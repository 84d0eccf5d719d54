"""The port's Gauss transform (probreg_tpu_torch.ops.gausstransform,
ops.gt_cuda, gauss_transform) held to the JAX package.

The same numpy clouds and weights go through the JAX package's
``gauss_transform`` and its tile-culled Pallas kernel (interpret mode), and
through the port's, which on CPU tensors runs the plain version of the CUDA
kernel.

Tolerance: |port - reference| <= 2e-4 * max(1, max |reference|), the JAX
package's own tolerance between its culled kernel and its dense transform
(tests/test_culled_estep.py): the two take d2 in different valid f32
operation orders (differences against the expanded form), ~1e-4 relative
on O(1) coordinates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu import config as jcfg  # noqa: E402
from probreg_tpu import gauss_transform as jgtf  # noqa: E402
from probreg_tpu.ops import estep_pallas as jep  # noqa: E402
from probreg_tpu.ops import gausstransform as jgt  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import gauss_transform as pgtf  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops import gausstransform as pgt  # noqa: E402
from probreg_tpu_torch.ops import gt_cuda as pgc  # noqa: E402

ATOL = 2e-4


def _blobs(m=600, n=500, dim=3, seed=13):
    """Eight well-separated blobs (tests/test_culled_estep.py), in 2-D or
    3-D, with five weight channels."""
    rng = np.random.default_rng(seed)
    centers = np.array([[i * 5.0, j * 5.0, k * 5.0] for i in range(2)
                        for j in range(2) for k in range(2)], np.float32)
    src = (centers[rng.integers(0, 8, m)]
           + rng.normal(0, 0.2, (m, 3))).astype(np.float32)[:, :dim]
    tgt = (centers[rng.integers(0, 8, n)]
           + rng.normal(0, 0.2, (n, 3))).astype(np.float32)[:, :dim]
    w = rng.uniform(0.1, 1.0, (m, 5)).astype(np.float32)
    return src.copy(), tgt.copy(), w


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(out, ref, h=None, pts=()):
    """``out`` against ``ref`` to ATOL of the largest magnitude; with ``h``
    and the clouds, each entry also to the f32 noise of the expanded-form
    d2 = |q|^2 + |p|^2 - 2 q.p that the reference uses: ~4 eps |x - c|^2 in
    d2, so 8 eps max|x - c|^2 / h^2 relative in exp(-d2 / h^2)."""
    out, ref = np.asarray(out), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    rtol = 0.0
    if h is not None:
        both = np.concatenate(pts)
        r2 = float(((both - both.mean(0)) ** 2).sum(1).max())
        rtol = 8.0 * np.finfo(np.float32).eps * r2 / h ** 2
    np.testing.assert_allclose(out / scale, ref / scale, atol=ATOL,
                               rtol=rtol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("h", [2.0, 0.3, 0.05])
def test_gauss_transform_matches_reference(h, dim):
    """The dense streaming transform, 1-D and 5-channel weights, M != N,
    in one block and in blocks smaller than the source (each centred on
    its own mean)."""
    src, tgt, w = _blobs(dim=dim)
    for wt in (w, w[:, 0]):
        ref = jgt.gauss_transform(src, tgt, wt, h)
        for block in (None, 256):
            out = pgt.gauss_transform(_t(src), _t(tgt), _t(wt), h,
                                      block=block)
            assert out.shape == ref.shape == (500,) + wt.shape[1:]
            _close(out, ref, h, (src, tgt))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("h", [2.0, 0.3, 0.05])
def test_culled_plain_matches_reference_kernel(h, sort, dim):
    """The plain version of the culled kernel against the reference's
    Pallas kernel in interpret mode, on unsorted caller order (sort=True)
    and on Morton-sorted clouds (sort=False)."""
    src, tgt, w = _blobs(dim=dim, seed=17)
    if not sort:
        from probreg_tpu.ops.spatial import morton_order

        perm = np.asarray(morton_order(src))
        src, w = src[perm], w[perm]
        tgt = tgt[np.asarray(morton_order(tgt))]
    for wt in (w, w[:, 0]):
        ref = jep.gauss_transform_culled(src, tgt, wt, h, tile=128,
                                         interpret=True, sort=sort)
        out = pgc.gauss_transform_culled(_t(src), _t(tgt), _t(wt), h,
                                         tile=128, sort=sort)
        assert out.shape == ref.shape
        _close(out, ref, h, (src, tgt))


def test_culling_fires_and_gives_exact_zeros():
    """A far query cluster on Morton-sorted clouds: its tiles see no active
    point tile and get exactly 0; the rest equals the dense transform."""
    from probreg_tpu_torch.ops.spatial import morton_order

    src, tgt, w = _blobs(seed=3)
    tgt[:300] += 100.0
    ps, qs, wt = _t(src), _t(tgt), _t(w)
    perm = morton_order(ps)
    ps, wt, qs = ps[perm], wt[perm], qs[morton_order(qs)]
    h = 0.3
    cen = (ps.sum(0) + qs.sum(0)) / (ps.shape[0] + qs.shape[0])
    mask = pgc.prepare(ps - cen, qs - cen, wt, h, tile=64)[4]
    assert 0.0 < float(mask.float().mean()) < 1.0
    dead = (~mask.any(0)).repeat_interleave(pgc._ROWS)[:500]
    assert int(dead.sum()) > 0
    out = pgc.gauss_transform_culled(ps, qs, wt, h, tile=64, sort=False)
    assert bool((out[dead] == 0).all())
    near = qs[:, 0] < 50.0
    ref = jgt.gauss_transform(ps.numpy(), qs[near].numpy(), wt.numpy(), h)
    _close(out[near], ref, h, (src, tgt[300:]))
    # Unculled, the same numbers (culling drops only exact zeros).
    full = pgc.gauss_transform_culled(ps, qs, wt, h, tile=64, sort=False,
                                      cull=False)
    np.testing.assert_array_equal(out.numpy(), full.numpy())


def test_large_bandwidth_case_where_the_reference_fast_start_fires():
    """The reference's bf16 fast-start branch engages when its bound argerr
    <= estep_fast_start_tol; the port always takes the exact branch and
    must still agree with it."""
    src, tgt, w = _blobs(m=300, n=280, seed=5)
    h = 40.0
    # estep_pallas.gauss_transform_culled's bound on the centred clouds.
    both = np.concatenate([src, tgt])
    cen = both.mean(0)
    q2max = float(((tgt - cen) ** 2).sum(1).max())
    p2max = float(((src - cen) ** 2).sum(1).max())
    argerr = 8.0 * 2.0 ** -9 * np.sqrt(q2max * p2max) / h ** 2
    assert jcfg.config.estep_fast_start
    assert argerr <= jcfg.config.estep_fast_start_tol, argerr
    ref = jep.gauss_transform_culled(src, tgt, w, h, tile=128,
                                     interpret=True)
    out = pgc.gauss_transform_culled(_t(src), _t(tgt), _t(w), h, tile=128)
    _close(out, ref)


def test_gate_routes_large_problems_to_the_culled_kernel(monkeypatch):
    """Sorted callers from culled_estep_min_pairs, unsorted ones only from
    max(that, 2^28), at most 8 channels and 2 <= D <= 8; the result is the
    dense one."""
    calls = []
    orig = pgc.gauss_transform_culled_plain
    monkeypatch.setattr(pgc, "gauss_transform_culled_plain",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1000)
    src, tgt, w = _blobs(m=200, n=150, seed=8)
    ref = jgt.gauss_transform(src, tgt, w, 0.3)
    _close(pgt.gauss_transform(_t(src), _t(tgt), _t(w), 0.3,
                               assume_sorted=True), ref)
    assert calls == [1]
    pgt.gauss_transform(_t(src), _t(tgt), _t(w), 0.3)          # unsorted
    pgt.gauss_transform(_t(src[:, :1]), _t(tgt[:, :1]), _t(w), 0.3,
                        assume_sorted=True)                    # D = 1
    nine = np.concatenate([w, w], axis=1)[:, :9]
    pgt.gauss_transform(_t(src), _t(tgt), _t(nine), 0.3, assume_sorted=True)
    monkeypatch.setattr(pcfg.config, "use_culled_estep", False)
    pgt.gauss_transform(_t(src), _t(tgt), _t(w), 0.3, assume_sorted=True)
    assert calls == [1]


@pytest.mark.parametrize("need_m2,with_normals", [(False, False),
                                                  (True, False),
                                                  (True, True)])
def test_filterreg_moments_match_reference(need_m2, with_normals):
    """M != N: the moments are per source point, (M,) and (M, D)."""
    rng = np.random.default_rng(11)
    src = rng.uniform(-1, 1, (230, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (170, 3)).astype(np.float32)
    nrm = rng.normal(size=(170, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    sigma = 0.3
    normals = nrm if with_normals else None
    ref = jgt.filterreg_moments(src / sigma, tgt / sigma, tgt, normals,
                                need_m2=need_m2)
    out = pgt.filterreg_moments(_t(src / sigma), _t(tgt / sigma), _t(tgt),
                                None if normals is None else _t(normals),
                                need_m2=need_m2)
    assert out[0].shape == (230,) and out[1].shape == (230, 3)
    for a, b in zip(out, ref):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b)


def test_facade_matches_reference():
    src, tgt, w = _blobs(m=120, n=90, seed=2)
    ref = jgtf.GaussTransform(src, 0.5).compute(tgt, w[:, 0])
    out = pgtf.GaussTransform(src, 0.5, device="cpu").compute(tgt, w[:, 0])
    _close(out, ref)
    ref2 = jgtf.GaussTransform(src, 0.5).compute(tgt, w.T)      # (C, M)
    out2 = pgtf.GaussTransform(src, 0.5, device="cpu").compute(tgt, w.T)
    assert out2.shape == ref2.shape == (5, 90)
    _close(out2, ref2)
    ones = pgtf.GaussTransform(src, 0.5, device="cpu").compute(tgt)
    _close(ones, jgtf.GaussTransform(src, 0.5).compute(tgt))
    _close(pgtf.Direct(src, 0.5, device="cpu").compute(tgt, w),
           jgtf.Direct(src, 0.5).compute(tgt, w))
    with pytest.raises(NotImplementedError, match="ifgt.*Queue 1 item 8"):
        pgtf.GaussTransform(src, 0.5, method="ifgt", device="cpu")


def test_wrapper_checks():
    pts, w = torch.zeros((10, 3)), torch.ones(10)
    with pytest.raises(ValueError, match="2 <= D <= 8"):
        pgc.gauss_transform_culled(torch.zeros((10, 1)), torch.zeros((4, 1)),
                                   w, 1.0)
    with pytest.raises(ValueError, match="C <= 8"):
        pgc.gauss_transform_culled(pts, pts, torch.ones((10, 9)), 1.0)
    with pytest.raises(ValueError, match="float32"):
        pgc.gauss_transform_culled(pts.double(), pts.double(), w.double(),
                                   1.0)
    with pytest.raises(ValueError, match="empty"):
        pgc.gauss_transform_culled(torch.zeros((0, 3)), pts, w[:0], 1.0)
    # The active mask is estep_cuda's, with 1/h^2 for 1/(2 sigma2).
    assert pgc.ec is pec


@pytest.mark.parametrize("dim,width", [(2, 2), (3, 3), (4, 4), (5, 8),
                                       (8, 8)])
def test_kernel_widths_and_launch_shape(dim, width):
    """The kernel takes D = 2, 3, 4 as they are and 5 <= D <= 8 padded to 8
    with zero columns (which add exact zeros to d2); the channels keep
    their own width. Two blocks share each 256-row query tile."""
    assert pgc._width(dim) == width
    x = torch.arange(6 * dim, dtype=torch.float32).reshape(6, dim)
    padded = pgc._pad_cols(x, width)
    assert padded.shape == (6, width) and padded.is_contiguous()
    assert torch.equal(padded[:, :dim], x)
    assert not bool(padded[:, dim:].any())
    assert (padded is x) == (dim == width)
    assert pgc._ROWS % pgc.BLOCK_ROWS == 0
    blocks, threads = pgc.launch_shape(150_000)
    assert blocks == 1172 and blocks * pgc.BLOCK_ROWS >= 150_000
    assert threads * pgc.ROWS_PER_THREAD == pgc.BLOCK_ROWS * pgc.SLOTS

"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so on a GPU machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| + 1e-6 per output,
the criterion of chip_smoke.py (the two evaluate d2 in different f32
operation orders and sum in different orders). The whole-EM kernel is held
to its plain version at a fixed small number of iterations (lin, t to 1e-5
absolute, sigma2 to 1e-5 relative: only the summation order differs) and
over a whole run (2e-4 absolute, 1e-3 relative: the iterations amplify it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch.ops import em_cuda as pem  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops.spatial import morton_order  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, name):
    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()) + 1e-6, (name, err)


def _cloud(n, seed, dev, far=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:far, 2] += 30.0  # a far cluster: whole stripes or tiles culled
    t = torch.as_tensor(pts, device=dev)
    return t[morton_order(t)]


@pytest.mark.parametrize("m,n", [(1, 1), (37, 1000), (1000, 33), (640, 700)])
def test_estep_small_kernel_matches_plain(dev, m, n):
    ys, xs = _cloud(m, 1, dev), _cloud(n, 2, dev)
    scal = pec._scalars(0.05, 0.1, m, n, 3, dev)
    before = pec.LAUNCHES["estep_small"]
    got = pec.estep_small(ys, xs, 0.05, 0.1)
    assert pec.LAUNCHES["estep_small"] == before + 1
    want = pec.estep_small_plain(ys, xs, scal)
    for name, a, b in zip(("pt1", "p1", "px", "xx"),
                          (got.pt1, got.p1, got.px, got.xx), want):
        _close(a, b, name)


@pytest.mark.parametrize("sigma2", [0.5, 0.01, 1e-3])
@pytest.mark.parametrize("tile_m,tile_n", [(96, 256), (512, 1024)])
def test_stash_kernels_match_plain(dev, sigma2, tile_m, tile_n):
    """Ragged tiles, dense to mostly culled; the far target cluster gives
    stripes with no active tile, whose pt1 must be exactly 0. (Below
    sigma2 ~ 1e-3 the f32 d2 cancellation, ~eps |y|^2 / (2 sigma2), passes
    1e-4 relative in den, and pt1 = den / (den + c) carries it where den ~ c,
    as the reference's tests note for their own kernels.)"""
    m, n = 3000, 2500
    ys, xs = _cloud(m, 3, dev), _cloud(n, 4, dev, far=700)
    scal = pec._scalars(sigma2, 0.05, m, n, 3, dev)
    mask = pec._active_mask(*pec._tile_bounds(ys, tile_m),
                            *pec._tile_bounds(xs, tile_n), scal[0])
    before = dict(pec.LAUNCHES)
    got = pec.stash_estep(ys, xs, scal, mask, tile_m, tile_n)
    n_j = mask.shape[1]
    assert pec.LAUNCHES["stash_den"] == before["stash_den"] + n_j
    assert pec.LAUNCHES["stash_moment"] == before["stash_moment"] + n_j
    want = pec.stash_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        _close(a, b, name)
    dead = ~mask.any(0)  # stripes without an active tile
    if bool(dead.any()):
        cols = dead.repeat_interleave(tile_n)[:n]
        assert bool((got[0][cols] == 0).all())


def test_cuda_tensors_never_reach_the_plain_versions(dev, monkeypatch):
    def refuse(*a):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pec, "estep_small_plain", refuse)
    monkeypatch.setattr(pec, "stash_estep_plain", refuse)
    ys, xs = _cloud(800, 5, dev), _cloud(900, 6, dev)
    pec.estep_small(ys, xs, 0.1)
    pec.estep_auto(ys, xs, 0.1, tile_m=128, tile_n=256)
    torch.cuda.synchronize()


def test_streaming_registration_kernels_match_plain(dev, monkeypatch):
    """A 20k-point rigid registration through the stash kernels equals the
    same registration through the plain version, up to summation order."""
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 1 << 20)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1 << 20)
    rng = np.random.default_rng(7)
    src = rng.uniform(-1, 1, (20_000, 3)).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = (src @ rot.T + 0.05).astype(np.float32)
    res = pcpd.registration_cpd(src, tgt, maxiter=30, tol=1e-8)
    monkeypatch.setattr(pec, "stash_estep", pec.stash_estep_plain)
    ref = pcpd.registration_cpd(src, tgt, maxiter=30, tol=1e-8)
    for a, b in ((res.transformation.rot, ref.transformation.rot),
                 (res.transformation.t, ref.transformation.t)):
        assert float((a - b).abs().max()) <= 1e-4
    np.testing.assert_allclose(float(res.sigma2), float(ref.sigma2),
                               rtol=1e-3)


# --------------------------------------------------------------------------
# The two-pass E-step kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sigma2", [0.5, 0.01, 1e-3])
@pytest.mark.parametrize("tile_m,tile_n", [(96, 256), (512, 1024)])
def test_two_pass_kernels_match_plain(dev, sigma2, tile_m, tile_n):
    """Same clouds as the stash kernels' test: ragged tiles, dense to mostly
    culled, stripes and source tiles with no active partner."""
    m, n = 3000, 2500
    ys, xs = _cloud(m, 3, dev, far=500), _cloud(n, 4, dev, far=700)
    # Move the far source cluster away from the far target cluster too:
    # source tiles that see no target at small sigma2.
    ys = ys + torch.where(ys[:, 2:] > 20.0, 100.0, 0.0) * ys.new_tensor(
        [1.0, 0.0, 0.0])
    ys = ys[morton_order(ys)]
    scal = pec._scalars(sigma2, 0.05, m, n, 3, dev)
    mask = pec._active_mask(*pec._tile_bounds(ys, tile_m),
                            *pec._tile_bounds(xs, tile_n), scal[0])
    before = dict(pec.LAUNCHES)
    got = pec.fused_core(ys, xs, scal, mask, tile_m, tile_n)
    assert pec.LAUNCHES["fused_den"] == before["fused_den"] + 1
    assert pec.LAUNCHES["fused_moment"] == before["fused_moment"] + 1
    want = pec.fused_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        _close(a, b, name)
    dead_cols = (~mask.any(0)).repeat_interleave(tile_n)[:n]
    dead_rows = (~mask.any(1)).repeat_interleave(tile_m)[:m]
    assert bool((got[0][dead_cols] == 0).all())
    assert bool((got[1][dead_rows] == 0).all())
    assert bool((got[2][dead_rows] == 0).all())


def test_two_pass_wrappers_on_the_card(dev):
    """estep_culled (sorts, unsorts) and estep(use_pallas=True) agree with
    the streaming plain E-step."""
    from probreg_tpu_torch.ops import estep as peo

    rng = np.random.default_rng(8)
    ys = torch.as_tensor(rng.uniform(-1, 1, (2000, 3)), dtype=torch.float32,
                         device=dev)
    xs = torch.as_tensor(rng.uniform(-1, 1, (1800, 3)), dtype=torch.float32,
                         device=dev)
    want = peo.estep_xla(ys, xs, 0.01, 0.1)
    for got in (pec.estep_culled(ys, xs, 0.01, 0.1, tile_m=128, tile_n=256),
                peo.estep(ys, xs, 0.01, 0.1, use_pallas=True)):
        for name, a, b in zip(want._fields, got, want):
            _close(a, b, name)


# --------------------------------------------------------------------------
# The whole-EM kernel
# --------------------------------------------------------------------------

def _pair(m, n, seed, dev, affine=False):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (max(m, n), 3)).astype(np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    lin = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    if affine:
        lin = lin @ np.array([[1.1, 0.1, 0], [0, 0.9, 0.05], [0, 0, 1.05]],
                             np.float32)
    tgt = (src @ lin.T + np.float32([0.1, -0.05, 0.2])
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    rng.shuffle(tgt)
    return (torch.as_tensor(src[:m], device=dev),
            torch.as_tensor(tgt[:n], device=dev))


def _em_close(got, want, atol, rtol):
    lin, t, sigma2, q, _ = got
    lin_w, t_w, sigma2_w, q_w, _ = want
    assert float((lin - lin_w).abs().max()) <= atol
    assert float((t - t_w).abs().max()) <= atol
    assert float((sigma2 - sigma2_w).abs() / sigma2_w.abs()) <= rtol
    assert float((q - q_w).abs() / q_w.abs()) <= max(rtol, 1e-4)


def _plain_em(src, tgt, **kw):
    out = pem.run_em_cpd_fused_plain(
        src[None], tgt[None], None, affine=kw["kind"] == "affine", w=kw["w"],
        maxiter=kw["maxiter"], tol=kw["tol"],
        update_scale=kw["update_scale"])[0]
    return out[:9].reshape(3, 3), out[9:12], out[12], out[13], out[14]


@pytest.mark.parametrize("kind,update_scale", [("rigid", True),
                                               ("rigid", False),
                                               ("affine", False)])
@pytest.mark.parametrize("m,n", [(1024, 1024), (390, 390), (33, 700),
                                 (2000, 500), (7000, 149), (100, 10000)])
def test_whole_em_kernel_matches_plain(dev, kind, update_scale, m, n):
    src, tgt = _pair(m, n, m + n, dev, affine=kind == "affine")
    for maxiter, tol, atol, rtol in ((1, 0.0, 1e-5, 1e-5),
                                     (5, 0.0, 1e-5, 1e-5),
                                     (60, 1e-3, 2e-4, 1e-3)):
        kw = dict(kind=kind, w=0.1, maxiter=maxiter, tol=tol,
                  update_scale=update_scale)
        key = "em_affine" if kind == "affine" else "em_rigid"
        before = pem.LAUNCHES[key]
        got = pem._run_em_cpd_fused(src, tgt, **kw)
        assert pem.LAUNCHES[key] == before + 1
        want = _plain_em(src, tgt, **kw)
        _em_close(got, want, atol, rtol)
        if maxiter < 60:
            assert int(got[4]) == int(want[4]) == maxiter
        if kind == "rigid":
            rot, _ = pem.unpack_rigid(got[0])
            assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5


def test_whole_em_batch_is_one_launch_and_equals_single_pairs(dev):
    """A ragged masked batch: one launch, each pair equal to its own
    single-pair launch without padding, bit for bit."""
    rng = np.random.default_rng(5)
    sizes = [(300, 1024), (1024, 700), (517, 333), (64, 64), (1000, 1000)]
    pairs = [_pair(m, n, i, dev) for i, (m, n) in enumerate(sizes)]
    srcs = torch.zeros((len(pairs), 1024, 3), device=dev)
    tgts = torch.zeros((len(pairs), 1024, 3), device=dev)
    smask = torch.zeros((len(pairs), 1024), device=dev)
    tmask = torch.zeros((len(pairs), 1024), device=dev)
    for i, (s, t) in enumerate(pairs):
        # valid points scattered, not at the front: the wrapper compacts
        rows = torch.as_tensor(np.sort(rng.permutation(1024)[:s.shape[0]]),
                               device=dev)
        cols = torch.as_tensor(np.sort(rng.permutation(1024)[:t.shape[0]]),
                               device=dev)
        srcs[i, rows], smask[i, rows] = s, 1.0
        tgts[i, cols], tmask[i, cols] = t, 1.0
    kw = dict(kind="rigid", w=0.05, maxiter=100, tol=1e-2, update_scale=True)
    before = pem.LAUNCHES["em_rigid"]
    lin, t, sigma2, q, it = pem.run_em_cpd_fused_batch(srcs, tgts, smask,
                                                       tmask, **kw)
    assert pem.LAUNCHES["em_rigid"] == before + 1
    assert len(set(it.tolist())) > 1  # pairs stop at their own iterations
    for i, (s, tg) in enumerate(pairs):
        one = pem._run_em_cpd_fused(s, tg, **kw)
        assert torch.equal(one[0], lin[i]) and torch.equal(one[1], t[i])
        assert torch.equal(one[2], sigma2[i]) and torch.equal(one[4], it[i])


def test_whole_em_kernel_degenerate_clouds_give_proper_rotations(dev):
    """A planar and a collinear cloud: Horn's matrix has tied top
    eigenvalues, the rotation must still be proper."""
    rng = np.random.default_rng(6)
    for keep in (2, 1):
        src = np.zeros((400, 3), np.float32)
        src[:, :keep] = rng.uniform(-1, 1, (400, keep))
        tgt = src + rng.normal(0, 0.01, src.shape).astype(np.float32)
        tgt[:, keep:] = 0.0
        rot, t, scale, sigma2, _ = pem.run_em_rigid_fused(
            torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev),
            maxiter=20, tol=1e-6)
        assert bool(torch.isfinite(rot).all())
        assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
        eye = torch.eye(3, device=dev)
        assert float((rot @ rot.T - eye).abs().max()) < 1e-5


def test_whole_em_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pem, "run_em_cpd_fused_plain", refuse)
    monkeypatch.setattr(pec, "fused_estep_plain", refuse)
    src, tgt = _pair(500, 600, 9, dev)
    res = pcpd.registration_cpd(src, tgt, "affine", maxiter=10)
    assert bool(torch.isfinite(res.transformation.b).all())
    pcpd.registration_cpd_batch([src, src[:300]], [tgt, tgt[:400]], maxiter=5)
    pec.estep_fused(src, tgt, 0.1)
    with pytest.raises(ValueError, match="shared memory"):
        pem._run_em_cpd_fused(torch.zeros((8000, 3), device=dev), tgt)
    torch.cuda.synchronize()


def test_two_pass_registration_equals_stash_registration(dev, monkeypatch):
    """use_pallas=True drives the streaming loop through the two-pass
    kernels; the result equals the stash kernels' up to summation order."""
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 1 << 20)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1 << 20)
    src, tgt = _pair(20_000, 20_000, 10, dev)
    pec.reset_launches()
    res = pcpd.registration_cpd(src, tgt, maxiter=15, tol=1e-8,
                                use_pallas=True)
    assert pec.LAUNCHES["fused_den"] == pec.LAUNCHES["fused_moment"] == 15
    assert pec.LAUNCHES["stash_den"] == 0
    ref = pcpd.registration_cpd(src, tgt, maxiter=15, tol=1e-8)
    assert pec.LAUNCHES["stash_den"] > 0
    for a, b in ((res.transformation.rot, ref.transformation.rot),
                 (res.transformation.t, ref.transformation.t)):
        assert float((a - b).abs().max()) <= 1e-4
    np.testing.assert_allclose(float(res.sigma2), float(ref.sigma2),
                               rtol=1e-3)

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
The FilterReg whole-EM kernel is held to the same figures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch.ops import em_cuda as pem  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops import frg_cuda as pfc  # noqa: E402
from probreg_tpu_torch.ops import gt_cuda as pgc  # noqa: E402
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


def _small_case(m, n, dim, dev, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(-1, 1, (m, dim)), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(rng.uniform(-1, 1, (n, dim)), dtype=torch.float32,
                            device=dev))


def _small_close(ys, xs, sigma2, w):
    """K2 against its plain version, every output (n_p too)."""
    m, dim = ys.shape
    got = pec.estep_small(ys, xs, sigma2, w)
    scal = pec._scalars(sigma2, w, m, xs.shape[0], dim, ys.device)
    pt1, p1, px, xx = pec.estep_small_plain(ys, xs, scal)
    for name, a, b in zip(("pt1", "p1", "px", "n_p", "xx"), got,
                          (pt1, p1, px, p1.sum(), xx)):
        _close(a, b, name)
    return got, pt1


@pytest.mark.parametrize("m,n,dim,w", [
    (32768, 32, 3, 0.1), (32, 32768, 3, 0.1), (1000, 1000, 1, 0.1),
    (1000, 1000, 2, 0.1), (700, 500, 3, 0.0), (1, 3000, 3, 0.1),
    (3000, 1, 3, 0.1), (1, 1, 2, 0.0)])
def test_estep_small_shapes_dims_and_w(dev, m, n, dim, w):
    """The gate's tall and wide corners, D = 1 and 2, w = 0, M = 1 and
    N = 1: every output within the module's tolerance of the plain
    version."""
    ys, xs = _small_case(m, n, dim, dev)
    _small_close(ys, xs, 0.05, w)


@pytest.mark.parametrize("w", [0.0, 0.1])
def test_estep_small_columns_with_no_mass_take_eps(dev, w):
    """A target cluster far from every source at a small sigma2: its
    columns' raw normalizer is exactly 0, so den takes eps (+ c) and their
    pt1 is exactly 0, as in the plain version."""
    ys, xs = _small_case(600, 900, 3, dev, seed=3)
    xs[:200, 2] += 30.0
    got, pt1 = _small_close(ys, xs, 1e-3, w)
    assert bool((pt1[:200] == 0).all())
    assert bool((got.pt1[:200] == 0).all())
    assert bool(torch.isfinite(got.p1).all())


def _small_flat(mom):
    return torch.cat([mom.pt1, mom.p1, mom.px.reshape(-1),
                      torch.stack([mom.n_p, mom.xx])])


@pytest.mark.parametrize("m,n,dim", [(1000, 1000, 3), (32768, 32, 3),
                                     (32, 32768, 2), (640, 700, 1)])
def test_estep_small_same_bits_for_any_grid(dev, m, n, dim):
    """One block, two blocks and the default grid give the same bits, and
    so does a second run (no float atomics; the tickets are left at
    zero)."""
    ys, xs = _small_case(m, n, dim, dev)
    sigma2 = torch.tensor(0.05, device=dev)
    outs = []
    for kw in (dict(_blocks=1), dict(_blocks=2), {}, {}):
        launch, out = pec.small_launcher(ys, xs, sigma2, 0.1, **kw)
        launch()
        outs.append(_small_flat(out))
    for out in outs[1:]:
        assert torch.equal(outs[0], out)
    assert torch.equal(outs[0],
                       _small_flat(pec.estep_small(ys, xs, 0.05, 0.1)))


def test_estep_small_makes_at_most_two_launches(dev):
    """torch.profiler sees at most two device activities per estep_small
    call, with sigma2 a host float and a device tensor."""
    from torch.profiler import ProfilerActivity, profile

    ys, xs = _small_case(1000, 1000, 3, dev)
    for sigma2 in (0.05, torch.tensor(0.05, device=dev)):
        pec.estep_small(ys, xs, sigma2, 0.1)  # scratch grown, if it must
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                pec.estep_small(ys, xs, sigma2, 0.1)
            torch.cuda.synchronize()
        acts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        assert 5 <= len(acts) <= 10, [e.name for e in acts]


def test_estep_small_raises_and_never_falls_back(dev, monkeypatch):
    """A cooperative grid past the card's capacity and a library that
    cannot load both raise; the plain version is never called."""
    def refuse(*a):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pec, "estep_small_plain", refuse)
    ys, xs = _small_case(1000, 1000, 3, dev)
    launch, _ = pec.small_launcher(
        ys, xs, 0.05, 0.1, _blocks=pec.small_capacity(3, dev) + 1)
    with pytest.raises(RuntimeError, match="estep_small"):
        launch()

    def no_lib():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(pec, "_lib", no_lib)
    with pytest.raises(RuntimeError, match="nvcc"):
        pec.estep_small(ys, xs, 0.05, 0.1)


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
    assert pec.LAUNCHES["stash_den"] == before["stash_den"] + 1
    assert pec.LAUNCHES["stash_moment"] == before["stash_moment"] + 1
    want = pec.stash_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        _close(a, b, name)
    dead = ~mask.any(0)  # stripes without an active tile
    if bool(dead.any()):
        cols = dead.repeat_interleave(tile_n)[:n]
        assert bool((got[0][cols] == 0).all())


@pytest.mark.parametrize("kernel", ["K3", "K8", "K11", "K12"])
def test_one_estep_allocates_no_stash(dev, kernel):
    """One E-step of K3, K8, K11's route (identity reduction) and K12 at 20k
    x 20k points, dense, tiles 1024 x 1024: what it allocates at its peak
    above its inputs is its own (M) and (N) buffers, under 4 MiB here,
    where one (M, tile_n) f32 buffer, the stash that the per-stripe
    kernels held, would take 78 MiB."""
    from probreg_tpu_torch.ops import bcpd_cuda as pbc

    m = n = 20_000
    tile = 1024
    ys, xs, v_t, alpha = _wstash_inputs(m, n, 3, 13, dev)
    scal = pec._scalars(0.5, 0.05, m, n, 3, dev)
    mask = pec._active_mask(*pec._tile_bounds(ys, tile),
                            *pec._tile_bounds(xs, tile), scal[0])
    if kernel == "K8":
        rowlog = torch.log(alpha) - 1.5 * np.log(2 * np.pi * 0.5)
        wscal = torch.tensor([1.0, 0.1 / n, 1.1920929e-07], device=dev)
        mask, _ = pbc.cull_mask(ys, xs, rowlog, wscal[0], tile, tile)

        def estep():
            return pbc.wstash_estep(ys, xs, rowlog, v_t, wscal, mask, tile,
                                    tile)
    else:
        core, kw = {"K3": (pec.stash_estep, {}),
                    "K11": (pec.stash_estep,
                            {"reduce_den": lambda d: None}),
                    "K12": (pec.stash_merged_estep, {})}[kernel]

        def estep():
            return core(ys, xs, scal, mask, tile, tile, **kw)
    assert bool(mask.all())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = estep()
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert grew < 4 << 20, grew
    assert all(bool(torch.isfinite(t).all()) for t in out)


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


@pytest.mark.parametrize("sigma2", [0.5, 0.01, 1e-3])
@pytest.mark.parametrize("tile_m,tile_n", [(96, 256), (512, 1024)])
def test_stash_merged_kernel_matches_plain_and_k3(dev, sigma2, tile_m,
                                                  tile_n):
    """K12 on the inputs of test_stash_kernels_match_plain: two launches
    per E-step, K3's pass A (stash_den) and the folded pass B
    (stash_merged); against its plain version by the file's criterion;
    against K3 on the same inputs pt1 and xx equal bit for bit (the same
    pass A) and p1, px within 1e-5 of their largest entry (the normalizer
    folded into the channels)."""
    m, n = 3000, 2500
    ys, xs = _cloud(m, 3, dev), _cloud(n, 4, dev, far=700)
    scal = pec._scalars(sigma2, 0.05, m, n, 3, dev)
    mask = pec._active_mask(*pec._tile_bounds(ys, tile_m),
                            *pec._tile_bounds(xs, tile_n), scal[0])
    before = dict(pec.LAUNCHES)
    got = pec.stash_merged_estep(ys, xs, scal, mask, tile_m, tile_n)
    made = {k: pec.LAUNCHES[k] - before[k] for k in before}
    assert made == {**{k: 0 for k in before}, "stash_den": 1,
                    "stash_merged": 1}
    want = pec.stash_merged_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        _close(a, b, name)
    k3 = pec.stash_estep(ys, xs, scal, mask, tile_m, tile_n)
    assert torch.equal(got[0], k3[0]) and torch.equal(got[3], k3[3])
    for a, b in ((got[1], k3[1]), (got[2], k3[2])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_estep_auto_merged_on_the_card(dev, monkeypatch):
    """use_merged_stash routes estep_auto to K12 on CUDA tensors (no plain
    version); the moments equal the default route's up to the folded
    association; a cap below the 256 floor answers with estep_xla."""
    def refuse(*a):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pec, "stash_merged_estep_plain", refuse)
    monkeypatch.setattr(pec, "stash_estep_plain", refuse)
    ys, xs = _cloud(1800, 5, dev), _cloud(2100, 6, dev)
    base = pec.estep_auto(ys, xs, 0.05, 0.1, tile_m=128, tile_n=256)
    monkeypatch.setattr(pcfg.config, "use_merged_stash", True)
    before = pec.LAUNCHES["stash_merged"]
    out = pec.estep_auto(ys, xs, 0.05, 0.1, tile_m=128, tile_n=256)
    assert pec.LAUNCHES["stash_merged"] == before + 1
    for name, a, b in zip(out._fields, out, base):
        _close(a, b, name)
    monkeypatch.setattr(pcfg.config, "stash_max_bytes", 1 << 10)
    before = dict(pec.LAUNCHES)
    fall = pec.estep_auto(ys, xs, 0.05, 0.1, tile_m=128, tile_n=256)
    assert pec.LAUNCHES == before
    for name, a, b in zip(fall._fields, fall, base):
        _close(a, b, name)


def test_merged_pyramid_matches_default_on_the_card(dev, monkeypatch):
    """The rigid CPD pyramid on a 20k-point blobby surface (levels 3, 1,500
    coarse points; the finest level streams): through K12 it launches no
    K3b and K3 no K12, both recover pyramid_rigid.py's motion within the
    reference test's bar, and they agree within 1e-5 (pt1 and xx are the
    same bit for bit, p1 and px differ by one association's rounding)."""
    from probreg_tpu_torch import pyramid
    from probreg_tpu_torch.utils import se3_op
    from probreg_tpu_torch.utils.datagen import blobby_surface

    src = blobby_surface(20_000, seed=1)
    rot = se3_op.euler2mat(*np.deg2rad([5.0, 8.0, 12.0]))
    t_gt = torch.tensor([0.05, -0.03, 0.08])
    tgt = (src @ rot.numpy().T + t_gt.numpy()).astype(np.float32)
    runs = {}
    for merged in (False, True):
        monkeypatch.setattr(pcfg.config, "use_merged_stash", merged)
        before = dict(pec.LAUNCHES)
        res = pyramid.registration_cpd_pyramid(
            src, tgt, "rigid", levels=3, coarse_points=1500, tol=1e-4,
            device=dev)
        made = {k: pec.LAUNCHES[k] - before[k] for k in before}
        mine, other = (("stash_merged", "stash_moment") if merged
                       else ("stash_moment", "stash_merged"))
        assert made[mine] > 0 and made[other] == 0, made
        tr = res.transformation
        assert float(se3_op.rotation_angle(tr.rot.cpu().double(),
                                           rot.double())) < 1e-3
        assert float((tr.t.cpu() - t_gt).abs().max()) <= 1e-4
        assert abs(float(tr.scale) - 1.0) <= 1e-3
        runs[merged] = tr
    assert float((runs[True].rot - runs[False].rot).abs().max()) <= 1e-5
    assert float((runs[True].t - runs[False].t).abs().max()) <= 1e-5


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


def _bunny(dev):
    """The bunny at voxel 0.005 (bench.py's source) and a copy rotated by
    10 degrees about z with 1e-3 noise."""
    import os

    from probreg_tpu_torch.utils import io

    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "bunny.pcd")
    src = io.voxel_down_sample(io.read_point_cloud(path), 0.005)
    rng = np.random.default_rng(3)
    c, s = np.cos(np.deg2rad(10.0)), np.sin(np.deg2rad(10.0))
    tgt = src[rng.permutation(len(src))] @ np.array(
        [[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    tgt = tgt + 1e-3 * rng.standard_normal(tgt.shape)
    return (torch.as_tensor(src, dtype=torch.float32, device=dev),
            torch.as_tensor(tgt, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("case", ["bunny", "1024x1024", "masked 700/900"])
@pytest.mark.parametrize("kind", ["rigid", "affine"])
def test_whole_em_same_bits_for_every_cluster_size(dev, case, kind):
    """K1 on one block and on clusters of 2, 4 and 8 blocks (forced with
    _em_cuda's private argument) gives the same bits, at a fixed depth and
    with the loop test."""
    if case == "bunny":
        src, tgt = _bunny(dev)
    else:
        src, tgt = _pair(1024, 1024, 17, dev)
    smask = tmask = None
    if case.startswith("masked"):
        rng = np.random.default_rng(8)
        smask = torch.zeros(1024, device=dev)
        tmask = torch.zeros(1024, device=dev)
        smask[torch.as_tensor(rng.permutation(1024)[:700])] = 1.0
        tmask[torch.as_tensor(rng.permutation(1024)[:900])] = 1.0
        smask, tmask = smask[None], tmask[None]
    s_c, t_c, counts = pem.compact_batch(src[None], tgt[None], smask, tmask)
    assert pem.cluster_size(1, pem.sm_count(dev)) == 8
    for maxiter, tol in ((20, 0.0), (100, 1e-3)):
        kw = dict(affine=kind == "affine", w=0.05, maxiter=maxiter, tol=tol,
                  update_scale=True)
        outs = [pem._em_cuda(s_c, t_c, counts, **kw, _cluster=g)
                for g in (1, 2, 4, 8)]
        outs.append(pem._em_cuda(s_c, t_c, counts, **kw))
        for out in outs[1:]:
            assert torch.equal(out, outs[0])


def test_whole_em_batch_in_work_order_keeps_caller_order_and_pairs(dev):
    """A ragged batch of more pairs than SMs runs on one block a pair in
    work_order (largest m n first): one launch, each row the caller's pair,
    equal bit for bit to that pair alone (on a cluster of 8)."""
    rng = np.random.default_rng(12)
    sms = pem.sm_count(dev)
    batch = sms + 12
    sizes = rng.integers(64, 300, (batch, 2))
    pairs = [_pair(int(m), int(n), 100 + i, dev)
             for i, (m, n) in enumerate(sizes)]
    srcs = torch.zeros((batch, 300, 3), device=dev)
    tgts = torch.zeros((batch, 300, 3), device=dev)
    smask = torch.zeros((batch, 300), device=dev)
    tmask = torch.zeros((batch, 300), device=dev)
    for i, (s, t) in enumerate(pairs):
        srcs[i, :s.shape[0]], smask[i, :s.shape[0]] = s, 1.0
        tgts[i, :t.shape[0]], tmask[i, :t.shape[0]] = t, 1.0
    _, _, counts = pem.compact_batch(srcs, tgts, smask, tmask)
    order = pem.work_order(counts).cpu()
    assert order.tolist() != list(range(batch))
    assert pem.cluster_size(batch, sms) == 1
    kw = dict(kind="rigid", w=0.05, maxiter=50, tol=1e-3, update_scale=True)
    before = pem.LAUNCHES["em_rigid"]
    lin, t, sigma2, q, it = pem.run_em_cpd_fused_batch(srcs, tgts, smask,
                                                       tmask, **kw)
    assert pem.LAUNCHES["em_rigid"] == before + 1
    assert bool(torch.isfinite(lin).all())
    for i, (s, tg) in enumerate(pairs):
        one = pem._run_em_cpd_fused(s, tg, **kw)
        assert torch.equal(one[0], lin[i]) and torch.equal(one[1], t[i])
        assert torch.equal(one[2], sigma2[i]) and torch.equal(one[3], q[i])
        assert torch.equal(one[4], it[i])


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


# --------------------------------------------------------------------------
# FilterReg: the whole-EM kernel (K5) and the culled Gauss transform (K6)
# --------------------------------------------------------------------------

def _surface(n, seed, dev, rot_deg=0.0):
    """n points of the surface z = 0.3 sin(2x) + 0.24 cos(2y) over [-1, 1]^2
    with their analytic normals, rotated about z by ``rot_deg``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.24 * np.cos(2 * xy[:, 1])
    pts = np.column_stack([xy, z])
    nrm = np.column_stack([-0.6 * np.cos(2 * xy[:, 0]),
                           0.48 * np.sin(2 * xy[:, 1]), np.ones(n)])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = np.deg2rad(rot_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]])
    return (torch.as_tensor(pts @ rot.T, dtype=torch.float32, device=dev),
            torch.as_tensor(nrm @ rot.T, dtype=torch.float32, device=dev))


def _frg_pair(m, n, seed, dev):
    src, _ = _surface(m, seed, dev)
    tgt, nrm = _surface(n, seed + 1, dev, rot_deg=8.0)
    return src, tgt + torch.tensor([0.05, -0.02, 0.03], device=dev), nrm


def _frg_close(got, want, atol, rtol):
    """q to 1e-3 relative: for pt2pl it is a sum of squared residuals that
    are small differences, which amplifies the summation-order noise."""
    rot, t, sigma2, q, it = got
    rot_w, t_w, sigma2_w, q_w, it_w = want
    assert float((rot - rot_w).abs().max()) <= atol
    assert float((t - t_w).abs().max()) <= atol
    assert float(((sigma2 - sigma2_w).abs() / sigma2_w).max()) <= rtol
    assert float(((q - q_w).abs() / q_w.abs().clamp(min=1e-3)).max()) <= \
        1e-3
    assert torch.equal(it, it_w)


def _frg_plain(src, tgt, nrm, smask=None, tmask=None, sigma2_0=0.0, **kw):
    out = pfc.run_em_filterreg_fused_plain(
        *pfc.compact_batch(src, tgt, nrm, smask, tmask),
        pt2pl=kw["objective"] == "pt2pl", w=kw["w"], maxiter=kw["maxiter"],
        tol=kw["tol"], update_sigma2=kw["update_sigma2"],
        sigma2_decay=kw["sigma2_decay"], min_sigma2=1e-4, auto_sigma2=True,
        sigma2_0=sigma2_0)
    return (out[:, :9].reshape(-1, 3, 3), out[:, 9:12], out[:, 12],
            out[:, 13], out[:, 14])


@pytest.mark.parametrize("objective,update_sigma2", [("pt2pt", False),
                                                     ("pt2pt", True),
                                                     ("pt2pl", False),
                                                     ("pt2pl", True)])
@pytest.mark.parametrize("m,n", [(1024, 1024), (390, 390), (33, 700),
                                 (700, 33)])
def test_frg_kernel_matches_plain(dev, objective, update_sigma2, m, n):
    """After 1 and 5 iterations only the summation order differs; over 30
    the iterations amplify it. All at tol 0: at tol 1e-3 the two may stop
    iterations apart while a pt2pl transform is still moving (q is a small
    sum of squared residuals)."""
    src, tgt, nrm = _frg_pair(m, n, m + n, dev)
    nrm = nrm if objective == "pt2pl" else None
    key = "frg_" + objective
    for maxiter, atol in ((1, 1e-5), (5, 1e-5), (30, 2e-4)):
        kw = dict(objective=objective, w=0.05, maxiter=maxiter, tol=0.0,
                  update_sigma2=update_sigma2, sigma2_decay=0.9)
        before = pfc.LAUNCHES[key]
        got = pfc.run_em_filterreg_fused_batch(
            src[None], tgt[None], None if nrm is None else nrm[None], **kw)
        assert pfc.LAUNCHES[key] == before + 1
        want = _frg_plain(src[None], tgt[None],
                          None if nrm is None else nrm[None], **kw)
        _frg_close(got, want, atol, 1e-5 if maxiter <= 5 else 1e-3)
        assert int(got[4][0]) == maxiter
        assert abs(float(torch.linalg.det(got[0][0])) - 1.0) < 1e-5


@pytest.mark.parametrize("objective", ["pt2pt", "pt2pl"])
def test_frg_batch_is_one_launch_and_equals_single_pairs(dev, objective):
    """A ragged masked batch (valid points scattered, normals with their
    points): one launch, each pair equal to its own single-pair launch
    without padding, bit for bit, and to the plain version."""
    rng = np.random.default_rng(11)
    sizes = [(300, 1024), (1024, 700), (517, 333), (64, 64), (1000, 1000)]
    pairs = [_frg_pair(m, n, 20 + i, dev) for i, (m, n) in enumerate(sizes)]
    cap, b = 1024, len(pairs)
    srcs, tgts, nrms = (torch.zeros((b, cap, 3), device=dev)
                        for _ in range(3))
    smask, tmask = (torch.zeros((b, cap), device=dev) for _ in range(2))
    for i, (s, t, nv) in enumerate(pairs):
        rows = torch.as_tensor(np.sort(rng.permutation(cap)[:s.shape[0]]),
                               device=dev)
        cols = torch.as_tensor(np.sort(rng.permutation(cap)[:t.shape[0]]),
                               device=dev)
        srcs[i, rows], smask[i, rows] = s, 1.0
        tgts[i, cols], nrms[i, cols], tmask[i, cols] = t, nv, 1.0
    kw = dict(objective=objective, w=0.05, maxiter=100, tol=1e-2,
              update_sigma2=objective == "pt2pl", sigma2_decay=0.9)
    pt2pl = objective == "pt2pl"
    before = pfc.LAUNCHES["frg_" + objective]
    got = pfc.run_em_filterreg_fused_batch(
        srcs, tgts, nrms if pt2pl else None, smask, tmask, **kw)
    assert pfc.LAUNCHES["frg_" + objective] == before + 1
    for i, (s, t, nv) in enumerate(pairs):
        one = pfc.run_em_filterreg_fused_batch(
            s[None], t[None], nv[None] if pt2pl else None, **kw)
        for a, c in zip(got, one):
            assert torch.equal(a[i], c[0])
    kw.update(maxiter=5, tol=0.0)
    got = pfc.run_em_filterreg_fused_batch(
        srcs, tgts, nrms if pt2pl else None, smask, tmask, **kw)
    want = _frg_plain(srcs, tgts, nrms if pt2pl else None, smask, tmask,
                      **kw)
    _frg_close(got, want, 1e-5, 1e-5)


def _masks_700_900(dev, seed=8):
    """(1, 1024) masks with 700 and 900 valid points scattered."""
    rng = np.random.default_rng(seed)
    smask = torch.zeros(1024, device=dev)
    tmask = torch.zeros(1024, device=dev)
    smask[torch.as_tensor(rng.permutation(1024)[:700])] = 1.0
    tmask[torch.as_tensor(rng.permutation(1024)[:900])] = 1.0
    return smask[None], tmask[None]


def _frg_case(case, dev):
    """(source, target, normals, smask, tmask) of a single-pair case: the
    bunny (normals pointing away from the target's centroid), a 1024 x 1024
    surface pair, and that pair with 700 and 900 valid points."""
    if case == "bunny":
        src, tgt = _bunny(dev)
        nrm = tgt - tgt.mean(0)
        nrm = nrm / nrm.norm(dim=1, keepdim=True)
        return src, tgt, nrm, None, None
    src, tgt, nrm = _frg_pair(1024, 1024, 41, dev)
    masks = _masks_700_900(dev) if case.startswith("masked") else (None,
                                                                  None)
    return (src, tgt, nrm, *masks)


@pytest.mark.parametrize("case", ["bunny", "1024x1024", "masked 700/900"])
@pytest.mark.parametrize("objective,update_sigma2", [("pt2pt", False),
                                                     ("pt2pt", True),
                                                     ("pt2pl", False),
                                                     ("pt2pl", True)])
def test_frg_same_bits_for_every_cluster_size(dev, case, objective,
                                              update_sigma2):
    """K5 on one block and on clusters of 2, 4 and 8 blocks (forced with
    _frg_cuda's private argument) gives the same bits as the default (a
    cluster of 8 for one pair), at a fixed depth and with the loop test."""
    src, tgt, nrm, smask, tmask = _frg_case(case, dev)
    pt2pl = objective == "pt2pl"
    s_c, t_c, n_c, counts = pfc.compact_batch(
        src[None], tgt[None], nrm[None] if pt2pl else None, smask, tmask)
    assert pem.cluster_size(1, pem.sm_count(dev)) == 8
    for maxiter, tol in ((20, 0.0), (100, 1e-3)):
        kw = dict(pt2pl=pt2pl, w=0.05, maxiter=maxiter, tol=tol,
                  update_sigma2=update_sigma2, sigma2_decay=0.9,
                  min_sigma2=1e-4, auto_sigma2=True, sigma2_0=0.0)
        outs = [pfc._frg_cuda(s_c, t_c, n_c, counts, **kw, _cluster=g)
                for g in (1, 2, 4, 8)]
        outs.append(pfc._frg_cuda(s_c, t_c, n_c, counts, **kw))
        assert bool(torch.isfinite(outs[0]).all())
        for out in outs[1:]:
            assert torch.equal(out, outs[0])


def _ragged_batch(pairs, cap, dev):
    """Pads (source, target[, normals]) pairs to (B, cap, 3) tensors with
    their valid points first, and the (B, cap) masks."""
    b = len(pairs)
    srcs, tgts, nrms = (torch.zeros((b, cap, 3), device=dev)
                        for _ in range(3))
    smask, tmask = (torch.zeros((b, cap), device=dev) for _ in range(2))
    for i, p in enumerate(pairs):
        m, n = p[0].shape[0], p[1].shape[0]
        srcs[i, :m], smask[i, :m] = p[0], 1.0
        tgts[i, :n], tmask[i, :n] = p[1], 1.0
        if len(p) > 2:
            nrms[i, :n] = p[2]
    return srcs, tgts, nrms, smask, tmask


@pytest.mark.parametrize("objective", ["pt2pt", "pt2pl"])
def test_frg_batch_in_work_order_keeps_caller_order_and_pairs(dev,
                                                              objective):
    """A ragged batch of more pairs than SMs runs K5 on one block a pair in
    work_order (largest m n first): one launch, each row the caller's pair,
    equal bit for bit to that pair alone (on a cluster of 8)."""
    rng = np.random.default_rng(13)
    sms = pem.sm_count(dev)
    batch = sms + 12
    sizes = rng.integers(64, 300, (batch, 2))
    pairs = [_frg_pair(int(m), int(n), 200 + i, dev)
             for i, (m, n) in enumerate(sizes)]
    srcs, tgts, nrms, smask, tmask = _ragged_batch(pairs, 300, dev)
    pt2pl = objective == "pt2pl"
    nrms = nrms if pt2pl else None
    _, _, _, counts = pfc.compact_batch(srcs, tgts, nrms, smask, tmask)
    g, order = pem.launch_plan(batch, counts, sms)
    assert g == 1 and order.cpu().tolist() != list(range(batch))
    kw = dict(objective=objective, w=0.05, maxiter=50, tol=1e-3,
              update_sigma2=pt2pl, sigma2_decay=0.9)
    before = pfc.LAUNCHES["frg_" + objective]
    got = pfc.run_em_filterreg_fused_batch(srcs, tgts, nrms, smask, tmask,
                                           **kw)
    assert pfc.LAUNCHES["frg_" + objective] == before + 1
    assert bool(torch.isfinite(got[0]).all())
    for i, (s, t, nv) in enumerate(pairs):
        one = pfc.run_em_filterreg_fused_batch(
            s[None], t[None], nv[None] if pt2pl else None, **kw)
        for a, c in zip(got, one):
            assert torch.equal(a[i], c[0])


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("h2", [2.0, 0.02, 1e-3])
@pytest.mark.parametrize("dim,tile", [(2, 256), (3, 256), (3, 96), (4, 256),
                                      (5, 256)])
def test_gauss_transform_kernel_matches_plain(dev, channels, h2, dim, tile):
    """Dense to mostly culled on Morton-sorted clouds with a far query
    cluster, whose tiles see no active point tile and get exact zeros;
    every width the kernel is built for (D 2, 3, 4 and 8 for 5, C 1 to 8)
    launches."""
    from probreg_tpu_torch.ops.spatial import morton_order as mo

    rng = np.random.default_rng(dim * 100 + channels)
    ps = torch.as_tensor(rng.uniform(-1, 1, (3000, dim)),
                         dtype=torch.float32, device=dev)
    qs = torch.as_tensor(rng.uniform(-1, 1, (2500, dim)),
                         dtype=torch.float32, device=dev)
    # The last of the first three axes leads the Morton order: whole far
    # tiles.
    qs[:700, min(dim, 3) - 1] += 30.0
    w = torch.as_tensor(rng.uniform(0, 1, (3000, channels)),
                        dtype=torch.float32, device=dev)
    perm = mo(ps)
    ps, w, qs = ps[perm], w[perm], qs[mo(qs)]
    prep = pgc.prepare(ps, qs, w, h2 ** 0.5, tile)
    before = pgc.LAUNCHES["gauss_transform"]
    got = pgc.gt_core(*prep)
    assert pgc.LAUNCHES["gauss_transform"] == before + 1
    want = pgc.gauss_transform_culled_plain(*prep)
    _close(got, want, "gauss_transform")
    dead = (~prep[4].any(0)).repeat_interleave(pgc._ROWS)[:2500]
    assert bool(dead.any()) and bool((got[dead] == 0).all())


def test_gauss_transform_wrapper_on_the_card(dev):
    """The wrapper (centring, sort, unsort, 1-D weights) against the dense
    plain transform, with M != N."""
    from probreg_tpu_torch.ops import gausstransform as pgt

    rng = np.random.default_rng(12)
    src = torch.as_tensor(rng.uniform(-1, 1, (4000, 3)) + 5.0,
                          dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(rng.uniform(-1, 1, (2600, 3)) + 5.0,
                          dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.uniform(0, 1, 4000), dtype=torch.float32,
                        device=dev)
    got = pgc.gauss_transform_culled(src, tgt, w, 0.2)
    want = pgt.gauss_transform(src, tgt, w, 0.2)   # dense: below the gate
    assert got.shape == want.shape == (2600,)
    _close(got, want, "wrapper")


def test_filterreg_cuda_tensors_never_reach_the_plain_versions(dev,
                                                               monkeypatch):
    from probreg_tpu_torch import filterreg as pf

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pfc, "run_em_filterreg_fused_plain", refuse)
    monkeypatch.setattr(pgc, "gauss_transform_culled_plain", refuse)
    src, tgt, nrm = _frg_pair(500, 600, 30, dev)
    pfc.reset_launches()
    res = pf.registration_filterreg(src, tgt, target_normals=nrm,
                                    objective_type="pt2pl", maxiter=10)
    assert bool(torch.isfinite(res.transformation.rot).all())
    pf.registration_filterreg_batch([src, src[:300]], [tgt, tgt[:400]],
                                    maxiter=5)
    assert pfc.LAUNCHES == {"frg_pt2pt": 1, "frg_pt2pl": 1}
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 1 << 18)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1 << 18)
    pgc.reset_launches()
    pf.registration_filterreg(src, tgt, maxiter=4, tol=0.0)
    assert pgc.LAUNCHES["gauss_transform"] == 4
    torch.cuda.synchronize()


def test_streaming_filterreg_kernel_matches_plain(dev, monkeypatch):
    """A 20k-point streaming FilterReg through K6 equals the same
    registration through its plain version, up to summation order."""
    from probreg_tpu_torch import filterreg as pf

    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 1 << 20)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1 << 20)
    src, tgt = _pair(20_000, 20_000, 13, dev)
    kw = dict(maxiter=15, tol=0.0, sigma2_decay=0.8)
    pgc.reset_launches()
    res = pf.registration_filterreg(src, tgt, **kw)
    assert pgc.LAUNCHES["gauss_transform"] == 15
    monkeypatch.setattr(pgc, "gt_core", lambda *a:
                        pgc.gauss_transform_culled_plain(*a))
    ref = pf.registration_filterreg(src, tgt, **kw)
    for a, b in ((res.transformation.rot, ref.transformation.rot),
                 (res.transformation.t, ref.transformation.t)):
        assert float((a - b).abs().max()) <= 1e-4


# --------------------------------------------------------------------------
# The whole-ICP kernel (K7) and the row-weighted culled E-step (K8)
# --------------------------------------------------------------------------

def _icp_pair(m, n, seed, dev):
    """A source and, as the target, its rotated (6 degrees), shifted, noisy
    copy among other points: once aligned every match is clear, so rounding
    flips no nearest neighbour."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (m, 3))
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    k = min(m, n)
    tgt = np.concatenate([src[:k] @ rot.T + 0.01
                          + 1e-3 * rng.standard_normal((k, 3)),
                          rng.uniform(-0.5, 0.5, (n - k, 3))])
    tgt = rng.permutation(tgt)
    return (torch.as_tensor(src, dtype=torch.float32, device=dev),
            torch.as_tensor(tgt, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("m,n", [(1024, 1024), (390, 420), (33, 700),
                                 (700, 33), (2000, 300)])
def test_icp_kernel_matches_plain(dev, m, n):
    """K7 against its plain version at a fixed depth: rot and t to 1e-5, the
    rmse to 1e-4 relative (summation order only); a warm start too."""
    from probreg_tpu_torch.ops import icp_cuda as pic

    src, tgt = _icp_pair(m, n, 21, dev)
    for init in (None, (torch.eye(3, device=dev) * 1.0,
                        torch.tensor([0.01, 0.0, -0.01], device=dev))):
        kw = dict(maxiter=15, tol=0.0)
        rot0, t0 = init if init else (None, None)
        before = pic.LAUNCHES["icp"]
        got = pic.run_icp_fused(src, tgt, rot0, t0, **kw)
        assert pic.LAUNCHES["icp"] == before + 1
        want = pic.run_icp_fused_plain(
            src[None], tgt[None], None,
            pic._init_rows(1, rot0, t0, src), **kw)[0]
        assert float((got[0].reshape(-1) - want[:9]).abs().max()) <= 1e-5
        assert float((got[1] - want[9:12]).abs().max()) <= 1e-5
        assert abs(float(got[2]) / float(want[12]) - 1.0) <= 1e-4
        assert int(got[3]) == int(want[13]) == 15


def test_icp_kernel_masked_equals_unpadded_and_batch_one_launch(dev):
    """A ragged batch is one launch, each pair bit for bit its own launch;
    registration_icp and registration_icp_batch launch K7 once each."""
    from probreg_tpu_torch import icp as picp
    from probreg_tpu_torch.ops import icp_cuda as pic
    from probreg_tpu_torch.utils import interop

    pairs = [_icp_pair(m, n, 30 + i, dev)
             for i, (m, n) in enumerate([(300, 500), (1024, 700), (64, 900),
                                         (512, 512)])]
    srcs, smask = interop.pad_ragged([p[0] for p in pairs], device=dev)
    tgts, tmask = interop.pad_ragged([p[1] for p in pairs], device=dev)
    pic.reset_launches()
    rot, t, rmse, it = pic.run_icp_fused_batch(srcs, tgts, smask, tmask,
                                               maxiter=30, tol=1e-7)
    assert pic.LAUNCHES["icp"] == 1
    for b, (s, x) in enumerate(pairs):
        one = pic.run_icp_fused(s, x, maxiter=30, tol=1e-7)
        assert torch.equal(rot[b], one[0]) and torch.equal(t[b], one[1])
        assert torch.equal(rmse[b], one[2]) and int(it[b]) == int(one[3])
    pic.reset_launches()
    res = picp.registration_icp_batch([p[0] for p in pairs],
                                      [p[1] for p in pairs])
    assert pic.LAUNCHES["icp"] == 1
    single = picp.registration_icp(pairs[0][0], pairs[0][1])
    assert pic.LAUNCHES["icp"] == 2
    assert torch.equal(res[0].transformation.rot, single.transformation.rot)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["bunny", "1024x1024", "masked 700/900"])
def test_icp_same_bits_for_every_cluster_size(dev, case):
    """K7 on one block and on clusters of 2, 4 and 8 blocks (forced with
    _icp_cuda's private argument) gives the same bits as the default (a
    cluster of 8 for one pair), at a fixed depth and with the stop test,
    from the identity and from a warm start."""
    from probreg_tpu_torch.ops import icp_cuda as pic

    if case == "bunny":
        src, tgt = _bunny(dev)
        smask = tmask = None
    else:
        src, tgt = _icp_pair(1024, 1024, 43, dev)
        smask, tmask = (_masks_700_900(dev, 9) if case.startswith("masked")
                        else (None, None))
    s_c, t_c, counts = pic.compact_batch(src[None], tgt[None], smask, tmask)
    init = pic._init_rows(1, torch.eye(3, device=dev),
                          torch.tensor([0.01, 0.0, -0.01], device=dev), s_c)
    assert pem.cluster_size(1, pem.sm_count(dev)) == 8
    for maxiter, tol in ((20, 0.0), (100, 1e-6)):
        for start in (None, init):
            kw = dict(maxiter=maxiter, tol=tol)
            outs = [pic._icp_cuda(s_c, t_c, counts, start, **kw, _cluster=g)
                    for g in (1, 2, 4, 8)]
            outs.append(pic._icp_cuda(s_c, t_c, counts, start, **kw))
            assert bool(torch.isfinite(outs[0]).all())
            for out in outs[1:]:
                assert torch.equal(out, outs[0])


def test_icp_batch_in_work_order_keeps_caller_order_and_pairs(dev):
    """A ragged batch of more pairs than SMs runs K7 on one block a pair in
    work_order (largest m n first): one launch, each row the caller's pair,
    equal bit for bit to that pair alone (on a cluster of 8)."""
    from probreg_tpu_torch.ops import icp_cuda as pic

    rng = np.random.default_rng(14)
    sms = pem.sm_count(dev)
    batch = sms + 12
    sizes = rng.integers(64, 300, (batch, 2))
    pairs = [_icp_pair(int(m), int(n), 300 + i, dev)
             for i, (m, n) in enumerate(sizes)]
    srcs, tgts, _, smask, tmask = _ragged_batch(pairs, 300, dev)
    _, _, counts = pic.compact_batch(srcs, tgts, smask, tmask)
    g, order = pem.launch_plan(batch, counts, sms)
    assert g == 1 and order.cpu().tolist() != list(range(batch))
    before = pic.LAUNCHES["icp"]
    got = pic.run_icp_fused_batch(srcs, tgts, smask, tmask, maxiter=30,
                                  tol=1e-6)
    assert pic.LAUNCHES["icp"] == before + 1
    assert bool(torch.isfinite(got[0]).all())
    for i, (s, x) in enumerate(pairs):
        one = pic.run_icp_fused(s, x, maxiter=30, tol=1e-6)
        for a, c in zip(got, one):
            assert torch.equal(a[i], c)


@pytest.mark.parametrize("kernel,m,n", [("frg_pt2pl", 2803, 2803),
                                        ("frg_pt2pt", 2803, 2803),
                                        ("icp", 8, 14264)])
def test_largest_pair_of_each_gate_launches_on_one_block(dev, kernel, m, n):
    """The shared-memory gates of K5 and K7 reserve the kernels' static
    shared memory at one block of 1,024 threads, their largest: the
    largest pair each gate admits launches there and gives a finite
    result, and one more point is refused."""
    from probreg_tpu_torch.ops import icp_cuda as pic

    rng = np.random.default_rng(15)
    src = torch.as_tensor(rng.uniform(-1, 1, (1, m, 3)), dtype=torch.float32,
                          device=dev)
    tgt = torch.as_tensor(rng.uniform(-1, 1, (1, n, 3)), dtype=torch.float32,
                          device=dev)
    if kernel == "icp":
        assert pic.fused_dims_ok(m, n) and not pic.fused_dims_ok(m, n + 1)
        out = pic._icp_cuda(src, tgt, None, None, maxiter=2, tol=0.0,
                            _cluster=1)
    else:
        assert pfc.fused_dims_ok(m, n) and not pfc.fused_dims_ok(m + 1, n)
        pt2pl = kernel == "frg_pt2pl"
        out = pfc._frg_cuda(src, tgt, tgt / tgt.norm(dim=2, keepdim=True)
                            if pt2pl else None, None, pt2pl=pt2pl, w=0.0,
                            maxiter=2, tol=0.0, update_sigma2=False,
                            sigma2_decay=1.0, min_sigma2=1e-4,
                            auto_sigma2=True, sigma2_0=0.0, _cluster=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[:, :12]).all())


def _wstash_inputs(m, n, dim, seed, dev, far=0):
    rng = np.random.default_rng(seed)
    ys, xs = _cloud(m, seed, dev, far=far), _cloud(n, seed + 1, dev)
    ys, xs = ys[:, :dim].contiguous(), xs[:, :dim].contiguous()
    x2 = (xs * xs).sum(1)
    v_t = torch.cat([xs.T, torch.ones_like(x2)[None], x2[None]])
    alpha = torch.as_tensor(rng.uniform(0.5, 1.5, m) / m,
                            dtype=torch.float32, device=dev)
    return ys, xs, v_t, alpha


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("sigma2", [0.5, 1e-3])
@pytest.mark.parametrize("tile_m,tile_n", [(128, 256), (1024, 1024),
                                           (700, 384)])
def test_wstash_kernels_match_plain(dev, dim, sigma2, tile_m, tile_n):
    """K8 against its plain version, dense and culled, 2-D and 3-D, ragged
    tiles (a far source cluster leaves whole tiles culled): nu_d, the
    moments and e1 to 1e-4 of their largest entry; dmin equal over active
    pairs to 1e-6 (both expanded form)."""
    from probreg_tpu_torch.ops import bcpd_cuda as pbc

    m, n = 3000, 2500
    ys, xs, v_t, alpha = _wstash_inputs(m, n, dim, 40, dev, far=600)
    rowlog = torch.log(alpha) - dim * 0.5 * np.log(2 * np.pi * sigma2)
    scal = torch.tensor([0.5 / sigma2, 0.1 / n, 1.1920929e-07], device=dev)
    mask, _ = pbc.cull_mask(ys, xs, rowlog, scal[0], tile_m, tile_n)
    before = dict(pbc.LAUNCHES)
    got = pbc.wstash_estep(ys, xs, rowlog, v_t, scal, mask, tile_m, tile_n)
    assert pbc.LAUNCHES["wstash_den"] == before["wstash_den"] + 1
    assert pbc.LAUNCHES["wstash_moment"] == before["wstash_moment"] + 1
    want = pbc.wstash_estep_plain(ys, xs, rowlog, v_t, scal, mask, tile_m,
                                  tile_n)
    for name, i in (("nu_d", 0), ("mom", 1), ("e1", 3)):
        _close(got[i], want[i], name)
    assert torch.equal(torch.isinf(got[2]), torch.isinf(want[2]))
    fin = torch.isfinite(want[2])
    assert float((got[2] - want[2])[fin].abs().max()) <= 1e-6


def test_wstash_wrapper_dmin_bound_and_no_plain_call(dev, monkeypatch):
    from probreg_tpu_torch import icp as picp
    from probreg_tpu_torch.ops import bcpd_cuda as pbc

    def refuse(*a):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pbc, "wstash_estep_plain", refuse)
    ys, xs, v_t, alpha = _wstash_inputs(5000, 4000, 3, 50, dev, far=800)
    sigma2 = 1e-3
    rowlog = torch.log(alpha) - 1.5 * np.log(2 * np.pi * sigma2)
    _, _, dmin, _ = pbc.bcpd_estep_culled(ys, xs, rowlog, v_t, 0.0, sigma2,
                                          tile_m=256, tile_n=256)
    nn_d2, _ = picp._nearest_t(ys.T, xs.T)
    assert float((dmin - nn_d2).max()) <= 1e-6


def test_bcpd_culled_registration_matches_plain(dev, monkeypatch):
    """registration_bcpd through K8 (forced at test size) against the same
    registration through the plain version at a fixed depth; the launches
    are one of each pass per E-step. The low-rank VI amplifies rounding, so
    the kernel is held to 10x the spread between two plain versions that
    differ only in the summation order (tiles of 1024 and of 512)."""
    from probreg_tpu_torch import bcpd as pb
    from probreg_tpu_torch.ops import bcpd_cuda as pbc

    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1 << 20)
    rng = np.random.default_rng(60)
    src = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = (src @ rot.T + 0.05).astype(np.float32)
    kw = dict(rank=32, maxiter=2, tol=0.0, w=0.0, callbacks=[],
              normalize=True, callback_chunk=1, return_last=True)
    pbc.reset_launches()
    res = pb._registration_bcpd_impl(src, tgt, **kw)[2]
    assert pbc.LAUNCHES["wstash_den"] == 3
    assert pbc.LAUNCHES["wstash_moment"] == 3
    monkeypatch.setattr(pbc, "wstash_estep", pbc.wstash_estep_plain)
    ref = pb._registration_bcpd_impl(src, tgt, **kw)[2]
    culled = pbc.bcpd_estep_culled
    monkeypatch.setattr(pbc, "bcpd_estep_culled", lambda *a: culled(
        *a, tile_m=512, tile_n=512))
    other = pb._registration_bcpd_impl(src, tgt, **kw)[2]

    def diff(a, b):  # the final iterates: rot, t and v
        return np.array([
            np.abs(a["tf_init_params"]["rot"] - b["tf_init_params"]["rot"])
            .max(),
            np.abs(a["tf_init_params"]["t"] - b["tf_init_params"]["t"])
            .max(),
            np.abs(a["v_init"] - b["v_init"]).max()])

    assert np.all(diff(res, ref) <= np.maximum(10.0 * diff(other, ref),
                                               1e-6))


def _gmm_level_inputs(n, level, dev, seed=70):
    """A blobby surface of n points centred, the initial tree of a 2-level
    build, and level ``level``'s state and parent map (level 1's parents
    from one level-0 run of the plain version)."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc
    from probreg_tpu_torch.utils.datagen import blobby_surface

    pts = torch.as_tensor(blobby_surface(n, seed=seed), device=dev)
    pts = (pts - pts.mean(0))[None].contiguous()
    idxs = torch.as_tensor(np.random.default_rng(seed).integers(0, n, 64),
                           device=dev)[None]
    cnt = torch.tensor([n], device=dev)
    pi, mu, cov = pgt._init_tree(pts, idxs, cnt, 2)
    parent = torch.zeros((1, n), dtype=torch.int64, device=dev)
    if level == 1:
        st0 = pgt._pack_level(pi[:, :8], mu[:, :8], cov[:, :8])
        parent = pgc.level_em_plain(pts, cnt, st0, parent, lambda_s=1e-3,
                                    lambda_d=1e-4)[1]
    lb, le = pgt._level_start(level), pgt._level_start(level + 1)
    return pts, pgt._pack_level(pi[:, lb:le], mu[:, lb:le],
                                cov[:, lb:le]), parent


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("maxiter", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_gmmtree_level_em_kernel_matches_plain(dev, level, maxiter, masked):
    """K9 against its plain version at a fixed depth (lambda_s = 0), per
    field of the state (pi, mu, cov) and for q: within 1e-4 of the largest
    entry, or within 3x the spread between the plain version in f32 and
    in f64 on the same inputs (the EM amplifies rounding over iterations:
    a covariance m2 / m0 - mu mu^T of a small node cancels ~3 digits). The
    hard child agrees on all but 0.1 % of the points (near-ties). A padded
    batch of two is each pair's own launch bit for bit."""
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc

    pts, state, parent = _gmm_level_inputs(3000, level, dev)
    kw = dict(lambda_s=0.0, lambda_d=1e-4, maxiter=maxiter)
    before = pgc.LAUNCHES["gmmtree_level_em"]
    st, child, diag = pgc.level_em(pts, None, state, parent, **kw)
    assert pgc.LAUNCHES["gmmtree_level_em"] == before + 1
    want = pgc.level_em_plain(pts, None, state, parent, **kw)
    w64 = pgc.level_em_plain(pts.double(), None, state.double(), parent,
                             **kw)
    for sl in (slice(0, 1), slice(1, 4), slice(4, 10)):
        err = float((st[..., sl] - want[0][..., sl]).abs().max())
        spread = float((want[0][..., sl].double() - w64[0][..., sl])
                       .abs().max())
        scale = float(want[0][..., sl].abs().max())
        assert err <= max(1e-4 * scale + 1e-6, 3.0 * spread), (sl, err,
                                                                spread)
    assert float((child != want[1]).float().mean()) <= 1e-3
    assert int(diag[0, 1]) == maxiter
    q, q32, q64 = float(diag[0, 0]), float(want[2][0, 0]), float(
        w64[2][0, 0])
    assert abs(q - q32) <= max(1e-5 * abs(q32), 3.0 * abs(q32 - q64))
    if masked:
        n = 2000
        x = torch.zeros(2, 3000, 3, device=dev)
        x[0], x[1, :n] = pts[0], pts[0, :n]
        par = torch.zeros(2, 3000, dtype=torch.int64, device=dev)
        par[0], par[1, :n] = parent[0], parent[0, :n]
        sts = torch.cat([state, state])
        got = pgc.level_em(x, torch.tensor([3000, n], device=dev), sts, par,
                           **kw)
        one = pgc.level_em(x[1:, :n], None, state, par[1:, :n], **kw)
        assert torch.equal(got[0][1], one[0][0])
        assert torch.equal(got[1][1, :n], one[1][0])
        assert torch.equal(got[0][0], st[0])


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("maxiter", [1, 4])
def test_gmmtree_level_em_many_blocks_matches_plain(dev, level, maxiter):
    """K9 on one pair of 20,000 points, which the wrapper spreads over
    several blocks (a cooperative launch), against its plain version under
    test_gmmtree_level_em_kernel_matches_plain's tolerance."""
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc

    pts, state, parent = _gmm_level_inputs(20_000, level, dev)
    cap = pgc.level_capacity(state.shape[1], dev)
    assert pgc.blocks_per_pair(20_000, 1, cap) > 1
    kw = dict(lambda_s=0.0, lambda_d=1e-4, maxiter=maxiter)
    st, child, diag = pgc.level_em(pts, None, state, parent, **kw)
    want = pgc.level_em_plain(pts, None, state, parent, **kw)
    w64 = pgc.level_em_plain(pts.double(), None, state.double(), parent,
                             **kw)
    for sl in (slice(0, 1), slice(1, 4), slice(4, 10)):
        err = float((st[..., sl] - want[0][..., sl]).abs().max())
        spread = float((want[0][..., sl].double() - w64[0][..., sl])
                       .abs().max())
        scale = float(want[0][..., sl].abs().max())
        assert err <= max(1e-4 * scale + 1e-6, 3.0 * spread), (sl, err,
                                                                spread)
    assert float((child != want[1]).float().mean()) <= 1e-3
    assert int(diag[0, 1]) == maxiter
    q, q32, q64 = float(diag[0, 0]), float(want[2][0, 0]), float(
        w64[2][0, 0])
    assert abs(q - q32) <= max(1e-5 * abs(q32), 3.0 * abs(q32 - q64))


@pytest.mark.parametrize("lambda_s", [0.0, 1e-3])
def test_gmmtree_level_em_same_bits_for_any_blocks(dev, lambda_s):
    """The same pairs through one block per pair and through many (forced
    with level_launch's private argument) give the same state, child and
    diag bit for bit; so does a ragged batch against each pair alone, with
    a stop test that parts the pairs (lambda_s 1e-3)."""
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc

    pts, state, parent = _gmm_level_inputs(20_000, 1, dev)
    kw = dict(lambda_s=lambda_s, lambda_d=1e-4, maxiter=6)
    pts_s, seg, _ = pgc.sort_by_parent(pts, None, parent, 8)
    outs = [pgc.level_launch(pts_s, seg, state, **kw, _blocks=g)
            for g in (1, 2, 7, 19)]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)
    n = 9000
    x = torch.zeros_like(pts).repeat(2, 1, 1)
    x[0], x[1, :n] = pts[0], pts[0, :n]
    par = torch.zeros_like(parent).repeat(2, 1)
    par[0], par[1, :n] = parent[0], parent[0, :n]
    counts = torch.tensor([20_000, n], device=dev)
    got = pgc.level_em(x, counts, torch.cat([state, state]), par, **kw)
    for b, m in enumerate((20_000, n)):
        one = pgc.level_em(x[b:b + 1, :m], None, state, par[b:b + 1, :m],
                           **kw)
        assert torch.equal(got[0][b], one[0][0])
        assert torch.equal(got[1][b, :m], one[1][0])
        assert torch.equal(got[2][b], one[2][0])


def _gmm_reg_inputs(dev, n=2000, seed=71):
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.utils import se3_op
    from probreg_tpu_torch.utils.datagen import blobby_surface

    src = blobby_surface(n, seed=seed)
    rot = se3_op.euler2mat(*np.deg2rad([4.0, -3.0, 6.0])).numpy()
    tgt = torch.as_tensor(src @ rot.T + 0.02, dtype=torch.float32,
                          device=dev)
    tree = pgt.GMMTree(src, device=dev)._nodes
    return tgt, tree


@pytest.mark.parametrize("case", ["single", "warm", "masked"])
def test_gmmtree_reg_kernel_matches_plain(dev, case):
    """K10 against its plain version at a fixed depth (tol 0): rot and t to
    1e-5 (the descent from differences in both, sums in other orders)."""
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc

    tgt, tree = _gmm_reg_inputs(dev)
    kw = dict(max_level=2, lambda_c=0.01, maxiter=10, tol=0.0)
    rot0 = t0 = tmask = None
    if case == "warm":
        rot0 = torch.tensor([[1.0, -0.02, 0.0], [0.02, 1.0, 0.0],
                             [0.0, 0.0, 1.0]], device=dev)
        t0 = torch.tensor([0.01, 0.0, -0.01], device=dev)
    x = tgt
    if case == "masked":
        x = torch.cat([tgt, torch.full((300, 3), 9.0, device=dev)])
        tmask = torch.cat([torch.ones(2000, device=dev),
                           torch.zeros(300, device=dev)])
    before = pgc.LAUNCHES["gmmtree_reg"]
    got = pgc.run_gmmtree_reg_fused(x, *tree, rot0, t0, tmask, **kw)
    assert pgc.LAUNCHES["gmmtree_reg"] == before + 1
    ys, table, cen = pgc.reg_tables(tgt[None], torch.tensor([2000],
                                                            device=dev),
                                    *(a[None] for a in tree))
    rot0_ = torch.eye(3, device=dev) if rot0 is None else rot0
    t0_ = torch.zeros(3, device=dev) if t0 is None else t0
    init = torch.cat([rot0_.reshape(9), t0_ + rot0_ @ cen[0] - cen[0]])
    want = pgc.run_gmmtree_reg_fused_plain(
        ys, torch.tensor([2000], device=dev), table, init[None],
        max_level=2, maxiter=10, tol=0.0, lambda_c=0.01)[0]
    rot = want[:9].reshape(3, 3)
    t = want[9:12] + cen[0] - rot @ cen[0]
    assert float((got[0] - rot).abs().max()) <= 1e-5
    assert float((got[1] - t).abs().max()) <= 1e-5
    assert int(got[3]) == 10
    if case == "masked":
        one = pgc.run_gmmtree_reg_fused(tgt, *tree, **kw)
        for a, b in zip(got, one):
            assert torch.equal(a, b)


def test_gmmtree_batch_is_one_launch_of_each_and_equals_single(dev,
                                                               monkeypatch):
    """registration_gmmtree launches K9 once per level and K10 once, and
    never the plain versions; a ragged batch launches K9 once per level
    and K10 once, and each pair's registration on its tree is its
    single-pair launch bit for bit."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc
    from probreg_tpu_torch.utils.datagen import blobby_surface

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(pgc, "level_em_plain", refuse)
    monkeypatch.setattr(pgc, "run_gmmtree_reg_fused_plain", refuse)
    srcs = [blobby_surface(n, seed=n) for n in (700, 1000, 400)]
    tgts = [s[::-1][:m].copy() for s, m in zip(srcs, (650, 1000, 380))]
    pgc.reset_launches()
    one = pgt.registration_gmmtree(srcs[0], tgts[0])
    assert pgc.LAUNCHES == {"gmmtree_level_em": 2, "gmmtree_reg": 1}
    pgc.reset_launches()
    res = pgt.registration_gmmtree_batch(srcs, tgts, maxiter=20, tol=1e-4)
    assert pgc.LAUNCHES == {"gmmtree_level_em": 2, "gmmtree_reg": 1}
    assert len(res) == 3 and one.q is not None
    # The batch's registration against its own trees, pair by pair.
    from probreg_tpu_torch.utils import interop

    idxs = pgt._leaf_indices(0, [700, 1000, 400], 64, dev)
    src_p, smask = interop.pad_ragged(srcs, device=dev)
    tgt_p, tmask = interop.pad_ragged(tgts, device=dev)
    trees = pgt._build_fused(src_p, idxs, smask.sum(1).long(),
                             max_level=2, lambda_s=1e-3, lambda_d=1e-4)
    kw = dict(max_level=2, lambda_c=0.01, maxiter=20, tol=1e-4)
    batch = pgc.run_gmmtree_reg_fused_batch(tgt_p, *trees, tmasks=tmask,
                                            **kw)
    for b, (r, t) in enumerate(zip(res, tgts)):
        single = pgc.run_gmmtree_reg_fused(
            torch.as_tensor(t, device=dev), *(a[b] for a in trees), **kw)
        assert torch.equal(batch[0][b], single[0])
        assert torch.equal(batch[1][b], single[1])
        assert torch.equal(r.transformation.rot,
                           single[0].T)
    torch.cuda.synchronize()


def _reg_batch(dev, sizes, seed=71):
    """K10's prepared inputs for rotated samples of blobby_surface of the
    given sizes (each pair's tree built from its source), padded into one
    batch: (ys, counts, table, init)."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc
    from probreg_tpu_torch.utils import se3_op
    from probreg_tpu_torch.utils.datagen import blobby_surface

    rot = se3_op.euler2mat(*np.deg2rad([3.0, -2.0, 5.0])).numpy()
    n_cap = max(sizes)
    tgts = torch.zeros((len(sizes), n_cap, 3), device=dev)
    trees = []
    for b, n in enumerate(sizes):
        src = blobby_surface(n, seed=seed + b)
        tgts[b, :n] = torch.as_tensor(
            blobby_surface(n, seed=seed + 50 + b) @ rot.T, device=dev)
        trees.append(pgt.GMMTree(src, device=dev)._nodes)
    trees = [torch.stack(a) for a in zip(*trees)]
    counts = torch.tensor(sizes, dtype=torch.int32, device=dev)
    ys, table, _ = pgc.reg_tables(tgts, counts.long(), *trees)
    init = torch.zeros((len(sizes), 12), device=dev)
    init[:, [0, 4, 8]] = 1.0
    return ys, counts, table, init


@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_gmmtree_reg_same_bits_for_any_blocks(dev, tol):
    """K10 on one 150k pair through 1, 3, 16 and the capacity's blocks
    (forced with _reg_cuda's private argument) and the default gives the
    same rows bit for bit, one launch each; the default spreads the pair
    over more than one block."""
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc

    ys, counts, table, init = _reg_batch(dev, [150_000])
    cap = pgc.reg_capacity(table.shape[1], dev)
    assert pgc.blocks_per_pair(150_000, 1, cap) > 1
    kw = dict(max_level=2, maxiter=20, tol=tol, lambda_c=0.01)
    outs = []
    for g in (1, 3, 16, cap, None):
        before = pgc.LAUNCHES["gmmtree_reg"]
        outs.append(pgc._reg_cuda(ys, counts, table, init, **kw, _blocks=g))
        assert pgc.LAUNCHES["gmmtree_reg"] == before + 1
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert bool(torch.isfinite(outs[0]).all())


def test_gmmtree_reg_ragged_batch_equals_its_pairs_for_any_blocks(dev):
    """A ragged batch (150k, 20k, 3,000 and 700 targets) through K10 with
    the default blocks, 1 and 3 blocks per pair equals each pair alone bit
    for bit (the 150k pair alone on many blocks, the 700-point pair on
    one), at three tolerances of the stop test, one of which parts the
    pairs."""
    from probreg_tpu_torch.ops import gmmtree_cuda as pgc

    sizes = [150_000, 20_000, 3000, 700]
    ys, counts, table, init = _reg_batch(dev, sizes, seed=81)
    parted = False
    for tol in (1e-5, 1e-3, 1e-1):
        kw = dict(max_level=2, maxiter=30, tol=tol, lambda_c=0.01)
        batch = [pgc._reg_cuda(ys, counts, table, init, **kw, _blocks=g)
                 for g in (None, 1, 3)]
        for out in batch[1:]:
            assert torch.equal(out, batch[0])
        parted |= len(set(batch[0][:, 13].tolist())) > 1
        for b, n in enumerate(sizes):
            one = pgc._reg_cuda(ys[b:b + 1, :n].contiguous(),
                                counts[b:b + 1], table[b:b + 1],
                                init[b:b + 1], **kw)
            assert torch.equal(one[0], batch[0][b])
    assert parted   # some tol stops the pairs at different iterations


# --------------------------------------------------------------------------
# K11 (stash_den_raw, stash_finish) and the sharded runners
# --------------------------------------------------------------------------

def _shard_den_total(shards, xs, scal, tile_n):
    """The raw column sums of the target over every source shard, from K11
    runs that finalize locally (the all_reduce of one process's shards)."""
    total = torch.zeros_like(xs[:, 0])
    for ys, tm, mask in shards:
        seen = []
        pec.stash_estep(ys, xs, scal, mask, tm, tile_n,
                        reduce_den=lambda d: seen.append(d.clone()))
        assert len(seen) == 1
        total += seen[0]
    return total


@pytest.mark.parametrize("sigma2", [0.5, 0.01])
@pytest.mark.parametrize("tile_m,tile_n", [(96, 256), (512, 1024)])
def test_stash_den_raw_kernel_matches_plain(dev, sigma2, tile_m, tile_n):
    """K11's raw column sums, one (n,) reduction per E-step, against
    stash_den_raw_plain stripe by stripe, and K11 + stash_finish + K3's
    pass B (three launches) against the plain version, with stripes that
    have no active tile (the far cluster)."""
    m, n = 3000, 2500
    ys, xs = _cloud(m, 3, dev), _cloud(n, 4, dev, far=700)
    scal = pec._scalars(sigma2, 0.05, m, n, 3, dev)
    mask = pec._active_mask(*pec._tile_bounds(ys, tile_m),
                            *pec._tile_bounds(xs, tile_n), scal[0])
    dens = []
    before = dict(pec.LAUNCHES)
    got = pec.stash_estep(ys, xs, scal, mask, tile_m, tile_n,
                          reduce_den=lambda d: dens.append(d.clone()))
    made = {k: pec.LAUNCHES[k] - before[k] for k in before}
    assert made == {**{k: 0 for k in before}, "stash_den_raw": 1,
                    "stash_finish": 1, "stash_moment": 1}
    assert len(dens) == 1 and dens[0].shape == (n,)
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)
    for j, den in enumerate(dens[0].split(tile_n)):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        act = mask[:, j].repeat_interleave(tile_m)[:m]
        _, want = pec.stash_den_raw_plain(ys, y2, xs[cols], x2[cols], scal,
                                          act, mask.shape[0], tile_m)
        _close(den, want, f"den_raw stripe {j}")
    want = pec.stash_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("sigma2", [0.5, 0.01, 1e-3])
def test_stash_den_raw_one_shard_equals_k3_bit_for_bit(dev, sigma2):
    """At one m-shard (the reduction is the identity), K11 + stash_finish
    + K3's pass B give K3's pt1, p1, px and xx bit for bit: the same sums
    in the same order."""
    m, n = 4000, 3000
    ys, xs = _cloud(m, 8, dev), _cloud(n, 9, dev, far=500)
    scal = pec._scalars(sigma2, 0.05, m, n, 3, dev)
    mask = pec._active_mask(*pec._tile_bounds(ys, 512),
                            *pec._tile_bounds(xs, 1024), scal[0])
    k3 = pec.stash_estep(ys, xs, scal, mask, 512, 1024)
    k11 = pec.stash_estep(ys, xs, scal, mask, 512, 1024,
                          reduce_den=lambda d: None)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), k11, k3):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("parts,m", [(2, 3000), (4, 3000), (4, 9)])
def test_stash_den_raw_sharded_sum_matches_k3(dev, parts, m):
    """The source in ``parts`` shards (9 rows in 4 leave the last shard
    empty: 3, 3, 3, 0), their raw sums added: the shards' p1 /
    px together, and every shard's pt1 and xx, equal the unsharded K3
    E-step within the kernel tolerance."""
    from probreg_tpu_torch.parallel.mesh import shard_range

    n = 2500
    ys, xs = _cloud(m, 10, dev), _cloud(n, 11, dev, far=300)
    scal = pec._scalars(0.01, 0.05, m, n, 3, dev)
    tm0 = min(256, pec._round_up(m, 8))
    want = pec.stash_estep(ys, xs, scal, pec._active_mask(
        *pec._tile_bounds(ys, tm0), *pec._tile_bounds(xs, 512), scal[0]),
        tm0, 512)
    shards, rows = [], []
    for i in range(parts):
        r0, r1 = shard_range(m, parts, i)
        y = ys[r0:r1]
        tm = max(8, min(256, pec._round_up(y.shape[0], 8)))
        shards.append((y, tm, pec._active_mask(
            *pec._tile_bounds(y, tm), *pec._tile_bounds(xs, 512), scal[0])))
        rows.append((r0, r1))
    assert (shards[-1][0].shape[0] == 0) == (m == 9)
    total = _shard_den_total(shards, xs, scal, 512)
    p1, px = torch.zeros_like(want[1]), torch.zeros_like(want[2])
    for (y, tm, mask), (r0, r1) in zip(shards, rows):
        got = pec.stash_estep(y, xs, scal, mask, tm, 512,
                              reduce_den=lambda d: d.copy_(total))
        p1[r0:r1], px[r0:r1] = got[1], got[2]
        _close(got[0], want[0], "pt1")
        _close(got[3], want[3], "xx")
    _close(p1, want[1], "p1")
    _close(px, want[2], "px")


@pytest.fixture
def nccl_world_one(dev, tmp_path):
    """A process group of one rank under NCCL (file:// rendezvous)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_sharded_runners_on_one_nccl_rank(dev, nccl_world_one, monkeypatch):
    """registration_cpd_sharded on a 1-D mesh and registration_cpd_2d on a
    1 x 1 mesh, culled, at 20k points: the 2-D run goes through K11 (one
    den reduction and three launches per E-step) and never K3a, the 1-D
    run through K3; both equal the plain-driven run of the same runner within 1e-4 and
    each other within 1e-4 (tile sizes and the reduction differ)."""
    from probreg_tpu_torch.parallel import make_mesh, make_mesh_2d, mesh
    from probreg_tpu_torch.parallel import sharded, sharded2d

    rng = np.random.default_rng(12)
    src = rng.uniform(-1, 1, (20_000, 3)).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = (src @ rot.T + 0.05).astype(np.float32)
    kw = dict(maxiter=15, tol=0.0, use_culled=True, device=dev)
    one_d, two_d = make_mesh(), make_mesh_2d(1, 1)
    runs = {}
    for name, fn, m in (("1d", sharded.registration_cpd_sharded, one_d),
                        ("2d", sharded2d.registration_cpd_2d, two_d)):
        pec.reset_launches()
        mesh.reset_counts()
        runs[name] = fn(src, tgt, "rigid", mesh=m, **kw)
        torch.cuda.synchronize()
        got = {k: v for k, v in pec.LAUNCHES.items() if v}
        assert mesh.COUNTS["esteps"] == 15
        if name == "2d":
            assert got == {"stash_den_raw": 15, "stash_finish": 15,
                           "stash_moment": 15}
            assert mesh.COUNTS["den_all_reduce"] == 15
        else:
            assert set(got) == {"stash_den", "stash_moment"}
    for a, b in ((runs["1d"], runs["2d"]),):
        assert float((a.transformation.rot - b.transformation.rot)
                     .abs().max()) <= 1e-4
        assert float((a.transformation.t - b.transformation.t)
                     .abs().max()) <= 1e-4
    monkeypatch.setattr(pec, "stash_estep", pec.stash_estep_plain)
    plain = sharded2d.registration_cpd_2d(src, tgt, "rigid", mesh=two_d, **kw)
    assert float((plain.transformation.rot - runs["2d"].transformation.rot)
                 .abs().max()) <= 1e-4


# --------------------------------------------------------------------------
# Nonrigid CPD
# --------------------------------------------------------------------------

def _nonrigid_clouds(name):
    """The fish of examples/cpd_nonrigid2d.py, or 1,000 points uniform in
    [-1, 1]^3 moved by 0.05 sin(2 x[::-1])."""
    if name == "fish":
        import os

        data = os.path.join(os.path.dirname(__file__), "..", "data")
        return tuple(np.loadtxt(os.path.join(data, f"fish_{k}.txt"))
                     .astype(np.float32) for k in ("source", "target"))
    rng = np.random.default_rng(0)
    src = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    return src, (src + 0.05 * np.sin(2.0 * src[:, ::-1])).astype(np.float32)


@pytest.mark.parametrize("cloud", ["fish", "3d"])
@pytest.mark.parametrize("kind", ["nonrigid", "nonrigid_constrained"])
def test_dense_nonrigid_runs_k2_once_per_iteration(dev, cloud, kind):
    """Every iteration of the dense nonrigid and constrained loops is one
    launch of K2 and no other kernel; use_pallas=False launches none. At 10
    iterations (before sigma2 reaches the f32 floor, where the M x M solve
    makes the loop chaotic) the kernel-driven run is within 5e-5 of the
    plain-driven one (the CPU tests hold the packages to that bar). At
    that depth sigma2 is still ~0.2 in 3-D, where the field has not yet
    closed the residual: quality is the smoke's and the CPU tests'."""
    from probreg_tpu_torch import cpd as pcpd

    src, tgt = _nonrigid_clouds(cloud)
    kw = {} if kind == "nonrigid" else dict(
        beta=0.5, lmd=1.0, alpha=1e-3, idx_source=np.arange(0, len(src), 5),
        idx_target=np.arange(0, len(src), 5))
    pec.reset_launches()
    res = pcpd.registration_cpd(src, tgt, kind, maxiter=10, tol=0.0,
                                device=dev, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in pec.LAUNCHES.items() if v} == \
        {"estep_small": 10}
    pec.reset_launches()
    plain = pcpd.registration_cpd(src, tgt, kind, maxiter=10, tol=0.0,
                                  device=dev, use_pallas=False, **kw)
    torch.cuda.synchronize()
    assert not any(pec.LAUNCHES.values())
    moved = res.transformation.transform(src)
    assert bool(torch.isfinite(moved).all())
    assert float((moved - plain.transformation.transform(src)).abs()
                 .max()) <= 5e-5


def test_nonrigid_step_api_runs_k2(dev):
    """NonRigidCPD.expectation_step is one K2 launch; maximization_step
    with sigma2_p runs no kernel; five iterations of the two equal the
    plain-driven ones within 5e-5."""
    from probreg_tpu_torch import cpd as pcpd

    src, tgt = _nonrigid_clouds("3d")
    runs = []
    for use_pallas in (None, False):
        reg = pcpd.NonRigidCPD(src, use_pallas=use_pallas, device=dev)
        ts, sigma2 = torch.as_tensor(src, device=dev), 0.1
        pec.reset_launches()
        for _ in range(5):
            res = reg.maximization_step(
                tgt, reg.expectation_step(ts, tgt, sigma2), sigma2)
            ts, sigma2 = res.transformation.transform(src), res.sigma2
        torch.cuda.synchronize()
        runs.append(ts)
        assert pec.LAUNCHES["estep_small"] == (5 if use_pallas is None else 0)
    assert float((runs[0] - runs[1]).abs().max()) <= 5e-5


def test_nonrigid_sharded_on_one_nccl_rank(dev, nccl_world_one):
    """The low-rank nonrigid kinds on one NCCL rank, 4,096 points of
    examples/cpd_nonrigid_lowrank.py's surface (rank 60, 20 iterations):
    the 1-D runner (no kernel) within 1e-4 of cpd.registration_cpd (the
    same Nystrom factors); the culled 1 x 1 mesh through K11's route, its
    three launches and one den reduction per E-step, within 1e-2 of it
    (its factors come from the Morton-sorted source, so other landmarks)
    and its residual within 5 % of it."""
    from probreg_tpu_torch import cpd as pcpd
    from probreg_tpu_torch.parallel import make_mesh, make_mesh_2d, mesh
    from probreg_tpu_torch.parallel import sharded, sharded2d

    g = np.linspace(0.0, 1.0, 64)
    xx, yy = np.meshgrid(g, g)
    src = np.stack([xx, yy, 0.3 * np.sin(2 * np.pi * xx)
                    * np.cos(2 * np.pi * yy)], -1).reshape(-1, 3) \
        .astype(np.float32)
    tgt = src + 0.08 * np.stack(
        [np.sin(np.pi * yy), np.cos(np.pi * xx), np.sin(np.pi * (xx + yy))],
        -1).reshape(-1, 3).astype(np.float32)
    kw = dict(maxiter=20, tol=0.0, rank=60, device=dev)
    one = pcpd.registration_cpd(src, tgt, "nonrigid", **kw)
    moved = one.transformation.transform(src)
    tgt_d = torch.as_tensor(tgt, device=dev)

    def residual(x):
        return float((x - tgt_d).abs().mean())

    mesh.reset_counts()
    pec.reset_launches()
    r1 = sharded.registration_cpd_sharded(src, tgt, "nonrigid",
                                          mesh=make_mesh(), **kw)
    assert not any(pec.LAUNCHES.values())
    assert float((r1.transformation.transform(src) - moved).abs().max()) \
        <= 1e-4
    mesh.reset_counts()
    pec.reset_launches()
    r2 = sharded2d.registration_cpd_2d(src, tgt, "nonrigid",
                                       mesh=make_mesh_2d(1, 1),
                                       use_culled=True, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in pec.LAUNCHES.items() if v} == {
        "stash_den_raw": 20, "stash_finish": 20, "stash_moment": 20}
    assert mesh.COUNTS["den_all_reduce"] == 20
    moved2 = r2.transformation.transform(src)
    assert float((moved2 - moved).abs().max()) <= 1e-2
    assert residual(moved2) <= 1.05 * residual(moved)

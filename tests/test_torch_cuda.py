"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so on a GPU machine without JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| + 1e-6 per output,
the criterion of chip_smoke.py (the two evaluate d2 in different f32
operation orders and sum in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
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

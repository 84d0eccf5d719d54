"""The port's E-step (probreg_tpu_torch.ops) held to the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode) and the port's counterpart, which runs its kernels' plain
versions here because the tensors lie on the CPU.

Tolerance for the moments: rtol 1e-5, atol 1e-6, elementwise. The two
packages evaluate d2 = |y|^2 + |x|^2 - 2 y.x in different f32 operation
orders, and that cancellation noise (~eps |y|^2) is multiplied by
1/(2 sigma2) in the exponent. The clouds are therefore centred, like the
EM loops centre them, and the annealed case uses sigma2 = 0.1, where tiles
are culled and the noise stays near half the tolerance (at sigma2 = 0.05
it would exceed it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu.ops import estep as jeo  # noqa: E402
from probreg_tpu.ops import estep_pallas as jep  # noqa: E402
from probreg_tpu.ops import spatial as jsp  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch.ops import estep as peo  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops import spatial as psp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's workers torch's default pool
    oversubscribes the cores, and this file's many small products spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL, ATOL = 1e-5, 1e-6
TILE = 128


def _two_blobs(m=640, n=700, seed=11):
    """Two blobs on the z axis (Morton's top bit), 384 points in the first:
    the first three 128-tiles of each cloud lie in one blob, so separated
    tiles can be culled."""
    rng = np.random.default_rng(seed)

    def cloud(k):
        c = np.zeros((k, 3), np.float32)
        c[:384, 2], c[384:, 2] = -3.0, 3.0
        return (c + rng.normal(0, 0.2, (k, 3))).astype(np.float32)

    return cloud(m), cloud(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_moments(ref, out):
    for name, a, b in zip(ref._fields, ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _sorted(src, tgt):
    return (src[np.asarray(jsp.morton_order(src))],
            tgt[np.asarray(jsp.morton_order(tgt))])


@pytest.mark.parametrize("sigma2", [5.0, 0.1])
@pytest.mark.parametrize("w", [0.0, 0.05])
def test_estep_small_matches_reference_kernel(sigma2, w):
    src, tgt = _two_blobs()
    ref = jep.estep_small(src, tgt, jnp.float32(sigma2), w, interpret=True)
    out = pec.estep_small(_t(src), _t(tgt), sigma2, w)
    _assert_moments(ref, out)


@pytest.mark.parametrize("sigma2,culled", [(5.0, False), (0.1, True)])
def test_stash_estep_matches_reference(sigma2, culled):
    """Dense and culled regimes: against the reference stash kernels
    (exact branch) and the reference's plain streaming E-step."""
    src, tgt = _two_blobs()
    s_s, t_s = _sorted(src, tgt)
    frac_ref = float(jep.active_tile_fraction(s_s, t_s, sigma2, TILE, TILE))
    frac = float(pec.active_tile_fraction(_t(s_s), _t(t_s), sigma2, TILE,
                                          TILE))
    assert frac == pytest.approx(frac_ref)
    assert (frac < 1.0) == culled, frac

    w = 0.05
    out = pec.estep_auto(_t(src), _t(tgt), sigma2, w, tile_m=TILE,
                         tile_n=TILE)
    ref = jep.estep_auto(src, tgt, jnp.float32(sigma2), w, tile_m=TILE,
                         tile_n=TILE, interpret=True, fast_start=False)
    _assert_moments(ref, out)
    _assert_moments(jeo.estep_xla(src, tgt, jnp.float32(sigma2), w), out)

    # Pre-sorted mode (the EM loop's): moments stay in the sorted order.
    out_s = pec.estep_auto(_t(s_s), _t(t_s), sigma2, w, tile_m=TILE,
                           tile_n=TILE, assume_sorted=True)
    _assert_moments(jeo.estep_xla(s_s, t_s, jnp.float32(sigma2), w), out_s)


def test_stash_ragged_tiles_and_all_culled_stripes():
    """Tile sizes that divide neither cloud, and a sigma2 so small that
    whole stripes are culled: those columns get pt1 = 0, exactly as the
    reference's normalizer gives them."""
    src, tgt = _two_blobs(600, 520, seed=3)
    tgt[:200, 2] += 40.0  # far away from every source tile
    s_s, t_s = _sorted(src, tgt)
    out = pec.estep_auto(_t(s_s), _t(t_s), 0.1, 0.0, tile_m=96,
                         tile_n=128, assume_sorted=True)
    ref = jeo.estep_xla(s_s, t_s, jnp.float32(0.1), 0.0)
    _assert_moments(ref, out)
    far = t_s[:, 2] > 20.0
    assert np.all(out.pt1.numpy()[far] == 0.0)


@pytest.mark.parametrize("block", [None, 128])
@pytest.mark.parametrize("sigma2", [5.0, 0.1])
def test_estep_xla_matches_reference(sigma2, block):
    src, tgt = _two_blobs()
    ref = jeo.estep_xla(src, tgt, jnp.float32(sigma2), 0.05, block=block)
    out = peo.estep_xla(_t(src), _t(tgt), sigma2, 0.05, block=block)
    _assert_moments(ref, out)


@pytest.mark.parametrize("small,culled,sorted_,branch", [
    (1 << 20, 1 << 24, False, "small"),
    (0, 1 << 10, True, "stash"),
    (0, 1 << 10, False, "xla"),     # unsorted callers cull only from 2^28
    (0, 1 << 24, True, "xla"),
])
def test_dispatcher_picks_branch_by_size(monkeypatch, small, culled,
                                         sorted_, branch):
    """The branch depends on sizes and flags only; on the CPU each branch
    runs its plain version, and every branch matches the reference."""
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", small)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", culled)
    monkeypatch.setattr(pcfg.config, "tile_m", TILE)
    monkeypatch.setattr(pcfg.config, "tile_n", TILE)
    taken = []
    for name, fn in [("small", "estep_small_plain"),
                     ("stash", "stash_estep_plain")]:
        orig = getattr(pec, fn)
        monkeypatch.setattr(pec, fn, lambda *a, _o=orig, _n=name:
                            taken.append(_n) or _o(*a))
    src, tgt = _sorted(*_two_blobs())
    out = peo.estep(_t(src), _t(tgt), 0.1, 0.05, assume_sorted=sorted_)
    assert taken == ([] if branch == "xla" else [branch])
    _assert_moments(jeo.estep_xla(src, tgt, jnp.float32(0.1), 0.05), out)


def test_tile_bounds_and_mask_match_reference():
    src, tgt = _sorted(*_two_blobs(600, 520, seed=5))
    ys_t, y2 = jep._pad_transpose(jnp.asarray(src), 96)
    xs_t, x2 = jep._pad_transpose(jnp.asarray(tgt), TILE)
    ymin, ymax = jep._tile_bounds(ys_t, y2, 96)
    xmin, xmax = jep._tile_bounds(xs_t, x2, TILE)
    pymin, pymax = pec._tile_bounds(_t(src), 96)
    pxmin, pxmax = pec._tile_bounds(_t(tgt), TILE)
    np.testing.assert_array_equal(pymin.numpy(), np.asarray(ymin)[:3].T)
    np.testing.assert_array_equal(pymax.numpy(), np.asarray(ymax)[:3].T)
    np.testing.assert_array_equal(pxmin.numpy(), np.asarray(xmin)[:3].T)
    np.testing.assert_array_equal(pxmax.numpy(), np.asarray(xmax)[:3].T)
    for sigma2 in (5.0, 0.1, 0.01):
        inv2s2 = 0.5 / sigma2
        ref = np.asarray(jep._active_mask(ymin, ymax, xmin, xmax,
                                          jnp.float32(inv2s2)))
        out = pec._active_mask(pymin, pymax, pxmin, pxmax,
                               torch.tensor(inv2s2))
        np.testing.assert_array_equal(out.numpy(), ref > 0)


def test_mask_never_culls_a_live_tile():
    """Any tile pair holding a pair whose exponent is above the f32
    underflow bound must stay active."""
    src, tgt = _sorted(*_two_blobs(512, 512, seed=3))
    sigma2 = 0.03
    inv2s2 = 0.5 / sigma2
    ymin, ymax = pec._tile_bounds(_t(src), TILE)
    xmin, xmax = pec._tile_bounds(_t(tgt), TILE)
    mask = pec._active_mask(ymin, ymax, xmin, xmax,
                            torch.tensor(inv2s2)).numpy()
    assert not mask.all()
    d2 = ((src[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
    for i in range(mask.shape[0]):
        for j in range(mask.shape[1]):
            blk = d2[i * TILE:(i + 1) * TILE, j * TILE:(j + 1) * TILE]
            if blk.min() * inv2s2 <= pec._CUT:
                assert mask[i, j], (i, j, blk.min())


def test_compact_lists_active_tiles_in_order():
    mask = torch.tensor([[0, 1, 0],
                         [1, 1, 0],
                         [0, 1, 0],
                         [1, 0, 0]], dtype=torch.bool)  # (n_i=4, n_j=3)
    idx, cnt = pec._compact(mask)
    assert idx.dtype == cnt.dtype == torch.int32
    assert cnt.tolist() == [2, 3, 0]
    assert idx[0, :2].tolist() == [1, 3]
    assert idx[1, :3].tolist() == [0, 1, 2]


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_lists_per_stripe_and_per_source_tile(seed):
    """The lists the one-launch passes walk: _compact(mask), each stripe's
    active source tiles (pass A), and _compact(mask.T), each source tile's
    active stripes (pass B), ascending and counted. A random mask with a
    source tile and a stripe that have no active partner."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random((9, 7)) < 0.4)  # (n_i, n_j)
    mask[3, :] = False
    mask[:, 5] = False
    for rows in (mask.T, mask):
        idx, cnt = pec._compact(rows.T)
        assert idx.dtype == cnt.dtype == torch.int32
        assert idx.is_contiguous() and idx.shape == rows.shape
        for r in range(rows.shape[0]):
            want = torch.nonzero(rows[r]).flatten().tolist()
            assert int(cnt[r]) == len(want)
            assert idx[r, :len(want)].tolist() == want
    assert int(pec._compact(mask)[1][5]) == 0
    assert int(pec._compact(mask.T)[1][3]) == 0


@pytest.mark.parametrize("dim", [2, 3])
def test_morton_order_matches_reference(dim):
    rng = np.random.default_rng(9)
    pts = rng.uniform(-1, 2, (777, dim)).astype(np.float32)
    pts[5:40] = pts[4]  # ties: the stable sorts must agree
    np.testing.assert_array_equal(psp.morton_code(_t(pts)).numpy(),
                                  np.asarray(jsp.morton_code(pts)))
    np.testing.assert_array_equal(psp.morton_order(_t(pts)).numpy(),
                                  np.asarray(jsp.morton_order(pts)))


def test_stash_cap_shrinks_tile_then_raises(monkeypatch):
    """The cap's own contract (the reference's _capped_stash_tile_n):
    halve tile_n to the 256 floor, then raise, or with
    on_overflow="fallback" return None. estep_auto takes the fallback and
    answers with the streaming plain E-step, as the reference does
    (estep_pallas.py:1466-1479); both packages branch at the same sizes."""
    assert pec._capped_tile_n(150_000, 512, 1024, 1 << 30) == 1024
    # 150,016 x 1024 x 4 B = 614 MB: a 400 MB cap halves tile_n to 512.
    assert pec._capped_tile_n(150_000, 512, 1024, 400 << 20) == 512
    with pytest.raises(ValueError, match="stash_max_bytes"):
        pec._capped_tile_n(150_000, 512, 1024, 64 << 20)
    assert pec._capped_tile_n(150_000, 512, 1024, 64 << 20,
                              on_overflow="fallback") is None
    for args in [(150_000, 512, 1024, 1 << 30), (150_000, 512, 1024,
                                                 400 << 20)]:
        assert pec._capped_tile_n(*args) == jep._capped_stash_tile_n(
            *args[:3], budget=args[3])
    assert jep._capped_stash_tile_n(150_000, 512, 1024, budget=64 << 20,
                                    on_overflow="fallback") is None
    monkeypatch.setattr(pcfg.config, "stash_max_bytes", 1 << 10)
    src, tgt = _two_blobs()
    taken = []
    for fn in ("stash_estep_plain", "stash_merged_estep_plain"):
        monkeypatch.setattr(pec, fn, lambda *a: taken.append(a))
    out = pec.estep_auto(_t(src), _t(tgt), 0.1, 0.05)
    assert not taken
    _assert_moments(jeo.estep_xla(src, tgt, jnp.float32(0.1), 0.05), out)


@pytest.mark.parametrize("merged", [False, True])
def test_estep_auto_falls_back_past_the_floor_in_both_packages(merged):
    """A tiny cap in both packages (config.stash_max_bytes here,
    cpd_stash_max_bytes in the reference): both estep_auto return the
    moments of their own streaming E-step, with and without the merged
    knob."""
    from probreg_tpu import config as jcmod

    src, tgt = _two_blobs()
    cap = 1 << 10
    old = (pcfg.config.stash_max_bytes, pcfg.config.use_merged_stash,
           jcmod.config.cpd_stash_max_bytes, jcmod.config.use_merged_stash)
    pcfg.config.stash_max_bytes, pcfg.config.use_merged_stash = cap, merged
    jcmod.config.cpd_stash_max_bytes = cap
    jcmod.config.use_merged_stash = merged
    jcmod.clear_caches()
    try:
        out = pec.estep_auto(_t(src), _t(tgt), 0.1, 0.05)
        ref = jep.estep_auto(src, tgt, jnp.float32(0.1), 0.05,
                             interpret=True)
    finally:
        (pcfg.config.stash_max_bytes, pcfg.config.use_merged_stash,
         jcmod.config.cpd_stash_max_bytes,
         jcmod.config.use_merged_stash) = old
        jcmod.clear_caches()
    _assert_moments(peo.estep_xla(_t(src), _t(tgt), 0.1, 0.05), out)
    scan = jeo.estep_xla(src, tgt, jnp.float32(0.1), 0.05)
    for name, a, b in zip(ref._fields, ref, scan):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    _assert_moments(ref, out)


def test_merged_knob_halves_the_stash_budget(monkeypatch):
    """With use_merged_stash each of the two stash buffers gets half the
    cap (reference estep_pallas.py:1468-1470): a cap that holds one
    1024-column stash halves tile_n under the knob. Off the merged route
    the start-temperature gate also asks for the tiles under two thirds of
    the cap (estep_pallas.py:1488-1493): 384 < 768, so the fast branch is
    off there, and the E-step keeps the full cap's 768."""
    seen = []
    orig = pec._capped_tile_n
    monkeypatch.setattr(pec, "_capped_tile_n", lambda *a, **k: seen.append(
        orig(*a, **k)) or seen[-1])
    src, tgt = _two_blobs(640, 700)
    mp = 640  # tile_m 128 divides M
    monkeypatch.setattr(pcfg.config, "stash_max_bytes", mp * 768 * 4)
    for merged in (False, True):
        monkeypatch.setattr(pcfg.config, "use_merged_stash", merged)
        pec.estep_auto(_t(src), _t(tgt), 0.1, tile_m=TILE, tile_n=768)
    assert seen == [768, 384, 384]


# --------------------------------------------------------------------------
# K12: the pipelined stash E-step (use_merged_stash)
# --------------------------------------------------------------------------

def _rel(a, b):
    """Max abs error relative to the largest entry of the reference (the
    reference's own criterion, tests/test_culled_estep.py _rel)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _merged_inputs(sigma2, m=600, n=900, tm=128, tn=256, seed=7,
                   blobs=False):
    """The reference test's inputs (test_merged_stash_matches_two_launch):
    uniform clouds in [-1, 1]^3 (or the two blobs), Morton-sorted, scal =
    [0.5 / sigma2, 1e-4], as numpy for the reference and tensors for the
    port."""
    if blobs:
        src, tgt = _two_blobs(m, n, seed)
    else:
        rng = np.random.default_rng(seed)
        src = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        tgt = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    src, tgt = _sorted(src, tgt)
    scal = np.array([0.5 / sigma2, 1e-4], np.float32)
    ys, xs = _t(src), _t(tgt)
    mask = pec._active_mask(*pec._tile_bounds(ys, tm),
                            *pec._tile_bounds(xs, tn), torch.tensor(scal[0]))
    return src, tgt, scal, ys, xs, torch.from_numpy(scal), mask


@pytest.mark.parametrize("sigma2,blobs", [(0.5, False), (1e-3, False),
                                          (0.1, True)])
def test_stash_merged_plain_matches_reference_kernel(sigma2, blobs):
    """K12's plain version against the reference's fused_stash_merged_core
    (interpret mode), 600 x 900 with 128 x 256 tiles: the reference test's
    uniform clouds at sigma2 0.5 and 1e-3 (no tile pair of these clouds is
    far enough apart to be culled), and the two blobs at 0.1, where tiles
    are culled. pt1 and xx within 1e-6 of the largest entry, p1 and px
    within 1e-5 (the two packages form d2 in different f32 operation
    orders)."""
    tm, tn = 128, 256
    src, tgt, scal_np, ys, xs, scal, mask = _merged_inputs(
        sigma2, tm=tm, tn=tn, blobs=blobs)
    assert bool(mask.all()) != blobs
    ys_t, y2 = jep._pad_transpose(jnp.asarray(src), tm)
    xs_t, x2 = jep._pad_transpose(jnp.asarray(tgt), tn)
    ref = jep.fused_stash_merged_core(jnp.asarray(scal_np), ys_t, y2, xs_t,
                                      x2, tile_m=tm, tile_n=tn,
                                      interpret=True)
    pt1, p1, px, xx = pec.stash_merged_estep_plain(ys, xs, scal, mask, tm, tn)
    m, n = src.shape[0], tgt.shape[0]
    assert _rel(pt1.numpy(), np.asarray(ref[0])[0, :n]) <= 1e-6
    assert _rel(xx.numpy(), np.asarray(ref[3])[0, 0]) <= 1e-6
    assert _rel(p1.numpy(), np.asarray(ref[1])[0, :m]) <= 1e-5
    assert _rel(px.numpy(), np.asarray(ref[2])[:3, :m].T) <= 1e-5


@pytest.mark.parametrize("sigma2,blobs", [(0.5, False), (1e-3, False),
                                          (0.1, True)])
def test_stash_merged_plain_matches_stash_plain(sigma2, blobs):
    """Against K3's plain version on the same inputs: pass A is the same
    code, so pt1 and xx are equal; p1 and px differ only by the folded
    normalizer's rounding (within 1e-5 of the largest entry)."""
    _, _, _, ys, xs, scal, mask = _merged_inputs(sigma2, blobs=blobs)
    a = pec.stash_estep_plain(ys, xs, scal, mask, 128, 256)
    b = pec.stash_merged_estep_plain(ys, xs, scal, mask, 128, 256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
    assert _rel(b[1].numpy(), a[1].numpy()) <= 1e-5
    assert _rel(b[2].numpy(), a[2].numpy()) <= 1e-5


def test_estep_auto_merged_matches_reference_merged(monkeypatch):
    """estep_auto with use_merged_stash in both packages (the reference's
    test_estep_auto_merged_matches_default inputs): the port routes through
    the merged plain version and returns the reference's moments."""
    from probreg_tpu import config as jcmod

    rng = np.random.default_rng(5)
    src = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    taken = []
    for fn in ("stash_estep_plain", "stash_merged_estep_plain"):
        orig = getattr(pec, fn)
        monkeypatch.setattr(pec, fn, lambda *a, _o=orig, _n=fn:
                            taken.append(_n) or _o(*a))
    monkeypatch.setattr(pcfg.config, "use_merged_stash", True)
    old = jcmod.config.use_merged_stash
    jcmod.config.use_merged_stash = True
    jcmod.clear_caches()
    try:
        ref = jep.estep_auto(src, tgt, jnp.float32(0.3), 0.1, tile_m=128,
                             tile_n=256, interpret=True)
    finally:
        jcmod.config.use_merged_stash = old
        jcmod.clear_caches()
    out = pec.estep_auto(_t(src), _t(tgt), 0.3, 0.1, tile_m=128,
                         tile_n=256)
    assert taken == ["stash_merged_estep_plain"]
    _assert_moments(ref, out)
    monkeypatch.setattr(pcfg.config, "use_merged_stash", False)
    base = pec.estep_auto(_t(src), _t(tgt), 0.3, 0.1, tile_m=128,
                          tile_n=256)
    assert taken[-1] == "stash_estep_plain"
    _assert_moments(base, out)


@pytest.mark.parametrize("m,n", [(1, 1), (1, 1 << 20), (1 << 20, 1),
                                 (1000, 1000), (32768, 32), (32, 32768),
                                 (390, 390), (37, 1000), (1000, 33),
                                 (700, 1500)])
def test_small_plan_tiles_cover_the_shape_at_16_pairs_a_thread(m, n):
    """K2's tiles: powers of two from 16 to 256 holding 4,096 pairs (16 a
    thread of 256 in each phase), covering M x N, and the scratch that one
    launch needs for them."""
    plan = pec.small_plan(m, n)
    for side in (plan.rows, plan.cols):
        assert 16 <= side <= 256 and side & (side - 1) == 0
    assert plan.rows * plan.cols == 16 * 256
    assert (plan.nr - 1) * plan.rows < m <= plan.nr * plan.rows
    assert (plan.nc - 1) * plan.cols < n <= plan.nc * plan.cols
    nr, nc = plan.nr, plan.nc
    assert plan.scratch(m, n) == (4 * nc * m + nr * n + nc + nr,
                                  1 + nc + nr)


def test_small_plan_spreads_every_shape_of_the_gate_over_the_card():
    """1000^2 and both corners of the gate (M N = 2^20) get 256 tiles, where
    one block per 32 targets gave 32, 1 and 1,024 blocks; the tiles lean
    the way the problem does, so that a column's finalisation and a row's
    read about as many partials a thread."""
    assert pec.small_plan(1000, 1000) == (64, 64, 16, 16)
    assert pec.small_plan(32768, 32) == (256, 16, 128, 2)
    assert pec.small_plan(32, 32768) == (16, 256, 2, 128)
    assert pec.small_plan(390, 390).tiles == 49
    assert pec.small_plan(1000, 33).rows == 256
    assert pec.small_plan(37, 1000).cols == 256


def test_small_scratch_grows_only_when_a_launch_needs_more(monkeypatch):
    monkeypatch.setattr(pec, "_small_scratch", {})
    cpu = torch.device("cpu")
    work, tickets = pec.small_scratch(cpu, 7, 100, 10)
    assert work.numel() == 100 and tickets.numel() == 10
    assert bool((tickets == 0).all()) and tickets.dtype == torch.int32
    again = pec.small_scratch(cpu, 7, 60, 4)
    assert again[0] is work and again[1] is tickets
    grown = pec.small_scratch(cpu, 7, 300, 4)
    assert grown[0].numel() == 300 and grown[1] is tickets
    grown = pec.small_scratch(cpu, 7, 300, 40)
    assert grown[1].numel() == 40 and bool((grown[1] == 0).all())
    other = pec.small_scratch(cpu, 8, 10, 2)  # another stream
    assert other[0] is not grown[0]


class _FakeLib:
    """Records K2's C arguments in place of the library."""

    def __init__(self):
        self.calls = []

    def probreg_estep_small(self, *args):
        self.calls.append(args)
        return 0

    def probreg_empty_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_small_launcher_arguments(monkeypatch, dim):
    """What the wrapper hands K2: the clouds as they are with their D (the
    kernel's template), the plan's tiles, the grid (the tiles, at most the
    card's capacity, unless forced), sigma2 by pointer when it is a tensor
    on the clouds' device and by value otherwise, w and 1 - w, and one
    count per launch."""
    lib = _FakeLib()
    monkeypatch.setattr(pec, "_lib", lambda: lib)
    monkeypatch.setattr(pec, "_stream", lambda t: 0)
    monkeypatch.setattr(pec, "small_capacity", lambda d, dev: 200)
    monkeypatch.setattr(pec, "_small_scratch", {})
    ys, xs = torch.zeros((1000, dim)), torch.zeros((1000, dim))
    sigma2 = torch.tensor(0.25, dtype=torch.float64)
    before = pec.LAUNCHES["estep_small"]
    for kw in ({}, dict(_blocks=3)):
        launch, mom = pec.small_launcher(ys, xs, sigma2, 0.2, **kw)
        launch()
        assert mom.px.shape == (1000, dim) and mom.n_p.shape == ()
    assert pec.LAUNCHES["estep_small"] == before + 2
    assert [c[11] for c in lib.calls] == [200, 3]
    assert all(len(c) == 19 for c in lib.calls)
    c = lib.calls[0]
    assert c[1] == 1000 and c[3] == 1000 and c[4] == dim
    assert c[0] == ys.data_ptr() and c[2] == xs.data_ptr()
    assert c[5] is not None and c[6] == 0.0
    assert (c[7], c[8], c[9], c[10]) == (0.2, 1.0 - 0.2, 64, 64)
    launch, _ = pec.small_launcher(ys, xs, 0.25, 0.0)
    launch()
    assert lib.calls[-1][5] is None and lib.calls[-1][6] == 0.25
    # The launch keeps alive every tensor whose address it passes.
    alive = {t.data_ptr() for t in launch.tensors if t is not None}
    assert {lib.calls[-1][i] for i in (0, 2, 12, 13, 14)} <= alive


@pytest.mark.parametrize("cooperative", [False, True])
def test_empty_launcher_builds_its_arguments_once(monkeypatch, cooperative):
    """K2's floor: each launch() hands the library the arguments built when
    the launcher was made, as small_launcher's launch() does, and counts
    no K2 launch."""
    lib = _FakeLib()
    monkeypatch.setattr(pec, "_lib", lambda: lib)
    streams = []

    class _Stream:
        cuda_stream = 7

    def current_stream(device):
        streams.append(device)
        return _Stream()

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    before = pec.LAUNCHES["estep_small"]
    launch = pec.empty_launcher("cuda:0", cooperative)
    for _ in range(3):
        launch()
    assert lib.calls == [(int(cooperative), 7)] * 3
    assert streams == ["cuda:0"]
    assert pec.LAUNCHES["estep_small"] == before


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    pts = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="D <= 3"):
        pec.estep_small(pts, pts, 1.0)
    with pytest.raises(ValueError, match="float32"):
        pec.estep_auto(pts[:, :3].double(), pts[:, :3].double(), 1.0)
    # D > 3 is still served, by the plain streaming E-step.
    rng = np.random.default_rng(0)
    a = rng.normal(size=(50, 4)).astype(np.float32)
    out = peo.estep(_t(a), _t(a[::-1]), 1.0)
    _assert_moments(jeo.estep_xla(a, a[::-1], jnp.float32(1.0)), out)


# --------------------------------------------------------------------------
# The two-pass E-step (estep_fused / estep_culled) and the use_pallas knob
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sigma2,culled", [(5.0, False), (0.1, True)])
def test_two_pass_estep_matches_reference(sigma2, culled):
    """Dense and culled regimes: against the reference's two-pass kernels
    on the same sorted clouds and tiles, and its plain streaming E-step."""
    src, tgt = _two_blobs()
    s_s, t_s = _sorted(src, tgt)
    w = 0.05
    taken = []
    orig = pec.fused_estep_plain
    pec.fused_estep_plain = lambda ys, xs, scal, mask, *a: (
        taken.append(float(mask.float().mean())) or orig(ys, xs, scal, mask,
                                                         *a))
    try:
        out = pec.estep_fused(_t(s_s), _t(t_s), sigma2, w, tile_m=TILE,
                              tile_n=TILE)
        out_c = pec.estep_culled(_t(src), _t(tgt), sigma2, w, tile_m=TILE,
                                 tile_n=TILE)
        out_d = pec.estep_fused(_t(s_s), _t(t_s), sigma2, w, tile_m=TILE,
                                tile_n=TILE, cull=False)
    finally:
        pec.fused_estep_plain = orig
    assert (taken[0] < 1.0) == culled and taken[1] == taken[0], taken
    assert taken[2] == 1.0
    ref = jep.estep_fused(s_s, t_s, jnp.float32(sigma2), w, tile_m=TILE,
                          tile_n=TILE, interpret=True)
    _assert_moments(ref, out)
    _assert_moments(ref, out_d)
    _assert_moments(jeo.estep_xla(s_s, t_s, jnp.float32(sigma2), w), out)
    # estep_culled sorts inside and returns the moments in the input order.
    _assert_moments(jeo.estep_xla(src, tgt, jnp.float32(sigma2), w), out_c)


def test_two_pass_ragged_tiles_and_dead_stripes_and_rows():
    """Tile sizes that divide neither cloud; target stripes and source
    tiles with no active partner get exact zeros."""
    src, tgt = _two_blobs(600, 520, seed=3)
    tgt[:200, 2] += 40.0   # far away from every source tile
    src[:150, 0] += 90.0   # far away from every target stripe
    s_s, t_s = _sorted(src, tgt)
    out = pec.estep_fused(_t(s_s), _t(t_s), 0.1, 0.0, tile_m=96, tile_n=128)
    ref = jeo.estep_xla(s_s, t_s, jnp.float32(0.1), 0.0)
    _assert_moments(ref, out)
    assert np.all(out.pt1.numpy()[t_s[:, 2] > 20.0] == 0.0)
    lonely = s_s[:, 0] > 50.0
    assert np.all(out.p1.numpy()[lonely] == 0.0)
    assert np.all(out.px.numpy()[lonely] == 0.0)
    # The two-pass and the stash versions are the same function.
    stash = pec.estep_auto(_t(s_s), _t(t_s), 0.1, 0.0, tile_m=96,
                           tile_n=128, assume_sorted=True)
    _assert_moments(stash, out)


@pytest.mark.parametrize("use_pallas,cfg_flag,min_pairs,branch", [
    (True, False, 1 << 22, "two_pass"),    # asked for by the caller
    (False, True, 0, "xla"),               # pinned off, whatever the config
    (None, True, 1 << 10, "two_pass"),     # config.use_pallas from min_pairs
    (None, True, 1 << 22, "xla"),          # below pallas_min_pairs
    (None, False, 0, "xla"),               # the default: opt-in only
])
def test_dispatcher_use_pallas(monkeypatch, use_pallas, cfg_flag, min_pairs,
                               branch):
    """The reference's order (estep.py:184-213): small, sorted culled, then
    the two-pass kernels only by request."""
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", 0)
    monkeypatch.setattr(pcfg.config, "use_pallas", cfg_flag)
    monkeypatch.setattr(pcfg.config, "pallas_min_pairs", min_pairs)
    monkeypatch.setattr(pcfg.config, "tile_m", TILE)
    monkeypatch.setattr(pcfg.config, "tile_n", TILE)
    taken = []
    for name, fn in [("small", "estep_small_plain"),
                     ("stash", "stash_estep_plain"),
                     ("two_pass", "fused_estep_plain")]:
        orig = getattr(pec, fn)
        monkeypatch.setattr(pec, fn, lambda *a, _o=orig, _n=name:
                            taken.append(_n) or _o(*a))
    src, tgt = _sorted(*_two_blobs())
    out = peo.estep(_t(src), _t(tgt), 0.1, 0.05, use_pallas=use_pallas)
    assert taken == ([] if branch == "xla" else [branch])
    _assert_moments(jeo.estep_xla(src, tgt, jnp.float32(0.1), 0.05), out)


def test_dispatcher_use_pallas_keeps_small_and_culled_first(monkeypatch):
    """With use_pallas None the small and the sorted culled branches win
    over config.use_pallas, as in the reference; D > 3 never reaches a
    kernel."""
    monkeypatch.setattr(pcfg.config, "use_pallas", True)
    monkeypatch.setattr(pcfg.config, "pallas_min_pairs", 0)
    monkeypatch.setattr(pcfg.config, "tile_m", TILE)
    monkeypatch.setattr(pcfg.config, "tile_n", TILE)
    taken = []
    for name, fn in [("small", "estep_small_plain"),
                     ("stash", "stash_estep_plain"),
                     ("two_pass", "fused_estep_plain")]:
        orig = getattr(pec, fn)
        monkeypatch.setattr(pec, fn, lambda *a, _o=orig, _n=name:
                            taken.append(_n) or _o(*a))
    src, tgt = _sorted(*_two_blobs())
    peo.estep(_t(src), _t(tgt), 0.1)
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", 0)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1 << 10)
    peo.estep(_t(src), _t(tgt), 0.1, assume_sorted=True)
    peo.estep(_t(src), _t(tgt), 0.1)
    assert taken == ["small", "stash", "two_pass"]
    rng = np.random.default_rng(0)
    a = rng.normal(size=(50, 4)).astype(np.float32)
    out = peo.estep(_t(a), _t(a[::-1]), 1.0, use_pallas=True)
    assert taken == ["small", "stash", "two_pass"]
    _assert_moments(jeo.estep_xla(a, a[::-1], jnp.float32(1.0)), out)

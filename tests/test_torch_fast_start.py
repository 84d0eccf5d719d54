"""The start-temperature fast branch of the large E-steps, ``matmul_dtype``
and ``stash_dtype``, held to the JAX package.

The same numpy clouds (made from a seed) go through the JAX package's
functions (its Pallas kernels in interpret mode) and the port's, which run
their kernels' plain versions here because the tensors lie on the CPU.

* The gate: the port's branch (read from its device tally, ``FAST_STEPS``)
  against the reference's own expression (estep_pallas.py:1462-1541 for the
  CPD E-step, :1324-1340 for the Gauss transform) on the same inputs,
  across sigma2 and h on both sides of the threshold, and the reference's
  conditions that switch the gate off (the merged route, a bf16 stash, a
  budget whose two-thirds tiles are smaller).
* The plain fast branch against the reference's fast branch. On the CPU
  the reference's DEFAULT-precision product gives the bits of its HIGHEST
  one, so its fast branch differs from its exact one only by its bf16
  stash; the port's plain fast branch also rounds the cross term's
  operands to bf16. Tolerance, derived: the bound a (<= tol) caps the move
  of every exp argument, so each Gaussian moves by a factor within
  e^(+-a); a normalizer den (a sum of Gaussians) moves within the same
  factor, so p = g / den within e^(+-2a); the two stashes round p's g to
  bf16 apart (2^-9 each: (1 + 2^-9)^2 < 1 + 2^-8). So every CPD moment,
  a sum of terms of one sign per entry (p, p |x|, pt1 |x|^2), moves by at
  most (e^(2a) (1 + 2^-8) - 1) of the sum of its terms' magnitudes; the
  Gauss transform (no normalizer, no stash) by (e^a (1 + 2^-8) - 1) of
  sum_j g |w|, the 2^-8 there covering the f32 sums. The cases keep a <=
  tol / 2, where both lie under the issue's e^tol (1 + 2^-8) - 1. An
  absolute 1e-6 of the largest entry covers f32 summation order.
* The fast pass B's tensor-core form: ``moment_pieces`` rebuilds inv_den
  (x, y, z, 1) within 2^-24 of each value, ``moment_operand`` is its
  mma.sync.m16n8k16 fragment order, and the pass's association (bf16(g)
  times each piece in f32, a stripe's hi + (mid + lo), stripes in order)
  written in plain torch stays within the tolerance above of the
  reference's fast branch.
* K6's fast kernel on the tensor cores: ``weight_pieces`` rebuilds every
  weight within 2^-24 of it (2^-134, half of bf16's subnormal step, below
  ~2^-110), and the kernel's association (g in two bf16 pieces, hi and
  lo, the weights in three; per stage, as the kernel stages the points,
  (g_hi + g_lo) w_hi, (g_hi + g_lo) w_mid and g_hi w_lo with exact
  products, each stage's hi + (mid + lo) in f32, stages in order) written
  in plain torch on the port's plain fast g stays within 2^-16 of
  sum_j g |w| of the f64 product, and within the tolerance above of the
  reference's fast branch.
* The bound: on random clouds, the exp argument of the plain fast branch
  moves from the exact branch's by at most ``fast_bound``.
* ``stash_dtype`` and ``matmul_dtype`` = bf16 against the reference set the
  same way: both round the same f32 values to bf16, which the two
  packages may hold one f32 ulp apart, so a term may round to the other
  neighbour: 2^-8 of the sum of the terms' magnitudes, plus the absolute
  1e-6. The bf16-stash pass B's tensor-core form (bf16 of pass A's exact
  g times each piece of ``moment_pieces``, a stripe's hi + (mid + lo),
  stripes in order; K3's and K12's routes alike) written in plain torch
  stays within the same 2^-8 of either of the reference's cores.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import config as jcfg  # noqa: E402
from probreg_tpu.ops import estep as jeo  # noqa: E402
from probreg_tpu.ops import estep_pallas as jep  # noqa: E402
from probreg_tpu.ops import pairwise as jpw  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch.ops import estep as peo  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops import gausstransform as pgt  # noqa: E402
from probreg_tpu_torch.ops import gt_cuda as pgc  # noqa: E402
from probreg_tpu_torch.ops import pairwise as ppw  # noqa: E402
from probreg_tpu_torch.ops.spatial import morton_order  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 0.02          # both packages' estep_fast_start_tol
TILE_M, TILE_N = 128, 256
ATOL = 1e-6         # of the largest entry: f32 summation order


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _surface(n, seed, jitter=0.002):
    """A wavy sheet in 3-D: a smooth surface like the port's
    blobby_surface, small enough for the plain versions."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1, 1, (n, 2))
    z = 0.3 * np.sin(2.5 * uv[:, 0]) * np.cos(2.0 * uv[:, 1])
    pts = np.column_stack([uv, z]) + rng.normal(0, jitter, (n, 3))
    return pts.astype(np.float32)


def _pair(m=700, n=650, seed=3):
    src = _surface(m, seed)
    c, s = math.cos(0.2), math.sin(0.2)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = (_surface(n, seed + 1) @ rot.T).astype(np.float32)
    return src, tgt


def _ref_bound_k3(src, tgt, sigma2):
    """The reference's estep_auto bound, by its own helpers: scal[0] * 8 *
    2^-9 * sqrt(max y2 * max x2) over the padded transposes."""
    _, y2 = jep._pad_transpose(jnp.asarray(src), TILE_M)
    _, x2 = jep._pad_transpose(jnp.asarray(tgt), TILE_N)
    inv = (0.5 / jnp.asarray(sigma2, jnp.float32)).astype(jnp.float32)
    y2max = jnp.max(jnp.where(y2 < jep._BIG * 0.5, y2, 0.0))
    x2max = jnp.max(jnp.where(x2 < jep._BIG * 0.5, x2, 0.0))
    return inv * 8.0 * (2.0 ** -9) * jnp.sqrt(y2max * x2max)


def _ref_takes_fast_k3(src, tgt, sigma2, merged=False, stash=jnp.float32,
                       budget=6 << 30):
    """The reference estep_auto's branch: its static conditions, its
    tile budgets (estep_pallas.py:1462-1493) and its bound."""
    m, n = src.shape[0], tgt.shape[0]
    if merged or jnp.dtype(stash) != jnp.dtype(jnp.float32):
        return False
    eff = budget // 2 if merged else budget
    tn0 = min(TILE_N, ((n + 127) // 128) * 128)
    tn = jep._capped_stash_tile_n(m, TILE_M, tn0, budget=eff,
                                  on_overflow="fallback")
    gated = jep._capped_stash_tile_n(m, TILE_M, tn0, budget=eff * 2 // 3,
                                     on_overflow="fallback")
    if tn is None or gated is None or gated < tn:
        return False
    return bool(_ref_bound_k3(src, tgt, sigma2) <= TOL)


def _port_takes_fast_k3(src, tgt, sigma2):
    pec.reset_launches()
    pec.estep_auto(_t(src), _t(tgt), sigma2, 0.05, tile_m=TILE_M,
                   tile_n=TILE_N)
    return pec.fast_steps() == 1


def _threshold_k3(src, tgt):
    """sigma2 at which the reference's bound equals TOL (the bound is
    0.5 / sigma2 times its value at 1 / (2 sigma2) = 1)."""
    return 0.5 * float(_ref_bound_k3(src, tgt, 0.5)) / TOL


# --------------------------------------------------------------------------
# The gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.5, 0.9, 0.99, 1.01, 1.1, 2.0])
def test_k3_gate_takes_the_references_branch(factor):
    src, tgt = _pair()
    sigma2 = _threshold_k3(src, tgt) * factor
    want = _ref_takes_fast_k3(src, tgt, sigma2)
    assert want == (factor > 1.0)
    assert _port_takes_fast_k3(src, tgt, sigma2) == want


@pytest.mark.parametrize("knob", ["merged", "bf16_stash", "budget",
                                  "fast_start_off"])
def test_k3_gate_is_off_where_the_reference_switches_it_off(monkeypatch,
                                                            knob):
    """Each condition alone turns the fast branch off at a sigma2 where
    the bound fires: the merged route, a bf16 stash, a budget that holds
    the full tiles but not within two thirds of it (the reference's two
    resident stashes), and config.estep_fast_start."""
    src, tgt = _pair()
    sigma2 = _threshold_k3(src, tgt) * 2.0
    assert _ref_takes_fast_k3(src, tgt, sigma2)
    if knob == "merged":
        monkeypatch.setattr(pcfg.config, "use_merged_stash", True)
        assert not _ref_takes_fast_k3(src, tgt, sigma2, merged=True)
    elif knob == "bf16_stash":
        monkeypatch.setattr(pcfg.config, "stash_dtype", torch.bfloat16)
        assert not _ref_takes_fast_k3(src, tgt, sigma2, stash=jnp.bfloat16)
    elif knob == "budget":
        mp = -(-src.shape[0] // TILE_M) * TILE_M
        budget = mp * TILE_N * 4          # the full tiles fit exactly
        monkeypatch.setattr(pcfg.config, "stash_max_bytes", budget)
        assert not _ref_takes_fast_k3(src, tgt, sigma2, budget=budget)
    else:
        monkeypatch.setattr(pcfg.config, "estep_fast_start", False)
    assert not _port_takes_fast_k3(src, tgt, sigma2)


def test_k3_gate_through_the_dispatcher(monkeypatch):
    """ops/estep.estep reaches the gate on its culled branch, as the
    reference's estep reaches estep_auto."""
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1000)
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", 0)
    monkeypatch.setattr(pcfg.config, "tile_m", TILE_M)
    monkeypatch.setattr(pcfg.config, "tile_n", TILE_N)
    src, tgt = _pair()
    thr = _threshold_k3(src, tgt)
    for factor, want in ((2.0, 1), (0.5, 0)):
        pec.reset_launches()
        peo.estep(_t(src), _t(tgt), thr * factor, 0.05, assume_sorted=True)
        assert pec.fast_steps() == want


def _centred(src, tgt):
    both = np.concatenate([src, tgt]).astype(np.float32)
    cen = both.sum(0, dtype=np.float32) / np.float32(len(both))
    return src - cen, tgt - cen


def _ref_bound_k6(src, tgt, h):
    """gauss_transform_culled's bound (estep_pallas.py:1333-1336) on the
    centred clouds."""
    s_c, t_c = _centred(src, tgt)
    _, q2 = jep._pad_transpose(jnp.asarray(t_c), 256)
    _, p2 = jep._pad_transpose(jnp.asarray(s_c), 128)
    inv = 1.0 / (jnp.asarray(h, jnp.float32) ** 2)
    q2max = jnp.max(jnp.where(q2 < jep._BIG * 0.5, q2, 0.0))
    p2max = jnp.max(jnp.where(p2 < jep._BIG * 0.5, p2, 0.0))
    return inv * 8.0 * (2.0 ** -9) * jnp.sqrt(q2max * p2max)


def _weights(m, seed=5, c=4):
    return np.random.default_rng(seed).uniform(0.1, 1.0, (m, c)).astype(
        np.float32)


@pytest.mark.parametrize("factor", [0.5, 0.9, 0.99, 1.01, 1.1, 2.0])
def test_k6_gate_takes_the_references_branch(factor):
    src, tgt = _pair(500, 450)
    # h at which the bound equals TOL (it scales as 1 / h^2).
    h = math.sqrt(float(_ref_bound_k6(src, tgt, 1.0)) / TOL * factor)
    want = bool(_ref_bound_k6(src, tgt, h) <= TOL)
    assert want == (factor > 1.0)
    w = _weights(500)
    for fast_start, took in ((None, want), (False, False)):
        pgc.reset_launches()
        pgc.gauss_transform_culled(_t(src), _t(tgt), _t(w), h, tile=128,
                                   fast_start=fast_start)
        assert pgc.fast_steps() == int(took)


def test_k6_gate_through_gauss_transform(monkeypatch):
    """ops/gausstransform.gauss_transform reaches the gate on its culled
    branch; ``fast_start=False`` (the sharded FilterReg's shards) and
    ``config.estep_fast_start = False`` keep the exact branch."""
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1000)
    src, tgt = _pair(500, 450)
    h = math.sqrt(float(_ref_bound_k6(src, tgt, 1.0)) / TOL * 2.0)
    w = _weights(500)
    for kw, want in (({}, 1), ({"fast_start": False}, 0)):
        pgc.reset_launches()
        pgt.gauss_transform(_t(src), _t(tgt), _t(w), h, assume_sorted=True,
                            **kw)
        assert pgc.fast_steps() == want
    monkeypatch.setattr(pcfg.config, "estep_fast_start", False)
    pgc.reset_launches()
    pgt.gauss_transform(_t(src), _t(tgt), _t(w), h, assume_sorted=True)
    assert pgc.fast_steps() == 0


# --------------------------------------------------------------------------
# Against the reference's fast branch
# --------------------------------------------------------------------------

def _dense_terms(src, tgt, sigma2, w):
    """f64 magnitudes of each moment's terms: (sum_j p_ij, sum_j p_ij
    |x_j|, sum_i p_ij (= pt1's magnitude), sum_j pt1_j |x_j|^2)."""
    y, x = src.astype(np.float64), tgt.astype(np.float64)
    d2 = ((y[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    g = np.exp(-d2 / (2 * sigma2))
    dim, m, n = y.shape[1], y.shape[0], x.shape[0]
    c = (2 * np.pi * sigma2) ** (dim / 2) * w / (1 - w) * m / n
    p = g / (g.sum(0) + c)
    pt1 = p.sum(0)
    return p.sum(1), p @ np.abs(x), pt1, (pt1 * (x * x).sum(1)).sum()


def _within(name, got, want, mag, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert np.all(np.abs(got - want) <= rel * mag + ATOL * scale), (
        name, float((np.abs(got - want) - rel * mag).max()))


@pytest.mark.parametrize("factor", [2.5, 6.0])
@pytest.mark.parametrize("w", [0.0, 0.1])
def test_k3_plain_fast_branch_matches_the_references_fast_branch(factor, w):
    """At sigma2 = factor x the threshold (a = tol / factor <= tol / 2),
    the port's plain fast branch against the reference's estep_auto with
    fast_start=True, within (e^(2a) (1 + 2^-8) - 1) of each moment's terms'
    magnitude."""
    src, tgt = _pair()
    sigma2 = _threshold_k3(src, tgt) * factor
    a = float(_ref_bound_k3(src, tgt, sigma2))
    assert a <= TOL / 2
    ref = jep.estep_auto(src, tgt, jnp.float32(sigma2), w, tile_m=TILE_M,
                         tile_n=TILE_N, interpret=True, fast_start=True)
    pec.reset_launches()
    out = pec.estep_auto(_t(src), _t(tgt), sigma2, w, tile_m=TILE_M,
                         tile_n=TILE_N)
    assert pec.fast_steps() == 1
    rel = math.exp(2 * a) * (1 + 2.0 ** -8) - 1
    p1_mag, px_mag, pt1_mag, xx_mag = _dense_terms(src, tgt, sigma2, w)
    _within("pt1", out.pt1, ref.pt1, pt1_mag, rel)
    _within("p1", out.p1, ref.p1, p1_mag, rel)
    _within("px", out.px, ref.px, px_mag, rel)
    _within("xx", out.xx, ref.xx, xx_mag, rel)
    _within("n_p", out.n_p, ref.n_p, p1_mag.sum(), rel)
    # The exact branch of both packages stays within the repo's own 1e-5.
    ex = pec.estep_auto(_t(src), _t(tgt), sigma2, w, tile_m=TILE_M,
                        tile_n=TILE_N, fast_start=False)
    ref_ex = jep.estep_auto(src, tgt, jnp.float32(sigma2), w, tile_m=TILE_M,
                            tile_n=TILE_N, interpret=True, fast_start=False)
    for name, a_, b_ in zip(ref_ex._fields, ref_ex, ex):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a_), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("factor", [2.5, 6.0])
def test_k6_plain_fast_branch_matches_the_references_fast_branch(factor):
    """gauss_transform_culled with the gate on in both packages, at h with
    a = tol / factor: within (e^a (1 + 2^-8) - 1) of sum_j g |w|."""
    src, tgt = _pair(500, 450)
    h = math.sqrt(float(_ref_bound_k6(src, tgt, 1.0)) / TOL * factor)
    a = float(_ref_bound_k6(src, tgt, h))
    assert a <= TOL / 2 and jcfg.config.estep_fast_start
    w = _weights(500)
    ref = jep.gauss_transform_culled(src, tgt, w, h, tile=128,
                                     interpret=True)
    pgc.reset_launches()
    out = pgc.gauss_transform_culled(_t(src), _t(tgt), _t(w), h, tile=128)
    assert pgc.fast_steps() == 1
    d2 = ((tgt[:, None, :].astype(np.float64) - src[None]) ** 2).sum(-1)
    mag = np.exp(-d2 / h ** 2) @ np.abs(w.astype(np.float64))
    _within("gt", out, ref, mag, math.exp(a) * (1 + 2.0 ** -8) - 1)


# --------------------------------------------------------------------------
# The fast pass B on the tensor cores: its operand and its association
# --------------------------------------------------------------------------

def _moment_values(xs, inv_den):
    return torch.cat([xs[:, :3] * inv_den[:, None], inv_den[:, None]], 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_moment_pieces_rebuild_the_moment_values(seed):
    """hi + mid + lo of every value of v = inv_den (x, y, z, 1) is v within
    2^-24 of it (f32's half ulp), in f32 over the magnitudes a normalizer
    takes (1 / (den + c) from ~1e-30 to ~1e30), and a zero inv_den gives
    zero pieces."""
    rng = np.random.default_rng(seed)
    n = 777
    xs = _t(rng.normal(size=(n, 4)) * 10.0 ** rng.uniform(-3, 3, (n, 1)))
    inv_den = _t(10.0 ** rng.uniform(-30, 30, n))
    inv_den[::7] = 0.0
    pieces = pec.moment_pieces(xs, inv_den)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (n, 3, 4)
    v = _moment_values(xs, inv_den).double()
    p = pieces.double()
    rebuilt = p[:, 0] + p[:, 1] + p[:, 2]
    assert bool(((rebuilt - v).abs() <= 2.0 ** -24 * v.abs()).all())
    assert bool((pieces[::7] == 0).all())


@pytest.mark.parametrize("n,tile_n", [(50, 24), (700, 256), (2100, 1024)])
def test_moment_operand_is_the_mma_fragment_order(n, tile_n):
    """moment_operand against the fragment map of mma.sync.m16n8k16's B
    operand (PTX ISA: b0 holds rows 2 tig, 2 tig + 1 and b1 rows 2 tig + 8,
    2 tig + 9 of column gid), the first product's column 2c channel c's hi
    and 2c + 1 its mid, the second's 2c its lo and 2c + 1 zero, each stripe
    of tile_n targets zero-padded to a multiple of 16."""
    rng = np.random.default_rng(n)
    xs, inv_den = _t(rng.normal(size=(n, 4))), _t(rng.uniform(0, 5, n))
    pieces = pec.moment_pieces(xs, inv_den).float()
    op = pec.moment_operand(xs, inv_den, tile_n).float()
    gps = -(-tile_n // 16)
    assert op.shape == (-(-n // tile_n) * gps, 32, 8)
    lane = torch.arange(32)
    gid, tig = lane // 4, lane % 4
    for g in range(op.shape[0]):
        j, local = divmod(g, gps)
        for slot in range(8):     # [product][b0 / b1][e]
            prod, half, e = slot // 4, (slot // 2) % 2, slot % 2
            t_local = 16 * local + 8 * half + 2 * tig + e
            t = j * tile_n + t_local
            ok = (t_local < tile_n) & (t < n)
            piece = gid % 2 if prod == 0 else torch.full_like(gid, 2)
            live = ok & ((gid % 2 == 0) | (prod == 0))
            want = torch.where(
                live, pieces[t.clamp(max=n - 1), piece, gid // 2], 0.0)
            assert torch.equal(op[g, :, slot], want), (g, slot)


@pytest.mark.parametrize("factor", [2.5, 6.0])
@pytest.mark.parametrize("w", [0.0, 0.1])
def test_k3_fast_moments_from_pieces_match_the_references_fast_branch(
        factor, w):
    """The fast pass B's association in plain torch: per stripe, bf16(g)
    times each piece of moment_pieces in f32 (exact products), the stripe's
    hi + (mid + lo), stripes added in order; pass A's g, inv_den, pt1 and
    xx from the plain fast pass A. Against the reference's estep_auto with
    fast_start=True, within (e^(2a) (1 + 2^-8) - 1) of each moment's
    terms' magnitude (the derivation above)."""
    src, tgt = _pair()
    sigma2 = _threshold_k3(src, tgt) * factor
    a = float(_ref_bound_k3(src, tgt, sigma2))
    assert a <= TOL / 2
    ref = jep.estep_auto(src, tgt, jnp.float32(sigma2), w, tile_m=TILE_M,
                         tile_n=TILE_N, interpret=True, fast_start=True)
    y, x = _t(src), _t(tgt)
    perm_y, perm_x = morton_order(y), morton_order(x)
    ys, xs = y[perm_y], x[perm_x]
    m, n = ys.shape[0], xs.shape[0]
    scal = pec._scalars(sigma2, w, m, n, 3, ys.device)
    mask = pec._active_mask(*pec._tile_bounds(ys, TILE_M),
                            *pec._tile_bounds(xs, TILE_N), scal[0])
    p1, px, xx, pt1 = torch.zeros(m), torch.zeros(m, 3), torch.zeros(()), []
    for g, inv_den, pt1_j, xx_j, x_j in pec._plain_stripes(
            ys, xs, scal, mask, TILE_M, TILE_N, fast=True):
        gb = pec._bf16(g)
        hi, mid, lo = (gb @ piece.float() for piece in
                       pec.moment_pieces(x_j, inv_den).unbind(1))
        stripe = hi + (mid + lo)
        p1, px = p1 + stripe[:, 3], px + stripe[:, :3]
        xx = xx + xx_j
        pt1.append(pt1_j)
    pt1 = torch.empty(n).index_copy_(0, perm_x, torch.cat(pt1))
    p1 = torch.empty(m).index_copy_(0, perm_y, p1)
    px = torch.empty(m, 3).index_copy_(0, perm_y, px)
    rel = math.exp(2 * a) * (1 + 2.0 ** -8) - 1
    p1_mag, px_mag, pt1_mag, xx_mag = _dense_terms(src, tgt, sigma2, w)
    _within("pt1", pt1, ref.pt1, pt1_mag, rel)
    _within("p1", p1, ref.p1, p1_mag, rel)
    _within("px", px, ref.px, px_mag, rel)
    _within("xx", xx, ref.xx, xx_mag, rel)
    _within("n_p", p1.sum(), ref.n_p, p1_mag.sum(), rel)


# --------------------------------------------------------------------------
# K6's fast kernel on the tensor cores: its weight operand and its
# association
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_weight_pieces_rebuild_the_weights(seed):
    """hi + mid + lo of every weight is the weight within 2^-24 of it
    (f32's half ulp) over the magnitudes FilterReg's channels take and far
    beyond, zeros give zero pieces, and subnormal and tiny normal weights
    come back within 2^-134: bf16's subnormals are multiples of 2^-133, so
    no three pieces hold a finer remainder."""
    rng = np.random.default_rng(seed)
    m, c = 999, 5
    w = rng.normal(size=(m, c)) * 10.0 ** rng.uniform(-30, 30, (m, 1))
    w[5::13] = rng.uniform(-1, 1, (len(w[5::13]), c)) * 2.0 ** -127
    w[7::17, 0] = np.float32(2.0 ** -140)     # subnormal in f32
    w[9::19, 1] = np.float32(-3 * 2.0 ** -133)  # exactly a bf16 subnormal
    w[::11] = 0.0
    w = _t(w)
    pieces = pgc.weight_pieces(w)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (m, 3, c)
    p = pieces.double()
    rebuilt = p[:, 0] + p[:, 1] + p[:, 2]
    wd = w.double()
    err = (rebuilt - wd).abs()
    assert bool((err <= torch.clamp(2.0 ** -24 * wd.abs(),
                                    min=2.0 ** -134)).all())
    normal = wd.abs() >= 2.0 ** -100
    assert bool(normal.sum() > m) and bool(
        (err[normal] <= 2.0 ** -24 * wd.abs()[normal]).all())
    assert bool((pieces[::11] == 0).all())
    assert bool((rebuilt[9::19, 1] == wd[9::19, 1]).all())
    # The pieces are those of estep_cuda's moment operand.
    assert torch.equal(pieces.view(torch.int16),
                       pec.bf16_pieces(w).view(torch.int16))


def _stage_starts(m, tile):
    """The kernel's stages: each point tile from its start, 256 points at
    a time (csrc/gt.cu)."""
    return [s0 for t0 in range(0, m, tile)
            for s0 in range(t0, min(t0 + tile, m), 256)] + [m]


def _k6_fast_association(g, w, tile):
    """K6's fast kernel's sum, in plain torch: g (N, M) f32 split into
    hi = bf16(g) and lo = bf16(g - hi), the weights into weight_pieces;
    per stage (g_hi + g_lo) w_hi, (g_hi + g_lo) w_mid and g_hi w_lo with
    exact products (f64), each rounded to f32, the stage's hi + (mid + lo)
    in f32, stages added in order in f32."""
    g_hi = pec._bf16(g)
    g_lo = pec._bf16(g - g_hi)
    pieces = pgc.weight_pieces(w).double()
    starts = _stage_starts(g.shape[1], tile)
    tot = torch.zeros((g.shape[0], w.shape[1]))
    for s0, s1 in zip(starts[:-1], starts[1:]):
        gh, gl = g_hi[:, s0:s1].double(), g_lo[:, s0:s1].double()
        w_hi, w_mid, w_lo = pieces[s0:s1].unbind(1)
        hi = ((gh + gl) @ w_hi).float()
        mid = ((gh + gl) @ w_mid).float()
        lo = (gh @ w_lo).float()
        tot = tot + (hi + (mid + lo))
    return tot


def _far_queries(tgt, n_far, dist, seed):
    """``tgt`` with n_far points near -dist (1, 1, 1) and n_far near +dist
    (1, 1, 1) appended: the shared centroid stays near the origin, so the
    gate still fires at a large h, and the Morton order puts each far
    cluster in query tiles of its own, which are culled."""
    rng = np.random.default_rng(seed)
    far = rng.normal(0, 0.5, (2 * n_far, 3))
    far[:n_far] -= dist
    far[n_far:] += dist
    return np.concatenate([tgt, far]).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 4, 8])
def test_k6_fast_association_matches_f64_and_the_references_fast_branch(
        channels):
    """The fast kernel's association on the port's plain fast g (far
    query clusters culled, signed weights), against the f64 product of the
    same g within 2^-16 of sum_j g |w| (the split drops ~2^-17 of each
    g w, the f32 sums less), and against the reference's
    gauss_transform_culled on its fast branch within (e^a (1 + 2^-8) - 1)
    of sum_j g |w| (test_k6_plain_fast_branch_matches_the_references_fast
    _branch's tolerance)."""
    src, tgt = _pair(500, 450)
    tgt = _far_queries(tgt, 300, 400.0, channels)
    h = math.sqrt(float(_ref_bound_k6(src, tgt, 1.0)) / TOL * 2.5)
    a = float(_ref_bound_k6(src, tgt, h))
    assert a <= TOL / 2 and jcfg.config.estep_fast_start
    w = np.random.default_rng(channels).uniform(
        -1, 1, (500, channels)).astype(np.float32)
    ref = jep.gauss_transform_culled(src, tgt, w, h, tile=128,
                                     interpret=True)
    s_t, t_t, w_t = _t(src), _t(tgt), _t(w)
    cen = (s_t.sum(0) + t_t.sum(0)) / (s_t.shape[0] + t_t.shape[0])
    s_t, t_t = s_t - cen, t_t - cen
    perm_p, perm_q = morton_order(s_t), morton_order(t_t)
    qs, ps, wk, inv_h2, mask, tile = pgc.prepare(
        s_t[perm_p], t_t[perm_q], w_t[perm_p], h, 128)
    assert not bool(mask.all()) and bool(mask.any())
    g = torch.cat([gb for _, gb in pgc.plain_blocks(qs, ps, inv_h2, mask,
                                                    tile, fast=True)], 1)
    got = _k6_fast_association(g, wk, tile)
    want = g.double() @ wk.double()
    mag = g.double() @ wk.double().abs()
    assert bool(((got.double() - want).abs() <= 2.0 ** -16 * mag).all())
    dead = (~mask.any(0)).repeat_interleave(pgc._ROWS)[:qs.shape[0]]
    assert bool(dead.any()) and bool((got[dead] == 0).all())
    out = torch.empty_like(got).index_copy_(0, perm_q, got)
    d2 = ((tgt[:, None, :].astype(np.float64) - src[None]) ** 2).sum(-1)
    mag_ref = np.exp(-d2 / h ** 2) @ np.abs(w.astype(np.float64))
    _within("gt", out, ref, mag_ref, math.exp(a) * (1 + 2.0 ** -8) - 1)


# --------------------------------------------------------------------------
# The bound
# --------------------------------------------------------------------------

def _clouds_for_bound(seed):
    rng = np.random.default_rng(seed)
    yield rng.normal(size=(300, 3)), rng.normal(size=(260, 3))
    yield (rng.uniform(-1, 1, (300, 3)) + [4.0, -3.0, 2.0],
           rng.uniform(-1, 1, (280, 3)) + [4.0, -3.0, 2.5])
    yield rng.normal(size=(200, 3)) * [5.0, 0.1, 1.0], \
        rng.normal(size=(240, 3)) * [4.0, 0.2, 1.0]
    yield rng.normal(size=(250, 2)) * 3.0, rng.normal(size=(230, 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_argument_error_stays_under_the_bound(seed):
    """The plain fast branch's exp argument (the bf16 cross term, f32 sum)
    against the exact branch's, for the CPD E-step (1 / 2 sigma2) and the
    Gauss transform's expanded form (1 / h^2, 5-D too): never beyond
    fast_bound, at any inverse scale (the bound is linear in it)."""
    rng = np.random.default_rng(seed + 10)
    for y, x in list(_clouds_for_bound(seed)) + [
            (rng.normal(size=(150, 5)), rng.normal(size=(170, 5)))]:
        y, x = _t(y), _t(x)
        y2, x2 = (y * y).sum(1), (x * x).sum(1)
        inv = 0.37
        exact = -torch.clamp(y2[:, None] + x2[None] - 2.0 * (y @ x.T),
                             min=0.0) * inv
        fast = -torch.clamp(y2[:, None] + x2[None]
                            - 2.0 * (pec._bf16(y) @ pec._bf16(x).T),
                            min=0.0) * inv
        bound = float(pec.fast_bound(y2, x2, inv))
        err = float((fast - exact).abs().max())
        assert 0.0 < err <= bound, (err, bound)
        # The kernels' plain versions stay within it too.
        live = exact > -80.0
        nq_tiles = -(-x.shape[0] // pgc._ROWS)
        g6 = pgc.gauss_transform_culled_plain(
            x, y, torch.eye(y.shape[0]), inv,
            torch.ones((1, nq_tiles), dtype=torch.bool), y.shape[0], True)
        gots = [g6.T]
        if y.shape[1] <= 3:
            act = torch.ones(y.shape[0], dtype=torch.bool)
            gots.append(pec.stash_den_raw_plain(
                y, y2, x, x2, torch.tensor([inv, 0.0]), act, 1, y.shape[0],
                True)[0])
        for g in gots:
            arg = torch.log(g.double())[live]
            assert float((arg - exact.double()[live]).abs().max()) \
                <= bound + 1e-5


# --------------------------------------------------------------------------
# stash_dtype and matmul_dtype
# --------------------------------------------------------------------------

@pytest.mark.parametrize("merged", [False, True])
def test_bf16_stash_matches_the_reference(monkeypatch, merged):
    """config.stash_dtype = bfloat16 against the reference's estep_auto
    with stash_dtype=bfloat16 (its merged core too): pass B reads g
    rounded to bf16, den stays f32, and the fast branch is off in both."""
    src, tgt = _pair()
    sigma2, w = 0.05, 0.05
    old = jcfg.config.use_merged_stash
    jcfg.config.use_merged_stash = merged
    jcfg.clear_caches()
    try:
        ref = jep.estep_auto(src, tgt, jnp.float32(sigma2), w, tile_m=TILE_M,
                             tile_n=TILE_N, interpret=True,
                             stash_dtype=jnp.bfloat16)
    finally:
        jcfg.config.use_merged_stash = old
        jcfg.clear_caches()
    monkeypatch.setattr(pcfg.config, "use_merged_stash", merged)
    monkeypatch.setattr(pcfg.config, "stash_dtype", torch.bfloat16)
    pec.reset_launches()
    out = pec.estep_auto(_t(src), _t(tgt), sigma2, w, tile_m=TILE_M,
                         tile_n=TILE_N)
    assert pec.fast_steps() == 0
    p1_mag, px_mag, pt1_mag, xx_mag = _dense_terms(src, tgt, sigma2, w)
    # pt1 and xx never see the rounding: the repo's 1e-5.
    np.testing.assert_allclose(out.pt1.numpy(), np.asarray(ref.pt1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(out.xx), float(ref.xx), rtol=1e-5)
    _within("p1", out.p1, ref.p1, p1_mag, 2.0 ** -8)
    _within("px", out.px, ref.px, px_mag, 2.0 ** -8)
    # And it is not the f32 stash: the rounding shows in p1.
    monkeypatch.setattr(pcfg.config, "stash_dtype", torch.float32)
    f32 = pec.estep_auto(_t(src), _t(tgt), sigma2, w, tile_m=TILE_M,
                         tile_n=TILE_N)
    assert not torch.equal(f32.p1, out.p1)


@pytest.mark.parametrize("merged", [False, True])
def test_bf16_stash_moments_from_pieces_match_the_reference(merged):
    """The bf16-stash pass B's association on the card (moment_bf16_kernel,
    both routes) in plain torch: per stripe, bf16 of pass A's exact g times
    each piece of moment_pieces in f32 (exact products), the stripe's hi +
    (mid + lo), stripes added in order. Against the reference's estep_auto
    with stash_dtype=bfloat16 (its merged core too), within the 2^-8 of
    test_bf16_stash_matches_the_reference; pt1 and xx, which never see the
    rounding, within the repo's 1e-5. A far cluster of 300 sources makes
    whole source tiles that every stripe culls (their rows' moments are
    exact zeros)."""
    src, tgt = _pair()
    src[:300, 2] += 30.0
    sigma2, w = 0.05, 0.05
    old = jcfg.config.use_merged_stash
    jcfg.config.use_merged_stash = merged
    jcfg.clear_caches()
    try:
        ref = jep.estep_auto(src, tgt, jnp.float32(sigma2), w, tile_m=TILE_M,
                             tile_n=TILE_N, interpret=True,
                             stash_dtype=jnp.bfloat16)
    finally:
        jcfg.config.use_merged_stash = old
        jcfg.clear_caches()
    y, x = _t(src), _t(tgt)
    perm_y, perm_x = morton_order(y), morton_order(x)
    ys, xs = y[perm_y], x[perm_x]
    m, n = ys.shape[0], xs.shape[0]
    scal = pec._scalars(sigma2, w, m, n, 3, ys.device)
    mask = pec._active_mask(*pec._tile_bounds(ys, TILE_M),
                            *pec._tile_bounds(xs, TILE_N), scal[0])
    assert not bool(mask.all())
    p1, px, xx, pt1 = torch.zeros(m), torch.zeros(m, 3), torch.zeros(()), []
    for g, inv_den, pt1_j, xx_j, x_j in pec._plain_stripes(
            ys, xs, scal, mask, TILE_M, TILE_N):
        gb = pec._bf16(g)
        hi, mid, lo = (gb @ piece.float() for piece in
                       pec.moment_pieces(x_j, inv_den).unbind(1))
        stripe = hi + (mid + lo)
        p1, px = p1 + stripe[:, 3], px + stripe[:, :3]
        xx = xx + xx_j
        pt1.append(pt1_j)
    pt1 = torch.empty(n).index_copy_(0, perm_x, torch.cat(pt1))
    p1 = torch.empty(m).index_copy_(0, perm_y, p1)
    px = torch.empty(m, 3).index_copy_(0, perm_y, px)
    assert bool((p1[:300] == 0).all()) and bool((px[:300] == 0).all())
    p1_mag, px_mag, _, _ = _dense_terms(src, tgt, sigma2, w)
    np.testing.assert_allclose(pt1.numpy(), np.asarray(ref.pt1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(xx), float(ref.xx), rtol=1e-5)
    _within("p1", p1, ref.p1, p1_mag, 2.0 ** -8)
    _within("px", px, ref.px, px_mag, 2.0 ** -8)
    _within("n_p", p1.sum(), ref.n_p, p1_mag.sum(), 2.0 ** -8)


@pytest.fixture
def bf16_matmul(monkeypatch):
    old = jcfg.config.matmul_dtype
    jcfg.config.matmul_dtype = jnp.bfloat16
    jcfg.clear_caches()
    monkeypatch.setattr(pcfg.config, "matmul_dtype", torch.bfloat16)
    yield
    jcfg.config.matmul_dtype = old
    jcfg.clear_caches()


def test_bf16_matmul_estep_xla_matches_the_reference(bf16_matmul):
    """estep_xla with matmul_dtype = bfloat16 in both packages: the cross
    term's operands (pre-scaled by 1 / sqrt(2 sigma2)) and the moment
    product's (pmat and [x, 1]) rounded to bf16, the products in f32."""
    src, tgt = _pair(400, 380)
    sigma2, w = 0.05, 0.05
    ref = jeo.estep_xla(src, tgt, jnp.float32(sigma2), w)
    out = peo.estep_xla(_t(src), _t(tgt), sigma2, w)
    p1_mag, px_mag, pt1_mag, xx_mag = _dense_terms(src, tgt, sigma2, w)
    _within("p1", out.p1, ref.p1, p1_mag, 2.0 ** -8)
    _within("px", out.px, ref.px, px_mag, 2.0 ** -8)
    _within("pt1", out.pt1, ref.pt1, pt1_mag, 2.0 ** -8)
    _within("xx", out.xx, ref.xx, xx_mag, 2.0 ** -8)
    # It is not the f32 product: the rounding shows.
    pcfg.config.matmul_dtype = torch.float32
    f32 = peo.estep_xla(_t(src), _t(tgt), sigma2, w)
    pcfg.config.matmul_dtype = torch.bfloat16
    assert not torch.equal(f32.p1, out.p1)


def test_bf16_matmul_sqdist_matches_the_reference(bf16_matmul):
    src, tgt = _pair(300, 280)
    ref = np.asarray(jpw.sqdist(src, tgt))
    out = ppw.sqdist(_t(src), _t(tgt)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * ref.max())
    exact = ((src[:, None].astype(np.float64) - tgt[None]) ** 2).sum(-1)
    assert np.abs(out - exact).max() > 1e-4  # the bf16 rounding shows


# --------------------------------------------------------------------------
# The carry across
# --------------------------------------------------------------------------

def test_config_from_reference_carries_the_four_fields():
    fields = dataclasses.asdict(jcfg.Config())
    cfg = interop.config_from_reference(fields)
    assert cfg.estep_fast_start is True and cfg.estep_fast_start_tol == 0.02
    assert cfg.matmul_dtype == torch.float32
    assert cfg.stash_dtype == torch.float32
    fields.update(estep_fast_start=False, estep_fast_start_tol=0.005,
                  matmul_dtype=jnp.bfloat16, stash_dtype=jnp.bfloat16)
    cfg = interop.config_from_reference(fields)
    assert cfg.estep_fast_start is False and cfg.estep_fast_start_tol == 0.005
    assert cfg.matmul_dtype == torch.bfloat16
    assert cfg.stash_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        interop.config_from_reference({"stash_dtype": jnp.float16})

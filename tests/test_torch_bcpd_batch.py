"""BCPD batches of the port (probreg_tpu_torch.bcpd.registration_bcpd_batch,
the batched VI loop ``_vi_loop`` and the masked, batched Nystrom factors of
ops.lowrank) held to the JAX package.

Both packages get the same numpy inputs on the CPU: horse[::16] (184
points), horse[::24] (123 points) and the fish, turned by fixed angles.
Tolerances, each with its reason:
* landmark indices: equal (both round the same float32 product);
* masked Nystrom factors: u exactly zero on padded rows; U diag(lam) U^T
  of the valid block within 2e-4 of its largest entry (eigh and the SVD
  run in other orders on an ill-conditioned Gram matrix; the rule of
  tests/test_torch_bcpd.py for sign-invariant quantities);
* bcpd_estep(with_rmse=True): 1e-5 relative (f32 rounding);
* the masked ``_run_bcpd`` and the batches at depth 12 (tol 0): rot, t
  and scale within 1e-4 (the masked loop), transform(source) within 1e-4
  of the target's extent. The two packages' iterates part by ~1e-7 after
  one iteration and ~10x every four (rounding that the VI amplifies;
  batched and unbatched programs decorrelate after ~15 iterations,
  tests/test_batch.py:465-474), so deeper runs are not compared; each case
  asserts that the reference moved, so that it compares no two
  identities;
* the per-row stop rule (port against port, float64 so that rounding of
  batched and single products stays far below it): each row of a batch
  whose rows stop at different iterations within 1e-5 of its own
  single-pair run, last iterate and kept state.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from probreg_tpu import bcpd as jb  # noqa: E402
from probreg_tpu.ops import lowrank as jlr  # noqa: E402
from probreg_tpu.utils import math_utils as jmu  # noqa: E402
from probreg_tpu_torch import bcpd as pb  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch.ops import lowrank as plr  # noqa: E402
from probreg_tpu_torch.utils import io as pio  # noqa: E402
from probreg_tpu_torch.utils import math_utils as pmu  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
DEPTH = dict(maxiter=12, tol=0.0, lmd=10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the loop runs many small products that spin on
    oversubscribed cores under the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rot(deg):
    return pso.euler2mat(*np.deg2rad(deg)).numpy().astype(np.float32)


@pytest.fixture(scope="module")
def horse():
    pts = pio.read_point_cloud(os.path.join(_ROOT, "data", "horse.ply"))
    return pts[::16].astype(np.float32), pts[::24].astype(np.float32)


def _fish():
    load = lambda w: np.loadtxt(os.path.join(  # noqa: E731
        _ROOT, "data", f"fish_{w}.txt")).astype(np.float32)
    return load("source"), load("target")


def _padded(clouds):
    m = max(len(c) for c in clouds)
    out = np.zeros((len(clouds), m, clouds[0].shape[1]), np.float32)
    mask = np.zeros((len(clouds), m), np.float32)
    for i, c in enumerate(clouds):
        out[i, :len(c)], mask[i, :len(c)] = c, 1.0
    return out, mask


# --------------------------------------------------------------------------
# ops.lowrank: valid= and max_landmarks=
# --------------------------------------------------------------------------

def test_landmark_indices_are_the_references():
    """Both of the reference's strides as its jitted lowrank_imq computes
    them (lowrank.py:66, :74-75), over many counts and landmark numbers."""
    @jax.jit
    def masked(m_valid, ell_ones):
        ell = ell_ones.shape[0]
        return jnp.round(jnp.linspace(0.0, 1.0, ell)
                         * jnp.maximum(m_valid - 1.0, 0.0)).astype(jnp.int32)

    def fixed(m, ell):
        return np.asarray(jax.jit(lambda p: jnp.round(jnp.linspace(
            0, p.shape[0] - 1, ell)).astype(jnp.int32))(jnp.zeros((m, 1))))

    for ell in (1, 2, 3, 7, 32, 33, 40, 64, 128):
        counts = np.arange(max(ell, 1), 3000, 7)[::25]
        want = np.stack([np.asarray(masked(jnp.float32(c), jnp.ones(ell)))
                         for c in counts])
        got = plr.landmark_indices(_t(counts), ell).numpy()
        np.testing.assert_array_equal(got, want)
        for m in counts[::6]:
            np.testing.assert_array_equal(plr.landmark_indices(
                torch.tensor(float(m)), ell, masked=False).numpy(),
                fixed(int(m), ell))


def test_masked_and_batched_nystrom_match_reference(horse):
    big, small = horse
    pts, mask = _padded([big, small])
    rank, cap = 20, len(small)
    u_p, lam_p = (a.double().numpy() for a in plr.lowrank_imq(
        _t(pts), 1.0, rank, valid=_t(mask), max_landmarks=cap))
    assert u_p.shape == (2, len(big), rank) and lam_p.shape == (2, rank)
    for b, cloud in enumerate((big, small)):
        u_j, lam_j = (np.asarray(a, np.float64) for a in jlr.lowrank_imq(
            jnp.asarray(pts[b]), 1.0, rank, valid=jnp.asarray(mask[b]),
            max_landmarks=cap))
        n = len(cloud)
        assert not u_p[b, n:].any()                 # exactly zero padding
        g_p = (u_p[b, :n] * lam_p[b]) @ u_p[b, :n].T
        g_j = (u_j[:n] * lam_j) @ u_j[:n].T
        assert _rel(g_p, g_j) < 2e-4
        assert _rel(lam_p[b], lam_j) < 2e-4
    # One cloud unmasked through the batch axis: the single call's factors.
    u1, lam1 = plr.lowrank_imq(_t(big), 1.0, rank)
    ub, lamb = plr.lowrank_imq(_t(big[None]), 1.0, rank)
    g1 = (u1 * lam1) @ u1.T
    assert _rel((ub[0] * lamb[0]) @ ub[0].T, g1) < 1e-5


# --------------------------------------------------------------------------
# bcpd_estep(with_rmse=True) and the masked VI of one pair
# --------------------------------------------------------------------------

def test_estep_with_rmse_matches_reference():
    src, tgt = _fish()
    rng = np.random.default_rng(0)
    m = len(src)
    alpha = rng.uniform(0.5, 1.5, m).astype(np.float32) / m
    sdiag = rng.uniform(0.0, 0.1, m).astype(np.float32)
    args = (0.9, alpha, sdiag, 0.3, 0.1)
    res_j, rmse_j = jax.jit(jb.bcpd_estep, static_argnums=(6, 7))(
        jnp.asarray(src), jnp.asarray(tgt), *map(jnp.asarray, args[:4]),
        args[4], True)
    res_p, rmse_p = pb.bcpd_estep(_t(src), _t(tgt), *map(_t, args[:4]),
                                  args[4], with_rmse=True)
    for a, b in zip(res_p, res_j):
        assert _rel(a, b) < 1e-5
    assert _rel(rmse_p, rmse_j) < 1e-5
    assert pb.bcpd_estep(_t(src), _t(tgt), *map(_t, args[:4]),
                         args[4]).nu.shape == (m,)


@pytest.mark.parametrize("block", [4096, 64])
def test_masked_run_bcpd_matches_reference(horse, block):
    """One padded pair (123 of 184 source rows, 110 of 150 target columns)
    through the masked loop, dense and blocked over target columns."""
    _, small = horse
    tgt = (small @ _rot([8.0, -4.0, 6.0]).T)[:110] + 0.01
    cen = np.concatenate([small, tgt]).mean(0)
    sc = np.sqrt(pmu.squared_kernel_sum_np(small, tgt))
    s, sm = np.zeros((184, 3), np.float32), np.zeros(184, np.float32)
    t, tm = np.zeros((150, 3), np.float32), np.zeros(150, np.float32)
    s[:len(small)], sm[:len(small)] = (small - cen) / sc, 1.0
    t[:len(tgt)], tm[:len(tgt)] = (tgt - cen) / sc, 1.0
    s20 = float(jmu.masked_squared_kernel_sum_t(
        jnp.asarray(s.T), jnp.asarray(t.T), jnp.asarray(sm),
        jnp.asarray(tm)))
    tr_j, *_ = jb._run_bcpd(
        jnp.asarray(s), jnp.asarray(t),
        jmu.inverse_multiquadric_kernel(jnp.asarray(s), jnp.asarray(s)),
        jnp.float32(10.0), jnp.float32(1e20), jnp.float32(s20), w=0.0,
        maxiter=12, tol=0.0, block=block, smask=jnp.asarray(sm),
        tmask=jnp.asarray(tm))
    tr_p, *_ = pb._run_bcpd(
        _t(s), _t(t), pmu.inverse_multiquadric_kernel(_t(s), _t(s)),
        torch.tensor(10.0), torch.tensor(1e20), torch.tensor(s20), w=0.0,
        maxiter=12, tol=0.0, block=block, smask=_t(sm), tmask=_t(tm))
    n = len(small)
    moved_j = np.asarray(tr_j.transform(s))[:n]
    assert np.abs(moved_j - s[:n]).max() > 1e-2     # the reference moved
    rt_p, rt_j = tr_p.rigid_trans, tr_j.rigid_trans
    for name in ("rot", "t", "scale"):
        np.testing.assert_allclose(getattr(rt_p, name).numpy(),
                                   np.asarray(getattr(rt_j, name)), atol=1e-4)
    extent = float(np.ptp(t[:len(tgt)], 0).max())
    np.testing.assert_allclose(tr_p.transform(s).numpy()[:n], moved_j,
                               atol=1e-4 * extent)


# --------------------------------------------------------------------------
# registration_bcpd_batch against the reference
# --------------------------------------------------------------------------

def _cases(horse):
    big, small = horse
    turned = [big @ _rot([8.0, -4.0, 6.0]).T,
              big @ _rot([0.0, 0.0, 10.0]).T + 0.01]
    ragged_t = [turned[0], small @ _rot([0.0, 0.0, 10.0]).T + 0.01]
    search_t = [big @ _rot([0.0, 0.0, 120.0]).T,
                big @ _rot([5.0, -3.0, 4.0]).T]
    return {
        "fixed": (np.stack([big, big]), np.stack(turned), {}),
        "ragged": ([big, small], ragged_t, {}),
        "ragged_rank16": ([big, small], ragged_t, dict(rank=16)),
        "search4": (np.stack([big, big]), np.stack(search_t),
                    dict(n_starts=4)),
        "search4_ragged": ([big, small],
                           [search_t[0], small @ _rot([5.0, -3.0, 4.0]).T],
                           dict(n_starts=4)),
    }


@pytest.mark.parametrize("case", ["fixed", "ragged", "ragged_rank16",
                                  "search4", "search4_ragged"])
def test_registration_bcpd_batch_matches_reference(horse, case):
    sources, targets, kw = _cases(horse)[case]
    want = jb.registration_bcpd_batch(sources, targets, **DEPTH, **kw)
    got = pb.registration_bcpd_batch(sources, targets, **DEPTH, **kw, **CPU)
    assert len(got) == len(want) == len(sources)
    for g, w, src, tgt in zip(got, want, sources, targets):
        extent = float(np.ptp(tgt, 0).max())
        moved_j = np.asarray(w.transform(src))
        assert np.abs(moved_j - src).max() > 1e-2 * extent  # it moved
        assert tuple(g.v.shape) == src.shape
        np.testing.assert_allclose(g.transform(src).numpy(), moved_j,
                                   atol=1e-4 * extent)


# --------------------------------------------------------------------------
# The batched loop: per-row stop rule, host reads, refusals
# --------------------------------------------------------------------------

def test_rows_stop_on_their_own_and_one_read_per_iteration(horse,
                                                           monkeypatch):
    """Two normalized pairs whose criteria settle at different iterations
    (tol 1e-4): each row of the batch is its own single-pair run, and the
    batch reads the host once per iteration of its longest row."""
    big, _ = horse
    f64 = torch.float64
    monkeypatch.setattr(pcfg.config, "dtype", f64)
    pairs = []
    for deg in ([8.0, -4.0, 6.0], [0.0, 0.0, 10.0]):
        tgt = big.astype(np.float64) @ _rot(deg).T.astype(np.float64)
        cen = np.concatenate([big, tgt]).mean(0)
        sc = np.sqrt(pmu.squared_kernel_sum_np(big, tgt))
        pairs.append(((big - cen) / sc, (tgt - cen) / sc))
    src = _t(np.stack([p[0] for p in pairs]), f64)
    tgt = _t(np.stack([p[1] for p in pairs]), f64)
    gmat = pb._gram_rows(src, None)
    s20 = pb._squared_kernel_sums(src, tgt)
    lmd, k = torch.tensor(2.0, dtype=f64), torch.tensor(1e20, dtype=f64)
    kw = dict(w=0.0, maxiter=12, tol=1e-4)
    pb.reset_reads()
    kept, _, last = pb._vi_loop(src, tgt, gmat, lmd, k, s20, **kw)
    batch_reads = pb.READS
    reads = []
    for i in range(2):
        pb.reset_reads()
        tr, _, _, _, _, last1 = pb._run_bcpd(src[i], tgt[i], gmat[i], lmd,
                                             k, s20[i], **kw)
        reads.append(pb.READS - 1)       # less the one fetch of its result
        for a, b in zip(last[:5], last1[:5]):  # rot, t, scale, v_t, sigma2
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), atol=1e-5)
        np.testing.assert_allclose(kept[3][i].numpy(), tr.v.T.numpy(),
                                   atol=1e-5)
    # The rows stopped at different iterations; the batch read the host
    # once per iteration of its longest row, from the third on.
    assert reads[0] < reads[1] == kw["maxiter"] - 2
    assert batch_reads == max(reads)


def test_reads_do_not_grow_with_the_batch(horse):
    big, small = horse
    for sources, targets in (
            (big[None], (big @ _rot([0.0, 0.0, 10.0]).T)[None]),
            (np.stack([big] * 3), np.stack([big @ _rot([0.0, 0.0, d]).T
                                            for d in (5.0, 10.0, 20.0)]))):
        pb.reset_reads()
        pb.registration_bcpd_batch(sources, targets, maxiter=6, tol=0.0,
                                   **CPU)
        assert pb.READS == 6 - 2
    pb.reset_reads()
    pb.registration_bcpd_batch([big, small, big[:100]],
                               [big, small, big[:90]], maxiter=6, tol=0.0,
                               n_starts=3, **CPU)
    assert pb.READS == 6 - 2


def test_refusals_match_reference(horse):
    big, small = horse
    fs, ft = _fish()
    cases = [
        lambda m: m.registration_bcpd_batch(
            big[None], big[None], n_starts=4, normalize=False),
        lambda m: m.registration_bcpd_batch(
            [big, small], [big, small], n_starts=4, normalize=False),
        lambda m: m.registration_bcpd_batch(fs[None], ft[None], n_starts=4),
        lambda m: m.registration_bcpd_batch([big, small[:12]],
                                            [big, small], rank=16),
    ]
    for run in cases:
        with pytest.raises(ValueError) as want:
            run(jb)
        with pytest.raises(ValueError) as got:
            run(_CpuBatch)
        assert str(got.value) == str(want.value)


class _CpuBatch:
    """The port's batch entry point on the CPU, called as the reference's."""

    @staticmethod
    def registration_bcpd_batch(*a, **k):
        return pb.registration_bcpd_batch(*a, device="cpu", **k)

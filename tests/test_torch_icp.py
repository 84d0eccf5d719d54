"""Point-to-point ICP of the port (probreg_tpu_torch.icp, ops.icp_cuda) held
to the JAX package.

Both packages register the same numpy clouds on the CPU: the port's loop
``_run_icp`` against the reference's twin of the same name, and the plain
version of the whole-ICP kernel against the reference's fused kernel
``em_pallas.run_icp_fused`` in interpret mode.

Tolerances, each with its reason:
* nearest neighbours on untied clouds: the same indices, d2 to 1e-5 (the
  port takes differences, the reference the expanded form);
* the loops at a fixed depth (tol = 0): rot and t to 1e-5, the same n_iter
  (only f32 rounding of the reductions and the SVD differ);
* the kernel's plain version against the fused kernel: rot and t 1e-5
  (Horn by Jacobi in double here, by power iteration in f32 there), on
  untied clouds centred near the origin; the rmse to 2e-6 absolute, since
  the reference's expanded-form d2 carries ~|y|^2 eps = 1.5e-8 per pair on
  matched distances of ~3e-6;
* masked against unpadded and a batch against its pairs: bit for bit (the
  same valid points reach the same arithmetic).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import icp as jicp  # noqa: E402
from probreg_tpu.ops import em_pallas as jem  # noqa: E402
from probreg_tpu_torch import icp as picp  # noqa: E402
from probreg_tpu_torch.ops import icp_cuda as pic  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's workers torch's default pool
    oversubscribes the cores, and this file's many small products spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rot(deg):
    return pso.euler2mat(*np.deg2rad(deg)).numpy().astype(np.float64)


def _horse():
    from probreg_tpu_torch.utils import io

    return io.read_point_cloud(os.path.join(_ROOT, "data", "horse.ply"))


@pytest.fixture(scope="module")
def horse_pair():
    """Two different subsets of data/horse.ply (400 and 500 of its 2,936
    points), centred, the target rotated 10 degrees about z and shifted."""
    rng = np.random.default_rng(0)
    pts = np.asarray(_horse(), np.float64)
    pts = pts - pts.mean(0)
    src = pts[rng.choice(len(pts), 400, replace=False)]
    tgt = pts[rng.choice(len(pts), 500, replace=False)] @ _rot(
        [0, 0, 10]).T + [0.01, -0.005, 0.002]
    return src.astype(np.float32), tgt.astype(np.float32)


@pytest.fixture(scope="module")
def untied_pair():
    """400 points uniform in [-0.5, 0.5]^3 and, as the target, the same
    points rotated 6 degrees, shifted, with 1e-3 noise, shuffled, beside
    100 other points: once aligned, every source point's nearest target is
    its own image by a wide margin, so no rounding flips a match."""
    rng = np.random.default_rng(5)
    src = rng.uniform(-0.5, 0.5, (400, 3))
    tgt = src @ _rot([2, -3, 5]).T + [0.01, 0.0, -0.01] \
        + 1e-3 * rng.standard_normal(src.shape)
    tgt = np.concatenate([tgt, rng.uniform(-0.5, 0.5, (100, 3))])
    return src.astype(np.float32), rng.permutation(tgt).astype(np.float32)


def test_nearest_t_matches_reference():
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
    d2_j, idx_j = jicp._nearest_t(jnp.asarray(src.T), jnp.asarray(tgt.T))
    # Small blocks on both axes: the chunk boundaries are exercised.
    d2_p, idx_p = picp._nearest_t(_t(src.T), _t(tgt.T), block=256,
                                  src_block=128)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_p.numpy(), np.asarray(d2_j), atol=1e-5)
    d2_f, idx_f = picp._nearest_t(_t(src.T), _t(tgt.T))
    np.testing.assert_array_equal(idx_f.numpy(), idx_p.numpy())
    np.testing.assert_array_equal(d2_f.numpy(), d2_p.numpy())


@pytest.mark.parametrize("trim", [0.0, 0.1])
def test_run_icp_matches_reference(horse_pair, trim):
    src, tgt = horse_pair
    kw = dict(maxiter=20, tol=0.0, trim_fraction=trim)
    rot_j, t_j, rmse_j, it_j = jicp._run_icp(
        jnp.asarray(src), jnp.asarray(tgt), jnp.eye(3), jnp.zeros(3), **kw)
    rot_p, t_p, rmse_p, it_p = picp._run_icp(
        _t(src), _t(tgt), torch.eye(3), torch.zeros(3), **kw)
    assert it_p == int(it_j) == 20
    np.testing.assert_allclose(rot_p.numpy(), np.asarray(rot_j), atol=1e-5)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(float(rmse_p), float(rmse_j), rtol=1e-4)


def _fused_ref(src, tgt, **kw):
    rot, t, rmse, it = jem.run_icp_fused(jnp.asarray(src), jnp.asarray(tgt),
                                         interpret=True, **kw)
    return np.asarray(rot), np.asarray(t), float(rmse), int(it)


def test_kernel_plain_version_matches_reference_fused_kernel(untied_pair):
    """Untied clouds near the origin; a warm start; the stop test at a
    finite tol (both stop at the same iteration)."""
    src, tgt = untied_pair
    for kw in (dict(maxiter=15, tol=0.0),
               dict(rot0=_rot([1, -2, 4]).astype(np.float32),
                    t0=np.array([0.005, 0.0, -0.002], np.float32),
                    maxiter=10, tol=0.0),
               dict(maxiter=50, tol=1e-6)):
        rot_j, t_j, rmse_j, it_j = _fused_ref(src, tgt, **kw)
        args = {k: (None if v is None else _t(v)) for k, v in kw.items()
                if k in ("rot0", "t0")}
        rot_p, t_p, rmse_p, it_p = pic.run_icp_fused(
            _t(src), _t(tgt), **args, maxiter=kw["maxiter"], tol=kw["tol"])
        assert int(it_p) == it_j, kw
        np.testing.assert_allclose(rot_p.numpy(), rot_j, atol=1e-5)
        np.testing.assert_allclose(t_p.numpy(), t_j, atol=1e-5)
        np.testing.assert_allclose(float(rmse_p), rmse_j, atol=2e-6)


def test_kernel_plain_version_masked_equals_unpadded(untied_pair):
    """Padded points carry nothing: the masked pair is the unpadded one, bit
    for bit, and the reference's masked fused kernel agrees."""
    src, tgt = untied_pair
    rng = np.random.default_rng(3)
    sp = np.concatenate([src, rng.uniform(-1, 1, (60, 3))]).astype(
        np.float32)
    tp = np.concatenate([tgt, rng.uniform(-1, 1, (40, 3))]).astype(
        np.float32)
    sperm, tperm = rng.permutation(len(sp)), rng.permutation(len(tp))
    smask = (np.arange(len(sp)) < len(src)).astype(np.float32)[sperm]
    tmask = (np.arange(len(tp)) < len(tgt)).astype(np.float32)[tperm]
    sp, tp = sp[sperm], tp[tperm]
    kw = dict(maxiter=12, tol=0.0)
    masked = pic.run_icp_fused(_t(sp), _t(tp), smask=_t(smask),
                               tmask=_t(tmask), **kw)
    # The valid points in their padded order: the wrapper compacts stably.
    plain = pic.run_icp_fused(_t(sp[smask > 0]), _t(tp[tmask > 0]), **kw)
    for a, b in zip(masked, plain):
        assert torch.equal(a, b)
    rot_j, t_j, _, it_j = (np.asarray(x) for x in jem.run_icp_fused(
        jnp.asarray(sp), jnp.asarray(tp), smask=jnp.asarray(smask),
        tmask=jnp.asarray(tmask), interpret=True, **kw))
    assert int(it_j) == 12
    np.testing.assert_allclose(masked[0].numpy(), rot_j, atol=1e-5)
    np.testing.assert_allclose(masked[1].numpy(), t_j, atol=1e-5)


def test_exact_ties_go_to_the_first_index():
    """Sources exactly halfway between two lattice targets: the first index
    wins in the port's loop, in the kernel's plain version and in the
    reference's twin _run_icp (the reference's fused kernel averages the
    tied targets instead). All coordinates are dyadic and the clouds
    symmetric, so the centroid is exactly 0 and the ties stay exact."""
    g = np.array([-1.0, 0.0, 1.0])
    tgt = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    half = np.concatenate([0.5 * np.eye(3), -0.5 * np.eye(3)])
    extra = np.array([[0.875, 0.125, -0.125], [0.125, -0.875, 0.25]])
    src = np.concatenate([half, extra, -extra]).astype(np.float32)
    tgt = tgt.astype(np.float32)
    _, idx = picp._nearest_t(_t(src.T), _t(tgt.T))
    # (0.5, 0, 0) ties (0, 0, 0) (index 13) and (1, 0, 0) (index 22).
    assert int(idx[0]) == 13 and int(idx[3]) == 4
    kw = dict(maxiter=1, tol=0.0, trim_fraction=0.0)
    rot_j, t_j, _, _ = jicp._run_icp(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.eye(3), jnp.zeros(3), **kw)
    rot_p, t_p, _, _ = picp._run_icp(_t(src), _t(tgt), torch.eye(3),
                                     torch.zeros(3), **kw)
    rot_k, t_k, _, _ = pic.run_icp_fused(_t(src), _t(tgt), maxiter=1,
                                         tol=0.0)
    assert np.abs(np.asarray(t_j)).max() > 1e-2  # the tie rule shows in t
    for rot, t in ((rot_p, t_p), (rot_k, t_k)):
        np.testing.assert_allclose(rot.numpy(), np.asarray(rot_j), atol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-5)


def test_batch_is_its_pairs_bit_for_bit(horse_cloud):
    """A ragged batch through the kernel's wrapper (plain version on the
    CPU) equals each pair's own run; the entry point agrees."""
    rng = np.random.default_rng(4)
    pts = np.asarray(horse_cloud, np.float32)
    pairs = []
    for m, n in ((120, 150), (200, 90), (64, 64)):
        rot = _rot(rng.uniform(-10, 10, 3))
        pairs.append((pts[rng.choice(len(pts), m, replace=False)],
                      (pts[rng.choice(len(pts), n, replace=False)]
                       @ rot.T).astype(np.float32)))
    from probreg_tpu_torch.utils import interop

    srcs, smask = interop.pad_ragged([p[0] for p in pairs], device="cpu")
    tgts, tmask = interop.pad_ragged([p[1] for p in pairs], device="cpu")
    kw = dict(maxiter=30, tol=1e-6)
    rot, t, rmse, it = pic.run_icp_fused_batch(srcs, tgts, smask, tmask,
                                               **kw)
    res = picp.registration_icp_batch([p[0] for p in pairs],
                                      [p[1] for p in pairs], device="cpu",
                                      **kw)
    for b, (s, x) in enumerate(pairs):
        one = pic.run_icp_fused(_t(s), _t(x), **kw)
        assert torch.equal(rot[b], one[0]) and torch.equal(t[b], one[1])
        assert torch.equal(rmse[b], one[2]) and int(it[b]) == int(one[3])
        single = picp.registration_icp(s, x, device="cpu", **kw)
        assert torch.equal(res[b].transformation.rot,
                           single.transformation.rot)
        assert res[b].n_iter == single.n_iter
        np.testing.assert_allclose(res[b].transformation.rot.numpy(),
                                   one[0].numpy(), atol=1e-4)


def test_callbacks_fire_per_iteration_and_match_reference(horse_pair):
    src, tgt = horse_pair
    seen_p, seen_j = [], []
    res_p = picp.registration_icp(src, tgt, maxiter=7, tol=0.0,
                                  callbacks=[seen_p.append], device="cpu")
    res_j = jicp.registration_icp(src, tgt, maxiter=7, tol=0.0,
                                  callbacks=[seen_j.append])
    assert len(seen_p) == 7 and res_p.n_iter == 7 == int(res_j.n_iter)
    for a, b in zip(seen_p, seen_j):
        np.testing.assert_allclose(a.rot.numpy(), np.asarray(b.rot),
                                   atol=1e-5)
    np.testing.assert_allclose(res_p.transformation.t.numpy(),
                               np.asarray(res_j.transformation.t), atol=1e-5)
    zero = picp.registration_icp(src, src, maxiter=0, device="cpu",
                                 callbacks=[lambda tr: None])
    assert zero.n_iter == 0
    np.testing.assert_array_equal(zero.transformation.rot.numpy(), np.eye(3))


def test_registration_icp_matches_reference_and_recovers_pose(horse_cloud):
    src = np.asarray(horse_cloud, np.float32)
    ang = np.deg2rad([4.0, -2.0, 6.0])
    tgt = (src @ pso.euler2mat(*ang).numpy().T).astype(np.float32)
    res = picp.registration_icp(src, tgt, maxiter=60, tol=1e-10,
                                device="cpu")
    ref = jicp.registration_icp(src, tgt, maxiter=60, tol=1e-10)
    np.testing.assert_allclose(
        pso.mat2euler(res.transformation.rot).numpy(), ang, atol=1e-3)
    np.testing.assert_allclose(res.transformation.rot.numpy(),
                               np.asarray(ref.transformation.rot), atol=1e-5)
    assert float(res.rmse) < 1e-3


def test_kernel_branch_only_for_cuda_tensors(horse_pair, monkeypatch):
    """On CPU tensors the entry points run the loop, never the kernel's
    wrappers; the kernel's gate keeps the reference's sizes."""
    def refuse(*a, **k):
        raise AssertionError("the whole-ICP kernel branch ran on the CPU")

    monkeypatch.setattr(pic, "run_icp_fused", refuse)
    monkeypatch.setattr(pic, "run_icp_fused_batch", refuse)
    src, tgt = horse_pair
    assert not picp._fused_ok(_t(src), _t(tgt), 0.0)
    picp.registration_icp(src, tgt, maxiter=3, device="cpu")
    picp.registration_icp_batch([src, src[:300]], [tgt, tgt[:200]],
                                maxiter=3, device="cpu")
    for m, n in ((1024, 1024), (1025, 1024), (16384, 64), (8, 16384),
                 (390, 390), (7000, 100), (100, 7000)):
        assert pic.fused_dims_ok(m, n) == (jem.fused_dims_ok(m, n)
                                           and m + n <= 14272), (m, n)

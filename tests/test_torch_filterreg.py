"""Rigid FilterReg of the port (probreg_tpu_torch.filterreg, ops.frg_cuda,
ops.rigid_solvers) held to the JAX package.

Both packages register the same numpy clouds on the CPU, through the
branches of the port's path: the one-launch whole-EM branch (on the CPU the
plain version of the CUDA kernel), the dense loop ``_run_em_rigid``, the
streaming loop with the tile-culled Gauss transform (forced at test size by
lowering the thresholds), the batch entry point and the host loop.

Tolerances, each with its reason:
* helpers, solvers and M-steps on the same inputs: 1e-5 (f32 rounding of
  small reductions; the pt2pl solve is an SVD pseudo-inverse here and a
  least-squares SVD there);
* dense and streaming loops at a fixed depth (tol = 0): rot and t 1e-4,
  sigma2 1e-4 relative; pt2pl on the sinusoidal patch with analytic
  normals, where the 6 x 6 system is well posed;
* the whole-EM kernel's plain version against the reference's fused
  kernel in interpret mode: 2e-4 (Jacobi in double against the TPU's
  power iteration in f32 for Horn, elimination against the Schur form for
  pt2pl, summation order), on clouds centred at the origin, where the
  port's centring is the identity and both linearize the twist about the
  same point;
* the whole-EM kernel against the dense loop: transforms only, 5e-4 (Horn
  and the SVD drift apart over the iterations; the JAX package's own
  tolerance, tests/test_em_pallas_interpret.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import config as jcfg  # noqa: E402
from probreg_tpu import filterreg as jf  # noqa: E402
from probreg_tpu.ops import em_pallas as jem  # noqa: E402
from probreg_tpu.ops import gausstransform as jgt  # noqa: E402
from probreg_tpu.ops import pairwise as jpw  # noqa: E402
from probreg_tpu.ops import rigid_solvers as jrs  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import filterreg as pf  # noqa: E402
from probreg_tpu_torch.models import transformation as ptf  # noqa: E402
from probreg_tpu_torch.ops import frg_cuda as pfc  # noqa: E402
from probreg_tpu_torch.ops import gausstransform as pgt  # noqa: E402
from probreg_tpu_torch.ops import gt_cuda as pgc  # noqa: E402
from probreg_tpu_torch.ops import pairwise as ppw  # noqa: E402
from probreg_tpu_torch.ops import rigid_solvers as prs  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's workers torch's default pool
    oversubscribes the cores, and this file's many small products spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _clouds(m=150, n=None, seed=0, deg=(4.0, -3.0, 6.0), noise=0.005,
            dim=3):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (max(m, n or m), dim)).astype(np.float32)
    if dim == 3:
        rot = np.asarray(jso.euler2mat(*np.deg2rad(deg)), np.float32)
    else:
        a = np.deg2rad(deg[2])
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                       np.float32)
    tgt = (src @ rot.T + 0.03 + rng.normal(0, noise, src.shape)
           ).astype(np.float32)
    rng.shuffle(tgt)
    return src[:m].copy(), tgt[:n or m].copy()


def _patch(grid=10, m=64):
    """The sinusoidal patch with analytic normals of __graft_entry__.py: a
    well-posed pt2pl problem (constant normals leave 3 of the 6 twist
    directions free). Centred on the pair's shared centroid."""
    gx, gy = np.meshgrid(np.linspace(-0.5, 0.5, grid),
                         np.linspace(-0.5, 0.5, grid))
    px, py = gx.ravel(), gy.ravel()
    pz = 0.3 * np.sin(4 * px) + 0.24 * np.cos(4 * py)
    pts = np.stack([px, py, pz], 1).astype(np.float32)
    a = np.deg2rad(5.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    tgt = (pts @ rot.T).astype(np.float32)
    nr = np.stack([-1.2 * np.cos(4 * px), 0.96 * np.sin(4 * py),
                   np.ones(len(px))], 1)
    nr = nr / np.linalg.norm(nr, axis=1, keepdims=True)
    src = pts[:m]
    cen = np.concatenate([src, tgt]).mean(0)
    return ((src - cen).astype(np.float32), (tgt - cen).astype(np.float32),
            (nr @ rot.T).astype(np.float32))


def _same_tf(out, ref, atol):
    np.testing.assert_allclose(_np(out.transformation.rot),
                               _np(ref.transformation.rot), atol=atol)
    np.testing.assert_allclose(_np(out.transformation.t),
                               _np(ref.transformation.t), atol=atol)


# --------------------------------------------------------------------------
# Helpers and solvers
# --------------------------------------------------------------------------

def test_twist_helpers_match_reference():
    rng = np.random.default_rng(1)
    for tw in (rng.normal(0, 0.3, 6), np.r_[1e-7, 0, 0, 0.1, 0.2, 0.3]):
        tw = tw.astype(np.float32)
        np.testing.assert_allclose(_np(pso.skew(_t(tw[:3]))),
                                   _np(jso.skew(tw[:3])), atol=0)
        for linear in (False, True):
            r, t = pso.twist_trans(_t(tw), linear=linear)
            rr, tr = jso.twist_trans(tw, linear=linear)
            np.testing.assert_allclose(_np(r), _np(rr), atol=1e-6)
            np.testing.assert_allclose(_np(t), _np(tr), atol=0)
        rot0 = np.asarray(jso.euler2mat(0.1, -0.2, 0.3), np.float32)
        t0 = np.float32([0.5, -1.0, 2.0])
        r, t = pso.twist_mul(_t(tw), _t(rot0), _t(t0))
        rr, tr = jso.twist_mul(tw, rot0, t0)
        np.testing.assert_allclose(_np(r), _np(rr), atol=1e-6)
        np.testing.assert_allclose(_np(t), _np(tr), atol=1e-6)
    # Below an angle^2 of 1e-12 the rotation is exactly the identity.
    r, _ = pso.twist_trans(_t(np.r_[1e-7, 0, 0, 0, 0, 0]))
    assert torch.equal(r, torch.eye(3))


def test_nearest_sqdist_and_point_spacing_match_reference():
    """Both axes chunked (blocks smaller than the clouds), the point itself
    excluded, and invalid targets never a neighbour. 2e-6 absolute: the
    reference's expanded-form d2 carries ~4 eps |x|^2 of f32 noise, here
    |x|^2 <= 3; on the grid of the patch that noise must not keep a point
    from being excluded as its own neighbour."""
    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (130, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (110, 3)).astype(np.float32)
    valid = (rng.uniform(size=110) > 0.3).astype(np.float32)
    for kw in ({}, {"exclude_zero": True}):
        ref = jpw.nearest_sqdist(tgt, tgt, block=32, src_block=48, **kw)
        out = ppw.nearest_sqdist(_t(tgt), _t(tgt), block=32, src_block=48,
                                 **kw)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=2e-6)
    ref = jpw.nearest_sqdist(src, tgt, block=32, src_block=48,
                             target_valid=valid)
    out = ppw.nearest_sqdist(_t(src), _t(tgt), block=32, src_block=48,
                             target_valid=_t(valid))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=2e-6)
    for pts in (tgt, _patch()[1]):
        np.testing.assert_allclose(float(ppw.point_spacing_sq(_t(pts))),
                                   float(jpw.point_spacing_sq(pts)),
                                   rtol=1e-5)
    one = ppw.nearest_sqdist(_t(src[:1]), _t(src[:1]), exclude_zero=True)
    assert torch.isinf(one).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_weighted_kabsch_matches_reference(dim):
    src, tgt = _clouds(m=80, seed=3, dim=dim, noise=0.02)
    w = np.random.default_rng(3).uniform(0, 1, 80).astype(np.float32)
    w[:10] = 0.0
    r, t = prs.weighted_kabsch(_t(src), _t(tgt), _t(w))
    rr, tr = jrs.weighted_kabsch(src, tgt, w)
    np.testing.assert_allclose(_np(r), _np(rr), atol=1e-5)
    np.testing.assert_allclose(_np(t), _np(tr), atol=1e-5)
    r, t = prs.weighted_kabsch(_t(src), _t(tgt), torch.zeros(80))
    assert torch.equal(r, torch.eye(dim)) and torch.equal(t, torch.zeros(dim))


@pytest.mark.parametrize("normals", ["curved", "plane"])
def test_twist_for_pt2pl_matches_reference(normals):
    """On the curved patch the system has full rank; on a plane (one
    constant normal) it has a 3-D null space, where the minimum-norm
    solution keeps those components at 0 (lstsq rcond = 1e-6 there, an SVD
    pseudo-inverse with the same relative cutoff here)."""
    src, tgt, nrm = _patch()
    if normals == "plane":
        nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (len(tgt), 1))
    model, target, nv = src, tgt[:64] + 0.01, nrm[:64]
    w = np.random.default_rng(4).uniform(0.5, 1.0, 64).astype(np.float32)
    tw, q = prs.twist_for_pt2pl(_t(model), _t(target), _t(nv), _t(w))
    twr, qr = jrs.twist_for_pt2pl(model, target, nv, w)
    np.testing.assert_allclose(_np(tw), _np(twr), atol=1e-5)
    np.testing.assert_allclose(float(q), float(qr), rtol=1e-5)
    if normals == "plane":
        # Only the out-of-plane twist components (wx, wy, vz) are set.
        assert float(tw[[2, 3, 4]].abs().max()) < 1e-6
    zero, _ = prs.twist_for_pt2pl(_t(model), _t(target), _t(nv),
                                  torch.zeros(64))
    assert torch.equal(zero, torch.zeros(6))


@pytest.mark.parametrize("objective", ["pt2pt", "pt2pl", "pt2pl_plane"])
def test_msteps_match_reference(objective):
    """The row-major M-steps on the same moments (some m0 rows exactly 0,
    w > 0, m2 given), and the public E-step / M-step of RigidFilterReg.
    ``pt2pl_plane``: one normal for every target point, a rank-deficient
    6 x 6 system."""
    src, tgt, nrm = _patch()
    if objective == "pt2pl_plane":
        objective = "pt2pl"
        nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (len(tgt), 1))
    t_src = src + 0.02
    sigma2 = 0.01
    normals = nrm if objective == "pt2pl" else None
    mom = [np.array(a) if a is not None else None for a in
           jgt.filterreg_moments(t_src / np.sqrt(sigma2),
                                 tgt / np.sqrt(sigma2), tgt, normals,
                                 need_m2=True)]
    for a in mom:
        if a is not None:
            a[:5] = 0.0                    # rows with no support
    rot0 = np.asarray(jso.euler2mat(0.05, 0.0, -0.02), np.float32)
    t0 = np.float32([0.01, 0.02, -0.01])
    c = float(jf._outlier_c(sigma2, 0.1, 64, 100, 3))
    pmom = [None if a is None else _t(a) for a in mom]
    if objective == "pt2pt":
        ref = jf.rigid_mstep_pt2pt(t_src, mom[0], mom[1], mom[2], rot0, t0,
                                   sigma2, c)
        out = pf.rigid_mstep_pt2pt(_t(t_src), *pmom[:3], _t(rot0), _t(t0),
                                   torch.tensor(sigma2), c)
    else:
        ref = jf.rigid_mstep_pt2pl(t_src, *mom, rot0, t0, sigma2, c)
        out = pf.rigid_mstep_pt2pl(_t(t_src), *pmom, _t(rot0), _t(t0),
                                   torch.tensor(sigma2), c)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    # The public surface: expectation_step, then maximization_step.
    kw = dict(target_normals=normals, sigma2=sigma2)
    jreg = jf.RigidFilterReg(src, **kw)
    preg = pf.RigidFilterReg(src, device="cpu", **kw)
    jres = jreg.expectation_step(t_src, tgt, tgt, sigma2, True, objective)
    pres = preg.expectation_step(t_src, tgt, tgt, sigma2, True, objective)
    for a, b in zip(pres, jres):
        if a is not None:
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-6)
    ref = jreg.maximization_step(t_src, tgt, jres, w=0.0,
                                 objective_type=objective)
    out = preg.maximization_step(t_src, tgt, pres, w=0.0,
                                 objective_type=objective)
    _same_tf(out, ref, 1e-5)
    np.testing.assert_allclose(float(out.q), float(ref.q), rtol=1e-4)


# --------------------------------------------------------------------------
# The whole-EM loops
# --------------------------------------------------------------------------

def _loop_args(case):
    """(source, target, normals, kwargs, masks) of one _run_em_rigid case."""
    kw = dict(objective_type="pt2pt", update_sigma2=False, w=0.0,
              maxiter=12, tol=0.0, min_sigma2=1e-4, sigma2_decay=0.9)
    nrm, masks = None, None
    if case == "pt2pl":
        src, tgt, nrm = _patch()
        kw["objective_type"] = "pt2pl"
    elif case == "2d":
        src, tgt = _clouds(m=90, n=70, seed=5, dim=2)
    else:
        src, tgt = _clouds(m=90, n=70, seed=6)
    if case == "update_sigma2":
        kw.update(update_sigma2=True, w=0.05)
    if case == "masked":
        kw["w"] = 0.05
        rng = np.random.default_rng(7)
        src_p = np.zeros((100, 3), np.float32)
        tgt_p = np.zeros((100, 3), np.float32)
        src_p[:90], tgt_p[:70] = src, tgt
        smask = (np.arange(100) < 90).astype(np.float32)
        tmask = (np.arange(100) < 70).astype(np.float32)
        perm = rng.permutation(100)
        src, tgt = src_p[perm], tgt_p
        masks = (smask[perm], tmask)
    return src, tgt, nrm, kw, masks


@pytest.mark.parametrize("case", ["pt2pt", "pt2pl", "update_sigma2",
                                  "masked", "2d"])
def test_run_em_rigid_matches_reference(case):
    src, tgt, nrm, kw, masks = _loop_args(case)
    dim = src.shape[1]
    rot0 = np.eye(dim, dtype=np.float32)
    t0 = np.zeros(dim, np.float32)
    jm = {} if masks is None else dict(smask=jnp.asarray(masks[0]),
                                       tmask=jnp.asarray(masks[1]))
    pm = {} if masks is None else dict(smask=_t(masks[0]),
                                       tmask=_t(masks[1]))
    jn = None if nrm is None else jnp.asarray(nrm)
    ref = jf._run_em_rigid(jnp.asarray(src), jnp.asarray(tgt), jn, rot0, t0,
                           np.float32(0.0), auto_sigma2=True, **kw, **jm)
    out = pf._run_em_rigid(_t(src), _t(tgt), None if nrm is None else _t(nrm),
                           _t(rot0), _t(t0), 0.0, auto_sigma2=True, **kw,
                           **pm)
    _same_tf(out, ref, 1e-4)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=1e-4)
    if masks is not None:  # padding carries no mass: the unpadded pair
        keep_s, keep_t = masks[0] > 0, masks[1] > 0
        bare = pf._run_em_rigid(_t(src[keep_s]), _t(tgt[keep_t]), None,
                                _t(rot0), _t(t0), 0.0, auto_sigma2=True,
                                **kw)
        _same_tf(out, bare, 1e-5)


def _fused_ref(src, tgt, nrm, **kw):
    return jem.run_em_filterreg_fused(src, tgt, nrm, interpret=True, **kw)


@pytest.mark.parametrize("objective,update_sigma2,w", [
    ("pt2pt", False, 0.0), ("pt2pt", True, 0.1), ("pt2pl", False, 0.0),
    ("pt2pl", True, 0.05)])
def test_fused_plain_matches_reference_kernel(objective, update_sigma2, w):
    if objective == "pt2pl":
        src, tgt, nrm = _patch(grid=13, m=160)
    else:
        src, tgt = _clouds(m=160, n=140, seed=8)
        cen = np.concatenate([src, tgt]).mean(0)
        src, tgt, nrm = src - cen, tgt - cen, None
    kw = dict(w=w, maxiter=20, tol=0.0, update_sigma2=update_sigma2,
              sigma2_decay=0.9, min_sigma2=1e-4, auto_sigma2=True,
              objective=objective)
    rot_r, t_r, s2_r, q_r = _fused_ref(src, tgt, nrm, **kw)
    rot, t, s2, q = pfc.run_em_filterreg_fused(
        _t(src), _t(tgt), None if nrm is None else _t(nrm), **kw)
    np.testing.assert_allclose(_np(rot), _np(rot_r), atol=2e-4)
    np.testing.assert_allclose(_np(t), _np(t_r), atol=2e-4)
    np.testing.assert_allclose(float(s2), float(s2_r), rtol=2e-4)
    # q of a converged pt2pl pair is a sum of squared f32 residuals
    # (~1e-8): noise, hence the absolute floor.
    np.testing.assert_allclose(float(q), float(q_r), rtol=1e-3, atol=1e-6)
    assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
    # ... and on transforms, the port's own dense loop.
    dense = pf._run_em_rigid(
        _t(src), _t(tgt), None if nrm is None else _t(nrm), torch.eye(3),
        torch.zeros(3), 0.0, objective_type=objective,
        update_sigma2=update_sigma2, w=w, maxiter=20, tol=0.0,
        min_sigma2=1e-4, sigma2_decay=0.9, auto_sigma2=True)
    np.testing.assert_allclose(_np(rot), _np(dense.transformation.rot),
                               atol=5e-4)
    np.testing.assert_allclose(_np(t), _np(dense.transformation.t), atol=5e-4)


def test_fused_masked_pair_is_the_unpadded_pair():
    src, tgt, nrm = _patch()
    cap = 112
    rng = np.random.default_rng(9)
    rows, cols = rng.permutation(cap)[:64], rng.permutation(cap)[:100]
    src_p, tgt_p, nrm_p = (np.zeros((cap, 3), np.float32) for _ in range(3))
    smask, tmask = np.zeros(cap, np.float32), np.zeros(cap, np.float32)
    src_p[rows], smask[rows] = src, 1.0
    tgt_p[cols], nrm_p[cols], tmask[cols] = tgt, nrm, 1.0
    kw = dict(objective="pt2pl", maxiter=15, tol=0.0, update_sigma2=True,
              w=0.05)
    out = pfc.run_em_filterreg_fused(_t(src_p), _t(tgt_p), _t(nrm_p),
                                     _t(smask), _t(tmask), **kw)
    bare = pfc.run_em_filterreg_fused(_t(src), _t(tgt), _t(nrm), **kw)
    for a, b in zip(out, bare):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    # ... and the reference's masked kernel agrees.
    ref = _fused_ref(src_p, tgt_p, nrm_p, smask=smask, tmask=tmask,
                     maxiter=15, tol=0.0, update_sigma2=True, w=0.05,
                     objective="pt2pl")
    np.testing.assert_allclose(_np(out[0]), _np(ref[0]), atol=2e-4)


def test_fused_wrapper_gate_and_checks():
    assert pfc.fused_dims_ok(1024, 1024) and pfc.fused_dims_ok(2803, 2803)
    assert not pfc.fused_dims_ok(4000, 1024)      # 48 B per source point
    assert not pfc.fused_dims_ok(16, 7100)        # 32 B per target point
    pts = torch.zeros((1, 10, 3))
    with pytest.raises(ValueError, match="pt2pl requires"):
        pfc.run_em_filterreg_fused_batch(pts, pts, objective="pt2pl")
    with pytest.raises(ValueError, match="objective"):
        pfc.run_em_filterreg_fused_batch(pts, pts, objective="pt2plane")
    with pytest.raises(ValueError, match="shared memory"):
        pfc.run_em_filterreg_fused_batch(torch.zeros((1, 5000, 3)), pts)
    with pytest.raises(ValueError, match="normals"):
        pfc.run_em_filterreg_fused_batch(pts, pts, torch.zeros((1, 9, 3)),
                                         objective="pt2pl")
    # maxiter = 0: the start, with sigma2_0 and no iteration.
    src, tgt = _clouds(m=30)
    rot, t, s2, q, it = pfc.run_em_filterreg_fused_batch(
        _t(src)[None], _t(tgt)[None], maxiter=0)
    assert torch.equal(rot[0], torch.eye(3)) and int(it[0]) == 0
    ref = max(float(jf.mu.squared_kernel_sum(src, tgt)), 1e-4)
    np.testing.assert_allclose(float(s2[0]), ref, rtol=1e-5)


def test_streaming_loop_matches_reference(monkeypatch):
    """Above transposed_em_max_pairs both packages stream; with the port's
    culled_estep_min_pairs lowered each of its E-steps is one call of the
    culled Gauss transform (here its plain version), after one Morton
    sort."""
    monkeypatch.setattr(jcfg.config, "transposed_em_max_pairs", 1000)
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 1000)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1000)
    calls = []
    orig = pgc.gauss_transform_culled_plain
    monkeypatch.setattr(pgc, "gauss_transform_culled_plain",
                        lambda *a: calls.append(a[4].float().mean())
                        or orig(*a))
    for objective in ("pt2pt", "pt2pl"):
        if objective == "pt2pl":
            src, tgt, nrm = _patch()
            kw = dict(target_normals=nrm, objective_type="pt2pl",
                      update_sigma2=True, w=0.05)
        else:
            src, tgt = _clouds(m=120, n=100, seed=10)
            kw = dict(sigma2_decay=0.85)
        calls.clear()
        ref = jf.registration_filterreg(src, tgt, maxiter=10, tol=0.0, **kw)
        out = pf.registration_filterreg(src, tgt, maxiter=10, tol=0.0,
                                        device="cpu", **kw)
        assert len(calls) == 10
        _same_tf(out, ref, 1e-4)
        np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                                   rtol=1e-4)


# --------------------------------------------------------------------------
# Dispatch, batches, the host loop and what is not ported
# --------------------------------------------------------------------------

def _spy(monkeypatch):
    taken = []
    for name, mod, fn in [("fused", pfc, "run_em_filterreg_fused_batch"),
                          ("dense", pf, "_run_em_rigid"),
                          ("stream", pf, "_run_em_rigid_streaming")]:
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=name, **k:
                            taken.append(_n) or _o(*a, **k))
    return taken


@pytest.mark.parametrize("case,branch", [
    ("default", "fused"), ("pt2pl", "fused"), ("sigma2", "fused"),
    ("identity_init", "fused"), ("tf_init_params", "dense"),
    ("use_pallas_false", "dense"), ("use_fused_em_false", "dense"),
    ("max_pairs", "dense"), ("dims", "dense"), ("dim2", "dense"),
    ("large", "stream"), ("callbacks", None)])
def test_registration_takes_the_reference_branch(monkeypatch, case, branch):
    taken = _spy(monkeypatch)
    src, tgt, nrm = _patch()
    kw = dict(maxiter=3, device="cpu")
    if case == "pt2pl":
        kw.update(target_normals=nrm, objective_type="pt2pl")
    elif case == "sigma2":
        kw["sigma2"] = 0.01
    elif case == "identity_init":
        kw["tf_init_params"] = {"rot": np.eye(3), "t": np.zeros(3)}
    elif case == "tf_init_params":
        kw["tf_init_params"] = {"t": np.float32([0.01, 0.0, 0.0])}
    elif case == "use_pallas_false":
        kw["use_pallas"] = False
    elif case == "use_fused_em_false":
        monkeypatch.setattr(pcfg.config, "use_fused_em", False)
    elif case == "max_pairs":
        monkeypatch.setattr(pcfg.config, "fused_em_max_pairs", 64 * 100 - 1)
    elif case == "dims":
        monkeypatch.setattr(pfc, "fused_dims_ok", lambda m, n: False)
    elif case == "dim2":
        src, tgt = src[:, :2].copy(), tgt[:, :2].copy()
    elif case == "large":
        monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs",
                            64 * 100 - 1)
    elif case == "callbacks":
        seen = []
        kw["callbacks"] = [seen.append]
    res = pf.registration_filterreg(src, tgt, **kw)
    assert bool(torch.isfinite(res.transformation.rot).all())
    assert taken == ([] if branch is None else [branch])
    if case == "callbacks":
        assert len(seen) == 3


def test_callbacks_host_loop_matches_reference():
    src, tgt = _clouds(m=80, n=70, seed=11)
    seen_j, seen_p = [], []
    kw = dict(maxiter=6, tol=0.0, sigma2_decay=0.9, w=0.05)
    ref = jf.registration_filterreg(src, tgt, callbacks=[seen_j.append], **kw)
    out = pf.registration_filterreg(src, tgt, callbacks=[seen_p.append],
                                    device="cpu", **kw)
    assert len(seen_p) == len(seen_j) == 6
    _same_tf(out, ref, 1e-5)
    np.testing.assert_allclose(_np(seen_p[2].rot), _np(seen_j[2].rot),
                               atol=1e-5)


@pytest.mark.parametrize("objective", ["pt2pt", "pt2pl"])
@pytest.mark.parametrize("ragged", [False, True])
def test_batch_matches_single_pairs_and_reference(monkeypatch, objective,
                                                  ragged):
    """One call of the whole-EM batch runner (on the CPU its plain version)
    for the whole batch; every pair equals its single-pair registration,
    and the reference's batch (its dense loop: transforms to 5e-4). With
    the whole-EM kernel off, the port's dense batch loop equals the
    reference's to 1e-4."""
    calls = []
    orig = pfc.run_em_filterreg_fused_batch
    monkeypatch.setattr(pfc, "run_em_filterreg_fused_batch",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    src, tgt, nrm = _patch()
    sizes = [(64, 100), (50, 80), (40, 100)] if ragged else [(64, 100)] * 3
    rng = np.random.default_rng(12)
    srcs, tgts, nrms = [], [], []
    for i, (m, n) in enumerate(sizes):
        cols = np.sort(rng.permutation(100)[:n])
        srcs.append(src[:m] + 0.01 * i)
        tgts.append(tgt[cols])
        nrms.append(nrm[cols])
    if not ragged:
        srcs, tgts, nrms = np.stack(srcs), np.stack(tgts), np.stack(nrms)
    kw = dict(objective_type=objective, maxiter=15, tol=0.0,
              sigma2_decay=0.9, w=0.05,
              target_normals=nrms if objective == "pt2pl" else None)
    out = pf.registration_filterreg_batch(srcs, tgts, device="cpu", **kw)
    assert calls == [1]
    ref = jf.registration_filterreg_batch(srcs, tgts, **kw)
    for b in range(3):
        nb = kw["target_normals"][b] if objective == "pt2pl" else None
        one = pf.registration_filterreg(
            srcs[b], tgts[b], device="cpu", objective_type=objective,
            target_normals=nb, maxiter=15, tol=0.0, sigma2_decay=0.9, w=0.05)
        _same_tf(out[b], one, 1e-6)
        np.testing.assert_allclose(float(out[b].sigma2), float(one.sigma2),
                                   rtol=1e-6)
        _same_tf(out[b], ref[b], 5e-4)
    calls.clear()
    monkeypatch.setattr(pcfg.config, "use_fused_em", False)
    dense = pf.registration_filterreg_batch(srcs, tgts, device="cpu", **kw)
    assert calls == []
    for b in range(3):
        _same_tf(dense[b], ref[b], 1e-4)


def test_unported_paths_raise(monkeypatch):
    """The paths that once raised (the lattice E-step, the deformable
    model, a feature_fn) run; the search keeps the reference's refusals.
    (tests/test_torch_lattice.py, test_torch_deformable.py and
    test_torch_fpfh.py hold them to the reference.)"""
    src, tgt = _clouds(m=40)
    res = pf.registration_filterreg(src, tgt, estep_method="lattice",
                                    maxiter=3, device="cpu")
    assert torch.isfinite(res.transformation.rot).all()
    weights = ptf.DeformableKinematicModel.SkinningWeight(
        np.tile([[0, 1]], (len(src), 1)),
        np.full((len(src), 2), 0.5, np.float32))
    res = pf.DeformableKinematicFilterReg(src, weights, 0.01,
                                          device="cpu").registration(
        tgt, maxiter=3)
    assert res.transformation.dualquats.shape == (2, 8)
    res = pf.registration_filterreg(src, tgt, feature_fn=lambda x: x * 2.0,
                                    maxiter=3, device="cpu")
    assert torch.isfinite(res.transformation.rot).all()
    # Chunked callbacks and n_starts run (tests/test_torch_callbacks.py,
    # test_torch_multistart.py); the search keeps the reference's refusals.
    seen = []
    pf.registration_filterreg(src, tgt, callbacks=[seen.append], maxiter=5,
                              tol=0.0, callback_chunk=4, device="cpu")
    assert len(seen) == 5
    with pytest.raises(ValueError, match="no-callback"):
        pf.registration_filterreg(src, tgt, n_starts=4, callbacks=[print],
                                  device="cpu")
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 16)
    with pytest.raises(ValueError, match="transposed_em_max_pairs"):
        pf.registration_filterreg(src, tgt, n_starts=4, device="cpu")
    with pytest.raises(ValueError, match="pt2pl requires"):
        pf.registration_filterreg(src, tgt, objective_type="pt2pl",
                                  device="cpu")
    with pytest.raises(ValueError, match="Unknown objective"):
        pf.registration_filterreg_batch(src[None], tgt[None],
                                        objective_type="plane", device="cpu")


def test_as_normals_and_set_source():
    assert interop.as_normals(None) is None
    nrm = np.ones((5, 3))
    out = interop.as_normals(nrm, device="cpu")
    assert out.dtype == torch.float32 and out.shape == (5, 3)
    reg = pf.RigidFilterReg(device="cpu")
    reg.set_source(np.zeros((10, 2), np.float32))
    assert reg._tf_result.rot.shape == (2, 2)

"""Multistart (``n_starts > 1``) of the port held to the JAX package: the
orientation grid, the quaternion helpers, K1's and K5's plain versions
with a start pose, the searches of CPD, FilterReg, GMMTree and BCPD
(single pairs, fixed and ragged batches), their refusals and the
pyramids' coarsest-level-only rule.

Both packages take the same seeded numpy clouds on the CPU; the port runs
its kernels' plain versions, the JAX package its XLA twins, jitted. The
winning start must be the reference's wherever the best and runner-up
scores part by more than 1e-3 relative, in the reference's scores and in
the port's (two starts that settle on one pose in one package tie there,
and either is its winner); each winner's transform
is held to the tolerance the family's single-start parity tests state:
* CPD dense route (``_run_em_t``) 1e-5 (tests/test_torch_cpd.py), K1's
  plain version 2e-4 (tests/test_torch_em.py: Horn in double against the
  reference's f32 SVD, amplified by the EM);
* FilterReg dense route 1e-4, K5's plain version 5e-4
  (tests/test_torch_filterreg.py);
* GMMTree on carried trees 5e-4: its single-start tests hold 2e-5 on
  samples whose descent meets no near-tie, and the port's descent (d2
  from differences) and the reference's (the expanded form) part by up
  to ~1e-3 on samples with one; these 170-degree searches
  measured 1e-7 to 4e-4 against the reference's run of the same start;
* BCPD 1e-4 on the rigid part and the moved source
  (tests/test_torch_bcpd.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from probreg_tpu import bcpd as jb  # noqa: E402
from probreg_tpu import cost_functions as jcf  # noqa: E402
from probreg_tpu import cpd as jcpd  # noqa: E402
from probreg_tpu import filterreg as jf  # noqa: E402
from probreg_tpu import gmmtree as jgt  # noqa: E402
from probreg_tpu.utils import math_utils as jmu  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import bcpd as pb  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cost_functions as pcf  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch import filterreg as pf  # noqa: E402
from probreg_tpu_torch import gmmtree as pgt  # noqa: E402
from probreg_tpu_torch import pyramid as ppy  # noqa: E402
from probreg_tpu_torch.ops import em_cuda as pem  # noqa: E402
from probreg_tpu_torch.ops import frg_cuda as pfc  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import io as pio  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = dict(device="cpu")
GAP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the plain versions run many tiny products that
    spin on oversubscribed cores under the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rot(deg):
    return np.asarray(jso.euler2mat(*np.deg2rad(deg)), np.float32)


def _horse(n, seed):
    pts = pio.read_point_cloud(os.path.join(DATA, "horse.ply"))
    rng = np.random.default_rng(seed)
    return pts[rng.choice(len(pts), n, replace=False)].astype(np.float32)


def _pair(n=160, m=None, deg=(0.0, 0.0, 170.0), seed=0, noise=0.005):
    """A horse subset and a second subset moved by ``deg`` (170 degrees
    about z: the identity start lands in another basin)."""
    rng = np.random.default_rng(seed)
    src = _horse(n, seed)
    tgt = (_horse(m or n, seed + 50) @ _rot(deg).T + 0.02
           + rng.normal(0, noise, (m or n, 3))).astype(np.float32)
    return src, tgt


def _surface(n=120, deg=(0.0, 0.0, 170.0), seed=0):
    """A wavy, asymmetric height field with its analytic normals, and a
    rotated copy: the pt2pl pair."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    x, y = xy[:, 0], xy[:, 1]
    z = 0.1 * np.sin(3 * x) + 0.05 * np.cos(2 * y) + 0.08 * x * y + 0.03 * x
    dzdx = 0.3 * np.cos(3 * x) + 0.08 * y + 0.03
    dzdy = -0.1 * np.sin(2 * y) + 0.08 * x
    pts = np.stack([x, y, z], 1)
    nrm = np.stack([-dzdx, -dzdy, np.ones_like(x)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rot = _rot(deg)
    return (pts.astype(np.float32), (pts @ rot.T + 0.02).astype(np.float32),
            (nrm @ rot.T).astype(np.float32))


def _parted(scores):
    """Whether the best and runner-up of ``scores`` part by > GAP."""
    order = np.sort(np.where(np.isnan(scores), np.inf, scores))
    return len(order) > 1 and np.isfinite(order[1]) \
        and order[1] - order[0] > GAP * abs(order[0])


def _check_index(ref_scores, got_scores, got_best):
    """The reference's winner (jnp.argmin: the first of its minima, the
    first NaN) wherever the best and runner-up part by > GAP in both
    packages' scores: where two starts settle on one pose in one package
    they tie there, and either is its winner."""
    ref_scores = np.atleast_2d(np.asarray(ref_scores, np.float64))
    got_scores = np.atleast_2d(np.asarray(got_scores, np.float64))
    for b, (want, got) in enumerate(zip(ref_scores, got_scores)):
        if _parted(want) and _parted(got):
            assert int(got_best[b]) == int(jnp.argmin(want)), (b, want, got)


# --------------------------------------------------------------------------
# The grid, the quaternion helpers and the tie rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,dim", [(s, 3) for s in range(1, 11)]
                         + [(3, 2), (8, 2)])
def test_grid_matches_reference_bit_for_bit(n, dim):
    got = pcf.RigidCostFunction.initial_multistart_rots(n, dim)
    want = jcf.RigidCostFunction.initial_multistart_rots(n, dim)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_grid_refuses_more_than_ten_starts_and_quaternions_match():
    with pytest.raises(ValueError, match="n_starts <= 10"):
        pcf.RigidCostFunction.initial_multistart(11)
    rng = np.random.default_rng(3)
    for q in [rng.normal(size=4) for _ in range(5)] + [np.r_[1.0, 0, 0, 0]]:
        assert np.array_equal(pso.quat2mat_np(q), jso.quat2mat_np(q))
        np.testing.assert_allclose(_np(pso.quat2mat(_t(q))),
                                   np.asarray(jso.quat2mat(jnp.float32(q))),
                                   atol=1e-6)
    for deg in ([10.0, -20.0, 30.0], [0.0, 0.0, 179.0], [170.0, 5.0, -3.0],
                [0.0, 90.0, 0.0]):
        r = _rot(deg)
        got, want = _np(pso.mat2quat(_t(r))), np.asarray(jso.mat2quat(r))
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(_np(pso.quat2mat(_t(got))), r, atol=1e-5)


def test_selection_ties_and_nan_follow_jnp_argmin():
    for scores in ([0.5, 0.2, 0.2], [1.0, np.nan, 0.0], [np.nan, np.nan, 1.0],
                   [3.0, 2.0, 1.0]):
        arr = np.float32(scores)
        assert int(pcpd.first_min(_t(arr))) == int(jnp.argmin(arr))
    batch = np.float32([[0.5, 0.2, 0.2], [1.0, np.nan, 0.0]])
    assert _np(pcpd.first_min(_t(batch))).tolist() == [1, 1]


# --------------------------------------------------------------------------
# K1 and K5 plain versions with a start pose
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sigma2_0", [0.0, 0.05])
def test_k1_plain_start_row_matches_run_em_t(sigma2_0):
    src, tgt = _pair(120, deg=(0.0, 0.0, 40.0))
    lin0, t0, s0 = _rot([20.0, 0.0, 30.0]), np.float32([0.05, -0.1, 0.0]), 1.1
    row = pem.init_rows(_t(lin0)[None], _t(t0)[None], s0, sigma2_0)
    out = pem.run_em_cpd_fused_plain(_t(src)[None], _t(tgt)[None], None, row,
                                     affine=False, w=0.0, maxiter=8, tol=0.0,
                                     update_scale=True)[0]
    init = np.concatenate([lin0.ravel(), t0, [s0]]).astype(np.float32)
    lin, t, scale, s2, _ = jcpd._run_em_t(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init), kind="rigid",
        w=0.0, maxiter=8, tol=0.0, update_scale=True, default_init=False,
        sigma2_init=sigma2_0 or None)
    np.testing.assert_allclose(_np(out[:9]).reshape(3, 3),
                               np.asarray(lin) * float(scale), atol=2e-4)
    np.testing.assert_allclose(_np(out[9:12]), np.asarray(t), atol=2e-4)
    np.testing.assert_allclose(float(out[12]), float(s2), rtol=1e-3)
    # An identity row with sigma2_0 = 0 is the identity start, bit for bit.
    eye = pem.init_rows(torch.eye(3)[None], torch.zeros(1, 3))
    kw = dict(affine=False, w=0.0, maxiter=8, tol=0.0, update_scale=True)
    assert torch.equal(
        pem.run_em_cpd_fused_plain(_t(src)[None], _t(tgt)[None], None, eye,
                                   **kw),
        pem.run_em_cpd_fused_plain(_t(src)[None], _t(tgt)[None], None, **kw))


@pytest.mark.parametrize("objective", ["pt2pt", "pt2pl"])
def test_k5_plain_start_row_matches_run_em_rigid(objective):
    src, tgt = _pair(120, deg=(0.0, 0.0, 30.0))
    nrm = None
    if objective == "pt2pl":
        nrm = np.tile(np.float32([[0.0, 0.0, 1.0]]), (len(tgt), 1))
    rot0, t0 = _rot([0.0, 10.0, 25.0]), np.float32([0.02, 0.0, -0.03])
    kw = dict(w=0.0, maxiter=8, tol=0.0, update_sigma2=True,
              sigma2_decay=1.0, min_sigma2=1e-4, auto_sigma2=True)
    row = torch.cat([_t(rot0).reshape(1, 9), _t(t0)[None]], 1)
    nt = None if nrm is None else _t(nrm)[None]
    out = pfc.run_em_filterreg_fused_plain(
        _t(src)[None], _t(tgt)[None], nt, None, row, pt2pl=nrm is not None,
        sigma2_0=0.0, **kw)[0]
    ref = jf._run_em_rigid(
        jnp.asarray(src), jnp.asarray(tgt),
        None if nrm is None else jnp.asarray(nrm), jnp.asarray(rot0),
        jnp.asarray(t0), jnp.float32(0.0), objective_type=objective, **kw)
    np.testing.assert_allclose(_np(out[:9]).reshape(3, 3),
                               np.asarray(ref.transformation.rot), atol=5e-4)
    np.testing.assert_allclose(_np(out[9:12]),
                               np.asarray(ref.transformation.t), atol=5e-4)
    eye = torch.cat([torch.eye(3).reshape(1, 9), torch.zeros(1, 3)], 1)
    plain = dict(pt2pl=nrm is not None, sigma2_0=0.0, **kw)
    assert torch.equal(
        pfc.run_em_filterreg_fused_plain(_t(src)[None], _t(tgt)[None], nt,
                                         None, eye, **plain),
        pfc.run_em_filterreg_fused_plain(_t(src)[None], _t(tgt)[None], nt,
                                         None, **plain))


# --------------------------------------------------------------------------
# CPD
# --------------------------------------------------------------------------

CPD_KW = dict(w=0.0, maxiter=40, tol=1e-4, update_scale=True)


def _cpd_ref_scores(srcs, tgts, inits, smasks=None, tmasks=None):
    """The reference's per-start final sigma2 (B, S): the body of
    cpd._run_em_t_multistart without its selection."""
    def pair(src, tgt, sm, tm):
        if sm is None:
            cen = (src.sum(0) + tgt.sum(0)) / (src.shape[0] + tgt.shape[0])
        else:
            cen = (sm @ src + tm @ tgt) / jnp.maximum(sm.sum() + tm.sum(), 1.)

        def run(x0):
            lin0 = x0[:9].reshape(3, 3)
            x0 = jnp.concatenate([x0[:9], cen - x0[12] * lin0 @ cen,
                                  x0[12:]])
            return jcpd._run_em_t(src, tgt, x0, kind="rigid",
                                  default_init=False, smask=sm, tmask=tm,
                                  **CPD_KW)[3]
        return jax.vmap(run)(inits)

    if smasks is None:
        return jax.jit(jax.vmap(lambda s, t: pair(s, t, None, None)))(
            srcs, tgts)
    return jax.jit(jax.vmap(pair))(srcs, tgts, smasks, tmasks)


@pytest.mark.parametrize("form", ["single", "batch", "ragged"])
@pytest.mark.parametrize("fused", [False, True])
def test_cpd_multistart_matches_reference(form, fused):
    """``fused`` is K1's route (its plain version here), else the dense
    loop per start."""
    n_starts = 10 if form == "single" else 4
    inits = pcpd._multistart_inits(n_starts, 3)
    ji = jnp.asarray(inits)
    if form == "single":
        pairs = [_pair(150)]
    else:
        pairs = [_pair(120, 100 if form == "ragged" else None,
                       deg=(0.0, 0.0, d), seed=s)
                 for s, d in ((1, 170.0), (2, -100.0))]
    if form == "ragged":
        srcs, smasks = interop.pad_ragged([p[0] for p in pairs], **CPU)
        tgts, tmasks = interop.pad_ragged([p[1] for p in pairs], **CPU)
        jargs = [jnp.asarray(_np(x)) for x in (srcs, tgts, smasks, tmasks)]
        ref = jcpd._run_em_t_multistart_ragged_batch(
            *jargs[:2], jargs[2], jargs[3], ji, **CPD_KW)
        scores = _cpd_ref_scores(*jargs[:2], ji, jargs[2], jargs[3])
    else:
        srcs = torch.stack([_t(p[0]) for p in pairs])
        tgts = torch.stack([_t(p[1]) for p in pairs])
        smasks = tmasks = None
        jargs = [jnp.asarray(_np(x)) for x in (srcs, tgts)]
        ref = jcpd._run_em_t_multistart_batch(*jargs, ji, **CPD_KW)
        scores = _cpd_ref_scores(*jargs, ji)
    (lin, t, scale, s2, _), best, got = pcpd._run_em_t_multistart_batch(
        srcs, tgts, inits, smasks=smasks, tmasks=tmasks, fused=fused,
        **CPD_KW)
    _check_index(scores, got, best)
    atol = 2e-4 if fused else 1e-5
    np.testing.assert_allclose(_np(lin), np.asarray(ref[0]), atol=atol)
    np.testing.assert_allclose(_np(t), np.asarray(ref[1]), atol=atol)
    np.testing.assert_allclose(_np(s2), np.asarray(ref[3]), rtol=1e-3,
                               atol=1e-7)


def test_cpd_entry_points_search_and_compose_with_sigma2_init(monkeypatch):
    """registration_cpd / RigidCPD and registration_cpd_batch take the
    search; sigma2_init anneals every start (reference cpd.py:944); the
    K1 route is the one the gate picks, the dense loop past it."""
    src, tgt = _pair(150)
    got = pcpd.registration_cpd(src, tgt, n_starts=10, sigma2_init=0.05,
                                **CPU)
    want = jcpd.registration_cpd(src, tgt, n_starts=10, sigma2_init=0.05)
    np.testing.assert_allclose(_np(got.transformation.rot),
                               np.asarray(want.transformation.rot), atol=2e-4)
    # Two subsets of the horse: the right basin, to their sampling.
    assert pso.rotation_angle(got.transformation.rot,
                              _t(_rot([0.0, 0.0, 170.0]))) < 0.1
    routes = []
    orig = pcpd._run_em_t_multistart_all
    monkeypatch.setattr(pcpd, "_run_em_t_multistart_all",
                        lambda *a, **k: routes.append(k["fused"])
                        or orig(*a, **k))
    out = pcpd.registration_cpd_batch([src, src[:100]], [tgt, tgt[:90]],
                                      n_starts=2, maxiter=5, **CPU)
    assert len(out) == 2 and routes == [True]
    pcpd.registration_cpd(src[:, :2], tgt[:, :2], n_starts=3, maxiter=5,
                          **CPU)
    assert routes == [True, False]   # 2-D: the dense loop


def test_refusals_mirror_the_reference(monkeypatch):
    src, tgt = _pair(60)
    refused = [
        (r"mutually exclusive", lambda: pcpd.registration_cpd(
            src, tgt, n_starts=4, tf_init_params={"rot": np.eye(3)}, **CPU)),
        ("no-callback", lambda: pcpd.registration_cpd(
            src, tgt, n_starts=2, callbacks=[print], **CPU)),
        ("rigid batches only", lambda: pcpd.registration_cpd_batch(
            src[None], tgt[None], "affine", n_starts=2, **CPU)),
        ("no-callback", lambda: pf.registration_filterreg(
            src, tgt, n_starts=2, callbacks=[print], **CPU)),
        ("pt2pl requires", lambda: pf.registration_filterreg(
            src, tgt, n_starts=2, objective_type="pt2pl", **CPU)),
        ("no callbacks", lambda: pgt.registration_gmmtree(
            src, tgt, n_starts=2, callbacks=[print], **CPU)),
        ("normalized no-callback", lambda: pb.registration_bcpd(
            src, tgt, n_starts=2, normalize=False, **CPU)),
        ("warm", lambda: pb.registration_bcpd(
            src, tgt, n_starts=2, tf_init_params={"rot": np.eye(3)}, **CPU)),
        ("3-D clouds only", lambda: pb.registration_bcpd(
            src[:, :2], tgt[:, :2], n_starts=2, **CPU)),
        ("rigid pyramid only", lambda: ppy.registration_cpd_pyramid(
            src, tgt, "affine", n_starts=2, **CPU)),
        ("incompatible", lambda: ppy.registration_filterreg_pyramid(
            src, tgt, n_starts=2, callbacks=[print], **CPU)),
        ("incompatible", lambda: ppy.registration_gmmtree_pyramid(
            src, tgt, n_starts=2, dispatch_chunk=5, **CPU)),
        ("managed by the pyramid", lambda: ppy.registration_cpd_pyramid(
            src, tgt, n_starts=2, tf_init_params={"rot": np.eye(3)},
            **CPU)),
    ]
    for match, call in refused:
        with pytest.raises(ValueError, match=match):
            call()
    # The dense search past the dense loop's size points at the pyramid.
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 100)
    with pytest.raises(ValueError, match="registration_cpd_pyramid"):
        pcpd.registration_cpd(src, tgt, n_starts=4, **CPU)
    with pytest.raises(ValueError, match="filterreg_pyramid"):
        pf.registration_filterreg(src, tgt, n_starts=4, **CPU)


# --------------------------------------------------------------------------
# FilterReg
# --------------------------------------------------------------------------

def _frg_ref_scores(src, tgt, nrm, rots0, **kw):
    """The reference's per-start (sigma2, q) (S,) of one pair: the body of
    filterreg._run_em_rigid_multistart without its selection."""
    cen = (src.sum(0) + tgt.sum(0)) / (src.shape[0] + tgt.shape[0])

    def run(rot0):
        res = jf._run_em_rigid(src, tgt, nrm, rot0, cen - rot0 @ cen,
                               jnp.float32(0.0), **kw)
        return res.sigma2, res.q
    return jax.jit(jax.vmap(run))(rots0)


@pytest.mark.parametrize("objective,update_sigma2", [("pt2pt", False),
                                                     ("pt2pl", True)])
@pytest.mark.parametrize("fused", [False, True])
def test_filterreg_multistart_matches_reference(objective, update_sigma2,
                                                fused):
    if objective == "pt2pl":
        src, tgt, nrm = _surface()
    else:
        src, tgt = _pair(110)
        nrm = None
    rots0 = pf._multistart_rots(6, 3)
    kw = dict(objective_type=objective, update_sigma2=update_sigma2, w=0.0,
              maxiter=30, tol=1e-4, min_sigma2=1e-4, sigma2_decay=0.9,
              auto_sigma2=True)
    jn = None if nrm is None else jnp.asarray(nrm)
    ref = jf._run_em_rigid_multistart_jit(
        jnp.asarray(src), jnp.asarray(tgt), jn, jnp.asarray(rots0),
        np.float32(0.0), **kw)
    s2s, qs = _frg_ref_scores(jnp.asarray(src), jnp.asarray(tgt), jn,
                              jnp.asarray(rots0), **kw)
    (rot, t, s2, q), best, got = pf._run_em_rigid_multistart_batch(
        _t(src)[None], _t(tgt)[None], None if nrm is None else _t(nrm)[None],
        rots0, 0.0, fused=fused, **kw)
    _check_index(s2s if update_sigma2 else qs, got, best)
    atol = 5e-4 if fused else 1e-4
    np.testing.assert_allclose(_np(rot[0]), np.asarray(ref.transformation.rot),
                               atol=atol)
    np.testing.assert_allclose(_np(t[0]), np.asarray(ref.transformation.t),
                               atol=atol)


@pytest.mark.parametrize("ragged", [False, True])
def test_filterreg_batch_multistart_matches_reference(ragged):
    pairs = [_pair(100, 90 if ragged else None, deg=(0.0, 0.0, d), seed=s)
             for s, d in ((3, 170.0), (4, 95.0))]
    kw = dict(sigma2_decay=0.9, maxiter=30, tol=1e-4, n_starts=4)
    if ragged:
        srcs, tgts = [p[0] for p in pairs], [p[1] for p in pairs]
    else:
        srcs = np.stack([p[0] for p in pairs])
        tgts = np.stack([p[1] for p in pairs])
    got = pf.registration_filterreg_batch(srcs, tgts, **kw, **CPU)
    want = jf.registration_filterreg_batch(srcs, tgts, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.transformation.rot),
                                   np.asarray(w.transformation.rot),
                                   atol=5e-4)
        np.testing.assert_allclose(_np(g.transformation.t),
                                   np.asarray(w.transformation.t), atol=5e-4)


# --------------------------------------------------------------------------
# GMMTree
# --------------------------------------------------------------------------

def _gmm_ref_starts(tgt, pi, mu, cov, rots0, tmask=None, **kw):
    """The reference's per-start (rot, t, rescore), each (S, ...), of one
    pair: the body of gmmtree._run_registration_multistart without its
    selection."""
    n = tgt.shape[0]
    cen = jgt._tree_centroid(tgt, mu, tmask)
    mu_c = mu - cen[None, :]
    xs_t0 = tgt.T - cen[:, None]
    estep = jgt._estep_t_factory(pi, mu_c, cov, kw["max_level"],
                                 kw["lambda_c"])
    col = tmask[None, :] if tmask is not None else jnp.ones((1, n))

    def run(rot0):
        rot, t, _ = jgt._run_registration(tgt, pi, mu, cov, rot0,
                                          cen - rot0 @ cen, tmask=tmask,
                                          **kw)
        m0, m1 = estep(rot @ xs_t0 + (t + rot @ cen - cen)[:, None], col)
        d2 = jnp.sum((m1 / jnp.maximum(m0, 1e-15)[:, None] - mu_c) ** 2, 1)
        mass = jnp.sum(m0)
        n_eff = jnp.sum(tmask) if tmask is not None else n
        score = jnp.where(mass > 1e-3 * n_eff,
                          jnp.sum(m0 * d2) / jnp.maximum(mass, 1e-15),
                          jnp.inf)
        return rot, t, jnp.where(jnp.isnan(score), jnp.inf, score)
    return jax.jit(jax.vmap(run))(rots0)


@pytest.mark.parametrize("form", ["single", "batch", "ragged"])
def test_gmmtree_multistart_matches_reference_on_carried_trees(form):
    """Trees of the reference carried to the port; the search on K10's
    plain version (the route of CPU tensors) against the reference's
    vmapped twin loop."""
    # Targets are rotated copies of the sources: on other samples a point
    # near a tie of the descent flips and the runs part by ~1e-3.
    # Rotations near the grid's starts, so that the winners settle.
    cases = [(200, 200, (0.0, 0.0, 170.0), 5)] if form == "single" else [
        (150, 130 if form == "ragged" else 150, d, s)
        for s, d in ((5, (0.0, 0.0, 170.0)), (6, (172.0, 0.0, 8.0)))]
    pairs = []
    for n, m, d, seed in cases:
        src = _horse(n, seed)
        pairs.append((src, (src[:m] @ _rot(d).T + 0.02).astype(np.float32)))
    trees = [tuple(np.asarray(a) for a in
                   jgt.GMMTree(p[0], tree_level=2)._nodes) for p in pairs]
    n_starts = 6 if form == "single" else 4
    rots0 = pgt._multistart_rots(n_starts, 3)
    # At a fixed depth that lets the runs settle: after 20 iterations a
    # start from far off is still ~1e-4 short of the fixed point, at a
    # rate that differs between the two descents' roundings; after 50
    # they agree to ~5e-7.
    kw = dict(max_level=2, lambda_c=0.01, maxiter=50, tol=0.0)
    tgts, tmasks = interop.pad_ragged([p[1] for p in pairs], **CPU)
    nodes = [torch.stack([_t(tr[k]) for tr in trees]) for k in range(3)]
    (rot, t, _), best, got = pgt._run_registration_multistart_batch(
        tgts, *nodes, rots0, tmasks=tmasks if form == "ragged" else None,
        **kw)
    scores = []
    for b, tr in enumerate(trees):
        tm = None if form != "ragged" else jnp.asarray(_np(tmasks[b]))
        rots, ts, score = _gmm_ref_starts(
            jnp.asarray(_np(tgts[b])), *(jnp.asarray(a) for a in tr),
            jnp.asarray(rots0), tmask=tm, **kw)
        scores.append(score)
        # The winner against the reference's run of the same start (two
        # starts that settle in one basin score within GAP).
        i = int(best[b])
        np.testing.assert_allclose(_np(rot[b]), np.asarray(rots)[i],
                                   atol=5e-4)
        np.testing.assert_allclose(_np(t[b]), np.asarray(ts)[i], atol=5e-4)
    _check_index(np.stack(scores), got, best)


def test_gmmtree_entry_points_take_the_search():
    src, tgt = _pair(200, noise=0.0)
    res = pgt.registration_gmmtree(src, tgt, n_starts=10, **CPU)
    assert pso.rotation_angle(res.transformation.rot,
                              _t(_rot([0.0, 0.0, 170.0]))) < 0.05
    out = pgt.registration_gmmtree_batch([src, src[:150]], [tgt, tgt[:120]],
                                         n_starts=3, maxiter=5, **CPU)
    assert len(out) == 2
    assert all(bool(torch.isfinite(r.transformation.rot).all()) for r in out)


# --------------------------------------------------------------------------
# BCPD
# --------------------------------------------------------------------------

def test_bcpd_multistart_matches_reference():
    """The normalized single-pair search (n_starts 4) against the
    reference's: same winner, the rigid part and the moved source within
    1e-4; the winner's raw-frame sigma2 is returned for the pyramid."""
    src = _horse(140, 1)
    tgt = (_horse(120, 2) @ _rot([0.0, 0.0, 170.0]).T + 0.01).astype(
        np.float32)
    kw = dict(w=0.0, maxiter=8, tol=0.0, callbacks=[], normalize=True,
              callback_chunk=1, n_starts=4, lmd=10.0)
    got, s2_p = pb._registration_bcpd_impl(src, tgt, **kw, **CPU)
    want, s2_j = jb._registration_bcpd_impl(src, tgt, **kw)
    rt_g, rt_w = got.rigid_trans, want.rigid_trans
    np.testing.assert_allclose(_np(rt_g.rot), np.asarray(rt_w.rot), atol=1e-4)
    np.testing.assert_allclose(_np(rt_g.t), np.asarray(rt_w.t), atol=1e-4)
    np.testing.assert_allclose(float(rt_g.scale), float(rt_w.scale),
                               atol=1e-4)
    np.testing.assert_allclose(_np(got.transform(src)),
                               np.asarray(want.transform(src)), atol=1e-4)
    np.testing.assert_allclose(s2_p, s2_j, rtol=1e-3)
    # The winning start: the reference's per-start NN-RMSE.
    centroid = np.concatenate([src, tgt]).astype(np.float64).mean(0)
    scale = np.sqrt(jmu.squared_kernel_sum_np(src, tgt))
    src_n = ((src - centroid) / scale).astype(np.float32)
    tgt_n = ((tgt - centroid) / scale).astype(np.float32)
    rots0 = pcf.RigidCostFunction.initial_multistart_rots(4)
    gmat = jmu.inverse_multiquadric_kernel(jnp.asarray(src_n),
                                           jnp.asarray(src_n))

    def run(rot0):
        src_r = jnp.asarray(src_n) @ rot0.T
        s20 = jmu.squared_kernel_sum(src_r, jnp.asarray(tgt_n))
        return jb._run_bcpd(src_r, jnp.asarray(tgt_n), gmat,
                            jnp.float32(10.0), jnp.float32(1e20), s20,
                            w=0.0, maxiter=8, tol=0.0,
                            block=int(pcfg.config.estep_chunk))[4]
    scores = jax.jit(jax.vmap(run))(jnp.asarray(rots0))
    _, _, best, got = pb._run_bcpd_multistart(
        _t(src_n), _t(tgt_n), _t(1.0), _t(10.0), _t(1e20), rots0, w=0.0,
        maxiter=8, tol=0.0, rank=None, block=int(pcfg.config.estep_chunk))
    _check_index(np.asarray(scores)[None], [got], [best])


# --------------------------------------------------------------------------
# Pyramids: the search on the coarsest level only
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["cpd", "filterreg", "gmmtree", "bcpd"])
def test_pyramid_searches_on_the_coarsest_level_only(monkeypatch, family):
    """tests/test_pyramid.py:525 for every family: level 0 gets n_starts
    and no warm start, every finer level the carry and one start."""
    mod, name, warm = {
        "cpd": (pcpd, "registration_cpd", "tf_init_params"),
        "filterreg": (pf, "registration_filterreg", "tf_init_params"),
        "gmmtree": (pgt, "registration_gmmtree", "tf_init_params"),
        "bcpd": (pb, "_registration_bcpd_impl", "tf_init_params")}[family]
    calls, orig = [], getattr(mod, name)

    def spy(*a, **k):
        calls.append((k.get("n_starts", 1), k.get(warm)))
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    src = _horse(1500, 7)
    tgt = (src @ _rot([0.0, 0.0, 150.0]).T + 0.01).astype(np.float32)
    run = getattr(ppy, f"registration_{family}_pyramid")
    res = run(src, tgt, n_starts=4, levels=2, coarse_points=300, maxiter=20,
              tol=0.0, level_maxiters=[20, 3], **CPU)
    assert len(calls) == 2
    assert calls[0][0] == 4 and not calls[0][1]
    assert calls[1][0] == 1 and calls[1][1]
    rot = (res.rigid_trans.rot if family == "bcpd"
           else res.transformation.rot)
    if family == "cpd":  # the search finds the 150-degree basin
        assert pso.rotation_angle(rot, _t(_rot([0.0, 0.0, 150.0]))) < 0.05

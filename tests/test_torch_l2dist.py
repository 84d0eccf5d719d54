"""The L2-distance family of the port (GMMReg, SVR) held to the JAX package:
the thin-plate-spline kernels and design, the L2 costs and their
gradients, the batched BFGS against jax.scipy.optimize's, the GMM and
one-class SVM fits, the single-pair registrations (rigid and TPS, both
optimizer routes, two annealing rounds, callbacks, 10 starts) and the
batches (a ragged batch with starts; a batch of one against the single
pair, with one and two rounds; a ragged pair against itself unpadded).

Both packages take the same seeded numpy clouds on the CPU. The port's GMM
draws its seed centres from a torch.Generator, the reference's from
jax.random.choice: the GMM cases hand the reference's draws to the port
(``features._seed_indices``). Tolerances: L2 values and gradients 1e-5
relative; the reference's TPS points through tps_from_reference 1e-5 of
the extent; BFGS x 1e-4, fun 1e-6 relative, the same status; GMM means and
weights, OCSVM alpha / (nu n) 1e-4; rigid registrations 1e-3 rad and 1e-3
of the extent, and both packages within tests/test_l2dist_regs.py's truth
bounds (Euler 0.1 rad, t 1e-2); TPS moved points 1e-3 of the extent; a
batch of one against the single pair and a ragged pair against itself
unpadded 1e-5 (one device).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.scipy.optimize import minimize as jax_minimize  # noqa: E402

import _fixtures  # noqa: E402
from probreg_tpu import cost_functions as jcf  # noqa: E402
from probreg_tpu import features as jft  # noqa: E402
from probreg_tpu import l2dist_regs as jl  # noqa: E402
from probreg_tpu import transformation as jtf  # noqa: E402
from probreg_tpu.ops import pairwise as jpw  # noqa: E402
from probreg_tpu.utils import math_utils as jmu  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import cost_functions as pcf  # noqa: E402
from probreg_tpu_torch import features as pft  # noqa: E402
from probreg_tpu_torch import l2dist_regs as pl  # noqa: E402
from probreg_tpu_torch.models import transformation as ptf  # noqa: E402
from probreg_tpu_torch.ops import bfgs  # noqa: E402
from probreg_tpu_torch.ops import pairwise as ppw  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import math_utils as pmu  # noqa: E402

CPU = dict(device="cpu")
REL = 1e-5
ROT = 1e-3
TRUTH_EULER, TRUTH_T = 1e-1, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the fits and solves run many small products that
    spin on oversubscribed cores under the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def ref_seed_indices(seed, n, k, smask=None, device=None):
    """The reference's seed centres (features.py:72-76) in the port's
    ``_seed_indices`` signature."""
    key = jft.np_prng_key(seed)
    if smask is None:
        rows = [jax.random.choice(key, n, (k,), replace=False)]
    else:
        rows = [jax.random.choice(key, n, (k,), replace=False,
                                  p=jnp.asarray(m) / jnp.sum(jnp.asarray(m)))
                for m in smask.cpu().numpy()]
    return torch.as_tensor(np.stack([np.asarray(r) for r in rows]),
                           device=device)


@pytest.fixture
def ref_seeds(monkeypatch):
    monkeypatch.setattr(pft, "_seed_indices", ref_seed_indices)


@pytest.fixture(scope="module")
def horse(horse_cloud):
    return np.asarray(horse_cloud, np.float32)[::2]


def _euler(rot):
    return np.asarray(jso.mat2euler(np.asarray(rot, np.float64)))


def _angle(a, b):
    r = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    return float(np.arccos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)))


def check_rigid(ref, port, extent, ang=None):
    """Port against reference within ROT rad and ROT of the extent; both
    within the truth bounds when ``ang`` is given (t = 0)."""
    rot_p = port.rot.numpy()
    assert _angle(rot_p, ref.rot) <= ROT
    assert np.abs(port.t.numpy() - np.asarray(ref.t)).max() <= ROT * extent
    if ang is not None:
        for rot, t in ((ref.rot, ref.t), (rot_p, port.t.numpy())):
            np.testing.assert_allclose(_euler(rot), ang, atol=TRUTH_EULER)
            np.testing.assert_allclose(np.asarray(t), 0.0, atol=TRUTH_T)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("dim", [2, 3])
def test_tps_kernels_and_design(dim):
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(30, dim)).astype(np.float32)
    y = np.r_[x[:5], rng.normal(size=(12, dim))].astype(np.float32)
    for name in ("squared_kernel", f"tps_kernel_{dim}d"):
        want = np.asarray(getattr(jpw, name)(x, y))
        got = getattr(ppw, name)(_t(x), _t(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pmu.tps_kernel(_t(x), _t(y)).numpy(),
                               np.asarray(jmu.tps_kernel(x, y)), rtol=1e-5,
                               atol=1e-5)
    # prepare: the same basis columns up to the null-space basis, so the
    # same points for the same (A, pp v).
    ctrl = y[5:]
    a = (np.r_[np.zeros((1, dim)), np.eye(dim)]
         + 0.05 * rng.normal(size=(dim + 1, dim))).astype(np.float32)
    v_ref = (0.1 * rng.normal(size=(len(ctrl) - dim - 1, dim))) \
        .astype(np.float32)
    pn = np.c_[np.ones((len(ctrl), 1)), ctrl].astype(np.float32)
    pp_ref = np.asarray(jnp.linalg.svd(pn, full_matrices=True)[0])[:,
                                                                   dim + 1:]
    ref = jtf.TPSTransformation(a, v_ref, ctrl)
    port = interop.tps_from_reference(
        dict(a=a, v=v_ref, control_pts=ctrl, null_basis=pp_ref), **CPU)
    extent = float(np.ptp(x, 0).max())
    assert np.abs(port.transform(x).numpy()
                  - np.asarray(ref.transform(x))).max() <= 1e-5 * extent
    basis, kernel = port.prepare(_t(x))
    np.testing.assert_allclose(basis[:, 1:dim + 1].numpy(), x)
    n_null = len(ctrl) - dim - 1
    assert basis.shape == (len(x), dim + 1 + n_null)
    assert kernel.shape == (n_null, n_null)
    pp = ptf.null_basis(_t(ctrl)).numpy()
    # Both bases span one space: pp pp^T equals pp_ref pp_ref^T.
    np.testing.assert_allclose(pp @ pp.T, pp_ref @ pp_ref.T, atol=1e-5)


# ------------------------------------------------------------------ costs


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def mixtures():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(30, 3)).astype(np.float32),
            rng.uniform(0.1, 1.0, 30).astype(np.float32),
            rng.normal(size=(25, 3)).astype(np.float32),
            rng.uniform(0.1, 1.0, 25).astype(np.float32), 0.7)


def test_rigid_cost_and_compute_l2_dist(mixtures):
    mu_s, phi_s, mu_t, phi_t, sigma = mixtures
    theta = np.array([0.9, 0.1, -0.2, 0.3, 0.1, 0.2, -0.1], np.float32)
    f, g = jax.value_and_grad(jcf.RigidCostFunction.pure_objective)(
        jnp.asarray(theta), mu_s, phi_s, mu_t, phi_t, jnp.float32(sigma))
    pf, pg = pcf.RigidCostFunction(**CPU)(
        theta, _t(mu_s), _t(phi_s), _t(mu_t), _t(phi_t), sigma)
    assert isinstance(pf, float) and pg.dtype == np.float64
    assert _rel(pf, f) <= REL and _rel(pg, g) <= REL
    assert _rel(pcf.RigidCostFunction.pure_objective(
        _t(theta), _t(mu_s), _t(phi_s), _t(mu_t), _t(phi_t), sigma), f) \
        <= REL
    f, g = jcf.compute_l2_dist(mu_s, phi_s, mu_t, phi_t, sigma)
    pf, pg = pcf.compute_l2_dist(_t(mu_s), _t(phi_s), _t(mu_t), _t(phi_t),
                                 sigma)
    assert _rel(pf, f) <= REL and _rel(pg, g) <= REL


@pytest.mark.parametrize("dim", [2, 3])
def test_tps_cost_on_the_reference_basis(dim):
    """The TPS cost and gradient with the reference's basis and kernel
    passed through ``pure_objective``. TPS's self-overlap f1 has d2 == 0
    on its diagonal, where jnp.maximum(d2, 0) hands half the gradient of
    the tie to each side and torch.clamp all of it; the true derivative
    there is 0, so the two differ by rounding only."""
    rng = np.random.default_rng(10 + dim)
    ctrl = rng.normal(size=(12, dim)).astype(np.float32)
    ms = rng.normal(size=(20, dim)).astype(np.float32)
    mt = rng.normal(size=(18, dim)).astype(np.float32)
    ps = np.full(20, 1 / 20, np.float32)
    pt = np.full(18, 1 / 18, np.float32)
    n_a = dim * (dim + 1)
    theta = np.r_[np.r_[np.zeros((1, dim)), np.eye(dim)].ravel()
                  + 0.05 * rng.normal(size=n_a),
                  0.05 * rng.normal(size=(12 - dim - 1) * dim)] \
        .astype(np.float32)
    extra = jcf.TPSCostFunction.pure_prepare(
        jnp.asarray(ms), jnp.asarray(ctrl), np.float32(1.0), np.float32(0.1))
    f, g = jax.value_and_grad(jcf.TPSCostFunction.pure_objective)(
        jnp.asarray(theta), ms, ps, mt, pt, jnp.float32(0.5), *extra)
    with torch.enable_grad():
        x = _t(theta).requires_grad_(True)
        pf = pcf.TPSCostFunction.pure_objective(
            x, _t(ms), _t(ps), _t(mt), _t(pt), 0.5, _t(ctrl), 1.0, 0.1,
            basis=_t(extra[3]), kernel=_t(extra[4]))
        (pg,) = torch.autograd.grad(pf, x)
    assert _rel(pf.detach(), f) <= REL and _rel(pg, g) <= REL
    # The port's own basis: the same value at the same moved points.
    cost = pcf.TPSCostFunction(_t(ctrl), 1.0, 0.1, **CPU)
    own = float(cost.objective(_t(np.r_[theta[:n_a], np.zeros(
        (12 - dim - 1) * dim, np.float32)]), _t(ms), _t(ps), _t(mt),
        _t(pt), 0.5))
    ref0 = float(jcf.TPSCostFunction.pure_objective(
        jnp.asarray(np.r_[theta[:n_a], np.zeros((12 - dim - 1) * dim)],
                    jnp.float32), ms, ps, mt, pt, jnp.float32(0.5), *extra))
    assert _rel(own, ref0) <= REL


# ------------------------------------------------------------------- BFGS


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_t(x):
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
            + (1 - x[:, :-1]) ** 2).sum(1)


def _check_bfgs(port, refs):
    for i, ref in enumerate(refs):
        assert int(port.status[i]) == int(ref.status)
        np.testing.assert_allclose(port.x[i].numpy(), np.asarray(ref.x),
                                   atol=1e-4)
        assert abs(float(port.fun[i]) - float(ref.fun)) \
            <= 1e-6 * max(abs(float(ref.fun)), 1e-12)


def test_bfgs_rosenbrock_batch_against_jax():
    """Five starts solved as one batch, each against jax's BFGS from the
    same start, in float64 (in float32 the Rosenbrock valley turns
    rounding into different paths in both packages alike); the same
    iterations and evaluations too."""
    x0 = np.random.default_rng(0).uniform(-1.5, 1.5, (6, 4))
    with jax.enable_x64(True):
        out = jax.jit(jax.vmap(lambda x: jax_minimize(
            _rosen_j, x, method="BFGS", options={"maxiter": 30})))(
                jnp.asarray(x0))
        out = jax.tree_util.tree_map(np.asarray, out)
    refs = [jax.tree_util.tree_map(lambda a: a[i], out) for i in range(6)]
    bfgs.reset_counts()
    port = bfgs.minimize(_rosen_t, torch.from_numpy(x0), maxiter=30)
    _check_bfgs(port, refs)
    assert [int(n) for n in port.nit] == [int(r.nit) for r in refs]
    assert [int(n) for n in port.nfev] == [int(r.nfev) for r in refs]
    # Converged, out of iterations and a failed line search among them.
    assert {int(r.status) for r in refs} == {0, 1, 3}
    assert bfgs.SOLVES == 1 and bfgs.ITERS == max(int(r.nit) for r in refs)
    # One host read per BFGS iteration and per line-search evaluation,
    # plus each loop's last test.
    assert bfgs.READS == 2 * bfgs.ITERS + bfgs.EVALS


def test_bfgs_rigid_l2_against_jax(mixtures):
    """The conditioned rigid L2 solve of the registrations, float32, from
    three starts: _bfgs_solve of both packages."""
    mu_s, phi_s, mu_t, phi_t, sigma = mixtures
    x0 = np.asarray(jcf.RigidCostFunction.initial_multistart(3),
                    np.float32)
    x0[:, 4:] = 0.05
    rx, rf = jax.jit(jax.vmap(lambda x: jl._bfgs_solve(
        jcf.RigidCostFunction.pure_objective, x,
        (mu_s, phi_s, mu_t, phi_t, jnp.float32(sigma)), 50, 1e-3)))(
            jnp.asarray(x0))
    refs = [(np.asarray(rx[i]), float(rf[i])) for i in range(3)]
    rows = [_t(a)[None].expand(3, *a.shape) for a in (mu_s, phi_s, mu_t,
                                                      phi_t)]
    px, pfun = pl._bfgs_solve(pcf.RigidCostFunction.batch_objective, _t(x0),
                              (*rows, torch.full((3,), sigma)), 50, 1e-3)
    for i, (rx, rf) in enumerate(refs):
        np.testing.assert_allclose(px[i].numpy(), rx, atol=1e-4)
        assert abs(float(pfun[i]) - rf) <= 1e-6 * abs(rf)


# --------------------------------------------------------------- features


def test_gmm_fit_from_the_reference_seeds(horse):
    x = horse[:200]
    key = jft.np_prng_key(5)
    idx = ref_seed_indices(5, len(x), 16)
    mu_r, pi_r = jft._fit_spherical_gmm(key, jnp.asarray(x), 16)
    mu_p, pi_p = pft._fit_spherical_gmm(idx, _t(x)[None])
    np.testing.assert_allclose(mu_p[0].numpy(), np.asarray(mu_r), atol=1e-4)
    np.testing.assert_allclose(pi_p[0].numpy(), np.asarray(pi_r), atol=1e-4)
    # Masked: padded points never seed, weigh or count.
    sm = np.ones(230, np.float32)
    sm[200:] = 0.0
    xp = np.r_[x, np.zeros((30, 3), np.float32)]
    idx = ref_seed_indices(5, 230, 16, smask=_t(sm)[None])
    assert int(idx.max()) < 200
    mu_r, pi_r = jft._fit_spherical_gmm(key, jnp.asarray(xp), 16,
                                        smask=jnp.asarray(sm))
    mu_p, pi_p = pft._fit_spherical_gmm(idx, _t(xp)[None], smask=_t(sm)[None])
    np.testing.assert_allclose(mu_p[0].numpy(), np.asarray(mu_r), atol=1e-4)
    np.testing.assert_allclose(pi_p[0].numpy(), np.asarray(pi_r), atol=1e-4)


def test_gmm_seed_draws_are_the_generators():
    a = pft._seed_indices(3, 50, 10)
    assert a.shape == (1, 10) and len(set(a[0].tolist())) == 10
    assert torch.equal(a, pft._seed_indices(3, 50, 10))
    m = torch.zeros((2, 50))
    m[0, :20] = 1.0
    m[1, 10:40] = 1.0
    b = pft._seed_indices(3, 50, 10, smask=m)
    assert int(b[0].max()) < 20 and int(b[1].min()) >= 10
    assert torch.equal(b[1:], pft._seed_indices(3, 50, 10, smask=m[1:]))


@pytest.mark.parametrize("masked", [False, True])
def test_ocsvm_dual(horse, masked):
    x = horse[:200]
    sm = (np.arange(200) < 150).astype(np.float32) if masked else None
    kw_r = dict(smask=jnp.asarray(sm)) if masked else {}
    kw_p = dict(smask=_t(sm)[None]) if masked else {}
    a_r = np.asarray(jft._fit_ocsvm_dual(jnp.asarray(x), np.float32(80.0),
                                         0.1, **kw_r))
    a_p = pft._fit_ocsvm_dual(_t(x)[None], torch.tensor([80.0]),
                              torch.tensor([0.1]), **kw_p)[0].numpy()
    n = 150 if masked else 200
    np.testing.assert_allclose(a_p / (0.1 * n), a_r / (0.1 * n), atol=1e-4)
    if masked:
        assert np.all(a_p[150:] == 0.0)
    svm = pft.OneClassSVM(3, 0.2, gamma=80.0, nu=0.1, **CPU)
    mu, phi = svm.compute(x)
    mu_r, phi_r = jft.OneClassSVM(3, 0.2, gamma=80.0, nu=0.1).compute(x)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r))
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_r),
                               atol=1e-4 * float(np.abs(phi_r).max()))


def test_fpfh_names_its_item():
    """FPFH is ported (tests/test_torch_fpfh.py holds it to the
    reference): it builds and computes 33-D histograms."""
    pts = np.random.default_rng(0).normal(size=(60, 3)).astype(np.float32)
    h = pft.FPFH(0.8, 1.5, 10, 20, **CPU).compute(pts)
    assert h.shape == (60, 33) and torch.isfinite(h).all()
    np.testing.assert_allclose(h.reshape(60, 3, 11).sum(2).numpy(), 200.0,
                               rtol=1e-4)


# ---------------------------------------------------- single registrations


@pytest.fixture(scope="module")
def rigid_pair(horse):
    ang = np.deg2rad([8.0, -4.0, 6.0])
    rot = np.asarray(jso.euler2mat(*ang), np.float32)
    return horse, horse @ rot.T, ang


RIGID_CASES = {
    "svr": (jl.RigidSVR, pl.RigidSVR, {}),
    "gmmreg": (jl.RigidGMMReg, pl.RigidGMMReg, dict(n_gmm_components=100)),
}


@pytest.mark.parametrize("optimizer", ["jax", "scipy"])
@pytest.mark.parametrize("kind", sorted(RIGID_CASES))
def test_single_pair_rigid(rigid_pair, ref_seeds, kind, optimizer):
    """The entry points' classes with two annealing rounds (sigma x delta;
    GMM: a fresh seed, OCSVM: gamma x 10), tol 0: every round runs."""
    src, tgt, ang = rigid_pair
    jcls, pcls, kw = RIGID_CASES[kind]
    ref = jcls(src, optimizer=optimizer, **kw).registration(
        tgt, maxiter=2, tol=0.0)
    bfgs.reset_counts()
    port = pcls(src, optimizer=optimizer, **kw, **CPU).registration(
        tgt, maxiter=2, tol=0.0)
    assert port.rot.device.type == "cpu"
    check_rigid(ref, port, float(np.ptp(tgt, 0).max()), ang)
    # The on-device route solves once per round; the host route not at all.
    assert bfgs.SOLVES == (2 if optimizer == "jax" else 0)


@pytest.mark.parametrize("kind", ["svr", "gmmreg"])
def test_entry_points_are_their_classes(rigid_pair, kind):
    src, tgt, _ = rigid_pair
    kw = dict(n_gmm_components=100) if kind == "gmmreg" else {}
    cls = pl.RigidSVR if kind == "svr" else pl.RigidGMMReg
    a = getattr(pl, f"registration_{kind}")(src, tgt, **kw, **CPU)
    b = cls(src, **kw, **CPU).registration(tgt)
    assert torch.equal(a.rot, b.rot) and torch.equal(a.t, b.t)


def test_callbacks_take_the_host_route(rigid_pair):
    """Callbacks run scipy's BFGS on the host in both packages, each
    iteration's transform handed over; the value and gradient come from
    the device."""
    src, tgt, ang = rigid_pair
    seen_r, seen_p = [], []
    ref = jl.registration_svr(src, tgt, callbacks=[seen_r.append])
    bfgs.reset_counts()
    port = pl.registration_svr(src, tgt, callbacks=[seen_p.append], **CPU)
    assert bfgs.SOLVES == 0
    check_rigid(ref, port, float(np.ptp(tgt, 0).max()), ang)
    assert len(seen_p) >= 1 and abs(len(seen_p) - len(seen_r)) <= 1
    assert all(isinstance(t, ptf.RigidTransformation) for t in seen_p)


TPS_CASES = {
    "svr": (jl.registration_svr, pl.registration_svr, dict(opt_maxiter=30)),
    "gmmreg": (jl.registration_gmmreg, pl.registration_gmmreg,
               dict(n_gmm_components=40)),
}


# The on-device TPS round is the same for both features (the GMM's fit is
# held to the reference's on the rigid pair), so GMMReg takes the host
# route only: the reference's compile of each fused round costs seconds.
@pytest.mark.parametrize("kind,optimizer", [("svr", "jax"), ("svr", "scipy"),
                                            ("gmmreg", "scipy")])
def test_single_pair_tps_fish(ref_seeds, kind, optimizer):
    """BFGS from H0 = I is invariant under an orthogonal change of
    variables, so the solves in the two packages' null-space bases reach
    the same points (up to rounding)."""
    src, tgt = _fixtures.fish_source(), _fixtures.fish_target()
    jfn, pfn, kw = TPS_CASES[kind]
    ref = jfn(src, tgt, "nonrigid", optimizer=optimizer, **kw)
    port = pfn(src, tgt, "nonrigid", optimizer=optimizer, **kw, **CPU)
    assert isinstance(port, ptf.TPSTransformation)
    moved_r = np.asarray(ref.transform(src))
    moved_p = port.transform(src).numpy()
    extent = float(np.ptp(tgt, 0).max())
    assert np.abs(moved_p - moved_r).max() <= 1e-3 * extent

    def nn(a):
        return float(np.sqrt(((a[:, None] - tgt[None]) ** 2).sum(-1)
                             .min(1).mean()))

    assert nn(moved_p) < nn(src) and nn(moved_r) < nn(src)


def test_multistart_recovers_150_degrees(rigid_pair, ref_seeds):
    """tests/test_l2dist_regs.py:112: ten starts recover a 150-degree turn
    that the identity start misses, in both packages."""
    src = rigid_pair[0]
    rot = np.asarray(jso.euler2mat(0.0, 0.0, np.deg2rad(150.0)), np.float32)
    tgt = src @ rot.T
    kw = dict(n_gmm_components=100, n_starts=10)
    ref = jl.registration_gmmreg(src, tgt, **kw)
    port = pl.registration_gmmreg(src, tgt, **kw, **CPU)
    for res in (np.asarray(ref.rot), port.rot.numpy()):
        assert _angle(res, rot) < np.deg2rad(5.0)
    check_rigid(ref, port, float(np.ptp(tgt, 0).max()))
    single = pl.registration_gmmreg(src, tgt, n_gmm_components=100, **CPU)
    assert _angle(single.rot.numpy(), rot) > _angle(port.rot.numpy(), rot)


def test_tps_refuses_starts():
    with pytest.raises(ValueError, match="initial_multistart"):
        pl.registration_svr(np.zeros((20, 2), np.float32) + np.arange(20)[
            :, None], np.zeros((20, 2)), "nonrigid", n_starts=2, **CPU)


# ---------------------------------------------------------------- batches


@pytest.fixture(scope="module")
def ragged_pairs(horse):
    angs = [np.deg2rad([0.0, 0.0, 120.0]), np.deg2rad([6.0, -2.0, 3.0])]
    sources = [horse, horse[::2]]
    targets = [s @ np.asarray(jso.euler2mat(*a), np.float32).T
               for s, a in zip(sources, angs)]
    return sources, targets, angs


def test_ragged_batch_with_starts(ragged_pairs, ref_seeds):
    """A ragged GMMReg batch (masked fits and seeds) with four starts (the
    raw-point rescore with masks), one pair turned 120 degrees
    (test_batch.py:533). The fixed-size batch, with its annealing rounds,
    is the single pair's rounds (test_batch_of_one_is_the_single_pair,
    held to the reference through test_single_pair_rigid), and a ragged
    SVR pair its unpadded self
    (test_ragged_masked_pair_is_the_unpadded_pair)."""
    sources, targets, angs = ragged_pairs
    kw = dict(n_gmm_components=60, n_starts=4)
    refs = jl.registration_gmmreg_batch(sources, targets, **kw)
    ports = pl.registration_gmmreg_batch(sources, targets, **kw, **CPU)
    assert len(ports) == len(refs) == 2
    for ref, port, tgt, ang in zip(refs, ports, targets, angs):
        check_rigid(ref, port, float(np.ptp(tgt, 0).max()), ang)


@pytest.mark.parametrize("maxiter", [1, 2])
@pytest.mark.parametrize("kind", ["svr", "gmmreg"])
def test_batch_of_one_is_the_single_pair(rigid_pair, kind, maxiter):
    """A batch of one runs the single pair's fused rounds: the same seeds
    (GMM: seed + 1 + r in round r), sigma, gamma and starts. The single
    path centres the pair on its shared centroid, so the pair is centred
    first; tol 0 keeps every round of the single path."""
    src, tgt, _ = rigid_pair
    cen = (src.astype(np.float64).mean(0) + tgt.astype(np.float64).mean(0)) \
        / 2
    src = (src - cen).astype(np.float32)
    tgt = (tgt - cen).astype(np.float32)
    kw = dict(n_gmm_components=100) if kind == "gmmreg" else {}
    if kind == "gmmreg":
        reg = pl.RigidGMMReg(src, **kw, **CPU)
    else:
        reg = pl.RigidSVR(src, **CPU)
    single = reg.registration(tgt, maxiter=maxiter, tol=0.0)
    batch = getattr(pl, f"registration_{kind}_batch")(
        src[None], tgt[None], maxiter=maxiter, **kw, **CPU)[0]
    np.testing.assert_allclose(batch.rot.numpy(), single.rot.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(batch.t.numpy(), single.t.numpy(), atol=1e-5)


def test_ragged_masked_pair_is_the_unpadded_pair(horse):
    """SVR's dual is deterministic, so a padded pair reproduces its
    unpadded registration (test_batch.py:550); GMM's masked seeding draws
    other centres than the unmasked one."""
    small, big = horse[::4], horse
    rot = np.asarray(jso.euler2mat(*np.deg2rad([4.0, 1.0, -5.0])),
                     np.float32)
    ragged = pl.registration_svr_batch([small, big],
                                       [small @ rot.T, big @ rot.T], **CPU)
    plain = pl.registration_svr_batch(small[None], (small @ rot.T)[None],
                                      **CPU)
    np.testing.assert_allclose(ragged[0].rot.numpy(), plain[0].rot.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(ragged[0].t.numpy(), plain[0].t.numpy(),
                               atol=1e-5)


class _NoFusedFit:
    """A feature generator that hides ``fused_fit`` and delegates the rest,
    attribute writes too (the reference's _ShardedFeatureWrapper's shape):
    the registration must take the second on-device route."""

    def __init__(self, base):
        object.__setattr__(self, "_base", base)

    def __setattr__(self, name, value):
        setattr(self._base, name, value)

    def __getattr__(self, name):
        if name == "fused_fit":
            raise AttributeError(name)
        return getattr(self._base, name)


@pytest.mark.parametrize("kind", sorted(RIGID_CASES))
def test_feature_without_fused_fit_takes_the_second_route(rigid_pair,
                                                          ref_seeds, kind):
    """compute() mixtures, then one on-device BFGS solve a round, in both
    packages (reference l2dist_regs.py:329-345), two rounds, tol 0."""
    src, tgt, ang = rigid_pair
    jcls, pcls, kw = RIGID_CASES[kind]
    ref_reg = jcls(src, **kw)
    ref_reg._feature_gen = _NoFusedFit(ref_reg._feature_gen)
    ref = ref_reg.registration(tgt, maxiter=2, tol=0.0)
    port_reg = pcls(src, **kw, **CPU)
    port_reg._feature_gen = _NoFusedFit(port_reg._feature_gen)
    bfgs.reset_counts()
    port = port_reg.registration(tgt, maxiter=2, tol=0.0)
    assert bfgs.SOLVES == 2
    check_rigid(ref, port, float(np.ptp(tgt, 0).max()), ang)

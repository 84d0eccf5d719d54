"""Nonrigid and constrained CPD of the port (probreg_tpu_torch.cpd) held to
the JAX package (probreg_tpu.cpd).

Both packages take the same seeded numpy clouds on the CPU; the port runs
its kernels' plain versions (its tensors lie on the CPU), the JAX package
its XLA twins. Displacements (``transform(source)``) are compared, never
``w``, ``u`` or ``zc``: the signs of SVD columns and ``w`` under an
ill-conditioned M x M solve differ between LAPACK builds while G W and
U zc agree.

Tolerances, each measured on this CPU before it was set:
* M-steps on the same moments: 1e-5 absolute on the displacement, 1e-5
  relative on sigma2 (measured <= 2e-6).
* Dense nonrigid and constrained registration at 10 iterations, before
  sigma2 reaches the f32 floor: 5e-5 absolute (measured <= 1.7e-5).
* Deeper runs, where sigma2 falls to ~1e-6 and the M x M solve makes the
  loop chaotic, or alpha = 1e-6 makes the constrained solve
  ill-conditioned from the first iteration: 8 times the spread between
  the port's f32 and f64 runs of the same registration, plus 1e-5 (ROADMAP
  Queue 3's rule from PR 5); measured 1.0 to 4.4 times it.
* The low-rank loop on the same Nystrom factors: 1e-5 (measured 4e-7).
  Runs that build their own factors: 1e-3, because the two packages'
  factors of one cloud differ by up to 5e-4 in U diag(lam) U^T (an f32
  eigendecomposition of an ill-conditioned landmark Gram matrix; measured
  displacement differences 5e-5 to 2e-4).
* sigma2 within 1e-4 relative, or 2e-7 absolute where it has reached
  ~2e-6: there it is the f32 remainder of xx - 2 tr(PX^T T) + tr(T^T P T)
  over n_p D, whose terms are ~1e2 (measured 4e-8 to 8e-8 apart).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import cpd as jcpd  # noqa: E402
from probreg_tpu.models import transformation as jtf  # noqa: E402
from probreg_tpu.ops import estep as jeo  # noqa: E402
from probreg_tpu.ops import lowrank as jlr  # noqa: E402
from probreg_tpu.utils import math_utils as jmu  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch.models import transformation as ptf  # noqa: E402
from probreg_tpu_torch.ops import estep as peo  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import math_utils as pmu  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = dict(device="cpu")
TIGHT = 5e-5
LOWRANK = 1e-3
SPREAD_MULTIPLE = 8.0
SIGMA2_FLOOR = 2e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its dense M x M solves and small
    products spin on oversubscribed cores when the suite's workers share
    the machine (a deep 3-D case took 80-120 s under six workers, ~1 s
    alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fish():
    """examples/cpd_nonrigid2d.py's clouds (91 points, 2-D)."""
    return tuple(np.loadtxt(os.path.join(DATA, f"fish_{name}.txt")).astype(
        np.float32) for name in ("source", "target"))


def _cloud3d(m=300, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    return src, (src + 0.05 * np.sin(2.0 * src[:, ::-1])).astype(np.float32)


CLOUDS = {"fish": _fish, "3d": _cloud3d}


def _constrained(n, alpha):
    idx = np.arange(0, n, 5)
    return dict(beta=0.5, lmd=1.0, alpha=alpha, idx_source=idx,
                idx_target=idx)


def _moved_ref(res, src):
    return np.asarray(res.transformation.transform(src))


def _moved(res, src):
    return res.transformation.transform(torch.as_tensor(src)).numpy()


# --------------------------------------------------------------------------
# M-steps and transformations
# --------------------------------------------------------------------------

def _moments(src, tgt, sigma2=0.05, w=0.1):
    """The same E-step moments for both packages, from the JAX package's
    estep_xla of a slightly moved source."""
    mom = jeo.estep_xla(jnp.asarray(src + 0.01), jnp.asarray(tgt),
                        jnp.float32(sigma2), w)
    ref = mom
    port = peo.EstepMoments(*(torch.as_tensor(np.array(a)) for a in mom))
    return ref, port


@pytest.mark.parametrize("kind", ["dense", "lowrank", "constrained"])
def test_maximization_steps_match_reference(kind):
    src, tgt = _cloud3d(200)
    ref_mom, mom = _moments(src, tgt)
    sigma2_p = 0.05
    ys = torch.as_tensor(src)
    if kind == "lowrank":
        u, lam = jlr.lowrank_rbf(jnp.asarray(src), 2.0, 20)
        ref = jcpd.nonrigid_lowrank_maximization_step(
            jnp.asarray(src), ref_mom, u, lam, 2.0, sigma2_p)
        out = pcpd.nonrigid_lowrank_maximization_step(
            ys, mom, torch.as_tensor(np.array(u)),
            torch.as_tensor(np.array(lam)), 2.0, sigma2_p)
        assert isinstance(out.transformation,
                          ptf.LowRankNonRigidTransformation)
    else:
        g = jtf.NonRigidTransformation(None, src, 2.0).g
        if kind == "dense":
            ref = jcpd.nonrigid_maximization_step(jnp.asarray(src), ref_mom,
                                                  g, 2.0, sigma2_p)
            out = pcpd.nonrigid_maximization_step(
                ys, mom, torch.as_tensor(np.array(g)), 2.0, sigma2_p)
        else:
            p1t = np.zeros(200, np.float32)
            pxt = np.zeros_like(src)
            np.add.at(p1t, [0, 5, 5, 90], 1.0)
            np.add.at(pxt, [0, 5, 5, 90], tgt[[1, 7, 8, 90]])
            ref = jcpd.constrained_nonrigid_maximization_step(
                jnp.asarray(src), ref_mom, g, 2.0, sigma2_p, 0.1,
                jnp.asarray(p1t), jnp.asarray(pxt))
            out = pcpd.constrained_nonrigid_maximization_step(
                ys, mom, torch.as_tensor(np.array(g)), 2.0, sigma2_p, 0.1,
                torch.as_tensor(p1t), torch.as_tensor(pxt))
        assert isinstance(out.transformation, ptf.NonRigidTransformation)
    np.testing.assert_allclose(_moved(out, src), _moved_ref(ref, src),
                               atol=1e-5)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=1e-5)
    assert float(out.q) == float(out.sigma2)


def test_transformations_and_carry_across_match_reference():
    src, _ = _cloud3d(120)
    rng = np.random.default_rng(1)
    w = (0.01 * rng.normal(size=src.shape)).astype(np.float32)
    ref = jtf.NonRigidTransformation(w, src, 1.5)
    out = ptf.NonRigidTransformation(w, src, 1.5, **CPU)
    np.testing.assert_allclose(out.g.numpy(), np.asarray(ref.g), atol=1e-6)
    np.testing.assert_allclose(out.transform(src).numpy(),
                               np.asarray(ref.transform(src)), atol=1e-6)
    zero = ptf.NonRigidTransformation(None, src, 1.5, **CPU)
    assert torch.equal(zero.transform(src), torch.as_tensor(src))
    with pytest.raises(ValueError, match="points="):
        ptf.NonRigidTransformation(None, g=np.eye(3), **CPU)
    carried = interop.nonrigid_from_reference(
        {"w": np.asarray(ref.w), "g": np.asarray(ref.g)}, **CPU)
    assert isinstance(carried, ptf.NonRigidTransformation)
    np.testing.assert_allclose(carried.transform(src).numpy(),
                               np.asarray(ref.transform(src)), atol=1e-6)
    u, lam = jlr.lowrank_rbf(jnp.asarray(src), 1.5, 10)
    zc = (0.01 * rng.normal(size=(10, 3))).astype(np.float32)
    ref = jtf.LowRankNonRigidTransformation(zc, u, lam)
    carried = interop.nonrigid_from_reference(
        {k: np.asarray(getattr(ref, k)) for k in ("zc", "u", "lam")}, **CPU)
    assert isinstance(carried, ptf.LowRankNonRigidTransformation)
    np.testing.assert_allclose(carried.transform(src).numpy(),
                               np.asarray(ref.transform(src)), atol=1e-6)
    with pytest.raises(ValueError, match="w, g.*zc, u, lam"):
        interop.nonrigid_from_reference({"w": zc}, **CPU)


def test_normalizer_matches_reference():
    a, b = _cloud3d(50)
    ref = jmu.Normalizer.fit(a, b * 3.0 + 2.0)
    out = pmu.Normalizer.fit(a, b * 3.0 + 2.0)
    np.testing.assert_allclose(out.normalize(a).numpy(),
                               np.asarray(ref.normalize(a)), atol=1e-6)
    np.testing.assert_allclose(out.denormalize(b).numpy(),
                               np.asarray(ref.denormalize(b)), atol=1e-5)
    np.testing.assert_allclose(
        out.denormalize(out.normalize(torch.as_tensor(a))).numpy(), a,
        atol=1e-5)
    assert pmu.Normalizer().normalize(a).numpy().tolist() == a.tolist()
    np.testing.assert_allclose(
        pmu.rbf_kernel(torch.as_tensor(a), torch.as_tensor(b), 0.7).numpy(),
        np.asarray(jmu.rbf_kernel(a, b, 0.7)), atol=1e-6)


# --------------------------------------------------------------------------
# Registration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cloud", ["fish", "3d"])
@pytest.mark.parametrize("kind", ["nonrigid", "nonrigid_constrained"])
def test_dense_registration_matches_reference(cloud, kind):
    """10 iterations at a fixed depth (tol = 0); alpha = 1e-3 keeps the
    constrained solve well conditioned."""
    src, tgt = CLOUDS[cloud]()
    kw = {} if kind == "nonrigid" else _constrained(len(src), 1e-3)
    ref = jcpd.registration_cpd(src, tgt, kind, w=0.05, maxiter=10, tol=0.0,
                                **kw)
    out = pcpd.registration_cpd(src, tgt, kind, w=0.05, maxiter=10, tol=0.0,
                                **kw, **CPU)
    assert isinstance(out.transformation, ptf.NonRigidTransformation)
    np.testing.assert_allclose(_moved(out, src), _moved_ref(ref, src),
                               atol=TIGHT)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=1e-4)


def _noisy3d():
    """_cloud3d's pair with N(0, 0.01) noise on the target, and the clean
    target: on exact 1:1 clouds sigma2 collapses to the f32 floor within
    25 iterations and lmd sigma2 I no longer regularizes the M x M solve
    (then the JAX package itself lies 10 times the port's f32-f64 spread
    from f64); noise keeps sigma2 at its level, as real scans do."""
    src, clean = _cloud3d()
    noise = np.random.default_rng(1).normal(0.0, 0.01, src.shape)
    return src, (clean + noise).astype(np.float32), clean


@pytest.mark.parametrize("cloud", ["fish", "3d"])
@pytest.mark.parametrize("kind", ["nonrigid", "nonrigid_constrained"])
def test_deep_registration_within_precision_spread(cloud, kind):
    """tests/test_cpd.py's settings run to their depth (50 iterations
    nonrigid, 60 constrained with alpha = 1e-6): the port within 8 times
    its own f32-f64 spread of the JAX package, and both close the
    residual to the clean target as the reference test asks (< 0.2 of
    the initial one; 0.3 on the noisy 3-D cloud, whose noise is a quarter
    of that)."""
    if cloud == "fish":
        src, tgt = _fish()
        clean = tgt
    else:
        src, tgt, clean = _noisy3d()
    kw = ({} if kind == "nonrigid" else _constrained(len(src), 1e-6))
    it = dict(maxiter=50 if kind == "nonrigid" else 60, tol=0.0)
    ref = _moved_ref(jcpd.registration_cpd(src, tgt, kind, **it, **kw), src)
    out = _moved(pcpd.registration_cpd(src, tgt, kind, **it, **kw, **CPU),
                 src)
    dtype = pcfg.config.dtype
    pcfg.config.dtype = torch.float64
    try:
        f64 = _moved(pcpd.registration_cpd(src, tgt, kind, use_pallas=False,
                                           **it, **kw, **CPU),
                     src.astype(np.float64))
    finally:
        pcfg.config.dtype = dtype
    spread = float(np.abs(out - f64).max())
    assert float(np.abs(out - ref).max()) <= SPREAD_MULTIPLE * spread + 1e-5
    rmse0 = np.sqrt(((src - clean) ** 2).sum(1)).mean()
    bar = 0.2 if cloud == "fish" else 0.3  # the noise is 1/4 of rmse0
    for moved in (out, ref):
        assert np.sqrt(((moved - clean) ** 2).sum(1)).mean() < bar * rmse0


def _lowrank_pair():
    rng = np.random.default_rng(3)
    src = rng.uniform(-1.0, 1.0, (600, 3)).astype(np.float32)
    return src, (src[:500] + 0.05 * np.sin(2.0 * src[:500, ::-1])).astype(
        np.float32)


@pytest.mark.parametrize("block", [None, 128], ids=["unblocked", "blocked"])
def test_lowrank_loop_matches_reference(block):
    """_run_em_nonrigid_lowrank_t on the JAX package's own factors, its
    E-step in one block of 500 columns or in four of 128 (the last
    padded)."""
    src, tgt = _lowrank_pair()
    u, lam = jlr.lowrank_rbf(jnp.asarray(src), 2.0, 20)
    zc, sigma2, q = jcpd._run_em_nonrigid_lowrank_t(
        jnp.asarray(src), jnp.asarray(tgt), u, lam, jnp.float32(2.0), w=0.1,
        maxiter=30, tol=0.0, block=block)
    uu, ll = torch.as_tensor(np.array(u)), torch.as_tensor(np.array(lam))
    zc_p, sigma2_p, q_p = pcpd._run_em_nonrigid_lowrank_t(
        torch.as_tensor(src), torch.as_tensor(tgt), uu, ll, 2.0, w=0.1,
        maxiter=30, tol=0.0, block=block)
    np.testing.assert_allclose((uu @ zc_p.T).numpy(),
                               np.asarray(u @ zc.T), atol=1e-5)
    np.testing.assert_allclose(float(sigma2_p), float(sigma2), rtol=1e-4,
                               atol=SIGMA2_FLOOR)
    assert float(q_p) == float(sigma2_p)


@pytest.mark.parametrize("kind", ["nonrigid", "nonrigid_constrained"])
def test_lowrank_registration_matches_reference(kind):
    """registration_cpd with rank=: NonRigidCPD through its whole-EM loop,
    the constrained model through the generic loop, each on its own
    package's factors."""
    src, tgt = _lowrank_pair()
    kw = dict(rank=20) if kind == "nonrigid" \
        else dict(_constrained(len(tgt), 1e-3), rank=20)
    ref = jcpd.registration_cpd(src, tgt, kind, w=0.05, maxiter=20, tol=0.0,
                                **kw)
    out = pcpd.registration_cpd(src, tgt, kind, w=0.05, maxiter=20, tol=0.0,
                                **kw, **CPU)
    assert isinstance(out.transformation, ptf.LowRankNonRigidTransformation)
    np.testing.assert_allclose(_moved(out, src), _moved_ref(ref, src),
                               atol=LOWRANK)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=1e-4, atol=SIGMA2_FLOOR)


def test_v_init_and_sigma2_init_warm_start():
    """tests/test_pyramid.py's warm-start recipe at 300 points: v_init
    projected onto the Nystrom basis with sigma2_init, against the
    reference, and far tighter than a cold start."""
    rng = np.random.default_rng(0)
    src = rng.random((300, 3)).astype(np.float32)
    disp = (0.1 * np.sin(2.0 * src[:, ::-1])).astype(np.float32)
    tgt = src + disp
    kw = dict(rank=40, beta=1.0, lmd=2.0, maxiter=5)
    ref = jcpd.registration_cpd(src, tgt, "nonrigid", v_init=disp,
                                sigma2_init=1e-3, **kw)
    warm = pcpd.registration_cpd(src, tgt, "nonrigid", v_init=disp,
                                 sigma2_init=1e-3, **kw, **CPU)
    cold = pcpd.registration_cpd(src, tgt, "nonrigid", **kw, **CPU)
    np.testing.assert_allclose(_moved(warm, src), _moved_ref(ref, src),
                               atol=LOWRANK)
    r0 = np.sqrt((disp ** 2).sum(1)).mean()
    rw = np.sqrt(((_moved(warm, src) - tgt) ** 2).sum(1)).mean()
    rc = np.sqrt(((_moved(cold, src) - tgt) ** 2).sum(1)).mean()
    assert rw < 0.05 * r0 and rw < 0.1 * rc
    with pytest.raises(ValueError, match="v_init requires rank"):
        pcpd.NonRigidCPD(src, v_init=disp, **CPU)


@pytest.mark.parametrize("rank", [None, 20], ids=["dense", "lowrank"])
def test_step_api_matches_reference(rank):
    """NonRigidCPD.expectation_step + maximization_step(sigma2_p), five
    iterations, the previous sigma2 carried as sigma2_p."""
    src, tgt = _cloud3d(200)
    ref = jcpd.NonRigidCPD(src, rank=rank)
    out = pcpd.NonRigidCPD(src, rank=rank, **CPU)
    if rank is not None:  # the same factors for both
        out._tf_obj = interop.nonrigid_from_reference(
            {k: np.asarray(getattr(ref._tf_obj, k))
             for k in ("zc", "u", "lam")}, **CPU)
    s_ref, s_out = src, torch.as_tensor(src)
    sigma2 = float(jmu.squared_kernel_sum(src, tgt))
    s2_ref = s2_out = sigma2
    for _ in range(5):
        r = ref.maximization_step(tgt, ref.expectation_step(s_ref, tgt,
                                                            s2_ref),
                                  s2_ref)
        o = out.maximization_step(tgt, out.expectation_step(s_out, tgt,
                                                            s2_out),
                                  s2_out)
        s_ref, s2_ref = r.transformation.transform(src), r.sigma2
        s_out, s2_out = o.transformation.transform(src), o.sigma2
    np.testing.assert_allclose(s_out.numpy(), np.asarray(s_ref), atol=1e-5)
    np.testing.assert_allclose(float(s2_out), float(s2_ref), rtol=1e-4)


def test_constrained_priors_accumulate_repeated_indices():
    """p1_tilde and px_tilde as the reference's .at[].add builds them from
    the centred target: a repeated index pair counts twice."""
    src, tgt = _cloud3d(60)
    idx_s, idx_t = np.array([0, 3, 3, 7]), np.array([1, 2, 2, 9])
    ref = jcpd.ConstrainedNonRigidCPD(src, idx_source=idx_s,
                                      idx_target=idx_t)
    out = pcpd.ConstrainedNonRigidCPD(src, idx_source=idx_s,
                                      idx_target=idx_t, **CPU)
    ref._initialize(jnp.asarray(tgt - 0.5))
    out._initialize(torch.as_tensor(tgt - 0.5))
    np.testing.assert_array_equal(out.p1_tilde.numpy(),
                                  np.asarray(ref.p1_tilde))
    np.testing.assert_allclose(out.px_tilde.numpy(),
                               np.asarray(ref.px_tilde), atol=1e-7)
    assert float(out.p1_tilde[3]) == 2.0


# --------------------------------------------------------------------------
# Repairs of the base class
# --------------------------------------------------------------------------

def test_nonrigid_is_never_morton_sorted(monkeypatch):
    """Repair 1 (the reference's test_nonrigid_no_morton_sort_under_tpu_
    condition): with the culled-path threshold lowered to 1 pair and the
    small E-step kernel off, a nonrigid registration is not sorted, so its
    displacement rows stay the caller's; rigid still is."""
    from probreg_tpu_torch.ops import spatial

    src, tgt = _cloud3d(80, seed=4)
    base = _moved(pcpd.registration_cpd(src, tgt, "nonrigid", beta=0.5,
                                        lmd=1.0, maxiter=10, tol=0.0, **CPU),
                  src)
    sorted_calls = []
    order = spatial.morton_order

    def spy(points):
        sorted_calls.append(points.shape[0])
        return order(points)

    monkeypatch.setattr(spatial, "morton_order", spy)
    monkeypatch.setattr(pcfg.config, "culled_estep_min_pairs", 1)
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", 0)
    for kind, kw in [("nonrigid", dict(beta=0.5, lmd=1.0)),
                     ("nonrigid", dict(beta=0.5, lmd=1.0, use_pallas=True)),
                     ("nonrigid_constrained", _constrained(80, 1e-3))]:
        res = pcpd.registration_cpd(src, tgt, kind, maxiter=10, tol=0.0,
                                    **kw, **CPU)
        if kind == "nonrigid":
            np.testing.assert_allclose(_moved(res, src), base, atol=1e-5)
    assert sorted_calls == []
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 100)
    pcpd.registration_cpd(src, tgt, "rigid", maxiter=2, **CPU)
    assert sorted_calls == [80, 80]


def test_streaming_loop_keeps_the_nonrigid_transformation():
    """Repair 2: the streaming loop's frame conversion passes a nonrigid
    transformation through (its field is translation invariant) instead of
    reading an affine ``.b``: a cloud far from the origin registers as it
    does at the origin."""
    src, tgt = _fish()
    near = pcpd.registration_cpd(src, tgt, "nonrigid", maxiter=10, tol=0.0,
                                 **CPU)
    far = pcpd.registration_cpd(src + 30.0, tgt + 30.0, "nonrigid",
                                maxiter=10, tol=0.0, **CPU)
    assert type(far.transformation) is ptf.NonRigidTransformation
    np.testing.assert_allclose(_moved(far, src + 30.0) - 30.0,
                               _moved(near, src), atol=1e-4)


def test_maximization_step_takes_sigma2_p():
    """Repair 3: maximization_step hands sigma2_p to the M-step (the
    nonrigid regularizer lmd sigma2_p I); rigid and affine ignore it."""
    src, tgt = _cloud3d(100)
    ref = jcpd.NonRigidCPD(src)
    out = pcpd.NonRigidCPD(src, **CPU)
    est = ref.expectation_step(src, tgt, 0.05)
    est_p = out.expectation_step(src, tgt, 0.05)
    for sigma2_p in (0.05, 0.5):
        r = ref.maximization_step(tgt, est, sigma2_p)
        o = out.maximization_step(tgt, est_p, sigma2_p)
        np.testing.assert_allclose(_moved(o, src), _moved_ref(r, src),
                                   atol=1e-5)
    a = out.maximization_step(tgt, est_p, 0.05).transformation.w
    b = out.maximization_step(tgt, est_p, 0.5).transformation.w
    assert not torch.allclose(a, b)
    rigid = pcpd.RigidCPD(src, **CPU)
    est_r = rigid.expectation_step(src, tgt, 0.05)
    assert torch.equal(rigid.maximization_step(tgt, est_r, 0.5).sigma2,
                       rigid.maximization_step(tgt, est_r).sigma2)

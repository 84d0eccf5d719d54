"""Rigid and affine CPD of the port (probreg_tpu_torch.cpd) held to the JAX
package.

Both packages register the same numpy clouds on the CPU, through the
branches of the port's paths: the one-launch whole-EM branch (on the CPU
its plain version), the whole-EM dense loop (_run_em_t), the streaming loop
(_run_em) with the one-time Morton sort and the tile-culled E-steps, forced
at test size by lowering the thresholds, and the batch entry point.

Tolerances: the transform agrees to 1e-5 absolute (the per-iteration
moments agree to ~1e-6, test_torch_estep.py). sigma2 and q agree to 5e-3
and 1e-3 relative: at convergence sigma2 is the small difference of large
sums (xx - scale tr(A^T R)), which amplifies summation-order noise, and q
adds dim * n_p / 2 * log(sigma2). Affine and batch results agree to 2e-4
absolute (tests/test_torch_em.py says why).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu import config as jcfg  # noqa: E402
from probreg_tpu import cpd as jcpd  # noqa: E402
from probreg_tpu.ops import estep as jeo  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch.models import transformation as ptf  # noqa: E402
from probreg_tpu_torch.ops import em_cuda as pem  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.utils import interop, se3_op as pso  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's workers torch's default pool
    oversubscribes the cores, and this file's many small products spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ANGLES = np.deg2rad([10.0, -6.0, 15.0])


def _problem(m=600, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    rot = np.asarray(jso.euler2mat(*ANGLES), np.float32)
    tgt = (src @ rot.T + np.array([0.1, -0.05, 0.2], np.float32)
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    return src, tgt, rot


def _assert_same(ref, out, rot):
    np.testing.assert_allclose(out.transformation.rot.numpy(),
                               np.asarray(ref.transformation.rot), atol=1e-5)
    np.testing.assert_allclose(out.transformation.t.numpy(),
                               np.asarray(ref.transformation.t), atol=1e-5)
    np.testing.assert_allclose(float(out.transformation.scale),
                               float(ref.transformation.scale), atol=1e-5)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=5e-3)
    np.testing.assert_allclose(float(out.q), float(ref.q), rtol=1e-3)
    err = float(pso.rotation_angle(out.transformation.rot, rot))
    assert err < 2e-3, err


@pytest.mark.parametrize("update_scale", [True, False])
def test_dense_branch_matches_reference(update_scale):
    src, tgt, rot = _problem()
    ref = jcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-6,
                                update_scale=update_scale)
    out = pcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-6,
                                update_scale=update_scale, device="cpu")
    _assert_same(ref, out, rot)


def test_streaming_culled_branch_matches_reference(monkeypatch):
    """Above transposed_em_max_pairs both packages stream; the port sorts
    once and runs the plain stash E-step (its kernels' CPU version), the
    JAX package on the CPU runs its plain estep_xla."""
    monkeypatch.setattr(jcfg.config, "transposed_em_max_pairs", 1000)
    for k, v in [("transposed_em_max_pairs", 1000),
                 ("culled_estep_min_pairs", 1000),
                 ("small_estep_max_pairs", 0),
                 ("tile_m", 128), ("tile_n", 128)]:
        monkeypatch.setattr(pcfg.config, k, v)
    calls, frac = [], []
    orig = pec.stash_estep_plain

    def spy(ys, xs, scal, mask, tile_m, tile_n, *branch):
        calls.append(1)
        frac.append(float(mask.float().mean()))
        return orig(ys, xs, scal, mask, tile_m, tile_n, *branch)

    monkeypatch.setattr(pec, "stash_estep_plain", spy)
    src, tgt, rot = _problem()
    ref = jcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-6)
    out = pcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-6, device="cpu")
    _assert_same(ref, out, rot)
    assert len(calls) > 5
    assert frac[0] == 1.0 and frac[-1] < 1.0, frac  # dense, then culled


def test_run_em_t_with_initial_params_matches_reference():
    src, tgt, _ = _problem(400, seed=2)
    init_rot = np.asarray(jso.euler2mat(0.05, 0.0, 0.1), np.float32)
    init = np.concatenate([init_rot.ravel(), [0.02, 0.0, -0.01], [1.0]]
                          ).astype(np.float32)
    ref = jcpd._run_em_t(src, tgt, init, kind="rigid", w=0.1, maxiter=30,
                         tol=1e-6, default_init=False, sigma2_init=0.5)
    out = pcpd._run_em_t(torch.from_numpy(src), torch.from_numpy(tgt),
                         init, kind="rigid", w=0.1, maxiter=30, tol=1e-6,
                         sigma2_init=0.5)
    for a, b in zip(ref[:3], out[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=5e-3)
    # The same start through the object API.
    res = pcpd.registration_cpd(
        src, tgt, w=0.1, maxiter=30, tol=1e-6, device="cpu",
        tf_init_params={"rot": init_rot, "t": init[9:12]}, sigma2_init=0.5)
    np.testing.assert_allclose(res.transformation.rot.numpy(),
                               np.asarray(ref[0]), atol=1e-5)


def test_public_estep_mstep_match_reference():
    src, tgt, _ = _problem(300, seed=4)
    jr = jcpd.RigidCPD(src)
    pr = pcpd.RigidCPD(src, device="cpu")
    je = jr.expectation_step(src, tgt, 0.3, 0.1)
    pe = pr.expectation_step(src, tgt, 0.3, 0.1)
    for a, b in zip(je, pe):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    jm = jr.maximization_step(tgt, je)
    pm = pr.maximization_step(tgt, pe)
    np.testing.assert_allclose(pm.transformation.rot.numpy(),
                               np.asarray(jm.transformation.rot), atol=1e-5)
    np.testing.assert_allclose(pm.transformation.t.numpy(),
                               np.asarray(jm.transformation.t), atol=1e-5)
    np.testing.assert_allclose(float(pm.sigma2), float(jm.sigma2), rtol=1e-4)
    np.testing.assert_allclose(float(pm.q), float(jm.q), rtol=1e-4)


def test_rigid_maximization_step_matches_reference():
    src, tgt, _ = _problem(300, seed=6)
    jmom = jeo.estep_xla(src, tgt, np.float32(0.2), 0.0)
    pmom = pcpd.EstepMoments(*[torch.from_numpy(np.array(a)) for a in jmom])
    for us in (True, False):
        ref = jcpd.rigid_maximization_step(src, jmom, us)
        out = pcpd.rigid_maximization_step(torch.from_numpy(src), pmom, us)
        np.testing.assert_allclose(out.transformation.rot.numpy(),
                                   np.asarray(ref.transformation.rot),
                                   atol=1e-6)
        np.testing.assert_allclose(float(out.transformation.scale),
                                   float(ref.transformation.scale),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                                   rtol=1e-4)


def test_carry_across_rigid_transformation():
    """A JAX RigidTransformation's parameters, as numpy, give a port
    transformation that moves points the same way, and compose and invert
    the same way."""
    from probreg_tpu.models import transformation as jtf

    rot = np.asarray(jso.euler2mat(0.3, -0.2, 0.5), np.float32)
    jt = jtf.RigidTransformation(rot, np.array([0.5, -1.0, 2.0]), 1.3)
    params = {k: np.asarray(getattr(jt, k)) for k in ("rot", "t", "scale")}
    pt = interop.rigid_from_reference(params, device="cpu")
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(pt.transform(pts).numpy(),
                               np.asarray(jt.transform(pts)), atol=1e-5)
    np.testing.assert_allclose(pt.inverse().transform(pts).numpy(),
                               np.asarray(jt.inverse().transform(pts)),
                               atol=1e-5)
    np.testing.assert_allclose((pt * pt).transform(pts).numpy(),
                               np.asarray((jt * jt).transform(pts)),
                               atol=1e-4)


def test_carry_across_config():
    fields = dataclasses.asdict(jcfg.config)
    fields["small_estep_max_pairs"] = 12345
    # The merged-stash knob selects a kernel in both packages, so it
    # carries across like the other dispatch knobs.
    fields["use_merged_stash"] = True
    cfg = interop.config_from_reference(fields)
    assert cfg.use_merged_stash is True
    assert pcfg.Config().use_merged_stash == jcfg.Config().use_merged_stash
    assert cfg.small_estep_max_pairs == 12345
    assert cfg.transposed_em_max_pairs == jcfg.config.transposed_em_max_pairs
    assert cfg.culled_estep_min_pairs == jcfg.config.culled_estep_min_pairs
    assert cfg.tile_n == pcfg.Config().tile_n
    # The whole-EM and two-pass knobs carry over with the reference's values.
    for knob in ("use_fused_em", "fused_em_max_pairs", "use_pallas",
                 "pallas_min_pairs"):
        assert getattr(cfg, knob) == getattr(jcfg.config, knob), knob
        assert getattr(pcfg.Config(), knob) == getattr(jcfg.Config(), knob)
    # The CPD stash cap carries into stash_max_bytes, which estep_auto and
    # the sharded culled runners read with the reference's contract.
    assert cfg.stash_max_bytes == jcfg.config.cpd_stash_max_bytes
    fields["cpd_stash_max_bytes"] = 12345
    assert interop.config_from_reference(fields).stash_max_bytes == 12345
    # The BCPD stash cap keeps the reference's name and default, and
    # carries across as it is.
    assert (cfg.bcpd_stash_max_bytes == pcfg.Config().bcpd_stash_max_bytes
            == jcfg.Config().bcpd_stash_max_bytes == 2 << 30)
    fields["bcpd_stash_max_bytes"] = 4096
    assert interop.config_from_reference(fields).bcpd_stash_max_bytes == 4096
    assert cfg.dtype == torch.float32 and cfg.device == "cuda"


def test_se3_helpers_match_reference():
    r = pso.euler2mat(*ANGLES)
    np.testing.assert_allclose(r.numpy(), np.asarray(jso.euler2mat(*ANGLES)),
                               atol=1e-6)
    np.testing.assert_allclose(pso.mat2euler(r).numpy(), ANGLES, atol=1e-5)
    r2 = pso.euler2mat(0.0, 0.0, 0.1)
    np.testing.assert_allclose(float(pso.rotation_angle(r, r2)),
                               float(jso.rotation_angle(np.asarray(r),
                                                        np.asarray(r2))),
                               atol=1e-6)


def test_unported_kinds_raise():
    """The nonrigid kinds are ported (tests/test_torch_cpd_nonrigid.py);
    the batch entry point refuses them as the reference's does, and an
    unknown kind is a ValueError."""
    src, tgt, _ = _problem(50)
    with pytest.raises(ValueError, match="rigid.*affine"):
        pcpd.registration_cpd_batch(src[None], tgt[None], "nonrigid",
                                    device="cpu")
    with pytest.raises(ValueError, match="Unknown"):
        pcpd.registration_cpd(src, tgt, "bogus", device="cpu")


def test_transformation_defaults_follow_config_device(monkeypatch):
    monkeypatch.setattr(pcfg.config, "device", "cpu")
    tr = ptf.RigidTransformation()
    assert tr.device.type == "cpu"
    assert torch.equal(tr.rot, torch.eye(3))


# --------------------------------------------------------------------------
# Affine, batches, dispatch
# --------------------------------------------------------------------------

def _affine_problem(m=400, seed=1):
    src, tgt, _ = _problem(m, seed)
    return src, (tgt * np.float32([1.15, 0.9, 1.05])).astype(np.float32)


def _assert_affine_same(ref, out):
    np.testing.assert_allclose(out.transformation.b.numpy(),
                               np.asarray(ref.transformation.b), atol=2e-4)
    np.testing.assert_allclose(out.transformation.t.numpy(),
                               np.asarray(ref.transformation.t), atol=2e-4)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=5e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_affine_registration_matches_reference(monkeypatch, fused):
    """Through the one-launch branch and through the dense loop."""
    monkeypatch.setattr(pcfg.config, "use_fused_em", fused)
    src, tgt = _affine_problem()
    ref = jcpd.registration_cpd(src, tgt, "affine", w=0.05, maxiter=40,
                                tol=1e-6)
    out = pcpd.registration_cpd(src, tgt, "affine", w=0.05, maxiter=40,
                                tol=1e-6, device="cpu")
    assert isinstance(out.transformation, ptf.AffineTransformation)
    _assert_affine_same(ref, out)
    moved = out.transformation.transform(src).numpy()
    assert np.abs(moved - tgt).max() < 0.1


def test_affine_streaming_branch_and_init_params_match_reference(monkeypatch):
    monkeypatch.setattr(jcfg.config, "transposed_em_max_pairs", 1000)
    for k, v in [("transposed_em_max_pairs", 1000),
                 ("culled_estep_min_pairs", 1000),
                 ("small_estep_max_pairs", 0),
                 ("tile_m", 128), ("tile_n", 128)]:
        monkeypatch.setattr(pcfg.config, k, v)
    src, tgt = _affine_problem()
    init = {"b": np.eye(3, dtype=np.float32) * 1.02,
            "t": np.float32([0.05, 0.0, 0.1])}
    ref = jcpd.registration_cpd(src, tgt, "affine", maxiter=30, tol=1e-6,
                                tf_init_params=init)
    out = pcpd.registration_cpd(src, tgt, "affine", maxiter=30, tol=1e-6,
                                tf_init_params=init, device="cpu")
    _assert_affine_same(ref, out)
    # Below the streaming threshold the same start runs the dense loop.
    monkeypatch.setattr(jcfg.config, "transposed_em_max_pairs", 1 << 28)
    monkeypatch.setattr(pcfg.config, "transposed_em_max_pairs", 1 << 28)
    ref = jcpd.registration_cpd(src, tgt, "affine", maxiter=30, tol=1e-6,
                                tf_init_params=init)
    out = pcpd.registration_cpd(src, tgt, "affine", maxiter=30, tol=1e-6,
                                tf_init_params=init, device="cpu")
    _assert_affine_same(ref, out)


@pytest.mark.parametrize("kind", ["rigid", "affine"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_batch_registration_matches_reference(monkeypatch, kind, ragged,
                                              fused):
    """On the CPU the JAX package runs its vmapped dense loop; the port
    runs the whole-EM kernel's plain version (fused) or its own dense loop
    pair by pair."""
    monkeypatch.setattr(pcfg.config, "use_fused_em", fused)
    sizes = [(120, 100), (90, 120), (120, 120)] if ragged else [(100, 110)] * 3
    srcs, tgts = [], []
    for seed, (m, n) in enumerate(sizes):
        src, tgt, _ = _problem(max(m, n), seed)
        if kind == "affine":
            tgt = (tgt * np.float32([1.1, 0.95, 1.0])).astype(np.float32)
        srcs.append(src[:m])
        tgts.append(tgt[:n])
    if not ragged:
        srcs, tgts = np.stack(srcs), np.stack(tgts)
    kw = dict(w=0.05, maxiter=25, tol=1e-5)
    ref = jcpd.registration_cpd_batch(srcs, tgts, kind, **kw)
    out = pcpd.registration_cpd_batch(srcs, tgts, kind, device="cpu", **kw)
    assert len(out) == len(ref) == 3
    for r, o in zip(ref, out):
        if kind == "affine":
            _assert_affine_same(r, o)
            continue
        np.testing.assert_allclose(
            (o.transformation.rot * o.transformation.scale).numpy(),
            np.asarray(r.transformation.rot * r.transformation.scale),
            atol=2e-4)
        np.testing.assert_allclose(o.transformation.t.numpy(),
                                   np.asarray(r.transformation.t), atol=2e-4)
        np.testing.assert_allclose(float(o.sigma2), float(r.sigma2),
                                   rtol=5e-3)
    # Each pair of the batch equals its own single registration (the masked
    # dense loop sums over the padded length, hence not bit for bit).
    one = pcpd.registration_cpd(srcs[1], tgts[1], kind, device="cpu", **kw)
    lin = "b" if kind == "affine" else "rot"
    np.testing.assert_allclose(getattr(out[1].transformation, lin).numpy(),
                               getattr(one.transformation, lin).numpy(),
                               atol=1e-5)


def _spy_fused(monkeypatch):
    calls = []
    orig = pem.run_em_cpd_fused_batch

    def spy(*a, **k):
        calls.append(k.get("kind"))
        return orig(*a, **k)

    monkeypatch.setattr(pem, "run_em_cpd_fused_batch", spy)
    return calls


@pytest.mark.parametrize("kind", ["rigid", "affine"])
def test_small_3d_pair_reaches_the_whole_em_kernel(monkeypatch, kind):
    calls = _spy_fused(monkeypatch)
    src, tgt, _ = _problem(80)
    pcpd.registration_cpd(src, tgt, kind, maxiter=3, device="cpu")
    assert calls == [kind]
    pcpd.registration_cpd_batch([src, src[:50]], [tgt[:60], tgt], kind,
                                maxiter=3, device="cpu")
    assert calls == [kind, kind]


@pytest.mark.parametrize("bypass", ["tf_init_params", "sigma2_init", "dim2",
                                    "use_pallas_false", "use_fused_em_false",
                                    "max_pairs", "dims"])
def test_whole_em_kernel_is_bypassed(monkeypatch, bypass):
    """Each of the reference's conditions (cpd.py:958-963) sends the pair
    to the dense loop instead."""
    calls = _spy_fused(monkeypatch)
    src, tgt, _ = _problem(80)
    kw = {}
    if bypass == "tf_init_params":
        kw["tf_init_params"] = {"t": np.zeros(3, np.float32)}
    elif bypass == "sigma2_init":
        kw["sigma2_init"] = 0.5
    elif bypass == "dim2":
        src, tgt = src[:, :2].copy(), tgt[:, :2].copy()
    elif bypass == "use_pallas_false":
        kw["use_pallas"] = False
    elif bypass == "use_fused_em_false":
        monkeypatch.setattr(pcfg.config, "use_fused_em", False)
    elif bypass == "max_pairs":
        monkeypatch.setattr(pcfg.config, "fused_em_max_pairs", 80 * 80 - 1)
    else:
        monkeypatch.setattr(pem, "fused_dims_ok", lambda m, n: False)
    for kind in ("rigid", "affine"):
        res = pcpd.registration_cpd(src, tgt, kind, maxiter=3, device="cpu",
                                    **kw)
        assert bool(torch.isfinite(res.sigma2))
    if bypass not in ("tf_init_params", "sigma2_init"):
        batch_kw = {"use_pallas": False} if bypass == "use_pallas_false" else {}
        pcpd.registration_cpd_batch([src, src[:50]], [tgt, tgt], maxiter=3,
                                    device="cpu", **batch_kw)
    assert calls == []


@pytest.mark.parametrize("use_pallas,branch", [(None, "stash"),
                                               (True, "two_pass"),
                                               (False, "xla")])
def test_use_pallas_pins_the_streaming_estep(monkeypatch, use_pallas, branch):
    """None: the sorted stash E-step; True: the two-pass E-step on the
    sorted clouds; False: no kernel branch at all. All three register the
    same pair as the reference."""
    monkeypatch.setattr(jcfg.config, "transposed_em_max_pairs", 1000)
    for k, v in [("transposed_em_max_pairs", 1000),
                 ("culled_estep_min_pairs", 1000),
                 ("tile_m", 128), ("tile_n", 128)]:
        monkeypatch.setattr(pcfg.config, k, v)
    taken = []
    for name, fn in [("small", "estep_small_plain"),
                     ("stash", "stash_estep_plain"),
                     ("two_pass", "fused_estep_plain")]:
        orig = getattr(pec, fn)
        monkeypatch.setattr(pec, fn, lambda *a, _o=orig, _n=name:
                            taken.append(_n) or _o(*a))
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", 0)
    src, tgt, rot = _problem(400)
    ref = jcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-6)
    out = pcpd.registration_cpd(src, tgt, maxiter=50, tol=1e-6, device="cpu",
                                use_pallas=use_pallas)
    _assert_same(ref, out, rot)
    assert set(taken) == (set() if branch == "xla" else {branch})
    monkeypatch.setattr(pcfg.config, "small_estep_max_pairs", 1 << 20)
    # The public E-step follows the same pin.
    taken.clear()
    reg = pcpd.RigidCPD(src, device="cpu", use_pallas=use_pallas)
    reg.expectation_step(src, tgt, 0.3, 0.1)
    assert taken == {None: ["small"], True: ["two_pass"], False: []}[use_pallas]


def test_callbacks_and_multistart_are_named_as_not_ported():
    """Callbacks and n_starts were the last raises of CPD; both run now.
    What the reference refuses stays refused, with its ValueError."""
    src, tgt, _ = _problem(50)
    seen = []
    pcpd.registration_cpd(src, tgt, maxiter=4, tol=0.0,
                          callbacks=[seen.append], device="cpu")
    assert len(seen) == 4
    got = pcpd.registration_cpd(src, tgt, n_starts=4, device="cpu")
    want = jcpd.registration_cpd(src, tgt, n_starts=4)
    np.testing.assert_allclose(got.transformation.rot.numpy(),
                               np.asarray(want.transformation.rot),
                               atol=1e-5)
    with pytest.raises(ValueError, match="no-callback"):
        pcpd.registration_cpd(src, tgt, n_starts=4, callbacks=[print],
                              device="cpu")
    with pytest.raises(ValueError, match="rigid batches only"):
        pcpd.registration_cpd_batch(src[None], tgt[None], "affine",
                                    n_starts=4, device="cpu")
    with pytest.raises(ValueError, match="rigid.*affine"):
        pcpd.registration_cpd_batch(src[None], tgt[None], "nonrigid",
                                    device="cpu")
    # The reference's full signature is accepted when no callback is given.
    res = pcpd.registration_cpd(src, tgt, "rigid", 0.0, 5, 1e-3, [], False, 4,
                                device="cpu")
    assert bool(torch.isfinite(res.q))


def test_carry_across_affine_transformation_and_pad_ragged():
    from probreg_tpu.models import transformation as jtf
    from probreg_tpu.utils import interop as jinterop

    b = (np.eye(3) + np.random.default_rng(2).normal(0, 0.1, (3, 3))
         ).astype(np.float32)
    jt = jtf.AffineTransformation(b, np.array([0.5, -1.0, 2.0]))
    pt = interop.affine_from_reference(
        {k: np.asarray(getattr(jt, k)) for k in ("b", "t")}, device="cpu")
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(pt.transform(pts).numpy(),
                               np.asarray(jt.transform(pts)), atol=1e-5)
    clouds = [pts[:20], pts[:50], pts[:7]]
    ref_pts, ref_mask = jinterop.pad_ragged(clouds)
    out_pts, out_mask = interop.pad_ragged(clouds, device="cpu")
    np.testing.assert_array_equal(out_pts.numpy(), ref_pts)
    np.testing.assert_array_equal(out_mask.numpy(), ref_mask)

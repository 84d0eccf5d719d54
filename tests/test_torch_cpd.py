"""Rigid CPD of the port (probreg_tpu_torch.cpd) held to the JAX package.

Both packages register the same numpy clouds on the CPU, through both
branches of the port's main path: the whole-EM dense loop (_run_em_t) and
the streaming loop (_run_em) with the one-time Morton sort and the tile-
culled stash E-step, forced at test size by lowering the thresholds.

Tolerances: the transform agrees to 1e-5 absolute (the per-iteration
moments agree to ~1e-6, test_torch_estep.py). sigma2 and q agree to 5e-3
and 1e-3 relative: at convergence sigma2 is the small difference of large
sums (xx - scale tr(A^T R)), which amplifies summation-order noise, and q
adds dim * n_p / 2 * log(sigma2).
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
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.utils import interop, se3_op as pso  # noqa: E402

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

    def spy(ys, xs, scal, mask, tile_m, tile_n):
        calls.append(1)
        frac.append(float(mask.float().mean()))
        return orig(ys, xs, scal, mask, tile_m, tile_n)

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
    assert "use_merged_stash" in fields  # a TPU-only knob: left out
    cfg = interop.config_from_reference(fields)
    assert not hasattr(cfg, "use_merged_stash")
    assert cfg.small_estep_max_pairs == 12345
    assert cfg.transposed_em_max_pairs == jcfg.config.transposed_em_max_pairs
    assert cfg.culled_estep_min_pairs == jcfg.config.culled_estep_min_pairs
    assert cfg.tile_n == pcfg.Config().tile_n
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
    src, tgt, _ = _problem(50)
    with pytest.raises(NotImplementedError, match="affine"):
        pcpd.registration_cpd(src, tgt, "affine", device="cpu")
    with pytest.raises(ValueError, match="Unknown"):
        pcpd.registration_cpd(src, tgt, "bogus", device="cpu")


def test_transformation_defaults_follow_config_device(monkeypatch):
    monkeypatch.setattr(pcfg.config, "device", "cpu")
    tr = ptf.RigidTransformation()
    assert tr.device.type == "cpu"
    assert torch.equal(tr.rot, torch.eye(3))

"""The port's DeformableKinematicFilterReg held to the JAX package: the
dual-quaternion module, the se3 jacobians, the skinning model and its
carry-across, the blended-skinning Gauss-Newton M-step on an exactly
singular (colinear) 30-point bar and on a regular 30-point cloud, the
whole-EM loop and the host loop (held to the reference's loop, which the
reference's own tests hold to its host loop).

Both packages take the same seeded numpy clouds and skinning weights on
the CPU. Tolerances: dual-quaternion functions and jacobians 1e-6; the
M-step's dual quaternions 1e-5, its sigma2 and q 1e-5 relative (q
absolute 1e-8 once it is f32 noise; the
singular system is solved through an SVD with the reference's rcond cut
in both); the EM loops at a fixed depth (tol 0), dual quaternions 2e-5,
q 1e-4 relative (absolute 1e-8 at f32 noise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from probreg_tpu import filterreg as jfr  # noqa: E402
from probreg_tpu.models import transformation as jtf  # noqa: E402
from probreg_tpu.utils import dualquat as jdq  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu.utils.datagen import blobby_surface  # noqa: E402
from probreg_tpu_torch import filterreg as pfr  # noqa: E402
from probreg_tpu_torch.models import transformation as ptf  # noqa: E402
from probreg_tpu_torch.utils import dualquat as pdq  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in the other port test files under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return np.asarray(a)


@jax.jit
def _dualquat_ref(tw, pts, w):
    """The reference's outputs of every dual-quaternion function, in one
    compiled program (eager, each operation would compile on its own)."""
    q = jdq.from_twist(tw)
    q1 = jnp.roll(q, 1, axis=0) * -1.0               # antipodes to flip
    return (q, jdq.mul(q, q1), jdq.dlb2(w, q, 1 - w, q1),
            jdq.transform_point(q, pts), jdq.transform_point(q[2], pts),
            jdq.normalize(q1 * 3.0), jdq.conj(q[:, :4]),
            jdq.to_rot_trans(q)[1], jdq.from_rot_trans(q[:, :4], pts),
            jdq.identity(), jso.diff_x_from_twist(pts),
            jso.diff_rot_from_quaternion(w[:4] - 0.5))


def test_dualquat_and_jacobians_match_reference():
    rng = np.random.default_rng(0)
    tw = (rng.standard_normal((6, 6)) * 0.4).astype(np.float32)
    tw[0, :3] = 0.0                                   # the identity branch
    pts = rng.standard_normal((6, 3)).astype(np.float32)
    w = rng.uniform(size=6).astype(np.float32)
    q = pdq.from_twist(_t(tw))
    q1 = torch.roll(q, 1, 0) * -1.0
    ours = (q, pdq.mul(q, q1), pdq.dlb2(_t(w), q, _t(1 - w), q1),
            pdq.transform_point(q, _t(pts)),
            pdq.transform_point(q[2], _t(pts)), pdq.normalize(q1 * 3.0),
            pdq.conj(q[:, :4]), pdq.to_rot_trans(q)[1],
            pdq.from_rot_trans(q[:, :4], _t(pts)), pdq.identity(),
            pso.diff_x_from_twist(_t(pts)),
            pso.diff_rot_from_quaternion(_t(w[:4] - 0.5)))
    for a, b in zip(ours, _dualquat_ref(tw, pts, w)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)
    assert pso.diff_rot_from_quaternion(q[:2, :4]).shape == (2, 4, 3, 3)
    assert pfr.dualquat_from_twist is pdq.from_twist


def _bar(n=30):
    """examples/filterreg_deformable.py's bent bar: colinear points, so
    the rotation about the bar is unobservable."""
    pts = np.stack([np.linspace(-1.0, 1.0, n), np.zeros(n), np.zeros(n)],
                   1).astype(np.float32)
    wr = ((pts[:, 0] + 1.0) / 2.0).astype(np.float32)
    return pts, np.tile([[0, 1]], (n, 1)), np.stack([1 - wr, wr], 1)


def _surface(n=300):
    pts = blobby_surface(n, seed=6).astype(np.float32)
    wr = np.clip(0.5 + pts[:, 0] / (2 * np.abs(pts[:, 0]).max()), 0.0, 1.0)
    return pts, np.tile([[0, 1]], (n, 1)), np.stack(
        [1 - wr, wr], 1).astype(np.float32)


def _regular():
    """A 30-point piece of the surface: the bar's shapes, so the reference's
    compiled loop serves both."""
    return tuple(a[::10] for a in _surface())


GT = np.array([[0.0, 0, 0, 0, 0, 0], [0.0, 0.05, 0.2, 0.02, 0.1, -0.03]],
              np.float32)
SIG = 0.01
EM = dict(update_sigma2=True, w=0.0, tol=0.0, min_sigma2=1e-4)


def _target(pts, pair, val):
    model = jtf.DeformableKinematicModel(
        jdq.from_twist(jnp.asarray(GT)),
        jtf.DeformableKinematicModel.SkinningWeight(pair, val))
    return _np(model.transform(pts)).astype(np.float32)


def _ref_em(pts, tgt, pair, val, maxiter):
    """The reference's ``_run_em_deformable`` from the identity: every
    call has the same shapes and static arguments, so one compiled
    program serves the whole file."""
    return jfr._run_em_deformable(
        jnp.asarray(pts), jnp.asarray(tgt), jnp.tile(jdq.identity(), (2, 1)),
        jnp.asarray(pair), jnp.asarray(val), np.float32(SIG),
        maxiter=maxiter, **EM)


@pytest.mark.parametrize("cloud", [_bar, _regular])
def test_deformable_mstep_matches_reference(cloud):
    """One EM iteration from the identity: the port's E-step moments and
    ``_deformable_mstep`` against the reference's loop at depth 1; on the
    colinear bar the normal matrix is exactly singular."""
    pts, pair, val = cloud()
    tgt = _target(pts, pair, val)
    ref = _ref_em(pts, tgt, pair, val, 1)
    sig = torch.tensor(SIG)
    m0, m1, m2, _ = pfr.gto.filterreg_moments(
        _t(pts) / torch.sqrt(sig), _t(tgt) / torch.sqrt(sig), _t(tgt), None,
        need_m2=True)
    got = pfr._deformable_mstep(_t(pts), m0, m1, m2,
                                pdq.identity().repeat(2, 1),
                                torch.from_numpy(pair), _t(val), sig, 0.0)
    np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), atol=1e-5)
    assert not np.allclose(got[0].numpy()[1], [1, 0, 0, 0, 0, 0, 0, 0])
    assert max(float(got[1]), EM["min_sigma2"]) == pytest.approx(
        float(ref[1]), rel=1e-5)
    # q ends within rounding of 0 on the bar (its 1e-9 is f32 noise).
    assert float(got[2]) == pytest.approx(float(ref[2]), rel=1e-5, abs=1e-8)


def test_deformable_whole_em_and_host_loop_match_reference():
    """``_run_em_deformable`` at a fixed depth, the entry through
    ``DeformableKinematicFilterReg.registration`` (its weights carried
    with ``interop.deformable_from_reference``), and the host loop taken
    with callbacks, chunks of 4, against the reference's loop (whose own
    tests hold its host loop to it)."""
    pts, pair, val = _regular()
    tgt = _target(pts, pair, val)
    ref = _ref_em(pts, tgt, pair, val, 6)
    got = pfr._run_em_deformable(_t(pts), _t(tgt),
                                 pdq.identity().repeat(2, 1),
                                 torch.from_numpy(pair), _t(val), SIG,
                                 maxiter=6, **EM)
    np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), atol=2e-5)
    # The target is an exact skinned copy: q ends at f32 noise.
    assert float(got[2]) == pytest.approx(float(ref[2]), rel=1e-4, abs=1e-8)
    model = interop.deformable_from_reference(jtf.DeformableKinematicModel(
        jnp.tile(jdq.identity(), (2, 1)),
        jtf.DeformableKinematicModel.SkinningWeight(pair, val)),
        device="cpu")
    reg = pfr.DeformableKinematicFilterReg(pts, model.weights, SIG,
                                           update_sigma2=True, device="cpu")
    out = reg.registration(tgt, maxiter=6, tol=0.0)
    np.testing.assert_allclose(out.transformation.dualquats.numpy(),
                               got[0].numpy(), atol=1e-6)
    seen = []
    host = pfr.DeformableKinematicFilterReg(pts, model.weights, SIG,
                                            update_sigma2=True, device="cpu")
    host.set_callbacks([seen.append])
    host.registration(tgt, maxiter=6, tol=0.0, callback_chunk=4)
    assert len(seen) == 6
    np.testing.assert_allclose(seen[-1].dualquats.numpy(), _np(ref[0]),
                               atol=2e-5)

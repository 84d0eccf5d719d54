"""The sequence trackers of the port (probreg_tpu_torch.tracking) held to
the JAX package's (probreg_tpu.tracking) on the same frames, on the CPU.

Frames: horse[::16] (184 points) moved by a fixed drift of a few degrees
and millimetres per frame (rigid), or turned and deformed by a smooth
field (non-rigid). Tolerances: world poses within 1e-4 (rotation entries,
and translations relative to the extent); the non-rigid template moved
onto each frame within 1e-4 of the extent, and the VI state carried from
one frame to the next within 1e-4 of its largest entry. Each solve starts
from the last one's result, so a sequence compounds the packages'
rounding; the rigid solves settle it, the warm-started BCPD VI amplifies
it (test_nonrigid_tracker_matches_reference says how far).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu import tracking as jtr  # noqa: E402
from probreg_tpu_torch import tracking as ptr  # noqa: E402
from probreg_tpu_torch.utils import io as pio  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rot(deg):
    return pso.euler2mat(*np.deg2rad(deg)).double().numpy()


@pytest.fixture(scope="module")
def template():
    pts = pio.read_point_cloud(os.path.join(_ROOT, "data", "horse.ply"))
    return pts[::16].astype(np.float32)


def _rigid_frames(base, n=5, step=(1.0, -0.5, 2.0), shift=0.005):
    """``base`` and n - 1 frames, each moved by ``step`` degrees and
    ``shift`` along (1, -1, 0.5) from the last; with the true poses."""
    d_rot, d_t = _rot(step), shift * np.array([1.0, -1.0, 0.5])
    frames, poses = [base], [(np.eye(3), np.zeros(3))]
    for _ in range(n - 1):
        r, t = poses[-1]
        poses.append((d_rot @ r, d_rot @ t + d_t))
        frames.append((base @ poses[-1][0].T + poses[-1][1]).astype(
            np.float32))
    return frames, poses


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _track(trk, frames):
    return [trk.update(f) for f in frames]


def _same_poses(got, want, extent):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.rot.numpy(), np.asarray(w.rot),
                                   atol=1e-4)
        np.testing.assert_allclose(g.t.numpy(), np.asarray(w.t),
                                   atol=1e-4 * extent)


@pytest.mark.parametrize("algorithm", ["cpd", "filterreg", "icp"])
def test_rigid_tracker_matches_reference(template, algorithm):
    frames, _ = _rigid_frames(template)
    kw = dict(algorithm=algorithm, maxiter=30, tol=1e-6)
    want = _track(jtr.RigidTracker(**kw), frames)
    trk = ptr.RigidTracker(**kw, **CPU)
    got = _track(trk, frames)
    extent = float(np.ptp(template, 0).max())
    _same_poses(got, want, extent)
    assert trk.n_frames == len(frames)
    # The poses compared moved with the drift.
    assert np.abs(np.asarray(want[-1].rot) - np.eye(3)).max() > 0.1


def test_keyframe_mode_rekeys_as_reference(template):
    """Frames with 2e-3 noise each: every keyframe solve leaves a residual
    of ~3e-3, so a threshold of 1e-3 forces a re-key at every frame and
    'auto' (4x the first residual) none; both packages count the same and
    give the same poses through the re-keys."""
    frames, _ = _rigid_frames(template, step=(2.0, 1.0, 3.0))
    rng = np.random.default_rng(0)
    frames = frames[:1] + [(f + 2e-3 * rng.standard_normal(f.shape)).astype(
        np.float32) for f in frames[1:]]
    for rekey, count in ((1e-3, len(frames) - 1), ("auto", 0)):
        kw = dict(mode="keyframe", maxiter=30, tol=1e-6, rekey_rmse=rekey)
        ref = jtr.RigidTracker(**kw)
        want = _track(ref, frames)
        trk = ptr.RigidTracker(**kw, **CPU)
        got = _track(trk, frames)
        assert trk.n_rekeys == ref.n_rekeys == count
        _same_poses(got, want, float(np.ptp(template, 0).max()))


def _deforming(template):
    frames = [template]
    for k in range(1, 5):
        moved = template @ _rot([4.0 * k, -2.0 * k, 3.0 * k]).T
        bend = 0.004 * k * np.sin(3.0 * template[:, [1]] / np.ptp(template))
        frames.append((moved + bend).astype(np.float32))
    return frames


def _spy(monkeypatch, module):
    """Record the keyword arguments of every _registration_bcpd_impl call
    that ``module``'s tracker makes."""
    calls, impl = [], module._registration_bcpd_impl

    def spy(*a, **k):
        calls.append(k)
        return impl(*a, **k)

    monkeypatch.setattr(module, "_registration_bcpd_impl", spy)
    return calls


def test_nonrigid_tracker_matches_reference(template, monkeypatch):
    """maxiter 12, tol 0, rank 16: the first solve (cold) and the whole VI
    state the tracker carries into the second (inflated, floored), against
    the reference's; the warm solves that follow are chaotic at this depth
    (from one carried state both packages' f32 runs part from a float64 run
    by ~1e-7 of the extent after two iterations, ~1e-5 after four and
    ~5e-3 after twelve), so they are compared on a sequence at maxiter 4,
    where each moves the template by 15-18 % of the extent."""
    from probreg_tpu import bcpd as jb
    from probreg_tpu_torch import bcpd as pb

    frames = _deforming(template)
    kw = dict(maxiter=12, tol=0.0, lmd=10.0, rank=16)
    calls_j, calls_p = _spy(monkeypatch, jb), _spy(monkeypatch, pb)
    ref = jtr.NonrigidTracker(**kw)
    trk = ptr.NonrigidTracker(**kw, **CPU)
    for f in frames[:3]:
        want, got = ref.update(f), trk.update(f)
        if ref.n_frames == 2:
            extent = float(np.ptp(f, 0).max())
            moved_j = np.asarray(want.transform(template))
            assert np.abs(moved_j - template).max() > 1e-2 * extent
            np.testing.assert_allclose(got.transform(template).numpy(),
                                       moved_j, atol=1e-4 * extent)
    warm_j, warm_p = calls_j[1], calls_p[1]
    for name in ("rot", "t", "scale"):
        assert _rel(warm_p["tf_init_params"][name],
                    warm_j["tf_init_params"][name]) < 1e-4, name
    for name in ("v_init", "sigma2_init", "_alpha_init", "_sdiag_init"):
        assert _rel(warm_p[name], warm_j[name]) < 1e-4, name
    monkeypatch.undo()

    kw = dict(kw, maxiter=4)
    want = _track(jtr.NonrigidTracker(**kw), frames)
    trk = ptr.NonrigidTracker(**kw, **CPU)
    got = _track(trk, frames)
    assert trk.n_frames == len(frames)
    for g, w, f in zip(got[2:], want[2:], frames[2:]):
        extent = float(np.ptp(f, 0).max())
        moved_j = np.asarray(w.transform(template))
        assert np.abs(moved_j - template).max() > 1e-1 * extent
        np.testing.assert_allclose(g.transform(template).numpy(), moved_j,
                                   atol=1e-4 * extent)


def test_guards_match_reference():
    cases = [
        lambda m: m.RigidTracker(algorithm="nope"),
        lambda m: m.RigidTracker(mode="nope"),
        lambda m: m.RigidTracker(tf_init_params={}),
        lambda m: m.RigidTracker(sigma2_init=1.0),
        lambda m: m.RigidTracker(algorithm="filterreg", sigma2=1.0),
        lambda m: m.RigidTracker(algorithm="icp", n_starts=4),
    ] + [lambda m, bad=bad: m.NonrigidTracker(**{bad: object()})
         for bad in ("callbacks", "callback_chunk", "return_last",
                     "tf_init_params", "v_init", "sigma2_init")]
    for make in cases:
        with pytest.raises(ValueError) as want:
            make(jtr)
        with pytest.raises(ValueError) as got:
            make(_Cpu)
        assert str(got.value) == str(want.value)
    trk = ptr.RigidTracker(**CPU)
    with pytest.raises(RuntimeError, match="no frames"):
        trk.pose
    if not torch.cuda.is_available():
        for cls in (ptr.RigidTracker, ptr.NonrigidTracker):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls()


class _Cpu:
    """The port's trackers on the CPU, built as the reference's."""

    @staticmethod
    def RigidTracker(**k):
        return ptr.RigidTracker(device="cpu", **k)

    @staticmethod
    def NonrigidTracker(**k):
        return ptr.NonrigidTracker(device="cpu", **k)

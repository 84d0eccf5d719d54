"""The port's coarse-to-fine pyramids (probreg_tpu_torch.pyramid) held to
the JAX package's (probreg_tpu.pyramid).

The same numpy clouds (blobby surfaces of at most 3,000 points, two levels
of ~800 coarse points) go through both packages on the CPU; the port runs
its kernels' plain versions because its tensors lie on the CPU.

Tolerances: CPD, ICP and FilterReg transforms within 1e-4 of the
reference's (the two packages differ only in f32 operation order), CPD's
sigma2 within 5e-3 relative (it sits at the f32 floor on these exact
copies). GMMTree is held to the reference test's quality bar, because its
leaves are drawn from another generator (ROADMAP Queue 3). BCPD is held
to the reference's NN-RMSE within 5 %, because the VI amplifies rounding
(PERF.md).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu import config as jcmod  # noqa: E402
from probreg_tpu import pyramid as jpy  # noqa: E402
from probreg_tpu.utils.datagen import blobby_surface  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import pyramid as ppy  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the suite's workers torch's default pool
    oversubscribes the cores, and this file's many small products spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KW = dict(levels=2, coarse_points=800)
T_GT = np.array([0.05, -0.03, 0.08], np.float32)


def _rot(deg):
    return pso.euler2mat(*np.deg2rad(deg)).numpy()


@pytest.fixture(scope="module")
def rigid_pair():
    """pyramid_rigid.py's motion on a 3,000-point blobby surface."""
    src = blobby_surface(3000, seed=3)
    rot = _rot([5.0, 8.0, 12.0])
    return src, (src @ rot.T + T_GT).astype(np.float32), rot


def _angle(a, b):
    return float(pso.rotation_angle(torch.as_tensor(np.asarray(a)).double(),
                                    torch.as_tensor(np.asarray(b)).double()))


def _close_rigid(ref, out, atol):
    np.testing.assert_allclose(out.rot.numpy(), np.asarray(ref.rot),
                               atol=atol)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=atol)


def _nn_rmse(a, b):
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(1).mean()))


# --------------------------------------------------------------------------
# The schedule
# --------------------------------------------------------------------------

def test_schedule_helpers_match_reference(rigid_pair):
    src, tgt, _ = rigid_pair
    for v in (0.05, 0.2, 1.0):
        assert ppy._voxel_count(src, v) == jpy._voxel_count(src, v)
    for levels, coarse, factor in [(2, 800, 4.0), (3, 300, 3.0),
                                   (1, 800, 4.0), (3, 5000, 4.0)]:
        sizes = ppy.auto_voxel_sizes(src, tgt, levels, coarse, factor)
        assert sizes == jpy.auto_voxel_sizes(src, tgt, levels, coarse, factor)
        for a, b in zip(ppy.build_pyramid(src, sizes),
                        jpy.build_pyramid(src, sizes)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))
    assert ppy.auto_voxel_sizes(src * 0 + 1, tgt * 0 + 1, 3, 800) == [0.0]
    for args in [(1e-3, 0.1, 3.0), (1e-9, 0.0, 3.0), (0.5, 0.02, 1.0)]:
        assert ppy._carry_sigma2(*args) == jpy._carry_sigma2(*args)
    for n_levels, maxiter, div in [(1, 50, 5), (2, 50, 5), (4, 7, 3)]:
        assert ppy._default_level_maxiters(n_levels, maxiter, div) \
            == jpy._default_level_maxiters(n_levels, maxiter, div)
    for lm, n_levels, auto in [(None, 3, True), ([9, 8, 7], 3, False),
                               ([9, 8, 7, 6], 2, True), ([5], 1, True)]:
        assert ppy._fit_level_maxiters(lm, n_levels, 50, 5, auto) \
            == jpy._fit_level_maxiters(lm, n_levels, 50, 5, auto)
    with pytest.raises(ValueError, match="level_maxiters"):
        ppy._fit_level_maxiters([1, 2, 3], 2, 50, 5, False)


@pytest.mark.parametrize("dim,scale,voxel", [(3, 1.0, 0.05), (2, 1.0, 0.1),
                                             (4, 1.0, 0.3), (3, 1e7, 1e-7)])
def test_voxel_down_sample_matches_reference(dim, scale, voxel):
    """The port's voxel_down_sample equals the reference's bit for bit, in
    the same (lexicographic) voxel order; the last case's grid does not fit
    one int64 key, so it takes the row-wise unique."""
    from probreg_tpu.utils import io as jio
    from probreg_tpu_torch.utils import io as pio

    pts = scale * np.random.default_rng(dim).normal(size=(4000, dim))
    np.testing.assert_array_equal(pio.voxel_down_sample(pts, voxel),
                                  jio.voxel_down_sample(pts, voxel))


def test_voxel_keys_pack_in_row_order_and_decline_past_int64():
    """pack_voxel_keys sorts as the rows do; past a grid of 2^62 voxels it
    declines, and _voxel_count still counts exactly (row-wise unique)."""
    from probreg_tpu_torch.utils import io as pio

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 7, size=(500, 3))
    np.testing.assert_array_equal(
        np.argsort(pio.pack_voxel_keys(keys), kind="stable"),
        np.lexsort(keys.T[::-1]))
    pts = 1e7 * rng.normal(size=(2000, 3))
    big = np.floor((pts - pts.min(axis=0)) / 1e-7).astype(np.int64)
    assert pio.pack_voxel_keys(big) is None
    assert ppy._voxel_count(pts, 1e-7) == len(np.unique(big, axis=0))


def test_prepare_levels_keeps_the_callers_tensor(rigid_pair):
    src, tgt, _ = rigid_pair
    s, t = torch.as_tensor(src), torch.as_tensor(tgt)
    sl, tl, sizes = ppy._prepare_levels(s, t, None, 2, 800, 4.0, "cpu")
    assert sl[-1] is s and tl[-1] is t and sizes[-1] == 0.0
    assert isinstance(sl[0], np.ndarray)
    sl, _, _ = ppy._prepare_levels(s, t, None, 2, 800, 4.0, "cpu",
                                   keep_device_last=False)
    assert isinstance(sl[-1], np.ndarray)


def test_sliced_level_resumes_as_the_reference_does():
    """The same run/carry callbacks through both helpers: the same calls
    (budgets and warm states), the same early stop at a repeated warm state
    with tol > 0, and the explicit flatten stands in for tree_leaves
    (nested dicts, tuples, None, tensors)."""
    def drive(helper, budget, chunk, tol, freeze_at, as_tensor):
        calls = []

        def run(mi, warm):
            calls.append((mi, repr(warm)))
            return len(calls)

        def carry(res):
            k = min(res, freeze_at)
            t = torch.tensor([0.5, k]) if as_tensor else np.array([0.5, k])
            return ({"t": t, "scale": float(k), "skip": None}, None, 0.1)

        out = helper(budget, chunk, ({}, None, None), run, carry, tol=tol)
        return out, [c[0] for c in calls]

    for budget, chunk, tol, freeze in [(10, 3, 0.0, 99), (10, None, 1e-3, 99),
                                       (20, 4, 1e-3, 2), (0, 5, 0.0, 99),
                                       (7, 7, 1e-3, 1)]:
        ref = drive(jpy._sliced_level, budget, chunk, tol, freeze, False)
        for as_tensor in (False, True):
            assert drive(ppy._sliced_level, budget, chunk, tol, freeze,
                         as_tensor) == ref


# --------------------------------------------------------------------------
# CPD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rigid", "affine"])
def test_cpd_pyramid_matches_reference(rigid_pair, kind):
    src, tgt, rot = rigid_pair
    if kind == "affine":  # test_pyramid_affine's recipe
        rng = np.random.default_rng(2)
        b = np.eye(3, dtype=np.float32) \
            + 0.08 * rng.normal(size=(3, 3)).astype(np.float32)
        t_gt = 0.04 * rng.normal(size=3).astype(np.float32)
        tgt = (src @ b.T + t_gt).astype(np.float32)
    ref = jpy.registration_cpd_pyramid(src, tgt, kind, tol=1e-4, **KW)
    out = ppy.registration_cpd_pyramid(src, tgt, kind, tol=1e-4,
                                       device="cpu", **KW)
    if kind == "rigid":
        _close_rigid(ref.transformation, out.transformation, 1e-4)
        assert float(out.transformation.scale) == pytest.approx(
            float(ref.transformation.scale), abs=1e-4)
        assert _angle(out.transformation.rot, rot) < 1e-3
    else:
        np.testing.assert_allclose(out.transformation.b.numpy(),
                                   np.asarray(ref.transformation.b),
                                   atol=1e-4)
        np.testing.assert_allclose(out.transformation.t.numpy(),
                                   np.asarray(ref.transformation.t),
                                   atol=1e-4)
        np.testing.assert_allclose(out.transformation.b.numpy(), b,
                                   atol=1e-2)
    # The targets are exact copies, so sigma2 ends at the f32 floor in both
    # packages, where its last bits follow the summation order (ROADMAP,
    # Queue 3): both must reach the floor.
    floor = 10 * float(np.finfo(np.float32).eps)
    assert float(ref.sigma2) < floor and float(out.sigma2) < floor


def test_nonrigid_cpd_pyramid_matches_reference():
    """The low-rank nonrigid pyramid (2 levels, rank 20) on
    bench_bcpd_guarded.py's deformation of 2,000 points, without its
    rotation: the moved source within 1e-3 of the reference's (the two
    packages' Nystrom factors of one cloud differ by up to 5e-4,
    tests/test_torch_cpd_nonrigid.py), and the residual well below the
    deformation."""
    src = blobby_surface(2000, seed=5)
    defo = (0.02 * np.sin(3.0 * src[:, :1])
            * np.array([[1.0, 0.5, -0.3]])).astype(np.float32)
    tgt = (src + defo).astype(np.float32)
    kw = dict(rank=20, levels=2, coarse_points=600, maxiter=20, tol=0.0)
    ref = jpy.registration_cpd_pyramid(src, tgt, "nonrigid", **kw)
    out = ppy.registration_cpd_pyramid(src, tgt, "nonrigid", device="cpu",
                                       **kw)
    moved = out.transformation.transform(src).numpy()
    np.testing.assert_allclose(moved,
                               np.asarray(ref.transformation.transform(src)),
                               atol=1e-3)
    assert np.abs(moved - tgt).mean() < 0.3 * np.abs(defo).mean()


@pytest.fixture
def streaming_finest_level():
    """Both packages' configs lowered so that the finest level (9e6 pairs)
    streams through the sorted culled E-step while the coarse one (<= 1e6
    pairs) stays dense; restored after."""
    names = ("transposed_em_max_pairs", "culled_estep_min_pairs")
    old_p = {k: getattr(pcfg.config, k) for k in names}
    old_j = {k: getattr(jcmod.config, k) for k in names}
    for cfg in (pcfg.config, jcmod.config):
        cfg.transposed_em_max_pairs = 1 << 22
        cfg.culled_estep_min_pairs = 1 << 22
    jcmod.clear_caches()
    yield
    for k in names:
        setattr(pcfg.config, k, old_p[k])
        setattr(jcmod.config, k, old_j[k])
    pcfg.config.use_merged_stash = False
    jcmod.clear_caches()


def test_merged_route_inside_the_pyramid(rigid_pair, monkeypatch,
                                         streaming_finest_level):
    """With use_merged_stash the finest level's E-steps run K12's plain
    version, and the registration equals the default route's (K3's plain
    version) within 1e-5, and the reference's within 1e-4."""
    src, tgt, _ = rigid_pair
    taken = []
    for fn in ("stash_estep_plain", "stash_merged_estep_plain"):
        orig = getattr(pec, fn)
        monkeypatch.setattr(pec, fn, lambda *a, _o=orig, _n=fn:
                            taken.append(_n) or _o(*a))
    runs = {}
    for merged in (False, True):
        pcfg.config.use_merged_stash = merged
        taken.clear()
        runs[merged] = ppy.registration_cpd_pyramid(
            src, tgt, "rigid", tol=0.0, level_maxiters=[30, 4],
            device="cpu", **KW)
        want = "stash_merged_estep_plain" if merged else "stash_estep_plain"
        assert taken and set(taken) == {want}, taken
    _close_rigid(runs[False].transformation, runs[True].transformation, 1e-5)
    ref = jpy.registration_cpd_pyramid(src, tgt, "rigid", tol=0.0,
                                       level_maxiters=[30, 4], **KW)
    _close_rigid(ref.transformation, runs[True].transformation, 1e-4)


def test_cpd_pyramid_dispatch_chunk(rigid_pair):
    """CPD's result is its last EM iterate, so the sliced level resumes
    exactly (the reference's test_cpd_pyramid_dispatch_chunk)."""
    src, tgt, _ = rigid_pair
    kw = dict(tol=0.0, level_maxiters=[20, 10], **KW)
    full = ppy.registration_cpd_pyramid(src, tgt, "rigid", device="cpu",
                                        **kw)
    chunked = ppy.registration_cpd_pyramid(src, tgt, "rigid", device="cpu",
                                           dispatch_chunk=7, **kw)
    _close_rigid(full.transformation, chunked.transformation, 1e-5)
    ref = jpy.registration_cpd_pyramid(src, tgt, "rigid", dispatch_chunk=7,
                                       **kw)
    _close_rigid(ref.transformation, chunked.transformation, 1e-4)


# --------------------------------------------------------------------------
# The family pyramids
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_motion_pair():
    """test_pyramid_icp's motion (6, -4, 8 degrees) on 3,000 points."""
    src = blobby_surface(3000, seed=11)
    rot = _rot([6.0, -4.0, 8.0])
    return src, (src @ rot.T + T_GT).astype(np.float32), rot


@pytest.mark.parametrize("family", ["icp", "filterreg"])
def test_icp_and_filterreg_pyramids_match_reference(small_motion_pair,
                                                    family):
    src, tgt, rot = small_motion_pair
    name = {"icp": "registration_icp_pyramid",
            "filterreg": "registration_filterreg_pyramid"}[family]
    kw = dict(maxiter=40 if family == "icp" else 60, **KW)
    ref = getattr(jpy, name)(src, tgt, **kw)
    out = getattr(ppy, name)(src, tgt, device="cpu", **kw)
    _close_rigid(ref.transformation, out.transformation, 1e-4)
    assert _angle(out.transformation.rot, rot) < \
        (5e-3 if family == "icp" else 2e-2)


def test_gmmtree_pyramid_quality(small_motion_pair):
    """Held to the reference test's bar (test_pyramid_gmmtree), which the
    reference meets on the same clouds."""
    src, tgt, rot = small_motion_pair
    ref = jpy.registration_gmmtree_pyramid(src, tgt, maxiter=20, **KW)
    out = ppy.registration_gmmtree_pyramid(src, tgt, maxiter=20,
                                           device="cpu", **KW)
    for res in (ref, out):
        assert _angle(res.transformation.rot, rot) < 5e-2
        np.testing.assert_allclose(np.asarray(res.transformation.t), T_GT,
                                   atol=5e-2)


def test_bcpd_pyramid_matches_reference():
    """bench_bcpd_guarded.py's deformation and rotation on 2,000 points:
    the port's NN-RMSE within 5 % of the reference's, both well below the
    starting one."""
    src = blobby_surface(2000, seed=5)
    rot = _rot([8.0, -4.0, 6.0])
    defo = (0.02 * np.sin(3.0 * src[:, :1])
            * np.array([[1.0, 0.5, -0.3]])).astype(np.float32)
    tgt = ((src + defo) @ rot.T).astype(np.float32)
    kw = dict(maxiter=20, tol=0.0, lmd=10.0, rank=16, levels=2,
              coarse_points=600)
    ref = jpy.registration_bcpd_pyramid(src, tgt, **kw)
    out = ppy.registration_bcpd_pyramid(src, tgt, device="cpu", **kw)
    base = _nn_rmse(src, tgt)
    r_ref = _nn_rmse(np.asarray(ref.transform(src)), tgt)
    r_out = _nn_rmse(out.transform(src).numpy(), tgt)
    assert r_out < 0.7 * base
    assert r_out == pytest.approx(r_ref, rel=5e-2)


@pytest.mark.parametrize("voxel", [0.1, 0.0])
def test_interp_displacement_matches_reference(voxel):
    rng = np.random.default_rng(4)
    coarse = blobby_surface(500, seed=1)
    disp = (0.01 * rng.normal(size=coarse.shape)).astype(np.float32)
    fine = blobby_surface(1500, seed=2)
    ref = jpy._interp_displacement(coarse, disp, fine, voxel)
    out = ppy._interp_displacement(coarse, torch.as_tensor(disp), fine,
                                   voxel, device="cpu")
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------------------
# Rejections
# --------------------------------------------------------------------------

def test_rejections():
    src = np.random.default_rng(0).random((100, 3)).astype(np.float32)
    cpu = dict(device="cpu")
    # The FilterReg pyramid's mesh= (ported) refuses what the reference's
    # refuses, before any level runs.
    mesh_refusals = [
        (dict(callbacks=[print]), "neither callbacks nor dispatch_chunk"),
        (dict(dispatch_chunk=3), "neither callbacks nor dispatch_chunk"),
        (dict(use_pallas=False), "does not support \\['use_pallas'\\]"),
    ]
    for kw, match in mesh_refusals:
        with pytest.raises(ValueError, match=match):
            ppy.registration_filterreg_pyramid(src, src, mesh=object(),
                                               **kw, **cpu)
    invalid = [
        # n_starts (ported) is the rigid coarsest level's, without
        # callbacks, and GMMTree's not with dispatch_chunk (as the
        # reference's).
        lambda: ppy.registration_cpd_pyramid(src, src, "affine", n_starts=4,
                                             **cpu),
        lambda: ppy.registration_cpd_pyramid(src, src, n_starts=4,
                                             callbacks=[print], **cpu),
        lambda: ppy.registration_filterreg_pyramid(src, src, n_starts=2,
                                                   callbacks=[print], **cpu),
        lambda: ppy.registration_gmmtree_pyramid(src, src, n_starts=2,
                                                 dispatch_chunk=3, **cpu),
        # The CPD pyramid's mesh= is ported; like the reference's, it takes
        # no callbacks.
        lambda: ppy.registration_cpd_pyramid(src, src, mesh=object(),
                                             callbacks=[print], **cpu),
        lambda: ppy.registration_cpd_pyramid(src, src, "projective", **cpu),
        # The nonrigid pyramid carries a low-rank field only, and not on a
        # mesh.
        lambda: ppy.registration_cpd_pyramid(src, src, "nonrigid", **cpu),
        lambda: ppy.registration_cpd_pyramid(src, src, "nonrigid", rank=8,
                                             mesh=object(), **cpu),
        lambda: ppy.registration_cpd_pyramid(
            src, src, tf_init_params={"rot": np.eye(3)}, **cpu),
        lambda: ppy.registration_cpd_pyramid(src, src, sigma2_init=0.1,
                                             **cpu),
        lambda: ppy.registration_filterreg_pyramid(src, src, sigma2=0.1,
                                                   **cpu),
        lambda: ppy.registration_gmmtree_pyramid(
            src, src, tf_init_params={"rot": np.eye(3)}, **cpu),
        lambda: ppy.registration_icp_pyramid(
            src, src, tf_init_params={"rot": np.eye(3)}, **cpu),
        lambda: ppy.registration_bcpd_pyramid(src, src,
                                              v_init=np.zeros((100, 3)),
                                              **cpu),
        lambda: ppy.registration_bcpd_pyramid(src, src, callbacks=[print],
                                              **cpu),
        lambda: ppy.registration_bcpd_pyramid(src, src, mesh=object(),
                                              dispatch_chunk=3, **cpu),
        lambda: ppy.registration_bcpd_pyramid(src, src, mesh=object(),
                                              **cpu),
        lambda: ppy.registration_cpd_pyramid(src, src, voxel_sizes=[0.5, 0],
                                             level_maxiters=[3], **cpu),
    ]
    for call in invalid:
        with pytest.raises(ValueError):
            call()

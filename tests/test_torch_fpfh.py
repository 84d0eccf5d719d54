"""The port's FPFH and FilterReg's feature path held to the JAX package:
the neighbour search, the normals, the 33-D histograms, ``features.FPFH``,
the whole-EM feature loop and a numpy ``feature_fn`` in the whole-EM
loop and the host loop.

Both packages take the same seeded numpy cloud on the CPU, a 300-point
surface on which no neighbour set is cut at a tie on the k-th distance
(the test checks that the sets agree). Tolerances: neighbour distances
1e-5; normals 1e-5 (their eigenvalues are apart on this cloud);
histograms: an angle within rounding of one of the discontinuous bin
edges moves one vote (100 / count) between the packages, as it does
between the reference's own jitted and eager runs, and the neighbour term
spreads it over up to 50 rows, so at most 3 % of the entries may differ
by more than 0.1 (of a 0-200 scale) and the rest agree to 0.1. The
feature loops run a smooth 6-D map at a fixed depth (tol 0): rotations
and translations 1e-5, sigma2 and q 1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import features as jfe  # noqa: E402
from probreg_tpu import filterreg as jfr  # noqa: E402
from probreg_tpu.ops import fpfh as jfp  # noqa: E402
from probreg_tpu.utils.datagen import blobby_surface  # noqa: E402
from probreg_tpu_torch import features as pfe  # noqa: E402
from probreg_tpu_torch import filterreg as pfr  # noqa: E402
from probreg_tpu_torch.ops import fpfh as pfp  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402

RN, RF, NN_N, NN_F = 0.5, 1.0, 20, 50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in the other port test files under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cloud():
    pts = blobby_surface(300, seed=3).astype(np.float32)
    normals = np.asarray(jfp.estimate_normals(jnp.asarray(pts), radius=RN,
                                              max_nn=NN_N))
    return pts, normals


def test_knn_and_normals_match_reference(cloud):
    pts, normals_ref = cloud
    ji, jv, jd = (np.asarray(a) for a in jfp._knn(jnp.asarray(pts), NN_N,
                                                   RN))
    pi, pv, pd = (a.numpy() for a in pfp._knn(torch.from_numpy(pts), NN_N,
                                              RN))
    for a, b, va, vb, da, db in zip(ji, pi, jv, pv, jd, pd):
        oa, ob = np.argsort(a), np.argsort(b)
        assert np.array_equal(a[oa], b[ob])
        assert np.array_equal(va[oa], vb[ob])
        np.testing.assert_allclose(db[ob], da[oa], atol=1e-5)
    ours = pfe.FPFH(RN, RF, NN_N, NN_F, device="cpu").estimate_normals(pts)
    np.testing.assert_allclose(ours.numpy(), normals_ref, atol=1e-5)


def test_fpfh_matches_reference(cloud):
    pts, normals_ref = cloud
    ref = np.asarray(jfe.FPFH(RN, RF, NN_N, NN_F).compute(pts))
    fn = pfe.FPFH(RN, RF, NN_N, NN_F, device="cpu")
    got = fn(pts).numpy()
    assert got.shape == (300, 33)
    for out in (got, pfp.fpfh(torch.from_numpy(pts), RN, RF, NN_N, NN_F,
                              normals=torch.from_numpy(normals_ref)).numpy()):
        off = np.abs(out - ref) > 0.1
        assert off.mean() <= 0.03, off.mean()
        np.testing.assert_allclose(out[~off], ref[~off], atol=0.1)


def _feat_ref(x):
    return jnp.concatenate([x, 0.5 * jnp.sin(2.0 * x)], axis=1)


def _feat_port(x):
    return torch.cat([x, 0.5 * torch.sin(2.0 * x)], 1)


def _feat_np(x):
    x = np.asarray(x)
    return np.concatenate([x, 0.5 * np.sin(2.0 * x)], 1)


def _pair(cloud):
    src = cloud[0]
    rot = pso.euler2mat(0.1, -0.05, 0.2).numpy()
    tgt = (src @ rot.T + np.array([0.03, 0.0, -0.02])).astype(np.float32)
    return src, tgt, (cloud[1] @ rot.T).astype(np.float32)


def _close(ours, ref, rel=1e-5):
    rot, t = ours.transformation.rot, ours.transformation.t
    np.testing.assert_allclose(rot.numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(ref[1]), atol=1e-5)
    assert float(ours.sigma2) == pytest.approx(float(ref[2]), rel=rel)
    assert float(ours.q) == pytest.approx(float(ref[3]), rel=rel)


def test_feature_whole_em_matches_reference(cloud):
    """``_run_em_rigid_feature`` (pt2pt, sigma2 from the features) and
    the entry point with a ``feature_fn``, which takes it."""
    src, tgt, _ = _pair(cloud)
    kw = dict(objective_type="pt2pt", update_sigma2=True, w=0.0, maxiter=6,
              tol=0.0, min_sigma2=1e-4, auto_sigma2=True)
    ref = jfr._run_em_rigid_feature(
        jnp.asarray(src), jnp.asarray(tgt), None, _feat_ref(jnp.asarray(tgt)),
        jnp.eye(3), jnp.zeros(3), np.float32(0.0), feature_fn=_feat_ref,
        **kw)
    got = pfr._run_em_rigid_feature(
        torch.from_numpy(src), torch.from_numpy(tgt), None,
        _feat_port(torch.from_numpy(tgt)), torch.eye(3), torch.zeros(3),
        0.0, feature_fn=_feat_port, **kw)
    _close(got, ref)
    entry = pfr.registration_filterreg(src, tgt, feature_fn=_feat_port,
                                       update_sigma2=True, maxiter=6,
                                       tol=0.0, device="cpu")
    _close(entry, ref)


def test_numpy_feature_fn_matches_reference(cloud):
    """A numpy ``feature_fn`` (pt2pl, sigma2 from the point spacing) in the
    port's whole-EM loop and in its host loop with callbacks, against the
    reference's ``_run_em_rigid_feature`` on the same map in jnp (the
    reference's own tests hold its host loop, which it falls back to for
    a numpy map, to that loop)."""
    src, tgt, normals = _pair(cloud)
    kw = dict(objective_type="pt2pl", update_sigma2=False, w=0.0,
              maxiter=3, tol=0.0, min_sigma2=1e-4, sigma2_decay=0.9)
    ref = jfr._run_em_rigid_feature(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(normals),
        _feat_ref(jnp.asarray(tgt)), jnp.eye(3), jnp.zeros(3),
        np.float32(0.0), feature_fn=_feat_ref, auto_sigma2=True, **kw)
    args = dict(target_normals=normals, objective_type="pt2pl", maxiter=3,
                tol=0.0, sigma2_decay=0.9, feature_fn=_feat_np, device="cpu")
    _close(pfr.registration_filterreg(src, tgt, **args), ref)
    seen = []
    host = pfr.registration_filterreg(src, tgt, callbacks=[seen.append],
                                      **args)
    assert len(seen) == 3
    # A host loop reports the sigma2 its last M-step used, a whole-EM loop
    # the annealed one the next iteration would use (in both packages).
    _close(host, ref[:2] + (float(ref[2]) / 0.9, ref[3]))

"""The port's sharded FilterReg, BCPD, GMMTree, GMMReg and SVR runners and
the FilterReg and BCPD pyramids with ``mesh=`` (probreg_tpu_torch.parallel)
against the reference's (probreg_tpu.parallel) on the same inputs.

The reference runs on the conftest's virtual CPU devices; the port's ranks
are 4 spawned processes with a gloo process group (one spawn for the whole
module; the GMMTree calls register against the reference's tree, carried
into every rank by tests/_torch_ranks.py: the two packages' leaf
initializations draw different bits). Every call runs at a fixed depth
(tol = 0) on clouds that split unevenly over the ranks, and every rank must
return the same numbers bit for bit. Tolerances:

* transforms 1e-5 absolute, sigma2 and q 1e-4 relative (summation order
  only: the packages reduce across shards in different orders), as in
  tests/test_torch_parallel.py, for FilterReg and its pyramid;
* BCPD with the dense Gram matrix: the moved source points within 8 times
  the port's own f32-f64 spread at the same depth (the single-card
  registration_bcpd in both precisions), the rule of the BCPD tests;
* the low-rank cases (BCPD, its pyramid): 1e-3 of the moved points, as
  each package builds its own Nystrom factors (they differ by up to 5e-4,
  tests/test_torch_cpd_nonrigid.py);
* GMMTree: 1e-4 on the transform, q 10 % relative, on a target that is a
  rotated copy of the source at 20 iterations. A point near a tie of the
  descent can flip between the packages and move the pose by ~1e-3
  (tests/test_torch_gmmtree.py); on the rotated copy the poses meet at
  ~2e-5, while q, the residual at the fixed point, keeps the flipped
  points' share (~5 % here);
* GMMReg and SVR: 1e-3 rad and 1e-3 of the extent on rigid transforms,
  1e-3 of the extent on TPS moved points, the single-card L2 tests' bars
  (f32 BFGS paths part by rounding).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from probreg_tpu import gmmtree as jgt  # noqa: E402
from probreg_tpu import pyramid as jpyr  # noqa: E402
from probreg_tpu.parallel import sharded as jsh  # noqa: E402
from probreg_tpu.parallel import sharded2d as jsh2  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu.utils.datagen import blobby_surface  # noqa: E402

import _fixtures  # noqa: E402
import _torch_ranks  # noqa: E402
from probreg_tpu_torch import bcpd as pbcpd  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch.parallel import _spmd  # noqa: E402

ATOL = 1e-5
LOWRANK_ATOL = 1e-3
RTOL = 1e-4
BCPD_SPREAD = 8.0
GMMTREE_ATOL = 1e-4
GMMTREE_Q_RTOL = 0.1
L2_ATOL = 1e-3
M, N = 301, 257          # uneven on every mesh axis
ITERS = 10
BCPD_ITERS = 4
BCPD_KW = dict(maxiter=BCPD_ITERS, tol=0.0, gamma=0.1, lmd=10.0)
RANK = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rigid_pair(m=M, n=N, seed=0, bend=0.0):
    """A target of n of the source's m points, turned, moved and, with
    ``bend``, bent (a nonrigid part for BCPD); unit normals of varied
    directions for pt2pl."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                    [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    tgt = src[rng.permutation(m)[:n]] @ rot.T + np.array([0.05, -0.02, 0.03])
    tgt = tgt + bend * np.sin(3.0 * tgt)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return src, tgt.astype(np.float32), nrm.astype(np.float32)


def _tree_pair():
    """blobby_surface(401, seed=5) and its copy turned by (5, -3, 6)
    degrees (the GMMTree tests' pair, one point more)."""
    pts = blobby_surface(401, seed=5).astype(np.float32)
    rot = np.asarray(jso.euler2mat(*np.deg2rad([5.0, -3.0, 6.0])))
    return pts, (pts @ rot.T).astype(np.float32)


def _pyramid_pair():
    rng = np.random.default_rng(2)
    src = rng.uniform(-1.0, 1.0, (1500, 3)).astype(np.float32)
    th = 0.2
    rot = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                    [-np.sin(th), 0.0, np.cos(th)]])
    return src, (src @ rot.T + 0.02).astype(np.float32)


def _fish_pair():
    """The fish of the TPS tests (2-D)."""
    return (_fixtures.fish_source().astype(np.float32),
            _fixtures.fish_target().astype(np.float32))


FRG_PT2PL = dict(maxiter=ITERS, tol=0.0, update_sigma2=True)
FRG_PYR = dict(levels=2, level_maxiters=[ITERS, 5], tol=0.0,
               coarse_points=400)
BCPD_PYR = dict(levels=2, level_maxiters=[BCPD_ITERS, 3], tol=0.0,
                coarse_points=400, rank=RANK, gamma=0.1, lmd=10.0)

# (name, entry, mesh shape, pair, args, kwargs): each runs in the spawned
# ranks and on the reference's virtual mesh of the same shape.
CASES = [
    ("frg_1d_pt2pt", "filterreg_sharded", (4,), "rigid", (),
     dict(maxiter=ITERS, tol=0.0)),
    ("frg_1d_pt2pl", "filterreg_sharded", (4,), "rigid", ("pt2pl",),
     FRG_PT2PL),
    ("frg_2d_pt2pt", "filterreg_2d", (2, 2), "rigid", (),
     dict(maxiter=ITERS, tol=0.0)),
    ("frg_2d_pt2pl", "filterreg_2d", (2, 2), "rigid", ("pt2pl",), FRG_PT2PL),
    ("bcpd_1d_dense", "bcpd_sharded", (4,), "bent", (), BCPD_KW),
    ("bcpd_1d_lowrank", "bcpd_sharded", (4,), "bent", (),
     dict(BCPD_KW, rank=RANK)),
    ("bcpd_2d_lowrank", "bcpd_2d", (2, 2), "bent", (),
     dict(BCPD_KW, rank=RANK)),
    ("gmmtree_1d", "gmmtree_sharded", (4,), "tree", (),
     dict(maxiter=20, tol=0.0)),
    ("gmmreg_1d", "gmmreg_sharded", (4,), "rigid", (),
     dict(n_gmm_components=60)),
    ("svr_1d", "svr_sharded", (4,), "rigid", (), {}),
    ("svr_1d_tps", "svr_sharded", (4,), "fish", ("nonrigid",), {}),
    ("frg_pyramid", "filterreg_pyramid", (4,), "pyramid", (), FRG_PYR),
    ("bcpd_pyramid", "bcpd_pyramid", (2, 2), "pyramid", (), BCPD_PYR),
]


@functools.cache
def _pairs():
    src, tgt, nrm = _rigid_pair()
    bsrc, btgt, _ = _rigid_pair(bend=0.05)
    return {"rigid": (src, tgt, nrm), "bent": (bsrc, btgt),
            "tree": _tree_pair(), "fish": _fish_pair(),
            "pyramid": _pyramid_pair()}


def _args(pair, args):
    """(source, target[, normals], *args) of a case: pt2pl takes the
    normals before its objective."""
    if args[:1] == ("pt2pl",):
        return pair[:3] + args
    return pair[:2] + args


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case in one spawn of 4 gloo CPU ranks; returns each rank's
    outputs."""
    pairs = _pairs()
    calls = [(entry, shape, _args(pairs[pair], args), kw)
             for _, entry, shape, pair, args, kw in CASES]
    tree = [np.asarray(a) for a in
            jgt.GMMTree(pairs["tree"][0], tree_level=2)._nodes]
    return _spmd.run_spmd(_torch_ranks.rank_calls_on_tree, 4, "gloo", "cpu",
                          tree, calls,
                          workdir=tmp_path_factory.mktemp("spmd"),
                          timeout=300.0)


def _jax_mesh(shape):
    devs = jax.devices()[:int(np.prod(shape))]
    if len(shape) == 1:
        return jsh.make_mesh(devs)
    return jsh2.make_mesh_2d(*shape, devices=devs)


REFERENCE = {
    "filterreg_sharded": jsh.registration_filterreg_sharded,
    "filterreg_2d": jsh.registration_filterreg_sharded,
    "bcpd_sharded": jsh.registration_bcpd_sharded,
    "bcpd_2d": jsh.registration_bcpd_sharded,
    "gmmtree_sharded": jsh.registration_gmmtree_sharded,
    "gmmreg_sharded": jsh.registration_gmmreg_sharded,
    "svr_sharded": jsh.registration_svr_sharded,
    "filterreg_pyramid": jpyr.registration_filterreg_pyramid,
    "bcpd_pyramid": jpyr.registration_bcpd_pyramid,
}


def _same_on_every_rank(outs):
    """Every rank: the same E-steps and the same numbers bit for bit."""
    first = outs[0]
    for o in outs[1:]:
        assert o["counts"]["esteps"] == first["counts"]["esteps"]
        for k in first["result"]:
            assert np.array_equal(o["result"][k], first["result"][k]), k


def _moved(got, src):
    """The port's combined (BCPD) result applied to the source."""
    return got["scale"] * (src + got["v"]) @ got["lin"].T + got["t"]


def _bcpd_spread(src, tgt, kw):
    """Max |f32 - f64| of the port's single-card BCPD's moved points at
    the same depth."""
    kw = dict(kw, device="cpu")
    a = pbcpd.registration_bcpd(src, tgt, **kw).transform(
        torch.as_tensor(src)).numpy()
    dtype = pcfg.config.dtype
    pcfg.config.dtype = torch.float64
    try:
        b = pbcpd.registration_bcpd(src, tgt, **kw).transform(
            torch.as_tensor(src, dtype=torch.float64)).numpy()
    finally:
        pcfg.config.dtype = dtype
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_sharded_family_matches_reference(spawned, index):
    name, entry, shape, pair_name, args, kw = CASES[index]
    outs = [rank[index] for rank in spawned]
    _same_on_every_rank(outs)
    got = outs[0]["result"]
    pair = _pairs()[pair_name]
    src = pair[0]
    ref = REFERENCE[entry](*_args(pair, args), mesh=_jax_mesh(shape), **kw)
    if entry.startswith("bcpd"):
        moved = np.asarray(ref.transform(src))
        if "rank" in kw:
            bar = LOWRANK_ATOL
        else:
            bar = BCPD_SPREAD * _bcpd_spread(*pair, kw)
        assert np.abs(_moved(got, src) - moved).max() <= bar, name
        assert np.abs(_moved(got, src) - src).max() > 10 * bar, name
        return
    if "moved" in got:  # TPS: the moved control points (the source)
        extent = float(np.ptp(pair[1], 0).max())
        np.testing.assert_allclose(got["moved"],
                                   np.asarray(ref.transform(src)),
                                   atol=L2_ATOL * extent, err_msg=name)
        return
    tr = getattr(ref, "transformation", ref)
    atol = {"gmmtree": GMMTREE_ATOL, "gmmreg": L2_ATOL,
            "svr": L2_ATOL}.get(entry.split("_")[0], ATOL)
    np.testing.assert_allclose(got["lin"], np.asarray(tr.rot), atol=atol,
                               err_msg=name)
    np.testing.assert_allclose(got["t"], np.asarray(tr.t), atol=atol,
                               err_msg=name)
    if entry.startswith("filterreg"):
        np.testing.assert_allclose(got["sigma2"], float(ref.sigma2),
                                   rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(got["q"], float(ref.q), rtol=RTOL,
                                   err_msg=name)
    elif entry.startswith("gmmtree"):
        np.testing.assert_allclose(got["q"], float(ref.q),
                                   rtol=GMMTREE_Q_RTOL, err_msg=name)
        assert outs[0]["counts"]["esteps"] == kw["maxiter"]


def test_sharded_families_count_their_esteps(spawned):
    """One E-step per iteration (FilterReg, GMMTree), BCPD's loop and its
    final rescore, the pyramids' levels summed; one den reduction per
    E-step on the 2-D BCPD mesh."""
    want = {"frg_1d_pt2pt": ITERS, "frg_2d_pt2pl": ITERS,
            "bcpd_1d_dense": BCPD_ITERS + 1, "bcpd_2d_lowrank": BCPD_ITERS + 1,
            "frg_pyramid": sum(FRG_PYR["level_maxiters"]),
            "bcpd_pyramid": sum(BCPD_PYR["level_maxiters"]) + 2}
    for index, case in enumerate(CASES):
        if case[0] in want:
            counts = spawned[0][index]["counts"]
            assert counts["esteps"] == want[case[0]], case[0]
            if case[1] in ("bcpd_2d", "bcpd_pyramid"):
                assert counts["den_all_reduce"] == counts["esteps"], case[0]

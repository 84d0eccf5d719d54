"""The port's sharded CPD (probreg_tpu_torch.parallel) against the
reference's (probreg_tpu.parallel) on the same inputs.

The reference runs on the conftest's virtual CPU devices; the port's ranks
are 4 spawned processes with a gloo process group (one spawn for the whole
module). Both run at a fixed depth (tol = 0), so the two stop alike.
Tolerance on the transforms: 1e-5 absolute, the reference's own for its
2-D mesh against one device (tests/test_sharded2d.py), on the displacement
at the source points for the nonrigid kinds; 1e-3 for the low-rank ones,
whose Nystrom factors each package builds itself (they differ by up to
5e-4 in U diag(lam) U^T, tests/test_torch_cpd_nonrigid.py); sigma2 and q
within 1e-4 relative (summation order only: the two reduce across shards
in different orders). Every rank must return the same iterations and the
same transform bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from probreg_tpu.ops import estep_pallas as jep  # noqa: E402
from probreg_tpu.ops import spatial as jspatial  # noqa: E402
from probreg_tpu.parallel import sharded as jsh  # noqa: E402
from probreg_tpu.parallel import sharded2d as jsh2  # noqa: E402
from probreg_tpu import pyramid as jpyr  # noqa: E402
from probreg_tpu.ops.estep import outlier_constant  # noqa: E402

from probreg_tpu_torch import parallel as ppar  # noqa: E402
from probreg_tpu_torch.ops import estep_cuda as pec  # noqa: E402
from probreg_tpu_torch.ops.spatial import morton_order_np  # noqa: E402
from probreg_tpu_torch.parallel import _spmd  # noqa: E402
from probreg_tpu_torch.parallel import mesh as pmesh  # noqa: E402

ATOL = 1e-5
LOWRANK_ATOL = 1e-3
RTOL = 1e-4
M, N = 301, 257          # uneven on every mesh axis
ITERS = 10
TILE = 128


def _rigid_pair(m=M, n=N, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1.0, 1.0, (m, 3)).astype(np.float32)
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                    [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    tgt = src[rng.permutation(m)[:n]] @ rot.T + np.array([0.05, -0.02, 0.03])
    return src, tgt.astype(np.float32)


def _ragged_batch(seed=1):
    """6 ragged pairs: on 4 ranks, shards of 2 pairs and one empty rank."""
    rng = np.random.default_rng(seed)
    srcs, tgts = [], []
    for b in range(6):
        m, n = rng.integers(40, 90, 2)
        s, t = _rigid_pair(int(m), int(n), seed=10 + b)
        srcs.append(s)
        tgts.append(t)
    return srcs, tgts


def _pyramid_pair():
    rng = np.random.default_rng(2)
    src = rng.uniform(-1.0, 1.0, (1500, 3)).astype(np.float32)
    th = 0.2
    rot = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                    [-np.sin(th), 0.0, np.cos(th)]])
    return src, (src @ rot.T + 0.02).astype(np.float32)


PYR_KW = dict(levels=2, level_maxiters=[ITERS, 5], tol=0.0,
              coarse_points=400)

# (name, entry, mesh shape, args, kwargs): each runs in the spawned ranks
# and on the reference's virtual mesh of the same shape.
CASES = [
    ("2d_rigid_dense", "cpd_2d", (2, 2), ("rigid",), {}),
    ("2d_affine_dense", "cpd_2d", (2, 2), ("affine",), {}),
    ("2d_rigid_culled", "cpd_2d", (2, 2), ("rigid",),
     dict(use_culled=True, culled_tile=TILE)),
    ("2d_affine_culled", "cpd_2d", (2, 2), ("affine",),
     dict(use_culled=True, culled_tile=TILE)),
    ("1d_rigid_culled", "cpd_sharded", (4,), ("rigid",),
     dict(use_culled=True, culled_tile=TILE)),
    ("1d_affine_dense", "cpd_sharded", (4,), ("affine",), {}),
    ("1d_nonrigid_dense", "cpd_sharded", (4,), ("nonrigid",), {}),
    ("1d_nonrigid_lowrank", "cpd_sharded", (4,), ("nonrigid",),
     dict(rank=20)),
    ("2d_nonrigid_lowrank_dense", "cpd_2d", (2, 2), ("nonrigid",),
     dict(rank=20)),
    ("2d_nonrigid_lowrank_culled", "cpd_2d", (2, 2), ("nonrigid",),
     dict(rank=20, use_culled=True, culled_tile=TILE)),
]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case, the ragged batch and the pyramid in one spawn of 4 gloo
    CPU ranks; returns each rank's outputs."""
    src, tgt = _rigid_pair()
    calls = [(entry, shape, (src, tgt) + args,
              dict(kw, maxiter=ITERS, tol=0.0))
             for _, entry, shape, args, kw in CASES]
    calls.append(("cpd_batch_sharded", (4,), _ragged_batch(),
                  dict(maxiter=ITERS, tol=0.0)))
    calls.append(("cpd_pyramid", (2, 2), _pyramid_pair() + ("rigid",),
                  PYR_KW))
    return _spmd.run_spmd(_spmd.rank_calls, 4, "gloo", "cpu", calls,
                          workdir=tmp_path_factory.mktemp("spmd"),
                          timeout=300.0)


def _jax_mesh(shape):
    devs = jax.devices()[:int(np.prod(shape))]
    if len(shape) == 1:
        return jsh.make_mesh(devs)
    return jsh2.make_mesh_2d(*shape, devices=devs)


def _lin(tr):
    return np.asarray(tr.rot if hasattr(tr, "rot") else tr.b)


def _check(got, want, name, atol=ATOL):
    tr = want.transformation
    if "disp" in got:  # nonrigid: the displacement at the source points
        disp = tr.u @ tr.zc if hasattr(tr, "u") else tr.g @ tr.w
        np.testing.assert_allclose(got["disp"], np.asarray(disp), atol=atol,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got["lin"], _lin(tr), atol=atol,
                                   err_msg=name)
        np.testing.assert_allclose(got["t"], np.asarray(tr.t), atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(got["sigma2"], float(want.sigma2), rtol=RTOL,
                               err_msg=name)
    np.testing.assert_allclose(got["q"], float(want.q), rtol=RTOL,
                               err_msg=name)


def _same_on_every_rank(outs):
    """Every rank: the same E-steps and the same numbers bit for bit."""
    first = outs[0]
    for o in outs[1:]:
        assert o["counts"]["esteps"] == first["counts"]["esteps"]
        results = o["result"] if isinstance(o["result"], list) \
            else [o["result"]]
        firsts = first["result"] if isinstance(first["result"], list) \
            else [first["result"]]
        for a, b in zip(results, firsts):
            for k in a:
                assert np.array_equal(a[k], b[k]), k


def test_mesh_2d_shape_matches_reference():
    for world in range(1, 9):
        devs = jax.devices()[:world]
        ref = jsh2.make_mesh_2d(devices=devs)
        assert pmesh.mesh_2d_shape(world) == (ref.shape["m"], ref.shape["n"])
        for pm in (1, 2):
            if world % pm == 0:
                ref = jsh2.make_mesh_2d(pm=pm, devices=devs)
                assert pmesh.mesh_2d_shape(world, pm=pm) == (
                    ref.shape["m"], ref.shape["n"])
                ref = jsh2.make_mesh_2d(pn=pm, devices=devs)
                assert pmesh.mesh_2d_shape(world, pn=pm) == (
                    ref.shape["m"], ref.shape["n"])
    with pytest.raises(ValueError):
        jsh2.make_mesh_2d(3, 4, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="mesh shape 3x4 != 8"):
        pmesh.mesh_2d_shape(8, 3, 4)


def test_shard_range_is_the_reference_padding():
    """ceil(N / P) rows per shard, the last short or empty: the rows the
    reference's padded shards hold unmasked."""
    for n, parts in ((301, 2), (257, 4), (9, 4), (1, 2), (8, 4)):
        size = -(-n // parts)
        mask = np.zeros(size * parts)
        mask[:n] = 1
        for i in range(parts):
            start, stop = pmesh.shard_range(n, parts, i)
            assert stop - start == int(mask[i * size:(i + 1) * size].sum())
            assert start == min(i * size, n)


def test_morton_order_np_matches_reference():
    rng = np.random.default_rng(3)
    for shape in ((1000, 3), (333, 2), (12, 3)):
        pts = rng.normal(size=shape).astype(np.float32)
        pts[:5] = pts[5:10]  # ties keep their order
        np.testing.assert_array_equal(morton_order_np(pts),
                                      jspatial.morton_order_np(pts))


def _sorted_pair(m, n):
    src, tgt = _rigid_pair(m, n, seed=4)
    return src[morton_order_np(src)], tgt[morton_order_np(tgt)]


@functools.lru_cache(maxsize=None)
def _reference_spmd_fn(shape):
    """The reference's fused_stash_core_spmd(interpret=True) under
    shard_map on a virtual mesh of ``shape``, jitted once per shape, with
    p1 / px / xx summed over the target axis as its 2-D runner does."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def body(ys, sm, xs, xm, sigma2, c):
        pt1, p1, px, xx = jep.fused_stash_core_spmd(
            ys, xs, sm, xm, sigma2, c, m_axis="m", tile_m=TILE, tile_n=TILE,
            interpret=True)
        pxp = jax.lax.psum(jnp.concatenate([px, p1[None]], 0), "n")
        return pt1, pxp, jax.lax.psum(xx, "n")

    return jax.jit(shard_map(
        body, mesh=_jax_mesh(shape),
        in_specs=(P(None, "m"), P(None, "m"), P(None, "n"), P(None, "n"),
                  P(), P()),
        out_specs=(P(None, "n"), P(None, "m"), P()), check_vma=False))


def _reference_spmd(src, tgt, shape, sigma2, w):
    """(pt1 (N,), p1 (M,), px (M, D), xx) of the reference's SPMD core."""
    mesh = _jax_mesh(shape)
    m, dim = src.shape
    n = tgt.shape[0]
    ys_t, smask, _ = jsh2._shard_axis_t(src, mesh, "m")
    xs_t, xmask, _ = jsh2._shard_axis_t(tgt, mesh, "n")
    s2 = jnp.float32(sigma2)
    pt1, pxp, xx = _reference_spmd_fn(shape)(
        ys_t, smask, xs_t, xmask, s2, outlier_constant(s2, w, m, n, dim))
    pxp = np.asarray(pxp)[:, :m]
    return (np.asarray(pt1)[0, :n], pxp[dim], pxp[:dim].T, float(xx))


def _port_spmd(src, tgt, shape, sigma2, w):
    """The port's plain K11 + finish + pass B (estep_cuda.stash_estep with
    reduce_den, on CPU tensors) on every (source shard, target shard) of a
    shape = (pm, pn) mesh, in one process: each shard's one reduction per
    E-step hands over the raw sums of the whole target shard, which are
    summed over the source shards first (the all_reduce), then handed to
    every shard's run. Returns what _reference_spmd returns, and checks
    that pt1 and xx are the same bit for bit on every source shard."""
    pm, pn = shape
    m, dim = src.shape
    n = tgt.shape[0]
    scal = pec._scalars(sigma2, w, m, n, dim, "cpu")
    p1, px, pt1, xx = np.zeros(m), np.zeros((m, dim)), [], 0.0
    for j in range(pn):
        x0, x1 = pmesh.shard_range(n, pn, j)
        xs = torch.as_tensor(tgt[x0:x1])
        tn = min(TILE, pec._round_up(xs.shape[0], 128))
        shards = []
        for i in range(pm):
            y0, y1 = pmesh.shard_range(m, pm, i)
            ys = torch.as_tensor(src[y0:y1])
            tm = max(8, min(TILE, pec._round_up(ys.shape[0], 8)))
            mask = pec._active_mask(*pec._tile_bounds(ys, tm),
                                    *pec._tile_bounds(xs, tn), scal[0])
            shards.append((y0, y1, ys, tm, mask))
        total = torch.zeros(xs.shape[0])  # raw sums over every shard
        for y0, y1, ys, tm, mask in shards:
            seen = []
            pec.stash_estep(ys, xs, scal, mask, tm, tn,
                            reduce_den=lambda d: seen.append(d.clone()))
            assert len(seen) == 1
            total = total + seen[0]
        outs = []
        for y0, y1, ys, tm, mask in shards:
            out = pec.stash_estep(ys, xs, scal, mask, tm, tn,
                                  reduce_den=lambda d: d.copy_(total))
            p1[y0:y1] += out[1].numpy()
            px[y0:y1] += out[2].numpy()
            outs.append(out)
        for out in outs[1:]:
            assert torch.equal(out[0], outs[0][0])
            assert torch.equal(out[3], outs[0][3])
        pt1.append(outs[0][0].numpy())
        xx += float(outs[0][3])
    return np.concatenate(pt1), p1, px, xx


@pytest.mark.parametrize("shape,m,n", [((2, 2), M, N), ((4, 2), 9, N)],
                         ids=["2x2-uneven", "4x2-empty-source-shard"])
@pytest.mark.parametrize("regime", ["dense", "culled"])
def test_k11_plain_matches_reference_spmd(shape, m, n, regime):
    """The plain K11 path over the shards of one process against the
    reference's SPMD core on the virtual mesh. 9 source rows on 4 source
    shards leave the last one empty (3, 3, 3, 0). Tolerance: 1e-4 of each
    output's largest entry, the repo's kernel criterion (chip_smoke.py
    compare()): at sigma2 = 2e-3 the f32 cancellation in d2 = |y|^2 + |x|^2
    - 2 y.x times 1 / (2 sigma2) = 250 reaches ~1e-4 relative in g, and
    the two packages form d2 in different orders."""
    src, tgt = _sorted_pair(m, n)
    sigma2 = 0.5 if regime == "dense" else 2e-3
    if regime == "culled" and m == M:  # the 2x2 shards cull tile pairs
        ys, xs = torch.as_tensor(src[:151]), torch.as_tensor(tgt[:129])
        mask = pec._active_mask(*pec._tile_bounds(ys, 8),
                                *pec._tile_bounds(xs, TILE),
                                torch.tensor(0.5 / sigma2))
        assert not bool(mask.all())
    want = _reference_spmd(src, tgt, shape, sigma2, 0.1)
    got = _port_spmd(src, tgt, shape, sigma2, 0.1)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-6,
                                   err_msg=name)


def _k11_inputs(m, n, sigma2, tile_m=8, tile_n=64):
    """Sorted clouds of m and n points (m may be 0: an empty source shard)
    with the scalars and the active-tile mask of K11's route."""
    src, tgt = _sorted_pair(M, N)
    ys, xs = torch.as_tensor(src[:m]), torch.as_tensor(tgt[:n])
    scal = pec._scalars(sigma2, 0.1, max(m, 1), n, 3, "cpu")
    mask = pec._active_mask(*pec._tile_bounds(ys, tile_m),
                            *pec._tile_bounds(xs, tile_n), scal[0]) \
        if m else torch.zeros((0, -(-n // tile_n)), dtype=torch.bool)
    return ys, xs, scal, mask, tile_m, tile_n


K11_CASES = [(151, 257, 0.5), (151, 257, 2e-3), (0, 257, 0.5)]
K11_IDS = ["dense", "culled", "empty-source-shard"]


@pytest.mark.parametrize("m,n,sigma2", K11_CASES, ids=K11_IDS)
def test_k11_reduces_the_whole_target_shard_once(m, n, sigma2):
    """One E-step of K11's route hands reduce_den one (n,) f32 tensor, the
    raw sums of every stripe (five stripes of 64 here), once; an empty
    source shard hands zeros."""
    ys, xs, scal, mask, tm, tn = _k11_inputs(m, n, sigma2)
    assert mask.shape[1] == 5
    seen = []
    pec.stash_estep(ys, xs, scal, mask, tm, tn,
                    reduce_den=lambda d: seen.append(d.clone()))
    assert len(seen) == 1
    assert seen[0].shape == (n,) and seen[0].dtype == torch.float32
    assert bool((seen[0] == 0).all()) == (m == 0)


@pytest.mark.parametrize("m,n,sigma2", K11_CASES, ids=K11_IDS)
def test_k11_plain_with_identity_reduction_equals_stash_plain(m, n, sigma2):
    """With a reduction that leaves the sums as they are (one m-shard), the
    plain version of K11's route equals stash_estep_plain without
    reduce_den bit for bit: the same sums, finalized and moved in the same
    order."""
    ys, xs, scal, mask, tm, tn = _k11_inputs(m, n, sigma2)
    got = pec.stash_estep_plain(ys, xs, scal, mask, tm, tn,
                                reduce_den=lambda d: None)
    want = pec.stash_estep_plain(ys, xs, scal, mask, tm, tn)
    for name, a, b in zip(("pt1", "p1", "px", "xx"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.mark.parametrize("name,entry,shape,args,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_cpd_matches_reference(spawned, name, entry, shape, args,
                                       kw):
    idx = [c[0] for c in CASES].index(name)
    outs = [rank[idx] for rank in spawned]
    _same_on_every_rank(outs)
    assert outs[0]["counts"]["esteps"] == ITERS
    src, tgt = _rigid_pair()
    ref_fn = jsh2.registration_cpd_2d if entry == "cpd_2d" \
        else jsh.registration_cpd_sharded
    kw = dict(kw)
    if kw.get("use_culled"):
        kw["culled_interpret"] = True
    want = ref_fn(src, tgt, *args, maxiter=ITERS, tol=0.0,
                  mesh=_jax_mesh(shape), **kw)
    _check(outs[0]["result"], want, name,
           LOWRANK_ATOL if "rank" in kw else ATOL)
    if entry == "cpd_2d" and kw.get("use_culled"):
        # One normalizer reduction per E-step on every rank.
        assert outs[0]["counts"]["den_all_reduce"] == ITERS


def test_batch_sharded_matches_reference(spawned):
    outs = [rank[len(CASES)] for rank in spawned]
    _same_on_every_rank(outs)
    srcs, tgts = _ragged_batch()
    want = jsh.registration_cpd_batch_sharded(
        srcs, tgts, maxiter=ITERS, tol=0.0, mesh=_jax_mesh((4,)))
    assert len(outs[0]["result"]) == len(want) == 6
    for b, (got, ref) in enumerate(zip(outs[0]["result"], want)):
        _check(got, ref, f"pair {b}")


def test_pyramid_mesh_matches_reference(spawned):
    outs = [rank[len(CASES) + 1] for rank in spawned]
    _same_on_every_rank(outs)
    src, tgt = _pyramid_pair()
    want = jpyr.registration_cpd_pyramid(src, tgt, "rigid",
                                         mesh=_jax_mesh((2, 2)), **PYR_KW)
    _check(outs[0]["result"], want, "pyramid")
    assert outs[0]["counts"]["esteps"] == sum(PYR_KW["level_maxiters"])


def test_not_ported_sharded_names_raise():
    for fn in (ppar.registration_filterreg_sharded,
               ppar.registration_bcpd_sharded,
               ppar.registration_gmmtree_sharded,
               ppar.registration_gmmreg_sharded,
               ppar.registration_svr_sharded,
               ppar.registration_filterreg_2d, ppar.registration_bcpd_2d):
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            fn(None, None)
    import probreg_tpu.parallel as jpar

    exported = {k for k in dir(jpar) if k.startswith(("registration_",
                                                       "make_mesh",
                                                       "shard_points",
                                                       "estep_"))}
    assert exported <= set(dir(ppar)), exported - set(dir(ppar))


def test_sharded_stash_cap_refuses_past_the_floor(tmp_path, monkeypatch):
    """The reference's sharded culled runner shrinks tile_n to its stash cap
    and raises past the tile_n = 256 floor (sharded.py:250-262); the port
    does so with the same cap (stash_max_bytes, where the reference's
    cpd_stash_max_bytes carries), on a process group of one gloo rank."""
    import torch.distributed as dist
    from probreg_tpu_torch import config as pcfg

    monkeypatch.setattr(pcfg.config, "stash_max_bytes", 1 << 10)
    src, tgt = _rigid_pair()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = ppar.make_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="even at the tile_n=256 floor"):
            ppar.registration_cpd_sharded(src, tgt, mesh=mesh,
                                          use_culled=True, device="cpu")
        # The dense branch keeps no stash and runs.
        res = ppar.registration_cpd_sharded(src, tgt, mesh=mesh, maxiter=2,
                                            device="cpu")
        assert res.transformation.rot.shape == (3, 3)
    finally:
        dist.destroy_process_group()


def test_sharded_nonrigid_refusals(tmp_path):
    """As the reference: the sharded nonrigid field has no packed warm
    start (tf_init_params), and the dense nonrigid model does not run on
    the 2-D mesh (its M x M solve does not distribute); on a process group
    of one gloo rank."""
    import torch.distributed as dist

    src, tgt = _rigid_pair()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        one_d = ppar.make_mesh(device_type="cpu")
        two_d = ppar.make_mesh_2d(1, 1, device_type="cpu")
        with pytest.raises(ValueError, match="tf_init_params"):
            ppar.registration_cpd_sharded(
                src, tgt, "nonrigid", mesh=one_d, device="cpu",
                tf_init_params={"rot": np.eye(3)})
        with pytest.raises(ValueError, match="requires rank="):
            ppar.registration_cpd_2d(src, tgt, "nonrigid", mesh=two_d,
                                     device="cpu")
        with pytest.raises(ValueError, match="tf_init_params"):
            ppar.registration_cpd_2d(src, tgt, "nonrigid", mesh=two_d,
                                     rank=8, device="cpu",
                                     tf_init_params={"rot": np.eye(3)})
    finally:
        dist.destroy_process_group()

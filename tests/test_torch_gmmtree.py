"""GMMTree of the port (probreg_tpu_torch.gmmtree, ops.gmmtree_cuda,
ops.sym3) held to the JAX package.

Both packages take the same numpy inputs on the CPU: the closed-form 3x3
eigensolver, the plain version of the level-EM kernel K9 against the
reference's ``gmmtree_pallas.level_em`` and the plain version of the
registration kernel K10 against ``run_gmmtree_reg_fused``, both in
interpret mode, the twin loops, the steps and the entry points. Trees are
built from the reference's own leaf indices (``jax.random.randint``) or
carried across with ``interop.gmmtree_nodes_from_reference``.

Tolerances, each with its reason:
* eigenvalues 1e-5 of the spectral radius (the trigonometric form in f32
  carries ~1e-6 after the Rayleigh refinement, both packages alike);
  V diag(w) V^T = A to 1e-5 of the radius;
* one K9 iteration: pi 1e-6, mu 1e-5 (tests/test_gmmtree.py:155-202; only
  the order of the sums differs), the hard child exactly, ties included;
* whole builds: the m0 >= lambda_d death rule turns rounding into other,
  equally valid trees (the reference's own twin and kernel part by up to
  27 of 64 leaves here), so they are held to the reference's quality bar
  (tests/test_gmmtree.py:205-258): leaf mass within 0.02, leaf
  log-likelihood within 10 %, and recovery of a known rotation;
* registration on one tree: rot and t 2e-5 (tests/test_gmmtree.py:261-302;
  the port solves the 6 x 6 system in double, the reference in f32);
* masked against unpadded and a batch against its pairs: bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from probreg_tpu import gmmtree as jgt  # noqa: E402
from probreg_tpu.ops import gmmtree_pallas as jgp  # noqa: E402
from probreg_tpu.ops import sym3 as jsym  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu.utils.datagen import blobby_surface  # noqa: E402
from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import gmmtree as pgt  # noqa: E402
from probreg_tpu_torch.ops import gmmtree_cuda as pgc  # noqa: E402
from probreg_tpu_torch.ops import sym3 as psym  # noqa: E402
from probreg_tpu_torch.utils import interop  # noqa: E402
from probreg_tpu_torch.utils import se3_op as pso  # noqa: E402

BUILD = dict(max_level=2, lambda_s=0.001, lambda_d=1e-4)
REG = dict(max_level=2, lambda_c=0.01)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rot(deg):
    return np.asarray(jso.euler2mat(*np.deg2rad(deg)), np.float32)


def _np(tree):
    return [np.asarray(a) for a in tree]


@pytest.fixture(scope="module")
def blob_tree():
    """blobby_surface(400, seed=5), its target rotated by (5, -3, 6)
    degrees, and the reference's tree of the source (key 0)."""
    pts = blobby_surface(400, seed=5).astype(np.float32)
    tree = _np(jgt._build(jnp.asarray(pts), jax.random.PRNGKey(0), **BUILD))
    return pts, (pts @ _rot([5.0, -3.0, 6.0]).T).astype(np.float32), tree


# --------------------------------------------------------------------------
# ops/sym3
# --------------------------------------------------------------------------

def _sym_cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 3, 3))
    rand = a @ a.transpose(0, 2, 1)
    q = np.linalg.qr(rng.standard_normal((4, 3, 3)))[0]
    spectra = np.array([[2.0, 2.0, 2.0],        # isotropic
                        [1.0, 1.0, 3.0],        # repeated smallest
                        [0.5, 4.0, 4.0],        # repeated largest
                        [0.0, 1e-3, 2.0]])      # rank-deficient, flat
    rep = q @ (spectra[:, :, None] * q.transpose(0, 2, 1))
    near = rand[:4] * 1e-3 + np.eye(3)          # near-degenerate
    return {"random": rand, "repeated": rep, "near_degenerate": near}


@pytest.mark.parametrize("case", ["random", "repeated", "near_degenerate"])
def test_sym3_matches_reference(case):
    a = _sym_cases()[case].astype(np.float32)
    radius = np.abs(np.linalg.eigvalsh(a.astype(np.float64))).max(-1)
    w_j = np.asarray(jsym.eigvalsh3(jnp.asarray(a)))
    w_p = psym.eigvalsh3(_t(a)).numpy()
    np.testing.assert_allclose(w_p, w_j, atol=1e-5 * radius.max())
    lam, vec = psym.eigh3(_t(a))
    lam_j, _ = jsym.eigh3(jnp.asarray(a))
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j),
                               atol=1e-5 * radius.max())
    v = vec.double().numpy()
    back = v @ (lam.double().numpy()[:, :, None] * v.transpose(0, 2, 1))
    np.testing.assert_allclose(back, a, atol=1e-5 * radius.max())
    np.testing.assert_allclose(v.transpose(0, 2, 1) @ v,
                               np.broadcast_to(np.eye(3), v.shape),
                               atol=1e-5)


def test_mstep_core_invariant_to_eigenvector_sign_and_basis(blob_tree):
    """The twist M-step uses the eigenvectors only as a weighting basis:
    flipping signs, or rotating the basis inside a repeated eigenvalue,
    leaves it unchanged (so eigh3 need not match the reference's vectors)."""
    pts, tgt, tree = blob_tree
    pi, mu, cov = interop.gmmtree_nodes_from_reference(*tree, device="cpu")
    m0, m1, _ = pgt._reg_estep(_t(tgt), pi, mu, cov, **REG)
    lmd, nn = psym.eigh3(cov)
    ref = pgt._mstep_core(m0, m1, mu, lmd, nn, torch.eye(3), torch.zeros(3))
    flip = nn * torch.tensor([-1.0, 1.0, -1.0])
    got = pgt._mstep_core(m0, m1, mu, lmd, flip, torch.eye(3), torch.zeros(3))
    for a, b in zip(ref, got):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # Equal eigenvalues: any rotation of the basis inside them.
    lmd2 = lmd.clone()
    lmd2[:, 1] = lmd2[:, 0]
    c, s = np.cos(0.7), np.sin(0.7)
    turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32)
    a = pgt._mstep_core(m0, m1, mu, lmd2, nn, torch.eye(3), torch.zeros(3))
    b = pgt._mstep_core(m0, m1, mu, lmd2, nn @ turn, torch.eye(3),
                        torch.zeros(3))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# K9: one level of the build
# --------------------------------------------------------------------------

def _level1_inputs(tie=False):
    """Level 1 of a 2-level tree on blobby_surface(150, seed=1)
    (tests/test_gmmtree.py:155): leaves at 64 indexed points, each point's
    parent the nearest leaf's group. ``tie`` makes leaves 8p + 2 and
    8p + 5 identical, so every point of parent p ties between them."""
    pts = blobby_surface(150, seed=1).astype(np.float32)
    n = pts.shape[0]
    idxs = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (64,), 0, n))
    if tie:
        idxs = idxs.copy()
        idxs[5::8] = idxs[2::8]
    leaf = pts[idxs]
    diff = pts[None] - leaf[:, None]
    cov = np.einsum("kni,knj->kij", diff, diff) / n
    parent = (np.argmin(((pts[:, None] - leaf[None]) ** 2).sum(-1), 1)
              // 8).astype(np.int32)
    return pts, np.full(64, 1 / 8, np.float32), leaf, cov.astype(
        np.float32), parent


@pytest.mark.parametrize("case", ["unmasked", "masked", "tied"])
def test_level_em_plain_one_iteration_matches_reference(case):
    pts, pi, mu, cov, parent = _level1_inputs(tie=case == "tied")
    n = pts.shape[0]
    sm = np.ones(n, np.float32)
    pts_in, parent_in = pts, parent
    if case == "masked":
        # Padding at the tail (the port's wrappers compact to this order).
        pts_in = np.concatenate([pts, np.full((41, 3), 7.0, np.float32)])
        parent_in = np.concatenate([parent, np.zeros(41, np.int32)])
        sm = np.concatenate([sm, np.zeros(41, np.float32)])
    pi_j, mu_j, cov_j, cur_j = (np.asarray(a) for a in jgp.level_em(
        jnp.asarray(pts_in), jnp.asarray(sm), jnp.asarray(pi),
        jnp.asarray(mu), jnp.asarray(cov), jnp.asarray(parent_in), float(n),
        lambda_s=1e18, lambda_d=1e-4, maxiter=1, interpret=True))
    state = pgt._pack_level(_t(pi), _t(mu), _t(cov))[None]
    st, child, diag = pgc.level_em_plain(
        _t(pts_in)[None], torch.tensor([n]), state,
        torch.from_numpy(parent_in.astype(np.int64))[None], lambda_s=1e18,
        lambda_d=1e-4, maxiter=1)
    pi_p, mu_p, cov_p = (a[0].numpy() for a in pgt._unpack_level(st))
    assert float(diag[0, 1]) == 1.0
    np.testing.assert_allclose(pi_p, pi_j, atol=1e-6)
    np.testing.assert_allclose(mu_p, mu_j, atol=1e-5)
    np.testing.assert_allclose(cov_p, cov_j, atol=1e-5)
    np.testing.assert_array_equal(child[0, :n].numpy(), cur_j[:n])
    if case == "tied":
        # Every point of a parent whose winner is a tied pair takes 8p + 2.
        assert not np.any(cur_j[:n] % 8 == 5)
        assert np.any(cur_j[:n] % 8 == 2)


def test_level_em_wrapper_masked_equals_unpadded():
    """level_em on a padded batch of two pairs equals each pair's own run,
    bit for bit, and stops at the same iteration (full depth)."""
    pts, pi, mu, cov, parent = _level1_inputs()
    state = pgt._pack_level(_t(pi), _t(mu), _t(cov))
    half = 100
    x = torch.zeros(2, 150, 3)
    x[0], x[1, :half] = _t(pts), _t(pts[:half])
    par = torch.zeros(2, 150, dtype=torch.int64)
    par[0], par[1, :half] = torch.from_numpy(parent), torch.from_numpy(
        parent[:half])
    kw = dict(lambda_s=1e-3, lambda_d=1e-4)
    st, child, diag = pgc.level_em(x, torch.tensor([150, half]),
                                   torch.stack([state, state]), par, **kw)
    for b, n in enumerate((150, half)):
        one = pgc.level_em(x[b:b + 1, :n], None, state[None],
                           par[b:b + 1, :n], **kw)
        assert torch.equal(st[b], one[0][0])
        assert torch.equal(child[b, :n], one[1][0])
        assert torch.equal(diag[b], one[2][0])
    assert float(diag[0, 1]) > 1
    assert torch.equal(child[1, half:], torch.zeros(50, dtype=torch.int64))


def test_level_em_scratch_and_blocks_per_pair():
    """K9's scratch holds every chunk a pair can have (each parent's
    segment cut into chunks of CHUNK from its start); a pair is shared by
    several blocks only when it has enough chunks and the batch leaves room
    on the card."""
    c = pgc.CHUNK
    for n_cap, segs in ((3 * c + 5, [[0, 0, c, 3 * c + 5, 3 * c + 5],
                                     [0, 7, 7, 7, 2 * c]]),
                        (c, [[0, 1, 2, 3, c]])):
        n_par = len(segs[0]) - 1
        c_cap, l_cap = pgc.scratch_sizes(n_cap, 8 * n_par)
        for seg in segs:
            chunks = sum(-(-(b - a) // c) for a, b in zip(seg, seg[1:]))
            assert chunks <= c_cap and -(-seg[-1] // c) <= l_cap
    assert pgc.scratch_sizes(3 * c + 5, 32) == (4 + 4, 4)
    assert pgc.blocks_per_pair(150_000, 1, 132) == 132
    assert pgc.blocks_per_pair(20_000, 1, 132) == 20
    assert pgc.blocks_per_pair(20_000, 2, 132) == 20
    assert pgc.blocks_per_pair(150_000, 8, 132) == 16
    assert pgc.blocks_per_pair(3_000, 1, 132) == 1      # 3 chunks
    assert pgc.blocks_per_pair(150_000, 40, 132) == 1   # 3 blocks a pair
    assert pgc.blocks_per_pair(1024, 256, 132) == 1     # the batch fills it


@pytest.mark.parametrize("n_cap,batch,capacity,blocks,c_cap", [
    (150_000, 1, 132, 132, 147),   # the 150k pair: one block an SM
    (150_000, 1, 264, 147, 147),   # room for more: one block a chunk
    (150_000, 2, 132, 66, 147),
    (20_000, 8, 132, 16, 20),
    (2000, 3, 132, 1, 2),          # 2 chunks: one block
    (1024, 256, 132, 1, 1),        # the serving batch fills the card
])
def test_reg_scratch_and_blocks_per_pair(n_cap, batch, capacity, blocks,
                                         c_cap):
    """K10 takes blocks_per_pair blocks per pair against its own capacity
    and keeps the T x [m0, m1] partials of every chunk twice (one buffer
    per iteration parity); the chunks c = r, r + G, ... of blocks r < G
    cover each chunk of a pair once."""
    t_nodes = 72
    got = pgc.blocks_per_pair(n_cap, batch, capacity)
    assert got == blocks and batch * got <= max(capacity, batch)
    assert pgc.reg_scratch_sizes(n_cap, t_nodes) == (
        c_cap, 2 * c_cap * 4 * t_nodes)
    walked = sorted(c for r in range(got) for c in range(r, c_cap, got))
    assert walked == list(range(c_cap))


# --------------------------------------------------------------------------
# The build
# --------------------------------------------------------------------------

def _leaf_ll(pts, pi, mu, cov):
    inv, norm, _ = jgt._log_pdf_terms(jnp.asarray(cov[8:72]))
    n = pts.shape[0]
    p = jnp.asarray(pi[None, 8:72]) * jgt._pdf(
        jnp.asarray(pts), jnp.broadcast_to(jnp.asarray(mu[8:72]),
                                           (n, 64, 3)),
        jnp.broadcast_to(inv, (n, 64, 3, 3)), jnp.broadcast_to(norm,
                                                               (n, 64)))
    return float(jnp.sum(jnp.log(jnp.maximum(jnp.sum(p, 1), 1e-15))))


def _recovers(pts, tree):
    rot = _rot([5.0, -3.0, 6.0])
    tgt = (pts @ rot.T).astype(np.float32)
    pi, mu, cov = interop.gmmtree_nodes_from_reference(*tree, device="cpu")
    r, _, _ = pgt._run_registration(_t(tgt), pi, mu, cov, torch.eye(3),
                                    torch.zeros(3), **REG, maxiter=30,
                                    tol=1e-6)
    return float(pso.rotation_angle(r.T.double(), torch.from_numpy(
        rot).double()))


@pytest.mark.parametrize("fused", [False, True])
def test_build_meets_reference_quality(fused):
    """The port's build from the reference's leaf indices, through the twin
    level loop or the K9 route (its plain version on the CPU), against the
    reference's twin build at full depth (see the module docstring)."""
    pts = blobby_surface(400, seed=5).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ref = _np(jgt._build(jnp.asarray(pts), key, **BUILD))
    idxs = torch.from_numpy(np.asarray(
        jax.random.randint(key, (64,), 0, 400)).astype(np.int64))
    got = [a.numpy() for a in pgt._build(_t(pts), idxs, fused=fused,
                                         **BUILD)]
    assert got[0].shape == (72,) and got[2].shape == (72, 3, 3)
    # Level 0 has no death in either: the same to rounding.
    np.testing.assert_allclose(got[0][:8], ref[0][:8], atol=1e-5)
    np.testing.assert_allclose(got[1][:8], ref[1][:8], atol=1e-4)
    assert got[0][8:].sum() >= ref[0][8:].sum() - 0.02
    ll_ref, ll_got = _leaf_ll(pts, *ref), _leaf_ll(pts, *got)
    assert ll_got >= ll_ref - 0.10 * abs(ll_ref), (ll_ref, ll_got)
    assert _recovers(pts, got) < 5e-2


def test_masked_build_is_the_unpadded_build():
    """On the K9 route the wrapper compacts, so a padded cloud gets its
    unpadded tree bit for bit. The twin loop keeps the reference's masks
    (padded rows join its sums with weight 0, which moves their rounding):
    level 0 agrees to rounding, and the leaves by the quality bar."""
    pts = blobby_surface(200, seed=2).astype(np.float32)
    idxs = torch.from_numpy(np.random.default_rng(1).integers(0, 200, 64))
    padded = torch.cat([_t(pts), torch.full((30, 3), 5.0)])
    smask = torch.cat([torch.ones(200), torch.zeros(30)])
    plain = pgt._build(_t(pts), idxs, fused=True, **BUILD)
    masked = pgt._build(padded, idxs, smask=smask, fused=True, **BUILD)
    for a, b in zip(plain, masked):
        assert torch.equal(a, b)
    plain = [a.numpy() for a in pgt._build(_t(pts), idxs, **BUILD)]
    masked = [a.numpy() for a in pgt._build(padded, idxs, smask=smask,
                                            **BUILD)]
    np.testing.assert_allclose(masked[0][:8], plain[0][:8], atol=1e-5)
    np.testing.assert_allclose(masked[1][:8], plain[1][:8], atol=1e-4)
    assert masked[0][8:].sum() >= plain[0][8:].sum() - 0.02
    ll_p, ll_m = _leaf_ll(pts, *plain), _leaf_ll(pts, *masked)
    assert ll_m >= ll_p - 0.10 * abs(ll_p), (ll_p, ll_m)


# --------------------------------------------------------------------------
# K10 and the registration loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 57])
def test_reg_plain_matches_reference_kernel(blob_tree, pad):
    pts, tgt, tree = blob_tree
    kw = dict(**REG, maxiter=25, tol=1e-6)
    r0, t0 = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
    tgt_p = np.concatenate([tgt, np.zeros((pad, 3), np.float32)])
    tm = np.concatenate([np.ones(len(tgt)), np.zeros(pad)]).astype(
        np.float32)
    rj, tj, qj = jgp.run_gmmtree_reg_fused(
        jnp.asarray(tgt_p), *(jnp.asarray(a) for a in tree), r0, t0,
        jnp.asarray(tm) if pad else None, interpret=True, **kw)
    nodes = interop.gmmtree_nodes_from_reference(*tree, device="cpu")
    rp, tp, qp, it = pgc.run_gmmtree_reg_fused(
        _t(tgt_p), *nodes, tmask=_t(tm) if pad else None, **kw)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=2e-5)
    assert 1 < int(it) < 25
    if pad:
        one = pgc.run_gmmtree_reg_fused(_t(tgt), *nodes, **kw)
        for a, b in zip((rp, tp, qp, it), one):
            assert torch.equal(a, b)


def test_reg_plain_warm_start_and_batch(blob_tree):
    """A warm start (rot0, t0) against the reference kernel's; a ragged
    batch of two trees is its pairs bit for bit."""
    pts, tgt, tree = blob_tree
    kw = dict(**REG, maxiter=6, tol=0.0)
    r0 = _rot([1.0, 2.0, -1.0])
    t0 = np.array([0.01, -0.02, 0.005], np.float32)
    rj, tj, _ = jgp.run_gmmtree_reg_fused(
        jnp.asarray(tgt), *(jnp.asarray(a) for a in tree), jnp.asarray(r0),
        jnp.asarray(t0), interpret=True, **kw)
    nodes = interop.gmmtree_nodes_from_reference(*tree, device="cpu")
    rp, tp, _, it = pgc.run_gmmtree_reg_fused(_t(tgt), *nodes, _t(r0),
                                              _t(t0), **kw)
    assert int(it) == 6
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=2e-5)
    other = pgt._build(_t(pts[::2]), torch.arange(64) * 3, **BUILD)
    trees = [torch.stack(a) for a in zip(nodes, other)]
    tg = torch.zeros(2, 400, 3)
    tg[0], tg[1, :300] = _t(tgt), _t(tgt[:300])
    tm = torch.zeros(2, 400)
    tm[0], tm[1, :300] = 1.0, 1.0
    batch = pgc.run_gmmtree_reg_fused_batch(tg, *trees, tmasks=tm, **kw)
    for b, n in enumerate((400, 300)):
        one = pgc.run_gmmtree_reg_fused(tg[b, :n], *(a[b] for a in trees),
                                        **kw)
        for x, y in zip(batch, one):
            assert torch.equal(x[b], y)


def test_run_registration_matches_twin(blob_tree):
    pts, tgt, tree = blob_tree
    kw = dict(**REG, maxiter=8, tol=0.0)
    r0, t0 = _rot([0.5, 0.0, -1.0]), np.array([0.0, 0.01, 0.0], np.float32)
    rj, tj, qj = jgt._run_registration(
        jnp.asarray(tgt), *(jnp.asarray(a) for a in tree), jnp.asarray(r0),
        jnp.asarray(t0), **kw)
    nodes = interop.gmmtree_nodes_from_reference(*tree, device="cpu")
    rp, tp, qp = pgt._run_registration(_t(tgt), *nodes, _t(r0), _t(t0), **kw)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(float(qp), float(qj), rtol=1e-3)
    # Masked: padded columns carry no weight.
    tm = np.concatenate([np.ones(400), np.zeros(20)]).astype(np.float32)
    tg = np.concatenate([tgt, np.ones((20, 3), np.float32)])
    rm, tmv, _ = pgt._run_registration(_t(tg), *nodes, _t(r0), _t(t0),
                                       tmask=_t(tm), **kw)
    np.testing.assert_allclose(rm.numpy(), rp.numpy(), atol=1e-6)
    np.testing.assert_allclose(tmv.numpy(), tp.numpy(), atol=1e-6)


def test_steps_match_reference(blob_tree):
    pts, tgt, tree = blob_tree
    gt_j = jgt.GMMTree(tree_level=2)
    gt_j._nodes = tuple(jnp.asarray(a) for a in tree)
    gt_p = pgt.GMMTree(tree_level=2, device="cpu")
    gt_p._nodes = interop.gmmtree_nodes_from_reference(*tree, device="cpu")
    moved = (tgt @ _rot([1.0, -1.0, 2.0]).T).astype(np.float32)
    est_j = gt_j.expectation_step(jnp.asarray(moved))
    est_p = gt_p.expectation_step(moved)
    for a, b in zip(est_p.moments, est_j.moments):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=1e-4)
    from probreg_tpu.models import transformation as jtf
    from probreg_tpu_torch.models import transformation as ptf

    tr_j = jtf.RigidTransformation(jnp.eye(3), jnp.zeros(3))
    tr_p = ptf.RigidTransformation(device="cpu")
    m_j = gt_j.maximization_step(est_j, tr_j)
    m_p = gt_p.maximization_step(est_p, tr_p)
    np.testing.assert_allclose(m_p.transformation.rot.numpy(),
                               np.asarray(m_j.transformation.rot), atol=1e-5)
    np.testing.assert_allclose(m_p.transformation.t.numpy(),
                               np.asarray(m_j.transformation.t), atol=1e-5)
    np.testing.assert_allclose(float(m_p.q), float(m_j.q), rtol=1e-3)


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _carry_single(monkeypatch, tree):
    """Make the port's GMMTree take the reference's tree as its own."""
    nodes = interop.gmmtree_nodes_from_reference(*tree, device="cpu")

    def set_source(self, source):
        self._nodes = nodes

    monkeypatch.setattr(pgt.GMMTree, "set_source", set_source)


def test_registration_gmmtree_matches_reference(blob_tree, monkeypatch):
    pts, tgt, _ = blob_tree
    ref = jgt.registration_gmmtree(pts, tgt, maxiter=20, tol=0.0)
    _carry_single(monkeypatch, _np(jgt.GMMTree(pts, tree_level=2)._nodes))
    got = pgt.registration_gmmtree(pts, tgt, maxiter=20, tol=0.0,
                                   device="cpu")
    np.testing.assert_allclose(got.transformation.rot.numpy(),
                               np.asarray(ref.transformation.rot), atol=2e-5)
    np.testing.assert_allclose(got.transformation.t.numpy(),
                               np.asarray(ref.transformation.t), atol=2e-5)
    # The returned transformation maps source to target.
    err = float(pso.rotation_angle(got.transformation.rot.double(),
                                   torch.from_numpy(_rot([5.0, -3.0, 6.0]))
                                   .double()))
    assert err < 5e-2


@pytest.mark.parametrize("ragged", [False, True])
def test_registration_gmmtree_batch_matches_reference(monkeypatch, ragged):
    """Fixed-size and ragged batches on trees carried from the reference,
    against the reference's registration loop on each pair (its batch
    entry point is that loop under vmap)."""
    rng = np.random.default_rng(7)
    pairs = []
    # Targets are rotated subsets of their sources, 360-420 points: on
    # other samples, or at ~150 points where leaves of two or three points
    # have near-singular covariances, a point near a tie of the descent
    # flips between the two packages and the poses part by ~1e-3.
    sizes = [(420, 400), (380, 360), (400, 400)] if ragged \
        else [(400, 400)] * 3
    for s, (m, n) in enumerate(sizes):
        src = blobby_surface(m, seed=10 + s)
        rot = _rot(rng.uniform(-6, 6, 3))
        tgt = (src[:n] @ rot.T).astype(np.float32)
        pairs.append((src, tgt, rot))
    srcs, tgts = [p[0] for p in pairs], [p[1] for p in pairs]
    kw = dict(maxiter=10, tol=0.0)
    trees = [_np(jgt._build(jnp.asarray(s), jax.random.PRNGKey(i), **BUILD))
             for i, s in enumerate(srcs)]
    carried = tuple(torch.stack(a) for a in zip(*(
        interop.gmmtree_nodes_from_reference(*t, device="cpu")
        for t in trees)))
    monkeypatch.setattr(pgt, "_build_batch", lambda *a, **k: carried)
    got = pgt.registration_gmmtree_batch(
        srcs if ragged else np.stack(srcs),
        tgts if ragged else np.stack(tgts), device="cpu", **kw)
    assert len(got) == len(pairs)
    for r_p, tree, tgt, (_, _, rot) in zip(got, trees, tgts, pairs):
        r_j, t_j, _ = jgt._run_registration(
            jnp.asarray(tgt), *(jnp.asarray(a) for a in tree), jnp.eye(3),
            jnp.zeros(3), **REG, **kw)
        inv = jgt.tf.RigidTransformation(r_j, t_j).inverse()
        np.testing.assert_allclose(r_p.transformation.rot.numpy(),
                                   np.asarray(inv.rot), atol=2e-5)
        np.testing.assert_allclose(r_p.transformation.t.numpy(),
                                   np.asarray(inv.t), atol=2e-5)


def test_batch_is_its_pairs_on_the_kernel_routes(monkeypatch):
    """With the kernels' gates open on the CPU (their plain versions run),
    a ragged batch equals each pair registered alone in a batch of one,
    bit for bit: the build (one K9 call per level for the batch) and the
    registration (one K10 call)."""
    monkeypatch.setattr(pgt, "_fused_build_ok", lambda *a: True)
    monkeypatch.setattr(pgt, "_fused_reg_ok", lambda *a: True)
    srcs = [blobby_surface(m, seed=m) for m in (120, 90)]
    tgts = [(blobby_surface(n, seed=n) @ _rot([3.0, 0.0, -4.0]).T).astype(
        np.float32) for n in (100, 130)]
    kw = dict(maxiter=15, tol=1e-5)
    batch = pgt.registration_gmmtree_batch(srcs, tgts, seed=3, device="cpu",
                                           **kw)
    # Pair 0 draws its leaves first from the seed, so a batch of it alone
    # draws the same ones.
    alone = pgt.registration_gmmtree_batch(srcs[:1], tgts[:1], seed=3,
                                           device="cpu", **kw)
    assert torch.equal(batch[0].transformation.rot,
                       alone[0].transformation.rot)
    assert torch.equal(batch[0].transformation.t, alone[0].transformation.t)
    # Pair 1 alone on the leaves it drew in the batch.
    idxs = pgt._leaf_indices(3, [120, 90], 64, "cpu")
    assert not torch.equal(idxs[0], idxs[1])
    monkeypatch.setattr(pgt, "_leaf_indices",
                        lambda seed, counts, n, dev: idxs[1:])
    alone = pgt.registration_gmmtree_batch(srcs[1:], tgts[1:], seed=3,
                                           device="cpu", **kw)
    assert torch.equal(batch[1].transformation.rot,
                       alone[0].transformation.rot)
    assert torch.equal(batch[1].transformation.t, alone[0].transformation.t)
    assert torch.equal(batch[1].q, alone[0].q)


def test_horse_recovery(horse_cloud):
    """tests/test_gmmtree.py:13-21 on the port's own tree."""
    src = np.asarray(horse_cloud, dtype=np.float32)
    ang = np.deg2rad([5.0, -3.0, 4.0])
    tgt = src @ _rot(np.rad2deg(ang)).T
    res = pgt.registration_gmmtree(src, tgt, maxiter=30, tol=1e-6,
                                   device="cpu")
    rec = pso.mat2euler(res.transformation.rot.double()).numpy()
    np.testing.assert_allclose(rec, ang, atol=5e-2)
    np.testing.assert_allclose(res.transformation.t.numpy(), 0.0, atol=5e-3)


def test_callbacks_path_matches_reference(horse_cloud, monkeypatch):
    src = np.asarray(horse_cloud, dtype=np.float32)[::3]
    tgt = (src @ _rot([4.0, 0.0, -3.0]).T).astype(np.float32)
    tree = _np(jgt.GMMTree(src, tree_level=2)._nodes)
    seen_j, seen_p = [], []
    ref = jgt.registration_gmmtree(src, tgt, maxiter=6, tol=0.0,
                                   callbacks=[seen_j.append])
    _carry_single(monkeypatch, tree)
    got = pgt.registration_gmmtree(src, tgt, maxiter=6, tol=0.0,
                                   callbacks=[seen_p.append], device="cpu")
    assert len(seen_p) == len(seen_j) == 6
    for a, b in zip(seen_p, seen_j):
        np.testing.assert_allclose(a.rot.numpy(), np.asarray(b.rot),
                                   atol=2e-5)
    np.testing.assert_allclose(got.transformation.t.numpy(),
                               np.asarray(ref.transformation.t), atol=2e-5)
    # The callbacks loop and the loop without them land together.
    plain = pgt.registration_gmmtree(src, tgt, maxiter=6, tol=0.0,
                                     device="cpu")
    np.testing.assert_allclose(plain.transformation.rot.numpy(),
                               got.transformation.rot.numpy(), atol=2e-5)


def test_unported_paths_and_devices_raise():
    pts = blobby_surface(60, seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pgt.registration_gmmtree(pts, pts, n_starts=4, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pgt.registration_gmmtree(pts, pts, callback_chunk=4, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pgt.registration_gmmtree_batch(pts[None], pts[None], n_starts=2,
                                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pgt.registration_gmmtree(pts, pts)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pgt.registration_gmmtree_batch(pts[None], pts[None])
    assert pcfg.config.device == "cuda"
    # The kernels' gates: K9 to 3 levels, K10 to 2 (shared memory).
    assert pgc.fused_build_ok(3) and not pgc.fused_build_ok(4)
    assert pgc.fused_reg_ok(2) and not pgc.fused_reg_ok(3)
    with pytest.raises(ValueError, match="shared memory"):
        pgc.run_gmmtree_reg_fused(torch.zeros(10, 3), torch.zeros(584),
                                  torch.zeros(584, 3),
                                  torch.eye(3).expand(584, 3, 3),
                                  max_level=3, lambda_c=0.01, maxiter=1,
                                  tol=0.0)

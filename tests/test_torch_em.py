"""The port's whole-EM CPD (probreg_tpu_torch.ops.em_cuda) held to the JAX
package.

The same numpy clouds go through the JAX package's fused kernel (Pallas in
interpret mode) or its twin ``cpd._run_em_t``, and through the port's
``run_em_*_fused``, which on CPU tensors run the plain version of the CUDA
kernel.

Tolerances: lin and t 2e-4 absolute, sigma2 1e-3 relative. That is the JAX
package's own tolerance between its fused kernel and its twin
(tests/test_em_pallas_interpret.py): Horn's quaternion solve and the SVD
agree to ~1e-6 per iteration and the EM amplifies it. The M-step functions
alone agree to 1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from probreg_tpu import cpd as jcpd  # noqa: E402
from probreg_tpu.ops import em_pallas as jem  # noqa: E402
from probreg_tpu.ops import estep as jeo  # noqa: E402
from probreg_tpu.utils import se3_op as jso  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch.ops import em_cuda as pem  # noqa: E402
from probreg_tpu_torch.utils import math_utils as pmu  # noqa: E402

ATOL, RTOL_S2 = 2e-4, 1e-3


def _clouds(n=100, deg=(5.0, -3.0, 7.0), seed=0, noise=0.0, m=None):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rot = np.asarray(jso.euler2mat(*np.deg2rad(deg)), np.float32)
    tgt = (src @ rot.T + np.float32([0.05, -0.02, 0.03])
           + rng.normal(0, noise, src.shape)).astype(np.float32)
    return src[:m], tgt, rot


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_close(ref, out):
    """(lin, t, sigma2) triples."""
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=ATOL)
    np.testing.assert_allclose(float(out[2]), float(ref[2]), rtol=RTOL_S2)


@pytest.mark.parametrize("update_scale,w,noise", [(True, 0.0, 0.0),
                                                  (False, 0.0, 0.01),
                                                  (True, 0.1, 0.01)])
def test_rigid_fused_matches_reference_kernel(update_scale, w, noise):
    src, tgt, _ = _clouds(noise=noise, m=80)
    kw = dict(w=w, maxiter=25, tol=1e-6, update_scale=update_scale)
    rot_r, t_r, scale_r, s2_r, _ = jem.run_em_rigid_fused(
        src, tgt, interpret=True, **kw)
    rot, t, scale, s2, q = pem.run_em_rigid_fused(_t(src), _t(tgt), **kw)
    _assert_close((np.asarray(rot_r) * float(scale_r), t_r, s2_r),
                  (rot * scale, t, s2))
    assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
    if not update_scale:
        assert float(scale) == pytest.approx(1.0, abs=1e-6)
    # ... and the reference's twin, which centres like the port.
    lin_x, t_x, scale_x, s2_x, _ = jcpd._run_em_t(src, tgt, kind="rigid",
                                                  **kw)
    _assert_close((np.asarray(lin_x) * float(scale_x), t_x, s2_x),
                  (rot * scale, t, s2))


@pytest.mark.parametrize("w,noise", [(0.0, 0.0), (0.1, 0.01)])
def test_affine_fused_matches_reference_kernel(w, noise):
    src, tgt, _ = _clouds(seed=1, noise=noise)
    tgt = (tgt * np.float32([1.1, 0.9, 1.05])).astype(np.float32)
    kw = dict(w=w, maxiter=25, tol=1e-6)
    ref = jem.run_em_affine_fused(src, tgt, interpret=True, **kw)
    out = pem.run_em_affine_fused(_t(src), _t(tgt), **kw)
    _assert_close(ref[:3], out[:3])
    lin_x, t_x, _, s2_x, _ = jcpd._run_em_t(src, tgt, kind="affine",
                                            update_scale=False, **kw)
    _assert_close((lin_x, t_x, s2_x), out[:3])


def _ragged_pair(m, n, cap, seed):
    """A pair of m x n valid points padded to cap, with its 0/1 masks."""
    src, tgt, _ = _clouds(n=max(m, n), seed=seed, noise=0.01)
    src_p, tgt_p = np.zeros((2, cap, 3), np.float32)
    smask, tmask = np.zeros((2, cap), np.float32)
    src_p[:m], smask[:m] = src[:m], 1.0
    tgt_p[:n], tmask[:n] = tgt[:n], 1.0
    return src_p, tgt_p, smask, tmask


@pytest.mark.parametrize("kind", ["rigid", "affine"])
def test_masked_pair_matches_reference_kernel_and_the_unpadded_pair(kind):
    m, n, cap = 60, 75, 96
    src_p, tgt_p, smask, tmask = _ragged_pair(m, n, cap, seed=3)
    kw = dict(w=0.05, maxiter=20, tol=1e-6, update_scale=True, kind=kind)
    ref = jem._run_em_cpd_fused(src_p, tgt_p, smask, tmask, interpret=True,
                                **kw)
    out = pem._run_em_cpd_fused(_t(src_p), _t(tgt_p), _t(smask), _t(tmask),
                                **kw)
    _assert_close(ref[:3], out[:3])
    # Padding carries exactly zero mass: the same numbers as without it.
    bare = pem._run_em_cpd_fused(_t(src_p[:m]), _t(tgt_p[:n]), **kw)
    for a, b in zip(out, bare):
        assert torch.equal(a, b)
    # A mask that is not a prefix: the same registration again.
    perm = np.random.default_rng(0).permutation(cap)
    out_p = pem._run_em_cpd_fused(_t(src_p[perm]), _t(tgt_p), _t(smask[perm]),
                                  _t(tmask), **kw)
    _assert_close(out[:3], out_p[:3])


def test_fused_batch_matches_reference_ragged_batch():
    pairs = [_ragged_pair(m, n, 80, seed) for seed, (m, n) in
             enumerate([(80, 64), (50, 80), (33, 47)])]
    srcs, tgts, smasks, tmasks = (np.stack(x) for x in zip(*pairs))
    kw = dict(kind="rigid", w=0.05, maxiter=20, tol=1e-5, update_scale=True)
    lin_r, t_r, scale_r, s2_r, _ = jcpd._run_em_t_ragged_batch(
        jnp.asarray(srcs), jnp.asarray(tgts), jnp.asarray(smasks),
        jnp.asarray(tmasks), **kw)
    lin, t, s2, q, it = pem.run_em_cpd_fused_batch(
        _t(srcs), _t(tgts), _t(smasks), _t(tmasks), **kw)
    assert lin.shape == (3, 3, 3) and it.shape == (3,)
    for b in range(3):
        _assert_close((np.asarray(lin_r[b]) * float(scale_r[b]), t_r[b],
                       s2_r[b]), (lin[b], t[b], s2[b]))
    # The port's own plain ragged loop (the path beyond the kernel's sizes).
    lin_p, t_p, scale_p, s2_p, _ = pcpd._run_em_t_ragged_batch(
        _t(srcs), _t(tgts), _t(smasks), _t(tmasks), **kw)
    for b in range(3):
        _assert_close((np.asarray(lin_r[b]), t_r[b], s2_r[b]),
                      (lin_p[b], t_p[b], s2_p[b]))
        np.testing.assert_allclose(float(scale_p[b]), float(scale_r[b]),
                                   atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_run_em_t_affine_matches_reference(masked):
    src, tgt, _ = _clouds(seed=4, noise=0.01)
    tgt = (tgt * np.float32([1.2, 0.95, 1.0])).astype(np.float32)
    kw = dict(kind="affine", w=0.1, maxiter=30, tol=1e-6, update_scale=False)
    masks_j, masks_p = {}, {}
    if masked:
        src_p, tgt_p, smask, tmask = _ragged_pair(70, 90, 100, seed=4)
        src, tgt = src_p, tgt_p
        masks_j = dict(smask=jnp.asarray(smask), tmask=jnp.asarray(tmask))
        masks_p = dict(smask=_t(smask), tmask=_t(tmask))
    ref = jcpd._run_em_t(src, tgt, **kw, **masks_j)
    out = pcpd._run_em_t(_t(src), _t(tgt), **kw, **masks_p)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-4,
                               atol=1e-5)
    assert float(out[2]) == 1.0
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-3)


def test_affine_msteps_match_reference():
    src, tgt, _ = _clouds(n=200, seed=6, noise=0.02)
    jmom = jeo.estep_xla(src, tgt, np.float32(0.05), 0.1)
    pmom = pcpd.EstepMoments(*[_t(a) for a in jmom])
    ref = jcpd.affine_maximization_step(src, jmom)
    out = pcpd.affine_maximization_step(_t(src), pmom)
    np.testing.assert_allclose(out.transformation.b.numpy(),
                               np.asarray(ref.transformation.b), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(out.transformation.t.numpy(),
                               np.asarray(ref.transformation.t), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(out.sigma2), float(ref.sigma2),
                               rtol=1e-4)
    np.testing.assert_allclose(float(out.q), float(ref.q), rtol=1e-4)
    ref_t = jcpd._affine_mstep_t(jnp.asarray(src.T), jmom.p1, jmom.px.T,
                                 jmom.n_p, jmom.xx)
    out_t = pcpd._affine_mstep_t(_t(src.T), pmom.p1, pmom.px.T, pmom.n_p,
                                 pmom.xx)
    for a, b in zip(ref_t, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)


def test_masked_squared_kernel_sum_matches_reference():
    src_p, tgt_p, smask, tmask = _ragged_pair(40, 55, 64, seed=7)
    ref = jcpd.mu.masked_squared_kernel_sum_t(src_p.T, tgt_p.T, smask, tmask)
    out = pmu.masked_squared_kernel_sum_t(_t(src_p.T), _t(tgt_p.T),
                                          _t(smask), _t(tmask))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    bare = pmu.squared_kernel_sum(_t(src_p[:40]), _t(tgt_p[:55]))
    np.testing.assert_allclose(float(out), float(bare), rtol=1e-5)


@pytest.mark.parametrize("keep", [2, 1])
def test_degenerate_clouds_give_proper_rotations(keep):
    """A planar (keep=2) or collinear (keep=1) cloud ties the top
    eigenvalues of Horn's matrix; the rotation must stay proper."""
    rng = np.random.default_rng(8)
    src = np.zeros((120, 3), np.float32)
    src[:, :keep] = rng.uniform(-1, 1, (120, keep))
    tgt = src + rng.normal(0, 0.01, src.shape).astype(np.float32)
    tgt[:, keep:] = 0.0
    rot, t, scale, s2, q = pem.run_em_rigid_fused(_t(src), _t(tgt),
                                                  maxiter=15, tol=1e-6)
    assert bool(torch.isfinite(rot).all()) and bool(torch.isfinite(s2))
    assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
    np.testing.assert_allclose((rot @ rot.T).numpy(), np.eye(3), atol=1e-5)
    # The cloud itself is mapped back onto the target.
    moved = (_t(src) @ rot.T) * scale + t
    assert float((moved - _t(tgt)).abs().max()) < 0.1


def test_fused_dims_gate_and_wrapper_checks():
    assert pem.fused_dims_ok(1024, 1024) and pem.fused_dims_ok(7000, 149)
    assert not pem.fused_dims_ok(7200, 10)      # 32 B per source point
    assert not pem.fused_dims_ok(10, 11500)     # 20 B per target point
    assert not pem.fused_dims_ok(16384, 16384)  # the reference's TPU cap
    pts = torch.zeros((1, 10, 3))
    with pytest.raises(ValueError, match="3-D"):
        pem.run_em_cpd_fused_batch(torch.zeros((1, 10, 2)),
                                   torch.zeros((1, 10, 2)))
    with pytest.raises(ValueError, match="float32"):
        pem.run_em_cpd_fused_batch(pts.double(), pts.double())
    with pytest.raises(ValueError, match="both masks"):
        pem.run_em_cpd_fused_batch(pts, pts, torch.ones((1, 10)))
    with pytest.raises(ValueError, match="shared memory"):
        pem.run_em_cpd_fused_batch(torch.zeros((1, 8000, 3)), pts)
    with pytest.raises(ValueError, match="empty"):
        pem.run_em_cpd_fused_batch(torch.zeros((1, 0, 3)), pts)
    # maxiter = 0 returns the start: identity, sigma2_0, q0, no iteration.
    src, tgt, _ = _clouds(n=30)
    lin, t, s2, q, it = pem._run_em_cpd_fused(_t(src), _t(tgt), maxiter=0)
    assert torch.equal(lin, torch.eye(3)) and int(it) == 0
    np.testing.assert_allclose(
        float(s2), float(pmu.squared_kernel_sum(_t(src), _t(tgt))), rtol=1e-5)


@pytest.mark.parametrize("batch,sms,want", [
    (1, 132, 8),      # the bunny: one pair on 8 SMs
    (16, 132, 8),
    (17, 132, 4),
    (33, 132, 4),
    (64, 132, 2),     # the affine serving batch
    (66, 132, 2),
    (67, 132, 1),
    (256, 132, 1),    # the rigid serving batch: one block a pair
    (3, 16, 4),
])
def test_cluster_size_from_batch_and_sms(batch, sms, want):
    """K1's blocks per pair: the largest of 8, 4, 2 whose clusters for the
    whole batch fit the SMs at one block an SM, else 1."""
    assert pem.cluster_size(batch, sms) == want
    assert want == 1 or batch * want <= sms


def test_work_order_is_largest_first_and_its_inverse_restores_order():
    """Pairs by m n, largest first, ties by index; the kernel writes block
    b's result at row order[b], so scattering the blocks' results by the
    order gives back the caller's order."""
    counts = torch.tensor([[300, 400], [1024, 1024], [400, 300], [10, 10],
                           [1024, 1024], [512, 600], [600, 512], [1, 1]],
                          dtype=torch.int32)
    order = pem.work_order(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 4, 5, 6, 0, 2, 3, 7]
    key = (counts[:, 0] * counts[:, 1]).long()
    per_block = key[order.long()]       # what block b works on
    assert bool((per_block[:-1] >= per_block[1:]).all())
    rows = torch.empty_like(per_block).index_copy_(0, order.long(),
                                                   per_block)
    assert torch.equal(rows, key)
    rng = np.random.default_rng(3)
    counts = torch.as_tensor(rng.integers(300, 1025, (256, 2)),
                             dtype=torch.int32)
    order = pem.work_order(counts).long()
    assert sorted(order.tolist()) == list(range(256))
    key = (counts[:, 0] * counts[:, 1]).long()
    want = sorted(range(256), key=lambda b: (-int(key[b]), b))
    assert order.tolist() == want


def _ragged_counts(batch, seed=3):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(300, 1025, (batch, 2)),
                           dtype=torch.int32)


@pytest.mark.parametrize("case,batch,ragged,want_g,ordered", [
    ("single pair", 1, False, 8, False),
    ("64 pairs", 64, True, 2, False),         # 128 blocks fit 132 SMs
    ("256 ragged pairs", 256, True, 1, True),
    ("fixed-size batch", 256, False, 1, False),
])
def test_launch_plan_blocks_and_order(case, batch, ragged, want_g, ordered):
    """The launch plan of K1, K5 and K7 on 132 SMs: cluster_size's blocks
    per pair, and the work order only for a ragged batch whose blocks
    outnumber the SMs; the hooks force the blocks and the arrival order."""
    counts = _ragged_counts(batch) if ragged else None
    g, order = pem.launch_plan(batch, counts, 132)
    assert g == want_g == pem.cluster_size(batch, 132)
    if ordered:
        assert torch.equal(order, pem.work_order(counts))
    else:
        assert order is None
    g, order = pem.launch_plan(batch, counts, 132, cluster=8)
    assert g == 8
    assert (order is not None) == ragged      # batch * 8 > 132
    assert pem.launch_plan(batch, counts, 132, cluster=8,
                           ordered=False) == (8, None)


class _StubLib:
    """A stand-in for a kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("kernel", ["frg_pt2pt", "frg_pt2pl", "icp"])
@pytest.mark.parametrize("batch", [1, 256])
def test_frg_and_icp_launch_through_the_launch_plan(monkeypatch, kernel,
                                                    batch):
    """K5's and K7's wrappers take the blocks per pair and the work order
    from em_cuda.launch_plan and hand both to their kernel, once per
    launch (a stub library on the CPU stands in for the built one)."""
    from probreg_tpu_torch.ops import frg_cuda as pfc
    from probreg_tpu_torch.ops import icp_cuda as pic

    plans, plan = [], pem.launch_plan

    def spy(*a, **k):
        plans.append(plan(*a, **k))
        return plans[-1]

    lib = _StubLib()
    mod = pic if kernel == "icp" else pfc
    monkeypatch.setattr(pem, "launch_plan", spy)
    monkeypatch.setattr(pem, "sm_count", lambda device: 132)
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    monkeypatch.setattr(mod, "_stream", lambda t: 0)
    counts = _ragged_counts(batch)
    srcs = torch.zeros((batch, 1024, 3))
    tgts = torch.zeros((batch, 1024, 3))
    before = dict(mod.LAUNCHES)
    if kernel == "icp":
        pic._icp_cuda(srcs, tgts, counts, None, maxiter=30, tol=1e-6)
        (name, args), = lib.calls
        order_ptr, g = args[5], args[8]
    else:
        pt2pl = kernel == "frg_pt2pl"
        pfc._frg_cuda(srcs, tgts, tgts if pt2pl else None, counts,
                      pt2pl=pt2pl, w=0.0, maxiter=50, tol=1e-3,
                      update_sigma2=False, sigma2_decay=1.0,
                      min_sigma2=1e-4, auto_sigma2=True, sigma2_0=0.0)
        (name, args), = lib.calls
        order_ptr, g = args[6], args[8]
    (want_g, want_order), = plans
    assert g == want_g == (8 if batch == 1 else 1)
    assert order_ptr == (None if want_order is None
                         else want_order.data_ptr())
    assert (want_order is None) == (batch == 1)
    key = "icp" if kernel == "icp" else kernel
    assert mod.LAUNCHES[key] == before[key] + 1

"""GMMTree registration: EM against a hierarchical (octree-of-Gaussians) GMM.

Counterpart of probreg_tpu/gmmtree.py. The tree is three tensors, pi (T,),
mu (T, 3) and cov (T, 3, 3), in the reference's layout: node j's children
are (j + 1) 8 ... (j + 1) 8 + 7, and level l spans [8 (8^l - 1) / 7,
8 (8^(l+1) - 1) / 7).

* The build (``_build``): the leaf init from given leaf indices, the
  bottom-up parent init and one EM loop per level, top-down. The twin
  level loop runs in tensors; on a CUDA device each level is one launch of
  the level-EM kernel K9 for the whole batch (``ops/gmmtree_cuda.py``).
* The registration (``_run_registration``): the transposed descent loop of
  the reference, one host read of q per iteration; on a CUDA device the
  whole loop is one launch of the registration kernel K10, for a single
  pair or a whole batch. The pose is carried in the frame of the shared
  centroid of target and node means, and every result converts back.
* ``GMMTree``, ``registration_gmmtree`` and ``registration_gmmtree_batch``
  (fixed-size and ragged), and the callbacks host loop.

Moment sums are one-hot products, never ``index_add_`` / ``scatter_add_``,
whose float atomics on the card differ from run to run. The leaf indices
are drawn from a ``torch.Generator`` seeded with ``seed``, so a tree differs
from the reference's for the same seed (its ``jax.random`` bits differ);
the tests hand the reference's indices to the port. Multistart
(``n_starts > 1``), chunked callbacks (``callback_chunk > 1``) and the
GMMTree pyramid are not ported yet.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import config as _config
from .log import log
from .models import transformation as tf
from .ops import gmmtree_cuda
from .ops.em_cuda import _compact
from .ops.gmmtree_cuda import _go
from .ops.sym3 import eigh3
from .utils import interop
from .utils import se3_op as so

N_NODE = 8
_EPS = 1.0e-15
_EPS32 = float(np.finfo(np.float32).eps)
_LAMBDA_D = 1.0e-4
_BUILD_MAXITER = 50
_NOT_PORTED = ("{} is not ported to probreg_tpu_torch yet (ROADMAP.md, "
               "Queue 1 item 10); use probreg_tpu.gmmtree")

EstepResult = namedtuple("EstepResult", ["moments"])
MstepResult = namedtuple("MstepResult", ["transformation", "q"])
MstepResult.__doc__ = """Result of Maximization step.

    Attributes:
        transformation (tf.Transformation): Transformation from source to target.
        q (float): Result of likelihood.
"""


def _level_start(l: int) -> int:
    """First node index of level l (gmmtree.cc:44)."""
    return N_NODE * (N_NODE ** l - 1) // (N_NODE - 1)


def _n_total(max_level: int) -> int:
    return _level_start(max_level)


_log_pdf_terms = gmmtree_cuda.log_pdf_terms
_complexity = gmmtree_cuda.complexity


def _pdf(points, mu, inv, norm):
    """Gaussian pdf of points (P, 3) against nodes (P, K, ...)."""
    d = points[:, None, :] - mu
    ep = -0.5 * torch.einsum("pki,pkij,pkj->pk", d, inv, d)
    return norm * torch.exp(ep)


def _gamma_children(points, parent_idx, pi, mu, inv, norm):
    """Soft assignment of each point to the 8 children of its parent."""
    cidx = ((parent_idx + 1) * N_NODE)[:, None] + torch.arange(
        N_NODE, device=points.device)
    g = pi[cidx] * _pdf(points, mu[cidx], inv[cidx], norm[cidx])
    den = g.sum(1, keepdim=True)
    g = torch.where(den > _EPS, g / torch.clamp(den, min=_EPS),
                    torch.zeros_like(g))
    return g, cidx


def _accumulate(points, gamma, node_idx, n_total, chunk: int = 1 << 16):
    """Moments (m0, m1, m2) per node (gmmtree.cc:78-82) as one-hot products
    over chunks of points, added in chunk order."""
    zz = (points[:, :, None] * points[:, None, :]).reshape(-1, 9)
    feats = torch.cat([gamma[:, None], gamma[:, None] * points,
                       gamma[:, None] * zz], 1)
    nodes = torch.arange(n_total, device=points.device)
    out = points.new_zeros((n_total, feats.shape[1]))
    for s in range(0, feats.shape[0], chunk):
        onehot = (nodes[:, None] == node_idx[None, s:s + chunk]).to(
            points.dtype)
        out = out + onehot @ feats[s:s + chunk]
    return out[:, 0], out[:, 1:4], out[:, 4:].reshape(-1, 3, 3)


def _init_tree(points, idxs, n_eff, max_level):
    """initializeNodes (gmmtree.cc:46-75) for a batch: ``points`` (B, N, 3)
    centred with padding rows 0, ``idxs`` (B, 8^max_level) leaf indices,
    ``n_eff`` (B,) valid counts. The leaves are the indexed points with the
    covariance of the cloud about them, (1/n) sum (x - m)(x - m)^T, taken
    from the cloud's moments (the points are centred, so no digits are
    lost); each parent averages its children. Returns (pi, mu, cov)."""
    batch, _, dim = points.shape
    n_total = _n_total(max_level)
    pi = points.new_zeros((batch, n_total))
    mu = points.new_zeros((batch, n_total, dim))
    cov = points.new_zeros((batch, n_total, dim, dim))
    n_leaf = N_NODE ** max_level
    lf = _level_start(max_level - 1)
    leaf_mu = torch.gather(points, 1, idxs[:, :, None].expand(-1, -1, dim))
    # Sums in f64, so padding rows (zeros) cannot change their rounding: a
    # padded cloud gets its unpadded tree.
    p64 = points.double()
    s1 = p64.sum(1).to(points.dtype)
    s2 = torch.einsum("bni,bnj->bij", p64, p64).to(points.dtype)
    n = n_eff.to(points.dtype)[:, None, None, None]
    leaf_cov = ((s2[:, None] - leaf_mu[..., :, None] * s1[:, None, None, :]
                 - s1[:, None, :, None] * leaf_mu[..., None, :]) / n
                + leaf_mu[..., :, None] * leaf_mu[..., None, :])
    pi[:, lf:lf + n_leaf] = 1.0 / N_NODE
    mu[:, lf:lf + n_leaf] = leaf_mu
    cov[:, lf:lf + n_leaf] = leaf_cov
    for l in range(max_level - 2, -1, -1):
        pidx, cidx = _level_start(l), _level_start(l + 1)
        k = N_NODE ** (l + 1)
        cm = mu[:, cidx:cidx + k * N_NODE].reshape(batch, k, N_NODE, dim)
        cc = cov[:, cidx:cidx + k * N_NODE].reshape(batch, k, N_NODE, dim,
                                                    dim)
        pm = cm.mean(2)
        pc = (cc + cm[..., :, None] * cm[..., None, :]).mean(2) \
            - pm[..., :, None] * pm[..., None, :]
        pi[:, pidx:pidx + k] = 1.0 / N_NODE
        mu[:, pidx:pidx + k] = pm
        cov[:, pidx:pidx + k] = pc
    return pi, mu, cov


def _pack_level(pi, mu, cov):
    """(B, K, 10) level state [pi, mu, c00, c01, c02, c11, c12, c22]."""
    c6 = cov.reshape(*cov.shape[:-2], 9)[..., [0, 1, 2, 4, 5, 8]]
    return torch.cat([pi[..., None], mu, c6], -1)


def _unpack_level(state):
    c = state[..., 4:10]
    cov = torch.stack([c[..., [0, 1, 2]], c[..., [1, 3, 4]],
                       c[..., [2, 4, 5]]], -2)
    return state[..., 0], state[..., 1:4], cov


def _build_fused(points, idxs, counts, *, max_level, lambda_s, lambda_d):
    """The build of a batch of pairs on the level-EM kernel, one launch per
    level for the whole batch: ``points`` (B, N, 3) with each pair's
    ``counts`` (B,) valid points first. Returns (pi, mu, cov) stacked, in
    each cloud's raw frame."""
    n_cap = points.shape[1]
    counts = counts.to(torch.int64)
    valid = (torch.arange(n_cap, device=points.device)[None, :]
             < counts[:, None]).to(points.dtype)
    n_eff = counts.to(points.dtype)
    cen = ((points * valid[..., None]).double().sum(1).to(points.dtype)
           / torch.clamp(n_eff, min=1.0)[:, None])
    pts = ((points - cen[:, None, :]) * valid[..., None]).contiguous()
    pi, mu, cov = _init_tree(pts, idxs, counts, max_level)
    parent = torch.zeros(points.shape[:2], dtype=torch.int64,
                         device=points.device)
    for l in range(max_level):
        lb, le = _level_start(l), _level_start(l + 1)
        state, parent, _ = gmmtree_cuda.level_em(
            pts, counts, _pack_level(pi[:, lb:le], mu[:, lb:le],
                                     cov[:, lb:le]),
            parent, lambda_s=lambda_s, lambda_d=lambda_d,
            maxiter=_BUILD_MAXITER)
        pi[:, lb:le], mu[:, lb:le], cov[:, lb:le] = _unpack_level(state)
    return pi, mu + cen[:, None, :], cov


def _build(points, idxs, *, max_level, lambda_s, lambda_d, smask=None,
           fused=False):
    """buildGmmTree (gmmtree.cc:98-123): per-level EM to convergence.

    ``points`` (N, 3); ``idxs`` (8^max_level,) the leaf indices, in
    [0, n_eff) when masked. ``smask``: optional (N,) validity mask of a
    padded cloud whose padding sits at the tail; every responsibility of a
    padded point is zeroed and the normalizers use the true count, which
    is the unpadded build. ``fused`` runs each level on K9 (its plain
    version for CPU tensors); otherwise the twin level loop runs here.
    Returns (pi (T,), mu (T, 3), cov (T, 3, 3)) in the raw frame.
    """
    if fused:
        if smask is None:
            counts = torch.tensor([points.shape[0]], device=points.device)
            pts = points[None]
        else:
            pts, counts = _compact(points[None], smask[None])
        pi, mu, cov = _build_fused(pts, idxs[None], counts,
                                   max_level=max_level, lambda_s=lambda_s,
                                   lambda_d=lambda_d)
        return pi[0], mu[0], cov[0]
    n, dim = points.shape
    n_total = _n_total(max_level)
    masked = smask is not None
    n_eff = smask.sum() if masked else torch.tensor(
        float(n), dtype=points.dtype, device=points.device)
    # Centring: every covariance here is of the cancellation-prone
    # m2 / m0 - mu mu^T form; node means shift back at the end.
    if masked:
        cen = (smask @ points) / torch.clamp(n_eff, min=1.0)
    else:
        cen = points.mean(0)
    points = points - cen[None, :]
    pz = points * smask[:, None] if masked else points
    pi, mu, cov = (a[0] for a in _init_tree(pz[None], idxs[None],
                                            n_eff[None], max_level))

    parent_idx = torch.full((n,), -1, dtype=torch.int64,
                            device=points.device)
    pts_rep = points.repeat_interleave(N_NODE, 0)
    for l in range(max_level):
        lb, le = _level_start(l), _level_start(l + 1)
        sl = slice(lb, le)

        def level_ll(pi, mu, cov):
            inv, norm, _ = _log_pdf_terms(cov[sl])
            k = le - lb
            p = pi[None, sl] * _pdf(points, mu[sl].expand(n, k, dim),
                                    inv.expand(n, k, dim, dim),
                                    norm.expand(n, k))
            ll = torch.log(torch.clamp(p.sum(1), min=_EPS))
            return (ll * smask).sum() if masked else ll.sum()

        q, q_prev, it = np.float32(0.0), np.float32(np.inf), 0
        cur = parent_idx
        while _go(it, _BUILD_MAXITER, q, q_prev, lambda_s):
            inv, norm, _ = _log_pdf_terms(cov)
            gamma, cidx = _gamma_children(points, parent_idx, pi, mu, inv,
                                          norm)
            if masked:
                gamma = gamma * smask[:, None]
            m0, m1, m2 = _accumulate(pts_rep, gamma.reshape(-1),
                                     cidx.reshape(-1), n_total)
            # mlEstimator (gmmtree.cc:84-97) on this level only.
            keep = m0[sl] >= lambda_d
            m0s = torch.clamp(m0[sl], min=_EPS)
            new_mu = torch.where(keep[:, None], m1[sl] / m0s[:, None],
                                 torch.zeros_like(m1[sl]))
            pi, mu, cov = pi.clone(), mu.clone(), cov.clone()
            pi[sl] = torch.where(keep, m0[sl] / n_eff, torch.zeros_like(m0[sl]))
            mu[sl] = new_mu
            cov[sl] = torch.where(
                keep[:, None, None],
                m2[sl] / m0s[:, None, None]
                - new_mu[:, :, None] * new_mu[:, None, :],
                torch.eye(dim, dtype=points.dtype, device=points.device))
            cur = cidx.gather(1, gamma.argmax(1, keepdim=True))[:, 0]
            q_prev, q = q, np.float32(float(level_ll(pi, mu, cov)))
            it += 1
        parent_idx = cur
    return pi, mu + cen[None, :], cov


def _build_batch(points, idxs, counts, *, max_level, lambda_s, lambda_d,
                 fused):
    """Trees of a batch: ``points`` (B, N, 3) with each pair's ``counts``
    valid points first. Fused, one K9 launch per level for the batch;
    otherwise the twin build pair by pair on its valid points."""
    if fused:
        return _build_fused(points, idxs, counts, max_level=max_level,
                            lambda_s=lambda_s, lambda_d=lambda_d)
    trees = [_build(points[b, :n], idxs[b], max_level=max_level,
                    lambda_s=lambda_s, lambda_d=lambda_d)
             for b, n in enumerate(counts.tolist())]
    return tuple(torch.stack(a) for a in zip(*trees))


def _leaf_indices(seed: int, counts, n_leaf: int, device) -> torch.Tensor:
    """(B, n_leaf) leaf indices, pair b's uniform in [0, counts[b]), from
    one ``torch.Generator`` seeded with ``seed`` (pair by pair in order)."""
    gen = torch.Generator().manual_seed(int(seed))
    rows = [torch.randint(0, max(int(c), 1), (n_leaf,), generator=gen)
            for c in counts]
    return torch.stack(rows).to(device)


def _reg_estep(points, pi, mu, cov, *, max_level, lambda_c):
    """gmmTreeRegEstep (gmmtree.cc:175-215): the descent of every point;
    the moments (m0, m1, m2) of the node it ends at."""
    n = points.shape[0]
    inv, norm, _ = _log_pdf_terms(cov)
    cplx = _complexity(cov)
    search = torch.full((n,), -1, dtype=torch.int64, device=points.device)
    gmax = points.new_zeros(n)
    stopped = torch.zeros(n, dtype=torch.bool, device=points.device)
    for _ in range(max_level):
        gamma, cidx = _gamma_children(points, search, pi, mu, inv, norm)
        arg = gamma.argmax(1, keepdim=True)
        search = torch.where(stopped, search, cidx.gather(1, arg)[:, 0])
        gmax = torch.where(stopped, gmax, gamma.gather(1, arg)[:, 0])
        stopped = stopped | (cplx[search] <= lambda_c)
    return _accumulate(points, gmax, search, _n_total(max_level))


def _mstep_core(m0, m1, node_mu, lmd, nn, rot_p, t_p):
    """Reference gmmtree.py:64-81 with the node eigendecompositions hoisted
    out of the loop; the stacked twist least squares by its 6 x 6 normal
    equations with the 1e-8 ridge, in f32 as the reference solves them."""
    dim = node_mu.shape[1]
    keep = m0 >= _EPS32
    m0s = torch.clamp(m0, min=_EPS32)
    s = m1 / m0s[:, None]
    scale = torch.sqrt(m0s[:, None] / torch.clamp(lmd, min=_EPS32))
    nn_t = (nn * scale[:, None, :]).transpose(1, 2)     # rows = vectors
    b = torch.einsum("tij,tj->ti", nn_t, node_mu - s)
    a_rot = torch.linalg.cross(s[:, None, :].expand_as(nn_t), nn_t, dim=-1)
    amat = torch.cat([a_rot, nn_t], 2)
    amat = torch.where(keep[:, None, None], amat, torch.zeros_like(amat))
    b = torch.where(keep[:, None], b, torch.zeros_like(b))
    amat = amat.reshape(-1, 2 * dim)
    b = b.reshape(-1)
    ata = amat.T @ amat
    x = torch.linalg.solve(
        ata + 1e-8 * torch.eye(2 * dim, dtype=ata.dtype, device=ata.device),
        amat.T @ b)
    q = ((amat @ x - b) ** 2).sum()
    rot, t = so.twist_mul(x, rot_p, t_p)
    return rot, t, q


def _mstep(m0, m1, node_mu, node_cov, rot_p, t_p):
    lmd, nn = eigh3(node_cov)
    return _mstep_core(m0, m1, node_mu, lmd, nn, rot_p, t_p)


def _estep_t_factory(pi, mu, cov, max_level, lambda_c):
    """The transposed-descent E-step: estep(x_t (3, N), col_mask (1, N)) ->
    (m0 (T,), m1 (T, 3)), the Mahalanobis terms of all T nodes in the
    reference's expanded form (three products) with the exponent clamped
    at 0, each level's argmax over all T nodes as the reference's twin
    takes it, and the moments by a one-hot product."""
    n_total = _n_total(max_level)
    dim = mu.shape[1]
    inv, norm, _ = _log_pdf_terms(cov)
    cplx = _complexity(cov)
    si_stack = inv.reshape(n_total * dim, dim)
    msi = torch.einsum("tij,tj->ti", inv, mu)
    mcm = (msi * mu).sum(1)
    parent_of = torch.arange(n_total, device=mu.device) // N_NODE - 1
    rows = torch.arange(n_total, device=mu.device)[:, None]

    def estep_t(x_t, col_mask):
        n = x_t.shape[1]
        b_all = si_stack @ x_t                                  # (3T, N)
        qf = (b_all * x_t.repeat(n_total, 1)).reshape(
            n_total, dim, n).sum(1)                             # (T, N)
        lin = msi @ x_t
        ep = -0.5 * (qf - 2.0 * lin + mcm[:, None])
        wpdf = pi[:, None] * (norm[:, None]
                              * torch.exp(torch.clamp(ep, max=0.0)))
        parent = torch.full((1, n), -1, dtype=torch.int64,
                            device=x_t.device)
        gmax = x_t.new_zeros((1, n))
        stopped = torch.zeros((1, n), dtype=torch.bool, device=x_t.device)
        search = torch.zeros((1, n), dtype=torch.int64, device=x_t.device)
        for _ in range(max_level):
            g = wpdf * (parent_of[:, None] == parent).to(x_t.dtype)
            den = g.sum(0, keepdim=True)
            g = torch.where(den > _EPS, g / torch.clamp(den, min=_EPS),
                            torch.zeros_like(g))
            new_g = g.amax(0, keepdim=True)
            new_search = g.argmax(0, keepdim=True)   # the first maximum
            search = torch.where(stopped, search, new_search)
            gmax = torch.where(stopped, gmax, new_g)
            stopped = stopped | (cplx[search] <= lambda_c)
            parent = torch.where(stopped, parent, search)
        w = (rows == search).to(x_t.dtype) * gmax * col_mask     # (T, N)
        return w.sum(1), w @ x_t.T

    return estep_t


def _tree_centroid(target, mu, tmask=None):
    """The shared centring shift of the descent: the mean of the (valid)
    targets and the node means."""
    if tmask is not None:
        tsum, tcnt = tmask @ target, tmask.sum()
    else:
        tsum, tcnt = target.sum(0), target.shape[0]
    return (tsum + mu.sum(0)) / (tcnt + mu.shape[0])


def _run_registration(target, pi, mu, cov, rot0, t0, *, max_level, lambda_c,
                      maxiter, tol, tmask=None):
    """The whole registration loop in the transposed (D, N) layout, one host
    read of q per iteration: (rot, t, q) in the raw frame."""
    n = target.shape[0]
    lmd_nodes, nn_nodes = eigh3(cov)
    # An f32 build can leave slightly indefinite nodes; the floor keeps one
    # from dominating the 6 x 6 system (reference gmmtree.py:384-389).
    lmd_nodes = torch.clamp(lmd_nodes, min=1e-7)
    cen = _tree_centroid(target, mu, tmask)
    mu = mu - cen[None, :]
    xs_t0 = target.T - cen[:, None]
    rot, t = rot0, t0 + rot0 @ cen - cen
    estep_core = _estep_t_factory(pi, mu, cov, max_level, lambda_c)
    col_mask = tmask[None, :] if tmask is not None else target.new_ones(
        (1, n))
    q = torch.tensor(float("inf"), dtype=target.dtype, device=target.device)
    q_f, q_prev, it = np.float32(np.inf), np.float32(np.inf), 0
    while _go(it, maxiter, q_f, q_prev, tol):
        m0, m1 = estep_core(rot @ xs_t0 + t[:, None], col_mask)
        rot, t, q = _mstep_core(m0, m1, mu, lmd_nodes, nn_nodes, rot, t)
        q_prev, q_f = q_f, np.float32(float(q))
        it += 1
    return rot, t + cen - rot @ cen, q


def _fused_build_ok(points: torch.Tensor, tree_level: int) -> bool:
    """The level-EM kernel's branch (reference gmmtree.py:563-569, a CUDA
    device in place of the TPU backend)."""
    return (points.is_cuda and _config.config.use_fused_em
            and points.shape[-1] == 3 and points.dtype == torch.float32
            and gmmtree_cuda.fused_build_ok(tree_level))


def _fused_reg_ok(target: torch.Tensor, tree_level: int) -> bool:
    """The registration kernel's branch (reference gmmtree.py:618-622)."""
    return (target.is_cuda and _config.config.use_fused_em
            and target.shape[-1] == 3 and target.dtype == torch.float32
            and gmmtree_cuda.fused_reg_ok(tree_level))


class GMMTree:
    """GMM Tree registration (reference gmmtree.py:24-96).

    Args:
        source: Source point cloud data.
        tree_level: Maximum depth of the GMM tree.
        lambda_c: Complexity threshold pruning the registration descent.
        lambda_s: Log-likelihood tolerance for building the tree.
        tf_init_params: Initializer kwargs for the rigid transformation.
        seed: Seed of the leaf initialization's ``torch.Generator``.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.
    """

    def __init__(self, source=None, tree_level: int = 2,
                 lambda_c: float = 0.01, lambda_s: float = 0.001,
                 tf_init_params: Optional[Dict] = None, seed: int = 0,
                 device=None):
        self._device = _config.resolve_device(device)
        self._tree_level = int(tree_level)
        self._lambda_c = float(lambda_c)
        self._lambda_s = float(lambda_s)
        self._tf_result = tf.RigidTransformation(**(tf_init_params or {}),
                                                 device=self._device)
        self._callbacks: List[Callable] = []
        self._seed = seed
        self._source = None
        if source is not None:
            self.set_source(source)

    def set_source(self, source):
        self._source = interop.as_points(source, device=self._device)
        # Build from the cloud centred in f64: far from the origin, f32
        # coordinates would quantize the cloud enough to flip the build EM
        # into a degenerate tree (reference gmmtree.py:548-556). Node means
        # shift back, so the tree stays in the caller's frame.
        src64 = interop.as_points(source, dtype=torch.float64,
                                  device=self._device)
        center = src64.mean(0)
        pts = (src64 - center).to(_config.config.dtype)
        idxs = _leaf_indices(self._seed, [pts.shape[0]],
                             N_NODE ** self._tree_level, self._device)[0]
        pi, mu, cov = _build(pts, idxs, max_level=self._tree_level,
                             lambda_s=self._lambda_s, lambda_d=_LAMBDA_D,
                             fused=_fused_build_ok(pts, self._tree_level))
        self._nodes = (pi, mu + center.to(mu.dtype)[None, :], cov)

    def set_callbacks(self, callbacks):
        self._callbacks = callbacks

    def expectation_step(self, target) -> EstepResult:
        pi, mu, cov = self._nodes
        return EstepResult(_reg_estep(
            interop.as_points(target, device=self._device), pi, mu, cov,
            max_level=self._tree_level, lambda_c=self._lambda_c))

    def maximization_step(self, estep_res: EstepResult,
                          trans_p) -> MstepResult:
        m0, m1, _ = estep_res.moments
        _, mu, cov = self._nodes
        rot, t, q = _mstep(m0, m1, mu, cov, trans_p.rot, trans_p.t)
        return MstepResult(tf.RigidTransformation(rot, t), q)

    def registration(self, target, maxiter: int = 20, tol: float = 1.0e-4,
                     n_starts: int = 1,
                     callback_chunk: int = 1) -> MstepResult:
        if int(n_starts) > 1:
            raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
        if int(callback_chunk) > 1:
            raise NotImplementedError(_NOT_PORTED.format(
                "callback_chunk > 1"))
        target = interop.as_points(target, device=self._device)
        pi, mu, cov = self._nodes
        if not self._callbacks:
            kw = dict(max_level=self._tree_level, lambda_c=self._lambda_c,
                      maxiter=int(maxiter), tol=float(tol))
            if _fused_reg_ok(target, self._tree_level):
                rot, t, q, _ = gmmtree_cuda.run_gmmtree_reg_fused(
                    target, pi, mu, cov, self._tf_result.rot,
                    self._tf_result.t, **kw)
            else:
                rot, t, q = _run_registration(
                    target, pi, mu, cov, self._tf_result.rot,
                    self._tf_result.t, **kw)
            self._tf_result = tf.RigidTransformation(rot, t)
            return MstepResult(self._tf_result.inverse(), q)
        return self._callback_loop(target, int(maxiter), float(tol))

    def _callback_loop(self, target, maxiter, tol) -> MstepResult:
        """The reference's host loop over expectation_step /
        maximization_step (gmmtree.py:668-705), in the same shared-centroid
        frame as _run_registration: nodes and target centred in, every
        emitted transformation converted back."""
        pi, mu, cov = self._nodes
        cen = _tree_centroid(target, mu).double()
        target_c = target - cen.to(target.dtype)[None, :]
        rot0 = self._tf_result.rot.double()
        tf_c = tf.RigidTransformation(
            rot0, self._tf_result.t.double() + rot0 @ cen - cen)

        def to_raw(tr):
            r = tr.rot.double()
            return tf.RigidTransformation(r, tr.t.double() + cen - r @ cen)

        saved_nodes = self._nodes
        q = None
        res = MstepResult(tf_c, None)
        try:
            self._nodes = (pi, mu - cen.to(mu.dtype)[None, :], cov)
            for i in range(maxiter):
                estep_res = self.expectation_step(
                    res.transformation._transform(target_c))
                res = self.maximization_step(estep_res, res.transformation)
                self._tf_result = to_raw(res.transformation)
                for c in self._callbacks:
                    c(self._tf_result.inverse())
                log.debug("Iteration: {}, Criteria: {}".format(i, res.q))
                if q is not None and abs(float(res.q) - q) < tol:
                    break
                q = float(res.q)
        finally:
            self._nodes = saved_nodes
        return MstepResult(self._tf_result.inverse(), res.q)


def registration_gmmtree(
    source,
    target,
    maxiter: int = 20,
    tol: float = 1.0e-4,
    callbacks: Optional[List[Callable]] = None,
    n_starts: int = 1,
    device=None,
    **kwargs: Any,
) -> MstepResult:
    """GMMTree registration (reference gmmtree.py:99-129).

    The EM moves the *target* onto the source's tree; the returned
    transformation is the inverse, i.e. maps source to target (reference
    gmmtree.py:86-96).

    Args:
        source: Source point cloud ((N, 3) ndarray, tensor or Open3D cloud).
        target: Target point cloud.
        maxiter: Maximum EM iterations.
        tol: Convergence tolerance on the residual q.
        callbacks: Called with the current (inverse) transformation each
            iteration.
        n_starts: Multistart is not ported yet: > 1 raises.
        device: Device to run on (default ``config.device``, "cuda"). A
            missing CUDA device raises instead of running on the CPU.

    Keyword Args:
        tree_level (int): Maximum depth of the GMM tree.
        lambda_c (float): Complexity threshold for the descent pruning.
        lambda_s (float): Build log-likelihood tolerance.
        tf_init_params (dict): Initializer for the rigid transformation.
        seed (int): Seed of the leaf initialization.
        callback_chunk (int): Only 1 is ported: > 1 raises.

    Returns:
        MstepResult: (transformation, q).
    """
    callback_chunk = int(kwargs.pop("callback_chunk", 1))
    if int(n_starts) > 1:
        raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
    if callback_chunk > 1:
        raise NotImplementedError(_NOT_PORTED.format("callback_chunk > 1"))
    gt = GMMTree(source, device=device, **kwargs)
    gt.set_callbacks(list(callbacks or []))
    return gt.registration(target, maxiter, tol)


def registration_gmmtree_batch(
    sources,
    targets,
    maxiter: int = 20,
    tol: float = 1.0e-4,
    tree_level: int = 2,
    lambda_c: float = 0.01,
    lambda_s: float = 0.001,
    seed: int = 0,
    n_starts: int = 1,
    device=None,
) -> List[MstepResult]:
    """Register B cloud pairs with GMMTree (reference gmmtree.py:879).

    ``sources`` (B, M, 3) and ``targets`` (B, N, 3), or lists of clouds with
    different point counts (zero-padded and registered with masks, which is
    the same as registering each pair without its padding). Pair b's leaves
    are drawn after pairs 0 .. b-1 from one generator seeded with ``seed``.
    On a CUDA device the trees are built with one launch of the level-EM
    kernel per level for the whole batch, and all pairs register in one
    launch of the registration kernel; otherwise the twin loops run pair by
    pair. Same target-transform / inverse-return convention as
    :func:`registration_gmmtree`. Returns a list of ``MstepResult``.
    """
    if int(n_starts) > 1:
        raise NotImplementedError(_NOT_PORTED.format("n_starts > 1"))
    dev = _config.resolve_device(device)
    ragged = isinstance(sources, (list, tuple)) \
        or isinstance(targets, (list, tuple))
    if ragged:
        src, smask = interop.pad_ragged(list(sources), device=dev)
        tgt, tmask = interop.pad_ragged(list(targets), device=dev)
        src, s_cnt = _compact(src, smask)
    else:
        src = interop.as_points(sources, device=dev)
        tgt = interop.as_points(targets, device=dev)
        tmask = None
        s_cnt = torch.full((src.shape[0],), src.shape[1], dtype=torch.int64,
                           device=dev)
    tree_level = int(tree_level)
    idxs = _leaf_indices(seed, s_cnt.tolist(), N_NODE ** tree_level, dev)
    pi, mu, cov = _build_batch(src, idxs, s_cnt, max_level=tree_level,
                               lambda_s=float(lambda_s),
                               lambda_d=_LAMBDA_D,
                               fused=_fused_build_ok(src, tree_level))
    kw = dict(max_level=tree_level, lambda_c=float(lambda_c),
              maxiter=int(maxiter), tol=float(tol))
    if _fused_reg_ok(tgt, tree_level):
        rot, t, q, _ = gmmtree_cuda.run_gmmtree_reg_fused_batch(
            tgt, pi, mu, cov, tmasks=tmask, **kw)
    else:
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        runs = [_run_registration(
            tgt[b], pi[b], mu[b], cov[b], eye, zero,
            tmask=None if tmask is None else tmask[b], **kw)
            for b in range(tgt.shape[0])]
        rot, t, q = (torch.stack(a) for a in zip(*runs))
    return [MstepResult(tf.RigidTransformation(rot[b], t[b]).inverse(), q[b])
            for b in range(tgt.shape[0])]

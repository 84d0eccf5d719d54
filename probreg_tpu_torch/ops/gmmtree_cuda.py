"""GMMTree's two kernels, the level-EM of the tree build and the whole
registration, beside their plain versions.

Counterpart of probreg_tpu/ops/gmmtree_pallas.py:

* ``level_em`` (K9, ``_level_em_kernel``) runs one tree level's whole build
  EM, the stop test included, in one launch of ``csrc/gmmtree.cu``
  ``level_em_kernel`` for the whole batch, so a batch's build is one launch
  per level (the reference launches once per pair and level). A pair's
  points are cut into chunks of ``CHUNK``; ``blocks_per_pair`` picks how
  many thread blocks share a pair (1 when the batch fills the card, else up
  to one per chunk, in one cooperative launch). The sums run over the
  chunks in a fixed order, so the result is the same bits for any number
  of blocks and any batch.
* ``run_gmmtree_reg_fused_batch`` / ``run_gmmtree_reg_fused`` (K10,
  ``_reg_kernel``) run every iteration of the registration (the descent,
  the per-node moments, the twist normal equations, the solve, the compose
  and the stop test) in one launch of ``gmmtree_reg_kernel``, one launch
  per batch. A pair's targets are cut into chunks of ``CHUNK`` in their
  stored order and ``blocks_per_pair`` picks the blocks per pair as for
  K9 (against K10's own capacity, ``reg_capacity``); the moments are
  summed over the chunks in a fixed order, so the result is the same bits
  for any number of blocks and any batch.

K9 follows the twin level loop of ``gmmtree._build``: u = pi * norm *
exp(-d^T inv d / 2) from differences d = x - mu, the closed-form adjugate
inverse (a node is dead when det < 1e-15 or pi = 0), gamma = u / den where
den > 1e-15, the hard child as the first maximum among the point's own 8
children, the m0 >= lambda_d death rule, and the stop test on the level's
log-likelihood over ALL its nodes with the updated parameters. The
wrapper sorts each pair's points by parent, so the kernel sums each
parent's children's moments over one contiguous segment.

K10 follows the twin ``gmmtree._run_registration``: it clamps the exponent
at 0 as the twin does (the reference kernel does not), takes d from
differences (the twin takes the expanded form), restricts each descent
step to the parent's 8 children, and solves the 6 x 6 system with the
1e-8 ridge in double. The per-tree set-up is done here in tensors, as the
reference's wrapper does: ``eigh3`` of the node covariances with the 1e-7
eigenvalue floor, the shared centroid of targets and node means, the
inverse, pi and norm of each node (a dead node has norm 0, so its u is
exactly 0), each node's complexity, and the starting pose in the centred
frame.

Masks become counts: the wrappers move each pair's valid points to the
front, so a padded pair is bit for bit the registration of the pair
without its padding.

CUDA tensors run the kernels; CPU tensors run ``level_em_plain`` and
``run_gmmtree_reg_fused_plain``, the same arithmetic in tensors with the
stop tests on the host. Nothing else picks between them. Every launch adds
one to ``LAUNCHES["gmmtree_level_em"]`` or ``LAUNCHES["gmmtree_reg"]``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .em_cuda import _compact
from .estep_cuda import _check, _stream
from .sym3 import eigh3, eigvalsh3

N_NODE = 8
_EPS = 1.0e-15
_EPS32 = float(np.finfo(np.float32).eps)
_TWO_PI_15 = (2.0 * math.pi) ** 1.5
# Shared memory a block may use on the card (227 KB) less what each kernel
# holds statically (block sums and reduction buffers, under 32 KB).
_SMEM_BYTES = 227 * 1024 - 32 * 1024
# Floats per node: K9 keeps [pi, mu (3), cov (6)], the E-step terms
# [mu (3), inv (6), pi, norm, 0] and the 10 moment totals (and two ints
# per parent, under 1 %); K10's table is TABLE_WIDTH wide.
_K9_NODE_FLOATS = 10 + 12 + 10
# K9's and K10's points per chunk (csrc/gmmtree.cu kChunk); K9's moments
# per chunk.
CHUNK = 1024
_PART_WIDTH = 8 * 10
# Fewest chunks in a pair for which the pair is shared by several blocks.
_MIN_SPLIT_CHUNKS = 4
TABLE_WIDTH = 24
# K10's shared memory per node: the table, one [m0, m1] buffer per warp
# (32), the node totals and three twist rows of 7.
_K10_NODE_FLOATS = TABLE_WIDTH + 32 * 4 + 4 + 3 * 7

LAUNCHES = {"gmmtree_level_em": 0, "gmmtree_reg": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _n_total(max_level: int) -> int:
    return N_NODE * (N_NODE ** max_level - 1) // (N_NODE - 1)


def fused_build_ok(max_level: int) -> bool:
    """True iff K9 can build a tree of ``max_level`` levels: the deepest
    level's 8^max_level nodes (parameters, E-step terms and moment totals,
    128 B each) stay in one block's shared memory, so max_level <= 3.
    Points stay in device memory, so the cloud's size does not enter."""
    return 1 <= max_level and (4 * _K9_NODE_FLOATS * N_NODE ** max_level
                               <= _SMEM_BYTES)


def fused_reg_ok(max_level: int) -> bool:
    """True iff K10 can register against a tree of ``max_level`` levels: the
    node table and one moment buffer per warp, 708 B per node, stay in one
    block's shared memory, so max_level <= 2 (72 nodes). Points stay in
    device memory, so the cloud's size does not enter."""
    return 1 <= max_level and (4 * _K10_NODE_FLOATS * _n_total(max_level)
                               <= _SMEM_BYTES)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("gmmtree")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_gmmtree_level_em.argtypes = [
            _P, _I, _P, _I, _P, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P, _P,
            _P, _P, _P]
        lib.probreg_gmmtree_level_em.restype = ctypes.c_int
        lib.probreg_gmmtree_level_capacity.argtypes = [_I, _P]
        lib.probreg_gmmtree_level_capacity.restype = ctypes.c_int
        lib.probreg_gmmtree_reg_capacity.argtypes = [_I, _P]
        lib.probreg_gmmtree_reg_capacity.restype = ctypes.c_int
        lib.probreg_gmmtree_reg.argtypes = [_P, _I, _P, _P, _I, _P, _I, _I,
                                            _I, _I, _I, _F, _F, _P, _P, _P,
                                            _P]
        lib.probreg_gmmtree_reg.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def _counts(points: torch.Tensor, counts) -> torch.Tensor:
    """(B,) int64 valid points per pair (all when ``counts`` is None)."""
    if counts is None:
        return torch.full((points.shape[0],), points.shape[1],
                          dtype=torch.int64, device=points.device)
    return torch.as_tensor(counts, device=points.device).to(torch.int64)


def _check_points(points: torch.Tensor, what: str) -> torch.Tensor:
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"expected (B, N, 3) {what}, got "
                         f"{tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise ValueError(f"the GMMTree kernels take float32 {what}")
    return points.contiguous()


# --------------------------------------------------------------------------
# K9: one level of the tree build
# --------------------------------------------------------------------------

def node_terms(state: torch.Tensor):
    """E-step terms of nodes ``state`` (..., 10) [pi, mu (3), cov (6):
    c00, c01, c02, c11, c12, c22]: (mu, inv (6, same order), pi, norm) by
    the closed-form adjugate; a node with det < 1e-15 gets inv = I and
    norm = 0."""
    pi, mu = state[..., 0], state[..., 1:4]
    c00, c01, c02, c11, c12, c22 = state[..., 4:10].unbind(-1)
    adj00 = c11 * c22 - c12 * c12
    adj01 = -(c01 * c22 - c02 * c12)
    adj02 = c01 * c12 - c02 * c11
    adj11 = c00 * c22 - c02 * c02
    adj12 = -(c00 * c12 - c01 * c02)
    adj22 = c00 * c11 - c01 * c01
    det = c00 * adj00 + c01 * adj01 + c02 * adj02
    valid = det >= _EPS
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    inv = torch.stack([adj00, adj01, adj02, adj11, adj12, adj22], -1) \
        * inv_det[..., None]
    eye6 = inv.new_tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0])
    inv = torch.where(valid[..., None], inv, eye6)
    norm = torch.where(
        valid, 1.0 / (torch.sqrt(torch.clamp(det, min=_EPS)) * _TWO_PI_15),
        torch.zeros_like(det))
    return mu, inv, pi, norm


def mahalanobis_exponent(d: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """-d^T inv d / 2 for differences d (..., 3) and packed inverses
    inv (..., 6), in the kernels' operation order."""
    d0, d1, d2 = d.unbind(-1)
    i00, i01, i02, i11, i12, i22 = inv.unbind(-1)
    return -0.5 * (d0 * (i00 * d0 + i01 * d1 + i02 * d2)
                   + d1 * (i01 * d0 + i11 * d1 + i12 * d2)
                   + d2 * (i02 * d0 + i12 * d1 + i22 * d2))


def _features(x: torch.Tensor) -> torch.Tensor:
    """(n, 10) moment features [1, x, x0x0, x0x1, x0x2, x1x1, x1x2, x2x2]."""
    x0, x1, x2 = x.unbind(-1)
    return torch.stack([torch.ones_like(x0), x0, x1, x2, x0 * x0, x0 * x1,
                        x0 * x2, x1 * x1, x1 * x2, x2 * x2], -1)


def _mstep_level(mom: torch.Tensor, n_eff: float, lambda_d: float):
    """New (K, 10) state from the (K, 10) moments (the m0 >= lambda_d rule;
    a dead node gets pi 0, mu 0, cov I)."""
    m0 = mom[:, 0]
    keep = m0 >= lambda_d
    m0s = torch.clamp(m0, min=_EPS)
    pi = torch.where(keep, m0 / n_eff, torch.zeros_like(m0))
    mu = torch.where(keep[:, None], mom[:, 1:4] / m0s[:, None],
                     torch.zeros_like(mom[:, 1:4]))
    a, b, c = mu.unbind(-1)
    mumu = torch.stack([a * a, a * b, a * c, b * b, b * c, c * c], -1)
    eye6 = mom.new_tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0])
    cov = torch.where(keep[:, None], mom[:, 4:10] / m0s[:, None] - mumu,
                      eye6)
    return torch.cat([pi[:, None], mu, cov], 1)


def _go(it: int, maxiter: int, q, q_prev, tol) -> bool:
    """The kernels' stop test, in f32: go on while it < maxiter and (it == 0
    or |q - q_prev| >= tol); a NaN stops."""
    if it >= maxiter:
        return False
    if it == 0:
        return True
    with np.errstate(invalid="ignore", over="ignore"):
        return bool(np.abs(np.float32(q) - np.float32(q_prev))
                    >= np.float32(tol))


def _level_ll(x: torch.Tensor, state: torch.Tensor, chunk: int = 8192):
    """sum over points of log(max(sum_k u_k(x), 1e-15)) over all K nodes."""
    mu, inv, pi, norm = node_terms(state)
    total = x.new_zeros(())
    for s in range(0, x.shape[0], chunk):
        d = x[s:s + chunk, None, :] - mu
        u = pi * (norm * torch.exp(mahalanobis_exponent(d, inv)))
        total = total + torch.log(torch.clamp(u.sum(1), min=_EPS)).sum()
    return total


def _level_plain_pair(x, parent, state, *, lambda_s, lambda_d, maxiter):
    """One pair's level EM on its ``n`` valid points: (state (K, 10),
    child (n,) int64, q, n_iter)."""
    n, k = x.shape[0], state.shape[0]
    n_parents = k // N_NODE
    cidx = parent[:, None] * N_NODE + torch.arange(N_NODE,
                                                   device=x.device)
    # Parents one-hot: the moments of parent p's 8 children are one
    # (n_parents, n) x (n, 80) product, no scatter.
    onehot = (parent[None, :] == torch.arange(
        n_parents, device=x.device)[:, None]).to(x.dtype)
    feat = _features(x)
    n_eff = float(np.float32(n))
    child = torch.zeros(n, dtype=torch.int64, device=x.device)
    q, q_prev, it = np.float32(0.0), np.float32(np.inf), 0
    while _go(it, maxiter, q, q_prev, lambda_s):
        mu, inv, pi, norm = node_terms(state)
        d = x[:, None, :] - mu[cidx]
        u = pi[cidx] * (norm[cidx]
                        * torch.exp(mahalanobis_exponent(d, inv[cidx])))
        den = u.sum(1, keepdim=True)
        g = torch.where(den > _EPS, u / torch.clamp(den, min=_EPS),
                        torch.zeros_like(u))
        child = cidx.gather(1, g.argmax(1, keepdim=True))[:, 0]
        mom = onehot @ (g[:, :, None] * feat[:, None, :]).reshape(n, -1)
        state = _mstep_level(mom.reshape(k, 10), n_eff, lambda_d)
        q_prev, q = q, np.float32(float(_level_ll(x, state)))
        it += 1
    return state, child, q, it


def level_em_plain(points, counts, state, parent, *, lambda_s, lambda_d,
                   maxiter=50):
    """Plain version of K9: ``points`` (B, N, 3) centred with each pair's
    valid points first, ``counts`` (B,) valid points (None: all),
    ``state`` (B, K, 10) the level's [pi, mu, cov6] at the start,
    ``parent`` (B, N) each point's parent local to the previous level.
    Returns (state (B, K, 10), child (B, N) int64 local to this level, 0
    for padding, diag (B, 2) [q, n_iter])."""
    cnt = _counts(points, counts).tolist()
    states, childs, diags = [], [], []
    for b, n in enumerate(cnt):
        st, ch, q, it = _level_plain_pair(
            points[b, :n], parent[b, :n].long(), state[b],
            lambda_s=float(lambda_s), lambda_d=float(lambda_d),
            maxiter=int(maxiter))
        states.append(st)
        childs.append(torch.cat([ch, ch.new_zeros(points.shape[1] - n)]))
        diags.append(torch.tensor([float(q), float(it)]))
    return (torch.stack(states), torch.stack(childs),
            torch.stack(diags).to(points.device))


def level_em(points, counts, state, parent, *, lambda_s, lambda_d,
             maxiter=50):
    """One tree level's build EM for a batch of pairs, as ONE launch of K9
    (see ``level_em_plain`` for the arguments and results)."""
    points = _check_points(points, "points")
    if state.dim() != 3 or state.shape[2] != 10 \
            or state.shape[1] % N_NODE != 0:
        raise ValueError(f"expected a (B, 8P, 10) level state, got "
                         f"{tuple(state.shape)}")
    if 4 * _K9_NODE_FLOATS * state.shape[1] > _SMEM_BYTES:
        raise ValueError(f"{state.shape[1]} nodes do not fit one block's "
                         "shared memory (see fused_build_ok)")
    run = _level_em_cuda if points.is_cuda else level_em_plain
    return run(points, counts, state.float().contiguous(), parent,
               lambda_s=lambda_s, lambda_d=lambda_d, maxiter=maxiter)


def sort_by_parent(points, counts, parent, n_parents):
    """Each pair's valid points grouped by parent, in order (padding last):
    (points (B, N, 3), seg (B, P + 1) int32 where parent p's points are
    seg[p] .. seg[p + 1] and seg[P] is the valid count, order (B, N))."""
    n_cap = points.shape[1]
    cnt = _counts(points, counts)
    valid = torch.arange(n_cap, device=points.device)[None, :] < cnt[:, None]
    key = torch.where(valid, parent.long(),
                      torch.full_like(parent.long(), n_parents))
    key_s, order = torch.sort(key, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[:, :, None].expand_as(points))
    bounds = torch.arange(n_parents + 1, device=points.device).expand(
        points.shape[0], -1).contiguous()
    seg = torch.searchsorted(key_s, bounds).to(torch.int32)
    return pts_s.contiguous(), seg.contiguous(), order


def blocks_per_pair(n_cap: int, batch: int, capacity: int) -> int:
    """Thread blocks that share each pair of a K9 or K10 launch: one per
    chunk of an ``n_cap``-point pair, as many as ``capacity`` resident
    blocks of that kernel allow for the batch; 1 for pairs of fewer than
    _MIN_SPLIT_CHUNKS chunks and when the batch alone fills the card."""
    per = min(-(-n_cap // CHUNK), capacity // max(batch, 1))
    return per if per >= _MIN_SPLIT_CHUNKS else 1


_capacity_cache = {}


def _capacity(entry: str, nodes: int, device) -> int:
    """Blocks of the kernel behind ``entry`` (a tree level or a tree of
    ``nodes`` nodes) that can be resident at once on ``device``, queried
    once per kernel, device and node count."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (entry, index, nodes)
    if key not in _capacity_cache:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _check(getattr(_lib(), f"probreg_{entry}")(
                nodes, ctypes.addressof(out)), entry)
        _capacity_cache[key] = out.value
    return _capacity_cache[key]


def level_capacity(k_nodes: int, device) -> int:
    """K9 blocks of ``k_nodes`` nodes that can be resident at once on
    ``device``."""
    return _capacity("gmmtree_level_capacity", k_nodes, device)


def scratch_sizes(n_cap: int, k_nodes: int):
    """(c_cap, l_cap): chunks and point ranges of K9's scratch per pair. A
    pair's parents cut its at most n_cap points into at most
    ceil(n_cap / CHUNK) + P chunks (each parent's segment adds at most one
    partial chunk); the stop test cuts them into ceil(n_cap / CHUNK)
    ranges."""
    ranges = -(-n_cap // CHUNK)
    return ranges + k_nodes // N_NODE, ranges


def level_launch(pts_s, seg, state, *, lambda_s, lambda_d, maxiter,
                 _blocks=None):
    """One launch of K9 on points sorted by ``sort_by_parent``: (state,
    child (B, N) int32 in the sorted order, diag (B, 2)). ``_blocks``
    forces the blocks per pair (tests); by default ``blocks_per_pair``."""
    batch, n_cap = pts_s.shape[0], pts_s.shape[1]
    k_nodes = state.shape[1]
    per = _blocks or blocks_per_pair(
        n_cap, batch, level_capacity(k_nodes, pts_s.device))
    c_cap, l_cap = scratch_sizes(n_cap, k_nodes)
    # One scratch buffer: chunk moments, range log-likelihoods, flags.
    n_part, n_ll = batch * c_cap * _PART_WIDTH, batch * l_cap
    scratch = pts_s.new_empty(n_part + n_ll + batch)
    base = scratch.data_ptr()
    state_out = torch.empty_like(state)
    child_s = torch.zeros((batch, n_cap), dtype=torch.int32,
                          device=pts_s.device)
    diag = pts_s.new_empty((batch, 2))
    status = _lib().probreg_gmmtree_level_em(
        pts_s.data_ptr(), n_cap, seg.data_ptr(), k_nodes, state.data_ptr(),
        batch, per, c_cap, l_cap, float(lambda_s), float(lambda_d),
        int(maxiter), base, base + 4 * n_part, base + 4 * (n_part + n_ll),
        state_out.data_ptr(), child_s.data_ptr(), diag.data_ptr(),
        _stream(pts_s))
    _check(status, "gmmtree_level_em")
    LAUNCHES["gmmtree_level_em"] += 1
    return state_out, child_s, diag


def _level_em_cuda(points, counts, state, parent, *, lambda_s, lambda_d,
                   maxiter):
    pts_s, seg, order = sort_by_parent(points, counts, parent,
                                       state.shape[1] // N_NODE)
    state_out, child_s, diag = level_launch(
        pts_s, seg, state, lambda_s=lambda_s, lambda_d=lambda_d,
        maxiter=maxiter)
    child = torch.zeros(points.shape[:2], dtype=torch.int64,
                        device=points.device)
    child.scatter_(1, order, child_s.long())
    return state_out, child, diag


# --------------------------------------------------------------------------
# K10: the whole registration
# --------------------------------------------------------------------------

def log_pdf_terms(cov: torch.Tensor):
    """(inv, norm, valid) of 3x3 covariances (gmmtree._log_pdf_terms):
    det < 1e-15 is dead, with inv = I and norm = 0."""
    det = torch.linalg.det(cov)
    valid = det >= _EPS
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    inv = torch.linalg.inv(torch.where(valid[..., None, None], cov, eye))
    norm = 1.0 / (torch.sqrt(torch.clamp(det, min=_EPS)) * _TWO_PI_15)
    return inv, torch.where(valid, norm, torch.zeros_like(norm)), valid


def complexity(cov: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue over the eigenvalue sum (gmmtree.cc:35-40)."""
    lmds = eigvalsh3(cov)
    return lmds[..., -1] / torch.clamp(lmds.sum(-1), min=_EPS)


def reg_tables(targets, counts, pi, mu, cov):
    """Per-tree set-up of K10 for (B, N, 3) targets with valid points first
    and (B, T) / (B, T, 3) / (B, T, 3, 3) trees: (ys, table, cen).

    ``cen`` (B, 3) is the shared centroid of the valid targets and the node
    means (gmmtree._tree_centroid); ``ys`` the targets minus it (padding
    0); ``table`` (B, T, 24) per node [mu - cen (3), inv (6: 00, 01, 02,
    11, 12, 22), pi, norm, complexity, eigenvectors (9, row-major, columns
    are vectors), eigenvalues floored at 1e-7 (3)]."""
    n_cap = targets.shape[1]
    valid = (torch.arange(n_cap, device=targets.device)[None, :]
             < counts[:, None]).to(targets.dtype)
    # In f64, so padding rows cannot change the rounding (a padded pair is
    # its unpadded registration).
    tsum = (targets * valid[..., None]).double().sum(1).to(targets.dtype)
    cen = (tsum + mu.sum(1)) / (counts.to(targets.dtype)
                                + mu.shape[1])[:, None]
    ys = (targets - cen[:, None, :]) * valid[..., None]
    lmd, nn = eigh3(cov)
    lmd = torch.clamp(lmd, min=1e-7)
    inv, norm, _ = log_pdf_terms(cov)
    inv6 = inv.reshape(*inv.shape[:-2], 9)[..., [0, 1, 2, 4, 5, 8]]
    table = torch.cat([mu - cen[:, None, :], inv6, pi[..., None],
                       norm[..., None], complexity(cov)[..., None],
                       nn.reshape(*nn.shape[:-2], 9), lmd], -1)
    return ys.contiguous(), table.float().contiguous(), cen


def run_gmmtree_reg_fused_batch(targets, pi, mu, cov, rot0=None, t0=None,
                                tmasks=None, *, max_level, lambda_c, maxiter,
                                tol, plain=False):
    """Whole GMMTree registrations of a batch as ONE launch of K10.

    ``targets`` (B, N, 3) [+ ``tmasks`` (B, N) 0/1], trees ``pi`` (B, T),
    ``mu`` (B, T, 3), ``cov`` (B, T, 3, 3) in the targets' raw frame,
    ``rot0`` / ``t0`` the starting pose, (3, 3) / (3,) for every pair or
    (B, 3, 3) / (B, 3), identity by default. Returns (rot (B, 3, 3),
    t (B, 3), q (B,), n_iter (B,) int) in the raw frame: x -> rot x + t
    moves each target onto its tree. ``plain``: the plain version on any
    device and for any depth (a route outside the kernel's gate)."""
    targets = _check_points(targets, "targets")
    if pi.shape[1] != _n_total(max_level):
        raise ValueError(f"a tree of {pi.shape[1]} nodes is not one of "
                         f"{max_level} levels")
    if not plain and not fused_reg_ok(max_level):
        raise ValueError(f"a tree of {max_level} levels does not fit one "
                         "block's shared memory (see fused_reg_ok)")
    batch = targets.shape[0]
    if tmasks is None:
        counts = _counts(targets, None)
    else:
        targets, counts = _compact(targets, tmasks)
        counts = counts.long()
    ys, table, cen = reg_tables(targets, counts, pi.float(), mu.float(),
                                cov.float())
    eye = torch.eye(3, dtype=targets.dtype, device=targets.device)
    rot0 = eye if rot0 is None else torch.as_tensor(rot0).to(targets)
    t0 = targets.new_zeros(3) if t0 is None else torch.as_tensor(t0).to(
        targets)
    rot0 = rot0.reshape(-1, 3, 3).expand(batch, 3, 3)
    t0 = t0.reshape(-1, 3).expand(batch, 3)
    t0c = t0 + (rot0 @ cen[:, :, None])[:, :, 0] - cen   # centred frame
    init = torch.cat([rot0.reshape(batch, 9), t0c], 1).contiguous()
    run = _reg_cuda if targets.is_cuda and not plain \
        else run_gmmtree_reg_fused_plain
    out = run(ys, counts.to(torch.int32).contiguous(), table, init,
              max_level=int(max_level), maxiter=int(maxiter),
              tol=float(tol), lambda_c=float(lambda_c))
    rot = out[:, :9].reshape(-1, 3, 3)
    t = out[:, 9:12] + cen - (rot @ cen[:, :, None])[:, :, 0]
    return rot, t, out[:, 12], out[:, 13].to(torch.int32)


def run_gmmtree_reg_fused(target, pi, mu, cov, rot0=None, t0=None,
                          tmask=None, *, max_level, lambda_c, maxiter, tol):
    """One pair as one launch: (rot (3, 3), t (3,), q, n_iter)."""
    rot, t, q, it = run_gmmtree_reg_fused_batch(
        target[None], pi[None], mu[None], cov[None], rot0, t0,
        None if tmask is None else tmask[None], max_level=max_level,
        lambda_c=lambda_c, maxiter=maxiter, tol=tol)
    return rot[0], t[0], q[0], it[0]


def reg_capacity(t_nodes: int, device) -> int:
    """K10 blocks for a tree of ``t_nodes`` nodes that can be resident at
    once on ``device``."""
    return _capacity("gmmtree_reg_capacity", t_nodes, device)


def reg_scratch_sizes(n_cap: int, t_nodes: int):
    """(c_cap, floats): the chunks of at most ``n_cap`` targets and the
    floats of K10's scratch per pair, the T x [m0, m1] partials of every
    chunk twice (one buffer per iteration parity)."""
    c_cap = -(-n_cap // CHUNK)
    return c_cap, 2 * c_cap * 4 * t_nodes


def _reg_cuda(ys, counts, table, init, *, max_level, maxiter, tol,
              lambda_c, _blocks=None):
    """One launch of K10 on ``reg_tables``' inputs: (B, 16) rows as
    ``run_gmmtree_reg_fused_plain``'s. ``_blocks`` forces the blocks per
    pair (tests); by default ``blocks_per_pair``."""
    batch, n_cap, t_nodes = ys.shape[0], ys.shape[1], table.shape[1]
    per = _blocks or blocks_per_pair(n_cap, batch,
                                     reg_capacity(t_nodes, ys.device))
    c_cap, n_part = reg_scratch_sizes(n_cap, t_nodes)
    # One scratch buffer: chunk partials, then the flags (int32).
    scratch = ys.new_empty(batch * n_part + 2 * batch)
    base = scratch.data_ptr()
    out = ys.new_empty((batch, 16))
    status = _lib().probreg_gmmtree_reg(
        ys.data_ptr(), n_cap, counts.data_ptr(), table.data_ptr(), t_nodes,
        init.data_ptr(), batch, per, c_cap, max_level, maxiter, tol,
        lambda_c, base, base + 4 * batch * n_part, out.data_ptr(),
        _stream(ys))
    _check(status, "gmmtree_reg")
    LAUNCHES["gmmtree_reg"] += 1
    return out


def _descend(x, table, max_level, lambda_c):
    """The descent of every point: (node (n,) int64, gmax (n,))."""
    mu, inv, pi, norm = (table[:, 0:3], table[:, 3:9], table[:, 9],
                         table[:, 10])
    cplx = table[:, 11]
    n = x.shape[0]
    eight = torch.arange(N_NODE, device=x.device)
    parent = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    search = torch.zeros(n, dtype=torch.int64, device=x.device)
    gmax = x.new_zeros(n)
    stopped = torch.zeros(n, dtype=torch.bool, device=x.device)
    for _ in range(max_level):
        cidx = ((parent + 1) * N_NODE)[:, None] + eight
        ep = mahalanobis_exponent(x[:, None, :] - mu[cidx], inv[cidx])
        u = pi[cidx] * (norm[cidx] * torch.exp(torch.clamp(ep, max=0.0)))
        den = u.sum(1, keepdim=True)
        g = torch.where(den > _EPS, u / den, torch.zeros_like(u))
        arg = g.argmax(1, keepdim=True)          # the first maximum
        search = torch.where(stopped, search, cidx.gather(1, arg)[:, 0])
        gmax = torch.where(stopped, gmax, g.gather(1, arg)[:, 0])
        stopped = stopped | (cplx[search] <= lambda_c)
        parent = torch.where(stopped, parent, search)
    return search, gmax


def twist_rows(m0, m1, table):
    """(T, 3, 7) rows [s x v_j, v_j, b_j] of the twist system, one per node
    and eigendirection j: v_j the j-th eigenvector scaled by
    sqrt(m0 / lambda_j), s = m1 / m0, b_j = v_j . (mu - s); zero where
    m0 < f32 eps (gmmtree._mstep_core)."""
    keep = m0 >= _EPS32
    m0s = torch.clamp(m0, min=_EPS32)
    s = m1 / m0s[:, None]
    scale = torch.sqrt(m0s[:, None] / torch.clamp(table[:, 21:24],
                                                  min=_EPS32))
    v = table[:, 12:21].reshape(-1, 3, 3).transpose(1, 2) * scale[:, :, None]
    dmu = table[:, 0:3] - s
    b = (v * dmu[:, None, :]).sum(-1)
    s0, s1, s2 = s[:, None, 0], s[:, None, 1], s[:, None, 2]
    v0, v1, v2 = v.unbind(-1)
    rows = torch.stack([s1 * v2 - s2 * v1, s2 * v0 - s0 * v2,
                        s0 * v1 - s1 * v0, v0, v1, v2, b], -1)
    return torch.where(keep[:, None, None], rows, torch.zeros_like(rows))


def solve_twist(ata: torch.Tensor, atb: torch.Tensor) -> torch.Tensor:
    """The twist of the 6 x 6 normal equations with the 1e-8 ridge, solved
    in double."""
    a = ata.double() + 1e-8 * torch.eye(6, dtype=torch.float64,
                                        device=ata.device)
    return torch.linalg.solve(a, atb.double())


def compose_twist(x, rot, t):
    """(rot, t) after the twist x = (w, v) in double: dR = Rodrigues(w)
    (identity when |w|^2 < 1e-12), rot <- dR rot, t <- dR t + v
    (se3_op.twist_mul)."""
    w, v = x[:3], x[3:]
    twd2 = float((w * w).sum())
    dr = torch.eye(3, dtype=torch.float64, device=x.device)
    if twd2 >= 1e-12:
        twd = math.sqrt(twd2)
        nw = w / twd
        sk = torch.zeros(3, 3, dtype=torch.float64, device=x.device)
        sk[0, 1], sk[0, 2], sk[1, 2] = -nw[2], nw[1], -nw[0]
        sk = sk - sk.T
        dr = (math.cos(twd) * dr + (1.0 - math.cos(twd)) * torch.outer(nw, nw)
              + math.sin(twd) * sk)
    return ((dr @ rot.double()).to(rot.dtype),
            (dr @ t.double() + v).to(t.dtype))


def _reg_plain_pair(ys, table, init, *, max_level, maxiter, tol, lambda_c):
    t_nodes = table.shape[0]
    rot, t = init[:9].reshape(3, 3), init[9:12]
    nodes = torch.arange(t_nodes, device=ys.device)
    q, q_prev, it = np.float32(np.inf), np.float32(np.inf), 0
    while _go(it, maxiter, q, q_prev, tol):
        x = ys @ rot.T + t
        node, gmax = _descend(x, table, max_level, lambda_c)
        onehot = (node[None, :] == nodes[:, None]).to(ys.dtype)   # (T, n)
        m0 = onehot @ gmax
        m1 = onehot @ (gmax[:, None] * x)
        rows = twist_rows(m0, m1, table).reshape(-1, 7)
        amat, b = rows[:, :6], rows[:, 6]
        sol = solve_twist(amat.T @ amat, amat.T @ b)
        q_new = ((amat @ sol.to(amat.dtype) - b) ** 2).sum()
        rot, t = compose_twist(sol, rot, t)
        q_prev, q = q, np.float32(float(q_new))
        it += 1
    return torch.cat([rot.reshape(-1), t,
                      t.new_tensor([float(q), float(it), 0.0, 0.0])])


def run_gmmtree_reg_fused_plain(ys, counts, table, init, *, max_level,
                                maxiter, tol, lambda_c):
    """Plain version of K10: ``ys`` (B, N, 3) centred targets with each
    pair's ``counts`` (B,) valid points first, ``table`` (B, T, 24) from
    ``reg_tables``, ``init`` (B, 12) the starting [rot, t] in the centred
    frame. Returns (B, 16) rows [rot (9), t (3, centred frame), q, n_iter,
    0, 0], pair by pair with the stop test on the host."""
    rows = []
    for b, n in enumerate(counts.tolist()):
        rows.append(_reg_plain_pair(ys[b, :n], table[b], init[b],
                                    max_level=max_level, maxiter=maxiter,
                                    tol=tol, lambda_c=lambda_c))
    return torch.stack(rows)

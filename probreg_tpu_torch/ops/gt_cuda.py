"""Tile-culled exact Gauss transform on the card, beside its plain version.

Counterpart of probreg_tpu/ops/estep_pallas.py ``gauss_transform_culled``
(the ``_gt_kernel`` TPU kernel):

    out[i, c] = sum_j exp(-|target_i - source_j|^2 / h^2) * weights[j, c]

with the reference's argument order and h^2 (not 2 h^2), at most 8 weight
channels and 2 <= D <= 8. There is no normalizer, so one pass suffices. Both
clouds are centred on their shared centroid and, with ``sort=True``,
Morton-sorted here (the result comes back in the caller's order). Query
rows form tiles of 256, points tiles of ``tile``; a tile pair is culled
only when its box-gap bound proves that every exp in it underflows f32 to
exactly 0 (``estep_cuda._active_mask`` with 1/h^2 in place of
1/(2 sigma2)), so culling never changes a result, and a query tile with no
active point tile gets exact zeros. The kernel takes the channels at their
own width and D = 2, 3, 4 as they are (5 <= D <= 7 padded to 8); two
thread blocks share a query tile, ``ROWS_PER_THREAD`` rows a thread,
``SLOTS`` stages summed at once by separate threads.

With ``config.estep_fast_start`` (the reference's start-temperature
branch, ``fast_start=False`` to refuse it) the transform takes the fast
branch where ``estep_cuda.fast_gate`` on the centred clouds and 1/h^2 says
so: ``gauss_transform_fast`` forms q.p on the tensor cores from bf16
coordinates with an f32 sum and d2 in the expanded form |q|^2 + |p|^2 -
2 q.p (as ``_gt_kernel``), with |q|^2 and |p|^2 from the f32 points, and
the weights' sums on the tensor cores too: g in two bf16 pieces against the
weights in three (``weight_pieces``, split inside the kernel), which keeps
the reference's f32 product to ~2^-17 of sum_j g |w|. Both kernels are
launched and each returns at once unless the device flag picks it;
``FAST_STEPS`` counts the calls that took the fast branch, on the device.

CUDA tensors run the kernels (``csrc/gt.cu``); CPU tensors run
``gauss_transform_culled_plain``. Nothing else picks between them. Every
launch adds one to ``LAUNCHES["gauss_transform"]`` or
``LAUNCHES["gauss_transform_fast"]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import config
from . import _build
from . import estep_cuda as ec
from .pairwise import sqdist_diff
from .spatial import morton_order

_ROWS = 256           # query rows per culling tile (csrc/gt.cu kTile)
BLOCK_ROWS = 128      # query rows per thread block (kBlockRows)
ROWS_PER_THREAD = 2   # (kRowsPerThread)
SLOTS = 2             # stages a block sums at once (kSlots)
MAX_CHANNELS = 8
_PLAIN_POINTS = 1024  # points per step of the plain version

LAUNCHES = {"gauss_transform": 0, "gauss_transform_fast": 0}
# Calls that took the fast branch, per device (estep_cuda.tally_fast).
FAST_STEPS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FAST_STEPS.clear()


def fast_steps() -> int:
    """Calls that took the fast branch since reset_launches()."""
    return ec.fast_steps(FAST_STEPS)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("gt")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_gauss_transform.argtypes = [_P, _I, _P, _P, _I, _I, _I,
                                                _P, _P, _I, _F, _P, _P, _P]
        lib.probreg_gauss_transform_fast.argtypes = [
            _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P]
        lib.probreg_gauss_transform_fast_dump.argtypes = [
            _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P,
            _P]
        for fn in (lib.probreg_gauss_transform,
                   lib.probreg_gauss_transform_fast,
                   lib.probreg_gauss_transform_fast_dump):
            fn.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` contiguous with zero columns up to ``width`` (no copy when it
    is already that wide and contiguous)."""
    if x.shape[1] == width:
        return x.contiguous()
    out = x.new_zeros((x.shape[0], width))
    out[:, :x.shape[1]] = x
    return out


def _width(dim: int) -> int:
    """The kernel's width for D coordinates: D itself for D <= 4, else 8
    (the padding adds exact zeros to d2)."""
    return dim if dim <= 4 else 8


def launch_shape(nq: int):
    """(blocks, threads) of one launch on ``nq`` query rows."""
    return -(-nq // BLOCK_ROWS), BLOCK_ROWS // ROWS_PER_THREAD * SLOTS


def prepare(source, target, weights, h, tile: int = 256, cull: bool = True):
    """What the kernel and its plain version take, for clouds already
    centred and in the order wanted: (qs, ps, w, inv_h2, mask, tile), with
    mask (n_point_tiles, n_query_tiles) True where a tile pair may
    contribute."""
    inv_h2 = 1.0 / float(h) ** 2
    tile = min(int(tile), ec._round_up(source.shape[0], 8))
    if cull:
        mask = ec._active_mask(*ec._tile_bounds(source, tile),
                               *ec._tile_bounds(target, _ROWS), inv_h2)
    else:
        mask = torch.ones((-(-source.shape[0] // tile),
                           -(-target.shape[0] // _ROWS)),
                          dtype=torch.bool, device=source.device)
    return target, source, weights, inv_h2, mask, tile


def gauss_transform_culled(source, target, weights, h, tile: int = 256,
                           cull: bool = True, sort: bool = True,
                           fast_start: bool = None):
    """Tile-culled Gauss transform: (len(target), C), or (len(target),) for
    1-D weights. ``sort=False`` trusts the caller's (Morton) order, as the
    streaming FilterReg loop that sorts once. ``fast_start`` (default
    ``config.estep_fast_start``): take the reference's gate (the fast
    branch where its bound allows); False keeps the exact branch."""
    squeeze = weights.dim() == 1
    if squeeze:
        weights = weights[:, None]
    if source.dim() != 2 or target.dim() != 2 \
            or source.shape[1] != target.shape[1] \
            or weights.shape[0] != source.shape[0]:
        raise ValueError("expected (M, D) source, (N, D) target and (M, C) "
                         f"weights, got {tuple(source.shape)}, "
                         f"{tuple(target.shape)}, {tuple(weights.shape)}")
    dim, c = source.shape[1], weights.shape[1]
    if not 2 <= dim <= 8 or not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the Gauss transform kernel takes 2 <= D <= 8 and "
                         f"1 <= C <= {MAX_CHANNELS}, got D = {dim}, C = {c}")
    if source.shape[0] == 0 or target.shape[0] == 0:
        raise ValueError("empty point cloud")
    if len({source.device, target.device, weights.device}) != 1:
        raise ValueError("source, target and weights on different devices")
    if {source.dtype, target.dtype, weights.dtype} != {torch.float32}:
        raise ValueError("the Gauss transform kernel takes float32 inputs")
    cen = (source.sum(0) + target.sum(0)) / (source.shape[0]
                                             + target.shape[0])
    source, target = source - cen, target - cen
    if sort:
        perm_p, perm_q = morton_order(source), morton_order(target)
        source, weights, target = source[perm_p], weights[perm_p], \
            target[perm_q]
    gate = None
    if config.estep_fast_start if fast_start is None else fast_start:
        gate = ec.fast_gate((target * target).sum(1),
                            (source * source).sum(1), 1.0 / float(h) ** 2)
        ec.tally_fast(FAST_STEPS, gate)
    out = gt_core(*prepare(source, target, weights, h, tile, cull), gate)
    if sort:
        out = torch.empty_like(out).index_copy_(0, perm_q, out)
    return out[:, 0] if squeeze else out


def gt_core(qs, ps, w, inv_h2, mask, tile, gate=None):
    """(N, C) Gauss transform of prepared inputs: the kernel for CUDA
    tensors (with ``gate``, fast_gate's flag, both branches' kernels, each
    running only where the flag picks it), the plain version for CPU
    tensors."""
    if qs.is_cuda:
        return _gt_cuda(qs, ps, w, inv_h2, mask, tile, gate)
    return gauss_transform_culled_plain(qs, ps, w, inv_h2, mask, tile, gate)


def _gt_cuda(qs, ps, w, inv_h2, mask, tile, gate=None):
    launch, out = gt_launcher(qs, ps, w, inv_h2, mask, tile, gate)
    launch()
    return out


def gt_launcher(qs, ps, w, inv_h2, mask, tile, gate=None, g_dump=None):
    """(launch, out) for prepared CUDA inputs: the active-tile lists and
    padded buffers are made here, once; each ``launch()`` queues one kernel
    launch that writes the (N, C) result into ``out`` (with ``gate``, the
    exact kernel's and the fast kernel's, one of which returns at once).
    ``g_dump`` (tests only, with ``gate``): an (N, M) f32 buffer that takes
    every Gaussian the fast kernel forms."""
    (nq, dim), (m, c) = qs.shape, w.shape
    dp = _width(dim)
    act_idx, act_cnt = ec._compact(mask)          # per query tile
    # The closure holds its inputs until its last launch is queued.
    qk, pk = _pad_cols(qs, dp), _pad_cols(ps, dp)
    wk = w.contiguous()
    out = qs.new_empty((nq, c))
    lib, stream = _lib(), ec._stream(qs)
    if gate is not None:
        gate = gate.to(torch.int32).reshape(1).contiguous()
        q2, p2 = (qs * qs).sum(1), (ps * ps).sum(1)
    gate_ptr = None if gate is None else gate.data_ptr()

    def launch_fast():
        args = (qk.data_ptr(), q2.data_ptr(), nq, pk.data_ptr(),
                p2.data_ptr(), wk.data_ptr(), m, dp, c, act_idx.data_ptr(),
                act_cnt.data_ptr(), tile, inv_h2, gate_ptr, out.data_ptr())
        if g_dump is None:
            err = lib.probreg_gauss_transform_fast(*args, stream)
        else:
            err = lib.probreg_gauss_transform_fast_dump(
                *args, g_dump.data_ptr(), stream)
        ec._check(err, "gauss_transform_fast")
        LAUNCHES["gauss_transform_fast"] += 1

    def launch():
        ec._check(lib.probreg_gauss_transform(
            qk.data_ptr(), nq, pk.data_ptr(), wk.data_ptr(), m, dp, c,
            act_idx.data_ptr(), act_cnt.data_ptr(), tile, inv_h2,
            gate_ptr, out.data_ptr(), stream), "gauss_transform")
        LAUNCHES["gauss_transform"] += 1
        if gate is not None:
            launch_fast()

    # The fast kernel alone (with a gate), for timing it.
    launch.fast = launch_fast if gate is not None else None
    return launch, out


def gt_fast_dump(qs, ps, w, inv_h2, mask, tile):
    """Tests only: the fast kernel (flag 1) on prepared CUDA inputs, with
    every Gaussian it forms, before its split: (out (N, C), g (N, M)), g NaN
    at the pairs of culled tiles."""
    g = qs.new_full((qs.shape[0], ps.shape[0]), float("nan"))
    gate = torch.ones((), dtype=torch.int32, device=qs.device)
    launch, out = gt_launcher(qs, ps, w, inv_h2, mask, tile, gate, g)
    launch.fast()
    return out, g


def weight_pieces(w: torch.Tensor) -> torch.Tensor:
    """(M, 3, C) bf16: the fast kernel's split of the (M, C) f32 weights,
    hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), each
    difference exact in f32 (estep_cuda.bf16_pieces). The kernel forms the
    same pieces while it stages each weight; this documents its operand and
    serves the tests."""
    return ec.bf16_pieces(w)


def plain_blocks(qs, ps, inv_h2, mask, tile, fast=False):
    """The plain version's Gaussians, point block by point block: (p0,
    g (N, step)) with g zeroed in culled tile pairs; with ``fast``, the
    fast kernel's d2 = max(|q|^2 + |p|^2 - 2 q.p, 0) with q.p from the
    bf16-rounded coordinates summed in f32, |q|^2 and |p|^2 from the f32
    points."""
    nq = qs.shape[0]
    rows = torch.arange(nq, device=qs.device) // _ROWS
    step = max(tile, _PLAIN_POINTS // tile * tile)
    if fast:
        q2, qb = (qs * qs).sum(1), ec._bf16(qs)
    for p0 in range(0, ps.shape[0], step):
        p = ps[p0:p0 + step]
        if fast:
            d2 = torch.clamp(q2[:, None] + (p * p).sum(1)[None, :]
                             - 2.0 * (qb @ ec._bf16(p).T), min=0.0)
        else:
            d2 = sqdist_diff(qs, p)
        cols = torch.arange(p0, p0 + p.shape[0], device=qs.device) // tile
        act = mask[cols][:, rows].T                      # (N, step)
        yield p0, torch.where(act, torch.exp(-d2 * inv_h2), 0.0)


def gauss_transform_culled_plain(qs, ps, w, inv_h2, mask, tile, gate=None):
    """Plain version of the kernel: d2 from differences, exp(-d2 / h^2)
    zeroed in culled tile pairs, summed against the weights in f32 (the
    reference's g @ w), point tile by point tile. ``gate`` (fast_gate's
    flag or a bool, read here): where it is set, the fast kernel's d2
    (plain_blocks). The same arguments as gt_core."""
    fast = gate is not None and bool(gate)
    out = qs.new_zeros((qs.shape[0], w.shape[1]))
    for p0, g in plain_blocks(qs, ps, inv_h2, mask, tile, fast):
        out = out + g @ w[p0:p0 + g.shape[1]]
    return out

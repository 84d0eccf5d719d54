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

The reference's fast-start branch (a bf16 cross term under an error bound
derived for the TPU's matrix unit) is not ported: the port always takes
the exact branch, as it does for the CPD E-step.

CUDA tensors run the kernel (``csrc/gt.cu``); CPU tensors run
``gauss_transform_culled_plain``. Nothing else picks between them. Every
launch adds one to ``LAUNCHES["gauss_transform"]``.
"""

from __future__ import annotations

import ctypes

import torch

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

LAUNCHES = {"gauss_transform": 0}


def reset_launches() -> None:
    LAUNCHES["gauss_transform"] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("gt")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_gauss_transform.argtypes = [_P, _I, _P, _P, _I, _I, _I,
                                                _P, _P, _I, _F, _P, _P]
        lib.probreg_gauss_transform.restype = ctypes.c_int
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
                           cull: bool = True, sort: bool = True):
    """Tile-culled exact Gauss transform: (len(target), C), or
    (len(target),) for 1-D weights. ``sort=False`` trusts the caller's
    (Morton) order, as the streaming FilterReg loop that sorts once."""
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
    out = gt_core(*prepare(source, target, weights, h, tile, cull))
    if sort:
        out = torch.empty_like(out).index_copy_(0, perm_q, out)
    return out[:, 0] if squeeze else out


def gt_core(qs, ps, w, inv_h2, mask, tile):
    """(N, C) Gauss transform of prepared inputs: one kernel launch for
    CUDA tensors, the plain version for CPU tensors."""
    if qs.is_cuda:
        return _gt_cuda(qs, ps, w, inv_h2, mask, tile)
    return gauss_transform_culled_plain(qs, ps, w, inv_h2, mask, tile)


def _gt_cuda(qs, ps, w, inv_h2, mask, tile):
    launch, out = gt_launcher(qs, ps, w, inv_h2, mask, tile)
    launch()
    return out


def gt_launcher(qs, ps, w, inv_h2, mask, tile):
    """(launch, out) for prepared CUDA inputs: the active-tile lists and
    padded buffers are made here, once; each ``launch()`` queues one kernel
    launch that writes the (N, C) result into ``out``."""
    (nq, dim), (m, c) = qs.shape, w.shape
    dp = _width(dim)
    act_idx, act_cnt = ec._compact(mask)          # per query tile
    # The closure holds its inputs until its last launch is queued.
    qk, pk = _pad_cols(qs, dp), _pad_cols(ps, dp)
    wk = w.contiguous()
    out = qs.new_empty((nq, c))
    lib, stream = _lib(), ec._stream(qs)

    def launch():
        ec._check(lib.probreg_gauss_transform(
            qk.data_ptr(), nq, pk.data_ptr(), wk.data_ptr(), m, dp, c,
            act_idx.data_ptr(), act_cnt.data_ptr(), tile, inv_h2,
            out.data_ptr(), stream), "gauss_transform")
        LAUNCHES["gauss_transform"] += 1
    return launch, out


def gauss_transform_culled_plain(qs, ps, w, inv_h2, mask, tile):
    """Plain version of the kernel: d2 from differences, exp(-d2 / h^2)
    zeroed in culled tile pairs, summed against the weights, point tile by
    point tile."""
    nq = qs.shape[0]
    rows = torch.arange(nq, device=qs.device) // _ROWS
    out = qs.new_zeros((nq, w.shape[1]))
    step = max(tile, _PLAIN_POINTS // tile * tile)
    for p0 in range(0, ps.shape[0], step):
        p = ps[p0:p0 + step]
        d2 = sqdist_diff(qs, p)
        cols = torch.arange(p0, p0 + p.shape[0], device=qs.device) // tile
        act = mask[cols][:, rows].T                      # (N, step)
        g = torch.where(act, torch.exp(-d2 * inv_h2), 0.0)
        out = out + g @ w[p0:p0 + step]
    return out

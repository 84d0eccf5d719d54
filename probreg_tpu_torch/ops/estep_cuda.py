"""CPD E-step kernels on the card, each beside its plain PyTorch version.

Counterpart of the kernels of probreg_tpu/ops/estep_pallas.py on the CPD
path, with their helpers:

* ``estep_small``: the whole E-step in one cooperative launch for M * N <=
  2^20 and D <= 3 (replaces ``_small_kernel``): tiles of R sources x C
  targets spread over every SM (``small_plan``), the scalars formed in the
  kernel, the clouds read as they are, scratch kept per device and stream
  (``small_scratch``); one device launch per call.
* ``estep_auto``: the tile-culled E-step on Morton-sorted clouds (the
  reference's stash E-step), two launches and no stash: pass A
  (``stash_den``, replaces ``_stash_den_kernel``) walks each target stripe's
  active source tiles and forms the column normalizer (per-tile partial
  sums added in tile order), pt1 and xx; pass B (``stash_moment``, replaces
  ``_stash_moment_kernel``) walks each source tile's active stripes, forms
  each pair's Gaussian again and sums p1 and px. The TPU kernels stash each
  exp between the passes; on the card the stash's bytes cost more than the
  exp. With ``config.use_merged_stash`` the E-step takes the association
  of the reference's pipelined kernel (``_stash_merged_kernel``), two
  launches and no stash either: K3's pass A, then ``stash_merged``, pass B
  with the normalizer folded into the channels for every stripe but the
  last. When even tile_n = 256 would put the reference's stash over its
  budget (half of it under ``use_merged_stash``, which keeps two),
  ``estep_auto`` returns the streaming plain E-step (``ops/estep.estep_xla``)
  as the reference does: no route here keeps a stash, but all take the
  same capped tiles and the same fallback, so that both packages branch
  at the same sizes.
* ``stash_estep(..., reduce_den=)``: the E-step on one source shard of a
  2-D (m, n) mesh (parallel/sharded2d.py), where a target column's
  normalizer sums over every source shard: pass A stops at the raw column
  sums of every stripe (``stash_den_raw``, replaces
  ``_stash_den_raw_kernel``), the caller all-reduces them over the m-axis
  once, ``stash_finish`` forms inv_den, pt1 and xx from them, and K3's pass
  B forms the Gaussian again: three launches and one reduction per E-step,
  no stash. All routes give the default route's pt1, inv_den and xx bit
  for bit on the same sums.
* ``estep_fused`` / ``estep_culled``: the two-pass tile-culled E-step with
  no stash: pass A (``fused_den``, replaces ``_den_kernel``) forms the column
  normalizer, pt1 and xx, pass B (``fused_moment``, replaces
  ``_moment_kernel``) computes each active pair's exp again and sums p1 and
  px. Each pass is one launch for the whole E-step; the kernels are K3's
  with one running sum per column and per row.

A tile pair is culled when its box-gap bound proves that every exp in it
underflows f32 to exactly 0 (sum_d max(0, gap_d)^2 * 0.5 / sigma2 > 104),
so culling never changes a result.

``estep_auto`` also takes the reference's start-temperature fast branch
(``config.estep_fast_start``, ``fast_gate``): where the bf16 rounding of
the cross term cannot move any exp argument by more than
``config.estep_fast_start_tol``, pass A (``stash_den_fast``) and pass B
(``stash_moment_fast``) form y.x on the tensor cores from bf16 coordinates
with an f32 sum and the Gaussian as exp2f on a pre-scaled argument; pass B
rounds each Gaussian to bf16 (the reference's bf16 stash) and takes its
moments on the tensor cores against ``moment_operand``, inv_den (x, 1)
split into three bf16 pieces, formed on the device after pass A. The
decision is a flag on the device: K3's exact passes and the fast passes
are both launched, and each reads the flag and returns at once unless it
is its branch, so no E-step reads the flag on the host. ``FAST_STEPS``
counts, on the device, the gated E-steps that took the fast branch.
``config.stash_dtype = torch.bfloat16`` (fast branch off) rounds pass B's
Gaussians the same way (``stash_moment_bf16``, ``stash_merged_bf16``).
Culling stays exact on the fast branch: a culled tile's exact argument
exceeds 104, and the branch moves no argument by more than the tolerance.

Each wrapper runs its CUDA kernel (``csrc/estep.cu``) on CUDA tensors and
its plain version on CPU tensors; nothing else picks between them. Every
kernel launch adds one to ``LAUNCHES[<kernel>]``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import config
from . import _build
from .estep import EstepMoments, estep_xla, outlier_constant
from .spatial import morton_order

# exp(-x) underflows below the smallest f32 subnormal (2^-149) for
# x > 103.28; 104 leaves margin for the f32 bound arithmetic.
_CUT = 104.0
_EPS = float(torch.finfo(torch.float32).eps)
_DEN_THREADS = 256   # columns per pass-A block (csrc/estep.cu kDenThreads)
_SMALL_THREADS = 256  # threads of a K2 block (kSmallThreads)
_SMALL_TILE = 16 * _SMALL_THREADS  # pairs of a K2 tile (kSmallTilePairs)
_MAX_GRID_Y = 65535

LAUNCHES = {"estep_small": 0, "stash_den": 0, "stash_moment": 0,
            "stash_merged": 0, "stash_den_raw": 0, "stash_finish": 0,
            "fused_den": 0, "fused_moment": 0, "stash_den_fast": 0,
            "stash_moment_fast": 0, "stash_moment_bf16": 0,
            "stash_merged_bf16": 0}
# Gated E-steps that took the fast branch, per device: an int32 tensor that
# each gated E-step adds its flag to on the device (read it after a run).
FAST_STEPS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FAST_STEPS.clear()


def fast_steps(tally=None) -> int:
    """Gated calls that took the fast branch since the last
    reset_launches(), over every device (``tally``: FAST_STEPS, or
    gt_cuda's): one host read a device."""
    tally = FAST_STEPS if tally is None else tally
    return int(sum(int(t) for t in tally.values()))


def tally_fast(tally, gate: torch.Tensor) -> None:
    """Adds a gated call's flag to ``tally`` on its device (no host read)."""
    key = str(gate.device)
    if key not in tally:
        tally[key] = torch.zeros((), dtype=torch.int32, device=gate.device)
    tally[key].add_(gate.reshape(()))


# --------------------------------------------------------------------------
# The start-temperature gate
# --------------------------------------------------------------------------
#
# Rounding a coordinate to bf16 (8 significant bits, round to nearest) moves
# it by at most 2^-9 of itself, so each product y_d x_d moves by at most
# (2 * 2^-9 + 2^-18) |y_d x_d| and, by Cauchy-Schwarz over d, 2 y.x by at
# most ~4 * 2^-9 |y| |x|; the products of two bf16 values are exact in f32
# and the tensor cores sum them in f32. The reference's bound, (1/2s2) * 8
# * 2^-9 * sqrt(max|y|^2 max|x|^2) for the CPD E-step and 1/h^2 in place of
# 1/2s2 for the Gauss transform, keeps a factor 2 over that for the f32
# sums; bf16 is the format the reference's one-pass DEFAULT product used,
# so the bound holds here as derived there. Each exp argument then moves by
# at most the bound, each Gaussian by a factor within e^(+-bound).

def fast_bound(y2: torch.Tensor, x2: torch.Tensor, inv) -> torch.Tensor:
    """The reference's bound on the exp-argument error of the bf16 cross
    term, as a 0-d f32 tensor on the clouds' device: inv * 8 * 2^-9 *
    sqrt(max y2 * max x2), from the squared norms of both clouds and inv
    = 1/(2 sigma2) (a device tensor) or 1/h^2 (a number, taken in f32;
    the scalings by 8 and 2^-9 are exact, so both forms round as the
    reference's f32 product does). No host read, no copy to the device."""
    root = torch.sqrt(y2.amax() * x2.amax())
    if isinstance(inv, torch.Tensor):
        return inv.to(torch.float32) * 8.0 * (2.0 ** -9) * root
    return root * (float(np.float32(inv)) * 8.0 * 2.0 ** -9)


def fast_gate(y2, x2, inv, tol=None) -> torch.Tensor:
    """The fast branch's flag, a 0-d int32 tensor on the clouds' device:
    1 where fast_bound <= tol (default config.estep_fast_start_tol). No
    host read."""
    tol = config.estep_fast_start_tol if tol is None else tol
    return (fast_bound(y2, x2, inv) <= tol).to(torch.int32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


# --------------------------------------------------------------------------
# The fast pass B's moment operand
# --------------------------------------------------------------------------
#
# The fast pass B computes sum_n bf16(g)_mn v_n, v_n = inv_den_n (x_n, y_n,
# z_n, 1), on the tensor cores (mma.sync m16n8k16, csrc/estep.cu
# moment_fast_kernel). Each f32 v_n goes in as three bf16 pieces whose sum
# is v_n to ~2^-24 of it; bf16(g) times a piece is exact in the f32
# accumulator, so the product rebuilds the reference's f32 p = bf16(g)
# inv_den and p x.

def moment_pieces(xs: torch.Tensor, inv_den: torch.Tensor) -> torch.Tensor:
    """(n, 3, 4) bf16: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
    mid) of v = inv_den (x, y, z, 1) in f32, from the (n, >= 3) packed
    targets (their first three columns; zeros past D) and inv_den (n). Each
    difference is exact in f32; a zero inv_den gives zero pieces."""
    return bf16_pieces(torch.cat([xs[:, :3] * inv_den[:, None],
                                  inv_den[:, None]], 1))


def bf16_pieces(v: torch.Tensor) -> torch.Tensor:
    """(n, 3, k) bf16: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
    mid) of the (n, k) f32 ``v``, each rounded to nearest even and each
    difference exact in f32, so hi + mid + lo is v to ~2^-24 of it (the
    tensor-core operands of moment_operand and of K6's fast kernel)."""
    hi = v.to(torch.bfloat16)
    rest = v - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo], 1)


def moment_operand(xs: torch.Tensor, inv_den: torch.Tensor,
                   tile_n: int) -> torch.Tensor:
    """The fast pass B's B operand: moment_pieces laid out in the fragment
    order of mma.sync.m16n8k16, each stripe of ``tile_n`` targets padded
    with zeros to a multiple of 16 (so a stripe starts a group). Shape
    (n_j * ceil(tile_n / 16), 32, 8) bf16: group G, lane 4 gid + tig, then
    the first product's b0, b1 and the second's b0, b1 (two bf16 each),
    where b0 holds targets 2 tig, 2 tig + 1 and b1 targets 2 tig + 8,
    2 tig + 9 of the group at B column gid. The first product's column 2c
    is channel c's hi and 2c + 1 its mid; the second's column 2c its lo,
    2c + 1 zero (channels x, y, z, 1)."""
    n = xs.shape[0]
    n_j, gps = -(-n // tile_n), -(-tile_n // 16)
    q = moment_pieces(xs, inv_den)                       # (n, 3, 4)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, n_j * tile_n - n))
    q = torch.nn.functional.pad(q.view(n_j, tile_n, 3, 4),
                                (0, 0, 0, 0, 0, 16 * gps - tile_n))
    hi, mid, lo = q.unbind(2)                            # (n_j, T, 4) each
    first = torch.stack([hi, mid], -1).flatten(-2)       # column 2c + piece
    second = torch.stack([lo, torch.zeros_like(lo)], -1).flatten(-2)
    b = torch.stack([first, second], -2)                 # (n_j, T, 2, 8)
    # target 16 G + 8 half + 2 tig + e, product, column gid ->
    # [G, gid, tig, product, half, e]
    b = b.view(n_j, gps, 2, 4, 2, 2, 8).permute(0, 1, 6, 3, 5, 2, 4)
    return b.reshape(n_j * gps, 32, 8).contiguous()


def pack_bf16_check(g: torch.Tensor):
    """Tests only: the bf16 bits that the bf16-stash pass B packs for each
    value of the f32 CUDA tensor ``g`` (even length; csrc/estep.cu
    pack_bf16, pairwise), beside __float2bfloat16_rn's of the same values,
    formed by one kernel: (packed, rounded), two bf16 tensors of g's
    length."""
    if not g.is_cuda or g.dtype != torch.float32 or g.numel() % 2:
        raise ValueError("expected an f32 CUDA tensor of even length")
    g = g.reshape(-1).contiguous()
    packed = torch.empty(g.numel() // 2, dtype=torch.int32, device=g.device)
    rounded = torch.empty(g.numel(), dtype=torch.bfloat16, device=g.device)
    _check(_lib().probreg_pack_bf16_check(
        g.data_ptr(), g.numel() // 2, packed.data_ptr(), rounded.data_ptr(),
        _stream(g)), "pack_bf16_check")
    return packed.view(torch.bfloat16), rounded


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "probreg_estep_small": [_P, _I, _P, _I, _I, _P, _F, _F, _F, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P, _P],
    "probreg_estep_small_capacity": [_I, _P],
    "probreg_empty_launch": [_I, _P],
    "probreg_stash_den": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P],
    "probreg_stash_rows": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                           _P, _P],
    "probreg_stash_den_raw": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                              _P, _P],
    "probreg_stash_finish": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "probreg_stash_merged": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P],
    "probreg_fused_den": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P],
    "probreg_fused_moment": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P],
    "probreg_stash_den_gated": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P, _P, _P],
    "probreg_stash_rows_gated": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                 _P, _P, _P, _P],
    "probreg_stash_den_fast": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P],
    "probreg_stash_rows_fast": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P, _P, _P],
    "probreg_stash_rows_bf16": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P, _P, _P],
    "probreg_stash_merged_bf16": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P,
                                  _P, _P, _P, _P, _P, _P],
    "probreg_stash_den_dump": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                               _P, _P, _P, _P, _P],
    "probreg_pack_bf16_check": [_P, _I, _P, _P, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("estep")
    if not getattr(lib, "_probreg_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def _check(status: int, kernel: str) -> None:
    if status != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{status}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _check_points(t_source: torch.Tensor, target: torch.Tensor):
    if t_source.dim() != 2 or target.dim() != 2 \
            or t_source.shape[1] != target.shape[1]:
        raise ValueError("expected (M, D) and (N, D) point tensors, got "
                         f"{tuple(t_source.shape)} and {tuple(target.shape)}")
    if not 1 <= t_source.shape[1] <= 3:
        raise ValueError(f"the E-step kernels take D <= 3, got "
                         f"D = {t_source.shape[1]}")
    if t_source.shape[0] == 0 or target.shape[0] == 0:
        raise ValueError("empty point cloud")
    if t_source.device != target.device:
        raise ValueError(f"source on {t_source.device}, target on "
                         f"{target.device}")
    if t_source.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError("the E-step kernels take float32 points")
    return t_source.contiguous(), target.contiguous()


def _scalars(sigma2, w, m, n, dim, device) -> torch.Tensor:
    """[0.5 / sigma2, outlier c] as a device f32 tensor (no host sync)."""
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=device)
    c = outlier_constant(sigma2, w, m, n, dim)
    return torch.stack([0.5 / sigma2, torch.as_tensor(c, dtype=torch.float32,
                                                      device=device)])


def _pack(points: torch.Tensor) -> torch.Tensor:
    """(M, D <= 3) -> (M, 4) f32: coordinates zero-padded to 3, then |p|^2."""
    m, dim = points.shape
    out = points.new_zeros((m, 4))
    out[:, :dim] = points
    out[:, 3] = (points * points).sum(1)
    return out


# --------------------------------------------------------------------------
# Tile culling
# --------------------------------------------------------------------------

def _tile_bounds(points: torch.Tensor, tile: int):
    """Per-tile axis-aligned boxes, (n_tiles, D) mins and maxes.

    Rows past the cloud (the ragged last tile) are excluded through +/-inf
    sentinels, so padding never widens a box.
    """
    m, dim = points.shape
    nb = -(-m // tile)
    pad = points.new_full((nb * tile - m, dim), math.inf)
    bmin = torch.cat([points, pad]).view(nb, tile, dim).amin(1)
    bmax = torch.cat([points, -pad]).view(nb, tile, dim).amax(1)
    return bmin, bmax


def _box_gap_lb2(ymin, ymax, xmin, xmax) -> torch.Tensor:
    """(nb_m, nb_n) lower bound on any pair's squared distance between two
    tiles: sum_d max(0, gap_d)^2 with gap_d the boxes' separation on axis d."""
    lb2 = ymin.new_zeros((ymin.shape[0], xmin.shape[0]))
    for d in range(ymin.shape[1]):
        gap = torch.clamp(torch.maximum(ymin[:, d, None] - xmax[None, :, d],
                                        xmin[None, :, d] - ymax[:, d, None]),
                          min=0.0)
        lb2 = lb2 + gap * gap
    return lb2


def _active_mask(ymin, ymax, xmin, xmax, inv2s2) -> torch.Tensor:
    """(nb_m, nb_n) bool: True where the tile pair may contribute, False
    where every exp(-d2 * inv2s2) in it underflows to exactly 0."""
    return _box_gap_lb2(ymin, ymax, xmin, xmax) * inv2s2 <= _CUT


def active_tile_fraction(t_source, target, sigma2, tile_m=None, tile_n=None):
    """Fraction of tile pairs the stash E-step computes (1.0: dense), for
    clouds already in Morton order. A diagnostic; returns a 0-d tensor."""
    tile_m = tile_m or config.tile_m
    tile_n = tile_n or config.tile_n
    inv2s2 = 0.5 / torch.as_tensor(sigma2, dtype=torch.float32,
                                   device=t_source.device)
    ymin, ymax = _tile_bounds(t_source, tile_m)
    xmin, xmax = _tile_bounds(target, tile_n)
    return _active_mask(ymin, ymax, xmin, xmax, inv2s2).float().mean()


def _compact(mask: torch.Tensor):
    """Per-stripe active-tile lists, built on the device.

    Returns act_idx (n_j, n_i) int32, whose row j lists stripe j's active
    source tiles in ascending order first, and act_cnt (n_j,) int32. This
    replaces the reference's scalar-prefetch ``eff`` arrays, which exist
    for TPU DMA elision: a block here loads its own tile index.
    """
    mask_t = mask.T
    order = torch.argsort((~mask_t).to(torch.int8), dim=1, stable=True)
    return (order.to(torch.int32).contiguous(),
            mask_t.sum(1).to(torch.int32).contiguous())


def stash_budget(device) -> int:
    """Bytes allowed for the reference's stash (config.stash_max_bytes, else
    an eighth of the card's memory, or 1 GiB on the CPU). The reference's
    pipelined E-step keeps two stash buffers, so estep_auto gives each half
    of it. No route of this package keeps a stash: the budget only picks
    the tiles and the fallback, as it does in the reference."""
    if config.stash_max_bytes:
        return int(config.stash_max_bytes)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 8
    return 1 << 30


def _capped_tile_n(m: int, tile_m: int, tile_n: int, budget: int,
                   on_overflow: str = "raise",
                   knob: str = "config.stash_max_bytes", itemsize: int = 4):
    """Halve tile_n (multiples of 128, floor 256) until the (M_padded,
    tile_n) stash of ``itemsize``-byte entries fits the budget (reference
    ``_capped_stash_tile_n``). Beyond the floor, ``on_overflow="raise"``
    raises, naming ``knob``, and ``"fallback"`` returns None, so that the
    caller can take a path without a stash."""
    mp = _round_up(m, tile_m)
    while tile_n > 256 and mp * tile_n * itemsize > budget:
        tile_n = max(256, (tile_n // 2 // 128) * 128)
    if mp * tile_n * itemsize > budget:
        if on_overflow == "fallback":
            return None
        raise ValueError(
            f"the E-step stash needs {mp * tile_n * itemsize / 2**30:.2f} "
            f"GiB even at tile_n={tile_n} (M_padded={mp}), over the "
            f"{budget / 2**30:.2f} GiB cap; raise {knob}")
    return tile_n


# --------------------------------------------------------------------------
# K2: estep_small
# --------------------------------------------------------------------------

def estep_small(t_source: torch.Tensor, target: torch.Tensor, sigma2,
                w: float = 0.0) -> EstepMoments:
    """Whole E-step (M * N <= 2^20 pairs, D <= 3): one launch of K2 for
    CUDA tensors, the plain version for CPU tensors."""
    t_source, target = _check_points(t_source, target)
    if t_source.is_cuda:
        launch, out = small_launcher(t_source, target, sigma2, w)
        launch()
        return out
    (m, dim), n = t_source.shape, target.shape[0]
    scal = _scalars(sigma2, w, m, n, dim, t_source.device)
    pt1, p1, px, xx = estep_small_plain(t_source, target, scal)
    return EstepMoments(pt1, p1, px, p1.sum(), xx)


class SmallPlan(NamedTuple):
    """K2's tiles: ``rows`` sources x ``cols`` targets, ``nr`` row chunks x
    ``nc`` column groups."""

    rows: int
    cols: int
    nr: int
    nc: int

    @property
    def tiles(self) -> int:
        return self.nr * self.nc

    def scratch(self, m: int, n: int):
        """(f32 work, int32 counters) that one launch needs: row partials
        (4 nc m), column partials (nr n), xx per group (nc), n_p per chunk
        (nr); counters 1 + nc + nr."""
        nr, nc = self.nr, self.nc
        return 4 * nc * m + nr * n + nc + nr, 1 + nc + nr


@functools.lru_cache(maxsize=1024)
def small_plan(m: int, n: int) -> SmallPlan:
    """K2's tiles for an (M, N) E-step. A tile holds 4,096 pairs (16 a
    thread of 256 in each phase), R x C with both powers of two from 16 to
    256 and C / R near sqrt(N / M): then a column's finalisation (nr / K
    partials a thread, K = 256 / C) and a row's (nc / Q, Q = 256 / R) take
    about as many loads, and the tiles about M N / 4,096. 1000^2 -> 64 x 64
    (256 tiles, 4 partials a thread each way), 32,768 x 32 -> 256 x 16 and
    32 x 32,768 -> 16 x 256 (256 tiles, 8 and 2). The sums' association
    follows the tiles, so it is set by the shape."""
    log_rows = math.floor(6.5 + 0.5 * math.log2(m / n))
    rows = 1 << min(max(log_rows, 4), 8)
    cols = _SMALL_TILE // rows
    return SmallPlan(rows, cols, -(-m // rows), -(-n // cols))


_small_scratch = {}


def small_scratch(device, stream: int, work: int, tickets: int):
    """K2's scratch on ``device`` for launches on ``stream``: f32 work of at
    least ``work`` and zeroed int32 tickets of at least ``tickets``, kept
    and grown only when a launch needs more. The kernel writes every work
    entry it reads and leaves the tickets at zero, so neither is cleared
    again; growing the tickets is a fill, the only launch besides K2's."""
    key = (str(device), stream)
    w_buf, t_buf = _small_scratch.get(key, (None, None))
    if w_buf is None or w_buf.numel() < work:
        w_buf = torch.empty(work, dtype=torch.float32, device=device)
    if t_buf is None or t_buf.numel() < tickets:
        t_buf = torch.zeros(tickets, dtype=torch.int32, device=device)
    _small_scratch[key] = (w_buf, t_buf)
    return w_buf, t_buf


_small_capacity = {}


def small_capacity(dim: int, device) -> int:
    """Blocks of K2's cooperative kernel that fit on ``device`` at once."""
    key = (str(device), dim)
    if key not in _small_capacity:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _check(_lib().probreg_estep_small_capacity(dim,
                                                       ctypes.byref(out)),
                   "estep_small capacity")
        _small_capacity[key] = out.value
    return _small_capacity[key]


def _sigma2_arg(sigma2, device):
    """sigma2 for K2: (a device f32 scalar to keep alive, or None; the host
    value used when there is none). A tensor on the clouds' card is read
    there (no host sync); anything else is read on the host."""
    if isinstance(sigma2, torch.Tensor) and sigma2.device == device:
        if sigma2.dim() or sigma2.dtype != torch.float32:
            sigma2 = sigma2.reshape(()).to(torch.float32)
        return sigma2, 0.0
    return None, float(sigma2)


def small_launcher(t_source, target, sigma2, w: float = 0.0, *,
                   _blocks=None):
    """(launch, moments) of one K2 E-step on contiguous CUDA f32 clouds:
    the outputs and scratch are set up here and each ``launch()`` fills
    them again. ``_blocks`` forces the grid, which changes no bit."""
    (m, dim), n = t_source.shape, target.shape[0]
    dev = t_source.device
    plan = small_plan(m, n)
    blocks = _blocks or min(plan.tiles, small_capacity(dim, dev))
    stream = _stream(t_source)
    work, tickets = small_scratch(dev, stream, *plan.scratch(m, n))
    dev_s, host_s = _sigma2_arg(sigma2, dev)
    out = t_source.new_empty(n + m * (1 + dim) + 2)  # one allocation
    pt1, p1, stats = out[:n], out[n:n + m], out[-2:]
    px = out[n + m:n + m * (1 + dim)].view(m, dim)
    args = (t_source.data_ptr(), m, target.data_ptr(), n, dim,
            None if dev_s is None else dev_s.data_ptr(), host_s, float(w),
            1.0 - float(w), plan.rows, plan.cols, blocks, work.data_ptr(),
            tickets.data_ptr(), pt1.data_ptr(), p1.data_ptr(), px.data_ptr(),
            stats.data_ptr(), stream)
    lib = _lib()

    def launch():
        _check(lib.probreg_estep_small(*args), "estep_small")
        LAUNCHES["estep_small"] += 1

    # Every tensor the kernel reads or writes lives as long as launch does.
    launch.tensors = (t_source, target, dev_s, out, work, tickets)
    return launch, EstepMoments(pt1, p1, px, stats[0], stats[1])


def empty_launcher(device, cooperative: bool = False):
    """``launch()`` of a kernel that does nothing, its arguments set up
    here as small_launcher sets up K2's: K2's floor through the same
    path."""
    args = (int(cooperative), torch.cuda.current_stream(device).cuda_stream)
    lib = _lib()

    def launch():
        _check(lib.probreg_empty_launch(*args), "empty")

    return launch


def estep_small_plain(t_source, target, scal):
    """Plain version of the K2 kernel: the dense (M, N) posterior, with the
    reference kernel's divisions by den."""
    inv2s2, c = scal[0], scal[1]
    y2 = (t_source * t_source).sum(1)
    x2 = (target * target).sum(1)
    d2 = torch.clamp(y2[:, None] + x2[None, :] - 2.0 * (t_source @ target.T),
                     min=0.0)
    g = torch.exp(-d2 * inv2s2)
    den_raw = g.sum(0)
    den = torch.where(den_raw == 0.0, _EPS, den_raw) + c
    pt1 = den_raw / den
    pmat = g / den
    return pt1, pmat.sum(1), pmat @ target, (pt1 * x2).sum()


# --------------------------------------------------------------------------
# K3: the stash E-step
# --------------------------------------------------------------------------

def estep_auto(t_source: torch.Tensor, target: torch.Tensor, sigma2,
               w: float = 0.0, tile_m: int = None, tile_n: int = None,
               assume_sorted: bool = False,
               fast_start: bool = None) -> EstepMoments:
    """Tile-culled E-step through K3 (two launches, no stash).

    ``assume_sorted``: the caller guarantees both clouds are in Morton
    order (cpd.registration sorts once); the moments then come back in that
    order. Otherwise the clouds are sorted here and the moments returned in
    the input order.

    ``config.use_merged_stash`` picks K12, the pipelined kernel's
    association (two launches, no stash), with the reference's tiles for
    two stash buffers, each within half the budget. Where even tile_n = 256
    would exceed the budget, the streaming plain E-step answers instead
    (reference estep_pallas.py:1466-1479): a branch by size, which both
    packages take at the same sizes. Neither route keeps a stash, but both
    take the reference's tiles and branch, so that their bits match the
    stash kernels' and their dispatch the reference's.

    ``fast_start`` (default ``config.estep_fast_start``): the reference's
    start-temperature gate (estep_pallas.py:1462-1541). It applies only off
    the merged route, with an f32 ``config.stash_dtype`` and where the
    tiles under two thirds of the budget equal the full budget's (the
    reference's two resident stashes); then ``fast_gate`` decides on the
    device between K3's exact passes and its fast passes.
    """
    t_source, target = _check_points(t_source, target)
    (m, dim), n = t_source.shape, target.shape[0]
    merged = bool(config.use_merged_stash)
    round_g = config.stash_dtype == torch.bfloat16
    if fast_start is None:
        fast_start = bool(config.estep_fast_start)
    fast_start = fast_start and not merged and not round_g
    itemsize = 2 if round_g else 4
    budget = stash_budget(t_source.device)
    budget = budget // 2 if merged else budget
    tile_m = min(tile_m or config.tile_m, _round_up(m, 8))
    tile_n = min(tile_n or config.tile_n, _round_up(n, 128))
    capped = _capped_tile_n(m, tile_m, tile_n, budget,
                            on_overflow="fallback", itemsize=itemsize)
    if capped is None:
        return estep_xla(t_source, target, sigma2, w)
    if fast_start:
        gated = _capped_tile_n(m, tile_m, tile_n, budget * 2 // 3,
                               on_overflow="fallback", itemsize=itemsize)
        fast_start = gated is not None and gated >= capped
    tile_n = capped
    if assume_sorted:
        ys, xs = t_source, target
    else:
        perm_y, perm_x = morton_order(t_source), morton_order(target)
        ys, xs = t_source[perm_y], target[perm_x]
    scal = _scalars(sigma2, w, m, n, dim, t_source.device)
    ymin, ymax = _tile_bounds(ys, tile_m)
    xmin, xmax = _tile_bounds(xs, tile_n)
    mask = _active_mask(ymin, ymax, xmin, xmax, scal[0])
    # Positional arguments throughout: callers may put the plain versions,
    # which take the same ones, in the kernels' place.
    if merged:
        pt1, p1, px, xx = stash_merged_estep(ys, xs, scal, mask, tile_m,
                                             tile_n, round_g)
    else:
        gate = None
        if fast_start:
            gate = fast_gate((ys * ys).sum(1), (xs * xs).sum(1), scal[0])
            tally_fast(FAST_STEPS, gate)
        pt1, p1, px, xx = stash_estep(ys, xs, scal, mask, tile_m, tile_n,
                                      None, gate, round_g)
    if not assume_sorted:
        pt1 = torch.empty_like(pt1).index_copy_(0, perm_x, pt1)
        p1 = torch.empty_like(p1).index_copy_(0, perm_y, p1)
        px = torch.empty_like(px).index_copy_(0, perm_y, px)
    return EstepMoments(pt1, p1, px, p1.sum(), xx)


def stash_estep(ys, xs, scal, mask, tile_m: int, tile_n: int,
                reduce_den=None, gate=None, round_g: bool = False):
    """(pt1, p1, px, xx) of the tile-culled E-step on sorted clouds, given
    the (n_i, n_j) active-tile mask: the kernels for CUDA tensors (K3, one
    launch per pass), the plain version for CPU tensors.

    ``reduce_den``: ys is one source shard of a 2-D mesh (reference
    ``fused_stash_core_spmd``). The raw column sums of every stripe, one
    (n,) tensor, go to ``reduce_den`` once, which all-reduces them in place
    over the source shards before they are finalized: ``stash_den_raw``
    (K11), ``stash_finish`` and K3's pass B, three launches. pt1 and xx are
    the target shard's, the same on every source shard; p1 and px the
    source shard's sums over these columns. ys may be empty (a source shard
    past the end of the cloud): it adds nothing and still takes part in the
    reduction.

    ``gate``: fast_gate's 0-d int32 flag (single card only). Where it is 1
    the E-step takes the fast branch (``stash_den_fast``,
    ``stash_moment_fast``); on CUDA tensors both branches' passes are
    launched and each runs only where the flag picks it. ``round_g``: pass
    B rounds each Gaussian to bf16 (``config.stash_dtype``; the fast
    branch always does).
    """
    if not ys.is_cuda:
        return stash_estep_plain(ys, xs, scal, mask, tile_m, tile_n,
                                 reduce_den, gate, round_g)
    if reduce_den is None:
        return StashPlan(ys, xs, scal, mask, tile_m, tile_n, gate=gate,
                         round_g=round_g).run()
    return ShardStashPlan(ys, xs, scal, mask, tile_m, tile_n,
                          reduce_den).run()


class TwoPassPlan:
    """Device buffers of one E-step whose passes are one launch each, and
    its launches: ``den()`` (pass A over every stripe: inv_den, pt1 and the
    xx partials) must precede ``moment()`` (pass B over every source tile:
    p1 and px). Nothing per pair is kept. K3 (``StashPlan``), K4
    (``FusedPlan``) and K12 (``MergedStashPlan``) take the same arguments;
    ``DEN`` and ``MOMENT`` name each pass's C entry and its LAUNCHES
    key; ``round_g`` (K3 and K12) takes pass B from ``MOMENT_BF16``."""

    DEN = MOMENT = MOMENT_BF16 = None

    def __init__(self, ys, xs, scal, mask, tile_m: int, tile_n: int,
                 round_g: bool = False):
        (m, self.dim), n = ys.shape, xs.shape[0]
        self.n_i, self.n_j = mask.shape
        if max(self.n_i, self.n_j) > _MAX_GRID_Y:
            raise ValueError(f"{self.n_i} x {self.n_j} tiles exceed the "
                             "two-pass kernels' launch limits")
        if self.n_i != -(-m // tile_m) or self.n_j != -(-n // tile_n):
            raise ValueError("mask shape does not match the tiles")
        self.m, self.n, self.tile_m, self.tile_n = m, n, tile_m, tile_n
        self.ys, self.xs = _pack(ys), _pack(xs)
        self.scal = scal.to(torch.float32).contiguous()
        self.col_idx, self.col_cnt = _compact(mask)      # per stripe
        self.row_idx, self.row_cnt = _compact(mask.T)    # per source tile
        new = self.ys.new_empty
        self.inv_den, self.pt1 = new(n), new(n)
        self.xx_part = new((self.n_j, -(-tile_n // _DEN_THREADS)))
        self.p1px = new((m, 4))
        self.lib = _lib()
        self.stream = _stream(self.ys)
        self.round_g = round_g

    def _launch(self, kernel, idx, cnt, *out) -> None:
        entry, key = kernel
        status = getattr(self.lib, entry)(
            self.ys.data_ptr(), self.m, self.tile_m, self.n_i,
            self.xs.data_ptr(), self.n, self.tile_n, self.n_j,
            idx.data_ptr(), cnt.data_ptr(), self.scal.data_ptr(),
            *(None if t is None else t.data_ptr() for t in out), self.stream)
        _check(status, key)
        LAUNCHES[key] += 1

    def den(self) -> None:
        self._launch(self.DEN, self.col_idx, self.col_cnt, self.inv_den,
                     self.pt1, self.xx_part)

    def moment(self) -> None:
        if self.round_g:
            return self.moment_bf16()
        self._launch(self.MOMENT, self.row_idx, self.row_cnt, self.inv_den,
                     self.p1px)

    def moment_bf16(self, g_dump=None) -> None:
        """Pass B reading a bf16 stash, after pass A: moment_operand from
        inv_den (elementwise, on the device), then the kernel, whose moments
        run on the tensor cores (K3's and K12's alike), on the source tiles
        heaviest first (by active stripe count; the bits do not depend on
        the order). ``g_dump`` (tests only): an (m, n) f32 buffer that
        takes every Gaussian the pass forms, before its rounding."""
        mop = moment_operand(self.xs, self.inv_den, self.tile_n)
        order = torch.argsort(self.row_cnt, descending=True,
                              stable=True).to(torch.int32)
        self._launch(self.MOMENT_BF16, self.row_idx, self.row_cnt, order,
                     mop, self.p1px, g_dump)

    def result(self):
        return (self.pt1, self.p1px[:, 3], self.p1px[:, :self.dim],
                self.xx_part.sum())

    def run(self):
        """Both launches; (pt1, p1, px, xx)."""
        self.den()
        self.moment()
        return self.result()


class StashPlan(TwoPassPlan):
    """K3: pass A sums each active tile's rows apart and adds the tiles'
    sums in tile order (the stash kernels' order), pass B sums each row's
    stripes apart and adds them in stripe order: the association of the
    reference's stash kernels, whose stash it does without.

    ``gate`` (fast_gate's flag): each pass launches K3's exact kernel,
    which returns at once where the flag is 1, and the fast kernel
    (``stash_den_fast``, ``stash_moment_fast``), which returns at once
    where it is 0. ``round_g``: pass B reads each Gaussian rounded to
    bf16 (``stash_moment_bf16``)."""

    DEN = ("probreg_stash_den", "stash_den")
    MOMENT = ("probreg_stash_rows", "stash_moment")
    DEN_GATED = ("probreg_stash_den_gated", "stash_den")
    MOMENT_GATED = ("probreg_stash_rows_gated", "stash_moment")
    DEN_FAST = ("probreg_stash_den_fast", "stash_den_fast")
    MOMENT_FAST = ("probreg_stash_rows_fast", "stash_moment_fast")
    MOMENT_BF16 = ("probreg_stash_rows_bf16", "stash_moment_bf16")

    def __init__(self, ys, xs, scal, mask, tile_m: int, tile_n: int,
                 gate=None, round_g: bool = False):
        super().__init__(ys, xs, scal, mask, tile_m, tile_n, round_g)
        if gate is not None and round_g:
            raise ValueError("a gated E-step takes an f32 stash (the "
                             "reference's gate is off under a bf16 one)")
        self.gate = None if gate is None else \
            gate.to(torch.int32).reshape(1).contiguous()

    def den(self) -> None:
        if self.gate is None:
            return super().den()
        self._launch(self.DEN_GATED, self.col_idx, self.col_cnt, self.gate,
                     self.inv_den, self.pt1, self.xx_part)
        self.den_fast()

    def moment(self) -> None:
        if self.gate is None:
            return super().moment()
        self._launch(self.MOMENT_GATED, self.row_idx, self.row_cnt,
                     self.gate, self.inv_den, self.p1px)
        self.moment_fast()

    def den_dump(self, g_dump) -> None:
        """Tests only: the exact pass A (``stash_den``'s kernel) with
        every Gaussian it forms also written to ``g_dump`` (m, n) f32."""
        self._launch(("probreg_stash_den_dump", "stash_den"), self.col_idx,
                     self.col_cnt, self.inv_den, self.pt1, self.xx_part,
                     g_dump)

    def den_fast(self, g_dump=None) -> None:
        """The fast pass A alone (it runs where the gate is 1).
        ``g_dump`` (tests only): an (m, n) f32 buffer that takes every
        Gaussian the pass forms."""
        self._launch(self.DEN_FAST, self.col_idx, self.col_cnt, self.gate,
                     self.inv_den, self.pt1, self.xx_part, g_dump)

    def moment_fast(self, g_dump=None) -> None:
        """The fast pass B alone, after pass A: moment_operand from inv_den
        (elementwise, on the device), then the kernel; ``g_dump`` as in
        den_fast (each g before its rounding)."""
        mop = moment_operand(self.xs, self.inv_den, self.tile_n)
        self._launch(self.MOMENT_FAST, self.row_idx, self.row_cnt, self.gate,
                     mop, self.p1px, g_dump)


class ShardStashPlan(StashPlan):
    """K11's route on one source shard of a 2-D mesh: pass A of K3 cut in
    two around the caller's reduction. ``den_raw()`` writes the raw column
    sums of every stripe into ``den_raw_buf`` (n,), ``reduce_den`` sums
    them over the source shards in place, ``finish()`` forms inv_den, pt1
    and the xx partials from them; pass B is K3's. Nothing per pair is
    kept. An empty source (n_i = 0) launches neither pass: its raw sums are
    0 and it has no rows."""

    def __init__(self, ys, xs, scal, mask, tile_m: int, tile_n: int,
                 reduce_den):
        super().__init__(ys, xs, scal, mask, tile_m, tile_n)
        self.reduce_den = reduce_den
        self.den_raw_buf = self.ys.new_empty(self.n)

    def den_raw(self) -> None:
        """K11: the raw column sums into den_raw_buf, unfinalized."""
        if self.n_i == 0:
            self.den_raw_buf.zero_()
            return
        self._launch(("probreg_stash_den_raw", "stash_den_raw"),
                     self.col_idx, self.col_cnt, self.den_raw_buf)

    def finish(self) -> None:
        """inv_den, pt1 and the xx partials from den_raw_buf, in K3's
        pass-A chunk layout."""
        status = self.lib.probreg_stash_finish(
            self.xs.data_ptr(), self.n, self.tile_n, self.n_j,
            self.scal.data_ptr(), self.den_raw_buf.data_ptr(),
            self.inv_den.data_ptr(), self.pt1.data_ptr(),
            self.xx_part.data_ptr(), self.stream)
        _check(status, "stash_finish")
        LAUNCHES["stash_finish"] += 1

    def den(self) -> None:
        self.den_raw()
        self.reduce_den(self.den_raw_buf)
        self.finish()

    def moment(self) -> None:
        if self.n_i:
            super().moment()


class MergedStashPlan(TwoPassPlan):
    """K12: K3's pass A, then pass B with the normalizer folded into the
    channels (p1 += g * inv_den, px += g * (x * inv_den)) for every stripe
    but the last, which keeps K3's p = g * inv_den, as the reference's
    pipelined kernel and its epilogue associate them. ``round_g``: pass B
    reads each Gaussian rounded to bf16 (``stash_merged_bf16``): K3's
    bf16 pass B, since sum_n bf16(g) inv_den (x, 1) is one product either
    way on the tensor cores, so both routes give the same bits."""

    DEN = StashPlan.DEN
    MOMENT = ("probreg_stash_merged", "stash_merged")
    MOMENT_BF16 = ("probreg_stash_merged_bf16", "stash_merged_bf16")


def stash_merged_estep(ys, xs, scal, mask, tile_m: int, tile_n: int,
                       round_g: bool = False):
    """(pt1, p1, px, xx) of the pipelined stash E-step's function on sorted
    clouds: K12's two launches for CUDA tensors, the plain version for CPU
    tensors. ``round_g`` as in stash_estep."""
    if ys.is_cuda:
        return MergedStashPlan(ys, xs, scal, mask, tile_m, tile_n,
                               round_g).run()
    return stash_merged_estep_plain(ys, xs, scal, mask, tile_m, tile_n,
                                    round_g)


def stash_den_raw_plain(ys, y2, x, x2, scal, act_rows, n_i, tile_m,
                        fast: bool = False):
    """Plain version of K11 on one stripe: g (zero in culled tiles) and the
    stripe's raw column sums, per-tile sums added in tile order. ``fast``:
    the cross term from the bf16-rounded coordinates, summed in f32 (the
    fast branch's pass A; y2 and x2 stay those of the f32 points)."""
    cross = _bf16(ys) @ _bf16(x).T if fast else ys @ x.T
    d2 = torch.clamp(y2[:, None] + x2[None, :] - 2.0 * cross, min=0.0)
    g = torch.where(act_rows[:, None], torch.exp(-d2 * scal[0]), 0.0)
    pad = n_i * tile_m - ys.shape[0]
    part = torch.nn.functional.pad(g, (0, 0, 0, pad)).view(
        n_i, tile_m, x.shape[0]).sum(1)
    return g, part.sum(0)


def _plain_finish(den_raw, x2, scal):
    """Pass A's finalisation of one stripe from its raw column sums:
    inv_den, pt1, xx."""
    inv_den = 1.0 / (torch.where(den_raw == 0.0, _EPS, den_raw) + scal[1])
    pt1 = den_raw * inv_den
    return inv_den, pt1, (pt1 * x2).sum()


def _plain_pass_a(ys, y2, x, x2, scal, act_rows, n_i, tile_m,
                  fast: bool = False):
    """Pass A of one stripe: g (zero in culled tiles), inv_den, pt1, xx."""
    g, den_raw = stash_den_raw_plain(ys, y2, x, x2, scal, act_rows, n_i,
                                     tile_m, fast)
    return (g, *_plain_finish(den_raw, x2, scal))


def _plain_pass_b(g, inv_den, x, round_g: bool = False):
    """Pass B of one stripe: the stripe's p1 and px contributions.
    ``round_g``: g read as a bf16 stash holds it."""
    p = (_bf16(g) if round_g else g) * inv_den[None, :]
    return p.sum(1), p @ x


def _plain_pass_b_folded(g, inv_den, x, round_g: bool = False):
    """Pass B of one stripe with the normalizer folded into the channels:
    p1 = g @ inv_den, px = g @ (x * inv_den) (the pipelined kernel's
    association)."""
    g = _bf16(g) if round_g else g
    return g @ inv_den, g @ (x * inv_den[:, None])


def _plain_stripes(ys, xs, scal, mask, tile_m: int, tile_n: int,
                   reduce_den=None, fast: bool = False):
    """Pass A of every stripe in order: (g, inv_den, pt1, xx, x) each. With
    ``reduce_den`` the raw sums of every stripe come first, as one (n,)
    tensor through one ``reduce_den`` call, and each stripe's g is formed
    again for its finalisation and pass B. ``fast``: the fast branch's
    cross term."""
    m, n_i, n_j = ys.shape[0], mask.shape[0], mask.shape[1]
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)

    def raw(j):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        act_rows = mask[:, j].repeat_interleave(tile_m)[:m]
        return stash_den_raw_plain(ys, y2, xs[cols], x2[cols], scal,
                                   act_rows, n_i, tile_m, fast)

    if reduce_den is not None:
        den_raw = torch.cat([raw(j)[1] for j in range(n_j)])
        reduce_den(den_raw)
        reduced = den_raw.split(tile_n)
    for j in range(n_j):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        g, den_j = raw(j)
        if reduce_den is not None:
            den_j = reduced[j]
        yield (g, *_plain_finish(den_j, x2[cols], scal), xs[cols])


def stash_estep_plain(ys, xs, scal, mask, tile_m: int, tile_n: int,
                      reduce_den=None, gate=None, round_g: bool = False):
    """Plain version of the stash kernels, stripe by stripe: per-tile
    column sums added in tile order, culled tiles contributing nothing;
    ``reduce_den`` as in stash_estep (the plain version of K11's route:
    every stripe's raw sums, one reduction, then the finalisation and pass
    B). ``gate`` (fast_gate's flag or a bool, read here): where it is set,
    the fast branch (the bf16 cross term in pass A, and pass B from g
    rounded to bf16); ``round_g``: pass B from g rounded to bf16 (a bf16
    stash). The same arguments as stash_estep."""
    fast = gate is not None and bool(gate)
    round_g = round_g or fast
    p1, px, xx = ys.new_zeros(ys.shape[0]), torch.zeros_like(ys), \
        ys.new_zeros(())
    pt1 = []
    for g, inv_den, pt1_j, xx_j, x in _plain_stripes(ys, xs, scal, mask,
                                                     tile_m, tile_n,
                                                     reduce_den, fast):
        p1_j, px_j = _plain_pass_b(g, inv_den, x, round_g)
        p1, px, xx = p1 + p1_j, px + px_j, xx + xx_j
        pt1.append(pt1_j)
    return torch.cat(pt1), p1, px, xx


def stash_merged_estep_plain(ys, xs, scal, mask, tile_m: int, tile_n: int,
                             round_g: bool = False):
    """Plain version of the pipelined kernel: pass A as in
    stash_estep_plain, pass B one stripe behind with the folded
    normalizer, and the last stripe's pass B in K3's association (the
    epilogue). Stripes add into p1 and px in stripe order. ``round_g``:
    pass B from g rounded to bf16."""
    p1, px, xx = ys.new_zeros(ys.shape[0]), torch.zeros_like(ys), \
        ys.new_zeros(())
    pt1, prev = [], None
    for g, inv_den, pt1_j, xx_j, x in _plain_stripes(ys, xs, scal, mask,
                                                     tile_m, tile_n):
        if prev is not None:
            p1_j, px_j = _plain_pass_b_folded(*prev, round_g)
            p1, px = p1 + p1_j, px + px_j
        xx = xx + xx_j
        pt1.append(pt1_j)
        prev = (g, inv_den, x)
    p1_j, px_j = _plain_pass_b(*prev, round_g)
    return torch.cat(pt1), p1 + p1_j, px + px_j, xx


# --------------------------------------------------------------------------
# K4: the two-pass E-step (no stash, the Gaussian computed in both passes)
# --------------------------------------------------------------------------

def estep_fused(t_source: torch.Tensor, target: torch.Tensor, sigma2,
                w: float = 0.0, tile_m: int = None, tile_n: int = None,
                cull: bool = True) -> EstepMoments:
    """Exact two-pass E-step on the clouds in the order given.

    ``cull=True`` skips tile pairs whose box-gap bound proves that every
    exp underflows to exactly 0. That only fires on spatially sorted
    clouds: use :func:`estep_culled` unless the caller sorted already.
    """
    t_source, target = _check_points(t_source, target)
    (m, dim), n = t_source.shape, target.shape[0]
    tile_m = min(tile_m or config.tile_m, _round_up(m, 8))
    tile_n = min(tile_n or config.tile_n, _round_up(n, 128))
    scal = _scalars(sigma2, w, m, n, dim, t_source.device)
    if cull:
        mask = _active_mask(*_tile_bounds(t_source, tile_m),
                            *_tile_bounds(target, tile_n), scal[0])
    else:
        mask = torch.ones((-(-m // tile_m), -(-n // tile_n)),
                          dtype=torch.bool, device=t_source.device)
    pt1, p1, px, xx = fused_core(t_source, target, scal, mask, tile_m, tile_n)
    return EstepMoments(pt1, p1, px, p1.sum(), xx)


def estep_culled(t_source: torch.Tensor, target: torch.Tensor, sigma2,
                 w: float = 0.0, tile_m: int = None,
                 tile_n: int = None) -> EstepMoments:
    """Morton-sorted two-pass E-step; moments in the input order."""
    perm_y, perm_x = morton_order(t_source), morton_order(target)
    mom = estep_fused(t_source[perm_y], target[perm_x], sigma2, w,
                      tile_m=tile_m, tile_n=tile_n, cull=True)
    return EstepMoments(
        torch.empty_like(mom.pt1).index_copy_(0, perm_x, mom.pt1),
        torch.empty_like(mom.p1).index_copy_(0, perm_y, mom.p1),
        torch.empty_like(mom.px).index_copy_(0, perm_y, mom.px),
        mom.n_p, mom.xx)


def fused_core(ys, xs, scal, mask, tile_m: int, tile_n: int):
    """(pt1, p1, px, xx) of the two-pass E-step given the (n_i, n_j)
    active-tile mask: two kernel launches for CUDA tensors, the plain
    version for CPU tensors."""
    if not ys.is_cuda:
        return fused_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
    return FusedPlan(ys, xs, scal, mask, tile_m, tile_n).run()


class FusedPlan(TwoPassPlan):
    """K4: one running sum per column over every active tile (pass A) and
    per row over every active stripe (pass B)."""

    DEN = ("probreg_fused_den", "fused_den")
    MOMENT = ("probreg_fused_moment", "fused_moment")


def fused_estep_plain(ys, xs, scal, mask, tile_m: int, tile_n: int):
    """Plain version of the two-pass kernels: pass A over every stripe
    keeps only inv_den, pt1 and xx; pass B computes each stripe's Gaussian
    again, culled tiles contributing nothing in either."""
    m, n_i = ys.shape[0], mask.shape[0]
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)

    def stripe(j):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        act_rows = mask[:, j].repeat_interleave(tile_m)[:m]
        return _plain_pass_a(ys, y2, xs[cols], x2[cols], scal, act_rows, n_i,
                             tile_m)

    inv_den, pt1 = [], []
    xx = ys.new_zeros(())
    for j in range(mask.shape[1]):
        _, inv_den_j, pt1_j, xx_j = stripe(j)
        inv_den.append(inv_den_j)
        pt1.append(pt1_j)
        xx = xx + xx_j
    p1, px = ys.new_zeros(m), torch.zeros_like(ys)
    for j in range(mask.shape[1]):
        p1_j, px_j = _plain_pass_b(stripe(j)[0], inv_den[j],
                                   xs[j * tile_n:(j + 1) * tile_n])
        p1, px = p1 + p1_j, px + px_j
    return torch.cat(pt1), p1, px, xx

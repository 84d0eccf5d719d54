"""CPD E-step kernels on the card, each beside its plain PyTorch version.

Counterpart of the kernels of probreg_tpu/ops/estep_pallas.py on the CPD
path, with their helpers:

* ``estep_small``: the whole E-step in one launch for M * N <= 2^20
  (replaces ``_small_kernel``).
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
so culling never changes a result. The reference's fast-start branch (bf16
cross term and stash under an error bound derived for the TPU) is not
ported: the port always runs the exact branch.

Each wrapper runs its CUDA kernel (``csrc/estep.cu``) on CUDA tensors and
its plain version on CPU tensors; nothing else picks between them. Every
kernel launch adds one to ``LAUNCHES[<kernel>]``.
"""

from __future__ import annotations

import ctypes
import math

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
_SMALL_COLS = 32     # columns per K2 block (kSmallCols)
_MAX_GRID_Y = 65535

LAUNCHES = {"estep_small": 0, "stash_den": 0, "stash_moment": 0,
            "stash_merged": 0, "stash_den_raw": 0, "stash_finish": 0,
            "fused_den": 0, "fused_moment": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probreg_estep_small": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
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
                   knob: str = "config.stash_max_bytes"):
    """Halve tile_n (multiples of 128, floor 256) until the (M_padded,
    tile_n) f32 stash fits the budget (reference
    ``_capped_stash_tile_n``). Beyond the floor, ``on_overflow="raise"``
    raises, naming ``knob``, and ``"fallback"`` returns None, so that the
    caller can take a path without a stash."""
    mp = _round_up(m, tile_m)
    while tile_n > 256 and mp * tile_n * 4 > budget:
        tile_n = max(256, (tile_n // 2 // 128) * 128)
    if mp * tile_n * 4 > budget:
        if on_overflow == "fallback":
            return None
        raise ValueError(
            f"the E-step stash needs {mp * tile_n * 4 / 2**30:.2f} GiB even "
            f"at tile_n={tile_n} (M_padded={mp}), over the "
            f"{budget / 2**30:.2f} GiB cap; raise {knob}")
    return tile_n


# --------------------------------------------------------------------------
# K2: estep_small
# --------------------------------------------------------------------------

def estep_small(t_source: torch.Tensor, target: torch.Tensor, sigma2,
                w: float = 0.0) -> EstepMoments:
    """Whole E-step in one launch (M * N <= 2^20 pairs)."""
    t_source, target = _check_points(t_source, target)
    (m, dim), n = t_source.shape, target.shape[0]
    scal = _scalars(sigma2, w, m, n, dim, t_source.device)
    if t_source.is_cuda:
        pt1, p1, px, xx = _estep_small_cuda(t_source, target, scal)
    else:
        pt1, p1, px, xx = estep_small_plain(t_source, target, scal)
    return EstepMoments(pt1, p1, px, p1.sum(), xx)


def _estep_small_cuda(t_source, target, scal):
    (m, dim), n = t_source.shape, target.shape[0]
    ys, xs = _pack(t_source), _pack(target)
    blocks = -(-n // _SMALL_COLS)
    pt1 = ys.new_empty(n)
    part = ys.new_empty((blocks, m, 4))
    xx_part = ys.new_empty(blocks)
    ticket = torch.zeros(1, dtype=torch.int32, device=ys.device)
    p1px = ys.new_empty((m, 4))
    xx = ys.new_empty(())
    status = _lib().probreg_estep_small(
        ys.data_ptr(), m, xs.data_ptr(), n, scal.data_ptr(), pt1.data_ptr(),
        part.data_ptr(), xx_part.data_ptr(), ticket.data_ptr(),
        p1px.data_ptr(), xx.data_ptr(), _stream(ys))
    _check(status, "estep_small")
    LAUNCHES["estep_small"] += 1
    return pt1, p1px[:, 3], p1px[:, :dim], xx


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
               assume_sorted: bool = False) -> EstepMoments:
    """Exact tile-culled E-step through K3 (two launches, no stash).

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
    """
    t_source, target = _check_points(t_source, target)
    (m, dim), n = t_source.shape, target.shape[0]
    merged = bool(config.use_merged_stash)
    budget = stash_budget(t_source.device)
    tile_m = min(tile_m or config.tile_m, _round_up(m, 8))
    tile_n = _capped_tile_n(m, tile_m,
                            min(tile_n or config.tile_n, _round_up(n, 128)),
                            budget // 2 if merged else budget,
                            on_overflow="fallback")
    if tile_n is None:
        return estep_xla(t_source, target, sigma2, w)
    if assume_sorted:
        ys, xs = t_source, target
    else:
        perm_y, perm_x = morton_order(t_source), morton_order(target)
        ys, xs = t_source[perm_y], target[perm_x]
    scal = _scalars(sigma2, w, m, n, dim, t_source.device)
    ymin, ymax = _tile_bounds(ys, tile_m)
    xmin, xmax = _tile_bounds(xs, tile_n)
    mask = _active_mask(ymin, ymax, xmin, xmax, scal[0])
    core = stash_merged_estep if merged else stash_estep
    pt1, p1, px, xx = core(ys, xs, scal, mask, tile_m, tile_n)
    if not assume_sorted:
        pt1 = torch.empty_like(pt1).index_copy_(0, perm_x, pt1)
        p1 = torch.empty_like(p1).index_copy_(0, perm_y, p1)
        px = torch.empty_like(px).index_copy_(0, perm_y, px)
    return EstepMoments(pt1, p1, px, p1.sum(), xx)


def stash_estep(ys, xs, scal, mask, tile_m: int, tile_n: int,
                reduce_den=None):
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
    """
    if not ys.is_cuda:
        return stash_estep_plain(ys, xs, scal, mask, tile_m, tile_n,
                                 reduce_den)
    if reduce_den is None:
        return StashPlan(ys, xs, scal, mask, tile_m, tile_n).run()
    return ShardStashPlan(ys, xs, scal, mask, tile_m, tile_n,
                          reduce_den).run()


class TwoPassPlan:
    """Device buffers of one E-step whose passes are one launch each, and
    its launches: ``den()`` (pass A over every stripe: inv_den, pt1 and the
    xx partials) must precede ``moment()`` (pass B over every source tile:
    p1 and px). Nothing per pair is kept. K3 (``StashPlan``), K4
    (``FusedPlan``) and K12 (``MergedStashPlan``) take the same arguments;
    ``DEN`` and ``MOMENT`` name each pass's C entry and its LAUNCHES
    key."""

    DEN = MOMENT = None

    def __init__(self, ys, xs, scal, mask, tile_m: int, tile_n: int):
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

    def _launch(self, kernel, idx, cnt, *out) -> None:
        entry, key = kernel
        status = getattr(self.lib, entry)(
            self.ys.data_ptr(), self.m, self.tile_m, self.n_i,
            self.xs.data_ptr(), self.n, self.tile_n, self.n_j,
            idx.data_ptr(), cnt.data_ptr(), self.scal.data_ptr(),
            *(t.data_ptr() for t in out), self.stream)
        _check(status, key)
        LAUNCHES[key] += 1

    def den(self) -> None:
        self._launch(self.DEN, self.col_idx, self.col_cnt, self.inv_den,
                     self.pt1, self.xx_part)

    def moment(self) -> None:
        self._launch(self.MOMENT, self.row_idx, self.row_cnt, self.inv_den,
                     self.p1px)

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
    reference's stash kernels, whose stash it does without."""

    DEN = ("probreg_stash_den", "stash_den")
    MOMENT = ("probreg_stash_rows", "stash_moment")


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
    pipelined kernel and its epilogue associate them."""

    DEN = StashPlan.DEN
    MOMENT = ("probreg_stash_merged", "stash_merged")


def stash_merged_estep(ys, xs, scal, mask, tile_m: int, tile_n: int):
    """(pt1, p1, px, xx) of the pipelined stash E-step's function on sorted
    clouds: K12's two launches for CUDA tensors, the plain version for CPU
    tensors."""
    if ys.is_cuda:
        return MergedStashPlan(ys, xs, scal, mask, tile_m, tile_n).run()
    return stash_merged_estep_plain(ys, xs, scal, mask, tile_m, tile_n)


def stash_den_raw_plain(ys, y2, x, x2, scal, act_rows, n_i, tile_m):
    """Plain version of K11 on one stripe: g (zero in culled tiles) and the
    stripe's raw column sums, per-tile sums added in tile order."""
    d2 = torch.clamp(y2[:, None] + x2[None, :] - 2.0 * (ys @ x.T), min=0.0)
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


def _plain_pass_a(ys, y2, x, x2, scal, act_rows, n_i, tile_m):
    """Pass A of one stripe: g (zero in culled tiles), inv_den, pt1, xx."""
    g, den_raw = stash_den_raw_plain(ys, y2, x, x2, scal, act_rows, n_i,
                                     tile_m)
    return (g, *_plain_finish(den_raw, x2, scal))


def _plain_pass_b(g, inv_den, x):
    """Pass B of one stripe: the stripe's p1 and px contributions."""
    p = g * inv_den[None, :]
    return p.sum(1), p @ x


def _plain_pass_b_folded(g, inv_den, x):
    """Pass B of one stripe with the normalizer folded into the channels:
    p1 = g @ inv_den, px = g @ (x * inv_den) (the pipelined kernel's
    association)."""
    return g @ inv_den, g @ (x * inv_den[:, None])


def _plain_stripes(ys, xs, scal, mask, tile_m: int, tile_n: int,
                   reduce_den=None):
    """Pass A of every stripe in order: (g, inv_den, pt1, xx, x) each. With
    ``reduce_den`` the raw sums of every stripe come first, as one (n,)
    tensor through one ``reduce_den`` call, and each stripe's g is formed
    again for its finalisation and pass B."""
    m, n_i, n_j = ys.shape[0], mask.shape[0], mask.shape[1]
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)

    def raw(j):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        act_rows = mask[:, j].repeat_interleave(tile_m)[:m]
        return stash_den_raw_plain(ys, y2, xs[cols], x2[cols], scal,
                                   act_rows, n_i, tile_m)

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
                      reduce_den=None):
    """Plain version of the stash kernels, stripe by stripe: per-tile
    column sums added in tile order, culled tiles contributing nothing;
    ``reduce_den`` as in stash_estep (the plain version of K11's route:
    every stripe's raw sums, one reduction, then the finalisation and pass
    B)."""
    p1, px, xx = ys.new_zeros(ys.shape[0]), torch.zeros_like(ys), \
        ys.new_zeros(())
    pt1 = []
    for g, inv_den, pt1_j, xx_j, x in _plain_stripes(ys, xs, scal, mask,
                                                     tile_m, tile_n,
                                                     reduce_den):
        p1_j, px_j = _plain_pass_b(g, inv_den, x)
        p1, px, xx = p1 + p1_j, px + px_j, xx + xx_j
        pt1.append(pt1_j)
    return torch.cat(pt1), p1, px, xx


def stash_merged_estep_plain(ys, xs, scal, mask, tile_m: int, tile_n: int):
    """Plain version of the pipelined kernel: pass A as in
    stash_estep_plain, pass B one stripe behind with the folded
    normalizer, and the last stripe's pass B in K3's association (the
    epilogue). Stripes add into p1 and px in stripe order."""
    p1, px, xx = ys.new_zeros(ys.shape[0]), torch.zeros_like(ys), \
        ys.new_zeros(())
    pt1, prev = [], None
    for g, inv_den, pt1_j, xx_j, x in _plain_stripes(ys, xs, scal, mask,
                                                     tile_m, tile_n):
        if prev is not None:
            p1_j, px_j = _plain_pass_b_folded(*prev)
            p1, px = p1 + p1_j, px + px_j
        xx = xx + xx_j
        pt1.append(pt1_j)
        prev = (g, inv_den, x)
    p1_j, px_j = _plain_pass_b(*prev)
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

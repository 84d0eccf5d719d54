"""Row-weighted tile-culled BCPD E-step on the card, beside its plain version.

Counterpart of ``bcpd_estep_culled`` in probreg_tpu/ops/estep_pallas.py
(``_wstash_den_kernel`` + ``_wstash_moment_kernel``). BCPD's posterior is
p_ij = exp(rowlog_i - d2_ij / 2s2) / den_j, den_j = w/N + sum_i exp(.)
(den == 0 -> eps), with rowlog folding the mixing weight, the Sigma
diagonal and the normalizer into the exponent (reference bcpd.py:53-72).
On Morton-sorted clouds, two launches per E-step and no stash:

* pass A (``wstash_den``) walks each target stripe's active source tiles
  and forms the column normalizer (per-256-row partial sums added in
  order) and nu_d = den_raw / den;
* pass B (``wstash_moment``) walks each source tile's active stripes and
  forms each pair's Gaussian again: the per-source moments of a channel
  matrix V (C <= 8, N), each source row's minimum d2 over active pairs and
  the residual-form sigma2 numerator e1 = sum p d2.

The TPU kernels stash each exp between the passes; on the card the
stash's bytes cost more than the exp. The tiles stay the reference's:
``bcpd_tile_n`` caps tile_n with ``config.bcpd_stash_max_bytes`` (the
reference's knob and default), on the CPU and on the card alike, so the
sums keep their order.

The cull mask uses the GLOBAL maximum rowlog clamped at -104: a tile pair
is culled when max rowlog - lb2 / 2s2 < -104, so every culled pair is
culled by distance and its box-gap bound lb2 is a real lower bound on its
d2; the wrapper folds the culled tiles' lb2 into each row's minimum
(reference estep_pallas.py:1093-1112, 1191-1196). A per-tile maximum could
cull an overlapping tile and collapse dmin.

Each wrapper runs its CUDA kernels (``csrc/wstash.cu``) on CUDA tensors and
the plain version on CPU tensors; nothing else picks between them. Every
kernel launch adds one to ``LAUNCHES[<kernel>]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..config import config
from .estep_cuda import (_CUT, _EPS, _box_gap_lb2, _capped_tile_n, _check,
                         _check_points, _compact, _pack, _round_up, _stream,
                         _tile_bounds)

_STAGE = 256        # source rows per pass-A partial (csrc/wstash.cu kStage)
_MAX_C = 8          # channels of V (kMaxC)
_MAX_TILE_N = 3072  # pass B keeps a stripe's columns in shared memory
_MAX_GRID_Y = 65535

LAUNCHES = {"wstash_den": 0, "wstash_moment": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probreg_wstash_den": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                           _P, _P, _P],
    "probreg_wstash_moment": [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                              _P, _P, _P, _P, _P, _P, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("wstash")
    if not getattr(lib, "_probreg_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._probreg_typed = True
    return lib


def bcpd_tile_n(m: int, n: int, tile_m: int = 1024,
                tile_n: int = 1024) -> int:
    """The E-step's tile_n for M sources and N targets, as the reference's
    ``bcpd_estep_culled`` picks it: clipped to N (a multiple of 128), then
    halved (floor 256) until the (M_padded, tile_n) f32 stash fits
    ``config.bcpd_stash_max_bytes``; beyond the floor it raises."""
    tile_m = min(tile_m, _round_up(m, 8))
    tile_n = min(tile_n, _round_up(n, 128))
    return _capped_tile_n(m, tile_m, tile_n, config.bcpd_stash_max_bytes,
                          knob="config.bcpd_stash_max_bytes")


def cull_mask(ys, xs, rowlog, inv2s2, tile_m: int, tile_n: int):
    """(mask (n_i, n_j) bool, lb2 (n_i, n_j)) on sorted clouds: a tile pair
    is active unless max(max rowlog, -104) - lb2 * inv2s2 < -104."""
    ymin, ymax = _tile_bounds(ys, tile_m)
    xmin, xmax = _tile_bounds(xs, tile_n)
    lb2 = _box_gap_lb2(ymin, ymax, xmin, xmax)
    rlmax = torch.clamp(rowlog.max(), min=-_CUT)
    return rlmax - lb2 * inv2s2 >= -_CUT, lb2


def bcpd_estep_culled(t_source, target, rowlog, v_t, w_over_n, sigma2,
                      tile_m: int = 1024, tile_n: int = 1024):
    """Tile-culled BCPD E-step on Morton-sorted inputs (the caller sorts).

    Args:
        t_source: (M, D <= 3) transformed source, sorted.
        target: (N, D) target, sorted.
        rowlog: (M,) per-source-row log weight.
        v_t: (C <= 8, N) channel matrix whose per-source moments are
            wanted (BCPD passes [x; 1; |x|^2]).
        w_over_n: the outlier constant w / n_eff.
        sigma2: Gaussian variance (a float or a 0-d tensor).

    Returns (nu_d (N,), mom (C, M), dmin (M,), e1 ()): dmin is each row's
    minimum d2 over active tiles, min'd with the box-gap bound of its culled
    tiles, a lower bound on the true nearest-neighbour d2 that is exact
    wherever the nearest neighbour lies in an active tile.
    """
    t_source, target = _check_points(t_source, target)
    (m, dim), n = t_source.shape, target.shape[0]
    dev = t_source.device
    rowlog = torch.as_tensor(rowlog, dtype=torch.float32, device=dev)
    v_t = torch.as_tensor(v_t, dtype=torch.float32, device=dev)
    if rowlog.shape != (m,) or v_t.dim() != 2 or v_t.shape[1] != n \
            or not 1 <= v_t.shape[0] <= _MAX_C:
        raise ValueError(f"expected rowlog ({m},) and V (C <= {_MAX_C}, "
                         f"{n}), got {tuple(rowlog.shape)} and "
                         f"{tuple(v_t.shape)}")
    tile_n = bcpd_tile_n(m, n, tile_m, tile_n)
    tile_m = min(tile_m, _round_up(m, 8))
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev)
    inv2s2 = 0.5 / sigma2
    scal = torch.stack([inv2s2, torch.as_tensor(
        w_over_n, dtype=torch.float32, device=dev).reshape(()),
        torch.tensor(_EPS, dtype=torch.float32, device=dev)])
    mask, lb2 = cull_mask(t_source, target, rowlog, inv2s2, tile_m, tile_n)
    nud, mom, dmin, e1 = wstash_estep(t_source, target, rowlog, v_t, scal,
                                      mask, tile_m, tile_n)
    # Fold the culled tiles' box-gap bounds into the row minima.
    lb2_row = torch.where(mask, math.inf, lb2).amin(1)
    dmin = torch.minimum(dmin, lb2_row.repeat_interleave(tile_m)[:m])
    return nud, mom, dmin, e1


def wstash_estep(ys, xs, rowlog, v_t, scal, mask, tile_m: int, tile_n: int):
    """(nu_d, mom (C, M), dmin over active pairs, e1) of the row-weighted
    E-step on sorted clouds, given the (n_i, n_j) active-tile mask: the
    kernels for CUDA tensors (one launch per pass), the plain version for
    CPU tensors."""
    if ys.is_cuda:
        plan = WStashPlan(ys, xs, rowlog, v_t, scal, mask, tile_m, tile_n)
        plan.den()
        plan.moment()
        return plan.result()
    return wstash_estep_plain(ys, xs, rowlog, v_t, scal, mask, tile_m,
                              tile_n)


class WStashPlan:
    """Device buffers of one row-weighted E-step and its two launches:
    ``den()`` (pass A over every stripe) writes inv_den and nu_d;
    ``moment()`` (pass B over every source tile) writes the moments, the
    row minima and the rows' e1 terms, and must follow ``den()``. Nothing
    per pair is kept."""

    def __init__(self, ys, xs, rowlog, v_t, scal, mask, tile_m: int,
                 tile_n: int):
        (m, self.dim), n = ys.shape, xs.shape[0]
        self.n_i, self.n_j = mask.shape
        if tile_n > _MAX_TILE_N or max(self.n_i, self.n_j) > _MAX_GRID_Y:
            raise ValueError(f"tile_n={tile_n} / {self.n_i} x {self.n_j} "
                             "tiles exceed the row-weighted kernels' launch "
                             "limits")
        if tile_n % 4:
            raise ValueError(f"tile_n={tile_n}: pass B reads a stripe's "
                             "columns as float4, so tile_n must be a "
                             "multiple of 4")
        if self.n_i != -(-m // tile_m) or self.n_j != -(-n // tile_n):
            raise ValueError("mask shape does not match the tiles")
        self.m, self.n, self.tile_m, self.tile_n = m, n, tile_m, tile_n
        self.ys, self.xs = _pack(ys), _pack(xs)
        self.rowlog = rowlog.to(torch.float32).contiguous()
        self.vt = v_t.to(torch.float32).contiguous()
        self.c = self.vt.shape[0]
        self.scal = scal.to(torch.float32).contiguous()
        self.col_idx, self.col_cnt = _compact(mask)      # per stripe
        self.row_idx, self.row_cnt = _compact(mask.T)    # per source tile
        new = self.ys.new_empty
        self.inv_den, self.nud = new(n), new(n)
        self.mom = new((m, _MAX_C))
        self.dmin, self.e1r = new(m), new(m)
        self.lib = _lib()
        self.stream = _stream(self.ys)

    def den(self) -> None:
        status = self.lib.probreg_wstash_den(
            self.ys.data_ptr(), self.rowlog.data_ptr(), self.m, self.tile_m,
            self.n_i, self.xs.data_ptr(), self.n, self.tile_n, self.n_j,
            self.col_idx.data_ptr(), self.col_cnt.data_ptr(),
            self.scal.data_ptr(), self.inv_den.data_ptr(),
            self.nud.data_ptr(), self.stream)
        _check(status, "wstash_den")
        LAUNCHES["wstash_den"] += 1

    def moment(self) -> None:
        status = self.lib.probreg_wstash_moment(
            self.ys.data_ptr(), self.rowlog.data_ptr(), self.m, self.tile_m,
            self.n_i, self.xs.data_ptr(), self.vt.data_ptr(), self.c, self.n,
            self.tile_n, self.n_j, self.row_idx.data_ptr(),
            self.row_cnt.data_ptr(), self.scal.data_ptr(),
            self.inv_den.data_ptr(), self.mom.data_ptr(),
            self.dmin.data_ptr(), self.e1r.data_ptr(), self.stream)
        _check(status, "wstash_moment")
        LAUNCHES["wstash_moment"] += 1

    def result(self):
        return (self.nud, self.mom[:, :self.c].T, self.dmin,
                self.e1r.sum())


def _plain_den(ys, y2, rowlog, x, x2, scal, act_rows, n_i, tile_m):
    """Pass A of one stripe: g (zero in culled tiles), d2, inv_den and nu_d;
    column sums per 256-row stage of each tile, added in stage order."""
    d2 = torch.clamp(y2[:, None] + x2[None, :] - 2.0 * (ys @ x.T), min=0.0)
    g = torch.where(act_rows[:, None],
                    torch.exp(rowlog[:, None] - d2 * scal[0]), 0.0)
    stages = -(-tile_m // _STAGE)
    per_tile = torch.nn.functional.pad(
        g, (0, 0, 0, n_i * tile_m - ys.shape[0])).view(n_i, tile_m, -1)
    per_stage = torch.nn.functional.pad(
        per_tile, (0, 0, 0, stages * _STAGE - tile_m)).view(
        n_i * stages, _STAGE, -1).sum(1)
    den_raw = per_stage.sum(0)
    den = den_raw + scal[1]
    den = torch.where(den == 0.0, scal[2], den)
    return g, d2, 1.0 / den, den_raw / den


def wstash_estep_plain(ys, xs, rowlog, v_t, scal, mask, tile_m: int,
                       tile_n: int):
    """Plain version of the row-weighted stash kernels, stripe by stripe:
    culled tiles contribute nothing, and the row minima run over active
    pairs only (inf where a row has none)."""
    m = ys.shape[0]
    n_i = mask.shape[0]
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)
    mom = ys.new_zeros((v_t.shape[0], m))
    dmin = ys.new_full((m,), math.inf)
    e1 = ys.new_zeros(())
    nud = []
    for j in range(mask.shape[1]):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        act_rows = mask[:, j].repeat_interleave(tile_m)[:m]
        g, d2, inv_den, nud_j = _plain_den(ys, y2, rowlog, xs[cols],
                                           x2[cols], scal, act_rows, n_i,
                                           tile_m)
        p = g * inv_den[None, :]
        mom = mom + v_t[:, cols] @ p.T
        dmin = torch.minimum(dmin, torch.where(act_rows[:, None], d2,
                                               math.inf).amin(1))
        e1 = e1 + (p * d2).sum()
        nud.append(nud_j)
    return torch.cat(nud), mom, dmin, e1

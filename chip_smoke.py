#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (probreg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from probreg_tpu_torch/csrc/ (one nvcc per source,
all started together), holds each kernel against its plain PyTorch version
on the card at the shapes its path gives it, then drives the port's paths
through the user entry points, each with the launch counters set to 0 just
before it and read just after:

* rigid CPD at 150,000 points (examples/largescale_rigid.py: uniform in
  [-1, 1]^3, seed 0, Euler (3, -2, 5) degrees, maxiter 40, tol 1e-8):
  the streaming EM with the tile-culled E-step kernels (stash_den,
  stash_moment: one launch each per E-step, no stash);
* the same clouds with use_pallas=True at a smaller depth: the streaming EM
  with the two-pass kernels (fused_den, fused_moment);
* the public E-step on a 1,000-point pair (RigidCPD.expectation_step):
  one launch of the small E-step kernel (estep_small); then the step API
  (expectation_step + maximization_step, 50 iterations) timed on the bunny
  and on a 1,000-point pair;
* rigid and affine CPD on the bunny (bench.py's configuration): the whole
  EM in one launch of the whole-EM kernel (em_rigid, em_affine);
* registration_cpd_batch on a ragged batch of 256 pairs of 300-1024 points
  (rigid) and a fixed-size batch of 64 pairs (affine): one launch of the
  whole-EM kernel for each batch;
* rigid FilterReg at 150,000 points (examples/largescale_rigid.py: maxiter
  40, tol 1e-8, sigma2_decay 0.9): the streaming EM, each E-step one launch
  of the tile-culled Gauss transform (gauss_transform);
* rigid FilterReg on the bunny, pt2pt and pt2pl (examples/filterreg_rigid.py
  and filterreg_rigid_pt2pl.py): the whole EM in one launch of the FilterReg
  whole-EM kernel (frg_pt2pt, frg_pt2pl);
* registration_filterreg_batch on the 256 ragged horse pairs (pt2pt) and on
  64 pt2pl pairs of 512 points: one launch of that kernel for each batch;
* ICP on the bunny (examples/icp_comparison.py: 10 degrees about z,
  maxiter 100, tol 1e-8): one launch of the whole-ICP kernel (icp);
  registration_icp_batch on the 256 ragged horse pairs: one launch; and one
  registration_icp past the kernel's gate, on the 150,000-point clouds
  (maxiter 10): the plain torch loop;
* combined BCPD at 100,000 points (benchmarks/bench_bcpd_guarded.py's
  fixture: blobby_surface(100_000, seed=2), deformed by 0.02 sin(3x) [1,
  0.5, -0.3] and rotated by Euler (8, -4, 6) degrees; rank 64, maxiter 50,
  tol 1e-4, one level): each VI iteration runs the row-weighted culled
  E-step kernels (wstash_den, wstash_moment) once each, no stash;
* GMMTree (tree_level 2, maxiter 20, tol 1e-4 unless named): the bunny of
  examples/gmmtree_rigid.py and bench.py's bunny pair; 32 copies of that
  pair (benchmarks/bench_full.py) and the 256 ragged horse pairs (maxiter
  30, tol 1e-6, examples/batch_serving.py) through
  registration_gmmtree_batch; and two 150,000-point samples of
  blobby_surface (seeds 2 and 3), the target rotated by Euler (3, -2, 5)
  degrees: each call or batch builds its trees with one launch of the
  level-EM kernel (gmmtree_level_em) per level and registers with one
  launch of the registration kernel (gmmtree_reg);
* the coarse-to-fine CPD pyramid (examples/pyramid_rigid.py:
  blobby_surface(n, seed=0), the target moved by Euler (5, 8, 12) degrees
  and t = (0.05, -0.03, 0.08); levels 3, tol 1e-4) at 200,000 and
  1,000,000 points, once through the default E-step kernels (stash_den,
  stash_moment) and once with config.use_merged_stash through K3's pass A
  and the folded pass B of the pipelined kernel (stash_den, stash_merged:
  two launches per E-step, no stash); the affine CPD pyramid
  at 200,000 points (test_pyramid_affine's map); and the ICP, FilterReg
  (pt2pt) and GMMTree pyramids at 200,000 points, and the BCPD pyramid at
  100,000 points (bench_bcpd_guarded.py: rank 64, maxiter 50, tol 1e-4, 4
  levels);
* nonrigid CPD (examples/cpd_nonrigid2d.py's fish, beta 2, lmd 2, maxiter
  50, tol 1e-3; and the 1,000-point cloud of the step API moved by
  0.05 sin(2 x[::-1]), 30 iterations): one launch of the small E-step
  kernel (estep_small) per iteration, against the plain-driven run, one
  iteration split by CUDA events into K2, the M x M solve and the rest;
  constrained nonrigid CPD on the fish (tests/test_cpd.py's settings, K2
  per iteration); 50 iterations of NonRigidCPD's step API; the low-rank
  loop (rank 60, maxiter 20) on examples/cpd_nonrigid_lowrank.py's
  16,384-point surface (plain tensors, no kernel); and the low-rank
  nonrigid CPD pyramid (rank 64, levels 3, maxiter 50, tol 1e-4) at
  100,000 points (bench_bcpd_guarded.py's deformation, no rotation), the
  displacement carried between levels by the tile-culled Gauss transform
  (gauss_transform) where coarse x fine >= 2^28, and 3 iterations of the
  low-rank loop on its finest clouds split by torch.profiler;
* the sharded CPD runners (probreg_tpu_torch.parallel) on the 150k pair,
  culled, 40 iterations: on one NCCL rank, registration_cpd_sharded on a
  1-D mesh (stash_den, stash_moment per shard) and registration_cpd_2d on
  a 1 x 1 mesh (stash_den_raw, stash_finish, stash_moment: three launches
  and one den all_reduce per E-step), and the low-rank nonrigid kind on
  the 16,384-point surface (rank 60, 20 iterations) on both meshes, held
  to the single-card low-rank run; then four ranks on the one card under
  gloo, a
  check of the cross-shard collectives and not a 4-card figure: 2 x 2
  registration_cpd_2d (K11 in every rank), 1-D x 4
  registration_cpd_sharded, registration_cpd_batch_sharded on the 256
  ragged horse pairs (one em_rigid launch per rank, bit for bit against
  registration_cpd_batch), the CPD pyramid with mesh= (2 x 2) at
  200,000 points and the 2 x 2 low-rank nonrigid kind on the 16,384-point
  surface (K11 in every rank).

Prints the card, a {"kernels": [...]} line and, last, {"ok": true, ...}.
Exits non-zero without a CUDA device or when any phase fails.

    python3 chip_smoke.py --parent DIR

instead times the small E-step kernel (K2) of this checkout and of another
checkout DIR at every shape check_small runs, with the largest difference
between them, and the step API (RigidCPD.expectation_step +
maximization_step) of both in fresh processes; holds the whole-loop
kernels of this checkout (K1 for CPD, K5 for FilterReg, K7 for ICP) bit
for bit against those built from DIR, at 1, 2, 4 and 8 blocks per pair
and the default; times them and the GMMTree registration kernel (K10) of
both; and prints the fixed cost of a K1, K5 and K7 iteration on a 32 x 32
pair.
"""

import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 and f32 outside the
# tensor cores. The bounds below divide this run's bytes and operations by
# them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations per pair, counting one exp as one operation: the Gaussian
# (dot 5, |y|^2 + |x|^2 - 2 y.x 3, max and scale 2, exp 1) is 11, its column
# sum 1; normalizing (1) and the p1 / px sums (1 + 6) are 8.
FLOPS_GAUSS = 11 + 1
FLOPS_MOMENTS = 8
RTOL, ATOL = 1e-4, 1e-6  # see compare()
N_LARGE = 150_000
# Rotation error (rad) the 150k run must reach against the ground truth.
# After its 40 iterations rigid CPD on this configuration is still annealing
# (sigma2 ~ 0.02): it ends near 1.4e-3 rad on the card, and the same loop
# on the CPU ends at 2.5e-3 / 2.3e-3 rad for 3,000 / 8,000 points. The
# sharper check is the kernel-driven run against the plain-driven one.
ROT_ERR_MAX = 3e-3
_ESTEP_CU = "probreg_tpu_torch/csrc/estep.cu"
_EM_CU = "probreg_tpu_torch/csrc/em.cu"
_FRG_CU = "probreg_tpu_torch/csrc/frg.cu"
_GT_CU = "probreg_tpu_torch/csrc/gt.cu"
_ICP_CU = "probreg_tpu_torch/csrc/icp.cu"
_WSTASH_CU = "probreg_tpu_torch/csrc/wstash.cu"
_GMMTREE_CU = "probreg_tpu_torch/csrc/gmmtree.cu"
# name -> (source of the kernel, file:line of the TPU kernel it replaces)
KERNELS = {
    "estep_small": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:1571"),
    "stash_den": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:393"),
    "stash_moment": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:429"),
    "stash_merged": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:581"),
    "stash_den_raw": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:779"),
    # K11's finalisation: jnp code between the psum and pass B in the
    # reference (fused_stash_core_spmd), a hand-written kernel here. K11's
    # pass B (estep_pallas.py:874) is stash_moment's kernel.
    "stash_finish": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:906"),
    "em_rigid": (_EM_CU, "probreg_tpu/ops/em_pallas.py:262"),
    "em_affine": (_EM_CU, "probreg_tpu/ops/em_pallas.py:262"),
    "fused_den": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:87"),
    "fused_moment": (_ESTEP_CU, "probreg_tpu/ops/estep_pallas.py:124"),
    "frg_pt2pt": (_FRG_CU, "probreg_tpu/ops/em_pallas.py:797"),
    "frg_pt2pl": (_FRG_CU, "probreg_tpu/ops/em_pallas.py:797"),
    "gauss_transform": (_GT_CU, "probreg_tpu/ops/estep_pallas.py:1210"),
    "icp": (_ICP_CU, "probreg_tpu/ops/em_pallas.py:563"),
    "wstash_den": (_WSTASH_CU, "probreg_tpu/ops/estep_pallas.py:943"),
    "wstash_moment": (_WSTASH_CU, "probreg_tpu/ops/estep_pallas.py:987"),
    "gmmtree_level_em": (_GMMTREE_CU,
                         "probreg_tpu/ops/gmmtree_pallas.py:109"),
    "gmmtree_reg": (_GMMTREE_CU, "probreg_tpu/ops/gmmtree_pallas.py:297"),
}
# A whole EM iteration needs, per pair, the Gaussian once and the moments
# once: that is what the bound charges. (The kernel itself forms the
# Gaussian again in its second pass, 32 operations per pair, because the
# posterior does not fit shared memory; that is its choice, not the
# function's.)
FLOPS_EM = FLOPS_GAUSS + FLOPS_MOMENTS
# Depth of the whole-EM batch runs that are compared and timed (tol 0: the
# kernel and its plain version both run exactly this many iterations).
EM_BATCH_ITERS = 20
# Depth of the 150k runs that are only compared with each other (kernels
# against their plain version, two-pass against stash).
COMPARE_ITERS = 10
TWO_PASS_ITERS = 5
# Rotation error (rad) the 150k FilterReg run must reach. With sigma2
# decaying by 0.9 for 40 iterations the smoothing ends at sigma2 ~ 0.01, and
# the port's streaming loop on this configuration ends at 2.84e-3 / 3.44e-3
# rad on the CPU for 3,000 / 8,000 points; 6e-3 leaves room for the trend.
FRG_ROT_ERR_MAX = 6e-3
# f32 operations per pair and iteration of the whole ICP: d2 from
# differences (3 subtractions, 3 products, 2 sums) and the running minimum.
FLOPS_ICP = 9
# Depth of the whole-ICP runs that are compared and timed (tol 0).
ICP_ITERS = 20
# BCPD at 100k: the fixture of benchmarks/bench_bcpd_guarded.py.
N_BCPD = 100_000
BCPD_ARGS = dict(rank=64, maxiter=50, tol=1e-4)
# Depth of the kernel-driven and plain-driven BCPD runs that are compared.
BCPD_COMPARE_ITERS = 3
# GMMTree: f32 operations of one weighted Gaussian of a node from
# differences (3 subtractions, 15 for inv d, 5 for d . inv d, the scale, the
# exp and the two weights: 27).
FLOPS_GMM_GAUSS = 27
# Depths of the GMMTree comparisons (lambda_s = 0 / tol = 0: both run
# exactly this many iterations). At 150k |q| is ~1e5, so one f32 ulp of q
# passes lambda_s = 1e-3 and a stop test cannot be compared there.
GMM_BUILD_ITERS = 10
GMM_REG_ITERS = 20
N_GMM = 150_000
# The CPD pyramid: examples/pyramid_rigid.py's case and arguments.
PYRAMID_SIZES = (200_000, 1_000_000)
PYRAMID_ARGS = dict(levels=3, tol=1e-4)
# The reference test's bar for the rigid pyramid (tests/test_pyramid.py:
# 52-59): rotation angle (rad), |t - t_gt| and |scale - 1|.
PYR_ANGLE_MAX, PYR_T_MAX, PYR_SCALE_MAX = 1e-3, 1e-4, 1e-3
# The merged-stash (K12) and default (K3) pyramid runs must agree within
# this in rot and t. Stated before their first run on the card: the two
# routes' E-steps give pt1 and xx bit for bit and p1, px that differ by the
# rounding of one association (~1e-7 of their largest entry), and both EMs
# anneal to the same fixed point on these exact copies.
PYR_ROUTE_TOL = 1e-5
# check_pyramid_estep: where a kernel's output is beyond compare()'s
# tolerance of its plain version, it must lie within this many times the
# plain version's own distance from the f64 result (the repo's factor for
# f32 spreads, as in the GMMTree checks). Stated after compare()'s
# tolerance failed there on the card: p1 of K12 at 5.66e-4 of its largest
# entry at the 200k pyramid's sigma2 of 9.9e-5 (CHANGES.md).
PYR_ESTEP_SPREAD = 3.0
# test_pyramid_affine's bar on b and t.
PYR_AFFINE_MAX = 1e-2
# The sharded runners (probreg_tpu_torch.parallel) on the 150k clouds: a
# 2 x 2 rank holds half of each cloud; registration_cpd_2d's default tile;
# the depth of the 150k phase (run_large_registration, maxiter 40), fixed
# (tol 0) so every run makes the same iterations.
SHARD = N_LARGE // 2
MESH_TILE = 512
MESH_ITERS = 40
# The 1-D and 2-D runners against each other and across mesh shapes, in rot
# and t: they differ in tile sizes and in the order of the cross-shard sums,
# as the two-pass and stash routes of the 150k phase do (1e-4 there).
MESH_AGREE = 1e-4
# One E-step of K11's route: raw pass A, finish, K3's pass B.
K11_ROUTE = ("stash_den_raw", "stash_finish", "stash_moment")
# Repetitions of the den all_reduce when it is timed.
REDUCE_REPS = 200
# K2 (estep_small) at (M, N, D): the kernel table's 1000^2 row, the same
# in 2-D, the gate's tall and wide corners (M * N = 2^20) and bench.py's
# bunny size.
SMALL_SHAPES = ((1000, 1000, 3), (1000, 1000, 2), (32768, 32, 3),
                (32, 32768, 3), (390, 390, 3))
# Back-to-back launches in one timed run of K2 or of the empty kernel.
SMALL_REPS = 200
# E-step + M-step pairs of the step API in one timed run (step_api_ms).
STEP_ITERS = 50
STEP_QUADS = 5  # --parent: the step API's order parent, this, this, parent


def flops_wstash(channels: int):
    """f32 operations per active pair of the row-weighted E-step's passes,
    from their own inputs (no stash): pass A the Gaussian with its row
    offset (dot 5, |y|^2 + |x|^2 - 2 y.x 3, max 1, scale and offset 2, exp
    1) and the column sum, 13; pass B the Gaussian again (12), p = g / den
    1, e1 2, the row minimum 1 and 2 per channel."""
    return 13, 16 + 2 * channels


def flops_frg(channels: int) -> int:
    """f32 operations per pair of a FilterReg E-step or Gauss transform: the
    Gaussian from differences (3 subtractions, 3 products and 2 sums for
    d2, the scale and the exp: 10; d2 >= 0 needs no clamp) and 2 per moment
    channel."""
    return 10 + 2 * channels


def flops_level_em(k: int) -> int:
    """f32 operations per point and iteration of K9 on a level of k nodes:
    the 8 children's Gaussians with the sum, the division and the
    first-maximum test (3), and the 10 moments (20), plus the 6 feature
    products; then the stop test's Gaussian over all k nodes with its sum,
    the log and the point's share of q (2)."""
    return 8 * (FLOPS_GMM_GAUSS + 3 + 20) + 6 + k * (FLOPS_GMM_GAUSS + 1) + 2


def flops_gmm_reg(levels: float) -> float:
    """f32 operations per point and iteration of K10 whose descent visits
    ``levels`` levels on average: the transform (18), per level 8 Gaussians
    with the clamp, the sum, the division and the first-maximum test (31
    each), and the point's 4 moments (4)."""
    return 18 + levels * 8 * (FLOPS_GMM_GAUSS + 4) + 4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def evented(spans, name, fn):
    """``fn`` with each call between CUDA events, appended to ``spans`` as
    (name, start event, end event)."""
    def run(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **k)
        e1.record()
        spans.append((name, e0, e1))
        return out
    return run


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want):
    """Max abs error of a kernel output against its plain version, and that
    error relative to the output's largest magnitude (the repo's own
    criterion, tests/test_culled_estep.py _rel). Raises beyond
    RTOL * max|want| + ATOL. Per element the two differ by the f32
    cancellation in d2 = |y|^2 + |x|^2 - 2 y.x (FMAs in the kernel, cuBLAS
    in the plain version), amplified by 1/(2 sigma2); normalizing by the
    largest entry keeps small entries from failing on that noise."""
    got, want = got.double(), want.double()
    abs_err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"  {name:6s} max_abs_err {abs_err:.3e}  max_rel_err "
        f"{abs_err / max(scale, 1e-30):.3e}")
    if not abs_err <= RTOL * scale + ATOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version beyond {RTOL} of its largest entry")
    return abs_err


def large_clouds(dev):
    rng = np.random.default_rng(0)
    src = rng.uniform(-1.0, 1.0, (N_LARGE, 3)).astype(np.float32)
    from probreg_tpu_torch.utils import se3_op

    rot = se3_op.euler2mat(*np.deg2rad([3.0, -2.0, 5.0])).numpy()
    tgt = (src @ rot.T).astype(np.float32)
    return src, tgt, rot


def device_launches(fn, calls=20):
    """Device activities (kernels, copies, fills) per call of ``fn``, their
    device us per call, and the us per call of each activity by name, from
    torch.profiler (CUPTI) over ``calls`` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / calls)
    return count / calls, sum(by_name.values()), by_name


def device_us(fn, calls=20) -> float:
    """Device us per call of ``fn`` (device_launches)."""
    return device_launches(fn, calls)[1]


def small_flat(mom):
    """K2's five outputs in one f32 vector, for bitwise comparisons."""
    return torch.cat([mom.pt1, mom.p1, mom.px.reshape(-1),
                      torch.stack([mom.n_p, mom.xx])])


def check_small(dev, kernels):
    """K2 at every SMALL_SHAPES shape: held to its plain version (compare)
    and to the plain version in f64 (within compare()'s tolerance, or
    PYR_ESTEP_SPREAD times the f32 plain version's own distance from it);
    the same bits on one block, two blocks and the default grid; the raw
    launch and the whole estep_small call timed beside the empty kernel's
    launch through the same ctypes path, its arguments built once as K2's
    are (K2's floor); the device launches of a whole call counted with
    torch.profiler. The kernels line takes the 1000^2, D = 3 row: ``ms``
    is the host-timed raw launch (SMALL_REPS back to back), ``device_ms``
    the kernel's device time (torch.profiler)."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    def floor_ms(coop):
        empty = ec.empty_launcher(dev, coop)
        return (timed(lambda: [empty() for _ in range(SMALL_REPS)], 5)
                / SMALL_REPS, device_us(empty) / 1e3)

    (floor, dev_floor), (floor_coop, dev_floor_coop) = (floor_ms(False),
                                                        floor_ms(True))
    log(f"[K2 estep_small] floor: an empty kernel through the same path, "
        f"{SMALL_REPS} back to back: {floor:.4f} ms a launch, "
        f"{floor_coop:.4f} ms as a cooperative launch (the host's issue "
        f"rate); on the device (torch.profiler) {dev_floor:.5f} / "
        f"{dev_floor_coop:.5f} ms")
    names = ("pt1", "p1", "px", "n_p", "xx")
    for m, n, dim in SMALL_SHAPES:
        ys, xs, sigma2, w = small_case(m, n, dim, dev)
        scal = ec._scalars(sigma2, w, m, n, dim, dev)
        plan = ec.small_plan(m, n)
        log(f"[K2 estep_small] {m} x {n}, D = {dim}: tiles of {plan.rows} x "
            f"{plan.cols}, {plan.tiles} of them, "
            f"{min(plan.tiles, ec.small_capacity(dim, dev))} blocks")
        mom = ec.estep_small(ys, xs, sigma2, w)
        got = (mom.pt1, mom.p1, mom.px, mom.n_p, mom.xx)
        pt1, p1, px, xx = ec.estep_small_plain(ys, xs, scal)
        plain = (pt1, p1, px, p1.sum(), xx)
        pt1, p1, px, xx = ec.estep_small_plain(ys.double(), xs.double(),
                                               scal.double())
        f64 = (pt1, p1, px, p1.sum(), xx)
        err = max(compare(k, a, b) for k, a, b in zip(names, got, plain))
        for k, a, b, c in zip(names, got, plain, f64):
            d_k = float((a.double() - c).abs().max())
            d_p = float((b.double() - c).abs().max())
            scale = float(c.abs().max())
            log(f"  {k:6s} from f64: kernel {d_k:.3e}, plain {d_p:.3e}")
            if not (d_k <= RTOL * scale + ATOL
                    or d_k <= PYR_ESTEP_SPREAD * d_p):
                raise AssertionError(f"K2 {k} at {m} x {n}: {d_k} from f64")
        outs = []
        for kw in (dict(_blocks=1), dict(_blocks=2), {}):
            launch, out = ec.small_launcher(ys, xs, sigma2, w, **kw)
            launch()
            outs.append(small_flat(out))
        same = [bool(torch.equal(outs[2], o)) for o in outs]
        log(f"  bits equal on 1 block, 2 blocks, the default grid: {same}; "
            f"equal to estep_small's: "
            f"{bool(torch.equal(outs[2], small_flat(mom)))}")
        if not all(same) or not torch.equal(outs[2], small_flat(mom)):
            raise AssertionError(f"K2's bits depend on the grid at {m} x {n}")
        one, _ = ec.small_launcher(ys, xs, sigma2, w)
        raw = timed(lambda: [one() for _ in range(SMALL_REPS)],
                    5) / SMALL_REPS
        dev_ms = device_us(one) / 1e3
        whole = timed(lambda: ec.estep_small(ys, xs, sigma2, w), 50)
        count, whole_dev, acts = device_launches(
            lambda: ec.estep_small(ys, xs, sigma2, w))
        plain_ms = timed(lambda: ec.estep_small_plain(ys, xs, scal), 20)
        nbytes = 4 * dim * (m + n) + 4 + 4 * n + 4 * m * (1 + dim) + 8
        b_ms, b_by = bound(nbytes, m * n * (FLOPS_GAUSS + FLOPS_MOMENTS))
        log(f"  device time (torch.profiler): K2 {dev_ms:.5f} ms "
            f"({dev_ms / dev_floor_coop:.2f} x the empty cooperative "
            f"launch's); bound {b_ms:.5f} ms ({b_by})")
        log(f"  host-timed: {SMALL_REPS} raw launches back to back {raw:.4f}"
            f" ms each ({raw / floor_coop:.2f} x the empty one's), the "
            f"whole estep_small call {whole:.4f} ms ({count:g} device "
            f"launches, {whole_dev / 1e3:.5f} ms of device time: "
            f"{sorted(acts)}); plain {plain_ms:.4f} ms")
        if count > 2:
            raise AssertionError(f"estep_small made {count} launches")
        if (m, n, dim) == SMALL_SHAPES[0]:
            kernels["estep_small"] = dict(max_abs_err=err, ms=raw,
                                          device_ms=dev_ms,
                                          plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=b_by)


def active_pairs(mask, m, n, tile_m, tile_n) -> float:
    """Pairs in the active tiles of an (n_i, n_j) mask over m x n points
    (the last row and column of tiles ragged)."""
    rows = torch.full((mask.shape[0],), float(tile_m), device=mask.device)
    rows[-1] = m - (rows.numel() - 1) * tile_m
    cols = torch.full((mask.shape[1],), float(tile_n), device=mask.device)
    cols[-1] = n - (cols.numel() - 1) * tile_n
    return float(rows @ mask.float() @ cols)


def estep_regimes(dev, shared):
    """One E-step on the centred, Morton-sorted 150k clouds in two regimes:
    dense (sigma2_0) and culled (an annealed sigma2): a list of (regime,
    sigma2, ys, xs, scal, mask, tile_m, tile_n, active pairs), made once
    and kept in ``shared`` for the phase that follows."""
    from probreg_tpu_torch.config import config
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.ops.spatial import morton_order
    from probreg_tpu_torch.utils import math_utils

    regimes = shared.setdefault("regimes", [])
    if not regimes:
        src, tgt, _ = large_clouds(dev)
        ys = torch.as_tensor(src, device=dev)
        xs = torch.as_tensor(tgt, device=dev)
        cen = (ys.sum(0) + xs.sum(0)) / (ys.shape[0] + xs.shape[0])
        ys, xs = ys - cen, xs - cen
        ys, xs = ys[morton_order(ys)], xs[morton_order(xs)]
        sigma2_0 = float(math_utils.squared_kernel_sum(ys, xs))
        m, n = ys.shape[0], xs.shape[0]
        tile_m = config.tile_m
        tile_n = ec._capped_tile_n(m, tile_m, config.tile_n,
                                   ec.stash_budget(dev))
        for regime, sigma2 in (("dense", sigma2_0), ("culled", 1e-3)):
            scal = ec._scalars(sigma2, 0.0, m, n, 3, dev)
            mask = ec._active_mask(*ec._tile_bounds(ys, tile_m),
                                   *ec._tile_bounds(xs, tile_n), scal[0])
            pairs = active_pairs(mask, m, n, tile_m, tile_n)
            regimes.append((regime, sigma2, ys, xs, scal, mask, tile_m,
                            tile_n, pairs))
    return regimes


def plain_pass_times(ys, xs, scal, mask, tile_m, tile_n):
    """ms of the plain passes A and B over all stripes, each stripe between
    its own events: (pass A, pass B from pass A's g, pass B forming the
    stripe's Gaussian again). The second is the cheaper plain form (it
    keeps a stripe's g in memory), the third does the kernels' work."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    m = ys.shape[0]
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)
    pa = pb = pb_again = 0.0
    for j in range(mask.shape[1]):
        c0 = j * tile_n
        x, xj2 = xs[c0:c0 + tile_n], x2[c0:c0 + tile_n]
        act = mask[:, j].repeat_interleave(tile_m)[:m]
        args = (ys, y2, x, xj2, scal, act, mask.shape[0], tile_m)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        g, inv_den, _, _ = ec._plain_pass_a(*args)
        e[1].record()
        ec._plain_pass_b(g, inv_den, x)
        e[2].record()
        del g
        g = ec._plain_pass_a(*args)[0]
        ec._plain_pass_b(g, inv_den, x)
        e[3].record()
        torch.cuda.synchronize()
        pa += e[0].elapsed_time(e[1])
        pb += e[1].elapsed_time(e[2])
        pb_again += e[2].elapsed_time(e[3])
        del g
    return pa, pb, pb_again


def estep_pass_bounds(m, n, pairs):
    """Bounds of the two passes of a large CPD E-step from the passes' own
    inputs and outputs, each read or written once: pass A reads both clouds
    and writes pt1 and inv_den, with the Gaussian and its column sum (12
    operations per active pair); pass B reads both clouds and inv_den,
    writes p1 and px, and needs the Gaussian again (11 + 8). A stash is a
    kernel's intermediate, not the function's: its bytes are not charged
    (K4 computes the same two passes without one), so K3 and K4 share these
    bounds."""
    return (bound(12 * (m + n) + 8 * n, pairs * FLOPS_GAUSS),
            bound(12 * (m + n) + 4 * n + 16 * m,
                  pairs * (FLOPS_GAUSS - 1 + FLOPS_MOMENTS)))


def estep_peak_mib(fn):
    """MiB of device memory that one call of ``fn`` allocates at its peak
    above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def check_pass_kernels(dev, kernels, shared, names, core, plain, plan_cls,
                       label, record):
    """Shared body of check_stash and check_fused_estep: a pair of pass
    kernels (one launch per pass each) against their plain version in both
    regimes, then timed against estep_pass_bounds, with the peak device
    memory of one E-step. ``record``: keep these times (K3's) in
    ``shared``; otherwise print K3's times on the same inputs beside.
    Both plain forms of pass B are printed; the kernels line takes the one
    each kernel has been held to since its port, K3's from pass A's g and
    K4's with the Gaussian formed again."""
    out = {}
    stash_ms = shared.setdefault("stash_ms", {})  # K3's times, for K4's log
    for (regime, sigma2, ys, xs, scal, mask, tile_m, tile_n,
         pairs) in estep_regimes(dev, shared):
        m, n = ys.shape[0], xs.shape[0]
        log(f"[{label}] {regime}: sigma2 {sigma2:.6g}, tiles {tile_m} x "
            f"{tile_n}, active tile fraction {float(mask.float().mean()):.4f},"
            f" active pairs {pairs:.4g}")
        got = core(ys, xs, scal, mask, tile_m, tile_n)
        want = plain(ys, xs, scal, mask, tile_m, tile_n)
        torch.cuda.synchronize()
        err_a = max(compare("pt1", got[0], want[0]),
                    compare("xx", got[3], want[3]))
        err_b = max(compare("p1", got[1], want[1]),
                    compare("px", got[2], want[2]))
        del got, want
        peak = estep_peak_mib(lambda: core(ys, xs, scal, mask, tile_m,
                                           tile_n))
        plan = plan_cls(ys, xs, scal, mask, tile_m, tile_n)
        ms_a, ms_b = timed(plan.den, 5), timed(plan.moment, 5)
        del plan
        pa, pb_g, pb_again = plain_pass_times(ys, xs, scal, mask, tile_m,
                                              tile_n)
        pb = pb_g if record else pb_again
        ba, bb = estep_pass_bounds(m, n, pairs)
        beside = ""
        if record:
            stash_ms[regime] = (ms_a, ms_b)
        else:
            k3 = stash_ms[regime]
            beside = (f"  [K3 on the same inputs: pass A {k3[0]:.3f} ms, "
                      f"pass B {k3[1]:.3f} ms]")
        log(f"  one E-step: peak device memory {peak:.3f} MiB above its "
            f"inputs ({m:,} x {tile_n} f32 would be "
            f"{4 * m * tile_n / 2**20:.1f} MiB)")
        log(f"  pass A kernel {ms_a:.3f} ms  plain {pa:.3f} ms  bound "
            f"{ba[0]:.3f} ms ({ba[1]})")
        log(f"  pass B kernel {ms_b:.3f} ms  plain {pb_g:.3f} ms from pass "
            f"A's g, {pb_again:.3f} ms forming it again  bound {bb[0]:.3f} "
            f"ms ({bb[1]}){beside}")
        out[regime] = (err_a, err_b, ms_a, ms_b, pa, pb, ba, bb)
    # The kernels line carries the dense E-step (the first iterations of
    # the 150k run); the culled numbers are printed above.
    err_a, err_b, ms_a, ms_b, pa, pb, ba, bb = out["dense"]
    kernels[names[0]] = dict(max_abs_err=max(err_a, out["culled"][0]),
                             ms=ms_a, plain_ms=pa, bound_ms=ba[0],
                             bound_by=ba[1])
    kernels[names[1]] = dict(max_abs_err=max(err_b, out["culled"][1]),
                             ms=ms_b, plain_ms=pb, bound_ms=bb[0],
                             bound_by=bb[1])


def check_stash(dev, kernels, shared):
    """K3 on the 150k clouds for one E-step, dense (sigma2_0) and culled
    (an annealed sigma2), against the plain version: one launch per pass,
    no stash."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    check_pass_kernels(dev, kernels, shared, ("stash_den", "stash_moment"),
                       ec.stash_estep, ec.stash_estep_plain, ec.StashPlan,
                       "K3", record=True)


def check_fused_estep(dev, kernels, shared):
    """K4 on the same inputs as K3: no stash, the Gaussian in both passes."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    check_pass_kernels(dev, kernels, shared, ("fused_den", "fused_moment"),
                       ec.fused_core, ec.fused_estep_plain, ec.FusedPlan,
                       "K4 two-pass", record=False)


def check_stash_merged(dev, kernels, shared):
    """K12 on the 150k clouds for one E-step, dense and culled: against its
    plain version (compare()'s tolerance), and against K3 on the same
    inputs: pt1 and xx equal bit for bit (the same pass A), p1 and px
    within 1e-5 of their largest entry (the normalizer is folded into the
    channels). Two launches per E-step (K3's pass A, stash_den, and the
    folded pass B, stash_merged), timed together, with the peak device
    memory of one E-step. The bound is the whole E-step's from its own
    inputs and outputs (both clouds read once; pt1, xx, p1 and px written
    once) and 12 + 8 operations per active pair, the Gaussian formed
    once."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    out = {}
    stash_ms = shared.get("stash_ms", {})
    for (regime, sigma2, ys, xs, scal, mask, tile_m, tile_n,
         pairs) in estep_regimes(dev, shared):
        m, n = ys.shape[0], xs.shape[0]
        log(f"[K12 merged] {regime}: sigma2 {sigma2:.6g}, tiles {tile_m} x "
            f"{tile_n}, active pairs {pairs:.4g}")
        before = dict(ec.LAUNCHES)
        got = ec.stash_merged_estep(ys, xs, scal, mask, tile_m, tile_n)
        torch.cuda.synchronize()
        made = {k: ec.LAUNCHES[k] - before[k] for k in before}
        if made != {**{k: 0 for k in before}, "stash_den": 1,
                    "stash_merged": 1}:
            raise AssertionError(f"K12 E-step made launches {made}")
        want = ec.stash_merged_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
        torch.cuda.synchronize()
        err = max(compare(k, a, b) for k, a, b in
                  zip(("pt1", "p1", "px", "xx"), got, want))
        del want
        k3 = ec.stash_estep(ys, xs, scal, mask, tile_m, tile_n)
        torch.cuda.synchronize()
        same = torch.equal(got[0], k3[0]) and torch.equal(got[3], k3[3])
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in ((got[1], k3[1]), (got[2], k3[2]))]
        log(f"  against K3: pt1 and xx {'equal' if same else 'NOT equal'} "
            f"bit for bit; p1 {rel[0]:.3e}, px {rel[1]:.3e} of the largest "
            "entry")
        del got, k3
        if not (same and max(rel) <= 1e-5):
            raise AssertionError("K12 disagrees with K3")
        peak = estep_peak_mib(lambda: ec.stash_merged_estep(
            ys, xs, scal, mask, tile_m, tile_n))
        plan = ec.MergedStashPlan(ys, xs, scal, mask, tile_m, tile_n)
        ms, ms_b = timed(plan.run, 5), timed(plan.moment, 5)
        del plan
        plain_ms = timed(lambda: ec.stash_merged_estep_plain(
            ys, xs, scal, mask, tile_m, tile_n), 2)
        b = bound(12 * (m + n) + 8 * n + 16 * m,
                  pairs * (FLOPS_GAUSS + FLOPS_MOMENTS))
        k3 = stash_ms.get(regime)
        beside = "" if k3 is None else \
            f"  [K3 on the same inputs: {k3[0] + k3[1]:.3f} ms]"
        log(f"  E-step kernel {ms:.3f} ms (its folded pass B {ms_b:.3f} ms) "
            f" plain {plain_ms:.3f} ms  bound {b[0]:.3f} ms ({b[1]}){beside}")
        log(f"  one E-step: peak device memory {peak:.3f} MiB above its "
            "inputs")
        out[regime] = (err, ms, plain_ms, b)
    err, ms, plain_ms, b = out["dense"]
    kernels["stash_merged"] = dict(max_abs_err=max(err, out["culled"][0]),
                                   ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                                   bound_by=b[1])


# --------------------------------------------------------------------------
# The whole-EM kernel
# --------------------------------------------------------------------------

def data_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        name)


def bunny_clouds(lin, seed=3):
    """bench.py's bunny configuration (seed 3; the FilterReg examples' is
    seed 4): the bunny at voxel 0.005 and a shuffled copy with 1e-3 noise,
    moved by the 3 x 3 map ``lin``."""
    from probreg_tpu_torch.utils import io

    rng = np.random.default_rng(seed)
    src = io.voxel_down_sample(io.read_point_cloud(data_path("bunny.pcd")),
                               0.005)
    tgt = src.copy()
    rng.shuffle(tgt)
    tgt = tgt + 1e-3 * rng.standard_normal(tgt.shape)
    return src.astype(np.float32), (tgt @ lin.T).astype(np.float32)


def z_rotation(deg):
    from probreg_tpu_torch.utils import se3_op

    return se3_op.euler2mat(0.0, 0.0, np.deg2rad(deg)).double().numpy()


AFFINE_MAP = np.diag([1.1, 0.95, 1.05])


def serving_batches(seed=4):
    """Seeded serving traffic from the horse scan (data/horse.ply, 2,936
    points): a ragged rigid batch of 256 pairs, source and target two
    different random subsets of 300-1024 points, the target rotated by
    Euler angles up to 15 degrees, shifted and given 5e-4 noise; and a
    fixed-size affine batch of 64 pairs of 512 points with a known map."""
    from probreg_tpu_torch.utils import io, se3_op

    horse = io.read_point_cloud(data_path("horse.ply")).astype(np.float64)
    rng = np.random.default_rng(seed)

    def pair(m, n, lin):
        src = horse[rng.choice(len(horse), m, replace=False)]
        tgt = horse[rng.choice(len(horse), n, replace=False)]
        tgt = (tgt @ lin.T + rng.uniform(-0.01, 0.01, 3)
               + 5e-4 * rng.standard_normal(tgt.shape))
        return src.astype(np.float32), tgt.astype(np.float32)

    rigid = []
    for _ in range(256):
        m, n = rng.integers(300, 1025, 2)
        rot = se3_op.euler2mat(*np.deg2rad(rng.uniform(-15, 15, 3))
                               ).double().numpy()
        rigid.append(pair(m, n, rot) + (rot,))
    affine = []
    for _ in range(64):
        lin = z_rotation(rng.uniform(-10, 10)) @ np.diag(
            rng.uniform(0.9, 1.1, 3))
        affine.append(pair(512, 512, lin) + (lin,))
    return rigid, affine


def em_pair_check(name, src, tgt, kind, smask=None, tmask=None):
    """The whole-EM kernel against its plain version on one pair: tightly
    after 1 and 5 iterations (only the order of the sums differs), loosely
    over a whole run (the iterations amplify it, and the two may stop one
    iteration apart). Returns the largest |lin|, |t| error seen."""
    from probreg_tpu_torch.ops import em_cuda as em

    worst = 0.0
    for maxiter, tol, atol, rtol in ((1, 0.0, 1e-5, 1e-5),
                                     (5, 0.0, 1e-5, 1e-5),
                                     (100, 1e-3, 2e-4, 1e-3)):
        kw = dict(kind=kind, w=0.0, maxiter=maxiter, tol=tol,
                  update_scale=True)
        masks = (None, None) if smask is None else (smask[None], tmask[None])
        got = em.run_em_cpd_fused_batch(src[None], tgt[None], *masks, **kw)
        want = em.run_em_cpd_fused_plain(
            *em.compact_batch(src[None], tgt[None], *masks),
            affine=kind == "affine", w=0.0, maxiter=maxiter, tol=tol,
            update_scale=True)[0]
        torch.cuda.synchronize()
        d_lin = float((got[0][0].reshape(-1) - want[:9]).abs().max())
        d_t = float((got[1][0] - want[9:12]).abs().max())
        r_s2 = abs(float(got[2][0]) / float(want[12]) - 1.0)
        r_q = abs(float(got[3][0]) / float(want[13]) - 1.0)
        log(f"  {name} {kind} maxiter {maxiter}: iterations kernel "
            f"{int(got[4][0])} plain {int(want[14])}, |lin| {d_lin:.2e} |t| "
            f"{d_t:.2e} sigma2 rel {r_s2:.2e} q rel {r_q:.2e}")
        if not (d_lin <= atol and d_t <= atol and r_s2 <= rtol
                and (maxiter > 5 or r_q <= rtol)):
            raise AssertionError(f"whole-EM kernel disagrees with its plain "
                                 f"version: {name} {kind} maxiter {maxiter}")
        worst = max(worst, d_lin, d_t)
    return worst


def em_batch_tensors(pairs, dev):
    from probreg_tpu_torch.utils import interop

    srcs, smask = interop.pad_ragged([p[0] for p in pairs], device=dev)
    tgts, tmask = interop.pad_ragged([p[1] for p in pairs], device=dev)
    return srcs, tgts, smask, tmask


def log_launch_plan(run, counts, batch):
    """How a whole-loop kernel (K1, K5, K7) lays out a batch launch
    (em_cuda.launch_plan): clusters of G blocks a pair, or one block a pair
    in work order, and then ``run``'s ms in arrival order
    (``run(_cluster=1, _ordered=False)``)."""
    from probreg_tpu_torch.ops import em_cuda as em

    sms = em.sm_count("cuda")
    g, order = em.launch_plan(batch, counts, sms)
    if order is None:
        log(f"  {batch} pairs on {sms} SMs: "
            f"{'one block' if g == 1 else f'clusters of {g} blocks'} a pair")
        return
    order = order.tolist()
    mn = counts.prod(1).tolist()
    arrival = timed(lambda: run(_cluster=1, _ordered=False), 5)
    log(f"  {batch} pairs on {sms} SMs: one block a pair, largest m n first "
        f"(blocks 0-3 take pairs {order[:4]}, m n "
        f"{[mn[b] for b in order[:4]]}; the last {order[-2:]}, m n "
        f"{[mn[b] for b in order[-2:]]}); in arrival order {arrival:.3f} ms")


def log_single_pair(name, run, iters, bound_text):
    """A single pair's ms and us per iteration on its default cluster and on
    one block (``run(_cluster=1)``)."""
    from probreg_tpu_torch.ops import em_cuda as em

    g = em.cluster_size(1, em.sm_count("cuda"))
    ms = timed(run, 5)
    one = timed(lambda: run(_cluster=1), 5)
    log(f"  {name}: {iters} iterations in {ms:.3f} ms ({ms / iters * 1e3:.1f}"
        f" us per iteration) on a cluster of {g} blocks; one block "
        f"{one / iters * 1e3:.1f} us per iteration; {bound_text}")


def check_em(dev, kernels):
    """K1 against run_em_cpd_fused_plain on the card: single pairs at the
    gate's edge (1024 x 1024), at the bunny's size and masked, then the two
    serving batches that run_batch drives, at a fixed depth, which give the
    kernels line its numbers."""
    from probreg_tpu_torch.ops import em_cuda as em

    log("[K1 whole EM] single pairs")
    rng = np.random.default_rng(5)
    big = rng.uniform(-1, 1, (1024, 3))
    pairs = {"1024x1024": (big, rng.permutation(
        big @ z_rotation(12.0).T + 0.01 * rng.standard_normal(big.shape)))}
    pairs["bunny 390"] = bunny_clouds(z_rotation(10.0))
    worst = {"rigid": 0.0, "affine": 0.0}
    for name, (src, tgt) in pairs.items():
        src = torch.as_tensor(src, dtype=torch.float32, device=dev)
        tgt = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
        for kind in worst:
            worst[kind] = max(worst[kind],
                              em_pair_check(name, src, tgt, kind))
        if name == "1024x1024":  # masked: 700 of 1024 and 900 of 1024 valid
            smask = torch.zeros(1024, device=dev)
            tmask = torch.zeros(1024, device=dev)
            smask[torch.as_tensor(rng.permutation(1024)[:700])] = 1.0
            tmask[torch.as_tensor(rng.permutation(1024)[:900])] = 1.0
            worst["rigid"] = max(worst["rigid"], em_pair_check(
                "masked 700/900", src, tgt, "rigid", smask, tmask))
        s_c, t_c, _ = em.compact_batch(src[None], tgt[None])
        for kind in worst:
            raw = dict(affine=kind == "affine", w=0.0, maxiter=100, tol=1e-3,
                       update_scale=True)
            its = int(em._em_cuda(s_c, t_c, None, **raw)[0, 14])
            m, n = src.shape[0], tgt.shape[0]
            b_ms, b_by = bound(12 * (m + n) + 64, its * m * n * FLOPS_EM)
            log_single_pair(f"{name} {kind}", lambda **k: em._em_cuda(
                s_c, t_c, None, **raw, **k), its,
                f"bound {b_ms:.4f} ms ({b_by})")

    # The serving batches, through the wrapper (masks and their compaction
    # included) against the plain version on each pair's own unpadded
    # clouds. Both run at a fixed depth (tol 0: exactly EM_BATCH_ITERS
    # iterations), because at tol 1e-3 the loop test |q - q_prev| < tol sits
    # at the f32 resolution of q (~1e-3 at |q| ~ 5,000), so two correct
    # versions stop iterations apart on slowly converging pairs. Times and
    # the bound are of that same fixed-depth run.
    rigid, affine = serving_batches()
    for key, kind, batch in (("em_rigid", "rigid", rigid),
                             ("em_affine", "affine", affine)):
        srcs, tgts, smask, tmask = em_batch_tensors(batch, dev)
        if kind == "affine":  # fixed-size: no masks, as run_batch sends it
            smask = tmask = None
        args = dict(w=0.0, maxiter=EM_BATCH_ITERS, tol=0.0, update_scale=True)
        lin, t, sigma2, _, it = em.run_em_cpd_fused_batch(
            srcs, tgts, smask, tmask, kind=kind, **args)
        if not bool((it == EM_BATCH_ITERS).all()):
            raise AssertionError("whole-EM batch: wrong iteration count")
        own = [(torch.as_tensor(p[0], device=dev)[None],
                torch.as_tensor(p[1], device=dev)[None]) for p in batch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = torch.cat([em.run_em_cpd_fused_plain(
            s, x, None, affine=kind == "affine", **args) for s, x in own])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = torch.cat([lin.reshape(-1, 9), t], dim=1)
        err = float((got - want[:, :12]).abs().max())
        r_s2 = float((sigma2 / want[:, 12] - 1.0).abs().max())
        log(f"[K1 whole EM] {kind} batch of {len(batch)}, {EM_BATCH_ITERS} "
            f"iterations: max |lin|, |t| {err:.2e}, sigma2 rel {r_s2:.2e}")
        # sigma2 is a small difference of large f32 sums (xx - scale
        # tr(A^T R)); both versions carry that cancellation noise.
        if not (err <= 1e-5 and r_s2 <= 1e-3):
            raise AssertionError(f"whole-EM {kind} batch disagrees with its "
                                 "plain version")
        # Raw launches on the compacted tensors (the wrapper's compaction
        # is not the kernel's time).
        s_c, t_c, counts = em.compact_batch(srcs, tgts, smask, tmask)
        raw = dict(affine=kind == "affine", **args)
        ms = timed(lambda: em._em_cuda(s_c, t_c, counts, **raw), 5)
        log_launch_plan(lambda **k: em._em_cuda(s_c, t_c, counts, **raw, **k),
                        counts, len(batch))
        sizes = torch.tensor([[p[0].shape[0], p[1].shape[0]] for p in batch],
                             dtype=torch.float64)
        pair_its = float(sizes.prod(1).sum()) * EM_BATCH_ITERS
        b_ms, b_by = bound(float(12 * sizes.sum() + 64 * len(batch)),
                           pair_its * FLOPS_EM)
        log(f"  kernel {ms:.3f} ms  plain {plain_ms:.1f} ms (a host loop "
            f"over the pairs)  bound {b_ms:.4f} ms ({b_by}), "
            f"{pair_its:.4g} pair-iterations")
        kernels[key] = dict(max_abs_err=max(err, worst[kind]), ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # As served (the entry point's maxiter 50, tol 1e-3): the kernel
        # alone, for its iteration spread and time.
        raw.update(maxiter=50, tol=1e-3)
        it = em._em_cuda(s_c, t_c, counts, **raw)[:, 14].cpu().double()
        ms = timed(lambda: em._em_cuda(s_c, t_c, counts, **raw), 5)
        pair_its = float((it * sizes.prod(1)).sum())
        log(f"  served (maxiter 50, tol 1e-3): iterations {int(it.min())}-"
            f"{int(it.max())}, kernel {ms:.3f} ms, {pair_its:.4g} "
            f"pair-iterations, bound "
            f"{bound(0.0, pair_its * FLOPS_EM)[0]:.4f} ms (operations)")


def _kernel_modules():
    from probreg_tpu_torch.ops import (bcpd_cuda, em_cuda, estep_cuda,
                                       frg_cuda, gmmtree_cuda, gt_cuda,
                                       icp_cuda)

    return (estep_cuda, em_cuda, frg_cuda, gt_cuda, icp_cuda, bcpd_cuda,
            gmmtree_cuda)


def reset_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def all_launches():
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def expect_launches(path, **want):
    """Every kernel named launched that often on ``path``, no other did."""
    got = all_launches()
    log(f"  launches: { {k: v for k, v in got.items() if v} }")
    for name, count in got.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {count} times, "
                                 f"expected {want.get(name, 0)}")


def run_large_registration(dev, launches):
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.utils import se3_op

    src, tgt, rot = large_clouds(dev)
    masks = []
    active_mask = ec._active_mask

    def recording_mask(*a):  # observes each E-step's tile mask
        mask = active_mask(*a)
        masks.append(mask.float().mean())
        return mask

    log(f"[main path] registration_cpd rigid, {N_LARGE:,} points, "
        "maxiter 40, tol 1e-8")
    t0 = time.perf_counter()
    cpd.registration_cpd(src, tgt, "rigid", maxiter=40, tol=1e-8)
    torch.cuda.synchronize()
    log(f"  warm call {time.perf_counter() - t0:.3f} s")
    ec._active_mask = recording_mask
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = cpd.registration_cpd(src, tgt, "rigid", maxiter=40, tol=1e-8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = all_launches()
    finally:
        ec._active_mask = active_mask
    launches.update(stash_den=got["stash_den"],
                    stash_moment=got["stash_moment"])
    peak = torch.cuda.max_memory_allocated()
    err = float(se3_op.rotation_angle(res.transformation.rot.cpu().double(),
                                      torch.as_tensor(rot).double()))
    sigma2 = float(res.sigma2)
    log(f"  timed call {wall:.3f} s, E-steps {len(masks)}, final sigma2 "
        f"{sigma2:.6g}, rotation error {err:.3e} rad")
    log(f"  active tile fraction: first E-step {float(masks[0]):.4f}, "
        f"last {float(masks[-1]):.4f}; peak memory {peak / 2**30:.3f} GiB")
    if not masks:
        raise AssertionError("the main path ran no culled E-step")
    # One launch of each pass per E-step.
    expect_launches("150k registration", stash_den=len(masks),
                    stash_moment=len(masks))
    if not (math.isfinite(sigma2) and err <= ROT_ERR_MAX):
        raise AssertionError(f"150k registration wrong: rotation error {err}")
    # The same registration with every stash E-step run by the plain
    # version: the kernels may change only the summation order. Both at a
    # smaller depth, because the plain version takes ~0.9 s per iteration.
    res = cpd.registration_cpd(src, tgt, "rigid", maxiter=COMPARE_ITERS,
                               tol=1e-8)
    stash_estep = ec.stash_estep
    ec.stash_estep = ec.stash_estep_plain
    try:
        t0 = time.perf_counter()
        ref = cpd.registration_cpd(src, tgt, "rigid", maxiter=COMPARE_ITERS,
                                   tol=1e-8)
        torch.cuda.synchronize()
    finally:
        ec.stash_estep = stash_estep
    d_rot = float((res.transformation.rot - ref.transformation.rot)
                  .abs().max())
    d_t = float((res.transformation.t - ref.transformation.t).abs().max())
    log(f"  plain-version registration, {COMPARE_ITERS} iterations (not 40, "
        f"to save time), {time.perf_counter() - t0:.3f} s: max |rot diff| "
        f"{d_rot:.3e}, max |t diff| {d_t:.3e}, sigma2 {float(ref.sigma2):.6g}"
        f" against {float(res.sigma2):.6g}")
    if not (d_rot <= 1e-4 and d_t <= 1e-4):
        raise AssertionError("kernel and plain registrations disagree")


def run_two_pass_path(dev, launches):
    """registration_cpd(use_pallas=True) on the 150k clouds: the streaming
    EM through the two-pass kernels, against the stash-driven run."""
    from probreg_tpu_torch import cpd

    src, tgt, _ = large_clouds(dev)
    kw = dict(maxiter=TWO_PASS_ITERS, tol=1e-8)
    log(f"[two-pass path] registration_cpd rigid use_pallas=True, "
        f"{N_LARGE:,} points, maxiter {TWO_PASS_ITERS}")
    cpd.registration_cpd(src, tgt, "rigid", use_pallas=True, **kw)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = cpd.registration_cpd(src, tgt, "rigid", use_pallas=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches("two-pass path", fused_den=TWO_PASS_ITERS,
                    fused_moment=TWO_PASS_ITERS)
    launches.update(fused_den=TWO_PASS_ITERS, fused_moment=TWO_PASS_ITERS)
    t0 = time.perf_counter()
    ref = cpd.registration_cpd(src, tgt, "rigid", **kw)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    d_rot = float((res.transformation.rot - ref.transformation.rot)
                  .abs().max())
    d_t = float((res.transformation.t - ref.transformation.t).abs().max())
    log(f"  two-pass {wall:.3f} s, stash {wall_ref:.3f} s for "
        f"{TWO_PASS_ITERS} iterations: max |rot diff| {d_rot:.3e}, max "
        f"|t diff| {d_t:.3e}, sigma2 {float(res.sigma2):.6g} against "
        f"{float(ref.sigma2):.6g}")
    if not (d_rot <= 1e-4 and d_t <= 1e-4 and math.isfinite(float(res.q))):
        raise AssertionError("two-pass and stash registrations disagree")


def run_small_estep_path(dev, launches):
    """The public E-step of a small problem goes through estep_small."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.ops import estep as eo

    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    reg = cpd.RigidCPD(src)
    reset_launches()
    res = reg.expectation_step(src, tgt, 0.1, 0.05)
    torch.cuda.synchronize()
    log("[E-step path] RigidCPD.expectation_step, 1000 x 1000")
    expect_launches("small E-step", estep_small=1)
    launches["estep_small"] = 1
    ref = eo.estep_xla(torch.as_tensor(src, device=dev),
                       torch.as_tensor(tgt, device=dev), 0.1, 0.05)
    for name, a, b in zip(("pt1", "p1", "px", "n_p"), res, ref):
        compare(name, a, b)
    # The step API as a user drives it: E-step and M-step in turn.
    for name, (s, t) in step_clouds().items():
        ms, out = step_api_ms(s, t)
        sigma2 = float(out.sigma2)
        log(f"[step API] {name}, {STEP_ITERS} iterations of "
            f"expectation_step + maximization_step: {ms:.4f} ms per "
            f"iteration, final sigma2 {sigma2:.4g}")
        if not (math.isfinite(sigma2)
                and bool(torch.isfinite(out.transformation.rot).all())):
            raise AssertionError(f"step API on {name}: non-finite result")


def run_bunny(dev, launches):
    """bench.py's bunny configuration, rigid and affine, each as one launch
    of the whole-EM kernel, held to the port's own dense loop."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.ops import em_cuda as em
    from probreg_tpu_torch.utils import se3_op

    for kind, lin_true in (("rigid", z_rotation(10.0)),
                           ("affine", z_rotation(10.0) @ AFFINE_MAP)):
        src, tgt = bunny_clouds(lin_true)
        kw = dict(maxiter=100, tol=1e-3)
        cpd.registration_cpd(src, tgt, kind, **kw)  # warm
        torch.cuda.synchronize()
        spans = []
        em_cuda = em._em_cuda
        em._em_cuda = evented(spans, "K1", em_cuda)
        try:
            reset_launches()
            t0 = time.perf_counter()
            res = cpd.registration_cpd(src, tgt, kind, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            em._em_cuda = em_cuda
        k1 = sum(e0.elapsed_time(e1) for _, e0, e1 in spans)
        log(f"[bunny] {kind}, {src.shape[0]} points, second call "
            f"{wall:.3f} ms, of which the K1 launch {k1:.3f} ms (CUDA "
            f"events) on a cluster of "
            f"{em.cluster_size(1, em.sm_count(dev))} blocks")
        expect_launches(f"bunny {kind}", **{f"em_{kind}": 1})
        ys = torch.as_tensor(src, device=dev)
        xs = torch.as_tensor(tgt, device=dev)
        t0 = time.perf_counter()
        lin, t, scale, _, _ = cpd._run_em_t(
            ys, xs, kind=kind, w=0.0, update_scale=kind == "rigid", **kw)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
        tr = res.transformation
        if kind == "rigid":
            d_ang = float(se3_op.rotation_angle(tr.rot.double(),
                                                lin.double()))
            ang = np.rad2deg(se3_op.mat2euler(tr.rot.cpu()).numpy())
            log(f"  dense loop {loop_ms:.1f} ms; rotation against it "
                f"{d_ang:.2e} rad, |t| {float((tr.t - t).abs().max()):.2e}, "
                f"recovered Euler {np.round(ang, 3).tolist()} deg")
            if not (d_ang <= 2e-4
                    and np.allclose(ang, [0.0, 0.0, 10.0], atol=0.5)):
                raise AssertionError("bunny registration wrong")
        else:
            d_lin = float((tr.b - lin).abs().max())
            d_true = float(np.abs(tr.b.cpu().numpy() - lin_true).max())
            log(f"  dense loop {loop_ms:.1f} ms; |B| against it {d_lin:.2e}, "
                f"against the known map {d_true:.2e}")
            if not (d_lin <= 2e-4 and d_true <= 2e-2):
                raise AssertionError("bunny affine registration wrong")


def run_batch(dev, launches):
    """registration_cpd_batch on the serving batches: one launch each."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.utils import se3_op

    rigid, affine = serving_batches()
    for kind, batch in (("rigid", rigid), ("affine", affine)):
        srcs, tgts = [p[0] for p in batch], [p[1] for p in batch]
        if kind == "affine":  # fixed-size: arrays, no masks
            srcs, tgts = np.stack(srcs), np.stack(tgts)
        cpd.registration_cpd_batch(srcs, tgts, kind)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = cpd.registration_cpd_batch(srcs, tgts, kind)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"[batch] registration_cpd_batch {kind}, {len(batch)} pairs, "
            f"second call {wall:.2f} ms ({wall / len(batch):.3f} ms per pair)")
        expect_launches(f"{kind} batch", **{f"em_{kind}": 1})
        launches[f"em_{kind}"] = 1
        errs, d_single = [], 0.0
        for (src, tgt, lin_true), r in zip(batch, res):
            one = cpd.registration_cpd(src, tgt, kind).transformation
            if kind == "rigid":
                errs.append(np.rad2deg(float(se3_op.rotation_angle(
                    r.transformation.rot.cpu().double(),
                    torch.as_tensor(lin_true)))))
                d = (one.rot * one.scale
                     - r.transformation.rot * r.transformation.scale)
            else:
                errs.append(float(np.abs(r.transformation.b.cpu().numpy()
                                         - lin_true).max()))
                d = one.b - r.transformation.b
            d_single = max(d_single, float(d.abs().max()))
        unit = "deg rotation error" if kind == "rigid" else "|B - known map|"
        log(f"  {unit}: max {max(errs):.4f} median {np.median(errs):.4f}; "
            f"max difference to the single-pair registrations "
            f"{d_single:.2e}")
        limit = (5.0, 1.0) if kind == "rigid" else (0.15, 0.05)
        if not (max(errs) <= limit[0] and np.median(errs) <= limit[1]
                and d_single <= 1e-6):
            raise AssertionError(f"{kind} batch registration wrong")


# --------------------------------------------------------------------------
# FilterReg: the whole-EM kernel (K5) and the culled Gauss transform (K6)
# --------------------------------------------------------------------------

def estimate_normals(pts, k=12):
    """PCA normals over k neighbours, oriented outward from the centroid (a
    numpy copy of examples/utils.py estimate_normals)."""
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    nbrs = pts[np.argsort(d2, axis=1)[:, :k]]
    ctr = nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", nbrs - ctr, nbrs - ctr)
    normals = np.linalg.eigh(cov)[1][:, :, 0]
    sign = np.sign((normals * (pts - pts.mean(0))).sum(1, keepdims=True))
    sign[sign == 0] = 1.0
    return (normals * sign).astype(pts.dtype)


def surface_pair(n, seed):
    """n points each of two samplings of z = 0.3 sin(2x) + 0.24 cos(2y) over
    [-1, 1]^2, the target rotated 8 degrees about z and shifted, with its
    analytic normals: a well-posed pt2pl pair."""
    rng = np.random.default_rng(seed)

    def sample(rot):
        xy = rng.uniform(-1, 1, (n, 2))
        pts = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0])
                               + 0.24 * np.cos(2 * xy[:, 1])])
        nrm = np.column_stack([-0.6 * np.cos(2 * xy[:, 0]),
                               0.48 * np.sin(2 * xy[:, 1]), np.ones(n)])
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        return pts @ rot.T, nrm @ rot.T

    src, _ = sample(np.eye(3))
    tgt, nrm = sample(z_rotation(8.0))
    return (src.astype(np.float32), (tgt + [0.05, -0.02, 0.03]).astype(
        np.float32), nrm.astype(np.float32))


def filterreg_batches(seed=5):
    """The FilterReg serving traffic: the 256 ragged rigid horse pairs of
    serving_batches (pt2pt), and 64 pt2pl pairs of 512 points, source and
    target two random subsets of the horse, the target rotated by Euler
    angles up to 10 degrees, shifted and given 5e-4 noise, with the PCA
    normals of the target subset."""
    from probreg_tpu_torch.utils import io, se3_op

    horse = io.read_point_cloud(data_path("horse.ply")).astype(np.float64)
    rng = np.random.default_rng(seed)
    pt2pl = []
    for _ in range(64):
        src = horse[rng.choice(len(horse), 512, replace=False)]
        tgt = horse[rng.choice(len(horse), 512, replace=False)]
        rot = se3_op.euler2mat(*np.deg2rad(rng.uniform(-10, 10, 3))
                               ).double().numpy()
        tgt = (tgt @ rot.T + rng.uniform(-0.01, 0.01, 3)
               + 5e-4 * rng.standard_normal(tgt.shape)).astype(np.float32)
        pt2pl.append((src.astype(np.float32), tgt, estimate_normals(tgt),
                      rot))
    return serving_batches()[0], pt2pl


# The FilterReg serving configurations: pt2pt anneals sigma2 by 0.9 per
# iteration (at its fixed cloud-scale start FilterReg stays 2-10 degrees off
# on these pairs); pt2pl starts at the point spacing.
FRG_SERVE = {"pt2pt": dict(sigma2_decay=0.9), "pt2pl": {}}


def frg_pair_check(name, src, tgt, nrm, objective, smask=None, tmask=None,
                   update_sigma2=False):
    """K5 against its plain version on one pair after 1 and 5 iterations
    (tol 0: only the order of the sums differs). Returns the largest |rot|,
    |t| error."""
    from probreg_tpu_torch.ops import frg_cuda as fc

    worst = 0.0
    for maxiter in (1, 5):
        kw = dict(w=0.0, maxiter=maxiter, tol=0.0, update_sigma2=update_sigma2,
                  sigma2_decay=0.9, min_sigma2=1e-4, auto_sigma2=True)
        batch = (src[None], tgt[None], None if nrm is None else nrm[None],
                 None if smask is None else smask[None],
                 None if tmask is None else tmask[None])
        got = fc.run_em_filterreg_fused_batch(*batch, objective=objective,
                                              **kw)
        want = fc.run_em_filterreg_fused_plain(
            *fc.compact_batch(*batch), pt2pl=objective == "pt2pl",
            sigma2_0=0.0, **kw)[0]
        torch.cuda.synchronize()
        d_rot = float((got[0][0].reshape(-1) - want[:9]).abs().max())
        d_t = float((got[1][0] - want[9:12]).abs().max())
        r_s2 = abs(float(got[2][0]) / float(want[12]) - 1.0)
        r_q = abs(float(got[3][0]) - float(want[13])) / max(
            abs(float(want[13])), 1e-3)
        log(f"  {name} {objective}{' update_sigma2' if update_sigma2 else ''}"
            f" maxiter {maxiter}: |rot| {d_rot:.2e} |t| {d_t:.2e} sigma2 rel "
            f"{r_s2:.2e} q rel {r_q:.2e}")
        # q of pt2pl is a sum of squared residuals that are small
        # differences: it carries the summation-order noise amplified.
        if not (d_rot <= 1e-5 and d_t <= 1e-5 and r_s2 <= 1e-5
                and r_q <= 1e-3 and int(got[4][0]) == maxiter):
            raise AssertionError(f"FilterReg whole-EM kernel disagrees with "
                                 f"its plain version: {name} {objective}")
        worst = max(worst, d_rot, d_t)
    return worst


def check_frg(dev, kernels):
    """K5 against run_em_filterreg_fused_plain on the card: single pairs
    (the bunny, a 1024 x 1024 surface pair, update_sigma2, a masked pair),
    then the two FilterReg batches that run_filterreg_batch drives, at a
    fixed depth, which give the kernels line its numbers."""
    from probreg_tpu_torch.ops import frg_cuda as fc

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    log("[K5 FilterReg whole EM] single pairs")
    src, tgt = bunny_clouds(z_rotation(10.0), seed=4)
    s_big, t_big, n_big = surface_pair(1024, 6)
    pairs = {"bunny 390": (t(src), t(tgt), t(estimate_normals(tgt))),
             "1024x1024": (t(s_big), t(t_big), t(n_big))}
    worst = {"pt2pt": 0.0, "pt2pl": 0.0}
    for name, (s, x, nv) in pairs.items():
        for obj in worst:
            worst[obj] = max(worst[obj], frg_pair_check(
                name, s, x, nv if obj == "pt2pl" else None, obj))
        m, n = s.shape[0], x.shape[0]
        for obj in worst:
            pt2pl = obj == "pt2pl"
            s_c, t_c, n_c, _ = fc.compact_batch(
                s[None], x[None], nv[None] if pt2pl else None)
            raw = dict(pt2pl=pt2pl, w=0.0, maxiter=50, tol=0.0,
                       update_sigma2=False, sigma2_decay=1.0, min_sigma2=1e-4,
                       auto_sigma2=True, sigma2_0=0.0)
            chans = 7 if pt2pl else 4
            b_ms, b_by = bound(12 * (m + 2 * n) + 64,
                               50 * m * n * flops_frg(chans))
            log_single_pair(f"{name} {obj}", lambda **k: fc._frg_cuda(
                s_c, t_c, n_c, None, **raw, **k), 50,
                f"bound {b_ms:.4f} ms ({b_by})")
    s, x, nv = pairs["1024x1024"]
    for obj in worst:
        worst[obj] = max(worst[obj], frg_pair_check(
            "1024x1024", s, x, nv if obj == "pt2pl" else None, obj,
            update_sigma2=True))
    rng = np.random.default_rng(7)
    k = s.shape[0]  # 700 and 900 of the 1024 points valid
    smask = torch.zeros(k, device=dev)
    tmask = torch.zeros(k, device=dev)
    smask[torch.as_tensor(rng.permutation(k)[:k * 700 // 1024])] = 1.0
    tmask[torch.as_tensor(rng.permutation(k)[:k * 900 // 1024])] = 1.0
    worst["pt2pl"] = max(worst["pt2pl"], frg_pair_check(
        "masked 700/900", s, x, nv, "pt2pl", smask, tmask))

    # The serving batches at a fixed depth (tol 0: both run exactly
    # EM_BATCH_ITERS iterations), through the wrapper (masks and their
    # compaction included) against the plain version on each pair's own
    # unpadded clouds; times and bound of that same run.
    rigid, pt2pl = filterreg_batches()
    for obj, batch in (("pt2pt", rigid), ("pt2pl", pt2pl)):
        srcs, tgts, smask, tmask = em_batch_tensors(batch, dev)
        nrms = None
        if obj == "pt2pl":  # fixed-size: no masks, as run_filterreg_batch
            nrms = torch.as_tensor(np.stack([p[2] for p in batch]),
                                   device=dev)
            smask = tmask = None
        args = dict(w=0.0, maxiter=EM_BATCH_ITERS, tol=0.0,
                    update_sigma2=False, min_sigma2=1e-4, auto_sigma2=True,
                    sigma2_decay=FRG_SERVE[obj].get("sigma2_decay", 1.0))
        n0 = fc.LAUNCHES["frg_" + obj]
        rot, tt, sigma2, _, it = fc.run_em_filterreg_fused_batch(
            srcs, tgts, nrms, smask, tmask, objective=obj, **args)
        n_launch = fc.LAUNCHES["frg_" + obj] - n0
        if not bool((it == EM_BATCH_ITERS).all()):
            raise AssertionError("FilterReg batch: wrong iteration count")
        own = [(t(p[0])[None], t(p[1])[None],
                t(p[2])[None] if obj == "pt2pl" else None) for p in batch]
        plain = dict(pt2pl=obj == "pt2pl", sigma2_0=0.0, **args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = torch.cat([fc.run_em_filterreg_fused_plain(s, x, nv, None,
                                                          **plain)
                          for s, x, nv in own])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = torch.cat([rot.reshape(-1, 9), tt], dim=1)
        err = float((got - want[:, :12]).abs().max())
        r_s2 = float((sigma2 / want[:, 12] - 1.0).abs().max())
        log(f"[K5 FilterReg whole EM] {obj} batch of {len(batch)}, "
            f"{EM_BATCH_ITERS} iterations, {n_launch} launch: max |rot|, |t| "
            f"{err:.2e}, sigma2 rel {r_s2:.2e}")
        if not (err <= 1e-5 and r_s2 <= 1e-5):
            raise AssertionError(f"FilterReg {obj} batch disagrees with its "
                                 "plain version")
        s_c, t_c, n_c, counts = fc.compact_batch(srcs, tgts, nrms, smask,
                                                 tmask)
        raw = dict(plain)
        ms = timed(lambda: fc._frg_cuda(s_c, t_c, n_c, counts, **raw), 5)
        log_launch_plan(lambda **k: fc._frg_cuda(s_c, t_c, n_c, counts,
                                                 **raw, **k),
                        counts, len(batch))
        sizes = torch.tensor([[p[0].shape[0], p[1].shape[0]] for p in batch],
                             dtype=torch.float64)
        pair_its = float(sizes.prod(1).sum()) * EM_BATCH_ITERS
        chans = 7 if obj == "pt2pl" else 4
        nbytes = float(12 * sizes[:, 0].sum()
                       + (24 if obj == "pt2pl" else 12) * sizes[:, 1].sum()
                       + 64 * len(batch))
        b_ms, b_by = bound(nbytes, pair_its * flops_frg(chans))
        log(f"  kernel {ms:.3f} ms  plain {plain_ms:.1f} ms (a host loop "
            f"over the pairs)  bound {b_ms:.4f} ms ({b_by}), "
            f"{pair_its:.4g} pair-iterations")
        kernels["frg_" + obj] = dict(max_abs_err=max(err, worst[obj]), ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by)


def check_gt(dev, kernels):
    """K6 against its plain version on the 150k clouds, as the streaming
    FilterReg E-step calls it (points: the target / sigma; queries: the
    transformed source / sigma; h = sqrt 2): dense at the run's sigma2_0
    with 4, 5 (update_sigma2's [1, x, |x|^2]) and 8 channels, culled at
    sigma2 = 1e-3, with M != N in one case; then the wrapper with sort=True
    on unsorted clouds and sort=False on sorted ones."""
    from probreg_tpu_torch.ops import gt_cuda as gc
    from probreg_tpu_torch.ops.spatial import morton_order
    from probreg_tpu_torch.utils import math_utils

    # The clouds Morton-sorted once, as the streaming loop holds them, and
    # its automatic sigma2_0.
    src, tgt, _ = large_clouds(dev)
    src, tgt = torch.as_tensor(src, device=dev), torch.as_tensor(tgt,
                                                                 device=dev)
    ys, xs = src[morton_order(src)], tgt[morton_order(tgt)]
    sigma2_0 = float(math_utils.squared_kernel_sum(ys, xs))
    rng = np.random.default_rng(8)
    nrm = torch.as_tensor(rng.normal(size=xs.shape), dtype=torch.float32,
                          device=dev)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    out = {}
    for label, sigma2, chans, n in (("dense", sigma2_0, 4, None),
                                    ("dense C=5", sigma2_0, 5, None),
                                    ("dense C=8", sigma2_0, 8, None),
                                    ("culled", 1e-3, 4, None),
                                    ("dense M != N", sigma2_0, 4, 120_000)):
        x = xs[:n] if n else xs
        w = torch.cat([torch.ones_like(x[:, :1]), x]
                      + ([(x * x).sum(1, keepdim=True)] if chans > 4 else [])
                      + ([nrm[:x.shape[0]]] if chans == 8 else []), dim=1)
        sigma = sigma2 ** 0.5
        ps, qs = x / sigma, ys / sigma
        cen = (ps.sum(0) + qs.sum(0)) / (ps.shape[0] + qs.shape[0])
        prep = gc.prepare(ps - cen, qs - cen, w, 2.0 ** 0.5)
        mask = prep[4]
        rows = torch.full((mask.shape[1],), float(gc._ROWS), device=dev)
        rows[-1] = qs.shape[0] - (rows.numel() - 1) * gc._ROWS
        cols = torch.full((mask.shape[0],), float(prep[5]), device=dev)
        cols[-1] = ps.shape[0] - (cols.numel() - 1) * prep[5]
        pairs = float(cols @ mask.float() @ rows)
        blocks, threads = gc.launch_shape(qs.shape[0])
        log(f"[K6 gauss_transform] {label}: sigma2 {sigma2:.6g}, "
            f"{qs.shape[0]} x {ps.shape[0]}, C = {chans}, active tile "
            f"fraction {float(mask.float().mean()):.4f}, active pairs "
            f"{pairs:.4g}; {blocks} blocks of {threads} threads, "
            f"{gc.ROWS_PER_THREAD} rows a thread, {gc.SLOTS} stages at once")
        n0 = gc.LAUNCHES["gauss_transform"]
        got = gc.gt_core(*prep)
        want = gc.gauss_transform_culled_plain(*prep)
        torch.cuda.synchronize()
        log(f"  {gc.LAUNCHES['gauss_transform'] - n0} launch")
        err = compare("out", got, want)
        del got, want
        ms = timed(gc.gt_launcher(*prep)[0], 5)
        plain_ms = timed(lambda: gc.gauss_transform_culled_plain(*prep), 2)
        nq, m = qs.shape[0], ps.shape[0]
        b_ms, b_by = bound(4 * (3 * (nq + m) + chans * (m + nq)),
                           pairs * flops_frg(chans))
        log(f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
            f"{b_ms:.3f} ms ({b_by})")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
    # The wrapper's own centring, sort and unsort, against the same path
    # with the plain version in place of the launch.
    sigma = sigma2_0 ** 0.5
    core = gc.gt_core
    for label, (p, q), sort in (("sort=True, unsorted", (tgt, src), True),
                                ("sort=False, sorted", (xs, ys), False)):
        w = torch.cat([torch.ones_like(p[:, :1]), p], dim=1)
        got = gc.gauss_transform_culled(p / sigma, q / sigma, w, 2.0 ** 0.5,
                                        sort=sort)
        gc.gt_core = gc.gauss_transform_culled_plain
        try:
            want = gc.gauss_transform_culled(p / sigma, q / sigma, w,
                                             2.0 ** 0.5, sort=sort)
        finally:
            gc.gt_core = core
        torch.cuda.synchronize()
        log(f"[K6 gauss_transform] wrapper, {label}:")
        err = compare("out", got, want)
        out["dense"]["max_abs_err"] = max(out["dense"]["max_abs_err"], err)
    kernels["gauss_transform"] = dict(
        out["dense"], max_abs_err=max(v["max_abs_err"] for v in out.values()))


def run_filterreg_large(dev, launches):
    """registration_filterreg on the 150k clouds of
    examples/largescale_rigid.py: the streaming EM, one K6 launch per E-step
    and no plain-version call."""
    from probreg_tpu_torch import filterreg
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.ops import gt_cuda as gc
    from probreg_tpu_torch.utils import se3_op

    src, tgt, rot = large_clouds(dev)
    kw = dict(maxiter=40, tol=1e-8, sigma2_decay=0.9)
    log(f"[FilterReg path] registration_filterreg rigid, {N_LARGE:,} points, "
        "maxiter 40, tol 1e-8, sigma2_decay 0.9")
    t0 = time.perf_counter()
    filterreg.registration_filterreg(src, tgt, **kw)
    torch.cuda.synchronize()
    log(f"  warm call {time.perf_counter() - t0:.3f} s")
    masks = []
    active_mask, plain = ec._active_mask, gc.gauss_transform_culled_plain

    def recording_mask(*a):  # observes each E-step's tile mask
        mask = active_mask(*a)
        masks.append(mask.float().mean())
        return mask

    def refuse(*a):
        raise AssertionError("the plain Gauss transform ran on the card")

    ec._active_mask, gc.gauss_transform_culled_plain = recording_mask, refuse
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = filterreg.registration_filterreg(src, tgt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ec._active_mask, gc.gauss_transform_culled_plain = active_mask, plain
    n_gt = all_launches()["gauss_transform"]
    expect_launches("150k FilterReg", gauss_transform=len(masks))
    launches["gauss_transform"] = n_gt
    peak = torch.cuda.max_memory_allocated()
    err = float(se3_op.rotation_angle(res.transformation.rot.cpu().double(),
                                      torch.as_tensor(rot).double()))
    ang = np.rad2deg(se3_op.mat2euler(res.transformation.rot.cpu()).numpy())
    log(f"  timed call {wall:.3f} s, E-steps {len(masks)}, gauss_transform "
        f"launches {n_gt}, final sigma2 {float(res.sigma2):.6g}, rotation "
        f"error {err:.3e} rad, recovered {np.round(ang, 3).tolist()} deg")
    log(f"  active tile fraction: first E-step {float(masks[0]):.4f}, last "
        f"{float(masks[-1]):.4f}; peak memory {peak / 2**30:.3f} GiB")
    if not (n_gt == 40 and math.isfinite(float(res.sigma2))
            and err <= FRG_ROT_ERR_MAX):
        raise AssertionError(f"150k FilterReg wrong: {n_gt} launches, "
                             f"rotation error {err}")
    # The same registration with the plain version in place of every
    # launch, at a smaller depth: the kernel may change only sum orders.
    kw["maxiter"] = COMPARE_ITERS
    res = filterreg.registration_filterreg(src, tgt, **kw)
    core = gc.gt_core
    gc.gt_core = gc.gauss_transform_culled_plain
    try:
        t0 = time.perf_counter()
        ref = filterreg.registration_filterreg(src, tgt, **kw)
        torch.cuda.synchronize()
    finally:
        gc.gt_core = core
    d_rot = float((res.transformation.rot - ref.transformation.rot)
                  .abs().max())
    d_t = float((res.transformation.t - ref.transformation.t).abs().max())
    log(f"  plain-version registration, {COMPARE_ITERS} iterations, "
        f"{time.perf_counter() - t0:.3f} s: max |rot diff| {d_rot:.3e}, "
        f"max |t diff| {d_t:.3e}")
    if not (d_rot <= 1e-4 and d_t <= 1e-4):
        raise AssertionError("kernel and plain FilterReg registrations "
                             "disagree")


def run_filterreg_bunny(dev, launches):
    """examples/filterreg_rigid.py (pt2pt) and filterreg_rigid_pt2pl.py
    (pt2pl, PCA normals): each one K5 launch, held to the port's own dense
    loop _run_em_rigid run to the kernel's iteration count (at tol 1e-3 the
    two would stop apart while a pt2pt pair with a fixed sigma2 still
    moves)."""
    from probreg_tpu_torch import filterreg
    from probreg_tpu_torch.ops import frg_cuda as fc
    from probreg_tpu_torch.utils import se3_op

    src, tgt = bunny_clouds(z_rotation(10.0), seed=4)
    nrm = estimate_normals(tgt)
    ys, xs = torch.as_tensor(src, device=dev), torch.as_tensor(tgt, device=dev)
    ns = torch.as_tensor(nrm, device=dev)
    for obj in ("pt2pt", "pt2pl"):
        kw = dict(objective_type=obj,
                  target_normals=nrm if obj == "pt2pl" else None)
        filterreg.registration_filterreg(src, tgt, **kw)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = filterreg.registration_filterreg(src, tgt, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"[FilterReg bunny] {obj}, {src.shape[0]} points, second call "
            f"{wall:.3f} ms")
        expect_launches(f"FilterReg bunny {obj}", **{f"frg_{obj}": 1})
        its = int(fc.run_em_filterreg_fused_batch(
            ys[None], xs[None], ns[None] if obj == "pt2pl" else None,
            objective=obj)[4][0])
        t0 = time.perf_counter()
        dense = filterreg._run_em_rigid(
            ys, xs, ns if obj == "pt2pl" else None, torch.eye(3, device=dev),
            torch.zeros(3, device=dev), 0.0, objective_type=obj,
            update_sigma2=False, w=0.0, maxiter=its, tol=0.0, min_sigma2=1e-4,
            auto_sigma2=True)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
        tr, tr_d = res.transformation, dense.transformation
        d_ang = float(se3_op.rotation_angle(tr.rot.double(),
                                            tr_d.rot.double()))
        ang = np.rad2deg(se3_op.mat2euler(tr.rot.cpu()).numpy())
        log(f"  {its} iterations; dense loop {loop_ms:.1f} ms; rotation "
            f"against it {d_ang:.2e}"
            f" rad, |t| {float((tr.t - tr_d.t).abs().max()):.2e}, recovered "
            f"Euler {np.round(ang, 3).tolist()} deg (the JAX package's "
            "example on the CPU: [2.543, -0.281, 12.059] pt2pt, [0.076, "
            "-0.485, 8.831] pt2pl)")
        if not (d_ang <= 2e-4
                and np.allclose(ang, [0.0, 0.0, 10.0], atol=3.5)):
            raise AssertionError(f"FilterReg bunny {obj} wrong")


def run_filterreg_batch(dev, launches):
    """registration_filterreg_batch on the FilterReg serving batches: one K5
    launch each, every pair equal to its single-pair registration."""
    from probreg_tpu_torch import filterreg
    from probreg_tpu_torch.utils import se3_op

    rigid, pt2pl = filterreg_batches()
    for obj, batch in (("pt2pt", rigid), ("pt2pl", pt2pl)):
        srcs, tgts = [p[0] for p in batch], [p[1] for p in batch]
        kw = dict(objective_type=obj, **FRG_SERVE[obj])
        if obj == "pt2pl":  # fixed-size: arrays, no masks
            srcs, tgts = np.stack(srcs), np.stack(tgts)
            kw["target_normals"] = np.stack([p[2] for p in batch])
        filterreg.registration_filterreg_batch(srcs, tgts, **kw)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = filterreg.registration_filterreg_batch(srcs, tgts, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"[FilterReg batch] registration_filterreg_batch {obj}, "
            f"{len(batch)} pairs, second call {wall:.2f} ms "
            f"({wall / len(batch):.3f} ms per pair)")
        expect_launches(f"FilterReg {obj} batch", **{f"frg_{obj}": 1})
        launches[f"frg_{obj}"] = 1
        errs, d_single = [], 0.0
        for b, (p, r) in enumerate(zip(batch, res)):
            one_kw = dict(kw)
            if obj == "pt2pl":
                one_kw["target_normals"] = p[2]
            one = filterreg.registration_filterreg(p[0], p[1], **one_kw)
            errs.append(np.rad2deg(float(se3_op.rotation_angle(
                r.transformation.rot.cpu().double(), torch.as_tensor(p[-1])))))
            d_single = max(d_single,
                           float((one.transformation.rot
                                  - r.transformation.rot).abs().max()),
                           float((one.transformation.t
                                  - r.transformation.t).abs().max()))
        log(f"  deg rotation error: max {max(errs):.4f} median "
            f"{np.median(errs):.4f}; max difference to the single-pair "
            f"registrations {d_single:.2e}")
        limit = (5.0, 1.5) if obj == "pt2pt" else (5.0, 2.5)
        if not (max(errs) <= limit[0] and np.median(errs) <= limit[1]
                and d_single <= 1e-6):
            raise AssertionError(f"FilterReg {obj} batch registration wrong")


# --------------------------------------------------------------------------
# ICP: the whole-ICP kernel (K7)
# --------------------------------------------------------------------------

def horse_pair_1024(seed=9):
    """Two different random subsets of 1024 points of data/horse.ply, the
    target rotated 10 degrees about z and shifted."""
    from probreg_tpu_torch.utils import io

    horse = io.read_point_cloud(data_path("horse.ply")).astype(np.float64)
    rng = np.random.default_rng(seed)
    src = horse[rng.choice(len(horse), 1024, replace=False)]
    tgt = horse[rng.choice(len(horse), 1024, replace=False)] @ z_rotation(
        10.0).T + 0.005
    return src.astype(np.float32), tgt.astype(np.float32)


def icp_compare(name, srcs, tgts, smask, tmask, own):
    """K7 through its wrapper (masks and compaction included) against its
    plain version on each pair's own unpadded clouds, at ICP_ITERS
    iterations (tol 0: both run exactly that many). Per pair, rot and t to
    1e-4 and the rmse to 1e-4 relative: the two differ in the order of the
    sums and in FMA contraction, and a match between two targets within
    ~1e-7 of a tie may go either way. Returns (max |rot|, |t| error, the
    plain version's ms over the pairs)."""
    from probreg_tpu_torch.ops import icp_cuda as ic

    kw = dict(maxiter=ICP_ITERS, tol=0.0)
    rot, t, rmse, it = ic.run_icp_fused_batch(srcs, tgts, smask, tmask, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = torch.cat([ic.run_icp_fused_plain(s, x, None, None, **kw)
                      for s, x in own])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (torch.cat([rot.reshape(-1, 9), t], 1) - want[:, :12]).abs().amax(1)
    r_rmse = (rmse / want[:, 12] - 1.0).abs()
    log(f"  {name}: {len(own)} pair(s), max |rot|, |t| {float(err.max()):.2e}"
        f" (median {float(err.median()):.2e}), rmse rel "
        f"{float(r_rmse.max()):.2e}, iterations {int(it.min())}-"
        f"{int(it.max())}")
    if not (bool((it == ICP_ITERS).all()) and float(err.max()) <= 1e-4
            and float(r_rmse.max()) <= 1e-4):
        raise AssertionError(f"whole-ICP kernel disagrees with its plain "
                             f"version: {name}")
    return float(err.max()), plain_ms


def check_icp(dev, kernels):
    """K7 against run_icp_fused_plain on the card: the bunny pair, one
    1024 x 1024 horse pair and the 256 ragged horse pairs that run_icp_batch
    drives, at a fixed depth; the batch gives the kernels line its
    numbers."""
    from probreg_tpu_torch.ops import icp_cuda as ic

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    log(f"[K7 whole ICP] kernel against its plain version, {ICP_ITERS} "
        "iterations, tol 0")
    worst = 0.0
    singles = {"bunny": bunny_clouds(z_rotation(10.0), seed=4),
               "horse 1024x1024": horse_pair_1024()}
    for name, (s, x) in singles.items():
        s, x = t(s)[None], t(x)[None]
        worst = max(worst, icp_compare(name, s, x, None, None, [(s, x)])[0])
        m, n = s.shape[1], x.shape[1]
        b_ms, b_by = bound(12 * (m + n) + 64, ICP_ITERS * m * n * FLOPS_ICP)
        log_single_pair(name, lambda **k: ic._icp_cuda(
            s, x, None, None, maxiter=ICP_ITERS, tol=0.0, **k), ICP_ITERS,
            f"bound {b_ms:.5f} ms ({b_by})")
    rigid = serving_batches()[0]
    srcs, tgts, smask, tmask = em_batch_tensors(rigid, dev)
    own = [(t(p[0])[None], t(p[1])[None]) for p in rigid]
    err, plain_ms = icp_compare("serving batch", srcs, tgts, smask, tmask,
                                own)
    worst = max(worst, err)
    s_c, t_c, counts = ic.compact_batch(srcs, tgts, smask, tmask)
    ms = timed(lambda: ic._icp_cuda(s_c, t_c, counts, None,
                                    maxiter=ICP_ITERS, tol=0.0), 5)
    log_launch_plan(lambda **k: ic._icp_cuda(s_c, t_c, counts, None,
                                             maxiter=ICP_ITERS, tol=0.0, **k),
                    counts, len(rigid))
    sizes = torch.tensor([[p[0].shape[0], p[1].shape[0]] for p in rigid],
                         dtype=torch.float64)
    pair_its = float(sizes.prod(1).sum()) * ICP_ITERS
    b_ms, b_by = bound(float(12 * sizes.sum() + 64 * len(rigid)),
                       pair_its * FLOPS_ICP)
    log(f"  batch kernel {ms:.3f} ms  plain {plain_ms:.1f} ms (a host loop "
        f"over the pairs)  bound {b_ms:.4f} ms ({b_by}), {pair_its:.4g} "
        "pair-iterations")
    kernels["icp"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)


def run_icp_bunny(dev, launches):
    """examples/icp_comparison.py: registration_icp on the bunny rotated 10
    degrees about z, one K7 launch; then the same at a fixed depth against
    the run with the plain version in place of the launch."""
    from probreg_tpu_torch import icp
    from probreg_tpu_torch.ops import icp_cuda as ic
    from probreg_tpu_torch.utils import se3_op

    src, tgt = bunny_clouds(z_rotation(10.0), seed=4)
    kw = dict(maxiter=100, tol=1e-8)
    icp.registration_icp(src, tgt, **kw)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = icp.registration_icp(src, tgt, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    expect_launches("ICP bunny", icp=1)
    launches["icp"] = 1
    ang = np.rad2deg(se3_op.mat2euler(res.transformation.rot.cpu()).numpy())
    log(f"[ICP bunny] registration_icp, {src.shape[0]} points, maxiter 100, "
        f"tol 1e-8: second call {wall:.3f} ms, {res.n_iter} iterations, rmse "
        f"{float(res.rmse):.4e}, recovered Euler "
        f"{np.round(ang, 4).tolist()} deg")
    fixed = dict(maxiter=ICP_ITERS, tol=0.0)
    got = icp.registration_icp(src, tgt, **fixed)
    launch = ic._icp_cuda
    ic._icp_cuda = ic.run_icp_fused_plain
    try:
        ref = icp.registration_icp(src, tgt, **fixed)
    finally:
        ic._icp_cuda = launch
    d_rot = float((got.transformation.rot - ref.transformation.rot)
                  .abs().max())
    d_t = float((got.transformation.t - ref.transformation.t).abs().max())
    log(f"  against the plain-driven run at {ICP_ITERS} iterations: |rot| "
        f"{d_rot:.2e}, |t| {d_t:.2e}")
    if not (d_rot <= 1e-4 and d_t <= 1e-4
            and np.allclose(ang, [0.0, 0.0, 10.0], atol=0.5)):
        raise AssertionError("ICP bunny wrong")


def run_icp_batch(dev, launches):
    """registration_icp_batch on the 256 ragged horse pairs: one K7 launch,
    every pair equal bit for bit to its single-pair registration."""
    from probreg_tpu_torch import icp
    from probreg_tpu_torch.utils import se3_op

    rigid = serving_batches()[0]
    srcs, tgts = [p[0] for p in rigid], [p[1] for p in rigid]
    icp.registration_icp_batch(srcs, tgts)  # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = icp.registration_icp_batch(srcs, tgts)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"[ICP batch] registration_icp_batch, {len(rigid)} ragged pairs, "
        f"second call {wall:.2f} ms ({wall / len(rigid):.3f} ms per pair)")
    expect_launches("ICP batch", icp=1)
    errs, d_single = [], 0.0
    for (src, tgt, rot), r in zip(rigid, res):
        one = icp.registration_icp(src, tgt).transformation
        errs.append(np.rad2deg(float(se3_op.rotation_angle(
            r.transformation.rot.cpu().double(), torch.as_tensor(rot)))))
        d_single = max(d_single,
                       float((one.rot - r.transformation.rot).abs().max()),
                       float((one.t - r.transformation.t).abs().max()))
    iters = [r.n_iter for r in res]
    log(f"  deg rotation error: max {max(errs):.4f} median "
        f"{np.median(errs):.4f}; iterations {min(iters)}-{max(iters)}; max "
        f"difference to the single-pair registrations {d_single:.2e}")
    if not (d_single == 0.0 and np.median(errs) <= 1.5 and max(errs) <= 5.0):
        raise AssertionError("ICP batch registration wrong")


def run_icp_large(dev, launches):
    """registration_icp past K7's gate, on the 150k clouds of
    examples/largescale_rigid.py (maxiter 10): the plain torch loop, no
    kernel."""
    from probreg_tpu_torch import icp
    from probreg_tpu_torch.ops import icp_cuda as ic
    from probreg_tpu_torch.utils import se3_op

    src, tgt, rot = large_clouds(dev)
    if ic.fused_dims_ok(N_LARGE, N_LARGE):
        raise AssertionError("150k pair inside the whole-ICP gate")
    reset_launches()
    t0 = time.perf_counter()
    res = icp.registration_icp(src, tgt, maxiter=10, tol=1e-8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches("150k ICP")
    err = float(se3_op.rotation_angle(res.transformation.rot.cpu().double(),
                                      torch.as_tensor(rot).double()))
    start = float(se3_op.rotation_angle(torch.eye(3, dtype=torch.float64),
                                        torch.as_tensor(rot).double()))
    log(f"[ICP 150k] registration_icp, {N_LARGE:,} points, maxiter 10 (past "
        f"the kernel's gate: the plain loop): {wall:.3f} s, {res.n_iter} "
        f"iterations, rmse {float(res.rmse):.4e}, rotation error {err:.3e} "
        f"rad (from {start:.3e})")
    if not (math.isfinite(float(res.rmse)) and err < start):
        raise AssertionError("150k ICP wrong")


# --------------------------------------------------------------------------
# BCPD: the row-weighted culled E-step (K8)
# --------------------------------------------------------------------------

def bcpd_clouds():
    """benchmarks/bench_bcpd_guarded.py's fixture at 100k points: (src,
    tgt, rot)."""
    from probreg_tpu_torch.utils import se3_op
    from probreg_tpu_torch.utils.datagen import blobby_surface

    src = blobby_surface(N_BCPD, seed=2).astype(np.float32)
    rot = se3_op.euler2mat(*np.deg2rad([8.0, -4.0, 6.0])).numpy()
    defo = (0.02 * np.sin(3.0 * src[:, :1])
            * np.array([[1.0, 0.5, -0.3]])).astype(np.float32)
    tgt = ((src + defo) @ rot.T).astype(np.float32)
    return src, tgt, rot


def wstash_inputs(dev):
    """The 100k BCPD clouds as the VI loop holds them (normalized as
    registration_bcpd does, Morton-sorted), their channel matrix, seeded row
    weights and the exact nearest neighbours."""
    from probreg_tpu_torch import icp
    from probreg_tpu_torch.ops.spatial import morton_order
    from probreg_tpu_torch.utils import math_utils as mu

    src, tgt, _ = bcpd_clouds()
    s64, t64 = src.astype(np.float64), tgt.astype(np.float64)
    centroid = np.concatenate([s64, t64]).mean(0)
    scale = math.sqrt(mu.squared_kernel_sum_np(s64, t64))
    ys = torch.as_tensor((s64 - centroid) / scale, dtype=torch.float32,
                         device=dev)
    xs = torch.as_tensor((t64 - centroid) / scale, dtype=torch.float32,
                         device=dev)
    ys, xs = ys[morton_order(ys)], xs[morton_order(xs)]
    x2 = (xs * xs).sum(1)
    v_t = torch.cat([xs.T, torch.ones_like(x2)[None], x2[None]])
    rng = np.random.default_rng(10)
    alpha = torch.as_tensor(rng.uniform(0.5, 1.5, N_BCPD) / N_BCPD,
                            dtype=torch.float32, device=dev)
    nn_d2, nn_idx = icp._nearest_t(ys.T, xs.T)
    return ys, xs, v_t, alpha, nn_d2, nn_idx


def check_wstash(dev, kernels):
    """K8 against its plain version on the 100k clouds, at the start
    temperature (everything dense) and at sigma2 = 1e-3 (a share of the
    tiles culled): nu_d, the moments and e1 to 1e-4 of their largest entry
    (compare()); dmin below the true nearest-neighbour d2 everywhere and
    equal to it (1e-6: both in the expanded form, rounded apart) wherever
    the nearest neighbour lies in an active tile."""
    from probreg_tpu_torch.ops import bcpd_cuda as bc
    from probreg_tpu_torch.utils import math_utils as mu

    ys, xs, v_t, alpha, nn_d2, nn_idx = wstash_inputs(dev)
    m, n, dim, c = ys.shape[0], xs.shape[0], 3, v_t.shape[0]
    sigma2_0 = float(mu.squared_kernel_sum(ys, xs))
    w_over_n = 0.1 / n  # an outlier weight w = 0.1, so nu_d is not all 1
    out = {}
    for regime, sigma2 in (("dense", sigma2_0), ("culled", 1e-3)):
        rowlog = torch.log(0.9 * alpha) - dim * 0.5 * math.log(
            2.0 * math.pi * sigma2)
        got = bc.bcpd_estep_culled(ys, xs, rowlog, v_t, w_over_n, sigma2)
        core = bc.wstash_estep
        bc.wstash_estep = bc.wstash_estep_plain
        try:
            want = bc.bcpd_estep_culled(ys, xs, rowlog, v_t, w_over_n,
                                        sigma2)
        finally:
            bc.wstash_estep = core
        torch.cuda.synchronize()
        tile_m, tile_n = 1024, 1024
        inv2s2 = torch.tensor(0.5 / sigma2, device=dev)
        mask, _ = bc.cull_mask(ys, xs, rowlog, inv2s2, tile_m, tile_n)
        rows = torch.full((mask.shape[0],), float(tile_m), device=dev)
        rows[-1] = m - (rows.numel() - 1) * tile_m
        cols = torch.full((mask.shape[1],), float(tile_n), device=dev)
        cols[-1] = n - (cols.numel() - 1) * tile_n
        pairs = float(rows @ mask.float() @ cols)
        log(f"[K8 wstash] {regime}: sigma2 {sigma2:.6g}, {m} x {n}, tiles "
            f"{tile_m} x {tile_n}, active tile fraction "
            f"{float(mask.float().mean()):.4f}, active pairs {pairs:.4g}")
        err_a = compare("nu_d", got[0], want[0])
        err_b = max(compare("mom", got[1], want[1]),
                    compare("e1", got[3], want[3]))
        dmin = got[2]
        in_active = mask[torch.arange(m, device=dev) // tile_m,
                         nn_idx // tile_n]
        over = float((dmin - nn_d2).max())
        off = float((dmin - nn_d2)[in_active].abs().max())
        log(f"  dmin - true NN d2: max {over:.2e} (a lower bound), max "
            f"|diff| {off:.2e} on the {int(in_active.sum())} rows whose "
            f"nearest neighbour lies in an active tile; against the plain "
            f"version {float((dmin - want[2]).abs().max()):.2e}")
        if not (over <= 1e-6 and off <= 1e-6):
            raise AssertionError("K8 dmin is not the nearest-neighbour bound")
        del got, want
        sc = torch.stack([inv2s2, torch.tensor(w_over_n, device=dev),
                          torch.tensor(torch.finfo(torch.float32).eps,
                                       device=dev)])
        peak = estep_peak_mib(lambda: bc.wstash_estep(
            ys, xs, rowlog, v_t, sc, mask, tile_m, tile_n))
        plan = bc.WStashPlan(ys, xs, rowlog, v_t, sc, mask, tile_m, tile_n)
        ms_a, ms_b = timed(plan.den, 3), timed(plan.moment, 3)
        del plan
        pa, pb = wstash_plain_times(ys, xs, rowlog, v_t, sc, mask, tile_m,
                                    tile_n)
        fa, fb = flops_wstash(c)
        # Each pass's own inputs and outputs; the stash is not charged.
        ba = bound(16 * m + 12 * n + 8 * n, pairs * fa)
        bb = bound(16 * m + 12 * n + 4 * (c + 1) * n + 4 * (c + 2) * m,
                   pairs * fb)
        log(f"  one E-step: peak device memory {peak:.3f} MiB above its "
            f"inputs ({m:,} x {tile_n} f32 would be "
            f"{4 * m * tile_n / 2**20:.1f} MiB)")
        log(f"  pass A kernel {ms_a:.3f} ms  plain {pa:.3f} ms  bound "
            f"{ba[0]:.3f} ms ({ba[1]})")
        log(f"  pass B kernel {ms_b:.3f} ms  plain {pb:.3f} ms  bound "
            f"{bb[0]:.3f} ms ({bb[1]})")
        out[regime] = (err_a, err_b, ms_a, ms_b, pa, pb, ba, bb)
    # The kernels line carries the dense E-step (the first iterations of the
    # 100k run); the culled numbers are printed above.
    err_a, err_b, ms_a, ms_b, pa, pb, ba, bb = out["dense"]
    kernels["wstash_den"] = dict(max_abs_err=max(err_a, out["culled"][0]),
                                 ms=ms_a, plain_ms=pa, bound_ms=ba[0],
                                 bound_by=ba[1])
    kernels["wstash_moment"] = dict(max_abs_err=max(err_b, out["culled"][1]),
                                    ms=ms_b, plain_ms=pb, bound_ms=bb[0],
                                    bound_by=bb[1])


def wstash_plain_times(ys, xs, rowlog, v_t, scal, mask, tile_m, tile_n):
    """ms of the plain passes A and B over all stripes, each stripe between
    its own events."""
    from probreg_tpu_torch.ops import bcpd_cuda as bc

    m = ys.shape[0]
    y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)
    mom = ys.new_zeros((v_t.shape[0], m))
    dmin = ys.new_full((m,), math.inf)
    e1 = ys.new_zeros(())
    pa = pb = 0.0
    for j in range(mask.shape[1]):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        act = mask[:, j].repeat_interleave(tile_m)[:m]
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        g, d2, inv_den, _ = bc._plain_den(ys, y2, rowlog, xs[cols], x2[cols],
                                          scal, act, mask.shape[0], tile_m)
        e[1].record()
        p = g * inv_den[None, :]
        mom += v_t[:, cols] @ p.T
        dmin = torch.minimum(dmin, torch.where(act[:, None], d2,
                                               math.inf).amin(1))
        e1 += (p * d2).sum()
        e[2].record()
        torch.cuda.synchronize()
        pa += e[0].elapsed_time(e[1])
        pb += e[1].elapsed_time(e[2])
        del g, d2, p
    return pa, pb


def run_bcpd_large(dev, launches):
    """registration_bcpd at 100k, rank 64: every E-step through K8 (one
    launch of each pass), no plain-version call; quality by the
    full-target NN-RMSE; then 3 iterations against the plain-driven run."""
    from probreg_tpu_torch import bcpd
    from probreg_tpu_torch.ops import bcpd_cuda as bc
    from probreg_tpu_torch.utils import math_utils as mu
    from probreg_tpu_torch.utils import se3_op

    src, tgt, rot = bcpd_clouds()
    log(f"[BCPD path] registration_bcpd, {N_BCPD:,} points, {BCPD_ARGS}")
    t0 = time.perf_counter()
    bcpd.registration_bcpd(src, tgt, **BCPD_ARGS)
    torch.cuda.synchronize()
    log(f"  warm call {time.perf_counter() - t0:.3f} s")
    masks = []
    cull, plain = bc.cull_mask, bc.wstash_estep_plain

    def recording(*a):  # observes each E-step's tile mask
        mask, lb2 = cull(*a)
        masks.append(mask.float().mean())
        return mask, lb2

    def refuse(*a):
        raise AssertionError("the plain row-weighted E-step ran on the card")

    bc.cull_mask, bc.wstash_estep_plain = recording, refuse
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = bcpd.registration_bcpd(src, tgt, **BCPD_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = all_launches()
    finally:
        bc.cull_mask, bc.wstash_estep_plain = cull, plain
    peak = torch.cuda.max_memory_allocated()
    launches.update(wstash_den=got["wstash_den"],
                    wstash_moment=got["wstash_moment"])
    expect_launches("100k BCPD", wstash_den=len(masks),
                    wstash_moment=len(masks))
    src_t = torch.as_tensor(src, device=dev)
    tgt_t = torch.as_tensor(tgt, device=dev)
    before = float(mu.compute_rmse(src_t, tgt_t))
    after = float(mu.compute_rmse(res.transform(src), tgt_t))
    rt = res.rigid_trans
    err = float(se3_op.rotation_angle(rt.rot.cpu().double(),
                                      torch.as_tensor(rot).double()))
    ang = np.rad2deg(se3_op.mat2euler(rt.rot.cpu()).numpy())
    log(f"  timed call {wall:.3f} s, {len(masks) - 1} VI iterations and the "
        f"final scoring ({len(masks)} E-steps, {got['wstash_den']} launches "
        f"of each pass), peak memory {peak / 2**30:.3f} GiB")
    log(f"  active tile fraction: first E-step {float(masks[0]):.4f}, last "
        f"VI iteration {float(masks[-2]):.4f}, final scoring "
        f"{float(masks[-1]):.4f}")
    log(f"  full-target NN-RMSE {before:.6f} before, {after:.6f} after; "
        f"rotation error {err:.3e} rad, recovered Euler "
        f"{np.round(ang, 3).tolist()} deg (true [8, -4, 6]), scale "
        f"{float(rt.scale):.5f}")
    if not (math.isfinite(after) and after < before):
        raise AssertionError("100k BCPD did not bring the source closer")
    # The same registration with the plain version in place of every pair
    # of launches, compared on the final VI iterate (return_last: the
    # best-visited result may be the starting state) and on the moved
    # source. The low-rank VI amplifies rounding: each M-step's K x K solve
    # is ill-conditioned at the start, so a change of the summation order
    # alone moves the iterate by ~1e-4 after one iteration and ~1e-3 after
    # three at these 100k points. So the tolerance is that spread, measured
    # in this run between two plain versions that differ only in their
    # summation order (tiles of 1024 and of 512): at each depth the kernel
    # stays within 10x of it.
    for depth in (1, BCPD_COMPARE_ITERS):
        t0 = time.perf_counter()
        plain = bcpd_final_iterate(src, tgt, depth, plain=True)
        plain_ms = (time.perf_counter() - t0) * 1e3
        kern = bcpd_final_iterate(src, tgt, depth)
        other = bcpd_final_iterate(src, tgt, depth, plain=True, tiles=512)
        got, ref = bcpd_spread(src, kern, plain), bcpd_spread(src, other,
                                                              plain)
        for label, d in (("kernel - plain", got),
                         ("plain, tiles 512 - plain", ref)):
            log(f"  {depth} iteration(s), {label}: max |diff| "
                + ", ".join(f"{k} {v:.2e}" for k, v in d.items()))
        log(f"  (the plain-driven run took {plain_ms:.0f} ms)")
        if not all(got[k] <= max(10.0 * ref[k], 1e-6) for k in got):
            raise AssertionError("kernel and plain BCPD registrations "
                                 f"disagree at {depth} iteration(s)")


def bcpd_final_iterate(src, tgt, maxiter, plain=False, tiles=None):
    """The raw-frame final VI iterate of registration_bcpd at a fixed depth
    (tol 0), through the kernels or through the plain version (and other
    tile sizes)."""
    from probreg_tpu_torch import bcpd
    from probreg_tpu_torch.ops import bcpd_cuda as bc

    kw = dict(BCPD_ARGS, maxiter=maxiter, tol=0.0, callbacks=[],
              normalize=True, callback_chunk=1, w=0.0, return_last=True)
    core, culled = bc.wstash_estep, bc.bcpd_estep_culled
    if plain:
        bc.wstash_estep = bc.wstash_estep_plain
    if tiles:
        bc.bcpd_estep_culled = lambda *a: culled(*a, tile_m=tiles,
                                                 tile_n=tiles)
    try:
        last = bcpd._registration_bcpd_impl(src, tgt, **kw)[2]
        torch.cuda.synchronize()
    finally:
        bc.wstash_estep, bc.bcpd_estep_culled = core, culled
    return last


def bcpd_spread(src, a, b):
    """Max differences of two final iterates: rot, t, scale, v, the moved
    source s R (y + v) + t, and sigma2 relative."""
    def moved(last):
        p = last["tf_init_params"]
        return p["scale"] * (src + last["v_init"]) @ p["rot"].T + p["t"]

    pa, pb = a["tf_init_params"], b["tf_init_params"]
    return {"rot": float(np.abs(pa["rot"] - pb["rot"]).max()),
            "t": float(np.abs(pa["t"] - pb["t"]).max()),
            "scale": abs(pa["scale"] - pb["scale"]),
            "v": float(np.abs(a["v_init"] - b["v_init"]).max()),
            "moved": float(np.abs(moved(a) - moved(b)).max()),
            "sigma2 rel": abs(a["sigma2_init"] / b["sigma2_init"] - 1.0)}


# --------------------------------------------------------------------------
# GMMTree: the level-EM kernel (K9) and the registration kernel (K10)
# --------------------------------------------------------------------------

def gmm_surface_pair():
    """The large GMMTree pair: source blobby_surface(150_000, seed=2),
    target a second sample of the same surface (seed 3) rotated by Euler
    (3, -2, 5) degrees (examples/largescale_rigid.py's rotation): (src,
    tgt, rot)."""
    from probreg_tpu_torch.utils import se3_op
    from probreg_tpu_torch.utils.datagen import blobby_surface

    rot = se3_op.euler2mat(*np.deg2rad([3.0, -2.0, 5.0])).double().numpy()
    src = blobby_surface(N_GMM, seed=2)
    tgt = (blobby_surface(N_GMM, seed=3) @ rot.T).astype(np.float32)
    return src, tgt, rot


def gmm_level_inputs(pts, counts, dev):
    """Clouds (B, N, 3) with each pair's ``counts`` (B,) valid points first,
    centred and with the padding zeroed as _build_fused does, and, for
    levels 0 and 1 of their initial 2-level trees (64 leaves drawn with
    seed 0), (state, parent map): level 1's parents from a whole level-0
    run of K9 on the batch. Returns (x, counts, levels)."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import gmmtree_cuda as gc

    x = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    counts = torch.as_tensor(counts, dtype=torch.int64, device=dev)
    valid = (torch.arange(x.shape[1], device=dev)[None, :]
             < counts[:, None]).float()[..., None]
    cen = (x * valid).double().sum(1) / counts[:, None].double()
    x = ((x - cen.float()[:, None, :]) * valid).contiguous()
    pi, mu, cov = pgt._init_tree(x, pgt._leaf_indices(0, counts.tolist(), 64,
                                                      dev), counts, 2)
    states = [pgt._pack_level(pi[:, lb:le], mu[:, lb:le], cov[:, lb:le])
              for lb, le in ((0, 8), (8, 72))]
    parent0 = torch.zeros(x.shape[:2], dtype=torch.int64, device=dev)
    parent1 = gc.level_em(x, counts, states[0], parent0, lambda_s=1e-3,
                          lambda_d=1e-4)[1]
    return x, counts, [(states[0], parent0), (states[1], parent1)]


def level_em_check(name, x, counts, state, parent, maxiter, quiet=False):
    """K9 against its plain version at a fixed depth (lambda_s = 0), pair by
    pair: per field (pi, mu, cov) within 1e-4 of the pair's largest entry,
    or within 3x the spread between the plain version in f32 and in f64 on
    that pair (the EM amplifies rounding over iterations: a small node's
    m2 / m0 - mu mu^T cancels); the hard child on all but 0.1 % of the
    valid points; every pair at maxiter iterations. Returns (the max abs
    error, the plain version's state)."""
    from probreg_tpu_torch.ops import gmmtree_cuda as gc

    kw = dict(lambda_s=0.0, lambda_d=1e-4, maxiter=maxiter)
    got = gc.level_em(x, counts, state, parent, **kw)
    want = gc.level_em_plain(x, counts, state, parent, **kw)
    w64 = gc.level_em_plain(x.double(), counts, state.double(), parent, **kw)
    torch.cuda.synchronize()
    ok, worst, parts, wide = True, 0.0, [], 0
    for label, sl in (("pi", slice(0, 1)), ("mu", slice(1, 4)),
                      ("cov", slice(4, 10))):
        err = (got[0][..., sl] - want[0][..., sl]).abs().amax((1, 2))
        spread = (want[0][..., sl].double() - w64[0][..., sl]).abs().amax(
            (1, 2))
        scale = want[0][..., sl].abs().amax((1, 2))
        tight = err <= 1e-4 * scale + 1e-6
        ok = ok and bool((tight | (err <= 3.0 * spread)).all())
        wide += int((~tight).sum())
        worst = max(worst, float(err.max()))
        b = int(err.argmax())
        parts.append(f"{label} {float(err[b]):.2e} (f32-f64 "
                     f"{float(spread[b]):.2e})")
    valid = (torch.arange(x.shape[1], device=x.device)[None, :]
             < counts[:, None])
    flips = float(((got[1] != want[1]) & valid).sum()) / float(counts.sum())
    q_rel = float((got[2][:, 0].double() / want[2][:, 0].double() - 1.0)
                  .abs().max())
    pairs = f"{x.shape[0]} pair(s), " if x.shape[0] > 1 else ""
    if not quiet:
        log(f"  {name}, {pairs}{maxiter} iteration(s): " + ", ".join(parts)
            + f"; fields over 1e-4 held to the spread: {wide}; hard child "
            f"differs on {flips:.2e} of the points; q rel {q_rel:.2e}")
    if not (ok and flips <= 1e-3
            and bool((got[2][:, 1] == maxiter).all())):
        raise AssertionError(f"level-EM kernel disagrees with its plain "
                             f"version: {name}, {maxiter} iterations: "
                             + ", ".join(parts))
    return worst, want[0]


def level_em_batch_check(name, x, counts, state, parent):
    """K9 on a ragged batch. On clouds of 300-1024 points a level-1 node
    holds ~10 of them, and past a few iterations the EM parts any two
    summation orders far beyond their f32-to-f64 spread (two plain versions
    that differ only in the order of the points do, logged below). So:
    whole launches at 1 and 3 iterations and each of GMM_BUILD_ITERS
    one-iteration launches from the plain version's state along its own
    trajectory are held pair by pair as in level_em_check; in the whole
    launch at GMM_BUILD_ITERS a pair's field is within 1e-4 of its largest
    entry or within 3x the largest per-pair difference between those two
    plain versions. Returns the max abs error of the pair-by-pair checks."""
    from probreg_tpu_torch.ops import gmmtree_cuda as gc

    worst = max(level_em_check(name, x, counts, state, parent, m)[0]
                for m in (1, 3))
    st, step_worst = state, 0.0
    for _ in range(GMM_BUILD_ITERS):
        err, st = level_em_check(f"{name}, stepwise", x, counts, st, parent,
                                 1, quiet=True)
        step_worst = max(step_worst, err)
    log(f"  {name}, {x.shape[0]} pair(s), each of {GMM_BUILD_ITERS} single "
        f"iterations from the plain version's state: max {step_worst:.2e}, "
        "every pair within the pair-by-pair criterion")
    kw = dict(lambda_s=0.0, lambda_d=1e-4, maxiter=GMM_BUILD_ITERS)
    got = gc.level_em(x, counts, state, parent, **kw)
    want = gc.level_em_plain(x, counts, state, parent, **kw)
    pts_s, _, order = gc.sort_by_parent(x, counts, parent,
                                        state.shape[1] // 8)
    other = gc.level_em_plain(pts_s, counts, state,
                              torch.gather(parent, 1, order), **kw)
    ok, parts = bool((got[2][:, 1] == GMM_BUILD_ITERS).all()), []
    for label, sl in (("pi", slice(0, 1)), ("mu", slice(1, 4)),
                      ("cov", slice(4, 10))):
        err = (got[0][..., sl] - want[0][..., sl]).abs().amax((1, 2))
        ref = (other[0][..., sl] - want[0][..., sl]).abs().amax((1, 2))
        cut = 1e-4 * want[0][..., sl].abs().amax((1, 2)) + 1e-6
        ok = ok and bool(((err <= cut) | (err <= 3.0 * ref.max())).all())
        parts.append(f"{label} max {float(err.max()):.2e}, "
                     f"{int((err > cut).sum())} over 1e-4 (plain orders: "
                     f"max {float(ref.max()):.2e}, {int((ref > cut).sum())} "
                     "over 1e-4)")
    log(f"  {name}, {x.shape[0]} pair(s), {GMM_BUILD_ITERS} iterations in "
        "one launch: " + ", ".join(parts))
    if not ok:
        raise AssertionError(f"level-EM kernel disagrees with its plain "
                             f"version: {name}, {GMM_BUILD_ITERS} iterations")
    return max(worst, step_worst)


def check_gmmtree_build(dev, kernels):
    """K9 against level_em_plain on the horse (2,936 points), the 150k
    surface and the 256 ragged horse sources as one compacted batch (the
    launches run_gmmtree_batch makes), levels 0 and 1 of a 2-level tree,
    at 1 iteration and at GMM_BUILD_ITERS (the batch as
    level_em_batch_check says); the 150k level 1 at that depth gives the
    kernels line its numbers."""
    from probreg_tpu_torch.ops import gmmtree_cuda as gc
    from probreg_tpu_torch.ops.em_cuda import _compact
    from probreg_tpu_torch.utils import io, interop

    log(f"[K9 level EM] kernel against its plain version, lambda_s 0")
    horse = io.read_point_cloud(data_path("horse.ply"))
    s_p, smask = interop.pad_ragged([p[0] for p in serving_batches()[0]],
                                    device=dev)
    s_c, s_cnt = _compact(s_p, smask)
    worst = 0.0
    cases = {"horse": (horse[None], [len(horse)]),
             "horse 256 ragged": (s_c, s_cnt),
             f"surface {N_GMM:,}": (gmm_surface_pair()[0][None], [N_GMM])}
    inputs = {}
    for name, (pts, cnt) in cases.items():
        x, counts, levels = inputs[name] = gmm_level_inputs(pts, cnt, dev)
        for lev, (state, parent) in enumerate(levels):
            per = gc.blocks_per_pair(
                x.shape[1], x.shape[0],
                gc.level_capacity(state.shape[1], dev))
            log(f"  {name} level {lev}: {x.shape[0]} pair(s) of up to "
                f"{x.shape[1]} points, {per} block(s) per pair")
            if x.shape[0] > 1:
                worst = max(worst, level_em_batch_check(
                    f"{name} level {lev}", x, counts, state, parent))
                continue
            for maxiter in (1, GMM_BUILD_ITERS):
                worst = max(worst, level_em_check(
                    f"{name} level {lev}", x, counts, state, parent,
                    maxiter)[0])
    # Raw launches on the sorted points (the wrapper's sort is not the
    # kernel's time), at the depth compared above.
    kw = dict(lambda_s=0.0, lambda_d=1e-4, maxiter=GMM_BUILD_ITERS)
    x, counts, levels = inputs["horse 256 ragged"]
    state, parent = levels[1]
    pts_s, seg, _ = gc.sort_by_parent(x, counts, parent, 8)
    ms = timed(lambda: gc.level_launch(pts_s, seg, state, **kw), 5)
    per = gc.blocks_per_pair(x.shape[1], x.shape[0],
                             gc.level_capacity(state.shape[1], dev))
    log(f"  256 ragged pairs, level 1, {GMM_BUILD_ITERS} iterations: kernel "
        f"{ms:.3f} ms for the batch ({per} block(s) per pair)")
    x, _, levels = inputs[f"surface {N_GMM:,}"]
    state, parent = levels[1]
    n, k = x.shape[1], state.shape[1]
    pts_s, seg, _ = gc.sort_by_parent(x, None, parent, k // 8)
    per = gc.blocks_per_pair(n, 1, gc.level_capacity(k, dev))
    ms = timed(lambda: gc.level_launch(pts_s, seg, state, **kw), 5)
    one_ms = timed(lambda: gc.level_launch(pts_s, seg, state, **kw,
                                           _blocks=1), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gc.level_em_plain(x, None, state, parent, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b_ms, b_by = bound(16 * n + 80 * k + 8,
                       float(n) * flops_level_em(k) * GMM_BUILD_ITERS)
    log(f"  {N_GMM:,} points, level 1 ({k} nodes), {GMM_BUILD_ITERS} "
        f"iterations: kernel {ms:.3f} ms ({ms / GMM_BUILD_ITERS:.3f} ms per "
        f"iteration) on {per} blocks; {one_ms:.3f} ms on one block  plain "
        f"{plain_ms:.1f} ms  bound {b_ms:.4f} ms ({b_by})")
    kernels["gmmtree_level_em"] = dict(max_abs_err=worst, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by)


def gmm_reg_compare(name, ys, counts, table, init, maxiter):
    """K10 against run_gmmtree_reg_fused_plain on prepared inputs at a fixed
    depth (tol 0). Both descend from differences, so only the order of the
    sums differs, and per pair rot and t agree to 1e-4, unless a point sits
    on a tie of the descent's first maximum and goes to another node: then
    the plain version in f32 and in f64 part as well, and the pair is held
    to 3x that spread. Returns (the per-pair differences, the plain
    version's ms)."""
    from probreg_tpu_torch.ops import gmmtree_cuda as gc

    kw = dict(max_level=2, maxiter=maxiter, tol=0.0, lambda_c=0.01)
    got = gc._reg_cuda(ys, counts, table, init, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = gc.run_gmmtree_reg_fused_plain(ys, counts, table, init, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (got[:, :12] - want[:, :12]).abs().amax(1)
    over = [int(b) for b in torch.nonzero(err > 1e-4)[:, 0]]
    spreads = []
    for b in over:
        w64 = gc.run_gmmtree_reg_fused_plain(
            ys[b:b + 1].double(), counts[b:b + 1], table[b:b + 1].double(),
            init[b:b + 1].double(), **kw)[0]
        spreads.append(float((want[b, :12].double() - w64[:12]).abs().max()))
    log(f"  {name}: {len(err)} pair(s), {maxiter} iterations, max |rot|, "
        f"|t| {float(err.max()):.2e} (median {float(err.median()):.2e}), q "
        f"rel {float((got[:, 12] / want[:, 12] - 1).abs().max()):.2e}; "
        f"over 1e-4: {len(over)} pair(s), "
        + ", ".join(f"{float(err[b]):.2e} against an f32-f64 spread of "
                    f"{sp:.2e}" for b, sp in zip(over, spreads)))
    if not bool((got[:, 13] == maxiter).all()):
        raise AssertionError(f"registration kernel: wrong iteration count "
                             f"({name})")
    if not all(float(err[b]) <= 3.0 * sp for b, sp in zip(over, spreads)):
        raise AssertionError(f"registration kernel disagrees with its plain "
                             f"version ({name})")
    return err, plain_ms


def gmm_reg_inputs(targets, tmask, trees):
    """K10's prepared inputs for (B, N, 3) targets and their trees, from the
    identity: (ys, counts, table, init)."""
    from probreg_tpu_torch.ops import gmmtree_cuda as gc
    from probreg_tpu_torch.ops.em_cuda import _compact

    if tmask is None:
        counts = torch.full((targets.shape[0],), targets.shape[1],
                            dtype=torch.int32, device=targets.device)
    else:
        targets, counts = _compact(targets, tmask)
    ys, table, _ = gc.reg_tables(targets, counts.long(), *trees)
    init = torch.zeros((targets.shape[0], 12), device=targets.device)
    init[:, [0, 4, 8]] = 1.0    # identity; t0 = 0 stays 0 when centred
    return ys, counts.contiguous(), table, init


def check_gmmtree_reg(dev, kernels):
    """K10 against its plain version on the bunny (bench.py's pair, its own
    tree) and on the 256 ragged horse pairs (trees from one K9 build of the
    batch) at GMM_REG_ITERS iterations, tol 0; the batch gives the kernels
    line its numbers (criterion: gmm_reg_compare)."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import gmmtree_cuda as gc
    from probreg_tpu_torch.ops.em_cuda import _compact

    log(f"[K10 GMMTree registration] kernel against its plain version")
    src, tgt = bunny_clouds(z_rotation(10.0))
    tree = [a[None] for a in pgt.GMMTree(src, device=dev)._nodes]
    tg = torch.as_tensor(tgt, device=dev)[None]
    err, _ = gmm_reg_compare("bunny", *gmm_reg_inputs(tg, None, tree),
                             GMM_REG_ITERS)
    worst = float(err.max())
    rigid = serving_batches()[0]
    srcs, tgts, smask, tmask = em_batch_tensors(rigid, dev)
    s_c, s_cnt = _compact(srcs, smask)
    trees = pgt._build_fused(s_c, pgt._leaf_indices(0, s_cnt.tolist(), 64,
                                                    dev), s_cnt,
                             max_level=2, lambda_s=1e-3, lambda_d=1e-4)
    inputs = gmm_reg_inputs(tgts, tmask, trees)
    err, plain_ms = gmm_reg_compare("serving batch", *inputs, GMM_REG_ITERS)
    worst = max(worst, float(err.max()))
    ys, counts, table, init = inputs
    kw = dict(max_level=2, maxiter=GMM_REG_ITERS, tol=0.0, lambda_c=0.01)
    ms = timed(lambda: gc._reg_cuda(ys, counts, table, init, **kw), 5)
    # The work of this data: the descent depth of each point at the
    # starting pose (a point stops at a level-0 node of complexity <=
    # lambda_c) times the iterations.
    work = 0.0
    for b, n in enumerate(counts.tolist()):
        node, _ = gc._descend(ys[b, :n], table[b], 2, 0.01)
        work += float((1.0 + (node >= 8).double()).sum())
    n_all = float(counts.sum())
    b_ms, b_by = bound(12 * n_all + 4 * table.numel() + 64 * len(rigid),
                       GMM_REG_ITERS * n_all * flops_gmm_reg(work / n_all))
    log(f"  batch kernel {ms:.3f} ms  plain {plain_ms:.1f} ms (a host loop "
        f"over the pairs)  bound {b_ms:.4f} ms ({b_by}); mean descent depth "
        f"{work / n_all:.3f} levels")
    kernels["gmmtree_reg"] = dict(max_abs_err=worst, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by)


def run_gmmtree_bunny(dev, launches):
    """examples/gmmtree_rigid.py (the bunny at voxel 0.005, 1e-3 noise, seed
    4, rotated 10 degrees about z) and bench.py's bunny pair (seed 3) at
    the defaults (tree_level 2, maxiter 20, tol 1e-4): per call
    tree_level K9 launches and one K10 launch; each angle within 5e-2 rad
    (tests/test_gmmtree.py's bar)."""
    from probreg_tpu_torch import gmmtree
    from probreg_tpu_torch.utils import se3_op

    for name, seed in (("examples/gmmtree_rigid.py", 4), ("bench.py", 3)):
        src, tgt = bunny_clouds(z_rotation(10.0), seed=seed)
        gmmtree.registration_gmmtree(src, tgt)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = gmmtree.registration_gmmtree(src, tgt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        expect_launches(f"GMMTree {name}", gmmtree_level_em=2,
                        gmmtree_reg=1)
        ang = se3_op.mat2euler(res.transformation.rot.cpu()).double().numpy()
        err = np.abs(ang - np.deg2rad([0.0, 0.0, 10.0]))
        log(f"[GMMTree bunny] {name}: registration_gmmtree, {src.shape[0]} "
            f"points, defaults: second call {wall:.3f} ms (build and "
            f"registration), recovered Euler "
            f"{np.round(np.rad2deg(ang), 4).tolist()} deg, max angle error "
            f"{err.max():.2e} rad")
        if not err.max() <= 5e-2:
            raise AssertionError(f"GMMTree bunny wrong: {name}")
    launches.update(gmmtree_level_em=2, gmmtree_reg=1)


def run_gmmtree_batch(dev, launches):
    """registration_gmmtree_batch on 32 copies of bench.py's bunny pair
    (benchmarks/bench_full.py bench_gmmtree_batch: maxiter 20, tol 1e-4)
    and on the 256 ragged horse pairs (examples/batch_serving.py's GMMTree
    settings: maxiter 30, tol 1e-6): one K9 launch per level and one K10
    launch per batch; every pair's registration equal bit for bit to its
    single-pair launch on the same tree."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.models import transformation as tf
    from probreg_tpu_torch.ops import gmmtree_cuda as gc
    from probreg_tpu_torch.ops.em_cuda import _compact
    from probreg_tpu_torch.utils import interop, se3_op

    src, tgt = bunny_clouds(z_rotation(10.0))
    rigid = serving_batches()[0]
    cases = (("bunny x32", [src] * 32, [tgt] * 32,
              [z_rotation(10.0)] * 32, dict(maxiter=20, tol=1e-4)),
             ("horse 256 ragged", [p[0] for p in rigid],
              [p[1] for p in rigid], [p[2] for p in rigid],
              dict(maxiter=30, tol=1e-6)))
    for name, srcs, tgts, rots, kw in cases:
        pgt.registration_gmmtree_batch(srcs, tgts, **kw)  # warm
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = pgt.registration_gmmtree_batch(srcs, tgts, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        expect_launches(f"GMMTree batch {name}", gmmtree_level_em=2,
                        gmmtree_reg=1)
        errs = np.array([np.rad2deg(float(se3_op.rotation_angle(
            r.transformation.rot.cpu().double(), torch.as_tensor(rot))))
            for r, rot in zip(res, rots)])
        # The same trees again, then each pair alone on its tree.
        s_p, smask = interop.pad_ragged(srcs, device=dev)
        t_p, tmask = interop.pad_ragged(tgts, device=dev)
        s_c, s_cnt = _compact(s_p, smask)
        trees = pgt._build_fused(s_c, pgt._leaf_indices(0, s_cnt.tolist(),
                                                        64, dev), s_cnt,
                                 max_level=2, lambda_s=1e-3, lambda_d=1e-4)
        rkw = dict(max_level=2, lambda_c=0.01, **kw)
        diff = 0.0
        for b, (r, t) in enumerate(zip(res, tgts)):
            one = gc.run_gmmtree_reg_fused(torch.as_tensor(t, device=dev),
                                           *(a[b] for a in trees), **rkw)
            inv = tf.RigidTransformation(one[0], one[1]).inverse()
            diff = max(diff, float((inv.rot - r.transformation.rot)
                                   .abs().max()),
                       float((inv.t - r.transformation.t).abs().max()))
        log(f"[GMMTree batch] {name}: registration_gmmtree_batch, second "
            f"call {wall:.2f} ms ({wall / len(srcs):.3f} ms per pair); deg "
            f"rotation error median {np.median(errs):.4f} max "
            f"{errs.max():.4f}; max difference to the single-pair launches "
            f"{diff:.2e}")
        if not (diff == 0.0 and np.median(errs) <= 1.5):
            raise AssertionError(f"GMMTree batch wrong: {name}")


def run_gmmtree_large(dev, launches, kernels):
    """registration_gmmtree on the 150k surface pair at the defaults: K9
    once per level and K10 once, no plain version and no twin loop called,
    the call's time split with CUDA events into K9 per level, the sorts by
    parent, K10 and the rest (host work and the other device work); then,
    on one tree, K10 against its plain version at 3 iterations."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import gmmtree_cuda as gc
    from probreg_tpu_torch.utils import se3_op

    src, tgt, rot = gmm_surface_pair()
    log(f"[GMMTree 150k] registration_gmmtree, {N_GMM:,} points each "
        "(two samples of one surface), defaults")
    t0 = time.perf_counter()
    pgt.registration_gmmtree(src, tgt)
    torch.cuda.synchronize()
    log(f"  warm call {time.perf_counter() - t0:.3f} s")

    def refuse(*a, **k):
        raise AssertionError("a plain GMMTree path ran on the card")

    spans = []   # (name, start event, end event) in launch order
    saved = (gc.level_em_plain, gc.run_gmmtree_reg_fused_plain,
             pgt._run_registration, pgt._accumulate, gc.level_launch,
             gc.sort_by_parent, gc._reg_cuda)
    gc.level_em_plain = gc.run_gmmtree_reg_fused_plain = refuse
    pgt._run_registration = pgt._accumulate = refuse
    gc.level_launch = evented(spans, "K9", gc.level_launch)
    gc.sort_by_parent = evented(spans, "sort", gc.sort_by_parent)
    gc._reg_cuda = evented(spans, "K10", gc._reg_cuda)
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = pgt.registration_gmmtree(src, tgt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = all_launches()
    finally:
        (gc.level_em_plain, gc.run_gmmtree_reg_fused_plain,
         pgt._run_registration, pgt._accumulate, gc.level_launch,
         gc.sort_by_parent, gc._reg_cuda) = saved
    split, level = {}, 0
    for name, e0, e1 in spans:
        if name == "K9":
            name, level = f"K9 level {level}", level + 1
        split[name] = split.get(name, 0.0) + e0.elapsed_time(e1)
    rest = wall * 1e3 - sum(split.values())
    log("  split of the timed call (CUDA events, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items())
        + f", the rest (host and other device work) {rest:.3f}")
    peak = torch.cuda.max_memory_allocated()
    expect_launches("150k GMMTree", gmmtree_level_em=2, gmmtree_reg=1)
    launches.update(gmmtree_level_em=got["gmmtree_level_em"],
                    gmmtree_reg=got["gmmtree_reg"])
    err = float(se3_op.rotation_angle(res.transformation.rot.cpu().double(),
                                      torch.as_tensor(rot)))
    log(f"  timed call {wall:.3f} s (build and registration), peak memory "
        f"{peak / 2**30:.3f} GiB, rotation error {err:.3e} rad, q "
        f"{float(res.q):.6g}")
    # One tree; K10 against its plain version at a shallow fixed depth.
    gt = pgt.GMMTree(src, device=dev)
    tg = torch.as_tensor(tgt, device=dev)[None]
    inputs = gmm_reg_inputs(tg, None, [a[None] for a in gt._nodes])
    d, plain_ms = gmm_reg_compare("150k kernel-driven against plain-driven",
                                  *inputs, 3)
    log(f"  (the plain-driven run took {plain_ms:.0f} ms)")
    # K10 alone on this pair at GMM_REG_ITERS iterations (tol 0), on the
    # blocks the wrapper picks and on one block.
    ys, counts, table, init = inputs
    kw = dict(max_level=2, maxiter=GMM_REG_ITERS, tol=0.0, lambda_c=0.01)
    per = gc.blocks_per_pair(ys.shape[1], 1,
                             gc.reg_capacity(table.shape[1], dev))
    ms = timed(lambda: gc._reg_cuda(ys, counts, table, init, **kw), 5)
    one_ms = timed(lambda: gc._reg_cuda(ys, counts, table, init, **kw,
                                        _blocks=1), 3)
    node, _ = gc._descend(ys[0], table[0], 2, 0.01)
    depth = float((1.0 + (node >= 8).double()).mean())
    b_ms, b_by = bound(12 * N_GMM + 4 * table.numel() + 64,
                       GMM_REG_ITERS * N_GMM * flops_gmm_reg(depth))
    its = int(gc._reg_cuda(ys, counts, table, init, max_level=2,
                           maxiter=20, tol=1e-4, lambda_c=0.01)[0, 13])
    log(f"  K10 at {N_GMM:,} points: {per} blocks per pair; "
        f"{GMM_REG_ITERS} iterations {ms:.3f} ms "
        f"({ms / GMM_REG_ITERS * 1e3:.1f} us per iteration), on one block "
        f"{one_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}, mean descent depth "
        f"{depth:.3f}); at the defaults (maxiter 20, tol 1e-4) {its} "
        "iterations")
    kernels.setdefault("gmmtree_reg", {}).update(
        blocks_150k=per, ms_150k=ms, one_block_ms_150k=one_ms,
        bound_ms_150k=b_ms, launches_150k=got["gmmtree_reg"])
    if not per > 1:
        raise AssertionError("K10 did not spread the 150k pair")
    if not err <= ROT_ERR_MAX:
        raise AssertionError("150k GMMTree wrong")


# --------------------------------------------------------------------------
# The pyramids
# --------------------------------------------------------------------------

def pyramid_case(n):
    """examples/pyramid_rigid.py's case: blobby_surface(n, seed=0), the
    target moved by Euler (5, 8, 12) degrees and t = (0.05, -0.03, 0.08).
    Returns (src, tgt, rot, t)."""
    from probreg_tpu_torch.utils import se3_op
    from probreg_tpu_torch.utils.datagen import blobby_surface

    src = blobby_surface(n, seed=0)
    rot = se3_op.euler2mat(*np.deg2rad([5.0, 8.0, 12.0])).numpy()
    t = np.array([0.05, -0.03, 0.08], np.float32)
    return src, (src @ rot.T + t).astype(np.float32), rot, t


def traced_cpd_pyramid(src, tgt, kind):
    """One registration_cpd_pyramid call with the launch counts set to 0
    just before it and read just after; records the points per level, the
    host's level preparation, each level's wall time (each ends in a
    synchronize), each culled E-step's active tile fraction, and each stash
    E-step's host time (launching its kernels, no synchronize) and device
    time (CUDA events around it). Keeps a copy of the inputs of the finest
    level's first stash E-step (``info["finest_inputs"]``: ys, xs, scal,
    mask, tile_m, tile_n) for check_pyramid_estep. Returns (result, wall s,
    info)."""
    from probreg_tpu_torch import cpd, pyramid
    from probreg_tpu_torch.ops import estep_cuda as ec

    info = {"level_s": [], "masks": [], "esteps": []}
    saved = (pyramid._prepare_levels, cpd.registration_cpd, ec._active_mask,
             ec.stash_estep, ec.stash_merged_estep)

    def prepare(*a, **k):
        out = saved[0](*a, **k)
        info["points"] = [int(len(x)) for x in out[0]]
        info["voxels"] = [float(v) for v in out[2]]
        info["prep_s"] = time.perf_counter() - t0
        return out

    def register(*a, **k):
        t1 = time.perf_counter()
        res = saved[1](*a, **k)
        torch.cuda.synchronize()
        info["level_s"].append(time.perf_counter() - t1)
        return res

    def active_mask(*a):
        mask = saved[2](*a)
        info["masks"].append((mask.shape[0], mask.float().mean()))
        return mask

    def timed_core(core):
        def run(ys, *a):
            if (ys.shape[0] == info["points"][-1]
                    and "finest_inputs" not in info):
                info["finest_inputs"] = tuple(
                    v.clone() if torch.is_tensor(v) else v for v in (ys, *a))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            t1 = time.perf_counter()
            out = core(ys, *a)
            host = time.perf_counter() - t1
            ev[1].record()
            info["esteps"].append((ys.shape[0], host, ev))
            return out
        return run

    (pyramid._prepare_levels, cpd.registration_cpd, ec._active_mask,
     ec.stash_estep, ec.stash_merged_estep) = (
        prepare, register, active_mask, timed_core(saved[3]),
        timed_core(saved[4]))
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = pyramid.registration_cpd_pyramid(src, tgt, kind,
                                               **PYRAMID_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info["launches"] = {k: v for k, v in all_launches().items() if v}
    finally:
        (pyramid._prepare_levels, cpd.registration_cpd, ec._active_mask,
         ec.stash_estep, ec.stash_merged_estep) = saved
    info["peak"] = torch.cuda.max_memory_allocated()
    info["esteps"] = [(m, host, ev[0].elapsed_time(ev[1]) / 1e3)
                      for m, host, ev in info["esteps"]]
    return res, wall, info


def log_pyramid(wall, info):
    from probreg_tpu_torch.config import config

    finest = -(-info["points"][-1] // config.tile_m)  # its source tiles
    fine = [float(f) for n_i, f in info["masks"] if n_i == finest]
    log(f"  timed call {wall:.3f} s: level preparation on the host "
        f"{info['prep_s']:.3f} s, levels (coarsest first) "
        + ", ".join(f"{p:,} points {s:.3f} s" for p, s in
                    zip(info["points"], info["level_s"])))
    log(f"  voxels {[round(v, 6) for v in info['voxels']]}; finest level "
        f"{len(fine)} E-steps, active tile fraction first "
        f"{fine[0] if fine else float('nan'):.5f} last "
        f"{fine[-1] if fine else float('nan'):.5f}; peak memory "
        f"{info['peak'] / 2**30:.3f} GiB")
    for m in sorted({m for m, _, _ in info["esteps"]}):
        host = [h for k, h, _ in info["esteps"] if k == m]
        dev = [d for k, _, d in info["esteps"] if k == m]
        log(f"  stash E-steps at {m:,} source points: {len(host)}, host "
            f"(launching) {sum(host):.4f} s, device (events) {sum(dev):.4f}"
            f" s, per E-step {1e3 * sum(dev) / len(dev):.3f} ms on the "
            "device")
    log(f"  launches: {info['launches']}")


def check_pyramid_estep(n, inputs, kernels):
    """K12 and K3 on the pyramid's own shapes: the inputs of the finest
    level's first stash E-step of the n-point pyramid (a blobby surface at
    the carried sigma2 ~1e-4, a few % of tile pairs active), each kernel
    against its plain version, and K12's pt1 and xx against K3's bit for
    bit. An output passes within compare()'s tolerance of the plain
    version, or, where the f32 rounding of d2 = |y|^2 + |x|^2 - 2 y.x,
    amplified by 1/(2 sigma2), exceeds it, within PYR_ESTEP_SPREAD times
    the plain version's own distance from the same function in f64: the
    kernel is then no less exact than its plain version. These launches
    come after the traced run's counts were read; their errors against the
    plain version join the kernels line. Last, one E-step of each is timed
    on these inputs beside K12's bound there."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    ys, xs, scal, mask, tile_m, tile_n = inputs
    log(f"[pyramid E-step] {n:,} points, finest level's first E-step: "
        f"{ys.shape[0]:,} x {xs.shape[0]:,}, tiles {tile_m} x {tile_n} "
        f"({mask.shape[0]} x {mask.shape[1]}), active tile fraction "
        f"{float(mask.float().mean()):.5f}, sigma2 "
        f"{0.5 / float(scal[0]):.6g}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exact = ec.stash_estep_plain(ys.double(), xs.double(), scal.double(),
                                 mask, tile_m, tile_n)
    torch.cuda.synchronize()
    log(f"  the plain version in f64: {time.perf_counter() - t0:.1f} s")
    got, bad = {}, []
    for name, core, plain, rows in (
            ("K12", ec.stash_merged_estep, ec.stash_merged_estep_plain,
             ("stash_merged", "stash_merged")),
            ("K3", ec.stash_estep, ec.stash_estep_plain,
             ("stash_den", "stash_moment"))):
        t0 = time.perf_counter()
        want = plain(*inputs)
        torch.cuda.synchronize()
        log(f"  {name} against its plain version (plain "
            f"{time.perf_counter() - t0:.1f} s):")
        out = core(*inputs)
        torch.cuda.synchronize()
        err = []
        for k, a, b, e in zip(("pt1", "p1", "px", "xx"), out, want, exact):
            a, b = a.double(), b.double()
            scale = float(e.abs().max())
            d_kp = float((a - b).abs().max())
            d_k, d_p = float((a - e).abs().max()), float((b - e).abs().max())
            ok = (d_kp <= RTOL * scale + ATOL
                  or d_k <= PYR_ESTEP_SPREAD * d_p)
            log(f"  {k:6s} max_abs_err {d_kp:.3e}  max_rel_err "
                f"{d_kp / max(scale, 1e-30):.3e}; against f64: kernel "
                f"{d_k / max(scale, 1e-30):.3e}, plain "
                f"{d_p / max(scale, 1e-30):.3e}{'' if ok else '  FAIL'}")
            if not ok:
                bad.append(f"{name} {k}")
            err.append(d_kp)
        del want
        for row, e in ((rows[0], max(err[0], err[3])),
                       (rows[1], max(err[1], err[2]))):
            kernels[row]["max_abs_err"] = max(kernels[row]["max_abs_err"], e)
        got[name] = out
    same = (torch.equal(got["K12"][0], got["K3"][0])
            and torch.equal(got["K12"][3], got["K3"][3]))
    log(f"  K12 against K3: pt1 and xx {'equal' if same else 'NOT equal'} "
        "bit for bit")
    del got
    m, n_x = ys.shape[0], xs.shape[0]
    pairs = active_pairs(mask, m, n_x, tile_m, tile_n)
    b12 = bound(12 * (m + n_x) + 8 * n_x + 16 * m,
                pairs * (FLOPS_GAUSS + FLOPS_MOMENTS))
    ms12 = timed(lambda: ec.stash_merged_estep(*inputs), 3)
    ms3 = timed(lambda: ec.stash_estep(*inputs), 3)
    log(f"  one E-step on these inputs: K12 {ms12:.3f} ms, K3 {ms3:.3f} ms; "
        f"K12's bound {b12[0]:.3f} ms ({b12[1]}), {pairs:.4g} active pairs")
    if bad or not same:
        raise AssertionError(f"{n} pyramid E-step: {bad}, pass A of K12 "
                             f"and K3 {'equal' if same else 'differ'}")


def run_pyramid_cpd(dev, launches, kernels):
    """registration_cpd_pyramid rigid at 200k and 1M points, through K3
    (the default) and through K12 (use_merged_stash), the second call of
    each timed: each route launches its own pass B only, recovers the
    truth within the reference test's bar, and the two agree within
    PYR_ROUTE_TOL. Then both kernels are held to their plain versions on
    the finest level's first E-step (check_pyramid_estep)."""
    from probreg_tpu_torch import pyramid
    from probreg_tpu_torch.config import config
    from probreg_tpu_torch.utils import se3_op

    for n in PYRAMID_SIZES:
        src, tgt, rot, t_gt = pyramid_case(n)
        runs = {}
        for merged in (False, True):
            route = "K12, use_merged_stash" if merged else "K3, the default"
            log(f"[pyramid] registration_cpd_pyramid rigid, {n:,} points, "
                f"{PYRAMID_ARGS}, {route}")
            config.use_merged_stash = merged
            try:
                t0 = time.perf_counter()
                pyramid.registration_cpd_pyramid(src, tgt, "rigid",
                                                 **PYRAMID_ARGS)
                torch.cuda.synchronize()
                log(f"  warm call {time.perf_counter() - t0:.3f} s")
                res, wall, info = traced_cpd_pyramid(src, tgt, "rigid")
            finally:
                config.use_merged_stash = False
            log_pyramid(wall, info)
            tr = res.transformation
            ang = float(se3_op.rotation_angle(tr.rot.cpu().double(),
                                              torch.as_tensor(rot).double()))
            t_err = float(np.abs(tr.t.cpu().numpy() - t_gt).max())
            s_err = abs(float(tr.scale) - 1.0)
            log(f"  rotation error {ang:.3e} rad, |t - t_gt| {t_err:.3e}, "
                f"|scale - 1| {s_err:.3e}, sigma2 {float(res.sigma2):.6g}")
            got = info["launches"]
            mine, other = (("stash_merged", "stash_moment") if merged
                           else ("stash_moment", "stash_merged"))
            if not (got.get(mine, 0) > 0 and got.get(other, 0) == 0):
                raise AssertionError(f"{n} pyramid, {route}: launches {got}")
            if not (ang < PYR_ANGLE_MAX and t_err <= PYR_T_MAX
                    and s_err <= PYR_SCALE_MAX):
                raise AssertionError(f"{n} pyramid, {route}: missed the "
                                     "reference test's bar")
            runs[merged] = tr
            if merged:
                inputs = info["finest_inputs"]
                if n == PYRAMID_SIZES[-1]:
                    launches["stash_merged"] = got["stash_merged"]
            del info
        d_rot = float((runs[True].rot - runs[False].rot).abs().max())
        d_t = float((runs[True].t - runs[False].t).abs().max())
        log(f"  K12 against K3 route: max |rot diff| {d_rot:.3e}, max |t "
            f"diff| {d_t:.3e} (limit {PYR_ROUTE_TOL})")
        if not (d_rot <= PYR_ROUTE_TOL and d_t <= PYR_ROUTE_TOL):
            raise AssertionError(f"{n} pyramid: the two routes disagree")
        check_pyramid_estep(n, inputs, kernels)
        del inputs


def run_pyramid_affine(dev, launches):
    """registration_cpd_pyramid affine at 200k points on
    test_pyramid_affine's map (b = I + 0.08 N, t = 0.04 N, seeded numpy),
    the second call timed; b and t within that test's 1e-2."""
    from probreg_tpu_torch import pyramid

    src = pyramid_case(PYRAMID_SIZES[0])[0]
    rng = np.random.default_rng(0)
    b = np.eye(3, dtype=np.float32) \
        + 0.08 * rng.normal(size=(3, 3)).astype(np.float32)
    t_gt = 0.04 * rng.normal(size=3).astype(np.float32)
    tgt = (src @ b.T + t_gt).astype(np.float32)
    log(f"[pyramid] registration_cpd_pyramid affine, {len(src):,} points, "
        f"{PYRAMID_ARGS}")
    t0 = time.perf_counter()
    pyramid.registration_cpd_pyramid(src, tgt, "affine", **PYRAMID_ARGS)
    torch.cuda.synchronize()
    log(f"  warm call {time.perf_counter() - t0:.3f} s")
    res, wall, info = traced_cpd_pyramid(src, tgt, "affine")
    log_pyramid(wall, info)
    b_err = float(np.abs(res.transformation.b.cpu().numpy() - b).max())
    t_err = float(np.abs(res.transformation.t.cpu().numpy() - t_gt).max())
    log(f"  |b - b_gt| {b_err:.3e}, |t - t_gt| {t_err:.3e}, sigma2 "
        f"{float(res.sigma2):.6g}")
    if not info["launches"].get("stash_den", 0) > 0:
        raise AssertionError("the affine pyramid did not run K3")
    if not (b_err <= PYR_AFFINE_MAX and t_err <= PYR_AFFINE_MAX):
        raise AssertionError("200k affine pyramid wrong")


def family_pyramid(name, fn, src, tgt, refused, **kw):
    """One call of a family pyramid with the launch counts set to 0 just
    before it and read just after, and the plain versions in ``refused``
    (pairs of module and attribute) replaced by a function that raises.
    Returns (result, wall s, launches, points per level as (m, n))."""
    from probreg_tpu_torch import pyramid

    sizes = []
    prepare = pyramid._prepare_levels

    def recording(*a, **k):
        out = prepare(*a, **k)
        sizes.extend((len(s_i), len(t_i)) for s_i, t_i in zip(*out[:2]))
        return out

    def refuse(*a, **k):
        raise AssertionError(f"a plain version ran in the {name} pyramid")

    saved = [getattr(mod, attr) for mod, attr in refused]
    for mod, attr in refused:
        setattr(mod, attr, refuse)
    pyramid._prepare_levels = recording
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = fn(src, tgt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in all_launches().items() if v}
    finally:
        pyramid._prepare_levels = prepare
        for (mod, attr), fn_ in zip(refused, saved):
            setattr(mod, attr, fn_)
    return res, wall, got, sizes


def run_family_pyramids(dev, launches):
    """The ICP, FilterReg (pt2pt) and GMMTree pyramids at 200k points on
    the rigid pyramid's case (one call each: their levels run kernels that
    earlier phases have loaded), and the BCPD pyramid on
    bench_bcpd_guarded.py's 100k fixture (4 levels, rank 64, maxiter 50, tol
    1e-4, second call timed). Each runs with its kernels' plain versions
    replaced by a function that raises, launches the kernels its levels
    reach, and (ICP, FilterReg, GMMTree) recovers the truth within the bar
    of its reference test (tests/test_pyramid.py: test_pyramid_icp,
    test_pyramid_filterreg, test_pyramid_gmmtree); BCPD's full-target
    NN-RMSE must fall. ICP and FilterReg take coarse_points=800 so that
    their coarsest level (803 x 827 points) lies within the whole-loop
    kernels' gates (K7: the padded pair <= 2^20; K5: M N <= 2^20); their
    finer levels run the nearest-neighbour loop (ICP) and the dense loop
    and the streaming loop on K6 (FilterReg)."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch import pyramid
    from probreg_tpu_torch.config import config
    from probreg_tpu_torch.ops import bcpd_cuda, frg_cuda, gmmtree_cuda
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.ops import gt_cuda, icp_cuda
    from probreg_tpu_torch.utils import math_utils as mu
    from probreg_tpu_torch.utils import se3_op

    def rot_err(r, rot):
        return float(se3_op.rotation_angle(r.cpu().double(),
                                           torch.as_tensor(rot).double()))

    masks = []
    active_mask = ec._active_mask

    def recording_mask(*a):  # one per streaming FilterReg E-step
        mask = active_mask(*a)
        masks.append(mask)
        return mask

    def icp_want(sizes):
        return dict(icp=sum(icp_cuda.fused_dims_ok(m, n) for m, n in sizes))

    def frg_want(sizes):
        m, n = sizes[0]
        k5 = (m * n <= config.fused_em_max_pairs
              and frg_cuda.fused_dims_ok(m, n))
        return dict(frg_pt2pt=int(k5), gauss_transform=len(masks))

    def gmm_want(sizes):
        return dict(gmmtree_level_em=2 * len(sizes),
                    gmmtree_reg=len(sizes))

    src, tgt, rot, t_gt = pyramid_case(PYRAMID_SIZES[0])
    for name, fn, kw, refused, want, (ang_max, t_max) in (
            ("ICP", pyramid.registration_icp_pyramid,
             dict(levels=3, coarse_points=800),
             ((icp_cuda, "run_icp_fused_plain"),), icp_want, (5e-3, 1e-3)),
            ("FilterReg pt2pt", pyramid.registration_filterreg_pyramid,
             dict(levels=3, coarse_points=800),
             ((frg_cuda, "run_em_filterreg_fused_plain"),
              (gt_cuda, "gauss_transform_culled_plain")), frg_want,
             (2e-2, 1e-2)),
            ("GMMTree", pyramid.registration_gmmtree_pyramid,
             dict(levels=3),
             ((gmmtree_cuda, "level_em_plain"),
              (gmmtree_cuda, "run_gmmtree_reg_fused_plain"),
              (pgt, "_run_registration"), (pgt, "_accumulate")), gmm_want,
             (5e-2, 5e-2))):
        log(f"[pyramid] {name}, {len(src):,} points, {kw}")
        masks.clear()
        ec._active_mask = recording_mask
        try:
            res, wall, got, sizes = family_pyramid(name, fn, src, tgt,
                                                   refused, **kw)
        finally:
            ec._active_mask = active_mask
        tr = res.transformation
        err = rot_err(tr.rot, rot)
        t_err = float(np.abs(tr.t.cpu().numpy() - t_gt).max())
        expected = want(sizes)
        log(f"  {wall:.3f} s (first call), levels {sizes}, rotation error "
            f"{err:.3e} rad, |t - t_gt| {t_err:.3e} (bar {ang_max}, "
            f"{t_max}); launches {got}, expected {expected}")
        if not (min(expected.values()) > 0
                and got == {k: v for k, v in expected.items() if v}):
            raise AssertionError(f"{name} pyramid: launches {got}, "
                                 f"expected {expected}")
        if not (err < ang_max and t_err <= t_max):
            raise AssertionError(f"{name} pyramid missed its reference "
                                 "test's bar")

    src, tgt, rot = bcpd_clouds()
    kw = dict(BCPD_ARGS, levels=4)
    log(f"[pyramid] BCPD, {len(src):,} points, {kw}")
    t0 = time.perf_counter()
    pyramid.registration_bcpd_pyramid(src, tgt, **kw)
    torch.cuda.synchronize()
    log(f"  warm call {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    res, wall, got, sizes = family_pyramid(
        "BCPD", pyramid.registration_bcpd_pyramid, src, tgt,
        ((bcpd_cuda, "wstash_estep_plain"),
         (gt_cuda, "gauss_transform_culled_plain")), **kw)
    src_t = torch.as_tensor(src, device=dev)
    tgt_t = torch.as_tensor(tgt, device=dev)
    before = float(mu.compute_rmse(src_t, tgt_t))
    after = float(mu.compute_rmse(res.transform(src), tgt_t))
    rt = res.rigid_trans
    ang = np.rad2deg(se3_op.mat2euler(rt.rot.cpu()).numpy())
    log(f"  timed call {wall:.3f} s, levels {sizes}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{got}")
    log(f"  full-target NN-RMSE {before:.6f} before, {after:.6f} after; "
        f"rotation error {rot_err(rt.rot, rot):.3e} rad, recovered Euler "
        f"{np.round(ang, 3).tolist()} deg (true [8, -4, 6]), scale "
        f"{float(rt.scale):.5f}")
    if not (math.isfinite(after) and after < before):
        raise AssertionError("the BCPD pyramid did not bring the source "
                             "closer")
    # K8 on the levels with M N >= 2^24, K6 in the displacement's
    # interpolation between levels.
    if not (got.get("wstash_den", 0) > 0
            and got.get("wstash_moment") == got["wstash_den"]
            and got.get("gauss_transform", 0) > 0
            and set(got) == {"wstash_den", "wstash_moment",
                             "gauss_transform"}):
        raise AssertionError(f"BCPD pyramid launches {got}")


# --------------------------------------------------------------------------
# Nonrigid CPD
# --------------------------------------------------------------------------

NONRIGID_ITERS = 30        # the dense 3-D run, tol 0
NONRIGID_AGREE = 1e-4      # kernel- against plain-driven moved points
NONRIGID_SPREAD = 8.0      # ... or this times the plain f32-f64 spread
LOWRANK_ARGS = dict(rank=60, maxiter=20)
N_NONRIGID_PYR = 100_000
NONRIGID_PYR_ARGS = dict(rank=64, levels=3, maxiter=50, tol=1e-4)
# The K6-driven nonrigid pyramid against the one with K6's plain version:
# the carried field differs by rounding only (compare()'s 1e-4 of its
# largest entry), and each level's loop stops on |d sigma2| < tol.
NONRIGID_PYR_AGREE = 1e-3
# The sharded low-rank kinds against the single-card run at a fixed depth:
# the 1-D runner builds the same Nystrom factors (1e-4); the culled 2-D
# runs build them from the Morton-sorted source, so other landmarks (on the
# CPU at this size 2.7e-3 apart, residual 1.5 % higher): 1e-2, and the
# residual within 5 %.
SHARDED_LOWRANK_ITERS = 20
LOWRANK_SAME_FACTORS = 1e-4
LOWRANK_SORTED = 1e-2
LOWRANK_RESIDUAL = 1.05


def fish_clouds():
    """examples/cpd_nonrigid2d.py's fish, read as the example reads it."""
    return tuple(np.loadtxt(data_path(f"fish_{k}.txt")).astype(np.float32)
                 for k in ("source", "target"))


def nonrigid_3d_pair():
    """step_clouds()' 1,000-point cloud, the target moved by
    0.05 sin(2 x[::-1]): M N = 10^6, K2's full width."""
    src = step_clouds()["1000x1000"][0]
    return src, (src + 0.05 * np.sin(2.0 * src[:, ::-1])).astype(np.float32)


def lowrank_surface():
    """examples/cpd_nonrigid_lowrank.py's 16,384-point surface and its
    deformation: (source, target, displacement)."""
    g = np.linspace(0.0, 1.0, 128)
    xx, yy = np.meshgrid(g, g)
    src = np.stack([xx, yy, 0.3 * np.sin(2 * np.pi * xx)
                    * np.cos(2 * np.pi * yy)], -1).reshape(-1, 3) \
        .astype(np.float32)
    disp = 0.08 * np.stack([np.sin(np.pi * yy), np.cos(np.pi * xx),
                            np.sin(np.pi * (xx + yy))], -1).reshape(-1, 3) \
        .astype(np.float32)
    return src, src + disp, disp


def counted_msteps():
    """Wraps the dense nonrigid M-steps of cpd so that each call is
    counted; returns (counter list, restore function)."""
    from probreg_tpu_torch import cpd

    calls = []
    saved = {}
    for name in ("nonrigid_maximization_step",
                 "constrained_nonrigid_maximization_step"):
        fn = getattr(cpd, name)
        saved[name] = fn

        def wrapped(*a, fn=fn, **k):
            calls.append(1)
            return fn(*a, **k)
        setattr(cpd, name, wrapped)

    def restore():
        for name, fn in saved.items():
            setattr(cpd, name, fn)
    return calls, restore


def dense_nonrigid(src, tgt, kind, **kw):
    """registration_cpd of a dense nonrigid kind with the launch counts set
    to 0 just before it: (result, M-steps run, launches, wall s)."""
    from probreg_tpu_torch import cpd

    calls, restore = counted_msteps()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = cpd.registration_cpd(src, tgt, kind, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in all_launches().items() if v}
    finally:
        restore()
    return res, len(calls), got, wall


def moved(res, src):
    return res.transformation.transform(src).double()


def split_dense_iteration(src, tgt, kw):
    """CUDA events around the 15th iteration of the dense 3-D run and, in
    it, around its E-step (K2's whole estep_small call) and its M x M
    solve: (iteration ms, K2 ms, solve ms)."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.ops import estep_cuda as ec

    spans = []
    step, small, solve = cpd._nonrigid_step, ec.estep_small, torch.linalg.solve
    cpd._nonrigid_step = evented(spans, "iteration", step)
    ec.estep_small = evented(spans, "K2", small)
    torch.linalg.solve = evented(spans, "solve", solve)
    try:
        cpd.registration_cpd(src, tgt, "nonrigid", **kw)
        torch.cuda.synchronize()
    finally:
        cpd._nonrigid_step, ec.estep_small = step, small
        torch.linalg.solve = solve
    per = {}
    for name, e0, e1 in spans:
        per.setdefault(name, []).append(e0.elapsed_time(e1))
    return per["iteration"][14], per["K2"][14], per["solve"][14]


def nonrigid_step_api_ms(src, tgt, dev, iters=STEP_ITERS, reps=5):
    """Wall ms per iteration of NonRigidCPD.expectation_step +
    maximization_step(..., sigma2_p), the moved source and sigma2 carried
    on, median of ``reps`` runs of ``iters`` after a warm one; and the
    launches of one run."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.utils import math_utils

    s = torch.as_tensor(src, device=dev)
    t = torch.as_tensor(tgt, device=dev)
    reg = cpd.NonRigidCPD(s, device=dev)
    sigma2_0 = math_utils.squared_kernel_sum(s, t)

    def run():
        ts, sigma2 = s, sigma2_0
        for _ in range(iters):
            res = reg.maximization_step(
                t, reg.expectation_step(ts, t, sigma2, 0.0), sigma2)
            ts, sigma2 = res.transformation.transform(s), res.sigma2
        torch.cuda.synchronize()
        return res

    reset_launches()
    res = run()
    got = {k: v for k, v in all_launches().items() if v}
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) / iters * 1e3, res, got


def traced_nonrigid_pyramid(src, tgt):
    """One low-rank nonrigid registration_cpd_pyramid call with the launch
    counts set to 0 just before it: (result, wall s, [(points, wall s,
    sigma2) per level], launches, [the inputs and output of each
    displacement carry])."""
    from probreg_tpu_torch import cpd, pyramid

    levels, carries = [], []
    entry, interp = cpd.registration_cpd, pyramid._interp_displacement

    def timed_level(s_i, t_i, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = entry(s_i, t_i, *a, **k)
        torch.cuda.synchronize()
        levels.append((len(s_i), time.perf_counter() - t0,
                       float(out.sigma2)))
        return out

    def recorded(*a, **k):
        out = interp(*a, **k)
        carries.append((a, k, out))
        return out

    cpd.registration_cpd = timed_level
    pyramid._interp_displacement = recorded
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = pyramid.registration_cpd_pyramid(src, tgt, "nonrigid",
                                               **NONRIGID_PYR_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in all_launches().items() if v}
    finally:
        cpd.registration_cpd = entry
        pyramid._interp_displacement = interp
    return res, wall, levels, got, carries


def run_nonrigid(dev, launches):
    """Nonrigid and constrained CPD through registration_cpd: the dense
    loop on the fish and at K2's full width (one K2 launch per iteration,
    against the plain-driven run), the constrained model on the fish, the
    step API, the low-rank loop at 16,384 points (no kernel), the
    low-rank nonrigid pyramid at 100,000 points (K6 between levels,
    against its plain version and the plain-driven pyramid) and the
    low-rank loop on its finest clouds split by torch.profiler."""
    from probreg_tpu_torch import config as pcfg
    from probreg_tpu_torch import cpd, pyramid
    from probreg_tpu_torch.ops import gt_cuda as gt
    from probreg_tpu_torch.utils import math_utils as mu
    from probreg_tpu_torch.utils.datagen import blobby_surface

    # The fish at the reference defaults.
    src, tgt = fish_clouds()
    kw = dict(beta=2.0, lmd=2.0, maxiter=50, tol=1e-3)
    log("[nonrigid] registration_cpd nonrigid, the fish (91 points, 2-D), "
        f"{kw}; second calls timed")
    dense_nonrigid(src, tgt, "nonrigid", **kw)  # warm
    dense_nonrigid(src, tgt, "nonrigid", use_pallas=False, **kw)
    res, iters, got, wall = dense_nonrigid(src, tgt, "nonrigid", **kw)
    plain, p_iters, p_got, p_wall = dense_nonrigid(src, tgt, "nonrigid",
                                                   use_pallas=False, **kw)
    disp = float((moved(res, src) - torch.as_tensor(src).double().to(dev))
                 .abs().mean())
    p_disp = float((moved(plain, src) - torch.as_tensor(src).double()
                    .to(dev)).abs().mean())
    log(f"  {iters} iterations, {wall * 1e3:.2f} ms, launches {got}; mean "
        f"displacement {disp:.6f}; use_pallas=False: {p_iters} iterations, "
        f"{p_wall * 1e3:.2f} ms, launches {p_got}, mean displacement "
        f"{p_disp:.6f}")
    if got != {"estep_small": iters} or p_got:
        raise AssertionError(f"fish: launches {got} for {iters} iterations")
    if not abs(disp - p_disp) <= NONRIGID_AGREE:
        raise AssertionError("fish: kernel- and plain-driven mean "
                             "displacements disagree")

    # K2's full width in 3-D, fixed depth.
    src, tgt = nonrigid_3d_pair()
    kw = dict(beta=2.0, lmd=2.0, maxiter=NONRIGID_ITERS, tol=0.0)
    log(f"[nonrigid] registration_cpd nonrigid, {len(src):,} x "
        f"{len(tgt):,} in 3-D, {kw}")
    dense_nonrigid(src, tgt, "nonrigid", **kw)  # warm
    res, iters, got, wall = dense_nonrigid(src, tgt, "nonrigid", **kw)
    plain = dense_nonrigid(src, tgt, "nonrigid", use_pallas=False, **kw)[0]
    dtype = pcfg.config.dtype
    pcfg.config.dtype = torch.float64
    try:
        f64 = dense_nonrigid(src, tgt, "nonrigid", use_pallas=False, **kw)[0]
    finally:
        pcfg.config.dtype = dtype
    err = float((moved(res, src) - moved(plain, src)).abs().max())
    spread = float((moved(plain, src) - f64.transformation.transform(
        src.astype(np.float64))).abs().max())
    resid = float((moved(res, src) - torch.as_tensor(tgt, device=dev))
                  .abs().mean())
    it_ms, k2_ms, solve_ms = split_dense_iteration(src, tgt, kw)
    log(f"  second call {wall:.4f} s, {iters} iterations, launches {got}; "
        f"sigma2 {float(res.sigma2):.6g}, mean residual {resid:.6f} (initial"
        f" {float(np.abs(src - tgt).mean()):.6f}); kernel against plain: max"
        f" |moved diff| {err:.3e} (plain f32 against f64 {spread:.3e})")
    log(f"  one iteration (the 15th, CUDA events): {it_ms:.4f} ms, K2's "
        f"estep_small call {k2_ms:.4f} ms, the M x M solve {solve_ms:.4f} "
        f"ms, the rest {it_ms - k2_ms - solve_ms:.4f} ms")
    if got != {"estep_small": NONRIGID_ITERS} or iters != NONRIGID_ITERS:
        raise AssertionError(f"3-D dense nonrigid: launches {got}")
    if not err <= max(NONRIGID_AGREE, NONRIGID_SPREAD * spread):
        raise AssertionError("3-D dense nonrigid: kernel- and plain-driven "
                             "runs disagree")

    # The constrained model: tests/test_cpd.py's settings on the fish.
    src, tgt = fish_clouds()
    idx = np.arange(0, len(src), 5)
    kw = dict(beta=0.5, lmd=1.0, alpha=1e-6, idx_source=idx,
              idx_target=idx, maxiter=60)
    log("[nonrigid] registration_cpd nonrigid_constrained, the fish, every "
        "fifth point a known pair, beta 0.5, lmd 1, alpha 1e-6, maxiter 60")
    dense_nonrigid(src, tgt, "nonrigid_constrained", **kw)  # warm
    res, iters, got, wall = dense_nonrigid(src, tgt, "nonrigid_constrained",
                                           **kw)
    rmse = float(torch.sqrt(((moved(res, src) - torch.as_tensor(
        tgt, device=dev)) ** 2).sum(1)).mean())
    rmse0 = float(np.sqrt(((src - tgt) ** 2).sum(1)).mean())
    log(f"  {iters} iterations, {wall * 1e3:.2f} ms, launches {got}; "
        f"residual {rmse:.6f} against {rmse0:.6f} at the start")
    if got != {"estep_small": iters} or not rmse < 0.2 * rmse0:
        raise AssertionError("constrained nonrigid missed its bar")

    # The step API on the 1,000-point pair.
    src, tgt = nonrigid_3d_pair()
    ms, out, got = nonrigid_step_api_ms(src, tgt, dev)
    log(f"[nonrigid step API] 1000 x 1000, {STEP_ITERS} iterations of "
        f"NonRigidCPD.expectation_step + maximization_step(sigma2_p): "
        f"{ms:.4f} ms per iteration, launches per run {got}, final sigma2 "
        f"{float(out.sigma2):.4g}")
    if got != {"estep_small": STEP_ITERS} \
            or not math.isfinite(float(out.sigma2)):
        raise AssertionError("nonrigid step API")

    # The low-rank loop at 16,384 points: plain tensors, no kernel.
    src, tgt, disp = lowrank_surface()
    log(f"[nonrigid low-rank] registration_cpd nonrigid, {len(src):,} "
        f"points, {LOWRANK_ARGS}")
    cpd.registration_cpd(src, tgt, "nonrigid", **LOWRANK_ARGS)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = cpd.registration_cpd(src, tgt, "nonrigid", **LOWRANK_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v for k, v in all_launches().items() if v}
    resid = float((moved(res, src) - torch.as_tensor(tgt, device=dev))
                  .abs().mean())
    log(f"  second call {wall:.4f} s, launches {got}, residual {resid:.5f} "
        f"(initial {float(np.abs(disp).mean()):.5f}), sigma2 "
        f"{float(res.sigma2):.6g}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if got or not resid < 0.5 * float(np.abs(disp).mean()):
        raise AssertionError("low-rank nonrigid missed its bar")

    # The low-rank nonrigid pyramid at 100,000 points.
    src = blobby_surface(N_NONRIGID_PYR, seed=2).astype(np.float32)
    defo = (0.02 * np.sin(3.0 * src[:, :1])
            * np.array([[1.0, 0.5, -0.3]])).astype(np.float32)
    tgt = (src + defo).astype(np.float32)
    sizes = pyramid.auto_voxel_sizes(src, tgt, NONRIGID_PYR_ARGS["levels"],
                                     3000, 4.0)
    counts = [len(x) for x in pyramid.build_pyramid(src, sizes)]
    k6 = sum(a * b >= 1 << 28 for a, b in zip(counts, counts[1:]))
    log(f"[nonrigid pyramid] registration_cpd_pyramid nonrigid, "
        f"{N_NONRIGID_PYR:,} points (bench_bcpd_guarded.py's deformation, "
        f"no rotation), {NONRIGID_PYR_ARGS}: levels of {counts} source "
        f"points; {k6} transition(s) with coarse x fine >= 2^28")
    res, wall, levels, got, carries = traced_nonrigid_pyramid(src, tgt)
    tgt_d = torch.as_tensor(tgt, device=dev)
    mv = res.transformation.transform(src)
    nn0 = float(mu.compute_rmse(torch.as_tensor(src, device=dev), tgt_d))
    nn1 = float(mu.compute_rmse(mv, tgt_d))
    log(f"  {wall:.3f} s (first call), levels "
        f"{[(n, round(t, 4), f'{s2:.3g}') for n, t, s2 in levels]} "
        f"(points, s, sigma2), launches {got}; mean |moved - target| by "
        f"index {float((mv - tgt_d).abs().mean()):.6f} (the deformation "
        f"{float(np.abs(defo).mean()):.6f}); NN-RMSE to the target "
        f"{nn1:.6f} (the source's {nn0:.6f})")
    if k6 < 1 or got != {"gauss_transform": k6}:
        raise AssertionError(f"nonrigid pyramid launches {got}, expected "
                             f"{k6} gauss_transform")
    # K6 on the carry it made, against its plain version; then the whole
    # pyramid with the plain version in K6's place.
    a, k, out = next(c for c in carries
                     if len(c[0][0]) * len(c[0][2]) >= 1 << 28)
    gt_cuda = gt._gt_cuda
    gt._gt_cuda = gt.gauss_transform_culled_plain
    try:
        compare("carry", torch.as_tensor(out),
                torch.as_tensor(pyramid._interp_displacement(*a, **k)))
        plain = pyramid.registration_cpd_pyramid(src, tgt, "nonrigid",
                                                 **NONRIGID_PYR_ARGS)
        torch.cuda.synchronize()
    finally:
        gt._gt_cuda = gt_cuda
    d = float((mv - plain.transformation.transform(src)).abs().max())
    log(f"  the plain-driven pyramid: max |moved diff| {d:.3e} (limit "
        f"{NONRIGID_PYR_AGREE:g})")
    if not (d <= NONRIGID_PYR_AGREE and nn1 < nn0):
        raise AssertionError("nonrigid pyramid missed its bar")
    split_lowrank_loop(src, tgt, dev)


def split_lowrank_loop(src, tgt, dev, iters=3):
    """Device time of ``iters`` iterations of the low-rank loop
    (_run_em_nonrigid_lowrank_t, rank 64, the pyramid's finest level) by
    kind of device activity, from torch.profiler: the matrix products,
    the K x K solve and the rest (exp, sums, copies); beside the wall
    time of the same call."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.ops import lowrank

    ys = torch.as_tensor(src, device=dev)
    xs = torch.as_tensor(tgt, device=dev)
    u, lam = lowrank.lowrank_rbf(ys, 2.0, NONRIGID_PYR_ARGS["rank"])

    def run():
        return cpd._run_em_nonrigid_lowrank_t(ys, xs, u, lam, 2.0, w=0.0,
                                              maxiter=iters, tol=0.0)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3
    _, total, by_name = device_launches(run, calls=1)
    groups = {"products": 0.0, "solve": 0.0, "rest": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        key = ("products" if any(k in low for k in ("gemm", "cutlass",
                                                      "xmma", "sm90_"))
               else "solve" if any(k in low for k in (
                   "getrf", "getrs", "trsm", "laswp", "lu_", "solve"))
               else "rest")
        groups[key] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"  low-rank loop at {len(src):,} x {len(tgt):,}, rank "
        f"{NONRIGID_PYR_ARGS['rank']}, {iters} iterations: {wall:.3f} ms "
        f"wall and {total / iters / 1e3:.3f} ms device time per iteration; "
        f"device ms per iteration by kind "
        f"{ {k: round(v / iters / 1e3, 4) for k, v in groups.items()} }; "
        f"largest: {[(n[:60], round(v / iters / 1e3, 4)) for n, v in top]}")


def check_stash_raw(dev, kernels, shared):
    """K11's route on the 150k clouds cut to a 2 x 2 rank's shapes: source
    and target shard 0 of the centred, Morton-sorted clouds (75,000 points
    each), tiles 512 x 512 (registration_cpd_2d's), dense and culled as
    estep_regimes. One E-step makes three launches (stash_den_raw,
    stash_finish, K3's pass B stash_moment) and hands reduce_den one
    (n,) tensor: the raw sums against stash_den_raw_plain, the route
    against the plain E-step (compare()); at one m-shard the same bit for
    bit as K3; the two m-shards of the mesh (the source's halves) with
    their raw sums added, against the unsharded K3 E-step (compare()).
    Each launch is timed per E-step with its bound: K11 K3's pass-A bound
    on the shard's shapes, pass B K3's pass-B bound there, the finish its
    columns' bytes; and the route's peak device memory per E-step."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    out = {}
    t = MESH_TILE
    for (regime, sigma2, ys, xs, scal, _, _, _,
         _) in estep_regimes(dev, shared):
        ysl, xsl = ys[:SHARD], xs[:SHARD]
        mask = ec._active_mask(*ec._tile_bounds(ysl, t),
                               *ec._tile_bounds(xsl, t), scal[0])
        n_i, n_j = mask.shape
        pairs = active_pairs(mask, SHARD, SHARD, t, t)
        log(f"[K11 route] {regime}: sigma2 {sigma2:.6g}, shard {SHARD:,} x "
            f"{SHARD:,}, tiles {t} x {t}, {n_j} stripes, active pairs "
            f"{pairs:.4g}")
        dens = []
        before = dict(ec.LAUNCHES)
        got = ec.stash_estep(ysl, xsl, scal, mask, t, t,
                             reduce_den=lambda d: dens.append(d.clone()))
        torch.cuda.synchronize()
        made = {k: ec.LAUNCHES[k] - before[k] for k in before}
        if made != {**{k: 0 for k in before}, "stash_den_raw": 1,
                    "stash_finish": 1, "stash_moment": 1} \
                or [tuple(d.shape) for d in dens] != [(SHARD,)]:
            raise AssertionError(f"K11 E-step: launches {made}, reductions "
                                 f"{[tuple(d.shape) for d in dens]}")
        y2, x2 = (ysl * ysl).sum(1), (xsl * xsl).sum(1)
        plain_dens = []
        for j in range(n_j):
            c = slice(j * t, (j + 1) * t)
            act = mask[:, j].repeat_interleave(t)[:SHARD]
            plain_dens.append(ec.stash_den_raw_plain(
                ysl, y2, xsl[c], x2[c], scal, act, n_i, t)[1])
        err_raw = compare("den_raw", dens[0], torch.cat(plain_dens))
        del dens, plain_dens
        want = ec.stash_estep_plain(ysl, xsl, scal, mask, t, t)
        err_fin = max(compare("pt1", got[0], want[0]),
                      compare("xx", got[3], want[3]))
        compare("p1", got[1], want[1])
        compare("px", got[2], want[2])
        k3 = ec.stash_estep(ysl, xsl, scal, mask, t, t)
        same = all(torch.equal(a, b) for a, b in zip(got, k3))
        log(f"  one m-shard: K11 + finish + pass B against K3: pt1, p1, px, "
            f"xx {'equal bit for bit' if same else 'NOT equal'}")
        if not same:
            raise AssertionError("K11 + finish + pass B differ from K3")
        del want, k3
        # The m-group of target shard 0: both source halves.
        halves = []
        for y in (ys[:SHARD], ys[SHARD:]):
            halves.append((y, ec._active_mask(
                *ec._tile_bounds(y, t), *ec._tile_bounds(xsl, t), scal[0])))
        total = torch.zeros_like(xsl[:, 0])
        for y, mk in halves:
            ec.stash_estep(y, xsl, scal, mk, t, t,
                           reduce_den=lambda d: total.add_(d))
        parts = [ec.stash_estep(y, xsl, scal, mk, t, t,
                                reduce_den=lambda d: d.copy_(total))
                 for y, mk in halves]
        whole = ec.stash_estep(ys, xsl, scal, ec._active_mask(
            *ec._tile_bounds(ys, t), *ec._tile_bounds(xsl, t), scal[0]), t, t)
        torch.cuda.synchronize()
        log("  two m-shards, raw sums added, against K3 on the whole source:")
        for k, name in enumerate(("pt1", "xx")):
            for part in parts:
                compare(name, part[(0, 3)[k]], whole[(0, 3)[k]])
        compare("p1", torch.cat([p[1] for p in parts]), whole[1])
        compare("px", torch.cat([p[2] for p in parts]), whole[2])
        del parts, whole, total, halves
        peak = estep_peak_mib(lambda: ec.stash_estep(
            ysl, xsl, scal, mask, t, t, reduce_den=lambda d: None))
        plan = ec.ShardStashPlan(ysl, xsl, scal, mask, t, t, None)
        ms_raw = timed(plan.den_raw, 5)
        ms_fin = timed(plan.finish, 5)
        ms_mom = timed(plan.moment, 5)
        del plan
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        plain_raw = plain_mom = 0.0
        raws, gs = [], []
        for j in range(n_j):
            c = slice(j * t, (j + 1) * t)
            act = mask[:, j].repeat_interleave(t)[:SHARD]
            e[0].record()
            g, den = ec.stash_den_raw_plain(ysl, y2, xsl[c], x2[c], scal,
                                            act, n_i, t)
            e[1].record()
            torch.cuda.synchronize()
            plain_raw += e[0].elapsed_time(e[1])
            raws.append(den)
            del g
        den = torch.cat(raws)
        e[0].record()
        inv_den = ec._plain_finish(den, x2, scal)[0]
        e[1].record()
        torch.cuda.synchronize()
        plain_fin = e[0].elapsed_time(e[1])
        for j in range(n_j):  # pass B from the stripe's g, formed again
            c = slice(j * t, (j + 1) * t)
            act = mask[:, j].repeat_interleave(t)[:SHARD]
            g, _ = ec.stash_den_raw_plain(ysl, y2, xsl[c], x2[c], scal, act,
                                          n_i, t)
            e[2].record()
            ec._plain_pass_b(g, inv_den[c], xsl[c])
            e[3].record()
            torch.cuda.synchronize()
            plain_mom += e[2].elapsed_time(e[3])
            del g
        b_raw, b_mom = estep_pass_bounds(SHARD, SHARD, pairs)
        # The finish per column: reads den_raw and |x|^2, writes inv_den
        # and pt1 (16 B); the where, the add, the division, the product
        # and the xx term (5 operations).
        b_fin = bound(16 * SHARD, 5 * SHARD)
        log(f"  per E-step, one launch each: K11 {ms_raw:.3f} ms  plain "
            f"{plain_raw:.3f} ms  bound {b_raw[0]:.3f} ms ({b_raw[1]}); "
            f"finish {ms_fin:.4f} ms  plain {plain_fin:.4f} ms  bound "
            f"{b_fin[0]:.5f} ms ({b_fin[1]}); pass B {ms_mom:.3f} ms  plain "
            f"{plain_mom:.3f} ms (from the stripe's g)  bound {b_mom[0]:.3f} "
            f"ms ({b_mom[1]}); the route {ms_raw + ms_fin + ms_mom:.3f} ms")
        log(f"  one E-step: peak device memory {peak:.3f} MiB above its "
            f"inputs ({SHARD:,} x {t} f32 would be "
            f"{4 * SHARD * t / 2**20:.1f} MiB)")
        out[regime] = (err_raw, err_fin, ms_raw, ms_fin, plain_raw,
                       plain_fin, b_raw, b_fin)
    (err_raw, err_fin, ms_raw, ms_fin, p_raw, p_fin, b_raw,
     b_fin) = out["dense"]
    kernels["stash_den_raw"] = dict(
        max_abs_err=max(err_raw, out["culled"][0]), ms=ms_raw,
        plain_ms=p_raw, bound_ms=b_raw[0], bound_by=b_raw[1])
    kernels["stash_finish"] = dict(
        max_abs_err=max(err_fin, out["culled"][1]), ms=ms_fin,
        plain_ms=p_fin, bound_ms=b_fin[0], bound_by=b_fin[1])


def rot_error(lin, rot):
    from probreg_tpu_torch.utils import se3_op

    return float(se3_op.rotation_angle(torch.as_tensor(lin).double(),
                                       torch.as_tensor(rot).double()))


def lowrank_against_single(name, disp, counts, got, want_launches,
                           single, tol):
    """Checks a sharded low-rank nonrigid run given as its displacement
    ``disp`` (M, D numpy) against the single-card run ``single`` = (moved
    source, residual): E-steps, launches, max |moved diff| within ``tol``
    and, for tol LOWRANK_SORTED, the residual within LOWRANK_RESIDUAL of
    the single card's."""
    src, tgt, _ = lowrank_surface()
    mv = src + disp
    d = float(np.abs(mv - single[0]).max())
    resid = float(np.abs(mv - tgt).mean())
    log(f"  {name}: counts {counts}, launches {got}; against the single "
        f"card: max |moved diff| {d:.3e} (limit {tol:g}), residual "
        f"{resid:.6f} against {single[1]:.6f}")
    if counts["esteps"] != SHARDED_LOWRANK_ITERS or got != want_launches:
        raise AssertionError(f"{name}: E-steps or launches wrong")
    if want_launches and counts["den_all_reduce"] != SHARDED_LOWRANK_ITERS:
        raise AssertionError(f"{name}: den reductions wrong")
    if not d <= tol or (tol == LOWRANK_SORTED
                        and not resid <= LOWRANK_RESIDUAL * single[1]):
        raise AssertionError(f"{name} disagrees with the single card")


def run_sharded_lowrank_one_rank(dev, shared):
    """Inside run_sharded_one_rank's NCCL group: the low-rank nonrigid kind
    on the 16,384-point surface (rank 60, SHARDED_LOWRANK_ITERS
    iterations, tol 0) through registration_cpd_sharded on a 1-D mesh (the
    dense sharded E-step, no kernel) and registration_cpd_2d on a culled
    1 x 1 mesh (K11's route: three launches and one den reduction per
    E-step), each second call timed, against cpd.registration_cpd."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.parallel import mesh as pmesh
    from probreg_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                            registration_cpd_2d,
                                            registration_cpd_sharded)

    src, tgt, _ = lowrank_surface()
    kw = dict(maxiter=SHARDED_LOWRANK_ITERS, tol=0.0,
              rank=LOWRANK_ARGS["rank"], device=dev)
    one = cpd.registration_cpd(src, tgt, "nonrigid", **kw)
    mv = one.transformation.transform(src).cpu().numpy()
    single = (mv, float(np.abs(mv - tgt).mean()))
    shared["lowrank_single"] = single
    k11 = dict.fromkeys(K11_ROUTE, SHARDED_LOWRANK_ITERS)
    for name, fn, mesh, want, tol in (
            ("1-D low-rank", registration_cpd_sharded, make_mesh(), {},
             LOWRANK_SAME_FACTORS),
            ("1 x 1 low-rank, culled", registration_cpd_2d,
             make_mesh_2d(1, 1), k11, LOWRANK_SORTED)):
        extra = {} if want == {} else dict(use_culled=True)
        log(f"[mesh, one NCCL rank] {fn.__name__} nonrigid rank "
            f"{kw['rank']}, {len(src):,} points, {SHARDED_LOWRANK_ITERS} "
            "iterations")
        fn(src, tgt, "nonrigid", mesh=mesh, **kw, **extra)  # warm
        torch.cuda.synchronize()
        reset_launches()
        pmesh.reset_counts()
        t0 = time.perf_counter()
        res = fn(src, tgt, "nonrigid", mesh=mesh, **kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr = res.transformation
        log(f"  timed call {wall:.4f} s")
        lowrank_against_single(
            name, (tr.u @ tr.zc).cpu().numpy(), dict(pmesh.COUNTS),
            {k: v for k, v in all_launches().items() if v}, want, single,
            tol)


def run_sharded_one_rank(dev, launches, shared):
    """The sharded runners on one NCCL rank (world size 1, file://
    rendezvous): registration_cpd_sharded on a 1-D mesh (K3 per shard) and
    registration_cpd_2d on a 1 x 1 mesh (K11's route: three launches and
    one den all_reduce per E-step) on the 150k pair, culled, MESH_ITERS
    iterations; the second call of each timed beside cpd.registration_cpd
    at the same depth. Both reach the 150k phase's bar and agree within
    MESH_AGREE. Then the low-rank nonrigid kind on both meshes
    (run_sharded_lowrank_one_rank) and the den all_reduce (N_LARGE floats,
    the 1 x 1 rank's target shard) under NCCL at world 1."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.parallel import mesh as pmesh
    from probreg_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                            registration_cpd_2d,
                                            registration_cpd_sharded)

    src, tgt, rot = large_clouds(dev)
    kw = dict(maxiter=MESH_ITERS, tol=0.0, use_culled=True, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            world_size=1, rank=0)
    try:
        runs = {}
        for name, fn, mesh in (("1-D", registration_cpd_sharded,
                                make_mesh()),
                               ("1 x 1", registration_cpd_2d,
                                make_mesh_2d(1, 1))):
            log(f"[mesh, one NCCL rank] {fn.__name__} on a {name} mesh, "
                f"{N_LARGE:,} points, culled, {MESH_ITERS} iterations")
            fn(src, tgt, "rigid", mesh=mesh, **kw)  # warm
            torch.cuda.synchronize()
            reset_launches()
            pmesh.reset_counts()
            t0 = time.perf_counter()
            res = fn(src, tgt, "rigid", mesh=mesh, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v for k, v in all_launches().items() if v}
            counts = dict(pmesh.COUNTS)
            err = rot_error(res.transformation.rot.cpu(), rot)
            log(f"  timed call {wall:.3f} s, counts {counts}, rotation "
                f"error {err:.3e} rad, sigma2 {float(res.sigma2):.6g}")
            log(f"  launches: {got}")
            if counts["esteps"] != MESH_ITERS:
                raise AssertionError(f"{name}: {counts['esteps']} E-steps")
            if name == "1 x 1":
                if got != dict.fromkeys(K11_ROUTE, MESH_ITERS) \
                        or counts["den_all_reduce"] != MESH_ITERS:
                    raise AssertionError(f"1 x 1 mesh launches {got}, den "
                                         "reductions "
                                         f"{counts['den_all_reduce']}")
                launches.update(stash_den_raw=got["stash_den_raw"],
                                stash_finish=got["stash_finish"])
            elif not (got.get("stash_den", 0) > 0
                      and set(got) == {"stash_den", "stash_moment"}):
                raise AssertionError(f"1-D mesh launches {got}")
            if not (math.isfinite(float(res.sigma2)) and err <= ROT_ERR_MAX):
                raise AssertionError(f"{name} mesh run missed the bar")
            runs[name] = (res.transformation, wall)
        cpd.registration_cpd(src, tgt, "rigid", maxiter=MESH_ITERS,
                             tol=0.0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = cpd.registration_cpd(src, tgt, "rigid", maxiter=MESH_ITERS,
                                   tol=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        a, b = runs["1-D"][0], runs["1 x 1"][0]
        d_rot = float((a.rot - b.rot).abs().max())
        d_t = float((a.t - b.t).abs().max())
        err = rot_error(one.transformation.rot.cpu(), rot)
        log(f"  cpd.registration_cpd at the same depth {wall:.3f} s "
            f"(rotation error {err:.3e} rad); 1-D {runs['1-D'][1]:.3f} s, "
            f"1 x 1 {runs['1 x 1'][1]:.3f}"
            f" s; 1-D against 1 x 1: max |rot diff| {d_rot:.3e}, max |t diff|"
            f" {d_t:.3e}")
        if not (d_rot <= MESH_AGREE and d_t <= MESH_AGREE):
            raise AssertionError("the 1-D and 1 x 1 mesh runs disagree")
        shared["one_rank"] = {k: (v[0].rot.cpu().numpy(),
                                  v[0].t.cpu().numpy())
                              for k, v in runs.items()}
        run_sharded_lowrank_one_rank(dev, shared)
        buf = torch.ones(N_LARGE, device=dev)
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REDUCE_REPS):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        log(f"  den all_reduce ({N_LARGE:,} floats) under NCCL, world 1: "
            f"{(time.perf_counter() - t0) * 1e3 / REDUCE_REPS:.4f} ms")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def same_on_every_rank(name, outs):
    """Every rank made the same E-steps and returned the same numbers bit
    for bit."""
    first = outs[0]
    for r, o in enumerate(outs[1:], 1):
        res = o["result"] if isinstance(o["result"], list) else [o["result"]]
        ref = first["result"] if isinstance(first["result"], list) \
            else [first["result"]]
        if o["counts"]["esteps"] != first["counts"]["esteps"] or not all(
                np.array_equal(a[k], b[k]) for a, b in zip(res, ref)
                for k in a):
            raise AssertionError(f"{name}: rank {r} differs from rank 0")


def run_mesh_on_one_card(dev, launches, shared):
    """Four ranks on the one card under gloo (all_reduce on CUDA tensors):
    a correctness run of the cross-shard collectives, not a 4-card figure.
    One spawn runs, in every rank, each call twice (the second timed):
    registration_cpd_2d on a 2 x 2 mesh and registration_cpd_sharded on a
    1-D mesh of 4 at 150k (culled, MESH_ITERS iterations),
    registration_cpd_batch_sharded on the 256 ragged horse pairs, the CPD
    pyramid with mesh= (2 x 2) at 200k, the den all_reduce's cost (SHARD
    floats, a 2 x 2 rank's target shard) and the low-rank nonrigid kind on
    a 2 x 2 mesh (the 16,384-point surface, culled). Every rank must
    report the same iterations and numbers; the 150k runs reach the 150k
    phase's bar and agree with the one-rank runs within MESH_AGREE; the
    batch equals registration_cpd_batch bit for bit; the pyramid meets the
    reference test's bar; the low-rank run makes K11's three launches per
    E-step in every rank and stays within LOWRANK_SORTED of the
    single-card run (lowrank_against_single)."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.parallel import _spmd

    src, tgt, rot = large_clouds(dev)
    rigid, _ = serving_batches()
    srcs, tgts = [p[0] for p in rigid], [p[1] for p in rigid]
    psrc, ptgt, prot, pt = pyramid_case(PYRAMID_SIZES[0])
    kw = dict(maxiter=MESH_ITERS, tol=0.0, use_culled=True)
    lsrc, ltgt, _ = lowrank_surface()
    calls = [("cpd_2d", (2, 2), (src, tgt, "rigid"), kw),
             ("cpd_sharded", (4,), (src, tgt, "rigid"), kw),
             ("cpd_batch_sharded", (4,), (srcs, tgts, "rigid"), {}),
             ("cpd_pyramid", (2, 2), (psrc, ptgt, "rigid"), PYRAMID_ARGS),
             ("all_reduce_cost", (2, 2), ("m", SHARD, REDUCE_REPS), {}),
             ("cpd_2d", (2, 2), (lsrc, ltgt, "nonrigid"),
              dict(maxiter=SHARDED_LOWRANK_ITERS, tol=0.0,
                   rank=LOWRANK_ARGS["rank"], use_culled=True))]
    log("[mesh, 4 gloo ranks on one card] 2 x 2 registration_cpd_2d and "
        f"1-D x 4 registration_cpd_sharded at {N_LARGE:,} points, "
        f"registration_cpd_batch_sharded on {len(srcs)} ragged pairs, the "
        f"CPD pyramid with mesh= at {PYRAMID_SIZES[0]:,} points")
    t0 = time.perf_counter()
    outs = _spmd.run_spmd(_spmd.rank_calls, 4, "gloo", "cuda:0", calls, 2,
                          timeout=600.0)
    log(f"  spawn and both rounds {time.perf_counter() - t0:.1f} s")
    per_call = [[rank[i] for rank in outs] for i in range(len(calls))]
    names = ["2 x 2", "1-D x 4", "batch", "pyramid", "all_reduce",
             "2 x 2 low-rank"]
    for name, res in zip(names, per_call):
        log(f"  {name}: timed call {max(o['seconds'] for o in res):.3f} s "
            f"(slowest rank), counts {res[0]['counts']}, launches per rank "
            f"{[o['launches'] for o in res]}")
        if name != "all_reduce":  # a time, each rank's own
            same_on_every_rank(name, res)
    one = shared.get("one_rank", {})
    for name, res, want, mine in (
            ("2 x 2", per_call[0], one.get("1 x 1"), "stash_den_raw"),
            ("1-D x 4", per_call[1], one.get("1-D"), "stash_den")):
        r0 = res[0]["result"]
        err = rot_error(r0["lin"], rot)
        log(f"  {name}: rotation error {err:.3e} rad, sigma2 "
            f"{r0['sigma2']:.6g}")
        if not err <= ROT_ERR_MAX or res[0]["counts"]["esteps"] != \
                MESH_ITERS:
            raise AssertionError(f"{name} missed the bar")
        for r, o in enumerate(res):
            got = o["launches"]
            if mine == "stash_den_raw":  # three launches, one reduction
                ok = (got == dict.fromkeys(K11_ROUTE, MESH_ITERS)
                      and o["counts"]["den_all_reduce"] == MESH_ITERS)
            else:
                ok = (got.get(mine, 0) > 0
                      and set(got) == {"stash_den", "stash_moment"})
            if not ok:
                raise AssertionError(f"{name}: rank {r} launches {got}, "
                                     f"counts {o['counts']}")
        if want is not None:
            d = max(float(np.abs(r0["lin"] - want[0]).max()),
                    float(np.abs(r0["t"] - want[1]).max()))
            log(f"  {name} against the one-rank run: max |diff| {d:.3e}")
            if not d <= MESH_AGREE:
                raise AssertionError(f"{name} disagrees with one rank")
    ref = cpd.registration_cpd_batch(srcs, tgts, "rigid")
    got = per_call[2][0]["result"]
    for b, (g, r) in enumerate(zip(got, ref)):
        tr = r.transformation
        if not (np.array_equal(g["lin"], tr.rot.cpu().numpy())
                and np.array_equal(g["t"], tr.t.cpu().numpy())
                and g["scale"] == float(tr.scale)
                and g["sigma2"] == float(r.sigma2) and g["q"] == float(r.q)):
            raise AssertionError(f"sharded batch pair {b} differs from "
                                 "registration_cpd_batch")
    if any(o["launches"] != {"em_rigid": 1} for o in per_call[2]):
        raise AssertionError("sharded batch: not one K1 launch per rank")
    log(f"  batch: all {len(got)} pairs equal registration_cpd_batch bit "
        "for bit")
    g = per_call[3][0]["result"]
    ang = rot_error(g["lin"], prot)
    t_err = float(np.abs(g["t"] - pt).max())
    s_err = abs(g["scale"] - 1.0)
    log(f"  pyramid: rotation error {ang:.3e} rad, |t - t_gt| {t_err:.3e}, "
        f"|scale - 1| {s_err:.3e}")
    if not (ang < PYR_ANGLE_MAX and t_err <= PYR_T_MAX
            and s_err <= PYR_SCALE_MAX):
        raise AssertionError("mesh pyramid missed the reference test's bar")
    if not all(o["launches"].get("stash_den_raw", 0) > 0
               for o in per_call[3]):
        raise AssertionError("mesh pyramid did not run K11 on every rank")
    ms = [o["result"] for o in per_call[4]]
    log(f"  den all_reduce ({SHARD:,} floats, m-axis of 2) under "
        f"gloo, CUDA tensors, 4 ranks on one card: "
        f"{', '.join(f'{x:.4f}' for x in ms)} ms per call by rank")
    single = shared.get("lowrank_single")
    if single is None:
        raise AssertionError("2 x 2 low-rank: no single-card run to hold it "
                             "to (run_sharded_one_rank failed)")
    for r, o in enumerate(per_call[5]):
        lowrank_against_single(
            f"2 x 2 low-rank, rank {r}", o["result"]["disp"], o["counts"],
            o["launches"], dict.fromkeys(K11_ROUTE, SHARDED_LOWRANK_ITERS),
            single, LOWRANK_SORTED)


# --------------------------------------------------------------------------
# --parent DIR: this checkout's K1, K5, K7 and K10 against another
# checkout's build
# --------------------------------------------------------------------------

def parent_libs(parent):
    """Build ``parent``'s csrc/{em,gmmtree,frg,icp}.cu with the port's
    flags (one nvcc each, started together) into ``parent``/build and load
    them: K1 (with a cluster size and a work order) gets the parent's own
    signature; K5, K7 and K10 run through this checkout's wrappers, whose C
    signatures the parent shares (through_parent)."""
    import ctypes

    from probreg_tpu_torch.ops import _build

    out_dir = os.path.join(parent, "build", "parent_kernels")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("em", "gmmtree", "frg", "icp"):
        out = os.path.join(out_dir, f"lib{name}.so")
        src = os.path.join(parent, "probreg_tpu_torch", "csrc", f"{name}.cu")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{log_text}")
        libs[name] = ctypes.CDLL(out)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["em"].probreg_em_cpd.argtypes = [P, I, P, I, P, P, I, I, F, I, F,
                                          I, I, P, P]
    return libs


def parent_em(lib, s_c, t_c, counts, *, affine, w, maxiter, tol,
              update_scale):
    """The parent's K1 as its own wrapper launches it (launch_plan's
    clusters and order, which give the bits of one block per pair)."""
    from probreg_tpu_torch.ops import em_cuda as em
    from probreg_tpu_torch.ops.estep_cuda import _check, _stream

    g, order = em.launch_plan(s_c.shape[0], counts, em.sm_count(s_c.device))
    out = s_c.new_empty((s_c.shape[0], 16))
    _check(lib.probreg_em_cpd(
        s_c.data_ptr(), s_c.shape[1], t_c.data_ptr(), t_c.shape[1],
        None if counts is None else counts.data_ptr(),
        None if order is None else order.data_ptr(), s_c.shape[0], g, w,
        maxiter, tol, int(update_scale), int(affine), out.data_ptr(),
        _stream(s_c)), "parent em_cpd")
    return out


def through_parent(lib, name, fn, *a, **kw):
    """``fn``, a wrapper of this checkout, with csrc/``name``.cu's library
    replaced by the parent's build: for kernels whose C signature the two
    checkouts share."""
    from probreg_tpu_torch.ops import _build

    own = _build.load
    _build.load = lambda n: lib if n == name else own(n)
    try:
        return fn(*a, **kw)
    finally:
        _build.load = own


def parent_frg(lib, s_c, t_c, n_c, counts, **kw):
    """The parent's K5 through this checkout's wrapper, whose C signature
    the parent shares."""
    from probreg_tpu_torch.ops import frg_cuda as fc

    return through_parent(lib, "frg", fc._frg_cuda, s_c, t_c, n_c, counts,
                          **kw)


def parent_icp(lib, s_c, t_c, counts, init, **kw):
    """The parent's K7 through this checkout's wrapper, whose C signature
    the parent shares."""
    from probreg_tpu_torch.ops import icp_cuda as ic

    return through_parent(lib, "icp", ic._icp_cuda, s_c, t_c, counts, init,
                          **kw)


def against_parent(label, parent_fn, this_fn, depths, batch):
    """``this_fn(_cluster=g)`` for G = 1, 2, 4, 8 and the default against
    ``parent_fn()`` bit for bit at each (maxiter, tol) of ``depths``; then,
    at the first depth, the ms of both in the order parent, this, this,
    parent, this at each G, and (a ragged batch past the SMs) this in
    arrival order. Returns the number of depths that differ."""
    from probreg_tpu_torch.ops import em_cuda as em

    bad = 0
    for maxiter, tol in depths:
        want = parent_fn(maxiter, tol)
        same = [bool(torch.equal(this_fn(maxiter, tol, _cluster=g), want))
                for g in (1, 2, 4, 8, None)]
        bad += not all(same)
        log(f"[{label}] maxiter {maxiter} tol {tol}: bit for bit at G = 1, "
            f"2, 4, 8, default: {same}")
    maxiter, tol = depths[0]
    p0 = timed(lambda: parent_fn(maxiter, tol), 5)
    n0 = timed(lambda: this_fn(maxiter, tol), 5)
    n1 = timed(lambda: this_fn(maxiter, tol), 5)
    p1 = timed(lambda: parent_fn(maxiter, tol), 5)
    per_g = [timed(lambda: this_fn(maxiter, tol, _cluster=g), 5)
             for g in (1, 2, 4, 8)]
    g = em.cluster_size(batch, em.sm_count("cuda"))
    text = (f"  {maxiter} iterations: parent {p0:.4f} / {p1:.4f} ms, this "
            f"{n0:.4f} / {n1:.4f} ms (G = {g}); at G = 1, 2, 4, 8: "
            + ", ".join(f"{v:.4f}" for v in per_g) + " ms")
    if batch > em.sm_count("cuda"):
        arrival = timed(lambda: this_fn(maxiter, tol, _cluster=1,
                                        _ordered=False), 5)
        text += f"; in arrival order at G = 1 {arrival:.4f} ms"
    log(text)
    return bad


def parent_reg(lib, ys, counts, table, init, **kw):
    """The parent's K10 through this checkout's wrapper: its C signature
    (with blocks per pair and scratch) is this checkout's."""
    from probreg_tpu_torch.ops import gmmtree_cuda as gc

    return through_parent(lib, "gmmtree", gc._reg_cuda, ys, counts, table,
                          init, **kw)


def small_case(m, n, dim, dev, seed=1):
    """A K2 input of (M, N, D): uniform clouds in [-1, 1]^D, w 0.05 and
    sigma2 a twentieth of the CPD initializer (the annealed regime, where
    the normalizers spread over orders of magnitude)."""
    from probreg_tpu_torch.utils import math_utils

    rng = np.random.default_rng(seed)
    ys = torch.as_tensor(rng.uniform(-1, 1, (m, dim)), dtype=torch.float32,
                         device=dev)
    xs = torch.as_tensor(rng.uniform(-1, 1, (n, dim)), dtype=torch.float32,
                         device=dev)
    return ys, xs, math_utils.squared_kernel_sum(ys, xs) * 0.05, 0.05


def parent_small(lib, ys, xs, sigma2, w):
    """The parent's K2 (float4-packed clouds, a ticket, one block per 32
    targets) as its wrapper called it. Returns (launch, call): launch()
    reruns the kernel on buffers prepared once, call() does the parent
    wrapper's whole work (scalars, packing, allocations, launch, n_p) and
    returns (pt1, p1, px, n_p, xx)."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    (m, dim), n = ys.shape, xs.shape[0]

    def pack(p):
        out = p.new_zeros((p.shape[0], 4))
        out[:, :dim] = p
        out[:, 3] = (p * p).sum(1)
        return out

    def run(scal, y4, x4):
        blocks = -(-n // 32)
        bufs = [y4.new_empty(n), y4.new_empty((blocks, m, 4)),
                y4.new_empty(blocks),
                torch.zeros(1, dtype=torch.int32, device=y4.device),
                y4.new_empty((m, 4)), y4.new_empty(())]

        def launch():
            ec._check(lib.probreg_estep_small(
                y4.data_ptr(), m, x4.data_ptr(), n, scal.data_ptr(),
                *[b.data_ptr() for b in bufs], ec._stream(y4)),
                "parent estep_small")
        return launch, bufs

    launch, _ = run(ec._scalars(sigma2, w, m, n, dim, ys.device), pack(ys),
                    pack(xs))

    def call():
        go, bufs = run(ec._scalars(sigma2, w, m, n, dim, ys.device),
                       pack(ys), pack(xs))
        go()
        p1px = bufs[4]
        return bufs[0], p1px[:, 3], p1px[:, :dim], p1px[:, 3].sum(), bufs[5]
    return launch, call


def parent_estep_lib(parent):
    """``parent``'s csrc/estep.cu built with the port's flags, its K2 entry
    typed with the parent's C signature."""
    import ctypes

    from probreg_tpu_torch.ops import _build

    out_dir = os.path.join(parent, "build", "parent_kernels")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libestep.so")
    src = os.path.join(parent, "probreg_tpu_torch", "csrc", "estep.cu")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's estep.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probreg_estep_small.argtypes = [P, I, P, I] + [P] * 8
    lib.probreg_estep_small.restype = I
    return lib


def step_clouds():
    """The step API's two pairs: bench.py's bunny (390 points, the target
    turned 10 degrees about z) and a 1,000-point pair uniform in [-1, 1]^3,
    the target turned (3, -2, 5) degrees."""
    from probreg_tpu_torch.utils import se3_op

    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    rot = se3_op.euler2mat(*np.deg2rad([3.0, -2.0, 5.0])).double().numpy()
    return {"bunny": bunny_clouds(z_rotation(10.0)),
            "1000x1000": (src, (src @ rot.T).astype(np.float32))}


def step_api_ms(src, tgt, iters=STEP_ITERS, reps=11):
    """Wall ms per iteration of the step API (RigidCPD.expectation_step,
    then maximization_step, the moved source and sigma2 carried on) over
    ``iters`` iterations ending in a synchronize, the median of ``reps``
    runs after a warm one (the host's clock: a run spreads by tens of
    percent on a shared host); and the last M-step's result."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.utils import math_utils

    dev = torch.device("cuda")
    s = torch.as_tensor(src, device=dev)
    t = torch.as_tensor(tgt, device=dev)
    reg = cpd.RigidCPD(s, device=dev)
    sigma2_0 = math_utils.squared_kernel_sum(s, t)

    def run():
        ts, sigma2 = s, sigma2_0
        for _ in range(iters):
            res = reg.maximization_step(
                t, reg.expectation_step(ts, t, sigma2, 0.0))
            ts, sigma2 = res.transformation.transform(s), res.sigma2
        torch.cuda.synchronize()
        return res

    run()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) / iters * 1e3, res


def step_api_main(npz):
    """Print the step API's ms per iteration on the pairs saved in ``npz``
    as one JSON line (run by step_api_in with the checkout's package first
    on the path)."""
    data = np.load(npz)
    names = sorted({key.rsplit("_", 1)[0] for key in data.files})
    print(json.dumps({name: step_api_ms(data[f"{name}_src"],
                                        data[f"{name}_tgt"])[0]
                      for name in names}), flush=True)


def step_api_in(checkout):
    """step_api_main in a fresh process whose probreg_tpu_torch is
    ``checkout``'s (its kernels built there at first use); {pair: ms}."""
    here = os.path.dirname(os.path.abspath(__file__))
    npz = os.path.join(here, "build", "step_clouds.npz")
    os.makedirs(os.path.dirname(npz), exist_ok=True)
    np.savez(npz, **{f"{name}_{k}": a for name, pair in step_clouds().items()
                     for k, a in zip(("src", "tgt"), pair)})
    checkout = os.path.abspath(checkout)
    # This file by its path: the checkout may hold a chip_smoke.py of its own.
    code = ("import importlib.util, sys\n"
            f"sys.path.insert(0, {checkout!r})\n"
            "spec = importlib.util.spec_from_file_location("
            f"'smoke', {os.path.abspath(__file__)!r})\n"
            "smoke = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(smoke)\n"
            f"smoke.step_api_main({npz!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"step API run in {checkout} failed:\n"
                           f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def k2_against_parent(parent, this=True) -> int:
    """K2 of this checkout against ``parent``'s build at every
    SMALL_SHAPES shape: the largest difference of each output, the raw
    launch and the whole call of both in the order parent, this, this,
    parent; then the step API's ms per iteration in fresh processes,
    parent, this, this, parent, STEP_QUADS times over: 2 STEP_QUADS pairs
    of neighbours, each read as this / parent (the host's clock spreads
    more from run to run than K2's gain, so one pair decides nothing).
    ``this=False`` times the parent alone.
    Returns the number of shapes where this checkout's K2 failed."""
    from probreg_tpu_torch.ops import estep_cuda as ec

    dev = torch.device("cuda")
    lib = parent_estep_lib(parent)
    bad = 0
    for m, n, dim in SMALL_SHAPES:
        ys, xs, sigma2, w = small_case(m, n, dim, dev)
        p_launch, p_call = parent_small(lib, ys, xs, sigma2, w)
        p_raw = [timed(lambda: [p_launch() for _ in range(SMALL_REPS)], 5)
                 / SMALL_REPS]
        p_whole = [timed(p_call, 50)]
        p_dev = [device_us(p_launch) / 1e3]
        text = f"[K2 against the parent] {m} x {n}, D = {dim}: "
        if this:
            want = p_call()
            got = ec.estep_small(ys, xs, sigma2, w)
            diff = max(float((a.double() - b.double()).abs().max()
                             / max(float(b.double().abs().max()), 1e-30))
                       for a, b in zip((got.pt1, got.p1, got.px, got.n_p,
                                        got.xx), want))
            raw, _ = ec.small_launcher(ys, xs, sigma2, w)
            n_raw, n_whole, n_dev = [], [], []
            for _ in range(2):
                n_raw.append(timed(lambda: [raw() for _ in
                                            range(SMALL_REPS)], 5)
                             / SMALL_REPS)
                n_whole.append(timed(lambda: ec.estep_small(ys, xs, sigma2,
                                                            w), 50))
                n_dev.append(device_us(raw) / 1e3)
            text += (f"largest difference from the parent {diff:.3e} of the "
                     f"output's largest entry; this: device "
                     f"{n_dev[0]:.5f} / {n_dev[1]:.5f} ms, raw launch "
                     f"{n_raw[0]:.4f} / {n_raw[1]:.4f} ms, whole call "
                     f"{n_whole[0]:.4f} / {n_whole[1]:.4f} ms; ")
            bad += not diff <= RTOL
        p_raw.append(timed(lambda: [p_launch() for _ in range(SMALL_REPS)], 5)
                     / SMALL_REPS)
        p_whole.append(timed(p_call, 50))
        p_dev.append(device_us(p_launch) / 1e3)
        log(text + f"parent: device {p_dev[0]:.5f} / {p_dev[1]:.5f} ms, raw "
            f"launch {p_raw[0]:.4f} / {p_raw[1]:.4f} ms, whole call "
            f"{p_whole[0]:.4f} / {p_whole[1]:.4f} ms")
    here = os.path.dirname(os.path.abspath(__file__))
    order = (["parent", "this", "this", "parent"] * STEP_QUADS if this
             else ["parent"] * 2)
    runs = [step_api_in(parent if who == "parent" else here)
            for who in order]
    for name in runs[0]:
        ms = [r[name] for r in runs]
        log(f"[step API against the parent] {name}, {STEP_ITERS} "
            f"iterations of expectation_step + maximization_step, ms per "
            f"iteration ({', '.join(order[:4])}, ...): "
            + " / ".join(f"{v:.4f}" for v in ms))
        if this:
            # Neighbours (0, 1), (2, 3), ...: one parent and one this each.
            ratio = sorted(ms[i + (order[i] == "parent")]
                           / ms[i + (order[i] == "this")]
                           for i in range(0, len(ms), 2))
            mid = len(ratio) // 2
            med = (ratio[mid] + ratio[~mid]) / 2
            log(f"[step API against the parent] {name}: this / parent in "
                f"{len(ratio)} neighbouring pairs, sorted: "
                + ", ".join(f"{r:.3f}" for r in ratio)
                + f"; median {med:.4f}; this lower in "
                f"{sum(r < 1 for r in ratio)} of {len(ratio)}")
    return bad


def compare_with_parent(parent) -> int:
    """K2 and the step API of this checkout against ``parent``'s
    (k2_against_parent). K1 of this checkout against ``parent``'s build,
    bit for bit, on the
    bunny, a 1024 x 1024 pair, the masked 700/900 pair and both serving
    batches, for clusters of 1, 2, 4 and 8 blocks and the default, at a
    fixed depth and with the loop test; times of both in the order parent,
    this, this, parent. K10 of both on the 150k pair and the 256 horse
    pairs: times and the largest difference. K5 and K7 as K1
    (compare_frg_icp_with_parent). The fixed cost of an iteration of K1,
    K5 and K7 on a 32 x 32 pair."""
    from probreg_tpu_torch import gmmtree as pgt
    from probreg_tpu_torch.ops import em_cuda as em
    from probreg_tpu_torch.ops import gmmtree_cuda as gc
    from probreg_tpu_torch.ops.em_cuda import _compact

    dev = torch.device("cuda")
    bad = k2_against_parent(parent)
    libs = parent_libs(parent)
    rng = np.random.default_rng(5)
    big = rng.uniform(-1, 1, (1024, 3))
    big_t = rng.permutation(big @ z_rotation(12.0).T
                            + 0.01 * rng.standard_normal(big.shape))
    smask = torch.zeros(1, 1024, device=dev)
    tmask = torch.zeros(1, 1024, device=dev)
    smask[0, torch.as_tensor(rng.permutation(1024)[:700])] = 1.0
    tmask[0, torch.as_tensor(rng.permutation(1024)[:900])] = 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    rigid, affine = serving_batches()
    cases = {"bunny": (*(t(a)[None] for a in bunny_clouds(
        z_rotation(10.0))), None, None),
        "1024x1024": (t(big)[None], t(big_t)[None], None, None),
        "masked 700/900": (t(big)[None], t(big_t)[None], smask, tmask)}
    for name, batch in (("rigid 256 ragged", rigid),
                        ("affine 64", affine)):
        cases[name] = em_batch_tensors(batch, dev)
        if name.startswith("affine"):
            cases[name] = cases[name][:2] + (None, None)
    for name, (srcs, tgts, sm, tm) in cases.items():
        s_c, t_c, counts = em.compact_batch(srcs, tgts, sm, tm)
        for kind in ("rigid", "affine"):
            if name.startswith(("rigid", "masked")) and kind == "affine":
                continue
            if name.startswith("affine") and kind == "rigid":
                continue
            kw = dict(affine=kind == "affine", w=0.0, update_scale=True)
            bad += against_parent(
                f"K1 against the parent] [{name} {kind}",
                lambda it, tol: parent_em(libs["em"], s_c, t_c, counts,
                                          maxiter=it, tol=tol, **kw),
                lambda it, tol, **k: em._em_cuda(s_c, t_c, counts,
                                                 maxiter=it, tol=tol, **kw,
                                                 **k),
                ((EM_BATCH_ITERS, 0.0), (100, 1e-3)), s_c.shape[0])
    # K10: the 150k pair and the 256 ragged horse pairs.
    src, tgt, _ = gmm_surface_pair()
    tree = [a[None] for a in pgt.GMMTree(src, device=dev)._nodes]
    big_in = gmm_reg_inputs(t(tgt)[None], None, tree)
    srcs, tgts, smask, tmask = em_batch_tensors(rigid, dev)
    s_c, s_cnt = _compact(srcs, smask)
    trees = pgt._build_fused(s_c, pgt._leaf_indices(0, s_cnt.tolist(), 64,
                                                    dev), s_cnt,
                             max_level=2, lambda_s=1e-3, lambda_d=1e-4)
    serve_in = gmm_reg_inputs(tgts, tmask, trees)
    kw = dict(max_level=2, maxiter=GMM_REG_ITERS, tol=0.0, lambda_c=0.01)
    for name, inputs in ((f"{N_GMM:,} pair", big_in),
                         ("256 horse pairs", serve_in)):
        want = parent_reg(libs["gmmtree"], *inputs, **kw)
        got = gc._reg_cuda(*inputs, **kw)
        diff = float((got[:, :12] - want[:, :12]).abs().max())
        p0 = timed(lambda: parent_reg(libs["gmmtree"], *inputs, **kw), 3)
        n0 = timed(lambda: gc._reg_cuda(*inputs, **kw), 5)
        n1 = timed(lambda: gc._reg_cuda(*inputs, **kw), 5)
        p1 = timed(lambda: parent_reg(libs["gmmtree"], *inputs, **kw), 3)
        one = timed(lambda: gc._reg_cuda(*inputs, **kw, _blocks=1), 3)
        log(f"[K10 against the parent] {name}, {GMM_REG_ITERS} iterations: "
            f"max |rot|, |t| difference {diff:.2e}; parent {p0:.4f} / "
            f"{p1:.4f} ms, this {n0:.4f} / {n1:.4f} ms, this on one block "
            f"a pair {one:.4f} ms")
    # A pair of 32 points: a K1 iteration's fixed cost (the M-step in one
    # thread, the barriers, the sums), per iteration.
    s32, t32 = (c[:, :32].contiguous() for c in cases["1024x1024"][:2])
    for kind in ("rigid", "affine"):
        kw = dict(affine=kind == "affine", w=0.0, maxiter=EM_BATCH_ITERS,
                  tol=0.0, update_scale=True)
        log_fixed_cost(f"K1 {kind}", lambda: parent_em(libs["em"], s32, t32,
                                                       None, **kw),
                       lambda g: em._em_cuda(s32, t32, None, **kw,
                                             _cluster=g))
    bad += compare_frg_icp_with_parent(libs, dev)
    log(f"cases that differ from the parent: {bad}")
    return 1 if bad else 0


def compare_frg_icp_with_parent(libs, dev) -> int:
    """K5 (pt2pt and pt2pl, update_sigma2 both ways) and K7 of this
    checkout against the parent's builds (through_parent), bit for bit,
    on the bunny, a 1024 x 1024 pair, the masked 700/900 pair and the
    serving batches, for G = 1, 2, 4, 8 and the default, at a fixed depth
    and with the loop test; times in the order parent, this, this, parent;
    and a 32 x 32 pair's fixed cost per iteration. Returns the number of
    cases that differ."""
    from probreg_tpu_torch.ops import frg_cuda as fc
    from probreg_tpu_torch.ops import icp_cuda as ic

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    rng = np.random.default_rng(7)
    smask = torch.zeros(1, 1024, device=dev)
    tmask = torch.zeros(1, 1024, device=dev)
    smask[0, torch.as_tensor(rng.permutation(1024)[:700])] = 1.0
    tmask[0, torch.as_tensor(rng.permutation(1024)[:900])] = 1.0
    b_src, b_tgt = bunny_clouds(z_rotation(10.0), seed=4)
    s_big, t_big, n_big = surface_pair(1024, 6)
    frg_rigid, frg_pt2pl = filterreg_batches()
    cases = {"bunny": (t(b_src)[None], t(b_tgt)[None],
                       t(estimate_normals(b_tgt))[None], None, None),
             "1024x1024": (t(s_big)[None], t(t_big)[None], t(n_big)[None],
                           None, None),
             "masked 700/900": (t(s_big)[None], t(t_big)[None],
                                t(n_big)[None], smask, tmask)}
    srcs, tgts, sm, tm = em_batch_tensors(frg_rigid, dev)
    cases["pt2pt 256 ragged"] = (srcs, tgts, None, sm, tm)
    srcs, tgts, _, _ = em_batch_tensors(frg_pt2pl, dev)
    cases["pt2pl 64"] = (srcs, tgts, t(np.stack([p[2] for p in frg_pt2pl])),
                         None, None)
    bad = 0
    for name, (srcs, tgts, nrms, sm, tm) in cases.items():
        for obj in ("pt2pt", "pt2pl"):
            if name.startswith(("pt2pt", "pt2pl")) and \
                    not name.startswith(obj):
                continue
            pt2pl = obj == "pt2pl"
            s_c, t_c, n_c, counts = fc.compact_batch(
                srcs, tgts, nrms if pt2pl else None, sm, tm)
            for update_sigma2 in (False, True):
                kw = dict(pt2pl=pt2pl, w=0.0, update_sigma2=update_sigma2,
                          min_sigma2=1e-4, auto_sigma2=True, sigma2_0=0.0,
                          sigma2_decay=FRG_SERVE[obj].get("sigma2_decay",
                                                          1.0))
                bad += against_parent(
                    f"K5 against the parent] [{name} {obj} update_sigma2 "
                    f"{update_sigma2}",
                    lambda it, tol: parent_frg(
                        libs["frg"], s_c, t_c, n_c, counts, maxiter=it,
                        tol=tol, **kw),
                    lambda it, tol, **k: fc._frg_cuda(
                        s_c, t_c, n_c, counts, maxiter=it, tol=tol, **kw,
                        **k),
                    ((EM_BATCH_ITERS, 0.0), (50, 1e-3)), s_c.shape[0])
    icp_cases = {name: (srcs, tgts, sm, tm)
                 for name, (srcs, tgts, _, sm, tm) in cases.items()
                 if not name.startswith("pt2pl")}
    for name, (srcs, tgts, sm, tm) in icp_cases.items():
        s_c, t_c, counts = ic.compact_batch(srcs, tgts, sm, tm)
        warm = ic._init_rows(s_c.shape[0], z_rotation(3.0),
                             [0.01, 0.0, -0.01], s_c)
        for init in (None, warm):
            bad += against_parent(
                f"K7 against the parent] [{name} "
                f"{'identity' if init is None else 'warm start'}",
                lambda it, tol: parent_icp(libs["icp"], s_c, t_c, counts,
                                           init, maxiter=it, tol=tol),
                lambda it, tol, **k: ic._icp_cuda(s_c, t_c, counts, init,
                                                  maxiter=it, tol=tol, **k),
                ((ICP_ITERS, 0.0), (30, 1e-6)), s_c.shape[0])
    # A pair of 32 points: an iteration's fixed cost (the M-step in one
    # thread, the barriers, the sums), per iteration.
    s32, t32, n32 = (c[:, :32].contiguous() for c in cases["1024x1024"][:3])
    runs = {"K5 pt2pt": (
        lambda **k: parent_frg(libs["frg"], s32, t32, None, None, pt2pl=False,
                               **k),
        lambda **k: fc._frg_cuda(s32, t32, None, None, pt2pl=False, **k)),
        "K5 pt2pl": (
        lambda **k: parent_frg(libs["frg"], s32, t32, n32, None, pt2pl=True,
                               **k),
        lambda **k: fc._frg_cuda(s32, t32, n32, None, pt2pl=True, **k))}
    frg_kw = dict(w=0.0, maxiter=EM_BATCH_ITERS, tol=0.0, update_sigma2=False,
                  sigma2_decay=1.0, min_sigma2=1e-4, auto_sigma2=True,
                  sigma2_0=0.0)
    for name, (par, this) in runs.items():
        log_fixed_cost(name, lambda: par(**frg_kw),
                       lambda g: this(**frg_kw, _cluster=g))
    icp_kw = dict(maxiter=ICP_ITERS, tol=0.0)
    log_fixed_cost("K7", lambda: parent_icp(libs["icp"], s32, t32, None,
                                            None, **icp_kw),
                   lambda g: ic._icp_cuda(s32, t32, None, None, **icp_kw,
                                          _cluster=g))
    return bad


def log_fixed_cost(name, parent_run, this_run, iters=EM_BATCH_ITERS):
    """us per iteration of a 32 x 32 pair: the parent's, and this one's on
    one block and on a cluster of 8."""
    p_us = timed(parent_run, 5) / iters * 1e3
    g_us = {g: timed(lambda: this_run(g), 5) / iters * 1e3 for g in (1, 8)}
    log(f"[{name} fixed cost] 32 x 32: parent {p_us:.2f} us per iteration, "
        f"this {g_us[1]:.2f} (G = 1) / {g_us[8]:.2f} (G = 8)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        log(card_line())
        return compare_with_parent(sys.argv[2])
    import probreg_tpu_torch  # noqa: F401
    from probreg_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernels, launches, shared, failed = {}, {}, {}, []
    for phase, args in ((check_small, (dev, kernels)),
                        (check_stash, (dev, kernels, shared)),
                        (check_fused_estep, (dev, kernels, shared)),
                        (check_stash_merged, (dev, kernels, shared)),
                        (check_stash_raw, (dev, kernels, shared)),
                        (check_em, (dev, kernels)),
                        (run_large_registration, (dev, launches)),
                        (run_two_pass_path, (dev, launches)),
                        (run_small_estep_path, (dev, launches)),
                        (run_bunny, (dev, launches)),
                        (run_batch, (dev, launches)),
                        (check_frg, (dev, kernels)),
                        (check_gt, (dev, kernels)),
                        (run_filterreg_large, (dev, launches)),
                        (run_filterreg_bunny, (dev, launches)),
                        (run_filterreg_batch, (dev, launches)),
                        (check_icp, (dev, kernels)),
                        (run_icp_bunny, (dev, launches)),
                        (run_icp_batch, (dev, launches)),
                        (run_icp_large, (dev, launches)),
                        (check_wstash, (dev, kernels)),
                        (run_bcpd_large, (dev, launches)),
                        (check_gmmtree_build, (dev, kernels)),
                        (check_gmmtree_reg, (dev, kernels)),
                        (run_gmmtree_bunny, (dev, launches)),
                        (run_gmmtree_batch, (dev, launches)),
                        (run_gmmtree_large, (dev, launches, kernels)),
                        (run_pyramid_cpd, (dev, launches, kernels)),
                        (run_pyramid_affine, (dev, launches)),
                        (run_family_pyramids, (dev, launches)),
                        (run_nonrigid, (dev, launches)),
                        (run_sharded_one_rank, (dev, launches, shared)),
                        (run_mesh_on_one_card, (dev, launches, shared))):
        t0 = time.perf_counter()
        try:
            phase(*args)
        except Exception:  # report every phase; the run fails below
            traceback.print_exc()
            failed.append(phase.__name__)
        log(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **kernels[name], "library_ms": None}
        for name, (source, replaces) in KERNELS.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

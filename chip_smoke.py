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
  the streaming EM with the tile-culled stash kernels (stash_den,
  stash_moment);
* the public E-step on a 1,000-point pair (RigidCPD.expectation_step):
  the one-launch small E-step kernel (estep_small);
* rigid CPD on the bunny (bench.py's configuration): the dense whole-EM
  loop, which has no kernel in this slice.

Prints the card, a {"kernels": [...]} line and, last, {"ok": true, ...}.
Exits non-zero without a CUDA device or when any phase fails.
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
REPLACES = {
    "estep_small": "probreg_tpu/ops/estep_pallas.py:1571",
    "stash_den": "probreg_tpu/ops/estep_pallas.py:393",
    "stash_moment": "probreg_tpu/ops/estep_pallas.py:429",
}
SOURCE = "probreg_tpu_torch/csrc/estep.cu"


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


def check_small(dev, kernels):
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.utils import math_utils

    log("[K2 estep_small] M = N = 1000")
    rng = np.random.default_rng(1)
    m = n = 1000
    ys = torch.as_tensor(rng.uniform(-1, 1, (m, 3)), dtype=torch.float32,
                         device=dev)
    xs = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32,
                         device=dev)
    sigma2 = math_utils.squared_kernel_sum(ys, xs) * 0.05
    scal = ec._scalars(sigma2, 0.05, m, n, 3, dev)
    mom = ec.estep_small(ys, xs, sigma2, 0.05)
    plain = ec.estep_small_plain(ys, xs, scal)
    torch.cuda.synchronize()
    err = max(compare(k, a, b) for k, a, b in
              zip(("pt1", "p1", "px", "xx"), mom[:2] + (mom.px, mom.xx),
                  plain))
    # Time raw launches on prepared buffers (the wrapper's packing is not
    # the kernel's time).
    y4, x4 = ec._pack(ys), ec._pack(xs)
    blocks = -(-n // ec._SMALL_COLS)
    bufs = [y4.new_empty(n), y4.new_empty((blocks, m, 4)),
            y4.new_empty(blocks),
            torch.zeros(1, dtype=torch.int32, device=dev),
            y4.new_empty((m, 4)), y4.new_empty(())]
    lib, stream = ec._lib(), ec._stream(y4)

    def launch():
        ec._check(lib.probreg_estep_small(
            y4.data_ptr(), m, x4.data_ptr(), n, scal.data_ptr(),
            *[b.data_ptr() for b in bufs], stream), "estep_small")

    reps = 200
    ms = timed(lambda: [launch() for _ in range(reps)], 5) / reps
    plain_ms = timed(lambda: ec.estep_small_plain(ys, xs, scal), 20)
    nbytes = 12 * (m + n) + 4 * n + 16 * m + 12
    b_ms, b_by = bound(nbytes, m * n * (FLOPS_GAUSS + FLOPS_MOMENTS))
    log(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.5f} "
        f"ms ({b_by})")
    kernels["estep_small"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by)


def check_stash(dev, kernels):
    """K3 on the 150k clouds for one E-step, dense (sigma2_0) and culled
    (an annealed sigma2), against the plain version."""
    from probreg_tpu_torch.config import config
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.ops.spatial import morton_order
    from probreg_tpu_torch.utils import math_utils

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
    rows = torch.full((-(-m // tile_m),), float(tile_m), device=dev)
    rows[-1] = m - (rows.numel() - 1) * tile_m
    cols = torch.full((-(-n // tile_n),), float(tile_n), device=dev)
    cols[-1] = n - (cols.numel() - 1) * tile_n
    out = {}
    for regime, sigma2 in (("dense", sigma2_0), ("culled", 1e-3)):
        scal = ec._scalars(sigma2, 0.0, m, n, 3, dev)
        mask = ec._active_mask(*ec._tile_bounds(ys, tile_m),
                               *ec._tile_bounds(xs, tile_n), scal[0])
        frac = float(mask.float().mean())
        pairs = float(rows @ mask.float() @ cols)
        log(f"[K3 stash] {regime}: sigma2 {sigma2:.6g}, tiles {tile_m} x "
            f"{tile_n}, active tile fraction {frac:.4f}, active pairs "
            f"{pairs:.4g}")
        got = ec.stash_estep(ys, xs, scal, mask, tile_m, tile_n)
        want = ec.stash_estep_plain(ys, xs, scal, mask, tile_m, tile_n)
        torch.cuda.synchronize()
        err_a = max(compare("pt1", got[0], want[0]),
                    compare("xx", got[3], want[3]))
        err_b = max(compare("p1", got[1], want[1]),
                    compare("px", got[2], want[2]))
        del got, want

        plan = ec.StashPlan(ys, xs, scal, mask, tile_m, tile_n)
        n_j = plan.n_j
        ms_a = timed(lambda: [plan.den(j) for j in range(n_j)], 5)
        ms_b = timed(lambda: [plan.moment(j) for j in range(n_j)], 5)
        del plan
        # Plain passes, each stripe between its own events.
        y2, x2 = (ys * ys).sum(1), (xs * xs).sum(1)
        pa = pb = 0.0
        for j in range(n_j):
            c0 = j * tile_n
            x, xj2 = xs[c0:c0 + tile_n], x2[c0:c0 + tile_n]
            act = mask[:, j].repeat_interleave(tile_m)[:m]
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            g, inv_den, _, _ = ec._plain_pass_a(ys, y2, x, xj2, scal, act,
                                                mask.shape[0], tile_m)
            e[1].record()
            ec._plain_pass_b(g, inv_den, x)
            e[2].record()
            torch.cuda.synchronize()
            pa += e[0].elapsed_time(e[1])
            pb += e[1].elapsed_time(e[2])
            del g
        ba = bound(12 * (m + n) + 4 * pairs + 8 * n, pairs * FLOPS_GAUSS)
        bb = bound(4 * pairs + 16 * n + 16 * m, pairs * FLOPS_MOMENTS)
        log(f"  pass A kernel {ms_a:.3f} ms  plain {pa:.3f} ms  bound "
            f"{ba[0]:.3f} ms ({ba[1]})")
        log(f"  pass B kernel {ms_b:.3f} ms  plain {pb:.3f} ms  bound "
            f"{bb[0]:.3f} ms ({bb[1]})")
        out[regime] = (err_a, err_b, ms_a, ms_b, pa, pb, ba, bb)
    # The kernels line carries the dense E-step (the first iterations of
    # the 150k run); the culled numbers are printed above.
    err_a, err_b, ms_a, ms_b, pa, pb, ba, bb = out["dense"]
    kernels["stash_den"] = dict(max_abs_err=max(err_a, out["culled"][0]),
                                ms=ms_a, plain_ms=pa, bound_ms=ba[0],
                                bound_by=ba[1])
    kernels["stash_moment"] = dict(max_abs_err=max(err_b, out["culled"][1]),
                                   ms=ms_b, plain_ms=pb, bound_ms=bb[0],
                                   bound_by=bb[1])


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
        ec.reset_launches()
        t0 = time.perf_counter()
        res = cpd.registration_cpd(src, tgt, "rigid", maxiter=40, tol=1e-8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.update(stash_den=ec.LAUNCHES["stash_den"],
                        stash_moment=ec.LAUNCHES["stash_moment"])
        unexpected = ec.LAUNCHES["estep_small"]
    finally:
        ec._active_mask = active_mask
    peak = torch.cuda.max_memory_allocated()
    err = float(se3_op.rotation_angle(res.transformation.rot.cpu().double(),
                                      torch.as_tensor(rot).double()))
    sigma2 = float(res.sigma2)
    log(f"  timed call {wall:.3f} s, E-steps {len(masks)}, final sigma2 "
        f"{sigma2:.6g}, rotation error {err:.3e} rad")
    log(f"  active tile fraction: first E-step {float(masks[0]):.4f}, "
        f"last {float(masks[-1]):.4f}; peak memory {peak / 2**30:.3f} GiB")
    log(f"  launches: {launches}")
    if not (launches["stash_den"] > 0 and launches["stash_moment"] > 0):
        raise AssertionError("the main path did not launch the stash kernels")
    if unexpected:
        raise AssertionError("estep_small launched on the 150k path")
    # The same registration with every stash E-step run by the plain
    # version: the kernels may change only the summation order.
    stash_estep = ec.stash_estep
    ec.stash_estep = ec.stash_estep_plain
    try:
        t0 = time.perf_counter()
        ref = cpd.registration_cpd(src, tgt, "rigid", maxiter=40, tol=1e-8)
        torch.cuda.synchronize()
    finally:
        ec.stash_estep = stash_estep
    d_rot = float((res.transformation.rot - ref.transformation.rot)
                  .abs().max())
    d_t = float((res.transformation.t - ref.transformation.t).abs().max())
    log(f"  plain-version registration {time.perf_counter() - t0:.3f} s: "
        f"max |rot diff| {d_rot:.3e}, max |t diff| {d_t:.3e}, sigma2 "
        f"{float(ref.sigma2):.6g}")
    if not (math.isfinite(sigma2) and err <= ROT_ERR_MAX):
        raise AssertionError(f"150k registration wrong: rotation error {err}")
    if not (d_rot <= 1e-4 and d_t <= 1e-4):
        raise AssertionError("kernel and plain registrations disagree")


def run_small_estep_path(dev, launches):
    """The public E-step of a small problem goes through estep_small."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.ops import estep_cuda as ec
    from probreg_tpu_torch.ops import estep as eo

    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    reg = cpd.RigidCPD(src)
    ec.reset_launches()
    res = reg.expectation_step(src, tgt, 0.1, 0.05)
    torch.cuda.synchronize()
    launches["estep_small"] = ec.LAUNCHES["estep_small"]
    log(f"[E-step path] RigidCPD.expectation_step, 1000 x 1000: launches "
        f"{ec.LAUNCHES}")
    if launches["estep_small"] != 1:
        raise AssertionError("the small E-step did not launch estep_small")
    ref = eo.estep_xla(torch.as_tensor(src, device=dev),
                       torch.as_tensor(tgt, device=dev), 0.1, 0.05)
    for name, a, b in zip(("pt1", "p1", "px", "n_p"), res, ref):
        compare(name, a, b)


def run_bunny(dev):
    """bench.py's bunny configuration through the dense whole-EM loop."""
    from probreg_tpu_torch import cpd
    from probreg_tpu_torch.utils import io, se3_op

    rng = np.random.default_rng(3)
    src = io.voxel_down_sample(io.read_point_cloud(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "bunny.pcd")), 0.005)
    tgt = src.copy()
    rng.shuffle(tgt)
    tgt = tgt + 1e-3 * rng.standard_normal(tgt.shape)
    rot = se3_op.euler2mat(0.0, 0.0, np.deg2rad(10.0)).double().numpy()
    tgt = (tgt @ rot.T).astype(np.float32)
    t0 = time.perf_counter()
    res = cpd.registration_cpd(src.astype(np.float32), tgt, maxiter=100,
                               tol=1e-3)
    torch.cuda.synchronize()
    ang = np.rad2deg(se3_op.mat2euler(res.transformation.rot.cpu()).numpy())
    log(f"[bunny] {src.shape[0]} points, dense loop, "
        f"{time.perf_counter() - t0:.3f} s (first call), recovered Euler "
        f"{np.round(ang, 3).tolist()} deg")
    if not np.allclose(ang, [0.0, 0.0, 10.0], atol=0.5):
        raise AssertionError("bunny registration did not recover 10 deg")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    kernels, launches, failed = {}, {}, []
    for phase, args in ((check_small, (dev, kernels)),
                        (check_stash, (dev, kernels)),
                        (run_large_registration, (dev, launches)),
                        (run_small_estep_path, (dev, launches)),
                        (run_bunny, (dev,))):
        try:
            phase(*args)
        except Exception:  # report every phase; the run fails below
            traceback.print_exc()
            failed.append(phase.__name__)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         **kernels[name], "library_ms": None}
        for name in ("estep_small", "stash_den", "stash_moment")]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

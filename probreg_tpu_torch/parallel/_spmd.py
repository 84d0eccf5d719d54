"""Run a function on every rank of a fresh process group, and the rank
functions that the tests and chip_smoke.py share.

``run_spmd(fn, world, backend, device, *args)`` spawns ``world`` processes;
rank r joins a process group of ``backend`` through a ``file://``
rendezvous in a fresh directory (no port to collide on), calls ``fn(device,
*args)`` and saves what it returns; the parent returns every rank's result
in rank order. A rank that raises makes the call raise, and the other ranks
are stopped. ``fn`` is pickled by its module name, so it must be a
module-level function such as :func:`rank_calls`.

Several ranks may share one CUDA card under gloo (a check of the
collectives, not a multi-card figure); NCCL needs a card per rank.
"""

from __future__ import annotations

import datetime
import os
import shutil
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import COUNTS, make_mesh, make_mesh_2d, reset_counts


def run_spmd(fn, world: int, backend: str, device, *args, workdir=None,
             timeout: float = 900.0):
    """Every rank's ``fn(device, *args)``, in rank order (see the module
    docstring). ``device``: every rank's device; ``"cuda"`` without an
    index gives rank r card r % the card count. ``workdir``: the directory
    for the rendezvous file and the results (default: a new temporary one,
    removed afterwards).
    ``timeout``: seconds a collective may wait before it fails."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="probreg_spmd_") if own \
        else str(workdir)
    try:
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, backend, str(device), workdir,
                                 timeout, args))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def _rank_main(rank, fn, world, backend, device, workdir, timeout, args):
    if backend == "gloo" and "GLOO_SOCKET_IFNAME" not in os.environ and any(
            name == "lo" for _, name in socket.if_nameindex()):
        # The ranks share one host: gloo's pairs over the loopback device
        # (by default gloo binds the hostname's interface, which can be a
        # much slower path: 4.4 ms against 0.57 ms per small all_reduce
        # measured on a CPU host).
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:  # a card per rank, as far as there are cards
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        # One thread a rank: the ranks share the host's cores, and a rank
        # whose threads are descheduled holds up every collective (4 CPU
        # ranks under a loaded host took 30 s with one thread each against
        # 46 s with two).
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'pg')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(str(dev), *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh(shape, device):
    device_type = torch.device(device).type
    if len(shape) == 1:
        return make_mesh(device_type=device_type)
    return make_mesh_2d(*shape, device_type=device_type)


def _entry(name: str):
    from .. import pyramid
    from . import sharded, sharded2d

    return {"cpd_sharded": sharded.registration_cpd_sharded,
            "cpd_2d": sharded2d.registration_cpd_2d,
            "cpd_batch_sharded": sharded.registration_cpd_batch_sharded,
            "cpd_pyramid": pyramid.registration_cpd_pyramid,
            "filterreg_sharded": sharded.registration_filterreg_sharded,
            "filterreg_2d": sharded2d.registration_filterreg_2d,
            "filterreg_pyramid": pyramid.registration_filterreg_pyramid,
            "bcpd_sharded": sharded.registration_bcpd_sharded,
            "bcpd_2d": sharded2d.registration_bcpd_2d,
            "bcpd_pyramid": pyramid.registration_bcpd_pyramid,
            "gmmtree_sharded": sharded.registration_gmmtree_sharded,
            "gmmreg_sharded": sharded.registration_gmmreg_sharded,
            "svr_sharded": sharded.registration_svr_sharded,
            "all_reduce_cost": all_reduce_cost}[name]


def all_reduce_cost(axis: str, numel: int, reps: int, *, mesh,
                    device) -> float:
    """ms per all_reduce of a ``numel``-float tensor over one axis of
    ``mesh``, over ``reps`` calls after a warm-up (the 2-D culled E-step's
    normalizer reduction, one per E-step)."""
    grp = mesh.get_group(axis)
    buf = torch.ones(numel, device=device)
    dist.all_reduce(buf, group=grp)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf, group=grp)
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def _kernel_launches():
    from ..ops import (bcpd_cuda, em_cuda, estep_cuda, frg_cuda,
                       gmmtree_cuda, gt_cuda, icp_cuda)

    return tuple(mod.LAUNCHES for mod in (estep_cuda, em_cuda, frg_cuda,
                                          gt_cuda, icp_cuda, bcpd_cuda,
                                          gmmtree_cuda))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_result(res) -> dict:
    """A result as numpy and floats: an MstepResult's sigma2 and q (those
    it has) beside its transformation's numbers, or a bare
    transformation's. Rigid and affine: lin (rot or b), t, scale; combined
    (BCPD): those of its rigid part and v; nonrigid: the displacement at
    the source points, disp (G W or U zc); TPS: the moved control points,
    moved."""
    out, tr = {}, res
    if hasattr(res, "transformation"):
        tr = res.transformation
        out = {k: float(getattr(res, k)) for k in ("sigma2", "q")
               if getattr(res, k, None) is not None}

    def host(x):
        return x.detach().cpu().numpy()

    if hasattr(tr, "u") or hasattr(tr, "g"):
        disp = tr.u @ tr.zc if hasattr(tr, "u") else tr.g @ tr.w
        return {"disp": host(disp), **out}
    if hasattr(tr, "control_pts"):
        return {"moved": host(tr.transform(tr.control_pts)), **out}
    if hasattr(tr, "rigid_trans"):
        out["v"] = host(tr.v)
        tr = tr.rigid_trans
    lin = tr.rot if hasattr(tr, "rot") else tr.b
    return {"lin": host(lin), "t": host(tr.t),
            "scale": float(getattr(tr, "scale", 1.0)), **out}


def rank_calls(device, calls, repeats: int = 1):
    """One rank's part of a list of sharded calls. Each call is (entry,
    mesh_shape, args, kwargs): the entry point named ``entry`` (a key of
    ``_entry``: ``cpd_sharded``, ``filterreg_2d``, ``bcpd_pyramid``, ...,
    or ``all_reduce_cost``) called ``repeats`` times with ``mesh=`` a mesh
    of ``mesh_shape`` ((P,) or (Pm, Pn)) over the world and ``device=``.
    Returns, per call, the last run's result (``host_result``; a list for a
    batch; a float for the cost), its kernel launches, ``mesh.COUNTS`` (its
    E-steps are its iterations), wall seconds (ending in a synchronize)
    and, on a CUDA device, the rank's peak allocated MiB."""
    meshes, outs = {}, []
    for entry, mesh_shape, args, kwargs in calls:
        shape = tuple(mesh_shape)
        if shape not in meshes:
            meshes[shape] = _mesh(shape, device)
        fn = _entry(entry)
        for _ in range(repeats):
            for launches in _kernel_launches():
                for k in launches:
                    launches[k] = 0
            reset_counts()
            _sync(device)
            if torch.device(device).type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = fn(*args, mesh=meshes[shape], device=device, **kwargs)
            _sync(device)
            seconds = time.perf_counter() - t0
        got = {}
        for launches in _kernel_launches():
            got.update({k: v for k, v in launches.items() if v})
        if isinstance(res, list):
            res = [host_result(r) for r in res]
        elif not isinstance(res, float):
            res = host_result(res)
        peak = (torch.cuda.max_memory_allocated(device) / 2**20
                if torch.device(device).type == "cuda" else None)
        outs.append({"result": res, "launches": got,
                     "counts": dict(COUNTS), "seconds": seconds,
                     "peak_mib": peak})
    return outs

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
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:  # a card per rank, as far as there are cards
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:  # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
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
    from ..ops import em_cuda, estep_cuda

    return estep_cuda.LAUNCHES, em_cuda.LAUNCHES


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_result(res) -> dict:
    """An MstepResult as numpy and floats: lin (rot or b), t, scale,
    sigma2, q; for a nonrigid transformation its displacement at the
    source points, disp (G W or U zc), in place of lin, t and scale."""
    tr = res.transformation
    if hasattr(tr, "u") or hasattr(tr, "g"):
        disp = tr.u @ tr.zc if hasattr(tr, "u") else tr.g @ tr.w
        return {"disp": disp.detach().cpu().numpy(),
                "sigma2": float(res.sigma2), "q": float(res.q)}
    lin = tr.rot if hasattr(tr, "rot") else tr.b
    return {"lin": lin.detach().cpu().numpy(),
            "t": tr.t.detach().cpu().numpy(),
            "scale": float(getattr(tr, "scale", 1.0)),
            "sigma2": float(res.sigma2), "q": float(res.q)}


def rank_calls(device, calls, repeats: int = 1):
    """One rank's part of a list of sharded calls. Each call is (entry,
    mesh_shape, args, kwargs): the entry point named ``entry``
    (``cpd_sharded``, ``cpd_2d``, ``cpd_batch_sharded``, ``cpd_pyramid``,
    or ``all_reduce_cost``) called ``repeats`` times with ``mesh=`` a mesh
    of ``mesh_shape`` ((P,) or (Pm, Pn)) over the world and ``device=``.
    Returns, per call, the last run's result (``host_result``; a list for a
    batch; a float for the cost), its kernel launches, ``mesh.COUNTS`` (its
    E-steps are its iterations) and wall seconds (ending in a
    synchronize)."""
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
        outs.append({"result": res, "launches": got,
                     "counts": dict(COUNTS), "seconds": seconds})
    return outs

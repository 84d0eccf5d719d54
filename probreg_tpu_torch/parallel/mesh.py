"""Process groups, device meshes and shards of the sharded runners.

Counterpart of the mesh helpers of probreg_tpu/parallel/ (``sharded.py``
:45-68 and :139-156, ``sharded2d.py``:56-97). The reference is
single-controller: one process sees every device and ``shard_map`` runs the
SPMD body. Here every rank is a process of ``torch.distributed``: each rank
calls the same entry point with the same full clouds, takes its own shard
by its coordinate on the mesh, and gets back the same replicated result.

A shard is a plain slice, ceil(N / P) rows per shard with the last shards
short or empty, the reference's boundaries (it pads the last shards and
masks the padding; the port's kernels take any size, so there is no
padding and no mask). An empty shard computes nothing and adds exact zeros
to every sum.

Collectives are ``all_reduce`` only (``all_reduce_`` for sums,
``all_reduce_min_`` for minima; a gather is an ``all_reduce`` of a
zero-filled buffer, ``gather_shards``): gloo runs it on CUDA tensors too,
so several ranks can share one card, which NCCL refuses. The
backend is the one of the caller's process group; nothing here changes it
or moves a tensor to the host to get round it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import config as _config
from ..log import log
from ..utils import interop

AXIS = "points"
M_AXIS, N_AXIS = "m", "n"

# Counts of the sharded runners' work, read by tests and chip_smoke.py:
# E-steps run (one per EM iteration, so a call's count is its iterations),
# all_reduce calls, and among them the normalizer reductions of the 2-D
# E-step (one per E-step).
COUNTS = {"esteps": 0, "all_reduce": 0, "den_all_reduce": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, **kwargs):
    """Bring up the default process group and log it (reference
    ``parallel/__init__.py:31``, ``jax.distributed.initialize``).

    ``coordinator_address``: ``"host:port"`` (rank 0's TCP rendezvous) or a
    URL with its own scheme (``"file:///path"``); None reads the ``env://``
    variables a launcher such as torchrun sets. ``backend``: default
    ``"nccl"`` where CUDA is available, else ``"gloo"``. Call once per
    process before building meshes.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = None
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id), **kwargs)
    log.info("distributed initialized: process %d/%d, backend %s, %d local "
             "CUDA devices", dist.get_rank(), dist.get_world_size(), backend,
             torch.cuda.device_count() if torch.cuda.is_available() else 0)


def make_mesh(axis: str = AXIS, device_type: str = "cuda"):
    """1-D mesh over every rank of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def mesh_2d_shape(world: int, pm: Optional[int] = None,
                  pn: Optional[int] = None) -> Tuple[int, int]:
    """(pm, pn) of a 2-D mesh over ``world`` ranks (reference
    ``make_mesh_2d``): squarish with pn >= pm by default, the missing factor
    from the given one; ValueError when pm * pn != world."""
    if pm is None and pn is None:
        pm = int(np.floor(np.sqrt(world)))
        while world % pm:
            pm -= 1
        pn = world // pm
    elif pm is None:
        pm = world // pn
    elif pn is None:
        pn = world // pm
    if pm * pn != world:
        raise ValueError(f"mesh shape {pm}x{pn} != {world} devices")
    return pm, pn


def make_mesh_2d(pm: Optional[int] = None, pn: Optional[int] = None,
                 device_type: str = "cuda"):
    """2-D ``(m, n)`` mesh over every rank: the source is sharded over m,
    the target over n (shape: :func:`mesh_2d_shape`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_2d_shape(dist.get_world_size(), pm, pn)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=(M_AXIS, N_AXIS))


def axis_group(mesh, axis: str):
    """(process group, this rank's coordinate, size) of one mesh axis."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device``, by default ``cuda:{LOCAL_RANK}``;
    raises without CUDA unless the caller asked for the CPU."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return _config.resolve_device(device)


def shard_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of shard ``index`` of ``parts`` over n rows: ceil(n /
    parts) rows each, the last shards short or empty."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


def shard_points(points, mesh, axis: str = AXIS, device=None):
    """This rank's shard of (N, D) points along ``axis`` of ``mesh``:
    returns ((Nl, D) tensor on ``device``, N)."""
    pts = interop.as_points(points, device="cpu")
    _, index, parts = axis_group(mesh, axis)
    start, stop = shard_range(pts.shape[0], parts, index)
    return pts[start:stop].to(rank_device(device)), pts.shape[0]


def shard_points_t(points, mesh, axis: str = AXIS, device=None):
    """:func:`shard_points` in the transposed layout: ((D, Nl), N)."""
    loc, n = shard_points(points, mesh, axis, device)
    return loc.T, n


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``group``; returns it."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def all_reduce_min_(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum of ``t`` in place over the ranks of ``group``;
    returns it."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def gather_shards(loc: torch.Tensor, n: int, mesh, axis: str) -> torch.Tensor:
    """The whole (N, ...) array on every rank from each rank's shard
    ``loc`` along ``axis`` (``shard_range``'s rows): one all_reduce of a
    zero-filled buffer, exact (x + 0 is x)."""
    grp, index, parts = axis_group(mesh, axis)
    start, stop = shard_range(n, parts, index)
    buf = loc.new_zeros((n,) + tuple(loc.shape[1:]))
    buf[start:stop] = loc
    return all_reduce_(buf, grp)


def from_first_rank(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the first rank of ``group`` holds it, on every rank of
    ``group``: an all_reduce to which every other rank adds zeros (x + 0 is
    x). A replicated solve can differ in its last bits from rank to rank (a
    CPU LAPACK's M x M solve is not reproducible from run to run), and the
    ranks must hold one state and take one stop decision."""
    t = t.contiguous() if dist.get_rank(group=group) == 0 \
        else torch.zeros_like(t, memory_format=torch.contiguous_format)
    return all_reduce_(t, group)

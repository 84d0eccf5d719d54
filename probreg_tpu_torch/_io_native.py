"""The port's native point-cloud loader: ctypes binding of csrc/io_native.cpp.

Counterpart of the JAX package's compiled ``probreg_tpu._io_native``, with
its functions, signatures, dtypes and errors: ``read_ply``, ``read_pcd``,
``voxel_down_sample``, ``read_batch`` and ``morton_order``, plus
``voxel_count`` (the pyramids' density probe). The library is built at
first use by ``ops._build`` with the host C++ compiler, into
``build/torch_kernels/``; without a compiler, or when the build fails, every
function raises (there is no numpy fallback here: ``utils.io`` keeps the
numpy versions as ``*_plain`` for the tests). ctypes releases the
interpreter lock for the length of each call, so ``read_batch``'s threads
and other Python threads run alongside.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

import numpy as np

from .ops import _build

__all__ = ["read_ply", "read_pcd", "voxel_down_sample", "voxel_count",
           "read_batch", "morton_order"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
_ERR = 4096  # bytes of an error message


def _lib() -> ctypes.CDLL:
    lib = _build.load("io_native")
    if not getattr(lib, "_probreg_typed", False):
        lib.probreg_read_cloud.argtypes = [ctypes.c_char_p, ctypes.c_int, _PP,
                                           ctypes.POINTER(_I), _P, _I]
        lib.probreg_voxel_down_sample.argtypes = [_P, _I, _D, _PP,
                                                  ctypes.POINTER(_I), _P, _I]
        for f in (lib.probreg_voxel_count_f64, lib.probreg_voxel_count_f32):
            f.argtypes = [_P, _I, _I, _D, ctypes.POINTER(_I), _P, _I]
        lib.probreg_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _I, _D, _I, _PP,
            ctypes.POINTER(_I), ctypes.POINTER(_I), _P, _I]
        lib.probreg_morton_order.argtypes = [_P, _I, _I, _P, _P, _I]
        for f in (lib.probreg_read_cloud, lib.probreg_voxel_down_sample,
                  lib.probreg_voxel_count_f64, lib.probreg_voxel_count_f32,
                  lib.probreg_read_batch, lib.probreg_morton_order):
            f.restype = ctypes.c_int
        lib.probreg_free.argtypes = [_P]
        lib.probreg_free.restype = None
        lib._probreg_typed = True
    return lib


def _raise(code: int, err, path: str = None):
    msg = err.value.decode(errors="replace")
    if code > 0:  # an errno: the file could not be opened or read
        raise OSError(code, os.strerror(code), path)
    raise ValueError(msg)


def _take(lib, ptr, n: int) -> np.ndarray:
    """Copy the library's (n, 3) float64 buffer into numpy and free it."""
    if n == 0:
        return np.zeros((0, 3), np.float64)
    try:
        return np.ctypeslib.as_array(ptr, shape=(n, 3)).copy()
    finally:
        lib.probreg_free(ptr)


def _read(path, kind: int) -> np.ndarray:
    lib = _lib()
    path = os.fsdecode(path)
    out, n = ctypes.POINTER(ctypes.c_double)(), _I()
    err = ctypes.create_string_buffer(_ERR)
    code = lib.probreg_read_cloud(os.fsencode(path), kind, ctypes.byref(out),
                                  ctypes.byref(n), err, _ERR)
    if code:
        _raise(code, err, path)
    return _take(lib, out, n.value)


def read_ply(path) -> np.ndarray:
    """Vertex x/y/z of a PLY file (ascii, binary either endian) as (N, 3)
    float64. OSError when it cannot be opened, ValueError when malformed."""
    return _read(path, 1)


def read_pcd(path) -> np.ndarray:
    """x/y/z of a PCD file (ascii or binary DATA) as (N, 3) float64."""
    return _read(path, 2)


def _points(points, dtype, dims) -> np.ndarray:
    pts = np.ascontiguousarray(points, dtype=dtype)
    if pts.ndim != 2 or pts.shape[1] not in dims:
        raise ValueError("expected (N, %s) array"
                         % "|".join(str(d) for d in dims))
    return pts


def voxel_down_sample(points, voxel_size: float) -> np.ndarray:
    """Mean of the points of each occupied voxel of (N, 3) float64 points,
    the voxels in lexicographic key order (utils.io.voxel_down_sample_plain
    bit for bit)."""
    pts = _points(points, np.float64, (3,))
    lib = _lib()
    out, n = ctypes.POINTER(ctypes.c_double)(), _I()
    err = ctypes.create_string_buffer(_ERR)
    code = lib.probreg_voxel_down_sample(
        pts.ctypes.data, pts.shape[0], float(voxel_size), ctypes.byref(out),
        ctypes.byref(n), err, _ERR)
    if code:
        _raise(code, err)
    return _take(lib, out, n.value)


def voxel_count(points, voxel_size: float) -> int:
    """Number of occupied voxels of (N, D) points, the voxel keys computed
    in the points' precision: float32 points as float32 (as numpy divides a
    float32 array by a Python float), anything else as float64."""
    pts = np.asarray(points)
    dtype = np.float32 if pts.dtype == np.float32 else np.float64
    pts = np.ascontiguousarray(pts, dtype=dtype)
    if pts.ndim != 2:
        raise ValueError("expected (N, D) array")
    lib = _lib()
    fn = (lib.probreg_voxel_count_f32 if dtype == np.float32
          else lib.probreg_voxel_count_f64)
    count = _I()
    err = ctypes.create_string_buffer(_ERR)
    code = fn(pts.ctypes.data, pts.shape[0], pts.shape[1], float(voxel_size),
              ctypes.byref(count), err, _ERR)
    if code:
        _raise(code, err)
    return int(count.value)


def read_batch(paths: Sequence, voxel: float = 0.0,
               threads: int = 0) -> List[np.ndarray]:
    """Read many .ply / .pcd files (voxel-downsampled when ``voxel`` > 0)
    on ``threads`` native threads (0: min(len(paths), the host's cores)).
    Returns (N_i, 3) float64 arrays in input order; the first failing file
    raises ValueError naming its path."""
    paths = [os.fsdecode(p) for p in paths]
    n = len(paths)
    if n == 0:
        return []
    lib = _lib()
    c_paths = (ctypes.c_char_p * n)(*(os.fsencode(p) for p in paths))
    outs = (ctypes.POINTER(ctypes.c_double) * n)()
    counts = (_I * n)()
    failed = _I(-1)
    err = ctypes.create_string_buffer(_ERR)
    code = lib.probreg_read_batch(c_paths, n, float(voxel), int(threads),
                                  outs, counts, ctypes.byref(failed), err,
                                  _ERR)
    if code:
        reason = err.value.decode(errors="replace")
        if code > 0:
            reason += " (%s)" % os.strerror(code)
        raise ValueError("%s: %s" % (paths[failed.value], reason))
    return [_take(lib, outs[i], counts[i]) for i in range(n)]


def morton_order(points) -> np.ndarray:
    """Stable Z-order permutation (int64) of (N, 2|3) float32 points:
    ops.spatial.morton_order's codes and order."""
    pts = _points(points, np.float32, (2, 3))
    order = np.empty(pts.shape[0], np.int64)
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR)
    code = lib.probreg_morton_order(pts.ctypes.data, pts.shape[0],
                                    pts.shape[1], order.ctypes.data, err,
                                    _ERR)
    if code:
        _raise(code, err)
    return order

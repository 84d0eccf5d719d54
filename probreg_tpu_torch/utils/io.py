"""Point-cloud IO: PLY / PCD readers and voxel downsampling.

Counterpart of probreg_tpu/utils/io.py (the reference leans on Open3D's C++
IO). ``read_ply``, ``read_pcd``, ``read_batch`` and ``voxel_down_sample`` of
(N, 3) points run the port's native loader (``probreg_tpu_torch._io_native``,
csrc/io_native.cpp, built at first use with the host C++ compiler), as the
reference's do with its own; ``read_batch`` reads on native threads. Only
``.txt`` files and points of another width than 3 stay on numpy. Without a
C++ compiler the native route raises: it never gives way to numpy. The numpy
bodies stay as the plain versions (``read_ply_plain``, ``read_pcd_plain``,
``voxel_down_sample_plain``, the sequential ``read_batch_plain``), which the
tests hold the native route to, bit for bit. Both read the ASCII/binary PLY
and PCD variants used by the probreg fixtures (data/horse.ply is
binary_little_endian, data/bunny.pcd is ASCII v0.7); ``voxel_down_sample``
averages the points of each voxel, like Open3D.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import numpy as np

from .. import _io_native

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "float64": "f8", "double": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def read_ply(path) -> np.ndarray:
    """Read vertex x/y/z from a PLY file (ascii or binary, either endian)."""
    return _io_native.read_ply(path)


def read_pcd(path) -> np.ndarray:
    """Read x/y/z from a PCD file (ascii or binary DATA)."""
    return _io_native.read_pcd(path)


def read_ply_plain(path) -> np.ndarray:
    """numpy version of :func:`read_ply`."""
    raw = Path(path).read_bytes()
    # CRLF-tolerant AND line-anchored: a bare substring search matched
    # 'end_header' inside comment lines and truncated the header (review
    # finding); the real terminator is a line that is exactly the token.
    m = re.search(rb"^end_header[ \t]*\r?$", raw, re.M)
    if m is None:
        raise ValueError("not a PLY file: %s" % path)
    header = raw[: m.start()].decode("ascii", errors="replace").splitlines()
    body = raw[m.end() + 1:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype_str) ...])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property" and elements:
            if tok[1] == "list":
                elements[-1][2].append(("__list__", (tok[2], tok[3])))
            else:
                elements[-1][2].append((tok[-1], _PLY_DTYPES[tok[1]]))

    if not elements or elements[0][0] != "vertex":
        raise ValueError("PLY without leading vertex element")
    name, count, props = elements[0]
    if any(p[0] == "__list__" for p in props):
        raise ValueError("list property in vertex element unsupported")

    if fmt == "ascii":
        ncols = len(props)
        vals = np.array(body.split()[: count * ncols], dtype=np.float64).reshape(count, ncols)
        cols = [p[0] for p in props]
        idx = [cols.index(c) for c in ("x", "y", "z")]
        return vals[:, idx].astype(np.float64)

    endian = "<" if fmt == "binary_little_endian" else ">"
    dt = np.dtype([(p, endian + t) for p, t in props])
    verts = np.frombuffer(body, dtype=dt, count=count)
    return np.stack(
        [verts["x"], verts["y"], verts["z"]], axis=1
    ).astype(np.float64)


def read_pcd_plain(path) -> np.ndarray:
    """numpy version of :func:`read_pcd`."""
    raw = Path(path).read_bytes()
    # \r? before \n: CRLF-written PCD headers (review finding).
    m = re.search(rb"DATA[ \t]+(\w+)[ \t]*\r?\n", raw)
    if m is None:
        raise ValueError("not a PCD file: %s" % path)
    header = raw[: m.end()].decode("ascii", errors="replace")
    body = raw[m.end():]

    def _req(pattern):
        hm = re.search(pattern, header)
        if hm is None:
            # A clear diagnostic instead of AttributeError on a truncated
            # header (review finding).
            raise ValueError("not a PCD file (missing %r): %s"
                             % (pattern, path))
        return hm

    fields = _req(r"FIELDS\s+(.+)").group(1).split()
    sizes = [int(s) for s in _req(r"SIZE\s+(.+)").group(1).split()]
    types = _req(r"TYPE\s+(.+)").group(1).split()
    counts_m = re.search(r"COUNT\s+(.+)", header)
    counts = [int(c) for c in counts_m.group(1).split()] if counts_m else [1] * len(fields)
    n = int(_req(r"POINTS\s+(\d+)").group(1))
    data_kind = m.group(1).decode()

    if data_kind == "ascii":
        vals = np.array(body.split(), dtype=np.float64)
        ncols = sum(counts)
        vals = vals[: n * ncols].reshape(n, ncols)
        col = 0
        out = {}
        for f, c in zip(fields, counts):
            out[f] = vals[:, col]
            col += c
        return np.stack([out["x"], out["y"], out["z"]], axis=1)
    if data_kind == "binary":
        np_t = {"F": "f", "I": "i", "U": "u"}
        dt = np.dtype(
            [
                (f, "<%s%d" % (np_t[t], s), (c,) if c > 1 else ())
                for f, s, t, c in zip(fields, sizes, types, counts)
            ]
        )
        pts = np.frombuffer(body, dtype=dt, count=n)
        return np.stack([pts["x"], pts["y"], pts["z"]], axis=1).astype(np.float64)
    raise ValueError("unsupported PCD DATA kind: %s" % data_kind)


def write_ply(path, points: np.ndarray, binary: bool = True) -> None:
    """Write an x/y/z vertex cloud as PLY (float32; binary LE or ascii).

    Counterpart of :func:`read_ply`, so the framework round-trips its own
    fixtures without Open3D (the reference delegates all IO to Open3D,
    reference probreg/transformation.py:23-26 and examples/utils.py).
    """
    pts = np.ascontiguousarray(np.asarray(points, dtype="<f4"))
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\nformat %s 1.0\ncomment probreg_tpu_torch fixture\n"
        "element vertex %d\nproperty float32 x\nproperty float32 y\n"
        "property float32 z\nend_header\n" % (fmt, pts.shape[0])
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.tobytes())
        else:
            np.savetxt(f, pts, fmt="%.7g")


def write_pcd(path, points: np.ndarray, binary: bool = False) -> None:
    """Write an x/y/z cloud as PCD v0.7 (ascii by default)."""
    pts = np.ascontiguousarray(np.asarray(points, dtype="<f4"))
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        "WIDTH %d\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %d\n"
        "DATA %s\n" % (n, n, "binary" if binary else "ascii")
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.tobytes())
        else:
            np.savetxt(f, pts, fmt="%.7g")


def write_point_cloud(path, points: np.ndarray) -> None:
    path = str(path)
    if path.endswith(".ply"):
        return write_ply(path, points)
    if path.endswith(".pcd"):
        return write_pcd(path, points)
    if path.endswith(".txt"):
        return np.savetxt(path, np.asarray(points), fmt="%.10g")
    raise ValueError("unsupported point cloud format: %s" % path)


def read_point_cloud(path) -> np.ndarray:
    return _read_point_cloud(path, read_ply, read_pcd)


def _read_point_cloud(path, ply, pcd) -> np.ndarray:
    path = str(path)
    if path.endswith(".ply"):
        return ply(path)
    if path.endswith(".pcd"):
        return pcd(path)
    if path.endswith(".txt"):
        return np.loadtxt(path)
    raise ValueError("unsupported point cloud format: %s" % path)


def read_batch(paths, voxel_size: float = 0.0, threads: int = 0):
    """Load many PLY/PCD files (optionally voxel-downsampled) concurrently.

    The .ply / .pcd files are read on ``threads`` native threads (0:
    min(len(paths), the host's cores)) with the interpreter lock released,
    the data-loader for serving pipelines that overlap host IO with device
    compute (it pairs with :func:`probreg_tpu_torch.cpd.
    registration_cpd_batch`); ``.txt`` files are read with numpy. A file
    that cannot be read raises ValueError naming it.

    Returns a list of (N_i, 3) float64 arrays, in input order.
    """
    paths = [str(p) for p in paths]
    clouds = iter(_io_native.read_batch(
        [p for p in paths if not p.endswith(".txt")], float(voxel_size),
        int(threads)))
    out = []
    for p in paths:
        if not p.endswith(".txt"):
            out.append(next(clouds))
            continue
        pts = np.loadtxt(p)
        if voxel_size > 0.0:
            pts = voxel_down_sample(pts, voxel_size)
        out.append(np.asarray(pts, dtype=np.float64))
    return out


def read_batch_plain(paths, voxel_size: float = 0.0):
    """Sequential numpy version of :func:`read_batch`."""
    out = []
    for p in paths:
        pts = _read_point_cloud(p, read_ply_plain, read_pcd_plain)
        if voxel_size > 0.0:
            pts = voxel_down_sample_plain(pts, voxel_size)
        out.append(np.asarray(pts, dtype=np.float64))
    return out


def pack_voxel_keys(keys: np.ndarray) -> Optional[np.ndarray]:
    """One int64 per row of non-negative integer voxel keys (N, D), in the
    rows' lexicographic order, or None where the grid holds 2^62 voxels or
    more and the packed key could overflow. A 1-D ``np.unique`` of the
    packed keys is ~20x faster than the row-wise one at 10^6 points."""
    span = keys.max(axis=0) + 1
    if not float(np.prod(span.astype(np.float64))) < 2.0 ** 62:
        return None
    flat = keys[:, 0]
    for d in range(1, keys.shape[1]):
        flat = flat * span[d] + keys[:, d]
    return flat


def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points falling in the same voxel (Open3D-compatible), the
    voxels in lexicographic key order; (N, 3) points natively."""
    if not voxel_size > 0.0:
        raise ValueError("voxel_size must be positive, got %r" % voxel_size)
    points = np.asarray(points, dtype=np.float64)
    if points.ndim == 2 and points.shape[1] == 3:
        return _io_native.voxel_down_sample(points, float(voxel_size))
    return voxel_down_sample_plain(points, voxel_size)


def voxel_down_sample_plain(points: np.ndarray,
                            voxel_size: float) -> np.ndarray:
    """numpy version of :func:`voxel_down_sample`, for any width."""
    if not voxel_size > 0.0:
        # Open3D raises the same; without this the divide produces an
        # int64-wrapped garbage voxelization (review finding).
        raise ValueError("voxel_size must be positive, got %r" % voxel_size)
    points = np.asarray(points, dtype=np.float64)
    vmin = points.min(axis=0)
    keys = np.floor((points - vmin) / voxel_size).astype(np.int64)
    # Lexicographic unique voxel ids.
    flat = pack_voxel_keys(keys)
    if flat is not None:
        _, inv = np.unique(flat, return_inverse=True)
    else:
        _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    nvox = inv.max() + 1
    sums = np.zeros((nvox, points.shape[1]))
    np.add.at(sums, inv, points)
    counts = np.bincount(inv, minlength=nvox)[:, None]
    return sums / counts

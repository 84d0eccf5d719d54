"""The port's native point-cloud loader (probreg_tpu_torch._io_native,
csrc/io_native.cpp) held to the JAX package's loaders.

The library is built here with the host C++ compiler at first use. The same
files and numpy points (made from a seed) go through the port's native
route, its numpy plain versions (``utils.io.*_plain``), the JAX package's
Python reader (its native module switched off) and the JAX package's own
native module (``probreg_tpu._io_native``, built by tests/conftest.py).
Every comparison is bit for bit: the readers convert the same stored values
to float64, and voxel downsampling sums each voxel's points in input order
in float64 in both routes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu import pyramid as jpy  # noqa: E402
from probreg_tpu.utils import io as jio  # noqa: E402
from probreg_tpu_torch import _io_native as nat  # noqa: E402
from probreg_tpu_torch import pyramid as ppy  # noqa: E402
from probreg_tpu_torch.ops import _build  # noqa: E402
from probreg_tpu_torch.ops import spatial  # noqa: E402
from probreg_tpu_torch.utils import io as pio  # noqa: E402
from probreg_tpu_torch.utils.datagen import blobby_surface  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(_ROOT, "data")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_native():
    return pytest.importorskip("probreg_tpu._io_native")


def _jax_python(monkeypatch, fn, *args):
    """The JAX package's numpy route (its native module switched off)."""
    with monkeypatch.context() as m:
        m.setattr(jio, "_nat", None)
        return fn(*args)


def _equal(a, b):
    assert a.dtype == np.float64 and b.dtype == np.float64
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Files in every format variant
# --------------------------------------------------------------------------

_NP = {"float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
       "uchar": "u1", "char": "i1", "short": "i2", "ushort": "u2",
       "int": "i4", "uint": "u4", "int16": "i2"}


def _write_ply(path, cols, fmt, crlf=False, comment="made from a seed"):
    """cols: [(name, ply type, values)] in record order."""
    nl = "\r\n" if crlf else "\n"
    n = len(cols[0][2])
    head = ["ply", "format %s 1.0" % fmt, "comment %s" % comment,
            "element vertex %d" % n]
    head += ["property %s %s" % (t, name) for name, t, _ in cols]
    head += ["element face 0", "property list uchar int vertex_indices",
             "end_header"]
    with open(path, "wb") as f:
        f.write(nl.join(head).encode() + nl.encode())
        if fmt == "ascii":
            for i in range(n):
                f.write((" ".join(repr(float(v[i])) if t in
                                  ("float", "float32", "double", "float64")
                                  else str(int(v[i])) for _, t, v in cols)
                         + nl).encode())
        else:
            end = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(name, end + _NP[t]) for name, t, _ in cols])
            rec = np.zeros(n, dt)
            for name, _, v in cols:
                rec[name] = v
            f.write(rec.tobytes())


def _write_pcd(path, cols, kind, crlf=False):
    """cols: [(name, size, type letter, count, values (n, count))]."""
    nl = "\r\n" if crlf else "\n"
    n = len(cols[0][4])
    head = ["# .PCD v0.7 - Point Cloud Data file format", "VERSION 0.7",
            "FIELDS " + " ".join(c[0] for c in cols),
            "SIZE " + " ".join(str(c[1]) for c in cols),
            "TYPE " + " ".join(c[2] for c in cols),
            "COUNT " + " ".join(str(c[3]) for c in cols),
            "WIDTH %d" % n, "HEIGHT 1", "VIEWPOINT 0 0 0 1 0 0 0",
            "POINTS %d" % n, "DATA %s" % kind]
    with open(path, "wb") as f:
        f.write(nl.join(head).encode() + nl.encode())
        if kind == "ascii":
            for i in range(n):
                f.write((" ".join(repr(float(x)) if t == "F" else
                                  str(int(x)) for _, _, t, _, v in cols
                                  for x in np.atleast_1d(v[i])) + nl)
                        .encode())
        else:
            dt = np.dtype([(name, "<%s%d" % ({"F": "f", "I": "i", "U": "u"}[t],
                                             s), (c,) if c > 1 else ())
                           for name, s, t, c, _ in cols])
            rec = np.zeros(n, dt)
            for name, _, _, _, v in cols:
                rec[name] = v
            f.write(rec.tobytes())


def _cloud_files(tmp):
    """Every PLY / PCD variant the readers cover, from one seeded cloud."""
    rng = np.random.default_rng(20)
    n = 257
    xyz = rng.normal(size=(n, 3)) * [1.0, 1e-3, 1e4]
    xyz[:7] = xyz[7:14]  # duplicates
    xyz[20] = [-0.0, 0.0, 1e-300]
    red = rng.integers(0, 256, n)
    ids = rng.integers(-2**31, 2**31 - 1, n)
    files = {}
    f32 = xyz.astype(np.float32)
    extra = [("red", "uchar", red)]
    for fmt in ("ascii", "binary_little_endian", "binary_big_endian"):
        files["ply " + fmt] = (
            "%s.ply" % fmt,
            lambda p, fmt=fmt: _write_ply(
                p, [("id", "int", ids), ("x", "float", f32[:, 0])] + extra
                + [("y", "float32", f32[:, 1]), ("nx", "double", xyz[:, 0]),
                   ("z", "float", f32[:, 2])], fmt))
    files["ply double, CRLF"] = ("crlf.ply", lambda p: _write_ply(
        p, [("x", "double", xyz[:, 0]), ("y", "double", xyz[:, 1]),
            ("z", "double", xyz[:, 2])], "binary_big_endian", crlf=True))
    files["ply ascii double, CRLF"] = ("crlf_ascii.ply", lambda p: _write_ply(
        p, [("x", "double", xyz[:, 0]), ("y", "double", xyz[:, 1]),
            ("z", "double", xyz[:, 2])], "ascii", crlf=True))
    files["ply int coordinates"] = ("ints.ply", lambda p: _write_ply(
        p, [("x", "short", ids % 3000 - 1500), ("y", "ushort", red * 200),
            ("z", "char", red - 128)], "binary_big_endian"))
    files["ply comment naming end_header"] = ("comment.ply", lambda p:
        _write_ply(p, [("x", "float", f32[:, 0]), ("y", "float", f32[:, 1]),
                       ("z", "float", f32[:, 2])], "binary_little_endian",
                   comment="the header ends at end_header"))
    rgb = rng.random((n, 1)).astype(np.float32)
    normal = rng.random((n, 3)).astype(np.float32)
    for kind in ("ascii", "binary"):
        files["pcd " + kind] = ("%s.pcd" % kind, lambda p, kind=kind:
            _write_pcd(p, [("normal", 4, "F", 3, normal),
                           ("x", 4, "F", 1, f32[:, 0]),
                           ("y", 8, "F", 1, xyz[:, 1]),
                           ("intensity", 2, "U", 1, red),
                           ("z", 4, "F", 1, f32[:, 2]),
                           ("rgb", 4, "F", 1, rgb[:, 0])], kind))
    files["pcd ascii, CRLF"] = ("crlf.pcd", lambda p: _write_pcd(
        p, [("x", 8, "F", 1, xyz[:, 0]), ("y", 8, "F", 1, xyz[:, 1]),
            ("z", 8, "F", 1, xyz[:, 2])], "ascii", crlf=True))
    files["pcd binary int"] = ("int.pcd", lambda p: _write_pcd(
        p, [("x", 4, "I", 1, ids), ("y", 1, "U", 1, red),
            ("z", 2, "I", 1, red - 300)], "binary"))
    out = {}
    for name, (fname, write) in files.items():
        path = os.path.join(tmp, fname)
        write(path)
        out[name] = path
    out["data/horse.ply"] = os.path.join(DATA, "horse.ply")
    out["data/bunny.pcd"] = os.path.join(DATA, "bunny.pcd")
    return out


@pytest.fixture(scope="module")
def cloud_files(tmp_path_factory):
    return _cloud_files(str(tmp_path_factory.mktemp("clouds")))


def test_readers_match_both_jax_loaders(cloud_files, ref_native,
                                        monkeypatch):
    for name, path in cloud_files.items():
        ply = path.endswith(".ply")
        got = (pio.read_ply if ply else pio.read_pcd)(path)
        assert got.flags.c_contiguous and got.shape[1] == 3, name
        _equal(got, (pio.read_ply_plain if ply else pio.read_pcd_plain)(path))
        _equal(got, _jax_python(monkeypatch,
                                jio.read_ply if ply else jio.read_pcd, path))
        _equal(got, (ref_native.read_ply if ply else ref_native.read_pcd)(
            path))
        _equal(got, pio.read_point_cloud(path))
    assert pio.read_ply(cloud_files["data/horse.ply"]).shape == (2936, 3)
    assert pio.read_pcd(cloud_files["data/bunny.pcd"]).shape == (397, 3)


def test_reader_errors(tmp_path):
    with pytest.raises(OSError):
        pio.read_ply(tmp_path / "missing.ply")
    with pytest.raises(FileNotFoundError):
        pio.read_pcd(str(tmp_path / "missing.pcd"))
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 2\n"
                    b"property float x\n")
    with pytest.raises(ValueError, match="not a PLY file"):
        pio.read_ply(bad)
    bad.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 9"
                    b"\nproperty float x\nproperty float y\nproperty float z"
                    b"\nend_header\n" + b"\0" * 12)
    with pytest.raises(ValueError, match="truncated"):
        pio.read_ply(bad)
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement face 1\nend_header\n")
    with pytest.raises(ValueError, match="leading vertex"):
        pio.read_ply(bad)
    pcd = tmp_path / "bad.pcd"
    pcd.write_bytes(b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nPOINTS 1\n"
                    b"DATA binary_compressed\n")
    with pytest.raises(ValueError, match="binary_compressed"):
        pio.read_pcd(pcd)


# --------------------------------------------------------------------------
# voxel_down_sample and voxel_count
# --------------------------------------------------------------------------

def _voxel_cases():
    rng = np.random.default_rng(21)
    surface = blobby_surface(40_000, seed=4).astype(np.float64)
    dup = np.repeat(rng.normal(size=(300, 3)), 4, axis=0)
    rng.shuffle(dup)
    return [
        ("surface", surface, 0.01),
        ("surface coarse", surface, 0.07),
        ("surface fine", surface, 0.002),
        ("negative", rng.normal(size=(5000, 3)) - 50.0, 0.3),
        ("duplicates", dup, 0.05),
        ("one voxel", rng.random((1000, 3)), 10.0),
        ("one point", np.array([[-1.5, 2.0, 1e-9]]), 0.1),
        ("threads", rng.normal(size=(300_000, 3)), 0.05),
        ("past one word", 1e7 * rng.normal(size=(4000, 3)), 1e-7),
    ]


@pytest.mark.parametrize("case", _voxel_cases(), ids=lambda c: c[0])
def test_voxel_down_sample_bit_for_bit(case, ref_native, monkeypatch):
    _, pts, voxel = case
    got = pio.voxel_down_sample(pts, voxel)
    _equal(got, pio.voxel_down_sample_plain(pts, voxel))
    _equal(got, nat.voxel_down_sample(pts, voxel))
    _equal(got, ref_native.voxel_down_sample(pts, voxel))
    _equal(got, _jax_python(monkeypatch, jio.voxel_down_sample, pts, voxel))


def test_voxel_down_sample_other_widths_and_bad_sizes(monkeypatch):
    rng = np.random.default_rng(22)
    for dim in (2, 4):
        pts = rng.normal(size=(3000, dim))
        got = pio.voxel_down_sample(pts, 0.2)
        assert got.shape[1] == dim
        _equal(got, pio.voxel_down_sample_plain(pts, 0.2))
        _equal(got, _jax_python(monkeypatch, jio.voxel_down_sample, pts, 0.2))
    pts = rng.normal(size=(100, 3))
    for bad in (0.0, -0.1, float("nan")):
        with pytest.raises(ValueError, match="positive"):
            pio.voxel_down_sample(pts, bad)
        with pytest.raises(ValueError, match="positive"):
            pio.voxel_down_sample_plain(pts, bad)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        nat.voxel_down_sample(pts[:, :2], 0.1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxel_count_is_the_number_of_unique_keys(dtype):
    rng = np.random.default_rng(23)
    for pts, voxel in ((blobby_surface(30_000, seed=5), 0.013),
                       (rng.normal(size=(200_000, 3)), 0.04),
                       (rng.normal(size=(5000, 2)) - 7.0, 0.05),
                       (rng.normal(size=(5000, 4)), 0.5),
                       (1e7 * rng.normal(size=(3000, 3)), 1e-7)):
        pts = pts.astype(dtype)
        keys = np.floor((pts - pts.min(axis=0)) / voxel).astype(np.int64)
        flat = pio.pack_voxel_keys(keys)
        want = (np.unique(flat).size if flat is not None
                else np.unique(keys, axis=0).shape[0])
        assert nat.voxel_count(pts, voxel) == want
        assert ppy._voxel_count(pts, voxel) == want
        assert ppy._voxel_count_plain(pts, voxel) == want
        assert jpy._voxel_count(pts, voxel) == want


# --------------------------------------------------------------------------
# read_batch
# --------------------------------------------------------------------------

def test_read_batch_threads_keep_input_order(cloud_files, tmp_path,
                                             ref_native):
    paths = list(cloud_files.values()) * 3
    txt = tmp_path / "fish.txt"
    np.savetxt(txt, np.random.default_rng(24).random((50, 2)))
    mixed = paths[:5] + [str(txt)] + paths[5:]
    for voxel in (0.0, 0.05):
        want = pio.read_batch_plain(mixed, voxel)
        ref = ref_native.read_batch(paths, voxel, 4)
        for threads in (1, 3, 0):
            got = pio.read_batch(mixed, voxel_size=voxel, threads=threads)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _equal(a, b)
            for a, b in zip(nat.read_batch(paths, voxel, threads), ref):
                _equal(a, b)
    assert pio.read_batch([]) == []


def test_read_batch_names_the_file_that_fails(cloud_files, tmp_path):
    missing = str(tmp_path / "no_such_cloud.pcd")
    paths = [cloud_files["data/horse.ply"], missing,
             cloud_files["data/bunny.pcd"]]
    for threads in (1, 2, 0):
        with pytest.raises(ValueError, match="no_such_cloud.pcd"):
            pio.read_batch(paths, threads=threads)
    other = tmp_path / "cloud.xyz"
    other.write_text("0 0 0\n")
    with pytest.raises(ValueError, match="cloud.xyz"):
        nat.read_batch([cloud_files["data/horse.ply"], str(other)])


# --------------------------------------------------------------------------
# Morton order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_morton_order_matches_torch_and_the_jax_native(dim, ref_native):
    from probreg_tpu.ops import spatial as jspatial

    rng = np.random.default_rng(25 + dim)
    for n in (1, 17, 5000, 200_000):
        pts = rng.normal(size=(n, dim)).astype(np.float32)
        if n > 10:
            pts[:8] = pts[8:16]  # ties keep their order
            pts[:, -1] = 0.25    # a zero-span axis
        got = nat.morton_order(pts)
        assert got.dtype == np.int64
        want = spatial.morton_order(torch.as_tensor(pts)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref_native.morton_order(pts))
        np.testing.assert_array_equal(spatial.morton_order_np(pts), want)
        if n <= 5000:
            np.testing.assert_array_equal(
                got, np.asarray(jspatial.morton_order(pts)))
    assert nat.morton_order(np.zeros((0, dim), np.float32)).shape == (0,)


@pytest.mark.parametrize("case,seed", [("normal3", 2), ("grid3", 3),
                                       ("normal2", 2)])
def test_morton_order_np_of_float64_clouds_is_the_references(case, seed):
    """A float64 cloud is quantized in float64, as the JAX package's numpy
    route does (its native sort takes float32 only): casting it to float32
    first moves the points whose scaled coordinate lies within a float32
    rounding of a cell boundary (on these seeds 26 of the 200,000 normal
    3-D points, 8 of the 100,000 on a 1e-3 grid, 36 of the 5,000 2-D
    points)."""
    from probreg_tpu.ops import spatial as jspatial

    rng = np.random.default_rng(seed)
    if case == "normal3":
        pts = rng.normal(size=(200_000, 3))
    elif case == "grid3":
        pts = np.round(rng.normal(size=(100_000, 3)), 3)
    else:
        pts = rng.normal(size=(5_000, 2))
    want = jspatial.morton_order_np(pts)
    got = spatial.morton_order_np(pts)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, spatial.morton_order(torch.as_tensor(pts)).numpy())


# --------------------------------------------------------------------------
# The pyramids' levels
# --------------------------------------------------------------------------

def test_pyramid_levels_are_the_plain_routes(monkeypatch):
    src = blobby_surface(50_000, seed=6)
    rot = np.asarray([[0.98, -0.2, 0.0], [0.2, 0.98, 0.0], [0.0, 0.0, 1.0]],
                     np.float32)
    tgt = (src @ rot.T + 0.01).astype(np.float32)
    args = (None, 3, 3000, 4.0, "cpu")
    s_nat, t_nat, v_nat = ppy._prepare_levels(src, tgt, *args)
    sizes = ppy.auto_voxel_sizes(src, tgt, 3, 3000, 4.0)
    assert sizes == v_nat == jpy.auto_voxel_sizes(src, tgt, 3, 3000, 4.0)
    with monkeypatch.context() as m:
        m.setattr(pio, "voxel_down_sample", pio.voxel_down_sample_plain)
        m.setattr(ppy, "_voxel_count", ppy._voxel_count_plain)
        s_pl, t_pl, v_pl = ppy._prepare_levels(src, tgt, *args)
    assert v_pl == v_nat
    for a, b in zip(s_nat + t_nat, s_pl + t_pl):
        a = a.numpy() if torch.is_tensor(a) else a
        b = b.numpy() if torch.is_tensor(b) else b
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(s_nat[:-1], jpy.build_pyramid(src, sizes)[:-1]):
        np.testing.assert_array_equal(a, np.asarray(b))


# --------------------------------------------------------------------------
# The build: no quiet fallback, one compile across processes
# --------------------------------------------------------------------------

def test_without_a_compiler_the_native_route_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    pts = np.random.default_rng(27).random((100, 3))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        pio.voxel_down_sample(pts, 0.1)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        pio.read_ply(os.path.join(DATA, "horse.ply"))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        ppy._voxel_count(pts, 0.1)
    # Only float32 clouds take the native sort (a float64 one is ordered
    # in float64 by the torch route, as the reference orders it).
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        spatial.morton_order_np(pts.astype(np.float32))
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_concurrent_builds_compile_once(tmp_path):
    code = ("import sys\nfrom pathlib import Path\n"
            "from probreg_tpu_torch.ops import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "start = _build._start\n"
            "def counted(name):\n"
            "    started = start(name)\n"
            "    print('compiled' if started else 'found')\n"
            "    return started\n"
            "_build._start = counted\n"
            "_build.load('io_native')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    said = sorted(o.strip() for o, _ in outs)
    assert said == ["compiled", "found", "found"], said
    assert len(list(tmp_path.glob("libio_native-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))

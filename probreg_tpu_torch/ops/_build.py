"""Build the sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``; each ``csrc/<name>.cpp`` (host code: the native
point-cloud loader) the same way by the host C++ compiler. Libraries go to
``build/torch_kernels/`` beside the package, named by a hash of the source,
the shared ``csrc/*.cuh`` headers and the flags, so a changed source is
rebuilt and an unchanged one is loaded as it is. One target is built by one
process at a time (a lock file beside it), so concurrent test workers
compile a library once. A failed build, or a missing compiler, raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# IEEE f32 on purpose: no --use_fast_math (it flushes subnormals and swaps in
# the approximate exp, which the reference's exactness properties exclude).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Host code keeps numpy's bits: no -ffast-math, and no contraction of a
# multiply and an add into one rounding.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++, g++ or clang++) on PATH: one "
                       f"is needed to build the native loader in {CSRC}")


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _target(name: str) -> Path:
    src = _source(name)
    if src.suffix == ".cu":
        # The shared headers count too: a changed header rebuilds every
        # CUDA source.
        code = src.read_bytes() + b"".join(
            p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        flags = NVCC_FLAGS
    else:
        code, flags = src.read_bytes(), CXX_FLAGS
    tag = hashlib.sha256(code + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


@contextlib.contextmanager
def _locked(names: Iterable[str]):
    """Hold the lock files of the given sources' targets (taken in sorted
    order, so two processes never wait on each other)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        for path in sorted({_target(n) for n in names}):
            fd = os.open(f"{path}.lock", os.O_RDWR | os.O_CREAT, 0o644)
            stack.callback(os.close, fd)
            fcntl.flock(fd, fcntl.LOCK_EX)
        yield


def _start(name: str):
    """Start the compiler for one source; None when its library is already
    built."""
    out = _target(name)
    if out.exists():
        return None
    src = _source(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if src.suffix == ".cu":
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for "
                           f"{_source(name).name} (exit {proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, out)
    return log


def build(names: Iterable[str] = None) -> Dict[str, str]:
    """Build the given sources (default: all of csrc/*.cu and csrc/*.cpp),
    one compiler each, all started together. Returns each source's compiler
    output (ptxas register and spill report; empty when the library was
    already built)."""
    if names is None:
        names = sorted(p.stem for p in (*CSRC.glob("*.cu"),
                                        *CSRC.glob("*.cpp")))
    names = list(names)
    with _lock, _locked(names):
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built first
    if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with _locked([name]):
                _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib

"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``. Libraries go to ``build/torch_kernels/`` beside the
package, named by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so a changed source is rebuilt and an unchanged one is
loaded as it is. A failed build raises.
"""

from __future__ import annotations

import ctypes
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


def _target(name: str) -> Path:
    # The shared headers count too: a changed header rebuilds every source.
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build(names: Iterable[str] = None) -> Dict[str, str]:
    """Build the given sources (default: all of csrc/*.cu), one nvcc each,
    all started together. Returns each source's compiler output (ptxas
    register and spill report; empty when the library was already built)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib

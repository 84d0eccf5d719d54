"""Build/install probreg_tpu (optionally with the native IO extension).

The package itself is pure Python/JAX; the extension is an optional native
data-loader (probreg_tpu/cc/io_native.cpp) that utils/io.py picks up when
present. Mirrors the role of the reference's setup.py-built pybind11
extensions (its IO went through Open3D C++; reference setup.py:114-193).

Set PROBREG_TPU_NO_NATIVE=1 to skip the extension (pure-python wheel);
otherwise a failed compile falls back to pure python instead of aborting
the install (the extension is strictly optional).
"""

import os

from setuptools import Extension, find_packages, setup
from setuptools.command.build_ext import build_ext


class _OptionalBuildExt(build_ext):
    """Tolerate a missing/broken compiler: the extension is optional."""

    def run(self):
        try:
            super().run()
        except Exception as exc:  # pragma: no cover - compiler-env dependent
            print(f"WARNING: skipping optional native extension: {exc}")

    def build_extension(self, ext):
        try:
            super().build_extension(ext)
        except Exception as exc:  # pragma: no cover
            print(f"WARNING: skipping optional native extension: {exc}")


def _ext_modules():
    if os.environ.get("PROBREG_TPU_NO_NATIVE"):
        return []
    import numpy as np

    return [
        Extension(
            "probreg_tpu._io_native",
            sources=["probreg_tpu/cc/io_native.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17"],
            language="c++",
        )
    ]


def _version():
    ns = {}
    with open(os.path.join("probreg_tpu", "version.py")) as f:
        exec(f.read(), ns)
    return ns["__version__"]


setup(
    name="probreg_tpu",
    version=_version(),
    description="TPU-native probabilistic point-cloud registration "
                "(JAX/XLA/Pallas)",
    packages=find_packages(include=["probreg_tpu", "probreg_tpu.*",
                                    "probreg_tpu_torch",
                                    "probreg_tpu_torch.*"]),
    package_data={"probreg_tpu": ["cc/*.cpp"],
                  "probreg_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    ext_modules=_ext_modules(),
    cmdclass={"build_ext": _OptionalBuildExt},
)

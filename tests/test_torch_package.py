"""Package boundaries of the PyTorch port (probreg_tpu_torch)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from probreg_tpu_torch import config as pcfg  # noqa: E402
from probreg_tpu_torch import cpd as pcpd  # noqa: E402
from probreg_tpu_torch import bcpd as pbcpd  # noqa: E402
from probreg_tpu_torch import filterreg as pfilterreg  # noqa: E402
from probreg_tpu_torch import gmmtree as pgmmtree  # noqa: E402
from probreg_tpu_torch import icp as picp  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, probreg_tpu_torch\n"
        "import probreg_tpu_torch.ops.estep_cuda, probreg_tpu_torch.ops._build\n"
        "import probreg_tpu_torch.ops.em_cuda, probreg_tpu_torch.filterreg\n"
        "import probreg_tpu_torch.ops.gausstransform\n"
        "import probreg_tpu_torch.ops.gt_cuda\n"
        "import probreg_tpu_torch.ops.frg_cuda\n"
        "import probreg_tpu_torch.gauss_transform\n"
        "import probreg_tpu_torch.ops.rigid_solvers\n"
        "import probreg_tpu_torch.utils.io, probreg_tpu_torch.utils.datagen\n"
        "import probreg_tpu_torch.utils.interop\n"
        "import probreg_tpu_torch.icp, probreg_tpu_torch.bcpd\n"
        "import probreg_tpu_torch.ops.icp_cuda, probreg_tpu_torch.ops.lowrank\n"
        "import probreg_tpu_torch.ops.bcpd_cuda\n"
        "import probreg_tpu_torch.gmmtree, probreg_tpu_torch.ops.gmmtree_cuda\n"
        "import probreg_tpu_torch.ops.sym3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'probreg_tpu' or m.startswith('probreg_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_point_without_cuda_raises_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcpd.registration_cpd(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pfilterreg.registration_filterreg(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pfilterreg.registration_filterreg_batch(pts[None], pts[None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        picp.registration_icp(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        picp.registration_icp_batch(pts[None], pts[None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pbcpd.registration_bcpd(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgmmtree.registration_gmmtree(pts, pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgmmtree.registration_gmmtree_batch(pts[None], pts[None])
    assert picp.registration_icp(pts + 1.0, pts, maxiter=2,
                                 device="cpu").n_iter == 2
    res = pfilterreg.registration_filterreg(pts + 1.0, pts, maxiter=2,
                                            device="cpu")
    assert res.transformation.rot.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        pcfg.resolve_device(None)
    assert pcfg.resolve_device("cpu").type == "cpu"
    assert pcfg.config.device == "cuda"


def test_kernel_sources_ship_with_the_package():
    from probreg_tpu_torch.ops import _build

    for name in ("estep.cu", "em.cu", "frg.cu", "gt.cu", "icp.cu",
                 "wstash.cu", "gmmtree.cu", "em_common.cuh"):
        assert (_build.CSRC / name).exists(), name
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "em", "estep", "frg", "gmmtree", "gt", "icp", "wstash"]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

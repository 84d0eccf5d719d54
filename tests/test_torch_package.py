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
        "import probreg_tpu_torch.pyramid\n"
        "import probreg_tpu_torch.parallel, probreg_tpu_torch.parallel.mesh\n"
        "import probreg_tpu_torch.parallel.sharded\n"
        "import probreg_tpu_torch.parallel.sharded2d\n"
        "import probreg_tpu_torch.parallel._spmd\n"
        "import probreg_tpu_torch.l2dist_regs, probreg_tpu_torch.features\n"
        "import probreg_tpu_torch.cost_functions\n"
        "import probreg_tpu_torch.ops.bfgs, probreg_tpu_torch.ops.ifgt\n"
        "import probreg_tpu_torch.tracking\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'probreg_tpu' or m.startswith('probreg_tpu.')]\n"
        "assert not bad, bad\n"
        "from probreg_tpu_torch import parallel as par\n"
        "print(' '.join(k for k in dir(par) if callable(getattr(par, k))))\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # The port's parallel package exports every sharded runner of the
    # JAX package's (read here, outside the process that must not import
    # it).
    import probreg_tpu.parallel as jpar

    wanted = {k for k in dir(jpar) if k.startswith("registration_")}
    assert wanted <= set(proc.stdout.split()), \
        wanted - set(proc.stdout.split())


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


def test_pyramid_entry_points_without_cuda_raise():
    """The pyramids run on the card by default too: without one they raise
    before any level runs, and run on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from probreg_tpu_torch import pyramid

    pts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    for fn in (pyramid.registration_cpd_pyramid,
               pyramid.registration_filterreg_pyramid,
               pyramid.registration_gmmtree_pyramid,
               pyramid.registration_icp_pyramid,
               pyramid.registration_bcpd_pyramid):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(pts, pts)
    res = pyramid.registration_icp_pyramid(pts + 0.01, pts, maxiter=2,
                                           device="cpu")
    assert res.transformation.rot.device.type == "cpu"


def test_l2dist_entry_points_without_cuda_raise():
    """GMMReg, SVR, their batches and the IFGT run on the card by default:
    without one they raise, and run on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from probreg_tpu_torch import gauss_transform as pgt
    from probreg_tpu_torch import l2dist_regs as pl

    rng = np.random.default_rng(0)
    pts = rng.random((40, 3)).astype(np.float32)
    tgt = pts + np.float32(0.01)
    calls = (
        (pl.registration_svr, (pts, tgt), dict(opt_maxiter=3)),
        (pl.registration_gmmreg, (pts, tgt),
         dict(n_gmm_components=8)),
        (pl.registration_svr_batch, (pts[None], tgt[None]),
         dict(opt_maxiter=3)),
        (pl.registration_gmmreg_batch, (pts[None], tgt[None]),
         dict(n_gmm_components=8, opt_maxiter=3)),
    )
    for fn, args, kw in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args, **kw)
        res = fn(*args, **kw, device="cpu")
        res = res[0] if isinstance(res, list) else res
        assert res.rot.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pgt.GaussTransform(pts, 0.5, method="ifgt")
    out = pgt.GaussTransform(pts, 0.5, method="ifgt",
                             device="cpu").compute(tgt)
    assert out.shape == (40,) and out.device.type == "cpu"


def test_kernel_sources_ship_with_the_package():
    from probreg_tpu_torch.ops import _build

    for name in ("estep.cu", "em.cu", "frg.cu", "gt.cu", "icp.cu",
                 "wstash.cu", "gmmtree.cu", "em_common.cuh",
                 "bf16_mma.cuh"):
        assert (_build.CSRC / name).exists(), name
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "em", "estep", "frg", "gmmtree", "gt", "icp", "wstash"]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # The native point-cloud loader: host C++, IEEE arithmetic.
    assert (_build.CSRC / "io_native.cpp").exists()
    assert sorted(p.stem for p in _build.CSRC.glob("*.cpp")) == ["io_native"]
    for flag in ("--use_fast_math", "-ffast-math", "-Ofast"):
        assert flag not in _build.CXX_FLAGS
    assert _build._target("io_native").parent == _build.BUILD_DIR

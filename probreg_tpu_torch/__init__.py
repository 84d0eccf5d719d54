"""probreg_tpu_torch: the PyTorch / CUDA port of probreg_tpu.

A second package beside the JAX one. Rigid and affine CPD, rigid FilterReg
(pt2pt and pt2pl), ICP and GMMTree run end to end, single pairs, batches
and large clouds, and combined BCPD single pairs up to 10^5 points and
beyond, on
hand-written CUDA kernels for the H100 (``csrc/``): the CPD E-steps
(``estep.cu``), the whole-EM CPD and FilterReg kernels (``em.cu``,
``frg.cu``), the whole-ICP kernel (``icp.cu``), the tile-culled Gauss
transform (``gt.cu``), the row-weighted culled BCPD E-step
(``wstash.cu``) and GMMTree's level-EM and registration kernels
(``gmmtree.cu``). It imports neither JAX nor the JAX package.
"""

import torch as _torch

# Annealed EM needs f32-exact squared distances (sigma2 falls toward machine
# epsilon); TF32 keeps ~3 decimal digits and breaks the annealing. The JAX
# package forces "highest" matmul precision for the same reason.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import bcpd, config, cpd, filterreg, gauss_transform  # noqa: E402,F401
from . import gmmtree, icp, log  # noqa: E402,F401
from .models import transformation  # noqa: E402,F401
from .utils import se3_op  # noqa: E402,F401
from .version import __version__  # noqa: E402,F401

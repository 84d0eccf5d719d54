"""probreg_tpu_torch: the PyTorch / CUDA port of probreg_tpu.

A second package beside the JAX one. Rigid CPD runs end to end; above the
dense threshold its E-steps go through hand-written CUDA kernels for the
H100 (``csrc/estep.cu``). It imports neither JAX nor the JAX package.
"""

import torch as _torch

# Annealed EM needs f32-exact squared distances (sigma2 falls toward machine
# epsilon); TF32 keeps ~3 decimal digits and breaks the annealing. The JAX
# package forces "highest" matmul precision for the same reason.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import config, cpd, log  # noqa: E402,F401
from .models import transformation  # noqa: E402,F401
from .utils import se3_op  # noqa: E402,F401
from .version import __version__  # noqa: E402,F401

"""probreg_tpu_torch: the PyTorch / CUDA port of probreg_tpu.

A second package beside the JAX one. Rigid, affine, nonrigid and
constrained nonrigid CPD (dense or low-rank), FilterReg (rigid pt2pt and
pt2pl with the exact or the permutohedral-lattice E-step and any feature
map, FPFH among them; and deformable-kinematic on dual quaternions), ICP
and GMMTree run end to end, single pairs, batches and large
clouds, and combined BCPD single pairs up to 10^5 points and beyond and
batches of pairs (fixed-size or ragged, dense or low-rank, one VI loop for
all of them); the
L2-distance family (``l2dist_regs``: GMMReg and SVR, rigid and thin-plate
spline, single pairs and rigid batches, on the features of ``features``,
the costs of ``cost_functions`` and a batched BFGS) and the IFGT
(``gauss_transform.GaussTransform(method="ifgt")``) run too. CPD,
FilterReg, GMMTree, BCPD and the rigid L2 registrations take ``n_starts``
(an orientation search); the loops take callbacks. The
coarse-to-fine pyramids of these families (``pyramid``) take clouds of
10^6 points; CPD also runs sharded over the ranks of
``torch.distributed`` (``parallel``: 1-D and 2-D meshes). ``tracking``
follows a sequence of frames with warm-started solves (``RigidTracker``
on CPD, FilterReg or ICP; ``NonrigidTracker`` on BCPD). They run on
hand-written CUDA kernels for the H100 (``csrc/``): the CPD E-steps
(``estep.cu``, the pipelined kernel's folded pass B and the 2-D mesh's
raw pass among them), the whole-EM CPD and FilterReg kernels (``em.cu``,
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

# The package surface of probreg_tpu/__init__.py.
from . import bcpd, config, cost_functions, cpd  # noqa: E402,F401
from . import features, filterreg, gauss_transform  # noqa: E402,F401
from . import gaussian_filtering, gmmtree, icp, l2dist_regs  # noqa: E402,F401
from . import log, math_utils, parallel, pyramid  # noqa: E402,F401
from . import se3_op, tracking, transformation  # noqa: E402,F401
from .version import __version__  # noqa: E402,F401


def __getattr__(name):
    # callbacks may pull in matplotlib or open3d: imported on first use.
    if name == "callbacks":
        import importlib

        return importlib.import_module(".callbacks", __name__)
    raise AttributeError(name)

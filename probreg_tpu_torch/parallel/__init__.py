"""Multi-rank execution on ``torch.distributed``: meshes and the sharded
runners.

Counterpart of probreg_tpu/parallel/. Every rank is a process; each calls
the same entry point with the same full clouds and gets back the same
result (mesh.py). With the target sharded over a 1-D mesh: rigid, affine
and nonrigid CPD (``registration_cpd_sharded``), rigid FilterReg, BCPD,
GMMTree, GMMReg and SVR (``registration_{filterreg,bcpd,gmmtree,gmmreg,
svr}_sharded``). With both clouds sharded over a 2-D ``(m, n)`` mesh:
rigid, affine and low-rank nonrigid CPD (``registration_cpd_2d``, the
culled E-step on kernel K11), rigid FilterReg and low-rank BCPD
(``registration_filterreg_2d``, ``registration_bcpd_2d``). Batches of CPD
pairs split over the ranks: ``registration_cpd_batch_sharded``.
"""

from .mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    mesh_2d_shape,
    shard_points,
    shard_points_t,
)
from .sharded import (  # noqa: F401
    estep_sharded,
    registration_bcpd_sharded,
    registration_cpd_batch_sharded,
    registration_cpd_sharded,
    registration_filterreg_sharded,
    registration_gmmreg_sharded,
    registration_gmmtree_sharded,
    registration_svr_sharded,
)
from .sharded2d import (  # noqa: F401
    registration_bcpd_2d,
    registration_cpd_2d,
    registration_filterreg_2d,
)

"""Top-level alias of :mod:`probreg_tpu_torch.models.transformation`, so
``from probreg_tpu_torch import transformation`` works as the reference's
``from probreg import transformation`` does."""

from .models.transformation import (  # noqa: F401
    AffineTransformation,
    CombinedTransformation,
    DeformableKinematicModel,
    LowRankNonRigidTransformation,
    NonRigidTransformation,
    RigidTransformation,
    TPSTransformation,
    Transformation,
)

"""Top-level alias of :mod:`probreg_tpu_torch.utils.se3_op` (reference
se3_op.py)."""

from .utils.se3_op import (  # noqa: F401
    diff_rot_from_quaternion,
    diff_x_from_twist,
    euler2mat,
    mat2euler,
    mat2quat,
    quat2mat,
    quat2mat_np,
    rotation_angle,
    skew,
    twist_mul,
    twist_trans,
)

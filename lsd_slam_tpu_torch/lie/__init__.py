"""Lie groups: torch f32 device ops (`groups`) and f64 host math (`np_sim3`).

Same layouts as lsd_slam_tpu.lie: quaternions ``[w, x, y, z]``, SE3
``(..., 7) = [quat, t]``, Sim3 ``(..., 8) = [quat, t, s]``, tangents
``[upsilon, omega(, sigma)]``.
"""

from lsd_slam_tpu_torch.lie.groups import (  # noqa: F401
    quat_mul,
    quat_conj,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
    matrix_to_quat,
    hat,
    so3_exp,
    so3_log,
    se3_identity,
    se3_exp,
    se3_log,
    se3_mul,
    se3_inverse,
    se3_apply,
    se3_adjoint,
    se3_from_sim3,
    sim3_from_se3,
    sim3_identity,
    sim3_exp,
    sim3_log,
    sim3_mul,
    sim3_inverse,
    sim3_apply,
    sim3_adjoint,
)

"""Branch-free quaternion / SE(3) / Sim(3) ops in torch f32.

Port of lsd_slam_tpu/lie/groups.py: quaternion, SE3 and Sim3
exp/log/mul/inverse/apply/adjoint, `quat_to_matrix` / `matrix_to_quat`,
and the Sim3 <-> SE3 converters. Same layouts and tangent ordering
([upsilon, omega(, sigma)]); every function takes arbitrary leading batch
dims and keeps the input dtype and device. Matrix products are plain f32
(the package disables TF32).
"""

from __future__ import annotations

import torch

# Taylor-fallback threshold (see lsd_slam_tpu.lie.groups._EPS)
_EPS = 1e-6

# terms of the W = sum M^k/(k+1)! series (lsd_slam_tpu.lie.groups)
_W_SERIES_TERMS = 16


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conj(q):
    # the product with [1, -1, -1, -1] (the JAX package's) bit for bit,
    # without copying that constant to the card, which waits for its stream
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q, p):
    """Rotate points ``p`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    w = q[..., 0:1]
    v = q[..., 1:4]
    vxp = _cross(v, p)
    return p + 2.0 * (w * vxp + _cross(v, vxp))


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion, branch-free: the
    four candidates (one per dominant diagonal term) blended by where."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    q0w = safe_sqrt(1.0 + tr)
    q0 = torch.stack([q0w, (m21 - m12) / q0w, (m02 - m20) / q0w,
                      (m10 - m01) / q0w], -1)
    q1x = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / q1x, q1x, (m01 + m10) / q1x,
                      (m02 + m20) / q1x], -1)
    q2y = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / q2y, (m01 + m10) / q2y, q2y,
                      (m12 + m21) / q2y], -1)
    q3z = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / q3z, (m02 + m20) / q3z,
                      (m12 + m21) / q3z, q3z], -1)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    best = torch.argmax(scores, dim=-1)[..., None]
    q = torch.where(best == 0, q0, torch.where(
        best == 1, q1, torch.where(best == 2, q2, q3)))
    return quat_normalize(0.5 * q)


def hat(w):
    """so(3) hat: (..., 3) -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(omega):
    """Axis-angle (..., 3) -> unit quaternion (..., 4)."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(
        small,
        0.5 - theta_sq / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(theta), theta),
    )
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * omega], dim=-1)


def so3_log(q):
    """Unit quaternion -> axis-angle (..., 3), |result| in [0, pi]."""
    w0 = q[..., 0:1]
    q = q * torch.sign(torch.where(w0 == 0, torch.ones_like(w0), w0))
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    vn_sq = torch.sum(q[..., 1:4] ** 2, dim=-1, keepdim=True)
    vn = torch.sqrt(vn_sq)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn_sq < _EPS
    scale = torch.where(
        small,
        2.0 / torch.clamp_min(w, 1e-12)
        * (1.0 - vn_sq / (3.0 * torch.clamp_min(w * w, 1e-12))),
        theta / torch.where(small, torch.ones_like(vn), vn),
    )
    return scale * q[..., 1:4]


def _w_matrix(omega, sigma):
    """W(omega, sigma) = sum_k M^k/(k+1)!, M = sigma*I + hat(omega)."""
    batch = torch.broadcast_shapes(omega.shape[:-1], sigma.shape)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(
        batch + (3, 3))
    m = (sigma[..., None, None] * eye + hat(omega)).expand(batch + (3, 3))
    w = eye
    for k in range(_W_SERIES_TERMS, 0, -1):
        w = eye + torch.matmul(m, w) / float(k + 1)
    return w


def _solve33(a, b):
    """Closed-form 3x3 solve via the adjugate (as lsd_slam_tpu.lie)."""
    c0 = _cross(a[..., 1, :], a[..., 2, :])
    c1 = _cross(a[..., 2, :], a[..., 0, :])
    c2 = _cross(a[..., 0, :], a[..., 1, :])
    det = torch.sum(a[..., 0, :] * c0, dim=-1, keepdim=True)
    x = b[..., 0:1] * c0 + b[..., 1:2] * c1 + b[..., 2:3] * c2
    return x / det


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(tuple(batch_shape) + (7,), dtype=dtype, device=device)
    g[..., 0] = 1.0
    return g


def se3_exp(tangent):
    ups, omega = tangent[..., 0:3], tangent[..., 3:6]
    q = so3_exp(omega)
    wm = _w_matrix(omega, torch.zeros(omega.shape[:-1], dtype=omega.dtype,
                                      device=omega.device))
    t = torch.matmul(wm, ups.unsqueeze(-1)).squeeze(-1)
    return torch.cat([q, t], dim=-1)


def se3_log(g):
    q, t = g[..., 0:4], g[..., 4:7]
    omega = so3_log(q)
    wm = _w_matrix(omega, torch.zeros(omega.shape[:-1], dtype=omega.dtype,
                                      device=omega.device))
    return torch.cat([_solve33(wm, t), omega], dim=-1)


def se3_mul(a, b):
    qa, ta = a[..., 0:4], a[..., 4:7]
    qb, tb = b[..., 0:4], b[..., 4:7]
    return torch.cat(
        [quat_normalize(quat_mul(qa, qb)), quat_rotate(qa, tb) + ta], dim=-1)


def se3_inverse(g):
    q, t = g[..., 0:4], g[..., 4:7]
    qi = quat_conj(q)
    return torch.cat([qi, -quat_rotate(qi, t)], dim=-1)


def se3_apply(g, p):
    return quat_rotate(g[..., 0:4], p) + g[..., 4:7]


def se3_adjoint(g):
    """Adjoint in [upsilon, omega] ordering: [[R, hat(t)R], [0, R]]."""
    r = quat_to_matrix(g[..., 0:4])
    adj = torch.zeros(g.shape[:-1] + (6, 6), dtype=g.dtype, device=g.device)
    adj[..., 0:3, 0:3] = r
    adj[..., 0:3, 3:6] = torch.matmul(hat(g[..., 4:7]), r)
    adj[..., 3:6, 3:6] = r
    return adj


# Sim(3): (..., 8) = [quat(4), t(3), s]; tangent (..., 7) = [ups, omega, sigma]

def sim3_identity(batch_shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(tuple(batch_shape) + (8,), dtype=dtype, device=device)
    g[..., 0] = 1.0
    g[..., 7] = 1.0
    return g


def sim3_exp(tangent):
    ups, omega, sigma = tangent[..., 0:3], tangent[..., 3:6], tangent[..., 6]
    q = so3_exp(omega)
    t = torch.matmul(_w_matrix(omega, sigma), ups.unsqueeze(-1)).squeeze(-1)
    return torch.cat([q, t, torch.exp(sigma)[..., None]], dim=-1)


def sim3_log(g):
    q, t, s = g[..., 0:4], g[..., 4:7], g[..., 7]
    omega = so3_log(q)
    sigma = torch.log(s)
    ups = _solve33(_w_matrix(omega, sigma), t)
    return torch.cat([ups, omega, sigma[..., None]], dim=-1)


def sim3_mul(a, b):
    qa, ta, sa = a[..., 0:4], a[..., 4:7], a[..., 7:8]
    qb, tb, sb = b[..., 0:4], b[..., 4:7], b[..., 7:8]
    return torch.cat([quat_normalize(quat_mul(qa, qb)),
                      sa * quat_rotate(qa, tb) + ta, sa * sb], dim=-1)


def sim3_inverse(g):
    q, t, s = g[..., 0:4], g[..., 4:7], g[..., 7:8]
    qi = quat_conj(q)
    si = 1.0 / s
    return torch.cat([qi, -si * quat_rotate(qi, t), si], dim=-1)


def sim3_apply(g, p):
    return g[..., 7:8] * quat_rotate(g[..., 0:4], p) + g[..., 4:7]


def sim3_adjoint(g):
    """Sim3 adjoint, [ups, omega, sigma] ordering (Sophus sim3.hpp Adj):
    [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    r = quat_to_matrix(g[..., 0:4])
    t = g[..., 4:7]
    adj = torch.zeros(g.shape[:-1] + (7, 7), dtype=g.dtype, device=g.device)
    adj[..., 0:3, 0:3] = g[..., 7, None, None] * r
    adj[..., 0:3, 3:6] = torch.matmul(hat(t), r)
    adj[..., 0:3, 6] = -t
    adj[..., 3:6, 3:6] = r
    adj[..., 6, 6] = 1.0
    return adj


def se3_from_sim3(g):
    """Drop the scale, keep rotation+translation (util/SophusUtil.h:60-63)."""
    return g[..., 0:7]


def sim3_from_se3(g, scale=1.0):
    """Attach an explicit scale (util/SophusUtil.h:53-58)."""
    s = torch.full(g.shape[:-1] + (1,), float(scale), dtype=g.dtype,
                   device=g.device)
    return torch.cat([g, s], dim=-1)

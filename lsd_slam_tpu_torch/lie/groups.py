"""Branch-free quaternion / SE(3) ops in torch f32.

Port of lsd_slam_tpu/lie/groups.py, limited to what the VO path calls:
quaternion and SE3 exp/log/mul/inverse, `quat_to_matrix`, and the Sim3 <->
SE3 converters. Same layouts and tangent ordering ([upsilon, omega]); every
function takes arbitrary leading batch dims and keeps the input dtype and
device. Matrix products are plain f32 (the package disables TF32).
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
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


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


def se3_from_sim3(g):
    """Drop the scale, keep rotation+translation (util/SophusUtil.h:60-63)."""
    return g[..., 0:7]


def sim3_from_se3(g, scale=1.0):
    """Attach an explicit scale (util/SophusUtil.h:53-58)."""
    s = torch.full(g.shape[:-1] + (1,), float(scale), dtype=g.dtype,
                   device=g.device)
    return torch.cat([g, s], dim=-1)

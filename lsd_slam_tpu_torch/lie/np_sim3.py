"""Host-side (numpy, float64) Sim3/SE3 helpers for pose bookkeeping.

A copy of lsd_slam_tpu/lie/np_sim3.py (the port never imports the JAX
package).

The reference does all pose composition in double-precision Sophus
(util/SophusUtil.h). On TPU, f64 is emulated and slow — so the device
kernels stay f32 while the host-side keyframe-graph bookkeeping (absolute
pose chains, graph updates) uses these numpy f64 routines. Same array
layouts as lsd_slam_tpu_torch.lie.groups: SE3 (7,) [quat, t], Sim3 (8,) [quat, t, s],
tangents [upsilon, omega(, sigma)].
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_rotate(q, p):
    w = q[..., 0:1]
    v = q[..., 1:4]
    vxp = np.cross(v, p)
    return p + 2.0 * (w * vxp + np.cross(v, vxp))


def quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(q.shape[:-1] + (3, 3))


def sim3_identity():
    return np.array([1, 0, 0, 0, 0, 0, 0, 1], dtype=np.float64)


def se3_identity():
    return np.array([1, 0, 0, 0, 0, 0, 0], dtype=np.float64)


def sim3_mul(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    q = quat_mul(a[..., 0:4], b[..., 0:4])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    t = a[..., 7:8] * quat_rotate(a[..., 0:4], b[..., 4:7]) + a[..., 4:7]
    return np.concatenate([q, t, a[..., 7:8] * b[..., 7:8]], axis=-1)


def sim3_inverse(g):
    g = np.asarray(g, np.float64)
    qi = quat_conj(g[..., 0:4])
    si = 1.0 / g[..., 7:8]
    return np.concatenate([qi, -si * quat_rotate(qi, g[..., 4:7]), si], axis=-1)


def se3_mul(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    q = quat_mul(a[..., 0:4], b[..., 0:4])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    t = quat_rotate(a[..., 0:4], b[..., 4:7]) + a[..., 4:7]
    return np.concatenate([q, t], axis=-1)


def se3_inverse(g):
    g = np.asarray(g, np.float64)
    qi = quat_conj(g[..., 0:4])
    return np.concatenate([qi, -quat_rotate(qi, g[..., 4:7])], axis=-1)


def sim3_from_se3(g, scale=1.0):
    g = np.asarray(g, np.float64)
    return np.concatenate([g, np.full(g.shape[:-1] + (1,), float(scale))],
                          axis=-1)


def se3_from_sim3(g):
    return np.asarray(g, np.float64)[..., 0:7]


def so3_log(q):
    q = np.asarray(q, np.float64)
    sign = np.where(q[..., 0:1] < 0, -1.0, 1.0)
    q = q * sign
    w = np.clip(q[..., 0:1], -1.0, 1.0)
    vn = np.linalg.norm(q[..., 1:4], axis=-1, keepdims=True)
    theta = 2.0 * np.arctan2(vn, w)
    scale = np.where(vn < 1e-9, 2.0 / np.maximum(w, _EPS),
                     theta / np.maximum(vn, _EPS))
    return scale * q[..., 1:4]


def sim3_log_norm(g):
    """Cheap magnitude of log(g): |upsilon-ish| + |omega| + |log s| — used
    for pose-discrepancy thresholds, not exact W-matrix inversion."""
    g = np.asarray(g, np.float64)
    w = so3_log(g[..., 0:4])
    return np.sqrt(np.sum(g[..., 4:7] ** 2, -1) + np.sum(w * w, -1)
                   + np.log(g[..., 7]) ** 2)


def se3_log(g):
    """Exact SE3 log in f64 (W-matrix series like lie.groups)."""
    g = np.asarray(g, np.float64)
    omega = so3_log(g[..., 0:4])

    def hat(v):
        z = np.zeros_like(v[..., 0])
        return np.stack([z, -v[..., 2], v[..., 1],
                         v[..., 2], z, -v[..., 0],
                         -v[..., 1], v[..., 0], z],
                        axis=-1).reshape(v.shape[:-1] + (3, 3))

    m = hat(omega)
    eye = np.broadcast_to(np.eye(3), m.shape)
    wmat = eye.copy()
    for k in range(18, 0, -1):
        wmat = eye + (m @ wmat) / (k + 1)
    ups = np.linalg.solve(wmat, g[..., 4:7][..., None])[..., 0]
    return np.concatenate([ups, omega], axis=-1)


def so3_exp(omega):
    """Axis-angle (..., 3) -> unit quaternion (..., 4), f64."""
    omega = np.asarray(omega, np.float64)
    theta = np.linalg.norm(omega, axis=-1, keepdims=True)
    half = 0.5 * theta
    small = theta < 1e-9
    k = np.where(small, 0.5 - theta ** 2 / 48.0,
                 np.sin(half) / np.maximum(theta, _EPS))
    w = np.where(small, 1.0 - theta ** 2 / 8.0, np.cos(half))
    return np.concatenate([w, k * omega], axis=-1)


def _w_matrix_np(omega, sigma, n_terms: int = 20):
    """W = sum_k M^k/(k+1)! with M = sigma*I + hat(omega), f64 Horner
    (mirrors lie.groups._w_matrix)."""
    omega = np.asarray(omega, np.float64)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    z = np.zeros_like(wx)
    hat = np.stack([
        np.stack([z, -wz, wy], -1),
        np.stack([wz, z, -wx], -1),
        np.stack([-wy, wx, z], -1)], -2)
    eye = np.broadcast_to(np.eye(3), hat.shape)
    m = np.asarray(sigma)[..., None, None] * eye + hat
    w = eye.copy()
    for k in range(n_terms, 0, -1):
        w = eye + (m @ w) / float(k + 1)
    return w


def sim3_exp(tangent):
    """Sim3 exp (..., 7) [upsilon, omega, sigma] -> (..., 8), f64
    (mirrors lie.groups.sim3_exp for host-side graph math)."""
    tangent = np.asarray(tangent, np.float64)
    ups, omega, sigma = tangent[..., 0:3], tangent[..., 3:6], tangent[..., 6]
    q = so3_exp(omega)
    s = np.exp(sigma)
    t = np.einsum("...ij,...j->...i", _w_matrix_np(omega, sigma), ups)
    return np.concatenate([q, t, s[..., None]], axis=-1)


def se3_exp(tangent):
    """SE3 exp (..., 6) [upsilon, omega] -> (..., 7), f64."""
    tangent = np.asarray(tangent, np.float64)
    ups, omega = tangent[..., 0:3], tangent[..., 3:6]
    q = so3_exp(omega)
    t = np.einsum("...ij,...j->...i",
                  _w_matrix_np(omega, np.zeros(omega.shape[:-1])), ups)
    return np.concatenate([q, t], axis=-1)


def sim3_log(g):
    """Exact Sim3 log (..., 8) -> (..., 7) [upsilon, omega, sigma], f64
    (mirrors lie.groups.sim3_log — host-side constraint math must not pay
    a device round-trip per candidate)."""
    g = np.asarray(g, np.float64)
    omega = so3_log(g[..., 0:4])
    sigma = np.log(g[..., 7])
    w = _w_matrix_np(omega, sigma)
    ups = np.linalg.solve(w, g[..., 4:7][..., None])[..., 0]
    return np.concatenate([ups, omega, sigma[..., None]], axis=-1)


def sim3_adjoint(g):
    """Sim3 adjoint (..., 8) -> (..., 7, 7), [ups, omega, sigma] ordering
    (Sophus sim3.hpp Adj; mirrors lie.groups.sim3_adjoint):

        [[s R, hat(t) R, -t],
         [ 0 ,    R    ,  0],
         [ 0 ,    0    ,  1]]
    """
    g = np.asarray(g, np.float64)
    r = quat_to_matrix(g[..., 0:4])
    t = g[..., 4:7]
    s = g[..., 7]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    z = np.zeros_like(tx)
    hat_t = np.stack([
        np.stack([z, -tz, ty], -1),
        np.stack([tz, z, -tx], -1),
        np.stack([-ty, tx, z], -1)], -2)
    adj = np.zeros(g.shape[:-1] + (7, 7), np.float64)
    adj[..., 0:3, 0:3] = s[..., None, None] * r
    adj[..., 0:3, 3:6] = hat_t @ r
    adj[..., 0:3, 6] = -t
    adj[..., 3:6, 3:6] = r
    adj[..., 6, 6] = 1.0
    return adj

"""Quaternion / SO(3) primitives (port of ``msckf_mono_tpu/utils/quat.py``).

Hamilton convention, stored as ``[w, x, y, z]`` along the last axis; every
function broadcasts over leading (batch) axes. Semantics match Eigen's
``Quaternion`` as used by the reference implementation:

* ``to_rotmat(q) @ v  ==  q * v`` (Eigen's ``q.toRotationMatrix()*v``),
* ``mul(a, b)`` is Eigen's ``a * b``,
* ``inverse`` of a unit quaternion is the conjugate.

The reference integrates the quaternion kinematics in the JPL-style stacked
form ``y = [-x, -y, -z, w]`` (msckf.h:1425-1467); :func:`integrate_rk5`
mirrors that computation exactly (same fixed RK coefficients).
"""

from __future__ import annotations

import torch


def skew(v):
    """Skew-symmetric matrix of a 3-vector (reference matrix_utils.h:8-17)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


# Unit-quaternion inverse == conjugate (Eigen ``q.inverse()`` for unit q).
inverse = conjugate


def mul(a, b):
    """Hamilton product ``a ⊗ b`` (Eigen ``a * b``)."""
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


def to_rotmat(q):
    """Rotation matrix R with ``R @ v == q * v`` (Eigen ``toRotationMatrix``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q, v):
    """Rotate vector(s) v by quaternion q (== to_rotmat(q) @ v), cheap form."""
    qv = q[..., 1:4]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def from_rotmat(r):
    """Quaternion from rotation matrix (Shepperd's method, branch-free)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-30)) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        dim=-1,
    )
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-30)) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        dim=-1,
    )
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-30)) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        dim=-1,
    )
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-30)) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        dim=-1,
    )

    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    return normalize(q)


def from_two_vectors(a, b):
    """Rotation taking direction a to direction b (Eigen ``FromTwoVectors``)."""
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = cross(an, bn)
    d = torch.sum(an * bn, dim=-1)
    w = 1.0 + d
    q = torch.cat([w[..., None], c], dim=-1)
    # Degenerate anti-parallel case: pick any orthogonal axis.
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    ortho = torch.where(torch.abs(an[..., 0:1]) < 0.9, cross(an, ex), cross(an, ey))
    q_flip = torch.cat([torch.zeros_like(w[..., None]), ortho], dim=-1)
    q = torch.where((w > 1e-8)[..., None], q, q_flip)
    return normalize(q)


def angular_distance(a, b):
    """Eigen ``a.angularDistance(b)``: 2*atan2(|vec(d)|, |w(d)|), d = a⁻¹ b."""
    d = mul(conjugate(a), b)
    return 2.0 * torch.atan2(torch.linalg.norm(d[..., 1:4], dim=-1), torch.abs(d[..., 0]))


def build_update_quat(delta_theta):
    """Multiplicative EKF correction quaternion (reference msckf.h:851-872)."""
    dq = 0.5 * delta_theta
    sq = torch.sum(dq * dq, dim=-1)
    w = torch.where(sq > 1.0, torch.ones_like(sq), torch.sqrt(torch.clamp(1.0 - sq, min=0.0)))
    q = torch.cat([w[..., None], -dq], dim=-1)
    return normalize(q)


def omega_mat_jpl(omega):
    """4x4 Omega matrix acting on y=[-x,-y,-z,w] (reference matrix_utils.h:19-30)."""
    s = skew(omega)
    top = torch.cat([-s, omega[..., :, None]], dim=-1)
    bot = torch.cat([-omega[..., None, :], torch.zeros_like(omega[..., :1, None])], dim=-1)
    return torch.cat([top, bot], dim=-2)


def integrate_rk5(q, omega, dt):
    """Fixed-coefficient 6-stage RK integration of quaternion kinematics.

    Numerically mirrors ``propogateImuStateRK`` (reference msckf.h:1425-1458).
    ``dt`` broadcasts against the leading axes of ``q``.
    """
    dt = torch.as_tensor(dt, dtype=q.dtype, device=q.device)[..., None]
    omega_psi = 0.5 * omega_mat_jpl(omega)

    y0 = torch.stack([-q[..., 1], -q[..., 2], -q[..., 3], q[..., 0]], dim=-1)

    def f(y):
        return torch.sum(omega_psi * y[..., None, :], dim=-1)

    k0 = f(y0)
    k1 = f(y0 + (k0 / 4.0) * dt)
    k2 = f(y0 + (k0 / 8.0 + k1 / 8.0) * dt)
    k3 = f(y0 + (-k1 / 2.0 + k2) * dt)
    k4 = f(y0 + (k0 * 3.0 / 16.0 + k3 * 9.0 / 16.0) * dt)
    k5 = f(y0 + (-k0 * 3.0 / 7.0 + k1 * 2.0 / 7.0 + k2 * 12.0 / 7.0 - k3 * 12.0 / 7.0 + k4 * 8.0 / 7.0) * dt)

    y_t = y0 + (7.0 * k0 + 32.0 * k2 + 12.0 * k3 + 32.0 * k4 + 7.0 * k5) * dt / 90.0

    q_new = torch.stack([y_t[..., 3], -y_t[..., 0], -y_t[..., 1], -y_t[..., 2]], dim=-1)
    return normalize(q_new)

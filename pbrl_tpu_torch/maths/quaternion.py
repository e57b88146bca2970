"""Batched quaternion algebra on torch tensors (counterpart of
``pbrl_tpu/maths/quaternion.py``).

Quaternions are ``(..., 4)`` tensors in wxyz order; rotation vectors are
axis * angle in radians. Every function broadcasts over leading batch
dimensions and is differentiable.
"""

from __future__ import annotations

import torch

from pbrl_tpu_torch.maths.numeric import safe_norm

_EPS = 1e-12
# q1 (x) q2 = sum_k (SIGN * q1[..., IDX])[..., i, k] * q2[..., k]: the
# Hamilton product as one gather, one product and one sum.
_MUL_IDX = ((0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_MUL_SIGN = ((1.0, -1.0, -1.0, -1.0), (1.0, 1.0, -1.0, 1.0),
             (1.0, 1.0, 1.0, -1.0), (1.0, -1.0, 1.0, 1.0))
_MUL_TABLES = {}


def identity(shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity quaternion(s) with the given batch shape."""
    q = torch.zeros(tuple(shape) + (4,), device=device, dtype=dtype)
    q[..., 0] = 1.0
    return q


def normalize(q: torch.Tensor) -> torch.Tensor:
    n = safe_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 * q2`` (wxyz)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def mul_fused(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """:func:`mul` in four tensor operations (the same products, summed in
    another order): what the engine's inner loops use, where the number of
    launches sets the time."""
    key = (q1.device, q1.dtype)
    if key not in _MUL_TABLES:
        _MUL_TABLES[key] = (torch.tensor(_MUL_IDX, device=q1.device).reshape(-1),
                            torch.tensor(_MUL_SIGN, device=q1.device, dtype=q1.dtype))
    idx, sign = _MUL_TABLES[key]
    left = q1[..., idx].unflatten(-1, (4, 4)) * sign
    return torch.sum(left * q2[..., None, :], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse for possibly non-unit quaternions."""
    return conj(q) / torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=_EPS)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R(q) @ v`` in the 15-mul form ``v + 2 (w (u x v) + u x (u x v))``."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return rotate(conj(q), v)


def from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Quaternion from (unit) axis and angle; ``angle`` broadcasts."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None]
    s = axis * torch.sin(half)
    return torch.cat([torch.cos(half).expand(s.shape[:-1] + (1,)), s], dim=-1)


def to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion, angle in (-pi, pi]."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:4]
    sin_half = safe_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < 1e-7, 2.0 + angle * angle / 12.0,
                        angle / torch.clamp(sin_half, min=_EPS))
    return v * scale[..., None]


def from_rotvec(rv: torch.Tensor) -> torch.Tensor:
    """Quaternion from a rotation vector (exp map), stable at small angles."""
    angle = safe_norm(rv, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-7
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=_EPS))
    return torch.cat([torch.cos(half), rv * k], dim=-1)


def integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """``q (x) exp(omega_local dt)``, normalised: MuJoCo's free/ball joint
    position integration (body-frame angular velocity)."""
    return normalize(mul(q, from_rotvec(omega_local * dt)))


def integrate_world(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate by a world-frame angular velocity: ``exp(w dt) (x) q``."""
    return normalize(mul(from_rotvec(omega_world * dt), q))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` of unit quaternion(s)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from a rotation matrix (Shepperd's branchless method:
    the best of four constructions by largest pivot, w >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                      1.0 + m22 - m00 - m11], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=_EPS)) * 0.5
    w0, x1, y2, z3 = qw.unbind(-1)
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], -1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)], -1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)], -1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3], -1),
    ], dim=-2)
    idx = torch.argmax(qw, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return normalize(q)


def to_euler_rxyz(q: torch.Tensor) -> torch.Tensor:
    """Intrinsic x-y-z Euler angles (``R = Rx(a) Ry(b) Rz(c)``), the
    decomposition a MuJoCo x/y/z hinge triple realises; at gimbal lock c is
    folded into a."""
    m = to_matrix(q)
    b = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    locked = torch.abs(m[..., 0, 2]) > 1.0 - 1e-7
    a = torch.where(locked, torch.atan2(m[..., 2, 1], m[..., 1, 1]),
                    torch.atan2(-m[..., 1, 2], m[..., 2, 2]))
    c = torch.where(locked, torch.zeros_like(b), torch.atan2(-m[..., 0, 1], m[..., 0, 0]))
    return torch.stack([a, b, c], dim=-1)


def from_euler_rxyz(euler: torch.Tensor) -> torch.Tensor:
    """Quaternion from intrinsic x-y-z Euler angles (``R = Rx Ry Rz``)."""
    a, b, c = euler.unbind(-1)
    z = torch.zeros_like(a)
    ex = torch.stack([a, z, z], dim=-1)
    ey = torch.stack([z, b, z], dim=-1)
    ez = torch.stack([z, z, c], dim=-1)
    return mul(from_rotvec(ex), mul(from_rotvec(ey), from_rotvec(ez)))


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a broadcast gradient back to an input's ``shape``."""
    lead = g.dim() - len(shape)
    if lead:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _AngleBetween(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q1, q2):
        ctx.save_for_backward(q1, q2)
        d = torch.abs(torch.sum(q1 * q2, dim=-1))
        return 2.0 * torch.acos(torch.clamp(d, -1.0, 1.0))

    @staticmethod
    def backward(ctx, g):
        q1, q2 = ctx.saved_tensors
        s = torch.sum(q1 * q2, dim=-1)
        d_safe = torch.clamp(torch.abs(s), -1.0 + 1e-6, 1.0 - 1e-6)
        coef = (g * (-2.0 / torch.sqrt(1.0 - d_safe * d_safe)) * torch.sign(s))[..., None]
        return _sum_to(coef * q2, q1.shape), _sum_to(coef * q1, q2.shape)


def angle_between(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two unit quaternions, in [0, pi].

    The value is the plain ``2 acos |<q1, q2>|``. Its gradient is pbrl_tpu's
    custom JVP transposed: ``d/dx acos`` diverges as ``|<q1, q2>| -> 1``,
    where autograd would give ``0 * inf = NaN`` exactly where a policy
    tracks well, so the derivative factor is clamped at ``|d| = 1 - 1e-6``
    (about 1.4e3). Analytic policy gradients (``train/apg.py``) need it."""
    return _AngleBetween.apply(q1, q2)


def box_minus(q_new: torch.Tensor, q_old: torch.Tensor, dt) -> torch.Tensor:
    """Finite-difference body-frame angular velocity
    ``log(q_old^-1 (x) q_new) / dt``."""
    return to_rotvec(mul(conj(q_old), q_new)) / dt

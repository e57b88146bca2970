"""Batched 6D spatial-vector algebra (counterpart of
``pbrl_tpu/maths/spatial.py``).

Spatial quantities are in world coordinates about a reference point (the
engine uses the root body's position): a motion vector is ``[omega(3),
v(3)]`` with ``v`` the velocity of the body-fixed point at the reference
point; a force vector is ``[torque about the point(3), force(3)]``. Every
function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

from pbrl_tpu_torch.maths.numeric import matmul


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix ``[v]x`` of shape (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape[:-1] + (3, 3))


def inertia_at_origin(mass: torch.Tensor, com: torch.Tensor,
                      inertia_c: torch.Tensor) -> torch.Tensor:
    """Spatial inertia (..., 6, 6) about the reference point:
    ``[[I_c + m cx cx^T, m cx], [m cx^T, m 1]]`` with ``cx = skew(com)``."""
    cx = skew(com)
    cxt = cx.transpose(-1, -2)
    m = mass[..., None, None]
    top_left = inertia_c + matmul(m * cx, cxt)
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(cx.shape)
    top = torch.cat([top_left, m * cx], dim=-1)
    bot = torch.cat([m * cxt, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product ``v x m`` (..., 6)."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, ml) + cross(vl, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product ``v x* f`` (..., 6)."""
    w, vl = v[..., :3], v[..., 3:]
    ft, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, ft) + cross(vl, fl), cross(w, fl)], dim=-1)


def point_velocity(v: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Linear velocity of ``point`` (relative to the reference point) on a
    body with motion ``v``."""
    return v[..., 3:] + cross(v[..., :3], point)

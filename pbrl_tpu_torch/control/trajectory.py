"""Cubic joint-space trajectories (counterpart of
``pbrl_tpu/control/trajectory.py``): coefficients of the cubic with zero
endpoint velocities, a ``(nu, 4)`` table over the actuators, and
pointwise evaluation of positions and velocities. Everything broadcasts.
"""

from __future__ import annotations

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cubic_coefficients(t0, tf, q0, qf) -> torch.Tensor:
    """(..., 4) coefficients of the cubic going q0 -> qf over [t0, tf] with
    zero endpoint velocity: ``q(t) = a0 + a1 t + a2 t^2 + a3 t^3``."""
    dev = next((x.device for x in (t0, tf, q0, qf) if isinstance(x, torch.Tensor)), None)
    t0, tf, q0, qf = (_f32(x, dev) for x in (t0, tf, q0, qf))
    d3 = (tf - t0) ** 3
    a0 = (qf * t0 ** 2 * (3 * tf - t0) + q0 * tf ** 2 * (tf - 3 * t0)) / d3
    a1 = 6 * t0 * tf * (q0 - qf) / d3
    a2 = 3 * (t0 + tf) * (qf - q0) / d3
    a3 = 2 * (q0 - qf) / d3
    return torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-1)


def constant_trajectories(nu: int, value=0.0, t0=1.0, tf=3.0) -> torch.Tensor:
    """(nu, 4) table holding ``value`` at every actuator."""
    return cubic_coefficients(t0, tf, value, value).reshape(1, 4).repeat(nu, 1)


def set_trajectories(table: torch.Tensor, indices, coeffs) -> torch.Tensor:
    """A copy of ``table`` with rows ``indices`` replaced by ``coeffs``."""
    idx = torch.as_tensor(indices, dtype=torch.long, device=table.device).reshape(-1)
    src = torch.as_tensor(coeffs, dtype=table.dtype, device=table.device).expand(
        idx.shape[0], table.shape[-1])
    return table.index_copy(0, idx, src)


def evaluate(table: torch.Tensor, t) -> torch.Tensor:
    """All trajectories at time ``t`` -> (..., nu)."""
    t = torch.as_tensor(t, dtype=table.dtype, device=table.device)
    return table[..., 0] + t * (table[..., 1] + t * (table[..., 2] + t * table[..., 3]))


def evaluate_velocity(table: torch.Tensor, t) -> torch.Tensor:
    """d/dt of :func:`evaluate`."""
    t = torch.as_tensor(t, dtype=table.dtype, device=table.device)
    return table[..., 1] + t * (2 * table[..., 2] + t * 3 * table[..., 3])

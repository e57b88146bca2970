"""PD controllers: standard, inverse-dynamics, Stable and implicit PD
(counterpart of ``pbrl_tpu/control/pd.py``).

Pure functions of ``(Model, Data)`` over a batch of envs: ``target`` and
the returned torques are (B, nu) on the actuated dofs. ``stable_pd`` solves
``(M + dt KD)`` per env with the unrolled Cholesky (symmetrised,
regularised by 1e-6); ``implicit_pd`` is the same law folded into the
integrator's implicit solve (explicit torque in ``qfrc_applied``, kd on
``imp_damping``), the production controller. Gains are ``Gains`` of (nu,)
arrays or tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pbrl_tpu_torch.engine.data import Data, model_cache
from pbrl_tpu_torch.maths.numeric import matmul
from pbrl_tpu_torch.model.spec import Model
from pbrl_tpu_torch.ops.linalg import solve_spd


class Gains(NamedTuple):
    kp: np.ndarray  # (nu,)
    kd: np.ndarray  # (nu,)


def _index(model: Model, device):
    def build():
        t = lambda x: torch.tensor(x, dtype=torch.long, device=device)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        return {"dofadr": t(model.actuator_dofadr), "qposadr": t(model.actuator_qposadr),
                "lo": f(model.actuator_gear * model.actuator_ctrlrange[:, 0]),
                "hi": f(model.actuator_gear * model.actuator_ctrlrange[:, 1])}
    return model_cache(model, device, "control", build)


def _gain(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _actuated(model: Model, data: Data):
    """(q, qd) on the actuated dofs (B, nu), and the dof index."""
    ix = _index(model, data.qpos.device)
    return data.qpos[:, ix["qposadr"]], data.qvel[:, ix["dofadr"]], ix["dofadr"]


def _scatter(model: Model, values: torch.Tensor, dofadr) -> torch.Tensor:
    """(B, nu) values set on their dofs of a zero (B, nv)."""
    out = values.new_zeros(values.shape[:-1] + (model.nv,))
    return out.index_copy(-1, dofadr, values)


def standard_pd(model: Model, data: Data, target: torch.Tensor, gains: Gains) -> torch.Tensor:
    """``tau = -kp (q - q*) - kd qd``."""
    q, qd, _ = _actuated(model, data)
    return -_gain(gains.kp, q) * (q - target) - _gain(gains.kd, q) * qd


def inverse_dynamics_pd(model: Model, data: Data, target: torch.Tensor,
                        gains: Gains) -> torch.Tensor:
    """Computed-torque PD: ``tau = (M u + qfrc_bias)[actuated]`` with the PD
    law ``u`` in acceleration space on the actuated dofs."""
    q, qd, dofadr = _actuated(model, data)
    u = _scatter(model, -_gain(gains.kp, q) * (q - target) - _gain(gains.kd, q) * qd, dofadr)
    tau_full = matmul(data.qM, u[..., None])[..., 0] + data.qfrc_bias
    return tau_full[:, dofadr]


def stable_pd(model: Model, data: Data, target_next: torch.Tensor, gains: Gains, *,
              target_vel_next=None, reg: float = 1e-6) -> torch.Tensor:
    """Stable PD (Tan et al. 2011) with the dt-lookahead target:

        e      = (q + dt qd) - q*_{t+dt}            (actuated dofs)
        (M + dt KD) qacc = -C - KP e - KD qd + qfrc_applied
        tau    = -kp e - kd (qd + dt qacc - qd*_{t+dt})
    """
    dt = float(np.float32(model.option.timestep))
    q, qd, dofadr = _actuated(model, data)
    kp, kd = _gain(gains.kp, q), _gain(gains.kd, q)
    e_act = q + dt * qd - target_next
    e = _scatter(model, e_act, dofadr)
    kp_full = _scatter(model, kp.expand_as(q), dofadr)
    kd_full = _scatter(model, kd.expand_as(q), dofadr)
    rhs = -data.qfrc_bias - kp_full * e - kd_full * data.qvel + data.qfrc_applied
    m_impl = data.qM + torch.diag_embed(dt * kd_full)
    eye = torch.eye(model.nv, dtype=m_impl.dtype, device=m_impl.device)
    m_impl = 0.5 * (m_impl + m_impl.transpose(-1, -2)) + reg * eye
    qacc = solve_spd(m_impl, rhs)
    qd_next = qd + dt * qacc[:, dofadr]
    if target_vel_next is not None:
        qd_next = qd_next - target_vel_next
    return -kp * e_act - kd * qd_next


def implicit_pd(model: Model, data: Data, target_next: torch.Tensor, gains: Gains, *,
                target_vel_next=None, clamp: bool = True, clamp_scale: float = 1.0) -> Data:
    """Stable PD fused into the integrator's implicit solve:
    ``(M + dt (D + KD)) qacc = f - kp e - kd qd``. The explicit part (clipped
    to the torque envelope when ``clamp``) rides ``qfrc_applied``, kd rides
    ``imp_damping``: one factorisation per substep in all."""
    dt = float(np.float32(model.option.timestep))
    q, qd, dofadr = _actuated(model, data)
    kp, kd = _gain(gains.kp, q), _gain(gains.kd, q)
    e = q + dt * qd - target_next
    qd_err = qd if target_vel_next is None else qd - target_vel_next
    tau = -kp * e - kd * qd_err
    if clamp:
        tau = clamp_torque(model, tau, clamp_scale)
    return data.replace(qfrc_applied=_scatter(model, tau, dofadr),
                        imp_damping=_scatter(model, kd.expand_as(q), dofadr))


def clamp_torque(model: Model, tau: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Clamp per-actuator torque to ``gear * ctrlrange * scale``."""
    ix = _index(model, tau.device)
    return torch.minimum(torch.maximum(tau, ix["lo"] * scale), ix["hi"] * scale)


def torque_to_qfrc(model: Model, tau: torch.Tensor) -> torch.Tensor:
    """Scatter (B, nu) actuated torques into a (B, nv) generalized force."""
    return _scatter(model, tau, _index(model, tau.device)["dofadr"])


def masked_torque(tau: torch.Tensor, actuator_mask) -> torch.Tensor:
    """Zero the torques outside ``actuator_mask`` (nu,)."""
    return tau * torch.as_tensor(actuator_mask, device=tau.device).to(tau.dtype)

"""Forward dynamics pipeline and integrator (counterpart of
``pbrl_tpu/engine/forward.py``).

    kinematics -> collide -> com_velocity -> crba -> rnea_bias -> passive
    -> actuation -> constraint_forces -> acceleration -> integrate

``step`` advances one physics substep of the whole batch; ``step_n`` runs
``n`` substeps in a Python loop. In 'step' self-contact-mass mode, substep
0's own constraint solve returns the self-contact masses and substeps
1..n-1 hold them (pbrl_tpu carries them through its ``lax.scan``).
Acceleration uses MuJoCo's implicit-damping Euler:
``(M + h diag(damping + imp_damping)) qacc = qfrc_smooth + qfrc_constraint``.

Spans (:func:`~pbrl_tpu_torch.utils.profiling.trace_annotation`, on while a
profiler records), one set per substep: ``engine/kinematics``,
``engine/collision``, ``engine/dynamics`` (the inertial quantities, the
actuators and the controller), ``engine/solve`` (the constraint solve and
the acceleration) and ``engine/integrate``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pbrl_tpu_torch.engine import collision, dynamics, kinematics, solver
from pbrl_tpu_torch.engine.data import Data, make_data, model_cache  # noqa: F401 (re-export)
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.model.spec import JointType, Model
from pbrl_tpu_torch.ops.linalg import solve_spd
from pbrl_tpu_torch.utils.profiling import trace_annotation

_QVEL_LIMIT = 1e3  # defensive clamp: keeps f32 contact blowups from cascading into NaNs


def fwd_velocity(model: Model, data: Data) -> Data:
    data = kinematics.com_velocity(model, data)
    data = dynamics.crba(model, data)
    data = dynamics.rnea_bias(model, data)
    return dynamics.passive(model, data)


def fwd_acceleration(model: Model, data: Data) -> Data:
    h = float(np.float32(model.option.timestep))
    damping = dynamics.tables(model, data.qpos.device).damping
    rhs = (data.qfrc_applied + data.qfrc_actuator + data.qfrc_passive - data.qfrc_bias
           + data.qfrc_constraint)
    m_impl = data.qM + torch.diag_embed(h * (damping + data.imp_damping))
    return data.replace(qacc=solve_spd(m_impl, rhs))


def forward_smooth(model: Model, data: Data) -> Data:
    """Kinematics and the inertial quantities only (qM, qfrc_bias, cvel):
    what the PD controllers read. No collision or constraint work."""
    return fwd_velocity(model, kinematics.kinematics(model, data))


def forward(model: Model, data: Data, qfrc_fn=None, held_self=None, use_held=None,
            return_self_masses: bool = False):
    """Full forward dynamics: every derived field including qacc.

    ``qfrc_fn(model, data)`` runs after the inertial quantities and before
    the constraint solve; it returns a (B, nv) force (it replaces
    ``qfrc_applied``) or a whole ``Data`` (implicit PD also sets
    ``imp_damping``). ``held_self``/``use_held``/``return_self_masses`` are
    the 'step' self-contact-mass plumbing of :func:`solver.contact_forces`."""
    with trace_annotation("engine/kinematics"):
        data = kinematics.kinematics(model, data)
    with trace_annotation("engine/collision"):
        data = collision.collide(model, data)
    with trace_annotation("engine/dynamics"):
        data = dynamics.actuation(model, fwd_velocity(model, data))
        if qfrc_fn is not None:
            out = qfrc_fn(model, data)
            data = out if isinstance(out, Data) else data.replace(qfrc_applied=out)
    with trace_annotation("engine/solve"):
        out = solver.constraint_forces(model, data, held_self=held_self, use_held=use_held,
                                       return_masses=return_self_masses)
        data, masses = out if return_self_masses else (out, None)
        data = fwd_acceleration(model, data)
    return (data, masses) if return_self_masses else data


@dataclasses.dataclass
class _Integration:
    scalar_q: torch.Tensor   # (n,) qpos of hinge/slide joints
    scalar_d: torch.Tensor   # (n,) their dofs
    free_q: torch.Tensor     # (nf,) qpos address of each free joint
    free_d: torch.Tensor     # (nf,) dof address
    perm: torch.Tensor       # (nq,) [scalar | free pos | free quat] -> qpos order


def _integration(model: Model, device) -> _Integration:
    sq, sd, fq, fd = [], [], [], []
    for j in range(model.njnt):
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        if model.jnt_type[j] == JointType.FREE:
            fq.append(qa)
            fd.append(da)
        else:
            sq.append(qa)
            sd.append(da)
    order = sq + [qa + k for qa in fq for k in range(3)] + [qa + k for qa in fq
                                                           for k in range(3, 7)]
    where = {q: i for i, q in enumerate(order)}
    t = lambda x: torch.tensor(x, dtype=torch.long, device=device)
    return _Integration(scalar_q=t(sq), scalar_d=t(sd), free_q=t(fq), free_d=t(fd),
                        perm=t([where[q] for q in range(model.nq)]))


def _integrate_qpos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor, h) -> torch.Tensor:
    """Position integration per joint type (free-joint quaternion on the manifold)."""
    it = model_cache(model, qpos.device, "integrate", lambda: _integration(model, qpos.device))
    B = qpos.shape[0]
    parts = [qpos[:, it.scalar_q] + h * qvel[:, it.scalar_d]]
    if it.free_q.numel():
        ar = torch.arange(7, device=qpos.device)
        fq = qpos[:, it.free_q[:, None] + ar]          # (B, nf, 7)
        fv = qvel[:, it.free_d[:, None] + ar[:6]]      # (B, nf, 6)
        parts.append((fq[..., :3] + h * fv[..., :3]).reshape(B, -1))
        parts.append(quat.integrate(fq[..., 3:], fv[..., 3:], h).reshape(B, -1))
    return torch.cat(parts, dim=1)[:, it.perm]


def integrate(model: Model, data: Data) -> Data:
    """Semi-implicit Euler: velocity first, then position with the new velocity."""
    h = float(np.float32(model.option.timestep))
    qvel = torch.clamp(data.qvel + h * data.qacc, -_QVEL_LIMIT, _QVEL_LIMIT)
    qpos = _integrate_qpos(model, data.qpos, qvel, h)
    return data.replace(qpos=qpos, qvel=qvel, time=data.time + h)


def step(model: Model, data: Data, ctrl: Optional[torch.Tensor] = None, qfrc_fn=None,
         held_self=None, use_held=None, return_self_masses: bool = False):
    """One physics substep; ``ctrl`` (when given) is held for it. With
    ``return_self_masses`` also returns the substep's fresh Delassus masses."""
    if ctrl is not None:
        data = data.replace(ctrl=ctrl)
    out = forward(model, data, qfrc_fn=qfrc_fn, held_self=held_self, use_held=use_held,
                  return_self_masses=return_self_masses)
    data, masses = out if return_self_masses else (out, None)
    with trace_annotation("engine/integrate"):
        data = integrate(model, data)
    return (data, masses) if return_self_masses else data


def step_n(model: Model, data: Data, n: int, ctrl: Optional[torch.Tensor] = None,
           qfrc_fn=None, on_substep=None) -> Data:
    """``n`` substeps with held control. With ``qfrc_fn`` the controller
    re-evaluates every substep against the fresh state. In 'step'
    self-contact-mass mode substep 0's solve supplies the self-contact
    masses held by substeps 1..n-1. ``on_substep(data)`` (optional) sees
    the state after each substep."""
    if ctrl is not None:
        data = data.replace(ctrl=ctrl)
    held = None
    step_mode = (model.option.self_contact_mass == "step"
                 and data.contact.dist.shape[1] > 0)
    for i in range(n):
        if step_mode:
            data, masses = step(model, data, qfrc_fn=qfrc_fn, held_self=held,
                                use_held=i > 0, return_self_masses=True)
            if i == 0:
                held = masses
        else:
            data = step(model, data, qfrc_fn=qfrc_fn)
        if on_substep is not None:
            on_substep(data)
    return data

"""Constraint forces: contacts (normal + Coulomb friction) and joint limits
(counterpart of ``pbrl_tpu/engine/solver.py``).

A vectorised compliant model with a friction-cone clamp:

* normal:   ``f_n = m_eff (-(1/tc^2) pen - (2 zeta/tc) v_n)``, clamped to
  ``f_n >= 0`` and active only while penetrating;
* friction: ``f_t = -m_eff (2/tc) v_t`` clamped to ``|f_t| <= mu f_n``;
* limits:   a one-sided spring-damper in joint space scaled by ``M[ii]``.

``m_eff`` is the exact Delassus mass ``1/(J M^-1 J^T)`` along the normal,
from the live configuration, with the two-body row
``J = (anc[b2] - anc[b1]) (S . f_hat)`` for ground and self contacts
alike. Self-contact rows follow ``Option.self_contact_mass``: 'substep'
(fresh every substep), 'step' (the policy-step entry substep's masses,
held: ``forward.step_n`` captures them with ``return_masses``) or 'static'
(the pairwise harmonic surrogate).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pbrl_tpu_torch.engine import collision
from pbrl_tpu_torch.engine.data import Data, model_cache
from pbrl_tpu_torch.maths.numeric import matmul, safe_norm
from pbrl_tpu_torch.maths.spatial import cross
from pbrl_tpu_torch.model.spec import JointType, Model
from pbrl_tpu_torch.ops.linalg import _solve_lower, cholesky_factor


@dataclasses.dataclass
class _Tables:
    danc: torch.Tensor        # (ncon, nv) anc[body2] - anc[body1] (world = zero row)
    b1: torch.Tensor          # (ncon,) body rows with the world at nbody
    b2: torch.Tensor
    is_ground: torch.Tensor   # (ncon,) bool
    m_harmonic: torch.Tensor  # (ncon,) the 'static' self-contact surrogate
    k: float                  # 1/tc^2 (float32 arithmetic, as pbrl_tpu's)
    b: float                  # 2 zeta/tc
    ft_gain: float            # 2/tc
    lim_qadr: torch.Tensor    # (nlim,)
    lim_dadr: torch.Tensor
    lim_lo: torch.Tensor
    lim_hi: torch.Tensor
    lim_k: float
    lim_b: float


def _build_tables(model: Model, device) -> _Tables:
    f32 = dict(dtype=torch.float32, device=device)
    ct = collision.tables(model, device)
    nb = model.nbody
    body1 = ct.body1.cpu().numpy()
    body2 = ct.body2.cpu().numpy()
    b1 = np.where(body1 < 0, nb, body1)
    b2 = np.where(body2 < 0, nb, body2)
    anc = np.concatenate([model.ancestor_mask, np.zeros((1, model.nv), np.float32)])
    inv_mass = np.concatenate([np.float32(1.0) / np.maximum(model.body_mass, np.float32(1e-9)),
                               np.zeros(1, np.float32)]).astype(np.float32)
    m_harm = np.float32(1.0) / np.maximum(inv_mass[b1] + inv_mass[b2], np.float32(1e-9))
    opt = model.option
    h = np.float32(opt.timestep)
    tc = np.maximum(np.float32(opt.contact_timeconst), np.float32(2.0) * h)
    ltc = np.maximum(np.float32(opt.limit_timeconst), np.float32(2.0) * h)
    rows = [j for j in range(model.njnt)
            if model.jnt_type[j] != JointType.FREE and model.jnt_limited[j]]
    rng = model.jnt_range[rows].reshape(-1, 2)
    return _Tables(
        danc=torch.as_tensor(anc[b2] - anc[b1], **f32),
        b1=torch.as_tensor(b1, device=device), b2=torch.as_tensor(b2, device=device),
        is_ground=torch.as_tensor(body1 < 0, device=device),
        m_harmonic=torch.as_tensor(m_harm.astype(np.float32), **f32),
        k=float(np.float32(1.0) / (tc * tc)), ft_gain=float(np.float32(2.0) / tc),
        b=float(np.float32(2.0) * np.float32(opt.contact_dampratio) / tc),
        lim_qadr=torch.tensor([model.jnt_qposadr[j] for j in rows], dtype=torch.long,
                              device=device),
        lim_dadr=torch.tensor([model.jnt_dofadr[j] for j in rows], dtype=torch.long,
                              device=device),
        lim_lo=torch.as_tensor(rng[:, 0], **f32), lim_hi=torch.as_tensor(rng[:, 1], **f32),
        lim_k=float(np.float32(1.0) / (ltc * ltc)),
        lim_b=float(np.float32(2.0) * np.float32(opt.limit_dampratio) / ltc))


def tables(model: Model, device) -> _Tables:
    return model_cache(model, device, "solver", lambda: _build_tables(model, device))


def _delassus_masses(model: Model, data: Data) -> torch.Tensor:
    """Exact per-row Delassus mass ``1/(J M^-1 J^T)`` along each contact
    normal, (B, ncon), from the live configuration."""
    tb = tables(model, data.qpos.device)
    con = data.contact
    arm = con.pos - data.origin[:, None]
    n_w = con.frame[..., 0, :]
    f_hat = torch.cat([cross(arm, n_w), n_w], dim=-1)                 # (B, ncon, 6)
    jrow = tb.danc * matmul(f_hat, data.subspace.transpose(1, 2))     # (B, ncon, nv)
    chol = cholesky_factor(data.qM)
    y = _solve_lower(chol[:, None], jrow)
    return 1.0 / torch.clamp(torch.sum(y * y, dim=-1), min=1e-6)


def contact_forces(model: Model, data: Data, held_self: Optional[torch.Tensor] = None,
                   use_held=None, return_masses: bool = False):
    """Solve the contact forces and add them to ``qfrc_constraint``.

    ``held_self``: (B, ncon) masses of the policy step's entry substep
    ('step' mode), used for the self-contact rows only. ``use_held``: a
    bool (or bool tensor) gating them, False on the entry substep itself;
    None means ``held_self is not None``. ``return_masses``: also return
    this substep's fresh masses (B, ncon)."""
    con = data.contact
    if con.dist.shape[1] == 0:
        out = data.replace(qfrc_constraint=torch.zeros_like(data.qvel))
        return (out, data.qvel.new_zeros(data.qvel.shape[0], 0)) if return_masses else out
    tb = tables(model, data.qpos.device)
    cvel = torch.cat([data.cvel, data.cvel.new_zeros(data.cvel.shape[0], 1, 6)], dim=1)
    v1, v2 = cvel[:, tb.b1], cvel[:, tb.b2]
    arm = con.pos - data.origin[:, None]
    vrel = (v2[..., 3:] + cross(v2[..., :3], arm)) - (v1[..., 3:] + cross(v1[..., :3], arm))
    v_frame = torch.sum(con.frame * vrel[..., None, :], dim=-1)       # (B, ncon, 3)
    vn, vt = v_frame[..., 0], v_frame[..., 1:]

    m_delassus = _delassus_masses(model, data)
    smode = model.option.self_contact_mass
    if smode == "static":
        m_eff = torch.where(tb.is_ground, m_delassus, tb.m_harmonic)
    elif smode == "step" and held_self is not None:
        if use_held is None or use_held is True:
            m_self = held_self
        elif use_held is False:
            m_self = m_delassus
        else:
            m_self = torch.where(use_held, held_self, m_delassus)
        m_eff = torch.where(tb.is_ground, m_delassus, m_self)
    else:  # 'substep', or 'step' at the policy step's entry substep
        m_eff = m_delassus

    pen = torch.clamp(con.dist, max=0.0)
    active = (con.dist < 0.0).to(data.qvel.dtype)
    fn = torch.clamp(m_eff * (-tb.k * pen - tb.b * vn), min=0.0) * active
    ft_raw = -m_eff[..., None] * tb.ft_gain * vt
    # safe_norm: ft_raw is exactly zero at rest and on zero-mass held rows
    ft_norm = safe_norm(ft_raw, dim=-1)
    cone = con.friction * fn
    scale = torch.where(ft_norm > 1e-9,
                        torch.clamp(cone / torch.clamp(ft_norm, min=1e-9), max=1.0),
                        torch.zeros_like(ft_norm))
    ft = ft_raw * scale[..., None] * active[..., None]
    f_frame = torch.cat([fn[..., None], ft], dim=-1)                   # (B, ncon, 3)
    f_world = torch.sum(con.frame * f_frame[..., None], dim=-2)       # frame rows -> world
    spatial_f = torch.cat([cross(arm, f_world), f_world], dim=-1)      # (B, ncon, 6)
    per_dof = matmul(tb.danc.t(), spatial_f)                           # (B, nv, 6)
    qfrc = torch.sum(data.subspace * per_dof, dim=-1)
    out = data.replace(qfrc_constraint=data.qfrc_constraint + qfrc,
                       contact=con.replace(force=f_frame))
    return (out, m_delassus) if return_masses else out


def limit_forces(model: Model, data: Data) -> Data:
    """One-sided compliant joint-limit torques for limited hinge/slide dofs."""
    tb = tables(model, data.qpos.device)
    if tb.lim_dadr.numel() == 0:
        return data
    q = data.qpos[:, tb.lim_qadr]
    qd = data.qvel[:, tb.lim_dadr]
    m_eff = data.qM[:, tb.lim_dadr, tb.lim_dadr]
    over_hi = torch.clamp(q - tb.lim_hi, min=0.0)
    over_lo = torch.clamp(tb.lim_lo - q, min=0.0)
    zero = torch.zeros_like(q)
    tau_hi = torch.clamp(torch.where(over_hi > 0, m_eff * (-tb.lim_k * over_hi - tb.lim_b * qd),
                                     zero), max=0.0)  # a limit can only push back
    tau_lo = torch.clamp(torch.where(over_lo > 0, m_eff * (tb.lim_k * over_lo - tb.lim_b * qd),
                                     zero), min=0.0)
    qfrc = torch.zeros_like(data.qvel).index_add(1, tb.lim_dadr, tau_hi + tau_lo)
    return data.replace(qfrc_constraint=data.qfrc_constraint + qfrc)


def constraint_forces(model: Model, data: Data, held_self=None, use_held=None,
                      return_masses: bool = False):
    data = data.replace(qfrc_constraint=torch.zeros_like(data.qvel))
    out = contact_forces(model, data, held_self=held_self, use_held=use_held,
                         return_masses=return_masses)
    data, masses = out if return_masses else (out, None)
    data = limit_forces(model, data)
    return (data, masses) if return_masses else data

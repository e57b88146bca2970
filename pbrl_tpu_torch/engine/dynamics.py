"""Inertial dynamics: CRBA mass matrix, RNEA bias forces, passive and
actuator forces (counterpart of ``pbrl_tpu/engine/dynamics.py``).

With motion axes ``S (nv, 6)`` about the root and the static ancestor mask
``A (nbody, nv)``, the CRBA is the masked quadratic form
``M = sum_b (A_b S) I_b (A_b S)^T`` (+ armature), two batched products.
The RNEA's body accelerations (qacc = 0, gravity as a base acceleration)
are pbrl_tpu's per-dof velocity-product terms ``Sdot_i qvel_i`` summed
over each body's ancestor dofs; pbrl_tpu accumulates them body by body
down the tree, here one product with the ancestor mask sums them, and a
static within-body prefix matrix gives each hinge the partial velocity
``v_run`` of the dofs before it. The products run in full f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrl_tpu_torch.engine.data import Data, model_cache
from pbrl_tpu_torch.maths import spatial
from pbrl_tpu_torch.maths.numeric import matmul
from pbrl_tpu_torch.model.spec import JointType, Model


@dataclasses.dataclass
class _Tables:
    mass: torch.Tensor        # (nb,)
    inertia: torch.Tensor     # (nb, 3, 3) body-frame inertia about the com
    anc: torch.Tensor         # (nb, nv)
    armature: torch.Tensor    # (nv, nv) diagonal
    damping: torch.Tensor     # (nv,)
    a_base: torch.Tensor      # (6,) [0, -g]
    vrun_body: torch.Tensor   # (nv,) body whose velocity starts a dof's v_run (nb = none)
    prefix: torch.Tensor      # (nv, nv) earlier non-free dofs of the same body
    bias_weight: torch.Tensor  # (nv,) 0 for free-joint translations (Sdot = 0)
    act_dofadr: torch.Tensor  # (nu,)
    ctrl_lo: torch.Tensor
    ctrl_hi: torch.Tensor
    gear: torch.Tensor


def _build_tables(model: Model, device) -> _Tables:
    f32 = dict(dtype=torch.float32, device=device)
    nv, nb = model.nv, model.nbody
    vrun_body = np.full(nv, nb)
    prefix = np.zeros((nv, nv), np.float32)
    weight = np.ones(nv, np.float32)
    joints_of = [[] for _ in range(nb)]
    for j in range(model.njnt):
        joints_of[model.jnt_bodyid[j]].append(j)
    for b in range(nb):
        p = model.body_parent[b]
        earlier = []
        for j in joints_of[b]:
            da = model.jnt_dofadr[j]
            if model.jnt_type[j] == JointType.FREE:
                # Sdot = v_body x S for the rotational axes, 0 for translations
                vrun_body[da:da + 6] = b
                weight[da:da + 3] = 0.0
                earlier = []
                continue
            vrun_body[da] = nb if p == -1 else p
            prefix[da, earlier] = 1.0
            earlier.append(da)
    g = np.asarray(model.option.gravity, np.float32)
    return _Tables(
        mass=torch.as_tensor(model.body_mass, **f32),
        inertia=torch.as_tensor(model.body_inertia, **f32),
        anc=torch.as_tensor(model.ancestor_mask, **f32),
        armature=torch.diag(torch.as_tensor(model.dof_armature, **f32)),
        damping=torch.as_tensor(model.dof_damping, **f32),
        a_base=torch.as_tensor(np.concatenate([np.zeros(3, np.float32), -g]), **f32),
        vrun_body=torch.as_tensor(vrun_body, device=device),
        prefix=torch.as_tensor(prefix, **f32),
        bias_weight=torch.as_tensor(weight, **f32),
        act_dofadr=torch.tensor(model.actuator_dofadr, dtype=torch.long, device=device),
        ctrl_lo=torch.as_tensor(model.actuator_ctrlrange[:, 0], **f32),
        ctrl_hi=torch.as_tensor(model.actuator_ctrlrange[:, 1], **f32),
        gear=torch.as_tensor(model.actuator_gear, **f32))


def tables(model: Model, device) -> _Tables:
    return model_cache(model, device, "dynamics", lambda: _build_tables(model, device))


def _spatial_inertias(model: Model, data: Data) -> torch.Tensor:
    """(B, nbody, 6, 6) world-frame spatial inertias about ``data.origin``."""
    tb = tables(model, data.qpos.device)
    rot = data.ximat
    inertia_w = matmul(matmul(rot, tb.inertia), rot.transpose(-1, -2))
    return spatial.inertia_at_origin(tb.mass, data.xipos - data.origin[:, None], inertia_w)


def crba(model: Model, data: Data) -> Data:
    """Dense joint-space mass matrix (composite rigid body algorithm)."""
    tb = tables(model, data.qpos.device)
    B, nv = data.qvel.shape
    imats = _spatial_inertias(model, data)                           # (B, nb, 6, 6)
    s_masked = tb.anc[None, :, :, None] * data.subspace[:, None]       # (B, nb, nv, 6)
    is_ = matmul(s_masked, imats.transpose(-1, -2))                    # (B, nb, nv, 6)
    flat = lambda x: x.transpose(1, 2).reshape(B, nv, -1)              # (B, nv, nb*6)
    m = matmul(flat(s_masked), flat(is_).transpose(1, 2))
    return data.replace(qM=m + tb.armature)


def rnea_bias(model: Model, data: Data) -> Data:
    """Coriolis + centrifugal + gravity generalized force (qacc = 0), with
    MuJoCo's sign: ``M qacc + qfrc_bias = qfrc_applied + qfrc_actuator +
    qfrc_passive + qfrc_constraint``."""
    tb = tables(model, data.qpos.device)
    imats = _spatial_inertias(model, data)
    v = data.cvel                                                      # (B, nb, 6)
    S, qvel = data.subspace, data.qvel
    v_pad = torch.cat([v, v.new_zeros(v.shape[0], 1, 6)], dim=1)
    v_run = v_pad[:, tb.vrun_body] + matmul(tb.prefix, S * qvel[..., None])
    terms = spatial.motion_cross(v_run, S) * (qvel * tb.bias_weight)[..., None]
    acc = tb.a_base + matmul(tb.anc, terms)                            # (B, nb, 6)
    momentum = matmul(imats, v[..., None])[..., 0]
    f = matmul(imats, acc[..., None])[..., 0] + spatial.force_cross(v, momentum)
    bias = torch.sum(S * matmul(tb.anc.t(), f), dim=-1)
    return data.replace(qfrc_bias=bias)


def passive(model: Model, data: Data) -> Data:
    """Joint damping (explicit part; the integrator adds the implicit part)."""
    return data.replace(qfrc_passive=-tables(model, data.qpos.device).damping * data.qvel)


def actuation(model: Model, data: Data) -> Data:
    """Torque motors: ``gear * clip(ctrl, ctrlrange)`` on their dofs."""
    if model.nu == 0:
        return data.replace(qfrc_actuator=torch.zeros_like(data.qvel))
    tb = tables(model, data.qpos.device)
    ctrl = torch.minimum(torch.maximum(data.ctrl, tb.ctrl_lo), tb.ctrl_hi)
    qfrc = torch.zeros_like(data.qvel).index_add(1, tb.act_dofadr, tb.gear * ctrl)
    return data.replace(qfrc_actuator=qfrc)


def full_mass_matrix(model: Model, data: Data) -> torch.Tensor:
    """The dense mass matrix (B, nv, nv) of the last ``crba``."""
    return data.qM

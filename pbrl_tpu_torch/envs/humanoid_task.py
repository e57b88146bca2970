"""Humanoid imitation task quantities: end-effectors, centre of mass, pose
errors, fall detection (counterpart of ``pbrl_tpu/envs/humanoid_task.py``).

Everything is batched over a leading env axis. ``ee_positions`` and
``center_of_mass`` take engine ``Data`` as pbrl_tpu's do, or body frames
(the policy-step kernel's outputs). ``augment_clip`` runs the engine's
kinematics over every clip frame, as pbrl_tpu does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pbrl_tpu_torch.engine import collision
from pbrl_tpu_torch.engine.data import Data, make_data
from pbrl_tpu_torch.engine.kinematics import kinematics
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.maths.numeric import safe_norm
from pbrl_tpu_torch.mocap.clip import MotionClip
from pbrl_tpu_torch.mocap.skeleton import DOF, MODEL_JOINT_ORDER
from pbrl_tpu_torch.model.spec import Model

# End-effector points: (body name, offset in body frame): wrist spheres and
# foot box centres.
EE_SPECS = (
    ("right_elbow", (0.0, 0.0, -0.258947)),
    ("left_elbow", (0.0, 0.0, -0.258947)),
    ("right_ankle", (0.045, 0.0, -0.0225)),
    ("left_ankle", (0.045, 0.0, -0.0225)),
)


def joint_slices(model: Model) -> Tuple[Tuple[int, int], ...]:
    """Static ((qposadr, dof), ...) for the 12 mocap joints in model order."""
    out = []
    for name in MODEL_JOINT_ORDER:
        dof = DOF[name]
        jname = name if dof == 1 else f"{name}_x"
        j = model.joint_id(jname)
        out.append((model.jnt_qposadr[j], dof))
    return tuple(out)


def ee_positions(model: Model, data_or_xpos, xquat: torch.Tensor = None) -> torch.Tensor:
    """(..., n_ee, 3) world end-effector points, from engine ``Data`` or from
    body frames ``xpos`` (..., nb, 3) and ``xquat`` (..., nb, 4)."""
    if isinstance(data_or_xpos, Data):
        xpos, xquat = data_or_xpos.xpos, data_or_xpos.xquat
    else:
        xpos = data_or_xpos
    bids = [model.body_id(n) for n, _ in EE_SPECS]
    offsets = xpos.new_tensor([o for _, o in EE_SPECS])
    return xpos[..., bids, :] + quat.rotate(xquat[..., bids, :], offsets)


def center_of_mass(model: Model, data_or_xpos, xquat: torch.Tensor = None) -> torch.Tensor:
    """(..., 3) whole-body centre of mass, from engine ``Data`` (its body
    centres ``xipos``) or from body frames."""
    if isinstance(data_or_xpos, Data):
        xipos = data_or_xpos.xipos
    else:
        xipos = data_or_xpos + quat.rotate(xquat, data_or_xpos.new_tensor(model.body_ipos))
    mass = xipos.new_tensor(model.body_mass)
    return torch.einsum("b,...bx->...x", mass, xipos) / torch.sum(mass)


def joint_pose_errors(model: Model, qpos: torch.Tensor, qpos_ref: torch.Tensor) -> torch.Tensor:
    """(B, 12) per-joint geodesic rotation error in radians: hinge triples
    composed to quaternions, so a 3-dof joint's error is one angle."""
    errs = []
    for qadr, dof in joint_slices(model):
        if dof == 1:
            errs.append(torch.abs(qpos[..., qadr] - qpos_ref[..., qadr]))
        else:
            q1 = quat.from_euler_rxyz(qpos[..., qadr:qadr + 3])
            q2 = quat.from_euler_rxyz(qpos_ref[..., qadr:qadr + 3])
            errs.append(quat.angle_between(q1, q2))
    return torch.stack(errs, dim=-1)


def root_pose_error(qpos: torch.Tensor, qpos_ref: torch.Tensor):
    """(position error norm, rotation error angle) of the free root, (B,) each."""
    pos = safe_norm(qpos[..., :3] - qpos_ref[..., :3], dim=-1)
    rot = quat.angle_between(quat.normalize(qpos[..., 3:7]), quat.normalize(qpos_ref[..., 3:7]))
    return pos, rot


def fall_mask(model: Model, allowed_body_names: Tuple[str, ...]) -> np.ndarray:
    """Static (ncon,) mask of the plane-contact slots whose body may NOT
    touch the ground (a fall when any of them touches)."""
    allowed = {model.body_id(n) for n in allowed_body_names}
    mask = []
    # the slot layout of collision.collide
    for t, pairs in sorted(collision._plane_groups(model).items()):
        per = collision.plane_contact_count(t)
        for _, other in pairs:
            mask.extend([model.geom_bodyid[other] not in allowed] * per)
    for (t1, t2), pairs in sorted(collision._pair_groups(model).items()):
        mask.extend([False] * (collision.pair_contact_count(t1, t2) * len(pairs)))
    assert len(mask) == collision.ncon_max(model), "layout drifted from collide()"
    return np.asarray(mask, bool)


def detect_fall(model: Model, data: Data, static_mask) -> torch.Tensor:
    """(B,) bool: a disallowed body touches the ground."""
    mask = torch.as_tensor(static_mask, device=data.contact.dist.device)
    return torch.any((data.contact.dist < 0.0) & mask, dim=-1)


def augment_clip(model: Model, clip: MotionClip) -> MotionClip:
    """Fill ``ee_pos``/``com`` by running the engine's kinematics over every
    clip frame."""
    d = kinematics(model, make_data(model, qpos=clip.qpos))
    return clip.replace(ee_pos=ee_positions(model, d), com=center_of_mass(model, d))

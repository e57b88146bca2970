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
from pbrl_tpu_torch.engine.data import Data, make_data, model_cache
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


def _tables(model: Model, device, dtype):
    """The reward's constant tensors on ``device``, built once per model,
    device and dtype (:func:`~pbrl_tpu_torch.engine.data.model_cache`), so a
    step copies nothing from the host: the ball joints' (8, 3) and the hinge
    joints' (4,) qpos columns, the permutation from [ball, hinge] back to
    model order, the end-effector body ids and offsets, and the bodies'
    inertial offsets, masses and total mass."""
    def build():
        slices = joint_slices(model)
        ball = [j for j, (_, dof) in enumerate(slices) if dof == 3]
        hinge = [j for j, (_, dof) in enumerate(slices) if dof == 1]
        idx = lambda x: torch.tensor(x, dtype=torch.long, device=device)
        val = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        mass = val(model.body_mass)
        return {
            "ball": idx([[slices[j][0] + k for k in range(3)] for j in ball]),
            "hinge": idx([slices[j][0] for j in hinge]),
            "order": idx(np.argsort(ball + hinge)),
            "ee_bids": idx([model.body_id(n) for n, _ in EE_SPECS]),
            "ee_offsets": val([o for _, o in EE_SPECS]),
            "body_ipos": val(model.body_ipos), "body_mass": mass, "mass_total": torch.sum(mass),
        }
    return model_cache(model, device, f"humanoid_task/{dtype}", build)


def ee_positions(model: Model, data_or_xpos, xquat: torch.Tensor = None) -> torch.Tensor:
    """(..., n_ee, 3) world end-effector points, from engine ``Data`` or from
    body frames ``xpos`` (..., nb, 3) and ``xquat`` (..., nb, 4)."""
    if isinstance(data_or_xpos, Data):
        xpos, xquat = data_or_xpos.xpos, data_or_xpos.xquat
    else:
        xpos = data_or_xpos
    t = _tables(model, xpos.device, xpos.dtype)
    bids = t["ee_bids"]
    return xpos[..., bids, :] + quat.rotate(xquat[..., bids, :], t["ee_offsets"])


def center_of_mass(model: Model, data_or_xpos, xquat: torch.Tensor = None) -> torch.Tensor:
    """(..., 3) whole-body centre of mass, from engine ``Data`` (its body
    centres ``xipos``) or from body frames."""
    if isinstance(data_or_xpos, Data):
        xipos = data_or_xpos.xipos
        t = _tables(model, xipos.device, xipos.dtype)
    else:
        t = _tables(model, data_or_xpos.device, data_or_xpos.dtype)
        xipos = data_or_xpos + quat.rotate(xquat, t["body_ipos"])
    return torch.einsum("b,...bx->...x", t["body_mass"], xipos) / t["mass_total"]


def joint_pose_errors(model: Model, qpos: torch.Tensor, qpos_ref: torch.Tensor) -> torch.Tensor:
    """(..., 12) per-joint geodesic rotation error in radians, in model
    order: each ball joint's hinge triple composed to a quaternion, so its
    error is one angle, and each hinge joint's absolute angle difference.
    The 8 ball joints go through one batched pass over a (..., 8, 3) block;
    every op is elementwise or reduces within one joint, so each column is
    bitwise what a loop over the joints gives."""
    t = _tables(model, qpos.device, qpos.dtype)
    ball, hinge = t["ball"], t["hinge"]
    q1 = quat.from_euler_rxyz(qpos[..., ball])
    q2 = quat.from_euler_rxyz(qpos_ref[..., ball])
    errs = torch.cat([quat.angle_between(q1, q2),
                      torch.abs(qpos[..., hinge] - qpos_ref[..., hinge])], dim=-1)
    return errs[..., t["order"]]


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

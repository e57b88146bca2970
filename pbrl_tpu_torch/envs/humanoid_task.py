"""The humanoid imitation task (counterpart of
``pbrl_tpu/envs/humanoid_task.py``): the DeepMimic observation, reward,
PD targets, termination, start draws and controllers, and the quantities
under them: end-effectors, centre of mass, pose errors, fall detection.

Both envs step through these functions: ``MimicVecEnv`` with the body
frames of the policy-step kernel or the engine, ``MimicEnv`` with its
engine ``Data``. The config is an argument of every call and is kept
nowhere, so a config replaced on a live env holds from its next call;
``env_tables`` builds an env's constant tensors once.

Everything is batched over a leading env axis. ``ee_positions`` and
``center_of_mass`` take engine ``Data`` as pbrl_tpu's do, or body frames
(the policy-step kernel's outputs). ``augment_clip`` runs the engine's
kinematics over every clip frame, as pbrl_tpu does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from pbrl_tpu_torch.control import default_gains
from pbrl_tpu_torch.control import pd as ctrl
from pbrl_tpu_torch.engine import collision
from pbrl_tpu_torch.engine.data import Data, make_data, model_cache
from pbrl_tpu_torch.engine.forward import forward_smooth
from pbrl_tpu_torch.engine.kinematics import kinematics
from pbrl_tpu_torch.envs.base import EnvConfig
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.mocap.clip import (MotionClip, phase, reference_aux,
                                       reference_frame_index, reference_state)
from pbrl_tpu_torch.mocap.skeleton import DOF, MODEL_JOINT_ORDER
from pbrl_tpu_torch.model.spec import Model

CONTROLLERS = ("implicit_pd", "stable_pd", "standard_pd", "inverse_dynamics_pd")
ACTION_MODES = ("absolute", "residual", "torque")

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


def root_rotation_error(qpos: torch.Tensor, qpos_ref: torch.Tensor) -> torch.Tensor:
    """(B,) rotation angle between the free root's and the reference's."""
    return quat.angle_between(quat.normalize(qpos[..., 3:7]), quat.normalize(qpos_ref[..., 3:7]))


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


def env_model(model: Model, config: EnvConfig) -> Model:
    """The model an env of ``config`` simulates: the physics rate and the
    self-contact mode pinned, the contact and friction scales applied,
    joint limits dropped when the config does not enforce them."""
    opt = model.option
    model = model.replace(option=opt.replace(
        timestep=np.asarray(config.physics_dt, np.float32),
        self_contact_mass=config.self_contact_mass))
    if config.contact_tc_scale != 1.0 or config.friction_scale != 1.0:
        opt = model.option
        model = model.replace(
            option=opt.replace(contact_timeconst=np.asarray(
                opt.contact_timeconst * config.contact_tc_scale, np.float32)),
            geom_friction=np.asarray(model.geom_friction * config.friction_scale,
                                     np.float32))
    if not config.enforce_joint_limits:
        model = model.replace(jnt_limited=tuple(False for _ in model.jnt_limited))
    return model


def gains_on(gains: ctrl.Gains, device, mask=None) -> ctrl.Gains:
    """``gains`` (times an actuator mask when given) as float32 tensors on
    ``device``, made once so that no step copies them to the card."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32) * (1.0 if mask is None else mask),
                                  dtype=torch.float32, device=device)
    return ctrl.Gains(kp=t(gains.kp), kd=t(gains.kd))


@dataclasses.dataclass(frozen=True)
class EnvTables:
    """An env's constant tensors on its device (:func:`env_tables`)."""

    qposadr: torch.Tensor           # (nu,) each actuator's qpos address
    act_lo: torch.Tensor            # (nu,) each actuator's joint range
    act_hi: torch.Tensor
    fall_bodies: Sequence[str]      # the bodies that may touch the ground
    fall_mask: torch.Tensor         # (ncon,) the contact slots that are a fall
    gains: ctrl.Gains               # scaled by kp_scale/kd_scale
    masked_gains: ctrl.Gains        # gains times the actuator mask
    mask: Optional[torch.Tensor]    # (nu,) the actuator mask, or None


def env_tables(model: Model, config: EnvConfig, gains: Optional[ctrl.Gains],
               actuator_mask, device) -> EnvTables:
    """The constant tensors of an env of ``config`` over its ``model``. The
    implicit-PD law takes the actuator mask folded into its gains (zero kp
    and kd give zero explicit torque and zero implicit diagonal)."""
    if config.controller not in CONTROLLERS:
        raise ValueError(f"unknown controller {config.controller!r}; one of "
                         f"{sorted(CONTROLLERS)}")
    if config.action_mode not in ACTION_MODES:
        raise ValueError(f"unknown action_mode {config.action_mode!r}; one of "
                         f"{sorted(ACTION_MODES)}")
    gains = gains or default_gains()
    base = ctrl.Gains(kp=np.asarray(gains.kp, np.float32) * np.float32(config.kp_scale),
                      kd=np.asarray(gains.kd, np.float32) * np.float32(config.kd_scale))
    mask = None if actuator_mask is None else np.asarray(actuator_mask).astype(np.float32)
    allowed = config.fall_contact_bodies or ("right_ankle", "left_ankle")
    rng = model.jnt_range[list(model.actuator_jntid())]  # (nu, 2) actuator order
    on = lambda x: torch.as_tensor(x, device=device)
    return EnvTables(qposadr=on(model.actuator_qposadr), act_lo=on(rng[:, 0]),
                     act_hi=on(rng[:, 1]), fall_bodies=allowed,
                     fall_mask=on(fall_mask(model, allowed)), gains=gains_on(base, device),
                     masked_gains=gains_on(base, device, mask),
                     mask=None if mask is None else on(mask))


Draw = Callable[..., torch.Tensor]  # draw(fn, *shape): fn's draw of shape (B, *shape)


def start_times(clip: MotionClip, config: EnvConfig, B: int, draw: Draw, device) -> torch.Tensor:
    """(B,) episode start times: the RSI draws, or zeros without RSI."""
    c = config
    if not c.reference_state_init:
        return torch.zeros(B, device=device)
    hi = clip.cycle_time if clip.loop else 0.9 * clip.cycle_time
    u = draw(torch.rand)
    if c.rsi_phase_bias > 0:
        u = u ** (1.0 / (1.0 + c.rsi_phase_bias))
    elif c.rsi_phase_bias < 0:
        u = u ** (1.0 - c.rsi_phase_bias)
    return hi * u


def reset_noise(model: Model, config: EnvConfig, qpos, qvel, draw: Draw):
    """The start states ``qpos, qvel`` with the reset noise."""
    c = config
    if c.rsi_noise_qpos > 0 or c.rsi_noise_qvel > 0:
        nq = draw(torch.randn, model.nq - 7)
        nv = draw(torch.randn, model.nv)
        qpos = torch.cat([qpos[:, :7], qpos[:, 7:] + c.rsi_noise_qpos * nq], dim=1)
        qvel = qvel + c.rsi_noise_qvel * nv
    if c.rsi_noise_root_xy > 0:
        nxy = 2.0 * draw(torch.rand, 2) - 1.0
        qpos = torch.cat([qpos[:, :2] + c.rsi_noise_root_xy * nxy, qpos[:, 2:]], dim=1)
    return qpos, qvel


def pd_target(clip: MotionClip, config: EnvConfig, t, action, tables: EnvTables):
    """(B, nu) PD targets of ``action`` for the policy step from ``t``."""
    c = config
    if c.action_mode == "residual":
        q_ref, _ = reference_state(clip, t + (c.policy_dt + c.ref_target_lead))
        action = q_ref[:, tables.qposadr] + action
    if not c.enforce_joint_limits:
        return action
    return torch.minimum(torch.maximum(action, tables.act_lo[None]), tables.act_hi[None])


def clamp_and_mask(model: Model, config: EnvConfig, tau, tables: EnvTables):
    """``tau`` clamped to the torque envelope, then masked."""
    tau = ctrl.clamp_torque(model, tau, config.torque_limit_scale)
    return tau if tables.mask is None else ctrl.masked_torque(tau, tables.mask)


def pd_torque(model: Model, config: EnvConfig, data: Data, target, tables: EnvTables):
    """The explicit law's clamped, masked torque on engine ``data``: Stable
    PD stands for implicit PD too."""
    law = {"standard_pd": ctrl.standard_pd,
           "inverse_dynamics_pd": ctrl.inverse_dynamics_pd}.get(config.controller, ctrl.stable_pd)
    return clamp_and_mask(model, config, law(model, data, target, tables.gains), tables)


def held_torque(model: Model, config: EnvConfig, data: Data, target, tables: EnvTables):
    """The torque held over a policy step: the explicit law on its start
    ``data``, whose ``qfrc_applied`` enters Stable PD's solve."""
    return pd_torque(model, config, forward_smooth(model, data), target, tables)


def engine_controller(model: Model, config: EnvConfig, u, tables: EnvTables,
                      torque: bool = False, implicit: Sequence[str] = ("implicit_pd",)):
    """The engine's ``qfrc_fn`` for a policy step: the torque ``u`` held
    (``torque``), or the PD target ``u`` under implicit PD for the laws in
    ``implicit``, else under the explicit law, every substep."""
    if torque:
        qfrc = ctrl.torque_to_qfrc(model, clamp_and_mask(model, config, u, tables))
        return lambda m, d: qfrc
    if config.controller in implicit:
        return lambda m, d: ctrl.implicit_pd(m, d, u, tables.masked_gains,
                                             clamp_scale=config.torque_limit_scale)
    return lambda m, d: ctrl.torque_to_qfrc(m, pd_torque(m, config, d, u, tables))


def observation_size(model: Model, config: EnvConfig) -> int:
    """The width of :func:`observation` under ``config``."""
    n = model.nq + model.nv
    if config.exclude_root_xy:
        n -= 2
    if config.include_phase:
        n += 1
    if config.include_ref_root_offset:
        n += 2
    if config.include_link_obs:
        n += 7 * model.nbody
    return n


def body_frames(model: Model, qpos, qvel):
    """(xpos, xquat) of a state no step made, by the engine's kinematics."""
    d = kinematics(model, make_data(model, qpos=qpos, qvel=qvel))
    return d.xpos, d.xquat


def observation(model: Model, clip: MotionClip, config: EnvConfig, qpos, qvel, t, q_ref,
                xpos=None, xquat=None) -> torch.Tensor:
    """The observation at ``t``, ``q_ref`` the reference qpos there; the
    link terms take the frames given, or :func:`body_frames`."""
    c = config
    parts = [qpos[:, 2:] if c.exclude_root_xy else qpos, qvel]
    if c.include_phase:
        parts.append(phase(clip, t)[:, None])
    if c.include_ref_root_offset or c.include_link_obs:
        w, x, y, z = qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6]
        yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
        cy, sy = torch.cos(yaw), torch.sin(yaw)
    if c.include_ref_root_offset:
        # the reference's root xy in the root heading (yaw) frame
        d = q_ref[:, :2] - qpos[:, :2]
        parts.append(torch.stack([cy * d[:, 0] + sy * d[:, 1],
                                  -sy * d[:, 0] + cy * d[:, 1]], dim=1))
    if c.include_link_obs:
        if xpos is None:
            xpos, xquat = body_frames(model, qpos, qvel)
        rel = xpos - qpos[:, None, :3]
        rx = cy[:, None] * rel[..., 0] + sy[:, None] * rel[..., 1]
        ry = -sy[:, None] * rel[..., 0] + cy[:, None] * rel[..., 1]
        # heading-normalised orientations: q_yaw^-1 * xquat
        h = 0.5 * yaw
        zero = torch.zeros_like(h)
        qh_inv = torch.stack([torch.cos(h), zero, zero, -torch.sin(h)], dim=1)
        qrel = quat.mul(qh_inv[:, None, :], xquat)
        parts.append(torch.cat([rx, ry, rel[..., 2], qrel.reshape(qpos.shape[0], -1)],
                               dim=1))
    return torch.cat(parts, dim=1)


def reward(model: Model, clip: MotionClip, config: EnvConfig, qpos, qvel, t, ref, xpos, xquat,
           fall):
    """(reward, terms) at ``t``, ``ref`` the reference (qpos, qvel) there,
    ``fall`` (B,) > 0 where an env fell."""
    c = config
    q_ref, v_ref = ref
    ee_ref, com_ref = reference_aux(clip, t)

    joint_err = joint_pose_errors(model, qpos, q_ref)  # (B, 12)
    root_rot = root_rotation_error(qpos, q_ref)
    pose_sq = torch.sum(joint_err ** 2, dim=1) + root_rot ** 2
    r_pose = torch.exp(-c.s_pose * pose_sq)
    r_vel = torch.exp(-c.s_vel * torch.sum((qvel - v_ref) ** 2, dim=1))
    ee = ee_positions(model, xpos, xquat)
    r_ee = torch.exp(-c.s_ee * torch.sum((ee - ee_ref) ** 2, dim=(1, 2)) / len(EE_SPECS))
    com = center_of_mass(model, xpos, xquat)
    r_com = torch.exp(-c.s_com * torch.sum((com - com_ref) ** 2, dim=1))

    reward = c.w_pose * r_pose + c.w_vel * r_vel + c.w_ee * r_ee + c.w_com * r_com
    if c.aerial_window:
        # flight phase: blend toward a root-rotation and root-angular-
        # velocity reward inside the window
        lo, hi = c.aerial_window
        ph = phase(clip, t)
        edge = max(c.aerial_edge, 1e-6)
        win = (torch.clamp((ph - lo) / edge, 0.0, 1.0)
               * torch.clamp((hi - ph) / edge, 0.0, 1.0))
        r_root = torch.exp(-c.aerial_s_root * root_rot ** 2)
        dw = qvel[:, 3:6] - v_ref[:, 3:6]
        r_angvel = torch.exp(-c.aerial_s_angvel * torch.sum(dw ** 2, dim=1))
        aerial = (c.aerial_w_pose * r_pose + c.aerial_w_root * r_root
                  + c.aerial_w_angvel * r_angvel + c.aerial_w_com * r_com)
        reward = (1.0 - win) * reward + win * aerial
    if c.drift_w > 0:
        # training-only root-xy shaping at a gentle scale
        dxy = qpos[:, :2] - q_ref[:, :2]
        r_drift = torch.exp(-c.drift_s * torch.sum(dxy ** 2, dim=1))
        reward = (1.0 - c.drift_w) * reward + c.drift_w * r_drift
    if c.early_termination:
        reward = torch.where(fall > 0, 0.0, reward)
    terms = {
        "reward_pose": r_pose, "reward_vel": r_vel, "reward_ee": r_ee,
        "reward_com": r_com, "pose_error": torch.mean(joint_err, dim=1),
        "root_err": root_rot,
    }
    return reward, terms


def termination(clip: MotionClip, config: EnvConfig, t, episode_start, fall, root_err, reward):
    """(reward, done) of a step ending at ``t``; pose termination zeroes
    the reward too."""
    c = config
    in_episode = t - episode_start
    done = torch.zeros_like(fall)
    if c.early_termination:
        done = torch.maximum(done, fall)
    if c.pose_termination > 0:
        thr = torch.full_like(t, c.pose_termination)
        if c.pose_termination_after_cycle > 0:
            thr = torch.where(in_episode >= clip.cycle_time, c.pose_termination_after_cycle, thr)
        off_pose = root_err > thr
        reward = torch.where(off_pose, 0.0, reward)
        done = torch.maximum(done, off_pose.to(done.dtype))
    done = torch.maximum(done, (in_episode >= c.max_episode_time).to(done.dtype))
    if not clip.loop:
        done = torch.maximum(done, (t >= clip.cycle_time).to(done.dtype))
    return reward, done


def step_metrics(clip: MotionClip, t, fall, terms):
    """A step's metrics: the clip frame at ``t``, the fall, the reward terms."""
    return {"step_index": reference_frame_index(clip, t).to(torch.float32), "fall": fall,
            **terms}

"""Motion-imitation environment over the engine: PD-driven humanoid with
the DeepMimic reward (counterpart of ``pbrl_tpu/envs/mimic.py``).

The action is the PD target (or, in ``torque`` mode, the torque); the
controller (implicit, Stable, standard or inverse-dynamics PD) turns it
into torque, re-evaluated every physics substep (``pd_per_substep``) or
once per policy step from the pre-step state and held (the reference's
semantics). The reward is the four DeepMimic terms with the aerial-window
and drift shaping; resets start at a random clip phase (RSI) with optional
noise. pbrl_tpu's env holds one env and is vmapped; this one steps a batch
of envs with a leading env axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pbrl_tpu_torch.control import default_gains
from pbrl_tpu_torch.control import pd as ctrl
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.forward import forward_smooth, step_n
from pbrl_tpu_torch.engine.kinematics import kinematics as run_kinematics
from pbrl_tpu_torch.envs import humanoid_task as task
from pbrl_tpu_torch.envs.base import Env, EnvConfig, State
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.mocap.clip import (MotionClip, phase, reference_aux,
                                       reference_frame_index, reference_state)
from pbrl_tpu_torch.model.spec import Model

CONTROLLERS = ("implicit_pd", "stable_pd", "standard_pd", "inverse_dynamics_pd")


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


def scaled_gains(gains: ctrl.Gains, config: EnvConfig) -> ctrl.Gains:
    """The gain table scaled by ``kp_scale``/``kd_scale`` (float32 numpy)."""
    return ctrl.Gains(kp=np.asarray(gains.kp, np.float32) * np.float32(config.kp_scale),
                      kd=np.asarray(gains.kd, np.float32) * np.float32(config.kd_scale))


def gains_on(gains: ctrl.Gains, device, mask=None) -> ctrl.Gains:
    """``gains`` (times an actuator mask when given) as float32 tensors on
    ``device``, made once so that no step copies them to the card."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32) * (1.0 if mask is None else mask),
                                  dtype=torch.float32, device=device)
    return ctrl.Gains(kp=t(gains.kp), kd=t(gains.kd))


class MimicEnv(Env):
    """DeepMimic-style imitation of one motion clip, on the clip's device."""

    def __init__(self, model: Model, clip: MotionClip, config: EnvConfig = EnvConfig(),
                 gains: Optional[ctrl.Gains] = None, actuator_mask=None):
        if config.controller not in CONTROLLERS:
            raise ValueError(f"unknown controller {config.controller!r}; one of "
                             f"{sorted(CONTROLLERS)}")
        model = env_model(model, config)
        self.model = model
        self.config = config
        self.device = clip.qpos.device
        self.clip = clip if clip.ee_pos is not None else task.augment_clip(model, clip)
        base = scaled_gains(gains or default_gains(), config)
        self.gains = gains_on(base, self.device)
        self.actuator_mask = None
        self._masked_gains = self.gains
        if actuator_mask is not None:
            mk = np.asarray(actuator_mask).astype(np.float32)
            self.actuator_mask = torch.as_tensor(mk, device=self.device)
            self._masked_gains = gains_on(base, self.device, mk)
        allowed = config.fall_contact_bodies or ("right_ankle", "left_ankle")
        self._fall_mask = torch.as_tensor(task.fall_mask(model, allowed), device=self.device)
        self._qposadr = torch.tensor(model.actuator_qposadr, device=self.device)
        rng = model.jnt_range[list(model.actuator_jntid())]  # (nu, 2) actuator order
        self._act_lo = torch.as_tensor(rng[:, 0], device=self.device)
        self._act_hi = torch.as_tensor(rng[:, 1], device=self.device)

    # -- sizes ------------------------------------------------------------
    @property
    def observation_size(self) -> int:
        n = self.model.nq + self.model.nv
        if self.config.exclude_root_xy:
            n -= 2
        if self.config.include_phase:
            n += 1
        if self.config.include_ref_root_offset:
            n += 2
        if self.config.include_link_obs:
            n += 7 * self.model.nbody
        return n

    @property
    def action_size(self) -> int:
        return self.model.nu

    # -- helpers ----------------------------------------------------------
    def _obs(self, data) -> torch.Tensor:
        c = self.config
        parts = [data.qpos[:, 2:] if c.exclude_root_xy else data.qpos, data.qvel]
        if c.include_phase:
            parts.append(phase(self.clip, data.time)[:, None])
        if c.include_ref_root_offset or c.include_link_obs:
            w, x, y, z = data.qpos[:, 3:7].unbind(-1)
            yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
            cy, sy = torch.cos(yaw), torch.sin(yaw)
        if c.include_ref_root_offset:
            q_ref, _ = reference_state(self.clip, data.time)
            d = q_ref[:, :2] - data.qpos[:, :2]
            parts.append(torch.stack([cy * d[:, 0] + sy * d[:, 1],
                                      -sy * d[:, 0] + cy * d[:, 1]], dim=1))
        if c.include_link_obs:
            rel = data.xpos - data.qpos[:, None, :3]
            rx = cy[:, None] * rel[..., 0] + sy[:, None] * rel[..., 1]
            ry = -sy[:, None] * rel[..., 0] + cy[:, None] * rel[..., 1]
            h = 0.5 * yaw
            zero = torch.zeros_like(h)
            qh_inv = torch.stack([torch.cos(h), zero, zero, -torch.sin(h)], dim=1)
            qrel = quat.mul(qh_inv[:, None, :], data.xquat)
            parts.append(torch.cat([rx, ry, rel[..., 2], qrel.reshape(qrel.shape[0], -1)],
                                   dim=1))
        return torch.cat(parts, dim=1)

    def _target(self, data, action) -> torch.Tensor:
        c = self.config
        if c.action_mode == "residual":
            ref_q, _ = reference_state(self.clip, data.time + (c.policy_dt + c.ref_target_lead))
            target = ref_q[:, self._qposadr] + action
        elif c.action_mode in ("absolute", "torque"):
            target = action
        else:
            raise ValueError(f"unknown action_mode {c.action_mode!r}")
        if not c.enforce_joint_limits:
            return target
        return torch.minimum(torch.maximum(target, self._act_lo), self._act_hi)

    def _torque_fn(self, target, explicit_only: bool = False):
        """The qfrc callback evaluated inside each substep. ``explicit_only``
        gives a plain torque even for implicit PD: the held-torque path
        evaluates one torque from the pre-step state and holds it."""
        c = self.config

        def qfrc(model, data):
            if c.controller == "implicit_pd" and not explicit_only:
                # an actuator mask folds into the gains: zero kp and kd give
                # zero explicit torque and zero implicit diagonal
                return ctrl.implicit_pd(model, data, target, self._masked_gains,
                                        clamp_scale=c.torque_limit_scale)
            if c.controller == "standard_pd":
                tau = ctrl.standard_pd(model, data, target, self.gains)
            elif c.controller == "inverse_dynamics_pd":
                tau = ctrl.inverse_dynamics_pd(model, data, target, self.gains)
            else:  # stable_pd, or implicit_pd in explicit (held) form
                tau = ctrl.stable_pd(model, data, target, self.gains)
            tau = ctrl.clamp_torque(model, tau, c.torque_limit_scale)
            if self.actuator_mask is not None:
                tau = ctrl.masked_torque(tau, self.actuator_mask)
            return ctrl.torque_to_qfrc(model, tau)

        return qfrc

    def _reward(self, data, fall):
        c = self.config
        qpos_ref, qvel_ref = reference_state(self.clip, data.time)
        ee_ref, com_ref = reference_aux(self.clip, data.time)
        joint_err = task.joint_pose_errors(self.model, data.qpos, qpos_ref)
        _, root_rot_err = task.root_pose_error(data.qpos, qpos_ref)
        r_pose = torch.exp(-c.s_pose * (torch.sum(joint_err ** 2, dim=1) + root_rot_err ** 2))
        r_vel = torch.exp(-c.s_vel * torch.sum((data.qvel - qvel_ref) ** 2, dim=1))
        ee = task.ee_positions(self.model, data)
        r_ee = torch.exp(-c.s_ee * torch.sum((ee - ee_ref) ** 2, dim=(1, 2))
                         / len(task.EE_SPECS))
        com = task.center_of_mass(self.model, data)
        r_com = torch.exp(-c.s_com * torch.sum((com - com_ref) ** 2, dim=1))
        reward = c.w_pose * r_pose + c.w_vel * r_vel + c.w_ee * r_ee + c.w_com * r_com
        if c.aerial_window:
            lo, hi = c.aerial_window
            ph = phase(self.clip, data.time)
            edge = max(c.aerial_edge, 1e-6)
            win = (torch.clamp((ph - lo) / edge, 0.0, 1.0)
                   * torch.clamp((hi - ph) / edge, 0.0, 1.0))
            r_root = torch.exp(-c.aerial_s_root * root_rot_err ** 2)
            dw = data.qvel[:, 3:6] - qvel_ref[:, 3:6]
            r_angvel = torch.exp(-c.aerial_s_angvel * torch.sum(dw ** 2, dim=1))
            aerial = (c.aerial_w_pose * r_pose + c.aerial_w_root * r_root
                      + c.aerial_w_angvel * r_angvel + c.aerial_w_com * r_com)
            reward = (1.0 - win) * reward + win * aerial
        if c.drift_w > 0:
            dxy = data.qpos[:, :2] - qpos_ref[:, :2]
            r_drift = torch.exp(-c.drift_s * torch.sum(dxy ** 2, dim=1))
            reward = (1.0 - c.drift_w) * reward + c.drift_w * r_drift
        if c.early_termination:
            reward = torch.where(fall, 0.0, reward)
        terms = {"reward_pose": r_pose, "reward_vel": r_vel, "reward_ee": r_ee,
                 "reward_com": r_com, "pose_error": torch.mean(joint_err, dim=1),
                 "root_err": root_rot_err}
        return reward, terms

    # -- protocol ---------------------------------------------------------
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
              t0: Optional[torch.Tensor] = None) -> State:
        """Reset ``num_envs`` envs: start times from ``t0`` when given, else
        RSI draws of ``generator``; reset noise from ``generator``."""
        c = self.config
        B, dev = num_envs, self.device

        def draw(fn, *shape):
            gdev = generator.device if generator is not None else dev
            return fn(*shape, generator=generator, device=gdev).to(dev)

        if t0 is None:
            if c.reference_state_init:
                hi = self.clip.cycle_time if self.clip.loop else 0.9 * self.clip.cycle_time
                u = draw(torch.rand, B)
                if c.rsi_phase_bias > 0:
                    u = u ** (1.0 / (1.0 + c.rsi_phase_bias))
                elif c.rsi_phase_bias < 0:
                    u = u ** (1.0 - c.rsi_phase_bias)
                t0 = hi * u
            else:
                t0 = torch.zeros(B, device=dev)
        t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
        qpos, qvel = reference_state(self.clip, t0)
        if c.rsi_noise_qpos > 0 or c.rsi_noise_qvel > 0:
            nq = draw(torch.randn, B, self.model.nq - 7)
            nv = draw(torch.randn, B, self.model.nv)
            qpos = torch.cat([qpos[:, :7], qpos[:, 7:] + c.rsi_noise_qpos * nq], dim=1)
            qvel = qvel + c.rsi_noise_qvel * nv
        if c.rsi_noise_root_xy > 0:
            nxy = 2.0 * draw(torch.rand, B, 2) - 1.0
            qpos = torch.cat([qpos[:, :2] + c.rsi_noise_root_xy * nxy, qpos[:, 2:]], dim=1)
        data = run_kinematics(self.model, make_data(self.model, qpos=qpos, qvel=qvel)
                              .replace(time=t0))
        _, terms = self._reward(data, torch.zeros(B, dtype=torch.bool, device=dev))
        metrics = {"step_index": reference_frame_index(self.clip, t0).to(torch.float32),
                   "fall": torch.zeros(B, device=dev), **terms}
        zeros = torch.zeros(B, device=dev)
        return State(pipeline=data, obs=self._obs(data), reward=zeros, done=zeros,
                     metrics=metrics, info={"episode_start": t0})

    def step(self, state: State, action: torch.Tensor) -> State:
        c = self.config
        data = state.pipeline
        if c.action_mode == "torque":
            tau = ctrl.clamp_torque(self.model, action, c.torque_limit_scale)
            if self.actuator_mask is not None:
                tau = ctrl.masked_torque(tau, self.actuator_mask)
            qfrc = ctrl.torque_to_qfrc(self.model, tau)
            qfrc_fn = lambda model, d: qfrc
        else:
            target = self._target(data, action)
            qfrc_fn = self._torque_fn(target)
        n = c.n_substeps
        if c.action_mode == "torque" or c.pd_per_substep:
            data = step_n(self.model, data, n, qfrc_fn=qfrc_fn)
        else:
            # one torque per policy step from the pre-step state, held
            d0 = forward_smooth(self.model, data)
            held = self._torque_fn(target, explicit_only=True)(self.model, d0)
            data = step_n(self.model, data, n, qfrc_fn=lambda model, d: held)
        data = run_kinematics(self.model, data)

        fall = task.detect_fall(self.model, data, self._fall_mask)
        reward, terms = self._reward(data, fall)
        t_in_episode = data.time - state.info["episode_start"]
        done = torch.zeros_like(reward)
        if c.early_termination:
            done = torch.maximum(done, fall.to(done.dtype))
        if c.pose_termination > 0:
            thr = torch.full_like(reward, c.pose_termination)
            if c.pose_termination_after_cycle > 0:
                thr = torch.where(t_in_episode >= self.clip.cycle_time,
                                  c.pose_termination_after_cycle, thr)
            off_pose = terms["root_err"] > thr
            reward = torch.where(off_pose, 0.0, reward)
            done = torch.maximum(done, off_pose.to(done.dtype))
        done = torch.maximum(done, (t_in_episode >= c.max_episode_time).to(done.dtype))
        if not self.clip.loop:
            done = torch.maximum(done, (data.time >= self.clip.cycle_time).to(done.dtype))
        metrics = {"step_index": reference_frame_index(self.clip, data.time).to(torch.float32),
                   "fall": fall.to(torch.float32), **terms}
        return state.replace(pipeline=data, obs=self._obs(data), reward=reward, done=done,
                             metrics=metrics)

"""One DeepMimic env step in plain PyTorch, from a given batch of states.

The semantics of ``MimicVecEnv.step`` with the kernel backend (implicit PD
re-solved every substep): the PD targets from the action, the policy step
(the plain field program: the entry substep solves the held self-contact
masses, the others reuse them, then the final-pose FK), the NaN
quarantine, the observation, the 4-term reward with the recipe's aerial
and drift shaping, and early, pose, episode-time and clip-end termination.
The env configuration is the dict of the configuration file; the model,
gains and clip are rebuilt here from the repository's files.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import field_physics as fp
from benchmark.reference import quaternion as quat
from benchmark.reference.builders import humanoid_model
from benchmark.reference.clip import load_clip, phase, reference_aux, reference_state
from benchmark.reference.skeleton import DOF, MODEL_JOINT_ORDER, generate_kp_kd_gains

EE_SPECS = (
    ("right_elbow", (0.0, 0.0, -0.258947)),
    ("left_elbow", (0.0, 0.0, -0.258947)),
    ("right_ankle", (0.045, 0.0, -0.0225)),
    ("left_ankle", (0.045, 0.0, -0.0225)),
)


def plain_step(spec, qpos, qvel, u):
    """(qpos', qvel', xpos (B, nbody, 3), xquat (B, nbody, 4), fall (B,))."""
    B = qpos.shape[0]
    q = list(qpos.t().contiguous().to(torch.float32).unbind(0))
    v = list(qvel.t().contiguous().to(torch.float32).unbind(0))
    target = list(u.t().contiguous().to(torch.float32).unbind(0))
    q, v, fall, held = fp.substep(spec, q, v, target)
    held = held or None
    for _ in range(1, spec.n_substeps):
        q, v, f, _ = fp.substep(spec, q, v, target, held_self=held)
        fall = torch.maximum(fall, f)
    xpos, xquat = fp.fk_outputs(spec, q)
    return (torch.stack(q, 1), torch.stack(v, 1),
            torch.stack([torch.stack(p, 1) for p in xpos], 1).reshape(B, spec.nbody, 3),
            torch.stack([torch.stack(r, 1) for r in xquat], 1).reshape(B, spec.nbody, 4),
            fall)


class RefEnv:
    """The env of one configuration's ``env_config`` dict, on ``device``."""

    def __init__(self, clip_name: str, c: dict, device):
        self.c = c
        self.device = torch.device(device)
        self.n_substeps = max(1, round(c["policy_dt"] / c["physics_dt"]))
        model = humanoid_model()
        model = model.replace(option=model.option.replace(
            timestep=np.asarray(c["physics_dt"], np.float32),
            self_contact_mass=c["self_contact_mass"]))
        if c["contact_tc_scale"] != 1.0 or c["friction_scale"] != 1.0:
            opt = model.option
            model = model.replace(
                option=opt.replace(contact_timeconst=np.asarray(
                    opt.contact_timeconst * c["contact_tc_scale"], np.float32)),
                geom_friction=np.asarray(model.geom_friction * c["friction_scale"], np.float32))
        if not c["enforce_joint_limits"]:
            model = model.replace(jnt_limited=tuple(False for _ in model.jnt_limited))
        self.model = model
        kp, kd = generate_kp_kd_gains()
        kp = np.asarray(kp, np.float32) * np.float32(c["kp_scale"])
        kd = np.asarray(kd, np.float32) * np.float32(c["kd_scale"])
        self.spec = fp.build_spec(
            model, kp=kp, kd=kd, n_substeps=self.n_substeps, mode="pd",
            fall_allowed_bodies=tuple(c["fall_contact_bodies"]) or ("right_ankle", "left_ankle"),
            torque_scale=c["torque_limit_scale"])
        dev = self.device
        self._ee_ids = [model.body_id(n) for n, _ in EE_SPECS]
        self._ee_off = torch.tensor([o for _, o in EE_SPECS], dtype=torch.float32, device=dev)
        self._mass = torch.as_tensor(np.asarray(model.body_mass, np.float32), device=dev)
        self._ipos = torch.as_tensor(np.asarray(model.body_ipos, np.float32), device=dev)
        clip = load_clip(clip_name, device=dev)
        xpos, xquat = self._fk(clip.qpos)
        self.clip = clip.replace(ee_pos=self._ee(xpos, xquat), com=self._com(xpos, xquat))
        self._slices = []
        for name in MODEL_JOINT_ORDER:
            j = model.joint_id(name if DOF[name] == 1 else f"{name}_x")
            self._slices.append((int(model.jnt_qposadr[j]), DOF[name]))
        self._qposadr = torch.as_tensor(np.asarray(model.actuator_qposadr), device=dev)
        rng = np.asarray(model.jnt_range)[list(model.actuator_jntid())]
        self._lo = torch.as_tensor(rng[:, 0].astype(np.float32), device=dev)
        self._hi = torch.as_tensor(rng[:, 1].astype(np.float32), device=dev)

    def _fk(self, qpos):
        B, nb = qpos.shape[0], self.spec.nbody
        xpos, xquat = fp.fk_outputs(self.spec, list(qpos.t().contiguous().unbind(0)))
        return (torch.stack([torch.stack(p, 1) for p in xpos], 1).reshape(B, nb, 3),
                torch.stack([torch.stack(r, 1) for r in xquat], 1).reshape(B, nb, 4))

    def _ee(self, xpos, xquat):
        ids = self._ee_ids
        return xpos[:, ids] + quat.rotate(xquat[:, ids], self._ee_off)

    def _com(self, xpos, xquat):
        xipos = xpos + quat.rotate(xquat, self._ipos)
        return torch.einsum("b,nbx->nx", self._mass, xipos) / torch.sum(self._mass)

    def start(self, t, low: bool = False):
        """(qpos, qvel) of a clean reset at clip times ``t``; with ``low``,
        looked up in bfloat16 (the control of this float32 stage)."""
        if not low:
            return reference_state(self.clip, t)
        c = self.clip
        clip = c.replace(qpos=c.qpos.bfloat16(), qvel=c.qvel.bfloat16(), dt=c.dt.bfloat16(),
                         cycle_time=c.cycle_time.bfloat16(),
                         cycle_offset=c.cycle_offset.bfloat16())
        q, v = reference_state(clip, t.bfloat16())
        return q.float(), v.float()

    def obs(self, qpos, qvel, t):
        c = self.c
        parts = [qpos[:, 2:] if c["exclude_root_xy"] else qpos, qvel]
        if c["include_phase"]:
            parts.append(phase(self.clip, t)[:, None])
        if c["include_ref_root_offset"]:
            w, x, y, z = qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6]
            yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
            cy, sy = torch.cos(yaw), torch.sin(yaw)
            q_ref, _ = reference_state(self.clip, t)
            d = q_ref[:, :2] - qpos[:, :2]
            parts.append(torch.stack([cy * d[:, 0] + sy * d[:, 1],
                                      -sy * d[:, 0] + cy * d[:, 1]], dim=1))
        if c["include_link_obs"]:
            raise NotImplementedError("link observations are not in the reference")
        return torch.cat(parts, dim=1)

    def target(self, qpos, t, action):
        c = self.c
        if c["action_mode"] == "residual":
            q_ref, _ = reference_state(self.clip, t + (c["policy_dt"] + c["ref_target_lead"]))
            action = q_ref[:, self._qposadr] + action
        elif c["action_mode"] != "absolute":
            raise NotImplementedError(f"action_mode {c['action_mode']!r}")
        if not c["enforce_joint_limits"]:
            return action
        return torch.minimum(torch.maximum(action, self._lo[None]), self._hi[None])

    def reward(self, qpos, qvel, t, xpos, xquat, fall):
        c = self.c
        q_ref, v_ref = reference_state(self.clip, t)
        ee_ref, com_ref = reference_aux(self.clip, t)
        errs = []
        for qadr, dof in self._slices:
            if dof == 1:
                errs.append(torch.abs(qpos[:, qadr] - q_ref[:, qadr]))
            else:
                errs.append(quat.angle_between(quat.from_euler_rxyz(qpos[:, qadr:qadr + 3]),
                                               quat.from_euler_rxyz(q_ref[:, qadr:qadr + 3])))
        joint_err = torch.stack(errs, dim=1)
        root_rot = quat.angle_between(quat.normalize(qpos[:, 3:7]), quat.normalize(q_ref[:, 3:7]))
        r_pose = torch.exp(-c["s_pose"] * (torch.sum(joint_err ** 2, dim=1) + root_rot ** 2))
        r_vel = torch.exp(-c["s_vel"] * torch.sum((qvel - v_ref) ** 2, dim=1))
        r_ee = torch.exp(-c["s_ee"] * torch.sum((self._ee(xpos, xquat) - ee_ref) ** 2, dim=(1, 2))
                         / len(EE_SPECS))
        r_com = torch.exp(-c["s_com"] * torch.sum((self._com(xpos, xquat) - com_ref) ** 2, dim=1))
        reward = c["w_pose"] * r_pose + c["w_vel"] * r_vel + c["w_ee"] * r_ee + c["w_com"] * r_com
        if c["aerial_window"]:
            lo, hi = c["aerial_window"]
            ph = phase(self.clip, t)
            edge = max(c["aerial_edge"], 1e-6)
            win = torch.clamp((ph - lo) / edge, 0.0, 1.0) * torch.clamp((hi - ph) / edge, 0.0, 1.0)
            r_root = torch.exp(-c["aerial_s_root"] * root_rot ** 2)
            dw = qvel[:, 3:6] - v_ref[:, 3:6]
            r_angvel = torch.exp(-c["aerial_s_angvel"] * torch.sum(dw ** 2, dim=1))
            aerial = (c["aerial_w_pose"] * r_pose + c["aerial_w_root"] * r_root
                      + c["aerial_w_angvel"] * r_angvel + c["aerial_w_com"] * r_com)
            reward = (1.0 - win) * reward + win * aerial
        if c["drift_w"] > 0:
            dxy = qpos[:, :2] - q_ref[:, :2]
            r_drift = torch.exp(-c["drift_s"] * torch.sum(dxy ** 2, dim=1))
            reward = (1.0 - c["drift_w"]) * reward + c["drift_w"] * r_drift
        if c["early_termination"]:
            reward = torch.where(fall > 0, 0.0, reward)
        terms = {"reward_pose": r_pose, "reward_vel": r_vel, "reward_ee": r_ee,
                 "reward_com": r_com, "root_err": root_rot}
        return reward, terms

    def step(self, qpos, qvel, time, episode_start, action):
        """One policy step of each row; a dict of (B, ...) outputs."""
        c = self.c
        q, v, xpos, xquat, fall = plain_step(self.spec, qpos, qvel, self.target(qpos, time, action))
        t = time + self.n_substeps * c["physics_dt"]
        bad = ~(torch.isfinite(q).all(dim=1) & torch.isfinite(v).all(dim=1))
        q = torch.where(bad[:, None], torch.nan_to_num(q), q)
        v = torch.where(bad[:, None], torch.nan_to_num(v), v)
        xpos = torch.nan_to_num(xpos)
        xquat = torch.where(torch.isfinite(xquat), xquat, 1.0)
        fall = torch.maximum(fall, bad.to(fall.dtype))
        obs = self.obs(q, v, t)
        reward, terms = self.reward(q, v, t, xpos, xquat, fall)
        reward = torch.where(bad, 0.0, torch.nan_to_num(reward))
        done = fall.clone() if c["early_termination"] else torch.zeros_like(fall)
        if c["pose_termination"] > 0:
            thr = torch.full_like(t, c["pose_termination"])
            if c["pose_termination_after_cycle"] > 0:
                survived = t - episode_start >= self.clip.cycle_time
                thr = torch.where(survived, c["pose_termination_after_cycle"], thr)
            off = terms["root_err"] > thr
            reward = torch.where(off, 0.0, reward)
            done = torch.maximum(done, off.to(done.dtype))
        done = torch.maximum(done, (t - episode_start >= c["max_episode_time"]).to(done.dtype))
        if not self.clip.loop:
            done = torch.maximum(done, (t >= self.clip.cycle_time).to(done.dtype))
        return {"qpos": q, "qvel": v, "obs": obs, "reward": reward, "done": done,
                "fall": fall, **terms}

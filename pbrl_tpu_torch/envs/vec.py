"""Vectorized mimic environment: batch-first step over the policy-step kernel.

Counterpart of ``pbrl_tpu/envs/vec.py::MimicVecEnv``. With the kernel
backend (``backend="kernel"``, or ``"auto"``) the whole env batch advances
through ONE call of the policy-step wrapper per policy step
(:mod:`pbrl_tpu_torch.ops.mimic_kernel`: the CUDA kernel for tensors on
the card, its plain version for tensors on the CPU). ``backend="xla"``
keeps pbrl_tpu's name, so flags and run configs carry over; here it means
the einsum engine (:mod:`pbrl_tpu_torch.engine`) in plain PyTorch on the
env's device, with every controller. The reference lookup, reward terms,
termination and observation assembly are plain PyTorch on the same device.

Held-torque PD (``pd_per_substep=False``, the reference's once-per-policy-
step PD): ``_held_tau`` evaluates one Stable-PD torque per env from the
pre-step state on the engine (``forward_smooth``, one ``(M + dt KD)``
solve, clamp, mask), and the kernel runs in its ``torque`` mode. As in
pbrl_tpu, the kernel backend implements implicit and Stable PD only, and
held PD the Stable-PD law only; other combinations raise ``ValueError``.

Data parallelism: an env built on a :class:`~pbrl_tpu_torch.parallel.Mesh`
of ``n`` ranks holds this rank's rows of the batch. ``reset`` takes the
whole batch's size; every random draw (RSI times, reset noise, the
curriculum's draws) is made for the whole batch from the generator, which
every rank seeds alike, and each rank keeps its own rows, so the ranks
together draw what one process draws for the whole batch. The curriculum's
peer is drawn among the alive envs of all ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pbrl_tpu_torch.control import Gains, default_gains
from pbrl_tpu_torch.control import pd as ctrl
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.forward import forward_smooth
from pbrl_tpu_torch.engine.forward import step as engine_step
from pbrl_tpu_torch.engine.kinematics import kinematics as run_kinematics
from pbrl_tpu_torch.envs import humanoid_task as task
from pbrl_tpu_torch.envs.base import EnvConfig, VecState
from pbrl_tpu_torch.envs.mimic import env_model, gains_on, scaled_gains
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.mocap.clip import (MotionClip, phase, reference_aux,
                                       reference_frame_index, reference_state)
from pbrl_tpu_torch.model.spec import Model
from pbrl_tpu_torch.ops.mimic_kernel import build_mimic_step, captured_launches
from pbrl_tpu_torch.parallel.mesh import SINGLE, Mesh
from pbrl_tpu_torch.utils.profiling import count, trace_annotation

BACKENDS = ("auto", "kernel", "xla")


def _to(clip: MotionClip, device) -> MotionClip:
    move = {k: getattr(clip, k).to(device) for k in
            ("qpos", "qvel", "dt", "cycle_time", "cycle_offset", "ee_pos", "com")
            if getattr(clip, k) is not None}
    return clip.replace(**move)


# A packed block's segments start on the caching allocator's 512-byte
# boundary: a kernel meets a view of the block with the alignment, and so
# takes the vectorised path, that it meets in a tensor of its own.
_ALIGN = 128  # float32 words


def _layout(shapes):
    """Each shape's (offset, size) in a packed float32 block, and the
    block's size."""
    spans, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        spans.append((at, n))
        at += -(-n // _ALIGN) * _ALIGN
    return spans, at


def _fillers(layout, size, device):
    """For each segment, an unset tensor of the words between it and the
    next one, or None where it ends on the boundary."""
    ends = [at for at, _ in layout[1:]] + [size]
    return [torch.empty(end - at - n, device=device) if end > at + n else None
            for (at, n), end in zip(layout, ends)]


def _pack(tensors, fillers, out=None):
    """``tensors`` in one packed block (``out`` when given) by one ``cat``."""
    parts = []
    for x, fill in zip(tensors, fillers):
        parts += [x.reshape(-1)] if fill is None else [x.reshape(-1), fill]
    return torch.cat(parts, out=out)


def _unpack(block, layout, shapes):
    return [block[at:at + n].view(shape) for (at, n), shape in zip(layout, shapes)]


class _StepGraph:
    """:meth:`MimicVecEnv._advance` captured as one CUDA graph for one shape
    of inputs. A replay copies the inputs into the graph's packed input block
    (one ``cat``), replays, and clones its packed output block (one copy);
    the outputs are views of that clone, so no tensor a caller holds is ever
    written again. Each kernel launch the graph holds is added to its
    wrapper's ``launches`` at every replay."""

    def __init__(self, env: "MimicVecEnv", inputs):
        dev = inputs[0].device
        shapes = [x.shape for x in inputs]
        self._in_layout, size = _layout(shapes)
        self._in = torch.zeros(size, device=dev)
        self._in_fill = _fillers(self._in_layout, size, dev)
        static = _unpack(self._in, self._in_layout, shapes)
        # Captured on a side stream (the default one cannot capture), with
        # no synchronize of the device (``torch.cuda.graph`` makes one).
        self._graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), captured_launches() as launched, torch.cuda.stream(side):
            self._graph.capture_begin()
            try:
                out, metrics = env._advance(*static)
                out["bad"] = out["bad"].to(torch.float32)
                outs = list(out.values()) + list(metrics.values())  # all float32
                self._shapes = [x.shape for x in outs]
                self._out_layout, size = _layout(self._shapes)
                self._out = _pack(outs, _fillers(self._out_layout, size, dev))
            finally:
                self._graph.capture_end()
        self._launched = launched
        self._names, self._metric_names = list(out), list(metrics)

    def replay(self, state: VecState, action: torch.Tensor) -> VecState:
        _pack((state.qpos, state.qvel, state.time, state.episode_start, action),
              self._in_fill, out=self._in)
        self._graph.replay()
        for kstep in self._launched:
            kstep.launches += 1
        views = _unpack(self._out.clone(), self._out_layout, self._shapes)
        n = len(self._names)
        out = dict(zip(self._names, views[:n]))
        count("vec/quarantined", out.pop("bad"))
        return state.replace(**out, metrics=dict(zip(self._metric_names, views[n:])))


class MimicVecEnv:
    """Batch-first DeepMimic imitation env over the policy-step kernel or
    the engine."""

    is_vectorized = True

    def __init__(
        self,
        model: Model,
        clip: MotionClip,
        config: EnvConfig = EnvConfig(),
        gains: Optional[Gains] = None,
        backend: str = "auto",
        actuator_mask=None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        backend = "kernel" if backend == "auto" else backend
        mode = "torque" if config.action_mode == "torque" else "pd"
        self._held_pd = mode == "pd" and not config.pd_per_substep
        if self._held_pd and config.controller not in ("implicit_pd", "stable_pd"):
            raise ValueError("pd_per_substep=False implements the Stable-PD law; use "
                             f"pd_per_substep=True for {config.controller!r}")
        if backend == "kernel" and config.controller not in ("implicit_pd", "stable_pd"):
            raise ValueError(f"the kernel backend implements implicit/Stable PD; use "
                             f"backend='xla' for {config.controller!r}")
        self.backend = backend
        self._mode = mode
        self.device = torch.device(device)
        self.mesh = mesh or SINGLE
        model = env_model(model, config)
        self.model = model
        self.config = config
        clip = _to(clip, self.device)
        self.clip = clip if clip.ee_pos is not None else task.augment_clip(model, clip)
        gains = scaled_gains(gains or default_gains(), config)
        self.gains = gains
        dev = self.device
        kp, kd = gains.kp, gains.kd
        self._mask = None
        if actuator_mask is not None:
            # For the implicit-PD law the mask folds into the gains: zero kp
            # and kd give zero explicit torque and zero implicit diagonal.
            mk = np.asarray(actuator_mask).astype(np.float32)
            kp, kd = kp * mk, kd * mk
            self._mask = torch.as_tensor(mk, device=dev)
        self._gains_t = gains_on(gains, dev)
        self._masked_gains_t = gains_on(Gains(kp, kd), dev)
        allowed = config.fall_contact_bodies or ("right_ankle", "left_ankle")
        if backend == "kernel":
            self._kstep, self._kspec = build_mimic_step(
                model, kp=kp, kd=kd, n_substeps=config.n_substeps,
                mode="torque" if self._held_pd else mode, fall_allowed_bodies=allowed,
                torque_scale=config.torque_limit_scale)
        else:
            self._fall_mask = torch.as_tensor(task.fall_mask(model, allowed), device=dev)

        self._graphs = {}  # input shapes -> (owner, _StepGraph or None): see step
        self._qposadr = torch.as_tensor(model.actuator_qposadr, device=dev)
        rng = model.jnt_range[list(model.actuator_jntid())]  # (nu, 2) actuator order
        self._act_lo = torch.as_tensor(rng[:, 0], device=dev)
        self._act_hi = torch.as_tensor(rng[:, 1], device=dev)

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def _fk_batch(self, qpos, qvel):
        """Body frames by the engine's kinematics (a reset state; a step
        reuses the physics' final-pose frames)."""
        d = run_kinematics(self.model, make_data(self.model, qpos=qpos, qvel=qvel))
        return d.xpos, d.xquat

    def _obs(self, qpos, qvel, t, xpos=None, xquat=None):
        """The observation; the link terms take the step's body frames, or
        the engine's kinematics when none are given (a reset state)."""
        c = self.config
        parts = [qpos[:, 2:] if c.exclude_root_xy else qpos, qvel]
        if c.include_phase:
            parts.append(phase(self.clip, t)[:, None])
        if c.include_ref_root_offset or c.include_link_obs:
            w, x, y, z = qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6]
            yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
            cy, sy = torch.cos(yaw), torch.sin(yaw)
        if c.include_ref_root_offset:
            # the reference's root xy in the root heading (yaw) frame
            q_ref, _ = reference_state(self.clip, t)
            d = q_ref[:, :2] - qpos[:, :2]
            parts.append(torch.stack([cy * d[:, 0] + sy * d[:, 1],
                                      -sy * d[:, 0] + cy * d[:, 1]], dim=1))
        if c.include_link_obs:
            if xpos is None:
                xpos, xquat = self._fk_batch(qpos, qvel)
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

    def _reward_batch(self, qpos, qvel, t, xpos, xquat, fall):
        c = self.config
        q_ref, v_ref = reference_state(self.clip, t)
        ee_ref, com_ref = reference_aux(self.clip, t)

        joint_err = task.joint_pose_errors(self.model, qpos, q_ref)  # (B, 12)
        root_rot = quat.angle_between(quat.normalize(qpos[:, 3:7]),
                                      quat.normalize(q_ref[:, 3:7]))
        pose_sq = torch.sum(joint_err ** 2, dim=1) + root_rot ** 2
        r_pose = torch.exp(-c.s_pose * pose_sq)
        r_vel = torch.exp(-c.s_vel * torch.sum((qvel - v_ref) ** 2, dim=1))
        ee = task.ee_positions(self.model, xpos, xquat)
        r_ee = torch.exp(-c.s_ee * torch.sum((ee - ee_ref) ** 2, dim=(1, 2))
                         / len(task.EE_SPECS))
        com = task.center_of_mass(self.model, xpos, xquat)
        r_com = torch.exp(-c.s_com * torch.sum((com - com_ref) ** 2, dim=1))

        reward = c.w_pose * r_pose + c.w_vel * r_vel + c.w_ee * r_ee + c.w_com * r_com
        if c.aerial_window:
            # flight phase: blend toward a root-rotation and root-angular-
            # velocity reward inside the window
            lo, hi = c.aerial_window
            ph = phase(self.clip, t)
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

    def _target(self, qpos, t, action):
        c = self.config
        if c.action_mode == "residual":
            q_ref, _ = reference_state(self.clip, t + (c.policy_dt + c.ref_target_lead))
            action = q_ref[:, self._qposadr] + action
        if not c.enforce_joint_limits:
            return action
        return torch.minimum(torch.maximum(action, self._act_lo[None]), self._act_hi[None])

    # ------------------------------------------------------------------
    def _held_tau(self, qpos, qvel, target):
        """One Stable-PD torque per env from the pre-step state (the
        reference's per-policy-step PD): ``forward_smooth`` on the batch, one
        ``(M + dt KD)`` solve per env, the torque envelope, the mask."""
        m = self.model
        d = forward_smooth(m, make_data(m, qpos=qpos, qvel=qvel))
        tau = ctrl.clamp_torque(m, ctrl.stable_pd(m, d, target, self._gains_t),
                                self.config.torque_limit_scale)
        if self._mask is not None:
            tau = ctrl.masked_torque(tau, self._mask)
        return tau

    def _engine_qfrc_fn(self, u):
        """The per-substep controller of the engine backend for the step's
        targets (or torques) ``u``."""
        c = self.config
        if self._mode == "pd" and not self._held_pd:
            if c.controller in ("implicit_pd", "stable_pd"):
                return lambda mm, dd: ctrl.implicit_pd(
                    mm, dd, u, self._masked_gains_t, clamp_scale=c.torque_limit_scale)
            law = (ctrl.standard_pd if c.controller == "standard_pd"
                   else ctrl.inverse_dynamics_pd)

            def qfrc_fn(mm, dd):
                tau = ctrl.clamp_torque(mm, law(mm, dd, u, self._gains_t),
                                        c.torque_limit_scale)
                if self._mask is not None:
                    tau = ctrl.masked_torque(tau, self._mask)
                return ctrl.torque_to_qfrc(mm, tau)

            return qfrc_fn
        tau = ctrl.clamp_torque(self.model, u, c.torque_limit_scale)
        if self._mask is not None:
            tau = ctrl.masked_torque(tau, self._mask)
        qfrc = ctrl.torque_to_qfrc(self.model, tau)
        return lambda mm, dd: qfrc

    def _physics(self, qpos, qvel, u):
        """(qpos', qvel', xpos, xquat, fall) of one policy step through the
        kernel or the engine."""
        if self._held_pd:
            u = self._held_tau(qpos, qvel, u)
        if self.backend == "kernel":
            return self._kstep(qpos, qvel, u.to(torch.float32).contiguous())
        m = self.model
        qfrc_fn = self._engine_qfrc_fn(u)
        d = make_data(m, qpos=qpos, qvel=qvel)
        step_mode = m.option.self_contact_mass == "step" and d.contact.dist.shape[1] > 0
        held, fall = None, None
        for i in range(self.config.n_substeps):
            if step_mode:
                # the entry substep's own solve gives the held self-contact masses
                d, masses = engine_step(m, d, qfrc_fn=qfrc_fn, held_self=held,
                                        use_held=i > 0, return_self_masses=True)
                held = masses if i == 0 else held
            else:
                d = engine_step(m, d, qfrc_fn=qfrc_fn)
            f = task.detect_fall(m, d, self._fall_mask).to(torch.float32)
            fall = f if fall is None else torch.maximum(fall, f)
        d = run_kinematics(m, d)
        return d.qpos, d.qvel, d.xpos, d.xquat, fall

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
              t0: Optional[torch.Tensor] = None) -> VecState:
        """Reset a batch of ``num_envs`` envs (this rank's rows of it). Start
        times come from ``t0`` (num_envs,) when given (shared with another
        implementation in tests), else from RSI draws of ``generator``;
        reset noise is drawn from ``generator``."""
        c = self.config
        mesh = self.mesh
        B = mesh.local(num_envs)
        dev = self.device

        def draw(fn, *shape):  # the whole batch's draw; this rank's rows of it
            gdev = generator.device if generator is not None else dev
            return mesh.rows(fn(num_envs, *shape, generator=generator, device=gdev)).to(dev)

        if t0 is None:
            if c.reference_state_init:
                hi = self.clip.cycle_time if self.clip.loop else 0.9 * self.clip.cycle_time
                u = draw(torch.rand)
                if c.rsi_phase_bias > 0:
                    u = u ** (1.0 / (1.0 + c.rsi_phase_bias))
                elif c.rsi_phase_bias < 0:
                    u = u ** (1.0 - c.rsi_phase_bias)
                t0 = hi * u
            else:
                t0 = torch.zeros(B, device=dev)
        else:
            t0 = mesh.rows(torch.as_tensor(t0, dtype=torch.float32, device=dev))
        qpos, qvel = reference_state(self.clip, t0)
        if c.rsi_noise_qpos > 0 or c.rsi_noise_qvel > 0:
            nq = draw(torch.randn, self.model.nq - 7)
            nv = draw(torch.randn, self.model.nv)
            qpos = torch.cat([qpos[:, :7], qpos[:, 7:] + c.rsi_noise_qpos * nq], dim=1)
            qvel = qvel + c.rsi_noise_qvel * nv
        if c.rsi_noise_root_xy > 0:
            nxy = 2.0 * draw(torch.rand, 2) - 1.0
            qpos = torch.cat([qpos[:, :2] + c.rsi_noise_root_xy * nxy, qpos[:, 2:]], dim=1)
        qpos, qvel = qpos.contiguous(), qvel.contiguous()
        zeros = torch.zeros(B, device=dev)
        metrics = {
            "step_index": reference_frame_index(self.clip, t0).to(torch.float32),
            "fall": zeros, "reward_pose": zeros, "reward_vel": zeros,
            "reward_ee": zeros, "reward_com": zeros, "pose_error": zeros,
            "root_err": zeros,
        }
        return VecState(qpos=qpos, qvel=qvel, time=t0, episode_start=t0,
                        obs=self._obs(qpos, qvel, t0), reward=zeros, done=zeros,
                        metrics=metrics)

    def step(self, state: VecState, action: torch.Tensor) -> VecState:
        """One policy step of the batch.

        On the card the step replays one CUDA graph of its body
        (:class:`_StepGraph`) when the backend is the kernel, the PD is
        per substep (held PD runs the engine's solve, which copies from the
        host), the five inputs are float32 and none needs a gradient. The
        first call for a shape of inputs runs eagerly (it loads the
        kernel and the tables), the second captures the graph, later ones
        replay it; swapping ``_kstep``, ``_physics`` or ``config`` on the
        env starts over. Everything else (the CPU, the engine backend,
        autograd through the step) runs the body eagerly. Both give the
        same bits: the graph holds the same kernels on the same inputs.

        Spans: ``vec/step`` around it; on an eager step ``vec/targets``,
        ``vec/physics`` (the kernel's launch, or the engine), ``vec/obs``,
        ``vec/reward``, and ``vec/termination`` twice (the NaN quarantine
        before the obs, ``done`` after the reward) inside it. A replay has
        no child span. Counters: ``vec/steps`` (every call),
        ``vec/graph_replays``, ``vec/graph_captures`` and
        ``vec/quarantined``, the envs the quarantine catches."""
        with trace_annotation("vec/step"):
            count("vec/steps", 1)
            graph = self._graph(state, action)
            if graph is None:
                return self._step(state, action)
            count("vec/graph_replays", 1)
            return graph.replay(state, action)

    def _graph(self, state: VecState, action: torch.Tensor):
        """The captured step for these inputs, or None to run eagerly."""
        inputs = (state.qpos, state.qvel, state.time, state.episode_start, action)
        if (self.backend != "kernel" or self._held_pd or not state.qpos.is_cuda
                or any(x.dtype != torch.float32 for x in inputs)
                or torch.is_grad_enabled() and any(x.requires_grad for x in inputs)):
            return None
        key = tuple(tuple(x.shape) for x in inputs) + (state.qpos.device,)
        owner = (self._kstep, getattr(self._physics, "__func__", self._physics), self.config)
        found = self._graphs.get(key)
        if found is None or any(a is not b for a, b in zip(found[0], owner)):
            self._graphs[key] = (owner, None)  # this key's eager first call
            return None
        if found[1] is None:
            found = self._graphs[key] = (owner, _StepGraph(self, inputs))
            count("vec/graph_captures", 1)
        return found[1]

    def _step(self, state: VecState, action: torch.Tensor) -> VecState:
        out, metrics = self._advance(state.qpos, state.qvel, state.time, state.episode_start,
                                     action)
        count("vec/quarantined", out.pop("bad"))
        return state.replace(**out, metrics=metrics)

    def _advance(self, qpos_in, qvel_in, time, episode_start, action):
        """The step's body on its input tensors: ``(out, metrics)``, ``out``
        the new ``qpos``, ``qvel``, ``time``, ``obs``, ``reward``, ``done``
        and the quarantine's mask ``bad``."""
        c = self.config
        with trace_annotation("vec/targets"):
            if c.action_mode == "torque":
                u = action if self._mask is None else action * self._mask[None]
            else:
                u = self._target(qpos_in, time, action)
        with trace_annotation("vec/physics"):
            qpos, qvel, xpos, xquat, fall = self._physics(qpos_in, qvel_in, u)
        t = time + c.n_substeps * c.physics_dt

        with trace_annotation("vec/termination"):
            # NaN quarantine: a numerically poisoned env is terminated and
            # sanitised so NaNs never reach the learner or the obs statistics.
            bad = ~(torch.isfinite(qpos).all(dim=1) & torch.isfinite(qvel).all(dim=1))
            qpos = torch.where(bad[:, None], torch.nan_to_num(qpos), qpos)
            qvel = torch.where(bad[:, None], torch.nan_to_num(qvel), qvel)
            xpos = torch.nan_to_num(xpos)
            xquat = torch.where(torch.isfinite(xquat), xquat, 1.0)
            fall = torch.maximum(fall, bad.to(fall.dtype))

        with trace_annotation("vec/obs"):
            obs = self._obs(qpos, qvel, t, xpos, xquat)
        with trace_annotation("vec/reward"):
            reward, terms = self._reward_batch(qpos, qvel, t, xpos, xquat, fall)
            reward = torch.where(bad, 0.0, torch.nan_to_num(reward))
        with trace_annotation("vec/termination"):
            done = torch.zeros_like(fall)
            if c.early_termination:
                done = torch.maximum(done, fall)
            if c.pose_termination > 0:
                thr = torch.full_like(t, c.pose_termination)
                if c.pose_termination_after_cycle > 0:
                    survived = t - episode_start >= self.clip.cycle_time
                    thr = torch.where(survived, c.pose_termination_after_cycle, thr)
                off_pose = terms["root_err"] > thr
                reward = torch.where(off_pose, 0.0, reward)
                done = torch.maximum(done, off_pose.to(done.dtype))
            done = torch.maximum(
                done, (t - episode_start >= c.max_episode_time).to(done.dtype))
            if not self.clip.loop:
                done = torch.maximum(done, (t >= self.clip.cycle_time).to(done.dtype))
        metrics = {
            "step_index": reference_frame_index(self.clip, t).to(torch.float32),
            "fall": fall,
            **terms,
        }
        return dict(qpos=qpos, qvel=qvel, time=t, obs=obs, reward=reward, done=done,
                    bad=bad), metrics

    def auto_reset(self, state: VecState, generator: Optional[torch.Generator] = None,
                   t0: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                   peer: Optional[torch.Tensor] = None) -> VecState:
        """Re-initialise envs where done=1 (keeps the finished step's
        reward, done and metrics). Fresh states are drawn for the whole
        batch, as :meth:`reset` draws them (start times from ``t0`` when
        given). With ``curriculum_reset_prob`` p > 0, an env restarts with
        probability p from the state of a peer drawn uniformly among the
        alive envs of the whole batch (in ``curriculum_phase_window``, when
        set); ``u`` and ``peer`` (both of the whole batch's size) replace
        those draws of ``generator`` when given. Spans: ``vec/auto_reset``
        around it; ``vec/reset`` (the fresh draw) and ``vec/curriculum``.
        Counters: ``vec/resets`` (the envs restarted), ``vec/fresh_states``
        (the fresh states made, however few envs are done) and
        ``vec/curriculum_restarts`` (the envs restarted from a peer)."""
        with trace_annotation("vec/auto_reset"):
            B = state.done.shape[0] * self.mesh.world  # the whole batch
            with trace_annotation("vec/reset"):
                fresh = self.reset(B, generator, t0=t0)
            count("vec/fresh_states", state.done.shape[0])
            if self.config.curriculum_reset_prob > 0:
                with trace_annotation("vec/curriculum"):
                    fresh = self._curriculum(state, fresh, generator, u, peer)
            d = state.done.to(torch.bool)
            count("vec/resets", state.done)

            def sel(a, b):
                return torch.where(d.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

            return state.replace(
                qpos=sel(fresh.qpos, state.qpos), qvel=sel(fresh.qvel, state.qvel),
                time=sel(fresh.time, state.time),
                episode_start=sel(fresh.episode_start, state.episode_start),
                obs=sel(fresh.obs, state.obs))

    def _curriculum(self, state: VecState, fresh: VecState, generator, u, peer) -> VecState:
        """``fresh`` with each env that restarts from a peer given the
        peer's state (:meth:`auto_reset`'s curriculum)."""
        c = self.config
        mesh = self.mesh
        B = state.done.shape[0] * mesh.world
        dev = self.device
        gdev = generator.device if generator is not None else dev
        ok = state.done == 0
        if c.curriculum_phase_window:
            lo, hi = c.curriculum_phase_window
            ph = phase(self.clip, state.time)
            ok = ok & (ph >= lo) & (ph <= hi)
        # the candidate peers' states, from every rank
        nq, nv = state.qpos.shape[1], state.qvel.shape[1]
        whole = mesh.gather_rows(torch.cat([state.qpos, state.qvel, state.time[:, None],
                                            ok[:, None].to(state.qpos.dtype)], dim=1))
        all_q, all_v = whole[:, :nq], whole[:, nq:nq + nv]
        all_t, all_ok = whole[:, nq + nv], whole[:, nq + nv + 1] > 0
        if u is None:
            u = torch.rand(B, generator=generator, device=gdev).to(dev)
        if peer is None:
            # Uniform over the eligible envs by inverse CDF, over all envs
            # when none is (ok[peer] then refuses the draw); no host sync.
            w = torch.where(all_ok.any(), all_ok.to(torch.float32), 1.0)
            cdf = torch.cumsum(w, 0)
            r = torch.rand(B, generator=generator, device=gdev).to(dev) * cdf[-1]
            peer = torch.searchsorted(cdf, r, right=True).clamp_(max=B - 1)
        u, peer = mesh.rows(u), mesh.rows(peer)
        use = (u < c.curriculum_reset_prob) & all_ok[peer]
        count("vec/curriculum_restarts", use, where=state.done)
        peer_qpos = all_q[peer]
        if c.curriculum_recenter_xy:
            ref_q, _ = reference_state(self.clip, all_t[peer])
            peer_qpos = torch.cat([ref_q[:, :2], peer_qpos[:, 2:]], dim=1)
        qpos0 = torch.where(use[:, None], peer_qpos, fresh.qpos)
        qvel0 = torch.where(use[:, None], all_v[peer], fresh.qvel)
        t_peer = all_t[peer]
        t0 = torch.where(use, t_peer, fresh.time)
        return fresh.replace(qpos=qpos0, qvel=qvel0, time=t0,
                             episode_start=torch.where(use, t_peer, fresh.episode_start),
                             obs=self._obs(qpos0, qvel0, t0))

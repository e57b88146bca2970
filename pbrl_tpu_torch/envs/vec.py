"""Vectorized mimic environment: batch-first step over the policy-step kernel.

Counterpart of ``pbrl_tpu/envs/vec.py::MimicVecEnv``. With the kernel
backend (``backend="kernel"``, or ``"auto"``) the whole env batch advances
through ONE call of the policy-step wrapper per policy step
(:mod:`pbrl_tpu_torch.ops.mimic_kernel`: the CUDA kernel for tensors on
the card, its plain version for tensors on the CPU). ``backend="xla"``
keeps pbrl_tpu's name, so flags and run configs carry over; here it means
the einsum engine (:mod:`pbrl_tpu_torch.engine`) in plain PyTorch on the
env's device, with every controller. The task (reference lookup, reward,
termination, observation, targets, start draws) is
:mod:`~pbrl_tpu_torch.envs.humanoid_task`'s, in plain PyTorch on the same
device; this env keeps the physics, the NaN quarantine, ``auto_reset``
with its curriculum and the captured step.

Held-torque PD (``pd_per_substep=False``, the reference's once-per-policy-
step PD): ``humanoid_task.held_torque`` evaluates one Stable-PD torque per
env from the pre-step state on the engine (``forward_smooth``, one
``(M + dt KD)`` solve, clamp, mask), and the kernel runs in its ``torque``
mode. As in pbrl_tpu, the kernel backend implements implicit and Stable PD
only, and held PD the Stable-PD law only; other combinations raise
``ValueError``.

Data parallelism: an env built on a :class:`~pbrl_tpu_torch.parallel.Mesh`
of ``n`` ranks holds this rank's rows of the batch. ``reset`` takes the
whole batch's size; every random draw (RSI times, reset noise, the
curriculum's draws) is made for the whole batch from the generator, which
every rank seeds alike, and each rank keeps its own rows, so the ranks
together draw what one process draws for the whole batch. The curriculum's
peer is drawn among the alive envs of all ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from pbrl_tpu_torch.control import Gains
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.forward import step_n
from pbrl_tpu_torch.engine.kinematics import kinematics as run_kinematics
from pbrl_tpu_torch.envs import humanoid_task as task
from pbrl_tpu_torch.envs.base import EnvConfig, VecState
from pbrl_tpu_torch.mocap.clip import (MotionClip, phase, reference_frame_index,
                                       reference_state)
from pbrl_tpu_torch.model.spec import Model
from pbrl_tpu_torch.ops.mimic_kernel import build_mimic_step, captured_launches
from pbrl_tpu_torch.parallel.mesh import SINGLE, Mesh
from pbrl_tpu_torch.utils.profiling import count, trace_annotation

BACKENDS = ("auto", "kernel", "xla")
# The laws the kernel implements. Per substep both run as implicit PD, on
# the engine too; held PD evaluates the Stable-PD law.
KERNEL_LAWS = ("implicit_pd", "stable_pd")


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
        if self._held_pd and config.controller not in KERNEL_LAWS:
            raise ValueError("pd_per_substep=False implements the Stable-PD law; use "
                             f"pd_per_substep=True for {config.controller!r}")
        if backend == "kernel" and config.controller not in KERNEL_LAWS:
            raise ValueError(f"the kernel backend implements implicit/Stable PD; use "
                             f"backend='xla' for {config.controller!r}")
        self.backend = backend
        self._mode = mode
        self.device = torch.device(device)
        self.mesh = mesh or SINGLE
        model = task.env_model(model, config)
        self.model = model
        self.config = config
        clip = _to(clip, self.device)
        self.clip = clip if clip.ee_pos is not None else task.augment_clip(model, clip)
        self.tables = task.env_tables(model, config, gains, actuator_mask, self.device)
        if backend == "kernel":
            kp, kd = (x.cpu().numpy() for x in self.tables.masked_gains)
            self._kstep, self._kspec = build_mimic_step(
                model, kp=kp, kd=kd, n_substeps=config.n_substeps,
                mode="torque" if self._held_pd else mode,
                fall_allowed_bodies=self.tables.fall_bodies,
                torque_scale=config.torque_limit_scale)
        self._graphs = {}  # input shapes -> (owner, _StepGraph or None): see step

    @property
    def observation_size(self) -> int:
        return task.observation_size(self.model, self.config)

    @property
    def action_size(self) -> int:
        return self.model.nu

    def _physics(self, qpos, qvel, u):
        """(qpos', qvel', xpos, xquat, fall) of one policy step through the
        kernel or the engine; the engine's fall is taken at every substep."""
        m, c = self.model, self.config
        if self._held_pd:
            u = task.held_torque(m, c, make_data(m, qpos=qpos, qvel=qvel), u, self.tables)
        if self.backend == "kernel":
            return self._kstep(qpos, qvel, u.to(torch.float32).contiguous())
        qfrc_fn = task.engine_controller(m, c, u, self.tables,
                                         torque=self._mode == "torque" or self._held_pd,
                                         implicit=KERNEL_LAWS)
        falls = []
        d = step_n(m, make_data(m, qpos=qpos, qvel=qvel), c.n_substeps, qfrc_fn=qfrc_fn,
                   on_substep=lambda d: falls.append(
                       task.detect_fall(m, d, self.tables.fall_mask).to(torch.float32)))
        d = run_kinematics(m, d)
        return d.qpos, d.qvel, d.xpos, d.xquat, functools.reduce(torch.maximum, falls)

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
            t0 = task.start_times(self.clip, c, B, draw, dev)
        else:
            t0 = mesh.rows(torch.as_tensor(t0, dtype=torch.float32, device=dev))
        q_ref, v_ref = reference_state(self.clip, t0)
        qpos, qvel = task.reset_noise(self.model, c, q_ref, v_ref, draw)
        qpos, qvel = qpos.contiguous(), qvel.contiguous()
        zeros = torch.zeros(B, device=dev)
        metrics = {
            "step_index": reference_frame_index(self.clip, t0).to(torch.float32),
            "fall": zeros, "reward_pose": zeros, "reward_vel": zeros,
            "reward_ee": zeros, "reward_com": zeros, "pose_error": zeros,
            "root_err": zeros,
        }
        return VecState(qpos=qpos, qvel=qvel, time=t0, episode_start=t0,
                        obs=task.observation(self.model, self.clip, c, qpos, qvel, t0, q_ref),
                        reward=zeros, done=zeros, metrics=metrics)

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
        ``vec/physics`` (the kernel's launch, or the engine), ``vec/reward``
        (with the step's one reference lookup), ``vec/obs``, and
        ``vec/termination`` twice (the NaN quarantine before the reward,
        ``done`` after the obs) inside it. A replay has no child span.
        Counters: ``vec/steps`` (every call),
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
        m, clip, c, k = self.model, self.clip, self.config, self.tables
        with trace_annotation("vec/targets"):
            if c.action_mode == "torque":
                u = action if k.mask is None else action * k.mask[None]
            else:
                u = task.pd_target(clip, c, time, action, k)
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

        with trace_annotation("vec/reward"):
            ref = reference_state(clip, t)
            reward, terms = task.reward(m, clip, c, qpos, qvel, t, ref, xpos, xquat, fall)
            reward = torch.where(bad, 0.0, torch.nan_to_num(reward))
        with trace_annotation("vec/obs"):
            obs = task.observation(m, clip, c, qpos, qvel, t, ref[0], xpos, xquat)
        with trace_annotation("vec/termination"):
            reward, done = task.termination(clip, c, t, episode_start, fall, terms["root_err"],
                                            reward)
        return dict(qpos=qpos, qvel=qvel, time=t, obs=obs, reward=reward, done=done,
                    bad=bad), task.step_metrics(clip, t, fall, terms)

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
        obs = task.observation(self.model, self.clip, c, qpos0, qvel0, t0,
                               reference_state(self.clip, t0)[0])
        return fresh.replace(qpos=qpos0, qvel=qvel0, time=t0,
                             episode_start=torch.where(use, t_peer, fresh.episode_start),
                             obs=obs)

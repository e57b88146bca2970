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
with its curriculum, and the step and ``auto_reset`` captured as CUDA
graphs.

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

import dataclasses
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


class _Graph:
    """``body`` captured as one CUDA graph for one shape of inputs. ``body``
    takes the inputs' views in the graph's packed input block and returns
    dicts of tensors, each kept as float32 in its packed output block. A
    replay copies the inputs into the input block (one ``cat``), replays,
    and clones the output block (one copy): the outputs, dicts of the
    body's keys, are views of that clone, so no tensor a caller holds is
    ever written again. Each kernel launch the graph holds is added to its
    wrapper's ``launches`` at every replay."""

    def __init__(self, body, inputs):
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
                groups = body(*static)
                outs = [x.to(torch.float32) for g in groups for x in g.values()]
                self._shapes = [x.shape for x in outs]
                self._out_layout, size = _layout(self._shapes)
                self._out = _pack(outs, _fillers(self._out_layout, size, dev))
            finally:
                self._graph.capture_end()
        self._launched = launched
        self._keys = [list(g) for g in groups]

    def replay(self, inputs):
        _pack(inputs, self._in_fill, out=self._in)
        self._graph.replay()
        for kstep in self._launched:
            kstep.launches += 1
        views = iter(_unpack(self._out.clone(), self._out_layout, self._shapes))
        return tuple({k: next(views) for k in keys} for keys in self._keys)


def _capturable(inputs) -> bool:
    """Inputs a graph can take: float32 tensors on the card, none of them
    needing a gradient."""
    return (inputs[0].is_cuda and all(x.dtype == torch.float32 for x in inputs)
            and not (torch.is_grad_enabled() and any(x.requires_grad for x in inputs)))


@dataclasses.dataclass
class _Entry:
    """One shape of inputs' graph: its owner, the draws its eager first
    call made (:class:`_Draws`' plan; empty for the step, which draws
    nothing), and the graph once captured."""

    owner: tuple
    plan: Optional[list] = None
    graph: Optional[_Graph] = None


def _entry(entries: dict, inputs, owner: tuple) -> _Entry:
    """The entry of ``entries`` for these inputs' shapes and device; a fresh
    one where there is none or its owner differs (compared by identity)."""
    key = tuple(tuple(x.shape) for x in inputs) + (inputs[0].device,)
    found = entries.get(key)
    if found is None or any(a is not b for a, b in zip(found.owner, owner)):
        found = entries[key] = _Entry(owner)
    return found


class _Draws:
    """A reset's random draws for the whole batch of ``n`` envs from
    ``generator`` (its device's default one when None), moved to
    ``device``: ``draws(fn, *shape)`` is ``fn``'s draw of shape
    ``(n, *shape)``, this rank's rows of it unless ``rows`` is False.
    ``plan`` records each call, ``(fn, shape, rows)``, in order; ``take``
    makes a plan's calls again."""

    def __init__(self, n: int, generator: Optional[torch.Generator], device, mesh: Mesh):
        self.n, self.generator, self.device, self.mesh = n, generator, device, mesh
        self.plan = []

    def __call__(self, fn, *shape, rows: bool = True) -> torch.Tensor:
        self.plan.append((fn, shape, rows))
        gdev = self.generator.device if self.generator is not None else self.device
        x = fn(self.n, *shape, generator=self.generator, device=gdev)
        return (self.mesh.rows(x) if rows else x).to(self.device)

    def take(self, plan) -> list:
        return [self(fn, *shape, rows=rows) for fn, shape, rows in plan]


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
        self._graphs = {}        # input shapes -> _Entry of the step's graph: see step
        self._reset_graphs = {}  # the same for auto_reset's graph

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
        return self._fresh(num_envs, _Draws(num_envs, generator, self.device, self.mesh), t0)

    def _fresh(self, num_envs: int, draw, t0: Optional[torch.Tensor]) -> VecState:
        """:meth:`reset` with its draws from ``draw`` (a :class:`_Draws`, or
        a plan's draws taken in order)."""
        c = self.config
        mesh = self.mesh
        B = mesh.local(num_envs)
        dev = self.device
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
        (:class:`_Graph`) when the backend is the kernel, the PD is
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
            out, metrics = graph.replay((state.qpos, state.qvel, state.time,
                                         state.episode_start, action))
            count("vec/quarantined", out.pop("bad"))
            return state.replace(**out, metrics=metrics)

    def _graph(self, state: VecState, action: torch.Tensor):
        """The captured step for these inputs, or None to run eagerly."""
        inputs = (state.qpos, state.qvel, state.time, state.episode_start, action)
        if self.backend != "kernel" or self._held_pd or not _capturable(inputs):
            return None
        owner = (self._kstep, getattr(self._physics, "__func__", self._physics), self.config)
        found = _entry(self._graphs, inputs, owner)
        if found.plan is None:
            found.plan = []  # this key's eager first call
            return None
        if found.graph is None:
            found.graph = _Graph(self._advance, inputs)
            count("vec/graph_captures", 1)
        return found.graph

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
        those draws of ``generator`` when given.

        On the card the body (:meth:`_renew`: the fresh states, the
        curriculum, the selection of the done envs) replays one CUDA graph
        (:class:`_Graph`) when the state is float32 and needs no gradient,
        one rank holds the whole batch (with more, the curriculum's gather
        is a collective), ``t0``, ``u`` and ``peer`` are not given and the
        observation has no link terms (their kinematics copy from the
        host). The graph holds no generator: before each replay the
        generator makes the calls the key's eager first call made, in its
        order, and the graph takes their results as inputs, so the
        generator ends where the eager body leaves it. As for the step, the
        first call for a shape of inputs runs eagerly, the second captures,
        later ones replay; a swapped ``config`` starts over. Everything
        else runs the body eagerly, with the same bits.

        Spans: ``vec/auto_reset`` around it; on an eager call ``vec/reset``
        (the fresh draw) and ``vec/curriculum`` inside it. Counters:
        ``vec/auto_resets`` (every call), ``vec/reset_replays``,
        ``vec/reset_captures``, ``vec/resets`` (the envs restarted),
        ``vec/fresh_states`` (the fresh states made, however few envs are
        done) and ``vec/curriculum_restarts`` (the envs restarted from a
        peer)."""
        with trace_annotation("vec/auto_reset"):
            count("vec/auto_resets", 1)
            count("vec/fresh_states", state.done.shape[0])
            count("vec/resets", state.done)
            inputs = (state.qpos, state.qvel, state.time, state.episode_start, state.obs,
                      state.done)
            draw = _Draws(state.done.shape[0] * self.mesh.world, generator, self.device,
                          self.mesh)
            found = self._reset_graph(inputs, t0, u, peer)
            if found is None or found.plan is None:
                out, curriculum = self._renew(*inputs, draw, t0=t0, u=u, peer=peer)
                if found is not None:  # this key's eager first call
                    found.plan = draw.plan
            else:
                inputs += tuple(draw.take(found.plan))
                if found.graph is None:
                    found.graph = _Graph(self._renew_drawn, inputs)
                    count("vec/reset_captures", 1)
                count("vec/reset_replays", 1)
                out, curriculum = found.graph.replay(inputs)
            if curriculum:
                count("vec/curriculum_restarts", curriculum["use"], where=state.done)
            return state.replace(**out)

    def _reset_graph(self, inputs, t0, u, peer) -> Optional[_Entry]:
        """The entry of :meth:`auto_reset`'s graph for these inputs, or None
        to run eagerly."""
        if (self.mesh.world != 1 or self.config.include_link_obs or t0 is not None
                or u is not None or peer is not None or not _capturable(inputs)):
            return None
        return _entry(self._reset_graphs, inputs, (self.config,))

    def _renew_drawn(self, *inputs):
        """:meth:`_renew` on the state's six tensors and, after them, the
        draws of a plan, taken in order: the body the graph captures."""
        drawn = iter(inputs[6:])
        return self._renew(*inputs[:6], lambda fn, *shape, rows=True: next(drawn))

    def _renew(self, qpos, qvel, time, episode_start, obs, done, draw, t0=None, u=None,
               peer=None):
        """:meth:`auto_reset`'s body on the state's tensors, its draws from
        ``draw``: ``(out, curriculum)``, ``out`` the new ``qpos``, ``qvel``,
        ``time``, ``episode_start`` and ``obs``, ``curriculum`` ``{"use":
        mask}`` of the envs given a peer's state, or ``{}`` without one."""
        B = done.shape[0] * self.mesh.world  # the whole batch
        with trace_annotation("vec/reset"):
            fresh = self._fresh(B, draw, t0)
        curriculum = {}
        if self.config.curriculum_reset_prob > 0:
            with trace_annotation("vec/curriculum"):
                fresh, curriculum["use"] = self._curriculum(qpos, qvel, time, done, fresh,
                                                            draw, u, peer)
        d = done.to(torch.bool)

        def sel(a, b):
            return torch.where(d.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        return dict(qpos=sel(fresh.qpos, qpos), qvel=sel(fresh.qvel, qvel),
                    time=sel(fresh.time, time),
                    episode_start=sel(fresh.episode_start, episode_start),
                    obs=sel(fresh.obs, obs)), curriculum

    def _curriculum(self, qpos, qvel, time, done, fresh: VecState, draw, u, peer):
        """``(fresh, use)``: ``fresh`` with each env that restarts from a
        peer given the peer's state, and the mask of those envs
        (:meth:`auto_reset`'s curriculum)."""
        c = self.config
        mesh = self.mesh
        B = done.shape[0] * mesh.world
        ok = done == 0
        if c.curriculum_phase_window:
            lo, hi = c.curriculum_phase_window
            ph = phase(self.clip, time)
            ok = ok & (ph >= lo) & (ph <= hi)
        # the candidate peers' states, from every rank
        nq, nv = qpos.shape[1], qvel.shape[1]
        whole = mesh.gather_rows(torch.cat([qpos, qvel, time[:, None],
                                            ok[:, None].to(qpos.dtype)], dim=1))
        all_q, all_v = whole[:, :nq], whole[:, nq:nq + nv]
        all_t, all_ok = whole[:, nq + nv], whole[:, nq + nv + 1] > 0
        if u is None:
            u = draw(torch.rand, rows=False)
        if peer is None:
            # Uniform over the eligible envs by inverse CDF, over all envs
            # when none is (ok[peer] then refuses the draw); no host sync.
            w = torch.where(all_ok.any(), all_ok.to(torch.float32), 1.0)
            cdf = torch.cumsum(w, 0)
            r = draw(torch.rand, rows=False) * cdf[-1]
            peer = torch.searchsorted(cdf, r, right=True).clamp_(max=B - 1)
        u, peer = mesh.rows(u), mesh.rows(peer)
        use = (u < c.curriculum_reset_prob) & all_ok[peer]
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
                             obs=obs), use

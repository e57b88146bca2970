"""APG cells: ``apg.train_step`` from a bundled learner state, iteration
after iteration, on ``MimicVecEnv`` over the engine (``backend="xla"``).

Set-up builds one train state as ``cli train-apg --from-checkpoint``
restores an imported learner state (``apg.init``, then the policy, the
frozen critic and the obs statistics by ``checkpoint.restore_params_into``;
the optimiser restarts), drives it through ``WARM_UNITS`` iterations of the
window's own call and feed, and hands that same state to the window. A unit
is one iteration: the window's loss and the policy's gradient through
autograd over the engine, the update and the restarts, with the action
noise drawn by the benchmark from the seed and the iteration's metrics read
to the host, as ``cli train-apg --steps-per-call 1`` reads them. With
``split`` (the traced run) the unit passes a ``timing`` dict, so that the
program times its forward window and its backward, each ended by a
synchronize.

The proxy (:class:`APGProxy`) sees every ``env.step`` call: the window's
``horizon`` forward steps, then, with ``remat``, the checkpoint's
recompute of each step inside the backward, last step first. It records a
CUDA event after each of them (the recompute runs until ``env.step``
returns: the tensors it must give back are saved after it), so a unit
gives 2 x horizon events and its intervals tile the forward and the
backward: one after the last forward step holds the loss, the start of the
backward and the last step's recompute; each later one a step's backward
and the recompute of the step before it. The sampled rows are recorded
detached, in the forward only. ``trace_steps`` counts the forward steps'
ends (1 to horizon) and, as horizon + 1, the unit's restarts, which the
program draws after the backward and the update: ``[horizon, horizon +
1]`` traces the whole backward. (The profiler cannot be started or stopped
from inside the backward: the autograd engine sets each node's thread-local
state anew, so a profiler stopped there stays on in the thread that
started it.)

For the judge the mode keeps the window's last unit: its entry state, its
noise draw and the (qpos, qvel) of each of its forward steps (references:
the program makes new ones), the policy's gradient as the optimiser
received it (references: the program sets new ``.grad`` tensors each
iteration), its params after the update, and a copy of the params and
Adam's moments before it, made into buffers of set-up before each unit
(7.3 MB on the card).

``correct``: the start of set-up and the judged iteration's entry (a fresh
restart of every env, ``reset_every`` 1) held to what a reset has to give
(:func:`benchmark.judge.reset_numbers`); the sampled (step, env) pairs of
the judged forward against the reference's step from the program's input
state (``judge.step_numbers``); the reference's window from the judged
entry state with the same noise and params along the program's path
(``benchmark/reference/apg.py``): its loss, its policy gradient against
the program's before ``zero_nans`` and the clip, and the update from
Adam's state before it. The path is followed because two float32 programs
of the same contact-rich motion part over a window's steps: from the same
entry, free, the reference's gradient of 2048 envs x 8 steps lay 0.53 and
0.97 (relative) from the program's on an H100; along the program's path,
8e-6 to 1.3e-3. The reference runs on the CPU, each step in a worker
process.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import tempfile

import torch

from benchmark import judge
from benchmark.proxy import INPUT_FIELDS, OUTPUT_FIELDS, StepProxy
from benchmark.reference import apg as ref_apg
from benchmark.reference.env import RefEnv
from benchmark.trace import STEP_MARK

WARM_UNITS = 1       # set-up iterations before the window
SAMPLED_ROWS = 64    # envs recorded at every forward step of a unit
FAULTS = ("no_value_tail", "step_grad_cut", "half_batch")


def plant(name: str, prog):
    """Plant one of ``FAULTS`` in the program; returns its undo.

    * ``no_value_tail``: ``apg.window_loss`` drops the critic's bootstrap;
    * ``step_grad_cut``: the env detaches its input state at the window's
      middle step (the same step in the forward and in its recompute);
    * ``half_batch``: the env's physics leaves the second half of the
      batch's state as it was."""
    from pbrl_tpu_torch.train import apg

    if name == "no_value_tail":
        window_loss = apg.window_loss

        def dropped(env, config, *args, **kw):
            return window_loss(env, dataclasses.replace(config, value_bootstrap=False),
                               *args, **kw)
        apg.window_loss = dropped
        return lambda: setattr(apg, "window_loss", window_loss)
    proxy = prog.proxy
    env = proxy._env
    if name == "step_grad_cut":
        from pbrl_tpu_torch.utils.tree import map_states

        step, H = env.step, prog.cfg.horizon

        def cut(state, action):
            n = proxy._n  # this call's index in the unit: forward, then recomputes in reverse
            if (n if n < H else 2 * H - 1 - n) == H // 2:
                state = map_states(torch.Tensor.detach, state)
            return step(state, action)
        env.step = cut
    else:  # half_batch
        physics = env._physics

        def half(q, v, u):
            out = list(physics(q, v, u))
            h = q.shape[0] // 2
            out[0] = torch.cat([out[0][:h], q[h:]])
            out[1] = torch.cat([out[1][:h], v[h:]])
            return tuple(out)
        env._physics = half
    attr = "step" if name == "step_grad_cut" else "_physics"
    return lambda: delattr(env, attr)


def tiny(cell: dict, conf: dict):
    """A copy of a cell and its configuration that the CPU runs in seconds
    (the benchmark's tests): 4 envs, a 4 ms policy step, a 2-step window."""
    conf = copy.deepcopy(conf)
    conf["env_config"]["policy_dt"] = 0.004
    conf["apg_config"].update(num_envs=4, horizon=2, total_env_steps=100 * 4 * 2)
    return dict(cell, num_envs=4, trace_steps=[2, 3]), conf


class APGProxy(StepProxy):
    """:class:`~benchmark.proxy.StepProxy` for a differentiated window: an
    event after every ``env.step`` call, forward or recompute; the sampled
    rows, detached, of the forward steps only (step ``k`` of a unit into
    ``buffer[k]``); the markers and ``on_step`` of the forward steps, and
    ``on_step(horizon + 1)`` when the program draws its restarts."""

    def __init__(self, env, horizon: int, timing: bool = False):
        super().__init__(env, timing)
        self.horizon = horizon
        self.path = []  # the unit's (qpos, qvel) after each forward step

    def begin_unit(self):
        super().begin_unit()
        self.path = []

    def step(self, state, action):
        nstate = self._env.step(state, action)
        if not self.segments:
            self.begin_unit()
        if self.timing:
            ev = self._event()
            ev.record()
            self.segments[-1].append(ev)
        forward = self._n < self.horizon
        if forward:
            self.path.append((nstate.qpos.detach(), nstate.qvel.detach()))
        if forward and self.buffer is not None:
            with torch.no_grad():
                B = state.qpos.shape[0]
                cols = [getattr(state, f).reshape(B, -1) for f in INPUT_FIELDS]
                cols.append(action)
                cols += [getattr(nstate, f).reshape(B, -1) for f in OUTPUT_FIELDS]
                self.buffer[self._n].copy_(torch.cat(cols, 1).index_select(0, self.rows))
        self._n += 1
        if forward:
            if self.mark:
                with torch.profiler.record_function(STEP_MARK):
                    pass
            if self.on_step is not None:
                self.on_step(self._n)
        return nstate

    def reset(self, *args, **kw):
        state = self._env.reset(*args, **kw)
        if self.segments and self._n >= self.horizon and self.on_step is not None:
            self.on_step(self.horizon + 1)
        return state

    def prepare(self, rows, units: int):
        """At set-up: the events of ``units`` units and the buffer of one
        unit's sampled forward rows."""
        self.reserve(2 * self.horizon * units)
        self.rows = rows
        width = sum(w for _, _, w in self.widths())
        self.buffer = torch.empty((self.horizon, rows.shape[0], width), device=rows.device)


class Program:
    launches_kernel = False  # the engine's autograd: no mimic_step_kernel

    def __init__(self, cell: dict, conf: dict, device):
        from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
        from pbrl_tpu_torch.mocap import load_clip
        from pbrl_tpu_torch.model import humanoid_model
        from pbrl_tpu_torch.train import checkpoint
        from pbrl_tpu_torch.train.apg import APGConfig
        from pbrl_tpu_torch.utils.configio import dict_to_config

        self.cell, self.conf, self.device = cell, conf, torch.device(device)
        self.env_config = {**conf["env_config"], **cell.get("env_set", {})}
        self.apg_config = {**conf["apg_config"], **cell.get("apg_set", {})}
        self.cfg = dict_to_config(APGConfig, self.apg_config)
        env = MimicVecEnv(humanoid_model(), load_clip(conf["clip"], device=self.device),
                          dict_to_config(EnvConfig, self.env_config), device=self.device,
                          backend=conf["backend"])
        self.proxy = APGProxy(env, self.cfg.horizon, timing=self.device.type == "cuda")
        self.files = (checkpoint.bundled_policy(conf["clip"]),
                      checkpoint.bundled_train_state(conf["clip"]))
        tmp = tempfile.mkdtemp(prefix="bench_apg_")
        try:
            checkpoint.import_train_state(tmp, self.files[1], self.files[0])
            self.payload = checkpoint.restore(tmp, device=self.device)
        finally:
            shutil.rmtree(tmp)
        self.steps_per_unit = self.cfg.num_envs * self.cfg.horizon
        self.mlp = ([env.observation_size, *self.cfg.hidden, env.action_size],
                    [env.observation_size, *self.cfg.hidden, 1])
        self.ref = None
        self.windows = None  # the reference's worker processes (_windows)

    def start(self, seed: int):
        from pbrl_tpu_torch.train import apg, checkpoint

        self.cfg = dataclasses.replace(self.cfg, seed=seed)
        ts = apg.init(self.proxy, self.cfg, self.device)
        checkpoint.restore_params_into(ts, self.payload)
        self.ts = ts
        self.first_state = ts.env_state
        self.draws = torch.Generator(device=self.device).manual_seed(
            (seed * 2654435761 + 97) % 2 ** 63)
        g = torch.Generator().manual_seed(seed)
        self.rows = torch.randperm(self.cfg.num_envs, generator=g)[:SAMPLED_ROWS].to(self.device)
        self.pick = torch.Generator().manual_seed(seed + 1)
        self.proxy.clear()
        self.last = None

    def _params(self):
        return {f"policy/{k}": p for k, p in self.ts.policy.named_parameters()}

    def warm(self):
        """The first iterations, through the window's call and feed; then
        the buffers of the window's copies of the learner's state."""
        for _ in range(WARM_UNITS):
            self._iteration()
        self.proxy.clear()
        self.proxy.prepare(self.rows, 64)
        opt = self.ts.opt
        self.before = {"params": {k: p.detach().clone() for k, p in self._params().items()},
                       "mu": {k: v.clone() for k, v in opt.mu.items()},
                       "nu": {k: v.clone() for k, v in opt.nu.items()}, "count": opt.count}

    def _iteration(self, split=False):
        """One iteration through the window's call and feed: (what the
        judge reads of it, its host spans)."""
        from pbrl_tpu_torch.train import apg

        c = self.cfg
        noise = torch.randn((c.horizon, c.num_envs, self.proxy.action_size),
                            generator=self.draws, device=self.device)
        entry = self.ts.env_state
        self.proxy.begin_unit()
        timing = {} if split else None
        _, metrics = apg.train_step(self.proxy, c, self.ts, noise=noise, timing=timing)
        values = torch.stack(list(metrics.values())).tolist()
        calls = self.proxy._n
        if calls != (2 if c.remat else 1) * c.horizon:
            raise RuntimeError(f"{calls} env.step calls in an iteration of horizon {c.horizon}")
        grads = {k: p.grad for k, p in self._params().items()}
        spans = {"forward_s": timing["forward_s"], "backward_s": timing["backward_s"]} if split else {}
        return {"entry": entry, "noise": noise, "metrics": dict(zip(metrics, values)),
                "grads": grads, "path": self.proxy.path}, spans

    def unit(self, split=False):
        self.last = None  # the previous unit's references go before this one's come
        for k, p in self._params().items():
            self.before["params"][k].copy_(p.detach())
        opt = self.ts.opt
        for k in opt.mu:
            self.before["mu"][k].copy_(opt.mu[k])
            self.before["nu"][k].copy_(opt.nu[k])
        self.before["count"] = opt.count
        self.last, spans = self._iteration(split)
        self.last["after"] = {k: p.detach() for k, p in self._params().items()}
        return self.steps_per_unit, spans

    def model_flops(self, flops, units: int) -> dict:
        """Model FLOP of ``units`` iterations by precision class
        (:func:`benchmark.apg_flops.iteration_flops`), the physics counted
        on 256 of the last unit's sampled forward states."""
        from benchmark import apg_flops

        env = self.ref["env"]
        q, v, u = self.physics_inputs(env)
        per_env = flops.kernel_flop_per_env(env.spec, q, v, u)
        need = apg_flops.iteration_flops(flops, self.mlp, self.cfg.num_envs, self.cfg.horizon,
                                         per_env)
        return {k: units * x for k, x in need.items()}

    def free(self):
        """Drop the program's state; the judged unit's records stay."""
        self.kept = self._records()
        self.ts = self.proxy = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    # -- correctness ----------------------------------------------------------
    def _records(self):
        """(the last unit's (horizon, rows, columns) sampled records, the
        columns), the program's own until it is freed."""
        return self.kept if self.proxy is None else (self.proxy.buffer, self.proxy.widths())

    def _pairs(self):
        """The judged forward's sampled records as {(side, field): (N, w)},
        with each pair's noise row."""
        buffer, columns = self._records()
        H, R, K = buffer.shape
        s = judge.split(buffer.reshape(H * R, K), columns)
        s["noise"] = self.last["noise"][:, self.rows].reshape(H * R, -1)
        return s

    def physics_inputs(self, env: RefEnv):
        """(qpos, qvel, targets) of 256 sampled forward states of the last
        unit."""
        s = {k: x.cpu() for k, x in self._pairs().items()}  # the reference runs on the CPU
        n = s[("in", "qpos")].shape[0]
        idx = torch.randperm(n, generator=torch.Generator().manual_seed(7))[:256]
        q, t = s[("in", "qpos")][idx], s[("in", "time")][idx, 0]
        return q, s[("in", "qvel")][idx], env.target(q, t, s[("in", "action")][idx])

    def reference(self, device):
        """The reference on the CPU, whatever ``device``: its physics issues
        one tensor op per scalar op, whose backward the CPU runs several
        times faster than the card, and its steps run in worker processes
        there, started now (``reference/apg.py::FollowedWindows``)."""
        value, stats = ref_apg.load_critic(self.files[1], "cpu")
        self.ref = {"env": RefEnv(self.conf["clip"], self.env_config, "cpu"), "value": value,
                    "stats": stats, "config": self.apg_config}
        self._windows()
        return self.ref

    def _windows(self):
        if self.windows is None:
            self.windows = ref_apg.FollowedWindows(self.conf["clip"], self.env_config,
                                                   self.apg_config, os.cpu_count() or 1)
        return self.windows

    def _start_window(self, low: bool = False):
        """Send the judged unit's window to the reference's workers: from the
        program's copy of the state before it, along the program's path; with
        ``low``, the matmuls' operands in TF32."""
        L, ref = self.last, self.ref
        e = L["entry"]
        entry = {"qpos": e.qpos, "qvel": e.qvel, "time": e.time, "episode_start": e.episode_start}
        self._windows().start(self.before["params"], ref["value"], ref["stats"], entry,
                              L["noise"], L["path"], low)

    def _finish_window(self):
        """The reference's (loss, gradient, params after the update) of the
        window sent."""
        loss, grads = self.windows.finish()
        b, cpu = self.before, lambda d: {k: v.detach().cpu() for k, v in d.items()}
        after, *_ = ref_apg.update(cpu(b["params"]), grads, cpu(b["mu"]), cpu(b["nu"]),
                                   b["count"], self.ref["config"])
        return loss, grads, after

    def _window(self, low: bool = False):
        self._start_window(low)
        return self._finish_window()

    def _gaps(self, got, want) -> dict:
        """``loss_gap``, ``grad_gap`` and ``delta_gap`` of ``got`` against
        ``want``, each (loss, gradient, params after) of the judged unit."""
        before = {k: p.cpu() for k, p in self.before["params"].items()}
        loss_gap = abs(got[0] - want[0]) / abs(want[0])
        delta = lambda after: {k: after[k].cpu() - before[k] for k in before}
        return {"loss_gap": loss_gap, "grad_gap": relative_gap(got[1], want[1]),
                "delta_gap": relative_gap(delta(got[2]), delta(want[2]))}

    def _program_window(self):
        L = self.last
        return L["metrics"]["loss"], L["grads"], L["after"]

    def unit_readings(self, ref: dict, witness: bool = False) -> dict:
        """``loss_gap``, ``grad_gap`` and ``delta_gap`` of the unit just run,
        read as ``numbers`` reads them of the window's last unit but
        without the rest of the judge, so that calibration reads them after
        every unit (read them before the next unit starts). There is no
        float64 witness: the reference's physics runs in float32 only."""
        if witness:
            raise ValueError("the APG mode has no float64 witness")
        return self._gaps(self._program_window(), self._window())

    def numbers(self, ref: dict, control: bool = False) -> dict:
        """The compared numbers: the program's (or, with ``control``, the
        reference's with its matmuls' operands in TF32) against the
        reference's."""
        env, stats, c = ref["env"], ref["stats"], ref["config"]
        self._start_window()  # its forwards run in the workers while the pairs are stepped here
        params = {k: p.cpu() for k, p in self.before["params"].items()}
        s = {k: x.cpu() for k, x in self._pairs().items()}
        inp = {f: s[("in", f)] for f in ("qpos", "qvel", "obs")}
        out = {f: s[("out", f)] for f in ("qpos", "qvel", "obs", "reward", "done")}
        t_in, es_in = s[("in", "time")][:, 0], s[("in", "episode_start")][:, 0]
        act = s[("in", "action")]
        with torch.no_grad():
            obs_ref = env.obs(inp["qpos"], inp["qvel"], t_in)
            act_ref = ref_apg.action(params, stats, obs_ref, s["noise"], c)
            ref_out = env.step(inp["qpos"], inp["qvel"], t_in, es_in, act_ref)
            if control:
                act = ref_apg.action(params, stats, obs_ref, s["noise"], c, low=True)
                out = env.step(inp["qpos"], inp["qvel"], t_in, es_in, act)
                inp = {**inp, "obs": obs_ref}
        nums = judge.step_numbers(inp, act, out, obs_ref, act_ref, ref_out)
        # every env restarts fresh before each iteration (reset_every 1)
        fresh = [self.first_state] + [self.last["entry"]] * (self.cfg.reset_every == 1)
        starts = [judge.reset_numbers(env, _on_cpu(st), [], low=control) for st in fresh]
        nums["start_gap"] = max(r["start_gap"] for r in starts)
        nums["reset_wrong"] = sum(r["reset_wrong"] for r in starts)
        want = self._finish_window()
        seconds = self.windows.seconds
        got = self._window(low=True) if control else self._program_window()
        self.windows.close()
        self.windows = None
        nums.update(self._gaps(got, want))
        nums.update({f"reference_{k}": v for k, v in seconds.items()})
        nums["losses"] = [got[0], want[0]]
        nums["grad_nans"] = [float(sum(torch.isnan(g).sum() for g in x[1].values()
                                       if g is not None)) for x in (got, want)]
        nums["pairs"] = float(act.shape[0])
        return nums


def relative_gap(got: dict, want: dict) -> float:
    """``|got - want| / |want|`` over all leaves together (2-norms), each
    NaN entry, and a leaf without a gradient, taken as 0 on either side,
    as the optimiser takes them."""
    z = lambda x: 0.0 if x is None else torch.nan_to_num(
        x.detach().cpu().double(), nan=0.0, posinf=float("inf"), neginf=float("-inf"))
    num = sum(float(torch.sum((z(got[k]) - z(want[k])) ** 2)) for k in want)
    den = sum(float(torch.sum(z(want[k]) ** 2)) for k in want)
    return (num / den) ** 0.5 if den > 0 else (0.0 if num == 0 else float("inf"))


def _on_cpu(state):
    from pbrl_tpu_torch.utils.tree import map_states

    return map_states(lambda x: x.cpu(), state)

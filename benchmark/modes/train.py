"""Training cells: ``ppo.train_step`` from a bundled learner state,
iteration after iteration.

Set-up builds one train state as ``cli train`` resumes an imported learner
state (``ppo.init``, ``checkpoint.restore_into``, ``reset_log_std``), drives
it through ``FIRST_STEPS`` iterations of the window's own call and feed,
and hands that same state to the window. A unit is one iteration: the
``train_step`` made by ``make_train_functions`` with the action noise and
the minibatch permutations drawn by the benchmark from the seed, its
metrics read to the host as ``ppo.train`` reads them. With ``split`` (the
traced run) the unit calls ``ppo.rollout`` and ``ppo.learn`` in turn, with
a synchronize between them, so that each has a host-clock span.

Before each unit of the window the learner's state (parameters, Adam's
moments and count, the observation statistics) is copied into buffers
made at set-up, and the unit's steps are kept (references, no copies)
until the next unit starts, so that the window's last unit can be judged.

``correct`` judges the first ``FIRST_STEPS`` iterations and the window's
last. A reference learner loaded from the same files follows the first
ones; a second starts from the program's state before the last (it cannot
rebuild tens of iterations it did not follow). Each takes its iteration's
rollout (the program's observations, actions, rewards and dones, which it
judges step by step on sampled pairs) and makes its own update with the
same permutations: the loss of each iteration, the gradient of the first
iteration's first minibatch by leaf, the change of every leaf over the
first iterations and over the last are compared. The env's resets in
these iterations (the first reset, and each ``auto_reset``, read from the
states around it) are held to what a reset has to give
(:func:`benchmark.judge.reset_numbers`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import shutil
import tempfile
import time

import torch

from benchmark import faults, judge
from benchmark.proxy import StepProxy
from benchmark.reference.env import RefEnv
from benchmark.reference.learner import Learner

FIRST_STEPS = 3     # set-up iterations the reference follows from the files
PAIRS = 512         # sampled (step, env) pairs the reference steps
FAULTS = ("unchanged", "half_batch", "altered", "no_reset", "no_curriculum")
# Faults that ``correct`` does not catch yet: the judged iterations hold too
# few curriculum candidates (done envs with a live peer in the phase window)
# for their missing restarts to show in ``curriculum_tail``.
MISSED = ("no_curriculum",)


def applies(name: str, cell: dict, conf: dict) -> bool:
    """``no_curriculum`` only where the configuration has a curriculum."""
    return name != "no_curriculum" or conf["env_config"]["curriculum_reset_prob"] > 0


def plant(name: str, prog):
    """Plant one of ``FAULTS`` (``benchmark/faults.py`` says what each
    breaks); returns its undo."""
    if name == "unchanged":
        from pbrl_tpu_torch.train import optim

        step = optim.Adam.step

        def frozen(self, params):
            self.count += 1
            return torch.zeros(())
        optim.Adam.step = frozen
        return lambda: setattr(optim.Adam, "step", step)
    if name == "half_batch":
        from pbrl_tpu_torch.train import ppo

        loss_fn = ppo.loss_fn

        def half(policy, value, config, batch, adv, ret, obs_stats):
            h = adv.shape[0] // 2
            part = type(batch)(**{k: getattr(batch, k)[:h] for k in vars(batch)})
            return loss_fn(policy, value, config, part, adv[:h], ret[:h], obs_stats)
        ppo.loss_fn = half
        return lambda: setattr(ppo, "loss_fn", loss_fn)
    if name == "altered":
        return faults._wrap_kernel(prog, faults._altered)
    env = prog.proxy._env
    if name == "no_reset":
        env.auto_reset = lambda state, *args, **kw: state

        def undo():
            del env.auto_reset
        return undo
    config = env.config  # no_curriculum
    env.config = dataclasses.replace(config, curriculum_reset_prob=0.0)
    return lambda: setattr(env, "config", config)


def tiny(cell: dict, conf: dict):
    """A copy of a cell and its configuration that the CPU runs in seconds
    (the benchmark's tests): 4 envs, a 4 ms policy step, episodes of 6 ms
    so that every rollout resets, 2-step rollouts, 2 minibatches, 1 epoch."""
    conf = copy.deepcopy(conf)
    conf["env_config"].update(policy_dt=0.004, max_episode_time=0.006)
    return dict(cell, num_envs=4, train_set={"num_envs": 4, "unroll_length": 2,
                                             "num_minibatches": 2, "update_epochs": 1}), conf


class Program:
    launches_kernel = True   # every rollout step is one mimic_step_kernel launch

    def __init__(self, cell: dict, conf: dict, device):
        from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
        from pbrl_tpu_torch.mocap import load_clip
        from pbrl_tpu_torch.model import humanoid_model
        from pbrl_tpu_torch.train import checkpoint
        from pbrl_tpu_torch.train.ppo import TrainConfig
        from pbrl_tpu_torch.utils.configio import dict_to_config

        self.cell, self.conf, self.device = cell, conf, torch.device(device)
        self.env_config = {**conf["env_config"], **cell.get("env_set", {})}
        self.train_config = {**conf["train_config"], **cell.get("train_set", {})}
        env = MimicVecEnv(humanoid_model(), load_clip(conf["clip"], device=self.device),
                          dict_to_config(EnvConfig, self.env_config), device=self.device)
        self.proxy = StepProxy(env, timing=self.device.type == "cuda")
        self.cfg = dict_to_config(TrainConfig, self.train_config)
        self.files = (checkpoint.bundled_policy(conf["clip"]),
                      checkpoint.bundled_train_state(conf["clip"]))
        # the imported learner state, as `cli train` resumes it, read once
        tmp = tempfile.mkdtemp(prefix="bench_learner_")
        try:
            checkpoint.import_train_state(tmp, self.files[1], self.files[0])
            self.payload = checkpoint.restore(tmp, device=self.device)
        finally:
            shutil.rmtree(tmp)
        self.steps_per_unit = self.cfg.num_envs * self.cfg.unroll_length
        self.mlp = ([env.observation_size, *self.cfg.hidden, env.action_size],
                    [env.observation_size, *self.cfg.hidden, 1])

    def start(self, seed: int):
        from pbrl_tpu_torch.train import checkpoint
        from pbrl_tpu_torch.train.ppo import make_train_functions

        cfg = dataclasses.replace(self.cfg, seed=seed)
        init, self.train_step, _ = make_train_functions(self.proxy, cfg)
        ts = init(self.device)
        checkpoint.restore_into(ts, self.payload)
        if cfg.reset_log_std:
            with torch.no_grad():
                ts.policy.log_std.fill_(cfg.init_log_std)
        self.ts = ts
        self.draws = torch.Generator(device=self.device).manual_seed(
            (seed * 2654435761 + 97) % 2 ** 63)
        self.pick = torch.Generator().manual_seed(seed + 1)
        self.proxy.clear()
        self.traced = None

    def _draws(self):
        c, dev = self.cfg, self.device
        noise = torch.randn((c.unroll_length, c.num_envs, self.proxy.action_size),
                            generator=self.draws, device=dev)
        n = c.unroll_length * c.num_envs
        perms = torch.stack([torch.randperm(n, generator=self.draws, device=dev)
                             for _ in range(c.update_epochs)])
        return noise, perms

    def warm(self):
        """The first iterations, through the window's call and feed, kept
        whole for the reference; then the buffers of the window's copies
        of the learner's state."""
        ts = self.ts
        self.p0 = {k: p.detach().clone() for k, p in ts.params().items()}
        self.first_state = ts.env_state
        self.proxy.full = True
        real_step = ts.opt.step

        def first_step(params):
            # the first gradient as the optimiser gets it
            self.grads = {n: p.grad.detach().clone() if p.grad is not None
                          else torch.zeros_like(p) for n, p in params.items()}
            del ts.opt.step
            return real_step(params)

        ts.opt.step = first_step
        self.first = [self._iteration()[0] for _ in range(FIRST_STEPS)]
        self.p3 = {k: p.detach().clone() for k, p in ts.params().items()}
        self.proxy.clear()
        self.proxy.reserve(64 * self.cfg.unroll_length)
        self.before = _tree(lambda x: x.detach().clone(), self._learner_state())

    def _learner_state(self):
        ts = self.ts
        s = ts.obs_stats
        return {"params": {k: p.detach() for k, p in ts.params().items()},
                "mu": ts.opt.mu, "nu": ts.opt.nu, "stats": [s.count, s.mean, s.m2]}

    def _iteration(self, split=False):
        """One iteration through the window's call and feed: (what the
        judge reads of it, its host spans)."""
        noise, perms = self._draws()
        self.proxy.records.clear()
        self.proxy.begin_unit()
        spans = {}
        if not split:
            _, metrics = self.train_step(self.ts, noise=noise, perms=perms)
            values = torch.stack(list(metrics.values())).tolist()
        else:
            from pbrl_tpu_torch.train import ppo

            t0 = time.perf_counter()
            state, traj = ppo.rollout(self.proxy, self.cfg, self.ts, noise)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            metrics = ppo.learn(self.cfg, self.ts, state, traj, perms)
            values = torch.stack(list(metrics.values())).tolist()
            spans = {"rollout_s": t1 - t0, "learn_s": time.perf_counter() - t1}
        return {"noise": noise, "perms": perms, "metrics": dict(zip(metrics, values)),
                "steps": self.proxy.records[-1], "final": self.ts.env_state}, spans

    def unit(self, split=False):
        self.last = None  # the previous unit's steps go before this one's come
        _tree(lambda src, dst: dst.copy_(src), self._learner_state(), self.before)
        self.before["count"] = self.ts.opt.count
        self.last, spans = self._iteration(split)
        self.last["after"] = {k: p.detach() for k, p in self.ts.params().items()}
        if split and len(self.proxy.segments) == 2:  # the traced unit
            self.traced = self.last["steps"]
        return self.steps_per_unit, spans

    def launches(self):
        return self.proxy._env._kstep.launches

    def model_flops(self, flops, units: int) -> dict:
        """Model FLOP of ``units`` iterations by precision class: the MLPs
        (rollout forward of both nets per env step; the bootstrap forward;
        forward and backward of both nets per learned sample) and the
        kernel."""
        c = self.cfg
        pol, val = (flops.mlp_forward(w) for w in self.mlp)
        steps = c.unroll_length * c.num_envs
        per_unit = (steps * (pol + val) + c.num_envs * val
                    + 3 * c.update_epochs * steps * (pol + val))
        return {"matmul": units * per_unit, "vector": units * steps * self.kernel_flop_per_env}

    def free(self):
        """Drop the program's state; the judged iterations' records stay."""
        self.ts = self.train_step = self.proxy = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    # -- correctness ----------------------------------------------------------
    @staticmethod
    def _rollout(steps):
        """An iteration's (T, B, ...) rollout as the learner took it."""
        stack = lambda f: torch.stack([f(s) for s in steps])
        return {"qpos": stack(lambda s: s["in"].qpos), "qvel": stack(lambda s: s["in"].qvel),
                "time": stack(lambda s: s["in"].time),
                "episode_start": stack(lambda s: s["in"].episode_start),
                "obs": stack(lambda s: s["in"].obs), "action": stack(lambda s: s["action"]),
                "out_qpos": stack(lambda s: s["out"].qpos),
                "out_qvel": stack(lambda s: s["out"].qvel),
                "out_obs": stack(lambda s: s["out"].obs),
                "reward": stack(lambda s: s["out"].reward), "done": stack(lambda s: s["out"].done)}

    def kernel_inputs(self, env: RefEnv):
        """(qpos, qvel, targets) of 256 launch inputs drawn from the traced
        unit's steps (the window's last unit where none was traced)."""
        r = self._rollout(self.traced or self.last["steps"])
        T, B = r["reward"].shape
        idx = torch.randperm(T * B, generator=torch.Generator().manual_seed(7))[:256]
        f = lambda x: x.flatten(0, 1)[idx.to(x.device)]
        return f(r["qpos"]), f(r["qvel"]), env.target(f(r["qpos"]), f(r["time"]), f(r["action"]))

    def reference(self, device):
        return {"env": RefEnv(self.conf["clip"], self.env_config, device),
                "make_learner": lambda: Learner(self.files[0], self.files[1], self.train_config,
                                                device),
                "learner_at": lambda state, dtype=torch.float32: Learner.from_state(
                    state, self.train_config, device, dtype)}

    def _judge(self, env, learner, got, it, n, control):
        """One iteration: ``n`` sampled (step, env) pairs with the
        reference's obs and action, then the reference's update (and, with
        ``control``, ``got``'s in TF32). Returns (pairs, (loss, reference's
        loss), the first minibatch's gradients (got, reference's))."""
        r = self._rollout(it["steps"])
        T, B = r["reward"].shape
        idx = torch.randperm(T * B, generator=self.pick)[:n]
        g = lambda x: x.flatten(0, 1)[idx.to(x.device)]
        pair = {f: g(v) for f, v in r.items()}
        noise = g(it["noise"])
        with torch.no_grad():
            pair["obs_ref"] = obs_ref = env.obs(pair["qpos"], pair["qvel"], pair["time"])
            pair["act_ref"] = (learner.policy_mean(learner.normalize(obs_ref))
                               + torch.exp(learner.log_std()) * noise)
            if control:
                with _tf32():
                    pair["action"] = (got.policy_mean(got.normalize(obs_ref))
                                      + torch.exp(got.log_std()) * noise)
        args = (r["obs"], r["action"], r["reward"], r["done"], it["final"].obs, it["perms"])
        metrics, grads = learner.learn(*args)
        if control:
            with _tf32():
                got_metrics, got_grads = got.learn(*args)
            got_loss = float(got_metrics["loss"])
        else:
            m, c = it["metrics"], self.cfg
            got_loss = m["loss_policy"] + c.value_cost * m["loss_value"] - c.entropy_cost * m["entropy"]
            got_grads = self.grads
        return pair, (got_loss, float(metrics["loss"])), (got_grads, grads)

    def unit_readings(self, ref: dict, witness: bool = False) -> dict:
        """``window_delta_gap`` of the unit just run, read as ``numbers``
        reads it of the window's last unit but without the rest of the
        judge, so that calibration reads it after every unit (read it before
        the next unit starts): the program's, the control's (the reference
        in TF32 in its place) and, with ``witness``, the program's and the
        reference's against the reference in float64."""
        it = self.last
        r = self._rollout(it["steps"])
        inputs = (r["obs"], r["action"], r["reward"], r["done"], it["final"].obs)
        got = {k: it["after"][k] - self.before["params"][k] for k in self.before["params"]}

        def delta(dtype=torch.float32, low=False):
            learner = ref["learner_at"](self.before, dtype)
            start = {k: p.clone() for k, p in learner.params.items()}
            with _tf32() if low else contextlib.nullcontext():
                learner.learn(*(x.to(dtype) for x in inputs), it["perms"])
            return {k: learner.params[k] - start[k] for k in start}

        ref32 = delta()
        out = {"window_delta_gap": judge.leaf_gap(got, ref32)[0],
               "control_window_delta_gap": judge.leaf_gap(delta(low=True), ref32)[0]}
        if witness:
            ref64 = delta(torch.float64)
            out["program_f64_gap"] = judge.leaf_gap(got, ref64)[0]
            out["reference_f64_gap"] = judge.leaf_gap(ref32, ref64)[0]
        return out

    def _transitions(self, iterations):
        """(state a step left, state ``auto_reset`` made of it) of every
        step of the iterations."""
        for it in iterations:
            steps = it["steps"]
            posts = [s["in"] for s in steps[1:]] + [it["final"]]
            yield from ((s["out"], post) for s, post in zip(steps, posts))

    def numbers(self, ref: dict, control: bool = False) -> dict:
        """The compared numbers: the program's (or, with ``control``, the
        reference's in the lower precision) against the reference's. The
        sampled pairs of every judged iteration are stepped as one batch."""
        env = ref["env"]
        learners = [ref["make_learner"](), ref["learner_at"](self.before)]
        gots = [ref["make_learner"](), ref["learner_at"](self.before)] if control else [None, None]
        starts = [{k: p.clone() for k, p in l.params.items()} for l in learners]
        judged = self.first + [self.last]
        nums, losses, pairs = {}, [], []
        for k, it in enumerate(judged):
            w = int(k == len(self.first))  # 0: following from the files; 1: the window's last
            pair, loss, grads = self._judge(env, learners[w], gots[w], it,
                                            PAIRS // len(judged), control)
            pairs.append(pair)
            losses.append(loss)
            if k == 0:
                nums["grad_gap"], nums["grad_leaf"], _ = judge.leaf_gap(*grads)
        s = {f: torch.cat([p[f] for p in pairs]) for f in pairs[0]}
        with torch.no_grad():
            ref_out = env.step(s["qpos"], s["qvel"], s["time"], s["episode_start"], s["act_ref"])
            inp = {"obs": s["obs"]}
            out = {"qpos": s["out_qpos"], "qvel": s["out_qvel"], "obs": s["out_obs"],
                   "reward": s["reward"], "done": s["done"]}
            if control:
                out = env.step(s["qpos"], s["qvel"], s["time"], s["episode_start"], s["action"])
                inp = {"obs": s["obs_ref"]}
            nums.update(judge.step_numbers(inp, s["action"], out, s["obs_ref"], s["act_ref"],
                                           ref_out))
            nums.update(judge.reset_numbers(env, self.first_state, self._transitions(judged),
                                            low=control))
        # against the largest of the losses: a loss near 0 has no relative scale
        scale = max(abs(r) for _, r in losses)
        nums["loss_gap"] = max(abs(g - r) for g, r in losses) / scale
        ends = [{k: self.p3[k] - self.p0[k] for k in starts[0]},
                {k: self.last["after"][k] - self.before["params"][k] for k in starts[1]}]
        for w, name in enumerate(("delta", "window_delta")):
            ref_delta = {k: learners[w].params[k] - starts[w][k] for k in starts[w]}
            got_delta = ({k: gots[w].params[k] - starts[w][k] for k in starts[w]} if control
                         else ends[w])
            nums[f"{name}_gap"], nums[f"{name}_leaf"], nums[f"{name}_skipped"] = \
                judge.leaf_gap(got_delta, ref_delta)
        nums["losses"] = losses
        nums["pairs"] = float(s["qpos"].shape[0])
        return nums


def _tree(fn, *trees):
    """``fn`` over the tensors of nested dicts and lists (the first tree's
    shape); other leaves are kept from the first tree."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tree(fn, *(x[i] for x in trees)) for i in range(len(t))]
    return t


class _tf32:
    """Matmuls in TF32 inside the block: the control's precision."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was

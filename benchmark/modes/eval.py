"""Eval cells: ``ppo.evaluate`` of a shipped policy, episode after episode.

A unit is one episode of ``num_envs`` envs for ``episode_steps`` steps from
a fresh reset drawn from the run's generator, its metrics read to the host,
as ``cli eval`` runs it. The env is the configuration's with the
training-only perturbations stripped as ``cli eval`` strips them
(``env_set`` of the workload file).

``correct`` follows the program step by step: from the window's sampled
(step, env) pairs whose env is still alive, the reference takes the
program's input state, builds its own observation, policy mean and step,
and compares each with the program's. The start is checked by itself: the
state of each sampled env at its episode's first step against the clip's
reference state at its start time.
"""

from __future__ import annotations

import copy

import torch

from benchmark import faults, judge
from benchmark.proxy import StepProxy
from benchmark.reference.env import RefEnv
from benchmark.reference.learner import Learner

PAIRS = 512         # sampled (step, env) pairs the reference steps
SAMPLED_ROWS = 32   # envs recorded at every step
RECORDED_STEPS = 2048  # steps of the window whose sampled rows are kept
FAULTS = ("unchanged", "half_batch", "altered")


def _unchanged(k, q, v, u):
    return (q.clone(), v.clone(), *k(q, v, u)[2:])


def _half_batch(k, q, v, u):
    h = q.shape[0] // 2
    out = list(k(q, v, u))
    out[0] = torch.cat([out[0][:h], q[h:]])
    out[1] = torch.cat([out[1][:h], v[h:]])
    return tuple(out)


def plant(name: str, prog):
    """Plant one of ``FAULTS`` in the policy-step kernel
    (``benchmark/faults.py`` says what each breaks); returns its undo."""
    fn = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": faults._altered}
    return faults._wrap_kernel(prog, fn[name])


def tiny(cell: dict, conf: dict):
    """A copy of a cell and its configuration that the CPU runs in seconds
    (the benchmark's tests): 4 envs, a 4 ms policy step, 3 steps."""
    conf = copy.deepcopy(conf)
    conf["env_config"]["policy_dt"] = 0.004
    return dict(cell, num_envs=4, episode_steps=3), conf


class Program:
    launches_kernel = True   # every env step is one mimic_step_kernel launch

    def __init__(self, cell: dict, conf: dict, device):
        from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
        from pbrl_tpu_torch.mocap import load_clip
        from pbrl_tpu_torch.model import humanoid_model
        from pbrl_tpu_torch.train import checkpoint
        from pbrl_tpu_torch.utils.configio import dict_to_config

        self.cell, self.conf, self.device = cell, conf, torch.device(device)
        self.env_config = {**conf["env_config"], **cell.get("env_set", {})}
        env = MimicVecEnv(humanoid_model(), load_clip(conf["clip"], device=self.device),
                          dict_to_config(EnvConfig, self.env_config), device=self.device)
        self.proxy = StepProxy(env, timing=self.device.type == "cuda")
        self.policy_file = checkpoint.bundled_policy(conf["clip"])
        self.policy, self.stats, run = checkpoint.load_policy(self.policy_file, device=self.device)
        self.normalize_obs = (run.get("train_config") or {}).get("normalize_obs", True)
        self.num_envs, self.num_steps = cell["num_envs"], cell["episode_steps"]
        self.steps_per_unit = self.num_envs * self.num_steps
        self.mlp = [env.observation_size, *conf["train_config"]["hidden"], env.action_size]

    def start(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        self.rows = torch.randperm(self.num_envs, generator=g)[:SAMPLED_ROWS].to(self.device)
        self.pick = torch.Generator().manual_seed(seed + 1)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.proxy.clear()
        self.kept = None

    def warm(self):
        """A few steps at the cell's batch: the kernel's first launch and
        its tables, the allocator's blocks."""
        self._evaluate(3)
        self.proxy.clear()
        self.proxy.reserve(RECORDED_STEPS, self.rows)

    def _evaluate(self, steps):
        from pbrl_tpu_torch.train import evaluate

        self.proxy.begin_unit()
        metrics = evaluate(self.proxy, self.policy, self.stats, num_envs=self.num_envs,
                           num_steps=steps, generator=self.gen,
                           normalize_obs=self.normalize_obs)
        return {k: float(v) for k, v in metrics.items()}

    def unit(self, split=False):
        self.last = self._evaluate(self.num_steps)
        return self.steps_per_unit, {}

    def launches(self):
        return self.proxy._env._kstep.launches

    def model_flops(self, flops, units: int) -> dict:
        """Model FLOP of ``units`` episodes by precision class: the policy's
        forward per env step (matmul) and the kernel (vector f32)."""
        steps = units * self.num_steps * self.num_envs
        return {"matmul": steps * flops.mlp_forward(self.mlp),
                "vector": steps * self.kernel_flop_per_env}

    def free(self):
        """Drop the program's state; keep the sampled records."""
        self.kept = self._records()
        self.proxy = self.policy = self.stats = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _records(self):
        """(per unit the (steps, rows, columns) sampled records, the
        columns), the program's own until it is freed."""
        return self.kept if self.proxy is None else (self.proxy.sampled(), self.proxy.widths())

    # -- correctness ----------------------------------------------------------
    def sampled_inputs(self):
        """(N, K) sampled records of alive envs, and the (R, K) first-step
        records of every sampled env (the start)."""
        records, columns = self._records()
        alive_rows, firsts = [], []
        w = dict(((s, f), n) for s, f, n in columns)
        done_at = sum(n for (s, f, n) in columns[:-1])  # the last column: out done
        assert columns[-1][1] == "done" and w[("out", "done")] == 1
        for recs in records:                              # (S, R, K)
            firsts.append(recs[0])
            done = recs[:, :, done_at] > 0.5
            dead_before = torch.cumsum(done.to(torch.int32), 0) - done.to(torch.int32)
            alive_rows.append(recs[dead_before == 0])
        rows = torch.cat(alive_rows)
        idx = torch.randperm(rows.shape[0], generator=self.pick)[:PAIRS].to(rows.device)
        return rows[idx], torch.cat(firsts)

    def kernel_inputs(self, env: RefEnv):
        """(qpos, qvel, targets) of 256 rows, live or not, drawn from the
        records of the traced steps (``trace_steps`` of the window's second
        episode; all of it without them)."""
        records, columns = self._records()
        recs = records[min(1, len(records) - 1)]
        lo, hi = self.cell.get("trace_steps", (0, recs.shape[0]))
        rows = recs[lo:hi].reshape(-1, recs.shape[-1])
        idx = torch.randperm(rows.shape[0], generator=torch.Generator().manual_seed(7))[:256]
        s = judge.split(rows[idx.to(rows.device)], columns)
        q, t = s[("in", "qpos")], s[("in", "time")][:, 0]
        return q, s[("in", "qvel")], env.target(q, t, s[("in", "action")])

    def reference(self, device):
        return {"env": RefEnv(self.conf["clip"], self.env_config, device),
                "learner": Learner(self.policy_file, device=device)}

    def numbers(self, ref: dict, control: bool = False) -> dict:
        """The compared numbers: the program's (or, with ``control``, the
        reference's in the lower precision) against the reference's."""
        env, learner = ref["env"], ref["learner"]
        sample, first = self.sampled_inputs()
        columns = self._records()[1]
        s, f = judge.split(sample, columns), judge.split(first, columns)
        inp = {k[1]: v for k, v in s.items() if k[0] == "in"}
        out = {k[1]: v for k, v in s.items() if k[0] == "out"}
        t_in, es_in = inp["time"][:, 0], inp["episode_start"][:, 0]
        with torch.no_grad():
            obs_ref = env.obs(inp["qpos"], inp["qvel"], t_in)
            act_ref = learner.policy_mean(learner.normalize(obs_ref))
            ref_out = env.step(inp["qpos"], inp["qvel"], t_in, es_in, act_ref)
            q0, v0 = env.start(f[("in", "time")][:, 0])
            got_q0, got_v0 = f[("in", "qpos")], f[("in", "qvel")]
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    act = learner.policy_mean(learner.normalize(obs_ref))
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                out = env.step(inp["qpos"], inp["qvel"], t_in, es_in, act)
                inp = {**inp, "obs": obs_ref}
                got_q0, got_v0 = env.start(f[("in", "time")][:, 0], low=True)
            else:
                act = inp["action"]
        nums = judge.step_numbers(inp, act, out, obs_ref, act_ref, ref_out)
        nums["start_gap"] = max(judge.abs_gap(got_q0, q0), judge.rel_gap(got_v0, v0))
        nums["pairs"] = float(sample.shape[0])
        return nums

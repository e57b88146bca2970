"""The port's APG against the benchmark's plain reference
(``benchmark/reference/apg.py``) on the CPU.

Backflip's env config as the benchmark runs it (8 substeps a policy step,
residual targets, pose termination), 4 envs x horizon 2, seeded random
weights (``apg.init``), seeded obs statistics, the action noise (0.1) and
the critic's tail on. The port runs ``apg.loss_and_grad`` and one
``apg.train_step`` on ``MimicVecEnv`` over the engine; the reference runs
its window through the frozen field program from the same entry state,
noise and params, and its update from a fresh optimiser. Compared: the
loss, the policy's gradient (relative 2-norm of the difference over all
leaves) and the params after the update. A planted cut (the middle
step's input state detached, the benchmark's ``step_grad_cut``) breaks
the gradient's tolerance by orders of magnitude.

The reference's window takes about 20 s here (one tensor op per scalar
op of the physics, forward and backward); the port's about 5 s.
"""

import json
import os
import sys

import pytest
import torch

from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import apg
from pbrl_tpu_torch.train.running_stats import RunningStats
from pbrl_tpu_torch.utils.configio import dict_to_config
from pbrl_tpu_torch.utils.tree import map_states

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import apg as ref_apg  # noqa: E402
from benchmark.reference.env import RefEnv  # noqa: E402

B, H = 4, 2
# Tolerances. The engine and the field program compute the same equations
# in another order, agreeing to about 1e-6 relative in a step's state; the
# window's loss is a mean of exp-shaped rewards of those states (measured
# gap 0), and its gradient goes through 16 substeps of stiff contacts,
# which amplify the rounding (measured 6.2e-7). Adam's first update is
# about the sign of each gradient entry, so an entry whose gradient is
# within rounding of 0 may step the other way (measured 5.5e-5 over all
# leaves).
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-3


def relative(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    return (num / sum(float(torch.sum(want[k].double() ** 2)) for k in want)) ** 0.5


@pytest.fixture(scope="module")
def setting():
    with open(os.path.join(ROOT, "benchmark", "configs", "backflip-apg.json")) as f:
        conf = json.load(f)
    ec = conf["env_config"]
    env = MimicVecEnv(humanoid_model(), load_clip("backflip", device="cpu"),
                      dict_to_config(EnvConfig, ec), device="cpu", backend="xla")
    cfg = apg.APGConfig(num_envs=B, horizon=H, action_noise=0.1, value_bootstrap=True,
                        reset_every=1, learning_rate=1e-4, total_env_steps=100 * B * H, seed=3)
    ts = apg.init(env, cfg, "cpu")
    g = torch.Generator().manual_seed(5)
    n = env.observation_size
    ts.obs_stats = RunningStats(count=torch.tensor(1000.0), mean=0.1 * torch.randn(n, generator=g),
                                m2=1000.0 * (0.5 + torch.rand(n, generator=g)))
    noise = torch.randn((H, B, env.action_size), generator=g)
    params = {f"policy/{k}": p.detach().clone() for k, p in ts.policy.named_parameters()}
    value = {f"value/{k}": p.detach().clone() for k, p in ts.value.named_parameters()}
    stats = [ts.obs_stats.count, ts.obs_stats.mean, ts.obs_stats.m2]
    e = ts.env_state
    entry = {"qpos": e.qpos, "qvel": e.qvel, "time": e.time, "episode_start": e.episode_start}
    rcfg = dict(conf["apg_config"], num_envs=B, horizon=H, total_env_steps=100 * B * H)
    loss, grads = ref_apg.loss_and_grad(RefEnv("backflip", ec, "cpu"), params, value, stats,
                                        entry, noise, rcfg)
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    after, *_ = ref_apg.update(params, grads, zeros, dict(zeros), 0, rcfg)
    return {"env": env, "cfg": cfg, "ts": ts, "noise": noise, "params": params,
            "ref": (loss, grads, after)}


def fresh(s):
    """A train state at the setting's params, critic, statistics and entry."""
    ts = apg.init(s["env"], s["cfg"], "cpu")
    for k, p in ts.policy.named_parameters():
        p.data.copy_(s["params"][f"policy/{k}"])
    ts.value.load_state_dict(s["ts"].value.state_dict())
    ts.obs_stats, ts.env_state = s["ts"].obs_stats, s["ts"].env_state
    return ts


def port_grads(ts):
    return {f"policy/{k}": torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in ts.policy.named_parameters()}


def test_loss_and_grad_match_the_reference(setting):
    s = setting
    ts = fresh(s)
    loss, _ = apg.loss_and_grad(s["env"], s["cfg"], ts, s["noise"])
    ref_loss, ref_grads, _ = s["ref"]
    assert abs(float(loss) - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert relative(port_grads(ts), ref_grads) <= GRAD_TOL


def test_train_step_matches_the_reference(setting):
    s = setting
    ts = fresh(s)
    _, metrics = apg.train_step(s["env"], s["cfg"], ts, noise=s["noise"])
    ref_loss, ref_grads, ref_after = s["ref"]
    assert abs(float(metrics["loss"]) - ref_loss) <= LOSS_TOL * abs(ref_loss)
    assert relative(port_grads(ts), ref_grads) <= GRAD_TOL
    before = s["params"]
    after = {f"policy/{k}": p.detach() for k, p in ts.policy.named_parameters()}
    delta = lambda x: {k: x[k] - before[k] for k in before}
    assert relative(delta(after), delta(ref_after)) <= UPDATE_TOL


def test_a_cut_step_fails_the_gradient_tolerance(setting, monkeypatch):
    s = setting
    env, calls = s["env"], [0]
    step = MimicVecEnv.step

    def cut(self, state, action):
        n = calls[0]  # forward steps 0..H-1, then the recomputes, last step first
        calls[0] += 1
        if (n if n < H else 2 * H - 1 - n) == H // 2:
            state = map_states(torch.Tensor.detach, state)
        return step(self, state, action)

    ts = fresh(s)
    monkeypatch.setattr(MimicVecEnv, "step", cut)
    apg.loss_and_grad(env, s["cfg"], ts, s["noise"])
    assert calls[0] == 2 * H
    assert relative(port_grads(ts), s["ref"][1]) > 100 * GRAD_TOL

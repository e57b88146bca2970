"""The port's first PPO iterations on the humanoid against pbrl_tpu's.

At the walk run's learner settings (``ckpts/walk/run_config.json``: 1024-512
swish MLPs, 4 epochs x 8 minibatches, lr 1e-4 decayed, entropy cost 0) and
its env config, cut to 4 envs x 4 steps so that the CPU runs it in about a
minute: pbrl_tpu's ``train_step`` (its einsum engine, jitted) and the
port's (the plain version of the policy-step kernel) start from the same
flax init and env states, are fed the same draws (action noise, auto-reset
start times and per-epoch permutations, re-derived with pbrl_tpu's key
splits, ``ppo.py:166,236-238``) and run two iterations. Every metric, the
obs statistics and every parameter must agree.

The first iteration's ``kl_approx`` is large on both sides (109.146), and
the stats' update opens almost all of it before any step (107.992): the
loss normalises the obs with the stats the rollout just updated, while the
rollout sampled with the initial ones (count 0, mean 0, m2 1).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu.train import ppo as jppo
from pbrl_tpu.utils.configio import dict_to_config as j_dict_to_config
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import networks, optim, ppo, running_stats
from pbrl_tpu_torch.train.checkpoint import flax_state_dict
from pbrl_tpu_torch.utils.configio import dict_to_config

RUN_CONFIG = os.path.join(os.path.dirname(__file__), "..", "ckpts", "walk", "run_config.json")
B, T = 4, 4


class _FedResets:
    """The port's env with its auto-reset start times taken in turn from
    ``t0s`` (one (B,) tensor per rollout step)."""

    def __init__(self, env, t0s):
        self.env, self.t0s = env, list(t0s)
        self.observation_size, self.action_size = env.observation_size, env.action_size

    def step(self, state, action):
        return self.env.step(state, action)

    def auto_reset(self, state, generator=None):
        return self.env.auto_reset(state, t0=self.t0s.pop(0))


def _draws(jenv, reset, rng, cfg):
    """What pbrl_tpu's train_step draws from its train state's key: the
    action noise (T, B, nu), the auto-reset start times (T, B) and the
    per-epoch permutations."""
    noise, t0s, perms = [], [], []
    for _ in range(cfg.unroll_length):
        rng, k_act, k_reset = jax.random.split(rng, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (B, jenv.action_size))))
        t0s.append(torch.from_numpy(np.array(reset(jax.random.split(k_reset, B)).time)))
    for _ in range(cfg.update_epochs):
        rng, k = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k, B * cfg.unroll_length)))
    return torch.from_numpy(np.stack(noise)), t0s, torch.from_numpy(np.stack(perms))


def test_first_iterations_on_humanoid_match_pbrl_tpu():
    """Measured differences at most: metrics 9e-6 absolute (``loss_policy``,
    1.39) and 1.8e-5 relative (``root_err``); obs mean 1.8e-6 absolute, m2
    1.6e-6 relative; params 3.5e-6 (the value net's first layer: Adam
    normalises near-zero gradients). The bounds are about 10x those. Both
    sides give ``reward_mean`` 0.7075 at iteration 0 and 0.2231 after the
    first update."""
    with open(RUN_CONFIG) as f:
        run = json.load(f)
    train = dict(run["train_config"], num_envs=B, unroll_length=T,
                 total_env_steps=B * T * 1000)
    jcfg = j_dict_to_config(jppo.TrainConfig, train)
    cfg = dict_to_config(ppo.TrainConfig, train)
    assert cfg.hidden == (1024, 512) and cfg.num_minibatches == 8 and cfg.update_epochs == 4
    walk = augment_clip(humanoid_model(), load_clip("walk", device="cpu"))
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    jenv = JMimicVecEnv(j_humanoid(), jc, j_dict_to_config(JEnvConfig, run["env_config"]),
                        backend="xla")
    tenv = MimicVecEnv(humanoid_model(), walk, dict_to_config(EnvConfig, run["env_config"]),
                       device="cpu")

    init, step, _ = jppo.make_train_functions(jenv, jcfg)
    # flax's init leaves log_std weak-typed and the first update does not:
    # strong types keep the second call from compiling again
    jts = jax.tree_util.tree_map(lambda x: jnp.array(x, dtype=x.dtype),
                                 init(jax.random.PRNGKey(0)))
    step, reset = jax.jit(step), jax.jit(jenv.reset)
    params = jax.tree_util.tree_map(np.asarray, jts.params)
    policy = networks.PolicyNetwork(tenv.observation_size, tenv.action_size, cfg.hidden)
    value = networks.ValueNetwork(tenv.observation_size, cfg.hidden)
    policy.load_state_dict(flax_state_dict(params["policy"]))
    value.load_state_dict(flax_state_dict(params["value"]))
    ts = ppo.TrainState(
        policy=policy, value=value,
        opt=optim.Adam(cfg.learning_rate, cfg.max_grad_norm, cfg.total_updates),
        obs_stats=running_stats.init(tenv.observation_size, "cpu"),
        env_state=tenv.reset(B, t0=torch.from_numpy(np.array(jts.env_state.time))),
        generator=torch.Generator(), env_steps=0)
    np.testing.assert_allclose(ts.env_state.obs.numpy(), np.asarray(jts.env_state.obs),
                               atol=1e-6)

    for it in range(2):
        noise, t0s, perms = _draws(jenv, reset, jts.rng, jcfg)
        jts, jmetrics = step(jts)
        env_state, traj = ppo.rollout(_FedResets(tenv, t0s), cfg, ts, noise)
        # the KL that the stats' update alone opens, before any step
        with torch.no_grad():
            zero = torch.zeros_like(traj.reward)
            _, shift = ppo.loss_fn(ts.policy, ts.value, cfg, traj, zero, zero,
                                   running_stats.update(ts.obs_stats, traj.obs))
        metrics = ppo.learn(cfg, ts, env_state, traj, perms)
        if it == 0:
            assert float(shift["kl_approx"]) > 0.9 * float(jmetrics["kl_approx"]) > 50.0
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-4,
                                       atol=2e-5, err_msg=f"iteration {it}: {k}")
        got, want = ts.obs_stats, jts.obs_stats
        assert float(got.count) == float(want.count) == (it + 1) * B * T
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=2e-5, rtol=0,
                                   err_msg=f"iteration {it}: obs mean")
        np.testing.assert_allclose(got.m2.numpy(), np.asarray(want.m2), rtol=2e-5,
                                   err_msg=f"iteration {it}: obs m2")
        for name, net in (("policy", ts.policy), ("value", ts.value)):
            want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jts.params[name]))
            got = net.state_dict()
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=4e-5, rtol=0,
                                           err_msg=f"iteration {it}: {name}.{k}")
    assert ts.opt.count == int(jts.opt_state[1][0].count) == 2 * 4 * 8

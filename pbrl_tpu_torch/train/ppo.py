"""PPO over the vectorized env, and deterministic evaluation.

Counterpart of ``pbrl_tpu/train/ppo.py``: the same ``TrainConfig``, GAE,
clipped-surrogate loss, observation normalisation, minibatch epochs and
optimiser (:mod:`pbrl_tpu_torch.train.optim`), run eagerly on one device.
Every rollout step is one ``env.step`` (for ``MimicVecEnv``: one launch of
the policy-step kernel on the card) and one ``env.auto_reset``.

Random draws (action noise, resets, the per-epoch permutations) come from
the ``torch.Generator`` in the train state, on the run's device.
:func:`rollout` and :func:`learn` also take the draws as arguments, so
that a test can feed in pbrl_tpu's.

One deliberate difference from pbrl_tpu's ``train``: that runs
``num_iterations // steps_per_call`` fused calls and drops the remainder
iterations while still numbering the final checkpoint
``it0 + num_iterations``. Here every iteration runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from pbrl_tpu_torch.train import checkpoint as ckpt
from pbrl_tpu_torch.train import networks, optim, running_stats


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_envs: int = 2048
    unroll_length: int = 16
    num_minibatches: int = 8
    update_epochs: int = 4
    learning_rate: float = 3e-4
    lr_decay: bool = True        # linear decay to 1% of the rate over the run
    gamma: float = 0.95          # DeepMimic's discount
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    entropy_cost: float = 1e-3
    value_cost: float = 0.5
    max_grad_norm: float = 0.5
    normalize_obs: bool = True
    hidden: tuple = (1024, 512)
    total_env_steps: int = 10_000_000
    seed: int = 0
    reward_scale: float = 1.0
    # Exploration std: exp(init_log_std) rad on the PD-target action.
    # fixed_log_std freezes the std at the param's current value (the init
    # on fresh runs, the restored value when resuming); reset_log_std
    # overwrites a restored log_std with init_log_std.
    init_log_std: float = -1.0
    fixed_log_std: bool = False
    reset_log_std: bool = False

    @property
    def steps_per_iteration(self) -> int:
        return self.num_envs * self.unroll_length

    @property
    def num_iterations(self) -> int:
        return max(1, self.total_env_steps // self.steps_per_iteration)

    @property
    def total_updates(self) -> int:
        """Optimiser updates of a whole run: the decay's length."""
        return self.num_iterations * self.update_epochs * self.num_minibatches


@dataclasses.dataclass
class Transition:
    obs: torch.Tensor       # raw (un-normalised) observations
    action: torch.Tensor
    log_prob: torch.Tensor
    reward: torch.Tensor    # scaled by reward_scale
    done: torch.Tensor
    value: torch.Tensor


@dataclasses.dataclass
class TrainState:
    policy: networks.PolicyNetwork
    value: networks.ValueNetwork
    opt: optim.Adam
    obs_stats: running_stats.RunningStats
    env_state: object                  # the env's batched state
    generator: torch.Generator
    env_steps: int

    def params(self) -> Dict[str, torch.nn.Parameter]:
        """Every trained parameter as one tree, named like the checkpoint's."""
        return {**{f"policy/{k}": p for k, p in self.policy.named_parameters()},
                **{f"value/{k}": p for k, p in self.value.named_parameters()}}


def compute_gae(rewards, dones, values, bootstrap_value, gamma, lam):
    """GAE over a (T, B) rollout; ``dones`` terminate the bootstrap chain."""
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + gamma * (1.0 - dones) * values_tp1 - values
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * (1.0 - dones[t]) * carry
        adv[t] = carry
    return adv, adv + values


def _norm_obs(config: TrainConfig, stats, obs):
    return running_stats.normalize(stats, obs) if config.normalize_obs else obs


def init(env, config: TrainConfig, device="cuda") -> TrainState:
    """Fresh networks (flax's initialisers), optimiser, obs stats and env
    batch; the draws come from a generator on ``device`` seeded with
    ``config.seed``, which the train state keeps."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    policy, value = networks.init_params(
        env.observation_size, env.action_size, config.hidden,
        init_log_std=config.init_log_std, fixed_log_std=config.fixed_log_std,
        generator=generator, device=device)
    opt = optim.Adam(config.learning_rate, config.max_grad_norm,
                     config.total_updates if config.lr_decay else 0)
    return TrainState(policy=policy, value=value, opt=opt,
                      obs_stats=running_stats.init(env.observation_size, device),
                      env_state=env.reset(config.num_envs, generator),
                      generator=generator, env_steps=0)


@torch.no_grad()
def rollout(env, config: TrainConfig, ts: TrainState, noise: Optional[torch.Tensor] = None):
    """``unroll_length`` steps of the stochastic policy with auto-reset.
    Obs are normalised with the stats at the start of the rollout.
    ``noise`` (T, B, nu), when given, is the standard-normal action draw.
    Returns (final env state, Transition of (T, B, ...) tensors)."""
    state = ts.env_state
    steps = []
    for t in range(config.unroll_length):
        obs_n = _norm_obs(config, ts.obs_stats, state.obs)
        mean, log_std = ts.policy(obs_n)
        action = networks.sample_action(mean, log_std, ts.generator,
                                        None if noise is None else noise[t])
        lp = networks.log_prob(mean, log_std, action)
        val = ts.value(obs_n)
        nstate = env.step(state, action)
        steps.append(Transition(obs=state.obs, action=action, log_prob=lp,
                                reward=nstate.reward * config.reward_scale,
                                done=nstate.done, value=val))
        state = env.auto_reset(nstate, ts.generator)
    traj = Transition(**{f.name: torch.stack([getattr(s, f.name) for s in steps])
                         for f in dataclasses.fields(Transition)})
    return state, traj


def loss_fn(policy, value, config: TrainConfig, batch: Transition, adv, ret, obs_stats):
    """PPO loss of one minibatch: (total, aux)."""
    obs_n = _norm_obs(config, obs_stats, batch.obs)
    mean, log_std = policy(obs_n)
    lp = networks.log_prob(mean, log_std, batch.action)
    ratio = torch.exp(lp - batch.log_prob)
    adv_n = (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + 1e-8)
    surrogate = torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - config.clip_epsilon, 1 + config.clip_epsilon) * adv_n)
    policy_loss = -torch.mean(surrogate)
    v = value(obs_n)
    value_loss = torch.mean((v - ret) ** 2)
    ent = torch.mean(networks.entropy(log_std))
    total = policy_loss + config.value_cost * value_loss - config.entropy_cost * ent
    return total, {"loss_policy": policy_loss, "loss_value": value_loss, "entropy": ent,
                   "kl_approx": torch.mean(batch.log_prob - lp)}


def learn(config: TrainConfig, ts: TrainState, env_state, traj: Transition,
          perms: Optional[torch.Tensor] = None):
    """The update half of one iteration: obs stats from the rollout, GAE
    (bootstrap with the pre-update value net and the new stats), then
    ``update_epochs`` passes over ``num_minibatches`` minibatches of a
    fresh permutation each (``perms`` (epochs, T*B) when given).
    Updates ``ts`` in place and returns the iteration's metrics as 0-d
    tensors."""
    obs_stats = (running_stats.update(ts.obs_stats, traj.obs)
                 if config.normalize_obs else ts.obs_stats)
    with torch.no_grad():
        bootstrap = ts.value(_norm_obs(config, obs_stats, env_state.obs))
    adv, ret = compute_gae(traj.reward, traj.done, traj.value, bootstrap,
                           config.gamma, config.gae_lambda)

    flat = Transition(**{f.name: getattr(traj, f.name).flatten(0, 1)
                         for f in dataclasses.fields(Transition)})
    adv_f, ret_f = adv.reshape(-1), ret.reshape(-1)
    n = adv_f.shape[0]
    mb = n // config.num_minibatches
    params = ts.params()
    auxes = []
    for epoch in range(config.update_epochs):
        perm = (perms[epoch] if perms is not None else
                torch.randperm(n, generator=ts.generator, device=adv_f.device))
        perm = perm[:config.num_minibatches * mb].reshape(config.num_minibatches, mb)
        for idx in perm:
            batch = Transition(**{f.name: getattr(flat, f.name)[idx]
                                  for f in dataclasses.fields(Transition)})
            for p in params.values():
                p.grad = None
            total, aux = loss_fn(ts.policy, ts.value, config, batch, adv_f[idx],
                                 ret_f[idx], obs_stats)
            total.backward()
            ts.opt.step(params)
            auxes.append(aux)

    metrics = {
        "reward_mean": torch.mean(traj.reward) / config.reward_scale,
        "episode_done_frac": torch.mean(traj.done),
        **{k: torch.mean(torch.stack([a[k] for a in auxes])).detach() for k in auxes[0]},
        **{k: torch.mean(v) for k, v in env_state.metrics.items()},
    }
    ts.obs_stats = obs_stats
    ts.env_state = env_state
    ts.env_steps += config.steps_per_iteration
    return metrics


def train_step(env, config: TrainConfig, ts: TrainState,
               noise: Optional[torch.Tensor] = None, perms: Optional[torch.Tensor] = None):
    """One PPO iteration (rollout, then learn); updates ``ts`` in place and
    returns (ts, metrics)."""
    env_state, traj = rollout(env, config, ts, noise)
    return ts, learn(config, ts, env_state, traj, perms)


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(env, config: TrainConfig = TrainConfig(), progress_fn: Optional[Callable] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
          device="cuda"):
    """Run PPO for ``config.num_iterations`` iterations; returns
    (train state, metrics history).

    With ``checkpoint_dir``: the run config is written there, the latest
    checkpoint (if any) is restored and its step numbering continued, and a
    checkpoint is kept every ``checkpoint_every`` iterations and at the
    end. Each history entry (also passed to ``progress_fn(iteration,
    entry)``) holds the iteration's metrics, this run's ``env_steps``,
    ``sps`` (env steps per second since the start, learner included) and
    the iteration's ``rollout_s`` and ``learn_s``.
    """
    device = torch.device(device)
    ts = init(env, config, device)
    it0 = 0
    if checkpoint_dir:
        ckpt.save_run_config(checkpoint_dir, env, config)
        last = ckpt.latest_step(checkpoint_dir)
        if last is not None:
            ckpt.restore_into(ts, ckpt.restore(checkpoint_dir, last, device=device))
            if config.reset_log_std:
                with torch.no_grad():
                    ts.policy.log_std.fill_(config.init_log_std)
            # continue the numbering: latest_step is the largest step
            it0 = int(last)

    history = []
    saved = None
    _synchronize(device)
    t0 = time.perf_counter()
    for it in range(config.num_iterations):
        ta = time.perf_counter()
        env_state, traj = rollout(env, config, ts)
        _synchronize(device)
        tb = time.perf_counter()
        metrics = learn(config, ts, env_state, traj)
        values = torch.stack(list(metrics.values())).tolist()  # one copy to the host
        tc = time.perf_counter()
        entry = dict(zip(metrics, values))
        entry["env_steps"] = (it + 1) * config.steps_per_iteration
        entry["sps"] = entry["env_steps"] / (tc - t0)
        entry["rollout_s"], entry["learn_s"] = tb - ta, tc - tb
        history.append(entry)
        if progress_fn is not None:
            progress_fn(it, entry)
        if checkpoint_dir and (it + 1) % max(1, checkpoint_every) == 0:
            saved = it0 + it + 1
            ckpt.save(checkpoint_dir, ts, step=saved)
    if checkpoint_dir and saved != it0 + config.num_iterations:
        ckpt.save(checkpoint_dir, ts, step=it0 + config.num_iterations)
    return ts, history



# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def alive_masked_metrics(rew: torch.Tensor, done: torch.Tensor, perr: torch.Tensor):
    """(T, B) rollouts -> eval metrics. A step counts while no earlier-or-
    current step of its env was done (``alive = cumprod(1 - done)``)."""
    alive = torch.cumprod(1.0 - done, dim=0)
    live = torch.clamp(torch.sum(alive), min=1.0)
    return {
        "eval_reward": torch.sum(rew * alive) / live,
        "eval_episode_length": torch.mean(torch.sum(alive, dim=0)),
        "eval_pose_error": torch.sum(perr * alive) / live,
    }


@torch.no_grad()
def evaluate(env, policy, obs_stats, num_envs: int = 128, num_steps: int = 256,
             generator: Optional[torch.Generator] = None,
             t0: Optional[torch.Tensor] = None, normalize_obs: bool = True):
    """Deterministic-policy rollout (mean action, no auto-reset); returns
    mean live reward, mean episode length and mean live pose error."""
    state = env.reset(num_envs, generator, t0=t0)
    rews, dones, perrs = [], [], []
    for _ in range(num_steps):
        obs = running_stats.normalize(obs_stats, state.obs) if normalize_obs else state.obs
        mean, _ = policy(obs)
        state = env.step(state, mean)
        rews.append(state.reward)
        dones.append(state.done)
        perrs.append(state.metrics.get("pose_error", torch.zeros_like(state.reward)))
    return alive_masked_metrics(torch.stack(rews), torch.stack(dones), torch.stack(perrs))

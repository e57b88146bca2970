"""PPO over the vectorized env, and deterministic evaluation.

Counterpart of ``pbrl_tpu/train/ppo.py``: the same ``TrainConfig``, GAE,
clipped-surrogate loss, observation normalisation, minibatch epochs and
optimiser (:mod:`pbrl_tpu_torch.train.optim`), run eagerly on one device.
Every rollout step is one ``env.step`` (for ``MimicVecEnv``: one launch of
the policy-step kernel on the card) and one ``env.auto_reset``. A per-env
env (no ``is_vectorized``, e.g. ``MimicEnv``, whose state holds engine
``Data``) has no ``auto_reset``: as in pbrl_tpu, a fresh batch is reset
and taken where the step ended an episode, and the finished step's
reward, done and metrics are kept. Such an env is batched already, so
nothing is vmapped; it carries no mesh, so it trains in one process.
:func:`make_train_functions` binds ``init``, ``train_step`` and
``evaluate`` to an env and a config, as pbrl_tpu's does.

Random draws (action noise, resets, the per-epoch permutations) come from
the ``torch.Generator`` in the train state, on the run's device.
:func:`rollout` and :func:`learn` also take the draws as arguments, so
that a test can feed in pbrl_tpu's.

Data parallelism: with an env built on a :class:`~pbrl_tpu_torch.parallel.
Mesh` of ``n`` ranks, each rank steps its ``num_envs / n`` rows of the batch
and the ranks together compute pbrl_tpu's global step, as XLA runs it
over a sharded batch. Every rank seeds the same generator, draws the whole
batch's action noise (and, in the env, its reset draws) and keeps its
rows; every rank draws the same permutation of all ``T * num_envs``
samples, and takes the entries of each minibatch whose env it holds, so
its share of a minibatch varies. Each loss mean becomes a rank's sum over
the whole minibatch's size (:func:`shard_loss_fn`), the advantage's mean
and population std over each minibatch are all-reduced, the entropy term
enters on one rank only, and one all-reduce of one flat buffer per
minibatch sums the gradients (policy and value) and the loss metrics
before the optimiser's clip. The obs statistics and the iteration's
metrics are those of the whole batch, and the parameters stay bit-equal on
every rank. Only the primary process writes the run config, checkpoints
and progress. One process keeps :func:`loss_fn` and its means, so that its
training rounds as it did before data parallelism, bit for bit.

One deliberate difference from pbrl_tpu's ``train``: that runs
``num_iterations // steps_per_call`` fused calls and drops the remainder
iterations while still numbering the final checkpoint
``it0 + num_iterations``. Here every iteration runs.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from pbrl_tpu_torch.envs.base import where_states
from pbrl_tpu_torch.parallel.mesh import SINGLE, Mesh, mesh_of
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
    env_steps: int                     # the whole batch's
    mesh: Mesh = SINGLE                # the data-parallel ranks (the env's)

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
    batch (this rank's rows of it); the draws come from a generator on
    ``device`` seeded with ``config.seed``, which the train state keeps."""
    device = torch.device(device)
    mesh = mesh_of(env)
    mesh.local(config.num_envs)  # raises unless the ranks split the batch evenly
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
                      generator=generator, env_steps=0, mesh=mesh)


def reset_done(nstate, fresh):
    """A per-env env's auto-reset (pbrl_tpu's, ``ppo.py:145-155``): the
    ``fresh`` state where ``nstate`` is done, ``nstate`` elsewhere, with
    ``nstate``'s reward, done and metrics kept."""
    merged = where_states(nstate.done > 0, fresh, nstate)
    return dataclasses.replace(merged, reward=nstate.reward, done=nstate.done,
                               metrics=nstate.metrics)


@torch.no_grad()
def rollout(env, config: TrainConfig, ts: TrainState, noise: Optional[torch.Tensor] = None):
    """``unroll_length`` steps of the stochastic policy with auto-reset.
    Obs are normalised with the stats at the start of the rollout.
    ``noise`` (T, num_envs, nu), when given, is the standard-normal action
    draw of the whole batch, as the generator's draw otherwise is; this
    rank's rows of it move its envs. Returns (final env state, Transition of
    (T, B, ...) tensors of this rank's B envs)."""
    state = ts.env_state
    mesh = ts.mesh
    vectorized = getattr(env, "is_vectorized", False)
    steps = []
    for t in range(config.unroll_length):
        obs_n = _norm_obs(config, ts.obs_stats, state.obs)
        mean, log_std = ts.policy(obs_n)
        eps = noise[t] if noise is not None else torch.randn(
            (config.num_envs, mean.shape[1]), generator=ts.generator, device=mean.device)
        action = networks.sample_action(mean, log_std, noise=mesh.rows(eps))
        lp = networks.log_prob(mean, log_std, action)
        val = ts.value(obs_n)
        nstate = env.step(state, action)
        steps.append(Transition(obs=state.obs, action=action, log_prob=lp,
                                reward=nstate.reward * config.reward_scale,
                                done=nstate.done, value=val))
        if vectorized:
            state = env.auto_reset(nstate, ts.generator)
        else:
            state = reset_done(nstate, env.reset(config.num_envs, ts.generator))
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


def shard_loss_fn(policy, value, config: TrainConfig, batch: Transition, adv, ret, obs_stats,
                  adv_mean, adv_std, size: int, with_entropy: bool):
    """One rank's share of a data-parallel minibatch's loss: :func:`loss_fn`
    with each mean over the minibatch written as this rank's sum over its
    whole ``size``, the advantage normalised by the whole minibatch's
    ``adv_mean`` and ``adv_std``, and the entropy term (state-independent)
    on the rank that passes ``with_entropy`` only. Summed over the ranks,
    the losses and their gradients are :func:`loss_fn`'s. Returns (this
    rank's loss, its shares of (loss_policy, loss_value, kl_approx), the
    entropy)."""
    obs_n = _norm_obs(config, obs_stats, batch.obs)
    mean, log_std = policy(obs_n)
    lp = networks.log_prob(mean, log_std, batch.action)
    ratio = torch.exp(lp - batch.log_prob)
    adv_n = (adv - adv_mean) / (adv_std + 1e-8)
    surrogate = torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - config.clip_epsilon, 1 + config.clip_epsilon) * adv_n)
    policy_loss = -torch.sum(surrogate) / size
    value_loss = torch.sum((value(obs_n) - ret) ** 2) / size
    ent = networks.entropy(policy.clamped_log_std())
    total = policy_loss + config.value_cost * value_loss
    if with_entropy:
        total = total - config.entropy_cost * ent
    shares = torch.stack([policy_loss, value_loss, torch.sum(batch.log_prob - lp) / size])
    return total, shares.detach(), ent.detach()


def _shard_minibatches(mesh: Mesh, perms, batch: int, adv_f):
    """Per minibatch (rows of ``perms``, sample indices ``t * B + b`` of
    the whole (T, B) rollout), this rank's entries as indices into its
    flattened (T, batch) rollout, and the whole minibatch's advantage mean
    and population std (two all-reduces for all minibatches; one host
    sync)."""
    n_mb, size = perms.shape
    whole = batch * mesh.world
    t, b = perms // whole, perms % whole - mesh.rank * batch
    own = (b >= 0) & (b < batch)
    local = torch.where(own, t * batch + b, 0)
    vals = torch.where(own, adv_f[local], 0.0)
    mean = mesh.all_reduce(torch.sum(vals, dim=1)) / size
    sq = torch.where(own, (vals - mean[:, None]) ** 2, 0.0)
    std = torch.sqrt(mesh.all_reduce(torch.sum(sq, dim=1)) / size)
    entries = torch.split(local[own], own.sum(dim=1).tolist())
    return entries, mean, std


def _all_reduce_grads(mesh: Mesh, params, extra: torch.Tensor) -> torch.Tensor:
    """Sum every parameter's gradient and ``extra`` over the ranks with one
    all-reduce of one flat buffer; returns the summed ``extra``."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads] + [extra]))
    off = 0
    for p, g in zip(params.values(), grads):
        p.grad = flat[off:off + g.numel()].view_as(g)
        off += g.numel()
    return flat[off:]


def _batch_means(mesh: Mesh, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean of each tensor over the whole batch: one all-reduce of the
    ranks' sums (their shares are of one size)."""
    if mesh.world == 1:
        return {k: torch.mean(v) for k, v in values.items()}
    sums = mesh.all_reduce(torch.stack([torch.sum(v) for v in values.values()]))
    return {k: sums[i] / (v.numel() * mesh.world) for i, (k, v) in enumerate(values.items())}


def learn(config: TrainConfig, ts: TrainState, env_state, traj: Transition,
          perms: Optional[torch.Tensor] = None):
    """The update half of one iteration: obs stats from the rollout, GAE
    (bootstrap with the pre-update value net and the new stats), then
    ``update_epochs`` passes over ``num_minibatches`` minibatches of a
    fresh permutation each of the whole batch's samples (``perms``
    (epochs, T*num_envs) when given). Updates ``ts`` in place and returns
    the iteration's metrics as 0-d tensors."""
    mesh = ts.mesh
    obs_stats = (running_stats.update(ts.obs_stats, traj.obs, mesh.group)
                 if config.normalize_obs else ts.obs_stats)
    with torch.no_grad():
        bootstrap = ts.value(_norm_obs(config, obs_stats, env_state.obs))
    adv, ret = compute_gae(traj.reward, traj.done, traj.value, bootstrap,
                           config.gamma, config.gae_lambda)

    flat = Transition(**{f.name: getattr(traj, f.name).flatten(0, 1)
                         for f in dataclasses.fields(Transition)})
    adv_f, ret_f = adv.reshape(-1), ret.reshape(-1)
    n = adv_f.shape[0] * mesh.world  # the whole batch's samples
    mb = n // config.num_minibatches
    if perms is None:
        perms = torch.stack([torch.randperm(n, generator=ts.generator, device=adv_f.device)
                             for _ in range(config.update_epochs)])
    perms = perms[:, :config.num_minibatches * mb].reshape(-1, mb).to(adv_f.device)
    if mesh.world > 1:
        entries, adv_mean, adv_std = _shard_minibatches(mesh, perms, traj.reward.shape[1], adv_f)
    params = ts.params()
    auxes = []
    for j in range(perms.shape[0]):
        idx = perms[j] if mesh.world == 1 else entries[j]
        batch = Transition(**{f.name: getattr(flat, f.name)[idx]
                              for f in dataclasses.fields(Transition)})
        for p in params.values():
            p.grad = None
        if mesh.world == 1:
            total, aux = loss_fn(ts.policy, ts.value, config, batch, adv_f[idx],
                                 ret_f[idx], obs_stats)
            total.backward()
        else:
            total, shares, ent = shard_loss_fn(
                ts.policy, ts.value, config, batch, adv_f[idx], ret_f[idx], obs_stats,
                adv_mean[j], adv_std[j], mb, with_entropy=mesh.rank == 0)
            total.backward()
            shares = _all_reduce_grads(mesh, params, shares)
            aux = {"loss_policy": shares[0], "loss_value": shares[1], "entropy": ent,
                   "kl_approx": shares[2]}
        ts.opt.step(params)
        auxes.append(aux)

    means = _batch_means(mesh, {"reward_mean": traj.reward, "episode_done_frac": traj.done,
                                **env_state.metrics})
    means["reward_mean"] = means["reward_mean"] / config.reward_scale
    metrics = {
        "reward_mean": means.pop("reward_mean"),
        "episode_done_frac": means.pop("episode_done_frac"),
        **{k: torch.mean(torch.stack([a[k] for a in auxes])).detach() for k in auxes[0]},
        **means,
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


def make_train_functions(env, config: TrainConfig):
    """(init_fn(device="cuda"), train_step_fn(ts, ...), eval_fn(policy,
    obs_stats, ...)) bound to ``env`` and ``config``, as pbrl_tpu's
    ``make_train_functions`` returns them: :func:`init`, :func:`train_step`
    and :func:`evaluate`, for a vectorized or a per-env env."""
    return (functools.partial(init, env, config), functools.partial(train_step, env, config),
            functools.partial(evaluate, env, normalize_obs=config.normalize_obs))


def same_checkpoint(mesh: Mesh, step: Optional[int], device) -> None:
    """Raise unless every rank restores the same checkpoint step (None:
    none), as it must to stay replicated: one directory for all ranks."""
    if mesh.world == 1:
        return
    s = -1.0 if step is None else float(step)
    got = mesh.all_reduce(torch.tensor([s, -s], dtype=torch.float64, device=device),
                          dist.ReduceOp.MAX).tolist()
    if got[0] != -got[1]:
        raise ValueError("the ranks found different checkpoints to resume from: give every "
                         "rank the same checkpoint directory")


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

    Data-parallel (the env's mesh has several ranks): every rank runs this
    and holds the same history, whose times are the slowest rank's; only
    the primary rank writes the run config and checkpoints and calls
    ``progress_fn``, and every rank restores the checkpoint.
    """
    device = torch.device(device)
    ts = init(env, config, device)
    primary = ts.mesh.rank == 0
    it0 = 0
    if checkpoint_dir:
        if primary:
            ckpt.save_run_config(checkpoint_dir, env, config)
        last = ckpt.latest_step(checkpoint_dir)
        same_checkpoint(ts.mesh, last, device)
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
        seconds = [tb - ta, tc - tb, tc - t0]
        if ts.mesh.world > 1:  # the slowest rank's
            seconds = ts.mesh.all_reduce(torch.tensor(seconds, dtype=torch.float64,
                                                      device=device), dist.ReduceOp.MAX).tolist()
        entry = dict(zip(metrics, values))
        entry["env_steps"] = (it + 1) * config.steps_per_iteration
        entry["sps"] = entry["env_steps"] / seconds[2]
        entry["rollout_s"], entry["learn_s"] = seconds[0], seconds[1]
        history.append(entry)
        if progress_fn is not None and primary:
            progress_fn(it, entry)
        if checkpoint_dir and (it + 1) % max(1, checkpoint_every) == 0:
            saved = it0 + it + 1
            if primary:
                ckpt.save(checkpoint_dir, ts, step=saved)
    if checkpoint_dir and saved != it0 + config.num_iterations and primary:
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

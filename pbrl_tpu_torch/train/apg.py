"""Analytic policy gradients (APG, SHAC-style) through the differentiable
engine (counterpart of ``pbrl_tpu/train/apg.py``).

The trainer follows the exact gradient of a short window's DeepMimic
return, backpropagated by autograd through ``MimicVecEnv.step`` on the
einsum engine (``backend="xla"``), instead of PPO's likelihood-ratio
estimate of it:

* windows of ``horizon`` policy steps; the entry state is detached
  (truncation) and, with ``remat``, each policy step is rematerialised
  (``torch.utils.checkpoint``), so backward memory is one step deep;
* ``L = -E_b[sum_t gamma^t r_t alive_t + gamma^H V(s_H) alive_H] / H``
  with a FROZEN critic (no gradient to its weights, a differentiable
  input); ``done`` is detached, rewards after termination are masked;
* the policy mean as the action, plus ``action_noise`` times a normal draw
  (reparameterised, so it stays differentiable);
* a per-env env (``MimicEnv``, whose state holds engine ``Data`` and its
  ``Contact``) trains alike: its state is detached and restarted leaf by
  leaf (:func:`~pbrl_tpu_torch.envs.base.where_states`), as pbrl_tpu's
  tree map does;
* only the policy is updated, by ``optim.Adam`` with ``zero_nans``, the
  global-norm clip and the linear decay over ``num_iterations``; the
  critic and the obs statistics ride along, so an APG run is evaluated and
  resumed like a PPO run.

Spans and counters (on while a profiler records): ``apg/forward``,
``apg/backward`` and ``apg/update`` around an iteration's phases;
``apg/step`` around each window step, in the forward and again in each of
the checkpoint's recomputes inside the backward; ``apg/loss`` around the
value tail and the mean. Counter ``apg/recomputes``: the window steps
recomputed in the backward (``optim.Adam`` counts ``apg/nonfinite_grad``).

The policy-step kernel has no backward (pbrl_tpu's Pallas kernel defines no
VJP), so a ``MimicVecEnv`` on the kernel backend is refused. The window
runs in full f32 (:func:`~pbrl_tpu_torch.maths.numeric.full_f32`), its
backward included, whatever the process-wide TF32 setting.

Random draws come from the train state's ``torch.Generator``. The action
noise of a window is drawn before it and passed in: the checkpoint's
recompute replays only the global RNG, so a draw inside a rematerialised
step would give the recompute other noise and a wrong gradient.
:func:`train_step` also takes the noise and the reset states as arguments,
so that a test can feed in pbrl_tpu's.

Data parallelism follows PPO's (:mod:`pbrl_tpu_torch.train.ppo`): on an
env built on a mesh of ``n`` ranks each rank runs its rows of the batch
through the window, from the whole batch's draws (noise, resets); its loss
is its share (its window sum over the whole ``num_envs``), and one
all-reduce of one flat buffer sums the policy's gradients, the loss and
the metrics before ``zero_nans`` and the clip. The obs statistics take the
window's observations of all ranks; only the primary rank writes the run
config and checkpoints and calls ``progress_fn``.

Deliberate differences from pbrl_tpu's ``train``: every one of
``num_iterations`` runs (pbrl_tpu drops ``num_iterations %
steps_per_call``), the final checkpoint is labelled with the iterations
run, and a checkpoint is saved whenever the iteration count crosses a
multiple of ``checkpoint_every`` (pbrl_tpu rounds the cadence to
``steps_per_call``). ``env_steps`` is a Python int: pbrl_tpu's int32 wraps
(and ``reset_every``'s phase is read from it, as there).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from pbrl_tpu_torch.envs.base import where_states
from pbrl_tpu_torch.maths.numeric import full_f32
from pbrl_tpu_torch.parallel.mesh import mesh_of, shard_batch
from pbrl_tpu_torch.train import checkpoint as ckpt
from pbrl_tpu_torch.train import networks, optim, ppo, running_stats
from pbrl_tpu_torch.utils.configio import save_json_config
from pbrl_tpu_torch.utils.profiling import count, profile_scope, trace_annotation
from pbrl_tpu_torch.utils.tree import map_states


@dataclasses.dataclass(frozen=True)
class APGConfig:
    num_envs: int = 256
    horizon: int = 32            # truncated-BPTT window, in policy steps
    learning_rate: float = 2e-5
    lr_decay: bool = True
    gamma: float = 0.95
    value_bootstrap: bool = True  # the frozen critic closes the horizon
    action_noise: float = 0.0     # reparameterised exploration std (rad)
    max_grad_norm: float = 1.0
    normalize_obs: bool = True
    update_obs_stats: bool = False  # fine-tunes keep the PPO stats frozen
    # Demonstration replay (DiffMimic, Ren et al. 2023): reset the whole
    # batch every k iterations (0: never; 1: every window starts from
    # fresh reference-state inits), so that every gradient is taken near
    # the reference, where it is informative.
    reset_every: int = 0
    hidden: tuple = (1024, 512)
    total_env_steps: int = 2_000_000
    seed: int = 0
    init_log_std: float = -1.0
    fixed_log_std: bool = False
    remat: bool = True

    @property
    def steps_per_iteration(self) -> int:
        return self.num_envs * self.horizon

    @property
    def num_iterations(self) -> int:
        return max(1, self.total_env_steps // self.steps_per_iteration)


def _check_env(env) -> None:
    if getattr(env, "backend", None) == "kernel":
        raise ValueError("APG needs gradients through the physics, and the policy-step "
                         "kernel has none: build the env with backend='xla'")


def _norm_obs(config: APGConfig, stats, obs):
    return running_stats.normalize(stats, obs) if config.normalize_obs else obs


def make_optimizer(config: APGConfig) -> optim.Adam:
    """The policy's optimiser: ``zero_nans``, the global-norm clip, Adam, the
    rate decayed to 1% over ``num_iterations`` (one update per iteration)."""
    return optim.Adam(config.learning_rate, config.max_grad_norm,
                      config.num_iterations if config.lr_decay else 0, zero_nans=True)


def init(env, config: APGConfig, device="cuda") -> ppo.TrainState:
    """Fresh networks (the critic frozen), optimiser, obs stats and env
    batch, drawn from a generator on ``device`` seeded with ``config.seed``.
    The train state is PPO's: the same fields, checkpointed alike."""
    _check_env(env)
    device = torch.device(device)
    mesh = mesh_of(env)
    mesh.local(config.num_envs)  # raises unless the ranks split the batch evenly
    generator = torch.Generator(device=device).manual_seed(config.seed)
    policy, value = networks.init_params(
        env.observation_size, env.action_size, config.hidden,
        init_log_std=config.init_log_std, fixed_log_std=config.fixed_log_std,
        generator=generator, device=device)
    value.requires_grad_(False)
    with torch.no_grad():
        env_state = env.reset(config.num_envs, generator)
    return ppo.TrainState(policy=policy, value=value, opt=make_optimizer(config),
                          obs_stats=running_stats.init(env.observation_size, device),
                          env_state=env_state, generator=generator, env_steps=0, mesh=mesh)


def window_loss(env, config: APGConfig, policy, value, obs_stats, entry_state,
                noise: Optional[torch.Tensor] = None, ranks: int = 1):
    """Negative discounted window return, averaged over the batch, from
    ``entry_state``: (loss, aux). ``noise`` (horizon, B, nu) is the standard-
    normal action draw, required when ``action_noise > 0``. ``aux`` holds
    the final state, each env's ``ever_done``, the window's observations
    (with ``update_obs_stats``) and the metrics. With ``ranks`` > 1 the
    batch is one of that many equal shares and the loss its share: the
    ranks' losses sum to the whole batch's."""
    if config.action_noise > 0 and noise is None:
        raise ValueError("action_noise > 0 needs the window's noise draw")

    calls = 0

    def one_step(state, alive, acc, disc, eps):
        nonlocal calls
        calls += 1
        if calls > config.horizon:  # the checkpoint's recompute, inside the backward
            count("apg/recomputes", 1)
        with trace_annotation("apg/step"):
            mean, _ = policy(_norm_obs(config, obs_stats, state.obs))
            if config.action_noise > 0:
                mean = mean + config.action_noise * eps
            nstate = env.step(state, mean)
            done = nstate.done.detach()
            # the terminating step's reward counts (the env zeroes it on a
            # fall or off-pose); the steps after it are masked
            acc = acc + disc * alive * nstate.reward
            return nstate, alive * (1.0 - done), acc

    B = entry_state.done.shape[0]
    dev = entry_state.done.device
    state, alive = entry_state, torch.ones(B, device=dev)
    acc, disc = torch.zeros(B, device=dev), torch.ones((), device=dev)
    rews, dones, obses = [], [], []
    for t in range(config.horizon):
        eps = None if noise is None else noise[t]
        if config.remat:
            state, alive, acc = checkpoint(one_step, state, alive, acc, disc, eps,
                                           use_reentrant=False)
        else:
            state, alive, acc = one_step(state, alive, acc, disc, eps)
        disc = disc * config.gamma
        rews.append(state.reward.detach())
        dones.append(state.done.detach())
        if config.update_obs_stats:
            obses.append(state.obs.detach())

    with trace_annotation("apg/loss"):
        ret = acc
        if config.value_bootstrap:
            v_tail = value(_norm_obs(config, obs_stats, state.obs))
            ret = ret + (config.gamma ** config.horizon) * alive * v_tail
        loss = -torch.mean(ret) / (config.horizon * ranks)

    rews, dones = torch.stack(rews), torch.stack(dones)
    aux = {
        "final_state": state,
        "ever_done": torch.amax(dones, dim=0),
        "obses": torch.stack(obses) if obses else None,
        "metrics": {
            "reward_mean": torch.mean(rews),
            "episode_done_frac": torch.mean(dones),
            "window_alive_frac": torch.mean(alive.detach()),
            **{k: torch.mean(v.detach()) for k, v in state.metrics.items()},
        },
    }
    return loss, aux


def loss_and_grad(env, config: APGConfig, ts: ppo.TrainState, noise=None,
                  timing: Optional[dict] = None):
    """The window's loss from ``ts.env_state`` (detached) and the policy's
    gradient in its params' ``.grad``, both in full f32: (loss, aux).
    ``timing`` gets the synchronised seconds of the forward window and of
    the backward (``forward_s``, ``backward_s``). Data-parallel, the loss
    and the gradient are this rank's shares (:func:`window_loss`)."""
    for p in ts.policy.parameters():
        p.grad = None
    entry = map_states(torch.Tensor.detach, ts.env_state)
    sync = timing is not None
    with full_f32():
        with profile_scope("apg/forward", sync=sync) as fwd:
            loss, aux = window_loss(env, config, ts.policy, ts.value, ts.obs_stats, entry,
                                    noise, ranks=ts.mesh.world)
        with profile_scope("apg/backward", sync=sync) as bwd:
            loss.backward()
    if timing is not None:
        timing["forward_s"], timing["backward_s"] = fwd["seconds"], bwd["seconds"]
    return loss.detach(), aux


def train_step(env, config: APGConfig, ts: ppo.TrainState,
               noise: Optional[torch.Tensor] = None, fresh=None,
               timing: Optional[dict] = None):
    """One APG iteration: the window's loss and the policy's gradient
    (:func:`loss_and_grad`), the update, the obs stats (with
    ``update_obs_stats``), then every env that ended in the window (every
    env, each ``reset_every`` iterations) restarts. ``noise`` (horizon,
    num_envs, nu) and ``fresh`` (the reset states of the whole batch)
    replace the draws of ``ts.generator`` when given. Updates ``ts`` in
    place and returns (ts, metrics) as 0-d tensors."""
    gen = ts.generator
    mesh = ts.mesh
    dev = ts.env_state.done.device
    if noise is None and config.action_noise > 0:
        noise = torch.randn((config.horizon, config.num_envs, env.action_size),
                            generator=gen, device=gen.device).to(dev)
    if noise is not None:
        noise = mesh.rows(noise, dim=1)
    loss, aux = loss_and_grad(env, config, ts, noise, timing)
    params = {f"policy/{k}": p for k, p in ts.policy.named_parameters()}
    metrics = aux["metrics"]
    if mesh.world > 1:
        # one all-reduce: the gradient shares, the loss shares, the ranks' metric means
        shares = ppo._all_reduce_grads(mesh, params, torch.stack([loss, *metrics.values()]))
        loss = shares[0]
        metrics = dict(zip(metrics, shares[1:] / mesh.world))
    with profile_scope("apg/update"), torch.no_grad():
        grad_norm = ts.opt.step(params)
        if config.update_obs_stats:
            ts.obs_stats = running_stats.update(ts.obs_stats, aux["obses"], mesh.group)
        fresh = env.reset(config.num_envs, gen) if fresh is None else shard_batch(mesh, fresh)
        d = aux["ever_done"] > 0
        if config.reset_every > 0:
            it = ts.env_steps // config.steps_per_iteration
            if it % config.reset_every == config.reset_every - 1:
                d = torch.ones_like(d)
        ts.env_state = where_states(d, fresh, map_states(torch.Tensor.detach,
                                                         aux["final_state"]))
    ts.env_steps += config.steps_per_iteration
    return ts, {"loss": loss, "grad_norm": grad_norm, **metrics}


def make_apg_functions(env, config: APGConfig):
    """(init_fn(device), train_step_fn(ts, ...), eval_fn(policy, obs_stats,
    ...)) bound to ``env`` and ``config``, as pbrl_tpu's
    ``make_apg_functions`` returns them. The eval is PPO's: pbrl_tpu's APG
    ``evaluate`` is the same metric."""
    _check_env(env)
    return (functools.partial(init, env, config), functools.partial(train_step, env, config),
            functools.partial(ppo.evaluate, env, normalize_obs=config.normalize_obs))


def train(env, config: APGConfig = APGConfig(), progress_fn: Optional[Callable] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
          steps_per_call: int = 10, resume_from: Optional[str] = None, device="cuda"):
    """Run APG for ``config.num_iterations`` iterations; returns (train
    state, history).

    The latest checkpoint of ``checkpoint_dir``, else of ``resume_from`` (a
    PPO or APG run of the port, or one written by
    ``checkpoint.import_train_state``), gives the params, the obs stats and
    ``env_steps``; the optimiser restarts, as in pbrl_tpu. A resume inside
    ``checkpoint_dir`` continues its numbering. The history has one entry
    (also passed to ``progress_fn(iteration, entry)``) per
    ``steps_per_call`` iterations and one for a remainder: the last
    iteration's metrics, this run's ``env_steps``, ``sps`` (env steps per
    second since the start) and the seconds of the entry's forward windows
    and backwards (``forward_s``, ``backward_s``).
    """
    device = torch.device(device)
    ts = init(env, config, device)
    primary = ts.mesh.rank == 0
    it0 = 0
    src = None
    if checkpoint_dir and ckpt.latest_step(checkpoint_dir) is not None:
        src = checkpoint_dir
    elif resume_from:
        src = resume_from
    last = None if src is None else ckpt.latest_step(src)
    ppo.same_checkpoint(ts.mesh, last, device)
    if src is not None:
        if last is None:
            raise FileNotFoundError(f"no checkpoints under {src}")
        ckpt.restore_params_into(ts, ckpt.restore(src, last, device=device))
        if src == checkpoint_dir:
            it0 = int(last)
    if checkpoint_dir and primary:
        _save_run_config(checkpoint_dir, env, config)

    history = []
    saved = None
    every = max(1, checkpoint_every)
    steps_per_call = max(1, min(steps_per_call, config.num_iterations))
    ppo._synchronize(device)
    t0 = time.perf_counter()
    it = 0
    while it < config.num_iterations:
        n = min(steps_per_call, config.num_iterations - it)
        fwd_s = bwd_s = 0.0
        for _ in range(n):
            timing = {}
            ts, metrics = train_step(env, config, ts, timing=timing)
            fwd_s += timing["forward_s"]
            bwd_s += timing["backward_s"]
        values = torch.stack(list(metrics.values())).tolist()  # one copy to the host
        entry = dict(zip(metrics, values))
        entry["env_steps"] = (it + n) * config.steps_per_iteration
        entry["sps"] = entry["env_steps"] / (time.perf_counter() - t0)
        entry["forward_s"], entry["backward_s"] = fwd_s, bwd_s
        history.append(entry)
        if progress_fn is not None and primary:
            progress_fn(it + n - 1, entry)
        if checkpoint_dir and (it + n) // every > it // every:  # crossed a multiple
            saved = it0 + it + n
            if primary:
                ckpt.save(checkpoint_dir, ts, step=saved)
        it += n
    if checkpoint_dir and saved != it0 + config.num_iterations and primary:
        ckpt.save(checkpoint_dir, ts, step=it0 + config.num_iterations)
    return ts, history


def _save_run_config(directory: str, env, config: APGConfig) -> None:
    """``run_config.json`` with a ``TrainConfig`` projection of the fields
    eval needs to rebuild the networks (``cli eval`` and
    ``checkpoint.load_policy_from_dir`` read an APG run unchanged), and the
    whole ``APGConfig`` as ``apg_config.json``."""
    compat = ppo.TrainConfig(
        num_envs=config.num_envs, learning_rate=config.learning_rate, gamma=config.gamma,
        normalize_obs=config.normalize_obs, hidden=config.hidden,
        total_env_steps=config.total_env_steps, seed=config.seed,
        init_log_std=config.init_log_std, fixed_log_std=config.fixed_log_std)
    ckpt.save_run_config(directory, env, compat)
    save_json_config(os.path.join(directory, "apg_config.json"), config)

"""PPO and APG of the port on per-env envs, against pbrl_tpu's.

pbrl_tpu's trainers take any ``Env``: a per-env env (no ``is_vectorized``)
is vmapped, and its finished envs are replaced from a fresh reset chosen
by ``done``, with the finished step's reward, done and metrics kept
(PPO, ``pbrl_tpu/train/ppo.py:145-155``), or the whole state replaced
where the window ended (APG, ``apg.py:228-237``). The port's per-env envs
(``MimicEnv``) are batched already; their state nests engine ``Data`` and
its ``Contact``.

* A per-env toy env in JAX and its torch twin (the agent must output
  action == obs, as ``tests/test_ppo.py``'s ``MatchEnv``): a nested
  ``pipeline`` that ages every step (for APG also moved by the action, so
  that the gradient runs back through it, as ``tests/test_torch_apg.py``'s
  driven env), and an episode of 3 + 2k steps with k drawn at reset, so
  that envs end at different steps.
* Two iterations of ``make_train_functions``' ``train_step`` against
  pbrl_tpu's on its own draws and reset states, at
  ``tests/test_torch_ppo.py::test_train_step_matches_pbrl_tpu``'s
  tolerances; two ``make_apg_functions`` steps at
  ``tests/test_torch_apg.py::test_train_steps_match_pbrl_tpu``'s.
* The done-selection exact, on the toy env and on the humanoid
  ``MimicEnv``'s engine ``Data``.
* ``make_train_functions``' triple bit-equal to ``ppo.init``,
  ``ppo.train_step`` and ``ppo.evaluate``.
* One PPO and one APG step on the humanoid ``MimicEnv`` (2 envs,
  ``policy_dt=0.004``) with finite metrics.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.envs.base import Env as JEnv
from pbrl_tpu.envs.base import State as JState
from pbrl_tpu.train import apg as japg
from pbrl_tpu.train import ppo as jppo
from pbrl_tpu_torch.envs import State, map_states, where_states
from pbrl_tpu_torch.train import (APGTrainState, TrainState, Transition, apg,
                                  make_train_functions, networks, optim, ppo, running_stats)
from pbrl_tpu_torch.train.checkpoint import flax_state_dict
from tests.test_torch_ppo import OBS, ToyEnv, _np, _torch_nets

# ---------------------------------------------------------------------------
# The per-env toy env, in JAX (one env, vmapped by pbrl_tpu) and in torch
# (a batch)
# ---------------------------------------------------------------------------


@flax.struct.dataclass
class _JPipe:
    pos: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class _Pipe:
    pos: torch.Tensor


def _phase(lib, t, k):
    return 1.3 * t + 0.7 * k


class JPerEnvToy(JEnv):
    observation_size = OBS
    action_size = OBS

    def __init__(self, drive=0.0):
        self.drive = drive

    def _obs(self, t, k, pos):
        return jnp.sin(_phase(jnp, t, k) + 2.1 * jnp.arange(OBS, dtype=jnp.float32)) + pos

    def reset(self, rng):
        k = jax.random.randint(rng, (), 0, 3).astype(jnp.float32)
        z, pos = jnp.zeros(()), jnp.zeros(OBS)
        return JState(pipeline=_JPipe(pos=pos), obs=self._obs(z, k, pos), reward=z, done=z,
                      metrics={"pose_error": z}, info={"k": k, "t": z})

    def step(self, s, action):
        reward = jnp.exp(-jnp.sum((action - s.obs) ** 2))
        k, t = s.info["k"], s.info["t"] + 1
        pos = s.pipeline.pos + 0.1 + self.drive * jnp.tanh(action)
        done = (t >= 3 + 2 * k).astype(jnp.float32)
        return s.replace(pipeline=_JPipe(pos=pos), obs=self._obs(t, k, pos), reward=reward,
                         done=done, metrics={"pose_error": 0.5 * reward}, info={"k": k, "t": t})


class PerEnvToy:
    """The torch twin of ``JPerEnvToy``: a batch of envs, no ``auto_reset``.
    ``fed`` (a list of states), when given, holds the batches that
    ``reset`` returns in turn, pbrl_tpu's reset states in place of the
    generator's draws."""

    observation_size = OBS
    action_size = OBS

    def __init__(self, drive=0.0, fed=None):
        self.drive, self.fed = drive, fed

    def _obs(self, t, k, pos):
        return torch.sin(_phase(torch, t, k)[:, None]
                         + 2.1 * torch.arange(OBS, dtype=torch.float32)) + pos

    def reset(self, num_envs, generator=None, t0=None):
        if self.fed is not None:
            return self.fed.pop(0)
        k = torch.randint(0, 3, (num_envs,), generator=generator).to(torch.float32)
        z, pos = torch.zeros(num_envs), torch.zeros(num_envs, OBS)
        return State(pipeline=_Pipe(pos=pos), obs=self._obs(z, k, pos), reward=z, done=z,
                     metrics={"pose_error": z}, info={"k": k, "t": z})

    def step(self, s, action):
        reward = torch.exp(-torch.sum((action - s.obs) ** 2, dim=-1))
        k, t = s.info["k"], s.info["t"] + 1
        pos = s.pipeline.pos + 0.1 + self.drive * torch.tanh(action)
        done = (t >= 3 + 2 * k).to(torch.float32)
        return s.replace(pipeline=_Pipe(pos=pos), obs=self._obs(t, k, pos), reward=reward,
                         done=done, metrics={"pose_error": 0.5 * reward}, info={"k": k, "t": t})


def _state(js) -> State:
    """pbrl_tpu's batched toy state as the port's."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return State(pipeline=_Pipe(pos=t(js.pipeline.pos)), obs=t(js.obs), reward=t(js.reward),
                 done=t(js.done), metrics={k: t(v) for k, v in js.metrics.items()},
                 info={k: t(v) for k, v in js.info.items()})


def _assert_state(got: State, want, **tol):
    np.testing.assert_allclose(_np(got.obs), np.asarray(want.obs), err_msg="obs", **tol)
    np.testing.assert_allclose(_np(got.pipeline.pos), np.asarray(want.pipeline.pos),
                               err_msg="pipeline.pos", **tol)
    for k in ("k", "t"):
        np.testing.assert_array_equal(_np(got.info[k]), np.asarray(want.info[k]), err_msg=k)
    np.testing.assert_array_equal(_np(got.done), np.asarray(want.done))


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def _ppo_configs(**kw):
    defaults = dict(num_envs=16, unroll_length=8, num_minibatches=4, update_epochs=2,
                    hidden=(32, 32), learning_rate=3e-3, entropy_cost=1e-2,
                    total_env_steps=16 * 8 * 2, seed=0)
    defaults.update(kw)
    return jppo.TrainConfig(**defaults), ppo.TrainConfig(**defaults)


def _ppo_draws(jenv, ts_rng, cfg):
    """What pbrl_tpu's train_step draws from its train state's key on a
    per-env env: the action noise and each step's fresh reset batch
    (``ppo.py:166-172``), and the per-epoch permutations."""
    reset = jax.jit(jax.vmap(jenv.reset))
    rng, noise, resets = ts_rng, [], []
    for _ in range(cfg.unroll_length):
        rng, k_act, k_reset = jax.random.split(rng, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (cfg.num_envs, OBS))))
        resets.append(_state(reset(jax.random.split(k_reset, cfg.num_envs))))
    n = cfg.num_envs * cfg.unroll_length
    perms = []
    for _ in range(cfg.update_epochs):
        rng, k = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k, n)))
    return torch.from_numpy(np.stack(noise)), resets, torch.from_numpy(np.stack(perms))


def test_ppo_train_step_per_env_matches_pbrl_tpu():
    """Two iterations of the triple's ``train_step`` from pbrl_tpu's params
    and reset states, its draws fed to the port, at the tolerances of
    ``test_train_step_matches_pbrl_tpu``."""
    jcfg, cfg = _ppo_configs()
    jenv, env = JPerEnvToy(), PerEnvToy()
    jinit, jstep, _ = jppo.make_train_functions(jenv, jcfg)
    jts = jinit(jax.random.PRNGKey(0))
    policy, value = _torch_nets(jax.tree_util.tree_map(np.asarray, jts.params), cfg)
    _, step, _ = make_train_functions(env, cfg)
    ts = TrainState(policy=policy, value=value,
                    opt=optim.Adam(cfg.learning_rate, cfg.max_grad_norm, cfg.total_updates),
                    obs_stats=running_stats.init(OBS, "cpu"), env_state=_state(jts.env_state),
                    generator=torch.Generator(), env_steps=0)
    assert len(set(np.asarray(jts.env_state.info["k"]).tolist())) == 3  # mixed lengths
    jstep = jax.jit(jstep)
    for _ in range(2):
        noise, env.fed, perms = _ppo_draws(jenv, jts.rng, jcfg)
        jts, jmetrics = jstep(jts)
        ts, metrics = step(ts, noise=noise, perms=perms)
        assert not env.fed
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-5,
                                       atol=1e-6, err_msg=k)
        assert 0.0 < float(metrics["episode_done_frac"]) < 1.0
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(_np(getattr(ts.obs_stats, k)),
                                       np.asarray(getattr(jts.obs_stats, k)), rtol=1e-5,
                                       err_msg=k)
        for name, net in (("policy", ts.policy), ("value", ts.value)):
            want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jts.params[name]))
            for k, v in net.state_dict().items():
                np.testing.assert_allclose(_np(v), _np(want[k]), atol=1e-6, rtol=0,
                                           err_msg=f"{name}.{k}")
        _assert_state(ts.env_state, jts.env_state, atol=1e-6, rtol=0)
    assert ts.env_steps == int(jts.env_steps) == 2 * cfg.steps_per_iteration


def test_ppo_done_selection_exact():
    """One rollout step on the toy env: where the step ended an episode,
    the fresh state (its nested pipeline and info too) to the bit; elsewhere
    the step's; the step's reward, done and metrics kept everywhere."""
    _, cfg = _ppo_configs(num_envs=6, unroll_length=1)
    env = PerEnvToy()
    start = env.reset(6, torch.Generator().manual_seed(1))
    # steps 2, 4 and 6 end episodes of k = 0, 1, 2: put the envs one step
    # before the end or well before it
    k = torch.tensor([0.0, 0.0, 1.0, 1.0, 2.0, 2.0])
    t = torch.tensor([2.0, 0.0, 4.0, 1.0, 6.0, 3.0])
    start = start.replace(info={"k": k, "t": t},
                          pipeline=_Pipe(pos=torch.linspace(-1, 1, 18).reshape(6, 3)))
    start = start.replace(obs=env._obs(t, k, start.pipeline.pos))
    fresh = env.reset(6, torch.Generator().manual_seed(2))
    fresh = fresh.replace(reward=torch.full((6,), 7.0), metrics={"pose_error": torch.full((6,), 9.0)},
                          pipeline=_Pipe(pos=torch.full((6, OBS), 5.0)))
    policy, value = networks.init_params(OBS, OBS, (8,), generator=torch.Generator(),
                                         device="cpu")
    ts = TrainState(policy=policy, value=value, opt=None,
                    obs_stats=running_stats.init(OBS, "cpu"), env_state=start,
                    generator=torch.Generator(), env_steps=0)
    noise = torch.zeros(1, 6, OBS)
    stepped = env.step(start, networks.sample_action(
        *policy(running_stats.normalize(ts.obs_stats, start.obs)), noise=noise[0]))
    env.fed = [fresh]
    final, traj = ppo.rollout(env, cfg, ts, noise=noise)
    d = stepped.done > 0
    assert d.tolist() == [True, False, True, False, True, False]
    for got, a, b in ((final.obs, fresh.obs, stepped.obs),
                      (final.pipeline.pos, fresh.pipeline.pos, stepped.pipeline.pos),
                      (final.info["k"], fresh.info["k"], stepped.info["k"]),
                      (final.info["t"], fresh.info["t"], stepped.info["t"])):
        assert torch.equal(got[d], a[d]) and torch.equal(got[~d], b[~d])
    assert torch.equal(final.reward, stepped.reward) and torch.equal(final.done, stepped.done)
    assert torch.equal(final.metrics["pose_error"], stepped.metrics["pose_error"])
    assert torch.equal(traj.reward[0], stepped.reward) and torch.equal(traj.done[0], stepped.done)
    assert torch.equal(traj.obs[0], start.obs)


# ---------------------------------------------------------------------------
# APG
# ---------------------------------------------------------------------------


def _apg_configs(**kw):
    defaults = dict(num_envs=16, horizon=4, hidden=(32, 32), learning_rate=3e-3, gamma=0.9,
                    action_noise=0.1, update_obs_stats=True, value_bootstrap=True,
                    total_env_steps=16 * 4 * 2, seed=0)
    defaults.update(kw)
    return japg.APGConfig(**defaults), apg.APGConfig(**defaults)


def _apg_draws(jenv, ts_rng, cfg):
    """The window's noise and the fresh reset batch pbrl_tpu's APG
    train_step draws from its train state's key (``apg.py:203``, ``:228``)."""
    _, k_win, k_reset = jax.random.split(ts_rng, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (cfg.num_envs, OBS)))
                      for k in jax.random.split(k_win, cfg.horizon)])
    fresh = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k_reset, cfg.num_envs))
    return torch.from_numpy(noise), _state(fresh)


def test_apg_train_step_per_env_matches_pbrl_tpu():
    """Two ``make_apg_functions`` steps from pbrl_tpu's params and reset
    states on its draws: the gradient runs back through the nested
    pipeline, and the envs that ended in the first window (k = 0) restart
    while the others carry on. The tolerances of
    ``tests/test_torch_apg.py::test_train_steps_match_pbrl_tpu``."""
    jcfg, cfg = _apg_configs()
    jenv, env = JPerEnvToy(drive=0.5), PerEnvToy(drive=0.5)
    jinit, jstep, _ = japg.make_apg_functions(jenv, jcfg)
    jts = jinit(jax.random.PRNGKey(0))
    policy, value = _torch_nets(jax.tree_util.tree_map(np.asarray, jts.params), cfg)
    value.requires_grad_(False)
    frozen = {k: v.clone() for k, v in value.state_dict().items()}
    _, step, _ = apg.make_apg_functions(env, cfg)
    ts = APGTrainState(policy=policy, value=value, opt=apg.make_optimizer(cfg),
                       obs_stats=running_stats.init(OBS, "cpu"),
                       env_state=_state(jts.env_state), generator=torch.Generator(),
                       env_steps=0)
    jstep = jax.jit(jstep)
    for i in range(2):
        noise, fresh = _apg_draws(jenv, jts.rng, jcfg)
        jts, jmetrics = jstep(jts)
        ts, metrics = step(ts, noise=noise, fresh=fresh)
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-5,
                                       atol=1e-6, err_msg=f"iteration {i} {k}")
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(_np(getattr(ts.obs_stats, k)),
                                       np.asarray(getattr(jts.obs_stats, k)), rtol=1e-5,
                                       err_msg=k)
        want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jts.params["policy"]))
        for k, v in ts.policy.state_dict().items():
            np.testing.assert_allclose(_np(v), _np(want[k]), atol=1e-6, rtol=0, err_msg=k)
        _assert_state(ts.env_state, jts.env_state, atol=1e-6, rtol=0)
        restarted = _np(ts.env_state.info["t"]) == 0
        assert 0 < restarted.sum() < cfg.num_envs  # some envs restarted, not all
        assert not ts.env_state.obs.requires_grad and not ts.env_state.pipeline.pos.requires_grad
    for k, v in ts.value.state_dict().items():  # the critic never moves
        assert torch.equal(v, frozen[k]), k
    assert ts.env_steps == int(jts.env_steps) == 2 * cfg.steps_per_iteration


# ---------------------------------------------------------------------------
# The triple, and the tree helpers on engine Data
# ---------------------------------------------------------------------------


def test_make_train_functions_triple_is_ppo():
    """The triple of a vectorized env gives ``ppo.init``'s train state,
    ``ppo.train_step``'s metrics and ``ppo.evaluate``'s numbers, bit for
    bit; the package exports the training API's names."""
    _, cfg = _ppo_configs(total_env_steps=16 * 8 * 3)
    init, step, evaluate = make_train_functions(ToyEnv(seed=3), cfg)
    a = init("cpu")
    env_b = ToyEnv(seed=3)
    b = ppo.init(env_b, cfg, device="cpu")
    for x, y in zip(a.params().values(), b.params().values()):
        assert torch.equal(x, y)
    assert torch.equal(a.env_state.obs, b.env_state.obs)
    for _ in range(2):
        a, ma = step(a)
        b, mb = ppo.train_step(env_b, cfg, b)
        assert list(ma) == list(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(a.params().values(), b.params().values()):
        assert torch.equal(x, y)
    ea = evaluate(a.policy, a.obs_stats, num_envs=8, num_steps=6)
    eb = ppo.evaluate(env_b, b.policy, b.obs_stats, num_envs=8, num_steps=6)
    assert list(ea) == list(eb) and all(torch.equal(ea[k], eb[k]) for k in ea)
    assert APGTrainState is TrainState and Transition is ppo.Transition


def _humanoid_env():
    from pbrl_tpu_torch.envs import EnvConfig, MimicEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    return MimicEnv(humanoid_model(), load_clip("walk", device="cpu"), EnvConfig(policy_dt=0.004))


def test_where_and_map_states_on_engine_data():
    """On the humanoid ``MimicEnv``: ``where_states`` reaches every tensor
    of ``Data`` and its ``Contact`` with the env axis (per env, to the
    bit), takes ``Contact``'s per-slot layout (no env axis) from the
    carried state, and ``ppo.reset_done`` keeps the step's reward, done
    and metrics; ``map_states`` detaches every tensor."""
    env = _humanoid_env()
    gen = torch.Generator().manual_seed(0)
    start = env.reset(3, gen)
    nstate = env.step(start, torch.zeros(3, env.action_size))
    nstate = nstate.replace(done=torch.tensor([1.0, 0.0, 1.0]))
    fresh = env.reset(3, gen)
    merged = ppo.reset_done(nstate, fresh)
    d = nstate.done > 0
    seen = []

    def check(got, a, b, name=""):
        if isinstance(got, torch.Tensor):
            seen.append(name)
            if got.dim() and got.shape[0] == 3:
                assert torch.equal(got[d], a[d]) and torch.equal(got[~d], b[~d]), name
            else:
                assert torch.equal(got, b), name
        elif dataclasses.is_dataclass(got):
            for f in dataclasses.fields(got):
                check(getattr(got, f.name), getattr(a, f.name), getattr(b, f.name),
                      f"{name}.{f.name}")
        elif isinstance(got, dict):
            for k in got:
                check(got[k], a[k], b[k], f"{name}[{k}]")

    check(merged.pipeline, fresh.pipeline, nstate.pipeline, "pipeline")
    check(merged.obs, fresh.obs, nstate.obs, "obs")
    check(merged.info, fresh.info, nstate.info, "info")
    assert {".contact.body1", ".contact.force", ".qM", ".time"} <= {s[8:] for s in seen}
    assert not torch.equal(merged.pipeline.qpos, nstate.pipeline.qpos)
    assert torch.equal(merged.pipeline.contact.body1, nstate.pipeline.contact.body1)
    assert merged.reward is nstate.reward and merged.done is nstate.done
    assert merged.metrics is nstate.metrics
    wanted = where_states(d, fresh, nstate)
    assert torch.equal(wanted.pipeline.qvel, merged.pipeline.qvel)
    grad = nstate.replace(obs=nstate.obs.clone().requires_grad_(True))
    detached = map_states(torch.Tensor.detach, grad)
    assert not detached.obs.requires_grad and detached.pipeline.contact is not None


@pytest.mark.parametrize("trainer", ["ppo", "apg"])
def test_humanoid_mimic_env_trains(trainer):
    """The registry's env kind (``MimicEnv``, engine ``Data`` in its state)
    takes one PPO iteration and one APG step, 2 envs, with finite metrics,
    its engine state carried on (no env ends in 2 steps from the clip)."""
    env = _humanoid_env()
    if trainer == "ppo":
        cfg = ppo.TrainConfig(num_envs=2, unroll_length=2, num_minibatches=2, update_epochs=1,
                              hidden=(16,), total_env_steps=4)
        init, step, evaluate = make_train_functions(env, cfg)
    else:
        cfg = apg.APGConfig(num_envs=2, horizon=2, hidden=(16,), action_noise=0.1,
                            total_env_steps=4)
        init, step, evaluate = apg.make_apg_functions(env, cfg)
    ts = init("cpu")
    t_before = ts.env_state.pipeline.time.clone()
    ts, metrics = step(ts)
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    assert int(ts.env_steps) == cfg.steps_per_iteration
    if trainer == "apg":
        assert float(metrics["grad_norm"]) > 0
    # no env ends in 2 steps of 8 ms from a reference start: all carried on
    dt = cfg.unroll_length if trainer == "ppo" else cfg.horizon
    np.testing.assert_allclose(_np(ts.env_state.pipeline.time - t_before),
                               dt * env.config.effective_policy_dt, atol=1e-6)
    ev = evaluate(ts.policy, ts.obs_stats, num_envs=2, num_steps=1)
    assert all(bool(torch.isfinite(v)) for v in ev.values())

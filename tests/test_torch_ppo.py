"""PPO of the port against pbrl_tpu's, on the same inputs.

Each module of ``pbrl_tpu_torch.train`` is held against its pbrl_tpu
counterpart on inputs made from a numpy seed: GAE, the running obs
statistics, the Gaussian helpers, the networks' initialisers, the loss and
its gradients, the optimiser against optax, one whole ``train_step`` on a
deterministic toy env fed pbrl_tpu's own random draws, and the env's
auto-reset. pbrl_tpu's side runs on the CPU as ``tests/test_ppo.py`` runs
it; its loss and optimiser are taken from the closure of its own
``train_step``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pbrl_tpu.train import networks as jnet
from pbrl_tpu.train import ppo as jppo
from pbrl_tpu.train import running_stats as jrs
from pbrl_tpu_torch.train import networks, optim, ppo, running_stats
from pbrl_tpu_torch.train.checkpoint import flax_state_dict


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# A deterministic toy env, in JAX and in torch: the agent must output
# action == obs (tests/test_ppo.py's MatchEnv), with obs a fixed function of
# the env index and its step count, and env i ending after 5 + i % 3 steps.
# ---------------------------------------------------------------------------

OBS = 3


@flax.struct.dataclass
class _JToyState:
    obs: jnp.ndarray
    t: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    metrics: dict


class JToyEnv:
    is_vectorized = True
    observation_size = OBS
    action_size = OBS

    @staticmethod
    def _obs(t):
        i = jnp.arange(t.shape[0], dtype=jnp.float32)[:, None]
        k = jnp.arange(OBS, dtype=jnp.float32)[None]
        return jnp.sin(1.3 * t[:, None] + 0.7 * i + 2.1 * k)

    def reset(self, keys):
        z = jnp.zeros(keys.shape[0])
        return _JToyState(obs=self._obs(z), t=z, reward=z, done=z,
                          metrics={"pose_error": z})

    def step(self, s, action):
        reward = jnp.exp(-jnp.sum((action - s.obs) ** 2, axis=-1))
        t = s.t + 1
        i = jnp.arange(t.shape[0])
        done = (t >= 5 + i % 3).astype(jnp.float32)
        return s.replace(obs=self._obs(t), t=t, reward=reward, done=done,
                         metrics={"pose_error": 0.5 * reward})

    def auto_reset(self, s, keys):
        fresh = self.reset(keys)
        d = s.done > 0
        return s.replace(obs=jnp.where(d[:, None], fresh.obs, s.obs),
                         t=jnp.where(d, fresh.t, s.t))


class ToyEnv:
    """The torch twin of ``JToyEnv``; with ``seed``, obs are uniform draws
    in [-1, 1) instead (MatchEnv proper), for the learning test."""

    is_vectorized = True
    observation_size = OBS
    action_size = OBS

    def __init__(self, seed=None):
        self.gen = None if seed is None else torch.Generator().manual_seed(seed)

    def _obs(self, t):
        if self.gen is not None:
            return 2.0 * torch.rand(t.shape[0], OBS, generator=self.gen) - 1.0
        i = torch.arange(t.shape[0], dtype=torch.float32)[:, None]
        k = torch.arange(OBS, dtype=torch.float32)[None]
        return torch.sin(1.3 * t[:, None] + 0.7 * i + 2.1 * k)

    def reset(self, num_envs, generator=None, t0=None):
        from pbrl_tpu_torch.envs import VecState

        z = torch.zeros(num_envs)
        return VecState(qpos=z[:, None], qvel=z[:, None], time=z, episode_start=z,
                        obs=self._obs(z), reward=z, done=z, metrics={"pose_error": z})

    def step(self, s, action):
        reward = torch.exp(-torch.sum((action - s.obs) ** 2, dim=-1))
        t = s.time + 1
        done = (t >= 5 + torch.arange(t.shape[0]) % 3).to(torch.float32)
        return s.replace(obs=self._obs(t), time=t, reward=reward, done=done,
                         metrics={"pose_error": 0.5 * reward})

    def auto_reset(self, s, generator=None):
        fresh = self.reset(s.done.shape[0])
        d = s.done > 0
        return s.replace(obs=torch.where(d[:, None], fresh.obs, s.obs),
                         time=torch.where(d, fresh.time, s.time))


def _tiny_config(**kw):
    defaults = dict(num_envs=16, unroll_length=8, num_minibatches=2, update_epochs=2,
                    hidden=(32, 32), learning_rate=3e-3, total_env_steps=16 * 8 * 60,
                    seed=0)
    defaults.update(kw)
    return jppo.TrainConfig(**defaults), ppo.TrainConfig(**defaults)


def _jax_functions(jcfg):
    init, step, _ = jppo.make_train_functions(JToyEnv(), jcfg)
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    return init, step, cells


def _torch_nets(params, cfg):
    policy = networks.PolicyNetwork(OBS, OBS, cfg.hidden, fixed_log_std=cfg.fixed_log_std)
    value = networks.ValueNetwork(OBS, cfg.hidden)
    policy.load_state_dict(flax_state_dict(params["policy"]))
    value.load_state_dict(flax_state_dict(params["value"]))
    return policy, value


def _assert_params_equal(policy, value, params, **tol):
    for name, net in (("policy", policy), ("value", value)):
        want = flax_state_dict(jax.tree_util.tree_map(np.asarray, params[name]))
        got = net.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=f"{name}.{k}", **tol)


# ---------------------------------------------------------------------------
# GAE, running stats, Gaussian helpers, init
# ---------------------------------------------------------------------------


def test_compute_gae_matches_pbrl_tpu():
    T, B = 8, 5
    rng = np.random.default_rng(0)
    r = rng.normal(size=(T, B)).astype(np.float32)
    d = (rng.uniform(size=(T, B)) < 0.3).astype(np.float32)
    v = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    want_adv, want_ret = jppo.compute_gae(*(jnp.asarray(x) for x in (r, d, v, boot)),
                                          0.95, 0.95)
    adv, ret = ppo.compute_gae(*(_t(x) for x in (r, d, v, boot)), 0.95, 0.95)
    assert d.sum() > 0
    np.testing.assert_allclose(_np(adv), np.asarray(want_adv), atol=1e-6)
    np.testing.assert_allclose(_np(ret), np.asarray(want_ret), atol=1e-6)


def test_running_stats_match_pbrl_tpu():
    rng = np.random.default_rng(1)
    dim = 6
    js, ts = jrs.init(dim), running_stats.init(dim, device="cpu")
    for k in ("count", "mean", "m2"):  # m2 starts at ones, count at 0
        np.testing.assert_array_equal(_np(getattr(ts, k)), np.asarray(getattr(js, k)))
    batches = [rng.normal(3.0, 2.0, size=(50, dim)), rng.normal(-1.0, 0.5, size=(8, 4, dim)),
               rng.normal(0.0, 5.0, size=(1, dim)), rng.normal(1.0, 1.0, size=(16, 16, dim))]
    for b in batches:
        b = b.astype(np.float32)
        js, ts = jrs.update(js, jnp.asarray(b)), running_stats.update(ts, _t(b))
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(_np(getattr(ts, k)), np.asarray(getattr(js, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(ts.std), np.asarray(js.std), rtol=1e-6)
    obs = rng.normal(size=(9, dim)).astype(np.float32)
    np.testing.assert_allclose(_np(running_stats.normalize(ts, _t(obs))),
                               np.asarray(jrs.normalize(js, jnp.asarray(obs))), atol=1e-6)


def test_gaussian_helpers_match_pbrl_tpu():
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(7, 28)).astype(np.float32)
    log_std = np.broadcast_to(np.linspace(-2.3, 0.7, 28, dtype=np.float32), mean.shape)
    key = jax.random.PRNGKey(5)
    want_a = jnet.sample_action(key, jnp.asarray(mean), jnp.asarray(log_std))
    noise = np.asarray(jax.random.normal(key, mean.shape))  # the draw pbrl_tpu made
    a = networks.sample_action(_t(mean), _t(log_std), noise=_t(noise))
    np.testing.assert_allclose(_np(a), np.asarray(want_a), atol=1e-6)
    act = (mean + rng.normal(size=mean.shape)).astype(np.float32)
    np.testing.assert_allclose(
        _np(networks.log_prob(_t(mean), _t(log_std), _t(act))),
        np.asarray(jnet.log_prob(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(act))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(networks.entropy(_t(log_std))),
                               np.asarray(jnet.entropy(jnp.asarray(log_std))),
                               rtol=1e-6, atol=1e-6)
    drawn = networks.sample_action(_t(mean), _t(log_std), torch.Generator().manual_seed(0))
    assert drawn.shape == mean.shape and not torch.equal(drawn, _t(mean))


def test_init_matches_flax_distribution():
    policy, value = networks.init_params(68, 28, (1024, 512), init_log_std=-1.3,
                                         generator=torch.Generator().manual_seed(0),
                                         device="cpu")
    jparams, _, _ = jnet.init_params(jax.random.PRNGKey(0), 68, 28, (1024, 512))
    layers = [m for net in (policy, value) for m in net.modules()
              if isinstance(m, torch.nn.Linear)]
    assert len(layers) == 6
    for m in layers:
        fan_in = m.weight.shape[1]
        std = float(m.weight.detach().std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (m, std)
        assert float(m.weight.detach().abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
        assert float(m.bias.detach().abs().max()) == 0.0
    np.testing.assert_array_equal(_np(policy.log_std), np.full(28, -1.3, np.float32))
    # flax's own draw of the widest kernel, for scale
    k = np.asarray(jparams["policy"]["params"]["torso"]["hidden_1"]["kernel"])
    assert abs(k.std() * np.sqrt(1024) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# Loss and gradients, optimiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed_log_std", [False, True], ids=["free_std", "fixed_std"])
def test_loss_and_grads_match_pbrl_tpu(fixed_log_std):
    jcfg, cfg = _tiny_config(fixed_log_std=fixed_log_std, entropy_cost=1e-2)
    _, _, cells = _jax_functions(jcfg)
    params, _, _ = jnet.init_params(jax.random.PRNGKey(3), OBS, OBS, (32, 32),
                                    fixed_log_std=fixed_log_std)
    params = flax.core.unfreeze(params)
    # one log_std beyond each clamp bound: no gradient there
    params["policy"]["params"]["log_std"] = jnp.asarray([-3.0, -0.6, 1.2], jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(4)
    n = 64
    obs = rng.normal(1.0, 2.0, size=(n, OBS)).astype(np.float32)
    act = rng.normal(size=(n, OBS)).astype(np.float32)
    old_lp = rng.normal(-4.0, 0.5, size=n).astype(np.float32)
    adv = rng.normal(0.3, 1.5, size=n).astype(np.float32)
    ret = rng.normal(size=n).astype(np.float32)
    stats = {"count": np.float32(500.0), "mean": rng.normal(size=OBS).astype(np.float32),
             "m2": rng.uniform(100, 900, size=OBS).astype(np.float32)}
    zeros = np.zeros(n, np.float32)
    jbatch = jppo.Transition(obs=jnp.asarray(obs), action=jnp.asarray(act),
                             log_prob=jnp.asarray(old_lp), reward=jnp.asarray(zeros),
                             done=jnp.asarray(zeros), value=jnp.asarray(zeros))
    (jtotal, jaux), jgrads = cells["grad_fn"](params, jbatch, jnp.asarray(adv),
                                              jnp.asarray(ret), jrs.RunningStats(**stats))

    policy, value = _torch_nets(params, cfg)
    batch = ppo.Transition(obs=_t(obs), action=_t(act), log_prob=_t(old_lp), reward=_t(zeros),
                           done=_t(zeros), value=_t(zeros))
    total, aux = ppo.loss_fn(policy, value, cfg, batch, _t(adv), _t(ret),
                             running_stats.RunningStats(**{k: _t(v) for k, v in stats.items()}))
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5, atol=1e-5)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for name, net in (("policy", policy), ("value", value)):
        want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jgrads[name]))
        for k, p in net.named_parameters():
            g = np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
            np.testing.assert_allclose(g, _np(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name}.{k}")
    g_std = np.zeros(OBS) if policy.log_std.grad is None else _np(policy.log_std.grad)
    assert g_std[0] == 0.0 and g_std[2] == 0.0  # beyond the clamp
    assert (g_std[1] == 0.0) == fixed_log_std


def test_optimizer_matches_optax():
    rng = np.random.default_rng(5)
    shapes = {"policy/w": (4, 3), "policy/b": (3,), "value/w": (5, 2)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr, max_norm, total = 1e-2, 0.5, 3
    grads = [{k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    grads[1] = {k: 20.0 * g for k, g in grads[1].items()}  # beyond max_grad_norm
    norms = [np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in gs.values()))
             for gs in grads]
    assert norms[1] > max_norm and all(n < max_norm for i, n in enumerate(norms) if i != 1)

    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adam(optax.linear_schedule(lr, lr * 0.01, total)))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    opt = optim.Adam(lr, max_norm, total)
    for i, gs in enumerate(grads):  # updates 4 and 5 are past total_updates
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = _t(gs[k])
        norm = opt.step(params)
        np.testing.assert_allclose(float(norm), norms[i], rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(_np(params[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i + 1} {k}")
    adam = jstate[1][0]
    assert opt.count == int(adam.count) == int(jstate[1][1].count) == 5
    for k in shapes:
        np.testing.assert_allclose(_np(opt.mu[k]), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(_np(opt.nu[k]), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-12)
    assert opt.lr(0) == pytest.approx(lr) and opt.lr(7) == pytest.approx(lr * 0.01)


# ---------------------------------------------------------------------------
# One whole iteration, and learning
# ---------------------------------------------------------------------------


def _jax_draws(ts_rng, cfg):
    """The action noise and permutations pbrl_tpu's train_step draws from
    its train state's key (ppo.py:166-167 and :236-238)."""
    rng = ts_rng
    noise = []
    for _ in range(cfg.unroll_length):
        rng, k_act, _ = jax.random.split(rng, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (cfg.num_envs, OBS))))
    n = cfg.num_envs * cfg.unroll_length
    perms = []
    for _ in range(cfg.update_epochs):
        rng, k = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k, n)))
    return torch.from_numpy(np.stack(noise)), torch.from_numpy(np.stack(perms))


def test_train_step_matches_pbrl_tpu():
    """Two iterations from the same params, pbrl_tpu's draws fed to the
    port. Adam divides by the root of the second moment, so where a
    gradient element is near zero float32 rounding changes the step by a
    large relative amount; the bounds are absolute, about 10x the largest
    differences measured on this case: params 6e-8 (weights up to 1.3),
    metrics 1.1e-7 (1.9e-6 relative), obs stats 7.2e-7 relative."""
    jcfg, cfg = _tiny_config(num_minibatches=4, entropy_cost=1e-2, total_env_steps=16 * 8 * 2)
    init, step, _ = _jax_functions(jcfg)
    jts = init(jax.random.PRNGKey(0))
    policy, value = _torch_nets(jax.tree_util.tree_map(np.asarray, jts.params), cfg)
    env = ToyEnv()
    ts = ppo.TrainState(policy=policy, value=value,
                        opt=optim.Adam(cfg.learning_rate, cfg.max_grad_norm, cfg.total_updates),
                        obs_stats=running_stats.init(OBS, "cpu"),
                        env_state=env.reset(cfg.num_envs), generator=torch.Generator(),
                        env_steps=0)
    np.testing.assert_allclose(_np(ts.env_state.obs), np.asarray(jts.env_state.obs), atol=1e-6)
    step = jax.jit(step)
    for _ in range(2):
        noise, perms = _jax_draws(jts.rng, jcfg)
        jts, jmetrics = step(jts)
        ts, metrics = ppo.train_step(env, cfg, ts, noise=noise, perms=perms)
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-5,
                                       atol=1e-6, err_msg=k)
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(_np(getattr(ts.obs_stats, k)),
                                       np.asarray(getattr(jts.obs_stats, k)), rtol=1e-5,
                                       err_msg=k)
        _assert_params_equal(ts.policy, ts.value, jts.params, atol=1e-6, rtol=0)
        np.testing.assert_allclose(_np(ts.env_state.obs), np.asarray(jts.env_state.obs),
                                   atol=1e-6)
    assert ts.env_steps == int(jts.env_steps) == 2 * cfg.steps_per_iteration
    assert ts.opt.count == int(jts.opt_state[1][0].count) == 2 * 2 * 4


def test_ppo_learns_match_env():
    _, cfg = _tiny_config()
    env = ToyEnv(seed=0)
    ts = ppo.init(env, cfg, device="cpu")
    first = None
    for _ in range(60):
        ts, metrics = ppo.train_step(env, cfg, ts)
        if first is None:
            first = float(metrics["reward_mean"])
    last = float(metrics["reward_mean"])
    # Random actions give ~exp(-2) ~ 0.14 mean; matching pushes toward 1.
    assert last > first + 0.2, f"no learning: {first} -> {last}"
    assert ts.opt.count == 60 * cfg.update_epochs * cfg.num_minibatches


def test_train_runs_every_iteration(tmp_path):
    """pbrl_tpu drops ``num_iterations % steps_per_call`` iterations; the
    port runs them all, and numbers and keeps checkpoints as pbrl_tpu does
    (the last 3, the final one at it0 + num_iterations)."""
    from pbrl_tpu_torch.train import checkpoint

    _, cfg = _tiny_config(total_env_steps=16 * 8 * 7)
    d = str(tmp_path / "run")
    seen = []
    ts, history = ppo.train(ToyEnv(seed=1), cfg, progress_fn=lambda it, e: seen.append(it),
                            checkpoint_dir=d, checkpoint_every=2, device="cpu")
    assert seen == list(range(7)) and len(history) == 7
    assert history[-1]["env_steps"] == 7 * cfg.steps_per_iteration
    assert all(h["sps"] > 0 and h["rollout_s"] > 0 and h["learn_s"] > 0 for h in history)
    assert checkpoint._steps(d) == [4, 6, 7]
    assert ts.opt.count == 7 * cfg.update_epochs * cfg.num_minibatches
    ts2, _ = ppo.train(ToyEnv(seed=1), cfg, checkpoint_dir=d, checkpoint_every=100,
                       device="cpu")
    assert checkpoint.latest_step(d) == 14 and ts2.env_steps == 2 * ts.env_steps


# ---------------------------------------------------------------------------
# The env's auto-reset, on the humanoid
# ---------------------------------------------------------------------------


def test_auto_reset_matches_pbrl_tpu():
    """From shared reset states and a mixed done mask: finished envs take
    the fresh state, the others keep theirs, and every env keeps the
    finished step's reward, done and metrics."""
    from pbrl_tpu.envs import EnvConfig as JEnvConfig
    from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
    from pbrl_tpu.mocap import clip as jclip
    from pbrl_tpu.model import humanoid_model as j_humanoid
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv, VecState
    from pbrl_tpu_torch.envs.humanoid_task import augment_clip
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    walk = augment_clip(humanoid_model(), load_clip("walk", device="cpu"))
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    jenv = JMimicVecEnv(j_humanoid(), jc, JEnvConfig(), backend="xla")
    tenv = MimicVecEnv(humanoid_model(), walk, EnvConfig(), device="cpu")
    B = 6
    reset = jax.jit(jenv.reset)
    js = reset(jax.random.split(jax.random.PRNGKey(0), B))
    rng = np.random.default_rng(6)
    done = np.array([1, 0, 1, 0, 0, 1], np.float32)
    # a finished step: moved states, later times, its own reward and metrics
    js = js.replace(
        qpos=js.qpos + jnp.asarray(rng.normal(0, 0.05, js.qpos.shape), jnp.float32),
        qvel=js.qvel + jnp.asarray(rng.normal(0, 0.5, js.qvel.shape), jnp.float32),
        time=js.time + 0.4, reward=jnp.asarray(rng.uniform(size=B), jnp.float32),
        done=jnp.asarray(done),
        metrics={k: jnp.asarray(rng.uniform(size=B), jnp.float32) for k in js.metrics})
    js = js.replace(obs=jenv._obs(js.qpos, js.qvel, js.time))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    want = jax.jit(jenv.auto_reset)(js, keys)
    fresh_t0 = torch.from_numpy(np.array(reset(keys).time))

    ts = VecState(**{k: torch.from_numpy(np.array(getattr(js, k)))
                     for k in ("qpos", "qvel", "time", "episode_start", "obs", "reward",
                               "done")},
                  metrics={k: torch.from_numpy(np.array(v)) for k, v in js.metrics.items()})
    got = tenv.auto_reset(ts, t0=fresh_t0)
    for k, tol in (("qpos", 1e-5), ("qvel", 1e-4), ("time", 0), ("episode_start", 0),
                   ("obs", 1e-4), ("reward", 0), ("done", 0)):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                   atol=tol, rtol=0, err_msg=k)
    assert set(got.metrics) == set(want.metrics)
    for k in got.metrics:
        np.testing.assert_array_equal(_np(got.metrics[k]), np.asarray(want.metrics[k]))
    # the mask really mixed: done envs moved to the fresh start, the rest stayed
    d = done > 0
    np.testing.assert_array_equal(_np(got.time)[d], _np(fresh_t0)[d])
    np.testing.assert_array_equal(_np(got.time)[~d], np.asarray(js.time)[~d])

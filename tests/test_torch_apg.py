"""APG of the port against pbrl_tpu's, on the same inputs.

* ``angle_between``'s backward against ``jax.grad`` through pbrl_tpu's
  custom JVP (of ``sum(sin(angle) + angle**2)``), at 1e-6 absolute and
  relative: random pairs, exactly aligned (|d| = 1, where plain autograd
  gives NaN), antipodal and negative-dot pairs.
* The window loss, its metrics and aux, and the policy gradient against
  pbrl_tpu's ``grad_fn`` (taken from the closure of its ``train_step``), at
  1e-5 absolute and relative, on the toy env twins of
  ``tests/test_torch_ppo.py`` (the agent must output action == obs; env i
  ends after 5 + i % 3 steps): as they are, and driven (the next obs also
  depends on the action, so the gradient runs back through time and into
  the critic's input); with and without ``value_bootstrap``, and with
  ``action_noise`` fed pbrl_tpu's draws; rematerialised and not.
* Two whole ``train_step``s (``zero_nans``, clip, Adam, the decay,
  ``reset_every=1``, ``update_obs_stats``) from the same params on
  pbrl_tpu's draws: params at 1e-6 absolute (the bound of
  ``tests/test_torch_ppo.py``'s train-step test), metrics at 2e-5
  relative, obs stats at 1e-5 relative; the critic bit-frozen.
* The optimiser's ``zero_nans`` against optax's chain, a NaN gradient entry
  included (params at 1e-6 relative; ``grad_norm`` raw, so NaN).
* Learning on the random-obs toy env, ``train`` warm-started from a port
  PPO checkpoint (every iteration runs, checkpoints labelled by iterations
  run, both config files written and read back), and small checks of
  ``utils.guards`` and ``utils.profiling``.
"""

import dataclasses
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pbrl_tpu.maths import quaternion as jquat
from pbrl_tpu.train import apg as japg
from pbrl_tpu.train import running_stats as jrs
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.train import apg, checkpoint, optim, ppo, running_stats
from pbrl_tpu_torch.train.checkpoint import flax_state_dict
from pbrl_tpu_torch.utils import (assert_finite, check_finite_tree, nan_debug_enabled,
                                  profile_scope, profile_to, trace_annotation)
from pbrl_tpu_torch.utils.configio import dict_to_config, load_json_config
from tests.test_torch_ppo import OBS, JToyEnv, ToyEnv, _np, _t, _torch_nets


# ---------------------------------------------------------------------------
# angle_between
# ---------------------------------------------------------------------------


def _unit(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "aligned", "antipodal", "negative_dot"])
def test_angle_between_grad_matches_custom_jvp(case):
    rng = np.random.default_rng(0)
    q1 = _unit(rng, 32)
    if case == "random":
        q2 = _unit(rng, 32)
    elif case == "aligned":
        q1[:4] = np.eye(4, dtype=np.float32)  # <q, q> is exactly 1 on these rows
        q2 = q1.copy()
    elif case == "antipodal":
        q2 = -q1
    else:
        q2 = _unit(rng, 32)
        q2 *= -np.sign(np.sum(q1 * q2, axis=1, keepdims=True))
    s = np.sum(q1.astype(np.float64) * q2, axis=1)
    assert case != "negative_dot" or (s < 0).all()
    assert case != "aligned" or (np.abs(np.sum(q1[:4] * q2[:4], axis=1)) == 1.0).all()

    def f(angle, lib):
        return lib.sum(lib.sin(angle) + angle ** 2)

    want = jax.grad(lambda a, b: f(jquat.angle_between(a, b), jnp), argnums=(0, 1))(
        jnp.asarray(q1), jnp.asarray(q2))
    t1, t2 = _t(q1).requires_grad_(True), _t(q2).requires_grad_(True)
    angle = quat.angle_between(t1, t2)
    np.testing.assert_array_equal(
        _np(angle), _np(2.0 * torch.acos(torch.clamp(torch.abs(torch.sum(_t(q1) * _t(q2), -1)),
                                                     -1.0, 1.0))))  # the forward to the bit
    f(angle, torch).backward()
    for got, w in ((t1.grad, want[0]), (t2.grad, want[1])):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_angle_between_grad_broadcasts():
    """A (4,) quaternion against a (5, 4) batch: the gradient of the single
    one sums over the batch."""
    rng = np.random.default_rng(1)
    q1, q2 = _unit(rng, 1)[0], _unit(rng, 5)
    t1 = _t(q1).requires_grad_(True)
    torch.sum(quat.angle_between(t1, _t(q2))).backward()
    want = jax.grad(lambda a: jnp.sum(jquat.angle_between(a, jnp.asarray(q2))))(jnp.asarray(q1))
    np.testing.assert_allclose(_np(t1.grad), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Toy envs: the twins of tests/test_torch_ppo.py, and driven variants whose
# next obs depends on the action
# ---------------------------------------------------------------------------


class JDrivenEnv(JToyEnv):
    def step(self, s, action):
        out = super().step(s, action)
        return out.replace(obs=out.obs + 0.5 * jnp.tanh(action))


class DrivenEnv(ToyEnv):
    def step(self, s, action):
        out = super().step(s, action)
        return out.replace(obs=out.obs + 0.5 * torch.tanh(action))


ENVS = {"match": (JToyEnv, ToyEnv), "driven": (JDrivenEnv, DrivenEnv)}


def _configs(**kw):
    defaults = dict(num_envs=16, horizon=8, hidden=(32, 32), learning_rate=3e-3, gamma=0.9,
                    total_env_steps=16 * 8 * 2, seed=0)
    defaults.update(kw)
    return japg.APGConfig(**defaults), apg.APGConfig(**defaults)


def _grad_fn(jenv, jcfg):
    init, step, _ = japg.make_apg_functions(jenv, jcfg)
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    return init, step, cells["grad_fn"]


def _nets(params, cfg):
    policy, value = _torch_nets(params, cfg)
    return policy, value.requires_grad_(False)


def _noise(rng, cfg):
    """The window's action noise pbrl_tpu's train_step draws from its
    train state's key (apg.py:203, :161-163, :175)."""
    _, k_win, _ = jax.random.split(rng, 3)
    keys = jax.random.split(k_win, cfg.horizon)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (cfg.num_envs, OBS)))
                                      for k in keys]))


def _stats(rng):
    return {"count": np.float32(500.0), "mean": rng.normal(size=OBS).astype(np.float32),
            "m2": rng.uniform(100, 900, size=OBS).astype(np.float32)}


@pytest.mark.parametrize("env_kind,case", [
    ("match", "plain"), ("match", "bootstrap"), ("match", "noise"),
    ("driven", "plain"), ("driven", "bootstrap"), ("driven", "noise_no_remat")])
def test_window_loss_and_grad_match_pbrl_tpu(env_kind, case):
    jenv_cls, env_cls = ENVS[env_kind]
    jcfg, cfg = _configs(value_bootstrap=case == "bootstrap",
                         action_noise=0.1 if case.startswith("noise") else 0.0,
                         **({"remat": False} if case == "noise_no_remat" else {}))
    init, _, grad_fn = _grad_fn(jenv_cls(), jcfg)
    jts = init(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(jts.params))
    stats = _stats(np.random.default_rng(4))
    _, k_win, _ = jax.random.split(jts.rng, 3)
    (jloss, jaux), jgrads = grad_fn(params["policy"], (params["value"], jrs.RunningStats(**stats)),
                                    jts.env_state, k_win)

    env = env_cls()
    policy, value = _nets(params, cfg)
    loss, aux = apg.window_loss(env, cfg, policy, value,
                                running_stats.RunningStats(**{k: _t(v) for k, v in stats.items()}),
                                env.reset(cfg.num_envs),
                                _noise(jts.rng, cfg) if cfg.action_noise else None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    assert set(aux["metrics"]) == set(jaux["metrics"])
    for k in aux["metrics"]:
        np.testing.assert_allclose(aux["metrics"][k].item(), float(jaux["metrics"][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert 0.0 < float(aux["metrics"]["episode_done_frac"]) < 1.0  # the alive mask bites
    np.testing.assert_array_equal(_np(aux["ever_done"]), np.asarray(jaux["ever_done"]))
    np.testing.assert_allclose(_np(aux["final_state"].obs), np.asarray(jaux["final_state"].obs),
                               rtol=1e-5, atol=1e-5)
    want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in policy.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(g, _np(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(policy.torso.out.weight.grad.abs().max()) > 0
    assert all(p.grad is None for p in value.parameters())


def test_train_steps_match_pbrl_tpu():
    """Two iterations from the same params, pbrl_tpu's draws fed to the
    port; the second starts from windows all reset (``reset_every=1``)."""
    jcfg, cfg = _configs(action_noise=0.1, reset_every=1, update_obs_stats=True,
                         value_bootstrap=True)
    init, step, _ = _grad_fn(JDrivenEnv(), jcfg)
    jts = init(jax.random.PRNGKey(0))
    policy, value = _nets(jax.tree_util.tree_map(np.asarray, jts.params), cfg)
    env = DrivenEnv()
    ts = ppo.TrainState(policy=policy, value=value, opt=apg.make_optimizer(cfg),
                        obs_stats=running_stats.init(OBS, "cpu"),
                        env_state=env.reset(cfg.num_envs), generator=torch.Generator(),
                        env_steps=0)
    frozen = {k: v.clone() for k, v in value.state_dict().items()}
    step = jax.jit(step)
    for i in range(2):
        noise = _noise(jts.rng, jcfg)
        jts, jmetrics = step(jts)
        ts, metrics = apg.train_step(env, cfg, ts, noise=noise)
        assert set(metrics) == set(jmetrics)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-5,
                                       atol=1e-6, err_msg=f"iteration {i} {k}")
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(_np(getattr(ts.obs_stats, k)),
                                       np.asarray(getattr(jts.obs_stats, k)), rtol=1e-5, err_msg=k)
        want = flax_state_dict(jax.tree_util.tree_map(np.asarray, jts.params["policy"]))
        for k, v in ts.policy.state_dict().items():
            np.testing.assert_allclose(_np(v), _np(want[k]), atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(_np(ts.env_state.obs), np.asarray(jts.env_state.obs),
                                   atol=1e-6)
        np.testing.assert_array_equal(_np(ts.env_state.time), np.asarray(jts.env_state.t))
    for k, v in ts.value.state_dict().items():  # the critic never moves
        assert torch.equal(v, frozen[k]), k
    assert ts.env_steps == int(jts.env_steps) == 2 * cfg.steps_per_iteration
    assert ts.opt.count == 2 and ts.opt.total_updates == cfg.num_iterations == 2
    assert ts.opt.lr(2) == pytest.approx(cfg.learning_rate * 0.01)  # decays to 1%


def test_zero_nans_matches_optax():
    rng = np.random.default_rng(5)
    shapes = {"policy/w": (4, 3), "policy/b": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 0.5).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[1]["policy/w"][2, 1] = np.nan
    lr, max_norm, total = 1e-2, 1.0, 3
    tx = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(max_norm),
                     optax.adam(optax.linear_schedule(lr, lr * 0.01, total)))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    opt = optim.Adam(lr, max_norm, total, zero_nans=True)
    for i, gs in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in gs.items()}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = _t(gs[k])
        norm = opt.step(params)
        want_norm = float(optax.global_norm(jg))
        assert np.isnan(want_norm) == (i == 1)
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)  # raw, NaN included
        for k in shapes:
            assert bool(torch.isfinite(params[k]).all())
            np.testing.assert_allclose(_np(params[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i + 1} {k}")
    plain = optim.Adam(lr, max_norm, total)
    assert not plain.zero_nans  # PPO's arithmetic: no zero_nans step


# ---------------------------------------------------------------------------
# Learning and the train loop
# ---------------------------------------------------------------------------


def test_apg_learns_match_env():
    """pbrl_tpu's ``test_apg_learns_match_env`` on the port: exact gradients
    of exp(-||a - obs||^2) drive the policy to match in 40 iterations."""
    cfg = apg.APGConfig(num_envs=16, horizon=8, hidden=(32, 32), learning_rate=1e-2,
                        gamma=0.9, value_bootstrap=False, total_env_steps=16 * 8 * 40, seed=0)
    env = ToyEnv(seed=0)
    init, step, evaluate = apg.make_apg_functions(env, cfg)
    ts = init("cpu")
    first = None
    for _ in range(40):
        ts, metrics = step(ts)
        if first is None:
            first = float(metrics["reward_mean"])
    last = float(metrics["reward_mean"])
    assert last > max(first + 0.3, 0.6), f"no learning: {first} -> {last}"
    assert float(evaluate(ts.policy, ts.obs_stats, num_envs=32, num_steps=16)["eval_reward"]) > 0.6


def test_reset_every_restarts_windows():
    """``reset_every=1`` restarts every env after every window; without it
    the envs alive at the window's end carry on."""
    for every, want_alive in ((0, True), (1, False)):
        cfg = apg.APGConfig(num_envs=16, horizon=4, hidden=(8,), reset_every=every,
                            total_env_steps=64)
        env = ToyEnv()
        ts = apg.init(env, cfg, "cpu")
        ts, _ = apg.train_step(env, cfg, ts)
        carried = ts.env_state.time > 0
        assert bool(carried.any()) == want_alive and bool(carried.all()) == want_alive


def test_train_warm_start_from_ppo(tmp_path):
    """``train`` from a port PPO checkpoint: params, obs stats and
    ``env_steps`` carried over (the optimiser fresh), every iteration run,
    checkpoints labelled by iterations run and saved as the count crosses
    a multiple of ``checkpoint_every``, ``run_config.json`` and
    ``apg_config.json`` written and read back; a second call inside the
    run directory continues its numbering."""
    src, dst = str(tmp_path / "ppo"), str(tmp_path / "apg")
    pcfg = ppo.TrainConfig(num_envs=8, unroll_length=4, num_minibatches=2, update_epochs=1,
                           hidden=(32, 32), total_env_steps=8 * 4 * 2)
    pts, _ = ppo.train(ToyEnv(seed=3), pcfg, checkpoint_dir=src, device="cpu")
    cfg = apg.APGConfig(num_envs=8, horizon=4, hidden=(32, 32), learning_rate=1e-2,
                        total_env_steps=8 * 4 * 5)
    seen = []
    ts, history = apg.train(ToyEnv(seed=1), cfg, progress_fn=lambda it, e: seen.append(it),
                            checkpoint_dir=dst, checkpoint_every=2, steps_per_call=2,
                            resume_from=src, device="cpu")
    assert seen == [1, 3, 4] and len(history) == 3  # 2 + 2 + the remainder of 1
    assert [h["env_steps"] for h in history] == [64, 128, 160]
    assert all(h["sps"] > 0 and h["forward_s"] > 0 and h["backward_s"] > 0 for h in history)
    assert checkpoint._steps(dst) == [2, 4, 5]
    assert ts.opt.count == 5 and ts.env_steps == pts.env_steps + 5 * cfg.steps_per_iteration
    for k, v in pts.value.state_dict().items():
        assert torch.equal(ts.value.state_dict()[k], v), k
    assert not torch.equal(ts.policy.torso.out.weight, pts.policy.torso.out.weight)
    payload = checkpoint.restore(dst)
    assert set(payload) == {"policy", "value", "opt", "obs_stats", "env_steps"}
    assert set(payload["opt"]["mu"]) == {f"policy/{k}" for k, _ in ts.policy.named_parameters()}
    assert load_json_config(os.path.join(dst, "apg_config.json"), apg.APGConfig) == cfg
    with open(os.path.join(dst, "apg_config.json")) as f:
        assert json.load(f)["__config__"] == "APGConfig"
    run = checkpoint.load_run_config(dst)
    tc = dict_to_config(ppo.TrainConfig, run["train_config"])
    assert tc.hidden == cfg.hidden and tc.num_envs == cfg.num_envs
    policy, stats = checkpoint.load_policy_from_dir(dst, device="cpu")
    for k, v in policy.state_dict().items():
        assert torch.equal(v, ts.policy.state_dict()[k]), k
    assert torch.equal(stats.mean, pts.obs_stats.mean)  # update_obs_stats is off

    ts2, _ = apg.train(ToyEnv(seed=1), cfg, checkpoint_dir=dst, checkpoint_every=100,
                       resume_from=src, device="cpu")
    assert checkpoint.latest_step(dst) == 10
    assert ts2.env_steps == ts.env_steps + 5 * cfg.steps_per_iteration
    assert ts2.opt.count == 5  # the optimiser restarted, as in pbrl_tpu


def test_train_apg_refuses_the_kernel_backend():
    class KernelEnv(ToyEnv):
        backend = "kernel"

    cfg = apg.APGConfig(num_envs=2, horizon=1, hidden=(4,))
    with pytest.raises(ValueError, match="no.*backward|has none"):
        apg.init(KernelEnv(), cfg, "cpu")
    with pytest.raises(ValueError):
        apg.make_apg_functions(KernelEnv(), cfg)


# ---------------------------------------------------------------------------
# utils: guards and profiling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Leafy:
    a: torch.Tensor
    b: dict


def test_guards():
    x = torch.ones(3)
    assert assert_finite(x, "x") is x
    with pytest.raises(FloatingPointError, match="non-finite values in y"):
        assert_finite(torch.tensor([1.0, float("inf")]), "y")
    tree = {"p": {"w": torch.zeros(2), "n": torch.tensor([float("nan")])},
            "s": [torch.ones(1), torch.tensor(float("inf"))], "i": torch.arange(3),
            "d": _Leafy(a=torch.tensor([float("nan")]), b={"ok": 1.0}),
            "m": torch.nn.Linear(2, 2)}
    assert check_finite_tree(tree) == ["['p']['n']", "['s'][1]", "['d'].a"]
    with torch.no_grad():
        tree["m"].bias[0] = float("nan")
    assert check_finite_tree(tree["m"], "policy") == ["policy['bias']"]
    assert check_finite_tree({"ok": torch.ones(2)}) == []

    a = torch.tensor([0.0], requires_grad=True)
    assert not torch.is_anomaly_enabled()
    with nan_debug_enabled():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(a - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_profiling(tmp_path):
    with profile_to(str(tmp_path / "trace")) as prof:
        with trace_annotation("apg/test_scope"):
            torch.ones(8).sum()
        with profile_scope("apg/timed", sync=True) as t:
            torch.ones(8).cumsum(0)
    names = {e.name for e in prof.events()}
    assert {"apg/test_scope", "apg/timed"} <= names
    assert t["seconds"] > 0
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "apg/test_scope" in f.read()
    with pytest.raises(KeyError):
        with profile_scope("apg/raises") as t2:
            raise KeyError("x")
    assert t2["seconds"] >= 0

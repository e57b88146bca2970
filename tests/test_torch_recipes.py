"""The env options of the seven shipped recipes, held against pbrl_tpu.

Each ``ckpts/*/run_config.json`` builds the port's ``MimicVecEnv`` as
trained and eval-stripped, with pbrl_tpu's observation size. On shared
numpy-seeded inputs: the heading-frame root offset and link observations,
the aerial-window and drift reward shaping, the takeoff-state curriculum of
``auto_reset`` (fed pbrl_tpu's draws, re-derived from its keys), the
actuator mask, and one whole step plus ``auto_reset`` at backflip's
training config. pbrl_tpu's physics is its field program run eagerly, as
in ``tests/test_torch_env_eval.py``, at 2 substeps per policy step
(``policy_dt`` 0.004) to keep the eager JAX cheap.
"""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env_eval import ALLOWED, SUBSTEPS2, _jax_field_physics

from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu.ops import field_physics as jfp
from pbrl_tpu.utils.configio import config_to_dict as j_config_to_dict
from pbrl_tpu.utils.configio import dict_to_config as j_dict_to_config
from pbrl_tpu_torch import cli
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv, VecState
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip, reference_state
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import checkpoint
from pbrl_tpu_torch.utils.configio import config_to_dict, dict_to_config

CKPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "ckpts")
RUN_DIRS = ("walk", "getup", "getup_faceup", "kick", "punch", "jump", "backflip")


def _run(run_dir):
    with open(os.path.join(CKPTS, run_dir, "run_config.json")) as f:
        return json.load(f)


_CLIPS = {}


def _clips(name):
    """(port clip, pbrl_tpu clip), both carrying the port's ee/com tables."""
    if name not in _CLIPS:
        tc = augment_clip(humanoid_model(), load_clip(name, device="cpu"))
        jc = jclip.load_clip(name).replace(ee_pos=jnp.asarray(tc.ee_pos.numpy()),
                                           com=jnp.asarray(tc.com.numpy()))
        _CLIPS[name] = (tc, jc)
    return _CLIPS[name]


def _envs(clip, cfg: dict, **kw):
    """The port's and pbrl_tpu's env at the same config (a dict of fields)."""
    tc, jc = _clips(clip)
    tenv = MimicVecEnv(humanoid_model(), tc, EnvConfig(**cfg), device="cpu",
                       actuator_mask=kw.get("actuator_mask"))
    jenv = JMimicVecEnv(j_humanoid(), jc, JEnvConfig(**cfg), backend="xla", **kw)
    return tenv, jenv


def _backflip(**over):
    cfg = dict(dict_to_config(EnvConfig, _run("backflip")["env_config"]).__dict__)
    cfg.update(over)
    return cfg


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states(clip, B, seed, t):
    """Reference states at times ``t`` moved by numpy noise, with a random
    heading: (qpos, qvel) as float32 numpy."""
    tc, _ = _clips(clip)
    rng = np.random.default_rng(seed)
    q, v = (x.numpy().copy() for x in reference_state(tc, torch.as_tensor(t, dtype=torch.float32)))
    q[:, :3] += rng.normal(0, 0.1, (B, 3))
    yaw = rng.uniform(-np.pi, np.pi, B)
    qz = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)
    w1, x1, y1, z1 = qz.T
    w2, x2, y2, z2 = q[:, 3:7].T
    q[:, 3:7] = np.stack([w1 * w2 - z1 * z2, w1 * x2 - z1 * y2,
                          w1 * y2 + z1 * x2, w1 * z2 + z1 * w2], 1)
    q[:, 7:] += rng.normal(0, 0.05, (B, q.shape[1] - 7))
    v += rng.normal(0, 0.5, v.shape)
    return q.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("run_dir", RUN_DIRS)
def test_recipe_configs_build(run_dir, monkeypatch):
    """The training config and the eval-stripped one (pbrl_tpu's eval
    recipe, captured from ``pbrl_tpu.cli._restore_run``) build the port's
    env with pbrl_tpu's observation size; ``cli eval``'s stripped config
    equals pbrl_tpu's, ``--env-set`` applied last in both."""
    import pbrl_tpu.envs
    import pbrl_tpu.mocap
    from pbrl_tpu import cli as jcli

    run = _run(run_dir)
    clip = run["clip"]
    _, jc = _clips(clip)
    captured = {}

    def capture(model, clip_, cfg, **kw):
        captured["cfg"] = cfg
        return JMimicVecEnv(model, clip_, cfg, backend="xla")

    monkeypatch.setattr(pbrl_tpu.envs, "MimicVecEnv", capture)
    monkeypatch.setattr(pbrl_tpu.mocap, "load_clip", lambda name: jc)
    env_set = ["ref_target_lead=0.025", "pose_termination=0.5"]
    jenv_eval, _ = jcli._restore_run(types.SimpleNamespace(
        checkpoint_dir=os.path.join(CKPTS, run_dir), clip=None, env_set=env_set))
    eval_cfg = cli._overrides(cli._env_config(run), env_set, "--env-set", cli._float_or_str)
    assert config_to_dict(eval_cfg) == j_config_to_dict(captured["cfg"])

    train_cfg = dict_to_config(EnvConfig, run["env_config"])
    jenv_train = JMimicVecEnv(j_humanoid(), jc, j_dict_to_config(JEnvConfig, run["env_config"]),
                              backend="xla")
    tc, _ = _clips(clip)
    for cfg, jenv in ((train_cfg, jenv_train), (eval_cfg, jenv_eval)):
        env = MimicVecEnv(humanoid_model(), tc, cfg, device="cpu")
        assert env.observation_size == jenv.observation_size
    assert env.observation_size == (70 if run_dir in ("jump", "backflip") else 68)


@pytest.fixture(scope="module")
def link_envs():
    return _envs("backflip", _backflip(include_link_obs=True))


def test_obs_root_offset_and_links_match(link_envs):
    """Root offset and link terms at 1e-6 given the same body frames (the
    step path), and at 1e-6 on the reset path, where both packages take the
    frames from their einsum engine (4.0e-7 over 3 x 64 random states)."""
    tenv, jenv = link_envs
    B = 6
    t = np.random.default_rng(0).uniform(0.0, 2.0 * 1.75, B).astype(np.float32)
    q, v = _states("backflip", B, 1, t)
    assert tenv.observation_size == jenv.observation_size == 70 + 7 * 13
    xpos, xquat = (x.numpy() for x in tenv._fk_batch(torch.from_numpy(q), torch.from_numpy(v)))
    rng = np.random.default_rng(2)
    xpos = (xpos + rng.normal(0, 0.01, xpos.shape)).astype(np.float32)
    xquat = (xquat + rng.normal(0, 0.01, xquat.shape)).astype(np.float32)
    jobs = jax.jit(jenv._obs)
    want = np.asarray(jobs(q, v, t, xpos=xpos, xquat=xquat))
    got = tenv._obs(*(torch.from_numpy(x) for x in (q, v, t, xpos, xquat))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want = np.asarray(jobs(q, v, t))
    got = tenv._obs(*(torch.from_numpy(x) for x in (q, v, t))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("falls", ["none", "some"])
def test_reward_aerial_and_drift_match(falls):
    """Backflip's training reward (aerial window, drift shaping, early
    termination) at phases over the whole cycle, the window's edges
    included: the reward and every term within 1e-6, plus 4e-6 of the
    value, and the mean joint angle ``pose_error`` within 1e-5. The two
    packages round the quaternion dot product in their own order, and one
    float32 ulp of it moves 2 acos|<q1, q2>| squared by about 8 x 6e-8
    per joint (a pose reward near 0.6 by up to 1.7e-6) and the angle
    itself by 4 x 6e-8 / angle."""
    tenv, jenv = _envs("backflip", _backflip())
    ph = np.array([0.0, 0.26, 0.27, 0.28, 0.3, 0.4, 0.49, 0.5, 0.51, 0.8, 1.3, 1.45])
    t = (ph * 1.75).astype(np.float32)
    B = t.shape[0]
    q, v = _states("backflip", B, 3, t)
    xpos, xquat = (x.numpy() for x in tenv._fk_batch(torch.from_numpy(q), torch.from_numpy(v)))
    fall = (np.zeros(B) if falls == "none" else np.arange(B) % 3 == 0).astype(np.float32)
    want_r, want_terms = jax.jit(jenv._reward_batch)(q, v, t, xpos, xquat, fall)
    got_r, got_terms = tenv._reward_batch(*(torch.from_numpy(x)
                                            for x in (q, v, t, xpos, xquat, fall)))
    np.testing.assert_allclose(_np(got_r), np.asarray(want_r), atol=1e-6, rtol=4e-6)
    assert set(got_terms) == set(want_terms)
    for k in got_terms:
        np.testing.assert_allclose(_np(got_terms[k]), np.asarray(want_terms[k]),
                                   atol=1e-5 if k == "pose_error" else 1e-6, rtol=4e-6,
                                   err_msg=k)
    if falls == "some":
        assert np.all(_np(got_r)[fall > 0] == 0.0)


def _vec_state(js):
    return VecState(**{k: torch.from_numpy(np.array(getattr(js, k)))
                       for k in ("qpos", "qvel", "time", "episode_start", "obs", "reward",
                                 "done")},
                    metrics={k: torch.from_numpy(np.array(v)) for k, v in js.metrics.items()})


def _curriculum_draws(jenv, js, keys):
    """pbrl_tpu's curriculum draws (u, peer) re-derived from its keys, and
    which envs may be drawn."""
    lo, hi = jenv.config.curriculum_phase_window

    @jax.jit
    def draws(done, time, keys):
        ph = jax.vmap(lambda tt: jclip.phase(jenv.clip, tt))(time)
        ok = (done == 0) & (ph >= lo) & (ph <= hi)
        logits = jnp.where(ok, 0.0, -1e9)
        u = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 7), ()))(keys)
        peer = jax.vmap(lambda k: jax.random.categorical(jax.random.fold_in(k, 8),
                                                         logits))(keys)
        return u, peer, ok

    return tuple(np.array(x) for x in draws(js.done, js.time, keys))


@functools.lru_cache(maxsize=None)
def _curriculum_envs(recenter):
    """Both envs at the curriculum test's config, with pbrl_tpu's reset and
    auto_reset compiled once for the cases that share them."""
    cfg = _backflip(curriculum_reset_prob=0.6, rsi_noise_root_xy=0.0,
                    curriculum_recenter_xy=recenter)
    tenv, jenv = _envs("backflip", cfg)
    return tenv, jenv, jax.jit(jenv.reset), jax.jit(jenv.auto_reset), jax.jit(jenv._obs)


@pytest.mark.parametrize("case", ["mixed", "mixed-no-recenter", "all-masked"])
def test_curriculum_auto_reset_matches(case):
    """The takeoff-state curriculum from shared states, fed pbrl_tpu's
    draws: a mixed done mask with envs in and out of the phase window
    (recentred or not), and a batch whose window masks every env. The
    restart probability is raised from backflip's 0.15 to 0.6 so that
    several of 8 envs adopt a peer; reset noise is off, as its draws
    cannot be shared."""
    tenv, jenv, reset, auto_reset, obs = _curriculum_envs(case != "mixed-no-recenter")
    B = 8
    js = reset(jax.random.split(jax.random.PRNGKey(0), B))
    rng = np.random.default_rng(5)
    if case == "all-masked":
        ph = np.array([0.1, 0.2, 0.3, 0.45, 0.6, 0.7, 0.96, 0.99])
        done = np.array([0, 0, 0, 0, 1, 1, 0, 0], np.float32)
    else:
        ph = np.array([0.1, 0.55, 0.7, 0.9, 0.3, 0.6, 0.97, 0.8])
        done = np.array([1, 0, 1, 0, 1, 1, 0, 1], np.float32)
    t = jnp.asarray(ph * 1.75 + 1.75, jnp.float32)  # the second cycle: xy offset nonzero
    js = js.replace(
        qpos=js.qpos + jnp.asarray(rng.normal(0, 0.05, js.qpos.shape), jnp.float32),
        qvel=js.qvel + jnp.asarray(rng.normal(0, 0.5, js.qvel.shape), jnp.float32),
        time=t, episode_start=t - 0.3, reward=jnp.asarray(rng.uniform(size=B), jnp.float32),
        done=jnp.asarray(done),
        metrics={k: jnp.asarray(rng.uniform(size=B), jnp.float32) for k in js.metrics})
    js = js.replace(obs=obs(js.qpos, js.qvel, js.time))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    want = auto_reset(js, keys)
    u, peer, ok = _curriculum_draws(jenv, js, keys)
    adopted = (done > 0) & (u < 0.6) & ok[peer]
    assert adopted.any() == (case != "all-masked")
    fresh_t0 = torch.from_numpy(np.array(reset(keys).time))

    ts = _vec_state(js)
    got = tenv.auto_reset(ts, t0=fresh_t0, u=torch.from_numpy(u), peer=torch.from_numpy(peer))
    for k, tol in (("qpos", 1e-5), ("qvel", 1e-4), ("time", 0), ("episode_start", 0),
                   ("obs", 1e-4), ("reward", 0), ("done", 0)):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                   atol=tol, rtol=0, err_msg=k)
    for k in got.metrics:
        np.testing.assert_array_equal(_np(got.metrics[k]), np.asarray(want.metrics[k]))

    # the port's own draws: every adopted peer is eligible; none when all are masked
    gen = torch.Generator().manual_seed(0)
    own = tenv.auto_reset(ts, gen, t0=fresh_t0, u=torch.zeros(B))
    fresh = tenv.reset(B, t0=fresh_t0)
    moved = (own.time != fresh.time).numpy() & (done > 0)
    if case == "all-masked":
        assert not moved.any()
    else:
        assert moved[done > 0].all()
        eligible = set(np.asarray(js.time)[ok].tolist())
        assert set(own.time.numpy()[moved].tolist()) <= eligible


@pytest.mark.parametrize("mode", ["pd", "torque"])
def test_actuator_mask_matches(mode):
    """An actuator mask folds into the kernel's gains as pbrl_tpu folds
    it (the spec pbrl_tpu's kernel path builds, field by field), and in
    torque mode scales the action that reaches the physics."""
    mask = (np.random.default_rng(7).uniform(size=28) > 0.3).astype(np.float32)
    cfg = dict(SUBSTEPS2, action_mode="absolute" if mode == "pd" else "torque",
               kp_scale=1.5)
    tenv, jenv = _envs("walk", cfg, actuator_mask=mask)
    gains = jenv._masked_gains
    want = jfp.build_spec(jenv.model, kp=np.asarray(gains.kp), kd=np.asarray(gains.kd),
                          n_substeps=2, mode=mode, fall_allowed_bodies=ALLOWED,
                          torque_scale=jenv.config.torque_limit_scale)
    got = tenv._kspec
    assert np.sum(mask == 0) > 0
    for k in ("kp", "kd", "tau_lo", "tau_hi"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-7, err_msg=k)
    assert got.limits == want.limits and got.mode == want.mode == mode

    B = 3
    q, v = _states("walk", B, 8, np.array([0.1, 0.5, 0.9], np.float32))
    act = np.random.default_rng(9).normal(0, 10.0 if mode == "torque" else 0.3,
                                          (B, 28)).astype(np.float32)
    seen = {}

    class Stop(Exception):
        pass

    def j_physics(qpos, qvel, u):
        seen["jax"] = np.asarray(u)
        raise Stop

    jenv._physics = j_physics
    jenv._target = jax.jit(jenv._target)
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    with pytest.raises(Stop):
        jenv.step(js.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v)), jnp.asarray(act))
    kstep = tenv._kstep
    tenv._kstep = lambda a, b, u: (seen.__setitem__("port", u.numpy()), kstep(a, b, u))[1]
    ts = tenv.reset(B, t0=torch.from_numpy(np.asarray(js.time)))
    tenv.step(ts.replace(qpos=torch.from_numpy(q), qvel=torch.from_numpy(v)),
              torch.from_numpy(act))
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=1e-6, rtol=0)
    if mode == "torque":
        assert np.all(seen["port"][:, mask == 0] == 0.0)


def test_backflip_training_step_and_auto_reset_match():
    """One whole step and ``auto_reset`` at backflip's training config
    (residual targets, no joint limits, torque scale 2.5, root offset obs,
    aerial window, drift, curriculum), 2 envs, from shared states; reset
    noise off, as its draws cannot be shared."""
    cfg = _backflip(rsi_noise_root_xy=0.0, **SUBSTEPS2)
    tenv, jenv = _envs("backflip", cfg)
    jenv._physics = _jax_field_physics(jenv)
    # pbrl_tpu's own target, reward and observation code, compiled (cheaper
    # than eager)
    for name in ("_target", "_reward_batch", "_obs"):
        setattr(jenv, name, jax.jit(getattr(jenv, name)))
    B = 2
    reset = jax.jit(jenv.reset)
    js = reset(jax.random.split(jax.random.PRNGKey(0), B))
    t = jnp.asarray([0.2, 1.2], jnp.float32)
    q0, v0 = jax.jit(jax.vmap(lambda tt: jclip.reference_state(jenv.clip, tt)))(t)
    js = js.replace(qpos=q0, qvel=v0, time=t, episode_start=t,
                    obs=jenv._obs(q0, v0, t))
    ts = tenv.reset(B, t0=torch.from_numpy(np.array(t)))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), atol=1e-4, rtol=0)
    ts = ts.replace(qpos=torch.from_numpy(np.array(js.qpos)),
                    qvel=torch.from_numpy(np.array(js.qvel)))
    act = (np.random.default_rng(10).normal(size=(B, 28)) * 0.05).astype(np.float32)

    js2 = jenv.step(js, jnp.asarray(act))
    ts2 = tenv.step(ts, torch.from_numpy(act))
    obs_t, obs_j = ts2.obs.numpy(), np.asarray(js2.obs)
    np.testing.assert_allclose(obs_t[:, :33], obs_j[:, :33], atol=1e-4, rtol=0)  # qpos
    np.testing.assert_allclose(obs_t[:, 33:67], obs_j[:, 33:67], atol=5e-3, rtol=0)  # qvel
    np.testing.assert_allclose(obs_t[:, 67:], obs_j[:, 67:], atol=1e-4, rtol=0)  # phase, offset
    np.testing.assert_allclose(ts2.reward.numpy(), np.asarray(js2.reward), atol=1e-3, rtol=0)
    for k in ("reward_pose", "reward_vel", "reward_ee", "reward_com", "root_err"):
        np.testing.assert_allclose(ts2.metrics[k].numpy(), np.asarray(js2.metrics[k]),
                                   atol=1e-3, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ts2.done.numpy(), np.asarray(js2.done))
    np.testing.assert_array_equal(ts2.metrics["fall"].numpy(), np.asarray(js2.metrics["fall"]))
    np.testing.assert_allclose(ts2.time.numpy(), np.asarray(js2.time), atol=1e-6)

    done = jnp.asarray([1.0, 0.0])  # env 0 finished; env 1 (phase 0.69) is a peer
    js2 = js2.replace(done=done)
    ts2 = ts2.replace(done=torch.from_numpy(np.array(done)))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jax.jit(jenv.auto_reset)(js2, keys)
    u, peer, _ = _curriculum_draws(jenv, js2, keys)
    got = tenv.auto_reset(ts2, t0=torch.from_numpy(np.array(reset(keys).time)),
                          u=torch.from_numpy(u), peer=torch.from_numpy(peer))
    for k, tol in (("qpos", 1e-4), ("qvel", 5e-3), ("time", 1e-6), ("episode_start", 1e-6),
                   ("obs", 5e-3)):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                   atol=tol, rtol=0, err_msg=k)


def test_imported_backflip_state_unwraps_env_steps(tmp_path):
    """pbrl_tpu's int32 env-step counter wrapped in ``ckpts/backflip``;
    the imported checkpoint holds the count Adam's updates imply."""
    with np.load(checkpoint.bundled_train_state("backflip")) as z:
        raw, count, step = int(z["env_steps"]), int(z["opt/count"]), int(z["step"])
    assert raw < 0 and step == 201410
    d = str(tmp_path / "backflip")
    assert checkpoint.import_train_state(d, checkpoint.bundled_train_state("backflip"),
                                         checkpoint.bundled_policy("backflip")) == 201410
    payload = checkpoint.restore(d)
    assert payload["opt"]["count"] == count
    assert payload["env_steps"] == count // 32 * 2048 * 16
    assert (payload["env_steps"] - raw) % 2 ** 32 == 0


def test_cli_eval_backflip_cpu(capsys):
    """``cli eval --clip backflip`` finds the bundled policy and runs
    (at 2 substeps per policy step, through ``--env-set``)."""
    assert cli.main(["eval", "--device", "cpu", "--clip", "backflip", "--num-envs", "2",
                     "--steps", "2", "--env-set", "policy_dt=0.004"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["eval_episode_length"] == 2.0
    assert all(np.isfinite(v) for v in out.values())

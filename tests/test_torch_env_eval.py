"""MimicVecEnv, the policy networks and deterministic evaluation of the
port against pbrl_tpu.

The env step is held against pbrl_tpu's ``MimicVecEnv`` from the same
reset states. pbrl_tpu's einsum-engine step (``backend="xla"``) costs
about 46 s of XLA compilation on CPU, so its physics here is pbrl_tpu's
field program (its kernel's math, run eagerly), whose agreement with the
einsum engine tests/test_field_physics.py holds; everything else in the
JAX step (targets, NaN quarantine, observation, the four reward terms,
termination) is pbrl_tpu's own code.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.mocap.skeleton import generate_kp_kd_gains
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu.ops import field_physics as jfp
from pbrl_tpu.train import networks as jnet
from pbrl_tpu.train import ppo as jppo
from pbrl_tpu.train import running_stats as jrs
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import checkpoint, evaluate
from pbrl_tpu_torch.train.ppo import alive_masked_metrics

ALLOWED = ("right_ankle", "left_ankle")
# Two physics substeps per policy step keep the eager JAX physics cheap (as
# tests/test_vec_env.py does); each substep is held against pbrl_tpu in
# test_torch_field_physics.py, and the 8-substep kernel against its plain
# version on the card by chip_smoke.py.
SUBSTEPS2 = dict(policy_dt=0.004, physics_dt=0.002)


@pytest.fixture(scope="module")
def walk():
    return augment_clip(humanoid_model(), load_clip("walk", device="cpu"))


def _jax_field_physics(jenv):
    """pbrl_tpu's policy step through its field program, eagerly."""
    kp, kd = generate_kp_kd_gains()
    c = jenv.config
    spec = jfp.build_spec(jenv.model, kp=kp, kd=kd, n_substeps=c.n_substeps, mode="pd",
                          fall_allowed_bodies=ALLOWED, torque_scale=c.torque_limit_scale)

    def physics(qpos, qvel, u):
        rows = lambda a: [a[:, i] for i in range(a.shape[1])]
        q, v, fall, held = jfp.substep(spec, rows(qpos), rows(qvel), rows(u))
        for _ in range(1, spec.n_substeps):
            q, v, f, _ = jfp.substep(spec, q, v, rows(u), held_self=held or None)
            fall = jnp.maximum(fall, f)
        xp, xq = jfp.fk_outputs(spec, q)
        B = qpos.shape[0]
        return (jnp.stack(q, 1), jnp.stack(v, 1),
                jnp.stack([jnp.stack(p, 1) for p in xp], 1).reshape(B, -1, 3),
                jnp.stack([jnp.stack(r, 1) for r in xq], 1).reshape(B, -1, 4), fall)

    return physics


def test_env_step_matches_jax(walk):
    B = 4
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    jenv = JMimicVecEnv(j_humanoid(), jc, JEnvConfig(**SUBSTEPS2), backend="xla")
    jenv._physics = _jax_field_physics(jenv)
    # pbrl_tpu's own reward and observation code, compiled (cheaper than eager)
    jenv._reward_batch = jax.jit(jenv._reward_batch)
    jenv._obs = jax.jit(jenv._obs)
    tenv = MimicVecEnv(humanoid_model(), walk, EnvConfig(**SUBSTEPS2), device="cpu")
    assert tenv.observation_size == jenv.observation_size == 68

    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    ts = tenv.reset(B, t0=torch.from_numpy(np.array(js.time)))
    np.testing.assert_allclose(ts.qpos.numpy(), np.asarray(js.qpos), atol=1e-5)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), atol=1e-4)
    ts = ts.replace(qpos=torch.from_numpy(np.array(js.qpos)),
                    qvel=torch.from_numpy(np.array(js.qvel)))
    rng = np.random.default_rng(0)
    act = (np.asarray(js.qpos)[:, 7:] + rng.normal(size=(B, 28)) * 0.05).astype(np.float32)

    js2 = jenv.step(js, jnp.asarray(act))
    ts2 = tenv.step(ts, torch.from_numpy(act))
    assert tenv._kstep.launches == 0  # CPU: the plain version, no kernel launch
    obs_t, obs_j = ts2.obs.numpy(), np.asarray(js2.obs)
    np.testing.assert_allclose(obs_t[:, :33], obs_j[:, :33], atol=1e-4)   # qpos part
    np.testing.assert_allclose(obs_t[:, 33:67], obs_j[:, 33:67], atol=5e-3)  # qvel
    np.testing.assert_allclose(obs_t[:, 67], obs_j[:, 67], atol=1e-6)     # phase
    np.testing.assert_allclose(ts2.reward.numpy(), np.asarray(js2.reward), atol=1e-3)
    for k in ("reward_pose", "reward_vel", "reward_ee", "reward_com"):
        np.testing.assert_allclose(ts2.metrics[k].numpy(), np.asarray(js2.metrics[k]),
                                   atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(ts2.done.numpy(), np.asarray(js2.done))
    np.testing.assert_array_equal(ts2.metrics["fall"].numpy(), np.asarray(js2.metrics["fall"]))
    np.testing.assert_allclose(ts2.time.numpy(), np.asarray(js2.time), atol=1e-6)


def _flax_policy_apply(params, obs):
    net = jnet.PolicyNetwork(action_size=28)
    return net.apply(params, jnp.asarray(obs))


def test_converted_policy_matches_flax():
    params, _, _ = jnet.init_params(jax.random.PRNGKey(3), 68, 28)
    pol = flax.core.unfreeze(params["policy"])
    # log_std beyond both clamp bounds exercises the clamp
    pol["params"]["log_std"] = jnp.linspace(-3.0, 1.0, 28)
    pol = jax.tree_util.tree_map(np.asarray, pol)
    obs = np.random.default_rng(1).normal(size=(16, 68)).astype(np.float32)
    want_mean, want_ls = _flax_policy_apply(pol, obs)
    net = checkpoint.policy_from_params(pol)
    with torch.no_grad():
        mean, ls = net(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=1e-5)
    np.testing.assert_allclose(ls.numpy(), np.asarray(want_ls), atol=1e-6)
    assert net.torso.hidden_0.weight.shape == (1024, 68)


# ckpts/ run directory of each shipped clip's recipe
RUN_DIRS = {"walk": "walk", "getup_facedown": "getup", "getup_faceup": "getup_faceup",
            "kick": "kick", "punch": "punch", "jump": "jump", "backflip": "backflip"}


@pytest.mark.parametrize("clip", list(RUN_DIRS))
def test_bundled_walk_policy_matches_flax(clip):
    """Each shipped clip's bundled .npz maps onto the port's modules as
    flax reads the Orbax checkpoint it was exported from. Means to 1e-5
    and, past walk's, 2e-6 relative: jump's and backflip's reach 27, where
    float32 sums over 1024 products round to about 1e-6 of the value."""
    import os

    from pbrl_tpu.train import checkpoint as jckpt

    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "ckpts",
                           RUN_DIRS[clip])
    net, stats, run = checkpoint.load_policy(checkpoint.bundled_policy(clip), device="cpu")
    want_run = jckpt.load_run_config(run_dir)
    assert run == want_run and run["clip"] == clip
    payload = jax.tree_util.tree_map(np.asarray, jckpt.restore(run_dir))
    obs_size = payload["obs_stats"]["mean"].shape[0]
    assert obs_size == (70 if run["env_config"]["include_ref_root_offset"] else 68)
    obs = np.random.default_rng(2).normal(size=(8, obs_size)).astype(np.float32)
    want_mean, want_ls = _flax_policy_apply(payload["params"]["policy"], obs)
    with torch.no_grad():
        mean, ls = net(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=1e-5,
                               rtol=1e-7 if clip == "walk" else 2e-6)
    np.testing.assert_allclose(ls.numpy(), np.asarray(want_ls), atol=1e-6)
    for k in ("count", "mean", "m2"):
        np.testing.assert_array_equal(getattr(stats, k).numpy(), payload["obs_stats"][k])


@flax.struct.dataclass
class _ScriptedState:
    t: jnp.ndarray
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    metrics: dict


class _ScriptedEnv:
    """A vectorized JAX env whose rewards and dones come from a table."""

    is_vectorized = True
    observation_size = 3
    action_size = 2

    def __init__(self, rew, done):
        self.rew, self.done = jnp.asarray(rew), jnp.asarray(done)

    def reset(self, keys):
        B = keys.shape[0]
        return _ScriptedState(t=jnp.zeros((), jnp.int32), obs=jnp.zeros((B, 3)),
                              reward=jnp.zeros(B), done=jnp.zeros(B),
                              metrics={"pose_error": jnp.zeros(B)})

    def step(self, s, action):
        return s.replace(t=s.t + 1, reward=self.rew[s.t], done=self.done[s.t],
                         metrics={"pose_error": 0.5 * self.rew[s.t]})


def test_alive_masking_matches_pbrl_tpu():
    rng = np.random.default_rng(4)
    T, B = 6, 3
    rew = rng.uniform(0, 1, (T, B)).astype(np.float32)
    done = np.zeros((T, B), np.float32)
    done[2, 0] = 1.0   # env 0 ends at step 3
    done[4, 1] = 1.0   # env 1 ends at step 5, then reports done again
    done[5, 1] = 1.0
    env = _ScriptedEnv(rew, done)
    cfg = jppo.TrainConfig(hidden=(4,), num_envs=B, total_env_steps=1000)
    _, _, j_eval = jppo.make_train_functions(env, cfg)
    params, _, _ = jnet.init_params(jax.random.PRNGKey(0), 3, 2, (4,))
    want = j_eval(params, jrs.init(3), jax.random.PRNGKey(0), num_envs=B, num_steps=T)
    got = alive_masked_metrics(torch.from_numpy(rew), torch.from_numpy(done),
                               torch.from_numpy(0.5 * rew))
    for k in ("eval_reward", "eval_episode_length", "eval_pose_error"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    assert float(got["eval_episode_length"]) == pytest.approx((2 + 4 + 6) / 3)


def test_evaluate_two_steps_cpu(walk):
    net, stats, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device="cpu")
    env = MimicVecEnv(humanoid_model(), walk, EnvConfig(), device="cpu")
    out = evaluate(env, net, stats, num_envs=2, num_steps=2,
                   generator=torch.Generator().manual_seed(0))
    assert float(out["eval_episode_length"]) == 2.0
    assert all(np.isfinite(float(v)) for v in out.values())
    assert 0.5 < float(out["eval_reward"]) <= 1.0
    assert env._kstep.launches == 0


@pytest.mark.parametrize("cfg,backend", [
    ({"controller": "standard_pd"}, "kernel"),
    ({"controller": "inverse_dynamics_pd"}, "kernel"),
    ({"controller": "standard_pd", "pd_per_substep": False}, "xla"),
    ({"controller": "inverse_dynamics_pd", "pd_per_substep": False}, "xla"),
], ids=["kernel_standard", "kernel_inverse", "held_standard", "held_inverse"])
def test_remaining_refusals_match_jax(walk, cfg, backend):
    """The refusals left are pbrl_tpu's own: the kernel backend implements
    implicit and Stable PD only, held PD the Stable-PD law only; both
    packages raise ValueError for the same configs."""
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    with pytest.raises(ValueError, match="implements"):
        JMimicVecEnv(j_humanoid(), jc, JEnvConfig(**cfg), backend=backend)
    with pytest.raises(ValueError, match="implements"):
        MimicVecEnv(humanoid_model(), walk, EnvConfig(**cfg), backend=backend, device="cpu")

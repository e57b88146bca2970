"""The port's ``MimicEnv`` against pbrl_tpu's: reset and one step at 2 envs
(vmapped and jitted in pbrl_tpu, batched in the port), 2 physics substeps
per policy step, implicit PD re-solved every substep.

Tolerances: the reset state 1e-5 (the reference lookup, as
tests/test_envs.py), its observation and reward terms 1e-5; the step as
tests/test_torch_env_eval.py's env step (observation qpos part 1e-4, qvel
part 5e-3, phase 1e-6, reward and terms 1e-3, done and fall exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicEnv as JMimicEnv
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.kinematics import kinematics
from pbrl_tpu_torch.envs import EnvConfig, MimicEnv
from pbrl_tpu_torch.model import humanoid_model
from test_torch_envs import walk_pair  # noqa: F401 (fixture)

SUBSTEPS2 = dict(policy_dt=0.004, physics_dt=0.002)


def test_mimic_env_matches_jax(walk_pair):
    jc, walk = walk_pair
    B = 2
    jenv = JMimicEnv(j_humanoid(), jc, JEnvConfig(**SUBSTEPS2))
    tenv = MimicEnv(humanoid_model(), walk, EnvConfig(**SUBSTEPS2))
    assert tenv.observation_size == jenv.observation_size and tenv.action_size == 28
    js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(1), B))
    ts = tenv.reset(B, t0=torch.from_numpy(np.array(js.pipeline.time)))
    np.testing.assert_allclose(ts.pipeline.qpos.numpy(), np.asarray(js.pipeline.qpos),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), atol=1e-5, rtol=0)
    for k in ("step_index", "reward_pose", "reward_vel", "reward_ee", "reward_com", "fall"):
        np.testing.assert_allclose(ts.metrics[k].numpy(), np.asarray(js.metrics[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    # the step from pbrl_tpu's exact reset state
    q, v, t = (torch.from_numpy(np.array(x)) for x in
               (js.pipeline.qpos, js.pipeline.qvel, js.pipeline.time))
    d = kinematics(tenv.model, make_data(tenv.model, q, v).replace(time=t))
    ts = ts.replace(pipeline=d, info={"episode_start": t})
    act = (np.asarray(js.pipeline.qpos)[:, 7:]
           + np.random.default_rng(2).normal(size=(B, 28)) * 0.05).astype(np.float32)
    js2 = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(act))
    ts2 = tenv.step(ts, torch.from_numpy(act))
    obs_t, obs_j = ts2.obs.numpy(), np.asarray(js2.obs)
    np.testing.assert_allclose(obs_t[:, :33], obs_j[:, :33], atol=1e-4, rtol=0)
    np.testing.assert_allclose(obs_t[:, 33:67], obs_j[:, 33:67], atol=5e-3, rtol=0)
    np.testing.assert_allclose(obs_t[:, 67], obs_j[:, 67], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts2.reward.numpy(), np.asarray(js2.reward), atol=1e-3, rtol=0)
    for k in ("reward_pose", "reward_vel", "reward_ee", "reward_com", "pose_error"):
        np.testing.assert_allclose(ts2.metrics[k].numpy(), np.asarray(js2.metrics[k]),
                                   atol=1e-3, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ts2.done.numpy(), np.asarray(js2.done))
    np.testing.assert_array_equal(ts2.metrics["fall"].numpy(), np.asarray(js2.metrics["fall"]))
    np.testing.assert_allclose(ts2.pipeline.time.numpy(), np.asarray(js2.pipeline.time),
                               atol=1e-6, rtol=0)

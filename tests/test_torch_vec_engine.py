"""One ``MimicVecEnv.step`` on each path this port added, against
pbrl_tpu's ``backend="xla"`` env (its einsum engine, vmapped and jitted)
from shared reset states: held-torque PD (``pd_per_substep=False``) on the
port's kernel backend (the kernel's plain version on the CPU, in
``torque`` mode) and on its engine backend (tests/test_torch_vec_held.py),
the engine backend with implicit and Stable PD (here), with standard PD
(tests/test_torch_vec_controllers.py) and inverse-dynamics PD
(tests/test_torch_vec_inverse_pd.py); each pbrl_tpu env step is an XLA
compile of tens of seconds on the CPU, so they run as four files. 2 envs,
2 physics substeps per policy step (as tests/test_torch_env_eval.py),
noisy absolute targets.

Tolerances as tests/test_torch_env_eval.py's env step: observation qpos
part 1e-4, qvel part 5e-3, phase 1e-6; reward and each reward term 1e-3;
done, fall and time exact (time 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model

SUBSTEPS2 = dict(policy_dt=0.004, physics_dt=0.002)


def step_pair(cfg_kw, backends=("xla",), B=2, seed=0):
    """pbrl_tpu's xla env and the port's env on each of ``backends``, one
    step from the same reset states and actions: (jax state, {backend:
    port state}, {backend: port env})."""
    walk = augment_clip(humanoid_model(), load_clip("walk", device="cpu"))
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    jenv = JMimicVecEnv(j_humanoid(), jc, JEnvConfig(**SUBSTEPS2, **cfg_kw), backend="xla")
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(seed), B))
    rng = np.random.default_rng(seed)
    act = (np.asarray(js.qpos)[:, 7:] + rng.normal(size=(B, 28)) * 0.05).astype(np.float32)
    js2 = jax.jit(jenv.step)(js, jnp.asarray(act))
    out, envs = {}, {}
    for backend in backends:
        tenv = MimicVecEnv(humanoid_model(), walk, EnvConfig(**SUBSTEPS2, **cfg_kw),
                           backend=backend, device="cpu")
        ts = tenv.reset(B, t0=torch.from_numpy(np.array(js.time)))
        ts = ts.replace(qpos=torch.from_numpy(np.array(js.qpos)),
                        qvel=torch.from_numpy(np.array(js.qvel)))
        out[backend] = tenv.step(ts, torch.from_numpy(act))
        envs[backend] = tenv
    return js2, out, envs


def assert_step_matches(ts2, js2):
    obs_t, obs_j = ts2.obs.numpy(), np.asarray(js2.obs)
    np.testing.assert_allclose(obs_t[:, :33], obs_j[:, :33], atol=1e-4, rtol=0)
    np.testing.assert_allclose(obs_t[:, 33:67], obs_j[:, 33:67], atol=5e-3, rtol=0)
    np.testing.assert_allclose(obs_t[:, 67], obs_j[:, 67], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts2.reward.numpy(), np.asarray(js2.reward), atol=1e-3, rtol=0)
    for k in ("reward_pose", "reward_vel", "reward_ee", "reward_com"):
        np.testing.assert_allclose(ts2.metrics[k].numpy(), np.asarray(js2.metrics[k]),
                                   atol=1e-3, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ts2.done.numpy(), np.asarray(js2.done))
    np.testing.assert_array_equal(ts2.metrics["fall"].numpy(), np.asarray(js2.metrics["fall"]))
    np.testing.assert_allclose(ts2.time.numpy(), np.asarray(js2.time), atol=1e-6, rtol=0)


@pytest.mark.parametrize("controller", ["implicit_pd", "stable_pd"])
def test_engine_backend_matches_jax(controller):
    js2, out, _ = step_pair({"controller": controller})
    assert_step_matches(out["xla"], js2)

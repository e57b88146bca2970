"""The port's controllers and trajectories against pbrl_tpu's.

The four PD laws, ``clamp_torque``, ``masked_torque`` and
``torque_to_qfrc`` run on the same ``forward_smooth`` data (pbrl_tpu's,
vmapped and jitted once, converted for the port) and the same targets;
``MimicVecEnv._held_tau`` (forward_smooth, one Stable-PD solve per env,
clamp, mask) against pbrl_tpu's on 4 envs. Tolerances: torques 1e-5 of the
largest (standard PD 1e-6: no solve; Stable and inverse-dynamics PD go
through the mass matrix, and Stable PD through a 34x34 solve), the held
torque 1e-4 relative as asked of it; trajectories 1e-6.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrl_tpu.engine  # noqa: F401
from pbrl_tpu import control as jctrl
from pbrl_tpu.engine import data as jdata
from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu_torch import control as tctrl
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from test_torch_engine import humanoid_states, scaled, to_torch

jfwd = sys.modules["pbrl_tpu.engine.forward"]
LAWS = ("standard_pd", "inverse_dynamics_pd", "stable_pd", "implicit_pd")


@pytest.fixture(scope="module")
def smooth():
    jm, tm = j_humanoid(), humanoid_model()
    qpos, qvel, target = humanoid_states(4, seed=6)
    jg = jctrl.default_gains()
    applied = np.random.default_rng(7).normal(size=(4, tm.nv)).astype(np.float32)

    def one(q, v, u, fa):
        d = jfwd.forward_smooth(jm, jdata.make_data(jm, qpos=q, qvel=v))
        d = d.replace(qfrc_applied=fa)  # Stable PD reads the applied force
        imp = jctrl.implicit_pd(jm, d, u, jg, clamp_scale=2.0)
        return d, {"standard_pd": jctrl.standard_pd(jm, d, u, jg),
                   "inverse_dynamics_pd": jctrl.inverse_dynamics_pd(jm, d, u, jg),
                   "stable_pd": jctrl.stable_pd(jm, d, u, jg),
                   "implicit_pd": (imp.qfrc_applied, imp.imp_damping)}

    jd, taus = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (qpos, qvel, target, applied)))
    return jm, tm, to_torch(jd), torch.from_numpy(target), taus


@pytest.mark.parametrize("law", LAWS)
def test_pd_law_matches_jax(smooth, law):
    jm, tm, td, u, taus = smooth
    gains = tctrl.default_gains()
    if law == "implicit_pd":
        out = tctrl.implicit_pd(tm, td, u, gains, clamp_scale=2.0)
        scaled(out.qfrc_applied, taus[law][0], 1e-6)
        scaled(out.imp_damping, taus[law][1], 0.0)
        return
    got = getattr(tctrl, law)(tm, td, u, gains)
    assert got.shape == (4, tm.nu)
    scaled(got, taus[law], 1e-6 if law == "standard_pd" else 1e-5)


def test_clamp_mask_scatter_match_jax(smooth):
    jm, tm, _, _, taus = smooth
    tau = np.array(taus["stable_pd"])
    mask = (np.arange(tm.nu) % 3 != 0)
    for scale in (1.0, 2.5):
        want = jax.vmap(lambda t: jctrl.clamp_torque(jm, t, scale))(jnp.asarray(tau))
        scaled(tctrl.clamp_torque(tm, torch.from_numpy(tau), scale), want, 0.0)
    want = jax.vmap(lambda t: jctrl.masked_torque(t, jnp.asarray(mask)))(jnp.asarray(tau))
    scaled(tctrl.masked_torque(torch.from_numpy(tau), mask), want, 0.0)
    want = jax.vmap(lambda t: jctrl.torque_to_qfrc(jm, t))(jnp.asarray(tau))
    scaled(tctrl.torque_to_qfrc(tm, torch.from_numpy(tau)), want, 0.0)


def test_trajectories_match_jax():
    rng = np.random.default_rng(8)
    q0, qf = rng.uniform(-1, 1, (2, 28)).astype(np.float32)
    jt = jctrl.cubic_coefficients(0.5, 2.0, jnp.asarray(q0), jnp.asarray(qf))
    tt = tctrl.cubic_coefficients(0.5, 2.0, torch.from_numpy(q0), torch.from_numpy(qf))
    scaled(tt, jt, 1e-6)
    jtab = jctrl.set_trajectories(jctrl.constant_trajectories(28, 0.1), [1, 5], jt[:2])
    ttab = tctrl.set_trajectories(tctrl.constant_trajectories(28, 0.1), [1, 5], tt[:2])
    scaled(ttab, jtab, 1e-6)
    for t in (0.5, 1.3, 2.0):
        scaled(tctrl.evaluate(ttab, t), jctrl.evaluate(jtab, t), 1e-6)
        scaled(tctrl.evaluate_velocity(ttab, t), jctrl.evaluate_velocity(jtab, t), 1e-6)


def test_held_tau_matches_jax():
    """``_held_tau`` on 4 envs at 1e-4 relative of the largest torque, with
    an actuator mask (pbrl_tpu's env with the same mask) and without it
    (held against the same torques where the mask lets them through)."""
    walk = augment_clip(humanoid_model(), load_clip("walk", device="cpu"))
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    mask = np.arange(28) % 4 != 1
    jenv = JMimicVecEnv(j_humanoid(), jc, JEnvConfig(pd_per_substep=False), backend="xla",
                        actuator_mask=jnp.asarray(mask))
    qpos, qvel, target = humanoid_states(4, seed=9)
    want = np.asarray(jax.jit(jenv._held_tau)(*(jnp.asarray(x) for x in (qpos, qvel, target))))
    args = [torch.from_numpy(x) for x in (qpos, qvel, target)]
    for m in (mask, None):
        tenv = MimicVecEnv(humanoid_model(), walk, EnvConfig(pd_per_substep=False),
                           actuator_mask=m, device="cpu")
        got = tenv._held_tau(*args)
        if m is None:
            got = got[:, mask]
        scaled(got, want if m is not None else want[:, mask], 1e-4)
        assert m is None or np.all(got.numpy()[:, ~mask] == 0.0)
    assert np.abs(want).max() > 1.0

"""``scripts/torch_reward_parity.py``'s MuJoCo side against
``scripts/reward_parity.py::mujoco_rollout`` (pbrl_tpu's), on walk's
bundled policy over 5 policy steps from the clip start: the same MuJoCo
model, Stable-PD law and reward, with the port's policy, observation and
reward on one side and pbrl_tpu's on the other. Rewards within 1e-5, qpos
within 1e-6. Also the port's side of the protocol (its engine from the
clip start) and the row's fields on 3 steps. Skipped without MuJoCo, as
``tests/test_oracle_mujoco.py`` is.
"""

import argparse
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_env():
    from pbrl_tpu_torch.cli import _policy_env

    port = _script("torch_reward_parity")
    policy, stats, _, env = _policy_env(argparse.Namespace(
        checkpoint_dir=None, clip="walk", policy=None, device="cpu", env_set=[]))
    return port, policy, stats, port.parity_env(env)


def _pbrl_tpu_side(port_env):
    """pbrl_tpu's parity env at the same config, and walk's bundled policy
    as flax params and pbrl_tpu obs stats."""
    import jax.numpy as jnp

    from pbrl_tpu.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu.mocap import load_clip
    from pbrl_tpu.model import humanoid_model
    from pbrl_tpu.train.networks import PolicyNetwork
    from pbrl_tpu.train.running_stats import RunningStats
    from pbrl_tpu.utils.configio import dict_to_config
    from pbrl_tpu_torch.train import checkpoint

    cfg = dict_to_config(EnvConfig, {k: list(v) if isinstance(v, tuple) else v
                                     for k, v in dataclasses.asdict(port_env.config).items()})
    env = MimicVecEnv(humanoid_model(), load_clip("walk"), cfg, backend="xla")
    tree = {}
    with np.load(checkpoint.bundled_policy("walk")) as z:
        for k in z.files:
            if k.startswith("policy/"):
                node = tree
                parts = k.split("/")[1:]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(z[k])
        stats = RunningStats(**{k: jnp.asarray(z[f"obs_stats/{k}"]) for k in ("count", "mean", "m2")})
    return env, PolicyNetwork(action_size=env.action_size), {"params": tree}, stats


def test_mujoco_side_matches_reward_parity():
    port, policy, stats, env = _port_env()
    assert not env.config.reference_state_init and env.backend == "xla"
    jenv, jpolicy, jparams, jstats = _pbrl_tpu_side(env)
    want_r, want_q = _script("reward_parity").mujoco_rollout(jenv, jpolicy, jparams, jstats, 5)
    got_r, got_q = port.mujoco_rollout(env, policy, stats, 5)
    assert got_r.shape == (5,) and got_q.shape == (5, 35)
    np.testing.assert_allclose(got_r, want_r, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_q, want_q, atol=1e-6, rtol=0)
    assert float(np.abs(got_q[-1] - got_q[0]).max()) > 1e-2  # the body moved


def test_parity_row_and_our_side():
    port, policy, stats, env = _port_env()
    r, q = port.our_rollout(env, policy, stats, 3)
    assert r.shape == (3,) and q.shape == (3, 35) and np.isfinite(r).all()
    assert port.fan(4) == [0.0, -0.001, 0.001, -0.002]
    row = port.run_one("walk", None, 3, 1)
    assert row["clip"] == "walk" and row["per_rollout_ours"] == [round(float(r.mean()), 4)]
    for k in ("reward_ours", "reward_mujoco", "relative_gap", "steady_state_gap",
              "root_pos_rmse_m", "ours_by_third", "mujoco_by_third"):
        assert k in row
    assert port.parity_md_rows()["walk"][3] == 1  # PARITY.md's walk row, 1 rollout

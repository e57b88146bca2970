"""``scripts/torch_diag_rollout.py`` against pbrl_tpu's
``scripts/diag_rollout.py``.

Walk's bundled policy from clip time 0 (no reference-state init) at walk's
eval-stripped run config, over its first 4 steps, against pbrl_tpu's
env of that script (``_restore_run`` of ``ckpts/walk``, the same policy's
Orbax checkpoint) stepped with the same loop body. pbrl_tpu's physics is its
field program run eagerly, at 2 substeps per policy step (``policy_dt``
0.004: pbrl_tpu's through ``--env-set``, the tool's through a run directory
whose ``run_config.json`` is walk's with that one field changed), as
tests/test_torch_env_eval.py runs it, at that file's tolerances: qpos 1e-4,
qvel 5e-3, reward and its terms 1e-3, done exact, time 1e-6. The backflip
ceiling's part (c), computed by ``torch_backflip_ceiling.checkpoint_terms``
from the tool's record, is held against the same statistics computed as
``scripts/backflip_ceiling.py`` computes them from pbrl_tpu's rollout. The
tool's ``.npz`` keys and JSON keys are pbrl_tpu's script's (read from its
source), the JSON with ``launches`` added.
"""

import argparse
import ast
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_env_eval import _jax_field_physics

from pbrl_tpu.cli import _restore_run
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap.clip import reference_state as j_reference_state
from pbrl_tpu.train import checkpoint as jckpt
from pbrl_tpu.train import running_stats as jrs
from pbrl_tpu.train.networks import PolicyNetwork as JPolicyNetwork

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY_DT = 0.004  # walk's run config has physics_dt 0.002: 2 substeps per step


def _tool(name="torch_diag_rollout"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def walk_run(tmp_path):
    """A run directory of the port with no checkpoint (so the tool takes
    walk's bundled policy) whose run config is walk's at ``POLICY_DT``."""
    with open(os.path.join(ROOT, "ckpts", "walk", "run_config.json")) as f:
        run = json.load(f)
    run["env_config"]["policy_dt"] = POLICY_DT
    with open(tmp_path / "run_config.json", "w") as f:
        json.dump(run, f)
    return str(tmp_path)


def _ceiling_terms(qvel, time, reward, terms, clip, s_vel):
    """Part (c)'s statistics as ``scripts/backflip_ceiling.py`` computes them."""
    v_ref = np.stack([np.asarray(j_reference_state(clip, jnp.asarray(float(t)))[1])
                      for t in time])
    dv = qvel - v_ref
    vel_sq_mean = float(np.mean(np.sum(dv**2, axis=1)))
    return {
        "mean_reward": round(float(reward.mean()), 4),
        "terms_mean": {k: round(float(terms[:, j].mean()), 4)
                       for j, k in enumerate(("pose", "vel", "ee", "com"))},
        "qvel_rmse_per_dof": round(float(np.sqrt(np.mean(dv**2))), 3),
        "ref_qvel_rms_per_dof": round(float(np.sqrt(np.mean(v_ref**2))), 3),
        "sum_dv_sq_mean": round(vel_sq_mean, 1),
        "r_vel_at_checkpoint_rmse": float(np.exp(-s_vel * vel_sq_mean)),
    }


def _pbrl_tpu_keys():
    """The keys of ``scripts/diag_rollout.py``'s ``np.savez`` and of the
    dict its ``json.dumps`` prints."""
    with open(os.path.join(ROOT, "scripts", "diag_rollout.py")) as f:
        tree = ast.parse(f.read())
    npz, line = None, None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "savez":
                npz = [kw.arg for kw in node.keywords]
            elif node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict):
                line = [k.value for k in node.args[0].keys]
    return npz, line


def test_diag_rollout_matches_pbrl_tpu(walk_run):
    steps = 4
    ckpt = os.path.join(ROOT, "ckpts", "walk")
    jenv, train_cfg = _restore_run(argparse.Namespace(checkpoint_dir=ckpt, clip=None,
                                                      env_set=[f"policy_dt={POLICY_DT}"]))
    jenv = JMimicVecEnv(jenv.model, jenv.clip,
                        dataclasses.replace(jenv.config, reference_state_init=False),
                        backend="xla")
    jenv._physics = _jax_field_physics(jenv)
    jenv._reward_batch = jax.jit(jenv._reward_batch)
    jenv._obs = jax.jit(jenv._obs)
    payload = jax.tree_util.tree_map(np.asarray, jckpt.restore(ckpt))
    stats = jrs.RunningStats(**payload["obs_stats"])
    policy = JPolicyNetwork(action_size=jenv.action_size, hidden=tuple(train_cfg.hidden))
    s = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 1))
    want = {k: [] for k in ("qpos", "qvel", "reward", "done", "time", "root_err", "terms")}
    for _ in range(steps):  # diag_rollout.py's scan body
        mean, _ = policy.apply(payload["params"]["policy"], jrs.normalize(stats, s.obs))
        s = jenv.step(s, mean)
        for k, x in (("qpos", s.qpos), ("qvel", s.qvel), ("reward", s.reward), ("done", s.done),
                     ("time", s.time), ("root_err", s.metrics["root_err"])):
            want[k].append(np.asarray(x[0]))
        want["terms"].append([float(s.metrics[k][0]) for k in
                              ("reward_pose", "reward_vel", "reward_ee", "reward_com")])
    want = {k: np.asarray(v) for k, v in want.items()}
    want["qpos_ref"] = np.stack([np.asarray(j_reference_state(jenv.clip, jnp.asarray(float(t)))[0])
                                 for t in want["time"]])

    tool = _tool()
    env, rec = tool.diag_rollout(checkpoint_dir=walk_run, steps=steps, device="cpu")
    assert env.clip.name == "walk"
    assert env.config.n_substeps == 2 and not env.config.reference_state_init
    assert float(rec["time"][0]) == float(want["time"][0]) > 0.0  # the clip's start, one step on
    np.testing.assert_allclose(rec["qpos"], want["qpos"], atol=1e-4)
    np.testing.assert_allclose(rec["qvel"], want["qvel"], atol=5e-3)
    np.testing.assert_allclose(rec["reward"], want["reward"], atol=1e-3)
    np.testing.assert_allclose(rec["terms"], want["terms"], atol=1e-3)
    np.testing.assert_allclose(rec["root_err"], want["root_err"], atol=1e-3)
    np.testing.assert_array_equal(rec["done"], want["done"])
    np.testing.assert_allclose(rec["time"], want["time"], atol=1e-6)
    np.testing.assert_allclose(rec["qpos_ref"], want["qpos_ref"], atol=1e-5)
    assert env._kstep.launches == 0  # the CPU runs the kernel's plain version

    got = _tool("torch_backflip_ceiling").checkpoint_terms(env, rec)
    ref = _ceiling_terms(want["qvel"], want["time"], want["reward"], np.asarray(want["terms"]),
                         jenv.clip, jenv.config.s_vel)
    assert list(got) == list(ref) and list(got["terms_mean"]) == list(ref["terms_mean"])
    # the reward and its terms at the rollout's 1e-3; the rounded statistics to
    # their last printed digit; the velocity term, unrounded, to 1e-4 of itself
    # (it holds ``sum_dv_sq_mean`` to about 1e-3 of 13)
    assert abs(got["mean_reward"] - ref["mean_reward"]) <= 1e-3
    for k, x in ref["terms_mean"].items():
        assert abs(got["terms_mean"][k] - x) <= 1e-3, k
    assert abs(got["qvel_rmse_per_dof"] - ref["qvel_rmse_per_dof"]) <= 1e-3 + 1e-9
    assert abs(got["ref_qvel_rms_per_dof"] - ref["ref_qvel_rms_per_dof"]) <= 1e-3 + 1e-9
    assert abs(got["sum_dv_sq_mean"] - ref["sum_dv_sq_mean"]) <= 0.1 + 1e-9
    np.testing.assert_allclose(got["r_vel_at_checkpoint_rmse"], ref["r_vel_at_checkpoint_rmse"],
                               rtol=1e-4)

    # the same formulas on a seeded record whose times span many clip frames,
    # so that the pairing of rows with reference times shows
    rng = np.random.default_rng(0)
    n = 16
    fake = {"time": np.sort(rng.uniform(0.0, float(env.clip.cycle_time), n)).astype(np.float32),
            "qvel": rng.normal(size=(n, 34)).astype(np.float32),
            "reward": rng.uniform(size=n).astype(np.float32),
            "terms": rng.uniform(size=(n, 4)).astype(np.float32)}
    got = _tool("torch_backflip_ceiling").checkpoint_terms(env, fake)
    ref = _ceiling_terms(fake["qvel"], fake["time"], fake["reward"], fake["terms"], jenv.clip,
                         jenv.config.s_vel)
    r_got, r_ref = got.pop("r_vel_at_checkpoint_rmse"), ref.pop("r_vel_at_checkpoint_rmse")
    assert got == ref
    np.testing.assert_allclose(r_got, r_ref, rtol=1e-5)


def test_diag_outputs_have_pbrl_tpu_keys(walk_run, tmp_path, capsys):
    npz_keys, line_keys = _pbrl_tpu_keys()
    assert npz_keys and line_keys
    out = str(tmp_path / "diag.npz")
    assert _tool().main(["--device", "cpu", "--checkpoint-dir", walk_run, "--steps", "1",
                         "--out", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"-> {out}"
    got = json.loads(lines[-2])
    assert list(got) == line_keys + ["launches"] and got["launches"] == 0
    assert got["alive"] == 1 and got["cycle_steps"] == 317  # walk's 1.2667 s cycle at 4 ms
    with np.load(out) as z:
        assert sorted(z.files) == sorted(npz_keys)
        assert z["qpos"].shape == z["qpos_ref"].shape == (1, 35)

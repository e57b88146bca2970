"""The backflip investigation's tools on the port, against pbrl_tpu's.

* ``scripts/torch_recipe_flags.py`` prints ``scripts/recipe_flags.py``'s
  line (run in this process) for every ``ckpts/*/run_config.json``, and
  the port's command line parses it back to the stored configs, the
  skipped fields aside;
* ``scripts/torch_measure_lag.py``: its ``lag_sse`` is pbrl_tpu's to 1e-12
  on seeded arrays, and on ``artifacts/backflip.npz`` it gives
  ``logs/backflip_lag_r5.json``: the best lag -2.75 steps, each SSE to
  1e-4;
* ``scripts/torch_backflip_ceiling.py``: the timing-error envelope at 256
  reference times is ``logs/backflip_ceiling.json``'s to 2e-4 in every row
  and term; on 8 reference times each sample's reward and terms are
  pbrl_tpu's ``_reward_batch`` on MuJoCo's body poses (as
  ``scripts/backflip_ceiling.py:72-80`` builds them) to 1e-5, the two
  angle diagnostics (``pose_error``, ``root_err``) to ANGLE_ULP; the whole
  tool at ``--steps 4`` on the CPU is finite with the log's keys;
* ``scripts/torch_render_all_skills.sh`` under a stand-in ``python`` (as
  tests/test_torch_tools.py runs the port's shell scripts): seven ``cli
  rollout`` commands that parse with the port's parser; under a stand-in
  that fails for two skills, it runs the rest and exits 1 naming those two.
"""

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_tools import _commands, _parse

from pbrl_tpu_torch import cli
from pbrl_tpu_torch.envs import EnvConfig
from pbrl_tpu_torch.train import TrainConfig
from pbrl_tpu_torch.utils.configio import dict_to_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
RUN_DIRS = ("walk", "getup", "getup_faceup", "kick", "punch", "jump", "backflip")
ENVELOPE_TOL = 2e-4  # the log prints 4 decimals
# ``angle_between`` is 2 acos(|<q1, q2>|): near equal poses one float32 ulp
# of the dot product moves it by 2 acos(1 - 2**-24) = 6.905e-4, while the
# reward terms, which take the squared angles, move by under 1e-5
ANGLE_ULP = 7e-4


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)  # the ceiling imports the diag rollout beside it
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log(name):
    with open(os.path.join(ROOT, "logs", name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# recipe flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run_dir", RUN_DIRS)
def test_recipe_flags_match_pbrl_tpu(run_dir, monkeypatch, capsys):
    path = os.path.join(ROOT, "ckpts", run_dir)
    monkeypatch.setattr(sys, "argv", ["recipe_flags.py", path])
    _script("recipe_flags").main()
    want = capsys.readouterr().out.strip()
    port = _script("torch_recipe_flags")
    line = port.recipe_flags(path)
    assert line == want
    assert port.main([path]) == 0 and capsys.readouterr().out.strip() == want

    args = cli.build_parser().parse_args(["train", *line.split()])
    env = cli._overrides(EnvConfig(), args.env_set, "--env-set", cli._float_or_str)
    train = cli._overrides(TrainConfig(), args.train_set, "--train-set", int)
    with open(os.path.join(path, "run_config.json")) as f:
        run = json.load(f)
    assert env == dict_to_config(EnvConfig, run["env_config"])
    stored = dict_to_config(TrainConfig, run["train_config"])
    skipped = {k: getattr(TrainConfig(), k) for k in port.SKIP_TRAIN
               if k in {f.name for f in dataclasses.fields(TrainConfig)}}
    assert train == dataclasses.replace(stored, **skipped)


# ---------------------------------------------------------------------------
# lag
# ---------------------------------------------------------------------------


def test_lag_sse_matches_pbrl_tpu():
    want, port = _script("measure_lag"), _script("torch_measure_lag")
    rng = np.random.default_rng(0)
    q, ref = rng.normal(size=(2, 50, 28))
    for lag in (-3.0, -2.75, -0.5, 0.0, 0.25, 1.0, 3.75, 6.0):
        assert abs(port.lag_sse(q, ref, lag) - want.lag_sse(q, ref, lag)) <= 1e-12
    np.testing.assert_array_equal(port.LAGS, np.arange(-3.0, 6.01, 0.25))


def test_measure_lag_on_backflip_artifact(capsys):
    port = _script("torch_measure_lag")
    npz = os.path.join("artifacts", "backflip.npz")
    assert port.main(["--device", "cpu", os.path.join(ROOT, npz), "backflip"]) == 0
    out = json.loads(capsys.readouterr().out)
    want = _log("backflip_lag_r5.json")
    assert set(out) == set(want)
    assert out["best_lag_steps"] == -2.75 == want["best_lag_steps"]
    assert out["best_lag_ms"] == pytest.approx(want["best_lag_ms"], abs=1e-9)
    assert out["steps"] == want["steps"] and out["lags_steps"] == want["lags_steps"]
    np.testing.assert_allclose(out["sse"], want["sse"], atol=1e-4)
    for k in ("sse_at_zero", "sse_at_best"):
        assert out[k] == pytest.approx(want[k], abs=1e-4)


# ---------------------------------------------------------------------------
# ceiling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ceiling_mod():
    return _script("torch_backflip_ceiling")


@pytest.fixture(scope="module")
def backflip_env():
    """The port's backflip env of the tools: eval-stripped, no RSI."""
    _, _, _, env = cli._policy_env(argparse.Namespace(
        checkpoint_dir=None, clip="backflip", policy=None, device="cpu",
        env_set=["reference_state_init=false"]))
    return env


def test_ceiling_envelope_matches_log(ceiling_mod, backflip_env):
    rows = ceiling_mod.envelope(backflip_env, 256)
    want = _log("backflip_ceiling.json")["envelope"]
    assert list(rows) == list(want)
    for name, row in rows.items():
        assert list(row) == list(want[name]), name
        for k, v in row.items():
            assert abs(v - want[name][k]) <= ENVELOPE_TOL + 1e-9, (name, k, v, want[name][k])


def test_ceiling_scores_match_pbrl_tpu_with_mujoco_fk(ceiling_mod, backflip_env):
    """Each (shift, time) sample against pbrl_tpu's reward on MuJoCo's
    forward kinematics of pbrl_tpu's own reference state."""
    import jax
    import jax.numpy as jnp
    import mujoco

    from pbrl_tpu.cli import _restore_run
    from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
    from pbrl_tpu.mocap.clip import reference_state as j_reference_state
    from pbrl_tpu.model import humanoid_spec
    from pbrl_tpu.model.mjcf import to_mjcf

    steps = 8
    jenv, _ = _restore_run(argparse.Namespace(checkpoint_dir=os.path.join(ROOT, "ckpts",
                                                                          "backflip"),
                                              clip=None, env_set=None))
    jenv = JMimicVecEnv(jenv.model, jenv.clip,
                        dataclasses.replace(jenv.config, reference_state_init=False))
    mj = mujoco.MjModel.from_xml_string(to_mjcf(humanoid_spec()))
    mjd = mujoco.MjData(mj)
    rows = ceiling_mod.shifts(jenv.config, jenv.clip)
    pdt = float(jenv.config.effective_policy_dt)
    q, v, t, xp, xq = [], [], [], [], []
    for _, delta in rows:
        for k in range(steps):
            qk, vk = j_reference_state(jenv.clip, jnp.asarray(k * pdt + delta))
            mjd.qpos[:] = np.asarray(qk, np.float64)
            mjd.qvel[:] = 0.0
            mujoco.mj_forward(mj, mjd)
            q.append(np.asarray(qk, np.float32))
            v.append(np.asarray(vk, np.float32))
            t.append(k * pdt)
            xp.append(np.asarray(mjd.xpos[1:], np.float32))
            xq.append(np.asarray(mjd.xquat[1:], np.float32))
    r_want, terms_want = jax.jit(jenv._reward_batch)(
        jnp.asarray(np.stack(q)), jnp.asarray(np.stack(v)), jnp.asarray(t, jnp.float32),
        jnp.asarray(np.stack(xp)), jnp.asarray(np.stack(xq)), jnp.zeros(len(t)))

    got_rows, r, terms = ceiling_mod.score(backflip_env, steps)
    assert [n for n, _ in got_rows] == [n for n, _ in rows]
    assert [d for _, d in got_rows] == pytest.approx([d for _, d in rows], abs=1e-12)
    np.testing.assert_allclose(r.reshape(-1).numpy(), np.asarray(r_want), atol=1e-5)
    assert set(terms) == set(terms_want)
    for k, x in terms.items():
        tol = ANGLE_ULP if k in ("pose_error", "root_err") else 1e-5
        np.testing.assert_allclose(x.reshape(-1).numpy(), np.asarray(terms_want[k]), atol=tol,
                                   err_msg=k)


def test_ceiling_tool_runs_on_cpu(tmp_path, capsys, ceiling_mod):
    out_path = tmp_path / "ceiling.json"
    assert ceiling_mod.main(["--device", "cpu", "--steps", "4", "--out", str(out_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    with open(out_path) as f:
        assert json.load(f) == out
    want = _log("backflip_ceiling.json")
    assert set(out) == set(want) | {"launches"} and out["launches"] == 0  # the CPU: plain
    assert out["clip"] == "backflip" and out["weights"] == want["weights"]
    assert out["kernel_scales"] == want["kernel_scales"]
    assert set(out["checkpoint"]) == set(want["checkpoint"])
    assert set(out["checkpoint"]["terms_mean"]) == set(want["checkpoint"]["terms_mean"])
    nums = [out["ceiling_at_1frame_timing"], out["eval_fraction_of_ceiling"],
            *[v for k, v in out["checkpoint"].items() if k != "terms_mean"],
            *out["checkpoint"]["terms_mean"].values()]
    assert all(math.isfinite(x) for x in nums)
    # the ceiling of the envelope's 4 reference times, weighted as the log's
    one = out["envelope"]["1 frame"]
    w = out["weights"]
    assert out["ceiling_at_1frame_timing"] == pytest.approx(
        sum(w[k] * one[f"reward_{k}"] for k in w), abs=1e-4)


# ---------------------------------------------------------------------------
# render script
# ---------------------------------------------------------------------------


def test_render_all_skills_parses(tmp_path):
    calls = [_parse(a) for a in _commands(tmp_path, "torch_render_all_skills.sh")]
    assert [a.cmd for a in calls] == ["rollout"] * 7
    assert sorted(a.clip for a in calls) == sorted(
        ["walk", "jump", "backflip", "kick", "punch", "getup_facedown", "getup_faceup"])
    out = tmp_path / "out"
    for a in calls:
        assert (a.steps, a.camera, a.checkpoint_dir, a.device) == (240, "back", None, "cuda")
        assert (a.out, a.video) == (str(out / f"{a.clip}.npz"), str(out / f"{a.clip}.mp4"))


def test_render_all_skills_fails_when_a_skill_fails(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(
        '#!/usr/bin/env bash\necho "$5" >> "$RECORD"\n'
        'case "$5" in kick|getup_faceup) exit 1;; esac\n')
    (bin_dir / "python").chmod(0o755)
    record = tmp_path / "record"
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", RECORD=str(record),
               OUT=str(tmp_path / "out"))
    out = subprocess.run(["bash", os.path.join(SCRIPTS, "torch_render_all_skills.sh")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 1
    assert out.stderr.strip().splitlines()[-1] == "RENDER FAILED: kick getup_faceup"
    assert record.read_text().split() == ["walk", "jump", "backflip", "kick", "punch",
                                          "getup_facedown", "getup_faceup"]

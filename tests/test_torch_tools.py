"""The repo tools of the port: ``scripts/torch_train_all_clips.sh`` and
``scripts/torch_eval_all.sh`` (pbrl_tpu's recipes as commands of the
port's CLI) and ``scripts/torch_phase_eval.py`` (eval by start phase).

Each shell script runs under bash with a stand-in ``python`` first on the
``PATH`` that records its arguments, so bash expands the loops and
variables; every recorded command must be ``-m pbrl_tpu_torch.cli ...``
and parse with the port's own CLI parser, its ``--env-set`` fields those
of ``EnvConfig``. The phase eval (2 phases x 3 steps of walk's bundled
policy, on the CPU) must give, phase by phase, ``ppo.evaluate`` with
``t0`` at that phase to the bit.
"""

import json
import os
import subprocess

import pytest
import torch

from pbrl_tpu_torch import cli
from pbrl_tpu_torch.envs import EnvConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = """#!/usr/bin/env bash
printf '%s\\0' "$@" >> "$RECORD"
printf '\\n' >> "$RECORD"
echo '{"eval_reward": 0.0}'
"""


def _commands(tmp_path, script, *args):
    """The argument lists the script hands to ``python``, one per call."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(STUB)
    (bin_dir / "python").chmod(0o755)
    record = tmp_path / "record"
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", RECORD=str(record),
               OUT=str(tmp_path / "out"))
    out = subprocess.run(["bash", os.path.join(ROOT, "scripts", script), *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return [ln.strip("\0").split("\0") for ln in record.read_text().splitlines() if ln]


def _parse(argv):
    assert argv[:2] == ["-m", "pbrl_tpu_torch.cli"], argv
    args = cli.build_parser().parse_args(argv[2:])
    env_set = getattr(args, "env_set", None) or []
    cli._overrides(EnvConfig(), env_set, "--env-set", cli._float_or_str)  # known fields only
    return args


def test_train_all_clips_parses(tmp_path):
    calls = [_parse(a) for a in _commands(tmp_path, "torch_train_all_clips.sh")]
    assert [a.cmd for a in calls] == ["train"] * 7
    assert sorted(a.clip for a in calls) == sorted(
        ["walk", "jump", "kick", "punch", "backflip", "getup_facedown", "getup_faceup"])
    by_clip = {a.clip: a for a in calls}
    assert all(a.checkpoint_dir == str(tmp_path / "out" / a.clip) for a in calls)
    bf = by_clip["backflip"]
    assert bf.action_mode == "residual" and bf.pose_termination == 1.57
    assert bf.total_steps == 1_000_000_000 and not bf.verbose
    assert "include_link_obs=true" in bf.env_set and "aerial_window=0.27,0.5" in bf.env_set
    assert by_clip["getup_faceup"].no_early_termination and by_clip["kick"].no_joint_limits


def test_eval_all_parses(tmp_path):
    dirs = [tmp_path / "walk", tmp_path / "jump"]
    for d in dirs:
        d.mkdir()
    calls = [_parse(a) for a in _commands(tmp_path, "torch_eval_all.sh", *map(str, dirs),
                                          str(tmp_path / "missing"))]
    assert [(a.cmd, a.checkpoint_dir) for a in calls] == [("eval", str(d)) for d in dirs]


def test_phase_eval_is_evaluate_by_phase():
    import importlib.util

    from pbrl_tpu_torch.train import evaluate

    spec = importlib.util.spec_from_file_location(
        "torch_phase_eval", os.path.join(ROOT, "scripts", "torch_phase_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.phase_eval("walk", phases=2, steps=3, device="cpu")
    json.dumps(out)
    policy, stats, run, env = cli._policy_env(type("A", (), dict(
        checkpoint_dir=None, clip="walk", policy=None, device="cpu", env_set=[]))())
    assert out["clip"] == "walk" and len(out["per_phase"]) == 2
    assert out["per_phase"][0]["t0"] == 0.0
    assert out["per_phase"][1]["phase"] == pytest.approx(0.5, abs=1e-6)
    for row in out["per_phase"]:
        want = evaluate(env, policy, stats, num_envs=1, num_steps=3, t0=torch.tensor([row["t0"]]))
        assert row["reward"] == float(want["eval_reward"])
        assert row["ep_len"] == float(want["eval_episode_length"])
        assert row["pose_error"] == float(want["eval_pose_error"])
    assert out["mean_ep_len"] == 3.0

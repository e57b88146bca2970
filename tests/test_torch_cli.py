"""The port's command line: ``eval`` resolves its run configuration, clip
and policy as pbrl_tpu's does, and refuses what it cannot honour."""

import json
import os
import shutil

import numpy as np
import pytest

from pbrl_tpu_torch import cli
from pbrl_tpu_torch.train import checkpoint

CKPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "ckpts")
WALK_POLICY = checkpoint.bundled_policy("walk")


def _eval(*args):
    return cli.main(["eval", "--device", "cpu", "--num-envs", "2", "--steps", "1", *args])


def test_eval_reads_the_checkpoint_run_config(capsys):
    assert _eval("--checkpoint-dir", os.path.join(CKPTS, "walk")) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"eval_reward", "eval_episode_length", "eval_pose_error"}
    assert out["eval_episode_length"] == 1.0
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("case", ["no_run_config", "unknown_field", "policy_of_other_clip",
                                  "clip_flag_of_other_clip", "no_bundled_policy"])
def test_eval_refuses(case, tmp_path):
    """Each case would otherwise evaluate something other than what was
    asked: the bundled run config in place of the directory's, or the walk
    policy on another clip."""
    run = checkpoint.load_run_config(os.path.join(CKPTS, "walk"))
    if case == "no_run_config":
        with pytest.raises(FileNotFoundError, match="run_config.json"):
            _eval("--checkpoint-dir", str(tmp_path))
    elif case == "unknown_field":
        run["env_config"]["not_a_field"] = 1
        (tmp_path / "run_config.json").write_text(json.dumps(run))
        with pytest.raises(KeyError, match="not_a_field"):
            _eval("--checkpoint-dir", str(tmp_path))
    elif case == "policy_of_other_clip":
        with pytest.raises(ValueError, match="trained on clip 'walk', not on 'kick'"):
            _eval("--checkpoint-dir", os.path.join(CKPTS, "kick"), "--policy", WALK_POLICY)
    elif case == "clip_flag_of_other_clip":
        with pytest.raises(ValueError, match="trained on clip 'walk', not on 'jump'"):
            _eval("--clip", "jump", "--policy", WALK_POLICY)
    else:
        # a run on a clip file has no bundled policy (each of the seven shipped
        # clips has one): the walk policy is not used in its place
        from pbrl_tpu_torch.mocap.clip import clip_path

        clip_file = tmp_path / "humanoid3d_my_kick.txt"
        shutil.copy(clip_path("kick"), clip_file)
        run = checkpoint.load_run_config(os.path.join(CKPTS, "kick"))
        run["clip"] = str(clip_file)
        (tmp_path / "run_config.json").write_text(json.dumps(run))
        with pytest.raises(FileNotFoundError, match="humanoid3d_my_kick.txt_policy.npz"):
            _eval("--checkpoint-dir", str(tmp_path))

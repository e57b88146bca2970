"""The port's ``cli train`` and its checkpoints.

``train --device cpu`` on the humanoid at a tiny size writes the run
config and checkpoints, resumes with continued numbering (as
``tests/test_ppo.py::test_resume_continues_checkpoint_numbering``), and
``eval --checkpoint-dir`` reads the directory. The walk run's learner
state exported from ``ckpts/walk`` equals the Orbax arrays, and imports
into a port checkpoint that ``ppo.train`` resumes from as pbrl_tpu's
resume would.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pbrl_tpu_torch import cli
from pbrl_tpu_torch.train import checkpoint

CKPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "ckpts")
TINY = ["train", "--device", "cpu", "--num-envs", "4", "--unroll-length", "4",
        "--total-steps", "32", "--train-set", "hidden=32,32", "--env-set", "policy_dt=0.004"]


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]


def test_train_resume_and_eval_round_trip(tmp_path, capsys):
    d = str(tmp_path / "run")
    assert cli.main([*TINY, "--checkpoint-dir", d, "--checkpoint-every", "1"]) == 0
    lines = _lines(capsys)
    assert [x["iteration"] for x in lines[:-1]] == [0, 1]
    final = lines[-1]["final"]
    assert final["env_steps"] == 32 and final["sps"] > 0
    for k in ("reward_mean", "episode_done_frac", "loss_policy", "loss_value", "entropy",
              "kl_approx", "fall", "pose_error"):
        assert np.isfinite(final[k]), k
    run = checkpoint.load_run_config(d)
    assert run["clip"] == "walk"
    assert run["train_config"]["hidden"] == [32, 32] and run["train_config"]["num_envs"] == 4
    assert run["env_config"]["policy_dt"] == 0.004
    assert checkpoint._steps(d) == [1, 2]
    first = checkpoint.restore(d)
    assert first["env_steps"] == 32 and first["opt"]["count"] == 2 * 4 * 8

    assert cli.main([*TINY, "--checkpoint-dir", d, "--quiet"]) == 0
    assert checkpoint.latest_step(d) == 4  # continued from 2, not restarted at 1
    second = checkpoint.restore(d)
    assert second["env_steps"] == 64 and second["opt"]["count"] == 2 * 2 * 4 * 8
    capsys.readouterr()

    assert cli.main(["eval", "--device", "cpu", "--checkpoint-dir", d, "--num-envs", "2",
                     "--steps", "1"]) == 0
    out = _lines(capsys)[-1]
    assert out["eval_episode_length"] == 1.0 and all(np.isfinite(v) for v in out.values())
    policy, _ = checkpoint.load_policy_from_dir(d, device="cpu")
    assert torch.equal(policy.state_dict()["torso.out.weight"],
                       second["policy"]["torso.out.weight"])


@pytest.mark.parametrize("flags", [["--train-set", "not_a_field=1"],
                                   ["--env-set", "not_a_field=1"]],
                         ids=["train_set", "env_set"])
def test_train_refuses(flags, tmp_path):
    with pytest.raises(SystemExit, match="unknown"):
        cli.main([*TINY, "--checkpoint-dir", str(tmp_path), *flags])
    assert checkpoint.latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("flags,kernel", [
    (["--backend", "xla"], False), (["--backend", "kernel"], True),
    (["--backend", "xla", "--controller", "standard_pd"], False),
    (["--backend", "xla", "--controller", "inverse_dynamics_pd"], False),
    (["--env-set", "pd_per_substep=false"], True),
], ids=["backend_xla", "backend_kernel", "xla_standard_pd", "xla_inverse_dynamics_pd",
        "held_pd"])
def test_train_backends(flags, kernel, tmp_path, capsys, monkeypatch):
    """``cli train --device cpu`` on each physics backend and controller at
    the tiny size: finite metrics, the run config's controller and PD mode,
    a policy-step wrapper built (and run by its plain version, launching
    nothing) only on the kernel backend."""
    from pbrl_tpu_torch.envs import vec

    built = []
    build = vec.build_mimic_step
    monkeypatch.setattr(vec, "build_mimic_step",
                        lambda *a, **kw: built.append(build(*a, **kw)) or built[-1])
    d = str(tmp_path / "run")
    assert cli.main([*TINY, "--checkpoint-dir", d, "--quiet", *flags]) == 0
    final = _lines(capsys)[-1]["final"]
    for k in ("reward_mean", "loss_policy", "loss_value", "kl_approx", "pose_error"):
        assert np.isfinite(final[k]), k
    env_cfg = checkpoint.load_run_config(d)["env_config"]
    want = flags[flags.index("--controller") + 1] if "--controller" in flags else "implicit_pd"
    assert env_cfg["controller"] == want
    assert env_cfg["pd_per_substep"] is ("pd_per_substep=false" not in flags)
    assert len(built) == int(kernel)
    if kernel:
        step, spec = built[0]
        assert step.launches == 0
        assert spec.mode == ("torque" if "pd_per_substep=false" in flags else "pd")


def test_train_without_card_does_not_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        cli.main(["train", "--num-envs", "4", "--checkpoint-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "run_config.json")


@pytest.mark.parametrize("clip", ["walk", "backflip"])
def test_exported_train_state_matches_orbax(clip):
    """Every array of the clip's two exported files equals its
    ``ckpts/<clip>`` checkpoint's (the latest step)."""
    import jax

    from pbrl_tpu.train import checkpoint as jckpt

    payload = jax.tree_util.tree_map(np.asarray, jckpt.restore(os.path.join(CKPTS, clip)))
    step = jckpt.latest_step(os.path.join(CKPTS, clip))
    assert step == {"walk": 15258, "backflip": 201410}[clip]
    with np.load(checkpoint.bundled_train_state(clip)) as z:
        state = {k: z[k] for k in z.files}
    with np.load(checkpoint.bundled_policy(clip)) as z:
        pol = {k: z[k] for k in z.files}

    def flat(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    want = flat(payload["params"]["value"]["params"], "value/")
    adam, sched = payload["opt_state"][1]
    for which in ("mu", "nu"):
        for net in ("policy", "value"):
            want.update(flat(adam[which][net]["params"], f"opt/{which}/{net}/"))
    want["policy/log_std"] = payload["params"]["policy"]["params"]["log_std"]
    want.update(flat(payload["obs_stats"], "obs_stats/"))
    want["opt/count"] = adam["count"]
    want["env_steps"] = payload["env_steps"]
    want["step"] = step
    assert set(state) == set(want) | {"run_config"}
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    assert int(adam["count"]) == int(sched["count"])
    assert json.loads(str(state["run_config"])) == jckpt.load_run_config(
        os.path.join(CKPTS, clip))
    # the policy file's params other than the clamped log_std are the checkpoint's
    for k, v in flat(payload["params"]["policy"]["params"], "policy/").items():
        if k != "policy/log_std":
            np.testing.assert_array_equal(pol[k], v, err_msg=k)
    np.testing.assert_array_equal(pol["policy/log_std"],
                                  np.clip(want["policy/log_std"], -2.3, 0.7))
    if clip == "walk":  # the clamp does bite: both copies are needed
        assert want["policy/log_std"].min() < -2.3


def test_imported_walk_state_resumes(tmp_path):
    """The walk run's learner state as a port checkpoint at step 15258:
    one resumed iteration continues the numbering, restores Adam's count
    (so the learning rate is at its 1% floor) and the unclamped log_std."""
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.train import ppo
    from pbrl_tpu_torch.utils.configio import dict_to_config

    d = str(tmp_path / "walk")
    step = checkpoint.import_train_state(d, checkpoint.bundled_train_state("walk"),
                                         checkpoint.bundled_policy("walk"))
    assert step == 15258 and checkpoint.latest_step(d) == 15258
    payload = checkpoint.restore(d)
    with np.load(checkpoint.bundled_train_state("walk")) as z:
        np.testing.assert_array_equal(payload["value"]["torso.hidden_0.weight"].numpy(),
                                      z["value/torso/hidden_0/kernel"].T)
        np.testing.assert_array_equal(payload["opt"]["mu"]["policy/torso.out.weight"].numpy(),
                                      z["opt/mu/policy/torso/out/kernel"].T)
        np.testing.assert_array_equal(payload["policy"]["log_std"].numpy(), z["policy/log_std"])
    count0 = payload["opt"]["count"]
    assert count0 == 488000 and payload["env_steps"] == 499712000

    run = checkpoint.load_run_config(d)
    cfg = dataclasses.replace(dict_to_config(ppo.TrainConfig, run["train_config"]),
                              num_envs=2, unroll_length=1, num_minibatches=1,
                              update_epochs=1, total_env_steps=2)
    env = MimicVecEnv(humanoid_model(), load_clip("walk", device="cpu"),
                      EnvConfig(policy_dt=0.004), device="cpu")
    ts, history = ppo.train(env, cfg, checkpoint_dir=d, device="cpu")
    assert checkpoint.latest_step(d) == 15259 and len(history) == 1
    assert ts.opt.count == count0 + 1
    assert ts.opt.lr(count0) == pytest.approx(cfg.learning_rate * 0.01)
    assert ts.env_steps == 499712000 + 2
    assert float(ts.policy.log_std.detach().min()) < -2.3  # restored unclamped

"""The port's ``ReplayEnv`` (frames, rollout, partial body), the registry,
and ``cli replay --device cpu`` against pbrl_tpu's (``MimicEnv`` is held
in tests/test_torch_mimic_env.py). Tolerances: replay poses and FK 1e-6, velocities 1e-6 plus 1e-6 relative (the frame
interpolation of velocities near 3 rad/s rounds in its own order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.envs import ReplayEnv as JReplayEnv
from pbrl_tpu.envs import registered_environments as j_registered
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu_torch import cli
from pbrl_tpu_torch.envs import (EnvConfig, MimicEnv, ReplayEnv, get_environment,
                                 registered_environments)
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip, reference_state
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.viz import load_trajectory

@pytest.fixture(scope="module")
def walk_pair():
    walk = augment_clip(humanoid_model(), load_clip("walk", device="cpu"))
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    return jc, walk


def test_replay_hits_clip_frames_and_matches_jax(walk_pair):
    jc, walk = walk_pair
    env = ReplayEnv(humanoid_model(), walk)
    s = env.at_frame(10)
    np.testing.assert_allclose(s.pipeline.qpos[0].numpy(), walk.qpos[10].numpy(), atol=1e-4)
    assert int(s.metrics["step_index"][0]) == 10
    assert float(s.pipeline.xpos[0, :, 2].min()) < 0.2  # FK ran: feet near the ground
    js = jax.jit(lambda: JReplayEnv(j_humanoid(), jc).at_frame(10))()
    for k in ("qpos", "qvel", "xpos", "xquat"):
        np.testing.assert_allclose(getattr(s.pipeline, k)[0].numpy(),
                                   np.asarray(getattr(js.pipeline, k)), atol=1e-6,
                                   rtol=1e-6 if k == "qvel" else 0, err_msg=k)
    many = env.at_frame(torch.tensor([3, 10, 40]))
    np.testing.assert_array_equal(many.pipeline.qpos[1].numpy(), s.pipeline.qpos[0].numpy())


def test_replay_rollout_and_partial_body(walk_pair):
    _, walk = walk_pair
    m = humanoid_model()
    states = ReplayEnv(m, walk).rollout(80, num_envs=2)
    assert states.obs.shape == (80, 2, m.nq + m.nv)
    assert bool(torch.isfinite(states.obs).all())
    x = states.pipeline.qpos[:, 0, 0].numpy()
    assert x[-1] > x[0]  # walk wraps with its root offset: forward progress
    mask = np.zeros(m.nq)
    for jn in ("right_shoulder_x", "right_shoulder_y", "right_shoulder_z", "right_elbow"):
        mask[m.jnt_qposadr[m.joint_id(jn)]] = 1.0
    q = ReplayEnv(m, walk, qpos_mask=mask).at_frame(15).pipeline.qpos[0].numpy()
    assert q[m.jnt_qposadr[m.joint_id("left_elbow")]] == 0.0
    a = m.jnt_qposadr[m.joint_id("right_elbow")]
    np.testing.assert_allclose(q[a], float(walk.qpos[15, a]), atol=1e-4)


def test_registry_names():
    assert registered_environments() == j_registered() == ["humanoid_mimic", "humanoid_replay"]
    assert isinstance(get_environment("humanoid_replay", device="cpu"), ReplayEnv)
    env = get_environment("humanoid_mimic", device="cpu", gravity=False)
    assert isinstance(env, MimicEnv) and float(np.abs(env.model.option.gravity).max()) == 0.0
    with pytest.raises(KeyError):
        get_environment("nope")


def test_cli_replay_writes_reference_states(tmp_path, capsys, walk_pair):
    """``cli replay --device cpu``: one cycle of frames, each the clip's
    reference state at the env's clock, equal to pbrl_tpu's replay rollout."""
    jc, walk = walk_pair
    out = str(tmp_path / "walk.npz")
    assert cli.main(["replay", "--device", "cpu", "--clip", "walk", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    traj = load_trajectory(out)
    frames = int(float(walk.cycle_time) / EnvConfig().policy_dt) + 1
    assert line["frames"] == frames and traj["qpos"].shape == (frames, 35)
    assert float(traj["fps"]) == pytest.approx(60.0)
    t = torch.zeros(1)
    want = []
    for _ in range(frames):  # the env's clock: policy_dt added per step in float32
        t = t + EnvConfig().policy_dt
        want.append(reference_state(walk, t)[0][0].numpy())
    np.testing.assert_allclose(traj["qpos"], np.stack(want), atol=1e-6, rtol=0)
    jq = jax.jit(lambda: JReplayEnv(j_humanoid(), jc).rollout(frames))().pipeline.qpos
    np.testing.assert_allclose(traj["qpos"], np.asarray(jq), atol=1e-6, rtol=0)
    with pytest.raises(SystemExit, match="MuJoCo"):
        cli.main(["replay", "--device", "cpu", "--out", out, "--video", "walk.mp4"])

"""The port's ``cli rollout``, video rendering, ``cli bench`` and native clip
loader, against pbrl_tpu's.

* ``rollout_trajectory`` (the body of ``cli rollout``) from pbrl_tpu's
  reset state against pbrl_tpu's rollout loop (``cli.py:347-356``: the
  policy's mean action, no reset) with the walk policy, 2 policy steps of
  2 substeps, pbrl_tpu's physics its field program run eagerly (as
  tests/test_torch_env_eval.py runs it): qpos 1e-4, reward 1e-3, done
  exact; then ``cli rollout --device cpu``'s file and summary line;
* ``render_video`` against pbrl_tpu's (the same MJCF, lights and colours:
  the same pixels) and ``save_video``, skipped where host MuJoCo or
  offscreen GL is missing, as tests/test_cli_viz.py skips;
* ``cli bench --device cpu`` at 2 envs x 1 step, its JSON line;
* the native loader against pbrl_tpu's and against Python's ``json`` on
  every clip of ``assets/motions``, as tests/test_io_native.py holds
  pbrl_tpu's, built under ``build/`` and never into ``native/``.
"""

import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu import io_native as j_io_native
from pbrl_tpu.envs import EnvConfig as JEnvConfig
from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu.train import checkpoint as jckpt
from pbrl_tpu.train import running_stats as jrs
from pbrl_tpu.train.networks import PolicyNetwork as JPolicyNetwork
from pbrl_tpu_torch import cli, io_native
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs.humanoid_task import augment_clip
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import checkpoint
from pbrl_tpu_torch.viz import load_trajectory, save_video
from test_torch_env_eval import SUBSTEPS2, _jax_field_physics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOTIONS = os.path.join(ROOT, "assets", "motions")


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------


def test_rollout_matches_pbrl_tpu():
    steps = 2
    walk = augment_clip(humanoid_model(), load_clip("walk", device="cpu"))
    jc = jclip.load_clip("walk").replace(ee_pos=jnp.asarray(walk.ee_pos.numpy()),
                                         com=jnp.asarray(walk.com.numpy()))
    jenv = JMimicVecEnv(j_humanoid(), jc, JEnvConfig(**SUBSTEPS2), backend="xla")
    jenv._physics = _jax_field_physics(jenv)
    jenv._reward_batch = jax.jit(jenv._reward_batch)
    jenv._obs = jax.jit(jenv._obs)
    payload = jax.tree_util.tree_map(np.asarray, jckpt.restore(os.path.join(ROOT, "ckpts",
                                                                            "walk")))
    jstats = jrs.RunningStats(**payload["obs_stats"])
    jpolicy = JPolicyNetwork(action_size=28)
    js = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 1))
    want = []
    for _ in range(steps):  # pbrl_tpu's rollout body
        mean, _ = jpolicy.apply(payload["params"]["policy"], jrs.normalize(jstats, js.obs))
        js = jenv.step(js, mean)
        want.append((np.asarray(js.qpos[0]), float(js.reward[0]), float(js.done[0])))

    policy, stats, _ = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device="cpu")
    env = MimicVecEnv(humanoid_model(), walk, EnvConfig(**SUBSTEPS2), device="cpu")
    js0 = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 1))
    state = env.reset(1, t0=torch.from_numpy(np.array(js0.time)))
    state = state.replace(qpos=torch.from_numpy(np.array(js0.qpos)),
                          qvel=torch.from_numpy(np.array(js0.qvel)))
    r = cli.rollout_trajectory(env, policy, stats, state, steps)
    qpos, reward, done = r["qpos"], r["reward"], r["done"]
    assert qpos.shape == (steps, 35) and reward.shape == done.shape == (steps,)
    np.testing.assert_allclose(qpos, np.stack([w[0] for w in want]), atol=1e-4)
    np.testing.assert_allclose(reward, [w[1] for w in want], atol=1e-3)
    np.testing.assert_array_equal(done, [w[2] for w in want])
    assert env._kstep.launches == 0  # the CPU runs the kernel's plain version


def test_cli_rollout_writes_trajectory(tmp_path, capsys):
    out = str(tmp_path / "walk.npz")
    assert cli.main(["rollout", "--device", "cpu", "--clip", "walk", "--steps", "2",
                     "--env-set", "policy_dt=0.004", "--out", out]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"rollout: 2 steps, mean reward (\S+), alive (\d+) steps -> (.+)", line)
    assert m and m.group(3) == out and int(m.group(2)) == 2
    traj = load_trajectory(out)
    assert set(traj) == {"qpos", "fps", "metric_reward", "metric_done"}
    assert traj["qpos"].shape == (2, 35) and np.isfinite(traj["qpos"]).all()
    assert float(traj["fps"]) == pytest.approx(250.0)
    assert float(m.group(1)) == pytest.approx(float(traj["metric_reward"].mean()), abs=5e-4)
    np.testing.assert_array_equal(traj["metric_done"], 0.0)


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------


RENDER = """
import os, sys
import numpy as np
from pbrl_tpu_torch import cli
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model, humanoid_spec
from pbrl_tpu_torch.viz import render_video, save_video

out = sys.argv[1]
qpos = load_clip("walk", device="cpu").qpos[:3].numpy()
try:
    frames = render_video(humanoid_spec(), qpos, width=128, height=96, camera="back")
except Exception as e:  # headless GL may be missing
    if "GL" not in str(e):
        raise
    print("NO_GL", e)
    sys.exit(0)
assert frames.shape == (3, 96, 128, 3) and frames.dtype == np.uint8
assert frames.std() > 0  # not a blank screen
try:
    render_video(humanoid_model(), qpos)
    raise AssertionError("a compiled Model was rendered")
except TypeError as e:
    assert "ModelSpec" in str(e)
from pbrl_tpu.model import humanoid_spec as j_humanoid_spec
from pbrl_tpu.viz import render_video as j_render_video
want = j_render_video(j_humanoid_spec(), qpos, width=128, height=96, camera="back")
np.testing.assert_array_equal(frames, want)
assert os.path.getsize(save_video(os.path.join(out, "v.mp4"), frames, fps=30)) > 0
assert cli.main(["rollout", "--device", "cpu", "--steps", "2", "--env-set", "policy_dt=0.004",
                 "--out", os.path.join(out, "r.npz"), "--video",
                 os.path.join(out, "r.mp4")]) == 0
print("RENDER_OK", sorted(os.listdir(out)))
"""


def test_render_video_matches_pbrl_tpu(tmp_path):
    """The port's frames are pbrl_tpu's, pixel for pixel; ``save_video``
    writes them and ``cli rollout --video`` renders its trajectory. Run in
    a subprocess: MuJoCo picks its GL backend when first imported, and a
    failed GL context must not reach the other tests of this process.
    Skipped where host MuJoCo or offscreen GL is missing."""
    if importlib.util.find_spec("mujoco") is None:  # found, not imported here
        pytest.skip("host MuJoCo is not installed")
    proc = subprocess.run([sys.executable, "-c", RENDER, str(tmp_path)], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    if proc.stdout.startswith("NO_GL"):
        pytest.skip(f"offscreen GL unavailable: {proc.stdout.strip()}")
    assert "RENDER_OK" in proc.stdout, proc.stdout
    assert any(f.startswith("r.") and not f.endswith(".npz") for f in os.listdir(tmp_path))


def test_save_video_gif_fallback(tmp_path):
    frames = (np.random.default_rng(0).random((4, 16, 16, 3)) * 255).astype(np.uint8)
    out = save_video(str(tmp_path / "clip.mp4"), frames, fps=10)
    assert out.endswith((".mp4", ".gif")) and os.path.getsize(out) > 0


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------


def test_cli_bench_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ITERS", "1")
    assert cli.main(["bench", "--device", "cpu", "--num-envs", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "humanoid_mimic_env_steps_per_sec_per_chip_4096envs"
    assert rec["unit"] == "env-steps/s/chip" and rec["value"] > 0
    assert abs(rec["substeps_per_sec_per_chip"] - 8 * rec["value"]) <= 8 * 0.05 + 0.05  # rounding
    assert rec["flops_per_substep"] > 1e4 and rec["achieved_gflops_per_chip"] >= 0
    assert (rec["num_envs"], rec["iters"], rec["launches"], rec["device"]) == (2, 1, 0, "cpu")
    assert "vs_baseline" not in rec


# ---------------------------------------------------------------------------
# native clip loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lib():
    if not io_native.available():
        pytest.skip("native loader unavailable (no C++ compiler)")
    return io_native.get_library()


def test_native_built_outside_native_dir(lib):
    assert os.path.dirname(lib._name) == io_native.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libpbrl_io_")


def test_native_matches_json_and_pbrl_tpu(lib):
    paths = sorted(glob.glob(os.path.join(MOTIONS, "humanoid3d_*.txt")))
    assert paths
    for path in paths:
        frames, loop = io_native.load_frames(path)
        with open(path) as f:
            data = json.load(f)
        np.testing.assert_array_equal(frames, np.asarray(data["Frames"], np.float64),
                                      err_msg=os.path.basename(path))
        assert loop == str(data.get("Loop", "none")).strip('"')
        if j_io_native.available():
            jframes, jloop = j_io_native.load_frames(path)
            np.testing.assert_array_equal(frames, jframes)
            assert loop == jloop


def test_native_batch_load(lib, tmp_path):
    paths = sorted(glob.glob(os.path.join(MOTIONS, "humanoid3d_*.txt")))
    out = io_native.load_frames_batch(paths)
    assert len(out) == len(paths) and all(r is not None and r[0].shape[1] == 44 for r in out)
    good = os.path.join(MOTIONS, "humanoid3d_walk.txt")
    out = io_native.load_frames_batch([good, str(tmp_path / "missing.txt"), good])
    assert out[0] is not None and out[1] is None and out[2] is not None


def test_native_error_messages(lib, tmp_path):
    p = tmp_path / "broken.txt"
    p.write_text('{"Loop": "wrap", "Frames": [[1, 2], [3]]}')
    with pytest.raises(RuntimeError, match="ragged"):
        io_native.load_frames(str(p))
    with pytest.raises(RuntimeError, match="cannot open"):
        io_native.load_frames(str(tmp_path / "nope.txt"))


def test_parse_deepmimic_native_and_python_agree(monkeypatch):
    from pbrl_tpu_torch.mocap.convert import parse_deepmimic

    path = os.path.join(MOTIONS, "humanoid3d_walk.txt")
    p = parse_deepmimic(path)
    monkeypatch.setenv("PBRL_NATIVE", "0")
    assert not io_native.available()
    p2 = parse_deepmimic(path)
    np.testing.assert_array_equal(p.qpos, p2.qpos)
    np.testing.assert_array_equal(p.qvel, p2.qvel)
    assert p.loop == p2.loop

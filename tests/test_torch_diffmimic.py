"""The port's DiffMimic ``.npy`` loader against pbrl_tpu's.

Both are host numpy in f64, so ``parse_diffmimic_npy`` is held to
pbrl_tpu's on the bundled clip at 1e-9 (qpos, qvel, durations). Then the
facts of ``tests/test_diffmimic.py`` on the port's parse (601 frames at 30
fps, upright, 15 m of forward walking, unit root quaternions, a foot near
the floor by the port's engine FK, velocities consistent with positions),
and ``load_clip``'s ``.npy`` path: the bundled file by its name, looked up
under ``assets/motion_diffmimic/``, gives pbrl_tpu's clip at 1e-6 (float32
tensors), and a missing file raises ``FileNotFoundError``.
"""

import os

import numpy as np
import pytest
import torch

from pbrl_tpu.mocap import load_clip as jload_clip
from pbrl_tpu.mocap.diffmimic import parse_diffmimic_npy as jparse
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.kinematics import kinematics
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.mocap.diffmimic import parse_diffmimic_npy
from pbrl_tpu_torch.model import humanoid_model

NAME = "walk_fps_30_20s.npy"
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets",
                    "motion_diffmimic", NAME)


@pytest.fixture(scope="module")
def clip():
    return parse_diffmimic_npy(PATH)


def test_parse_matches_pbrl_tpu(clip):
    want = jparse(PATH)
    for k in ("qpos", "qvel", "durations"):
        np.testing.assert_allclose(getattr(clip, k), getattr(want, k), rtol=0, atol=1e-9,
                                   err_msg=k)
    assert clip.loop == want.loop == "wrap"
    assert clip.total_time == pytest.approx(want.total_time, abs=1e-9)


def test_shape_and_facts(clip):
    assert clip.num_frames == 601
    np.testing.assert_allclose(clip.total_time, 601 / 30.0, atol=1e-6)
    assert clip.loop == "wrap"
    assert clip.qpos.shape == (601, 35) and clip.qvel.shape == (601, 34)
    z = clip.qpos[:, 2]
    assert 0.8 < z.min() and z.max() < 0.95          # upright throughout
    assert clip.qpos[-1, 0] - clip.qpos[0, 0] > 15   # 20 s of forward walking
    assert np.abs(clip.qpos[:, 7:]).max() < 1.6       # sane joint angles
    np.testing.assert_allclose(np.linalg.norm(clip.qpos[:, 3:7], axis=1), 1.0, atol=1e-9)
    dt = clip.durations[0]
    np.testing.assert_allclose(clip.qpos[10, 7:], clip.qpos[9, 7:] + dt * clip.qvel[10, 6:],
                               atol=1e-8)


def test_fk_feet_on_ground(clip):
    m = humanoid_model()
    q = torch.as_tensor(clip.qpos[:1], dtype=torch.float32)
    d = kinematics(m, make_data(m, qpos=q))
    assert float(d.xpos[0, :, 2].min()) < 0.12  # a foot is near the floor


def test_load_clip_npy_path():
    c = load_clip(NAME, device="cpu")
    want = jload_clip(NAME)
    assert c.num_frames == want.num_frames == 601 and c.loop and c.name == "walk_fps_30_20s"
    for k in ("qpos", "qvel", "dt", "cycle_time", "cycle_offset"):
        np.testing.assert_allclose(getattr(c, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert torch.equal(load_clip(PATH, device="cpu").qpos, c.qpos)
    with pytest.raises(FileNotFoundError):
        load_clip("nope.npy", device="cpu")

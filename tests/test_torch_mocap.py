"""pbrl_tpu_torch mocap ingestion and clip lookups against pbrl_tpu.

Parsing is host numpy (f64) on both sides: the arrays must be identical.
The device lookups run on a time grid that crosses the cycle wrap and
agree to 1e-6 (float32; the root positions, which grow with the cycle
count, to 1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.envs.humanoid_task import augment_clip as j_augment
from pbrl_tpu.mocap import clip as jclip
from pbrl_tpu.mocap.convert import parse_deepmimic as j_parse
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu_torch.envs.humanoid_task import augment_clip as t_augment
from pbrl_tpu_torch.mocap import clip as tclip
from pbrl_tpu_torch.mocap.convert import parse_deepmimic as t_parse
from pbrl_tpu_torch.model import humanoid_model

CLIPS = tclip.bundled_clip_names()


def test_all_seven_clips_bundled():
    assert CLIPS == ["backflip", "getup_facedown", "getup_faceup", "jump", "kick",
                     "punch", "walk"]


@pytest.mark.parametrize("name", CLIPS)
def test_parsed_clip_identical(name):
    path = tclip.clip_path(name)
    a, b = j_parse(path), t_parse(path)
    for field in ("qpos", "qvel", "durations", "cum_time"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    assert (a.loop, a.total_time, a.num_frames) == (b.loop, b.total_time, b.num_frames)


def _grid(jc):
    """Times from before the start to 2.5 cycles, plus points just around
    each cycle wrap."""
    ct = float(jc.cycle_time)
    wraps = ct * np.arange(1, 3)[:, None] + np.array([-1e-4, 0.0, 1e-4])
    return np.concatenate([np.linspace(-0.1, 2.5 * ct, 97), wraps.reshape(-1)]
                          ).astype(np.float32)


@pytest.fixture(scope="module")
def walk_pair():
    jm = j_humanoid()
    jc = j_augment(jm, jclip.load_clip("walk"))
    tc = t_augment(humanoid_model(), tclip.load_clip("walk", device="cpu"))
    return jc, tc


def test_augment_clip_matches(walk_pair):
    jc, tc = walk_pair
    # both packages run their einsum engine's kinematics (2.4e-7 measured)
    np.testing.assert_allclose(tc.ee_pos.numpy(), np.asarray(jc.ee_pos), atol=1e-6)
    np.testing.assert_allclose(tc.com.numpy(), np.asarray(jc.com), atol=1e-6)


@pytest.mark.parametrize("name", ["walk", "getup_faceup"])
def test_lookups_match(name, walk_pair):
    if name == "walk":
        jc, tc = walk_pair
    else:
        tc = t_augment(humanoid_model(), tclip.load_clip(name, device="cpu"))
        jc = jclip.load_clip(name)
    # share the FK-derived reference arrays so the lookup alone is compared
    jc = jc.replace(ee_pos=jnp.asarray(tc.ee_pos.numpy()), com=jnp.asarray(tc.com.numpy()))
    assert jc.loop == tc.loop and jc.num_frames == tc.num_frames
    t = _grid(jc)
    tt = torch.from_numpy(t)
    jq, jv = jax.vmap(lambda x: jclip.reference_state(jc, x))(jnp.asarray(t))
    q, v = tclip.reference_state(tc, tt)
    np.testing.assert_allclose(q.numpy()[:, 3:], np.asarray(jq)[:, 3:], atol=1e-6)
    np.testing.assert_allclose(q.numpy()[:, :3], np.asarray(jq)[:, :3], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6, rtol=1e-6)
    jee, jcom = jax.vmap(lambda x: jclip.reference_aux(jc, x))(jnp.asarray(t))
    ee, com = tclip.reference_aux(tc, tt)
    np.testing.assert_allclose(ee.numpy(), np.asarray(jee), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(com.numpy(), np.asarray(jcom), rtol=1e-6, atol=1e-6)
    jph = jax.vmap(lambda x: jclip.phase(jc, x))(jnp.asarray(t))
    np.testing.assert_allclose(tclip.phase(tc, tt).numpy(), np.asarray(jph), atol=1e-6)
    jfi = jax.vmap(lambda x: jclip.reference_frame_index(jc, x))(jnp.asarray(t))
    np.testing.assert_array_equal(tclip.reference_frame_index(tc, tt).numpy(),
                                  np.asarray(jfi))

"""``MimicEnv`` and ``MimicVecEnv`` on the engine step the same task.

Both envs take the observation, reward, targets, termination and start
draws from :mod:`pbrl_tpu_torch.envs.humanoid_task`; this holds them equal
from the same reset (the same generator, so the same RSI times and reset
noise), over 2 policy steps at 2 substeps: observation, reward and every
reward term within 1e-6, done exact. ``MimicEnv``'s clock advances one
substep at a time and the vec env's one policy step at once; at the
recipes' 2 ms substep the two sums differ by an ulp, and the reference
velocity moves the velocity term by up to 8e-6 across it. A substep of
2^-9 s adds exactly in both, so the two envs score the same times. The
states stay up (no env falls), where the two envs' fall rules (after the
step, at every substep) agree.
"""

import dataclasses
import json
import os

import pytest
import torch

from pbrl_tpu_torch.envs import EnvConfig, MimicEnv, MimicVecEnv
from pbrl_tpu_torch.mocap import load_clip, reference_state
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.utils.configio import dict_to_config

CKPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "ckpts")
TERMS = ("reward_pose", "reward_vel", "reward_ee", "reward_com", "pose_error", "root_err")


def _config(name, **over):
    with open(os.path.join(CKPTS, name, "run_config.json")) as f:
        cfg = dict_to_config(EnvConfig, json.load(f)["env_config"])
    return dataclasses.replace(cfg, policy_dt=2.0 ** -8, physics_dt=2.0 ** -9, **over)


# walk: absolute targets, joint limits. backflip: residual targets, aerial
# and drift shaping, root offset and link observations, pose termination,
# reset noise.
CASES = {
    "walk": ("walk", {}),
    "backflip": ("backflip", {"include_link_obs": True}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mimic_env_and_vec_env_agree(name):
    clip_name, over = CASES[name]
    cfg = _config(clip_name, **over)
    model, clip = humanoid_model(), load_clip(clip_name, device="cpu")
    if name == "backflip":
        assert cfg.action_mode == "residual" and cfg.aerial_window and cfg.drift_w > 0
        assert cfg.pose_termination > 0 and cfg.include_ref_root_offset
    per = MimicEnv(model, clip, cfg)
    vec = MimicVecEnv(model, clip, cfg, backend="xla", device="cpu")
    assert per.observation_size == vec.observation_size and cfg.n_substeps == 2
    B = 8
    ps = per.reset(B, torch.Generator().manual_seed(3))
    vs = vec.reset(B, torch.Generator().manual_seed(3))
    assert torch.equal(ps.info["episode_start"], vs.time)
    assert torch.equal(ps.pipeline.qpos, vs.qpos) and torch.equal(ps.pipeline.qvel, vs.qvel)
    torch.testing.assert_close(ps.obs, vs.obs, atol=1e-6, rtol=0)
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        if cfg.action_mode == "absolute":  # track the reference's next pose
            q_ref, _ = reference_state(clip, vs.time + cfg.policy_dt)
            action = q_ref[:, model.actuator_qposadr]
        else:
            action = torch.zeros(B, model.nu)
        action = action + 0.02 * torch.randn(B, model.nu, generator=g)
        ps, vs = per.step(ps, action), vec.step(vs, action)
        assert torch.equal(ps.pipeline.time, vs.time)
        assert not bool(ps.metrics["fall"].any()) and not bool(vs.metrics["fall"].any())
        torch.testing.assert_close(ps.obs, vs.obs, atol=1e-6, rtol=0)
        torch.testing.assert_close(ps.reward, vs.reward, atol=1e-6, rtol=0)
        assert ps.metrics.keys() == vs.metrics.keys()
        for k in TERMS:
            torch.testing.assert_close(ps.metrics[k], vs.metrics[k], atol=1e-6, rtol=0,
                                       msg=k)
        assert torch.equal(ps.done, vs.done)
        assert bool((vs.reward > 0).all())

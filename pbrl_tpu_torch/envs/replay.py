"""Kinematic motion-replay environment (counterpart of
``pbrl_tpu/envs/replay.py``).

``step`` runs forward kinematics only, no dynamics, so a reference motion
can be played back, exported and checked. ``qpos_mask`` replays part of the
body: where it is 0 the model holds its reference pose. States carry a
leading env axis (envs may start at different frames via ``at_frame``).
"""

from __future__ import annotations

from typing import Optional

import torch

from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.kinematics import kinematics
from pbrl_tpu_torch.envs.base import Env, EnvConfig, State, stack_states
from pbrl_tpu_torch.mocap.clip import MotionClip, phase, reference_frame_index, reference_state
from pbrl_tpu_torch.model.spec import Model


class ReplayEnv(Env):
    """FK-only playback of a motion clip on the clip's device."""

    def __init__(self, model: Model, clip: MotionClip, config: EnvConfig = EnvConfig(),
                 qpos_mask=None):
        self.model = model
        self.clip = clip
        self.config = config
        self.device = clip.qpos.device
        mask = torch.ones(model.nq) if qpos_mask is None else torch.as_tensor(qpos_mask)
        self.qpos_mask = mask.to(device=self.device, dtype=torch.float32)
        self._qpos0 = torch.as_tensor(model.qpos0, device=self.device)

    @property
    def observation_size(self) -> int:
        return self.model.nq + self.model.nv

    @property
    def action_size(self) -> int:
        return 0

    def _at_time(self, t: torch.Tensor) -> State:
        qpos_ref, qvel_ref = reference_state(self.clip, t)
        qpos = torch.where(self.qpos_mask > 0, qpos_ref, self._qpos0)
        qvel = qvel_ref * (self.qpos_mask[:self.model.nv] > 0)
        data = kinematics(self.model, make_data(self.model, qpos=qpos, qvel=qvel)
                          .replace(time=t.to(qpos.dtype)))
        metrics = {"step_index": reference_frame_index(self.clip, t).to(torch.float32),
                   "phase": phase(self.clip, t)}
        live = torch.ones_like(t, dtype=torch.bool) if self.clip.loop else t < self.clip.cycle_time
        return State(pipeline=data, obs=torch.cat([data.qpos, data.qvel], dim=1),
                     reward=torch.zeros_like(t), done=(~live).to(torch.float32),
                     metrics=metrics, info={})

    def reset(self, num_envs: int = 1) -> State:
        return self._at_time(torch.zeros(num_envs, device=self.device))

    def step(self, state: State, action: Optional[torch.Tensor] = None) -> State:
        del action  # kinematic playback ignores actions
        return self._at_time(state.pipeline.time + self.config.policy_dt)

    def at_frame(self, k) -> State:
        """Jump straight to clip frame(s) ``k`` (an int or a (B,) tensor)."""
        k = torch.as_tensor(k, dtype=torch.float32, device=self.device).reshape(-1)
        return self._at_time(k * self.clip.dt)

    def rollout(self, n_steps: int, num_envs: int = 1) -> State:
        """Play ``n_steps`` policy steps from the clip's start; the states
        stacked along a leading time axis (T, B, ...)."""
        s = self.reset(num_envs)
        out = []
        for _ in range(n_steps):
            s = self.step(s)
            out.append(s)
        return stack_states(out)

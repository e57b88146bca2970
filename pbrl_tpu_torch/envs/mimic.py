"""Motion-imitation environment over the engine: PD-driven humanoid with
the DeepMimic reward (counterpart of ``pbrl_tpu/envs/mimic.py``).

The action is the PD target (or, in ``torque`` mode, the torque); the
controller (implicit, Stable, standard or inverse-dynamics PD) turns it
into torque, re-evaluated every physics substep (``pd_per_substep``) or
once per policy step from the pre-step state and held (the reference's
semantics). The task (observation, reward, targets, termination, start
draws, controllers) is :mod:`~pbrl_tpu_torch.envs.humanoid_task`'s; this
env keeps engine ``Data`` in its state, steps it with ``step_n`` and
takes the fall after the step, as pbrl_tpu's does. pbrl_tpu's env holds
one env and is vmapped; this one steps a batch of envs with a leading env
axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from pbrl_tpu_torch.control import pd as ctrl
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.forward import step_n
from pbrl_tpu_torch.engine.kinematics import kinematics as run_kinematics
from pbrl_tpu_torch.envs import humanoid_task as task
from pbrl_tpu_torch.envs.base import Env, EnvConfig, State
from pbrl_tpu_torch.mocap.clip import MotionClip, reference_state
from pbrl_tpu_torch.model.spec import Model


class MimicEnv(Env):
    """DeepMimic-style imitation of one motion clip, on the clip's device."""

    def __init__(self, model: Model, clip: MotionClip, config: EnvConfig = EnvConfig(),
                 gains: Optional[ctrl.Gains] = None, actuator_mask=None):
        model = task.env_model(model, config)
        self.model = model
        self.config = config
        self.device = clip.qpos.device
        self.clip = clip if clip.ee_pos is not None else task.augment_clip(model, clip)
        self.tables = task.env_tables(model, config, gains, actuator_mask, self.device)

    @property
    def observation_size(self) -> int:
        return task.observation_size(self.model, self.config)

    @property
    def action_size(self) -> int:
        return self.model.nu

    def _outcome(self, data, fall, ref, episode_start=None):
        """(obs, reward, done, metrics) of engine ``data``, its fall (B,)
        float and ``ref``, the reference (qpos, qvel) at its time; ``done``
        None for a reset state (no ``episode_start``)."""
        m, clip, c = self.model, self.clip, self.config
        reward, terms = task.reward(m, clip, c, data.qpos, data.qvel, data.time, ref,
                                    data.xpos, data.xquat, fall)
        done = None
        if episode_start is not None:
            reward, done = task.termination(clip, c, data.time, episode_start, fall,
                                            terms["root_err"], reward)
        obs = task.observation(m, clip, c, data.qpos, data.qvel, data.time, ref[0],
                               data.xpos, data.xquat)
        return obs, reward, done, task.step_metrics(clip, data.time, fall, terms)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
              t0: Optional[torch.Tensor] = None) -> State:
        """Reset ``num_envs`` envs: start times from ``t0`` when given, else
        RSI draws of ``generator``; reset noise from ``generator``."""
        B, dev = num_envs, self.device

        def draw(fn, *shape):
            gdev = generator.device if generator is not None else dev
            return fn(B, *shape, generator=generator, device=gdev).to(dev)

        if t0 is None:
            t0 = task.start_times(self.clip, self.config, B, draw, dev)
        t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
        ref = reference_state(self.clip, t0)
        qpos, qvel = task.reset_noise(self.model, self.config, *ref, draw)
        data = run_kinematics(self.model, make_data(self.model, qpos=qpos, qvel=qvel)
                              .replace(time=t0))
        zeros = torch.zeros(B, device=dev)
        obs, _, _, metrics = self._outcome(data, zeros, ref)
        return State(pipeline=data, obs=obs, reward=zeros, done=zeros, metrics=metrics,
                     info={"episode_start": t0})

    def step(self, state: State, action: torch.Tensor) -> State:
        c, m, k = self.config, self.model, self.tables
        data = state.pipeline
        u, torque = action, c.action_mode == "torque"
        if not torque:
            u = task.pd_target(self.clip, c, data.time, action, k)
            if not c.pd_per_substep:  # one torque from the pre-step state, held
                u, torque = task.held_torque(m, c, data, u, k), True
        data = step_n(m, data, c.n_substeps, qfrc_fn=task.engine_controller(m, c, u, k, torque))
        data = run_kinematics(m, data)
        fall = task.detect_fall(m, data, k.fall_mask).to(torch.float32)
        ref = reference_state(self.clip, data.time)
        obs, reward, done, metrics = self._outcome(data, fall, ref, state.info["episode_start"])
        return state.replace(pipeline=data, obs=obs, reward=reward, done=done, metrics=metrics)

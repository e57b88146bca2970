"""Faults planted in the program under the benchmark: the readings that
set the upper ends of the training cells' limits, and the test that sees
``correct`` come out false, use them. Each ``plant`` returns its undo.

* ``unchanged``: a step that returns its state unchanged. In training the
  learner's step leaves every parameter as it was; in eval the policy step
  returns its input state.
* ``half_batch``: half of the batch left out. In training each
  minibatch's loss is the mean over its first half; in eval the policy
  step advances the first half of the envs and returns the rest unchanged.
* ``altered``: an answer altered where it is produced: the policy step's
  velocity of one joint is off by 0.05 rad/s in every env.
* ``no_reset`` (training): ``auto_reset`` returns its state as it is, so
  done envs are left unreset.
* ``no_curriculum`` (training, where the configuration has a curriculum):
  ``auto_reset`` never restarts an env from a peer's state.

The exchange between chips does not exist in a one-chip cell.
"""

from __future__ import annotations

import dataclasses

import torch

FAULTS = ("unchanged", "half_batch", "altered", "no_reset", "no_curriculum")


def applies(name: str, cell: dict, conf: dict) -> bool:
    """Whether a cell can have the fault."""
    if name == "no_reset":
        return cell["mode"] == "train"
    if name == "no_curriculum":
        return cell["mode"] == "train" and conf["env_config"]["curriculum_reset_prob"] > 0
    return name in FAULTS


class _Wrapped:
    """The policy step with ``fn`` around it; its other attributes (the
    launch count) are the step's."""

    def __init__(self, inner, fn):
        self.inner, self.fn = inner, fn

    def __call__(self, q, v, u):
        return self.fn(self.inner, q, v, u)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _wrap_kernel(prog, fn):
    env = prog.proxy._env
    inner = env._kstep
    env._kstep = _Wrapped(inner, fn)

    def undo():
        env._kstep = inner
    return undo


def plant(name: str, prog):
    mode = prog.cell["mode"]
    if name == "unchanged" and mode == "train":
        from pbrl_tpu_torch.train import optim

        step = optim.Adam.step

        def frozen(self, params):
            self.count += 1
            return torch.zeros(())
        optim.Adam.step = frozen
        return lambda: setattr(optim.Adam, "step", step)
    if name == "unchanged":
        return _wrap_kernel(prog, lambda k, q, v, u: (q.clone(), v.clone(), *k(q, v, u)[2:]))
    if name == "half_batch" and mode == "train":
        from pbrl_tpu_torch.train import ppo

        loss_fn = ppo.loss_fn

        def half(policy, value, config, batch, adv, ret, obs_stats):
            h = adv.shape[0] // 2
            part = type(batch)(**{k: getattr(batch, k)[:h] for k in vars(batch)})
            return loss_fn(policy, value, config, part, adv[:h], ret[:h], obs_stats)
        ppo.loss_fn = half
        return lambda: setattr(ppo, "loss_fn", loss_fn)
    if name == "half_batch":
        def half(k, q, v, u):
            h = q.shape[0] // 2
            out = list(k(q, v, u))
            out[0] = torch.cat([out[0][:h], q[h:]])
            out[1] = torch.cat([out[1][:h], v[h:]])
            return tuple(out)
        return _wrap_kernel(prog, half)
    if name == "altered":
        def altered(k, q, v, u):
            out = list(k(q, v, u))
            out[1] = out[1].clone()
            out[1][:, 6] += 0.05
            return tuple(out)
        return _wrap_kernel(prog, altered)
    env = prog.proxy._env
    if name == "no_reset":
        env.auto_reset = lambda state, *args, **kw: state

        def undo():
            del env.auto_reset
        return undo
    if name == "no_curriculum":
        config = env.config
        env.config = dataclasses.replace(config, curriculum_reset_prob=0.0)
        return lambda: setattr(env, "config", config)
    raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")

"""Faults planted in the program under the benchmark: the readings that
set the upper ends of the training cells' limits, and the test that sees
``correct`` come out false, use them. Each ``plant`` returns its undo.

Each mode owns its faults: ``benchmark/modes/<mode>.py`` names those its
program can have in ``FAULTS`` and plants them with ``plant(name, prog)``;
an optional ``applies(name, cell, conf)`` there narrows them to the cells
whose configuration has what a fault breaks. :func:`plant` and
:func:`applies` dispatch to the cell's mode. The faults of the train and
eval modes:

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

import torch

from benchmark.run import mode_of

# The faults of the train and eval modes (``calibrate.py --faults`` names them).
FAULTS = ("unchanged", "half_batch", "altered", "no_reset", "no_curriculum")


def applies(name: str, cell: dict, conf: dict) -> bool:
    """Whether a cell can have the fault: one of its mode's, and, where the
    mode narrows them, one its configuration allows."""
    mode = mode_of(cell)
    if name not in mode.FAULTS:
        return False
    narrow = getattr(mode, "applies", None)
    return narrow is None or narrow(name, cell, conf)


def plant(name: str, prog):
    """Plant a fault of the program's mode; returns its undo."""
    mode = mode_of(prog.cell)
    if name not in mode.FAULTS:
        raise ValueError(f"{name!r} is not a fault of mode {prog.cell['mode']!r}; "
                         f"its faults: {mode.FAULTS}")
    return mode.plant(name, prog)


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
    """``fn(step, q, v, u)`` in place of the env's policy-step kernel."""
    env = prog.proxy._env
    inner = env._kstep
    env._kstep = _Wrapped(inner, fn)

    def undo():
        env._kstep = inner
    return undo


def _altered(k, q, v, u):
    """The policy step with one joint's velocity off by 0.05 rad/s."""
    out = list(k(q, v, u))
    out[1] = out[1].clone()
    out[1][:, 6] += 0.05
    return tuple(out)

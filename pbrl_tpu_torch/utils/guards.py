"""Numerical guards: finiteness checks and anomaly detection (counterpart
of ``pbrl_tpu/utils/guards.py``).

pbrl_tpu checks inside ``jit`` through a debug callback; the port runs
eagerly, so :func:`assert_finite` is a plain host-side check (one device
sync). :func:`nan_debug_enabled` turns on autograd's anomaly detection,
which names the operation whose backward first gives a NaN, where
pbrl_tpu turns on ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch


def assert_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Raise ``FloatingPointError`` when ``x`` holds a NaN or an inf."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x


def check_finite_tree(tree, prefix: str = "") -> list:
    """Paths of the non-finite float leaves of a tree of dicts, lists,
    tuples, dataclasses and modules (a module counts as its
    ``state_dict``), in pbrl_tpu's ``keystr`` form (``['key']``,
    ``[0]``, ``.field``); an empty list when every leaf is finite."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        items = [(f"[{k!r}]", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        leaf = torch.as_tensor(tree) if isinstance(tree, (float, int)) else tree
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            return [prefix]
        return []
    return [p for key, v in items for p in check_finite_tree(v, prefix + key)]


@contextlib.contextmanager
def nan_debug_enabled():
    """Within the block, autograd's anomaly detection is on: a backward
    that gives a NaN raises, naming the forward operation at fault."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)

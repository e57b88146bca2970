"""The one walk over a tree of states: tensors in dicts and dataclasses,
nested (env states, engine ``Data`` and its ``Contact``, batches of them).
It stands here, below ``envs`` and ``parallel``, so that both use it."""

from __future__ import annotations

import dataclasses

import torch


def map_states(fn, *states):
    """``fn`` over the tensors of states of one structure (dataclasses and
    dicts, nested, as engine ``Data`` and its ``Contact`` are), leaf by
    leaf; ``None`` and other non-tensor leaves are the first state's."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return fn(*states)
    if isinstance(first, dict):
        return {k: map_states(fn, *(s[k] for s in states)) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: map_states(fn, *(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(first)})
    return first

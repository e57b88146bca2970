"""Config serialisation: dataclass configs <-> dict / JSON.

Counterpart of ``pbrl_tpu/utils/configio.py`` (``config_to_dict`` and
``dict_to_config``): ``EnvConfig`` and ``TrainConfig`` round-trip through
``run_config.json`` in the same schema, tuples as JSON lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Type, TypeVar

T = TypeVar("T")


def config_to_dict(cfg: Any) -> dict:
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"{type(cfg).__name__} is not a dataclass config")
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def dict_to_config(cls: Type[T], d: dict) -> T:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

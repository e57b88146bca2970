"""Config serialisation: dataclass configs <-> dict / JSON.

Counterpart of ``pbrl_tpu/utils/configio.py``: ``EnvConfig`` and
``TrainConfig`` round-trip through ``run_config.json`` in the same schema,
tuples as JSON lists; :func:`save_json_config` writes one config to its own
file (``apg_config.json``) with its class name under ``__config__``.
"""

from __future__ import annotations

import dataclasses
import json
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


def save_json_config(path: str, cfg: Any) -> None:
    with open(path, "w") as f:
        json.dump({"__config__": type(cfg).__name__, **config_to_dict(cfg)}, f, indent=2)


def load_json_config(path: str, cls: Type[T]) -> T:
    with open(path) as f:
        d = json.load(f)
    d.pop("__config__", None)
    return dict_to_config(cls, d)

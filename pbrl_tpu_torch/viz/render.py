"""Trajectory dump and load (counterpart of the numpy part of
``pbrl_tpu/viz/render.py``): a (T, nq) qpos trajectory, its frame rate and
optional qvel and metrics in one ``.npz``. Rendering a video needs host
MuJoCo and is not part of the port."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def dump_trajectory(path: str, qpos, fps: float, *, qvel=None,
                    metrics: Optional[dict] = None) -> None:
    """Save a (T, nq) trajectory (+ optional qvel and metrics) as .npz."""
    payload = {"qpos": np.asarray(qpos), "fps": np.asarray(fps)}
    if qvel is not None:
        payload["qvel"] = np.asarray(qvel)
    for k, v in (metrics or {}).items():
        payload[f"metric_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **payload)


def load_trajectory(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}

"""Trajectory dump and offline rendering by host MuJoCo (counterpart of
``pbrl_tpu/viz/render.py``).

A (T, nq) qpos trajectory, its frame rate and optional qvel and metrics go
into one ``.npz``. ``render_video`` renders a trajectory on the host:
the model is exported to MJCF (:func:`~pbrl_tpu_torch.model.mjcf.to_mjcf`)
and ``mujoco.Renderer`` draws each frame, with pbrl_tpu's lighting and
colours, off the simulation's path. MuJoCo is imported there only, and a
missing MuJoCo raises an ``ImportError`` that names it.
"""

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


def render_video(spec_or_model, qpos: np.ndarray, *, width=640, height=480,
                 camera: Optional[str] = None) -> np.ndarray:
    """(T, H, W, 3) uint8 frames of a qpos trajectory, rendered by host
    MuJoCo from a :class:`~pbrl_tpu_torch.model.spec.ModelSpec`."""
    # headless (no DISPLAY): MuJoCo needs an offscreen GL backend; EGL by default
    if "MUJOCO_GL" not in os.environ and not os.environ.get("DISPLAY"):
        os.environ["MUJOCO_GL"] = "egl"
    try:
        import mujoco
    except ImportError as e:
        raise ImportError("render_video needs host MuJoCo (the mujoco package), "
                          "which is not installed") from e

    from pbrl_tpu_torch.model.mjcf import to_mjcf
    from pbrl_tpu_torch.model.spec import ModelSpec

    if not isinstance(spec_or_model, ModelSpec):
        raise TypeError("render_video needs the ModelSpec (e.g. humanoid_spec())")
    mj = mujoco.MjModel.from_xml_string(to_mjcf(spec_or_model))
    # the exported MJCF has no lights or materials: a brighter headlight and
    # distinct robot and floor colours (visual only)
    mj.vis.headlight.ambient[:] = (0.35, 0.35, 0.35)
    mj.vis.headlight.diffuse[:] = (0.9, 0.9, 0.9)
    mj.vis.headlight.specular[:] = (0.3, 0.3, 0.3)
    plane = mj.geom_type == mujoco.mjtGeom.mjGEOM_PLANE
    mj.geom_rgba[plane] = (0.82, 0.84, 0.87, 1.0)
    mj.geom_rgba[~plane] = (0.35, 0.48, 0.78, 1.0)
    data = mujoco.MjData(mj)
    renderer = mujoco.Renderer(mj, height=height, width=width)
    frames = []
    for q in np.asarray(qpos):
        data.qpos[: mj.nq] = q
        mujoco.mj_forward(mj, data)
        if camera:
            renderer.update_scene(data, camera=camera)
        else:
            renderer.update_scene(data)
        frames.append(renderer.render().copy())
    renderer.close()
    return np.stack(frames)


def save_video(path: str, frames: np.ndarray, fps: float = 30.0) -> str:
    """Write frames as pbrl_tpu does: an mp4 through mediapy, else through
    imageio; without an mp4 encoder an animated GIF beside it, else the
    frames as ``<path>_frames.npz``. Returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import mediapy

        mediapy.write_video(path, frames, fps=fps)
        return path
    except Exception:
        pass
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        pass
    try:
        import imageio

        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(alt, frames, duration=1000.0 / fps, loop=0)
        return alt
    except Exception:
        alt = os.path.splitext(path)[0] + "_frames.npz"
        np.savez_compressed(alt, frames=frames, fps=fps)
        return alt

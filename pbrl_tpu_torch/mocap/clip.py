"""Motion clips on the device with time-indexed reference lookup.

Counterpart of ``pbrl_tpu/mocap/clip.py``. The lookups take a batch of
query times ``t`` (any shape) instead of one vmapped scalar. DeepMimic
clips are uniform-dt, so the frame index is a multiply + floor; a ``wrap``
clip loops in time with the root's horizontal displacement accumulated per
cycle, so walking references keep moving forward.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional

import numpy as np
import torch

from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.mocap.convert import ParsedClip, parse_deepmimic

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "motions")


@dataclasses.dataclass(frozen=True)
class MotionClip:
    """Clip tensors on one device. Shapes: T frames, nq=35, nv=34."""

    qpos: torch.Tensor          # (T, nq)
    qvel: torch.Tensor          # (T, nv)
    dt: torch.Tensor            # () uniform frame dt
    cycle_time: torch.Tensor    # () total clip time
    cycle_offset: torch.Tensor  # (3,) root displacement per cycle (z zeroed)
    loop: bool
    num_frames: int
    # FK-derived reference quantities (envs.humanoid_task.augment_clip).
    ee_pos: Optional[torch.Tensor] = None  # (T, n_ee, 3)
    com: Optional[torch.Tensor] = None     # (T, 3)
    name: str = "clip"

    def replace(self, **kw) -> "MotionClip":
        return dataclasses.replace(self, **kw)


def _np_slerp(q0: np.ndarray, q1: np.ndarray, alpha: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    d = min(d, 1.0)
    theta = np.arccos(d)
    if theta < 1e-8:
        out = q0 + alpha * (q1 - q0)
    else:
        s = np.sin(theta)
        out = (np.sin((1 - alpha) * theta) * q0 + np.sin(alpha * theta) * q1) / s
    return out / np.linalg.norm(out)


def resample_uniform(p: ParsedClip) -> ParsedClip:
    """Resample a non-uniform-dt clip to the median frame interval (linear
    on qpos/qvel, root quaternion slerped)."""
    inter = np.asarray(p.durations[:-1], np.float64)
    dt = float(np.median(inter))
    T_new = int(np.floor(p.total_time / dt + 1e-9)) + 1
    ct = p.cum_time
    qpos = np.empty((T_new, p.qpos.shape[1]))
    qvel = np.empty((T_new, p.qvel.shape[1]))
    for k in range(T_new):
        t = min(k * dt, p.total_time - 1e-9)
        i = int(np.searchsorted(ct, t, side="right")) - 1
        i = min(max(i, 0), len(ct) - 1)
        if i >= len(ct) - 1:
            qpos[k], qvel[k] = p.qpos[-1], p.qvel[-1]
            continue
        a = (t - ct[i]) / max(float(p.durations[i]), 1e-12)
        a = min(max(a, 0.0), 1.0)
        qpos[k] = p.qpos[i] + a * (p.qpos[i + 1] - p.qpos[i])
        qpos[k, 3:7] = _np_slerp(p.qpos[i, 3:7], p.qpos[i + 1, 3:7], a)
        qvel[k] = p.qvel[i] + a * (p.qvel[i + 1] - p.qvel[i])
    durations = np.full(T_new, dt)
    durations[-1] = 0.0
    out = ParsedClip(qpos, qvel, durations, loop=p.loop, source=p.source)
    out.total_time = (T_new - 1) * dt
    return out


def from_parsed(p: ParsedClip, name: str = "clip", device="cuda",
                dtype=torch.float32) -> MotionClip:
    inter = np.asarray(p.durations[:-1], np.float64)
    if inter.size and not np.allclose(inter, inter[0], rtol=1e-5, atol=1e-9):
        p = resample_uniform(p)
    offset = p.qpos[-1, :3] - p.qpos[0, :3]
    offset[2] = 0.0  # vertical displacement never accumulates

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)

    return MotionClip(
        qpos=t(p.qpos), qvel=t(p.qvel), dt=t(p.dt), cycle_time=t(p.total_time),
        cycle_offset=t(offset), loop=p.loop == "wrap", num_frames=p.num_frames,
        name=name,
    )


def clip_path(name_or_path: str) -> str:
    """Path of a bundled clip short name ('walk') or of a DeepMimic file."""
    if os.path.exists(name_or_path):
        return name_or_path
    path = os.path.join(_ASSET_DIR, f"humanoid3d_{name_or_path}.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no clip {name_or_path!r}; bundled clips: {bundled_clip_names()}")
    return path


def load_clip(name_or_path: str, device="cuda", dtype=torch.float32, **kw) -> MotionClip:
    """Load a clip: a bundled short name ('walk'), a DeepMimic .txt path, or a
    DiffMimic .npy path (per-body world poses, :mod:`.diffmimic`), looked
    up under ``assets/motion_diffmimic/`` when it is not a file."""
    if name_or_path.endswith(".npy"):
        from pbrl_tpu_torch.mocap.diffmimic import parse_diffmimic_npy

        if not os.path.exists(name_or_path):
            alt = os.path.join(_ASSET_DIR, "..", "motion_diffmimic", name_or_path)
            if not os.path.exists(alt):
                raise FileNotFoundError(name_or_path)
            name_or_path = alt
        name = os.path.splitext(os.path.basename(name_or_path))[0]
        return from_parsed(parse_diffmimic_npy(name_or_path, **kw), name=name, device=device,
                           dtype=dtype)
    path = clip_path(name_or_path)
    name = (os.path.splitext(os.path.basename(path))[0]
            if os.path.exists(name_or_path) else name_or_path)
    return from_parsed(parse_deepmimic(path, **kw), name=name, device=device,
                       dtype=dtype)


def _frame_and_cycle(clip: MotionClip, t):
    if clip.loop:
        cycle = torch.floor(t / clip.cycle_time)
        t_mod = t - cycle * clip.cycle_time
    else:
        cycle = torch.zeros_like(t)
        t_mod = torch.minimum(torch.clamp(t, min=0.0), clip.cycle_time)
    return t_mod / clip.dt, cycle


def _frames(clip: MotionClip, f):
    T = clip.num_frames
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, T - 1)
    alpha = f - i0.to(f.dtype)
    i1 = (i0 + 1) % T if clip.loop else torch.clamp(i0 + 1, max=T - 1)
    return i0, i1, alpha


def reference_state(clip: MotionClip, t: torch.Tensor, interpolate: bool = True):
    """(qpos (..., nq), qvel (..., nv)) of the reference motion at times t.

    Linear interpolation between frames with the root quaternion slerped;
    ``wrap`` clips accumulate the horizontal cycle offset.
    """
    f, cycle = _frame_and_cycle(clip, t)
    i0, i1, alpha = _frames(clip, f)
    if not interpolate:
        qpos = clip.qpos[i0]
        qvel = clip.qvel[i0]
    else:
        a = alpha[..., None]
        q0, q1 = clip.qpos[i0], clip.qpos[i1].clone()
        wrapped = (i1 < i0).to(q0.dtype)[..., None]
        q1[..., :3] = q1[..., :3] + wrapped * clip.cycle_offset
        qpos = q0 + a * (q1 - q0)
        rq = quat.mul(
            q0[..., 3:7],
            quat.from_rotvec(a * quat.to_rotvec(
                quat.mul(quat.conj(q0[..., 3:7]), q1[..., 3:7]))),
        )
        qpos = torch.cat([qpos[..., :3], quat.normalize(rq), qpos[..., 7:]], dim=-1)
        qvel = clip.qvel[i0] + a * (clip.qvel[i1] - clip.qvel[i0])
    root = qpos[..., :3] + cycle[..., None] * clip.cycle_offset
    return torch.cat([root, qpos[..., 3:]], dim=-1), qvel


def reference_aux(clip: MotionClip, t: torch.Tensor):
    """Interpolated (ee_pos (..., n_ee, 3), com (..., 3)) at times t."""
    if clip.ee_pos is None or clip.com is None:
        raise ValueError("clip not augmented: call envs.humanoid_task.augment_clip")
    f, cycle = _frame_and_cycle(clip, t)
    i0, i1, alpha = _frames(clip, f)
    wrapped = (i1 < i0).to(clip.com.dtype)
    shift = wrapped[..., None] * clip.cycle_offset
    a = alpha[..., None]
    ee = clip.ee_pos[i0] + a[..., None] * (clip.ee_pos[i1] + shift[..., None, :]
                                           - clip.ee_pos[i0])
    com = clip.com[i0] + a * (clip.com[i1] + shift - clip.com[i0])
    total = cycle[..., None] * clip.cycle_offset
    return ee + total[..., None, :], com + total


def reference_frame_index(clip: MotionClip, t: torch.Tensor) -> torch.Tensor:
    """Integer frame index at times t."""
    f, _ = _frame_and_cycle(clip, t)
    return torch.clamp(torch.floor(f).to(torch.int64), 0, clip.num_frames - 1)


def phase(clip: MotionClip, t: torch.Tensor) -> torch.Tensor:
    """Normalized clip phase in [0, 1)."""
    if clip.loop:
        return torch.remainder(t, clip.cycle_time) / clip.cycle_time
    return torch.clamp(t / clip.cycle_time, 0.0, 1.0)


def bundled_clip_names():
    return sorted(
        os.path.basename(p)[11:-4]
        for p in glob.glob(os.path.join(_ASSET_DIR, "humanoid3d_*.txt"))
    )

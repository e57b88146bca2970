"""DeepMimic ``humanoid3d_*.txt`` clip parser and MuJoCo-frame converter.

The port's own copy of ``pbrl_tpu/mocap/convert.py`` (host numpy, f64):
parse the JSON clip, convert the left-handed y-up mocap frame to the
right-handed z-up model frame, emit ``qpos`` rows (spherical joints as
intrinsic-xyz Euler triples with branch continuity) and ``qvel`` rows by
finite differencing. Files are read by the native C++ parser
(:mod:`pbrl_tpu_torch.io_native`) where it is available, else by the
standard ``json`` module; both give the same frames.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List

import numpy as np

from pbrl_tpu_torch.mocap.skeleton import DOF, DP_JOINT_ORDER, MODEL_JOINT_ORDER

# ---------------------------------------------------------------------------
# Minimal f64 quaternion helpers (host only; device math lives in maths/)
# ---------------------------------------------------------------------------


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _qconj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qnorm(q: np.ndarray) -> np.ndarray:
    return q / max(np.linalg.norm(q), 1e-12)


def _qlog(q: np.ndarray) -> np.ndarray:
    """Rotation vector of a unit quaternion, shortest arc."""
    q = -q if q[0] < 0 else q
    s = np.linalg.norm(q[1:])
    if s < 1e-12:
        return 2.0 * q[1:]
    angle = 2.0 * math.atan2(s, q[0])
    return q[1:] * (angle / s)


def _euler_rxyz(q: np.ndarray) -> np.ndarray:
    """Intrinsic x-y-z Euler angles of unit q (R = Rx Ry Rz).

    Same decomposition as the vendored Gohlke ``euler_from_quaternion(...,
    'rxyz')`` used by the reference (``SimpleConverter.py:178``).
    """
    w, x, y, z = q
    m02 = 2 * (x * z + w * y)
    m02 = np.clip(m02, -1.0, 1.0)
    b = math.asin(m02)
    if abs(m02) > 1.0 - 1e-9:  # gimbal lock
        a = math.atan2(2 * (y * z + w * x), 1 - 2 * (x * x + z * z))
        c = 0.0
    else:
        m12 = 2 * (y * z - w * x)
        m22 = 1 - 2 * (x * x + y * y)
        a = math.atan2(-m12, m22)
        m01 = 2 * (x * y - w * z)
        m00 = 1 - 2 * (y * y + z * z)
        c = math.atan2(-m01, m00)
    return np.array([a, b, c])


# Mocap (left-handed, y-up) -> MuJoCo (right-handed, z-up).
_POS_PERM = np.array([
    [1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0],
    [0.0, 1.0, 0.0],
])
# Quaternion of _POS_PERM: rotation by +90 deg about x.
_L = np.array([math.cos(math.pi / 4), math.sin(math.pi / 4), 0.0, 0.0])
_L_INV = _qconj(_L)


def align_position(pos: np.ndarray) -> np.ndarray:
    """[x, y, z]_mocap -> [x, -z, y]_mujoco (``math_utils.py:15-22``)."""
    return _POS_PERM @ np.asarray(pos, np.float64)


def align_rotation(q_wxyz: np.ndarray) -> np.ndarray:
    """Conjugate the mocap quaternion into the MuJoCo frame
    (``math_utils.py:25-42``: ``q' = L q L^-1``)."""
    return _qnorm(_qmul(_L, _qmul(np.asarray(q_wxyz, np.float64), _L_INV)))


def _unwrap_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a - b wrapped to (-pi, pi] per component."""
    d = a - b
    return (d + np.pi) % (2.0 * np.pi) - np.pi


def _continuous_euler_track(quats: np.ndarray) -> np.ndarray:
    """Euler-rxyz trajectory with branch continuity and recentred range.

    The two euler solutions of a rotation — (a, b, c) and
    (a+pi, pi-b, c+pi) — describe the same pose; picking whichever is
    closer to the previous frame avoids the ±pi branch flips that a naive
    per-frame decomposition + unwrap turns into spurious multi-revolution
    hinge excursions (fatal for PD tracking and joint limits on e.g. the
    backflip clip's hips). Afterwards each column is unwrapped in time and
    shifted by whole turns so its median lies in (-pi, pi].
    """
    e = np.zeros((len(quats), 3))
    prev = None
    for k, q in enumerate(quats):
        cand = _euler_rxyz(q)
        if prev is not None:
            alt = np.array([cand[0] + np.pi, np.pi - cand[1], cand[2] + np.pi])
            d_c = np.abs(_unwrap_diff(cand, prev)).sum()
            d_a = np.abs(_unwrap_diff(alt, prev)).sum()
            if d_a < d_c:
                cand = alt
            cand = prev + _unwrap_diff(cand, prev)
        e[k] = cand
        prev = cand
    # recentre whole columns (continuity preserved; pose unchanged mod 2pi
    # only via full-turn shifts, which hinge triples realise identically)
    med = np.median(e, axis=0)
    e -= np.round(med / (2.0 * np.pi)) * 2.0 * np.pi
    return e


class ParsedClip:
    """Raw parse + converted arrays for one DeepMimic clip."""

    def __init__(self, qpos, qvel, durations, loop: str, source: str):
        self.qpos = qpos            # (T, 35) float64
        self.qvel = qvel            # (T, 34) float64
        self.durations = durations  # (T,) per-frame dt
        self.loop = loop            # "wrap" | "none"
        self.source = source
        self.total_time = float(np.sum(durations))
        self.cum_time = np.concatenate([[0.0], np.cumsum(durations)[:-1]])

    @property
    def num_frames(self) -> int:
        return self.qpos.shape[0]

    @property
    def dt(self) -> float:
        return float(self.durations[0])

    def duration_dict(self) -> Dict[int, List[float]]:
        """{frame: [cumulative_start_time, duration]} — reference
        ``SimpleConverter.create_dict_duration`` (``:226-238``)."""
        return {
            i: [float(self.cum_time[i]), float(self.durations[i])]
            for i in range(self.num_frames)
        }


def parse_deepmimic(path_or_json: str, *, velocity_mode: str = "euler_rate") -> ParsedClip:
    """Parse a DeepMimic humanoid3d clip file (or raw JSON string)."""
    if path_or_json.lstrip().startswith("{"):
        data = json.loads(path_or_json)
        source = "<string>"
        frames = np.asarray(data["Frames"], np.float64)
        loop = str(data.get("Loop", "none")).strip('"')
    else:
        source = path_or_json
        frames = None
        # the native C++ parser (native/pbrl_io.cpp) when it is available
        # (PBRL_NATIVE unset or 1, a host C++ compiler), else Python's json;
        # a file the native parser refuses is read by json, as in pbrl_tpu
        from pbrl_tpu_torch import io_native

        if io_native.available():
            try:
                frames, loop = io_native.load_frames(path_or_json)
            except RuntimeError:
                frames = None
        if frames is None:
            with open(path_or_json) as f:
                data = json.load(f)
            frames = np.asarray(data["Frames"], np.float64)
            loop = str(data.get("Loop", "none")).strip('"')

    T = frames.shape[0]
    durations = frames[:, 0]

    # --- per-frame aligned states ------------------------------------------
    root_pos = np.stack([align_position(f[1:4]) for f in frames])
    root_quat = np.stack([align_rotation(f[4:8]) for f in frames])
    joints: Dict[str, np.ndarray] = {}
    idx = 8
    for name in DP_JOINT_ORDER:
        if DOF[name] == 1:
            joints[name] = frames[:, idx : idx + 1].copy()
            idx += 1
        else:
            joints[name] = np.stack([align_rotation(f[idx : idx + 4]) for f in frames])
            idx += 4
    assert idx == frames.shape[1], f"frame width {frames.shape[1]} != parsed {idx}"

    # --- qpos rows ----------------------------------------------------------
    qpos = np.zeros((T, 35))
    qpos[:, :3] = root_pos
    qpos[:, 3:7] = root_quat
    col = 7
    eulers: Dict[str, np.ndarray] = {}
    for name in MODEL_JOINT_ORDER:
        if DOF[name] == 1:
            qpos[:, col] = joints[name][:, 0]
            col += 1
        else:
            e = _continuous_euler_track(joints[name])
            eulers[name] = e
            qpos[:, col : col + 3] = e
            col += 3
    assert col == 35

    # --- qvel rows (frame k velocity over the k-1 -> k interval) ------------
    qvel = np.zeros((T, 34))
    for k in range(1, T):
        dt = durations[k - 1]
        qvel[k, :3] = (root_pos[k] - root_pos[k - 1]) / dt
        # Free-joint angular velocity in the *body-local* frame (MuJoCo
        # convention): omega = log(q_prev^-1 q_cur) / dt.
        qvel[k, 3:6] = _qlog(_qmul(_qconj(root_quat[k - 1]), root_quat[k])) / dt
        col = 6
        for name in MODEL_JOINT_ORDER:
            if DOF[name] == 1:
                qvel[k, col] = _unwrap_diff(joints[name][k], joints[name][k - 1])[0] / dt
                col += 1
            else:
                if velocity_mode == "euler_rate":
                    qvel[k, col : col + 3] = (eulers[name][k] - eulers[name][k - 1]) / dt
                elif velocity_mode == "quat_log":
                    qvel[k, col : col + 3] = (
                        _qlog(_qmul(_qconj(joints[name][k - 1]), joints[name][k])) / dt
                    )
                else:
                    raise ValueError(f"unknown velocity_mode {velocity_mode!r}")
                col += 3
    # Frame 0: reference sets zero velocity (``SimpleConverter.py:106``); we
    # copy frame 1 for loop clips so RSI at phase 0 starts moving.
    if T > 1:
        qvel[0] = qvel[1] if loop == "wrap" else 0.0

    return ParsedClip(qpos, qvel, durations, loop, source)

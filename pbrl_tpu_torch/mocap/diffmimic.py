"""DiffMimic ``.npy`` clip loader (per-body world-pose format; the port's
own copy of ``pbrl_tpu/mocap/diffmimic.py``, host numpy in f64 on the
port's copies of the ``convert.py`` helpers).

The reference ships ``motion_diffmimic/walk_fps_30_20s.npy`` but never loads
it (SURVEY.md §2: "referenced by no code; future-work asset"). This module
realises that capability: the format is column-grouped per frame —
``[pos (nb, 3) | quat (nb, 4 wxyz) | linvel (nb, 3) | angvel (nb, 3)]`` in
world coordinates (verified on the bundled file: unit quaternions,
physically-ordered heights) — and is converted to our ``qpos``/``qvel``
layout by re-deriving joint coordinates from relative parent-child
rotations.

Body order of the bundled file matches the DeepMimic-skeleton humanoid
(root, chest, neck, R/L shoulder+elbow, R/L hip+knee+ankle) with one
trailing extra body (scene object) that is ignored.
"""

from __future__ import annotations

import numpy as np

from pbrl_tpu_torch.mocap.convert import (
    ParsedClip,
    _continuous_euler_track,
    _qconj,
    _qlog,
    _qmul,
    _qnorm,
)
from pbrl_tpu_torch.mocap.skeleton import DOF, MODEL_JOINT_ORDER

# body index in the npy stream for each model body (parent listed too)
_BODY_INDEX = {
    "root": 0, "chest": 1, "neck": 2, "right_shoulder": 3, "right_elbow": 4,
    "left_shoulder": 5, "left_elbow": 6, "right_hip": 7, "right_knee": 8,
    "right_ankle": 9, "left_hip": 10, "left_knee": 11, "left_ankle": 12,
}
_PARENT = {
    "chest": "root", "neck": "chest", "right_shoulder": "chest",
    "right_elbow": "right_shoulder", "left_shoulder": "chest",
    "left_elbow": "left_shoulder", "right_hip": "root",
    "right_knee": "right_hip", "right_ankle": "right_knee",
    "left_hip": "root", "left_knee": "left_hip", "left_ankle": "left_knee",
}
# Hinge axes of the single-dof joints (body frame), from the humanoid spec.
_HINGE_AXIS = {"right_elbow": (0.0, -1.0, 0.0), "left_elbow": (0.0, -1.0, 0.0),
               "right_knee": (0.0, -1.0, 0.0), "left_knee": (0.0, -1.0, 0.0)}


def parse_diffmimic_npy(path: str, fps: float = 30.0) -> ParsedClip:
    """Load a DiffMimic npy clip into the standard ParsedClip form."""
    raw = np.load(path)
    T, width = raw.shape
    if width % 13:
        raise ValueError(f"frame width {width} is not nb*13")
    nb = width // 13
    if nb < 13:
        raise ValueError(f"need >= 13 bodies, file has {nb}")
    pos = raw[:, : nb * 3].reshape(T, nb, 3)
    quat = raw[:, nb * 3 : nb * 7].reshape(T, nb, 4)
    # linvel = raw[:, nb*7 : nb*10]  (world; velocities are re-derived by
    # finite differencing for consistency with the joint coordinates)

    dt = 1.0 / fps
    qpos = np.zeros((T, 35))
    qpos[:, :3] = pos[:, _BODY_INDEX["root"]]
    qpos[:, 3:7] = np.stack([_qnorm(q) for q in quat[:, _BODY_INDEX["root"]]])

    col = 7
    for name in MODEL_JOINT_ORDER:
        bi = _BODY_INDEX[name]
        pi = _BODY_INDEX[_PARENT[name]]
        rel = np.stack([
            _qnorm(_qmul(_qconj(_qnorm(quat[k, pi])), _qnorm(quat[k, bi])))
            for k in range(T)
        ])
        if DOF[name] == 1:
            ax = np.asarray(_HINGE_AXIS[name])
            # angle about the known hinge axis: rel ~ [cos(a/2), sin(a/2)*ax]
            sin_half = rel[:, 1:] @ ax
            angle = 2.0 * np.arctan2(sin_half, rel[:, 0])
            qpos[:, col] = np.unwrap(angle)
            col += 1
        else:
            qpos[:, col : col + 3] = _continuous_euler_track(rel)
            col += 3
    assert col == 35

    qvel = np.zeros((T, 34))
    for k in range(1, T):
        qvel[k, :3] = (qpos[k, :3] - qpos[k - 1, :3]) / dt
        qvel[k, 3:6] = _qlog(_qmul(_qconj(qpos[k - 1, 3:7]), qpos[k, 3:7])) / dt
        qvel[k, 6:] = (qpos[k, 7:] - qpos[k - 1, 7:]) / dt
    if T > 1:
        qvel[0] = qvel[1]

    durations = np.full(T, dt)
    return ParsedClip(qpos, qvel, durations, loop="wrap", source=path)

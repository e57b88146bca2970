"""DeepMimic skeleton tables: joint orders, DoF map, PD gain table.

The port's own copy of ``pbrl_tpu/mocap/skeleton.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

# Joint order as serialized in DeepMimic humanoid3d clips (after the root).
DP_JOINT_ORDER = (
    "chest", "neck", "right_hip", "right_knee", "right_ankle",
    "right_shoulder", "right_elbow", "left_hip", "left_knee", "left_ankle",
    "left_shoulder", "left_elbow",
)

# Joint order of the humanoid model's qpos layout (matches the builder's
# body ordering in pbrl_tpu.model.builders.humanoid_spec).
MODEL_JOINT_ORDER = (
    "chest", "neck", "right_shoulder", "right_elbow", "left_shoulder",
    "left_elbow", "right_hip", "right_knee", "right_ankle", "left_hip",
    "left_knee", "left_ankle",
)

# Degrees of freedom per mocap joint (3 = spherical serialized as wxyz quat,
# 1 = hinge serialized as a single angle).
DOF = {
    "chest": 3, "neck": 3, "right_shoulder": 3, "right_elbow": 1,
    "left_shoulder": 3, "left_elbow": 1, "right_hip": 3, "right_knee": 1,
    "right_ankle": 3, "left_hip": 3, "left_knee": 1, "left_ankle": 3,
}

# Per-joint [kp, kd] PD gains (reference ``util_data.py:36-38``).
PD_GAINS = {
    "chest": (1000.0, 100.0), "neck": (100.0, 10.0),
    "right_shoulder": (400.0, 40.0), "right_elbow": (300.0, 30.0),
    "left_shoulder": (400.0, 40.0), "left_elbow": (300.0, 30.0),
    "right_hip": (500.0, 50.0), "right_knee": (500.0, 50.0),
    "right_ankle": (400.0, 40.0), "left_hip": (500.0, 50.0),
    "left_knee": (500.0, 50.0), "left_ankle": (400.0, 40.0),
}

# End-effector bodies for the DeepMimic end-effector reward term.
END_EFFECTORS = ("right_elbow", "left_elbow", "right_ankle", "left_ankle")

NU = sum(DOF.values())  # 28 actuated dofs


def generate_kp_kd_gains(dtype=np.float32):
    """(28,) kp and kd vectors in MODEL_JOINT_ORDER dof order."""
    kp, kd = [], []
    for joint in MODEL_JOINT_ORDER:
        p, d = PD_GAINS[joint]
        kp += [p] * DOF[joint]
        kd += [d] * DOF[joint]
    return np.asarray(kp, dtype), np.asarray(kd, dtype)

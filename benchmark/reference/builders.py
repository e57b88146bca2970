"""Built-in model builders: DeepMimic humanoid and sphere test scene.

Counterpart of ``pbrl_tpu/model/builders.py``: the same programmatic
specs (13-body humanoid with a free root and 28 hinges, nq 35 / nv 34 /
nu 28; a 5 kg r=0.1 free sphere), compiled by the port's host-side
compiler into float32 numpy arrays.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.spec import (
    ActuatorSpec,
    CameraSpec,
    GeomSpec,
    GeomType,
    JointSpec,
    JointType,
    ModelSpec,
    SiteSpec,
)

_ID_QUAT = (1.0, 0.0, 0.0, 0.0)
_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def _hinge(name, axis, rng, armature=1.0, damping=1.0):
    return JointSpec(
        name=name,
        type=JointType.HINGE,
        axis=np.asarray(axis, np.float64),
        pos=np.zeros(3),
        range=(float(rng[0]), float(rng[1])),
        limited=True,
        armature=armature,
        damping=damping,
    )


def _hinge3(base, ranges):
    """x/y/z hinge triple at the body origin (DeepMimic spherical joint)."""
    return [_hinge(f"{base}_{ax}", _AXES[ax], r) for ax, r in zip("xyz", ranges)]


def _sphere(name, r, pos, mass):
    return GeomSpec(
        name=name,
        type=GeomType.SPHERE,
        size=np.array([r, 0.0, 0.0]),
        pos=np.asarray(pos, np.float64),
        quat=np.asarray(_ID_QUAT),
        mass=mass,
    )


def _zcapsule(name, r, z0, z1, mass):
    """Capsule whose axis runs along local z from z0 to z1 (MJCF fromto)."""
    mid = 0.5 * (z0 + z1)
    hh = 0.5 * abs(z1 - z0)
    return GeomSpec(
        name=name,
        type=GeomType.CAPSULE,
        size=np.array([r, hh, 0.0]),
        pos=np.array([0.0, 0.0, mid]),
        quat=np.asarray(_ID_QUAT),
        mass=mass,
    )


def _box(name, half, pos, mass):
    return GeomSpec(
        name=name,
        type=GeomType.BOX,
        size=np.asarray(half, np.float64),
        pos=np.asarray(pos, np.float64),
        quat=np.asarray(_ID_QUAT),
        mass=mass,
    )


def _site(name, pos):
    return SiteSpec(name=name, pos=np.asarray(pos, np.float64), quat=np.asarray(_ID_QUAT))


def humanoid_spec(gravity: bool = True, floor: bool = True) -> ModelSpec:
    """DeepMimic-skeleton 28-DoF humanoid (13 bodies, free root)."""
    spec = ModelSpec(name="humanoid", timestep=0.002)
    if not gravity:
        spec.gravity = np.zeros(3)
    if floor:
        spec.world_geoms.append(
            GeomSpec(
                name="floor",
                type=GeomType.PLANE,
                size=np.array([50.0, 50.0, 0.2]),
                pos=np.zeros(3),
                quat=np.asarray(_ID_QUAT),
                mass=0.0,
                friction=1.0,
                margin=1e-3,
            )
        )

    root = spec.add_body("root", None, pos=(0, 0, 0.9))
    root.joints.append(
        JointSpec(
            name="root",
            type=JointType.FREE,
            axis=np.array([0.0, 0.0, 1.0]),
            pos=np.zeros(3),
            range=(0.0, 0.0),
            limited=False,
            armature=0.0,
            damping=0.0,
        )
    )
    root.geoms.append(_sphere("root", 0.09, (0, 0, 0.07), 6.0))
    root.sites.append(_site("joint_waist", (0, 0, 0.205)))
    # tracking cameras (back/side, mode="trackcom")
    root.cameras.append(CameraSpec(
        name="back", pos=np.array([-3.0, 0.0, 1.0]),
        xyaxes=np.array([0.0, -1.0, 0.0, 1.0, 0.0, 2.0]), mode="trackcom"))
    root.cameras.append(CameraSpec(
        name="side", pos=np.array([0.0, -3.0, 1.0]),
        xyaxes=np.array([1.0, 0.0, 0.0, 0.0, 1.0, 2.0]), mode="trackcom"))

    chest = spec.add_body("chest", "root", pos=(0, 0, 0.236151))
    chest.joints += _hinge3("chest", [(-1.2, 1.2)] * 3)
    chest.geoms.append(_sphere("chest", 0.11, (0, 0, 0.12), 14.0))

    neck = spec.add_body("neck", "chest", pos=(0, 0, 0.223894))
    neck.joints += _hinge3("neck", [(-1.0, 1.0)] * 3)
    neck.geoms.append(_sphere("neck", 0.1025, (0, 0, 0.175), 2.0))
    neck.sites.append(_site("joint_neck", (0, 0, 0.02)))

    for side, sgn in (("right", -1.0), ("left", 1.0)):
        sh = spec.add_body(f"{side}_shoulder", "chest", pos=(-0.02405, sgn * 0.18311, 0.2435))
        if side == "right":
            sh_ranges = [(-3.14, 0.5), (-3.14, 0.7), (-1.5, 1.5)]
        else:
            sh_ranges = [(-0.5, 3.14), (-3.14, 0.7), (-1.5, 1.5)]
        sh.joints += _hinge3(f"{side}_shoulder", sh_ranges)
        sh.geoms.append(_zcapsule(f"{side}_shoulder", 0.045, -0.05, -0.23, 1.5))
        sh.sites.append(_site(f"joint_{side}_shoulder", (0, 0, 0)))

        el = spec.add_body(f"{side}_elbow", f"{side}_shoulder", pos=(0, 0, -0.274788))
        el.joints.append(_hinge(f"{side}_elbow", (0, -1, 0), (0.0, 2.8)))
        el.geoms.append(_zcapsule(f"{side}_elbow", 0.04, -0.0525, -0.1875, 1.0))
        el.geoms.append(_sphere(f"{side}_wrist", 0.04, (0, 0, -0.258947), 0.5))
        el.sites.append(_site(f"joint_{side}_elbow", (0, 0, 0)))

    for side, sgn in (("right", -1.0), ("left", 1.0)):
        hip = spec.add_body(f"{side}_hip", "root", pos=(0, sgn * 0.084887, 0))
        hip.joints += _hinge3(f"{side}_hip", [(-1.2, 1.2), (-2.57, 1.57), (-1.0, 1.0)])
        hip.geoms.append(_zcapsule(f"{side}_hip", 0.055, -0.06, -0.36, 4.5))
        hip.sites.append(_site(f"joint_{side}_hip", (0, 0, 0)))

        knee = spec.add_body(f"{side}_knee", f"{side}_hip", pos=(0, 0, -0.421546))
        knee.joints.append(_hinge(f"{side}_knee", (0, -1, 0), (-2.7, 0.0)))
        knee.geoms.append(_zcapsule(f"{side}_knee", 0.05, -0.045, -0.355, 3.0))
        knee.sites.append(_site(f"joint_{side}_knee", (0, 0, 0)))

        ank = spec.add_body(f"{side}_ankle", f"{side}_knee", pos=(0, 0, -0.40987))
        ank.joints += _hinge3(f"{side}_ankle", [(-1.0, 1.0), (-1.0, 1.57), (-1.0, 1.0)])
        ank.geoms.append(_box(f"{side}_ankle", (0.0885, 0.045, 0.0275), (0.045, 0, -0.0225), 1.0))
        ank.sites.append(_site(f"joint_{side}_ankle", (0, 0, 0)))

    # Contact exclusions: reference/models/final_humanoid.xml:116-125.
    spec.exclude_pairs = [
        ("right_hip", "root"),
        ("left_hip", "root"),
        ("right_hip", "right_knee"),
        ("left_hip", "left_knee"),
        ("right_knee", "right_ankle"),
        ("left_knee", "left_ankle"),
        ("right_elbow", "right_shoulder"),
        ("left_elbow", "left_shoulder"),
    ]

    # Torque motors, one per hinge, gears from reference XML :127-162.
    gears = {
        "chest": 200, "neck": 50, "shoulder": 100, "elbow": 60,
        "hip": 200, "knee": 150, "ankle": 90,
    }
    for bi, body in enumerate(spec.bodies):
        for j in body.joints:
            if j.type != JointType.HINGE:
                continue
            stem = j.name.replace("right_", "").replace("left_", "").split("_")[0]
            spec.actuators.append(
                ActuatorSpec(name=j.name, joint=j.name, gear=float(gears[stem]), ctrlrange=(-0.5, 0.5))
            )
    return spec


def sphere_scene_spec(gravity: bool = True, floor: bool = True) -> ModelSpec:
    """Single 5 kg free sphere (r=0.1) above a plane: forward-dynamics sanity scene."""
    spec = ModelSpec(name="sphere_scene", timestep=0.002)
    if not gravity:
        spec.gravity = np.zeros(3)
    if floor:
        spec.world_geoms.append(
            GeomSpec(
                name="floor",
                type=GeomType.PLANE,
                size=np.array([50.0, 50.0, 0.2]),
                pos=np.zeros(3),
                quat=np.asarray(_ID_QUAT),
                mass=0.0,
                friction=1.0,
                margin=1e-3,
            )
        )
    body = spec.add_body("new_sphere", None, pos=(0, -1.2, 1.4))
    body.joints.append(
        JointSpec(
            name="new_sphere",
            type=JointType.FREE,
            axis=np.array([0.0, 0.0, 1.0]),
            pos=np.zeros(3),
            range=(0.0, 0.0),
            limited=False,
        )
    )
    body.geoms.append(_sphere("new_sphere_geom", 0.1, (0, 0, 0), 5.0))
    return spec


def humanoid_model(gravity: bool = True, floor: bool = True, dtype=np.float32):
    return humanoid_spec(gravity, floor).compile(dtype)


def sphere_model(gravity: bool = True, floor: bool = True, dtype=np.float32):
    return sphere_scene_spec(gravity, floor).compile(dtype)

"""MJCF-subset loader and exporter (counterpart of ``pbrl_tpu/model/mjcf.py``).

``load_spec`` / ``load_model`` parse the MJCF features the reference's
models use (``final_humanoid.xml``, ``sphere_model.xml``): nested bodies,
free/hinge/slide joints, sphere/capsule/box/plane geoms (``fromto``
included), per-geom masses with inertia synthesised from the geoms, one
``<default>`` class for joints/geoms/motors, ``<contact><exclude>`` pairs,
``<motor>`` actuators, sites and cameras, into the port's
:class:`~pbrl_tpu_torch.model.spec.ModelSpec`.

``to_mjcf`` emits MJCF from a :class:`ModelSpec`, so that a scene built in
code can be rendered by host MuJoCo (:mod:`pbrl_tpu_torch.viz.render`) or
held against CPU MuJoCo in tests. numpy and ElementTree only, as in
pbrl_tpu, whose output this reproduces string for string.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from pbrl_tpu_torch.model.spec import (
    ActuatorSpec,
    CameraSpec,
    GeomSpec,
    GeomType,
    JointSpec,
    JointType,
    ModelSpec,
    SiteSpec,
)

_GEOM_TYPES = {"plane": GeomType.PLANE, "sphere": GeomType.SPHERE,
               "capsule": GeomType.CAPSULE, "box": GeomType.BOX}
_GEOM_NAMES = {v: k for k, v in _GEOM_TYPES.items()}
_JOINT_TYPES = {"free": JointType.FREE, "hinge": JointType.HINGE, "slide": JointType.SLIDE}
_JOINT_NAMES = {v: k for k, v in _JOINT_TYPES.items()}


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()])


def _bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1")


def _quat_from_euler_xyz(e: np.ndarray) -> np.ndarray:
    """x-y-z euler angles to a wxyz quaternion, as pbrl_tpu converts them."""
    def axis_quat(axis, a):
        q = np.zeros(4)
        q[0] = math.cos(a / 2)
        q[1 + axis] = math.sin(a / 2)
        return q

    def qmul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    # as pbrl_tpu (after mju_euler2Quat): the axis rotations multiplied in order
    q = np.array([1.0, 0, 0, 0])
    for i, a in enumerate(e):
        q = qmul(q, axis_quat(i, a))
    return q


class _Defaults:
    def __init__(self):
        self.joint = {}
        self.geom = {}
        self.motor = {}


def load_spec(xml: str, *, path: bool = False) -> ModelSpec:
    """Parse an MJCF string (or file if ``path=True``) into a ModelSpec."""
    root = ET.parse(xml).getroot() if path else ET.fromstring(xml)
    if root.tag != "mujoco":
        raise ValueError("not an MJCF document")
    spec = ModelSpec(name=root.get("model", "model"))

    degree = True  # MJCF default angle unit
    comp = root.find("compiler")
    if comp is not None:
        degree = comp.get("angle", "degree") == "degree"
    ang = (lambda x: x * math.pi / 180.0) if degree else (lambda x: x)

    opt = root.find("option")
    if opt is not None:
        if opt.get("gravity"):
            spec.gravity = _floats(opt.get("gravity"))
        if opt.get("timestep"):
            spec.timestep = float(opt.get("timestep"))

    dfl = _Defaults()
    d = root.find("default")
    if d is not None:
        for tag, store in (("joint", dfl.joint), ("geom", dfl.geom), ("motor", dfl.motor)):
            el = d.find(tag)
            if el is not None:
                store.update(el.attrib)

    def parse_joint(el, order) -> JointSpec:
        a = dict(dfl.joint)
        a.update(el.attrib)
        jtype = _JOINT_TYPES[a.get("type", "hinge")]
        limited = _bool(a.get("limited", "false")) and a.get("range") is not None
        rng = _floats(a["range"]) if a.get("range") else np.zeros(2)
        if jtype != JointType.SLIDE:
            rng = np.array([ang(rng[0]), ang(rng[1])])
        free = jtype == JointType.FREE
        return JointSpec(
            name=a.get("name", f"joint{order}"),
            type=jtype,
            axis=_floats(a.get("axis", "0 0 1")),
            pos=_floats(a.get("pos", "0 0 0")),
            range=(float(rng[0]), float(rng[1])),
            limited=limited and not free,
            armature=0.0 if free else float(a.get("armature", 0.0)),
            damping=0.0 if free else float(a.get("damping", 0.0)),
            stiffness=float(a.get("stiffness", 0.0)),
        )

    def parse_geom(el, order) -> GeomSpec:
        a = dict(dfl.geom)
        a.update(el.attrib)
        gtype = _GEOM_TYPES[a.get("type", "sphere")]
        size = np.zeros(3)
        sz = _floats(a["size"]) if a.get("size") else np.zeros(0)
        size[: len(sz)] = sz[:3]
        pos = _floats(a.get("pos", "0 0 0"))
        quat = _floats(a.get("quat", "1 0 0 0"))
        if a.get("euler"):
            quat = _quat_from_euler_xyz(np.array([ang(x) for x in _floats(a["euler"])]))
        if a.get("fromto"):
            ft = _floats(a["fromto"])
            p0, p1 = ft[:3], ft[3:]
            pos = 0.5 * (p0 + p1)
            d = p1 - p0
            hh = 0.5 * np.linalg.norm(d)
            size[1] = hh
            z = d / max(np.linalg.norm(d), 1e-12)
            # quat rotating +z onto the segment direction
            c = np.clip(z[2], -1.0, 1.0)
            if c > 1 - 1e-10:
                quat = np.array([1.0, 0, 0, 0])
            elif c < -1 + 1e-10:
                quat = np.array([0.0, 1.0, 0, 0])
            else:
                axis = np.cross([0, 0, 1.0], z)
                axis /= np.linalg.norm(axis)
                half = math.acos(c) / 2
                quat = np.concatenate([[math.cos(half)], axis * math.sin(half)])
        friction = _floats(a["friction"])[0] if a.get("friction") else 1.0
        return GeomSpec(
            name=a.get("name", f"geom{order}"),
            type=gtype,
            size=size,
            pos=pos,
            quat=quat,
            mass=float(a.get("mass", 0.0)),
            friction=friction,
            contype=int(a.get("contype", 1)),
            conaffinity=int(a.get("conaffinity", 1)),
            margin=float(a.get("margin", 0.0)),
        )

    counter = [0]

    def parse_body(el, parent_name: Optional[str]):
        name = el.get("name", f"body{counter[0]}")
        counter[0] += 1
        pos = _floats(el.get("pos", "0 0 0"))
        quat = _floats(el.get("quat", "1 0 0 0"))
        if el.get("euler"):
            quat = _quat_from_euler_xyz(np.array([ang(x) for x in _floats(el.get("euler"))]))
        body = spec.add_body(name, parent_name, pos=pos, quat=quat)
        for child in el:
            if child.tag == "joint":
                body.joints.append(parse_joint(child, counter[0]))
                counter[0] += 1
            elif child.tag == "freejoint":
                # MJCF shorthand for <joint type="free"> (name passthrough)
                child.set("type", "free")
                body.joints.append(parse_joint(child, counter[0]))
                counter[0] += 1
            elif child.tag == "geom":
                body.geoms.append(parse_geom(child, counter[0]))
                counter[0] += 1
            elif child.tag == "site":
                q = _floats(child.get("quat", "1 0 0 0"))
                if child.get("euler"):
                    q = _quat_from_euler_xyz(
                        np.array([ang(x) for x in _floats(child.get("euler"))]))
                body.sites.append(
                    SiteSpec(name=child.get("name", f"site{counter[0]}"),
                             pos=_floats(child.get("pos", "0 0 0")), quat=q)
                )
                counter[0] += 1
            elif child.tag == "camera":
                xy = (_floats(child.get("xyaxes"))
                      if child.get("xyaxes") else None)
                body.cameras.append(
                    CameraSpec(name=child.get("name", f"camera{counter[0]}"),
                               pos=_floats(child.get("pos", "0 0 0")),
                               xyaxes=xy,
                               mode=child.get("mode", "fixed"))
                )
                counter[0] += 1
            elif child.tag == "body":
                parse_body(child, name)

    wb = root.find("worldbody")
    if wb is not None:
        for child in wb:
            if child.tag == "geom":
                spec.world_geoms.append(parse_geom(child, counter[0]))
                counter[0] += 1
            elif child.tag == "body":
                parse_body(child, None)

    contact = root.find("contact")
    if contact is not None:
        for ex in contact.findall("exclude"):
            spec.exclude_pairs.append((ex.get("body1"), ex.get("body2")))

    act = root.find("actuator")
    if act is not None:
        for m in act.findall("motor"):
            a = dict(dfl.motor)
            a.update(m.attrib)
            limited = _bool(a.get("ctrllimited", "false")) and a.get("ctrlrange") is not None
            cr = _floats(a["ctrlrange"]) if a.get("ctrlrange") else np.zeros(2)
            spec.actuators.append(
                ActuatorSpec(
                    name=a.get("name", a["joint"]),
                    joint=a["joint"],
                    gear=float(_floats(a.get("gear", "1"))[0]),
                    ctrlrange=(float(cr[0]), float(cr[1])),
                    ctrllimited=limited,
                )
            )
    return spec


def load_model(xml: str, *, path: bool = False, dtype=np.float32):
    """The compiled :class:`~pbrl_tpu_torch.model.spec.Model` of an MJCF
    string (or file if ``path=True``)."""
    return load_spec(xml, path=path).compile(dtype)


# ---------------------------------------------------------------------------
# Exporter
# ---------------------------------------------------------------------------


def _fmt(v) -> str:
    arr = np.atleast_1d(np.asarray(v, np.float64))
    return " ".join(f"{x:.10g}" for x in arr)


def to_mjcf(spec: ModelSpec) -> str:
    """Emit an MJCF document equivalent to ``spec`` (for rendering/oracles)."""
    root = ET.Element("mujoco", model=spec.name)
    ET.SubElement(root, "compiler", angle="radian", inertiafromgeom="true")
    ET.SubElement(root, "option", gravity=_fmt(spec.gravity), timestep=f"{spec.timestep:.10g}")
    wb = ET.SubElement(root, "worldbody")

    def emit_geom(parent, g: GeomSpec):
        attrs = dict(
            name=g.name, type=_GEOM_NAMES[g.type], pos=_fmt(g.pos),
            quat=_fmt(g.quat), contype=str(g.contype), conaffinity=str(g.conaffinity),
            friction=f"{g.friction:.10g} 0.005 0.0001", margin=f"{g.margin:.10g}", condim="3",
        )
        if g.type == GeomType.SPHERE:
            attrs["size"] = _fmt(g.size[:1])
        elif g.type == GeomType.CAPSULE:
            attrs["size"] = _fmt(g.size[:2])
        elif g.type == GeomType.BOX:
            attrs["size"] = _fmt(g.size[:3])
        else:
            attrs["size"] = _fmt(spec_size_for_plane(g))
        if g.type != GeomType.PLANE:
            attrs["mass"] = f"{g.mass:.10g}"
        ET.SubElement(parent, "geom", **attrs)

    def spec_size_for_plane(g):
        s = np.where(np.asarray(g.size) <= 0, 1.0, g.size)
        return s

    def emit_body(parent_el, bi: int):
        b = spec.bodies[bi]
        el = ET.SubElement(parent_el, "body", name=b.name, pos=_fmt(b.pos), quat=_fmt(b.quat))
        for j in b.joints:
            attrs = dict(name=j.name, type=_JOINT_NAMES[j.type], pos=_fmt(j.pos))
            if j.type != JointType.FREE:
                attrs.update(
                    axis=_fmt(j.axis),
                    limited="true" if j.limited else "false",
                    armature=f"{j.armature:.10g}",
                    damping=f"{j.damping:.10g}",
                    stiffness=f"{j.stiffness:.10g}",
                )
                if j.limited:
                    attrs["range"] = _fmt(np.asarray(j.range))
            else:
                attrs.update(limited="false", armature="0", damping="0", stiffness="0")
            ET.SubElement(el, "joint", **attrs)
        for g in b.geoms:
            emit_geom(el, g)
        for s in b.sites:
            ET.SubElement(el, "site", name=s.name, pos=_fmt(s.pos), quat=_fmt(s.quat), size="0.01")
        for c in b.cameras:
            attrs = dict(name=c.name, pos=_fmt(c.pos), mode=c.mode)
            if c.xyaxes is not None:
                attrs["xyaxes"] = _fmt(c.xyaxes)
            ET.SubElement(el, "camera", **attrs)
        for ci, cb in enumerate(spec.bodies):
            if cb.parent == bi:
                emit_body(el, ci)

    for g in spec.world_geoms:
        emit_geom(wb, g)
    for bi, b in enumerate(spec.bodies):
        if b.parent == -1:
            emit_body(wb, bi)

    if spec.exclude_pairs:
        contact = ET.SubElement(root, "contact")
        for b1, b2 in spec.exclude_pairs:
            ET.SubElement(contact, "exclude", body1=b1, body2=b2)

    if spec.actuators:
        act = ET.SubElement(root, "actuator")
        for a in spec.actuators:
            ET.SubElement(
                act, "motor", name=a.name, joint=a.joint, gear=f"{a.gear:.10g}",
                ctrllimited="true" if a.ctrllimited else "false",
                ctrlrange=_fmt(np.asarray(a.ctrlrange)),
            )
    ET.indent(root)
    return ET.tostring(root, encoding="unicode")

"""Model specification and compiler: host-side builder -> static ``Model``.

Counterpart of ``pbrl_tpu/model/spec.py``. The compile step is host numpy
there as here, so the compiled arrays are identical; the port keeps them as
float32 numpy arrays (the physics wrapper packs them into kernel tables and
the env moves what it needs to its device).

Semantics as in the reference: multiple joints per body compose
sequentially, geom-mass inertia synthesis, free-joint qpos/qvel layout
(3 pos + wxyz quat / 3 world linvel + 3 body angvel), actuator
``gear * clip(ctrl, ctrlrange)`` torque motors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


class JointType:
    FREE = 0
    HINGE = 1
    SLIDE = 2


class GeomType:
    PLANE = 0
    SPHERE = 1
    CAPSULE = 2
    BOX = 3


# ---------------------------------------------------------------------------
# Host-side spec (mutable, numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeomSpec:
    name: str
    type: int
    size: np.ndarray          # (3,) sphere (r,-,-), capsule (r,hh,-), box half-extents
    pos: np.ndarray           # (3,) in body frame
    quat: np.ndarray          # (4,) wxyz in body frame
    mass: float
    friction: float = 1.0
    contype: int = 1
    conaffinity: int = 1
    margin: float = 0.0


@dataclasses.dataclass
class JointSpec:
    name: str
    type: int
    axis: np.ndarray          # (3,) in body frame (hinges/slides)
    pos: np.ndarray           # (3,) anchor in body frame
    range: Tuple[float, float]
    limited: bool
    armature: float = 0.0
    damping: float = 0.0
    stiffness: float = 0.0
    ref: float = 0.0


@dataclasses.dataclass
class SiteSpec:
    name: str
    pos: np.ndarray
    quat: np.ndarray


@dataclasses.dataclass
class CameraSpec:
    """Rendering camera (host-side only; never enters the compiled Model)."""

    name: str
    pos: np.ndarray
    xyaxes: Optional[np.ndarray] = None
    mode: str = "fixed"


@dataclasses.dataclass
class BodySpec:
    name: str
    parent: int               # index into ModelSpec.bodies, -1 = world
    pos: np.ndarray
    quat: np.ndarray
    joints: List[JointSpec] = dataclasses.field(default_factory=list)
    geoms: List[GeomSpec] = dataclasses.field(default_factory=list)
    sites: List[SiteSpec] = dataclasses.field(default_factory=list)
    cameras: List[CameraSpec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ActuatorSpec:
    name: str
    joint: str
    gear: float
    ctrlrange: Tuple[float, float]
    ctrllimited: bool = True


@dataclasses.dataclass
class ModelSpec:
    """Mutable model description. ``compile()`` produces the static Model."""

    name: str = "model"
    gravity: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, -9.81]))
    timestep: float = 0.002
    bodies: List[BodySpec] = dataclasses.field(default_factory=list)
    world_geoms: List[GeomSpec] = dataclasses.field(default_factory=list)
    actuators: List[ActuatorSpec] = dataclasses.field(default_factory=list)
    exclude_pairs: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    filter_parent: bool = True

    def add_body(self, name: str, parent: Optional[str], pos=(0, 0, 0), quat=(1, 0, 0, 0)) -> BodySpec:
        pidx = -1 if parent is None else self.body_index(parent)
        body = BodySpec(name=name, parent=pidx, pos=np.asarray(pos, np.float64),
                        quat=np.asarray(quat, np.float64))
        self.bodies.append(body)
        return body

    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(f"no body named {name!r}")

    def compile(self, dtype=np.float32) -> "Model":
        return _compile(self, dtype)


# ---------------------------------------------------------------------------
# Compiled, immutable Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Option:
    gravity: np.ndarray
    timestep: np.ndarray
    contact_timeconst: np.ndarray
    contact_dampratio: np.ndarray
    contact_impratio: np.ndarray
    limit_timeconst: np.ndarray
    limit_dampratio: np.ndarray
    solver_iterations: int = 20
    solver: str = "pgd"
    # Self-contact effective mass: 'step' (exact, solved at policy-step
    # entry and held), 'substep' (exact every substep) or 'static'.
    self_contact_mass: str = "step"

    def replace(self, **kw) -> "Option":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Model:
    """Static compiled model; bodies are topologically ordered and
    ``body_parent == -1`` denotes attachment to the world."""

    nbody: int
    njnt: int
    nq: int
    nv: int
    nu: int
    ngeom: int
    nsite: int
    npair: int
    nplanepair: int
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    geom_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    actuator_names: Tuple[str, ...]
    body_parent: Tuple[int, ...]
    jnt_type: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    body_pos: np.ndarray
    body_quat: np.ndarray
    body_mass: np.ndarray
    body_ipos: np.ndarray
    body_inertia: np.ndarray
    jnt_axis: np.ndarray
    jnt_pos: np.ndarray
    jnt_range: np.ndarray
    jnt_limited: Tuple[bool, ...]
    dof_bodyid: Tuple[int, ...]
    dof_armature: np.ndarray
    dof_damping: np.ndarray
    ancestor_mask: np.ndarray
    geom_type: Tuple[int, ...]
    geom_bodyid: Tuple[int, ...]
    geom_pos: np.ndarray
    geom_quat: np.ndarray
    geom_size: np.ndarray
    geom_friction: np.ndarray
    geom_margin: np.ndarray
    site_bodyid: Tuple[int, ...]
    site_pos: np.ndarray
    site_quat: np.ndarray
    pair_geom1: Tuple[int, ...]
    pair_geom2: Tuple[int, ...]
    plane_geom: Tuple[int, ...]
    plane_other: Tuple[int, ...]
    actuator_gear: np.ndarray
    actuator_ctrlrange: np.ndarray
    actuator_dofadr: Tuple[int, ...]
    actuator_qposadr: Tuple[int, ...]
    qpos0: np.ndarray
    option: Option

    def replace(self, **kw) -> "Model":
        return dataclasses.replace(self, **kw)

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)

    def joint_id(self, name: str) -> int:
        return self.joint_names.index(name)

    def actuator_id(self, name: str) -> int:
        return self.actuator_names.index(name)

    def site_id(self, name: str) -> int:
        return self.site_names.index(name)

    def actuator_jntid(self) -> Tuple[int, ...]:
        """Joint driven by each actuator (matched by qpos address)."""
        qmap = {qa: j for j, qa in enumerate(self.jnt_qposadr)}
        return tuple(qmap[qa] for qa in self.actuator_qposadr)

    @property
    def dt(self):
        return self.option.timestep


# ---------------------------------------------------------------------------
# Geom inertia synthesis
# ---------------------------------------------------------------------------


def _geom_inertia(g: GeomSpec) -> np.ndarray:
    """Rotational inertia (3,3) of a geom about its own com, geom frame."""
    m = g.mass
    if g.type == GeomType.SPHERE:
        r = g.size[0]
        i = 0.4 * m * r * r
        return np.diag([i, i, i])
    if g.type == GeomType.CAPSULE:
        r, hh = g.size[0], g.size[1]
        vol_cyl = np.pi * r * r * 2 * hh
        vol_sph = 4.0 / 3.0 * np.pi * r ** 3
        rho = m / (vol_cyl + vol_sph)
        mc, ms = rho * vol_cyl, rho * vol_sph
        izz = mc * r * r / 2.0 + ms * 0.4 * r * r
        ixx = (
            mc * (r * r / 4.0 + hh * hh / 3.0)
            + ms * (0.4 * r * r + hh * hh + 0.75 * hh * r)
        )
        return np.diag([ixx, ixx, izz])
    if g.type == GeomType.BOX:
        a, b, c = g.size
        return np.diag(
            [m * (b * b + c * c) / 3.0, m * (a * a + c * c) / 3.0, m * (a * a + b * b) / 3.0]
        )
    if g.type == GeomType.PLANE:
        return np.zeros((3, 3))
    raise ValueError(f"unknown geom type {g.type}")


def _np_quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _body_inertial(body: BodySpec) -> Tuple[float, np.ndarray, np.ndarray]:
    """Aggregate geom masses into (mass, com, inertia-about-com) in body frame."""
    if not body.geoms:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = sum(g.mass for g in body.geoms)
    com = sum(g.mass * g.pos for g in body.geoms) / mass
    inertia = np.zeros((3, 3))
    for g in body.geoms:
        rot = _np_quat_to_mat(g.quat)
        ig = rot @ _geom_inertia(g) @ rot.T
        d = g.pos - com
        inertia += ig + g.mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return mass, com, inertia


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


_JOINT_NQ = {JointType.FREE: 7, JointType.HINGE: 1, JointType.SLIDE: 1}
_JOINT_NV = {JointType.FREE: 6, JointType.HINGE: 1, JointType.SLIDE: 1}


def _compile(spec: ModelSpec, dtype) -> Model:
    nb = len(spec.bodies)
    for i, b in enumerate(spec.bodies):
        if b.parent >= i:
            raise ValueError("bodies must be topologically ordered (parent before child)")

    jnt_specs: List[Tuple[int, JointSpec]] = []
    for bi, b in enumerate(spec.bodies):
        for j in b.joints:
            jnt_specs.append((bi, j))
    nq = nv = 0
    jnt_qposadr, jnt_dofadr = [], []
    for _, j in jnt_specs:
        jnt_qposadr.append(nq)
        jnt_dofadr.append(nv)
        nq += _JOINT_NQ[j.type]
        nv += _JOINT_NV[j.type]

    dof_bodyid = np.zeros(nv, np.int32)
    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    for (bi, j), da in zip(jnt_specs, jnt_dofadr):
        n = _JOINT_NV[j.type]
        dof_bodyid[da : da + n] = bi
        dof_armature[da : da + n] = j.armature
        dof_damping[da : da + n] = j.damping

    # dof d moves body b iff d's body is an ancestor-or-self of b
    anc = np.zeros((nb, nv), np.float64)
    for b in range(nb):
        chain = set()
        cur = b
        while cur != -1:
            chain.add(cur)
            cur = spec.bodies[cur].parent
        for d in range(nv):
            if int(dof_bodyid[d]) in chain:
                anc[b, d] = 1.0

    geoms: List[Tuple[int, GeomSpec]] = [(-1, g) for g in spec.world_geoms]
    for bi, b in enumerate(spec.bodies):
        for g in b.geoms:
            geoms.append((bi, g))
    ng = len(geoms)

    sites: List[Tuple[int, SiteSpec]] = []
    for bi, b in enumerate(spec.bodies):
        for s in b.sites:
            sites.append((bi, s))

    name_to_bi = {b.name: i for i, b in enumerate(spec.bodies)}
    excluded = set()
    for n1, n2 in spec.exclude_pairs:
        b1, b2 = name_to_bi[n1], name_to_bi[n2]
        excluded.add((min(b1, b2), max(b1, b2)))

    def _compatible(i, j):
        g1, g2 = geoms[i][1], geoms[j][1]
        return (g1.contype & g2.conaffinity) or (g2.contype & g1.conaffinity)

    pair1, pair2, plane_g, plane_o = [], [], [], []
    for i in range(ng):
        for j in range(i + 1, ng):
            bi, gi = geoms[i]
            bj, gj = geoms[j]
            if bi == bj:
                continue
            if not _compatible(i, j):
                continue
            if (min(bi, bj), max(bi, bj)) in excluded:
                continue
            if spec.filter_parent and bi != -1 and bj != -1:
                if spec.bodies[bi].parent == bj or spec.bodies[bj].parent == bi:
                    continue
            ti, tj = gi.type, gj.type
            if ti == GeomType.PLANE and tj == GeomType.PLANE:
                continue
            if ti == GeomType.PLANE:
                plane_g.append(i)
                plane_o.append(j)
            elif tj == GeomType.PLANE:
                plane_g.append(j)
                plane_o.append(i)
            elif ti <= tj:  # canonical order: sphere < capsule < box
                pair1.append(i)
                pair2.append(j)
            else:
                pair1.append(j)
                pair2.append(i)

    jnt_names = [j.name for _, j in jnt_specs]
    act_gear, act_cr, act_dof, act_qpos, act_names = [], [], [], [], []
    for a in spec.actuators:
        ji = jnt_names.index(a.joint)
        if _JOINT_NV[jnt_specs[ji][1].type] != 1:
            raise ValueError("motors only supported on single-dof joints")
        act_gear.append(a.gear)
        act_cr.append(a.ctrlrange if a.ctrllimited else (-np.inf, np.inf))
        act_dof.append(jnt_dofadr[ji])
        act_qpos.append(jnt_qposadr[ji])
        act_names.append(a.name)

    qpos0 = np.zeros(nq)
    for (bi, j), qa in zip(jnt_specs, jnt_qposadr):
        if j.type == JointType.FREE:
            qpos0[qa : qa + 3] = spec.bodies[bi].pos
            qpos0[qa + 3] = 1.0
        else:
            qpos0[qa] = j.ref

    masses, ipos, inertias = [], [], []
    for b in spec.bodies:
        m, c, ine = _body_inertial(b)
        masses.append(m)
        ipos.append(c)
        inertias.append(ine)

    f = lambda x: np.asarray(np.asarray(x), dtype)

    option = Option(
        gravity=f(spec.gravity),
        timestep=f(spec.timestep),
        contact_timeconst=f(0.02),
        contact_dampratio=f(1.0),
        contact_impratio=f(1.0),
        limit_timeconst=f(0.02),
        limit_dampratio=f(1.0),
    )

    return Model(
        nbody=nb,
        njnt=len(jnt_specs),
        nq=nq,
        nv=nv,
        nu=len(spec.actuators),
        ngeom=ng,
        nsite=len(sites),
        npair=len(pair1),
        nplanepair=len(plane_g),
        body_names=tuple(b.name for b in spec.bodies),
        joint_names=tuple(jnt_names),
        geom_names=tuple(g.name for _, g in geoms),
        site_names=tuple(s.name for _, s in sites),
        actuator_names=tuple(act_names),
        body_parent=tuple(int(b.parent) for b in spec.bodies),
        jnt_type=tuple(int(j.type) for _, j in jnt_specs),
        jnt_bodyid=tuple(int(bi) for bi, _ in jnt_specs),
        jnt_qposadr=tuple(int(x) for x in jnt_qposadr),
        jnt_dofadr=tuple(int(x) for x in jnt_dofadr),
        body_pos=f([b.pos for b in spec.bodies]).reshape(nb, 3),
        body_quat=f([b.quat for b in spec.bodies]).reshape(nb, 4),
        body_mass=f(masses),
        body_ipos=f(ipos).reshape(nb, 3),
        body_inertia=f(inertias).reshape(nb, 3, 3),
        jnt_axis=f([j.axis for _, j in jnt_specs]).reshape(-1, 3),
        jnt_pos=f([j.pos for _, j in jnt_specs]).reshape(-1, 3),
        jnt_range=f([j.range for _, j in jnt_specs]).reshape(-1, 2),
        jnt_limited=tuple(bool(j.limited) for _, j in jnt_specs),
        dof_bodyid=tuple(int(x) for x in dof_bodyid),
        dof_armature=f(dof_armature),
        dof_damping=f(dof_damping),
        ancestor_mask=f(anc),
        geom_type=tuple(int(g.type) for _, g in geoms),
        geom_bodyid=tuple(int(bi) for bi, _ in geoms),
        geom_pos=f([g.pos for _, g in geoms]).reshape(ng, 3),
        geom_quat=f([g.quat for _, g in geoms]).reshape(ng, 4),
        geom_size=f([g.size for _, g in geoms]).reshape(ng, 3),
        geom_friction=f([g.friction for _, g in geoms]),
        geom_margin=f([g.margin for _, g in geoms]),
        site_bodyid=tuple(int(bi) for bi, _ in sites),
        site_pos=f([s.pos for _, s in sites]).reshape(-1, 3),
        site_quat=f([s.quat for _, s in sites]).reshape(-1, 4),
        pair_geom1=tuple(pair1),
        pair_geom2=tuple(pair2),
        plane_geom=tuple(plane_g),
        plane_other=tuple(plane_o),
        actuator_gear=f(act_gear),
        actuator_ctrlrange=f(np.asarray(act_cr).reshape(-1, 2) if act_cr else np.zeros((0, 2))),
        actuator_dofadr=tuple(int(x) for x in act_dof),
        actuator_qposadr=tuple(int(x) for x in act_qpos),
        qpos0=f(qpos0),
        option=option,
    )

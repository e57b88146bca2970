"""Field-form physics in plain PyTorch: the kernel's plain version.

Counterpart of ``pbrl_tpu/ops/field_physics.py``. Every per-env scalar
quantity is a "field": one ``(B,)`` tensor. Vectors and quaternions are
Python tuples of fields, the model structure is baked in from the static
``Model`` metadata (``build_spec``), and the sparsity-exploiting
algorithms (composite rigid body with subtree sums, ancestor-pair mass
matrix, leaves-first tree Cholesky, streamed contact-to-body force
accumulation) are written out per scalar.

This module is the plain version of the CUDA policy-step kernel
(``csrc/mimic_step.cu``): the CPU path of the env runs it, and the tests
and ``chip_smoke.py`` hold the kernel against it. It issues one small
tensor op per scalar operation, so on the GPU it costs seconds per policy
step whatever the batch: it is a reference, not a fast path.

``pack_spec`` flattens a ``SubstepSpec`` into the int32/float32 table the
kernel reads; its layout is the ``MODEL_FIELDS`` list of the CUDA source,
which ``table_layout`` reads.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from benchmark.reference.spec import GeomType, JointType, Model

# =========================================================================
# Field math: vec3 / quat as tuples of same-shaped arrays
# =========================================================================

Vec3 = Tuple  # (x, y, z)
Quat = Tuple  # (w, x, y, z)
Spatial = Tuple  # (wx, wy, wz, vx, vy, vz) about the origin


# ---- structural-constant folding -------------------------------------------
#
# Components of field vectors/quats may be plain Python floats: STRUCTURAL
# constants known from the model alone (a free joint's translation axis, a
# zero lever arm, an identity quaternion, a world-plane normal). The
# primitives below fold arithmetic on them in Python, so a 0.0 component
# costs no tensor op downstream. Values equal the unfolded program up to
# float32 rounding of constant subexpressions (folded in f64, then cast on
# first contact with a tensor field). The CUDA kernel computes the same
# constants at run time in f32, so the two differ by rounding only.
#
# Finite-values assumption: ``fsub(a, a) -> 0.0`` and ``fmul(0.0, x) ->
# 0.0`` zero a NaN/Inf lane. State sanitization lives one level up (the
# env's NaN quarantine, envs/vec.py), so the program treats its inputs as
# finite.


def _isc(x) -> bool:
    """Is x a structural constant (a Python number, not a tensor)?"""
    return isinstance(x, (int, float))


def _max(a, c):
    """jnp.maximum(a, c) for a tensor or a structural constant a."""
    return max(a, c) if _isc(a) else torch.clamp(a, min=c)


def _min(a, c):
    return min(a, c) if _isc(a) else torch.clamp(a, max=c)


def _sqrt(a):
    import math

    return math.sqrt(a) if _isc(a) else torch.sqrt(a)


def _rsqrt(a):
    import math

    return 1.0 / math.sqrt(a) if _isc(a) else torch.rsqrt(a)


def fneg(a):
    return -a


def fadd(a, b):
    if _isc(a) and a == 0.0:
        return b
    if _isc(b) and b == 0.0:
        return a
    return a + b


def fsub(a, b):
    if a is b:  # identical tensor: structurally zero
        return 0.0
    if _isc(b) and b == 0.0:
        return a
    if _isc(a) and a == 0.0:
        return -b
    return a - b


def fmul(a, b):
    if _isc(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return -b
    if _isc(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return -a
    return a * b


def fsqrt(a):
    import math

    return math.sqrt(a) if _isc(a) else torch.sqrt(a)


def fdiv(a, b):
    if _isc(b):
        if _isc(a):
            return a / b
        return fmul(a, 1.0 / b)  # constant reciprocal: a mul instead of a div
    return a / b


def _ensure_field(x, like):
    """Materialize a structural constant as a field row when one escapes to
    a consumer that needs a tensor (program outputs, torch.stack)."""
    return torch.full_like(like, float(x)) if _isc(x) else x


def v3(x, y, z):
    return (x, y, z)


def v3_const(vals, like=None):
    """Structural-constant vec3 (``like`` kept for call-site compat)."""
    return tuple(float(v) for v in vals)


def v3_zero(like=None):
    return (0.0, 0.0, 0.0)


def v3_add(a, b):
    return (fadd(a[0], b[0]), fadd(a[1], b[1]), fadd(a[2], b[2]))


def v3_sub(a, b):
    return (fsub(a[0], b[0]), fsub(a[1], b[1]), fsub(a[2], b[2]))


def v3_scale(a, s):
    return (fmul(a[0], s), fmul(a[1], s), fmul(a[2], s))


def v3_dot(a, b):
    return fadd(fadd(fmul(a[0], b[0]), fmul(a[1], b[1])), fmul(a[2], b[2]))


def v3_cross(a, b):
    return (
        fsub(fmul(a[1], b[2]), fmul(a[2], b[1])),
        fsub(fmul(a[2], b[0]), fmul(a[0], b[2])),
        fsub(fmul(a[0], b[1]), fmul(a[1], b[0])),
    )


def v3_norm(a, eps=1e-12):
    return _sqrt(_max(v3_dot(a, a), eps))


def q_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (
        fsub(fsub(fsub(fmul(w1, w2), fmul(x1, x2)), fmul(y1, y2)), fmul(z1, z2)),
        fsub(fadd(fadd(fmul(w1, x2), fmul(x1, w2)), fmul(y1, z2)), fmul(z1, y2)),
        fadd(fadd(fsub(fmul(w1, y2), fmul(x1, z2)), fmul(y1, w2)), fmul(z1, x2)),
        fadd(fsub(fadd(fmul(w1, z2), fmul(x1, y2)), fmul(y1, x2)), fmul(z1, w2)),
    )


def q_normalize(q):
    nsq = fadd(fadd(fadd(fmul(q[0], q[0]), fmul(q[1], q[1])),
                    fmul(q[2], q[2])), fmul(q[3], q[3]))
    if _isc(nsq):
        import math

        n = 1.0 / math.sqrt(max(nsq, 1e-12))
    else:
        n = _rsqrt(_max(nsq, 1e-12))
    return (fmul(q[0], n), fmul(q[1], n), fmul(q[2], n), fmul(q[3], n))


def q_rotate(q, v):
    """R(q) v via the 15-mul form (u = q_vec): v + 2(w (u x v) + u x (u x v))."""
    w = q[0]
    u = (q[1], q[2], q[3])
    uv = v3_cross(u, v)
    uuv = v3_cross(u, uv)
    return (
        fadd(v[0], fmul(2.0, fadd(fmul(w, uv[0]), uuv[0]))),
        fadd(v[1], fmul(2.0, fadd(fmul(w, uv[1]), uuv[1]))),
        fadd(v[2], fmul(2.0, fadd(fmul(w, uv[2]), uuv[2]))),
    )


def q_rotate_inv(q, v):
    return q_rotate((q[0], -q[1], -q[2], -q[3]), v)


def q_axis_angle(axis_const, angle):
    """Quat from a STATIC unit axis (python floats) and an angle field."""
    half = 0.5 * angle
    c, s = torch.cos(half), torch.sin(half)
    ax, ay, az = (float(a) for a in axis_const)
    return (c, s * ax, s * ay, s * az)


def q_exp_omega(omega, dt):
    """exp map of omega*dt (field vec3), stable at small angles."""
    a2 = v3_dot(omega, omega) * (dt * dt)
    angle = _sqrt(_max(a2, 1e-24))
    half = 0.5 * angle
    small = a2 < 1e-14
    k = torch.where(small, 0.5 * dt - a2 * dt / 48.0, torch.sin(half) / angle * dt)
    return (torch.cos(half), omega[0] * k, omega[1] * k, omega[2] * k)


def q_to_mat(q):
    """Rows of R(q) as three vec3 fields."""
    w, x, y, z = q
    xx, yy, zz = fmul(x, x), fmul(y, y), fmul(z, z)
    xy, xz, yz = fmul(x, y), fmul(x, z), fmul(y, z)
    wx, wy, wz = fmul(w, x), fmul(w, y), fmul(w, z)
    r0 = (fsub(1.0, fmul(2.0, fadd(yy, zz))), fmul(2.0, fsub(xy, wz)),
          fmul(2.0, fadd(xz, wy)))
    r1 = (fmul(2.0, fadd(xy, wz)), fsub(1.0, fmul(2.0, fadd(xx, zz))),
          fmul(2.0, fsub(yz, wx)))
    r2 = (fmul(2.0, fsub(xz, wy)), fmul(2.0, fadd(yz, wx)),
          fsub(1.0, fmul(2.0, fadd(xx, yy))))
    return r0, r1, r2


def sp_motion_cross(v, m):
    """Spatial motion cross product v x m (both 6-field tuples)."""
    w, vl = v[:3], v[3:]
    mw, ml = m[:3], m[3:]
    a = v3_cross(w, mw)
    b = v3_add(v3_cross(w, ml), v3_cross(vl, mw))
    return a + b


def sp_dot(a, b):
    acc = 0.0
    for k in range(6):
        acc = fadd(acc, fmul(a[k], b[k]))
    return acc


# =========================================================================
# Structured spatial inertia: 10 parameters (A sym 3x3, h = m*c, m)
#   I_spatial = [[A, skew(h)], [skew(h)^T, m E]],  A about the origin.
# =========================================================================


def inertia_mul(A, h, m, s):
    """I @ s for motion s = (w, v): returns force (A w + h x v, m v - h x w)."""
    w, v = s[:3], s[3:]
    Aw = (
        fadd(fadd(fmul(A[0][0], w[0]), fmul(A[0][1], w[1])), fmul(A[0][2], w[2])),
        fadd(fadd(fmul(A[0][1], w[0]), fmul(A[1][1], w[1])), fmul(A[1][2], w[2])),
        fadd(fadd(fmul(A[0][2], w[0]), fmul(A[1][2], w[1])), fmul(A[2][2], w[2])),
    )
    top = v3_add(Aw, v3_cross(h, v))
    bot = v3_sub(v3_scale(v, m), v3_cross(h, w))
    return top + bot


# =========================================================================
# Static model extraction
# =========================================================================


@dataclasses.dataclass
class _JointMeta:
    jtype: int
    qadr: int
    dadr: int
    axis: Tuple[float, float, float]
    pos: Tuple[float, float, float]


@dataclasses.dataclass
class _BodyMeta:
    parent: int
    pos: Tuple[float, float, float]
    quat: Tuple[float, float, float, float]
    joints: List[_JointMeta]
    mass: float
    ipos: Tuple[float, float, float]
    inertia: Tuple[Tuple[float, ...], ...]  # 3x3 about com, body frame


@dataclasses.dataclass
class _ContactSlot:
    kind: str          # 'plane_sphere' | 'plane_capend' | 'plane_corner' |
                       # 'sphere_sphere' | 'sphere_capsule' | 'sphere_box' |
                       # 'capsule_capsule' | 'capsule_box' |
                       # 'boxcorner_box' | 'box_boxcorner' (one corner each)
    g1: int
    g2: int
    body1: int         # -1 = world
    body2: int
    friction: float
    m_eff: float       # static harmonic-mean effective mass (self-contact
                       # surrogate; ground slots use the live Delassus mass)
    extra: tuple = ()  # kind-specific static params (e.g. cap end, corner signs)
    fall: bool = False # counts as a fall contact when active


@dataclasses.dataclass
class SubstepSpec:
    """Everything static the field program needs (no tensors)."""

    nq: int
    nv: int
    nu: int
    nbody: int
    dt: float
    gravity: Tuple[float, float, float]
    bodies: List[_BodyMeta]
    dof_damping: List[float]
    dof_armature: List[float]
    # actuated dofs
    act_dof: List[int]
    act_qadr: List[int]
    kp: List[float]
    kd: List[float]
    tau_lo: List[float]
    tau_hi: List[float]
    # joint limits: (qadr, dadr, lo, hi)
    limits: List[Tuple[int, int, float, float]]
    # mass-matrix ancestor pairs (i, j) with j <= i, both on one path
    m_pairs: List[Tuple[int, int]]
    # dof -> body
    dof_body: List[int]
    # per-body dof list (in order)
    body_dofs: List[List[int]]
    # geoms (for contacts): static pose in body frame + size
    geom_body: List[int]
    geom_pos: List[Tuple[float, float, float]]
    geom_quat: List[Tuple[float, float, float, float]]
    geom_size: List[Tuple[float, float, float]]
    geom_type: List[int]
    slots: List[_ContactSlot]
    # option constants
    contact_tc: float
    contact_damp: float
    limit_tc: float
    limit_damp: float
    mode: str = "pd"          # 'pd' | 'torque'
    n_substeps: int = 8
    # friction for geom-geom (self) contacts; ground contacts always get
    # friction. Frictionless self-contacts cost ~40% fewer kernel ops and
    # barely change imitation dynamics.
    self_contact_friction: bool = True
    # Effective-mass model for SELF-contact slots (ground slots always use
    # the exact per-substep Delassus mass):
    #   'step'    — exact two-body Delassus mass computed at POLICY-STEP
    #               entry (substep 0) and held for the remaining substeps.
    #               Self-contact inertia coupling varies on the joint-config
    #               timescale (~16 ms policy step moves joints <= 0.16 rad),
    #               so a 60 Hz refresh is near-exact at ~1/8 the cost of
    #               per-substep solves. DEFAULT.
    #   'substep' — exact two-body Delassus mass every substep (500 Hz).
    #   'static'  — round-2/3 pairwise harmonic surrogate (cheapest,
    #               documented fidelity gap).
    # engine/solver.py honors the same model so the engines stay
    # differential-testable in every mode.
    self_contact_mass: str = "step"


def build_spec(
    model: Model,
    kp: Optional[np.ndarray] = None,
    kd: Optional[np.ndarray] = None,
    n_substeps: int = 8,
    mode: str = "pd",
    fall_allowed_bodies: Sequence[str] = (),
    torque_scale: float = 1.0,
) -> SubstepSpec:
    """Extract all static structure from a compiled Model (host-side)."""
    f = lambda x: np.asarray(x, np.float64)
    bodies: List[_BodyMeta] = []
    joints_of = [[] for _ in range(model.nbody)]
    for j in range(model.njnt):
        joints_of[model.jnt_bodyid[j]].append(
            _JointMeta(
                jtype=model.jnt_type[j],
                qadr=model.jnt_qposadr[j],
                dadr=model.jnt_dofadr[j],
                axis=tuple(f(model.jnt_axis)[j]),
                pos=tuple(f(model.jnt_pos)[j]),
            )
        )
    for b in range(model.nbody):
        bodies.append(
            _BodyMeta(
                parent=model.body_parent[b],
                pos=tuple(f(model.body_pos)[b]),
                quat=tuple(f(model.body_quat)[b]),
                joints=joints_of[b],
                mass=float(f(model.body_mass)[b]),
                ipos=tuple(f(model.body_ipos)[b]),
                inertia=tuple(tuple(r) for r in f(model.body_inertia)[b]),
            )
        )

    # dof -> body, per-body dofs
    dof_body = list(model.dof_bodyid)
    body_dofs = [[] for _ in range(model.nbody)]
    for i, b in enumerate(dof_body):
        body_dofs[b].append(i)

    # ancestor-dof chain per dof (for the mass matrix pairs)
    def chain_dofs(b):
        out = []
        while b != -1:
            out = body_dofs[b] + out
            b = model.body_parent[b]
        return out

    m_pairs = []
    for b in range(model.nbody):
        anc = chain_dofs(b)
        for i in body_dofs[b]:
            for j in anc:
                if j <= i:
                    m_pairs.append((i, j))
    # dedupe (root body dofs appear via their own chain)
    m_pairs = sorted(set(m_pairs))

    # actuated dofs + gains
    act_dof = list(model.actuator_dofadr)
    act_qadr = list(model.actuator_qposadr)
    gear = f(model.actuator_gear)
    cr = f(model.actuator_ctrlrange)
    tau_lo = list(gear * cr[:, 0] * torque_scale) if model.nu else []
    tau_hi = list(gear * cr[:, 1] * torque_scale) if model.nu else []
    if kp is None:
        kp = np.zeros(model.nu)
    if kd is None:
        kd = np.zeros(model.nu)

    limits = []
    for j in range(model.njnt):
        if model.jnt_type[j] == JointType.FREE or not model.jnt_limited[j]:
            continue
        lo, hi = f(model.jnt_range)[j]
        limits.append((model.jnt_qposadr[j], model.jnt_dofadr[j], float(lo), float(hi)))

    # ---- contact slots --------------------------------------------------
    allowed = {model.body_id(n) for n in fall_allowed_bodies}
    masses = f(model.body_mass)

    def m_eff(b1, b2):
        inv = 0.0
        for b in (b1, b2):
            if b >= 0:
                inv += 1.0 / max(masses[b], 1e-9)
        return 1.0 / max(inv, 1e-9)

    gfric = f(model.geom_friction)
    slots: List[_ContactSlot] = []

    def add(kind, g1, g2, extra=()):
        b1, b2 = model.geom_bodyid[g1], model.geom_bodyid[g2]
        fric = float(max(gfric[g1], gfric[g2]))
        fall = False
        if model.geom_type[g1] == GeomType.PLANE:
            fall = b2 not in allowed
        slots.append(_ContactSlot(kind=kind, g1=g1, g2=g2, body1=b1, body2=b2,
                                  friction=fric, m_eff=m_eff(b1, b2),
                                  extra=extra, fall=fall))

    corners = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
               for sz in (-1.0, 1.0)]
    for gp, go in zip(model.plane_geom, model.plane_other):
        t = model.geom_type[go]
        if t == GeomType.SPHERE:
            add("plane_sphere", gp, go)
        elif t == GeomType.CAPSULE:
            add("plane_capend", gp, go, extra=(-1.0,))
            add("plane_capend", gp, go, extra=(1.0,))
        elif t == GeomType.BOX:
            for c in corners:
                add("plane_corner", gp, go, extra=c)
    for g1, g2 in zip(model.pair_geom1, model.pair_geom2):
        t1, t2 = model.geom_type[g1], model.geom_type[g2]
        if (t1, t2) == (GeomType.BOX, GeomType.BOX):
            # corner-vs-box manifold: 8 corners of each box probed against
            # the other (mirrors engine/collision.py's narrow phase)
            for c in corners:
                add("boxcorner_box", g1, g2, extra=c)
                add("box_boxcorner", g1, g2, extra=c)
            continue
        kinds = {
            (GeomType.SPHERE, GeomType.SPHERE): "sphere_sphere",
            (GeomType.SPHERE, GeomType.CAPSULE): "sphere_capsule",
            (GeomType.SPHERE, GeomType.BOX): "sphere_box",
            (GeomType.CAPSULE, GeomType.CAPSULE): "capsule_capsule",
            (GeomType.CAPSULE, GeomType.BOX): "capsule_box",
        }
        add(kinds[(t1, t2)], g1, g2)

    opt = model.option
    return SubstepSpec(
        nq=model.nq, nv=model.nv, nu=model.nu, nbody=model.nbody,
        dt=float(opt.timestep), gravity=tuple(f(opt.gravity)),
        bodies=bodies,
        dof_damping=list(f(model.dof_damping)),
        dof_armature=list(f(model.dof_armature)),
        act_dof=act_dof, act_qadr=act_qadr,
        kp=list(np.asarray(kp, np.float64)), kd=list(np.asarray(kd, np.float64)),
        tau_lo=tau_lo, tau_hi=tau_hi,
        limits=limits, m_pairs=m_pairs,
        dof_body=dof_body, body_dofs=body_dofs,
        geom_body=list(model.geom_bodyid),
        geom_pos=[tuple(r) for r in f(model.geom_pos)],
        geom_quat=[tuple(r) for r in f(model.geom_quat)],
        geom_size=[tuple(r) for r in f(model.geom_size)],
        geom_type=list(model.geom_type),
        slots=slots,
        contact_tc=float(opt.contact_timeconst),
        contact_damp=float(opt.contact_dampratio),
        limit_tc=float(opt.limit_timeconst),
        limit_damp=float(opt.limit_dampratio),
        mode=mode,
        n_substeps=n_substeps,
        self_contact_mass=str(opt.self_contact_mass),
    )


# =========================================================================
# The field program: one physics substep on row-lists
# =========================================================================


def _fk(spec: SubstepSpec, qpos: List):
    """FK + motion subspace. Returns (xpos, xquat [per body], S rows, origin)."""
    nb = spec.nbody
    xpos: List = [None] * nb
    xquat: List = [None] * nb
    S: List = [None] * spec.nv
    like = qpos[0]

    origin = None
    for b, bm in enumerate(spec.bodies):
        if bm.parent == -1:
            pq = (1.0, 0.0, 0.0, 0.0)
            pp = (0.0, 0.0, 0.0)
        else:
            pq, pp = xquat[bm.parent], xpos[bm.parent]
        bq = q_mul(pq, tuple(float(c) for c in bm.quat)) if bm.quat != (1.0, 0.0, 0.0, 0.0) else pq
        bp = v3_add(pp, q_rotate(pq, v3_const(bm.pos))) if bm.pos != (0.0, 0.0, 0.0) else pp

        for jm in bm.joints:
            if jm.jtype == JointType.FREE:
                bp = (qpos[jm.qadr], qpos[jm.qadr + 1], qpos[jm.qadr + 2])
                bq = q_normalize(tuple(qpos[jm.qadr + 3 + k] for k in range(4)))
                if origin is None:
                    origin = bp
                for k in range(3):
                    e = [0.0, 0.0, 0.0]
                    e[k] = 1.0
                    S[jm.dadr + k] = (0.0, 0.0, 0.0) + tuple(e)
                for k in range(3):
                    e = [0.0, 0.0, 0.0]
                    e[k] = 1.0
                    ax = q_rotate(bq, tuple(e))
                    arm = v3_sub(bp, origin)  # folds to (0,0,0) at the root
                    S[jm.dadr + 3 + k] = ax + v3_cross(arm, ax)
            elif jm.jtype == JointType.HINGE:
                angle = qpos[jm.qadr]
                ql = q_axis_angle(jm.axis, angle)
                if jm.pos != (0.0, 0.0, 0.0):
                    anchor = v3_add(bp, q_rotate(bq, v3_const(jm.pos, like)))
                    bq = q_mul(bq, ql)
                    bp = v3_sub(anchor, q_rotate(bq, v3_const(jm.pos, like)))
                else:
                    anchor = bp
                    bq = q_mul(bq, ql)
                ax = q_rotate(bq, v3_const(jm.axis, like))
                if origin is None:
                    arm = anchor
                else:
                    arm = v3_sub(anchor, origin)
                S[jm.dadr] = ax + v3_cross(arm, ax)
            elif jm.jtype == JointType.SLIDE:
                ax = q_rotate(bq, v3_const(jm.axis, like))
                bp = v3_add(bp, v3_scale(ax, qpos[jm.qadr]))
                S[jm.dadr] = (0.0, 0.0, 0.0) + ax
            else:
                raise ValueError(f"joint type {jm.jtype}")
        if origin is None and b == 0:
            origin = bp
        xpos[b] = bp
        xquat[b] = q_normalize(bq)
    return xpos, xquat, S, origin


def _cvel(spec, S, qvel):
    """Per-body spatial velocity by propagation."""
    v = [None] * spec.nbody
    zero6 = (0.0,) * 6
    for b, bm in enumerate(spec.bodies):
        cur = zero6 if bm.parent == -1 else v[bm.parent]
        for i in spec.body_dofs[b]:
            cur = tuple(fadd(cur[k], fmul(S[i][k], qvel[i])) for k in range(6))
        v[b] = cur
    return v


def _spatial_inertias(spec, xpos, xquat, origin):
    """Structured spatial inertia (A, h, m) per body about origin."""
    out = []
    like = xpos[0][0]
    for b, bm in enumerate(spec.bodies):
        r0, r1, r2 = q_to_mat(xquat[b])
        I = bm.inertia
        # Iw = R I R^T, symmetric: compute columns of R I first.
        rows = (r0, r1, r2)
        RI = [[fadd(fadd(fmul(rows[a][0], I[0][c]), fmul(rows[a][1], I[1][c])),
                    fmul(rows[a][2], I[2][c])) for c in range(3)]
              for a in range(3)]
        Iw = [[fadd(fadd(fmul(RI[a][0], rows[c][0]), fmul(RI[a][1], rows[c][1])),
                    fmul(RI[a][2], rows[c][2])) for c in range(3)]
              for a in range(3)]
        # com relative to origin
        ip = v3_const(bm.ipos)
        c = v3_sub(v3_add(xpos[b], q_rotate(xquat[b], ip)), origin) \
            if bm.ipos != (0.0, 0.0, 0.0) else v3_sub(xpos[b], origin)
        m = bm.mass
        h = v3_scale(c, m)
        # A = Iw + m (c.c E - c c^T)  (parallel axis to the origin)
        cc = v3_dot(c, c)
        A = [[fsub(fadd(Iw[a][k], (fmul(m, cc) if a == k else 0.0)),
                   fmul(fmul(m, c[a]), c[k]))
              for k in range(3)] for a in range(3)]
        out.append((A, h, m, c))
    return out


def _crba(spec, S, inertias):
    """Mass matrix entries for the static ancestor pairs -> dict[(i,j)]."""
    # composite inertias: subtree sums (children have larger index)
    comp = [[inertias[b][0], inertias[b][1], inertias[b][2]] for b in range(spec.nbody)]
    for b in range(spec.nbody - 1, -1, -1):
        p = spec.bodies[b].parent
        if p >= 0:
            A, h, m = comp[b]
            Ap, hp, mp = comp[p]
            comp[p] = (
                [[fadd(Ap[a][k], A[a][k]) for k in range(3)] for a in range(3)],
                v3_add(hp, h),
                fadd(mp, m),
            )
    F = [None] * spec.nv  # F_i = I^C_{body(i)} S_i
    for i in range(spec.nv):
        A, h, m = comp[spec.dof_body[i]]
        F[i] = inertia_mul(A, h, m, S[i])
    M = {}
    for (i, j) in spec.m_pairs:
        M[(i, j)] = sp_dot(S[j], F[i])
    for i in range(spec.nv):
        M[(i, i)] = fadd(M[(i, i)], spec.dof_armature[i])
    return M


def _rnea_bias(spec, S, cvel, inertias, qvel):
    """Velocity-product + gravity bias force per dof (corrected Sdot rules)."""
    g = spec.gravity
    a_base = (0.0, 0.0, 0.0) + v3_const([-g[0], -g[1], -g[2]])
    acc = [None] * spec.nbody
    for b, bm in enumerate(spec.bodies):
        a = a_base if bm.parent == -1 else acc[bm.parent]
        v_run = (0.0,) * 6 if bm.parent == -1 else cvel[bm.parent]
        for jm in bm.joints:
            if jm.jtype == JointType.FREE:
                vj_rot = tuple(
                    fadd(fadd(fmul(S[jm.dadr + 3][c], qvel[jm.dadr + 3]),
                              fmul(S[jm.dadr + 4][c], qvel[jm.dadr + 4])),
                         fmul(S[jm.dadr + 5][c], qvel[jm.dadr + 5]))
                    for c in range(6)
                )
                cx = sp_motion_cross(cvel[b], vj_rot)
                a = tuple(fadd(a[c], cx[c]) for c in range(6))
                v_run = cvel[b]
            else:
                i = jm.dadr
                cx = sp_motion_cross(v_run, S[i])
                a = tuple(fadd(a[c], fmul(cx[c], qvel[i])) for c in range(6))
                v_run = tuple(fadd(v_run[c], fmul(S[i][c], qvel[i])) for c in range(6))
        acc[b] = a

    # f_b = I a + v x* (I v)
    f = []
    for b in range(spec.nbody):
        A, h, m, _ = inertias[b]
        Ia = inertia_mul(A, h, m, acc[b])
        Iv = inertia_mul(A, h, m, cvel[b])
        w, vl = cvel[b][:3], cvel[b][3:]
        t1 = v3_add(v3_cross(w, Iv[:3]), v3_cross(vl, Iv[3:]))
        t2 = v3_cross(w, Iv[3:])
        f.append((fadd(Ia[0], t1[0]), fadd(Ia[1], t1[1]), fadd(Ia[2], t1[2]),
                  fadd(Ia[3], t2[0]), fadd(Ia[4], t2[1]), fadd(Ia[5], t2[2])))

    # subtree force sums, then project on S
    for b in range(spec.nbody - 1, -1, -1):
        p = spec.bodies[b].parent
        if p >= 0:
            f[p] = tuple(fadd(f[p][c], f[b][c]) for c in range(6))
    bias = [sp_dot(S[i], f[spec.dof_body[i]]) for i in range(spec.nv)]
    return bias


# ---------------- contacts ------------------------------------------------


def _np_quat_rotate(q, v):
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    u, w = q[1:], q[0]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _geom_pose(spec, g, xpos, xquat, like, cache):
    """World pose of geom g: ('static', np_pos, np_quat) for world geoms,
    field tuples otherwise. Cached per substep."""
    if g in cache:
        return cache[g]
    b = spec.geom_body[g]
    gp = spec.geom_pos[g]
    gq = spec.geom_quat[g]
    if b < 0:
        out = ("static", np.asarray(gp), np.asarray(gq))
    else:
        bp, bq = xpos[b], xquat[b]
        p = v3_add(bp, q_rotate(bq, v3_const(gp, like))) if gp != (0.0, 0.0, 0.0) else bp
        q = q_mul(bq, tuple(float(c) for c in gq)) \
            if gq != (1.0, 0.0, 0.0, 0.0) else bq
        out = (p, q)
    cache[g] = out
    return out


def _cap_ends_cached(spec, g, pose, cache):
    key = ("ends", g)
    if key in cache:
        return cache[key]
    p, q = pose
    out = _capsule_ends(p, q, float(spec.geom_size[g][1]))
    cache[key] = out
    return out


def _make_frame(n):
    """Orthonormal tangents for unit normal field n -> (t1, t2)."""
    use_x = torch.abs(n[0]) < 0.5
    ref = (torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0), 0.0)
    t1 = v3_cross(n, ref)
    inv = _rsqrt(_max(v3_dot(t1, t1), 1e-12))
    t1 = v3_scale(t1, inv)
    t2 = v3_cross(n, t1)
    return t1, t2


def _closest_on_segment(a, b, p):
    ab = v3_sub(b, a)
    t = v3_dot(v3_sub(p, a), ab) / _max(v3_dot(ab, ab), 1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return v3_add(a, v3_scale(ab, t))


def _capsule_ends(p, q, hh):
    ax = q_rotate(q, (0.0, 0.0, 1.0))
    return (v3_sub(p, v3_scale(ax, hh)), v3_add(p, v3_scale(ax, hh)))


def _point_box(pl_, half):
    """Closest point/normal/signed-dist of field point pl_ vs static box."""
    hx, hy, hz = (float(h) for h in half)
    cl = (torch.clamp(pl_[0], -hx, hx), torch.clamp(pl_[1], -hy, hy),
          torch.clamp(pl_[2], -hz, hz))
    delta = v3_sub(pl_, cl)
    dsq = v3_dot(delta, delta)
    # squared-distance test: v3_norm clamps to ~1e-9 and float rounding made
    # exactly-interior points (delta == 0 after the clip) classify as outside
    outside = dsq > 1e-18
    d_out = _sqrt(_max(dsq, 1e-18))
    n_out = v3_scale(delta, 1.0 / d_out)
    gx, gy, gz = hx - torch.abs(pl_[0]), hy - torch.abs(pl_[1]), hz - torch.abs(pl_[2])
    # interior: nearest face
    min_xy = torch.minimum(gx, gy)
    gap_in = torch.minimum(min_xy, gz)
    sx = torch.where(pl_[0] >= 0, 1.0, -1.0)
    sy = torch.where(pl_[1] >= 0, 1.0, -1.0)
    sz = torch.where(pl_[2] >= 0, 1.0, -1.0)
    is_x = gx <= torch.minimum(gy, gz)
    is_y = ~is_x & (gy <= gz)
    is_z = ~is_x & ~is_y
    n_in = (torch.where(is_x, sx, 0.0), torch.where(is_y, sy, 0.0),
            torch.where(is_z, sz, 0.0))
    cl_in = v3_add(pl_, v3_scale(n_in, gap_in))
    n = tuple(torch.where(outside, n_out[k], n_in[k]) for k in range(3))
    closest = tuple(torch.where(outside, cl[k], cl_in[k]) for k in range(3))
    dist = torch.where(outside, d_out, -gap_in)
    return closest, n, dist


def _contact_geometry(spec, slot, xpos, xquat, like, cache):
    """(dist, pos, normal 1->2, static_frame_or_None) for one static slot."""
    s1 = spec.geom_size[slot.g1]
    s2 = spec.geom_size[slot.g2]
    k = slot.kind
    if k in ("plane_sphere", "plane_capend", "plane_corner"):
        ppose = _geom_pose(spec, slot.g1, xpos, xquat, like, cache)
        opose = _geom_pose(spec, slot.g2, xpos, xquat, like, cache)
        op, oq = opose
        if ppose[0] == "static":
            # World-attached plane (the common case): normal and tangents
            # are compile-time constants; distance is one dot product.
            _, pp_np, pq_np = ppose
            n_np = _np_quat_rotate(pq_np, [0.0, 0.0, 1.0])
            ref = [1.0, 0, 0] if abs(n_np[0]) < 0.5 else [0.0, 1.0, 0]
            t1_np = np.cross(n_np, ref)
            t1_np /= max(np.linalg.norm(t1_np), 1e-12)
            t2_np = np.cross(n_np, t1_np)
            frame = (tuple(n_np), tuple(t1_np), tuple(t2_np))
            n = v3_const(n_np)
            d0 = float(np.dot(n_np, pp_np))

            def plane_h(pt):
                return fsub(v3_dot(n, pt), d0)

        else:
            pp, pq = ppose
            n = q_rotate(pq, (0.0, 0.0, 1.0))
            frame = None

            def plane_h(pt):
                return v3_dot(n, v3_sub(pt, pp))

        if k == "plane_sphere":
            r = float(s2[0])
            dist = plane_h(op) - r
            pos = v3_sub(op, v3_scale(n, r + 0.5 * dist))
            return dist, pos, n, frame
        if k == "plane_capend":
            r = float(s2[0])
            sign = slot.extra[0]
            e0, e1 = _cap_ends_cached(spec, slot.g2, opose, cache)
            end = e0 if sign < 0 else e1
            dist = plane_h(end) - r
            pos = v3_sub(end, v3_scale(n, r + 0.5 * dist))
            return dist, pos, n, frame
        # plane_corner
        sx, sy, sz = slot.extra
        corner_l = (float(s2[0]) * sx, float(s2[1]) * sy, float(s2[2]) * sz)
        cw = v3_add(op, q_rotate(oq, v3_const(corner_l, like)))
        dist = plane_h(cw)
        pos = v3_sub(cw, v3_scale(n, 0.5 * dist))
        return dist, pos, n, frame

    p1, q1 = _geom_pose(spec, slot.g1, xpos, xquat, like, cache)
    p2, q2 = _geom_pose(spec, slot.g2, xpos, xquat, like, cache)

    def sphere_sphere(c1, r1, c2, r2):
        d = v3_sub(c2, c1)
        ln = v3_norm(d, 1e-18)
        n = v3_scale(d, 1.0 / ln)
        dist = ln - (r1 + r2)
        pos = v3_add(c1, v3_scale(n, r1 + 0.5 * dist))
        return dist, pos, n

    if k == "sphere_sphere":
        return sphere_sphere(p1, float(s1[0]), p2, float(s2[0])) + (None,)
    if k == "sphere_capsule":
        e0, e1 = _cap_ends_cached(spec, slot.g2, (p2, q2), cache)
        cp = _closest_on_segment(e0, e1, p1)
        return sphere_sphere(p1, float(s1[0]), cp, float(s2[0])) + (None,)
    if k in ("boxcorner_box", "box_boxcorner"):
        # One corner of box a probed against box b; normal emitted 1 -> 2.
        # The 8+8 corner slots of one pair share both rotation matrices, so
        # cache rows of R per geom instead of per-corner quaternion rotates
        # (the corner offset is a compile-time constant: R @ c folds to 9
        # scalar muls).
        sx, sy, sz = slot.extra
        if k == "boxcorner_box":
            (pa, qa, sa, ga), (pb, qb, sb, gb) = ((p1, q1, s1, slot.g1),
                                                  (p2, q2, s2, slot.g2))
        else:
            (pa, qa, sa, ga), (pb, qb, sb, gb) = ((p2, q2, s2, slot.g2),
                                                  (p1, q1, s1, slot.g1))

        def rot_rows(g, q):
            key = ("mat", g)
            if key not in cache:
                cache[key] = q_to_mat(q)
            return cache[key]

        ra = rot_rows(ga, qa)
        rb = rot_rows(gb, qb)
        corner_l = (float(sa[0]) * sx, float(sa[1]) * sy, float(sa[2]) * sz)
        cw = tuple(pa[i] + ra[i][0] * corner_l[0] + ra[i][1] * corner_l[1]
                   + ra[i][2] * corner_l[2] for i in range(3))
        rel = v3_sub(cw, pb)
        pl_ = tuple(rb[0][i] * rel[0] + rb[1][i] * rel[1] + rb[2][i] * rel[2]
                    for i in range(3))  # R_b^T (cw - pb)
        closest_l, n_l, d = _point_box(pl_, sb)
        n_w = tuple(v3_dot(rb[i], n_l) for i in range(3))  # box b -> corner
        surf = tuple(pb[i] + v3_dot(rb[i], closest_l) for i in range(3))
        pos = v3_add(surf, v3_scale(n_w, 0.5 * d))
        n = v3_scale(n_w, -1.0) if k == "boxcorner_box" else n_w
        return d, pos, n, None
    if k == "sphere_box":
        pl_ = q_rotate_inv(q2, v3_sub(p1, p2))
        closest_l, n_l, d = _point_box(pl_, s2)
        r = float(s1[0])
        dist = d - r
        n = v3_scale(q_rotate(q2, n_l), -1.0)
        pos = v3_sub(v3_add(p2, q_rotate(q2, closest_l)),
                     v3_scale(n, 0.5 * dist))
        return dist, pos, n, None
    if k == "capsule_capsule":
        a0, a1 = _cap_ends_cached(spec, slot.g1, (p1, q1), cache)
        b0, b1 = _cap_ends_cached(spec, slot.g2, (p2, q2), cache)
        # Ericson clamped closest points
        d1 = v3_sub(a1, a0)
        d2 = v3_sub(b1, b0)
        r = v3_sub(a0, b0)
        a = v3_dot(d1, d1)
        e = v3_dot(d2, d2)
        fq = v3_dot(d2, r)
        c = v3_dot(d1, r)
        b = v3_dot(d1, d2)
        denom = a * e - b * b
        s = torch.where(denom > 1e-12, (b * fq - c * e) / _max(denom, 1e-12), 0.0)
        s = torch.clamp(s, 0.0, 1.0)
        t = (b * s + fq) / _max(e, 1e-12)
        t = torch.clamp(t, 0.0, 1.0)
        s = torch.clamp((b * t - c) / _max(a, 1e-12), 0.0, 1.0)
        cp1 = v3_add(a0, v3_scale(d1, s))
        cp2 = v3_add(b0, v3_scale(d2, t))
        return sphere_sphere(cp1, float(s1[0]), cp2, float(s2[0])) + (None,)
    if k == "capsule_box":
        a0, a1 = _cap_ends_cached(spec, slot.g1, (p1, q1), cache)
        cp = _closest_on_segment(a0, a1, p2)
        pl_ = q_rotate_inv(q2, v3_sub(cp, p2))
        closest_l, _, _ = _point_box(pl_, s2)
        box_pt = v3_add(p2, q_rotate(q2, closest_l))
        cp = _closest_on_segment(a0, a1, box_pt)
        pl_ = q_rotate_inv(q2, v3_sub(cp, p2))
        closest_l, n_l, d = _point_box(pl_, s2)
        dist = d - float(s1[0])
        n = v3_scale(q_rotate(q2, n_l), -1.0)
        pos = v3_sub(v3_add(p2, q_rotate(q2, closest_l)),
                     v3_scale(n, 0.5 * dist))
        return dist, pos, n, None
    raise ValueError(f"slot kind {k}")


def _chain_dofs(spec, b):
    """Static ancestor dof chain of body b (ascending dof order)."""
    out = []
    while b != -1:
        out = spec.body_dofs[b] + out
        b = spec.bodies[b].parent
    return out


def _delassus_inv_mass(spec, L0, invd0, S, body, f_hat, body1=-1):
    """w = J M^-1 J^T for a contact on ``body`` (vs world, or vs ``body1``)
    with unit spatial force ``f_hat`` about the origin.

    J[i] = (anc_body[i] - anc_body1[i]) * (S_i . f_hat): +1 on ``body``'s
    ancestor chain, -1 on ``body1``'s, 0 where the chains overlap (the
    common root path cancels — relative velocity is insensitive to shared
    ancestors). With M = L L^T the scalar Delassus entry is
    w = ||L^-1 J^T||^2 — only the FORWARD triangular solve is needed. The
    solve runs over the UNION of the two chains: eliminating a dof only
    couples its own ancestors, so y's support is the ancestor closure of
    J's support, which re-includes the cancelled common path but nothing
    off the two chains. World-vs-body (body1=-1) reduces to the single
    ~13-dof root path.
    """
    n = spec.nv
    r = lambda a: n - 1 - a  # reversed-space index (leaves first)
    supp2 = _chain_dofs(spec, body)
    supp1 = _chain_dofs(spec, body1) if body1 >= 0 else []
    s1, s2 = set(supp1), set(supp2)
    supp = sorted(s1 | s2)
    rows = {}
    for i in supp:
        if i in s2 and i in s1:
            rows[i] = None  # common root path: cancels exactly in J
        elif i in s2:
            rows[i] = sp_dot(S[i], f_hat)
        else:
            rows[i] = fneg(sp_dot(S[i], f_hat))
    y = {}
    for i in sorted(supp, key=r):  # distal dofs eliminate first
        acc = rows[i]
        for j in supp:
            if r(j) < r(i) and L0[r(i)][r(j)] is not None and y[j] is not None:
                term = fmul(L0[r(i)][r(j)], y[j])
                acc = fneg(term) if acc is None else fsub(acc, term)
        y[i] = None if acc is None else fmul(acc, invd0[r(i)])
    w = None
    for i in supp:
        if y[i] is None:
            continue
        w = fmul(y[i], y[i]) if w is None else fadd(w, fmul(y[i], y[i]))
    return w


def _contact_forces(spec, xpos, xquat, cvel, origin, like, S=None, L0=None,
                    invd0=None, held_self=None):
    """Streamed contacts: per-body spatial force accumulators + fall flag.

    With ``S``/``L0`` (motion subspace + plain-M tree factor) given, ground
    slots use the exact per-substep Delassus effective mass along the
    normal; self-contact slots follow ``spec.self_contact_mass``:
    'substep' solves fresh, 'step' uses ``held_self`` (dict slot-idx ->
    mass field from the policy-step entry substep; when None — i.e. AT the
    entry substep — solves fresh and records into the returned dict),
    'static' uses the harmonic surrogate. Matches ``engine/solver.py``.

    Returns (facc, fall, self_mass_out).
    """
    facc = [[0.0] * 6 for _ in range(spec.nbody)]
    fall = torch.zeros_like(like)
    self_out = {}

    tc = max(spec.contact_tc, 2.0 * spec.dt)
    kstiff = 1.0 / (tc * tc)
    bdamp = 2.0 * spec.contact_damp / tc

    cache = {}
    for si, slot in enumerate(spec.slots):
        dist, pos, n, static_frame = _contact_geometry(
            spec, slot, xpos, xquat, like, cache)
        is_ground = slot.kind.startswith("plane")
        with_friction = is_ground or spec.self_contact_friction
        if static_frame is not None:
            n_np, t1_np, t2_np = static_frame
            n = v3_const(n_np)
            t1 = v3_const(t1_np)
            t2 = v3_const(t2_np)
        elif with_friction:
            t1, t2 = _make_frame(n)
        arm = v3_sub(pos, origin)

        def point_vel(b):
            if b < 0:
                return (0.0, 0.0, 0.0)
            v = cvel[b]
            return v3_add(v[3:], v3_cross(v[:3], arm))

        vrel = v3_sub(point_vel(slot.body2), point_vel(slot.body1))
        vn = v3_dot(n, vrel)
        if with_friction:
            vt1 = v3_dot(t1, vrel)
            vt2 = v3_dot(t2, vrel)

        ground = slot.body1 < 0
        smode = spec.self_contact_mass
        if S is not None and (
                ground or smode == "substep"
                or (smode == "step" and held_self is None)):
            f_hat = v3_cross(arm, n) + n  # unit spatial force about origin
            w = _delassus_inv_mass(spec, L0, invd0, S, slot.body2, f_hat,
                                   body1=slot.body1)
            m_eff = 1.0 / _max(w, 1e-6)
            if not ground and smode == "step":
                self_out[si] = m_eff
        elif S is not None and smode == "step":
            m_eff = held_self[si]
        else:
            m_eff = slot.m_eff

        active = dist < 0.0
        pen = _min(dist, 0.0)
        fn = m_eff * (-kstiff * pen - bdamp * vn)
        fn = torch.where(active, _max(fn, 0.0), 0.0)

        if with_friction:
            ft_scale = -m_eff * (2.0 / tc)
            f1r, f2r = ft_scale * vt1, ft_scale * vt2
            ft_norm = _sqrt(_max(f1r * f1r + f2r * f2r, 1e-18))
            cone = slot.friction * fn
            scale = torch.where(ft_norm > 1e-9,
                                _min(cone / ft_norm, 1.0), 0.0)
            f1 = f1r * scale
            f2 = f2r * scale
            fw = (fadd(fadd(fmul(n[0], fn), fmul(t1[0], f1)), fmul(t2[0], f2)),
                  fadd(fadd(fmul(n[1], fn), fmul(t1[1], f1)), fmul(t2[1], f2)),
                  fadd(fadd(fmul(n[2], fn), fmul(t1[2], f1)), fmul(t2[2], f2)))
        else:
            fw = (fmul(n[0], fn), fmul(n[1], fn), fmul(n[2], fn))
        torque = v3_cross(arm, fw)
        for (b, sgn) in ((slot.body2, 1.0), (slot.body1, -1.0)):
            if b < 0:
                continue
            acc = facc[b]
            if sgn > 0:
                facc[b] = [fadd(acc[0], torque[0]), fadd(acc[1], torque[1]),
                           fadd(acc[2], torque[2]), fadd(acc[3], fw[0]),
                           fadd(acc[4], fw[1]), fadd(acc[5], fw[2])]
            else:
                facc[b] = [fsub(acc[0], torque[0]), fsub(acc[1], torque[1]),
                           fsub(acc[2], torque[2]), fsub(acc[3], fw[0]),
                           fsub(acc[4], fw[1]), fsub(acc[5], fw[2])]
        if slot.fall:
            fall = torch.maximum(fall, active.to(like.dtype))
    return facc, fall, self_out


# ---------------- dense solve ---------------------------------------------


def _factor(spec, M, lhs_extra_diag):
    """Sparse tree Cholesky factor of the field dict M (+diag).

    The mass matrix of a kinematic tree is nonzero only for ancestor pairs.
    Eliminating LEAVES FIRST (reverse dof order — MuJoCo's mj_factorM trick)
    produces zero fill-in: eliminating a leaf column only couples its own
    ancestors, which are already mutually coupled. We therefore run a
    standard Cholesky in reversed index space; the structural pattern is
    exactly ``spec.m_pairs``. Returns (L, invdiag): L as a 2-D list in
    reversed space (``L[r(i)][r(j)]``; None = structurally zero) and the
    reciprocal diagonal ``invdiag[j] = 1 / L[j][j]`` — computed once here
    so every triangular solve (the acceleration solve + one Delassus solve
    per contact slot, ~140 per substep) multiplies instead of divides
    (the reciprocals are already needed to build
    L's columns).
    """
    n = spec.nv
    r = lambda a: n - 1 - a  # reversed-space <-> dof index

    # A in reversed space, structural-sparse (None = exactly zero)
    A = [[None for _ in range(n)] for _ in range(n)]
    for (i, j), v in M.items():
        A[r(i)][r(j)] = v
        A[r(j)][r(i)] = v
    for i in range(n):
        A[r(i)][r(i)] = fadd(M[(i, i)], lhs_extra_diag[i])

    # verify no fill-in would occur (debug-grade symbolic check is implicit:
    # an update to a structurally-zero entry raises below).
    L = [[None] * n for _ in range(n)]
    invd = [None] * n
    for j in range(n):
        d = (fsqrt(max(A[j][j], 1e-12)) if _isc(A[j][j])
             else _sqrt(_max(A[j][j], 1e-12)))
        inv = fdiv(1.0, d) if _isc(d) else 1.0 / d
        L[j][j] = d
        invd[j] = inv
        col = [i for i in range(j + 1, n) if A[i][j] is not None]
        for i in col:
            L[i][j] = fmul(A[i][j], inv)
        for ii_idx, i in enumerate(col):
            for kk in col[ii_idx:]:
                if A[kk][i] is None:
                    # tree ordering guarantees this never happens; guard for
                    # exotic models (would need symbolic fill).
                    A[kk][i] = 0.0
                    A[i][kk] = A[kk][i]
                A[kk][i] = fsub(A[kk][i], fmul(L[kk][j], L[i][j]))
                if kk != i:
                    A[i][kk] = A[kk][i]
    return L, invd


def _solve(spec, M, lhs_extra_diag, rhs):
    """Factor + solve in one call (see :func:`_factor`)."""
    n = spec.nv
    r = lambda a: n - 1 - a
    L, invd = _factor(spec, M, lhs_extra_diag)

    rrev = [rhs[n - 1 - a] for a in range(n)]
    # forward: L y = rhs_rev
    y = [None] * n
    for i in range(n):
        acc = rrev[i]
        for j in range(i):
            if L[i][j] is not None:
                acc = fsub(acc, fmul(L[i][j], y[j]))
        y[i] = fmul(acc, invd[i])
    # backward: L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[i]
        for j in range(i + 1, n):
            if L[j][i] is not None:
                acc = fsub(acc, fmul(L[j][i], x[j]))
        x[i] = fmul(acc, invd[i])
    return [x[r(i)] for i in range(n)]


# ---------------- the substep ---------------------------------------------


def substep(spec: SubstepSpec, qpos: List, qvel: List, u: List,
            held_self=None):
    """One physics substep on row-lists. ``u`` = PD targets (mode='pd') or
    torques (mode='torque'), nu rows.

    Returns (qpos', qvel', fall, self_mass_out): ``self_mass_out`` is the
    dict of exact self-contact masses computed THIS substep (non-empty only
    in 'step' mode with ``held_self=None`` — the policy-step entry substep);
    pass it back as ``held_self`` for the remaining substeps of the step.
    """
    like = qpos[0]
    h = spec.dt

    xpos, xquat, S, origin = _fk(spec, qpos)
    cvel = _cvel(spec, S, qvel)
    inertias = _spatial_inertias(spec, xpos, xquat, origin)
    M = _crba(spec, S, inertias)
    bias = _rnea_bias(spec, S, cvel, inertias, qvel)
    # Plain-M factor for the Delassus contact masses (the acceleration solve
    # below refactors with the implicit diagonal folded in).
    L0, invd0 = _factor(spec, M, [0.0] * spec.nv)
    facc, fall, self_out = _contact_forces(spec, xpos, xquat, cvel, origin,
                                           like, S=S, L0=L0, invd0=invd0,
                                           held_self=held_self)

    # subtree force sums -> constraint qfrc
    for b in range(spec.nbody - 1, -1, -1):
        p = spec.bodies[b].parent
        if p >= 0:
            facc[p] = [fadd(facc[p][c], facc[b][c]) for c in range(6)]
    qfrc_con = [sp_dot(S[i], tuple(facc[spec.dof_body[i]])) for i in range(spec.nv)]

    # joint limits (uses M diagonal as effective mass)
    ltc = max(spec.limit_tc, 2.0 * h)
    lk = 1.0 / (ltc * ltc)
    lb = 2.0 * spec.limit_damp / ltc
    for (qa, da, lo, hi) in spec.limits:
        q = qpos[qa]
        qd = qvel[da]
        me = M[(da, da)]
        over_hi = _max(q - hi, 0.0)
        over_lo = _max(lo - q, 0.0)
        tau_hi = _min(torch.where(over_hi > 0, me * (-lk * over_hi - lb * qd), 0.0), 0.0)
        tau_lo = _max(torch.where(over_lo > 0, me * (lk * over_lo - lb * qd), 0.0), 0.0)
        qfrc_con[da] = fadd(qfrc_con[da], tau_hi + tau_lo)

    # rhs & implicit diagonal
    rhs = [None] * spec.nv
    extra_diag = [h * spec.dof_damping[i] for i in range(spec.nv)]
    for i in range(spec.nv):
        rhs[i] = fadd(fsub(fneg(bias[i]), fmul(spec.dof_damping[i], qvel[i])),
                      qfrc_con[i])

    if spec.mode == "pd":
        for a in range(spec.nu):
            da, qa = spec.act_dof[a], spec.act_qadr[a]
            e = qpos[qa] + h * qvel[da] - u[a]
            tau = -spec.kp[a] * e - spec.kd[a] * qvel[da]
            tau = torch.clamp(tau, spec.tau_lo[a], spec.tau_hi[a])
            rhs[da] = rhs[da] + tau
            extra_diag[da] = extra_diag[da] + h * spec.kd[a]
    elif spec.mode == "torque":
        for a in range(spec.nu):
            da = spec.act_dof[a]
            tau = torch.clamp(u[a], spec.tau_lo[a], spec.tau_hi[a])
            rhs[da] = rhs[da] + tau
    else:
        raise ValueError(spec.mode)

    qacc = _solve(spec, M, extra_diag, rhs)

    # semi-implicit Euler (with the engine's defensive qvel clamp)
    qvel2 = [torch.clamp(qvel[i] + h * qacc[i], -1e3, 1e3) for i in range(spec.nv)]
    qpos2 = list(qpos)
    for bm in spec.bodies:
        for jm in bm.joints:
            if jm.jtype == JointType.FREE:
                for k in range(3):
                    qpos2[jm.qadr + k] = qpos[jm.qadr + k] + h * qvel2[jm.dadr + k]
                q = tuple(qpos[jm.qadr + 3 + k] for k in range(4))
                w = tuple(qvel2[jm.dadr + 3 + k] for k in range(3))
                qn = q_normalize(q_mul(q, q_exp_omega(w, h)))
                for k in range(4):
                    qpos2[jm.qadr + 3 + k] = qn[k]
            else:
                qpos2[jm.qadr] = qpos[jm.qadr] + h * qvel2[jm.dadr]
    return qpos2, qvel2, fall, self_out


def fk_outputs(spec: SubstepSpec, qpos: List):
    """Final-pose FK rows for reward computation: (xpos, xquat per body).

    Components that stayed structural constants through FK (possible only
    for a jointless body chain, e.g. a fixed-base test scene) are
    materialized as field rows here via ``_ensure_field`` — consumers
    (kernel outputs, ``torch.stack``) need tensors.
    """
    xpos, xquat, _, _ = _fk(spec, qpos)
    like = qpos[0]
    xpos = [tuple(_ensure_field(c, like) for c in p) for p in xpos]
    xquat = [tuple(_ensure_field(c, like) for c in q) for q in xquat]
    return xpos, xquat




# =========================================================================
# Operation count (counterpart of count_substep_flops)
# =========================================================================

# Weights per scalar op, as pbrl_tpu's count_substep_flops weighs jaxpr
# primitives (transcendentals 4, square roots 2, two-sided clamps 2).
_OP_WEIGHTS = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "true_divide": 1,
    "neg": 1, "abs": 1, "maximum": 1, "minimum": 1, "where": 1,
    "sqrt": 2, "rsqrt": 2, "sin": 4, "cos": 4, "exp": 4, "log": 4,
}


def _op_name(func) -> str:
    name = getattr(func, "__name__", "")
    return name.strip("_").removeprefix("r") if name.startswith("__r") else name.strip("_")


class _Count(TorchFunctionMode):
    """Weighs every tensor op run under it (``n``)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        if name == "clamp":
            bounds = [a for a in args[1:3] if a is not None]
            bounds += [v for k, v in kwargs.items() if k in ("min", "max") and v is not None]
            self.n += len(bounds)
        else:
            self.n += _OP_WEIGHTS.get(name, 0)
        return func(*args, **kwargs)


def _counted(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its FLOPs)``."""
    with _Count() as c:
        out = fn(*args, **kwargs)
    return out, c.n


def _unit_state(spec: SubstepSpec):
    """qpos, qvel, u rows of one CPU env, for counting."""
    like = torch.zeros(1)
    return [like + 0.1] * spec.nq, [like] * spec.nv, [like] * max(spec.nu, 1)


def _delassus_flops(spec: SubstepSpec):
    """FLOPs of the plain-M factor, and per slot those of its Delassus mass
    (the unit force, the solve and ``1 / max(w, eps)``) as
    ``_contact_forces`` spends them."""
    qpos, _, _ = _unit_state(spec)
    xpos, xquat, S, origin = _fk(spec, qpos)
    M = _crba(spec, S, _spatial_inertias(spec, xpos, xquat, origin))
    (L0, invd0), n_factor = _counted(_factor, spec, M, [0.0] * spec.nv)

    def mass(slot, arm, n):
        f_hat = v3_cross(arm, n) + n
        w = _delassus_inv_mass(spec, L0, invd0, S, slot.body2, f_hat, body1=slot.body1)
        return 1.0 / _max(w, 1e-6)

    cache, per_slot = {}, []
    for slot in spec.slots:
        _, pos, n, frame = _contact_geometry(spec, slot, xpos, xquat, qpos[0], cache)
        n = v3_const(frame[0]) if frame is not None else n
        per_slot.append(_counted(mass, slot, v3_sub(pos, origin), n)[1])
    return n_factor, per_slot


def count_policy_step_flops(spec: SubstepSpec, active: Optional[torch.Tensor] = None) -> int:
    """Scalar FLOPs of one policy step.

    Without ``active``: for one env, the straight-line program. Runs the
    plain program on one CPU env under a ``TorchFunctionMode`` that weighs
    every tensor op like ``count_substep_flops`` weighs jaxpr primitives:
    the entry substep, one held-mass substep times ``n_substeps - 1`` and
    the final FK. The program is straight-line, so this count does not
    depend on the state.

    With ``active``, the ``(n_substeps, B, nslot)`` touching contacts of
    ``contact_activity``: what these B envs need, summed. A contact that
    does not touch pushes with zero force whatever its mass, so a ground or
    'substep' mass is needed only at a substep where its contact touches, a
    held 'step' mass only where its contact touches at some substep of the
    step, and the plain-M factor only at a substep that solves a mass.
    """
    qpos, qvel, u = _unit_state(spec)
    (_, _, _, held), n_entry = _counted(substep, spec, qpos, qvel, u)
    n_rest = 0
    if spec.n_substeps > 1:
        n_rest = _counted(substep, spec, qpos, qvel, u, held_self=held or None)[1]
    per_env = n_entry + (spec.n_substeps - 1) * n_rest + _counted(fk_outputs, spec, qpos)[1]
    if active is None:
        return per_env

    n_factor, per_slot = _delassus_flops(spec)
    cost = torch.tensor(per_slot, dtype=torch.float64)
    active = active.cpu()
    ns, B = active.shape[:2]
    ground = torch.tensor([s.body1 < 0 for s in spec.slots])
    entry = (torch.arange(ns) == 0)[:, None]
    mode = spec.self_contact_mass
    # the masses the straight-line program solves at each substep, and those needed
    if mode == "substep":
        program = torch.ones((ns, len(per_slot)), dtype=torch.bool)
        needed = active
    else:
        program = ground | (entry & (mode == "step"))
        held_needed = (~ground & active.any(0))[None] & entry[:, :, None] & (mode == "step")
        needed = (ground & active) | held_needed
    spared = B * float((program * cost).sum()) - float((needed * cost).sum())
    spared += n_factor * int((~needed.any(-1)).sum())
    return int(B * per_env - spared)


def _touching(spec: SubstepSpec, q: List) -> torch.Tensor:
    xpos, xquat, _, _ = _fk(spec, q)
    cache = {}
    return torch.stack([
        _ensure_field(_contact_geometry(spec, slot, xpos, xquat, q[0], cache)[0], q[0]) < 0.0
        for slot in spec.slots], 1)


def contacts_touching(spec: SubstepSpec, qpos: torch.Tensor) -> torch.Tensor:
    """``(B, nslot)`` bool: which contacts touch (distance < 0) at these
    ``(B, nq)`` poses, on their device."""
    return _touching(spec, list(qpos.t().contiguous().to(torch.float32).unbind(0)))


def contact_activity(spec: SubstepSpec, qpos: torch.Tensor, qvel: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """``(n_substeps, B, nslot)`` bool: which contacts touch (distance < 0)
    at each substep of one policy step of the plain program from these
    ``(B, K)`` inputs, on their device."""
    q = list(qpos.t().contiguous().to(torch.float32).unbind(0))
    v = list(qvel.t().contiguous().to(torch.float32).unbind(0))
    target = list(u.t().contiguous().to(torch.float32).unbind(0))
    out, held = [], None
    for k in range(spec.n_substeps):
        out.append(_touching(spec, q))
        q, v, _, h = substep(spec, q, v, target, held_self=held)
        if k == 0:
            held = h or None
    return torch.stack(out, 0)

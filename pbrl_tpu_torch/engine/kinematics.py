"""Forward kinematics and velocity kinematics (counterpart of
``pbrl_tpu/engine/kinematics.py``).

pbrl_tpu walks the body tree one body and one joint at a time per env and
vmaps the walk. Here the bodies of one tree level go together: a level's
entry frames come from its parents in one gather, and its k-th joints
compose in one batched quaternion product for every k. A body with fewer
joints composes the identity at the missing slots (an exact no-op), so
every step is a whole-level tensor operation. The per-joint arithmetic is
pbrl_tpu's: ``bq <- bq (x) q_local``, hinge anchors ``bp + R(bq) jnt_pos``,
slides ``bp + R(bq) axis * q``. The motion subspace (nv, 6) about the root
body's position comes out of the same pass; CRBA, RNEA and the contact
Jacobians reuse it.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from pbrl_tpu_torch.engine.data import Data, model_cache
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.maths.numeric import matmul
from pbrl_tpu_torch.maths.spatial import cross
from pbrl_tpu_torch.model.spec import JointType, Model


@dataclasses.dataclass
class _Slot:
    """The k-th joints of one level's bodies (identity where a body has
    fewer than k + 1 joints)."""

    angle_idx: torch.Tensor   # (n,) qpos index of a hinge's angle; nq (a zero) otherwise
    axis: torch.Tensor        # (n, 3) joint axis; 0 where no joint
    hinge_axis: torch.Tensor  # (n, 3) axis of hinges, 0 elsewhere (identity rotation)
    jpos: torch.Tensor        # (n, 3) hinge anchor in the body frame
    has_jpos: bool
    slide: torch.Tensor       # (n, 1) 1.0 for a slide joint
    slide_idx: torch.Tensor   # (n,) qpos index of a slide's offset; nq otherwise
    has_slide: bool


@dataclasses.dataclass
class _Level:
    parent_pos: torch.Tensor  # (n,) parents' places in the level-order body list
    body_pos: torch.Tensor    # (n, 3)
    body_quat: torch.Tensor   # (n, 4)
    free_rows: torch.Tensor   # (nf,) rows of bodies with a free joint
    free_all: bool
    free_qadr: torch.Tensor   # (nf,) their qpos addresses
    slots: List[_Slot]


@dataclasses.dataclass
class _Plan:
    levels: List[_Level]
    body_perm: torch.Tensor   # level order -> body order
    dof_perm: torch.Tensor    # rows of the per-level axis lists -> dof order
    linear: torch.Tensor      # (nv,) bool: translational dof
    free_lin: torch.Tensor    # (3 nf_total, 3) free joints' world translation axes
    body_ipos: torch.Tensor
    site_body: torch.Tensor
    site_pos: torch.Tensor
    geom_body: torch.Tensor
    geom_world: torch.Tensor  # (ngeom, 1) bool
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    ancestor_mask: torch.Tensor


def _build_plan(model: Model, device) -> _Plan:
    nb = model.nbody
    f32 = dict(dtype=torch.float32, device=device)
    joints_of = [[] for _ in range(nb)]
    for j in range(model.njnt):
        joints_of[model.jnt_bodyid[j]].append(j)
    depth = []
    for b in range(nb):
        p = model.body_parent[b]
        depth.append(0 if p == -1 else depth[p] + 1)
    by_level = [[b for b in range(nb) if depth[b] == d] for d in range(max(depth) + 1)]
    order = [b for lv in by_level for b in lv]
    place = {b: i for i, b in enumerate(order)}

    levels, row_dofs, linear = [], [], np.zeros(model.nv, bool)
    free_lin_dofs, free_lin = [], []
    for bodies in by_level:
        free = [i for i, b in enumerate(bodies)
                if joints_of[b] and model.jnt_type[joints_of[b][0]] == JointType.FREE]
        for i in free:
            b = bodies[i]
            if model.body_parent[b] != -1 or len(joints_of[b]) != 1:
                raise NotImplementedError("a free joint must be the only joint of a "
                                          "body attached to the world")
        for i in free:
            da = model.jnt_dofadr[joints_of[bodies[i]][0]]
            for k in range(3):
                free_lin_dofs.append(da + k)
                free_lin.append(np.eye(3)[k])
                linear[da + k] = True
        for i in free:  # rotational free dofs: rows of the free-joint block
            da = model.jnt_dofadr[joints_of[bodies[i]][0]]
            row_dofs.extend([da + 3 + k for k in range(3)])
        slots = []
        nslot = max((len(joints_of[b]) for i, b in enumerate(bodies) if i not in free),
                    default=0)
        for k in range(nslot):
            angle_idx, axis, hinge_axis, jpos, slide, slide_idx = [], [], [], [], [], []
            for i, b in enumerate(bodies):
                js = [] if i in free else joints_of[b]
                if k >= len(js):
                    angle_idx.append(model.nq)
                    axis.append(np.zeros(3))
                    hinge_axis.append(np.zeros(3))
                    jpos.append(np.zeros(3))
                    slide.append(0.0)
                    slide_idx.append(model.nq)
                    row_dofs.append(-1)
                    continue
                j = js[k]
                jt = model.jnt_type[j]
                if jt not in (JointType.HINGE, JointType.SLIDE):
                    raise ValueError(f"unsupported joint type {jt}")
                is_hinge = jt == JointType.HINGE
                qa = model.jnt_qposadr[j]
                angle_idx.append(qa if is_hinge else model.nq)
                axis.append(model.jnt_axis[j])
                hinge_axis.append(model.jnt_axis[j] if is_hinge else np.zeros(3))
                jpos.append(model.jnt_pos[j] if is_hinge else np.zeros(3))
                slide.append(0.0 if is_hinge else 1.0)
                slide_idx.append(model.nq if is_hinge else qa)
                row_dofs.append(model.jnt_dofadr[j])
                linear[model.jnt_dofadr[j]] = not is_hinge
            jpos = np.asarray(jpos, np.float32)
            slides = np.asarray(slide, np.float32)
            slots.append(_Slot(
                angle_idx=torch.tensor(angle_idx, device=device),
                axis=torch.as_tensor(np.asarray(axis, np.float32), **f32),
                hinge_axis=torch.as_tensor(np.asarray(hinge_axis, np.float32), **f32),
                jpos=torch.as_tensor(jpos, **f32), has_jpos=bool(np.any(jpos != 0)),
                slide=torch.as_tensor(slides[:, None], **f32),
                slide_idx=torch.tensor(slide_idx, device=device),
                has_slide=bool(np.any(slides))))
        levels.append(_Level(
            parent_pos=torch.tensor([place.get(model.body_parent[b], 0) for b in bodies],
                                    device=device),
            body_pos=torch.as_tensor(model.body_pos[bodies], **f32),
            body_quat=torch.as_tensor(model.body_quat[bodies], **f32),
            free_rows=torch.tensor(free, device=device, dtype=torch.long),
            free_all=len(free) == len(bodies),
            free_qadr=torch.tensor([model.jnt_qposadr[joints_of[bodies[i]][0]] for i in free],
                                   device=device, dtype=torch.long),
            slots=slots))
    rows = free_lin_dofs + row_dofs
    where = {d: r for r, d in enumerate(rows) if d >= 0}
    if sorted(where) != list(range(model.nv)):
        raise ValueError("every dof needs exactly one motion axis")
    gb = np.asarray(model.geom_bodyid)
    return _Plan(
        levels=levels,
        body_perm=torch.tensor([place[b] for b in range(nb)], device=device),
        dof_perm=torch.tensor([where[d] for d in range(model.nv)], device=device),
        linear=torch.as_tensor(linear, device=device),
        free_lin=torch.as_tensor(np.asarray(free_lin, np.float32).reshape(-1, 3), **f32),
        body_ipos=torch.as_tensor(model.body_ipos, **f32),
        site_body=torch.tensor(model.site_bodyid, device=device, dtype=torch.long),
        site_pos=torch.as_tensor(model.site_pos, **f32),
        geom_body=torch.as_tensor(np.maximum(gb, 0), device=device),
        geom_world=torch.as_tensor(gb < 0, device=device)[:, None],
        geom_pos=torch.as_tensor(model.geom_pos, **f32),
        geom_quat=torch.as_tensor(model.geom_quat, **f32),
        ancestor_mask=torch.as_tensor(model.ancestor_mask, **f32),
    )


def plan(model: Model, device) -> _Plan:
    return model_cache(model, device, "kinematics", lambda: _build_plan(model, device))


def kinematics(model: Model, data: Data) -> Data:
    """Compute xpos/xquat/xipos/ximat, site and geom poses and the dof
    motion subspace from ``data.qpos``."""
    qpos = data.qpos
    B = qpos.shape[0]
    pl = plan(model, qpos.device)
    qpad = torch.cat([qpos, qpos.new_zeros(B, 1)], dim=1)  # index nq reads 0
    all_q, all_p = None, None
    s_ang, s_anchor = [], []
    if pl.free_lin.shape[0]:
        s_ang.append(qpos.new_zeros(B, pl.free_lin.shape[0], 3))
        s_anchor.append(pl.free_lin.expand(B, -1, 3))
    for li, lv in enumerate(pl.levels):
        n = lv.body_pos.shape[0]
        if li == 0:  # parent is the world: the body's own frame, exactly
            bq = lv.body_quat.expand(B, n, 4)
            bp = lv.body_pos.expand(B, n, 3)
        else:
            pq, pp = all_q[:, lv.parent_pos], all_p[:, lv.parent_pos]
            bq = quat.mul_fused(pq, lv.body_quat)
            bp = pp + quat.rotate(pq, lv.body_pos)
        if lv.free_rows.numel():
            fq = quat.normalize(qpos[:, lv.free_qadr[:, None] + torch.arange(
                3, 7, device=qpos.device)])
            fp_ = qpos[:, lv.free_qadr[:, None] + torch.arange(3, device=qpos.device)]
            if lv.free_all:
                bq, bp = fq, fp_
            else:
                bq = bq.index_copy(1, lv.free_rows, fq)
                bp = bp.index_copy(1, lv.free_rows, fp_)
            # body-frame angular axes of the free joints: R(bq) e_k
            eye = torch.eye(3, dtype=qpos.dtype, device=qpos.device)
            s_ang.append(quat.rotate(fq[:, :, None, :], eye).reshape(B, -1, 3))
            s_anchor.append(fp_[:, :, None, :].expand(B, -1, 3, 3).reshape(B, -1, 3))
        for sl in lv.slots:
            axis_w = quat.rotate(bq, sl.axis)
            anchor = bp + quat.rotate(bq, sl.jpos) if sl.has_jpos else bp
            ql = quat.from_axis_angle(sl.hinge_axis, qpad[:, sl.angle_idx])
            bq_new = quat.mul_fused(bq, ql)
            if sl.has_jpos:
                bp = anchor - quat.rotate(bq_new, sl.jpos)
            if sl.has_slide:
                bp = bp + axis_w * qpad[:, sl.slide_idx, None]
                s_ang.append(axis_w * (1.0 - sl.slide))
                s_anchor.append(torch.where(sl.slide > 0, axis_w, anchor))
            else:
                s_ang.append(axis_w)
                s_anchor.append(anchor)
            bq = bq_new
        xq, xp = quat.normalize(bq), bp
        all_q = xq if all_q is None else torch.cat([all_q, xq], dim=1)
        all_p = xp if all_p is None else torch.cat([all_p, xp], dim=1)
    xquat = all_q[:, pl.body_perm]
    xpos = all_p[:, pl.body_perm]
    origin = xpos[:, 0]  # root body position: reference point of the spatial math

    ang = torch.cat(s_ang, dim=1)[:, pl.dof_perm]
    anchor = torch.cat(s_anchor, dim=1)[:, pl.dof_perm]
    rot_rows = torch.cat([ang, cross(anchor - origin[:, None], ang)], dim=-1)
    lin_rows = torch.cat([torch.zeros_like(anchor), anchor], dim=-1)
    subspace = torch.where(pl.linear[:, None], lin_rows, rot_rows)

    ximat = quat.to_matrix(xquat)
    xipos = xpos + quat.rotate(xquat, pl.body_ipos)
    if model.nsite:
        site_xpos = xpos[:, pl.site_body] + quat.rotate(xquat[:, pl.site_body], pl.site_pos)
    else:
        site_xpos = qpos.new_zeros(B, 0, 3)
    gq = xquat[:, pl.geom_body]
    gxpos = torch.where(pl.geom_world, pl.geom_pos,
                        xpos[:, pl.geom_body] + quat.rotate(gq, pl.geom_pos))
    gxquat = torch.where(pl.geom_world, pl.geom_quat, quat.mul_fused(gq, pl.geom_quat))
    return data.replace(origin=origin, xpos=xpos, xquat=xquat, xipos=xipos, ximat=ximat,
                        site_xpos=site_xpos, geom_xpos=gxpos, geom_xquat=gxquat,
                        subspace=subspace)


def com_velocity(model: Model, data: Data) -> Data:
    """Body spatial velocities ``cvel[b] = sum_i anc[b, i] S_i qvel_i``."""
    anc = plan(model, data.qpos.device).ancestor_mask
    weighted = anc * data.qvel[:, None, :]  # (B, nb, nv)
    return data.replace(cvel=matmul(weighted, data.subspace))


def body_velocity(model: Model, data: Data, body_id: int) -> torch.Tensor:
    """(B, 6) [angular, linear at the body origin] world velocity of one body."""
    v = data.cvel[:, body_id]
    lin = v[:, 3:] + cross(v[:, :3], data.xpos[:, body_id] - data.origin)
    return torch.cat([v[:, :3], lin], dim=-1)


def point_velocities(data: Data, body_ids, points: torch.Tensor) -> torch.Tensor:
    """(B, n, 3) linear world velocities of ``points`` (B, n, 3) on bodies
    ``body_ids`` (n,)."""
    v = data.cvel[:, torch.as_tensor(body_ids, device=points.device)]
    return v[..., 3:] + cross(v[..., :3], points - data.origin[:, None])

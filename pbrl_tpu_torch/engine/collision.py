"""Contact generation: static candidate pairs -> fixed-size Contact slots.

Counterpart of ``pbrl_tpu/engine/collision.py``. The candidate pairs are
fixed when the model is compiled; they are grouped by type signature, and
each group is one vectorised narrow phase over the env batch and the
group's pairs. The slot count is a static function of the model
(``ncon_max``) and the slot order is pbrl_tpu's (plane groups, then
geom-geom groups, each sorted by type). Narrow phases: plane against
sphere, capsule (its two end spheres) and box (its 8 corners);
sphere-sphere, sphere-capsule, sphere-box, capsule-capsule, capsule-box
(two-pass closest-point refinement) and box-box (the 8 corners of each box
probed against the other, 16 slots per pair).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from pbrl_tpu_torch.engine.data import Contact, Data, model_cache
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.maths.numeric import safe_norm
from pbrl_tpu_torch.maths.spatial import cross
from pbrl_tpu_torch.model.spec import GeomType, Model

# All 8 corners per box-plane pair, as the field program and the kernel.
_BOX_CORNERS_PER_CONTACT = 8
_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                    np.float32)


def _pair_groups(model: Model):
    """Static grouping of candidate pairs by (type1, type2) signature."""
    groups = {}
    for g1, g2 in zip(model.pair_geom1, model.pair_geom2):
        groups.setdefault((model.geom_type[g1], model.geom_type[g2]), []).append((g1, g2))
    return groups


def _plane_groups(model: Model):
    groups = {}
    for gp, go in zip(model.plane_geom, model.plane_other):
        groups.setdefault(model.geom_type[go], []).append((gp, go))
    return groups


def plane_contact_count(t: int) -> int:
    """Contacts emitted per plane-geom pair of geom type ``t``."""
    return {GeomType.SPHERE: 1, GeomType.CAPSULE: 2,
            GeomType.BOX: _BOX_CORNERS_PER_CONTACT}[t]


def pair_contact_count(t1: int, t2: int) -> int:
    """Contacts emitted per geom-geom pair (box-box: 8 corners each way)."""
    return 16 if (t1, t2) == (GeomType.BOX, GeomType.BOX) else 1


def ncon_max(model: Model) -> int:
    """Static maximum contact count for this model."""
    n = 0
    for t, pairs in _plane_groups(model).items():
        n += plane_contact_count(t) * len(pairs)
    for (t1, t2), pairs in _pair_groups(model).items():
        n += pair_contact_count(t1, t2) * len(pairs)
    return n


# ---------------------------------------------------------------------------
# Primitive helpers (vectorised over leading axes)
# ---------------------------------------------------------------------------


def _make_frame(normal: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) orthonormal frame rows [n, t1, t2] from unit normals."""
    ex = normal.new_tensor([1.0, 0.0, 0.0])
    ey = normal.new_tensor([0.0, 1.0, 0.0])
    ref = torch.where(torch.abs(normal[..., 0:1]) < 0.5, ex, ey)
    t1 = cross(normal, ref)
    t1 = t1 / torch.clamp(safe_norm(t1, dim=-1, keepdim=True), min=1e-12)
    t2 = cross(normal, t1)
    return torch.stack([normal, t1, t2], dim=-2)


def _sphere_sphere(c1, r1, c2, r2):
    """(dist, pos, normal) for point-sphere pairs; normal 1 -> 2."""
    d = c2 - c1
    ln = safe_norm(d, dim=-1, keepdim=True)
    n = d / torch.clamp(ln, min=1e-9)
    dist = ln[..., 0] - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


def _closest_on_segment(a, b, p):
    """Closest point to ``p`` on segment ``a``-``b``."""
    ab = b - a
    t = torch.sum((p - a) * ab, dim=-1) / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)
    return a + torch.clamp(t, 0.0, 1.0)[..., None] * ab


def _segment_segment(p1, q1, p2, q2):
    """Closest points between two segments (Ericson, branchless clamped)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12, (b * f - c * e) / torch.clamp(denom, min=1e-12),
                    torch.zeros_like(denom))
    s = torch.clamp(s, 0.0, 1.0)
    t = (b * s + f) / torch.clamp(e, min=1e-12)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
    return p1 + s[..., None] * d1, p2 + t_cl[..., None] * d2


def _point_box(p_local, half):
    """Closest point on a box (local frame) to p, interior points included:
    (closest_local, normal_local, signed distance to the surface)."""
    clamped = torch.clamp(p_local, -half, half)
    delta = p_local - clamped
    out_d = safe_norm(delta, dim=-1)  # delta is exactly zero for interior points
    outside = out_d > 1e-9
    n_out = delta / torch.clamp(out_d, min=1e-9)[..., None]
    face_gap = half - torch.abs(p_local)  # >= 0 inside
    k = torch.argmin(face_gap, dim=-1)
    sgn = torch.sign(torch.gather(p_local, -1, k[..., None]))[..., 0]
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    n_in = F.one_hot(k, 3).to(p_local.dtype) * sgn[..., None]
    gap_in = torch.gather(face_gap, -1, k[..., None])[..., 0]
    closest_in = p_local + n_in * gap_in[..., None]
    normal = torch.where(outside[..., None], n_out, n_in)
    closest = torch.where(outside[..., None], clamped, closest_in)
    dist = torch.where(outside, out_d, -gap_in)
    return closest, normal, dist


def _capsule_ends(pos, q, hh):
    axis = quat.rotate(q, pos.new_tensor([0.0, 0.0, 1.0]))
    return pos - axis * hh[..., None], pos + axis * hh[..., None]


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Group:
    kind: tuple               # ("plane", t) or ("pair", t1, t2)
    ids1: torch.Tensor        # (n,) geom ids (the plane for plane groups)
    ids2: torch.Tensor
    size1: torch.Tensor       # (n, 3)
    size2: torch.Tensor


@dataclasses.dataclass
class _Tables:
    groups: List[_Group]
    corners: torch.Tensor     # (8, 3)
    friction: torch.Tensor    # (ncon,)
    margin: torch.Tensor      # (ncon,)
    body1: torch.Tensor       # (ncon,) long
    body2: torch.Tensor


def _build_tables(model: Model, device) -> _Tables:
    f32 = dict(dtype=torch.float32, device=device)
    gbody = model.geom_bodyid
    groups, fric, marg, b1s, b2s = [], [], [], [], []

    def add(kind, pairs, per):
        ids1 = [a for a, _ in pairs]
        ids2 = [b for _, b in pairs]
        groups.append(_Group(kind=kind, ids1=torch.tensor(ids1, device=device),
                             ids2=torch.tensor(ids2, device=device),
                             size1=torch.as_tensor(model.geom_size[ids1], **f32),
                             size2=torch.as_tensor(model.geom_size[ids2], **f32)))
        for a, b in pairs:
            for _ in range(per):
                fric.append(max(model.geom_friction[a], model.geom_friction[b]))
                marg.append(max(model.geom_margin[a], model.geom_margin[b]))
                b1s.append(gbody[a])
                b2s.append(gbody[b])

    for t, pairs in sorted(_plane_groups(model).items()):
        if t not in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.BOX):
            raise NotImplementedError(f"plane vs geom type {t}")
        add(("plane", t), pairs, plane_contact_count(t))
    supported = {(GeomType.SPHERE, GeomType.SPHERE), (GeomType.SPHERE, GeomType.CAPSULE),
                 (GeomType.SPHERE, GeomType.BOX), (GeomType.CAPSULE, GeomType.CAPSULE),
                 (GeomType.CAPSULE, GeomType.BOX), (GeomType.BOX, GeomType.BOX)}
    for (t1, t2), pairs in sorted(_pair_groups(model).items()):
        if (t1, t2) not in supported:
            raise NotImplementedError(f"pair {t1} vs {t2}")
        add(("pair", t1, t2), pairs, pair_contact_count(t1, t2))
    return _Tables(groups=groups, corners=torch.as_tensor(_CORNERS, **f32),
                   friction=torch.as_tensor(np.asarray(fric, np.float32), **f32),
                   margin=torch.as_tensor(np.asarray(marg, np.float32), **f32),
                   body1=torch.tensor(b1s, dtype=torch.long, device=device),
                   body2=torch.tensor(b2s, dtype=torch.long, device=device))


def tables(model: Model, device) -> _Tables:
    return model_cache(model, device, "collision", lambda: _build_tables(model, device))


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------


def _narrow(g: _Group, gxpos, gxquat, corners):
    """(dist (B, n*per), pos (B, n*per, 3), normal (B, n*per, 3)) of one group."""
    B = gxpos.shape[0]
    p1, q1 = gxpos[:, g.ids1], gxquat[:, g.ids1]
    p2, q2 = gxpos[:, g.ids2], gxquat[:, g.ids2]
    s1, s2 = g.size1, g.size2
    flat = lambda *xs: tuple(x.reshape(B, -1, *x.shape[3:]) for x in xs)
    if g.kind[0] == "plane":
        # normal points plane -> geom (body1 = the plane's)
        t = g.kind[1]
        n = quat.rotate(q1, p1.new_tensor([0.0, 0.0, 1.0]))
        if t == GeomType.SPHERE:
            r = s2[:, 0]
            dist = torch.sum(n * (p2 - p1), dim=-1) - r
            return dist, p2 - n * (r + 0.5 * dist)[..., None], n
        if t == GeomType.CAPSULE:
            e0, e1 = _capsule_ends(p2, q2, s2[:, 1])
            ends = torch.stack([e0, e1], dim=2)  # (B, n, 2, 3)
            r = s2[:, 0, None]
            dist = torch.sum(n[:, :, None] * (ends - p1[:, :, None]), dim=-1) - r
            pos = ends - n[:, :, None] * (r + 0.5 * dist)[..., None]
            return flat(dist, pos, n[:, :, None].expand_as(ends))
        cw = p2[:, :, None] + quat.rotate(q2[:, :, None], corners * s2[:, None])
        dist = torch.sum(n[:, :, None] * (cw - p1[:, :, None]), dim=-1)  # (B, n, 8)
        pos = cw - n[:, :, None] * (0.5 * dist)[..., None]
        return flat(dist, pos, n[:, :, None].expand_as(cw))
    t1, t2 = g.kind[1:]
    if (t1, t2) == (GeomType.SPHERE, GeomType.SPHERE):
        return _sphere_sphere(p1, s1[:, 0], p2, s2[:, 0])
    if (t1, t2) == (GeomType.SPHERE, GeomType.CAPSULE):
        e0, e1 = _capsule_ends(p2, q2, s2[:, 1])
        return _sphere_sphere(p1, s1[:, 0], _closest_on_segment(e0, e1, p1), s2[:, 0])
    if (t1, t2) == (GeomType.SPHERE, GeomType.BOX):
        closest_l, n_l, d = _point_box(quat.rotate_inv(q2, p1 - p2), s2)
        dist = d - s1[:, 0]
        n = -quat.rotate(q2, n_l)  # 1 -> 2
        return dist, p2 + quat.rotate(q2, closest_l) - n * (0.5 * dist)[..., None], n
    if (t1, t2) == (GeomType.CAPSULE, GeomType.CAPSULE):
        a0, a1 = _capsule_ends(p1, q1, s1[:, 1])
        b0, b1 = _capsule_ends(p2, q2, s2[:, 1])
        cp1, cp2 = _segment_segment(a0, a1, b0, b1)
        return _sphere_sphere(cp1, s1[:, 0], cp2, s2[:, 0])
    if (t1, t2) == (GeomType.CAPSULE, GeomType.BOX):
        # segment point nearest the box centre, clamped to the box, then
        # re-projected on the segment (two-pass refinement)
        a0, a1 = _capsule_ends(p1, q1, s1[:, 1])
        cp = _closest_on_segment(a0, a1, p2)
        closest_l, _, _ = _point_box(quat.rotate_inv(q2, cp - p2), s2)
        cp = _closest_on_segment(a0, a1, p2 + quat.rotate(q2, closest_l))
        closest_l, n_l, d = _point_box(quat.rotate_inv(q2, cp - p2), s2)
        dist = d - s1[:, 0]
        n = -quat.rotate(q2, n_l)
        return dist, p2 + quat.rotate(q2, closest_l) - n * (0.5 * dist)[..., None], n

    def corner_probe(pc, qc, sc, pb, qb, sb):
        """Corners of box c (B, n, 8) against box b; normal box b -> corner."""
        cw = pc[:, :, None] + quat.rotate(qc[:, :, None], corners * sc[:, None])
        p_loc = quat.rotate_inv(qb[:, :, None], cw - pb[:, :, None])
        closest_l, n_l, d = _point_box(p_loc, sb[:, None])
        n_w = quat.rotate(qb[:, :, None], n_l)
        surf = pb[:, :, None] + quat.rotate(qb[:, :, None], closest_l)
        return d, surf + n_w * (0.5 * d)[..., None], n_w

    d12, pos12, nw12 = corner_probe(p1, q1, s1, p2, q2, s2)  # normal 2 -> 1
    d21, pos21, nw21 = corner_probe(p2, q2, s2, p1, q1, s1)  # normal 1 -> 2
    return flat(torch.cat([d12, d21], dim=2), torch.cat([pos12, pos21], dim=2),
                torch.cat([-nw12, nw21], dim=2))


def collide(model: Model, data: Data) -> Data:
    """Fill ``data.contact`` with every candidate contact slot."""
    tb = tables(model, data.qpos.device)
    if not tb.groups:
        return data
    dists, poss, normals = [], [], []
    for g in tb.groups:
        d, p, n = _narrow(g, data.geom_xpos, data.geom_xquat, tb.corners)
        dists.append(d)
        poss.append(p)
        normals.append(n)
    pos = torch.cat(poss, dim=1)
    contact = Contact(
        dist=torch.cat(dists, dim=1), pos=pos, frame=_make_frame(torch.cat(normals, dim=1)),
        friction=tb.friction, includemargin=tb.margin, body1=tb.body1, body2=tb.body2,
        force=torch.zeros_like(pos))
    return data.replace(contact=contact)

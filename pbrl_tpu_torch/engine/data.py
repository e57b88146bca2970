"""Simulation state (``Data``) of a batch of environments.

Counterpart of ``pbrl_tpu/engine/data.py``. pbrl_tpu's ``Data`` holds one
env and is batched by ``jax.vmap``; here every field carries a leading env
axis B. The contact layout is static per model, so ``Contact.body1``,
``body2``, ``friction`` and ``includemargin`` are per-slot tensors (ncon,)
shared by the batch.
"""

from __future__ import annotations

import dataclasses

import torch

from pbrl_tpu_torch.model.spec import Model


@dataclasses.dataclass(frozen=True)
class Contact:
    """Fixed-size set of candidate contact slots (inactive slots have
    ``dist >= includemargin`` and are masked by the solver)."""

    dist: torch.Tensor           # (B, ncon) signed gap (negative = penetration)
    pos: torch.Tensor            # (B, ncon, 3) world contact point
    frame: torch.Tensor          # (B, ncon, 3, 3) rows [normal, tangent1, tangent2]
    friction: torch.Tensor       # (ncon,) tangential friction coefficient
    includemargin: torch.Tensor  # (ncon,)
    body1: torch.Tensor          # (ncon,) int64, -1 = world
    body2: torch.Tensor          # (ncon,) int64
    force: torch.Tensor          # (B, ncon, 3) solved force in the contact frame

    @property
    def active(self) -> torch.Tensor:
        return self.dist < self.includemargin

    def replace(self, **kw) -> "Contact":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Data:
    """State and derived caches of B environments."""

    # integrated state
    qpos: torch.Tensor          # (B, nq)
    qvel: torch.Tensor          # (B, nv)
    time: torch.Tensor          # (B,)
    ctrl: torch.Tensor          # (B, nu)
    qfrc_applied: torch.Tensor  # (B, nv) user-injected generalized force
    imp_damping: torch.Tensor   # (B, nv) extra implicit damping of the
                                # integrator's (M + h diag(.)) solve (implicit PD)
    # kinematics cache
    origin: torch.Tensor        # (B, 3) reference point of the spatial quantities
                                # (the root body's position)
    xpos: torch.Tensor          # (B, nbody, 3)
    xquat: torch.Tensor         # (B, nbody, 4)
    xipos: torch.Tensor         # (B, nbody, 3) body centre of mass
    ximat: torch.Tensor         # (B, nbody, 3, 3)
    site_xpos: torch.Tensor     # (B, nsite, 3)
    geom_xpos: torch.Tensor     # (B, ngeom, 3)
    geom_xquat: torch.Tensor    # (B, ngeom, 4)
    subspace: torch.Tensor      # (B, nv, 6) motion axes about ``origin``
    cvel: torch.Tensor          # (B, nbody, 6) body spatial velocity
    # dynamics cache
    qM: torch.Tensor            # (B, nv, nv) mass matrix (with armature)
    qfrc_bias: torch.Tensor     # (B, nv) Coriolis, centrifugal and gravity
    qfrc_passive: torch.Tensor  # (B, nv) damping
    qfrc_actuator: torch.Tensor  # (B, nv)
    qfrc_constraint: torch.Tensor  # (B, nv) contact and limit forces
    qacc: torch.Tensor          # (B, nv)
    contact: Contact

    def replace(self, **kw) -> "Data":
        return dataclasses.replace(self, **kw)


def _zero_contact(model: Model, B: int, device) -> Contact:
    from pbrl_tpu_torch.engine import collision

    ncon = collision.ncon_max(model)
    z = dict(dtype=torch.float32, device=device)
    return Contact(
        dist=torch.full((B, ncon), 1e10, **z),
        pos=torch.zeros((B, ncon, 3), **z),
        frame=torch.eye(3, **z).expand(B, ncon, 3, 3).clone(),
        friction=torch.ones((ncon,), **z),
        includemargin=torch.zeros((ncon,), **z),
        body1=torch.zeros((ncon,), dtype=torch.long, device=device),
        body2=torch.zeros((ncon,), dtype=torch.long, device=device),
        force=torch.zeros((B, ncon, 3), **z),
    )


def make_data(model: Model, qpos=None, qvel=None, *, batch_size: int = 1,
              device=None) -> Data:
    """Fresh Data at ``qpos`` (B, nq), by default the model's reference pose.

    B and the device come from ``qpos`` (else ``qvel``) when given, else
    from ``batch_size`` and ``device`` (default ``cuda``)."""
    given = qpos if qpos is not None else qvel
    if given is not None:
        B, device = given.shape[0], given.device
    else:
        B, device = batch_size, torch.device(device or "cuda")
    z = dict(dtype=torch.float32, device=device)
    nb, nv = model.nbody, model.nv
    if qpos is None:
        qpos = torch.as_tensor(model.qpos0, **z).expand(B, model.nq).clone()
    if qvel is None:
        qvel = torch.zeros((B, nv), **z)
    unit = torch.tensor([1.0, 0.0, 0.0, 0.0], **z)
    return Data(
        qpos=qpos.to(torch.float32), qvel=qvel.to(torch.float32),
        time=torch.zeros((B,), **z), ctrl=torch.zeros((B, model.nu), **z),
        qfrc_applied=torch.zeros((B, nv), **z), imp_damping=torch.zeros((B, nv), **z),
        origin=torch.zeros((B, 3), **z), xpos=torch.zeros((B, nb, 3), **z),
        xquat=unit.expand(B, nb, 4).clone(), xipos=torch.zeros((B, nb, 3), **z),
        ximat=torch.eye(3, **z).expand(B, nb, 3, 3).clone(),
        site_xpos=torch.zeros((B, model.nsite, 3), **z),
        geom_xpos=torch.zeros((B, model.ngeom, 3), **z),
        geom_xquat=unit.expand(B, model.ngeom, 4).clone(),
        subspace=torch.zeros((B, nv, 6), **z), cvel=torch.zeros((B, nb, 6), **z),
        qM=torch.zeros((B, nv, nv), **z), qfrc_bias=torch.zeros((B, nv), **z),
        qfrc_passive=torch.zeros((B, nv), **z), qfrc_actuator=torch.zeros((B, nv), **z),
        qfrc_constraint=torch.zeros((B, nv), **z), qacc=torch.zeros((B, nv), **z),
        contact=_zero_contact(model, B, device),
    )


def model_cache(model: Model, device, name: str, build):
    """``build()`` once per model, device and ``name``: the engine's index
    and constant tensors are made when a model first meets a device, not on
    every call. The cache lives on the model object, so a model made by
    ``Model.replace`` starts with an empty one."""
    cache = model.__dict__.get("_engine_cache")
    if cache is None:
        cache = {}
        object.__setattr__(model, "_engine_cache", cache)
    key = (name, str(torch.device(device)))
    if key not in cache:
        cache[key] = build()
    return cache[key]

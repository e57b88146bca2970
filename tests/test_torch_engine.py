"""The port's einsum engine against pbrl_tpu's, stage by stage, and
against the port's own field program.

pbrl_tpu's engine runs vmapped and jitted one stage at a time (a jitted
whole humanoid step costs tens of seconds of XLA compile on the CPU; the
step and ``step_n`` are held in tests/test_torch_engine_step*.py). Each
port stage gets pbrl_tpu's input ``Data`` (converted), so a stage is held
alone. Inputs: humanoid poses at numpy-seeded joint noise (0.3 rad),
velocities (0.5), walk reference states with RSI-like noise, one env
lifted +1 m, a tilted root; the sphere scene.

Tolerances (float32 rounding; the products sum in another order):
kinematics 1e-6 absolute; collide 1e-6 on dist and pos, 2e-6 on the
frames of the active rows; ``com_velocity``, ``crba`` and ``rnea_bias``
1e-6 of each output's largest entry; contact forces and the Delassus
masses 2e-5 of the largest entry (the stiff contacts' 1/(J M^-1 J^T)
amplifies rounding); the engine against the field program as
tests/test_field_physics.py holds pbrl_tpu's: one substep qpos 1e-6, qvel
2e-4, four substeps qpos 1e-5, FK 1e-5.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbrl_tpu.engine  # noqa: F401
import pbrl_tpu_torch.engine  # noqa: F401
from pbrl_tpu.engine import data as jdata
from pbrl_tpu.engine import dynamics as jdyn
from pbrl_tpu.engine import kinematics as jkin
from pbrl_tpu.engine import solver as jsol
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu.model import sphere_model as j_sphere
from pbrl_tpu_torch.control import default_gains, implicit_pd
from pbrl_tpu_torch.engine import collision, dynamics, kinematics, solver
from pbrl_tpu_torch.engine.data import Contact, Data, make_data
from pbrl_tpu_torch.mocap.skeleton import generate_kp_kd_gains
from pbrl_tpu_torch.model import humanoid_model, sphere_model
from pbrl_tpu_torch.ops import field_physics as fp

jfwd = sys.modules["pbrl_tpu.engine.forward"]
tfwd = sys.modules["pbrl_tpu_torch.engine.forward"]


def humanoid_states(B=4, seed=0, nu=28):
    """(qpos, qvel, target) float32. Even envs: walk reference states at
    numpy-seeded phases with RSI-like noise (joints 0.05, velocities 0.5);
    odd envs: the model's reference pose with joint noise 0.3 (into the
    joint limits) and velocities 0.5. Env 1 is lifted +1 m, env 2's root
    tilted."""
    from pbrl_tpu_torch.mocap import load_clip, reference_state

    m = humanoid_model()
    rng = np.random.default_rng(seed)
    clip = load_clip("walk", device="cpu")
    t = torch.as_tensor(rng.uniform(0.0, float(clip.cycle_time), B), dtype=torch.float32)
    ref_q, ref_v = (x.double().numpy() for x in reference_state(clip, t))
    qpos = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
    qpos[:, 2] = 0.85
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, m.nq - 7))
    qvel = rng.normal(size=(B, m.nv)) * 0.5
    even = np.arange(B) % 2 == 0
    qpos[even] = ref_q[even]
    qpos[even, 7:] += rng.normal(size=(even.sum(), m.nq - 7)) * 0.05
    qvel[even] += ref_v[even]
    if B > 1:
        qpos[1, 2] += 1.0
    if B > 2:
        qpos[2, 3:7] = [np.cos(0.2), np.sin(0.2), 0.0, 0.0]
    target = rng.uniform(-0.3, 0.3, (B, nu))
    return tuple(x.astype(np.float32) for x in (qpos, qvel, target))


def to_torch(jd) -> Data:
    """A port ``Data`` holding a batched pbrl_tpu ``Data``'s arrays."""
    t = lambda x: torch.from_numpy(np.array(x))
    con = jd.contact
    contact = Contact(dist=t(con.dist), pos=t(con.pos), frame=t(con.frame),
                      friction=t(con.friction[0]), includemargin=t(con.includemargin[0]),
                      body1=t(con.body1[0]).long(), body2=t(con.body2[0]).long(),
                      force=t(con.force))
    return Data(**{f.name: t(getattr(jd, f.name)) for f in dataclasses.fields(Data)
                   if f.name != "contact"}, contact=contact)


def to_jax(td: Data, B: int):
    """A batched pbrl_tpu ``Data`` holding a port ``Data``'s tensors."""
    j = lambda x: jnp.asarray(x.detach().numpy())
    con = td.contact
    rep = lambda x: jnp.tile(j(x)[None], (B,) + (1,) * x.dim())
    contact = jdata.Contact(dist=j(con.dist), pos=j(con.pos), frame=j(con.frame),
                            friction=rep(con.friction), includemargin=rep(con.includemargin),
                            body1=rep(con.body1).astype(jnp.int32),
                            body2=rep(con.body2).astype(jnp.int32), force=j(con.force))
    return jdata.Data(**{f.name: j(getattr(td, f.name)) for f in dataclasses.fields(Data)
                         if f.name != "contact"}, contact=contact)


def scaled(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def humanoid_pair():
    jm, tm = j_humanoid(), humanoid_model()
    qpos, qvel, _ = humanoid_states()

    def one(q, v):
        d = jdata.make_data(jm, qpos=q, qvel=v)
        return jfwd.fwd_velocity(jm, jfwd.fwd_position(jm, d))

    jd = jax.jit(jax.vmap(one))(jnp.asarray(qpos), jnp.asarray(qvel))
    return jm, tm, qpos, qvel, jd


KIN_FIELDS = ("origin", "xpos", "xquat", "xipos", "ximat", "site_xpos", "geom_xpos",
              "geom_xquat", "subspace")


def test_kinematics_matches_jax(humanoid_pair):
    jm, tm, qpos, qvel, jd = humanoid_pair
    td = kinematics.kinematics(tm, make_data(tm, torch.from_numpy(qpos), torch.from_numpy(qvel)))
    for k in KIN_FIELDS:
        np.testing.assert_allclose(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_kinematics_sphere_matches_jax():
    jm, tm = j_sphere(), sphere_model()
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(tm.qpos0), (3, 1))
    qpos[:, 3:7] = rng.normal(size=(3, 4))
    qpos = qpos.astype(np.float32)
    jd = jax.jit(jax.vmap(lambda q: jkin.kinematics(jm, jdata.make_data(jm, qpos=q))))(
        jnp.asarray(qpos))
    td = kinematics.kinematics(tm, make_data(tm, torch.from_numpy(qpos)))
    for k in KIN_FIELDS:
        np.testing.assert_allclose(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_collide_matches_jax(humanoid_pair):
    """On pbrl_tpu's kinematics: every slot's dist and pos, the frames of
    the slots near touching (the frame of a far-apart pair is arbitrary
    under rounding), the static slot tables."""
    jm, tm, qpos, qvel, jd = humanoid_pair
    B = qpos.shape[0]
    td = collision.collide(tm, to_torch(jd))
    jc, tc = jd.contact, td.contact
    assert tc.dist.shape == (B, collision.ncon_max(tm)) == jc.dist.shape
    np.testing.assert_allclose(tc.dist.numpy(), np.asarray(jc.dist), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc.pos.numpy(), np.asarray(jc.pos), atol=1e-6, rtol=0)
    near = np.asarray(jc.dist) < 0.05
    assert near.sum() > 10 and (np.asarray(jc.dist) < 0).sum() > 0
    np.testing.assert_allclose(tc.frame.numpy()[near], np.asarray(jc.frame)[near], atol=2e-6,
                               rtol=0)
    for k in ("friction", "includemargin", "body1", "body2"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k))[0])


def test_inertial_stages_match_jax(humanoid_pair):
    """com_velocity, crba and rnea_bias (and passive) on pbrl_tpu's kinematics."""
    jm, tm, qpos, qvel, jd = humanoid_pair
    td = to_torch(jd)
    scaled(kinematics.com_velocity(tm, td).cvel, jd.cvel, 1e-6)
    scaled(dynamics.crba(tm, td).qM, jd.qM, 1e-6)
    scaled(dynamics.rnea_bias(tm, td).qfrc_bias, jd.qfrc_bias, 1e-6)
    scaled(dynamics.passive(tm, td).qfrc_passive, jd.qfrc_passive, 0.0)
    ctrl = np.random.default_rng(2).uniform(-1, 1, (qpos.shape[0], tm.nu)).astype(np.float32)
    got = dynamics.actuation(tm, td.replace(ctrl=torch.from_numpy(ctrl))).qfrc_actuator
    want = jax.vmap(lambda d, c: jdyn.actuation(jm, d.replace(ctrl=c)).qfrc_actuator)(
        jd, jnp.asarray(ctrl))
    scaled(got, want, 1e-7)


@pytest.mark.parametrize("mode", ["step", "substep", "static"])
def test_contact_forces_match_jax(humanoid_pair, mode):
    """The contact and limit forces, in each self-contact-mass mode, on
    pbrl_tpu's forward data: 'step' with held masses (the masses of a
    perturbed pose) on the self rows, and its entry substep returning
    the fresh masses."""
    jm, tm, qpos, qvel, jd = humanoid_pair
    B = qpos.shape[0]
    jm = jm.replace(option=jm.option.replace(self_contact_mass=mode))
    tm = tm.replace(option=tm.option.replace(self_contact_mass=mode))
    ncon = jd.contact.dist.shape[1]
    held = np.random.default_rng(4).uniform(0.5, 3.0, (B, ncon)).astype(np.float32)

    def one(d, h):
        if mode == "step":
            d1, masses = jsol.constraint_forces(jm, d, held_self=h, use_held=True,
                                                return_masses=True)
            d0 = jsol.constraint_forces(jm, d, held_self=h, use_held=False)
            return d1, masses, d0
        d1, masses = jsol.constraint_forces(jm, d, return_masses=True)
        return d1, masses, d1

    jd1, jmass, jd0 = jax.jit(jax.vmap(one))(jd, jnp.asarray(held))
    td = to_torch(jd)
    hs = torch.from_numpy(held) if mode == "step" else None
    td1, tmass = solver.constraint_forces(tm, td, held_self=hs, use_held=True,
                                          return_masses=True)
    td0 = solver.constraint_forces(tm, td, held_self=hs, use_held=False)
    assert int((np.asarray(jd.contact.dist) < 0).sum()) > 0
    scaled(tmass, jmass, 2e-5)
    scaled(td1.qfrc_constraint, jd1.qfrc_constraint, 2e-5)
    scaled(td1.contact.force, jd1.contact.force, 2e-5)
    scaled(td0.qfrc_constraint, jd0.qfrc_constraint, 2e-5)
    # the limit forces alone (contacts emptied)
    far = td.replace(contact=td.contact.replace(dist=torch.full_like(td.contact.dist, 1.0)))
    lim_t = solver.limit_forces(tm, far.replace(qfrc_constraint=torch.zeros_like(far.qvel)))
    lim_j = jax.vmap(lambda d: jsol.limit_forces(jm, d.replace(
        qfrc_constraint=jnp.zeros_like(d.qvel))))(to_jax(far, B))
    scaled(lim_t.qfrc_constraint, lim_j.qfrc_constraint, 1e-6)
    assert float(lim_t.qfrc_constraint.abs().max()) > 0  # the 0.3 rad noise hits some limits


def test_sphere_free_fall_and_rest():
    """The sphere scene: free fall over 3 substeps (vz = -g h 3 to rtol
    1e-5) and pbrl_tpu's step_n on it; resting on the plane."""
    jm, tm = j_sphere(floor=False), sphere_model(floor=False)
    d = tfwd.step_n(tm, make_data(tm, batch_size=2, device="cpu"), 3)
    h = float(tm.option.timestep)
    np.testing.assert_allclose(d.qvel[:, 2].numpy(), -9.81 * h * 3, rtol=1e-5)
    jd = jax.jit(lambda: jfwd.step_n(jm, jdata.make_data(jm), 3))()
    np.testing.assert_allclose(d.qpos[0].numpy(), np.asarray(jd.qpos), atol=1e-7, rtol=0)
    np.testing.assert_allclose(d.qvel[0].numpy(), np.asarray(jd.qvel), atol=1e-7, rtol=0)
    tm = sphere_model()
    d = make_data(tm, batch_size=1, device="cpu")
    for _ in range(2):
        d = tfwd.step_n(tm, d, 250)
    r = float(tm.geom_size[1, 0])
    assert abs(float(d.qpos[0, 2]) - r) < 5e-3 and float(d.qvel.abs().max()) < 1e-2


def _rows(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(a.shape[1])]


def test_engine_matches_field_program():
    """The port's engine (implicit PD) against the port's field program,
    the kernel's plain version, from the same states: one substep, four
    chained substeps, and the FK outputs."""
    m = humanoid_model()
    kp, kd = generate_kp_kd_gains()
    spec = fp.build_spec(m, kp=kp, kd=kd, fall_allowed_bodies=("right_ankle", "left_ankle"))
    gains = default_gains()
    qpos, qvel, target = humanoid_states(3, seed=1)
    u = torch.from_numpy(target)
    pd = lambda mm, dd: implicit_pd(mm, dd, u, gains)
    d = make_data(m, torch.from_numpy(qpos), torch.from_numpy(qvel))
    d1 = tfwd.step(m, d, qfrc_fn=pd)
    q2, v2, _, _ = fp.substep(spec, _rows(qpos), _rows(qvel), _rows(target))
    np.testing.assert_allclose(torch.stack(q2, 1).numpy(), d1.qpos.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(torch.stack(v2, 1).numpy(), d1.qvel.numpy(), atol=2e-4, rtol=0)
    qr, vr = q2, v2
    for _ in range(3):
        d1 = tfwd.step(m, d1, qfrc_fn=pd)
        qr, vr, _, _ = fp.substep(spec, qr, vr, _rows(target))
    np.testing.assert_allclose(torch.stack(qr, 1).numpy(), d1.qpos.numpy(), atol=1e-5, rtol=0)
    dk = kinematics.kinematics(m, d1)
    xpos, xquat = fp.fk_outputs(spec, qr)
    for b in range(m.nbody):
        np.testing.assert_allclose(torch.stack(xpos[b], 1).numpy(), dk.xpos[:, b].numpy(),
                                   atol=1e-5, rtol=0)
        got_q = torch.stack(xquat[b], 1).numpy()
        want_q = dk.xquat[:, b].numpy()
        got_q = got_q * np.sign(np.sum(got_q * want_q, axis=1, keepdims=True))
        np.testing.assert_allclose(got_q, want_q, atol=1e-5, rtol=0)


def test_gradients_flow_through_a_step():
    """The engine is out of place throughout, so autograd runs through a
    substep with contacts (what analytic policy gradients need): the
    gradient of the next velocity with respect to the PD targets is finite
    and not zero."""
    m = humanoid_model()
    qpos, qvel, target = humanoid_states(2, seed=3)
    u = torch.from_numpy(target).requires_grad_(True)
    d = make_data(m, torch.from_numpy(qpos), torch.from_numpy(qvel))
    d1 = tfwd.step(m, d, qfrc_fn=lambda mm, dd: implicit_pd(mm, dd, u, default_gains()))
    assert int((d1.contact.dist < 0).sum()) > 0
    torch.sum(d1.qvel ** 2).backward()
    assert bool(torch.isfinite(u.grad).all()) and float(u.grad.abs().max()) > 0

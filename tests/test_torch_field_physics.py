"""The field program in plain PyTorch against pbrl_tpu's, run eagerly.

pbrl_tpu's ``fp.substep``/``fp.fk_outputs`` (the math of its Pallas
kernel) run eagerly on B = 2, as tests/test_field_physics.py runs them;
the port's plain version runs on CPU tensors from the same numpy inputs.
Both fold the same structural constants, so they differ by float32
rounding: qpos 1e-6 and qvel 2e-4 after one substep (qvel carries the
stiff contact and PD forces through the solve), FK 1e-5, fall exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.mocap.skeleton import generate_kp_kd_gains
from pbrl_tpu.model import humanoid_model as j_humanoid, sphere_model as j_sphere
from pbrl_tpu.ops import field_physics as jfp
from pbrl_tpu_torch.model import humanoid_model, sphere_model
from pbrl_tpu_torch.ops import field_physics as tfp

ALLOWED = ("right_ankle", "left_ankle")


def _specs(mode="pd", **kw):
    kp, kd = generate_kp_kd_gains()
    js = jfp.build_spec(j_humanoid(), kp=kp, kd=kd, mode=mode, fall_allowed_bodies=ALLOWED,
                        torque_scale=2.0, **kw)
    ts = tfp.build_spec(humanoid_model(), kp=kp, kd=kd, mode=mode,
                        fall_allowed_bodies=ALLOWED, torque_scale=2.0, **kw)
    return js, ts


@pytest.fixture(scope="module")
def specs():
    return _specs()


def _state(m, seed, B=2, z=0.85):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
    qpos[:, 2] = z
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, m.nq - 7))
    qvel = rng.normal(size=(B, m.nv)) * 0.5
    target = rng.uniform(-0.3, 0.3, (B, m.nu))
    return [x.astype(np.float32) for x in (qpos, qvel, target)]


def _jrows(a):
    return [jnp.asarray(a[:, i]) for i in range(a.shape[1])]


def _trows(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(a.shape[1])]


def _np(rows):
    return np.stack([np.asarray(r) if not isinstance(r, torch.Tensor) else r.numpy()
                     for r in rows], 1)


def test_spec_identical(specs):
    js, ts = specs
    for f in ("nq", "nv", "nu", "nbody", "dt", "gravity", "dof_damping", "dof_armature",
              "act_dof", "act_qadr", "kp", "kd", "tau_lo", "tau_hi", "limits", "m_pairs",
              "dof_body", "body_dofs", "geom_body", "geom_pos", "geom_quat", "geom_size",
              "geom_type", "contact_tc", "contact_damp", "limit_tc", "limit_damp",
              "self_contact_mass"):
        assert getattr(js, f) == getattr(ts, f), f
    assert [(s.kind, s.g1, s.g2, s.body1, s.body2, s.friction, s.m_eff, s.extra, s.fall)
            for s in js.slots] == [(s.kind, s.g1, s.g2, s.body1, s.body2, s.friction,
                                    s.m_eff, s.extra, s.fall) for s in ts.slots]
    assert len(ts.slots) == 141 and len(ts.m_pairs) == 310 and len(ts.limits) == 28


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_substep_matches(specs, seed):
    js, ts = specs
    q, v, u = _state(humanoid_model(), seed)
    jq, jv, jf, jheld = jfp.substep(js, _jrows(q), _jrows(v), _jrows(u))
    tq, tv, tf, theld = tfp.substep(ts, _trows(q), _trows(v), _trows(u))
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert sorted(jheld) == sorted(theld) and len(theld) == 104


@pytest.mark.parametrize("self_mass", ["substep", "static"])
def test_substep_matches_self_mass_modes(specs, self_mass):
    """The self-contact-mass modes other than 'step': 'substep' solves the
    exact two-body Delassus mass every substep, 'static' takes the
    harmonic surrogate. The state has active self-contacts, so the two
    modes differ in qvel well beyond the tolerance (at one substep
    'substep' equals 'step', which solves at the entry substep)."""
    js, ts = (dataclasses.replace(s, self_contact_mass=self_mass) for s in specs)
    q, v, u = _state(humanoid_model(), 0)
    jq, jv, jf, jheld = jfp.substep(js, _jrows(q), _jrows(v), _jrows(u))
    tq, tv, tf, theld = tfp.substep(ts, _trows(q), _trows(v), _trows(u))
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert jheld == {} and theld == {}
    other = "static" if self_mass == "substep" else "substep"
    os_ = dataclasses.replace(specs[1], self_contact_mass=other)
    _, sv, _, _ = tfp.substep(os_, _trows(q), _trows(v), _trows(u))
    assert np.abs(_np(sv) - _np(tv)).max() > 1e-3


def test_held_mass_substep(specs):
    """Substeps 1..n-1 of a policy step reuse the entry substep's exact
    self-contact masses (held_self)."""
    js, ts = specs
    q, v, u = _state(humanoid_model(), 5, z=0.8)
    _, _, _, jheld = jfp.substep(js, _jrows(q), _jrows(v), _jrows(u))
    theld = {k: torch.from_numpy(np.array(x)) for k, x in jheld.items()}
    q2, v2, _ = _state(humanoid_model(), 6, z=0.8)
    jq, jv, jf, jout = jfp.substep(js, _jrows(q2), _jrows(v2), _jrows(u), held_self=jheld)
    tq, tv, tf, tout = tfp.substep(ts, _trows(q2), _trows(v2), _trows(u), held_self=theld)
    assert jout == {} and tout == {}
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_torque_mode_substep():
    js, ts = _specs(mode="torque")
    q, v, _ = _state(humanoid_model(), 3)
    u = (20.0 * np.sin(np.arange(2 * 28))).reshape(2, 28).astype(np.float32)
    jq, jv, jf, _ = jfp.substep(js, _jrows(q), _jrows(v), _jrows(u))
    tq, tv, tf, _ = tfp.substep(ts, _trows(q), _trows(v), _trows(u))
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-4)


def test_sphere_scene_substeps():
    js = jfp.build_spec(j_sphere(), n_substeps=1)
    ts = tfp.build_spec(sphere_model(), n_substeps=1)
    q = np.tile(np.asarray(sphere_model().qpos0), (2, 1))
    q[1, 2] = 0.09  # second env resting in the floor: ground contact active
    v = np.zeros((2, 6), np.float32)
    jq, jv, tq, tv = _jrows(q), _jrows(v), _trows(q), _trows(v)
    for _ in range(3):
        jq, jv, _, _ = jfp.substep(js, jq, jv, [])
        tq, tv, _, _ = tfp.substep(ts, tq, tv, [])
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=2e-4)
    h = float(sphere_model().option.timestep)
    np.testing.assert_allclose(float(tv[2][0]), -9.81 * h * 3, rtol=1e-5)


def test_fk_outputs_match(specs):
    js, ts = specs
    q, _, _ = _state(humanoid_model(), 4)
    jp, jr = jfp.fk_outputs(js, _jrows(q))
    tp, tr = tfp.fk_outputs(ts, _trows(q))
    for b in range(13):
        np.testing.assert_allclose(_np(tp[b]), _np(jp[b]), atol=1e-5)
        np.testing.assert_allclose(_np(tr[b]), _np(jr[b]), atol=1e-5)


def test_fall_flag_exact(specs):
    js, ts = specs
    m = humanoid_model()
    q = np.tile(np.asarray(m.qpos0, np.float32), (2, 1))
    q[1, 2] = 0.05  # root sphere inside the floor: fall
    v = np.zeros((2, m.nv), np.float32)
    u = np.zeros((2, m.nu), np.float32)
    jf = jfp.substep(js, _jrows(q), _jrows(v), _jrows(u))[2]
    tf = tfp.substep(ts, _trows(q), _trows(v), _trows(u))[2]
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.tolist() == [0.0, 1.0]


def _jax_policy_step_flops(js):
    """Scalar FLOPs of pbrl_tpu's policy step (entry substep, n - 1
    held-mass substeps, final FK), each primitive weighed as
    ``count_substep_flops`` weighs it. ``jax.disable_jit`` inlines the
    clamps and selects that jnp's jitted helpers (``clip``, ``where``) wrap
    in ``jit`` equations, which ``count_substep_flops`` weighs 0."""
    like = jnp.zeros(())
    q, v, u = [like] * js.nq, [like] * js.nv, [like] * js.nu
    held = {si: like for si, sl in enumerate(js.slots) if sl.body1 >= 0}

    def count(f, *args):
        with jax.disable_jit():
            eqns = jax.make_jaxpr(f)(*args).jaxpr.eqns
        return sum(jfp._FLOP_PRIMS.get(e.primitive.name, 0) for e in eqns)

    entry = count(lambda q, v, u: jfp.substep(js, list(q), list(v), list(u)), q, v, u)
    rest = count(lambda q, v, u, h: jfp.substep(js, list(q), list(v), list(u),
                                                held_self=h)[:3], q, v, u, held)
    fk = count(lambda q: jfp.fk_outputs(js, list(q)), q)
    return entry + (js.n_substeps - 1) * rest + fk


def test_policy_step_flop_count(specs):
    """The port's operation count of a policy step, from which chip_smoke.py
    takes the kernel's bound, equals pbrl_tpu's count of the same program
    exactly (500,858 per env on this model): the port folds every constant
    that pbrl_tpu folds. It is 3.3% above 8 x count_substep_flops (60,323)
    plus the FK (2,391), because that count skips the 1,985 clamps and
    selects per substep inside jnp's jitted helpers."""
    js, ts = specs
    assert tfp.count_policy_step_flops(ts) == _jax_policy_step_flops(js)


@pytest.mark.parametrize("self_mass", ["step", "substep", "static"])
def test_needed_flop_count_attribution(specs, self_mass):
    """The per-slot Delassus FLOPs that the data-dependent count takes off
    are those the program spends: in 'step' mode the entry substep exceeds
    a held-mass substep by exactly the self slots' masses; with every
    contact touching the count is the straight-line one, with none it is
    smaller."""
    ts = dataclasses.replace(specs[1], self_contact_mass=self_mass)
    n_factor, per_slot = tfp._delassus_flops(ts)
    if self_mass == "step":
        q, v, u = tfp._unit_state(ts)
        (_, _, _, held), n_entry = tfp._counted(tfp.substep, ts, q, v, u)
        n_rest = tfp._counted(tfp.substep, ts, q, v, u, held_self=held)[1]
        assert n_entry - n_rest == sum(c for c, s in zip(per_slot, ts.slots) if s.body1 >= 0)
    shape = (ts.n_substeps, 3, len(ts.slots))
    straight = tfp.count_policy_step_flops(ts)
    assert tfp.count_policy_step_flops(ts, torch.ones(shape, dtype=torch.bool)) == 3 * straight
    none = tfp.count_policy_step_flops(ts, torch.zeros(shape, dtype=torch.bool))
    assert none <= 3 * (straight - ts.n_substeps * n_factor)


def test_contact_activity_matches_fall_flag(specs):
    """contact_activity's touching contacts give the plain policy step's
    fall flag exactly, and the FLOPs they need lie between the count with
    no contact and the straight-line count."""
    from pbrl_tpu_torch.ops.mimic_kernel import mimic_step_plain

    ts = dataclasses.replace(specs[1], n_substeps=3)
    m = humanoid_model()
    q, v, u = (torch.from_numpy(a) for a in _state(m, 5, B=3))
    q[2, 2] = 0.05  # root inside the floor: a fall
    active = tfp.contact_activity(ts, q, v, u)
    assert active.shape == (3, 3, len(ts.slots)) and active.dtype == torch.bool
    fall_slots = torch.tensor([s.fall for s in ts.slots])
    fall = (active & fall_slots).any(-1).any(0).float()
    np.testing.assert_array_equal(fall.numpy(), mimic_step_plain(ts, q, v, u)[4].numpy())
    assert fall[2] == 1.0
    # the first substep's contacts are those touching at the inputs' poses
    assert torch.equal(tfp.contacts_touching(ts, q), active[0])
    shape = (ts.n_substeps, 3, len(ts.slots))
    none = tfp.count_policy_step_flops(ts, torch.zeros(shape, dtype=torch.bool))
    assert none < tfp.count_policy_step_flops(ts, active) < 3 * tfp.count_policy_step_flops(ts)

"""``pbrl_tpu_torch.model.mjcf`` against pbrl_tpu's, the slide-joint scene
it opens, and the port's engine against CPU MuJoCo.

* ``to_mjcf`` emits pbrl_tpu's document string for string, and
  ``load_spec`` / ``load_model`` give pbrl_tpu's specs and compiled arrays
  field by field (exactly: both compile in host numpy), on the humanoid
  round trip, the ``fromto`` capsule, the cameras
  (tests/test_model.py:84-140) and the slide scene of
  tests/test_field_physics.py:318;
* on that scene the port's field program, the port's engine and
  pbrl_tpu's engine agree over 6 substeps (qpos 1e-5, qvel 1e-3, as
  tests/test_field_physics.py:336-365 holds pbrl_tpu's two);
* the humanoid exported by ``to_mjcf`` and compiled by MuJoCo's C compiler
  is the oracle of the port's FK (2e-5), site positions (2e-5), CRBA mass
  matrix (3e-4 of its largest entry), RNEA bias force (5e-4 of its
  largest) and a 50-substep smooth trajectory (qpos 2e-3, qvel 2e-2), the
  tolerances of tests/test_oracle_mujoco.py (float32 against float64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.engine import make_data as j_make_data
from pbrl_tpu.engine.forward import step as j_engine_step
from pbrl_tpu.model import humanoid_spec as j_humanoid_spec
from pbrl_tpu.model import load_model as j_load_model
from pbrl_tpu.model import load_spec as j_load_spec
from pbrl_tpu.model import to_mjcf as j_to_mjcf
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.engine.forward import forward, step, step_n
from pbrl_tpu_torch.model import GeomType, humanoid_spec, load_model, load_spec, to_mjcf
from pbrl_tpu_torch.ops import field_physics as fp

SLIDE_XML = """
<mujoco>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="carriage" pos="0 0 0.6">
      <joint name="lift" type="slide" axis="0 0 1" damping="0.5"/>
      <geom name="ball" type="sphere" size="0.12" mass="2"/>
      <body name="arm" pos="0.2 0 0">
        <joint name="swing" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom name="tip" type="sphere" size="0.06" pos="0.25 0 0" mass="0.5"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

FROMTO_XML = """
<mujoco>
  <compiler angle="radian"/>
  <worldbody>
    <body name="b" pos="0 0 1">
      <joint name="j" type="free"/>
      <geom name="c" type="capsule" size="0.05" fromto="0 0 -0.2 0 0 0.2" mass="1"/>
    </body>
  </worldbody>
</mujoco>
"""


def _plain(x):
    """A spec or model as plain, comparable python/numpy values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "shape"):  # numpy or jax arrays
        return np.asarray(x)
    return x


def _assert_same(got, want, path="spec"):
    if isinstance(want, dict):
        assert set(got) >= set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("xml", ["humanoid", "fromto", "slide"])
def test_load_spec_and_to_mjcf_match_pbrl_tpu(xml):
    """The parsed spec field by field, its export string for string, and
    the compiled model's arrays exactly."""
    text = {"humanoid": to_mjcf(humanoid_spec()), "fromto": FROMTO_XML, "slide": SLIDE_XML}[xml]
    if xml == "humanoid":
        assert text == j_to_mjcf(j_humanoid_spec())
    spec, jspec = load_spec(text), j_load_spec(text)
    _assert_same(_plain(spec), _plain(jspec))
    assert to_mjcf(spec) == j_to_mjcf(jspec)
    m, jm = load_model(text), j_load_model(text)
    for f in dataclasses.fields(jm):
        if f.name in {g.name for g in dataclasses.fields(m)}:
            _assert_same(_plain(getattr(m, f.name)), _plain(getattr(jm, f.name)), f.name)


def test_mjcf_roundtrip_humanoid():
    spec = humanoid_spec()
    m1, m2 = spec.compile(), load_spec(to_mjcf(spec)).compile()
    assert (m1.nq, m1.nv, m1.nu) == (m2.nq, m2.nv, m2.nu)
    assert m1.body_names == m2.body_names and m1.jnt_type == m2.jnt_type
    assert m1.geom_type == m2.geom_type
    for k in ("body_pos", "jnt_range", "body_mass", "body_inertia"):
        np.testing.assert_allclose(getattr(m1, k), getattr(m2, k), atol=1e-6, err_msg=k)
    assert m1.npair == m2.npair and m1.nplanepair == m2.nplanepair


def test_mjcf_fromto_capsule():
    g = load_spec(FROMTO_XML).bodies[0].geoms[0]
    assert g.type == GeomType.CAPSULE
    np.testing.assert_allclose(g.size[:2], [0.05, 0.2])
    np.testing.assert_allclose(g.pos, [0, 0, 0], atol=1e-12)


def test_mjcf_cameras_roundtrip():
    spec = humanoid_spec()
    cams = {c.name: c for b in spec.bodies for c in b.cameras}
    assert set(cams) == {"back", "side"} and cams["back"].mode == "trackcom"
    xml = to_mjcf(spec)
    cams2 = {c.name: c for b in load_spec(xml).bodies for c in b.cameras}
    assert set(cams2) == {"back", "side"}
    np.testing.assert_allclose(cams2["back"].pos, cams["back"].pos)
    np.testing.assert_allclose(cams2["side"].xyaxes, cams["side"].xyaxes)
    mujoco = pytest.importorskip("mujoco")
    mj = mujoco.MjModel.from_xml_string(xml)
    assert {mj.camera(i).name for i in range(mj.ncam)} == {"back", "side"}


def test_slide_scene_field_program_engines_agree():
    """The slide joint (the kernel's J_SLIDE branch) through the port's
    field program, the port's engine and pbrl_tpu's engine: a slider
    dropping onto the floor with a swinging hinge arm, 6 substeps."""
    m, jm = load_model(SLIDE_XML), j_load_model(SLIDE_XML)
    assert list(m.jnt_type) == [2, 1]  # slide, hinge
    qpos = np.asarray(m.qpos0, np.float64).copy()
    qpos[0], qpos[1] = -0.3, 0.7   # the ball 1 cm above the floor; the arm off-axis
    qvel = np.array([-0.5, 1.0])
    spec = fp.build_spec(m, n_substeps=1, mode="torque")
    rows = lambda a: [torch.tensor([v], dtype=torch.float32) for v in a]
    q, v = rows(qpos), rows(qvel)
    d = make_data(m, qpos=torch.tensor(qpos[None], dtype=torch.float32),
                  qvel=torch.tensor(qvel[None], dtype=torch.float32))
    jd = j_make_data(jm, qpos=jnp.asarray(qpos, jnp.float32), qvel=jnp.asarray(qvel, jnp.float32))
    for _ in range(6):
        q, v, _, _ = fp.substep(spec, q, v, [])
        d = step(m, d)
        jd = j_engine_step(jm, jd)
    qf = np.array([float(r[0]) for r in q])
    vf = np.array([float(r[0]) for r in v])
    assert np.all(np.isfinite(qf)) and np.all(np.isfinite(vf))
    assert qf[0] < -0.3  # the slider moved down onto the floor
    for name, (qe, ve) in {"port engine": (d.qpos[0].numpy(), d.qvel[0].numpy()),
                           "pbrl_tpu engine": (np.asarray(jd.qpos), np.asarray(jd.qvel))}.items():
        np.testing.assert_allclose(qf, qe, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(vf, ve, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(d.qpos[0].numpy(), np.asarray(jd.qpos), atol=1e-5)
    np.testing.assert_allclose(d.qvel[0].numpy(), np.asarray(jd.qvel), atol=1e-3)


# ---------------------------------------------------------------------------
# The port's engine against CPU MuJoCo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle():
    mujoco = pytest.importorskip("mujoco")
    spec = humanoid_spec(floor=False)
    return spec.compile(), mujoco.MjModel.from_xml_string(to_mjcf(spec)), mujoco


def _random_state(m, seed):
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0, np.float64).copy()
    qpos[7:] = rng.uniform(-0.5, 0.5, size=m.nq - 7)
    quat = rng.normal(size=4)
    qpos[3:7] = quat / np.linalg.norm(quat)
    qpos[:3] = rng.uniform(-1, 1, size=3) + [0, 0, 1.5]
    qvel = rng.normal(size=m.nv) * 0.5
    return qpos, qvel


def _both(oracle, seed):
    ours, mj, mujoco = oracle
    qpos, qvel = _random_state(ours, seed)
    mjd = mujoco.MjData(mj)
    mjd.qpos[:], mjd.qvel[:] = qpos, qvel
    mujoco.mj_forward(mj, mjd)
    d = forward(ours, make_data(ours, qpos=torch.tensor(qpos[None], dtype=torch.float32),
                                qvel=torch.tensor(qvel[None], dtype=torch.float32)))
    return ours, mj, mjd, d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fk_matches_mujoco(oracle, seed):
    ours, mj, mjd, d = _both(oracle, seed)
    for b, name in enumerate(ours.body_names):
        i = mj.body(name).id
        np.testing.assert_allclose(d.xpos[0, b].numpy(), mjd.xpos[i], atol=2e-5, err_msg=name)
        qo = d.xquat[0, b].numpy().astype(np.float64)
        qo = -qo if np.dot(mjd.xquat[i], qo) < 0 else qo
        np.testing.assert_allclose(qo, mjd.xquat[i], atol=2e-5, err_msg=name)
    for s, name in enumerate(ours.site_names):
        np.testing.assert_allclose(d.site_xpos[0, s].numpy(), mjd.site(name).xpos, atol=2e-5,
                                   err_msg=f"site {name}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mass_matrix_and_bias_match_mujoco(oracle, seed):
    mujoco = oracle[2]
    ours, mj, mjd, d = _both(oracle, seed)
    M_mj = np.zeros((mj.nv, mj.nv))
    mujoco.mj_fullM(mj, mjd, M_mj)  # MuJoCo >= 3.10's signature, as tests/test_oracle_mujoco.py
    M = d.qM[0].numpy().astype(np.float64)
    scale = max(1.0, np.abs(M_mj).max())
    np.testing.assert_allclose(M / scale, M_mj / scale, atol=3e-4)
    bias = d.qfrc_bias[0].numpy().astype(np.float64)
    scale = max(1.0, np.abs(mjd.qfrc_bias).max())
    np.testing.assert_allclose(bias / scale, mjd.qfrc_bias / scale, atol=5e-4)


def test_smooth_trajectory_matches_mujoco(oracle):
    """50 substeps with no contacts and no limits (MuJoCo's hard limits and
    the engine's compliant springs differ by design), torque motors held."""
    mujoco = oracle[2]
    spec = humanoid_spec(floor=False)
    for b in spec.bodies:
        for j in b.joints:
            j.limited = False
        for g in b.geoms:
            g.contype = g.conaffinity = 0
    ours = spec.compile()
    mj = mujoco.MjModel.from_xml_string(to_mjcf(spec))
    qpos = np.asarray(ours.qpos0, np.float64).copy()
    qpos[2] += 2.0
    rng = np.random.default_rng(7)
    qpos[7:] = rng.uniform(-0.3, 0.3, size=ours.nq - 7)
    ctrl = rng.uniform(-0.4, 0.4, size=ours.nu)
    mjd = mujoco.MjData(mj)
    mjd.qpos[:], mjd.ctrl[:] = qpos, ctrl
    for _ in range(50):
        mujoco.mj_step(mj, mjd)
    d = step_n(ours, make_data(ours, qpos=torch.tensor(qpos[None], dtype=torch.float32)), 50,
               ctrl=torch.tensor(ctrl[None], dtype=torch.float32))
    np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, atol=2e-3)
    np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, atol=2e-2)

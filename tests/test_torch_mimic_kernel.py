"""The policy-step wrapper, its kernel table and its CUDA source.

* On CPU tensors the wrapper runs the plain version: held against
  pbrl_tpu's Pallas wrapper in interpret mode on the sphere scene (B = 5,
  3 substeps, the case of tests/test_vec_env.py), outputs to 1e-5 and free
  fall exact to rtol 1e-5.
* ``pack_spec`` round-trips the humanoid spec, and its field list is the
  CUDA source's ``MODEL_FIELDS``.
* The CUDA source's device code, compiled for the host with g++ where one
  is installed, agrees with the plain version (the kernel's arithmetic and
  table walk, without nvcc).
* One ``gpu`` test launches the real kernel on the card.

JAX is imported inside the tests that use it, so the ``gpu`` test also
runs where JAX is not installed (``pytest --noconftest -m gpu``).
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pbrl_tpu_torch.mocap.skeleton import generate_kp_kd_gains
from pbrl_tpu_torch.model import humanoid_model, sphere_model
from pbrl_tpu_torch.ops import field_physics as fp
from pbrl_tpu_torch.ops import mimic_kernel

ALLOWED = ("right_ankle", "left_ankle")


def _humanoid_step(mode="pd", n_substeps=2, self_mass="step"):
    kp, kd = generate_kp_kd_gains()
    step, spec = mimic_kernel.build_mimic_step(humanoid_model(), kp=kp, kd=kd,
                                               n_substeps=n_substeps, mode=mode,
                                               fall_allowed_bodies=ALLOWED, torque_scale=2.0)
    if self_mass == spec.self_contact_mass:
        return step, spec
    spec = dataclasses.replace(spec, self_contact_mass=self_mass)
    return mimic_kernel.MimicStep(spec), spec


def _humanoid_inputs(seed, B, mode):
    m = humanoid_model()
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
    q[:, 2] = rng.uniform(0.8, 0.9, B)
    q[:, 7:] += rng.uniform(-0.3, 0.3, (B, m.nq - 7))
    v = rng.normal(size=(B, m.nv)) * 0.5
    if mode == "pd":
        u = rng.uniform(-0.3, 0.3, (B, m.nu))
    else:
        u = 20.0 * np.sin(np.arange(B * m.nu)).reshape(B, m.nu)
    return [torch.from_numpy(x.astype(np.float32)) for x in (q, v, u)]


def test_cpu_wrapper_matches_pallas_interpret_sphere():
    import jax.numpy as jnp

    from pbrl_tpu.model import sphere_model as j_sphere
    from pbrl_tpu.ops.mimic_kernel import build_mimic_step as j_build

    jm, m = j_sphere(), sphere_model()
    jstep, _ = j_build(jm, n_substeps=3, interpret=True)
    tstep, _ = mimic_kernel.build_mimic_step(m, n_substeps=3)
    B = 5
    rng = np.random.default_rng(0)
    q = np.tile(np.asarray(m.qpos0, np.float32), (B, 1))
    q[:, 2] += rng.uniform(-1.35, 0.0, B).astype(np.float32)  # some envs in contact
    v = (rng.normal(size=(B, m.nv)) * 0.3).astype(np.float32)
    v[0] = 0.0
    q[0] = np.asarray(m.qpos0)
    want = jstep(jnp.asarray(q), jnp.asarray(v), jnp.zeros((B, 1)))
    got = tstep(torch.from_numpy(q), torch.from_numpy(v), torch.zeros(B, 0))
    assert tstep.launches == 0  # CPU tensors never launch the kernel
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    h = float(m.option.timestep)
    np.testing.assert_allclose(got[1][0, 2].item(), -9.81 * h * 3, rtol=1e-5)


def test_wrapper_rejects_bad_inputs():
    step, spec = mimic_kernel.build_mimic_step(sphere_model(), n_substeps=1)
    q = torch.zeros(2, spec.nq)
    with pytest.raises(ValueError):
        step(q, torch.zeros(2, spec.nv + 1), torch.zeros(2, 1))
    with pytest.raises(ValueError):
        step(q.double(), torch.zeros(2, spec.nv, dtype=torch.float64),
             torch.zeros(2, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        step(torch.zeros(spec.nq, 2).t(), torch.zeros(2, spec.nv), torch.zeros(2, 1))


def test_pack_spec_round_trips_humanoid():
    step, spec = _humanoid_step()
    w = step.table
    r = lambda name: fp.read_table(w, name)
    assert r("nq")[0] == 35 and r("nv")[0] == 34 and r("nu")[0] == 28
    assert r("nbody")[0] == 13 and r("nslot")[0] == 141 and r("npair")[0] == 310
    assert np.sum(r("dof_lim")[:34] >= 0) == 28 and r("n_substeps")[0] == 2 and r("mode")[0] == 0
    pairs = list(zip(r("pair_i")[:310].tolist(), r("pair_j")[:310].tolist()))
    assert pairs == spec.m_pairs
    assert r("body_parent")[:13].tolist() == [b.parent for b in spec.bodies]
    np.testing.assert_array_equal(r("body_pos")[:39].reshape(13, 3),
                                  np.asarray([b.pos for b in spec.bodies], np.float32))
    np.testing.assert_array_equal(r("act_kp")[:28], np.asarray(spec.kp, np.float32))
    np.testing.assert_array_equal(r("act_lo")[:28], np.asarray(spec.tau_lo, np.float32))
    kinds = r("slot_kind")[:141]
    assert [fp.SLOT_KINDS[k] for k in kinds] == [s.kind for s in spec.slots]
    counts = {k: int(np.sum(kinds == i)) for i, k in enumerate(fp.SLOT_KINDS)}
    assert counts == {"plane_sphere": 5, "plane_capend": 16, "plane_corner": 16,
                      "sphere_sphere": 8, "sphere_capsule": 32, "sphere_box": 10,
                      "capsule_capsule": 24, "capsule_box": 14, "boxcorner_box": 8,
                      "box_boxcorner": 8}
    # the Delassus support of each slot is the union of its bodies' chains
    start, count = r("slot_supp_start"), r("slot_supp_count")
    for si, s in enumerate(spec.slots):
        dofs = r("supp_dof")[start[si]:start[si] + count[si]].tolist()
        chains = set(fp._chain_dofs(spec, s.body2))
        if s.body1 >= 0:
            chains |= set(fp._chain_dofs(spec, s.body1))
        assert dofs == sorted(chains)
    # ancestor lists: every (k, i) pair with i < k, descending per k
    ptr = r("anc_ptr")
    for k in range(34):
        anc = r("anc_dof")[ptr[k]:ptr[k + 1]].tolist()
        assert anc == sorted((j for (i, j) in spec.m_pairs if i == k and j < k), reverse=True)
    h = spec.dt  # implicit diagonal of the first hinge: h * damping + h * kd
    np.testing.assert_allclose(r("dof_extra_diag")[6], h * 1.0 + h * spec.kd[0], rtol=1e-7)


def test_pack_spec_team_layout():
    """The table entries that let an env's lanes share its work: bodies by
    tree level (body 0 alone first), children in descending index, each
    body's contact slots in slot order, the rounds in which lanes take the
    slots (five rounds of 32 lanes, ten kinds' code paths in all, the 32
    capsule-end and box-corner ground slots in the first),
    dofs by depth, the factor's entries and steps by body level (each
    entry's terms in the serial program's order), and each slot's
    support-local ancestor positions."""
    step, spec = _humanoid_step()
    w = step.table
    r = lambda name: fp.read_table(w, name)
    nb, nv, ns = 13, 34, 141
    parent = [b.parent for b in spec.bodies]
    lvl_ptr, order = r("lvl_ptr")[:r("nlevel")[0] + 1], r("lvl_body")[:nb]
    assert sorted(order.tolist()) == list(range(nb)) and order[0] == 0 and lvl_ptr[1] == 1
    level = {b: l for l in range(len(lvl_ptr) - 1) for b in order[lvl_ptr[l]:lvl_ptr[l + 1]]}
    assert all(level[b] == level[parent[b]] + 1 for b in range(1, nb))
    cptr, child = r("child_ptr"), r("child")
    for b in range(nb):
        assert child[cptr[b]:cptr[b + 1]].tolist() == sorted(
            (c for c in range(nb) if parent[c] == b), reverse=True)
    sptr, bslot = r("body_slot_ptr"), r("body_slot")
    for b in range(nb):
        es = bslot[sptr[b]:sptr[b + 1]].tolist()
        assert es == sorted(es)
        assert es == sorted([2 * i for i, s in enumerate(spec.slots) if s.body2 == b]
                            + [2 * i + 1 for i, s in enumerate(spec.slots) if s.body1 == b])
    anc = fp._anc_lists(spec)
    dep = r("dep_dof")[:nv].tolist()
    assert sorted(dep) == list(range(nv))
    assert [len(anc[i]) for i in dep] == sorted(len(a) for a in anc)
    pairs = spec.m_pairs
    # the factor by body level: every (k, i) once, with the terms of the
    # descendants c of k in descending order, split into the dofs of
    # descendant bodies (one pass) and the body's own later dofs (steps)
    fa_ptr, fa_ent, fa_optr, fa_op = r("fa_ptr"), r("fa_ent"), r("fa_op_ptr"), r("fa_op")
    fl_ptr, piv_ptr, piv = r("fl_step_ptr"), r("fb_piv_ptr"), r("fb_piv")
    upd_ptr, upd = r("fb_upd_ptr"), r("fb_upd")
    terms = {}
    for lv in range(len(lvl_ptr) - 1):
        for e in range(fa_ptr[lv], fa_ptr[lv + 1]):
            k, i = pairs[fa_ent[e] & 1023]
            assert (fa_ent[e] >> 10) & 63 == k and (fa_ent[e] >> 16) == (i == k)
            assert level[spec.dof_body[k]] == lv
            terms[(k, i)] = [(pairs[o & 1023], pairs[o >> 10])
                             for o in fa_op[fa_optr[e]:fa_optr[e + 1]]]
        for st in range(fl_ptr[lv], fl_ptr[lv + 1]):
            for t in range(piv_ptr[st], piv_ptr[st + 1]):
                k = piv[t] & 255
                assert pairs[piv[t] >> 8] == (k, k)
            for code in upd[upd_ptr[st]:upd_ptr[st + 1]]:
                tgt, a_, b_ = pairs[code & 1023], pairs[(code >> 10) & 1023], pairs[code >> 20]
                terms[tgt].append((b_, a_))
    assert sorted(terms) == sorted(pairs)
    for (k, i), got in terms.items():
        want = [((c, i), (c, k)) for c in range(nv - 1, k, -1) if k in anc[c]]
        assert got == want, (k, i)
    order = r("slot_order")[:r("nslot_order")[0]].tolist()
    assert len(order) % 32 == 0 and sorted(si for si in order if si >= 0) == list(range(ns))
    rounds = [[fp.SLOT_KINDS[r("slot_kind")[si]] for si in order[c:c + 32] if si >= 0]
              for c in range(0, len(order), 32)]
    assert len(rounds) == 5 and sum(len(set(kinds)) for kinds in rounds) == 10
    assert sorted(rounds[0]) == ["plane_capend"] * 16 + ["plane_corner"] * 16
    pos, end = r("dl_pos").view(np.uint8), r("slot_dl_end")
    start, count = r("slot_supp_start"), r("slot_supp_count")
    for si in range(ns):
        dofs = r("supp_dof")[start[si]:start[si] + count[si]].tolist()
        n_ops = sum(len(anc[i]) for i in dofs)
        got = pos[end[si] - n_ops:end[si]].tolist()
        assert [dofs[p] for p in got] == [a for i in dofs for a in anc[i]]
    assert max(count[:ns]) <= fp.table_limits()["MAXSL"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    out = str(tmp_path_factory.mktemp("kernel") / "libmimic_host.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", out,
                    mimic_kernel.SOURCE], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    mimic_kernel.bind(lib)
    return lib


def _host_step(lib, step, q, v, u):
    """The kernel's arithmetic on the host: (B, K) rows in and out, as the
    wrapper hands them to the card."""
    spec = step.spec
    B, nb = q.shape[0], spec.nbody
    ins = [np.ascontiguousarray(x.numpy()) for x in (q, v, u)]
    outs = [np.zeros(shape, np.float32)
            for shape in ((B, spec.nq), (B, spec.nv), (B, nb, 3), (B, nb, 4), (B,))]
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
    lib.mimic_step_host(ptr(step.table), B, *[ptr(a) for a in ins + outs])
    return outs


@pytest.mark.parametrize("mode, self_mass", [
    pytest.param("pd", "step", id="pd"),
    pytest.param("torque", "step", id="torque"),
    pytest.param("pd", "substep", id="pd-substep"),
    pytest.param("pd", "static", id="pd-static"),
])
def test_cuda_source_on_host_matches_plain(host_lib, mode, self_mass):
    """Two substeps of the humanoid: the table-driven source (push-form
    triangular solves, its own summation order) and the plain version
    agree to float32 rounding: qpos/FK 1e-6, qvel 1e-4, fall exact. The
    inputs have active self-contacts, so each self-contact-mass mode
    ('step' holds the entry substep's Delassus mass, 'substep' solves it
    every substep, 'static' takes the harmonic surrogate) takes its own
    branch: 'substep' and 'static' move qvel by about 1e-3 and 0.25 from
    'step'."""
    step, _ = _humanoid_step(mode, self_mass=self_mass)
    q, v, u = _humanoid_inputs(1, 3, mode)
    got = _host_step(host_lib, step, q, v, u)
    want = [t.numpy() for t in step(q, v, u)]
    for name, a, b, tol in zip(("qpos", "qvel", "xpos", "xquat", "fall"), got, want,
                               (1e-6, 1e-4, 1e-6, 1e-6, 0.0)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)


@pytest.mark.parametrize("run_dir", ["getup", "backflip"])
def test_cuda_source_on_host_recipe_spec(host_lib, run_dir):
    """The kernel table of a shipped recipe's env (no joint limits, so the
    spec has none; backflip's torque scale 2.5, and an actuator mask folded
    into its gains), 2 substeps: the source on the host and the plain
    version agree as above."""
    import json
    import os

    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.utils.configio import dict_to_config

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "ckpts", run_dir,
                        "run_config.json")
    with open(path) as f:
        run = json.load(f)
    cfg = dataclasses.replace(dict_to_config(EnvConfig, run["env_config"]), policy_dt=0.004)
    mask = (np.arange(28) % 5 != 0).astype(np.float32) if run_dir == "backflip" else None
    env = MimicVecEnv(humanoid_model(), load_clip(run["clip"], device="cpu"), cfg,
                      actuator_mask=mask, device="cpu")
    step = env._kstep
    assert step.spec.limits == [] and step.spec.n_substeps == 2
    assert step.spec.tau_hi[0] == pytest.approx(
        float(humanoid_model().actuator_gear[0]) * cfg.torque_limit_scale
        * float(humanoid_model().actuator_ctrlrange[0, 1]))
    q, v, u = _humanoid_inputs(3, 3, "pd")
    q[:, 7:] *= 3.0  # beyond the joint ranges, which no limit holds here
    got = _host_step(host_lib, step, q, v, u)
    want = [t.numpy() for t in step(q, v, u)]
    for name, a, b, tol in zip(("qpos", "qvel", "xpos", "xquat", "fall"), got, want,
                               (1e-6, 1e-4, 1e-6, 1e-6, 0.0)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)


def test_cuda_source_on_host_sphere(host_lib):
    step, _ = mimic_kernel.build_mimic_step(sphere_model(), n_substeps=3)
    q = torch.from_numpy(np.tile(np.asarray(sphere_model().qpos0, np.float32), (5, 1)))
    v = torch.zeros(5, 6)
    got = _host_step(host_lib, step, q, v, torch.zeros(5, 1))
    want = [t.numpy() for t in step(q, v, torch.zeros(5, 1))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card (one policy
    step of 64, 33 and 1 humanoid envs, both modes): qpos and FK 1e-5,
    qvel 1e-2 (stiff contacts amplify rounding; chip_smoke.py measured a
    max of 1.1e-3 over 2 steps of 256 envs), fall exact. Two launches on
    the same inputs give the same bits: a race between the lanes of an
    env would not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for mode in ("pd", "torque"):
        step, spec = _humanoid_step(mode, n_substeps=8)
        for B in (64, 33, 1):
            q, v, u = (t.to(dev) for t in _humanoid_inputs(2, B, mode))
            got = step(q, v, u)
            again = step(q, v, u)
            want = mimic_kernel.mimic_step_plain(spec, q, v, u)
            torch.cuda.synchronize()
            for a, b, tol in zip(got, want, (1e-5, 1e-2, 1e-5, 1e-5, 0.0)):
                assert tuple(a.shape) == tuple(b.shape)
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=tol)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (mode, B)
        assert step.launches == 6

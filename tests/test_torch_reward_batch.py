"""The imitation reward's batched per-joint pass against the per-joint loop.

``humanoid_task.joint_pose_errors`` computes the 8 ball joints' errors in one
batched pass over a (B, 8, 3) block and the 4 hinge joints' in one ``abs``,
with its constant tables built once per model, device and dtype. The loop
over the 12 mocap joints that it replaced, and the reward formula around it
(with per-call host tables for the end-effectors and the centre of mass),
are kept here as the oracle: the batched pass, its gradients through
``angle_between``'s custom backward, ``MimicVecEnv._reward_batch``'s reward
and terms, and a whole env step (obs, reward, done, metrics) must equal them
bit for bit. The test marked ``gpu`` runs on the card (``python -m pytest
--noconftest -q -m gpu tests/test_torch_reward_batch.py``): the same
equality at 2048 envs, and the ``vec/reward`` span under ``torch.profiler``
with no host-to-device copy and at most 700 launch calls a step.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs import humanoid_task as task
from pbrl_tpu_torch.maths import quaternion as quat
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.mocap.clip import phase, reference_aux, reference_state
from pbrl_tpu_torch.model import humanoid_model

MODEL = humanoid_model()
# The backflip recipe's reward terms: aerial window, drift shaping, early
# termination (benchmark/configs/backflip.json).
BACKFLIP = dict(aerial_window=(0.27, 0.5), aerial_w_pose=0.2, aerial_w_root=0.35,
                aerial_w_angvel=0.25, aerial_w_com=0.2, aerial_s_root=2.0,
                aerial_s_angvel=0.02, aerial_edge=0.03, drift_w=0.35, drift_s=3.0,
                pose_termination=1.57, pose_termination_after_cycle=2.4,
                exclude_root_xy=True, include_phase=True, include_ref_root_offset=True,
                action_mode="residual", enforce_joint_limits=False, torque_limit_scale=2.5)
CONFIGS = {"walk": ("walk", {}), "backflip": ("backflip", BACKFLIP)}


# ---------------------------------------------------------------------------
# The oracle: the per-joint loop and the reward formula around it
# ---------------------------------------------------------------------------

def _conj(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def _loop_joint_pose_errors(model, qpos, qpos_ref):
    errs = []
    for qadr, dof in task.joint_slices(model):
        if dof == 1:
            errs.append(torch.abs(qpos[..., qadr] - qpos_ref[..., qadr]))
        else:
            q1 = quat.from_euler_rxyz(qpos[..., qadr:qadr + 3])
            q2 = quat.from_euler_rxyz(qpos_ref[..., qadr:qadr + 3])
            errs.append(quat.angle_between(q1, q2))
    return torch.stack(errs, dim=-1)


def _loop_ee_positions(model, xpos, xquat):
    bids = [model.body_id(n) for n, _ in task.EE_SPECS]
    offsets = xpos.new_tensor([o for _, o in task.EE_SPECS])
    return xpos[..., bids, :] + quat.rotate(xquat[..., bids, :], offsets)


def _loop_center_of_mass(model, xpos, xquat):
    xipos = xpos + quat.rotate(xquat, xpos.new_tensor(model.body_ipos))
    mass = xipos.new_tensor(model.body_mass)
    return torch.einsum("b,...bx->...x", mass, xipos) / torch.sum(mass)


def _loop_reward_batch(env, qpos, qvel, t, xpos, xquat, fall):
    c = env.config
    q_ref, v_ref = reference_state(env.clip, t)
    ee_ref, com_ref = reference_aux(env.clip, t)
    joint_err = _loop_joint_pose_errors(env.model, qpos, q_ref)
    root_rot = quat.angle_between(quat.normalize(qpos[:, 3:7]), quat.normalize(q_ref[:, 3:7]))
    pose_sq = torch.sum(joint_err ** 2, dim=1) + root_rot ** 2
    r_pose = torch.exp(-c.s_pose * pose_sq)
    r_vel = torch.exp(-c.s_vel * torch.sum((qvel - v_ref) ** 2, dim=1))
    ee = _loop_ee_positions(env.model, xpos, xquat)
    r_ee = torch.exp(-c.s_ee * torch.sum((ee - ee_ref) ** 2, dim=(1, 2)) / len(task.EE_SPECS))
    com = _loop_center_of_mass(env.model, xpos, xquat)
    r_com = torch.exp(-c.s_com * torch.sum((com - com_ref) ** 2, dim=1))
    reward = c.w_pose * r_pose + c.w_vel * r_vel + c.w_ee * r_ee + c.w_com * r_com
    if c.aerial_window:
        lo, hi = c.aerial_window
        ph = phase(env.clip, t)
        edge = max(c.aerial_edge, 1e-6)
        win = torch.clamp((ph - lo) / edge, 0.0, 1.0) * torch.clamp((hi - ph) / edge, 0.0, 1.0)
        r_root = torch.exp(-c.aerial_s_root * root_rot ** 2)
        dw = qvel[:, 3:6] - v_ref[:, 3:6]
        r_angvel = torch.exp(-c.aerial_s_angvel * torch.sum(dw ** 2, dim=1))
        aerial = (c.aerial_w_pose * r_pose + c.aerial_w_root * r_root
                  + c.aerial_w_angvel * r_angvel + c.aerial_w_com * r_com)
        reward = (1.0 - win) * reward + win * aerial
    if c.drift_w > 0:
        dxy = qpos[:, :2] - q_ref[:, :2]
        r_drift = torch.exp(-c.drift_s * torch.sum(dxy ** 2, dim=1))
        reward = (1.0 - c.drift_w) * reward + c.drift_w * r_drift
    if c.early_termination:
        reward = torch.where(fall > 0, 0.0, reward)
    terms = {"reward_pose": r_pose, "reward_vel": r_vel, "reward_ee": r_ee,
             "reward_com": r_com, "pose_error": torch.mean(joint_err, dim=1),
             "root_err": root_rot}
    return reward, terms


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _pose_pair(case, device="cpu"):
    """(qpos, qpos_ref), (B, nq) each, for one named case."""
    g = torch.Generator().manual_seed(7)
    B = 1 if case == "batch1" else 257
    u = lambda *s: 2.0 * torch.rand(*s, generator=g, dtype=torch.float64) - 1.0  # noqa: E731
    qpos = (math.pi * u(B, MODEL.nq)).to(torch.float32)
    if case in ("random", "batch1"):
        ref = (math.pi * u(B, MODEL.nq)).to(torch.float32)
    elif case == "identical":  # |<q1, q2>| = 1: the error about 0, the gradient clamped
        ref = qpos.clone()
    elif case == "euler_at_pi":  # Euler angles at and next to +-pi
        edge = torch.tensor([math.pi, -math.pi, math.pi - 1e-6, -math.pi + 1e-6])
        qpos = edge[torch.randint(4, (B, MODEL.nq), generator=g)]
        ref = edge[torch.randint(4, (B, MODEL.nq), generator=g)]
    elif case == "error_near_pi":  # relative rotations of about pi on one axis
        flip = (math.pi - 1e-3 * torch.rand(B, MODEL.nq, generator=g)).to(torch.float32)
        ref = qpos + flip * torch.where(u(B, MODEL.nq) > 0, 1.0, -1.0).to(torch.float32)
    else:
        raise ValueError(case)
    return qpos.to(device), ref.to(device)


POSE_CASES = ("random", "identical", "euler_at_pi", "error_near_pi", "batch1")


@pytest.mark.parametrize("case", POSE_CASES)
def test_joint_pose_errors_equal_the_loop(case):
    qpos, ref = _pose_pair(case)
    got = task.joint_pose_errors(MODEL, qpos, ref)
    want = _loop_joint_pose_errors(MODEL, qpos, ref)
    assert got.shape == want.shape == (qpos.shape[0], 12)
    assert torch.equal(got, want)
    if case == "identical":  # an ulp of the dot product below 1 reads about 7e-4
        assert float(got.max()) < 2e-3
    if case == "error_near_pi":
        ball = [j for j, (_, dof) in enumerate(task.joint_slices(MODEL)) if dof == 3]
        assert float(got[:, ball].max()) > 3.0


@pytest.mark.parametrize("case", POSE_CASES)
def test_joint_pose_error_gradients_equal_the_loop(case):
    qpos, ref = _pose_pair(case)
    w = torch.rand(qpos.shape[0], 12, generator=torch.Generator().manual_seed(3))
    grads = []
    for fn in (task.joint_pose_errors, _loop_joint_pose_errors):
        q, r = qpos.clone().requires_grad_(), ref.clone().requires_grad_()
        torch.sum(fn(MODEL, q, r) * w).backward()
        grads.append((q.grad, r.grad))
    (gq, gr), (wq, wr) = grads
    assert torch.equal(gq, wq) and torch.equal(gr, wr)
    assert torch.isfinite(gq).all() and bool((gq != 0).any())


def test_joint_pose_errors_any_leading_shape():
    qpos, ref = _pose_pair("random")
    got = task.joint_pose_errors(MODEL, qpos.reshape(257, 1, -1), ref.reshape(257, 1, -1))
    assert torch.equal(got[:, 0], _loop_joint_pose_errors(MODEL, qpos, ref))
    assert torch.equal(task.joint_pose_errors(MODEL, qpos[0], ref[0]),
                       _loop_joint_pose_errors(MODEL, qpos[0], ref[0]))


def test_tables_built_once_per_device_and_dtype():
    x = torch.zeros(3, MODEL.nbody, 3)
    assert task._tables(MODEL, x.device, x.dtype) is task._tables(MODEL, x.device, x.dtype)
    t64 = task._tables(MODEL, x.device, torch.float64)
    assert t64["body_mass"].dtype == torch.float64
    assert t64["ball"].shape == (8, 3) and t64["hinge"].shape == (4,)


def _env(name, device="cpu", backend="xla"):
    clip, cfg = CONFIGS[name]
    cfg = {"policy_dt": 0.004, **cfg}  # 2 substeps a policy step
    return MimicVecEnv(MODEL, load_clip(clip, device=device), EnvConfig(**cfg),
                       backend=backend, device=device)


def _states(env, B, seed):
    """(qpos, qvel, t, xpos, xquat, fall) of B perturbed reference states
    across the clip, their frames, and falls on about half of them."""
    g = torch.Generator().manual_seed(seed)
    s = env.reset(B, g)
    dev = env.device
    qpos = s.qpos + 0.3 * torch.randn(s.qpos.shape, generator=g).to(dev)
    qvel = s.qvel + torch.randn(s.qvel.shape, generator=g).to(dev)
    t = torch.rand(B, generator=g).to(dev) * 2.0 * float(env.clip.cycle_time)
    xpos, xquat = env._fk_batch(qpos, qvel)
    fall = (torch.rand(B, generator=g) < 0.5).to(torch.float32).to(dev)
    return qpos, qvel, t, xpos, xquat, fall


def _assert_reward_equal(env, args):
    reward, terms = env._reward_batch(*args)
    want_reward, want_terms = _loop_reward_batch(env, *args)
    assert torch.equal(reward, want_reward)
    assert terms.keys() == want_terms.keys()
    for k in terms:
        assert torch.equal(terms[k], want_terms[k]), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reward_batch_equals_the_loop(name):
    env = _env(name)
    args = _states(env, 64, seed=11)
    _assert_reward_equal(env, args)
    reward = env._reward_batch(*args)[0]
    if name == "backflip":  # the aerial window and the drift term are live
        ph = phase(env.clip, args[2])
        assert bool(((ph > 0.3) & (ph < 0.47)).any())
    assert bool((reward[args[5] > 0] == 0).all()) and bool((reward[args[5] == 0] > 0).all())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_equals_the_loop(name, monkeypatch):
    """A whole env step (obs, reward, done, metrics) with the batched reward
    equals one with the per-joint loop and per-call host tables, from the
    same state."""
    env = _env(name)
    g = torch.Generator().manual_seed(5)
    s = env.reset(8, g)
    action = 0.1 * torch.randn(8, env.action_size, generator=g)
    out = env.step(s, action)
    monkeypatch.setattr(quat, "conj", _conj)
    monkeypatch.setattr(env, "_reward_batch", lambda *a: _loop_reward_batch(env, *a))
    want = env.step(s, action)
    for f in ("qpos", "qvel", "time", "obs", "reward", "done"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert out.metrics.keys() == want.metrics.keys()
    for k in out.metrics:
        assert torch.equal(out.metrics[k], want.metrics[k]), k


def test_conj_equals_the_host_table():
    q = torch.randn(5, 4, dtype=torch.float64)
    assert torch.equal(quat.conj(q), _conj(q))
    assert torch.equal(quat.conj(q.float()), _conj(q.float()))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpyAsync",
                   "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reward_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = _env(name, device="cuda", backend="kernel")
    args = _states(env, 2048, seed=13)
    _assert_reward_equal(env, args)
    env._reward_batch(*args)  # tables built
    torch.cuda.synchronize()

    g = torch.Generator().manual_seed(17)
    s = env.reset(2048, g)
    action = 0.1 * torch.randn(2048, env.action_size, generator=g).cuda()
    env.step(s, action)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        env.step(s, action)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_card = lambda e: e.device_type() == torch.autograd.DeviceType.CUDA  # noqa: E731
    host = [(e.name(), e.start_ns(), e.start_ns() + max(e.duration_ns(), 0), e.correlation_id())
            for e in events if not on_card(e)]
    (span,) = [(a, b) for n, a, b, _ in host if n == "vec/reward"]
    launches = {c: n for n, a, _, c in host
                if span[0] <= a <= span[1] and n.startswith(LAUNCH_PREFIXES)}
    copies = [e.name() for e in events
              if on_card(e) and "HtoD" in e.name() and e.correlation_id() in launches]
    assert not copies, copies
    assert 0 < len(launches) <= 700, len(launches)

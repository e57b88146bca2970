"""The port's spans and counters (``pbrl_tpu_torch.utils.profiling``).

With no profiler a span is a shared no-op and counts nothing. Under
``torch.profiler`` on the CPU, one PPO iteration and one short evaluation
give each span its count and its parent, as op-scope host events (not user
annotations); the counters equal what the states show; and a rollout under
the profiler is bit-identical to one without it. The test marked ``gpu``
runs on the card (``python -m pytest --noconftest -q -m gpu
tests/test_torch_tracing.py``): the kernel's launch, a replayed graph's,
inside ``vec/step`` on the device trace's clock (a replay has no
``vec/physics``), no device event named as a span, the same launches with
the spans switched off, and ``ppo.train``'s timing without a synchronize
between rollout and learn.
"""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs import vec as vec_mod
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import optim, ppo
from pbrl_tpu_torch.utils import profiling

# Each span's parent span (None: outermost).
PARENT = {
    "ppo/rollout": None, "ppo/policy": ("ppo/rollout", "ppo/evaluate"),
    "vec/step": ("ppo/rollout", "ppo/evaluate"), "vec/targets": "vec/step",
    "vec/physics": "vec/step", "vec/obs": "vec/step", "vec/reward": "vec/step",
    "vec/termination": "vec/step", "vec/auto_reset": "ppo/rollout",
    "vec/reset": "vec/auto_reset", "vec/curriculum": "vec/auto_reset",
    "ppo/learn": None, "ppo/gae": "ppo/learn", "ppo/minibatch": "ppo/learn",
    "ppo/loss": "ppo/minibatch", "ppo/backward": "ppo/minibatch",
    "optim/step": "ppo/minibatch", "ppo/evaluate": None,
}
SMALL = dict(num_envs=4, unroll_length=3, num_minibatches=2, update_epochs=2, hidden=(16, 16))


def _env(clip="walk", device="cpu", backend="xla", **cfg):
    """A small env: 2 substeps a policy step; episodes end after 6 ms."""
    cfg = {"policy_dt": 0.004, "max_episode_time": 0.006, **cfg}
    return MimicVecEnv(humanoid_model(), load_clip(clip, device=device), EnvConfig(**cfg),
                       backend=backend, device=device)


def _spans(prof):
    """The program's spans among the profiler's events."""
    return [e for e in prof.events() if e.name in PARENT]


@pytest.fixture(autouse=True)
def _empty_tally():
    profiling.counters()
    yield
    profiling.counters()


def test_spans_off_record_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    a, b = profiling.trace_annotation("ppo/policy"), profiling.trace_annotation("vec/step")
    assert a is b
    with a, b:
        profiling.count("vec/fresh_states", 4)
        profiling.count("vec/resets", torch.ones(4))
    env = _env()
    cfg = ppo.TrainConfig(**SMALL)
    ppo.train_step(env, cfg, ppo.init(env, cfg, "cpu"))
    assert profiling.counters() == {}


def test_count_keeps_references_and_reduces_at_read():
    done = torch.tensor([1.0, 0.0, 1.0])
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("a", 2)
        profiling.count("a", done)
        profiling.count("b", torch.tensor([True, False, True]), where=done * 0 + 1)
        profiling.count("b", torch.tensor([True, True, False]), where=done)
    assert profiling._tally["a"][1] is done
    assert profiling.counters() == {"a": 4, "b": 3}
    assert profiling.counters() == {}


def test_span_counts_and_nesting():
    env = _env()
    cfg = ppo.TrainConfig(**SMALL)
    ts = ppo.init(env, cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ppo.train_step(env, cfg, ts)
    n = collections.Counter(e.name for e in _spans(prof))
    T, mbs = cfg.unroll_length, cfg.update_epochs * cfg.num_minibatches
    assert n["ppo/policy"] == n["vec/step"] == n["vec/physics"] == n["vec/auto_reset"] == T
    assert n["vec/termination"] == 2 * T and n["vec/curriculum"] == 0
    assert n["ppo/minibatch"] == n["ppo/loss"] == n["ppo/backward"] == n["optim/step"] == mbs
    assert n["ppo/rollout"] == n["ppo/learn"] == n["ppo/gae"] == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof_eval:
        ppo.evaluate(env, ts.policy, ts.obs_stats, num_envs=3, num_steps=2)
    m = collections.Counter(e.name for e in _spans(prof_eval))
    assert m["ppo/evaluate"] == 1 and m["ppo/policy"] == m["vec/step"] == 2
    assert m["vec/auto_reset"] == 0
    for p in (prof, prof_eval):
        for e in _spans(p):
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            want = PARENT[e.name]
            assert parent in (want if isinstance(want, tuple) else (want,)), (e.name, parent)
        for k in p.profiler.kineto_results.events():
            if k.name() in PARENT:
                assert not k.is_user_annotation(), k.name()


def test_counters_equal_the_states():
    # a rollout: every done env restarts, each auto_reset draws a whole batch
    env = _env()
    cfg = ppo.TrainConfig(**SMALL)
    ts = ppo.init(env, cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        _, traj = ppo.rollout(env, cfg, ts)
    got = profiling.counters()
    assert got["vec/resets"] == int(traj.done.sum()) > 0
    assert got["vec/fresh_states"] == cfg.num_envs * cfg.unroll_length
    assert got["vec/quarantined"] == 0
    assert profiling.counters() == {}

    # the curriculum at p = 1 and no phase window: every done env restarts
    # from a live peer, whose time it takes
    env = _env("backflip", curriculum_reset_prob=1.0, curriculum_phase_window=())
    g = torch.Generator().manual_seed(3)
    pre = env.reset(6, g)
    pre = pre.replace(done=torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0, 1.0]))
    with profile(activities=[ProfilerActivity.CPU]):
        post = env.auto_reset(pre, g)
    got = profiling.counters()
    live_t = set(pre.time[pre.done == 0].tolist())
    from_peer = sum(t in live_t for t in post.time[pre.done > 0].tolist())
    assert got["vec/curriculum_restarts"] == from_peer == got["vec/resets"] == 3
    assert got["vec/fresh_states"] == 6

    # one env given a NaN is quarantined
    env = _env()
    s = env.reset(4, torch.Generator().manual_seed(4))
    qvel = s.qvel.clone()
    qvel[2, 0] = float("nan")
    with profile(activities=[ProfilerActivity.CPU]):
        out = env.step(s.replace(qvel=qvel), torch.zeros(4, env.action_size))
    assert profiling.counters() == {"vec/quarantined": 1, "vec/steps": 1}
    assert out.done[2] == 1 and torch.isfinite(out.qvel).all()


def test_rollout_bit_identical_under_profiler():
    env = _env()
    cfg = ppo.TrainConfig(**SMALL)
    outs = []
    for traced in (False, True):
        ts = ppo.init(env, cfg, "cpu")
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            state, traj = ppo.rollout(env, cfg, ts)
            ppo.learn(cfg, ts, state, traj)
        outs.append((state, traj, ts.params()))
    (s0, t0, p0), (s1, t1, p1) = outs
    for f in ("obs", "action", "log_prob", "reward", "done", "value"):
        assert torch.equal(getattr(t0, f), getattr(t1, f)), f
    assert torch.equal(s0.qpos, s1.qpos) and torch.equal(s0.obs, s1.obs)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpyAsync",
                   "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD")


def _traced_rollout(env, cfg, ts):
    """(host events, device events) of one rollout under the profiler, each
    as (name, start ns, end ns, correlation id)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ppo.rollout(env, cfg, ts)
        torch.cuda.synchronize()
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        ev = (e.name(), e.start_ns(), e.start_ns() + max(e.duration_ns(), 0), e.correlation_id())
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(ev)
    return host, dev


@pytest.mark.gpu
def test_spans_on_the_device_clock(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = _env(device="cuda", backend="kernel", policy_dt=1 / 30, max_episode_time=0.2)
    cfg = ppo.TrainConfig(**dict(SMALL, num_envs=256, unroll_length=8))
    ts = ppo.init(env, cfg, "cuda")
    ppo.rollout(env, cfg, ts)  # builds the kernel and captures the step
    host, dev = _traced_rollout(env, cfg, ts)
    steps = [(a, b) for n, a, b, _ in host if n == "vec/step"]
    kernels = [(a, c) for n, a, _, c in dev if "mimic_step_kernel" in n]
    assert len(steps) == len(kernels) == cfg.unroll_length
    assert not [n for n, _, _, _ in host if n == "vec/physics"]
    launch_at = {c: (n, a) for n, a, _, c in host if n.startswith(LAUNCH_PREFIXES)}
    for start, corr in kernels:
        name, at = launch_at[corr]
        assert name == "cudaGraphLaunch"
        (span,) = [(a, b) for a, b in steps if a <= at <= b]
        assert start > span[0]
    assert not [n for n, _, _, _ in dev if n in PARENT or "/" in n and ":" not in n]
    launches_on = sum(n.startswith(LAUNCH_PREFIXES) for n, _, _, _ in host)

    off = lambda name: contextlib.nullcontext()  # noqa: E731
    for mod in (ppo, vec_mod, optim):
        monkeypatch.setattr(mod, "trace_annotation", off)
    host_off, _ = _traced_rollout(env, cfg, ts)
    assert not [n for n, _, _, _ in host_off if n in PARENT]
    assert sum(n.startswith(LAUNCH_PREFIXES) for n, _, _, _ in host_off) == launches_on


@pytest.mark.gpu
def test_train_times_without_a_synchronize(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = _env(device="cuda", backend="kernel", policy_dt=1 / 30, max_episode_time=0.2)
    cfg = ppo.TrainConfig(**dict(SMALL, num_envs=256, unroll_length=8, total_env_steps=3 * 2048))
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (calls.append(a), real(*a)))
    _, history = ppo.train(env, cfg, device="cuda")
    assert len(history) == 3 and len(calls) == 1
    for h in history:
        assert h["rollout_s"] > 0 and h["learn_s"] > 0 and h["sps"] > 0

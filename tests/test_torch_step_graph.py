"""``MimicVecEnv.step`` replayed as a captured CUDA graph.

On the CPU, on the engine backend and with a gradient to carry, the step
runs its body eagerly, captures nothing and gives ``_step``'s bits; the
counters ``vec/steps``, ``vec/graph_replays`` and ``vec/graph_captures``
tally while a profiler records and not otherwise; the packed blocks' views
have the shapes, alignment and contiguity of tensors of their own.

The tests marked ``gpu`` run on the card (``python -m pytest --noconftest
-q -m gpu tests/test_torch_step_graph.py``): walk and backflip at 2048 and
4096 envs from one seeded reset, every replayed step equal to the eager
body's (``torch.equal``), no step's outputs written by a later one, one
kernel launch counted per step, a swapped ``_kstep`` captured anew (and the
original again after the undo), held PD and the engine eager.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs import vec as vec_mod
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.ops import mimic_kernel
from pbrl_tpu_torch.train import checkpoint
from pbrl_tpu_torch.train.running_stats import normalize
from pbrl_tpu_torch.utils import profiling
from pbrl_tpu_torch.utils.configio import dict_to_config

GRAPH_COUNTERS = ("vec/steps", "vec/graph_replays", "vec/graph_captures")


@pytest.fixture(autouse=True)
def _empty_tally():
    profiling.counters()
    yield
    profiling.counters()


def _small_env(backend, clip="walk", device="cpu", **cfg):
    """2 substeps a policy step."""
    cfg = {"policy_dt": 0.004, **cfg}
    return MimicVecEnv(humanoid_model(), load_clip(clip, device=device), EnvConfig(**cfg),
                       backend=backend, device=device)


def _fields(s):
    out = {f: getattr(s, f) for f in ("qpos", "qvel", "time", "episode_start", "obs",
                                      "reward", "done")}
    out.update({f"metrics/{k}": v for k, v in s.metrics.items()})
    return out


def _assert_same(got, want):
    a, b = _fields(got), _fields(want)
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert x.is_contiguous() and y.is_contiguous(), k
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cpu", "engine", "grad"])
def test_eager_where_no_graph_applies(case):
    env = _small_env("xla" if case == "engine" else "kernel")
    state = env.reset(3, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    action = 0.2 * torch.randn(3, env.action_size, generator=g)
    if case == "grad":
        action.requires_grad_(True)
    with torch.enable_grad() if case == "grad" else torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU]):
            got = env.step(state, action)
            want = env._step(state, action)
    counts = profiling.counters()
    assert counts["vec/steps"] == 1
    assert "vec/graph_replays" not in counts and "vec/graph_captures" not in counts
    assert env._graphs == {}
    _assert_same(got, want)
    assert got.episode_start is state.episode_start
    if case == "grad":
        got.reward.sum().backward()
        assert action.grad is not None and torch.isfinite(action.grad).all()


def test_step_counters_tally_only_under_a_profiler():
    env = _small_env("kernel")
    state = env.reset(2, torch.Generator().manual_seed(1))
    action = torch.zeros(2, env.action_size)
    s = env.step(state, action)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            s = env.step(s, action)
    counts = profiling.counters()
    assert {k: counts.get(k, 0) for k in GRAPH_COUNTERS} == {
        "vec/steps": 3, "vec/graph_replays": 0, "vec/graph_captures": 0}
    assert counts["vec/quarantined"] == 0
    env.step(s, action)
    assert profiling.counters() == {}


@pytest.mark.parametrize("batch", [1, 3, 128, 4096])
def test_packed_views_are_aligned_and_contiguous(batch):
    shapes = [(batch, 35), (batch, 34), (batch,), (batch, 197), (batch, 1)]
    tensors = [torch.randn(s) for s in shapes]
    layout, size = vec_mod._layout(shapes)
    assert all(at % vec_mod._ALIGN == 0 for at, _ in layout)
    assert [n for _, n in layout] == [t.numel() for t in tensors]
    assert size % vec_mod._ALIGN == 0 and size >= layout[-1][0] + layout[-1][1]
    fill = vec_mod._fillers(layout, size, "cpu")
    out = torch.zeros(size)
    vec_mod._pack(tensors, fill, out=out)
    for block in (out, vec_mod._pack(tensors, fill)):
        assert block.shape == (size,)
        for view, t in zip(vec_mod._unpack(block, layout, shapes), tensors):
            assert view.shape == t.shape and view.is_contiguous()
            assert view.data_ptr() % 512 == block.data_ptr() % 512
            assert torch.equal(view, t)


def test_captured_launches_record_only_inside_the_block():
    with mimic_kernel.captured_launches() as outer:
        assert mimic_kernel._captures == [outer]
        with mimic_kernel.captured_launches() as inner:
            assert mimic_kernel._captures == [outer, inner]
        assert mimic_kernel._captures == [outer]
    assert mimic_kernel._captures == [] and outer == [] and inner == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _recipe(clip, dev):
    """The clip's training env (its run config, every term on) and its
    shipped policy's mean action."""
    policy, stats, run = checkpoint.load_policy(checkpoint.bundled_policy(clip), device=dev)
    env = MimicVecEnv(humanoid_model(), load_clip(clip, device=dev),
                      dict_to_config(EnvConfig, dict(run["env_config"])), device=dev)

    def act(state):
        return policy(normalize(stats, state.obs))[0]
    return env, act


@pytest.mark.gpu
@pytest.mark.parametrize("clip,steps", [("walk", 300), ("backflip", 256)])
@pytest.mark.parametrize("num_envs", [2048, 4096])
def test_replay_equals_eager(clip, steps, num_envs):
    dev = _card()
    env, act = _recipe(clip, dev)
    state = env.reset(num_envs, torch.Generator(device=dev).manual_seed(11))
    ks = env._kstep
    prev = None
    with torch.no_grad():
        for i in range(steps):
            action = act(state)
            want = env._step(state, action)
            n0 = ks.launches
            got = env.step(state, action)
            assert ks.launches == n0 + 1, i
            _assert_same(got, want)
            if prev is not None:  # step i-1's outputs, untouched by step i
                _assert_same(prev[0], prev[1])
            prev = (got, vec_mod.VecState(**{f: getattr(got, f).clone() for f in (
                "qpos", "qvel", "time", "episode_start", "obs", "reward", "done")},
                metrics={k: v.clone() for k, v in got.metrics.items()}))
            state = got
    (entry,) = env._graphs.values()
    assert isinstance(entry.graph, vec_mod._Graph) and entry.graph._launched == [ks]


@pytest.mark.gpu
def test_swapped_kernel_captures_again():
    dev = _card()
    env, act = _recipe("walk", dev)
    state = env.reset(2048, torch.Generator(device=dev).manual_seed(3))
    inner = env._kstep

    class Altered:
        def __init__(self, k):
            self.k = k

        def __call__(self, q, v, u):
            out = list(self.k(q, v, u))
            out[1] = out[1] + 0.05
            return tuple(out)

        def __getattr__(self, name):
            return getattr(self.k, name)

    def run(n):
        nonlocal state
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(n):
                action = act(state)
                want = env._step(state, action)
                got = env.step(state, action)
                _assert_same(got, want)
                state = got
        counts = profiling.counters()
        return {k: counts.get(k, 0) for k in GRAPH_COUNTERS}

    once = {"vec/steps": 4, "vec/graph_replays": 3, "vec/graph_captures": 1}
    with torch.no_grad():
        assert run(4) == once
        n0 = inner.launches
        env._kstep = Altered(inner)
        assert run(4) == once
        assert inner.launches == n0 + 8  # 4 eager bodies and 4 steps
        action = act(state)
        altered = env.step(state, action)
        env._kstep = inner
        assert not torch.equal(altered.qvel, env._step(state, action).qvel)
        assert run(4) == once
    assert len(env._graphs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["held_pd", "engine"])
def test_held_pd_and_engine_stay_eager(case):
    dev = _card()
    cfg = {"pd_per_substep": False} if case == "held_pd" else {}
    env = _small_env("xla" if case == "engine" else "kernel", device=dev, **cfg)
    state = env.reset(256, torch.Generator(device=dev).manual_seed(2))
    action = torch.zeros(256, env.action_size, device=dev)
    with torch.no_grad():
        for _ in range(3):
            got = env.step(state, action)
            _assert_same(got, env._step(state, action))
            state = got
    assert env._graphs == {}

"""``MimicVecEnv.auto_reset`` replayed as a captured CUDA graph.

On the CPU ``auto_reset`` runs its body eagerly and captures nothing, also
with ``t0``, ``u`` or ``peer`` given, with a gradient and with the link
observation; the counters ``vec/auto_resets``, ``vec/reset_replays`` and
``vec/reset_captures`` tally while a profiler records and not otherwise;
the body fed the draws of a recorded plan gives the eager body's bits and
leaves the generator where the eager body leaves it; and the replay's
bookkeeping (eager first call, capture, replay, a swapped config) runs
with a stand-in for the graph.

The tests marked ``gpu`` run on the card (``python -m pytest --noconftest
-q -m gpu tests/test_torch_reset_graph.py``): walk and backflip at 2048
envs from one seeded reset, over two PPO rollouts with some envs forced
done at every step, every replayed ``auto_reset`` equal (``torch.equal``)
to the eager body's with two generators cloned from one state, the
generators' states equal afterwards, no call's outputs written by a later
one and ``vec/curriculum_restarts`` equal on both paths; a swapped
config (curriculum off) captured anew and in effect; the engine backend
bit-equal too; and the cases above eager on the card.
"""

import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.envs import vec as vec_mod
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import checkpoint
from pbrl_tpu_torch.train.running_stats import normalize
from pbrl_tpu_torch.utils import profiling
from pbrl_tpu_torch.utils.configio import dict_to_config

RESET_COUNTERS = ("vec/auto_resets", "vec/reset_replays", "vec/reset_captures")
FIELDS = ("qpos", "qvel", "time", "episode_start", "obs")


@pytest.fixture(autouse=True)
def _empty_tally():
    profiling.counters()
    yield
    profiling.counters()


def _recipe(clip, device, backend="kernel", **cfg):
    """The clip's training env (its run config, every term on, with
    ``cfg`` on top) and its shipped policy's mean action."""
    policy, stats, run = checkpoint.load_policy(checkpoint.bundled_policy(clip), device=device)
    config = dict_to_config(EnvConfig, {**run["env_config"], **cfg})
    env = MimicVecEnv(humanoid_model(), load_clip(clip, device=device), config,
                      backend=backend, device=device)

    def act(state):
        return policy(normalize(stats, state.obs))[0]
    return env, act


def _inputs(state):
    return (state.qpos, state.qvel, state.time, state.episode_start, state.obs, state.done)


def _draws(env, state, generator):
    return vec_mod._Draws(state.done.shape[0], generator, env.device, env.mesh)


def _twin(generator):
    """A generator on the same device in the same state."""
    return torch.Generator(device=generator.device).set_state(generator.get_state())


def _assert_same(got, want):
    for k in FIELDS:
        x, y = got[k], want[k]
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def _forced(state, generator, share=0.05):
    """``state`` with a random share of its envs done besides."""
    hit = torch.rand(state.done.shape[0], generator=generator, device=state.done.device) < share
    return state.replace(done=torch.maximum(state.done, hit.to(state.done.dtype)))


def _overrides(case, env, state):
    B = state.done.shape[0]
    g = torch.Generator(device=env.device).manual_seed(9)
    return {"t0": {"t0": torch.rand(B, generator=g, device=env.device)},
            "u": {"u": torch.rand(B, generator=g, device=env.device)},
            "peer": {"peer": torch.randint(B, (B,), generator=g, device=env.device)},
            }.get(case, {})


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def _small_env(clip="backflip", **cfg):
    """2 substeps a policy step; the recipe's curriculum at p = 1 over the
    whole clip, so that every done env with a live peer restarts from it."""
    cfg = {"policy_dt": 0.004, "curriculum_reset_prob": 1.0, "curriculum_phase_window": (),
           **cfg}
    return _recipe(clip, "cpu", backend="xla", **cfg)[0]


@pytest.mark.parametrize("case", ["cpu", "t0", "u", "peer", "grad", "link_obs"])
def test_eager_where_no_graph_applies(case):
    env = _small_env(include_link_obs=case == "link_obs")
    state = env.reset(6, torch.Generator().manual_seed(5))
    state = state.replace(done=torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0, 1.0]))
    if case == "grad":
        state = state.replace(qpos=state.qpos.clone().requires_grad_(True))
    kw = _overrides(case, env, state)
    g = torch.Generator().manual_seed(6)
    twin = _twin(g)
    with torch.enable_grad() if case == "grad" else torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU]):
            got = env.auto_reset(state, g, **kw)
        want, use = env._renew(*_inputs(state), _draws(env, state, twin), **kw)
    counts = profiling.counters()
    assert counts["vec/auto_resets"] == 1
    assert "vec/reset_replays" not in counts and "vec/reset_captures" not in counts
    assert env._reset_graphs == {}
    _assert_same({k: getattr(got, k) for k in FIELDS}, want)
    assert torch.equal(g.get_state(), twin.get_state())
    assert counts["vec/curriculum_restarts"] == int((use["use"] & (state.done > 0)).sum())
    assert got.reward is state.reward and got.done is state.done
    if case == "grad":
        got.qpos.sum().backward()
        assert torch.equal(state.qpos.grad[:, 0], 1.0 - state.done)


def test_reset_counters_tally_only_under_a_profiler():
    env = _small_env()
    g = torch.Generator().manual_seed(1)
    s = env.reset(4, g)
    s = env.auto_reset(s.replace(done=torch.ones(4)), g)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            s = env.auto_reset(s, g)
    counts = profiling.counters()
    assert {k: counts.get(k, 0) for k in RESET_COUNTERS} == {
        "vec/auto_resets": 3, "vec/reset_replays": 0, "vec/reset_captures": 0}
    assert counts["vec/fresh_states"] == 12
    env.auto_reset(s, g)
    assert profiling.counters() == {}


@pytest.mark.parametrize("clip", ["walk", "backflip"])
def test_predrawn_body_equals_eager(clip):
    """The plan records the draws of ``reset`` (RSI times, reset noise)
    and of the curriculum (``u``, ``r``) in order; made again from a twin
    generator and fed to the body the graph captures, they give the eager
    body's bits and leave the generator where the eager body leaves it."""
    env = _recipe(clip, "cpu", backend="xla", policy_dt=0.004)[0]
    g = torch.Generator().manual_seed(3)
    state = env.reset(8, g)
    state = _forced(state.replace(time=state.time + 0.1), torch.Generator().manual_seed(4),
                    share=0.5)
    first, second = _twin(g), _twin(g)
    draw = _draws(env, state, first)
    want = env._renew(*_inputs(state), draw)
    assert draw.plan == {"walk": [(torch.rand, (), True)],
                    "backflip": [(torch.rand, (), True), (torch.rand, (2,), True),
                                 (torch.rand, (), False), (torch.rand, (), False)]}[clip]
    drawn = _draws(env, state, second).take(draw.plan)
    got = env._renew_drawn(*_inputs(state), *drawn)
    _assert_same(got[0], want[0])
    assert list(got[1]) == list(want[1]) and all(torch.equal(got[1][k], want[1][k])
                                                 for k in want[1])
    assert torch.equal(first.get_state(), second.get_state())
    post = env.auto_reset(state, g)
    _assert_same({k: getattr(post, k) for k in FIELDS}, want[0])
    assert torch.equal(g.get_state(), first.get_state())


class _StandIn:
    """A CPU stand-in for :class:`vec._Graph`: each replay runs the body
    on copies of the inputs and returns float32 copies of its outputs."""

    made = 0

    def __init__(self, body, inputs):
        self.body = body
        _StandIn.made += 1

    def replay(self, inputs):
        groups = self.body(*[x.clone() for x in inputs])
        return tuple({k: v.to(torch.float32).clone() for k, v in g.items()} for g in groups)


def test_replay_bookkeeping_with_a_stand_in(monkeypatch):
    """The first call of a shape runs eagerly and records the draws, the
    second captures, later ones replay; a swapped config starts over. Every
    call equals an eager twin env's, with the generators alike."""
    monkeypatch.setattr(vec_mod, "_Graph", _StandIn)
    monkeypatch.setattr(vec_mod, "_capturable",
                        lambda xs: all(x.dtype == torch.float32 for x in xs))
    env, twin_env = _small_env(curriculum_reset_prob=0.5), _small_env(curriculum_reset_prob=0.5)
    g = torch.Generator().manual_seed(2)
    state = env.reset(8, g)
    gt = _twin(g)
    forced = torch.Generator().manual_seed(3)
    kept = []

    def run(n):
        nonlocal state
        counts = collections.Counter()
        with torch.no_grad():
            for _ in range(n):
                pre = _forced(state.replace(time=state.time + 0.05), forced, share=0.4)
                with monkeypatch.context() as m:
                    m.setattr(vec_mod, "_capturable", lambda xs: False)
                    want = twin_env.auto_reset(pre, gt)
                with profile(activities=[ProfilerActivity.CPU]):
                    state = env.auto_reset(pre, g)
                counts.update(profiling.counters())
                _assert_same({k: getattr(state, k) for k in FIELDS},
                             {k: getattr(want, k) for k in FIELDS})
                assert torch.equal(g.get_state(), gt.get_state())
                kept.append((state, {k: getattr(state, k).clone() for k in FIELDS}))
        return {k: counts.get(k, 0) for k in RESET_COUNTERS + ("vec/curriculum_restarts",)}

    _StandIn.made = 0
    once = run(5)
    assert {k: once[k] for k in RESET_COUNTERS} == {
        "vec/auto_resets": 5, "vec/reset_replays": 4, "vec/reset_captures": 1}
    assert once["vec/curriculum_restarts"] > 0
    (entry,) = env._reset_graphs.values()
    assert len(entry.plan) == 4 and isinstance(entry.graph, _StandIn)
    config = env.config
    env.config = twin_env.config = dataclasses.replace(config, curriculum_reset_prob=0.0)
    off = run(4)
    assert off == {"vec/auto_resets": 4, "vec/reset_replays": 3, "vec/reset_captures": 1,
                   "vec/curriculum_restarts": 0}
    (entry,) = env._reset_graphs.values()
    assert len(entry.plan) == 2 and _StandIn.made == 2
    for got, copy in kept:
        _assert_same({k: getattr(got, k) for k in FIELDS}, copy)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rollouts(env, act, num_envs, steps, seed=11):
    """``steps`` env steps from one seeded reset, with some envs forced done
    at every step: each ``auto_reset`` (replayed from the third call)
    against the eager body's on a twin generator. Returns the counters and
    the curriculum's restarts by the eager body."""
    dev = env.device
    g = torch.Generator(device=dev).manual_seed(seed)
    state = env.reset(num_envs, g)
    forced = torch.Generator(device=dev).manual_seed(seed + 1)
    kept, restarts = [], 0
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for i in range(steps):
            nstate = _forced(env.step(state, act(state)), forced)
            twin = _twin(g)
            want, use = env._renew(*_inputs(nstate), _draws(env, nstate, twin))
            if use:
                restarts += int((use["use"] & (nstate.done > 0)).sum())
            state = env.auto_reset(nstate, g)
            _assert_same({k: getattr(state, k) for k in FIELDS}, want)
            assert torch.equal(g.get_state(), twin.get_state()), i
            assert state.reward is nstate.reward and state.done is nstate.done
            kept.append((state, {k: getattr(state, k).clone() for k in FIELDS}))
    for got, copy in kept:  # no call's outputs written by a later one
        _assert_same({k: getattr(got, k) for k in FIELDS}, copy)
    counts = profiling.counters()
    return counts, restarts


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["walk", "backflip"])
def test_replay_equals_eager(clip):
    dev = _card()
    env, act = _recipe(clip, dev)
    steps = 32  # two rollouts of the recipe's 16 steps
    counts, restarts = _rollouts(env, act, 2048, steps)
    assert {k: counts.get(k, 0) for k in RESET_COUNTERS} == {
        "vec/auto_resets": steps, "vec/reset_replays": steps - 1, "vec/reset_captures": 1}
    assert counts.get("vec/curriculum_restarts", 0) == restarts
    if clip == "backflip":
        assert restarts > 0
    (entry,) = env._reset_graphs.values()
    assert isinstance(entry.graph, vec_mod._Graph) and entry.graph._launched == []


@pytest.mark.gpu
def test_swapped_config_captures_again():
    dev = _card()
    env, act = _recipe("backflip", dev)
    config = env.config
    on = _rollouts(env, act, 2048, 4)
    env.config = dataclasses.replace(config, curriculum_reset_prob=0.0)
    off = _rollouts(env, act, 2048, 4)
    (entry,) = env._reset_graphs.values()
    assert len(entry.plan) == 2  # the reset's draws alone: no curriculum draws
    env.config = config
    again = _rollouts(env, act, 2048, 4)
    for counts, _ in (on, off, again):
        assert {k: counts.get(k, 0) for k in RESET_COUNTERS} == {
            "vec/auto_resets": 4, "vec/reset_replays": 3, "vec/reset_captures": 1}
    assert on[1] > 0 and again[1] > 0
    assert off[1] == 0 and "vec/curriculum_restarts" not in off[0]
    (entry,) = env._reset_graphs.values()
    assert len(entry.plan) == 4


@pytest.mark.gpu
def test_engine_backend_replays_bit_equal():
    dev = _card()
    env, act = _recipe("backflip", dev, backend="xla")
    counts, _ = _rollouts(env, act, 256, 5)
    assert {k: counts.get(k, 0) for k in RESET_COUNTERS} == {
        "vec/auto_resets": 5, "vec/reset_replays": 4, "vec/reset_captures": 1}
    assert env._graphs == {}  # the engine's step stays eager


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["t0", "u", "peer", "grad", "link_obs"])
def test_eager_on_the_card_where_no_graph_applies(case):
    dev = _card()
    env, _ = _recipe("backflip", dev, include_link_obs=case == "link_obs")
    state = _forced(env.reset(256, torch.Generator(device=dev).manual_seed(2)),
                    torch.Generator(device=dev).manual_seed(3), share=0.2)
    if case == "grad":
        state = state.replace(qpos=state.qpos.clone().requires_grad_(True))
    kw = _overrides(case, env, state)
    g = torch.Generator(device=dev).manual_seed(4)
    with torch.enable_grad() if case == "grad" else torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                twin = _twin(g)
                got = env.auto_reset(state, g, **kw)
                want, _ = env._renew(*_inputs(state), _draws(env, state, twin), **kw)
                _assert_same({k: getattr(got, k) for k in FIELDS}, want)
    counts = profiling.counters()
    assert counts["vec/auto_resets"] == 3 and "vec/reset_captures" not in counts
    assert env._reset_graphs == {}

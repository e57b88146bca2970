"""The yardstick's arithmetic on inputs with known answers."""

import math
import statistics
import types

import pytest
import torch

from benchmark import flops, run
from benchmark.trace import LAUNCH_CALLS, STEP_MARK, UNIT_MARK, Trace


def ctx(**kw):
    base = dict(log=lambda m: None, card={}, flops=flops, kernel=None, trace=None, spans={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_step_ms_p95_known():
    intervals = [float(i) for i in range(1, 101)]   # 1..100 ms
    got = run.reader("step_ms_p95")(ctx(intervals_ms=intervals))
    assert got == pytest.approx(95.05)
    assert got == statistics.quantiles(intervals, n=20, method="inclusive")[18]
    assert run.reader("step_ms_p95")(ctx(intervals_ms=[3.0])) is None


def test_device_idle_pct_union():
    # window 0..100 ns; device busy 10..30 and 20..40 (overlap) and 60..70: 40 ns
    tr = Trace(device=[("k", 10, 30), ("k", 20, 40), ("m", 60, 70)],
               host=[("aten::x", 0, 100)])
    assert tr.busy_ns() == 40
    assert tr.window_ns() == 100
    assert run.reader("device_idle_pct")(ctx(trace=tr)) == pytest.approx(60.0)
    assert tr.top_device_ops() == [["k", 40e-9], ["m", 10e-9]]
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(20e-9) and gaps[0][0] == "aten::x"


def test_launches_per_step_counts_inside_step_spans():
    host = [(UNIT_MARK, 0, 0), ("cudaLaunchKernel", 1, 2), (STEP_MARK, 10, 10),
            ("cudaLaunchKernel", 11, 12), ("cudaMemcpyAsync", 13, 14), (STEP_MARK, 20, 20),
            ("cudaLaunchKernel", 25, 26),                       # after the last step: learn
            (UNIT_MARK, 30, 30), ("cudaLaunchKernel", 31, 32), ("aten::mm", 33, 34),
            (STEP_MARK, 40, 40)]
    tr = Trace(device=[("k", 0, 1)], host=host)
    assert tr.step_spans() == [(0, 10), (10, 20), (30, 40)]
    assert tr.launches_per_step() == pytest.approx(4 / 3)
    assert "cudaGraphLaunch" in LAUNCH_CALLS


def test_step_mfu_pct_known():
    # 67e12 f32 FLOP of kernel and 495e12 TF32 FLOP of matmuls in 2 s: 100%
    assert flops.step_mfu_pct({"matmul": 495e12, "vector": 67e12}, 2.0, "tf32") == pytest.approx(100.0)
    # f32 matmuls: 67e12 FLOP in 4 s: 25%
    assert flops.step_mfu_pct({"matmul": 67e12, "vector": 0.0}, 4.0, "fp32") == pytest.approx(25.0)
    assert flops.mlp_forward([68, 1024, 512, 28]) == 2 * (68 * 1024 + 1024 * 512 + 512 * 28)


def test_kernel_roofline_bound():
    spec = types.SimpleNamespace(nq=35, nv=34, nu=28, nbody=13)
    least, bound = flops.kernel_least_s(spec, 1e6, 1000)
    assert least == pytest.approx(1e9 / 67e12) and bound.startswith("operations")
    least, bound = flops.kernel_least_s(spec, 0.0, 1000)
    assert least == pytest.approx(4 * 1000 * (2 * 69 + 28 + 91 + 1) / 3.35e12)
    assert bound.startswith("bytes")
    tr = Trace(device=[("mimic_step_kernel(x)", 0, 2_000_000), ("other", 0, 5)], host=[])
    c = ctx(trace=tr, kernel={"spec": spec, "flop_per_env": 1e6, "batch": 1000})
    assert run.reader("kernel_roofline_pct")(c) == pytest.approx(100 * (1e9 / 67e12) / 2e-3)


def test_frozen_counter_equals_the_programs():
    """At the copy's commit the frozen counter counts what the program's does."""
    from benchmark.reference.env import RefEnv
    from benchmark.run import load_cell
    from pbrl_tpu_torch.ops import field_physics as program_fp
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.utils.configio import dict_to_config
    from benchmark.reference import field_physics as frozen_fp

    _, cell, conf = load_cell("walk-eval")
    c = {**conf["env_config"], **cell["env_set"], "policy_dt": 0.004}
    ref = RefEnv(conf["clip"], c, "cpu")
    env = MimicVecEnv(humanoid_model(), load_clip(conf["clip"], device="cpu"),
                      dict_to_config(EnvConfig, c), device="cpu")
    t = torch.tensor([0.1, 0.5, 0.9])
    q, v = ref.start(t)
    u = ref.target(q, t, torch.zeros(3, 28))
    got = flops.kernel_flop_per_env(ref.spec, q, v, u)
    spec = env._kspec
    want = program_fp.count_policy_step_flops(spec, program_fp.contact_activity(spec, q, v, u)) / 3
    assert got == want
    assert frozen_fp.count_policy_step_flops(ref.spec) == program_fp.count_policy_step_flops(spec)


def test_reset_numbers_on_the_programs_resets():
    """The program's own ``auto_reset`` (backflip: root x, y noise and the
    takeoff curriculum) reads as sound; each broken rule is counted."""
    import dataclasses

    from benchmark import judge
    from benchmark.reference.env import RefEnv
    from benchmark.run import load_cell
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.utils.configio import dict_to_config

    _, _, conf = load_cell("backflip-ppo")
    c = dict(conf["env_config"], policy_dt=0.004)
    env = MimicVecEnv(humanoid_model(), load_clip("backflip", device="cpu"),
                      dict_to_config(EnvConfig, c), device="cpu")
    ref = RefEnv("backflip", c, "cpu")
    g = torch.Generator().manual_seed(5)
    first = env.reset(400, g)
    pre = first.replace(done=(torch.rand(400, generator=g) < 0.5).float())
    post = env.auto_reset(pre, g)
    sound = judge.reset_numbers(ref, first, [(pre, post)])
    assert sound["reset_wrong"] == 0 and sound["start_gap"] < 1e-6 and sound["curriculum_tail"] < 3
    assert judge.reset_numbers(ref, first, [(pre, post)], low=True)["start_gap"] > 1e-2

    live, dead = torch.nonzero(pre.done == 0)[0, 0], torch.nonzero(pre.done > 0)[0, 0]
    moved = post.replace(qvel=post.qvel.clone(), time=post.time.clone())
    moved.qvel[live, 3] += 1e-3
    moved.time[dead] += 0.01
    assert judge.reset_numbers(ref, first, [(pre, moved)])["reset_wrong"] == 2
    env.config = dataclasses.replace(env.config, curriculum_reset_prob=0.0)
    none = judge.reset_numbers(ref, first, [(pre, env.auto_reset(pre, g))])
    assert none["curriculum_restarts"] == 0 and none["curriculum_tail"] > 4
    # 0 of 10 at p = 0.15: 2 x 0.85^10; 5 of 10: 2 x P(X >= 5)
    assert judge.binomial_tail(0, 10, 0.15) == pytest.approx(-math.log10(2 * 0.85 ** 10))
    high = sum(math.comb(10, i) * 0.15 ** i * 0.85 ** (10 - i) for i in range(5, 11))
    assert judge.binomial_tail(5, 10, 0.15) == pytest.approx(-math.log10(2 * high))
    assert 0.0 <= judge.binomial_tail(2, 10, 0.15) < 0.1 and judge.binomial_tail(0, 0, 0.15) == 0.0

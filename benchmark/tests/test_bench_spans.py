"""The readers of the program's spans and counters on synthetic traces with
known answers, and their None where the program has neither."""

import types

import pytest
import torch

from benchmark import run, spans
from benchmark.trace import STEP_MARK, UNIT_MARK, Trace

NEW = ("policy_host_ms", "env_step_host_ms", "auto_reset_host_ms", "minibatch_host_ms",
       "idle_outside_spans_pct", "reset_useful_pct")


def ctx(**kw):
    logged = []
    base = dict(log=logged.append, logged=logged, card={}, kernel=None, trace=None, spans={},
                program_counters=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def stepped_trace():
    """Two policy steps, 0-100 and 100-200 ns. The first: ``ppo/policy``
    0-20, ``vec/step`` 20-60 (``vec/physics`` 30-40 inside), glue 60-70,
    ``vec/auto_reset`` 70-90, glue 90-100; the second holds no span. The
    device is busy 10-15, 35-50, 75-80 and 120-130."""
    host = [(UNIT_MARK, 0, 0), ("ppo/policy", 0, 20), ("aten::addmm", 2, 8),
            ("vec/step", 20, 60), ("vec/physics", 30, 40), ("cudaLaunchKernel", 31, 33),
            ("vec/auto_reset", 70, 90), (STEP_MARK, 100, 100), ("aten::mul", 110, 115),
            (STEP_MARK, 200, 200)]
    dev = [("k", 10, 15), ("mimic_step_kernel", 35, 50), ("k", 75, 80), ("k", 120, 130)]
    return Trace(device=dev, host=host)


def test_span_means():
    tr = stepped_trace()
    tr.host += [("ppo/policy", 300, 340), ("ppo/minibatch", 400, 1_400_400)]
    c = ctx(trace=tr)
    assert spans.span_ns(tr, "ppo/policy") == [20, 40]
    assert run.reader("policy_host_ms")(c) == pytest.approx(30e-6)
    assert run.reader("env_step_host_ms")(c) == pytest.approx(40e-6)
    assert run.reader("auto_reset_host_ms")(c) == pytest.approx(20e-6)
    assert run.reader("minibatch_host_ms")(c) == pytest.approx(1.4)


def test_idle_by_innermost_span_and_outside_share():
    tr = stepped_trace()
    # idle: 0-10, 15-35, 50-75, 80-120, 130-200 = 165 ns
    assert spans.idle_intervals(tr) == [(0, 10), (15, 35), (50, 75), (80, 120), (130, 200)]
    assert spans.innermost(tr) == [(0, 20, "ppo/policy"), (20, 30, "vec/step"),
                                   (30, 40, "vec/physics"), (40, 60, "vec/step"),
                                   (70, 90, "vec/auto_reset")]
    assert spans.idle_by_span(tr) == {"ppo/policy": 15, "vec/step": 20, "vec/physics": 5,
                                      "vec/auto_reset": 15, None: 110}
    # inside the three step spans: 55 ns of the 165 idle inside the steps
    c = ctx(trace=tr)
    assert run.reader("idle_outside_spans_pct")(c) == pytest.approx(100 * 110 / 165)
    assert any("vec/physics 0.000000005" in m for m in c.logged)
    assert any("device events named as a span: 0" in m for m in c.logged)
    # the launch at 31 ns is vec/physics's
    assert spans.launches_by_span(tr) == {"vec/physics": 1, None: 0}
    assert any("over 1 env steps: vec/physics 1, none 0" in m for m in c.logged)


def test_readers_return_none_without_spans_or_counters():
    bare = Trace(device=[("k", 10, 15), ("k", 50, 60)],
                 host=[(UNIT_MARK, 0, 0), ("aten::mul", 20, 30), (STEP_MARK, 100, 100)])
    for name in NEW:
        assert run.reader(name)(ctx(trace=bare)) is None, name
        assert run.reader(name)(ctx()) is None, name
    assert spans.idle_by_span(bare) is None and spans.launches_by_span(bare) is None
    # spans but no step markers: no share of the steps' idle time
    tr = stepped_trace()
    tr.host = [e for e in tr.host if e[0] not in (STEP_MARK, UNIT_MARK)]
    assert spans.idle_outside_pct(tr) is None


def test_reset_useful_pct_from_counters():
    c = ctx(program_counters={"vec/resets": 3, "vec/fresh_states": 12, "vec/quarantined": 0})
    assert run.reader("reset_useful_pct")(c) == pytest.approx(25.0)
    assert run.reader("reset_useful_pct")(ctx(program_counters={})) is None
    assert run.reader("reset_useful_pct")(ctx(program_counters={"vec/quarantined": 0})) is None


def test_program_counters_read_once_and_logged():
    from torch.profiler import ProfilerActivity, profile

    from pbrl_tpu_torch.utils import profiling

    profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("vec/fresh_states", 8)
        profiling.count("vec/resets", torch.tensor([1.0, 0.0, 1.0]))
    c = types.SimpleNamespace(log=[].append)
    assert spans.program_counters(c) == {"vec/fresh_states": 8, "vec/resets": 2}
    assert spans.program_counters(c) == {"vec/fresh_states": 8, "vec/resets": 2}
    assert run.reader("reset_useful_pct")(c) == pytest.approx(25.0)
    assert spans.is_span("vec/step") and not spans.is_span("aten::mul")
    assert not spans.is_span(STEP_MARK) and not spans.is_span("Memcpy HtoD (a / b)")

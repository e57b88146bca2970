"""APG's spans and counters, and the engine's (``pbrl_tpu_torch.utils.
profiling``), on the CPU.

Under ``torch.profiler`` one APG iteration (2 envs, horizon 2, 2 substeps)
opens ``apg/step`` once per window step in the forward and once more per
step recomputed in the backward (``remat``), ``apg/loss`` once, and the
engine's five phase spans once per substep of each of those steps; the
counter ``apg/recomputes`` reads the horizon with ``remat`` and 0
without; ``apg/nonfinite_grad`` counts the NaN gradient entries
``optim.Adam(zero_nans=True)`` zeroes. With no profiler the spans are the
shared no-op and nothing is counted.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import apg, optim
from pbrl_tpu_torch.utils import profiling

H = 2
ENGINE = ("engine/kinematics", "engine/collision", "engine/dynamics", "engine/solve",
          "engine/integrate")


def _env():
    return MimicVecEnv(humanoid_model(), load_clip("walk", device="cpu"),
                       EnvConfig(policy_dt=0.004), backend="xla", device="cpu")


def _iteration(remat: bool, traced: bool):
    """One APG iteration: (span counts, counters)."""
    env = _env()
    cfg = apg.APGConfig(num_envs=2, horizon=H, hidden=(16,), action_noise=0.05,
                        total_env_steps=2 * H, remat=remat)
    ts = apg.init(env, cfg, "cpu")
    profiling.counters()
    if not traced:
        apg.train_step(env, cfg, ts)
        return None, profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apg.train_step(env, cfg, ts)
    names = collections.Counter(e.name for e in prof.events())
    return names, profiling.counters()


@pytest.mark.parametrize("remat", [True, False])
def test_spans_and_recomputes_under_a_profiler(remat):
    names, counts = _iteration(remat, traced=True)
    steps = 2 * H if remat else H
    assert names["apg/step"] == steps
    assert names["apg/loss"] == 1
    assert names["vec/step"] == steps
    substeps = steps * 2  # policy_dt 0.004: 2 substeps a policy step
    for span in ENGINE:
        assert names[span] == substeps, span
    assert counts.get("apg/recomputes", 0) == (H if remat else 0)
    assert counts["apg/nonfinite_grad"] == 0


def test_no_profiler_no_spans_no_counts(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span opened with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _, counts = _iteration(remat=True, traced=False)
    assert counts == {}


def test_nonfinite_grad_counts_the_zeroed_entries():
    w = torch.nn.Parameter(torch.ones(5))
    w.grad = torch.tensor([1.0, float("nan"), 2.0, float("nan"), float("nan")])
    opt = optim.Adam(1e-3, 1.0, zero_nans=True)
    profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        opt.step({"w": w})
    assert profiling.counters()["apg/nonfinite_grad"] == 3
    assert torch.isfinite(w).all()
    w.grad = torch.tensor([float("nan")] * 5)
    opt.step({"w": w})  # no profiler: nothing counted
    assert profiling.counters() == {}

"""On the card: one cell end to end, briefly, and each cell's control (it
must come out not correct, the program correct): the eval cells at a
shorter episode and fewer envs, the training cells at their own size and
walk-ppo also at 256 envs."""

import json
import subprocess
import sys

import pytest

from benchmark import judge, run
from conftest import ROOT


@pytest.mark.gpu
def test_one_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "walk-eval",
                          "--seed", str(2 ** 31 + 123), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    manifest, _, _ = run.load_cell("walk-eval")
    assert set(result["metrics"]) == {m["name"] for m in run.cell_metrics(manifest, "walk-eval",
                                                                          trace=False)}
    assert result["device"]["platform"] == "gpu"


SMALL = {"walk-eval": {"num_envs": 512, "episode_steps": 60},
         "backflip-eval": {"num_envs": 512, "episode_steps": 60},
         "walk-ppo": {}, "backflip-ppo": {}}


def readings(name, change, seed=2 ** 31 + 5):
    """(the program's numbers, the control's) of one seed: set-up and one
    window unit."""
    _, cell, conf = run.load_cell(name)
    cell = {**cell, **change}
    prog = run.mode_of(cell).Program(cell, conf, "cuda")
    ref = prog.reference("cuda")
    prog.start(seed)
    prog.warm()
    prog.unit()
    return cell, prog.numbers(ref), prog.numbers(ref, control=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(card, name):
    cell, nums, control = readings(name, SMALL[name])
    assert judge.verdict(nums, cell["limits"]), judge.report(nums, cell["limits"])
    assert not judge.verdict(control, cell["limits"])


# walk-ppo at 256 envs (minibatches of 512): round-off in the learner grows
# over the set-up's iterations at this batch, in the reference in float32
# as in the program (PERF.md section 6), so the numbers compared here are
# those that do not carry it, with limits set from readings at this size.
LIMITS_256 = {"grad_gap": 0.0001, "start_gap": 0.0001,
              "reset_wrong": 0.0}


@pytest.mark.gpu
def test_training_at_256_envs(card):
    _, nums, control = readings("walk-ppo", {"num_envs": 256, "train_set": {"num_envs": 256}})
    assert judge.verdict(nums, LIMITS_256), judge.report(nums, LIMITS_256)
    assert not judge.verdict(control, LIMITS_256)

"""A run drives the program with its timed path broken underneath, and
``correct`` comes out false; sound, it comes out true. The look for a
card is skipped: the cells run on the CPU at a tiny size."""

import types

import pytest

from benchmark import faults, run
from conftest import tiny

CELLS = ("walk-ppo", "walk-eval")


def run_tiny(name, fault=None):
    manifest, cell, conf = run.load_cell(name)
    cell, conf = tiny(cell, conf)
    args = types.SimpleNamespace(workload=name, seed=2 ** 31 + 77, seconds=0.01, trace=0)
    undo = []
    out = run.run_cell(args, manifest, cell, conf, "cpu", lambda m: None,
                       break_program=(lambda p: undo.append(faults.plant(fault, p)))
                       if fault else None)
    for u in undo:
        u()
    return out


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_tiny(name)
    assert out["correct"] is True, out["checks"]


def applicable():
    for name in CELLS:
        _, cell, conf = run.load_cell(name)
        yield from ((name, f) for f in faults.FAULTS if faults.applies(f, cell, conf))


@pytest.mark.parametrize("name,fault", list(applicable()))
def test_fault_is_not_correct(name, fault):
    out = run_tiny(name, fault)
    assert out["correct"] is False, (fault, out["checks"])

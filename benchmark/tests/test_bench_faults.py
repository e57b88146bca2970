"""A run drives the program with its timed path broken underneath, and
``correct`` comes out false; sound, it comes out true. The look for a
card is skipped: every cell of the manifest whose mode has a ``tiny``
runs on the CPU at that size, with each fault its mode can have."""

import json
import os
import types

import pytest

from benchmark import faults, run
from conftest import ROOT

MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def cells():
    """(name, cell, configuration) of every manifest cell whose mode cuts
    it to a CPU size."""
    for w in MANIFEST["workloads"]:
        _, cell, conf = run.load_cell(w["name"])
        if hasattr(run.mode_of(cell), "tiny"):
            yield w["name"], cell, conf


CELLS = [name for name, _, _ in cells()]


def run_tiny(name, fault=None, trace=0):
    manifest, cell, conf = run.load_cell(name)
    cell, conf = run.mode_of(cell).tiny(cell, conf)
    args = types.SimpleNamespace(workload=name, seed=2 ** 31 + 77, seconds=0.01, trace=trace)
    undo = []
    out = run.run_cell(args, manifest, cell, conf, "cpu", lambda m: None,
                       break_program=(lambda p: undo.append(faults.plant(fault, p)))
                       if fault else None)
    for u in undo:
        u()
    return out


def pairs(missed):
    """The (cell, fault) pairs of every cell's applicable faults, those its
    mode names as not yet caught (``missed``) or the others."""
    for name, cell, conf in cells():
        mode = run.mode_of(cell)
        for f in mode.FAULTS:
            if faults.applies(f, cell, conf) and (f in getattr(mode, "MISSED", ())) == missed:
                yield name, f


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_tiny(name)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("name,fault", list(pairs(missed=False)))
def test_fault_is_not_correct(name, fault):
    out = run_tiny(name, fault)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("name,fault", list(pairs(missed=True)))
def test_missed_fault_still_reads_correct(name, fault):
    """A fault the mode names as not caught: when the judge learns to catch
    it, this fails, and the fault leaves the mode's ``MISSED``."""
    out = run_tiny(name, fault)
    assert out["correct"] is True, (fault, out["checks"])


def test_unknown_fault_names_the_modes_faults():
    _, cell, _ = run.load_cell("walk-eval")
    with pytest.raises(ValueError, match=r"'no_reset' is not a fault of mode 'eval'.*altered"):
        faults.plant("no_reset", types.SimpleNamespace(cell=cell))


def test_faults_name_the_union_of_train_and_eval():
    from benchmark.modes import eval as eval_mode, train

    assert set(faults.FAULTS) == set(train.FAULTS) | set(eval_mode.FAULTS)

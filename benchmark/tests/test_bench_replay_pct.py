"""``env_step_replay_pct`` on fake counter tallies: 100 x replays over
steps, and None where the program tallies no ``vec/steps``."""

import types

import pytest

from benchmark import run


def ctx(counts):
    return types.SimpleNamespace(log=lambda m: None, program_counters=counts)


@pytest.mark.parametrize("counts,want", [
    ({"vec/steps": 40, "vec/graph_replays": 40}, 100.0),
    ({"vec/steps": 16, "vec/graph_replays": 12, "vec/graph_captures": 1}, 75.0),
    ({"vec/steps": 8, "vec/quarantined": 0}, 0.0),
])
def test_replays_over_steps(counts, want):
    assert run.reader("env_step_replay_pct")(ctx(counts)) == pytest.approx(want)


@pytest.mark.parametrize("counts", [None, {}, {"vec/resets": 3, "vec/fresh_states": 12},
                                    {"vec/steps": 0}])
def test_none_without_steps(counts):
    assert run.reader("env_step_replay_pct")(ctx(counts)) is None

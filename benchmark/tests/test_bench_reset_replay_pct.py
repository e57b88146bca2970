"""``auto_reset_replay_pct`` on fake counter tallies: 100 x replays over
``auto_reset`` calls, and None where the program tallies no
``vec/auto_resets``."""

import types

import pytest

from benchmark import run


def ctx(counts):
    return types.SimpleNamespace(log=lambda m: None, program_counters=counts)


@pytest.mark.parametrize("counts,want", [
    ({"vec/auto_resets": 16, "vec/reset_replays": 16}, 100.0),
    ({"vec/auto_resets": 16, "vec/reset_replays": 15, "vec/reset_captures": 1}, 93.75),
    ({"vec/auto_resets": 8, "vec/resets": 3, "vec/fresh_states": 16384}, 0.0),
])
def test_replays_over_calls(counts, want):
    assert run.reader("auto_reset_replay_pct")(ctx(counts)) == pytest.approx(want)


@pytest.mark.parametrize("counts", [None, {}, {"vec/resets": 3, "vec/fresh_states": 12},
                                    {"vec/steps": 40, "vec/graph_replays": 40},
                                    {"vec/auto_resets": 0}])
def test_none_without_auto_resets(counts):
    assert run.reader("auto_reset_replay_pct")(ctx(counts)) is None

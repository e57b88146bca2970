"""Env steps that replayed a captured CUDA graph in the traced unit: 100
times the program's counter ``vec/graph_replays`` over ``vec/steps`` (every
``MimicVecEnv.step`` call); None where the program counts no steps."""

from benchmark import spans


def read(ctx):
    counts = spans.program_counters(ctx)
    if not counts or not counts.get("vec/steps"):
        return None
    return 100.0 * counts.get("vec/graph_replays", 0) / counts["vec/steps"]

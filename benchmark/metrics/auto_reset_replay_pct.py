"""Env resets that replayed a captured CUDA graph in the traced unit: 100
times the program's counter ``vec/reset_replays`` over ``vec/auto_resets``
(every ``MimicVecEnv.auto_reset`` call); None where the program counts no
``auto_reset`` calls."""

from benchmark import spans


def read(ctx):
    counts = spans.program_counters(ctx)
    if not counts or not counts.get("vec/auto_resets"):
        return None
    return 100.0 * counts.get("vec/reset_replays", 0) / counts["vec/auto_resets"]

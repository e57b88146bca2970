"""Fresh states used over fresh states drawn in the traced unit: 100 times
the program's counter ``vec/resets`` (envs ``auto_reset`` restarts) over
``vec/fresh_states`` (states it draws, the whole batch each call)."""

from benchmark import spans


def read(ctx):
    counts = spans.program_counters(ctx)
    if not counts or not counts.get("vec/fresh_states"):
        return None
    return 100.0 * counts.get("vec/resets", 0) / counts["vec/fresh_states"]

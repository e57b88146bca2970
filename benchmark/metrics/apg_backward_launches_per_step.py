"""Launch calls inside the traced ``apg/backward`` span and outside its
``apg/step`` spans (the recomputes), per window step recomputed (the
program's counter ``apg/recomputes``): a step's backward."""

from benchmark import apg_spans, spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    backward = apg_spans.intervals(ctx.trace, "apg/backward")
    counts = spans.program_counters(ctx)
    recomputes = (counts or {}).get("apg/recomputes")
    if not backward or not recomputes:
        return None
    inside = apg_spans.launches_in(ctx.trace, backward)
    steps = apg_spans.launches_in(ctx.trace, apg_spans.intervals(ctx.trace, "apg/step"))
    ctx.log(f"apg_backward_launches_per_step: {inside} launches in apg/backward, {steps} of them "
            f"in apg/step spans, {recomputes} recomputes")
    return (inside - steps) / recomputes

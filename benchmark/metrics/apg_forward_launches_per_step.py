"""Launch calls (kernel and graph launches, async copies and memsets)
that start inside the traced ``apg/step`` spans, per span: a window
step's policy forward and env step, as the checkpoint recomputes it in
the backward (the traced range starts after the last forward step)."""

from benchmark import apg_spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    steps = apg_spans.intervals(ctx.trace, "apg/step")
    if not steps:
        return None
    ctx.log(f"apg_forward_launches_per_step: {len(steps)} apg/step spans; the trace holds "
            f"{apg_spans.launches_in(ctx.trace, [(0, 2 ** 63)])} launch calls and "
            f"{len(ctx.trace.device)} device operations over {ctx.trace.window_ns() / 1e9:.3f} s")
    return apg_spans.launches_in(ctx.trace, steps) / len(steps)

"""CPU-side CUDA runtime calls that enqueue device work (kernel and graph
launches, async copies and memsets) inside the traced policy steps' host
spans, per step."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches_per_step()

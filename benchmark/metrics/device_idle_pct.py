"""100 minus the union of device operations' intervals over the traced
window's span, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.trace.idle_pct()

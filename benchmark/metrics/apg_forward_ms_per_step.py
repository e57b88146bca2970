"""The program's synchronised host seconds of ``apg/forward`` (its
``timing``: the window's forward, ended by a synchronize) over the
horizon, in ms, averaged over the traced run's iterations outside the
traced one."""


def read(ctx):
    spans = ctx.spans.get("forward_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * ctx.policy_steps_per_unit)

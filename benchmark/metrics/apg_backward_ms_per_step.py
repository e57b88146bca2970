"""The program's synchronised host seconds of ``apg/backward`` (its
``timing``: the backward with each step's recompute, ended by a
synchronize) over the horizon, in ms, averaged over the traced run's
iterations outside the traced one."""


def read(ctx):
    spans = ctx.spans.get("backward_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * ctx.policy_steps_per_unit)

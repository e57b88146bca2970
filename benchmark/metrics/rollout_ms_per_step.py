"""Host clock around each ``ppo.rollout`` call of the window (ended by a
synchronize), summed and divided by the rollout's policy steps."""


def read(ctx):
    spans = ctx.spans.get("rollout_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * ctx.policy_steps_per_unit)

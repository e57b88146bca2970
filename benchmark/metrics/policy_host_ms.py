"""Mean host duration of the program's ``ppo/policy`` spans in the traced
unit: each step's observation normalisation, policy forward, draw,
log-prob and value (rollout), or normalisation and forward (eval)."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx.trace, "ppo/policy")

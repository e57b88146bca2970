"""Envs x policy steps of the traced run's units outside the traced one
over their host-clock seconds: the window's throughput in a cell whose
end-to-end rate spreads too widely from run to run to hold a bound."""


def read(ctx):
    if not ctx.untraced_units or ctx.untraced_s <= 0:
        return None
    return ctx.untraced_units * ctx.policy_steps_per_unit * ctx.num_envs / ctx.untraced_s

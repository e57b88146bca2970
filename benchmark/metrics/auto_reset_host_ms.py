"""Mean host duration of the program's ``vec/auto_reset`` spans in the
traced unit: the fresh draw for the whole batch, the curriculum and the
selection of the done envs."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx.trace, "vec/auto_reset")

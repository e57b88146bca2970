"""Mean host duration of the program's ``vec/step`` spans in the traced
unit: ``MimicVecEnv.step``'s targets, kernel launch, obs, reward and
termination."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx.trace, "vec/step")

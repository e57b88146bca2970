"""Mean host duration of the program's ``ppo/minibatch`` spans in the
traced iteration: a minibatch's gather, loss, backward and optimiser
step."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx.trace, "ppo/minibatch")

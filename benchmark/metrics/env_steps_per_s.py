"""Envs x policy steps of the window's whole units over its wall time (host
clock, ended by a synchronize)."""


def read(ctx):
    return ctx.env_steps / ctx.seconds

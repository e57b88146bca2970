"""The APG cell's window rate: envs x window steps of the traced run's
iterations outside the traced one over their host-clock seconds."""

from benchmark.run import reader

read = reader("untraced_env_steps_per_s")

"""The operations an APG iteration needs (``modes/apg.py``), by precision
class, beside :mod:`benchmark.flops`.

Per env step of the window: the policy MLP's forward and its backward
(twice the forward: the gradients of its inputs and of its weights), and
the physics' needed FLOP (the frozen counter over sampled states,
:func:`benchmark.flops.kernel_flop_per_env`) forward plus twice that for
its backward. Once a window per env: the frozen critic's forward and the
gradient of its input (twice its forward). The checkpoint's recompute of
each step is not counted: a model FLOP is one the window needs, not one
the program spends again.
"""

from __future__ import annotations


def iteration_flops(flops, mlp, num_envs: int, horizon: int, physics_per_env: float) -> dict:
    """{"matmul": FLOP of the MLPs, "vector": FLOP of the physics} of one
    iteration; ``mlp`` holds the (policy, value) widths."""
    policy, value = (flops.mlp_forward(w) for w in mlp)
    steps = num_envs * horizon
    return {"matmul": 3 * steps * policy + 2 * num_envs * value,
            "vector": 3 * steps * physics_per_env}

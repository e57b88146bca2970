"""95th percentile of every policy step of the window: the device-timeline
interval between the CUDA events recorded after consecutive ``env.step``
calls of one rollout or episode."""

import statistics


def read(ctx):
    if len(ctx.intervals_ms) < 2:
        return None
    ctx.log(f"step_ms_p95: {len(ctx.intervals_ms)} step intervals, "
            f"median {statistics.median(ctx.intervals_ms):.4f} ms")
    return statistics.quantiles(ctx.intervals_ms, n=20, method="inclusive")[18]

"""The policy-step kernel's least time over its device time in the trace:
the larger of the needed FLOP (the frozen counter over sampled launch
inputs) at 67 TFLOP/s f32 and the bytes (each read or written once) at
3.35 TB/s, over the mean duration of ``mimic_step_kernel`` launches."""

KERNEL = "mimic_step_kernel"


def read(ctx):
    if ctx.trace is None or ctx.kernel is None:
        return None
    times = ctx.trace.kernel_ns(KERNEL)
    if not times:
        return None
    k = ctx.kernel
    least, bound = ctx.flops.kernel_least_s(k["spec"], k["flop_per_env"], k["batch"])
    mean_s = sum(times) / len(times) / 1e9
    ctx.log(f"kernel_roofline_pct: {len(times)} launches, mean {mean_s * 1e3:.6f} ms, "
            f"least {least * 1e3:.6f} ms, bound by {bound}; "
            f"{k['flop_per_env']:.1f} FLOP per env; card {ctx.card.get('power_limit')}")
    return 100.0 * least / mean_s

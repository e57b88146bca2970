"""The whole step's model FLOP over the card's peak in each precision,
summed, over the window's seconds outside the traced unit (whose
profiler stops inside the window): the MLPs from their widths (forward in
rollout and eval, forward and backward in learn) at the precision the run
set for float32 matmuls, and the kernel's needed FLOP at the f32 peak."""


def read(ctx):
    if ctx.kernel is None:
        return None
    prec = ctx.flops.matmul_precision()
    need = ctx.program.model_flops(ctx.flops, ctx.untraced_units)
    ctx.log(f"step_mfu_pct: {need['matmul']:.6g} matmul FLOP at the {prec} peak, "
            f"{need['vector']:.6g} kernel FLOP at the fp32 peak, over {ctx.untraced_s:.4f} s "
            f"of {ctx.untraced_units} units; card {ctx.card.get('power_limit')}")
    return ctx.flops.step_mfu_pct(need, ctx.untraced_s, prec)

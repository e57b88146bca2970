"""The APG iteration's model FLOP over the card's peak in each precision,
summed, over the window's seconds outside the traced iteration: the
policy MLP's forward and backward per env step and the critic's tail once
a window at the run's matmul precision, the physics' needed FLOP forward
and twice that backward at the f32 peak (``benchmark/apg_flops.py``; the
recompute not counted). No kernel of the port runs: no roofline."""


def read(ctx):
    prog = ctx.program
    if not ctx.untraced_units or getattr(prog, "ref", None) is None:
        return None
    prec = ctx.flops.matmul_precision()
    need = prog.model_flops(ctx.flops, ctx.untraced_units)
    ctx.log(f"apg_step_mfu_pct: {need['matmul']:.6g} matmul FLOP at the {prec} peak, "
            f"{need['vector']:.6g} physics FLOP at the fp32 peak, over {ctx.untraced_s:.4f} s "
            f"of {ctx.untraced_units} iterations; card {ctx.card.get('power_limit')}")
    return ctx.flops.step_mfu_pct(need, ctx.untraced_s, prec)

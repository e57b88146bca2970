"""Of the device's idle time inside the traced policy steps (marker to
marker), the share during which the host was in none of the program's
``ppo/policy``, ``vec/step`` or ``vec/auto_reset`` spans: the loop's glue
and the benchmark's own recording. Logs the device's idle seconds over
the traced window by the innermost program span the host was in, the
launch calls by that span, and the program's counters."""

from benchmark import spans


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    spans.program_counters(ctx)
    by = spans.idle_by_span(tr)
    if by is None:
        return None
    named = sum(1 for n, _, _ in tr.device if spans.is_span(n))
    ctx.log(f"idle_outside_spans_pct: device events named as a span: {named}; idle s by "
            "innermost span: " + ", ".join(f"{k or 'none'} {v / 1e9:.9f}" for k, v in
                                          sorted(by.items(), key=lambda kv: -kv[1])))
    launches = spans.launches_by_span(tr)
    ctx.log(f"launches by innermost span over {len(spans.span_ns(tr, 'vec/step'))} env steps: "
            + ", ".join(f"{k or 'none'} {v}" for k, v in
                        sorted(launches.items(), key=lambda kv: -kv[1])))
    return spans.idle_outside_pct(tr)

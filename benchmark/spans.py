"""Readings of the program's own spans and counters in a traced window.

The program opens its spans (``pbrl_tpu_torch.utils.profiling.
trace_annotation``, named ``layer/what``: ``ppo/policy``, ``vec/step``)
only while a profiler records; they land among the trace's host events,
on the clock of its device events. A host event is a program span when
its name holds a ``/`` and neither ``:`` nor a space (aten ops, runtime
calls and the benchmark's ``bench::`` markers hold none or a ``:``).
Spans of one thread nest, so at each instant the host is in at most one
innermost program span. Every function returns None where the trace holds
none of the spans it reads (a program without spans); the counters are
None where the program offers none.
"""

from __future__ import annotations

import bisect

from benchmark.trace import LAUNCH_CALLS, merged

# The spans a policy step spends its host time in; the rest of a step is
# the loop's glue and the benchmark's own recording.
STEP_SPANS = ("ppo/policy", "vec/step", "vec/auto_reset")


def is_span(name: str) -> bool:
    return "/" in name and ":" not in name and " " not in name


def span_ns(trace, name: str):
    """Host durations (ns) of the spans named ``name``."""
    return [b - a for n, a, b in trace.host if n == name]


def mean_ms(trace, name: str):
    """Mean host duration (ms) of the spans named ``name``; None if none."""
    if trace is None:
        return None
    d = span_ns(trace, name)
    return sum(d) / len(d) / 1e6 if d else None


def _total(intervals):
    return sum(b - a for a, b in intervals)


def _intersect(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_intervals(trace):
    """The device's idle intervals over the window (all events' span)."""
    ev = trace.device + trace.host
    lo, hi = min(a for _, a, _ in ev), max(b for _, _, b in ev)
    out, t = [], lo
    for a, b in merged([(a, b) for _, a, b in trace.device]):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(trace):
    """Disjoint (start, end, name) pieces of the window in which the host
    was in a program span, each named by the innermost one."""
    spans = sorted((a, b, n) for n, a, b in trace.host if is_span(n) and b > a)
    pts = sorted({p for a, b, _ in spans for p in (a, b)})
    out = []
    for a, b in zip(pts, pts[1:]):
        inside = [(s, -e, n) for s, e, n in spans if s <= a and e >= b]
        if inside:
            out.append((a, b, max(inside)[2]))
    return out


def idle_by_span(trace):
    """The device's idle ns over the window by the innermost program span
    the host was in (None: in none); None where the trace has no span."""
    pieces = innermost(trace)
    if not pieces:
        return None
    idle = idle_intervals(trace)
    out, j = {}, 0
    for a, b, name in pieces:  # both sorted and disjoint: one pass
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            out[name] = out.get(name, 0) + min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    out[None] = _total(idle) - sum(out.values())
    return out


def launches_by_span(trace):
    """Launch calls over the window by the innermost program span the host
    was in when each started (None: in none); None where the trace has no
    span."""
    pieces = innermost(trace)
    if not pieces:
        return None
    starts = sorted(a for n, a, _ in trace.host if n in LAUNCH_CALLS)
    out = {}
    for a, b, name in pieces:
        n = bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
        if n:
            out[name] = out.get(name, 0) + n
    out[None] = len(starts) - sum(out.values())
    return out


def idle_outside_pct(trace, names=STEP_SPANS):
    """Of the device's idle time inside the traced policy steps, the share
    (%) in which the host was in none of the spans ``names``; None where
    the trace has no step or none of those spans."""
    steps = trace.step_spans()
    within = merged([(a, b) for n, a, b in trace.host if n in names])
    if not steps or not within:
        return None
    idle = _intersect(idle_intervals(trace), merged(steps))
    total = _total(idle)
    if total <= 0:
        return None
    return 100.0 * (total - _total(_intersect(idle, [tuple(x) for x in within]))) / total


def program_counters(ctx):
    """The program's counters over the traced unit (read once a run, and
    logged); None where the program offers none."""
    if not hasattr(ctx, "program_counters"):
        try:
            from pbrl_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        read = getattr(profiling, "counters", None)
        ctx.program_counters = read() if read is not None else None
        for k, v in sorted((ctx.program_counters or {}).items()):
            ctx.log(f"counter {k}: {v}")
    return ctx.program_counters

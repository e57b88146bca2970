"""Launch counts of the APG cell's traced range by the program's spans
(``apg/step``, ``apg/backward``), whichever thread opened them: the
backward and its recomputes run on the autograd engine's thread while
the thread that called ``backward`` sits in ``apg/backward``."""

from __future__ import annotations

import bisect

from benchmark.trace import LAUNCH_CALLS, merged


def intervals(trace, name: str):
    """The (start, end) of the spans named ``name``."""
    return [(a, b) for n, a, b in trace.host if n == name and b > a]


def launches_in(trace, spans) -> int:
    """Launch calls that start inside the union of ``spans``."""
    starts = sorted(a for n, a, _ in trace.host if n in LAUNCH_CALLS)
    return sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
               for a, b in merged(spans))

"""The traced window's arithmetic, from ``torch.profiler``'s raw events.

Device busy time is the union of the device operations' intervals
(``chip_smoke.py::profile_eval``'s arithmetic); the window is the span of
all traced events. Host launches are the CPU-side CUDA runtime calls that
enqueue device work; a policy step's span runs from one ``bench::step``
marker to the next within one unit (the proxy emits a marker after each
step, and one at each unit's start).
"""

from __future__ import annotations

import bisect

from torch.autograd import DeviceType

LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaMemcpy2DAsync", "cuMemcpyAsync", "cuMemsetD8Async", "cuMemsetD32Async"))
STEP_MARK, UNIT_MARK = "bench::step", "bench::unit"


def merged(spans):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one traced window, as plain tuples (ns)."""

    def __init__(self, device=(), host=()):
        self.device = list(device)   # (name, start, end)
        self.host = list(host)       # (name, start, end)

    @classmethod
    def from_profiler(cls, prof):
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns()
            b = a + max(e.duration_ns(), 0)
            (dev if e.device_type() == DeviceType.CUDA else host).append((e.name(), a, b))
        return cls(dev, host)

    def window_ns(self):
        ev = self.device + self.host
        return max(b for _, _, b in ev) - min(a for _, a, _ in ev)

    def busy_ns(self):
        return sum(b - a for a, b in merged([(a, b) for _, a, b in self.device]))

    def idle_pct(self):
        return 100.0 * (1.0 - self.busy_ns() / self.window_ns())

    def top_device_ops(self, n=10):
        per = {}
        for name, a, b in self.device:
            per[name] = per.get(name, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def kernel_ns(self, substring):
        """Durations of the device operations whose name holds ``substring``."""
        return [b - a for name, a, b in self.device if substring in name]

    def step_spans(self):
        """(start, end) of each policy step on the host: marker to marker
        within one unit."""
        marks = sorted((a, name) for name, a, _ in self.host if name in (STEP_MARK, UNIT_MARK))
        spans = []
        for (a, _), (b, name_b) in zip(marks, marks[1:]):
            if name_b == STEP_MARK:
                spans.append((a, b))
        return spans

    def launches_per_step(self):
        spans = self.step_spans()
        if not spans:
            return None
        starts = sorted(a for name, a, _ in self.host if name in LAUNCH_CALLS)
        n = sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a) for a, b in spans)
        return n / len(spans)

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between device operations inside the
        window, each named by the innermost host event running at its
        middle."""
        busy = merged([(a, b) for _, a, b in self.device])
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            inner = [(e - s, name) for name, s, e in self.host
                     if s <= mid <= e and name not in (STEP_MARK, UNIT_MARK)]
            out.append([min(inner)[1] if inner else "host between ops", (b - a) / 1e9])
        return out

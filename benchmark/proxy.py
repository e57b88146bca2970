"""The env the benchmark hands to the program's entry: it forwards every
attribute to the program's env and observes each ``step`` call.

After each step it records a CUDA event on the current stream (the
device-timeline end of that policy step; read only after the window), and,
when asked, the step's inputs and outputs: a fixed sample of rows at every
step (``rows``) into a buffer made at set-up, so that recording allocates
nothing in the window, or every row (``full``, references to the states).
Nothing here synchronises.
"""

from __future__ import annotations

import torch

from benchmark.trace import STEP_MARK, UNIT_MARK

# The recorded columns of a sampled step, in order.
INPUT_FIELDS = ("qpos", "qvel", "time", "episode_start", "obs")
OUTPUT_FIELDS = ("qpos", "qvel", "obs", "reward", "done")


class StepProxy:
    def __init__(self, env, timing: bool = False):
        self._env = env
        self.timing = timing
        self.rows = None      # a LongTensor of rows to record at every step
        self.buffer = None    # (steps, rows, columns) of the sampled records
        self.full = False     # record every row (references, no copies)
        self.on_step = None   # called after each step with the step's index in its unit
        self.mark = False     # emit profiler markers at each step and unit
        self.segments = []    # per unit: list of CUDA events, one per step
        self.records = []     # per unit: list of per-step records
        self._pool = []
        self._used = 0
        self._filled = 0
        self._n = 0

    def __getattr__(self, name):
        return getattr(self._env, name)

    def begin_unit(self):
        """A new rollout or episode: step intervals never span two units."""
        self.segments.append([])
        self.records.append([])
        self._n = 0
        if self.mark:
            with torch.profiler.record_function(UNIT_MARK):
                pass

    def _event(self):
        if self._used >= len(self._pool):
            self._pool.extend(torch.cuda.Event(enable_timing=True) for _ in range(1024))
        self._used += 1
        return self._pool[self._used - 1]

    def reserve(self, n: int, rows=None):
        """Create the events of ``n`` steps now (set-up), not in the window,
        and with ``rows`` the buffer of their sampled records."""
        while self.timing and len(self._pool) < n:
            self._pool.extend(torch.cuda.Event(enable_timing=True) for _ in range(1024))
        if rows is not None:
            self.rows = rows
            width = sum(w for _, _, w in self.widths())
            self.buffer = torch.empty((n, rows.shape[0], width), device=rows.device)
            self._filled = 0

    def step(self, state, action):
        nstate = self._env.step(state, action)
        if not self.segments:
            self.begin_unit()
        if self.timing:
            ev = self._event()
            ev.record()
            self.segments[-1].append(ev)
        if self.full:
            self.records[-1].append({"in": state, "action": action, "out": nstate})
        elif self.buffer is not None and self._filled < self.buffer.shape[0]:
            cols = [getattr(state, f).reshape(state.qpos.shape[0], -1) for f in INPUT_FIELDS]
            cols.append(action)
            cols += [getattr(nstate, f).reshape(state.qpos.shape[0], -1) for f in OUTPUT_FIELDS]
            self.buffer[self._filled].copy_(torch.cat(cols, 1).index_select(0, self.rows))
            self.records[-1].append(self._filled)
            self._filled += 1
        self._n += 1
        if self.mark:
            with torch.profiler.record_function(STEP_MARK):
                pass
        if self.on_step is not None:
            self.on_step(self._n)
        return nstate

    def widths(self):
        """Column widths of a sampled record, by (side, field)."""
        e = self._env
        nq, nv, no, nu = e.model.nq, e.model.nv, e.observation_size, e.action_size
        w = {"qpos": nq, "qvel": nv, "time": 1, "episode_start": 1, "obs": no,
             "reward": 1, "done": 1}
        return ([("in", f, w[f]) for f in INPUT_FIELDS] + [("in", "action", nu)]
                + [("out", f, w[f]) for f in OUTPUT_FIELDS])

    def step_intervals_ms(self):
        """Device-timeline ms between consecutive steps of one unit."""
        out = []
        for seg in self.segments:
            out += [a.elapsed_time(b) for a, b in zip(seg, seg[1:])]
        return out

    def sampled(self):
        """Per unit, the (steps, rows, columns) sampled records."""
        return [self.buffer[idx[0]:idx[-1] + 1] for idx in self.records if idx]

    def clear(self):
        self.segments, self.records, self._used, self._filled = [], [], 0, 0

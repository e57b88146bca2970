"""Profiling: spans and counters inside the program, ``torch.profiler``
traces, and host-clock scopes (counterpart of
``pbrl_tpu/utils/profiling.py``).

Spans and counters are on exactly while a ``torch.profiler`` records in
the process, and cost one flag check otherwise: no switch of their own.

- :func:`trace_annotation` is the program's span, named ``layer/what``
  (``ppo/policy``, ``vec/step``). Off, it is a shared no-op context. On,
  it opens an op-scope range (not a user annotation): it lands among the
  profiler's host events, on the clock of its device events, and puts
  nothing on the device timeline, so a gap in the device's work can be put
  down to the span the host was in.
- :func:`count` tallies a counter: a host int, or a tensor the program
  already made (a mask, summed when read; ``where`` masks it further), kept
  by reference so that counting launches nothing. :func:`counters` reduces
  the tally in one go (one wait for the card) and clears it.
- :func:`profile_to` writes a Chrome trace (chrome://tracing, Perfetto) of
  the enclosed block; :func:`profile_scope` times a phase on the host
  clock, after the card has finished when ``sync``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Union

import torch

_recording = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
_tally: Dict[str, List] = {}


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def trace_annotation(name: str):
    """The span ``name``: an op-scope range while a profiler records, a
    shared no-op context otherwise."""
    if not _recording():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def count(name: str, value: Union[int, torch.Tensor],
          where: Optional[torch.Tensor] = None) -> None:
    """Add ``value`` (an int, or a tensor summed when read; with ``where``,
    only its entries where ``where`` is nonzero) to the counter ``name``,
    while a profiler records."""
    if _recording():
        _tally.setdefault(name, []).append(value if where is None else (value, where))


def counters() -> Dict[str, int]:
    """The counters tallied since the last call, as ``{name: int}``; clears
    the tally."""
    tally = dict(_tally)
    _tally.clear()
    out = {name: 0 for name in tally}
    sums: Dict[torch.device, List] = {}
    for name, values in tally.items():
        for v in values:
            if isinstance(v, tuple):
                v = torch.logical_and(v[0], v[1])
            if isinstance(v, torch.Tensor):
                sums.setdefault(v.device, []).append((name, torch.count_nonzero(v)))
            else:
                out[name] += int(v)
    for items in sums.values():
        for (name, _), n in zip(items, torch.stack([n for _, n in items]).tolist()):
            out[name] += n
    return out


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block (the host's operations, and the card's when
    there is one) into ``log_dir/trace_<ms since the epoch>.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))


@contextlib.contextmanager
def profile_scope(name: str, *, sync: bool = False) -> Iterator[dict]:
    """Host-clock scope, also a :func:`trace_annotation` span; fills the
    yielded dict with ``seconds``. ``sync=True`` waits for the card before
    and after, so the time is the block's work and only it."""
    if sync:
        _synchronize()
    out: dict = {}
    t0 = time.perf_counter()
    try:
        with trace_annotation(name):
            yield out
        if sync:
            _synchronize()
    finally:
        out["seconds"] = time.perf_counter() - t0

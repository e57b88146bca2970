"""Profiling: ``torch.profiler`` traces and named scopes around the hot
phases (counterpart of ``pbrl_tpu/utils/profiling.py``).

A :func:`trace_annotation` range shows in a ``torch.profiler`` trace (and
as an NVTX range when a card is present); :func:`profile_to` writes a
Chrome trace (chrome://tracing, Perfetto); :func:`profile_scope` times a
phase on the host clock, after the card has finished when ``sync``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Named range in ``torch.profiler`` traces, and in NVTX on a card."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
    """Host-clock scope, also a :func:`trace_annotation` range; fills the
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

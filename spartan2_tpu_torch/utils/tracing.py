"""Per-phase timing spans (reference: tracing + start_span!, lib.rs:52-60).

A span costs nothing unless a caller collects spans with ``record()``;
then every span synchronizes the current CUDA device at entry and exit,
so queued kernels are charged to the span that launched them, and
appends (depth, name, milliseconds) to the collected list.
"""

from __future__ import annotations

import contextlib
import time

import torch

_sink: list | None = None
_depth = 0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def record():
    """Collect the spans that run inside the block into the yielded list."""
    global _sink
    prev, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = prev


@contextlib.contextmanager
def span(name: str):
    global _depth
    if _sink is None:
        yield
        return
    sink = _sink
    _sync()
    t0 = time.perf_counter()
    _depth += 1
    try:
        yield
    finally:
        _sync()
        _depth -= 1
        sink.append((_depth, name, (time.perf_counter() - t0) * 1e3))

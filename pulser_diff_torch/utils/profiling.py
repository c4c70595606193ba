"""Profiling helpers (counterpart of pulser_diff_tpu/utils/profiling.py).

``timed`` is a wall clock around a block that waits for the GPU's queued
work before it stops; ``profile_trace`` names a region in a
``torch.profiler`` trace, and on the GPU in an NVTX range as well.  The
JAX package's ``start_server`` (a profiler server for on-demand capture)
has no counterpart in torch.profiler.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


def _on_gpu() -> bool:
    """Whether this process has work on the GPU (CUDA initialised)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock a block, ending on ``torch.cuda.synchronize()`` when the
    process has work on the GPU: the seconds go to ``results[label]``, or
    are printed in ms."""
    t0 = time.perf_counter()
    yield
    if _on_gpu():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[timed] {label}: {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def profile_trace(label: str) -> Iterator[None]:
    """A named region: a ``torch.profiler.record_function`` event, and on
    the GPU an NVTX range (no cost outside a profiler or NVTX tool)."""
    nvtx = _on_gpu()
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()

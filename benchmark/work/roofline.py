"""A kernel's share of its roofline, from the trace and the problem's work."""

from __future__ import annotations

from typing import Callable, Optional

from benchmark.work import counts


def share(run, kernel: str, work: Callable) -> Optional[float]:
    """100 x the least time of ``work(run.size, run.runs)`` over the mean
    device time of a launch of ``kernel`` (matched by its whole name);
    None where the traced window holds no such launch."""
    if run.trace is None:
        return None
    secs = run.trace.kernel_seconds(kernel)
    if not secs:
        return None
    least = counts.least_seconds(*work(run.size, run.runs))
    return 100.0 * least / (sum(secs) / len(secs))

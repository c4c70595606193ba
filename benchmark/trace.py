"""The reduction of a ``torch.profiler`` trace to what the readers need.

Device operations are the trace's kernels, copies and sets on the device
(its activity types ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the
device-side shadows of host labels are left out).  The traced window is
the host label ``window`` that the harness puts around the traced
epochs.  Busy time is the union of the device operations' intervals
inside the window, never their sum; an idle gap is a stretch of the
window that no device operation covers, and it is named by what the host
was doing at its middle: the loop's part (forward, backward, ...) and
the innermost host operation then running.  The parts' labels are the
session's (its ``PARTS``).
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import NamedTuple, Optional

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _kind(e, labels=frozenset({"window"})) -> str:
    """An event's activity type; where the trace's events do not say
    (torch before 2.12), a device event that bears a label's name is that
    label's device-side shadow and any other is a device operation."""
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        return activity()
    if e.device_type() == _cuda():
        return "gpu_user_annotation" if e.name() in labels else "kernel"
    user = getattr(e, "is_user_annotation", None)
    return "user_annotation" if (user() if user else e.name() in labels) else "cpu_op"


def _cuda():
    import torch

    return torch.autograd.DeviceType.CUDA


class Op(NamedTuple):
    name: str
    start: int  # ns
    end: int  # ns


def kernel_id(name: str) -> str:
    """A kernel's bare name from the demangled signature the trace gives:
    ``void ns::fused_fwd_kernel<false>(float const*, ...)`` ->
    ``fused_fwd_kernel``.  A copy or set keeps its name."""
    s = name[5:] if name.startswith("void ") else name
    # a signature's template or argument list follows the name directly
    cut = next((i for i, c in enumerate(s) if c in "<(" and i and s[i - 1] != " "), len(s))
    return s[:cut].rsplit("::", 1)[-1].strip()


class Trace:
    """The device operations and host labels of one traced window."""

    def __init__(self, device_ops: list, host_ops: list, labels: list, window: Op,
                 epochs: int) -> None:
        self.window = window
        self.epochs = epochs
        self.device_ops = sorted((o for o in device_ops
                                  if o.end > window.start and o.start < window.end),
                                 key=lambda o: o.start)
        self.host_ops = host_ops
        self.labels = labels

    @classmethod
    def from_profiler(cls, prof, epochs: int, parts) -> "Trace":
        """The trace of a window labelled ``window`` whose epochs label
        their ``parts``."""
        names = frozenset(parts) | {"window"}
        dev, host, labels, window = [], [], [], None
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e, names)
            start = int(e.start_ns()) if hasattr(e, "start_ns") else int(e.start_us()) * 1000
            op = Op(e.name(), start, start + int(e.duration_ns()))
            if kind in DEVICE_KINDS:
                dev.append(op)
            elif kind == "user_annotation":
                if op.name == "window":
                    window = op
                elif op.name in names:
                    labels.append(op)
            elif kind in HOST_KINDS:
                host.append(op)
        if window is None:
            raise RuntimeError("the trace holds no window label")
        return cls(dev, host, labels, window, epochs)

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window."""
        out: list = []
        for o in self.device_ops:
            s, e = max(o.start, self.window.start), min(o.end, self.window.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, name: str) -> list:
        """Each launch's device seconds of the kernel named ``name``."""
        return [(o.end - o.start) / 1e9 for o in self.device_ops if kernel_id(o.name) == name]

    def top_device_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        total: dict = defaultdict(int)
        for o in self.device_ops:
            total[kernel_id(o.name)] += o.end - o.start
        return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[what the host was doing, seconds]]: the idle time of the
        window by the host's part and innermost operation at each gap's
        middle, the largest first."""
        gaps, last = [], self.window.start
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.window.end > last:
            gaps.append((last, self.window.end))
        total: dict = defaultdict(int)
        for (s, e), name in zip(gaps, self._host_at([(s + e) // 2 for s, e in gaps])):
            total[name] += e - s
        return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def _host_at(self, times: list) -> list:
        """For each time (ascending), 'part: innermost host op'."""
        out = []
        part = _Sweep(self.labels)
        op = _Sweep(self.host_ops)
        for t in times:
            p, o = part.innermost(t), op.innermost(t)
            out.append(f"{p.name if p else 'between epochs'}: {o.name if o else 'no host op'}")
        return out


class _Sweep:
    """Innermost (shortest) interval covering each of ascending times."""

    def __init__(self, ops: list) -> None:
        self.ops = sorted(ops, key=lambda o: o.start)
        self.i = 0
        self.active: list = []  # heap by end

    def innermost(self, t: int) -> Optional[Op]:
        while self.i < len(self.ops) and self.ops[self.i].start <= t:
            o = self.ops[self.i]
            heapq.heappush(self.active, (o.end, self.i, o))
            self.i += 1
        while self.active and self.active[0][0] < t:
            heapq.heappop(self.active)
        if not self.active:
            return None
        return min((a[2] for a in self.active), key=lambda o: o.end - o.start)

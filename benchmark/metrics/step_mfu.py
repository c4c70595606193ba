"""The whole epoch's share of the chip's f32 peak: the operations of the
forward evolution and its adjoint, counted from the problem
(work/counts.py), over the mean epoch time of the traced run's epochs
before the profiler started (the device's clock), at the f32 rate
outside the tensor cores.  It bounds what the kernels' roofline shares
can give the step, whichever kernels carry it."""

from benchmark.work import counts
from benchmark.work.peaks import F32_FLOPS


def read(run):
    if not run.epoch_s:
        return None
    ops = counts.forward(run.size, run.runs)[0] + counts.adjoint(run.size, run.runs)[0]
    return 100.0 * ops / (sum(run.epoch_s) / len(run.epoch_s) * F32_FLOPS)

"""K1 (``fused_fwd_kernel``, csrc/fused_evolution.cu): its roofline share
for the forward evolution of the problem (work/counts.py)."""

from benchmark.work import counts, roofline


def read(run):
    return roofline.share(run, "fused_fwd_kernel", counts.forward)

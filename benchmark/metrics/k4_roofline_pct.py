"""K4 (``fused_fwd_ckpt_kernel``, csrc/fused_ckpt.cu): its roofline share
for the forward evolution of the problem (work/counts.py)."""

from benchmark.work import counts, roofline


def read(run):
    return roofline.share(run, "fused_fwd_ckpt_kernel", counts.forward)

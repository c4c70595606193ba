"""K5 (``fused_bwd_ckpt_kernel``, csrc/fused_ckpt.cu): its roofline share
for the discrete adjoint of the problem (work/counts.py)."""

from benchmark.work import counts, roofline


def read(run):
    return roofline.share(run, "fused_bwd_ckpt_kernel", counts.adjoint)

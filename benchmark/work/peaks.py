"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

The kernels keep f32-compensated arithmetic outside the tensor cores
(two-word states and weights, to hold an f64 solve's 1e-6), so their
operations are held against the f32 rate outside the tensor cores.
"""

F32_FLOPS = 67e12  # FLOP/s, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # bytes/s, HBM3

"""The work counts as exact integers, and the roofline reader on a
synthetic trace."""

from types import SimpleNamespace

from benchmark.trace import Op, Trace, kernel_id
from benchmark.work import counts, roofline
from benchmark.work.peaks import F32_FLOPS, HBM_BYTES_PER_S

SIZE = {"atoms": 2, "steps": 3, "stages": 6, "axpys": 20, "slots": 2, "samples": 5,
        "streams": 2}


def test_bench_forward_counts():
    # H psi on 4 entries: (2 + 4 * 2) * 4 = 40; a step 6 * 40 + 20 * 4 * 4 = 560
    assert counts.forward(SIZE, 1) == (3 * 560, 3 * 2 * 4 * 8 + 4 * 8 + 2 * 5 * 8)
    assert counts.forward(SIZE, 8) == (8 * 3 * 560, 8 * 3 * 64 + 32 + 8 * 80)


def test_bench_adjoint_counts():
    # a step: 12 * 40 + 40 * 16 + 6 * 16 = 1216
    assert counts.adjoint(SIZE, 1) == (3 * 1216, 5 * 64 + 32 + 2 * 80)
    assert counts.adjoint({**SIZE, "atoms": 12, "steps": 166}, 1)[0] == 166 * 4096 * (12 * 50 + 160 + 24)


def test_bench_least_time_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 0) == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0
    assert counts.least_seconds(F32_FLOPS, 2 * HBM_BYTES_PER_S) == 2.0


def test_bench_kernel_names_match_whole():
    assert kernel_id("void fused_fwd_kernel<false>(float const*, Parts)") == "fused_fwd_kernel"
    assert kernel_id("void fused_fwd_ckpt_kernel(In, FwdOut, float*)") == "fused_fwd_ckpt_kernel"
    assert kernel_id("void at::native::vectorized_elementwise_kernel<4, X>(int, X)") == \
        "vectorized_elementwise_kernel"
    assert kernel_id("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"


def _trace(ops, epochs=2):
    window = Op("window", 0, 10_000_000)
    return Trace([Op(n, s, e) for n, s, e in ops], [], [], window, epochs)


def test_bench_roofline_matches_the_whole_name():
    tr = _trace([("void fused_fwd_kernel<false>(x)", 0, 2_000_000),
                 ("void fused_fwd_ckpt_kernel(x)", 3_000_000, 9_000_000)])
    run = SimpleNamespace(trace=tr, size=SIZE, runs=1)
    least = counts.least_seconds(*counts.forward(SIZE, 1))
    assert roofline.share(run, "fused_fwd_kernel", counts.forward) == 100 * least / 2e-3
    assert roofline.share(run, "fused_bwd_kernel", counts.adjoint) is None


def test_bench_busy_is_a_union():
    tr = _trace([("a", 0, 4_000_000), ("b", 1_000_000, 3_000_000), ("c", 6_000_000, 7_000_000)])
    assert tr.busy_s == 5e-3
    assert tr.window_s == 1e-2
    gaps = tr.idle_gaps()
    assert sum(s for _, s in gaps) == 5e-3


class _Event:
    """A trace event of a torch whose events do not give their activity."""

    def __init__(self, name, cuda):
        self._name, self._cuda = name, cuda

    def name(self):
        return self._name

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU


def test_bench_event_kinds_without_activity_type():
    from benchmark.trace import _kind

    labels = frozenset({"window", "forward"})
    assert _kind(_Event("void fused_bwd_kernel<false>(x)", True), labels) == "kernel"
    assert _kind(_Event("forward", True), labels) == "gpu_user_annotation"
    assert _kind(_Event("window", False), labels) == "user_annotation"
    assert _kind(_Event("aten::mm", False), labels) == "cpu_op"

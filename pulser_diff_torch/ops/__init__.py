from pulser_diff_torch.ops.linalg import (
    HMAT, IMAT, XMAT, YMAT, ZMAT, basis_state, expect, interpolate_sine, kron, s,
    total_magnetization, total_magnetization_diag, trace, vn_entropy,
)

__all__ = [
    "HMAT",
    "IMAT",
    "XMAT",
    "YMAT",
    "ZMAT",
    "basis_state",
    "expect",
    "interpolate_sine",
    "kron",
    "s",
    "total_magnetization",
    "total_magnetization_diag",
    "trace",
    "vn_entropy",
]

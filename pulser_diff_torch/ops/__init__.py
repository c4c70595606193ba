from pulser_diff_torch.ops.linalg import expect, interpolate_sine, kron, total_magnetization

__all__ = ["expect", "interpolate_sine", "kron", "total_magnetization"]

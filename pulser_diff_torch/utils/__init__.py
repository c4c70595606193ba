"""Parameter checkpoints, profiling helpers and step export (counterpart
of pulser_diff_tpu/utils: ``checkpoint``, ``profiling`` and ``export``)."""

from pulser_diff_torch.utils.checkpoint import load_params, save_params
from pulser_diff_torch.utils.export import export_step, load_meta, load_step
from pulser_diff_torch.utils.profiling import profile_trace, timed

__all__ = [
    "save_params",
    "load_params",
    "timed",
    "profile_trace",
    "export_step",
    "load_step",
    "load_meta",
]

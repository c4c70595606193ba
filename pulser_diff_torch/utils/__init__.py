"""Parameter checkpoints and profiling helpers (counterpart of
pulser_diff_tpu/utils: ``checkpoint`` and ``profiling``)."""

from pulser_diff_torch.utils.checkpoint import load_params, save_params
from pulser_diff_torch.utils.profiling import profile_trace, timed

__all__ = ["save_params", "load_params", "timed", "profile_trace"]

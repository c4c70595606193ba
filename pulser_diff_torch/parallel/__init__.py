"""Device meshes, sharded solves and multi-process sweeps on torch.distributed
(counterpart of pulser_diff_tpu/parallel)."""

from pulser_diff_torch.parallel.mesh import (
    make_mesh,
    sharded_expectation_step,
    sharded_mcwf_states,
    sharded_mesolve,
    sharded_noise_states,
    sharded_sesolve,
)

__all__ = [
    "make_mesh",
    "sharded_noise_states",
    "sharded_mcwf_states",
    "sharded_expectation_step",
    "sharded_sesolve",
    "sharded_mesolve",
]

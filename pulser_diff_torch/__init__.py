"""pulser_diff_torch: the PyTorch/CUDA port of pulser_diff_tpu.

A differentiable pulse-level emulator for neutral atoms: a Pulser-style
sequence becomes a factored Hamiltonian whose Schrodinger evolution is
differentiable in the pulse parameters.  On an NVIDIA H100 the evolution
and its adjoint run in hand-written CUDA kernels (``csrc/``); on the CPU
they run the kernels' plain PyTorch versions or the f64 stepper.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Importing this package changes no global torch state.
"""

from pulser_diff_torch.backend import TorchEmulator
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.derivative import deriv_param, deriv_time
from pulser_diff_torch.model import QuantumModel
from pulser_diff_torch.simconfig import NoiseModel, SimConfig
from pulser_diff_torch.solvers import SolverType, TimeGrid, sesolve

__all__ = [
    "Cplx",
    "NoiseModel",
    "QuantumModel",
    "SimConfig",
    "SolverType",
    "TimeGrid",
    "TorchEmulator",
    "deriv_param",
    "deriv_time",
    "sesolve",
]

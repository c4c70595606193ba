from pulser_diff_torch.solvers.mcwf import McwfResult, mcsolve
from pulser_diff_torch.solvers.solver import SolverType, TimeGrid, mesolve, sesolve

__all__ = ["McwfResult", "SolverType", "TimeGrid", "mcsolve", "mesolve", "sesolve"]

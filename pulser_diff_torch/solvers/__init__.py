from pulser_diff_torch.solvers.solver import SolverType, TimeGrid, sesolve

__all__ = ["SolverType", "TimeGrid", "sesolve"]

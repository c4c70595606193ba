"""f64 Schrodinger stepper (counterpart of pulser_diff_tpu/solvers/solver.py).

The port's f64 oracle and its route for ``fused=False``: a fixed-step
explicit Runge-Kutta integration (DP5 or RK4) on the merged grid of
Hamiltonian sampling times and evaluation times, written as a plain
Python loop over torch ops, differentiated by autograd.  Evaluation-time
states are collected at the grid's write slots.  Lindblad, Krylov,
adaptive and checkpointed forms are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.cplx import Cplx, cstack
from pulser_diff_torch.ops.apply import FactoredHamiltonian, h_apply_batched, interp_streams


class SolverType:
    """Solver identifiers (the subset this slice ports)."""

    DP5_SE = "DP5_SE"
    RK4_SE = "RK4_SE"
    RK4_PALLAS = "RK4_PALLAS"
    DP5_PALLAS = "DP5_PALLAS"


@dataclass(frozen=True)
class TimeGrid:
    """Merged integration grid: static structure (numpy slots) and the
    time values as a tensor."""

    times: torch.Tensor  # (n_grid,) sorted
    write_slots: np.ndarray  # (n_grid,) int: eval slot per grid point, or n_eval
    n_eval: int

    @staticmethod
    def make(sampling_times, eval_times, device: DeviceLike = None) -> "TimeGrid":
        """Build the grid host-side; ``eval_times`` sorted and unique.
        Equal times keep the sampling entry first (stable sort).  The
        times go to ``device`` (CUDA unless given)."""
        device = resolve_device(device)
        s_np = np.asarray(sampling_times, dtype=np.float64)
        e_np = np.asarray(eval_times, dtype=np.float64)
        merged = np.concatenate([s_np, e_np])
        perm = np.argsort(merged, kind="stable")
        n_eval = len(e_np)
        src_slot = np.concatenate(
            [np.full(len(s_np), n_eval, dtype=np.int32), np.arange(n_eval, dtype=np.int32)]
        )
        return TimeGrid(
            times=torch.as_tensor(merged[perm], dtype=DTYPE, device=device),
            write_slots=src_slot[perm],
            n_eval=n_eval,
        )

    def refined(self, substeps: int) -> "TimeGrid":
        """Insert ``substeps - 1`` equally spaced non-writing points into
        every interval (how the fused kernels honour the substep count)."""
        if substeps <= 1:
            return self
        t = self.times
        n = t.shape[0]
        w = torch.arange(1, substeps, dtype=t.dtype, device=t.device) / substeps
        interior = t[:-1, None] + (t[1:] - t[:-1])[:, None] * w[None, :]
        merged = torch.cat([torch.cat([t[:-1, None], interior], dim=1).reshape(-1), t[-1:]])
        slots = np.full((n - 1, substeps), self.n_eval, dtype=np.int32)
        slots[:, 0] = np.asarray(self.write_slots[:-1], np.int32)
        write_slots = np.concatenate(
            [slots.reshape(-1), np.asarray(self.write_slots[-1:], np.int32)]
        )
        return TimeGrid(times=merged, write_slots=write_slots, n_eval=self.n_eval)


_DP5_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0])
_DP5_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
]
_DP5_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84])

_RK4_C = np.array([0.0, 0.5, 0.5, 1.0])
_RK4_A = [[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]]
_RK4_B = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])


def _se_rhs(ham: FactoredHamiltonian, t: torch.Tensor, psi: Cplx) -> Cplx:
    """dpsi/dt = -i H(t) psi."""
    zr, zc, zk = interp_streams(ham, t)
    return h_apply_batched(ham, zr, zc, zk, psi).mul_neg_i()


def _explicit_rk_step(rhs, t0, h, y: Cplx, c_nodes, a_coeffs, b_weights) -> Cplx:
    """Generic explicit Runge-Kutta step over Cplx states."""
    ks = []
    for i, ci in enumerate(c_nodes):
        yi = y
        for j, aij in enumerate(a_coeffs[i]):
            if aij != 0.0:
                yi = yi + ks[j] * (float(aij) * h)
        ks.append(rhs(t0 + float(ci) * h, yi))
    out = y
    for bi, ki in zip(b_weights, ks):
        if bi != 0.0:
            out = out + ki * (float(bi) * h)
    return out


def _make_se_step(ham: FactoredHamiltonian, solver: str, substeps: int):
    if solver not in (SolverType.DP5_SE, SolverType.RK4_SE):
        raise ValueError(f"Unknown statevector solver '{solver}'.")
    c, A, B = (
        (_DP5_C, _DP5_A, _DP5_B) if solver == SolverType.DP5_SE else (_RK4_C, _RK4_A, _RK4_B)
    )

    def rhs(t, p):
        return _se_rhs(ham, t, p)

    def step(psi: Cplx, t0, t1) -> Cplx:
        h = (t1 - t0) / substeps
        for i in range(substeps):
            psi = _explicit_rk_step(rhs, t0 + i * h, h, psi, c, A, B)
        return psi

    return step


def _integrate(step, y0: Cplx, grid: TimeGrid) -> Cplx:
    """Loop over grid intervals, collecting eval-slot states."""
    n_eval = grid.n_eval
    out: list = [None] * n_eval
    slots = [int(s) for s in grid.write_slots]
    if slots[0] < n_eval:
        out[slots[0]] = y0
    y = y0
    t = grid.times
    for k in range(t.shape[0] - 1):
        y = step(y, t[k], t[k + 1])
        if slots[k + 1] < n_eval:
            out[slots[k + 1]] = y
    return cstack(out)


def sesolve(
    ham: FactoredHamiltonian,
    psi0: Cplx,
    grid: TimeGrid,
    solver: str = SolverType.DP5_SE,
    substeps: int = 1,
) -> Cplx:
    """Integrate i dpsi/dt = H(t) psi in f64.

    psi0: Cplx (nb, da, db).  Returns (n_eval, nb, da, db).
    """
    return _integrate(_make_se_step(ham, solver, substeps), psi0, grid)

"""Schrodinger stepper (counterpart of pulser_diff_tpu/solvers/solver.py).

The port's f64 oracle and its route for ``fused=False``: a fixed-step
explicit Runge-Kutta integration (DP5 or RK4) on the merged grid of
Hamiltonian sampling times and evaluation times, written as a plain
Python loop over torch ops, differentiated by autograd.  Evaluation-time
states are collected at the grid's write slots.

``DP5_SE_F32`` / ``RK4_SE_F32`` run the same steppers on an f32 copy of
the Hamiltonian, the state and the grid times, every product pinned to
full f32 precision (the JAX package's route past the fused kernels' cap).
Reverse mode can checkpoint the integration: ``remat`` recomputes each
grid interval's step in the backward pass, ``n_segments`` checkpoints
runs of about sqrt(n_steps) steps; by default both follow the JAX
package's memory rule (``_auto_remat``, ``_auto_segments``).  Lindblad,
Krylov and adaptive forms are later slices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.cplx import Cplx, cstack
from pulser_diff_torch.ops.apply import FactoredHamiltonian, h_apply_batched, interp_streams


class SolverType:
    """Solver identifiers (the subset ported so far)."""

    DP5_SE = "DP5_SE"
    RK4_SE = "RK4_SE"
    DP5_SE_F32 = "DP5_SE_F32"
    RK4_SE_F32 = "RK4_SE_F32"
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


# Residual-storage budget of reverse mode, the JAX package's rule and
# default (set there for a 16 GiB TPU, kept for parity): below it every
# stage is stored; above it one state per step (``remat``); when even that
# exceeds it, sqrt-segments.  PDT_REMAT_MB overrides it.
_REMAT_BYTES_THRESHOLD = int(os.environ.get("PDT_REMAT_MB", str(4 * 1024))) * 1024 * 1024


def _state_bytes(y0: Cplx) -> int:
    return 2 * y0.re.numel() * y0.re.element_size()


def _auto_remat(y0: Cplx, n_steps: int, stages: int = 6) -> bool:
    """Recompute each step in the backward pass only when storing its
    stages would exceed the budget."""
    return n_steps * stages * _state_bytes(y0) > _REMAT_BYTES_THRESHOLD


def _auto_segments(y0: Cplx, n_steps: int) -> Optional[int]:
    """sqrt-checkpointing's segment count when even one state per step
    would exceed the budget, else None."""
    if n_steps * _state_bytes(y0) > _REMAT_BYTES_THRESHOLD:
        return max(2, int(np.ceil(np.sqrt(n_steps))))
    return None


def _run_steps(step, y: Cplx, t: torch.Tensor, slots: list, n_eval: int, k0: int, k1: int,
               remat: bool = False):
    """Steps k0 .. k1 - 1 from ``y``: the last state and the (slot, state)
    pairs written on the way.  ``remat`` checkpoints each step."""
    writes = []
    for k in range(k0, k1):
        if remat:
            y = Cplx(*checkpoint(lambda re, im, t0, t1: tuple(step(Cplx(re, im), t0, t1)),
                                 y.re, y.im, t[k], t[k + 1], use_reentrant=False))
        else:
            y = step(y, t[k], t[k + 1])
        if slots[k + 1] < n_eval:
            writes.append((slots[k + 1], y))
    return y, writes


def _integrate(step, y0: Cplx, grid: TimeGrid, remat: bool = False,
               n_segments: Optional[int] = None) -> Cplx:
    """Loop over grid intervals, collecting eval-slot states.

    ``remat``: each step is recomputed in the backward pass, so reverse
    mode stores one state per step instead of its stages.  ``n_segments``:
    the steps are cut into that many runs (of ceil(n_steps / n_segments)
    steps, the last one shorter), each checkpointed as a whole, its steps
    not one by one (as in the JAX package); reverse mode then stores a
    state per segment plus one segment's stages.  Neither changes a value
    or a gradient.  With segments ``remat`` is not read, as in JAX."""
    n_eval = grid.n_eval
    out: list = [None] * n_eval
    slots = [int(s) for s in grid.write_slots]
    if slots[0] < n_eval:
        out[slots[0]] = y0
    t = grid.times
    n_steps = t.shape[0] - 1
    if n_segments is None or n_segments <= 1 or n_steps < 4:
        _, writes = _run_steps(step, y0, t, slots, n_eval, 0, n_steps, remat)
    else:
        seg_len = -(-n_steps // min(n_segments, n_steps))
        y, writes = y0, []

        def segment(k0, k1, re, im):
            last, seg_writes = _run_steps(step, Cplx(re, im), t, slots, n_eval, k0, k1)
            return (*last, *[v for _, w in seg_writes for v in w])

        for k0 in range(0, n_steps, seg_len):
            k1 = min(k0 + seg_len, n_steps)
            res = checkpoint(segment, k0, k1, y.re, y.im, use_reentrant=False)
            y = Cplx(res[0], res[1])
            seg_slots = [slots[k + 1] for k in range(k0, k1) if slots[k + 1] < n_eval]
            writes += [(s, Cplx(res[2 + 2 * i], res[3 + 2 * i])) for i, s in enumerate(seg_slots)]
    for slot, y in writes:
        out[slot] = y
    return cstack(out)


# f32 solver modes -> the stepper they run
_F32_SOLVERS = {
    SolverType.DP5_SE_F32: SolverType.DP5_SE,
    SolverType.RK4_SE_F32: SolverType.RK4_SE,
}


def _cast_ham(ham: FactoredHamiltonian, dtype: torch.dtype) -> FactoredHamiltonian:
    """Every float field of the factored Hamiltonian in ``dtype``, by
    differentiable casts (cotangents come back to the f64 leaves), the
    sample spacing as a 0-d tensor on the streams' device, as the JAX
    package casts it."""

    def c(x):
        if x is None:
            return None
        if isinstance(x, Cplx):
            return Cplx(x.re.to(dtype), x.im.to(dtype))
        return x.to(dtype)

    return ham._replace(
        row_parts=c(ham.row_parts),
        col_parts=c(ham.col_parts),
        row_streams=c(ham.row_streams),
        col_streams=c(ham.col_streams),
        int_diag=c(ham.int_diag),
        kron_row=c(ham.kron_row),
        kron_col=c(ham.kron_col),
        kron_streams=c(ham.kron_streams),
        sample_dt=torch.as_tensor(ham.sample_dt, dtype=dtype,
                                  device=ham.row_streams.re.device),
    )


def sesolve(
    ham: FactoredHamiltonian,
    psi0: Cplx,
    grid: TimeGrid,
    solver: str = SolverType.DP5_SE,
    substeps: int = 1,
    remat: Optional[bool] = None,
    n_segments: Optional[int] = None,
) -> Cplx:
    """Integrate i dpsi/dt = H(t) psi.

    psi0: Cplx (nb, da, db).  Returns (n_eval, nb, da, db), in f64, or in
    f32 for ``DP5_SE_F32`` / ``RK4_SE_F32``: the Hamiltonian, psi0 and the
    grid times cast to f32 (so the stream sample index is taken in f32, as
    the JAX package takes it) and the f64 modes' stepper run on them.
    ``remat`` / ``n_segments``: checkpointed integration (``_integrate``);
    None decides from the state's bytes (``_auto_remat``,
    ``_auto_segments``).
    """
    if solver in _F32_SOLVERS:
        f32 = torch.float32
        grid32 = TimeGrid(times=grid.times.to(f32), write_slots=grid.write_slots,
                          n_eval=grid.n_eval)
        return sesolve(_cast_ham(ham, f32), psi0.to(f32), grid32, _F32_SOLVERS[solver],
                       substeps, remat, n_segments)
    n_steps = grid.times.shape[0] * substeps
    if remat is None:
        remat = _auto_remat(psi0, n_steps)
    if n_segments is None:
        n_segments = _auto_segments(psi0, n_steps)
    return _integrate(_make_se_step(ham, solver, substeps), psi0, grid, remat, n_segments)

"""Schrodinger and Lindblad steppers (counterpart of
pulser_diff_tpu/solvers/solver.py).

``sesolve`` is the port's f64 oracle and its route for ``fused=False``: a fixed-step
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
package's memory rule (``_auto_remat``, ``_auto_segments``).

``mesolve`` integrates the Lindblad master equation on the density
matrix with the same steppers, in one of the JAX package's three forms of
the right-hand side: the Liouville superoperator (one (dim^2, dim^2)
product a stage, up to ``_SUPEROP_DIM_CAP``), the dense form (H(t) and
the lifted collapse operators as (dim, dim) products, up to
``_DENSE_ME_DIM_CAP``) and the factored per-site form above.  None of
them is a kernel of its own, in the JAX package or here: they are plain
matrix products.  ``DP5_ME_F32`` / ``RK4_ME_F32`` run them in f32 with
pinned products.

``KRYLOV_SE`` steps by the fourth-order commutator-free Magnus scheme
(CF4): two exponentials a substep, each exp(-i h H) psi taken in an
m-dimensional Lanczos subspace with full reorthogonalisation
(``_krylov_expm``), every column of the state batch in its own subspace
on one shared grid.  In f64 autograd runs through the recursion (the
exact discrete adjoint), with the small exponential's derivative taken
by divided differences (``_expm_sym_e1``), which stays finite where a
breakdown makes the spectrum degenerate; ``KRYLOV_SE_F32`` runs it in f32
and differentiates the exact map instead, a continuous adjoint on a
3-node Gauss rule (``_krylov_expm_cadj``).  ``DP5_SE_ADAPTIVE`` takes
adaptive DP5(4) steps inside each grid interval, differentiated by a
continuous-adjoint sweep of its own (``_AdaptiveEvolve``), its bounded
loop a host loop with one read an attempted step (``ADAPTIVE_COUNTS``).
No kernel lies under them, in the JAX package or here.

Under ``torch.export`` (``torch.compiler.is_exporting()``) ``sesolve`` and
``mesolve`` hand their loop to one custom op (``solvers/stepper_op.py``),
which runs the same steps on real tensors and differentiates them interval
by interval with ``torch.func.vjp``, so an exported step does not grow with
its steps; eagerly nothing of that runs.  The autograd Functions of the
Krylov and adaptive steppers take the ``setup_context`` form and
differentiate inside with ``torch.func.vjp``, so that the op can take them
through ``torch.func``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pulser_diff_torch.config import DeviceLike, default_dtype, resolve_device
from pulser_diff_torch.cplx import Cplx, cstack
from pulser_diff_torch.hamiltonian import CollapseOps
from pulser_diff_torch.ops.apply import (
    FactoredHamiltonian, _einsum, _f32_full_precision, _mm, _weighted_sum, apply_local_left,
    apply_local_right, ceinsum, h_apply_batched, h_apply_rho_left, h_applier,
    interp_streams,
)


class SolverType:
    """Solver identifiers."""

    DP5_SE = "DP5_SE"
    RK4_SE = "RK4_SE"
    # CF4-Magnus steps through Lanczos exponentials (f64 / f32)
    KRYLOV_SE = "KRYLOV_SE"
    KRYLOV_SE_F32 = "KRYLOV_SE_F32"
    # adaptive DP5(4) inside each grid interval, continuous adjoint
    DP5_SE_ADAPTIVE = "DP5_SE_ADAPTIVE"
    DP5_SE_F32 = "DP5_SE_F32"
    RK4_SE_F32 = "RK4_SE_F32"
    RK4_PALLAS = "RK4_PALLAS"
    DP5_PALLAS = "DP5_PALLAS"
    # the Lindblad master equation on the density matrix (f64 / f32)
    DP5_ME = "DP5_ME"
    RK4_ME = "RK4_ME"
    DP5_ME_F32 = "DP5_ME_F32"
    RK4_ME_F32 = "RK4_ME_F32"
    # quantum-jump trajectories (solvers/mcwf.py), f64 / f32 drift
    MCWF = "MCWF"
    MCWF_F32 = "MCWF_F32"

ME_SOLVERS = (SolverType.DP5_ME, SolverType.RK4_ME, SolverType.DP5_ME_F32,
              SolverType.RK4_ME_F32)


@dataclass(frozen=True)
class TimeGrid:
    """Merged integration grid: static structure (numpy slots) and the
    time values as a tensor.  A grid from :meth:`make` keeps the sampling
    times and the sort permutation, so that :meth:`with_values` can put
    other evaluation-time values (a tensor that carries gradients) into
    the same structure."""

    times: torch.Tensor  # (n_grid,) sorted
    write_slots: np.ndarray  # (n_grid,) int: eval slot per grid point, or n_eval
    n_eval: int
    sampling_times: Optional[torch.Tensor] = None  # kept for with_values()
    perm: Optional[np.ndarray] = None  # the merge's sort permutation

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
            times=torch.as_tensor(merged[perm], dtype=default_dtype(), device=device),
            write_slots=src_slot[perm],
            n_eval=n_eval,
            sampling_times=torch.as_tensor(s_np, dtype=default_dtype(), device=device),
            perm=perm,
        )

    def with_values(self, eval_times: torch.Tensor) -> "TimeGrid":
        """The same structure with the evaluation times ``eval_times``: the
        gradient in them flows into the grid's step sizes.  The values must
        stay close to those the grid was built with (the sort permutation
        is kept)."""
        if self.sampling_times is None or self.perm is None:
            raise ValueError("TimeGrid was not built by TimeGrid.make().")
        dev = self.sampling_times.device
        times = torch.cat([self.sampling_times,
                           torch.as_tensor(eval_times, dtype=default_dtype()).to(dev)])
        return TimeGrid(times=times[torch.as_tensor(self.perm, device=dev)],
                        write_slots=self.write_slots, n_eval=self.n_eval,
                        sampling_times=self.sampling_times, perm=self.perm)

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


def _tableau_of(solver: str):
    """(c, A, b) of a solver's DP5 or RK4 stages."""
    if solver in (SolverType.DP5_SE, SolverType.DP5_ME):
        return _DP5_C, _DP5_A, _DP5_B
    return _RK4_C, _RK4_A, _RK4_B


def _rk_step_fn(rhs, c, A, B, substeps: int):
    """step(y, t0, t1): ``substeps`` explicit RK steps of ``rhs``."""

    def step(y: Cplx, t0, t1) -> Cplx:
        h = (t1 - t0) / substeps
        for i in range(substeps):
            y = _explicit_rk_step(rhs, t0 + i * h, h, y, c, A, B)
        return y

    return step


def _make_se_step(ham: FactoredHamiltonian, solver: str, substeps: int, krylov_dim: int = 12,
                  krylov_tol: float = 1e-12, rtol: float = 1e-8, atol: float = 1e-10,
                  max_iters: int = 256):
    if solver in (SolverType.DP5_SE, SolverType.RK4_SE):
        return _rk_step_fn(lambda t, p: _se_rhs(ham, t, p), *_tableau_of(solver), substeps)
    if solver == SolverType.DP5_SE_ADAPTIVE:
        return _make_se_step_adaptive(ham, substeps, rtol, atol, max_iters)
    if solver == SolverType.KRYLOV_SE:
        return _make_se_step_krylov(ham, substeps, krylov_dim, krylov_tol)
    raise ValueError(f"Unknown statevector solver '{solver}'.")


# ----------------------------------------------------------------------
# Krylov CF4-Magnus stepper
# ----------------------------------------------------------------------
# Gauss nodes and weights of the fourth-order commutator-free Magnus
# scheme (Blanes-Moan), as Python floats, so that an f32 solve stays f32
# (as in the JAX package, where a numpy scalar would promote it).
_SQ3 = float(np.sqrt(3.0))
_CF4_C = (0.5 - _SQ3 / 6, 0.5 + _SQ3 / 6)
_CF4_A = ((3 - 2 * _SQ3) / 12, (3 + 2 * _SQ3) / 12)


def _mix(za: Optional[Cplx], zb: Optional[Cplx], wa: float, wb: float) -> Optional[Cplx]:
    if za is None or zb is None:
        return None
    return Cplx(wa * za.re + wb * zb.re, wa * za.im + wb * zb.im)


class _ApplyParts(NamedTuple):
    """The FactoredHamiltonian fields ``h_applier`` reads."""

    row_parts: torch.Tensor
    col_parts: torch.Tensor
    int_diag: torch.Tensor
    kron_row: Optional[torch.Tensor]
    kron_col: Optional[torch.Tensor]


def _make_se_step_krylov(ham: FactoredHamiltonian, substeps: int, m: int, tol: float):
    """CF4: per substep the two Gauss-point Hamiltonians mixed into two
    exponentials of h/2, the right factor (earlier times) first.  Each
    column of the (nb, da, db) state gets its own Lanczos subspace.  In
    f32 the exponential carries the continuous adjoint."""
    c1, c2 = _CF4_C
    a1, a2 = _CF4_A
    parts = _ApplyParts(ham.row_parts, ham.col_parts, ham.int_diag, ham.kron_row, ham.kron_col)

    def step(psi: Cplx, t0, t1) -> Cplx:
        h = (t1 - t0) / substeps
        cadj = psi.re.dtype == torch.float32
        for i in range(substeps):
            ts = t0 + i * h
            z1 = interp_streams(ham, ts + c1 * h)
            z2 = interp_streams(ham, ts + c2 * h)
            for wa, wb in ((2 * a2, 2 * a1), (2 * a1, 2 * a2)):
                zr, zc, zk = (_mix(x, y, wa, wb) for x, y in zip(z1, z2))
                if cadj:
                    psi = _krylov_expm_cadj(m, tol, parts, zr, zc, zk, h / 2, psi)
                else:
                    psi = _krylov_expm(h_applier(parts, zr, zc, zk), psi, h / 2, m, tol)
        return psi

    return step


# f32 breakdown floor, relative to the running spectral scale (~5 sqrt(f32
# eps)): below it a Lanczos residual is rounding noise
_KRYLOV_F32_REL_TOL = 3e-4


def _krylov_expm(apply, psi: Cplx, h, m: int, tol: float = 1e-12) -> Cplx:
    """exp(-i h H) psi for each column of psi (nb, da, db), in an
    m-dimensional Lanczos subspace of its own."""
    return _krylov_exp_of(_lanczos(apply, psi, m, tol), h)


def _lanczos(apply, psi: Cplx, m: int, tol: float = 1e-12) -> tuple:
    """The Lanczos subspace of each column of psi (nb, da, db): the basis
    (Q.re, Q.im), each (m, nb, da, db), the tridiagonal T (nb, m, m) and
    the columns' norms.  It does not depend on the step h.

    The recursion runs on the whole batch at once, with per-column alpha,
    beta and T (``_krylov_exp_of`` takes one batched ``eigh``).  Each new
    vector is
    reorthogonalised against the whole basis buffer in one masked
    contraction.  ``tol`` is the happy-breakdown threshold: once a
    column's residual norm falls to it, that column's later vectors and
    couplings are masked to zero (with ``torch.where`` before the square
    root, so reverse mode stays finite).  In f32 the threshold is also
    ``_KRYLOV_F32_REL_TOL`` times the column's running spectral scale (max
    |alpha|, beta), where the residual is rounding noise.  No value is
    read on the host."""
    dt, dev = psi.re.dtype, psi.re.device
    rel_tol = _KRYLOV_F32_REL_TOL if dt == torch.float32 else 0.0
    nb = psi.re.shape[0]
    axes = tuple(range(1, psi.re.ndim))
    q_axes = tuple(a + 1 for a in axes)

    def col(x: torch.Tensor) -> torch.Tensor:
        return x.reshape((nb,) + (1,) * len(axes))

    def contract(c: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
        # sum_k c[k, b] Q[k, b, ...]
        return _einsum("kb,kbx->bx", c, Q.reshape(Q.shape[0], nb, -1)).reshape(psi.re.shape)

    nrm = torch.sqrt(psi.abs2().sum(axes))
    q = psi * col(1.0 / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
    pad = [torch.zeros_like(q.re)] * m
    mask_all = torch.arange(m, device=dev)[:, None]
    q_re, q_im = [q.re], [q.im]
    beta_prev = torch.zeros(nb, dtype=dt, device=dev)
    alive = torch.ones(nb, dtype=dt, device=dev)
    scale = torch.zeros(nb, dtype=dt, device=dev)
    tol2 = torch.full((nb,), tol * tol, dtype=dt, device=dev)
    alphas, betas = [], []
    for j in range(m):
        qj = Cplx(q_re[j], q_im[j])
        w = apply(qj)
        alpha = (w.re * qj.re + w.im * qj.im).sum(axes)
        scale = torch.maximum(scale, torch.maximum(alpha.abs(), beta_prev))
        w = w - qj * col(alpha)
        if j > 0:
            w = w - Cplx(q_re[j - 1], q_im[j - 1]) * col(beta_prev)
        # full reorthogonalisation against every built vector (k <= j), one
        # masked contraction against the whole (m, nb, da, db) buffer
        Q_re = torch.stack(q_re + pad[len(q_re):])
        Q_im = torch.stack(q_im + pad[len(q_im):])
        mask = (mask_all <= j).to(dt)
        ov_re = ((Q_re * w.re).sum(q_axes) + (Q_im * w.im).sum(q_axes)) * mask
        ov_im = ((Q_re * w.im).sum(q_axes) - (Q_im * w.re).sum(q_axes)) * mask
        w = Cplx(w.re - contract(ov_re, Q_re) + contract(ov_im, Q_im),
                 w.im - contract(ov_re, Q_im) - contract(ov_im, Q_re))
        # mask before the square root: its derivative is unbounded at 0
        s2 = w.abs2().sum(axes)
        thr2 = torch.maximum(tol2, (rel_tol * scale) ** 2)
        ok = s2 > thr2
        beta = torch.sqrt(torch.where(ok, s2, torch.ones_like(s2))) * ok.to(dt)
        alive = alive * ok.to(dt)
        if j + 1 < m:
            q_next = w * col(alive / torch.where(beta > 0, beta, torch.ones_like(beta)))
            q_re.append(q_next.re)
            q_im.append(q_next.im)
        alphas.append(alpha)
        betas.append(beta * alive)
        beta_prev = beta
    a = torch.stack(alphas, -1)
    b = torch.stack(betas[:-1], -1)
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    return torch.stack(q_re), torch.stack(q_im), T, nrm


def _krylov_exp_of(basis: tuple, h) -> Cplx:
    """nrm sum_k u_k q_k with u = expm(-i h T) e1: exp(-i h H) psi from
    psi's Lanczos subspace."""
    Q_re, Q_im, T, nrm = basis
    m, nb, shape = Q_re.shape[0], Q_re.shape[1], Q_re.shape[1:]

    def contract(c: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
        # sum_k c[k, b] Q[k, b, ...]
        return _einsum("kb,kbx->bx", c, Q.reshape(m, nb, -1)).reshape(shape)

    u_re, u_im = (u.transpose(0, 1) for u in _expm_sym_e1(T, h))
    out = Cplx(contract(u_re, Q_re) - contract(u_im, Q_im),
               contract(u_re, Q_im) + contract(u_im, Q_re))
    return out * nrm.reshape((nb,) + (1,) * (len(shape) - 1))


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x over leading batch axes (x one axis shorter than A)."""
    return (A @ x[..., None])[..., 0]


class _ExpmSymE1(torch.autograd.Function):
    """(re, im) of expm(-i h T) e1 for small symmetric T (..., m, m), by
    an eigendecomposition on T's device (its eigenpairs are returned too,
    not differentiable).  The backward pass is the
    transpose of the JAX package's Daleckii-Krein JVP: divided
    differences F_ij = (f(l_i) - f(l_j)) / (l_i - l_j), and on
    (near-)degenerate pairs the derivative f'(mu) = -i h e^{-i h mu} at
    the midpoint, so the gradient stays finite where plain autograd
    through ``eigh`` divides by a zero gap (as after a Lanczos breakdown).
    Products in f32 run at full f32 precision.

    An f32 T is decomposed in f64 and the eigenpairs rounded to f32: the
    f32 ``eigh`` of PyTorch's LAPACK build loses orthogonality at ~1e-7 a
    call, biased, and over a solve's few hundred calls that drift in the
    state's norm put KRYLOV_SE_F32 ~3x further from f64 than the JAX
    package's f32 mode (tests/test_torch_krylov.py)."""

    @staticmethod
    def forward(T, h):
        with _f32_full_precision():
            if T.dtype == torch.float32:
                lam, V = (x.to(T.dtype) for x in torch.linalg.eigh(T.to(torch.float64)))
            else:
                lam, V = torch.linalg.eigh(T)
            phase = lam * (-h)
            v0 = V[..., 0, :]
            u_re = _bmv(V, torch.cos(phase) * v0)
            u_im = _bmv(V, torch.sin(phase) * v0)
        return u_re, u_im, lam, V

    @staticmethod
    def setup_context(ctx, inputs, output):
        T, h = inputs
        lam, V = output[2:]
        ctx.mark_non_differentiable(lam, V)
        ctx.save_for_backward(lam, V, torch.as_tensor(h, dtype=T.dtype, device=T.device))
        ctx.h_is_tensor = isinstance(h, torch.Tensor)

    @staticmethod
    def backward(ctx, g_re, g_im, _g_lam, _g_v):
        lam, V, h = ctx.saved_tensors
        with _f32_full_precision():
            phase = lam * (-h)
            f_re, f_im = torch.cos(phase), torch.sin(phase)
            v0 = V[..., 0, :]
            dl = lam[..., :, None] - lam[..., None, :]
            scale = torch.clamp(lam.abs().amax(-1), min=1.0)[..., None, None]
            near = dl.abs() < 1e-10 * scale
            safe_dl = torch.where(near, torch.ones_like(dl), dl)
            mid = 0.5 * (lam[..., :, None] + lam[..., None, :]) * (-h)
            F_re = torch.where(near, h * torch.sin(mid),
                               (f_re[..., :, None] - f_re[..., None, :]) / safe_dl)
            F_im = torch.where(near, -h * torch.cos(mid),
                               (f_im[..., :, None] - f_im[..., None, :]) / safe_dl)
            Vt = V.transpose(-1, -2)
            a, b = _bmv(Vt, g_re), _bmv(Vt, g_im)
            G = (F_re * a[..., :, None] + F_im * b[..., :, None]) * v0[..., None, :]
            T_bar = V @ G @ Vt
            # d/dh e^{-i h l} = -i l e^{-i h l}
            h_bar = (a * (lam * f_im) * v0 - b * (lam * f_re) * v0).sum()
        return T_bar, (h_bar.reshape(h.shape) if ctx.h_is_tensor else None)


def _expm_sym_e1(T: torch.Tensor, h) -> tuple[torch.Tensor, torch.Tensor]:
    return _ExpmSymE1.apply(T, h)[:2]


# The f32 path differentiates the exact map, not the recursion (reverse
# mode through an f32 Lanczos recursion overflows near an eigenstate,
# where the small betas' sensitivities cancel only in f64):
#   cot_psi = exp(+i h H) ct
#   <ct, d exp(-i h H) psi> = h Int_0^1 Im(u(s)^H dH v(s)) ds,
#       v(s) = exp(-i h s H) psi,  u(s) = exp(-i h s H) cot_psi,
# the integral by 3-node Gauss-Legendre quadrature.
_KRYLOV_ADJ_NODES = (0.5 - float(np.sqrt(15)) / 10, 0.5, 0.5 + float(np.sqrt(15)) / 10)
_KRYLOV_ADJ_WEIGHTS = (5 / 18, 4 / 9, 5 / 18)


class _KrylovExpmCadj(torch.autograd.Function):
    """``_krylov_expm`` with the continuous adjoint above as its backward
    pass.  Differentiable in the part stacks, the interaction diagonal,
    the kron part matrices, the mixed stream values, h and psi."""

    @staticmethod
    def forward(m, tol, *args):
        ops, h, psi_re, psi_im = args[:11], args[11], args[12], args[13]
        with _f32_full_precision():
            out = _krylov_expm(_cadj_apply(ops), Cplx(psi_re, psi_im), h, m, tol)
        return out.re, out.im

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.m, ctx.tol = inputs[:2]
        ctx.save_for_backward(*inputs[2:], *output)

    @staticmethod
    def backward(ctx, g_re, g_im):
        with _f32_full_precision():
            return _KrylovExpmCadj._backward(ctx, g_re, g_im)

    @staticmethod
    def _backward(ctx, g_re, g_im):
        saved = ctx.saved_tensors
        ops, h, psi, out = saved[:11], saved[11], Cplx(*saved[12:14]), Cplx(*saved[14:16])
        m, tol = ctx.m, ctx.tol
        apply = _cadj_apply(ops)
        ct = Cplx(g_re, g_im)
        lam = _krylov_expm(apply, ct, -h, m, tol)
        need = ctx.needs_input_grad[2:13]
        grads = [None] * 11
        want = [i for i in range(11) if need[i] and ops[i] is not None]
        if want:
            # one subspace each for psi and lam serves every node
            nb = psi.re.shape[0]
            basis = _lanczos(apply, Cplx(torch.cat([psi.re, lam.re]), torch.cat([psi.im, lam.im])),
                             m, tol)
            for s, wq in zip(_KRYLOV_ADJ_NODES, _KRYLOV_ADJ_WEIGHTS):
                vu = _krylov_exp_of(basis, h * s)
                v_s, u_s = vu[:nb], vu[nb:]

                def apply_to_v(*xs):
                    leaves = list(ops)
                    for i, x in zip(want, xs):
                        leaves[i] = x
                    y = _cadj_apply(leaves)(v_s)
                    return y.re, y.im

                # <ct_F, X> = wq h Im(u_s^H X)
                _, vjp_fn = torch.func.vjp(apply_to_v, *[ops[i] for i in want])
                gs = vjp_fn((-(wq * h) * u_s.im, (wq * h) * u_s.re))
                for i, g in zip(want, gs):
                    grads[i] = g if grads[i] is None else grads[i] + g
        g_h = None
        if ctx.needs_input_grad[13]:
            # d/dh exp(-i h H) psi = -i H out
            z = apply(out)
            g_h = (ct.re * z.im - ct.im * z.re).sum().reshape(h.shape)
        return (None, None, *grads, g_h, lam.re, lam.im)


def _cadj_apply(ops):
    """v -> H v for the flat operands of ``_KrylovExpmCadj``: the five
    ``_ApplyParts`` fields, then zr, zc and zk as (re, im) pairs."""
    zk = None if ops[9] is None else Cplx(ops[9], ops[10])
    return h_applier(_ApplyParts(*ops[:5]), Cplx(ops[5], ops[6]), Cplx(ops[7], ops[8]), zk)


def _krylov_expm_cadj(m: int, tol: float, parts: _ApplyParts, zr: Cplx, zc: Cplx,
                      zk: Optional[Cplx], h, psi: Cplx) -> Cplx:
    zk_ = (None, None) if zk is None else tuple(zk)
    re, im = _KrylovExpmCadj.apply(m, tol, *parts, *zr, *zc, *zk_, h, psi.re, psi.im)
    return Cplx(re, im)


# ----------------------------------------------------------------------
# adaptive DP5(4) with a continuous adjoint
# ----------------------------------------------------------------------
# embedded 4th-order weights of the error estimate (with the FSAL 7th
# stage k7 = f(t + h, y5))
_DP5_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)

# the adaptive loops' host traffic: attempted and accepted steps, and the
# host reads of the loop condition (one an attempted step, one before
# the first); ``reset_adaptive_counts`` sets them to 0
ADAPTIVE_COUNTS = {"attempts": 0, "accepted": 0, "reads": 0}


def reset_adaptive_counts() -> None:
    for k in ADAPTIVE_COUNTS:
        ADAPTIVE_COUNTS[k] = 0


def _axpy(y: list, k: list, c) -> list:
    return [a + c * b for a, b in zip(y, k)]


def _adaptive_dp5(rhs, y0: list, span, h0, rtol: float, atol: float, max_iters: int) -> list:
    """Integrate dy/ds = rhs(s, y) over a list of tensors from s = 0 to
    ``span`` by adaptive DP5(4) steps (the JAX package's
    ``_adaptive_dp5_pytree``): componentwise error scale atol + rtol |y|,
    RMS-normed over every element of every tensor; a step is accepted at
    norm <= 1; the next step is clip(0.9 norm^-0.2, 0.2, 5) times this
    one; the loop ends at s >= span - 1e-15 or after ``max_iters``
    attempts, accepted or not.  JAX's bounded while loop becomes a host
    loop: one host read an attempted step (its accept flag and the
    condition together) and one before the first."""
    n_elems = sum(int(x.numel()) for x in y0) or 1
    s, h, y = span * 0.0, h0, list(y0)
    ADAPTIVE_COUNTS["reads"] += 1
    go = bool(s < span - 1e-15)
    i = 0
    while go and i < max_iters:
        h_eff = torch.minimum(h, span - s)
        ks = []
        for st, cs in enumerate(_DP5_C):
            yi = y
            for j, a in enumerate(_DP5_A[st]):
                if a != 0.0:
                    yi = _axpy(yi, ks[j], float(a) * h_eff)
            ks.append(rhs(s + float(cs) * h_eff, yi))
        y5 = y
        for bi, ki in zip(_DP5_B, ks):
            if bi != 0.0:
                y5 = _axpy(y5, ki, float(bi) * h_eff)
        ks.append(rhs(s + h_eff, y5))  # FSAL 7th stage
        err = None
        for b5i, b4i, ki in zip(list(_DP5_B) + [0.0], _DP5_B4, ks):
            d = float(b5i - b4i)
            if d != 0.0:
                err = [(d * h_eff) * k for k in ki] if err is None else _axpy(err, ki, d * h_eff)
        sq_sum = sum(((e / (atol + rtol * yv.abs())) ** 2).sum() for e, yv in zip(err, y))
        err_norm = torch.sqrt(sq_sum / n_elems)
        accept = err_norm <= 1.0
        y = [torch.where(accept, a, b) for a, b in zip(y5, y)]
        s = torch.where(accept, s + h_eff, s)
        factor = torch.clamp(0.9 * torch.where(err_norm > 0, err_norm, 1e-10) ** -0.2, 0.2, 5.0)
        h = h_eff * factor
        i += 1
        accepted, go = torch.stack([accept, s < span - 1e-15]).tolist()
        ADAPTIVE_COUNTS["attempts"] += 1
        ADAPTIVE_COUNTS["accepted"] += int(accepted)
        ADAPTIVE_COUNTS["reads"] += 1
    return y


def _rebuild_ham(parts: tuple, streams, n_samples: int) -> FactoredHamiltonian:
    """A FactoredHamiltonian from its constant parts (row_parts,
    col_parts, sample_dt) and its differentiable streams (row_streams re,
    im, col_streams re, im, int_diag, kron_row, kron_col, kron_streams re,
    im; the kron entries None without kron pairs)."""
    row_parts, col_parts, sample_dt = parts
    rs_re, rs_im, cs_re, cs_im, diag, kr, kc, ks_re, ks_im = streams
    return FactoredHamiltonian(
        row_parts=row_parts, col_parts=col_parts, row_streams=Cplx(rs_re, rs_im),
        col_streams=Cplx(cs_re, cs_im), int_diag=diag, sample_dt=sample_dt,
        n_samples=n_samples, kron_row=kr, kron_col=kc,
        kron_streams=None if ks_re is None else Cplx(ks_re, ks_im),
    )


class _AdaptiveEvolve(torch.autograd.Function):
    """Adaptive DP5(4) evolution of psi over [t0, t1] (the JAX package's
    ``_adaptive_evolve``).  Its backward pass is a second adaptive sweep,
    from t1 back to t0, of the augmented system (psi, costate, stream
    cotangents), with the error norm over all of it; the interval ends'
    cotangents come back too (the evaluation-time gradients).  The part
    stacks and sample spacing are constant."""

    @staticmethod
    def forward(cfg, parts, t0, t1, psi_re, psi_im, *streams):
        n_samples, rtol, atol, max_iters = cfg
        ham = _rebuild_ham(parts, streams, n_samples)
        span = t1 - t0
        y = _adaptive_dp5(lambda s, p: list(_se_rhs(ham, t0 + s, Cplx(*p))),
                          [psi_re, psi_im], span, span, rtol, atol, max_iters)
        # an empty interval returns psi itself: as a view, which
        # setup_context may save
        return tuple(a.view_as(a) if a is b else a for a, b in zip(y, (psi_re, psi_im)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        cfg, parts, t0, t1 = inputs[:4]
        ctx.cfg, ctx.parts = cfg, parts
        ctx.save_for_backward(t0, t1, *output, *inputs[6:])

    @staticmethod
    def backward(ctx, g_re, g_im):
        t0, t1, p1_re, p1_im, *streams = ctx.saved_tensors
        n_samples, rtol, atol, max_iters = ctx.cfg
        live = [i for i, x in enumerate(streams) if x is not None]
        span = t1 - t0

        def f(st, t, psi: Cplx) -> Cplx:
            return _se_rhs(_rebuild_ham(ctx.parts, st, n_samples), t, psi)

        def aug_rhs(s, y):
            # dpsi/ds = -f;  dlam/ds = (df/dpsi)^T lam;  dtheta/ds = (df/dtheta)^T lam
            def f_of(*xs):
                st = list(streams)
                for i, x in zip(live, xs):
                    st[i] = x
                fv = f(st, t1 - s, Cplx(*xs[len(live):]))
                return fv.re, fv.im

            fv, vjp_fn = torch.func.vjp(f_of, *[streams[i] for i in live], y[0], y[1])
            gs = vjp_fn((y[2], y[3]))
            return [-fv[0], -fv[1], gs[-2], gs[-1], *gs[:-2]]

        y0 = [p1_re, p1_im, g_re, g_im] + [torch.zeros_like(streams[i]) for i in live]
        y = _adaptive_dp5(aug_rhs, y0, span, span, rtol, atol, max_iters)
        lam0 = Cplx(y[2], y[3])
        grads = [None] * len(streams)
        for i, g in zip(live, y[4:]):
            grads[i] = g
        t0_bar = t1_bar = None
        if ctx.needs_input_grad[3]:
            f1 = f(streams, t1, Cplx(p1_re, p1_im))
            t1_bar = (g_re * f1.re).sum() + (g_im * f1.im).sum()
        if ctx.needs_input_grad[2]:
            f0 = f(streams, t0, Cplx(y[0], y[1]))
            t0_bar = -((lam0.re * f0.re).sum() + (lam0.im * f0.im).sum())
        return (None, None, t0_bar, t1_bar, lam0.re, lam0.im, *grads)


def _make_se_step_adaptive(ham: FactoredHamiltonian, substeps: int, rtol: float = 1e-8,
                           atol: float = 1e-10, max_iters: int = 256):
    """Adaptive DP5(4) per grid interval (``substeps`` is not read, as in
    the JAX package), differentiable through ``_AdaptiveEvolve``."""
    cfg = (int(ham.n_samples), float(rtol), float(atol), int(max_iters))
    parts = (ham.row_parts, ham.col_parts, ham.sample_dt)
    ks = ham.kron_streams
    streams = (ham.row_streams.re, ham.row_streams.im, ham.col_streams.re, ham.col_streams.im,
               ham.int_diag, ham.kron_row, ham.kron_col,
               None if ks is None else ks.re, None if ks is None else ks.im)

    def step(psi: Cplx, t0, t1) -> Cplx:
        re, im = _AdaptiveEvolve.apply(cfg, parts, t0, t1, psi.re, psi.im, *streams)
        return Cplx(re, im)

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


def _me_auto_remat(me_form: str, dim: int, rho0: Cplx, n_steps: int) -> bool:
    """The JAX package's remat rule for mesolve: as ``_auto_remat``, and
    also when what each stage materializes for the backward pass would
    exceed the budget: the (dim^2, dim^2) Liouvillian (superop), or H(t)
    and the stage's rho, ~4 dim^2 words (dense)."""
    if _auto_remat(rho0, n_steps):
        return True
    itemsize = rho0.re.element_size()
    if me_form == "superop":
        stage_bytes = 2 * dim**4 * itemsize
    elif me_form == "dense":
        stage_bytes = 4 * dim**2 * itemsize
    else:
        return False
    return n_steps * 6 * stage_bytes > _REMAT_BYTES_THRESHOLD


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


# ----------------------------------------------------------------------
# the Lindblad right-hand side, factored per site
# ----------------------------------------------------------------------
def _group_collapse(collapse: CollapseOps, n: int, d: int) -> list:
    """[(site, L, Q)] by site, in site order: L the (m, d, d) stack of the
    operators at that site, Q = sum_m L_m^+ L_m (d, d)."""
    if collapse.ops is None:
        return []
    by_site: dict = {}
    for k, s_ in enumerate(collapse.sites):
        by_site.setdefault(int(s_), []).append(k)
    groups = []
    for site in sorted(by_site):
        idx = torch.as_tensor(by_site[site], device=collapse.ops.re.device)
        L = Cplx(collapse.ops.re[idx], collapse.ops.im[idx])
        q_re = _einsum("mji,mjk->ik", L.re, L.re) + _einsum("mji,mjk->ik", L.im, L.im)
        q_im = _einsum("mji,mjk->ik", L.re, L.im) - _einsum("mji,mjk->ik", L.im, L.re)
        groups.append((site, L, Cplx(q_re, q_im)))
    return groups


def _site_superops(groups: list, d: int) -> list:
    """[(site, B)]: each site's dissipator as one real (2 d^2, 2 d^2) block
    matrix [[S.re, -S.im], [S.im, S.re]] acting on the pair (row digit,
    column digit) of rho at that site, with
        S[x, y, i, j] = sum_m L_m[x, i] conj(L_m)[y, j]
                        - 1/2 (Q[x, i] delta[y, j] + delta[x, i] Q[j, y]),
    so that sum_m L_m rho L_m^+ - 1/2 {Q, rho} at the site is one product
    (the JAX package contracts the same terms one by one)."""
    out = []
    for site, L, Q in groups:
        eye = torch.eye(d, dtype=Q.re.dtype, device=Q.re.device)
        one = Cplx(eye, torch.zeros_like(eye))
        S = (ceinsum("mxi,myj->xyij", L, L.conj())
             - (ceinsum("xi,yj->xyij", Q, one) + ceinsum("xi,jy->xyij", one, Q)) * 0.5)
        s_re, s_im = S.re.reshape(d * d, d * d), S.im.reshape(d * d, d * d)
        out.append((site, torch.cat([torch.cat([s_re, -s_im], 1), torch.cat([s_im, s_re], 1)])))
    return out


def _dissipator(site_ops: list, n: int, d: int, rho: Cplx) -> Cplx:
    """sum_k L_k rho L_k^+ - 1/2 {L_k^+ L_k, rho}: at each site one real
    product of its ``_site_superops`` block with rho's re and im, the
    site's row and column digits brought to the front."""
    dim = d**n
    x = torch.stack([rho.re, rho.im])
    out = None
    for site, B in site_ops:
        lead, trail = d**site, dim // d ** (site + 1)
        site_view = (2, lead, d, trail, lead, d, trail)
        xs = x.reshape(site_view).permute(0, 2, 5, 1, 3, 4, 6)
        y = _mm(B, xs.reshape(2 * d * d, -1)).reshape(xs.shape).permute(0, 3, 1, 4, 5, 2, 6)
        out = (y if out is None else out.reshape(site_view) + y).reshape(2, dim, dim)
    return Cplx(out[0], out[1])


def _me_rhs(ham: FactoredHamiltonian, site_ops: list, n: int, d: int, t: torch.Tensor,
            rho: Cplx) -> Cplx:
    """drho/dt = -i[H, rho] + sum_k L_k rho L_k^+ - 1/2 {L_k^+ L_k, rho}."""
    zr, zc, zk = interp_streams(ham, t)
    hrho = h_apply_rho_left(ham, zr, zc, zk, rho)
    # -i (H rho - (H rho)^H): rho H = (H rho)^H for H and rho hermitian
    out = Cplx(hrho.re - hrho.re.T, hrho.im + hrho.im.T).mul_neg_i()
    if site_ops:
        out = out + _dissipator(site_ops, n, d, rho)
    return out


def _make_me_step(ham, collapse, n, d, solver, substeps):
    site_ops = _site_superops(_group_collapse(collapse, n, d), d)
    return _rk_step_fn(lambda t, r: _me_rhs(ham, site_ops, n, d, t, r), *_tableau_of(solver),
                       substeps)


# ----------------------------------------------------------------------
# the Liouville (superoperator) form, for small dims
# ----------------------------------------------------------------------
# The right-hand side is linear in the real stream components w_j(t):
#     d vec(rho)/dt = (S0 + sum_j w_j(t) S_j) vec(rho),
# with the stack S built once a solve, so a stage is one (dim^2, dim^2)
# product.  Row-major vec: vec(A rho B) = (A (x) B^T) vec(rho).  The cap
# is the JAX package's, set from its TPU runs; kept for parity.
_SUPEROP_DIM_CAP = 8


def _lifted_parts(ham: FactoredHamiltonian) -> list:
    """Every real part of H lifted to (dim, dim), in the order of
    ``interp_streams``' coefficients: rows, columns, kron pairs."""
    dev, dt_ = ham.int_diag.device, ham.int_diag.dtype
    eye_a = torch.eye(ham.da, dtype=dt_, device=dev)
    eye_b = torch.eye(ham.db, dtype=dt_, device=dev)
    lifts = [torch.kron(p, eye_b) for p in ham.row_parts]
    lifts += [torch.kron(eye_a, p) for p in ham.col_parts]
    if ham.kron_row is not None:
        lifts += [torch.kron(r, c) for r, c in zip(ham.kron_row, ham.kron_col)]
    return lifts


def _lifted_collapse(collapse: CollapseOps, n: int, d: int) -> Optional[Cplx]:
    """The collapse operators lifted to (M, dim, dim)."""
    if collapse.ops is None:
        return None
    dim = d**n
    dev, dt_ = collapse.ops.re.device, collapse.ops.re.dtype
    re, im = [], []
    for m, site in enumerate(collapse.sites):
        il = torch.eye(d ** int(site), dtype=dt_, device=dev)
        it = torch.eye(dim // d ** (int(site) + 1), dtype=dt_, device=dev)
        re.append(torch.kron(il, torch.kron(collapse.ops.re[m], it)))
        im.append(torch.kron(il, torch.kron(collapse.ops.im[m], it)))
    return Cplx(torch.stack(re), torch.stack(im))


def _superop_terms(ham: FactoredHamiltonian, collapse: CollapseOps, n: int, d: int):
    """(S0, S): the static Cplx (dim^2, dim^2) superoperator and the
    stacked Cplx (J, dim^2, dim^2) ones in ``_superop_w``'s order.  Each
    real part P gives two hermitian generators: x: M = P + P^T, -i[M, .]
    = -i(M (x) I - I (x) M); y: M = i(P - P^T), -i[M, .] = K (x) I + I (x)
    K with K = P - P^T."""
    dim = ham.dim
    dev, dt_ = ham.int_diag.device, ham.int_diag.dtype
    eye = torch.eye(dim, dtype=dt_, device=dev)

    def comm_sym(m):
        s_ = torch.kron(m, eye) - torch.kron(eye, m)
        return Cplx(torch.zeros_like(s_), -s_)

    def comm_asym(k):
        s_ = torch.kron(k, eye) + torch.kron(eye, k)
        return Cplx(s_, torch.zeros_like(s_))

    stack: list = []
    for lift in _lifted_parts(ham):
        stack.append(comm_sym(lift + lift.T))
        stack.append(comm_asym(lift - lift.T))
    # static part: -i[diag(U), .] + the dissipator
    s0 = comm_sym(torch.diag(ham.int_diag.reshape(-1)))
    lifted = _lifted_collapse(collapse, n, d)
    if lifted is not None:
        for lr, li in zip(lifted.re, lifted.im):
            # vec(L rho L^+) = (L (x) conj(L)) vec(rho)
            t_re = torch.kron(lr, lr) + torch.kron(li, li)
            t_im = torch.kron(li, lr) - torch.kron(lr, li)
            # -1/2 {Q, rho}, Q = L^+ L hermitian (Q^T = conj(Q))
            q_re = _mm(lr.T, lr) + _mm(li.T, li)
            q_im = _mm(lr.T, li) - _mm(li.T, lr)
            a_re = -0.5 * (torch.kron(q_re, eye) + torch.kron(eye, q_re))
            a_im = -0.5 * (torch.kron(q_im, eye) - torch.kron(eye, q_im))
            s0 = s0 + Cplx(t_re + a_re, t_im + a_im)
    if not stack:
        return s0, None
    return s0, Cplx(torch.stack([x.re for x in stack]), torch.stack([x.im for x in stack]))


def _superop_w(zr: Cplx, zc: Cplx, zk: Optional[Cplx]) -> torch.Tensor:
    """The real coefficients in ``_superop_terms``' order: (x_0, y_0, x_1,
    y_1, ...) per part, rows, then columns, then kron pairs."""
    ws = [torch.stack([z.re, z.im], -1).reshape(-1) for z in (zr, zc, zk) if z is not None]
    return torch.cat(ws)


def _make_me_step_superop(ham, collapse, n, d, solver, substeps):
    S0, S = _superop_terms(ham, collapse, n, d)
    dim2 = ham.dim**2

    def rhs(t, v: Cplx) -> Cplx:
        lt_re, lt_im = S0.re, S0.im
        if S is not None:
            w = _superop_w(*interp_streams(ham, t))
            lt_re = lt_re + _weighted_sum(w, S.re)
            lt_im = lt_im + _weighted_sum(w, S.im)
        vr, vi = v.re.reshape(dim2, 1), v.im.reshape(dim2, 1)
        return Cplx((_mm(lt_re, vr) - _mm(lt_im, vi)).reshape(dim2),
                    (_mm(lt_re, vi) + _mm(lt_im, vr)).reshape(dim2))

    inner = _rk_step_fn(rhs, *_tableau_of(solver), substeps)

    def step(rho: Cplx, t0, t1) -> Cplx:
        return inner(rho.reshape(dim2), t0, t1).reshape(ham.dim, ham.dim)

    return step


# ----------------------------------------------------------------------
# the dense form, for mid-size rho
# ----------------------------------------------------------------------
# H(t) materialized as one (dim, dim) Cplx a stage from precomputed lifted
# part stacks, the collapse operators lifted to (M, dim, dim) once a
# solve, and the right-hand side as (dim, dim) products:
#     -i[H, rho]                 -> U = H rho;  -i(U - U^H)
#     -1/2 {G, rho}, G = sum L^+L -> W = G rho;  -(W + W^H) / 2
#     sum_m L_m rho L_m^+        -> T = L rho (batched);  sum_m T_m L_m^+
# The cap is the JAX package's, set from its TPU runs; kept for parity.
_DENSE_ME_DIM_CAP = 2048


def _dense_h_stacks(ham: FactoredHamiltonian):
    """(diag(U), Sym, Asym): H(t) = diag(U) + sum_j x_j Sym_j + i sum_j
    y_j Asym_j with x + iy a part's coefficient, Sym = P + P^T and Asym =
    P - P^T real (J, dim, dim) stacks (None without parts)."""
    diag = torch.diag(ham.int_diag.reshape(-1))
    lifts = _lifted_parts(ham)
    if not lifts:
        return diag, None, None
    return (diag, torch.stack([x + x.T for x in lifts]),
            torch.stack([x - x.T for x in lifts]))


def _dense_collapse(collapse: CollapseOps, n: int, d: int):
    """(L, G): the lifted (M, dim, dim) collapse operators and G = sum_m
    L_m^+ L_m (dim, dim), or (None, None)."""
    L = _lifted_collapse(collapse, n, d)
    if L is None:
        return None, None
    g_re = _einsum("mca,mcb->ab", L.re, L.re) + _einsum("mca,mcb->ab", L.im, L.im)
    g_im = _einsum("mca,mcb->ab", L.re, L.im) - _einsum("mca,mcb->ab", L.im, L.re)
    return L, Cplx(g_re, g_im)


def _make_me_step_dense(ham, collapse, n, d, solver, substeps):
    diag, Sym, Asym = _dense_h_stacks(ham)
    L, G = _dense_collapse(collapse, n, d)

    def rhs(t, rho: Cplx) -> Cplx:
        zr, zc, zk = interp_streams(ham, t)
        h_re, h_im = diag, None
        if Sym is not None:
            x = torch.cat([z.re for z in (zr, zc, zk) if z is not None])
            y = torch.cat([z.im for z in (zr, zc, zk) if z is not None])
            h_re = h_re + _weighted_sum(x, Sym)
            h_im = _weighted_sum(y, Asym)
        # U = H rho;  -i[H, rho] = -i(U - U^H)
        u_re = _mm(h_re, rho.re)
        u_im = _mm(h_re, rho.im)
        if h_im is not None:
            u_re = u_re - _mm(h_im, rho.im)
            u_im = u_im + _mm(h_im, rho.re)
        out = Cplx(u_re - u_re.T, u_im + u_im.T).mul_neg_i()
        if L is not None:
            # drift: W = G rho; -(W + W^H) / 2
            w_re = _mm(G.re, rho.re) - _mm(G.im, rho.im)
            w_im = _mm(G.re, rho.im) + _mm(G.im, rho.re)
            out = out - Cplx(w_re + w_re.T, w_im - w_im.T) * 0.5
            # jumps: T = L rho (batched), sum_m T_m L_m^+
            t_re = _einsum("mab,bc->mac", L.re, rho.re) - _einsum("mab,bc->mac", L.im, rho.im)
            t_im = _einsum("mab,bc->mac", L.re, rho.im) + _einsum("mab,bc->mac", L.im, rho.re)
            j_re = _einsum("mac,mbc->ab", t_re, L.re) + _einsum("mac,mbc->ab", t_im, L.im)
            j_im = _einsum("mac,mbc->ab", t_im, L.re) - _einsum("mac,mbc->ab", t_re, L.im)
            out = out + Cplx(j_re, j_im)
        return out

    return _rk_step_fn(rhs, *_tableau_of(solver), substeps)


_ME_FORMS = {
    "superop": _make_me_step_superop,
    "dense": _make_me_step_dense,
    "factored": _make_me_step,
}


def me_form_for(dim: int, superop: Optional[bool] = None, me_form: Optional[str] = None) -> str:
    """The right-hand side's form: ``me_form`` if given, else the legacy
    ``superop`` (True: superop, False: factored), else by dim: superop up
    to ``_SUPEROP_DIM_CAP``, dense up to ``_DENSE_ME_DIM_CAP``, factored
    above."""
    if me_form is not None:
        if me_form not in _ME_FORMS:
            raise ValueError(f"me_form must be one of {sorted(_ME_FORMS)}, got {me_form!r}")
        return me_form
    if superop is not None:
        return "superop" if superop else "factored"
    if dim <= _SUPEROP_DIM_CAP:
        return "superop"
    return "dense" if dim <= _DENSE_ME_DIM_CAP else "factored"

# f32 solver modes -> the stepper they run
_F32_SOLVERS = {
    SolverType.DP5_SE_F32: SolverType.DP5_SE,
    SolverType.RK4_SE_F32: SolverType.RK4_SE,
    SolverType.KRYLOV_SE_F32: SolverType.KRYLOV_SE,
}
_F32_ME_SOLVERS = {
    SolverType.DP5_ME_F32: SolverType.DP5_ME,
    SolverType.RK4_ME_F32: SolverType.RK4_ME,
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
    krylov_dim: int = 12,
    krylov_tol: float = 1e-12,
    rtol: float = 1e-8,
    atol: float = 1e-10,
    max_iters: int = 256,
    remat: Optional[bool] = None,
    n_segments: Optional[int] = None,
) -> Cplx:
    """Integrate i dpsi/dt = H(t) psi.

    psi0: Cplx (nb, da, db).  Returns (n_eval, nb, da, db), in f64, or in
    f32 for ``DP5_SE_F32`` / ``RK4_SE_F32`` / ``KRYLOV_SE_F32``: the
    Hamiltonian, psi0 and the grid times cast to f32 (so the stream sample
    index is taken in f32, as the JAX package takes it) and the f64 modes'
    stepper run on them, every product at full f32 precision; the Krylov
    breakdown threshold is then raised to at least 1e-7 (below it the f32
    threshold would never fire).  ``krylov_dim`` / ``krylov_tol``: the
    Lanczos subspace and breakdown threshold of ``KRYLOV_SE``; ``rtol`` /
    ``atol`` / ``max_iters``: the error control and attempt cap of
    ``DP5_SE_ADAPTIVE``.  ``remat`` / ``n_segments``: checkpointed
    integration (``_integrate``); None decides from the state's bytes
    (``_auto_remat``, ``_auto_segments``).  Under ``torch.export`` the
    loop is one call of ``stepper_op.run_stepper``, which keeps one state
    per interval (or per segment) for its adjoint.
    """
    if solver in _F32_SOLVERS:
        f32 = torch.float32
        grid32 = TimeGrid(times=grid.times.to(f32), write_slots=grid.write_slots,
                          n_eval=grid.n_eval)
        return sesolve(_cast_ham(ham, f32), psi0.to(f32), grid32, _F32_SOLVERS[solver],
                       substeps, krylov_dim, max(krylov_tol, 1e-7), rtol, atol, max_iters,
                       remat, n_segments)
    n_steps = grid.times.shape[0] * substeps
    if remat is None:
        remat = _auto_remat(psi0, n_steps)
    if n_segments is None:
        n_segments = _auto_segments(psi0, n_steps)
    if torch.compiler.is_exporting():
        from pulser_diff_torch.solvers.stepper_op import run_stepper

        return run_stepper("se", solver, ham, psi0, grid, substeps, n_segments,
                           krylov_dim=krylov_dim, krylov_tol=krylov_tol, rtol=rtol, atol=atol,
                           max_iters=max_iters)
    step = _make_se_step(ham, solver, substeps, krylov_dim, krylov_tol, rtol, atol, max_iters)
    return _integrate(step, psi0, grid, remat, n_segments)


def mesolve(
    ham: FactoredHamiltonian,
    rho0: Cplx,
    collapse: CollapseOps,
    n_qudits: int,
    qudit_dim: int,
    grid: TimeGrid,
    solver: str = SolverType.DP5_ME,
    substeps: int = 1,
    remat: Optional[bool] = None,
    n_segments: Optional[int] = None,
    superop: Optional[bool] = None,
    me_form: Optional[str] = None,
) -> Cplx:
    """Integrate the Lindblad master equation.

    rho0: Cplx (dim, dim).  Returns (n_eval, dim, dim).  The form of the
    right-hand side follows ``me_form_for`` (``me_form`` in {"superop",
    "dense", "factored"} forces one; the legacy ``superop=True/False``
    forces superop / factored).  ``remat`` / ``n_segments`` as in
    :func:`sesolve`; None decides by ``_me_auto_remat`` (what a stage
    materializes) and ``_auto_segments``.  ``DP5_ME_F32`` / ``RK4_ME_F32``
    run the same forms on f32 copies of the Hamiltonian, rho0, the
    collapse operators and the grid times, every product at full f32
    precision, forward and backward.  Under ``torch.export`` the loop is
    one call of ``stepper_op.run_stepper``, as in :func:`sesolve`.
    """
    if solver in _F32_ME_SOLVERS:
        f32 = torch.float32
        col32 = collapse._replace(ops=None if collapse.ops is None else collapse.ops.to(f32))
        grid32 = TimeGrid(times=grid.times.to(f32), write_slots=grid.write_slots,
                          n_eval=grid.n_eval)
        return mesolve(_cast_ham(ham, f32), rho0.to(f32), col32, n_qudits, qudit_dim, grid32,
                       _F32_ME_SOLVERS[solver], substeps, remat, n_segments, superop, me_form)
    if solver not in (SolverType.DP5_ME, SolverType.RK4_ME):
        raise ValueError(f"Unknown master-equation solver '{solver}'.")
    n_steps = grid.times.shape[0] * substeps
    me_form = me_form_for(ham.dim, superop, me_form)
    if remat is None:
        remat = _me_auto_remat(me_form, ham.dim, rho0, n_steps)
    if n_segments is None:
        n_segments = _auto_segments(rho0, n_steps)
    if torch.compiler.is_exporting():
        from pulser_diff_torch.solvers.stepper_op import run_stepper

        return run_stepper("me", solver, ham, rho0, grid, substeps, n_segments,
                           collapse=collapse, n=n_qudits, d=qudit_dim, form=me_form)
    step = _ME_FORMS[me_form](ham, collapse, n_qudits, qudit_dim, solver, substeps)
    return _integrate(step, rho0, grid, remat, n_segments)

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
pinned products.  Krylov and adaptive forms are later slices.
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
from pulser_diff_torch.hamiltonian import CollapseOps
from pulser_diff_torch.ops.apply import (
    FactoredHamiltonian, _einsum, _mm, _weighted_sum, apply_local_left, apply_local_right,
    ceinsum, h_apply_batched, h_apply_rho_left, interp_streams,
)


class SolverType:
    """Solver identifiers (the subset ported so far)."""

    DP5_SE = "DP5_SE"
    RK4_SE = "RK4_SE"
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
            times=torch.as_tensor(merged[perm], dtype=DTYPE, device=device),
            write_slots=src_slot[perm],
            n_eval=n_eval,
            sampling_times=torch.as_tensor(s_np, dtype=DTYPE, device=device),
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
                           torch.as_tensor(eval_times, dtype=DTYPE).to(dev)])
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


def _make_se_step(ham: FactoredHamiltonian, solver: str, substeps: int):
    if solver not in (SolverType.DP5_SE, SolverType.RK4_SE):
        raise ValueError(f"Unknown statevector solver '{solver}'.")
    return _rk_step_fn(lambda t, p: _se_rhs(ham, t, p), *_tableau_of(solver), substeps)


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
    precision, forward and backward.
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
    step = _ME_FORMS[me_form](ham, collapse, n_qudits, qudit_dim, solver, substeps)
    return _integrate(step, rho0, grid, remat, n_segments)

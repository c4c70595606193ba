"""Quantum-jump (Monte-Carlo wavefunction) unraveling of the Lindblad
equation (counterpart of pulser_diff_tpu/solvers/mcwf.py).

The average over trajectories of |psi><psi| / ||psi||^2 reproduces
mesolve's rho(t), at the cost of R statevectors instead of one dim^2
density matrix:

  - between jumps the unnormalized state follows the non-Hermitian drift
    d psi/dt = -i H(t) psi - (1/2) (sum_k L_k^+ L_k) psi;
  - its squared norm is the no-jump survival probability: a jump fires
    at the end of a step where it fell below the trajectory's threshold
    r ~ U(0, 1);
  - at a jump, channel k is drawn with probability ||L_k psi||^2 / sum,
    the state becomes L_k psi / ||L_k psi|| and a fresh threshold is
    drawn.

As in the JAX package: the R trajectories are the state batch of the
factored Hamiltonian application, one jump at most a trajectory a step
(``substeps`` refines the steps), the channel weights come from per-site
reduced density matrices, and the selected jump applies one (d, d) site
matrix a trajectory.  The JAX package skips the jump arithmetic on steps
where no trajectory crossed (``lax.cond``); here it runs every step,
masked with ``torch.where`` (its states are those of the branched form),
so the step loop never waits for the device.  The uniforms come from a
``torch.Generator`` on the state's device (``draw_uniforms``), or from the
caller (``uniforms=``), which lets a test feed the JAX package's draws.

Under ``torch.export`` the uniforms are constants of the graph, as the
JAX package's key is under ``jax.jit``, and the step loop is one custom
op (``solvers/mcwf_op.py``), as the JAX package's ``lax.scan`` is one
loop; eagerly nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pulser_diff_torch.config import constant_under_export
from pulser_diff_torch.cplx import Cplx, cstack
from pulser_diff_torch.hamiltonian import CollapseOps
from pulser_diff_torch.ops.apply import FactoredHamiltonian, _einsum
from pulser_diff_torch.solvers.solver import (
    SolverType, TimeGrid, _auto_remat, _cast_ham, _explicit_rk_step, _group_collapse, _se_rhs,
    _tableau_of, sesolve,
)


# the smallest squared norm a normalization divides by, and the least
# total channel weight a jump needs
_TINY = float(np.finfo(np.float32).tiny)


class McwfResult(NamedTuple):
    states: Cplx  # (n_eval, R, da, db) normalized trajectory states
    n_jumps: torch.Tensor  # (R,) int32 jump count per trajectory


class Uniforms(NamedTuple):
    """The draws of one solve: u_sel (n_steps, R) picks a jump's channel,
    u_thr (n_steps, R) the threshold after it, thr0 (R,) the first."""

    u_sel: torch.Tensor
    u_thr: torch.Tensor
    thr0: torch.Tensor


def draw_uniforms(gen: torch.Generator, n_steps: int, n_traj: int,
                  dtype: torch.dtype) -> Uniforms:
    """The uniforms of a solve of ``n_steps`` steps and ``n_traj``
    trajectories, drawn on the generator's device (constants of the graph
    under ``torch.export``: ``constant_under_export``)."""
    dev = gen.device

    def draw(*shape: int) -> torch.Tensor:
        return constant_under_export(
            lambda: torch.rand(*shape, generator=gen, dtype=dtype, device=dev))

    return Uniforms(draw(n_steps, n_traj), draw(n_steps, n_traj), draw(n_traj))


def _site_view(psi: Cplx, site: int, n: int, d: int) -> tuple:
    """(R, lead, d, trail) views of a (R, da, db) batch's re and im."""
    lead = d**site
    shape = (psi.re.shape[0], lead, d, d**n // (lead * d))
    return psi.re.reshape(shape), psi.im.reshape(shape)


def _apply_site_ket(op: Cplx, site: int, n: int, d: int, psi: Cplx) -> Cplx:
    """lift(op, site) @ psi for a trajectory batch psi (R, da, db)."""
    x, y = _site_view(psi, site, n, d)
    out_re = _einsum("ji,rlit->rljt", op.re, x) - _einsum("ji,rlit->rljt", op.im, y)
    out_im = _einsum("ji,rlit->rljt", op.re, y) + _einsum("ji,rlit->rljt", op.im, x)
    return Cplx(out_re, out_im).reshape(psi.shape)


def _apply_site_ket_traj(op: Cplx, site: int, n: int, d: int, psi: Cplx) -> Cplx:
    """A per-trajectory site operator: op (R, d, d), psi (R, da, db)."""
    x, y = _site_view(psi, site, n, d)
    out_re = _einsum("rji,rlit->rljt", op.re, x) - _einsum("rji,rlit->rljt", op.im, y)
    out_im = _einsum("rji,rlit->rljt", op.re, y) + _einsum("rji,rlit->rljt", op.im, x)
    return Cplx(out_re, out_im).reshape(psi.shape)


def _site_rdm(site: int, n: int, d: int, psi: Cplx) -> Cplx:
    """The one-site reduced density matrices G[r, i, i'] = sum_env
    conj(psi)[.., i, ..] psi[.., i', ..] of a (R, da, db) batch."""
    x, y = _site_view(psi, site, n, d)
    g_re = _einsum("rlit,rljt->rij", x, x) + _einsum("rlit,rljt->rij", y, y)
    g_im = _einsum("rlit,rljt->rij", x, y) - _einsum("rlit,rljt->rij", y, x)
    return Cplx(g_re, g_im)


def _q_carries_grad(groups: list) -> bool:
    return any(Q.re.requires_grad or Q.im.requires_grad for _s, _L, Q in groups)


def _diag_q_sum(groups: list, n: int, d: int, state_shape, dtype) -> Optional[torch.Tensor]:
    """sum_site lift(Q_site) as a (da, db) diagonal when every site's Q =
    sum_m L^+ L is diagonal (dephasing, relaxation, depolarizing), else
    None.  It reads Q on the host; the caller takes the general path
    instead when Q carries a gradient (``_q_carries_grad``): a constant
    diagonal would drop it (the JAX package takes the general path for
    traced Q)."""
    if not groups:
        return None
    full = np.zeros([d] * n) if n > 1 else np.zeros([d])
    for site, _L, Q in groups:
        qre = Q.re.detach().cpu().numpy().astype(np.float64)
        qim = Q.im.detach().cpu().numpy().astype(np.float64)
        if np.abs(qre - np.diag(np.diag(qre))).max() > 1e-12 or np.abs(qim).max() > 1e-12:
            return None
        shape = [1] * n
        shape[site] = d
        full = full + np.diag(qre).reshape(shape)
    return torch.as_tensor(full.reshape(state_shape), dtype=dtype, device=Q.re.device)


def _norm2(psi: Cplx) -> torch.Tensor:
    """(R,) squared norms of a (R, da, db) batch."""
    return (psi.re**2 + psi.im**2).sum(dim=tuple(range(1, psi.re.ndim)))


def _per_traj(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (R,) vector shaped to broadcast against a (R, ...) batch."""
    return v.reshape((v.shape[0],) + (1,) * (like.ndim - 1))


def _drift_step(ham: FactoredHamiltonian, groups: list, n: int, d: int,
                qdiag: Optional[torch.Tensor], c, A, B):
    """step(re, im, t0, t1) -> (re, im): one explicit Runge-Kutta step of
    the non-Hermitian drift -i H psi - (1/2) sum_site lift(Q_site) psi, the
    anti-Hermitian part as the elementwise ``qdiag`` where it is given
    (``_diag_q_sum``), else site by site."""
    if qdiag is not None:
        half_q = qdiag * 0.5

        def drift_rhs(t, p):
            out = _se_rhs(ham, t, p)
            return Cplx(out.re - half_q * p.re, out.im - half_q * p.im)
    else:
        def drift_rhs(t, p):
            out = _se_rhs(ham, t, p)
            for site, _L, Q in groups:
                out = out - _apply_site_ket(Q, site, n, d, p) * 0.5
            return out

    def drift_step(re, im, t0, t1):
        return tuple(_explicit_rk_step(drift_rhs, t0, t1 - t0, Cplx(re, im), c, A, B))

    return drift_step


def _normalized(p: Cplx, tiny: float) -> Cplx:
    nrm = _per_traj(torch.sqrt(torch.clamp(_norm2(p), min=tiny)), p.re)
    return Cplx(p.re / nrm, p.im / nrm)


def _apply_jumps(groups: list, n: int, d: int, M: int, p: Cplx, thr: torch.Tensor,
                 nj: torch.Tensor, crossed: torch.Tensor, us: torch.Tensor, ut: torch.Tensor,
                 tiny: float):
    """One step's jumps: the channel weights ||L_m p||^2 = tr(L^+ L G_site),
    the categorical draw by ``us``, the jump applied and the threshold
    redrawn from ``ut`` for the trajectories that crossed (and have a
    nonzero weight); every other trajectory keeps its state, threshold and
    count exactly."""
    ws = []
    for site, L, _Q in groups:
        G = _site_rdm(site, n, d, p)  # (R, d, d)
        # P_m = L_m^+ L_m; w[m, r] = Re sum_ik P_m[i, k] G[r, i, k]
        p_re = _einsum("mji,mjk->mik", L.re, L.re) + _einsum("mji,mjk->mik", L.im, L.im)
        p_im = _einsum("mji,mjk->mik", L.re, L.im) - _einsum("mji,mjk->mik", L.im, L.re)
        ws.append(_einsum("mik,rik->mr", p_re, G.re) - _einsum("mik,rik->mr", p_im, G.im))
    w = torch.clamp(torch.cat(ws, 0), min=0.0)  # (M, R)
    tot = w.sum(0)
    jumped = crossed & (tot > tiny)
    cum = torch.cumsum(w, 0)
    # an ulp of rounding can put us * tot past cum[-1]: clip to the last
    # channel, as the JAX package does, so no trajectory selects nothing
    kstar = torch.clamp((cum < (us * tot)[None, :]).sum(0), max=M - 1)
    onehot = (torch.arange(M, device=kstar.device)[:, None] == kstar[None, :]).to(p.re.dtype)
    pj = None
    off = 0
    for site, L, _Q in groups:
        m = L.re.shape[0]
        sel = onehot[off:off + m]  # (m, R)
        op = Cplx(_einsum("mr,mij->rij", sel, L.re), _einsum("mr,mij->rij", sel, L.im))
        contrib = _apply_site_ket_traj(op, site, n, d, p)
        pj = contrib if pj is None else pj + contrib
        off += m
    scale = _per_traj(1.0 / torch.sqrt(torch.clamp(_norm2(pj), min=tiny)), pj.re)
    jb = _per_traj(jumped, p.re)
    p = Cplx(torch.where(jb, pj.re * scale, p.re), torch.where(jb, pj.im * scale, p.im))
    return p, torch.where(jumped, ut, thr), nj + jumped.to(torch.int32)


def _mc_step(drift_step, groups: list, n: int, d: int, M: int, tiny: float, p: Cplx,
             thr: torch.Tensor, nj: torch.Tensor, t0, t1, us: torch.Tensor, ut: torch.Tensor,
             remat: bool = False):
    """One step of the trajectories over [t0, t1]: the drift (checkpointed
    with ``remat``), then the jumps of those whose squared norm fell below
    their threshold; (p, thr, nj) after it."""
    if remat:
        p = Cplx(*checkpoint(drift_step, p.re, p.im, t0, t1, use_reentrant=False))
    else:
        p = Cplx(*drift_step(p.re, p.im, t0, t1))
    crossed = _norm2(p) < thr
    return _apply_jumps(groups, n, d, M, p, thr, nj, crossed, us, ut, tiny)


def mcsolve(
    ham: FactoredHamiltonian,
    psi0: Cplx,
    collapse: CollapseOps,
    n_qudits: int,
    qudit_dim: int,
    grid: TimeGrid,
    gen: Optional[torch.Generator],
    n_traj: int,
    solver: str = SolverType.DP5_SE,
    substeps: int = 1,
    remat: Optional[bool] = None,
    *,
    uniforms: Optional[Uniforms] = None,
) -> McwfResult:
    """Integrate the Lindblad equation by ``n_traj`` quantum-jump
    trajectories.

    Differentiable as the JAX package's is (a fixed-realization pathwise
    estimator): with fixed uniforms, autograd flows through the drift, the
    jump applications and the normalizations, while the discrete decisions
    (threshold crossings, channel draws) stay constant, so it misses the
    dependence of the jump statistics on the parameters.  ``remat``
    checkpoints each step (by default above the residual budget).

    Args:
        psi0: Cplx (da, db), shared by all trajectories, or (R, da, db)
            with R == n_traj.
        collapse: the site-local sqrt(rate)-scaled jump operators.
        gen: draws the uniforms (``draw_uniforms``) unless ``uniforms`` is
            given; a generator seeded alike gives the same trajectories.
        solver: DP5_SE / RK4_SE stages for the drift; the *_F32 modes run
            the solve in f32 with every product at full f32 precision.
        uniforms: the draws (u_sel, u_thr, thr0) of the refined grid's
            steps, in the state's dtype.

    Returns:
        McwfResult(states (n_eval, R, da, db) normalized, n_jumps (R,)).
    """
    f32_alias = {SolverType.DP5_SE_F32: SolverType.DP5_SE,
                 SolverType.RK4_SE_F32: SolverType.RK4_SE}
    if solver in f32_alias:
        f32 = torch.float32
        col32 = collapse._replace(ops=None if collapse.ops is None else collapse.ops.to(f32))
        grid32 = TimeGrid(times=grid.times.to(f32), write_slots=grid.write_slots,
                          n_eval=grid.n_eval)
        u32 = None if uniforms is None else Uniforms(*(u.to(f32) for u in uniforms))
        return mcsolve(_cast_ham(ham, f32), psi0.to(f32), col32, n_qudits, qudit_dim, grid32,
                       gen, n_traj, f32_alias[solver], substeps, remat, uniforms=u32)
    if solver not in (SolverType.DP5_SE, SolverType.RK4_SE):
        raise ValueError(f"mcsolve drift solver must be DP5_SE/RK4_SE(_F32), got '{solver}'.")
    c, A, B = _tableau_of(solver)

    n, d, R = n_qudits, qudit_dim, int(n_traj)
    dtype = psi0.re.dtype
    groups = _group_collapse(collapse, n, d)
    if psi0.re.ndim == 2:
        psi = Cplx(psi0.re.expand((R,) + psi0.re.shape), psi0.im.expand((R,) + psi0.im.shape))
    else:
        if psi0.re.shape[0] != R:
            raise ValueError(f"psi0 leading axis {psi0.re.shape[0]} != n_traj {R}.")
        psi = psi0
    if not groups:
        # no jump channels: norm-preserving Schrodinger trajectories
        states = sesolve(ham, psi, grid, solver=solver, substeps=substeps)
        return McwfResult(states, torch.zeros(R, dtype=torch.int32, device=psi.re.device))

    g = grid.refined(substeps)
    times = g.times
    n_steps = times.shape[0] - 1
    M = sum(L.re.shape[0] for _, L, _ in groups)
    if uniforms is None:
        uniforms = draw_uniforms(gen, n_steps, R, dtype)
    u_sel, u_thr, thr = (u.to(device=psi.re.device, dtype=dtype) for u in uniforms)
    if u_sel.shape != (n_steps, R) or thr.shape != (R,):
        raise ValueError(f"uniforms of shapes {tuple(u_sel.shape)} / {tuple(thr.shape)} for "
                         f"{n_steps} steps of {R} trajectories.")
    tiny = _TINY
    if remat is None:
        remat = _auto_remat(psi, n_steps, stages=len(c))
    if torch.compiler.is_exporting():
        from pulser_diff_torch.solvers.mcwf_op import run_mcwf

        return run_mcwf(solver, ham, psi, collapse, n, d, g, Uniforms(u_sel, u_thr, thr), remat,
                        _q_carries_grad(groups))

    # the anti-Hermitian drift -(1/2) sum_site lift(Q_site): one (da, db)
    # elementwise diagonal when every Q is diagonal
    qdiag = None if _q_carries_grad(groups) else _diag_q_sum(groups, n, d, psi.re.shape[1:],
                                                             dtype)
    drift_step = _drift_step(ham, groups, n, d, qdiag, c, A, B)
    n_eval = g.n_eval
    out: list = [None] * n_eval
    slots = [int(s_) for s_ in g.write_slots]
    if slots[0] < n_eval:
        out[slots[0]] = _normalized(psi, tiny)
    p = psi
    nj = torch.zeros(R, dtype=torch.int32, device=psi.re.device)
    for k in range(n_steps):
        p, thr, nj = _mc_step(drift_step, groups, n, d, M, tiny, p, thr, nj, times[k],
                              times[k + 1], u_sel[k], u_thr[k], remat)
        if slots[k + 1] < n_eval:
            out[slots[k + 1]] = _normalized(p, tiny)
    return McwfResult(cstack(out), nj)

"""MCWF's trajectory loop as one custom op under ``torch.export``.

Eagerly ``mcsolve`` runs its steps as a Python loop, which autograd
differentiates.  Under export (``torch.compiler.is_exporting()``) it
calls :func:`run_mcwf` instead: the loop becomes one op,
``pulser_diff_torch::mcwf_states``, and its adjoint a second,
``pulser_diff_torch::mcwf_states_bwd``, so the exported graph, and the time
to export it, do not grow with the steps (as the JAX package's
``lax.scan`` stays one loop).  It follows ``solvers/stepper_op.py``:

- The loop carries three things a step: the unnormalized states ``p``,
  the thresholds ``thr`` and the jump counts ``nj``.  The forward op runs
  the eager step (``mcwf._mc_step``: the drift, then the jumps) on its
  tensors, so its states and jump counts are the eager ones bit for bit.
  Beside the normalized slot states and the jump counts it returns the
  start carry of every step, or of every run of ``seg_len`` steps when
  ``_auto_remat`` asks for checkpointing (sqrt-checkpointing then).
- The backward op sweeps the steps in reverse, with the steppers'
  driver (``stepper_op._reverse_sweep``), and the autograd rule is
  theirs (``stepper_op._register_loop_autograd``).  On each step it takes
  ``torch.func.vjp`` of the drift and the jump application together, from
  the step's start carry, and adds the cotangent of the step's slot
  through its normalization; inside a run of steps it first recomputes
  their carries.  The discrete decisions (which trajectories crossed,
  the channel each one took) come out as in the forward op, since their
  inputs are the same bit for bit: the adjoint is the eager
  fixed-realization estimator's, differentiated through the drift, the
  jumps and the normalizations, as the JAX package's is.  The uniforms
  get a zero cotangent (the eager states depend on them only through
  those decisions).
- The host read that picks the elementwise drift (``_diag_q_sum``) runs
  inside the op body, where the collapse operators are real; the trace
  passes whether they carry a gradient (then the general drift).

Each op takes its tensors as one list and their keys as one comma-joined
string, its static configuration as one JSON string, and serves every
device type with one implementation: the trajectories are plain torch
ops, no kernel of their own.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pulser_diff_torch.cplx import Cplx, cstack
from pulser_diff_torch.hamiltonian import CollapseOps
from pulser_diff_torch.ops.apply import _f32_full_precision
from pulser_diff_torch.ops.fused_evolution import _data_of
from pulser_diff_torch.solvers.mcwf import (
    _TINY, McwfResult, Uniforms, _diag_q_sum, _drift_step, _mc_step, _normalized,
)
from pulser_diff_torch.solvers.solver import _group_collapse, _tableau_of
from pulser_diff_torch.solvers.stepper_op import (
    _ham_of, _n_kept, _op_args, _register_loop_autograd, _reverse_sweep,
)

_UNIFORM_KEYS = ("u_sel", "u_thr", "thr0")
# the keys whose cotangents the sweep carries itself (the state's, the
# grid times'), or that have none (the uniforms')
_OWN_KEYS = ("psi_re", "psi_im", "times") + _UNIFORM_KEYS


def _groups_of(cfg: dict, data: dict) -> list:
    collapse = CollapseOps(tuple(cfg["sites"]), Cplx(data["col_re"], data["col_im"]))
    return _group_collapse(collapse, cfg["n"], cfg["d"])


def _qdiag(cfg: dict, data: dict):
    """The elementwise drift's diagonal, read on the host once a call, or
    None for the general drift (the collapse operators carry a gradient,
    or some Q is not diagonal)."""
    if cfg["q_grad"]:
        return None
    return _diag_q_sum(_groups_of(cfg, data), cfg["n"], cfg["d"], data["psi_re"].shape[1:],
                       data["psi_re"].dtype)


def _stepper(cfg: dict, data: dict, qdiag):
    """step(p, thr, nj, t0, t1, k) -> (p, thr, nj): step k of the eager
    loop, built from ``data``."""
    groups = _groups_of(cfg, data)
    n, d = cfg["n"], cfg["d"]
    drift = _drift_step(_ham_of(cfg, data), groups, n, d, qdiag, *_tableau_of(cfg["solver"]))
    M = sum(L.re.shape[0] for _, L, _ in groups)
    u_sel, u_thr = data["u_sel"], data["u_thr"]

    def step(p: Cplx, thr, nj, t0, t1, k: int):
        return _mc_step(drift, groups, n, d, M, _TINY, p, thr, nj, t0, t1, u_sel[k], u_thr[k])

    return step


def _forward(cfg: dict, slots: list, data: dict) -> list:
    """[slot states re, im, n_jumps, kept carries p re, p im, thr, nj]."""
    step = _stepper(cfg, data, _qdiag(cfg, data))
    t, n_eval, seg_len = data["times"], cfg["n_eval"], cfg["seg_len"]
    n_steps = t.shape[0] - 1
    p, thr = Cplx(data["psi_re"], data["psi_im"]), data["thr0"]
    nj = torch.zeros(thr.shape, dtype=torch.int32, device=thr.device)
    out: list = [None] * n_eval
    if slots[0] < n_eval:
        out[slots[0]] = _normalized(p, _TINY)
    kept = []
    for k0 in range(0, n_steps, seg_len):
        kept.append((p, thr, nj))
        for k in range(k0, min(k0 + seg_len, n_steps)):
            p, thr, nj = step(p, thr, nj, t[k], t[k + 1], k)
            if slots[k + 1] < n_eval:
                out[slots[k + 1]] = _normalized(p, _TINY)
    states = cstack(out)
    carries = [torch.stack([c[0].re for c in kept]), torch.stack([c[0].im for c in kept]),
               torch.stack([c[1] for c in kept]), torch.stack([c[2] for c in kept])]
    return [states.re, states.im, nj.clone(), *carries]


def _backward(cfg: dict, slots: list, want: list, kept: list, g_re, g_im, data: dict) -> list:
    """The cotangents of the ``want`` keys, from the kept carries ``kept``
    = [p re, p im, thr, nj]: ``stepper_op._reverse_sweep`` over the steps,
    each step's outputs its end state and, where a slot reads it, that
    state normalized."""
    t, n_eval = data["times"], cfg["n_eval"]
    kp_re, kp_im, k_thr, k_nj = kept
    qdiag = _qdiag(cfg, data)
    step = _stepper(cfg, data, qdiag)

    def local(k, carry, lam):
        p, thr, nj = carry
        written = slots[k + 1] < n_eval
        cot = (lam.re, lam.im)
        if written:
            cot += (g_re[slots[k + 1]], g_im[slots[k + 1]])

        def f(sub, re, im, t0, t1):
            fn = _stepper(cfg, {**data, **sub}, qdiag) if sub else step
            p1 = fn(Cplx(re, im), thr, nj, t0, t1, k)[0]
            if not written:
                return p1.re, p1.im
            q = _normalized(p1, _TINY)
            return p1.re, p1.im, q.re, q.im

        return p, f, cot

    lam, found = _reverse_sweep(data, want, _OWN_KEYS, cfg["seg_len"],
                                lambda i: (Cplx(kp_re[i], kp_im[i]), k_thr[i], k_nj[i]),
                                lambda c, k: step(*c, t[k], t[k + 1], k), local)
    if slots[0] < n_eval:
        def norm0(re, im):
            q = _normalized(Cplx(re, im), _TINY)
            return q.re, q.im

        _, vjp_fn = torch.func.vjp(norm0, data["psi_re"], data["psi_im"])
        c_re, c_im = vjp_fn((g_re[slots[0]], g_im[slots[0]]))
        lam = Cplx(lam.re + c_re, lam.im + c_im)
    found.update(psi_re=lam.re, psi_im=lam.im,
                 **{k: torch.zeros_like(data[k]) for k in _UNIFORM_KEYS})
    # fresh tensors: an op's output may not alias its inputs
    return [found[k].clone() for k in want]


@torch.library.custom_op("pulser_diff_torch::mcwf_states", mutates_args=())
def _mcwf_op(cfg: str, slots: torch.Tensor, keys: str,
             tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """MCWF's step loop (see the module docstring)."""
    with _f32_full_precision(whole=True):
        return _forward(json.loads(cfg), slots.tolist(), _data_of(keys, tensors))


@_mcwf_op.register_fake
def _(cfg, slots, keys, tensors):
    c, data = json.loads(cfg), _data_of(keys, tensors)
    psi, thr = data["psi_re"], data["thr0"]
    n_kept = _n_kept(data["times"].shape[0] - 1, c["seg_len"])
    return [psi.new_empty((c["n_eval"], *psi.shape)), psi.new_empty((c["n_eval"], *psi.shape)),
            thr.new_empty(thr.shape, dtype=torch.int32),
            psi.new_empty((n_kept, *psi.shape)), psi.new_empty((n_kept, *psi.shape)),
            thr.new_empty((n_kept, *thr.shape)),
            thr.new_empty((n_kept, *thr.shape), dtype=torch.int32)]


@torch.library.custom_op("pulser_diff_torch::mcwf_states_bwd", mutates_args=())
def _mcwf_bwd_op(cfg: str, slots: torch.Tensor, keys: str, want: str,
                 kept: list[torch.Tensor], g_re: torch.Tensor, g_im: torch.Tensor,
                 tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The adjoint of ``mcwf_states`` for the slot cotangents ``g``, from
    its kept carries (p re, p im, thr, nj): the cotangents of the ``want``
    keys, in that order."""
    with _f32_full_precision(whole=True):
        return _backward(json.loads(cfg), slots.tolist(), want.split(","), kept, g_re, g_im,
                         _data_of(keys, tensors))


_register_loop_autograd(_mcwf_op, _mcwf_bwd_op, 3)


def _mcwf_args(solver: str, ham, psi: Cplx, collapse: CollapseOps, n: int, d: int, grid,
               uniforms: Uniforms, remat: bool, q_grad: bool) -> tuple:
    """The arguments of ``mcwf_states`` (cfg, slots, keys, tensors) for a
    solve as :func:`run_mcwf` takes it."""
    n_steps = grid.times.shape[0] - 1
    n_segments = max(2, int(np.ceil(np.sqrt(n_steps)))) if remat else None
    cfg, slots, keys, tensors = _op_args("mc", solver, ham, psi, grid, 1, n_segments,
                                         collapse=collapse, n=n, d=d)
    cfg = json.dumps({**json.loads(cfg), "q_grad": bool(q_grad)})
    return cfg, slots, ",".join([keys, *_UNIFORM_KEYS]), [*tensors, *uniforms]


def run_mcwf(*args) -> McwfResult:
    """``mcsolve``'s loop over the refined grid (DP5_SE / RK4_SE drift,
    the states (R, da, db), the uniforms in their dtype) as one call of
    ``mcwf_states``: the normalized states at the grid's evaluation slots,
    differentiable through ``mcwf_states_bwd``, and the jump counts.  The
    arguments are :func:`_mcwf_args`': ``remat`` keeps one carry every
    ~sqrt(steps) steps instead of every step; ``q_grad`` says the collapse
    operators carry a gradient."""
    outs = _mcwf_op(*_mcwf_args(*args))
    return McwfResult(Cplx(outs[0], outs[1]), outs[2])

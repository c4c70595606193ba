"""The steppers' loop as one custom op under ``torch.export``.

Eagerly ``sesolve`` and ``mesolve`` integrate with a Python loop over the
grid intervals, which autograd differentiates.  A ``torch.export`` trace
would record every op of every stage of every step, so under export
(``torch.compiler.is_exporting()``) they call :func:`run_stepper`
instead: the loop becomes one op, ``pulser_diff_torch::stepper_states``,
and its adjoint a second, ``pulser_diff_torch::stepper_states_bwd``, so
the exported graph, and the time to export it, no longer grow with the
steps (as the JAX package's ``lax.scan`` stays one loop).

- The forward op builds the eager path's step (``_make_se_step`` or the
  master equation's form) from its tensors and runs ``_run_steps`` on
  them: its states are the eager states bit for bit.  Beside the slot
  states it returns the start state of every grid interval, or of every
  run of ``seg_len`` intervals when ``_auto_segments`` (or
  ``n_segments``) asks for sqrt-checkpointing.
- The backward op sweeps the intervals in reverse: it adds each written
  slot's cotangent to the state's, and on each interval takes
  ``torch.func.vjp`` of the step as a function of the start state, the
  interval's ends and the tensors whose cotangents are wanted; inside a
  run of intervals it first recomputes their start states.  Autograd sits
  above a custom op's implementation in the dispatcher and records
  nothing inside it, so the op body differentiates with ``torch.func``
  and never with ``torch.autograd.grad``.

Each op takes its tensors as one list and their keys as one comma-joined
string, its static configuration as one JSON string (an op schema holds
no dict), and serves every device type with one implementation: the
steppers are plain torch ops, no kernel of their own.  The reverse sweep
(:func:`_reverse_sweep`) and the autograd rule
(:func:`_register_loop_autograd`) serve MCWF's loop op too
(``solvers/mcwf_op.py``), whose carry is more than the state.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from pulser_diff_torch.cplx import Cplx, cstack
from pulser_diff_torch.hamiltonian import CollapseOps
from pulser_diff_torch.ops.apply import _f32_full_precision
from pulser_diff_torch.ops.fused_evolution import _data_of, _save_states, _saved
from pulser_diff_torch.solvers.solver import (
    _ME_FORMS, _make_se_step, _rebuild_ham, _run_steps,
)

# the Hamiltonian's differentiable tensors, in ``_rebuild_ham``'s order
_STREAM_KEYS = ("rs_re", "rs_im", "cs_re", "cs_im", "int_diag", "kron_row", "kron_col",
                "ks_re", "ks_im")
# the keys whose cotangents the sweep carries itself (the state's, the
# grid times'), not through the step's tensors
_STATE_KEYS = ("psi_re", "psi_im", "times")


def _inputs(ham, y0: Cplx, times: torch.Tensor, collapse: Optional[CollapseOps]) -> dict:
    """Every tensor of a solve by key, the absent ones (no kron pairs, no
    collapse operator) left out; the sample spacing only where it is a
    tensor (the f32 modes)."""
    ks = ham.kron_streams
    data = {
        "psi_re": y0.re, "psi_im": y0.im, "times": times,
        "row_parts": ham.row_parts, "col_parts": ham.col_parts,
        "rs_re": ham.row_streams.re, "rs_im": ham.row_streams.im,
        "cs_re": ham.col_streams.re, "cs_im": ham.col_streams.im,
        "int_diag": ham.int_diag, "kron_row": ham.kron_row, "kron_col": ham.kron_col,
        "ks_re": None if ks is None else ks.re, "ks_im": None if ks is None else ks.im,
        "sample_dt": ham.sample_dt if isinstance(ham.sample_dt, torch.Tensor) else None,
    }
    if collapse is not None and collapse.ops is not None:
        data["col_re"], data["col_im"] = collapse.ops.re, collapse.ops.im
    return {k: v for k, v in data.items() if v is not None}


def _ham_of(cfg: dict, data: dict):
    """The factored Hamiltonian of a solve, rebuilt from ``data``."""
    parts = (data["row_parts"], data["col_parts"], data.get("sample_dt", cfg["sample_dt"]))
    return _rebuild_ham(parts, tuple(data.get(k) for k in _STREAM_KEYS), cfg["n_samples"])


def _step_of(cfg: dict, data: dict):
    """step(y, t0, t1) of the eager path, built from ``data``."""
    ham = _ham_of(cfg, data)
    if cfg["kind"] == "se":
        return _make_se_step(ham, cfg["solver"], cfg["substeps"], cfg["krylov_dim"],
                             cfg["krylov_tol"], cfg["rtol"], cfg["atol"], cfg["max_iters"])
    ops = Cplx(data["col_re"], data["col_im"]) if "col_re" in data else None
    collapse = CollapseOps(tuple(cfg["sites"]), ops)
    return _ME_FORMS[cfg["form"]](ham, collapse, cfg["n"], cfg["d"], cfg["solver"],
                                  cfg["substeps"])


def _n_kept(n_steps: int, seg_len: int) -> int:
    return -(-n_steps // seg_len)


def _forward(cfg: dict, slots: list, data: dict) -> list:
    """[slot states re, im, kept start states re, im]."""
    step = _step_of(cfg, data)
    y = Cplx(data["psi_re"], data["psi_im"])
    t, n_eval, seg_len = data["times"], cfg["n_eval"], cfg["seg_len"]
    n_steps = t.shape[0] - 1
    out: list = [None] * n_eval
    if slots[0] < n_eval:
        out[slots[0]] = y
    kept = []
    for k0 in range(0, n_steps, seg_len):
        kept.append(y)
        y, writes = _run_steps(step, y, t, slots, n_eval, k0, min(k0 + seg_len, n_steps))
        for slot, state in writes:
            out[slot] = state
    states = cstack(out)
    if not kept:
        empty = y.re.new_empty((0, *y.re.shape))
        return [states.re, states.im, empty, empty.clone()]
    starts = cstack(kept)
    return [states.re, states.im, starts.re, starts.im]


def _reverse_sweep(data: dict, want: list, own: tuple, seg_len: int, start, advance,
                   local) -> tuple:
    """A reverse sweep of ``torch.func.vjp`` over the grid intervals, run by
    run of ``seg_len`` steps: the state's cotangent at the first step, and
    the cotangents of the grid times and of the ``want`` keys not in
    ``own`` (those the caller carries itself), by key.

    ``start(i)`` is run i's kept start carry, ``advance(carry, k)`` the
    carry after step k (the carries inside a run are recomputed from its
    start), and ``local(k, carry, lam)`` gives step k as (y, f, cot): its
    start state y, ``f(sub, re, im, t0, t1)`` its outputs as a function of
    that state, the interval's ends and the tensors ``sub`` (by key) put
    in place of ``data``'s, and their cotangent ``cot`` given the state's
    cotangent ``lam`` after the step."""
    t = data["times"]
    n_steps = t.shape[0] - 1
    live = [k for k in want if k not in own]
    need_t = "times" in want
    acc = {k: torch.zeros_like(data[k]) for k in live}
    t_bar = torch.zeros_like(t)
    lam = Cplx(torch.zeros_like(data["psi_re"]), torch.zeros_like(data["psi_im"]))
    xs = [data[x] for x in live]
    for k0 in reversed(range(0, n_steps, seg_len)):
        k1 = min(k0 + seg_len, n_steps)
        carries = [start(k0 // seg_len)]
        for k in range(k0, k1 - 1):
            carries.append(advance(carries[-1], k))
        for k in reversed(range(k0, k1)):
            y, f, cot = local(k, carries[k - k0], lam)
            ends = (t[k], t[k + 1])
            if need_t:
                _, vjp_fn = torch.func.vjp(
                    lambda re, im, t0, t1, *xs_: f(dict(zip(live, xs_)), re, im, t0, t1),
                    y.re, y.im, *ends, *xs)
            else:  # the interval's ends as constants: no cotangent taken
                _, vjp_fn = torch.func.vjp(
                    lambda re, im, *xs_: f(dict(zip(live, xs_)), re, im, *ends),
                    y.re, y.im, *xs)
            cots = vjp_fn(cot)
            lam = Cplx(cots[0], cots[1])
            if need_t:
                t_bar[k] += cots[2]
                t_bar[k + 1] += cots[3]
                cots = cots[:2] + cots[4:]
            for key, c in zip(live, cots[2:]):
                acc[key] += c
    return lam, {"times": t_bar, **acc}


def _backward(cfg: dict, slots: list, want: list, kept: list, g_re, g_im, data: dict) -> list:
    """The cotangents of the ``want`` keys, from the kept start states
    ``kept`` = [re, im]."""
    t, n_eval = data["times"], cfg["n_eval"]
    st_re, st_im = kept
    step = _step_of(cfg, data)

    def local(k, y, lam):
        if slots[k + 1] < n_eval:
            lam = lam + Cplx(g_re[slots[k + 1]], g_im[slots[k + 1]])

        def f(sub, re, im, t0, t1):
            out = (_step_of(cfg, {**data, **sub}) if sub else step)(Cplx(re, im), t0, t1)
            return out.re, out.im

        return y, f, (lam.re, lam.im)

    lam, found = _reverse_sweep(data, want, _STATE_KEYS, cfg["seg_len"],
                                lambda i: Cplx(st_re[i], st_im[i]),
                                lambda y, k: step(y, t[k], t[k + 1]), local)
    if slots[0] < n_eval:
        lam = lam + Cplx(g_re[slots[0]], g_im[slots[0]])
    found.update(psi_re=lam.re, psi_im=lam.im)
    # fresh tensors: an op's output may not alias its inputs
    return [found[k].clone() for k in want]


@torch.library.custom_op("pulser_diff_torch::stepper_states", mutates_args=())
def _states_op(cfg: str, slots: torch.Tensor, keys: str,
               tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The steppers' loop (see the module docstring)."""
    with _f32_full_precision(whole=True):
        return _forward(json.loads(cfg), slots.tolist(), _data_of(keys, tensors))


@_states_op.register_fake
def _(cfg, slots, keys, tensors):
    c, data = json.loads(cfg), _data_of(keys, tensors)
    psi = data["psi_re"]
    n_kept = _n_kept(data["times"].shape[0] - 1, c["seg_len"])
    return [psi.new_empty((n, *psi.shape)) for n in (c["n_eval"],) * 2 + (n_kept,) * 2]


@torch.library.custom_op("pulser_diff_torch::stepper_states_bwd", mutates_args=())
def _states_bwd_op(cfg: str, slots: torch.Tensor, keys: str, want: str,
                   kept: list[torch.Tensor], g_re: torch.Tensor, g_im: torch.Tensor,
                   tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The adjoint of ``stepper_states`` for the slot cotangents ``g``,
    from its kept start states (re, im): the cotangents of the ``want``
    keys, in that order."""
    with _f32_full_precision(whole=True):
        return _backward(json.loads(cfg), slots.tolist(), want.split(","), kept, g_re, g_im,
                         _data_of(keys, tensors))


def _bwd_fake(cfg, slots, keys, want, kept, g_re, g_im, tensors):
    """The fake implementation of an adjoint op: one cotangent like each
    wanted tensor."""
    data = _data_of(keys, tensors)
    return [torch.empty_like(data[k]) for k in want.split(",")]


def _register_loop_autograd(op, bwd_op, kept_from: int) -> None:
    """``op``'s autograd rule, for a loop op (cfg, slots, keys, tensors)
    whose first two outputs are the slot states (re, im) and whose outputs
    from ``kept_from`` on are the carries its adjoint ``bwd_op`` (cfg,
    slots, keys, want, kept, g_re, g_im, tensors) reads: the adjoint runs
    for the tensors whose gradient is asked for, with zero slot
    cotangents where autograd hands none."""
    bwd_op.register_fake(_bwd_fake)

    def setup(ctx, inputs, output) -> None:
        cfg, slots, keys, tensors = inputs
        ctx.cfg, ctx.keys, ctx.n_kept = cfg, keys, len(output) - kept_from
        _save_states(ctx, output[kept_from:], slots, *tensors, n_states=ctx.n_kept)

    def backward(ctx, grads):
        saved = _saved(ctx)
        kept, slots, tensors = list(saved[:ctx.n_kept]), saved[ctx.n_kept], saved[ctx.n_kept + 1:]
        keys = ctx.keys.split(",")
        want = [k for k, n in zip(keys, ctx.needs_input_grad[3]) if n]
        out: list = [None] * len(keys)
        if want:
            shape = (json.loads(ctx.cfg)["n_eval"], *kept[0].shape[1:])
            g_re, g_im = (kept[0].new_zeros(shape) if g is None else g for g in grads[:2])
            cots = bwd_op(ctx.cfg, slots, ctx.keys, ",".join(want), kept, g_re, g_im,
                          list(tensors))
            for k, c in zip(want, cots):
                out[keys.index(k)] = c
        return None, None, None, out

    op.register_autograd(backward, setup_context=setup)


_register_loop_autograd(_states_op, _states_bwd_op, 2)


def _op_args(kind: str, solver: str, ham, y0: Cplx, grid, substeps: int,
             n_segments: Optional[int], *, krylov_dim: int = 12, krylov_tol: float = 1e-12,
             rtol: float = 1e-8, atol: float = 1e-10, max_iters: int = 256,
             collapse: Optional[CollapseOps] = None, n: int = 0, d: int = 0,
             form: Optional[str] = None) -> tuple:
    """The arguments of ``stepper_states`` (cfg, slots, keys, tensors) for a
    solve as :func:`run_stepper` takes it."""
    n_steps = grid.times.shape[0] - 1
    seg_len = 1
    if n_segments is not None and n_segments > 1 and n_steps >= 4:
        seg_len = -(-n_steps // min(n_segments, n_steps))
    sample_dt = ham.sample_dt
    cfg = {
        "kind": kind, "solver": solver, "substeps": int(substeps), "n_eval": int(grid.n_eval),
        "n_samples": int(ham.n_samples), "seg_len": int(seg_len),
        "sample_dt": None if isinstance(sample_dt, torch.Tensor) else float(sample_dt),
        "krylov_dim": int(krylov_dim), "krylov_tol": float(krylov_tol), "rtol": float(rtol),
        "atol": float(atol), "max_iters": int(max_iters), "form": form, "n": int(n),
        "d": int(d), "sites": [] if collapse is None else [int(s) for s in collapse.sites],
    }
    data = _inputs(ham, y0, grid.times, collapse)
    slots = torch.as_tensor([int(s) for s in grid.write_slots], dtype=torch.int64)
    return json.dumps(cfg), slots, ",".join(data), list(data.values())


def run_stepper(*args, **kwargs) -> Cplx:
    """``_integrate(step, y0, grid, ...)`` of the step that ``sesolve``
    (``kind="se"``) or ``mesolve`` (``"me"``, with ``collapse``, the
    register's ``n`` sites of dimension ``d`` and the right-hand side's
    ``form``) builds, as one call of ``stepper_states``: the states at
    the grid's evaluation slots, differentiable through
    ``stepper_states_bwd``.  The arguments are :func:`_op_args`';
    ``n_segments`` is read as ``_integrate`` reads it."""
    outs = _states_op(*_op_args(*args, **kwargs))
    return Cplx(outs[0], outs[1])

"""A frozen copy of ``chip_smoke.py``'s ``_bound_ms``, for one earlier line.

That bound counts the work of the port's own factored layout (da x db
blocks, part stacks, two-word streams) from the staged tensors, so a
change of layout changes it, and a leaner layout could read over 100 %.
No metric reads it: the roofline shares count the work from the problem
(``counts.py``).  It is printed so that a run's kernel times tie to the
kernel table of PERF.md, whose bounds it gave.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.work.peaks import F32_FLOPS, HBM_BYTES_PER_S


def _bound_ms(fe, data, slots, others, S: int, kind: str) -> tuple[float, str]:
    """chip_smoke.py's ``_bound_ms`` as it stood when the benchmark was
    defined (its comments shortened)."""
    R, nb, da, db = (int(v) for v in data["psi_re"].shape)
    n_steps = int(data["hs"].shape[0])
    K = fe._n_kron(data)
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    kron_flops = 2 * nb * K * 4 * (da * da * db + da * db * db)
    assembly_flops = 2 * (pr * da * da + pc * db * db) * 2
    apply_flops = 2 * 4 * nb * (da * da * db + da * db * db) + kron_flops + assembly_flops
    outer_flops = (2 * 4 * nb * (da * da * db + db * db * da)
                   + 2 * nb * K * (4 * (da * db * db + da * da * db)
                                   + 4 * da * da * db + 4 * db * db * da))
    outer_flops += 2 * (pr * da * da + pc * db * db) * 2
    shared = ("rp", "cp", "hb_hi", "hb_lo", "hs", "diag", "diag_lo") + fe._ZF_KEYS
    if K:
        shared += ("kr", "kc") + fe._ZKF_KEYS
    inputs = [data[k] for k in shared]
    if kind in ("fwd", "fwd_ckpt"):
        flops = R * n_steps * S * apply_flops
        inputs += [data["psi_re"], data["psi_im"]]
    elif kind == "bwd":
        flops = R * n_steps * ((3 * S - 1) * apply_flops + S * outer_flops)
        inputs += [data[k] for k in fe._ZB_KEYS + (fe._ZKB_KEYS if K else ())]
    else:
        flops = R * n_steps * ((2 * S - 1) * apply_flops + S * outer_flops)
        inputs += [data["psi_re"], data["psi_im"]]
    tensors = (*inputs, *(() if slots is None else (slots,)), *others)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_line(model, stacks: torch.Tensor, split) -> str:
    """The frozen bound of each kernel of the model's route at the
    candidates ``stacks`` (P, n), each taken to the model's parameters by
    ``split``, staged as the main path stages them; the kernels run once
    each for their outputs' sizes."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.ops import fused_evolution as fe
    from pulser_diff_torch.solvers import TimeGrid

    with torch.no_grad():
        sims = [model._make_emulator(split(k)) for k in stacks]
        h = sims[0]._hamiltonian
        da, db = h.dim**h._a, h.dim**h._b
        substeps = model._default_substeps()
        grid = TimeGrid.make(h.sampling_times, sims[0]._eval_times_array,
                             stacks.device).refined(substeps)
        psi0 = sims[0].initial_state
        nb = psi0.shape[1]
        p = Cplx(psi0.re.T.reshape(nb, da, db), psi0.im.T.reshape(nb, da, db))
        data = fe.prepare_mc_inputs([s._hamiltonian._ham_data for s in sims], p, grid.times,
                                    "DP5")
        data = {k: v.detach().contiguous() for k, v in data.items()}
        slots = torch.as_tensor(np.asarray(grid.write_slots, np.int32), device=stacks.device)
        n_eval, last = grid.n_eval, int(grid.write_slots[-1])
        ckpt = sims[0]._route_ckpt(model.options.get("ckpt"), h._ham_data, "DP5")
        S = 6
        if ckpt:
            st = fe.fused_fwd_ckpt(data, "DP5")
            lam = [torch.ones_like(st[0]), torch.ones_like(st[1])]
            out = fe.fused_bwd_ckpt(data, "DP5", st[0], st[1], *lam)
            kinds = (("K4", None, st[:2], "fwd_ckpt"), ("K5", None, (*st[:2], *lam, *out),
                                                         "bwd_ckpt"))
        else:
            st = fe.fused_fwd(data, "DP5", slots, n_eval)
            lam = [torch.ones_like(st[0]), torch.ones_like(st[1])]
            out = fe.fused_bwd(data, "DP5", slots, n_eval, last, st[0], st[1], *lam)
            kinds = (("K1", slots, st[:2], "fwd"), ("K2", slots, (*st[:2], *lam, *out), "bwd"))
        parts = []
        for label, sl, others, kind in kinds:
            ms, by = _bound_ms(fe, data, sl, others, S, kind)
            parts.append(f"{label} {ms:.4f} ms by {by}")
    return (f"frozen chip_smoke _bound_ms (the port's layout, R = {len(stacks)}, "
            f"{int(data['hs'].shape[0])} steps): " + ", ".join(parts))

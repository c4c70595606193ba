#!/usr/bin/env python3
"""Seconds to export a value+grad step against its steps, on the CPU.

    python3 export_timing.py [--solver DP5_SE] [--ns 4 200] [--threads 1]
    python3 export_timing.py --solver MCWF --ns 80 400

The step is tests/test_torch_export.py's: two atoms 8 um apart, one
constant rydberg_global pulse of trainable amplitude, the last total
magnetization and its gradient (torch.autograd.grad).  With ``--solver
MCWF`` (or ``MCWF_F32``) the atoms dephase at 3 /us and the value is
``expectation_mcwf_fn``'s average over 4 trajectories (key 0, one
step a sample), whose loop is the op ``mcwf_states`` under the trace: 424
graph nodes at 80 and at 400 ns (one CPU thread).  For each pulse
length it prints the steps the solver takes, the nodes of the exported
graph, and the seconds of export_step (its eager call, the trace and the
save), load_step and one reloaded call.  On every route the loop over
steps is one op under the trace (the steppers' ``stepper_states``, the
fused route's kernels: DP5_PALLAS, their plain versions on the CPU), so
the graph keeps its size as the steps grow: with DP5_SE, 363 nodes and
an export of 4.0 s at 4 ns and 5.7 s at 200 ns (DP5_SE_F32: 397 nodes,
3.6 s and 9.1 s), where the unrolled loop took 53.3 s at 4 ns (16720
nodes) and did not finish in 600 s at 200 ns.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence
from pulser_diff_torch.model import QuantumModel
from pulser_diff_torch.ops import total_magnetization
from pulser_diff_torch.simconfig import SimConfig
from pulser_diff_torch.utils import export_step, load_step

MCWF_SOLVERS = ("MCWF", "MCWF_F32")
MCWF_TRAJ = 4


def _step(duration: int, solver: str):
    reg = Register({"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])})
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse.ConstantPulse(duration, seq.declare_variable("om"), -1.0, 0.0), "ryd")
    obs = total_magnetization(2, device="cpu")
    if solver in MCWF_SOLVERS:
        model = QuantumModel(seq, {"om": 1.8}, solver=solver, device="cpu",
                             noise_config=SimConfig(noise="dephasing", dephasing_rate=3.0),
                             evaluation_times="Minimal")
        exp_fn = model.expectation_mcwf_fn(obs, key=0, n_traj=MCWF_TRAJ, substeps=1)
    else:
        model = QuantumModel(seq, {"om": 1.8}, solver=solver, device="cpu")
        exp_fn = model.expectation_fn(obs)

    def step(p):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        _, vals = exp_fn(q)
        grads = torch.autograd.grad(vals[-1], list(q.values()))
        return vals[-1].detach(), {k: g.detach() for k, g in zip(q, grads)}

    return model, step


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", default="DP5_SE")
    ap.add_argument("--ns", type=int, nargs="+", default=[4, 200])
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    p0 = {"om": torch.tensor(1.8, dtype=torch.float64)}
    with tempfile.TemporaryDirectory() as tmp:
        for ns in args.ns:
            model, step = _step(ns, args.solver)
            path = os.path.join(tmp, f"step{ns}.pt2")
            t0 = time.perf_counter()
            export_step(step, (p0,), path)
            t1 = time.perf_counter()
            loaded = load_step(path, device="cpu")
            t2 = time.perf_counter()
            loaded(p0)
            t3 = time.perf_counter()
            nodes = len(torch.export.load(path).graph.nodes)
            steps = ns * (1 if args.solver in MCWF_SOLVERS else model._default_substeps())
            print(f"{args.solver} {ns} ns: {steps} steps, {nodes} graph nodes; export_step "
                  f"{t1 - t0:.1f} s, load_step {t2 - t1:.1f} s, reloaded call {t3 - t2:.2f} s",
                  flush=True)


if __name__ == "__main__":
    main()

"""Basic usage (docs/basic_usage.py in the port).

Build a sequence on two atoms 8 um apart (a constant pulse, then a
Blackman pulse under a detuning ramp), simulate it, take the total
magnetization over time, its derivative in the first pulse's amplitude
(``deriv_param``) and its derivative in the evaluation times
(``deriv_time`` through ``TimeGrid.with_values`` and ``sesolve``).

    python -m pulser_diff_torch.examples.basic_usage
"""

from __future__ import annotations

import numpy as np
import torch

from pulser_diff_torch import TorchEmulator
from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.core import (
    BlackmanWaveform, MockDevice, Pulse, RampWaveform, Register, Sequence,
)
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.derivative import deriv_param, deriv_time
from pulser_diff_torch.examples._common import knots
from pulser_diff_torch.ops import total_magnetization
from pulser_diff_torch.ops.linalg import expect
from pulser_diff_torch.solvers import TimeGrid, sesolve

COORDS = {"q0": (-4.0, 0.0), "q1": (4.0, 0.0)}
OMEGA = 2.0


def sequence(omega=OMEGA) -> Sequence:
    """ConstantPulse(300 ns, ``omega``, -1, 0), then a Blackman pulse of
    area pi under a ramp from -2 to 2 rad/us, phase 0.3."""
    seq = Sequence(Register(COORDS), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse.ConstantPulse(300, omega, -1.0, 0.0), "ryd")
    seq.add(Pulse(BlackmanWaveform(300, np.pi), RampWaveform(300, -2.0, 2.0), 0.3), "ryd")
    return seq


def magnetization_trace(omega, device: DeviceLike) -> torch.Tensor:
    """<M>(t) at every sampling time."""
    sim = TorchEmulator.from_sequence(sequence(omega), device=device)
    obs = total_magnetization(len(COORDS), device=sim.torch_device)
    return sim.run().expect([obs])[0].re


def magnetization_and_grad(device: DeviceLike) -> tuple[float, float]:
    """<M>(T) at omega = 2 and d<M>(T)/d omega (``deriv_param`` at the
    final time), from one solve and its adjoint."""
    omega = knots(OMEGA, device).requires_grad_(True)
    times = TorchEmulator.from_sequence(sequence(), device=device).evaluation_times
    traces = []

    def trace(om):
        traces.append(magnetization_trace(om, device))
        return traces[-1]

    (grad,) = deriv_param(trace, [omega], times=times)
    return float(traces[0][-1].detach()), float(grad)


def trace_of_times(device: DeviceLike, n_times: int | None = None):
    """(f, times, pulse end times): f maps the evaluation times to <M> at
    each of them, through ``sesolve`` on a grid whose times carry the
    gradient (``TimeGrid.with_values``).  ``n_times`` keeps the first so
    many evaluation times, and the solve ends at the last of them."""
    sim = TorchEmulator.from_sequence(sequence(), device=device)
    obs = total_magnetization(len(COORDS), device=sim.torch_device)
    h = sim._hamiltonian
    eval_times = np.asarray(sim._eval_times_array)[:n_times]
    sampling = np.asarray(h.sampling_times)
    grid0 = TimeGrid.make(sampling[sampling <= eval_times[-1]], eval_times, sim.torch_device)
    da, db = h.dim**h._a, h.dim**h._b
    psi0 = sim.initial_state
    p = Cplx(psi0.re.T.reshape(1, da, db), psi0.im.T.reshape(1, da, db))

    def f(ts):
        states = sesolve(h._ham_data, p, grid0.with_values(ts))
        n_eval = states.re.shape[0]
        return expect(obs, states.reshape(n_eval, da * db, 1)).re

    n = len(eval_times)
    return f, sim.evaluation_times[:n], [i for i in sim.endtimes if i < n]


def time_derivative(device: DeviceLike, n_times: int | None = None) -> torch.Tensor:
    """d<M>/dt at every evaluation time, or at the first ``n_times``
    (``deriv_time``, the pulse boundaries repaired)."""
    f, times, endtimes = trace_of_times(device, n_times)
    return deriv_time(f, times, pulse_endtimes=endtimes)


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    """The flow has one size: ``ci`` changes nothing."""
    final, grad = magnetization_and_grad(device)
    out = {"final_magnetization": final, "dM_domega": grad,
           "max_dM_dt": float(time_derivative(device).abs().max())}
    print("final magnetization:", out["final_magnetization"])
    print("d<M>(T)/d omega =", out["dM_domega"])
    print("max |d<M>/dt| =", out["max_dM_dt"])
    return out


if __name__ == "__main__":
    main()

"""Gate optimization (docs/gate_optimization.py in the port).

A global pulse whose amplitude and detuning are sine-interpolated from
trainable knots is optimised so that the evolution implements a target
gate: a Hadamard on each of 2 atoms (10 + 10 knots, 512 ns) and on each
of 4 atoms (20 + 20 knots, 1100 ns).  The gate matrix is the evolution of
the identity: its d columns are one batch of initial states, nb = d, so
on the GPU every value and gradient is one launch of the forward kernel
(K1) and one of its adjoint (K2) over the whole batch.

    python -m pulser_diff_torch.examples.gate_optimization
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

from pulser_diff_torch import TorchEmulator
from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.core import Register
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.examples._common import (
    AdamRun, adam, ci_mode, epoch_line, knots, sweep_emulator,
)
from pulser_diff_torch.utils import timed

N_PARAMS = 10
DURATION = 512
SAMPLING_RATE = 0.25
COORDS = {"q0": (-10.0, 0.0), "q1": (10.0, 0.0)}

# target: a Hadamard on every qubit (in the r-first ordering)
H1 = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
TARGET = np.kron(H1, H1)

# the 4-qubit gate: 20 knots a waveform over 1100 ns on a 20 um square
N_PARAMS4 = 20
DURATION4 = 1100
COORDS4 = {f"q{i}": (20.0 * (i % 2) - 10.0, 20.0 * (i // 2) - 10.0) for i in range(4)}
TARGET4 = reduce(np.kron, [H1] * 4)

# the starting knots (amplitude, detuning) and the scripts' epochs
P0 = (3.0, 3.0)
P0_4 = (2.0, 1.0)
EPOCHS = 300
EPOCHS4 = 400
LR = 5e-2
# the convergence floor that tests/test_docs.py holds the 2-qubit gate to
FLOOR_LR = 0.15
FLOOR_STEPS = 200
FLOOR_FIDELITY = 0.99


def gate_emulator(params, coords, duration: int, device: DeviceLike) -> TorchEmulator:
    """The emulator of the gate pulse for knots ``params`` = (amplitude,
    detuning), its initial state the identity (one state a column)."""
    sim = sweep_emulator(Register(coords), *params, duration, SAMPLING_RATE, device)
    eye = torch.eye(2 ** len(coords), dtype=torch.float64, device=sim.torch_device)
    sim.set_initial_state(Cplx(eye, torch.zeros_like(eye)))
    return sim


def overlap_fidelity(states: Cplx, target: np.ndarray) -> torch.Tensor:
    """|tr(U_target^H U)|^2 / d^2 of the last evolved gate matrix U (the
    target is real)."""
    u = states[states.re.shape[0] - 1]
    tgt = torch.as_tensor(target, dtype=torch.float64, device=u.re.device)
    ov_re = torch.sum(tgt * u.re)
    ov_im = torch.sum(tgt * u.im)
    return (ov_re**2 + ov_im**2) / target.shape[0] ** 2


def gate_fidelity(params, device: DeviceLike, **options) -> torch.Tensor:
    """The 2-qubit gate's fidelity; ``options`` go to ``run()``."""
    sim = gate_emulator(params, COORDS, DURATION, device)
    return overlap_fidelity(sim.run(**options).states, TARGET)


def gate_fidelity_4q(params, device: DeviceLike, **options) -> torch.Tensor:
    """The 4-qubit gate's fidelity (nb = 16); ``options`` go to ``run()``."""
    sim = gate_emulator(params, COORDS4, DURATION4, device)
    return overlap_fidelity(sim.run(**options).states, TARGET4)


def initial_params(n_params: int, start: tuple, device: DeviceLike) -> tuple:
    """(amplitude, detuning) knots, each a constant."""
    return tuple(knots(np.full(n_params, v), device) for v in start)


def optimize(fidelity, params, epochs: int, lr: float = LR, label: str = "",
             stop_at: float | None = None, log_every: int = 25) -> AdamRun:
    """Adam on the infidelity 1 - ``fidelity(params)``."""
    return adam(lambda ps: 1.0 - fidelity(ps), params, epochs, lr, stop_at=stop_at,
                log_every=log_every, label=label)


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    """The 2-qubit optimisation (300 epochs; 3 in CI), then, outside CI,
    the 4-qubit one (400 epochs)."""
    ci = ci_mode(ci)
    secs = {}
    with timed("2q", secs):
        run = optimize(lambda p: gate_fidelity(p, device), initial_params(N_PARAMS, P0, device),
                       3 if ci else EPOCHS)
    out = {"fidelity": 1.0 - run.best}
    print(f"final gate fidelity: {100 * out['fidelity']:.3f}% "
          f"({epoch_line(secs['2q'], len(run.losses))})")
    if not ci:
        with timed("4q", secs):
            run4 = optimize(lambda p: gate_fidelity_4q(p, device),
                            initial_params(N_PARAMS4, P0_4, device), EPOCHS4, label="4q ")
        out["fidelity_4q"] = 1.0 - run4.best
        print(f"final 4-qubit gate fidelity: {100 * out['fidelity_4q']:.3f}% "
              f"({epoch_line(secs['4q'], len(run4.losses))})")
    return out


if __name__ == "__main__":
    main()

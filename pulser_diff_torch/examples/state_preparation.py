"""State preparation (docs/state_preparation.py in the port).

Prepare |r...r> on a 6-atom chain 12 um apart by optimising an adiabatic
sweep: amplitude and detuning sine-interpolated from 15 + 15 knots over
1100 ns, gradients through the whole evolution (on the GPU, one launch of
K1 and one of K2 an epoch, at da = db = 8).  Three Adam stages, 2000,
2000 and 3000 epochs at learning rates 1e-2, 3e-3 and 1e-3, each from the
last one's parameters, keep the best parameters seen.

    python -m pulser_diff_torch.examples.state_preparation
"""

from __future__ import annotations

import numpy as np
import torch

from pulser_diff_torch import TorchEmulator
from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.core import Register
from pulser_diff_torch.examples._common import (
    ci_mode, epoch_line, final_population, knots, staged_adam, sweep_emulator,
)
from pulser_diff_torch.utils import timed

N_QUBITS = 6
N_PARAMS = 15  # 15 amplitude + 15 detuning knots
DURATION = 1100
SAMPLING_RATE = 0.25
SPACING = 12.0
# target: every atom in |r> (index 0 per site, so global index 0)
TARGET_INDEX = 0
STAGES = ((1e-2, 2000), (3e-3, 2000), (1e-3, 3000))
# the epochs between progress lines
LOG_EVERY = 500
# CI: two epochs a stage
CI_STAGES = ((1e-2, 2), (3e-3, 2), (1e-3, 2))


def emulator(amp_p: torch.Tensor, det_p: torch.Tensor, device: DeviceLike) -> TorchEmulator:
    return sweep_emulator(Register.linear(N_QUBITS, spacing=SPACING, prefix="q"), amp_p, det_p,
                          DURATION, SAMPLING_RATE, device)


def fidelity(amp_p: torch.Tensor, det_p: torch.Tensor, device: DeviceLike,
             **options) -> torch.Tensor:
    """The final population of |r...r>; ``options`` go to ``run()``."""
    return final_population(emulator(amp_p, det_p, device), TARGET_INDEX, **options)


def initial_params(device: DeviceLike) -> tuple:
    """The sweep the script starts from: the amplitude a half sine of
    height 3, the detuning a ramp from -6 to 6 rad/us."""
    return (knots(3.0 * np.sin(np.linspace(0, np.pi, N_PARAMS)), device),
            knots(np.linspace(-6.0, 6.0, N_PARAMS), device))


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    stages = CI_STAGES if ci_mode(ci) else STAGES
    secs = {}
    with timed("flow", secs):
        best, _ = staged_adam(lambda ps: 1.0 - fidelity(*ps, device), initial_params(device),
                              stages, log_every=LOG_EVERY)
    print(f"final state fidelity: {100 * (1 - best):.4f}% after "
          f"{epoch_line(secs['flow'], sum(n for _, n in stages))}")
    return {"fidelity": 1.0 - best}


if __name__ == "__main__":
    main()

"""Adiabatic antiferromagnetic state preparation on 9 atoms
(docs/afm_preparation.py in the port).

Prepare |rgrgrgrgr> on a 9-atom chain 7 um apart, in the Rydberg-blockade
regime (C6/r^6 = 46 rad/us between neighbours), by optimising a sweep of
15 + 15 sine-interpolated knots over 1500 ns with gradients through the
whole evolution (on the GPU, one launch of K1 and one of K2 an epoch, at
dim 512).  Three Adam stages, 3000, 3000 and 4000 epochs at learning rates
1e-2, 3e-3 and 1e-3, keep the best parameters seen.

    python -m pulser_diff_torch.examples.afm_preparation
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

N = 9
SPACING = 7.0
N_PARAMS = 15
DURATION = 1500
RATE = 0.25
# target |rgrgrgrgr>: r is bit 0 of a site in the index ordering (r first)
TARGET = int("".join("0" if i % 2 == 0 else "1" for i in range(N)), 2)
STAGES = ((1e-2, 3000), (3e-3, 3000), (1e-3, 4000))
# the epochs between progress lines
LOG_EVERY = 500
# CI: one epoch a stage
CI_STAGES = ((1e-2, 1), (3e-3, 1), (1e-3, 1))


def emulator(amp_p: torch.Tensor, det_p: torch.Tensor, device: DeviceLike) -> TorchEmulator:
    return sweep_emulator(Register.linear(N, spacing=SPACING, prefix="q"), amp_p, det_p,
                          DURATION, RATE, device)


def fidelity(amp_p: torch.Tensor, det_p: torch.Tensor, device: DeviceLike,
             **options) -> torch.Tensor:
    """The final population of |rgrgrgrgr>; ``options`` go to ``run()``."""
    return final_population(emulator(amp_p, det_p, device), TARGET, **options)


def initial_params(device: DeviceLike) -> tuple:
    """The script's start: the amplitude a half sine of height 5.5, the
    detuning a ramp from -12 to 14 rad/us."""
    return (knots(5.5 * np.sin(np.linspace(0, np.pi, N_PARAMS)), device),
            knots(np.linspace(-12.0, 14.0, N_PARAMS), device))


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    stages = CI_STAGES if ci_mode(ci) else STAGES
    secs = {}
    with timed("flow", secs):
        best, _ = staged_adam(lambda ps: 1.0 - fidelity(*ps, device), initial_params(device),
                              stages, log_every=LOG_EVERY)
    print(f"final 9-atom AFM fidelity: {100 * (1 - best):.4f}% after "
          f"{epoch_line(secs['flow'], sum(n for _, n in stages))}")
    return {"fidelity": 1.0 - best}


if __name__ == "__main__":
    main()

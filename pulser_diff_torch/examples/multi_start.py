"""Multi-start optimization (docs/multi_start.py in the port).

Pulse-level loss landscapes are not convex, and the usual cure is to
restart from several guesses.  ``QuantumModel.fit_population`` trains P
candidates in lock-step: on the GPU the P Hamiltonians ride the runs
axis of the fused kernels, one launch of K1 and one of K2 an epoch for
all of them.  The best candidate seen is loaded into the model.

Two atoms 10 um apart, a sine-interpolated amplitude (6 knots) and a
constant detuning, both trainable, are driven to a final magnetization
generated from known parameters, so that a perfect solution exists.

    python -m pulser_diff_torch.examples.multi_start
"""

from __future__ import annotations

import numpy as np
import torch

from pulser_diff_torch import QuantumModel
from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.core import (
    ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
)
from pulser_diff_torch.examples._common import ci_mode, epoch_line, knots, sine_drive
from pulser_diff_torch.utils import timed

N_PARAMS = 6
DURATION = 384
SAMPLING_RATE = 0.5
COORDS = {"q0": (-5.0, 0.0), "q1": (5.0, 0.0)}
# the parameters that generate the target
TRUE_AMP = 2.0 * np.sin(np.linspace(0.3, np.pi, N_PARAMS))
TRUE_DET = -0.8
LR = 5e-2
SEED = 7
# (candidates, epochs): the script's sizes and its CI sizes
SIZES = (8, 200)
CI_SIZES = (4, 40)


def make_model(device: DeviceLike) -> QuantumModel:
    """The model over the declared variables ``amp_samples`` (from 6
    knots, ``amp_samples_0``) and ``det``."""
    seq = Sequence(Register(COORDS), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp_samples = seq.declare_variable("amp_samples", size=DURATION)
    det = seq.declare_variable("det")
    seq.add(Pulse(CustomWaveform(amp_samples, duration=DURATION),
                  ConstantWaveform(DURATION, det), 0.0), "ryd")
    return QuantumModel(
        seq,
        {"amp_samples": ((np.ones(N_PARAMS),), lambda v: sine_drive(v, DURATION)), "det": 0.0},
        sampling_rate=SAMPLING_RATE,
        evaluation_times="Minimal",
        device=device,
    )


def final_value(model: QuantumModel, params) -> float:
    """The final total magnetization at ``params``."""
    with torch.no_grad():
        _, vals = model.expectation_fn()(params)
    return float(vals[-1])


def target_value(model: QuantumModel) -> float:
    dev = model.torch_device
    return final_value(model, {"amp_samples_0": knots(TRUE_AMP, dev),
                               "det": knots(TRUE_DET, dev)})


def make_loss(target: float):
    """(eval_times, values) -> the squared distance of the final value
    to ``target``."""
    def loss(times, vals):
        return (vals[-1] - target) ** 2
    return loss


def initial_stack(n_pop: int, seed: int = SEED) -> dict:
    """``n_pop`` candidates drawn around a neutral guess (numpy arrays)."""
    rng = np.random.default_rng(seed)
    return {"amp_samples_0": 1.0 + 0.8 * rng.standard_normal((n_pop, N_PARAMS)),
            "det": 0.5 * rng.standard_normal(n_pop)}


def train(model: QuantumModel, target: float, stack: dict, epochs: int,
          steps_per_call: int = 1) -> tuple[list, dict]:
    """``fit_population`` with Adam at ``LR``: (one (P,) loss array an
    epoch, the final stack); the best candidate is loaded."""
    return model.fit_population(make_loss(target), stack, epochs=epochs,
                                optimizer=lambda ps: torch.optim.Adam(ps, lr=LR),
                                steps_per_call=steps_per_call)


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    n_pop, epochs = CI_SIZES if ci_mode(ci) else SIZES
    model = make_model(device)
    target = target_value(model)
    secs = {}
    with timed("flow", secs):
        losses, _ = train(model, target, initial_stack(n_pop), epochs,
                          steps_per_call=epochs // 2)
    print(f"{n_pop} candidates, {epoch_line(secs['flow'], epochs)}")
    print(f"initial losses: {np.round(np.asarray(losses[0]), 4)}")
    print(f"final   losses: {np.round(np.asarray(losses[-1]), 6)}")
    loaded = (final_value(model, dict(model.params)) - target) ** 2
    print(f"loaded best candidate loss: {loaded:.3g}")
    return {"losses": losses, "loaded": loaded}


if __name__ == "__main__":
    main()

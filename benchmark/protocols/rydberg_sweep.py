"""The ``rydberg_sweep`` protocol on the program's side.

One global Rydberg pulse whose amplitude (clipped at 0) and detuning are
sine-interpolated from trainable knots, on a fixed register, trained to
prepare a target basis state: the state-preparation workload of
pulser-diff.  This module makes the inputs from the seed (the
interpolation matrix, the knots) and builds the program's
``QuantumModel`` from the configuration; the plain reference of the same
protocol is ``benchmark/reference/`` under the same name.

A candidate's knots are one row: the amplitude's first, then the
detuning's (``PARAMS`` names the model's parameters in that order).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

PARAMS = ("amp_samples_0", "det_samples_0")


def sine_matrix(n_knots: int, duration: int) -> np.ndarray:
    """(duration, n_knots) weights that take the knots to one sample a
    ns: the span is cut into n_knots + 1 equal pieces, and inside each
    the sample moves from one knot to the next along the easing
    s(h) = (1 + sin(pi h - pi / 2)) / 2 (0 before the first knot and
    after the last)."""
    step = duration / (n_knots + 1)
    k = np.arange(duration, dtype=np.float64)
    idx = np.floor(k / step).astype(int)
    s = (1 + np.sin(np.pi * (k - idx * step) / step - np.pi / 2)) / 2
    out = np.zeros((duration, n_knots))
    rows = np.arange(duration)
    before = idx > 0
    out[rows[before], idx[before] - 1] = 1 - s[before]
    inside = idx < n_knots
    out[rows[inside], idx[inside]] = s[inside]
    return out


def make_inputs(cfg: Mapping, n_candidates: int, seed: int, device) -> dict:
    """The interpolation matrix and (P, 2 knots) float64 knots: the
    configuration's sweep (a half sine of the amplitude's height, a
    detuning ramp) with every knot moved by a uniform draw of up to
    ``jitter``, drawn on ``device`` from ``seed``."""
    pulse = cfg["pulse"]
    n = int(pulse["knots"])
    base = torch.cat([
        float(pulse["init_amplitude"]) * torch.sin(torch.linspace(0, np.pi, n,
                                                                  dtype=torch.float64)),
        torch.linspace(*(float(v) for v in pulse["init_detuning"]), n, dtype=torch.float64),
    ]).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand((n_candidates, 2 * n), generator=gen, dtype=torch.float64, device=device)
    return {"matrix": sine_matrix(n, int(pulse["duration_ns"])),
            "knots": base + float(pulse["jitter"]) * (2 * u - 1)}


def split(stack: torch.Tensor, cfg: Mapping) -> dict:
    """Knots (..., 2 knots) as the model's parameters by name."""
    n = int(cfg["pulse"]["knots"])
    return {PARAMS[0]: stack[..., :n], PARAMS[1]: stack[..., n:]}


def build_model(cfg: Mapping, inputs: Mapping, device):
    """The program's model of the protocol, its knots set to the first
    candidate's."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch import core

    pulse = cfg["pulse"]
    dev = getattr(core, cfg["device"])
    if abs(dev.interaction_coeff - cfg["interaction"]["c6"]) > 1e-6:
        raise ValueError(f"{cfg['device']} has C6 {dev.interaction_coeff}, the configuration "
                         f"states {cfg['interaction']['c6']}")
    duration = int(pulse["duration_ns"])
    reg = core.Register.from_coordinates([tuple(c) for c in cfg["register"]["coords"]],
                                         prefix="q")
    seq = core.Sequence(reg, dev)
    seq.declare_channel("drive", pulse["channel"])
    amp = seq.declare_variable("amp_samples", size=duration)
    det = seq.declare_variable("det_samples", size=duration)
    seq.add(core.Pulse(core.CustomWaveform(amp, duration=duration),
                       core.CustomWaveform(det, duration=duration), float(pulse["phase"])),
            "drive")
    m = torch.as_tensor(inputs["matrix"], dtype=torch.float64, device=device)
    first = split(inputs["knots"][0].detach(), cfg)
    return QuantumModel(
        seq,
        {"amp_samples": ((first[PARAMS[0]],), lambda v: torch.relu(m @ v.to(m.dtype))),
         "det_samples": ((first[PARAMS[1]],), lambda v: m @ v.to(m.dtype))},
        sampling_rate=float(pulse["sampling_rate"]),
        evaluation_times=cfg["solver"]["evaluation_times"],
        device=device,
    )


def observable(cfg: Mapping, device) -> torch.Tensor:
    """The projector on the target basis state, as its diagonal."""
    d = torch.zeros(2 ** len(cfg["register"]["coords"]), dtype=torch.float64, device=device)
    d[int(cfg["target_index"])] = 1.0
    return d


def loss(vals: torch.Tensor) -> torch.Tensor:
    """Each candidate's loss from its expectation values over the
    evaluation times (last axis): one minus the target's final
    population."""
    return 1.0 - vals[..., -1]

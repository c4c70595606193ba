"""What the example flows share: the CI switch, the sine-interpolated
drive and the emulator of a sweep, and an Adam loop that keeps the best
parameters it has seen."""

from __future__ import annotations

import math
import os
import time
from typing import Callable, NamedTuple, Sequence

import torch

from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.ops.linalg import _interpolate_sine_np


def ci_mode(ci: bool) -> bool:
    """The CI sizes: asked for, or ``PDT_DOCS_CI=1`` (the scripts' switch)."""
    return bool(ci) or bool(int(os.environ.get("PDT_DOCS_CI", "0")))


def knots(values, device: DeviceLike) -> torch.Tensor:
    """An f64 tensor of ``values`` on ``device``."""
    return torch.as_tensor(values, dtype=torch.float64, device=device)


def sine_drive(params: torch.Tensor, duration: int) -> torch.Tensor:
    """``duration`` samples sine-interpolated from the knots ``params``."""
    m = torch.as_tensor(_interpolate_sine_np(int(params.shape[0]), duration), dtype=torch.float64,
                        device=params.device)
    return m @ params


def sweep_emulator(register, amp_p: torch.Tensor, det_p: torch.Tensor, duration: int,
                   sampling_rate: float, device: DeviceLike):
    """The emulator of one global Rydberg pulse whose amplitude (clipped
    at 0) and detuning are sine-interpolated from ``amp_p`` and ``det_p``,
    evaluated at its start and end only."""
    from pulser_diff_torch import TorchEmulator
    from pulser_diff_torch.core import CustomWaveform, MockDevice, Pulse, Sequence

    seq = Sequence(register, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp = torch.relu(sine_drive(amp_p, duration))
    det = sine_drive(det_p, duration)
    seq.add(Pulse(CustomWaveform(amp), CustomWaveform(det), 0.0), "ryd")
    return TorchEmulator.from_sequence(seq, sampling_rate=sampling_rate,
                                       evaluation_times="Minimal", device=device)


def final_population(sim, index: int, **options) -> torch.Tensor:
    """The population of basis state ``index`` at the end of
    ``sim.run(**options)``."""
    st = sim.run(**options).states
    return st[st.re.shape[0] - 1].abs2()[index, 0]


def epoch_line(seconds: float, epochs: int) -> str:
    """"N epochs in S s (M ms an epoch)"."""
    return f"{epochs} epochs in {seconds:.1f} s ({1e3 * seconds / epochs:.2f} ms an epoch)"


class AdamRun(NamedTuple):
    best: float  # the least loss seen
    best_params: list  # the parameters that gave it
    losses: list  # every epoch's loss
    params: list  # the parameters after the last update


def adam(loss_fn: Callable[[list], torch.Tensor], params: Sequence[torch.Tensor], epochs: int,
         lr: float, *, stop_at: float | None = None, log_every: int = 0,
         label: str = "") -> AdamRun:
    """``epochs`` steps of ``torch.optim.Adam`` at ``lr`` on ``loss_fn``
    of the list of parameters, from copies of ``params``.  With
    ``stop_at`` the loop ends once a loss is at or below it, before the
    update; ``log_every`` prints every so many epochs."""
    ps = [p.detach().clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(ps, lr=lr)
    best, best_ps, losses = math.inf, [p.detach().clone() for p in ps], []
    t0 = time.perf_counter()
    for ep in range(epochs):
        opt.zero_grad()
        loss = loss_fn(ps)
        loss.backward()
        value = float(loss.detach())
        losses.append(value)
        if value < best:
            best, best_ps = value, [p.detach().clone() for p in ps]
        if log_every and ep % log_every == 0:
            print(f"{label}epoch {ep}: loss {value:.6e}, best {best:.6e} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if stop_at is not None and best <= stop_at:
            break
        opt.step()
    return AdamRun(best, best_ps, losses, [p.detach() for p in ps])


def staged_adam(loss_fn: Callable[[list], torch.Tensor], params: Sequence[torch.Tensor],
                stages: Sequence[tuple[float, int]], log_every: int = 0) -> tuple[float, list]:
    """Adam stage after stage, ``stages`` a list of (lr, epochs), each
    stage a fresh optimiser from the last stage's final parameters, as the
    scripts' staged schedules run; returns the best loss of all stages and
    its parameters."""
    best, best_ps, ps = math.inf, [p.detach().clone() for p in params], list(params)
    for lr, epochs in stages:
        run = adam(loss_fn, ps, epochs, lr, log_every=log_every, label=f"lr={lr} ")
        print(f"adam lr={lr}: best loss {run.best:.3e}", flush=True)
        if run.best < best:
            best, best_ps = run.best, run.best_params
        ps = run.params
    return best, best_ps

"""Pulse: amplitude + detuning waveforms and a phase (counterpart of
pulser_diff_tpu/core/pulse.py)."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from pulser_diff_torch.core.variables import Expr, evaluate
from pulser_diff_torch.core.waveforms import ConstantWaveform, CustomWaveform, Waveform


class Pulse:
    """A pulse on a channel: amplitude wf (rad/us, >=0), detuning wf
    (rad/us), a carrier phase (rad) and a phase shift applied to its
    targets' phase reference at its end."""

    def __init__(
        self,
        amplitude: Waveform,
        detuning: Waveform,
        phase: Any,
        post_phase_shift: Any = 0.0,
    ) -> None:
        if not isinstance(amplitude, Waveform) or not isinstance(detuning, Waveform):
            raise TypeError("amplitude and detuning must be Waveforms.")
        if not (amplitude.is_parametrized or detuning.is_parametrized):
            if amplitude.duration != detuning.duration:
                raise ValueError(
                    "Pulse amplitude and detuning must have the same duration."
                )
        self.amplitude = amplitude
        self.detuning = detuning
        self.phase = phase
        self.post_phase_shift = post_phase_shift

    @property
    def duration(self) -> int:
        return self.amplitude.duration

    @property
    def is_parametrized(self) -> bool:
        return (
            self.amplitude.is_parametrized
            or self.detuning.is_parametrized
            or isinstance(self.phase, Expr)
            or isinstance(self.post_phase_shift, Expr)
        )

    def build(self, values: Mapping[str, Any]) -> "Pulse":
        if not self.is_parametrized:
            return self
        return Pulse(
            self.amplitude.build(values),
            self.detuning.build(values),
            evaluate(self.phase, values),
            evaluate(self.post_phase_shift, values),
        )

    @classmethod
    def ConstantPulse(
        cls, duration: Any, amplitude: Any, detuning: Any, phase: Any,
        post_phase_shift: Any = 0.0,
    ) -> "Pulse":
        return cls(
            ConstantWaveform(duration, amplitude),
            ConstantWaveform(duration, detuning),
            phase,
            post_phase_shift,
        )

    @classmethod
    def ConstantAmplitude(
        cls, amplitude: Any, detuning: Waveform, phase: Any,
        post_phase_shift: Any = 0.0,
    ) -> "Pulse":
        return cls(ConstantWaveform(detuning._duration, amplitude), detuning, phase,
                   post_phase_shift)

    @classmethod
    def ConstantDetuning(
        cls, amplitude: Waveform, detuning: Any, phase: Any,
        post_phase_shift: Any = 0.0,
    ) -> "Pulse":
        return cls(amplitude, ConstantWaveform(amplitude._duration, detuning), phase,
                   post_phase_shift)

    @classmethod
    def ArbitraryPhase(
        cls, amplitude: Waveform, phase: Waveform, post_phase_shift: Any = 0.0,
    ) -> "Pulse":
        """Pulse with a time-dependent carrier phase phi(t): a phase
        modulation is a detuning delta(t) = -dphi/dt, so the pulse gets a
        CustomWaveform detuning equal to minus the phase's derivative
        (central differences, rad/ns -> rad/us) and the carrier phase
        phi(0).  Neither waveform may be parametrized."""
        if not isinstance(phase, Waveform):
            raise TypeError("ArbitraryPhase requires a phase Waveform.")
        if amplitude.is_parametrized or phase.is_parametrized:
            raise NotImplementedError(
                "ArbitraryPhase does not support parametrized waveforms: build() them first."
            )
        ph = phase.samples
        det = -torch.gradient(ph)[0] * 1e3
        return cls(amplitude, CustomWaveform(det, duration=phase.duration), ph[0],
                   post_phase_shift)

    def draw(self, fig_name: str | None = None, kwargs_savefig: dict = {}) -> None:
        """Plot the pulse's amplitude and detuning (pulser's ``Pulse.draw``)."""
        import matplotlib.pyplot as plt
        import numpy as np

        from pulser_diff_torch.core.drawing import to_host

        fig, (ax_a, ax_d) = plt.subplots(2, 1, sharex=True, figsize=(8, 4))
        amp = to_host(self.amplitude.samples)
        det = to_host(self.detuning.samples)
        t = np.arange(self.duration)
        ax_a.fill_between(t, 0, amp, color="darkgreen", alpha=0.4)
        ax_a.plot(t, amp, color="darkgreen")
        ax_a.set_ylabel("Ω (rad/µs)")
        ax_d.fill_between(t, 0, det, color="indigo", alpha=0.3)
        ax_d.plot(t, det, color="indigo")
        ax_d.set_ylabel("δ (rad/µs)")
        ax_d.set_xlabel("t (ns)")
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        plt.show()

    def __repr__(self) -> str:
        return f"Pulse({self.amplitude!r}, {self.detuning!r}, phase={self.phase})"

"""Pulse: amplitude + detuning waveforms and a phase (counterpart of
pulser_diff_tpu/core/pulse.py)."""

from __future__ import annotations

from typing import Any, Mapping

from pulser_diff_torch.core.variables import Expr, evaluate
from pulser_diff_torch.core.waveforms import ConstantWaveform, Waveform


class Pulse:
    """A pulse on a channel: amplitude wf (rad/us, >=0), detuning wf
    (rad/us) and a carrier phase (rad)."""

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

    def __repr__(self) -> str:
        return f"Pulse({self.amplitude!r}, {self.detuning!r}, phase={self.phase})"

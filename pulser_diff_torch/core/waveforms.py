"""Waveforms (counterpart of pulser_diff_tpu/core/waveforms.py).

This slice ports ``ConstantWaveform`` and ``CustomWaveform``.  Durations
are integer nanoseconds; samples are one value per ns in rad/us, as
tensors that carry gradients to their parameters.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from pulser_diff_torch.config import DTYPE
from pulser_diff_torch.core.variables import Expr, evaluate


def _as_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(DTYPE)
    return torch.as_tensor(x, dtype=DTYPE)


class Waveform:
    """Base class.  Subclasses define ``_samples()`` over concrete params."""

    _param_names: tuple[str, ...] = ()

    def __init__(self, duration: Any) -> None:
        self._duration = duration

    @property
    def duration(self) -> int:
        if isinstance(self._duration, Expr):
            raise ValueError(
                "Waveform duration is still parametrized; call build() first."
            )
        return int(self._duration)

    @property
    def is_parametrized(self) -> bool:
        if isinstance(self._duration, Expr):
            return True
        return any(isinstance(getattr(self, n), Expr) for n in self._param_names)

    def build(self, values: Mapping[str, Any]) -> "Waveform":
        """Substitute variable values, returning a concrete waveform."""
        if not self.is_parametrized:
            return self
        kwargs = {n: evaluate(getattr(self, n), values) for n in self._param_names}
        dur = evaluate(self._duration, values)
        return type(self)(int(round(float(dur))), **kwargs)

    @property
    def samples(self) -> torch.Tensor:
        if self.is_parametrized:
            raise ValueError(
                "Cannot sample a parametrized waveform; call build() first."
            )
        return self._samples()

    def _samples(self) -> torch.Tensor:
        raise NotImplementedError


class ConstantWaveform(Waveform):
    """Constant-valued waveform."""

    _param_names = ("value",)

    def __init__(self, duration: Any, value: Any) -> None:
        super().__init__(duration)
        self.value = value

    def _samples(self) -> torch.Tensor:
        return _as_tensor(self.value).expand(self.duration)

    def __repr__(self) -> str:
        return f"ConstantWaveform({self._duration}, {self.value})"


class CustomWaveform(Waveform):
    """Waveform from an explicit per-ns sample array."""

    _param_names = ("_sample_arr",)

    def __init__(self, samples: Any, duration: Any = None) -> None:
        self._sample_arr = samples
        if duration is None:
            if isinstance(samples, Expr):
                raise ValueError(
                    "CustomWaveform with a variable sample array needs an "
                    "explicit duration."
                )
            duration = len(samples)
        super().__init__(duration)

    def build(self, values: Mapping[str, Any]) -> "CustomWaveform":
        if not self.is_parametrized:
            return self
        return CustomWaveform(_as_tensor(evaluate(self._sample_arr, values)))

    def _samples(self) -> torch.Tensor:
        return _as_tensor(self._sample_arr)

    def __repr__(self) -> str:
        return f"CustomWaveform(<{self._duration} samples>)"

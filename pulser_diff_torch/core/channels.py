"""Channel specifications (counterpart of pulser_diff_tpu/core/channels.py).

A channel couples a pair of atomic levels and is addressed globally (all
atoms of the register) or locally (explicit targets, retargeted with
``Sequence.target``).  The basis names follow pulser:
  - Rydberg   -> "ground-rydberg"
  - Raman     -> "digital"
  - Microwave -> "XY" (global only)
A channel carries its pulse limits, its timing constraints, its output
modulation bandwidth and, for the EOM-capable Rydberg channel, a
:class:`~.eom.RydbergEOM`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pulser_diff_torch.core.eom import _MODBW_TO_TR, RydbergEOM


@dataclass(frozen=True)
class Channel:
    name: str = ""
    addressing: str = "Global"  # "Global" | "Local"
    basis: str = "ground-rydberg"
    max_abs_detuning: Optional[float] = None  # rad/us
    max_amp: Optional[float] = None  # rad/us
    min_retarget_interval: int = 0  # ns
    fixed_retarget_t: int = 0  # ns
    max_targets: Optional[int] = None
    clock_period: int = 1  # ns
    min_duration: int = 1  # ns
    max_duration: Optional[int] = None  # ns
    mod_bandwidth: Optional[float] = None  # MHz
    eom_config: Optional[RydbergEOM] = None

    @property
    def supports_eom_mode(self) -> bool:
        return self.eom_config is not None

    def validate_pulse(self, amp_max: float, det_max: float, duration: int) -> None:
        if self.max_amp is not None and amp_max > self.max_amp + 1e-9:
            raise ValueError(
                f"Pulse amplitude {amp_max} exceeds channel maximum {self.max_amp}."
            )
        if self.max_abs_detuning is not None and det_max > self.max_abs_detuning + 1e-9:
            raise ValueError(
                f"Pulse |detuning| {det_max} exceeds channel maximum {self.max_abs_detuning}."
            )
        if duration < self.min_duration:
            raise ValueError(
                f"Pulse duration {duration} below channel minimum {self.min_duration} ns."
            )
        if self.max_duration is not None and duration > self.max_duration:
            raise ValueError(
                f"Pulse duration {duration} above channel maximum {self.max_duration} ns."
            )

    @property
    def is_global(self) -> bool:
        return self.addressing == "Global"

    @property
    def rise_time(self) -> int:
        """Rise time (90 % output) in ns: 0.48 / mod_bandwidth."""
        if self.mod_bandwidth:
            return int(_MODBW_TO_TR / self.mod_bandwidth * 1e3)
        return 0

    @property
    def fall_time(self) -> int:
        """Extra time for the output to ramp down past the programmed end:
        twice the rise time."""
        return 2 * self.rise_time

    @staticmethod
    def apply_modulation(input_samples: torch.Tensor, rise_time: int,
                         keep_ends: bool = False) -> torch.Tensor:
        """The channel's output response: convolution with a normalized
        Blackman window of width 2 rise_time.  ``keep_ends=True`` pads with
        the edge values first (detuning and phase hold their boundary
        values instead of decaying to zero).  The output is
        ``len(input) + 2 rise_time`` long; differentiable."""
        if not rise_time:
            return input_samples
        window = np.blackman(2 * rise_time)
        w = torch.as_tensor(window / np.sum(window), dtype=input_samples.dtype,
                            device=input_samples.device)
        if keep_ends:
            x = F.pad(input_samples[None, None], (2 * rise_time, 2 * rise_time),
                      mode="replicate")[0, 0]
        else:
            x = F.pad(input_samples, (rise_time, rise_time))
        # numpy's convolve(x, w, "same"): the full convolution's centre
        m = w.shape[0]
        full = F.conv1d(F.pad(x, (m - 1, m - 1))[None, None], w.flip(0)[None, None])[0, 0]
        start = (m - 1) // 2
        mod = full[start:start + x.shape[0]]
        if keep_ends:
            mod = mod[rise_time:-rise_time]
        return mod

    def modulate(self, input_samples: torch.Tensor, keep_ends: bool = False) -> torch.Tensor:
        """Modulate the input with this channel's response."""
        return self.apply_modulation(input_samples, self.rise_time, keep_ends)


class _ChannelFamily:
    basis: str = ""

    @classmethod
    def Global(cls, max_abs_detuning: Optional[float] = None,
               max_amp: Optional[float] = None, **kwargs) -> Channel:
        return Channel(name=f"{cls.__name__.lower()}_global", addressing="Global",
                       basis=cls.basis, max_abs_detuning=max_abs_detuning, max_amp=max_amp,
                       **kwargs)

    @classmethod
    def Local(cls, max_abs_detuning: Optional[float] = None,
              max_amp: Optional[float] = None, **kwargs) -> Channel:
        return Channel(name=f"{cls.__name__.lower()}_local", addressing="Local",
                       basis=cls.basis, max_abs_detuning=max_abs_detuning, max_amp=max_amp,
                       **kwargs)


class Rydberg(_ChannelFamily):
    basis = "ground-rydberg"


class Raman(_ChannelFamily):
    basis = "digital"


class Microwave(_ChannelFamily):
    basis = "XY"

    @classmethod
    def Local(cls, *args, **kwargs) -> Channel:
        raise ValueError("Microwave channels only support Global addressing.")

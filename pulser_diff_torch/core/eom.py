"""EOM-mode configuration (counterpart of pulser_diff_tpu/core/eom.py).

The two-photon Rydberg transition is driven by two beams (RED and BLUE)
through electro-optic modulators.  In EOM mode a channel emits square
pulses only (amplitude 0 or a fixed ``amp_on``, switched with the EOM's
fast rise time), and while the drive is off the atoms still see the light
shift of whichever beams stay on, so the off-detuning is one of a
discrete set.  Standard two-photon physics:

  - effective Rabi frequency  Omega = Omega_red * Omega_blue / (2 d_int)
  - per-beam light shift  +/- Omega_beam^2 / (4 d_int) (BLUE +, RED -;
    d_int the intermediate detuning)
  - beam amplitudes for a target Omega: balanced
    Omega_beam = sqrt(2 d_int Omega) while below the limiting beam's
    maximum; past it the limiting beam saturates and the other scales as
    2 d_int Omega / max_limiting_amp.

Switching off a subset of the controlled beams removes their light shift;
``detuning_off_options`` are the detunings of each switch-off
configuration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

RED = "RED"
BLUE = "BLUE"

# shared with Channel.rise_time: TR such that the output reaches 90%
_MODBW_TO_TR = 0.48


@dataclass(frozen=True)
class RydbergEOM:
    """EOM configuration of a Rydberg channel.

    mod_bandwidth: MHz — the EOM's own modulation bandwidth (used for
        rise/fall inside EOM blocks; typically 10-100x the channel's).
    limiting_beam: RED | BLUE — the beam whose amplitude saturates first.
    max_limiting_amp: rad/us — the limiting beam's maximum amplitude.
    intermediate_detuning: rad/us — detuning from the intermediate state.
    controlled_beams: the beams that can be switched off in EOM mode.
    custom_buffer_time: ns — overrides the 2x rise-time buffer inserted
        around EOM blocks.
    """

    mod_bandwidth: float
    limiting_beam: str = RED
    max_limiting_amp: float = 2 * np.pi * 10.0
    intermediate_detuning: float = 2 * np.pi * 700.0
    controlled_beams: tuple[str, ...] = (BLUE,)
    custom_buffer_time: Optional[int] = None

    def __post_init__(self) -> None:
        if self.limiting_beam not in (RED, BLUE):
            raise ValueError("limiting_beam must be RED or BLUE.")
        if not self.controlled_beams or any(
            b not in (RED, BLUE) for b in self.controlled_beams
        ):
            raise ValueError(
                "controlled_beams must be a non-empty subset of "
                "(RED, BLUE)."
            )
        if self.mod_bandwidth <= 0:
            raise ValueError("mod_bandwidth must be positive.")

    @property
    def rise_time(self) -> int:
        """EOM rise time in ns."""
        return int(_MODBW_TO_TR / self.mod_bandwidth * 1e3)

    @property
    def buffer_time(self) -> int:
        """Buffer inserted when entering/leaving EOM mode (ns)."""
        if self.custom_buffer_time is not None:
            return int(self.custom_buffer_time)
        return 2 * self.rise_time

    # ------------------------------------------------------------------
    # two-photon beam physics
    # ------------------------------------------------------------------
    def beam_amplitudes(self, rabi_frequency: float) -> dict[str, float]:
        """{RED: Omega_red, BLUE: Omega_blue} realizing ``rabi_frequency``
        (rad/us): balanced until the limiting beam saturates."""
        if rabi_frequency < 0:
            raise ValueError("rabi_frequency must be non-negative.")
        base = float(np.sqrt(2 * self.intermediate_detuning * rabi_frequency))
        if base <= self.max_limiting_amp:
            return {RED: base, BLUE: base}
        other = 2 * self.intermediate_detuning * rabi_frequency / (
            self.max_limiting_amp
        )
        out = {RED: other, BLUE: other}
        out[self.limiting_beam] = self.max_limiting_amp
        return out

    def _lightshift(self, rabi_frequency: float, *beams_on: str) -> float:
        """Net two-photon light shift with the given beams on (rad/us):
        BLUE contributes +Omega_b^2/(4 d_int), RED -Omega_r^2/(4 d_int).
        """
        amps = self.beam_amplitudes(rabi_frequency)
        sign = {BLUE: 1.0, RED: -1.0}
        return sum(
            sign[b] * amps[b] ** 2 / (4 * self.intermediate_detuning)
            for b in beams_on
        )

    def detuning_off_options(
        self, rabi_frequency: float, detuning_on: float
    ) -> np.ndarray:
        """The discrete detunings the atoms can sit at when the drive is
        off, given that ``detuning_on`` is calibrated with both beams on.
        """
        # the static offset making the on-detuning come out right
        offset = detuning_on - self._lightshift(rabi_frequency, RED, BLUE)
        all_beams = (RED, BLUE)
        if len(self.controlled_beams) == 1:
            # only one beam switchable: the other stays on
            still_on = tuple(
                b for b in all_beams if b not in self.controlled_beams
            )
            shifts = [self._lightshift(rabi_frequency, *still_on)]
        else:
            # switching off either single beam, or both
            shifts = [
                self._lightshift(rabi_frequency, other)
                for other in all_beams
            ]
            shifts.append(0.0)
        return np.array(shifts) + offset

    def calculate_detuning_off(
        self,
        amp_on: float,
        detuning_on: float,
        optimal_detuning_off: float = 0.0,
    ) -> float:
        """The achievable off-detuning closest to the requested optimum
        (what ``Sequence.enable_eom_mode`` locks in)."""
        options = self.detuning_off_options(float(amp_on), float(detuning_on))
        return float(options[np.argmin(np.abs(options - optimal_detuning_off))])

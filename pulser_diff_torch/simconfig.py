"""Noise configuration (counterpart of pulser_diff_tpu/simconfig.py).

This slice is noiseless: ``SimConfig`` and ``NoiseModel`` carry only what
the Hamiltonian reads, and any noise type raises NotImplementedError.
Noise channels, Monte-Carlo runs and SPAM are a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class NoiseModel:
    noise_types: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.noise_types:
            raise NotImplementedError(
                f"Noise types {self.noise_types} are not ported yet; the "
                "port runs noiseless simulations only."
            )


@dataclass(frozen=True)
class SimConfig:
    noise: Tuple[str, ...] = ()

    def to_noise_model(self) -> NoiseModel:
        return NoiseModel(noise_types=tuple(self.noise))

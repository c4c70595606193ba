"""Device specifications (counterpart of pulser_diff_tpu/core/devices.py).

The device supplies the interaction constants used by the Hamiltonian:
``interaction_coeff`` (C6/hbar, rad/us um^6) for the ising interaction
and ``interaction_coeff_xy`` (C3/hbar, rad/us um^3) for the XY one.
``MockDevice`` (virtual, 3D) has the global and local Rydberg and Raman
channels and the global microwave channel; ``AnalogDevice`` a global
Rydberg channel with limits, output modulation and an EOM mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pulser_diff_torch.core.channels import Channel, Microwave, Raman, Rydberg
from pulser_diff_torch.core.eom import BLUE, RED, RydbergEOM
from pulser_diff_torch.core.register import Register

# C6/hbar [rad/us um^6] per rydberg level (subset of pulser's table)
C6_DICT = {
    50: 96120.72,
    55: 297167.09,
    60: 865723.02,
    65: 2281056.86,
    70: 5420158.53,
    75: 11886839.66,
    80: 24371417.83,
}


@dataclass(frozen=True)
class Device:
    name: str
    dimensions: int = 2
    rydberg_level: int = 70
    max_atom_num: Optional[int] = None
    max_radial_distance: Optional[float] = None
    min_atom_distance: float = 0.0
    interaction_coeff_xy: Optional[float] = 3700.0
    supports_slm_mask: bool = True
    channels: tuple[Channel, ...] = ()
    is_virtual: bool = False

    @property
    def interaction_coeff(self) -> float:
        return C6_DICT[self.rydberg_level]

    @property
    def supported_bases(self) -> set[str]:
        return {ch.basis for ch in self.channels}

    @property
    def channel_objects(self) -> dict[str, Channel]:
        return {ch.name: ch for ch in self.channels}

    def validate_register(self, register: Register) -> None:
        if register.dimensionality > self.dimensions:
            raise ValueError(
                f"Register is {register.dimensionality}D but device "
                f"'{self.name}' supports {self.dimensions}D."
            )
        n = len(register)
        if self.max_atom_num is not None and n > self.max_atom_num:
            raise ValueError(
                f"Register has {n} atoms; device allows {self.max_atom_num}."
            )
        coords = register.coords_array
        if coords.requires_grad or torch.compiler.is_exporting():
            # trainable coordinates, or a trace under torch.export: the
            # geometric checks are skipped, as the JAX package skips them
            # for traced coordinates (export_step runs them eagerly first)
            return
        coords = coords.cpu().numpy()
        if self.max_radial_distance is not None:
            r = np.linalg.norm(coords, axis=-1).max()
            if r > self.max_radial_distance + 1e-9:
                raise ValueError(
                    f"Atoms lie up to {r:.2f} um from the center; device "
                    f"allows {self.max_radial_distance} um."
                )
        if self.min_atom_distance > 0 and n > 1:
            d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            if d.min() < self.min_atom_distance - 1e-9:
                raise ValueError(
                    f"Minimal inter-atom distance {d.min():.2f} um below "
                    f"device limit {self.min_atom_distance} um."
                )


MockDevice = Device(
    name="MockDevice",
    dimensions=3,
    rydberg_level=70,
    interaction_coeff_xy=3700.0,
    supports_slm_mask=True,
    is_virtual=True,
    channels=(
        Rydberg.Global(),
        Rydberg.Local(),
        Raman.Global(),
        Raman.Local(),
        Microwave.Global(),
    ),
)

VirtualDevice = MockDevice

AnalogDevice = Device(
    name="AnalogDevice",
    dimensions=2,
    rydberg_level=60,
    max_atom_num=25,
    max_radial_distance=35.0,
    min_atom_distance=5.0,
    interaction_coeff_xy=None,
    supports_slm_mask=False,
    channels=(
        Rydberg.Global(max_abs_detuning=2 * np.pi * 20, max_amp=2 * np.pi * 2,
                       clock_period=4, min_duration=16, mod_bandwidth=8.0,
                       eom_config=RydbergEOM(
                           mod_bandwidth=40.0,
                           limiting_beam=RED,
                           max_limiting_amp=2 * np.pi * 10.0,
                           intermediate_detuning=2 * np.pi * 700.0,
                           controlled_beams=(BLUE,),
                       )),
    ),
)

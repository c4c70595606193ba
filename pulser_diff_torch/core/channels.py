"""Channel specifications (counterpart of pulser_diff_tpu/core/channels.py).

The port has the global Rydberg channel (ground-rydberg basis) and the
global microwave channel (XY basis).  Local addressing, the Raman
(digital) channels, pulse limits, modulation and EOM mode are later
slices.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Channel:
    name: str = ""
    addressing: str = "Global"
    basis: str = "ground-rydberg"


class _ChannelFamily:
    basis: str = ""

    @classmethod
    def Global(cls) -> Channel:
        return Channel(name=f"{cls.__name__.lower()}_global", addressing="Global",
                       basis=cls.basis)


class Rydberg(_ChannelFamily):
    basis = "ground-rydberg"


class Microwave(_ChannelFamily):
    """Global only, as in the JAX package."""

    basis = "XY"

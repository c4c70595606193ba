"""Channel specifications (counterpart of pulser_diff_tpu/core/channels.py).

This slice ports the global Rydberg channel.  Local addressing, the Raman
(digital) and microwave (XY) channels, pulse limits, modulation and EOM
mode are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Channel:
    name: str = ""
    addressing: str = "Global"
    basis: str = "ground-rydberg"


class Rydberg:
    basis = "ground-rydberg"

    @classmethod
    def Global(cls) -> Channel:
        return Channel(name="rydberg_global", addressing="Global", basis=cls.basis)

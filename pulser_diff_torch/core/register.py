"""Atom register (counterpart of pulser_diff_tpu/core/register.py).

Coordinates (um) are f64 tensors; the Hamiltonian moves them to the
emulator's device.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import torch

from pulser_diff_torch.config import DTYPE

QubitId = Any


class Register:
    """Associates qubit ids to 2D (or 3D) coordinates in um."""

    def __init__(self, qubits: Mapping[QubitId, Any]) -> None:
        if not qubits:
            raise ValueError("Register cannot be empty.")
        self._coords: dict[QubitId, torch.Tensor] = {
            qid: (c.to(DTYPE) if isinstance(c, torch.Tensor)
                  else torch.as_tensor(c, dtype=DTYPE))
            for qid, c in qubits.items()
        }
        dims = {int(v.shape[-1]) for v in self._coords.values()}
        if len(dims) != 1:
            raise ValueError("All coordinates must have the same dimension.")
        self._dim = dims.pop()

    @property
    def qubits(self) -> dict[QubitId, torch.Tensor]:
        return dict(self._coords)

    @property
    def qubit_ids(self) -> tuple[QubitId, ...]:
        return tuple(self._coords.keys())

    @property
    def dimensionality(self) -> int:
        return self._dim

    def __len__(self) -> int:
        return len(self._coords)

    @property
    def coords_array(self) -> torch.Tensor:
        """(n_qubits, dim) stacked coordinates, in declaration order."""
        return torch.stack(list(self._coords.values()))

    @classmethod
    def from_coordinates(
        cls,
        coords: Iterable[Any],
        prefix: str | None = None,
        labels: Iterable[QubitId] | None = None,
    ) -> "Register":
        coords = list(coords)
        if labels is not None:
            ids = list(labels)
            if len(ids) != len(coords):
                raise ValueError("Label count must match coordinate count.")
        elif prefix is not None:
            ids = [f"{prefix}{i}" for i in range(len(coords))]
        else:
            ids = list(range(len(coords)))
        return cls(dict(zip(ids, coords)))

    def __repr__(self) -> str:
        return f"Register({self._coords})"

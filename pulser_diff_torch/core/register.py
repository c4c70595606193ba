"""Atom register (counterpart of pulser_diff_tpu/core/register.py).

Coordinates (um) are f64 tensors; the Hamiltonian moves them to the
emulator's device.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from pulser_diff_torch.config import default_dtype

QubitId = Any


class Register:
    """Associates qubit ids to 2D (or 3D) coordinates in um."""

    def __init__(self, qubits: Mapping[QubitId, Any]) -> None:
        if not qubits:
            raise ValueError("Register cannot be empty.")
        self._coords: dict[QubitId, torch.Tensor] = {
            qid: (c.to(default_dtype()) if isinstance(c, torch.Tensor)
                  else torch.as_tensor(c, dtype=default_dtype()))
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
        center: bool = False,
    ) -> "Register":
        coords = list(coords)
        if center:
            arr = torch.stack([torch.as_tensor(c, dtype=default_dtype()) for c in coords])
            arr = arr - arr.mean(dim=0)
            coords = list(arr)
        if labels is not None:
            ids = list(labels)
            if len(ids) != len(coords):
                raise ValueError("Label count must match coordinate count.")
        elif prefix is not None:
            ids = [f"{prefix}{i}" for i in range(len(coords))]
        else:
            ids = list(range(len(coords)))
        return cls(dict(zip(ids, coords)))

    @classmethod
    def rectangle(cls, rows: int, columns: int, spacing: float = 4.0,
                  prefix: str | None = None) -> "Register":
        xs, ys = np.meshgrid(np.arange(columns), np.arange(rows))
        coords = np.stack([xs.ravel(), ys.ravel()], axis=-1) * spacing
        return cls.from_coordinates(coords - coords.mean(axis=0), prefix=prefix)

    @classmethod
    def square(cls, side: int, spacing: float = 4.0, prefix: str | None = None) -> "Register":
        return cls.rectangle(side, side, spacing, prefix)

    @classmethod
    def linear(cls, n: int, spacing: float = 4.0, prefix: str | None = None) -> "Register":
        coords = np.stack([np.arange(n) * spacing, np.zeros(n)], axis=-1)
        return cls.from_coordinates(coords - coords.mean(axis=0), prefix=prefix)

    @classmethod
    def triangular_lattice(cls, rows: int, atoms_per_row: int, spacing: float = 4.0,
                           prefix: str | None = None) -> "Register":
        coords = [((c + 0.5 * (r % 2)) * spacing, r * spacing * np.sqrt(3) / 2)
                  for r in range(rows) for c in range(atoms_per_row)]
        arr = np.asarray(coords)
        return cls.from_coordinates(arr - arr.mean(axis=0), prefix=prefix)

    @staticmethod
    def _hex_ring(ring: int) -> list:
        """The 6 ring triangular-lattice points at hex distance ``ring`` from
        the origin (axial coordinates (i, j), basis a = (1, 0),
        b = (1/2, sqrt(3)/2); ring = max(|i|, |j|, |i + j|)), sorted by
        angle."""
        a = np.array([1.0, 0.0])
        b = np.array([0.5, np.sqrt(3) / 2])
        pts = [i * a + j * b
               for i in range(-ring, ring + 1) for j in range(-ring, ring + 1)
               if max(abs(i), abs(j), abs(i + j)) == ring]
        pts.sort(key=lambda p: np.arctan2(p[1], p[0]))
        return pts

    @classmethod
    def hexagon(cls, layers: int, spacing: float = 4.0, prefix: str | None = None) -> "Register":
        """A central atom plus ``layers`` full rings on the triangular
        lattice (1 + 3 L (L + 1) atoms)."""
        if layers < 1:
            raise ValueError("hexagon needs at least one layer.")
        pts = [np.zeros(2)]
        for ring in range(1, layers + 1):
            pts.extend(cls._hex_ring(ring))
        arr = np.asarray(pts) * spacing
        return cls.from_coordinates(arr - arr.mean(axis=0), prefix=prefix)

    @classmethod
    def max_connectivity(cls, n_qubits: int, device, spacing: float | None = None,
                         prefix: str | None = None) -> "Register":
        """The first ``n_qubits`` sites of a triangular lattice at the
        device's minimal atom distance, spiralling out from the center."""
        if n_qubits < 1:
            raise ValueError("Need at least one qubit.")
        if spacing is None:
            spacing = float(device.min_atom_distance)
            if spacing <= 0:
                raise ValueError(
                    f"Device '{device.name}' has no minimal atom distance; "
                    "pass an explicit spacing."
                )
        elif spacing < float(device.min_atom_distance):
            raise ValueError(
                f"spacing {spacing} below the device minimum {device.min_atom_distance}."
            )
        pts = [np.zeros(2)]
        ring = 1
        while len(pts) < n_qubits:
            pts.extend(cls._hex_ring(ring))
            ring += 1
        arr = np.asarray(pts[:n_qubits]) * spacing
        return cls.from_coordinates(arr - arr.mean(axis=0), prefix=prefix)

    @classmethod
    def cuboid(cls, rows: int, columns: int, layers: int, spacing: float = 4.0,
               prefix: str | None = None) -> "Register":
        """3D grid of rows x columns x layers atoms."""
        zs, ys, xs = np.meshgrid(np.arange(layers), np.arange(rows), np.arange(columns),
                                 indexing="ij")
        coords = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=-1) * spacing
        return cls.from_coordinates(coords - coords.mean(axis=0), prefix=prefix)

    @classmethod
    def cubic(cls, side: int, spacing: float = 4.0, prefix: str | None = None) -> "Register":
        """side^3 cubic lattice."""
        return cls.cuboid(side, side, side, spacing, prefix)

    def rotated(self, degrees: float) -> "Register":
        """New register with all coordinates rotated counterclockwise around
        the origin (2D only)."""
        if self._dim != 2:
            raise ValueError("rotated() only applies to 2D registers.")
        th = np.deg2rad(degrees)
        rot = torch.as_tensor([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                              dtype=default_dtype())
        return Register({qid: rot.to(c.device) @ c for qid, c in self._coords.items()})

    def with_coords(self, coords: Mapping[QubitId, Any]) -> "Register":
        """New register with (a subset of) coordinates replaced."""
        return Register({**self._coords, **coords})

    def draw(self, blockade_radius: float | None = None, draw_half_radius: bool = False,
             fig_name: str | None = None, kwargs_savefig: dict = {}) -> None:
        """Scatter-plot the register with qubit-id labels (pulser's
        ``Register.draw``); optionally circle each atom at half the
        blockade radius so overlapping circles mark blockaded pairs."""
        import matplotlib.pyplot as plt

        from pulser_diff_torch.core.drawing import to_host

        coords = to_host(self.coords_array)
        if self._dim != 2:
            raise NotImplementedError("draw() only supports 2D registers.")
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(coords[:, 0], coords[:, 1], s=60, color="darkgreen")
        for qid, c in zip(self.qubit_ids, coords):
            ax.annotate(str(qid), c, textcoords="offset points", xytext=(6, 6), fontsize=9)
        if blockade_radius is not None and draw_half_radius:
            for c in coords:
                ax.add_patch(plt.Circle(tuple(c), blockade_radius / 2, fill=True, alpha=0.1,
                                        color="darkgreen"))
        ax.set_xlabel("x (µm)")
        ax.set_ylabel("y (µm)")
        ax.set_aspect("equal")
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        plt.show()

    def __repr__(self) -> str:
        return f"Register({self._coords})"

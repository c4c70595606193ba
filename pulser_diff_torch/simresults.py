"""Simulation results (counterpart of pulser_diff_tpu/simresults.py).

The port has the coherent results: the states at every evaluation time
and their expectation values, in the ground-rydberg or the XY basis.
"""

from __future__ import annotations

import typing

import numpy as np

from pulser_diff_torch.config import DTYPE
from pulser_diff_torch.cplx import Cplx, as_cplx, cstack
from pulser_diff_torch.ops.linalg import expect as _expect
from pulser_diff_torch.result import QuantumResult


class CoherentResults:
    """Results of a deterministic (state-resolving) simulation."""

    def __init__(
        self,
        run_output: typing.Sequence[QuantumResult],
        size: int,
        basis_name: str,
        sim_times: np.ndarray,
    ) -> None:
        if basis_name not in ("ground-rydberg", "XY"):
            raise ValueError("Only the 'ground-rydberg' and 'XY' bases are ported.")
        self._dim = 2
        self._size = size
        self._basis_name = basis_name
        self._sim_times = sim_times
        self._results = tuple(run_output)

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> QuantumResult:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def states(self) -> Cplx:
        """(n_eval, dim, nb) states at every evaluation time."""
        return cstack([res.state for res in self])

    def get_final_state(self) -> Cplx:
        return self._results[-1].state

    def expect(self, obs_list: typing.Sequence) -> list[Cplx]:
        """Expectation values of each observable over time; a 1-D
        observable of shape (dim**size,) is its diagonal."""
        if not isinstance(obs_list, (list, tuple)):
            raise TypeError("`obs_list` must be a list of operators.")
        legal = (self._dim**self._size, self._dim**self._size)
        out = []
        for obs in obs_list:
            obs = as_cplx(obs, dtype=DTYPE)
            if obs.shape not in (legal, legal[:1]):
                raise ValueError(
                    f"Incompatible shape of observable. Expected {legal} or "
                    f"{legal[:1]}, got {obs.shape}."
                )
            out.append(_expect(obs, self.states))
        return out

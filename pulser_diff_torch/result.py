"""One evaluation time's result (counterpart of pulser_diff_tpu/result.py).

This slice keeps the state; bitstring sampling and measurement-basis
reductions are a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from pulser_diff_torch.cplx import Cplx


@dataclass
class QuantumResult:
    """State at one evaluation time: a (dim, nb) ket batch."""

    atom_order: tuple
    meas_basis: str
    state: Cplx

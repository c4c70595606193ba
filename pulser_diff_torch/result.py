"""One evaluation time's result: state, measurement weights and sampling
(counterpart of pulser_diff_tpu/result.py).

The bitstring probabilities follow the JAX package: in the ground-rydberg
basis the state index has r first, so it is flipped into bit order (r is
bit 1); in a non-matching measurement basis every shot reads all zeros.
Systems with more than two levels a site (the 'all' and leakage bases)
are not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pulser_diff_torch.cplx import Cplx


@dataclass
class QuantumResult:
    """State at one evaluation time: a (dim, nb) ket batch (nb = 1 for
    the weights and samples)."""

    atom_order: tuple
    meas_basis: str
    state: Cplx
    matching_meas_basis: bool = True
    basis_labels: Optional[tuple] = None  # set for leakage-extended bases

    @property
    def _size(self) -> int:
        return len(self.atom_order)

    @property
    def _dim(self) -> int:
        full = int(np.prod(self.state.shape))
        if self.state.shape[-1] != 1 and self.state.ndim == 2 and \
           self.state.shape[0] == self.state.shape[1]:
            full = int(round(full**0.5))
        return int(round(full ** (1 / self._size)))

    @property
    def _basis_name(self) -> str:
        if self._dim > 2:
            return "all"
        if self.meas_basis == "XY":
            return "XY"
        if not self.matching_meas_basis:
            return "digital" if self.meas_basis == "ground-rydberg" else "ground-rydberg"
        return self.meas_basis

    @property
    def sampling_errors(self) -> dict[str, float]:
        return {b: 0.0 for b in self.sampling_dist}

    def _weights(self) -> torch.Tensor:
        """Measurement probabilities per bitstring (2^n,), differentiable."""
        st = self.state
        if st.ndim == 2 and st.shape[0] == st.shape[1] and st.shape[0] > 1:
            probs = torch.diagonal(st.re).abs()  # a density matrix's diagonal is real
        else:
            probs = st.abs2().reshape(-1)
        if self._dim != 2:
            raise NotImplementedError(
                "Measurement weights of systems with more than two levels a site are not "
                "ported yet (ROADMAP queue 1 item 8).")
        if self.matching_meas_basis:
            # ground-rydberg ordering has r first: flip to bit order
            weights = torch.flip(probs, (0,)) if self.meas_basis == "ground-rydberg" else probs
        else:
            weights = torch.zeros_like(probs)
            weights[0] = 1.0
        return weights / weights.sum()

    @property
    def sampling_dist(self) -> dict[str, float]:
        w = self._weights().detach().cpu().numpy()
        n = self._size
        return {np.binary_repr(i, width=n): float(w[i]) for i in np.nonzero(w)[0]}

    def get_samples(self, n_samples: int, rng: Optional[np.random.Generator] = None) -> Counter:
        """Sample bitstrings from the measurement distribution (numpy
        generator, as in the JAX package)."""
        rng = rng or np.random.default_rng()
        w = self._weights().detach().cpu().numpy()
        w = np.clip(w, 0, None)
        w = w / w.sum()
        n = self._size
        counts = rng.multinomial(n_samples, w)
        return Counter(
            {np.binary_repr(i, width=n): int(c) for i, c in enumerate(counts) if c > 0}
        )

    def get_state(
        self,
        reduce_to_basis: Optional[str] = None,
        ignore_global_phase: bool = True,
        tol: float = 1e-6,
        normalize: bool = True,
    ) -> Cplx:
        """The state, with its global phase removed (the phase of its
        largest amplitude) unless ``ignore_global_phase=False``.  A
        reduction to another basis needs three levels a site, which are
        not ported yet (ROADMAP queue 1 item 8)."""
        st = self.state
        is_dm = st.ndim == 2 and st.shape[0] == st.shape[1] and st.shape[0] > 1
        if ignore_global_phase and not is_dm:
            flat = st.reshape(-1)
            a2 = flat.abs2()
            idx = torch.argmax(a2)
            mag = torch.sqrt(a2[idx])
            safe = torch.where(mag > 0, mag, torch.ones_like(mag))
            st = st * Cplx(flat.re[idx] / safe, -flat.im[idx] / safe)
        if reduce_to_basis not in (None, self._basis_name):
            raise TypeError(
                f"Can't reduce a system in {self._basis_name} to the {reduce_to_basis} basis."
            )
        return st

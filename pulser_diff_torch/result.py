"""One evaluation time's result: state, measurement weights and sampling
(counterpart of pulser_diff_tpu/result.py).

The bitstring probabilities follow the JAX package: in the ground-rydberg
basis the state index has r first, so it is flipped into bit order (r is
bit 1); in a non-matching measurement basis every shot reads all zeros.
With three or four levels a site (the all basis, the leakage-extended
bases) a 0/1 projection maps each state to its bitstring: the
measurement basis' bright level ('r', 'h' or 'd') reads 1, every other
level, the dark one included, reads 0.  ``get_state`` reduces an
all-basis state to the ground-rydberg or the digital basis.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from pulser_diff_torch.cplx import Cplx


def _digits(n: int, d: int) -> np.ndarray:
    """(d^n, n) base-d digits of every state index, the first site first."""
    rem = np.arange(d**n)
    digits = np.zeros((d**n, n), dtype=np.int64)
    for k in range(n - 1, -1, -1):
        digits[:, k] = rem % d
        rem //= d
    return digits


@lru_cache
def _level_projection_matrix(n: int, d: int, one_state: int) -> np.ndarray:
    """(2^n, d^n) 0/1 matrix P with P[b, s] = 1 iff the d-level state s
    maps to bitstring b: digit ``one_state`` -> bit 1, any other digit (a
    leakage level included) -> bit 0."""
    bits = (_digits(n, d) == one_state).astype(np.int64)
    b_of_s = np.zeros(d**n, dtype=np.int64)
    for k in range(n):
        b_of_s = b_of_s * 2 + bits[:, k]
    P = np.zeros((2**n, d**n))
    P[b_of_s, np.arange(d**n)] = 1.0
    return P


def _three_level_projection_matrix(n: int, one_state: int, ex0: int, ex1: int) -> np.ndarray:
    """The 3-level projection (the other two levels read 0)."""
    return _level_projection_matrix(n, 3, one_state)


# measurement "bright" label per basis (bit value 1)
_ONE_LABEL = {"ground-rydberg": "r", "digital": "h", "XY": "d"}


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
        if self._dim == 2:
            if self.matching_meas_basis:
                # ground-rydberg ordering has r first: flip to bit order
                weights = (torch.flip(probs, (0,)) if self.meas_basis == "ground-rydberg"
                           else probs)
            else:
                weights = torch.zeros_like(probs)
                weights[0] = 1.0
        elif self._dim in (3, 4):
            if self.basis_labels is not None:
                labels = list(self.basis_labels)
            elif self._dim == 3:
                labels = ["r", "g", "h"]  # the all basis
            else:
                raise NotImplementedError("4-level states need explicit basis_labels.")
            one_label = _ONE_LABEL.get(self.meas_basis)
            if one_label is None or one_label not in labels:
                raise RuntimeError(
                    f"Unknown measurement basis '{self.meas_basis}' for a {self._dim}-level "
                    "system.")
            P = torch.as_tensor(
                _level_projection_matrix(self._size, self._dim, labels.index(one_label)),
                dtype=probs.dtype, device=probs.device)
            weights = P @ probs
        else:
            raise NotImplementedError("Cannot sample systems with single-atom dimension > 4.")
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
        largest amplitude) unless ``ignore_global_phase=False``.  An
        all-basis state (ket or density matrix) reduces to the
        ground-rydberg basis (no 'h') or the digital basis (no 'r') when
        the population it drops is at most ``tol``, renormalised unless
        ``normalize=False``; any other reduction raises."""
        st = self.state
        is_dm = st.ndim == 2 and st.shape[0] == st.shape[1] and st.shape[0] > 1
        if ignore_global_phase and not is_dm:
            flat = st.reshape(-1)
            a2 = flat.abs2()
            idx = torch.argmax(a2)
            mag = torch.sqrt(a2[idx])
            safe = torch.where(mag > 0, mag, torch.ones_like(mag))
            st = st * Cplx(flat.re[idx] / safe, -flat.im[idx] / safe)
        if reduce_to_basis is None or self._dim != 3:
            if reduce_to_basis not in (None, self._basis_name):
                raise TypeError(
                    f"Can't reduce a system in {self._basis_name} to the {reduce_to_basis} "
                    "basis.")
            return st
        if reduce_to_basis == "ground-rydberg":
            ex_digit = 2  # |h>
        elif reduce_to_basis == "digital":
            ex_digit = 0  # |r>
        else:
            raise ValueError("'reduce_to_basis' must be 'ground-rydberg' or 'digital', not "
                             f"'{reduce_to_basis}'.")
        n = self._size
        has_ex = (_digits(n, 3) == ex_digit).any(axis=1)
        keep = torch.as_tensor(np.where(~has_ex)[0], device=st.re.device)
        drop = torch.as_tensor(has_ex, device=st.re.device)
        msg = ("Can't reduce to chosen basis because the population of a state to eliminate "
               "is above the allowed tolerance.")
        if is_dm:
            if float(torch.diagonal(st.re)[drop].sum()) > tol:
                raise TypeError(msg)
            red = Cplx(st.re[keep][:, keep], st.im[keep][:, keep])
            if normalize:
                tr = torch.trace(red.re)
                red = red * (1.0 / torch.where(tr > 0, tr, torch.ones_like(tr)))
            return red
        flat = st.reshape(-1)
        if float(flat.abs2()[drop].sum()) > tol:
            raise TypeError(msg)
        red = flat[keep]
        if normalize:
            nrm = torch.sqrt(red.abs2().sum())
            red = red * (1.0 / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
        return red.reshape(2**n, 1)

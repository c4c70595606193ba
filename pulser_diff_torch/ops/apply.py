"""Factorized Hamiltonian application (counterpart of pulser_diff_tpu/ops/apply.py).

The N-qudit state is a (d^a, d^b) split-complex matrix Psi, and

    H(t) = Hrow(t) (x) I  +  I (x) Hcol(t)  +  diag(U)

with Hrow, Hcol assembled from static stacks of real part matrices and
complex coefficient streams.  This slice ports the ising path: no kron
pairs (the XY flip-flop terms are a later slice).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pulser_diff_torch.cplx import Cplx


class FactoredHamiltonian(NamedTuple):
    """The factorized Hamiltonian terms (real part stacks, complex streams)."""

    row_parts: torch.Tensor  # (Pr, da, da) real
    col_parts: torch.Tensor  # (Pc, db, db) real
    row_streams: Cplx  # (Pr, Ts)
    col_streams: Cplx  # (Pc, Ts)
    int_diag: torch.Tensor  # (da, db) real static diagonal (vdW)
    sample_dt: float  # us between stream samples
    n_samples: int  # Ts

    @property
    def da(self) -> int:
        return self.row_parts.shape[-1]

    @property
    def db(self) -> int:
        return self.col_parts.shape[-1]

    @property
    def dim(self) -> int:
        return self.da * self.db


def interp_streams(h: FactoredHamiltonian, t: torch.Tensor):
    """Linearly interpolate all coefficient streams at times ``t`` (us).

    Follows the JAX package's index rule, which departs from upstream's:
    the full grid is interpolated (idx2 = idx1 + 1 <= Ts-1), so the last
    sample is read.  Returns (zr, zc) with leading axes = t.shape and the
    part axis last (the JAX package's third stream, for kron pairs, is
    not ported yet).
    """
    Ts = h.n_samples
    dt = h.sample_dt
    idx1 = torch.clamp(torch.floor(t / dt).to(torch.int64), 0, Ts - 2)
    idx2 = idx1 + 1
    w = (t - idx1.to(t.dtype) * dt) / dt

    def _take(streams: Cplx) -> Cplx:
        out = []
        for s in (streams.re, streams.im):
            s1 = s[:, idx1]  # (P, ...)
            s2 = s[:, idx2]
            z = s1 + (s2 - s1) * w
            out.append(z.movedim(0, -1))
        return Cplx(*out)

    return _take(h.row_streams), _take(h.col_streams)


def assemble_side(parts: torch.Tensor, z: Cplx, transpose: bool = False) -> Cplx:
    """Hermitian side matrix H = sum_p z_p P_p + h.c. (parts real);
    ``transpose=True`` returns H^T (= conj(H))."""
    a_re = torch.einsum("p,pij->ij", z.re, parts)
    a_im = torch.einsum("p,pij->ij", z.im, parts)
    h_re = a_re + a_re.T
    h_im = a_im - a_im.T
    if transpose:
        return Cplx(h_re, -h_im)
    return Cplx(h_re, h_im)


def h_apply_batched(h: FactoredHamiltonian, zr: Cplx, zc: Cplx, psi: Cplx) -> Cplx:
    """H(t) @ psi for a batched state (nb, da, db)."""
    hr = assemble_side(h.row_parts, zr)
    gc = assemble_side(h.col_parts, zc, transpose=True)
    x, y = psi.re, psi.im
    rx = hr.re @ x - hr.im @ y
    ry = hr.re @ y + hr.im @ x
    cx = x @ gc.re - y @ gc.im
    cy = x @ gc.im + y @ gc.re
    return Cplx(rx + cx + h.int_diag * x, ry + cy + h.int_diag * y)

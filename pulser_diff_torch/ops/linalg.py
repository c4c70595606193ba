"""Tensor utilities (counterpart of pulser_diff_tpu/ops/linalg.py).

``kron``, the Pauli and Hadamard constants, ``basis_state``, ``expect``
(kets, density matrices and batches of them, and 1-D diagonal
observables), ``trace``, ``vn_entropy``, ``total_magnetization`` (and its
diagonal), the sine easing ``s`` and ``interpolate_sine``.
"""

from __future__ import annotations

from functools import lru_cache, reduce
from math import pi, prod, sin

import numpy as np
import torch

from pulser_diff_torch.config import DeviceLike, default_dtype, resolve_device
from pulser_diff_torch.cplx import Cplx, as_cplx, ckron

IMAT = as_cplx(np.eye(2))
XMAT = as_cplx(np.array([[0, 1], [1, 0]]))
YMAT = as_cplx(np.array([[0, -1j], [1j, 0]]))
ZMAT = as_cplx(np.array([[1, 0], [0, -1]]))
HMAT = as_cplx(np.array([[1, 1], [1, -1]]) / np.sqrt(2.0))


def kron(*args) -> Cplx:
    """Dense Kronecker product of any number of (split-)complex matrices."""
    return reduce(ckron, [as_cplx(a, dtype=default_dtype()) for a in args])


@lru_cache
def _total_magnetization_diag_np(n_qubits: int) -> np.ndarray:
    # diag(sum_i Z_i) over the computational basis: zero bits - one bits
    idx = np.arange(2**n_qubits, dtype=np.int64)
    ones = np.zeros(2**n_qubits, dtype=np.int64)
    for b in range(n_qubits):
        ones += (idx >> b) & 1
    return (n_qubits - 2 * ones).astype(np.float64)


def total_magnetization_diag(n_qubits: int, device: DeviceLike = None) -> torch.Tensor:
    """The diagonal of sum_i Z_i, on ``device`` (CUDA unless given)."""
    return torch.as_tensor(_total_magnetization_diag_np(n_qubits), dtype=default_dtype(),
                           device=resolve_device(device))


def total_magnetization(
    n_qubits: int, dense: bool | None = None, device: DeviceLike = None
) -> Cplx:
    """sum_i Z_i: the dense diagonal matrix up to 12 qubits, else (or with
    ``dense=False``) its 1-D diagonal, which ``expect`` accepts; on
    ``device`` (CUDA unless given)."""
    d = total_magnetization_diag(n_qubits, device)
    if dense is None:
        dense = n_qubits <= 12
    if not dense:
        return Cplx(d, torch.zeros_like(d))
    return Cplx(torch.diag(d),
                torch.zeros(d.shape[0], d.shape[0], dtype=default_dtype(), device=device))


def expect(obs: Cplx, states: Cplx) -> Cplx:
    """Expectation values of ``obs`` over a time batch of states.

    ``states``: kets (n_t, dim, n_batch), or (n_t, dim) promoted to
    (n_t, dim, 1), the batch columns summed as in the reference; density
    matrices (n_t, dim, dim), tr(O rho) (Lindblad states and the
    pseudo-densities of sampled results); or a density-matrix batch
    (n_t, dim, dim, n_batch), sum_k tr(O rho_k).  A 1-D ``obs`` of shape
    (dim,) is the diagonal operator diag(obs).
    """
    obs = as_cplx(obs, dtype=default_dtype()).to(device=states.device)
    if states.ndim == 2 and states.shape[-1] != states.shape[-2]:
        states = states.reshape(states.shape + (1,))
    if states.ndim == 4:
        states = states.sum(axis=-1)
    if states.ndim != 3:
        raise ValueError(f"Unsupported states shape {states.shape}")
    if states.shape[-1] == states.shape[-2]:
        # f32 density matrices against an f64 observable: promoted for the
        # contraction, as jnp.einsum promotes
        dt = torch.promote_types(states.dtype, obs.dtype)
        states, obs = states.to(dt), obs.to(dt)
        if obs.ndim == 1:
            # tr(diag(d) rho) = sum_j d_j rho_jj
            rr = torch.diagonal(states.re, dim1=-2, dim2=-1)
            ri = torch.diagonal(states.im, dim1=-2, dim2=-1)
            return Cplx(rr @ obs.re - ri @ obs.im, ri @ obs.re + rr @ obs.im)
        # tr(O rho) = sum_ij O_ij rho_ji: each rho flattened against O^T,
        # as products of explicit views (an einsum saves reshapes of its
        # own, which a torch.export trace calling torch.autograd.grad does
        # not follow)
        o_re, o_im = (o.T.reshape(-1) for o in (obs.re, obs.im))
        s_re, s_im = (s.reshape(s.shape[0], -1) for s in (states.re, states.im))
        return Cplx(s_re @ o_re - s_im @ o_im, s_im @ o_re + s_re @ o_im)
    sh = states.sum(axis=-1)  # (n_t, dim)
    if obs.ndim == 1:
        # |s_j|^2 in the states' dtype, promoted for the contraction (as
        # jnp.einsum promotes f32 states against an f64 observable)
        p = sh.re * sh.re + sh.im * sh.im
        dt = torch.promote_types(p.dtype, obs.dtype)
        return Cplx(p.to(dt) @ obs.re.to(dt), p.to(dt) @ obs.im.to(dt))
    dt = torch.promote_types(sh.dtype, obs.dtype)
    sh, obs = sh.to(dt), obs.to(dt)
    # <s|O|s> = sum_jk conj(s_j) O_jk s_k
    ar = sh.re @ obs.re  # (n_t, dim): sum_j s_j O_jk
    ai = sh.im @ obs.re
    br = sh.re @ obs.im
    bi = sh.im @ obs.im
    re = ((ar + bi) * sh.re + (ai - br) * sh.im).sum(-1)
    im = ((br - ai) * sh.re + (ar + bi) * sh.im).sum(-1)
    return Cplx(re, im)


def trace(mat: Cplx) -> Cplx:
    """Trace over the last two axes."""
    return Cplx(torch.diagonal(mat.re, dim1=-2, dim2=-1).sum(-1),
                torch.diagonal(mat.im, dim1=-2, dim2=-1).sum(-1))


def vn_entropy(rho: Cplx) -> torch.Tensor:
    """Von Neumann entropy (bits) of a density matrix, from the spectrum
    of the real symmetric embedding [[re, -im], [im, re]], which holds
    each eigenvalue of rho twice (as the JAX package computes it)."""
    emb = torch.cat([torch.cat([rho.re, -rho.im], -1), torch.cat([rho.im, rho.re], -1)], -2)
    ev = torch.linalg.eigvalsh(emb)[..., ::2]
    keep = ev > 1e-30
    safe = torch.where(keep, ev, torch.ones_like(ev))
    return torch.where(keep, -ev * torch.log2(safe), torch.zeros_like(ev)).sum(-1)


def basis_state(dim: int | tuple[int, ...], number: int | tuple[int, ...],
                device: DeviceLike = None) -> Cplx:
    """Ket of a Fock state / tensor product of Fock states, shape (n, 1),
    on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    dim = (dim,) if isinstance(dim, int) else dim
    number = (number,) if isinstance(number, int) else number
    if len(dim) != len(number):
        raise ValueError(
            f"Arguments `number` must have the same length as `dim` of "
            f"length {len(dim)}, but has length {len(number)}."
        )
    n = 0
    for d, s_ in zip(dim, number):
        n = d * n + s_
    ket = np.zeros((prod(dim), 1))
    ket[n] = 1.0
    return as_cplx(ket, dtype=default_dtype(), device=device)


def s(t: float) -> float:
    """Sine easing in [0, 1]."""
    return (1 + sin((pi * t - (pi / 2)))) / 2


@lru_cache
def _interpolate_sine_np(num_values: int, duration: int) -> np.ndarray:
    step_size = duration / (num_values + 1)
    mat = np.zeros((duration, num_values))
    for k in range(duration):
        idx, r = divmod(k, step_size)
        idx = int(idx)
        h = r / step_size
        if idx > 0:
            mat[k, idx - 1] = 1 - s(h)
        if idx < num_values:
            mat[k, idx] = s(h)
    return mat


def interpolate_sine(num_values: int, duration: int, device: DeviceLike = None) -> torch.Tensor:
    """(duration, num_values) sine-interpolation weight matrix on
    ``device`` (CUDA unless given); the caller applies it as
    ``interpolate_sine(n, T) @ values``."""
    device = resolve_device(device)
    return torch.as_tensor(
        _interpolate_sine_np(num_values, duration), dtype=default_dtype(), device=device
    )

"""Carry state across from the JAX package as numpy arrays.

The port imports nothing of the JAX package; callers that hold both
(tests, migration scripts) convert the JAX arrays with ``np.asarray``
and hand them to these builders, so both packages see the same inputs.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pulser_diff_torch.config import DeviceLike, resolve_device
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops.apply import FactoredHamiltonian


def _tensor(x: Any, device: DeviceLike) -> torch.Tensor:
    """An f64 copy of an array (JAX hands out read-only buffers)."""
    return torch.tensor(np.array(x, dtype=np.float64), dtype=torch.float64, device=device)


def _cplx(pair: Any, device: DeviceLike) -> Cplx:
    re, im = pair
    return Cplx(_tensor(re, device), _tensor(im, device))


def factored_from_numpy(
    *,
    row_parts: Any,
    col_parts: Any,
    row_streams: Any,
    col_streams: Any,
    int_diag: Any,
    sample_dt: Any,
    n_samples: int,
    kron_row: Any = None,
    kron_col: Any = None,
    kron_streams: Any = None,
    device: DeviceLike = None,
) -> FactoredHamiltonian:
    """The port's FactoredHamiltonian from the JAX one's fields, on
    ``device`` (CUDA unless given).

    ``row_streams`` / ``col_streams`` / ``kron_streams`` are (re, im)
    pairs of (P, Ts) arrays; the JAX ``Cplx`` is such a pair.  The kron
    fields (XY) are None for an ising Hamiltonian."""
    device = resolve_device(device)
    kron = kron_row is not None
    return FactoredHamiltonian(
        row_parts=_tensor(row_parts, device),
        col_parts=_tensor(col_parts, device),
        row_streams=_cplx(row_streams, device),
        col_streams=_cplx(col_streams, device),
        int_diag=_tensor(int_diag, device),
        sample_dt=float(np.asarray(sample_dt)),
        n_samples=int(n_samples),
        kron_row=_tensor(kron_row, device) if kron else None,
        kron_col=_tensor(kron_col, device) if kron else None,
        kron_streams=_cplx(kron_streams, device) if kron else None,
    )


def params_from_numpy(
    params: Mapping[str, Any], device: DeviceLike = None, requires_grad: bool = False
) -> dict[str, torch.Tensor]:
    """A JAX ``QuantumModel.params`` dict as the port's parameter dict
    (f64 tensors on ``device``, CUDA unless given), ready for
    ``expectation_fn(obs)(params)``."""
    device = resolve_device(device)
    return {
        name: _tensor(v, device).requires_grad_(requires_grad)
        for name, v in params.items()
    }


def collapse_from_numpy(sites: Any, ops: Any, device: DeviceLike = None):
    """The port's CollapseOps from the JAX one's fields: the site of each
    operator and the (re, im) pair of its (M, d, d) stack (None without
    Lindblad noise), on ``device`` (CUDA unless given)."""
    from pulser_diff_torch.hamiltonian import CollapseOps

    device = resolve_device(device)
    return CollapseOps(tuple(int(s) for s in sites),
                       None if ops is None else _cplx(ops, device))

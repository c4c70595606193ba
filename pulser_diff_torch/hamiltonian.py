"""Time-dependent Rydberg Hamiltonian assembly (counterpart of
pulser_diff_tpu/hamiltonian.py).

The sampled sequence becomes a :class:`FactoredHamiltonian`: static
stacks of small real part matrices (row-group / column-group lifts) plus
complex coefficient streams, and the van der Waals diagonal on the
(da, db) grid.  Physics as in the JAX package:
  - amplitude coeff 0.5*amp*exp(-i*phase) on the lowering op, hermitized;
  - detuning coeff -0.5*det on the occupation projector, hermitized;
  - van der Waals C6/r^6 n_i n_j.
This slice is noiseless, global and ising-only: the ground-rydberg basis
of the global Rydberg channel (no local channels, other bases or XY kron
pairs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pulser_diff_torch.config import DTYPE
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.register import QubitId
from pulser_diff_torch.core.sampler import SequenceSamples
from pulser_diff_torch.ops.apply import FactoredHamiltonian
from pulser_diff_torch.simconfig import NoiseModel

# the ground-rydberg basis: dimension, basis labels, and the operator ids
# (amplitude, detuning) of its channels
_BASIS = "ground-rydberg"
_DIM = 2
_LABELS = ["r", "g"]
_OP_IDS = ("sigma_gr", "sigma_rr")


def _local_op_np(name: str) -> np.ndarray:
    """|b1><b2| as a dense real numpy matrix from a 'sigma_xy' name."""
    b1, b2 = name[6], name[7]
    m = np.zeros((_DIM, _DIM))
    m[_LABELS.index(b1), _LABELS.index(b2)] = 1.0
    return m


class NoiseDraws(NamedTuple):
    """Random draws for one run (all zero in this noiseless slice)."""

    bad_atoms: torch.Tensor  # (n,) float 0/1
    doppler: torch.Tensor  # (n,) rad/us
    amp_factors: torch.Tensor  # (n_slots_total,) >= 0


def zero_noise_draws(n_qubits: int, n_slots: int, device="cpu") -> NoiseDraws:
    return NoiseDraws(
        bad_atoms=torch.zeros(n_qubits, dtype=DTYPE, device=device),
        doppler=torch.zeros(n_qubits, dtype=DTYPE, device=device),
        amp_factors=torch.ones(max(n_slots, 1), dtype=DTYPE, device=device),
    )


def _maybe_nonzero(arr: torch.Tensor) -> bool:
    """True unless the array is provably all-zero.  A tensor that carries
    gradients counts as nonzero, as a traced array does in the JAX
    package: dropping its term would drop its gradient."""
    return arr.requires_grad or bool((arr != 0).any())


class Hamiltonian:
    """Builds and holds the factorized Hamiltonian for a sampled sequence."""

    def __init__(
        self,
        samples_obj: SequenceSamples,
        qdict: dict[QubitId, torch.Tensor],
        device: Device,
        sampling_rate: float,
        config: NoiseModel,
        torch_device: torch.device,
    ) -> None:
        self.samples_obj = samples_obj
        self.torch_device = torch_device
        self._qdict = {
            k: torch.as_tensor(v, dtype=DTYPE).to(torch_device) for k, v in qdict.items()
        }
        self._device = device
        self._sampling_rate = sampling_rate
        self.basis_name = _BASIS
        self.dim = _DIM
        self._basis_labels = _LABELS
        self._size = len(self._qdict)
        self._duration = samples_obj.max_duration
        # host-side numpy: the grid structure
        self.sampling_times = (
            np.arange(self._duration, dtype=np.float64)[
                self._subsample_indices(self._duration)
            ]
            / 1000
        )
        self._a = self._size // 2
        self._b = self._size - self._a
        self.set_config(config)

    def _subsample_indices(self, length: int) -> np.ndarray:
        n_keep = int(self._sampling_rate * self._duration)
        return np.linspace(0, length - 1, n_keep).astype(int)

    def _adapt_to_sampling_rate(self, arr: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(self._subsample_indices(arr.shape[0]), device=arr.device)
        return arr[idx]

    @property
    def config(self) -> NoiseModel:
        return self._config

    def set_config(self, cfg: NoiseModel) -> None:
        if not isinstance(cfg, NoiseModel):
            raise ValueError(f"Object {cfg} is not a valid `NoiseModel`.")
        self._config = cfg
        self._ham_data = self.build_data(
            zero_noise_draws(self._size, self._count_noise_slots(), self.torch_device)
        )

    def _count_noise_slots(self) -> int:
        return sum(len(cs.slots) for cs in self.samples_obj.channel_samples.values())

    def _interaction_weights(self, good: torch.Tensor) -> torch.Tensor:
        """(n, n) upper-triangular pair weights W_ij = C6/r^6 (rad/us),
        zeroed for bad atoms."""
        n = self._size
        coords = torch.stack(list(self._qdict.values()))
        diff = coords[:, None, :] - coords[None, :, :]
        d2 = (diff * diff).sum(-1)
        eye = torch.eye(n, dtype=torch.bool, device=coords.device)
        # grad-safe diagonal: sqrt'(0) is inf, and the diagonal is masked
        dist = torch.sqrt(torch.where(eye, torch.ones_like(d2), d2))
        w = self._device.interaction_coeff / dist**6
        tri = torch.triu(torch.ones(n, n, dtype=DTYPE, device=coords.device), diagonal=1)
        return w * tri * (good[:, None] * good[None, :])

    def build_data(self, draws: NoiseDraws) -> FactoredHamiltonian:
        """Nested samples + draws -> FactoredHamiltonian."""
        samples = self.samples_obj.to_nested_dict()
        n, d, a, b = self._size, self.dim, self._a, self._b
        dev = self.torch_device
        good = 1.0 - draws.bad_atoms

        row_parts, col_parts = [], []
        row_streams, col_streams = [], []

        def _lift_group(op: np.ndarray, sites: list[int], group: str) -> np.ndarray:
            g = a if group == "row" else b
            out = np.zeros((d**g, d**g))
            for s_ in sites:
                loc = s_ if group == "row" else s_ - a
                out += np.kron(np.kron(np.eye(d**loc), op), np.eye(d ** (g - loc - 1)))
            return out

        def add_term(op_name, sites, amp_stream, det_stream, det_op_name) -> None:
            op_np = _local_op_np(op_name)
            det_np = _local_op_np(det_op_name)
            rsites = [s_ for s_ in sites if s_ < a]
            csites = [s_ for s_ in sites if s_ >= a]
            if amp_stream is not None:
                if rsites:
                    row_parts.append(_lift_group(op_np, rsites, "row"))
                    row_streams.append(amp_stream)
                if csites:
                    col_parts.append(_lift_group(op_np, csites, "col"))
                    col_streams.append(amp_stream)
            if det_stream is not None:
                zs = Cplx(det_stream, torch.zeros_like(det_stream))
                if rsites:
                    row_parts.append(_lift_group(det_np, rsites, "row"))
                    row_streams.append(zs)
                if csites:
                    col_parts.append(_lift_group(det_np, csites, "col"))
                    col_streams.append(zs)

        def _coeffs(qty: dict):
            amp, det, phase = qty["amp"], qty["det"], qty["phase"]
            amp_stream = det_stream = None
            if _maybe_nonzero(amp):
                half = 0.5 * amp
                amp_stream = Cplx(
                    self._adapt_to_sampling_rate(half * torch.cos(phase)),
                    self._adapt_to_sampling_rate(-half * torch.sin(phase)),
                )
            if _maybe_nonzero(det):
                det_stream = self._adapt_to_sampling_rate(-0.5 * det)
            return amp_stream, det_stream

        qty = samples["Global"].get(_BASIS)
        if qty:
            amp_s, det_s = _coeffs(qty)
            add_term(_OP_IDS[0], list(range(n)), amp_s, det_s, _OP_IDS[1])

        n_samples = int(self._sampling_rate * self._duration)
        sample_dt = 0.001 / self._sampling_rate

        def _stack_parts(parts, streams, g):
            if not parts:
                z = torch.zeros(1, n_samples, dtype=DTYPE, device=dev)
                return torch.zeros(1, d**g, d**g, dtype=DTYPE, device=dev), Cplx(z, z)
            return (
                torch.as_tensor(np.stack(parts), dtype=DTYPE, device=dev),
                Cplx(
                    torch.stack([s_.re for s_ in streams]).to(dev),
                    torch.stack([s_.im for s_ in streams]).to(dev),
                ),
            )

        rp, rs = _stack_parts(row_parts, row_streams, a)
        cp, cs = _stack_parts(col_parts, col_streams, b)

        int_diag = torch.zeros(d**a, d**b, dtype=DTYPE, device=dev)
        if n > 1:
            int_diag = self._ising_diag(self._interaction_weights(good))

        return FactoredHamiltonian(
            row_parts=rp,
            col_parts=cp,
            row_streams=rs,
            col_streams=cs,
            int_diag=int_diag,
            sample_dt=sample_dt,
            n_samples=n_samples,
        )

    def _ising_diag(self, W: torch.Tensor) -> torch.Tensor:
        """sum_{i<j} W_ij n_i n_j over the (da, db) grid."""
        d, a, b = self.dim, self._a, self._b
        dev = W.device
        occ_site = np.zeros((d,))
        occ_site[self._basis_labels.index("r")] = 1.0

        def occ_table(g: int) -> torch.Tensor:
            out = np.zeros((g, d**g)) if g else np.zeros((0, 1))
            for k in range(g):
                out[k] = np.kron(np.kron(np.ones(d**k), occ_site), np.ones(d ** (g - k - 1)))
            return torch.as_tensor(out, dtype=DTYPE, device=dev)

        Or, Oc = occ_table(a), occ_table(b)
        W_rr, W_cc, W_rc = W[:a, :a], W[a:, a:], W[:a, a:]
        zeros1 = torch.zeros(1, dtype=DTYPE, device=dev)
        diag_r = torch.einsum("ij,ix,jx->x", W_rr, Or, Or) if a else zeros1
        diag_c = torch.einsum("ij,ix,jx->x", W_cc, Oc, Oc) if b else zeros1
        cross = (
            torch.einsum("ij,ix,jy->xy", W_rc, Or, Oc)
            if (a and b)
            else torch.zeros(d**a, d**b, dtype=DTYPE, device=dev)
        )
        return diag_r[:, None] + diag_c[None, :] + cross

"""Time-dependent Rydberg / XY Hamiltonian assembly (counterpart of
pulser_diff_tpu/hamiltonian.py).

The sampled sequence becomes a :class:`FactoredHamiltonian`: static
stacks of small real part matrices (row-group / column-group lifts) plus
complex coefficient streams, and the interaction: the van der Waals
diagonal on the (da, db) grid (ising), or the XY dipole flip-flop terms
as kron pairs.  Physics as in the JAX package:
  - amplitude coeff 0.5*amp*exp(-i*phase) on the lowering op, hermitized;
  - detuning coeff -0.5*det on the occupation projector, hermitized;
  - van der Waals C6/r^6 n_i n_j;
  - XY C3 (1 - 3 cos^2 theta)/r^3 (sigma+ sigma- + h.c.), theta the angle
    between the pair and the magnetic field.
The port is noiseless and global: the ground-rydberg basis of the global
Rydberg channel and the XY basis of the global microwave channel (no
local channels, digital or all bases, SLM masks).  The interaction
weights are differentiable in the qubit coordinates, or in the pair
distances set through ``_dist_override``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.register import QubitId
from pulser_diff_torch.core.sampler import SequenceSamples
from pulser_diff_torch.ops.apply import FactoredHamiltonian
from pulser_diff_torch.simconfig import NoiseModel

# basis tables: (dimension, labels); the digital and all bases are a
# later slice
_BASIS_TABLE = {
    "XY": (2, ["u", "d"]),
    "ground-rydberg": (2, ["r", "g"]),
}

# operator ids (amplitude, detuning) per sampled basis
_OP_IDS = {
    "ground-rydberg": ("sigma_gr", "sigma_rr"),
    "XY": ("sigma_du", "sigma_uu"),
}


def _local_op_np(dim: int, basis: list[str], name: str) -> np.ndarray:
    """|b1><b2| as a dense real numpy matrix from a 'sigma_xy' name."""
    b1, b2 = name[6], name[7]
    m = np.zeros((dim, dim))
    m[basis.index(b1), basis.index(b2)] = 1.0
    return m


class NoiseDraws(NamedTuple):
    """Random draws for one run (all zero in this noiseless slice)."""

    bad_atoms: torch.Tensor  # (n,) float 0/1
    doppler: torch.Tensor  # (n,) rad/us
    amp_factors: torch.Tensor  # (n_slots_total,) >= 0


def zero_noise_draws(n_qubits: int, n_slots: int, device: DeviceLike = None) -> NoiseDraws:
    """The draws of a noiseless run, on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
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
        self._dist_override: dict[str, torch.Tensor] = {}
        self._last_dist: tuple = ((), None)  # (qubit ids, (n, n) distances) of the last build
        self._interaction = "XY" if samples_obj._in_xy else "ising"
        self.basis_name = "XY" if self._interaction == "XY" else "ground-rydberg"
        self.dim, self._basis_labels = _BASIS_TABLE[self.basis_name]
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
        """(n, n) upper-triangular pair weights W_ij (rad/us), zeroed for
        bad atoms.  ising: C6/r^6.  XY: C3 (1 - 3cos^2 theta)/r^3.

        The pair distances are kept for ``_dist_dict``; ``_dist_override``
        entries ('q1-q2' keys) replace the distance of their pair."""
        n = self._size
        qids = list(self._qdict)
        coords = torch.stack([self._qdict[q] for q in qids])
        diff = coords[:, None, :] - coords[None, :, :]
        d2 = (diff * diff).sum(-1)
        eye = torch.eye(n, dtype=torch.bool, device=coords.device)
        # grad-safe diagonal: sqrt'(0) is inf, and the diagonal is masked
        dist = torch.sqrt(torch.where(eye, torch.ones_like(d2), d2))
        if self._dist_override:
            ii, jj, vals = [], [], []
            for i in range(n):
                for j in range(i + 1, n):
                    key = f"{qids[i]}-{qids[j]}"
                    if key in self._dist_override:
                        ii.append(i)
                        jj.append(j)
                        vals.append(torch.as_tensor(self._dist_override[key], dtype=DTYPE,
                                                    device=coords.device))
            if vals:
                dist = dist.index_put((torch.as_tensor(ii, device=coords.device),
                                       torch.as_tensor(jj, device=coords.device)),
                                      torch.stack(vals))
        self._last_dist = (qids, dist)
        if self._interaction == "ising":
            w = self._device.interaction_coeff / dist**6
        else:
            mag = torch.as_tensor(self.samples_obj._magnetic_field[: coords.shape[-1]],
                                  dtype=DTYPE, device=coords.device)
            mag_norm = torch.linalg.norm(mag)
            # double where: a plain where still propagates the unselected
            # branch's NaN through the gradient when mag_norm == 0 (the
            # default out-of-plane field), poisoning every coordinate
            # gradient
            degenerate = mag_norm < 1e-8
            safe_denom = torch.where(degenerate, torch.ones_like(dist), dist * mag_norm)
            cosine = torch.where(degenerate, torch.zeros_like(dist), (diff @ mag) / safe_denom)
            w = self._device.interaction_coeff_xy * (1 - 3 * cosine**2) / dist**3
        tri = torch.triu(torch.ones(n, n, dtype=DTYPE, device=coords.device), diagonal=1)
        return w * tri * (good[:, None] * good[None, :])

    @property
    def _dist_dict(self) -> dict[str, torch.Tensor]:
        """Pair distances 'q1-q2' of the last build (overrides included)."""
        qids, dist = self._last_dist
        return {f"{qids[i]}-{qids[j]}": dist[i, j]
                for i in range(len(qids)) for j in range(i + 1, len(qids))}

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
            op_np = _local_op_np(d, self._basis_labels, op_name)
            det_np = _local_op_np(d, self._basis_labels, det_op_name)
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

        for basis_key, qty in samples["Global"].items():
            if qty:
                amp_op, det_op = _OP_IDS[basis_key]
                amp_s, det_s = _coeffs(qty)
                add_term(amp_op, list(range(n)), amp_s, det_s, det_op)

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
        kron_row = kron_col = kron_streams = None
        if n > 1:
            W = self._interaction_weights(good)
            if self._interaction == "ising":
                int_diag = self._ising_diag(W)
            else:
                kron_row, kron_col, kron_streams = self._xy_kron_terms(W, n_samples)

        return FactoredHamiltonian(
            row_parts=rp,
            col_parts=cp,
            row_streams=rs,
            col_streams=cs,
            int_diag=int_diag,
            sample_dt=sample_dt,
            n_samples=n_samples,
            kron_row=kron_row,
            kron_col=kron_col,
            kron_streams=kron_streams,
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

    def _xy_kron_terms(self, W: torch.Tensor, n_samples: int):
        """Factor the XY dipole flip-flop interaction
        sum_{i<j} W_ij (sigma_ud^i sigma_du^j + h.c.) into kron-pair terms
        z_k(t) (R_k (x) C_k) + h.c., applied as R @ Psi @ C^T:

          - within-row-group pairs  -> (sum_{i<j<a} W_ij s+_i s-_j, I_db)
          - within-col-group pairs  -> (I_da, sum_{a<=i<j} W_ij s+_i s-_j)
          - cross pairs, grouped by row site i -> (s+_i lift,
            sum_{j>=a} W_ij s-_j lift)

        W carries the coordinates' gradient into R_k / C_k.  This is the
        unmasked branch: the JAX package time-windows the terms with on/off
        streams under an SLM mask, and the port has no SLM mask yet."""
        d, a, b = self.dim, self._a, self._b
        da, db = d**a, d**b
        dev = W.device
        sig_ud = _local_op_np(d, self._basis_labels, "sigma_ud")
        sig_du = _local_op_np(d, self._basis_labels, "sigma_du")

        def lift(op: np.ndarray, loc: int, g: int) -> np.ndarray:
            return np.kron(np.kron(np.eye(d**loc), op), np.eye(d ** (g - loc - 1)))

        def t(x: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(x, dtype=DTYPE, device=dev)

        ud_row = [lift(sig_ud, i, a) for i in range(a)]
        du_row = [lift(sig_du, i, a) for i in range(a)]
        ud_col = [lift(sig_ud, j, b) for j in range(b)]
        du_col = [lift(sig_du, j, b) for j in range(b)]
        rows, cols = [], []
        # within-row pairs
        if a >= 2:
            m = torch.zeros(da, da, dtype=DTYPE, device=dev)
            for i in range(a):
                for j in range(i + 1, a):
                    m = m + W[i, j] * t(ud_row[i] @ du_row[j])
            rows.append(m)
            cols.append(torch.eye(db, dtype=DTYPE, device=dev))
        # within-col pairs
        if b >= 2:
            m = torch.zeros(db, db, dtype=DTYPE, device=dev)
            for i in range(b):
                for j in range(i + 1, b):
                    m = m + W[a + i, a + j] * t(ud_col[i] @ du_col[j])
            rows.append(torch.eye(da, dtype=DTYPE, device=dev))
            cols.append(m)
        # cross pairs grouped by row site
        if a and b:
            du_col_j = t(np.stack(du_col))  # (b, db, db)
            for i in range(a):
                rows.append(t(ud_row[i]))
                cols.append(torch.einsum("j,jcd->cd", W[i, a:], du_col_j))
        zs = torch.ones(len(rows), n_samples, dtype=DTYPE, device=dev)
        return torch.stack(rows), torch.stack(cols), Cplx(zs, torch.zeros_like(zs))

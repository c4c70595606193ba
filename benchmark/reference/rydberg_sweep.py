"""Plain reference of the ``rydberg_sweep`` protocol.

Neutral atoms in the ground-rydberg basis, driven by one global Rydberg
pulse of phase 0 whose amplitude and detuning are both trained:

    H(t) = sum_i Omega(t)/2 sigma^x_i - delta(t) sum_i n_i
           + sum_{i<j} C6 / |r_i - r_j|^6 n_i n_j,

with n_i = |r><r| on atom i.  The state starts with every atom in |g>
and is evolved by fixed-step Dormand-Prince 5 on the problem's grid;
the loss is one minus the final population of the target |r...r>.

The knots of a candidate are one row: the amplitude's ``knots`` first,
then the detuning's.  The benchmark hands both sides the (duration,
knots) interpolation matrix M; the per-ns samples are relu(M a) for the
amplitude (it may not go negative) and M d for the detuning.  The grid
and the coefficients follow the problem statement of the configuration
file:

* each stream has ``duration`` samples, one a ns, and a closing sample
  at ``duration`` that repeats the last;
* ``n = int(rate * (duration + 1))`` of those ``duration + 1`` samples
  are kept, at the indices ``linspace(0, duration, n)`` truncated to
  integers; those indices, over 1000, are the sampling times in us;
* the integration grid is the sampling times merged with the evaluation
  times 0 and duration / 1000 (a stable sort; a step of length 0 is a
  step all the same), each interval cut into ``substeps`` equal steps;
* a coefficient at time t is read by linear interpolation of the kept
  samples on a uniform grid of spacing 1 / rate ns: index
  ``clamp(floor(t / dt), 0, n - 2)`` and weight ``(t - index dt) / dt``.

Everything here is torch or numpy, complex states, matrix free: the
drive term is the sum over atoms of the state with that atom's digit
flipped.  The dtype is a parameter: float64 is the reference, float32
the control.  No matrix product is taken on a state, and TF32 is off all
the same.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Mapping

import numpy as np
import torch

# Dormand and Prince (1980): the six stages of the fifth-order solution
# (the seventh only feeds the embedded error estimate)
DP5_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
DP5_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
DP5_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def kept_indices(duration: int, rate: float) -> np.ndarray:
    """The indices of the per-ns samples, the closing one included, that
    the sampling rate keeps."""
    return np.linspace(0, duration, int(rate * (duration + 1))).astype(int)


def grid_times(duration: int, rate: float, substeps: int) -> np.ndarray:
    """The integration grid (us): the sampling times and the evaluation
    times 0 and T merged, each interval cut into ``substeps`` steps."""
    sampling = kept_indices(duration, rate).astype(np.float64) / 1000
    merged = np.sort(np.concatenate([sampling, [0.0, duration / 1000]]), kind="stable")
    if substeps == 1:
        return merged
    w = np.arange(substeps) / substeps
    inner = merged[:-1, None] + (merged[1:] - merged[:-1])[:, None] * w[None, :]
    return np.concatenate([inner.reshape(-1), merged[-1:]])


def occupations(n: int, device) -> torch.Tensor:
    """(n, 2^n) bool: atom i is in |r> in basis state k.  Atom 0 is the
    most significant digit, and digit 0 is |r>."""
    k = torch.arange(2**n, device=device)
    shifts = torch.arange(n - 1, -1, -1, device=device)
    return ((k[None, :] >> shifts[:, None]) & 1) == 0


def interaction_diagonal(coords: np.ndarray, c6: float, dtype, device) -> torch.Tensor:
    """sum_{i<j} C6 / r_ij^6 n_i n_j over the basis (rad/us)."""
    n = coords.shape[0]
    occ = occupations(n, device)
    out = torch.zeros(2**n, dtype=dtype, device=device)
    for i in range(n):
        for j in range(i + 1, n):
            r = float(np.linalg.norm(coords[i] - coords[j]))
            out += (occ[i] & occ[j]).to(dtype) * (c6 / r**6)
    return out


def stability_substeps(omega_max: float, delta_max: float, diag_max: float, n: int,
                       rate: float) -> int:
    """The fewest equal steps per grid interval that keep ||H|| h <= 1.2,
    with ||H|| bounded by n Omega/2 + n |delta| + max interaction."""
    bound = n * omega_max / 2 + n * delta_max + diag_max
    return max(1, math.ceil(bound * (0.001 / rate) / 1.2))


class Problem:
    """One configuration's Hamiltonian and grid, in ``dtype``.

    ``matrix``: the (duration, knots) matrix that takes a stream's knots
    to its per-ns samples (rad/us), as the benchmark hands it to both
    sides."""

    def __init__(self, cfg: Mapping, matrix: np.ndarray, dtype=torch.float64,
                 device="cpu") -> None:
        pulse = cfg["pulse"]
        self.n = len(cfg["register"]["coords"])
        self.dtype = dtype
        self.cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
        self.device = torch.device(device)
        self.duration = int(pulse["duration_ns"])
        self.rate = float(pulse["sampling_rate"])
        self.knots = int(pulse["knots"])
        coords = np.asarray(cfg["register"]["coords"], dtype=np.float64)
        kept = kept_indices(self.duration, self.rate)
        # the kept rows of the interpolation matrix with its closing row (a
        # copy of the last): a stream's kept samples are M_kept @ knots
        closed = np.concatenate([matrix, matrix[-1:]])
        self.m_kept = torch.as_tensor(closed[kept], dtype=dtype, device=self.device)
        self.diag = interaction_diagonal(coords, float(cfg["interaction"]["c6"]), dtype,
                                         self.device)
        self.n_r = occupations(self.n, self.device).sum(0).to(dtype)
        # flip[i, k] = k with atom i's digit flipped: sigma^x_i y = y[..., flip[i]]
        k = torch.arange(2**self.n, device=self.device)
        self.flip = k[None, :] ^ (1 << torch.arange(self.n, device=self.device))[:, None]
        self.target = int(cfg["target_index"])
        self.substeps = int(cfg["solver"]["substeps"])
        self.times = grid_times(self.duration, self.rate, self.substeps)
        self.sample_dt = 0.001 / self.rate
        self.n_samples = len(kept)

    def samples(self, knots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(amplitude, detuning) kept samples, each (P, n_samples)."""
        k = knots.to(self.dtype)
        amp = torch.relu(k[:, :self.knots] @ self.m_kept.T)
        return amp, k[:, self.knots:] @ self.m_kept.T

    def check_substeps(self, knots: torch.Tensor) -> None:
        """Refuse a stated step count that the stability bound would not
        give for ``knots`` (the streams' largest samples)."""
        with torch.no_grad():
            amp, det = self.samples(knots.detach().to(self.device))
        need = stability_substeps(float(amp.abs().max()), float(det.abs().max()),
                                  float(self.diag.max()), self.n, self.rate)
        if need != self.substeps:
            raise ValueError(f"the stability bound gives {need} substeps, the configuration "
                             f"states {self.substeps}")

    def _interp(self, t: float):
        """(index, weight) of time t on the uniform sample grid."""
        i = min(max(int(math.floor(t / self.sample_dt)), 0), self.n_samples - 2)
        return i, (t - i * self.sample_dt) / self.sample_dt

    def _apply_x(self, y: torch.Tensor) -> torch.Tensor:
        """sum_i sigma^x_i y for a batch y of shape (P, 2^n)."""
        return y[:, self.flip].sum(1)

    def _rhs(self, t: float, amp: torch.Tensor, det: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """-i H(t) y."""
        i, w = self._interp(t)
        omega = amp[:, i] + (amp[:, i + 1] - amp[:, i]) * w
        delta = det[:, i] + (det[:, i + 1] - det[:, i]) * w
        diag = self.diag[None, :] - delta[:, None] * self.n_r[None, :]
        hy = diag * y + (0.5 * omega)[:, None] * self._apply_x(y)
        return -1j * hy

    def _step(self, t0: float, h: float, amp, det, y: torch.Tensor) -> torch.Tensor:
        ks = []
        for c, a in zip(DP5_C, DP5_A):
            yi = y
            for aij, kj in zip(a, ks):
                yi = yi + kj * (aij * h)
            ks.append(self._rhs(t0 + c * h, amp, det, yi))
        out = y
        for b, k in zip(DP5_B, ks):
            if b != 0.0:
                out = out + k * (b * h)
        return out

    def loss(self, knots: torch.Tensor) -> torch.Tensor:
        """(P,) one minus the final population of the target, for knots
        (P, 2 knots)."""
        amp, det = self.samples(knots)
        y = torch.zeros(knots.shape[0], 2**self.n, dtype=self.cdtype, device=self.device)
        y[:, -1] = 1.0  # every atom in |g>: every digit 1
        t = self.times
        for k in range(len(t) - 1):
            y = self._step(float(t[k]), float(t[k + 1] - t[k]), amp, det, y)
        return 1.0 - y[:, self.target].abs() ** 2

    def value_and_grad(self, knots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Each candidate's loss and its gradient in the knots, float64
        whatever the working dtype."""
        with _no_tf32(), torch.enable_grad():
            x = knots.detach().to(self.device, self.dtype).requires_grad_(True)
            vals = self.loss(x)
            (grad,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach().double(), grad.double()


def problem_size(cfg: Mapping) -> dict:
    """The sizes that the work counts read (``benchmark/work/counts.py``)."""
    pulse = cfg["pulse"]
    duration, rate = int(pulse["duration_ns"]), float(pulse["sampling_rate"])
    return {
        "atoms": len(cfg["register"]["coords"]),
        "steps": len(grid_times(duration, rate, int(cfg["solver"]["substeps"]))) - 1,
        "stages": len(DP5_C),
        "axpys": sum(len(a) for a in DP5_A) + sum(b != 0.0 for b in DP5_B),
        "slots": 2,  # the evaluation times 0 and T
        "samples": len(kept_indices(duration, rate)),
        "streams": 2,  # the amplitude and the detuning
    }

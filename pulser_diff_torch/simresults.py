"""Simulation results (counterpart of pulser_diff_tpu/simresults.py).

``CoherentResults`` holds the states at every evaluation time (with SPAM
measurement errors, its samples take the detection flips and its
expectation values read the pseudo-density); ``NoisyResults`` holds the
bitstring counts of a Monte-Carlo batch, one ``SampledResult`` a time,
and its states are diagonal pseudo-densities built from them.  Bases:
ground-rydberg, digital, all (three levels a site, measured in the
ground-rydberg or the digital basis) and XY; a leakage-extended basis
keeps its name.  ``plot`` (matplotlib) is not ported.
"""

from __future__ import annotations

import typing
from collections import Counter
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from pulser_diff_torch.config import default_dtype
from pulser_diff_torch.cplx import Cplx, as_cplx, cmatmul, cstack
from pulser_diff_torch.ops.linalg import expect as _expect
from pulser_diff_torch.result import QuantumResult
from pulser_diff_torch.simconfig import host_float


class SampledResult:
    """Counter-of-bitstrings result for one time point."""

    def __init__(self, atom_order: tuple, meas_basis: str, bitstring_counts: Counter) -> None:
        self.atom_order = atom_order
        self.meas_basis = meas_basis
        self.bitstring_counts = Counter(bitstring_counts)
        self._total = sum(self.bitstring_counts.values())

    @property
    def sampling_dist(self) -> dict[str, float]:
        return {b: c / self._total for b, c in self.bitstring_counts.items()}

    def get_samples(self, n_samples: int) -> Counter:
        rng = np.random.default_rng()
        keys = list(self.bitstring_counts.keys())
        probs = np.array([self.bitstring_counts[k] for k in keys], dtype=float)
        probs /= probs.sum()
        counts = rng.multinomial(n_samples, probs)
        return Counter({k: int(c) for k, c in zip(keys, counts) if c > 0})


class SimulationResults:
    """The results API shared by the coherent and the sampled results."""

    _use_pseudo_dens: bool = False

    def __init__(self, size: int, basis_name: str, sim_times: np.ndarray) -> None:
        if basis_name not in ("ground-rydberg", "digital", "all", "XY"):
            raise ValueError("`basis_name` must be 'ground-rydberg', 'digital', 'all' or 'XY'.")
        self._dim = 3 if basis_name == "all" else 2
        self._size = size
        self._basis_name = basis_name
        self._sim_times = sim_times
        self._results: tuple = ()

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int):
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def states(self) -> Cplx:
        raise NotImplementedError

    def get_state(self, t: float) -> Cplx:
        raise NotImplementedError

    def get_final_state(self) -> Cplx:
        raise NotImplementedError

    def expect(self, obs_list: Sequence) -> list[Cplx]:
        """Expectation values of each observable over time; a 1-D
        observable of shape (dim**size,) is its diagonal.  On the
        pseudo-densities (sampled results, measurement errors) only
        diagonal observables are legal."""
        if not isinstance(obs_list, (list, tuple)):
            raise TypeError("`obs_list` must be a list of operators.")
        dim = 2 if self._use_pseudo_dens else self._dim
        legal = (dim**self._size, dim**self._size)
        out = []
        for obs in obs_list:
            obs = as_cplx(obs, dtype=default_dtype())
            if obs.shape not in (legal, legal[:1]):
                raise ValueError(
                    f"Incompatible shape of observable. Expected {legal} or "
                    f"{legal[:1]}, got {obs.shape}."
                )
            if self._use_pseudo_dens:
                if obs.ndim == 2 and not all(
                        torch.allclose(t, torch.diag(torch.diagonal(t))) for t in (obs.re, obs.im)):
                    raise ValueError("Observable is non-diagonal.")
                states = self._pseudo_density_states()
            else:
                states = self.states
            out.append(_expect(obs.to(device=states.device), states))
        return out

    def sample_state(self, t: float, n_samples: int = 1000, t_tol: float = 1e-3) -> Counter:
        return self[self._get_index_from_time(t, t_tol)].get_samples(n_samples)

    def sample_final_state(self, N_samples: int = 1000) -> Counter:
        return self.sample_state(float(self._sim_times[-1]), N_samples)

    def plot(self, op, fmt: str = "", label: str = "") -> None:
        """Plot the expectation value of ``op`` over the simulation times."""
        import matplotlib.pyplot as plt

        vals = self.expect([op])[0]
        plt.plot(np.asarray(self._sim_times), vals.re.detach().cpu().numpy(), fmt, label=label)
        plt.xlabel("Time (µs)")
        plt.ylabel("Expectation value")

    def _get_index_from_time(self, t_float: float, tol: float = 1e-3) -> int:
        hits = np.where(np.abs(t_float - np.asarray(self._sim_times)) < tol)[0]
        if len(hits) == 0:
            raise IndexError(
                f"Given time {t_float} is absent from Simulation times within tolerance {tol}."
            )
        return int(hits[0])

    def _meas_kernel_1q(self) -> np.ndarray:
        """(2, 2) kernel K[state, bit]: the weight of physical state
        ``state`` given the measured bit ``bit``."""
        K = np.zeros((2, 2))
        for bit in (0, 1):
            good = 1 - bit if self._basis_name == "ground-rydberg" else bit
            K[good, bit] = 1.0
        return K

    def _pseudo_density_states(self) -> Cplx:
        return cstack([self._calc_pseudo_density(i) for i in range(len(self))])

    def _calc_pseudo_density(self, t_index: int) -> Cplx:
        """Diagonal (2^n, 2^n) pseudo-density from the measurement weights."""
        w = self._weights_at(t_index)
        K1 = torch.as_tensor(self._meas_kernel_1q(), dtype=default_dtype(), device=w.device)
        K = K1
        for _ in range(self._size - 1):
            K = torch.kron(K, K1)
        diag = K @ w
        return Cplx(torch.diag(diag), torch.zeros(len(diag), len(diag), dtype=diag.dtype,
                                                  device=diag.device))

    def _weights_at(self, t_index: int) -> torch.Tensor:
        raise NotImplementedError


class NoisyResults(SimulationResults):
    """Results of a Monte-Carlo batch: bitstring counts at every
    evaluation time over ``n_measures`` shots."""

    _use_pseudo_dens = True

    def __init__(
        self,
        run_output: typing.Sequence[SampledResult],
        size: int,
        basis_name: str,
        sim_times: np.ndarray,
        n_measures: int,
    ) -> None:
        super().__init__(size, "digital" if basis_name == "all" else basis_name, sim_times)
        self.n_measures = n_measures
        self._results = tuple(run_output)

    @property
    def states(self) -> Cplx:
        return self._pseudo_density_states()

    @property
    def results(self) -> list[Counter]:
        """Each time's bitstring frequencies."""
        return [Counter(res.sampling_dist) for res in self]

    def _weights_at(self, t_index: int) -> torch.Tensor:
        w = np.zeros(2**self._size)
        for b, p in self[t_index].sampling_dist.items():
            w[int(b, 2)] = p
        return torch.as_tensor(w, dtype=default_dtype())

    def get_state(self, t: float, t_tol: float = 1e-3) -> Cplx:
        return self._calc_pseudo_density(self._get_index_from_time(t, t_tol))

    def get_final_state(self) -> Cplx:
        return self.get_state(float(self._sim_times[-1]))

    def plot(self, op, fmt: str = ".", label: str = "", error_bars: bool = True) -> None:
        """The expectation value of ``op`` over time, with error bars of
        one standard error over ``n_measures`` shots (from <O^2> - <O>^2
        on the diagonal pseudo-densities)."""
        import matplotlib.pyplot as plt

        if not error_bars:
            super().plot(op, fmt, label)
            return
        moy = self.expect([op])[0]
        opc = as_cplx(op, dtype=default_dtype())
        # a 1-D op is diag(op): O^2 squares elementwise
        o2 = opc * opc if opc.ndim == 1 else cmatmul(opc, opc)
        var = self.expect([o2])[0].re - moy.re**2
        st = np.sqrt(np.clip(var.detach().cpu().numpy(), 0, None) / self.n_measures)
        plt.errorbar(np.asarray(self._sim_times), moy.re.detach().cpu().numpy(), st, fmt=fmt,
                     lw=1, capsize=3, label=label)
        plt.xlabel("Time (µs)")
        plt.ylabel("Expectation value")


class CoherentResults(SimulationResults):
    """Results of a deterministic (state-resolving) simulation."""

    def __init__(
        self,
        run_output: typing.Sequence[QuantumResult],
        size: int,
        basis_name: str,
        sim_times: np.ndarray,
        meas_basis: Optional[str] = None,
        meas_errors: Optional[Mapping[str, float]] = None,
    ) -> None:
        super().__init__(size, basis_name, sim_times)
        meas_basis = basis_name if meas_basis is None else meas_basis
        if self._basis_name == "all":
            if meas_basis not in ("ground-rydberg", "digital"):
                raise ValueError("`meas_basis` must be 'ground-rydberg' or 'digital'.")
        elif meas_basis != self._basis_name:
            raise ValueError("`meas_basis` and `basis_name` must have the same value.")
        self._meas_basis = meas_basis
        self._results = tuple(run_output)
        if meas_errors is not None:
            if set(meas_errors) != {"epsilon", "epsilon_prime"}:
                raise ValueError(
                    "When defining measurement errors, only values of "
                    "'epsilon' and 'epsilon_prime' must be given."
                )
            self._use_pseudo_dens = True
        self._meas_errors = meas_errors

    @property
    def states(self) -> Cplx:
        """(n_eval, dim, nb) states at every evaluation time."""
        return cstack([res.state for res in self])

    def _weights_at(self, t_index: int) -> torch.Tensor:
        return self[t_index]._weights()

    def _meas_kernel_1q(self) -> np.ndarray:
        if not self._meas_errors:
            return super()._meas_kernel_1q()
        eps = host_float(self._meas_errors["epsilon"])
        eps_p = host_float(self._meas_errors["epsilon_prime"])
        K = np.zeros((2, 2))
        for bit in (0, 1):
            err = eps if bit == 0 else eps_p
            good = 1 - bit if self._basis_name == "ground-rydberg" else bit
            K[good, bit] = 1 - err
            K[1 - good, bit] = err
        return K

    def get_state(self, t: float, reduce_to_basis: Optional[str] = None,
                  ignore_global_phase: bool = True, tol: float = 1e-6,
                  normalize: bool = True, t_tol: float = 1e-3) -> Cplx:
        return self[self._get_index_from_time(t, t_tol)].get_state(
            reduce_to_basis, ignore_global_phase, tol, normalize)

    def get_final_state(self, reduce_to_basis: Optional[str] = None,
                        ignore_global_phase: bool = True, tol: float = 1e-6,
                        normalize: bool = True) -> Cplx:
        return self.get_state(float(self._sim_times[-1]), reduce_to_basis,
                              ignore_global_phase, tol, normalize)

    def sample_state(self, t: float, n_samples: int = 1000, t_tol: float = 1e-3) -> Counter:
        """Samples with the SPAM detection flips (0 -> 1 with epsilon,
        1 -> 0 with epsilon_prime), as in the JAX package."""
        sampled = super().sample_state(t, n_samples, t_tol)
        if self._meas_errors is None:
            return sampled
        eps = host_float(self._meas_errors["epsilon"])
        eps_p = host_float(self._meas_errors["epsilon_prime"])
        if eps == 0.0 and eps_p == 0.0:
            return sampled
        rng = np.random.default_rng()
        shots = list(sampled.keys())
        n_det = np.array(list(sampled.values()))
        shot_arr = np.array([[int(c) for c in s] for s in shots], dtype=np.int64)
        flip_rep = np.repeat(np.where(shot_arr == 1, eps_p, eps), n_det, axis=0)
        flips = rng.random(flip_rep.shape) < flip_rep
        new_shots = np.repeat(shot_arr, n_det, axis=0) ^ flips
        out: Counter = Counter(map(tuple, new_shots))
        return Counter({"".join(map(str, k)): v for k, v in out.items()})

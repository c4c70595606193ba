"""Emulator orchestration (counterpart of pulser_diff_tpu/backend.py).

``TorchEmulator`` (the upstream pulser-diff name) builds the factored
Hamiltonian of a sampled sequence on one torch device, holds the initial
state and the evaluation times, and routes the solve:

  - on CUDA, ``DP5_SE`` takes the fused kernels, as the JAX package does
    on a TPU, below ``_FUSED_DIM_CAP``: K1 forward and K2 adjoint below
    ``_CKPT_DIM_THRESHOLD``, the checkpointed K4 forward and K5 adjoint
    from there and wherever K1's or K2's cluster plan refuses the shape
    (``ckpt=True`` / ``False`` overrides); from the cap (18 atoms) it
    takes the f32 stepper ``DP5_SE_F32``, as the JAX package does;
  - on the CPU, ``DP5_SE`` takes the f64 stepper, as the JAX package does
    on its CPU backend;
  - ``solver="DP5_PALLAS"`` / ``"RK4_PALLAS"`` and ``fused=True`` force
    the fused path on either device (on the CPU that runs the kernels'
    plain versions), above the cap too;
  - ``fused=False`` forces the f64 stepper.

The port is noiseless and coherent: ``run()`` returns
:class:`CoherentResults`.  ``expectation_fn_of_dists`` differentiates an
expectation in the inter-qubit distances, through the same routing.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.sampler import SequenceSamples, sample
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.hamiltonian import Hamiltonian
from pulser_diff_torch.ops.fused_evolution import (
    _NB_MAX, _tableau, cluster_fits, cluster_plan, evolve_states,
)
from pulser_diff_torch.result import QuantumResult
from pulser_diff_torch.simconfig import SimConfig
from pulser_diff_torch.simresults import CoherentResults
from pulser_diff_torch.solvers import SolverType, TimeGrid, sesolve

# solver options accepted by run(**options) (and QuantumModel) so far
_RUN_OPTIONS = {"substeps", "max_step", "fused", "ckpt", "remat", "n_segments"}
# the options that go on to sesolve
_SESOLVE_OPTIONS = ("remat", "n_segments")


def check_options(options: Mapping[str, Any], where: str) -> None:
    """Raise TypeError on a solver option the port does not know."""
    unknown = set(options) - _RUN_OPTIONS
    if unknown:
        raise TypeError(
            f"Unknown {where} option(s) {sorted(unknown)}; supported: {sorted(_RUN_OPTIONS)}."
        )


class TorchEmulator:
    """Differentiable emulator of a sampled pulse sequence on one torch
    device (``torch_device``; CUDA unless ``"cpu"`` is passed)."""

    _PALLAS_METHODS = {SolverType.RK4_PALLAS: "RK4", SolverType.DP5_PALLAS: "DP5"}

    # constants kept from the JAX package (backend.py): the fused adjoint's
    # ceiling (from there DP5_SE takes the f32 stepper on CUDA), the forward
    # kernels' ceiling for paths that never differentiate (the noisy batch,
    # ROADMAP queue 1 item 3), and the switch to the checkpointed adjoint
    # (K4/K5)
    _FUSED_DIM_CAP = 2**18
    _FUSED_FWD_DIM_CAP = 2**19
    _CKPT_DIM_THRESHOLD = 2**16

    def __init__(
        self,
        sampled_seq: SequenceSamples,
        register: Register,
        device: Device,
        sampling_rate: float = 1.0,
        config: Optional[SimConfig] = None,
        evaluation_times: Union[float, str, Any] = "Full",
        *,
        torch_device: DeviceLike = None,
    ) -> None:
        self.torch_device = resolve_device(torch_device)
        if not isinstance(sampled_seq, SequenceSamples):
            raise TypeError(
                "The provided sequence has to be a valid SequenceSamples instance."
            )
        if sampled_seq.max_duration == 0:
            raise ValueError("SequenceSamples is empty.")
        device.validate_register(register)
        self._register = register
        # globalize Global channels to the register & extend duration by 1
        sampled_seq = sampled_seq.globalize(register.qubit_ids)
        self._tot_duration = sampled_seq.max_duration
        self.samples_obj = sampled_seq.extend_duration(
            self._tot_duration + 1, hold_edge=True
        )
        if not (0 < sampling_rate <= 1.0):
            raise ValueError(
                f"The sampling rate (`sampling_rate` = {sampling_rate}) must "
                "be greater than 0 and less than or equal to 1."
            )
        if int(self._tot_duration * sampling_rate) < 4:
            raise ValueError("`sampling_rate` is too small, less than 4 data points.")
        noise_model = (config or SimConfig()).to_noise_model()
        self._hamiltonian = Hamiltonian(
            self.samples_obj,
            register.qubits,
            device,
            sampling_rate,
            noise_model,
            self.torch_device,
        )
        self.set_evaluation_times(evaluation_times)
        self.set_initial_state("all-ground")
        # pair distances, filled by run(dist_grad=True)
        self.dist_dict: dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------
    @property
    def sampling_times(self) -> np.ndarray:
        return self._hamiltonian.sampling_times

    @property
    def _sampling_rate(self) -> float:
        return self._hamiltonian._sampling_rate

    @property
    def dim(self) -> int:
        return self._hamiltonian.dim

    @property
    def basis_name(self) -> str:
        return self._hamiltonian.basis_name

    @property
    def initial_state(self) -> Cplx:
        return self._initial_state

    def set_initial_state(self, state: Union[str, Cplx, Any]) -> None:
        h = self._hamiltonian
        dev = self.torch_device
        if isinstance(state, str) and state == "all-ground":
            idx = h._basis_labels.index("u" if h._interaction == "XY" else "g")
            pos = 0
            for _ in range(h._size):
                pos = pos * h.dim + idx
            ket = torch.zeros((h.dim**h._size, 1), dtype=DTYPE, device=dev)
            ket[pos, 0] = 1.0
            self._initial_state = Cplx(ket, torch.zeros_like(ket))
            self._initial_is_ground = True
            return
        st = as_cplx(state, dtype=DTYPE, device=dev).to(device=dev)
        legal = h.dim**h._size
        if st.shape[0] != legal:
            raise ValueError(
                f"Incompatible shape of initial state. Expected {legal}, got {st.shape[0]}."
            )
        if st.ndim == 1:
            st = st.reshape(legal, 1)
        self._initial_state = st
        self._initial_is_ground = False

    @property
    def qq_distances(self) -> dict[str, torch.Tensor]:
        """Pair distances 'q1-q2' of the last Hamiltonian build."""
        return dict(self._hamiltonian._dist_dict)

    @property
    def qq_distance_keys(self) -> list[str]:
        """Pair keys 'q1-q2' in the order expectation_fn_of_dists takes."""
        qids = list(self._hamiltonian._qdict)
        return [f"{q1}-{q2}" for q1, q2 in itertools.combinations(qids, 2)]

    @property
    def evaluation_times(self) -> torch.Tensor:
        return torch.as_tensor(self._eval_times_array, dtype=DTYPE, device=self.torch_device)

    def set_evaluation_times(self, value: Union[str, float, Any]) -> None:
        """As in the JAX package: the times are kept host-side (the grid
        structure is static) and always include 0 and T."""
        h = self._hamiltonian
        if isinstance(value, str):
            if value == "Full":
                eval_times = np.asarray(h.sampling_times)
            elif value == "Minimal":
                eval_times = np.array([])
            else:
                raise ValueError(
                    "Wrong evaluation time label. It should be `Full`, "
                    "`Minimal`, an array of times or a float between 0 and 1."
                )
        elif isinstance(value, float):
            if value > 1 or value <= 0:
                raise ValueError("evaluation_times float must be between 0 and 1.")
            st = np.asarray(h.sampling_times)
            indices = np.linspace(0, len(st) - 1, int(value * len(st))).astype(int)
            eval_times = st[indices]
        elif isinstance(value, (list, tuple, np.ndarray, torch.Tensor)):
            arr = (
                value.detach().cpu().numpy()
                if isinstance(value, torch.Tensor)
                else np.asarray(value, dtype=np.float64)
            )
            if arr.size and arr.max() > self._tot_duration / 1000:
                raise ValueError(
                    "Provided evaluation-time list extends further than sequence duration."
                )
            if arr.size and arr.min() < 0:
                raise ValueError("Provided evaluation-time list contains negative values.")
            eval_times = arr
        else:
            raise ValueError(
                "Wrong evaluation time label. It should be `Full`, "
                "`Minimal`, an array of times or a float between 0 and 1."
            )
        self._eval_times_array = np.unique(
            np.concatenate([eval_times, np.array([0.0, self._tot_duration / 1000])])
        )

    # ------------------------------------------------------------------
    # the solve
    # ------------------------------------------------------------------
    def _auto_substeps(self, options: Mapping[str, Any]) -> int:
        """Stability heuristic of the JAX package: ||H|| * h_sub <= ~1.2."""
        if "substeps" in options:
            return int(options["substeps"])
        dt_grid = 0.001 / self._sampling_rate
        if "max_step" in options:
            return max(1, int(np.ceil(dt_grid / float(options["max_step"]))))
        hd = self._hamiltonian._ham_data
        zmax = 0.0
        for streams, parts in ((hd.row_streams, hd.row_parts), (hd.col_streams, hd.col_parts)):
            s = streams.to_numpy()
            p = parts.detach().cpu().numpy()
            pn = np.linalg.norm(p, ord=2, axis=(1, 2))
            zmax += 2 * float(np.max(np.abs(s), axis=1) @ pn) if s.size else 0.0
        dmax = float(hd.int_diag.detach().abs().max())
        if hd.kron_row is not None:
            kr = hd.kron_row.detach().cpu().numpy()
            kc = hd.kron_col.detach().cpu().numpy()
            zs = np.abs(hd.kron_streams.to_numpy()).max(axis=1)
            zmax += 2 * float(sum(z * np.linalg.norm(r, 2) * np.linalg.norm(c, 2)
                                  for z, r, c in zip(zs, kr, kc)))
        return max(1, int(np.ceil((zmax + dmax) * dt_grid / 1.2)))

    def _fused_backend_ok(self) -> bool:
        return (
            self.torch_device.type == "cuda"
            and int(self._initial_state.shape[1]) <= _NB_MAX
        )

    def _fused_eligible(self) -> bool:
        h = self._hamiltonian
        return self._fused_backend_ok() and (h.dim**h._size) < self._FUSED_DIM_CAP

    def _f32_xla_eligible(self) -> bool:
        """From the fused cap the f32 stepper is the default on CUDA
        (``fused=False`` restores f64)."""
        h = self._hamiltonian
        return self.torch_device.type == "cuda" and (h.dim**h._size) >= self._FUSED_DIM_CAP

    def _route_ckpt(self, ckpt: Optional[bool], ham_data, method: str) -> bool:
        """Whether the fused solve takes the checkpointed kernels K4/K5.

        By default they run from dim 2^16, as in the JAX package, and also
        wherever K1 or K2 cannot hold the shape (their cluster plan, decided
        before any launch): 14 and 15 atoms, or a state batch past nb = 2
        at 12 atoms, which the JAX package runs on its VMEM kernels.  An
        explicit ``ckpt=False`` on such a shape raises the plan's
        ValueError, which names ``ckpt=True``."""
        da, db = int(ham_data.row_parts.shape[-1]), int(ham_data.col_parts.shape[-1])
        shape = (
            int(self._initial_state.shape[1]), da, db, int(ham_data.row_parts.shape[0]),
            int(ham_data.col_parts.shape[0]),
            0 if ham_data.kron_row is None else int(ham_data.kron_row.shape[0]),
            _tableau(method)[2],
        )
        if ckpt is None:
            return da * db >= self._CKPT_DIM_THRESHOLD or not (
                cluster_fits(False, *shape) and cluster_fits(True, *shape))
        if not ckpt:
            for bwd in (False, True):
                cluster_plan(bwd, *shape)
        return bool(ckpt)

    def _solve_states(
        self,
        ham_data,
        solver: str,
        substeps: int,
        grid: TimeGrid,
        solver_opts: Optional[Mapping[str, Any]] = None,
    ) -> Cplx:
        """Run the routed solver; returns (n_eval, dim, nb) kets."""
        h = self._hamiltonian
        da, db = h.dim**h._a, h.dim**h._b
        dim = da * db
        opts = dict(solver_opts or {})
        fused = opts.pop("fused", None)
        ckpt = opts.pop("ckpt", None)
        if solver == SolverType.DP5_SE and fused is not False:
            if (fused is True and self._fused_backend_ok()) or self._fused_eligible():
                solver = SolverType.DP5_PALLAS
            elif self._f32_xla_eligible():
                # past the fused adjoint's cap, the JAX package's default:
                # the f32 stepper (|dv| 3.4e-6, |dg| 1.6e-6 against f64 at
                # 18 atoms there)
                solver = SolverType.DP5_SE_F32
        psi0 = self._initial_state  # (dim, nb)
        nb = psi0.shape[1]
        p = Cplx(psi0.re.T.reshape(nb, da, db), psi0.im.T.reshape(nb, da, db))
        if solver in (SolverType.DP5_SE, SolverType.RK4_SE, SolverType.DP5_SE_F32,
                      SolverType.RK4_SE_F32):
            states = sesolve(ham_data, p, grid, solver=solver, substeps=substeps,
                             **{k: opts[k] for k in _SESOLVE_OPTIONS if k in opts})
        elif solver in self._PALLAS_METHODS:
            method = self._PALLAS_METHODS[solver]
            states = evolve_states(
                ham_data, p, grid.refined(substeps), method=method,
                ckpt=self._route_ckpt(ckpt, ham_data, method),
            )
        else:
            raise ValueError(f"Solver {solver} not available.")
        n_eval = states.re.shape[0]
        return Cplx(
            states.re.reshape(n_eval, nb, dim).transpose(1, 2),
            states.im.reshape(n_eval, nb, dim).transpose(1, 2),
        )

    def _wrap_coherent(self, states: Cplx) -> CoherentResults:
        h = self._hamiltonian
        results = [
            QuantumResult(tuple(h._qdict), h.basis_name, states[i])
            for i in range(states.re.shape[0])
        ]
        return CoherentResults(results, h._size, h.basis_name, self._eval_times_array)

    def expectation_fn_of_dists(self, obs: Any, solver: str = SolverType.DP5_SE,
                                **options: Any) -> Callable[[torch.Tensor], torch.Tensor]:
        """Function: pair distances -> expectation trace (n_eval,).

        It takes a (n_pairs,) tensor ordered like ``qq_distance_keys`` and
        rebuilds the interaction with those distances; differentiate it
        with torch.autograd.  Routed as ``run`` routes: on CUDA DP5_SE
        takes the fused kernels."""
        from pulser_diff_torch.hamiltonian import zero_noise_draws
        from pulser_diff_torch.ops.linalg import expect as _expect

        obs = as_cplx(obs, dtype=DTYPE, device=self.torch_device).to(device=self.torch_device)
        h = self._hamiltonian
        keys = self.qq_distance_keys
        substeps = int(options.get("substeps", self._auto_substeps(options)))
        grid = TimeGrid.make(h.sampling_times, self._eval_times_array, self.torch_device)
        draws = zero_noise_draws(h._size, h._count_noise_slots(), self.torch_device)

        def fn(dist_values: torch.Tensor) -> torch.Tensor:
            h._dist_override = dict(zip(keys, dist_values))
            try:
                hd = h.build_data(draws)
            finally:
                h._dist_override = {}
            states = self._solve_states(hd, solver, substeps, grid, solver_opts=options)
            return _expect(obs, states).re

        return fn

    def run(self, time_grad: bool = False, dist_grad: bool = False,
            solver: str = SolverType.DP5_SE, **options: Any) -> CoherentResults:
        """Simulate the sequence on the emulator's device.

        ``time_grad`` / ``dist_grad`` are taken for parity with the JAX
        package and warn, as there: gradients in the evaluation times or
        the distances come from differentiating a function
        (``expectation_fn_of_dists``); ``dist_grad`` fills ``dist_dict``
        with the pair distances.

        Options: ``substeps`` / ``max_step`` (fixed-step refinement),
        ``fused`` (True / False to force the fused kernels or the f64
        stepper), ``ckpt`` (True / False to force the checkpointed fused
        kernels K4/K5 or K1/K2; by default they run from dim 2^16 and
        wherever K1/K2 cannot hold the shape), ``remat`` / ``n_segments``
        (the steppers' checkpointed integration)."""
        check_options(options, "run()")
        h = self._hamiltonian
        if time_grad:
            warnings.warn(
                "run(time_grad=True) only exposes metadata: gradients with respect "
                "to evaluation times come from differentiating a function of them.",
                UserWarning, stacklevel=2,
            )
        if dist_grad:
            warnings.warn(
                "run(dist_grad=True) only exposes qq_distances: gradients with respect "
                "to inter-qubit distances flow through the function returned by "
                "expectation_fn_of_dists().",
                UserWarning, stacklevel=2,
            )
            self.dist_dict.update(h._dist_dict)
        substeps = self._auto_substeps(options)
        grid = TimeGrid.make(h.sampling_times, self._eval_times_array, self.torch_device)
        states = self._solve_states(h._ham_data, solver, substeps, grid, solver_opts=options)
        return self._wrap_coherent(states)

    # ------------------------------------------------------------------
    @classmethod
    def from_sequence(
        cls,
        sequence: Sequence,
        sampling_rate: float = 1.0,
        config: Optional[SimConfig] = None,
        evaluation_times: Union[float, str, Any] = "Full",
        *,
        device: DeviceLike = None,
    ) -> "TorchEmulator":
        """Build an emulator straight from a built Sequence, on ``device``
        (CUDA unless ``"cpu"`` is passed)."""
        torch_device = resolve_device(device)
        if not isinstance(sequence, Sequence):
            raise TypeError("The provided sequence has to be a valid Sequence instance.")
        if sequence.is_parametrized():
            raise ValueError(
                "The provided sequence needs to be built to be simulated. "
                "Call `Sequence.build()` with the necessary parameters."
            )
        if not sequence._schedule:
            raise ValueError("The provided sequence has no declared channels.")
        if all(not slots or slots[-1].tf == 0 for slots in sequence._schedule.values()):
            raise ValueError("No instructions given for the channels in the sequence.")
        return cls(
            sample(sequence, extended_duration=sequence.get_duration(), device=torch_device),
            sequence.register,
            sequence.device,
            sampling_rate,
            config,
            evaluation_times,
            torch_device=torch_device,
        )

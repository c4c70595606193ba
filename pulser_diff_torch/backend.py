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

Without noise ``run()`` returns :class:`CoherentResults`.  With the
stochastic noises of a ``SimConfig`` (``doppler``, ``amplitude``, SPAM
state-preparation errors) it draws one Hamiltonian per run, evolves the R
runs as one batch and samples bitstrings on the device, with the SPAM
detection flips, into :class:`NoisyResults` (``_route_noisy`` decides the
batch's solver: on CUDA one forward launch of K1, or of K4 where K1's
cluster does not hold the shape).  The Lindblad noises (``dephasing``,
``relaxation``, ``depolarizing``, ``eff_noise``) reroute any
Schrodinger solver to ``DP5_ME``, as the JAX package does: ``mesolve`` on
the density matrix, returned as :class:`CoherentResults` over density
matrices, or one ``mesolve`` a run under stochastic noise;
``solver="MCWF"`` / ``"MCWF_F32"`` unravel them into quantum-jump
trajectories instead (``_run_mcwf``), sampled into :class:`NoisyResults`.
``expectation_fn_of_dists`` differentiates an expectation in the
inter-qubit distances, through the coherent routing;
``expectation_fn_of_times`` in the evaluation times, on the f64 stepper.
Every basis runs: ground-rydberg, digital (Raman channels), all (three
levels a site, da = 3^a on the fused kernels), XY, and the
leakage-extended ones.
"""

from __future__ import annotations

import itertools
import warnings
from collections import Counter
from dataclasses import asdict
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from pulser_diff_torch.config import DeviceLike, default_dtype, resolve_device
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.sampler import SequenceSamples, sample
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.hamiltonian import DRAW_FIELDS, Hamiltonian, draw_noise, zero_noise_draws
from pulser_diff_torch.ops.fused_evolution import (
    _NB_MAX, _tableau, check_parts, cluster_fits, cluster_plan, evolve_mc, evolve_states,
)
from pulser_diff_torch.result import _ONE_LABEL, QuantumResult, _level_projection_matrix
from pulser_diff_torch.simconfig import NoiseModel, SimConfig, host_float
from pulser_diff_torch.simresults import CoherentResults, NoisyResults, SampledResult
from pulser_diff_torch.solvers import SolverType, TimeGrid, mcsolve, mesolve, sesolve
from pulser_diff_torch.solvers.solver import ME_SOLVERS

_LINDBLAD_NOISES = {"dephasing", "relaxation", "depolarizing", "eff_noise"}
_DETERMINISTIC_NOISES = _LINDBLAD_NOISES | {"SPAM", "amplitude", "leakage"}
_MCWF_SOLVERS = (SolverType.MCWF, SolverType.MCWF_F32)

# solver options accepted by run(**options) and QuantumModel: the JAX
# package's set
_RUN_OPTIONS = {
    "substeps", "max_step", "krylov_dim", "krylov_tol", "rtol", "atol", "max_iters", "fused",
    "superop", "me_form", "remat", "n_segments", "n_traj", "ckpt",
}
# the options that go on to sesolve (mesolve takes the last two)
_SESOLVE_OPTIONS = ("rtol", "atol", "max_iters", "krylov_tol", "remat", "n_segments")
_MESOLVE_OPTIONS = ("remat", "n_segments")
_SE_SOLVERS = (SolverType.DP5_SE, SolverType.RK4_SE, SolverType.KRYLOV_SE,
               SolverType.KRYLOV_SE_F32, SolverType.DP5_SE_ADAPTIVE, SolverType.DP5_SE_F32,
               SolverType.RK4_SE_F32)


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
    # kernels' ceiling for paths that never differentiate (the noisy batch
    # of run()), and the switch to the checkpointed adjoint (K4/K5)
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
        # the sequence's measurement basis, else the Hamiltonian's (digital
        # for the digital and all bases)
        basis_name = self._hamiltonian.basis_name
        self._meas_basis = self.samples_obj._measurement or (
            "digital" if basis_name in ("digital", "all") else basis_name)
        self.set_initial_state("all-ground")
        # pair distances, filled by run(dist_grad=True)
        self.dist_dict: dict[str, torch.Tensor] = {}
        # seeds every draw of run() (unseeded, as in the JAX package)
        self._rng = np.random.default_rng()

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
    def basis(self) -> dict[str, Cplx]:
        """The one-site kets of the basis, by level label."""
        return self._hamiltonian.basis

    @property
    def config(self) -> SimConfig:
        return SimConfig.from_noise_model(self._hamiltonian.config)

    def _check_supported(self, cfg: SimConfig) -> None:
        interaction = self._hamiltonian._interaction
        not_supported = set(cfg.noise) - cfg.supported_noises[interaction]
        if not_supported:
            raise NotImplementedError(
                f"Interaction mode '{interaction}' does not support simulation of noise "
                f"types: {', '.join(not_supported)}."
            )

    def set_config(self, cfg: SimConfig) -> None:
        if not isinstance(cfg, SimConfig):
            raise ValueError(f"Object {cfg} is not a valid `SimConfig`.")
        self._check_supported(cfg)
        self._hamiltonian.set_config(cfg.to_noise_model())

    def add_config(self, config: SimConfig) -> None:
        """Merge in the noise types of ``config`` with the parameters they
        need; the other parameters stay."""
        if not isinstance(config, SimConfig):
            raise ValueError(f"Object {config} is not a valid `SimConfig`")
        self._check_supported(config)
        old = self._hamiltonian.config
        new_nm = config.to_noise_model()
        old_noises = set(old.noise_types)
        params = asdict(old)
        params["noise_types"] = tuple(old_noises | set(new_nm.noise_types))
        relevant = NoiseModel._find_relevant_params(
            set(new_nm.noise_types) - old_noises, new_nm.state_prep_error, new_nm.amp_sigma,
            new_nm.laser_waist,
        )
        for p in relevant:
            params[p] = getattr(new_nm, p)
        self._hamiltonian.set_config(NoiseModel(**params))

    def show_config(self, solver_options: bool = False) -> None:
        print(self.config.__str__(solver_options))

    def reset_config(self) -> None:
        self._hamiltonian.set_config(SimConfig().to_noise_model())

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
            ket = torch.zeros((h.dim**h._size, 1), dtype=default_dtype(), device=dev)
            ket[pos, 0] = 1.0
            self._initial_state = Cplx(ket, torch.zeros_like(ket))
            self._initial_is_ground = True
            return
        st = as_cplx(state, dtype=default_dtype(), device=dev).to(device=dev)
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
    def endtimes(self) -> list:
        """The pulse slots' boundaries as indices of the sampled grid (two
        a slot end, and 0), for ``deriv_time``'s repair of the time
        derivative there."""
        end_ts = [0]
        remaining = np.linspace(0, self._tot_duration,
                                int(self._sampling_rate * (self._tot_duration + 1))).astype(int)
        for cs in self.samples_obj.channel_samples.values():
            for sl in cs.slots:
                pos = int(np.searchsorted(remaining, sl.tf, side="left"))
                end_ts += [pos - 1, pos]
        return sorted(end_ts)

    def build_operator(self, operations) -> Cplx:
        """The dense operator on the register of ``[(op, qubits), ...]``
        (``Hamiltonian.build_operator``)."""
        return self._hamiltonian.build_operator(operations)

    def get_hamiltonian(self, time: float) -> Cplx:
        """The dense H at ``time`` (ns) of the noiseless build, or of the
        current draw under stochastic noise."""
        if time > self._tot_duration:
            raise ValueError(
                f"Provided time (`time` = {time}) must be less than or equal to the sequence "
                f"duration ({self._tot_duration}).")
        if time < 0:
            raise ValueError(
                f"Provided time (`time` = {time}) must be greater than or equal to 0.")
        return self._hamiltonian._hamiltonian(time / 1000)

    @property
    def evaluation_times(self) -> torch.Tensor:
        return torch.as_tensor(self._eval_times_array, dtype=default_dtype(),
                               device=self.torch_device)

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
        h = self._hamiltonian
        hd = h._ham_data
        zmax = 0.0
        for streams, parts in ((hd.row_streams, hd.row_parts), (hd.col_streams, hd.col_parts)):
            s = streams.to_numpy()
            zmax += 2 * float(np.max(np.abs(s), axis=1) @ h.part_norms(parts)) if s.size else 0.0
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
        wherever K1 or K2 cannot hold the shape (their cluster plan, the
        launch's own rule, decided before any launch): 14 and 15 atoms, a
        state batch past nb = 2 at 12 atoms, the all basis from 7 atoms
        (one block a run at da = 3^a), which the JAX package runs on its
        VMEM kernels.  An
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
        """Run the routed solver; returns (n_eval, dim, nb) kets, or
        (n_eval, dim, dim) density matrices for the ME solvers (rho0 =
        sum over the initial batch of |psi><psi|)."""
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
        if solver in ME_SOLVERS:
            rho0 = Cplx(psi0.re @ psi0.re.T + psi0.im @ psi0.im.T,
                        psi0.im @ psi0.re.T - psi0.re @ psi0.im.T)
            return mesolve(ham_data, rho0, h._collapse_ops, h._size, h.dim, grid, solver=solver,
                           substeps=substeps, superop=opts.get("superop"),
                           me_form=opts.get("me_form"),
                           **{k: opts[k] for k in _MESOLVE_OPTIONS if k in opts})
        nb = psi0.shape[1]
        p = Cplx(psi0.re.T.reshape(nb, da, db), psi0.im.T.reshape(nb, da, db))
        if solver in _SE_SOLVERS:
            states = sesolve(ham_data, p, grid, solver=solver, substeps=substeps,
                             krylov_dim=int(opts.get("krylov_dim", 12)),
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

    def _wrap_coherent(self, states: Cplx,
                       meas_errors: Optional[Mapping[str, Any]] = None) -> CoherentResults:
        h = self._hamiltonian
        results = [
            QuantumResult(tuple(h._qdict), self._meas_basis, states[i],
                          self._meas_basis == h.basis_name, tuple(h._basis_labels))
            for i in range(states.re.shape[0])
        ]
        return CoherentResults(results, h._size, h.basis_name, self._eval_times_array,
                               self._meas_basis, meas_errors)

    def expectation_fn_of_dists(self, obs: Any, solver: str = SolverType.DP5_SE,
                                **options: Any) -> Callable[[torch.Tensor], torch.Tensor]:
        """Function: pair distances -> expectation trace (n_eval,).

        It takes a (n_pairs,) tensor ordered like ``qq_distance_keys`` and
        rebuilds the interaction with those distances; differentiate it
        with torch.autograd.  Routed as ``run`` routes: on CUDA DP5_SE
        takes the fused kernels."""
        from pulser_diff_torch.hamiltonian import zero_noise_draws
        from pulser_diff_torch.ops.linalg import expect as _expect

        obs = as_cplx(obs, dtype=default_dtype(), device=self.torch_device).to(
            device=self.torch_device)
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

    def expectation_fn_of_times(self, obs: Any, solver: str = SolverType.DP5_SE,
                                **options: Any) -> Callable[[torch.Tensor], torch.Tensor]:
        """Function: evaluation times (n_eval,) -> expectation trace
        (n_eval,), for ``deriv_time``.  The times keep the grid's structure
        (``TimeGrid.with_values``) and carry their gradient into its step
        sizes, so the solve takes the f64 stepper (``fused=False``), as in
        the JAX package: the fused kernels take the step sizes as
        constants."""
        from pulser_diff_torch.ops.linalg import expect as _expect

        obs = as_cplx(obs, dtype=default_dtype(), device=self.torch_device).to(
            device=self.torch_device)
        h = self._hamiltonian
        substeps = int(options.get("substeps", self._auto_substeps(options)))
        grid0 = TimeGrid.make(h.sampling_times, self._eval_times_array, self.torch_device)

        def fn(times: torch.Tensor) -> torch.Tensor:
            states = self._solve_states(h._ham_data, solver, substeps, grid0.with_values(times),
                                        solver_opts={**options, "fused": False})
            return _expect(obs, states).re

        return fn

    def run(self, time_grad: bool = False, dist_grad: bool = False,
            solver: str = SolverType.DP5_SE, **options: Any):
        """Simulate the sequence on the emulator's device.

        Without noise (and with SPAM measurement errors only) it returns
        :class:`CoherentResults`.  With doppler or amplitude noise (a
        nonzero ``amp_sigma``) it draws ``runs`` Hamiltonians, and with a
        SPAM state-preparation error ``eta`` > 0 alone it enumerates
        ``runs`` bad-atom configurations (repeats weighting the samples);
        either batch is evolved at once (``_route_noisy``) and sampled on
        the device into :class:`NoisyResults` of ``runs *
        samples_per_run`` shots a time.  With a Lindblad noise any solver
        but an ME or MCWF one becomes ``DP5_ME``: the density matrix
        evolves under ``mesolve`` (CoherentResults over density matrices,
        or one ``mesolve`` a run of a noisy batch); ``MCWF`` /
        ``MCWF_F32`` take ``_run_mcwf``.

        ``time_grad`` / ``dist_grad`` are taken for parity with the JAX
        package and warn, as there: gradients in the evaluation times or
        the distances come from differentiating a function
        (``expectation_fn_of_times`` with ``deriv_time``,
        ``expectation_fn_of_dists``); ``dist_grad`` fills ``dist_dict``
        with the pair distances.

        Options: ``substeps`` / ``max_step`` (fixed-step refinement),
        ``fused`` (True / False to force the fused kernels or the f64
        stepper), ``ckpt`` (True / False to force the checkpointed fused
        kernels K4/K5 or K1/K2; by default they run from dim 2^16 and
        wherever K1/K2 cannot hold the shape), ``remat`` / ``n_segments``
        (the steppers' checkpointed integration), ``krylov_dim`` /
        ``krylov_tol`` (``KRYLOV_SE`` / ``KRYLOV_SE_F32``), ``rtol`` /
        ``atol`` / ``max_iters`` (``DP5_SE_ADAPTIVE``), ``superop`` /
        ``me_form`` (the Lindblad form), ``n_traj`` (MCWF)."""
        check_options(options, "run()")
        h = self._hamiltonian
        cfg = h.config
        noise = set(cfg.noise_types)
        if time_grad:
            warnings.warn(
                "run(time_grad=True) only exposes metadata: gradients with respect "
                "to evaluation times flow through the function returned by "
                "expectation_fn_of_times() (see derivative.deriv_time).",
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
        meas_errors = None
        eta = host_float(cfg.state_prep_error)
        if "SPAM" in noise:
            meas_errors = {"epsilon": cfg.p_false_pos, "epsilon_prime": cfg.p_false_neg}
            if eta > 0 and not self._initial_is_ground:
                raise NotImplementedError(
                    "Can't combine state preparation errors with an initial state "
                    "different from the ground."
                )
        if noise & _LINDBLAD_NOISES and solver not in ME_SOLVERS + _MCWF_SOLVERS:
            solver = SolverType.DP5_ME
        substeps = self._auto_substeps(options)
        grid = TimeGrid.make(h.sampling_times, self._eval_times_array, self.torch_device)
        if solver in _MCWF_SOLVERS:
            return self._run_mcwf(solver, substeps, grid, options, meas_errors)
        deterministic = noise <= _DETERMINISTIC_NOISES and (
            "amplitude" not in noise or host_float(cfg.amp_sigma) == 0.0)
        if deterministic and ("SPAM" not in noise or eta == 0):
            states = self._solve_states(h._ham_data, solver, substeps, grid, solver_opts=options)
            return self._wrap_coherent(states, meas_errors)
        draws, reps, varying = self._draw_batch(deterministic)
        hams = h.build_batch(draws, varying)
        states = self._solve_batch(hams, solver, substeps, grid, options)
        return self._sample_noisy(states, reps, cfg.samples_per_run, cfg.runs, meas_errors)

    def _draw_batch(self, deterministic: bool) -> tuple[list, list, frozenset]:
        """The draws of a noisy batch, each run's repeats, and the draw
        fields that differ between runs.  SPAM state-preparation errors
        alone (``deterministic``): the bad-atom configurations of ``runs``
        draws, each once, its repeats weighting its samples.  Otherwise
        ``runs`` independent draws of every noise type."""
        h = self._hamiltonian
        cfg = h.config
        n_slots = h._count_noise_slots()
        if deterministic:
            eta = host_float(cfg.state_prep_error)
            configs = Counter(
                "".join(str(int(x)) for x in (self._rng.random(h._size) < eta))
                for _ in range(cfg.runs)
            ).most_common()
            draws = [zero_noise_draws(h._size, n_slots, self.torch_device)._replace(
                bad_atoms=torch.tensor([float(c) for c in bits], dtype=default_dtype(),
                                       device=self.torch_device)) for bits, _ in configs]
            return draws, [r for _, r in configs], frozenset({"bad_atoms"})
        gen = self._generator()
        draws = [draw_noise(gen, cfg, h._size, n_slots) for _ in range(cfg.runs)]
        varying = frozenset(DRAW_FIELDS[t] for t in cfg.noise_types if t in DRAW_FIELDS)
        return draws, [1] * cfg.runs, varying

    def _generator(self) -> torch.Generator:
        """A generator on the emulator's device, seeded from its host
        generator."""
        gen = torch.Generator(device=self.torch_device)
        gen.manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        return gen

    def _route_noisy(self, solver: str, options: Mapping[str, Any], pr: int, pc: int,
                     K: int = 0) -> tuple[str, Optional[str]]:
        """(solver, kernel) of a noisy batch, decided before any launch.

        The batch never differentiates, so the fused path is gated by the
        forward kernels' ceiling (``_FUSED_FWD_DIM_CAP``), as in the JAX
        package: on CUDA ``DP5_SE`` (and ``DP5_PALLAS`` / ``RK4_PALLAS`` on
        any device) takes ONE forward launch for all runs, ``"K1"`` where
        K1's cluster plan holds the shape, else ``"K4"`` (``ckpt=True`` /
        ``False`` forces one; ``False`` raises where K1 refuses).  Past the
        ceiling every run takes the f32 stepper on CUDA; ``fused=False``
        and the CPU take the f64 stepper (kernel None)."""
        h = self._hamiltonian
        dim = h.dim**h._size
        fused = options.get("fused")
        if solver in self._PALLAS_METHODS or (
                solver == SolverType.DP5_SE and fused is not False and self._fused_backend_ok()
                and dim < self._FUSED_FWD_DIM_CAP):
            check_parts(pr, pc)
            method = self._PALLAS_METHODS.get(solver, "DP5")
            shape = (int(self._initial_state.shape[1]), h.dim**h._a, h.dim**h._b, pr, pc, K,
                     _tableau(method)[2])
            ckpt = options.get("ckpt")
            if ckpt is None:
                ckpt = not cluster_fits(False, *shape)
            elif not ckpt:
                cluster_plan(False, *shape)
            run_solver = SolverType.RK4_PALLAS if method == "RK4" else SolverType.DP5_PALLAS
            return run_solver, ("K4" if ckpt else "K1")
        if solver == SolverType.DP5_SE and fused is not False and self._f32_xla_eligible():
            return SolverType.DP5_SE_F32, None
        return solver, None

    def _solve_batch(self, hams: list, solver: str, substeps: int, grid: TimeGrid,
                     options: Mapping[str, Any]) -> Cplx:
        """The R runs' states, (R, n_eval, dim, nb), without gradients:
        one fused forward launch, or one stepper solve per run."""
        hd = hams[0]
        K = 0 if hd.kron_row is None else int(hd.kron_row.shape[0])
        run_solver, kernel = self._route_noisy(
            solver, options, int(hd.row_parts.shape[0]), int(hd.col_parts.shape[0]), K)
        with torch.no_grad():
            if kernel is None:
                opts = {**options, "fused": False}
                st = [self._solve_states(ham, run_solver, substeps, grid, solver_opts=opts)
                      for ham in hams]
                return Cplx(torch.stack([s.re for s in st]), torch.stack([s.im for s in st]))
            h = self._hamiltonian
            da, db = h.dim**h._a, h.dim**h._b
            psi0 = self._initial_state
            nb = psi0.shape[1]
            p = Cplx(psi0.re.T.reshape(nb, da, db), psi0.im.T.reshape(nb, da, db))
            st = evolve_mc(hams, p, grid.refined(substeps), self._PALLAS_METHODS[run_solver],
                           ckpt=kernel == "K4")
        R, n_eval = st.re.shape[:2]
        return Cplx(st.re.reshape(R, n_eval, nb, da * db).transpose(2, 3),
                    st.im.reshape(R, n_eval, nb, da * db).transpose(2, 3))

    def _run_mcwf(self, solver: str, substeps: int, grid: TimeGrid, options: Mapping[str, Any],
                  meas_errors: Optional[Mapping[str, Any]]) -> NoisyResults:
        """Quantum-jump trajectories (``mcsolve``) of R = ``n_traj``
        (default ``runs``), sampled on the device into NoisyResults of R x
        ``samples_per_run`` shots a time, as the JAX package does.  With
        doppler, amplitude (``amp_sigma`` > 0) or SPAM preparation errors
        every trajectory draws its own Hamiltonian (``build_batch``) and is
        solved alone; otherwise the R trajectories are one batch.  Warns
        when the per-step jump probability bound passes 0.1 (one jump at
        most a step would bias the average)."""
        h = self._hamiltonian
        cfg = h.config
        noise = set(cfg.noise_types)
        psi0 = self._initial_state
        if psi0.shape[1] != 1:
            raise ValueError("MCWF requires a single (non-batched) initial state.")
        n_traj = int(options.get("n_traj", cfg.runs))
        drift = SolverType.DP5_SE if solver == SolverType.MCWF else SolverType.DP5_SE_F32
        da, db = h.dim**h._a, h.dim**h._b
        p0 = Cplx(psi0.re[:, 0].reshape(da, db), psi0.im[:, 0].reshape(da, db))
        collapse = h._collapse_ops
        eta = host_float(cfg.state_prep_error)
        if eta > 0 and not self._initial_is_ground:
            raise NotImplementedError(
                "Can't combine state preparation errors with an initial state different "
                "from the ground.")
        if collapse.ops is not None:
            self._warn_jump_probability(collapse, grid, substeps)
        stochastic = ("doppler" in noise or ("amplitude" in noise
                      and host_float(cfg.amp_sigma) > 0) or eta > 0)
        gen = self._generator()
        with torch.no_grad():
            if stochastic:
                draws = [draw_noise(gen, cfg, h._size, h._count_noise_slots())
                         for _ in range(n_traj)]
                varying = frozenset(DRAW_FIELDS[t] for t in noise if t in DRAW_FIELDS)
                st = [mcsolve(hd, p0, collapse, h._size, h.dim, grid, gen, 1, drift,
                              substeps).states for hd in h.build_batch(draws, varying)]
                st = Cplx(torch.cat([s_.re for s_ in st], 1), torch.cat([s_.im for s_ in st], 1))
            else:
                st = mcsolve(h._ham_data, p0, collapse, h._size, h.dim, grid, gen, n_traj, drift,
                             substeps).states  # (n_eval, R, da, db)
        n_eval = st.re.shape[0]
        states = Cplx(st.re.reshape(n_eval, n_traj, da * db).transpose(0, 1)[..., None],
                      st.im.reshape(n_eval, n_traj, da * db).transpose(0, 1)[..., None])
        return self._sample_noisy(states, [1] * n_traj, cfg.samples_per_run, n_traj,
                                  meas_errors)

    @staticmethod
    def _warn_jump_probability(collapse, grid: TimeGrid, substeps: int) -> None:
        """Warn when sum_m lambda_max(L_m^+ L_m) times the largest step
        passes 0.1 (host-side, before the solve)."""
        lz = collapse.ops.to_numpy()
        q = np.einsum("mji,mjk->mik", lz.conj(), lz)
        rate_bound = float(sum(np.linalg.eigvalsh(qm).max() for qm in q))
        t_np = grid.times.detach().cpu().numpy().astype(np.float64)
        dt_max = float(np.diff(t_np).max()) / max(int(substeps), 1)
        p_step = rate_bound * dt_max
        if p_step > 0.1:
            rec = int(np.ceil(p_step / 0.05)) * max(int(substeps), 1)
            warnings.warn(
                f"MCWF per-step jump probability bound is {p_step:.2f} (> 0.1): the "
                "one-jump-per-step resolution will bias trajectory averages away from the "
                f"master equation. Pass run(substeps={rec}) or use the density-matrix solvers.",
                UserWarning, stacklevel=4,
            )

    def _batched_weights(self, states_all: Cplx) -> torch.Tensor:
        """Measurement bitstring probabilities of a (R, n_eval, dim, nb)
        state batch (the batched form of QuantumResult._weights), in f64,
        normalised along the last axis: (R, n_eval, 2^n)."""
        h = self._hamiltonian
        full = h.dim**h._size
        re, im = states_all.re.to(torch.float64), states_all.im.to(torch.float64)
        if re.ndim == 4 and re.shape[-2] == re.shape[-1] == full:
            probs = torch.diagonal(re, dim1=-2, dim2=-1).abs()
        else:
            probs = (re**2 + im**2).reshape(re.shape[0], re.shape[1], -1)
        if h.dim == 2:
            if self._meas_basis != h.basis_name:
                probs = torch.zeros_like(probs)
                probs[..., 0] = 1.0
            elif self._meas_basis == "ground-rydberg":
                probs = torch.flip(probs, (-1,))  # r-first ordering -> bit order
        elif h.dim in (3, 4):
            # the bright level reads 1, every other level 0: one 0/1
            # projection (2^n, d^n) on the device
            labels = list(h._basis_labels)
            one_label = _ONE_LABEL.get(self._meas_basis)
            if one_label is None or one_label not in labels:
                raise RuntimeError(
                    f"Unknown measurement basis '{self._meas_basis}' for a {h.dim}-level system.")
            P = torch.as_tensor(_level_projection_matrix(h._size, h.dim, labels.index(one_label)),
                                dtype=probs.dtype, device=probs.device)
            probs = torch.einsum("ks,rts->rtk", P, probs)
        else:
            raise NotImplementedError("Cannot sample systems with single-atom dimension > 4.")
        weights = torch.clamp(probs, min=0.0)
        return weights / weights.sum(-1, keepdim=True)

    def _sample_noisy(self, states_all: Cplx, reps: list, samples_per_run: int, runs: int,
                      meas_errors: Optional[Mapping[str, Any]] = None) -> NoisyResults:
        """Bitstring statistics of a solved batch of noisy runs: the
        weights, the draws and the detection flips on the device
        (``_device_sample_counts``), one (n_eval, 2^n) count array back to
        the host."""
        n_per_run = torch.as_tensor(np.asarray(reps, dtype=np.int64) * samples_per_run,
                                    device=self.torch_device)
        eps = eps_p = 0.0
        if meas_errors is not None:
            eps = host_float(meas_errors["epsilon"])
            eps_p = host_float(meas_errors["epsilon_prime"])
        counts = _device_sample_counts(self._batched_weights(states_all), n_per_run,
                                       int(n_per_run.max()), self._generator(),
                                       self._hamiltonian._size, eps, eps_p)
        return self._noisy_from_counts(counts.cpu().numpy(), runs, samples_per_run)

    def _noisy_from_counts(self, counts_np: np.ndarray, runs: int,
                           samples_per_run: int) -> NoisyResults:
        """NoisyResults from a (n_eval, 2^n) integer count array."""
        h = self._hamiltonian
        results = []
        for row in counts_np:
            counter = Counter({np.binary_repr(int(i), width=h._size): int(row[i])
                               for i in np.nonzero(row)[0]})
            results.append(SampledResult(tuple(h._qdict), self._meas_basis, counter))
        return NoisyResults(results, h._size, h.basis_name, self._eval_times_array,
                            runs * samples_per_run)

    # ------------------------------------------------------------------
    def draw(self, draw_phase_area: bool = False, draw_phase_shifts: bool = False,
             draw_phase_curve: bool = False, fig_name: Optional[str] = None,
             kwargs_savefig: dict = {}) -> None:
        """Plot the sampled amp/det(/phase) per channel (the renderer is
        shared with Sequence.draw, core/drawing.py)."""
        from pulser_diff_torch.core.drawing import draw_channel_samples

        draw_channel_samples(
            self.samples_obj.channel_samples,
            draw_phase_area=draw_phase_area,
            draw_phase_shifts=draw_phase_shifts,
            draw_phase_curve=draw_phase_curve,
            fig_name=fig_name,
            kwargs_savefig=kwargs_savefig,
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_sequence(
        cls,
        sequence: Sequence,
        sampling_rate: float = 1.0,
        config: Optional[SimConfig] = None,
        evaluation_times: Union[float, str, Any] = "Full",
        with_modulation: bool = False,
        *,
        device: DeviceLike = None,
    ) -> "TorchEmulator":
        """Build an emulator straight from a built Sequence, on ``device``
        (CUDA unless ``"cpu"`` is passed); ``with_modulation=True`` samples
        the channels' modulated output, on a grid longer by the fall
        time."""
        torch_device = resolve_device(device)
        if not isinstance(sequence, Sequence):
            raise TypeError("The provided sequence has to be a valid Sequence instance.")
        if sequence.is_parametrized() or sequence.is_register_mappable():
            raise ValueError(
                "The provided sequence needs to be built to be simulated. "
                "Call `Sequence.build()` with the necessary parameters."
            )
        if not sequence._schedule:
            raise ValueError("The provided sequence has no declared channels.")
        if all(not slots or slots[-1].tf == 0 for slots in sequence._schedule.values()):
            raise ValueError("No instructions given for the channels in the sequence.")
        if with_modulation and sequence._slm_mask_targets:
            raise NotImplementedError(
                "Simulation of sequences combining an SLM mask and output "
                "modulation is not supported."
            )
        return cls(
            sample(sequence, modulation=with_modulation,
                   extended_duration=sequence.get_duration(include_fall_time=with_modulation),
                   device=torch_device),
            sequence.register,
            sequence.device,
            sampling_rate,
            config,
            evaluation_times,
            torch_device=torch_device,
        )


def _device_sample_counts(weights: torch.Tensor, n_per_run: torch.Tensor, n_max: int,
                          gen: torch.Generator, n_qubits: int, eps: float,
                          eps_p: float) -> torch.Tensor:
    """Bitstring sampling with the SPAM detection flips, on the weights'
    device.

    weights: (R, n_eval, K) probabilities, normalised in f64; n_per_run:
    (R,) sample counts.  Draws ``n_max`` samples per (run, time) with
    ``torch.multinomial``; flips each bit with probability ``eps`` (0 ->
    1) or ``eps_p`` (1 -> 0) by a uniform draw; drops each run's draws
    past its count; returns the (n_eval, K) int64 counts summed over the
    runs."""
    R, n_eval, K = weights.shape
    dev = weights.device
    samples = torch.multinomial(weights.reshape(R * n_eval, K), n_max, replacement=True,
                                generator=gen).reshape(R, n_eval, n_max)
    if eps > 0.0 or eps_p > 0.0:
        u = torch.rand((R, n_eval, n_max, n_qubits), generator=gen, dtype=weights.dtype,
                       device=dev)
        bit_pos = torch.arange(n_qubits, device=dev)
        bits = (samples[..., None] >> bit_pos) & 1
        p_flip = torch.tensor([eps, eps_p], dtype=weights.dtype, device=dev)[bits]
        flips = (u < p_flip).long()
        samples = samples ^ (flips << bit_pos).sum(-1)
    keep = torch.arange(n_max, device=dev)[None, :] < n_per_run.to(dev)[:, None]  # (R, n_max)
    cells = torch.arange(n_eval, device=dev)[None, :, None] * K + samples
    counts = torch.bincount(cells[keep[:, None, :].expand(R, n_eval, n_max)],
                            minlength=n_eval * K)
    return counts.reshape(n_eval, K)

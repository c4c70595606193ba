"""QuantumModel: trainable pulse sequences (counterpart of
pulser_diff_tpu/model.py).

An ``nn.Module`` whose trainable values are ``nn.Parameter``s, plus the
functional form ``expectation_fn(obs)(params)`` that the JAX package
differentiates with ``jax.value_and_grad``; here ``torch.autograd``
differentiates it.  Parameters are the declared sequence variables and
the custom-waveform callables ``{"name": ((p0, p1, ...), fn)}``, which
register one parameter per argument as ``name_0``, ``name_1``, ...
A qubit id with a value makes that qubit's coordinates trainable: the
register is rebuilt from the parameters on every call, so the gradient
reaches them through the interaction weights.  ``expectation_population_fn``
evaluates a stack of P candidate parameter sets: on CUDA below the fused
cap in one launch of the fused kernels, the candidates on their runs axis.

A ``noise_config`` with a Lindblad noise (dephasing, relaxation,
depolarizing, eff_noise) reroutes the solve to ``DP5_ME``, as the JAX
package does, so ``expectation_fn`` differentiates through ``mesolve``
(noise rates given as tensors included); ``expectation_mcwf_fn``
differentiates quantum-jump trajectories at fixed draws.

The constructor takes the JAX package's parameters in its order.
Duration optimisation, stochastic noise without a Lindblad noise
(``noise_config``: ROADMAP queue 1 item 11), ``constraints`` and ``fit``
are later slices: they raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
from torch import nn

from pulser_diff_torch.backend import _LINDBLAD_NOISES, TorchEmulator, check_options
from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.core.variables import Expr
from pulser_diff_torch.ops.fused_evolution import evolve_mc
from pulser_diff_torch.ops.linalg import expect as _expect
from pulser_diff_torch.ops.linalg import total_magnetization
from pulser_diff_torch.simconfig import SimConfig
from pulser_diff_torch.simresults import CoherentResults
from pulser_diff_torch.solvers import SolverType, TimeGrid, mcsolve
from pulser_diff_torch.solvers.mcwf import Uniforms
from pulser_diff_torch.solvers.solver import ME_SOLVERS


class QuantumModel(nn.Module):
    def __init__(
        self,
        seq: Sequence,
        trainable_param_values: Optional[Mapping[str, Any]] = None,
        constraints: Optional[Mapping[str, Any]] = None,
        sampling_rate: float = 1.0,
        solver: str = SolverType.DP5_SE,
        initial_state: Optional[Cplx] = None,
        noise_config: Optional[SimConfig] = None,
        time_grad: bool = False,
        dist_grad: bool = False,
        evaluation_times: Any = "Full",
        *,
        device: DeviceLike = None,
        **options: Any,
    ) -> None:
        super().__init__()
        if constraints:
            raise NotImplementedError(
                "Parameter constraints come with the training API (fit, "
                "check_constraints), which is not ported yet (ROADMAP queue 1 item 6).")
        if noise_config is not None and noise_config.noise and not (
                set(noise_config.noise) & _LINDBLAD_NOISES):
            raise NotImplementedError(
                f"A model with noise {tuple(noise_config.noise)} and no Lindblad noise is not "
                "ported yet: its gradient runs through a per-qubit Hamiltonian, which needs "
                "the adjoint kernels K2/K5 past 8 parts (ROADMAP queue 1 item 11). "
                "TorchEmulator.run() runs the noisy simulation.")
        check_options(options, "QuantumModel")
        self.torch_device = resolve_device(device)
        trainable_param_values = dict(trainable_param_values or {})
        self.constraints = dict(constraints or {})
        self.device = seq.device
        self.sampling_rate = sampling_rate
        self.solver = solver
        self.initial_state = initial_state
        self.noise_config = noise_config
        self.time_grad = time_grad
        self.dist_grad = dist_grad
        self.evaluation_times = evaluation_times
        self.options = options
        self._substeps_cache: Optional[int] = None
        self._seq = seq
        self.register = seq.register

        for call in seq._to_build_calls:
            if call.name == "add" and isinstance(call.args[0].amplitude._duration, Expr):
                raise NotImplementedError("Pulse-duration optimisation is not ported yet.")

        # custom-waveform callables: (params, fn)
        self.callables: dict[str, Callable] = {
            n: v[1]
            for n, v in trainable_param_values.items()
            if isinstance(v, tuple) and len(v) == 2 and callable(v[1])
        }
        callable_params = {n: trainable_param_values.pop(n)[0] for n in self.callables}

        self.params = nn.ParameterDict()
        declared = set(seq.declared_variables)
        qids = {str(q): q for q in self.register.qubit_ids}
        # qubit id -> its trainable coordinates' parameter name
        self.trainable_qubits: dict = {}
        for name, val in trainable_param_values.items():
            if name in qids:
                self.trainable_qubits[qids[name]] = name
            elif name not in declared:
                raise ValueError(
                    f"'{name}' is neither a declared sequence variable nor a register qubit id."
                )
            self.params[name] = nn.Parameter(self._tensor(val))
        for name, ptuple in callable_params.items():
            for i, v in enumerate(ptuple):
                self.params[f"{name}_{i}"] = nn.Parameter(self._tensor(v))

    def _tensor(self, v: Any) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.detach().to(dtype=DTYPE, device=self.torch_device).clone()
        return torch.as_tensor(v, dtype=DTYPE, device=self.torch_device)

    # ------------------------------------------------------------------
    def _build_values(self, params: Mapping[str, Any]) -> dict[str, Any]:
        """Values for Sequence.build: trainable leaves + callables."""
        values = {n: v for n, v in params.items() if n in self._seq.declared_variables}
        for name, fn in self.callables.items():
            args = []
            i = 0
            while f"{name}_{i}" in params:
                args.append(params[f"{name}_{i}"])
                i += 1
            values[name] = fn(*args)
        return values

    def _construct_register(self, params: Mapping[str, Any]) -> Register:
        """The register with the trainable coordinates from ``params``, all
        on the module's device."""
        coords = {q: c.to(self.torch_device) for q, c in self.register.qubits.items()}
        for qid, name in self.trainable_qubits.items():
            coords[qid] = params[name]
        return Register(coords)

    def _clone_with_register(self, register: Register) -> Sequence:
        """The sequence replayed on another register: the magnetic field,
        the XY mode, the variables and every call carried over."""
        new = Sequence(register, self.device)
        new._magnetic_field = self._seq._magnetic_field.copy()
        new._in_xy = self._seq._in_xy
        new._variables = dict(self._seq._variables)
        for call in self._seq._calls:
            getattr(new, call.name)(*call.args, **call.kwargs)
        new._to_build_calls = list(self._seq._to_build_calls)
        return new

    def _make_emulator(self, params: Mapping[str, Any]) -> TorchEmulator:
        seq = self._seq
        if self.trainable_qubits:
            seq = self._clone_with_register(self._construct_register(params))
        built = seq.build(**self._build_values(params)) if seq.is_parametrized() else seq
        sim = TorchEmulator.from_sequence(
            built,
            sampling_rate=self.sampling_rate,
            config=self.noise_config,
            evaluation_times=self.evaluation_times,
            device=self.torch_device,
        )
        if self.initial_state is not None:
            sim.set_initial_state(self.initial_state)
        return sim

    def _default_substeps(self) -> int:
        """Stability-driven substep count, computed once from the current
        parameter values and cached."""
        if self._substeps_cache is None:
            with torch.no_grad():
                sim = self._make_emulator(dict(self.params))
                self._substeps_cache = sim._auto_substeps({})
        return self._substeps_cache

    def _states_fn(self, params: Mapping[str, Any], force_no_fused: bool = False):
        """(eval_times, states) as a function of ``params``;
        ``force_no_fused`` pins the stepper (``fused=False``).  With a
        Lindblad noise any solver but an ME one becomes ``DP5_ME``, and
        the states are density matrices."""
        sim = self._make_emulator(params)
        h = sim._hamiltonian
        solver = self.solver
        if set(h.config.noise_types) & _LINDBLAD_NOISES and solver not in ME_SOLVERS:
            solver = SolverType.DP5_ME
        substeps = int(self.options.get("substeps", self._default_substeps()))
        grid = TimeGrid.make(h.sampling_times, sim._eval_times_array, self.torch_device)
        opts = {**self.options, "fused": False} if force_no_fused else self.options
        states = sim._solve_states(h._ham_data, solver, substeps, grid, solver_opts=opts)
        return sim._eval_times_array, states

    def _observable(self, obs: Optional[Cplx]) -> Cplx:
        """``obs`` on the module's device; by default the total
        magnetization in its diagonal form."""
        if obs is None:
            obs = total_magnetization(len(self.register.qubit_ids), dense=False,
                                      device=self.torch_device)
        return as_cplx(obs, dtype=DTYPE).to(device=self.torch_device)

    def expectation_fn(
        self, obs: Optional[Cplx] = None
    ) -> Callable[[Mapping[str, Any]], tuple]:
        """Function: params -> (eval_times, real expectation values)."""
        obs = self._observable(obs)

        def fn(params: Mapping[str, Any]):
            times, states = self._states_fn(params)
            return times, _expect(obs, states).re

        return fn

    def expectation_mcwf_fn(
        self, obs: Optional[Cplx] = None, *, key: Any, n_traj: int,
        substeps: Optional[int] = None, uniforms: Optional[Uniforms] = None,
    ) -> Callable[[Mapping[str, Any]], tuple]:
        """Function: params -> (eval_times, (n_eval,) expectation values
        averaged over ``n_traj`` quantum-jump trajectories (``mcsolve``),
        as the JAX package's: the Lindblad path at statevector cost.

        The draws are fixed: ``key`` (an int) seeds a fresh generator on
        the module's device at every call, or ``uniforms`` gives them, so
        autograd differentiates the drift, the jumps and the
        normalizations at fixed jump times and channels (the
        fixed-realization pathwise estimator, biased by the missing
        dependence of the jump statistics on the parameters).  The drift
        is ``DP5_SE``, or ``DP5_SE_F32`` when the model's solver is
        ``MCWF_F32``."""
        obs = self._observable(obs)
        drift = SolverType.DP5_SE_F32 if self.solver == SolverType.MCWF_F32 else SolverType.DP5_SE

        def fn(params: Mapping[str, Any]):
            sim = self._make_emulator(params)
            h = sim._hamiltonian
            grid = TimeGrid.make(h.sampling_times, sim._eval_times_array, self.torch_device)
            ss = int(substeps) if substeps is not None else int(
                self.options.get("substeps", self._default_substeps()))
            psi0 = sim.initial_state
            if psi0.re.shape[1] != 1:
                raise ValueError(
                    "expectation_mcwf_fn requires a single (non-batched) initial state.")
            da, db = h.dim**h._a, h.dim**h._b
            p0 = Cplx(psi0.re[:, 0].reshape(da, db), psi0.im[:, 0].reshape(da, db))
            gen = None
            if uniforms is None:
                gen = torch.Generator(device=self.torch_device)
                gen.manual_seed(int(key))
            st = mcsolve(h._ham_data, p0, h._collapse_ops, h._size, h.dim, grid, gen, n_traj,
                         drift, ss, uniforms=uniforms).states  # (n_eval, R, da, db)
            n_eval, R = st.re.shape[:2]
            # each trajectory's expectation, then their mean
            vals = _expect(obs, st.reshape(n_eval * R, da * db, 1)).re
            return sim._eval_times_array, vals.reshape(n_eval, R).mean(1)

        return fn

    def expectation_population_fn(
        self, obs: Optional[Cplx] = None
    ) -> Callable[[Mapping[str, Any]], tuple]:
        """Function: a stack of P candidate parameter sets (every value with
        a leading axis P) -> (eval_times, (P, n_eval) real expectation
        values).

        Where the solve is fused (``DP5_PALLAS`` / ``RK4_PALLAS``, or
        ``DP5_SE`` on CUDA below the fused cap unless ``fused=False``), the
        P Hamiltonians are staged together and solved in one launch of the
        forward kernel and one of the adjoint, the candidates on the runs
        axis (``evolve_mc``); K1/K2 or K4/K5 as ``TorchEmulator._route_ckpt``
        decides for one candidate (an explicit ``ckpt`` wins).  Elsewhere
        (the CPU by default, or from the cap) the candidates are solved one
        after another on the stepper.  Candidates do not interact, so the
        gradient of a loss summed over them is each candidate's gradient."""
        obs = self._observable(obs)

        def fn(param_stack: Mapping[str, Any]):
            n_pop = len(next(iter(param_stack.values())))
            cands = [{k: v[i] for k, v in param_stack.items()} for i in range(n_pop)]
            sim = self._make_emulator(cands[0])
            h = sim._hamiltonian
            times = sim._eval_times_array
            use_fused = (self.solver in TorchEmulator._PALLAS_METHODS or (
                self.solver == SolverType.DP5_SE
                and self.options.get("fused") is not False
                and sim._fused_eligible()
            )) and not set(h.config.noise_types) & _LINDBLAD_NOISES
            if not use_fused:
                vals = [_expect(obs, self._states_fn(p, force_no_fused=True)[1]).re
                        for p in cands]
                return times, torch.stack(vals)
            substeps = int(self.options.get("substeps", self._default_substeps()))
            grid = TimeGrid.make(h.sampling_times, times, self.torch_device)
            hams = [h._ham_data] + [self._make_emulator(p)._hamiltonian._ham_data
                                    for p in cands[1:]]
            psi0 = sim.initial_state  # (dim, nb)
            nb = psi0.shape[1]
            da, db = h.dim**h._a, h.dim**h._b
            p0 = Cplx(psi0.re.T.reshape(nb, da, db), psi0.im.T.reshape(nb, da, db))
            method = TorchEmulator._PALLAS_METHODS.get(self.solver, "DP5")
            ckpt = sim._route_ckpt(self.options.get("ckpt"), h._ham_data, method)
            st = evolve_mc(hams, p0, grid.refined(substeps), method=method, ckpt=ckpt)
            n_eval = st.re.shape[1]
            states = Cplx(st.re.reshape(n_pop, n_eval, nb, da * db).transpose(2, 3),
                          st.im.reshape(n_pop, n_eval, nb, da * db).transpose(2, 3))
            return times, torch.stack([_expect(obs, states[i]).re for i in range(n_pop)])

        return fn

    def _run(self) -> tuple[torch.Tensor, CoherentResults]:
        sim = self._make_emulator(dict(self.params))
        results = sim.run(time_grad=self.time_grad, dist_grad=self.dist_grad,
                          solver=self.solver, **self.options)
        return sim.evaluation_times, results

    def forward(self) -> tuple[torch.Tensor, Cplx]:
        """(eval_times, states (n_eval, dim, nb)) at the module's parameters,
        through ``TorchEmulator.run``."""
        times, results = self._run()
        return times, results.states

    def expectation(self, obs: Optional[Cplx] = None) -> tuple[torch.Tensor, Cplx]:
        """(eval_times, complex expectation values of ``obs``) at the
        module's parameters; by default the total magnetization."""
        times, results = self._run()
        return times, results.expect([self._observable(obs)])[0]

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
reaches them through the interaction weights.

Duration optimisation, noise and ``fit`` are later slices.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
from torch import nn

from pulser_diff_torch.backend import TorchEmulator
from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.core.variables import Expr
from pulser_diff_torch.ops.linalg import expect as _expect
from pulser_diff_torch.ops.linalg import total_magnetization
from pulser_diff_torch.solvers import SolverType, TimeGrid


class QuantumModel(nn.Module):
    def __init__(
        self,
        seq: Sequence,
        trainable_param_values: Optional[Mapping[str, Any]] = None,
        sampling_rate: float = 1.0,
        solver: str = SolverType.DP5_SE,
        initial_state: Optional[Cplx] = None,
        evaluation_times: Any = "Full",
        *,
        device: DeviceLike = None,
        **options: Any,
    ) -> None:
        super().__init__()
        self.torch_device = resolve_device(device)
        trainable_param_values = dict(trainable_param_values or {})
        self.device = seq.device
        self.sampling_rate = sampling_rate
        self.solver = solver
        self.initial_state = initial_state
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

    def _states_fn(self, params: Mapping[str, Any]):
        """(eval_times, states) as a function of ``params``."""
        sim = self._make_emulator(params)
        h = sim._hamiltonian
        substeps = int(self.options.get("substeps", self._default_substeps()))
        grid = TimeGrid.make(h.sampling_times, sim._eval_times_array, self.torch_device)
        states = sim._solve_states(
            h._ham_data, self.solver, substeps, grid, solver_opts=self.options
        )
        return sim._eval_times_array, states

    def expectation_fn(
        self, obs: Optional[Cplx] = None
    ) -> Callable[[Mapping[str, Any]], tuple]:
        """Function: params -> (eval_times, real expectation values)."""
        if obs is None:
            obs = total_magnetization(len(self.register.qubit_ids), dense=False,
                                      device=self.torch_device)
        obs = as_cplx(obs, dtype=DTYPE).to(device=self.torch_device)

        def fn(params: Mapping[str, Any]):
            times, states = self._states_fn(params)
            return times, _expect(obs, states).re

        return fn

    def forward(self, obs: Optional[Cplx] = None):
        """(eval_times, expectation values) at the module's parameters."""
        return self.expectation_fn(obs)(dict(self.params))

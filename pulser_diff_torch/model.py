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

A pulse whose duration is a sequence variable makes the durations
trainable, as in the JAX package: every pulse (constant waveforms only)
becomes a tanh-edged boxcar (``waveform_funcs.constant_waveform``) on a
grid padded to 64 ns (``_pad_duration``), so the duration is a smooth
parameter and a small update keeps the shapes.

``fit`` and ``fit_population`` train with ``torch.optim`` (Adam at lr
1e-2 by default, optax's default in the JAX package), clamping the
``constraints`` after every update (``check_constraints``).

A ``noise_config`` with a Lindblad noise (dephasing, relaxation,
depolarizing, eff_noise) reroutes the solve to ``DP5_ME``, as the JAX
package does, so ``expectation_fn`` differentiates through ``mesolve``
(noise rates given as tensors included); ``expectation_mcwf_fn``
differentiates quantum-jump trajectories at fixed draws.  Stochastic
noise (doppler, amplitude, SPAM) builds the Hamiltonian of one drawn
realization, all local (2 ceil(n / 2) parts a side), and differentiates
it through the fused kernels, which take up to 32 parts.  The draw rules
are the JAX package's, where the draw is a constant of each traced
program: an eager ``expectation_fn`` call draws anew; ``fit`` trains on
one realization (one per chunk length with ``steps_per_call``, one
compiled program each there); the candidates of a population share one.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping, Optional, Union
from uuid import uuid4

import numpy as np
import torch
from torch import nn

from pulser_diff_torch.backend import _LINDBLAD_NOISES, TorchEmulator, check_options
from pulser_diff_torch.config import DeviceLike, default_dtype, resolve_device
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.core.channels import Rydberg
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.sampler import ChannelSamples, SequenceSamples, _PulseTargetSlot
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.core.variables import Variable, VariableItem
from pulser_diff_torch.core.waveforms import ConstantWaveform
from pulser_diff_torch.hamiltonian import NoiseDraws
from pulser_diff_torch.ops.fused_evolution import evolve_mc
from pulser_diff_torch.ops.linalg import expect as _expect
from pulser_diff_torch.ops.linalg import total_magnetization
from pulser_diff_torch.simconfig import SimConfig
from pulser_diff_torch.simresults import CoherentResults
from pulser_diff_torch.solvers import SolverType, TimeGrid, mcsolve
from pulser_diff_torch.solvers.mcwf import Uniforms
from pulser_diff_torch.solvers.solver import ME_SOLVERS
from pulser_diff_torch.waveform_funcs import constant_waveform

# the noises whose draw enters the Hamiltonian (a realization per build)
_STOCHASTIC_NOISES = {"SPAM", "doppler", "amplitude"}


@dataclass
class Parameter:
    """Bookkeeping record for one model parameter."""

    name: str
    value: Union[int, float, torch.Tensor, None] = None
    trainable: bool = False
    type: str = ""


def _pad_duration(total_ns: int, chunk: int = 64) -> int:
    """Round the optimisation grid up to a chunk multiple, so that small
    duration updates keep the shapes."""
    return int(np.ceil(total_ns / chunk) * chunk)


def _adam(tensors: list) -> torch.optim.Optimizer:
    """The default optimiser: Adam at lr 1e-2 (optax.adam(1e-2)'s update)."""
    return torch.optim.Adam(tensors, lr=1e-2)


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
        # the pinned noise realization every emulator is built from (None:
        # each build draws its own)
        self._draws: Optional[NoiseDraws] = None

        # custom-waveform callables: (params, fn)
        self.callables: dict[str, Callable] = {
            n: v[1]
            for n, v in trainable_param_values.items()
            if isinstance(v, tuple) and len(v) == 2 and callable(v[1])
        }
        callable_params = {n: trainable_param_values.pop(n)[0] for n in self.callables}

        self.seq_abs_repr, self.optimize_duration, self.seq_params = self._get_abstract_repr(seq)

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
        for name, rec in self.seq_params.items():
            if rec.trainable and name not in self.params and name not in self.callables:
                raise ValueError(f"No value for trainable sequence parameter {name} is given.")
        for name, ptuple in callable_params.items():
            for i, v in enumerate(ptuple):
                self.params[f"{name}_{i}"] = nn.Parameter(self._tensor(v))

        # the static grid of duration optimisation
        if self.optimize_duration:
            self._t_max = _pad_duration(self._get_total_duration(self.params))
        self.update_sequence()

    def _tensor(self, v: Any) -> torch.Tensor:
        """A copy of ``v`` on the module's device (training updates it in
        place, so it never shares the caller's memory)."""
        if isinstance(v, torch.Tensor):
            v = v.detach()
        return torch.as_tensor(v, dtype=default_dtype(), device=self.torch_device).clone()

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

    # ------------------------------------------------------------------
    # abstract representation and duration optimisation
    # ------------------------------------------------------------------
    def _get_abstract_repr(self, seq: Sequence) -> tuple[list[dict], bool, dict[str, Parameter]]:
        """Each pulse's duration (under duration optimisation), amplitude,
        detuning and phase as Parameter records; whether a duration is a
        variable; the records by name."""
        pulses = [call.args[0] for call in list(seq._calls) + list(seq._to_build_calls)
                  if call.name == "add"]
        optimize_duration = any(
            isinstance(p.amplitude._duration, (Variable, VariableItem)) for p in pulses)
        params: dict[str, Parameter] = {}

        def _record(value: Any, kind: str) -> Parameter:
            if isinstance(value, (Variable, VariableItem)):
                rec = Parameter(value.var.name, trainable=True, type=kind)
            else:
                rec = Parameter(f"{kind[:4]}_var_{uuid4()}", value=value, trainable=False,
                                type=kind)
            params[rec.name] = rec
            return rec

        abs_repr = []
        for p in pulses:
            rec: dict[str, Any] = {}
            dur = p.amplitude._duration
            if optimize_duration:
                if isinstance(dur, (Variable, VariableItem)):
                    d_rec = Parameter(dur.var.name, trainable=True, type="duration")
                else:  # ns -> us
                    d_rec = Parameter(f"dur_var_{uuid4()}", value=float(dur) / 1000,
                                      trainable=False, type="duration")
                params[d_rec.name] = d_rec
                rec["duration"] = d_rec
            for key, wf in (("amplitude", p.amplitude), ("detuning", p.detuning)):
                if isinstance(wf, ConstantWaveform):
                    rec[key] = _record(wf.value, key)
                elif optimize_duration:
                    raise NotImplementedError(
                        f"{key} waveform type {type(wf).__name__} is not supported with "
                        "duration optimization.")
            rec["phase"] = _record(p.phase, "phase")
            abs_repr.append(rec)
        return abs_repr, optimize_duration, params

    def _param_value(self, rec: Parameter, params: Mapping[str, Any]) -> Any:
        return params[rec.name] if rec.trainable else rec.value

    def _get_total_duration(self, params: Mapping[str, Any]) -> int:
        """The pulses' total duration in ns (read on the host), plus a 5 ns
        margin."""
        total = 0
        for rec in self.seq_abs_repr:
            val = self._param_value(rec["duration"], params)
            # read on the host in f64, whatever the default dtype
            total += int(float(torch.as_tensor(val, dtype=torch.float64).detach()) * 1000)
        return total + 5

    def _opt_duration_samples(self, params: Mapping[str, Any]):
        """(amp, det, phase) on the padded grid of ``_t_max`` ns: each pulse
        a tanh-edged boxcar from the end of the one before."""
        dt = default_dtype()
        t = torch.arange(self._t_max, dtype=dt, device=self.torch_device)
        amp = det = phase = torch.zeros(self._t_max, dtype=dt, device=self.torch_device)
        ti: Any = 0
        for rec in self.seq_abs_repr:
            tf = ti + self._param_value(rec["duration"], params)
            amp = amp + constant_waveform(ti, tf, self._param_value(rec["amplitude"], params))(t)
            det = det + constant_waveform(ti, tf, self._param_value(rec["detuning"], params))(t)
            phase = phase + constant_waveform(ti, tf, self._param_value(rec["phase"], params))(t)
            ti = tf
        return amp, det, phase

    def _opt_duration_samples_obj(self, params: Mapping[str, Any],
                                  register: Register) -> SequenceSamples:
        """The synthesised samples on the sequence's first channel (a global
        Rydberg one if none is declared), in a field of (0, 0, 30)."""
        amp, det, phase = self._opt_duration_samples(params)
        ch = self._seq.declared_channels
        name, chan = next(iter(ch.items())) if ch else ("rydberg_global", None)
        chan = chan or Rydberg.Global()
        cs = ChannelSamples(
            amp=amp, det=det, phase=phase,
            slots=[_PulseTargetSlot(0, self._t_max, frozenset(register.qubit_ids))],
            addressing="Global", basis=chan.basis,
        )
        return SequenceSamples(channel_samples={name: cs},
                               _magnetic_field=np.array([0.0, 0.0, 30.0]),
                               _in_xy=chan.basis == "XY", qubit_ids=register.qubit_ids)

    # ------------------------------------------------------------------
    # emulator construction
    # ------------------------------------------------------------------
    @property
    def _stochastic(self) -> bool:
        """Whether the noise configuration draws a realization per build."""
        return self.noise_config is not None and bool(
            set(self.noise_config.noise) & _STOCHASTIC_NOISES)

    @contextmanager
    def _pinned(self, draws: Optional[NoiseDraws]) -> Iterator[None]:
        """Build every emulator from ``draws`` inside the block (an outer pin
        wins; without stochastic noise, or with ``None``, nothing is
        pinned)."""
        if draws is None or self._draws is not None or not self._stochastic:
            yield
            return
        self._draws = draws
        try:
            yield
        finally:
            self._draws = None

    def _draw(self) -> Optional[NoiseDraws]:
        """A fresh realization of the stochastic noise (None without it)."""
        if not self._stochastic:
            return None
        with torch.no_grad():
            return self._make_emulator(dict(self.params))._hamiltonian.draws

    def _make_emulator(self, params: Mapping[str, Any]) -> TorchEmulator:
        register = self._construct_register(params)
        pinned = self._draws is not None
        config = None if pinned else self.noise_config
        if self.optimize_duration:
            sim = TorchEmulator(
                self._opt_duration_samples_obj(params, register), register, self.device,
                sampling_rate=self.sampling_rate, config=config,
                evaluation_times=self.evaluation_times, torch_device=self.torch_device,
            )
        else:
            seq = self._seq
            if self.trainable_qubits:
                seq = self._clone_with_register(register)
            built = seq.build(**self._build_values(params)) if seq.is_parametrized() else seq
            sim = TorchEmulator.from_sequence(
                built,
                sampling_rate=self.sampling_rate,
                config=config,
                evaluation_times=self.evaluation_times,
                device=self.torch_device,
            )
        if pinned:
            sim._check_supported(self.noise_config)
            sim._hamiltonian.set_config(self.noise_config.to_noise_model(), draws=self._draws)
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
        return as_cplx(obs, dtype=default_dtype()).to(device=self.torch_device)

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
            # the candidates share one realization, as under jax.vmap
            with self._pinned(sim._hamiltonian.draws):
                return population(sim, cands)

        def population(sim: TorchEmulator, cands: list):
            n_pop = len(cands)
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

    # ------------------------------------------------------------------
    # bookkeeping and training
    # ------------------------------------------------------------------
    def check_constraints(self) -> None:
        """Clamp the trainable parameters to their constraint intervals, in
        place."""
        self._clamp(self.params)

    def update_sequence(self) -> None:
        """Re-materialise the register and the built sequence (``built_seq``)
        from the current parameters; under duration optimisation, grow the
        padded grid when the total duration outgrows it (the samples are
        synthesised, so ``built_seq`` is None)."""
        with torch.no_grad():
            if self.trainable_qubits:
                self.register = self._construct_register(self.params)
            if self.optimize_duration:
                total = self._get_total_duration(self.params)
                if total > self._t_max:
                    self._t_max = _pad_duration(total)
                self.built_seq = None
                return
            seq = self._seq
            if self.trainable_qubits:
                seq = self._clone_with_register(self.register)
            self.built_seq = (seq.build(**self._build_values(self.params))
                              if seq.is_parametrized() else seq)

    def _clamp(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Clamp, in place, each of ``tensors`` that has a constraint."""
        with torch.no_grad():
            for name, c in self.constraints.items():
                if name in tensors:
                    tensors[name].clamp_(c["min"], c["max"])

    @staticmethod
    def _chunks(total: int, steps_per_call: int, remainder_first: bool) -> list[int]:
        """The step counts of the chunks that ``steps_per_call`` cuts
        ``total`` steps into (the JAX package's compiled scan lengths)."""
        k = max(int(steps_per_call), 1)
        full, rem = divmod(total, k)
        if not rem:
            return [k] * full
        return [rem] + [k] * full if remainder_first else [k] * full + [rem]

    def fit(
        self,
        loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        epochs: int = 50,
        optimizer: Any = None,
        obs: Optional[Cplx] = None,
        verbose: bool = False,
        callback: Optional[Callable] = None,
        steps_per_call: int = 1,
    ) -> list[float]:
        """Optimise the trainable parameters; returns the loss of every epoch.

        Args:
            loss_fn: (eval_times, expectation_values) -> scalar loss.
            optimizer: a callable that takes the list of tensors to optimise
                and returns a ``torch.optim.Optimizer`` (default: Adam at lr
                1e-2), or an optimiser already built over ``parameters()``.
            steps_per_call: the epochs of one chunk; ``verbose`` and
                ``callback(epoch, loss, params)`` fire once a chunk, and
                each chunk length has its own noise realization, as each
                compiled scan length has in the JAX package.  The losses do
                not depend on it otherwise.

        Every update is followed by ``check_constraints``, and the sequence
        is updated at the end.  With stochastic noise every epoch of a chunk
        trains on one drawn realization.
        """
        params = list(self.params.values())
        opt = optimizer if isinstance(optimizer, torch.optim.Optimizer) else (
            optimizer or _adam)(params)
        exp_fn = self.expectation_fn(obs)
        draws: dict[int, Optional[NoiseDraws]] = {}
        losses: list[float] = []
        for k in self._chunks(epochs, steps_per_call, remainder_first=False):
            if k not in draws:
                draws[k] = self._draw()
            with self._pinned(draws[k]):
                for _ in range(k):
                    opt.zero_grad()
                    loss = loss_fn(*exp_fn(dict(self.params)))
                    loss.backward()
                    opt.step()
                    self.check_constraints()
                    losses.append(float(loss.detach()))
            if verbose:
                print(f"epoch {len(losses) - 1}: loss={losses[-1]:.6f}")
            if callback is not None:
                callback(len(losses) - 1, losses[-1],
                         {n: p.detach().clone() for n, p in self.params.items()})
        self.update_sequence()
        return losses

    def fit_population(
        self,
        loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        param_stack: Mapping[str, Any],
        epochs: int = 50,
        optimizer: Any = None,
        obs: Optional[Cplx] = None,
        verbose: bool = False,
        steps_per_call: int = 1,
    ) -> tuple[list, dict[str, torch.Tensor]]:
        """Multi-start optimisation: P candidates (every value of
        ``param_stack`` with a leading axis P) advance in lock-step, each
        epoch one ``expectation_population_fn`` evaluation of all of them
        and one update of each.  The candidates are independent: the summed
        loss's gradient separates per candidate, and Adam's state is
        elementwise, so one optimiser over the stack is P optimisers.

        Args:
            loss_fn: (eval_times, (n_eval,) expectations) -> scalar, as for
                ``fit``; applied to each candidate.
            optimizer: a callable that takes the list of stacked tensors and
                returns a ``torch.optim.Optimizer`` (default: Adam at lr
                1e-2).
            steps_per_call: the epochs of one chunk (the remainder first);
                ``verbose`` fires once a chunk.

        Runs ``epochs + 1`` evaluations (the last one, of the final stack,
        without gradient) and tracks each candidate's best-ever loss from
        the stacks that produced it.  Returns ``(losses, final_stack)``:
        one (P,) array a epoch and the stack after ``epochs`` updates; the
        best candidate seen at any evaluation is loaded into the parameters.
        """
        if isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError("fit_population takes an optimizer factory: a callable of the "
                            "list of stacked tensors.")
        stack = {k: self._tensor(v).requires_grad_(True) for k, v in param_stack.items()}
        opt = (optimizer or _adam)(list(stack.values()))
        pop_fn = self.expectation_population_fn(obs)
        n_pop = int(next(iter(stack.values())).shape[0])
        best_loss = torch.full((n_pop,), math.inf, dtype=default_dtype(),
                               device=self.torch_device)
        best_stack = {k: v.detach().clone() for k, v in stack.items()}
        final_stack: dict[str, torch.Tensor] = {}
        draws: dict[int, Optional[NoiseDraws]] = {}
        losses: list = []
        for k in self._chunks(epochs + 1, steps_per_call, remainder_first=True):
            if k not in draws:
                draws[k] = self._draw()
            with self._pinned(draws[k]):
                for _ in range(k):
                    last = len(losses) == epochs
                    opt.zero_grad()
                    with torch.set_grad_enabled(not last):
                        times, vals = pop_fn(stack)
                        per = torch.stack([loss_fn(times, vals[i]) for i in range(n_pop)])
                    if not last:
                        per.sum().backward()
                    per = per.detach()
                    improved = per < best_loss
                    best_loss = torch.where(improved, per, best_loss)
                    best_stack = {
                        n: torch.where(improved.reshape((-1,) + (1,) * (v.ndim - 1)),
                                       stack[n].detach(), v)
                        for n, v in best_stack.items()}
                    final_stack = {n: v.detach().clone() for n, v in stack.items()}
                    if not last:
                        opt.step()
                        self._clamp(stack)
                    losses.append(per.cpu().numpy())
            if verbose:
                print(f"epoch {len(losses) - 1}: best={losses[-1].min():.6f} "
                      f"median={np.median(losses[-1]):.6f}")
        best = int(torch.argmin(best_loss))
        with torch.no_grad():
            for name, v in best_stack.items():
                self.params[name].copy_(v[best])
        self.update_sequence()
        return losses[:epochs], final_stack

"""Pulse sequence builder (counterpart of pulser_diff_tpu/core/sequence.py).

Channels (global and local, with retargeting), pulses under the three
scheduling protocols, delays, per-(basis, qubit) phase references with
``phase_shift`` and ``post_phase_shift`` and their phase barrier,
``align``, ``measure``, EOM mode, the SLM mask, ``switch_device``,
declared variables and deferred (parametrized) building, and the
abstract representation (``interop``).

A parametrized sequence is a template: ``seq.build(**values)`` evaluates
every deferred expression with tensors, so gradients flow from the values
through sampling and the Hamiltonian into the solver.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np
import torch

from pulser_diff_torch.core.channels import Channel
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.pulse import Pulse
from pulser_diff_torch.core.register import QubitId, Register
from pulser_diff_torch.core.variables import Expr, Variable


@dataclass
class _TimeSlot:
    """One scheduled item on a channel."""

    kind: str  # "pulse" | "delay" | "eom_delay" | "target"
    ti: int
    tf: int
    targets: frozenset
    pulse: Optional[Pulse] = None
    # "eom_delay" only: the locked off-detuning the drive idles at while
    # waiting inside an EOM block (amp 0, phase holds its last value)
    det_off: float = 0.0
    # "pulse" only: the targets' accumulated phase reference at add time
    # (per-(basis, qubit), advanced by phase_shift() and by each pulse's
    # post_phase_shift — pulser semantics, shared across channels of the
    # same basis). The sampler emits pulse.phase + phase_ref.
    phase_ref: Any = 0.0


@dataclass
class _Call:
    name: str
    args: tuple
    kwargs: dict


def _ref_group_key(v: Any):
    """Grouping key for phase-reference values: plain numbers group by
    value, tensors by object identity (the shared-object updates in
    phase_shift / _add_concrete keep equal references identical)."""
    if isinstance(v, (int, float)):
        return ("f", float(v))
    return ("o", id(v))


def _host_float(v: Any) -> float:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return float(np.asarray(v))


def _same_phase_ref(refs: list) -> bool:
    """All the phase references equal (compared on the host)."""
    return len({_host_float(r) for r in refs}) <= 1


class Sequence:
    def __init__(self, register: Register, device: Device) -> None:
        device.validate_register(register)
        self._register = register
        self._device = device
        self._channels: dict[str, Channel] = {}
        self._schedule: dict[str, list[_TimeSlot]] = {}
        self._last_target: dict[str, frozenset] = {}
        self._basis_per_channel: dict[str, str] = {}
        self._variables: dict[str, Variable] = {}
        self._calls: list[_Call] = []  # concrete calls
        self._to_build_calls: list[_Call] = []  # parametrized calls
        self._measurement: Optional[str] = None
        self._slm_mask_targets: frozenset = frozenset()
        self._magnetic_field = np.array([0.0, 0.0, 30.0])
        self._in_xy: bool = False
        # EOM mode state: channel -> (amp_on, detuning_on, detuning_off)
        self._eom_state: dict[str, tuple] = {}
        # closed/open EOM intervals per channel: [ti, tf | None]
        self._eom_blocks: dict[str, list[list]] = {}
        # EOM phase-drift reference per channel: last time the drive
        # left a pulse while in EOM mode (add_eom_pulse's
        # correct_phase_drift measures the det_off drift from here)
        self._eom_drift_ref: dict[str, int] = {}
        # per-(basis, qubit) phase bookkeeping (pulser's _basis_ref):
        # accumulated reference, last shift time (phase barrier), last
        # time the qubit was driven on that basis
        self._phase_ref: dict[tuple, Any] = {}
        self._phase_last_t: dict[tuple, int] = {}
        self._last_used: dict[tuple, int] = {}

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def register(self) -> Register:
        return self._register

    @property
    def device(self) -> Device:
        return self._device

    @property
    def declared_channels(self) -> dict[str, Channel]:
        return dict(self._channels)

    @property
    def declared_variables(self) -> dict[str, Variable]:
        return dict(self._variables)

    @property
    def magnetic_field(self) -> np.ndarray:
        return self._magnetic_field

    def is_parametrized(self) -> bool:
        return bool(self._to_build_calls)

    def is_register_mappable(self) -> bool:
        return False

    def get_duration(
        self, channel: str | None = None, include_fall_time: bool = False
    ) -> int:
        def fall(name: str) -> int:
            ch = self._channels.get(name)
            return ch.fall_time if (include_fall_time and ch) else 0

        if channel is not None:
            slots = self._schedule.get(channel, [])
            return (slots[-1].tf + fall(channel)) if slots else 0
        return max(
            (s[-1].tf + fall(name) for name, s in self._schedule.items() if s),
            default=0,
        )

    # ------------------------------------------------------------------
    # declarations
    # ------------------------------------------------------------------
    def declare_channel(
        self,
        name: str,
        channel_id: str,
        initial_target: QubitId | Iterable[QubitId] | None = None,
    ) -> None:
        if name in self._channels:
            raise ValueError(f"Channel '{name}' already declared.")
        ch_objs = self._device.channel_objects
        if channel_id not in ch_objs:
            raise ValueError(
                f"Device '{self._device.name}' has no channel '{channel_id}'. "
                f"Available: {sorted(ch_objs)}"
            )
        ch = ch_objs[channel_id]
        if ch.basis == "XY":
            if self._channels and not self._in_xy:
                raise ValueError(
                    "Microwave channels can't be combined with other bases."
                )
            self._in_xy = True
        elif self._in_xy:
            raise ValueError(
                "Can't declare a non-microwave channel in XY mode."
            )
        self._channels[name] = ch
        self._schedule[name] = []
        if ch.is_global:
            tgt = frozenset(self._register.qubit_ids)
        else:
            if initial_target is None:
                tgt = frozenset()
            else:
                tgt = self._as_targets(initial_target)
        self._last_target[name] = tgt
        self._calls.append(
            _Call("declare_channel", (name, channel_id, initial_target), {})
        )

    def declare_variable(
        self, name: str, size: int = 1, dtype: type = float
    ) -> Variable:
        if name in self._variables:
            raise ValueError(f"Variable '{name}' already declared.")
        var = Variable(name, size=size, dtype=dtype)
        self._variables[name] = var
        return var

    def set_magnetic_field(
        self, bx: float = 0.0, by: float = 0.0, bz: float = 30.0
    ) -> None:
        if not self._in_xy and self._channels:
            raise ValueError("Magnetic field can only be set in XY mode.")
        self._in_xy = True
        self._magnetic_field = np.array([bx, by, bz], dtype=float)

    # ------------------------------------------------------------------
    # schedule construction
    # ------------------------------------------------------------------
    def _as_targets(self, qubits: QubitId | Iterable[QubitId]) -> frozenset:
        if isinstance(qubits, (str, int)):
            qubits = [qubits]
        tgt = frozenset(qubits)
        unknown = tgt - set(self._register.qubit_ids)
        if unknown:
            raise ValueError(f"Unknown qubit ids: {unknown}")
        return tgt

    def _check_channel(self, channel: str) -> Channel:
        if channel not in self._channels:
            raise ValueError(f"Channel '{channel}' not declared.")
        return self._channels[channel]

    def add(
        self,
        pulse: Pulse,
        channel: str,
        protocol: str = "min-delay",
        _eom: bool = False,
        _drift_rate: Optional[float] = None,
    ) -> None:
        ch = self._check_channel(channel)
        if protocol not in ("min-delay", "no-delay", "wait-for-all"):
            raise ValueError(f"Invalid protocol '{protocol}'.")
        if not isinstance(pulse, Pulse):
            raise TypeError("add() requires a Pulse.")
        if channel in self._eom_state and not _eom:
            raise RuntimeError(
                f"Channel '{channel}' is in EOM mode: only add_eom_pulse() "
                "and delay() are allowed until disable_eom_mode()."
            )
        kwargs = {"protocol": protocol}
        if _eom:
            kwargs["_eom"] = True
        if pulse.is_parametrized or self.is_parametrized():
            self._to_build_calls.append(_Call("add", (pulse, channel), kwargs))
            return
        # _add_concrete returns the pulse as scheduled (the EOM phase-
        # drift correction depends on the scheduled start time); record
        # THAT one so serialization round-trips the effective phase
        pulse = self._add_concrete(pulse, channel, protocol, _drift_rate)
        self._calls.append(_Call("add", (pulse, channel), kwargs))

    def _add_concrete(
        self,
        pulse: Pulse,
        channel: str,
        protocol: str,
        drift_rate: Optional[float] = None,
    ) -> Pulse:
        ch = self._channels[channel]
        duration = pulse.duration
        if ch.max_amp is not None or ch.max_abs_detuning is not None:
            amp_s, det_s = pulse.amplitude.samples, pulse.detuning.samples
            # samples that carry gradients are skipped, as the JAX package
            # skips traced ones (a trainable pulse under optimisation)
            if not (amp_s.requires_grad or det_s.requires_grad):
                ch.validate_pulse(float(amp_s.abs().max()), float(det_s.abs().max()), duration)
        tgt = self._last_target[channel]
        basis = ch.basis
        refs = [self._phase_ref.get((basis, q), 0.0) for q in sorted(tgt, key=str)]
        if not _same_phase_ref(refs):
            raise ValueError(
                "Cannot do a multiple-target pulse on qubits with "
                "different phase references for the same basis."
            )
        phase_ref = refs[0] if refs else 0.0
        t0 = self.get_duration(channel)
        if protocol == "wait-for-all":
            t0 = max(t0, self.get_duration())
        elif protocol == "min-delay":
            for other, slots in self._schedule.items():
                if other == channel or not slots:
                    continue
                if self._last_target_at_end(other) & tgt:
                    t0 = max(t0, slots[-1].tf)
        # phase barrier: a pulse cannot start before the last phase
        # shift registered on its targets (pulser Schedule.add_pulse's
        # phase_barrier_ts)
        for q in tgt:
            t0 = max(t0, self._phase_last_t.get((basis, q), 0))
        ti, tf = t0, t0 + duration
        if drift_rate is not None:
            # EOM correct_phase_drift (pulser add_eom_pulse): the drive
            # idled at detuning_off since the drift reference; shift the
            # carrier phase by drift_rate * elapsed (rad/us * ns * 1e-3)
            ref_ti = self._eom_drift_ref.get(channel, ti)
            drift = drift_rate * (ti - ref_ti) * 1e-3
            pulse = Pulse(
                pulse.amplitude,
                pulse.detuning,
                pulse.phase + drift,
                pulse.post_phase_shift,
            )
        if ti > self.get_duration(channel):
            # implicit delay on this channel
            self._schedule[channel].append(
                _TimeSlot("delay", self.get_duration(channel), ti,
                          self._last_target[channel])
            )
        self._schedule[channel].append(
            _TimeSlot(
                "pulse", ti, tf, self._last_target[channel], pulse,
                phase_ref=phase_ref,
            )
        )
        for q in tgt:
            self._last_used[(basis, q)] = tf
        if not (
            isinstance(pulse.post_phase_shift, (int, float))
            and float(pulse.post_phase_shift) == 0.0
        ):
            updated: dict = {}
            for q in tgt:
                cur = self._phase_ref.get((basis, q), 0.0)
                gk = _ref_group_key(cur)
                if gk not in updated:
                    # once per distinct prior ref, so equal refs stay the
                    # same object (see phase_shift)
                    updated[gk] = cur + pulse.post_phase_shift
                self._phase_ref[(basis, q)] = updated[gk]
                # the post-shift happens AT the pulse's end: it must
                # barrier later pulses on these targets (pulser records
                # it at the qubit's last_used time, i.e. tf)
                self._phase_last_t[(basis, q)] = tf
        if channel in self._eom_state:
            # the drive idles at det_off again from this pulse's end
            self._eom_drift_ref[channel] = tf
        return pulse

    def _last_target_at_end(self, channel: str) -> frozenset:
        return self._last_target[channel]

    def delay(self, duration: Any, channel: str) -> None:
        self._check_channel(channel)
        if isinstance(duration, Expr) or self.is_parametrized():
            self._to_build_calls.append(_Call("delay", (duration, channel), {}))
            return
        d = int(duration)
        if channel in self._eom_state:
            # in EOM mode the drive idles at the locked off-detuning with
            # zero amplitude; the phase stream holds its last value (the
            # dedicated slot kind keeps the sampler from treating this as
            # a pulse, which would reset the phase — pulser semantics)
            _, _, det_off = self._eom_state[channel]
            t0 = self.get_duration(channel)
            self._schedule[channel].append(
                _TimeSlot(
                    "eom_delay", t0, t0 + d, self._last_target[channel],
                    det_off=float(det_off),
                )
            )
            self._calls.append(_Call("delay", (duration, channel), {}))
            return
        t0 = self.get_duration(channel)
        self._schedule[channel].append(
            _TimeSlot("delay", t0, t0 + d, self._last_target[channel])
        )
        self._calls.append(_Call("delay", (duration, channel), {}))

    # ------------------------------------------------------------------
    # EOM mode (pulser's enable_eom_mode / add_eom_pulse /
    # disable_eom_mode)
    # ------------------------------------------------------------------
    def is_in_eom_mode(self, channel: str) -> bool:
        self._check_channel(channel)
        return channel in self._eom_state

    def enable_eom_mode(
        self,
        channel: str,
        amp_on: float,
        detuning_on: float,
        optimal_detuning_off: float = 0.0,
    ) -> None:
        """Lock the channel into EOM mode: square pulses at
        (amp_on, detuning_on); idle periods sit at the achievable
        off-detuning closest to ``optimal_detuning_off`` (see
        core.eom.RydbergEOM.calculate_detuning_off)."""
        ch = self._check_channel(channel)
        if ch.eom_config is None:
            raise TypeError(
                f"Channel '{channel}' does not have an EOM configuration."
            )
        if channel in self._eom_state:
            raise RuntimeError(f"Channel '{channel}' is already in EOM mode.")
        if self.is_parametrized():
            self._to_build_calls.append(
                _Call(
                    "enable_eom_mode",
                    (channel, amp_on, detuning_on, optimal_detuning_off),
                    {},
                )
            )
            return
        det_off = ch.eom_config.calculate_detuning_off(
            float(amp_on), float(detuning_on), float(optimal_detuning_off)
        )
        # switching buffer when the channel already carries output
        if self._schedule[channel] and ch.eom_config.buffer_time > 0:
            t0 = self.get_duration(channel)
            self._schedule[channel].append(
                _TimeSlot(
                    "delay", t0, t0 + ch.eom_config.buffer_time,
                    self._last_target[channel],
                )
            )
        self._eom_state[channel] = (
            float(amp_on), float(detuning_on), det_off
        )
        self._eom_blocks.setdefault(channel, []).append(
            [self.get_duration(channel), None]
        )
        # phase-drift reference: the drive idles at det_off from here on
        # (advanced to each EOM pulse's end as they are added)
        self._eom_drift_ref[channel] = self.get_duration(channel)
        self._calls.append(
            _Call(
                "enable_eom_mode",
                (channel, amp_on, detuning_on, optimal_detuning_off),
                {},
            )
        )

    def add_eom_pulse(
        self,
        channel: str,
        duration: Any,
        phase: Any,
        post_phase_shift: Any = 0.0,
        protocol: str = "min-delay",
        correct_phase_drift: bool = False,
    ) -> None:
        """Add a square pulse at the EOM operating point (pulser's
        add_eom_pulse: duration + phase are the only free knobs).

        ``correct_phase_drift`` shifts the carrier phase by
        ``-detuning_off * elapsed`` where ``elapsed`` is the idle time
        at the locked off-detuning since the last EOM pulse (or the
        block start) — pulser's phase-drift correction, keeping the
        drive phase-coherent with the frame that rotated under
        ``detuning_off`` during the wait."""
        from pulser_diff_torch.core.waveforms import ConstantWaveform

        if not self.is_in_eom_mode(channel):
            if self.is_parametrized() and any(
                c.name == "enable_eom_mode" and c.args[0] == channel
                for c in self._to_build_calls
            ):
                self._to_build_calls.append(
                    _Call(
                        "add_eom_pulse",
                        (channel, duration, phase, post_phase_shift),
                        {
                            "protocol": protocol,
                            "correct_phase_drift": correct_phase_drift,
                        },
                    )
                )
                return
            raise RuntimeError(
                f"Channel '{channel}' must be in EOM mode (enable_eom_mode)."
            )
        amp_on, det_on, det_off = self._eom_state[channel]
        self.add(
            Pulse(
                ConstantWaveform(duration, amp_on),
                ConstantWaveform(duration, det_on),
                phase,
                post_phase_shift,
            ),
            channel,
            protocol=protocol,
            _eom=True,
            _drift_rate=-float(det_off) if correct_phase_drift else None,
        )

    def disable_eom_mode(self, channel: str) -> None:
        """Leave EOM mode (adds the switching buffer back out)."""
        ch = self._check_channel(channel)
        if self.is_parametrized():
            self._to_build_calls.append(
                _Call("disable_eom_mode", (channel,), {})
            )
            return
        if channel not in self._eom_state:
            raise RuntimeError(f"Channel '{channel}' is not in EOM mode.")
        del self._eom_state[channel]
        self._eom_blocks[channel][-1][1] = self.get_duration(channel)
        if ch.eom_config.buffer_time > 0:
            t0 = self.get_duration(channel)
            self._schedule[channel].append(
                _TimeSlot(
                    "delay", t0, t0 + ch.eom_config.buffer_time,
                    self._last_target[channel],
                )
            )
        self._calls.append(_Call("disable_eom_mode", (channel,), {}))

    def phase_shift(
        self, phi: Any, *targets: QubitId, basis: str = "digital"
    ) -> None:
        """Shift the phase reference of ``targets`` on ``basis`` by
        ``phi`` (pulser's ``Sequence.phase_shift``): every later pulse on
        a channel of that basis targeting those qubits picks up the
        accumulated reference on top of its own phase, and a pulse
        targeting qubits with *different* references raises.  ``phi`` may
        be a deferred Expr in a parametrized sequence."""
        if basis not in ("ground-rydberg", "digital", "XY"):
            raise ValueError(f"No phase reference for basis '{basis}'.")
        if not targets:
            raise ValueError("phase_shift requires at least one target.")
        tgt = self._as_targets(list(targets))
        if isinstance(phi, Expr) or self.is_parametrized():
            self._to_build_calls.append(
                _Call("phase_shift", (phi,) + tuple(targets), {"basis": basis})
            )
            return
        # the updated ref once per distinct prior ref: qubits that shared
        # a reference keep sharing one object (a tensor phi included)
        updated: dict = {}
        for q in tgt:
            key = (basis, q)
            cur = self._phase_ref.get(key, 0.0)
            gk = _ref_group_key(cur)
            if gk not in updated:
                updated[gk] = cur + phi
            self._phase_ref[key] = updated[gk]
            self._phase_last_t[key] = self._last_used.get(key, 0)
        self._calls.append(
            _Call("phase_shift", (phi,) + tuple(targets), {"basis": basis})
        )

    def current_phase_ref(
        self, qubit: QubitId, basis: str = "digital"
    ) -> Any:
        """The accumulated phase reference of ``qubit`` on ``basis``
        (pulser's ``Sequence.current_phase_ref``)."""
        if basis not in ("ground-rydberg", "digital", "XY"):
            raise ValueError(f"No phase reference for basis '{basis}'.")
        if qubit not in set(self._register.qubit_ids):
            raise ValueError(f"Unknown qubit id: {qubit}")
        return self._phase_ref.get((basis, qubit), 0.0)

    def phase_shift_index(
        self, phi: Any, *targets: int, basis: str = "digital"
    ) -> None:
        """Index-based variant of :meth:`phase_shift` (pulser's
        ``phase_shift_index``): targets are positions in the register's
        qubit-id order."""
        self.phase_shift(
            phi, *self._ids_from_indices(targets), basis=basis
        )

    def target_index(
        self, qubits: int | Iterable[int], channel: str
    ) -> None:
        """Index-based variant of :meth:`target` (pulser's
        ``target_index``)."""
        if isinstance(qubits, int):
            qubits = [qubits]
        self.target(self._ids_from_indices(qubits), channel)

    def _ids_from_indices(self, indices: Iterable[int]) -> tuple:
        ids = tuple(self._register.qubit_ids)
        out = []
        for i in indices:
            if not isinstance(i, (int, np.integer)):
                raise TypeError(
                    f"Indices must be ints, got {type(i).__name__}."
                )
            if not (0 <= int(i) < len(ids)):
                raise ValueError(
                    f"Index {i} out of range for {len(ids)} qubits."
                )
            out.append(ids[int(i)])
        return tuple(out)

    def align(self, *channels: str) -> None:
        """Insert delays so the named channels' schedules all reach the
        latest end among them (pulser's ``align``)."""
        if len(channels) < 2:
            raise ValueError("align requires at least two channels.")
        for ch in channels:
            self._check_channel(ch)
        if self.is_parametrized():
            self._to_build_calls.append(_Call("align", tuple(channels), {}))
            return
        t = max(self.get_duration(ch) for ch in channels)
        for ch in channels:
            gap = t - self.get_duration(ch)
            if gap > 0:
                self.delay(gap, ch)

    def is_measured(self) -> bool:
        return self._measurement is not None

    def get_measurement_basis(self) -> str:
        """The measurement basis (pulser parity: raises when the sequence
        has not been measured)."""
        if self._measurement is None:
            raise RuntimeError("The sequence has not been measured.")
        return self._measurement

    @property
    def available_channels(self) -> dict[str, Channel]:
        """Device channels that can still be declared (pulser parity):
        virtual devices reuse channel ids freely; physical devices
        exclude already-declared ids.  In XY mode only microwave
        channels remain available (and vice versa once a non-XY channel
        is declared)."""
        declared_ids = {
            c.args[1] for c in self._calls if c.name == "declare_channel"
        }
        out = {}
        for cid, ch in self._device.channel_objects.items():
            if not self._device.is_virtual and cid in declared_ids:
                continue
            if self._in_xy:
                # XY mode (declared microwave channel OR
                # set_magnetic_field): only microwave channels remain
                if ch.basis != "XY":
                    continue
            elif self._channels and ch.basis == "XY":
                continue
            out[cid] = ch
        return out

    def switch_device(
        self, new_device: Device, strict: bool = False
    ) -> "Sequence":
        """Re-run this sequence's build recipe against ``new_device``
        (pulser's ``switch_device``): the register is re-validated, each
        declared channel id must exist on the new device with the same
        addressing and basis (``strict`` additionally requires equal
        modulation bandwidth and retarget timings), and every recorded
        call is replayed so the new device's constraints re-validate all
        pulses."""
        decls = [c for c in self._calls if c.name == "declare_channel"]
        new_chs = new_device.channel_objects
        for c in decls:
            ch_name, cid = c.args[0], c.args[1]
            if cid not in new_chs:
                raise ValueError(
                    f"Device '{new_device.name}' has no channel '{cid}'."
                )
            old, new = self._device.channel_objects[cid], new_chs[cid]
            if (old.addressing, old.basis) != (new.addressing, new.basis):
                raise ValueError(
                    f"Channel '{cid}' differs in addressing/basis on "
                    f"'{new_device.name}'."
                )
            if strict and (
                old.mod_bandwidth != new.mod_bandwidth
                or old.min_retarget_interval != new.min_retarget_interval
                or old.fixed_retarget_t != new.fixed_retarget_t
                or old.eom_config != new.eom_config
            ):
                raise ValueError(
                    f"Channel '{cid}' differs in modulation/retarget "
                    f"timings or EOM configuration on "
                    f"'{new_device.name}' (strict switch)."
                )
            if (
                not strict
                and self._eom_blocks.get(ch_name)
                and new.eom_config is None
            ):
                raise ValueError(
                    f"Channel '{cid}' used EOM mode but has no EOM "
                    f"configuration on '{new_device.name}'."
                )
        new_seq = Sequence(self._register, new_device)
        new_seq._magnetic_field = self._magnetic_field.copy()
        new_seq._in_xy = self._in_xy
        for call in self._calls:
            getattr(new_seq, call.name)(*call.args, **call.kwargs)
        new_seq._variables = dict(self._variables)
        new_seq._to_build_calls = list(self._to_build_calls)
        return new_seq

    def target(self, qubits: QubitId | Iterable[QubitId], channel: str) -> None:
        ch = self._check_channel(channel)
        if ch.is_global:
            raise ValueError("Can't retarget a global channel.")
        if self.is_parametrized():
            self._to_build_calls.append(_Call("target", (qubits, channel), {}))
            return
        tgt = self._as_targets(qubits)
        if ch.max_targets is not None and len(tgt) > ch.max_targets:
            raise ValueError(
                f"Channel supports at most {ch.max_targets} targets."
            )
        t0 = self.get_duration(channel)
        retarget = max(ch.fixed_retarget_t, ch.min_retarget_interval if t0 > 0 else 0)
        self._schedule[channel].append(
            _TimeSlot("target", t0, t0 + retarget, tgt)
        )
        self._last_target[channel] = tgt
        self._calls.append(_Call("target", (qubits, channel), {}))

    def measure(self, basis: str = "ground-rydberg") -> None:
        if self._measurement is not None:
            raise RuntimeError("Sequence already measured.")
        valid = {"ground-rydberg", "digital", "XY"}
        if basis not in valid:
            raise ValueError(f"Measurement basis must be one of {valid}.")
        if self.is_parametrized():
            self._to_build_calls.append(_Call("measure", (basis,), {}))
            return
        self._measurement = basis
        self._calls.append(_Call("measure", (basis,), {}))

    def config_slm_mask(self, qubits: Iterable[QubitId]) -> None:
        if not self._device.supports_slm_mask:
            raise ValueError(f"Device '{self._device.name}' has no SLM mask.")
        if self._slm_mask_targets:
            raise ValueError("SLM mask already configured.")
        self._slm_mask_targets = self._as_targets(qubits)
        self._calls.append(_Call("config_slm_mask", (qubits,), {}))

    # ------------------------------------------------------------------
    # building parametrized sequences
    # ------------------------------------------------------------------
    def _set_register(self, register: Register) -> None:
        """Swap in a new register with identical qubit ids (pulser's
        Sequence._set_register equivalent, used by QuantumModel)."""
        if set(register.qubit_ids) != set(self._register.qubit_ids):
            raise ValueError("New register must have the same qubit ids.")
        self._register = register

    def build(self, **values: Any) -> "Sequence":
        """Return a concrete Sequence with all variables substituted."""
        missing = set(self._variables) - set(values)
        used: set[str] = set()
        for call in self._to_build_calls:
            for a in list(call.args) + list(call.kwargs.values()):
                if isinstance(a, Expr):
                    used |= a.variables()
                elif isinstance(a, Pulse) and a.is_parametrized:
                    for w in (a.amplitude, a.detuning):
                        if w.is_parametrized:
                            for pn in ("_duration",) + w._param_names:
                                v = getattr(w, pn, None)
                                if isinstance(v, Expr):
                                    used |= v.variables()
                    if isinstance(a.phase, Expr):
                        used |= a.phase.variables()
        missing_used = missing & used
        if missing_used:
            raise TypeError(f"Missing values for variables: {sorted(missing_used)}")

        new = Sequence(self._register, self._device)
        new._magnetic_field = self._magnetic_field.copy()
        new._in_xy = self._in_xy
        # replay concrete calls
        for call in self._calls:
            getattr(new, call.name)(*call.args, **call.kwargs)
        # replay parametrized calls with substituted values
        for call in self._to_build_calls:
            if call.name == "add":
                pulse, channel = call.args
                new.add(pulse.build(values), channel, **call.kwargs)
            elif call.name == "delay":
                dur, channel = call.args
                if isinstance(dur, Expr):
                    dur = int(np.round(_host_float(dur.evaluate(values))))
                new.delay(dur, channel)
            elif call.name == "phase_shift":
                phi = call.args[0]
                if isinstance(phi, Expr):
                    phi = phi.evaluate(values)
                new.phase_shift(phi, *call.args[1:], **call.kwargs)
            else:
                getattr(new, call.name)(*call.args, **call.kwargs)
        return new

    def to_abstract_repr(self, name: str = "pulser_diff_torch") -> str:
        """Serialize this built sequence to the pulser abstract-repr JSON
        dialect (method form of ``interop.to_abstract_repr``)."""
        from pulser_diff_torch.interop import to_abstract_repr

        return to_abstract_repr(self, name=name)

    @staticmethod
    def from_abstract_repr(obj: Any) -> "Sequence":
        """Rebuild a sequence from abstract-repr JSON (str or dict)."""
        from pulser_diff_torch.interop import from_abstract_repr

        return from_abstract_repr(obj)

    def draw(self, draw_phase_area: bool = False, draw_phase_shifts: bool = False,
             draw_phase_curve: bool = False, fig_name: Optional[str] = None,
             kwargs_savefig: dict = {}, *, device=None) -> None:
        """Plot the sequence's sampled channel streams (pulser's
        ``Sequence.draw``; the renderer is shared with TorchEmulator.draw),
        sampled on ``device`` (CUDA unless given)."""
        from pulser_diff_torch.core.drawing import draw_channel_samples
        from pulser_diff_torch.core.sampler import sample

        if self.is_parametrized():
            raise ValueError("Cannot draw a parametrized sequence: call build() first.")
        draw_channel_samples(
            sample(self, device=device).channel_samples,
            draw_phase_area=draw_phase_area,
            draw_phase_shifts=draw_phase_shifts,
            draw_phase_curve=draw_phase_curve,
            fig_name=fig_name,
            kwargs_savefig=kwargs_savefig,
        )

    def __repr__(self) -> str:
        lines = [f"Sequence({len(self._register)} qubits, device={self._device.name})"]
        for name, slots in self._schedule.items():
            lines.append(f"  {name}: {len(slots)} slots, T={self.get_duration(name)} ns")
        return "\n".join(lines)

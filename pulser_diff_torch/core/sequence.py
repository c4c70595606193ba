"""Pulse sequence builder (counterpart of pulser_diff_tpu/core/sequence.py).

The port has global channels, pulses, delays, declared variables,
deferred (parametrized) building, and the XY mode of the microwave
channel with its magnetic field.  Local retargeting, measurement, phase
shifts, SLM masks, EOM mode and serialization are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from pulser_diff_torch.core.channels import Channel
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.pulse import Pulse
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.variables import Expr, Variable


@dataclass
class _TimeSlot:
    """One scheduled item on a channel."""

    kind: str  # "pulse" | "delay"
    ti: int
    tf: int
    targets: frozenset
    pulse: Optional[Pulse] = None


@dataclass
class _Call:
    name: str
    args: tuple
    kwargs: dict


class Sequence:
    def __init__(self, register: Register, device: Device) -> None:
        device.validate_register(register)
        self._register = register
        self._device = device
        self._channels: dict[str, Channel] = {}
        self._schedule: dict[str, list[_TimeSlot]] = {}
        self._variables: dict[str, Variable] = {}
        self._calls: list[_Call] = []  # concrete calls
        self._to_build_calls: list[_Call] = []  # parametrized calls
        self._magnetic_field = np.array([0.0, 0.0, 30.0])
        self._in_xy: bool = False

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

    def get_duration(self, channel: str | None = None) -> int:
        if channel is not None:
            slots = self._schedule.get(channel, [])
            return slots[-1].tf if slots else 0
        return max((s[-1].tf for s in self._schedule.values() if s), default=0)

    # ------------------------------------------------------------------
    def declare_channel(self, name: str, channel_id: str) -> None:
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
                raise ValueError("Microwave channels can't be combined with other bases.")
            self._in_xy = True
        elif self._in_xy:
            raise ValueError("Can't declare a non-microwave channel in XY mode.")
        self._channels[name] = ch
        self._schedule[name] = []
        self._calls.append(_Call("declare_channel", (name, channel_id), {}))

    def declare_variable(self, name: str, size: int = 1, dtype: type = float) -> Variable:
        if name in self._variables:
            raise ValueError(f"Variable '{name}' already declared.")
        var = Variable(name, size=size, dtype=dtype)
        self._variables[name] = var
        return var

    def set_magnetic_field(self, bx: float = 0.0, by: float = 0.0, bz: float = 30.0) -> None:
        """The field whose direction sets the XY interaction's angle; it
        puts the sequence in XY mode."""
        if not self._in_xy and self._channels:
            raise ValueError("Magnetic field can only be set in XY mode.")
        self._in_xy = True
        self._magnetic_field = np.array([bx, by, bz], dtype=float)

    def _check_channel(self, channel: str) -> None:
        if channel not in self._channels:
            raise ValueError(f"Channel '{channel}' not declared.")

    def add(self, pulse: Pulse, channel: str, protocol: str = "min-delay") -> None:
        self._check_channel(channel)
        if protocol not in ("min-delay", "no-delay", "wait-for-all"):
            raise ValueError(f"Invalid protocol '{protocol}'.")
        if not isinstance(pulse, Pulse):
            raise TypeError("add() requires a Pulse.")
        if pulse.is_parametrized or self.is_parametrized():
            self._to_build_calls.append(_Call("add", (pulse, channel), {"protocol": protocol}))
            return
        self._add_concrete(pulse, channel, protocol)
        self._calls.append(_Call("add", (pulse, channel), {"protocol": protocol}))

    def _add_concrete(self, pulse: Pulse, channel: str, protocol: str) -> None:
        if not (isinstance(pulse.post_phase_shift, (int, float))
                and float(pulse.post_phase_shift) == 0.0):
            raise NotImplementedError("post_phase_shift is not ported yet.")
        tgt = frozenset(self._register.qubit_ids)
        # every channel is global, so every channel shares the pulse's
        # targets: "min-delay" waits for all of them, as "wait-for-all" does
        t0 = self.get_duration(channel) if protocol == "no-delay" else self.get_duration()
        ti, tf = t0, t0 + pulse.duration
        if ti > self.get_duration(channel):
            self._schedule[channel].append(
                _TimeSlot("delay", self.get_duration(channel), ti, tgt)
            )
        self._schedule[channel].append(_TimeSlot("pulse", ti, tf, tgt, pulse))

    def delay(self, duration: Any, channel: str) -> None:
        self._check_channel(channel)
        if isinstance(duration, Expr) or self.is_parametrized():
            self._to_build_calls.append(_Call("delay", (duration, channel), {}))
            return
        t0 = self.get_duration(channel)
        self._schedule[channel].append(
            _TimeSlot("delay", t0, t0 + int(duration), frozenset(self._register.qubit_ids))
        )
        self._calls.append(_Call("delay", (duration, channel), {}))

    # ------------------------------------------------------------------
    def build(self, **values: Any) -> "Sequence":
        """Return a concrete Sequence with all variables substituted."""
        used: set[str] = set()
        for call in self._to_build_calls:
            for a in list(call.args) + list(call.kwargs.values()):
                if isinstance(a, Expr):
                    used |= a.variables()
                elif isinstance(a, Pulse):
                    for v in (a.amplitude._duration, a.phase,
                              *(getattr(w, n) for w in (a.amplitude, a.detuning)
                                for n in w._param_names)):
                        if isinstance(v, Expr):
                            used |= v.variables()
        missing = (set(self._variables) - set(values)) & used
        if missing:
            raise TypeError(f"Missing values for variables: {sorted(missing)}")

        new = Sequence(self._register, self._device)
        new._magnetic_field = self._magnetic_field.copy()
        new._in_xy = self._in_xy
        for call in self._calls:
            getattr(new, call.name)(*call.args, **call.kwargs)
        for call in self._to_build_calls:
            if call.name == "add":
                pulse, channel = call.args
                new.add(pulse.build(values), channel, **call.kwargs)
            elif call.name == "delay":
                dur, channel = call.args
                if isinstance(dur, Expr):
                    dur = int(round(float(dur.evaluate(values))))
                new.delay(dur, channel)
        return new

    def __repr__(self) -> str:
        lines = [f"Sequence({len(self._register)} qubits, device={self._device.name})"]
        for name, slots in self._schedule.items():
            lines.append(f"  {name}: {len(slots)} slots, T={self.get_duration(name)} ns")
        return "\n".join(lines)

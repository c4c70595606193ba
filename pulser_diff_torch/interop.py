"""Interop with pulser (counterpart of pulser_diff_tpu/interop.py).

The converters of live pulser objects (``from_pulser_register``,
``from_pulser_waveform``, ``from_pulser_device``,
``from_pulser_sequence``) turn a pulser Register, Waveform, Device or
built Sequence into its port equivalent, so an existing pulser program
runs on this backend unchanged::

    import pulser
    from pulser_diff_torch.interop import from_pulser_sequence
    seq = from_pulser_sequence(pulser_seq)
    sim = TorchEmulator.from_sequence(seq)

They read the objects' attributes only (duck typing), so pulser is not a
dependency: ``from_pulser_sequence`` asks for it lazily
(``_require_pulser``), and the native front end (``pulser_diff_torch.core``)
needs it nowhere.

``from_abstract_repr`` reads a sequence serialized in pulser's JSON
dialect (``Sequence.to_abstract_repr()``) into a port Sequence, and
``to_abstract_repr`` writes a built port Sequence back, both without
pulser.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pulser_diff_torch.core import (
    BlackmanWaveform,
    CompositeWaveform,
    ConstantWaveform,
    CustomWaveform,
    InterpolatedWaveform,
    KaiserWaveform,
    Pulse,
    RampWaveform,
    Register,
    Sequence,
)
from pulser_diff_torch.core.channels import Channel
from pulser_diff_torch.core.devices import C6_DICT, Device


def _np(x: Any) -> np.ndarray:
    """A host float64 copy of a number, an array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=float)


# ----------------------------------------------------------------------
# live pulser objects (read by their attributes; pulser imported lazily)
# ----------------------------------------------------------------------
def _require_pulser():
    try:
        import pulser  # noqa: F401

        return pulser
    except ImportError as e:
        raise ImportError(
            "The `pulser` package is not installed; interop conversion "
            "requires it. The native front end (pulser_diff_torch.core) "
            "does not."
        ) from e


def from_pulser_register(preg: Any) -> Register:
    """A port Register with a pulser Register's qubit ids and coordinates."""
    return Register({qid: _np(c) for qid, c in preg.qubits.items()})


def from_pulser_waveform(wf: Any):
    """The port waveform of a pulser waveform, by its class name; a kind
    without a counterpart becomes a CustomWaveform of its samples."""
    name = type(wf).__name__
    if name == "ConstantWaveform":
        return ConstantWaveform(wf.duration, float(wf._value))
    if name == "RampWaveform":
        return RampWaveform(wf.duration, float(wf._start), float(wf._stop))
    if name == "BlackmanWaveform":
        return BlackmanWaveform(wf.duration, float(wf._area))
    if name == "KaiserWaveform":
        return KaiserWaveform(wf.duration, float(wf._area), float(getattr(wf, "_beta", 14.6)))
    if name == "InterpolatedWaveform":
        times = _np(wf._times) / max(wf.duration - 1, 1)
        return InterpolatedWaveform(wf.duration, _np(wf._values), times)
    if name == "CompositeWaveform":
        return CompositeWaveform(*[from_pulser_waveform(w) for w in wf._waveforms])
    # fall back to raw samples (exact)
    return CustomWaveform(_np(wf.samples))


def from_pulser_device(pdev: Any) -> Device:
    """A port Device spec of a pulser device.  A Rydberg level missing from
    ``C6_DICT`` gets the device's own interaction coefficient there."""
    channels = []
    for ch_id, ch in pdev.channels.items():
        channels.append(
            Channel(
                name=ch_id,
                addressing=ch.addressing,
                basis=ch.basis,
                max_abs_detuning=getattr(ch, "max_abs_detuning", None),
                max_amp=getattr(ch, "max_amp", None),
                min_retarget_interval=getattr(ch, "min_retarget_interval", 0) or 0,
                fixed_retarget_t=getattr(ch, "fixed_retarget_t", 0) or 0,
                max_targets=getattr(ch, "max_targets", None),
                clock_period=getattr(ch, "clock_period", 1),
                min_duration=getattr(ch, "min_duration", 1),
                max_duration=getattr(ch, "max_duration", None),
                mod_bandwidth=getattr(ch, "mod_bandwidth", None),
            )
        )
    level = getattr(pdev, "rydberg_level", 70)
    if level not in C6_DICT:
        C6_DICT[level] = float(pdev.interaction_coeff)
    return Device(
        name=pdev.name,
        dimensions=getattr(pdev, "dimensions", 2),
        rydberg_level=level,
        max_atom_num=getattr(pdev, "max_atom_num", None),
        max_radial_distance=getattr(pdev, "max_radial_distance", None),
        min_atom_distance=getattr(pdev, "min_atom_distance", 0.0) or 0.0,
        interaction_coeff_xy=getattr(pdev, "interaction_coeff_xy", None),
        supports_slm_mask=getattr(pdev, "supports_slm_mask", False),
        channels=tuple(channels),
    )


def from_pulser_sequence(pseq: Any) -> Sequence:
    """A port Sequence replaying a BUILT pulser Sequence's schedule: its
    register, device, channels, SLM mask, then slot by slot its targets,
    delays and pulses, and its measurement.  A parametrized sequence
    raises ValueError."""
    _require_pulser()
    if pseq.is_parametrized():
        raise ValueError("Convert built sequences only (call .build() first).")
    seq = Sequence(from_pulser_register(pseq.register), from_pulser_device(pseq.device))
    for name, ch in pseq.declared_channels.items():
        # the device's id of the declared channel
        cid = next((dev_id for dev_id, dev_ch in pseq.device.channels.items() if dev_ch == ch),
                   None)
        seq.declare_channel(name, cid or ch.name)
    if getattr(pseq, "_slm_mask_targets", None):
        seq.config_slm_mask(pseq._slm_mask_targets)
    for name in pseq.declared_channels:
        for slot in pseq._schedule[name].slots:
            if slot.ti < 0:
                continue
            if isinstance(slot.type, str):
                if slot.type == "delay":
                    seq.delay(slot.tf - slot.ti, name)
                elif slot.type == "target":
                    seq.target(sorted(slot.targets), name)
                continue
            p = slot.type
            # pulser folds the targets' phase reference (the phase shifts
            # and the earlier post-phase shifts) into a scheduled pulse's
            # phase, so the slot's phase is the effective one: replayed
            # with post_phase_shift=0, or the Sequence would add the
            # shifts a second time
            seq.add(Pulse(from_pulser_waveform(p.amplitude), from_pulser_waveform(p.detuning),
                          float(p.phase), 0.0), name, protocol="no-delay")
    if getattr(pseq, "_measurement", None):
        seq.measure(pseq._measurement)
    return seq


# ----------------------------------------------------------------------
# pulser abstract-repr JSON (no pulser install required)
# ----------------------------------------------------------------------
def _waveform_from_abstract(d: Any):
    """Build a native waveform from a pulser abstract-repr waveform dict
    (`Sequence.to_abstract_repr()` serialization; kinds follow pulser's
    JSON schema)."""
    if isinstance(d, (int, float)):
        return float(d)
    kind = d["kind"]
    if kind == "constant":
        return ConstantWaveform(int(d["duration"]), float(d["value"]))
    if kind == "ramp":
        return RampWaveform(
            int(d["duration"]), float(d["start"]), float(d["stop"])
        )
    if kind == "blackman":
        return BlackmanWaveform(int(d["duration"]), float(d["area"]))
    if kind == "kaiser":
        return KaiserWaveform(
            int(d["duration"]), float(d["area"]), float(d.get("beta", 14.6))
        )
    if kind == "interpolated":
        times = np.asarray(d["times"], dtype=float)
        return InterpolatedWaveform(
            int(d["duration"]), np.asarray(d["values"], dtype=float), times
        )
    if kind == "custom":
        return CustomWaveform(np.asarray(d["samples"], dtype=float))
    if kind == "composite":
        return CompositeWaveform(
            *[_waveform_from_abstract(w) for w in d["waveforms"]]
        )
    raise ValueError(f"Unknown abstract waveform kind '{kind}'.")


def _device_from_abstract(d: Any) -> Device:
    """Resolve a device: a known native device name or a full channel
    spec dict."""
    from pulser_diff_torch.core import devices as _devices

    if isinstance(d, str):
        dev = getattr(_devices, d, None)
        if dev is None:
            raise ValueError(f"Unknown device name '{d}'.")
        return dev
    def _eom_from_abstract(e):
        if e is None:
            return None
        from pulser_diff_torch.core.eom import BLUE, RED, RydbergEOM

        beams = {"RED": RED, "BLUE": BLUE}
        return RydbergEOM(
            mod_bandwidth=float(e["mod_bandwidth"]),
            limiting_beam=beams[e.get("limiting_beam", "RED")],
            max_limiting_amp=float(e["max_limiting_amp"]),
            intermediate_detuning=float(e["intermediate_detuning"]),
            controlled_beams=tuple(
                beams[b] for b in e.get("controlled_beams", ["BLUE"])
            ),
            custom_buffer_time=e.get("custom_buffer_time"),
        )

    channels = tuple(
        Channel(
            name=ch_id,
            addressing=spec.get("addressing", "Global"),
            basis=spec.get("basis", "ground-rydberg"),
            max_abs_detuning=spec.get("max_abs_detuning"),
            max_amp=spec.get("max_amp"),
            min_retarget_interval=spec.get("min_retarget_interval", 0) or 0,
            fixed_retarget_t=spec.get("fixed_retarget_t", 0) or 0,
            max_targets=spec.get("max_targets"),
            clock_period=spec.get("clock_period", 1),
            min_duration=spec.get("min_duration", 1),
            max_duration=spec.get("max_duration"),
            mod_bandwidth=spec.get("mod_bandwidth"),
            eom_config=_eom_from_abstract(spec.get("eom_config")),
        )
        for ch_id, spec in d["channels"].items()
    )
    return Device(
        name=d.get("name", "AbstractDevice"),
        dimensions=d.get("dimensions", 2),
        rydberg_level=d.get("rydberg_level", 70),
        max_atom_num=d.get("max_atom_num"),
        max_radial_distance=d.get("max_radial_distance"),
        min_atom_distance=d.get("min_atom_distance", 0.0) or 0.0,
        interaction_coeff_xy=d.get("interaction_coeff_xy"),
        supports_slm_mask=d.get("supports_slm_mask", False),
        channels=channels,
    )


def from_abstract_repr(obj: Any) -> Sequence:
    """Deserialize a pulser abstract-repr JSON document (string or dict)
    into a native Sequence.

    This is the install-free migration path: serialize with pulser's
    `seq.to_abstract_repr()` anywhere, load here.  Supported subset:
    register, channel declarations (with optional initial targets),
    pulse/delay/target operations, measurement, SLM mask and magnetic
    field, EOM operations and phase shifts.
    """
    import json

    d = json.loads(obj) if isinstance(obj, str) else obj
    reg = Register(
        {
            str(q["name"]): np.asarray(
                [float(q["x"]), float(q["y"])], dtype=float
            )
            for q in d["register"]
        }
    )
    dev = _device_from_abstract(d.get("device", "MockDevice"))
    seq = Sequence(reg, dev)
    if d.get("magnetic_field") is not None:
        seq.set_magnetic_field(*[float(v) for v in d["magnetic_field"]])
    for name, decl in d.get("channels", {}).items():
        if isinstance(decl, str):
            seq.declare_channel(name, decl)
        else:
            seq.declare_channel(
                name,
                decl["channel_id"],
                initial_target=decl.get("initial_target"),
            )
    if d.get("slm_mask_targets"):
        seq.config_slm_mask(tuple(d["slm_mask_targets"]))
    for op in d.get("operations", []):
        tag = op["op"]
        if tag == "pulse":
            seq.add(
                Pulse(
                    _waveform_from_abstract(op["amplitude"]),
                    _waveform_from_abstract(op["detuning"]),
                    float(op.get("phase", 0.0)),
                    float(op.get("post_phase_shift", 0.0)),
                ),
                op["channel"],
                protocol=op.get("protocol", "min-delay"),
            )
        elif tag == "delay":
            seq.delay(int(op["time"]), op["channel"])
        elif tag == "target":
            qubits = op["qubits"] if isinstance(op["qubits"], list) else [op["qubits"]]
            seq.target(qubits, op["channel"])
        elif tag == "enable_eom_mode":
            seq.enable_eom_mode(
                op["channel"],
                float(op["amp_on"]),
                float(op["detuning_on"]),
                float(op.get("optimal_detuning_off", 0.0)),
            )
        elif tag == "add_eom_pulse":
            seq.add_eom_pulse(
                op["channel"],
                int(op["duration"]),
                float(op["phase"]),
                float(op.get("post_phase_shift", 0.0)),
                protocol=op.get("protocol", "min-delay"),
            )
        elif tag == "disable_eom_mode":
            seq.disable_eom_mode(op["channel"])
        elif tag == "phase_shift":
            targets = (
                op["targets"]
                if isinstance(op["targets"], list)
                else [op["targets"]]
            )
            seq.phase_shift(
                float(op["phi"]),
                *targets,
                basis=op.get("basis", "digital"),
            )
        else:
            raise ValueError(f"Unknown abstract operation '{tag}'.")
    if d.get("measurement"):
        seq.measure(d["measurement"])
    return seq


# ----------------------------------------------------------------------
# abstract-repr EXPORT (the inverse of from_abstract_repr)
# ----------------------------------------------------------------------
def _scalar(x: Any, what: str) -> float:
    """Concrete scalar -> float; reject deferred Exprs (built seqs only)."""
    from pulser_diff_torch.core.variables import Expr

    if isinstance(x, Expr):
        raise ValueError(
            f"Cannot serialize a parametrized {what}: call build() first "
            "(to_abstract_repr handles BUILT sequences only)."
        )
    return float(_np(x))


def _target_list(x: Any) -> list[str]:
    """Qubit id(s) -> list of string ids.  Native QubitIds may be ints
    (Sequence._as_targets accepts them); abstract repr names are strings,
    so int ids round-trip as their string form (matching the register's
    exported names)."""
    if isinstance(x, str) or not hasattr(x, "__iter__"):
        return [str(x)]
    return [str(t) for t in x]


def _waveform_to_abstract(wf: Any) -> dict:
    if wf.is_parametrized:
        raise ValueError(
            "Cannot serialize a parametrized waveform: call build() first."
        )
    name = type(wf).__name__
    if name == "ConstantWaveform":
        return {
            "kind": "constant",
            "duration": int(wf.duration),
            "value": _scalar(wf.value, "waveform value"),
        }
    if name == "RampWaveform":
        return {
            "kind": "ramp",
            "duration": int(wf.duration),
            "start": _scalar(wf.start, "ramp start"),
            "stop": _scalar(wf.stop, "ramp stop"),
        }
    if name == "BlackmanWaveform":
        return {
            "kind": "blackman",
            "duration": int(wf.duration),
            "area": _scalar(wf.area, "blackman area"),
        }
    if name == "KaiserWaveform":
        return {
            "kind": "kaiser",
            "duration": int(wf.duration),
            "area": _scalar(wf.area, "kaiser area"),
            "beta": float(wf.beta),
        }
    if name == "InterpolatedWaveform":
        n = int(_np(wf.values).shape[0])
        times = (
            np.linspace(0.0, 1.0, n)
            if wf.times is None
            else _np(wf.times)
        )
        return {
            "kind": "interpolated",
            "duration": int(wf.duration),
            "values": _np(wf.values).tolist(),
            "times": times.tolist(),
        }
    if name == "CustomWaveform":
        return {
            "kind": "custom",
            "samples": _np(wf._sample_arr).tolist(),
        }
    if name == "CompositeWaveform":
        return {
            "kind": "composite",
            "waveforms": [_waveform_to_abstract(w) for w in wf._waveforms],
        }
    raise ValueError(f"Cannot serialize waveform type '{name}'.")


def _eom_to_abstract(e: Any) -> dict:
    out = {
        "mod_bandwidth": float(e.mod_bandwidth),
        "limiting_beam": str(e.limiting_beam),
        "max_limiting_amp": float(e.max_limiting_amp),
        "intermediate_detuning": float(e.intermediate_detuning),
        "controlled_beams": [str(b) for b in e.controlled_beams],
    }
    if e.custom_buffer_time is not None:
        out["custom_buffer_time"] = int(e.custom_buffer_time)
    return out


def _device_to_abstract(dev: Device) -> Any:
    """A known module-level device serializes as its name; anything else
    as a full spec dict (the form _device_from_abstract reads back)."""
    from pulser_diff_torch.core import devices as _devices

    if getattr(_devices, dev.name, None) == dev:
        return dev.name
    chs = {}
    for ch in dev.channels:
        spec: dict[str, Any] = {
            "addressing": ch.addressing,
            "basis": ch.basis,
        }
        for k in (
            "max_abs_detuning",
            "max_amp",
            "max_targets",
            "max_duration",
            "mod_bandwidth",
        ):
            v = getattr(ch, k)
            if v is not None:
                spec[k] = float(v) if k != "max_targets" else int(v)
        for k, dflt in (
            ("min_retarget_interval", 0),
            ("fixed_retarget_t", 0),
            ("clock_period", 1),
            ("min_duration", 1),
        ):
            v = getattr(ch, k)
            if v != dflt:
                spec[k] = int(v)
        if ch.eom_config is not None:
            spec["eom_config"] = _eom_to_abstract(ch.eom_config)
        chs[ch.name] = spec
    out: dict[str, Any] = {
        "name": dev.name,
        "dimensions": int(dev.dimensions),
        "rydberg_level": int(dev.rydberg_level),
        "min_atom_distance": float(dev.min_atom_distance),
        "supports_slm_mask": bool(dev.supports_slm_mask),
        "channels": chs,
    }
    if dev.max_atom_num is not None:
        out["max_atom_num"] = int(dev.max_atom_num)
    if dev.max_radial_distance is not None:
        out["max_radial_distance"] = float(dev.max_radial_distance)
    if dev.interaction_coeff_xy is not None:
        out["interaction_coeff_xy"] = float(dev.interaction_coeff_xy)
    return out


def to_abstract_repr(seq: Sequence, name: str = "pulser_diff_torch") -> str:
    """Serialize a BUILT native Sequence to the pulser abstract-repr JSON
    dialect that :func:`from_abstract_repr` reads back (the subset of
    pulser's `Sequence.to_abstract_repr()` schema this framework
    supports: register, device, channel declarations, pulse / delay /
    target / EOM operations, SLM mask, magnetic field, measurement).

    Round trip: ``from_abstract_repr(to_abstract_repr(seq))`` reproduces
    the sequence's sampled streams exactly.
    """
    import json

    if seq.is_parametrized():
        raise ValueError(
            "to_abstract_repr handles BUILT sequences only: call "
            "seq.build(**values) first."
        )
    d: dict[str, Any] = {
        "version": "1",
        "name": name,
        "device": _device_to_abstract(seq.device),
        "register": [
            {
                "name": str(qid),
                "x": float(_np(c)[0]),
                "y": float(_np(c)[1]),
            }
            for qid, c in seq.register.qubits.items()
        ],
    }
    if seq._in_xy:
        d["magnetic_field"] = [float(v) for v in seq.magnetic_field]
    channels: dict[str, Any] = {}
    operations: list[dict[str, Any]] = []
    measurement = None
    for call in seq._calls:
        if call.name == "declare_channel":
            ch_name, ch_id, initial_target = call.args
            if initial_target is None:
                channels[ch_name] = ch_id
            else:
                channels[ch_name] = {
                    "channel_id": ch_id,
                    "initial_target": _target_list(initial_target),
                }
        elif call.name == "add":
            pulse, ch_name = call.args
            if call.kwargs.get("_eom"):
                op = {
                    "op": "add_eom_pulse",
                    "channel": ch_name,
                    "duration": int(pulse.duration),
                    "phase": _scalar(pulse.phase, "phase"),
                    "post_phase_shift": _scalar(
                        pulse.post_phase_shift, "post_phase_shift"
                    ),
                    "protocol": call.kwargs.get("protocol", "min-delay"),
                }
            else:
                op = {
                    "op": "pulse",
                    "channel": ch_name,
                    "amplitude": _waveform_to_abstract(pulse.amplitude),
                    "detuning": _waveform_to_abstract(pulse.detuning),
                    "phase": _scalar(pulse.phase, "phase"),
                    "post_phase_shift": _scalar(
                        pulse.post_phase_shift, "post_phase_shift"
                    ),
                    "protocol": call.kwargs.get("protocol", "min-delay"),
                }
            operations.append(op)
        elif call.name == "delay":
            duration, ch_name = call.args
            operations.append(
                {
                    "op": "delay",
                    "time": int(duration),
                    "channel": ch_name,
                }
            )
        elif call.name == "target":
            qubits, ch_name = call.args
            operations.append(
                {
                    "op": "target",
                    "qubits": sorted(_target_list(qubits)),
                    "channel": ch_name,
                }
            )
        elif call.name == "enable_eom_mode":
            ch_name, amp_on, det_on, det_off_opt = call.args
            operations.append(
                {
                    "op": "enable_eom_mode",
                    "channel": ch_name,
                    "amp_on": _scalar(amp_on, "amp_on"),
                    "detuning_on": _scalar(det_on, "detuning_on"),
                    "optimal_detuning_off": _scalar(
                        det_off_opt, "optimal_detuning_off"
                    ),
                }
            )
        elif call.name == "disable_eom_mode":
            operations.append(
                {"op": "disable_eom_mode", "channel": call.args[0]}
            )
        elif call.name == "phase_shift":
            operations.append(
                {
                    "op": "phase_shift",
                    "phi": _scalar(call.args[0], "phase shift"),
                    "targets": [str(q) for q in call.args[1:]],
                    "basis": call.kwargs.get("basis", "digital"),
                }
            )
        elif call.name == "measure":
            measurement = call.args[0]
        elif call.name == "config_slm_mask":
            d["slm_mask_targets"] = sorted(
                str(q) for q in seq._slm_mask_targets
            )
        else:  # pragma: no cover - future call kinds
            raise ValueError(
                f"Cannot serialize sequence call '{call.name}'."
            )
    d["channels"] = channels
    d["operations"] = operations
    if measurement is not None:
        d["measurement"] = measurement
    return json.dumps(d)

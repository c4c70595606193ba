"""PyTorch port vs the JAX package: the sequence front end
(pulser_diff_torch.core: sequence, sampler, channels, eom, devices,
register, pulse).

The same program runs through both packages: the schedules must agree
slot for slot (kind, start, end, targets, EOM off-detuning, phase
reference), the samples at 1e-12 (with and without output modulation),
and every refusal raise the same exception.  The port is also held
against the frozen pure-numpy oracles of tests/fixtures at the
tolerances of tests/test_sequence_fixtures.py (1e-12) and
tests/test_modulation_fixtures.py (1e-9).
"""

import json
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.core.sampler import sample as jsample
from pulser_diff_torch.core.sampler import sample as tsample

from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
MOD_FIXTURE_TOL = 1e-9
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _reg(core, n=4, spacing=6.0):
    return core.Register.from_coordinates(
        [(spacing * (i % 2), spacing * (i // 2)) for i in range(n)], prefix="q")


def _device(core, **local):
    """MockDevice with its local Rydberg channel's timing replaced."""
    chans = tuple(replace(ch, **local) if ch.name == "rydberg_local" else ch
                  for ch in core.MockDevice.channels)
    return replace(core.MockDevice, channels=chans, name="TimedMock")


def _eom_device(core, buffer_time=None, beams=("BLUE",)):
    eom = core.RydbergEOM(mod_bandwidth=40.0, limiting_beam=core.RED,
                          max_limiting_amp=2 * np.pi * 10.0,
                          intermediate_detuning=2 * np.pi * 700.0,
                          controlled_beams=tuple(getattr(core, b) for b in beams),
                          custom_buffer_time=buffer_time)
    chans = tuple(replace(ch, mod_bandwidth=8.0, eom_config=eom)
                  if ch.name == "rydberg_global" else ch for ch in core.MockDevice.channels)
    return replace(core.MockDevice, channels=chans, name="EomMock")


def prog_protocols(core):
    seq = core.Sequence(_reg(core), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.declare_channel("l", "rydberg_local", initial_target="q0")
    seq.declare_channel("r", "raman_local", initial_target=["q2", "q3"])
    seq.add(core.Pulse.ConstantPulse(100, 1.0, 0.2, 0.1), "l")
    seq.add(core.Pulse.ConstantPulse(60, 0.5, 0.0, 0.0), "r")  # disjoint: no wait
    seq.add(core.Pulse(core.BlackmanWaveform(80, 1.0), core.RampWaveform(80, -1, 1), 0.3), "g")
    seq.add(core.Pulse.ConstantPulse(40, 0.7, -0.1, 0.2), "l", protocol="no-delay")
    seq.add(core.Pulse.ConstantPulse(30, 0.9, 0.3, 0.0), "r", protocol="wait-for-all")
    seq.delay(12, "g")
    seq.add(core.Pulse.ConstantPulse(20, 1.1, 0.0, 0.4), "g", protocol="no-delay")
    return seq


def prog_retarget(core):
    dev = _device(core, min_retarget_interval=20, fixed_retarget_t=8, max_targets=2)
    seq = core.Sequence(_reg(core), dev)
    seq.declare_channel("l", "rydberg_local")
    seq.target("q1", "l")  # before any output: the fixed time only
    seq.add(core.Pulse(core.KaiserWaveform(50, 0.8), core.ConstantWaveform(50, 0.4), 0.0), "l")
    seq.target(["q0", "q3"], "l")
    seq.add(core.Pulse.ConstantPulse(30, 1.2, 0.0, 0.5), "l")
    seq.target_index([2], "l")
    seq.add(core.Pulse(core.InterpolatedWaveform(40, [0.0, 1.0, 0.3]),
                       core.ConstantWaveform(40, 0.0), 0.0), "l")
    return seq


def prog_phases(core):
    seq = core.Sequence(_reg(core), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.declare_channel("l", "rydberg_local", initial_target=["q1", "q2"])
    seq.add(core.Pulse.ConstantPulse(60, 1.0, 0.0, 0.2, post_phase_shift=0.3), "g")
    seq.add(core.Pulse.ConstantPulse(40, 1.5, 0.3, 0.4), "l")
    seq.phase_shift(0.9, "q1", "q2", basis="ground-rydberg")
    seq.add(core.Pulse.ConstantPulse(30, 0.8, 0.1, 0.0, post_phase_shift=-0.2), "l")
    seq.phase_shift_index(-0.7, 0, 3, basis="ground-rydberg")
    seq.phase_shift(0.5, "q0", basis="digital")  # another basis: no effect here
    seq.target(["q0", "q3"], "l")
    seq.add(core.Pulse.ConstantPulse(50, 1.1, -0.2, 0.6), "l", protocol="no-delay")
    seq.align("g", "l")
    seq.measure("ground-rydberg")
    return seq


def prog_eom(core):
    seq = core.Sequence(_reg(core, 2, 8.0), _eom_device(core))
    seq.declare_channel("g", "rydberg_global")
    seq.add(core.Pulse(core.BlackmanWaveform(200, 1.5), core.ConstantWaveform(200, -0.4), 0.0),
            "g")
    seq.enable_eom_mode("g", 2.0, 0.5, optimal_detuning_off=-1.0)
    seq.add_eom_pulse("g", 100, 0.6)
    seq.delay(48, "g")
    seq.add_eom_pulse("g", 80, 0.6, 0.2, correct_phase_drift=True)
    seq.disable_eom_mode("g")
    seq.add(core.Pulse(core.ConstantWaveform(120, 1.0), core.ConstantWaveform(120, 0.3), 0.1),
            "g")
    return seq


def prog_eom_open(core):
    seq = core.Sequence(_reg(core, 2, 8.0), _eom_device(core, buffer_time=10,
                                                       beams=("RED", "BLUE")))
    seq.declare_channel("g", "rydberg_global")
    seq.enable_eom_mode("g", 1.2, -0.3)
    seq.add_eom_pulse("g", 60, 0.0)
    seq.delay(30, "g")
    return seq


def prog_slm(core):
    seq = core.Sequence(_reg(core), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.declare_channel("l", "rydberg_local", initial_target="q1")
    seq.config_slm_mask(["q1", "q2"])
    seq.add(core.Pulse.ConstantPulse(70, 1.3, -0.5, 0.0), "l")
    seq.add(core.Pulse(core.RampWaveform(90, 0.0, 2.0), core.ConstantWaveform(90, 0.1), 0.2), "g")
    return seq


def prog_xy(core):
    seq = core.Sequence(_reg(core, 3, 8.0), core.MockDevice)
    seq.declare_channel("mw", "microwave_global")
    seq.set_magnetic_field(0.5, 0.1, 1.0)
    seq.config_slm_mask(["q0"])
    seq.add(core.Pulse.ConstantPulse(50, 1.0, 0.0, 0.0, post_phase_shift=0.3), "mw")
    seq.add(core.Pulse(core.RampWaveform(40, 0.2, 1.0), core.ConstantWaveform(40, 0.5), 0.4),
            "mw")
    seq.measure("XY")
    return seq


def prog_analog(core):
    reg = core.Register.rectangle(2, 2, spacing=6.0, prefix="q")
    seq = core.Sequence(reg, core.AnalogDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.add(core.Pulse(core.BlackmanWaveform(240, 1.0), core.RampWaveform(240, -3, 3), 0.0), "g")
    seq.enable_eom_mode("g", 3.0, 0.0)
    seq.add_eom_pulse("g", 64, 0.3)
    seq.delay(32, "g")
    seq.add_eom_pulse("g", 48, 0.5)
    seq.disable_eom_mode("g")
    seq.add(core.Pulse(core.InterpolatedWaveform(120, [0.0, 4.0, 2.0, 0.0]),
                       core.ConstantWaveform(120, -1.0), 0.8), "g")
    return seq


def prog_switched(core):
    """prog_phases replayed on a device with the same channel ids."""
    return prog_phases(core).switch_device(_device(core))


def prog_built(core):
    """Every call kind recorded as parametrized, then built."""
    seq = core.Sequence(_reg(core), _eom_device(core))
    seq.declare_channel("g", "rydberg_global")
    seq.declare_channel("l", "rydberg_local", initial_target="q0")
    area = seq.declare_variable("area")
    phi = seq.declare_variable("phi")
    dur = seq.declare_variable("dur", dtype=int)
    seq.enable_eom_mode("g", 2.0, 0.0)
    seq.add_eom_pulse("g", 40, 0.2)
    seq.disable_eom_mode("g")
    seq.add(core.Pulse(core.BlackmanWaveform(dur, area), core.RampWaveform(dur, -1, 1), 0.1), "l")
    seq.target(["q1", "q2"], "l")
    seq.phase_shift(phi, "q1", "q2", basis="ground-rydberg")
    seq.add(core.Pulse.ConstantPulse(40, area * 0.5, 0.2, phi, post_phase_shift=phi * 2), "l")
    seq.delay(dur, "g")
    seq.align("g", "l")
    seq.measure("ground-rydberg")
    values = {"area": 1.3, "phi": 0.35, "dur": 52}
    if core is jcore:
        values = {k: jnp.asarray(v) for k, v in values.items()}
    return seq.build(**values)


PROGRAMS = {f.__name__[5:]: f for f in (
    prog_protocols, prog_retarget, prog_phases, prog_eom, prog_eom_open, prog_slm, prog_xy,
    prog_analog, prog_switched, prog_built)}


def _schedule(seq):
    return {name: [(s.kind, s.ti, s.tf, tuple(sorted(s.targets)), float(s.det_off),
                    float(np.asarray(s.phase_ref.detach() if isinstance(s.phase_ref, torch.Tensor)
                                     else s.phase_ref)))
                   for s in slots] for name, slots in seq._schedule.items()}


def _assert_nested(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_nested(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_schedule_and_samples_match_jax(name):
    js, ts = PROGRAMS[name](jcore), PROGRAMS[name](tcore)
    tsch, jsch = _schedule(ts), _schedule(js)
    assert tsch.keys() == jsch.keys()
    for ch in jsch:
        assert [s[:4] for s in tsch[ch]] == [s[:4] for s in jsch[ch]], ch
        np.testing.assert_allclose([s[4:] for s in tsch[ch]], [s[4:] for s in jsch[ch]], rtol=0,
                                   atol=F64_TOL)
    for include_fall in (False, True):
        assert ts.get_duration(include_fall_time=include_fall) == js.get_duration(
            include_fall_time=include_fall)
    assert ts._eom_blocks == js._eom_blocks
    assert ts._measurement == js._measurement
    assert ts._slm_mask_targets == js._slm_mask_targets
    for q in ts.register.qubit_ids:
        for basis in ("ground-rydberg", "digital"):
            assert float(ts.current_phase_ref(q, basis)) == pytest.approx(
                float(js.current_phase_ref(q, basis)), abs=F64_TOL)
    for modulation in (False, True):
        jss = jsample(js, modulation=modulation)
        tss = tsample(ts, modulation=modulation, device="cpu")
        assert (tss._slm_mask.targets, tss._slm_mask.end) == (jss._slm_mask.targets,
                                                              jss._slm_mask.end)
        assert tss._measurement == jss._measurement
        assert tss.used_bases == jss.used_bases
        for ch, jcs in jss.channel_samples.items():
            tcs = tss.channel_samples[ch]
            assert [(s.ti, s.tf, s.targets) for s in tcs.slots] == [
                (s.ti, s.tf, s.targets) for s in jcs.slots]
            assert tcs.eom_blocks == jcs.eom_blocks
            for f in ("amp", "det", "phase"):
                np.testing.assert_allclose(to_numpy(getattr(tcs, f)), np.asarray(getattr(jcs, f)),
                                           rtol=0, atol=F64_TOL, err_msg=f"{ch}/{f}/{modulation}")
        for all_local in (False, True):
            _assert_nested(tss.to_nested_dict(all_local), jss.to_nested_dict(all_local))


def test_sequence_api_matches_jax():
    """available_channels, measurement, EOM state and register mapping."""
    for core in (jcore, tcore):
        seq = core.Sequence(_reg(core), core.MockDevice)
        assert sorted(seq.available_channels) == sorted(core.MockDevice.channel_objects)
        seq.declare_channel("g", "rydberg_global")
        assert "microwave_global" not in seq.available_channels
        assert not seq.is_register_mappable() and not seq.is_measured()
        with pytest.raises(RuntimeError, match="not been measured"):
            seq.get_measurement_basis()
        seq.measure("digital")
        assert seq.is_measured() and seq.get_measurement_basis() == "digital"
        xy = core.Sequence(_reg(core), core.MockDevice)
        xy.set_magnetic_field(0.0, 1.0, 0.0)
        assert list(xy.available_channels) == ["microwave_global"]
        analog = core.Sequence(core.Register.square(2, 6.0), core.AnalogDevice)
        analog.declare_channel("g", "rydberg_global")
        assert analog.available_channels == {}
        assert not analog.is_in_eom_mode("g")
        analog.enable_eom_mode("g", 1.0, 0.0)
        assert analog.is_in_eom_mode("g")
    eom = tcore.AnalogDevice.channels[0].eom_config
    jeom = jcore.AnalogDevice.channels[0].eom_config
    assert eom == replace(eom) and eom.rise_time == jeom.rise_time
    assert eom.buffer_time == jeom.buffer_time
    for amp, det, opt in ((1.0, 0.0, 0.0), (4.0, -2.0, -5.0), (12.0, 3.0, 10.0)):
        assert eom.beam_amplitudes(amp) == jeom.beam_amplitudes(amp)
        np.testing.assert_allclose(eom.detuning_off_options(amp, det),
                                   jeom.detuning_off_options(amp, det), rtol=0, atol=F64_TOL)
        assert eom.calculate_detuning_off(amp, det, opt) == jeom.calculate_detuning_off(
            amp, det, opt)


REGISTERS = {
    "rectangle": lambda c: c.Register.rectangle(2, 3, spacing=5.0, prefix="q"),
    "square": lambda c: c.Register.square(3),
    "linear": lambda c: c.Register.linear(4, spacing=7.0),
    "triangular": lambda c: c.Register.triangular_lattice(3, 2, spacing=6.0),
    "hexagon": lambda c: c.Register.hexagon(2),
    "max_connectivity": lambda c: c.Register.max_connectivity(9, c.AnalogDevice),
    "cuboid": lambda c: c.Register.cuboid(2, 2, 3, spacing=5.0),
    "cubic": lambda c: c.Register.cubic(2),
    "rotated": lambda c: c.Register.rectangle(2, 2, spacing=4.0).rotated(33.0),
    "with_coords": lambda c: c.Register.linear(3).with_coords({1: np.array([1.0, 2.0])}),
    "centered": lambda c: c.Register.from_coordinates([(0.0, 0.0), (3.0, 1.0), (1.0, 5.0)],
                                                      center=True),
}


@pytest.mark.parametrize("name", sorted(REGISTERS))
def test_register_constructors_match_jax(name):
    jr, tr = REGISTERS[name](jcore), REGISTERS[name](tcore)
    assert tr.qubit_ids == jr.qubit_ids and tr.dimensionality == jr.dimensionality
    np.testing.assert_allclose(to_numpy(tr.coords_array), np.asarray(jr.coords_array), rtol=0,
                               atol=F64_TOL)


def _bad_amp(core):
    seq = core.Sequence(core.Register.square(2, 6.0), core.AnalogDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.add(core.Pulse.ConstantPulse(100, 20.0, 0.0, 0.0), "g")


def _bad_duration(core):
    seq = core.Sequence(core.Register.square(2, 6.0), core.AnalogDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.add(core.Pulse.ConstantPulse(8, 1.0, 0.0, 0.0), "g")


def _mixed_refs(core):
    seq = core.Sequence(_reg(core), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.phase_shift(0.4, "q0", basis="ground-rydberg")
    seq.add(core.Pulse.ConstantPulse(10, 1.0, 0.0, 0.0), "g")


def _seq(core, *channels, device=None):
    seq = core.Sequence(_reg(core), device or core.MockDevice)
    for name, cid in channels:
        seq.declare_channel(name, cid)
    return seq


def _eom_add(core):
    seq = core.Sequence(core.Register.square(2, 6.0), core.AnalogDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.enable_eom_mode("g", 1.0, 0.0)
    seq.add(core.Pulse.ConstantPulse(20, 1.0, 0.0, 0.0), "g")


def _strict_switch(core):
    seq = _seq(core, ("g", "rydberg_global"))
    seq.add(core.Pulse.ConstantPulse(20, 1.0, 0.0, 0.0), "g")
    seq.switch_device(_eom_device(core), strict=True)


REFUSALS = {
    "radial_distance": (ValueError, lambda c: c.Sequence(c.Register.linear(12, 7.0),
                                                           c.AnalogDevice)),
    "min_distance": (ValueError, lambda c: c.Sequence(c.Register.linear(3, 2.0), c.AnalogDevice)),
    "dimensions": (ValueError, lambda c: c.Sequence(c.Register.cubic(2, 6.0), c.AnalogDevice)),
    "amplitude_limit": (ValueError, _bad_amp),
    "duration_limit": (ValueError, _bad_duration),
    "unknown_channel": (ValueError, lambda c: _seq(c, ("x", "rydberg_nowhere"))),
    "undeclared": (ValueError, lambda c: _seq(c).delay(10, "g")),
    "protocol": (ValueError, lambda c: _seq(c, ("g", "rydberg_global")).add(
        c.Pulse.ConstantPulse(10, 1.0, 0.0, 0.0), "g", protocol="soon")),
    "retarget_global": (ValueError, lambda c: _seq(c, ("g", "rydberg_global")).target("q0", "g")),
    "unknown_qubit": (ValueError, lambda c: _seq(c, ("l", "rydberg_local")).target("q9", "l")),
    "max_targets": (ValueError, lambda c: _seq(c, ("l", "rydberg_local"), device=_device(
        c, max_targets=1)).target(["q0", "q1"], "l")),
    "xy_mix": (ValueError, lambda c: _seq(c, ("g", "rydberg_global"), ("m", "microwave_global"))),
    "microwave_local": (ValueError, lambda c: c.Microwave.Local()),
    "mixed_phase_refs": (ValueError, _mixed_refs),
    "phase_basis": (ValueError, lambda c: _seq(c).phase_shift(0.1, "q0", basis="nope")),
    "align_one": (ValueError, lambda c: _seq(c, ("g", "rydberg_global")).align("g")),
    "measure_basis": (ValueError, lambda c: _seq(c).measure("other")),
    "slm_device": (ValueError, lambda c: c.Sequence(c.Register.square(2, 6.0),
                                                    c.AnalogDevice).config_slm_mask(["q0"])),
    "eom_config": (TypeError, lambda c: _seq(c, ("g", "rydberg_global")).enable_eom_mode(
        "g", 1.0, 0.0)),
    "eom_add": (RuntimeError, _eom_add),
    "eom_disable": (RuntimeError, lambda c: _seq(c, ("g", "rydberg_global"),
                                                 device=_eom_device(c)).disable_eom_mode("g")),
    "strict_switch": (ValueError, _strict_switch),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name):
    exc, fn = REFUSALS[name]
    for core in (jcore, tcore):
        with pytest.raises(exc):
            fn(core)


def test_measure_twice_and_slm_twice_raise():
    for core in (jcore, tcore):
        seq = _seq(core, ("g", "rydberg_global"))
        seq.config_slm_mask(["q0"])
        with pytest.raises(ValueError, match="already"):
            seq.config_slm_mask(["q1"])
        seq.measure()
        with pytest.raises(RuntimeError, match="already measured"):
            seq.measure()


# ----------------------------------------------------------------------
# the frozen pure-numpy oracles
# ----------------------------------------------------------------------
def _fixture(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


SEQ_FIXTURES = _fixture("sequence_samples.json")
MOD_FIXTURES = _fixture("modulated_samples.json")


def _fixture_waveform(spec):
    kind = spec["kind"]
    if kind == "constant":
        return tcore.ConstantWaveform(spec["duration"], spec["value"])
    if kind == "ramp":
        return tcore.RampWaveform(spec["duration"], spec["start"], spec["stop"])
    return tcore.BlackmanWaveform(spec["duration"], spec["area"])


def _fixture_sequence(prog):
    chans = tuple(
        tcore.Channel(name=f"fx_{op[1]}", addressing=op[2]["addressing"], basis=op[2]["basis"],
                      min_retarget_interval=op[2].get("min_retarget_interval", 0),
                      fixed_retarget_t=op[2].get("fixed_retarget_t", 0))
        for op in prog["ops"] if op[0] == "declare")
    device = tcore.Device(name="FixtureDevice", dimensions=2, supports_slm_mask=True,
                          is_virtual=True, channels=chans)
    reg = tcore.Register.from_coordinates([(8.0 * i, 0.0) for i in range(len(prog["qubits"]))],
                                          prefix="q")
    seq = tcore.Sequence(reg, device)
    for op in prog["ops"]:
        if op[0] == "declare":
            seq.declare_channel(op[1], f"fx_{op[1]}", initial_target=op[2].get("initial_target"))
        elif op[0] == "pulse":
            _, name, amp, det, phase, pps, protocol = op
            seq.add(tcore.Pulse(_fixture_waveform(amp), _fixture_waveform(det), phase, pps), name,
                    protocol=protocol)
        elif op[0] == "delay":
            seq.delay(op[2], op[1])
        elif op[0] == "target":
            seq.target(op[2], op[1])
        else:
            _, phi, targets, basis = op
            seq.phase_shift(phi, *targets, basis=basis)
    if prog.get("slm_mask"):
        seq.config_slm_mask(prog["slm_mask"])
    return seq


@pytest.mark.parametrize("name", sorted(SEQ_FIXTURES))
def test_sequence_fixture_oracle(name):
    fx = SEQ_FIXTURES[name]
    ss = tsample(_fixture_sequence(fx["program"]), device="cpu")
    assert ss.max_duration == fx["total"]
    if fx["program"].get("slm_mask"):
        assert ss._slm_mask.end == fx["mask_end"]
    nested = ss.to_nested_dict(all_local=True)
    assert not nested["Global"]
    _assert_nested(nested["Local"], fx["expected"])


def _mod_device(fix, with_eom):
    eom = None
    if with_eom:
        p = fix["eom_params"]
        eom = tcore.RydbergEOM(mod_bandwidth=fix["eom_bandwidth"], limiting_beam=tcore.RED,
                               max_limiting_amp=2 * np.pi * 10.0,
                               intermediate_detuning=2 * np.pi * 700.0,
                               controlled_beams=tuple(getattr(tcore, b) for b in p.get(
                                   "controlled_beams", ["BLUE"])),
                               custom_buffer_time=p.get("custom_buffer_time"))
    chans = tuple(replace(ch, mod_bandwidth=fix["mod_bandwidth"], eom_config=eom)
                  if ch.name == "rydberg_global" else ch for ch in tcore.MockDevice.channels)
    return replace(tcore.MockDevice, channels=chans, name="ModMock")


def _mod_sequence(name, fix):
    """The programs of tests/test_modulation_fixtures.py, in the port."""
    P, C, eom = tcore.Pulse, tcore.ConstantWaveform, name.startswith("eom_")
    seq = tcore.Sequence(tcore.Register({"q0": [0.0, 0.0], "q1": [7.0, 0.0]}),
                         _mod_device(fix, eom))
    seq.declare_channel("g", "rydberg_global")
    p = fix.get("eom_params", {})
    if name == "constant_30MHz":
        seq.add(P.ConstantPulse(300, 2.0, -1.5, 0.4), "g")
        seq.delay(100, "g")
    elif name == "blackman_ramp_8MHz":
        seq.add(P(tcore.BlackmanWaveform(240, np.pi), tcore.RampWaveform(240, -2.0, 2.0), 0.0),
                "g")
        seq.delay(60, "g")
    elif name == "two_pulse_gap_20MHz":
        seq.add(P.ConstantPulse(120, 1.2, 0.5, 0.0), "g")
        seq.delay(80, "g")
        seq.add(P.ConstantPulse(100, 2.4, -0.7, 1.1), "g")
    elif name == "eom_closed_block":
        seq.add(P.ConstantPulse(240, 1.0, -0.5, 0.2), "g")
        seq.enable_eom_mode("g", p["amp_on"], p["detuning_on"])
        seq.add_eom_pulse("g", 100, 1.0)
        seq.delay(60, "g")
        seq.add_eom_pulse("g", 80, 1.0)
        seq.disable_eom_mode("g")
        seq.add(P.ConstantPulse(120, 1.5, 0.3, 0.7), "g")
    elif name == "eom_open_end":
        seq.add(P.ConstantPulse(200, 0.9, 0.6, 0.0), "g")
        seq.enable_eom_mode("g", p["amp_on"], p["detuning_on"])
        seq.add_eom_pulse("g", 120, 0.5)
        seq.delay(80, "g")
    else:
        seq.add(P(C(150, 0.8), C(150, 0.1), 0.0), "g")
        seq.enable_eom_mode("g", p["amp_on"], p["detuning_on"],
                            optimal_detuning_off=p["optimal_detuning_off"])
        seq.add_eom_pulse("g", 90, 0.9)
        seq.delay(40, "g")
        seq.add_eom_pulse("g", 50, 0.9)
        seq.disable_eom_mode("g")
        seq.delay(60, "g")
    return seq


@pytest.mark.parametrize("name", sorted(MOD_FIXTURES))
def test_modulated_fixture_oracle(name):
    fix = MOD_FIXTURES[name]
    seq = _mod_sequence(name, fix)
    raw = tsample(seq, device="cpu").channel_samples["g"]
    if name.startswith("eom_"):
        assert [list(b) for b in raw.eom_blocks] == fix["eom_blocks"]
    mod = tsample(seq, modulation=True, device="cpu").channel_samples["g"]
    for cs, suffix in ((raw, "in"), (mod, "mod")):
        for f in ("amp", "det", "phase"):
            want = np.asarray(fix[f"{f}_{suffix}"])
            got = to_numpy(getattr(cs, f))
            assert got.shape == want.shape, (f, suffix)
            np.testing.assert_allclose(got, want, rtol=0, atol=MOD_FIXTURE_TOL,
                                       err_msg=f"{f}_{suffix}")


def test_limits_skip_differentiable_values():
    """The channel limits and the register's geometric checks hold a
    concrete value and pass one that carries gradients, as the JAX
    package passes traced ones (a pulse or a register under
    optimisation)."""
    import jax

    def build(core, amp, x):
        reg = core.Register({"q0": [0.0, 0.0], "q1": [6.0, 0.0], "q2": x})
        seq = core.Sequence(reg, core.AnalogDevice)
        seq.declare_channel("g", "rydberg_global")
        seq.add(core.Pulse.ConstantPulse(100, amp, 0.0, 0.0), "g")
        return seq

    far = [40.0, 0.0]  # past AnalogDevice's 35 um radius
    jax.grad(lambda a: jnp.sum(build(jcore, a, jnp.asarray(far) * a / a).register.coords_array)
             )(jnp.asarray(20.0))
    a = torch.tensor(20.0, dtype=torch.float64, requires_grad=True)
    build(tcore, a, torch.tensor(far, dtype=torch.float64, requires_grad=True))
    for core in (jcore, tcore):
        with pytest.raises(ValueError, match="exceeds channel maximum"):
            build(core, 20.0, [0.0, 6.0])
        with pytest.raises(ValueError, match="um from the center"):
            build(core, 1.0, far)

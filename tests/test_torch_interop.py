"""PyTorch port vs the JAX package: interop (pulser_diff_torch.interop,
``Sequence.to_abstract_repr`` / ``from_abstract_repr`` and
``SimConfig.to_pulser``).

Every frozen ``tests/fixtures/abstract_seq_*.json`` sequence is read by
both packages, with equal schedules and samples (1e-12, modulated too
for the EOM one); the port writes the JSON the JAX package writes, and
either package reads the other's.  The converters of live pulser objects
run, as the JAX package's tests run them, on duck-typed stand-ins with an
empty module for the lazy ``import pulser``: each waveform kind's samples
(1e-12), the device's fields (and an unknown Rydberg level's C6 in both
tables, restored after), the replayed sequence's samples (1e-12) against
JAX's replay, the refusal of an unbuilt sequence and the ImportError
without pulser.  ``to_pulser`` equals JAX's field by field.
"""

import dataclasses
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
import pulser_diff_tpu.core as jcore
from pulser_diff_tpu import interop as jinterop
from pulser_diff_tpu import simconfig as jsc
from pulser_diff_tpu.core.sampler import sample as jsample
from pulser_diff_torch import TorchEmulator
from pulser_diff_torch import interop as tinterop
from pulser_diff_torch import simconfig as tsc
from pulser_diff_torch.core.sampler import sample as tsample

from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
FIXTURES = sorted(f for f in os.listdir(os.path.join(os.path.dirname(__file__), "fixtures"))
                  if f.startswith("abstract_seq_"))


def _text(name):
    with open(os.path.join(os.path.dirname(__file__), "fixtures", name)) as f:
        return f.read()


def _assert_nested(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_nested(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64_TOL,
                                   err_msg=path)


def _assert_same_sequence(ts, js, modulations=(False,)):
    assert ts.get_duration() == js.get_duration()
    assert ts._measurement == js._measurement
    assert ts._slm_mask_targets == js._slm_mask_targets
    assert ts._in_xy == js._in_xy
    np.testing.assert_array_equal(ts.magnetic_field, js.magnetic_field)
    assert set(ts.declared_channels) == set(js.declared_channels)
    assert ts.device.name == js.device.name
    assert set(ts.device.channel_objects) == set(js.device.channel_objects)
    assert ts._eom_blocks == js._eom_blocks
    for mod in modulations:
        tss, jss = tsample(ts, modulation=mod, device="cpu"), jsample(js, modulation=mod)
        for ch, jcs in jss.channel_samples.items():
            for f in ("amp", "det", "phase"):
                np.testing.assert_allclose(to_numpy(getattr(tss.channel_samples[ch], f)),
                                           np.asarray(getattr(jcs, f)), rtol=0, atol=F64_TOL,
                                           err_msg=f"{ch}/{f}/{mod}")
        _assert_nested(tss.to_nested_dict(), jss.to_nested_dict())


def _mods(name):
    return (False, True) if name == "abstract_seq_eom.json" else (False,)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_as_in_jax(name):
    ts = tinterop.from_abstract_repr(_text(name))
    js = jinterop.from_abstract_repr(_text(name))
    _assert_same_sequence(ts, js, _mods(name))
    # the dict form and the method form read the same sequence
    ts2 = tcore.Sequence.from_abstract_repr(json.loads(_text(name)))
    _assert_same_sequence(ts2, js)


@pytest.mark.parametrize("name", FIXTURES)
def test_to_abstract_repr_round_trips_and_matches_jax(name):
    """The port writes the JSON the JAX package writes for the same
    sequence; reading it back, in either package, gives equal samples."""
    ts = tinterop.from_abstract_repr(_text(name))
    js = jinterop.from_abstract_repr(_text(name))
    t_json = ts.to_abstract_repr()
    assert json.loads(t_json) == {**json.loads(jinterop.to_abstract_repr(js)),
                                  "name": "pulser_diff_torch"}
    _assert_same_sequence(tinterop.from_abstract_repr(t_json), js, _mods(name))
    _assert_same_sequence(ts, jinterop.from_abstract_repr(t_json), _mods(name))


def test_digital_fixture_parses_and_its_hamiltonian_names_item_8():
    """The digital fixture (a Raman channel beside a Rydberg one) builds in
    the all basis, measured in the digital basis; its build_data equals
    JAX's at 1e-12."""
    from pulser_diff_tpu.backend import TpuEmulator

    from tests.torch_port_cases import factored_fields

    seq = tinterop.from_abstract_repr(_text("abstract_seq_digital.json"))
    assert {ch.basis for ch in seq.declared_channels.values()} == {"digital", "ground-rydberg"}
    assert seq._measurement == "digital"
    tsim = TorchEmulator.from_sequence(seq, evaluation_times="Minimal", device="cpu")
    jsim = TpuEmulator.from_sequence(jinterop.from_abstract_repr(_text("abstract_seq_digital.json")),
                                     evaluation_times="Minimal")
    assert (tsim.basis_name, tsim.dim, tsim._meas_basis) == ("all", 3, "digital")
    tf, jf = factored_fields(tsim._hamiltonian._ham_data), factored_fields(jsim._hamiltonian._ham_data)
    for k, v in jf.items():
        assert tf[k].shape == v.shape, k
        np.testing.assert_allclose(tf[k], v, rtol=0, atol=1e-12, err_msg=k)


def test_to_abstract_repr_refusals_and_int_ids():
    seq = tcore.Sequence(tcore.Register.from_coordinates([(0.0, 0.0), (6.0, 0.0)]),
                         tcore.MockDevice)
    seq.declare_channel("l", "rydberg_local", initial_target=0)
    a = seq.declare_variable("a")
    seq.add(tcore.Pulse.ConstantPulse(20, a, 0.0, 0.0), "l")
    with pytest.raises(ValueError, match="BUILT"):
        seq.to_abstract_repr()
    built = seq.build(a=torch.tensor(1.5, dtype=torch.float64))
    d = json.loads(built.to_abstract_repr())
    assert d["channels"]["l"] == {"channel_id": "rydberg_local", "initial_target": ["0"]}
    assert d["operations"][0]["amplitude"] == {"kind": "constant", "duration": 20, "value": 1.5}
    back = tinterop.from_abstract_repr(d)
    assert back.register.qubit_ids == ("0", "1")
    np.testing.assert_allclose(to_numpy(tsample(back, device="cpu").channel_samples["l"].amp),
                               to_numpy(tsample(built, device="cpu").channel_samples["l"].amp),
                               rtol=0, atol=F64_TOL)
    with pytest.raises(ValueError, match="Unknown abstract operation"):
        tinterop.from_abstract_repr({**d, "operations": [{"op": "teleport"}]})
    with pytest.raises(ValueError, match="Unknown device name"):
        tinterop.from_abstract_repr({**d, "device": "NoSuchDevice"})


# ----------------------------------------------------------------------
# live pulser objects: the JAX package's duck-typed stand-ins
# (tests/test_interop.py), each converted by both packages
# ----------------------------------------------------------------------
class _FakeReg:
    def __init__(self, qubits):
        self.qubits = qubits


class _FakeWf:
    def __init__(self, duration, **attrs):
        self.duration = duration
        for k, v in attrs.items():
            setattr(self, k, v)


def _fake_kind(name: str):
    """A stand-in waveform class whose type name is pulser's ``name``."""
    return type(name, (_FakeWf,), {})


_FAKE_WAVEFORMS = {
    "constant": lambda: _fake_kind("ConstantWaveform")(100, _value=2.0),
    "ramp": lambda: _fake_kind("RampWaveform")(60, _start=-0.5, _stop=1.7),
    "blackman": lambda: _fake_kind("BlackmanWaveform")(200, _area=np.pi),
    "kaiser": lambda: _fake_kind("KaiserWaveform")(120, _area=2.1, _beta=9.0),
    "interpolated": lambda: _fake_kind("InterpolatedWaveform")(
        80, _values=np.array([0.0, 1.2, 0.7, 2.0]), _times=np.array([0.0, 20.0, 55.0, 79.0])),
    "composite": lambda: _fake_kind("CompositeWaveform")(
        160, _waveforms=[_fake_kind("ConstantWaveform")(100, _value=2.0),
                         _fake_kind("RampWaveform")(60, _start=2.0, _stop=0.0)]),
    "custom": lambda: _fake_kind("SomethingExotic")(5, samples=np.arange(5.0) * 0.3),
}


class _FakeChannel:
    def __init__(self, addressing, basis, **attrs):
        self.addressing = addressing
        self.basis = basis
        self.max_abs_detuning = None
        self.max_amp = None
        for k, v in attrs.items():
            setattr(self, k, v)


class _FakeDevice:
    name = "FakeDevice"
    dimensions = 2
    rydberg_level = 70
    max_atom_num = 10
    max_radial_distance = 50.0
    min_atom_distance = 1.0
    interaction_coeff = 5420158.53
    interaction_coeff_xy = 3700.0
    supports_slm_mask = True

    def __init__(self, **attrs):
        self.channels = {"rydberg_global": _FakeChannel("Global", "ground-rydberg")}
        for k, v in attrs.items():
            setattr(self, k, v)


class _FakePulse:
    def __init__(self, amplitude, detuning, phase, post_phase_shift=0.0):
        self.amplitude = amplitude
        self.detuning = detuning
        self.phase = phase
        self.post_phase_shift = post_phase_shift


class _FakeSlot:
    def __init__(self, ti, tf, type_, targets=frozenset()):
        self.ti = ti
        self.tf = tf
        self.type = type_
        self.targets = targets


class _FakeSchedule:
    def __init__(self, slots):
        self.slots = slots


class _FakeSequence:
    def __init__(self, register, device, declared, schedule, measurement=None,
                 slm_targets=None, parametrized=False):
        self.register = register
        self.device = device
        self.declared_channels = declared
        self._schedule = schedule
        self._measurement = measurement
        self._slm_mask_targets = slm_targets or set()
        self._parametrized = parametrized

    def is_parametrized(self):
        return self._parametrized


@pytest.fixture
def fake_pulser(monkeypatch):
    """An empty module for the lazy ``import pulser``, as the JAX package's
    tests provide it."""
    monkeypatch.setitem(sys.modules, "pulser", types.ModuleType("pulser"))


@pytest.fixture
def c6_tables():
    """Both packages' C6 tables, restored after the test."""
    tables = (tcore.devices.C6_DICT, jcore.devices.C6_DICT)
    saved = [dict(t) for t in tables]
    yield tables
    for t, s in zip(tables, saved):
        t.clear()
        t.update(s)


def test_register_matches_jax():
    qubits = {"q0": np.array([0.0, 0.0]), "q1": np.array([5.0, 0.3]), 7: np.array([-2.5, 4.0])}
    treg = tinterop.from_pulser_register(_FakeReg(qubits))
    jreg = jinterop.from_pulser_register(_FakeReg(qubits))
    assert treg.qubit_ids == jreg.qubit_ids == ("q0", "q1", 7)
    np.testing.assert_array_equal(to_numpy(treg.coords_array), np.asarray(jreg.coords_array))


@pytest.mark.parametrize("kind", list(_FAKE_WAVEFORMS))
def test_waveform_matches_jax(kind):
    """Each pulser waveform kind, and the fallback to raw samples: the same
    class of waveform in both packages, samples within 1e-12."""
    twf = tinterop.from_pulser_waveform(_FAKE_WAVEFORMS[kind]())
    jwf = jinterop.from_pulser_waveform(_FAKE_WAVEFORMS[kind]())
    assert type(twf).__name__ == type(jwf).__name__
    assert twf.duration == jwf.duration
    np.testing.assert_allclose(to_numpy(twf.samples), np.asarray(jwf.samples), rtol=0,
                               atol=F64_TOL)


def _fields(dev) -> dict:
    out = {f.name: getattr(dev, f.name) for f in dataclasses.fields(dev) if f.name != "channels"}
    out["channels"] = [{f.name: getattr(ch, f.name) for f in dataclasses.fields(ch)}
                       for ch in dev.channels]
    return out


@pytest.mark.parametrize("level", [70, 63])
def test_device_matches_jax(c6_tables, level):
    """The device's fields and channels equal JAX's; an unknown Rydberg
    level installs the device's C6 in each package's table."""
    chans = {"rydberg_global": _FakeChannel("Global", "ground-rydberg", max_amp=12.5),
             "raman_local": _FakeChannel("Local", "digital", max_targets=2, clock_period=4,
                                         min_retarget_interval=220, mod_bandwidth=4.0)}
    coeff = 5420158.53 if level == 70 else 1234567.0
    tdev = tinterop.from_pulser_device(_FakeDevice(rydberg_level=level, interaction_coeff=coeff,
                                                   channels=chans))
    jdev = jinterop.from_pulser_device(_FakeDevice(rydberg_level=level, interaction_coeff=coeff,
                                                   channels=chans))
    assert _fields(tdev) == _fields(jdev)
    assert tdev.interaction_coeff == jdev.interaction_coeff == pytest.approx(coeff)
    assert tdev.supported_bases == {"ground-rydberg", "digital"}
    for table in c6_tables:
        assert table[level] == coeff


def _fake_sequence(core_qubits: dict, slm: bool = False) -> _FakeSequence:
    """The JAX package's replay stand-in: a target, a constant pulse, a
    delay and a ramp pulse with a post-phase shift; with ``slm`` a second
    pulse under an SLM mask on q1."""
    ch = _FakeChannel("Global", "ground-rydberg")
    dev = _FakeDevice(channels={"rydberg_global": ch})
    const, ramp = _fake_kind("ConstantWaveform"), _fake_kind("RampWaveform")
    slots = [
        _FakeSlot(-1, 0, "target", frozenset(core_qubits)),
        _FakeSlot(0, 120, _FakePulse(const(120, _value=1.8), const(120, _value=-0.6), 0.25)),
        _FakeSlot(120, 160, "delay"),
        _FakeSlot(160, 260, _FakePulse(ramp(100, _start=0.0, _stop=2.0), const(100, _value=0.4),
                                       1.1, 0.2)),
    ]
    if slm:
        slots.append(_FakeSlot(260, 340, _FakePulse(const(80, _value=1.0),
                                                    const(80, _value=0.3), 1.3)))
    return _FakeSequence(_FakeReg(core_qubits), dev, {"ryd": ch}, {"ryd": _FakeSchedule(slots)},
                         measurement="ground-rydberg", slm_targets={"q1"} if slm else None)


@pytest.mark.parametrize("slm", [False, True])
def test_sequence_replay_matches_jax(fake_pulser, slm):
    """The replayed schedule equals JAX's replay (samples at 1e-12), and the
    port's final state equals that of the sequence built natively, the
    post-phase shift folded into the slot phases."""
    qubits = {"q0": np.array([-3.0, 0.0]), "q1": np.array([3.0, 0.0])}
    ts = tinterop.from_pulser_sequence(_fake_sequence(qubits, slm))
    js = jinterop.from_pulser_sequence(_fake_sequence(qubits, slm))
    _assert_same_sequence(ts, js)
    if slm:
        return
    ref = tcore.Sequence(tcore.Register(qubits), tcore.MockDevice)
    ref.declare_channel("ryd", "rydberg_global")
    ref.add(tcore.Pulse(tcore.ConstantWaveform(120, 1.8), tcore.ConstantWaveform(120, -0.6),
                        0.25), "ryd")
    ref.delay(40, "ryd")
    ref.add(tcore.Pulse(tcore.RampWaveform(100, 0.0, 2.0), tcore.ConstantWaveform(100, 0.4), 1.1,
                        post_phase_shift=0.2), "ryd")
    ref.measure("ground-rydberg")
    states = [TorchEmulator.from_sequence(s, evaluation_times="Minimal", device="cpu").run()
              .states for s in (ts, ref)]
    np.testing.assert_allclose(to_numpy(states[0].re), to_numpy(states[1].re), rtol=0,
                               atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(states[0].im), to_numpy(states[1].im), rtol=0,
                               atol=F64_TOL)


def test_sequence_refuses_unbuilt(fake_pulser):
    pseq = _FakeSequence(_FakeReg({}), _FakeDevice(), {}, {}, parametrized=True)
    for interop in (tinterop, jinterop):
        with pytest.raises(ValueError, match="built"):
            interop.from_pulser_sequence(pseq)


def test_sequence_needs_pulser(monkeypatch):
    """Without pulser, the replay raises ImportError naming the native
    front end, as JAX's does; the other converters need no pulser."""
    monkeypatch.setitem(sys.modules, "pulser", None)
    pseq = _fake_sequence({"q0": np.array([0.0, 0.0])})
    with pytest.raises(ImportError, match=r"native front end \(pulser_diff_torch.core\)"):
        tinterop.from_pulser_sequence(pseq)
    with pytest.raises(ImportError, match="pulser"):
        jinterop.from_pulser_sequence(pseq)
    assert tinterop.from_pulser_register(_FakeReg({"q0": np.zeros(2)})).qubit_ids == ("q0",)


def _to_pulser_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _assert_same_value(got, want, name):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), name
        for g, w in zip(got, want):
            _assert_same_value(g, w, name)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert type(got) is type(want) and got == want, (name, got, want)


@pytest.mark.parametrize("grad", [False, True])
def test_to_pulser_matches_jax(grad):
    """A config with tensor rates (a 0-d temperature carrying a gradient
    with ``grad``, effective-noise operators as 2-D tensors) becomes the
    config JAX's ``to_pulser`` makes from the same arrays: Python floats
    and numpy arrays, field by field."""
    oper = np.array([[0.3, 0.4], [0.4, -0.3]])
    values = dict(noise=("dephasing", "doppler", "eff_noise"), dephasing_rate=0.123,
                  temperature=42.0, eff_noise_rates=(0.5,), eff_noise_opers=(oper,), eta=0.02)
    tcfg = tsc.SimConfig(**{
        **values, "dephasing_rate": torch.tensor(0.123, dtype=torch.float64),
        "temperature": torch.tensor(42.0, dtype=torch.float64, requires_grad=grad),
        "eff_noise_rates": (torch.tensor(0.5, dtype=torch.float64),),
        "eff_noise_opers": (torch.as_tensor(oper),)})
    jcfg = jsc.SimConfig(**{
        **values, "dephasing_rate": jnp.asarray(0.123), "temperature": jnp.asarray(42.0),
        "eff_noise_rates": (jnp.asarray(0.5),), "eff_noise_opers": (jnp.asarray(oper),)})
    got, want = _to_pulser_fields(tcfg.to_pulser()), _to_pulser_fields(jcfg.to_pulser())
    assert got.keys() == want.keys()
    for name in want:
        _assert_same_value(got[name], want[name], name)
    assert isinstance(got["temperature"], float) and isinstance(got["eff_noise_opers"][0],
                                                                np.ndarray)

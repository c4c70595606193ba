"""PyTorch port vs the JAX package: the abstract representation
(pulser_diff_torch.interop and ``Sequence.to_abstract_repr`` /
``from_abstract_repr``).

Every frozen ``tests/fixtures/abstract_seq_*.json`` sequence is read by
both packages, with equal schedules and samples (1e-12, modulated too
for the EOM one); the port writes the JSON the JAX package writes, and
either package reads the other's.
"""

import json
import os

import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
from pulser_diff_tpu import interop as jinterop
from pulser_diff_tpu.core.sampler import sample as jsample
from pulser_diff_torch import TorchEmulator
from pulser_diff_torch import interop as tinterop
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

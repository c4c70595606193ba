"""PyTorch port vs the JAX package: sampling, the factored Hamiltonian,
the time grid and the substep heuristic (pulser_diff_torch.core,
hamiltonian, ops.apply, solvers.TimeGrid, backend).

Both sides compute these in f64 from the same sequence, with the same
operations, so values agree to 1e-12 and integer tables exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.core.sampler import sample as jsample
from pulser_diff_tpu.ops.apply import interp_streams as j_interp
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.core.sampler import sample as tsample
from pulser_diff_torch.ops.apply import interp_streams as t_interp
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.torch_port_cases import emulators, factored_fields, sequence, to_numpy

torch.set_num_threads(1)

# f64 on both sides, same operations in the same order
F64_TOL = 1e-12


def _two_pulse_sequence(core):
    """A parametrised amplitude, a delay and a second pulse with its own
    phase: idle padding, phase holding and build() in one sequence."""
    reg = core.Register.from_coordinates([(0.0, 0.0), (7.0, 0.0), (0.0, 7.0)], prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    v = seq.declare_variable("amp", size=40)
    seq.add(core.Pulse(core.CustomWaveform(v, duration=40),
                       core.ConstantWaveform(40, -2.0), 0.3), "ryd")
    seq.delay(12, "ryd")
    seq.add(core.Pulse.ConstantPulse(28, 1.1, 0.7, -0.9), "ryd")
    return seq.build(amp=np.linspace(0.2, 1.9, 40))


@pytest.mark.parametrize("which", ["single", "two_pulse"])
def test_sampled_streams_match_jax(which):
    if which == "single":
        js, ts = sequence(jcore, 3, 90, seed=1), sequence(tcore, 3, 90, seed=1)
    else:
        js, ts = _two_pulse_sequence(jcore), _two_pulse_sequence(tcore)
    jss = jsample(js, extended_duration=js.get_duration())
    tss = tsample(ts, extended_duration=ts.get_duration(), device="cpu")
    assert set(jss.channel_samples) == set(tss.channel_samples)
    for name, jcs in jss.channel_samples.items():
        tcs = tss.channel_samples[name]
        for f in ("amp", "det", "phase"):
            np.testing.assert_allclose(to_numpy(getattr(tcs, f)), np.asarray(getattr(jcs, f)),
                                       rtol=0, atol=F64_TOL, err_msg=f)
        assert [(s.ti, s.tf) for s in tcs.slots] == [(s.ti, s.tf) for s in jcs.slots]
    # the emulator's globalised, edge-held (+1 sample) copy
    jx = jss.globalize(js.register.qubit_ids).extend_duration(js.get_duration() + 1, hold_edge=True)
    tx = tss.globalize(ts.register.qubit_ids).extend_duration(ts.get_duration() + 1, hold_edge=True)
    for name, jcs in jx.channel_samples.items():
        for f in ("amp", "det", "phase"):
            np.testing.assert_allclose(to_numpy(getattr(tx.channel_samples[name], f)),
                                       np.asarray(getattr(jcs, f)), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("n_atoms", [2, 3, 4])
def test_factored_hamiltonian_fields_match_jax(n_atoms):
    """Every FactoredHamiltonian field, including the odd atom count where
    the row and column groups differ (da != db)."""
    jsim, tsim = emulators(n_atoms, duration=80, seed=n_atoms)
    jf = factored_fields(jsim._hamiltonian._ham_data)
    tf = factored_fields(tsim._hamiltonian._ham_data)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert jf[k].shape == tf[k].shape, k
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=F64_TOL, err_msg=k)
    da, db = tf["int_diag"].shape
    assert da * db == 2**n_atoms and (n_atoms % 2 == 0) == (da == db)
    # the JAX fields carried across reproduce the port's own
    conv = factored_from_numpy(
        row_parts=jf["row_parts"], col_parts=jf["col_parts"],
        row_streams=(jf["row_streams_re"], jf["row_streams_im"]),
        col_streams=(jf["col_streams_re"], jf["col_streams_im"]),
        int_diag=jf["int_diag"], sample_dt=jf["sample_dt"], n_samples=int(jf["n_samples"]), device="cpu",
    )
    for k, v in factored_fields(conv).items():
        np.testing.assert_allclose(v, tf[k], rtol=0, atol=F64_TOL, err_msg=k)


def test_interp_streams_match_jax():
    """Stream interpolation at stage times, including the last sample
    (the JAX package's index rule, not upstream's)."""
    jsim, tsim = emulators(3, duration=80, seed=5)
    jh, th = jsim._hamiltonian._ham_data, tsim._hamiltonian._ham_data
    T = float(jh.sample_dt) * (int(jh.n_samples) - 1)
    t = np.concatenate([np.linspace(0.0, T, 37), [T, 0.5 * float(jh.sample_dt)]])
    jr, jc, _ = j_interp(jh, jnp.asarray(t))
    tr, tc, tk = t_interp(th, torch.as_tensor(t, dtype=torch.float64))
    assert tk is None
    for a, b in ((tr.re, jr.re), (tr.im, jr.im), (tc.re, jc.re), (tc.im, jc.im)):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("eval_times", ["Minimal", "Full", 0.3, "array"])
@pytest.mark.parametrize("substeps", [1, 3])
def test_time_grid_slots_match_jax(eval_times, substeps):
    if eval_times == "array":
        eval_times = [0.0105, 0.033, 0.05]
    jsim, tsim = emulators(2, duration=60, seed=2, evaluation_times=eval_times)
    np.testing.assert_array_equal(tsim._eval_times_array, np.asarray(jsim._eval_times_array))
    jh, th = jsim._hamiltonian, tsim._hamiltonian
    np.testing.assert_array_equal(th.sampling_times, np.asarray(jh.sampling_times))
    jg = JGrid.make(jh.sampling_times, jsim._eval_times_array).refined(substeps)
    tg = TGrid.make(th.sampling_times, tsim._eval_times_array, device="cpu").refined(substeps)
    assert tg.n_eval == jg.n_eval
    np.testing.assert_array_equal(tg.write_slots, np.asarray(jg.write_slots))
    np.testing.assert_allclose(to_numpy(tg.times), np.asarray(jg.times), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("options", [{}, {"max_step": 0.0007}, {"substeps": 4}])
def test_auto_substeps_match_jax(options):
    jsim, tsim = emulators(4, duration=80, seed=3, sampling_rate=0.25)
    assert tsim._auto_substeps(options) == jsim._auto_substeps(options)

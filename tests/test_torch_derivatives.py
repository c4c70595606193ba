"""PyTorch port vs the JAX package: derivatives in the evaluation times
and at one time (pulser_diff_torch.derivative, TimeGrid.with_values,
TorchEmulator.endtimes / expectation_fn_of_times).

Both packages differentiate the f64 stepper through the grid's step
sizes, so the time derivatives agree at 1e-10; the repair at the pulse
boundaries is the same host-side arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu import derivative as jder
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch import TorchEmulator, backend, deriv_param, deriv_time
from pulser_diff_torch import derivative as tder
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.test_torch_bases import pair
from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

TOL = 1e-10


def _two_pulse(core, n_atoms: int = 2, omega=2.0):
    """Two constant pulses (a boundary at 150 ns) on a 2-atom pair 8 um
    apart."""
    reg = core.Register.from_coordinates([(-4.0, 0.0), (4.0, 0.0), (0.0, 7.0)][:n_atoms],
                                         prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse.ConstantPulse(150, omega, -0.5, 0.0), "ryd")
    seq.add(core.Pulse.ConstantPulse(150, 1.0, 0.5, 0.4), "ryd")
    return seq


def _obs(n: int, d: int = 2) -> np.ndarray:
    """sum_i |level 0><level 0|_i as a diagonal."""
    digits = np.stack(np.unravel_index(np.arange(d**n), (d,) * n), axis=1)
    return (digits == 0).sum(1).astype(np.float64)


def _sims(evaluation_times="Full", sampling_rate=0.5):
    jsim = TpuEmulator.from_sequence(_two_pulse(jcore), sampling_rate=sampling_rate,
                                     evaluation_times=evaluation_times)
    tsim = TorchEmulator.from_sequence(_two_pulse(tcore), sampling_rate=sampling_rate,
                                       evaluation_times=evaluation_times, device="cpu")
    return jsim, tsim


def test_time_grid_with_values():
    """The grid keeps the merge's structure; new evaluation-time values land
    where JAX puts them, and the gradient reaches them."""
    jsim, tsim = _sims(evaluation_times=[0.05, 0.1234, 0.2])
    h = tsim._hamiltonian
    jg = JGrid.make(jsim._hamiltonian.sampling_times, jsim._eval_times_array)
    tg = TGrid.make(h.sampling_times, tsim._eval_times_array, device="cpu")
    np.testing.assert_array_equal(tg.perm, jg.perm)
    new = tsim._eval_times_array + 1e-4
    jt = jg.with_values(jnp.asarray(new)).times
    t = torch.tensor(new, requires_grad=True)
    tt = tg.with_values(t)
    np.testing.assert_allclose(to_numpy(tt.times), np.asarray(jt), rtol=0, atol=0)
    np.testing.assert_array_equal(tt.write_slots, tg.write_slots)
    (tt.times * torch.arange(len(tt.times), dtype=torch.float64)).sum().backward()
    assert bool((t.grad > 0).all())
    with pytest.raises(ValueError, match="TimeGrid.make"):
        tg.refined(2).with_values(t)


def test_endtimes_match_jax():
    for rate in (0.5, 0.25, 1.0):
        jsim, tsim = _sims(sampling_rate=rate)
        assert tsim.endtimes == jsim.endtimes
    jsim, tsim = pair("all", 2, duration=80)
    assert tsim.endtimes == jsim.endtimes


@pytest.mark.parametrize("basis", ["ground-rydberg", "all"])
def test_expectation_fn_of_times_and_deriv_time_match_jax(basis, monkeypatch):
    """The trace and df/dt with and without the boundary repair, against
    JAX; the solve takes the f64 stepper, with fused=True too (no fused
    evolution is called)."""
    if basis == "all":
        jsim, tsim = pair("all", 2, evaluation_times="Full", duration=80)
        obs = _obs(2, 3)
    else:
        jsim, tsim = _sims(sampling_rate=0.25)
        obs = _obs(2)
    jfn = jsim.expectation_fn_of_times(jnp.asarray(obs))
    tfn = tsim.expectation_fn_of_times(torch.as_tensor(obs), fused=True)
    jt = jsim.evaluation_times
    tt = tsim.evaluation_times

    def refuse(*a, **k):
        raise AssertionError("a fused evolution was called")

    monkeypatch.setattr(backend, "evolve_states", refuse)
    np.testing.assert_allclose(to_numpy(tfn(tt)), np.asarray(jfn(jt)), rtol=0, atol=TOL)
    ends = tsim.endtimes
    for pe in (None, ends):
        got = deriv_time(tfn, tt, pulse_endtimes=pe)
        want = jder.deriv_time(jfn, jt, pulse_endtimes=pe)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=TOL)
    # the repair only touches the boundary samples
    raw = to_numpy(deriv_time(tfn, tt))
    fixed = to_numpy(deriv_time(tfn, tt, pulse_endtimes=ends))
    changed = set(np.nonzero(raw != fixed)[0].tolist())
    assert changed and changed <= {i for e in ends for i in (e - 1, e)}


def test_deriv_time_tracks_a_central_difference():
    """df/dt at interior times against a central difference of the
    trace, as tests/test_derivatives.py checks JAX's."""
    _, tsim = _sims()
    fn = tsim.expectation_fn_of_times(torch.as_tensor(_obs(2)))
    t = tsim.evaluation_times
    dfdt = to_numpy(deriv_time(fn, t))
    f = to_numpy(fn(t))
    tn = to_numpy(t)
    mid = (f[2:] - f[:-2]) / (tn[2:] - tn[:-2])
    assert np.abs(dfdt[1:-1] - mid)[2:-2].mean() < 5e-2


def test_fix_border_vals_matches_jax():
    rng = np.random.default_rng(2)
    d = rng.normal(size=40)
    for ends in ([0], [0, 9, 10, 29, 30], [0, 9, 10, 36, 37], [0, 5, 20]):
        np.testing.assert_array_equal(tder._fix_border_vals(d, ends, 0.004),
                                      jder._fix_border_vals(d, ends, 0.004))


def test_deriv_param_matches_jax():
    """The gradient at the last time and at a chosen one (ns), one per
    parameter, against JAX's."""

    def jf(om, det):
        seq = jcore.Sequence(jcore.Register.from_coordinates([(-4.0, 0.0), (4.0, 0.0)]),
                             jcore.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(jcore.Pulse.ConstantPulse(150, om, det, 0.0), "ryd")
        sim = TpuEmulator.from_sequence(seq, evaluation_times=0.1)
        return sim.run().expect([jnp.asarray(_obs(2))])[0].re

    def tf(om, det):
        seq = tcore.Sequence(tcore.Register.from_coordinates([(-4.0, 0.0), (4.0, 0.0)]),
                             tcore.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(tcore.Pulse.ConstantPulse(150, om, det, 0.0), "ryd")
        sim = TorchEmulator.from_sequence(seq, evaluation_times=0.1, device="cpu")
        return sim.run().expect([torch.as_tensor(_obs(2))])[0].re

    x = [torch.tensor(1.7, dtype=torch.float64, requires_grad=True),
         torch.tensor(-0.3, dtype=torch.float64, requires_grad=True)]
    jx = [jnp.asarray(1.7), jnp.asarray(-0.3)]
    times = np.linspace(0, 0.15, 15)
    last = deriv_param(tf, x)
    for kw in ({}, {"times": times, "t": 60.0}):
        got = deriv_param(tf, x, **kw)
        want = jder.deriv_param(jf, jx, **({"times": jnp.asarray(times), "t": 60.0} if kw
                                          else {}))
        assert len(got) == 2
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) < TOL
    (g,) = deriv_param(lambda det: tf(x[0], det), x[1])
    assert float(g) == float(last[1])


def test_run_time_grad_warns():
    _, tsim = _sims(evaluation_times="Minimal")
    with pytest.warns(UserWarning, match="expectation_fn_of_times"):
        tsim.run(time_grad=True)

"""PyTorch port vs the JAX package: Lindblad noise through the entry points
(pulser_diff_torch.backend: run()'s reroute to DP5_ME, the ME branch of
_solve_states, one mesolve a run under stochastic noise; model.py:
QuantumModel with a Lindblad noise_config; result.py / simresults.py on
density matrices).

States agree with the JAX package's to 1e-12 and with the scipy golden
model (tests/golden.py) to ATOL_NOISE; model values and gradients to
1e-10; the dephasing-rate gradient equals jax.grad's and a central
difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu import hamiltonian as jham
from pulser_diff_tpu.hamiltonian import NoiseDraws as JDraws
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch import QuantumModel, SimConfig, TorchEmulator
from pulser_diff_torch import TimeGrid as TGrid
from pulser_diff_torch import hamiltonian as tham
from pulser_diff_torch.ops.linalg import total_magnetization
from pulser_diff_torch.simresults import CoherentResults, NoisyResults

from tests.golden import golden_mesolve
from tests.metrics import ATOL_NOISE
from tests.torch_port_cases import sequence, to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
MODEL_TOL = 1e-10
FD_TOL = 1e-6

Z = np.diag([1.0, -1.0]).astype(complex)
X = np.array([[0, 1], [1, 0]], dtype=complex)
Y = np.array([[0, -1j], [1j, 0]])
SGR = np.array([[0, 0], [1, 0]], dtype=complex)  # |g><r| in (r, g) order
EFF_OP = np.array([[0.3, 0.4], [0.4, -0.3]])

# (config, the local collapse operators the golden model lifts)
CHANNELS = {
    "dephasing": (dict(noise="dephasing", dephasing_rate=0.12), [np.sqrt(0.06) * Z]),
    "relaxation": (dict(noise="relaxation", relaxation_rate=0.12), [np.sqrt(0.12) * SGR]),
    "depolarizing": (dict(noise="depolarizing", depolarizing_rate=0.12),
                     [np.sqrt(0.03) * m for m in (X, Y, Z)]),
    "eff_noise": (dict(noise="eff_noise", eff_noise_rates=(0.2,), eff_noise_opers=(EFF_OP,)),
                  [np.sqrt(0.2) * EFF_OP.astype(complex)]),
}


def _pair(n=2, duration=100, evaluation_times=0.25, **cfg):
    jsim = TpuEmulator.from_sequence(sequence(jcore, n, duration), config=JSimConfig(**cfg),
                                     evaluation_times=evaluation_times)
    tsim = TorchEmulator.from_sequence(sequence(tcore, n, duration), config=SimConfig(**cfg),
                                       evaluation_times=evaluation_times, device="cpu")
    return jsim, tsim


def _np(c) -> np.ndarray:
    return to_numpy(c.re) + 1j * to_numpy(c.im)


def _lift(op, site, n):
    out = np.eye(1, dtype=complex)
    for k in range(n):
        out = np.kron(out, op if k == site else np.eye(2, dtype=complex))
    return out


@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_run_matches_jax_and_golden(channel):
    cfg, locs = CHANNELS[channel]
    jsim, tsim = _pair(duration=60, **cfg)
    jres, tres = jsim.run(), tsim.run()
    assert isinstance(tres, CoherentResults)
    js, ts = _np(jres.states), _np(tres.states)
    assert ts.shape == js.shape == (len(tsim._eval_times_array), 4, 4)
    np.testing.assert_allclose(ts, js, rtol=0, atol=F64_TOL)
    collapse = [_lift(m, i, 2) for m in locs for i in range(2)]
    ref = golden_mesolve(sequence(jcore, 2, 60), jcore.MockDevice, tsim._eval_times_array,
                         collapse)
    assert np.abs(ts - ref).max() < ATOL_NOISE
    assert np.abs(np.trace(ts, axis1=1, axis2=2) - 1).max() < 1e-12


def test_solvers_and_forms_through_run_match_jax():
    """The ME solvers a caller names (RK4_ME, DP5_ME_F32) and me_form /
    superop reach mesolve as in the JAX package; a Schrodinger solver is
    rerouted to DP5_ME."""
    jsim, tsim = _pair(n=2, duration=60, evaluation_times="Minimal",
                       noise=("dephasing", "relaxation"), dephasing_rate=0.1)
    for solver, opts, tol in (("RK4_ME", {"me_form": "dense"}, F64_TOL),
                              ("DP5_SE", {"superop": False}, F64_TOL),
                              ("DP5_ME_F32", {}, 2e-6)):
        js = _np(jsim.run(solver=solver, **opts).states)
        ts = _np(tsim.run(solver=solver, **opts).states)
        np.testing.assert_allclose(ts, js, rtol=0, atol=tol)


def _final_z(core, emulator, simconfig, rate, total_mag, **kw):
    sim = emulator.from_sequence(sequence(core, 2, 60), config=simconfig(
        noise="dephasing", dephasing_rate=rate), evaluation_times="Minimal", **kw)
    return sim.run().expect([total_mag])[0].re[-1]


def test_dephasing_rate_gradient_matches_jax_and_fd():
    jval, jgrad = jax.value_and_grad(lambda r: _final_z(
        jcore, TpuEmulator, JSimConfig, r, j_total_mag(2)))(jnp.asarray(0.1))
    obs = total_magnetization(2, device="cpu")

    def f(r):
        return _final_z(tcore, TorchEmulator, SimConfig, r, obs, device="cpu")

    rate = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    val = f(rate)
    val.backward()
    val = val.detach()
    assert abs(float(val) - float(jval)) < MODEL_TOL
    assert abs(float(rate.grad) - float(jgrad)) < MODEL_TOL
    eps = 1e-4
    with torch.no_grad():
        fd = (float(f(torch.tensor(0.1 + eps))) - float(f(torch.tensor(0.1 - eps)))) / (2 * eps)
    assert abs(float(rate.grad) - fd) < FD_TOL


def test_dephasing_doppler_runs_match_jax():
    """Each run of a dephasing + doppler batch (one mesolve a run) against
    the JAX package's mesolve on the same draws."""
    cfg = dict(noise=("dephasing", "doppler"), dephasing_rate=0.1, temperature=60.0, runs=3,
               samples_per_run=4)
    jsim, tsim = _pair(duration=60, evaluation_times="Minimal", **cfg)
    draws, reps, varying = tsim._draw_batch(False)
    assert reps == [1, 1, 1] and varying == frozenset({"doppler"})
    h, jh = tsim._hamiltonian, jsim._hamiltonian
    substeps = tsim._auto_substeps({})
    assert substeps == jsim._auto_substeps({})
    tgrid = TGrid.make(h.sampling_times, tsim._eval_times_array, device="cpu")
    ts = tsim._solve_batch(h.build_batch(draws, varying), "DP5_ME", substeps, tgrid, {})
    jgrid = JGrid.make(jh.sampling_times, jsim._eval_times_array)
    for r, d in enumerate(draws):
        jd = JDraws(*(jnp.asarray(to_numpy(x)) for x in d))
        js = jsim._solve_states(jh.build_data(jd), None, "DP5_ME", substeps, 12, jgrid)
        np.testing.assert_allclose(_np(ts[r]), np.asarray(js.re) + 1j * np.asarray(js.im),
                                   rtol=0, atol=F64_TOL)
    res = tsim.run()
    assert isinstance(res, NoisyResults)
    assert {sum(r.bitstring_counts.values()) for r in res} == {12}


def _model_sequence(core, kind):
    reg = core.Register.from_coordinates([(0.0, 0.0), (7.0, 0.0)], prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ch", "microwave_global" if kind == "xy" else "rydberg_global")
    om = seq.declare_variable("omega")
    seq.add(core.Pulse.ConstantPulse(80, om, -0.6, 0.2), "ch")
    return seq


MODEL_NOISE = {
    "ising": dict(noise=("dephasing", "relaxation"), dephasing_rate=0.1, relaxation_rate=0.05),
    "xy": dict(noise=("depolarizing",), depolarizing_rate=0.08),
}


@pytest.mark.parametrize("kind", ["ising", "xy"])
def test_model_value_and_grad_match_jax(kind):
    jm = JModel(_model_sequence(jcore, kind), {"omega": jnp.asarray(1.7)},
                noise_config=JSimConfig(**MODEL_NOISE[kind]), evaluation_times="Minimal")
    tm = QuantumModel(_model_sequence(tcore, kind), {"omega": 1.7},
                      noise_config=SimConfig(**MODEL_NOISE[kind]), evaluation_times="Minimal",
                      device="cpu")
    jfn = jm.expectation_fn()
    jv, jg = jax.value_and_grad(lambda om: jfn({"omega": om})[1][-1])(jnp.asarray(1.7))
    om = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    tv = tm.expectation_fn()({"omega": om})[1][-1]
    tv.backward()
    tv = tv.detach()
    assert abs(float(tv) - float(jv)) < MODEL_TOL
    assert abs(float(om.grad) - float(jg)) < MODEL_TOL
    # forward(): density matrices through run()
    jt, js = jm.forward()
    tt, ts = tm.forward()
    np.testing.assert_allclose(_np(ts), np.asarray(js.re) + 1j * np.asarray(js.im), rtol=0,
                               atol=F64_TOL)


def test_stochastic_only_model_and_leakage_raise(monkeypatch):
    """A doppler-only model differentiates one drawn realization on the
    Schrodinger stepper (kets, not density matrices), as JAX's does: from
    the same draws, value and gradient to MODEL_TOL.  Leakage runs on the
    extended basis (three levels a site), its density matrices equal to
    JAX's."""
    dop = np.array([0.7, -0.4])

    def draws(lib, cls, key, cfg, n, n_slots):
        d = dop if "doppler" in cfg.noise_types else np.zeros(n)
        return cls(*(lib.asarray(x) for x in (np.zeros(n), d, np.ones(max(n_slots, 1)))))

    monkeypatch.setattr(jham, "draw_noise", lambda *a: draws(jnp, JDraws, *a))
    monkeypatch.setattr(tham, "draw_noise", lambda *a: draws(torch, tham.NoiseDraws, *a))
    jm = JModel(_model_sequence(jcore, "ising"), {"omega": jnp.asarray(1.7)},
                noise_config=JSimConfig(noise=("doppler",)), evaluation_times="Minimal")
    tm = QuantumModel(_model_sequence(tcore, "ising"), {"omega": 1.7},
                      noise_config=SimConfig(noise=("doppler",)), evaluation_times="Minimal",
                      device="cpu")
    jfn = jm.expectation_fn()
    jv, jg = jax.value_and_grad(lambda om: jfn({"omega": om})[1][-1])(jnp.asarray(1.7))
    om = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    tv = tm.expectation_fn()({"omega": om})[1][-1]
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) < MODEL_TOL
    assert abs(float(om.grad) - float(jg)) < MODEL_TOL
    _, states = tm._states_fn({"omega": om.detach()})
    assert tuple(states.shape[1:]) == (4, 1)
    leak = np.zeros((3, 3))
    leak[2, 1] = 1.0  # |x><g|
    jsim, tsim = _pair(noise=("eff_noise",), with_leakage=True, eff_noise_rates=(0.1,),
                       eff_noise_opers=(leak,))
    rho = tsim.run().states
    assert tuple(rho.shape[1:]) == (9, 9)
    np.testing.assert_allclose(_np(rho), jsim.run().states.to_numpy(), rtol=0, atol=F64_TOL)


def test_results_over_rho_match_jax():
    """get_state / get_final_state, expect on dense and diagonal
    observables, the measurement weights and samples of density-matrix
    results; with SPAM measurement errors only, the pseudo-density's."""
    cfg, _ = CHANNELS["depolarizing"]
    jsim, tsim = _pair(**cfg)
    jr, tr = jsim.run(), tsim.run()
    t = float(tsim._eval_times_array[1])
    np.testing.assert_allclose(_np(tr.get_state(t)), _np(jr.get_state(t)), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(_np(tr.get_final_state()), _np(jr.get_final_state()), rtol=0,
                               atol=F64_TOL)
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    for o in (obs, np.arange(4.0)):
        np.testing.assert_allclose(_np(tr.expect([o])[0]), _np(jr.expect([o])[0]), rtol=0,
                                   atol=F64_TOL)
    assert tr[-1].sampling_dist.keys() == jr[-1].sampling_dist.keys()
    for k, p in jr[-1].sampling_dist.items():
        assert abs(tr[-1].sampling_dist[k] - p) < F64_TOL
    assert sum(tr.sample_final_state(500).values()) == 500
    # SPAM measurement errors only: CoherentResults over the pseudo-density
    spam = dict(noise=("dephasing", "SPAM"), dephasing_rate=0.1, eta=0.0, epsilon=0.05,
                epsilon_prime=0.1)
    jsim, tsim = _pair(**spam)
    jr, tr = jsim.run(), tsim.run()
    assert isinstance(tr, CoherentResults)
    np.testing.assert_allclose(_np(tr.expect([np.arange(4.0)])[0]),
                               _np(jr.expect([np.arange(4.0)])[0]), rtol=0, atol=F64_TOL)


def test_spam_preparation_errors_with_dephasing():
    """SPAM eta > 0 with dephasing: the bad-atom configurations, one
    mesolve each, sampled into NoisyResults (the JAX package's path)."""
    cfg = dict(noise=("dephasing", "SPAM"), dephasing_rate=0.1, eta=0.3, epsilon=0.0,
               epsilon_prime=0.0, runs=6, samples_per_run=5)
    _, tsim = _pair(duration=60, evaluation_times="Minimal", **cfg)
    res = tsim.run()
    assert isinstance(res, NoisyResults)
    assert {sum(r.bitstring_counts.values()) for r in res} == {30}
    assert abs(sum(res.results[-1].values()) - 1.0) < 1e-12

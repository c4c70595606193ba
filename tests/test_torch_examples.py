"""PyTorch port: the example flows (pulser_diff_torch.examples) against
the JAX package on the same inputs, the docs scripts' start values.

  - gate_optimization: the 2-qubit fidelity's value and gradient, the
    first 3 Adam steps of the 2-qubit loop (lr 0.15, tests/test_docs.py's
    floor loop) against optax's, the 4-qubit fidelity (nb = 16);
  - state_preparation: the 6-atom fidelity and its gradient;
  - afm_preparation: the 9-atom fidelity;
  - basic_usage: the final magnetization, d<M>/d omega and max |d<M>/dt|;
  - noisy_simulation: the CI quantities that no draw enters (the Lindblad
    trace and <Sz>, the dephasing-rate gradient, the leaked population,
    the dense form's trace), and the drawn ones seeded;
  - large_scale: the CI model's value and gradient;
  - multi_start: fit_population from one numpy stack in both packages;
  - every example: a module that imports without running its flow.

The JAX side runs through the JAX package's API, or through
``runpy.run_path`` of the three scripts that only define functions at
import (gate_optimization.py, state_preparation.py, afm_preparation.py).
Both sides solve on their f64 steppers on the CPU; torch.optim.Adam and
optax.adam make the same update in another operation order.
"""

import importlib
import pkgutil
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.examples as texamples
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_magnetization
from pulser_diff_tpu.ops.linalg import _interpolate_sine_np as j_interp
from pulser_diff_torch.examples import (
    afm_preparation, basic_usage, gate_optimization, large_scale, multi_start,
    noisy_simulation, state_preparation,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DOCS = ROOT / "docs"
CPU = "cpu"

# f64 on both sides, the same steps in another operation order
TOL = 1e-10
# quantities through a derivative of a long solve, or printed by a script
PRINTED_TOL = 1e-8
# losses of an Adam trajectory (relative)
ADAM_REL = 1e-9
ADAM_STEPS = 3


def _docs(name: str) -> dict:
    return runpy.run_path(str(DOCS / f"{name}.py"), run_name="docs")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grad(fn, *args):
    """(value, gradients) of the scalar ``fn(*args)`` in each argument."""
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    value = fn(*xs)
    return value.detach(), torch.autograd.grad(value, xs)


# ---------------------------------------------------------------------------
# gate_optimization
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jgate():
    return _docs("gate_optimization")


@pytest.fixture(scope="module")
def gate_loops(jgate):
    """The 2-qubit floor loop's first ADAM_STEPS losses in both packages,
    and the first step's gradient."""
    n = gate_optimization.N_PARAMS
    vag = jax.jit(jax.value_and_grad(lambda p: 1.0 - jgate["gate_fidelity"](p)))
    params = tuple(jnp.full((n,), v) for v in gate_optimization.P0)
    opt = optax.adam(gate_optimization.FLOOR_LR)
    state = opt.init(params)
    j_losses, j_grad0 = [], None
    for _ in range(ADAM_STEPS):
        v, g = vag(params)
        j_losses.append(float(v))
        j_grad0 = g if j_grad0 is None else j_grad0
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    p0 = gate_optimization.initial_params(n, gate_optimization.P0, CPU)
    value, grad = _grad(lambda a, d: 1.0 - gate_optimization.gate_fidelity((a, d), CPU), *p0)
    run = gate_optimization.optimize(lambda p: gate_optimization.gate_fidelity(p, CPU), p0,
                                     ADAM_STEPS, lr=gate_optimization.FLOOR_LR, log_every=0)
    return dict(j_losses=j_losses, j_grad0=j_grad0, value=value, grad=grad, run=run)


def test_gate_fidelity_value_and_gradient(gate_loops):
    r = gate_loops
    np.testing.assert_allclose(float(r["value"]), r["j_losses"][0], rtol=0, atol=TOL)
    for got, want in zip(r["grad"], r["j_grad0"]):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    assert np.abs(np.asarray(r["j_grad0"][0])).max() > 1e-7


def test_gate_adam_steps_match_optax(gate_loops):
    """The 2-qubit floor loop (Adam at lr 0.15 from 3.0): the losses of its
    first steps against optax's, each step's parameters feeding the next."""
    r = gate_loops
    np.testing.assert_allclose(r["run"].losses, r["j_losses"], rtol=ADAM_REL, atol=0)
    assert r["run"].best == min(r["run"].losses)
    # the loop moves: each step's loss differs from the first
    assert abs(r["j_losses"][-1] - r["j_losses"][0]) > 1e-6


def test_gate_fidelity_4q_value(jgate):
    """The 4-qubit gate (nb = 16, 20 + 20 knots, 1100 ns) at the script's
    start values."""
    n = gate_optimization.N_PARAMS4
    want = float(jgate["gate_fidelity_4q"](tuple(jnp.full((n,), v)
                                                 for v in gate_optimization.P0_4)))
    got = gate_optimization.gate_fidelity_4q(
        gate_optimization.initial_params(n, gate_optimization.P0_4, CPU), CPU)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gate_optimization.TARGET4, jgate["TARGET4"])


# ---------------------------------------------------------------------------
# state_preparation, afm_preparation
# ---------------------------------------------------------------------------
def test_state_preparation_fidelity_and_gradient():
    jmod = _docs("state_preparation")
    a, d = state_preparation.initial_params(CPU)
    jv, jg = jax.jit(jax.value_and_grad(jmod["fidelity"], argnums=(0, 1)))(
        jnp.asarray(_np(a)), jnp.asarray(_np(d)))
    value, grad = _grad(lambda x, y: state_preparation.fidelity(x, y, CPU), a, d)
    np.testing.assert_allclose(float(value), float(jv), rtol=0, atol=TOL)
    for got, want in zip(grad, jg):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    assert state_preparation.TARGET_INDEX == jmod["TARGET_INDEX"]


def test_afm_fidelity():
    """Called eagerly, as the port calls it: under jax.jit the JAX
    emulator cannot read the Hamiltonian's norm and takes 1 substep where
    the heuristic asks 2 here."""
    jmod = _docs("afm_preparation")
    a, d = afm_preparation.initial_params(CPU)
    want = float(jmod["fidelity"](jnp.asarray(_np(a)), jnp.asarray(_np(d))))
    got = afm_preparation.fidelity(a, d, CPU)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=TOL)
    assert afm_preparation.TARGET == jmod["TARGET"]


# ---------------------------------------------------------------------------
# basic_usage
# ---------------------------------------------------------------------------
def _j_basic_sequence(omega):
    reg = jcore.Register({"q0": jnp.array([-4.0, 0.0]), "q1": jnp.array([4.0, 0.0])})
    seq = jcore.Sequence(reg, jcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(jcore.Pulse.ConstantPulse(300, omega, -1.0, 0.0), "ryd")
    seq.add(jcore.Pulse(jcore.BlackmanWaveform(300, np.pi), jcore.RampWaveform(300, -2.0, 2.0),
                        0.3), "ryd")
    return seq


def _j_basic_quantities():
    """docs/basic_usage.py's three printed quantities through the JAX API:
    the magnetization trace's final value and its derivative in omega at
    the final time (one program), and deriv_time through sesolve."""
    from pulser_diff_tpu.cplx import Cplx
    from pulser_diff_tpu.derivative import deriv_time
    from pulser_diff_tpu.ops.linalg import expect
    from pulser_diff_tpu.solvers import TimeGrid, sesolve

    obs = j_total_magnetization(2)

    def final(omega):
        sim = TpuEmulator.from_sequence(_j_basic_sequence(omega))
        return sim.run().expect([obs])[0].re[-1]

    value, grad = jax.jit(jax.value_and_grad(final))(jnp.asarray(2.0))
    sim = TpuEmulator.from_sequence(_j_basic_sequence(2.0))
    h = sim._hamiltonian
    grid0 = TimeGrid.make(h.sampling_times, sim._eval_times_array)
    da, db = h.dim**h._a, h.dim**h._b
    psi0 = sim.initial_state
    p = Cplx(psi0.re.T.reshape(1, da, db), psi0.im.T.reshape(1, da, db))

    def trace_of_times(ts):
        states = sesolve(h._ham_data, p, grid0.with_values(ts))
        n = states.re.shape[0]
        return expect(obs, Cplx(states.re.reshape(n, da * db, 1),
                                states.im.reshape(n, da * db, 1))).re

    dmdt = deriv_time(trace_of_times, sim.evaluation_times, pulse_endtimes=sim.endtimes)
    return float(value), float(grad), float(jnp.abs(dmdt).max())


def test_basic_usage_quantities():
    """The final magnetization, d<M>(T)/d omega (deriv_param) and
    max |d<M>/dt| (deriv_time) that basic_usage prints."""
    want = _j_basic_quantities()
    final, grad = basic_usage.magnetization_and_grad(CPU)
    dmdt = float(basic_usage.time_derivative(CPU).abs().max())
    np.testing.assert_allclose((final, grad, dmdt), want, rtol=PRINTED_TOL, atol=PRINTED_TOL)
    assert abs(grad) > 0.1 and dmdt > 1.0


# ---------------------------------------------------------------------------
# noisy_simulation
# ---------------------------------------------------------------------------
def _j_noisy_seq(dur):
    reg = jcore.Register({"q0": jnp.array([-4.0, 0.0]), "q1": jnp.array([4.0, 0.0])})
    seq = jcore.Sequence(reg, jcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(jcore.Pulse.ConstantPulse(dur, 2.0, -1.0, 0.0), "ryd")
    return seq


def _j_noisy_quantities(dur: int, n_mid: int) -> dict:
    """docs/noisy_simulation.py's deterministic quantities through the JAX
    API, at the script's CI sizes."""
    obs = j_total_magnetization(2)
    cfg = JSimConfig(noise=("dephasing", "relaxation"), dephasing_rate=0.1,
                     relaxation_rate=0.05)
    res = TpuEmulator.from_sequence(_j_noisy_seq(dur), config=cfg, evaluation_times=0.2).run()
    rho = res.states[len(res._sim_times) - 1]
    out = {"trace": float(jnp.trace(rho.re)), "sz": float(res.expect([obs])[0].re[-1])}

    def loss(rate):
        sim = TpuEmulator.from_sequence(
            _j_noisy_seq(dur), config=JSimConfig(noise="dephasing", dephasing_rate=rate),
            evaluation_times="Minimal")
        return sim.run().expect([obs])[0].re[-1]

    out["rate_grad"] = float(jax.grad(loss)(jnp.asarray(0.1)))
    lop = np.zeros((3, 3))
    lop[2, 1] = 1.0
    cfg = JSimConfig(noise="eff_noise", eff_noise_rates=(0.2,), eff_noise_opers=(lop,),
                     with_leakage=True)
    res = TpuEmulator.from_sequence(_j_noisy_seq(dur), config=cfg,
                                    evaluation_times="Minimal").run()
    r = res.states[len(res._sim_times) - 1].re
    out["leaked"] = float(r[8, 8] + r[2, 2] + r[5, 5] + r[7, 7])
    reg = jcore.Register.from_coordinates([(9.0 * i, 0.0) for i in range(n_mid)], prefix="q")
    seq = jcore.Sequence(reg, jcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(jcore.Pulse.ConstantPulse(dur, 1.5, -0.8, 0.0), "ryd")
    sim = TpuEmulator.from_sequence(seq, config=JSimConfig(noise="dephasing",
                                                           dephasing_rate=0.05),
                                    evaluation_times="Minimal")
    out["dense_trace"] = float(np.trace(np.asarray(
        sim.run(solver="DP5_ME", me_form="dense").states.re)[-1]))
    return out


def test_noisy_simulation_deterministic_quantities():
    """The Lindblad run's trace and <Sz>, the dephasing-rate gradient, the
    leaked population and the dense form's trace, at the CI sizes."""
    s = noisy_simulation.sizes(ci=True)
    dur = s["dur"]
    want = _j_noisy_quantities(dur, s["n_mid"])
    trace, sz = noisy_simulation.lindblad(dur, CPU)
    got = {"trace": trace, "sz": sz, "rate_grad": noisy_simulation.rate_gradient(dur, CPU),
           "leaked": noisy_simulation.leakage(dur, CPU),
           "dense_trace": noisy_simulation.dense_me(dur, s["n_mid"], CPU)}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL, err_msg=k)
    assert abs(got["rate_grad"]) > 1e-5 and got["leaked"] > 1e-3


def test_noisy_simulation_draws_are_seeded():
    """The Monte-Carlo run() and the MCWF runs: counts summing to runs x
    samples_per_run (frequencies to 1), the same seed giving the same
    draws, the trajectories' populations near the master equation's."""
    s = noisy_simulation.sizes(ci=True)
    dur, runs = s["dur"], s["mc_runs"]
    counts = noisy_simulation.monte_carlo(dur, runs, CPU)
    assert sum(counts.values()) == runs * 30
    assert counts == noisy_simulation.monte_carlo(dur, runs, CPU)
    assert counts != noisy_simulation.monte_carlo(dur, runs, CPU, seed=8)
    eta = noisy_simulation.mcwf_eta(dur, s["traj"], CPU)
    assert sum(eta.values()) == pytest.approx(1.0, abs=1e-12)
    assert noisy_simulation.mcwf_vs_me(dur, s["traj"], CPU) < 4 / np.sqrt(s["traj"])


# ---------------------------------------------------------------------------
# large_scale
# ---------------------------------------------------------------------------
def test_large_scale_ci_value_and_gradient():
    n, dur, k = large_scale.sizes(ci=True)
    coords = [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n)]
    seq = jcore.Sequence(jcore.Register.from_coordinates(coords, prefix="q"), jcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp = seq.declare_variable("amp", size=dur)
    seq.add(jcore.Pulse(jcore.CustomWaveform(amp, duration=dur),
                        jcore.ConstantWaveform(dur, -2.0), 0.0), "ryd")
    m = jnp.asarray(j_interp(k, dur))
    jmodel = JModel(seq, {"amp": ((jnp.linspace(1.0, 3.0, k),), lambda v: m @ v)},
                    sampling_rate=0.25, evaluation_times="Minimal")
    exp_fn = jmodel.expectation_fn(j_total_magnetization(n, dense=False))
    jv, jg = jax.jit(jax.value_and_grad(lambda x: exp_fn({"amp_0": x})[1][-1]))(
        jnp.linspace(1.0, 3.0, k))
    model = large_scale.make_model(n, dur, k, CPU)
    value, grad = large_scale.value_and_grad(
        model, torch.as_tensor(large_scale.start_knots(k), dtype=torch.float64))
    np.testing.assert_allclose(float(value), float(jv), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(grad), np.asarray(jg), rtol=0, atol=TOL)
    norm = large_scale.f32_final_norm(model, torch.as_tensor(large_scale.start_knots(k)))
    assert abs(norm - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# multi_start
# ---------------------------------------------------------------------------
def test_multi_start_fit_population_matches_jax():
    """fit_population (Adam at 5e-2) from one numpy stack of 2 candidates,
    2 epochs: every epoch's losses, the final stack and the loaded best
    candidate in both packages."""
    n_pop, epochs = 2, 2
    stack = multi_start.initial_stack(n_pop)
    dur, n = multi_start.DURATION, multi_start.N_PARAMS
    reg = jcore.Register({"q0": jnp.array([-5.0, 0.0]), "q1": jnp.array([5.0, 0.0])})
    seq = jcore.Sequence(reg, jcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp_samples = seq.declare_variable("amp_samples", size=dur)
    det = seq.declare_variable("det")
    seq.add(jcore.Pulse(jcore.CustomWaveform(amp_samples, duration=dur),
                        jcore.ConstantWaveform(dur, det), 0.0), "ryd")
    m = jnp.asarray(j_interp(n, dur))
    jmodel = JModel(seq, {"amp_samples": ((jnp.ones(n),), lambda v: m @ v),
                          "det": jnp.asarray(0.0)},
                    sampling_rate=multi_start.SAMPLING_RATE, evaluation_times="Minimal")
    _, v_target = jmodel.expectation_fn()({"amp_samples_0": jnp.asarray(multi_start.TRUE_AMP),
                                           "det": jnp.asarray(multi_start.TRUE_DET)})
    j_target = float(v_target[-1])
    j_losses, j_final = jmodel.fit_population(
        lambda t, v: (v[-1] - j_target) ** 2, {k: jnp.asarray(v) for k, v in stack.items()},
        epochs=epochs, optimizer=optax.adam(multi_start.LR))

    model = multi_start.make_model(CPU)
    target = multi_start.target_value(model)
    np.testing.assert_allclose(target, j_target, rtol=0, atol=TOL)
    losses, final = multi_start.train(model, target, stack, epochs)
    assert len(losses) == epochs and all(x.shape == (n_pop,) for x in losses)
    np.testing.assert_allclose(np.stack(losses), np.stack([np.asarray(x) for x in j_losses]),
                               rtol=ADAM_REL, atol=1e-14)
    for k, v in j_final.items():
        np.testing.assert_allclose(_np(final[k]), np.asarray(v), rtol=0, atol=ADAM_REL)
        np.testing.assert_allclose(_np(model.params[k]), np.asarray(jmodel.params[k]), rtol=0,
                                   atol=ADAM_REL)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------
_QUIET_IMPORT = """
import importlib, pkgutil, sys, time
import pulser_diff_torch.examples as ex
t0 = time.perf_counter()
for m in pkgutil.iter_modules(ex.__path__):
    importlib.import_module("pulser_diff_torch.examples." + m.name)
print(round(time.perf_counter() - t0, 3))
"""


def test_examples_import_without_running():
    """A module for each docs/*.py script, each with main(device, ci); in
    a fresh interpreter they import in well under a second, printing
    nothing."""
    names = {m.name for m in pkgutil.iter_modules(texamples.__path__)} - {"_common"}
    assert names == {p.stem for p in DOCS.glob("*.py")}
    for name in names:
        mod = importlib.import_module(f"pulser_diff_torch.examples.{name}")
        assert callable(mod.main)
        assert mod.main.__code__.co_varnames[:2] == ("device", "ci")
    out = subprocess.run([sys.executable, "-c", _QUIET_IMPORT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    (line,) = out.stdout.strip().splitlines()
    assert float(line) < 1.0


def test_examples_state_no_tpu_figures():
    """The examples name no TPU, and so state no figure taken on one."""
    import re

    for path in Path(texamples.__file__).parent.glob("*.py"):
        found = re.findall(r"\b(tpu|v5e|v4|xla|pallas|mxu|hbm|vmem)\b", path.read_text(), re.I)
        assert not found, (path.name, found)

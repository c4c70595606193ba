"""PyTorch port vs the JAX package: the adaptive DP5(4) stepper
``DP5_SE_ADAPTIVE`` (pulser_diff_torch.solvers.solver: ``_adaptive_dp5``,
``_AdaptiveEvolve``, ``_make_se_step_adaptive``) and the new solvers'
options through ``run``, ``QuantumModel``, the noisy batch,
``expectation_fn_of_times`` and ``expectation_fn_of_dists``.

Both packages take the same steps: the same error norm over every element,
the same accept rule and step factor, the same end test and attempt cap
(the JAX package's bounded while loop is a host loop here, one read an
attempt).  The JAX package's attempt and accept counts are read by
wrapping ``jax.lax.while_loop`` with a counting carry.  The backward pass
is the same continuous-adjoint sweep, so values and gradients agree to
f64 roundoff carried through the step control.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_torch import SimConfig, TorchEmulator, backend
from pulser_diff_torch.ops.linalg import total_magnetization
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import solver as tsolver

from tests.test_torch_krylov import _jax_stream_loss, _port_value_and_grad, _stream_loss
from tests.test_torch_model_api import _jax_model, _port_model
from tests.test_torch_solver import _setup
from tests.torch_port_cases import emulators, jax_cplx, to_numpy, torch_cplx

torch.set_num_threads(1)

STATE_TOL = 1e-10
GRAD_TOL = 1e-8


def _jax_counted(monkeypatch, fn):
    """fn() with JAX's adaptive loop counting its attempted and accepted
    steps: (result, {"attempts": n, "accepted": n})."""
    stats = {"attempts": 0, "accepted": 0}
    real = jax.lax.while_loop

    def record(a, b):
        stats["attempts"] += int(a)
        stats["accepted"] += int(b)

    def counting(cond, body, init):
        def body2(c):
            inner, att, acc = c
            new = body(inner)
            return new, att + 1, acc + (new[0] != inner[0]).astype(jnp.int32)

        out, att, acc = real(lambda c: cond(c[0]), body2, (init, jnp.int32(0), jnp.int32(0)))
        jax.debug.callback(record, att, acc)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counting)
    try:
        out = fn()
        jax.effects_barrier()
    finally:
        monkeypatch.undo()
    return out, stats


def _port_counted(fn):
    tsolver.reset_adaptive_counts()
    out = fn()
    return out, dict(tsolver.ADAPTIVE_COUNTS)


@pytest.mark.parametrize("opts", [{}, {"rtol": 1e-6, "atol": 1e-9}])
def test_adaptive_run_matches_jax_step_for_step(monkeypatch, opts):
    """run(solver="DP5_SE_ADAPTIVE") states at 1e-10, with the same
    attempted and accepted steps; one host read an attempt and one an
    interval."""
    jsim, tsim = emulators(3, duration=60, seed=3, sampling_rate=0.1, evaluation_times=0.5)
    js, jc = _jax_counted(monkeypatch, lambda: jsim.run(solver="DP5_SE_ADAPTIVE", **opts).states)
    ts, tc = _port_counted(lambda: tsim.run(solver="DP5_SE_ADAPTIVE", **opts).states)
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=STATE_TOL)
    assert jc["attempts"] > jc["accepted"] > 0
    assert (tc["attempts"], tc["accepted"]) == (jc["attempts"], jc["accepted"])
    grid = TGrid.make(tsim._hamiltonian.sampling_times, tsim._eval_times_array, device="cpu")
    assert tc["reads"] == tc["attempts"] + len(grid.times) - 1


def test_adaptive_value_and_grad_match_jax():
    """Value and gradient in the streams and the interaction diagonal
    through the continuous adjoint (its own adaptive sweep over psi, the
    costate and every stream cotangent) against jax.value_and_grad at
    1e-8."""
    jh, th, psi, jg, tg = _setup(3, 1, "Minimal", duration=30)
    opts = {"rtol": 1e-6, "atol": 1e-9}
    jv, (jgs, jgd) = jax.value_and_grad(
        _jax_stream_loss(jh, jax_cplx(*psi), jg, "DP5_SE_ADAPTIVE", **opts), argnums=(0, 1))(
        jh.row_streams.re, jh.int_diag)
    tv, tgs, tgd = _port_value_and_grad(
        _stream_loss(th, torch_cplx(*psi), tg, "DP5_SE_ADAPTIVE", **opts), th)
    assert abs(float(tv) - float(jv)) < GRAD_TOL
    for got, want in ((tgs, jgs), (tgd, jgd)):
        assert float(np.abs(np.asarray(want)).max()) > 1e-3
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=GRAD_TOL)


def test_adaptive_time_gradient_matches_jax():
    """tests/test_solvers.py::test_adaptive_dp5_time_gradient on the port:
    the gradient in the evaluation times flows through the interval ends'
    cotangents; against JAX's at 1e-8, and against the fixed-step DP5 at
    that test's 1e-6."""
    def sim(core, cls, **kw):
        reg = core.Register({"q0": [-4.0, 0.0], "q1": [4.0, 0.0]})
        seq = core.Sequence(reg, core.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        seq.add(core.Pulse.ConstantPulse(100, 2.0, 0.0, 0.5), "ryd")
        return cls.from_sequence(seq, evaluation_times=[0.04, 0.08], **kw)

    jsim = sim(jcore, TpuEmulator)
    tsim = sim(tcore, TorchEmulator, device="cpu")
    jfn = jsim.expectation_fn_of_times(j_total_mag(2), solver="DP5_SE_ADAPTIVE", substeps=2)
    g_jax = jax.grad(lambda t: jfn(t)[-1])(jsim.evaluation_times)
    tfn = tsim.expectation_fn_of_times(total_magnetization(2, device="cpu"),
                                       solver="DP5_SE_ADAPTIVE", substeps=2)
    times = tsim.evaluation_times.clone().requires_grad_(True)
    tfn(times)[-1].backward()
    fixed = tsim.expectation_fn_of_times(total_magnetization(2, device="cpu"))
    t2 = tsim.evaluation_times.clone().requires_grad_(True)
    fixed(t2)[-1].backward()
    assert float(np.abs(np.asarray(g_jax)).max()) > 1e-4
    np.testing.assert_allclose(to_numpy(times.grad), np.asarray(g_jax), rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(to_numpy(times.grad), to_numpy(t2.grad), rtol=0, atol=1e-6)


def _simple(core, cls, **kw):
    reg = core.Register({"q0": [-4.0, 0.0], "q1": [4.0, 0.0]})
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse.ConstantPulse(240, 2.0, -1.0, 0.5), "ryd")
    return cls.from_sequence(seq, sampling_rate=0.05, evaluation_times="Minimal", **kw)


def test_adaptive_options_plumbed(monkeypatch):
    """tests/test_routing.py::test_adaptive_options_plumbed on the port
    (rtol / atol / max_iters reach the adaptive stepper through run();
    at tight tolerances 20 ns intervals are cut, at loose ones taken
    whole), and a run capped by max_iters gives JAX's result, attempt for
    attempt."""
    sim = _simple(tcore, TorchEmulator, device="cpu")
    ref = to_numpy(sim.run(solver="DP5_SE", fused=False, substeps=8).states.re)
    tight = to_numpy(sim.run(solver="DP5_SE_ADAPTIVE", rtol=1e-12, atol=1e-14).states.re)
    loose = to_numpy(sim.run(solver="DP5_SE_ADAPTIVE", rtol=1e-3, atol=1e-3,
                             max_iters=8).states.re)
    d_tight, d_loose = np.abs(tight - ref).max(), np.abs(loose - ref).max()
    assert np.abs(tight - loose).max() > 0
    assert d_tight < 1e-9
    assert d_loose > d_tight
    jsim = _simple(jcore, TpuEmulator)
    capped = {"rtol": 1e-12, "atol": 1e-14, "max_iters": 3}
    js, jc = _jax_counted(monkeypatch, lambda: jsim.run(solver="DP5_SE_ADAPTIVE", **capped).states)
    ts, tc = _port_counted(lambda: sim.run(solver="DP5_SE_ADAPTIVE", **capped).states)
    times = TGrid.make(sim._hamiltonian.sampling_times, sim._eval_times_array, device="cpu").times
    n_spans = int((torch.diff(times) > 1e-15).sum())  # zero-length intervals take no attempt
    assert tc["attempts"] == jc["attempts"] == 3 * n_spans
    assert tc["accepted"] == jc["accepted"]
    assert np.abs(to_numpy(ts.re) - tight).max() > 1e-6  # the cap stopped it short
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=STATE_TOL)


OPTS = {"krylov_dim": 8, "krylov_tol": 1e-12, "rtol": 1e-7, "atol": 1e-9, "max_iters": 64}


@pytest.mark.parametrize("solver", ["KRYLOV_SE", "DP5_SE_ADAPTIVE"])
def test_model_takes_the_new_solvers(solver):
    """QuantumModel takes the new solvers with the JAX package's five
    options and gives JAX's values at 1e-10 (4 atoms, 121 times); with
    KRYLOV_SE_F32 it stays within 1e-5 relative of the f64 Krylov model."""
    jm, tm = _jax_model(solver=solver, **OPTS), _port_model(solver=solver, **OPTS)
    _, jv = jm.expectation()
    _, tv = tm.expectation()
    np.testing.assert_allclose(to_numpy(tv.re), np.asarray(jv.re), rtol=0, atol=STATE_TOL)
    if solver == "KRYLOV_SE":
        _, t32 = _port_model(solver="KRYLOV_SE_F32", **OPTS).expectation()
        scale = float(tv.re.abs().max())
        assert float((t32.re.double() - tv.re).abs().max()) < 1e-5 * scale


def test_distances_take_the_new_solvers():
    """expectation_fn_of_dists takes the adaptive stepper and its options:
    value against JAX's at 1e-8 and distance gradient at 1e-6 of its
    largest entry; and the Krylov stepper's value at 1e-10."""
    jsim, tsim = emulators(3, duration=40, seed=6)
    d0 = np.asarray([float(tsim.qq_distances[k]) for k in tsim.qq_distance_keys])
    obs_j, obs_t = j_total_mag(3), total_magnetization(3, device="cpu")
    jfn = jsim.expectation_fn_of_dists(obs_j, solver="DP5_SE_ADAPTIVE", **OPTS)
    tfn = tsim.expectation_fn_of_dists(obs_t, solver="DP5_SE_ADAPTIVE", **OPTS)
    jval, jgrad = jax.value_and_grad(lambda d: jfn(d)[-1])(jnp.asarray(d0))
    d = torch.tensor(d0, requires_grad=True)
    tval = tfn(d)[-1]
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) < GRAD_TOL
    # the blockaded pairs' gradient is small (~1e-6): held relative to it
    scale = float(np.abs(np.asarray(jgrad)).max())
    assert scale > 1e-7
    np.testing.assert_allclose(to_numpy(d.grad), np.asarray(jgrad), rtol=0, atol=1e-6 * scale)
    jk = jsim.expectation_fn_of_dists(obs_j, solver="KRYLOV_SE", **OPTS)(jnp.asarray(d0))
    with torch.no_grad():
        tk = tsim.expectation_fn_of_dists(obs_t, solver="KRYLOV_SE", **OPTS)(torch.tensor(d0))
    np.testing.assert_allclose(to_numpy(tk), np.asarray(jk), rtol=0, atol=STATE_TOL)


def test_noisy_batch_passes_the_solver_and_options(monkeypatch):
    """A noisy run() solves each run with the requested solver and
    options, as the JAX package's per-run fallback does."""
    calls = []
    real = backend.sesolve

    def spy(*a, **kw):
        calls.append((kw["solver"], kw["krylov_dim"], kw.get("krylov_tol")))
        return real(*a, **kw)

    monkeypatch.setattr(backend, "sesolve", spy)
    _, tsim = emulators(2, duration=40, seed=1)
    tsim.set_config(SimConfig(noise=("doppler",), temperature=50.0, runs=3, samples_per_run=5))
    res = tsim.run(solver="KRYLOV_SE", krylov_dim=4, krylov_tol=1e-10)
    assert calls == [("KRYLOV_SE", 4, 1e-10)] * 3
    assert sum(res.results[-1].values()) == pytest.approx(1.0)

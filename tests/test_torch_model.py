"""PyTorch port vs the JAX package end to end: the bench.py workload
(sine-interpolated 8-parameter amplitude on a rydberg_global channel,
constant detuning, total magnetization, value and gradient) shrunk to
four atoms, through QuantumModel.expectation_fn, TorchEmulator.run and
the solver routing (pulser_diff_torch.model, backend, simresults).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_torch import QuantumModel, TorchEmulator
from pulser_diff_torch.convert import params_from_numpy
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.ops.linalg import _interpolate_sine_np, total_magnetization

from tests.torch_port_cases import emulators, sequence, to_numpy

torch.set_num_threads(1)

N_ATOMS, DURATION, N_PARAMS, SAMPLING_RATE = 4, 120, 8, 0.25
P0 = np.linspace(1.0, 3.0, N_PARAMS)
M = _interpolate_sine_np(N_PARAMS, DURATION)

# f64 on both sides with the same grid and tableau
F64_TOL = 1e-10
# the fused f32 path on both sides: the plain versions repeat the
# kernels' compensated arithmetic, so value and gradient differ only by
# the f32 rounding of sums taken in another order (observed ~4e-9 here,
# against ~2e-7 / ~7e-7 between either fused path and f64)
FUSED_TOL = 1e-7
# the BASELINE.md bars of the fused f32 path against f64
VALUE_BAR, GRAD_BAR = 1e-6, 1e-5


def _bench_sequence(core):
    reg = core.Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(N_ATOMS)], prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    v = seq.declare_variable("amp_samples", size=DURATION)
    seq.add(core.Pulse(core.CustomWaveform(v, duration=DURATION),
                       core.ConstantWaveform(DURATION, -2.0), 0.0), "ryd")
    return seq


@functools.lru_cache(maxsize=None)
def _jax_value_grad(solver="DP5_SE", fused=None, ckpt=None):
    kw = {"solver": solver}
    for name, val in (("fused", fused), ("ckpt", ckpt)):
        if val is not None:
            kw[name] = val
    Mj = jnp.asarray(M)
    model = JModel(_bench_sequence(jcore), {"amp_samples": ((jnp.asarray(P0),), lambda x: Mj @ x)},
                   sampling_rate=SAMPLING_RATE, evaluation_times="Minimal", **kw)
    f = model.expectation_fn(j_total_mag(N_ATOMS, dense=False))
    v, g = jax.value_and_grad(lambda p: f({"amp_samples_0": p})[1][-1])(jnp.asarray(P0))
    return float(v), np.asarray(g), model


def _port_model(**kw):
    Mt = torch.as_tensor(M)
    return QuantumModel(_bench_sequence(tcore), {"amp_samples": ((P0,), lambda x: Mt @ x)},
                        sampling_rate=SAMPLING_RATE, evaluation_times="Minimal",
                        device="cpu", **kw)


def _port_value_grad(model, params=None):
    params = params or {"amp_samples_0": torch.tensor(P0, requires_grad=True)}
    _, vals = model.expectation_fn()(params)
    vals[-1].backward()
    return float(vals[-1].detach()), to_numpy(params["amp_samples_0"].grad)


def test_bench_workload_f64_matches_jax():
    jv, jg, jmodel = _jax_value_grad(fused=False)
    model = _port_model(fused=False)
    assert model._default_substeps() == jmodel._default_substeps()
    params = params_from_numpy(jmodel.params, device="cpu", requires_grad=True)
    before = dict(tfe.LAUNCHES)
    tv, tg = _port_value_grad(model, params)
    assert tfe.LAUNCHES == before
    assert abs(tv - jv) < F64_TOL
    np.testing.assert_allclose(tg, jg, rtol=0, atol=F64_TOL)


def test_bench_workload_fused_matches_pallas_and_f64():
    """DP5_PALLAS on the CPU runs the kernels' plain versions: held
    against JAX DP5_PALLAS in interpret mode at f32 roundoff, and against
    the f64 path within the BASELINE bars."""
    jv, jg, _ = _jax_value_grad(solver="DP5_PALLAS")
    jv64, jg64, _ = _jax_value_grad(fused=False)
    tv, tg = _port_value_grad(_port_model(solver="DP5_PALLAS"))
    assert abs(tv - jv) < FUSED_TOL
    np.testing.assert_allclose(tg, jg, rtol=0, atol=FUSED_TOL)
    assert abs(tv - jv64) < VALUE_BAR
    np.testing.assert_allclose(tg, jg64, rtol=0, atol=GRAD_BAR)


def test_quantum_model_is_a_module():
    """The module's parameters carry the gradient of its expectation (the
    forward call returns the states, as the JAX package's does)."""
    model = _port_model(fused=False)
    assert [n for n, _ in model.named_parameters()] == ["params.amp_samples_0"]
    times, states = model()
    assert states.shape == (2, 2**N_ATOMS, 1)
    _, vals = model.expectation()
    vals.re[-1].backward()
    _, g = _port_value_grad(_port_model(fused=False))
    np.testing.assert_allclose(to_numpy(model.params["amp_samples_0"].grad), g, rtol=0, atol=0)
    np.testing.assert_array_equal(times, [0.0, DURATION / 1000])


@pytest.mark.parametrize("eval_times", ["Full", 0.5])
def test_run_expectations_match_jax(eval_times):
    """run() on the CPU routes DP5_SE to the f64 stepper, as the JAX
    package does on its CPU backend, and its results match."""
    jsim, tsim = emulators(3, duration=80, seed=4, evaluation_times=eval_times)
    jres = jsim.run()
    before = dict(tfe.LAUNCHES)
    tres = tsim.run()
    assert tfe.LAUNCHES == before
    assert len(tres) == len(jres.states.re)
    np.testing.assert_allclose(to_numpy(tres.states.re), np.asarray(jres.states.re),
                               rtol=0, atol=F64_TOL)
    for dense in (True, False):
        (je,) = jres.expect([j_total_mag(3, dense=dense)])
        (te,) = tres.expect([total_magnetization(3, dense=dense, device="cpu")])
        np.testing.assert_allclose(to_numpy(te.re), np.asarray(je.re), rtol=0, atol=F64_TOL)


def _spy(monkeypatch, name):
    """Count the calls of ``tfe.<name>`` (the CPU runs plain versions, which
    the launch counters do not count)."""
    calls = []
    real = getattr(tfe, name)
    monkeypatch.setattr(tfe, name, lambda *a, **k: calls.append(name) or real(*a, **k))
    return calls


def test_fused_run_and_routing(monkeypatch):
    """DP5_PALLAS forces the fused path on the CPU (plain versions), on
    K1/K2 below dim 2^16 and on the checkpointed K4/K5 from there, as the
    JAX package routes it; ckpt overrides; fused=False and the default
    keep the stepper; unknown options raise."""
    _, tsim = emulators(2, duration=60, seed=6, evaluation_times="Full")
    f64 = tsim.run(fused=False).states
    fwd, fwd_ckpt = _spy(monkeypatch, "fused_fwd"), _spy(monkeypatch, "fused_fwd_ckpt")
    fused = tsim.run(solver="DP5_PALLAS").states
    assert fused.re.dtype == torch.float32 and fused.shape == f64.shape
    assert float((fused.re.double() - f64.re).abs().max()) < VALUE_BAR
    assert (len(fwd), len(fwd_ckpt)) == (1, 0)
    # ckpt=False keeps K1/K2 at small dim; ckpt=True takes K4/K5, same states
    tsim.run(solver="DP5_PALLAS", ckpt=False)
    assert (len(fwd), len(fwd_ckpt)) == (2, 0)
    ck = tsim.run(solver="DP5_PALLAS", ckpt=True).states
    assert (len(fwd), len(fwd_ckpt)) == (2, 1)
    np.testing.assert_array_equal(to_numpy(ck.re), to_numpy(fused.re))
    np.testing.assert_array_equal(to_numpy(tsim.run().states.re), to_numpy(f64.re))
    # 16 atoms: dim 2^16, where the JAX package takes the checkpointed kernels
    big = TorchEmulator.from_sequence(sequence(tcore, 16, duration=8), sampling_rate=0.5,
                                      device="cpu")
    out = big.run(solver="DP5_PALLAS", substeps=1).states
    assert (len(fwd), len(fwd_ckpt)) == (2, 2)
    assert out.shape[1:] == (2**16, 1) and bool(torch.isfinite(out.re).all())
    with pytest.raises(TypeError, match="Unknown run"):
        tsim.run(nsteps=100)
    with pytest.raises(TypeError, match="Sequence instance"):
        TorchEmulator.from_sequence(sequence(jcore, 2), device="cpu")


def _spy_kron(monkeypatch, name):
    """Record the number of kron pairs in the data of each ``tfe.<name>``
    call."""
    calls = []
    real = getattr(tfe, name)

    def spy(data, *a, **k):
        calls.append(tfe._n_kron(data))
        return real(data, *a, **k)

    monkeypatch.setattr(tfe, name, spy)
    return calls


@pytest.mark.parametrize("ckpt", [None, True])
def test_xy_fused_routing(monkeypatch, ckpt):
    """An XY sequence with DP5_PALLAS at small dim reaches the K1/K2
    wrappers with its kron pairs (K > 0), value and distance gradient
    alike; ckpt=True takes K4/K5 instead; DP5_SE on the CPU stays on the
    f64 stepper."""
    from tests.torch_port_cases import xy_emulators

    _, tsim = xy_emulators(3, duration=40, seed=8, field=(1.0, 1.0, 0.0))
    names = ("fused_fwd", "fused_bwd", "fused_fwd_ckpt", "fused_bwd_ckpt")
    calls = {n: _spy_kron(monkeypatch, n) for n in names}
    opts = {} if ckpt is None else {"ckpt": ckpt}
    d = torch.tensor([8.5, 16.2, 8.3], dtype=torch.float64, requires_grad=True)
    fn = tsim.expectation_fn_of_dists(total_magnetization(3, device="cpu"), solver="DP5_PALLAS", **opts)
    fn(d)[-1].backward()
    assert bool(torch.isfinite(d.grad).all()) and float(d.grad.abs().max()) > 0
    used = ("fused_fwd_ckpt", "fused_bwd_ckpt") if ckpt else ("fused_fwd", "fused_bwd")
    assert {n: len(c) for n, c in calls.items()} == {n: int(n in used) for n in names}
    assert all(k == 2 for n in used for k in calls[n])  # within-column + one cross term
    tsim.run(solver="DP5_PALLAS", **opts)
    assert len(calls[used[0]]) == 2
    tsim.run()
    assert len(calls[used[0]]) == 2 and sum(len(c) for c in calls.values()) == 3

"""PyTorch port vs the JAX package: the signatures of ``QuantumModel`` and
``TorchEmulator.run`` (pulser_diff_torch.model, backend).

The port takes the JAX package's parameters in its order (constraints and
stochastic noise included), raises on unknown options, warns on
``time_grad`` / ``dist_grad`` as the JAX package warns, and gives
``forward()`` (states) and ``expectation()`` (complex values) the JAX
package's returns.  Four atoms of the bench.py workload, on the CPU, on
the f64 stepper on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_torch import QuantumModel, SimConfig
from pulser_diff_torch.ops.linalg import total_magnetization

from tests.test_torch_model import M, N_ATOMS, P0, SAMPLING_RATE, _bench_sequence
from tests.torch_port_cases import emulators, to_numpy

torch.set_num_threads(1)

# f64 on both sides, the same grid and tableau: states and values agree to
# f64 roundoff over ~120 steps
F64_TOL = 1e-12


def _jax_model(*args, **kw):
    Mj = jnp.asarray(M)
    return JModel(_bench_sequence(jcore), {"amp_samples": ((jnp.asarray(P0),), lambda x: Mj @ x)},
                  *args, **kw)


def _port_model(*args, **kw):
    Mt = torch.as_tensor(M)
    return QuantumModel(_bench_sequence(tcore), {"amp_samples": ((P0,), lambda x: Mt @ x)},
                        *args, device="cpu", **kw)


# JAX's order after the trainable values: constraints, sampling_rate,
# solver, initial_state, noise_config, time_grad, dist_grad, evaluation_times
POSITIONAL = (None, SAMPLING_RATE, "DP5_SE", None, None, False, False, 0.5)


def test_positional_order_matches_jax():
    jm, tm = _jax_model(*POSITIONAL), _port_model(*POSITIONAL)
    for name in ("constraints", "sampling_rate", "solver", "initial_state", "noise_config",
                 "time_grad", "dist_grad", "evaluation_times", "options"):
        assert getattr(tm, name) == getattr(jm, name), name
    jt, js = jm.forward()
    tt, ts = tm.forward()
    np.testing.assert_allclose(to_numpy(tt), np.asarray(jt), rtol=0, atol=0)
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=F64_TOL)


def test_noise_and_constraints_raise_naming_the_queue():
    """Stochastic noise and constraints are taken, as the JAX package takes
    them: the constraints clamp as JAX's check_constraints clamps, and the
    noisy model's Hamiltonian is one drawn, all-local realization."""
    cons = {"amp_samples_0": {"min": 1.5, "max": 2.5}}
    jm, tm = _jax_model(constraints=cons), _port_model(constraints=cons)
    assert tm.constraints == jm.constraints == cons
    jm.check_constraints()
    tm.check_constraints()
    np.testing.assert_array_equal(to_numpy(tm.params["amp_samples_0"]),
                                  np.asarray(jm.params["amp_samples_0"]))
    noisy = _port_model(noise_config=SimConfig(noise=("doppler",)))
    h = noisy._make_emulator(dict(noisy.params))._hamiltonian._ham_data
    assert (h.row_parts.shape[0], h.col_parts.shape[0]) == (2 * (N_ATOMS // 2),) * 2
    # the noiseless defaults are accepted
    _port_model(constraints={}, noise_config=SimConfig())


def test_unknown_options_raise():
    """The options run() takes are accepted (remat and n_segments among
    them); the reference-era ``nsteps``, which the JAX package rejects,
    and misspellings raise instead of being ignored."""
    _port_model(fused=False, ckpt=None, remat=True, n_segments=2, substeps=1)
    for bad in ({"nsteps": 100}, {"n_segment": 2}):
        with pytest.raises(TypeError, match="Unknown QuantumModel option"):
            _port_model(**bad)


@pytest.mark.parametrize("flag", ["time_grad", "dist_grad"])
def test_flags_warn_as_jax(flag):
    jm, tm = _jax_model(**{flag: True}), _port_model(**{flag: True})
    with pytest.warns(UserWarning, match=flag):
        jm.forward()
    with pytest.warns(UserWarning, match=flag):
        _, states = tm.forward()
    assert states.shape[1:] == (2**N_ATOMS, 1)


@pytest.mark.parametrize("eval_times", ["Full", "Minimal"])
def test_forward_returns_states_as_jax(eval_times):
    jt, js = _jax_model(evaluation_times=eval_times).forward()
    tm = _port_model(evaluation_times=eval_times)
    tt, ts = tm()
    assert ts.shape == tuple(js.re.shape)
    np.testing.assert_array_equal(to_numpy(tt), np.asarray(jt))
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("dense", [False, True])
def test_expectation_is_complex_as_jax(dense):
    jm, tm = _jax_model(evaluation_times="Full"), _port_model(evaluation_times="Full")
    jobs = None if not dense else j_total_mag(N_ATOMS, dense=True)
    tobs = None if not dense else total_magnetization(N_ATOMS, dense=True, device="cpu")
    jt, jv = jm.expectation(jobs)
    tt, tv = tm.expectation(tobs)
    np.testing.assert_array_equal(to_numpy(tt), np.asarray(jt))
    np.testing.assert_allclose(to_numpy(tv.re), np.asarray(jv.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(tv.im), np.asarray(jv.im), rtol=0, atol=F64_TOL)
    # the real part is the functional path's value
    _, fv = tm.expectation_fn(tobs)(dict(tm.params))
    np.testing.assert_allclose(to_numpy(tv.re), to_numpy(fv), rtol=0, atol=F64_TOL)


def test_run_dist_grad_fills_dist_dict_as_jax():
    """run(dist_grad=True), the call tests/test_backend.py makes on the JAX
    package: both warn and fill dist_dict with the pair distances."""
    jsim, tsim = emulators(3, duration=60, seed=2)
    assert tsim.dist_dict == {}
    with pytest.warns(UserWarning, match="dist_grad"):
        jsim.run(dist_grad=True, solver="DP5_SE")
    with pytest.warns(UserWarning, match="dist_grad"):
        tsim.run(dist_grad=True, solver="DP5_SE")
    assert list(tsim.dist_dict) == list(jsim.dist_dict)
    for k, v in jsim.dist_dict.items():
        assert abs(float(tsim.dist_dict[k]) - float(v)) < F64_TOL
    # a positional flag is time_grad, as in JAX
    with pytest.warns(UserWarning, match="time_grad"):
        res = tsim.run(True)
    assert len(res) == len(jsim.run().states.re)

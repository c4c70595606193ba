"""PyTorch port vs the JAX package: export and reload of value+grad steps on
the Lindblad forms, through evaluation times, and on the Krylov and
adaptive steppers (pulser_diff_torch.utils.export; the steppers' loop as
the custom ops ``pulser_diff_torch::stepper_states`` / ``_bwd``,
solvers/stepper_op.py).

Each step is exported, reloaded and held against the port's eager step
(the value bit for bit, the gradient at 1e-12 in f64) and against the JAX
package's jitted step on the same input: ``mesolve``'s three forms at 200
ns with the dephasing rate's gradient, the f32 master equation through a
model with Lindblad noise, the evaluation-time gradient of
``expectation_fn_of_times``, and ``KRYLOV_SE`` / ``KRYLOV_SE_F32`` /
``DP5_SE_ADAPTIVE``.  The Krylov and adaptive steppers run at 20 ns, a
pulse short enough for the Krylov steppers' CPU time (their eager step is
the slowest of the stepper routes); the graph does not depend on the steps
(test_torch_export_steppers.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
import pulser_diff_tpu.core as jcore
from pulser_diff_torch import QuantumModel, SimConfig, TorchEmulator
from pulser_diff_torch.ops import total_magnetization
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_mag

from tests.test_torch_derivatives import TOL as TIME_TOL
from tests.test_torch_derivatives import _obs, _sims
from tests.test_torch_export import F64_TOL, _jax_step, _port_step, _roundtrip
from tests.test_torch_export_steppers import STEPPER_NS, STEPPER_OPS, _assert_close
from tests.test_torch_f32 import GRAD_REL_TOL
from tests.test_torch_lindblad import MODEL_NOISE, _model_sequence
from tests.test_torch_mesolve import F32_TOL
from tests.torch_port_cases import sequence

torch.set_num_threads(1)

# the dephasing rate whose gradient the Lindblad steps take
RATE = 0.1
# the Krylov and adaptive steppers' pulse (see the module docstring)
KRYLOV_NS = 20


def _rate_step(duration: int, form: str, substeps: int):
    """The 2-atom dephasing model's value+grad step in the rate: the last
    total magnetization of ``run()`` on ``mesolve``'s ``form``."""
    obs = total_magnetization(2, device="cpu")

    def step(p):
        r = p["rate"].detach().requires_grad_(True)
        sim = TorchEmulator.from_sequence(sequence(tcore, 2, duration), config=SimConfig(
            noise="dephasing", dephasing_rate=r), evaluation_times="Minimal", device="cpu")
        val = sim.run(me_form=form, substeps=substeps).expect([obs])[0].re[-1]
        (g,) = torch.autograd.grad(val, [r])
        return val.detach(), {"rate": g.detach()}

    return step, {"rate": torch.tensor(RATE, dtype=torch.float64)}


def _jax_rate_step(duration: int, form: str, substeps: int):
    def f(r):
        sim = TpuEmulator.from_sequence(sequence(jcore, 2, duration), config=JSimConfig(
            noise="dephasing", dephasing_rate=r), evaluation_times="Minimal")
        return sim.run(me_form=form, substeps=substeps).expect([j_total_mag(2)])[0].re[-1]

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(RATE))
    return float(v), float(g)


@pytest.mark.parametrize("form", ["superop", "dense", "factored"])
def test_export_lindblad_rate_step(tmp_path, form):
    """A 2-atom DP5_ME step at 200 ns on each form of the right-hand side,
    the dephasing rate trainable (the collapse operators are inputs of the
    op): the reloaded step equals the eager step (the value bit for bit,
    the rate's gradient at 1e-12) and JAX's jitted step at 1e-12."""
    sim = TorchEmulator.from_sequence(sequence(tcore, 2, STEPPER_NS), config=SimConfig(
        noise="dephasing", dephasing_rate=RATE), evaluation_times="Minimal", device="cpu")
    substeps = sim._auto_substeps({})
    step, p0 = _rate_step(STEPPER_NS, form, substeps)
    _, meta, got = _roundtrip(tmp_path, form, step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    _assert_close(got, step(p0), F64_TOL)
    jv, jg = _jax_rate_step(STEPPER_NS, form, substeps)
    assert abs(float(got[0]) - jv) < F64_TOL
    assert abs(float(got[1]["rate"]) - jg) < F64_TOL
    assert abs(jg) > 1e-4


def test_export_lindblad_f32_model_step(tmp_path):
    """DP5_ME_F32 through a QuantumModel with Lindblad noise (the dense
    form at 2 atoms, its omega gradient): the reloaded value equals the
    eager value bit for bit, the gradient within tests/test_torch_f32.py's
    relative tolerance of the eager one, and both within
    tests/test_torch_mesolve.py's f32 tolerance of JAX's."""
    model = QuantumModel(_model_sequence(tcore, "ising"), {"omega": 1.7}, solver="DP5_ME_F32",
                         noise_config=SimConfig(**MODEL_NOISE["ising"]), me_form="dense",
                         evaluation_times="Minimal", device="cpu")
    exp_fn = model.expectation_fn(total_magnetization(2, device="cpu"))

    def step(p):
        om = p["omega"].detach().requires_grad_(True)
        val = exp_fn({"omega": om})[1][-1]
        (g,) = torch.autograd.grad(val, [om])
        return val.detach(), {"omega": g.detach()}

    p0 = {"omega": torch.tensor(1.7, dtype=torch.float64)}
    _, meta, got = _roundtrip(tmp_path, "me32", step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    _assert_close(got, step(p0), GRAD_REL_TOL, rel=True)
    jm = JModel(_model_sequence(jcore, "ising"), {"omega": jnp.asarray(1.7)},
                solver="DP5_ME_F32", noise_config=JSimConfig(**MODEL_NOISE["ising"]),
                me_form="dense", evaluation_times="Minimal")
    jfn = jm.expectation_fn(j_total_mag(2))
    jv, jg = jax.jit(jax.value_and_grad(lambda om: jfn({"omega": om})[1][-1].real))(
        jnp.asarray(1.7))
    assert abs(float(got[0]) - float(jv)) < F32_TOL
    assert abs(float(got[1]["omega"]) - float(jg)) < F32_TOL * 10


def test_export_eval_time_gradient(tmp_path):
    """``expectation_fn_of_times`` (the f64 stepper on a grid whose times
    carry their gradient): a step returning the trace and the gradient of
    a weighted sum of it in the evaluation times exports (the grid's times
    are an input of the op), and reloads equal to the eager step (the
    trace bit for bit, the time gradient at 1e-12) and to JAX's at the
    derivative tests' 1e-10."""
    jsim, tsim = _sims(evaluation_times=[0.05, 0.1234, 0.2])
    tfn = tsim.expectation_fn_of_times(torch.as_tensor(_obs(2)))
    t0 = torch.as_tensor(tsim.evaluation_times, dtype=torch.float64)
    w = torch.linspace(1.0, 2.0, t0.shape[0], dtype=torch.float64)

    def step(p):
        times = p["times"].detach().requires_grad_(True)
        trace = tfn(times)
        (g,) = torch.autograd.grad((trace * w).sum(), [times])
        return trace.detach(), {"times": g.detach()}

    p0 = {"times": t0}
    _, meta, got = _roundtrip(tmp_path, "times", step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    _assert_close(got, step(p0), F64_TOL)
    jfn = jsim.expectation_fn_of_times(jnp.asarray(_obs(2)))
    jw = jnp.asarray(w.numpy())
    jt = jnp.asarray(jsim.evaluation_times)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jfn(jt)), rtol=0, atol=TIME_TOL)
    jg = jax.grad(lambda t: (jfn(t) * jw).sum())(jt)
    np.testing.assert_allclose(got[1]["times"].numpy(), np.asarray(jg), rtol=0, atol=TIME_TOL)
    assert float(got[1]["times"].abs().max()) > 1e-3


# solver -> (the gradient's tolerance against the eager step, relative?,
# the tolerance against JAX's step, or None where the f32 Krylov gap is
# tests/test_torch_krylov.py's to hold)
KRYLOV_CASES = {
    "KRYLOV_SE": (F64_TOL, False, F64_TOL),
    "KRYLOV_SE_F32": (GRAD_REL_TOL, True, None),
    "DP5_SE_ADAPTIVE": (F64_TOL, False, F64_TOL),
}


@pytest.mark.parametrize("solver", list(KRYLOV_CASES))
@pytest.mark.parametrize("xy", [False, True], ids=["ising", "xy"])
def test_export_krylov_and_adaptive(tmp_path, solver, xy):
    """The Krylov and adaptive steppers, whose steps are autograd
    Functions of their own (taken through torch.func.vjp inside the
    adjoint op), with q1's coordinates trainable in XY mode: the reloaded
    step equals the eager step (the value bit for bit) and, in f64, JAX's
    jitted step at 1e-12."""
    eager_tol, rel, jax_tol = KRYLOV_CASES[solver]
    step, p0 = _port_step(KRYLOV_NS, xy=xy, solver=solver)
    _, meta, got = _roundtrip(tmp_path, "kry", step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    _assert_close(got, step(p0), eager_tol, rel)
    if jax_tol is not None:
        jv, jg = _jax_step(KRYLOV_NS, xy=xy, solver=solver)
        assert abs(float(got[0]) - jv) < jax_tol
        for k, g in jg.items():
            assert float((got[1][k] - torch.tensor(g)).abs().max()) < jax_tol, k

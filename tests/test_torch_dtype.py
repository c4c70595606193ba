"""PyTorch port vs the JAX package: the default dtype
(pulser_diff_torch.config.set_default_dtype / default_dtype, the
counterparts of pulser_diff_tpu/config.py's).

Under ``set_default_dtype(float32)`` both packages build their parameters,
register, samples, Hamiltonian, time grid and states in float32, and their
steppers run in float32.  The JAX side runs in a subprocess, since its
default is a process-wide global; the port's is set and restored around
each case.  Outputs carry the same dtype in both packages, and their
values agree within ``F32_TOL``: the two packages take the same f32 steps
with sums in another order, and differ by a few f32 roundings of values of
order one (observed: 1.2e-7, one f32 ulp at 2, on the run's values; 0 and
1.9e-9 on the model's values and gradient; against a gap of ~4e-7
between either package's f32 and f64 results).
"""

import json

import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
from pulser_diff_torch import TorchEmulator, config
from pulser_diff_torch.model import QuantumModel
from pulser_diff_torch.ops import total_magnetization
from pulser_diff_torch.ops.linalg import _interpolate_sine_np

from tests.conftest import run_isolated

torch.set_num_threads(1)

# f32 on both sides, the same steps in another order of sums
F32_TOL = 1e-6
# bench.py's model cut to 4 atoms and 200 ns
N_ATOMS = 4
DURATION = 200
P0 = np.linspace(1.0, 3.0, 8)

_JAX = """
import json
import jax.numpy as jnp
import numpy as np
from pulser_diff_tpu import config
config.set_default_dtype(jnp.float32)
import jax
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.core import (ConstantWaveform, CustomWaveform, MockDevice, Pulse,
                                  Register, Sequence)
from pulser_diff_tpu.model import QuantumModel
from pulser_diff_tpu.ops import total_magnetization
from pulser_diff_tpu.ops.linalg import _interpolate_sine_np

reg = Register({"q0": jnp.array([-4.0, 0.0]), "q1": jnp.array([4.0, 0.0])})
seq = Sequence(reg, MockDevice)
seq.declare_channel("ryd", "rydberg_global")
seq.add(Pulse.ConstantPulse(100, 1.5, -0.5, 0.2), "ryd")
res = TpuEmulator.from_sequence(seq, evaluation_times=0.2).run()
ev = res.expect([total_magnetization(2)])[0]

n, d = %(n)d, %(d)d
reg = Register.from_coordinates([(10.0 * (i %% 4), 10.0 * (i // 4)) for i in range(n)],
                                prefix="q")
seq = Sequence(reg, MockDevice)
seq.declare_channel("ryd", "rydberg_global")
amp = seq.declare_variable("amp_samples", size=d)
seq.add(Pulse(CustomWaveform(amp, duration=d), ConstantWaveform(d, -2.0), 0.0), "ryd")
M = jnp.asarray(_interpolate_sine_np(8, d))
model = QuantumModel(seq, {"amp_samples": ((jnp.asarray(%(p0)s),), lambda v: M @ v)},
                     sampling_rate=0.25, evaluation_times="Minimal", fused=False)
exp_fn = model.expectation_fn(total_magnetization(n, dense=False))
p = model.params["amp_samples_0"]


@jax.jit
def step(q):
    (times, vals), vjp = jax.vjp(lambda r: exp_fn({"amp_samples_0": r}), q)
    (g,) = vjp((jnp.zeros_like(times), jnp.zeros_like(vals).at[-1].set(1.0)))
    return times, vals, g


times, vals, g = step(p)
print(json.dumps({
    "run": {"re": np.asarray(ev.re).tolist(), "dtype": str(ev.re.dtype),
            "state_dtype": str(res.states.re.dtype)},
    "model": {"param_dtype": str(p.dtype), "vals": np.asarray(vals).tolist(),
              "vals_dtype": str(vals.dtype), "grad": np.asarray(g).tolist(),
              "grad_dtype": str(g.dtype), "times_dtype": str(times.dtype)},
}))
"""


@pytest.fixture(scope="module")
def jax_f32():
    code = _JAX % {"n": N_ATOMS, "d": DURATION, "p0": repr(P0.tolist())}
    return json.loads(run_isolated(code).strip().splitlines()[-1])


@pytest.fixture
def f32_default():
    """The port's default dtype float32 inside the test, float64 after."""
    config.set_default_dtype(torch.float32)
    try:
        yield
    finally:
        config.set_default_dtype(torch.float64)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def test_run_matches_jax_in_f32(jax_f32, f32_default):
    """test_plotting_smoke's 2-atom run(): the expectation values and the
    states are float32 in both packages, and agree within F32_TOL."""
    reg = tcore.Register({"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])})
    seq = tcore.Sequence(reg, tcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(tcore.Pulse.ConstantPulse(100, 1.5, -0.5, 0.2), "ryd")
    res = TorchEmulator.from_sequence(seq, evaluation_times=0.2, device="cpu").run()
    ev = res.expect([total_magnetization(2, device="cpu")])[0]
    want = jax_f32["run"]
    assert _name(ev.re.dtype) == want["dtype"] == "float32"
    assert _name(res.states.re.dtype) == want["state_dtype"] == "float32"
    np.testing.assert_allclose(ev.re.numpy(), want["re"], rtol=0, atol=F32_TOL)


def test_model_value_and_grad_match_jax_in_f32(jax_f32, f32_default):
    """bench.py's model at 4 atoms (8 sine-interpolated amplitude knots,
    the f64 stepper's code, fused=False): the parameters, times, values and
    gradient are float32 in both packages, and agree within F32_TOL.  The
    interpolation matrix stays float64, as the JAX package's numpy matrix
    does, and its product is promoted as jnp promotes it."""
    reg = tcore.Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(N_ATOMS)], prefix="q")
    seq = tcore.Sequence(reg, tcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp = seq.declare_variable("amp_samples", size=DURATION)
    seq.add(tcore.Pulse(tcore.CustomWaveform(amp, duration=DURATION),
                        tcore.ConstantWaveform(DURATION, -2.0), 0.0), "ryd")
    M = torch.as_tensor(_interpolate_sine_np(8, DURATION))
    model = QuantumModel(seq, {"amp_samples": ((P0,), lambda v: M @ v.to(M.dtype))},
                         sampling_rate=0.25, evaluation_times="Minimal", fused=False,
                         device="cpu")
    exp_fn = model.expectation_fn(total_magnetization(N_ATOMS, dense=False, device="cpu"))
    p = model.params["amp_samples_0"].detach().requires_grad_(True)
    times, vals = exp_fn({"amp_samples_0": p})
    (g,) = torch.autograd.grad(vals[-1], [p])
    want = jax_f32["model"]
    assert _name(p.dtype) == want["param_dtype"] == "float32"
    assert _name(vals.dtype) == want["vals_dtype"] == "float32"
    assert _name(g.dtype) == want["grad_dtype"] == "float32"
    assert _name(torch.as_tensor(times).dtype) == want["times_dtype"]
    np.testing.assert_allclose(vals.detach().numpy(), want["vals"], rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(g.numpy(), want["grad"], rtol=0, atol=F32_TOL)
    assert float(g.abs().max()) > 1e-2


def test_default_is_float64_and_bad_dtypes_raise():
    """The default is float64 (again, after the f32 cases); only float32
    and float64 are accepted, as in the JAX package."""
    assert config.default_dtype() is torch.float64
    assert torch.get_default_dtype() is torch.float32  # torch's own is untouched
    for bad in (torch.float16, torch.bfloat16, torch.complex64, "float32", np.float32):
        with pytest.raises(ValueError, match="float32 or float64"):
            config.set_default_dtype(bad)
    assert config.default_dtype() is torch.float64
    config.set_default_dtype(torch.float32)
    try:
        assert config.default_dtype() is torch.float32
        assert total_magnetization(2, device="cpu").re.dtype == torch.float32
    finally:
        config.set_default_dtype(torch.float64)
    assert total_magnetization(2, device="cpu").re.dtype == torch.float64


_JAX_GAP = """
import json, sys
import jax.numpy as jnp
import numpy as np
from pulser_diff_tpu import config
if sys.argv[1] == "f32":
    config.set_default_dtype(jnp.float32)
import jax
from pulser_diff_tpu.core import (ConstantWaveform, CustomWaveform, MockDevice, Pulse,
                                  Register, Sequence)
from pulser_diff_tpu.model import QuantumModel
from pulser_diff_tpu.ops import total_magnetization
from pulser_diff_tpu.ops.linalg import _interpolate_sine_np

n, d = int(sys.argv[2]), 660
reg = Register.from_coordinates([(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n)],
                                prefix="q")
seq = Sequence(reg, MockDevice)
seq.declare_channel("ryd", "rydberg_global")
amp = seq.declare_variable("amp_samples", size=d)
seq.add(Pulse(CustomWaveform(amp, duration=d), ConstantWaveform(d, -2.0), 0.0), "ryd")
M = jnp.asarray(_interpolate_sine_np(8, d))
model = QuantumModel(seq, {"amp_samples": ((jnp.asarray(np.linspace(1.0, 3.0, 8)),),
                                           lambda v: M @ v)},
                     sampling_rate=0.25, evaluation_times="Minimal", solver=sys.argv[3])
exp_fn = model.expectation_fn(total_magnetization(n, dense=False))
v, g = jax.value_and_grad(lambda p: exp_fn({"amp_samples_0": p})[1][-1])(
    model.params["amp_samples_0"])
print(json.dumps({"v": float(v), "g": np.asarray(g, np.float64).tolist()}))
"""


def _port_step(mode: str, n: int, solver: str):
    """bench.py's model at ``n`` atoms on the CPU under the ``mode``
    default dtype: (value, gradient) as float64 numpy."""
    config.set_default_dtype(torch.float32 if mode == "f32" else torch.float64)
    try:
        d = 660
        reg = tcore.Register.from_coordinates(
            [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n)], prefix="q")
        seq = tcore.Sequence(reg, tcore.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        amp = seq.declare_variable("amp_samples", size=d)
        seq.add(tcore.Pulse(tcore.CustomWaveform(amp, duration=d),
                            tcore.ConstantWaveform(d, -2.0), 0.0), "ryd")
        M = torch.as_tensor(_interpolate_sine_np(8, d))
        model = QuantumModel(seq, {"amp_samples": ((np.linspace(1.0, 3.0, 8),),
                                                   lambda v: M @ v.to(M.dtype))},
                             sampling_rate=0.25, evaluation_times="Minimal", solver=solver,
                             device="cpu")
        exp_fn = model.expectation_fn(total_magnetization(n, dense=False, device="cpu"))
        p = model.params["amp_samples_0"].detach().requires_grad_(True)
        vals = exp_fn({"amp_samples_0": p})[1]
        (g,) = torch.autograd.grad(vals[-1], [p])
        return float(vals[-1].detach()), g.double().numpy()
    finally:
        config.set_default_dtype(torch.float64)


def main(atoms=(4, 6, 8), solvers=("DP5_PALLAS", "DP5_SE")) -> None:
    """Print each package's f32-default versus f64-default gap (|dv|,
    max|dg|) on bench.py's model (660 ns, 166 steps) at ``atoms``, on the
    fused route (the Pallas kernels in interpret mode; the port's plain
    versions) and on the stepper.  Run: python -m tests.test_torch_dtype"""
    for solver in solvers:
        for n in atoms:
            jax_out = [json.loads(run_isolated(_JAX_GAP.replace(
                "sys.argv[1]", repr(m)).replace("sys.argv[2]", repr(str(n))).replace(
                "sys.argv[3]", repr(solver))).strip().splitlines()[-1]) for m in ("f64", "f32")]
            port = [_port_step(m, n, solver) for m in ("f64", "f32")]
            jdv = abs(jax_out[0]["v"] - jax_out[1]["v"])
            jdg = float(np.abs(np.subtract(jax_out[0]["g"], jax_out[1]["g"])).max())
            pdv = abs(port[0][0] - port[1][0])
            pdg = float(np.abs(port[0][1] - port[1][1]).max())
            print(f"{solver} {n} atoms: JAX |dv| {jdv:.3e} max|dg| {jdg:.3e}; "
                  f"port |dv| {pdv:.3e} max|dg| {pdg:.3e}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()

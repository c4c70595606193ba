"""PyTorch port vs the JAX package: the training API of ``QuantumModel``
(pulser_diff_torch.model, waveform_funcs).

  - ``constant_waveform``, ``_pad_duration``, ``_t_max`` and the
    duration-optimisation samples against the JAX package's (f64);
  - ``check_constraints`` and ``update_sequence``;
  - ``fit``'s per-epoch losses and final parameters against JAX's ``fit``
    with ``optax.adam`` for plain sequence variables, constraints, pulse
    durations and custom-waveform callables; ``steps_per_call`` against
    per-step training, with ``callback`` once a chunk;
  - ``fit_population``'s losses, final stack and loaded best candidate
    against JAX's.

torch.optim.Adam and optax.adam make the same update (bias-corrected
moments, eps added to sqrt(v_hat)) in another operation order, and both
models solve on the f64 stepper: the losses and parameters agree to
~1e-13 over six epochs, held at 1e-9.  Two atoms, on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import waveform_funcs as jwf
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.model import _pad_duration as j_pad
from pulser_diff_tpu.ops import interpolate_sine as j_interp
from pulser_diff_torch import QuantumModel
from pulser_diff_torch import waveform_funcs as twf
from pulser_diff_torch.model import _pad_duration
from pulser_diff_torch.ops.linalg import _interpolate_sine_np

from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
FIT_TOL = 1e-9
TARGET = -0.3
EPOCHS = 6


def _loss(vals):
    return (vals[-1] - TARGET) ** 2


def _register(core):
    return core.Register.from_coordinates([(-4.0, 0.0), (4.0, 0.0)], prefix="q")


def _param_seq(core):
    """omega and det of one constant pulse, both variables."""
    seq = core.Sequence(_register(core), core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega = seq.declare_variable("omega")
    det = seq.declare_variable("det")
    seq.add(core.Pulse.ConstantPulse(48, omega, det, 0.0), "ryd")
    return seq


def _duration_seq(core):
    """A pulse of variable duration and amplitude, then a fixed one."""
    seq = core.Sequence(_register(core), core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    dur = seq.declare_variable("dur", dtype=int)
    omega = seq.declare_variable("omega")
    seq.add(core.Pulse.ConstantPulse(dur[0], omega[0], -0.4, 0.0), "ryd")
    seq.add(core.Pulse.ConstantPulse(12, 1.1, 0.3, 0.0), "ryd")
    return seq


def _callable_seq(core, duration: int = 48):
    seq = core.Sequence(_register(core), core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp = seq.declare_variable("amp_samples", size=duration)
    seq.add(core.Pulse(core.CustomWaveform(amp, duration=duration),
                       core.ConstantWaveform(duration, -0.5), 0.0), "ryd")
    return seq


# case -> (sequence function, trainable values (numpy), constraints, optimizer lr or None)
CASES = {
    "variables": (_param_seq, {"omega": 1.0, "det": 0.0}, None, 1e-1),
    "constraints": (_param_seq, {"omega": 1.0, "det": 0.0},
                    {"omega": {"min": 0.5, "max": 1.15}, "det": {"min": -0.1, "max": 0.1}}, 1e-1),
    "durations": (_duration_seq, {"dur": np.array([0.04]), "omega": np.array([1.5])}, None, 5e-3),
    "callables": (_callable_seq, {"amp_samples": np.linspace(0.8, 1.6, 5)}, None, None),
}


def _models(case: str, **kw):
    """The case's model in both packages (f64 stepper, sampling rate 0.5)."""
    build, values, constraints, _ = CASES[case]
    if build is _callable_seq:
        mj = jnp.asarray(j_interp(5, 48))
        mt = torch.as_tensor(_interpolate_sine_np(5, 48))
        jvals = {"amp_samples": ((jnp.asarray(values["amp_samples"]),), lambda v: mj @ v)}
        tvals = {"amp_samples": ((values["amp_samples"],), lambda v: mt @ v)}
    else:
        jvals = {k: jnp.asarray(v) for k, v in values.items()}
        tvals = dict(values)
    jm = JModel(build(jcore), jvals, constraints=constraints, sampling_rate=0.5, **kw)
    tm = QuantumModel(build(tcore), tvals, constraints=constraints, sampling_rate=0.5,
                      device="cpu", **kw)
    return jm, tm


def _optimizers(case: str):
    lr = CASES[case][3]
    if lr is None:  # the defaults: optax.adam(1e-2) and torch.optim.Adam at 1e-2
        return None, None
    return optax.adam(lr), (lambda ps: torch.optim.Adam(ps, lr=lr))


def _assert_params(tm, jm, tol):
    assert set(tm.params) == set(jm.params)
    for k, v in jm.params.items():
        np.testing.assert_allclose(to_numpy(tm.params[k]), np.asarray(v), rtol=0, atol=tol,
                                   err_msg=k)


def test_constant_waveform_matches_jax():
    t = np.arange(300, dtype=np.float64)
    for ti, tf, value, steep in ((0, 0.21, 1.7, 1.0), (0.05, 0.2, -0.6, 0.5),
                                 (np.array([0.05]), np.array([0.17]), np.array([2.0]), 2.0)):
        want = jwf.constant_waveform(
            ti if isinstance(ti, int) else jnp.asarray(ti), jnp.asarray(tf),
            jnp.asarray(value), steep)(jnp.asarray(t))
        f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
        got = twf.constant_waveform(ti if isinstance(ti, int) else f64(ti), f64(tf), f64(value),
                                    steep)(f64(t))
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64_TOL)
    # a sequence variable as the end time: a deferred Expr in both packages
    jvar, tvar = (_param_seq(c).declared_variables["omega"] for c in (jcore, tcore))
    jexpr = jwf.constant_waveform(0, jvar, 1.3)(jnp.asarray(t))
    texpr = twf.constant_waveform(0, tvar, 1.3)(torch.as_tensor(t, dtype=torch.float64))
    assert texpr.variables() == {"omega"}
    np.testing.assert_allclose(to_numpy(texpr.evaluate({"omega": 0.12})),
                               np.asarray(jexpr.evaluate({"omega": 0.12})), rtol=0, atol=F64_TOL)


def test_duration_grid_and_samples_match_jax():
    """_pad_duration, the abstract representation, _t_max, the total
    duration and the synthesised samples (amp, det, phase), and the
    emulator's grid built from them."""
    for n in (1, 63, 64, 65, 245, 1000):
        assert _pad_duration(n) == j_pad(n)
    jm, tm = _models("durations")
    assert tm.optimize_duration and jm.optimize_duration
    assert tm._t_max == jm._t_max == 64  # 40 + 12 + 5 ns, rounded up to 64
    assert tm._get_total_duration(tm.params) == jm._get_total_duration(jm.params) == 57
    assert [sorted(r) for r in tm.seq_abs_repr] == [sorted(r) for r in jm.seq_abs_repr]
    assert {(p.name, p.trainable, p.type) for p in tm.seq_params.values() if p.trainable} == {
        (p.name, p.trainable, p.type) for p in jm.seq_params.values() if p.trainable}
    assert tm.built_seq is None and jm.built_seq is None
    params = {"dur": np.array([0.043]), "omega": np.array([1.2])}
    want = jm._opt_duration_samples({k: jnp.asarray(v) for k, v in params.items()})
    got = tm._opt_duration_samples({k: torch.as_tensor(v) for k, v in params.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0, atol=F64_TOL)
    jsim = jm._make_emulator(jm.params)
    tsim = tm._make_emulator(dict(tm.params))
    np.testing.assert_array_equal(tsim._eval_times_array, jsim._eval_times_array)
    np.testing.assert_array_equal(tsim.sampling_times, np.asarray(jsim.sampling_times))
    # a duration past the grid grows it in update_sequence
    with torch.no_grad():
        tm.params["dur"].fill_(0.1)
    jm.params["dur"] = jnp.asarray([0.1])
    tm.update_sequence()
    jm.update_sequence()
    assert tm._t_max == jm._t_max == 128
    # a non-constant waveform cannot take a variable duration
    seq = tcore.Sequence(_register(tcore), tcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    dur = seq.declare_variable("dur", dtype=int)
    seq.add(tcore.Pulse(tcore.ConstantWaveform(dur[0], 1.0),
                        tcore.CustomWaveform(np.zeros(50)), 0.0), "ryd")
    with pytest.raises(NotImplementedError, match="detuning waveform type CustomWaveform"):
        QuantumModel(seq, {"dur": np.array([0.05])}, device="cpu")


def test_check_constraints_and_missing_values_match_jax():
    jm, tm = _models("constraints")
    for m in (jm, tm):
        m.params["omega"] = jnp.asarray(5.0) if m is jm else m.params["omega"]
    with torch.no_grad():
        tm.params["omega"].fill_(5.0)
        tm.params["det"].fill_(-0.7)
    jm.params["det"] = jnp.asarray(-0.7)
    jm.check_constraints()
    tm.check_constraints()
    _assert_params(tm, jm, 0.0)
    assert tm.params["omega"].item() == 1.15 and tm.params["det"].item() == -0.1
    with pytest.raises(ValueError, match="No value for trainable sequence parameter det"):
        QuantumModel(_param_seq(tcore), {"omega": 1.0}, device="cpu")
    with pytest.raises(ValueError, match="No value for trainable sequence parameter det"):
        JModel(_param_seq(jcore), {"omega": jnp.asarray(1.0)})


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax(case):
    """Per-epoch losses and final parameters of fit (10 epochs), and the
    sequence each rebuilds at the end."""
    jm, tm = _models(case)
    jopt, topt = _optimizers(case)
    jl = jm.fit(lambda t, v: _loss(v), epochs=EPOCHS, optimizer=jopt)
    tl = tm.fit(lambda t, v: _loss(v), epochs=EPOCHS, optimizer=topt)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FIT_TOL)
    _assert_params(tm, jm, FIT_TOL)
    assert tl[-1] < tl[0]
    if case == "constraints":
        assert float(tm.params["omega"]) == 1.15  # the bound was reached and held
    if case == "durations":
        assert abs(float(tm.params["dur"][0]) - 0.04) > 1e-3
    else:  # the rebuilt sequence carries the trained values
        _, want = jm.expectation()
        _, got = tm.expectation()
        np.testing.assert_allclose(to_numpy(got.re), np.asarray(want.re), rtol=0, atol=FIT_TOL)


def test_fit_takes_a_built_optimizer_and_steps_per_call():
    """An optimizer built over parameters() gives the factory's losses;
    steps_per_call = 2 over 5 epochs gives the per-step losses, with the
    callback at epochs 1, 3 and 4."""
    _, a = _models("variables")
    _, b = _models("variables")
    _, c = _models("variables")
    la = a.fit(lambda t, v: _loss(v), epochs=5)
    lb = b.fit(lambda t, v: _loss(v), epochs=5,
               optimizer=torch.optim.Adam(b.parameters(), lr=1e-2))
    seen = []
    lc = c.fit(lambda t, v: _loss(v), epochs=5, steps_per_call=2,
               callback=lambda ep, loss, params: seen.append((ep, loss, float(params["omega"]))))
    assert la == lb == lc
    assert [s[0] for s in seen] == [1, 3, 4]
    assert [s[1] for s in seen] == [la[1], la[3], la[4]]
    assert seen[-1][2] == float(c.params["omega"])


def test_fit_population_matches_jax():
    """Losses (one (P,) array an epoch), the final stack and the best-ever
    candidate loaded into the parameters, against JAX's fit_population."""
    jm, tm = _models("variables")
    stack = {"omega": np.array([0.8, 1.2, 1.9]), "det": np.array([0.2, -0.1, -0.6])}
    jl, jfin = jm.fit_population(lambda t, v: _loss(v), {k: jnp.asarray(v) for k, v in stack.items()},
                                 epochs=EPOCHS, optimizer=optax.adam(1e-1))
    tl, tfin = tm.fit_population(lambda t, v: _loss(v), stack, epochs=EPOCHS,
                                 optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-1))
    assert len(tl) == len(jl) == EPOCHS and tl[0].shape == (3,)
    np.testing.assert_allclose(np.stack(tl), np.stack([np.asarray(x) for x in jl]), rtol=0,
                               atol=FIT_TOL)
    for k in stack:
        np.testing.assert_allclose(to_numpy(tfin[k]), np.asarray(jfin[k]), rtol=0, atol=FIT_TOL)
    _assert_params(tm, jm, FIT_TOL)
    # the stack the caller passed is not trained in place
    assert stack["omega"].tolist() == [0.8, 1.2, 1.9]

"""PyTorch port vs the JAX package: the waveform family, PCHIP
interpolation and the deferred-expression operations
(pulser_diff_torch.core.waveforms, core.variables, waveform_funcs).

Both sides compute in f64 with the same formulas, so samples agree to
1e-12 and gradients (autograd against jax.grad) to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.core import waveforms as jwf
from pulser_diff_torch.core import waveforms as twf

from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
GRAD_TOL = 1e-10

VALUES = [0.3, 1.7, 1.1, -0.4, 0.9]
TIMES = [0.0, 0.15, 0.5, 0.8, 1.0]

# (name, make(core)) for every waveform kind
WAVEFORMS = {
    "constant": lambda c: c.ConstantWaveform(37, 1.25),
    "ramp": lambda c: c.RampWaveform(53, -1.5, 2.25),
    "ramp_1": lambda c: c.RampWaveform(1, 0.5, 2.0),
    "blackman": lambda c: c.BlackmanWaveform(120, np.pi),
    "blackman_odd": lambda c: c.BlackmanWaveform(77, -0.8),
    "kaiser": lambda c: c.KaiserWaveform(90, 1.3),
    "kaiser_beta": lambda c: c.KaiserWaveform(61, 2.0, beta=6.0),
    "custom": lambda c: c.CustomWaveform(np.sin(np.arange(40) / 7.0)),
    "interpolated": lambda c: c.InterpolatedWaveform(100, VALUES),
    "interpolated_times": lambda c: c.InterpolatedWaveform(83, VALUES, TIMES),
    "interpolated_2": lambda c: c.InterpolatedWaveform(30, [0.2, 1.0]),
    "composite": lambda c: c.CompositeWaveform(
        c.BlackmanWaveform(40, 1.0), c.RampWaveform(20, 0.5, -0.5), c.ConstantWaveform(10, 2.0)),
}


@pytest.mark.parametrize("name", sorted(WAVEFORMS))
def test_waveform_samples_match_jax(name):
    jw, tw = WAVEFORMS[name](jcore), WAVEFORMS[name](tcore)
    assert tw.duration == jw.duration
    want = np.asarray(jw.samples)
    got = to_numpy(tw.samples)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
    for attr in ("first_value", "last_value", "integral"):
        np.testing.assert_allclose(to_numpy(getattr(tw, attr)), np.asarray(getattr(jw, attr)),
                                   rtol=0, atol=F64_TOL, err_msg=attr)
    try:
        jc = jw.change_duration(jw.duration + 9)
    except NotImplementedError:  # ramp, custom and composite waveforms keep theirs
        with pytest.raises(NotImplementedError):
            tw.change_duration(tw.duration + 9)
    else:
        np.testing.assert_allclose(to_numpy(tw.change_duration(tw.duration + 9).samples),
                                   np.asarray(jc.samples), rtol=0, atol=F64_TOL)
    assert tw == WAVEFORMS[name](tcore) and jw == WAVEFORMS[name](jcore)
    assert tw != tcore.ConstantWaveform(tw.duration, 9.0)
    # the output of a channel with a modulation bandwidth
    jch, tch = (c.Rydberg.Global(mod_bandwidth=20.0) for c in (jcore, tcore))
    np.testing.assert_allclose(to_numpy(tw.modulated_samples(tch)),
                               np.asarray(jw.modulated_samples(jch)), rtol=0, atol=F64_TOL)


def test_ramp_slope_and_from_max_val_match_jax():
    assert float(twf.RampWaveform(41, -1.0, 3.0).slope) == pytest.approx(
        float(jwf.RampWaveform(41, -1.0, 3.0).slope), abs=F64_TOL)
    for cls in ("BlackmanWaveform", "KaiserWaveform"):
        for max_val, area in ((2.0, np.pi), (0.7, 0.4), (-1.5, -2.0)):
            jw = getattr(jwf, cls).from_max_val(max_val, area)
            tw = getattr(twf, cls).from_max_val(max_val, area)
            assert tw.duration == jw.duration
            np.testing.assert_allclose(to_numpy(tw.samples), np.asarray(jw.samples), rtol=0,
                                       atol=F64_TOL)
        with pytest.raises(ValueError, match="matching signs"):
            getattr(twf, cls).from_max_val(-1.0, np.pi)


PCHIP_CASES = {
    "one_point": ([0.0], [1.3]),
    "two_points": ([0.0, 5.0], [1.0, -1.0]),
    "monotone": ([0.0, 1.0, 2.5, 4.0, 6.0], [0.0, 0.5, 0.9, 2.0, 2.1]),
    "sign_changes": ([0.0, 1.0, 2.0, 3.5, 5.0, 7.0], [1.0, -1.0, 2.0, 2.0, -0.5, 0.3]),
    "flat_segment": ([0.0, 2.0, 3.0, 5.0], [1.0, 1.0, 3.0, 0.0]),
}


@pytest.mark.parametrize("name", sorted(PCHIP_CASES))
def test_pchip_interpolate_matches_jax(name):
    x, y = PCHIP_CASES[name]
    t = np.linspace(x[0] - 0.5, x[-1] + 0.5, 97)
    want = jwf.pchip_interpolate(jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))
    got = twf.pchip_interpolate(torch.tensor(x, dtype=torch.float64),
                                torch.tensor(y, dtype=torch.float64),
                                torch.tensor(t, dtype=torch.float64))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64_TOL)


GRAD_CASES = {
    "interpolated_values": (lambda c, p: c.InterpolatedWaveform(90, p), VALUES),
    "interpolated_times": (lambda c, p: c.InterpolatedWaveform(70, VALUES, p), TIMES),
    "blackman_area": (lambda c, p: c.BlackmanWaveform(80, p[0]), [1.4]),
    "kaiser_area": (lambda c, p: c.KaiserWaveform(60, p[0]), [0.9]),
    "ramp_ends": (lambda c, p: c.RampWaveform(50, p[0], p[1]), [-0.3, 1.8]),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_waveform_gradients_match_jax(name):
    """The gradient of a weighted sum of the samples in the waveform's
    parameters: autograd against jax.grad."""
    build, p0 = GRAD_CASES[name]
    n = build(jcore, p0).duration
    w = np.cos(np.arange(n) / 5.0)
    jg = jax.grad(lambda p: jnp.sum(build(jcore, p).samples * w))(jnp.asarray(p0))
    p = torch.tensor(p0, dtype=torch.float64, requires_grad=True)
    (build(tcore, p).samples * torch.as_tensor(w)).sum().backward()
    assert float(np.abs(np.asarray(jg)).max()) > 1e-6
    np.testing.assert_allclose(to_numpy(p.grad), np.asarray(jg), rtol=0, atol=GRAD_TOL)


def _seq_vars(core):
    seq = core.Sequence(core.Register.from_coordinates([(0.0, 0.0), (5.0, 0.0)]), core.MockDevice)
    return seq.declare_variable("x"), seq.declare_variable("v", size=3)


EXPRS = {
    "add": lambda x, v: x + 1.5,
    "radd": lambda x, v: 2.0 + x,
    "sub": lambda x, v: x - v[1],
    "rsub": lambda x, v: 3.0 - x,
    "mul": lambda x, v: x * v[0],
    "rmul": lambda x, v: 0.5 * x,
    "div": lambda x, v: x / 3.0,
    "rdiv": lambda x, v: 2.0 / x,
    "pow": lambda x, v: x ** 3,
    "neg_abs": lambda x, v: abs(-x + v[2]),
    "tanh": lambda x, v: (x * 2.0).tanh(),
    "sin": lambda x, v: v[1].sin(),
    "cos": lambda x, v: (x + v[0]).cos(),
    "exp": lambda x, v: (-x).exp(),
    "sqrt": lambda x, v: (x * x + 1.0).sqrt(),
    "log": lambda x, v: (x + 2.0).log(),
    "getitem": lambda x, v: (v * 2.0)[2],
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expr_operations_match_jax(name):
    """Each Expr operation, evaluated and differentiated in its variables."""
    fn = EXPRS[name]
    je, te = fn(*_seq_vars(jcore)), fn(*_seq_vars(tcore))
    assert isinstance(te, tcore.Expr)
    assert te.variables() == je.variables()
    x0, v0 = 0.7, np.array([0.4, -1.1, 2.3])
    want = je.evaluate({"x": jnp.asarray(x0), "v": jnp.asarray(v0)})
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    v = torch.tensor(v0, dtype=torch.float64, requires_grad=True)
    got = te.evaluate({"x": x, "v": v})
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64_TOL)
    jgx, jgv = jax.grad(lambda a, b: jnp.sum(je.evaluate({"x": a, "v": b})), argnums=(0, 1))(
        jnp.asarray(x0), jnp.asarray(v0))
    got.sum().backward()
    for g, w in ((x.grad, jgx), (v.grad, jgv)):
        got_g = np.zeros_like(np.asarray(w)) if g is None else to_numpy(g)
        np.testing.assert_allclose(got_g, np.asarray(w), rtol=0, atol=GRAD_TOL)
    from pulser_diff_torch.core.variables import contains_expr

    assert contains_expr(te) and not contains_expr(1.0)


def test_parametrized_waveforms_build_and_differentiate():
    """Variables in every parameter slot (duration included) build into
    the concrete waveforms of JAX's build, and the built samples carry
    the gradient to the values."""
    def build(core, values):
        seq = core.Sequence(core.Register.from_coordinates([(0.0, 0.0), (5.0, 0.0)]),
                            core.MockDevice)
        dur = seq.declare_variable("dur", dtype=int)
        area = seq.declare_variable("area")
        pts = seq.declare_variable("pts", size=4)
        wfs = [core.BlackmanWaveform(dur, area), core.KaiserWaveform(dur, area * 0.5),
               core.RampWaveform(dur, area, -area), core.InterpolatedWaveform(dur, pts),
               core.CompositeWaveform(core.ConstantWaveform(dur, area), core.CustomWaveform(pts,
                                                                                          4))]
        assert all(w.is_parametrized for w in wfs)
        with pytest.raises(ValueError, match="build"):
            wfs[0].samples
        return [w.build(values) for w in wfs]

    jb = build(jcore, {"dur": 33, "area": jnp.asarray(1.2),
                       "pts": jnp.asarray([0.0, 1.0, 0.4, 0.8])})
    area = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    tb = build(tcore, {"dur": 33.2, "area": area,
                       "pts": torch.tensor([0.0, 1.0, 0.4, 0.8], dtype=torch.float64)})
    for jw, tw in zip(jb, tb):
        assert tw.duration == jw.duration
        np.testing.assert_allclose(to_numpy(tw.samples), np.asarray(jw.samples), rtol=0,
                                   atol=F64_TOL)
    sum(w.samples.sum() for w in tb).backward()
    assert area.grad is not None and torch.isfinite(area.grad)


PULSES = {
    "constant_amplitude": lambda c: c.Pulse.ConstantAmplitude(
        1.3, c.RampWaveform(40, -1.0, 2.0), 0.2, post_phase_shift=0.5),
    "constant_detuning": lambda c: c.Pulse.ConstantDetuning(c.BlackmanWaveform(40, 1.1), -0.7, 0.4),
    "arbitrary_phase": lambda c: c.Pulse.ArbitraryPhase(
        c.KaiserWaveform(50, 0.9), c.InterpolatedWaveform(50, [0.0, 1.2, 0.4, 2.0])),
}


@pytest.mark.parametrize("name", sorted(PULSES))
def test_pulse_constructors_match_jax(name):
    """ConstantAmplitude / ConstantDetuning / ArbitraryPhase (its detuning
    minus the phase's derivative, its carrier phase phi(0))."""
    jp, tp = PULSES[name](jcore), PULSES[name](tcore)
    assert tp.duration == jp.duration
    for wf in ("amplitude", "detuning"):
        np.testing.assert_allclose(to_numpy(getattr(tp, wf).samples),
                                   np.asarray(getattr(jp, wf).samples), rtol=0, atol=F64_TOL,
                                   err_msg=wf)
    for attr in ("phase", "post_phase_shift"):
        assert float(getattr(tp, attr)) == pytest.approx(float(getattr(jp, attr)), abs=F64_TOL)

"""PyTorch port vs the JAX package: local channels, the SLM mask and
output modulation through the Hamiltonian, the model and the fused
kernels (pulser_diff_torch.hamiltonian ``build_data`` /
``_xy_kron_terms``, model, backend ``from_sequence(with_modulation=)``,
ops.fused_evolution at the shapes they bring).

The f64 paths agree to 1e-12 (the build) and 1e-10 (values, gradients,
states).  The kernels' plain versions are held against the Pallas
kernels in interpret mode, as tests/test_torch_xy_fused.py and
tests/test_torch_ckpt.py hold them: K1/K2 at an XY shape whose SLM mask
doubles the kron pairs, and K1/K2 and K4/K5 at a shape that mixes global
and per-qubit parts across a retarget.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch import QuantumModel, TorchEmulator
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.ops.linalg import _interpolate_sine_np
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.test_torch_xy_fused import _max_rel, _same_inputs, _want
from tests.torch_port_cases import (
    batched, factored_fields, jax_cplx, kron_fields, random_state, to_numpy, torch_cplx,
)

torch.set_num_threads(1)

F64_TOL = 1e-12
MODEL_TOL = 1e-10
# the kernels' plain versions against the Pallas kernels (the tolerances
# of tests/test_torch_fused.py): states 1e-5 absolute, every cotangent
# 1e-4 of its largest magnitude
K1_TOL = 1e-5
K2_REL_TOL = 1e-4
STAGE_RTOL = 2.0**-23
STAGE_ATOL = 1e-14


def _coords(n, spacing=6.0):
    return [(spacing * (i % 2), spacing * (i // 2)) for i in range(n)]


def mixed_sequence(core, n=4, duration=100):
    """A global pulse and a local channel retargeted from q0 to (q1, q2)
    with a phase shift between, one local pulse overlapping the global
    one (no-delay) and one after it."""
    seq = core.Sequence(core.Register.from_coordinates(_coords(n), prefix="q"), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.declare_channel("l", "rydberg_local", initial_target="q0")
    seq.add(core.Pulse(core.InterpolatedWaveform(duration, [0.5, 2.0, 1.2, 0.3]),
                       core.ConstantWaveform(duration, -1.0), 0.1), "g")
    seq.add(core.Pulse(core.BlackmanWaveform(40, 1.2), core.RampWaveform(40, -1.0, 1.0), 0.2),
            "l", protocol="no-delay")
    seq.target(["q1", "q2"], "l")
    seq.phase_shift(0.6, "q1", "q2", basis="ground-rydberg")
    seq.add(core.Pulse(core.BlackmanWaveform(30, 0.9), core.RampWaveform(30, 0.8, -0.4), 0.0),
            "l")
    return seq


def ising_slm_sequence(core, n=3):
    seq = core.Sequence(core.Register.from_coordinates(_coords(n), prefix="q"), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.config_slm_mask(["q1"])
    seq.add(core.Pulse.ConstantPulse(40, 1.5, -0.5, 0.0), "g")
    seq.add(core.Pulse(core.RampWaveform(50, 0.2, 1.8), core.ConstantWaveform(50, 0.4), 0.3), "g")
    return seq


def xy_slm_sequence(core, n=4, first=24, second=36):
    """bench_xy.py's kind of sequence (microwave_global, an in-plane
    field) with an SLM mask on two qubits and a first pulse that ends
    mid-sequence."""
    rng = np.random.default_rng(n)
    jit = rng.uniform(-0.4, 0.4, size=(n, 2))
    coords = [(8.0 * (i % 2) + jit[i, 0], 8.0 * (i // 2) + jit[i, 1]) for i in range(n)]
    seq = core.Sequence(core.Register.from_coordinates(coords, prefix="q"), core.MockDevice)
    seq.declare_channel("mw", "microwave_global")
    seq.set_magnetic_field(1.0, 1.0, 0.0)
    seq.config_slm_mask(["q0", f"q{n - 1}"])
    seq.add(core.Pulse.ConstantPulse(first, 1.4, 0.3, 0.0), "mw")
    seq.add(core.Pulse(core.RampWaveform(second, 0.4, 1.6), core.ConstantWaveform(second, -0.2),
                       0.5), "mw")
    return seq


def _emulators(build, sampling_rate=0.5, **kw):
    jsim = TpuEmulator.from_sequence(build(jcore), sampling_rate=sampling_rate,
                                     evaluation_times="Minimal", **kw)
    tsim = TorchEmulator.from_sequence(build(tcore), sampling_rate=sampling_rate,
                                       evaluation_times="Minimal", device="cpu", **kw)
    return jsim, tsim


BUILDS = {
    "mixed_3": functools.partial(mixed_sequence, n=3),
    "mixed_4": mixed_sequence,
    "ising_slm": ising_slm_sequence,
    "xy_slm_3": functools.partial(xy_slm_sequence, n=3),
    "xy_slm_4": xy_slm_sequence,
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_data_matches_jax(name):
    """Parts (in JAX's order), streams, the interaction, and with XY the
    kron pairs of the full and masked sets with their on/off streams."""
    jsim, tsim = _emulators(BUILDS[name])
    jh, th = jsim._hamiltonian._ham_data, tsim._hamiltonian._ham_data
    jf, tf = factored_fields(jh), factored_fields(th)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=F64_TOL, err_msg=k)
    if name.startswith("xy"):
        jk, tk = kron_fields(jh), kron_fields(th)
        for k in jk:
            assert tk[k].shape == jk[k].shape, k
            np.testing.assert_allclose(tk[k], jk[k], rtol=0, atol=F64_TOL, err_msg=k)
        n = len(tsim._register.qubit_ids)
        a, b = n // 2, n - n // 2
        K = (a >= 2) + (b >= 2) + a
        on = tk["kron_streams_re"]
        assert on.shape[0] == 2 * K  # the full set, then the masked set
        assert set(np.unique(on)) == {0.0, 1.0}
        np.testing.assert_array_equal(on[:K] + on[K:], np.ones_like(on[:K]))
    else:
        # per-qubit streams beside (mixed) or instead of (SLM) the global ones
        assert th.row_parts.shape[0] + th.col_parts.shape[0] > 4


N_PARAMS, DURATION = 4, 100
P0 = np.linspace(0.8, 2.0, N_PARAMS)
AREA0 = np.array([1.1, 0.7])


def local_model_sequence(core, n=3):
    """A global channel with a parametrized amplitude and a local channel
    whose two Blackman pulses' areas are a sequence variable."""
    seq = core.Sequence(core.Register.from_coordinates(_coords(n), prefix="q"), core.MockDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.declare_channel("l", "rydberg_local", initial_target="q0")
    amp = seq.declare_variable("amp_samples", size=DURATION)
    area = seq.declare_variable("area", size=2)
    seq.add(core.Pulse(core.CustomWaveform(amp, duration=DURATION),
                       core.ConstantWaveform(DURATION, -1.0), 0.0), "g")
    seq.add(core.Pulse(core.BlackmanWaveform(40, area[0]), core.RampWaveform(40, -1.0, 1.0), 0.2),
            "l", protocol="no-delay")
    seq.target(["q1", "q2"], "l")
    seq.phase_shift(0.6, "q1", "q2", basis="ground-rydberg")
    seq.add(core.Pulse(core.BlackmanWaveform(40, area[1]), core.RampWaveform(40, 1.0, -0.5), 0.0),
            "l")
    return seq


def test_local_model_value_and_gradient_match_jax():
    """A 3-atom model (global amplitude parameters and the local pulses'
    areas trainable): value and both gradients on the f64 paths."""
    M = _interpolate_sine_np(N_PARAMS, DURATION)
    Mj, Mt = jnp.asarray(M), torch.as_tensor(M)
    jm = JModel(local_model_sequence(jcore), {"amp_samples": ((jnp.asarray(P0),), lambda x: Mj @ x),
                                             "area": jnp.asarray(AREA0)},
                sampling_rate=0.5, evaluation_times="Minimal", fused=False)
    f = jm.expectation_fn(j_total_mag(3, dense=False))
    (jv, (jgp, jga)) = jax.value_and_grad(
        lambda p, a: f({"amp_samples_0": p, "area": a})[1][-1], argnums=(0, 1))(
        jnp.asarray(P0), jnp.asarray(AREA0))
    tm = QuantumModel(local_model_sequence(tcore), {"amp_samples": ((P0,), lambda x: Mt @ x),
                                                    "area": AREA0},
                      sampling_rate=0.5, evaluation_times="Minimal", fused=False, device="cpu")
    assert tm._default_substeps() == jm._default_substeps()
    p = torch.tensor(P0, requires_grad=True)
    a = torch.tensor(AREA0, requires_grad=True)
    tv = tm.expectation_fn()({"amp_samples_0": p, "area": a})[1][-1]
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) < MODEL_TOL
    assert float(np.abs(np.asarray(jga)).max()) > 1e-4
    np.testing.assert_allclose(to_numpy(p.grad), np.asarray(jgp), rtol=0, atol=MODEL_TOL)
    np.testing.assert_allclose(to_numpy(a.grad), np.asarray(jga), rtol=0, atol=MODEL_TOL)


def modulated_sequence(core):
    """AnalogDevice: a Blackman pulse, an EOM block of two pulses, an
    interpolated pulse."""
    reg = core.Register.from_coordinates([(-6.0, 0.0), (0.0, 1.0), (6.0, 0.0)], prefix="q")
    seq = core.Sequence(reg, core.AnalogDevice)
    seq.declare_channel("g", "rydberg_global")
    seq.add(core.Pulse(core.BlackmanWaveform(200, 0.9), core.RampWaveform(200, -2.0, 2.0), 0.0),
            "g")
    seq.enable_eom_mode("g", 3.0, 0.0)
    seq.add_eom_pulse("g", 40, 0.3)
    seq.delay(24, "g")
    seq.add_eom_pulse("g", 32, 0.5)
    seq.disable_eom_mode("g")
    seq.add(core.Pulse(core.InterpolatedWaveform(80, [0.0, 3.0, 1.5, 0.0]),
                       core.ConstantWaveform(80, -1.0), 0.8), "g")
    return seq


def test_modulated_run_matches_jax_and_slm_is_refused():
    jsim, tsim = _emulators(modulated_sequence, with_modulation=True)
    seq = modulated_sequence(tcore)
    assert tsim._tot_duration == seq.get_duration(include_fall_time=True) > seq.get_duration()
    np.testing.assert_allclose(tsim.sampling_times, jsim.sampling_times, rtol=0, atol=0)
    jres, tres = jsim.run(), tsim.run()
    for f in ("re", "im"):
        np.testing.assert_allclose(to_numpy(getattr(tres.states, f)),
                                   np.asarray(getattr(jres.states, f)), rtol=0, atol=MODEL_TOL)
    masked = xy_slm_sequence(tcore)
    with pytest.raises(NotImplementedError, match="SLM mask and output modulation"):
        TorchEmulator.from_sequence(masked, with_modulation=True, device="cpu")


# ----------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ----------------------------------------------------------------------
def _kernel_inputs(build, method="DP5"):
    """The JAX kernel inputs of ``build``'s sequence (the JAX Hamiltonian
    staged by the JAX package) and the port's own staging of its own
    Hamiltonian, with the grid's slots."""
    jsim, tsim = _emulators(build)
    h, th = jsim._hamiltonian, tsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    re, im = batched(random_state(da * db, 1, seed=7), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array)
    tg = TGrid.make(th.sampling_times, tsim._eval_times_array, device="cpu")
    jdata = jpe.prepare_fused_inputs(h._ham_data, jax_cplx(re, im), jg.times, method)
    tdata = tfe.prepare_fused_inputs(th._ham_data, torch_cplx(re, im), tg.times, method)
    slots = tuple(int(s) for s in np.asarray(jg.write_slots))
    return jdata, tdata, slots, jg.n_eval


def _assert_staged_alike(jdata, tdata):
    assert set(tdata) == set(jdata)
    for k, jv in jdata.items():
        tv = to_numpy(tdata[k])
        assert tv.shape == jv.shape, k
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=STAGE_RTOL, atol=STAGE_ATOL,
                                   err_msg=k)


def test_slm_xy_k1_k2_plain_match_pallas_interpret():
    """3 atoms XY under an SLM mask: K = 4 kron pairs (the full and masked
    sets of 2), the on/off streams stepping inside a step; RK4.  The port's
    staging of its own Hamiltonian against JAX's; K1's plain version
    (states, both words) against the Pallas forward; K2's (lam0, every
    stream cotangent, the kron ones, dbar, krbar, kcbar) against the JAX
    custom VJP."""
    jdata, tdata, slots, n_eval = _kernel_inputs(
        functools.partial(xy_slm_sequence, n=3, first=8, second=14), "RK4")
    _assert_staged_alike(jdata, tdata)
    assert tfe._n_kron(tdata) == 4
    (j_re, j_im), vjp = jax.vjp(
        lambda d: jpe.fused_evolve_states("RK4", True, slots, n_eval, slots[-1], d), jdata)
    rng = np.random.default_rng(11)
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    jcot = {k: np.asarray(v) for k, v in jcot.items()}
    data = _same_inputs({k: np.asarray(v) for k, v in jdata.items()})
    tslots = torch.tensor(slots, dtype=torch.int32)
    t_re, t_im = tfe.fused_fwd(data, "RK4", tslots, n_eval)
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=K1_TOL)
    outs = tfe.fused_bwd(data, "RK4", tslots, n_eval, slots[-1], torch.tensor(np.asarray(j_re)),
                         torch.tensor(np.asarray(j_im)), torch.tensor(lam[0]),
                         torch.tensor(lam[1]))
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    zrr, zri, zcr, zci = tfe._unpack_zbar(outs[2], pr, pc)
    zkr, zki = tfe._unpack_zbar_kron(outs[2], pr, pc)
    pairs = {"psi_re": outs[0], "psi_im": outs[1], "diag": outs[3], "kr": outs[4],
             "kc": outs[5], "zrh_re": zrr, "zrh_im": zri, "zch_re": zcr, "zch_im": zci,
             "zkh_re": zkr, "zkh_im": zki}
    for k, got in pairs.items():
        want = _want(jcot, k)
        assert tuple(got.shape) == want.shape, k
        assert _max_rel(got, want) < K2_REL_TOL, (k, _max_rel(got, want))
    assert np.abs(jcot["kr"]).max() > 1e-3 and np.abs(jcot["kc"]).max() > 1e-3


def test_mixed_parts_k1_k2_plain_match_pallas_interpret():
    """3 atoms, a global channel and a local one retargeted from q0 to
    (q1, q2) with a phase shift: global and per-qubit parts in one stack.
    K1's plain version against the Pallas forward; K2's (lam0, every
    stream cotangent, dbar), whose rebuild of each step's start state
    crosses the retarget, against the JAX custom VJP."""
    jdata, tdata, slots, n_eval = _kernel_inputs(functools.partial(mixed_sequence, n=3))
    _assert_staged_alike(jdata, tdata)
    pr, pc = int(tdata["rp"].shape[0]), int(tdata["cp"].shape[0])
    assert pr + pc > 4
    (j_re, j_im), vjp = jax.vjp(
        lambda d: jpe.fused_evolve_states("DP5", True, slots, n_eval, slots[-1], d), jdata)
    rng = np.random.default_rng(13)
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    data = _same_inputs({k: np.asarray(v) for k, v in jdata.items()})
    tslots = torch.tensor(slots, dtype=torch.int32)
    t_re, t_im = tfe.fused_fwd(data, "DP5", tslots, n_eval)
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=K1_TOL)
    lam0_re, lam0_im, zbar, dbar = tfe.fused_bwd(
        data, "DP5", tslots, n_eval, slots[-1], torch.tensor(np.asarray(j_re)),
        torch.tensor(np.asarray(j_im)), torch.tensor(lam[0]), torch.tensor(lam[1]))
    zrr, zri, zcr, zci = tfe._unpack_zbar(zbar, pr, pc)
    pairs = {"psi_re": lam0_re, "psi_im": lam0_im, "diag": dbar, "zrh_re": zrr, "zrh_im": zri,
             "zch_re": zcr, "zch_im": zci}
    for k, got in pairs.items():
        want = np.asarray(jcot[k])
        assert tuple(got.shape) == want.shape, k
        assert _max_rel(got, want) < K2_REL_TOL, (k, _max_rel(got, want))


def test_mixed_parts_k4_k5_plain_match_pallas_interpret():
    """4 atoms, a global channel and a retargeted local one: global and
    per-qubit parts in one stack (pr = 6, pc = 4).  K4's plain version
    against the Pallas checkpointed forward at every step, K5's against
    the JAX checkpointed VJP."""
    jdata, tdata, _, _ = _kernel_inputs(mixed_sequence)
    _assert_staged_alike(jdata, tdata)
    assert (int(tdata["rp"].shape[0]), int(tdata["cp"].shape[0])) == (6, 4)
    (j_re, j_im), vjp = jax.vjp(lambda d: jpe.fused_evolve_ckpt("DP5", True, d), jdata)
    rng = np.random.default_rng(12)
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    data = _same_inputs({k: np.asarray(v) for k, v in jdata.items()})
    t_re, t_im = tfe.fused_fwd_ckpt(data, "DP5")
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=K1_TOL)
    lam0_re, lam0_im, zbar, dbar = tfe.fused_bwd_ckpt(
        data, "DP5", torch.tensor(np.asarray(j_re)), torch.tensor(np.asarray(j_im)),
        torch.tensor(lam[0]), torch.tensor(lam[1]))
    zrr, zri, zcr, zci = tfe._unpack_zbar(zbar, 6, 4)
    pairs = {"psi_re": lam0_re, "psi_im": lam0_im, "diag": dbar, "zrh_re": zrr, "zrh_im": zri,
             "zch_re": zcr, "zch_im": zci}
    for k, got in pairs.items():
        want = np.asarray(jcot[k])
        assert tuple(got.shape) == want.shape, k
        assert _max_rel(got, want) < K2_REL_TOL, (k, _max_rel(got, want))

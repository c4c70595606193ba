"""PyTorch port vs the JAX package: the XY path (microwave channel,
magnetic field, the dipole flip-flop interaction as kron pairs) from the
sequence to the value and the gradient with respect to pulse parameters,
qubit coordinates and pair distances.

The sequences are made in both packages from one numpy seed
(tests/torch_port_cases.py).  f64 quantities agree to 1e-12 (the same
operations) or 1e-10 (a few hundred stages of f64 roundoff); the fused f32
path is held against JAX's fused path in interpret mode and against the f64
path at the BASELINE.md bars.  The kernels' plain versions with kron pairs
are in test_torch_xy_fused.py and test_torch_xy_ckpt.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.backend import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_tpu.ops.apply import h_apply_batched as j_apply
from pulser_diff_tpu.ops.apply import h_matrix as j_h_matrix
from pulser_diff_tpu.ops.apply import interp_streams as j_interp
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_tpu.solvers import sesolve as jsesolve
from pulser_diff_torch import QuantumModel, TorchEmulator
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops.apply import h_apply_batched as t_apply
from pulser_diff_torch.ops.apply import h_matrix as t_h_matrix
from pulser_diff_torch.ops.apply import interp_streams as t_interp
from pulser_diff_torch.ops.linalg import _interpolate_sine_np, total_magnetization
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import sesolve as tsesolve

from tests.torch_port_cases import (
    batched, factored_fields, jax_cplx, kron_fields, random_state, to_numpy, torch_cplx,
    xy_coords, xy_emulators, xy_sequence,
)

torch.set_num_threads(1)

# the same f64 operations on both sides
F64_TOL = 1e-12
# f64 stepper over a few hundred stages, another association of the sums
STEP_TOL = 1e-10
# the fused f32 path on both sides (the plain versions against the Pallas
# kernels in interpret mode): f32 roundoff of sums taken in another order
FUSED_TOL = 1e-7
# the BASELINE.md bars of the fused f32 path against f64
VALUE_BAR, GRAD_BAR = 1e-6, 1e-5

IN_PLANE = (1.0, 1.0, 0.0)
# 2 atoms: cross terms only (a = b = 1); 3: within-column + cross (da != db);
# 4: all three kinds; 6: the JAX kernel's block form (da = db = 8)
ATOMS = [2, 3, 4, 6]


def _port_hamiltonian(jh):
    """The JAX FactoredHamiltonian's fields as the port's."""
    f, k = factored_fields(jh), kron_fields(jh)
    return factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]),
        kron_row=k["kron_row"], kron_col=k["kron_col"],
        kron_streams=(k["kron_streams_re"], k["kron_streams_im"]), device="cpu",
    )


# ----------------------------------------------------------------------
# front end
# ----------------------------------------------------------------------
@pytest.mark.parametrize("field", [None, IN_PLANE], ids=["default-field", "in-plane"])
@pytest.mark.parametrize("n_atoms", ATOMS)
def test_xy_front_end_matches_jax(n_atoms, field):
    """The sampled XY streams and every build_data field, kron pairs
    included, for the same sequence in both packages."""
    jsim, tsim = xy_emulators(n_atoms, seed=n_atoms, field=field)
    jh, th = jsim._hamiltonian, tsim._hamiltonian
    assert th.basis_name == jh.basis_name == "XY"
    assert th._basis_labels == jh._basis_labels
    np.testing.assert_array_equal(tsim.samples_obj._magnetic_field,
                                  jsim.samples_obj._magnetic_field)
    jq = jsim.samples_obj.to_nested_dict()["Global"]["XY"]
    tq = tsim.samples_obj.to_nested_dict()["Global"]["XY"]
    for k in ("amp", "det", "phase"):
        np.testing.assert_allclose(to_numpy(tq[k]), np.asarray(jq[k]), rtol=0, atol=F64_TOL)
    jf, tf = factored_fields(jh._ham_data), factored_fields(th._ham_data)
    jf.update(kron_fields(jh._ham_data))
    tf.update(kron_fields(th._ham_data))
    assert set(tf) == set(jf)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=F64_TOL, err_msg=k)
    # K: one within-row term (a >= 2), one within-column term (b >= 2), a cross term per row site
    a, b = n_atoms // 2, n_atoms - n_atoms // 2
    assert tf["kron_row"].shape[0] == (a >= 2) + (b >= 2) + a
    # the all-ground state is |u...u>, as in the JAX package
    np.testing.assert_array_equal(to_numpy(tsim.initial_state.re),
                                  np.asarray(jsim.initial_state.re))


@pytest.mark.parametrize("field", [None, IN_PLANE, (0.0, 0.0, 0.0)],
                         ids=["default-field", "in-plane", "zero-field"])
def test_xy_interaction_weights_and_coordinate_grad(field):
    """C3 (1 - 3 cos^2 theta) / r^3 and its gradient with respect to the
    coordinates; an out-of-plane or zero field puts no NaN into it (the
    double where)."""
    n = 4
    jsim, tsim = xy_emulators(n, seed=7, field=field)
    jh, th = jsim._hamiltonian, tsim._hamiltonian
    w = np.random.default_rng(1).normal(size=(n, n))
    c0 = np.asarray(xy_coords(n, 7))

    def jloss(c):
        jh._qdict = {q: c[i] for i, q in enumerate(jh._qdict)}
        return jnp.sum(jh._interaction_weights(jnp.ones(n)) * w)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(c0))
    c = torch.tensor(c0, requires_grad=True)
    th._qdict = {q: c[i] for i, q in enumerate(th._qdict)}
    W = th._interaction_weights(torch.ones(n, dtype=torch.float64))
    (W * torch.as_tensor(w)).sum().backward()
    jh._qdict = {q: jnp.asarray(c0[i]) for i, q in enumerate(jh._qdict)}
    jW = jh._interaction_weights(jnp.ones(n))
    np.testing.assert_allclose(to_numpy(W), np.asarray(jW), rtol=0, atol=F64_TOL)
    assert np.isfinite(to_numpy(c.grad)).all()
    np.testing.assert_allclose(to_numpy(c.grad), np.asarray(jgrad), rtol=0, atol=F64_TOL)
    # the pair distances land in _dist_dict under the same keys
    assert set(th._dist_dict) == set(jh._dist_dict)


def test_xy_mode_rules_and_copies():
    """XY mode as in the JAX package: a microwave channel cannot join
    another basis, the field needs XY mode, and build() and a model's
    register clone carry the field and the mode."""
    reg = tcore.Register.from_coordinates(xy_coords(3, 0), prefix="q")
    seq = tcore.Sequence(reg, tcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    with pytest.raises(ValueError, match="Microwave"):
        seq.declare_channel("mw", "microwave_global")
    with pytest.raises(ValueError, match="XY mode"):
        seq.set_magnetic_field(1.0, 0.0, 0.0)
    seq = tcore.Sequence(reg, tcore.MockDevice)
    seq.set_magnetic_field(1.0, 2.0, 0.5)
    with pytest.raises(ValueError, match="non-microwave"):
        seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("mw", "microwave_global")
    v = seq.declare_variable("amp", size=40)
    seq.add(tcore.Pulse(tcore.CustomWaveform(v, duration=40),
                        tcore.ConstantWaveform(40, 0.0), 0.0), "mw")
    built = seq.build(amp=np.ones(40))
    assert built._in_xy
    np.testing.assert_array_equal(built.magnetic_field, [1.0, 2.0, 0.5])
    model = QuantumModel(seq, {"amp": np.ones(40), "q1": xy_coords(3, 0)[1]}, device="cpu")
    assert set(model.trainable_qubits) == {"q1"}
    clone = model._clone_with_register(model._construct_register(dict(model.params)))
    assert clone._in_xy and clone.is_parametrized()
    np.testing.assert_array_equal(clone.magnetic_field, [1.0, 2.0, 0.5])
    with pytest.raises(ValueError, match="neither"):
        QuantumModel(seq, {"q9": (0.0, 0.0)}, device="cpu")


# ----------------------------------------------------------------------
# Hamiltonian application and the f64 stepper
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_atoms", [2, 3, 4])
def test_h_apply_with_kron_pairs_matches_jax(n_atoms):
    jsim, tsim = xy_emulators(n_atoms, seed=3, field=IN_PLANE)
    jh, th = jsim._hamiltonian._ham_data, tsim._hamiltonian._ham_data
    da, db = jh.da, jh.db
    re, im = batched(random_state(da * db, 3, seed=n_atoms), da, db)
    t = 0.37 * float(jh.sample_dt) * (int(jh.n_samples) - 1)
    jz = j_interp(jh, jnp.asarray(t))
    tz = t_interp(th, torch.tensor(t, dtype=torch.float64))
    assert tz[2] is not None
    jo = j_apply(jh, *jz, jax_cplx(re, im))
    to = t_apply(th, *tz, torch_cplx(re, im))
    np.testing.assert_allclose(to_numpy(to.re), np.asarray(jo.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(to.im), np.asarray(jo.im), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("t_frac", [0.0, 0.41, 1.0])
def test_h_matrix_with_kron_pairs_matches_jax(t_frac):
    """The dense H(t) at 3 atoms XY, and it is hermitian."""
    jsim, tsim = xy_emulators(3, seed=5, field=IN_PLANE)
    jh, th = jsim._hamiltonian._ham_data, tsim._hamiltonian._ham_data
    t = t_frac * float(jh.sample_dt) * (int(jh.n_samples) - 1)
    jm = j_h_matrix(jh, jnp.asarray(t))
    tm = t_h_matrix(th, torch.tensor(t, dtype=torch.float64))
    np.testing.assert_allclose(to_numpy(tm.re), np.asarray(jm.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(tm.im), np.asarray(jm.im), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(tm.re), to_numpy(tm.re).T, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(tm.im), -to_numpy(tm.im).T, rtol=0, atol=F64_TOL)


def _stepper_setup(n_atoms, nb, eval_times):
    jsim, _ = xy_emulators(n_atoms, duration=60, seed=20 + n_atoms, field=IN_PLANE,
                           evaluation_times=eval_times)
    h = jsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    psi = batched(random_state(da * db, nb, seed=n_atoms), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array)
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu")
    return h._ham_data, _port_hamiltonian(h._ham_data), psi, jg, tg


@pytest.mark.parametrize("solver", ["DP5_SE", "RK4_SE"])
@pytest.mark.parametrize("n_atoms,nb,eval_times", [(3, 2, "Full"), (4, 1, 0.5)])
def test_xy_sesolve_states_match_jax(solver, n_atoms, nb, eval_times):
    jh, th, psi, jg, tg = _stepper_setup(n_atoms, nb, eval_times)
    js = jsesolve(jh, jax_cplx(*psi), jg, solver=solver, substeps=2)
    ts = tsesolve(th, torch_cplx(*psi), tg, solver=solver, substeps=2)
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=STEP_TOL)


def test_xy_sesolve_kron_grads_match_jax():
    """Gradients of a weighted population loss with respect to the kron
    part matrices (the path a coordinate gradient takes) and the kron
    streams, at 1e-10 of each gradient's largest magnitude."""
    jh, th, psi, jg, tg = _stepper_setup(3, 1, "Full")
    w = np.random.default_rng(4).normal(size=(jg.n_eval, 1) + psi[0].shape[1:])

    def jloss(kr, kc, ks):
        h = jh._replace(kron_row=kr, kron_col=kc, kron_streams=JCplx(ks, jh.kron_streams.im))
        s = jsesolve(h, jax_cplx(*psi), jg, substeps=2)
        return jnp.sum(jnp.asarray(w) * (s.re**2 + s.im**2))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jh.kron_row, jh.kron_col, jh.kron_streams.re)
    leaves = [th.kron_row.clone().requires_grad_(True), th.kron_col.clone().requires_grad_(True),
              th.kron_streams.re.clone().requires_grad_(True)]
    h = th._replace(kron_row=leaves[0], kron_col=leaves[1],
                    kron_streams=Cplx(leaves[2], th.kron_streams.im))
    s = tsesolve(h, torch_cplx(*psi), tg, substeps=2)
    tval = (torch.as_tensor(w) * (s.re**2 + s.im**2)).sum()
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) < STEP_TOL
    for leaf, jgr in zip(leaves, jgrads):
        jgr = np.asarray(jgr)
        assert np.abs(jgr).max() > 1e-3
        np.testing.assert_allclose(to_numpy(leaf.grad), jgr, rtol=0,
                                   atol=STEP_TOL * np.abs(jgr).max())


@pytest.mark.parametrize("spacing", [8.0, 3.0])
@pytest.mark.parametrize("options", [{}, {"max_step": 0.0007}, {"substeps": 4}])
def test_xy_auto_substeps_match_jax(options, spacing):
    """The stability heuristic counts the kron pairs' norms; at 3 um the
    flip-flop terms alone ask for several substeps."""
    def make(core):
        reg = core.Register.from_coordinates(
            [(spacing * i, 0.5 * (i % 2)) for i in range(4)], prefix="q")
        seq = core.Sequence(reg, core.MockDevice)
        seq.declare_channel("mw", "microwave_global")
        seq.add(core.Pulse.ConstantPulse(200, 1.2, -0.4, 0.3), "mw")
        return seq

    jsim = TpuEmulator.from_sequence(make(jcore), sampling_rate=0.1)
    tsim = TorchEmulator.from_sequence(make(tcore), sampling_rate=0.1, device="cpu")
    assert tsim._auto_substeps(options) == jsim._auto_substeps(options)
    if spacing == 3.0 and not options:
        assert tsim._auto_substeps(options) > 1


# ----------------------------------------------------------------------
# the model: bench_xy.py's workload at 4 atoms, 100 ns
# ----------------------------------------------------------------------
N_ATOMS, DURATION, N_PARAMS, SAMPLING_RATE, SPACING = 4, 100, 8, 0.25, 8.0
P0 = np.linspace(0.5, 2.0, N_PARAMS)
M = _interpolate_sine_np(N_PARAMS, DURATION)
COORDS = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(N_ATOMS)]


def _bench_xy_sequence(core):
    reg = core.Register.from_coordinates(COORDS, prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("mw", "microwave_global")
    v = seq.declare_variable("amp_samples", size=DURATION)
    seq.add(core.Pulse(core.CustomWaveform(v, duration=DURATION),
                       core.ConstantWaveform(DURATION, 0.0), 0.0), "mw")
    return seq


@functools.lru_cache(maxsize=None)
def _jax_xy_value_grad(**kw):
    Mj = jnp.asarray(M)
    model = JModel(_bench_xy_sequence(jcore),
                   {"amp_samples": ((jnp.asarray(P0),), lambda x: Mj @ x),
                    "q1": jnp.asarray(COORDS[1])},
                   sampling_rate=SAMPLING_RATE, evaluation_times="Minimal", **kw)
    f = model.expectation_fn(j_total_mag(N_ATOMS, dense=False))
    v, (gp, gc) = jax.value_and_grad(
        lambda p, c: f({"amp_samples_0": p, "q1": c})[1][-1], argnums=(0, 1)
    )(jnp.asarray(P0), jnp.asarray(COORDS[1]))
    return float(v), np.asarray(gp), np.asarray(gc), model._default_substeps()


def _port_xy_value_grad(**kw):
    Mt = torch.as_tensor(M)
    model = QuantumModel(_bench_xy_sequence(tcore),
                         {"amp_samples": ((P0,), lambda x: Mt @ x), "q1": COORDS[1]},
                         sampling_rate=SAMPLING_RATE, evaluation_times="Minimal",
                         device="cpu", **kw)
    p = torch.tensor(P0, requires_grad=True)
    c = torch.tensor(COORDS[1], dtype=torch.float64, requires_grad=True)
    _, vals = model.expectation_fn()({"amp_samples_0": p, "q1": c})
    vals[-1].backward()
    return (float(vals[-1].detach()), to_numpy(p.grad), to_numpy(c.grad),
            model._default_substeps())


def test_xy_model_f64_matches_jax():
    jv, jg, jc, js = _jax_xy_value_grad(fused=False)
    tv, tg, tc, ts = _port_xy_value_grad(fused=False)
    assert ts == js
    assert abs(tv - jv) < STEP_TOL
    np.testing.assert_allclose(tg, jg, rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=STEP_TOL)
    assert np.abs(tc).max() > 1e-5  # the coordinate gradient is there


def test_xy_model_fused_matches_pallas_and_f64():
    """DP5_PALLAS on the CPU runs the plain versions of K1/K2 with kron
    pairs: held against JAX DP5_PALLAS (interpret mode) at f32 roundoff,
    and against the f64 path within the BASELINE bars, for the parameter
    and the coordinate gradients alike."""
    jv, jg, jc, _ = _jax_xy_value_grad(solver="DP5_PALLAS")
    jv64, jg64, jc64, _ = _jax_xy_value_grad(fused=False)
    tv, tg, tc, _ = _port_xy_value_grad(solver="DP5_PALLAS")
    assert abs(tv - jv) < FUSED_TOL
    np.testing.assert_allclose(tg, jg, rtol=0, atol=FUSED_TOL)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=FUSED_TOL)
    assert abs(tv - jv64) < VALUE_BAR
    np.testing.assert_allclose(tg, jg64, rtol=0, atol=GRAD_BAR)
    np.testing.assert_allclose(tc, jc64, rtol=0, atol=GRAD_BAR)
    assert np.abs(tc).max() > 1e-5


# ----------------------------------------------------------------------
# distances
# ----------------------------------------------------------------------
@pytest.mark.parametrize("solver", ["DP5_PALLAS", "DP5_SE"])
def test_xy_distance_grad_matches_jax(solver):
    """expectation_fn_of_dists at 2 atoms: the value trace and the
    gradient with respect to the pair distance, against JAX with the
    same solver (test_pallas_xy_distance_grad_end_to_end's bar), and the
    port's fused gradient against its own f64 one."""
    def make(core):
        reg = core.Register.from_coordinates([(0.0, 0.0), (7.0, 2.0)], prefix="q")
        seq = core.Sequence(reg, core.MockDevice)
        seq.declare_channel("mw", "microwave_global")
        seq.set_magnetic_field(*IN_PLANE)
        seq.add(core.Pulse.ConstantPulse(200, 1.2, -0.4, 0.3), "mw")
        return seq

    jsim = TpuEmulator.from_sequence(make(jcore), sampling_rate=0.5, evaluation_times="Minimal")
    tsim = TorchEmulator.from_sequence(make(tcore), sampling_rate=0.5,
                                       evaluation_times="Minimal", device="cpu")
    assert tsim.qq_distance_keys == jsim.qq_distance_keys == ["q0-q1"]
    assert abs(float(tsim.qq_distances["q0-q1"]) - float(np.hypot(7.0, 2.0))) < F64_TOL
    d0 = 8.0

    def jfinal(s):
        fn = jsim.expectation_fn_of_dists(j_total_mag(2), solver=s)
        return lambda d: fn(d)[-1]

    jval = float(jfinal(solver)(jnp.asarray([d0])))
    jg = float(jax.grad(jfinal(solver))(jnp.asarray([d0]))[0])

    def tgrad(s):
        d = torch.tensor([d0], dtype=torch.float64, requires_grad=True)
        v = tsim.expectation_fn_of_dists(total_magnetization(2, device="cpu"), solver=s)(d)[-1]
        v.backward()
        return float(v.detach()), float(d.grad[0])

    tval, tg = tgrad(solver)
    assert abs(tval - jval) < (FUSED_TOL if solver == "DP5_PALLAS" else STEP_TOL)
    assert abs(tg - jg) < 1e-4 * max(1.0, abs(jg))
    assert abs(tg) > 1e-3
    if solver == "DP5_PALLAS":
        _, tg64 = tgrad("DP5_SE")
        assert abs(tg - tg64) < 1e-4 * max(1.0, abs(tg64))
    # the override is dropped after the call; qq_distances are the last build's
    assert tsim._hamiltonian._dist_override == {}
    assert float(tsim.qq_distances["q0-q1"].detach()) == d0
    with pytest.raises(ValueError):
        xy_sequence(tcore, 2).declare_channel("ryd", "rydberg_global")

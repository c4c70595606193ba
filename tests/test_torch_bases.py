"""PyTorch port vs the JAX package: the digital and all bases (Raman
channels, three levels a site) and the leakage-extended bases
(pulser_diff_torch.hamiltonian, backend, result, simresults).

Both packages build the same basis tables, factored Hamiltonians, dense
operators and H(t) (1e-12); measure 3- and 4-level states with the same
0/1 projection; reduce all-basis states to the ground-rydberg and digital
bases alike; and the fused kernels' plain versions at da = 3 and 9
agree with the JAX Pallas kernels in interpret mode at the tolerances of
tests/test_torch_fused.py.  A 3-atom all-basis model's value and
gradient match JAX's fused ones at the parity of tests/test_torch_model.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.result import QuantumResult as JResult
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch import QuantumModel, SimConfig, TorchEmulator
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.ops.linalg import _interpolate_sine_np
from pulser_diff_torch.result import QuantumResult

from tests.test_torch_fused import K1_TOL, K2_REL_TOL, _max_rel, _same_inputs
from tests.test_torch_model import FUSED_TOL, GRAD_BAR, VALUE_BAR
from tests.torch_port_cases import (
    batched, factored_fields, jax_cplx, pulse_samples, random_state, to_numpy,
)

torch.set_num_threads(1)

# f64 on both sides, the same operations
F64_TOL = 1e-12


def _leak_op(labels: list, to: str = "x", frm: str = None) -> np.ndarray:
    """|to><frm| in ``labels`` (the ground level by default)."""
    frm = frm or ("u" if "u" in labels else "g")
    op = np.zeros((len(labels), len(labels)))
    op[labels.index(to), labels.index(frm)] = 1.0
    return op


def all_sequence(core, n_atoms: int, channels=("ryd", "raman"), duration: int = 80,
                 seed: int = 0):
    """Custom-amplitude pulses on rydberg_global and / or raman_global
    (both at once: the all basis), or on microwave_global ("mw"), in the
    package ``core``."""
    amp, det = pulse_samples(duration, seed)
    reg = core.Register.from_coordinates(
        [(6.0 * (i % 2), 6.0 * (i // 2)) for i in range(n_atoms)], prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    kinds = {"ryd": "rydberg_global", "raman": "raman_global", "mw": "microwave_global"}
    for k, ch in enumerate(channels):
        seq.declare_channel(ch, kinds[ch])
        scale = 1.0 - 0.3 * k
        seq.add(core.Pulse(core.CustomWaveform(scale * amp), core.CustomWaveform(det + k),
                           0.4 + 0.3 * k), ch, protocol="no-delay")
    return seq


# basis name -> (channels, leakage level's label set for the eff_noise
# operator, or None)
BASES = {
    "digital": (("raman",), None),
    "all": (("ryd", "raman"), None),
    "ground-rydberg-leakage": (("ryd",), ["r", "g", "x"]),
    "digital-leakage": (("raman",), ["g", "h", "x"]),
    "xy-leakage": (("mw",), ["u", "d", "x"]),
}


def pair(name: str, n_atoms: int, evaluation_times="Minimal", duration: int = 80, **cfg):
    """(JAX emulator, port emulator on the CPU) for the same sequence in
    the basis ``name``."""
    channels, leak = BASES[name]
    if leak is not None:
        cfg = dict(noise="eff_noise", eff_noise_rates=(0.3,),
                   eff_noise_opers=(_leak_op(leak),), with_leakage=True, **cfg)
    jsim = TpuEmulator.from_sequence(
        all_sequence(jcore, n_atoms, channels, duration), sampling_rate=0.5,
        config=JSimConfig(**cfg) if cfg else None, evaluation_times=evaluation_times)
    tsim = TorchEmulator.from_sequence(
        all_sequence(tcore, n_atoms, channels, duration), sampling_rate=0.5,
        config=SimConfig(**cfg) if cfg else None, evaluation_times=evaluation_times,
        device="cpu")
    return jsim, tsim


def _np(c) -> np.ndarray:
    return to_numpy(c.re) + 1j * to_numpy(c.im)


def _close(got, want, tol=F64_TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name, n_atoms", [("digital", 3), ("all", 2), ("all", 3),
                                           ("ground-rydberg-leakage", 2),
                                           ("digital-leakage", 3), ("xy-leakage", 2)])
def test_basis_tables_and_build_data_match_jax(name, n_atoms):
    """The basis, its labels, kets and one-site operators; build_data; the
    initial state; build_operator and get_hamiltonian."""
    jsim, tsim = pair(name, n_atoms)
    jh, th = jsim._hamiltonian, tsim._hamiltonian
    assert (th.basis_name, th.dim, th._basis_labels) == (jh.basis_name, jh.dim, jh._basis_labels)
    assert (tsim.basis_name, tsim.dim, tsim._meas_basis) == (jsim.basis_name, jsim.dim,
                                                              jsim._meas_basis)
    assert set(tsim.basis) == set(jsim.basis)
    for b, ket in tsim.basis.items():
        _close(_np(ket), np.asarray(jsim.basis[b].re))
    assert set(th.op_matrix) == set(jh.op_matrix)
    for k, op in th.op_matrix.items():
        _close(_np(op), jh.op_matrix[k].to_numpy())
    jf, tf = factored_fields(jh._ham_data), factored_fields(th._ham_data)
    for k, v in jf.items():
        assert tf[k].shape == v.shape, k
        _close(tf[k], v)
    assert (th._ham_data.kron_row is None) == (jh._ham_data.kron_row is None)
    _close(_np(tsim.initial_state), jsim.initial_state.to_numpy())
    rng = np.random.default_rng(n_atoms)
    mat = rng.normal(size=(th.dim, th.dim)) + 1j * rng.normal(size=(th.dim, th.dim))
    names = [k for k in th.op_matrix if k != "I"]
    for ops in ([(names[0], "global")], [(mat, ["q1"])], [(names[-1], ["q0"]), (mat, ["q1"])]):
        _close(_np(tsim.build_operator(ops)), jsim.build_operator(ops).to_numpy())
    for t_ns in (0.0, 37.0, 80.0):
        _close(_np(tsim.get_hamiltonian(t_ns)), jsim.get_hamiltonian(t_ns).to_numpy())
    with pytest.raises(ValueError, match="must be less"):
        tsim.get_hamiltonian(81.0)
    with pytest.raises(ValueError, match="not a valid operator"):
        tsim.build_operator([("sigma_zz", ["q0"])])


@pytest.mark.parametrize("name, n_atoms", [("digital", 2), ("all", 2), ("all", 3),
                                           ("digital-leakage", 2), ("xy-leakage", 2)])
def test_runs_match_jax(name, n_atoms):
    """run() on the f64 stepper (or mesolve under leakage): the states, the
    weights of every time and the result's bases."""
    jsim, tsim = pair(name, n_atoms, evaluation_times=0.5)
    jres, tres = jsim.run(), tsim.run()
    assert (tres._basis_name, tres._meas_basis) == (jres._basis_name, jres._meas_basis)
    _close(_np(tres.states), jres.states.to_numpy(), 1e-10)
    for jr, tr in zip(jres, tres):
        _close(to_numpy(tr._weights()), np.asarray(jr._weights()), 1e-10)


def _states(rng, R, n_eval, dim, dm):
    """(R, n_eval, dim, 1) normalised kets or (R, n_eval, dim, dim)
    density matrices."""
    k = rng.normal(size=(R, n_eval, dim, 2)) + 1j * rng.normal(size=(R, n_eval, dim, 2))
    k /= np.linalg.norm(k, axis=2, keepdims=True)
    if dm:
        s = 0.5 * np.einsum("rtiq,rtjq->rtij", k, k.conj())
    else:
        s = k[..., :1]
    return s


@pytest.mark.parametrize("name, leak4, meas", [
    ("all", False, "digital"), ("all", False, "ground-rydberg"),
    ("ground-rydberg-leakage", False, "ground-rydberg"), ("digital-leakage", False, "digital"),
    ("xy-leakage", False, "XY"), ("all", True, "digital"), ("all", True, "ground-rydberg"),
])
def test_batched_weights_at_three_and_four_levels(name, leak4, meas):
    """_batched_weights on kets and density matrices against JAX's; the
    4-level case is the all basis extended by the dark level."""
    jsim, tsim = pair(name, 2)
    if leak4:
        jsim._hamiltonian._build_basis_and_op_matrices(with_leakage=True)
        tsim._hamiltonian._build_basis_and_op_matrices(with_leakage=True)
    d = tsim._hamiltonian.dim
    assert d == (4 if leak4 else 3)
    jsim._meas_basis = tsim._meas_basis = meas
    rng = np.random.default_rng(d)
    for dm in (False, True):
        s = _states(rng, 2, 3, d**2, dm)
        jw = jsim._batched_weights(JCplx(jnp.asarray(s.real), jnp.asarray(s.imag)))
        tw = tsim._batched_weights(Cplx(torch.as_tensor(s.real), torch.as_tensor(s.imag)))
        assert tuple(tw.shape) == (2, 3, 4)
        _close(to_numpy(tw), np.asarray(jw))
    tsim._meas_basis = "XY" if meas != "XY" else "digital"
    if tsim._meas_basis not in ("digital",) or "h" not in tsim._hamiltonian._basis_labels:
        with pytest.raises(RuntimeError, match="Unknown measurement basis"):
            tsim._batched_weights(Cplx(torch.as_tensor(s.real), torch.as_tensor(s.imag)))


def test_leaked_levels_read_zero_and_results_sample_alike():
    """A 4-level QuantumResult (r, g, h, x): 'x' and 'g' read 0, the bright
    level 1, as in JAX; sampling_dist and get_samples from the same numpy
    generator equal JAX's."""
    labels = ("r", "g", "h", "x")
    rng = np.random.default_rng(3)
    st = rng.normal(size=(16, 1)) + 1j * rng.normal(size=(16, 1))
    st /= np.linalg.norm(st)
    for meas in ("ground-rydberg", "digital"):
        jr = JResult(("q0", "q1"), meas, JCplx(jnp.asarray(st.real), jnp.asarray(st.imag)), True,
                     basis_labels=labels)
        tr = QuantumResult(("q0", "q1"), meas, Cplx(torch.as_tensor(st.real),
                                                    torch.as_tensor(st.imag)), True, labels)
        _close(to_numpy(tr._weights()), np.asarray(jr._weights()))
        assert tr.sampling_dist.keys() == jr.sampling_dist.keys()
        assert (tr.get_samples(500, np.random.default_rng(1))
                == jr.get_samples(500, np.random.default_rng(1)))
    only_x = np.zeros((16, 1))
    only_x[15] = 1.0
    tr = QuantumResult(("q0", "q1"), "digital", Cplx(torch.as_tensor(only_x),
                                                     torch.zeros(16, 1)), True, labels)
    assert float(tr._weights()[0]) == 1.0
    with pytest.raises(NotImplementedError, match="basis_labels"):
        QuantumResult(("q0", "q1"), "digital", Cplx(torch.as_tensor(only_x),
                                                    torch.zeros(16, 1)))._weights()


def test_get_state_reduces_like_jax():
    """All-basis kets (a coherent run) and density matrices (under
    relaxation) reduced to either 2-level basis, against JAX; a population
    past the tolerance raises."""
    for cfg in ({}, {"noise": "relaxation", "relaxation_rate": 0.4}):
        jsim, tsim = pair("all", 2, duration=60, **cfg)
        jres, tres = jsim.run(), tsim.run()
        for basis in ("ground-rydberg", "digital"):
            for norm in (True, False):
                got = tres.get_final_state(reduce_to_basis=basis, tol=1.0, normalize=norm)
                want = jres.get_final_state(reduce_to_basis=basis, tol=1.0, normalize=norm)
                _close(_np(got), want.to_numpy(), 1e-10)
            with pytest.raises(TypeError, match="tolerance"):
                tres.get_final_state(reduce_to_basis=basis, tol=1e-9)
        with pytest.raises(ValueError, match="reduce_to_basis"):
            tres.get_final_state(reduce_to_basis="XY")


def test_noisy_all_basis_run_samples_three_levels():
    """SPAM preparation errors on the all basis: the noisy batch samples
    3-level states through the projection, every time's counts summing to
    runs x samples_per_run; NoisyResults keeps the digital basis."""
    _, tsim = pair("all", 2, evaluation_times=0.5, noise="SPAM", eta=0.3,
                   runs=6, samples_per_run=4)
    res = tsim.run()
    assert type(res).__name__ == "NoisyResults" and res._basis_name == "digital"
    assert {sum(r.bitstring_counts.values()) for r in res} == {24}
    assert all(len(b) == 2 for r in res for b in r.bitstring_counts)


# ---------------------------------------------------------------------------
# the fused kernels' plain versions at da = 3 (2 atoms: 3 x 3) and da = 3,
# db = 9 (3 atoms) against the JAX Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
KERNEL_CASES = [(2, 1, "DP5", "Minimal"), (3, 2, "DP5", "Full")]


@functools.lru_cache(maxsize=None)
def _jax_kernels(case):
    """JAX kernel inputs for an all-basis case, its K1 states and K2
    cotangents, its K4 states and K5 cotangents (numpy)."""
    n, nb, method, eval_times = case
    jsim, _ = pair("all", n, evaluation_times=eval_times, duration=48)
    h = jsim._hamiltonian
    da, db = h.dim**h._a, h.dim**h._b
    re, im = batched(random_state(da * db, nb, seed=n), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array)
    jdata = jpe.prepare_fused_inputs(h._ham_data, jax_cplx(re, im), jg.times, method)
    slots = tuple(int(s) for s in np.asarray(jg.write_slots))
    rng = np.random.default_rng(n)

    def run(fwd):
        (j_re, j_im), vjp = jax.vjp(fwd, jdata)
        lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
        (cot,) = vjp(tuple(jnp.asarray(x) for x in lam))
        return (np.asarray(j_re), np.asarray(j_im)), lam, {k: np.asarray(v)
                                                            for k, v in cot.items()}

    k12 = run(lambda d: jpe.fused_evolve_states(method, True, slots, jg.n_eval, slots[-1], d))
    k45 = run(lambda d: jpe.fused_evolve_ckpt(method, True, d))
    return {k: np.asarray(v) for k, v in jdata.items()}, slots, jg.n_eval, (da, db), k12, k45


def _adjoint_pairs(tdata, out):
    lam0_re, lam0_im, zbar, dbar = out
    pr, pc = int(tdata["rp"].shape[0]), int(tdata["cp"].shape[0])
    zrr, zri, zcr, zci = tfe._unpack_zbar(zbar, pr, pc)
    return {"psi_re": lam0_re, "psi_im": lam0_im, "diag": dbar,
            "zrh_re": zrr, "zrh_im": zri, "zch_re": zcr, "zch_im": zci}


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"{c[0]}at-nb{c[1]}")
def test_k1_k2_plain_match_pallas_at_odd_da(case):
    """K1's plain version on every slot state and K2's on lam0, the stream
    cotangents and dbar, at da = 3 (a cluster of one block)."""
    method = case[2]
    jdata, slots, n_eval, (da, db), ((j_re, j_im), (lam_re, lam_im), jcot), _ = _jax_kernels(case)
    assert (da, db) == ((3, 3) if case[0] == 2 else (3, 9))
    assert tfe.cluster_plan(False, case[1], da, db, 2, 2, 0, 6)[0] == 1
    tdata = _same_inputs(jdata)
    tslots = torch.tensor(slots, dtype=torch.int32)
    t_re, t_im = tfe.fused_fwd(tdata, method, tslots, n_eval)
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=K1_TOL)
    out = tfe.fused_bwd(tdata, method, tslots, n_eval, slots[-1], torch.tensor(j_re),
                        torch.tensor(j_im), torch.tensor(lam_re), torch.tensor(lam_im))
    for k, got in _adjoint_pairs(tdata, out).items():
        assert tuple(got.shape) == jcot[k].shape, k
        assert _max_rel(got, jcot[k]) < K2_REL_TOL, (k, _max_rel(got, jcot[k]))


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"{c[0]}at-nb{c[1]}")
def test_k4_k5_plain_match_pallas_at_odd_da(case):
    """K4's plain version on every step's state and K5's on the adjoint's
    outputs, at da = 3; K4 equals K1 at the slots bit for bit."""
    method = case[2]
    jdata, slots, n_eval, _, _, ((j_re, j_im), (lam_re, lam_im), jcot) = _jax_kernels(case)
    tdata = _same_inputs(jdata)
    t_re, t_im = tfe.fused_fwd_ckpt(tdata, method)
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=K1_TOL)
    s_re, _ = tfe.fused_fwd(tdata, method, torch.tensor(slots, dtype=torch.int32), n_eval)
    for g, s in enumerate(slots[1:], start=1):
        if s < n_eval:
            assert torch.equal(t_re[:, g - 1], s_re[:, s])
    out = tfe.fused_bwd_ckpt(tdata, method, torch.tensor(j_re), torch.tensor(j_im),
                             torch.tensor(lam_re), torch.tensor(lam_im))
    for k, got in _adjoint_pairs(tdata, out).items():
        assert _max_rel(got, jcot[k]) < K2_REL_TOL, (k, _max_rel(got, jcot[k]))


# ---------------------------------------------------------------------------
# a 3-atom all-basis model: bench.py's 8-parameter amplitude on the Rydberg
# channel and a Raman pulse of trainable amplitude; the total Rydberg
# occupation
# ---------------------------------------------------------------------------
MODEL_ATOMS, MODEL_NS, N_PARAMS = 3, 120, 8
P0 = np.linspace(1.0, 3.0, N_PARAMS)
RAMAN0 = 0.8


def rydberg_occupation(n_atoms: int) -> np.ndarray:
    """The diagonal of sum_i |r><r|_i in the all basis (r is level 0)."""
    digits = np.stack(np.unravel_index(np.arange(3**n_atoms), (3,) * n_atoms), axis=1)
    return (digits == 0).sum(1).astype(np.float64)


def model_sequence(core):
    reg = core.Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(MODEL_ATOMS)], prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_global")
    v = seq.declare_variable("amp_samples", size=MODEL_NS)
    r = seq.declare_variable("raman_amp")
    seq.add(core.Pulse(core.CustomWaveform(v, duration=MODEL_NS),
                       core.ConstantWaveform(MODEL_NS, -2.0), 0.0), "ryd")
    seq.add(core.Pulse.ConstantPulse(MODEL_NS, r, 0.5, 0.3), "ram", protocol="no-delay")
    return seq


@functools.lru_cache(maxsize=None)
def _jax_model(solver):
    M = jnp.asarray(_interpolate_sine_np(N_PARAMS, MODEL_NS))
    model = JModel(model_sequence(jcore), {"amp_samples": ((jnp.asarray(P0),), lambda x: M @ x),
                                           "raman_amp": RAMAN0},
                   sampling_rate=0.25, evaluation_times="Minimal", solver=solver)
    f = model.expectation_fn(jnp.asarray(rydberg_occupation(MODEL_ATOMS)))

    def loss(p, r):
        return f({"amp_samples_0": p, "raman_amp": r})[1][-1]

    v, g = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(P0), jnp.asarray(RAMAN0))
    return float(v), np.concatenate([np.asarray(g[0]), [float(g[1])]])


def _port_model(solver):
    M = torch.as_tensor(_interpolate_sine_np(N_PARAMS, MODEL_NS))
    model = QuantumModel(model_sequence(tcore), {"amp_samples": ((P0,), lambda x: M @ x),
                                                 "raman_amp": RAMAN0},
                         sampling_rate=0.25, evaluation_times="Minimal", solver=solver,
                         device="cpu")
    p = torch.tensor(P0, requires_grad=True)
    r = torch.tensor(RAMAN0, dtype=torch.float64, requires_grad=True)
    f = model.expectation_fn(torch.as_tensor(rydberg_occupation(MODEL_ATOMS)))
    val = f({"amp_samples_0": p, "raman_amp": r})[1][-1]
    val.backward()
    return float(val.detach()), np.concatenate([to_numpy(p.grad), [float(r.grad)]])


def test_all_basis_model_matches_jax():
    """DP5_PALLAS on both sides (the plain versions here, the Pallas
    kernels in interpret mode there) at FUSED_TOL, and the f64 steppers at
    1e-10; the fused value and gradient within the BASELINE bars of f64."""
    jv, jg = _jax_model("DP5_PALLAS")
    tv, tg = _port_model("DP5_PALLAS")
    assert abs(tv - jv) < FUSED_TOL
    _close(tg, jg, FUSED_TOL)
    jv64, jg64 = _jax_model("DP5_SE")
    tv64, tg64 = _port_model("DP5_SE")
    assert abs(tv64 - jv64) < 1e-10
    _close(tg64, jg64, 1e-10)
    assert abs(tv - tv64) < VALUE_BAR
    _close(tg, tg64, GRAD_BAR)
    assert float(np.abs(tg[-1])) > 1e-5  # the Raman amplitude moves the occupation

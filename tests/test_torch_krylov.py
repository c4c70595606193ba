"""PyTorch port vs the JAX package: the Krylov CF4-Magnus stepper
``KRYLOV_SE`` / ``KRYLOV_SE_F32`` (pulser_diff_torch.solvers.solver:
``_make_se_step_krylov``, ``_krylov_expm``, ``_expm_sym_e1``,
``_krylov_expm_cadj``).

In f64 both packages run the same Lanczos recursion with the same
breakdown masks, and autograd runs through it (the exact discrete
adjoint), so states agree to f64 roundoff and gradients too, degenerate
spectra after a breakdown included.  In f32 both differentiate the exact
map by the same continuous adjoint; the two f32 solves round in another
order, so each is held against f64 at the JAX package's own bars, and the
port's distance to f64 against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.solvers import sesolve as jsesolve
from pulser_diff_tpu.solvers import solver as jsolver
from pulser_diff_torch import TorchEmulator
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops.linalg import _interpolate_sine_np
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import sesolve as tsesolve
from pulser_diff_torch.solvers import solver as tsolver

from tests.test_torch_mcwf import _count_syncs
from tests.test_torch_solver import _setup
from tests.torch_port_cases import emulators, jax_cplx, to_numpy, torch_cplx

torch.set_num_threads(1)

# f64 states against the JAX package's (same recursion, same masks)
STATE_TOL = 1e-11
# f64 value and gradient against jax.value_and_grad
GRAD_TOL = 1e-9
# the divided-difference backward against jax.vjp of the custom JVP
E1_TOL = 1e-12


def _stream_loss(th, tpsi, tg, solver, **kw):
    """loss(row_streams.re, int_diag) of the port: sum(re^2 - im) of the
    final state."""
    def loss(s_re, diag):
        h = th._replace(row_streams=Cplx(s_re, th.row_streams.im), int_diag=diag)
        out = tsesolve(h, tpsi, tg, solver=solver, **kw)
        return (out.re[-1] ** 2 - out.im[-1]).sum()
    return loss


def _jax_stream_loss(jh, jpsi, jg, solver, **kw):
    def loss(s_re, diag):
        h = jh._replace(row_streams=JCplx(s_re, jh.row_streams.im), int_diag=diag)
        out = jsesolve(h, jpsi, jg, solver=solver, **kw)
        last = out[out.re.shape[0] - 1]
        return jnp.sum(last.re ** 2 - last.im)
    return loss


def _port_value_and_grad(loss, th):
    s = th.row_streams.re.clone().requires_grad_(True)
    d = th.int_diag.clone().requires_grad_(True)
    v = loss(s, d)
    v.backward()
    return v.detach(), s.grad, d.grad


@pytest.mark.parametrize("n_atoms,nb,eval_times,m", [(3, 2, "Full", 12), (4, 1, 0.5, 6)])
def test_krylov_states_match_jax(n_atoms, nb, eval_times, m):
    """Every evaluation-time state at 1e-11; at 3 atoms (dim 8 < m) the
    subspace breaks down and the masks fire."""
    jh, th, psi, jg, tg = _setup(n_atoms, nb, eval_times)
    js = jsesolve(jh, jax_cplx(*psi), jg, solver="KRYLOV_SE", krylov_dim=m)
    ts = tsesolve(th, torch_cplx(*psi), tg, solver="KRYLOV_SE", krylov_dim=m)
    assert ts.re.dtype == torch.float64
    for got, want in ((ts.re, js.re), (ts.im, js.im)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=STATE_TOL)


@pytest.mark.parametrize("n_atoms,m", [(3, 12), (4, 6)])
def test_krylov_value_and_grad_match_jax(n_atoms, m):
    """Value and gradient (streams and interaction diagonal) against
    jax.value_and_grad at 1e-9; at 3 atoms the breakdown makes T's
    spectrum exactly degenerate, where plain autograd through eigh would
    give NaN."""
    jh, th, psi, jg, tg = _setup(n_atoms, 1, "Minimal")
    jv, (jgs, jgd) = jax.value_and_grad(
        _jax_stream_loss(jh, jax_cplx(*psi), jg, "KRYLOV_SE", krylov_dim=m), argnums=(0, 1))(
        jh.row_streams.re, jh.int_diag)
    tv, tgs, tgd = _port_value_and_grad(
        _stream_loss(th, torch_cplx(*psi), tg, "KRYLOV_SE", krylov_dim=m), th)
    assert abs(float(tv) - float(jv)) < GRAD_TOL
    for got, want in ((tgs, jgs), (tgd, jgd)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=GRAD_TOL)


def test_krylov_gradient_matches_dp5():
    """The port's Krylov value and gradient against its own DP5_SE at the
    JAX package's bars (tests/test_solvers.py::test_krylov_gradient_matches_dp5:
    the same 2-atom, 48 ns sequence, gradient in the Rabi frequency)."""
    reg = tcore.Register({"q0": [-4.0, 0.0], "q1": [4.0, 0.0]})

    def loss(omega, solver):
        seq = tcore.Sequence(reg, tcore.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        om = seq.declare_variable("om")
        seq.add(tcore.Pulse.ConstantPulse(48, om, -0.6, 0.5), "ryd")
        sim = TorchEmulator.from_sequence(seq.build(om=omega), sampling_rate=0.25,
                                          evaluation_times="Minimal", device="cpu")
        h = sim._hamiltonian
        grid = TGrid.make(h.sampling_times, sim._eval_times_array, device="cpu")
        psi0 = sim.initial_state
        st = tsesolve(h._ham_data, Cplx(psi0.re.T.reshape(1, 2, 2), psi0.im.T.reshape(1, 2, 2)),
                      grid, solver=solver, krylov_dim=6)
        pr, pi = st.re[-1].reshape(4), st.im[-1].reshape(4)
        obs = torch.tensor([2.0, 0.0, 0.0, -2.0], dtype=torch.float64)  # total magnetization
        return (obs * (pr ** 2 + pi ** 2)).sum()

    out = {}
    for solver in ("DP5_SE", "KRYLOV_SE"):
        om = torch.tensor(1.9, dtype=torch.float64, requires_grad=True)
        v = loss(om, solver)
        v.backward()
        out[solver] = (float(v.detach()), float(om.grad))
    (v_dp, g_dp), (v_kr, g_kr) = out["DP5_SE"], out["KRYLOV_SE"]
    assert np.isfinite(g_kr) and abs(g_kr) > 1e-3
    assert abs(v_dp - v_kr) < 1e-6
    assert abs(g_dp - g_kr) < 1e-5


def _e1_cases():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 5))
    rand = a + a.T
    degenerate = np.array([[1.3, 0.4, 0.0, 0.0], [0.4, -0.2, 0.0, 0.0],
                           [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    return {"random": (rand, 0.37), "degenerate": (degenerate, 0.7)}


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_expm_sym_e1_backward_matches_jax(case):
    """The backward pass (the transpose of JAX's Daleckii-Krein JVP) against
    jax.vjp of JAX's ``_expm_sym_e1`` at 1e-12, in T and in h, on a random
    T and on one with an exactly degenerate block (a breakdown's shape)."""
    T, h = _e1_cases()[case]
    rng = np.random.default_rng(5)
    ct = rng.normal(size=(2, T.shape[0]))
    (j_re, j_im), pull = jax.vjp(jsolver._expm_sym_e1, jnp.asarray(T), jnp.asarray(h))
    jT, jh = pull((jnp.asarray(ct[0]), jnp.asarray(ct[1])))
    tT = torch.tensor(T, requires_grad=True)
    th = torch.tensor(h, dtype=torch.float64, requires_grad=True)
    u_re, u_im = tsolver._expm_sym_e1(tT, th)
    np.testing.assert_allclose(to_numpy(u_re), np.asarray(j_re), atol=E1_TOL)
    np.testing.assert_allclose(to_numpy(u_im), np.asarray(j_im), atol=E1_TOL)
    gT, gh = torch.autograd.grad((u_re, u_im), (tT, th),
                                 grad_outputs=(torch.tensor(ct[0]), torch.tensor(ct[1])))
    assert bool(torch.isfinite(gT).all())
    np.testing.assert_allclose(to_numpy(gT), np.asarray(jT), rtol=0, atol=E1_TOL)
    assert abs(float(gh) - float(jh)) < E1_TOL


def test_expm_sym_e1_gradcheck():
    """torch.autograd.gradcheck on a non-degenerate T (symmetrised, so the
    numerical derivative moves both triangles as the backward assumes),
    batched over two matrices, and in h."""
    T, _ = _e1_cases()["random"]
    A = torch.tensor(np.stack([T, T[::-1, ::-1] + np.eye(5)]), requires_grad=True)
    h = torch.tensor(0.37, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, h_: tsolver._expm_sym_e1((a + a.transpose(-1, -2)) / 2, h_), (A, h))


def test_krylov_batch_equals_columns():
    """A batch of nb = 3 columns equals three nb = 1 solves: each column
    has its own subspace on the shared grid."""
    _, th, psi, _, tg = _setup(4, 3, "Full")
    batch = tsesolve(th, torch_cplx(*psi), tg, solver="KRYLOV_SE", krylov_dim=8)
    for b in range(3):
        one = tsesolve(th, torch_cplx(psi[0][b:b + 1], psi[1][b:b + 1]), tg, solver="KRYLOV_SE",
                       krylov_dim=8)
        np.testing.assert_allclose(to_numpy(batch.re[:, b:b + 1]), to_numpy(one.re), atol=1e-14)
        np.testing.assert_allclose(to_numpy(batch.im[:, b:b + 1]), to_numpy(one.im), atol=1e-14)


def test_krylov_loops_hold_no_host_sync(monkeypatch):
    """The Lanczos recursion and the step loop read no tensor on the host,
    in f64 and f32, forward and backward: the count of host reads does not
    grow with the step count."""
    counts = {}
    for duration in (40, 80):
        _, tsim = emulators(3, duration=duration, seed=2)
        h = tsim._hamiltonian
        tg = TGrid.make(h.sampling_times, tsim._eval_times_array, device="cpu")
        psi0 = tsim.initial_state
        p = Cplx(psi0.re.T.reshape(1, 2, 4), psi0.im.T.reshape(1, 2, 4))
        th = h._ham_data

        def run(solver):
            d = th.int_diag.clone().requires_grad_(True)
            out = tsesolve(th._replace(int_diag=d), p, tg, solver=solver, krylov_dim=6)
            (out.re.double() ** 2).sum().backward()

        counts[duration] = [_count_syncs(monkeypatch, lambda s=s: run(s))
                            for s in ("KRYLOV_SE", "KRYLOV_SE_F32")]
    assert counts[40] == counts[80], counts


def _f32_case():
    """tests/test_solvers.py::test_krylov_f32_matches_f64's input: the
    2-atom, 48 ns ConstantPulse(1.7, -0.6, 0.5) at sampling 0.25."""
    import pulser_diff_tpu.core as jcore

    reg_j = jcore.Register({"q0": jnp.array([-4.0, 0.0]), "q1": jnp.array([4.0, 0.0])})
    seq_j = jcore.Sequence(reg_j, jcore.MockDevice)
    seq_j.declare_channel("ryd", "rydberg_global")
    seq_j.add(jcore.Pulse.ConstantPulse(48, 1.7, -0.6, 0.5), "ryd")
    reg_t = tcore.Register({"q0": [-4.0, 0.0], "q1": [4.0, 0.0]})
    seq_t = tcore.Sequence(reg_t, tcore.MockDevice)
    seq_t.declare_channel("ryd", "rydberg_global")
    seq_t.add(tcore.Pulse.ConstantPulse(48, 1.7, -0.6, 0.5), "ryd")
    jsim = TpuEmulator.from_sequence(seq_j, sampling_rate=0.25, evaluation_times="Minimal")
    tsim = TorchEmulator.from_sequence(seq_t, sampling_rate=0.25, evaluation_times="Minimal",
                                       device="cpu")
    return jsim, tsim


def test_krylov_f32_matches_jax_f64():
    """KRYLOV_SE_F32 is f32 end to end, its gradient reaches the f64
    leaves, and value and gradient sit within the JAX package's bars of
    JAX's f64 Krylov (5e-6; 1e-4 x scale + 1e-8)."""
    from pulser_diff_tpu.solvers import TimeGrid as JGrid

    jsim, tsim = _f32_case()
    jh = jsim._hamiltonian._ham_data
    jg = JGrid.make(jsim._hamiltonian.sampling_times, jsim._eval_times_array)
    jpsi = JCplx(jsim.initial_state.re.T.reshape(1, 2, 2), jsim.initial_state.im.T.reshape(1, 2, 2))

    def jloss(s_re):
        h = jh._replace(row_streams=JCplx(s_re, jh.row_streams.im))
        out = jsesolve(h, jpsi, jg, solver="KRYLOV_SE", krylov_dim=4)
        last = out[out.re.shape[0] - 1]
        return jnp.sum(last.re ** 2 - last.im)

    v64, g64 = jax.value_and_grad(jloss)(jh.row_streams.re)
    th = tsim._hamiltonian._ham_data
    tg = TGrid.make(tsim._hamiltonian.sampling_times, tsim._eval_times_array, device="cpu")
    tpsi = Cplx(tsim.initial_state.re.T.reshape(1, 2, 2), tsim.initial_state.im.T.reshape(1, 2, 2))
    s = th.row_streams.re.clone().requires_grad_(True)
    out = tsesolve(th._replace(row_streams=Cplx(s, th.row_streams.im)), tpsi, tg,
                   solver="KRYLOV_SE_F32", krylov_dim=4)
    assert out.re.dtype == torch.float32 and out.im.dtype == torch.float32
    v32 = (out.re[-1] ** 2 - out.im[-1]).sum()
    v32.backward()
    assert s.grad.dtype == torch.float64
    assert abs(float(v64) - float(v32.detach())) < 5e-6
    scale = float(jnp.abs(g64).max())
    assert float(np.abs(np.asarray(g64) - to_numpy(s.grad)).max()) < 1e-4 * scale + 1e-8


@pytest.mark.parametrize("duration,seed", [(100, 1), (160, 0)])
def test_krylov_f32_distance_to_f64_within_jax(duration, seed):
    """The port's f32 Krylov states are at most 2x as far from the f64
    ones (+ 1e-7) as the JAX package's f32 states are, on the same 4-atom
    input.  With an f32 ``eigh`` of the Lanczos matrix the port's were
    2.8x and 8.4x as far here (the orthogonality loss of PyTorch's f32
    ``eigh``; ``_ExpmSymE1`` now decomposes T in f64 and rounds)."""
    jsim, tsim = emulators(4, duration=duration, seed=seed)
    j64 = jsim.run(solver="KRYLOV_SE").states
    j32 = jsim.run(solver="KRYLOV_SE_F32").states
    t32 = tsim.run(solver="KRYLOV_SE_F32").states
    assert t32.re.dtype == torch.float32
    ref = np.asarray(j64.re) + 1j * np.asarray(j64.im)
    d_jax = np.abs(np.asarray(j32.re, np.float64) + 1j * np.asarray(j32.im, np.float64) - ref).max()
    d_port = np.abs(to_numpy(t32.re).astype(np.float64) + 1j * to_numpy(t32.im) - ref).max()
    assert d_port <= 2 * d_jax + 1e-7, (d_port, d_jax)


def test_krylov_f32_near_eigenstate_gradients():
    """tests/test_solvers.py::test_krylov_f32_near_eigenstate_gradients on
    the port: 9 atoms at 6 um, 480 ns, an amplitude ramping from ~0 (the
    start is a near-eigenstate, the early betas small).  The f32 gradient
    through the continuous adjoint is finite and within that test's bars
    (1e-4 on the value, 1e-3 x scale + 1e-8 on the gradient) of JAX's f64
    Krylov discrete adjoint."""
    import pulser_diff_tpu.core as jcore
    from pulser_diff_tpu.ops.linalg import _interpolate_sine_np as j_interp_np
    from pulser_diff_tpu.solvers import TimeGrid as JGrid

    dur, n_params = 480, 4
    coords = [(6.0 * (i % 4), 6.0 * (i // 4)) for i in range(9)]

    def build(core, M, p):
        reg = core.Register.from_coordinates(coords, prefix="q")
        seq = core.Sequence(reg, core.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        amp = seq.declare_variable("amp", size=dur)
        seq.add(core.Pulse(core.CustomWaveform(amp, duration=dur),
                           core.ConstantWaveform(dur, -2.0), 0.0), "ryd")
        return seq.build(amp=M @ p)

    Mj = jnp.asarray(j_interp_np(n_params, dur))

    def jloss(p):
        sim = TpuEmulator.from_sequence(build(jcore, Mj, p), sampling_rate=0.25,
                                        evaluation_times="Minimal")
        h = sim._hamiltonian
        grid = JGrid.make(h.sampling_times, sim._eval_times_array)
        psi0 = sim.initial_state
        st = jsesolve(h._ham_data, JCplx(psi0.re.T.reshape(1, 16, 32), psi0.im.T.reshape(1, 16, 32)),
                      grid, solver="KRYLOV_SE")
        last = st[st.re.shape[0] - 1]
        return last.re[0, -1, -1] ** 2 + last.im[0, -1, -1] ** 2

    v64, g64 = jax.value_and_grad(jloss)(jnp.linspace(1.0, 3.0, n_params))
    Mt = torch.as_tensor(_interpolate_sine_np(n_params, dur))
    p = torch.linspace(1.0, 3.0, n_params, dtype=torch.float64).requires_grad_(True)
    sim = TorchEmulator.from_sequence(build(tcore, Mt, p), sampling_rate=0.25,
                                      evaluation_times="Minimal", device="cpu")
    h = sim._hamiltonian
    grid = TGrid.make(h.sampling_times, sim._eval_times_array, device="cpu")
    psi0 = sim.initial_state
    st = tsesolve(h._ham_data, Cplx(psi0.re.T.reshape(1, 16, 32), psi0.im.T.reshape(1, 16, 32)),
                  grid, solver="KRYLOV_SE_F32")
    v32 = st.re[-1, 0, -1, -1] ** 2 + st.im[-1, 0, -1, -1] ** 2
    v32.backward()
    assert bool(torch.isfinite(p.grad).all())
    assert abs(float(v64) - float(v32.detach())) < 1e-4
    scale = float(jnp.abs(g64).max())
    assert float(np.abs(np.asarray(g64) - to_numpy(p.grad)).max()) < 1e-3 * scale + 1e-8


def test_krylov_f32_products_are_pinned(monkeypatch):
    """Every f32 product of a KRYLOV_SE_F32 value-and-gradient solve (the
    recursion, the small exponential, the continuous adjoint) runs with
    TF32 off though the caller allowed it, and the caller's setting is
    restored."""
    m = torch.backends.cuda.matmul
    _, th, psi, _, tg = _setup(3, 1, "Minimal")
    seen, real_mm, real_einsum = [], torch.Tensor.__matmul__, torch.einsum

    def mm(a, b):
        if a.dtype == torch.float32:
            seen.append(m.allow_tf32)
        return real_mm(a, b)

    def einsum(eq, *ops):
        if any(o.dtype == torch.float32 for o in ops):
            seen.append(m.allow_tf32)
        return real_einsum(eq, *ops)

    monkeypatch.setattr(torch.Tensor, "__matmul__", mm)
    monkeypatch.setattr(torch, "einsum", einsum)
    try:
        m.allow_tf32 = True
        d = th.int_diag.clone().requires_grad_(True)
        s = tsesolve(th._replace(int_diag=d), torch_cplx(*psi), tg, solver="KRYLOV_SE_F32",
                     krylov_dim=6)
        n_fwd = len(seen)
        (s.re.double() ** 2).sum().backward()
        assert m.allow_tf32 is True
    finally:
        m.allow_tf32 = False
    assert n_fwd > 0 and len(seen) > n_fwd and set(seen) == {False}
    assert bool(torch.isfinite(d.grad).all())


def test_twelve_atom_f32_distance():
    """chip_smoke.py phase 17's reference: the JAX package's KRYLOV_SE_F32
    value against its KRYLOV_SE value on bench.py's 12-atom model cut to
    132 ns, on the CPU, is the constant the script holds the card to
    (JAX_F32_KRYLOV_DIST, 3x it the bar); and the port's own f32 distance
    on the CPU is within 2x it."""
    import chip_smoke
    from pulser_diff_tpu.model import QuantumModel as JModel
    from pulser_diff_tpu.ops.linalg import _interpolate_sine_np as j_interp_np

    dur, p0 = chip_smoke.P17_DURATION, np.linspace(1.0, 3.0, chip_smoke.N_PARAMS)
    coords = [(chip_smoke.SPACING * (i % 4), chip_smoke.SPACING * (i // 4))
              for i in range(chip_smoke.N_QUBITS)]

    def seq(core):
        s = core.Sequence(core.Register.from_coordinates(coords, prefix="q"), core.MockDevice)
        s.declare_channel("ryd", "rydberg_global")
        amp = s.declare_variable("amp_samples", size=dur)
        s.add(core.Pulse(core.CustomWaveform(amp, duration=dur),
                         core.ConstantWaveform(dur, chip_smoke.DET0), 0.0), "ryd")
        return s

    import pulser_diff_tpu.core as jcore

    Mj = jnp.asarray(j_interp_np(chip_smoke.N_PARAMS, dur))
    jv = {}
    for solver in ("KRYLOV_SE", "KRYLOV_SE_F32"):
        m = JModel(seq(jcore), {"amp_samples": ((jnp.asarray(p0),), lambda v: Mj @ v)},
                   sampling_rate=chip_smoke.SAMPLING_RATE, evaluation_times="Minimal",
                   solver=solver)
        jv[solver] = float(m.expectation_fn()({"amp_samples_0": jnp.asarray(p0)})[1][-1])
    d_jax = abs(jv["KRYLOV_SE_F32"] - jv["KRYLOV_SE"])
    assert abs(d_jax - chip_smoke.JAX_F32_KRYLOV_DIST) < 1e-2 * d_jax
    tv = {}
    for solver in ("KRYLOV_SE", "KRYLOV_SE_F32"):
        m, _ = chip_smoke._bench_model(torch, "cpu", None, duration=dur, solver=solver)
        with torch.no_grad():
            tv[solver] = float(m.expectation_fn()({"amp_samples_0": torch.tensor(p0)})[1][-1])
    assert abs(tv["KRYLOV_SE"] - jv["KRYLOV_SE"]) < 1e-10
    assert abs(tv["KRYLOV_SE_F32"] - tv["KRYLOV_SE"]) <= 2 * d_jax + 1e-7

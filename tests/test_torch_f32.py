"""PyTorch port vs the JAX package: the f32 stepper modes ``DP5_SE_F32`` /
``RK4_SE_F32`` (pulser_diff_torch.solvers.solver: ``_cast_ham``, the f32
branch of ``sesolve``; pulser_diff_torch.ops.apply: the pinned f32
products) and their route at dim >= 2^18 (``TorchEmulator._solve_states``).

Both packages run the same steppers on an f32 copy of the Hamiltonian,
the state and the grid times, and take the stream sample index in f32.
They sum the products in another order, so states and gradients agree to
f32 roundoff random-walked over the grid, with the tolerances below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.ops.apply import interp_streams as j_interp
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_tpu.solvers import solver as jsolver
from pulser_diff_torch import TorchEmulator, backend
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.core import ConstantWaveform, MockDevice, Pulse, Register, Sequence
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import apply as tapply
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import solver as tsolver

from tests.test_torch_solver import _setup
from tests.torch_port_cases import (
    batched, factored_fields, jax_cplx, kron_fields, random_state, to_numpy, torch_cplx,
    xy_emulators,
)

torch.set_num_threads(1)

# states (unit norm) against the JAX package's same mode: observed 4.2e-7
# (DP5) and 2.4e-7 (RK4) at 3 atoms over 62 steps
STATE_TOL = 2e-6
# gradients against the JAX package's: relative to the largest entry of
# each gradient (observed below 2e-6)
GRAD_REL_TOL = 2e-5
# the f32 modes against the port's own f64 stepper (observed 3.9e-7)
F64_STATE_TOL = 2e-6


def _xy_setup():
    """3 atoms XY with an in-plane field (kron pairs), both packages."""
    jsim, _ = xy_emulators(3, duration=60, seed=9, field=(1.0, 1.0, 0.0),
                           evaluation_times="Full")
    h = jsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    f, k = factored_fields(h._ham_data), kron_fields(h._ham_data)
    th = factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]),
        kron_row=k["kron_row"], kron_col=k["kron_col"],
        kron_streams=(k["kron_streams_re"], k["kron_streams_im"]), device="cpu",
    )
    psi = batched(random_state(da * db, 1, seed=3), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array)
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu")
    return h._ham_data, th, psi, jg, tg


def _case(kind):
    return _setup(3, 2, "Full") if kind == "ising" else _xy_setup()


@pytest.mark.parametrize("kind", ["ising", "xy"])
@pytest.mark.parametrize("solver", ["DP5_SE_F32", "RK4_SE_F32"])
def test_f32_states_match_jax_and_f64(solver, kind):
    jh, th, psi, jg, tg = _case(kind)
    js = jsolver.sesolve(jh, jax_cplx(*psi), jg, solver=solver, substeps=2)
    ts = tsolver.sesolve(th, torch_cplx(*psi), tg, solver=solver, substeps=2)
    t64 = tsolver.sesolve(th, torch_cplx(*psi), tg, solver=solver[:-4], substeps=2)
    assert ts.re.dtype == torch.float32 and ts.shape == tuple(js.re.shape)
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(to_numpy(ts.re), to_numpy(t64.re), rtol=0, atol=F64_STATE_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), to_numpy(t64.im), rtol=0, atol=F64_STATE_TOL)


@pytest.mark.parametrize("kind", ["ising", "xy"])
@pytest.mark.parametrize("solver", ["DP5_SE_F32", "RK4_SE_F32"])
def test_f32_gradients_match_jax(solver, kind):
    """A weighted population loss over every state, differentiated in f64
    leaves (a row stream, the diagonal, the initial state, and with kron
    pairs the kron part matrices) through the f32 casts."""
    jh, th, psi, jg, tg = _case(kind)
    w = np.random.default_rng(7).normal(size=(jg.n_eval,) + psi[0].shape)
    kron = jh.kron_row is not None

    def jloss(rs_re, diag, p_re, *kr):
        h = jh._replace(row_streams=JCplx(rs_re, jh.row_streams.im), int_diag=diag,
                        **({"kron_row": kr[0]} if kron else {}))
        s = jsolver.sesolve(h, JCplx(p_re, jnp.asarray(psi[1])), jg, solver=solver, substeps=2)
        return jnp.sum(jnp.asarray(w) * (s.re**2 + s.im**2))

    jargs = (jh.row_streams.re, jh.int_diag, jnp.asarray(psi[0])) + ((jh.kron_row,) if kron else ())
    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)

    leaves = [th.row_streams.re.clone().requires_grad_(True),
              th.int_diag.clone().requires_grad_(True),
              torch.as_tensor(psi[0]).clone().requires_grad_(True)]
    if kron:
        leaves.append(th.kron_row.clone().requires_grad_(True))
    h = th._replace(row_streams=Cplx(leaves[0], th.row_streams.im), int_diag=leaves[1],
                    **({"kron_row": leaves[3]} if kron else {}))
    s = tsolver.sesolve(h, Cplx(leaves[2], torch.as_tensor(psi[1])), tg, solver=solver,
                        substeps=2)
    tval = (torch.as_tensor(w) * (s.re.double() ** 2 + s.im.double() ** 2)).sum()
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) < STATE_TOL * abs(float(jval)) * 10
    for leaf, jgr in zip(leaves, jgrads):
        assert leaf.grad.dtype == torch.float64
        jgr = np.asarray(jgr)
        err = np.abs(to_numpy(leaf.grad) - jgr).max() / np.abs(jgr).max()
        assert err < GRAD_REL_TOL, err


def test_sample_boundary_index_is_taken_in_f32():
    """Grid times on the stream samples' boundaries, where the f32 index
    t / dt falls on the other side of an integer than the f64 one: the
    port interpolates with the f32 index, as the JAX package does, to
    the bit."""
    jh, th, _, _, _ = _setup(3, 1, "Minimal")
    dt = float(jh.sample_dt)
    ks = np.arange(int(jh.n_samples))
    t64 = ks * dt
    t32 = t64.astype(np.float32)
    idx32 = np.floor(t32 / np.float32(dt))
    flips = ks[idx32 != np.floor(t64 / dt)]
    assert flips.size > 0  # the grid exercises the boundary
    t = np.concatenate([t32, t32[flips] + np.float32(dt) / 2])
    jz = j_interp(jsolver._cast_ham(jh, jnp.float32), jnp.asarray(t))
    tz = tapply.interp_streams(tsolver._cast_ham(th, torch.float32), torch.as_tensor(t))
    for j, tt in zip(jz[:2], tz[:2]):
        assert tt.re.dtype == torch.float32
        np.testing.assert_array_equal(to_numpy(tt.re), np.asarray(j.re))
        np.testing.assert_array_equal(to_numpy(tt.im), np.asarray(j.im))
    # and a solve on a grid through those times
    # (only the last grid point writes a state)
    slots = np.full(int(flips[0]) + 3, 1, np.int32)
    slots[-1] = 0
    jg = JGrid(times=jnp.asarray(t64[: slots.size]), write_slots=slots, n_eval=1)
    tg = TGrid(times=torch.as_tensor(t64[: slots.size]), write_slots=slots, n_eval=1)
    psi = batched(random_state(th.dim, 1, seed=1), th.da, th.db)
    js = jsolver.sesolve(jh, jax_cplx(*psi), jg, solver="DP5_SE_F32")
    ts = tsolver.sesolve(th, torch_cplx(*psi), tg, solver="DP5_SE_F32")
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=STATE_TOL)


@pytest.mark.parametrize("setting", ["legacy", "per-backend"])
def test_f32_products_are_pinned(monkeypatch, setting):
    """Every f32 product of a value-and-gradient solve, forward and
    backward, runs with TF32 off for cuBLAS (``allow_tf32`` False, what
    cuBLAS reads) though the caller allowed it, through either of
    PyTorch's switches; the caller's setting is restored; no f32 einsum is
    left to the global setting."""
    m = torch.backends.cuda.matmul
    _, th, psi, _, tg = _xy_setup()
    seen, real_einsum = [], torch.einsum

    def spied(real):
        # the products: @, and the mm / bmm that apply._matmul calls
        def product(a, b):
            if a.dtype == torch.float32:
                seen.append(m.allow_tf32)
            return real(a, b)
        return product

    def einsum(eq, *ops):
        assert all(o.dtype != torch.float32 for o in ops), eq
        return real_einsum(eq, *ops)

    for owner, name in ((torch.Tensor, "__matmul__"), (torch, "mm"), (torch, "bmm")):
        monkeypatch.setattr(owner, name, spied(getattr(owner, name)))
    monkeypatch.setattr(torch, "einsum", einsum)
    prev = m.fp32_precision
    try:
        if setting == "legacy":
            m.allow_tf32 = True
        else:
            m.fp32_precision = "tf32"
        user = m.fp32_precision
        d = th.int_diag.clone().requires_grad_(True)
        s = tsolver.sesolve(th._replace(int_diag=d), torch_cplx(*psi), tg, solver="DP5_SE_F32")
        n_fwd = len(seen)
        (s.re.double() ** 2).sum().backward()
        assert m.fp32_precision == user == "tf32"
        if setting == "legacy":
            assert m.allow_tf32 is True
    finally:
        m.allow_tf32 = False
        m.fp32_precision = prev
    assert n_fwd > 0 and len(seen) > n_fwd and set(seen) == {False}
    assert bool(torch.isfinite(d.grad).all())


class _Routed(Exception):
    pass


def _emulator(n_atoms: int) -> TorchEmulator:
    """bench.py's lattice at ``n_atoms``, one short pulse, built on the CPU
    and then marked as a CUDA emulator (no tensor moves: the stubs below
    stop every solve before it runs)."""
    reg = Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n_atoms)], prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse(ConstantWaveform(20, 1.0), ConstantWaveform(20, -2.0), 0.0), "ryd")
    return TorchEmulator.from_sequence(seq, sampling_rate=0.25, evaluation_times="Minimal",
                                       device="cpu")


def _route(monkeypatch, sim: TorchEmulator, cuda: bool = True, **opts):
    """(stepper solver or "fused", ckpt) that _solve_states picks."""
    seen = {}

    def stub_se(ham, psi0, grid, solver="DP5_SE", substeps=1, **kw):
        seen.update(route=solver)
        raise _Routed

    def stub_fused(ham, psi0, grid, method="DP5", ckpt=False):
        seen.update(route="fused", ckpt=ckpt)
        raise _Routed

    monkeypatch.setattr(backend, "sesolve", stub_se)
    monkeypatch.setattr(backend, "evolve_states", stub_fused)
    if cuda:
        monkeypatch.setattr(sim, "torch_device", torch.device("cuda"))
    h = sim._hamiltonian
    grid = TGrid.make(h.sampling_times, sim._eval_times_array, device="cpu")
    with pytest.raises(_Routed):
        sim._solve_states(h._ham_data, "DP5_SE", 1, grid, solver_opts=opts)
    return seen.get("route"), seen.get("ckpt")


@pytest.mark.parametrize(
    "n_atoms, cuda, opts, route",
    [(18, True, {}, ("DP5_SE_F32", None)),
     (18, True, {"fused": False}, ("DP5_SE", None)),
     (18, True, {"fused": True}, ("fused", True)),
     (17, True, {}, ("fused", True)),
     (18, False, {}, ("DP5_SE", None))],
    ids=["18-atoms-f32", "18-atoms-fused-False-f64", "18-atoms-fused-True-K4K5",
         "17-atoms-K4K5", "18-atoms-cpu-f64"],
)
def test_route_from_the_cap(monkeypatch, n_atoms, cuda, opts, route):
    """On CUDA from dim 2^18 DP5_SE takes the f32 stepper, as the JAX
    package does; fused=False keeps f64 and fused=True the fused kernels
    (K4/K5, which have no shared-memory ceiling); below the cap the fused
    kernels; on the CPU nothing reroutes."""
    assert _route(monkeypatch, _emulator(n_atoms), cuda, **opts) == route

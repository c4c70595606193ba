"""PyTorch port vs the JAX package: the runs axis (R > 1) of the fused
kernels, ``evolve_mc`` (pulser_diff_torch.ops.fused_evolution:
``prepare_mc_inputs``, ``evolve_mc``) against ``pallas_evolve_mc``.

R Hamiltonians of one register geometry and one grid (another pulse, and
another spacing or another jitter of the XY coordinates, per run) are
staged on the runs axis and evolved in one call: K1/K2, or K4/K5 with
``ckpt=True``.  The JAX side runs its Pallas kernels in interpret mode;
on the CPU the port runs the kernels' plain versions.  Each run equals an
R = 1 call on its own inputs, and each per-run input gets its own
gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
from pulser_diff_tpu.backend import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.test_torch_fused import K1_TOL, K2_REL_TOL
from tests.torch_port_cases import (
    batched, factored_fields, kron_fields, pulse_samples, random_state, to_numpy, xy_sequence,
)

torch.set_num_threads(1)

# (label, atoms, runs, per-run psi0, ckpt, xy, tableau)
CASES = [
    ("ising-2at-R3-shared", 2, 3, False, False, False, "DP5"),
    ("ising-3at-R2-perrun-ckpt", 3, 2, True, True, False, "RK4"),
    ("xy-3at-R2-shared", 3, 2, False, False, True, "DP5"),
    ("xy-2at-R2-perrun-ckpt", 2, 2, True, True, True, "DP5"),
]


def _ising_sequence(core, n_atoms: int, run: int):
    """One rydberg_global pulse of run ``run``'s amplitude and detuning, on
    a two-column lattice spaced 6 + 0.5 run um (its own interaction)."""
    amp, det = pulse_samples(48, 60 + run)
    reg = core.Register.from_coordinates(
        [((6.0 + 0.5 * run) * (i % 2), (6.0 + 0.5 * run) * (i // 2)) for i in range(n_atoms)],
        prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse(core.CustomWaveform(amp), core.CustomWaveform(det), 0.4), "ryd")
    return seq


def _port_ham(jham):
    f = factored_fields(jham)
    kw = {}
    if jham.kron_row is not None:
        k = kron_fields(jham)
        kw = dict(kron_row=k["kron_row"], kron_col=k["kron_col"],
                  kron_streams=(k["kron_streams_re"], k["kron_streams_im"]))
    return factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]),
        device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _case(case):
    """JAX Hamiltonians of every run, the grid, psi0 (numpy)."""
    _, n, R, per_run, _, xy, _ = case
    jhams = []
    for r in range(R):
        seq = (xy_sequence(jcore, n, duration=48, seed=70 + r, field=(1.0, 1.0, 0.0)) if xy
               else _ising_sequence(jcore, n, r))
        sim = TpuEmulator.from_sequence(seq, sampling_rate=0.5, evaluation_times=0.5)
        jhams.append(sim._hamiltonian._ham_data)
    h = sim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    states = [batched(random_state(da * db, 1, seed=5 + r), da, db) for r in range(R)]
    psi = (np.stack([s[0] for s in states]), np.stack([s[1] for s in states])) if per_run \
        else states[0]
    return jhams, h.sampling_times, sim._eval_times_array, psi


@functools.lru_cache(maxsize=None)
def _jax_mc(case):
    """JAX's states and the gradient of a weighted loss in each run's row
    stream, diagonal and (XY) kron row matrices, and per-run psi0."""
    _, _, R, per_run, ckpt, xy, method = case
    jhams, st, et, psi = _case(case)
    grid = JGrid.make(st, et)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *jhams)

    def fwd(rs_re, diag, kr, p_re):
        hams = stacked._replace(row_streams=JCplx(rs_re, stacked.row_streams.im), int_diag=diag,
                                **({"kron_row": kr} if xy else {}))
        s = jpe.pallas_evolve_mc(hams, JCplx(p_re, jnp.asarray(psi[1])), grid, method=method,
                                 interpret=True, ckpt=ckpt)
        return s

    args = (stacked.row_streams.re, stacked.int_diag,
            stacked.kron_row if xy else jnp.zeros(()), jnp.asarray(psi[0]))
    s, vjp = jax.vjp(fwd, *args)
    rng = np.random.default_rng(11)
    w = (rng.normal(size=s.re.shape), rng.normal(size=s.im.shape))
    grads = vjp(JCplx(jnp.asarray(w[0], s.re.dtype), jnp.asarray(w[1], s.im.dtype)))
    return (np.asarray(s.re), np.asarray(s.im)), w, [np.asarray(g) for g in grads]


def _port_mc(case, runs=None):
    """The port's evolve_mc on the same inputs (``runs``: a subset), its
    states and the same loss's per-run leaf gradients."""
    _, _, R, per_run, ckpt, xy, method = case
    jhams, st, et, psi = _case(case)
    runs = list(range(R)) if runs is None else runs
    grid = TGrid.make(st, et, device="cpu").refined(1)
    hams, leaves = [], []
    for r in runs:
        th = _port_ham(jhams[r])
        lv = [th.row_streams.re.clone().requires_grad_(True),
              th.int_diag.clone().requires_grad_(True)]
        if xy:
            lv.append(th.kron_row.clone().requires_grad_(True))
        hams.append(th._replace(row_streams=Cplx(lv[0], th.row_streams.im), int_diag=lv[1],
                                **({"kron_row": lv[2]} if xy else {})))
        leaves.append(lv)
    p_re = torch.as_tensor(psi[0][runs] if per_run else psi[0]).requires_grad_(True)
    p_im = torch.as_tensor(psi[1][runs] if per_run else psi[1])
    s = tfe.evolve_mc(hams, Cplx(p_re, p_im), grid, method=method, ckpt=ckpt)
    return s, hams, leaves, p_re


def _backward(s, w, runs):
    loss = (torch.as_tensor(w[0][runs]) * s.re.double()).sum() + \
        (torch.as_tensor(w[1][runs]) * s.im.double()).sum()
    loss.backward()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_evolve_mc_matches_pallas_evolve_mc(case):
    """States at K1's / K4's parity (test_torch_fused.py, test_torch_ckpt.py)
    and the gradient of every per-run input within K2's relative bar."""
    _, _, R, per_run, _, xy, _ = case
    (j_re, j_im), w, jgrads = _jax_mc(case)
    s, _, leaves, p_re = _port_mc(case)
    assert tuple(s.re.shape) == j_re.shape and s.re.shape[0] == R
    np.testing.assert_allclose(to_numpy(s.re), j_re, rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(s.im), j_im, rtol=0, atol=K1_TOL)
    _backward(s, w, list(range(R)))
    names = ["row_streams.re", "int_diag"] + (["kron_row"] if xy else [])
    for i, name in enumerate(names):
        got = np.stack([to_numpy(lv[i].grad) for lv in leaves])
        assert _rel(got, jgrads[i]) < K2_REL_TOL, name
    # per-run psi0: one cotangent per run; shared: the sum over the runs
    assert p_re.grad.shape == jgrads[3].shape
    assert _rel(to_numpy(p_re.grad), jgrads[3]) < K2_REL_TOL


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_run_equals_its_own_call(case):
    """Runs share nothing: each run's states and per-run gradients are an
    R = 1 call's on the same inputs, bit for bit."""
    _, _, R, per_run, _, _, _ = case
    _, w, _ = _jax_mc(case)
    s, _, leaves, _ = _port_mc(case)
    _backward(s, w, list(range(R)))
    for r in range(R):
        s1, _, leaves1, p1 = _port_mc(case, [r])
        assert torch.equal(s1.re[0], s.re[r]) and torch.equal(s1.im[0], s.im[r])
        _backward(s1, w, [r])
        for a, b in zip(leaves1[0], leaves[r]):
            assert torch.equal(a.grad, b.grad)


def test_staging_shares_run_zero_and_checks_shapes():
    """The shared keys come from run 0 (as pallas_evolve_mc takes them),
    the per-run keys are stacked, a shared psi0 is broadcast."""
    case = CASES[0]
    jhams, st, et, psi = _case(case)
    hams = [_port_ham(h) for h in jhams]
    grid = TGrid.make(st, et, device="cpu")
    data = tfe.prepare_mc_inputs(hams, Cplx(torch.as_tensor(psi[0]), torch.as_tensor(psi[1])),
                                 grid.times, "DP5")
    R = len(hams)
    one = [tfe.prepare_fused_inputs(h, Cplx(torch.as_tensor(psi[0]), torch.as_tensor(psi[1])),
                                    grid.times, "DP5") for h in hams]
    for k, v in data.items():
        if k in ("rp", "cp", "hb_hi", "hb_lo", "hs"):
            assert torch.equal(v, one[0][k]), k
        else:
            assert v.shape[0] == R and all(torch.equal(v[r], one[r][k][0]) for r in range(R)), k
    tfe._check_shapes(data, 6)
    with pytest.raises(ValueError, match="wrong shape"):
        tfe._check_shapes({**data, "diag": data["diag"][:1]}, 6)

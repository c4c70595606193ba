"""PyTorch port vs the JAX package: the f64 stepper
(pulser_diff_torch.solvers.sesolve) and its autograd gradients.

Both sides integrate in f64 with the same tableau, grid and operation
order; their states and gradients agree to 1e-10 (f64 roundoff over a
few hundred stages, far below the solver's own truncation error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_tpu.solvers import sesolve as jsesolve
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import sesolve as tsesolve

from tests.torch_port_cases import (
    batched, emulators, factored_fields, jax_cplx, random_state, to_numpy, torch_cplx,
)

torch.set_num_threads(1)

F64_TOL = 1e-10


def _setup(n_atoms, nb, eval_times, duration=60):
    jsim, _ = emulators(n_atoms, duration=duration, seed=20 + n_atoms,
                        evaluation_times=eval_times)
    h = jsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    f = factored_fields(h._ham_data)
    th = factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]), device="cpu",
    )
    psi = batched(random_state(da * db, nb, seed=n_atoms), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array)
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu")
    return h._ham_data, th, psi, jg, tg


@pytest.mark.parametrize("solver", ["DP5_SE", "RK4_SE"])
@pytest.mark.parametrize("n_atoms,nb,eval_times", [(3, 2, "Full"), (4, 1, 0.5)])
def test_sesolve_states_match_jax(solver, n_atoms, nb, eval_times):
    jh, th, psi, jg, tg = _setup(n_atoms, nb, eval_times)
    js = jsesolve(jh, jax_cplx(*psi), jg, solver=solver, substeps=2)
    ts = tsesolve(th, torch_cplx(*psi), tg, solver=solver, substeps=2)
    assert ts.shape == tuple(js.re.shape)
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=F64_TOL)


def test_sesolve_gradients_match_jax():
    """Gradients of a weighted population loss over every evaluation
    state w.r.t. the coefficient streams, the interaction diagonal and
    the initial state."""
    jh, th, psi, jg, tg = _setup(3, 1, "Full")
    w = np.random.default_rng(3).normal(size=(jg.n_eval, 1) + psi[0].shape[1:])

    def jloss(rs_re, cs_im, diag, p_re):
        h = jh._replace(row_streams=JCplx(rs_re, jh.row_streams.im),
                        col_streams=JCplx(jh.col_streams.re, cs_im), int_diag=diag)
        s = jsesolve(h, JCplx(p_re, jnp.asarray(psi[1])), jg, substeps=2)
        return jnp.sum(jnp.asarray(w) * (s.re**2 + s.im**2))

    jargs = (jh.row_streams.re, jh.col_streams.im, jh.int_diag, jnp.asarray(psi[0]))
    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(*jargs)

    leaves = [th.row_streams.re.clone().requires_grad_(True),
              th.col_streams.im.clone().requires_grad_(True),
              th.int_diag.clone().requires_grad_(True),
              torch.as_tensor(psi[0]).requires_grad_(True)]
    h = th._replace(row_streams=Cplx(leaves[0], th.row_streams.im),
                    col_streams=Cplx(th.col_streams.re, leaves[1]), int_diag=leaves[2])
    s = tsesolve(h, Cplx(leaves[3], torch.as_tensor(psi[1])), tg, substeps=2)
    tval = (torch.as_tensor(w) * (s.re**2 + s.im**2)).sum()
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) < F64_TOL
    for leaf, jgr in zip(leaves, jgrads):
        np.testing.assert_allclose(to_numpy(leaf.grad), np.asarray(jgr), rtol=0, atol=F64_TOL)

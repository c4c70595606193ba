"""PyTorch port vs the JAX package: the final-state form of the fused
kernels, ``fused_evolve`` and ``pallas_evolve``
(pulser_diff_torch.ops.fused_evolution).

``pallas_evolve`` returns only the final state: through K1 with a slot
table in which only the last grid point carries a slot (K2 then takes
that slot's cotangent alone and rebuilds every earlier step), or with
``ckpt=True`` the last step of K4/K5.  On the CPU the kernels' plain
versions run; the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py calls them.  The tolerances are those
tests/test_torch_fused.py holds K1/K2 to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import fused_evolution as tfe

from tests.test_torch_fused import K1_TOL, K2_REL_TOL
from tests.torch_port_cases import (
    emulators, factored_fields, kron_fields, to_numpy, xy_emulators,
)

torch.set_num_threads(1)


def _case(xy: bool):
    """(JAX ham, port ham, psi0 (1, da, db) as numpy re/im, grid times):
    3 atoms ising over 24 ns, or 3 atoms XY over 16 ns with an in-plane
    field."""
    if xy:
        jsim, _ = xy_emulators(3, duration=16, seed=4, field=(1.0, 1.0, 0.0))
    else:
        jsim, _ = emulators(3, duration=24, seed=8)
    h = jsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    f = factored_fields(h._ham_data)
    kron = {}
    if xy:
        k = kron_fields(h._ham_data)
        kron = dict(kron_row=k["kron_row"], kron_col=k["kron_col"],
                    kron_streams=(k["kron_streams_re"], k["kron_streams_im"]))
    th = factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]),
        device="cpu", **kron,
    )
    psi = jsim.initial_state
    re = np.asarray(psi.re).T.reshape(1, da, db)
    im = np.asarray(psi.im).T.reshape(1, da, db)
    times = np.asarray(JGrid.make(h.sampling_times, jsim._eval_times_array).times)
    return h._ham_data, th, (re, im), times


def _max_rel(got, want) -> float:
    got, want = to_numpy(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _loss_and_grads(xy: bool, ckpt: bool, method: str):
    """Both packages' final state and the gradient of sum(re^2 - im) of it
    in the row streams' real part, the interaction diagonal and (XY) the
    kron part matrices."""
    jh, th, (re, im), times = _case(xy)
    jpsi = JCplx(jnp.asarray(re), jnp.asarray(im))

    def jloss(s_re, diag, *kr):
        h = jh._replace(row_streams=JCplx(s_re, jh.row_streams.im), int_diag=diag,
                        **({"kron_row": kr[0]} if kr else {}))
        out = jpe.pallas_evolve(h, jpsi, jnp.asarray(times), method, interpret=True, ckpt=ckpt)
        return jnp.sum(out.re ** 2 - out.im), out

    jargs = (jh.row_streams.re, jh.int_diag) + ((jh.kron_row,) if xy else ())
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(jargs))),
                                           has_aux=True)(*jargs)
    leaves = [th.row_streams.re.clone().requires_grad_(True),
              th.int_diag.clone().requires_grad_(True)]
    if xy:
        leaves.append(th.kron_row.clone().requires_grad_(True))
    h = th._replace(row_streams=Cplx(leaves[0], th.row_streams.im), int_diag=leaves[1],
                    **({"kron_row": leaves[2]} if xy else {}))
    tout = tfe.pallas_evolve(h, Cplx(torch.tensor(re), torch.tensor(im)), torch.tensor(times),
                             method, ckpt=ckpt)
    (tout.re.double() ** 2 - tout.im.double()).sum().backward()
    return jout, tout, jgrads, [x.grad for x in leaves]


@pytest.mark.parametrize("method,ckpt", [("DP5", False), ("RK4", False), ("DP5", True)])
def test_pallas_evolve_matches_jax(method, ckpt):
    """The final state (K1_TOL) and its gradient (K2_REL_TOL of each
    gradient's largest entry) against JAX's interpret-mode pallas_evolve."""
    jout, tout, jgrads, tgrads = _loss_and_grads(False, ckpt, method)
    assert tout.re.shape == jout.re.shape and tout.re.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(tout.re), np.asarray(jout.re), rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(tout.im), np.asarray(jout.im), rtol=0, atol=K1_TOL)
    for got, want in zip(tgrads, jgrads):
        assert _max_rel(got, want) < K2_REL_TOL


def test_pallas_evolve_xy_matches_jax():
    """With kron pairs (K3): the final state (the port's two-word state,
    as evolve_states returns it) and the gradients in the streams, the
    diagonal and the kron part matrices, against JAX's."""
    jout, tout, jgrads, tgrads = _loss_and_grads(True, False, "DP5")
    np.testing.assert_allclose(to_numpy(tout.re), np.asarray(jout.re), rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(tout.im), np.asarray(jout.im), rtol=0, atol=K1_TOL)
    assert len(tgrads) == 3
    for got, want in zip(tgrads, jgrads):
        assert float(np.abs(np.asarray(want)).max()) > 0
        assert _max_rel(got, want) < K2_REL_TOL


def test_final_state_is_the_last_slot_of_the_states_form():
    """fused_evolve's state equals the last evaluation slot of
    fused_evolve_states on the same inputs bit for bit; with ckpt=True the
    final state (K4's last step) is the same."""
    _, th, (re, im), times = _case(False)
    psi = Cplx(torch.tensor(re), torch.tensor(im))
    data = tfe.prepare_fused_inputs(th, psi, torch.tensor(times), "DP5")
    n_steps = int(data["hs"].shape[0])
    slots = torch.zeros(n_steps + 1, dtype=torch.int32)
    slots[1:] = torch.arange(1, n_steps + 1, dtype=torch.int32)
    fin = tfe.fused_evolve("DP5", data)
    st = tfe.fused_evolve_states("DP5", slots, n_steps + 1, n_steps, data)
    np.testing.assert_array_equal(to_numpy(fin[0]), to_numpy(st[0][:, -1]))
    np.testing.assert_array_equal(to_numpy(fin[1]), to_numpy(st[1][:, -1]))
    ck = tfe.pallas_evolve(th, psi, torch.tensor(times), "DP5", ckpt=True)
    np.testing.assert_array_equal(to_numpy(ck.re), to_numpy(fin[0][0]))

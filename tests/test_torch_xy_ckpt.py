"""PyTorch port vs the JAX package: the kron-pair (XY) branch of the
checkpointed kernels K4/K5 (``fused_fwd_ckpt`` / ``fused_bwd_ckpt`` with
kron pairs, ``evolve_states(ckpt=True)``, ``QuantumModel(ckpt=True)``).

The JAX side runs its Pallas kernels in interpret mode (the oracle of
tests/test_pallas.py::test_pallas_ckpt_adjoint_xy_kron); the tolerances
are those of tests/test_torch_fused.py.  K4's plain version shares K1's
step body, so their states agree bit for bit at the evaluation slots,
low words included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.test_torch_xy import (
    GRAD_BAR, IN_PLANE, VALUE_BAR, _port_hamiltonian, _port_xy_value_grad,
)
from tests.test_torch_xy_fused import (
    CASES, K1_TOL, K2_REL_TOL, _ids, _max_rel, _same_inputs, _setup, _want,
)
from tests.torch_port_cases import batched, random_state, torch_cplx, to_numpy, xy_emulators

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_ckpt(case):
    """JAX fused_evolve_ckpt's stored states, and the custom VJP's
    cotangent dict for random per-step cotangents (numpy)."""
    jdata, _, _, _ = _setup(*case)

    def fwd(d):
        return jpe.fused_evolve_ckpt(case[2], True, d)

    (j_re, j_im), vjp = jax.vjp(fwd, jdata)
    rng = np.random.default_rng(200 + case[0])
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    return ({k: np.asarray(v) for k, v in jdata.items()}, (np.asarray(j_re), np.asarray(j_im)),
            lam, {k: np.asarray(v) for k, v in jcot.items()})


@pytest.mark.parametrize("case", CASES[:2], ids=_ids)
def test_xy_ckpt_plain_match_pallas_interpret(case):
    """K4's plain version with kron pairs against the checkpointed forward
    Pallas kernel (every step's state), and K5's (lam0, every zbar column,
    dbar, krbar, kcbar) against the JAX custom VJP."""
    method = case[2]
    jdata, (j_re, j_im), (lam_re, lam_im), jcot = _jax_ckpt(case)
    tdata = _same_inputs(jdata)
    t_re, t_im = tfe.fused_fwd_ckpt(tdata, method)
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=K1_TOL)
    outs = tfe.fused_bwd_ckpt(tdata, method, torch.tensor(j_re), torch.tensor(j_im),
                              torch.tensor(lam_re), torch.tensor(lam_im))
    pr, pc = int(tdata["rp"].shape[0]), int(tdata["cp"].shape[0])
    zrr, zri, zcr, zci = tfe._unpack_zbar(outs[2], pr, pc)
    zkr, zki = tfe._unpack_zbar_kron(outs[2], pr, pc)
    pairs = {
        "psi_re": outs[0], "psi_im": outs[1], "diag": outs[3], "kr": outs[4], "kc": outs[5],
        "zrh_re": zrr, "zrh_im": zri, "zch_re": zcr, "zch_im": zci,
        "zkh_re": zkr, "zkh_im": zki,
    }
    for k, got in pairs.items():
        want = _want(jcot, k)
        assert tuple(got.shape) == want.shape, k
        assert _max_rel(got, want) < K2_REL_TOL, (k, _max_rel(got, want))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_xy_k4_plain_equals_k1_plain_at_the_slots(case):
    """K4's and K1's plain versions step through one body: with kron pairs
    their states, low words included, agree bit for bit at every slot."""
    _, tdata, slots, n_eval = _setup(*case)
    tdata = {k: v.detach() for k, v in tdata.items()}
    k1 = tfe.fused_fwd(tdata, case[2], torch.tensor(slots, dtype=torch.int32), n_eval, lo=True)
    k4 = tfe.fused_fwd_ckpt(tdata, case[2], lo=True)
    for g, s in enumerate(slots):
        if 0 < g and s < n_eval:
            for a, b in zip(k4, k1):
                assert torch.equal(a[:, g - 1], b[:, s]), (g, s)


def test_xy_ckpt_states_and_kron_grads_match_non_ckpt():
    """evolve_states(ckpt=True) with kron pairs: the same two-word states
    as the default path bit for bit, and the gradients with respect to the
    kron part matrices within the K2 tolerance (1e-4 of the largest): K2
    rebuilds the start states between slots by the mirror reconstruction,
    whose f32 error K5, reading exact stored states, does not have."""
    jsim, _ = xy_emulators(4, duration=30, seed=11, field=IN_PLANE, evaluation_times=0.5)
    h = jsim._hamiltonian
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu")
    th = _port_hamiltonian(h._ham_data)
    re, im = batched(random_state(16, 1, seed=4), th.da, th.db)
    w = torch.as_tensor(np.random.default_rng(6).normal(size=(tg.n_eval, 1, th.da, th.db)))
    states, grads = {}, {}
    for ckpt in (True, False):
        kr = th.kron_row.clone().requires_grad_(True)
        kc = th.kron_col.clone().requires_grad_(True)
        out = tfe.evolve_states(th._replace(kron_row=kr, kron_col=kc), torch_cplx(re, im), tg,
                                "DP5", ckpt=ckpt)
        ((out.re * w).sum() + (out.im**2).sum()).backward()
        states[ckpt], grads[ckpt] = out, (to_numpy(kr.grad), to_numpy(kc.grad))
    assert states[True].re.dtype == torch.float64
    assert torch.equal(states[True].re, states[False].re)
    assert torch.equal(states[True].im, states[False].im)
    for a, b in zip(grads[True], grads[False]):
        assert np.abs(b).max() > 1e-3
        assert np.abs(a - b).max() < K2_REL_TOL * np.abs(b).max()


def test_xy_model_ckpt_matches_default_and_f64():
    """bench_xy.py's workload at four atoms through
    QuantumModel(ckpt=True) (K4/K5's plain versions, kron pairs and
    coordinates): within the BASELINE bars of the port's f64 stepper
    (which test_torch_xy.py holds against JAX at 1e-10) and of the default
    fused path (K1/K2, held against JAX there), parameter and coordinate
    gradients alike.  K4/K5 themselves are held against JAX above."""
    before = dict(tfe.LAUNCHES)
    tv, tg, tc, _ = _port_xy_value_grad(solver="DP5_PALLAS", ckpt=True)
    assert tfe.LAUNCHES == before
    for v, g, c, _ in (_port_xy_value_grad(fused=False), _port_xy_value_grad(solver="DP5_PALLAS")):
        assert abs(tv - v) < VALUE_BAR
        np.testing.assert_allclose(tg, g, rtol=0, atol=GRAD_BAR)
        np.testing.assert_allclose(tc, c, rtol=0, atol=GRAD_BAR)
    assert np.abs(tc).max() > 1e-5

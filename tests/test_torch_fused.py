"""PyTorch port vs the JAX package: the fused-kernel host side and the
plain versions of the two CUDA kernels (pulser_diff_torch.ops.fused_evolution).

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does.  The port's plain versions repeat the CUDA
kernels' arithmetic: f32 words, two-word weights, Kahan carries, the
mirror-node reconstruction and the lean adjoint's stage order.  Both
sides then differ only in the summation order inside each product (the
JAX kernel's matmuls against explicit sums), so they agree at f32
roundoff, with the tolerances stated at each check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch.convert import factored_from_numpy
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.torch_port_cases import (
    batched, emulators, factored_fields, jax_cplx, random_state, to_numpy, torch_cplx,
)

torch.set_num_threads(1)

# (atoms, state batch, tableau, evaluation times, substeps).  Two and
# three atoms take the JAX kernel's direct form (da or db < 8), six atoms
# its block-real form (da = db = 8); three atoms have da != db.
CASES = [
    (2, 1, "DP5", "Minimal", 1),
    (3, 2, "DP5", "Full", 1),
    (4, 1, "RK4", 0.5, 2),
    (6, 1, "DP5", "Minimal", 1),
]

# Staged words: both sides compute the same f64 stage values with the
# same operations (bit-identical in practice); allow one f32 ulp on a hi
# word and f64 roundoff on a lo word.
STAGE_RTOL = 2.0**-23
STAGE_ATOL = 1e-14
# K1: unit-norm states after <= ~60 steps of 6-7 stages, each stage's
# sums rounded in another order (~1e-7 each): 1e-5 absolute.
K1_TOL = 1e-5
# K2: every cotangent is a sum of many products; 1e-4 of each output's
# largest magnitude (f32 roundoff of sums over da*db*nb terms, ~60 steps).
K2_REL_TOL = 1e-4


def _setup(n_atoms, nb, method, eval_times, substeps):
    jsim, _ = emulators(n_atoms, duration=48 if n_atoms == 6 else 60, seed=10 + n_atoms,
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
    re, im = batched(random_state(da * db, nb, seed=n_atoms), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array).refined(substeps)
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu").refined(substeps)
    jdata = jpe.prepare_fused_inputs(h._ham_data, jax_cplx(re, im), jg.times, method)
    tdata = tfe.prepare_fused_inputs(th, torch_cplx(re, im), tg.times, method)
    slots = tuple(int(s) for s in np.asarray(jg.write_slots))
    return jdata, tdata, slots, jg.n_eval


def _same_inputs(jdata):
    """The JAX kernel inputs as the port's f32 tensors, bit for bit."""
    return {k: torch.tensor(np.array(v)) for k, v in jdata.items()}


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"{c[0]}at-nb{c[1]}-{c[2]}")
def test_prepare_fused_inputs_match_jax(case):
    jdata, tdata, _, _ = _setup(*case)
    assert set(tdata) == set(jdata)
    for k, jv in jdata.items():
        tv = to_numpy(tdata[k])
        assert tv.shape == jv.shape and tv.dtype == np.float32, k
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=STAGE_RTOL, atol=STAGE_ATOL,
                                   err_msg=k)
    # the nb guard
    big = torch_cplx(*batched(random_state(4, tfe._NB_MAX + 1, 0), 2, 2))
    jsim, tsim = emulators(2, duration=40)
    with pytest.raises(ValueError, match="nb="):
        tfe.prepare_fused_inputs(tsim._hamiltonian._ham_data, big,
                                 TGrid.make(tsim.sampling_times, tsim._eval_times_array, device="cpu").times)


def _max_rel(got, want):
    got, want = to_numpy(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX kernel inputs, its forward states and the custom VJP's
    cotangent dict for random slot cotangents (numpy), per case."""
    method = case[2]
    jdata, _, slots, n_eval = _setup(*case)

    def fwd(d):
        return jpe.fused_evolve_states(method, True, slots, n_eval, slots[-1], d)

    (j_re, j_im), vjp = jax.vjp(fwd, jdata)
    rng = np.random.default_rng(case[0])
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(jdata), slots, n_eval, (np.asarray(j_re), np.asarray(j_im)), lam, as_np(jcot)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}at-nb{c[1]}-{c[2]}")
def test_plain_kernels_match_pallas_interpret(case):
    """K1's plain version against the forward Pallas kernel, and K2's
    plain version (lam0, every unpacked stream cotangent, dbar) against
    the JAX custom VJP, on bit-identical inputs."""
    method = case[2]
    jdata, slots, n_eval, (j_re, j_im), (lam_re, lam_im), jcot = _jax_run(case)
    tdata = _same_inputs(jdata)
    tslots = torch.tensor(slots, dtype=torch.int32)
    t_re, t_im = tfe.fused_fwd(tdata, method, tslots, n_eval)
    assert t_re.shape == j_re.shape
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=K1_TOL)

    # K2 from the JAX forward's stored states, as the JAX VJP runs it
    lam0_re, lam0_im, zbar, dbar = tfe.fused_bwd(
        tdata, method, tslots, n_eval, slots[-1], torch.tensor(j_re), torch.tensor(j_im),
        torch.tensor(lam_re), torch.tensor(lam_im))
    pr, pc = int(tdata["rp"].shape[0]), int(tdata["cp"].shape[0])
    zrr, zri, zcr, zci = tfe._unpack_zbar(zbar, pr, pc)
    pairs = {
        "psi_re": lam0_re, "psi_im": lam0_im, "diag": dbar,
        "zrh_re": zrr, "zrh_im": zri, "zch_re": zcr, "zch_im": zci,
    }
    for k, got in pairs.items():
        assert tuple(got.shape) == jcot[k].shape, k
        assert _max_rel(got, jcot[k]) < K2_REL_TOL, (k, _max_rel(got, jcot[k]))


def test_autograd_function_cotangents_match_jax():
    """The autograd Function hands every data key the cotangent the JAX
    custom VJP hands it: hi and lo words alike, diag and diag_lo both
    dbar, psi lam0, structural inputs zero."""
    case = CASES[1]
    jdata, slots, n_eval, _, lam, jcot = _jax_run(case)
    tdata = {k: v.requires_grad_(True) for k, v in _same_inputs(jdata).items()}
    out_re, out_im = tfe.fused_evolve_states(
        case[2], torch.tensor(slots, dtype=torch.int32), n_eval, slots[-1], tdata)
    loss = (out_re * torch.tensor(lam[0])).sum() + (out_im * torch.tensor(lam[1])).sum()
    loss.backward()
    for k, want in jcot.items():
        got = tdata[k].grad
        if not np.any(want):
            assert got is None or not torch.any(got), k
            continue
        assert _max_rel(got, want) < K2_REL_TOL, k
    torch.testing.assert_close(tdata["zrh_re"].grad, tdata["zrl_re"].grad, rtol=0, atol=0)
    torch.testing.assert_close(tdata["diag"].grad, tdata["diag_lo"].grad, rtol=0, atol=0)


def test_wrappers_launch_or_raise():
    """CPU tensors take the plain version without counting a launch; any
    other device launches its kernel or raises (no fallback).  Inputs the
    kernels would misread (shapes, the tableau, the last slot) raise on
    every device."""
    jdata, slots, n_eval, (j_re, j_im), *_ = _jax_run(CASES[0])
    tdata = _same_inputs(jdata)
    tslots = torch.tensor(slots, dtype=torch.int32)
    before = dict(tfe.LAUNCHES)
    tfe.fused_fwd(tdata, "DP5", tslots, n_eval)
    assert tfe.LAUNCHES == before
    st = torch.tensor(j_re)
    with pytest.raises(ValueError, match="wrong shape"):
        tfe.fused_fwd(dict(tdata, hs=tdata["hs"][:-1]), "DP5", tslots, n_eval)
    with pytest.raises(ValueError, match="wrong shape"):
        tfe.fused_fwd(tdata, "RK4", tslots, n_eval)
    with pytest.raises(ValueError, match="wrong shape"):
        tfe.fused_bwd(tdata, "DP5", tslots, n_eval, slots[-1], st, st, st, st[:, :1])
    with pytest.raises(ValueError, match="last_slot"):
        tfe.fused_bwd(tdata, "DP5", tslots, n_eval, n_eval, st, st, st, st)
    with pytest.raises(ValueError, match="tableau"):
        tfe.fused_fwd(tdata, "DP8", tslots, n_eval)
    meta = {k: v.to("meta") for k, v in tdata.items()}
    with pytest.raises(ValueError, match="No fused kernel"):
        tfe.fused_fwd(meta, "DP5", tslots.to("meta"), n_eval)
    with pytest.raises(ValueError, match="No fused kernel"):
        st = torch.empty((1, n_eval) + tuple(tdata["psi_re"].shape[1:]), device="meta")
        tfe.fused_bwd(meta, "DP5", tslots.to("meta"), n_eval, slots[-1], st, st, st, st)
    assert tfe.LAUNCHES == before

"""PyTorch port vs the JAX package: the checkpointed fused kernels K4/K5
(pulser_diff_torch.ops.fused_evolution: ``fused_fwd_ckpt`` /
``fused_bwd_ckpt``, their autograd Function, ``evolve_states(ckpt=True)``
and the ``ckpt`` run option of ``QuantumModel``).

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does.  On the CPU the port's wrappers run the
kernels' plain versions, which repeat the CUDA kernels' arithmetic.
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
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.test_torch_fused import CASES, K1_TOL, K2_REL_TOL, _max_rel, _same_inputs, _setup
from tests.test_torch_model import (
    FUSED_TOL, GRAD_BAR, VALUE_BAR, _jax_value_grad, _port_model, _port_value_grad,
)
from tests.torch_port_cases import (
    emulators, factored_fields, jax_cplx, to_numpy, torch_cplx,
)

torch.set_num_threads(1)

# the small cases of test_torch_fused.py, plus two runs stacked on the run
# axis (R = 2): the 3-atom case's inputs beside a second amplitude's
CKPT_CASES = [c + (1,) for c in CASES] + [(3, 2, "DP5", "Full", 1, 2)]


def _ids(c):
    return f"{c[0]}at-nb{c[1]}-{c[2]}-R{c[5]}"


def _inputs(case):
    """JAX kernel inputs (R runs) and the grid slots of run 0."""
    n, nb, method, eval_times, substeps, R = case
    jdata, _, slots, n_eval = _setup(n, nb, method, eval_times, substeps)
    if R == 2:
        # a second run: the same register with another pulse (seed), the
        # same grid; the shared keys (parts, step sizes) are equal
        jsim, _ = emulators(n, duration=60, seed=40 + n, evaluation_times=eval_times)
        h = jsim._hamiltonian
        jg = JGrid.make(h.sampling_times, jsim._eval_times_array).refined(substeps)
        other = jpe.prepare_fused_inputs(
            h._ham_data, jax_cplx(np.asarray(jdata["psi_im"][0], np.float64),
                                  np.asarray(jdata["psi_re"][0], np.float64)),
            jg.times, method)
        for k, v in jdata.items():
            if k not in ("rp", "cp", "hb_hi", "hb_lo", "hs"):
                jdata[k] = jnp.concatenate([v, other[k]], axis=0)
    return {k: np.asarray(v) for k, v in jdata.items()}, slots, n_eval


@functools.lru_cache(maxsize=None)
def _jax_ckpt(case):
    """JAX fused_evolve_ckpt's stored states, and the custom VJP's
    cotangent dict for random per-step cotangents (numpy)."""
    method = case[2]
    jdata, slots, n_eval = _inputs(case)

    def fwd(d):
        return jpe.fused_evolve_ckpt(method, True, d)

    (j_re, j_im), vjp = jax.vjp(fwd, {k: jnp.asarray(v) for k, v in jdata.items()})
    rng = np.random.default_rng(100 + case[0])
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    return (jdata, slots, n_eval, (np.asarray(j_re), np.asarray(j_im)), lam,
            {k: np.asarray(v) for k, v in jcot.items()})


@pytest.mark.parametrize("case", CKPT_CASES, ids=_ids)
def test_plain_k4_matches_pallas_interpret(case):
    """K4's plain version against the JAX checkpointed forward, every
    step's state; and against K1's plain version at the slots, bit for
    bit (the JAX package's test_pallas_ckpt_states_contract asserts the
    same of its two kernels)."""
    method = case[2]
    jdata, slots, n_eval, (j_re, j_im), _, _ = _jax_ckpt(case)
    tdata = _same_inputs(jdata)
    t_re, t_im = tfe.fused_fwd_ckpt(tdata, method)
    assert t_re.shape == j_re.shape
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=K1_TOL)
    s_re, s_im = tfe.fused_fwd_plain(tdata, method, torch.tensor(slots, dtype=torch.int32), n_eval)
    for g, s in enumerate(slots[1:], start=1):
        if s < n_eval:
            assert torch.equal(t_re[:, g - 1], s_re[:, s]) and torch.equal(t_im[:, g - 1], s_im[:, s])


@pytest.mark.parametrize("case", CKPT_CASES, ids=_ids)
def test_plain_k5_matches_pallas_interpret(case):
    """K5's plain version (lam0, every unpacked stream cotangent, dbar)
    against the JAX checkpointed custom VJP, from the same stored states
    and per-step cotangents."""
    method = case[2]
    jdata, _, _, (j_re, j_im), (lam_re, lam_im), jcot = _jax_ckpt(case)
    tdata = _same_inputs(jdata)
    lam0_re, lam0_im, zbar, dbar = tfe.fused_bwd_ckpt(
        tdata, method, torch.tensor(j_re), torch.tensor(j_im),
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


def test_ckpt_autograd_cotangents_match_jax():
    """The autograd Function hands every data key the cotangent the JAX
    checkpointed VJP hands it (structural inputs zero)."""
    case = CKPT_CASES[1]
    jdata, _, _, _, lam, jcot = _jax_ckpt(case)
    tdata = {k: v.requires_grad_(True) for k, v in _same_inputs(jdata).items()}
    st_re, st_im = tfe.fused_evolve_ckpt(case[2], tdata)
    loss = (st_re * torch.tensor(lam[0])).sum() + (st_im * torch.tensor(lam[1])).sum()
    loss.backward()
    for k, want in jcot.items():
        got = tdata[k].grad
        if not np.any(want):
            assert got is None or not torch.any(got), k
            continue
        assert _max_rel(got, want) < K2_REL_TOL, k


def _contract_setup():
    jsim, tsim = emulators(3, duration=60, seed=21, evaluation_times=0.25)
    h = jsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    re = np.asarray(jsim.initial_state.re).T.reshape(1, da, db)
    im = np.asarray(jsim.initial_state.im).T.reshape(1, da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array)
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu")
    return h._ham_data, factored_fields(h._ham_data), re, im, jg, tg


def _port_states(f, streams_re, re, im, tg, ckpt):
    th = factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]), device="cpu",
    )
    th = th._replace(row_streams=Cplx(streams_re, th.row_streams.im))
    return tfe.evolve_states(th, torch_cplx(re, im), tg, "DP5", ckpt=ckpt)


def test_ckpt_states_contract():
    """evolve_states(ckpt=True) against JAX pallas_evolve_states(ckpt=True):
    the evaluation-slot states, and the row-stream gradient of a
    mid-trajectory-plus-final loss, whose slot cotangents scatter into the
    per-step buffer.  Against the port's own non-ckpt path: the same
    states bit for bit, the same gradient within 1e-5 relative (the
    mirror reconstruction's own f32 error)."""
    jham, f, re, im, jg, tg = _contract_setup()
    j = jpe.pallas_evolve_states(jham, jax_cplx(re, im), jg, "DP5", interpret=True, ckpt=True)

    def jloss(s):
        out = jpe.pallas_evolve_states(
            jham._replace(row_streams=type(jham.row_streams)(s, jham.row_streams.im)),
            jax_cplx(re, im), jg, "DP5", interpret=True, ckpt=True)
        return jnp.sum(out.re[1] ** 2) + jnp.sum(out.im[-1] ** 2)

    jgrad = np.asarray(jax.grad(jloss)(jham.row_streams.re))

    grads, states = {}, {}
    for ckpt in (True, False):
        s = torch.tensor(f["row_streams_re"], requires_grad=True)
        out = _port_states(f, s, re, im, tg, ckpt)
        (out.re[1] ** 2).sum().add((out.im[-1] ** 2).sum()).backward()
        grads[ckpt], states[ckpt] = to_numpy(s.grad), out
    out = states[True]
    assert out.re.shape == j.re.shape
    np.testing.assert_allclose(to_numpy(out.re), np.asarray(j.re), rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(out.im), np.asarray(j.im), rtol=0, atol=K1_TOL)
    assert _max_rel(grads[True], jgrad) < K2_REL_TOL
    assert torch.equal(out.re, states[False].re) and torch.equal(out.im, states[False].im)
    scale = np.abs(grads[False]).max() + 1e-12
    assert np.abs(grads[True] - grads[False]).max() < 1e-5 * scale + 1e-9


def test_bench_workload_ckpt_matches_pallas_and_f64():
    """The bench workload at four atoms through QuantumModel(ckpt=True):
    against JAX QuantumModel with the same options (interpret) at f32
    roundoff, and against the JAX f64 path within the BASELINE bars."""
    jv, jg, _ = _jax_value_grad(solver="DP5_PALLAS", ckpt=True)
    jv64, jg64, _ = _jax_value_grad(fused=False)
    before = dict(tfe.LAUNCHES)
    tv, tg = _port_value_grad(_port_model(solver="DP5_PALLAS", ckpt=True))
    assert tfe.LAUNCHES == before
    assert abs(tv - jv) < FUSED_TOL
    np.testing.assert_allclose(tg, jg, rtol=0, atol=FUSED_TOL)
    assert abs(tv - jv64) < VALUE_BAR
    np.testing.assert_allclose(tg, jg64, rtol=0, atol=GRAD_BAR)


def test_ckpt_wrappers_launch_or_raise():
    """CPU tensors take the plain versions without counting a launch; any
    other device launches its kernel or raises (no fallback); inputs of the
    wrong shape or tableau raise on every device."""
    jdata, _, _, (j_re, j_im), *_ = _jax_ckpt(CKPT_CASES[0])
    tdata = _same_inputs(jdata)
    st = torch.tensor(j_re)
    before = dict(tfe.LAUNCHES)
    tfe.fused_fwd_ckpt(tdata, "DP5")
    tfe.fused_bwd_ckpt(tdata, "DP5", st, st, st, st)
    assert tfe.LAUNCHES == before
    with pytest.raises(ValueError, match="wrong shape"):
        tfe.fused_fwd_ckpt(dict(tdata, hs=tdata["hs"][:-1]), "DP5")
    with pytest.raises(ValueError, match="wrong shape"):
        tfe.fused_bwd_ckpt(tdata, "DP5", st, st, st, st[:, :-1])
    with pytest.raises(ValueError, match="tableau"):
        tfe.fused_fwd_ckpt(tdata, "DP8")
    meta = {k: v.to("meta") for k, v in tdata.items()}
    with pytest.raises(ValueError, match="No fused kernel"):
        tfe.fused_fwd_ckpt(meta, "DP5")
    mst = st.to("meta")
    with pytest.raises(ValueError, match="No fused kernel"):
        tfe.fused_bwd_ckpt(meta, "DP5", mst, mst, mst, mst)
    assert tfe.LAUNCHES == before

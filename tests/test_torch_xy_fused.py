"""PyTorch port vs the JAX package: the kron-pair (XY) branch of the fused
kernels K1/K2 (pulser_diff_torch.ops.fused_evolution with kron pairs:
the staging, the plain versions of K1 and K2, the autograd Function).

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does, on the same f32 inputs.  The tolerances are
those of tests/test_torch_fused.py: states 1e-5 absolute; every cotangent
1e-4 of its largest magnitude.  One divergence is pinned: the cotangent
of the kron streams' imaginary part (zb_bar) takes the derivative's sign
here, and the Pallas ``_kron_cotangents`` the opposite one (no XY
gradient reaches it: the kron streams are constants).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import sesolve as tsesolve

from tests.test_torch_xy import IN_PLANE, _port_hamiltonian
from tests.torch_port_cases import (
    batched, jax_cplx, random_state, to_numpy, torch_cplx, xy_emulators,
)

torch.set_num_threads(1)

# (atoms, state batch, tableau, evaluation times, substeps).  Two atoms:
# cross terms only, the JAX kernel's direct form; three: within-column +
# cross terms, da != db, a state batch; four: all three kinds, RK4; six:
# the JAX kernel's block form (da = db = 8).
CASES = [
    (2, 1, "DP5", "Minimal", 1),
    (3, 2, "DP5", "Full", 1),
    (4, 1, "RK4", 0.5, 2),
    (6, 1, "DP5", "Minimal", 1),
]
# staged words: the same f64 stage values on both sides, one f32 ulp on a
# hi word and f64 roundoff on a lo word
STAGE_RTOL = 2.0**-23
STAGE_ATOL = 1e-14
K1_TOL = 1e-5
K2_REL_TOL = 1e-4
# the kron columns of the cotangents whose sign the port takes from the
# derivative (opposite to the Pallas kernel's)
ZB_KEYS = ("zkh_im", "zkl_im")


def _ids(c):
    return f"{c[0]}at-nb{c[1]}-{c[2]}"


def _setup(n_atoms, nb, method, eval_times, substeps):
    jsim, _ = xy_emulators(n_atoms, duration=20, seed=30 + n_atoms, field=IN_PLANE,
                           evaluation_times=eval_times)
    h = jsim._hamiltonian
    da, db = h.dim ** h._a, h.dim ** h._b
    re, im = batched(random_state(da * db, nb, seed=n_atoms), da, db)
    jg = JGrid.make(h.sampling_times, jsim._eval_times_array).refined(substeps)
    tg = TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu").refined(substeps)
    jdata = jpe.prepare_fused_inputs(h._ham_data, jax_cplx(re, im), jg.times, method)
    tdata = tfe.prepare_fused_inputs(_port_hamiltonian(h._ham_data), torch_cplx(re, im),
                                     tg.times, method)
    slots = tuple(int(s) for s in np.asarray(jg.write_slots))
    return jdata, tdata, slots, jg.n_eval


def _same_inputs(jdata):
    """The JAX kernel inputs as the port's f32 tensors, bit for bit."""
    return {k: torch.tensor(np.array(v)) for k, v in jdata.items()}


def _max_rel(got, want):
    got, want = to_numpy(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _want(jcot, k):
    return -jcot[k] if k in ZB_KEYS else jcot[k]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_xy_prepare_fused_inputs_match_jax(case):
    """The kron part matrices and streams (forward hi/lo, mirror) are
    staged as the JAX package stages them."""
    jdata, tdata, _, _ = _setup(*case)
    assert set(tdata) == set(jdata)
    assert {"kr", "kc", "zkh_re", "zkl_im", "zkb_re"} <= set(tdata)
    K = int(jdata["kr"].shape[1])
    a, b = case[0] // 2, case[0] - case[0] // 2
    assert tfe._n_kron(tdata) == K == (a >= 2) + (b >= 2) + a
    for k, jv in jdata.items():
        tv = to_numpy(tdata[k])
        assert tv.shape == jv.shape and tv.dtype == np.float32, k
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=STAGE_RTOL, atol=STAGE_ATOL,
                                   err_msg=k)


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


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_xy_plain_k1_k2_match_pallas_interpret(case):
    """K1's plain version with kron pairs against the forward Pallas kernel,
    and K2's plain version (lam0, every zbar column with the kron ones,
    dbar, krbar, kcbar) against the JAX custom VJP, on bit-identical
    inputs."""
    method = case[2]
    jdata, slots, n_eval, (j_re, j_im), (lam_re, lam_im), jcot = _jax_run(case)
    tdata = _same_inputs(jdata)
    tslots = torch.tensor(slots, dtype=torch.int32)
    t_re, t_im = tfe.fused_fwd(tdata, method, tslots, n_eval)
    for got, want in ((t_re, j_re), (t_im, j_im)):
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=K1_TOL)
    outs = tfe.fused_bwd(tdata, method, tslots, n_eval, slots[-1], torch.tensor(j_re),
                         torch.tensor(j_im), torch.tensor(lam_re), torch.tensor(lam_im))
    assert len(outs) == 6
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
    assert np.abs(jcot["kr"]).max() > 1e-3 and np.abs(jcot["zkh_re"]).max() > 1e-3


def test_xy_autograd_function_cotangents_match_jax():
    """The autograd Function hands every data key the cotangent the JAX
    custom VJP hands it (the kron part matrices and streams included, hi
    and lo words alike; mirror streams zero), and returns the two-word
    states: f64, hi + lo exactly, hi equal to K1's states."""
    case = CASES[1]
    jdata, slots, n_eval, (j_re, _), lam, jcot = _jax_run(case)
    tdata = {k: v.requires_grad_(True) for k, v in _same_inputs(jdata).items()}
    tslots = torch.tensor(slots, dtype=torch.int32)
    out_re, out_im = tfe.fused_evolve_states(case[2], tslots, n_eval, slots[-1], tdata)
    assert out_re.dtype == torch.float64
    with torch.no_grad():
        hi_re, hi_im, lo_re, lo_im = tfe.fused_fwd(tdata, case[2], tslots, n_eval, lo=True)
    assert torch.equal(out_re, hi_re.double() + lo_re.double())
    assert torch.equal(out_im, hi_im.double() + lo_im.double())
    assert 0 < float(lo_re.abs().max()) <= 2.0**-24 * float(hi_re.abs().max())
    np.testing.assert_allclose(to_numpy(hi_re), j_re, rtol=0, atol=K1_TOL)
    loss = (out_re * torch.tensor(lam[0])).sum() + (out_im * torch.tensor(lam[1])).sum()
    loss.backward()
    for k in jcot:
        want, got = _want(jcot, k), tdata[k].grad
        if not np.any(want):
            assert got is None or not torch.any(got), k
            continue
        assert _max_rel(got, want) < K2_REL_TOL, k
    torch.testing.assert_close(tdata["zkh_re"].grad, tdata["zkl_re"].grad, rtol=0, atol=0)
    torch.testing.assert_close(tdata["zkh_im"].grad, tdata["zkl_im"].grad, rtol=0, atol=0)


def test_xy_kron_cotangents_are_the_derivatives():
    """Through evolve_states (the plain versions of K1/K2), the gradients
    with respect to the kron part matrices and to both parts of the kron
    streams match autograd through the port's f64 stepper, 1e-4 of each
    gradient's largest magnitude; the imaginary part's is the one whose
    sign the Pallas kernel flips."""
    jsim, tsim = xy_emulators(3, duration=30, seed=9, field=IN_PLANE)
    th = tsim._hamiltonian._ham_data
    tg = TGrid.make(tsim.sampling_times, tsim._eval_times_array, device="cpu")
    re, im = batched(random_state(8, 1, seed=3), th.da, th.db)
    w = torch.as_tensor(np.random.default_rng(5).normal(size=(2, th.da, th.db)))

    def grads(fused):
        leaves = [th.kron_row.clone().requires_grad_(True),
                  th.kron_col.clone().requires_grad_(True),
                  th.kron_streams.re.clone().requires_grad_(True),
                  th.kron_streams.im.clone().requires_grad_(True)]
        h = th._replace(kron_row=leaves[0], kron_col=leaves[1],
                        kron_streams=Cplx(leaves[2], leaves[3]))
        if fused:
            st = tfe.evolve_states(h, torch_cplx(re, im), tg, "DP5")
        else:
            st = tsesolve(h, torch_cplx(re, im), tg)
        fin = Cplx(st.re[-1, 0].double(), st.im[-1, 0].double())
        ((fin.re * w[0]).sum() + (fin.im * w[1]).sum()).backward()
        return [to_numpy(leaf.grad) for leaf in leaves]

    for got, want in zip(grads(True), grads(False)):
        assert np.abs(want).max() > 1e-4
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_xy_wrappers_launch_or_raise():
    """With kron pairs: CPU tensors take the plain versions without
    counting a launch; more than 32 pairs, a kron input of the wrong
    shape, or a device without a kernel raise."""
    jdata, slots, n_eval, (j_re, _), *_ = _jax_run(CASES[0])
    tdata = _same_inputs(jdata)
    tslots = torch.tensor(slots, dtype=torch.int32)
    before = dict(tfe.LAUNCHES)
    tfe.fused_fwd(tdata, "DP5", tslots, n_eval)
    assert tfe.LAUNCHES == before
    with pytest.raises(ValueError, match="wrong shape"):
        tfe.fused_fwd(dict(tdata, kc=tdata["kc"][:, :, :1]), "DP5", tslots, n_eval)
    many = {k: (v.repeat(1, 1, 1, 33) if k.startswith("zk") else
                v.repeat(1, 33, 1, 1) if k in ("kr", "kc") else v) for k, v in tdata.items()}
    with pytest.raises(ValueError, match="kron pairs"):
        tfe.fused_fwd(many, "DP5", tslots, n_eval)
    meta = {k: v.to("meta") for k, v in tdata.items()}
    with pytest.raises(ValueError, match="No fused kernel"):
        tfe.fused_fwd(meta, "DP5", tslots.to("meta"), n_eval)
    assert tfe.LAUNCHES == before

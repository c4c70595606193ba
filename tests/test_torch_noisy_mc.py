"""PyTorch port vs the JAX package: the forward kernels' plain versions on
the noisy batch's shapes, against the Pallas kernels in interpret mode.

  - ``evolve_mc`` (K1 and K4 plain) on R = 3 runs of a per-qubit
    (all-local) noisy build, the runs' Hamiltonians built from the same
    draws in both packages (JAX's ``jax.vmap`` of its build), against
    ``pallas_evolve_mc``;
  - a synthetic data dict with pr = pc = 12 parts a side through K1's and
    K4's plain versions against ``fused_evolve_states`` /
    ``fused_evolve_ckpt``, and a gradient at 12 parts (K2's plain version)
    against the Pallas adjoint.

Both sides differ only in the summation order inside each product: f32
round-off, K1_TOL and K2_REL_TOL as in tests/test_torch_fused.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu import simconfig as jsc
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.hamiltonian import draw_noise as jdraw_noise
from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_torch import simconfig as tsc
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.hamiltonian import NoiseDraws as TDraws
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid

from tests.test_torch_fused import K1_TOL, K2_REL_TOL, _max_rel, _same_inputs, _setup
from tests.torch_port_cases import batched, emulators, random_state, to_numpy

torch.set_num_threads(1)

NOISE = dict(noise=("doppler", "amplitude", "SPAM"), eta=0.3, amp_sigma=0.1, temperature=80.0)


@functools.lru_cache(maxsize=None)
def _noisy_batch(R: int = 3):
    """(JAX vmapped Hamiltonians, the port's batch, grids, psi0) at 3 atoms:
    one row and two column qubits, so pr = 2 and pc = 4 per-qubit parts."""
    jsim, tsim = emulators(3, duration=48, seed=4)
    jsim.set_config(jsc.SimConfig(**NOISE))
    tsim.set_config(tsc.SimConfig(**NOISE))
    jh = jsim._hamiltonian
    keys = jax.random.split(jax.random.PRNGKey(5), R)
    jdr = jax.vmap(lambda k: jdraw_noise(k, jh.config, 3, jh._count_noise_slots()))(keys)
    jb = jax.vmap(jh.build_data)(jdr)
    draws = [TDraws(*(torch.as_tensor(np.array(x)[r]) for x in jdr)) for r in range(R)]
    tb = tsim._hamiltonian.build_batch(draws, frozenset({"bad_atoms", "doppler", "amp_factors"}))
    re, im = batched(random_state(8, 1, seed=2), 2, 4)
    jg = JGrid.make(jh.sampling_times, jsim._eval_times_array).refined(2)
    tg = TGrid.make(jh.sampling_times, jsim._eval_times_array, device="cpu").refined(2)
    return jb, tb, jg, tg, (re, im)


@pytest.mark.parametrize("ckpt", [False, True], ids=["K1", "K4"])
def test_noisy_batch_matches_pallas_evolve_mc(ckpt):
    jb, tb, jg, tg, (re, im) = _noisy_batch()
    assert (tb[0].row_parts.shape[0], tb[0].col_parts.shape[0]) == (2, 4)
    js = jpe.pallas_evolve_mc(jb, JCplx(jnp.asarray(re), jnp.asarray(im)), jg, interpret=True,
                              ckpt=ckpt)
    with torch.no_grad():
        ts = tfe.evolve_mc(tb, Cplx(torch.as_tensor(re), torch.as_tensor(im)), tg, ckpt=ckpt)
    assert tuple(ts.re.shape) == tuple(js.re.shape) and ts.re.shape[0] == 3
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(ts.im), np.asarray(js.im), rtol=0, atol=K1_TOL)


def _widen(jdata: dict, P: int, seed: int) -> dict:
    """The kernel inputs with P seeded synthetic parts a side and stream
    words for them (numpy, the same for both packages)."""
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v) for k, v in jdata.items()}
    R, n_steps, S = out["zrh_re"].shape[:3]
    for key in ("rp", "cp"):
        d = out[key].shape[-1]
        out[key] = (rng.normal(size=(P, d, d)) / (2 * P**0.5)).astype(np.float32)
    for key in tfe._ZF_KEYS + tfe._ZB_KEYS:
        scale = 1e-8 if key[2] == "l" else 1.0
        out[key] = (scale * rng.normal(size=(R, n_steps, S, P))).astype(np.float32)
    return out


@pytest.mark.parametrize("n_atoms", [2, 4])
def test_twelve_parts_match_the_pallas_kernels(n_atoms):
    """pr = pc = 12 through K1's and K4's plain versions against the Pallas
    forward kernels (interpret mode); K4's states equal K1's."""
    jdata, _, slots, n_eval = _setup(n_atoms, 1, "DP5", "Minimal", 1)
    wide = _widen(jdata, 12, seed=n_atoms)
    jw = {k: jnp.asarray(v) for k, v in wide.items()}
    tw = _same_inputs(wide)
    j_re, j_im = jpe.fused_evolve_states("DP5", True, slots, n_eval, slots[-1], jw)
    t_re, t_im = tfe.fused_fwd(tw, "DP5", torch.tensor(slots, dtype=torch.int32), n_eval)
    np.testing.assert_allclose(to_numpy(t_re), np.asarray(j_re), rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(t_im), np.asarray(j_im), rtol=0, atol=K1_TOL)
    jc_re, jc_im = jpe.fused_evolve_ckpt("DP5", True, jw)
    c_re, c_im = tfe.fused_fwd_ckpt(tw, "DP5")
    np.testing.assert_allclose(to_numpy(c_re), np.asarray(jc_re), rtol=0, atol=K1_TOL)
    np.testing.assert_allclose(to_numpy(c_im), np.asarray(jc_im), rtol=0, atol=K1_TOL)
    g_of = {s: g for g, s in enumerate(slots) if s < n_eval and g > 0}
    for s, g in g_of.items():
        assert torch.equal(c_re[:, g - 1], t_re[:, s]) and torch.equal(c_im[:, g - 1], t_im[:, s])


def test_differentiable_call_past_eight_parts_is_refused():
    """A gradient through 12 parts a side (past one 8-part chunk of the
    adjoint's partials): evolve_mc's gradient in the interaction diagonal
    (dbar) and in the row streams (their zbar columns, every part) through
    K2's plain version, against jax.grad through pallas_evolve_mc (the
    Pallas adjoint, interpret mode), at K2_REL_TOL."""
    jb, tb, jg, tg, (re, im) = _noisy_batch()
    rng = np.random.default_rng(0)
    rp = rng.normal(size=(12, 2, 2)) / 8
    cp = rng.normal(size=(12, 4, 4)) / 8
    rs_re, rs_im = (to_numpy(x[:1]).repeat(12, 0) for x in (tb[0].row_streams.re,
                                                           tb[0].row_streams.im))
    cs_re, cs_im = (to_numpy(x[:1]).repeat(12, 0) for x in (tb[0].col_streams.re,
                                                           tb[0].col_streams.im))
    diag = to_numpy(tb[0].int_diag)
    w_re, w_im = rng.normal(size=(2, 1, 2, 1, 2, 4))

    def jloss(d, r):
        jh = jax.tree_util.tree_map(lambda x: x[:1], jb)._replace(
            row_parts=jnp.asarray(rp)[None], col_parts=jnp.asarray(cp)[None],
            row_streams=JCplx(r[None], jnp.asarray(rs_im)[None]),
            col_streams=JCplx(jnp.asarray(cs_re)[None], jnp.asarray(cs_im)[None]),
            int_diag=d[None])
        st = jpe.pallas_evolve_mc(jh, JCplx(jnp.asarray(re), jnp.asarray(im)), jg, interpret=True)
        return jnp.sum(w_re * st.re + w_im * st.im)

    jgd, jgr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(diag), jnp.asarray(rs_re))
    d = torch.tensor(diag, requires_grad=True)
    r = torch.tensor(rs_re, requires_grad=True)
    ham = tb[0]._replace(row_parts=torch.as_tensor(rp), col_parts=torch.as_tensor(cp),
                         row_streams=Cplx(r, torch.as_tensor(rs_im)),
                         col_streams=Cplx(torch.as_tensor(cs_re), torch.as_tensor(cs_im)),
                         int_diag=d)
    st = tfe.evolve_mc([ham], Cplx(torch.as_tensor(re), torch.as_tensor(im)), tg)
    (torch.as_tensor(w_re) * st.re + torch.as_tensor(w_im) * st.im).sum().backward()
    assert _max_rel(d.grad, jgd) < K2_REL_TOL
    assert _max_rel(r.grad, jgr) < K2_REL_TOL
"""PyTorch port vs the JAX package: the wide adjoint interval as a plain
version (``fused_bwd_plain(..., form="wide")``,
``ops/fused_evolution._bwd_interval_wide_plain``), the counterpart of
pulser_diff_tpu/ops/pallas_evolution.py ``_bwd_interval_wide``, which JAX's
K2 runs in place of the lean interval under ``PDT_KERNEL_WIDE_ADJ=1``.

The port of tests/test_pallas.py::test_pallas_lean_vs_wide_adjoint_parity:
the wide form does the lean form's arithmetic value for value, and only
adds the diagonal (and kron part-matrix) cotangents across stages in
forward order instead of reversed, so lam0 and every stream cotangent are
equal bit for bit, and dbar (krbar, kcbar) within 1e-6 of its scale.  The
wide plain version is then held against JAX's K2 in interpret mode with
``_WIDE_ADJ`` flipped in-process, at the f32 roundoff of
tests/test_torch_fused.py (1e-4 of each output's largest magnitude), both
packages' kernels fed the same f32 inputs (staged by the port, which
stages them as the JAX package does: tests/test_torch_fused.py holds that).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
from pulser_diff_torch import TorchEmulator
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_tpu.ops import pallas_evolution as jpe

from tests.torch_port_cases import (
    batched, random_state, sequence, torch_cplx, xy_sequence,
)

torch.set_num_threads(1)

# (label, tableau, atoms, state batch, evaluation times, XY): ising at 3
# atoms (da != db, a state batch, every evaluation time), and XY at 2 atoms
# with a kron pair under an in-plane field
CASES = {
    "ising-3at-nb2": ("DP5", 3, 2, "Full", False),
    "xy-2at": ("DP5", 2, 1, "Minimal", True),
}
# the pulses (ns): the JAX side's interpret mode takes seconds a step
ISING_NS = 24
XY_NS = 20
# the reassociation bar of test_pallas_lean_vs_wide_adjoint_parity
REASSOC_REL = 1e-6
REASSOC_ABS = 1e-9
# f32 roundoff of sums in another order, as tests/test_torch_fused.py
K2_REL_TOL = 1e-4
# the kron columns whose cotangent the port takes with the derivative's
# sign (tests/test_torch_xy_fused.py pins it)
ZB_KEYS = ("zkh_im", "zkl_im")


@functools.lru_cache(maxsize=None)
def _inputs(label):
    """The kernel inputs staged by the port, handed to both packages;
    JAX's forward kernel's states (interpret mode) and the pullback of its
    custom VJP; seeded slot cotangents; the arguments of the port's K2
    plain version on those states."""
    method, n, nb, eval_times, is_xy = CASES[label]
    if is_xy:
        seq = xy_sequence(tcore, n, XY_NS, seed=30 + n, field=(1.0, 1.0, 0.0))
    else:
        seq = sequence(tcore, n, ISING_NS, seed=10 + n)
    sim = TorchEmulator.from_sequence(seq, sampling_rate=0.5, evaluation_times=eval_times,
                                      device="cpu")
    h = sim._hamiltonian
    re, im = batched(random_state(h.dim**n, nb, seed=n), h.dim**h._a, h.dim**h._b)
    grid = TGrid.make(h.sampling_times, sim._eval_times_array, device="cpu")
    tdata = tfe.prepare_fused_inputs(h._ham_data, torch_cplx(re, im), grid.times, method)
    jdata = {k: jnp.asarray(v.numpy()) for k, v in tdata.items()}
    slots = tuple(int(v) for v in np.asarray(grid.write_slots))
    n_eval = grid.n_eval

    def fwd(d):
        return jpe.fused_evolve_states(method, True, slots, n_eval, slots[-1], d)

    (j_re, j_im), vjp = jax.vjp(fwd, jdata)
    rng = np.random.default_rng(n)
    lam = tuple(rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2))
    args = (tdata, method, torch.tensor(slots, dtype=torch.int32), n_eval, slots[-1],
            torch.tensor(np.asarray(j_re)), torch.tensor(np.asarray(j_im)),
            torch.tensor(lam[0]), torch.tensor(lam[1]))
    return vjp, lam, args


def _max_rel(got, want) -> float:
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _named(outs, data) -> dict:
    """An adjoint's outputs by name, the stream rows unpacked."""
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    named = {"psi_re": outs[0], "psi_im": outs[1], "diag": outs[3]}
    named.update(zip(("zrh_re", "zrh_im", "zch_re", "zch_im"), tfe._unpack_zbar(outs[2], pr, pc)))
    if len(outs) > 4:
        named.update(zip(("zkh_re", "zkh_im"), tfe._unpack_zbar_kron(outs[2], pr, pc)))
        named.update(kr=outs[4], kc=outs[5])
    return named


@pytest.mark.parametrize("label", list(CASES))
def test_wide_plain_matches_lean_plain(label):
    """The port's wide form against its lean form (K2's plain version):
    lam0 and the stream cotangents equal, the stage-summed cotangents
    within 1e-6 of their scale."""
    *_, args = _inputs(label)
    lean = _named(tfe.fused_bwd_plain(*args), args[0])
    wide = _named(tfe.fused_bwd_plain(*args, form="wide"), args[0])
    assert lean.keys() == wide.keys()
    for k in lean:
        if k in ("diag", "kr", "kc"):
            scale = float(wide[k].abs().max()) + 1e-12
            assert float((lean[k] - wide[k]).abs().max()) < REASSOC_REL * scale + REASSOC_ABS, k
        else:
            assert torch.equal(lean[k], wide[k]), k
    assert float(wide["diag"].abs().max()) > 1e-3
    with pytest.raises(ValueError, match="form"):
        tfe.fused_bwd_plain(*args, form="broad")


@pytest.mark.parametrize("label", list(CASES))
def test_wide_plain_matches_pallas_wide(label):
    """The port's wide form against JAX's K2 in interpret mode run through
    ``_bwd_interval_wide`` (``_WIDE_ADJ`` flipped in-process and reset
    after, as test_pallas.py flips it: the dispatch reads the module global
    at trace time): every cotangent within 1e-4 of its largest magnitude
    (the zb_bar column of the kron streams with the port's sign, as
    tests/test_torch_xy_fused.py pins it)."""
    vjp, lam, args = _inputs(label)
    assert not jpe._WIDE_ADJ
    jpe._WIDE_ADJ = True
    try:
        (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    finally:
        jpe._WIDE_ADJ = False
    want = {k: np.asarray(v) for k, v in jcot.items()}
    got = _named(tfe.fused_bwd_plain(*args, form="wide"), args[0])
    for k, g in got.items():
        w = -want[k] if k in ZB_KEYS else want[k]
        assert tuple(g.shape) == w.shape, k
        assert _max_rel(g, w) < K2_REL_TOL, (k, _max_rel(g, w))

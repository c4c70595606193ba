"""PyTorch port vs the JAX package: leakage noise, one dark level |x> more
a qudit (the cases of tests/test_leakage.py, each against JAX).

The leakage-extended bases run on the Lindblad path: mesolve in its
superop, dense and factored forms (1e-12 against JAX, and against each
other), quantum-jump trajectories fed JAX's uniforms (the same jumps,
states at 1e-10), and sampling, where the dark level reads 0.
"""

import jax
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_tpu.solvers import mcsolve as jmcsolve
from pulser_diff_torch import SimConfig, TorchEmulator
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import mcsolve

from tests.test_torch_mcwf import _inputs, _jax_uniforms
from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
# trajectories: the same jumps, states through ~150 steps and renormalizations
MCWF_TOL = 1e-10


def _leak(to: int, frm: int) -> np.ndarray:
    """|to><frm| in [r, g, x]."""
    op = np.zeros((3, 3))
    op[to, frm] = 1.0
    return op


def _line(core, n: int, spacing: float):
    return core.Register.from_coordinates([(spacing * i - spacing * (n - 1) / 2, 0.0)
                                           for i in range(n)], prefix="q")


def _seq(core, n: int, spacing: float = 8.0, duration: int = 150, omega=2.0, delta=-0.7,
         phase=0.4):
    seq = core.Sequence(_line(core, n, spacing), core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse.ConstantPulse(duration, omega, delta, phase), "ryd")
    return seq


def _pair(n: int, ops, rates, spacing: float = 8.0, evaluation_times="Minimal", **cfg):
    kw = dict(noise="eff_noise", eff_noise_rates=tuple(rates), eff_noise_opers=tuple(ops),
              with_leakage=True, **cfg)
    jsim = TpuEmulator.from_sequence(_seq(jcore, n, spacing), config=JSimConfig(**kw),
                                     evaluation_times=evaluation_times)
    tsim = TorchEmulator.from_sequence(_seq(tcore, n, spacing), config=SimConfig(**kw),
                                       evaluation_times=evaluation_times, device="cpu")
    return jsim, tsim


def _np(c) -> np.ndarray:
    return to_numpy(c.re) + 1j * to_numpy(c.im)


def test_leakage_config_roundtrip():
    cfg = SimConfig(noise="eff_noise", eff_noise_rates=(0.3,), eff_noise_opers=(_leak(2, 1),),
                    with_leakage=True)
    assert "leakage" in cfg.noise
    nm = cfg.to_noise_model()
    assert nm.with_leakage and "leakage" in nm.noise_types
    assert SimConfig.from_noise_model(nm).with_leakage
    with pytest.raises(ValueError, match="effective noise operator"):
        SimConfig(noise="leakage").to_noise_model()


def test_leakage_basis_and_operator_shapes():
    """The extended basis [r, g, x], every projector between its levels,
    the collapse operators of both packages; an operator of the 2-level
    shape raises, naming the dimension and the leakage."""
    jsim, tsim = _pair(2, [_leak(2, 1)], [0.2])
    h, jh = tsim._hamiltonian, jsim._hamiltonian
    assert (h.dim, h._basis_labels) == (3, ["r", "g", "x"])
    assert "sigma_xx" in h.op_matrix and "sigma_gx" in h.op_matrix
    assert h._collapse_ops.sites == jh._collapse_ops.sites
    np.testing.assert_allclose(_np(h._collapse_ops.ops), jh._collapse_ops.ops.to_numpy(),
                               rtol=0, atol=F64_TOL)
    bad = SimConfig(noise="eff_noise", eff_noise_rates=(0.2,), eff_noise_opers=(np.eye(2),),
                    with_leakage=True)
    with pytest.raises(ValueError, match=r"Incompatible shape.*\(3, 3\).*with leakage"):
        TorchEmulator.from_sequence(_seq(tcore, 2), config=bad, device="cpu")
    # leaving the leakage basis on set_config returns to two levels
    tsim.set_config(SimConfig(noise="dephasing"))
    assert (tsim.dim, tsim._hamiltonian._basis_labels) == (2, ["r", "g"])
    assert tsim._hamiltonian._ham_data.row_parts.shape[-1] == 2


def test_leakage_with_pauli_noises_embeds_them():
    """Dephasing and depolarizing act on the first two levels of the
    extended basis, as JAX embeds them; the run agrees."""
    jsim, tsim = _pair(2, [_leak(2, 1)], [0.2])
    for extra in (("dephasing",), ("depolarizing",), ("dephasing", "depolarizing")):
        kw = dict(noise=("eff_noise",) + extra, eff_noise_rates=(0.2,),
                  eff_noise_opers=(_leak(2, 1),), with_leakage=True, dephasing_rate=0.3,
                  depolarizing_rate=0.2)
        jsim.set_config(JSimConfig(**kw))
        tsim.set_config(SimConfig(**kw))
        np.testing.assert_allclose(_np(tsim._hamiltonian._collapse_ops.ops),
                                   jsim._hamiltonian._collapse_ops.ops.to_numpy(), rtol=0,
                                   atol=F64_TOL)
    np.testing.assert_allclose(_np(tsim.run().states), jsim.run().states.to_numpy(), rtol=0,
                               atol=1e-10)


def test_leakage_single_qubit_matches_jax():
    """1 qubit leaking |g> -> |x>: the 3-level Lindblad evolution at every
    evaluation time against JAX's (which tests/test_leakage.py holds
    against scipy), trace 1, population reaching |x>."""
    jsim, tsim = _pair(1, [_leak(2, 1)], [0.25], evaluation_times=0.3)
    jr, tr = jsim.run(), tsim.run()
    rho = _np(tr.states)
    np.testing.assert_allclose(rho, jr.states.to_numpy(), rtol=0, atol=F64_TOL)
    assert rho[-1, 2, 2].real > 0.01
    assert abs(np.trace(rho[-1]).real - 1) < 1e-10


@pytest.mark.parametrize("me_form", ["superop", "dense", "factored"])
def test_leakage_two_and_three_qubits_per_form(me_form):
    """vdW interaction on the extended basis (occupancy of |r> only),
    leaking out of |r> and |g>: each mesolve form against JAX's same form
    at 2 atoms, and the factored form at 3; against the superop form."""
    for n in ((2, 3) if me_form == "factored" else (2,)):
        jsim, tsim = _pair(n, [_leak(2, 0), _leak(2, 1)], [0.15, 0.1], spacing=6.0,
                           evaluation_times=0.25)
        jr = jsim.run(me_form=me_form)
        tr = tsim.run(me_form=me_form)
        rho = _np(tr.states)
        assert rho.shape[1:] == (3**n, 3**n)
        np.testing.assert_allclose(rho, jr.states.to_numpy(), rtol=0, atol=F64_TOL)
        if me_form != "superop" and n == 2:
            np.testing.assert_allclose(rho, _np(tsim.run(me_form="superop").states), rtol=0,
                                       atol=1e-10)
        assert abs(np.trace(rho[-1]).real - 1) < 1e-10
        x_idx = [i for i in range(3**n) if 2 in np.unravel_index(i, (3,) * n)]
        assert sum(rho[-1, i, i].real for i in x_idx) > 1e-4
        for jw, tw in zip(jr, tr):
            np.testing.assert_allclose(to_numpy(tw._weights()), np.asarray(jw._weights()),
                                       rtol=0, atol=1e-10)


def test_leakage_sampling_maps_x_to_zero():
    """A fully leaked register samples as all zeros; |r x> as '10'; the
    samples of a run's final state sum to the shots."""
    from pulser_diff_torch.result import QuantumResult

    for idx, want in ((8, 0), (2, 0b10)):
        st = np.zeros((9, 1))
        st[idx, 0] = 1.0
        qr = QuantumResult(("q0", "q1"), "ground-rydberg",
                           Cplx(torch.as_tensor(st), torch.zeros(9, 1, dtype=torch.float64)),
                           True, basis_labels=("r", "g", "x"))
        assert float(qr._weights()[want]) == pytest.approx(1.0)
    _, tsim = _pair(2, [_leak(2, 0)], [0.15], spacing=6.0)
    res = tsim.run()
    c = res.sample_state(float(tsim.evaluation_times[-1]), n_samples=50)
    assert sum(c.values()) == 50


def test_leakage_mcwf_matches_jax():
    """Quantum-jump trajectories on the extended basis fed JAX's uniforms:
    the same jump counts and states; run(solver="MCWF") samples them."""
    jsim, tsim = _pair(2, [_leak(2, 0), _leak(2, 1)], [3.0, 2.0], spacing=6.0,
                       evaluation_times=0.25)
    jh, jg, jp = _inputs(jsim, JGrid, JCplx)
    th, tg, tp = _inputs(tsim, TGrid, Cplx, device="cpu")
    R, key = 10, jax.random.PRNGKey(11)
    jr = jmcsolve(jh._ham_data, jp, jh._collapse_ops, 2, 3, jg, key, R)
    u = _jax_uniforms(key, len(tg.times) - 1, R)
    tr = mcsolve(th._ham_data, tp, th._collapse_ops, 2, 3, tg, None, R, uniforms=u)
    np.testing.assert_array_equal(to_numpy(tr.n_jumps), np.asarray(jr.n_jumps))
    assert int(np.asarray(jr.n_jumps).sum()) > 0
    np.testing.assert_allclose(_np(tr.states), jr.states.to_numpy(), rtol=0, atol=MCWF_TOL)
    res = tsim.run(solver="MCWF", n_traj=6)
    assert {sum(r.bitstring_counts.values()) for r in res} == {6 * tsim.config.samples_per_run}

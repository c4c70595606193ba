"""PyTorch port vs the JAX package: quantum-jump (MCWF) trajectories
(pulser_diff_torch.solvers.mcwf.mcsolve, TorchEmulator._run_mcwf,
QuantumModel.expectation_mcwf_fn).

Fed the JAX package's uniforms (its three jax.random draws), mcsolve
takes the same jump decisions: states agree to 1e-10 and jump counts
exactly.  The trajectory average tracks the port's own mesolve within
4/sqrt(R); the masked jump step equals a branched one bit for bit; the
step loop makes no host synchronization.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_tpu.solvers import mcsolve as jmcsolve
from pulser_diff_torch import QuantumModel, SimConfig, TorchEmulator
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.hamiltonian import CollapseOps
from pulser_diff_torch.simresults import NoisyResults
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import mcsolve, mcwf, sesolve
from pulser_diff_torch.solvers.mcwf import Uniforms

from tests.torch_port_cases import sequence, to_numpy, xy_sequence

torch.set_num_threads(1)

F64_TOL = 1e-10
# f32 trajectories: unit-norm states, ~50 steps of f32 rounding
F32_TOL = 1e-5
EFF_OP = np.array([[0.3, 0.4], [0.4, -0.3]])


def _pair(n, kind="ising", duration=100, evaluation_times=0.2, **cfg):
    seq = xy_sequence if kind == "xy" else sequence
    jsim = TpuEmulator.from_sequence(seq(jcore, n, duration), sampling_rate=0.5,
                                     config=JSimConfig(**cfg), evaluation_times=evaluation_times)
    tsim = TorchEmulator.from_sequence(seq(tcore, n, duration), sampling_rate=0.5,
                                       config=SimConfig(**cfg), evaluation_times=evaluation_times,
                                       device="cpu")
    return jsim, tsim


def _inputs(sim, grid_cls, cplx, **kw):
    """(Hamiltonian wrapper, grid, psi0 (da, db)) of either package."""
    h = sim._hamiltonian
    grid = grid_cls.make(h.sampling_times, sim._eval_times_array, **kw)
    psi0 = sim._initial_state
    da, db = h.dim**h._a, h.dim**h._b
    return h, grid, cplx(psi0.re[:, 0].reshape(da, db), psi0.im[:, 0].reshape(da, db))


def _jax_uniforms(key, n_steps, n_traj, dtype=np.float64) -> Uniforms:
    """The draws the JAX package's mcsolve makes from ``key``."""
    k_sel, k_thr, k_0 = jax.random.split(key, 3)
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    return Uniforms(*(torch.as_tensor(np.array(u)) for u in (
        jax.random.uniform(k_sel, (n_steps, n_traj), jdt),
        jax.random.uniform(k_thr, (n_steps, n_traj), jdt),
        jax.random.uniform(k_0, (n_traj,), jdt))))


def _np(c) -> np.ndarray:
    return to_numpy(c.re) + 1j * to_numpy(c.im)


CASES = {
    "dephasing": (2, "ising", dict(noise="dephasing", dephasing_rate=6.0)),
    "dephasing-relaxation": (3, "ising", dict(noise=("dephasing", "relaxation"),
                                              dephasing_rate=3.0, relaxation_rate=3.0)),
    "xy-depolarizing": (3, "xy", dict(noise="depolarizing", depolarizing_rate=4.0)),
    "eff_noise": (2, "ising", dict(noise="eff_noise", eff_noise_rates=(5.0,),
                                   eff_noise_opers=(EFF_OP,))),
}


@pytest.mark.parametrize("case, solver", [(c, "DP5_SE") for c in CASES]
                         + [("dephasing", "DP5_SE_F32")])
def test_mcsolve_matches_jax(case, solver):
    """Fed JAX's uniforms: the same trajectories and jump counts (the
    eff_noise case takes the general drift: its Q is not diagonal)."""
    n, kind, cfg = CASES[case]
    jsim, tsim = _pair(n, kind, **cfg)
    jh, jg, jp = _inputs(jsim, JGrid, JCplx)
    th, tg, tp = _inputs(tsim, TGrid, Cplx, device="cpu")
    R, key = 12, jax.random.PRNGKey(4)
    jr = jmcsolve(jh._ham_data, jp, jh._collapse_ops, n, 2, jg, key, R, solver=solver)
    f32 = solver.endswith("F32")
    u = _jax_uniforms(key, len(tg.times) - 1, R, np.float32 if f32 else np.float64)
    tr = mcsolve(th._ham_data, tp, th._collapse_ops, n, 2, tg, None, R, solver=solver, uniforms=u)
    np.testing.assert_array_equal(to_numpy(tr.n_jumps), np.asarray(jr.n_jumps))
    assert int(np.asarray(jr.n_jumps).sum()) > 0
    assert tr.states.re.dtype == (torch.float32 if f32 else torch.float64)
    np.testing.assert_allclose(_np(tr.states), np.asarray(jr.states.re)
                               + 1j * np.asarray(jr.states.im), rtol=0,
                               atol=F32_TOL if f32 else F64_TOL)


def test_no_collapse_equals_sesolve():
    _, tsim = _pair(2, duration=80)
    th, tg, tp = _inputs(tsim, TGrid, Cplx, device="cpu")
    res = mcsolve(th._ham_data, tp, CollapseOps((), None), 2, 2, tg, None, 3)
    assert int(res.n_jumps.abs().sum()) == 0
    ref = sesolve(th._ham_data, Cplx(tp.re[None], tp.im[None]), tg)
    for r in range(3):
        np.testing.assert_array_equal(_np(res.states[:, r]), _np(ref[:, 0]))


def test_average_tracks_mesolve():
    """E[|psi><psi|] over R trajectories against the port's mesolve."""
    _, tsim = _pair(2, duration=200, noise="dephasing", dephasing_rate=0.6)
    th, tg, tp = _inputs(tsim, TGrid, Cplx, device="cpu")
    R = 400
    gen = torch.Generator().manual_seed(7)
    res = mcsolve(th._ham_data, tp, th._collapse_ops, 2, 2, tg, gen, R)
    psi = _np(res.states).reshape(res.states.re.shape[0], R, -1)
    rho_avg = np.einsum("trk,trl->tkl", psi, psi.conj()) / R
    ref = _np(tsim.run().states)
    assert np.abs(rho_avg - ref).max() < 4.0 / np.sqrt(R)
    assert np.abs((np.abs(psi) ** 2).sum(-1) - 1.0).max() < 1e-12
    assert int(res.n_jumps.sum()) > 0


def test_masked_jumps_equal_branched(monkeypatch):
    """The masked step (the jump arithmetic on every step, torch.where on
    the trajectories that jump) equals the branched one (the JAX package's
    lax.cond: the arithmetic only on steps where some trajectory crossed)
    bit for bit; a step where none crossed returns its inputs."""
    _, tsim = _pair(2, noise=("dephasing", "relaxation"), dephasing_rate=4.0,
                    relaxation_rate=4.0)
    th, tg, tp = _inputs(tsim, TGrid, Cplx, device="cpu")

    def solve():
        return mcsolve(th._ham_data, tp, th._collapse_ops, 2, 2, tg,
                       torch.Generator().manual_seed(3), 16)

    masked = solve()
    real = mcwf._apply_jumps
    calls = []

    def branched(groups, n, d, M, p, thr, nj, crossed, *rest):
        calls.append(bool(crossed.any()))
        if not calls[-1]:
            return p, thr, nj
        return real(groups, n, d, M, p, thr, nj, crossed, *rest)

    monkeypatch.setattr(mcwf, "_apply_jumps", branched)
    ref = solve()
    assert True in calls and False in calls
    np.testing.assert_array_equal(_np(masked.states), _np(ref.states))
    np.testing.assert_array_equal(to_numpy(masked.n_jumps), to_numpy(ref.n_jumps))
    groups = mcwf._group_collapse(th._collapse_ops, 2, 2)
    p = Cplx(torch.randn(5, 2, 2, dtype=torch.float64), torch.randn(5, 2, 2, dtype=torch.float64))
    thr, nj = torch.rand(5, dtype=torch.float64), torch.arange(5, dtype=torch.int32)
    none = torch.zeros(5, dtype=torch.bool)
    q, thr2, nj2 = real(groups, 2, 2, 4, p, thr, nj, none, torch.rand(5, dtype=torch.float64),
                        torch.rand(5, dtype=torch.float64), 1e-38)
    assert torch.equal(q.re, p.re) and torch.equal(q.im, p.im)
    assert torch.equal(thr2, thr) and torch.equal(nj2, nj)


_SYNCS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__")


def _count_syncs(monkeypatch, fn) -> int:
    """How many times fn() reads a tensor's value on the host."""
    count = [0]
    for name in _SYNCS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, **k):
            count[0] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    try:
        fn()
    finally:
        monkeypatch.undo()
    return count[0]


def test_step_loops_hold_no_host_sync(monkeypatch):
    """mcsolve and mesolve read no tensor on the host inside their step
    loops: the count of host reads does not grow with the step count."""
    counts = {}
    for duration in (40, 80):
        _, tsim = _pair(2, duration=duration, noise="dephasing", dephasing_rate=2.0)
        th, tg, tp = _inputs(tsim, TGrid, Cplx, device="cpu")
        u = Uniforms(*(torch.rand(*s, dtype=torch.float64) for s in (
            (len(tg.times) - 1, 4), (len(tg.times) - 1, 4), (4,))))
        rho0 = Cplx(tp.re.reshape(-1, 1) @ tp.re.reshape(1, -1),
                    torch.zeros(4, 4, dtype=torch.float64))
        from pulser_diff_torch.solvers import mesolve

        counts[duration] = (
            _count_syncs(monkeypatch, lambda: mcsolve(
                th._ham_data, tp, th._collapse_ops, 2, 2, tg, None, 4, remat=False, uniforms=u)),
            *[_count_syncs(monkeypatch, lambda f=f: mesolve(
                th._ham_data, rho0, th._collapse_ops, 2, 2, tg, remat=False, me_form=f))
              for f in ("superop", "dense", "factored")])
    assert counts[40] == counts[80], counts


def test_run_mcwf_counts_options_and_warning():
    jsim, tsim = _pair(2, duration=160, evaluation_times=0.25, noise="dephasing",
                       dephasing_rate=0.25, runs=100, samples_per_run=40)
    res = tsim.run(solver="MCWF")
    assert isinstance(res, NoisyResults) and res.n_measures == 4000
    assert {sum(r.bitstring_counts.values()) for r in res} == {4000}
    ref = np.diagonal(to_numpy(tsim.run().states.re), axis1=-2, axis2=-1)
    mc = np.diagonal(to_numpy(res.states.re), axis1=-2, axis2=-1)
    assert np.abs(mc - ref).max() < 0.08
    res32 = tsim.run(solver="MCWF_F32", n_traj=20)
    assert res32.n_measures == 800 and abs(sum(res32.results[-1].values()) - 1.0) < 1e-9
    # composes with doppler: one Hamiltonian and one trajectory a draw
    _, dsim = _pair(2, duration=80, evaluation_times="Minimal",
                    noise=("dephasing", "doppler"), dephasing_rate=0.1, temperature=60.0,
                    runs=6, samples_per_run=10)
    dres = dsim.run(solver="MCWF")
    tr = np.trace(to_numpy(dres.states.re), axis1=1, axis2=2)
    assert np.abs(tr - 1).max() < 1e-8 and dres.n_measures == 60
    # fast rates warn as in the JAX package, substeps silence it
    _, fast = _pair(2, duration=200, noise="dephasing", dephasing_rate=80.0, runs=2,
                    samples_per_run=2, evaluation_times="Minimal")
    with pytest.warns(UserWarning, match="per-step jump probability"):
        fast.run(solver="MCWF")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        fast.run(solver="MCWF", substeps=8)
    # SPAM preparation errors need the ground state, as in the JAX package
    _, spam = _pair(2, duration=40, noise=("dephasing", "SPAM"), eta=0.2)
    spam.set_initial_state(np.ones(4) / 2.0)
    with pytest.raises(NotImplementedError, match="ground"):
        spam.run(solver="MCWF")


def _mcwf_models():
    def seq(core):
        reg = core.Register.from_coordinates([(0.0, 0.0), (9.0, 0.0)], prefix="q")
        s = core.Sequence(reg, core.MockDevice)
        s.declare_channel("ch", "rydberg_global")
        om = s.declare_variable("omega")
        s.add(core.Pulse.ConstantPulse(80, om, -0.6, 0.2), "ch")
        return s

    cfg = dict(noise="dephasing", dephasing_rate=3.0)
    jm = JModel(seq(jcore), {"omega": jnp.asarray(1.7)}, noise_config=JSimConfig(**cfg),
                solver="MCWF", evaluation_times="Minimal")
    tm = QuantumModel(seq(tcore), {"omega": 1.7}, noise_config=SimConfig(**cfg), solver="MCWF",
                      evaluation_times="Minimal", device="cpu")
    return jm, tm


def test_expectation_mcwf_fn_matches_jax():
    """The fixed-realization value and pathwise gradient, the JAX package's
    draws fed in."""
    jm, tm = _mcwf_models()
    key, R = jax.random.PRNGKey(3), 8
    jfn = jm.expectation_mcwf_fn(key=key, n_traj=R, substeps=1)
    jv, jg = jax.value_and_grad(lambda om: jfn({"omega": om})[1][-1])(jnp.asarray(1.7))
    sim = tm._make_emulator(dict(tm.params))
    n_steps = len(TGrid.make(sim.sampling_times, sim._eval_times_array, device="cpu").times) - 1
    tfn = tm.expectation_mcwf_fn(key=0, n_traj=R, substeps=1,
                                 uniforms=_jax_uniforms(key, n_steps, R))
    om = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    tv = tfn({"omega": om})[1][-1]
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) < F64_TOL
    assert abs(float(om.grad) - float(jg)) < F64_TOL


def test_expectation_mcwf_fn_fixed_key_and_pathwise_fd():
    """A seed fixes the realization: two calls agree bit for bit, and the
    gradient equals the central difference of the same estimator."""
    _, tm = _mcwf_models()
    fn = tm.expectation_mcwf_fn(key=5, n_traj=8, substeps=1)

    def loss(om):
        return fn({"omega": om})[1][-1]

    om = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    v = loss(om)
    v.backward()
    assert float(loss(torch.tensor(1.7, dtype=torch.float64))) == float(v.detach())
    eps = 1e-5
    with torch.no_grad():
        fd = (float(loss(torch.tensor(1.7 + eps, dtype=torch.float64)))
              - float(loss(torch.tensor(1.7 - eps, dtype=torch.float64)))) / (2 * eps)
    assert abs(float(om.grad) - fd) < 1e-5 * max(1.0, abs(fd))

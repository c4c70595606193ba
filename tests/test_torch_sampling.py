"""PyTorch port vs the JAX package: measurement weights, sampled results
and the noisy run() on the CPU (pulser_diff_torch.result, simresults,
TorchEmulator._batched_weights / _noisy_from_counts / run, and the device
sampler _device_sample_counts).

Deterministic functions are held to JAX's at 1e-12.  The samplers draw
from different generators, so they are held to their distributions: bit
marginals within 5 standard errors, counts that sum exactly.
"""


import numpy as np
import pytest
import torch

from pulser_diff_tpu import simconfig as jsc
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.result import QuantumResult as JResult
from pulser_diff_tpu.simresults import CoherentResults as JCoherent
from pulser_diff_torch import simconfig as tsc
from pulser_diff_torch.backend import _device_sample_counts
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.result import QuantumResult as TResult
from pulser_diff_torch.simresults import CoherentResults as TCoherent
from pulser_diff_torch.simresults import NoisyResults

from tests.torch_port_cases import emulators, random_state, to_numpy, xy_emulators

torch.set_num_threads(1)

F64_TOL = 1e-12
SE_BAR = 5.0


def _pair(kind: str):
    return xy_emulators(3, duration=40) if kind == "XY" else emulators(3, duration=40)


def _states(R: int, n_eval: int, dim: int, seed: int) -> np.ndarray:
    """(R, n_eval, dim, 1) normalised kets."""
    return np.stack([np.stack([random_state(dim, 1, seed + 10 * r + t) for t in range(n_eval)])
                     for r in range(R)])


@pytest.mark.parametrize("kind", ["ground-rydberg", "XY"])
def test_batched_weights_match_jax(kind):
    jsim, tsim = _pair(kind)
    st = _states(3, 2, 8, seed=1)
    jw = np.asarray(jsim._batched_weights(JCplx(st.real, st.imag)))
    tw = to_numpy(tsim._batched_weights(Cplx(torch.as_tensor(st.real), torch.as_tensor(st.imag))))
    assert tw.shape == jw.shape == (3, 2, 8)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("kind", ["ground-rydberg", "XY"])
def test_noisy_from_counts_matches_jax(kind):
    """Counters, bitstring frequencies, the pseudo-density states and a
    diagonal observable's expectation."""
    jsim, tsim = _pair(kind)
    rng = np.random.default_rng(4)
    counts = rng.multinomial(30, rng.dirichlet(np.ones(8) * 0.3), size=2)
    jr = jsim._noisy_from_counts(counts, 6, 5)
    tr = tsim._noisy_from_counts(counts, 6, 5)
    assert isinstance(tr, NoisyResults) and tr.n_measures == jr.n_measures == 30
    assert [r.bitstring_counts for r in tr] == [r.bitstring_counts for r in jr]
    assert tr.results == jr.results
    np.testing.assert_allclose(to_numpy(tr.states.re), np.asarray(jr.states.re), rtol=0,
                               atol=F64_TOL)
    obs = np.arange(8.0)
    np.testing.assert_allclose(to_numpy(tr.expect([obs])[0].re),
                               np.asarray(jr.expect([obs])[0].re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(tr.get_final_state().re),
                               np.asarray(jr.get_final_state().re), rtol=0, atol=F64_TOL)
    with pytest.raises(ValueError, match="non-diagonal"):
        tr.expect([np.ones((8, 8))])


@pytest.mark.parametrize("basis, matching", [("ground-rydberg", True), ("XY", True),
                                             ("ground-rydberg", False)])
def test_quantum_result_weights_match_jax(basis, matching):
    st = random_state(8, 1, seed=3)
    order = ("q0", "q1", "q2")
    jr = JResult(order, basis, JCplx(st.real, st.imag), matching)
    tr = TResult(order, basis, Cplx(torch.as_tensor(st.real), torch.as_tensor(st.imag)), matching)
    np.testing.assert_allclose(to_numpy(tr._weights()), np.asarray(jr._weights()), rtol=0,
                               atol=F64_TOL)
    assert tr.sampling_dist.keys() == jr.sampling_dist.keys()
    for b, p in jr.sampling_dist.items():
        assert abs(tr.sampling_dist[b] - p) < F64_TOL
    assert tr._basis_name == jr._basis_name
    got = tr.get_state()
    want = jr.get_state()
    np.testing.assert_allclose(to_numpy(got.re), np.asarray(want.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(to_numpy(got.im), np.asarray(want.im), rtol=0, atol=F64_TOL)
    assert sum(tr.get_samples(500, np.random.default_rng(0)).values()) == 500


def test_coherent_results_with_measurement_errors_match_jax():
    """SPAM detection errors turn the expectation to the pseudo-density's
    (the flip kernel applied to the weights); samples take the flips."""
    errs = {"epsilon": 0.05, "epsilon_prime": 0.2}
    order = ("q0", "q1", "q2")
    sts = [random_state(8, 1, seed=s) for s in (5, 6)]
    jres = JCoherent([JResult(order, "ground-rydberg", JCplx(s.real, s.imag), True) for s in sts],
                     3, "ground-rydberg", np.array([0.0, 0.04]), "ground-rydberg", errs)
    tres = TCoherent([TResult(order, "ground-rydberg",
                              Cplx(torch.as_tensor(s.real), torch.as_tensor(s.imag)))
                      for s in sts], 3, "ground-rydberg", np.array([0.0, 0.04]),
                     "ground-rydberg", errs)
    obs = np.diag(np.arange(8.0))
    np.testing.assert_allclose(to_numpy(tres.expect([obs])[0].re),
                               np.asarray(jres.expect([obs])[0].re), rtol=0, atol=F64_TOL)
    drawn = tres.sample_state(0.04, 2000)
    assert sum(drawn.values()) == 2000 and all(len(b) == 3 for b in drawn)
    with pytest.raises(ValueError, match="epsilon"):
        TCoherent([], 3, "ground-rydberg", np.zeros(1), "ground-rydberg", {"eta": 0.1})


def _marginals(n: int, w: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(w.shape[-1])
    return torch.stack([(w * ((idx >> j) & 1)).sum(-1) for j in range(n)], -1)


@pytest.mark.parametrize("eps, eps_p", [(0.0, 0.0), (0.1, 0.25)])
def test_device_sampler_statistics(eps, eps_p):
    """Counts sum to each time's draws; the bit marginals of the summed
    counts lie within 5 standard errors of the exact mixture's, with the
    detection flips (0 -> 1 at eps, 1 -> 0 at eps_p) applied to them."""
    n, R, n_eval, m = 4, 3, 2, 20000
    rng = np.random.default_rng(8)
    w = torch.as_tensor(rng.dirichlet(np.ones(2**n) * 0.5, size=(R, n_eval)))
    gen = torch.Generator().manual_seed(1)
    counts = _device_sample_counts(w, torch.full((R,), m), m, gen, n, eps, eps_p)
    assert counts.shape == (n_eval, 2**n) and counts.dtype == torch.int64
    assert counts.sum(-1).tolist() == [R * m] * n_eval
    exact = _marginals(n, w).mean(0)
    exact = exact * (1 - eps_p) + (1 - exact) * eps
    got = _marginals(n, counts.double() / (R * m))
    se = torch.sqrt(exact * (1 - exact) / (R * m))
    assert float(((got - exact).abs() / se).max()) < SE_BAR


def test_device_sampler_flip_rates_and_masking():
    """All-zero and all-one bitstrings: each bit reads 1 at rate eps and 0
    at rate eps_p; draws past each run's count are dropped."""
    n, m = 5, 40000
    w = torch.zeros(2, 1, 2**n, dtype=torch.float64)
    w[0, 0, 0] = 1.0
    w[1, 0, -1] = 1.0
    gen = torch.Generator().manual_seed(2)
    eps, eps_p = 0.05, 0.3
    zero = _device_sample_counts(w[:1], torch.tensor([m]), m, gen, n, eps, eps_p)[0]
    one = _device_sample_counts(w[1:], torch.tensor([m]), m, gen, n, eps, eps_p)[0]
    for counts, rate in ((zero, eps), (one, 1 - eps_p)):
        marg = _marginals(n, counts.double() / m)
        assert float((marg - rate).abs().max()) < SE_BAR * (rate * (1 - rate) / m) ** 0.5
    # run 0 draws 7 samples, run 1 draws 3 of the 7 (padded draws masked)
    masked = _device_sample_counts(w, torch.tensor([7, 3]), 7, gen, n, 0.0, 0.0)
    assert masked[0, 0] == 7 and masked[0, -1] == 3 and int(masked.sum()) == 10


@pytest.mark.parametrize("solver, kwargs, runs", [
    ("DP5_PALLAS", dict(noise=("doppler", "amplitude")), 3),
    ("DP5_SE", dict(noise=("doppler", "SPAM"), eta=0.2), 3),
    ("DP5_PALLAS", dict(noise=("SPAM",), eta=0.3, epsilon=0.1, epsilon_prime=0.1), 6),
], ids=["pallas-stochastic", "f64-stochastic-spam", "pallas-spam-enumerated"])
def test_noisy_run_on_cpu(solver, kwargs, runs):
    """run() with noise on the CPU (DP5_PALLAS: the kernels' plain versions
    on the runs axis; DP5_SE: the f64 stepper per run), explicit substeps:
    NoisyResults whose counts sum to runs x samples_per_run at every
    time, frequencies that sum to 1."""
    _, tsim = emulators(3, duration=40)
    tsim.set_config(tsc.SimConfig(runs=runs, samples_per_run=4, **kwargs))
    res = tsim.run(solver=solver, substeps=1)
    assert isinstance(res, NoisyResults) and len(res) == 2
    assert [sum(r.bitstring_counts.values()) for r in res] == [runs * 4] * 2
    assert abs(sum(res.results[-1].values()) - 1.0) < 1e-12
    assert res.states.shape == (2, 8, 8)


def test_spam_without_preparation_errors_is_coherent():
    """SPAM with eta = 0: the deterministic solve, its results carrying the
    detection errors (as JAX's); a non-ground initial state with eta > 0
    raises, as in the JAX package."""
    jsim, tsim = emulators(2, duration=40)
    jsim.set_config(jsc.SimConfig(noise=("SPAM",), eta=0.0))
    tsim.set_config(tsc.SimConfig(noise=("SPAM",), eta=0.0))
    jres, tres = jsim.run(), tsim.run()
    assert type(tres).__name__ == "CoherentResults" and tres._meas_errors is not None
    np.testing.assert_allclose(to_numpy(tres.expect([np.arange(4.0)])[0].re),
                               np.asarray(jres.expect([np.arange(4.0)])[0].re), rtol=0,
                               atol=1e-10)
    assert sum(tres.sample_final_state(300).values()) == 300
    tsim.set_config(tsc.SimConfig(noise=("SPAM",), eta=0.1))
    st = random_state(4, 1, seed=0)
    tsim.set_initial_state(Cplx(torch.as_tensor(st.real), torch.as_tensor(st.imag)))
    with pytest.raises(NotImplementedError, match="initial state"):
        tsim.run()

"""PyTorch port vs the JAX package: population evaluation,
``QuantumModel.expectation_population_fn`` (pulser_diff_torch.model), the
port's counterparts of tests/test_model.py's population tests.

P candidate parameter sets of one sequence: on the CPU by default each is
solved on the f64 stepper in turn; with ``DP5_PALLAS`` (and on CUDA by
default below the fused cap) all P in one call of the fused kernels, the
candidates on the runs axis (``evolve_mc``), routed between K1/K2 and
K4/K5 by ``TorchEmulator._route_ckpt``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_torch import QuantumModel, model as tmodel
from pulser_diff_torch.ops import fused_evolution as tfe

from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

# the fallback is the per-candidate solve itself: equal to f64 roundoff
F64_TOL = 1e-9
# the fused route on both sides (plain versions against interpret mode):
# f32 roundoff of sums in another order, as tests/test_torch_model.py
FUSED_TOL = 1e-7
# the summed loss's gradient against per-candidate gradients through the
# same fused route: the runs do not interact, so equal to the bit
SPLIT_TOL = 0.0

OMEGA = [1.0, 1.4, 2.1]
DET = [0.0, -0.4, 0.3]


def _param_seq(core, n_atoms: int = 2, spacing: float = 8.0):
    """tests/test_model.py's sequence: a constant pulse whose amplitude and
    detuning are declared variables, on a row of atoms."""
    reg = core.Register.from_coordinates([(spacing * i, 0.0) for i in range(n_atoms)],
                                         prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega = seq.declare_variable("omega")
    det = seq.declare_variable("det")
    seq.add(core.Pulse.ConstantPulse(120, omega, det, 0.0), "ryd")
    return seq


def _port(solver="DP5_SE", n_atoms=2, **kw):
    return QuantumModel(_param_seq(tcore, n_atoms), {"omega": 1.0, "det": 0.0},
                        sampling_rate=0.5, solver=solver, device="cpu", **kw)


def _stack(P=3, grad=False):
    return {"omega": torch.tensor(OMEGA[:P], dtype=torch.float64, requires_grad=grad),
            "det": torch.tensor(DET[:P], dtype=torch.float64, requires_grad=grad)}


@functools.lru_cache(maxsize=None)
def _jax_population(solver):
    model = JModel(_param_seq(jcore), {"omega": jnp.asarray(1.0), "det": jnp.asarray(0.0)},
                   sampling_rate=0.5, solver=solver)
    stack = {"omega": jnp.asarray(OMEGA), "det": jnp.asarray(DET)}
    pfn = model.expectation_population_fn()
    _, vals = pfn(stack)
    g = jax.grad(lambda s: jnp.sum(pfn(s)[1][:, -1] ** 2))(stack)
    return np.asarray(vals), {k: np.asarray(v) for k, v in g.items()}


def test_default_route_is_each_candidate_on_the_stepper():
    """The CPU default: no fused call, every candidate's trace equal to its
    own expectation_fn, and to the JAX package's vmapped stepper."""
    model = _port()
    before = dict(tfe.LAUNCHES)
    _, vals = model.expectation_population_fn()(_stack())
    assert tfe.LAUNCHES == before and vals.shape[0] == 3
    fn1 = model.expectation_fn()
    for i in range(3):
        _, vi = fn1({"omega": torch.tensor(OMEGA[i], dtype=torch.float64),
                     "det": torch.tensor(DET[i], dtype=torch.float64)})
        np.testing.assert_allclose(to_numpy(vals[i]), to_numpy(vi), rtol=0, atol=F64_TOL)
    jvals, _ = _jax_population("DP5_SE")
    np.testing.assert_allclose(to_numpy(vals), jvals, rtol=0, atol=F64_TOL)


def test_fused_population_matches_jax(monkeypatch):
    """DP5_PALLAS: one evolve_mc call with the three candidates on the runs
    axis (plain versions here), against the JAX package's fused population
    (interpret mode), values and the summed loss's gradient."""
    calls = []
    real = tmodel.evolve_mc
    monkeypatch.setattr(tmodel, "evolve_mc",
                        lambda hams, *a, **k: calls.append((len(hams), k)) or real(hams, *a, **k))
    stack = _stack(grad=True)
    _, vals = _port("DP5_PALLAS").expectation_population_fn()(stack)
    (vals[:, -1] ** 2).sum().backward()
    assert calls == [(3, {"method": "DP5", "ckpt": False})]
    jvals, jgrad = _jax_population("DP5_PALLAS")
    np.testing.assert_allclose(to_numpy(vals), jvals, rtol=0, atol=FUSED_TOL)
    for k in ("omega", "det"):
        np.testing.assert_allclose(to_numpy(stack[k].grad), jgrad[k], rtol=0, atol=FUSED_TOL)


def test_population_gradients_split_per_candidate():
    """The summed population loss's gradient is each candidate's own
    gradient through the same fused route (candidates do not interact)."""
    model = _port("DP5_PALLAS")
    stack = _stack(2, grad=True)
    _, vals = model.expectation_population_fn()(stack)
    (vals[:, -1] ** 2).sum().backward()
    for i in range(2):
        om = torch.tensor(OMEGA[i], dtype=torch.float64, requires_grad=True)
        de = torch.tensor(DET[i], dtype=torch.float64, requires_grad=True)
        _, vi = model.expectation_population_fn()({"omega": om[None], "det": de[None]})
        (vi[0, -1] ** 2).backward()
        assert abs(float(stack["omega"].grad[i]) - float(om.grad)) <= SPLIT_TOL
        assert abs(float(stack["det"].grad[i]) - float(de.grad)) <= SPLIT_TOL


class _Routed(Exception):
    pass


@pytest.mark.parametrize("n_atoms, opts, ckpt", [(12, {}, False), (14, {}, True),
                                                 (16, {}, True), (12, {"ckpt": True}, True)],
                         ids=["12-atoms-K1K2", "14-atoms-K4K5", "16-atoms-K4K5",
                              "12-atoms-ckpt-True"])
def test_population_route(monkeypatch, n_atoms, opts, ckpt):
    """The population takes K4/K5 where K1/K2's clusters refuse the shape
    (14 atoms) as well as from dim 2^16, by the same rule as one solve
    (``_route_ckpt``); an explicit ckpt wins.  No kernel runs: evolve_mc
    is stubbed."""
    seen = {}

    def stub(hams, psi0, grid, method="DP5", ckpt=False):
        seen.update(runs=len(hams), ckpt=ckpt)
        raise _Routed

    monkeypatch.setattr(tmodel, "evolve_mc", stub)
    model = QuantumModel(_param_seq(tcore, n_atoms, spacing=10.0), {"omega": 1.0, "det": 0.0},
                         sampling_rate=0.25, solver="DP5_PALLAS", device="cpu", substeps=1,
                         evaluation_times="Minimal", **opts)
    with pytest.raises(_Routed):
        model.expectation_population_fn()(_stack(2))
    assert seen == {"runs": 2, "ckpt": ckpt}

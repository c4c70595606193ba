"""PyTorch port vs the JAX package: checkpointed integration
(pulser_diff_torch.solvers.solver: ``_auto_remat``, ``_auto_segments``,
``_integrate``'s ``remat`` and ``n_segments``).

The decisions are the JAX package's from the same shapes and dtypes, and
checkpointing changes neither a value nor a gradient: the recomputed
steps repeat the same f64 operations in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.solvers import solver as jsolver
from pulser_diff_torch import backend
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.solvers import solver as tsolver

from tests.test_torch_solver import _setup
from tests.torch_port_cases import jax_cplx, to_numpy, torch_cplx

torch.set_num_threads(1)

# the same f64 operations in the same order, recomputed: equal in
# practice, held to 1e-13
REMAT_TOL = 1e-13
# against the JAX package's checkpointed integration (f64, another
# framework's sums): as tests/test_torch_solver.py
F64_TOL = 1e-10

GiB = 1024**3


def _states(shape, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}[dtype]
    return (JCplx(jnp.zeros(shape, jdt), jnp.zeros(shape, jdt)),
            Cplx(torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)))


def _edges(state_bytes: int, per_step: int, threshold: int) -> list[int]:
    """n_steps on both sides of n * per_step * state_bytes = threshold."""
    n = threshold // (per_step * state_bytes)
    return [1, max(1, n - 1), n, n + 1, 2 * n + 3]


# (shape, dtype): 4 atoms to the 18-atom f32 solve and the 16-atom f64 one
SHAPES = [((1, 4, 4), "f64"), ((2, 8, 16), "f32"), ((1, 64, 64), "f64"),
          ((1, 256, 256), "f64"), ((1, 512, 512), "f32"), ((3, 512, 512), "f64")]


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=[f"{s}-{d}" for s, d in SHAPES])
def test_auto_decisions_match_jax(shape, dtype):
    js, ts = _states(shape, dtype)
    nbytes = 2 * int(np.prod(shape)) * (4 if dtype == "f32" else 8)
    assert tsolver._state_bytes(ts) == nbytes
    T = tsolver._REMAT_BYTES_THRESHOLD
    assert T == jsolver._REMAT_BYTES_THRESHOLD == 4 * GiB
    for n in _edges(nbytes, 6, T) + _edges(nbytes, 1, T) + [167, 167 * 4]:
        assert tsolver._auto_remat(ts, n) == jsolver._auto_remat(js, n), n
        assert tsolver._auto_segments(ts, n) == jsolver._auto_segments(js, n), n


def test_auto_decisions_follow_a_smaller_budget(monkeypatch):
    """PDT_REMAT_MB's budget, set smaller on both sides: the same
    decisions at every step count."""
    js, ts = _states((1, 8, 8), "f64")
    monkeypatch.setattr(jsolver, "_REMAT_BYTES_THRESHOLD", 1 << 20)
    monkeypatch.setattr(tsolver, "_REMAT_BYTES_THRESHOLD", 1 << 20)
    for n in range(1, 1200, 7):
        assert tsolver._auto_remat(ts, n) == jsolver._auto_remat(js, n)
        assert tsolver._auto_segments(ts, n) == jsolver._auto_segments(js, n)


def _loss_and_grads(th, psi, tg, **opts):
    """A weighted loss over every evaluation state, and its gradient in a
    row stream, the diagonal and the initial state."""
    leaves = [th.row_streams.re.clone().requires_grad_(True),
              th.int_diag.clone().requires_grad_(True),
              torch.as_tensor(psi[0]).clone().requires_grad_(True)]
    h = th._replace(row_streams=Cplx(leaves[0], th.row_streams.im), int_diag=leaves[1])
    s = tsolver.sesolve(h, Cplx(leaves[2], torch.as_tensor(psi[1])), tg, substeps=2, **opts)
    w = torch.as_tensor(np.random.default_rng(5).normal(size=tuple(s.shape)))
    loss = (w * s.re + w.flip(0) * s.im).sum()
    loss.backward()
    return s, float(loss.detach()), [to_numpy(x.grad) for x in leaves]


# 3 atoms, every sampling time an evaluation time (slots inside every
# segment); 31 grid steps split into 2 (16 + 15) or 3 (11 + 11 + 9)
# segments, so the last one is shorter
@pytest.mark.parametrize("opts", [{"remat": True}, {"n_segments": 2}, {"n_segments": 3},
                                  {"remat": True, "n_segments": 3}],
                         ids=["remat", "seg2", "seg3", "remat-seg3"])
def test_checkpointing_keeps_values_and_gradients(opts):
    _, th, psi, _, tg = _setup(3, 2, "Full")
    assert (tg.times.shape[0] - 1) % 2 and (tg.times.shape[0] - 1) % 3
    s0, v0, g0 = _loss_and_grads(th, psi, tg, remat=False, n_segments=None)
    s1, v1, g1 = _loss_and_grads(th, psi, tg, **opts)
    np.testing.assert_allclose(to_numpy(s1.re), to_numpy(s0.re), rtol=0, atol=REMAT_TOL)
    assert abs(v1 - v0) < REMAT_TOL
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=0, atol=REMAT_TOL)


def test_segments_match_jax():
    """The JAX package's sqrt-checkpointed scan (zero-length padding
    intervals) and the port's shorter last segment: the same states and
    gradient."""
    jh, th, psi, jg, tg = _setup(3, 2, "Full")

    def jloss(diag):
        s = jsolver.sesolve(jh._replace(int_diag=diag), jax_cplx(*psi), jg, substeps=2,
                            remat=True, n_segments=3)
        return jnp.sum(s.re * s.re - s.im), s

    (jv, js), jgr = jax.value_and_grad(jloss, has_aux=True)(jh.int_diag)
    d = th.int_diag.clone().requires_grad_(True)
    ts = tsolver.sesolve(th._replace(int_diag=d), torch_cplx(*psi), tg, substeps=2,
                         remat=True, n_segments=3)
    tv = (ts.re * ts.re - ts.im).sum()
    tv.backward()
    np.testing.assert_allclose(to_numpy(ts.re), np.asarray(js.re), rtol=0, atol=F64_TOL)
    assert abs(float(tv.detach()) - float(jv)) < F64_TOL
    np.testing.assert_allclose(to_numpy(d.grad), np.asarray(jgr), rtol=0, atol=F64_TOL)


def test_options_reach_sesolve(monkeypatch):
    """``remat`` / ``n_segments`` given to run() reach sesolve, and the
    checkpointed run gives the same states."""
    from tests.torch_port_cases import emulators

    _, tsim = emulators(2, duration=60, seed=3, evaluation_times="Full")
    seen = []
    real = backend.sesolve
    monkeypatch.setattr(backend, "sesolve", lambda *a, **k: seen.append(k) or real(*a, **k))
    plain = tsim.run().states
    ck = tsim.run(remat=True, n_segments=2).states
    assert "remat" not in seen[0] and (seen[1]["remat"], seen[1]["n_segments"]) == (True, 2)
    np.testing.assert_allclose(to_numpy(ck.re), to_numpy(plain.re), rtol=0, atol=REMAT_TOL)

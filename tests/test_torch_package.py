"""The PyTorch port as a package: what it imports, where it runs by
default, and its tensor utilities against the JAX package
(pulser_diff_torch config, cplx, ops.linalg).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.ops import linalg as jla
from pulser_diff_torch import QuantumModel, TorchEmulator
from pulser_diff_torch import config as tconfig
from pulser_diff_torch.cplx import as_cplx
from pulser_diff_torch.ops import linalg as tla

from tests.torch_port_cases import sequence, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# f64 on both sides, same operations
F64_TOL = 1e-12

_IMPORT_PROBE = """
import importlib, pkgutil, sys
import torch
before = torch.get_default_dtype()
import pulser_diff_torch
names = [m.name for m in pkgutil.walk_packages(pulser_diff_torch.__path__, "pulser_diff_torch.")]
for name in names:
    importlib.import_module(name)
# the example flows and the utilities among them
for sub, mods in (("examples", ("afm_preparation", "basic_usage", "gate_optimization",
                                "large_scale", "multi_start", "noisy_simulation",
                                "state_preparation")),
                  ("utils", ("checkpoint", "profiling"))):
    missing = {f"pulser_diff_torch.{sub}.{m}" for m in mods} - set(names)
    assert not missing, missing
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "pulser_diff_tpu"))
assert not bad, bad
assert torch.get_default_dtype() is before, torch.get_default_dtype()
print("clean")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of pulser_diff_torch (the example flows of examples/
    and the utilities of utils/ among them), and chip_smoke.py, import in
    a fresh interpreter without pulling in JAX or pulser_diff_tpu, and
    without touching torch's default dtype."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device the entry points take CUDA; with no CUDA they
    raise instead of dropping to the CPU; device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = sequence(tcore, 2, 40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEmulator.from_sequence(seq)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantumModel(seq)
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        TorchEmulator.from_sequence(seq, device="cuda")
    sim = TorchEmulator.from_sequence(seq, device="cpu")
    assert sim.torch_device.type == "cpu" and sim.run().states.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tconfig.resolve_device(None) == torch.device("cuda")



def _no_device_calls():
    """Every entry point that makes tensors, called without a device."""
    from pulser_diff_torch.convert import factored_from_numpy, params_from_numpy
    from pulser_diff_torch.core.sampler import sample
    from pulser_diff_torch.hamiltonian import zero_noise_draws
    from pulser_diff_torch.solvers import TimeGrid

    z = np.zeros((1, 2, 2))
    streams = (np.zeros((1, 3)), np.zeros((1, 3)))
    return {
        "TimeGrid.make": lambda: TimeGrid.make([0.0, 1.0], [1.0]),
        "factored_from_numpy": lambda: factored_from_numpy(
            row_parts=z, col_parts=z, row_streams=streams, col_streams=streams,
            int_diag=np.zeros((2, 2)), sample_dt=1.0, n_samples=3),
        "params_from_numpy": lambda: params_from_numpy({"a": np.ones(2)}),
        "sample": lambda: sample(sequence(tcore, 2, 40)),
        "interpolate_sine": lambda: tla.interpolate_sine(3, 10),
        "basis_state": lambda: tla.basis_state(2, 1),
        "total_magnetization": lambda: tla.total_magnetization(2),
        "zero_noise_draws": lambda: zero_noise_draws(2, 1),
    }


@pytest.mark.parametrize("name", sorted(_no_device_calls()))
def test_tensor_entry_points_default_to_cuda(monkeypatch, name):
    """Without a device and without CUDA each raises as resolve_device(None)
    does, instead of making its tensors on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _no_device_calls()[name]()

def _rand_cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def test_kron_and_basis_states_match_jax():
    rng = np.random.default_rng(0)
    a, b = _rand_cplx(rng, (2, 2)), _rand_cplx(rng, (3, 3))
    for got, want in ((tla.kron(tla.XMAT, tla.YMAT, tla.ZMAT), jla.kron(jla.XMAT, jla.YMAT, jla.ZMAT)),
                      (tla.kron(a, b), jla.kron(a, b))):
        np.testing.assert_allclose(got.to_numpy(), np.asarray(want.re) + 1j * np.asarray(want.im),
                                   rtol=0, atol=F64_TOL)
    for dim, num in ((4, 2), ((2, 3, 2), (1, 2, 0))):
        np.testing.assert_array_equal(to_numpy(tla.basis_state(dim, num, device="cpu").re),
                                      np.asarray(jla.basis_state(dim, num).re))
    with pytest.raises(ValueError):
        tla.basis_state((2, 2), (1,), device="cpu")


@pytest.mark.parametrize("n_qubits", [3, 4])
def test_expect_and_observables_match_jax(n_qubits):
    """Kets with a batch axis, the dense and 1-D diagonal magnetization
    and a non-Hermitian observable (its imaginary part)."""
    rng = np.random.default_rng(n_qubits)
    dim = 2**n_qubits
    st = _rand_cplx(rng, (5, dim, 2))
    t_st = as_cplx(st)
    j_st = JCplx(jnp.asarray(st.real), jnp.asarray(st.imag))
    obs = _rand_cplx(rng, (dim, dim))
    cases = [
        (tla.total_magnetization(n_qubits, dense=True, device="cpu"), jla.total_magnetization(n_qubits, dense=True)),
        (tla.total_magnetization(n_qubits, dense=False, device="cpu"), jla.total_magnetization(n_qubits, dense=False)),
        (as_cplx(obs), JCplx(jnp.asarray(obs.real), jnp.asarray(obs.imag))),
    ]
    for t_obs, j_obs in cases:
        np.testing.assert_array_equal(to_numpy(t_obs.re), np.asarray(j_obs.re))
        got, want = tla.expect(t_obs, t_st), jla.expect(j_obs, j_st)
        np.testing.assert_allclose(to_numpy(got.re), np.asarray(want.re), rtol=0, atol=1e-10)
        np.testing.assert_allclose(to_numpy(got.im), np.asarray(want.im), rtol=0, atol=1e-10)


def test_interpolate_sine_matches_jax():
    for n, T in ((8, 660), (5, 37)):
        np.testing.assert_array_equal(to_numpy(tla.interpolate_sine(n, T, device="cpu")),
                                      np.asarray(jla.interpolate_sine(n, T)))


def test_public_surface_matches_jax():
    """Every name the JAX package exports (its emulator under the port's
    name) is exported by the port, at the top level and in ops; the ops
    constants and helpers equal JAX's."""
    import pulser_diff_torch
    import pulser_diff_torch.ops as tops
    import pulser_diff_tpu
    import pulser_diff_tpu.ops as jops

    for name in set(pulser_diff_tpu.__all__) - {"TpuEmulator"}:
        assert name in pulser_diff_torch.__all__ and hasattr(pulser_diff_torch, name), name
    assert set(jops.__all__) <= set(tops.__all__)
    for name in jops.__all__:
        assert hasattr(tops, name), name
    for name in ("HMAT", "IMAT", "XMAT", "YMAT", "ZMAT"):
        np.testing.assert_array_equal(getattr(tops, name).to_numpy(),
                                      getattr(jops, name).to_numpy())
    np.testing.assert_array_equal(to_numpy(tops.total_magnetization_diag(5, device="cpu")),
                                  np.asarray(jops.total_magnetization_diag(5)))
    assert [tops.s(x) for x in (0.0, 0.3, 1.0)] == [jops.s(x) for x in (0.0, 0.3, 1.0)]
    rng = np.random.default_rng(9)
    rho = _rand_cplx(rng, (4, 4))
    rho = rho @ rho.conj().T
    rho /= np.trace(rho)
    np.testing.assert_allclose(to_numpy(tops.trace(as_cplx(rho)).re),
                               np.asarray(jops.trace(JCplx(jnp.asarray(rho.real),
                                                           jnp.asarray(rho.imag))).re), atol=1e-14)


def test_solver_names_and_run_options_match_jax():
    """SolverType names every solver of the JAX package (and MCWF /
    MCWF_F32), and run() / QuantumModel take exactly the JAX package's
    options."""
    from pulser_diff_torch import SolverType
    from pulser_diff_torch.backend import _RUN_OPTIONS
    from pulser_diff_tpu import SolverType as JSolverType
    from pulser_diff_tpu.backend import _RUN_OPTIONS as J_RUN_OPTIONS

    def names(cls):
        return {k: v for k, v in vars(cls).items() if k.isupper()}

    assert names(SolverType) == names(JSolverType)
    assert {"KRYLOV_SE", "KRYLOV_SE_F32", "DP5_SE_ADAPTIVE", "MCWF", "MCWF_F32"} <= set(
        names(SolverType))
    assert _RUN_OPTIONS == J_RUN_OPTIONS


def test_cplx_helpers_match_jax():
    """The split-complex methods and constructors of both packages on one
    seeded input."""
    from pulser_diff_tpu import cplx as jc
    from pulser_diff_torch import cplx as tc

    rng = np.random.default_rng(4)
    a, b = _rand_cplx(rng, (3, 4)), _rand_cplx(rng, (4, 5))
    c = _rand_cplx(rng, (3, 4))
    ta, tb, tcc = as_cplx(a), as_cplx(b), as_cplx(c)
    ja, jb, jcc = (JCplx(jnp.asarray(x.real), jnp.asarray(x.imag)) for x in (a, b, c))
    theta = rng.normal(size=5)
    pairs = [
        (ta.T, ja.T), (ta.mH, ja.mH), (ta.flatten(), ja.flatten()),
        (ta / tcc, ja / jcc), (ta / 2.5, ja / 2.5), (ta / (1 - 2j), ja / (1 - 2j)),
        (tc.cmatmul(ta, tb), jc.cmatmul(ja, jb)), (tc.cdot(ta, tcc), jc.cdot(ja, jcc)),
        (tc.ceye(3), jc.ceye(3, jnp.float64)), (tc.czeros((2, 3)), jc.czeros((2, 3), jnp.float64)),
        (tc.cones(4), jc.cones(4, jnp.float64)),
        (tc.cexp_i(torch.as_tensor(theta)), jc.cexp_i(jnp.asarray(theta))),
        (tc.cconcat([ta, tcc], 1), jc.cconcat([ja, jcc], 1)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(to_numpy(ta.abs()), np.asarray(ja.abs()), rtol=0, atol=1e-14)
    np.testing.assert_allclose(float(tc.cnorm(ta)), float(jc.cnorm(ja)), rtol=0, atol=1e-14)
    assert ta.astype(torch.float32).dtype == torch.float32

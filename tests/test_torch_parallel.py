"""The port's device meshes and sharded solves (pulser_diff_torch/parallel/mesh.py)
against the JAX package's (pulser_diff_tpu/parallel/mesh.py).

The port's cases run on gloo ranks on the CPU, each a subprocess of
tests/torch_workers.py (two groups of 2 ranks for the state- and
row-sharded solves, 4 ranks for the runs axis), all three groups started together when the module's
first test asks for them; the JAX package runs in this process on the 8
virtual devices of tests/conftest.py meanwhile.  Same sequences on both
sides, f64 unless named.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.hamiltonian import draw_noise as jdraw_noise
from pulser_diff_tpu.parallel import make_mesh as jmake_mesh
from pulser_diff_tpu.parallel import mesh as jmesh
from pulser_diff_tpu.solvers import SolverType as JSolverType
from pulser_diff_tpu.solvers import TimeGrid as JTimeGrid
from pulser_diff_torch import SimConfig, TorchEmulator
from pulser_diff_torch.hamiltonian import NoiseDraws
from pulser_diff_torch.parallel import make_mesh
from pulser_diff_torch.parallel import mesh as tmesh
from pulser_diff_torch.solvers import TimeGrid

from .conftest import make_simple_sequence
from .torch_workers import simple_sequence

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GROUPS = {"sesolve": 2, "mesolve": 2, "runs": 4}
F64_TOL = 1e-12


class _Ranks:
    """The worker groups, started together; ``result(group)`` waits for
    one and loads what its rank 0 wrote."""

    def __init__(self, outdir: Path):
        self.outdir = outdir
        env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
        self.procs = {}
        for group, world in GROUPS.items():
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            self.procs[group] = [subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_workers.py"), group, str(rank),
                 str(world), str(port), str(outdir)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for rank in range(world)]
        self.loaded = {}

    def result(self, group: str):
        if group not in self.loaded:
            for rank, p in enumerate(self.procs[group]):
                out = p.communicate(timeout=600)[0]
                assert p.returncode == 0, f"{group} rank {rank} failed:\n{out[-4000:]}"
            self.loaded[group] = dict(np.load(self.outdir / f"{group}.npz"))
        return self.loaded[group]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmake_mesh({"state": 8})


def _ring(n, radius):
    from pulser_diff_tpu.core import Register

    return Register({f"q{i}": jnp.array([radius * np.cos(a), radius * np.sin(a)])
                     for i, a in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False))})


def _jax_case(seq, config=None):
    sim = TpuEmulator.from_sequence(seq, config=config, evaluation_times="Minimal")
    h = sim._hamiltonian
    grid = JTimeGrid.make(h.sampling_times, sim._eval_times_array)
    return sim, h, grid


def _jax_psi(sim, h):
    da, db = h.dim**h._a, h.dim**h._b
    p0 = sim.initial_state
    return JCplx(p0.re.T.reshape(1, da, db), p0.im.T.reshape(1, da, db))


def _np(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def test_make_mesh_validation(ranks):
    """The JAX package's check and message; without a process group the
    port names multihost.initialize instead of running on its own."""
    with pytest.raises(ValueError) as jerr:
        jmake_mesh({"runs": 3}, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as terr:
        make_mesh({"runs": 3}, devices=[0, 1], device_type="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        make_mesh({"runs": 1}, device_type="cpu")
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        make_mesh({"runs": 1}, devices=[0], device_type="cpu")


def test_solve_states_from_draws_matches_jax(two_atom_register, ranks):
    """One realization from JAX's draws carried over: the port's
    _solve_states_from_draws (fused=False, remat=True) against JAX's."""
    seq = make_simple_sequence(two_atom_register, duration=100)
    cfg = JSimConfig(noise=("doppler", "amplitude"), temperature=60.0, amp_sigma=0.1)
    sim, h, grid = _jax_case(seq, cfg)
    draws = jdraw_noise(jax.random.PRNGKey(2), h.config, h._size, h._count_noise_slots())
    want = jmesh._solve_states_from_draws(sim, draws, JSolverType.DP5_SE, 1, 12, grid)
    tsim = TorchEmulator.from_sequence(
        simple_sequence({"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])}, 100),
        config=SimConfig(noise=("doppler", "amplitude"), temperature=60.0, amp_sigma=0.1),
        evaluation_times="Minimal", device="cpu")
    th = tsim._hamiltonian
    tdraws = NoiseDraws(*(torch.as_tensor(np.array(x), dtype=torch.float64) for x in draws))
    got = tmesh._solve_states_from_draws(
        tsim, tdraws, "DP5_SE", 1, 12,
        TimeGrid.make(th.sampling_times, tsim._eval_times_array, "cpu"))
    assert float(np.abs(_np(want.re) - _np(want.re)[0]).max()) > 1e-3  # it evolved
    np.testing.assert_allclose(got.re.numpy(), _np(want.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(got.im.numpy(), _np(want.im), rtol=0, atol=F64_TOL)


def test_sharded_noise_states(ranks):
    """Eight seeds on 4 ranks: the port's mesh=None bit for bit, runs
    that differ, unit norms, Shard(0) over the 4 ranks."""
    r = ranks.result("runs")
    np.testing.assert_array_equal(r["noise_re"], r["plain_re"])
    np.testing.assert_array_equal(r["noise_im"], r["plain_im"])
    assert r["noise_re"].shape[0] == 8
    norms = (r["noise_re"] ** 2 + r["noise_im"] ** 2).sum(axis=(2, 3))
    assert np.abs(norms - 1).max() < 1e-8
    assert np.abs(r["noise_re"][0, -1] - r["noise_re"][1, -1]).max() > 1e-6
    assert str(r["noise_placements"]) == "(Shard(dim=0),)" and int(r["noise_ranks"]) == 4


def test_sharded_sesolve_matches_jax(mesh8, ranks):
    """JAX's 6-atom, 60 ns case (da = 8): states on 2 ranks against JAX's
    on its 8-device mesh, the amplitude-scale gradient through the
    sharded solve, Shard(2) placement, and the ValueError of a row dim
    (3) that the axis does not divide."""
    sim, h, grid = _jax_case(make_simple_sequence(_ring(6, 8.0), duration=60))
    psi0, hd = _jax_psi(sim, h), h._ham_data

    def scaled(s):
        return hd._replace(row_streams=JCplx(hd.row_streams.re * s, hd.row_streams.im * s),
                           col_streams=JCplx(hd.col_streams.re * s, hd.col_streams.im * s))

    want = jmesh.sharded_sesolve(hd, psi0, grid, mesh8)
    g = jax.grad(lambda s: jmesh.sharded_sesolve(scaled(s), psi0, grid, mesh8)
                 .abs2()[-1, 0, -1, -1])(jnp.asarray(1.0))
    r = ranks.result("sesolve")
    np.testing.assert_allclose(r["re"], _np(want.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(r["im"], _np(want.im), rtol=0, atol=F64_TOL)
    assert str(r["placements"]) == "(Shard(dim=2),)" and int(r["ranks"]) == 2
    assert abs(float(g)) > 1e-9
    np.testing.assert_allclose(float(r["grad"]), float(g), rtol=0, atol=1e-11)
    assert "not divisible by mesh axis 'state' of size 2" in str(r["refused"])


def test_sharded_sesolve_f32_mode(mesh8, ranks):
    """DP5_SE_F32 through the sharded solve: f32 states, Shard(2), within
    JAX's own f32 bar (5e-6) of JAX's sharded f64 solve and of its
    sharded f32 solve."""
    sim, h, grid = _jax_case(make_simple_sequence(_ring(6, 8.0), duration=60))
    psi0, hd = _jax_psi(sim, h), h._ham_data
    want64 = jmesh.sharded_sesolve(hd, psi0, grid, mesh8)
    want32 = jmesh.sharded_sesolve(hd, psi0, grid, mesh8, solver=JSolverType.DP5_SE_F32)
    r = ranks.result("sesolve")
    assert str(r["dtype32"]) == "torch.float32"
    assert str(r["placements32"]) == "(Shard(dim=2),)"
    for want in (want64, want32):
        np.testing.assert_allclose(r["re32"], _np(want.re), rtol=0, atol=5e-6)
        np.testing.assert_allclose(r["im32"], _np(want.im), rtol=0, atol=5e-6)


def test_sharded_sesolve_xy_kron_terms(mesh8, ranks):
    """The XY kron-pair terms (R @ Psi @ C^T) through the sharded solve."""
    from pulser_diff_tpu.core import MockDevice, Pulse, Sequence

    seq = Sequence(_ring(6, 7.0), MockDevice)
    seq.declare_channel("mw", "microwave_global")
    seq.add(Pulse.ConstantPulse(60, 1.5, 0.4, 0.3), "mw")
    sim, h, grid = _jax_case(seq)
    want = jmesh.sharded_sesolve(h._ham_data, _jax_psi(sim, h), grid, mesh8)
    r = ranks.result("mesolve")
    assert bool(r["xy_kron"])
    np.testing.assert_allclose(r["xy_re"], _np(want.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(r["xy_im"], _np(want.im), rtol=0, atol=F64_TOL)
    assert str(r["xy_placements"]) == "(Shard(dim=2),)"


def _rho_case(reg, rate):
    from pulser_diff_tpu.core import Register

    sim, h, grid = _jax_case(make_simple_sequence(Register(reg), duration=48),
                             JSimConfig(noise="dephasing", dephasing_rate=rate))
    p = sim.initial_state
    rho0 = JCplx(p.re @ p.re.T + p.im @ p.im.T, p.im @ p.re.T - p.re @ p.im.T)
    return h, grid, rho0


@pytest.mark.parametrize("key", ["sup", "dense"])
def test_sharded_mesolve_matches_jax(mesh8, ranks, key):
    """Density-matrix rows on 2 ranks against JAX's 8-device mesh: the
    3-atom case (superop form, dim 8) and the 4-atom one (dense form,
    dim 16); Shard(1) on (n_eval, dim, dim)."""
    reg, rate = {
        "sup": ({"q0": jnp.array([-5.0, 0.0]), "q1": jnp.array([5.0, 0.0]),
                 "q2": jnp.array([0.0, 6.0])}, 0.3),
        "dense": ({"q0": jnp.array([-6.0, 0.0]), "q1": jnp.array([6.0, 0.0]),
                   "q2": jnp.array([0.0, 7.0]), "q3": jnp.array([0.0, -7.0])}, 0.25),
    }[key]
    h, grid, rho0 = _rho_case(reg, rate)
    want = jmesh.sharded_mesolve(h._ham_data, rho0, h._collapse_ops, h._size, h.dim, grid,
                                 jmake_mesh({"rho": 8}))
    r = ranks.result("mesolve")
    np.testing.assert_allclose(r[f"{key}_re"], _np(want.re), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(r[f"{key}_im"], _np(want.im), rtol=0, atol=F64_TOL)
    assert str(r[f"{key}_placements"]) == "(Shard(dim=1),)"


def test_sharded_mcwf_states(ranks):
    """Eight trajectories on 4 ranks, 2 a shard: shard i one mcsolve
    from fold_seed(seed, i) bit for bit; shard 0 equal to the call
    without a mesh (one shard); unit norms; Shard(0); a count the axis
    does not divide refused."""
    r = ranks.result("runs")
    assert r["mc_re"].shape[0] == 4 and r["mc_re"].shape[2] == 2
    np.testing.assert_array_equal(r["mc_re"], r["ref_re"])
    np.testing.assert_array_equal(r["mc_im"], r["ref_im"])
    np.testing.assert_array_equal(r["mc_re"][:1], r["lone_re"])
    np.testing.assert_array_equal(r["mc_im"][:1], r["lone_im"])
    norms = (r["mc_re"] ** 2 + r["mc_im"] ** 2).sum(axis=(3, 4))
    assert np.abs(norms - 1).max() < 1e-8
    assert str(r["mc_placements"]) == "(Shard(dim=0),)"
    assert "must divide" in str(r["mc_refused"])


def test_sharded_expectation_step(ranks):
    """One step on 4 ranks, a run each: the loss equals the mean of the
    runs' losses computed alone from the same seeds (1e-12), every rank
    keeps the same parameter, and the SGD move equals lr x the mean of
    the lone runs' gradients (1e-12)."""
    r = ranks.result("runs")
    assert abs(float(r["step_loss"]) - float(np.mean(r["lone_losses"]))) < F64_TOL
    assert np.ptp(r["lone_losses"]) > 0  # the runs drew different noise
    omegas = r["step_omegas"]
    assert (omegas == omegas[0]).all(), omegas
    want = float(r["omega0"]) - float(r["lr"]) * float(r["lone_grad"])
    assert abs(float(omegas[0]) - want) < F64_TOL
    assert abs(float(r["lone_grad"])) > 1e-6


def test_large_scale_mesh_section(ranks):
    """examples/large_scale.py's mesh section at its CI size (6 atoms, da
    = 8) on 2 ranks: the f32 solve placed on both, its final norm within
    f32 rounding of the unsharded f32 run()'s and of 1."""
    r = ranks.result("mesolve")
    assert int(r["ls_ranks"]) == 2
    assert abs(float(r["ls_mesh_norm"]) - 1) < 1e-5
    assert abs(float(r["ls_mesh_norm"]) - float(r["ls_norm"])) < 1e-6

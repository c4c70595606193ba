"""PyTorch port vs the JAX package: exported steps that keep their draws
(pulser_diff_torch.utils.export, config.constant_under_export, and MCWF's
loop as the custom op ``pulser_diff_torch::mcwf_states``,
solvers/mcwf_op.py).

Under ``jax.jit`` a key drawn while tracing is a constant of the compiled
program, so the JAX package's exported artifact serves one realization.
The port's artifact does the same: the draws its trace makes are real
tensors, constants of the graph, and no ``torch.Generator`` is left in it.

  - a stochastic-noise model (doppler, amplitude, SPAM): two calls of the
    reloaded step equal bit for bit, and a fresh process without JAX
    gives the same value; fed the same draws (each package's
    ``draw_noise`` replaced as in tests/test_torch_noisy_model.py), the
    reloaded value and gradient within 1e-12 of JAX's reloaded artifact;
    the eager path still draws anew at each call;
  - ``expectation_mcwf_fn``: with ``key`` the reloaded value equals the
    eager value bit for bit and the gradient is within 1e-14 relative, with
    ``_auto_remat`` off and on; with JAX's uniforms, within 1e-10 of JAX's
    reloaded artifact on the f64 ising and XY routes, and within
    tests/test_torch_f32.py's tolerances on ``MCWF_F32``; the graph's node
    count is the same at 80 and 400 ns; ``MCWF_F32`` and an XY model
    export too;
  - ``opcheck`` on ``mcwf_states`` (its adjoint's checks by hand);
    ``export_step`` refuses a step that keeps a lifted generator.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_torch.core as tcore
import pulser_diff_tpu.core as jcore
from pulser_diff_torch import QuantumModel, SimConfig, TorchEmulator
from pulser_diff_torch import simconfig as tsc
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.solvers import TimeGrid, mcwf, mcwf_op
from pulser_diff_torch.solvers.mcwf import Uniforms
from pulser_diff_torch.utils import export_step, load_meta, load_step
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.utils import export_step as j_export_step
from pulser_diff_tpu.utils import load_step as j_load_step

from tests.test_torch_export import _check_stepper_adjoint
from tests.test_torch_export import _sequence as _xy_capable_sequence
from tests.test_torch_f32 import GRAD_REL_TOL, STATE_TOL
from tests.test_torch_mcwf import _jax_uniforms
from tests.test_torch_noisy_model import NOISES, _loss, _pair, _sequence

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F64_TOL = 1e-12
# the reloaded MCWF gradient against the eager one: the same estimator,
# the adjoint by torch.func.vjp step by step instead of autograd's graph
MCWF_GRAD_REL = 1e-14
# against JAX's artifact fed the same uniforms: tests/test_torch_mcwf.py's
MCWF_JAX_TOL = 1e-10
MCWF_OPS = ["pulser_diff_torch::mcwf_states", "pulser_diff_torch::mcwf_states_bwd"]
NOISY_PARAMS = {"omega": 1.2, "det": -0.3}


def _grad_step(fn, reduce):
    """params -> (value, {name: grad}) of ``reduce(fn(params)[1])``."""

    def step(p):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        v = reduce(fn(q)[1])
        grads = torch.autograd.grad(v, list(q.values()))
        return v.detach(), {k: g.detach() for k, g in zip(q, grads)}

    return step


def _f64(params: dict) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in params.items()}


def _noisy_model(noise: str) -> QuantumModel:
    return QuantumModel(_sequence(tcore), dict(NOISY_PARAMS),
                        noise_config=tsc.SimConfig(**NOISES[noise]), sampling_rate=0.5,
                        substeps=1, device="cpu")


def _reload(tmp_path, name: str, step, p0):
    path = export_step(step, (p0,), str(tmp_path / f"{name}.pt2"))
    return path, load_step(path, device="cpu")


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k]) for k in a[1])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Exported steps shared by the tests below, by name: (path, params)."""
    return {"dir": tmp_path_factory.mktemp("draws")}


def _shared(artifacts, name: str, make):
    """The artifact ``name``, exported once from ``make() -> (step,
    params)``: (path, loaded step, params as tensors, step)."""
    if name not in artifacts:
        step, params = make()
        p0 = _f64(params)
        path, loaded = _reload(artifacts["dir"], name, step, p0)
        artifacts[name] = (path, loaded, p0, step)
    return artifacts[name]


def _noisy_artifact(artifacts, noise: str = "doppler-amplitude-SPAM"):
    return _shared(artifacts, f"noisy_{noise}", lambda: (
        _grad_step(_noisy_model(noise).expectation_fn(), _loss), NOISY_PARAMS))


def test_noisy_reloaded_step_keeps_its_draws(artifacts):
    """Doppler, amplitude and SPAM noise: two calls of the reloaded step are
    equal bit for bit (export_step would raise on a lifted generator), and
    the kept draws are noise: the value differs from the noiseless
    step's."""
    _, loaded, p0, _ = _noisy_artifact(artifacts)
    first, second = loaded(p0), loaded(p0)
    assert _same(first, second), (first, second)
    clean = QuantumModel(_sequence(tcore), dict(NOISY_PARAMS), sampling_rate=0.5, substeps=1,
                         device="cpu")
    with torch.no_grad():
        assert not torch.equal(first[0], _loss(clean.expectation_fn()(p0)[1]))


def test_eager_noisy_calls_draw_anew():
    """Eagerly each call draws a new realization, as before export."""
    step = _grad_step(_noisy_model("doppler-amplitude-SPAM").expectation_fn(), _loss)
    p0 = _f64(NOISY_PARAMS)
    assert not torch.equal(step(p0)[0], step(p0)[0])


def _jax_artifact(tmp_path, name: str, loss, params: dict):
    """JAX's exported and reloaded value_and_grad of ``loss`` at ``params``."""
    path = j_export_step(jax.value_and_grad(loss), (params,), str(tmp_path / f"{name}.bin"))
    v, g = j_load_step(path)(params)
    return float(v), {k: float(x) for k, x in g.items()}


def test_noisy_reloaded_step_matches_jax_artifact(tmp_path, monkeypatch):
    """Fed the same draws (doppler, amplitude and SPAM), the port's
    reloaded step and JAX's reloaded artifact agree within 1e-12, value and
    gradient."""
    noise = "doppler-amplitude-SPAM"
    jm, tm = _pair(monkeypatch, noise, substeps=1)
    jv, jg = _jax_artifact(tmp_path, noise, lambda p: _loss(jm.expectation_fn()(p)[1]),
                           jm.params)
    p0 = _f64(NOISY_PARAMS)
    _, loaded = _reload(tmp_path, noise, _grad_step(tm.expectation_fn(), _loss), p0)
    tv, tg = loaded(p0)
    assert abs(float(tv) - jv) < F64_TOL
    for k in NOISY_PARAMS:
        assert abs(float(tg[k]) - jg[k]) < F64_TOL, k


def _mcwf_seq(core, duration: int = 40):
    reg = core.Register.from_coordinates([(0.0, 0.0), (9.0, 0.0)], prefix="q")
    s = core.Sequence(reg, core.MockDevice)
    s.declare_channel("ch", "rydberg_global")
    om = s.declare_variable("omega")
    s.add(core.Pulse.ConstantPulse(duration, om, -0.6, 0.2), "ch")
    return s


MCWF_CFG = dict(noise="dephasing", dephasing_rate=3.0)


def _mcwf_model(duration: int = 40, solver: str = "MCWF", **kw) -> QuantumModel:
    return QuantumModel(_mcwf_seq(tcore, duration), {"omega": 1.7},
                        noise_config=SimConfig(**MCWF_CFG), solver=solver,
                        evaluation_times="Minimal", device="cpu", **kw)


def _last(vals):
    return vals[-1]


def _assert_reloaded(got, want, rel: float) -> None:
    """The value bit for bit, each gradient within ``rel`` of its size."""
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    for k in want[1]:
        err = float((got[1][k] - want[1][k]).abs().max())
        assert err <= rel * float(want[1][k].abs().max()), (k, got[1][k], want[1][k])


def _mcwf_artifact(artifacts, remat: bool = False):
    """The 2-atom MCWF step (key 5, R = 4) exported with ``_auto_remat``
    deciding ``remat``."""
    name = f"mcwf_remat{remat}"
    if name not in artifacts:
        real = mcwf._auto_remat
        mcwf._auto_remat = lambda *a, **k: remat
        try:
            _shared(artifacts, name, lambda: (_grad_step(
                _mcwf_model().expectation_mcwf_fn(key=5, n_traj=4, substeps=1), _last),
                {"omega": 1.7}))
        finally:
            mcwf._auto_remat = real
    return artifacts[name]


def _mcwf_cfg(path: str) -> dict:
    """The static configuration of the graph's ``mcwf_states`` call."""
    (node,) = [n for n in torch.export.load(path).graph.nodes
               if n.target is torch.ops.pulser_diff_torch.mcwf_states.default]
    return json.loads(node.args[0])


@pytest.mark.parametrize("remat", [False, True])
def test_mcwf_key_reloaded_equals_eager(artifacts, monkeypatch, remat):
    """With ``key`` the artifact keeps the draws the key gives eagerly: the
    reloaded value equals the eager value bit for bit and the gradient is
    within 1e-14 relative; with ``_auto_remat`` on, the op keeps one carry
    every ~sqrt(steps) steps (every 6th of 40: 7 carries) and recomputes
    the others."""
    monkeypatch.setattr(mcwf, "_auto_remat", lambda *a, **k: remat)
    path, loaded, p0, step = _mcwf_artifact(artifacts, remat)
    assert load_meta(path)["custom_ops"] == MCWF_OPS
    assert _mcwf_cfg(path)["seg_len"] == (6 if remat else 1)
    got = loaded(p0)
    _assert_reloaded(got, step(p0), MCWF_GRAD_REL)
    assert _same(got, loaded(p0))
    assert abs(float(got[1]["omega"])) > 1e-6  # the gradient is there


def _xy_mcwf_model(core=tcore, model=QuantumModel, **kw):
    """The 2-atom XY model with depolarizing noise, in either package."""
    return model(_xy_capable_sequence(core, 40, xy=True), {"om": 1.8},
                 noise_config=(SimConfig if core is tcore else JSimConfig)(
                     noise="depolarizing", depolarizing_rate=4.0),
                 solver="MCWF", evaluation_times="Minimal", **kw)


def _port_mcwf(route: str):
    """(the port's model, params) of an MCWF route: the dephasing ising
    model in f64 ("ising") or f32 ("MCWF_F32"), or the XY model ("xy")."""
    if route == "xy":
        return _xy_mcwf_model(device="cpu"), {"om": 1.8}
    return _mcwf_model(solver="MCWF_F32" if route == "MCWF_F32" else "MCWF"), {"omega": 1.7}


def _jax_mcwf(route: str):
    """JAX's model of the same route."""
    if route == "xy":
        return _xy_mcwf_model(jcore, JModel)
    return JModel(_mcwf_seq(jcore), {"omega": jnp.asarray(1.7)}, noise_config=JSimConfig(**MCWF_CFG),
                  solver="MCWF_F32" if route == "MCWF_F32" else "MCWF", evaluation_times="Minimal")


JAX_KEY, JAX_R = 3, 8


def _uniforms_artifact(artifacts, route: str):
    """The port's MCWF step of ``route`` fed the JAX package's uniforms
    from key JAX_KEY (R = JAX_R; f32 draws on MCWF_F32), exported once."""

    def make():
        tm, params = _port_mcwf(route)
        sim = tm._make_emulator(dict(tm.params))
        n_steps = len(TimeGrid.make(sim.sampling_times, sim._eval_times_array,
                                    device="cpu").times) - 1
        u = _jax_uniforms(jax.random.PRNGKey(JAX_KEY), n_steps, JAX_R,
                          np.float32 if route == "MCWF_F32" else np.float64)
        fn = tm.expectation_mcwf_fn(key=0, n_traj=JAX_R, substeps=1, uniforms=u)
        return _grad_step(fn, _last), params

    return _shared(artifacts, f"uniforms_{route}", make)


@pytest.mark.parametrize("route", ["ising", "xy", "MCWF_F32"])
def test_mcwf_jax_uniforms_match_jax_artifact(artifacts, tmp_path, route):
    """Fed JAX's uniforms, the port's reloaded MCWF step is within 1e-10 of
    JAX's reloaded artifact from the same key, for the f64 ising and XY
    routes; ``MCWF_F32`` within tests/test_torch_f32.py's tolerances (the
    value within its state tolerance, the gradient within its relative
    one)."""
    jm = _jax_mcwf(route)
    jfn = jm.expectation_mcwf_fn(key=jax.random.PRNGKey(JAX_KEY), n_traj=JAX_R, substeps=1)
    jv, jg = _jax_artifact(tmp_path, "jmcwf", lambda p: jfn(p)[1][-1], jm.params)
    _, loaded, p0, _ = _uniforms_artifact(artifacts, route)
    tv, tg = loaded(p0)
    if route == "MCWF_F32":
        assert abs(float(tv) - jv) < STATE_TOL
        for k in p0:
            assert abs(float(tg[k]) - jg[k]) < GRAD_REL_TOL * abs(jg[k]), k
    else:
        assert abs(float(tv) - jv) < MCWF_JAX_TOL
        for k in p0:
            assert abs(float(tg[k]) - jg[k]) < MCWF_JAX_TOL, k


def _node_count(path: str) -> int:
    return len(torch.export.load(path).graph.nodes)


def test_mcwf_graph_does_not_grow_with_the_duration(tmp_path):
    """The value+grad step's graph has as many nodes at 80 ns as at 400 ns
    (40 and 200 steps, sampled every 2 ns): the loop and its adjoint are
    one node each."""
    counts = []
    for duration in (80, 400):
        model = _mcwf_model(duration, sampling_rate=0.5)
        step = _grad_step(model.expectation_mcwf_fn(key=2, n_traj=2, substeps=1), _last)
        path = export_step(step, (_f64({"omega": 1.7}),), str(tmp_path / f"ns{duration}.pt2"))
        counts.append(_node_count(path))
    assert counts[0] == counts[1], counts


@pytest.mark.parametrize("route", ["MCWF_F32", "xy"])
def test_mcwf_other_routes_export(artifacts, route):
    """MCWF_F32 (the f32 drift, its value bit for bit and its gradient
    within tests/test_torch_f32.py's relative tolerance of the eager step)
    and an XY model with depolarizing noise (f64, as the f64 route), on
    the artifacts of the test above."""
    path, loaded, p0, step = _uniforms_artifact(artifacts, route)
    assert load_meta(path)["custom_ops"] == MCWF_OPS
    _assert_reloaded(loaded(p0), step(p0), GRAD_REL_TOL if route == "MCWF_F32" else MCWF_GRAD_REL)


def _mcwf_op_args(remat: bool, q_grad: bool):
    """(op, arguments) of ``mcwf_states`` and of its adjoint at 2 atoms on
    6 steps of 3 trajectories (a relaxation and a dephasing channel; with
    ``q_grad`` the collapse operators' gradient asked for, so the general
    drift), the forward's float tensors as leaves that require grad, the
    adjoint's with seeded slot cotangents and every key wanted."""
    gen = torch.Generator().manual_seed(17)
    tsim = TorchEmulator.from_sequence(
        _mcwf_seq(tcore, 6).build(omega=1.3), config=SimConfig(
            noise=("dephasing", "relaxation"), dephasing_rate=2.0, relaxation_rate=1.0),
        sampling_rate=1.0, evaluation_times="Full", device="cpu")
    h = tsim._hamiltonian
    grid = TimeGrid.make(h.sampling_times, tsim._eval_times_array, torch.device("cpu"))
    psi = tsim.initial_state
    R, n_steps = 3, len(grid.times) - 1
    p0 = Cplx(psi.re[:, 0].reshape(1, 2, 2).expand(R, 2, 2),
              psi.im[:, 0].reshape(1, 2, 2).expand(R, 2, 2))
    u = Uniforms(*(torch.rand(*s, generator=gen, dtype=torch.float64)
                   for s in ((n_steps, R), (n_steps, R), (R,))))
    # thresholds high enough that some trajectories jump
    u = u._replace(thr0=0.9 + 0.1 * u.thr0)
    cfg, slots, keys, tensors = mcwf_op._mcwf_args("DP5_SE", h._ham_data, p0, h._collapse_ops,
                                                   2, 2, grid, u, remat, q_grad)
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in tensors]
    outs = mcwf_op._mcwf_op(cfg, slots, keys, tensors)
    assert int(outs[2].sum()) > 0  # some trajectory jumped
    lam = [torch.randn(outs[0].shape, generator=gen, dtype=outs[0].dtype) for _ in range(2)]
    fwd = (mcwf_op._mcwf_op, (cfg, slots, keys, leaves))
    bwd = (mcwf_op._mcwf_bwd_op, (cfg, slots, keys, keys, list(outs[3:]), *lam, tensors))
    return fwd, bwd


@pytest.mark.parametrize("remat, q_grad", [(False, False), (True, True)])
def test_mcwf_ops_pass_opcheck(remat, q_grad):
    """torch.library.opcheck: ``mcwf_states``' schema, fake implementation
    and registered autograd rule agree with its implementation; its
    adjoint's checks made by hand (its ``torch.func.vjp`` runs under no
    dispatch mode, as the steppers' adjoint's)."""
    (op, args), (bwd_op, bwd_args) = _mcwf_op_args(remat, q_grad)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    _check_stepper_adjoint(bwd_op, bwd_args)


def test_export_step_refuses_a_lifted_generator(tmp_path):
    """A step that draws from a generator at every call (the object lifted
    into the graph) raises, naming it, and writes nothing."""

    def step(x):
        gen = torch.Generator().manual_seed(5)
        return x + torch.rand(3, generator=gen, dtype=torch.float64)

    path = tmp_path / "gen.pt2"
    with pytest.raises(ValueError, match="torch.Generator object.*lifted_custom"):
        export_step(step, (torch.zeros(3, dtype=torch.float64),), str(path))
    assert not path.exists()


_FRESH_PROCESS = """
import json, sys
sys.modules["jax"] = None  # any import of JAX fails
import torch
from pulser_diff_torch.utils import load_step
out = []
for path, params in json.loads(sys.argv[1]):
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    v, g = load_step(path, device="cpu")(p)
    out.append([float(v).hex(), {k: float(x).hex() for k, x in g.items()}])
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jaxlib", "pulser_diff_tpu"))
print(json.dumps({"steps": out, "bad": bad}))
"""


def test_fresh_process_keeps_the_draws(artifacts):
    """A fresh process without JAX reloads a noisy step and an MCWF step
    and gives the values and gradients of the exporting process, bit for
    bit."""
    jobs, want = [], []
    for path, loaded, p0, _ in (_noisy_artifact(artifacts), _mcwf_artifact(artifacts)):
        v, g = loaded(p0)
        jobs.append([path, {k: float(x) for k, x in p0.items()}])
        want.append([float(v).hex(), {k: float(x).hex() for k, x in g.items()}])
    out = subprocess.run([sys.executable, "-c", _FRESH_PROCESS, json.dumps(jobs)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"steps": want, "bad": []}

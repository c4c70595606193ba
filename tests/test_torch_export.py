"""PyTorch port vs the JAX package: export and reload of a value+grad step
(pulser_diff_torch.utils.export, the counterpart of
pulser_diff_tpu/utils/export.py) and the fused kernels as ``torch.library``
custom ops (``pulser_diff_torch::fused_*``, ops/fused_evolution.py).

The fused route (K1/K2, K4/K5, with kron pairs, and with trainable
coordinates in the ising basis), whose loop lives inside one op, is
exported at JAX's 200 ns, reloaded and held bit for bit against the
port's eager step, and against JAX's jitted step on the same pulse.  One
right-hand side of the f64 XY stepper (the Hamiltonian built from the
coordinates, ``h_apply_batched`` once, its coordinate gradient) exports
too.  The ports of tests/test_misc.py's two export tests on the steppers,
whose loop is one custom op under the trace
(``pulser_diff_torch::stepper_states``, solvers/stepper_op.py), are in
test_torch_export_steppers.py, the other steppers' routes in
test_torch_export_solvers.py; ``opcheck`` covers the stepper ops here.
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
from pulser_diff_torch import SimConfig, TorchEmulator
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.model import QuantumModel
from pulser_diff_torch.ops import fused_evolution as tfe
from pulser_diff_torch.ops import total_magnetization
from pulser_diff_torch.ops.apply import h_apply_batched, interp_streams
from pulser_diff_torch.solvers import TimeGrid
from pulser_diff_torch.solvers import stepper_op
from pulser_diff_torch.solvers.solver import _cast_ham
from pulser_diff_torch.utils import export_step, load_meta, load_step
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import total_magnetization as j_total_mag
from pulser_diff_tpu.ops.apply import h_apply_batched as j_h_apply_batched
from pulser_diff_tpu.ops.apply import interp_streams as j_interp_streams

from tests.test_torch_model import FUSED_TOL
from tests.torch_port_cases import emulators, random_state, sequence, xy_emulators

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# the fused route: one op holds the loop, at JAX's pulse
FUSED_NS = 200
# f64 on both sides: the same steps in another order of products
F64_TOL = 1e-12
# the XY model's coordinates (2 atoms, 7.3 um apart; q1's are trainable)
XY_COORDS = ((0.0, 0.0), (7.0, 2.0))


def _sequence(core, duration: int, xy: bool = False):
    """test_misc's 2-atom sequence (a constant pulse of variable amplitude
    ``om``), or in XY mode one microwave pulse on two atoms 7.3 um apart."""
    if xy:
        reg = core.Register.from_coordinates(list(XY_COORDS), prefix="q")
    else:
        reg = core.Register({"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])})
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ch", "microwave_global" if xy else "rydberg_global")
    om = seq.declare_variable("om")
    seq.add(core.Pulse.ConstantPulse(duration, om, -0.4 if xy else -1.0, 0.3 if xy else 0.0), "ch")
    return seq


def _params(xy: bool, coords: bool = False) -> dict:
    """The trainable values: ``om``, and q1's coordinates in XY mode or
    with ``coords``."""
    p = {"om": 1.8}
    if xy:
        p["q1"] = np.asarray(XY_COORDS[1])
    elif coords:
        p["q1"] = np.array([4.0, 0.0])
    return p


def _jax_step(duration: int, xy: bool = False, coords: bool = False, **options):
    """JAX's jitted value+grad of the last expectation value, as
    tests/test_misc.py builds it: (value, {name: grad})."""
    p0 = {k: jnp.asarray(v) for k, v in _params(xy, coords).items()}
    model = JModel(_sequence(jcore, duration, xy), dict(p0), **options)
    exp_fn = model.expectation_fn(j_total_mag(2))

    def loss(p):
        _, vals = exp_fn(p)
        return vals[-1].real

    v, g = jax.jit(jax.value_and_grad(loss))(p0)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _port_step(duration: int, xy: bool = False, coords: bool = False, **options):
    """The port's value+grad step (params -> (value, {name: grad})) and its
    example input."""
    model = QuantumModel(_sequence(tcore, duration, xy), _params(xy, coords), device="cpu",
                         **options)
    exp_fn = model.expectation_fn(total_magnetization(2, device="cpu"))

    def step(p):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        _, vals = exp_fn(q)
        grads = torch.autograd.grad(vals[-1], list(q.values()))
        return vals[-1].detach(), {k: g.detach() for k, g in zip(q, grads)}

    p0 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in _params(xy, coords).items()}
    return step, p0


def _roundtrip(tmp_path, name: str, step, p0):
    """export_step -> load_meta -> load_step -> one call."""
    path = export_step(step, (p0,), str(tmp_path / f"{name}.pt2"))
    meta = load_meta(path)
    assert meta["device_type"] == "cpu" and meta["nr_args"] == 1
    assert meta["in_avals"] == [f"float64{list(v.shape)}" for v in p0.values()]
    assert meta["torch_version"] == torch.__version__
    return path, meta, load_step(path, device="cpu")(p0)


def _assert_same(got, want) -> None:
    """Bit for bit: value and every gradient."""
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), (k, got[1][k], want[1][k])


def test_load_step_device_check(tmp_path, monkeypatch):
    """A CPU artifact loads with device="cpu"; asked for CUDA, or with no
    device (which means CUDA), it raises ValueError naming both device
    types, before CUDA is touched.  (The JAX package's ``platforms=``, an
    export for another platform, has no counterpart: torch.export traces
    on the device it runs on.)"""

    def f(x):
        return (x * x).sum()

    path = export_step(f, (torch.ones(4, dtype=torch.float64),), str(tmp_path / "f.pt2"))
    fn = load_step(path, device="cpu")
    assert float(fn(torch.ones(4, dtype=torch.float64))) == 4.0

    def touched():
        raise AssertionError("CUDA was queried")

    monkeypatch.setattr(torch.cuda, "is_available", touched)
    for device in ("cuda", None):
        with pytest.raises(ValueError, match="'cpu'.*'cuda'"):
            load_step(path, device=device)
    assert load_meta(path)["custom_ops"] == []


# (options, XY mode, q1's coordinates trainable, the graph's ops)
FUSED_CASES = {
    "K1/K2": ({"solver": "DP5_PALLAS"}, False, False, ("fused_bwd", "fused_fwd")),
    "K4/K5": ({"solver": "DP5_PALLAS", "ckpt": True}, False, False,
              ("fused_bwd_ckpt", "fused_fwd_ckpt")),
    "K1/K2 kron": ({"solver": "DP5_PALLAS"}, True, True, ("fused_bwd", "fused_fwd")),
    "K1/K2 coords": ({"solver": "DP5_PALLAS"}, False, True, ("fused_bwd", "fused_fwd")),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_export_fused_route(tmp_path, case):
    """The fused route on the CPU (the kernels' plain versions): the
    exported graph holds the forward op and its adjoint, the reloaded step
    equals the eager step bit for bit, and the eager step equals JAX's
    fused step (Pallas in interpret mode) within tests/test_torch_model.py's
    parity; with trainable coordinates (kron pairs, or the ising
    interaction diagonal) the coordinate gradient included."""
    options, xy, coords, ops = FUSED_CASES[case]
    step, p0 = _port_step(FUSED_NS, xy, coords, **options)
    _, meta, got = _roundtrip(tmp_path, "fused", step, p0)
    assert meta["custom_ops"] == [f"pulser_diff_torch::{op}" for op in ops]
    want = step(p0)
    _assert_same(got, want)
    jv, jg = _jax_step(FUSED_NS, xy, coords, **options)
    assert abs(float(want[0]) - jv) < FUSED_TOL
    assert jg.keys() == want[1].keys()
    for k, g in jg.items():
        np.testing.assert_allclose(want[1][k].numpy(), g, rtol=0, atol=FUSED_TOL)
    if coords:
        assert float(want[1]["q1"].abs().max()) > 1e-5


def test_ising_diag_matches_jax_at_12_atoms():
    """The interaction diagonal of bench.py's 12-atom register (3 x 4 at 10
    um; the products written as mm, not einsums, so that the trace sees
    them) and its coordinate gradient equal the JAX package's at 1e-12."""
    coords = [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(12)]
    weights = np.random.default_rng(12).normal(size=(64, 64))

    def build(core, q):
        reg = core.Register.from_coordinates(coords, prefix="q").with_coords({"q1": q})
        seq = core.Sequence(reg, core.MockDevice)
        seq.declare_channel("ch", "rydberg_global")
        seq.add(core.Pulse.ConstantPulse(20, 1.0, -1.0, 0.0), "ch")
        return seq

    q = torch.tensor([10.0, 0.5], dtype=torch.float64, requires_grad=True)
    th = QuantumModel(build(tcore, q), {}, device="cpu")._make_emulator({})._hamiltonian
    tdiag = th._ham_data.int_diag
    (tg,) = torch.autograd.grad((tdiag * torch.tensor(weights)).sum(), [q])

    def jdiag(jq):
        return JModel(build(jcore, jq), {})._make_emulator({})._hamiltonian._ham_data.int_diag

    jq = jnp.asarray([10.0, 0.5])
    np.testing.assert_allclose(tdiag.detach().numpy(), np.asarray(jdiag(jq)), rtol=0,
                               atol=F64_TOL)
    jg = jax.grad(lambda x: (jdiag(x) * weights).sum())(jq)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=F64_TOL)
    assert float(tg.abs().max()) > 1e-3


# the time (us) and state batch of the XY right-hand side
RHS_T = 0.137
RHS_NB = 2


def _xy_rhs_loss(out):
    """A real scalar of H psi whose gradient reaches the kron matrices."""
    return (out.re * out.re).sum() + (out.im * out.re).sum()


def test_export_xy_stepper_rhs(tmp_path):
    """One right-hand side of the f64 XY stepper: q1's coordinates build
    the Hamiltonian (kron pairs), ``h_apply_batched`` applies it once to a
    seeded state batch, and ``torch.autograd.grad`` takes the coordinate
    gradient of a scalar of it.  The step exports and reloads bit for bit;
    H psi and the gradient equal JAX's ``h_apply_batched`` and ``jax.grad``
    at 1e-12 (f64 on both sides)."""
    model = QuantumModel(_sequence(tcore, FUSED_NS, True), _params(True), device="cpu")
    psi = random_state(4, RHS_NB, seed=5).T.reshape(RHS_NB, 2, 2)
    tpsi = Cplx(torch.tensor(psi.real), torch.tensor(psi.imag))

    def step(q1):
        q = q1.detach().requires_grad_(True)
        hd = model._make_emulator({"om": model.params["om"].detach(), "q1": q})._hamiltonian
        hd = hd._ham_data
        assert hd.kron_row is not None
        zr, zc, zk = interp_streams(hd, torch.tensor(RHS_T, dtype=torch.float64))
        out = h_apply_batched(hd, zr, zc, zk, tpsi)
        (g,) = torch.autograd.grad(_xy_rhs_loss(out), [q])
        return out.re.detach(), out.im.detach(), g.detach()

    q0 = torch.tensor(XY_COORDS[1], dtype=torch.float64)
    path = export_step(step, (q0,), str(tmp_path / "rhs.pt2"))
    assert load_meta(path)["custom_ops"] == []
    got, want = load_step(path, device="cpu")(q0), step(q0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[2].abs().max()) > 1e-3

    jmodel = JModel(_sequence(jcore, FUSED_NS, True), {k: jnp.asarray(v)
                                                        for k, v in _params(True).items()})
    jpsi = JCplx(jnp.asarray(psi.real), jnp.asarray(psi.imag))

    def jrhs(q1):
        hd = jmodel._make_emulator({"om": jmodel.params["om"], "q1": q1})._hamiltonian._ham_data
        zr, zc, zk = j_interp_streams(hd, jnp.asarray(RHS_T))
        return j_h_apply_batched(hd, zr, zc, zk, jpsi)

    jq = jnp.asarray(XY_COORDS[1])
    jout = jrhs(jq)
    jg = jax.grad(lambda q: _xy_rhs_loss(jrhs(q)))(jq)
    for a, b in ((want[0], jout.re), (want[1], jout.im), (want[2], jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=F64_TOL)


def test_export_checks_the_register_eagerly(tmp_path):
    """The trace skips the register's geometric checks (they read values):
    a step that builds a sequence on its input coordinates exports.  But
    export_step calls the step eagerly first, so atoms closer than the
    device allows (AnalogDevice: 5 um) still raise."""

    def step(coords):
        reg = tcore.Register({"q0": coords[0], "q1": coords[1]})
        return tcore.Sequence(reg, tcore.AnalogDevice).register.coords_array.sum()

    ok = torch.tensor([[0.0, 0.0], [8.0, 0.0]], dtype=torch.float64)
    path = export_step(step, (ok,), str(tmp_path / "ok.pt2"))
    assert float(load_step(path, device="cpu")(ok)) == 8.0
    with pytest.raises(ValueError, match="inter-atom distance"):
        export_step(step, (ok / 8.0,), str(tmp_path / "bad.pt2"))


def _op_args(ckpt: bool, xy: bool):
    """(op, arguments) of the forward op and of its adjoint at 2 atoms on 6
    steps: the forward's data as leaves that require grad (its autograd
    rule is checked), the adjoint's with random slot cotangents (seeded)."""
    _, tsim = (xy_emulators if xy else emulators)(2, duration=6, seed=3, sampling_rate=1.0,
                                                  evaluation_times="Full")
    h = tsim._hamiltonian
    grid = TimeGrid.make(h.sampling_times, tsim._eval_times_array, torch.device("cpu"))
    psi = tsim.initial_state
    da, db = h.dim ** h._a, h.dim ** h._b
    p0 = Cplx(psi.re.T.reshape(1, da, db), psi.im.T.reshape(1, da, db))
    data = tfe.prepare_fused_inputs(h._ham_data, p0, grid.times, "DP5")
    keys, tensors = tfe._op_inputs(data)
    slots = torch.as_tensor(np.asarray(grid.write_slots, dtype=np.int32))
    n_eval, last = grid.n_eval, int(slots[-1])
    gen = torch.Generator().manual_seed(11)
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    if ckpt:
        fwd = (tfe._fwd_ckpt_op, ("DP5", keys, xy, leaves))
        st = tfe.fused_fwd_ckpt(data, "DP5")
    else:
        fwd = (tfe._fwd_op, ("DP5", keys, slots, n_eval, last, xy, leaves))
        st = tfe.fused_fwd(data, "DP5", slots, n_eval)
    lam = [torch.randn(st[0].shape, generator=gen, dtype=torch.float32) for _ in range(2)]
    if ckpt:
        bwd = (tfe._bwd_ckpt_op, ("DP5", keys, *st, *lam, tensors))
    else:
        bwd = (tfe._bwd_op, ("DP5", keys, slots, n_eval, last, *st, *lam, tensors))
    return fwd, bwd


def _stepper_op_args(kind: str):
    """(op, arguments) of ``stepper_states`` and of its adjoint at 2 atoms
    on 6 steps: the f64 stepper with kron pairs (XY), the f32 stepper, or
    the dephasing master equation (its collapse operators among the
    tensors); the forward's tensors as leaves that require grad, the
    adjoint's with random slot cotangents (seeded) and every key wanted."""
    gen = torch.Generator().manual_seed(13)
    if kind == "stepper ME":
        tsim = TorchEmulator.from_sequence(sequence(tcore, 2, 6), config=SimConfig(
            noise="dephasing", dephasing_rate=0.1), sampling_rate=1.0,
            evaluation_times="Full", device="cpu")
    else:
        _, tsim = xy_emulators(2, duration=6, seed=3, sampling_rate=1.0,
                               evaluation_times="Full")
    h = tsim._hamiltonian
    ham = h._ham_data
    grid = TimeGrid.make(h.sampling_times, tsim._eval_times_array, torch.device("cpu"))
    psi = tsim.initial_state
    if kind == "stepper ME":
        rho = Cplx(psi.re @ psi.re.T + psi.im @ psi.im.T, psi.im @ psi.re.T - psi.re @ psi.im.T)
        args = stepper_op._op_args("me", "DP5_ME", ham, rho, grid, 1, None,
                                   collapse=h._collapse_ops, n=2, d=2, form="factored")
    else:
        da, db = h.dim ** h._a, h.dim ** h._b
        p0 = Cplx(psi.re.T.reshape(1, da, db), psi.im.T.reshape(1, da, db))
        if kind == "stepper f32":
            ham, p0 = _cast_ham(ham, torch.float32), p0.to(torch.float32)
            grid = TimeGrid(times=grid.times.to(torch.float32), write_slots=grid.write_slots,
                            n_eval=grid.n_eval)
        args = stepper_op._op_args("se", "DP5_SE", ham, p0, grid, 1, None)
    cfg, slots, keys, tensors = args
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in tensors]
    outs = stepper_op._states_op(cfg, slots, keys, tensors)
    lam = [torch.randn(outs[0].shape, generator=gen, dtype=outs[0].dtype) for _ in range(2)]
    fwd = (stepper_op._states_op, (cfg, slots, keys, leaves))
    bwd = (stepper_op._states_bwd_op, (cfg, slots, keys, keys, list(outs[2:]), *lam, tensors))
    return fwd, bwd


@pytest.mark.parametrize("kind", ["K1/K2", "K4/K5", "K1/K2 kron", "stepper XY", "stepper f32",
                                  "stepper ME"])
def test_ops_pass_opcheck(kind):
    """torch.library.opcheck: each op's schema, fake implementation and
    (for the forward ops) registered autograd rule agree with its CPU
    implementation (for the fused ops the plain version)."""
    if kind.startswith("stepper"):
        pairs = _stepper_op_args(kind)
    else:
        pairs = _op_args(ckpt=kind == "K4/K5", xy=kind.endswith("kron"))
    for op, args in pairs:
        if op is stepper_op._states_bwd_op:
            _check_stepper_adjoint(op, args)
            continue
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


def _check_stepper_adjoint(op, args) -> None:
    """opcheck's schema and fake-tensor checks of ``stepper_states_bwd``,
    made by hand: opcheck runs an op under dispatch modes that read the
    storage of every tensor an inner op sees, and the adjoint's
    ``torch.func.vjp`` holds its tensors in wrappers that have none.  No
    input is mutated, no output aliases an input, and the fake
    implementation gives the real outputs' shapes, dtypes and devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree

    leaves = [t for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor)]
    before = [t.clone() for t in leaves]
    outs = op(*args)
    for t, b in zip(leaves, before):
        assert torch.equal(t, b)
    ptrs = {t.untyped_storage().data_ptr() for t in leaves}
    assert all(o.untyped_storage().data_ptr() not in ptrs for o in outs)
    with FakeTensorMode() as mode:
        fake = op(*pytree.tree_map_only(torch.Tensor, mode.from_tensor, args))
    assert [(f.shape, f.dtype, f.device) for f in fake] == [
        (o.shape, o.dtype, o.device) for o in outs]


_FRESH_PROCESS = """
import json, sys
sys.modules["jax"] = None  # any import of JAX fails
import torch
from pulser_diff_torch.utils import load_step
p = {"om": torch.tensor(1.8, dtype=torch.float64)}
out = []
for path in sys.argv[1:]:
    v, g = load_step(path, device="cpu")(p)
    out.append({"value": float(v).hex(), "grad": float(g["om"]).hex()})
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jaxlib", "pulser_diff_tpu"))
print(json.dumps({"steps": out, "bad": bad}))
"""


def test_fresh_process_reloads_without_jax(tmp_path):
    """A fresh process with JAX unimportable, which imports only
    pulser_diff_torch.utils, loads an artifact holding the fused ops and
    one holding the stepper ops (20 ns pulses: only the reload is checked
    here) and reproduces their outputs bit for bit."""
    paths, want = [], []
    for solver in ("DP5_PALLAS", "DP5_SE"):
        step, p0 = _port_step(20, solver=solver)
        paths.append(export_step(step, (p0,), str(tmp_path / f"fresh_{solver}.pt2")))
        v, g = load_step(paths[-1], device="cpu")(p0)
        want.append({"value": float(v).hex(), "grad": float(g["om"]).hex()})
    assert load_meta(paths[1])["custom_ops"] == [
        "pulser_diff_torch::stepper_states", "pulser_diff_torch::stepper_states_bwd"]
    out = subprocess.run([sys.executable, "-c", _FRESH_PROCESS, *paths], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"steps": want, "bad": []}

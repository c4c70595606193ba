"""PyTorch port vs the JAX package: export and reload of a value+grad step
on the steppers (pulser_diff_torch.utils.export, the counterpart of
pulser_diff_tpu/utils/export.py).

Under the trace ``sesolve`` runs its loop as one custom op,
``pulser_diff_torch::stepper_states``, differentiated by a second,
``::stepper_states_bwd`` (solvers/stepper_op.py), so the exported graph
does not grow with the steps.  The ports of tests/test_misc.py's export
tests, the 2-atom step on the default route (the f64 stepper) and on
``DP5_SE_F32``, and the f64 XY stepper's step with q1's coordinates
trainable, are exported at JAX's 200 ns, reloaded, and held against the
port's eager step (the value bit for bit, the gradient at 1e-12 in f64 and
within tests/test_torch_f32.py's tolerances in f32) and against JAX's
jitted step on the same pulse.  The fused route and the shared helpers are
in test_torch_export.py; the Lindblad, evaluation-time, Krylov and
adaptive routes in test_torch_export_solvers.py.
"""

import torch

import pulser_diff_torch.core as tcore
from pulser_diff_torch import SimConfig, TorchEmulator
from pulser_diff_torch.ops import total_magnetization
from pulser_diff_torch.solvers import stepper_op
from pulser_diff_torch.utils import export_step

from tests.test_torch_export import F64_TOL, _jax_step, _port_step, _roundtrip
from tests.test_torch_f32 import GRAD_REL_TOL, STATE_TOL
from tests.torch_port_cases import sequence

torch.set_num_threads(1)

# JAX's own pulse (tests/test_misc.py): 200 steps of the 2-atom model
STEPPER_NS = 200
# the shortest pulse the sampler takes (4 samples at 1 GHz)
SHORT_NS = 4
STEPPER_OPS = ["pulser_diff_torch::stepper_states", "pulser_diff_torch::stepper_states_bwd"]


def _assert_close(got, want, tol: float, rel: bool = False) -> None:
    """The value bit for bit, every gradient within ``tol`` (absolute, or
    relative to its largest magnitude)."""
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        scale = float(want[1][k].abs().max()) if rel else 1.0
        assert float((got[1][k] - want[1][k]).abs().max()) <= tol * scale, (k, got, want)


def test_export_step_roundtrip(tmp_path):
    """The default route (the f64 stepper) at 200 ns: the graph holds the
    stepper ops; the reloaded step equals the eager step (the value bit for
    bit, the gradient at 1e-12) and JAX's jitted step at 1e-12; the export
    leaves the model's eager step as it was."""
    step, p0 = _port_step(STEPPER_NS)
    before = step(p0)
    path, meta, got = _roundtrip(tmp_path, "step", step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    assert meta["out_avals"] == ["float64[]", "float64[]"]
    after = step(p0)
    _assert_close(after, before, 0.0)
    _assert_close(got, after, F64_TOL)
    jv, jg = _jax_step(STEPPER_NS)
    assert abs(float(got[0]) - jv) < F64_TOL
    assert abs(float(got[1]["om"]) - float(jg["om"])) < F64_TOL
    assert abs(float(got[1]["om"])) > 1e-6  # the gradient is there


def test_export_step_f32_solver(tmp_path):
    """DP5_SE_F32 (the f32 stepper) exports and reloads like the f64 one:
    the value equal to the eager step's bit for bit, the gradient within
    tests/test_torch_f32.py's relative tolerance of it; both within those
    tolerances of JAX's."""
    step, p0 = _port_step(STEPPER_NS, solver="DP5_SE_F32")
    _, meta, got = _roundtrip(tmp_path, "step32", step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    _assert_close(got, step(p0), GRAD_REL_TOL, rel=True)
    jv, jg = _jax_step(STEPPER_NS, solver="DP5_SE_F32")
    assert abs(float(got[0]) - jv) < STATE_TOL * abs(jv) * 10
    assert abs(float(got[1]["om"]) - float(jg["om"])) / abs(float(jg["om"])) < GRAD_REL_TOL


def test_export_graph_does_not_grow_with_the_steps(tmp_path):
    """The f64 step's exported graph has as many nodes at 200 ns (200
    steps) as at 4 ns (4 steps): the loop is one op."""
    nodes = []
    for ns in (SHORT_NS, STEPPER_NS):
        step, p0 = _port_step(ns)
        path = export_step(step, (p0,), str(tmp_path / f"step{ns}.pt2"))
        nodes.append(len(torch.export.load(path).graph.nodes))
    assert nodes[0] == nodes[1], nodes


def test_export_xy_stepper_step(tmp_path):
    """The f64 XY stepper's whole step at 200 ns, q1's coordinates
    trainable (the kron pairs' matrices are inputs of the op): the
    reloaded step equals the eager step (the value bit for bit, the
    gradients at 1e-12) and JAX's jitted step at 1e-12."""
    step, p0 = _port_step(STEPPER_NS, xy=True)
    _, meta, got = _roundtrip(tmp_path, "xy", step, p0)
    assert meta["custom_ops"] == STEPPER_OPS
    _assert_close(got, step(p0), F64_TOL)
    jv, jg = _jax_step(STEPPER_NS, xy=True)
    assert abs(float(got[0]) - jv) < F64_TOL
    for k, g in jg.items():
        assert float((got[1][k] - torch.tensor(g)).abs().max()) < F64_TOL, k
    assert float(got[1]["q1"].abs().max()) > 1e-6


def test_eager_solves_never_call_the_stepper_op(monkeypatch):
    """Eagerly sesolve and mesolve run their Python loop: with the op and
    its wrapper made to raise, an eager value+grad step on the f64 and f32
    steppers and a Lindblad run() go through."""

    def refuse(*args, **kwargs):
        raise AssertionError("the stepper op was called eagerly")

    monkeypatch.setattr(stepper_op, "run_stepper", refuse)
    monkeypatch.setattr(stepper_op, "_states_op", refuse)
    for solver in ("DP5_SE", "DP5_SE_F32"):
        step, p0 = _port_step(20, solver=solver)
        assert abs(float(step(p0)[1]["om"])) > 0.0
    sim = TorchEmulator.from_sequence(sequence(tcore, 2, 20), config=SimConfig(
        noise="dephasing", dephasing_rate=0.1), evaluation_times="Minimal", device="cpu")
    val = sim.run().expect([total_magnetization(2, device="cpu")])[0].re[-1]
    assert torch.isfinite(val)

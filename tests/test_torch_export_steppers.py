"""PyTorch port vs the JAX package: export and reload of a value+grad step
on the steppers (pulser_diff_torch.utils.export, the counterpart of
pulser_diff_tpu/utils/export.py).

The ports of tests/test_misc.py's export tests: the 2-atom step on the
default route (the f64 stepper) and on ``DP5_SE_F32`` is exported,
reloaded and held bit for bit against the port's eager step, and against
JAX's jitted step on the same pulse.  The steppers' loop unrolls under the
trace (its export time grows with the steps), so both packages run at
``SHORT_NS``.  The fused route and the shared helpers are in
test_torch_export.py; this file stands apart so that a run that spreads
test files over workers puts these two long exports beside it.
"""

import torch

from tests.test_torch_export import F64_TOL, _assert_same, _jax_step, _port_step, _roundtrip
from tests.test_torch_f32 import GRAD_REL_TOL, STATE_TOL

torch.set_num_threads(1)

# the f64 and f32 steppers' pulse: the shortest the sampler takes (4
# samples at 1 GHz).  The trace records every op of every stage of every
# step: on one CPU thread the f64 step took 53.3 s to export and 28.4 s to
# reload at 4 ns (4 steps, 16720 graph nodes), 112.3 s and 71.8 s at 8 ns
# (export_timing.py).
SHORT_NS = 4


def test_export_step_roundtrip(tmp_path):
    """The default route (the f64 stepper): exported, reloaded, equal to
    the eager step bit for bit and to JAX's jitted step at 1e-12; the
    export leaves the model's eager step as it was."""
    step, p0 = _port_step(SHORT_NS)
    before = step(p0)
    path, meta, got = _roundtrip(tmp_path, "step", step, p0)
    assert meta["custom_ops"] == [] and meta["out_avals"] == ["float64[]", "float64[]"]
    after = step(p0)
    _assert_same(after, before)
    _assert_same(got, after)
    jv, jg = _jax_step(SHORT_NS)
    assert abs(float(got[0]) - jv) < F64_TOL
    assert abs(float(got[1]["om"]) - float(jg["om"])) < F64_TOL
    assert abs(float(got[1]["om"])) > 1e-6  # the gradient is there


def test_export_step_f32_solver(tmp_path):
    """DP5_SE_F32 (the f32 stepper) exports and reloads like the f64 one:
    equal to the eager step bit for bit, to JAX's within
    tests/test_torch_f32.py's tolerances."""
    step, p0 = _port_step(SHORT_NS, solver="DP5_SE_F32")
    _, _, got = _roundtrip(tmp_path, "step32", step, p0)
    _assert_same(got, step(p0))
    jv, jg = _jax_step(SHORT_NS, solver="DP5_SE_F32")
    assert abs(float(got[0]) - jv) < STATE_TOL * abs(jv) * 10
    assert abs(float(got[1]["om"]) - float(jg["om"])) / abs(float(jg["om"])) < GRAD_REL_TOL

"""Export and reload of a traced simulation step (counterpart of
pulser_diff_tpu/utils/export.py).

A trained model's value+grad step (a function of the parameters that calls
``torch.autograd.grad``) is traced once with ``torch.export`` and written
with ``torch.export.save``; ``load_step`` reloads it, in a fresh process if
need be, as a callable that runs the traced graph: no Python front end, no
Hamiltonian build, no autograd, for serving a fixed pulse program.  The
fused kernels K1/K2/K4/K5 are ``torch.library`` custom ops
(``pulser_diff_torch::fused_*``, ``ops/fused_evolution.py``), so a step on
the fused route holds them, forward and adjoint, in the artifact; on every
other route ``sesolve`` / ``mesolve`` run their loop under the trace as the
custom op ``pulser_diff_torch::stepper_states`` and its adjoint
``::stepper_states_bwd`` (``solvers/stepper_op.py``), and ``mcsolve`` its
trajectories as ``::mcwf_states`` and ``::mcwf_states_bwd``
(``solvers/mcwf_op.py``).

Notes:
- The artifact is tied to the device type it was traced on: a step traced
  on CUDA tensors launches the CUDA kernels, one traced on the CPU runs
  their plain versions.  ``torch.export`` does not lower for a device it
  does not trace on, so there is no counterpart of the JAX package's
  ``platforms=``; the device type is stored alongside and checked at load.
- Inputs must keep the exported shapes and dtypes.
- The loop over steps lives inside one op on every route, so the artifact
  and the time to export it do not grow with the steps: a 2-atom f64 step
  has 363 graph nodes at 4 ns and at 200 ns and exports in 3.8 s / 5.7 s
  on one CPU thread, its eager call included; a 2-atom MCWF step 424
  nodes at 80 and at 400 ns, 5.7 s / 9.2 s (``export_timing.py``).
- Draws are constants of the artifact, as a JAX key drawn under
  ``jax.jit`` is: the noise a step's trace draws (``draw_noise``) and the
  uniforms of an MCWF ``key`` are made on real tensors
  (``config.constant_under_export``), so every call of the reloaded step,
  in the exporting process or a fresh one, serves that one realization,
  while the eager step draws anew at each call.  ``export_step`` refuses a
  graph that would draw from a lifted ``torch.Generator``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from pulser_diff_torch.config import DeviceLike, resolve_device

_META_SUFFIX = ".meta.json"
_OP_NAMESPACE = "pulser_diff_torch"


class _Step(torch.nn.Module):
    def __init__(self, fn: Callable[..., Any]) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, *args: Any) -> Any:
        return self.fn(*args)


def _avals(tree: Any) -> list[str]:
    """dtype[shape] of every tensor leaf, as ``float64[8]``."""
    return [f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
            for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _custom_ops(exported: torch.export.ExportedProgram) -> list[str]:
    """The ``pulser_diff_torch::`` ops the exported graphs call."""
    names = set()
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                target = node.target
                if node.op == "call_function" and isinstance(target, torch._ops.OpOverload) \
                        and target.namespace == _OP_NAMESPACE:
                    names.add(target._schema.name)
    return sorted(names)


def _lifted_generators(exported: torch.export.ExportedProgram) -> list[str]:
    """The names of the ``torch.Generator`` objects the trace lifted into
    the graph: a draw from one of them is not a constant of the artifact
    (the object advances at every call, and ``torch.export.save`` does not
    keep its state)."""
    return sorted(name for name, obj in exported.constants.items()
                  if isinstance(obj, torch.Generator))


def export_step(fn: Callable[..., Any], example_args: Sequence[Any], path: str) -> str:
    """Export ``fn`` at ``example_args``'s shapes to ``path``.

    ``fn`` maps the step's inputs (e.g. a dict of parameter tensors) to its
    outputs, e.g. a value+grad step written with ``torch.autograd.grad``
    (``torch.func.grad_and_value`` does not trace under ``torch.export``).
    It is first called eagerly on ``example_args``: every check of the
    build runs there on real values (the trace skips the checks that read
    values, as the JAX package skips them on traced arrays), and the
    model's caches (the substep count) are filled from real values.  Then
    it is traced with ``torch.export.export(..., strict=False)``
    (``strict=True`` refuses ``torch.autograd.grad``), written with
    ``torch.export.save``, and described in ``path + ".meta.json"``.
    A graph that draws from a lifted ``torch.Generator`` raises ValueError
    naming it, before anything is written: the artifact keeps the draws
    its trace made (``config.constant_under_export``), as the JAX
    package's does.  Returns the path written."""
    example_args = tuple(example_args)
    out = fn(*example_args)
    devices = {t.device.type for t in pytree.tree_leaves((example_args, out))
               if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"A step runs on one device type; its tensors are on {sorted(devices)}.")
    exported = torch.export.export(_Step(fn), example_args, strict=False)
    generators = _lifted_generators(exported)
    if generators:
        raise ValueError(
            f"The exported step draws from the torch.Generator object(s) {generators} at every "
            "call; make the trace's draws with config.constant_under_export so that the "
            "artifact keeps them.")
    path = os.path.abspath(path)
    torch.export.save(exported, path)
    meta = {
        "device_type": devices.pop(),
        "nr_args": len(example_args),
        "in_avals": _avals(example_args),
        "out_avals": _avals(out),
        "torch_version": torch.__version__,
        "custom_ops": _custom_ops(exported),
    }
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_step(path: str, *, device: DeviceLike = None,
              check_device: bool = True) -> Callable[..., Any]:
    """Load a step written by :func:`export_step`; returns a callable
    running the traced graph.  ``device`` is resolved as every entry point
    resolves it (CUDA unless given); with ``check_device`` an artifact
    traced on another device type raises ValueError, before CUDA is
    touched."""
    meta = load_meta(path)
    want = torch.device(device).type if device is not None else "cuda"
    if check_device and want != meta["device_type"]:
        raise ValueError(
            f"Artifact was exported on device type '{meta['device_type']}' but is loaded for "
            f"'{want}'. Pass check_device=False to try anyway.")
    resolve_device(device)
    # the custom ops (the fused kernels', the steppers' loop) must be
    # registered before the graph that calls them is read
    from pulser_diff_torch.solvers import mcwf_op, stepper_op  # noqa: F401

    return torch.export.load(os.path.abspath(path)).module()


def load_meta(path: str) -> dict[str, Any]:
    """Read the sidecar metadata written by :func:`export_step`."""
    with open(os.path.abspath(path) + _META_SUFFIX) as f:
        return json.load(f)

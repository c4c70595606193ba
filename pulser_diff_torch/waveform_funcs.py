"""Smooth envelopes for duration-differentiable pulses (counterpart of
pulser_diff_tpu/waveform_funcs.py).

A boxcar built from tanh edges makes the pulse duration a smooth, hence
differentiable, parameter.  Tensors in, tensors out; a deferred sequence
``Expr`` needs ``Expr.tanh``, which comes with the rest of the front end
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from pulser_diff_torch.core.variables import Expr


def constant_waveform(
    ti: Any,
    tf: Any,
    value: Any,
    edge_steepness: float = 1.0,
) -> Callable:
    """Returns ``f(t_ns)`` = value * smooth-boxcar(t; ti, tf).

    ti/tf are in us (multiplied by 1000 inside); the edges are tanh
    sigmoids of width ~1/edge_steepness ns.
    """
    if any(isinstance(x, Expr) for x in (ti, tf, value)):
        raise NotImplementedError(
            "constant_waveform of a sequence Expr needs Expr.tanh, which is not ported yet "
            "(ROADMAP queue 1 item 7); pass tensors.")

    def pulse_envelope(t: Any) -> Any:
        is_zero = isinstance(ti, (int, float)) and ti == 0
        if is_zero:
            return value * 0.5 * (1.0 + torch.tanh(edge_steepness * (-(t - tf * 1000))))
        return value * (
            0.5 * (1.0 + torch.tanh(edge_steepness * (t - ti * 1000)))
            + 0.5 * (1.0 + torch.tanh(edge_steepness * (-(t - tf * 1000))))
            - 1.0
        )

    return pulse_envelope

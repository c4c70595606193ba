"""Smooth envelopes for duration-differentiable pulses (counterpart of
pulser_diff_tpu/waveform_funcs.py).

A boxcar built from tanh edges makes the pulse duration a smooth, hence
differentiable, parameter.  Works on tensors or deferred sequence
``Expr``s.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from pulser_diff_torch.core.variables import Expr


def _tanh(x: Any) -> Any:
    return x.tanh() if isinstance(x, Expr) else torch.tanh(x)


def constant_waveform(
    ti: Any,
    tf: Any,
    value: Any,
    edge_steepness: float = 1.0,
) -> Callable:
    """Returns ``f(t_ns)`` = value * smooth-boxcar(t; ti, tf).

    ti/tf are in us (multiplied by 1000 inside); the edges are tanh
    sigmoids of width ~1/edge_steepness ns.  Accepts tensors or deferred
    sequence Exprs for ti/tf/value.
    """

    def pulse_envelope(t: Any) -> Any:
        is_zero = isinstance(ti, (int, float)) and ti == 0
        if is_zero:
            return value * 0.5 * (1.0 + _tanh(edge_steepness * (-(t - tf * 1000))))
        return value * (
            0.5 * (1.0 + _tanh(edge_steepness * (t - ti * 1000)))
            + 0.5 * (1.0 + _tanh(edge_steepness * (-(t - tf * 1000))))
            - 1.0
        )

    return pulse_envelope

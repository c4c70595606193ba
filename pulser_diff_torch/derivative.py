"""Derivative helpers (counterpart of pulser_diff_tpu/derivative.py).

  - :func:`deriv_time`: d f(t_i) / d t_i for a function of the evaluation
    times (``TorchEmulator.expectation_fn_of_times``), with the repair of
    the pulse-boundary samples (:func:`_fix_border_vals`);
  - :func:`deriv_param`: the gradient of f in a list of parameters at one
    selected evaluation time.

Both take a callable and differentiate it with ``torch.autograd.grad``
against an all-ones or a one-hot cotangent, as the JAX package does with
``jax.vjp``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch



def _fix_border_vals(deriv: np.ndarray, border_indices: Sequence[int], dt: float) -> np.ndarray:
    """The derivative with its values at pulse boundaries replaced by a
    linear extrapolation from the neighbouring samples: a piecewise
    continuous pulse makes df/dt jump at a slot's edge, and the autodiff
    value there mixes both sides."""
    deriv = np.array(deriv, copy=True)
    prev_idx = 0
    for idx in border_indices:
        if idx == 0:
            deriv[0] = deriv[2] - ((deriv[2] - deriv[1]) / dt) * 2 * dt
        elif (idx - prev_idx) != 1 or idx + 3 >= len(deriv):
            deriv[idx - 1] = deriv[idx - 3] + ((deriv[idx - 2] - deriv[idx - 3]) / dt) * 2 * dt
            deriv[idx] = deriv[idx - 2] + ((deriv[idx - 1] - deriv[idx - 2]) / dt) * 2 * dt
        else:
            deriv[idx] = deriv[idx + 2] - ((deriv[idx + 2] - deriv[idx + 1]) / dt) * 2 * dt
        prev_idx = idx
    return deriv


def deriv_time(f: Callable[[torch.Tensor], torch.Tensor], times,
               pulse_endtimes: Optional[list] = None) -> torch.Tensor:
    """df/dt at each evaluation time: the vector-Jacobian product of the
    real function ``f`` (times (n,) -> values (n,)) with an all-ones
    cotangent.  With ``pulse_endtimes`` (``TorchEmulator.endtimes``) the
    boundary samples are rebuilt by linear extrapolation."""
    # the times keep a tensor's dtype, as jax.vjp keeps them
    dt = times.dtype if isinstance(times, torch.Tensor) else torch.float64
    t = torch.as_tensor(times, dtype=dt).detach().clone().requires_grad_(True)
    val = f(t)
    (res,) = torch.autograd.grad(val, t, torch.ones_like(val))
    if pulse_endtimes is not None:
        dt = float(t[1].detach() - t[0].detach())
        fixed = _fix_border_vals(res.detach().cpu().numpy(), pulse_endtimes, dt)
        res = torch.as_tensor(fixed, dtype=res.dtype, device=res.device)
    return res


def deriv_param(f: Callable[..., torch.Tensor],
                x: Union[Sequence[torch.Tensor], torch.Tensor], times=None,
                t: Optional[float] = None) -> tuple:
    """The gradient of ``f(*x)`` (values over the evaluation times) in
    each parameter of ``x`` (tensors with ``requires_grad``) at one time:
    the one nearest ``t`` (ns) among ``times`` (us), the last time by
    default.  Returns one gradient a parameter."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    val = f(*xs)
    v = torch.zeros_like(val)
    if times is None:
        v[-1] = 1.0
    else:
        times_np = np.asarray(torch.as_tensor(times).detach().cpu(), dtype=np.float64)
        tt = float(times_np[-1]) if t is None else float(t) / 1000
        v[int(np.abs(times_np - tt).argmin())] = 1.0
    return torch.autograd.grad(val, xs, v)

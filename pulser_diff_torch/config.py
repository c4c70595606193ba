"""The default dtype and device resolution (counterpart of
pulser_diff_tpu/config.py).

The default dtype is the one piece of global state the port keeps, as the
JAX package keeps it: ``set_default_dtype(torch.float32)`` makes the
parameters, the register, the samples, the Hamiltonian, the time grid and
the states of every later build float32, as the JAX package's
``set_default_dtype(jnp.float32)`` does.  It is the port's own global and
never touches ``torch.set_default_dtype``.  Where the port needs float64
whatever the default (host reads, the f64 references, the hi/lo split's
source), it names ``torch.float64``; the fused kernels take float32 words.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a device and without CUDA they raise: nothing falls back to the
CPU on its own.

A random draw made while ``torch.export`` traces a step is made on real
tensors (``constant_under_export``), so it enters the exported graph as a
constant and every call of the artifact reuses it, as a JAX key drawn
from under ``jax.jit`` is a constant of the compiled program.
"""

from __future__ import annotations

from typing import Callable, TypeVar, Union

import torch
from torch.utils._python_dispatch import _disable_current_modes

T = TypeVar("T")

# real dtype of the state, coefficient and Hamiltonian arrays
_DEFAULT_DTYPE = torch.float64


def set_default_dtype(dtype: torch.dtype) -> None:
    """Make ``dtype`` (``torch.float32`` or ``torch.float64``) the real
    dtype of every later build; ValueError otherwise."""
    global _DEFAULT_DTYPE
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("default dtype must be float32 or float64")
    _DEFAULT_DTYPE = dtype


def default_dtype() -> torch.dtype:
    """The real dtype of the state, coefficient and Hamiltonian arrays."""
    return _DEFAULT_DTYPE


DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises RuntimeError when no device is given and CUDA is absent.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available. pulser_diff_torch runs on the "
                "GPU by default; pass device='cpu' to run on the CPU."
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Device {dev} was requested but CUDA is absent.")
    return dev


def constant_under_export(draw: Callable[[], T]) -> T:
    """``draw()``.  Under ``torch.export`` it runs outside the trace's
    dispatch modes, so the tensors it returns are real and enter the
    exported graph as constants: the artifact keeps the draws its trace
    made and every call reuses them, in the exporting process and in a
    fresh one, and the generator it reads never becomes an object of the
    graph.  Eagerly it is a plain call (each call draws anew)."""
    if not torch.compiler.is_exporting():
        return draw()
    with _disable_current_modes():
        return draw()

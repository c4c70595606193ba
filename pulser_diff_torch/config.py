"""Dtype helpers and device resolution (counterpart of pulser_diff_tpu/config.py).

The JAX package switches its process into x64 mode at import.  The port
changes no global state: every tensor it makes gets an explicit dtype
(``DTYPE`` for the f64 paths, ``torch.float32`` inside the fused kernels)
and an explicit device.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a device and without CUDA they raise: nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

# real dtype of the f64 paths (state, coefficients, Hamiltonian parts)
DTYPE = torch.float64

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

"""Parameter checkpoints (counterpart of pulser_diff_tpu/utils/checkpoint.py).

``save_params`` writes a flat dict of tensors with ``torch.save``, or, for
a path ending in ``.npz``, as numpy's npz: the form the JAX package writes
when orbax is absent, which ``load_params`` reads too.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from pulser_diff_torch.config import DeviceLike, resolve_device


def save_params(path: str, params: Mapping[str, Any], step: Optional[int] = None) -> str:
    """Save a flat params dict (tensors or arrays) to ``path``, or to
    ``path/step_<step>.pt`` with ``step``; returns the path written."""
    target = os.path.join(path, f"step_{step}.pt") if step is not None else path
    os.makedirs(os.path.dirname(os.path.abspath(target)), exist_ok=True)
    host = {k: torch.as_tensor(v).detach().cpu() for k, v in params.items()}
    if target.endswith(".npz"):
        np.savez(target, **{k: v.numpy() for k, v in host.items()})
    else:
        torch.save(host, target)
    return target


def load_params(path: str, device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """The params dict saved at ``path`` on ``device`` (CUDA unless
    given): a ``torch.save`` file, or an npz (``path`` itself, or
    ``path + ".npz"`` as the JAX package names its fallback), with the
    dtypes stored."""
    dev = resolve_device(device)
    npz = path if path.endswith(".npz") else path + ".npz"
    if path.endswith(".npz") or (not os.path.exists(path) and os.path.isfile(npz)):
        with np.load(npz) as data:
            return {k: torch.as_tensor(data[k], device=dev) for k in data.files}
    return torch.load(path, map_location=dev, weights_only=True)

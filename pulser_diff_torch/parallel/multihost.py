"""Multi-host parameter sweeps (counterpart of pulser_diff_tpu/parallel/multihost.py).

``parallel.mesh`` shards noise realizations and states over the ranks of
one group.  This module adds the sweep axis: a stack of parameter sets
laid out ACROSS hosts ("param") while each host's own ranks split the
runs ("runs"), so the only traffic between hosts is the per-param
reduction's.

Usage (the same program on every rank, e.g. under ``torchrun
--nnodes H --nproc-per-node N``, or started by hand):

    from pulser_diff_torch.parallel import multihost as mh
    mh.initialize(coordinator_address, num_processes, process_id)
    mesh = mh.param_runs_mesh()          # ("param", "runs")
    losses = mh.param_sweep(loss_fn, param_stack, seeds, mesh)

On the CPU every rank is a gloo process (``tests/test_torch_multihost.py``
runs 2 hosts x 2 ranks on localhost).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.parallel.mesh import (
    _block, _require_group, distribute, make_mesh, placements,
)

__all__ = ["initialize", "param_runs_mesh", "global_array", "param_sweep", "placements"]


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None) -> None:
    """Join the process group at ``coordinator_address`` ("host:port") as
    rank ``process_id`` of ``num_processes``: NCCL where the process has a
    GPU (each rank on card ``process_id`` modulo the host's cards), gloo
    otherwise, unless ``backend`` names one."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def param_runs_mesh(param_axis: str = "param", runs_axis: str = "runs",
                    device_type: DeviceLike = None) -> DeviceMesh:
    """The 2-D mesh of the group: ``param`` across hosts, ``runs`` over
    each host's ranks (``LOCAL_WORLD_SIZE``, which torchrun sets, else 1)."""
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    _require_group()
    return make_mesh({param_axis: dist.get_world_size() // local_size, runs_axis: local_size},
                     device_type=device_type)


def global_array(x, mesh: DeviceMesh, places: Sequence) -> DTensor:
    """A DTensor from host-replicated data (every rank passes the same
    full ``x``): each rank keeps its own block, no communication."""
    return distribute(torch.as_tensor(x), mesh, places)


def param_sweep(
    loss_fn: Callable[[torch.Tensor, int], torch.Tensor],
    param_stack,
    seeds,
    mesh: DeviceMesh,
    param_axis: str = "param",
    runs_axis: str = "runs",
    with_grad: bool = False,
):
    """Mean-over-runs loss for every parameter set in the stack.

    ``loss_fn(params, seed)`` -> scalar; ``param_stack``: a tensor (or a
    DTensor from :func:`global_array`) with a leading (n_param,) axis;
    ``seeds``: (n_param, n_runs) integers.  Each rank takes its block of
    params along ``param_axis`` and its block of runs along
    ``runs_axis``; the mean over runs is one all_reduce over the runs
    axis (the losses and, with ``with_grad``, the gradients in one
    buffer).  Returns the (n_param,) losses as a DTensor placed
    ``Shard(0)`` on ``param_axis`` (``Replicate()`` on ``runs_axis``),
    and with ``with_grad=True`` also the gradients (n_param, ...), placed
    alike.
    """
    full = param_stack.full_tensor() if isinstance(param_stack, DTensor) else param_stack
    full = torch.as_tensor(full)
    seeds = np.asarray(seeds)
    n_param, n_runs = seeds.shape
    mine = full[_block(n_param, mesh, param_axis, "n_param")]
    my_seeds = seeds[_block(n_param, mesh, param_axis, "n_param"),
                     _block(n_runs, mesh, runs_axis, "n_runs")]
    losses, grads = [], []
    for p, row in zip(mine, my_seeds):
        p = p.detach().clone().requires_grad_(with_grad)
        with torch.set_grad_enabled(with_grad):
            total = torch.stack([loss_fn(p, int(s)) for s in row]).sum()
        losses.append(total.detach().reshape(1))
        if with_grad:
            (g,) = torch.autograd.grad(total, p)
            grads.append(g.reshape(1, -1))
    buf = torch.cat(losses)
    if with_grad:
        buf = torch.cat([buf[:, None], torch.cat(grads)], dim=1)
    dist.all_reduce(buf, group=mesh.get_group(runs_axis))
    buf = buf / n_runs
    places = tuple(Shard(0) if n == param_axis else Replicate() for n in mesh.mesh_dim_names)
    if not with_grad:
        return DTensor.from_local(buf, mesh, places, run_check=False)
    loss_t = DTensor.from_local(buf[:, 0].contiguous(), mesh, places, run_check=False)
    grad_t = DTensor.from_local(buf[:, 1:].reshape((len(mine),) + tuple(full.shape[1:])),
                                mesh, places, run_check=False)
    return loss_t, grad_t

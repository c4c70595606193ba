"""Device meshes on torch.distributed (counterpart of pulser_diff_tpu/parallel/mesh.py).

The JAX package states its parallel axes as NamedSharding over a Mesh and
lets XLA's partitioner insert the collectives.  Here the mesh is a
``DeviceMesh`` over the process group (one rank a device: NCCL on CUDA,
gloo on the CPU) and the placements are DTensor's:

  - "runs":  stochastic noise realizations (doppler / amplitude / SPAM)
             and quantum-jump trajectories, one seed a run; each rank
             solves its contiguous block of runs, and the result is a
             DTensor placed ``Shard(0)`` on the runs axis;
  - "state": one statevector's row-group axis (``sharded_sesolve``) or a
             density matrix's row index (``sharded_mesolve``), split over
             the axis; the port's unchanged steppers run on the DTensors,
             and DTensor's sharding rules issue the collectives that XLA's
             partitioner inserts in the JAX package.

The inputs of a sharded call are replicated host data (every rank passes
the same full tensors, as every JAX process holds the global values): each
rank keeps its own block (``DTensor.from_local``), so placing them costs
no communication, and autograd flows back to the plain tensors.

``make_mesh`` needs a process group: start one with
``pulser_diff_torch.parallel.multihost.initialize`` (or ``torchrun``, then
``torch.distributed.init_process_group``).  One process on one card is a
group of one rank.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from pulser_diff_torch.config import DeviceLike, default_dtype, resolve_device
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.hamiltonian import draw_noise
from pulser_diff_torch.ops.linalg import expect as _expect
from pulser_diff_torch.solvers import SolverType, TimeGrid


def make_mesh(axis_sizes: dict[str, int], devices: Optional[Sequence[int]] = None,
              device_type: DeviceLike = None) -> DeviceMesh:
    """A DeviceMesh of shape ``axis_sizes.values()`` named by its keys.

    ``devices``: the ranks of a sub-mesh (default: every rank of the
    process group); the sizes must multiply to their count.
    ``device_type``: CUDA unless given; without CUDA it raises, as
    ``config.resolve_device`` does.  Raises RuntimeError without a process
    group (``multihost.initialize`` starts one).
    """
    dev_type = resolve_device(device_type).type
    shape = tuple(int(s) for s in axis_sizes.values())
    if devices is None:
        _require_group()
        devices = range(dist.get_world_size())
    devices = [int(d) for d in devices]
    n = int(np.prod(shape))
    if n != len(devices):
        raise ValueError(
            f"Mesh of shape {dict(axis_sizes)} needs {n} devices, got {len(devices)}.")
    _require_group()
    return DeviceMesh(dev_type, torch.tensor(devices).reshape(shape),
                      mesh_dim_names=tuple(axis_sizes))


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "No process group: call pulser_diff_torch.parallel.multihost.initialize(...) (or "
            "torch.distributed.init_process_group under torchrun) before make_mesh.")


def placements(mesh: DeviceMesh, axis: str, dim: int) -> tuple:
    """``Shard(dim)`` on the mesh axis ``axis``, ``Replicate()`` on the
    others (JAX's ``P(..., axis, ...)`` with ``axis`` at ``dim``)."""
    names = mesh.mesh_dim_names
    return tuple(Shard(dim) if name == axis else Replicate() for name in names)


def _block(n: int, mesh: DeviceMesh, axis: str, what: str) -> slice:
    """This rank's contiguous block of ``n`` items split over ``mesh[axis]``."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % size:
        raise ValueError(f"{what} {n} must divide the '{axis}' axis size {size}.")
    per = n // size
    c = mesh.get_local_rank(axis)
    return slice(c * per, (c + 1) * per)


def _local_block(x: torch.Tensor, mesh: DeviceMesh, places: Sequence) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``places`` (a
    differentiable slice)."""
    for name, p in zip(mesh.mesh_dim_names, places):
        if isinstance(p, Shard):
            sl = _block(x.shape[p.dim], mesh, name, f"Dimension {p.dim} of size")
            x = x.narrow(p.dim, sl.start, sl.stop - sl.start)
    return x


def distribute(x: Any, mesh: DeviceMesh, places: Sequence) -> Any:
    """The full tensor ``x`` (the same on every rank) as a DTensor with
    ``places``, from this rank's block: no communication, and autograd
    flows back to ``x``.  A Cplx maps part by part; None and non-tensors
    pass through."""
    if isinstance(x, Cplx):
        return Cplx(distribute(x.re, mesh, places), distribute(x.im, mesh, places))
    if not isinstance(x, torch.Tensor):
        return x
    return DTensor.from_local(_local_block(x, mesh, places), mesh, tuple(places),
                              run_check=False)


def _replicated(nt: Any, mesh: DeviceMesh) -> Any:
    """Every tensor field of a NamedTuple replicated over the mesh."""
    rep = (Replicate(),) * mesh.ndim
    return nt._replace(**{f: distribute(getattr(nt, f), mesh, rep) for f in nt._fields})


def _to_placements(x: Cplx, mesh: DeviceMesh, places: tuple) -> Cplx:
    """A DTensor result redistributed to ``places`` (JAX's out_shardings);
    a no-op where DTensor's rules already gave them."""
    return Cplx(*(t if tuple(t.placements) == places else t.redistribute(mesh, places)
                  for t in x))


def _stack(states: list) -> Cplx:
    return Cplx(torch.stack([s.re for s in states]), torch.stack([s.im for s in states]))


def _solve_states_from_draws(sim, draws, solver, substeps, krylov_dim, grid):
    """One realization's states (n_eval, dim, nb) from its draws, on the
    f64 stepper as the JAX package solves it here: ``fused=False`` (it
    vmaps and shards the solve, and vmap of pallas_call does not lower);
    ``remat=True``, one state per step kept for reverse mode."""
    h = sim._hamiltonian
    hd = h.build_data(draws)
    return sim._solve_states(
        hd, solver, substeps, grid,
        solver_opts={"fused": False, "remat": True, "krylov_dim": krylov_dim},
    )


def _grid(sim) -> TimeGrid:
    h = sim._hamiltonian
    return TimeGrid.make(h.sampling_times, sim._eval_times_array, sim.torch_device)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def fold_seed(seed: int, i: int) -> int:
    """The seed of item ``i`` of a realization ``seed`` (the counterpart of
    ``jax.random.fold_in(key, i)``): a SeedSequence of (seed, i)."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1, np.uint64)[0])


def run_seeds(seed: int, n_runs: int) -> list[int]:
    """The seeds of ``n_runs`` runs of one step (JAX's
    ``jax.random.split(key, n_runs)``)."""
    return [fold_seed(seed, i) for i in range(n_runs)]


def sharded_noise_states(
    sim,
    seeds: Sequence[int],
    mesh: Optional[DeviceMesh] = None,
    axis: str = "runs",
    solver: str = SolverType.DP5_SE,
    substeps: int = 1,
    krylov_dim: int = 12,
) -> Cplx:
    """Monte-Carlo noise realizations, one per seed: run i draws its noise
    (``draw_noise``) from a generator on the emulator's device seeded with
    ``seeds[i]``.  With a mesh each rank solves its contiguous block of
    runs over ``mesh[axis]``, one after another.

    Returns states of shape (n_runs, n_eval, dim, nb): plain tensors
    without a mesh, else DTensors placed ``Shard(0)`` on ``axis``.  Each
    run is the same solve either way, so the two are equal bit for bit.
    """
    h = sim._hamiltonian
    cfg = h.config
    n_slots = h._count_noise_slots()
    grid = _grid(sim)
    seeds = [int(s) for s in seeds]
    local = seeds if mesh is None else seeds[_block(len(seeds), mesh, axis, "n_runs")]

    def one(seed):
        draws = draw_noise(_generator(seed, sim.torch_device), cfg, h._size, n_slots)
        return _solve_states_from_draws(sim, draws, solver, substeps, krylov_dim, grid)

    out = _stack([one(s) for s in local])
    if mesh is None:
        return out
    places = placements(mesh, axis, 0)
    return Cplx(*(DTensor.from_local(x, mesh, places, run_check=False) for x in out))


def sharded_mcwf_states(
    sim,
    seed: int,
    n_traj: int,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "runs",
    solver: str = SolverType.MCWF,
    substeps: int = 1,
):
    """MCWF (quantum-jump) trajectories sharded over ``mesh[axis]``, the
    Lindblad counterpart of :func:`sharded_noise_states`.

    ``n_traj`` splits into ``mesh.size(axis)`` blocks; block i is one
    ``mcsolve`` of its trajectories, drawn from a generator seeded with
    ``fold_seed(seed, i)`` (JAX: ``fold_in(key, i)``).  So the results are
    bit-identical with and without a mesh for the same seed and shard
    count (without a mesh there is one block).

    Returns ``McwfResult`` with states (n_shards, n_eval, per_shard, da,
    db) and n_jumps (n_shards, per_shard): DTensors placed ``Shard(0)`` on
    ``axis`` with a mesh.
    """
    from pulser_diff_torch.solvers.mcwf import McwfResult, mcsolve

    h = sim._hamiltonian
    grid = _grid(sim)
    psi0 = sim._initial_state
    da, db = h.dim**h._a, h.dim**h._b
    p0 = Cplx(psi0.re[:, 0].reshape(da, db), psi0.im[:, 0].reshape(da, db))
    drift = SolverType.DP5_SE if solver == SolverType.MCWF else SolverType.DP5_SE_F32
    n_shards = 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))
    if n_traj % n_shards:
        raise ValueError(f"n_traj {n_traj} must divide the '{axis}' axis size {n_shards}.")
    per = n_traj // n_shards
    shards = range(n_shards) if mesh is None else [mesh.get_local_rank(axis)]
    res = [mcsolve(h._ham_data, p0, h._collapse_ops, h._size, h.dim, grid,
                   _generator(fold_seed(seed, i), sim.torch_device), per, drift, substeps)
           for i in shards]
    states = _stack([r.states for r in res])
    jumps = torch.stack([r.n_jumps for r in res])
    if mesh is None:
        return McwfResult(states, jumps)
    places = placements(mesh, axis, 0)
    return McwfResult(
        Cplx(*(DTensor.from_local(x, mesh, places, run_check=False) for x in states)),
        DTensor.from_local(jumps, mesh, places, run_check=False))


def run_loss(model, params, obs: Cplx, target: float, seed: int,
             solver: str = SolverType.DP5_SE, substeps: int = 1) -> torch.Tensor:
    """One noise realization's loss (final expectation - target)^2: the
    model's emulator at ``params``, its noise drawn from a generator
    seeded with ``seed``, solved by :func:`_solve_states_from_draws`."""
    sim = model._make_emulator(params)
    h = sim._hamiltonian
    draws = draw_noise(_generator(seed, model.torch_device), h.config, h._size,
                       h._count_noise_slots())
    states = _solve_states_from_draws(sim, draws, solver, substeps, 12, _grid(sim))
    return (_expect(obs, states).re[-1] - target) ** 2


def sharded_expectation_step(
    model,
    obs: Any,
    target: float,
    optimizer: Callable[[list], torch.optim.Optimizer],
    mesh: DeviceMesh,
    n_runs: int,
    runs_axis: str = "runs",
    solver: str = SolverType.DP5_SE,
    substeps: int = 1,
) -> Callable[[int], torch.Tensor]:
    """A training step over the mesh.

    loss(params) = mean over ``n_runs`` noise realizations (split over
    ``runs_axis``) of (final expectation - target)^2.  ``optimizer`` is
    the training API's factory of the tensor list (``lambda ps:
    torch.optim.Adam(ps, lr=...)``), built once over the model's
    parameters, which the step trains in place.

    Returns step(seed) -> loss: run i draws from ``run_seeds(seed,
    n_runs)[i]``; each rank solves its block of runs, the mean over ranks
    is one autograd-aware all_reduce, and after the backward pass the
    parameter gradients are summed over the runs axis, so every rank
    takes the same optimiser step and keeps the same parameters.
    """
    obs = as_cplx(obs, dtype=default_dtype()).to(device=model.torch_device)
    params = list(model.params.values())
    opt = optimizer(params)
    group = mesh.get_group(runs_axis)
    n_ranks = dist.get_world_size(group)

    def step(seed: int) -> torch.Tensor:
        seeds = run_seeds(seed, n_runs)[_block(n_runs, mesh, runs_axis, "n_runs")]
        opt.zero_grad()
        local = torch.stack([run_loss(model, dict(model.params), obs, target, s, solver,
                                      substeps) for s in seeds]).sum()
        with warnings.catch_warnings():
            # deprecated from torch 2.13 for _functional_collectives.all_reduce,
            # whose autograd rule older releases lack; this one has it in all
            warnings.simplefilter("ignore", FutureWarning)
            loss = dist_nn.all_reduce(local, group=group) / n_runs
        loss.backward()
        # the all_reduce's backward sums the ranks' equal cotangents, so
        # each rank holds n_ranks x its own runs' share: sum the shares
        # over the axis (one all_reduce of the flat gradients)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for p, g in zip(params, (flat / n_ranks).split([p.numel() for p in params])):
            p.grad = g.reshape(p.shape)
        opt.step()
        return loss.detach()

    return step


def sharded_sesolve(
    ham_data,
    psi0: Cplx,
    grid: TimeGrid,
    mesh: DeviceMesh,
    axis: str = "state",
    solver: str = SolverType.DP5_SE,
    substeps: int = 1,
    **solver_kwargs: Any,
) -> Cplx:
    """Schrodinger evolution with ONE statevector sharded over the mesh.

    psi0 (nb, da, db), the same on every rank, is placed ``Shard(1)`` on
    ``mesh[axis]`` (its row-group axis) and the factored Hamiltonian's
    tensors ``Replicate()``; the port's unchanged ``solvers.sesolve`` runs
    on them (constants it makes inside are replicated implicitly).  The
    row product ``hr @ psi`` crosses the shard boundary and DTensor's
    matmul rule gathers its operand; the column product and the vdW
    diagonal stay local.  Returns (n_eval, nb, da, db) DTensors placed
    ``Shard(2)``; autograd flows back to ``ham_data`` and ``psi0``.

    ``da`` must be divisible by the mesh axis size.
    """
    from pulser_diff_torch.solvers import sesolve as _sesolve

    n_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    da = psi0.re.shape[-2]
    if da % n_shards != 0:
        raise ValueError(
            f"state row dim {da} not divisible by mesh axis '{axis}' of size {n_shards}")
    p0 = distribute(psi0, mesh, placements(mesh, axis, 1))
    with implicit_replication():
        out = _sesolve(_replicated(ham_data, mesh), p0, grid, solver=solver,
                       substeps=substeps, **solver_kwargs)
    return _to_placements(out, mesh, placements(mesh, axis, 2))


def sharded_mesolve(
    ham_data,
    rho0: Cplx,
    collapse,
    n_qudits: int,
    qudit_dim: int,
    grid: TimeGrid,
    mesh: DeviceMesh,
    axis: str = "rho",
    solver: str = SolverType.DP5_ME,
    substeps: int = 1,
    n_segments: Optional[int] = None,
) -> Cplx:
    """Lindblad evolution with the density matrix sharded over the mesh:
    rho0 (dim, dim) placed ``Shard(0)`` on its row index, the Hamiltonian
    and the collapse operators ``Replicate()``, the port's unchanged
    ``solvers.mesolve`` (any of its three forms) run on them.  Returns
    (n_eval, dim, dim) DTensors placed ``Shard(1)``."""
    from pulser_diff_torch.solvers import mesolve as _mesolve

    r0 = distribute(rho0, mesh, placements(mesh, axis, 0))
    with implicit_replication():
        out = _mesolve(_replicated(ham_data, mesh), r0, _replicated(collapse, mesh), n_qudits,
                       qudit_dim, grid, solver=solver, substeps=substeps, n_segments=n_segments)
    return _to_placements(out, mesh, placements(mesh, axis, 1))

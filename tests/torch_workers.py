"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py).

    python tests/torch_workers.py <group> <rank> <world> <port> <outdir>

Each rank joins a gloo group on localhost, runs its group's cases through
pulser_diff_torch.parallel on the CPU and, on rank 0, writes the gathered
results to ``<outdir>/<group>.npz`` (other ranks write what only they
hold to ``<group>_<rank>.npz``).  Imports the port and numpy only.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


def ring(n: int, radius: float) -> dict:
    return {f"q{i}": np.array([radius * np.cos(a), radius * np.sin(a)])
            for i, a in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False))}


def simple_sequence(reg: dict, duration: int, omega=2.0, delta=-1.0, phase=0.5):
    """tests/conftest.py's make_simple_sequence in the port."""
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence

    seq = Sequence(Register(reg), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse.ConstantPulse(duration, omega, delta, phase), "ryd")
    return seq


def xy_ring_sequence():
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence

    seq = Sequence(Register(ring(6, 7.0)), MockDevice)
    seq.declare_channel("mw", "microwave_global")
    seq.add(Pulse.ConstantPulse(60, 1.5, 0.4, 0.3), "mw")
    return seq


def emulator(seq, config=None):
    from pulser_diff_torch import TorchEmulator

    return TorchEmulator.from_sequence(seq, config=config, evaluation_times="Minimal", device=CPU)


def grid_of(sim):
    from pulser_diff_torch.solvers import TimeGrid

    h = sim._hamiltonian
    return TimeGrid.make(h.sampling_times, sim._eval_times_array, CPU)


def psi_of(sim):
    from pulser_diff_torch.cplx import Cplx

    h = sim._hamiltonian
    da, db = h.dim**h._a, h.dim**h._b
    p0 = sim.initial_state
    return Cplx(p0.re.T.reshape(1, da, db), p0.im.T.reshape(1, da, db))


def rho_of(sim):
    from pulser_diff_torch.cplx import Cplx

    p = sim.initial_state
    return Cplx(p.re @ p.re.T + p.im @ p.im.T, p.im @ p.re.T - p.re @ p.im.T)


def full(x) -> np.ndarray:
    return x.full_tensor().detach().numpy()


def scale_streams(hd, s):
    from pulser_diff_torch.cplx import Cplx

    return hd._replace(row_streams=Cplx(hd.row_streams.re * s, hd.row_streams.im * s),
                       col_streams=Cplx(hd.col_streams.re * s, hd.col_streams.im * s))


def sesolve_group(world: int) -> dict:
    """JAX's 6-atom, 60 ns cases: states and the amplitude-scale gradient,
    the f32 mode, the ValueError."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.parallel import make_mesh, sharded_sesolve
    from pulser_diff_torch.solvers import SolverType

    mesh = make_mesh({"state": world}, device_type="cpu")
    sim = emulator(simple_sequence(ring(6, 8.0), 60))
    grid, psi0, hd = grid_of(sim), psi_of(sim), sim._hamiltonian._ham_data
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    out = sharded_sesolve(scale_streams(hd, s), psi0, grid, mesh)
    (g,) = torch.autograd.grad(out.abs2()[-1, 0, -1, -1].full_tensor(), s)
    out32 = sharded_sesolve(hd, psi0, grid, mesh, solver=SolverType.DP5_SE_F32)
    try:
        sharded_sesolve(hd, Cplx(psi0.re[:, :3], psi0.im[:, :3]), grid, mesh)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    return {
        "re": full(out.re), "im": full(out.im), "grad": float(g),
        "placements": str(out.re.placements), "ranks": out.re.device_mesh.size(),
        "re32": full(out32.re), "im32": full(out32.im), "dtype32": str(out32.re.dtype),
        "placements32": str(out32.re.placements),
        "refused": refused,
    }


def mesolve_group(world: int) -> dict:
    """JAX's 3-atom (superop form) and 4-atom (dense form) dephasing cases,
    its 6-atom XY case through sharded_sesolve, and large_scale's mesh
    section at its CI size."""
    from pulser_diff_torch import SimConfig
    from pulser_diff_torch.examples import large_scale
    from pulser_diff_torch.parallel import make_mesh, sharded_mesolve, sharded_sesolve

    mesh = make_mesh({"rho": world}, device_type="cpu")
    xy = emulator(xy_ring_sequence())
    xhd = xy._hamiltonian._ham_data
    out_xy = sharded_sesolve(xhd, psi_of(xy), grid_of(xy), make_mesh({"state": world},
                                                                     device_type="cpu"))
    out = {"xy_kron": xhd.kron_row is not None, "xy_re": full(out_xy.re),
           "xy_im": full(out_xy.im), "xy_placements": str(out_xy.re.placements)}
    for key, reg, rate in (
        ("sup", {"q0": np.array([-5.0, 0.0]), "q1": np.array([5.0, 0.0]),
                 "q2": np.array([0.0, 6.0])}, 0.3),
        ("dense", {"q0": np.array([-6.0, 0.0]), "q1": np.array([6.0, 0.0]),
                   "q2": np.array([0.0, 7.0]), "q3": np.array([0.0, -7.0])}, 0.25),
    ):
        sim = emulator(simple_sequence(reg, 48), SimConfig(noise="dephasing", dephasing_rate=rate))
        h = sim._hamiltonian
        rho = sharded_mesolve(h._ham_data, rho_of(sim), h._collapse_ops, h._size, h.dim,
                              grid_of(sim), mesh)
        out.update({f"{key}_re": full(rho.re), f"{key}_im": full(rho.im),
                    f"{key}_placements": str(rho.re.placements)})
    ls = large_scale.main(device="cpu", ci=True)
    out.update({"ls_ranks": ls["mesh_ranks"], "ls_mesh_norm": ls["mesh_norm"],
                "ls_norm": ls["norm"]})
    return out


def runs_group(world: int) -> dict:
    """sharded_noise_states, sharded_mcwf_states and sharded_expectation_step
    on the runs axis."""
    from pulser_diff_torch import QuantumModel, SimConfig
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence
    from pulser_diff_torch.ops import total_magnetization
    from pulser_diff_torch.parallel import (
        make_mesh, sharded_expectation_step, sharded_mcwf_states, sharded_noise_states,
    )
    from pulser_diff_torch.parallel.mesh import fold_seed, run_loss, run_seeds
    from pulser_diff_torch.solvers import mcsolve

    mesh = make_mesh({"runs": world}, device_type="cpu")
    two = {"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])}
    out = {}
    sim = emulator(simple_sequence(two, 100), SimConfig(noise="doppler", temperature=60.0,
                                                        runs=2 * world))
    seeds = list(range(100, 100 + 2 * world))
    st = sharded_noise_states(sim, seeds, mesh=mesh)
    out.update(noise_re=full(st.re), noise_im=full(st.im),
               noise_placements=str(st.re.placements), noise_ranks=st.re.device_mesh.size())
    if dist.get_rank() == 0:
        plain = sharded_noise_states(sim, seeds)
        out.update(plain_re=plain.re.numpy(), plain_im=plain.im.numpy())

    # trajectories: one mcsolve a shard, seeded by fold_seed(seed, shard)
    sim_mc = emulator(simple_sequence(two, 120), SimConfig(noise="dephasing", dephasing_rate=0.3))
    mc = sharded_mcwf_states(sim_mc, 5, n_traj=2 * world, mesh=mesh)
    out.update(mc_re=full(mc.states.re), mc_im=full(mc.states.im),
               mc_jumps=full(mc.n_jumps), mc_placements=str(mc.states.re.placements))
    if dist.get_rank() == 0:
        lone = sharded_mcwf_states(sim_mc, 5, n_traj=2)
        out.update(lone_re=lone.states.re.numpy(), lone_im=lone.states.im.numpy())
        h = sim_mc._hamiltonian
        p0 = psi_of(sim_mc)[0]
        refs = [mcsolve(h._ham_data, p0, h._collapse_ops, h._size, h.dim, grid_of(sim_mc),
                        torch.Generator().manual_seed(fold_seed(5, i)), 2).states
                for i in range(world)]
        out.update(ref_re=np.stack([r.re.numpy() for r in refs]),
                   ref_im=np.stack([r.im.numpy() for r in refs]))
    try:
        sharded_mcwf_states(sim_mc, 5, n_traj=2 * world + 2, mesh=mesh)
        out["mc_refused"] = ""
    except ValueError as exc:
        out["mc_refused"] = str(exc)

    # the training step: JAX's 2-atom model with doppler noise, SGD so
    # the parameters' move carries the gradient's size
    seq = Sequence(Register(two), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    om = seq.declare_variable("omega")
    seq.add(Pulse.ConstantPulse(60, om, 0.0, 0.0), "ryd")
    model = QuantumModel(seq, {"omega": 1.5}, noise_config=SimConfig(noise="doppler",
                                                                     temperature=50.0),
                         evaluation_times="Minimal", device=CPU)
    obs = total_magnetization(2, device=CPU)
    lr, seed, n_runs = 0.1, 3, world
    if dist.get_rank() == 0:
        w = model.params["omega"].detach().clone().requires_grad_(True)
        lone = torch.stack([run_loss(model, {"omega": w}, obs, -1.5, s)
                            for s in run_seeds(seed, n_runs)])
        (g,) = torch.autograd.grad(lone.mean(), w)
        out.update(lone_losses=lone.detach().numpy(), lone_grad=float(g),
                   omega0=float(model.params["omega"]))
    step = sharded_expectation_step(model, obs, -1.5, lambda ps: torch.optim.SGD(ps, lr=lr),
                                    mesh, n_runs)
    loss = step(seed)
    omegas = [torch.zeros(1, dtype=torch.float64) for _ in range(world)]
    dist.all_gather(omegas, model.params["omega"].detach().reshape(1))
    out.update(step_loss=float(loss), step_omegas=torch.cat(omegas).numpy(), lr=lr)
    return out


def sweep_loss(omega, seed: int):
    """tests/test_multihost.py's noisy single-interval Rabi loss, its
    per-run perturbation from the seed (``np`` or ``torch`` values)."""
    delta = (seed % 1000) / 1000.0 * 0.1
    lib = torch if isinstance(omega, torch.Tensor) else np
    theta = lib.sqrt(omega**2 + delta**2) * 0.05
    return lib.sin(theta / 2) ** 2


SWEEP_PARAMS = np.linspace(1.0, 4.0, 2)
SWEEP_SEEDS = np.arange(8).reshape(2, 4) * 7919 + 13


def multihost_group(world: int) -> dict:
    """param_sweep on ("param", "runs") = 2 hosts x 2 ranks (LOCAL_WORLD_SIZE
    = 2): the losses and, with with_grad, the gradients; this rank's
    blocks and the gathered stacks."""
    from pulser_diff_torch.parallel import multihost as mh

    mesh = mh.param_runs_mesh(device_type="cpu")
    params = mh.global_array(SWEEP_PARAMS, mesh, mh.placements(mesh, "param", 0))
    losses = mh.param_sweep(sweep_loss, params, SWEEP_SEEDS, mesh)
    losses2, grads = mh.param_sweep(sweep_loss, params, SWEEP_SEEDS, mesh, with_grad=True)
    return {"shape": np.array(mesh.mesh.shape), "names": ",".join(mesh.mesh_dim_names),
            "param_row": mesh.get_local_rank("param"), "local_param": params.to_local().numpy(),
            "local_loss": losses.to_local().numpy(), "loss": full(losses),
            "loss2": full(losses2), "grad": full(grads),
            "placements": str(losses.placements), "grad_placements": str(grads.placements)}


GROUPS = {"sesolve": sesolve_group, "mesolve": mesolve_group, "runs": runs_group,
          "multihost": multihost_group}


def main(group: str, rank: int, world: int, port: int, outdir: str) -> None:
    from pulser_diff_torch.parallel.multihost import initialize

    initialize(f"localhost:{port}", world, rank)
    try:
        out = GROUPS[group](world)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{group}.npz"), **out)
        elif group == "multihost":
            np.savez(os.path.join(outdir, f"{group}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    g, r, w, p, d = sys.argv[1:]
    main(g, int(r), int(w), int(p), d)

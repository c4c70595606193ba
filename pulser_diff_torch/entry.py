"""Entry points of the port (counterpart of __graft_entry__.py).

entry():            the forward step of the flagship workload, a 9-atom
                    adiabatic sweep (3 x 3 grid at 6.2 um) with
                    InterpolatedWaveform amplitude and detuning parameters
                    (8 knots each, 400 ns), returning the final total
                    magnetization; on CUDA unless a device is given.
dryrun_multichip(): one sharded training step over a ("runs", "param")
                    mesh and one state-sharded solve (and a row-sharded
                    Lindblad solve and sharded trajectories) on tiny
                    shapes, on n gloo ranks on the CPU in subprocesses
                    that never touch a GPU.

    python -c "from pulser_diff_torch.entry import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

from pulser_diff_torch.config import DeviceLike


def flagship_model(n_qubits: int = 9, duration: int = 400, n_params: int = 8,
                   device: DeviceLike = None, **options):
    """(model, obs): the flagship sweep's QuantumModel at ``n_qubits``
    atoms, its parameters at the start values, and the total
    magnetization; ``options`` go to the QuantumModel (``fused=False``
    pins the f64 stepper)."""
    from pulser_diff_torch.config import resolve_device
    from pulser_diff_torch.core import (
        InterpolatedWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.model import QuantumModel
    from pulser_diff_torch.ops import total_magnetization

    device = resolve_device(device)
    side = int(np.ceil(np.sqrt(n_qubits)))
    coords = [(6.2 * (i % side), 6.2 * (i // side)) for i in range(n_qubits)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp_vals = seq.declare_variable("amp_vals", size=n_params)
    det_vals = seq.declare_variable("det_vals", size=n_params)
    seq.add(Pulse(InterpolatedWaveform(duration, amp_vals),
                  InterpolatedWaveform(duration, det_vals), 0.0), "ryd")
    model = QuantumModel(seq, {"amp_vals": np.linspace(0.0, 4.0, n_params),
                               "det_vals": np.linspace(-4.0, 4.0, n_params)}, device=device,
                         **options)
    return model, total_magnetization(n_qubits, dense=False, device=device)


def flagship(n_qubits: int = 9, duration: int = 400, n_params: int = 8,
             device: DeviceLike = None, **options):
    """(forward, example_args): forward(amp_vals, det_vals) -> the final
    total magnetization of :func:`flagship_model`'s sweep."""
    import torch

    model, obs = flagship_model(n_qubits, duration, n_params, device, **options)
    exp_fn = model.expectation_fn(obs)

    def forward(amp_vals: torch.Tensor, det_vals: torch.Tensor) -> torch.Tensor:
        _, vals = exp_fn({"amp_vals": amp_vals, "det_vals": det_vals})
        return vals[-1]

    return forward, (model.params["amp_vals"], model.params["det_vals"])


def entry(device: DeviceLike = None):
    """(fn, example_args): the flagship's forward step, on ``device`` (CUDA
    unless given)."""
    return flagship(device=device)


def dryrun_multichip(n_devices: int) -> None:
    """Run one sharded training step and the sharded solves on
    ``n_devices`` gloo ranks on the CPU, each a subprocess with no GPU
    visible, and print the first rank's ``dryrun_multichip OK ...`` line.
    Raises RuntimeError if a rank fails."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pulser_diff_torch.entry", "--multichip-worker", str(n_devices),
         str(rank), str(port)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=1800)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(rank, p.returncode, out) for rank, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        rank, rc, out = failed[0]
        raise RuntimeError(f"multichip dryrun rank {rank} failed (rc={rc}):\n{out[-4000:]}")
    sys.stdout.write("".join(line + "\n" for line in outs[0].splitlines()
                             if line.startswith("dryrun_multichip OK")))


def _multichip_worker(n_devices: int, rank: int, port: int) -> None:
    """One rank of the dry run (all on the CPU).

    Mesh axes (the parallel axes of this package):
      - 'runs':  stochastic noise realizations, one seed a run;
      - 'param': a parameter-sweep batch (data parallelism over models).
    The mean loss over both axes: param_sweep's all_reduce over 'runs',
    then the full (n_param,) losses and gradients on every rank."""
    import torch

    torch.set_num_threads(1)
    from pulser_diff_torch import SimConfig, TorchEmulator
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.model import QuantumModel
    from pulser_diff_torch.ops import total_magnetization
    from pulser_diff_torch.parallel import (
        make_mesh, sharded_mcwf_states, sharded_mesolve, sharded_sesolve,
    )
    from pulser_diff_torch.parallel.mesh import run_loss, run_seeds
    from pulser_diff_torch.parallel.multihost import initialize, param_sweep
    from pulser_diff_torch.solvers import TimeGrid

    cpu = torch.device("cpu")
    initialize(f"localhost:{port}", n_devices, rank, backend="gloo")
    if n_devices % 2 == 0 and n_devices >= 4:
        axes = {"runs": n_devices // 2, "param": 2}
    else:
        axes = {"runs": n_devices, "param": 1}
    mesh = make_mesh(axes, device_type="cpu")

    # tiny workload: 2 qubits, 50 ns, trainable omega, doppler noise
    reg = Register({"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])})
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    om = seq.declare_variable("omega")
    seq.add(Pulse.ConstantPulse(50, om, 0.0, 0.0), "ryd")
    model = QuantumModel(seq, {"omega": 1.5},
                         noise_config=SimConfig(noise="doppler", temperature=50.0), device=cpu)
    obs = total_magnetization(2, device=cpu)
    n_runs, n_param, target = axes["runs"] * 2, axes["param"] * 2, -1.5
    omegas = torch.linspace(1.0, 2.0, n_param, dtype=torch.float64)
    seeds = np.array(run_seeds(0, n_param * n_runs)).reshape(n_param, n_runs)
    losses, grads = param_sweep(
        lambda w, seed: run_loss(model, {"omega": w}, obs, target, seed), omegas, seeds, mesh,
        with_grad=True)
    loss = losses.full_tensor().mean()
    omegas.grad = grads.full_tensor() / n_param
    opt = torch.optim.Adam([omegas.requires_grad_()], lr=1e-2)
    opt.step()
    if not bool(torch.isfinite(loss)) or not bool(torch.isfinite(omegas).all()):
        raise RuntimeError(f"multichip dryrun: loss {loss}, omegas {omegas}")

    # ONE statevector sharded over its row-group axis
    n_q = max(2, int(np.ceil(np.log2(2 * n_devices))) * 2)
    if (2 ** (n_q // 2)) % n_devices != 0:
        # a device count that is not a power of 2 cannot split the
        # power-of-2 row dim evenly: the step above validated the mesh
        if rank == 0:
            print(f"dryrun_multichip OK: mesh={axes} loss={float(loss):.6f} "
                  "state_shards=skipped", flush=True)
        return
    angles = np.linspace(0, 2 * np.pi, n_q, endpoint=False)
    seq_s = Sequence(Register({f"s{i}": np.array([9.0 * np.cos(a), 9.0 * np.sin(a)])
                               for i, a in enumerate(angles)}), MockDevice)
    seq_s.declare_channel("ryd", "rydberg_global")
    seq_s.add(Pulse.ConstantPulse(40, 2.0, 0.5, 0.0), "ryd")
    sim_s = TorchEmulator.from_sequence(seq_s, evaluation_times="Minimal", device=cpu)
    hs = sim_s._hamiltonian
    da, db = hs.dim**hs._a, hs.dim**hs._b
    p0 = sim_s.initial_state
    psi0 = Cplx(p0.re.T.reshape(1, da, db), p0.im.T.reshape(1, da, db))
    out = sharded_sesolve(hs._ham_data, psi0, TimeGrid.make(hs.sampling_times,
                          sim_s._eval_times_array, cpu), make_mesh({"state": n_devices},
                                                                    device_type="cpu"))
    norm = float(out.abs2()[-1].sum().full_tensor())
    if abs(norm - 1.0) > 1e-8:
        raise RuntimeError(f"sharded sesolve norm drift: {norm}")
    n_placed = out.re.device_mesh.size()

    # the density matrix's rows, and trajectories, over the mesh
    n_q_rho = max(2, int(np.ceil(np.log2(n_devices))))
    rho_shards = mcwf_shards = 0
    if (2**n_q_rho) % n_devices == 0:
        seq_r = Sequence(Register({f"r{i}": np.array([8.0 * i, 0.0]) for i in range(n_q_rho)}),
                         MockDevice)
        seq_r.declare_channel("ryd", "rydberg_global")
        seq_r.add(Pulse.ConstantPulse(40, 1.5, 0.3, 0.0), "ryd")
        sim_r = TorchEmulator.from_sequence(
            seq_r, config=SimConfig(noise="dephasing", dephasing_rate=0.2),
            evaluation_times="Minimal", device=cpu)
        hr = sim_r._hamiltonian
        pr = sim_r.initial_state
        rho0 = Cplx(pr.re @ pr.re.T + pr.im @ pr.im.T, pr.im @ pr.re.T - pr.re @ pr.im.T)
        rho_mesh = make_mesh({"rho": n_devices}, device_type="cpu")
        rho = sharded_mesolve(hr._ham_data, rho0, hr._collapse_ops, hr._size, hr.dim,
                              TimeGrid.make(hr.sampling_times, sim_r._eval_times_array, cpu),
                              rho_mesh)
        tr = float(rho.re[-1].full_tensor().trace())
        if abs(tr - 1.0) > 1e-8:
            raise RuntimeError(f"sharded mesolve trace drift: {tr}")
        rho_shards = rho.re.device_mesh.size()
        mc = sharded_mcwf_states(sim_r, 11, n_traj=2 * n_devices, mesh=rho_mesh, axis="rho")
        norms = mc.states.abs2().sum(dim=(3, 4)).full_tensor()
        if float((norms - 1).abs().max()) > 1e-8:
            raise RuntimeError(f"sharded trajectories' norms drift: {norms}")
        mcwf_shards = mc.states.re.device_mesh.size()
    if rank == 0:
        print(f"dryrun_multichip OK: mesh={axes} loss={float(loss):.6f} "
              f"state_shards={n_placed} rho_shards={rho_shards} mcwf_shards={mcwf_shards}",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--multichip-worker":
        import torch.distributed as dist

        try:
            _multichip_worker(*(int(a) for a in sys.argv[2:]))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    else:
        raise SystemExit("usage: python -m pulser_diff_torch.entry --multichip-worker "
                         "<n_devices> <rank> <port>")

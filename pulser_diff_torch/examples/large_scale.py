"""Scaling to large systems (docs/large_scale.py in the port).

One model at every size; the emulator picks the solve for the state's
dimension, as the JAX package does:

| state size | default path on the GPU |
|---|---|
| dim < 2^16 | the fused kernels K1/K2, one thread-block cluster a run |
| 2^16 <= dim < 2^18 | the checkpointed kernels K4/K5 |
| dim >= 2^18 (18 atoms on) | the f32 stepper ``DP5_SE_F32``; ``fused=False`` gives f64 |

``run(solver="DP5_SE_F32")`` takes the f32 stepper at any size.  Past
one card the statevector's row-group axis shards over a mesh of the
process group's ranks (``parallel.sharded_sesolve`` on DTensors, the
row product's operand gathered by DTensor's matmul rule); the last
section runs it in f32 when the group has more than one rank and its size
divides the row dimension.

    N_ATOMS=18 python -m pulser_diff_torch.examples.large_scale
    N_ATOMS=18 torchrun --nproc-per-node 4 -m pulser_diff_torch.examples.large_scale
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pulser_diff_torch import QuantumModel, SolverType
from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.core import (
    ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
)
from pulser_diff_torch.examples._common import ci_mode, knots, sine_drive
from pulser_diff_torch.ops import total_magnetization

SPACING = 10.0
DETUNING = -2.0
SAMPLING_RATE = 0.25


def sizes(ci: bool) -> tuple[int, int, int]:
    """(atoms, ns, knots): 6 / 120 / 4 in CI, else ``N_ATOMS`` (18 by
    default) / 660 / 8."""
    if ci_mode(ci):
        return 6, 120, 4
    return int(os.environ.get("N_ATOMS", "18")), 660, 8


def make_model(n_atoms: int, duration: int, n_params: int, device: DeviceLike,
               **options) -> QuantumModel:
    """``n_atoms`` on a 4-column lattice, a sine-interpolated amplitude of
    ``n_params`` knots (``amp_0``) and a constant detuning."""
    coords = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(n_atoms)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp = seq.declare_variable("amp", size=duration)
    seq.add(Pulse(CustomWaveform(amp, duration=duration),
                  ConstantWaveform(duration, DETUNING), 0.0), "ryd")
    return QuantumModel(seq, {"amp": ((start_knots(n_params),),
                                      lambda v: sine_drive(v, duration))},
                        sampling_rate=SAMPLING_RATE, evaluation_times="Minimal", device=device,
                        **options)


def start_knots(n_params: int) -> np.ndarray:
    return np.linspace(1.0, 3.0, n_params)


def value_and_grad(model: QuantumModel, amp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The final total magnetization (its diagonal form) and its gradient
    in the knots."""
    n = len(model.register.qubit_ids)
    exp_fn = model.expectation_fn(total_magnetization(n, dense=False, device=model.torch_device))
    a = amp.detach().clone().requires_grad_(True)
    value = exp_fn({"amp_0": a})[1][-1]
    (grad,) = torch.autograd.grad(value, a)
    return value.detach(), grad


def f32_final_norm(model: QuantumModel, amp: torch.Tensor) -> float:
    """The squared norm of the final state of the f32 stepper's run()."""
    with torch.no_grad():
        sim = model._make_emulator({"amp_0": amp})
        final = sim.run(solver=SolverType.DP5_SE_F32).get_final_state()
    return float((final.re.double() ** 2 + final.im.double() ** 2).sum())


def state_inputs(model: QuantumModel, amp: torch.Tensor) -> tuple:
    """(ham_data, psi0 (1, da, db), grid) of the model at ``amp``, as
    ``sesolve`` and ``parallel.sharded_sesolve`` take them."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.solvers import TimeGrid

    with torch.no_grad():
        sim = model._make_emulator({"amp_0": amp})
    h = sim._hamiltonian
    da, db = h.dim**h._a, h.dim**h._b
    p0 = sim.initial_state
    return (h._ham_data, Cplx(p0.re.T.reshape(1, da, db), p0.im.T.reshape(1, da, db)),
            TimeGrid.make(h.sampling_times, sim._eval_times_array, model.torch_device))


def sharded_f32_norm(model: QuantumModel, amp: torch.Tensor, n_dev: int) -> tuple[int, float]:
    """The f32 solve with the state's rows sharded over a ``{"state":
    n_dev}`` mesh of the process group: (ranks placed on, final squared
    norm)."""
    from pulser_diff_torch.parallel import make_mesh, sharded_sesolve

    mesh = make_mesh({"state": n_dev}, device_type=model.torch_device.type)
    with torch.no_grad():
        out = sharded_sesolve(*state_inputs(model, amp), mesh, solver=SolverType.DP5_SE_F32)
        norm = (out.re[-1].double() ** 2 + out.im[-1].double() ** 2).sum().full_tensor()
    return out.re.device_mesh.size(), float(norm)


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    n_atoms, duration, n_params = sizes(ci)
    model = make_model(n_atoms, duration, n_params, device)
    amp = knots(start_knots(n_params), device)
    value, grad = value_and_grad(model, amp)
    print(f"N={n_atoms} (dim {2**n_atoms:,}): <M>={float(value):.6f}, "
          f"|grad|={float(grad.abs().max()):.4f}")
    norm = f32_final_norm(model, amp)
    print("f32 solve final-state norm:", norm)
    out = {"value": float(value), "grad": grad.cpu().numpy(), "norm": norm}
    # past one card: the state's rows over the ranks of the process group
    n_dev = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    da = 2 ** (n_atoms // 2)
    if da % n_dev == 0 and n_dev > 1:
        out["mesh_ranks"], out["mesh_norm"] = sharded_f32_norm(model, amp, n_dev)
        print(f"sharded f32 solve over {out['mesh_ranks']} devices: "
              f"norm={out['mesh_norm']:.9f}")
    else:
        print(f"(mesh demo skipped: da={da} not divisible by {n_dev} devices)")
    return out


if __name__ == "__main__":
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun
        from pulser_diff_torch.parallel.multihost import initialize

        initialize(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                   int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    main()

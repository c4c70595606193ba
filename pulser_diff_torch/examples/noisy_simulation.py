"""Noisy simulation (docs/noisy_simulation.py in the port).

Every noise channel on two atoms 8 um apart under one constant pulse:
  - dephasing + relaxation on the master equation (density matrices);
  - the gradient of <Sz> in the dephasing rate, a tensor end to end;
  - leakage to a dark level through an effective-noise operator;
  - doppler noise + SPAM as a Monte-Carlo batch of drawn Hamiltonians
    (on the GPU one launch of the forward kernel K1 for all runs, the
    runs on its runs axis) sampled with detection errors;
  - quantum-jump trajectories (MCWF) against the master equation, and
    with state-preparation errors;
  - the dense form of the master equation at 3 (CI) or 6 atoms;
  - the pathwise gradient through trajectories (``expectation_mcwf_fn``).

Each draw comes from a generator seeded with ``seed``.

    python -m pulser_diff_torch.examples.noisy_simulation
"""

from __future__ import annotations

import numpy as np
import torch

from pulser_diff_torch import QuantumModel, SimConfig, TorchEmulator
from pulser_diff_torch.config import DeviceLike
from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence
from pulser_diff_torch.examples._common import ci_mode, knots
from pulser_diff_torch.ops import total_magnetization

COORDS = {"q0": (-4.0, 0.0), "q1": (4.0, 0.0)}
SEED = 7
# (pulse ns, Monte-Carlo runs, trajectories, atoms of the dense form,
# trajectories of the pathwise gradient): the script's sizes, its CI sizes
SIZES = dict(dur=400, mc_runs=50, traj=200, n_mid=6, grad_traj=256)
CI_SIZES = dict(dur=80, mc_runs=4, traj=8, n_mid=3, grad_traj=8)


def sizes(ci: bool) -> dict:
    return CI_SIZES if ci_mode(ci) else SIZES


def make_seq(dur: int, omega=2.0, detuning=-1.0, phase=0.0) -> Sequence:
    seq = Sequence(Register(COORDS), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse.ConstantPulse(dur, omega, detuning, phase), "ryd")
    return seq


def _emulator(dur: int, config: SimConfig, device: DeviceLike, seed: int = SEED,
              evaluation_times="Minimal") -> TorchEmulator:
    sim = TorchEmulator.from_sequence(make_seq(dur), config=config,
                                      evaluation_times=evaluation_times, device=device)
    # seeds every draw of its runs
    sim._rng = np.random.default_rng(seed)
    return sim


def lindblad(dur: int, device: DeviceLike) -> tuple[float, float]:
    """Dephasing (0.1) + relaxation (0.05): the final trace and <Sz>."""
    cfg = SimConfig(noise=("dephasing", "relaxation"), dephasing_rate=0.1,
                    relaxation_rate=0.05)
    res = _emulator(dur, cfg, device, evaluation_times=0.2).run()
    rho = res.states[len(res._sim_times) - 1]
    obs = total_magnetization(2, device=rho.re.device)
    return float(torch.trace(rho.re)), float(res.expect([obs])[0].re[-1])


def rate_gradient(dur: int, device: DeviceLike, rate: float = 0.1) -> float:
    """d<Sz>(T)/d(dephasing rate): the rate a tensor through mesolve."""
    r = knots(rate, device).requires_grad_(True)
    sim = _emulator(dur, SimConfig(noise="dephasing", dephasing_rate=r), device)
    obs = total_magnetization(2, device=sim.torch_device)
    (g,) = torch.autograd.grad(sim.run().expect([obs])[0].re[-1], r)
    return float(g)


def leakage(dur: int, device: DeviceLike) -> float:
    """The population leaked to |x> under the effective-noise operator
    |x><g| at rate 0.2: the diagonal x-terms of the final 9 x 9 rho."""
    lop = np.zeros((3, 3))
    lop[2, 1] = 1.0
    cfg = SimConfig(noise="eff_noise", eff_noise_rates=(0.2,), eff_noise_opers=(lop,),
                    with_leakage=True)
    res = _emulator(dur, cfg, device).run()
    rho = res.states[len(res._sim_times) - 1].re
    return float(rho[2 * 3 + 2, 2 * 3 + 2] + rho[2, 2] + rho[1 * 3 + 2, 1 * 3 + 2]
                 + rho[2 * 3 + 1, 2 * 3 + 1])


def monte_carlo(dur: int, runs: int, device: DeviceLike, seed: int = SEED) -> dict:
    """Doppler (50 uK) + SPAM detection errors (0.03, 0.01): the final
    time's bitstring counts of ``runs`` x 30 samples."""
    cfg = SimConfig(noise=("doppler", "SPAM"), temperature=50.0, runs=runs,
                    samples_per_run=30, eta=0.0, epsilon=0.03, epsilon_prime=0.01)
    return dict(_emulator(dur, cfg, device, seed).run()._results[-1].bitstring_counts)


def mcwf_vs_me(dur: int, runs: int, device: DeviceLike, seed: int = SEED) -> float:
    """Dephasing 0.1 as ``runs`` quantum-jump trajectories against the
    master equation: the largest difference of the populations."""
    cfg = SimConfig(noise="dephasing", dephasing_rate=0.1, runs=runs, samples_per_run=30)
    sim = _emulator(dur, cfg, device, seed, evaluation_times=0.2)
    mc = sim.run(solver="MCWF").states.re
    me = sim.run().states.re
    return float((torch.diagonal(mc, dim1=-2, dim2=-1)
                  - torch.diagonal(me, dim1=-2, dim2=-1)).abs().max())


def mcwf_eta(dur: int, runs: int, device: DeviceLike, seed: int = SEED) -> dict:
    """Trajectories under dephasing with state-preparation errors (eta
    0.2): the final time's frequencies."""
    cfg = SimConfig(noise=("dephasing", "SPAM"), dephasing_rate=0.1, eta=0.2, epsilon=0.0,
                    epsilon_prime=0.0, runs=runs, samples_per_run=30)
    return dict(_emulator(dur, cfg, device, seed).run(solver="MCWF").results[-1])


def dense_me(dur: int, n_mid: int, device: DeviceLike) -> float:
    """The final trace of dephasing on ``n_mid`` atoms 9 um apart, on the
    dense form of the master equation."""
    reg = Register.from_coordinates([(9.0 * i, 0.0) for i in range(n_mid)], prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse.ConstantPulse(dur, 1.5, -0.8, 0.0), "ryd")
    sim = TorchEmulator.from_sequence(seq, config=SimConfig(noise="dephasing",
                                                            dephasing_rate=0.05),
                                      evaluation_times="Minimal", device=device)
    rho = sim.run(solver="DP5_ME", me_form="dense").states.re
    return float(torch.trace(rho[-1]))


def mcwf_model(dur: int, device: DeviceLike) -> QuantumModel:
    """omega of a constant pulse trainable, under dephasing 0.08."""
    seq = Sequence(Register(COORDS), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega = seq.declare_variable("omega")
    seq.add(Pulse.ConstantPulse(dur, omega, -0.6, 0.2), "ryd")
    return QuantumModel(seq, {"omega": 1.7},
                        noise_config=SimConfig(noise="dephasing", dephasing_rate=0.08),
                        evaluation_times="Minimal", device=device)


def mcwf_gradient(dur: int, n_traj: int, device: DeviceLike,
                  seed: int = SEED) -> tuple[float, float]:
    """The final <Sz> averaged over ``n_traj`` trajectories and its
    pathwise derivative in omega (jump draws pinned by ``seed``)."""
    fn = mcwf_model(dur, device).expectation_mcwf_fn(key=seed, n_traj=n_traj)
    om = knots(1.7, device).requires_grad_(True)
    val = fn({"omega": om})[1][-1]
    (g,) = torch.autograd.grad(val, om)
    return float(val.detach()), float(g)


def main(device: DeviceLike = "cuda", ci: bool = False) -> dict:
    s = sizes(ci)
    dur = s["dur"]
    trace, sz = lindblad(dur, device)
    print("trace:", trace)
    print("final <Sz>:", sz)
    out = {"trace": trace, "sz": sz, "rate_grad": rate_gradient(dur, device),
           "leaked": leakage(dur, device), "counts": monte_carlo(dur, s["mc_runs"], device),
           "mcwf_vs_me": mcwf_vs_me(dur, s["traj"], device),
           "eta": mcwf_eta(dur, s["traj"], device),
           "dense_trace": dense_me(dur, s["n_mid"], device),
           "mcwf_grad": mcwf_gradient(dur, s["grad_traj"], device)}
    print("d<Sz>/d(dephasing_rate) =", out["rate_grad"])
    print("leaked population (diagonal x-terms):", out["leaked"])
    print("sampled bitstrings:", out["counts"])
    print("max |pop_MCWF - pop_ME|:", out["mcwf_vs_me"], f"(statistical, ~1/sqrt(R={s['traj']}))")
    print("with eta=0.2:", out["eta"])
    print(f"{s['n_mid']}-atom dense-form mesolve trace:", out["dense_trace"])
    val, grad = out["mcwf_grad"]
    print("MCWF pathwise d<Sz>/domega:", grad, " value:", val)
    return out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pulser_diff_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the hand-written kernels, from csrc/, into the ignored build
     directory, one nvcc per source, all started together, with ptxas's
     registers and spill bytes for each kernel instantiation;
  3. kernels against their plain PyTorch versions on the card: K1
     (fused_fwd_kernel) on every evaluation-slot state and K2
     (fused_bwd_kernel) on lam0, every stream cotangent and dbar, each
     launched as one thread-block cluster per run (its cluster size, the
     host plan's shared memory against the kernel's own count, and two K2
     runs equal bit for bit, printed); K4
     (fused_fwd_ckpt_kernel) on every step's state and K5
     (fused_bwd_ckpt_kernel) on the same outputs as K2; at the main paths'
     shapes and at small shapes that cover the direct form, da != db, a
     state batch, the RK4 tableau and two runs.  K1/K2 refuse what
     does not fit a block's shared memory and name ckpt=True; a 14-atom
     value+grad step with default options then takes K4/K5 (exactly one
     launch each, held against the f64 stepper at the bars of phase 4).
     K4/K5's launch plan (grid, tile, jobs, barriers per step, shared
     memory) equals the host's ckpt_plan, the kernels' own barrier counts
     equal the plan's, two K5 runs are equal bit for bit, and no K4/K5
     instantiation spills.  The kron-pair branches (K3, the
     XY terms) of all four kernels at small XY shapes (2, 3, 4 atoms, an
     in-plane field) and at the 12-atom XY shapes (K = 8), with K2/K5's
     kron stream and part-matrix cotangents and the states' low words; K4
     equal to K1 at every 12-atom XY slot, bit for bit;
  4. the 12-atom main path: the 8-parameter value-and-gradient step of
     bench.py through QuantumModel.expectation_fn and torch.autograd, held
     against the port's f64 stepper on the card (1e-6 on the value, 1e-5
     on the gradient) with exactly one K1 and one K2 launch per step;
  5. the 16-atom main path: the same step at dim 2^16, which routes to
     K4/K5, with exactly one K4 and one K5 launch and no K1/K2 launch,
     held against the f64 stepper at the same bars (its time and peak
     device memory printed);
  6. the 12-atom XY main path: bench_xy.py's value and gradient with
     respect to 8 amplitude parameters and q1's coordinates through
     QuantumModel (default routing), with exactly one K1 and one K2 launch
     and no K4/K5 launch, held against the f64 stepper at the same bars,
     the coordinate gradient included (the f64 step's time and peak device
     memory printed);
  7. times: each kernel's warm median (CUDA events) beside its plain
     version's time and its bound, the value+grad steps, the f64 steps;
  8. 18 atoms (dim 2^18): bench.py's step with default options takes the
     f32 stepper DP5_SE_F32 (no fused launch), held against the f64
     stepper at 1e-5 / 1e-5, with its time and peak device memory; the
     same step with TF32 allowed gives the same bits; with remat=True the
     same result; with fused=True K4/K5 (against their plain versions at
     these shapes, their plans, times, and the step at the BASELINE bars);
  9. population (bench_population.py): 8 candidates at 12 atoms through
     expectation_population_fn, exactly one K1 and one K2 launch, each
     candidate's value and gradient equal to its own step's bit for bit;
     2 candidates at 16 atoms, one K4 and one K5 launch, values bit for bit
     and gradients within 1e-6 relative; the kernels at those R-run shapes
     against their plain versions, K1/K2's resident clusters, K4/K5's
     plans, kernel times at R > 1 and R = 1, the population step against
     the sequential steps;
 10. 14- and 16-atom XY: bench_xy.py's step on the default route (K4/K5
     with 9 and 10 kron pairs), value, gradient and q1's coordinate
     gradient against the f64 stepper at the BASELINE bars, with the
     step's and kernels' times and bounds;
 11. the noisy Monte-Carlo batch (bench_mc.py: doppler + amplitude noise,
     one amplitude and one detuning stream per qubit, so pr = pc = 12
     parts at 12 atoms) through TorchEmulator.run(): at 12 atoms R = 1, 8
     and 32 exactly one K1 launch a run(), every time's counts summing to
     runs x samples_per_run and results[-1] to 1, warm run() times; K1 at
     the R-run inputs against its plain version (two runs at R = 8, one
     at R = 32), two runs' final states against the f64 stepper (1e-6),
     K4 equal to K1 bit for bit at every slot, K1's resident clusters; 16
     atoms R = 8 and 18 atoms R = 2 (pr = pc = 18) in one K4 launch, K4
     against its plain version on one run, one run against the f64
     stepper, time and peak memory; synthetic pr = pc = 12 and 20 parts at
     small shapes (K1 against plain, K4 = K1 bit for bit; K2 and K5
     against plain on the first WIDE_STEPS steps) and
     every kernel refusing 33 parts on the host before any launch; SPAM (eta 0.1, eps
     0.01, eps' 0.05, 15 runs) on K1 and the eta = 0 CoherentResults path
     with sample_state; the device sampler's bit marginals within 5
     standard errors of the exact mixture's, without and with detection
     flips (20000 samples a run, 8 runs);
 12. the Lindblad path of bench_mesolve.py at a quarter of its duration (100 ns;
     no kernel on it, as in the JAX package; every count stays 0): the 10-atom value+grad step through
     QuantumModel with dephasing (DP5_ME, the dense form at dim 1024)
     against the factored form (1e-10 on the value, 1e-8 on the gradient)
     and DP5_ME_F32 (1e-5 / 1e-5), its final trace within 1e-10 of 1, its
     remat plan, time, peak device memory and busy share; the 3-atom
     dephasing-rate gradient (superop form) against a central difference
     (1e-6); the 12-atom run() on the factored form (dim 4096), the final
     trace and Hermiticity within 1e-10, time and peak; dephasing +
     doppler run() at 8 atoms, R = 4 (one mesolve a run), counts summing
     to runs x samples_per_run;
 13. quantum-jump trajectories (bench_mcwf.py at 100 ns, no kernel): the 3-atom
     run(solver="MCWF", n_traj=1024) populations against DP5_ME within
     4/sqrt(R); 12 atoms MCWF_F32 at R = 64, timed, its final counts
     summing to 1; at 10 atoms expectation_mcwf_fn's value and gradient
     against the DP5_ME model's (0.05, 0.02 x scale: the bars of
     tests/test_mcwf.py::test_mcwf_gradient_matches_mesolve);
 14. training: bench.py's model with bench_mc.py's noise (doppler 50 uK,
     amplitude 0.05), one drawn realization pinned: the 12-atom value+grad
     step (one K1 and one K2 launch at pr = pc = 12) and the 16-atom one
     (one K4 and one K5 launch at 16) against the f64 stepper on the same
     draws (1e-6 / 1e-5), K2 / K5 at those shapes against their plain
     versions on the first PLAIN_STEPS steps and timed; fit on bench.py's
     12-atom model (5 epochs, default Adam: one K1 and one K2 launch an
     epoch, every loss equal bit for bit to a hand loop); fit_population
     with 8 candidates (6 evaluations on the runs axis: 6 K1 and 5 K2
     launches; each candidate's losses against a lone fit from it);
     duration optimisation (ConstantPulse(dur[0], 2, -2, 0) on the 3x4
     lattice: the duration gradient against the f64 stepper's, 3 epochs of
     fit move it); fit on the noisy model, one realization for 3 epochs;
 15. the rest of the front end: (a) bench.py's 12-atom model with a
     rydberg_local channel beside its global one (two disjoint target
     groups in turn, a phase shift, Blackman pulses of trainable area,
     ramped detunings; pr = pc = 8 parts) on the default route (one K1 and
     one K2 launch; the value held against the f64 stepper at 1e-6, value
     and gradient against the same step through K1/K2's plain versions at
     1e-6 / 1e-6, the gradient's distance to the f64 stepper printed beside
     the plain versions' own: the lean adjoint's rebuild) and with
     ckpt=True (one K4 and one K5 launch, value and gradient held at 1e-6 /
     1e-5); (b) a modulated run() on AnalogDevice with an EOM block (one K1
     launch, the final state against the f64 stepper at 1e-6); (c)
     bench_xy.py's 12-atom step under an SLM mask on two qubits (K = 16
     kron pairs, one K1 and one K2 launch) and (d) the 16-atom one (K = 20,
     one K4 and one K5 launch), value, gradient and q1's coordinate
     gradient against the f64 stepper at 1e-6 / 1e-5 / 1e-5; every kernel
     at these shapes against its plain version (on every step in (a) and
     (b), on a window around the SLM window's end in (c) and (d)), timed,
     with its bound;
 16. the other bases: bench.py's model with a raman_global pulse of
     trainable amplitude beside its rydberg_global one (the all basis,
     three levels a site, da = 3^a; the total Rydberg occupation) through
     QuantumModel on the default route: at 2 and 6 atoms (3 x 3, 27 x 27)
     one K1 and one K2 launch on a cluster of one block (C = 1), at 6 atoms
     with ckpt=True one K4 and one K5 launch; at 8 atoms (81 x 81) K1/K2's
     plan refuses on the host before any launch and the step takes one K4
     and one K5 launch, as at 10 atoms (243 x 243, dim 59049); (c)
     bench.py's model on raman_global alone (the digital basis, 64 x 64, no
     interaction, K1/K2 at C = 16); each step against the f64 stepper at
     1e-6 / 1e-5 with its time and peak device memory, its kernels against
     their plain versions on the first PLAIN_STEPS steps, timed with
     their bounds; (d) a 4-atom Lindblad run() on
     the leakage-extended basis (dim 81, no kernel): the dense and
     factored forms within 1e-10, trace and Hermiticity 1e-10, the weights
     reading |x> as 0; (e) at 12 atoms (f64 stepper, no kernel)
     expectation_fn_of_times and deriv_time with the pulse boundaries
     repaired, against a central difference at three interior times, and
     deriv_param at the final time against a central difference along the
     gradient, 1e-5 relative, timed;
 17. the Krylov and adaptive steppers and the final-state form: (a)
     bench.py's 12-atom model cut to 132 ns, value and gradient on the card
     under KRYLOV_SE, DP5_SE_ADAPTIVE and KRYLOV_SE_F32 (no kernel under
     them: every count stays 0), each f64 solver against the same call on
     the card machine's CPU (KRYLOV_SE 1e-10 relative on the value, 1e-8
     x max|g| on the gradient; DP5_SE_ADAPTIVE 1e-8 / 1e-6, both runs'
     attempted and accepted steps printed), KRYLOV_SE_F32 against
     KRYLOV_SE on the card (the value within 3x the JAX package's own
     f32-to-f64 distance on this model, floor 1e-5; the gradient 1e-4 x
     max|g| + 1e-8); their times, peak device memory, busy shares (on the
     model cut to 20 ns), the adaptive loop's host reads, and each one's distance to the f64
     DP5_SE step at 1 and 8 substeps, printed; (b) pallas_evolve (the
     final state only) at 12 atoms (one K1 and one K2 launch), 16 atoms
     with ckpt=True (one K4 and one K5) and on the 12-atom XY model (K1/K2
     with kron pairs): the final state equal to evolve_states' last slot
     bit for bit, the gradient within 1e-4 relative of evolve_states',
     the kernels at the final-state inputs against their plain versions,
     timed, with their bounds;
 18. the example flows of pulser_diff_torch/examples (the docs/*.py user
     flows), each through its own functions on its default route: (a) the
     2-qubit gate (the identity as a batch of nb = 4 states, one cluster
     of C = 2 blocks): the first value+grad step against the f64 stepper
     (1e-6 / 1e-5), then Adam at lr 0.15 from 3.0 until the fidelity
     reaches 99 % within 200 steps, one K1 and one K2 launch every step;
     (b) the 4-qubit gate (nb = 16, C = 4), its first step; (c) the 6-atom
     state preparation (C = 8) and (d) the 9-atom AFM preparation (dim
     512, C = 16), their first steps (the same bars) and 3 Adam steps
     timed; K1/K2 against their plain versions on every
     step of one epoch in (a) and (b), on the sweep's first 24 steps in
     (c) and (d), timed with their bounds and cluster sizes,
     and each epoch split into the host's rebuild of Sequence -> sampler
     -> Hamiltonian, K1 + K2 and the rest; (e) multi_start at its CI sizes
     (P = 4 candidates on the runs axis, 40 epochs: 41 K1 and 40 K2
     launches), every candidate's first loss equal to its own evaluation,
     the loaded candidate's loss the least seen; (f) noisy_simulation's
     Monte-Carlo run() (one K1 launch, counts summing to runs x
     samples_per_run, reproducible from its seed); (g) basic_usage's
     deriv_param on K1/K2 against a central difference of the f64
     stepper (value 1e-6, derivative 1e-5 relative), deriv_time (f64
     stepper) on the first 151 evaluation times against central
     differences at three times in the constant pulse (1e-5 relative),
     the central differences on the card machine's CPU; (h) large_scale
     at 18 atoms: its model built bit for bit as bench.py's, whose step
     phase 8 takes (DP5_SE_F32, no fused launch), and the f32 run()'s
     final norm; each sub-phase's wall seconds printed.

The last two lines are one JSON object per kernel list and the result
line {"ok": true, "device": {...}}.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# the 12-atom main path of bench.py
N_QUBITS = 12
DURATION = 660
N_PARAMS = 8
SAMPLING_RATE = 0.25
SPACING = 10.0
DET0 = -2.0
SEED = 0

# the 12-atom XY path of bench_xy.py: microwave_global, 8 sine-interpolated
# amplitude parameters and the coordinates of q1
XY_DURATION = 400
XY_SPACING = 8.0
XY_P0 = np.linspace(0.5, 2.0, N_PARAMS)

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version, both f32 on the card in a different summation
# order: K1 states are unit-norm, ~1000 dependent stages of ~6e-8
# rounding random-walk to ~2e-6, so 1e-5 absolute; K2 outputs are sums
# over up to da*db*nb terms per stage (its stream and kcbar cotangents
# summed per block over the block's rows, then across the cluster in rank
# order), so 1e-4 relative to the largest magnitude of each output
K1_TOL = 1e-5
K2_TOL_REL = 1e-4
# the BASELINE bars of the fused f32 path against the f64 path
VALUE_TOL = 1e-6
GRAD_TOL = 1e-5
# the f32 stepper's accuracy class against f64 (the route the JAX package
# takes from 18 atoms; it records 3.4e-6 / 1.6e-6 there): wider than the
# fused kernels' compensated arithmetic
F32_VALUE_TOL = 1e-5
F32_GRAD_TOL = 1e-5

# the population workload of bench_population.py: P candidates around
# bench.py's parameters, 0.3 apart (seeded); K1/K2 at 12 atoms, K4/K5 at 16
POP_SPREAD = 0.3
POP_12 = 8
POP_16 = 2
# K4/K5 at R > 1 against R = 1: the states come out equal bit for bit,
# zbar's job partials may be summed in another order, so the gradient is
# held to 1e-6 relative
POP_CKPT_GRAD_REL = 1e-6


_START = [None]


def _log(msg: str) -> None:
    """Print ``msg``; a phase's first line gets the seconds since the first
    line."""
    if _START[0] is None:
        _START[0] = time.perf_counter()
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - _START[0]:.1f} s] {msg}"
    print(msg, flush=True)


def _bench_model(torch, device, fused, n_qubits: int = N_QUBITS,
                 duration: int = DURATION, **options):
    """bench.py's model at ``n_qubits`` atoms; ``fused=None`` keeps the
    default routing."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch.core import (
        ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    coords = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(n_qubits)]
    reg = Register.from_coordinates(coords, prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp_var = seq.declare_variable("amp_samples", size=duration)
    seq.add(
        Pulse(CustomWaveform(amp_var, duration=duration),
              ConstantWaveform(duration, DET0), 0.0),
        "ryd",
    )
    M = torch.as_tensor(_interpolate_sine_np(N_PARAMS, duration), device=device)
    p0 = np.linspace(1.0, 3.0, N_PARAMS)
    model = QuantumModel(
        seq,
        {"amp_samples": ((p0,), lambda v: M @ v)},
        sampling_rate=SAMPLING_RATE,
        evaluation_times="Minimal",
        device=device,
        **({} if fused is None else {"fused": fused}),
        **options,
    )
    return model, p0


def _xy_model(torch, device, fused, n_qubits: int = N_QUBITS, duration: int = XY_DURATION,
              **options):
    """bench_xy.py's model at ``n_qubits`` atoms on a 4-column lattice at
    8 um, with q1's coordinates trainable; returns (model, q1's coords)."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch.core import (
        ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    coords = [(XY_SPACING * (i % 4), XY_SPACING * (i // 4)) for i in range(n_qubits)]
    reg = Register.from_coordinates(coords, prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("mw", "microwave_global")
    amp_var = seq.declare_variable("amp_samples", size=duration)
    seq.add(Pulse(CustomWaveform(amp_var, duration=duration),
                  ConstantWaveform(duration, 0.0), 0.0), "mw")
    M = torch.as_tensor(_interpolate_sine_np(N_PARAMS, duration), device=device)
    model = QuantumModel(
        seq,
        {"amp_samples": ((XY_P0,), lambda v: M @ v), "q1": coords[1]},
        sampling_rate=SAMPLING_RATE,
        evaluation_times="Minimal",
        device=device,
        **({} if fused is None else {"fused": fused}),
        **options,
    )
    return model, coords[1]


def _xy_value_and_grad(torch, model, c1, device):
    """(value, parameter gradient, coordinate gradient, values)."""
    p = torch.tensor(XY_P0, dtype=torch.float64, device=device, requires_grad=True)
    c = torch.tensor(c1, dtype=torch.float64, device=device, requires_grad=True)
    _, vals = model.expectation_fn()({"amp_samples_0": p, "q1": c})
    value = vals[-1]
    value.backward()
    return value.detach(), p.grad.detach(), c.grad.detach(), vals.detach()


def _value_and_grad(torch, model, p0, device):
    p = torch.tensor(p0, dtype=torch.float64, device=device, requires_grad=True)
    _, vals = model.expectation_fn()({"amp_samples_0": p})
    value = vals[-1]
    value.backward()
    return value.detach(), p.grad.detach(), vals.detach()


def _kernel_inputs(torch, sim, substeps: int, device, method: str = "DP5"):
    """The fused kernels' inputs as the main path stages them."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.ops.fused_evolution import prepare_fused_inputs
    from pulser_diff_torch.solvers import TimeGrid

    h = sim._hamiltonian
    da, db = h.dim**h._a, h.dim**h._b
    grid = TimeGrid.make(h.sampling_times, sim._eval_times_array, device).refined(substeps)
    psi0 = sim.initial_state
    nb = psi0.shape[1]
    p = Cplx(psi0.re.T.reshape(nb, da, db), psi0.im.T.reshape(nb, da, db))
    with torch.no_grad():
        data = prepare_fused_inputs(h._ham_data, p, grid.times, method)
    data = {k: v.detach().contiguous() for k, v in data.items()}
    slots = torch.as_tensor(np.asarray(grid.write_slots, np.int32), device=device)
    return data, slots, grid.n_eval, int(grid.write_slots[-1])


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _check_kernels(torch, fe, data, slots, n_eval, last_slot, method, gen, label, times=None):
    """K1 and K2 against their plain versions on the same inputs; returns
    (k1 max abs err, k2 max abs err, k2 max relative err, inputs of K2).
    ``times``: a dict that gets the plain versions' times (ms, once)."""
    # with kron pairs the states' low words too
    lo = fe._n_kron(data) > 0
    outs = fe.fused_fwd(data, method, slots, n_eval, lo=lo)
    k1_plain_ms, refs = _host_time_ms(
        torch, lambda: fe.fused_fwd_plain(data, method, slots, n_eval, lo=lo), 1)
    (out_re, out_im), (ref_re, ref_im) = outs[:2], refs[:2]
    k1_err = max(_max_err(o, w) for o, w in zip(outs, refs))
    if not all(torch.isfinite(o).all() for o in outs):
        raise RuntimeError(f"{label}: K1 produced non-finite states")
    if k1_err > K1_TOL:
        raise RuntimeError(f"{label}: K1 vs plain {k1_err:.3e} > {K1_TOL:.0e}")
    shape = tuple(ref_re.shape)
    lam_re = torch.randn(shape, generator=gen, dtype=torch.float32).to(ref_re.device)
    lam_im = torch.randn(shape, generator=gen, dtype=torch.float32).to(ref_re.device)
    got = fe.fused_bwd(data, method, slots, n_eval, last_slot, ref_re, ref_im, lam_re, lam_im)
    k2_plain_ms, want = _host_time_ms(torch, lambda: fe.fused_bwd_plain(
        data, method, slots, n_eval, last_slot, ref_re, ref_im, lam_re, lam_im), 1)
    if times is not None:
        times.update(k1_plain=k1_plain_ms, k2_plain=k2_plain_ms)
    k2_abs, k2_rel = _compare_adjoint(torch, fe, data, got, want, f"{label}: K2")
    _log(f"  {label}: K1 max|err| {k1_err:.3e} (tol {K1_TOL:.0e}), "
         f"K2 max|err| {k2_abs:.3e}, max rel err {k2_rel:.3e} (tol {K2_TOL_REL:.0e})")
    return k1_err, k2_abs, k2_rel, (ref_re, ref_im, lam_re, lam_im)


def _small_cases(torch, device):
    """Small shapes: direct form (da = db = 2), da != db with a state
    batch and every sampling time an evaluation time, and RK4."""
    from pulser_diff_torch import TorchEmulator
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence
    from pulser_diff_torch.core import ConstantWaveform, CustomWaveform

    cases = []
    for n, nb, method, eval_times in ((2, 1, "DP5", "Minimal"), (3, 2, "DP5", "Full"),
                                      (4, 1, "RK4", 0.5)):
        reg = Register.from_coordinates(
            [(6.0 * (i % 2), 6.0 * (i // 2)) for i in range(n)], prefix="q")
        seq = Sequence(reg, MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        t = np.arange(120)
        seq.add(Pulse(CustomWaveform(1.0 + np.sin(t / 20.0) ** 2),
                      ConstantWaveform(120, -1.5), 0.4), "ryd")
        sim = TorchEmulator.from_sequence(seq, sampling_rate=0.5,
                                          evaluation_times=eval_times, device=device)
        if nb > 1:
            rng = np.random.default_rng(SEED + n)
            st = rng.normal(size=(2**n, nb)) + 1j * rng.normal(size=(2**n, nb))
            st /= np.linalg.norm(st, axis=0)
            sim.set_initial_state(Cplx(torch.as_tensor(st.real, device=device),
                                       torch.as_tensor(st.imag, device=device)))
        cases.append((f"{n} atoms nb={nb} {method}", sim, method))
    return cases


def _xy_small_cases(torch, device):
    """Small XY shapes with an in-plane field (the angle term on): 2 atoms
    (cross terms only, the direct form), 3 atoms with a state batch (da !=
    db, within-column + cross terms) and 4 atoms with RK4 (all three
    kinds of kron pairs)."""
    from pulser_diff_torch import TorchEmulator
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.core import CustomWaveform, MockDevice, Pulse, Register, Sequence

    cases = []
    for n, nb, method in ((2, 1, "DP5"), (3, 2, "DP5"), (4, 1, "RK4")):
        reg = Register.from_coordinates(
            [(8.0 * i, 2.0 * (i % 2)) for i in range(n)], prefix="q")
        seq = Sequence(reg, MockDevice)
        seq.declare_channel("mw", "microwave_global")
        seq.set_magnetic_field(1.0, 1.0, 0.0)
        t = np.arange(100)
        seq.add(Pulse(CustomWaveform(1.0 + np.sin(t / 15.0) ** 2),
                      CustomWaveform(0.3 * np.cos(t / 25.0)), 0.3), "mw")
        sim = TorchEmulator.from_sequence(seq, sampling_rate=0.5, evaluation_times="Full",
                                          device=device)
        if nb > 1:
            rng = np.random.default_rng(SEED + n)
            st = rng.normal(size=(2**n, nb)) + 1j * rng.normal(size=(2**n, nb))
            st /= np.linalg.norm(st, axis=0)
            sim.set_initial_state(Cplx(torch.as_tensor(st.real, device=device),
                                       torch.as_tensor(st.imag, device=device)))
        cases.append((f"XY {n} atoms nb={nb} {method}", sim, method))
    return cases


def _cuda_time_ms(torch, fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _host_time_ms(torch, fn, n: int):
    """fn() n times, each timed on the host clock around synchronised work:
    the median time (ms) and the last output."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _check_ckpt(torch, fe, data, method, gen, label, times=None):
    """K4 and K5 against their plain versions on the same inputs, K5 from
    the plain stored states and random per-step cotangents; returns
    (K4 max abs err, K5 max abs err, K5 max rel err, inputs of K5).
    ``times``: a dict that gets the plain versions' times (ms, once)."""
    lo = fe._n_kron(data) > 0
    outs = fe.fused_fwd_ckpt(data, method, lo=lo)
    k4_plain_ms, refs = _host_time_ms(
        torch, lambda: fe.fused_fwd_ckpt_plain(data, method, lo=lo), 1)
    ref_re, ref_im = refs[:2]
    if not all(torch.isfinite(o).all() for o in outs):
        raise RuntimeError(f"{label}: K4 produced non-finite states")
    k4_err = max(_max_err(o, w) for o, w in zip(outs, refs))
    if k4_err > K1_TOL:
        raise RuntimeError(f"{label}: K4 vs plain {k4_err:.3e} > {K1_TOL:.0e}")
    shape = tuple(ref_re.shape)
    lam_re = torch.randn(shape, generator=gen, dtype=torch.float32).to(ref_re.device)
    lam_im = torch.randn(shape, generator=gen, dtype=torch.float32).to(ref_re.device)
    got = fe.fused_bwd_ckpt(data, method, ref_re, ref_im, lam_re, lam_im)
    k5_plain_ms, want = _host_time_ms(
        torch, lambda: fe.fused_bwd_ckpt_plain(data, method, ref_re, ref_im, lam_re, lam_im), 1)
    if times is not None:
        times.update(k4_plain=k4_plain_ms, k5_plain=k5_plain_ms)
    k5_abs, k5_rel = _compare_adjoint(torch, fe, data, got, want, f"{label}: K5")
    _log(f"  {label}: K4 max|err| {k4_err:.3e} (tol {K1_TOL:.0e}), "
         f"K5 max|err| {k5_abs:.3e}, max rel err {k5_rel:.3e} (tol {K2_TOL_REL:.0e})")
    return k4_err, k5_abs, k5_rel, (ref_re, ref_im, lam_re, lam_im)


def _compare_adjoint(torch, fe, data, got, want, label):
    """An adjoint kernel's (lam0, zbar, dbar) against its plain version:
    each output within K2_TOL_REL of its largest magnitude."""
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    pairs = [("lam0_re", got[0], want[0]), ("lam0_im", got[1], want[1]), ("dbar", got[3], want[3])]
    names = ("zbar_rr", "zbar_ri", "zbar_cr", "zbar_ci")
    pairs += list(zip(names, fe._unpack_zbar(got[2], pr, pc), fe._unpack_zbar(want[2], pr, pc)))
    if len(want) > 4:  # the kron pairs' stream and part-matrix cotangents
        pairs += list(zip(("zbar_kr", "zbar_ki"), fe._unpack_zbar_kron(got[2], pr, pc),
                          fe._unpack_zbar_kron(want[2], pr, pc)))
        pairs += [("krbar", got[4], want[4]), ("kcbar", got[5], want[5])]
    err_abs = err_rel = 0.0
    for name, g, w in pairs:
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{label} {name} is not finite")
        err = _max_err(g, w)
        rel = err / max(float(w.abs().max()), 1e-30)
        err_abs, err_rel = max(err_abs, err), max(err_rel, rel)
        if rel > K2_TOL_REL:
            raise RuntimeError(f"{label} {name} vs plain rel {rel:.3e} > {K2_TOL_REL:.0e}")
    return err_abs, err_rel


def _two_runs(torch, fe, data):
    """Two runs on the run axis: the given one, and one with its state's
    real and imaginary parts swapped and its streams scaled by 0.9."""
    shared = ("rp", "cp", "hb_hi", "hb_lo", "hs")
    out = {}
    for k, v in data.items():
        if k in shared:
            out[k] = v
            continue
        w = v * 0.9 if k in fe._ZF_KEYS + fe._ZB_KEYS else v
        if k == "psi_re":
            w = data["psi_im"]
        if k == "psi_im":
            w = data["psi_re"]
        out[k] = torch.cat((v, w)).contiguous()
    return out


def _bound_ms(fe, data, slots, others, S: int, kind: str) -> tuple[float, str]:
    """Least time for the work: the bytes of every input read once and
    every output written once over the HBM rate, against the products'
    f32 operations over the non-tensor f32 rate; the larger of the two.
    ``others``: the kernel's tensors outside ``data`` (states, cotangents,
    outputs).  ``kind``: "fwd" (K1), "bwd" (K2), "fwd_ckpt" (K4) or
    "bwd_ckpt" (K5)."""
    R, nb, da, db = (int(v) for v in data["psi_re"].shape)
    n_steps = int(data["hs"].shape[0])
    K = fe._n_kron(data)
    # 8 real products per application of -iH (4 row-side, 4 column-side),
    # and 8 per kron pair (R u, R^T u, then times C^T or C, for x and y);
    # the side matrices assembled from the parts, two stream words each:
    # 2 (pr da^2 + pc db^2) words, a multiply and an add each
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    kron_flops = 2 * nb * K * 4 * (da * da * db + da * db * db)
    assembly_flops = 2 * (pr * da * da + pc * db * db) * 2
    apply_flops = 2 * 4 * nb * (da * da * db + da * db * db) + kron_flops + assembly_flops
    # per stage the 8 outer products of (W, V, Wc, Vc), and per kron pair
    # the 16 of the part-matrix cotangents (8 of them (da, da, db) or
    # (db, db, da)); the stream cotangents reuse the products of the
    # transpose application, counted in apply_flops
    outer_flops = (2 * 4 * nb * (da * da * db + db * db * da)
                   + 2 * nb * K * (4 * (da * db * db + da * da * db)
                                   + 4 * da * da * db + 4 * db * db * da))
    # and per stage the contraction of (W, V, Wc, Vc) against the part
    # stacks: 2 words, a multiply and an add each, per part entry
    outer_flops += 2 * (pr * da * da + pc * db * db) * 2
    shared = ("rp", "cp", "hb_hi", "hb_lo", "hs", "diag", "diag_lo") + fe._ZF_KEYS
    if K:
        shared += ("kr", "kc") + fe._ZKF_KEYS
    inputs = [data[k] for k in shared]
    if kind in ("fwd", "fwd_ckpt"):
        # S applications per step
        flops = R * n_steps * S * apply_flops
        inputs += [data["psi_re"], data["psi_im"]]
    elif kind == "bwd":
        # S mirror + (S - 1) forward + S transpose applications per step
        flops = R * n_steps * ((3 * S - 1) * apply_flops + S * outer_flops)
        inputs += [data[k] for k in fe._ZB_KEYS + (fe._ZKB_KEYS if K else ())]
    else:
        # (S - 1) forward + S transpose applications per step, no mirror pass
        flops = R * n_steps * ((2 * S - 1) * apply_flops + S * outer_flops)
        inputs += [data["psi_re"], data["psi_im"]]
    tensors = (*inputs, *(() if slots is None else (slots,)), *others)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _xy_kernel_phase(torch, fe, device, gen):
    """The kron-pair branches (K3) against their plain versions: K1/K2 and
    K4/K5 at the small XY shapes and at the 12-atom XY shapes (K4 equal to
    K1 at every evaluation slot, bit for bit).  Returns the 12-atom inputs
    and errors, and the plain versions' times."""
    for label, sim, method in _xy_small_cases(torch, device):
        sd, ss, sn, sl = _kernel_inputs(torch, sim, 1, device, method)
        _check_kernels(torch, fe, sd, ss, sn, sl, method, gen, label)
        _check_ckpt(torch, fe, sd, method, gen, label)
    model, c1 = _xy_model(torch, device, fused=None)
    substeps = model._default_substeps()
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, substeps, device)
    K = fe._n_kron(data)
    _log(f"  12 atoms XY: K = {K} kron pairs, {int(data['hs'].shape[0])} steps, "
         f"substeps {substeps}, kr {tuple(data['kr'].shape)}, kc {tuple(data['kc'].shape)}")
    times = {}
    plan = _log_plan(fe, fe._library(), data, "DP5", "12 atoms XY (main path)")
    k1_err, k2_err, _, k2_in = _check_kernels(
        torch, fe, data, slots, n_eval, last_slot, "DP5", gen, "12 atoms XY (main path)", times)
    _two_k2_runs(torch, fe, data, slots, n_eval, last_slot, k2_in, "12 atoms XY")
    k4_err, k5_err, _, k5_in = _check_ckpt(
        torch, fe, data, "DP5", gen, "12 atoms XY (ckpt=True)", times)
    ckpt_plans = _ckpt_plans(torch, fe, data, "12 atoms XY (ckpt=True)")
    _two_k5_runs(torch, fe, data, k5_in, "12 atoms XY")
    ck = fe.fused_fwd_ckpt(data, "DP5", lo=True)
    k1 = fe.fused_fwd(data, "DP5", slots, n_eval, lo=True)
    g_of = {int(s): g for g, s in enumerate(slots.tolist()) if s < n_eval}
    k4_vs_k1 = max(_max_err(c[:, g - 1], o[:, s]) for c, o in zip(ck, k1)
                   for s, g in g_of.items() if g > 0)
    _log(f"  12 atoms XY: K4 vs K1 at the evaluation slots (both words) max|diff| "
         f"{k4_vs_k1:.3e}")
    if k4_vs_k1 != 0.0:
        raise RuntimeError(f"12 atoms XY: K4 differs from K1 at the slots by {k4_vs_k1:.3e}")
    return {"model": model, "c1": c1, "data": data, "slots": slots, "n_eval": n_eval,
            "last_slot": last_slot, "k1_err": k1_err, "k2_err": k2_err, "k4_err": k4_err,
            "k5_err": k5_err, "k2_in": k2_in, "k5_in": k5_in, "plain": times, "plan": plan,
            "ckpt_plans": ckpt_plans}


def _xy_step_phase(torch, fe, device, xy):
    """The 12-atom XY value+grad through QuantumModel (default routing),
    counts reset just before and read just after: one K1 and one K2
    launch, no K4/K5; held against the f64 stepper on the card."""
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value, grad, cgrad, vals = _xy_value_and_grad(torch, xy["model"], xy["c1"], device)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fe.LAUNCHES)
    if launches != {"fused_fwd": 1, "fused_bwd": 1, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}:
        raise RuntimeError(f"12 atoms XY: expected one K1 and one K2 launch, got {launches}")
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(grad).all()
                                  and torch.isfinite(cgrad).all()):
        raise RuntimeError(f"12 atoms XY: bad output: values {vals}, grad {grad}, coords {cgrad}")
    if float(cgrad.abs().max()) == 0.0:
        raise RuntimeError("12 atoms XY: the coordinate gradient is zero")
    f64_model, c1 = _xy_model(torch, device, fused=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v64, g64, c64, _ = _xy_value_and_grad(torch, f64_model, c1, device)
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t0) * 1e3
    f64_peak = torch.cuda.max_memory_allocated() / 2**30
    del f64_model
    _log(f"  launches {launches}; f64 stepper value+grad {f64_ms:.1f} ms (once), peak device "
         f"memory {f64_peak:.2f} GiB")
    dv = abs(float(value) - float(v64))
    dg = float((grad - g64).abs().max())
    dc = float((cgrad - c64).abs().max())
    _log(f"  12 atoms XY: value {float(value)!r}  f64 {float(v64)!r}  |dv| {dv:.3e} "
         f"(tol {VALUE_TOL:.0e})")
    _log(f"  12 atoms XY: grad  {grad.cpu().numpy().tolist()!r}")
    _log(f"  12 atoms XY: f64   {g64.cpu().numpy().tolist()!r}  max|dg| {dg:.3e} "
         f"(tol {GRAD_TOL:.0e})")
    _log(f"  12 atoms XY: coordinate grad {cgrad.cpu().numpy().tolist()!r}  f64 "
         f"{c64.cpu().numpy().tolist()!r}  max|dc| {dc:.3e} (tol {GRAD_TOL:.0e}), "
         f"max|coordinate grad| {float(cgrad.abs().max()):.6e}")
    # what the states' low words repair: the same final state's value from
    # its f32 hi words alone (the Pallas kernel's single-word states), as
    # the expectation takes f32 states (|s|^2 in f32) and squared in f64
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.ops.linalg import expect, total_magnetization

    outs = fe.fused_fwd(xy["data"], "DP5", xy["slots"], xy["n_eval"], lo=True)
    mag = total_magnetization(N_QUBITS, dense=False, device=device)
    ls = xy["last_slot"]

    def _value(re, im):
        return float(expect(mag, Cplx(re.reshape(re.shape[0], -1).T[None],
                                      im.reshape(im.shape[0], -1).T[None])).re[0])

    hi_re, hi_im = outs[0][0, ls], outs[1][0, ls]
    errs = [abs(v - float(v64)) for v in (
        _value(hi_re, hi_im), _value(hi_re.double(), hi_im.double()),
        _value(hi_re.double() + outs[2][0, ls].double(), hi_im.double() + outs[3][0, ls].double()))]
    _log("  12 atoms XY: final value from the hi words alone |dv| {:.3e} (f32 squares), "
         "{:.3e} (f64 squares); from hi + lo |dv| {:.3e}".format(*errs))
    if dv > VALUE_TOL or dg > GRAD_TOL or dc > GRAD_TOL:
        raise RuntimeError(f"12 atoms XY: fused path vs f64 stepper: |dv| {dv:.3e}, "
                           f"|dg| {dg:.3e}, |dc| {dc:.3e}")
    return {"launches": launches, "first_ms": first_ms, "f64_ms": f64_ms, "f64_peak": f64_peak,
            "dv": dv, "dg": dg, "dc": dc}


def _ptxas_summary(report: str) -> dict:
    """Registers and spill bytes (stores, loads) of each function (kernel
    entries and out-of-line device functions) in a ``ptxas -v`` report, by
    mangled name."""
    out, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            out.setdefault(name, [None, None, None])
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            out[name][1] = int(words[words.index("spill") - 2])
            out[name][2] = int(words[words.index("loads") - 3])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[name][0] = int(words[words.index("registers") - 1])
    return out


def _instantiation(mangled: str) -> str:
    """fused_fwd_kernel<true> for _Z16fused_fwd_kernelILb1EE...; other
    functions keep their mangled name."""
    for base in ("fused_fwd_kernel", "fused_bwd_kernel", "fused_fwd_ckpt_kernel",
                 "fused_bwd_ckpt_kernel"):
        tag = f"{len(base)}{base}"
        if tag in mangled:
            rest = mangled.split(tag, 1)[1]
            return base + ("<true>" if rest.startswith("ILb1E") else
                           "<false>" if rest.startswith("ILb0E") else "")
    return mangled


def _log_plan(fe, lib, data, method, label) -> dict:
    """K1's and K2's cluster plans for ``data``; the host's shared memory
    must equal the kernel's own count."""
    R, n_steps, pr, pc, nb, da, db = fe._dims(data)
    S = fe._tableau(method)[2]
    plans = {}
    for bwd in (False, True):
        plan = fe.fused_plan(data, method, bwd)
        own = int(lib.pdt_fused_smem_bytes(int(bwd), nb, da, db, pr, pc, fe._n_kron(data), S,
                                           plan["C"]))
        if own != plan["smem_bytes"]:
            raise RuntimeError(f"{label}: host plan {plan['smem_bytes']} B vs kernel {own} B")
        plans["K2" if bwd else "K1"] = plan
    _log(f"  {label}: K1 cluster C = {plans['K1']['C']} ({plans['K1']['blocks_per_run']} blocks "
         f"per run, {plans['K1']['smem_bytes']} B shared memory a block), K2 cluster C = "
         f"{plans['K2']['C']} ({plans['K2']['blocks_per_run']} blocks per run, "
         f"{plans['K2']['smem_bytes']} B), runs {plans['K1']['runs']}")
    return plans


def _two_k2_runs(torch, fe, data, slots, n_eval, last_slot, k2_in, label) -> None:
    """Two K2 launches on the same inputs give the same bits."""
    a = fe.fused_bwd(data, "DP5", slots, n_eval, last_slot, *k2_in)
    b = fe.fused_bwd(data, "DP5", slots, n_eval, last_slot, *k2_in)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{label}: two K2 runs differ")
    _log(f"  {label}: two K2 runs equal bit for bit")


def _two_k5_runs(torch, fe, data, k5_in, label) -> None:
    """Two K5 launches on the same inputs give the same bits."""
    a = fe.fused_bwd_ckpt(data, "DP5", *k5_in)
    b = fe.fused_bwd_ckpt(data, "DP5", *k5_in)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{label}: two K5 runs differ")
    _log(f"  {label}: two K5 runs equal bit for bit")


def _ckpt_plans(torch, fe, data, label) -> dict:
    """K4's and K5's plans on the card against the host's ckpt_plan, and
    the grid barriers each kernel counted in its last launch (run just
    before, on ``data``) against the plan's."""
    R, n_steps, pr, pc, nb, da, db = fe._dims(data)
    K, S = fe._n_kron(data), fe._tableau("DP5")[2]
    torch.cuda.synchronize()
    plans = {}
    for bwd, name, fn in ((False, "K4", "pdt_ckpt_fwd"), (True, "K5", "pdt_ckpt_bwd")):
        own = fe.ckpt_device_plan(data, "DP5", bwd)
        host = fe.ckpt_plan(bwd, R, nb, da, db, K, S, own["sms"])
        for key in ("blocks", "tile", "jobs_max", "barriers_per_step", "smem_bytes"):
            if host[key] != own[key]:
                raise RuntimeError(f"{label}: {name} plan {key}: host {host[key]} vs kernel {own[key]}")
        counted = int(fe.CKPT_BARRIERS[fn][1])
        if counted != 1 + n_steps * own["barriers_per_step"]:
            raise RuntimeError(f"{label}: {name} took {counted} grid barriers, planned "
                               f"1 + {n_steps} x {own['barriers_per_step']}")
        _log(f"  {label}: {name} {own['blocks']} blocks of {own['sms']} SMs, tile "
             f"{own['tile'][0]}x{own['tile'][1]}, jobs {host['jobs']}, "
             f"{own['barriers_per_step']} grid barriers per step ({counted} in the launch), "
             f"{own['smem_bytes']} B shared memory a block")
        plans[name] = own
    return plans


def _reset(fe) -> None:
    for k in fe.LAUNCHES:
        fe.LAUNCHES[k] = 0


def _hold_against_f64(torch, value, grad, v64, g64, label):
    dv = abs(float(value) - float(v64))
    dg = float((grad - g64).abs().max())
    _log(f"  {label}: value {float(value)!r}  f64 {float(v64)!r}  |dv| {dv:.3e} (tol {VALUE_TOL:.0e})")
    _log(f"  {label}: grad  {grad.cpu().numpy().tolist()!r}")
    _log(f"  {label}: f64   {g64.cpu().numpy().tolist()!r}  max|dg| {dg:.3e} (tol {GRAD_TOL:.0e})")
    if dv > VALUE_TOL or dg > GRAD_TOL:
        raise RuntimeError(f"{label}: fused path vs f64 stepper: |dv| {dv:.3e}, |dg| {dg:.3e}")


def _peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _timed_value_and_grad(torch, model, p0, device):
    """One value+grad with the counts reset just before: (value, grad,
    values, launches, host ms, peak device memory GiB, allocated before
    GiB)."""
    from pulser_diff_torch.ops import fused_evolution as fe

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _reset(fe)
    t0 = time.perf_counter()
    value, grad, vals = _value_and_grad(torch, model, p0, device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return value, grad, vals, dict(fe.LAUNCHES), ms, _peak_gib(torch), before


def _device_busy_ms(torch, fn):
    """The ms the device spent in kernels and copies during one fn() (the
    sum of their durations as torch.profiler records them, device activity
    only), and how many it saw; (None, 0) where the profiler recorded no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the trace's raw events: prof.events() builds a Python object for each
    # of a step's up to ~10^5 launches, minutes on the card's host
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    return (sum(e.duration_ns() for e in dev) / 1e6 if dev else None), len(dev)


def _busy_line(busy, count, step_ms) -> str:
    if busy is None:
        return "device busy share not measured (the profiler saw no device activity)"
    return (f"device busy {busy:.2f} ms in {count} kernels and copies, "
            f"{100 * busy / step_ms:.1f} % of the warm step (idle {100 - 100 * busy / step_ms:.1f} %)")


def _phase_18(torch, fe, device, p0, gen, n: int = 18):
    """18 atoms (dim 2^18, the large-scale tutorial's default), bench.py's
    step: the default route (DP5_SE_F32, no fused launch) against the f64
    stepper, its time and peak memory, the same step with TF32 allowed
    (bit for bit), with remat=True, and with fused=True (K4/K5 at da = db =
    512, a measurement: the default stays the JAX package's)."""
    import pulser_diff_torch.backend as be

    solvers = []
    real_sesolve = be.sesolve
    be.sesolve = lambda *a, **k: solvers.append(k.get("solver")) or real_sesolve(*a, **k)
    try:
        model, _ = _bench_model(torch, device, fused=None, n_qubits=n)
        v, g, vals, launches, first_ms, peak, before = _timed_value_and_grad(torch, model, p0,
                                                                             device)
        route = list(solvers)
    finally:
        be.sesolve = real_sesolve
    if any(launches.values()) or route != ["DP5_SE_F32"]:
        raise RuntimeError(f"18 atoms: expected DP5_SE_F32 and no fused launch, got solvers "
                           f"{route}, launches {launches}")
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(g).all()):
        raise RuntimeError(f"18 atoms: bad output: values {vals}, grad {g}")
    step_ms, _ = _host_time_ms(torch, lambda: _value_and_grad(torch, model, p0, device), 3)
    busy = _device_busy_ms(torch, lambda: _value_and_grad(torch, model, p0, device))
    _log(f"  18 atoms default route: solvers {route}, launches {launches}; value+grad "
         f"{step_ms:.2f} ms warm median of 3 (first {first_ms:.1f} ms), peak device memory "
         f"{peak:.2f} GiB ({before:.2f} GiB allocated before); {_busy_line(*busy, step_ms)}")
    # TF32 allowed by the caller: the f32 route pins its products, forward
    # and backward, so the value and gradient are the same bits
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        v_t, g_t, _ = _value_and_grad(torch, model, p0, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_equal = bool(torch.equal(v_t, v) and torch.equal(g_t, g))
    _log(f"  18 atoms with allow_tf32 = True: value and gradient equal bit for bit: {tf32_equal}")
    if not tf32_equal:
        raise RuntimeError(f"18 atoms: TF32 changed the f32 route: |dv| "
                           f"{abs(float(v_t - v)):.3e}, max|dg| {float((g_t - g).abs().max()):.3e}")
    # checkpointed integration
    remat_model, _ = _bench_model(torch, device, fused=None, n_qubits=n, remat=True)
    v_r, g_r, _, _, remat_ms, remat_peak, _ = _timed_value_and_grad(torch, remat_model, p0,
                                                                    device)
    dv_r, dg_r = abs(float(v_r - v)), float((g_r - g).abs().max())
    _log(f"  18 atoms remat=True: {remat_ms:.1f} ms (once, warm), peak {remat_peak:.2f} GiB; "
         f"|dv| {dv_r:.3e}, max|dg| {dg_r:.3e} from the default")
    if dv_r > 1e-6 * abs(float(v)) or dg_r > 1e-6 * float(g.abs().max()):
        raise RuntimeError(f"18 atoms: remat=True moved the result: {dv_r:.3e} / {dg_r:.3e}")
    del remat_model
    # the f64 oracle
    f64_model, _ = _bench_model(torch, device, fused=False, n_qubits=n)
    v64, g64, _, _, f64_ms, f64_peak, _ = _timed_value_and_grad(torch, f64_model, p0, device)
    del f64_model
    dv, dg = abs(float(v) - float(v64)), float((g - g64).abs().max())
    _log(f"  18 atoms f64 stepper value+grad {f64_ms:.1f} ms (once), peak {f64_peak:.2f} GiB")
    _log(f"  18 atoms f32 route: value {float(v)!r}  f64 {float(v64)!r}  |dv| {dv:.3e} "
         f"(tol {F32_VALUE_TOL:.0e}); max|dg| {dg:.3e} (tol {F32_GRAD_TOL:.0e})")
    if dv > F32_VALUE_TOL or dg > F32_GRAD_TOL:
        raise RuntimeError(f"18 atoms: f32 route vs f64 stepper: |dv| {dv:.3e}, |dg| {dg:.3e}")
    # K4/K5 forced (fused=True): kernels against their plain versions at
    # these shapes, then the step through QuantumModel
    k_model, _ = _bench_model(torch, device, fused=True, n_qubits=n)
    with torch.no_grad():
        sim = k_model._make_emulator(dict(k_model.params))
    d18, _, _, _ = _kernel_inputs(torch, sim, k_model._default_substeps(), device)
    del sim
    times = {}
    k4_err, k5_err, _, k5_in = _check_ckpt(torch, fe, d18, "DP5", gen, "18 atoms", times)
    plans = _ckpt_plans(torch, fe, d18, "18 atoms")
    v_k, g_k, _, k_launches, k_first, k_peak, _ = _timed_value_and_grad(torch, k_model, p0, device)
    if k_launches != {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 1, "fused_bwd_ckpt": 1}:
        raise RuntimeError(f"18 atoms fused=True: launches {k_launches}")
    k_step_ms, _ = _host_time_ms(torch, lambda: _value_and_grad(torch, k_model, p0, device), 3)
    k_busy = _device_busy_ms(torch, lambda: _value_and_grad(torch, k_model, p0, device))
    n_k = 3
    k4_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(d18, "DP5"), n_k)
    k5_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd_ckpt(d18, "DP5", *k5_in), n_k)
    k5_out = fe.fused_bwd_ckpt(d18, "DP5", *k5_in)
    k4_bound, k4_by = _bound_ms(fe, d18, None, k5_in[:2], 6, "fwd_ckpt")
    k5_bound, k5_by = _bound_ms(fe, d18, None, (*k5_in, *k5_out), 6, "bwd_ckpt")
    R, _, _, _, nb, da, db = fe._dims(d18)
    rounds = {name: -(-fe.ckpt_plan(bwd, R, nb, da, db, 0, 6, plans[name]["sms"])["jobs_max"]
                      // plans[name]["blocks"]) for bwd, name in ((False, "K4"), (True, "K5"))}
    _log(f"  18 atoms fused=True: launches {k_launches}, value+grad {k_step_ms:.2f} ms warm "
         f"median of 3 (first {k_first:.1f} ms), peak {k_peak:.2f} GiB, n_steps "
         f"{int(d18['hs'].shape[0])}; K4 {k4_ms:.3f} ms (plain {times['k4_plain']:.1f} ms once, "
         f"bound {k4_bound:.4f} ms by {k4_by}), K5 {k5_ms:.3f} ms (plain "
         f"{times['k5_plain']:.1f} ms once, bound {k5_bound:.4f} ms by {k5_by}); rounds of the "
         f"largest phase on {plans['K4']['sms']} SMs: {rounds}; {_busy_line(*k_busy, k_step_ms)}")
    _hold_against_f64(torch, v_k, g_k, v64, g64, "18 atoms fused=True (K4/K5)")
    del k_model
    k4_entry = dict(launches=k_launches["fused_fwd_ckpt"], err=k4_err, ms=k4_ms,
                    plain_ms=times["k4_plain"], bound=k4_bound, by=k4_by)
    k5_entry = dict(launches=k_launches["fused_bwd_ckpt"], err=k5_err, ms=k5_ms,
                    plain_ms=times["k5_plain"], bound=k5_bound, by=k5_by)
    del d18, k5_in, k5_out
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "f64_ms": f64_ms, "dv": dv, "dg": dg, "K4": k4_entry,
            "K5": k5_entry}


def _population_inputs(torch, fe, model, cands, device):
    """The fused kernels' inputs for the candidates on the runs axis, as
    expectation_population_fn stages them."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.solvers import TimeGrid

    with torch.no_grad():
        sims = [model._make_emulator({"amp_samples_0": torch.as_tensor(c, device=device)})
                for c in cands]
        h = sims[0]._hamiltonian
        da, db = h.dim**h._a, h.dim**h._b
        grid = TimeGrid.make(h.sampling_times, sims[0]._eval_times_array, device).refined(
            model._default_substeps())
        psi0 = sims[0].initial_state
        p = Cplx(psi0.re.T.reshape(1, da, db), psi0.im.T.reshape(1, da, db))
        data = fe.prepare_mc_inputs([s._hamiltonian._ham_data for s in sims], p, grid.times,
                                    "DP5")
    data = {k: v.detach().contiguous() for k, v in data.items()}
    slots = torch.as_tensor(np.asarray(grid.write_slots, np.int32), device=device)
    return data, slots, grid.n_eval, int(grid.write_slots[-1])


def _population_phase(torch, fe, device, p0, gen, n_qubits: int, n_pop: int):
    """bench_population.py's step: n_pop candidates' summed loss, value and
    gradient through expectation_population_fn (default routing), counts
    reset just before and read just after (one forward and one adjoint
    launch with the candidates on the runs axis), each candidate held
    against its own R = 1 step; the kernels at these R-run shapes against
    their plain versions; the population step against n_pop sequential
    steps."""
    ckpt = n_qubits >= 14
    label = f"population {n_qubits} atoms P={n_pop}"
    model, _ = _bench_model(torch, device, fused=None, n_qubits=n_qubits)
    rng = np.random.default_rng(SEED)
    cands = p0[None, :] + POP_SPREAD * rng.normal(size=(n_pop, N_PARAMS))
    pfn = model.expectation_population_fn()

    def pop_step():
        stack = torch.tensor(cands, dtype=torch.float64, device=device, requires_grad=True)
        _, vals = pfn({"amp_samples_0": stack})
        vals[:, -1].sum().backward()
        return vals.detach(), stack.grad.detach()

    (vals, grads), launches, first_ms = _counted(torch, fe, label, pop_step,
                                                 K4K5 if ckpt else K1K2)
    if vals.shape != (n_pop, 2) or not (torch.isfinite(vals).all() and torch.isfinite(grads).all()):
        raise RuntimeError(f"{label}: bad output: values {vals}, grads {grads}")
    # each candidate against its own step (R = 1)
    dv_max = dg_max = 0.0
    for i, c in enumerate(cands):
        v1, g1, _ = _value_and_grad(torch, model, c, device)
        dv = abs(float(vals[i, -1]) - float(v1))
        dg = float((grads[i] - g1).abs().max() / g1.abs().max())
        dv_max, dg_max = max(dv_max, dv), max(dg_max, dg)
    _log(f"  {label}: launches {launches}; against each candidate's R = 1 step: max|dv| "
         f"{dv_max:.3e}, max relative |dg| {dg_max:.3e}")
    if dv_max != 0.0 or dg_max > (POP_CKPT_GRAD_REL if ckpt else 0.0):
        raise RuntimeError(f"{label}: a candidate differs from its R = 1 step: |dv| {dv_max:.3e}, "
                           f"relative |dg| {dg_max:.3e}")
    pop_ms, _ = _host_time_ms(torch, pop_step, 3)
    seq_ms, _ = _host_time_ms(
        torch, lambda: [_value_and_grad(torch, model, c, device) for c in cands], 3)
    _log(f"  {label}: population step {pop_ms:.2f} ms, {n_pop} sequential steps {seq_ms:.2f} ms "
         f"(warm medians of 3, first population step {first_ms:.1f} ms)")
    # the kernels at the R-run shapes, and at R = 1 (run 0's inputs); the
    # plain versions on the first PLAIN_STEPS steps (seconds a step at R > 1)
    data, slots, n_eval, last_slot = _population_inputs(torch, fe, model, cands, device)
    shared = ("rp", "cp", "hb_hi", "hb_lo", "hs")
    one = {k: v if k in shared else v[:1] for k, v in data.items()}
    ks, k_in = _held_kernels(torch, fe, data, slots, n_eval, last_slot, gen, label, ckpt,
                             n=PLAIN_STEPS, reps=5)
    in1 = [t[:1].contiguous() for t in k_in]
    if ckpt:
        plans = _ckpt_plans(torch, fe, data, label)
        fwd1_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(one, "DP5"), 5)
        bwd1_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd_ckpt(one, "DP5", *in1), 5)
        _log(f"  {label}: K4 plan {plans['K4']['blocks']} blocks, tile {plans['K4']['tile']}; "
             f"K5 {plans['K5']['blocks']} blocks, tile {plans['K5']['tile']}")
        names = ("K4", "K5")
    else:
        plan = _log_plan(fe, fe._library(), data, "DP5", label)
        resident = {name: fe.resident_clusters(data, "DP5", bwd)
                    for bwd, name in ((False, "K1"), (True, "K2"))}
        fwd1_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd(one, "DP5", slots, n_eval), 5)
        bwd1_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd(one, "DP5", slots, n_eval, last_slot,
                                                            *in1), 5)
        _log(f"  {label}: {n_pop} clusters of C = {plan['K1']['C']} blocks; resident at once "
             f"{resident} clusters, so {-(-n_pop // resident['K1'])} / "
             f"{-(-n_pop // resident['K2'])} waves")
        names = ("K1", "K2")
    fwd, bwd = ks[names[0]], ks[names[1]]
    _log(f"  {label}: {names[0]}/{names[1]} at R = {n_pop} {fwd['ms']:.3f} / {bwd['ms']:.3f} ms, "
         f"at R = 1 {fwd1_ms:.3f} / {bwd1_ms:.3f} ms (CUDA events, warm medians of 5); bounds "
         f"at R = {n_pop} {fwd['bound']:.4f} ms by {fwd['by']} / {bwd['bound']:.4f} ms by "
         f"{bwd['by']}")
    del data, k_in, in1, one, model
    torch.cuda.empty_cache()
    counts = ("fused_fwd_ckpt", "fused_bwd_ckpt") if ckpt else ("fused_fwd", "fused_bwd")
    return [dict(e, launches=launches[c]) for e, c in zip((fwd, bwd), counts)]


def _xy_ckpt_phase(torch, fe, device, n: int):
    """bench_xy.py's step at ``n`` atoms (14: K = 9 kron pairs, 16: K = 10):
    the default routing takes K4/K5 with kron pairs (K1/K2's clusters
    refuse the shape); value, gradient and q1's coordinate gradient
    against the f64 stepper at the BASELINE bars; the step's and the
    kernels' times and bounds."""
    label = f"{n} atoms XY"
    model, c1 = _xy_model(torch, device, fused=None, n_qubits=n)
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value, grad, cgrad, vals = _xy_value_and_grad(torch, model, c1, device)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fe.LAUNCHES)
    if launches != {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 1, "fused_bwd_ckpt": 1}:
        raise RuntimeError(f"{label}: expected one K4 and one K5 launch, got {launches}")
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(grad).all()
                                  and torch.isfinite(cgrad).all()):
        raise RuntimeError(f"{label}: bad output: values {vals}, grad {grad}, coords {cgrad}")
    step_ms, _ = _host_time_ms(torch, lambda: _xy_value_and_grad(torch, model, c1, device), 3)
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    data, _, _, _ = _kernel_inputs(torch, sim, model._default_substeps(), device)
    K = fe._n_kron(data)
    k4_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(data, "DP5", lo=True), 3)
    st = fe.fused_fwd_ckpt(data, "DP5", lo=True)
    lam = [torch.randn(tuple(st[0].shape), generator=torch.Generator().manual_seed(SEED),
                       dtype=torch.float32).to(device) for _ in range(2)]
    k5_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd_ckpt(data, "DP5", st[0], st[1], *lam), 3)
    plans = _ckpt_plans(torch, fe, data, label)
    k5_out = fe.fused_bwd_ckpt(data, "DP5", st[0], st[1], *lam)
    k4_bound, k4_by = _bound_ms(fe, data, None, st, 6, "fwd_ckpt")
    k5_bound, k5_by = _bound_ms(fe, data, None, (st[0], st[1], *lam, *k5_out), 6, "bwd_ckpt")
    del sim, st, lam, k5_out
    f64_model, c1 = _xy_model(torch, device, fused=False, n_qubits=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v64, g64, c64, _ = _xy_value_and_grad(torch, f64_model, c1, device)
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t0) * 1e3
    del f64_model
    dv, dg, dc = (abs(float(value) - float(v64)), float((grad - g64).abs().max()),
                  float((cgrad - c64).abs().max()))
    _log(f"  {label} (K = {K}): launches {launches}; value+grad {step_ms:.2f} ms warm median "
         f"of 3 (first {first_ms:.1f} ms), K4 {k4_ms:.3f} ms (bound {k4_bound:.4f} ms by "
         f"{k4_by}), K5 {k5_ms:.3f} ms (bound {k5_bound:.4f} ms by {k5_by}) (CUDA events, "
         f"{plans['K4']['blocks']} / {plans['K5']['blocks']} blocks); f64 stepper {f64_ms:.1f} ms")
    _log(f"  {label}: value {float(value)!r}  f64 {float(v64)!r}  |dv| {dv:.3e} (tol "
         f"{VALUE_TOL:.0e}); max|dg| {dg:.3e}, max|dc| {dc:.3e} (tol {GRAD_TOL:.0e}), "
         f"max|coordinate grad| {float(cgrad.abs().max()):.6e}")
    if dv > VALUE_TOL or dg > GRAD_TOL or dc > GRAD_TOL:
        raise RuntimeError(f"{label}: K4/K5 vs f64 stepper: |dv| {dv:.3e}, |dg| {dg:.3e}, "
                           f"|dc| {dc:.3e}")
    del model, data
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "k4_ms": k4_ms, "k5_ms": k5_ms, "dv": dv, "dg": dg, "dc": dc}


# the noisy Monte-Carlo batch of bench_mc.py: bench.py's sequence with a
# concrete amplitude, doppler + amplitude noise (50 uK, amp_sigma 0.05, the
# default 175 um laser waist): one amplitude and one detuning stream per
# qubit, so pr = pc = 2 ceil(n / 2) parts a side (12 at 12 atoms)
MC_RUNS = (1, 8, 32)
MC_SAMPLES = 5
MC_16 = 8
MC_18 = 2
# the sampler's statistics: samples a run, and the bar in standard errors
MC_STAT_SAMPLES = 20000
MC_STAT_SE = 5.0
# the steps of the wide-part adjoint checks
WIDE_STEPS = 8
K1_ONLY = {"fused_fwd": 1, "fused_bwd": 0, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}
K4_ONLY = {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 1, "fused_bwd_ckpt": 0}


def _mc_sim(torch, device, n_qubits: int, runs: int, noise=("doppler", "amplitude"), **cfg):
    """bench_mc.py's emulator at ``n_qubits`` atoms with ``runs`` runs."""
    from pulser_diff_torch import SimConfig, TorchEmulator
    from pulser_diff_torch.core import (
        ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    coords = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(n_qubits)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    amp = _interpolate_sine_np(N_PARAMS, DURATION) @ np.linspace(1.0, 3.0, N_PARAMS)
    seq.add(Pulse(CustomWaveform(amp), ConstantWaveform(DURATION, DET0), 0.0), "ryd")
    sim = TorchEmulator.from_sequence(seq, sampling_rate=SAMPLING_RATE,
                                      evaluation_times="Minimal", device=device)
    sim.set_config(SimConfig(noise=noise, runs=runs, samples_per_run=MC_SAMPLES,
                             temperature=50.0, amp_sigma=0.05, **cfg))
    return sim


def _mc_run(torch, fe, sim, label: str, want: dict):
    """One run() with the counts reset just before and read just after:
    exactly the launches ``want``; every time's counts sum to runs x
    samples_per_run and results[-1] to 1 (bench_mc.py's check).  Returns
    (results, host ms, launches)."""
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fe.LAUNCHES)
    if launches != want:
        raise RuntimeError(f"{label}: run() launched {launches}, expected {want}")
    cfg = sim._hamiltonian.config
    totals = {sum(r.bitstring_counts.values()) for r in res}
    if totals != {cfg.runs * cfg.samples_per_run}:
        raise RuntimeError(f"{label}: counts a time {totals}, expected "
                           f"{cfg.runs * cfg.samples_per_run}")
    final = sum(res.results[-1].values())
    if abs(final - 1.0) > 1e-6:
        raise RuntimeError(f"{label}: results[-1] sums to {final!r}")
    return res, ms, launches


def _mc_batch(torch, fe, sim, device):
    """A batch as run() draws, builds and stages it: the Hamiltonians, the
    coarse grid and substeps, the kernels' inputs on the runs axis."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.solvers import TimeGrid

    h = sim._hamiltonian
    draws, _, varying = sim._draw_batch(False)
    hams = h.build_batch(draws, varying)
    substeps = sim._auto_substeps({})
    grid = TimeGrid.make(h.sampling_times, sim._eval_times_array, device)
    fine = grid.refined(substeps)
    da, db = h.dim**h._a, h.dim**h._b
    psi0 = sim.initial_state
    p = Cplx(psi0.re.T.reshape(1, da, db), psi0.im.T.reshape(1, da, db))
    with torch.no_grad():
        data = fe.prepare_mc_inputs(hams, p, fine.times, "DP5")
    data = {k: v.contiguous() for k, v in data.items()}
    slots = torch.as_tensor(np.asarray(fine.write_slots, np.int32), device=device)
    return {"hams": hams, "grid": grid, "substeps": substeps, "data": data, "slots": slots,
            "n_eval": fine.n_eval, "last_slot": int(fine.write_slots[-1])}


def _runs_of(data, idx):
    """The inputs of the runs ``idx`` alone."""
    shared = ("rp", "cp", "hb_hi", "hb_lo", "hs")
    return {k: v if k in shared else v[idx].contiguous() for k, v in data.items()}


def _mc_vs_f64(torch, sim, b, states, runs, label: str) -> float:
    """The final states of ``runs`` (the batch's run() solve) against the
    f64 stepper on the same Hamiltonians, at the BASELINE state bar."""
    err = 0.0
    for r in runs:
        with torch.no_grad():
            ref = sim._solve_states(b["hams"][r], "DP5_SE", b["substeps"], b["grid"],
                                    {"fused": False})
        err = max(err, _max_err(states.re[r, -1], ref.re[-1]), _max_err(states.im[r, -1],
                                                                         ref.im[-1]))
    _log(f"  {label}: final states of runs {list(runs)} against the f64 stepper max|diff| "
         f"{err:.3e} (tol {VALUE_TOL:.0e})")
    if err > VALUE_TOL:
        raise RuntimeError(f"{label}: final states vs f64 {err:.3e} > {VALUE_TOL:.0e}")
    return err


def _bit_marginals(n: int, w):
    """(n,) probability of each bit being 1 under the (K,) weights w; bit
    j of a sample index is qubit n - 1 - j of its bitstring."""
    import torch

    idx = torch.arange(w.shape[-1], device=w.device)
    return torch.stack([(w * ((idx >> j) & 1)).sum(-1) for j in range(n)], -1)


def _sampler_check(torch, sim, weights, eps: float, eps_p: float, label: str) -> float:
    """Draw MC_STAT_SAMPLES a run with _device_sample_counts and hold each
    bit's marginal within MC_STAT_SE standard errors of the exact
    mixture's (flipped by eps / eps_p); returns the largest z score."""
    from pulser_diff_torch.backend import _device_sample_counts

    R, n_eval, K = weights.shape
    n = sim._hamiltonian._size
    n_per_run = torch.full((R,), MC_STAT_SAMPLES, dtype=torch.int64, device=weights.device)
    counts = _device_sample_counts(weights, n_per_run, MC_STAT_SAMPLES, sim._generator(), n,
                                   eps, eps_p).double()
    total = R * MC_STAT_SAMPLES
    if not torch.equal(counts.sum(-1), torch.full((n_eval,), float(total), device=counts.device,
                                                  dtype=counts.dtype)):
        raise RuntimeError(f"{label}: counts a time {counts.sum(-1).tolist()} != {total}")
    exact = _bit_marginals(n, weights).mean(0)  # (n_eval, n)
    exact = exact * (1 - eps_p) + (1 - exact) * eps
    got = _bit_marginals(n, counts / total)
    se = torch.sqrt(exact * (1 - exact) / total).clamp(min=1.0 / total)
    z = float(((got - exact).abs() / se).max())
    _log(f"  {label}: {total} draws a time, bit marginals within {z:.2f} standard errors of "
         f"the exact mixture's (bar {MC_STAT_SE}); largest marginal {float(exact.max()):.4e}")
    if z > MC_STAT_SE:
        raise RuntimeError(f"{label}: a bit marginal is {z:.2f} standard errors off")
    return z


def _widen_parts(torch, fe, data, P: int, seed: int):
    """``data`` with P synthetic row and column parts a side (random
    matrices, whose symmetric and antisymmetric halves the kernels form)
    and seeded stream words for them."""
    g = torch.Generator().manual_seed(seed)
    out = dict(data)
    R, n_steps, S = (int(v) for v in data["zrh_re"].shape[:3])
    dev = data["rp"].device
    for key, d in (("rp", int(data["rp"].shape[-1])), ("cp", int(data["cp"].shape[-1]))):
        out[key] = (torch.randn((P, d, d), generator=g) / (2 * P**0.5)).to(dev).contiguous()
    for key in fe._ZF_KEYS + fe._ZB_KEYS:
        scale = 1e-8 if key[2] == "l" else 1.0
        out[key] = (scale * torch.randn((R, n_steps, S, P), generator=g)).to(dev).contiguous()
    return out


def _wide_parts_checks(torch, fe, device, gen):
    """Synthetic pr = pc = 12 and 20 at the small shapes (da = db = 4 and
    16, two runs): K1 against its plain version, K4 equal to K1 bit for
    bit at every slot, and on the first WIDE_STEPS steps K1, K2, K4 and K5
    against their plain versions (the adjoints reduce their partials in
    chunks of 8 parts: two and three chunks here); every kernel refuses 33
    parts with the host's ValueError before any launch.  The adjoints'
    random cotangents come from their own generator, so ``gen`` keeps its
    draws."""
    cases = [c for c in _small_cases(torch, device)]
    base = []
    for label, sim, method in cases[2:]:
        base.append((label, _kernel_inputs(torch, sim, 1, device, method), method))
    model, _ = _bench_model(torch, device, fused=None, n_qubits=8, duration=200)
    with torch.no_grad():
        sim8 = model._make_emulator(dict(model.params))
    base.append(("8 atoms", _kernel_inputs(torch, sim8, 1, device), "DP5"))
    for label, (sd, ss, sn, sl), method in base:
        for P in (12, 20):
            wd = _widen_parts(torch, fe, _two_runs(torch, fe, sd), P, seed=P)
            tag = f"{label} R=2 pr=pc={P}"
            outs = fe.fused_fwd(wd, method, ss, sn)
            refs = fe.fused_fwd_plain(wd, method, ss, sn)
            err = max(_max_err(o, w) for o, w in zip(outs, refs))
            ck = fe.fused_fwd_ckpt(wd, method)
            g_of = {int(s): g for g, s in enumerate(ss.tolist()) if s < sn}
            diff = max(_max_err(c[:, g - 1], o[:, s]) for c, o in zip(ck, outs)
                       for s, g in g_of.items() if g > 0)
            _log(f"  {tag}: K1 vs plain max|err| {err:.3e} (tol {K1_TOL:.0e}), K4 vs K1 "
                 f"max|diff| {diff:.3e}")
            if err > K1_TOL or diff != 0.0:
                raise RuntimeError(f"{tag}: K1 vs plain {err:.3e}, K4 vs K1 {diff:.3e}")
            # the adjoints against their plain versions on the first steps
            # (the plain versions' Python loops over 2P parts a stage take
            # seconds a step); the slots of a two-time grid
            n = min(WIDE_STEPS, int(wd["hs"].shape[0]))
            cut = _cut_steps(wd, n)
            cslots = torch.tensor([0] + [2] * (n - 1) + [1], dtype=torch.int32, device=device)
            wgen = torch.Generator().manual_seed(SEED + P)
            _check_kernels(torch, fe, cut, cslots, 2, 1, method, wgen, f"{tag}, first {n} steps")
            _check_ckpt(torch, fe, cut, method, wgen, f"{tag}, first {n} steps")
    sd, ss, sn, sl = base[0][1]
    method = base[0][2]
    wd = _widen_parts(torch, fe, sd, 33, seed=33)
    zero = torch.zeros((1, sn, *sd["psi_re"].shape[1:]), dtype=torch.float32, device=device)
    zero_ck = torch.zeros((1, int(sd["hs"].shape[0]), *sd["psi_re"].shape[1:]),
                          dtype=torch.float32, device=device)
    for name, call in (("K1", lambda: fe.fused_fwd(wd, method, ss, sn)),
                       ("K2", lambda: fe.fused_bwd(wd, method, ss, sn, sl, *[zero] * 4)),
                       ("K4", lambda: fe.fused_fwd_ckpt(wd, method)),
                       ("K5", lambda: fe.fused_bwd_ckpt(wd, method, *[zero_ck] * 4))):
        _reset(fe)
        try:
            call()
        except ValueError as exc:
            if "at most 32" not in str(exc) or any(fe.LAUNCHES.values()):
                raise
            _log(f"  33 parts: {name} refused before any launch: {exc}")
        else:
            raise RuntimeError(f"{name} accepted 33 parts")


def _mc_phase(torch, fe, device, gen):
    """Phase 11, the noisy Monte-Carlo batch of bench_mc.py through
    TorchEmulator.run(): its launches, counts and timings at 12 atoms R =
    1, 8, 32 (K1), 16 atoms R = 8 and 18 atoms R = 2 (K4); the kernels at
    these shapes against their plain versions and the runs against the f64
    stepper; K4 = K1 at 12 parts; the wide-part shapes and the adjoint's
    refusal; SPAM; the sampler's statistics."""
    out = {"run_ms": {}, "kernels": []}
    S = 6
    for R in MC_RUNS:
        label = f"12 atoms R={R}"
        sim = _mc_sim(torch, device, 12, R)
        _, first_ms, run_launches = _mc_run(torch, fe, sim, label, K1_ONLY)
        run_ms, _ = _host_time_ms(torch, sim.run, 3)
        out["run_ms"][R] = run_ms
        b = _mc_batch(torch, fe, sim, device)
        d = b["data"]
        R_, n_steps, pr, pc, nb, da, db = fe._dims(d)
        _log(f"  {label}: run() {run_ms:.2f} ms warm median of 3 ({run_ms / R:.2f} ms a run; "
             f"first {first_ms:.1f} ms), pr = pc = {pr}, {n_steps} steps, substeps "
             f"{b['substeps']}")
        if R == 1:
            continue
        _reset(fe)
        states = sim._solve_batch(b["hams"], "DP5_SE", b["substeps"], b["grid"], {})
        launches = dict(fe.LAUNCHES)
        k1_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd(d, "DP5", b["slots"], b["n_eval"]), 5)
        k1_out = fe.fused_fwd(d, "DP5", b["slots"], b["n_eval"])
        bound, by = _bound_ms(fe, d, b["slots"], k1_out, S, "fwd")
        resident = fe.resident_clusters(d, "DP5", False)
        # the plain version on the first runs (two at R = 8, one at R = 32):
        # a Python loop of small launches, ~seconds a run at 12 parts
        n_plain = 2 if R == MC_RUNS[1] else 1
        plain_ms, refs = _host_time_ms(torch, lambda: fe.fused_fwd_plain(
            _runs_of(d, slice(0, n_plain)), "DP5", b["slots"], b["n_eval"]), 1)
        err = max(_max_err(o[:n_plain], w) for o, w in zip(k1_out, refs))
        _log(f"  {label}: K1 vs plain on {n_plain} run(s) max|err| {err:.3e} (tol "
             f"{K1_TOL:.0e}; plain {plain_ms:.1f} ms)")
        if err > K1_TOL:
            raise RuntimeError(f"{label}: K1 vs plain {err:.3e}")
        entry = dict(launches=run_launches["fused_fwd"], ms=k1_ms, bound=bound, by=by, err=err,
                     plain_ms=plain_ms, plain_runs=n_plain)
        if R == MC_RUNS[1]:
            _mc_vs_f64(torch, sim, b, states, (0, 1), label)
            ck = fe.fused_fwd_ckpt(d, "DP5")
            g_of = {int(s): g for g, s in enumerate(b["slots"].tolist()) if s < b["n_eval"]}
            diff = max(_max_err(c[:, g - 1], o[:, s]) for c, o in zip(ck, k1_out)
                       for s, g in g_of.items() if g > 0)
            _log(f"  {label}: K4 vs K1 at every slot of the {R} runs max|diff| {diff:.3e}")
            if diff != 0.0:
                raise RuntimeError(f"{label}: K4 differs from K1 by {diff:.3e}")
            del ck
            # the sampler on the card: the exact mixture's bit marginals
            weights = sim._batched_weights(states)
            _sampler_check(torch, sim, weights, 0.0, 0.0, f"{label} sampler")
            _sampler_check(torch, sim, weights, 0.1, 0.1, f"{label} sampler eps = eps' = 0.1")
        _log(f"  {label}: K1 {k1_ms:.3f} ms (CUDA events, warm median of 5; bound {bound:.4f} "
             f"ms by {by}), {R} clusters, {resident} resident at once, so "
             f"{-(-R // resident)} waves; run()'s launches {launches}")
        out["kernels"].append((f"fused_fwd_kernel (K1), noisy run() 12 atoms R = {R}, "
                               f"pr = pc = {pr}", "fused_evolution.cu", 594, entry))
        del sim, b, d, states, k1_out
        torch.cuda.empty_cache()
    # K4: 16 atoms R = 8, 18 atoms R = 2
    for n, R in ((16, MC_16), (18, MC_18)):
        label = f"{n} atoms R={R}"
        sim = _mc_sim(torch, device, n, R)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, first_ms, run_launches = _mc_run(torch, fe, sim, label, K4_ONLY)
        peak = _peak_gib(torch)
        run_ms, _ = _host_time_ms(torch, sim.run, 2)
        b = _mc_batch(torch, fe, sim, device)
        d = b["data"]
        _, n_steps, pr, pc, nb, da, db = fe._dims(d)
        _reset(fe)
        states = sim._solve_batch(b["hams"], "DP5_SE", b["substeps"], b["grid"], {})
        launches = dict(fe.LAUNCHES)
        if launches != K4_ONLY:
            raise RuntimeError(f"{label}: batch solve launched {launches}")
        _mc_vs_f64(torch, sim, b, states, (0,), label)
        del states
        one = _runs_of(d, slice(0, 1))
        k4_out = fe.fused_fwd_ckpt(d, "DP5")
        plain_ms, refs = _host_time_ms(torch, lambda: fe.fused_fwd_ckpt_plain(one, "DP5"), 1)
        err = max(_max_err(o[:1], w) for o, w in zip(k4_out, refs))
        del refs
        if err > K1_TOL:
            raise RuntimeError(f"{label}: K4 vs plain {err:.3e}")
        k4_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(d, "DP5"), 3)
        bound, by = _bound_ms(fe, d, None, k4_out, S, "fwd_ckpt")
        plan = fe.ckpt_device_plan(d, "DP5", False)
        _log(f"  {label}: pr = pc = {pr}, {n_steps} steps, substeps {b['substeps']}; run() "
             f"{run_ms:.2f} ms warm median of 2 ({run_ms / R:.2f} ms a run; first "
             f"{first_ms:.1f} ms), peak device memory {peak:.2f} GiB; K4 {k4_ms:.3f} ms (CUDA "
             f"events, warm median of 3; bound {bound:.4f} ms by {by}; {plan['blocks']} blocks, "
             f"tile {plan['tile']}), K4 vs plain on run 0 max|err| {err:.3e} (plain "
             f"{plain_ms:.1f} ms a run)")
        out["run_ms"][f"{n}x{R}"] = run_ms
        out["kernels"].append((f"fused_fwd_ckpt_kernel (K4), noisy run() {n} atoms R = {R}, "
                               f"pr = pc = {pr}", "fused_ckpt.cu", 1479,
                               dict(launches=run_launches["fused_fwd_ckpt"], err=err, ms=k4_ms,
                                    plain_ms=plain_ms, plain_runs=1, bound=bound, by=by)))
        del sim, b, d, one, k4_out
        torch.cuda.empty_cache()
    _wide_parts_checks(torch, fe, device, gen)
    # SPAM: the enumerated bad-atom configurations on K1, detection flips
    spam = _mc_sim(torch, device, 12, 15, noise=("SPAM",), eta=0.1, epsilon=0.01,
                   epsilon_prime=0.05)
    res, spam_ms, _ = _mc_run(torch, fe, spam, "12 atoms SPAM eta=0.1", K1_ONLY)
    _log(f"  12 atoms SPAM (eta 0.1, eps 0.01, eps' 0.05, 15 runs): {spam_ms:.1f} ms, "
         f"{len(res)} times, final counts {dict(res[-1].bitstring_counts.most_common(3))}")
    coh = _mc_sim(torch, device, 12, 15, noise=("SPAM",), eta=0.0, epsilon=0.01,
                  epsilon_prime=0.05)
    _reset(fe)
    cres = coh.run()
    launches = dict(fe.LAUNCHES)
    drawn = cres.sample_final_state(1000)
    if type(cres).__name__ != "CoherentResults" or launches != K1_ONLY or \
            sum(drawn.values()) != 1000:
        raise RuntimeError(f"12 atoms SPAM eta=0: {type(cres).__name__}, launches {launches}, "
                           f"{sum(drawn.values())} samples")
    _log(f"  12 atoms SPAM eta=0: CoherentResults, launches {launches}, sample_state(1000) "
         f"{dict(drawn.most_common(3))}")
    return out


# the Lindblad workload of bench_mesolve.py: a 4-wide lattice at 8 um,
# 400 ns (100 ns here: ME_DURATION), a 4-parameter sine-interpolated
# amplitude, detuning -1 rad/us,
# dephasing 0.05 rad/us, sampling_rate 0.5; the final total magnetization
# and its gradient in the 4 parameters
# phase 14, training: bench.py's loss (the final total magnetization), the
# noise of bench_mc.py on bench.py's model, the epochs of each fit, the
# duration model's starting duration (us), and the adjoint kernels' plain
# versions at the noisy shapes on a cut step count
TRAIN_NOISE = dict(noise=("doppler", "amplitude"), temperature=50.0, amp_sigma=0.05)
TRAIN_EPOCHS = 5
TRAIN_NOISY_EPOCHS = 3
DUR0 = 0.66
PLAIN_STEPS = 24
K1K2 = {"fused_fwd": 1, "fused_bwd": 1, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}
K4K5 = {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 1, "fused_bwd_ckpt": 1}


def _train_loss(times, vals):
    return vals[-1]


def _cut_steps(data, n: int, start: int = 0):
    """The kernels' inputs of the ``n`` steps from ``start`` (the first
    ``n`` by default; the checkpointed kernels store every step, so a
    window from elsewhere needs no slots)."""
    out = dict(data)
    for k in ("hb_hi", "hb_lo", "hs"):
        out[k] = data[k][start:start + n].contiguous()
    for k in data:
        if k.startswith("z"):
            out[k] = data[k][:, start:start + n].contiguous()
    return out


def _counted(torch, fe, label, fn, want: dict):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, held to ``want``: (result, launches, host ms)."""
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fe.LAUNCHES)
    if launches != want:
        raise RuntimeError(f"{label}: expected {want}, got {launches}")
    return res, launches, ms


def _held_kernels(torch, fe, data, slots, n_eval, last_slot, gen, label, ckpt: bool, *,
                  n=None, start: int = 0, reps: int = 3):
    """K1 and K2 (K4 and K5 with ``ckpt``) on ``data``: each against its
    plain version on the ``n`` steps from ``start`` (every step when ``n``
    is None), then timed on every step (CUDA events, warm median of
    ``reps``) with its bound.  Returns ({"K1": entry, "K2": entry} or K4 /
    K5, the adjoint's inputs); an entry holds err, ms, plain_ms, bound, by
    and plain_steps."""
    n_steps = fe._dims(data)[1]
    n = n_steps if n is None else min(n, n_steps)
    start = max(0, min(start, n_steps - n))
    lo, S, times = fe._n_kron(data) > 0, 6, {}
    win = data if n == n_steps else _cut_steps(data, n, start)
    tag = label if n == n_steps else f"{label} (steps {start}-{start + n - 1} of {n_steps})"
    if ckpt:
        errs = _check_ckpt(torch, fe, win, "DP5", gen, tag, times)[:2]
        fwd, bwd = (lambda: fe.fused_fwd_ckpt(data, "DP5", lo=lo)), fe.fused_bwd_ckpt
        names, kinds, bslots = ("K4", "K5"), ("fwd_ckpt", "bwd_ckpt"), None
        args = (data, "DP5")
    else:
        # the window's own slots: its first grid point's and the last one's
        cslots = slots if n == n_steps else torch.cat([slots[:n], slots[-1:]])
        errs = _check_kernels(torch, fe, win, cslots, n_eval, last_slot, "DP5", gen, tag,
                              times)[:2]
        fwd, bwd = (lambda: fe.fused_fwd(data, "DP5", slots, n_eval, lo=lo)), fe.fused_bwd
        names, kinds, bslots = ("K1", "K2"), ("fwd", "bwd"), slots
        args = (data, "DP5", slots, n_eval, last_slot)
    st = fwd()
    k_in = (st[0], st[1], *[torch.randn(tuple(st[0].shape), generator=gen,
                                        dtype=torch.float32).to(st[0].device) for _ in range(2)])
    outs = (st, (*k_in, *bwd(*args, *k_in)))
    fns = (fwd, lambda: bwd(*args, *k_in))
    entries = {}
    for i, name in enumerate(names):
        bound, by = _bound_ms(fe, data, bslots, outs[i], S, kinds[i])
        entries[name] = dict(err=errs[i], ms=_cuda_time_ms(torch, fns[i], reps),
                             plain_ms=times[f"k{name[1]}_plain"], bound=bound, by=by,
                             plain_steps=n)
    return entries, k_in


def _times(counts: dict, n: int) -> dict:
    """The launch counts of ``n`` steps of ``counts`` each."""
    return {k: v * n for k, v in counts.items()}


def _noisy_step(torch, fe, device, n_qubits: int, p0, gen, want: dict):
    """(a) / (b): bench.py's model at ``n_qubits`` with bench_mc.py's noise,
    one drawn realization pinned: the value+grad step through the default
    route (counts reset just before, read just after), held against the
    f64 stepper on the same draws; the adjoint kernel at these shapes
    against its plain version on the first PLAIN_STEPS steps, timed over
    all of them."""
    from pulser_diff_torch import SimConfig

    label = f"noisy {n_qubits} atoms"
    model, _ = _bench_model(torch, device, fused=None, n_qubits=n_qubits,
                            noise_config=SimConfig(**TRAIN_NOISE))
    draws = model._draw()
    with model._pinned(draws):
        substeps = model._default_substeps()
        with torch.no_grad():
            sim = model._make_emulator(dict(model.params))
        torch.cuda.reset_peak_memory_stats()
        (value, grad, vals), launches, first_ms = _counted(
            torch, fe, label, lambda: _value_and_grad(torch, model, p0, device), want)
        peak = _peak_gib(torch)
        step_ms, _ = _host_time_ms(torch, lambda: _value_and_grad(torch, model, p0, device), 3)
    f64, _ = _bench_model(torch, device, fused=False, n_qubits=n_qubits,
                          noise_config=SimConfig(**TRAIN_NOISE))
    with f64._pinned(draws):
        t0 = time.perf_counter()
        v64, g64, _ = _value_and_grad(torch, f64, p0, device)
        torch.cuda.synchronize()
        f64_ms = (time.perf_counter() - t0) * 1e3
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, substeps, device)
    R_, n_steps, pr, pc, nb, da, db = fe._dims(data)
    _log(f"  {label}: pr = pc = {pr}, {n_steps} steps, launches {launches}, step {step_ms:.2f} ms "
         f"warm median of 3 (first {first_ms:.1f} ms), peak {peak:.2f} GiB; f64 stepper "
         f"{f64_ms:.1f} ms (once)")
    _hold_against_f64(torch, value, grad, v64, g64, label)
    ckpt = bool(want["fused_bwd_ckpt"])
    ks, _ = _held_kernels(torch, fe, data, slots, n_eval, last_slot, gen, label, ckpt,
                          n=PLAIN_STEPS, reps=3 if ckpt else 5)
    kname, name = ("K5", "fused_bwd_ckpt") if ckpt else ("K2", "fused_bwd")
    e = ks[kname]
    _log(f"  {label}: {kname} at pr = pc = {pr} {e['ms']:.3f} ms (CUDA events, warm median), "
         f"bound {e['bound']:.4f} ms by {e['by']}; plain {e['plain_ms']:.1f} ms on the first "
         f"{PLAIN_STEPS} steps")
    del data, model, f64, sim
    torch.cuda.empty_cache()
    return dict(e, launches=launches[name], pr=pr, step_ms=step_ms)


def _chunk_cost(torch, fe, device, gen):
    """K2 at 7, 8 and 9 synthetic parts a side on the 12-atom main path's
    shapes (CUDA events, warm medians of 3): 8 to 9 parts adds a second
    chunk of stream cotangents, whose outer products K2 recomputes, beside
    one more part to assemble, which 7 to 8 parts adds alone."""
    model, _ = _bench_model(torch, device, fused=None)
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, model._default_substeps(), device)
    ms = {}
    for P in (7, 8, 9):
        wd = _widen_parts(torch, fe, data, P, seed=P)
        st = fe.fused_fwd(wd, "DP5", slots, n_eval)
        lam = [torch.randn(st[0].shape, generator=gen, dtype=torch.float32).to(device)
               for _ in range(2)]
        ms[P] = _cuda_time_ms(torch, lambda: fe.fused_bwd(wd, "DP5", slots, n_eval, last_slot,
                                                          *st, *lam), 3)
    second = (ms[9] - ms[8]) - (ms[8] - ms[7])
    _log(f"  (c) K2 at 7 / 8 / 9 synthetic parts, 12 atoms: {ms[7]:.3f} / {ms[8]:.3f} / "
         f"{ms[9]:.3f} ms; the second chunk's recomputed outer products ~{second:.3f} ms")
    return ms


def _fit_phase(torch, fe, device, p0):
    """(d) fit on bench.py's 12-atom model: TRAIN_EPOCHS epochs with the
    default optimiser, one K1 and one K2 launch an epoch, every epoch's
    loss equal bit for bit to a hand loop of expectation_fn and Adam;
    (e) fit_population with bench_population.py's 8 candidates: epochs + 1
    evaluations on the runs axis (one K1 launch each, one K2 launch each
    but the last), each candidate's losses against a lone fit from it."""
    model, _ = _bench_model(torch, device, fused=None)
    model._default_substeps()
    ends = []

    def stamp(*_):  # each epoch's end, on the host clock after its work
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = model.fit(_train_loss, epochs=TRAIN_EPOCHS, callback=stamp)
    launches = dict(fe.LAUNCHES)
    epochs_ms = np.diff([t0] + ends) * 1e3
    epoch_ms = float(np.median(epochs_ms[1:]))
    if launches != _times(K1K2, TRAIN_EPOCHS):
        raise RuntimeError(f"fit: launches {launches}")
    hand, _ = _bench_model(torch, device, fused=None)
    opt = torch.optim.Adam(hand.parameters(), lr=1e-2)
    want = []
    for _ in range(TRAIN_EPOCHS):
        opt.zero_grad()
        loss = _train_loss(*hand.expectation_fn()(dict(hand.params)))
        loss.backward()
        opt.step()
        want.append(float(loss.detach()))
    if losses != want:
        raise RuntimeError(f"fit: losses {losses} differ from the hand loop's {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"fit: losses {losses}")
    _log(f"  (d) fit, 12 atoms, {TRAIN_EPOCHS} epochs: launches {launches}, losses {losses!r} "
         f"(equal bit for bit to the hand loop's); epochs {epochs_ms.round(2).tolist()} ms (the "
         f"first one builds the optimiser's kernels), {epoch_ms:.2f} ms warm median")
    # (e) the population
    rng = np.random.default_rng(SEED)
    cands = p0[None, :] + POP_SPREAD * rng.normal(size=(POP_12, N_PARAMS))
    pmodel, _ = _bench_model(torch, device, fused=None)
    pmodel._default_substeps()
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plosses, final = pmodel.fit_population(_train_loss, {"amp_samples_0": cands},
                                           epochs=TRAIN_EPOCHS)
    torch.cuda.synchronize()
    pop_ms = (time.perf_counter() - t0) * 1e3
    plaunches = dict(fe.LAUNCHES)
    want_l = {"fused_fwd": TRAIN_EPOCHS + 1, "fused_bwd": TRAIN_EPOCHS, "fused_fwd_ckpt": 0,
              "fused_bwd_ckpt": 0}
    if plaunches != want_l:
        raise RuntimeError(f"fit_population: launches {plaunches}, expected {want_l}")
    diff = 0.0
    for i, c in enumerate(cands):
        lone, _ = _bench_model(torch, device, fused=None)
        with torch.no_grad():
            lone.params["amp_samples_0"].copy_(torch.as_tensor(c, device=device))
        ll = lone.fit(_train_loss, epochs=TRAIN_EPOCHS)
        diff = max(diff, max(abs(a - float(b[i])) for a, b in zip(ll, plosses)))
    best = min(float(x.min()) for x in plosses)
    _log(f"  (e) fit_population, 12 atoms, {POP_12} candidates, {TRAIN_EPOCHS} epochs: launches "
         f"{plaunches}, {pop_ms / (TRAIN_EPOCHS + 1):.2f} ms an evaluation ({pop_ms:.1f} ms in "
         f"all); each candidate's losses against a lone fit from it max|diff| {diff:.3e}; best "
         f"loss {best!r}")
    if diff > 1e-12:
        raise RuntimeError(f"fit_population: a candidate's losses differ from its lone fit by "
                           f"{diff:.3e}")
    return {"epoch_ms": epoch_ms, "pop_eval_ms": pop_ms / (TRAIN_EPOCHS + 1)}


def _duration_model(torch, device, **options):
    """(f) ConstantPulse(dur[0], 2 rad/us, -2 rad/us, 0) on bench.py's 3x4
    lattice at bench.py's sampling rate, the duration trainable from DUR0."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence

    coords = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(N_QUBITS)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    dur = seq.declare_variable("dur", dtype=int)
    seq.add(Pulse.ConstantPulse(dur[0], 2.0, DET0, 0.0), "ryd")
    return QuantumModel(seq, {"dur": np.array([DUR0])}, sampling_rate=SAMPLING_RATE,
                        evaluation_times="Minimal", device=device, **options)


def _duration_phase(torch, fe, device):
    """(f) the duration gradient against the f64 stepper's: on the default
    route (K1/K2), whose adjoint rebuilds each step's start state by
    reverse-time steps on the mirror nodes, as the JAX package's lean
    adjoint does, printed; with ckpt=True (K4/K5, the stored states) held
    at the bars.  Then TRAIN_NOISY_EPOCHS epochs of fit on the default
    route: the duration moves."""
    def vag(m, want):
        d = torch.tensor([DUR0], dtype=torch.float64, device=device, requires_grad=True)
        _reset(fe)
        value = m.expectation_fn()({"dur": d})[1][-1]
        value.backward()
        torch.cuda.synchronize()
        if dict(fe.LAUNCHES) != want:
            raise RuntimeError(f"duration step: launches {dict(fe.LAUNCHES)}, expected {want}")
        return value.detach(), d.grad.detach()

    model = _duration_model(torch, device)
    value, grad = vag(model, K1K2)
    v64, g64 = vag(_duration_model(torch, device, fused=False), NO_LAUNCH)
    vc, gc = vag(_duration_model(torch, device, ckpt=True), K4K5)
    _log(f"  (f) duration model: grid {model._t_max} ns, {DUR0} us; default route (K1/K2): "
         f"value {float(value)!r}, d/d(dur) {float(grad[0])!r}; f64 {float(v64)!r}, "
         f"{float(g64[0])!r}: |dv| {abs(float(value - v64)):.3e}, |dg| "
         f"{abs(float(grad[0] - g64[0])):.3e} (the gradient: the mirror-node reconstruction of "
         f"the lean adjoint at this sampling, not held; the value held at {VALUE_TOL:.0e})")
    if abs(float(value - v64)) > VALUE_TOL:
        raise RuntimeError(f"duration model: value vs f64 {abs(float(value - v64)):.3e}")
    _hold_against_f64(torch, vc, gc, v64, g64, "duration model, ckpt=True (K4/K5)")
    _reset(fe)
    losses = model.fit(_train_loss, epochs=TRAIN_NOISY_EPOCHS)
    launches = dict(fe.LAUNCHES)
    moved = float(model.params["dur"].detach()[0]) - DUR0
    _log(f"  (f) fit of the duration, {TRAIN_NOISY_EPOCHS} epochs: launches {launches}, losses "
         f"{losses!r}, the duration moved {moved:+.6f} us")
    if launches != _times(K1K2, TRAIN_NOISY_EPOCHS) or not abs(moved) > 0:
        raise RuntimeError(f"duration fit: launches {launches}, moved {moved}")


def _noisy_fit(torch, fe, device):
    """(g) fit on the noisy 12-atom model: TRAIN_NOISY_EPOCHS epochs, one
    drawn realization for all of them."""
    from pulser_diff_torch import SimConfig

    model, _ = _bench_model(torch, device, fused=None, noise_config=SimConfig(**TRAIN_NOISE))
    model._default_substeps()
    drawn = []
    draw = model._draw
    model._draw = lambda: drawn.append(1) or draw()
    _reset(fe)
    losses = model.fit(_train_loss, epochs=TRAIN_NOISY_EPOCHS)
    launches = dict(fe.LAUNCHES)
    _log(f"  (g) noisy fit, 12 atoms, {TRAIN_NOISY_EPOCHS} epochs: {len(drawn)} realization "
         f"drawn, launches {launches}, losses {losses!r}")
    if (len(drawn) != 1 or launches != _times(K1K2, TRAIN_NOISY_EPOCHS)
            or not all(np.isfinite(losses))):
        raise RuntimeError(f"noisy fit: {len(drawn)} draws, launches {launches}, losses {losses}")


def _training_phase(torch, fe, device, p0, gen):
    """Phase 14, training: (a) the noisy 12-atom model's value+grad (K1/K2
    at 12 parts a side), (b) the noisy 16-atom model's (K4/K5 at 16), both
    against the f64 stepper on the same draws; (c) synthetic 20 parts is
    phase 11's, and here K2's cost of a second chunk; (d) fit, (e)
    fit_population, (f) duration optimisation, (g) a noisy fit, all at 12
    atoms."""
    k2 = _noisy_step(torch, fe, device, 12, p0, gen, K1K2)
    k5 = _noisy_step(torch, fe, device, 16, p0, gen, K4K5)
    chunks = _chunk_cost(torch, fe, device, gen)
    fit = _fit_phase(torch, fe, device, p0)
    _duration_phase(torch, fe, device)
    _noisy_fit(torch, fe, device)
    return {"K2": k2, "K5": k5, "chunks": chunks, **fit}


# bench_mesolve.py's pulse runs 400 ns; phases 12 and 13 run it for 100 ns
# (51 steps), the depth cut that keeps the script inside its time limit
ME_DURATION = 100
ME_PARAMS = 4
ME_SPACING = 8.0
ME_DET0 = -1.0
ME_RATE = 0.05
ME_SAMPLING = 0.5
ME_P0 = np.linspace(1.0, 2.5, ME_PARAMS)
# phase 12's atom counts: the dense form (dim 1024), the superop form's
# rate gradient, the factored form's forward (dim 4096), the noisy batch
ME_DENSE_N = 10
ME_SUPEROP_N = 3
ME_FACTORED_N = 12
ME_BATCH_N = 8
ME_BATCH_R = 4
# the dense and the factored forms sum the same f64 terms in another
# order; the f32 ME stepper against f64 at the f32 stepper's bars
ME_FORM_VALUE_TOL = 1e-10
ME_FORM_GRAD_TOL = 1e-8
ME_TRACE_TOL = 1e-10
ME_FD_TOL = 1e-6
# bench_mcwf.py: the same pulse at 9 um, sampled a quarter of the grid
MCWF_SPACING = 9.0
MCWF_ANCHOR_R = 1024
MCWF_BIG_N = 12
MCWF_BIG_R = 64
# tests/test_mcwf.py::test_mcwf_gradient_matches_mesolve's model and bars
MCWF_GRAD_N = 10
MCWF_GRAD_R = 512
MCWF_VALUE_TOL = 0.05
MCWF_GRAD_REL = 0.02
NO_LAUNCH = {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}


def _me_sequence(n_qubits: int, spacing: float, amp_values=None):
    """bench_mesolve.py's sequence (bench_mcwf.py's at 9 um): the amplitude
    a declared variable, or the concrete values M @ ``amp_values``."""
    from pulser_diff_torch.core import (
        ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    coords = [(spacing * (i % 4), spacing * (i // 4)) for i in range(n_qubits)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    if amp_values is None:
        amp = CustomWaveform(seq.declare_variable("amp_samples", size=ME_DURATION),
                             duration=ME_DURATION)
    else:
        amp = CustomWaveform(_interpolate_sine_np(ME_PARAMS, ME_DURATION) @ amp_values)
    seq.add(Pulse(amp, ConstantWaveform(ME_DURATION, ME_DET0), 0.0), "ryd")
    return seq


def _me_model(torch, device, n_qubits: int, **options):
    """bench_mesolve.py's QuantumModel with dephasing at ``n_qubits`` atoms."""
    from pulser_diff_torch import QuantumModel, SimConfig
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    M = torch.as_tensor(_interpolate_sine_np(ME_PARAMS, ME_DURATION), device=device)
    return QuantumModel(
        _me_sequence(n_qubits, ME_SPACING), {"amp_samples": ((ME_P0,), lambda v: M @ v)},
        sampling_rate=ME_SAMPLING, noise_config=SimConfig(noise="dephasing",
                                                          dephasing_rate=ME_RATE),
        evaluation_times="Minimal", device=device, **options)


def _me_sim(torch, device, n_qubits: int, spacing: float = ME_SPACING,
            evaluation_times="Minimal", **cfg):
    """The emulator of bench_mesolve.py's pulse (amplitude at ME_P0) with
    the noise ``cfg`` (dephasing at ME_RATE unless given)."""
    from pulser_diff_torch import SimConfig, TorchEmulator

    cfg = {"noise": "dephasing", "dephasing_rate": ME_RATE, **cfg}
    return TorchEmulator.from_sequence(
        _me_sequence(n_qubits, spacing, ME_P0), sampling_rate=ME_SAMPLING,
        evaluation_times=evaluation_times, config=SimConfig(**cfg), device=device)


def _me_step(torch, model, device):
    """One value+grad of bench_mesolve.py's loss: (value, grad)."""
    p = torch.tensor(ME_P0, dtype=torch.float64, device=device, requires_grad=True)
    _, vals = model.expectation_fn()({"amp_samples_0": p})
    vals[-1].backward()
    return vals[-1].detach(), p.grad.detach()


def _no_launch(fe, label: str) -> None:
    """The Lindblad and MCWF paths reach no kernel, as in the JAX package."""
    if dict(fe.LAUNCHES) != NO_LAUNCH:
        raise RuntimeError(f"{label}: launched {dict(fe.LAUNCHES)}, expected no kernel")


def _rho_checks(torch, rho, label: str) -> tuple:
    """|tr rho - 1| and max |rho - rho^H| of a final density matrix, each
    within ME_TRACE_TOL."""
    from pulser_diff_torch.ops.linalg import trace

    tr = trace(rho)
    dtr = abs(complex(float(tr.re), float(tr.im)) - 1.0)
    herm = max(float((rho.re - rho.re.T).abs().max()), float((rho.im + rho.im.T).abs().max()))
    if dtr > ME_TRACE_TOL or herm > ME_TRACE_TOL:
        raise RuntimeError(f"{label}: |tr - 1| {dtr:.3e}, max|rho - rho^H| {herm:.3e}")
    return dtr, herm


def _lindblad_phase(torch, fe, device, n_dense: int = ME_DENSE_N, n_sup: int = ME_SUPEROP_N,
                    n_fac: int = ME_FACTORED_N, n_batch: int = ME_BATCH_N, n_warm: int = 1):
    """Phase 12, the Lindblad path of bench_mesolve.py: the value+grad step
    through QuantumModel (DP5_ME, the dense form at dim 1024) against the
    factored form and DP5_ME_F32, its final trace, time, peak and busy
    share; the dephasing-rate gradient against a central difference (the
    superop form); the factored form's 12-atom run() (trace, Hermiticity,
    time, peak); dephasing + doppler run() through one mesolve a run."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.solvers import solver as sv

    out = {}
    label = f"{n_dense} atoms DP5_ME"
    model = _me_model(torch, device, n_dense)
    h = model._make_emulator({"amp_samples_0": torch.as_tensor(ME_P0, device=device)})
    h = h._hamiltonian
    dim = h.dim**h._size
    n_steps = (len(h.sampling_times) + 2) * model._default_substeps()
    rho = Cplx(*(torch.empty(dim, dim, dtype=torch.float64, device=device) for _ in range(2)))
    form = sv.me_form_for(dim)
    _log(f"  {label}: dim {dim}, form {form}, {n_steps} steps (substeps "
         f"{model._default_substeps()}), remat {sv._me_auto_remat(form, dim, rho, n_steps)}, "
         f"segments {sv._auto_segments(rho, n_steps)}; rho {2 * dim * dim * 8 / 2**20:.0f} MiB")
    del rho
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(fe)
    t0 = time.perf_counter()
    value, grad = _me_step(torch, model, device)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    _no_launch(fe, label)
    peak = _peak_gib(torch)
    step_ms, _ = _host_time_ms(torch, lambda: _me_step(torch, model, device), n_warm)
    busy = _device_busy_ms(torch, lambda: _me_step(torch, model, device))
    _log(f"  {label}: value {float(value)!r}, grad {grad.cpu().numpy().tolist()!r}")
    _log(f"  {label}: step {step_ms:.1f} ms (warm median of {n_warm}; first {first_ms:.1f} ms), "
         f"peak device memory {peak:.2f} GiB; {_busy_line(*busy, step_ms)}")
    with torch.no_grad():
        _, states = model._states_fn({"amp_samples_0": torch.as_tensor(ME_P0, device=device)})
    dtr, herm = _rho_checks(torch, states[-1], label)
    _log(f"  {label}: final |tr rho - 1| {dtr:.3e}, max|rho - rho^H| {herm:.3e} (tol "
         f"{ME_TRACE_TOL:.0e})")
    del states
    out.update(dense_ms=step_ms, dense_peak=peak, dense_busy=busy[0])
    # the factored form on the same step
    fac = _me_model(torch, device, n_dense, me_form="factored")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fac_ms, (v_f, g_f) = _host_time_ms(torch, lambda: _me_step(torch, fac, device), 1)
    fac_peak = _peak_gib(torch)
    dv, dg = abs(float(value - v_f)), float((grad - g_f).abs().max())
    _log(f"  {label}: factored form step {fac_ms:.1f} ms (one run), peak {fac_peak:.2f} GiB; "
         f"|dvalue| {dv:.3e} (tol {ME_FORM_VALUE_TOL:.0e}), max|dgrad| {dg:.3e} (tol "
         f"{ME_FORM_GRAD_TOL:.0e})")
    if dv > ME_FORM_VALUE_TOL or dg > ME_FORM_GRAD_TOL:
        raise RuntimeError(f"{label}: dense vs factored |dv| {dv:.3e}, |dg| {dg:.3e}")
    out.update(factored_ms=fac_ms, factored_peak=fac_peak)
    del fac
    # DP5_ME_F32 against the f64 step
    f32 = _me_model(torch, device, n_dense, solver="DP5_ME_F32")
    _reset(fe)
    f32_ms, (v_32, g_32) = _host_time_ms(torch, lambda: _me_step(torch, f32, device), 1)
    _no_launch(fe, f"{label}_F32")
    dv, dg = abs(float(value - v_32)), float((grad - g_32).abs().max())
    _log(f"  {label}_F32: step {f32_ms:.1f} ms (one run); |dvalue| {dv:.3e} (tol "
         f"{F32_VALUE_TOL:.0e}), max|dgrad| {dg:.3e} (tol {F32_GRAD_TOL:.0e}) against f64")
    if dv > F32_VALUE_TOL or dg > F32_GRAD_TOL:
        raise RuntimeError(f"{label}_F32 vs f64: |dv| {dv:.3e}, |dg| {dg:.3e}")
    out["f32_ms"] = f32_ms
    del f32, model
    torch.cuda.empty_cache()

    # the dephasing-rate gradient (superop form) against a central difference
    from pulser_diff_torch.ops.linalg import total_magnetization

    obs = total_magnetization(n_sup, device=device)

    def final(rate):
        sim = _me_sim(torch, device, n_sup, dephasing_rate=rate)
        return sim.run().expect([obs])[0].re[-1]

    rate = torch.tensor(ME_RATE, dtype=torch.float64, device=device, requires_grad=True)
    _reset(fe)
    val = final(rate)
    val.backward()
    _no_launch(fe, f"{n_sup} atoms rate gradient")
    eps = 1e-4
    with torch.no_grad():
        fd = (float(final(ME_RATE + eps)) - float(final(ME_RATE - eps))) / (2 * eps)
    dgr = abs(float(rate.grad) - fd)
    _log(f"  {n_sup} atoms ({sv.me_form_for(2**n_sup)} form): d<Z>/d(dephasing_rate) "
         f"{float(rate.grad)!r}, central difference {fd!r}, |diff| {dgr:.3e} (tol "
         f"{ME_FD_TOL:.0e})")
    if dgr > ME_FD_TOL:
        raise RuntimeError(f"rate gradient vs central difference {dgr:.3e}")

    # 12 atoms: run() on the default route (the factored form), forward only
    label = f"{n_fac} atoms run()"
    sim = _me_sim(torch, device, n_fac)
    dim = 2**n_fac
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(fe)
    with torch.no_grad():
        fac_run_ms, res = _host_time_ms(torch, sim.run, 1)
    _no_launch(fe, label)
    peak = _peak_gib(torch)
    dtr, herm = _rho_checks(torch, res[-1].state, label)
    _log(f"  {label}: dim {dim}, form {sv.me_form_for(dim)}, rho {2 * dim * dim * 8 / 2**20:.0f}"
         f" MiB; {fac_run_ms:.1f} ms (one run), peak device memory {peak:.2f} GiB; final "
         f"|tr rho - 1| {dtr:.3e}, max|rho - rho^H| {herm:.3e} (tol {ME_TRACE_TOL:.0e})")
    out.update(factored12_ms=fac_run_ms, factored12_peak=peak)
    del sim, res
    torch.cuda.empty_cache()

    # dephasing + doppler: one mesolve a run (_solve_batch)
    label = f"{n_batch} atoms dephasing + doppler R={ME_BATCH_R}"
    sim = _me_sim(torch, device, n_batch, noise=("dephasing", "doppler"), temperature=50.0,
                  runs=ME_BATCH_R, samples_per_run=MC_SAMPLES)
    _reset(fe)
    with torch.no_grad():
        batch_ms, res = _host_time_ms(torch, sim.run, 1)
    _no_launch(fe, label)
    totals = {sum(r.bitstring_counts.values()) for r in res}
    if type(res).__name__ != "NoisyResults" or totals != {ME_BATCH_R * MC_SAMPLES}:
        raise RuntimeError(f"{label}: {type(res).__name__}, counts a time {totals}")
    _log(f"  {label}: NoisyResults, counts a time {totals}, {batch_ms:.1f} ms")
    out["batch_ms"] = batch_ms
    return out


def _mcwf_model(torch, device, n_qubits: int, solver: str, omega: float = 1.7,
                rate: float = 0.08, duration: int = 160):
    """tests/test_mcwf.py's gradient model: a line at 9 um, a constant
    pulse of trainable amplitude omega (detuning -0.6, phase 0.2), dephasing."""
    from pulser_diff_torch import QuantumModel, SimConfig
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence

    reg = Register.from_coordinates([(9.0 * i, 0.0) for i in range(n_qubits)], prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    om = seq.declare_variable("omega")
    seq.add(Pulse.ConstantPulse(duration, om, -0.6, 0.2), "ryd")
    return QuantumModel(seq, {"omega": omega}, noise_config=SimConfig(
        noise="dephasing", dephasing_rate=rate), solver=solver, evaluation_times="Minimal",
        device=device)


def _mcwf_phase(torch, fe, device, n_anchor: int = 3, n_big: int = MCWF_BIG_N,
                n_grad: int = MCWF_GRAD_N, anchor_r: int = MCWF_ANCHOR_R,
                big_r: int = MCWF_BIG_R, grad_r: int = MCWF_GRAD_R):
    """Phase 13, MCWF (bench_mcwf.py): the 3-atom populations of
    run(solver="MCWF", n_traj=1024) against DP5_ME within 4/sqrt(R); 12
    atoms MCWF_F32 at R = 64, timed; expectation_mcwf_fn's value and
    gradient against the DP5_ME model's at 10 atoms."""
    out = {}
    sim = _me_sim(torch, device, n_anchor, spacing=MCWF_SPACING, evaluation_times=0.25,
                  runs=anchor_r, samples_per_run=40)
    _reset(fe)
    me_ms, ref = _host_time_ms(torch, sim.run, 1)
    mc_ms, res = _host_time_ms(torch, lambda: sim.run(solver="MCWF", n_traj=anchor_r), 1)
    _no_launch(fe, f"{n_anchor} atoms MCWF")
    pop_me = torch.diagonal(ref.states.re, dim1=-2, dim2=-1).cpu()
    pop_mc = torch.diagonal(res.states.re, dim1=-2, dim2=-1).cpu()
    diff = float((pop_me - pop_mc).abs().max())
    bar = 4.0 / np.sqrt(anchor_r)
    _log(f"  {n_anchor} atoms: DP5_ME run() {me_ms:.1f} ms, MCWF run() R={anchor_r} "
         f"{mc_ms:.1f} ms; max|pop_MCWF - pop_ME| {diff:.4f} (tol 4/sqrt(R) = {bar:.4f})")
    if diff > bar:
        raise RuntimeError(f"MCWF populations vs DP5_ME {diff:.4f}")
    out["anchor_ms"] = mc_ms
    # 12 atoms, f32 drift
    label = f"{n_big} atoms MCWF_F32 R={big_r}"
    sim = _me_sim(torch, device, n_big, spacing=MCWF_SPACING, evaluation_times=0.25,
                  runs=big_r, samples_per_run=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(fe)
    _, first = _host_time_ms(torch, lambda: sim.run(solver="MCWF_F32"), 1)
    _no_launch(fe, label)
    peak = _peak_gib(torch)
    big_ms, res = _host_time_ms(torch, lambda: sim.run(solver="MCWF_F32"), 2)
    final = sum(res.results[-1].values())
    totals = {sum(r.bitstring_counts.values()) for r in res}
    if abs(final - 1.0) > 1e-6 or totals != {big_r * 10}:
        raise RuntimeError(f"{label}: results[-1] sums to {final!r}, counts {totals}")
    _log(f"  {label}: run() {big_ms:.1f} ms warm median of 2 ({big_ms / big_r:.2f} ms a "
         f"trajectory), peak device memory {peak:.2f} GiB; results[-1] sums to {final!r}")
    out.update(big_ms=big_ms, big_peak=peak)
    del sim, res
    # the fixed-realization gradient against the DP5_ME model's
    label = f"{n_grad} atoms expectation_mcwf_fn R={grad_r}"
    om = torch.tensor(1.7, dtype=torch.float64, device=device, requires_grad=True)
    mc = _mcwf_model(torch, device, n_grad, "MCWF")
    _reset(fe)
    t0 = time.perf_counter()
    v_mc = mc.expectation_mcwf_fn(key=12, n_traj=grad_r)({"omega": om})[1][-1]
    v_mc.backward()
    v_mc = v_mc.detach()
    torch.cuda.synchronize()
    mc_grad_ms = (time.perf_counter() - t0) * 1e3
    g_mc = float(om.grad)
    _no_launch(fe, label)
    om2 = torch.tensor(1.7, dtype=torch.float64, device=device, requires_grad=True)
    me = _mcwf_model(torch, device, n_grad, "DP5_ME")
    t0 = time.perf_counter()
    v_me = me.expectation_fn()({"omega": om2})[1][-1]
    v_me.backward()
    v_me = v_me.detach()
    torch.cuda.synchronize()
    me_grad_ms = (time.perf_counter() - t0) * 1e3
    g_me = float(om2.grad)
    dv, dg = abs(float(v_mc) - float(v_me)), abs(g_mc - g_me)
    scale = max(1.0, abs(g_me))
    _log(f"  {label}: value {float(v_mc)!r} vs DP5_ME {float(v_me)!r} (|diff| {dv:.4f}, tol "
         f"{MCWF_VALUE_TOL}); grad {g_mc!r} vs {g_me!r} (|diff| {dg:.4f}, tol "
         f"{MCWF_GRAD_REL} x {scale:.3f}); value+grad {mc_grad_ms:.1f} ms (MCWF) and "
         f"{me_grad_ms:.1f} ms (DP5_ME), one run each")
    if dv > MCWF_VALUE_TOL or dg > MCWF_GRAD_REL * scale:
        raise RuntimeError(f"{label}: |dv| {dv:.4f}, |dg| {dg:.4f}")
    out.update(grad_mc_ms=mc_grad_ms, grad_me_ms=me_grad_ms)
    return out


# phase 15, the rest of the front end on the card: (a) bench.py's 3x4
# register with its global channel and 8-parameter amplitude (over
# LOCAL_GLOBAL_NS) beside a rydberg_local channel that targets two
# disjoint groups in turn (one on each side of the row / column split),
# a phase shift on the second, Blackman amplitudes of trainable area and
# ramped detunings; (b) the same register on AnalogDevice, modulated,
# with an EOM block; (c) / (d) bench_xy.py's sequence under an SLM mask
# on two qubits whose first pulse ends at SLM_FIRST_NS.  The kernels are
# held against their plain versions on every step in (a) and (b), across
# the retarget, the phase shift and the EOM block; in (c) / (d) on
# FE_PLAIN_STEPS steps (K1/K2) or FE_CKPT_PLAIN_STEPS (K4/K5) around the
# SLM window's end.  (a)'s default-route gradient is held against the
# same step through K1/K2's plain versions (the kernels' share of its
# distance to the f64 stepper); that distance itself is the lean
# adjoint's rebuild and is printed beside the plain versions' own.
LOCAL_GLOBAL_NS = 480
LOCAL_A = ("q0", "q1", "q6")
LOCAL_B = ("q4", "q9", "q10")
LOCAL_AREAS = np.array([1.2, 0.9])
LOCAL_PHASE = 0.7
SLM_QUBITS = ("q0", "q6")
SLM_FIRST_NS = 160
FE_PLAIN_STEPS = 24
FE_CKPT_PLAIN_STEPS = 8
# (a)'s default-route gradient against the same step through K1/K2's plain
# versions: a tenth of GRAD_TOL, so that a distance to the f64 stepper
# past GRAD_TOL cannot come from the kernels
PLAIN_GRAD_TOL = 1e-6
FWD_ONLY = {"fused_fwd": 1, "fused_bwd": 0, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}


def _local_model(torch, device, fused, **options):
    """(a): bench.py's model with a local channel beside its global one;
    returns (model, p0)."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch.core import (
        BlackmanWaveform, ConstantWaveform, CustomWaveform, MockDevice, Pulse, RampWaveform,
        Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    coords = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(N_QUBITS)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("loc", "rydberg_local", initial_target=LOCAL_A)
    amp_var = seq.declare_variable("amp_samples", size=LOCAL_GLOBAL_NS)
    area = seq.declare_variable("area", size=2)
    seq.add(Pulse(CustomWaveform(amp_var, duration=LOCAL_GLOBAL_NS),
                  ConstantWaveform(LOCAL_GLOBAL_NS, DET0), 0.0), "ryd")
    seq.add(Pulse(BlackmanWaveform(160, area[0]), RampWaveform(160, -1.0, 1.0), 0.0), "loc",
            protocol="no-delay")
    seq.target(LOCAL_B, "loc")
    seq.phase_shift(LOCAL_PHASE, *LOCAL_B, basis="ground-rydberg")
    seq.add(Pulse(BlackmanWaveform(200, area[1]), RampWaveform(200, 1.0, -1.0), 0.0), "loc")
    M = torch.as_tensor(_interpolate_sine_np(N_PARAMS, LOCAL_GLOBAL_NS), device=device)
    p0 = np.linspace(1.0, 3.0, N_PARAMS)
    model = QuantumModel(
        seq, {"amp_samples": ((p0,), lambda v: M @ v), "area": LOCAL_AREAS},
        sampling_rate=SAMPLING_RATE, evaluation_times="Minimal", device=device,
        **({} if fused is None else {"fused": fused}), **options)
    return model, p0


def _local_value_and_grad(torch, model, p0, device):
    """(value, gradient in the 8 parameters then the 2 areas, values)."""
    p = torch.tensor(p0, dtype=torch.float64, device=device, requires_grad=True)
    a = torch.tensor(LOCAL_AREAS, dtype=torch.float64, device=device, requires_grad=True)
    _, vals = model.expectation_fn()({"amp_samples_0": p, "area": a})
    vals[-1].backward()
    return vals[-1].detach(), torch.cat([p.grad, a.grad]).detach(), vals.detach()


def _modulated_sequence():
    """(b): the 3x4 register on AnalogDevice: a Blackman pulse, an EOM
    block of two pulses (the second phase-drift corrected), an
    interpolated pulse."""
    from pulser_diff_torch.core import (
        AnalogDevice, BlackmanWaveform, ConstantWaveform, InterpolatedWaveform, Pulse,
        RampWaveform, Register, Sequence,
    )

    seq = Sequence(Register.rectangle(3, 4, spacing=SPACING, prefix="q"), AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse(BlackmanWaveform(240, 1.0), RampWaveform(240, -4.0, 4.0), 0.0), "ryd")
    seq.enable_eom_mode("ryd", 3.0, 0.0)
    seq.add_eom_pulse("ryd", 64, 0.3)
    seq.delay(40, "ryd")
    seq.add_eom_pulse("ryd", 48, 0.5, correct_phase_drift=True)
    seq.disable_eom_mode("ryd")
    seq.add(Pulse(InterpolatedWaveform(200, [0.0, 6.0, 3.0, 0.0]), ConstantWaveform(200, -2.0),
                  0.8), "ryd")
    return seq


def _xy_slm_model(torch, device, fused, n_qubits: int = N_QUBITS):
    """(c) / (d): bench_xy.py's model under an SLM mask on SLM_QUBITS, its
    first pulse a constant one ending at SLM_FIRST_NS, then the
    8-parameter amplitude; q1's coordinates trainable."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch.core import (
        ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    rest = XY_DURATION - SLM_FIRST_NS
    coords = [(XY_SPACING * (i % 4), XY_SPACING * (i // 4)) for i in range(n_qubits)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("mw", "microwave_global")
    seq.config_slm_mask(SLM_QUBITS)
    amp_var = seq.declare_variable("amp_samples", size=rest)
    seq.add(Pulse.ConstantPulse(SLM_FIRST_NS, 1.0, 0.0, 0.0), "mw")
    seq.add(Pulse(CustomWaveform(amp_var, duration=rest), ConstantWaveform(rest, 0.0), 0.0),
            "mw")
    M = torch.as_tensor(_interpolate_sine_np(N_PARAMS, rest), device=device)
    model = QuantumModel(
        seq, {"amp_samples": ((XY_P0,), lambda v: M @ v), "q1": coords[1]},
        sampling_rate=SAMPLING_RATE, evaluation_times="Minimal", device=device,
        **({} if fused is None else {"fused": fused}))
    return model, coords[1]


def _slm_step(fe, data) -> int:
    """The first step whose kron on/off streams differ from the first
    step's (the SLM window's end), or 0 without kron pairs."""
    if not fe._n_kron(data):
        return 0
    on = data["zkh_re"][0, :, :, 0]
    changed = (on != on[0, 0]).any(-1).nonzero()
    return int(changed[0]) if changed.numel() else 0


def _fe_kernels(torch, fe, sim, substeps: int, device, gen, label: str, ckpt: bool, n=None,
                reps: int = 3):
    """The kernels of one phase-15, 16 or 18 run at its shapes: K1 and K2,
    or K4 and K5 with ``ckpt``, against their plain versions on every
    step, or on ``n`` steps around the SLM window's end (the first ``n``
    without an SLM mask), then timed on every step with their bounds
    (``_held_kernels``).  Returns {kernel: entry} with pr, pc, K, nb, da,
    db, n_steps and (K1/K2) the cluster size C."""
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, substeps, device)
    R_, n_steps, pr, pc, nb, da, db = fe._dims(data)
    K = fe._n_kron(data)
    if ckpt:
        plans = _ckpt_plans(torch, fe, data, label)
        where = f"on {plans['K4']['blocks']} / {plans['K5']['blocks']} blocks"
    else:
        plans = _log_plan(fe, fe._library(), data, "DP5", label)
        where = f"clusters {plans['K1']['C']} / {plans['K2']['C']} blocks"
    start = 0 if n is None else _slm_step(fe, data) - n // 2
    out, _ = _held_kernels(torch, fe, data, slots, n_eval, last_slot, gen, label, ckpt, n=n,
                           start=start, reps=reps)
    (a, ea), (b, eb) = out.items()
    _log(f"  {label}: nb = {nb}, {da} x {db}, pr = {pr}, pc = {pc}, K = {K}, {n_steps} steps; "
         f"{a} {ea['ms']:.3f} ms (bound {ea['bound']:.4f} ms by {ea['by']}), {b} "
         f"{eb['ms']:.3f} ms (bound {eb['bound']:.4f} ms by {eb['by']}) (CUDA events, warm "
         f"median of {reps}) {where}; plain {ea['plain_ms']:.1f} / {eb['plain_ms']:.1f} ms on "
         f"{ea['plain_steps']} steps")
    for name, e in out.items():
        e.update(pr=pr, pc=pc, K=K, nb=nb, da=da, db=db, n_steps=n_steps,
                 C=None if ckpt else plans[name]["C"])
    del data
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _plain_versions(fe):
    """K1 and K2's wrappers replaced by their plain versions (which count
    no launch) for the steps run inside."""
    saved = fe.fused_fwd, fe.fused_bwd
    fe.fused_fwd, fe.fused_bwd = fe.fused_fwd_plain, fe.fused_bwd_plain
    try:
        yield
    finally:
        fe.fused_fwd, fe.fused_bwd = saved


def _entry(kname, src, replaces, launches, e, what):
    """A phase-15 or phase-16 kernel entry: its shape in the name."""
    return (f"{kname}, {what} (pr = {e['pr']}, pc = {e['pc']}, K = {e['K']}; plain_ms: "
            f"{e['plain_steps']} steps)", src, replaces, launches, e)


def _fe_local(torch, fe, device, gen):
    """(a): the local-addressing model's value+grad on the default route
    (K1/K2): the value against the f64 stepper, the gradient against the
    same step's through K1/K2's plain versions, and its distance to the
    f64 stepper's printed beside theirs; with ckpt=True (K4/K5) value and
    gradient against the f64 stepper; the four kernels on every step
    against their plain versions."""
    label = "(a) 12 atoms, global + local channels"
    model, p0 = _local_model(torch, device, fused=None)
    (v, g, vals), la, first_ms = _counted(
        torch, fe, label, lambda: _local_value_and_grad(torch, model, p0, device), K1K2)
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(g).all()):
        raise RuntimeError(f"{label}: bad output: values {vals}, grad {g}")
    step_ms, _ = _host_time_ms(torch, lambda: _local_value_and_grad(torch, model, p0, device), 3)
    with _plain_versions(fe):
        plain_ms, (vp, gp, _) = _host_time_ms(
            torch, lambda: _local_value_and_grad(torch, model, p0, device), 1)
    ck_model, _ = _local_model(torch, device, fused=None, ckpt=True)
    (vc, gc, _), lc, _ = _counted(
        torch, fe, f"{label}, ckpt=True",
        lambda: _local_value_and_grad(torch, ck_model, p0, device), K4K5)
    f64, _ = _local_model(torch, device, fused=False)
    f64_ms, (v64, g64, _) = _host_time_ms(
        torch, lambda: _local_value_and_grad(torch, f64, p0, device), 1)
    dv, dg, dgp = abs(float(v) - float(v64)), (g - g64).abs(), (gp - g64).abs()
    dvk, dgk = abs(float(v) - float(vp)), float((g - gp).abs().max())
    _log(f"  {label}: launches {la}; value+grad {step_ms:.2f} ms warm median of 3 (first "
         f"{first_ms:.1f} ms); through K1/K2's plain versions {plain_ms:.1f} ms, f64 stepper "
         f"{f64_ms:.1f} ms (once each)")
    _log(f"  {label}, default route (K1/K2): value {float(v)!r}  f64 {float(v64)!r}  |dv| "
         f"{dv:.3e} (tol {VALUE_TOL:.0e}); against the plain versions' step |dv| {dvk:.3e} (tol "
         f"{VALUE_TOL:.0e}), max|dg| {dgk:.3e} (tol {PLAIN_GRAD_TOL:.0e})")
    _log(f"  {label}, default route (K1/K2) against the f64 stepper: max|dg| "
         f"{float(dg[:-2].max()):.3e} on the 8 parameters, {float(dg[-2:].max()):.3e} on the 2 "
         f"areas (|area grad| {float(g64[-2:].abs().max()):.4e}); the plain versions' step "
         f"{float(dgp[:-2].max()):.3e} / {float(dgp[-2:].max()):.3e}: the lean adjoint's "
         f"rebuild of each step's start state, not held; with ckpt=True (stored states) it is "
         f"held at {GRAD_TOL:.0e}")
    if dv > VALUE_TOL or dvk > VALUE_TOL or dgk > PLAIN_GRAD_TOL:
        raise RuntimeError(f"{label}: value vs f64 {dv:.3e}; against the plain versions' step "
                           f"|dv| {dvk:.3e}, |dg| {dgk:.3e}")
    _hold_against_f64(torch, vc, gc, v64, g64, f"{label}, ckpt=True (K4/K5)")
    substeps = model._default_substeps()
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    ks = _fe_kernels(torch, fe, sim, substeps, device, gen, label, ckpt=False)
    ks.update(_fe_kernels(torch, fe, sim, substeps, device, gen, f"{label}, ckpt=True",
                          ckpt=True))
    what = "12 atoms global + local"
    return [
        _entry("fused_fwd_kernel (K1)", "fused_evolution.cu", 594, la["fused_fwd"], ks["K1"], what),
        _entry("fused_bwd_kernel (K2)", "fused_evolution.cu", 1026, la["fused_bwd"], ks["K2"],
               what),
        _entry("fused_fwd_ckpt_kernel (K4)", "fused_ckpt.cu", 1479, lc["fused_fwd_ckpt"],
               ks["K4"], what + " ckpt=True"),
        _entry("fused_bwd_ckpt_kernel (K5)", "fused_ckpt.cu", 1511, lc["fused_bwd_ckpt"],
               ks["K5"], what + " ckpt=True"),
    ]


def _fe_modulated(torch, fe, device, gen):
    """(b): the modulated run() on the default route (one K1 launch), its
    final state against the f64 stepper; K1 at its shape on every step
    against its plain version."""
    from pulser_diff_torch import TorchEmulator

    label = "(b) 12 atoms AnalogDevice, modulated, EOM block"
    seq = _modulated_sequence()
    sim = TorchEmulator.from_sequence(seq, sampling_rate=SAMPLING_RATE,
                                      evaluation_times="Minimal", with_modulation=True,
                                      device=device)
    res, lb, first_ms = _counted(torch, fe, label, lambda: sim.run(), FWD_ONLY)
    run_ms, _ = _host_time_ms(torch, lambda: sim.run(), 3)
    ref = sim.run(fused=False)
    err = max(_max_err(res.states.re[-1], ref.states.re[-1]),
              _max_err(res.states.im[-1], ref.states.im[-1]))
    _log(f"  {label}: {seq.get_duration()} ns programmed, {sim._tot_duration} ns modulated "
         f"(fall time {seq.declared_channels['ryd'].fall_time} ns), EOM blocks "
         f"{seq._eom_blocks['ryd']}; launches {lb}; run() {run_ms:.2f} ms warm median of 3 "
         f"(first {first_ms:.1f} ms); final state vs the f64 stepper max|diff| {err:.3e} (tol "
         f"{VALUE_TOL:.0e})")
    if not torch.isfinite(res.states.re).all() or err > VALUE_TOL:
        raise RuntimeError(f"{label}: final state vs f64 {err:.3e} > {VALUE_TOL:.0e}")
    ks = _fe_kernels(torch, fe, sim, sim._auto_substeps({}), device, gen, label, ckpt=False)
    return [_entry("fused_fwd_kernel (K1)", "fused_evolution.cu", 594, lb["fused_fwd"], ks["K1"],
                   "12 atoms modulated run()")]


def _fe_xy_slm(torch, fe, device, gen, n: int):
    """(c) / (d): the XY value+grad under an SLM mask at ``n`` atoms on the
    default route (K1/K2 at 12 atoms, K4/K5 at 16), value, gradient and
    q1's coordinate gradient against the f64 stepper; the kernels at its
    doubled kron pairs against their plain versions."""
    ckpt = n > N_QUBITS
    want = K4K5 if ckpt else K1K2
    label = f"({'d' if ckpt else 'c'}) {n} atoms XY, SLM mask on {SLM_QUBITS}"
    model, c1 = _xy_slm_model(torch, device, fused=None, n_qubits=n)
    (v, g, cg, vals), lx, first_ms = _counted(
        torch, fe, label, lambda: _xy_value_and_grad(torch, model, c1, device), want)
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(g).all()
                                  and torch.isfinite(cg).all()):
        raise RuntimeError(f"{label}: bad output: values {vals}, grad {g}, coords {cg}")
    reps = 1 if ckpt else 3  # a 16-atom step takes seconds
    step_ms, _ = _host_time_ms(torch, lambda: _xy_value_and_grad(torch, model, c1, device),
                               reps)
    f64, _ = _xy_slm_model(torch, device, fused=False, n_qubits=n)
    t0 = time.perf_counter()
    v64, g64, c64, _ = _xy_value_and_grad(torch, f64, c1, device)
    torch.cuda.synchronize()
    f64_ms = (time.perf_counter() - t0) * 1e3
    del f64
    dv, dg, dc = (abs(float(v) - float(v64)), float((g - g64).abs().max()),
                  float((cg - c64).abs().max()))
    _log(f"  {label}: launches {lx}; value+grad {step_ms:.2f} ms warm median of {reps} (first "
         f"{first_ms:.1f} ms); f64 stepper {f64_ms:.1f} ms (once)")
    _log(f"  {label}: value {float(v)!r}  f64 {float(v64)!r}  |dv| {dv:.3e} (tol "
         f"{VALUE_TOL:.0e}); max|dg| {dg:.3e}, max|dc| {dc:.3e} (tol {GRAD_TOL:.0e}), "
         f"coordinate grad {cg.cpu().numpy().tolist()!r}")
    if dv > VALUE_TOL or dg > GRAD_TOL or dc > GRAD_TOL or float(cg.abs().max()) == 0.0:
        raise RuntimeError(f"{label}: fused path vs f64 stepper: |dv| {dv:.3e}, "
                           f"|dg| {dg:.3e}, |dc| {dc:.3e}")
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    ks = _fe_kernels(torch, fe, sim, model._default_substeps(), device, gen, label, ckpt=ckpt,
                     n=FE_CKPT_PLAIN_STEPS if ckpt else FE_PLAIN_STEPS, reps=reps)
    del model, sim
    torch.cuda.empty_cache()
    what = f"{n} atoms XY SLM"
    if ckpt:
        return [_entry("fused_fwd_ckpt_kernel with its kron-pair branch (K4, K3)",
                       "fused_ckpt.cu", 1479, lx["fused_fwd_ckpt"], ks["K4"], what),
                _entry("fused_bwd_ckpt_kernel with its kron-pair branch (K5, K3)",
                       "fused_ckpt.cu", 1511, lx["fused_bwd_ckpt"], ks["K5"], what)]
    return [_entry("fused_fwd_kernel with its kron-pair branch (K1, K3)", "fused_evolution.cu",
                   594, lx["fused_fwd"], ks["K1"], what),
            _entry("fused_bwd_kernel with its kron-pair branch (K2, K3)", "fused_evolution.cu",
                   1026, lx["fused_bwd"], ks["K2"], what)]


def _front_end_phase(torch, fe, device, gen, xy16: int = 16):
    """Phase 15: (a) the local-addressing model, (b) the modulated run(),
    (c) the 12-atom XY SLM step (K1/K2, K = 16), (d) the 16-atom one
    (K4/K5, K = 20).  Returns the kernels' entries."""
    return (_fe_local(torch, fe, device, gen) + _fe_modulated(torch, fe, device, gen)
            + _fe_xy_slm(torch, fe, device, gen, N_QUBITS)
            + _fe_xy_slm(torch, fe, device, gen, xy16))


# phase 16, the other bases: bench.py's model with a raman_global pulse of
# trainable amplitude beside its rydberg_global one (the all basis, three
# levels a site, da = 3^a), the observable the total Rydberg occupation;
# bench.py's model on raman_global alone (the digital basis); leakage; the
# time derivatives
RAMAN_AMP0 = 0.8
RAMAN_DET = 0.5
RAMAN_PHASE = 0.3
# the all basis: K1/K2 at C = 1 on 3 x 3 and 27 x 27; K4/K5 from 7 atoms
# (K1/K2's plan refuses before any launch) and at 6 atoms with ckpt=True;
# 10 atoms (243 x 243, dim 59049) is the largest below the checkpoint
# threshold 2^16
ALL_SMALL_N = 2
ALL_K1K2_N = 6
ALL_REFUSED_N = 8
ALL_BIG_N = 10
# leakage: a 4-atom register (dim 81) leaking |r> and |g> into |x>
LEAK_N = 4
LEAK_RATES = (0.3, 0.2)
# the time derivatives: a central difference of the same function, its
# step (us) and bar; the parameter derivative's step along the gradient
DERIV_EPS = 1e-6
DERIV_REL_TOL = 1e-5
PARAM_EPS = 1e-5


def _all_model(torch, device, fused, n_qubits: int, raman_only: bool = False, **options):
    """bench.py's model at ``n_qubits`` atoms with a raman_global pulse of
    trainable amplitude beside the rydberg_global one (the all basis), or
    with bench.py's amplitude on raman_global alone (the digital basis);
    returns (model, p0, observable): the total Rydberg occupation's
    diagonal in the all basis, None (the total magnetization) in the
    digital one."""
    from pulser_diff_torch import QuantumModel
    from pulser_diff_torch.core import (
        ConstantWaveform, CustomWaveform, MockDevice, Pulse, Register, Sequence,
    )
    from pulser_diff_torch.ops.linalg import _interpolate_sine_np

    coords = [(SPACING * (i % 4), SPACING * (i // 4)) for i in range(n_qubits)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    if not raman_only:
        seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_global")
    amp_var = seq.declare_variable("amp_samples", size=DURATION)
    seq.add(Pulse(CustomWaveform(amp_var, duration=DURATION), ConstantWaveform(DURATION, DET0),
                  0.0), "ram" if raman_only else "ryd")
    M = torch.as_tensor(_interpolate_sine_np(N_PARAMS, DURATION), device=device)
    p0 = np.linspace(1.0, 3.0, N_PARAMS)
    params = {"amp_samples": ((p0,), lambda v: M @ v)}
    obs = None
    if not raman_only:
        r = seq.declare_variable("raman_amp")
        seq.add(Pulse.ConstantPulse(DURATION, r, RAMAN_DET, RAMAN_PHASE), "ram",
                protocol="no-delay")
        params["raman_amp"] = RAMAN_AMP0
        digits = np.stack(np.unravel_index(np.arange(3**n_qubits), (3,) * n_qubits), axis=1)
        obs = torch.as_tensor((digits == 0).sum(1).astype(np.float64), device=device)
    model = QuantumModel(seq, params, sampling_rate=SAMPLING_RATE, evaluation_times="Minimal",
                         device=device, **({} if fused is None else {"fused": fused}), **options)
    return model, p0, obs


def _all_value_and_grad(torch, model, p0, obs, device):
    """(value, gradient in the 8 parameters and the Raman amplitude,
    values)."""
    p = torch.tensor(p0, dtype=torch.float64, device=device, requires_grad=True)
    params = {"amp_samples_0": p}
    if "raman_amp" in model.params:
        params["raman_amp"] = torch.tensor(RAMAN_AMP0, dtype=torch.float64, device=device,
                                           requires_grad=True)
    _, vals = model.expectation_fn(obs)(params)
    vals[-1].backward()
    grad = torch.cat([v.grad.reshape(-1) for v in params.values()])
    return vals[-1].detach(), grad.detach(), vals.detach()


def _all_step(torch, fe, device, gen, n: int, label: str, want: dict, raman_only: bool = False,
              plain_n=None, **options):
    """One phase-16 value+grad step on its route, counted (exactly one
    launch of each kernel of ``want``), timed with its peak device memory,
    held against the f64 stepper at VALUE_TOL / GRAD_TOL; its kernels at
    its shapes against their plain versions (every step, or the first
    ``plain_n``), timed, with their bounds.  Returns {kernel: entry} with
    the launches."""
    model, p0, obs = _all_model(torch, device, None, n, raman_only, **options)
    step = lambda: _all_value_and_grad(torch, model, p0, obs, device)  # noqa: E731
    (v, g, vals), launches, first_ms = _counted(torch, fe, label, step, want)
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(g).all()):
        raise RuntimeError(f"{label}: bad output: values {vals}, grad {g}")
    torch.cuda.reset_peak_memory_stats()
    reps = 1 if n >= ALL_BIG_N else 3
    step_ms, _ = _host_time_ms(torch, step, reps)
    peak = _peak_gib(torch)
    f64, _, _ = _all_model(torch, device, False, n, raman_only)
    f64_ms, (v64, g64, _) = _host_time_ms(
        torch, lambda: _all_value_and_grad(torch, f64, p0, obs, device), 1)
    del f64
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    h = sim._hamiltonian
    _log(f"  {label}: basis {h.basis_name} ({h.dim} levels), da x db = {h.dim**h._a} x "
         f"{h.dim**h._b}; launches {launches}; value+grad {step_ms:.2f} ms warm median of "
         f"{reps} (first {first_ms:.1f} ms), peak device memory {peak:.3f} GiB; f64 stepper "
         f"{f64_ms:.1f} ms (once)")
    _hold_against_f64(torch, v, g, v64, g64, label)
    ckpt = want["fused_fwd_ckpt"] > 0
    ks = _fe_kernels(torch, fe, sim, model._default_substeps(), device, gen, label, ckpt=ckpt,
                     n=plain_n, reps=reps)
    for name, e in ks.items():
        e["launches"] = launches[{"K1": "fused_fwd", "K2": "fused_bwd", "K4": "fused_fwd_ckpt",
                                  "K5": "fused_bwd_ckpt"}[name]]
        e.update(step_ms=step_ms, peak=peak, da=h.dim**h._a, db=h.dim**h._b)
    del model, sim
    torch.cuda.empty_cache()
    return ks


def _all_refused(torch, fe, device, n: int) -> None:
    """K1/K2's plan refuses the shape on the host (ValueError naming
    ckpt=True) before any launch."""
    model, _, _ = _all_model(torch, device, None, n)
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, model._default_substeps(), device)
    R, n_steps, pr, pc, nb, da, db = fe._dims(data)
    for bwd in (False, True):
        if fe.cluster_fits(bwd, nb, da, db, pr, pc, 0, 6):
            raise RuntimeError(f"{n} atoms ({da} x {db}): K{2 if bwd else 1}'s plan fits")
    st = torch.zeros((R, n_eval, nb, da, db), dtype=torch.float32, device=device)
    _reset(fe)
    for name, call in (("K1", lambda: fe.fused_fwd(data, "DP5", slots, n_eval)),
                       ("K2", lambda: fe.fused_bwd(data, "DP5", slots, n_eval, last_slot,
                                                   st, st, st, st))):
        try:
            call()
        except ValueError as exc:
            if "ckpt=True" not in str(exc):
                raise
            _log(f"  {n} atoms ({da} x {db}): {name} refused on the host as expected: {exc}")
        else:
            raise RuntimeError(f"{n} atoms: {name} accepted a shape its plan refuses")
    _no_launch(fe, f"{n} atoms, the refusals")
    del data, sim, model


def _leakage_phase(torch, fe, device, n: int = LEAK_N) -> dict:
    """(d): a Lindblad run() on the leakage-extended basis [r, g, x] at
    ``n`` atoms (no kernel): the dense and factored forms within
    ME_FORM_VALUE_TOL of each other at every time, the final trace and
    Hermiticity within ME_TRACE_TOL, the final weights equal to a host
    projection that reads |x> as 0, the samples summing to the shots."""
    from pulser_diff_torch import SimConfig, TorchEmulator
    from pulser_diff_torch.core import MockDevice, Pulse, Register, Sequence

    coords = [(ME_SPACING * (i % 4), ME_SPACING * (i // 4)) for i in range(n)]
    seq = Sequence(Register.from_coordinates(coords, prefix="q"), MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse.ConstantPulse(ME_DURATION, 2.0, -1.0, 0.0), "ryd")
    ops = []
    for frm in (0, 1):  # |x><r|, |x><g|
        op = np.zeros((3, 3))
        op[2, frm] = 1.0
        ops.append(op)
    cfg = SimConfig(noise="eff_noise", eff_noise_rates=LEAK_RATES, eff_noise_opers=tuple(ops),
                    with_leakage=True)
    sim = TorchEmulator.from_sequence(seq, sampling_rate=ME_SAMPLING, config=cfg,
                                      evaluation_times=0.5, device=device)
    label = f"(d) {n} atoms leakage (dim {sim.dim**n})"
    _reset(fe)
    out = {}
    for form in ("dense", "factored"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run(me_form=form)
        torch.cuda.synchronize()
        out[form] = (res, (time.perf_counter() - t0) * 1e3)
    _no_launch(fe, label)
    dense, factored = out["dense"][0], out["factored"][0]
    diff = max(_max_err(dense.states.re, factored.states.re),
               _max_err(dense.states.im, factored.states.im))
    rho = dense.states[-1]
    dtr, herm = _rho_checks(torch, rho, label)
    pops = torch.diagonal(rho.re).double().cpu().numpy()
    digits = np.stack(np.unravel_index(np.arange(3**n), (3,) * n), axis=1)
    bits = (digits == 0).astype(np.int64) @ (1 << np.arange(n - 1, -1, -1))
    want = np.bincount(bits, weights=pops, minlength=2**n)
    got = dense[-1]._weights().double().cpu().numpy()
    dw = float(np.abs(got - want / want.sum()).max())
    leaked = float(pops[(digits == 2).any(1)].sum())
    shots = dense.sample_final_state(1000)
    _log(f"  {label}: dense {out['dense'][1]:.1f} ms, factored {out['factored'][1]:.1f} ms; "
         f"forms max|diff| {diff:.3e} (tol {ME_FORM_VALUE_TOL:.0e}); |tr - 1| {dtr:.3e}, "
         f"max|rho - rho^H| {herm:.3e}; population in |x> {leaked:.4f}; weights vs the host "
         f"projection (x reads 0) {dw:.3e}; {sum(shots.values())} shots")
    if diff > ME_FORM_VALUE_TOL or dw > 1e-12 or leaked < 1e-3 or sum(shots.values()) != 1000:
        raise RuntimeError(f"{label}: forms {diff:.3e}, weights {dw:.3e}, leaked {leaked:.3e}")
    return {"leak_dense_ms": out["dense"][1], "leak_factored_ms": out["factored"][1]}


def _derivative_phase(torch, fe, device) -> dict:
    """(e): bench.py's 12-atom sequence on the f64 stepper (no kernel):
    expectation_fn_of_times on every sampled time and deriv_time with the
    pulse boundaries repaired, against a central difference of the same
    function at three interior times between the streams' samples;
    deriv_param at one time against a central difference along the
    gradient; each within DERIV_REL_TOL relative."""
    from pulser_diff_torch import deriv_param, deriv_time
    from pulser_diff_torch.ops.linalg import total_magnetization

    label = f"(e) {N_QUBITS} atoms, time derivatives"
    model, p0 = _bench_model(torch, device, fused=False, n_qubits=N_QUBITS, duration=DURATION)
    with torch.no_grad():
        sim = model._make_emulator(dict(model.params))
    sim.set_evaluation_times("Full")
    obs = total_magnetization(N_QUBITS, dense=False, device=device)
    _reset(fe)
    fn = sim.expectation_fn_of_times(obs)
    t = sim.evaluation_times
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfdt = deriv_time(fn, t, pulse_endtimes=sim.endtimes)
    torch.cuda.synchronize()
    dt_ms = (time.perf_counter() - t0) * 1e3
    n_t = int(t.shape[0])
    # at an evaluation time on a sample of the drive's streams (linearly
    # interpolated, so H(t) has a kink there) the stepped function has
    # only one-sided derivatives; the central difference is taken at
    # interior times between samples
    pos = sim._eval_times_array / sim._hamiltonian._ham_data.sample_dt
    between = [i for i in range(2, n_t - 2) if abs(pos[i] - round(pos[i])) > 0.1
               and all(abs(i - e) > 2 for e in sim.endtimes)]
    if len(between) < 3:
        raise RuntimeError(f"{label}: {len(between)} interior times between samples")
    worst = 0.0
    with torch.no_grad():
        for i in (between[len(between) // 4], between[len(between) // 2],
                  between[3 * len(between) // 4]):
            e = torch.zeros_like(t)
            e[i] = DERIV_EPS
            fd = float(fn(t + e).sum() - fn(t - e).sum()) / (2 * DERIV_EPS)
            rel = abs(float(dfdt[i]) - fd) / abs(fd)
            worst = max(worst, rel)
            _log(f"  {label}: t = {float(t[i]):.3f} us  deriv_time {float(dfdt[i])!r}  central "
                 f"difference {fd!r}  rel {rel:.3e}")
    # deriv_param at one time: the final value's gradient in the 8
    # parameters, against a central difference along it
    fnp = model.expectation_fn()
    p = torch.tensor(p0, dtype=torch.float64, device=device, requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (g,) = deriv_param(lambda x: fnp({"amp_samples_0": x})[1], [p],
                       times=np.array([0.0, DURATION / 1000]), t=DURATION)
    torch.cuda.synchronize()
    dp_ms = (time.perf_counter() - t0) * 1e3
    u = g / g.norm()
    with torch.no_grad():
        fd = float(fnp({"amp_samples_0": p + PARAM_EPS * u})[1][-1]
                   - fnp({"amp_samples_0": p - PARAM_EPS * u})[1][-1]) / (2 * PARAM_EPS)
    rel_p = abs(float(g.norm()) - fd) / abs(fd)
    _no_launch(fe, label)
    _log(f"  {label}: deriv_time over {n_t} times {dt_ms:.1f} ms (f64 stepper, forward and "
         f"backward); worst rel {worst:.3e} (tol {DERIV_REL_TOL:.0e}); deriv_param at "
         f"{DURATION} ns {dp_ms:.1f} ms, |g| {float(g.norm())!r} against the central difference "
         f"{fd!r}, rel {rel_p:.3e}")
    if worst > DERIV_REL_TOL or rel_p > DERIV_REL_TOL:
        raise RuntimeError(f"{label}: deriv_time rel {worst:.3e}, deriv_param rel {rel_p:.3e}")
    return {"deriv_time_ms": dt_ms, "deriv_param_ms": dp_ms}


def _bases_phase(torch, fe, device, gen):
    """Phase 16: the all basis on K1/K2 (2 and 6 atoms, C = 1) and K4/K5 (6
    atoms with ckpt=True, 8 and 10 atoms by default, K1/K2 refusing 8
    atoms on the host first), the digital basis at 12 atoms (K1/K2, C =
    16), leakage, the time derivatives.  Returns the kernels' entries and
    the times of (d) and (e)."""
    label = "(a/b) {n} atoms, all basis{extra}"
    small = _all_step(torch, fe, device, gen, ALL_SMALL_N, label.format(n=ALL_SMALL_N, extra=""),
                      K1K2, plain_n=PLAIN_STEPS)
    mid = _all_step(torch, fe, device, gen, ALL_K1K2_N, label.format(n=ALL_K1K2_N, extra=""),
                    K1K2, plain_n=PLAIN_STEPS)
    mid_ck = _all_step(torch, fe, device, gen, ALL_K1K2_N,
                       label.format(n=ALL_K1K2_N, extra=", ckpt=True"), K4K5, plain_n=PLAIN_STEPS,
                       ckpt=True)
    _all_refused(torch, fe, device, ALL_REFUSED_N)
    refused = _all_step(torch, fe, device, gen, ALL_REFUSED_N,
                        label.format(n=ALL_REFUSED_N, extra=""), K4K5, plain_n=PLAIN_STEPS)
    big = _all_step(torch, fe, device, gen, ALL_BIG_N, label.format(n=ALL_BIG_N, extra=""),
                    K4K5, plain_n=PLAIN_STEPS)
    digital = _all_step(torch, fe, device, gen, N_QUBITS,
                        f"(c) {N_QUBITS} atoms, digital basis (raman_global)", K1K2,
                        raman_only=True, plain_n=PLAIN_STEPS)
    times = {**_leakage_phase(torch, fe, device), **_derivative_phase(torch, fe, device)}
    entries = []
    for what, ks in ((f"all basis {ALL_SMALL_N} atoms", small),
                     (f"all basis {ALL_K1K2_N} atoms", mid),
                     (f"all basis {ALL_K1K2_N} atoms ckpt=True", mid_ck),
                     (f"all basis {ALL_REFUSED_N} atoms", refused),
                     (f"all basis {ALL_BIG_N} atoms", big),
                     (f"digital basis {N_QUBITS} atoms", digital)):
        for name, e in ks.items():
            src, line = (("fused_evolution.cu", 594 if name == "K1" else 1026)
                         if name in ("K1", "K2") else
                         ("fused_ckpt.cu", 1479 if name == "K4" else 1511))
            kname = {"K1": "fused_fwd_kernel (K1)", "K2": "fused_bwd_kernel (K2)",
                     "K4": "fused_fwd_ckpt_kernel (K4)", "K5": "fused_bwd_ckpt_kernel (K5)"}[name]
            entries.append(_entry(kname, src, line, e["launches"], e,
                                  f"{what}, {e['da']} x {e['db']}"))
    return entries, times


# phase 17: the Krylov and adaptive steppers (plain torch, no kernel under
# them, as no Pallas kernel lies under them in the JAX package) on
# bench.py's 12-atom model at full width, cut to 132 ns (33 grid
# intervals), and the final-state form of the fused kernels
P17_DURATION = 132
# the window on which phase 17 (a) takes each solver's busy share
P17_PROFILE_NS = 20
# |value of KRYLOV_SE_F32 - value of KRYLOV_SE| of the JAX package on this
# model (12 atoms, 132 ns), on the CPU; recomputed by
# tests/test_torch_krylov.py::test_twelve_atom_f32_distance
JAX_F32_KRYLOV_DIST = 8.820745065918345e-06
# KRYLOV_SE_F32's value against KRYLOV_SE on the card: 3x the JAX
# package's own f32 distance, floor 1e-5; its gradient at the JAX
# package's bar (tests/test_solvers.py::test_krylov_f32_matches_f64)
F32_KRYLOV_VALUE_TOL = max(3 * JAX_F32_KRYLOV_DIST, 1e-5)
F32_KRYLOV_GRAD_REL = 1e-4
# each f64 solver on the card against the same call on the card machine's
# CPU (same algorithm, same grid): (value relative, gradient x max|g|).
# Device roundoff may flip an adaptive accept near its threshold, so the
# adaptive bars sit at rtol's level
P17_BARS = {"KRYLOV_SE": (1e-10, 1e-8), "DP5_SE_ADAPTIVE": (1e-8, 1e-6)}


def _p17_step(torch, fe, device, solver: str, label: str, profile: bool = True, **options):
    """One value+grad step of the 132 ns model under ``solver``, counted
    (no fused launch) with the adaptive loop's counts read just after;
    its time, peak device memory and (``profile``) busy share on a second
    run.  Returns a dict."""
    from pulser_diff_torch.solvers import solver as sv

    fused = options.pop("fused", None)
    model, p0 = _bench_model(torch, device, fused, duration=P17_DURATION, solver=solver,
                             **options)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sv.reset_adaptive_counts()
    (v, g, vals), _, ms = _counted(torch, fe, label, lambda: _value_and_grad(torch, model, p0,
                                                                             device), NO_LAUNCH)
    counts = dict(sv.ADAPTIVE_COUNTS)
    peak = _peak_gib(torch)
    if vals.shape != (2,) or not (torch.isfinite(vals).all() and torch.isfinite(g).all()):
        raise RuntimeError(f"{label}: bad output: values {vals}, grad {g}")
    line = f"  {label}: value+grad {ms:.1f} ms, peak device memory {peak:.3f} GiB"
    busy = None
    if profile:
        # the profiler's trace of a whole step holds ~10^5-10^6 launches and
        # takes minutes to read back: the busy share is taken on the same
        # model cut to P17_PROFILE_NS, timed alone and then profiled
        short, _ = _bench_model(torch, device, fused, duration=P17_PROFILE_NS, solver=solver,
                                **options)
        step = lambda: _value_and_grad(torch, short, p0, device)  # noqa: E731
        short_ms, _ = _host_time_ms(torch, step, 1)
        busy, n_dev = _device_busy_ms(torch, step)
        line += f"; cut to {P17_PROFILE_NS} ns ({short_ms:.1f} ms) " + _busy_line(
            busy, n_dev, short_ms)
        busy = None if busy is None else busy / short_ms
    if counts["attempts"]:
        line += (f"; {counts['attempts']} attempted / {counts['accepted']} accepted steps, "
                 f"{counts['reads']} host reads")
    _log(line)
    del model
    return dict(v=v, g=g, ms=ms, peak=peak, busy_share=busy, counts=counts)


def _p17_hold(v, g, v_ref, g_ref, value_tol: float, grad_tol: float, label: str,
              relative: bool = True) -> tuple:
    """|dv| (relative to |v_ref| when ``relative``) and max |dg| / max |g_ref|,
    held to the bars."""
    dv = abs(float(v) - float(v_ref)) / (abs(float(v_ref)) if relative else 1.0)
    dg = float((g.double().cpu() - g_ref.double().cpu()).abs().max()) / float(
        g_ref.abs().max())
    _log(f"  {label}: value {float(v)!r} against {float(v_ref)!r}: {'relative ' if relative else ''}"
         f"|dv| {dv:.3e} (tol {value_tol:.3e}); max|dg| / max|g| {dg:.3e} (tol {grad_tol:.0e})")
    if dv > value_tol or dg > grad_tol:
        raise RuntimeError(f"{label}: |dv| {dv:.3e}, |dg| {dg:.3e}")
    return dv, dg


def _solvers_phase(torch, fe, device):
    """(a): value+grad under KRYLOV_SE, DP5_SE_ADAPTIVE and KRYLOV_SE_F32 on
    the card, each f64 solver held against the same call on the card
    machine's CPU, KRYLOV_SE_F32 against KRYLOV_SE on the card; each
    solver's distance to the f64 DP5_SE step at 1 and 8 substeps printed.
    Returns the steps' times."""
    cpu = torch.device("cpu")
    steps, out = {}, {}
    for solver in ("KRYLOV_SE", "DP5_SE_ADAPTIVE", "KRYLOV_SE_F32"):
        steps[solver] = _p17_step(torch, fe, device, solver, f"(a) {solver} on the card")
    for solver, (vtol, gtol) in P17_BARS.items():
        from pulser_diff_torch.solvers import solver as sv

        model, p0 = _bench_model(torch, cpu, None, duration=P17_DURATION, solver=solver)
        sv.reset_adaptive_counts()
        t0 = time.perf_counter()
        v, g, _ = _value_and_grad(torch, model, p0, cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        c = sv.ADAPTIVE_COUNTS
        s = steps[solver]
        extra = (f"; attempted / accepted steps {s['counts']['attempts']} / "
                 f"{s['counts']['accepted']} on the card, {c['attempts']} / {c['accepted']} on "
                 f"the CPU" if c["attempts"] else "")
        _log(f"  (a) {solver} on the card machine's CPU: {cpu_ms:.1f} ms{extra}")
        _p17_hold(s["v"], s["g"], v, g, vtol, gtol, f"(a) {solver}: card vs CPU")
    k64, k32 = steps["KRYLOV_SE"], steps["KRYLOV_SE_F32"]
    dv, dg = _p17_hold(k32["v"], k32["g"], k64["v"], k64["g"], F32_KRYLOV_VALUE_TOL,
                       F32_KRYLOV_GRAD_REL, "(a) KRYLOV_SE_F32 vs KRYLOV_SE on the card",
                       relative=False)
    _log(f"  (a) KRYLOV_SE_F32's distance to f64 on the card {dv:.3e}; the JAX package's f32 "
         f"mode on the CPU {JAX_F32_KRYLOV_DIST:.3e} (bar 3x that, floor 1e-5)")
    for sub in (1, 8):
        ref = _p17_step(torch, fe, device, "DP5_SE", f"(a) DP5_SE f64, {sub} substep(s)",
                        profile=False, fused=False, substeps=sub)
        for solver, s in steps.items():
            d_v = abs(float(s["v"]) - float(ref["v"]))
            d_g = float((s["g"].double() - ref["g"]).abs().max())
            _log(f"  (a) {solver} vs DP5_SE f64 at {sub} substep(s): |dv| {d_v:.3e}, "
                 f"max|dg| {d_g:.3e} (printed, not held)")
        out[f"dp5_f64_{sub}_ms"] = ref["ms"]
    for solver, s in steps.items():
        out[f"{solver}_ms"] = s["ms"]
    return out


def _final_state_case(torch, fe, device, gen, label: str, sim, substeps: int, ckpt: bool,
                      want: dict, plain_n=None) -> dict:
    """(b): pallas_evolve on ``sim``'s Hamiltonian, value and gradient in
    the streams and the interaction diagonal, counted (``want``); the final
    state equal to the last slot of evolve_states bit for bit and the
    gradient within K2's relative tolerance of evolve_states'; the kernels
    at the final-state form's inputs against their plain versions, timed."""
    from pulser_diff_torch.cplx import Cplx
    from pulser_diff_torch.solvers import TimeGrid

    h = sim._hamiltonian
    da, db = h.dim**h._a, h.dim**h._b
    grid = TimeGrid.make(h.sampling_times, sim._eval_times_array, device).refined(substeps)
    psi0 = sim.initial_state
    p = Cplx(psi0.re.T.reshape(1, da, db), psi0.im.T.reshape(1, da, db))

    def run(final: bool):
        hd = h._ham_data
        s = hd.row_streams.re.detach().clone().requires_grad_(True)
        d = hd.int_diag.detach().clone().requires_grad_(True)
        ham = hd._replace(row_streams=Cplx(s, hd.row_streams.im.detach()), int_diag=d)
        if final:
            st = fe.pallas_evolve(ham, p, grid.times, "DP5", ckpt=ckpt)
        else:
            st = fe.evolve_states(ham, p, grid, "DP5", ckpt=ckpt)[-1]
        (st.re.double() ** 2 - st.im.double()).sum().backward()
        return st.re.detach(), st.im.detach(), s.grad, d.grad

    (f_re, f_im, gs, gd), launches, ms = _counted(torch, fe, label, lambda: run(True), want)
    e_re, e_im, es, ed = run(False)
    if not (torch.equal(f_re, e_re) and torch.equal(f_im, e_im)):
        raise RuntimeError(f"{label}: the final state differs from evolve_states' last slot")
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in ((gs, es), (gd, ed)))
    _log(f"  {label}: final state {tuple(f_re.shape)} {f_re.dtype} equal to evolve_states' last "
         f"slot bit for bit; gradient within {rel:.3e} relative (tol {K2_TOL_REL:.0e}); "
         f"launches {launches}; value+grad {ms:.1f} ms")
    if rel > K2_TOL_REL:
        raise RuntimeError(f"{label}: gradient {rel:.3e} from evolve_states'")
    with torch.no_grad():
        data = fe.prepare_fused_inputs(h._ham_data, p, grid.times, "DP5")
    data = {k: v.detach().contiguous() for k, v in data.items()}
    n_steps = int(data["hs"].shape[0])
    slots = torch.ones(n_steps + 1, dtype=torch.int32, device=device)
    slots[-1] = 0
    ks, _ = _held_kernels(torch, fe, data, slots, 1, 0, gen, label, ckpt, n=plain_n)
    keys = {"K1": "fused_fwd", "K2": "fused_bwd", "K4": "fused_fwd_ckpt", "K5": "fused_bwd_ckpt"}
    for name, e in ks.items():
        e.update(launches=launches[keys[name]], pr=int(data["rp"].shape[0]),
                 pc=int(data["cp"].shape[0]), K=fe._n_kron(data), da=da, db=db)
        _log(f"  {label}: {name} {e['ms']:.3f} ms (bound {e['bound']:.4f} ms by {e['by']}), "
             f"against plain {e['err']:.3e} (plain {e['plain_ms']:.1f} ms on "
             f"{e['plain_steps']} steps)")
    return ks


def _final_state_phase(torch, fe, device, gen):
    """(b): pallas_evolve at 12 atoms on K1/K2, 16 atoms with ckpt=True on
    K4/K5, and on the 12-atom XY model on K1/K2 with kron pairs (K3).
    Returns the kernels' entries."""
    cases = []
    m12, _ = _bench_model(torch, device, True)
    m16, _ = _bench_model(torch, device, None, n_qubits=16)
    mxy, _ = _xy_model(torch, device, True)
    for label, model, ckpt, want, n in (
            ("(b) 12 atoms, pallas_evolve", m12, False, K1K2, PLAIN_STEPS),
            ("(b) 16 atoms, pallas_evolve(ckpt=True)", m16, True, K4K5, PLAIN_STEPS),
            ("(b) 12-atom XY, pallas_evolve", mxy, False, K1K2, PLAIN_STEPS)):
        with torch.no_grad():
            sim = model._make_emulator(dict(model.params))
        ks = _final_state_case(torch, fe, device, gen, label, sim, model._default_substeps(),
                               ckpt, want, plain_n=n)
        names = {"K1": ("fused_fwd_kernel (K1)", "fused_evolution.cu", 1330),
                 "K2": ("fused_bwd_kernel (K2)", "fused_evolution.cu", 1330),
                 "K4": ("fused_fwd_ckpt_kernel (K4)", "fused_ckpt.cu", 1679),
                 "K5": ("fused_bwd_ckpt_kernel (K5)", "fused_ckpt.cu", 1679)}
        for name, e in ks.items():
            kname, src, line = names[name]
            what = f"final-state form, {label[4:]}, {e['da']} x {e['db']}"
            cases.append(_entry(kname, src, line, e["launches"], e, what))
        del sim
        torch.cuda.empty_cache()
    return cases


# phase 18: the example flows of pulser_diff_torch/examples (docs/*.py) on
# the card, each on its default route, at the shapes the flows give K1/K2
# (identity batches nb = 4 / 16 at 2 / 4 atoms; 6 and 9 atoms, C = 8 / 16)
P18_ADAM_STEPS = 3
# three times inside basic_usage's constant first pulse (H constant there,
# so <M>(t) is smooth at the evaluation times): indices of its 1 ns grid;
# deriv_time on the card and its central differences solve the first
# P18_DERIV_TIMES evaluation times only (0-150 ns of the 600)
P18_DERIV_INDICES = (50, 100, 150)
P18_DERIV_TIMES = 151


def _ex_value_and_grad(torch, loss_fn, params):
    """(value, the gradient in every parameter, flattened) of
    ``loss_fn(list of parameters)``."""
    ps = [p.detach().clone().requires_grad_(True) for p in params]
    value = loss_fn(ps)
    grads = torch.autograd.grad(value, ps)
    return value.detach(), torch.cat([g.reshape(-1) for g in grads])


def _ex_shares(torch, label: str, epoch_ms: float, build, ks: dict) -> dict:
    """An epoch's time split (at the start values, where the kernels were
    timed): the host's rebuild of Sequence -> sampler ->
    Hamiltonian (``build()``, host clock, warm median of 3), K1 + K2 (CUDA
    events), and the rest (autograd, the small ops' launches, Adam)."""
    build_ms, _ = _host_time_ms(torch, build, 3)
    k_ms = ks["K1"]["ms"] + ks["K2"]["ms"]
    rest = epoch_ms - build_ms - k_ms
    _log(f"  {label}: epoch {epoch_ms:.2f} ms = build {build_ms:.2f} ms "
         f"({100 * build_ms / epoch_ms:.1f} %) + K1 + K2 {k_ms:.3f} ms "
         f"({100 * k_ms / epoch_ms:.1f} %) + the rest {rest:.2f} ms "
         f"({100 * rest / epoch_ms:.1f} %: autograd, the small ops' launches, Adam)")
    return {"epoch_ms": epoch_ms, "build_ms": build_ms, "kernel_ms": k_ms}


def _ex_first_step(torch, fe, label: str, loss, loss64, params):
    """The flow's first value+grad step on the default route, counted (one
    K1 and one K2 launch), against the f64 stepper's (``loss64``) at
    VALUE_TOL / GRAD_TOL.  Returns (value, grad, launches, first ms)."""
    (v, g), launches, first_ms = _counted(
        torch, fe, label, lambda: _ex_value_and_grad(torch, loss, params), K1K2)
    if not (torch.isfinite(v) and torch.isfinite(g).all()):
        raise RuntimeError(f"{label}: value {v}, grad {g}")
    f64_ms, (v64, g64) = _host_time_ms(torch, lambda: _ex_value_and_grad(torch, loss64, params),
                                       1)
    _log(f"  {label}: launches {launches}; first value+grad {first_ms:.1f} ms; f64 stepper "
         f"{f64_ms:.1f} ms (once)")
    _hold_against_f64(torch, v, g, v64, g64, label)
    return v, g, launches, first_ms


def _ex_gate(torch, fe, device, gen) -> dict:
    """(a) the 2-qubit gate (nb = 4, C = 2): the first step against f64;
    Adam at lr 0.15 from 3.0 until the fidelity reaches 99 % (within 200
    steps, tests/test_docs.py's floor), one K1 and one K2 launch every
    step; K1/K2 against plain on every step of one epoch; the epoch's
    shares.  (b) the 4-qubit gate (nb = 16, C = 4): the same first step,
    kernels and shares."""
    from pulser_diff_torch.examples import gate_optimization as g

    out = {}
    label = "(a) 2-qubit gate"
    p0 = g.initial_params(g.N_PARAMS, g.P0, device)
    _, _, la, _ = _ex_first_step(torch, fe, label, lambda ps: 1.0 - g.gate_fidelity(ps, device),
                                 lambda ps: 1.0 - g.gate_fidelity(ps, device, fused=False), p0)
    steps = []

    def fidelity(ps):
        # the counts of the step before (its forward and its adjoint)
        if steps and dict(fe.LAUNCHES) != K1K2:
            raise RuntimeError(f"{label}: step {len(steps) - 1} launched {dict(fe.LAUNCHES)}")
        _reset(fe)
        steps.append(time.perf_counter())
        return g.gate_fidelity(ps, device)

    called = []

    def loop():
        called.append(time.perf_counter())
        return g.optimize(fidelity, p0, g.FLOOR_STEPS, lr=g.FLOOR_LR,
                          stop_at=1.0 - g.FLOOR_FIDELITY, log_every=0)

    loop_ms, run = _host_time_ms(torch, loop, 1)
    if dict(fe.LAUNCHES) != K1K2:
        raise RuntimeError(f"{label}: the last step launched {dict(fe.LAUNCHES)}")
    n, fid = len(run.losses), 1.0 - run.best
    gaps = np.diff(steps) * 1e3
    _log(f"  {label}: Adam at lr {g.FLOOR_LR} reached fidelity {fid!r} at step {n - 1} "
         f"({n} steps, one K1 and one K2 launch each; floor {g.FLOOR_FIDELITY} within "
         f"{g.FLOOR_STEPS}); {loop_ms:.1f} ms, of which {1e3 * (steps[0] - called[0]):.1f} "
         f"ms before the first step (the process's first torch.optim.Adam imports torch's "
         f"compiler stack); from one step's start to the next: first {gaps[0]:.1f}, median "
         f"{np.median(gaps):.1f}, max {gaps.max():.1f} ms")
    if fid < g.FLOOR_FIDELITY:
        raise RuntimeError(f"{label}: fidelity {fid} < {g.FLOOR_FIDELITY} in {n} steps")
    sub = [g.gate_emulator(p, g.COORDS, g.DURATION, device)._auto_substeps({})
           for p in (p0, run.params)]
    _log(f"  {label}: substeps {sub[0]} at the start, {sub[1]} at the last parameters")
    loss = lambda ps: 1.0 - g.gate_fidelity(ps, device)  # noqa: E731
    step_ms, _ = _host_time_ms(torch, lambda: _ex_value_and_grad(torch, loss, p0), 3)
    sim = g.gate_emulator(p0, g.COORDS, g.DURATION, device)
    ks = _fe_kernels(torch, fe, sim, sim._auto_substeps({}), device, gen, label, False, reps=5)
    out["gate"] = dict(ks=ks, launches=la, steps=n, fidelity=fid, loop_ms=loop_ms, **_ex_shares(
        torch, label, step_ms, lambda: g.gate_emulator(p0, g.COORDS, g.DURATION, device), ks))

    label = "(b) 4-qubit gate"
    p4 = g.initial_params(g.N_PARAMS4, g.P0_4, device)
    loss4 = lambda ps: 1.0 - g.gate_fidelity_4q(ps, device)  # noqa: E731
    _, _, la, _ = _ex_first_step(torch, fe, label, loss4,
                                 lambda ps: 1.0 - g.gate_fidelity_4q(ps, device, fused=False), p4)
    step_ms, _ = _host_time_ms(torch, lambda: _ex_value_and_grad(torch, loss4, p4), 3)
    sim = g.gate_emulator(p4, g.COORDS4, g.DURATION4, device)
    ks = _fe_kernels(torch, fe, sim, sim._auto_substeps({}), device, gen, label, False, reps=5)
    out["gate4"] = dict(ks=ks, launches=la, **_ex_shares(
        torch, label, step_ms, lambda: g.gate_emulator(p4, g.COORDS4, g.DURATION4, device), ks))
    return out


def _ex_preparation(torch, fe, device, gen, mod, label: str) -> dict:
    """(c) / (d) state preparation at 6 atoms (C = 8), the AFM preparation
    at 9 (C = 16): the first step against f64, P18_ADAM_STEPS Adam steps at the first stage's rate
    (counted, timed), K1/K2 against plain on the sweep's first
    PLAIN_STEPS steps, the epoch's shares."""
    from pulser_diff_torch.examples._common import adam

    p0 = mod.initial_params(device)
    loss = lambda ps: 1.0 - mod.fidelity(*ps, device)  # noqa: E731
    v, _, la, _ = _ex_first_step(torch, fe, label, loss,
                                 lambda ps: 1.0 - mod.fidelity(*ps, device, fused=False), p0)
    want = _times(K1K2, P18_ADAM_STEPS)
    (run, launches, ms) = _counted(torch, fe, f"{label}, Adam",
                                   lambda: adam(loss, p0, P18_ADAM_STEPS, mod.STAGES[0][0]), want)
    _log(f"  {label}: {P18_ADAM_STEPS} Adam steps at lr {mod.STAGES[0][0]} {ms:.1f} ms "
         f"({ms / P18_ADAM_STEPS:.2f} ms a step), launches {launches}; infidelity "
         f"{run.losses[0]!r} -> {run.losses[-1]!r}")
    sim = mod.emulator(*p0, device)
    ks = _fe_kernels(torch, fe, sim, sim._auto_substeps({}), device, gen, label, False,
                     n=PLAIN_STEPS, reps=5)
    return dict(ks=ks, launches=la, fidelity=1.0 - float(v), **_ex_shares(
        torch, label, ms / P18_ADAM_STEPS, lambda: mod.emulator(*p0, device), ks))


def _ex_multi_start(torch, fe, device) -> dict:
    """(e) multi_start at its CI sizes: fit_population's epochs + 1
    evaluations on the runs axis (one K1 launch each, one K2 launch each
    but the last); every candidate's first loss equal to its own
    evaluation; the loaded candidate's loss the least seen."""
    from pulser_diff_torch.examples import multi_start as m

    n_pop, epochs = m.CI_SIZES
    label = f"(e) multi_start, P = {n_pop}, {epochs} epochs"
    model = m.make_model(device)
    target = m.target_value(model)
    stack = m.initial_stack(n_pop)
    want = {"fused_fwd": epochs + 1, "fused_bwd": epochs, "fused_fwd_ckpt": 0,
            "fused_bwd_ckpt": 0}
    (losses, _), launches, ms = _counted(
        torch, fe, label, lambda: m.train(model, target, stack, epochs, epochs // 2), want)
    own = [(m.final_value(model, {k: torch.as_tensor(v[i], device=device)
                                  for k, v in stack.items()}) - target) ** 2
           for i in range(n_pop)]
    d_own = float(np.abs(np.asarray(own) - losses[0]).max())
    loaded = (m.final_value(model, dict(model.params)) - target) ** 2
    least = float(min(x.min() for x in losses))
    _log(f"  {label}: launches {launches}; {ms:.1f} ms, {ms / (epochs + 1):.2f} ms an "
         f"evaluation of {n_pop} candidates; first losses {losses[0].tolist()!r}, each against "
         f"its own evaluation max|d| {d_own:.3e}; final losses {losses[-1].tolist()!r}; loaded "
         f"{loaded!r} (least seen in the returned epochs {least!r})")
    if d_own > 1e-12 or loaded > least + 1e-12:
        raise RuntimeError(f"{label}: own evaluations {d_own:.3e}, loaded {loaded} > {least}")
    return {"epoch_ms": ms / (epochs + 1)}


def _ex_noisy(torch, fe, device) -> dict:
    """(f) noisy_simulation's Monte-Carlo run() at its CI sizes: one K1
    launch for all runs, the counts summing to runs x samples_per_run, the
    same seed the same counts."""
    from pulser_diff_torch.examples import noisy_simulation as ns

    s = ns.sizes(ci=True)
    label = f"(f) noisy_simulation Monte-Carlo, {s['mc_runs']} runs"
    counts, launches, ms = _counted(
        torch, fe, label, lambda: ns.monte_carlo(s["dur"], s["mc_runs"], device), FWD_ONLY)
    again = ns.monte_carlo(s["dur"], s["mc_runs"], device)
    _log(f"  {label}: launches {launches}; run() {ms:.1f} ms (first); counts {counts}; the same "
         f"seed again: {again == counts}")
    if sum(counts.values()) != s["mc_runs"] * 30 or again != counts:
        raise RuntimeError(f"{label}: counts {counts}, again {again}")
    return {"run_ms": ms}


def _ex_basic(torch, fe, device) -> dict:
    """(g) basic_usage: deriv_param on the default route (K1/K2, 601
    evaluation slots), the value within VALUE_TOL and the derivative
    within DERIV_REL_TOL relative of a central difference of the f64
    stepper; deriv_time (f64 stepper, no kernel) on the first
    P18_DERIV_TIMES evaluation times against central differences at three
    times inside the constant pulse (DERIV_REL_TOL).  The central
    differences run the same functions on the card machine's CPU: at dim
    4 the f64 stepper is bound by the host's dispatch of its small ops,
    which the CPU issues faster than the card."""
    from pulser_diff_torch.examples import basic_usage as b

    label = "(g) basic_usage"
    cpu = torch.device("cpu")
    (final, grad), launches, ms = _counted(torch, fe, label,
                                           lambda: b.magnetization_and_grad(device), K1K2)
    with torch.no_grad():
        lo, hi = (float(b.magnetization_trace(b.OMEGA + s * PARAM_EPS, cpu)[-1])
                  for s in (-1, 1))
    fd, mid = (hi - lo) / (2 * PARAM_EPS), (hi + lo) / 2
    dv, rel_p = abs(final - mid), abs(grad - fd) / abs(fd)
    _log(f"  {label}: launches {launches}; deriv_param {ms:.1f} ms (K1/K2); <M>(T) {final!r}, "
         f"the f64 stepper's {mid!r} (CPU, the mean of the central difference's two solves): "
         f"|dv| {dv:.3e} (tol {VALUE_TOL:.0e}); d<M>/d omega {grad!r}, the central difference "
         f"{fd!r}: rel {rel_p:.3e} (tol {DERIV_REL_TOL:.0e})")
    _reset(fe)
    dt_ms, dmdt = _host_time_ms(torch, lambda: b.time_derivative(device, P18_DERIV_TIMES), 1)
    _no_launch(fe, label)
    fn, t, _ = b.trace_of_times(cpu, P18_DERIV_TIMES)
    worst = 0.0
    with torch.no_grad():
        for i in P18_DERIV_INDICES:
            e = torch.zeros_like(t)
            e[i] = DERIV_EPS
            fd_t = float(fn(t + e).sum() - fn(t - e).sum()) / (2 * DERIV_EPS)
            rel = abs(float(dmdt[i]) - fd_t) / abs(fd_t)
            worst = max(worst, rel)
            _log(f"  {label}: t = {float(t[i]):.3f} us  deriv_time {float(dmdt[i])!r}  central "
                 f"difference {fd_t!r}  rel {rel:.3e}")
    _log(f"  {label}: deriv_time over {int(t.shape[0])} times {dt_ms:.1f} ms (f64 stepper on "
         f"the card); max|d<M>/dt| {float(dmdt.abs().max())!r}; worst rel {worst:.3e} (tol "
         f"{DERIV_REL_TOL:.0e})")
    if dv > VALUE_TOL or rel_p > DERIV_REL_TOL or worst > DERIV_REL_TOL:
        raise RuntimeError(f"{label}: |dv| {dv:.3e}, deriv_param rel {rel_p:.3e}, deriv_time "
                           f"rel {worst:.3e}")
    return {"deriv_param_ms": ms, "deriv_time_ms": dt_ms}


def _same_build(torch, a, b) -> list:
    """The names of the fields in which two emulators' built Hamiltonians,
    initial states or evaluation times differ (bit for bit)."""
    ha, hb = a._hamiltonian._ham_data, b._hamiltonian._ham_data
    pairs = {f: (getattr(ha, f), getattr(hb, f)) for f in ha._fields}
    pairs["initial_state"] = (a.initial_state, b.initial_state)
    pairs["eval_times"] = (a._eval_times_array, b._eval_times_array)
    leaves = lambda x: ([x.re, x.im] if hasattr(x, "re") else [x])  # noqa: E731
    differ = []
    for name, (x, y) in pairs.items():
        for u, w in zip(leaves(x), leaves(y)):
            same = (torch.equal(u, w) if isinstance(u, torch.Tensor)
                    else np.array_equal(np.asarray(u), np.asarray(w)))
            if not same:
                differ.append(name)
    return differ


def _ex_large(torch, fe, device) -> dict:
    """(h) large_scale at 18 atoms: its model built at the start knots
    equal bit for bit (Hamiltonian data, initial state, evaluation times)
    to bench.py's, whose value+grad phase 8 takes on the same default
    route (DP5_SE_F32, no fused launch), so its step is phase 8's; the
    f32 run()'s final norm within F32_VALUE_TOL of 1, no fused launch."""
    from pulser_diff_torch.examples import large_scale as ls

    n, dur, k = ls.sizes(ci=False)
    label = f"(h) large_scale, {n} atoms"
    model = ls.make_model(n, dur, k, device)
    amp = torch.as_tensor(ls.start_knots(k), dtype=torch.float64, device=device)
    bench, p_bench = _bench_model(torch, device, None, n_qubits=n)
    with torch.no_grad():
        differ = _same_build(torch, model._make_emulator({"amp_0": amp}),
                             bench._make_emulator({"amp_samples_0": torch.as_tensor(
                                 p_bench, dtype=torch.float64, device=device)}))
    del bench
    norm, launches, norm_ms = _counted(torch, fe, label, lambda: ls.f32_final_norm(model, amp),
                                       NO_LAUNCH)
    _log(f"  {label}: built as bench.py's model (phase 8's step): "
         f"{'yes' if not differ else 'no, ' + ', '.join(differ)}; f32 run() {norm_ms:.1f} ms, "
         f"launches {launches}, final norm {norm!r}")
    if differ or abs(norm - 1) > F32_VALUE_TOL:
        raise RuntimeError(f"{label}: built data differ in {differ}, norm {norm}")
    del model
    torch.cuda.empty_cache()
    return {"f32_run_ms": norm_ms}


def _examples_phase(torch, fe, device, gen):
    """Phase 18: (a)-(h), the example flows on the card.  Returns the
    kernels' entries of (a)-(d), their runs and the other sub-phases'
    times; each sub-phase's wall seconds are logged."""
    from pulser_diff_torch.examples import afm_preparation, state_preparation

    def wall(key, fn):
        t0 = time.perf_counter()
        out = fn()
        _log(f"  {key}: {time.perf_counter() - t0:.1f} s")
        return out

    runs = {**wall("(a) + (b)", lambda: _ex_gate(torch, fe, device, gen)),
            "state": wall("(c)", lambda: _ex_preparation(torch, fe, device, gen, state_preparation,
                                                        "(c) 6-atom state preparation")),
            "afm": wall("(d)", lambda: _ex_preparation(torch, fe, device, gen, afm_preparation,
                                                      "(d) 9-atom AFM preparation"))}
    times = {"multi_start": wall("(e)", lambda: _ex_multi_start(torch, fe, device)),
             "noisy": wall("(f)", lambda: _ex_noisy(torch, fe, device)),
             "basic": wall("(g)", lambda: _ex_basic(torch, fe, device)),
             "large": wall("(h)", lambda: _ex_large(torch, fe, device))}
    entries = []
    for key, what in (("gate", "2-qubit gate"), ("gate4", "4-qubit gate"),
                      ("state", "6-atom state preparation"), ("afm", "9-atom AFM")):
        r = runs[key]
        for name, e in r["ks"].items():
            src, line, kname = (("fused_evolution.cu", 594, "fused_fwd_kernel (K1)")
                                if name == "K1" else
                                ("fused_evolution.cu", 1026, "fused_bwd_kernel (K2)"))
            count = r["launches"]["fused_fwd" if name == "K1" else "fused_bwd"]
            entries.append(_entry(kname, src, line, count, e,
                                  f"example {what}, nb = {e['nb']}, {e['da']} x {e['db']}, "
                                  f"C = {e['C']}, {e['n_steps']} steps"))
    return entries, runs, times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pulser_diff_torch.ops import fused_evolution as fe
    from pulser_diff_torch.ops import kernel_build

    # true f32 products everywhere (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(f"phase 1 device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
         f"cuda {torch.version.cuda}")

    # 2. build, both sources at once
    t0 = time.perf_counter()
    reports = kernel_build.build_all(("fused_evolution", "fused_ckpt"))
    fe._library()
    fe._ckpt_library()
    _log(f"phase 2 build: fused_evolution.cu and fused_ckpt.cu in "
         f"{time.perf_counter() - t0:.1f} s")
    for src, report in reports.items():
        for mangled, (regs, st, ld) in _ptxas_summary(report).items():
            kname = _instantiation(mangled)
            _log(f"  ptxas [{src}] {kname}: {regs} registers, spill stores {st} B, spill loads "
                 f"{ld} B")
            if src == "fused_ckpt" and (st or ld):
                raise RuntimeError(f"{kname} spills {st} / {ld} bytes")

    # 3. kernels against their plain versions
    _log("phase 3 kernels vs plain versions")
    fused_model, p0 = _bench_model(torch, device, fused=True)
    substeps = fused_model._default_substeps()
    with torch.no_grad():
        sim = fused_model._make_emulator(dict(fused_model.params))
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, substeps, device)
    plan12 = _log_plan(fe, fe._library(), data, "DP5", "12 atoms (main path)")
    main_plain: dict = {}  # the plain versions' times (once), reported in phase 7
    k1_err, k2_err, _, (st_re, st_im, lam_re, lam_im) = _check_kernels(
        torch, fe, data, slots, n_eval, last_slot, "DP5", gen, "12 atoms (main path)",
        main_plain)
    _two_k2_runs(torch, fe, data, slots, n_eval, last_slot, (st_re, st_im, lam_re, lam_im),
                 "12 atoms")
    small = []
    for label, small_sim, method in _small_cases(torch, device):
        sd, ss, sn, sl = _kernel_inputs(torch, small_sim, 1, device, method)
        _log_plan(fe, fe._library(), sd, method, label)
        _check_kernels(torch, fe, sd, ss, sn, sl, method, gen, label)
        small.append((label, sd, method, ss, sn, sl))
    # K4 runs K1's arithmetic: its states at the slots equal K1's
    ck_re, ck_im = fe.fused_fwd_ckpt(data, "DP5")
    k1_re, k1_im = fe.fused_fwd(data, "DP5", slots, n_eval)
    g_of = {int(s): g for g, s in enumerate(slots.tolist()) if s < n_eval}
    k4_vs_k1 = max(max(_max_err(ck_re[:, g - 1], k1_re[:, s]), _max_err(ck_im[:, g - 1], k1_im[:, s]))
                   for s, g in g_of.items() if g > 0)
    _log(f"  12 atoms: K4 vs K1 at the evaluation slots max|diff| {k4_vs_k1:.3e}")
    if k4_vs_k1 > K1_TOL:
        raise RuntimeError(f"K4 vs K1 {k4_vs_k1:.3e} > {K1_TOL:.0e}")
    del ck_re, ck_im, k1_re, k1_im
    for label, sd, method, *_ in small:
        _check_ckpt(torch, fe, sd, method, gen, label)
    label, sd, method, ss, sn, sl = small[1]
    _check_ckpt(torch, fe, _two_runs(torch, fe, sd), method, gen, f"{label} R=2")
    # two runs: two clusters, one per run (cotangents of their own draw, so
    # the later checks keep theirs)
    _check_kernels(torch, fe, _two_runs(torch, fe, sd), ss, sn, sl, method,
                   torch.Generator().manual_seed(SEED + 1), f"{label} R=2")
    # shared memory bounds nb * da * db: at 12 atoms a batch of 4 states
    # must be refused, naming nb = 3 as the largest that fits and ckpt=True
    batch4 = {**data, "psi_re": data["psi_re"].repeat(1, 4, 1, 1),
              "psi_im": data["psi_im"].repeat(1, 4, 1, 1)}
    try:
        fe.fused_fwd(batch4, "DP5", slots, n_eval)
    except ValueError as exc:
        if "up to nb=3" not in str(exc) or "ckpt=True" not in str(exc):
            raise
        _log(f"  12 atoms nb=4 refused as expected: {exc}")
    else:
        raise RuntimeError("12 atoms nb=4: the kernel accepted more shared memory than it has")
    # 14 atoms: K1 refuses even one state; the default routing runs it on
    # K4/K5, as the JAX package runs it with default options
    m14, _ = _bench_model(torch, device, fused=None, n_qubits=14)
    with torch.no_grad():
        sim14 = m14._make_emulator(dict(m14.params))
    d14, s14, n14, _ = _kernel_inputs(torch, sim14, m14._default_substeps(), device)
    try:
        fe.fused_fwd(d14, "DP5", s14, n14)
    except ValueError as exc:
        if "ckpt=True" not in str(exc):
            raise
        _log(f"  14 atoms refused by K1 as expected: {exc}")
    else:
        raise RuntimeError("14 atoms: K1 accepted more shared memory than it has")
    _check_ckpt(torch, fe, d14, "DP5", gen, "14 atoms")
    _ckpt_plans(torch, fe, d14, "14 atoms")
    _reset(fe)
    v14, g14, _ = _value_and_grad(torch, m14, p0, device)
    torch.cuda.synchronize()
    launches14 = dict(fe.LAUNCHES)
    if launches14 != {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 1, "fused_bwd_ckpt": 1}:
        raise RuntimeError(f"14 atoms (default routing): launches {launches14}")
    if not (torch.isfinite(v14) and torch.isfinite(g14).all()):
        raise RuntimeError(f"14 atoms: value {v14}, grad {g14}")
    f64_14, _ = _bench_model(torch, device, fused=False, n_qubits=14)
    v64_14, g64_14, _ = _value_and_grad(torch, f64_14, p0, device)
    _log(f"  14 atoms value+grad with default options: launches {launches14}")
    _hold_against_f64(torch, v14, g14, v64_14, g64_14, "14 atoms")
    del d14, sim14, m14, f64_14

    # 16-atom main-path shapes (the default routing)
    model16, _ = _bench_model(torch, device, fused=None, n_qubits=16)
    substeps16 = model16._default_substeps()
    with torch.no_grad():
        sim16 = model16._make_emulator(dict(model16.params))
    d16, _, _, _ = _kernel_inputs(torch, sim16, substeps16, device)
    del sim16
    k4_err, k5_err, _, (st16_re, st16_im, lam16_re, lam16_im) = _check_ckpt(
        torch, fe, d16, "DP5", gen, "16 atoms (main path)", main_plain)
    plans16 = _ckpt_plans(torch, fe, d16, "16 atoms")
    _two_k5_runs(torch, fe, d16, (st16_re, st16_im, lam16_re, lam16_im), "16 atoms")
    # the kron-pair branches (K3) at the XY shapes (after the ising checks,
    # whose random cotangents stay the draws they were)
    xy = _xy_kernel_phase(torch, fe, device, gen)

    # 4. the 12-atom main path: counts reset just before, read just after
    _log("phase 4 main path: 12-atom value+grad through QuantumModel")
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value, grad, vals = _value_and_grad(torch, fused_model, p0, device)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    launches = dict(fe.LAUNCHES)
    if launches != {"fused_fwd": 1, "fused_bwd": 1, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}:
        raise RuntimeError(f"expected one K1 and one K2 launch per step, got {launches}")
    if vals.shape != (2,) or not torch.isfinite(vals).all() or not torch.isfinite(grad).all():
        raise RuntimeError(f"bad main-path output: values {vals}, grad {grad}")
    f64_model, _ = _bench_model(torch, device, fused=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v64, g64, _ = _value_and_grad(torch, f64_model, p0, device)
    torch.cuda.synchronize()
    f64_step_ms = (time.perf_counter() - t0) * 1e3
    _log(f"  n_steps {int(data['hs'].shape[0])}, substeps {substeps}, launches {launches}")
    _hold_against_f64(torch, value, grad, v64, g64, "12 atoms")
    del f64_model

    # 5. the 16-atom main path: counts reset just before, read just after
    _log("phase 5 main path: 16-atom value+grad through QuantumModel (default routing)")
    _reset(fe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value16, grad16, vals16 = _value_and_grad(torch, model16, p0, device)
    torch.cuda.synchronize()
    first16_s = time.perf_counter() - t0
    launches16 = dict(fe.LAUNCHES)
    if launches16 != {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 1, "fused_bwd_ckpt": 1}:
        raise RuntimeError(f"expected one K4 and one K5 launch and no K1/K2, got {launches16}")
    if vals16.shape != (2,) or not torch.isfinite(vals16).all() or not torch.isfinite(grad16).all():
        raise RuntimeError(f"bad 16-atom output: values {vals16}, grad {grad16}")
    f64_16, _ = _bench_model(torch, device, fused=False, n_qubits=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v64_16, g64_16, _ = _value_and_grad(torch, f64_16, p0, device)
    torch.cuda.synchronize()
    f64_16_ms = (time.perf_counter() - t0) * 1e3
    f64_16_peak = torch.cuda.max_memory_allocated() / 2**30
    del f64_16
    _log(f"  n_steps {int(d16['hs'].shape[0])}, substeps {substeps16}, launches {launches16}, "
         f"K4 grid {fe.ckpt_blocks(d16, False)} blocks, K5 grid {fe.ckpt_blocks(d16, True)} blocks, "
         f"{plans16['K4']['barriers_per_step']} / {plans16['K5']['barriers_per_step']} grid "
         f"barriers per step")
    _log(f"  f64 stepper value+grad {f64_16_ms:.1f} ms (once), peak device memory "
         f"{f64_16_peak:.2f} GiB")
    _hold_against_f64(torch, value16, grad16, v64_16, g64_16, "16 atoms")

    # 6. the 12-atom XY main path: counts reset just before, read just after
    _log("phase 6 main path: 12-atom XY value+grad (parameters and q1's coordinates) "
         "through QuantumModel (default routing)")
    xy_step = _xy_step_phase(torch, fe, device, xy)

    # 7. times
    _log("phase 7 times (CUDA events, warm medians)")
    n_kernel = 10
    k1_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd(data, "DP5", slots, n_eval), n_kernel)
    k2_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd(
        data, "DP5", slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im), n_kernel)
    k4_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(d16, "DP5"), n_kernel)
    k5_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd_ckpt(
        d16, "DP5", st16_re, st16_im, lam16_re, lam16_im), n_kernel)
    # the plain versions ran once in phase 3 (host-bound loops of small
    # launches, seconds each), on the same inputs
    k1_plain_ms, k2_plain_ms = main_plain["k1_plain"], main_plain["k2_plain"]
    k4_plain_ms, k5_plain_ms = main_plain["k4_plain"], main_plain["k5_plain"]
    step_ms, _ = _host_time_ms(torch, lambda: _value_and_grad(torch, fused_model, p0, device), 5)
    step16_ms, _ = _host_time_ms(torch, lambda: _value_and_grad(torch, model16, p0, device), 5)
    S = 6
    k2_out = fe.fused_bwd(data, "DP5", slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im)
    k5_out = fe.fused_bwd_ckpt(d16, "DP5", st16_re, st16_im, lam16_re, lam16_im)
    k1_bound, k1_by = _bound_ms(fe, data, slots, (st_re, st_im), S, "fwd")
    k2_bound, k2_by = _bound_ms(fe, data, slots, (st_re, st_im, lam_re, lam_im, *k2_out),
                                S, "bwd")
    k4_bound, k4_by = _bound_ms(fe, d16, None, (st16_re, st16_im), S, "fwd_ckpt")
    k5_bound, k5_by = _bound_ms(fe, d16, None, (st16_re, st16_im, lam16_re, lam16_im, *k5_out),
                                S, "bwd_ckpt")
    _log(f"  K1 {k1_ms:.3f} ms on {plan12['K1']['C']} blocks (plain {k1_plain_ms:.1f} ms, bound "
         f"{k1_bound:.4f} ms by {k1_by})")
    _log(f"  K2 {k2_ms:.3f} ms on {plan12['K2']['C']} blocks (plain {k2_plain_ms:.1f} ms, bound "
         f"{k2_bound:.4f} ms by {k2_by})")
    _log(f"  K4 {k4_ms:.3f} ms (plain {k4_plain_ms:.1f} ms, bound {k4_bound:.4f} ms by {k4_by})")
    _log(f"  K5 {k5_ms:.3f} ms (plain {k5_plain_ms:.1f} ms, bound {k5_bound:.4f} ms by {k5_by})")
    _log(f"  12-atom value+grad step {step_ms:.2f} ms (first {first_step_s * 1e3:.1f} ms); "
         f"f64 stepper step {f64_step_ms:.1f} ms (once)")
    _log(f"  16-atom value+grad step {step16_ms:.2f} ms (first {first16_s * 1e3:.1f} ms); "
         f"f64 stepper step {f64_16_ms:.1f} ms (once)")
    # the XY kernels (K = 8) at the 12-atom XY shapes; their plain versions
    # ran once in phase 3 (Python loops of small launches, ~3 s and ~15 s)
    xd, xs, xn, xl = xy["data"], xy["slots"], xy["n_eval"], xy["last_slot"]
    n_xy = 5
    k1x_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd(xd, "DP5", xs, xn, lo=True), n_xy)
    k2x_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd(xd, "DP5", xs, xn, xl, *xy["k2_in"]), n_xy)
    k4x_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(xd, "DP5", lo=True), n_xy)
    k5x_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd_ckpt(xd, "DP5", *xy["k5_in"]), n_xy)
    stepx_ms, _ = _host_time_ms(
        torch, lambda: _xy_value_and_grad(torch, xy["model"], xy["c1"], device), n_xy)
    k2x_out = fe.fused_bwd(xd, "DP5", xs, xn, xl, *xy["k2_in"])
    k1x_bound, k1x_by = _bound_ms(fe, xd, xs, fe.fused_fwd(xd, "DP5", xs, xn, lo=True), S, "fwd")
    k2x_bound, k2x_by = _bound_ms(fe, xd, xs, (*xy["k2_in"], *k2x_out), S, "bwd")
    k4x_bound, _ = _bound_ms(fe, xd, None, fe.fused_fwd_ckpt(xd, "DP5", lo=True), S, "fwd_ckpt")
    k5x_out = fe.fused_bwd_ckpt(xd, "DP5", *xy["k5_in"])
    k5x_bound, _ = _bound_ms(fe, xd, None, (*xy["k5_in"], *k5x_out), S, "bwd_ckpt")
    plain = xy["plain"]
    _log(f"  K1 XY (K3 branch, K = {fe._n_kron(xd)}) {k1x_ms:.3f} ms on "
         f"{xy['plan']['K1']['C']} blocks (plain "
         f"{plain['k1_plain']:.1f} ms once, bound {k1x_bound:.4f} ms by {k1x_by})")
    _log(f"  K2 XY (K3 branch) {k2x_ms:.3f} ms on {xy['plan']['K2']['C']} blocks (plain "
         f"{plain['k2_plain']:.1f} ms once, "
         f"bound {k2x_bound:.4f} ms by {k2x_by})")
    _log(f"  K4 / K5 XY (ckpt=True shapes) {k4x_ms:.3f} / {k5x_ms:.3f} ms on "
         f"{fe.ckpt_blocks(xd, False)} / {fe.ckpt_blocks(xd, True)} blocks (plain "
         f"{plain['k4_plain']:.1f} / {plain['k5_plain']:.1f} ms once, bounds "
         f"{k4x_bound:.4f} / {k5x_bound:.4f} ms)")
    _log(f"  12-atom XY value+grad step {stepx_ms:.2f} ms (first {xy_step['first_ms']:.1f} ms); "
         f"f64 stepper step {xy_step['f64_ms']:.1f} ms (once, peak {xy_step['f64_peak']:.2f} GiB)")

    # 8. 18 atoms: the f32 route (counts reset just before, read just after)
    _log("phase 8 18 atoms: bench.py's value+grad on the default route (DP5_SE_F32), against "
         "the f64 stepper; with TF32 allowed; with remat=True; with fused=True (K4/K5)")
    big = _phase_18(torch, fe, device, p0, gen)

    # 9. population (bench_population.py): the candidates on the runs axis
    _log(f"phase 9 population: {POP_12} candidates at 12 atoms (K1/K2), {POP_16} at 16 atoms "
         "(K4/K5), through expectation_population_fn")
    pop12 = _population_phase(torch, fe, device, p0, gen, 12, POP_12)
    pop16 = _population_phase(torch, fe, device, p0, gen, 16, POP_16)

    # 10. 14- and 16-atom XY: K3 on its default route (K4/K5 with kron pairs)
    _log("phase 10 14- and 16-atom XY value+grad (parameters and q1's coordinates), default "
         "routing")
    xy14 = _xy_ckpt_phase(torch, fe, device, 14)
    xy16 = _xy_ckpt_phase(torch, fe, device, 16)
    _log(f"  18 atoms f32 route step {big['step_ms']:.2f} ms, f64 {big['f64_ms']:.1f} ms; "
         f"XY steps {xy14['step_ms']:.2f} ms (14 atoms), {xy16['step_ms']:.2f} ms (16 atoms)")

    # 11. the noisy Monte-Carlo batch (bench_mc.py) through run()
    _log("phase 11 noisy Monte-Carlo run(): doppler + amplitude at 12 atoms R = 1, 8, 32 (K1), "
         f"16 atoms R = {MC_16} and 18 atoms R = {MC_18} (K4); wide parts; SPAM; the sampler")
    mc = _mc_phase(torch, fe, device, gen)
    _log("  run() ms: " + ", ".join(f"{k}: {v:.2f}" for k, v in mc["run_ms"].items()))

    # 12. the Lindblad path (bench_mesolve.py), no kernel on it
    _log("phase 12 Lindblad: 10-atom value+grad through QuantumModel (DP5_ME, dense form) vs "
         "the factored form and DP5_ME_F32; 3-atom rate gradient; 12-atom run() (factored); "
         "8-atom dephasing + doppler run()")
    me = _lindblad_phase(torch, fe, device)
    # 13. quantum-jump trajectories (bench_mcwf.py), no kernel on it
    _log("phase 13 MCWF: 3-atom populations vs DP5_ME; 12-atom MCWF_F32 run(); 10-atom "
         "expectation_mcwf_fn value+grad vs DP5_ME")
    mcwf = _mcwf_phase(torch, fe, device)
    _log("  ms: " + ", ".join(f"{k}: {v:.1f}" for k, v in {**me, **mcwf}.items()
                              if k.endswith("_ms")))
    # 14. training: the noisy models' steps past 8 parts, fit, fit_population,
    # durations, a noisy fit
    _log("phase 14 training: noisy 12-atom (K1/K2) and 16-atom (K4/K5) value+grad vs f64 on "
         "one draw; fit, fit_population, duration optimisation and a noisy fit at 12 atoms")
    train = _training_phase(torch, fe, device, p0, gen)
    _log(f"  fit {train['epoch_ms']:.2f} ms an epoch; fit_population {train['pop_eval_ms']:.2f} "
         f"ms an evaluation; noisy steps {train['K2']['step_ms']:.2f} ms (12 atoms), "
         f"{train['K5']['step_ms']:.2f} ms (16 atoms)")

    # 15. the rest of the front end: local channels, modulation and EOM,
    # the SLM mask's doubled kron pairs
    _log("phase 15 front end: (a) 12-atom global + local channels value+grad (K1/K2; K4/K5 "
         "with ckpt=True), (b) 12-atom modulated run() with an EOM block (K1), (c) 12-atom XY "
         "under an SLM mask (K1/K2), (d) 16-atom XY under an SLM mask (K4/K5)")
    front = _front_end_phase(torch, fe, device, gen)

    # 16. the other bases: the all basis at da = 3^a (K1/K2 at C = 1, K4/K5),
    # the digital basis, leakage, the time derivatives
    _log(f"phase 16 other bases: all-basis value+grad at {ALL_SMALL_N} / {ALL_K1K2_N} atoms "
         f"(K1/K2, C = 1; K4/K5 with ckpt=True), {ALL_REFUSED_N} / {ALL_BIG_N} atoms (K4/K5), "
         f"the digital basis at {N_QUBITS} atoms (K1/K2), leakage at {LEAK_N} atoms, time "
         "derivatives")
    bases, bases_ms = _bases_phase(torch, fe, device, gen)
    _log("  ms: " + ", ".join(f"{k}: {v:.1f}" for k, v in bases_ms.items()))

    # 17. the Krylov and adaptive steppers (no kernel), and the final-state
    # form of the fused kernels
    _log(f"phase 17 solvers: (a) {N_QUBITS}-atom value+grad at {P17_DURATION} ns under "
         "KRYLOV_SE, DP5_SE_ADAPTIVE, KRYLOV_SE_F32 (no kernel) against the same call on the "
         "CPU and against KRYLOV_SE; (b) pallas_evolve at 12 atoms (K1/K2), 16 atoms ckpt=True "
         "(K4/K5), 12-atom XY (K1/K2 with kron pairs)")
    solvers_ms = _solvers_phase(torch, fe, device)
    _log("  ms: " + ", ".join(f"{k}: {v:.1f}" for k, v in solvers_ms.items()))
    final = _final_state_phase(torch, fe, device, gen)

    # 18. the example flows (pulser_diff_torch/examples), each on its
    # default route
    _log("phase 18 examples: (a) 2-qubit gate to 99 % (K1/K2, nb = 4), (b) 4-qubit gate (nb = "
         "16), (c) 6-atom state preparation, (d) 9-atom AFM preparation, (e) multi_start, (f) "
         "noisy_simulation's Monte-Carlo run(), (g) basic_usage's derivatives, (h) large_scale "
         "at 18 atoms")
    examples, _, examples_ms = _examples_phase(torch, fe, device, gen)
    _log("  ms: " + ", ".join(f"{k}.{n}: {v:.1f}" for k, d in examples_ms.items()
                              for n, v in d.items()))

    def entry(kname, src, replaces, count, err, ms, plain_ms, bound, by):
        return {"name": kname, "route": "cuda", "source": f"pulser_diff_torch/csrc/{src}",
                "replaces": f"pulser_diff_tpu/ops/pallas_evolution.py:{replaces}",
                "launches": count, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}

    kernels = [
        entry("fused_fwd_kernel (K1)", "fused_evolution.cu", 594, launches["fused_fwd"],
              k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by),
        entry("fused_bwd_kernel (K2)", "fused_evolution.cu", 1026, launches["fused_bwd"],
              k2_err, k2_ms, k2_plain_ms, k2_bound, k2_by),
        entry("fused_fwd_ckpt_kernel (K4)", "fused_ckpt.cu", 1479, launches16["fused_fwd_ckpt"],
              k4_err, k4_ms, k4_plain_ms, k4_bound, k4_by),
        entry("fused_bwd_ckpt_kernel (K5)", "fused_ckpt.cu", 1511, launches16["fused_bwd_ckpt"],
              k5_err, k5_ms, k5_plain_ms, k5_bound, k5_by),
        # the kron-pair branch (K3), timed in K1 and K2 at the 12-atom XY
        # shapes (K = 8); launches from the XY main path's run
        entry("fused_fwd_kernel kron-pair branch (K3 in K1, K = 8)", "fused_evolution.cu", 248,
              xy_step["launches"]["fused_fwd"], xy["k1_err"], k1x_ms, plain["k1_plain"],
              k1x_bound, k1x_by),
        entry("fused_bwd_kernel kron-pair branch (K3 in K2, K = 8)", "fused_evolution.cu", 699,
              xy_step["launches"]["fused_bwd"], xy["k2_err"], k2x_ms, plain["k2_plain"],
              k2x_bound, k2x_by),
    ]
    # the runs axis (population; its plain versions timed on the first
    # PLAIN_STEPS steps) and K4/K5 at 18 atoms (fused=True); each with the
    # launches of its own path's run
    cut = f"(plain_ms: first {PLAIN_STEPS} steps)"
    for kname, src, replaces, e in (
        (f"fused_fwd_kernel (K1), population R = {POP_12} {cut}", "fused_evolution.cu", 594,
         pop12[0]),
        (f"fused_bwd_kernel (K2), population R = {POP_12} {cut}", "fused_evolution.cu", 1026,
         pop12[1]),
        (f"fused_fwd_ckpt_kernel (K4), population R = {POP_16} {cut}", "fused_ckpt.cu", 1479,
         pop16[0]),
        (f"fused_bwd_ckpt_kernel (K5), population R = {POP_16} {cut}", "fused_ckpt.cu", 1511,
         pop16[1]),
        ("fused_fwd_ckpt_kernel (K4), 18 atoms fused=True", "fused_ckpt.cu", 1479, big["K4"]),
        ("fused_bwd_ckpt_kernel (K5), 18 atoms fused=True", "fused_ckpt.cu", 1511, big["K5"]),
    ):
        kernels.append(entry(kname, src, replaces, e["launches"], e["err"], e["ms"],
                             e["plain_ms"], e["bound"], e["by"]))
    # the adjoints past 8 parts on the noisy models' steps (phase 14), their
    # plain versions timed on the first PLAIN_STEPS steps
    for kname, src, replaces, e in (
        ("fused_bwd_kernel (K2), noisy 12 atoms", "fused_evolution.cu", 1026, train["K2"]),
        ("fused_bwd_ckpt_kernel (K5), noisy 16 atoms", "fused_ckpt.cu", 1511, train["K5"]),
    ):
        kernels.append(entry(f"{kname}, pr = pc = {e['pr']} (plain_ms: first {PLAIN_STEPS} "
                             "steps)", src, replaces, e["launches"], e["err"], e["ms"],
                             e["plain_ms"], e["bound"], e["by"]))
    # the noisy batch: the kernel on all R runs, its plain version timed on
    # the runs it was held against (named)
    for kname, src, replaces, e in mc["kernels"]:
        kernels.append(entry(f"{kname} (plain_ms: {e['plain_runs']} run(s))", src, replaces,
                             e["launches"], e["err"], e["ms"], e["plain_ms"], e["bound"],
                             e["by"]))
    for kname, src, replaces, count, e in front + bases + final + examples:
        kernels.append(entry(kname, src, replaces, count, e["err"], e["ms"], e["plain_ms"],
                             e["bound"], e["by"]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pulser_diff_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the hand-written kernels, from csrc/, into the ignored build
     directory;
  3. kernels against their plain PyTorch versions on the card: K1
     (fused_fwd_kernel) on every evaluation-slot state and K2
     (fused_bwd_kernel) on lam0, every stream cotangent and dbar, at the
     main path's shapes and at small shapes that cover the direct form,
     da != db, a state batch and the RK4 tableau;
  4. the main path: the 12-atom, 8-parameter value-and-gradient step of
     bench.py through QuantumModel.expectation_fn and torch.autograd, held
     against the port's f64 stepper on the card (1e-6 on the value, 1e-5
     on the gradient) with exactly one K1 and one K2 launch per step;
  5. times: each kernel's warm median (CUDA events) beside its plain
     version's time and its bound, the value+grad step, the f64 step.

The last two lines are one JSON object per kernel list and the result
line {"ok": true, "device": {...}}.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version, both f32 on the card in a different summation
# order: K1 states are unit-norm, ~1000 dependent stages of ~6e-8
# rounding random-walk to ~2e-6, so 1e-5 absolute; K2 outputs are sums
# over up to da*db*nb terms per stage, so 1e-4 relative to the largest
# magnitude of each output
K1_TOL = 1e-5
K2_TOL_REL = 1e-4
# the BASELINE bars of the fused f32 path against the f64 path
VALUE_TOL = 1e-6
GRAD_TOL = 1e-5


def _log(msg: str) -> None:
    print(msg, flush=True)


def _bench_model(torch, device, fused: bool, n_qubits: int = N_QUBITS,
                 duration: int = DURATION):
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
        fused=fused,
    )
    return model, p0


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


def _check_kernels(torch, fe, data, slots, n_eval, last_slot, method, gen, label):
    """K1 and K2 against their plain versions on the same inputs; returns
    (k1 max abs err, k2 max abs err, k2 max relative err, inputs of K2)."""
    out_re, out_im = fe.fused_fwd(data, method, slots, n_eval)
    ref_re, ref_im = fe.fused_fwd_plain(data, method, slots, n_eval)
    torch.cuda.synchronize()
    k1_err = max(_max_err(out_re, ref_re), _max_err(out_im, ref_im))
    if not (torch.isfinite(out_re).all() and torch.isfinite(out_im).all()):
        raise RuntimeError(f"{label}: K1 produced non-finite states")
    if k1_err > K1_TOL:
        raise RuntimeError(f"{label}: K1 vs plain {k1_err:.3e} > {K1_TOL:.0e}")
    shape = tuple(ref_re.shape)
    lam_re = torch.randn(shape, generator=gen, dtype=torch.float32).to(ref_re.device)
    lam_im = torch.randn(shape, generator=gen, dtype=torch.float32).to(ref_re.device)
    got = fe.fused_bwd(data, method, slots, n_eval, last_slot, ref_re, ref_im, lam_re, lam_im)
    want = fe.fused_bwd_plain(data, method, slots, n_eval, last_slot,
                              ref_re, ref_im, lam_re, lam_im)
    torch.cuda.synchronize()
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    pairs = [("lam0_re", got[0], want[0]), ("lam0_im", got[1], want[1]), ("dbar", got[3], want[3])]
    names = ("zbar_rr", "zbar_ri", "zbar_cr", "zbar_ci")
    pairs += list(zip(names, fe._unpack_zbar(got[2], pr, pc), fe._unpack_zbar(want[2], pr, pc)))
    k2_abs = k2_rel = 0.0
    for name, g, w in pairs:
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{label}: K2 {name} is not finite")
        err = _max_err(g, w)
        rel = err / max(float(w.abs().max()), 1e-30)
        k2_abs, k2_rel = max(k2_abs, err), max(k2_rel, rel)
        if rel > K2_TOL_REL:
            raise RuntimeError(f"{label}: K2 {name} vs plain rel {rel:.3e} > {K2_TOL_REL:.0e}")
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


def _host_time_ms(torch, fn, n: int) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound_ms(fe, data, slots, others, S: int, bwd: bool) -> tuple[float, str]:
    """Least time for the work: the bytes of every input read once and
    every output written once over the HBM rate, against the products'
    f32 operations over the non-tensor f32 rate; the larger of the two.
    ``others``: the kernel's tensors outside ``data`` (states, slot
    cotangents, outputs)."""
    R, nb, da, db = (int(v) for v in data["psi_re"].shape)
    n_steps = int(data["hs"].shape[0])
    # 8 real products per application of -iH (4 row-side, 4 column-side)
    apply_flops = 2 * 4 * nb * (da * da * db + da * db * db)
    shared = ("rp", "cp", "hb_hi", "hb_lo", "hs", "diag", "diag_lo") + fe._ZF_KEYS
    if not bwd:
        flops = R * n_steps * S * apply_flops
        inputs = [data[k] for k in shared + ("psi_re", "psi_im")]
    else:
        # per step: S mirror + (S - 1) forward + S transpose applications,
        # and per stage the 8 outer products of (W, V, Wc, Vc)
        outer_flops = 2 * 4 * nb * (da * da * db + db * db * da)
        flops = R * n_steps * ((3 * S - 1) * apply_flops + S * outer_flops)
        inputs = [data[k] for k in shared + fe._ZB_KEYS]
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, slots, *others))
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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

    # 2. build
    t0 = time.perf_counter()
    report = kernel_build.build("fused_evolution")
    fe._library()
    _log(f"phase 2 build: fused_evolution.cu in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill", "smem")):
            _log(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    _log("phase 3 kernels vs plain versions")
    fused_model, p0 = _bench_model(torch, device, fused=True)
    substeps = fused_model._default_substeps()
    with torch.no_grad():
        sim = fused_model._make_emulator(dict(fused_model.params))
    data, slots, n_eval, last_slot = _kernel_inputs(torch, sim, substeps, device)
    k1_err, k2_err, _, (st_re, st_im, lam_re, lam_im) = _check_kernels(
        torch, fe, data, slots, n_eval, last_slot, "DP5", gen, "12 atoms (main path)")
    for label, small_sim, method in _small_cases(torch, device):
        sd, ss, sn, sl = _kernel_inputs(torch, small_sim, 1, device, method)
        _check_kernels(torch, fe, sd, ss, sn, sl, method, gen, label)
    # shared memory bounds nb * da * db: at 12 atoms a batch of 4 states
    # must be refused, naming nb = 3 as the largest that fits
    batch4 = {**data, "psi_re": data["psi_re"].repeat(1, 4, 1, 1),
              "psi_im": data["psi_im"].repeat(1, 4, 1, 1)}
    try:
        fe.fused_fwd(batch4, "DP5", slots, n_eval)
    except ValueError as exc:
        if "up to nb=3" not in str(exc):
            raise
        _log(f"  12 atoms nb=4 refused as expected: {exc}")
    else:
        raise RuntimeError("12 atoms nb=4: the kernel accepted more shared memory than it has")

    # 4. the main path: counts reset just before, read just after
    _log("phase 4 main path: 12-atom value+grad through QuantumModel")
    for k in fe.LAUNCHES:
        fe.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value, grad, vals = _value_and_grad(torch, fused_model, p0, device)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    launches = dict(fe.LAUNCHES)
    if launches != {"fused_fwd": 1, "fused_bwd": 1}:
        raise RuntimeError(f"expected one K1 and one K2 launch per step, got {launches}")
    if vals.shape != (2,) or not torch.isfinite(vals).all() or not torch.isfinite(grad).all():
        raise RuntimeError(f"bad main-path output: values {vals}, grad {grad}")
    f64_model, _ = _bench_model(torch, device, fused=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v64, g64, _ = _value_and_grad(torch, f64_model, p0, device)
    torch.cuda.synchronize()
    f64_step_ms = (time.perf_counter() - t0) * 1e3
    dv = abs(float(value) - float(v64))
    dg = float((grad - g64).abs().max())
    _log(f"  n_steps {int(data['hs'].shape[0])}, substeps {substeps}, launches {launches}")
    _log(f"  value {float(value)!r}  f64 {float(v64)!r}  |dv| {dv:.3e} (tol {VALUE_TOL:.0e})")
    _log(f"  grad  {grad.cpu().numpy().tolist()!r}")
    _log(f"  f64   {g64.cpu().numpy().tolist()!r}  max|dg| {dg:.3e} (tol {GRAD_TOL:.0e})")
    if dv > VALUE_TOL or dg > GRAD_TOL:
        raise RuntimeError(f"fused path vs f64 stepper: |dv| {dv:.3e}, |dg| {dg:.3e}")

    # 5. times
    _log("phase 5 times (CUDA events, warm medians)")
    n_kernel = 10
    k1_ms = _cuda_time_ms(torch, lambda: fe.fused_fwd(data, "DP5", slots, n_eval), n_kernel)
    k1_plain_ms = _cuda_time_ms(
        torch, lambda: fe.fused_fwd_plain(data, "DP5", slots, n_eval), 3)
    k2_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd(
        data, "DP5", slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im), n_kernel)
    k2_plain_ms = _cuda_time_ms(torch, lambda: fe.fused_bwd_plain(
        data, "DP5", slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im), 3)
    step_ms = _host_time_ms(torch, lambda: _value_and_grad(torch, fused_model, p0, device), 5)
    S = 6
    k2_out = fe.fused_bwd(data, "DP5", slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im)
    k1_bound, k1_by = _bound_ms(fe, data, slots, (st_re, st_im), S, bwd=False)
    k2_bound, k2_by = _bound_ms(fe, data, slots, (st_re, st_im, lam_re, lam_im, *k2_out),
                                S, bwd=True)
    _log(f"  K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.1f} ms, bound {k1_bound:.4f} ms by {k1_by})")
    _log(f"  K2 {k2_ms:.3f} ms (plain {k2_plain_ms:.1f} ms, bound {k2_bound:.4f} ms by {k2_by})")
    _log(f"  value+grad step {step_ms:.2f} ms (first {first_step_s * 1e3:.1f} ms); "
         f"f64 stepper step {f64_step_ms:.1f} ms (once)")

    kernels = [
        {"name": "fused_fwd_kernel (K1)", "route": "cuda",
         "source": "pulser_diff_torch/csrc/fused_evolution.cu",
         "replaces": "pulser_diff_tpu/ops/pallas_evolution.py:594",
         "launches": launches["fused_fwd"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "fused_bwd_kernel (K2)", "route": "cuda",
         "source": "pulser_diff_torch/csrc/fused_evolution.cu",
         "replaces": "pulser_diff_tpu/ops/pallas_evolution.py:1026",
         "launches": launches["fused_bwd"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

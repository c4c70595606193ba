#!/usr/bin/env python3
"""Where K1/K2's time goes, phase by phase, on one NVIDIA GPU.

    python3 kernel_phases.py [--clusters 16 8]

Builds variants of pulser_diff_torch/csrc/fused_evolution.cu with one
phase compiled out (the products of the block's rows, the Hcol/Hrow
assembly, the DSMEM gather, the kron terms, K2's stream cotangents, K2's
kron matrix cotangents), one nvcc each, all started together, into the
ignored pulser_diff_torch/_build/phases/, and times K1 and K2 (CUDA-event
medians of 3 launches) at the 12-atom and the 12-atom XY shapes of
chip_smoke.py for each variant and each cluster size given.  A variant's
results are wrong by construction; only its time is read: the full
kernel's time minus a variant's is that phase's share.  Prints the card's
name and power limit first.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
import types

import chip_smoke as cs

# variant -> the source edits that compile its phase out
VARIANTS = {
    "full": [],
    "no_products": [
        ("apply_rows<KRON>(sh, g, r0, dg, dl, kx, kx + sl, 1.f);", ""),
        ("apply_rows<KRON>(sh, g, r0, dg, dl, out, out + sl, sign);", ""),
    ],
    "no_assembly": [("            assemble(sh, pt", "            if (0) assemble(sh, pt")],
    "no_gather": [("gather(cl, g, pub, sh.fx, sh.fy);", "")],
    "no_kron_terms": [
        ("if constexpr (KRON) kron_apply(", "if constexpr (false) kron_apply("),
        ("        if constexpr (KRON)\n            kron_apply(",
         "        if constexpr (false)\n            kron_apply("),
    ],
    "no_stream_cotangents": [("            side_cotangents(sh, g, r0, pt, us, nrow);", "")],
    "no_matrix_cotangents": [
        ("                kron_matrix_cotangents(sh, cl,", "                if (0) kron_matrix_cotangents(sh, cl,")
    ],
}


def _build(kb) -> dict:
    """One library per variant; raises if an edit no longer matches."""
    src = (kb.CSRC / "fused_evolution.cu").read_text()
    out = kb.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: '{old.strip()}' is not in the source")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
    return {name: out / f"lib{name}.so" for name in VARIANTS}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--clusters", type=int, nargs="+", default=[16],
                        help="cluster sizes to time (default: 16, the plan at 12 atoms)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device is available", file=sys.stderr)
        return 2
    from pulser_diff_torch.ops import fused_evolution as fe
    from pulser_diff_torch.ops import kernel_build as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _build(kb)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    shapes = {}
    for label, make in (("12 atoms", cs._bench_model), ("12 atoms XY", cs._xy_model)):
        model = make(torch, dev, fused=None)[0]
        with torch.no_grad():
            sim = model._make_emulator(dict(model.params))
        shapes[label] = cs._kernel_inputs(torch, sim, model._default_substeps(), dev)
    plan, loader = fe.cluster_plan, fe.kernel_build
    try:
        for C in args.clusters:
            fe.cluster_plan = lambda bwd, *shape, C=C: (C, 4 * fe._smem_floats(bwd, *shape, C))
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                fe.kernel_build = types.SimpleNamespace(load=lambda _name, lib=lib: lib)
                row = []
                for label, (data, slots, n_eval, last_slot) in shapes.items():
                    lo = fe._n_kron(data) > 0
                    states = fe.fused_fwd(data, "DP5", slots, n_eval, lo=lo)
                    st = tuple(s.nan_to_num() for s in states[:2])
                    lam = tuple(torch.full_like(st[0], 1e-3) for _ in range(2))
                    k1 = cs._cuda_time_ms(
                        torch, lambda: fe.fused_fwd(data, "DP5", slots, n_eval, lo=lo), 3)
                    k2 = cs._cuda_time_ms(torch, lambda: fe.fused_bwd(
                        data, "DP5", slots, n_eval, last_slot, *st, *lam), 3)
                    row.append(f"{label}: K1 {k1:.2f} ms, K2 {k2:.2f} ms")
                print(f"C={C} {name:21s} " + "; ".join(row), flush=True)
    finally:
        fe.cluster_plan, fe.kernel_build = plan, loader
    return 0


if __name__ == "__main__":
    sys.exit(main())

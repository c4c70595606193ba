#!/usr/bin/env python3
"""Where the fused kernels' time goes, phase by phase, on one NVIDIA GPU.

    python3 kernel_phases.py [--kernels k1k2 ckpt] [--clusters 16 8]
                             [--baseline DIR]

Builds variants of the kernel sources with one phase compiled out, one
nvcc each, all started together, into the ignored
pulser_diff_torch/_build/phases/, and times them (CUDA-event medians of 3
launches):
  - k1k2: csrc/fused_evolution.cu without the products of the block's
    rows, the Hcol/Hrow assembly, the DSMEM gather, the kron terms, K2's
    stream cotangents or K2's kron matrix cotangents; K1 and K2 at the
    12-atom and the 12-atom XY shapes of chip_smoke.py, for each cluster
    size given;
  - ckpt: csrc/fused_ckpt.cu without the side products, the epilogue and
    elementwise work, the side assembly, K5's outer-product (stream)
    cotangents or the kron phases, and a variant that keeps only the
    loops and the grid barriers; K4 and K5 at the 16-atom shapes and the
    12-atom XY shapes (ckpt=True).  With --baseline DIR (a checkout of
    the parent tree, e.g. unpacked by git archive) the parent's
    csrc/fused_ckpt.cu is timed the same way in the same call, with the
    edits of BASELINE_CKPT_VARIANTS.
A variant's results are wrong by construction; only its time is read:
the full kernel's time minus a variant's is that phase's share.  Prints
the card's name and power limit first.  Exits non-zero without CUDA.
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


# the parent tree's K4/K5 (a cooperative grid sized by state elements,
# 2S grid barriers a K4 step and 4S - 1 a K5 step, elementwise phases
# between the product phases)
_PARENT_OFF = {
    "products": [("        if (j < 2 * per_apply) {\n            const Side sd",
                  "        if (j < 2 * per_apply) {\n            continue;\n            const Side sd")],
    "epilogue": [("idx < RN; idx += gsize()) {", "idx < 0; idx += gsize()) {"),
                 ("idx < RM; idx += gsize()) {", "idx < 0; idx += gsize()) {")],
    "assembly": [("idx < (size_t)g.R * per; idx += gsize()) {", "idx < 0; idx += gsize()) {")],
    "outer": [("const int n_out = outer ? n_or + n_oc : 0;", "const int n_out = 0;")],
    "kron": [("const int n_kron = KRON ? in.K", "const int n_kron = 0 ? in.K"),
             ("kron_second(t, g, in, scratch, L.per_run, L.ko,",
              "if (0) kron_second(t, g, in, scratch, L.per_run, L.ko,")],
}


def _ckpt_variants(off: dict) -> dict:
    """full, one variant per phase, and barriers_only (every phase out)."""
    out = {"full": []}
    for phase, edits in off.items():
        out[f"no_{phase}"] = edits
    out["barriers_only"] = [e for edits in off.values() for e in edits]
    return out


# this tree's K4/K5 (one block per SM, one grid barrier per application of
# -iH, the stage's end in the product jobs' epilogue)
_CKPT_OFF = {
    "products": [
        ("        group_mma<CPLX, RM, RN>(sm.g[0], 0, A, B, g.da, g.db, g.da, i0, j0, p);", ""),
        ("        group_mma<CPLX, RM, RN>(sm.g[1], 1, A, B, g.da, g.db, g.db, i0, j0, p);", ""),
    ],
    "epilogue": [("fwd_stage_end(run, L,", "if (0) fwd_stage_end(run, L,"),
                 ("bwd_rev_end<KRON>(c, run,", "if (0) bwd_rev_end<KRON>(c, run,"),
                 ("bwd_rev_end<true>(c, run,", "if (0) bwd_rev_end<true>(c, run,"),
                 ("bwd_fwd_end(c, run,", "if (0) bwd_fwd_end(c, run,")],
    "assembly": [("        for (size_t i0 = gtid(); i0 < total; i0 += U * stride) {",
                  "        for (size_t i0 = gtid(); i0 < 0; i0 += U * stride) {")],
    "outer": [("const int n_out = rev ? dtiles(da, da, RM, RN) + dtiles(db, db, RM, RN) : 0;",
               "const int n_out = 0;")],
    "kron": [("const int per = pl.tiles + (KRON ? 2 * in.K * g.nb * dtiles(da, db, RM, RN) : 0);",
              "const int per = pl.tiles;"),
             ("const int n_rside = KRON ? 2 * c.in.K * g.nb * dt : 0;", "const int n_rside = 0;"),
             ("const int n_mat = KRON && rev ? 4 * c.in.K * g.nb * dt : 0;", "const int n_mat = 0;"),
             ("const int n_mat = rev ? K * (dtiles(da, da, RM, RN) + dtiles(db, db, RM, RN)) : 0;",
              "const int n_mat = 0;"),
             ("for (int j2 = 0; j2 < K; j2 += 2) {", "for (int j2 = 0; j2 < 0; j2 += 2) {")],
}

BASELINE_CKPT_VARIANTS = _ckpt_variants(_PARENT_OFF)
CKPT_VARIANTS = _ckpt_variants(_CKPT_OFF)


def _start(kb, src_path, variants: dict, tag: str) -> dict:
    """Start one nvcc per variant of ``src_path``; raises if an edit no
    longer matches."""
    src = src_path.read_text()
    out = kb.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {tag}/{name}: '{old.strip()}' is not in the source")
            text = text.replace(old, new)
        (out / f"{tag}_{name}.cu").write_text(text)
        lib = out / f"lib{tag}_{name}.so"
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(lib), str(out / f"{tag}_{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    return procs


def _finish(procs: dict, tag: str) -> dict:
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {tag}/{name}:\n{log[-3000:]}")
        libs[name] = lib
    return libs


def _use(fe, path, baseline=False):
    """Point the wrappers' library loader at one variant's library.  The
    parent's K4/K5 library has no pdt_ckpt_plan: its functions are declared
    here, with the signatures it shares."""
    lib = ctypes.CDLL(str(path))
    if baseline:
        I, P = ctypes.c_int, ctypes.c_void_p
        lib.pdt_ckpt_scratch_floats.argtypes = [I] * 7
        lib.pdt_ckpt_scratch_floats.restype = ctypes.c_size_t
        lib.pdt_ckpt_fwd.argtypes = [P, P, I] + [P] * 6 + [I] * 8 + [P, P, P]
        lib.pdt_ckpt_bwd.argtypes = [P, P, I] + [P] * 8 + [I] * 8 + [P, P, P]
        lib._pdt_declared = True
    fe.kernel_build = types.SimpleNamespace(load=lambda _name, lib=lib: lib)


def _shapes(torch, dev, makers):
    out = {}
    for label, make, kw in makers:
        model = make(torch, dev, fused=None, **kw)[0]
        with torch.no_grad():
            sim = model._make_emulator(dict(model.params))
        out[label] = cs._kernel_inputs(torch, sim, model._default_substeps(), dev)
    return out


def _time_k1k2(torch, fe, libs, shapes, clusters):
    for C in clusters:
        fe.cluster_plan = lambda bwd, *shape, C=C: (C, 4 * fe._smem_floats(bwd, *shape, C))
        for name, path in libs.items():
            _use(fe, path)
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


def _time_ckpt(torch, fe, libs, shapes, tag):
    for name, path in libs.items():
        _use(fe, path, baseline=tag == "parent")
        row = []
        for label, (data, *_rest) in shapes.items():
            lo = fe._n_kron(data) > 0
            states = fe.fused_fwd_ckpt(data, "DP5", lo=lo)
            st = tuple(s.nan_to_num() for s in states[:2])
            lam = tuple(torch.full_like(st[0], 1e-3) for _ in range(2))
            del states
            k4 = cs._cuda_time_ms(torch, lambda: fe.fused_fwd_ckpt(data, "DP5", lo=lo), 3)
            k5 = cs._cuda_time_ms(torch, lambda: fe.fused_bwd_ckpt(data, "DP5", *st, *lam), 3)
            row.append(f"{label}: K4 {k4:.2f} ms, K5 {k5:.2f} ms")
        print(f"{tag} {name:16s} " + "; ".join(row), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", nargs="+", choices=("k1k2", "ckpt"), default=["k1k2", "ckpt"])
    parser.add_argument("--clusters", type=int, nargs="+", default=[16],
                        help="K1/K2 cluster sizes to time (default: 16, the plan at 12 atoms)")
    parser.add_argument("--baseline", help="a checkout of the parent tree: time its K4/K5 too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device is available", file=sys.stderr)
        return 2
    from pathlib import Path

    from pulser_diff_torch.ops import fused_evolution as fe
    from pulser_diff_torch.ops import kernel_build as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    jobs = {}
    if "k1k2" in args.kernels:
        jobs["k1k2"] = _start(kb, kb.CSRC / "fused_evolution.cu", VARIANTS, "k1k2")
    if "ckpt" in args.kernels:
        jobs["ckpt"] = _start(kb, kb.CSRC / "fused_ckpt.cu", CKPT_VARIANTS, "ckpt")
        if args.baseline:
            src = Path(args.baseline) / "pulser_diff_torch" / "csrc" / "fused_ckpt.cu"
            jobs["parent"] = _start(kb, src, BASELINE_CKPT_VARIANTS, "parent")
    libs = {tag: _finish(procs, tag) for tag, procs in jobs.items()}
    print(f"built {sum(map(len, libs.values()))} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    plan, loader = fe.cluster_plan, fe.kernel_build
    try:
        if "k1k2" in libs:
            shapes = _shapes(torch, dev, (("12 atoms", cs._bench_model, {}),
                                          ("12 atoms XY", cs._xy_model, {})))
            _time_k1k2(torch, fe, libs["k1k2"], shapes, args.clusters)
        if "ckpt" in libs:
            shapes = _shapes(torch, dev, (("16 atoms", cs._bench_model, {"n_qubits": 16}),
                                          ("12 atoms XY", cs._xy_model, {"ckpt": True})))
            for tag in ("parent", "ckpt", "ckpt", "parent"):
                if tag in libs:
                    _time_ckpt(torch, fe, libs[tag], shapes, "parent" if tag == "parent" else "this")
    finally:
        fe.cluster_plan, fe.kernel_build = plan, loader
    return 0


if __name__ == "__main__":
    sys.exit(main())

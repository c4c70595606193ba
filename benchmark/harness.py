"""Run one cell of ``BENCHMARK.json`` once and print its result.

Every piece is found by name: the workload names a configuration and a
traffic mix; the configuration's file (``configs/<config>.json``) names
its protocol (``protocols/<name>.py``: the inputs from the seed and the
program's model) and its plain reference (``reference/<name>.py``); the
traffic mix is data (``traffic/<mix>.json``) whose ``entry`` names the
driver that runs it (``drivers/<entry>.py``); each per-layer metric is
read by ``metrics/<metric>.py``; the limits of the comparison are
``limits/<workload>.json``.

A driver module gives ``Session(cell, inputs, device, side)``, with
``set_up()``, ``epoch()`` (one unit of the window's work; the answers
read on the host), ``spans`` (per epoch, host seconds by part),
``record_function`` (set while a profiler records), ``PARTS`` (the
labels of those parts), ``after_window()``, ``records`` and ``free()``;
and ``compare(cell, inputs, records, device)``, the numbers held to the
limits, which runs the reference.

A run: set-up (imports, the device, the inputs and the session, its
set-up), the measured window of ``--seconds``, then, once the window has
closed, what the session owes the comparison, the check for modules of
the JAX package, the peak memory, the card's lines, the trace's
reduction (``--trace 1``), and the comparison, which runs after the
program's state is freed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Mapping, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pulser_diff_tpu"})


class CellError(RuntimeError):
    """A run that cannot give a result (no chip, a forbidden import)."""

    def __init__(self, msg: str, code: int) -> None:
        super().__init__(msg)
        self.code = code


def forbidden_modules(modules=None) -> list:
    """Loaded modules of JAX or of the JAX package, by top-level name
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_module(path: Path, label: str):
    """The module at ``path`` (a file the benchmark found by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: Path, workload: str) -> SimpleNamespace:
    """Everything one workload of ``root/BENCHMARK.json`` names."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"
    cfg = _json(root / conf["file"])
    traffic = _json(bench / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), cfg=cfg,
        traffic=traffic,
        driver=load_module(bench / "drivers" / f"{traffic['entry']}.py",
                           f"driver_{traffic['entry']}"),
        limits=_json(bench / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer,
        protocol=load_module(bench / "protocols" / f"{cfg['protocol']}.py",
                             f"protocol_{cfg['protocol']}"),
        reference=load_module(bench / "reference" / f"{cfg['reference']}.py",
                              f"reference_{cfg['reference']}"),
        readers={m["name"]: load_module(bench / "metrics" / f"{m['name']}.py",
                                        f"metric_{m['name'].replace('.', '_')}")
                 for m in per_layer},
    )


def device_lines(torch) -> list:
    """What the run ran on: the card, its power limit and clocks, torch."""
    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}"]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        lines.append(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    except (OSError, subprocess.SubprocessError) as exc:
        lines.append(f"nvidia-smi not read: {exc}")
    return lines


def make_inputs(cell: SimpleNamespace, seed: int, device) -> dict:
    """The inputs both sides are handed, from the seed (the protocol's)."""
    return cell.protocol.make_inputs(cell.cfg, int(cell.traffic["candidates"]), seed, device)


def judge(numbers: Mapping, limits: Mapping) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit is there, finite and at most it.  A number with no limit in
    the cell's file is not compared."""
    table = {k: {"value": numbers.get(k, math.nan), "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table


def _p90(values: list) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             root: Path = ROOT, device: str = "cuda", log=None, session_hook=None) -> dict:
    """One run; returns the result object (its keys in the contract's
    order, the checks last).  Raises CellError where no result may be
    printed.  ``session_hook(session)``, where given, sees the session
    before its set-up (the fault tests break the timed path there)."""
    log = log or (lambda s: print(s, flush=True))
    cell = resolve(root, workload)
    import torch

    cuda = device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: torch.cuda.is_available() is false", 3)
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{workload} needs {cell.chips} device(s), "
                            f"{torch.cuda.device_count()} visible", 3)
    size = cell.reference.problem_size(cell.cfg)
    runs = int(cell.traffic["candidates"])
    log(f"cell {workload}: {size['atoms']} atoms, {size['steps']} steps, {runs} candidate(s), "
        f"entry {cell.traffic['entry']}, seed {seed}, window {seconds} s, trace {int(trace)}")

    t_dev = time.perf_counter()
    inputs = make_inputs(cell, seed, device)
    session = cell.driver.Session(cell, inputs, device)
    if session_hook is not None:
        session_hook(session)
    t_model = time.perf_counter()
    session.set_up()
    first_ms = sum(session.spans[0].values()) * 1e3 if session.spans else math.nan
    session.spans.clear()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: to the device {t_dev - t_start:.3f} s, inputs and model "
        f"{t_model - t_dev:.3f} s, its set-up {time.perf_counter() - t_model:.3f} s "
        f"(the first epoch {first_ms:.1f} ms)")

    # the measured window: whole epochs until --seconds have passed; with
    # --trace 1 the profiler records its last trace_seconds (it is started
    # late, since CUPTI slows the launches after it stops)
    trace_from = seconds - min(float(cell.traffic["trace_seconds"]), seconds / 2)
    prof = label = None
    first_traced = None
    marks = [loop_event(torch, cuda)]
    answers = []
    w0 = time.perf_counter()
    while True:
        if trace and prof is None and time.perf_counter() - w0 >= trace_from:
            prof, label = _start_trace(session, cuda)
            first_traced = len(answers)
        answers.append(session.epoch())
        marks.append(loop_event(torch, cuda))
        if time.perf_counter() - w0 >= seconds and (not trace or prof is not None):
            break
    w1 = time.perf_counter()
    if prof is not None:
        label.__exit__(None, None, None)
        session.record_function = None
        prof.__exit__(None, None, None)
    epochs = len(answers)
    untraced_n = first_traced if trace else epochs
    traced = epochs - untraced_n
    untraced = session.spans[:untraced_n]
    window_ms = (w1 - w0) * 1e3
    if cuda:
        torch.cuda.synchronize()
    epoch_ms = ([marks[i].elapsed_time(marks[i + 1]) for i in range(epochs)] if cuda else [])
    # once the window has closed: what the session owes the comparison
    answers.append(session.after_window())
    failed = sum(1 for a in answers if not bool(torch.isfinite(a).all()))

    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or of the JAX package were loaded: {bad}", 4)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if cuda:
        for line in device_lines(torch):
            log(line)
    log(f"window {window_ms / 1e3:.3f} s, {epochs} epochs, {window_ms / epochs:.3f} ms an epoch"
        + (f"; the untraced epochs' mean {_mean(epoch_ms[:untraced_n]):.3f} ms, the "
           f"{traced} traced epochs' {_mean(epoch_ms[untraced_n:]):.3f} ms" if trace else ""))
    log(f"device memory peak {peak} bytes ({peak / 2**30:.3f} GiB)")

    result = {"correct": False, "attempted": len(answers), "failed": failed, "metrics": {}}
    tr = None
    if trace:
        from benchmark.trace import Trace
        tr = Trace.from_profiler(prof, traced, session.PARTS)
        view = SimpleNamespace(trace=tr if cuda else None, spans=untraced,
                               epoch_s=[t / 1e3 for t in epoch_ms[:untraced_n]],
                               size=size, runs=runs)
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(view)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if cuda:
            from benchmark.work.frozen_bound import bound_line
            log(bound_line(session.model, inputs["knots"],
                           lambda k: cell.protocol.split(k, cell.cfg)))
    else:
        got = {"setup_s": setup_s, "step_ms": window_ms / epochs}
        if epoch_ms:
            got["step_p90_ms"] = _p90(epoch_ms)
        for m in cell.end_to_end:
            if m["name"] in got:
                result["metrics"][m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                        "count": cell.chips, "memory_peak_bytes": peak}
    if tr is not None and cuda:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}

    # the comparison, once the program's state is freed
    records = session.records
    session.free()
    del session, prof, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = cell.driver.compare(cell, inputs, records, device)
    ok, table = judge(numbers, cell.limits)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    for k in sorted(set(numbers) - set(table)):
        log(f"not compared (no limit): {k} {numbers[k]!r}")
    result["correct"] = bool(ok and failed == 0)
    result["checks"] = table
    return result


def loop_event(torch, cuda: bool):
    """An event on the device's clock (None off CUDA)."""
    if not cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _start_trace(session, cuda: bool):
    """Start the profiler and the window's label; the session labels its
    parts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.__enter__()
    label = record_function("window")
    label.__enter__()
    session.record_function = record_function
    return prof, label


def _mean(values: list) -> float:
    return statistics.fmean(values) if values else float("nan")


def print_result(result: dict, out=None, err=None) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=err, flush=True)
    # a number that is not finite goes out as null: the line stays JSON
    checks = {k: {**v, "value": v["value"] if math.isfinite(v["value"]) else None}
              for k, v in result["checks"].items()}
    print(json.dumps({**result, "checks": checks}, allow_nan=False), file=out, flush=True)


def main(argv: Optional[list] = None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    # one host thread: the host's share of an epoch steadier from run to run
    torch.set_num_threads(1)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except CellError as exc:
        print(f"no result: {exc}", file=sys.stderr, flush=True)
        return exc.code
    if not all(math.isfinite(m["value"]) for m in result["metrics"].values()):
        print("no result: a metric is not finite", file=sys.stderr, flush=True)
        return 5
    print_result(result)
    return 0

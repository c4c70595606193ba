"""A configuration, a traffic mix (of a kind that no driver runs yet) and
a per-layer metric are found by name: adding them takes new files and
new entries, no edit of a file there."""

import hashlib
import json
import time

from benchmark import harness

METRIC = '''"""Adam's host time an epoch (a throwaway reader)."""


def read(run):
    return 1e3 * sum(s["adam"] for s in run.spans) / len(run.spans) if run.spans else None
'''

# a driver of a new kind: forward evaluations only, no optimiser (a sweep
# of candidate pulses), compared with the reference's values
DRIVER = '''"""A throwaway driver: each epoch evaluates the candidates, no update."""

import time

import torch

PARTS = ("forward", "loss_read")


class Session:
    PARTS = PARTS

    def __init__(self, cell, inputs, device, side="port"):
        self.cell, self.knots = cell, inputs["knots"]
        self.model = cell.protocol.build_model(cell.cfg, inputs, device)
        self.pop_fn = self.model.expectation_population_fn(
            cell.protocol.observable(cell.cfg, device))
        self.records, self.spans, self.record_function = {}, [], None

    def epoch(self):
        t0 = time.perf_counter()
        with torch.no_grad():
            vals = self.cell.protocol.loss(
                self.pop_fn(self.cell.protocol.split(self.knots, self.cell.cfg))[1])
        t1 = time.perf_counter()
        host = vals.cpu()
        self.spans.append({"forward": t1 - t0, "loss_read": time.perf_counter() - t1})
        return host

    def set_up(self):
        self.epoch()

    def after_window(self):
        host = self.epoch()
        self.records["values"] = host.double()
        return host

    def free(self):
        self.model = self.pop_fn = None


def compare(cell, inputs, records, device):
    problem = cell.reference.Problem(cell.cfg, inputs["matrix"], torch.float64, device)
    with torch.no_grad():
        ref = problem.loss(inputs["knots"].double()).cpu()
    return {"value_gap": float((records["values"] - ref).abs().max())}
'''


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def _add(tiny, name, cfg_name, traffic, traffic_name, limits, metric_entry=None):
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": cfg_name, "traffic": traffic_name,
                              "chips": 1, "why": "a test"})
    if metric_entry:
        spec["per_layer"].append(metric_entry)
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = tiny / "benchmark"
    (bench / "traffic" / f"{traffic_name}.json").write_text(json.dumps(traffic))
    (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))


def test_bench_new_cell_needs_only_new_files(tiny):
    before = _digest(tiny)
    bench = tiny / "benchmark"
    cfg = json.loads((bench / "configs" / "stateprep12_chain.json").read_text())
    cfg.update(name="ising3_line", register={"coords": [[0.0, 0.0], [9.0, 0.0], [18.0, 0.0]]})
    (bench / "configs" / "ising3_line.json").write_text(json.dumps(cfg))
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ising3_line", "source": "a test",
                            "file": "benchmark/configs/ising3_line.json", "reduced": [],
                            "why": "a test"})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "metrics" / "adam_host_ms.py").write_text(METRIC)
    _add(tiny, "ising3.slow", "ising3_line",
         {"entry": "fit", "candidates": 1, "lr": 0.02, "setup_epochs": 3, "trace_seconds": 5},
         "slow_train",
         {k: 1e-6 for k in ("loss_gap", "grad_gap", "step_gap", "window_loss_gap",
                            "window_grad_gap")},
         {"name": "adam_host_ms", "unit": "ms", "better": "lower", "source": "host_clock",
          "layer": "training loop", "moves": "step_ms", "workloads": ["ising3.slow"]})
    # a mix of a kind no driver ran before: its driver is a new file too
    (bench / "drivers" / "sweep_values.py").write_text(DRIVER)
    _add(tiny, "ising3.sweep", "ising3_line",
         {"entry": "sweep_values", "candidates": 3, "trace_seconds": 5}, "sweep3",
         {"value_gap": 1e-9})

    res = harness.run_cell("ising3.slow", 7, 0.5, True, time.perf_counter(), root=tiny,
                           device="cpu", log=lambda s: None)
    assert res["correct"]
    assert set(res["metrics"]) == {"adam_host_ms"}
    res = harness.run_cell("ising3.sweep", 7, 0.5, False, time.perf_counter(), root=tiny,
                           device="cpu", log=lambda s: None)
    assert res["correct"] and list(res["checks"]) == ["value_gap"]
    assert set(res["metrics"]) == {"setup_s", "step_ms"}
    after = _digest(tiny)
    assert {k: v for k, v in after.items() if k in before} == before

"""The import guard, and the reference's independence from the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent


def test_bench_guard_compares_top_level_names_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "pulser_diff_tpu.ops",
              "pulser_diff_torch", "pulser_diff_torch.model", "pulser_diff_tpu_extra",
              "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_modules(loaded) == ["flax.linen", "jax", "jax.numpy",
                                                 "jaxlib.xla_client", "pulser_diff_tpu.ops"]


def test_bench_run_loads_no_jax(tiny):
    # a whole run in a fresh process: nothing of JAX or the JAX package
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(1)\n"
            "from pathlib import Path\n"
            "from benchmark import harness\n"
            "r = harness.run_cell('ising12.train', 3, 0.2, False, time.perf_counter(),"
            " root=Path(%r), device='cpu', log=lambda s: None)\n"
            "print(harness.forbidden_modules(), r['correct'])\n") % (str(tiny), str(tiny))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_bench_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "math", "typing", "numpy", "torch"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path.name, names)


def test_bench_no_result_without_the_program(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark: no result line
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ising12.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    for line in lines[-1:]:
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")

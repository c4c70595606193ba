"""Each cell end to end on the card, a short window: one command,

    python -m pytest benchmark/tests/test_bench_card.py -q -m card
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_bench_cell_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "4100000001", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"

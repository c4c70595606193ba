"""The result line and the checks' lines."""

import io
import json
import time

from benchmark import harness
from benchmark.training import NUMBERS


def test_bench_last_line_keys(tiny):
    for trace in (False, True):
        res = harness.run_cell("ising12.population", 11, 0.2, trace, time.perf_counter(),
                               root=tiny, device="cpu", log=lambda s: None)
        out, err = io.StringIO(), io.StringIO()
        harness.print_result(res, out, err)
        last = json.loads(out.getvalue().strip().splitlines()[-1])
        assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(last)[-1] == "checks"
        assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
        # every number the cell's limits name, in their order
        limits = harness.resolve(tiny, "ising12.population").limits
        assert list(last["checks"]) == list(limits) and set(limits) <= set(NUMBERS)
        names = {"forward_host_ms"} if trace else {"setup_s", "step_ms"}
        assert set(last["metrics"]) == names
        for m in last["metrics"].values():
            assert set(m) == {"value", "unit"}
        tail = err.getvalue().strip().splitlines()[-len(limits):]
        assert [line.split()[1] for line in tail] == list(limits)
        assert all(" limit " in line for line in tail)

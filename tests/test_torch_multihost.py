"""The port's multi-host parameter sweep (pulser_diff_torch/parallel/multihost.py)
against the reference of tests/test_multihost.py: 2 "hosts" x 2 ranks, gloo
processes on localhost (tests/torch_workers.py's multihost group, with
LOCAL_WORLD_SIZE = 2 as torchrun would set it).  The param axis crosses the
hosts, the runs stay on each host."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from .torch_workers import SWEEP_PARAMS, SWEEP_SEEDS, sweep_loss

ROOT = Path(__file__).resolve().parents[1]


def _mean_loss(omega: float, row: int) -> float:
    return float(np.mean([sweep_loss(omega, int(s)) for s in SWEEP_SEEDS[row]]))


def test_two_host_param_sweep(tmp_path):
    """Every rank: the mesh {"param": 2, "runs": 2}, its own param row's
    mean loss against the numpy reference (1e-12); the gathered losses of
    both rows (with and without gradients) likewise, Shard(0) on param;
    the gradients against a central difference (1e-5)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
           "LOCAL_WORLD_SIZE": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_workers.py"), "multihost", str(rank), "4",
         str(port), str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    want = np.array([_mean_loss(w, i) for i, w in enumerate(SWEEP_PARAMS)])
    eps = 1e-6
    fd = np.array([(_mean_loss(w + eps, i) - _mean_loss(w - eps, i)) / (2 * eps)
                   for i, w in enumerate(SWEEP_PARAMS)])
    rows = []
    for rank in range(4):
        r = dict(np.load(tmp_path / ("multihost.npz" if rank == 0 else f"multihost_{rank}.npz")))
        assert list(r["shape"]) == [2, 2] and str(r["names"]) == "param,runs"
        row = int(r["param_row"])
        rows.append(row)
        np.testing.assert_array_equal(r["local_param"], SWEEP_PARAMS[row:row + 1])
        assert abs(float(r["local_loss"][0]) - want[row]) < 1e-12
        np.testing.assert_allclose(r["loss"], want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["loss2"], want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["grad"], fd, rtol=0, atol=1e-5)
        assert str(r["placements"]) == str(r["grad_placements"]) == "(Shard(dim=0), Replicate())"
    assert sorted(rows) == [0, 0, 1, 1]
    assert np.abs(fd).min() > 1e-4

"""The readings that the limits of ``benchmark/limits/`` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--side port|control] [--fault <fault>] [--epochs N]

For each seed, in one process: the cell's session on the chosen side
(the program, or the control: the reference in the precision below the
configuration's, put in the program's place), with a fault planted where
asked, through its set-up, ``--epochs`` epochs in place of the measured
window and the epoch after it, then the comparison with the float64
reference.  One JSON line a seed on standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402


def readings(cell, seed: int, side: str, fault, device: str, epochs: int) -> dict:
    import torch

    t0 = time.perf_counter()
    inputs = harness.make_inputs(cell, seed, device)
    session = cell.driver.Session(cell, inputs, device, side)
    if fault:
        faults.plant(session.loop, fault, int(cell.traffic["setup_epochs"]))
    session.set_up()
    for _ in range(epochs):
        session.epoch()
    session.after_window()
    records = session.records
    session.free()
    del session
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers = cell.driver.compare(cell, inputs, records, device)
    return {"workload": cell.name, "seed": seed, "side": side, "fault": fault,
            "epochs": epochs, "readings": numbers, "side_s": t1 - t0,
            "reference_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--side", choices=("port", "control"), default="port")
    ap.add_argument("--fault", choices=faults.FAULTS, default=None)
    ap.add_argument("--epochs", type=int, default=20,
                    help="epochs between set-up and the epoch after the window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    cell = harness.resolve(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.side, args.fault, args.device, args.epochs)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

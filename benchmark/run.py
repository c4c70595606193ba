"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers that decide ``correct`` are the last lines of
standard error.  It exits non-zero, with no result, where CUDA is not
available or has fewer devices than the cell asks for, and where a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel cache at a fixed path inside the checkout, set before torch loads
_CACHE = ROOT / ".benchmark_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
sys.path.insert(0, str(ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

"""pytest settings of the benchmark's own tests (``benchmark/tests/``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which decides there, never at import, whether a CUDA device is
present, and skips with the reason where none is:

    python -m pytest benchmark/tests -q            # without a card they skip
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an NVIDIA H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda")


def tiny_copy(dst: Path, atoms: int = 4, duration: int = 100) -> Path:
    """A copy of the benchmark under ``dst`` whose configurations are cut to
    ``atoms`` atoms and ``duration`` ns, beside a link to the program, for
    runs on the CPU."""
    import json
    import shutil

    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for conf in json.loads((dst / "BENCHMARK.json").read_text())["configs"]:
        path = dst / conf["file"]
        cfg = json.loads(path.read_text())
        cfg["register"]["coords"] = [[10.0 * (i % 4), 10.0 * (i // 4)] for i in range(atoms)]
        cfg["pulse"]["duration_ns"] = duration
        path.write_text(json.dumps(cfg))
    (dst / "pulser_diff_torch").symlink_to(ROOT / "pulser_diff_torch")
    return dst


@pytest.fixture
def tiny(tmp_path):
    """A 4-atom, 100 ns copy of the benchmark (see ``tiny_copy``)."""
    import torch

    torch.set_num_threads(1)
    return tiny_copy(tmp_path)

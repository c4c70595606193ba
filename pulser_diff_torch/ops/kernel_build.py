"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each source under ``pulser_diff_torch/csrc/`` is compiled at first use
with ``nvcc`` for ``sm_90a`` into ``pulser_diff_torch/_build/`` (listed in
.gitignore), keyed by the hash of the source and the flags, and loaded
with ctypes.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false keeps the compensated (Kahan / two-word) arithmetic rounded
# as written; the products use explicit __fmaf_rn.  No fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built.")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless the library is current;
    returns (process, temporary output, output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: concurrent builders
    # never load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # the compiler's report goes to a file, not a pipe: a build left
    # running while the caller works never stalls on a full pipe
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out


def start_builds(names) -> dict:
    """Start one ``nvcc`` for each source that is not current, all at once,
    and return at once; :func:`finish_builds` waits for them."""
    return {name: _start(name) for name in names}


def finish_builds(started: dict) -> dict[str, str]:
    """Wait for the builds of :func:`start_builds`; returns each compiler's
    output (ptxas register and shared-memory report), empty for a library
    that was current.  Raises if one failed."""
    reports, failed = {}, []
    for name, job in started.items():
        if job is None:
            reports[name] = ""
            continue
        proc, tmp, out = job
        proc.wait()
        log = tmp.with_suffix(".log")
        report = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{report[-4000:]}")
            continue
        os.replace(tmp, out)
        reports[name] = report
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def build_all(names) -> dict[str, str]:
    """Compile several sources at once (one ``nvcc`` each, all started
    together); returns each compiler's output, as :func:`finish_builds`."""
    return finish_builds(start_builds(names))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library is current; returns
    the compiler's output (ptxas register / shared-memory report)."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]

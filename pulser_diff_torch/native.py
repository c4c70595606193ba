"""ctypes binding of the native host-side sampler (counterpart of
pulser_diff_tpu/native.py).

``native/sampler.cpp`` is compiled at first use with the C++ compiler
(``$CXX``, else ``g++``) into ``pulser_diff_torch/_build/`` (listed in
.gitignore), keyed by the hash of the source and the flags, as
``ops/kernel_build.py`` builds the CUDA kernels; nothing is written into
``native/``.  A failed build raises with the compiler's output.

The port's waveforms sample with torch (``core/waveforms.py``); this
binding gives the JAX package's native entry points, for parity.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "sampler.cpp"
BUILD_DIR = _PKG / "_build"
# the flags of native/Makefile, so the results equal the JAX package's
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join((_compiler(),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libpdtorch_native-{key.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: concurrent builders
    # never load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"the C++ compiler {_compiler()!r} could not run: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{_compiler()} failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        i64, f64 = ctypes.c_int64, ctypes.c_double
        for name, args in (
            ("wf_blackman", [i64, f64, dp]),
            ("wf_kaiser", [i64, f64, f64, dp]),
            ("wf_ramp", [i64, f64, f64, dp]),
            ("wf_pchip", [i64, dp, dp, i64, dp, dp]),
            ("assemble_channel", [i64, i64, ip, ip, dp, dp, dp, dp, dp, dp]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (a failed build raises
    again at the next call that needs it)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def blackman(n: int, area: float) -> np.ndarray:
    """n samples of a Blackman window of the given area (per ns)."""
    lib = _load()
    out = np.empty(n, dtype=np.float64)
    lib.wf_blackman(n, float(area), _dp(out))
    return out


def kaiser(n: int, area: float, beta: float = 14.6) -> np.ndarray:
    """n samples of a Kaiser window of the given area and beta."""
    lib = _load()
    out = np.empty(n, dtype=np.float64)
    lib.wf_kaiser(n, float(area), float(beta), _dp(out))
    return out


def ramp(n: int, start: float, stop: float) -> np.ndarray:
    """n samples of a linear ramp from ``start`` to ``stop``."""
    lib = _load()
    out = np.empty(n, dtype=np.float64)
    lib.wf_ramp(n, float(start), float(stop), _dp(out))
    return out


def pchip(x: np.ndarray, y: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The PCHIP interpolant of the knots (x, y) at the times t."""
    lib = _load()
    x, y, t = _f64(x), _f64(y), _f64(t)
    if len(x) != len(y):
        raise ValueError(f"pchip: {len(x)} knot times against {len(y)} values")
    out = np.empty(len(t), dtype=np.float64)
    lib.wf_pchip(len(x), _dp(x), _dp(y), len(t), _dp(t), _dp(out))
    return out


def assemble_channel(total: int, ti: np.ndarray, tf: np.ndarray, seg_amp: np.ndarray,
                     seg_det: np.ndarray, seg_phase: np.ndarray):
    """A channel's (amp, det, phase) samples over ``total`` ns from its
    segments [ti, tf) and their concatenated samples; the phase holds its
    last value until the next segment."""
    lib = _load()
    ti = np.ascontiguousarray(ti, dtype=np.int64)
    tf = np.ascontiguousarray(tf, dtype=np.int64)
    seg_amp, seg_det, seg_phase = _f64(seg_amp), _f64(seg_det), _f64(seg_phase)
    if len(tf) != len(ti) or len(seg_phase) != len(ti) or (ti < 0).any() or (tf < ti).any() \
            or min(len(seg_amp), len(seg_det)) < int((tf - ti).sum()):
        raise ValueError("assemble_channel: the segments and their samples do not match")
    amp = np.zeros(total, dtype=np.float64)
    det = np.zeros(total, dtype=np.float64)
    phase = np.zeros(total, dtype=np.float64)
    lib.assemble_channel(total, len(ti), _ip(ti), _ip(tf), _dp(seg_amp), _dp(seg_det),
                         _dp(seg_phase), _dp(amp), _dp(det), _dp(phase))
    return amp, det, phase

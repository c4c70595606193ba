"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Each builder makes the same sequence or the same kernel inputs in both
packages from one numpy seed, so a test can compare the JAX function
with its ``pulser_diff_torch`` counterpart array for array.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp
import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu.backend import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_torch import TorchEmulator
from pulser_diff_torch.cplx import Cplx

CPU = torch.device("cpu")


def coords(n_atoms: int, spacing: float = 6.0) -> list[tuple[float, float]]:
    """Two-column lattice: close enough for a sizeable vdW diagonal."""
    return [(spacing * (i % 2), spacing * (i // 2)) for i in range(n_atoms)]


def pulse_samples(duration: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A smooth positive amplitude and a sign-changing detuning (rad/us)."""
    rng = np.random.default_rng(seed)
    t = np.arange(duration) / duration
    a = rng.uniform(0.5, 1.5, size=3)
    amp = 1.0 + a[0] * np.sin(np.pi * t * (1 + a[1])) ** 2
    det = -1.5 + a[2] * np.cos(3 * np.pi * t)
    return amp, det


def sequence(core, n_atoms: int, duration: int = 100, seed: int = 0, phase: float = 0.4):
    """One rydberg_global pulse with custom amplitude and detuning, in the
    package ``core`` (``pulser_diff_tpu.core`` or ``pulser_diff_torch.core``)."""
    amp, det = pulse_samples(duration, seed)
    reg = core.Register.from_coordinates(coords(n_atoms), prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse(core.CustomWaveform(amp), core.CustomWaveform(det), phase), "ryd")
    return seq


def xy_coords(n_atoms: int, seed: int) -> list[tuple[float, float]]:
    """A zig-zag line 8 um apart with a seeded jitter: no two pairs share a
    distance or an angle to an in-plane field."""
    rng = np.random.default_rng(seed)
    jit = rng.uniform(-0.5, 0.5, size=(n_atoms, 2))
    return [(8.0 * i + jit[i, 0], 2.0 * (i % 2) + jit[i, 1]) for i in range(n_atoms)]


def xy_sequence(core, n_atoms: int, duration: int = 80, seed: int = 0,
                field: tuple | None = None, phase: float = 0.3):
    """One microwave_global pulse with custom amplitude and detuning (XY
    mode), in the package ``core``; ``field`` sets the magnetic field."""
    amp, det = pulse_samples(duration, seed)
    reg = core.Register.from_coordinates(xy_coords(n_atoms, seed), prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("mw", "microwave_global")
    if field is not None:
        seq.set_magnetic_field(*field)
    seq.add(core.Pulse(core.CustomWaveform(amp), core.CustomWaveform(0.5 * det), phase), "mw")
    return seq


def xy_emulators(n_atoms: int, duration: int = 80, seed: int = 0, field: tuple | None = None,
                 sampling_rate: float = 0.5, evaluation_times="Minimal"):
    """(JAX emulator, port emulator on the CPU) for the same XY sequence."""
    jsim = TpuEmulator.from_sequence(
        xy_sequence(jcore, n_atoms, duration, seed, field),
        sampling_rate=sampling_rate, evaluation_times=evaluation_times,
    )
    tsim = TorchEmulator.from_sequence(
        xy_sequence(tcore, n_atoms, duration, seed, field),
        sampling_rate=sampling_rate, evaluation_times=evaluation_times, device="cpu",
    )
    return jsim, tsim


def emulators(n_atoms: int, duration: int = 100, seed: int = 0,
              sampling_rate: float = 0.5, evaluation_times="Minimal"):
    """(JAX emulator, port emulator on the CPU) for the same sequence."""
    jsim = TpuEmulator.from_sequence(
        sequence(jcore, n_atoms, duration, seed),
        sampling_rate=sampling_rate, evaluation_times=evaluation_times,
    )
    tsim = TorchEmulator.from_sequence(
        sequence(tcore, n_atoms, duration, seed),
        sampling_rate=sampling_rate, evaluation_times=evaluation_times, device="cpu",
    )
    return jsim, tsim


def random_state(dim: int, nb: int, seed: int) -> np.ndarray:
    """(dim, nb) normalised complex columns."""
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(dim, nb)) + 1j * rng.normal(size=(dim, nb))
    return st / np.linalg.norm(st, axis=0)


def batched(state: np.ndarray, da: int, db: int) -> tuple[np.ndarray, np.ndarray]:
    """(dim, nb) kets -> (nb, da, db) re/im, the solvers' layout."""
    nb = state.shape[1]
    return (np.ascontiguousarray(state.real.T.reshape(nb, da, db)),
            np.ascontiguousarray(state.imag.T.reshape(nb, da, db)))


def jax_cplx(re: np.ndarray, im: np.ndarray) -> JCplx:
    return JCplx(jnp.asarray(re), jnp.asarray(im))


def torch_cplx(re: np.ndarray, im: np.ndarray) -> Cplx:
    return Cplx(torch.as_tensor(re, dtype=torch.float64), torch.as_tensor(im, dtype=torch.float64))


def factored_fields(ham) -> dict[str, np.ndarray]:
    """A FactoredHamiltonian of either package as numpy arrays."""
    return {
        "row_parts": to_numpy(ham.row_parts),
        "col_parts": to_numpy(ham.col_parts),
        "row_streams_re": to_numpy(ham.row_streams.re),
        "row_streams_im": to_numpy(ham.row_streams.im),
        "col_streams_re": to_numpy(ham.col_streams.re),
        "col_streams_im": to_numpy(ham.col_streams.im),
        "int_diag": to_numpy(ham.int_diag),
        "sample_dt": np.asarray(float(ham.sample_dt)),
        "n_samples": np.asarray(int(ham.n_samples)),
    }


def kron_fields(ham) -> dict[str, np.ndarray]:
    """The kron-pair fields of a FactoredHamiltonian of either package."""
    return {
        "kron_row": to_numpy(ham.kron_row),
        "kron_col": to_numpy(ham.kron_col),
        "kron_streams_re": to_numpy(ham.kron_streams.re),
        "kron_streams_im": to_numpy(ham.kron_streams.im),
    }


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""The default routing of the fused solve between K1/K2 and the
checkpointed kernels K4/K5 (``TorchEmulator._route_ckpt``): decided by
dim and by K1's and K2's cluster plans, before any launch, so that every
shape the JAX package runs with default options runs in the port too.

No kernel runs here: ``evolve_states`` is replaced by a stub that records
the route and stops the solve.
"""

import numpy as np
import pytest
import torch

from pulser_diff_torch import TorchEmulator, backend
from pulser_diff_torch.core import ConstantWaveform, MockDevice, Pulse, Register, Sequence
from pulser_diff_torch.cplx import Cplx

torch.set_num_threads(1)


class _Routed(Exception):
    pass


def _emulator(n_atoms: int, nb: int = 1) -> TorchEmulator:
    """bench.py's lattice (4 columns, 10 um) at ``n_atoms``, one short
    constant pulse, on the CPU; ``nb`` seeded random initial states."""
    reg = Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n_atoms)], prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(Pulse(ConstantWaveform(20, 1.0), ConstantWaveform(20, -2.0), 0.0), "ryd")
    sim = TorchEmulator.from_sequence(seq, sampling_rate=0.25, evaluation_times="Minimal",
                                      device="cpu")
    if nb > 1:
        rng = np.random.default_rng(n_atoms)
        st = rng.normal(size=(2**n_atoms, nb)) + 1j * rng.normal(size=(2**n_atoms, nb))
        st /= np.linalg.norm(st, axis=0)
        sim.set_initial_state(Cplx(torch.as_tensor(st.real), torch.as_tensor(st.imag)))
    return sim


def _route(monkeypatch, sim: TorchEmulator, **options) -> bool:
    """The ``ckpt`` that ``run`` hands the fused evolution."""
    seen = {}

    def stub(ham, psi0, grid, method="DP5", ckpt=False):
        seen["ckpt"] = ckpt
        raise _Routed

    monkeypatch.setattr(backend, "evolve_states", stub)
    with pytest.raises(_Routed):
        sim.run(solver="DP5_PALLAS", **options)
    return seen["ckpt"]


@pytest.mark.parametrize(
    "n_atoms, nb, ckpt",
    [(12, 1, False), (12, 3, True), (14, 1, True), (16, 1, True)],
    ids=["12-atoms-nb1-K1K2", "12-atoms-nb3-K4K5", "14-atoms-K4K5", "16-atoms-K4K5"],
)
def test_default_route(monkeypatch, n_atoms, nb, ckpt):
    """12 atoms, one state: K1/K2.  12 atoms, three states (K2 holds at
    most two), and 14 atoms (no cluster holds them): K4/K5, as the JAX
    package runs them on its VMEM kernels.  16 atoms: K4/K5 by dim."""
    assert _route(monkeypatch, _emulator(n_atoms, nb)) is ckpt


def test_refusal_is_planned_for_both_kernels():
    """12 atoms, three states: K1 holds them and K2 does not, so the
    route follows K2's plan."""
    sim = _emulator(12, 3)
    hd = sim._hamiltonian._ham_data
    assert sim._route_ckpt(None, hd, "DP5") is True
    assert backend.cluster_fits(False, 3, 64, 64, 2, 2, 0, 6)
    assert not backend.cluster_fits(True, 3, 64, 64, 2, 2, 0, 6)


def test_explicit_ckpt_false_raises_naming_ckpt(monkeypatch):
    """14 atoms with ``ckpt=False``: the plan's ValueError, before any
    launch."""
    with pytest.raises(ValueError, match="ckpt=True"):
        _route(monkeypatch, _emulator(14), ckpt=False)


@pytest.mark.parametrize("n_atoms", [12, 14])
def test_explicit_ckpt_true_is_kept(monkeypatch, n_atoms):
    assert _route(monkeypatch, _emulator(n_atoms), ckpt=True) is True


def _all_basis_emulator(n_atoms: int) -> TorchEmulator:
    """bench.py's lattice with a rydberg_global and a raman_global pulse:
    the all basis, three levels a site (da = 3^(n // 2))."""
    reg = Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n_atoms)], prefix="q")
    seq = Sequence(reg, MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_global")
    seq.add(Pulse(ConstantWaveform(20, 1.0), ConstantWaveform(20, -2.0), 0.0), "ryd")
    seq.add(Pulse(ConstantWaveform(20, 0.7), ConstantWaveform(20, 0.5), 0.3), "ram",
            protocol="no-delay")
    return TorchEmulator.from_sequence(seq, sampling_rate=0.25, evaluation_times="Minimal",
                                       device="cpu")


@pytest.mark.parametrize("n_atoms, ckpt", [(2, False), (3, False), (4, False), (5, False),
                                           (6, False), (7, True), (8, True), (10, True)])
def test_all_basis_route(monkeypatch, n_atoms, ckpt):
    """The all basis runs one block a run (C = 1 for da = 3^a): K1/K2 up
    to 6 atoms (27 x 27); from 7 atoms (27 x 81) no block holds the plan
    and the route takes K4/K5 (8 atoms: 81 x 81, 10 atoms: 243 x 243,
    below dim 2^16), before any launch; ckpt=False there raises the
    plan's ValueError."""
    sim = _all_basis_emulator(n_atoms)
    assert sim.dim == 3 and sim.basis_name == "all"
    assert _route(monkeypatch, sim) is ckpt
    if ckpt:
        with pytest.raises(ValueError, match="ckpt=True"):
            _route(monkeypatch, sim, ckpt=False)

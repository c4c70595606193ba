"""The plain reference against closed forms and central differences."""

import math

import numpy as np
import pytest
import torch

from benchmark.protocols.rydberg_sweep import sine_matrix
from benchmark.reference.rydberg_sweep import Problem, problem_size
from benchmark.training import adam_steps

C6 = 5420158.53


def _cfg(coords, duration=660, knots=1, rate=0.25):
    return {"register": {"coords": coords}, "interaction": {"c6": C6},
            "pulse": {"duration_ns": duration, "sampling_rate": rate, "knots": knots},
            "solver": {"substeps": 1}, "target_index": 0}


def _constant(duration):
    """A matrix of one knot held over the whole pulse."""
    return np.ones((duration, 1))


@pytest.mark.parametrize("omega,delta", [(3.0, 0.0), (2.0, -2.0), (5.0, 1.5)])
def test_bench_one_atom_rabi(omega, delta):
    # generalised Rabi: P_r = O^2 / (O^2 + d^2) sin^2(sqrt(O^2 + d^2) T / 2)
    p = Problem(_cfg([[0.0, 0.0]]), _constant(660), torch.float64)
    got = float(p.loss(torch.tensor([[omega, delta]], dtype=torch.float64))[0])
    w = math.hypot(omega, delta)
    pr = omega**2 / w**2 * math.sin(w * 0.66 / 2) ** 2
    assert abs(got - (1 - pr)) < 1e-10


def test_bench_two_atoms_against_expm():
    # a constant H, the pair at 7 um: the dense exponential of the same H
    omega, delta, r = 2.5, -1.0, 7.0
    p = Problem(_cfg([[0.0, 0.0], [r, 0.0]]), _constant(660), torch.float64)
    got = float(p.loss(torch.tensor([[omega, delta]], dtype=torch.float64))[0])
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    n = np.diag([1.0, 0.0]).astype(complex)  # digit 0 is |r>
    eye = np.eye(2)
    h = (omega / 2 * (np.kron(sx, eye) + np.kron(eye, sx))
         - delta * (np.kron(n, eye) + np.kron(eye, n)) + C6 / r**6 * np.kron(n, n))
    vals, vecs = np.linalg.eigh(h)
    psi0 = np.zeros(4, dtype=complex)
    psi0[3] = 1.0  # both atoms in |g>
    psi = vecs @ (np.exp(-1j * vals * 0.66) * (vecs.conj().T @ psi0))
    want = 1 - abs(psi[0]) ** 2  # the target |rr>
    assert abs(got - want) < 1e-9


def test_bench_gradient_against_central_differences():
    # amplitude and detuning knots; the second candidate's amplitude is
    # below 0 wherever its last knot weighs, so relu holds it at 0 there
    # and that knot's gradient vanishes
    p = Problem(_cfg([[0.0, 0.0], [8.0, 0.0]], duration=120, knots=3), sine_matrix(3, 120),
                torch.float64)
    knots = torch.tensor([[1.5, 2.5, 1.0, -2.0, 0.5, 3.0],
                          [2.0, -1.0, -3.0, 1.0, -1.0, 2.0]], dtype=torch.float64)
    _, grad = p.value_and_grad(knots)
    h = 1e-5
    for j in range(6):
        e = torch.zeros_like(knots)
        e[:, j] = h
        fd = (p.loss(knots + e) - p.loss(knots - e)) / (2 * h)
        assert torch.allclose(grad[:, j], fd, rtol=1e-7, atol=1e-9)
    assert grad[1, 2] == 0 and grad[0, 2] != 0


def test_bench_adam_follows_torch():
    # the reference's Adam is torch.optim.Adam's update, step for step
    p = Problem(_cfg([[0.0, 0.0], [8.0, 0.0]], duration=120, knots=3), sine_matrix(3, 120),
                torch.float64)
    k0 = torch.tensor([[1.5, 2.5, 1.0, -2.0, 0.0, 2.0]], dtype=torch.float64)
    ref = adam_steps(p, k0, 3, 0.01)
    x = k0.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=0.01)
    for t in range(3):
        opt.zero_grad()
        loss = p.loss(x)
        assert torch.allclose(loss.detach(), ref["losses"][t], rtol=0, atol=1e-14)
        loss.sum().backward()
        opt.step()
    assert torch.allclose(x.detach(), ref["knots"], rtol=0, atol=1e-14)


def test_bench_substeps_follow_the_stability_bound():
    cfg = _cfg([[12.0 * i, 0.0] for i in range(12)], duration=1100, knots=15)
    p = Problem(cfg, sine_matrix(15, 1100), torch.float64)
    p.check_substeps(torch.full((1, 30), 6.0, dtype=torch.float64))
    with pytest.raises(ValueError):
        p.check_substeps(torch.full((1, 30), 40.0, dtype=torch.float64))


def test_bench_problem_size_of_the_cells():
    cfg = _cfg([[0.0, 0.0]] * 12, duration=1100, knots=15)
    assert problem_size(cfg) == {"atoms": 12, "steps": 276, "stages": 6, "axpys": 20,
                                 "slots": 2, "samples": 275, "streams": 2}

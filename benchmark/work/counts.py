"""Operations and bytes of the evolution and its adjoint, counted from the
problem and not from the port's tensors.

The problem (a protocol's ``problem_size``): ``atoms`` (the dimension is
2^atoms), ``steps`` of the integration grid, ``stages`` of the
Runge-Kutta scheme and ``axpys``, its nonzero stage and output weights
(each a complex y + c k), the evaluation ``slots`` whose states the
forward pass writes, and ``samples`` of each coefficient stream
(``streams`` of them); the ``runs`` are the candidates solved together.

H(t) psi is counted matrix free, as the problem allows: a real diagonal
(interaction and detuning) times psi, 2 real operations an entry, and
per atom one drive term, a real coefficient times psi with that atom
flipped, added in: 4 an entry.  A complex y + c k is 4 an entry.  The
adjoint of a step recomputes the step's stages from its start (the
forward pass keeps only the evaluation slots) and applies H(t)^T once
per stage, with the stages' weights; it contracts each stage's costate
with the drive term's output for the coefficients' gradient, 4 an entry
(the real part of a complex dot product).

Bytes: each input read once and each output written once, at 8 bytes a
real number (the float64 of the problem, or the two f32 words that hold
it): the initial state, the slot states, the interaction diagonal and
the coefficient streams; for the adjoint, the slot states and their
cotangents in, and the initial state's cotangent and the streams'
cotangents out.
"""

from __future__ import annotations

from typing import Mapping

from benchmark.work.peaks import F32_FLOPS, HBM_BYTES_PER_S

WORD = 8


def _apply_ops(atoms: int) -> int:
    return (2 + 4 * atoms) * 2**atoms


def forward(size: Mapping, runs: int) -> tuple[int, int]:
    """(operations, bytes) of the forward evolution of ``runs`` runs."""
    n, dim = size["atoms"], 2 ** size["atoms"]
    per_step = size["stages"] * _apply_ops(n) + size["axpys"] * 4 * dim
    ops = runs * size["steps"] * per_step
    state = 2 * dim * WORD
    nbytes = (runs * (1 + size["slots"]) * state + dim * WORD
              + runs * size["streams"] * size["samples"] * WORD)
    return ops, nbytes


def adjoint(size: Mapping, runs: int) -> tuple[int, int]:
    """(operations, bytes) of the discrete adjoint of ``runs`` runs."""
    n, dim = size["atoms"], 2 ** size["atoms"]
    per_step = (2 * size["stages"] * _apply_ops(n) + 2 * size["axpys"] * 4 * dim
                + size["stages"] * 4 * dim)
    ops = runs * size["steps"] * per_step
    state = 2 * dim * WORD
    streams = runs * size["streams"] * size["samples"] * WORD
    nbytes = runs * (2 * size["slots"] + 1) * state + dim * WORD + 2 * streams
    return ops, nbytes


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time the work could take on the chip: operations at the
    f32 rate or bytes at the HBM rate, whichever is longer."""
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)

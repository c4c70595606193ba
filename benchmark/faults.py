"""Faults planted under the timed path of a training cell, to show that
the comparison catches them (the fault tests, and ``calibrate.py
--fault``):

* ``unchanged``: the step returns the training state unchanged (Adam's
  moments advance, the knots come back as they were);
* ``half_batch``: half of the candidates left out of the loss (their
  values kept, their gradient gone), the update taken over the rest;
* ``altered``: each answer altered where it is produced, the loss off by
  a relative ``ALTER``;
* ``late_altered``: as ``altered``, but only from the first epoch after
  set-up on: a fault that the set-up epochs cannot see.
"""

from __future__ import annotations

import torch

ALTER = 1e-3
FAULTS = ("unchanged", "half_batch", "altered", "late_altered")


def plant(loop, fault: str, setup_epochs: int = 0) -> None:
    """Break ``loop`` (a ``training.ClosedLoop``) underneath by ``fault``;
    ``setup_epochs``: the epochs set-up runs before the window."""
    evaluate = loop.evaluate
    if fault == "unchanged":
        step = loop.opt.step

        def unchanged(closure=None):
            # the optimiser's state advances; the parameters come back as they were
            kept = [leaf.detach().clone() for leaf in loop.leaves]
            step()
            with torch.no_grad():
                for leaf, k in zip(loop.leaves, kept):
                    leaf.copy_(k)
        loop.opt.step = unchanged
    elif fault == "half_batch":
        def half(stack):
            v = evaluate(stack)
            keep = (len(v) + 1) // 2
            return torch.cat([v[:keep], v[keep:].detach()])
        loop.evaluate = half
    elif fault == "altered":
        loop.evaluate = lambda stack: evaluate(stack) * (1 + ALTER)
    elif fault == "late_altered":
        calls = [0]

        def late(stack):
            calls[0] += 1
            v = evaluate(stack)
            return v * (1 + ALTER) if calls[0] > setup_epochs else v
        loop.evaluate = late
    else:
        raise ValueError(f"unknown fault {fault!r}")

"""Training loops as the window drives them, and the comparison that
decides ``correct`` for them.

A traffic mix names its driver (``"entry"``, found as
``benchmark/drivers/<entry>.py``); the training drivers build their
session on ``Training`` and say only how the program's side is made (the
leaves that Adam updates and the call that evaluates them).  The mix's
parameters:

* ``candidates``: P, the candidates trained in lock-step;
* ``lr``: Adam's learning rate (``torch.optim.Adam``, default betas);
* ``setup_epochs``: the epochs that set-up runs through the window's
  own call, which the reference follows;
* ``trace_seconds``: the end of the window that a ``--trace 1`` run
  records with the profiler.

Each epoch is forward, loss, backward, Adam, the constraints' clamp and
the loss read on the host: a client that waits for each step's loss
before it sends the next, so the loop is closed.  The loop keeps a
host-clock span of each part of every epoch.

The comparison (numbers against ``benchmark/limits/<workload>.json``):

* ``loss_gap``: the widest gap of a set-up epoch's loss, candidate by
  candidate, over the reference's (or over 1 where that is smaller);
* ``grad_gap``: the first gradient as the optimiser holds it (its first
  moment after one step, over 1 - beta1), by the worst leaf: the gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``step_gap``: the knots' change over the set-up epochs, by the worst
  leaf, measured as ``grad_gap`` is; a leaf whose reference gradient is
  under a thousandth of the median leaf's is left out (Adam moves it by
  round-off alone);
* ``window_loss_gap`` and ``window_grad_gap``: once the window has
  closed, the same object runs one more epoch; its loss and its
  gradient (``.grad``, at the knots it started from) against the
  reference's value and gradient at those knots, measured as
  ``loss_gap`` and ``grad_gap`` are.  They cover the state that the
  window left behind, which the set-up epochs cannot.

A leaf is one candidate's knots (a population's stack is P leaves).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Mapping, Optional

import torch

PARTS = ("forward", "backward", "bookkeeping", "adam", "constraints", "loss_read")
NUMBERS = ("loss_gap", "grad_gap", "step_gap", "window_loss_gap", "window_grad_gap")


def _rows(t: torch.Tensor, n_pop: int) -> torch.Tensor:
    return t.reshape(n_pop, -1)


class ClosedLoop:
    """A candidate stack trained by ``evaluate`` and Adam.

    ``leaves``: the tensors Adam updates, each (k,) for one candidate or
    (P, k) for a stack; a candidate's knots are its rows of the leaves,
    side by side.  ``evaluate``: (P, n) knots -> (P,) losses,
    differentiable: the program's value path, or the reference in its
    place (the control).  ``clamp``: the constraints' clamp, in place.
    ``population``: keep ``fit_population``'s best-candidate bookkeeping."""

    def __init__(self, traffic: Mapping, leaves: list, n_pop: int,
                 evaluate: Callable[[torch.Tensor], torch.Tensor],
                 clamp: Optional[Callable[[], None]] = None, population: bool = False) -> None:
        self.leaves = leaves
        self.n_pop = n_pop
        self.evaluate = evaluate
        self.clamp = clamp
        self.population = population
        self.opt = torch.optim.Adam(leaves, lr=float(traffic["lr"]))
        ref = leaves[0]
        self.best_loss = torch.full((n_pop,), math.inf, dtype=ref.dtype, device=ref.device)
        self.best = [leaf.detach().clone() for leaf in leaves]
        # set while a profiler records: a label for each part
        self.record_function: Optional[Callable] = None
        self.spans: list[dict] = []  # per epoch: host seconds of each part

    def stack(self) -> torch.Tensor:
        """The candidates' knots as (P, n)."""
        return torch.cat([_rows(leaf, self.n_pop) for leaf in self.leaves], 1)

    def grad(self) -> torch.Tensor:
        """The gradient of the last epoch, (P, n)."""
        return torch.cat([_rows(leaf.grad, self.n_pop) for leaf in self.leaves], 1)

    def first_grad(self) -> torch.Tensor:
        """The first gradient as Adam holds it after one step: its first
        moment over (1 - beta1), (P, n)."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        return torch.cat([_rows(self.opt.state[leaf]["exp_avg"].detach(), self.n_pop)
                          for leaf in self.leaves], 1) / (1 - beta1)

    def epoch(self) -> torch.Tensor:
        """One training epoch; returns the candidates' losses (P,) as read
        on the host."""
        spans: dict = {}

        @contextlib.contextmanager
        def part(label: str):
            t0 = time.perf_counter()
            with (self.record_function(label) if self.record_function
                  else contextlib.nullcontext()):
                yield
            spans[label] = time.perf_counter() - t0

        with part("forward"):
            self.opt.zero_grad()
            per = self.evaluate(self.stack())
        with part("backward"):
            per.sum().backward()
        if self.population:
            # fit_population's order: the best-ever bookkeeping on the
            # evaluated stack, then the update
            with part("bookkeeping"):
                per = per.detach()
                improved = per < self.best_loss
                self.best_loss = torch.where(improved, per, self.best_loss)
                self.best = [torch.where(improved.reshape((-1,) + (1,) * (b.ndim - 1)),
                                         leaf.detach(), b)
                             for leaf, b in zip(self.leaves, self.best)]
                self.final = [leaf.detach().clone() for leaf in self.leaves]
        with part("adam"):
            self.opt.step()
        with part("constraints"):
            if self.clamp is not None:
                self.clamp()
        with part("loss_read"):
            host = per.detach().cpu()
        self.spans.append(spans)
        return host


class _Control:
    """The control: the plain reference, in the working precision below
    the configuration's, put in the program's place."""

    def __init__(self, reference, cfg: Mapping, matrix, device) -> None:
        low = {"float64": torch.float32}[cfg["solver"]["precision"]]
        problem = reference.Problem(cfg, matrix, low, device)

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, stack):
                vals, grad = problem.value_and_grad(stack)
                ctx.save_for_backward(grad.to(stack.dtype))
                return vals.to(stack.dtype)

            @staticmethod
            def backward(ctx, g):
                (grad,) = ctx.saved_tensors
                return g[:, None] * grad

        self.fn = Fn

    def __call__(self, stack):
        return self.fn.apply(stack)


class Training:
    """One side of a training cell: ``port`` (the program) or ``control``.

    A driver subclasses it and gives ``program(model)``: (leaves,
    evaluate, clamp) over the program's model."""

    PARTS = PARTS
    population = False

    def __init__(self, cell, inputs: Mapping, device, side: str = "port") -> None:
        self.cell, self.inputs = cell, inputs
        self.records: dict = {}
        knots = inputs["knots"]
        n_pop = int(cell.traffic["candidates"])
        self.model = None
        if side == "control":
            leaves = [knots[:n_pop].detach().clone().requires_grad_(True)]
            ctl = _Control(cell.reference, cell.cfg, inputs["matrix"], device)
            self.loop = ClosedLoop(cell.traffic, leaves, n_pop, ctl)
            return
        self.model = cell.protocol.build_model(cell.cfg, inputs, device)
        leaves, evaluate, clamp = self.program(self.model)
        self.loop = ClosedLoop(cell.traffic, leaves, n_pop, evaluate, clamp, self.population)

    def program(self, model):
        raise NotImplementedError

    @property
    def spans(self) -> list:
        return self.loop.spans

    @property
    def record_function(self):
        return self.loop.record_function

    @record_function.setter
    def record_function(self, fn) -> None:
        self.loop.record_function = fn

    def epoch(self) -> torch.Tensor:
        return self.loop.epoch()

    def set_up(self) -> None:
        """The set-up epochs through the window's own call; their record,
        float64 on the CPU."""
        loop = self.loop
        knots0 = loop.stack().detach().double().cpu().clone()
        losses, first = [], None
        for i in range(int(self.cell.traffic["setup_epochs"])):
            losses.append(loop.epoch().double())
            if i == 0:
                first = loop.first_grad().double().cpu()
        self.records["setup"] = {"losses": torch.stack(losses), "first_grad": first,
                                 "knots0": knots0,
                                 "knots": loop.stack().detach().double().cpu().clone()}

    def after_window(self) -> torch.Tensor:
        """One more epoch of the object the window drove: the knots it
        starts from, its losses and its gradient.  Returns its losses."""
        loop = self.loop
        knots = loop.stack().detach().double().cpu().clone()
        losses = loop.epoch()
        self.records["window"] = {"knots": knots, "losses": losses.double(),
                                  "grad": loop.grad().detach().double().cpu()}
        return losses

    def free(self) -> None:
        self.loop = self.model = None


def adam_steps(problem, knots0: torch.Tensor, n_steps: int, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Follow ``n_steps`` epochs of Adam (Kingma and Ba, 2015) from
    ``knots0`` (P, n) on the reference's ``value_and_grad``, each
    candidate on its own loss: the losses of every epoch (n_steps, P),
    the first gradient (P, n), and the knots after the last update
    (float64)."""
    p = knots0.detach().double().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses, first_grad = [], None
    for t in range(1, n_steps + 1):
        loss, g = problem.value_and_grad(p)
        losses.append(loss)
        if first_grad is None:
            first_grad = g
        m = betas[0] * m + (1 - betas[0]) * g
        v = betas[1] * v + (1 - betas[1]) * g * g
        m_hat = m / (1 - betas[0]**t)
        v_hat = v / (1 - betas[1]**t)
        p = p - lr * m_hat / (v_hat.sqrt() + eps)
    return {"losses": torch.stack(losses), "first_grad": first_grad, "knots": p}


def reference_records(cell, inputs: Mapping, records: Mapping, device) -> dict:
    """The float64 reference's records: the set-up epochs followed from
    the same knots, and the value and gradient at the knots the program
    started its after-window epoch from."""
    problem = cell.reference.Problem(cell.cfg, inputs["matrix"], torch.float64, device)
    knots0 = records["setup"]["knots0"].to(device)
    problem.check_substeps(knots0)
    out = {"setup": {k: v.cpu() for k, v in adam_steps(
        problem, knots0, int(cell.traffic["setup_epochs"]), float(cell.traffic["lr"])).items()}}
    if "window" in records:
        knots = records["window"]["knots"].to(device)
        problem.check_substeps(knots)
        loss, grad = problem.value_and_grad(knots)
        out["window"] = {"losses": loss.cpu(), "grad": grad.cpu()}
    return out


def _loss_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    lp, lr = prog.double(), ref.double()
    return float(((lp - lr).abs() / lr.abs().clamp(min=1.0)).max())


def _worst_norm_gap(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor) -> float:
    """Worst row's |‖prog‖ - ‖ref‖| over max(‖ref‖, median row ‖ref‖)."""
    pn, rn = prog.norm(dim=1)[keep], ref.norm(dim=1)[keep]
    if not len(rn):
        return math.nan
    scale = torch.clamp(rn, min=float(rn.median()))
    return float(((pn - rn).abs() / scale).max())


def readings(prog: Mapping, ref: Mapping) -> dict:
    """The numbers from the program's records and the reference's (both
    float64 on the CPU); the window's only where the program has its
    record."""
    p, r = prog["setup"], ref["setup"]
    g_ref = r["first_grad"]
    every = torch.ones(g_ref.shape[0], dtype=torch.bool)
    gn = g_ref.norm(dim=1)
    moved = gn >= 1e-3 * float(gn.median())
    out = {"loss_gap": _loss_gap(p["losses"], r["losses"]),
           "grad_gap": _worst_norm_gap(p["first_grad"], g_ref, every),
           "step_gap": _worst_norm_gap(p["knots"] - p["knots0"], r["knots"] - p["knots0"],
                                       moved)}
    if "window" in prog:
        pw, rw = prog["window"], ref["window"]
        out["window_loss_gap"] = _loss_gap(pw["losses"], rw["losses"])
        out["window_grad_gap"] = _worst_norm_gap(pw["grad"], rw["grad"], every)
    return out


def compare(cell, inputs: Mapping, records: Mapping, device) -> dict:
    """The comparison of a training cell: its numbers by name."""
    return readings(records, reference_records(cell, inputs, records, device))

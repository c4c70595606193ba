"""Deferred expressions over sequence variables (counterpart of
pulser_diff_tpu/core/variables.py).

A :class:`Variable` is declared on a Sequence; arithmetic on it builds a
small expression tree, and ``evaluate(values)`` substitutes tensors, so a
sequence built from ``nn.Parameter`` values is differentiable through
autograd.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Mapping

import torch


class Expr:
    """Base class for deferred expressions over sequence variables."""

    def evaluate(self, values: Mapping[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def variables(self) -> set[str]:
        raise NotImplementedError

    def _binop(self, other: Any, fn: Callable, name: str, reverse: bool = False) -> "Expr":
        a, b = (other, self) if reverse else (self, other)
        return OpCall(fn, (a, b), name)

    def __add__(self, o: Any) -> "Expr":
        return self._binop(o, operator.add, "add")

    def __radd__(self, o: Any) -> "Expr":
        return self._binop(o, operator.add, "add", reverse=True)

    def __sub__(self, o: Any) -> "Expr":
        return self._binop(o, operator.sub, "sub")

    def __rsub__(self, o: Any) -> "Expr":
        return self._binop(o, operator.sub, "sub", reverse=True)

    def __mul__(self, o: Any) -> "Expr":
        return self._binop(o, operator.mul, "mul")

    def __rmul__(self, o: Any) -> "Expr":
        return self._binop(o, operator.mul, "mul", reverse=True)

    def __truediv__(self, o: Any) -> "Expr":
        return self._binop(o, operator.truediv, "div")

    def __rtruediv__(self, o: Any) -> "Expr":
        return self._binop(o, operator.truediv, "div", reverse=True)

    def __pow__(self, o: Any) -> "Expr":
        return self._binop(o, operator.pow, "pow")

    def __neg__(self) -> "Expr":
        return OpCall(operator.neg, (self,), "neg")

    def __abs__(self) -> "Expr":
        return OpCall(_unary(torch.abs), (self,), "abs")

    def __getitem__(self, idx: int) -> "Expr":
        if isinstance(self, Variable):
            return VariableItem(self, idx)
        return OpCall(lambda x: x[idx], (self,), f"getitem[{idx}]")

    # the math functions of pulser's ParamObj
    def tanh(self) -> "Expr":
        return OpCall(_unary(torch.tanh), (self,), "tanh")

    def sin(self) -> "Expr":
        return OpCall(_unary(torch.sin), (self,), "sin")

    def cos(self) -> "Expr":
        return OpCall(_unary(torch.cos), (self,), "cos")

    def exp(self) -> "Expr":
        return OpCall(_unary(torch.exp), (self,), "exp")

    def sqrt(self) -> "Expr":
        return OpCall(_unary(torch.sqrt), (self,), "sqrt")

    def log(self) -> "Expr":
        return OpCall(_unary(torch.log), (self,), "log")


def _unary(fn: Callable) -> Callable:
    """``fn`` on a tensor, a number made an f64 tensor first."""
    return lambda x: fn(x if isinstance(x, torch.Tensor)
                        else torch.as_tensor(x, dtype=torch.float64))


class Variable(Expr):
    """A named, sized placeholder declared on a sequence."""

    def __init__(self, name: str, size: int = 1, dtype: type = float) -> None:
        self.name = name
        self.size = size
        self.dtype = dtype

    @property
    def var(self) -> "Variable":
        return self

    def evaluate(self, values: Mapping[str, Any]) -> torch.Tensor:
        if self.name not in values:
            raise ValueError(f"No value given for variable '{self.name}'.")
        val = values[self.name]
        arr = val if isinstance(val, torch.Tensor) else torch.as_tensor(val, dtype=torch.float64)
        if self.dtype is int and arr.is_floating_point():
            arr = torch.round(arr).to(torch.int64)
        return arr

    def variables(self) -> set[str]:
        return {self.name}

    def __len__(self) -> int:
        return self.size

    def __iter__(self):
        return (VariableItem(self, i) for i in range(self.size))

    def __repr__(self) -> str:
        return f"Variable({self.name!r}, size={self.size})"


class VariableItem(Expr):
    """A single element of a sized Variable."""

    def __init__(self, var: Variable, index: int) -> None:
        self.var = var
        self.index = index

    def evaluate(self, values: Mapping[str, Any]) -> torch.Tensor:
        arr = self.var.evaluate(values)
        if arr.ndim == 0:
            if self.index != 0:
                raise IndexError(
                    f"index {self.index} out of range for scalar variable "
                    f"'{self.var.name}'"
                )
            return arr
        return arr[self.index]

    def variables(self) -> set[str]:
        return {self.var.name}

    def __repr__(self) -> str:
        return f"{self.var.name}[{self.index}]"


class OpCall(Expr):
    """A deferred function application over expressions and constants."""

    def __init__(self, fn: Callable, args: tuple, opname: str) -> None:
        self.fn = fn
        self.args = args
        self.opname = opname

    def evaluate(self, values: Mapping[str, Any]) -> torch.Tensor:
        return self.fn(*[evaluate(a, values) for a in self.args])

    def variables(self) -> set[str]:
        out: set[str] = set()
        for a in self.args:
            if isinstance(a, Expr):
                out |= a.variables()
        return out

    def __repr__(self) -> str:
        return f"OpCall({self.opname}, {self.args})"


def evaluate(x: Any, values: Mapping[str, Any]) -> Any:
    """Evaluate ``x`` if it is an Expr, else return it unchanged."""
    return x.evaluate(values) if isinstance(x, Expr) else x


def contains_expr(x: Any) -> bool:
    return isinstance(x, Expr)

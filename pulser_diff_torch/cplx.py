"""Split-complex arithmetic (counterpart of pulser_diff_tpu/cplx.py).

Every complex quantity is a pair of real tensors ``(re, im)``.  The port
keeps this layout, which the JAX package chose for the TPU, at every
public function: the fused kernels work on split re/im f32 words, and the
tests compare the two packages array for array.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Union

import numpy as np
import torch


Scalar = Union[int, float, complex]


class Cplx(NamedTuple):
    """A complex tensor stored as separate real and imaginary parts."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.re.shape)

    @property
    def ndim(self) -> int:
        return self.re.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.re.dtype

    @property
    def device(self) -> torch.device:
        return self.re.device

    def __add__(self, other: "Cplx | Scalar") -> "Cplx":
        other = as_cplx(other, like=self)
        return Cplx(self.re + other.re, self.im + other.im)

    __radd__ = __add__

    def __sub__(self, other: "Cplx | Scalar") -> "Cplx":
        other = as_cplx(other, like=self)
        return Cplx(self.re - other.re, self.im - other.im)

    def __rsub__(self, other: "Cplx | Scalar") -> "Cplx":
        other = as_cplx(other, like=self)
        return Cplx(other.re - self.re, other.im - self.im)

    def __mul__(self, other: "Cplx | Scalar | torch.Tensor") -> "Cplx":
        if isinstance(other, Cplx):
            return Cplx(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        if isinstance(other, complex):
            return self * as_cplx(other, like=self)
        return Cplx(self.re * other, self.im * other)

    __rmul__ = __mul__

    def __truediv__(self, other: "Cplx | Scalar | torch.Tensor") -> "Cplx":
        if isinstance(other, Cplx):
            den = other.re * other.re + other.im * other.im
            return Cplx((self.re * other.re + self.im * other.im) / den,
                        (self.im * other.re - self.re * other.im) / den)
        if isinstance(other, complex):
            return self / as_cplx(other, like=self)
        return Cplx(self.re / other, self.im / other)

    def __neg__(self) -> "Cplx":
        return Cplx(-self.re, -self.im)

    def __getitem__(self, idx: Any) -> "Cplx":
        return Cplx(self.re[idx], self.im[idx])

    def conj(self) -> "Cplx":
        return Cplx(self.re, -self.im)

    @property
    def T(self) -> "Cplx":
        """Transpose (all axes reversed, as numpy's ``.T``)."""
        perm = tuple(range(self.re.ndim - 1, -1, -1))
        return Cplx(self.re.permute(perm), self.im.permute(perm))

    @property
    def mH(self) -> "Cplx":
        """Conjugate transpose over the last two axes."""
        return Cplx(self.re.transpose(-1, -2), -self.im.transpose(-1, -2))

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def abs(self) -> torch.Tensor:
        return torch.sqrt(self.abs2())

    def reshape(self, *shape) -> "Cplx":
        return Cplx(self.re.reshape(*shape), self.im.reshape(*shape))

    def flatten(self) -> "Cplx":
        return Cplx(self.re.reshape(-1), self.im.reshape(-1))

    def astype(self, dtype: torch.dtype) -> "Cplx":
        return Cplx(self.re.to(dtype), self.im.to(dtype))

    def transpose(self, *axes) -> "Cplx":
        return Cplx(self.re.permute(*axes), self.im.permute(*axes))

    def to(self, *args, **kwargs) -> "Cplx":
        return Cplx(self.re.to(*args, **kwargs), self.im.to(*args, **kwargs))

    def sum(self, axis=None, keepdims: bool = False) -> "Cplx":
        if axis is None:
            return Cplx(self.re.sum(), self.im.sum())
        return Cplx(
            self.re.sum(dim=axis, keepdim=keepdims),
            self.im.sum(dim=axis, keepdim=keepdims),
        )

    def mul_i(self) -> "Cplx":
        """Multiply by +i (rotates (re, im) -> (-im, re))."""
        return Cplx(-self.im, self.re)

    def mul_neg_i(self) -> "Cplx":
        """Multiply by -i (rotates (re, im) -> (im, -re))."""
        return Cplx(self.im, -self.re)

    def to_numpy(self) -> np.ndarray:
        return (
            self.re.detach().cpu().numpy()
            + 1j * self.im.detach().cpu().numpy()
        )


def as_cplx(x: Any, like: Cplx | None = None, dtype=None, device=None) -> Cplx:
    """Coerce scalars, numpy arrays and tensors into a Cplx."""
    if isinstance(x, Cplx):
        return x
    if like is not None:
        dtype = dtype or like.dtype
        device = device or like.device
    # float64 by default, as jnp.asarray under the JAX package's x64 mode
    dtype = dtype or torch.float64
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return Cplx(x.real.to(dtype), x.imag.to(dtype))
        r = x.to(dtype=dtype, device=device or x.device)
        return Cplx(r, torch.zeros_like(r))
    arr = np.asarray(x)
    re = torch.as_tensor(np.ascontiguousarray(arr.real), dtype=dtype, device=device)
    im = torch.as_tensor(
        np.ascontiguousarray(arr.imag if np.iscomplexobj(arr) else np.zeros_like(arr.real)),
        dtype=dtype,
        device=device,
    )
    return Cplx(re, im)


def ckron(a: Cplx, b: Cplx) -> Cplx:
    return Cplx(
        torch.kron(a.re, b.re) - torch.kron(a.im, b.im),
        torch.kron(a.re, b.im) + torch.kron(a.im, b.re),
    )


def cstack(xs: Sequence[Cplx], axis: int = 0) -> Cplx:
    return Cplx(
        torch.stack([x.re for x in xs], dim=axis),
        torch.stack([x.im for x in xs], dim=axis),
    )


def czeros(shape, dtype=None, device=None) -> Cplx:
    z = torch.zeros(shape, dtype=dtype or torch.float64, device=device)
    return Cplx(z, z.clone())


def cones(shape, dtype=None, device=None) -> Cplx:
    return Cplx(torch.ones(shape, dtype=dtype or torch.float64, device=device),
                torch.zeros(shape, dtype=dtype or torch.float64, device=device))


def ceye(n: int, dtype=None, device=None) -> Cplx:
    return Cplx(torch.eye(n, dtype=dtype or torch.float64, device=device),
                torch.zeros(n, n, dtype=dtype or torch.float64, device=device))


def cexp_i(theta: torch.Tensor) -> Cplx:
    """exp(i theta) for real theta."""
    return Cplx(torch.cos(theta), torch.sin(theta))


def cmatmul(a: Cplx, b: Cplx) -> Cplx:
    """Complex matmul from four real ones."""
    return Cplx(a.re @ b.re - a.im @ b.im, a.re @ b.im + a.im @ b.re)


def cmatmul_rc(a: torch.Tensor, b: Cplx) -> Cplx:
    """Real @ complex."""
    return Cplx(a @ b.re, a @ b.im)


def cmatmul_cr(a: Cplx, b: torch.Tensor) -> Cplx:
    """Complex @ real."""
    return Cplx(a.re @ b, a.im @ b)


def cdot(a: Cplx, b: Cplx) -> Cplx:
    """<a|b> = sum(conj(a) * b) over all elements."""
    return Cplx((a.re * b.re + a.im * b.im).sum(), (a.re * b.im - a.im * b.re).sum())


def cnorm2(a: Cplx) -> torch.Tensor:
    return a.abs2().sum()


def cnorm(a: Cplx) -> torch.Tensor:
    return torch.sqrt(cnorm2(a))


def cconcat(xs: Sequence[Cplx], axis: int = 0) -> Cplx:
    return Cplx(torch.cat([x.re for x in xs], dim=axis), torch.cat([x.im for x in xs], dim=axis))


# the complex einsum lives beside the f32-pinned real einsum it is made of;
# imported last, as ops/ imports this module's names first
from pulser_diff_torch.ops.apply import ceinsum  # noqa: E402,F401

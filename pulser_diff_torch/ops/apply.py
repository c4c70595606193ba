"""Factorized Hamiltonian application (counterpart of pulser_diff_tpu/ops/apply.py).

The N-qudit state is a (d^a, d^b) split-complex matrix Psi, and

    H(t) = Hrow(t) (x) I  +  I (x) Hcol(t)  +  diag(U)
           + sum_k z_k(t) (R_k (x) C_k) + h.c.

with Hrow, Hcol assembled from static stacks of real part matrices and
complex coefficient streams, U the static van der Waals diagonal (ising)
and the (R_k, C_k) kron pairs the XY dipole flip-flop terms, applied as
R @ Psi @ C^T without building the dim x dim matrix.

In f32 (the ``*_F32`` solver modes) every product runs through
:func:`_mm` or :func:`_einsum`, at full f32 precision in the forward and
the backward pass whatever the caller's TF32 setting, as the JAX package
pins the f32 solve to ``Precision.HIGHEST``.

The density-matrix forms (``h_apply_rho_left``, ``apply_local_left`` /
``_right``) serve the factored Lindblad right-hand side of ``mesolve``.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import NamedTuple, Optional, Union

import torch

from pulser_diff_torch.cplx import Cplx


class FactoredHamiltonian(NamedTuple):
    """The factorized Hamiltonian terms (real part stacks, complex streams)."""

    row_parts: torch.Tensor  # (Pr, da, da) real
    col_parts: torch.Tensor  # (Pc, db, db) real
    row_streams: Cplx  # (Pr, Ts)
    col_streams: Cplx  # (Pc, Ts)
    int_diag: torch.Tensor  # (da, db) real static diagonal (vdW)
    # us between stream samples (an f32 0-d tensor once cast for the f32
    # modes, so the sample index is computed in f32 as in the JAX package)
    sample_dt: Union[float, torch.Tensor]
    n_samples: int  # Ts
    # XY flip-flop terms z_k (R_k (x) C_k) + h.c., or None
    kron_row: Optional[torch.Tensor] = None  # (K, da, da) real
    kron_col: Optional[torch.Tensor] = None  # (K, db, db) real
    kron_streams: Optional[Cplx] = None  # (K, Ts)

    @property
    def da(self) -> int:
        return self.row_parts.shape[-1]

    @property
    def db(self) -> int:
        return self.col_parts.shape[-1]

    @property
    def dim(self) -> int:
        return self.da * self.db


def _is_dtensor(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor (without importing torch.distributed.tensor,
    which no DTensor exists without)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _gather(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """s[:, idx].  A 0-d index (the steppers' one time a stage) is taken as
    one ``index_select`` on the device: indexing with a 0-d tensor reads it
    on the host (a sync a stage, and an unbacked value under
    torch.export).  A wider index keeps the indexing, whose backward on
    CUDA accumulates in a fixed order (``index_select``'s adds atomically,
    so a gradient would change from call to call); so does a DTensor
    stream (parallel/'s replicated Hamiltonian), under which its gradient
    flows."""
    if idx.ndim or _is_dtensor(s):
        return s[:, idx]
    return s.index_select(1, idx.reshape(1)).view(-1)


def interp_streams(h: FactoredHamiltonian, t: torch.Tensor):
    """Linearly interpolate all coefficient streams at times ``t`` (us).

    Follows the JAX package's index rule, which departs from upstream's:
    the full grid is interpolated (idx2 = idx1 + 1 <= Ts-1), so the last
    sample is read.  Returns (zr, zc, zk) with leading axes = t.shape and
    the part axis last; zk (the kron-pair streams) is None without kron
    pairs.
    """
    Ts = h.n_samples
    dt = h.sample_dt
    idx1 = torch.clamp(torch.floor(t / dt).to(torch.int64), 0, Ts - 2)
    idx2 = idx1 + 1
    w = (t - idx1.to(t.dtype) * dt) / dt

    def _take(streams: Cplx) -> Cplx:
        out = []
        for s in (streams.re, streams.im):
            s1 = _gather(s, idx1)  # (P, ...)
            s2 = _gather(s, idx2)
            z = s1 + (s2 - s1) * w
            out.append(z.movedim(0, -1))
        return Cplx(*out)

    zk = _take(h.kron_streams) if h.kron_streams is not None else None
    return _take(h.row_streams), _take(h.col_streams), zk


# this thread's nesting depth of _f32_full_precision: inside, a product
# that needs no gradient runs directly, and an inner block changes nothing;
# ``whole``: the block's differentiation runs inside it too
_PINNED = threading.local()


def _depth() -> int:
    return getattr(_PINNED, "depth", 0)


@contextlib.contextmanager
def _f32_full_precision(whole: bool = False):
    """cuBLAS f32 products at full f32 precision (no TF32) inside the block,
    through whichever of PyTorch's two switches the caller set (the legacy
    ``allow_tf32``, whose getter raises once the per-backend
    ``fp32_precision`` was set alone); both are restored after it.  With
    ``whole`` the caller differentiates inside the block too
    (``torch.func.vjp`` and its pullback), so no product needs an autograd
    Function of its own to pin its backward pass."""
    if _depth():
        yield
        return
    m = torch.backends.cuda.matmul
    new = getattr(m, "fp32_precision", None)
    try:
        prev = m.allow_tf32
    except RuntimeError:
        prev = None
    if prev is None:
        m.fp32_precision = "ieee"
    else:
        m.allow_tf32 = False
    _PINNED.depth, _PINNED.whole = 1, whole
    try:
        yield
    finally:
        _PINNED.depth, _PINNED.whole = 0, False
        if prev is not None:
            m.allow_tf32 = prev
        if new is not None:
            m.fp32_precision = new


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.  Where a or b is 2-D, one ``mm`` or ``bmm`` on views, the same
    kernel whether or not the operands require grad.  ``torch.matmul``
    picks its kernel by that (so a reloaded exported step, which runs
    without autograd, would round otherwise than the eager step), and it
    reshapes its operands inside itself, where autograd saves tensors that
    a ``torch.export`` trace calling ``torch.autograd.grad`` never sees (it
    would freeze them into the artifact as constants)."""
    if b.ndim == 2:  # (..., m, k) @ (k, n): the batch folds into the rows
        return torch.mm(a.reshape(-1, a.shape[-1]), b).view(*a.shape[:-1], b.shape[-1])
    if a.ndim == 2:  # (m, k) @ (..., k, n)
        b3 = b.reshape(-1, *b.shape[-2:])
        return torch.bmm(a.expand(b3.shape[0], *a.shape), b3).view(
            *b.shape[:-2], a.shape[0], b.shape[-1])
    return a @ b


class _F32Matmul(torch.autograd.Function):
    """a @ b (both at least 2-D, broadcasting) with the forward and the
    backward products at full f32 precision: the backward pass runs later,
    under whatever setting the caller has then, so a context manager
    around the forward alone would not pin it."""

    @staticmethod
    def forward(a, b):
        with _f32_full_precision():
            return _matmul(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _f32_full_precision():
            if ctx.needs_input_grad[0]:
                ga = _matmul(g, b.transpose(-1, -2)).sum_to_size(a.shape)
            if ctx.needs_input_grad[1]:
                gb = _matmul(a.transpose(-1, -2), g).sum_to_size(b.shape)
        return ga, gb


def _needs_graph(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a product must pin its own backward pass: outside a pinned
    block, or where autograd will differentiate it after a block that is
    not ``whole``."""
    if not _depth():
        return True
    return (not _PINNED.whole and torch.is_grad_enabled()
            and (a.requires_grad or b.requires_grad))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b; in f32 pinned to full precision, forward and backward."""
    if a.dtype == torch.float32 and _needs_graph(a, b):
        return _F32Matmul.apply(a, b)
    return _matmul(a, b)


class _F32Einsum(torch.autograd.Function):
    """torch.einsum of two operands with the forward and the backward
    products at full f32 precision (as :class:`_F32Matmul`).  The
    subscripts hold no ellipsis and no repeated index within an operand,
    and every index of an operand appears in the other or in the output,
    so each operand's cotangent is one einsum of the output's cotangent
    with the other operand."""

    @staticmethod
    def forward(sub, a, b):
        with _f32_full_precision():
            return torch.einsum(sub, a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sub = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.sub.replace(" ", "").split("->")
        sa, sb = ins.split(",")
        ga = gb = None
        with _f32_full_precision():
            if ctx.needs_input_grad[1]:
                ga = torch.einsum(f"{out},{sb}->{sa}", g, b)
            if ctx.needs_input_grad[2]:
                gb = torch.einsum(f"{sa},{out}->{sb}", a, g)
        return None, ga, gb


def _einsum(sub: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum(sub, a, b); in f32 pinned to full precision, forward
    and backward (subscripts as :class:`_F32Einsum` takes them)."""
    if a.dtype == torch.float32 and _needs_graph(a, b):
        return _F32Einsum.apply(sub, a, b)
    return torch.einsum(sub, a, b)


def ceinsum(sub: str, a: Cplx, b: Cplx) -> Cplx:
    """Complex einsum of two operands from split re/im parts (4 real
    einsums)."""
    rr = _einsum(sub, a.re, b.re)
    ii = _einsum(sub, a.im, b.im)
    ri = _einsum(sub, a.re, b.im)
    ir = _einsum(sub, a.im, b.re)
    return Cplx(rr - ii, ri + ir)


def _weighted_sum(z: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """sum_k z_k stack_k over the leading axis of a (K, i, j) or (K, b, i, j)
    stack (one product of (1, K) and (K, rest), pinned in f32; in f32 with
    (K, b, i, j) elementwise, so that no TF32 product enters)."""
    if stack.dtype != torch.float32 or stack.ndim == 3:
        return _mm(z.reshape(1, -1), stack.reshape(stack.shape[0], -1)).reshape(stack.shape[1:])
    return (z.reshape((-1,) + (1,) * (stack.ndim - 1)) * stack).sum(0)


def assemble_side(parts: torch.Tensor, z: Cplx, transpose: bool = False) -> Cplx:
    """Hermitian side matrix H = sum_p z_p P_p + h.c. (parts real);
    ``transpose=True`` returns H^T (= conj(H))."""
    a_re = _weighted_sum(z.re, parts)
    a_im = _weighted_sum(z.im, parts)
    h_re = a_re + a_re.T
    h_im = a_im - a_im.T
    if transpose:
        return Cplx(h_re, -h_im)
    return Cplx(h_re, h_im)


def _kron_terms_batched(h: FactoredHamiltonian, zk: Cplx, x: torch.Tensor, y: torch.Tensor):
    """Contribution of sum_k z_k (R_k (x) C_k) + h.c. to (H psi) for a
    batched state (nb, da, db), in real and imaginary parts.

    With T1_k(u) = R u C^T + R^T u C (self-adjoint) and
    T2_k(u) = R u C^T - R^T u C (anti-self-adjoint), z = a + ib:
      re += sum_k a_k T1_k(x) - b_k T2_k(y)
      im += sum_k a_k T1_k(y) + b_k T2_k(x)
    """
    KR, KC = h.kron_row, h.kron_col
    if x.dtype == torch.float32:
        kr, kc = KR[:, None], KC[:, None]
        krt, kct = kr.transpose(-1, -2), kc.transpose(-1, -2)
        x1, x2 = _mm(_mm(kr, x[None]), kct), _mm(_mm(krt, x[None]), kc)
        y1, y2 = _mm(_mm(kr, y[None]), kct), _mm(_mm(krt, y[None]), kc)
    else:
        # JAX's three-operand einsums as two bmm each, on views of the part
        # matrices and the state: an einsum saves reshapes that a
        # torch.export trace does not see
        K, da, db = KR.shape[0], KR.shape[1], KC.shape[1]

        def pairs(u: torch.Tensor):
            nb = u.shape[0]
            # u as (da, nb db), one view shared by the K terms
            uk = u.transpose(0, 1).reshape(da, nb * db).expand(K, da, nb * db)

            def product(r, c):  # r_k u c_k for every k, as (K, nb, da, db)
                ru = torch.bmm(r, uk).view(K, da * nb, db)
                return torch.bmm(ru, c).view(K, da, nb, db).transpose(1, 2)

            return product(KR, KC.transpose(1, 2)), product(KR.transpose(1, 2), KC)

        x1, x2 = pairs(x)
        y1, y2 = pairs(y)
    a, b = zk.re, zk.im
    add_re = _weighted_sum(a, x1 + x2) - _weighted_sum(b, y1 - y2)
    add_im = _weighted_sum(a, y1 + y2) + _weighted_sum(b, x1 - x2)
    return add_re, add_im


def h_apply(h: FactoredHamiltonian, zr: Cplx, zc: Cplx, zk: Optional[Cplx],
            psi: Cplx) -> Cplx:
    """H(t) @ psi for one (da, db) state."""
    out = h_apply_batched(h, zr, zc, zk, Cplx(psi.re[None], psi.im[None]))
    return Cplx(out.re[0], out.im[0])


def h_apply_batched(h: FactoredHamiltonian, zr: Cplx, zc: Cplx, zk: Optional[Cplx],
                    psi: Cplx) -> Cplx:
    """H(t) @ psi for a batched state (nb, da, db)."""
    return h_applier(h, zr, zc, zk)(psi)


def h_applier(h: FactoredHamiltonian, zr: Cplx, zc: Cplx, zk: Optional[Cplx]):
    """psi -> H(t) @ psi (as ``h_apply_batched``) with the side matrices
    assembled once, for repeated products at one time (a Krylov
    subspace)."""
    hr = assemble_side(h.row_parts, zr)
    gc = assemble_side(h.col_parts, zc, transpose=True)

    def apply(psi: Cplx) -> Cplx:
        x, y = psi.re, psi.im
        rx = _mm(hr.re, x) - _mm(hr.im, y)
        ry = _mm(hr.re, y) + _mm(hr.im, x)
        cx = _mm(x, gc.re) - _mm(y, gc.im)
        cy = _mm(x, gc.im) + _mm(y, gc.re)
        out_re = rx + cx + h.int_diag * x
        out_im = ry + cy + h.int_diag * y
        if h.kron_row is not None and zk is not None:
            add_re, add_im = _kron_terms_batched(h, zk, x, y)
            out_re = out_re + add_re
            out_im = out_im + add_im
        return Cplx(out_re, out_im)

    return apply


def h_matrix(h: FactoredHamiltonian, t: torch.Tensor) -> Cplx:
    """The dense (dim, dim) H(t), for introspection and tests."""
    zr, zc, zk = interp_streams(h, t)
    hr = assemble_side(h.row_parts, zr)
    hc = assemble_side(h.col_parts, zc)
    eye_a = torch.eye(h.da, dtype=h.int_diag.dtype, device=h.int_diag.device)
    eye_b = torch.eye(h.db, dtype=h.int_diag.dtype, device=h.int_diag.device)
    full_re = torch.kron(hr.re, eye_b) + torch.kron(eye_a, hc.re)
    full_im = torch.kron(hr.im, eye_b) + torch.kron(eye_a, hc.im)
    full_re = full_re + torch.diag(h.int_diag.reshape(-1))
    if h.kron_row is not None and zk is not None:
        # M = sum_k z_k R_k (x) C_k;  H += M + M^H
        kr_full = torch.stack([torch.kron(h.kron_row[k], h.kron_col[k])
                               for k in range(h.kron_row.shape[0])])
        m_re = _weighted_sum(zk.re, kr_full)
        m_im = _weighted_sum(zk.im, kr_full)
        full_re = full_re + m_re + m_re.T
        full_im = full_im + m_im - m_im.T
    return Cplx(full_re, full_im)


# ----------------------------------------------------------------------
# density-matrix application (the factored mesolve form)
# ----------------------------------------------------------------------
def h_apply_rho_left(h: FactoredHamiltonian, zr: Cplx, zc: Cplx, zk: Optional[Cplx],
                     rho: Cplx) -> Cplx:
    """H(t) @ rho for rho of shape (dim, dim): the factored H applied on
    rho's row index by batched small products."""
    da, db, dim = h.da, h.db, h.dim
    hr = assemble_side(h.row_parts, zr)
    hc = assemble_side(h.col_parts, zc)
    r4 = rho.reshape(da, db, dim)
    # Hrow acts on axis 0, Hcol on axis 1
    out_re = _einsum("ij,jbc->ibc", hr.re, r4.re) - _einsum("ij,jbc->ibc", hr.im, r4.im)
    out_im = _einsum("ij,jbc->ibc", hr.re, r4.im) + _einsum("ij,jbc->ibc", hr.im, r4.re)
    out_re = out_re + _einsum("ij,ajc->aic", hc.re, r4.re) - _einsum("ij,ajc->aic", hc.im, r4.im)
    out_im = out_im + _einsum("ij,ajc->aic", hc.re, r4.im) + _einsum("ij,ajc->aic", hc.im, r4.re)
    # the interaction diagonal on the row index
    d = h.int_diag.reshape(da, db, 1)
    out_re = out_re + d * r4.re
    out_im = out_im + d * r4.im
    if h.kron_row is not None and zk is not None:
        # the kron pairs on the row index, rho's columns as the state batch
        add_re, add_im = _kron_terms_batched(h, zk, r4.re.permute(2, 0, 1),
                                             r4.im.permute(2, 0, 1))
        out_re = out_re + add_re.permute(1, 2, 0)
        out_im = out_im + add_im.permute(1, 2, 0)
    return Cplx(out_re.reshape(dim, dim), out_im.reshape(dim, dim))


def apply_local_left(op: Cplx, site: int, n: int, d: int, x: Cplx) -> Cplx:
    """lift(op, site) @ x for x of shape (d^n, M) or (d^n,): the (d, d)
    operator contracted against the ``site`` factor of the row index, no
    lifted matrix built."""
    shape = x.shape
    x4 = x.reshape(d**site, d, -1)
    out_re = _einsum("ij,ajb->aib", op.re, x4.re) - _einsum("ij,ajb->aib", op.im, x4.im)
    out_im = _einsum("ij,ajb->aib", op.re, x4.im) + _einsum("ij,ajb->aib", op.im, x4.re)
    return Cplx(out_re, out_im).reshape(shape)


def apply_local_right(op: Cplx, site: int, n: int, d: int, rho: Cplx) -> Cplx:
    """rho @ lift(op, site) for rho of shape (M, d^n) (the column index
    is the Hilbert index)."""
    shape = rho.shape
    x4 = rho.reshape(-1, d, d**n // (d**site * d))
    # (rho A)[.., j, ..] = sum_i rho[.., i, ..] A[i, j]
    out_re = _einsum("aib,ij->ajb", x4.re, op.re) - _einsum("aib,ij->ajb", x4.im, op.im)
    out_im = _einsum("aib,ij->ajb", x4.re, op.im) + _einsum("aib,ij->ajb", x4.im, op.re)
    return Cplx(out_re, out_im).reshape(shape)

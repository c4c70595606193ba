"""Fused compensated-f32 ERK evolution and its discrete adjoint
(counterpart of pulser_diff_tpu/ops/pallas_evolution.py).

The whole Schrodinger evolution runs in ONE launch of a hand-written
CUDA kernel (K1, ``csrc/fused_evolution.cu``: ``fused_fwd_kernel``) and
its gradient in ONE launch of the adjoint kernel (K2:
``fused_bwd_kernel``), each one thread-block cluster of C blocks per run
(``cluster_plan`` picks C and the shared memory; each block keeps its
rows of the state in shared memory and reads its peers' through
distributed shared memory).  They compute what the Pallas kernels
``_fwd_kernel`` and ``_bwd_kernel`` (lean interval form) compute:

  - the state is split-complex f32 ``(R, nb, da, db)``; every stage
    assembles the row/column side matrices from the real part stacks and
    two-word (hi, lo) stream values, applies -iH as true-f32 products plus
    the two-word interaction diagonal, and the step increment uses
    two-word h*b_s weights with Kahan-compensated accumulation;
  - the adjoint rebuilds each step's start state by reverse-time ERK on
    the mirror-node (1 - c) streams, recomputes the forward stage inputs,
    runs the exact transpose of the stage recursion and accumulates the
    stream cotangents, the diagonal cotangent and the costate; at every
    grid point that carries an evaluation slot it reloads the stored
    state and adds that slot's cotangent.

With kron pairs (the XY flip-flop terms, K3) every stage adds
sum_k za_k T1_k - zb_k T2_k (and the imaginary counterpart) after the
side and diagonal terms, and the adjoint also emits the kron streams'
cotangents (two more zbar columns per term) and the part matrices'
cotangents ``krbar`` / ``kcbar`` (R, K, da, da) / (R, K, db, db), through
which a coordinate gradient reaches the interaction weights.  The data
dict then carries ``kr``, ``kc`` and the kron streams; without them every
kernel takes the ising path unchanged.

The checkpointed pair runs the same stage arithmetic where the state
no longer fits a cluster (the JAX package takes it from dim 2^16; the
port also wherever K1/K2's cluster plan refuses the shape): K4
(``csrc/fused_ckpt.cu``: ``fused_fwd_ckpt_kernel``, for
``_fwd_ckpt_kernel``) stores the state after every step, and K5
(``fused_bwd_ckpt_kernel``, for ``_bwd_ckpt_kernel``) runs the adjoint
from those exact start states, with no mirror pass, taking a cotangent
at every step.  Each is one cooperative launch of one block per SM, with
one grid barrier per application of -iH (``ckpt_plan`` mirrors the
kernel's plan).

Beside each kernel sits its plain PyTorch version (``fused_fwd_plain``,
``fused_bwd_plain``, ``fused_fwd_ckpt_plain``, ``fused_bwd_ckpt_plain``),
which repeats the kernel's arithmetic in the same order.  K2's plain
version also runs the JAX package's wide adjoint interval
(``form="wide"``), an oracle that no kernel runs.  Each kernel is a
``torch.library`` custom op (``pulser_diff_torch::fused_fwd``,
``::fused_bwd``, ``::fused_fwd_ckpt``, ``::fused_bwd_ckpt``) whose "cpu"
implementation is the plain version and whose "cuda" one launches the
kernel, with a fake implementation (shapes only) so that ``torch.export``
keeps the op in a traced step; K1's and K4's autograd rules, registered
on their ops, call K2 and K5.  The wrappers ``fused_fwd`` / ``fused_bwd`` /
``fused_fwd_ckpt`` / ``fused_bwd_ckpt`` check the inputs and call the
ops; on any device but the CPU and CUDA they raise.  ``LAUNCHES`` counts
kernel launches (the plain versions never count).

Every kernel takes up to 32 row and 32 column parts (a per-qubit noisy
build has 2 ceil(n / 2) a side); ``parts_fit`` / ``check_parts`` decide on
the host, before any launch.

Host side (``_precompute_stage_z``, ``_split_hi_lo``, ``_stage_all``,
``prepare_fused_inputs``, ``_unpack_zbar``, ``_zero_like_aux``) follows
the JAX package key by key.  Every kernel takes R runs (one cluster per
run for K1/K2, R times the jobs for K4/K5): ``prepare_mc_inputs`` and
``evolve_mc`` stage R Hamiltonians on that axis (population evaluation),
``evolve_states`` is one run of it.  ``fused_evolve`` / ``pallas_evolve``
return the final state only (K1/K2 with a slot on the last grid point
alone, or K4/K5's last step).  ``zbar`` is written directly as
``(R, n_steps, S, 2pr + 2pc + 2K)``: the ``(1, 128)`` row packing of the
Pallas kernel was a TPU layout workaround.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.ops import kernel_build
from pulser_diff_torch.ops.apply import FactoredHamiltonian, interp_streams
from pulser_diff_torch.solvers.solver import (
    _DP5_A, _DP5_B, _DP5_C, _RK4_A, _RK4_B, _RK4_C,
)

_TABLEAUS = {
    "RK4": (_RK4_C, _RK4_A, _RK4_B),
    "DP5": (_DP5_C, _DP5_A, _DP5_B),
}

# state-batch cap, as in the JAX package
_NB_MAX = 32

# data-dict keys for the staged streams, in kernel order
_ZF_KEYS = (
    "zrh_re", "zrh_im", "zrl_re", "zrl_im",
    "zch_re", "zch_im", "zcl_re", "zcl_im",
)
_ZB_KEYS = ("zbr_re", "zbr_im", "zbc_re", "zbc_im")
# the kron pairs' forward-node (hi/lo) and mirror-node streams
_ZKF_KEYS = ("zkh_re", "zkh_im", "zkl_re", "zkl_im")
_ZKB_KEYS = ("zkb_re", "zkb_im")

# the ops' data keys, in order; the first eight plus diag / diag_lo / psi
# carry gradients, the rest are structural constants
_FN_KEYS = _ZF_KEYS + (
    "diag", "diag_lo", "psi_re", "psi_im",
    "rp", "cp", "hb_hi", "hb_lo", "hs",
) + _ZB_KEYS
# with kron pairs: the part matrices and the forward streams carry
# gradients, the mirror streams are structural
_KRON_FN_KEYS = ("kr", "kc") + _ZKF_KEYS + _ZKB_KEYS

# kron pairs the kernels take (12 atoms XY: 8; an SLM-masked 16-atom XY
# sequence: 20)
_K_MAX = 32

# row / column parts a side that every kernel takes (a per-qubit
# (all-local) build has 2 ceil(n / 2): 18 at 18 atoms); the adjoint kernels
# reduce their stream cotangents in chunks of 8 parts
_P_MAX = 32

# kernel launches since the last reset (plain versions never count)
LAUNCHES = {"fused_fwd": 0, "fused_bwd": 0, "fused_fwd_ckpt": 0, "fused_bwd_ckpt": 0}

# shared memory one block can use on Hopper (bytes)
_SMEM_LIMIT = 232448
# K1/K2's launch (csrc/fused_evolution.cu): threads a block, and the
# largest cluster (above 8 blocks only as a non-portable size)
_NTHREADS = 256
_NWARPS = _NTHREADS // 32
_C_MAX = 16


# K4/K5's launch (csrc/fused_ckpt.cu): a block's two 128-thread groups each
# stage up to 4 A and 4 B operands through a ring of 3 k-chunks of 16
# (rows padded to 36 and 20 floats), beside 8 exchange tiles of 32 x 16
# and the reduction rows (8 warps x 16)
_CKPT_SMEM = 4 * (2 * 3 * 4 * 16 * (36 + 20) + 8 * 32 * 16 + _NWARPS * 16)

# the grid-barrier words of the last K4 / K5 launch (count, barriers
# completed), by kernel: read after the launch, they give the kernel's own
# barrier count
CKPT_BARRIERS: dict = {}


# ----------------------------------------------------------------------
# host-side staging (follows the JAX package)
# ----------------------------------------------------------------------
def _precompute_stage_z(ham: FactoredHamiltonian, grid_times: torch.Tensor,
                        c_nodes: np.ndarray = _RK4_C):
    """Interpolate all coefficient streams at every (step, stage) time.
    Returns (zr, zc, zk, hs) with z shapes (n_steps, S, P); zk is None
    without kron pairs."""
    t0s = grid_times[:-1]
    t1s = grid_times[1:]
    hs = t1s - t0s
    c = torch.as_tensor(np.asarray(c_nodes), dtype=hs.dtype, device=hs.device)
    ts = t0s[:, None] + hs[:, None] * c[None, :]
    zr, zc, zk = interp_streams(ham, ts)
    return zr, zc, zk, hs


def _split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-word f32 split: hi = f32(x), lo = f32(x - hi), the difference
    taken in f64 whatever the default dtype.  Under an f32 default the
    data is f32 already, so hi = x and lo = 0, which the kernels take as
    they take any low word."""
    x = x.to(torch.float64)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def _stage_all(ham: FactoredHamiltonian, grid_times: torch.Tensor, method: str) -> dict:
    """Forward-node (hi/lo split) + mirror-node staged streams."""
    C, _, B = _TABLEAUS[method]
    zr, zc, zk, hs = _precompute_stage_z(ham, grid_times, C)
    zbr, zbc, zbk, _ = _precompute_stage_z(ham, grid_times, 1.0 - C)
    hb = hs[:, None] * torch.as_tensor(B, dtype=hs.dtype, device=hs.device)[None, :]
    f32 = torch.float32
    out = {}
    for key_hi, key_lo, arr in (
        ("zrh_re", "zrl_re", zr.re), ("zrh_im", "zrl_im", zr.im),
        ("zch_re", "zcl_re", zc.re), ("zch_im", "zcl_im", zc.im),
    ):
        out[key_hi], out[key_lo] = _split_hi_lo(arr)
    out["zbr_re"] = zbr.re.to(f32)
    out["zbr_im"] = zbr.im.to(f32)
    out["zbc_re"] = zbc.re.to(f32)
    out["zbc_im"] = zbc.im.to(f32)
    if zk is not None:
        out["zkh_re"], out["zkl_re"] = _split_hi_lo(zk.re)
        out["zkh_im"], out["zkl_im"] = _split_hi_lo(zk.im)
        out["zkb_re"] = zbk.re.to(f32)
        out["zkb_im"] = zbk.im.to(f32)
    out["hb_hi"], out["hb_lo"] = _split_hi_lo(hb)
    out["hs"] = hs.to(f32)
    return out


def prepare_fused_inputs(
    ham: FactoredHamiltonian,
    psi0: Cplx,
    grid_times: torch.Tensor,
    method: str = "DP5",
) -> dict:
    """Stage-precompute + two-word f32 casts, with a leading R=1 run axis
    (the same keys, shapes and values as the JAX package's)."""
    return prepare_mc_inputs([ham], psi0, grid_times, method)


def prepare_mc_inputs(
    hams,
    psi0: Cplx,
    grid_times: torch.Tensor,
    method: str = "DP5",
) -> dict:
    """The inputs of R runs, one per Hamiltonian of ``hams`` (the port's
    counterpart of ``stage_one`` under ``jax.vmap`` in
    ``pallas_evolve_mc``): per-run streams, stage values, interaction
    diagonal (hi/lo) and kron part matrices, stacked on a leading run axis
    with ``torch.stack`` (so autograd hands each run its own cotangent);
    the part stacks, step sizes and weights shared, taken from run 0 as the
    JAX package takes them.  ``psi0`` is (nb, da, db), shared by every run,
    or (R, nb, da, db), one per run."""
    if int(psi0.re.shape[-3]) > _NB_MAX:
        raise ValueError(
            f"Fused kernels support state batches up to nb={_NB_MAX}; use "
            "the f64 stepper (fused=False) for larger batches."
        )
    f32 = torch.float32
    R = len(hams)
    staged = [_stage_all(h, grid_times, method) for h in hams]
    data = {k: v if k in ("hb_hi", "hb_lo", "hs") else torch.stack([st[k] for st in staged])
            for k, v in staged[0].items()}
    diag, diag_lo = _split_hi_lo(torch.stack([h.int_diag for h in hams]))
    data["rp"] = hams[0].row_parts.to(f32)
    data["cp"] = hams[0].col_parts.to(f32)
    data["diag"] = diag
    data["diag_lo"] = diag_lo
    if psi0.re.ndim == 3:
        data["psi_re"] = psi0.re.to(f32).expand(R, *psi0.re.shape)
        data["psi_im"] = psi0.im.to(f32).expand(R, *psi0.im.shape)
    else:
        data["psi_re"] = psi0.re.to(f32)
        data["psi_im"] = psi0.im.to(f32)
    if hams[0].kron_row is not None:
        # differentiable casts: the coordinate gradient flows through them
        data["kr"] = torch.stack([h.kron_row for h in hams]).to(f32)
        data["kc"] = torch.stack([h.kron_col for h in hams]).to(f32)
    # the kernels index dense row-major buffers
    return {k: v.contiguous() for k, v in data.items()}


def _dims(data: dict) -> tuple[int, ...]:
    R, nb, da, db = (int(v) for v in data["psi_re"].shape)
    n_steps = int(data["hs"].shape[0])
    pr = int(data["rp"].shape[0])
    pc = int(data["cp"].shape[0])
    return R, n_steps, pr, pc, nb, da, db


def _n_kron(data: dict) -> int:
    """K, the number of kron pairs (0 without them)."""
    return int(data["kr"].shape[1]) if "kr" in data else 0


def _fn_keys(data: dict) -> tuple[str, ...]:
    """The ops' data keys for ``data``."""
    return _FN_KEYS + (_KRON_FN_KEYS if "kr" in data else ())


def parts_fit(pr: int, pc: int) -> bool:
    """Whether the fused kernels take ``pr`` row and ``pc`` column parts."""
    return pr <= _P_MAX and pc <= _P_MAX


def check_parts(pr: int, pc: int) -> None:
    """Raise ValueError, before any launch, where :func:`parts_fit` refuses
    the parts."""
    if not parts_fit(pr, pc):
        raise ValueError(
            f"The fused kernels K1/K2/K4/K5 take at most {_P_MAX} row and {_P_MAX} column "
            f"parts (pr={pr}, pc={pc}); pass fused=False for the f64 stepper.")


def _check_shapes(data: dict, S: int, *states, slots: torch.Tensor | None = None,
                  n_eval: int = 0) -> None:
    """Raise on inputs whose shapes disagree with ``psi_re``, ``hs``,
    ``rp`` and ``cp`` (the kernels index them as dense buffers of these
    shapes).  ``states`` are slot states or slot cotangents
    (R, n_eval, ...) when ``slots`` is given, else per-step states or
    cotangents (R, n_steps, ...)."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    want = {
        "psi_re": (R, nb, da, db), "psi_im": (R, nb, da, db),
        "rp": (pr, da, da), "cp": (pc, db, db),
        "hb_hi": (n_steps, S), "hb_lo": (n_steps, S), "hs": (n_steps,),
        "diag": (R, da, db), "diag_lo": (R, da, db),
    }
    for k in _ZF_KEYS + _ZB_KEYS:
        want[k] = (R, n_steps, S, pr if k.startswith(("zr", "zbr")) else pc)
    K = _n_kron(data)
    if K:
        if K > _K_MAX:
            raise ValueError(f"The fused kernels take up to {_K_MAX} kron pairs, got {K}.")
        want["kr"], want["kc"] = (R, K, da, da), (R, K, db, db)
        for k in _ZKF_KEYS + _ZKB_KEYS:
            want[k] = (R, n_steps, S, K)
    got = {k: tuple(data[k].shape) for k in want}
    lead = n_steps
    if slots is not None:
        got["slots"], want["slots"] = tuple(slots.shape), (n_steps + 1,)
        lead = n_eval
    for i, t in enumerate(states):
        got[f"states[{i}]"], want[f"states[{i}]"] = tuple(t.shape), (R, lead, nb, da, db)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"Fused kernel inputs of the wrong shape (got, expected): {bad}")


def _tableau(method: str):
    if method not in _TABLEAUS:
        raise ValueError(f"No fused tableau '{method}'; expected one of {sorted(_TABLEAUS)}.")
    C, A, B = _TABLEAUS[method]
    return tuple(tuple(float(a) for a in row) for row in A), tuple(float(b) for b in B), len(C)


def _unpack_zbar(zbar: torch.Tensor, pr: int, pc: int):
    """(R, n_steps, S, 2pr + 2pc) cotangent rows -> per-stream cotangents
    (zbar_rr, zbar_ri, zbar_cr, zbar_ci), each (R, n_steps, S, P)."""
    return (
        zbar[..., 0 : 2 * pr : 2],
        zbar[..., 1 : 2 * pr : 2],
        zbar[..., 2 * pr : 2 * pr + 2 * pc : 2],
        zbar[..., 2 * pr + 1 : 2 * pr + 2 * pc : 2],
    )


def _unpack_zbar_kron(zbar: torch.Tensor, pr: int, pc: int):
    """The kron columns of the cotangent rows: (zbar_kr, zbar_ki), each
    (R, n_steps, S, K)."""
    return zbar[..., 2 * pr + 2 * pc :: 2], zbar[..., 2 * pr + 2 * pc + 1 :: 2]


def _parts_sym(data: dict):
    """(P + P^T, P - P^T) of the row and of the column part stacks."""
    rp, cp = data["rp"], data["cp"]
    return tuple(
        t.contiguous()
        for t in (rp + rp.transpose(-1, -2), rp - rp.transpose(-1, -2),
                  cp + cp.transpose(-1, -2), cp - cp.transpose(-1, -2))
    )


def _zero_like_aux(data: dict, zbar, dbar, lam0_re, lam0_im, kron=None) -> dict:
    """The cotangent dict: streams / diag / psi (and the kron part matrices
    and streams: ``kron`` = (zbar_kr, zbar_ki, krbar, kcbar)) carry
    gradients, everything structural (parts, step sizes, mirror streams)
    is zero.  Hi and lo words are summed in-kernel, so they get identical
    cotangents; so do diag and diag_lo."""
    zbar_rr, zbar_ri, zbar_cr, zbar_ci = zbar
    out = {k: torch.zeros_like(v) for k, v in data.items()}
    if kron is not None:
        zbar_kr, zbar_ki, out["kr"], out["kc"] = kron
        out["zkh_re"], out["zkh_im"] = zbar_kr, zbar_ki
        out["zkl_re"], out["zkl_im"] = zbar_kr, zbar_ki
    out["zrh_re"], out["zrh_im"] = zbar_rr, zbar_ri
    out["zrl_re"], out["zrl_im"] = zbar_rr, zbar_ri
    out["zch_re"], out["zch_im"] = zbar_cr, zbar_ci
    out["zcl_re"], out["zcl_im"] = zbar_cr, zbar_ci
    out["diag"] = dbar
    out["diag_lo"] = dbar
    out["psi_re"], out["psi_im"] = lam0_re, lam0_im
    return out


# ----------------------------------------------------------------------
# plain PyTorch versions of the kernels (same arithmetic, same order)
# ----------------------------------------------------------------------
def _f32(x) -> np.float32:
    return np.float32(x)


class _PlainRun:
    """One run's constants for the plain versions: symmetric and
    antisymmetric part stacks, host copies of the stream scalars, the
    two-word diagonal, and the kron part matrices."""

    def __init__(self, data: dict, r: int, mirror: bool) -> None:
        self.rsym, self.rasym, self.csym, self.casym = _parts_sym(data)
        self.zf = [data[k][r].detach().cpu().numpy() for k in _ZF_KEYS]
        self.zb = [data[k][r].detach().cpu().numpy() for k in _ZB_KEYS] if mirror else None
        self.d = data["diag"][r]
        self.dlo = data["diag_lo"][r]
        self.K = _n_kron(data)
        if self.K:
            self.kr, self.kc = data["kr"][r], data["kc"][r]
            self.zkf = [data[k][r].detach().cpu().numpy() for k in _ZKF_KEYS]
            self.zkb = [data[k][r].detach().cpu().numpy() for k in _ZKB_KEYS] if mirror else None

    @staticmethod
    def _assemble(parts: torch.Tensor, z: np.ndarray) -> torch.Tensor:
        acc = parts[0] * float(z[0])
        for p in range(1, parts.shape[0]):
            acc = acc + parts[p] * float(z[p])
        return acc

    def side(self, k: int, s: int, mirror: bool = False):
        """(Hrow re, Hrow im, Hcol^T re, Hcol^T im, kron) at step k, stage
        s; kron is None or the lists (za, zb) of the kron streams (hi + lo
        in f32; the mirror's hi word)."""
        a = self._assemble
        if mirror:
            z = self.zb
            hre = a(self.rsym, z[0][k, s])
            him = a(self.rasym, z[1][k, s])
            gre = a(self.csym, z[2][k, s])
            gim = -a(self.casym, z[3][k, s])
        else:
            z = self.zf
            hre = a(self.rsym, z[0][k, s]) + a(self.rsym, z[2][k, s])
            him = a(self.rasym, z[1][k, s]) + a(self.rasym, z[3][k, s])
            gre = a(self.csym, z[4][k, s]) + a(self.csym, z[6][k, s])
            gim = -(a(self.casym, z[5][k, s]) + a(self.casym, z[7][k, s]))
        kron = None
        if self.K:
            if mirror:
                za = [float(v) for v in self.zkb[0][k, s]]
                zb = [float(v) for v in self.zkb[1][k, s]]
            else:
                zf = self.zkf
                za = [float(_f32(h) + _f32(lo)) for h, lo in zip(zf[0][k, s], zf[2][k, s])]
                zb = [float(_f32(h) + _f32(lo)) for h, lo in zip(zf[1][k, s], zf[3][k, s])]
            kron = (za, zb)
        return hre, him, gre, gim, kron

    def kron_products(self, u: torch.Tensor):
        """Per term (R u C^T, R^T u C) for u (nb, da, db), R first."""
        return [((R @ u) @ C.T, (R.T @ u) @ C) for R, C in zip(self.kr, self.kc)]

    def apply_minus_iH(self, side, x: torch.Tensor, y: torch.Tensor):
        """k = -i H u for u = (x, y) of shape (nb, da, db); the kron terms
        are added term by term after the side and diagonal terms."""
        hre, him, gre, gim, kron = side
        a1, a2, a3, a4 = hre @ x, him @ y, him @ x, hre @ y
        c1, c2, c3, c4 = x @ gre, y @ gim, x @ gim, y @ gre
        h_re = (((a1 - a2) + (c1 - c2)) + self.d * x) + self.dlo * x
        h_im = (((a3 + a4) + (c3 + c4)) + self.d * y) + self.dlo * y
        if kron is not None:
            za, zb = kron
            for j, ((x1, x2), (y1, y2)) in enumerate(
                    zip(self.kron_products(x), self.kron_products(y))):
                h_re = h_re + ((x1 + x2) * za[j] - (y1 - y2) * zb[j])
                h_im = h_im + ((y1 + y2) * za[j] + (x1 - x2) * zb[j])
        return h_im, -h_re

    def kron_cotangents(self, kron, gx, gy, ux, uy, krbar, kcbar) -> list:
        """One stage's kron cotangents for the stage cotangent g = (gx, gy)
        and the stage input u = (ux, uy): the stream rows (za_bar, zb_bar)
        per term (returned), and the part-matrix cotangents added to
        ``krbar`` / ``kcbar`` (K, da, da) / (K, db, db) in place, as K2's
        kron_matrix_cotangents adds them.  zb_bar = <g, d(-iHu)/dzb> takes
        the sign of the derivative, the opposite of the Pallas
        ``_kron_cotangents`` (T2 is anti-self-adjoint)."""
        za, zb = kron
        rows = []
        for (x1, x2), (y1, y2) in zip(self.kron_products(gx), self.kron_products(gy)):
            rows += [((x1 + x2) * uy - (y1 + y2) * ux).sum(),
                     ((x2 - x1) * ux + (y2 - y1) * uy).sum()]
        for j, (R, C) in enumerate(zip(self.kr, self.kc)):
            dR, dC = krbar[j], kcbar[j]
            for b in range(gx.shape[0]):
                B1 = gx[b] * zb[j] - gy[b] * za[j]
                B2 = gx[b] * -zb[j] - gy[b] * za[j]
                D1 = gx[b] * za[j] + gy[b] * zb[j]
                D2 = gx[b] * za[j] - gy[b] * zb[j]
                dR = (dR + (B1 @ C) @ ux[b].T + (ux[b] @ C) @ B2.T
                      + (D1 @ C) @ uy[b].T + (uy[b] @ C) @ D2.T)
                dC = (dC + B1.T @ (R @ ux[b]) + ux[b].T @ (R @ B2)
                      + D1.T @ (R @ uy[b]) + uy[b].T @ (R @ D2))
            krbar[j], kcbar[j] = dR, dC
        return rows


def _combine(x, y, ks, coeffs, sign: float = 1.0):
    """x + sum_j c_j k_j over the nonzero coefficients, in order."""
    for (kx, ky), c in zip(ks, coeffs):
        if c != 0.0:
            if sign > 0:
                x = x + kx * c
                y = y + ky * c
            else:
                x = x - kx * c
                y = y - ky * c
    return x, y


def _stage_coeffs(A, s: int, h: np.float32) -> list[float]:
    return [float(_f32(a) * h) if a != 0.0 else 0.0 for a in A[s]]


def _fwd_plain_steps(data: dict, method: str, r: int):
    """Run r's forward evolution: yields (x, y, cx, cy) after every step,
    the state and its Kahan carries (the state's low word is -c).  The
    shared body of K1's and K4's plain versions, so their states agree bit
    for bit."""
    A, B, S = _tableau(method)
    n_steps = int(data["hs"].shape[0])
    hs = data["hs"].detach().cpu().numpy()
    hb_hi = data["hb_hi"].detach().cpu().numpy()
    hb_lo = data["hb_lo"].detach().cpu().numpy()
    run = _PlainRun(data, r, mirror=False)
    x, y = data["psi_re"][r], data["psi_im"][r]
    cx, cy = torch.zeros_like(x), torch.zeros_like(y)
    for k in range(n_steps):
        h = _f32(hs[k])
        ks = []
        for s in range(S):
            xs, ys = _combine(x, y, ks, _stage_coeffs(A, s, h))
            ks.append(run.apply_minus_iH(run.side(k, s), xs, ys))
        dx = dy = None
        for s in range(S):
            if B[s] == 0.0:
                continue
            w = float(hb_hi[k, s])
            if dx is None:
                dx, dy = ks[s][0] * w, ks[s][1] * w
            else:
                dx, dy = dx + ks[s][0] * w, dy + ks[s][1] * w
        for s in range(S):
            if B[s] == 0.0:
                continue
            w = float(hb_lo[k, s])
            dx, dy = dx + ks[s][0] * w, dy + ks[s][1] * w
        # Kahan-compensated accumulation
        yk = dx - cx
        t = x + yk
        cx = (t - x) - yk
        x = t
        yk = dy - cy
        t = y + yk
        cy = (t - y) - yk
        y = t
        yield x, y, cx, cy


def fused_fwd_plain(data: dict, method: str, slots: torch.Tensor, n_eval: int,
                    lo: bool = False):
    """Plain version of K1: the states at every evaluation slot,
    (R, n_eval, nb, da, db) re/im in f32; with ``lo`` also their low words
    (the negated Kahan carries: the compensated state is hi + lo)."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    sl = [int(v) for v in slots.tolist()]
    like = data["psi_re"]
    outs = [torch.zeros((R, n_eval, nb, da, db), dtype=like.dtype, device=like.device)
            for _ in range(4 if lo else 2)]
    for r in range(R):
        if sl[0] < n_eval:
            outs[0][r, sl[0]], outs[1][r, sl[0]] = data["psi_re"][r], data["psi_im"][r]
        for k, words in enumerate(_fwd_plain_steps(data, method, r)):
            if sl[k + 1] < n_eval:
                for o, w in zip(outs, _words(words)):
                    o[r, sl[k + 1]] = w
    return tuple(outs)


def _words(step) -> tuple:
    """(hi re, hi im, lo re, lo im) of a step of :func:`_fwd_plain_steps`."""
    x, y, cx, cy = step
    return x, y, -cx, -cy


def fused_fwd_ckpt_plain(data: dict, method: str, lo: bool = False):
    """Plain version of K4: the state after every step,
    (R, n_steps, nb, da, db) re/im in f32 (index k holds grid point k + 1);
    with ``lo`` also their low words, as :func:`fused_fwd_plain`."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    like = data["psi_re"]
    outs = [torch.zeros((R, n_steps, nb, da, db), dtype=like.dtype, device=like.device)
            for _ in range(4 if lo else 2)]
    for r in range(R):
        for k, words in enumerate(_fwd_plain_steps(data, method, r)):
            for o, w in zip(outs, _words(words)):
                o[r, k] = w
    return tuple(outs)


def _stage_rows(run: _PlainRun, side, gx, gy, ux, uy, kbar) -> torch.Tensor:
    """One stage's cotangent row (2pr + 2pc + 2K,) for the stage cotangent
    g = (gx, gy) and the stage input u = (ux, uy): the outer products
    summed over the batch, against each part; with kron pairs the kron
    stream rows, and the part-matrix cotangents added to ``kbar``.  Both
    adjoint forms pack their rows with it, as the JAX package's share
    ``_stage_cotangent_rows``."""
    pr, pc = run.rsym.shape[0], run.csym.shape[0]
    W = torch.zeros_like(run.rsym[0])
    V = torch.zeros_like(W)
    Wc = torch.zeros_like(run.csym[0])
    Vc = torch.zeros_like(Wc)
    for b in range(gx.shape[0]):
        W = W + (gx[b] @ uy[b].T - gy[b] @ ux[b].T)
        V = V + (gx[b] @ ux[b].T + gy[b] @ uy[b].T)
        Wc = Wc + (uy[b].T @ gx[b] - ux[b].T @ gy[b])
        Vc = Vc + (ux[b].T @ gx[b] + uy[b].T @ gy[b])
    rows = []
    for p in range(pr):
        rows += [(run.rsym[p] * W).sum(), (run.rasym[p] * V).sum()]
    for p in range(pc):
        rows += [(run.csym[p] * Wc).sum(), ((-run.casym[p]) * Vc).sum()]
    if run.K:
        rows += run.kron_cotangents(side[4], gx, gy, ux, uy, *kbar)
    return torch.stack(rows)


def _stage_cotangent(lx, ly, w, h, bhl, A, B, S, s: int):
    """The cotangent of stage s: h b_s lam' + sum_{r>s} h a_rs w_r."""
    if B[s] != 0.0:
        gx, gy = lx * bhl[s], ly * bhl[s]
    else:
        gx, gy = torch.zeros_like(lx), torch.zeros_like(ly)
    for rr in range(s + 1, S):
        a = A[rr][s]
        if a != 0.0:
            c = float(_f32(a) * h)
            gx = gx + w[rr][0] * c
            gy = gy + w[rr][1] * c
    return gx, gy


def _adjoint_core_plain(run: _PlainRun, k: int, x, y, lx, ly, dacc, h, bhl, A, B, S,
                        zrow: torch.Tensor, kbar=None):
    """Phases 2-3 of one adjoint step from the step's START state (x, y):
    the forward stage recompute and the reversed transpose recursion with
    each stage's cotangent rows (written to ``zrow``, (S, 2pr + 2pc + 2K)),
    then the costate update; with kron pairs the part-matrix cotangents
    accumulate into ``kbar`` = (krbar, kcbar) of the run.  Shared by K2's
    and K5's plain versions, as the JAX package shares ``_adjoint_core``.
    Returns (lx', ly', dacc')."""
    # forward stage inputs (the last stage's product is dead)
    us, fk = [], []
    for s in range(S):
        us.append(_combine(x, y, fk, _stage_coeffs(A, s, h)))
        if s < S - 1:
            fk.append(run.apply_minus_iH(run.side(k, s), *us[s]))
    # reversed transpose recursion with the cotangent work
    w = [None] * S
    for s in reversed(range(S)):
        gx, gy = _stage_cotangent(lx, ly, w, h, bhl, A, B, S, s)
        # F^T = -F for the real form of -iH (H hermitian)
        side = run.side(k, s)
        kx, ky = run.apply_minus_iH(side, gx, gy)
        w[s] = (-kx, -ky)
        ux, uy = us[s]
        dacc = dacc + (gx * uy - gy * ux).sum(0)
        zrow[s] = _stage_rows(run, side, gx, gy, ux, uy, kbar)
    # costate update
    for s in range(S):
        lx, ly = lx + w[s][0], ly + w[s][1]
    return lx, ly, dacc


def _reconstruct_plain(run: _PlainRun, sides_b, x, y, h, bhl, A, B, S):
    """A step's start state from its end state (x, y): the same tableau
    with step -h on the mirror-node sides ``sides_b``."""
    rk = []
    for s in range(S):
        xs, ys = _combine(x, y, rk, _stage_coeffs(A, s, h), sign=-1.0)
        rk.append(run.apply_minus_iH(sides_b[s], xs, ys))
    return _combine(x, y, rk, [bhl[s] if B[s] != 0.0 else 0.0 for s in range(S)], sign=-1.0)


def _bwd_interval_wide_plain(run: _PlainRun, k: int, x1, y1, lx, ly, dacc, h, bhl, A, B, S,
                             zrow: torch.Tensor, kbar=None):
    """One adjoint step in the JAX package's wide form
    (``_bwd_interval_wide``, run there under ``PDT_KERNEL_WIDE_ADJ=1``):
    all 2S stage sides assembled up front, the start state rebuilt on the
    mirror nodes, every stage recomputed, the exact transpose of the stage
    recursion, then the cotangent pass as a phase of its own, stage by
    stage in forward order.  The lean form (:func:`_adjoint_core_plain`,
    K2's) does the same arithmetic but adds ``dacc`` and the kron
    part-matrix cotangents in reversed stage order.  A test oracle: no
    kernel runs this form.  Returns (x0, y0, lx', ly', dacc')."""
    sides = [run.side(k, s) for s in range(S)]
    sides_b = [run.side(k, s, mirror=True) for s in range(S)]
    x0, y0 = _reconstruct_plain(run, sides_b, x1, y1, h, bhl, A, B, S)
    # forward stage inputs, every stage's product
    us, fk = [], []
    for s in range(S):
        us.append(_combine(x0, y0, fk, _stage_coeffs(A, s, h)))
        fk.append(run.apply_minus_iH(sides[s], *us[s]))
    # exact transpose of the stage recursion
    kb, w = [None] * S, [None] * S
    for s in reversed(range(S)):
        kb[s] = _stage_cotangent(lx, ly, w, h, bhl, A, B, S, s)
        kx, ky = run.apply_minus_iH(sides[s], *kb[s])
        w[s] = (-kx, -ky)
    for s in range(S):
        lx, ly = lx + w[s][0], ly + w[s][1]
    # the cotangent pass, in stage order
    for s in range(S):
        (gx, gy), (ux, uy) = kb[s], us[s]
        zrow[s] = _stage_rows(run, sides[s], gx, gy, ux, uy, kbar)
        dacc = dacc + (gx * uy - gy * ux).sum(0)
    return x0, y0, lx, ly, dacc


def _bwd_outputs(data: dict, S: int):
    """(lam0_re, lam0_im, zbar, dbar), then (krbar, kcbar) with kron pairs
    (zeroed: they accumulate).  Shapes only (the ops' fake implementations
    use it too)."""
    like = data["psi_re"]
    K = data["kr"].shape[1] if "kr" in data else 0
    zbar = like.new_empty((like.shape[0], data["hs"].shape[0], S,
                           2 * data["rp"].shape[0] + 2 * data["cp"].shape[0] + 2 * K))
    outs = (torch.empty_like(like), torch.empty_like(like), zbar, torch.empty_like(data["diag"]))
    if "kr" in data:
        outs += (torch.zeros_like(data["kr"]), torch.zeros_like(data["kc"]))
    return outs


def _step_weights(data: dict, S: int):
    """Host copies of the step sizes and the summed two-word h*b_s weights."""
    hs = data["hs"].detach().cpu().numpy()
    hb_hi = data["hb_hi"].detach().cpu().numpy()
    hb_lo = data["hb_lo"].detach().cpu().numpy()
    bhl = [[float(_f32(hb_hi[k, s]) + _f32(hb_lo[k, s])) for s in range(S)]
           for k in range(hs.shape[0])]
    return hs, bhl


def fused_bwd_plain(data: dict, method: str, slots: torch.Tensor, n_eval: int,
                    last_slot: int, st_re, st_im, lam_re, lam_im, form: str = "lean"):
    """Plain version of K2.  Returns (lam0_re, lam0_im, zbar, dbar) with
    zbar (R, n_steps, S, 2pr + 2pc + 2K) and dbar (R, da, db), then
    (krbar, kcbar) with kron pairs.  ``form="wide"`` runs each step as the
    JAX package's wide adjoint interval (:func:`_bwd_interval_wide_plain`),
    the oracle K2's lean form is held against."""
    if form not in ("lean", "wide"):
        raise ValueError(f"form must be 'lean' or 'wide', not {form!r}")
    A, B, S = _tableau(method)
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    sl = [int(v) for v in slots.tolist()]
    hs, bhl_all = _step_weights(data, S)
    outs = _bwd_outputs(data, S)
    lam0_re, lam0_im, zbar, dbar = outs[:4]
    for r in range(R):
        kbar = tuple(o[r] for o in outs[4:])
        run = _PlainRun(data, r, mirror=True)
        x, y = st_re[r, last_slot], st_im[r, last_slot]
        lx, ly = lam_re[r, last_slot], lam_im[r, last_slot]
        dacc = torch.zeros_like(run.d)
        for k in reversed(range(n_steps)):
            h = _f32(hs[k])
            bhl = bhl_all[k]
            if form == "wide":
                x, y, lx, ly, dacc = _bwd_interval_wide_plain(
                    run, k, x, y, lx, ly, dacc, h, bhl, A, B, S, zbar[r, k], kbar)
            else:
                # 1. reconstruct the step's start state on the mirror streams
                sides_b = [run.side(k, s, mirror=True) for s in range(S)]
                x, y = _reconstruct_plain(run, sides_b, x, y, h, bhl, A, B, S)
                # 2-3. stage recompute, transpose recursion, costate update
                lx, ly, dacc = _adjoint_core_plain(run, k, x, y, lx, ly, dacc, h, bhl, A, B,
                                                   S, zbar[r, k], kbar)
            # 4. the stored state / slot cotangent
            if sl[k] < n_eval:
                x, y = st_re[r, sl[k]], st_im[r, sl[k]]
                lx, ly = lx + lam_re[r, sl[k]], ly + lam_im[r, sl[k]]
        lam0_re[r], lam0_im[r], dbar[r] = lx, ly, dacc
    return outs


def fused_bwd_ckpt_plain(data: dict, method: str, st_re, st_im, lam_re, lam_im):
    """Plain version of K5: the adjoint of :func:`fused_fwd_ckpt_plain`
    for per-step cotangents ``lam`` (R, n_steps, nb, da, db), from the
    stored start states (no mirror pass).  Returns (lam0_re, lam0_im,
    zbar, dbar[, krbar, kcbar]) as K2's plain version does."""
    A, B, S = _tableau(method)
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    hs, bhl_all = _step_weights(data, S)
    outs = _bwd_outputs(data, S)
    lam0_re, lam0_im, zbar, dbar = outs[:4]
    for r in range(R):
        kbar = tuple(o[r] for o in outs[4:])
        run = _PlainRun(data, r, mirror=False)
        lx = torch.zeros_like(data["psi_re"][r])
        ly = torch.zeros_like(lx)
        dacc = torch.zeros_like(run.d)
        for k in reversed(range(n_steps)):
            # the cotangent of the state at grid point k + 1 (= stored[k])
            lx, ly = lx + lam_re[r, k], ly + lam_im[r, k]
            # the step's start state: stored[k - 1], or psi0 at k = 0
            if k == 0:
                x, y = data["psi_re"][r], data["psi_im"][r]
            else:
                x, y = st_re[r, k - 1], st_im[r, k - 1]
            lx, ly, dacc = _adjoint_core_plain(run, k, x, y, lx, ly, dacc, _f32(hs[k]),
                                               bhl_all[k], A, B, S, zbar[r, k], kbar)
        lam0_re[r], lam0_im[r], dbar[r] = lx, ly, dacc
    return outs


# ----------------------------------------------------------------------
# CUDA kernels (csrc/fused_evolution.cu), plain C interface via ctypes
# ----------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = kernel_build.load("fused_evolution")
    if not getattr(lib, "_pdt_declared", False):
        lib.pdt_fused_smem_bytes.argtypes = [_I] * 9
        lib.pdt_fused_smem_bytes.restype = ctypes.c_size_t
        lib.pdt_fused_scratch_floats.argtypes = [_I] * 5
        lib.pdt_fused_scratch_floats.restype = ctypes.c_size_t
        lib.pdt_fused_resident_clusters.argtypes = [_I] * 9
        lib.pdt_fused_resident_clusters.restype = _I
        lib.pdt_fused_fwd.argtypes = (
            [_P] * 6 + [_P] + [_P] * 6 + [_P] * 4 + [_P, _I] + [_I] * 9 + [_P, _P, _I, _P]
        )
        lib.pdt_fused_fwd.restype = _I
        lib.pdt_fused_bwd.argtypes = (
            [_P] * 8 + [_P, _P] + [_P] * 6 + [_P] * 5 + [_P, _P, _P, _I] + [_I] * 10
            + [_P, _P, _I, _P]
        )
        lib.pdt_fused_bwd.restype = _I
        lib._pdt_declared = True
    return lib


def _check_cuda(tensors: dict, device: torch.device) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"'{name}' is on {t.device}, expected {device}.")
        if t.dtype != (torch.int32 if name == "slots" else torch.float32):
            raise TypeError(f"'{name}' has dtype {t.dtype}.")
        if not t.is_contiguous():
            raise ValueError(f"'{name}' is not contiguous.")


def _tableau_c(method: str):
    A, B, S = _tableau(method)
    a = np.zeros((S, S))
    for i, row in enumerate(A):
        a[i, : len(row)] = row
    a_arr = (ctypes.c_double * (S * S))(*a.reshape(-1).tolist())
    bnz = (ctypes.c_int * S)(*[int(b != 0.0) for b in B])
    return a_arr, bnz, S


def _launch_check(err: int, what: str, pr: int, pc: int) -> None:
    if err == -1:
        raise ValueError(f"{what}: unsupported tableau.")
    if err == -2:
        raise ValueError(
            f"{what} refused pr={pr}, pc={pc} parts: the fused kernels take at most "
            f"{_P_MAX} a side.")
    if err == -3:
        raise RuntimeError(f"{what}: the device does not support cooperative launches.")
    if err == -4:
        raise ValueError(f"{what}: at most {_K_MAX} kron pairs are supported.")
    if err == -5:
        raise RuntimeError(f"{what}: the device cannot schedule the planned thread-block cluster.")
    if err == -6:
        raise ValueError(f"{what}: the kernel refused the cluster plan.")
    if err == -7:
        raise RuntimeError(f"{what}: a block of the planned size does not fit an SM.")
    if err == -8:
        raise ValueError(f"{what}: a run's scratch exceeds 2^32 floats; split the state batch.")
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}.")


def _smem_floats(bwd: bool, nb: int, da: int, db: int, pr: int, pc: int, K: int, S: int,
                 C: int) -> int:
    """Shared memory (floats) of one K1/K2 block, as ``smem_floats`` in
    csrc/fused_evolution.cu computes it: Hcol (db, db) x 2, the block's
    Hrow rows (da / C, da) x 2, the gathered stage vector (nb, da, db + 1)
    x 2, two published slabs, the state and stage slabs (each
    (nb, da / C, db)); with kron pairs the 2K stream values, R_k's rows and
    columns, C_k (db, db + 1) and the products of the block's rows (K2 also
    the gathered stage input); K2's reduction rows; the stage's stream
    words, 4 (pr + pc)."""
    rpb = da // C
    slab, full = nb * rpb * db, nb * da * (db + 1)
    f = 2 * db * db + 2 * rpb * da + 2 * full + 4 * slab + ((4 + 4 * S) if bwd else (4 + 2 * S)) * slab
    if K:
        f += 2 * K + 2 * rpb * da + db * (db + 1) + 8 * rpb * db
        if bwd:
            f += 2 * full
    if bwd:
        f += (_NWARPS + 2) * (2 * pr + 2 * pc + 2 * K)
    return f + 4 * (pr + pc)


def _cluster_size(da: int) -> int:
    """The largest power of two, at most 16, that divides da: the most
    blocks a run can take, each owning da / C rows (16 for 2^a and 4^a
    from da = 16, 1 for 3^a).  On the card 16 blocks (a non-portable size)
    were as fast as 8 at 12 atoms and faster with kron pairs (PERF.md),
    and they need the least shared memory a block."""
    return math.gcd(da, _C_MAX)


def _plan_ok(bwd: bool, nb: int, da: int, db: int, pr: int, pc: int, K: int, S: int,
             C: int) -> bool:
    """The launch's own rule (``plan_ok`` in csrc/fused_evolution.cu): C a
    power of two that divides da, at most 16, and a block's shared memory
    within the limit."""
    if C < 1 or C > _C_MAX or C & (C - 1) or da % C:
        return False
    return 4 * _smem_floats(bwd, nb, da, db, pr, pc, K, S, C) <= _SMEM_LIMIT


def cluster_fits(bwd: bool, nb: int, da: int, db: int, pr: int, pc: int, K: int,
                 S: int) -> bool:
    """Whether K1 (``bwd=False``) or K2 takes this shape: the launch
    accepts its cluster plan (:func:`cluster_plan` raises otherwise), so
    routing decides before any launch."""
    return _plan_ok(bwd, nb, da, db, pr, pc, K, S, _cluster_size(da))


def cluster_plan(bwd: bool, nb: int, da: int, db: int, pr: int, pc: int, K: int,
                 S: int) -> tuple[int, int]:
    """(C, shared-memory bytes a block): the thread-block cluster that K1
    (``bwd=False``) or K2 launches for one run of this shape.  Raises
    ValueError, naming ``ckpt=True``, where a block's shared memory does
    not hold the plan."""
    C = _cluster_size(da)
    need = 4 * _smem_floats(bwd, nb, da, db, pr, pc, K, S, C)
    if cluster_fits(bwd, nb, da, db, pr, pc, K, S):
        return C, need
    fits = [n for n in range(1, nb) if 4 * _smem_floats(bwd, n, da, db, pr, pc, K, S, C) <= _SMEM_LIMIT]
    most = f"state batches up to nb={fits[-1]}" if fits else "no state batch"
    raise ValueError(
        f"The fused {'adjoint' if bwd else 'forward'} kernel needs {need} bytes of shared "
        f"memory per block for nb={nb}, da={da}, db={db}, K={K} with a cluster of {C} blocks "
        f"(limit {_SMEM_LIMIT}); at this da, db it takes {most}. Pass ckpt=True to run the "
        "state on the checkpointed kernels K4/K5, which keep it in device memory; or split "
        "the batch, or pass fused=False for the f64 stepper."
    )


def fused_plan(data: dict, method: str, bwd: bool) -> dict:
    """K1's (``bwd=False``) or K2's launch for ``data``: the cluster size C,
    the blocks of one run (C), the runs (R) and the shared memory a block."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    C, smem = cluster_plan(bwd, nb, da, db, pr, pc, _n_kron(data), _tableau(method)[2])
    return {"C": C, "blocks_per_run": C, "runs": R, "smem_bytes": smem}


def resident_clusters(data: dict, method: str, bwd: bool) -> int:
    """How many of K1's (``bwd=False``) or K2's clusters for ``data`` the
    card holds at once (``cudaOccupancyMaxActiveClusters``); runs past it
    go in waves."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    K, S = _n_kron(data), _tableau(method)[2]
    C, _ = cluster_plan(bwd, nb, da, db, pr, pc, K, S)
    n = int(_library().pdt_fused_resident_clusters(int(bwd), nb, da, db, pr, pc, K, S, C))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {n}")
    return n


def _kron_ptrs(data: dict, bwd: bool):
    """The kron inputs' pointers (kr, kc, forward streams, then K2's mirror
    streams; null without kron pairs) and the names the launch checks."""
    names = ("kr", "kc") + _ZKF_KEYS + (_ZKB_KEYS if bwd else ())
    if "kr" not in data:
        return (_P * 8)(), ()
    return (_P * 8)(*[data[k].data_ptr() for k in names]), names


def _fused_fwd_cuda(data: dict, method: str, slots: torch.Tensor, n_eval: int, lo: bool):
    device = data["psi_re"].device
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    K = _n_kron(data)
    kron, knames = _kron_ptrs(data, False)
    names = ("psi_re", "psi_im", "rp", "cp", "hb_hi", "hb_lo", "hs", "diag", "diag_lo") + _ZF_KEYS
    _check_cuda({**{k: data[k] for k in names + knames}, "slots": slots}, device)
    a_arr, bnz, S = _tableau_c(method)
    check_parts(pr, pc)
    C, _ = cluster_plan(False, nb, da, db, pr, pc, K, S)
    lib = _library()
    rsym, rasym, csym, casym = _parts_sym(data)
    outs = tuple(torch.empty((R, n_eval, nb, da, db), dtype=torch.float32, device=device)
                 for _ in range(4 if lo else 2))
    lo_ptrs = (outs[2].data_ptr(), outs[3].data_ptr()) if lo else (None, None)
    zf = (_P * 8)(*[data[k].data_ptr() for k in _ZF_KEYS])
    # the library's runtime launches on its current device: make it the data's
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pdt_fused_fwd(
            data["psi_re"].data_ptr(), data["psi_im"].data_ptr(),
            rsym.data_ptr(), rasym.data_ptr(), csym.data_ptr(), casym.data_ptr(),
            zf,
            data["hb_hi"].data_ptr(), data["hb_lo"].data_ptr(), data["hs"].data_ptr(),
            data["diag"].data_ptr(), data["diag_lo"].data_ptr(), slots.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), *lo_ptrs, kron, K,
            R, n_steps, nb, da, db, pr, pc, n_eval, S,
            a_arr, bnz, C, stream,
        )
    _launch_check(err, "fused_fwd_kernel", pr, pc)
    LAUNCHES["fused_fwd"] += 1
    return outs


def _fused_bwd_cuda(data: dict, method: str, slots: torch.Tensor, n_eval: int,
                    last_slot: int, st_re, st_im, lam_re, lam_im):
    device = data["psi_re"].device
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    K = _n_kron(data)
    kron, knames = _kron_ptrs(data, True)
    names = ("rp", "cp", "hb_hi", "hb_lo", "hs", "diag", "diag_lo") + _ZF_KEYS + _ZB_KEYS
    _check_cuda(
        {**{k: data[k] for k in names + knames}, "slots": slots, "st_re": st_re,
         "st_im": st_im, "lam_re": lam_re, "lam_im": lam_im},
        device,
    )
    a_arr, bnz, S = _tableau_c(method)
    check_parts(pr, pc)
    C, _ = cluster_plan(True, nb, da, db, pr, pc, K, S)
    lib = _library()
    rsym, rasym, csym, casym = _parts_sym(data)
    outs = _bwd_outputs(data, S)
    lam0_re, lam0_im, zbar, dbar = outs[:4]
    krbar, kcbar = (o.data_ptr() for o in outs[4:]) if K else (None, None)
    # the per-block kcbar partials (R, C, K, db, db)
    scratch = torch.empty(int(lib.pdt_fused_scratch_floats(1, R, db, K, C)),
                          dtype=torch.float32, device=device)
    zf = (_P * 8)(*[data[k].data_ptr() for k in _ZF_KEYS])
    zb = (_P * 4)(*[data[k].data_ptr() for k in _ZB_KEYS])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pdt_fused_bwd(
            st_re.data_ptr(), st_im.data_ptr(), lam_re.data_ptr(), lam_im.data_ptr(),
            rsym.data_ptr(), rasym.data_ptr(), csym.data_ptr(), casym.data_ptr(),
            zf, zb,
            data["hb_hi"].data_ptr(), data["hb_lo"].data_ptr(), data["hs"].data_ptr(),
            data["diag"].data_ptr(), data["diag_lo"].data_ptr(), slots.data_ptr(),
            lam0_re.data_ptr(), lam0_im.data_ptr(), zbar.data_ptr(), dbar.data_ptr(),
            scratch.data_ptr(), kron, krbar, kcbar, K,
            R, n_steps, nb, da, db, pr, pc, n_eval, last_slot, S,
            a_arr, bnz, C, stream,
        )
    _launch_check(err, "fused_bwd_kernel", pr, pc)
    LAUNCHES["fused_bwd"] += 1
    return outs


def _op_inputs(data: dict) -> tuple[str, list]:
    """The ops' data keys, comma-joined (an op schema has no list of
    strings), and their tensors in that order; raise for a device type
    that has no kernel (the ops have a "cpu" and a "cuda" implementation
    and nothing else)."""
    dev = data["psi_re"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"No fused kernel for device type '{dev.type}'.")
    keys = _fn_keys(data)
    return ",".join(keys), [data[k] for k in keys]


def fused_fwd(data: dict, method: str, slots: torch.Tensor, n_eval: int, lo: bool = False,
              last_slot: int = -1):
    """K1: forward evolution writing every evaluation-slot state; with
    ``lo`` also the states' low words (their Kahan carries, negated).

    Replaces ``_fwd_kernel`` (pallas_evolution.py) with ``states=True``,
    with its kron-pair branch when ``data`` has kron pairs.  A call of the
    op ``pulser_diff_torch::fused_fwd``: CPU tensors take
    :func:`fused_fwd_plain`, CUDA tensors launch ``fused_fwd_kernel``.
    Differentiable through K2, which starts from ``last_slot``, the final
    grid point's slot (-1: read from ``slots`` when the backward runs)."""
    _check_shapes(data, _tableau(method)[2], slots=slots, n_eval=n_eval)
    keys, tensors = _op_inputs(data)
    return tuple(_fwd_op(method, keys, slots, int(n_eval), int(last_slot), bool(lo), tensors))


def fused_bwd(data: dict, method: str, slots: torch.Tensor, n_eval: int,
              last_slot: int, st_re, st_im, lam_re, lam_im):
    """K2: discrete adjoint of :func:`fused_fwd` for the slot cotangents
    ``lam``.  Replaces ``_bwd_kernel`` (lean interval form).  Returns
    (lam0_re, lam0_im, zbar, dbar), then (krbar, kcbar) with kron pairs.
    A call of the op ``pulser_diff_torch::fused_bwd``: CPU tensors take
    :func:`fused_bwd_plain`, CUDA tensors launch ``fused_bwd_kernel``."""
    _check_shapes(data, _tableau(method)[2], st_re, st_im, lam_re, lam_im,
                  slots=slots, n_eval=n_eval)
    if not 0 <= last_slot < n_eval:
        raise ValueError(f"last_slot {last_slot} is not an evaluation slot (n_eval={n_eval}).")
    keys, tensors = _op_inputs(data)
    return tuple(_bwd_op(method, keys, slots, int(n_eval), int(last_slot),
                         st_re, st_im, lam_re, lam_im, tensors))


# ----------------------------------------------------------------------
# checkpointed kernels (csrc/fused_ckpt.cu): K4 forward, K5 adjoint
# ----------------------------------------------------------------------
# inputs of pdt_ckpt_fwd / pdt_ckpt_bwd, in the order of their pointer arrays
_CKPT_FWD_IN = ("psi_re", "psi_im", "rsym", "rasym", "csym", "casym") + _ZF_KEYS + (
    "hb_hi", "hb_lo", "hs", "diag", "diag_lo")
_CKPT_BWD_IN = ("st_re", "st_im", "lam_re", "lam_im") + _CKPT_FWD_IN
# the data keys both take (the symmetric part stacks are formed per launch)
_CKPT_DATA_KEYS = ("psi_re", "psi_im", "rp", "cp", "hb_hi", "hb_lo", "hs", "diag",
                   "diag_lo") + _ZF_KEYS


def _ckpt_library() -> ctypes.CDLL:
    lib = kernel_build.load("fused_ckpt")
    if not getattr(lib, "_pdt_declared", False):
        lib.pdt_ckpt_scratch_floats.argtypes = [_I] * 7
        lib.pdt_ckpt_scratch_floats.restype = ctypes.c_size_t
        lib.pdt_ckpt_blocks.argtypes = [_I] * 6
        lib.pdt_ckpt_blocks.restype = _I
        lib.pdt_ckpt_plan.argtypes = [_I] * 7 + [_P]
        lib.pdt_ckpt_plan.restype = _I
        lib.pdt_ckpt_fwd.argtypes = [_P, _P, _I] + [_P] * 6 + [_I] * 8 + [_P, _P, _P]
        lib.pdt_ckpt_fwd.restype = _I
        lib.pdt_ckpt_bwd.argtypes = [_P, _P, _I] + [_P] * 8 + [_I] * 8 + [_P, _P, _P]
        lib.pdt_ckpt_bwd.restype = _I
        lib._pdt_declared = True
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ckpt_plan(bwd: bool, R: int, nb: int, da: int, db: int, K: int, S: int,
              n_sm: int = 132) -> dict:
    """K4's (``bwd=False``) or K5's launch on a card with ``n_sm`` SMs, as
    the kernel plans it (``make_plan`` in csrc/fused_ckpt.cu).

    A job owns an output tile of (16 rm) x (8 rn) elements: 32 x 16 where
    those tiles (over all runs) come to at least three quarters of the
    SMs, else 16 x 8.  The R-side kron products, the part-matrix cotangents and the
    outer products run on double tiles (two tile heights, a group each).
    Returns the grid (one block per SM, at most the largest phase's jobs),
    the tile, the jobs of each product phase (all runs), the grid barriers
    per step (one per application of -iH, two with kron pairs) and the
    shared memory of a block."""
    r = 2 if 4 * R * _cdiv(da, 32) * _cdiv(db, 16) >= 3 * n_sm else 1
    tm, tn = 16 * r, 8 * r
    tiles = _cdiv(da, tm) * _cdiv(db, tn)
    dt = _cdiv(da, 2 * tm) * _cdiv(db, tn)
    outer = _cdiv(da, 2 * tm) * _cdiv(da, tn) + _cdiv(db, 2 * tm) * _cdiv(db, tn)
    first = tiles + 2 * K * nb * dt
    if bwd:
        phases = {"forward": first, "forward_kron": tiles,
                  "reverse": first + 4 * K * nb * dt + outer, "reverse_kron": tiles + K * outer}
    else:
        phases = {"apply": first, "apply_kron": tiles}
    jobs = {k: R * v for k, v in phases.items() if K or not k.endswith("_kron")}
    most = max(jobs.values())
    return {"blocks": max(1, min(most, n_sm)), "tile": (tm, tn), "jobs": jobs, "jobs_max": most,
            "barriers_per_step": (2 * S - 1 if bwd else S) * (2 if K else 1),
            "smem_bytes": _CKPT_SMEM}


def ckpt_device_plan(data: dict, method: str, bwd: bool) -> dict:
    """The plan K4 (``bwd=False``) or K5 computes for ``data`` on its CUDA
    device (``pdt_ckpt_plan``): blocks, tile, the largest phase's jobs,
    grid barriers per step, shared memory a block and the device's SMs."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(data["psi_re"].device):
        err = _ckpt_library().pdt_ckpt_plan(int(bwd), R, nb, da, db, _n_kron(data),
                                            _tableau(method)[2], out)
    _launch_check(err, "pdt_ckpt_plan", pr, pc)
    return {"blocks": out[0], "tile": (out[1], out[2]), "jobs_max": out[3],
            "barriers_per_step": out[4], "smem_bytes": out[5], "sms": out[6]}


def ckpt_blocks(data: dict, bwd: bool) -> int:
    """The cooperative grid (blocks of 256 threads) that K4 (``bwd=False``)
    or K5 launches for ``data`` on its CUDA device."""
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    with torch.cuda.device(data["psi_re"].device):
        return int(_ckpt_library().pdt_ckpt_blocks(int(bwd), R, nb, da, db, _n_kron(data)))


def _ckpt_launch(fn_name: str, bwd: int, data: dict, method: str, tensors: dict, outs) -> None:
    """Check, then launch K4 or K5 as one cooperative grid on the data's
    device and torch's current stream; raise if the launch is refused.
    The barrier words stay in ``CKPT_BARRIERS[fn_name]``.
    ``outs``: K4's states, or K5's (lam0_re, lam0_im, zbar, dbar[, krbar,
    kcbar])."""
    device = data["psi_re"].device
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    K = _n_kron(data)
    kron, knames = _kron_ptrs(data, False)
    _check_cuda({**tensors, **{k: data[k] for k in knames}}, device)
    check_parts(pr, pc)
    lib = _ckpt_library()
    a_arr, bnz, S = _tableau_c(method)
    rsym, rasym, csym, casym = _parts_sym(data)
    ins = {**tensors, "rsym": rsym, "rasym": rasym, "csym": csym, "casym": casym}
    order = _CKPT_BWD_IN if bwd else _CKPT_FWD_IN
    in_ptrs = (_P * len(order))(*[ins[k].data_ptr() for k in order])
    scratch = torch.empty(int(lib.pdt_ckpt_scratch_floats(bwd, R, S, nb, da, db, K)),
                          dtype=torch.float32, device=device)
    # the grid barrier's arrival count and generation; the count starts at 0
    barrier = torch.zeros(2, dtype=torch.int32, device=device)
    out_ptrs = [t.data_ptr() for t in outs[:4]]
    if bwd:
        out_ptrs += [t.data_ptr() for t in outs[4:]] if K else [None, None]
    elif len(outs) == 2:
        out_ptrs += [None, None]  # no low words
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(
            in_ptrs, kron, K, *out_ptrs, scratch.data_ptr(), barrier.data_ptr(),
            R, n_steps, nb, da, db, pr, pc, S, a_arr, bnz, stream,
        )
    _launch_check(err, fn_name, pr, pc)
    CKPT_BARRIERS[fn_name] = barrier


def _fused_fwd_ckpt_cuda(data: dict, method: str, lo: bool):
    R, n_steps, pr, pc, nb, da, db = _dims(data)
    outs = tuple(torch.empty((R, n_steps, nb, da, db), dtype=torch.float32,
                             device=data["psi_re"].device) for _ in range(4 if lo else 2))
    _ckpt_launch("pdt_ckpt_fwd", 0, data, method, {k: data[k] for k in _CKPT_DATA_KEYS}, outs)
    LAUNCHES["fused_fwd_ckpt"] += 1
    return outs


def _fused_bwd_ckpt_cuda(data: dict, method: str, st_re, st_im, lam_re, lam_im):
    tensors = {**{k: data[k] for k in _CKPT_DATA_KEYS},
               "st_re": st_re, "st_im": st_im, "lam_re": lam_re, "lam_im": lam_im}
    outs = _bwd_outputs(data, _tableau(method)[2])
    _ckpt_launch("pdt_ckpt_bwd", 1, data, method, tensors, outs)
    LAUNCHES["fused_bwd_ckpt"] += 1
    return outs


def fused_fwd_ckpt(data: dict, method: str, lo: bool = False):
    """K4: forward evolution storing the state after every step,
    (R, n_steps, nb, da, db) re/im; with ``lo`` also their low words.

    Replaces ``_fwd_ckpt_kernel`` (pallas_evolution.py), with its
    kron-pair branch when ``data`` has kron pairs.  A call of the op
    ``pulser_diff_torch::fused_fwd_ckpt``: CPU tensors take
    :func:`fused_fwd_ckpt_plain`, CUDA tensors launch
    ``fused_fwd_ckpt_kernel`` (csrc/fused_ckpt.cu).  Differentiable
    through K5."""
    _check_shapes(data, _tableau(method)[2])
    keys, tensors = _op_inputs(data)
    return tuple(_fwd_ckpt_op(method, keys, bool(lo), tensors))


def fused_bwd_ckpt(data: dict, method: str, st_re, st_im, lam_re, lam_im):
    """K5: adjoint of :func:`fused_fwd_ckpt` for the per-step cotangents
    ``lam``, from the stored states ``st``.  Replaces ``_bwd_ckpt_kernel``.
    Returns what :func:`fused_bwd` returns.  A call of the op
    ``pulser_diff_torch::fused_bwd_ckpt``: CPU tensors take
    :func:`fused_bwd_ckpt_plain`, CUDA tensors launch
    ``fused_bwd_ckpt_kernel``."""
    _check_shapes(data, _tableau(method)[2], st_re, st_im, lam_re, lam_im)
    keys, tensors = _op_inputs(data)
    return tuple(_bwd_ckpt_op(method, keys, st_re, st_im, lam_re, lam_im, tensors))


# ----------------------------------------------------------------------
# the kernels as torch.library custom ops, with their autograd rules
# ----------------------------------------------------------------------
# Each op takes the data as one list of tensors and its keys as one
# comma-joined string (an op schema has no list of strings).  Its "cpu"
# implementation is the plain version and its "cuda" one the launch; a
# fake implementation gives the outputs' shapes, so ``torch.export`` keeps
# the op (and, under ``torch.autograd.grad``, its adjoint) in the graph.
# The implementations look the launches up when they run, so a harness can
# swap a launch for its plain version.
def _data_of(keys: str, tensors) -> dict:
    return dict(zip(keys.split(","), tensors))


def _no_kernel(*args):
    raise ValueError("The fused kernels run on 'cpu' (plain versions) and 'cuda' tensors only.")


def _fwd_outputs(data: dict, lead, lo: bool) -> list:
    """Fresh (R, lead, nb, da, db) f32 states: two, or four with ``lo``."""
    psi = data["psi_re"]
    return [psi.new_empty((psi.shape[0], lead, *psi.shape[1:])) for _ in range(4 if lo else 2)]


@torch.library.custom_op("pulser_diff_torch::fused_fwd", mutates_args=())
def _fwd_op(method: str, keys: str, slots: torch.Tensor, n_eval: int, last_slot: int, lo: bool,
            tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """K1 (``last_slot`` is its adjoint's; see :func:`fused_fwd`)."""
    _no_kernel()


@_fwd_op.register_kernel("cpu")
def _(method, keys, slots, n_eval, last_slot, lo, tensors):
    return list(fused_fwd_plain(_data_of(keys, tensors), method, slots, n_eval, lo))


@_fwd_op.register_kernel("cuda")
def _(method, keys, slots, n_eval, last_slot, lo, tensors):
    return list(_fused_fwd_cuda(_data_of(keys, tensors), method, slots, n_eval, lo))


@_fwd_op.register_fake
def _(method, keys, slots, n_eval, last_slot, lo, tensors):
    return _fwd_outputs(_data_of(keys, tensors), n_eval, lo)


@torch.library.custom_op("pulser_diff_torch::fused_bwd", mutates_args=())
def _bwd_op(method: str, keys: str, slots: torch.Tensor, n_eval: int, last_slot: int,
            st_re: torch.Tensor, st_im: torch.Tensor, lam_re: torch.Tensor, lam_im: torch.Tensor,
            tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """K2 (see :func:`fused_bwd`)."""
    _no_kernel()


@_bwd_op.register_kernel("cpu")
def _(method, keys, slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im, tensors):
    return list(fused_bwd_plain(_data_of(keys, tensors), method, slots, n_eval, last_slot,
                                st_re, st_im, lam_re, lam_im))


@_bwd_op.register_kernel("cuda")
def _(method, keys, slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im, tensors):
    return list(_fused_bwd_cuda(_data_of(keys, tensors), method, slots, n_eval, last_slot,
                                st_re, st_im, lam_re, lam_im))


@_bwd_op.register_fake
def _(method, keys, slots, n_eval, last_slot, st_re, st_im, lam_re, lam_im, tensors):
    return list(_bwd_outputs(_data_of(keys, tensors), _tableau(method)[2]))


@torch.library.custom_op("pulser_diff_torch::fused_fwd_ckpt", mutates_args=())
def _fwd_ckpt_op(method: str, keys: str, lo: bool,
                 tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """K4 (see :func:`fused_fwd_ckpt`)."""
    _no_kernel()


@_fwd_ckpt_op.register_kernel("cpu")
def _(method, keys, lo, tensors):
    return list(fused_fwd_ckpt_plain(_data_of(keys, tensors), method, lo))


@_fwd_ckpt_op.register_kernel("cuda")
def _(method, keys, lo, tensors):
    return list(_fused_fwd_ckpt_cuda(_data_of(keys, tensors), method, lo))


@_fwd_ckpt_op.register_fake
def _(method, keys, lo, tensors):
    data = _data_of(keys, tensors)
    return _fwd_outputs(data, data["hs"].shape[0], lo)


@torch.library.custom_op("pulser_diff_torch::fused_bwd_ckpt", mutates_args=())
def _bwd_ckpt_op(method: str, keys: str, st_re: torch.Tensor, st_im: torch.Tensor,
                 lam_re: torch.Tensor, lam_im: torch.Tensor,
                 tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """K5 (see :func:`fused_bwd_ckpt`)."""
    _no_kernel()


@_bwd_ckpt_op.register_kernel("cpu")
def _(method, keys, st_re, st_im, lam_re, lam_im, tensors):
    return list(fused_bwd_ckpt_plain(_data_of(keys, tensors), method, st_re, st_im,
                                     lam_re, lam_im))


@_bwd_ckpt_op.register_kernel("cuda")
def _(method, keys, st_re, st_im, lam_re, lam_im, tensors):
    return list(_fused_bwd_ckpt_cuda(_data_of(keys, tensors), method, st_re, st_im,
                                     lam_re, lam_im))


@_bwd_ckpt_op.register_fake
def _(method, keys, st_re, st_im, lam_re, lam_im, tensors):
    return list(_bwd_outputs(_data_of(keys, tensors), _tableau(method)[2]))


def _states_out(outs) -> tuple:
    """A forward kernel's states as the differentiable forms return them:
    the f32 hi words, or with kron pairs (outs carries the low words) the
    compensated state hi + lo, exactly, in f64 (torch ops outside the op,
    so autograd hands the hi word the cotangent of the sum and the lo
    word's is dropped, as :func:`_f32_cot` says).

    Why only with kron pairs: the XY main path's observable (12 atoms,
    total magnetization ~11.9 from a state within a few 1e-3 of |u...u>)
    moves by up to ~7e-7 under the f32 rounding of the state alone, half
    of the 1e-6 bar, and the hi words missed the bar (1.08e-6); with the
    low words that term is gone.  The ising path keeps the Pallas kernels'
    single-word states: with low words the 4-atom ising model of
    tests/test_torch_model.py and tests/test_torch_ckpt.py moves 2.14e-7
    from the JAX package's fused value (which returns the hi words), past
    the 1e-7 parity those tests hold, for no bar the ising path misses."""
    if len(outs) == 2:
        return tuple(outs)
    f64 = torch.float64
    return outs[0].to(f64) + outs[2].to(f64), outs[1].to(f64) + outs[3].to(f64)


def _f32_cot(g: torch.Tensor) -> torch.Tensor:
    """A state cotangent as the adjoint kernels take it.  A low word is the
    forward's rounding remainder: its derivative is taken as zero, so the
    cotangent of hi + lo is the cotangent of hi."""
    return g.to(torch.float32).contiguous()


def _cotangents(data: dict, outs) -> dict:
    """An adjoint kernel's outputs as the cotangent of every data key."""
    lam0_re, lam0_im, zbar, dbar = outs[:4]
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    kron = (*_unpack_zbar_kron(zbar, pr, pc), *outs[4:]) if len(outs) > 4 else None
    return _zero_like_aux(data, _unpack_zbar(zbar, pr, pc), dbar, lam0_re, lam0_im, kron)


def _data_grads(keys: str, cot: dict, needs) -> list:
    return [cot[k] if n else None for k, n in zip(keys.split(","), needs)]


def _save_states(ctx, output, *inputs, n_states: int = 2) -> None:
    """Keep the forward's first ``n_states`` outputs (the hi words) and the
    inputs for the adjoint.  Under ``torch.export`` the outputs are held
    on ``ctx`` itself: a saved output comes back from autograd as a new
    tensor, which the trace no longer knows and would freeze into the
    artifact as a constant.  Eagerly they are saved tensors (no reference
    cycle through the graph)."""
    states = tuple(output[:n_states])
    if torch.compiler.is_exporting():
        ctx.states = states
        ctx.save_for_backward(*inputs)
    else:
        ctx.states = None
        ctx.save_for_backward(*states, *inputs)


def _saved(ctx) -> tuple:
    """(*outputs, *inputs) as :func:`_save_states` kept them."""
    if ctx.states is None:
        return ctx.saved_tensors
    return (*ctx.states, *ctx.saved_tensors)


def _fwd_setup(ctx, inputs, output) -> None:
    method, keys, slots, n_eval, last_slot, lo, tensors = inputs
    ctx.method, ctx.keys, ctx.n_eval, ctx.last_slot = method, keys, n_eval, last_slot
    _save_states(ctx, output, slots, *tensors)


def _fwd_backward(ctx, grads):
    """K1's rule (counterpart of the JAX custom VJP ``fused_evolve_states``):
    K2 on the hi words' cotangents."""
    st_re, st_im, slots, *tensors = _saved(ctx)
    data = _data_of(ctx.keys, tensors)
    last_slot = ctx.last_slot if ctx.last_slot >= 0 else int(slots[-1])
    cot = _cotangents(data, fused_bwd(data, ctx.method, slots, ctx.n_eval, last_slot,
                                      st_re, st_im, _f32_cot(grads[0]), _f32_cot(grads[1])))
    return (None,) * 6 + (_data_grads(ctx.keys, cot, ctx.needs_input_grad[6]),)


def _fwd_ckpt_setup(ctx, inputs, output) -> None:
    method, keys, lo, tensors = inputs
    ctx.method, ctx.keys = method, keys
    _save_states(ctx, output, *tensors)


def _fwd_ckpt_backward(ctx, grads):
    """K4's rule (counterpart of the JAX custom VJP ``fused_evolve_ckpt``):
    K5 fed the per-step cotangent buffer autograd hands it (dense, zero at
    every step no slot reads)."""
    st_re, st_im, *tensors = _saved(ctx)
    data = _data_of(ctx.keys, tensors)
    cot = _cotangents(data, fused_bwd_ckpt(data, ctx.method, st_re, st_im,
                                           _f32_cot(grads[0]), _f32_cot(grads[1])))
    return (None,) * 3 + (_data_grads(ctx.keys, cot, ctx.needs_input_grad[3]),)


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)
_fwd_ckpt_op.register_autograd(_fwd_ckpt_backward, setup_context=_fwd_ckpt_setup)


def fused_evolve_states(method: str, slots: torch.Tensor, n_eval: int,
                        last_slot: int, data: dict):
    """Fused f32 ERK evolution emitting every evaluation-slot state,
    differentiable through the adjoint kernel.

    slots: int32 tensor (n_steps + 1,) of grid write slots on the data's
    device; n_eval: number of evaluation slots; last_slot: the final grid
    point's slot.  Returns (R, n_eval, nb, da, db) re/im: f32, or with
    kron pairs the two-word states hi + lo in f64 (see ``_states_out``)."""
    return _states_out(fused_fwd(data, method, slots, n_eval, lo="kr" in data,
                                 last_slot=int(last_slot)))


def fused_evolve_ckpt(method: str, data: dict):
    """Fused f32 ERK evolution emitting EVERY step's state,
    (R, n_steps, nb, da, db) re/im (as :func:`fused_evolve_states` returns
    them; the state after step k at index k), differentiable through the
    checkpointed adjoint kernel, which reads exact start states (the hi
    words the forward stepped from) instead of reconstructing them."""
    return _states_out(fused_fwd_ckpt(data, method, lo="kr" in data))


def evolve_mc(hams, psi0: Cplx, grid, method: str = "DP5", ckpt: bool = False) -> Cplx:
    """Fused evolution of R runs in one launch of the forward kernel (and,
    under autograd, one of the adjoint), the runs on the kernels' runs axis
    (counterpart of ``pallas_evolve_mc``).  ``hams``: R factored
    Hamiltonians on one grid and one register geometry (their part stacks
    equal); ``psi0``: (nb, da, db) shared or (R, nb, da, db) per run.
    Returns the states at the grid's evaluation slots, (R, n_eval, nb, da,
    db): f32, or f64 two-word states with kron pairs.  ``ckpt=True`` takes
    the checkpointed kernels K4/K5: every step's state is stored and the
    slots are gathered from it, so their cotangents scatter into the
    per-step buffer."""
    data = prepare_mc_inputs(hams, psi0, grid.times, method)
    pr, pc = int(data["rp"].shape[0]), int(data["cp"].shape[0])
    check_parts(pr, pc)
    slots_np = np.asarray(grid.write_slots, dtype=np.int32)
    last_slot = int(slots_np[-1])
    if last_slot >= grid.n_eval:
        raise ValueError(
            "The final grid point must carry an evaluation slot (the "
            "emulator always unions {0, T} into evaluation times)."
        )
    device = data["psi_re"].device
    if ckpt:
        st_re, st_im = fused_evolve_ckpt(method, data)
        # grid point g carries slot s when slots[g] = s < n_eval; its state
        # is psi0 for g = 0 and stored[:, g - 1] otherwise
        by_slot = {int(s): g for g, s in enumerate(slots_np) if s < grid.n_eval}
        idx = torch.as_tensor([by_slot[s] for s in range(grid.n_eval)], device=device)
        return Cplx(
            torch.cat([data["psi_re"].to(st_re.dtype)[:, None], st_re], 1).index_select(1, idx),
            torch.cat([data["psi_im"].to(st_im.dtype)[:, None], st_im], 1).index_select(1, idx))
    slots = torch.as_tensor(slots_np, device=device)
    return Cplx(*fused_evolve_states(method, slots, grid.n_eval, last_slot, data))


def evolve_states(ham: FactoredHamiltonian, psi0: Cplx, grid, method: str = "DP5",
                  ckpt: bool = False) -> Cplx:
    """Fused evolution emitting the states at the grid's evaluation slots,
    (n_eval, nb, da, db) f32 (f64 two-word states with kron pairs),
    differentiable (counterpart of ``pallas_evolve_states``): one run of
    :func:`evolve_mc`."""
    return evolve_mc([ham], psi0, grid, method, ckpt)[0]


def fused_evolve(method: str, data: dict):
    """Fused f32 ERK evolution returning the final state only, (R, nb, da,
    db) re/im, differentiable (counterpart of the JAX package's
    ``fused_evolve``): K1 with a slot table in which only the last grid
    point carries a slot, so K2 takes that slot's cotangent alone and
    rebuilds every earlier step, as the JAX kernels do without their
    states table.  With kron pairs the state is the two-word hi + lo in
    f64 (``_states_out``)."""
    n_steps = int(data["hs"].shape[0])
    slots = torch.ones(n_steps + 1, dtype=torch.int32, device=data["psi_re"].device)
    slots[-1] = 0
    st_re, st_im = fused_evolve_states(method, slots, 1, 0, data)
    return st_re[:, 0], st_im[:, 0]


def pallas_evolve(ham: FactoredHamiltonian, psi0: Cplx, grid_times: torch.Tensor,
                  method: str = "DP5", ckpt: bool = False) -> Cplx:
    """Evolve psi0 (nb, da, db) over ``grid_times`` on the fused kernels and
    return the final state only, differentiable in the Hamiltonian's
    streams, its interaction diagonal, its kron part matrices and psi0
    (counterpart of the JAX package's ``pallas_evolve``).  K1/K2 by
    default (``fused_evolve``); ``ckpt=True`` takes K4/K5, the last step of
    ``fused_evolve_ckpt``.  f32, or with kron pairs the two-word state in
    f64, as ``evolve_states`` returns it."""
    data = prepare_fused_inputs(ham, psi0, grid_times, method)
    check_parts(int(data["rp"].shape[0]), int(data["cp"].shape[0]))
    if ckpt:
        st_re, st_im = fused_evolve_ckpt(method, data)
        return Cplx(st_re[0, -1], st_im[0, -1])
    out_re, out_im = fused_evolve(method, data)
    return Cplx(out_re[0], out_im[0])

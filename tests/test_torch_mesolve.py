"""PyTorch port vs the JAX package: the Lindblad master equation
(pulser_diff_torch.hamiltonian.collapse_operators / CollapseOps,
ops.apply's density-matrix products, ops.linalg's trace / vn_entropy /
expect on rho, and solvers.solver.mesolve in its superop, dense and
factored forms, f64 and f32).

The same Hamiltonian, collapse operators and initial density matrix go
through both packages (carried across as numpy).  f64 states agree to
1e-12, the forms with each other to 1e-13; the f32 forms agree with the
JAX package's f32 forms and with f64 to f32 roundoff random-walked over
the grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
from pulser_diff_tpu import SimConfig as JSimConfig
from pulser_diff_tpu import TpuEmulator
from pulser_diff_tpu.cplx import Cplx as JCplx
from pulser_diff_tpu.ops import apply as japply
from pulser_diff_tpu.ops import linalg as jlinalg
from pulser_diff_tpu.solvers import TimeGrid as JGrid
from pulser_diff_tpu.solvers import solver as jsolver
import pulser_diff_torch.core as tcore
from pulser_diff_torch import SimConfig, TorchEmulator
from pulser_diff_torch.convert import collapse_from_numpy, factored_from_numpy
from pulser_diff_torch.cplx import Cplx
from pulser_diff_torch.hamiltonian import collapse_operators
from pulser_diff_torch.ops import apply as tapply
from pulser_diff_torch.ops import linalg as tlinalg
from pulser_diff_torch.simconfig import NoiseModel
from pulser_diff_torch.solvers import TimeGrid as TGrid
from pulser_diff_torch.solvers import solver as tsolver

from tests.torch_port_cases import (
    factored_fields, kron_fields, sequence, to_numpy, xy_sequence,
)

torch.set_num_threads(1)

F64_TOL = 1e-12
FORM_TOL = 1e-13
OP_TOL = 1e-15
# f32 forms (unit-trace rho, ~60 steps) against the JAX package's f32
# forms and against f64 (observed below 1e-7 and 5e-7 at 2-3 atoms)
F32_TOL = 2e-6
EFF_OP = np.array([[0.3, 0.4], [0.4, -0.3]])

CHANNELS = {
    "dephasing": dict(noise="dephasing", dephasing_rate=0.12),
    "relaxation": dict(noise="relaxation", relaxation_rate=0.07),
    "depolarizing": dict(noise="depolarizing", depolarizing_rate=0.09),
    "eff_noise": dict(noise="eff_noise", eff_noise_rates=(0.2,), eff_noise_opers=(EFF_OP,)),
    "all": dict(noise=("dephasing", "relaxation", "depolarizing"), dephasing_rate=0.1,
                relaxation_rate=0.05, depolarizing_rate=0.03),
}


def _emulators(n, kind, duration=40, noise="all", evaluation_times="Full"):
    """(JAX emulator, port emulator on the CPU) with the noise CHANNELS[noise]."""
    seq = xy_sequence if kind == "xy" else sequence
    cfg = CHANNELS[noise]
    if kind == "xy":
        cfg = dict(noise="dephasing", dephasing_rate=0.1)
    jsim = TpuEmulator.from_sequence(seq(jcore, n, duration), sampling_rate=0.5,
                                     config=JSimConfig(**cfg), evaluation_times=evaluation_times)
    tsim = TorchEmulator.from_sequence(seq(tcore, n, duration), sampling_rate=0.5,
                                       config=SimConfig(**cfg), evaluation_times=evaluation_times,
                                       device="cpu")
    return jsim, tsim


def _ham_pair(jsim):
    """JAX's Hamiltonian, and the same one as the port's (carried across)."""
    hd = jsim._hamiltonian._ham_data
    f = factored_fields(hd)
    kron = {}
    if hd.kron_row is not None:
        k = kron_fields(hd)
        kron = dict(kron_row=k["kron_row"], kron_col=k["kron_col"],
                    kron_streams=(k["kron_streams_re"], k["kron_streams_im"]))
    th = factored_from_numpy(
        row_parts=f["row_parts"], col_parts=f["col_parts"],
        row_streams=(f["row_streams_re"], f["row_streams_im"]),
        col_streams=(f["col_streams_re"], f["col_streams_im"]),
        int_diag=f["int_diag"], sample_dt=f["sample_dt"], n_samples=int(f["n_samples"]),
        device="cpu", **kron)
    return hd, th


def _collapse_pair(jsim):
    c = jsim._hamiltonian._collapse_ops
    ops = None if c.ops is None else (np.asarray(c.ops.re), np.asarray(c.ops.im))
    return c, collapse_from_numpy(c.sites, ops, device="cpu")


def _rho(dim, seed, dtype=np.float64):
    """A random density matrix (re, im)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    rho = a @ a.conj().T
    rho /= np.trace(rho).real
    return rho.real.astype(dtype), rho.imag.astype(dtype)


def _grids(jsim):
    h = jsim._hamiltonian
    return (JGrid.make(h.sampling_times, jsim._eval_times_array),
            TGrid.make(h.sampling_times, jsim._eval_times_array, device="cpu"))


def _np(c) -> np.ndarray:
    return to_numpy(c.re) + 1j * to_numpy(c.im)


# ----------------------------------------------------------------------
# collapse operators
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind, noise", [("ising", k) for k in sorted(CHANNELS)]
                         + [("xy", k) for k in ("dephasing", "depolarizing", "eff_noise")])
def test_collapse_ops_match_jax(kind, noise):
    seq = xy_sequence if kind == "xy" else sequence
    cfg = CHANNELS[noise]
    jsim = TpuEmulator.from_sequence(seq(jcore, 3, 20), config=JSimConfig(**cfg),
                                     evaluation_times="Minimal")
    tsim = TorchEmulator.from_sequence(seq(tcore, 3, 20), config=SimConfig(**cfg),
                                       evaluation_times="Minimal", device="cpu")
    jc, tc = jsim._hamiltonian._collapse_ops, tsim._hamiltonian._collapse_ops
    assert tc.sites == tuple(int(s) for s in jc.sites)
    np.testing.assert_allclose(_np(tc.ops), np.asarray(jc.ops.re) + 1j * np.asarray(jc.ops.im),
                               rtol=0, atol=OP_TOL)


def test_collapse_ops_digital_basis_match_jax():
    """The digital basis (a Raman channel): dephasing at the hyperfine rate;
    relaxation refused in both packages."""
    reg = jcore.Register.from_coordinates([(0.0, 0.0), (6.0, 0.0)], prefix="q")
    seq = jcore.Sequence(reg, jcore.MockDevice)
    seq.declare_channel("ram", "raman_global")
    seq.add(jcore.Pulse.ConstantPulse(20, 1.0, 0.0, 0.0), "ram")
    cfg = dict(noise=("dephasing", "depolarizing"), dephasing_rate=0.2,
               hyperfine_dephasing_rate=0.03, depolarizing_rate=0.05)
    jsim = TpuEmulator.from_sequence(seq, config=JSimConfig(**cfg), evaluation_times="Minimal")
    h = jsim._hamiltonian
    assert h.basis_name == "digital"
    tc = collapse_operators(SimConfig(**cfg).to_noise_model(), "digital", list(h._basis_labels),
                            2, torch.device("cpu"))
    jc = h._collapse_ops
    assert tc.sites == tuple(int(s) for s in jc.sites)
    np.testing.assert_allclose(_np(tc.ops), np.asarray(jc.ops.re) + 1j * np.asarray(jc.ops.im),
                               rtol=0, atol=OP_TOL)
    with pytest.raises(ValueError, match="ground-rydberg"):
        jsim.set_config(JSimConfig(noise="relaxation"))
    with pytest.raises(ValueError, match="ground-rydberg"):
        collapse_operators(NoiseModel(noise_types=("relaxation",)), "digital",
                           list(h._basis_labels), 2, torch.device("cpu"))


def test_eff_noise_shape_is_checked_as_in_jax():
    bad = dict(noise="eff_noise", eff_noise_rates=(0.1,), eff_noise_opers=(np.eye(3),))
    with pytest.raises(ValueError, match="Incompatible shape"):
        TpuEmulator.from_sequence(sequence(jcore, 2, 20), config=JSimConfig(**bad))
    with pytest.raises(ValueError, match="Incompatible shape"):
        TorchEmulator.from_sequence(sequence(tcore, 2, 20), config=SimConfig(**bad),
                                    device="cpu")


def test_rate_tensor_keeps_its_gradient():
    rate = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    c = collapse_operators(NoiseModel(noise_types=("dephasing",), dephasing_rate=rate),
                           "ground-rydberg", ["r", "g"], 2, torch.device("cpu"))
    # d/dr of sum_sites sqrt(r / 2) Z[0, 0] over 2 sites
    c.ops.re[:, 0, 0].sum().backward()
    np.testing.assert_allclose(float(rate.grad), 0.5 / np.sqrt(0.2 / 2), rtol=1e-14)


# ----------------------------------------------------------------------
# density-matrix products
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ising", "xy"])
def test_rho_products_match_jax(kind):
    jsim, _ = _emulators(3, kind, duration=40)
    jh, th = _ham_pair(jsim)
    re, im = _rho(th.dim, seed=2)
    t = 0.013
    jz = japply.interp_streams(jh, jnp.asarray(t))
    tz = tapply.interp_streams(th, torch.tensor(t, dtype=torch.float64))
    jo = japply.h_apply_rho_left(jh, *jz, JCplx(jnp.asarray(re), jnp.asarray(im)))
    to = tapply.h_apply_rho_left(th, *tz, Cplx(torch.as_tensor(re), torch.as_tensor(im)))
    np.testing.assert_allclose(_np(to), np.asarray(jo.re) + 1j * np.asarray(jo.im), rtol=0,
                               atol=F64_TOL)
    rng = np.random.default_rng(5)
    op = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    jop = JCplx(jnp.asarray(op.real), jnp.asarray(op.imag))
    top = Cplx(torch.as_tensor(op.real), torch.as_tensor(op.imag))
    for site in range(3):
        for jf, tf in ((japply.apply_local_left, tapply.apply_local_left),
                       (japply.apply_local_right, tapply.apply_local_right)):
            jo = jf(jop, site, 3, 2, JCplx(jnp.asarray(re), jnp.asarray(im)))
            to = tf(top, site, 3, 2, Cplx(torch.as_tensor(re), torch.as_tensor(im)))
            np.testing.assert_allclose(_np(to), np.asarray(jo.re) + 1j * np.asarray(jo.im),
                                       rtol=0, atol=F64_TOL)


# ----------------------------------------------------------------------
# the three forms of mesolve
# ----------------------------------------------------------------------
def _mesolve_pair(n, kind, form, solver="DP5_ME", noise="all", seed=1):
    jsim, _ = _emulators(n, kind, noise=noise)
    jh, th = _ham_pair(jsim)
    jc, tc = _collapse_pair(jsim)
    jg, tg = _grids(jsim)
    dt = np.float32 if solver.endswith("F32") else np.float64
    re, im = _rho(th.dim, seed)
    js = jsolver.mesolve(jh, JCplx(jnp.asarray(re), jnp.asarray(im)), jc, n, 2, jg,
                         solver=solver, me_form=form)
    ts = tsolver.mesolve(th, Cplx(torch.as_tensor(re), torch.as_tensor(im)), tc, n, 2, tg,
                         solver=solver, me_form=form)
    assert ts.re.dtype == (torch.float32 if dt is np.float32 else torch.float64)
    return np.asarray(js.re) + 1j * np.asarray(js.im), _np(ts), (th, tc, tg, re, im)


@pytest.mark.parametrize("n, kind, form", [
    (2, "ising", "superop"), (3, "ising", "dense"), (2, "ising", "factored"),
    (2, "xy", "superop"), (3, "xy", "dense"), (2, "xy", "factored"),
])
def test_me_forms_match_jax(n, kind, form):
    js, ts, _ = _mesolve_pair(n, kind, form)
    assert ts.shape == js.shape and ts.shape[0] > 10
    np.testing.assert_allclose(ts, js, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("kind", ["ising", "xy"])
def test_me_forms_agree(kind):
    jsim, _ = _emulators(3, kind, duration=40)
    _, th = _ham_pair(jsim)
    _, tc = _collapse_pair(jsim)
    _, tg = _grids(jsim)
    re, im = _rho(th.dim, seed=4)
    rho0 = Cplx(torch.as_tensor(re), torch.as_tensor(im))
    out = {f: _np(tsolver.mesolve(th, rho0, tc, 3, 2, tg, me_form=f))
           for f in ("superop", "dense", "factored")}
    np.testing.assert_allclose(out["dense"], out["superop"], rtol=0, atol=FORM_TOL)
    np.testing.assert_allclose(out["factored"], out["superop"], rtol=0, atol=FORM_TOL)
    legacy = _np(tsolver.mesolve(th, rho0, tc, 3, 2, tg, superop=False))
    np.testing.assert_array_equal(legacy, out["factored"])


class _Picked(Exception):
    pass


@pytest.mark.parametrize("n, superop, me_form", [
    (1, None, None), (2, None, None), (3, None, None), (3, True, None), (1, False, None),
    (1, None, "dense"), (3, False, "superop"),
])
def test_me_form_routing_matches_jax(monkeypatch, n, superop, me_form):
    """The form chosen for each dim and override, with the caps stubbed to
    2 (superop) and 4 (dense) so that 1-3 atoms cross both boundaries; the
    makers are stopped before any solve."""
    picked = {}

    def spy(pkg, name):
        def maker(*a, **k):
            picked[pkg] = name
            raise _Picked
        return maker

    for mod in (jsolver, tsolver):
        monkeypatch.setattr(mod, "_SUPEROP_DIM_CAP", 2)
        monkeypatch.setattr(mod, "_DENSE_ME_DIM_CAP", 4)
    monkeypatch.setattr(jsolver, "_make_me_step_superop", spy("jax", "superop"))
    monkeypatch.setattr(jsolver, "_make_me_step_dense", spy("jax", "dense"))
    monkeypatch.setattr(jsolver, "_make_me_step", spy("jax", "factored"))
    monkeypatch.setattr(tsolver, "_ME_FORMS", {f: spy("torch", f)
                                               for f in ("superop", "dense", "factored")})
    jsim, _ = _emulators(n, "ising", duration=20)
    jh, th = _ham_pair(jsim)
    jc, tc = _collapse_pair(jsim)
    jg, tg = _grids(jsim)
    re, im = _rho(th.dim, 0)
    with pytest.raises(_Picked):
        jsolver.mesolve(jh, JCplx(jnp.asarray(re), jnp.asarray(im)), jc, n, 2, jg,
                        superop=superop, me_form=me_form)
    with pytest.raises(_Picked):
        tsolver.mesolve(th, Cplx(torch.as_tensor(re), torch.as_tensor(im)), tc, n, 2, tg,
                        superop=superop, me_form=me_form)
    assert picked["torch"] == picked["jax"]


def test_me_form_caps_and_unknown_form():
    assert tsolver._SUPEROP_DIM_CAP == jsolver._SUPEROP_DIM_CAP == 8
    assert tsolver._DENSE_ME_DIM_CAP == jsolver._DENSE_ME_DIM_CAP == 2048
    assert [tsolver.me_form_for(d) for d in (8, 16, 2048, 4096)] == [
        "superop", "dense", "dense", "factored"]
    with pytest.raises(ValueError, match="me_form"):
        tsolver.me_form_for(8, me_form="sparse")


@pytest.mark.parametrize("form", ["superop", "dense", "factored"])
@pytest.mark.parametrize("dim, n_steps, dtype", [
    (8, 40, np.float64), (8, 400, np.float64), (32, 3000, np.float64), (256, 200, np.float32),
    (1024, 202, np.float64), (4096, 202, np.float64),
])
def test_me_auto_remat_matches_jax(form, dim, n_steps, dtype):
    """_me_auto_remat (what a stage materializes) on shapes of every kind,
    without allocating rho: a strided view of the right byte count."""
    a = np.broadcast_to(np.zeros(1, dtype), (dim, dim))
    jr = JCplx(a, a)
    tt = torch.float32 if dtype == np.float32 else torch.float64
    t = torch.zeros(1, dtype=tt).expand(dim, dim)
    want = jsolver._me_auto_remat(form, dim, jr, n_steps)
    assert tsolver._me_auto_remat(form, dim, Cplx(t, t), n_steps) == want


@pytest.mark.parametrize("form, opts", [("dense", dict(remat=True)),
                                         ("dense", dict(remat=False, n_segments=4)),
                                         ("factored", dict(remat=True, n_segments=3))])
def test_checkpointing_keeps_values_and_gradients(form, opts):
    jsim, _ = _emulators(2, "ising", duration=24)
    _, th = _ham_pair(jsim)
    _, tc = _collapse_pair(jsim)
    _, tg = _grids(jsim)
    re, im = _rho(th.dim, seed=3)

    def run(**kw):
        d = th.int_diag.clone().requires_grad_(True)
        ops = Cplx(tc.ops.re.clone().requires_grad_(True), tc.ops.im.clone())
        out = tsolver.mesolve(th._replace(int_diag=d), Cplx(torch.as_tensor(re),
                              torch.as_tensor(im)), tc._replace(ops=ops), 2, 2, tg,
                              me_form=form, **kw)
        (out.re[-1, 0, 0] + out.im[-2, 0, 1]).backward()
        return to_numpy(out.re), to_numpy(d.grad), to_numpy(ops.re.grad)

    ref = run(remat=False, n_segments=None)
    for got, want in zip(run(**opts), ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


# ----------------------------------------------------------------------
# f32
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n, kind, form", [(2, "ising", "superop"), (3, "xy", "dense")])
def test_f32_me_matches_jax_and_f64(n, kind, form):
    js, ts, _ = _mesolve_pair(n, kind, form, solver="DP5_ME_F32")
    np.testing.assert_allclose(ts, js, rtol=0, atol=F32_TOL)
    _, t64, _ = _mesolve_pair(n, kind, form, solver="DP5_ME")
    np.testing.assert_allclose(ts, t64, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("form", ["superop", "dense", "factored"])
def test_f32_me_products_are_pinned(monkeypatch, form):
    """Every f32 product of a DP5_ME_F32 value-and-gradient solve, forward
    and backward, runs with TF32 off for cuBLAS though the caller allowed
    it, and the caller's setting comes back; the states agree with the
    f64 form's."""
    m = torch.backends.cuda.matmul
    jsim, _ = _emulators(2, "xy", duration=30)
    _, th = _ham_pair(jsim)
    _, tc = _collapse_pair(jsim)
    _, tg = _grids(jsim)
    re, im = _rho(th.dim, seed=6)
    seen, real_einsum = [], torch.einsum

    def spied(real):
        # the products: @, and the mm / bmm that apply._matmul calls
        def product(a, b):
            if a.dtype == torch.float32:
                seen.append(m.allow_tf32)
            return real(a, b)
        return product

    def einsum(eq, *ops):
        if any(o.dtype == torch.float32 for o in ops):
            seen.append(m.allow_tf32)
        return real_einsum(eq, *ops)

    for owner, name in ((torch.Tensor, "__matmul__"), (torch, "mm"), (torch, "bmm")):
        monkeypatch.setattr(owner, name, spied(getattr(owner, name)))
    monkeypatch.setattr(torch, "einsum", einsum)
    prev = m.allow_tf32
    try:
        m.allow_tf32 = True
        d = th.int_diag.clone().requires_grad_(True)
        s = tsolver.mesolve(th._replace(int_diag=d), Cplx(torch.as_tensor(re),
                            torch.as_tensor(im)), tc, 2, 2, tg, solver="DP5_ME_F32",
                            me_form=form)
        n_fwd = len(seen)
        (s.re.double() ** 2).sum().backward()
        assert m.allow_tf32 is True
    finally:
        m.allow_tf32 = prev
    assert n_fwd > 0 and len(seen) > n_fwd and set(seen) == {False}
    assert bool(torch.isfinite(d.grad).all())
    s64 = tsolver.mesolve(th, Cplx(torch.as_tensor(re), torch.as_tensor(im)), tc, 2, 2, tg,
                          me_form=form)
    np.testing.assert_allclose(_np(s), _np(s64), rtol=0, atol=F32_TOL)


# ----------------------------------------------------------------------
# trace, entropy, expectation on rho
# ----------------------------------------------------------------------
def test_trace_entropy_expect_match_jax():
    rng = np.random.default_rng(8)
    rhos = [_rho(8, seed=s) for s in range(3)]
    re = np.stack([r for r, _ in rhos])
    im = np.stack([i for _, i in rhos])
    jr, tr = JCplx(jnp.asarray(re), jnp.asarray(im)), Cplx(torch.as_tensor(re),
                                                           torch.as_tensor(im))
    np.testing.assert_allclose(_np(tlinalg.trace(tr)), np.asarray(jlinalg.trace(jr).re)
                               + 1j * np.asarray(jlinalg.trace(jr).im), rtol=0, atol=F64_TOL)
    for k in range(3):
        np.testing.assert_allclose(to_numpy(tlinalg.vn_entropy(tr[k])),
                                   np.asarray(jlinalg.vn_entropy(jr[k])), rtol=0, atol=1e-10)
    pure = np.zeros((8, 8))
    pure[3, 3] = 1.0
    assert abs(float(tlinalg.vn_entropy(Cplx(torch.as_tensor(pure),
                                             torch.zeros(8, 8, dtype=torch.float64))))) < 1e-12
    obs = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    diag = rng.normal(size=8)
    batch = (np.stack([re, re[::-1]], -1), np.stack([im, im[::-1]], -1))  # (3, 8, 8, 2)
    cases = [(obs, (re, im)), (diag, (re, im)), (obs, batch), (diag, batch)]
    for o, (sr, si) in cases:
        jv = jlinalg.expect(jnp.asarray(o), JCplx(jnp.asarray(sr), jnp.asarray(si)))
        tv = tlinalg.expect(o, Cplx(torch.as_tensor(sr), torch.as_tensor(si)))
        np.testing.assert_allclose(_np(tv), np.asarray(jv.re) + 1j * np.asarray(jv.im), rtol=0,
                                   atol=F64_TOL)

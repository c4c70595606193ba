"""PyTorch port vs the JAX package: ``QuantumModel`` under stochastic noise
(doppler, amplitude, SPAM), and the adjoint kernels past 8 parts.

  - the model's value and gradient against JAX's from the same draws
    (each package's ``draw_noise`` replaced by one that returns seeded
    numpy draws), on the f64 stepper: 1e-12;
  - the draw rules of the JAX package, where a draw is a constant of the
    traced program: an eager call draws anew, ``fit`` trains on one
    realization (one a chunk length with ``steps_per_call``), the
    candidates of a population share one; ``fit`` and ``fit_population``
    against JAX's from the same draws (1e-9);
  - the routing of a noisy model's solve (K1/K2 at 12 atoms, 12 parts;
    K4/K5 at 16 atoms, 16 parts), decided before any launch;
  - K2's plain version at 20 and K5's at 12 and 20 synthetic parts a side
    against the Pallas adjoints in interpret mode (f32 roundoff); the caps
    are tests/test_torch_noise.py::test_part_caps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import hamiltonian as jham
from pulser_diff_tpu import simconfig as jsc
from pulser_diff_tpu.model import QuantumModel as JModel
from pulser_diff_tpu.ops import pallas_evolution as jpe
from pulser_diff_torch import QuantumModel, backend
from pulser_diff_torch import hamiltonian as tham
from pulser_diff_torch import simconfig as tsc
from pulser_diff_torch.ops import fused_evolution as tfe

from tests.test_torch_fused import K2_REL_TOL, _max_rel, _same_inputs, _setup
from tests.test_torch_noisy_mc import _widen
from tests.torch_port_cases import to_numpy

torch.set_num_threads(1)

F64_TOL = 1e-12
FIT_TOL = 1e-9
NOISES = {
    "doppler": dict(noise=("doppler",), temperature=80.0),
    "amplitude": dict(noise=("amplitude",), amp_sigma=0.1),
    "doppler-amplitude-SPAM": dict(noise=("doppler", "amplitude", "SPAM"), eta=0.2,
                                   temperature=80.0, amp_sigma=0.1),
}


def _sequence(core, n_atoms: int = 3, duration: int = 24):
    reg = core.Register.from_coordinates([(5.0 * i, 1.5 * (i % 2)) for i in range(n_atoms)],
                                         prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega = seq.declare_variable("omega")
    det = seq.declare_variable("det")
    seq.add(core.Pulse.ConstantPulse(duration, omega, det, 0.0), "ryd")
    seq.add(core.Pulse.ConstantPulse(duration // 2, 1.3, -0.4, 0.2), "ryd")
    return seq


def _fixed_draws(seed: int):
    """A draw_noise for each package that returns the same seeded numpy
    draws at every call, for the configuration's noise types."""

    def values(cfg, n, n_slots):
        rng = np.random.default_rng(seed)
        types = set(cfg.noise_types)
        bad = (np.arange(n) == 1).astype(float) if "SPAM" in types else np.zeros(n)
        dop = 0.9 * rng.normal(size=n) if "doppler" in types else np.zeros(n)
        amp = (np.clip(1.0 + 0.1 * rng.normal(size=max(n_slots, 1)), 0, None)
               if "amplitude" in types else np.ones(max(n_slots, 1)))
        return bad, dop, amp

    def jdraw(key, cfg, n, n_slots):
        return jham.NoiseDraws(*(jnp.asarray(x) for x in values(cfg, n, n_slots)))

    def tdraw(gen, cfg, n, n_slots):
        return tham.NoiseDraws(*(torch.as_tensor(x, dtype=torch.float64, device=gen.device)
                                 for x in values(cfg, n, n_slots)))

    return jdraw, tdraw


def _pair(monkeypatch, noise: str, seed: int = 3, **kw):
    """The model in both packages, each drawing the same fixed draws."""
    jdraw, tdraw = _fixed_draws(seed)
    monkeypatch.setattr(jham, "draw_noise", jdraw)
    monkeypatch.setattr(tham, "draw_noise", tdraw)
    jm = JModel(_sequence(jcore), {"omega": jnp.asarray(1.2), "det": jnp.asarray(-0.3)},
                noise_config=jsc.SimConfig(**NOISES[noise]), sampling_rate=0.5, **kw)
    tm = QuantumModel(_sequence(tcore), {"omega": 1.2, "det": -0.3},
                      noise_config=tsc.SimConfig(**NOISES[noise]), sampling_rate=0.5,
                      device="cpu", **kw)
    return jm, tm


def _loss(vals):
    return (vals[-1] + 0.5) ** 2


@pytest.mark.parametrize("noise", list(NOISES))
def test_value_and_gradient_match_jax(monkeypatch, noise):
    jm, tm = _pair(monkeypatch, noise, substeps=1)
    jv, jg = jax.value_and_grad(lambda p: _loss(jm.expectation_fn()(p)[1]))(jm.params)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tm.params.items()}
    tv = _loss(tm.expectation_fn()(params)[1])
    tv.backward()
    assert abs(float(tv) - float(jv)) < F64_TOL
    for k in ("omega", "det"):
        assert abs(float(params[k].grad) - float(jg[k])) < F64_TOL, k
    # the realization is all local: one amplitude and one detuning stream a
    # qubit, 2 ceil(n / 2) parts a side
    h = tm._make_emulator(dict(tm.params))._hamiltonian._ham_data
    if "doppler" in noise:
        assert (h.row_parts.shape[0], h.col_parts.shape[0]) == (2, 4)


def test_eager_calls_draw_anew_and_fit_pins_one(monkeypatch):
    """Two eager calls see two realizations; fit trains every epoch on one
    (the losses of a hand loop on that draw), and with steps_per_call one
    a chunk length."""
    tm = QuantumModel(_sequence(tcore), {"omega": 1.2, "det": -0.3},
                      noise_config=tsc.SimConfig(**NOISES["doppler"]), sampling_rate=0.5,
                      substeps=1, device="cpu")
    fn = tm.expectation_fn()
    with torch.no_grad():
        a, b = fn(dict(tm.params))[1], fn(dict(tm.params))[1]
    assert not torch.equal(a, b)
    seen = []
    update = tham.Hamiltonian._update_noise

    def spy(self):  # the stochastic draws (a noiseless build draws zeros)
        draws = update(self)
        if self._config.noise_types:
            seen.append(draws)
        return draws

    monkeypatch.setattr(tham.Hamiltonian, "_update_noise", spy)
    start = {k: v.detach().clone() for k, v in tm.params.items()}
    losses = tm.fit(lambda t, v: _loss(v), epochs=3)
    assert len(seen) == 1
    # the hand loop on the same realization
    hand = QuantumModel(_sequence(tcore), start, noise_config=tsc.SimConfig(**NOISES["doppler"]),
                        sampling_rate=0.5, substeps=1, device="cpu")
    opt = torch.optim.Adam(hand.parameters(), lr=1e-2)
    want = []
    with hand._pinned(seen[0]):
        for _ in range(3):
            opt.zero_grad()
            loss = _loss(hand.expectation_fn()(dict(hand.params))[1])
            loss.backward()
            opt.step()
            want.append(float(loss.detach()))
    assert losses == want
    seen.clear()
    tm.fit(lambda t, v: _loss(v), epochs=5, steps_per_call=2)
    assert len(seen) == 2  # chunks of 2, 2 and 1 steps: two lengths
    seen.clear()
    QuantumModel(_sequence(tcore), start, sampling_rate=0.5, device="cpu").fit(
        lambda t, v: _loss(v), epochs=2)
    assert not seen  # nothing drawn without stochastic noise


def test_population_shares_one_realization_and_matches_jax(monkeypatch):
    """Candidates equal in value give equal values (one realization); the
    population's values, and fit_population's losses, final stack and
    loaded best, against JAX's from the same draws."""
    tm = QuantumModel(_sequence(tcore), {"omega": 1.2, "det": -0.3},
                      noise_config=tsc.SimConfig(**NOISES["doppler"]), sampling_rate=0.5,
                      substeps=1, device="cpu")
    with torch.no_grad():
        _, v = tm.expectation_population_fn()({"omega": torch.tensor([1.2, 1.2], dtype=torch.float64),
                                               "det": torch.tensor([-0.3, -0.3], dtype=torch.float64)})
    assert torch.equal(v[0], v[1])
    jm, tm = _pair(monkeypatch, "doppler-amplitude-SPAM", substeps=1)
    stack = {"omega": np.array([0.9, 1.4]), "det": np.array([0.1, -0.5])}
    _, jv = jm.expectation_population_fn()({k: jnp.asarray(x) for k, x in stack.items()})
    with torch.no_grad():
        _, tv = tm.expectation_population_fn()({k: torch.as_tensor(x) for k, x in stack.items()})
    np.testing.assert_allclose(to_numpy(tv), np.asarray(jv), rtol=0, atol=F64_TOL)
    jl, jfin = jm.fit_population(lambda t, x: _loss(x), {k: jnp.asarray(x) for k, x in stack.items()},
                                 epochs=3, optimizer=optax.adam(5e-2))
    tl, tfin = tm.fit_population(lambda t, x: _loss(x), stack, epochs=3,
                                 optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-2))
    np.testing.assert_allclose(np.stack(tl), np.stack([np.asarray(x) for x in jl]), rtol=0,
                               atol=FIT_TOL)
    for k in stack:
        np.testing.assert_allclose(to_numpy(tfin[k]), np.asarray(jfin[k]), rtol=0, atol=FIT_TOL)
        np.testing.assert_allclose(to_numpy(tm.params[k]), np.asarray(jm.params[k]), rtol=0,
                                   atol=FIT_TOL)


def test_fit_matches_jax_on_one_realization(monkeypatch):
    jm, tm = _pair(monkeypatch, "doppler-amplitude-SPAM", substeps=1)
    jl = jm.fit(lambda t, v: _loss(v), epochs=4, optimizer=optax.adam(5e-2))
    tl = tm.fit(lambda t, v: _loss(v), epochs=4,
                optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-2))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FIT_TOL)
    for k in ("omega", "det"):
        assert abs(float(tm.params[k].detach()) - float(jm.params[k])) < FIT_TOL, k


class _Routed(Exception):
    pass


@pytest.mark.parametrize("n_atoms, parts, ckpt", [(12, 12, False), (16, 16, True)],
                         ids=["12-atoms-K1K2", "16-atoms-K4K5"])
def test_noisy_model_routes_to_the_fused_kernels(monkeypatch, n_atoms, parts, ckpt):
    """The noisy model's fused solve (DP5_PALLAS here; DP5_SE on CUDA) takes
    K1/K2 at 12 atoms with 12 parts a side and K4/K5 at 16 atoms with 16,
    decided before any launch."""
    seen = {}

    def stub(ham, psi0, grid, method="DP5", ckpt=False):
        seen.update(parts=(int(ham.row_parts.shape[0]), int(ham.col_parts.shape[0])), ckpt=ckpt)
        raise _Routed

    monkeypatch.setattr(backend, "evolve_states", stub)
    seq = tcore.Sequence(tcore.Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n_atoms)], prefix="q"), tcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega = seq.declare_variable("omega")
    seq.add(tcore.Pulse.ConstantPulse(20, omega, -2.0, 0.0), "ryd")
    tm = QuantumModel(seq, {"omega": 1.0}, solver="DP5_PALLAS", sampling_rate=0.25,
                      noise_config=tsc.SimConfig(noise=("doppler", "amplitude"), amp_sigma=0.1),
                      substeps=1, device="cpu")
    with pytest.raises(_Routed):
        tm.expectation_fn()(dict(tm.params))
    assert seen == {"parts": (parts, parts), "ckpt": ckpt}


def _cut(jdata: dict, n_steps: int) -> dict:
    """The inputs of the first ``n_steps`` steps."""
    out = dict(jdata)
    for k in tfe._ZF_KEYS + tfe._ZB_KEYS:
        out[k] = out[k][:, :n_steps]
    for k in ("hb_hi", "hb_lo", "hs"):
        out[k] = out[k][:n_steps]
    return out


@pytest.mark.parametrize("kernel, P", [("K2", 20), ("K5", 12), ("K5", 20)])
def test_wide_part_adjoints_match_the_pallas_kernels(kernel, P):
    """pr = pc = P (two or three chunks of at most 8) through K2's or K5's
    plain version against the Pallas adjoint (interpret mode), 3 steps of
    the 2-atom DP5 case: lam0, every stream cotangent and dbar.  (K2 at 12
    parts: tests/test_torch_noisy_mc.py, through evolve_mc's gradient.)"""
    jdata, _, _, _ = _setup(2, 1, "DP5", "Minimal", 1)
    wide = _cut(_widen(jdata, P, seed=P), 3)
    slots, n_eval = (0, 2, 2, 1), 2
    jw = {k: jnp.asarray(v) for k, v in wide.items()}
    tw = _same_inputs(wide)
    if kernel == "K5":
        (j_re, j_im), vjp = jax.vjp(lambda d: jpe.fused_evolve_ckpt("DP5", True, d), jw)
    else:
        (j_re, j_im), vjp = jax.vjp(
            lambda d: jpe.fused_evolve_states("DP5", True, slots, n_eval, slots[-1], d), jw)
    rng = np.random.default_rng(P)
    lam = [rng.normal(size=j_re.shape).astype(np.float32) for _ in range(2)]
    (jcot,) = vjp(tuple(jnp.asarray(x) for x in lam))
    st = (torch.tensor(np.asarray(j_re)), torch.tensor(np.asarray(j_im)))
    lam_t = [torch.tensor(x) for x in lam]
    if kernel == "K5":
        lam0_re, lam0_im, zbar, dbar = tfe.fused_bwd_ckpt(tw, "DP5", *st, *lam_t)
    else:
        lam0_re, lam0_im, zbar, dbar = tfe.fused_bwd(
            tw, "DP5", torch.tensor(slots, dtype=torch.int32), n_eval, slots[-1], *st, *lam_t)
    zrr, zri, zcr, zci = tfe._unpack_zbar(zbar, P, P)
    pairs = {"psi_re": lam0_re, "psi_im": lam0_im, "diag": dbar,
             "zrh_re": zrr, "zrh_im": zri, "zch_re": zcr, "zch_im": zci}
    for k, got in pairs.items():
        assert tuple(got.shape) == np.asarray(jcot[k]).shape, k
        assert _max_rel(got, jcot[k]) < K2_REL_TOL, (k, _max_rel(got, jcot[k]))

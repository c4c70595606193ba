"""PyTorch port vs the JAX package: the noise configuration and the noisy
Hamiltonian (pulser_diff_torch.simconfig, the per-qubit samples of
core/sampler.py, hamiltonian.draw_noise / build_data / build_batch), and
the routing of run()'s noisy batch (TorchEmulator._route_noisy), decided
before any launch.

torch's generators cannot reproduce jax.random's streams, so the parity
tests hand the same draws (numpy) to both packages and compare the built
arrays; the port's own draws are held to their distributions.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pulser_diff_tpu.core as jcore
import pulser_diff_torch.core as tcore
from pulser_diff_tpu import simconfig as jsc
from pulser_diff_tpu.backend import TpuEmulator
from pulser_diff_tpu.hamiltonian import NoiseDraws as JDraws
from pulser_diff_tpu.hamiltonian import draw_noise as jdraw_noise
from pulser_diff_torch import QuantumModel, TorchEmulator
from pulser_diff_torch import simconfig as tsc
from pulser_diff_torch.hamiltonian import NoiseDraws as TDraws
from pulser_diff_torch.hamiltonian import draw_noise
from pulser_diff_torch.ops import fused_evolution as tfe

from tests.torch_port_cases import (
    emulators, factored_fields, kron_fields, pulse_samples, to_numpy, xy_emulators,
)

torch.set_num_threads(1)

F64_TOL = 1e-12


def _two_pulse_sequence(core, n_atoms: int, det0: float = -1.0):
    """Two rydberg_global pulses (two noise slots), the second ending at
    the sequence's end; ``det0 = 0`` gives an all-zero detuning."""
    amp, det = pulse_samples(60, 3)
    reg = core.Register.from_coordinates(
        [(6.0 * (i % 2), 6.0 * (i // 2)) for i in range(n_atoms)], prefix="q")
    seq = core.Sequence(reg, core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse(core.CustomWaveform(amp), core.ConstantWaveform(60, det0), 0.4), "ryd")
    seq.add(core.Pulse(core.CustomWaveform(amp[::-1].copy()), core.CustomWaveform(
        0.0 * det if det0 == 0 else det), 0.1), "ryd")
    return seq


def _pair(n_atoms: int, det0: float = -1.0):
    jsim = TpuEmulator.from_sequence(_two_pulse_sequence(jcore, n_atoms, det0), sampling_rate=0.5,
                                     evaluation_times="Minimal")
    tsim = TorchEmulator.from_sequence(_two_pulse_sequence(tcore, n_atoms, det0),
                                       sampling_rate=0.5, evaluation_times="Minimal",
                                       device="cpu")
    return jsim, tsim


def _draws(n: int, n_slots: int, seed: int, bad=None):
    """The same draws for both packages."""
    rng = np.random.default_rng(seed)
    bad = np.zeros(n) if bad is None else np.asarray(bad, dtype=np.float64)
    dop = 0.8 * rng.normal(size=n)
    amp = np.clip(1.0 + 0.1 * rng.normal(size=max(n_slots, 1)), 0, None)
    j = JDraws(jnp.asarray(bad), jnp.asarray(dop), jnp.asarray(amp))
    t = TDraws(*(torch.as_tensor(x, dtype=torch.float64) for x in (bad, dop, amp)))
    return j, t


def _assert_same_ham(jh, th, kron: bool = False):
    jf, tf = factored_fields(jh), factored_fields(th)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=F64_TOL, err_msg=k)
    if kron:
        jk, tk = kron_fields(jh), kron_fields(th)
        for k in jk:
            np.testing.assert_allclose(tk[k], jk[k], rtol=0, atol=F64_TOL, err_msg=k)


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cls", ["SimConfig", "NoiseModel"])
def test_config_fields_and_defaults_match_jax(cls):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jsc, cls))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tsc, cls))}
    assert tf == jf
    assert tsc.SUPPORTED_NOISES == jsc.SUPPORTED_NOISES
    assert tsc.NOISE_TYPES == jsc.NOISE_TYPES
    assert (tsc.KB, tsc.KEFF, tsc.MASS) == (jsc.KB, jsc.KEFF, jsc.MASS)


@pytest.mark.parametrize("kwargs", [
    dict(noise=("doppler", "amplitude"), temperature=30.0, amp_sigma=0.1),
    dict(noise=("SPAM",), eta=0.2, epsilon=0.03),
    dict(noise=("SPAM",), eta=0.0),
    dict(noise=("amplitude",), amp_sigma=0.0, laser_waist=float("inf")),
    dict(noise=("dephasing", "relaxation"), dephasing_rate=0.2),
    dict(noise="doppler"),
], ids=["doppler-amplitude", "spam", "spam-eta0", "amplitude-nowaist", "lindblad", "str"])
def test_noise_model_conversions_match_jax(kwargs):
    jc, tc = jsc.SimConfig(**kwargs), tsc.SimConfig(**kwargs)
    jn, tn = jc.to_noise_model(), tc.to_noise_model()
    assert dataclasses.asdict(tn) == dataclasses.asdict(jn)
    assert dataclasses.asdict(tsc.SimConfig.from_noise_model(tn)) == dataclasses.asdict(
        jsc.SimConfig.from_noise_model(jn))
    assert str(tc) == str(jc) and tc.spam_dict == jc.spam_dict


def test_doppler_sigma_matches_jax():
    for t in (1e-6, 50e-6, 3e-3):
        assert abs(tsc.doppler_sigma(t) - float(jsc.doppler_sigma(t))) < F64_TOL
        got = tsc.doppler_sigma(torch.tensor(t, dtype=torch.float64))
        assert abs(float(got) - float(jsc.doppler_sigma(t))) < F64_TOL


def test_config_errors_match_jax():
    for pkg in (jsc, tsc):
        with pytest.raises(ValueError, match="Unknown noise types"):
            pkg.SimConfig(noise=("thermal",))
        with pytest.raises(ValueError, match="effective noise operator"):
            pkg.NoiseModel(noise_types=("leakage",))
    jsim, tsim = xy_emulators(2, duration=40)
    for sim, pkg in ((jsim, jsc), (tsim, tsc)):
        with pytest.raises(NotImplementedError, match="does not support"):
            sim.set_config(pkg.SimConfig(noise=("doppler",)))
        with pytest.raises(ValueError, match="not a valid"):
            sim.set_config(pkg.SimConfig().to_noise_model())


def test_add_and_reset_config_match_jax():
    jsim, tsim = emulators(2, duration=40)
    for sim, pkg in ((jsim, jsc), (tsim, tsc)):
        sim.set_config(pkg.SimConfig(noise=("SPAM",), eta=0.1, runs=7))
        sim.add_config(pkg.SimConfig(noise=("doppler",), temperature=20.0, runs=3))
    jc, tc = jsim.config, tsim.config
    assert set(tc.noise) == set(jc.noise) == {"SPAM", "doppler"}
    assert dataclasses.asdict(dataclasses.replace(tc, noise=())) == dataclasses.asdict(
        dataclasses.replace(jc, noise=()))
    jsim.reset_config()
    tsim.reset_config()
    assert dataclasses.asdict(tsim.config) == dataclasses.asdict(jsim.config)
    assert tsim.config.noise == ()


# ----------------------------------------------------------------------
# samples and Hamiltonians
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_atoms", [3, 11])
def test_all_local_nested_dict_matches_jax(n_atoms):
    """The per-qubit scatter, in the order of the qubit ids as strings
    (q10 before q2 at 11 atoms), array for array."""
    jsim, tsim = _pair(n_atoms)
    jd = jsim.samples_obj.to_nested_dict(all_local=True)
    td = tsim.samples_obj.to_nested_dict(all_local=True)
    assert td["Global"] == {} and list(jd["Local"]) == list(td["Local"])
    for basis, jq in jd["Local"].items():
        assert list(td["Local"][basis]) == list(jq)
        for qid, qty in jq.items():
            for k in ("amp", "det", "phase"):
                np.testing.assert_allclose(to_numpy(td["Local"][basis][qid][k]),
                                           np.asarray(qty[k]), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("kwargs, bad", [
    (dict(noise=("doppler",)), None),
    (dict(noise=("amplitude",), amp_sigma=0.05), None),
    (dict(noise=("amplitude",), amp_sigma=0.05, laser_waist=float("inf")), None),
    (dict(noise=("doppler", "amplitude", "SPAM"), eta=0.3), [0, 1, 0]),
    (dict(noise=("SPAM",), eta=0.3), [1, 0, 0]),
], ids=["doppler", "amplitude-waist", "amplitude-nowaist", "all-bad-atom", "spam"])
def test_noisy_build_data_matches_jax(kwargs, bad):
    """JAX's draws through both packages' build_data: the parts, streams
    and interaction diagonal (a bad atom's streams zeroed, its terms
    dropped, its interactions off)."""
    jsim, tsim = _pair(3)
    jsim.set_config(jsc.SimConfig(**kwargs))
    tsim.set_config(tsc.SimConfig(**kwargs))
    jd, td = _draws(3, jsim._hamiltonian._count_noise_slots(), seed=7, bad=bad)
    _assert_same_ham(jsim._hamiltonian.build_data(jd), tsim._hamiltonian.build_data(td))


def test_xy_with_spam_bad_atom_matches_jax():
    jsim, tsim = xy_emulators(3, duration=60, field=(1.0, 1.0, 0.0))
    for sim, pkg in ((jsim, jsc), (tsim, tsc)):
        sim.set_config(pkg.SimConfig(noise=("SPAM",), eta=0.4))
    jd, td = _draws(3, 1, seed=5, bad=[0, 0, 1])
    _assert_same_ham(jsim._hamiltonian.build_data(jd), tsim._hamiltonian.build_data(td),
                     kron=True)


@pytest.mark.parametrize("kind", ["spam", "stochastic"])
def test_batch_build_keeps_the_vmapped_term_structure(kind):
    """A SPAM batch in which one run has a bad atom, on a sequence with
    an all-zero detuning: JAX's jax.vmap of the build keeps every traced
    term (the zero detunings too, and the bad atom's zeroed streams); so
    do the port's runs, all on one part stack equal to JAX's.  The
    stochastic batch of JAX's own key draws: run for run equal."""
    det0 = 0.0 if kind == "spam" else -1.0
    jsim, tsim = _pair(3, det0)
    if kind == "spam":
        kwargs = dict(noise=("SPAM",), eta=0.3)
        bad = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        n_slots = jsim._hamiltonian._count_noise_slots()
        jdr = jax.vmap(lambda b: JDraws(b, jnp.zeros(3), jnp.ones(n_slots)))(jnp.asarray(bad))
        varying = frozenset({"bad_atoms"})
    else:
        kwargs = dict(noise=("doppler", "amplitude"), amp_sigma=0.1)
        varying = frozenset({"doppler", "amp_factors"})
    jsim.set_config(jsc.SimConfig(**kwargs))
    tsim.set_config(tsc.SimConfig(**kwargs))
    jh = jsim._hamiltonian
    if kind == "stochastic":
        keys = jax.random.split(jax.random.PRNGKey(3), 3)
        jdr = jax.vmap(lambda k: jdraw_noise(k, jh.config, 3, jh._count_noise_slots()))(keys)
    jb = jax.vmap(jh.build_data)(jdr)
    R = int(np.asarray(jdr.bad_atoms).shape[0])
    tdraws = [TDraws(*(torch.as_tensor(np.array(x)[r]) for x in jdr)) for r in range(R)]
    tb = tsim._hamiltonian.build_batch(tdraws, varying)
    jf = factored_fields(jb._replace(sample_dt=jb.sample_dt[0], n_samples=jb.n_samples[0]))
    for r, th in enumerate(tb):
        tf = factored_fields(th)
        for k in ("row_parts", "col_parts"):
            assert tf[k].shape == jf[k].shape[1:], k
            np.testing.assert_array_equal(tf[k], jf[k][r], err_msg=k)
            assert th.row_parts is tb[0].row_parts and th.col_parts is tb[0].col_parts
        for k in ("row_streams_re", "row_streams_im", "col_streams_re", "col_streams_im",
                  "int_diag"):
            np.testing.assert_allclose(tf[k], jf[k][r], rtol=0, atol=F64_TOL, err_msg=k)
    if kind == "spam":
        # the eager single-run build drops the bad atom's and the zero
        # detuning's terms: the batch must not
        alone = tsim._hamiltonian.build_data(tdraws[1])
        assert alone.row_parts.shape[0] < tb[1].row_parts.shape[0]


def test_draw_noise_distributions():
    """The port's draws (its own stream): bad atoms at rate eta, Doppler
    shifts with the JAX package's sigma, amplitude factors clipped at 0."""
    cfg = tsc.SimConfig(noise=("SPAM", "doppler", "amplitude"), eta=0.2, temperature=50.0,
                        amp_sigma=0.5).to_noise_model()
    gen = torch.Generator().manual_seed(0)
    d = [draw_noise(gen, cfg, 50, 40) for _ in range(40)]
    bad = torch.stack([x.bad_atoms for x in d])
    dop = torch.stack([x.doppler for x in d])
    amp = torch.stack([x.amp_factors for x in d])
    n = bad.numel()
    assert abs(float(bad.mean()) - 0.2) < 5 * math.sqrt(0.2 * 0.8 / n)
    sigma = float(jsc.doppler_sigma(50e-6))
    assert abs(float(dop.std()) / sigma - 1) < 0.05 and abs(float(dop.mean())) < 5 * sigma / n**0.5
    assert float(amp.min()) == 0.0 and abs(float((amp > 0).float().mean()) - 0.977) < 0.02
    # no noise: the noiseless draws
    z = draw_noise(gen, tsc.SimConfig().to_noise_model(), 3, 2)
    assert not z.bad_atoms.any() and not z.doppler.any() and bool((z.amp_factors == 1).all())


# ----------------------------------------------------------------------
# routing of the noisy batch (no launch), and the part caps
# ----------------------------------------------------------------------
def _lattice_emulator(n_atoms: int) -> TorchEmulator:
    reg = tcore.Register.from_coordinates(
        [(10.0 * (i % 4), 10.0 * (i // 4)) for i in range(n_atoms)], prefix="q")
    seq = tcore.Sequence(reg, tcore.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(tcore.Pulse(tcore.ConstantWaveform(20, 1.0), tcore.ConstantWaveform(20, -2.0), 0.0),
            "ryd")
    return TorchEmulator.from_sequence(seq, sampling_rate=0.25, evaluation_times="Minimal",
                                       device="cpu")


@pytest.mark.parametrize("n_atoms, opts, route", [
    (12, {}, ("DP5_PALLAS", "K1")),
    (14, {}, ("DP5_PALLAS", "K4")),
    (16, {}, ("DP5_PALLAS", "K4")),
    (18, {}, ("DP5_PALLAS", "K4")),
    (12, {"ckpt": True}, ("DP5_PALLAS", "K4")),
    (12, {"fused": False}, ("DP5_SE", None)),
    (18, {"fused": False}, ("DP5_SE", None)),
    (19, {}, ("DP5_SE_F32", None)),
    (19, {"fused": True}, ("DP5_SE_F32", None)),
], ids=["12-K1", "14-K4", "16-K4", "18-K4", "12-ckpt-K4", "12-f64", "18-f64", "19-f32",
        "19-fused-f32"])
def test_noisy_route_on_cuda(monkeypatch, n_atoms, opts, route):
    """On a (stubbed) CUDA emulator the batch of all-local parts (pr = pc =
    2 ceil(n / 2)) takes one forward launch below 2^19: K1 where its
    cluster holds the shape, K4 from 14 atoms; from 2^19 the f32 stepper
    (fused=True does not force the kernels there, as in the JAX package);
    fused=False the f64 stepper."""
    sim = _lattice_emulator(n_atoms)
    monkeypatch.setattr(sim, "torch_device", torch.device("cuda"))
    p = 2 * math.ceil(n_atoms / 2)
    assert sim._route_noisy("DP5_SE", opts, p, p) == route


def test_noisy_route_on_cpu_and_refusals(monkeypatch):
    sim = _lattice_emulator(12)
    assert sim._route_noisy("DP5_SE", {}, 12, 12) == ("DP5_SE", None)
    assert sim._route_noisy("DP5_PALLAS", {}, 12, 12) == ("DP5_PALLAS", "K1")
    assert sim._route_noisy("RK4_PALLAS", {"ckpt": True}, 12, 12) == ("RK4_PALLAS", "K4")
    with pytest.raises(ValueError, match="at most 32"):
        sim._route_noisy("DP5_PALLAS", {}, 34, 2)
    monkeypatch.setattr(sim, "torch_device", torch.device("cuda"))
    with pytest.raises(ValueError, match="ckpt=True"):
        _lattice_emulator(14)._route_noisy("DP5_PALLAS", {"ckpt": False}, 14, 14)


def test_part_caps():
    """Every fused kernel, forward and adjoint, takes up to 32 parts a side
    (a per-qubit build has 2 ceil(n / 2)); 33 is refused on the host,
    naming the cap.  K2's cluster holds the 12-atom noisy shape (12 parts
    a side, one state)."""
    assert tfe.parts_fit(32, 32) and not tfe.parts_fit(33, 2) and not tfe.parts_fit(2, 33)
    with pytest.raises(ValueError, match="at most 32"):
        tfe.check_parts(2, 33)
    tfe.check_parts(18, 18)
    assert tfe.cluster_fits(True, 1, 64, 64, 12, 12, 0, 6)


def test_lindblad_and_model_noise_raise():
    jsim, tsim = emulators(2, duration=40)
    tsim.set_config(tsc.SimConfig(noise=("dephasing", "SPAM")))
    # the Lindblad noises run on the master equation (with the default SPAM
    # eta > 0, one mesolve per bad-atom configuration)
    res = tsim.run()
    assert type(res).__name__ == "NoisyResults"
    assert {sum(r.bitstring_counts.values()) for r in res} == {15 * 5}
    # a model with stochastic noise only builds one drawn realization, all
    # local (one amplitude and one detuning stream a qubit)
    model = QuantumModel(_two_pulse_sequence(tcore, 2), noise_config=tsc.SimConfig(
        noise=("doppler",)), sampling_rate=0.5, device="cpu")
    ham = model._make_emulator(dict(model.params))._hamiltonian
    assert (ham._ham_data.row_parts.shape[0], ham._ham_data.col_parts.shape[0]) == (2, 2)
    assert bool((ham.draws.doppler != 0).all())
    assert torch.isfinite(model.expectation_fn()(dict(model.params))[1]).all()
    # leakage extends the basis by the dark level: three levels a site
    tsim.set_config(tsc.SimConfig(noise=("eff_noise",), with_leakage=True,
                                  eff_noise_rates=(0.1,), eff_noise_opers=(np.eye(3),)))
    assert (tsim.dim, tsim._hamiltonian._basis_labels) == (3, ["r", "g", "x"])
    assert tuple(tsim._hamiltonian._ham_data.int_diag.shape) == (3, 3)

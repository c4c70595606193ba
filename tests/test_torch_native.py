"""The port's binding of the native host-side sampler (pulser_diff_torch/native.py)
against the JAX package's (pulser_diff_tpu/native.py), numpy and scipy, as
tests/test_native.py holds the JAX package's, and against the port's torch
waveforms."""

import os

import numpy as np
import pytest

from pulser_diff_tpu import native as jnative
from pulser_diff_torch import native


def _cases():
    x = np.array([0.0, 10.0, 30.0, 55.0, 99.0])
    y = np.array([0.0, 3.0, -1.0, 2.0, 0.0])
    ti, tf = np.array([10, 50]), np.array([20, 60])
    seg = (np.concatenate([np.full(10, 2.0), np.full(10, 3.0)]),
           np.concatenate([np.full(10, -1.0), np.full(10, 1.0)]), np.array([0.5, 0.7]))
    return {
        "blackman": ((237, np.pi), {}),
        "kaiser": ((200, 1.3), {"beta": 9.0}),
        "ramp": ((101, -1.0, 1.0), {}),
        "pchip": ((x, y, np.linspace(0, 99, 500)), {}),
        "assemble_channel": ((70, ti, tf, *seg), {}),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_equals_the_jax_packages_binding(name):
    """Both build the same source with the same flags: equal bit for bit."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    args, kw = _cases()[name]
    got, want = getattr(native, name)(*args, **kw), getattr(jnative, name)(*args, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_windows_and_ramp_match_numpy():
    """tests/test_native.py's bars: Blackman 1e-10 and its area, Kaiser
    1e-9, the ramp np.linspace's."""
    n, area = 237, np.pi
    w = np.clip(np.blackman(n), 0, None)
    mine = native.blackman(n, area)
    assert np.abs(mine - w * area / (w.sum() * 1e-3)).max() < 1e-10
    assert mine.sum() * 1e-3 == pytest.approx(area)
    w = np.kaiser(200, 14.6)
    assert np.abs(native.kaiser(200, 1.3) - w * 1.3 / (w.sum() * 1e-3)).max() < 1e-9
    assert np.allclose(native.ramp(101, -1.0, 1.0), np.linspace(-1, 1, 101))


def test_pchip_matches_scipy_and_the_ports_interpolation():
    """scipy's PchipInterpolator at 1e-12, and the port's torch
    pchip_interpolate (which the port's waveforms sample with) at 1e-12."""
    import torch
    from scipy.interpolate import PchipInterpolator

    from pulser_diff_torch.core.waveforms import pchip_interpolate

    x = np.array([0.0, 10.0, 30.0, 55.0, 99.0])
    y = np.array([0.0, 3.0, -1.0, 2.0, 0.0])
    t = np.linspace(0, 99, 500)
    mine = native.pchip(x, y, t)
    assert np.abs(mine - PchipInterpolator(x, y)(t)).max() < 1e-12
    ported = pchip_interpolate(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(t))
    assert np.abs(mine - ported.numpy()).max() < 1e-12


def test_windows_match_the_ports_waveforms():
    """The torch samples of BlackmanWaveform / KaiserWaveform / RampWaveform
    (the port's sampling path) against the binding at 1e-12."""
    import pulser_diff_torch.core as tcore

    for wf, ref in (
        (tcore.BlackmanWaveform(237, np.pi), native.blackman(237, np.pi)),
        (tcore.KaiserWaveform(200, 1.3), native.kaiser(200, 1.3)),
        (tcore.RampWaveform(101, -1.0, 1.0), native.ramp(101, -1.0, 1.0)),
    ):
        np.testing.assert_allclose(wf.samples.detach().cpu().numpy(), ref, rtol=0, atol=1e-12)


def test_assemble_channel():
    """tests/test_native.py's segments: samples placed, the phase filled
    forward; mismatched segments refused before any pointer is passed."""
    ti, tf = np.array([10, 50]), np.array([20, 60])
    seg_amp = np.concatenate([np.full(10, 2.0), np.full(10, 3.0)])
    seg_det = np.concatenate([np.full(10, -1.0), np.full(10, 1.0)])
    amp, det, phase = native.assemble_channel(70, ti, tf, seg_amp, seg_det, np.array([0.5, 0.7]))
    assert (amp[:10] == 0).all() and (amp[10:20] == 2.0).all()
    assert (amp[50:60] == 3.0).all() and (amp[60:] == 0).all()
    assert (det[10:20] == -1.0).all() and (det[50:60] == 1.0).all()
    assert (phase[10:20] == 0.5).all() and (phase[20:50] == 0.5).all()
    assert (phase[50:] == 0.7).all()
    with pytest.raises(ValueError):
        native.assemble_channel(70, ti, tf, seg_amp[:15], seg_det, np.array([0.5, 0.7]))


def test_builds_into_build_dir_not_native(monkeypatch, tmp_path):
    """A fresh build lands in the build directory (by default the port's
    _build/), keyed by the source's hash, and writes nothing into native/."""
    assert native.library_path().parent == native._PKG / "_build"
    before = sorted(os.listdir(native.SOURCE.parent))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.ramp(3, 0.0, 1.0).tolist() == [0.0, 0.5, 1.0]
    assert native.library_path().exists() and native.library_path().parent == tmp_path / "_build"
    assert sorted(os.listdir(native.SOURCE.parent)) == before


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler-xyz"])
def test_a_broken_compiler_raises(monkeypatch, tmp_path, cxx):
    """A failed build raises with the compiler's word (the JAX package's
    swallows it); available() then says False."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=cxx):
        native.blackman(10, 1.0)
    assert not native.available()

"""PyTorch port vs the JAX package: drawing (pulser_diff_torch/core/drawing.py
and the ``draw`` / ``plot`` methods of the waveforms, pulses, registers,
sequences, the emulator and the results).

The same objects are drawn by both packages under the Agg backend, and
each figure is read back: every axes' lines (``get_xydata()``, equal
within 1e-12: both packages sample in f64, and the results' expectation
values come from their f64 steppers), line styles and colours, texts
(labels, annotations, axis labels), scatter offsets and patches.  The
ports of tests/test_misc.py::test_plotting_smoke and of the drawing parts
of tests/test_sequence.py.
"""

from collections import Counter

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import pulser_diff_torch.core as tcore  # noqa: E402
import pulser_diff_tpu.core as jcore  # noqa: E402
from pulser_diff_torch import TorchEmulator  # noqa: E402
from pulser_diff_torch import simresults as tres  # noqa: E402
from pulser_diff_torch.core.channels import Channel as TChannel  # noqa: E402
from pulser_diff_torch.ops import total_magnetization  # noqa: E402
from pulser_diff_tpu import TpuEmulator  # noqa: E402
from pulser_diff_tpu import simresults as jres  # noqa: E402
from pulser_diff_tpu.core.channels import Channel as JChannel  # noqa: E402
from pulser_diff_tpu.ops import total_magnetization as j_total_mag  # noqa: E402

torch.set_num_threads(1)

# f64 samples on both sides, and f64 steppers for the results
DATA_TOL = 1e-12


def _figures(draw) -> list:
    """What ``draw()`` leaves in its figures: per axes, the lines (xy data,
    style, colour), texts, axis labels, scatter offsets and patches."""
    plt.close("all")
    draw()
    out = []
    for num in plt.get_fignums():
        for ax in plt.figure(num).axes:
            out.append({
                "lines": [(ln.get_xydata(), ln.get_linestyle(), ln.get_color())
                          for ln in ax.lines],
                "texts": [t.get_text() for t in ax.texts],
                "labels": (ax.get_xlabel(), ax.get_ylabel()),
                "offsets": [np.asarray(c.get_offsets()) for c in ax.collections
                            if type(c).__name__ == "PathCollection"],
                "patches": [(type(p).__name__, getattr(p, "center", None),
                             getattr(p, "radius", None)) for p in ax.patches],
            })
    plt.close("all")
    return out


def _assert_same_figures(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"] and g["labels"] == w["labels"]
        assert [ln[1:] for ln in g["lines"]] == [ln[1:] for ln in w["lines"]]
        for (gx, *_), (wx, *_) in zip(g["lines"], w["lines"]):
            assert gx.shape == wx.shape
            np.testing.assert_allclose(gx, wx, rtol=0, atol=DATA_TOL)
        assert len(g["offsets"]) == len(w["offsets"])
        for go, wo in zip(g["offsets"], w["offsets"]):
            np.testing.assert_allclose(go, wo, rtol=0, atol=DATA_TOL)
        assert [p[0] for p in g["patches"]] == [p[0] for p in w["patches"]]
        for (_, gc, gr), (_, wc, wr) in zip(g["patches"], w["patches"]):
            if gc is not None:
                np.testing.assert_allclose(gc, wc, rtol=0, atol=DATA_TOL)
                assert gr == pytest.approx(wr, abs=DATA_TOL)


def _register(core):
    return core.Register({"q0": np.array([-4.0, 0.0]), "q1": np.array([4.0, 0.0])})


def _sequence(core, shifted: bool = False):
    """test_plotting_smoke's sequence; ``shifted`` appends its second pulse
    at another phase (the phase-area and phase-shift annotations)."""
    seq = core.Sequence(_register(core), core.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(core.Pulse.ConstantPulse(100, 1.5, -0.5, 0.2), "ryd")
    if shifted:
        seq.add(core.Pulse.ConstantPulse(80, 2.0, 0.0, 0.9), "ryd")
    return seq


def _emulators(shifted: bool = False, evaluation_times=0.2):
    return (TpuEmulator.from_sequence(_sequence(jcore, shifted), evaluation_times=evaluation_times),
            TorchEmulator.from_sequence(_sequence(tcore, shifted),
                                        evaluation_times=evaluation_times, device="cpu"))


def test_results_plot_matches_jax():
    """SimulationResults.plot of the total magnetization over a run()."""
    jsim, tsim = _emulators()
    jr, tr = jsim.run(), tsim.run()
    want = _figures(lambda: (plt.figure(), jr.plot(j_total_mag(2), label="m")))
    got = _figures(lambda: (plt.figure(), tr.plot(total_magnetization(2, device="cpu"),
                                                  label="m")))
    _assert_same_figures(got, want)
    assert want[0]["labels"] == ("Time (µs)", "Expectation value")


@pytest.mark.parametrize("error_bars", [True, False])
def test_noisy_results_plot_matches_jax(error_bars):
    """NoisyResults.plot, with error bars (one standard error over the
    shots) and without, on the same bitstring counts in both packages."""
    times = np.array([0.0, 0.1, 0.2])
    counts = [Counter({"00": 3}), Counter({"00": 2, "01": 1}), Counter({"01": 1, "11": 2})]

    def noisy(res):
        out = [res.SampledResult(("q0", "q1"), "ground-rydberg", c) for c in counts]
        return res.NoisyResults(out, 2, "ground-rydberg", times, 3)

    want = _figures(lambda: (plt.figure(),
                             noisy(jres).plot(j_total_mag(2), error_bars=error_bars)))
    got = _figures(lambda: (plt.figure(), noisy(tres).plot(
        total_magnetization(2, device="cpu"), error_bars=error_bars)))
    _assert_same_figures(got, want)
    # with error bars the two caps are lines too, beside the data
    assert len(want[0]["lines"]) == (3 if error_bars else 1)


def test_emulator_and_sequence_draw_match_jax(tmp_path):
    """TorchEmulator.draw with the phase curve (saved to a file) and with
    the phase areas and shifts, and Sequence.draw, against the JAX
    package's: the pulse areas, the phase label and the dashed
    phase-shift markers are there."""
    jsim, tsim = _emulators()
    path = tmp_path / "draw.png"
    want = _figures(lambda: jsim.draw(draw_phase_curve=True))
    got = _figures(lambda: tsim.draw(draw_phase_curve=True, fig_name=str(path)))
    _assert_same_figures(got, want)
    assert path.stat().st_size > 0
    assert len(got) == 3  # amplitude, detuning and the phase's twin axes

    jsim, tsim = _emulators(shifted=True, evaluation_times="Minimal")
    opts = dict(draw_phase_area=True, draw_phase_shifts=True)
    want = _figures(lambda: jsim.draw(**opts))
    got = _figures(lambda: tsim.draw(**opts))
    _assert_same_figures(got, want)
    texts = got[0]["texts"]
    assert any("A:" in t for t in texts) and any("φ" in t for t in texts)
    assert any(style == "--" for _, style, _ in got[0]["lines"])

    want = _figures(lambda: _sequence(jcore, True).draw(**opts))
    got = _figures(lambda: _sequence(tcore, True).draw(**opts, device="cpu"))
    _assert_same_figures(got, want)


def test_nothing_to_draw():
    """A sequence without a channel has nothing to draw (as
    tests/test_sequence.py holds the JAX package's), and a parametrized
    one must be built first."""
    seq = tcore.Sequence(tcore.Register.linear(2, spacing=6.0, prefix="q"), tcore.MockDevice)
    with pytest.raises(ValueError, match="Nothing to draw"):
        seq.draw(device="cpu")
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(tcore.Pulse.ConstantPulse(100, seq.declare_variable("om"), 0.0, 0.0), "ryd")
    with pytest.raises(ValueError, match="build"):
        seq.draw(device="cpu")
    plt.close("all")


def test_register_pulse_waveform_draw_match_jax(tmp_path):
    """Register.draw with half-blockade circles, Pulse.draw of a Blackman
    pulse and Waveform.draw with a modulated output, against the JAX
    package's (the draw parts of tests/test_sequence.py's register, pulse
    and waveform tests), each saved to a file."""
    reg = {c: c.Register.linear(2, spacing=6.0, prefix="q") for c in (jcore, tcore)}
    kw = dict(blockade_radius=8.0, draw_half_radius=True)
    want = _figures(lambda: reg[jcore].draw(**kw))
    got = _figures(lambda: reg[tcore].draw(**kw, fig_name=str(tmp_path / "reg.png")))
    _assert_same_figures(got, want)
    assert got[0]["texts"] == ["q0", "q1"] and len(got[0]["patches"]) == 2

    hexa = {c: c.Register.hexagon(2, spacing=5.0) for c in (jcore, tcore)}
    _assert_same_figures(_figures(lambda: hexa[tcore].draw()), _figures(lambda: hexa[jcore].draw()))

    pulse = {c: c.Pulse(c.BlackmanWaveform(200, np.pi), c.RampWaveform(200, -1.0, 1.0), 0.3)
             for c in (jcore, tcore)}
    want = _figures(lambda: pulse[jcore].draw())
    got = _figures(lambda: pulse[tcore].draw(fig_name=str(tmp_path / "pulse.png")))
    _assert_same_figures(got, want)

    chans = {c: ch(name="rydberg_global", addressing="Global", basis="ground-rydberg",
                   mod_bandwidth=8.0) for c, ch in ((jcore, JChannel), (tcore, TChannel))}
    wf = {c: c.BlackmanWaveform(200, np.pi) for c in (jcore, tcore)}
    want = _figures(lambda: wf[jcore].draw(output_channel=chans[jcore]))
    got = _figures(lambda: wf[tcore].draw(output_channel=chans[tcore],
                                          fig_name=str(tmp_path / "wf.png")))
    _assert_same_figures(got, want)
    assert [style for _, style, _ in got[0]["lines"]] == ["-", "--"]
    for name in ("reg", "pulse", "wf"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0

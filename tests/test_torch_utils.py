"""PyTorch port: the parameter checkpoints and profiling helpers
(pulser_diff_torch.utils) against the JAX package's (pulser_diff_tpu.utils).

  - ``save_params`` / ``load_params`` round trips: ``torch.save`` files,
    a step directory, the npz form;
  - ``load_params`` reading the npz that the JAX package's ``save_params``
    writes without orbax, its dtypes and values kept;
  - ``timed`` filling ``results`` (and printing without it);
  - ``profile_trace``'s label among ``torch.profiler``'s events on the CPU.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulser_diff_tpu import utils as jutils
from pulser_diff_torch import QuantumModel
from pulser_diff_torch.utils import load_params, profile_trace, save_params, timed

torch.set_num_threads(1)


def _params():
    return {"omega": torch.tensor(1.5, dtype=torch.float64),
            "coords": torch.tensor([1.0, 2.0], dtype=torch.float64),
            "steps": torch.arange(3, dtype=torch.int32)}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu" and got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("name, step", [("ckpt.pt", None), ("ckpt.npz", None), ("run", 7)])
def test_checkpoint_round_trip(tmp_path, name, step):
    """torch.save files, a step directory and npz files load back equal,
    dtypes kept, on the device asked for."""
    params = _params()
    path = save_params(str(tmp_path / name), params, step=step)
    if step is not None:
        assert path == str(tmp_path / name / f"step_{step}.pt")
    _assert_same(load_params(path, device="cpu"), params)


def test_checkpoint_of_a_trained_model(tmp_path):
    """A model's parameters (nn.Parameters with gradients) save, load and
    restore into a fresh model."""
    import pulser_diff_torch.core as tcore

    def model():
        reg = tcore.Register.from_coordinates([(-4.0, 0.0), (4.0, 0.0)], prefix="q")
        seq = tcore.Sequence(reg, tcore.MockDevice)
        seq.declare_channel("ryd", "rydberg_global")
        om = seq.declare_variable("omega")
        seq.add(tcore.Pulse.ConstantPulse(40, om, -0.5, 0.0), "ryd")
        return QuantumModel(seq, {"omega": 1.1}, device="cpu")

    m = model()
    with torch.no_grad():
        m.params["omega"].add_(0.25)
    path = save_params(str(tmp_path / "model.pt"), dict(m.params))
    fresh = model()
    with torch.no_grad():
        for k, v in load_params(path, device="cpu").items():
            fresh.params[k].copy_(v)
    assert torch.equal(fresh.params["omega"], m.params["omega"])
    assert float(fresh.params["omega"].detach()) != 1.1


def test_load_params_reads_the_jax_packages_npz(tmp_path, monkeypatch):
    """Without orbax the JAX package's save_params writes an npz; the port
    reads it by the same path, with its dtypes and values."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jparams = {"omega": jnp.asarray(1.5), "coords": jnp.array([1.0, -2.0, 0.25]),
               "amp_0": jnp.linspace(0.5, 3.0, 8)}
    written = jutils.save_params(str(tmp_path / "jax_ckpt"), jparams)
    assert written.endswith(".npz")
    for path in (written, str(tmp_path / "jax_ckpt")):
        got = load_params(path, device="cpu")
        assert set(got) == set(jparams)
        for k, v in jparams.items():
            assert got[k].dtype == torch.float64
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_load_params_defaults_to_cuda(tmp_path, monkeypatch):
    """Without a device and without CUDA it raises instead of loading on
    the CPU."""
    path = save_params(str(tmp_path / "p.pt"), _params())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params(path)


def test_timed_fills_results(capsys):
    out = {}
    with timed("block", out):
        torch.ones(10).add_(1)
    assert set(out) == {"block"} and out["block"] >= 0.0
    with timed("printed"):
        pass
    assert "[timed] printed:" in capsys.readouterr().out


def test_timed_records_nothing_when_the_block_raises():
    """The block's exception passes through and nothing is recorded."""
    out = {}
    with pytest.raises(ValueError):
        with timed("fails", out):
            raise ValueError("inside")
    assert out == {}


def test_profile_trace_label_in_profiler_events():
    """profile_trace's label is a record_function event of torch.profiler
    on the CPU, around the work inside it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile_trace("pdt-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = [e.name for e in prof.events()]
    assert "pdt-region" in names
    region = next(e for e in prof.events() if e.name == "pdt-region")
    inner = [e for e in prof.events() if e.name == "aten::matmul"]
    assert inner and all(region.time_range.start <= e.time_range.start
                         and e.time_range.end <= region.time_range.end for e in inner)

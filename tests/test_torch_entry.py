"""The port's entry module (pulser_diff_torch/entry.py) against the JAX
package's entry module (__graft_entry__.py, imported by path as
tests/test_parallel.py does): the flagship sweep's value and gradient, and
the multi-rank dry run."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pulser_diff_torch.entry import dryrun_multichip, flagship

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _graft():
    spec = importlib.util.spec_from_file_location("_graft", ROOT / "__graft_entry__.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_flagship_value_and_grad_match_jax():
    """JAX's _flagship at the reduced n_qubits=4 (2 x 2 at 6.2 um, 8 + 8
    interpolation knots, 400 ns), called eagerly: the final total
    magnetization and its gradient in both knot vectors (1e-10), the
    example arguments equal to the last bit."""
    jfn, jargs = _graft()._flagship(n_qubits=4)
    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1))(*jargs)
    fn, args = flagship(n_qubits=4, device="cpu")
    for a, ja in zip(args, jargs):
        # np.linspace and jnp.linspace round apart in the last bit
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), rtol=0, atol=1e-15)
    value = fn(*args)
    grads = torch.autograd.grad(value, args)
    assert value.shape == () and abs(float(value.detach()) - float(jv)) < 1e-10
    for g, jgi in zip(grads, jg):
        assert float(np.abs(np.asarray(jgi)).max()) > 1e-3
        np.testing.assert_allclose(g.numpy(), np.asarray(jgi), rtol=0, atol=1e-10)


def test_entry_is_the_nine_atom_flagship(monkeypatch):
    """entry() builds the 9-atom flagship on the device it is given, and
    without one and without CUDA it raises instead of running on the CPU."""
    seen = {}
    import pulser_diff_torch.entry as entry_mod

    monkeypatch.setattr(entry_mod, "flagship", lambda **kw: seen.update(kw) or ("fn", ()))
    assert entry_mod.entry(device="cpu") == ("fn", ())
    assert seen == {"device": "cpu"}
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry_mod.entry()


def test_dryrun_multichip_two_ranks(capsys):
    """Two gloo ranks on the CPU: the ("runs", "param") training step, the
    state-, row- and trajectory-sharded solves, and the OK line."""
    dryrun_multichip(2)
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip OK: mesh={'runs': 2, 'param': 1} loss=")
    assert "state_shards=2 rho_shards=2 mcwf_shards=2" in out

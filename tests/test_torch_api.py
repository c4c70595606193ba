"""The port's public surface against the JAX package's.

For every module of pulser_diff_tpu/, each public name (a module-level
function or class not starting with ``_``, and each public method of such
a class, read from the source) has a counterpart of the same name in the
port's module of the same path: the port does what the JAX package does,
but for the exceptions listed below, each with its reason.  The list is
held tight: an exception whose name the port has is an error too.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "pulser_diff_tpu"

# names the port gives another name, and why
RENAMED = {
    # the kernels are hand-written CUDA, not Pallas
    "ops/pallas_evolution": "ops/fused_evolution",
    "pallas_evolve_states": "evolve_states",
    "pallas_evolve_mc": "evolve_mc",
    # the emulator is named for the port's framework (the JAX package
    # exports TorchEmulator as an alias of TpuEmulator)
    "TpuEmulator": "TorchEmulator",
}

# names the port does not have, and why
EXCEPTIONS = {
    ("utils/profiling", "start_server"): "kept on purpose: it wraps jax.profiler.start_server, "
                                         "the gRPC endpoint TensorBoard's capture button talks "
                                         "to; torch has no such server (torch.profiler writes "
                                         "traces), and a hand-made one would speak a protocol "
                                         "no tool reads",
}


def _public_names(path: Path) -> list[str]:
    """Module-level public functions and classes, and the public methods
    of those classes ('Class.method'), from the source."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.append(node.name)
        if isinstance(node, ast.ClassDef):
            out += [f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_")]
    return out


def _modules() -> list[str]:
    return sorted(str(p.relative_to(JAX_PKG).with_suffix("")) for p in JAX_PKG.rglob("*.py"))


def _port_has(module, name: str) -> bool:
    obj = module
    for part in name.split("."):
        obj = getattr(obj, RENAMED.get(part, part), None)
        if obj is None:
            return False
    return True


def _port_module(rel: str):
    rel = RENAMED.get(rel, rel)
    dotted = "pulser_diff_torch." + rel.replace("/", ".").removesuffix(".__init__")
    return importlib.import_module(dotted.removesuffix("."))


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    """Each public name of the JAX module is in the port's module (by
    attribute, so re-exports and inherited methods count), unless listed."""
    module = _port_module(rel)
    names = _public_names(JAX_PKG / f"{rel}.py")
    missing = [n for n in names if not _port_has(module, n) and (rel, n) not in EXCEPTIONS]
    assert not missing, f"{rel}: no counterpart for {missing}"
    for (mod, n), why in EXCEPTIONS.items():
        if mod == rel:
            assert n in names, f"{rel}.{n} is listed but the JAX package has no such name"
            assert not _port_has(module, n), f"{rel}.{n} is listed ({why}) but the port has it"


def test_the_lists_name_real_modules():
    """Every listed module exists in both packages."""
    mods = set(_modules())
    assert {m for m, _ in EXCEPTIONS} <= mods and "ops/pallas_evolution" in mods
    for rel in mods:
        assert (ROOT / "pulser_diff_torch" / f"{RENAMED.get(rel, rel)}.py").exists(), rel


_NO_MATPLOTLIB = """
import pkgutil, sys
sys.modules["matplotlib"] = None  # any import of matplotlib fails
sys.modules["jax"] = None
import pulser_diff_torch
names = [m.name for m in pkgutil.walk_packages(pulser_diff_torch.__path__, "pulser_diff_torch.")]
for name in names:
    __import__(name)
bad = sorted(n for n in sys.modules if sys.modules[n] is not None
             and n.split(".")[0] in ("matplotlib", "jaxlib", "pulser_diff_tpu"))
print(len(names), bad)
"""


def test_the_port_imports_without_matplotlib():
    """Every module of the port imports in a process where matplotlib (and
    JAX) cannot be imported: the drawing methods import matplotlib when
    they draw, as the card's machine has none."""
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) > 40 and bad == "[]", out.stdout


def test_small_helpers_match_jax():
    """The small public helpers against their JAX twins on seeded inputs:
    ``Cplx.mul_i``, ``cmatmul_rc`` / ``cmatmul_cr``, ``cnorm2``,
    ``cplx.ceinsum`` (ops/apply.py's, re-exported) and ``ops.apply.h_apply``
    (one (da, db) state through ``h_apply_batched``) on a 3-atom
    Hamiltonian at 1e-12."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pulser_diff_torch import cplx as tc
    from pulser_diff_torch.ops import apply as tapply
    from pulser_diff_tpu import cplx as jc
    from pulser_diff_tpu.ops import apply as japply
    from tests.torch_port_cases import emulators

    rng = np.random.default_rng(7)
    a, b = (rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4)) for _ in range(2))
    r = rng.normal(size=(4, 3))
    ta, tb = (tc.Cplx(torch.tensor(x.real), torch.tensor(x.imag)) for x in (a, b))
    ja, jb = (jc.Cplx(jnp.asarray(x.real), jnp.asarray(x.imag)) for x in (a, b))

    def same(t, j):
        np.testing.assert_allclose(t.to_numpy() if isinstance(t, tc.Cplx) else t.numpy(),
                                   j.to_numpy() if isinstance(j, jc.Cplx) else np.asarray(j),
                                   rtol=0, atol=1e-12)

    same(ta.mul_i(), ja.mul_i())
    same(ta.mul_i().mul_neg_i(), ja)
    same(tc.cmatmul_rc(torch.tensor(r), ta), jc.cmatmul_rc(jnp.asarray(r), ja))
    same(tc.cmatmul_cr(ta, torch.tensor(r)), jc.cmatmul_cr(ja, jnp.asarray(r)))
    same(tc.cnorm2(ta), jc.cnorm2(ja))
    same(tc.ceinsum("ij,kj->ik", ta, tb), jc.ceinsum("ij,kj->ik", ja, jb))
    assert tc.ceinsum is tapply.ceinsum

    jsim, tsim = emulators(3, duration=40, seed=3)
    jh, th = jsim._hamiltonian, tsim._hamiltonian
    da, db = th.dim ** th._a, th.dim ** th._b
    psi = rng.normal(size=(da, db)) + 1j * rng.normal(size=(da, db))
    t = 0.013
    zt = tapply.interp_streams(th._ham_data, torch.tensor(t, dtype=torch.float64))
    zj = japply.interp_streams(jh._ham_data, jnp.asarray(t))
    got = tapply.h_apply(th._ham_data, *zt, tc.Cplx(torch.tensor(psi.real),
                                                    torch.tensor(psi.imag)))
    want = japply.h_apply(jh._ham_data, *zj, jc.Cplx(jnp.asarray(psi.real),
                                                     jnp.asarray(psi.imag)))
    assert got.shape == (da, db)
    same(got, want)

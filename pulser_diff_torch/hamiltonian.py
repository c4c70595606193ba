"""Time-dependent Rydberg / XY Hamiltonian assembly (counterpart of
pulser_diff_tpu/hamiltonian.py).

The sampled sequence becomes a :class:`FactoredHamiltonian`: static
stacks of small real part matrices (row-group / column-group lifts) plus
complex coefficient streams, and the interaction: the van der Waals
diagonal on the (da, db) grid (ising), or the XY dipole flip-flop terms
as kron pairs.  Physics as in the JAX package:
  - amplitude coeff 0.5*amp*exp(-i*phase) on the lowering op, hermitized;
  - detuning coeff -0.5*det on the occupation projector, hermitized;
  - van der Waals C6/r^6 n_i n_j;
  - XY C3 (1 - 3 cos^2 theta)/r^3 (sigma+ sigma- + h.c.), theta the angle
    between the pair and the magnetic field.
The bases are the JAX package's: ground-rydberg (the Rydberg channels),
digital (the Raman channels: |g>, |h>), all (both: |r>, |g>, |h>, three
levels a site) and XY (the microwave channel), each with one dark level
|x> more under leakage noise.  The SLM mask acts in both interaction
modes (the masked qubits' amplitude zeroed in its window in ising mode;
the XY terms time-windowed).  The digital basis has no interaction term.
The interaction weights are differentiable in the qubit coordinates, or
in the pair distances set through ``_dist_override``.

Noise as in the JAX package: ``draw_noise`` draws one run's bad atoms
(SPAM state preparation), Doppler detunings and per-slot amplitude
factors from an explicit ``torch.Generator``; with per-qubit noise every
global channel is scattered to one stream per qubit (the "Local"
samples), each with its own amplitude and detuning part.  ``build_batch``
builds R runs with one term structure, decided from the configuration as
the JAX package's ``jax.vmap`` tracing decides it, so that the runs share
one part stack; lifted parts are built once and kept.

The Lindblad noises become :class:`CollapseOps`, one (d, d) operator per
site, scaled by sqrt(rate) (``collapse_operators``): dephasing,
relaxation, depolarizing and ``eff_noise``, as the JAX package builds
them, lifted into the leakage-extended bases with the dark level left
untouched.  A rate given as a tensor keeps its gradient into the
operators.  ``build_operator`` lifts named or given one-site operators to
the register, and ``_hamiltonian`` materializes H(t) densely, both for
introspection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pulser_diff_torch.config import (
    DeviceLike, constant_under_export, default_dtype, resolve_device,
)
from pulser_diff_torch.cplx import Cplx, as_cplx
from pulser_diff_torch.core.devices import Device
from pulser_diff_torch.core.register import QubitId
from pulser_diff_torch.core.sampler import SequenceSamples
from pulser_diff_torch.ops.apply import FactoredHamiltonian, _matmul, _weighted_sum, h_matrix
from pulser_diff_torch.ops.linalg import basis_state, kron
from pulser_diff_torch.simconfig import SUPPORTED_NOISES, NoiseModel, doppler_sigma, host_float

# basis tables: (dimension, labels, projector names)
_BASIS_TABLE = {
    "XY": (2, ["u", "d"], ["uu", "du", "ud", "dd"]),
    "ground-rydberg": (2, ["r", "g"], ["gr", "rr", "gg"]),
    "digital": (2, ["g", "h"], ["hg", "hh", "gg"]),
    "all": (3, ["r", "g", "h"], ["gr", "hg", "rr", "gg", "hh"]),
}

# operator ids (amplitude, detuning) per sampled basis
_OP_IDS = {
    "ground-rydberg": ("sigma_gr", "sigma_rr"),
    "digital": ("sigma_hg", "sigma_gg"),
    "XY": ("sigma_du", "sigma_uu"),
}


def _local_op_np(dim: int, basis: list[str], name: str) -> np.ndarray:
    """|b1><b2| as a dense real numpy matrix from a 'sigma_xy' name, or
    the identity for 'I'."""
    if name == "I":
        return np.eye(dim)
    b1, b2 = name[6], name[7]
    m = np.zeros((dim, dim))
    m[basis.index(b1), basis.index(b2)] = 1.0
    return m


# the one-site Pauli matrices of the collapse operators
_PAULI = {
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]]),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}


class CollapseOps(NamedTuple):
    """Single-site collapse operators: the site of each, and the (M, d, d)
    stack of local operators, already scaled by sqrt(rate) (None without
    Lindblad noise)."""

    sites: tuple
    ops: Optional[Cplx]


def collapse_operators(config: NoiseModel, basis_name: str, labels: list, n_qubits: int,
                       device: torch.device) -> CollapseOps:
    """The collapse operators of ``config``'s Lindblad noises on ``n_qubits``
    sites of the basis ``basis_name`` (level ``labels``, the dark level
    'x' last under leakage), as the JAX package builds them: sqrt(rate /
    2) Z for dephasing (at ``hyperfine_dephasing_rate`` in the digital
    basis), sqrt(rate) |g><r| for relaxation, sqrt(rate / 4) X, Y, Z for
    depolarizing, sqrt(rate_k) O_k for ``eff_noise`` (each O_k of the
    basis' dimension, the dark level included); the Pauli matrices act on
    the first two levels and leave the dark level untouched.  Each
    operator on every site in turn.  Rates stay tensors, so a rate with
    ``requires_grad`` carries its gradient into the operators."""
    dim = len(labels)
    leak = "x" in labels
    noise = config.noise_types

    def rate(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=default_dtype()).to(device)

    def root(x: torch.Tensor) -> torch.Tensor:
        # a power 0.5, the same bits as torch.sqrt: sqrt's backward reads
        # its saved output, which a torch.export trace calling
        # torch.autograd.grad does not follow (it would freeze it into the
        # artifact as a constant)
        return x**0.5

    def op(mat) -> Cplx:
        return as_cplx(mat, dtype=default_dtype(), device=device).to(device=device)

    def pauli(p: str) -> Cplx:
        """A Pauli matrix on the first two levels of a site."""
        m = np.zeros((dim, dim), dtype=complex)
        m[:2, :2] = _PAULI[p]
        return op(m)

    def basis_check(noise_type: str) -> None:
        if basis_name == "all":
            raise NotImplementedError(f"Cannot include {noise_type} noise in all-basis.")

    local: list[Cplx] = []
    if "dephasing" in noise:
        basis_check("dephasing")
        r = config.hyperfine_dephasing_rate if basis_name == "digital" else config.dephasing_rate
        local.append(pauli("Z") * root(rate(r) / 2))
    if "relaxation" in noise:
        if not {"g", "r"} <= set(labels):
            raise ValueError(
                "'relaxation' noise requires addressing of the 'ground-rydberg' basis.")
        local.append(op(_local_op_np(dim, labels, "sigma_gr"))
                     * root(rate(config.relaxation_rate)))
    if "depolarizing" in noise:
        basis_check("depolarizing")
        coeff = root(rate(config.depolarizing_rate) / 4)
        local += [pauli(p) * coeff for p in "XYZ"]
    if "eff_noise" in noise:
        basis_check("effective")
        for r, mat in zip(config.eff_noise_rates, config.eff_noise_opers):
            o = op(mat)
            if o.shape != (dim, dim):
                raise ValueError(
                    f"Incompatible shape {o.shape} of effective noise operator: expected "
                    f"({dim}, {dim}) for basis '{basis_name}'"
                    + (" with leakage" if leak else "") + ".")
            local.append(o * root(rate(r)))
    if not local:
        return CollapseOps((), None)
    sites = tuple(q for _ in local for q in range(n_qubits))
    return CollapseOps(sites, Cplx(
        torch.stack([o.re for o in local for _ in range(n_qubits)]),
        torch.stack([o.im for o in local for _ in range(n_qubits)])))


class NoiseDraws(NamedTuple):
    """Random draws for one stochastic run."""

    bad_atoms: torch.Tensor  # (n,) float 0/1
    doppler: torch.Tensor  # (n,) rad/us
    amp_factors: torch.Tensor  # (n_slots_total,) >= 0


def zero_noise_draws(n_qubits: int, n_slots: int, device: DeviceLike = None) -> NoiseDraws:
    """The draws of a noiseless run, on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    return NoiseDraws(
        bad_atoms=torch.zeros(n_qubits, dtype=default_dtype(), device=device),
        doppler=torch.zeros(n_qubits, dtype=default_dtype(), device=device),
        amp_factors=torch.ones(max(n_slots, 1), dtype=default_dtype(), device=device),
    )


def draw_noise(gen: torch.Generator, config: NoiseModel, n_qubits: int,
               n_slots: int) -> NoiseDraws:
    """One run's random noise on the generator's device, with the JAX
    package's semantics (its stream differs): a Bernoulli(eta) bad atom
    per qubit (SPAM), a Doppler detuning doppler_sigma(T) N(0, 1) per
    qubit, and an amplitude factor clip(1 + amp_sigma N(0, 1), 0) per
    pulse slot.  Under ``torch.export`` the uniform and normal samples are
    constants of the graph (``constant_under_export``), as the JAX
    package's key is under ``jax.jit``; the parameters stay traced."""
    dev = gen.device
    draws = zero_noise_draws(n_qubits, n_slots, dev)

    def param(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=default_dtype()).to(dev)

    def draw(sample, n: int) -> torch.Tensor:
        return constant_under_export(
            lambda: sample(n, generator=gen, dtype=default_dtype(), device=dev))

    if "SPAM" in config.noise_types:
        u = draw(torch.rand, n_qubits)
        draws = draws._replace(bad_atoms=(u < param(config.state_prep_error)).to(default_dtype()))
    if "doppler" in config.noise_types:
        sigma = doppler_sigma(param(config.temperature) * 1e-6)  # uK -> K
        z = draw(torch.randn, n_qubits)
        draws = draws._replace(doppler=sigma * z)
    if "amplitude" in config.noise_types:
        z = draw(torch.randn, max(n_slots, 1))
        draws = draws._replace(amp_factors=torch.clamp(1.0 + param(config.amp_sigma) * z, min=0.0))
    return draws


# the draws whose values differ between the runs of a batch, by branch of
# run(): the stochastic draws of each noise type, or the bad-atom
# configurations of SPAM
DRAW_FIELDS = {"SPAM": "bad_atoms", "doppler": "doppler", "amplitude": "amp_factors"}


def _maybe_nonzero(arr: torch.Tensor) -> bool:
    """True unless the array is provably all-zero.  A tensor that carries
    gradients, or any tensor under ``torch.export``, counts as nonzero, as
    a traced array does in the JAX package: dropping its term would drop
    its gradient, and a trace cannot read its values."""
    return arr.requires_grad or torch.compiler.is_exporting() or bool((arr != 0).any())


class Hamiltonian:
    """Builds and holds the factorized Hamiltonian for a sampled sequence."""

    def __init__(
        self,
        samples_obj: SequenceSamples,
        qdict: dict[QubitId, torch.Tensor],
        device: Device,
        sampling_rate: float,
        config: NoiseModel,
        torch_device: torch.device,
    ) -> None:
        self.samples_obj = samples_obj
        self.torch_device = torch_device
        self._qdict = {
            k: torch.as_tensor(v, dtype=default_dtype()).to(torch_device) for k, v in qdict.items()
        }
        self._device = device
        self._sampling_rate = sampling_rate
        self._dist_override: dict[str, torch.Tensor] = {}
        self._last_dist: tuple = ((), None)  # (qubit ids, (n, n) distances) of the last build
        self._interaction = "XY" if samples_obj._in_xy else "ising"
        self._size = len(self._qdict)
        self._qid_index = {qid: i for i, qid in enumerate(self._qdict)}
        # the last draw's bad atoms and Doppler detunings, by qubit
        self._bad_atoms: dict[QubitId, bool] = {}
        self._doppler_detune: dict[QubitId, float] = {}
        # seeds the draw of set_config (unseeded, as in the JAX package)
        self._np_rng = np.random.default_rng()
        # lifted part matrices and part stacks, built once
        self._lifts: dict[tuple, np.ndarray] = {}
        self._stacks: dict[tuple, torch.Tensor] = {}
        # spectral norms of the kept stacks, by stack id
        self._norms: dict[int, np.ndarray] = {}
        self._duration = samples_obj.max_duration
        # host-side numpy: the grid structure
        self.sampling_times = (
            np.arange(self._duration, dtype=np.float64)[
                self._subsample_indices(self._duration)
            ]
            / 1000
        )
        self._a = self._size // 2
        self._b = self._size - self._a
        self.set_config(config)

    def _subsample_indices(self, length: int) -> np.ndarray:
        n_keep = int(self._sampling_rate * self._duration)
        return np.linspace(0, length - 1, n_keep).astype(int)

    def _adapt_to_sampling_rate(self, arr: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(self._subsample_indices(arr.shape[0]), device=arr.device)
        return arr[idx]

    @property
    def config(self) -> NoiseModel:
        return self._config

    def set_config(self, cfg: NoiseModel, draws: Optional[NoiseDraws] = None) -> None:
        """Take a noise model and build the Hamiltonian of one draw from it
        (the noiseless one without stochastic noise), as the JAX package
        does; ``draws`` gives the realization instead of a fresh draw (a
        model's pinned one).  The realization stays in ``draws``."""
        if not isinstance(cfg, NoiseModel):
            raise ValueError(f"Object {cfg} is not a valid `NoiseModel`.")
        not_supported = set(cfg.noise_types) - SUPPORTED_NOISES[self._interaction]
        if not_supported:
            raise NotImplementedError(
                f"Interaction mode '{self._interaction}' does not support "
                f"simulation of noise types: {', '.join(not_supported)}."
            )
        want_leak = "leakage" in cfg.noise_types
        if not hasattr(self, "basis_name") or want_leak != self._with_leakage:
            self._build_basis_and_op_matrices(with_leakage=want_leak)
        self._collapse_ops = collapse_operators(cfg, self.basis_name, self._basis_labels,
                                                self._size, self.torch_device)
        self._config = cfg
        self.draws = self._update_noise() if draws is None else draws
        qids = list(self._qid_index)
        self._bad_atoms = dict(zip(qids, (self.draws.bad_atoms > 0.5).tolist()))
        self._doppler_detune = dict(zip(qids, self.draws.doppler.tolist()))
        self._ham_data = self.build_data(self.draws)

    def _build_basis_and_op_matrices(self, with_leakage: bool = False) -> None:
        """The basis from the sampled channels' bases (XY in XY mode; else
        ground-rydberg, digital, or all when both are used), extended by
        the dark level 'x' under leakage; its one-site kets ``basis`` and
        operators ``op_matrix`` ('I' and 'sigma_<b1><b2>', every pair of
        levels under leakage).  Lifted parts kept from another dimension
        are dropped."""
        if self._interaction == "XY":
            self.basis_name = "XY"
        else:
            used = self.samples_obj.used_bases
            if "digital" not in used:
                self.basis_name = "ground-rydberg"
            elif "ground-rydberg" not in used:
                self.basis_name = "digital"
            else:
                self.basis_name = "all"
        dim, labels, projectors = _BASIS_TABLE[self.basis_name]
        self._with_leakage = with_leakage
        if with_leakage:
            dim += 1
            labels = labels + ["x"]
            projectors = [b1 + b2 for b1 in labels for b2 in labels]
        self.dim = dim
        self._basis_labels = labels
        dev = self.torch_device
        self.basis = {b: basis_state(dim, i, device=dev) for i, b in enumerate(labels)}
        self.op_matrix: dict[str, Cplx] = {
            "I": as_cplx(np.eye(dim), dtype=default_dtype(), device=dev)}
        for proj in projectors:
            self.op_matrix["sigma_" + proj] = as_cplx(
                _local_op_np(dim, labels, "sigma_" + proj), dtype=default_dtype(), device=dev)
        self._lifts.clear()
        self._stacks.clear()
        self._norms.clear()

    def build_operator(self, operations) -> Cplx:
        """The dense operator on the register of ``[(op, qubits), ...]``:
        ``op`` an ``op_matrix`` name or a (dim, dim) matrix, on each qubit
        of ``qubits``, the identity elsewhere; ``(op, "global")`` sums the
        one-qubit operator over every qubit."""
        if not isinstance(operations, list):
            operations = [operations]
        op_list = [self.op_matrix["I"] for _ in range(self._size)]
        for operator, qubits in operations:
            if qubits == "global":
                total = None
                for q_id in self._qdict:
                    term = self.build_operator([(operator, [q_id])])
                    total = term if total is None else total + term
                return total
            qubits_set = set(qubits)
            if len(qubits_set) < len(qubits):
                raise ValueError("Duplicate atom ids in argument list.")
            if not qubits_set.issubset(self._qdict.keys()):
                raise ValueError(f"Invalid qubit names: {qubits_set - self._qdict.keys()}")
            if isinstance(operator, str):
                if operator not in self.op_matrix:
                    raise ValueError(f"{operator} is not a valid operator")
                operator = self.op_matrix[operator]
            else:
                operator = as_cplx(operator, dtype=default_dtype(), device=self.torch_device).to(
                    device=self.torch_device)
            for qubit in qubits:
                op_list[self._qid_index[qubit]] = operator
        return kron(*op_list)

    @property
    def _hamiltonian(self):
        """H(t): the dense (dim, dim) Hamiltonian at time ``t`` (us) of the
        current build."""

        def H_t(t) -> Cplx:
            return h_matrix(self._ham_data,
                            torch.as_tensor(t, dtype=default_dtype(), device=self.torch_device))

        return H_t

    def _count_noise_slots(self) -> int:
        return sum(len(cs.slots) for cs in self.samples_obj.channel_samples.values())

    def _update_noise(self) -> NoiseDraws:
        """One draw for the configuration, from a generator on the
        Hamiltonian's device seeded from the host generator; bad atoms
        only with a nonzero SPAM state-preparation error."""
        gen = torch.Generator(device=self.torch_device)
        gen.manual_seed(int(self._np_rng.integers(0, 2**31 - 1)))
        draws = draw_noise(gen, self._config, self._size, self._count_noise_slots())
        if not ("SPAM" in self._config.noise_types
                and host_float(self._config.state_prep_error) > 0):
            draws = draws._replace(bad_atoms=torch.zeros_like(draws.bad_atoms))
        return draws

    def _extract_samples(self, draws: NoiseDraws) -> dict:
        """The nested samples with one run's noise: per qubit, the Doppler
        shift on the detuning and the amplitude factor (the slot's draw
        times the laser-waist damping exp(-(r / w0)^2)) on the amplitude,
        inside each pulse slot (the final slot also on the closing
        sample); every stream of a bad atom zeroed."""
        cfg = self._config
        noise = set(cfg.noise_types)
        # per qubit unless every noise is global (Lindblad) or SPAM without
        # preparation errors
        local = True
        if noise <= {"dephasing", "relaxation", "SPAM", "depolarizing", "eff_noise"}:
            local = "SPAM" in noise and host_float(cfg.state_prep_error) > 0
        samples = self.samples_obj.to_nested_dict(all_local=local)
        if not local:
            return samples
        T = self.samples_obj.max_duration
        dev = self.torch_device
        slot_idx = 0
        for cs in self.samples_obj.channel_samples.values():
            sdict = samples["Local"].get(cs.basis, {})
            for slot in cs.slots:
                win = torch.zeros(T, dtype=torch.bool, device=dev)
                win[slot.ti : slot.tf] = True
                if slot.tf == T - 1:
                    # the +1 hold sample extends the final slot
                    win[slot.tf] = True
                amp_base = draws.amp_factors[slot_idx]
                for qid in slot.targets:
                    if qid not in sdict:
                        continue
                    qs = sdict[qid]
                    if "doppler" in noise:
                        qs["det"] = torch.where(
                            win, qs["det"] + draws.doppler[self._qid_index[qid]], qs["det"])
                    if "amplitude" in noise and cs.addressing == "Global":
                        noise_amp = amp_base
                        if cfg.laser_waist is not None:
                            r = torch.linalg.norm(self._qdict[qid])
                            w0 = torch.as_tensor(cfg.laser_waist, dtype=default_dtype()).to(dev)
                            noise_amp = amp_base * torch.exp(-((r / w0) ** 2))
                        qs["amp"] = torch.where(win, qs["amp"] * noise_amp, qs["amp"])
                slot_idx += 1
        # bad atoms: zero every local stream of badly prepared qubits
        for by_qubit in samples["Local"].values():
            for qid, qs in by_qubit.items():
                goodf = 1.0 - draws.bad_atoms[self._qid_index[qid]]
                for key in ("amp", "det", "phase"):
                    qs[key] = qs[key] * goodf
        return samples

    def _lift(self, op_name: str, sites: tuple, group: str) -> np.ndarray:
        """sum over ``sites`` of the one-site operator ``op_name`` lifted
        to the row (sites < a) or column group, built once."""
        key = (op_name, sites, group)
        if key not in self._lifts:
            d, a = self.dim, self._a
            g = a if group == "row" else self._b
            op = _local_op_np(d, self._basis_labels, op_name)
            out = np.zeros((d**g, d**g))
            for s_ in sites:
                loc = s_ if group == "row" else s_ - a
                out += np.kron(np.kron(np.eye(d**loc), op), np.eye(d ** (g - loc - 1)))
            self._lifts[key] = out
        return self._lifts[key]

    def _part_stack(self, keys: tuple, group: str) -> torch.Tensor:
        """The (P, d^g, d^g) stack of the lifted parts ``keys``, built once
        per term structure."""
        if (group, keys) not in self._stacks:
            self._stacks[group, keys] = torch.as_tensor(
                np.stack([self._lift(*k, group) for k in keys]), dtype=default_dtype(),
                device=self.torch_device)
        return self._stacks[group, keys]

    def part_norms(self, parts: torch.Tensor) -> np.ndarray:
        """The spectral norm of each part of a stack (the substep
        heuristic's), computed once for the stacks this Hamiltonian keeps
        (an SVD of 36 parts of 512 x 512 at 18 atoms takes seconds)."""
        kept = any(parts is t for t in self._stacks.values())
        if kept and id(parts) in self._norms:
            return self._norms[id(parts)]
        norms = np.linalg.norm(parts.detach().cpu().numpy(), ord=2, axis=(1, 2))
        if kept:
            self._norms[id(parts)] = norms
        return norms

    def build_batch(self, draws_list, varying: frozenset = frozenset()) -> list:
        """R runs' Hamiltonians with one term structure: a stream that
        depends on a draw in ``varying`` (names of NoiseDraws fields that
        differ between the runs) is kept in every run, even where a run's
        draw zeroes it, as the JAX package's ``jax.vmap`` of the build
        keeps every traced term.  The runs share one part stack (built
        once); the streams, the interaction diagonal and the kron part
        matrices are built per run."""
        return [self.build_data(d, varying=varying) for d in draws_list]

    def _interaction_weights(self, good: torch.Tensor) -> torch.Tensor:
        """(n, n) upper-triangular pair weights W_ij (rad/us), zeroed for
        bad atoms.  ising: C6/r^6.  XY: C3 (1 - 3cos^2 theta)/r^3.

        The pair distances are kept for ``_dist_dict``; ``_dist_override``
        entries ('q1-q2' keys) replace the distance of their pair."""
        n = self._size
        qids = list(self._qdict)
        coords = torch.stack([self._qdict[q] for q in qids])
        diff = coords[:, None, :] - coords[None, :, :]
        d2 = (diff * diff).sum(-1)
        eye = torch.eye(n, dtype=torch.bool, device=coords.device)
        # grad-safe diagonal: sqrt'(0) is inf, and the diagonal is masked.
        # A power, not torch.sqrt: sqrt's backward reads its saved output,
        # which autograd hands back as a tensor a torch.export trace of the
        # step does not follow (utils/export.py); the power's reads its input
        dist = torch.where(eye, torch.ones_like(d2), d2) ** 0.5
        if self._dist_override:
            ii, jj, vals = [], [], []
            for i in range(n):
                for j in range(i + 1, n):
                    key = f"{qids[i]}-{qids[j]}"
                    if key in self._dist_override:
                        ii.append(i)
                        jj.append(j)
                        vals.append(torch.as_tensor(self._dist_override[key], dtype=default_dtype(),
                                                    device=coords.device))
            if vals:
                dist = dist.index_put((torch.as_tensor(ii, device=coords.device),
                                       torch.as_tensor(jj, device=coords.device)),
                                      torch.stack(vals))
        self._last_dist = (qids, dist)
        if self._interaction == "ising":
            # a tensor over a tensor: ``scalar / t`` is reciprocal(t) * scalar,
            # and reciprocal's backward reads its saved output (as sqrt's)
            c6 = torch.as_tensor(self._device.interaction_coeff, dtype=dist.dtype,
                                 device=dist.device)
            w = c6 / dist**6
        else:
            mag = torch.as_tensor(self.samples_obj._magnetic_field[: coords.shape[-1]],
                                  dtype=default_dtype(), device=coords.device)
            mag_norm = torch.linalg.norm(mag)
            # double where: a plain where still propagates the unselected
            # branch's NaN through the gradient when mag_norm == 0 (the
            # default out-of-plane field), poisoning every coordinate
            # gradient
            degenerate = mag_norm < 1e-8
            safe_denom = torch.where(degenerate, torch.ones_like(dist), dist * mag_norm)
            # diff @ mag as one mm (``_matmul``: export keeps its saved operands)
            proj = _matmul(diff, mag[:, None])[..., 0]
            cosine = torch.where(degenerate, torch.zeros_like(dist), proj / safe_denom)
            w = self._device.interaction_coeff_xy * (1 - 3 * cosine**2) / dist**3
        tri = torch.triu(torch.ones(n, n, dtype=default_dtype(), device=coords.device), diagonal=1)
        return w * tri * (good[:, None] * good[None, :])

    @property
    def _dist_dict(self) -> dict[str, torch.Tensor]:
        """Pair distances 'q1-q2' of the last build (overrides included)."""
        qids, dist = self._last_dist
        return {f"{qids[i]}-{qids[j]}": dist[i, j]
                for i in range(len(qids)) for j in range(i + 1, len(qids))}

    def build_data(self, draws: NoiseDraws,
                   varying: frozenset = frozenset()) -> FactoredHamiltonian:
        """Nested samples + one run's draws -> FactoredHamiltonian.

        A stream that is all zero is dropped with its part, unless it
        carries gradients or depends on a draw named in ``varying`` (see
        :meth:`build_batch`)."""
        samples = self._extract_samples(draws)
        noise = set(self._config.noise_types)
        n, d, a, b = self._size, self.dim, self._a, self._b
        dev = self.torch_device
        good = 1.0 - draws.bad_atoms
        # streams that depend on a draw differing between runs: every
        # per-qubit stream through the bad atoms, the amplitudes through
        # the slots' factors, the detunings through the Doppler shifts
        bad_v = "bad_atoms" in varying
        amp_v = bad_v or ("amp_factors" in varying and "amplitude" in noise)
        det_v = bad_v or ("doppler" in varying and "doppler" in noise)

        row_keys, col_keys = [], []
        row_streams, col_streams = [], []

        def add_term(op_name, sites, amp_stream, det_stream, det_op_name) -> None:
            rsites = tuple(s_ for s_ in sites if s_ < a)
            csites = tuple(s_ for s_ in sites if s_ >= a)
            for name, stream in ((op_name, amp_stream), (det_op_name, det_stream)):
                if stream is None:
                    continue
                if rsites:
                    row_keys.append((name, rsites))
                    row_streams.append(stream)
                if csites:
                    col_keys.append((name, csites))
                    col_streams.append(stream)

        def _coeffs(qty: dict, local: bool):
            amp, det, phase = qty["amp"], qty["det"], qty["phase"]
            amp_stream = det_stream = None
            if (local and amp_v) or _maybe_nonzero(amp):
                half = 0.5 * amp
                amp_stream = Cplx(
                    self._adapt_to_sampling_rate(half * torch.cos(phase)),
                    self._adapt_to_sampling_rate(-half * torch.sin(phase)),
                )
            if (local and det_v) or _maybe_nonzero(det):
                det_stream = self._adapt_to_sampling_rate(-0.5 * det)
                det_stream = Cplx(det_stream, torch.zeros_like(det_stream))
            return amp_stream, det_stream

        for basis_key, qty in samples["Global"].items():
            if qty:
                amp_op, det_op = _OP_IDS[basis_key]
                add_term(amp_op, range(n), *_coeffs(qty, False), det_op)
        for basis_key, by_qubit in samples["Local"].items():
            amp_op, det_op = _OP_IDS[basis_key]
            for qid, qty in by_qubit.items():
                amp_s, det_s = _coeffs(qty, True)
                if amp_s is not None or det_s is not None:
                    add_term(amp_op, (self._qid_index[qid],), amp_s, det_s, det_op)

        n_samples = int(self._sampling_rate * self._duration)
        sample_dt = 0.001 / self._sampling_rate

        def _stack_parts(keys, streams, group, g):
            if not keys:
                z = torch.zeros(1, n_samples, dtype=default_dtype(), device=dev)
                return torch.zeros(1, d**g, d**g, dtype=default_dtype(), device=dev), Cplx(z, z)
            return (
                self._part_stack(tuple(keys), group),
                Cplx(
                    torch.stack([s_.re for s_ in streams]).to(dev),
                    torch.stack([s_.im for s_ in streams]).to(dev),
                ),
            )

        rp, rs = _stack_parts(row_keys, row_streams, "row", a)
        cp, cs = _stack_parts(col_keys, col_streams, "col", b)

        int_diag = torch.zeros(d**a, d**b, dtype=default_dtype(), device=dev)
        kron_row = kron_col = kron_streams = None
        if n > 1 and self.basis_name != "digital":
            W = self._interaction_weights(good)
            if self._interaction == "ising":
                int_diag = self._ising_diag(W)
            else:
                kron_row, kron_col, kron_streams = self._xy_kron_terms(W, n_samples)

        return FactoredHamiltonian(
            row_parts=rp,
            col_parts=cp,
            row_streams=rs,
            col_streams=cs,
            int_diag=int_diag,
            sample_dt=sample_dt,
            n_samples=n_samples,
            kron_row=kron_row,
            kron_col=kron_col,
            kron_streams=kron_streams,
        )

    def _ising_diag(self, W: torch.Tensor) -> torch.Tensor:
        """sum_{i<j} W_ij n_i n_j over the (da, db) grid."""
        d, a, b = self.dim, self._a, self._b
        dev = W.device
        occ_site = np.zeros((d,))
        occ_site[self._basis_labels.index("r")] = 1.0

        def occ_table(g: int) -> torch.Tensor:
            out = np.zeros((g, d**g)) if g else np.zeros((0, 1))
            for k in range(g):
                out[k] = np.kron(np.kron(np.ones(d**k), occ_site), np.ones(d ** (g - k - 1)))
            return torch.as_tensor(out, dtype=default_dtype(), device=dev)

        Or, Oc = occ_table(a), occ_table(b)
        W_rr, W_cc, W_rc = W[:a, :a], W[a:, a:], W[:a, a:]
        zeros1 = torch.zeros(1, dtype=default_dtype(), device=dev)
        # JAX's three-operand einsums as two-operand mm (``_matmul``): an
        # einsum saves reshapes that a torch.export trace does not see
        # sum_ij W_ij O_ix O_jx = sum_i (W @ O)_ix O_ix
        diag_r = (_matmul(W_rr, Or) * Or).sum(0) if a else zeros1
        diag_c = (_matmul(W_cc, Oc) * Oc).sum(0) if b else zeros1
        cross = (
            _matmul(_matmul(Or.T, W_rc), Oc)  # Or^T W_rc Oc
            if (a and b)
            else torch.zeros(d**a, d**b, dtype=default_dtype(), device=dev)
        )
        return diag_r[:, None] + diag_c[None, :] + cross

    def _xy_kron_terms(self, W: torch.Tensor, n_samples: int):
        """Factor the XY dipole flip-flop interaction
        sum_{i<j} W_ij (sigma_ud^i sigma_du^j + h.c.) into kron-pair terms
        z_k(t) (R_k (x) C_k) + h.c., applied as R @ Psi @ C^T:

          - within-row-group pairs  -> (sum_{i<j<a} W_ij s+_i s-_j, I_db)
          - within-col-group pairs  -> (I_da, sum_{a<=i<j} W_ij s+_i s-_j)
          - cross pairs, grouped by row site i -> (s+_i lift,
            sum_{j>=a} W_ij s-_j lift)

        W carries the coordinates' gradient into R_k / C_k.  Under an SLM
        mask the terms come twice, the full set over W and the masked set
        over W without the masked qubits' pairs, time-windowed by on/off
        streams: the masked set inside the mask's window, the full set
        after it."""
        d, a, b = self.dim, self._a, self._b
        da, db = d**a, d**b
        dev = W.device
        sig_ud = _local_op_np(d, self._basis_labels, "sigma_ud")
        sig_du = _local_op_np(d, self._basis_labels, "sigma_du")

        def lift(op: np.ndarray, loc: int, g: int) -> np.ndarray:
            return np.kron(np.kron(np.eye(d**loc), op), np.eye(d ** (g - loc - 1)))

        def t(x: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(x, dtype=default_dtype(), device=dev)

        ud_row = [lift(sig_ud, i, a) for i in range(a)]
        du_row = [lift(sig_du, i, a) for i in range(a)]
        ud_col = [lift(sig_ud, j, b) for j in range(b)]
        du_col = [lift(sig_du, j, b) for j in range(b)]

        def build_set(Wset: torch.Tensor) -> tuple[list, list]:
            rows, cols = [], []
            # within-row pairs
            if a >= 2:
                m = torch.zeros(da, da, dtype=default_dtype(), device=dev)
                for i in range(a):
                    for j in range(i + 1, a):
                        m = m + Wset[i, j] * t(ud_row[i] @ du_row[j])
                rows.append(m)
                cols.append(torch.eye(db, dtype=default_dtype(), device=dev))
            # within-col pairs
            if b >= 2:
                m = torch.zeros(db, db, dtype=default_dtype(), device=dev)
                for i in range(b):
                    for j in range(i + 1, b):
                        m = m + Wset[a + i, a + j] * t(ud_col[i] @ du_col[j])
                rows.append(torch.eye(da, dtype=default_dtype(), device=dev))
                cols.append(m)
            # cross pairs grouped by row site
            if a and b:
                du_col_j = t(np.stack(du_col))  # (b, db, db)
                for i in range(a):
                    rows.append(t(ud_row[i]))
                    cols.append(_weighted_sum(Wset[i, a:], du_col_j))
            return rows, cols

        mask_end = self.samples_obj._slm_mask.end
        if mask_end > 0:
            # the full set off and the masked set (no pair with a masked
            # qubit) on inside the mask's window
            unmask = np.ones(self._size)
            for q in self.samples_obj._slm_mask.targets:
                unmask[self._qid_index[q]] = 0.0
            rows_f, cols_f = build_set(W)
            rows_m, cols_m = build_set(W * t(np.outer(unmask, unmask)))
            coeff = np.ones(self._duration - 1)
            coeff[:mask_end] = 0.0
            on = self._adapt_to_sampling_rate(t(coeff))[:n_samples]
            rows, cols = rows_f + rows_m, cols_f + cols_m
            zs = torch.stack([on] * len(rows_f) + [1.0 - on] * len(rows_m))
        else:
            rows, cols = build_set(W)
            zs = torch.ones(len(rows), n_samples, dtype=default_dtype(), device=dev)
        return torch.stack(rows), torch.stack(cols), Cplx(zs, torch.zeros_like(zs))

"""Noise configuration (counterpart of pulser_diff_tpu/simconfig.py).

``SimConfig`` is the user-facing configuration, ``NoiseModel`` the form
the Hamiltonian reads; the field names, defaults, units and checks are
the JAX package's.  Rate and probability parameters may be Python
numbers or torch tensors.

Every noise type is accepted here.  ``TorchEmulator.run`` runs the
stochastic ones (``doppler``, ``amplitude``) and SPAM as a Monte-Carlo
batch, and the Lindblad types (``dephasing``, ``relaxation``,
``depolarizing``, ``eff_noise``) on the master equation (``mesolve``) or
as quantum-jump trajectories (``solver="MCWF"``); a rate given as a
tensor carries its gradient.  ``leakage`` (with ``eff_noise``) extends
the basis by a dark level |x> a site.  ``to_pulser`` makes every tensor
parameter a Python float or a numpy array.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

# physical constants (pulser-simulation parity)
KB = 1.38e-23  # J/K
KEFF = 8.7  # rad/um  (effective wavevector of the Rydberg lasers)
MASS = 1.45e-25  # kg (Rb87)


def doppler_sigma(temperature: Any) -> Any:
    """Standard deviation of the Doppler detuning [rad/us] at
    ``temperature`` [K]; a tensor for a tensor, else a float."""
    if isinstance(temperature, torch.Tensor):
        return KEFF * torch.sqrt(KB * temperature / MASS)
    return KEFF * math.sqrt(KB * float(temperature) / MASS)


SUPPORTED_NOISES: dict[str, set[str]] = {
    "ising": {
        "amplitude",
        "dephasing",
        "depolarizing",
        "doppler",
        "eff_noise",
        "relaxation",
        "SPAM",
        "leakage",
    },
    "XY": {"SPAM", "eff_noise", "dephasing", "depolarizing", "leakage"},
}

NOISE_TYPES = (
    "dephasing",
    "relaxation",
    "depolarizing",
    "eff_noise",
    "doppler",
    "amplitude",
    "SPAM",
    "leakage",
)


def host_float(x: Any) -> float:
    """A parameter's value on the host (tensor, numpy or Python number)."""
    if isinstance(x, torch.Tensor):
        return float(x.detach().cpu())
    return float(np.asarray(x))


def _nonzero(x: Any) -> bool:
    try:
        return host_float(x) > 0
    except (TypeError, ValueError):
        return True


@dataclass(frozen=True)
class NoiseModel:
    """Physical noise model.  Units follow pulser: rates rad/us,
    temperature uK, laser_waist um (None: no waist damping)."""

    noise_types: Tuple[str, ...] = ()
    runs: int = 15
    samples_per_run: int = 5
    state_prep_error: Any = 0.0  # eta
    p_false_pos: Any = 0.0  # epsilon
    p_false_neg: Any = 0.0  # epsilon_prime
    temperature: Any = 50.0  # uK
    laser_waist: Optional[Any] = None  # um
    amp_sigma: Any = 0.0
    relaxation_rate: Any = 0.01
    dephasing_rate: Any = 0.05
    hyperfine_dephasing_rate: Any = 1e-3
    depolarizing_rate: Any = 0.05
    eff_noise_rates: Tuple[Any, ...] = ()
    eff_noise_opers: Tuple[Any, ...] = ()
    with_leakage: bool = False

    def __post_init__(self) -> None:
        if self.with_leakage and "leakage" not in self.noise_types:
            object.__setattr__(self, "noise_types", tuple(self.noise_types) + ("leakage",))
        if "leakage" in self.noise_types and not self.with_leakage:
            object.__setattr__(self, "with_leakage", True)
        unknown = set(self.noise_types) - set(NOISE_TYPES)
        if unknown:
            raise ValueError(f"Unknown noise types: {unknown}")
        if self.with_leakage and "eff_noise" not in self.noise_types:
            raise ValueError(
                "At least one effective noise operator must be defined to simulate leakage."
            )
        if "eff_noise" in self.noise_types:
            if len(self.eff_noise_rates) != len(self.eff_noise_opers):
                raise ValueError("eff_noise_rates and eff_noise_opers must have the same length.")
            if not self.eff_noise_opers:
                raise ValueError("eff_noise requires at least one operator.")
            for op in self.eff_noise_opers:
                arr = (op.detach().cpu().numpy() if isinstance(op, torch.Tensor)
                       else np.asarray(op))
                if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
                    raise ValueError("eff_noise operators must be square 2D.")

    @staticmethod
    def _find_relevant_params(
        noise_types: Sequence[str],
        state_prep_error: Any,
        amp_sigma: Any,
        laser_waist: Any,
    ) -> set[str]:
        params: set[str] = set()
        if "SPAM" in noise_types:
            params |= {"state_prep_error", "p_false_pos", "p_false_neg"}
            if _nonzero(state_prep_error):
                params |= {"runs", "samples_per_run"}
        if "doppler" in noise_types:
            params |= {"temperature", "runs", "samples_per_run"}
        if "amplitude" in noise_types:
            params |= {"amp_sigma"}
            if laser_waist is not None:
                params |= {"laser_waist"}
            if _nonzero(amp_sigma):
                params |= {"runs", "samples_per_run"}
        if "dephasing" in noise_types:
            params |= {"dephasing_rate", "hyperfine_dephasing_rate"}
        if "relaxation" in noise_types:
            params |= {"relaxation_rate"}
        if "depolarizing" in noise_types:
            params |= {"depolarizing_rate"}
        if "eff_noise" in noise_types:
            params |= {"eff_noise_rates", "eff_noise_opers"}
        if "leakage" in noise_types:
            params |= {"with_leakage"}
        return params


@dataclass(frozen=True)
class SimConfig:
    """User-facing simulation noise configuration (the JAX package's
    fields and defaults)."""

    noise: Tuple[str, ...] = ()
    runs: int = 15
    samples_per_run: int = 5
    eta: Any = 0.005
    epsilon: Any = 0.01
    epsilon_prime: Any = 0.05
    temperature: Any = 50.0  # uK
    laser_waist: Any = 175.0  # um; inf -> disabled
    amp_sigma: Any = 5e-2
    relaxation_rate: Any = 0.01
    dephasing_rate: Any = 0.05
    hyperfine_dephasing_rate: Any = 1e-3
    depolarizing_rate: Any = 0.05
    eff_noise_rates: Tuple[Any, ...] = ()
    eff_noise_opers: Tuple[Any, ...] = ()
    with_leakage: bool = False
    solver_options: Optional[dict] = None

    def __post_init__(self) -> None:
        if isinstance(self.noise, str):
            object.__setattr__(self, "noise", (self.noise,))
        if self.with_leakage and "leakage" not in self.noise:
            object.__setattr__(self, "noise", tuple(self.noise) + ("leakage",))
        if "leakage" in self.noise and not self.with_leakage:
            object.__setattr__(self, "with_leakage", True)
        unknown = set(self.noise) - set(NOISE_TYPES)
        if unknown:
            raise ValueError(f"Unknown noise types: {unknown}")

    @property
    def spam_dict(self) -> dict[str, Any]:
        return {
            "eta": self.eta,
            "epsilon": self.epsilon,
            "epsilon_prime": self.epsilon_prime,
        }

    @property
    def supported_noises(self) -> dict[str, set[str]]:
        return SUPPORTED_NOISES

    def to_pulser(self) -> "SimConfig":
        """A copy with every tensor parameter concrete: a 0-d tensor becomes
        a Python float and any other a numpy array (tuples element by
        element), whatever its device and whether it carries a gradient,
        as the JAX package's ``to_pulser`` does with its arrays."""

        def conv(v: Any) -> Any:
            if isinstance(v, torch.Tensor):
                arr = v.detach().cpu().numpy()
                return float(arr) if arr.ndim == 0 else arr
            return v

        return SimConfig(**{
            f.name: tuple(conv(x) for x in v) if isinstance(v, tuple) else conv(v)
            for f in dataclasses.fields(self) for v in (getattr(self, f.name),)})

    def to_noise_model(self) -> NoiseModel:
        """The NoiseModel equivalent: the parameters relevant to the noise
        types, and always ``runs`` / ``samples_per_run``."""
        lw = self.laser_waist
        lw_f = None
        if lw is not None:
            try:
                lw_f = None if math.isinf(host_float(lw)) else lw
            except TypeError:
                lw_f = lw
        relevant = NoiseModel._find_relevant_params(self.noise, self.eta, self.amp_sigma, lw_f)
        relevant |= {"runs", "samples_per_run"}
        kwargs: dict[str, Any] = {"noise_types": tuple(self.noise)}
        name_map = {
            "state_prep_error": "eta",
            "p_false_pos": "epsilon",
            "p_false_neg": "epsilon_prime",
        }
        for p in relevant:
            src = name_map.get(p, p)
            kwargs[p] = getattr(self, src) if src != "laser_waist" else lw_f
        return NoiseModel(**kwargs)

    @classmethod
    def from_noise_model(cls, nm: NoiseModel) -> "SimConfig":
        return cls(
            noise=tuple(nm.noise_types),
            runs=nm.runs,
            samples_per_run=nm.samples_per_run,
            eta=nm.state_prep_error,
            epsilon=nm.p_false_pos,
            epsilon_prime=nm.p_false_neg,
            temperature=nm.temperature,
            laser_waist=nm.laser_waist if nm.laser_waist is not None else float("inf"),
            amp_sigma=nm.amp_sigma,
            relaxation_rate=nm.relaxation_rate,
            dephasing_rate=nm.dephasing_rate,
            hyperfine_dephasing_rate=nm.hyperfine_dephasing_rate,
            depolarizing_rate=nm.depolarizing_rate,
            eff_noise_rates=tuple(nm.eff_noise_rates),
            eff_noise_opers=tuple(nm.eff_noise_opers),
            with_leakage=nm.with_leakage,
        )

    def __str__(self, solver_options: bool = False) -> str:
        lines = [
            "Options:",
            "----------",
            f"Number of runs:        {self.runs}",
            f"Samples per run:       {self.samples_per_run}",
        ]
        if self.noise:
            lines.append("Noise types:           " + ", ".join(self.noise))
        if "SPAM" in self.noise:
            lines.append(f"SPAM dictionary:       {self.spam_dict}")
        if "eff_noise" in self.noise:
            lines.append(f"Effective noise rates: {self.eff_noise_rates}")
        if "doppler" in self.noise:
            lines.append(f"Temperature:           {self.temperature}uK")
        if "amplitude" in self.noise:
            lines.append(f"Laser waist:           {self.laser_waist}um")
            lines.append(f"Amplitude standard dev.:  {self.amp_sigma}")
        if "dephasing" in self.noise:
            lines.append(f"Dephasing rate: {self.dephasing_rate}")
        if "relaxation" in self.noise:
            lines.append(f"Relaxation rate: {self.relaxation_rate}")
        if "depolarizing" in self.noise:
            lines.append(f"Depolarizing rate: {self.depolarizing_rate}")
        if solver_options and self.solver_options:
            lines.append(f"Solver options: {self.solver_options}")
        return "\n".join(lines)

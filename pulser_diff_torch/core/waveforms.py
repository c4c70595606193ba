"""Waveforms (counterpart of pulser_diff_tpu/core/waveforms.py).

Every shape parameter (value, start/stop, area, sample arrays,
interpolation control points) may be a tensor or a deferred
:class:`~.variables.Expr`, and ``samples`` is differentiable with respect
to all of them.  Durations are integer nanoseconds; samples are one value
per ns in rad/us.  Blackman and Kaiser waveforms are parametrized by
their area (rad): ``sum(samples) * 1e-3 == area``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pulser_diff_torch.config import default_dtype
from pulser_diff_torch.core.variables import Expr, evaluate


def _as_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(default_dtype())
    if isinstance(x, (list, tuple)) and any(isinstance(v, torch.Tensor) for v in x):
        return torch.stack([_as_tensor(v) for v in x])
    return torch.as_tensor(x, dtype=default_dtype())


def _host_int(x: Any) -> int:
    """A duration evaluated from variables, rounded to whole ns."""
    if isinstance(x, int):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return int(np.round(float(np.asarray(x))))


class Waveform:
    """Base class.  Subclasses define ``_samples()`` over concrete params."""

    _param_names: tuple[str, ...] = ()

    def __init__(self, duration: Any) -> None:
        self._duration = duration

    @property
    def duration(self) -> int:
        if isinstance(self._duration, Expr):
            raise ValueError(
                "Waveform duration is still parametrized; call build() first."
            )
        return int(self._duration)

    @property
    def is_parametrized(self) -> bool:
        if isinstance(self._duration, Expr):
            return True
        return any(isinstance(getattr(self, n), Expr) for n in self._param_names)

    def build(self, values: Mapping[str, Any]) -> "Waveform":
        """Substitute variable values, returning a concrete waveform."""
        if not self.is_parametrized:
            return self
        kwargs = {n: evaluate(getattr(self, n), values) for n in self._param_names}
        return type(self)(_host_int(evaluate(self._duration, values)), **kwargs)

    @property
    def samples(self) -> torch.Tensor:
        """One sample per ns; differentiable in the waveform parameters."""
        if self.is_parametrized:
            raise ValueError(
                "Cannot sample a parametrized waveform; call build() first."
            )
        return self._samples()

    def _samples(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def first_value(self) -> torch.Tensor:
        return self.samples[0]

    @property
    def last_value(self) -> torch.Tensor:
        return self.samples[-1]

    @property
    def integral(self) -> torch.Tensor:
        """Waveform integral in rad (samples are rad/us, steps are ns)."""
        return self.samples.sum() * 1e-3

    def change_duration(self, new_duration: int) -> "Waveform":
        raise NotImplementedError(
            f"{type(self).__name__} cannot be stretched/contracted."
        )

    def modulated_samples(self, channel) -> torch.Tensor:
        """Samples after the channel's modulation-bandwidth transfer
        function, extended by the rise/fall tail."""
        return channel.modulate(self.samples)

    def draw(self, output_channel=None, fig_name: str | None = None,
             kwargs_savefig: dict = {}) -> None:
        """Plot the waveform (pulser's ``Waveform.draw``); with an
        ``output_channel``, overlay the modulated output."""
        import matplotlib.pyplot as plt

        from pulser_diff_torch.core.drawing import to_host

        s = to_host(self.samples)
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(np.arange(s.shape[0]), s, color="darkgreen", label="input")
        if output_channel is not None:
            m = to_host(self.modulated_samples(output_channel))
            ax.plot(np.arange(m.shape[0]), m, color="crimson", linestyle="--",
                    label="modulated output")
            ax.legend()
        ax.set_xlabel("t (ns)")
        ax.set_ylabel("value (rad/µs)")
        if fig_name is not None:
            plt.savefig(fig_name, **kwargs_savefig)
        plt.show()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Waveform):
            return NotImplemented
        try:
            mine = self.samples
            return self.duration == other.duration and bool(
                torch.allclose(mine, other.samples.to(mine.device)))
        except ValueError:
            return NotImplemented

    def __hash__(self) -> int:
        return id(self)


class ConstantWaveform(Waveform):
    """Constant-valued waveform."""

    _param_names = ("value",)

    def __init__(self, duration: Any, value: Any) -> None:
        super().__init__(duration)
        self.value = value

    def _samples(self) -> torch.Tensor:
        return _as_tensor(self.value).expand(self.duration)

    def change_duration(self, new_duration: int) -> "ConstantWaveform":
        return ConstantWaveform(new_duration, self.value)

    def __repr__(self) -> str:
        return f"ConstantWaveform({self._duration}, {self.value})"


class RampWaveform(Waveform):
    """Linear ramp from ``start`` to ``stop``."""

    _param_names = ("start", "stop")

    def __init__(self, duration: Any, start: Any, stop: Any) -> None:
        super().__init__(duration)
        self.start = start
        self.stop = stop

    def _samples(self) -> torch.Tensor:
        d = self.duration
        start, stop = _as_tensor(self.start), _as_tensor(self.stop)
        frac = torch.arange(d, dtype=default_dtype(), device=start.device) / max(d - 1, 1)
        return start + (stop - start) * frac

    @property
    def slope(self) -> torch.Tensor:
        return (_as_tensor(self.stop) - _as_tensor(self.start)) / ((self.duration - 1) * 1e-3)

    def __repr__(self) -> str:
        return f"RampWaveform({self._duration}, {self.start}, {self.stop})"


def _blackman_window(n: int, device=None) -> torch.Tensor:
    if n == 1:
        return torch.ones(1, dtype=default_dtype(), device=device)
    x = 2.0 * np.pi * torch.arange(n, dtype=default_dtype(), device=device) / (n - 1)
    return 0.42 - 0.5 * torch.cos(x) + 0.08 * torch.cos(2 * x)


class BlackmanWaveform(Waveform):
    """Blackman window scaled to a target pulse area."""

    _param_names = ("area",)

    def __init__(self, duration: Any, area: Any) -> None:
        super().__init__(duration)
        self.area = area

    @classmethod
    def from_max_val(cls, max_val: float, area: Any) -> "BlackmanWaveform":
        """Shortest Blackman waveform of the given area whose peak stays at
        or below ``max_val`` (exact search, on the host)."""
        area_f = float(_as_tensor(area).detach())
        if area_f * max_val < 0:
            raise ValueError("area and max_val must have matching signs")
        duration = _shortest_duration_for_peak(
            lambda d: np.clip(np.blackman(d), 0.0, None), area_f, max_val)
        return cls(duration, area)

    def _samples(self) -> torch.Tensor:
        area = _as_tensor(self.area)
        w = torch.clamp(_blackman_window(self.duration, area.device), min=0.0)
        return w * (area / (w.sum() * 1e-3))

    def change_duration(self, new_duration: int) -> "BlackmanWaveform":
        return BlackmanWaveform(new_duration, self.area)

    def __repr__(self) -> str:
        return f"BlackmanWaveform({self._duration}, {self.area})"


def _shortest_duration_for_peak(window_np, area_f: float, max_val: float) -> int:
    """Smallest duration whose area-normalized window peak
    ``max(w) * |area| / (sum(w) * 1e-3)`` stays at or below ``|max_val|``:
    the peak scales ~1/duration, so bracket by doubling and bisect."""

    def peak(duration: int) -> float:
        w = window_np(duration)
        s = float(w.sum())
        if s <= 0.0:
            return float("inf")  # degenerate (e.g. 1-sample) window
        return float(w.max()) * abs(area_f) / (s * 1e-3)

    hi = 1
    while peak(hi) > abs(max_val):
        hi *= 2
        if hi > 10_000_000:
            raise ValueError("area/max_val combination needs an unreasonable duration.")
    lo = hi // 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if mid == 0 or peak(mid) > abs(max_val):
            lo = mid
        else:
            hi = mid
    return hi


def _kaiser_window(n: int, beta: float, device=None) -> torch.Tensor:
    if n == 1:
        return torch.ones(1, dtype=default_dtype(), device=device)
    r = 2.0 * torch.arange(n, dtype=default_dtype(), device=device) / (n - 1) - 1.0
    num = torch.special.i0(beta * torch.sqrt(torch.clamp(1 - r * r, min=0.0)))
    return num / torch.special.i0(torch.as_tensor(beta, dtype=default_dtype(), device=device))


class KaiserWaveform(Waveform):
    """Kaiser window scaled to a target pulse area."""

    _param_names = ("area",)

    def __init__(self, duration: Any, area: Any, beta: float = 14.6) -> None:
        super().__init__(duration)
        self.area = area
        self.beta = beta

    def build(self, values: Mapping[str, Any]) -> "KaiserWaveform":
        if not self.is_parametrized:
            return self
        return KaiserWaveform(_host_int(evaluate(self._duration, values)),
                              evaluate(self.area, values), self.beta)

    def _samples(self) -> torch.Tensor:
        area = _as_tensor(self.area)
        w = _kaiser_window(self.duration, self.beta, area.device)
        return w * (area / (w.sum() * 1e-3))

    @classmethod
    def from_max_val(cls, max_val: float, area: Any, beta: float = 14.6) -> "KaiserWaveform":
        """Shortest Kaiser waveform of the given area whose peak does not
        exceed ``max_val`` (the sign of ``max_val`` bounds the signed area)."""
        area_f = float(_as_tensor(area).detach())
        if max_val * area_f < 0:
            raise ValueError("max_val and area must have matching signs.")
        duration = _shortest_duration_for_peak(lambda d: np.kaiser(d, beta), area_f, max_val)
        return cls(duration, area, beta)

    def change_duration(self, new_duration: int) -> "KaiserWaveform":
        return KaiserWaveform(new_duration, self.area, self.beta)

    def __repr__(self) -> str:
        return f"KaiserWaveform({self._duration}, {self.area}, beta={self.beta})"


class CustomWaveform(Waveform):
    """Waveform from an explicit per-ns sample array."""

    _param_names = ("_sample_arr",)

    def __init__(self, samples: Any, duration: Any = None) -> None:
        self._sample_arr = samples
        if duration is None:
            if isinstance(samples, Expr):
                raise ValueError(
                    "CustomWaveform with a variable sample array needs an "
                    "explicit duration."
                )
            duration = len(samples)
        super().__init__(duration)

    def build(self, values: Mapping[str, Any]) -> "CustomWaveform":
        if not self.is_parametrized:
            return self
        return CustomWaveform(_as_tensor(evaluate(self._sample_arr, values)))

    def _samples(self) -> torch.Tensor:
        return _as_tensor(self._sample_arr)

    def __repr__(self) -> str:
        return f"CustomWaveform(<{self._duration} samples>)"


def pchip_interpolate(x: Any, y: Any, t: torch.Tensor) -> torch.Tensor:
    """Differentiable PCHIP (Fritsch-Carlson monotone cubic) interpolation
    with scipy's PchipInterpolator derivative rules; differentiable in
    ``y`` (and in ``x`` almost everywhere)."""
    x, y = _as_tensor(x), _as_tensor(y)
    n = x.shape[0]
    if n == 1:
        return y[0].expand(t.shape)
    h = torch.diff(x)
    m = torch.diff(y) / h
    if n == 2:
        d = torch.stack([m[0], m[0]])
    else:
        # interior derivatives: weighted harmonic mean where slopes agree
        w1 = 2 * h[1:] + h[:-1]
        w2 = h[1:] + 2 * h[:-1]
        one = torch.ones_like(m[:-1])
        whmean = (w1 + w2) / (w1 / torch.where(m[:-1] == 0, one, m[:-1])
                              + w2 / torch.where(m[1:] == 0, one, m[1:]))
        cond = (torch.sign(m[:-1]) * torch.sign(m[1:])) > 0
        d_int = torch.where(cond, whmean, torch.zeros_like(whmean))

        def _edge(h0, h1, m0, m1):
            d0 = ((2 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
            d0 = torch.where(torch.sign(d0) != torch.sign(m0), torch.zeros_like(d0), d0)
            return torch.where(
                (torch.sign(m0) != torch.sign(m1)) & (torch.abs(d0) > 3 * torch.abs(m0)),
                3 * m0, d0)

        d0 = _edge(h[0], h[1], m[0], m[1])
        dn = _edge(h[-1], h[-2], m[-1], m[-2])
        d = torch.cat([d0[None], d_int, dn[None]])
    idx = torch.clamp(torch.searchsorted(x.detach().contiguous(), t.contiguous(), right=True) - 1,
                      0, n - 2)
    xk, hk = x[idx], h[idx]
    s_ = (t - xk) / hk
    yk, yk1 = y[idx], y[idx + 1]
    dk, dk1 = d[idx], d[idx + 1]
    # cubic Hermite basis
    h00 = (1 + 2 * s_) * (1 - s_) ** 2
    h10 = s_ * (1 - s_) ** 2
    h01 = s_ * s_ * (3 - 2 * s_)
    h11 = s_ * s_ * (s_ - 1)
    return h00 * yk + h10 * hk * dk + h01 * yk1 + h11 * hk * dk1


class InterpolatedWaveform(Waveform):
    """PCHIP interpolation through control values; gradients flow through
    ``values`` (and ``times``)."""

    _param_names = ("values", "times")

    def __init__(self, duration: Any, values: Any, times: Any = None) -> None:
        super().__init__(duration)
        self.values = values
        self.times = times

    def build(self, values_map: Mapping[str, Any]) -> "InterpolatedWaveform":
        if not self.is_parametrized:
            return self
        return InterpolatedWaveform(
            _host_int(evaluate(self._duration, values_map)),
            evaluate(self.values, values_map),
            evaluate(self.times, values_map) if self.times is not None else None,
        )

    def _samples(self) -> torch.Tensor:
        vals = _as_tensor(self.values)
        n = vals.shape[0]
        if self.times is None:
            tfrac = torch.linspace(0.0, 1.0, n, dtype=default_dtype(), device=vals.device)
        else:
            tfrac = _as_tensor(self.times).to(vals.device)
        x = tfrac * (self.duration - 1)
        t = torch.arange(self.duration, dtype=default_dtype(), device=vals.device)
        return pchip_interpolate(x, vals, t)

    def change_duration(self, new_duration: int) -> "InterpolatedWaveform":
        return InterpolatedWaveform(new_duration, self.values, self.times)

    def __repr__(self) -> str:
        return f"InterpolatedWaveform({self._duration}, {self.values})"


class CompositeWaveform(Waveform):
    """Concatenation of waveforms."""

    def __init__(self, *waveforms: Waveform) -> None:
        if not waveforms:
            raise ValueError("CompositeWaveform needs at least one waveform.")
        self._waveforms = list(waveforms)
        super().__init__(None)

    @property
    def waveforms(self) -> list[Waveform]:
        return list(self._waveforms)

    @property
    def duration(self) -> int:
        return sum(w.duration for w in self._waveforms)

    @property
    def is_parametrized(self) -> bool:
        return any(w.is_parametrized for w in self._waveforms)

    def build(self, values: Mapping[str, Any]) -> "CompositeWaveform":
        return CompositeWaveform(*[w.build(values) for w in self._waveforms])

    @property
    def samples(self) -> torch.Tensor:
        parts = [w.samples for w in self._waveforms]
        dev = next((p.device for p in parts if p.device.type != "cpu"), parts[0].device)
        return torch.cat([p.to(dev) for p in parts])

    def __repr__(self) -> str:
        return f"CompositeWaveform({self._waveforms})"

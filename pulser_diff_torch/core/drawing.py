"""Channel-sample plotting shared by ``TorchEmulator.draw`` and
``Sequence.draw`` (counterpart of pulser_diff_tpu/core/drawing.py).

matplotlib is imported inside the functions that draw, so that importing
the package does not need it.
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """A tensor (on any device, with or without a graph) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_channel_samples(
    channel_samples: dict,
    draw_phase_area: bool = False,
    draw_phase_shifts: bool = False,
    draw_phase_curve: bool = False,
    fig_name: str | None = None,
    kwargs_savefig: dict = {},
) -> None:
    """Plot per-channel amp/det(/phase) streams.

    ``draw_phase_area`` annotates each pulse with its area (multiples of
    pi) and phase; ``draw_phase_shifts`` marks the instants where the
    carrier phase changes with dashed lines and labels; ``draw_phase_curve``
    overlays the phase stream on a twin axis.
    """
    import matplotlib.pyplot as plt

    if not channel_samples:
        raise ValueError("Nothing to draw: no declared channels with samples.")
    n = len(channel_samples)
    fig, axes = plt.subplots(2 * n, 1, sharex=True, figsize=(10, 3 * n))
    axes = np.ravel(np.atleast_1d(axes))
    for i, (name, cs) in enumerate(channel_samples.items()):
        t = np.arange(cs.duration)
        amp, det, ph = to_host(cs.amp), to_host(cs.det), to_host(cs.phase)
        ax_a, ax_d = axes[2 * i], axes[2 * i + 1]
        ax_a.fill_between(t, 0, amp, color="darkgreen", alpha=0.4)
        ax_a.plot(t, amp, color="darkgreen")
        ax_a.set_ylabel(f"{name}\nΩ (rad/µs)")
        ax_d.fill_between(t, 0, det, color="indigo", alpha=0.3)
        ax_d.plot(t, det, color="indigo")
        ax_d.set_ylabel("δ (rad/µs)")
        if draw_phase_area:
            top = float(amp.max()) if amp.size else 1.0
            for sl in cs.slots:
                if sl.tf <= sl.ti:
                    continue
                seg = amp[sl.ti : sl.tf]
                if seg.size == 0 or float(np.abs(seg).max()) == 0.0:
                    continue
                area = float(seg.sum()) / 1000.0  # rad (ns * rad/us)
                phase_val = float(ph[sl.ti])
                mid = 0.5 * (sl.ti + sl.tf)
                label = f"A: {area / np.pi:.3g}π"
                if phase_val != 0.0:
                    label += f"\nφ: {phase_val / np.pi:.3g}π"
                ax_a.text(mid, 1.02 * top, label, ha="center", va="bottom", fontsize=8,
                          color="darkgreen")
        if draw_phase_shifts:
            # instants where the carrier phase jumps between slots
            jumps = np.nonzero(np.abs(np.diff(ph)) > 1e-12)[0] + 1
            for tj in jumps:
                for ax in (ax_a, ax_d):
                    ax.axvline(tj, linestyle="--", color="gray", alpha=0.6)
                ax_a.text(tj, 0.0, f"{float(ph[tj]) / np.pi:.3g}π", ha="left", va="bottom",
                          fontsize=7, color="gray", rotation=90)
        if draw_phase_curve:
            ax2 = ax_a.twinx()
            ax2.plot(t, ph, color="crimson", linestyle="--")
            ax2.set_ylabel("phase (rad)")
    axes[-1].set_xlabel("t (ns)")
    if fig_name is not None:
        plt.savefig(fig_name, **kwargs_savefig)
    plt.show()

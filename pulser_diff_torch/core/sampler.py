"""Sequence sampling: Sequence -> per-channel amp/det/phase tensors
(counterpart of pulser_diff_tpu/core/sampler.py, without modulation).

One sample per ns; amplitude/detuning in rad/us, phase in rad.  The
samples are built by concatenating per-slot waveform samples on the
requested device, so sampling is differentiable w.r.t. pulse parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch

from pulser_diff_torch.config import DTYPE, DeviceLike, resolve_device
from pulser_diff_torch.core.channels import Channel
from pulser_diff_torch.core.register import QubitId
from pulser_diff_torch.core.sequence import Sequence


@dataclass
class _PulseTargetSlot:
    ti: int
    tf: int
    targets: frozenset


@dataclass
class ChannelSamples:
    """Sampled tensors for one channel."""

    amp: torch.Tensor
    det: torch.Tensor
    phase: torch.Tensor
    slots: list[_PulseTargetSlot]
    addressing: str
    basis: str

    @property
    def duration(self) -> int:
        return int(self.amp.shape[0])

    def extend_duration(self, new_duration: int, hold_edge: bool = False) -> "ChannelSamples":
        """Pad samples to ``new_duration``; ``hold_edge=True`` repeats the
        final amp/det sample instead of zero-padding (the emulator's +1
        closing sample)."""
        T = self.duration
        if new_duration < T:
            raise ValueError("Cannot shrink samples.")
        if new_duration == T:
            return self
        pad = new_duration - T
        if T > 0 and hold_edge:
            pad_amp = self.amp[-1].expand(pad)
            pad_det = self.det[-1].expand(pad)
        else:
            pad_amp = pad_det = self.amp.new_zeros(pad)
        last_phase = self.phase[-1] if T > 0 else self.amp.new_zeros(())
        return replace(
            self,
            amp=torch.cat([self.amp, pad_amp]),
            det=torch.cat([self.det, pad_det]),
            phase=torch.cat([self.phase, last_phase.expand(pad)]),
        )


@dataclass
class SequenceSamples:
    """All channels of a sampled sequence + sequence-level metadata."""

    channel_samples: dict[str, ChannelSamples]
    _magnetic_field: np.ndarray
    _in_xy: bool
    qubit_ids: tuple[QubitId, ...]

    @property
    def max_duration(self) -> int:
        return max((cs.duration for cs in self.channel_samples.values()), default=0)

    def extend_duration(self, new_duration: int, hold_edge: bool = False) -> "SequenceSamples":
        return replace(
            self,
            channel_samples={
                k: v.extend_duration(new_duration, hold_edge)
                for k, v in self.channel_samples.items()
            },
        )

    def globalize(self, qubit_ids: tuple[QubitId, ...]) -> "SequenceSamples":
        """Replace Global channels' slot targets with the full register."""
        new = {}
        for name, cs in self.channel_samples.items():
            if cs.addressing == "Global":
                cs = replace(
                    cs,
                    slots=[_PulseTargetSlot(s.ti, s.tf, frozenset(qubit_ids)) for s in cs.slots],
                )
            new[name] = cs
        return replace(self, channel_samples=new, qubit_ids=tuple(qubit_ids))

    def to_nested_dict(self, all_local: bool = False) -> dict:
        """{"Global": {basis: {amp, det, phase}}, "Local": {basis: {qid:
        {amp, det, phase}}}}: the sum of the channels of each basis
        ("ground-rydberg", or "XY" for the microwave channel), the phase
        taken where the amplitude is on.  ``all_local=True`` (per-qubit
        noise) scatters each global channel to every qubit of the
        register, in the order of the qubit ids as strings, as the JAX
        package does; the port has no Local channels or SLM mask yet."""
        T = self.max_duration
        out: dict[str, Any] = {"Global": {}, "Local": {}}

        def _add(tgt: dict, cs: ChannelSamples) -> None:
            if not tgt:
                zeros = cs.amp.new_zeros(T)
                tgt.update(amp=zeros, det=zeros, phase=zeros)
            tgt["amp"] = tgt["amp"] + cs.amp
            tgt["det"] = tgt["det"] + cs.det
            tgt["phase"] = torch.where(cs.amp != 0, cs.phase, tgt["phase"])

        for cs in self.channel_samples.values():
            if not cs.slots:
                continue
            if not all_local:
                _add(out["Global"].setdefault(cs.basis, {}), cs)
                continue
            by_qubit = out["Local"].setdefault(cs.basis, {})
            for qid in sorted(self.qubit_ids, key=str):
                _add(by_qubit.setdefault(qid, {}), cs)
        return out


def _sample_channel(seq: Sequence, name: str, ch: Channel, total: int,
                    device: torch.device) -> ChannelSamples:
    amps: list[torch.Tensor] = []
    dets: list[torch.Tensor] = []
    phases: list[torch.Tensor] = []
    slots: list[_PulseTargetSlot] = []
    cursor = 0
    last_phase = torch.zeros((), dtype=DTYPE, device=device)

    def idle(n: int) -> None:
        amps.append(torch.zeros(n, dtype=DTYPE, device=device))
        dets.append(torch.zeros(n, dtype=DTYPE, device=device))
        phases.append(last_phase.expand(n))

    for slot in seq._schedule[name]:
        if slot.ti > cursor:
            idle(slot.ti - cursor)
            cursor = slot.ti
        n = slot.tf - slot.ti
        if slot.kind == "pulse":
            p = slot.pulse
            amps.append(p.amplitude.samples.to(device=device, dtype=DTYPE))
            dets.append(p.detuning.samples.to(device=device, dtype=DTYPE))
            ph = torch.as_tensor(p.phase, dtype=DTYPE).to(device)
            phases.append(ph.expand(n))
            last_phase = ph
            slots.append(_PulseTargetSlot(slot.ti, slot.tf, slot.targets))
        elif n > 0:
            idle(n)
        cursor = slot.tf
    if cursor < total:
        idle(total - cursor)
    if amps:
        amp, det, phase = torch.cat(amps), torch.cat(dets), torch.cat(phases)
    else:
        amp = det = phase = torch.zeros(total, dtype=DTYPE, device=device)
    return ChannelSamples(amp, det, phase, slots, ch.addressing, ch.basis)


def sample(
    seq: Sequence,
    extended_duration: Optional[int] = None,
    device: DeviceLike = None,
) -> SequenceSamples:
    """Sample a (concrete) Sequence into per-channel tensors on ``device``
    (CUDA unless given)."""
    if seq.is_parametrized():
        raise ValueError("Cannot sample a parametrized sequence; build() it.")
    device = resolve_device(device)
    total = seq.get_duration()
    chs = {
        name: _sample_channel(seq, name, ch, total, device)
        for name, ch in seq.declared_channels.items()
    }
    ss = SequenceSamples(
        channel_samples=chs,
        _magnetic_field=seq.magnetic_field,
        _in_xy=seq._in_xy,
        qubit_ids=seq.register.qubit_ids,
    )
    if extended_duration is not None:
        ss = ss.extend_duration(extended_duration)
    return ss

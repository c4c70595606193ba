"""Sequence sampling: Sequence -> per-channel amp/det/phase tensors
(counterpart of pulser_diff_tpu/core/sampler.py).

One sample per ns; amplitude/detuning in rad/us, phase in rad (each
pulse's phase plus its targets' phase reference).  The samples are built
by concatenating per-slot waveform samples on the requested device, so
sampling is differentiable in the pulse parameters.  With
``modulation=True`` each channel's output goes through its transfer
function (the EOM's inside EOM blocks).  ``to_nested_dict`` sums the
channels of each basis, scattering Local channels (and, under an ising
SLM mask, the Global ones) to one stream per qubit.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pulser_diff_torch.config import DeviceLike, default_dtype, resolve_device
from pulser_diff_torch.core.channels import Channel
from pulser_diff_torch.core.register import QubitId
from pulser_diff_torch.core.sequence import Sequence


@dataclass
class _PulseTargetSlot:
    ti: int
    tf: int
    targets: frozenset


@dataclass
class _SlmMask:
    targets: frozenset = frozenset()
    end: int = 0


@dataclass
class ChannelSamples:
    """Sampled tensors for one channel."""

    amp: torch.Tensor
    det: torch.Tensor
    phase: torch.Tensor
    slots: list[_PulseTargetSlot]
    addressing: str
    basis: str
    # closed [ti, tf) EOM-mode intervals (ns): the drive is modulated with
    # the EOM's bandwidth instead of the channel's inside them
    eom_blocks: list = None

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
    _measurement: Optional[str] = None
    _slm_mask: _SlmMask = field(default_factory=_SlmMask)

    @property
    def max_duration(self) -> int:
        return max((cs.duration for cs in self.channel_samples.values()), default=0)

    @property
    def used_bases(self) -> set[str]:
        return {cs.basis for cs in self.channel_samples.values() if cs.slots}

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
        {amp, det, phase}}}}: the sum of the channels of each basis, the
        phase taken where the amplitude is on.  A Local channel gives each
        qubit it targets its streams inside that qubit's slots.
        ``all_local=True`` (per-qubit noise) scatters each Global channel
        to every qubit of the register too, as does an SLM mask in ising
        mode, which zeroes the masked qubits' amplitude in its window.
        Qubits go in the order of their ids as strings."""
        T = self.max_duration
        slm_on = self._slm_mask.end > 0 and not self._in_xy
        out: dict[str, Any] = {"Global": {}, "Local": {}}

        def _add(tgt: dict, amp, det, phase) -> None:
            if not tgt:
                zeros = amp.new_zeros(T)
                tgt.update(amp=zeros, det=zeros, phase=zeros)
            tgt["amp"] = tgt["amp"] + amp
            tgt["det"] = tgt["det"] + det
            tgt["phase"] = torch.where(amp != 0, phase, tgt["phase"])

        for cs in self.channel_samples.values():
            if not cs.slots:
                continue
            local = cs.addressing == "Local"
            if not (local or all_local or slm_on):
                _add(out["Global"].setdefault(cs.basis, {}), cs.amp, cs.det, cs.phase)
                continue
            by_qubit = out["Local"].setdefault(cs.basis, {})
            targets = set().union(*(s.targets for s in cs.slots)) if local else self.qubit_ids
            for qid in sorted(targets, key=str):
                amp_q, det_q, phase_q = cs.amp, cs.det, cs.phase
                if local:
                    mask = np.zeros(T, dtype=bool)
                    for s in cs.slots:
                        if qid in s.targets:
                            mask[s.ti : s.tf] = True
                    m = torch.as_tensor(mask, device=cs.amp.device)
                    zero = cs.amp.new_zeros(())
                    amp_q, det_q, phase_q = (torch.where(m, x, zero) for x in (amp_q, det_q,
                                                                                 phase_q))
                if slm_on and qid in self._slm_mask.targets:
                    win = torch.zeros(T, dtype=torch.bool, device=cs.amp.device)
                    win[: self._slm_mask.end] = True
                    amp_q = torch.where(win, cs.amp.new_zeros(()), amp_q)
                _add(by_qubit.setdefault(qid, {}), amp_q, det_q, phase_q)
        return out


def _sample_channel(seq: Sequence, name: str, ch: Channel, total: int,
                    device: torch.device) -> ChannelSamples:
    amps: list[torch.Tensor] = []
    dets: list[torch.Tensor] = []
    phases: list[torch.Tensor] = []
    slots: list[_PulseTargetSlot] = []
    cursor = 0
    dt = default_dtype()
    last_phase = torch.zeros((), dtype=dt, device=device)

    def idle(n: int, det: float = 0.0) -> None:
        amps.append(torch.zeros(n, dtype=dt, device=device))
        dets.append(torch.full((n,), det, dtype=dt, device=device))
        phases.append(last_phase.expand(n))

    def tensor(x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dt).to(device)

    for slot in seq._schedule[name]:
        if slot.ti > cursor:
            idle(slot.ti - cursor)
            cursor = slot.ti
        n = slot.tf - slot.ti
        if slot.kind == "pulse" and slot.pulse is not None:
            p = slot.pulse
            amps.append(p.amplitude.samples.to(device=device, dtype=dt))
            dets.append(p.detuning.samples.to(device=device, dtype=dt))
            # the targets' phase reference at add time (phase_shift and
            # post_phase_shift, shared by the channels of the basis)
            ph = tensor(p.phase) + tensor(slot.phase_ref)
            phases.append(ph.expand(n))
            last_phase = ph
            slots.append(_PulseTargetSlot(slot.ti, slot.tf, slot.targets))
        elif n > 0:
            # EOM-mode waits idle at the locked off-detuning
            idle(n, slot.det_off if slot.kind == "eom_delay" else 0.0)
        cursor = slot.tf
    if cursor < total:
        idle(total - cursor)
    if amps:
        amp, det, phase = torch.cat(amps), torch.cat(dets), torch.cat(phases)
    else:
        amp = det = phase = torch.zeros(total, dtype=dt, device=device)
    blocks = [(int(ti), int(tf) if tf is not None else total)
              for ti, tf in seq._eom_blocks.get(name, [])]
    return ChannelSamples(amp, det, phase, slots, ch.addressing, ch.basis, eom_blocks=blocks)


def _modulate(cs: ChannelSamples, ch: Channel) -> ChannelSamples:
    """The channel's output modulation (``Channel.apply_modulation``): the
    amplitude decays to zero past the programmed end, detuning and phase
    hold their boundary values; the output is longer by the fall time.

    With EOM blocks, the JAX package's masked composition: the full
    amplitude and detuning streams are modulated twice, with the
    channel's bandwidth and with the EOM's, and the output takes the
    EOM-modulated samples inside each block plus its 2 eom_rise_time
    fall window (after a closed block; the whole tail after a block that
    stays open), and the standard ones elsewhere.  The phase always takes
    the standard response."""
    eom = ch.eom_config
    std_rise = ch.rise_time
    if cs.eom_blocks and eom is not None:
        T = cs.duration
        eom_rise = eom.rise_time
        eom_fall = 2 * eom_rise

        def _extend(a: torch.Tensor, n: int, keep_ends: bool) -> torch.Tensor:
            pad = n - a.shape[0]
            if pad <= 0:
                return a
            if keep_ends and a.shape[0] > 0:
                return torch.cat([a, a[-1].expand(pad)])
            return F.pad(a, (0, pad))

        def comp(x: torch.Tensor, keep_ends: bool) -> torch.Tensor:
            mod_std = Channel.apply_modulation(x, std_rise, keep_ends) if std_rise else x
            mod_eom = Channel.apply_modulation(x, eom_rise, keep_ends) if eom_rise else x
            n = max(mod_std.shape[0], mod_eom.shape[0])
            mod_std, mod_eom = _extend(mod_std, n, keep_ends), _extend(mod_eom, n, keep_ends)
            mask = np.zeros(n, dtype=bool)
            for ti, tf in cs.eom_blocks:
                mask[ti:tf] = True
                if tf < T:  # closed block: the EOM decay rides its fall time
                    mask[tf : min(tf + eom_fall, n)] = True
                else:  # the sequence ends in EOM mode: the tail stays EOM
                    mask[tf:] = True
            return torch.where(torch.as_tensor(mask, device=x.device), mod_eom, mod_std)

        return replace(
            cs,
            amp=comp(cs.amp, False),
            det=comp(cs.det, True),
            phase=Channel.apply_modulation(cs.phase, std_rise, True) if std_rise else cs.phase,
        )
    if ch.mod_bandwidth is None or std_rise == 0:
        return cs
    return replace(
        cs,
        amp=ch.modulate(cs.amp, keep_ends=False),
        det=ch.modulate(cs.det, keep_ends=True),
        phase=ch.modulate(cs.phase, keep_ends=True),
    )


def sample(
    seq: Sequence,
    modulation: bool = False,
    extended_duration: Optional[int] = None,
    device: DeviceLike = None,
) -> SequenceSamples:
    """Sample a (concrete) Sequence into per-channel tensors on ``device``
    (CUDA unless given); ``modulation=True`` applies the channels' output
    modulation, every channel cut or padded to the sequence's duration
    with its fall time."""
    if seq.is_parametrized():
        raise ValueError("Cannot sample a parametrized sequence; build() it.")
    device = resolve_device(device)
    total = seq.get_duration()
    chs: dict[str, ChannelSamples] = {}
    for name, ch in seq.declared_channels.items():
        cs = _sample_channel(seq, name, ch, total, device)
        chs[name] = _modulate(cs, ch) if modulation else cs
    if modulation:
        max_t = seq.get_duration(include_fall_time=True)
        for name, cs in chs.items():
            if cs.duration > max_t:
                cs = replace(cs, amp=cs.amp[:max_t], det=cs.det[:max_t], phase=cs.phase[:max_t])
            elif cs.duration < max_t:
                cs = cs.extend_duration(max_t)
            chs[name] = cs
    # the SLM mask's window: up to the end of the sequence's first pulse
    mask_end = 0
    if seq._slm_mask_targets:
        first_tf = [cs.slots[0].tf for cs in chs.values() if cs.slots]
        mask_end = min(first_tf) if first_tf else 0
    ss = SequenceSamples(
        channel_samples=chs,
        _magnetic_field=seq.magnetic_field,
        _in_xy=seq._in_xy,
        qubit_ids=seq.register.qubit_ids,
        _measurement=seq._measurement,
        _slm_mask=_SlmMask(seq._slm_mask_targets, mask_end),
    )
    if extended_duration is not None:
        ss = ss.extend_duration(extended_duration)
    return ss

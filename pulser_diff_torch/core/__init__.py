from pulser_diff_torch.core.variables import Expr, Variable, VariableItem
from pulser_diff_torch.core.waveforms import ConstantWaveform, CustomWaveform, Waveform
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.devices import Device, MockDevice
from pulser_diff_torch.core.channels import Channel, Microwave, Rydberg
from pulser_diff_torch.core.pulse import Pulse
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.core.sampler import ChannelSamples, SequenceSamples, sample

__all__ = [
    "Expr",
    "Variable",
    "VariableItem",
    "Waveform",
    "ConstantWaveform",
    "CustomWaveform",
    "Register",
    "Device",
    "MockDevice",
    "Channel",
    "Microwave",
    "Rydberg",
    "Pulse",
    "Sequence",
    "ChannelSamples",
    "SequenceSamples",
    "sample",
]

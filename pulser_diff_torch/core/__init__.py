from pulser_diff_torch.core.variables import Expr, Variable, VariableItem
from pulser_diff_torch.core.waveforms import (
    BlackmanWaveform,
    CompositeWaveform,
    ConstantWaveform,
    CustomWaveform,
    InterpolatedWaveform,
    KaiserWaveform,
    RampWaveform,
    Waveform,
)
from pulser_diff_torch.core.register import Register
from pulser_diff_torch.core.devices import AnalogDevice, Device, MockDevice, VirtualDevice
from pulser_diff_torch.core.channels import Channel, Microwave, Raman, Rydberg
from pulser_diff_torch.core.eom import BLUE, RED, RydbergEOM
from pulser_diff_torch.core.pulse import Pulse
from pulser_diff_torch.core.sequence import Sequence
from pulser_diff_torch.core.sampler import ChannelSamples, SequenceSamples, sample

__all__ = [
    "Expr",
    "Variable",
    "VariableItem",
    "Waveform",
    "ConstantWaveform",
    "RampWaveform",
    "BlackmanWaveform",
    "KaiserWaveform",
    "CustomWaveform",
    "InterpolatedWaveform",
    "CompositeWaveform",
    "Register",
    "Device",
    "MockDevice",
    "VirtualDevice",
    "AnalogDevice",
    "Channel",
    "Rydberg",
    "Raman",
    "Microwave",
    "RydbergEOM",
    "RED",
    "BLUE",
    "Pulse",
    "Sequence",
    "ChannelSamples",
    "SequenceSamples",
    "sample",
]

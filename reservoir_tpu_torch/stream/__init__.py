"""The host-to-device stream bridge of the port:
:class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge` (S logical
streams buffered into ``[S, B]`` tiles feeding a
:class:`~reservoir_tpu_torch.engine.ReservoirEngine`, BASELINE.md config 5
at full width),
:class:`~reservoir_tpu_torch.stream.bridge.DeviceSampler` (one stream), and
the bridge's skip gate, :class:`~reservoir_tpu_torch.stream.gate.SkipGate`
with :func:`~reservoir_tpu_torch.stream.gate.gate_ineligible_reason`."""

from .bridge import DeviceSampler, DeviceStreamBridge
from .gate import SkipGate, gate_ineligible_reason

__all__ = ["DeviceStreamBridge", "DeviceSampler", "SkipGate", "gate_ineligible_reason"]

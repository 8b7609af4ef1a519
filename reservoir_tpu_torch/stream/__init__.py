"""The host-to-device stream bridge of the port:
:class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge` (S logical
streams buffered into ``[S, B]`` tiles feeding a
:class:`~reservoir_tpu_torch.engine.ReservoirEngine`, BASELINE.md config 5
at full width) and
:class:`~reservoir_tpu_torch.stream.bridge.DeviceSampler` (one stream)."""

from .bridge import DeviceSampler, DeviceStreamBridge

__all__ = ["DeviceStreamBridge", "DeviceSampler"]

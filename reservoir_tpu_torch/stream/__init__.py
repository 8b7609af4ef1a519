"""The port's stream layer:

- :class:`~reservoir_tpu_torch.stream.operator.Sample` — the reference's
  pass-through flow (``Sample.scala:21-92``) with eager validation; each
  ``run()`` (:class:`~reservoir_tpu_torch.stream.operator.RunningSample`)
  or ``run_async()``
  (:class:`~reservoir_tpu_torch.stream.operator.AsyncRunningSample`)
  materializes a fresh sampler and a future, with the completion protocol
  of ``SampleImpl.scala:27-57``; ``Sample.device`` samples on the card;
- :class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge` (S logical
  streams buffered into ``[S, B]`` tiles feeding a
  :class:`~reservoir_tpu_torch.engine.ReservoirEngine`, BASELINE.md config 5
  at full width) and
  :class:`~reservoir_tpu_torch.stream.bridge.DeviceSampler` (one stream);
- the bridge's skip gate,
  :class:`~reservoir_tpu_torch.stream.gate.SkipGate` with
  :func:`~reservoir_tpu_torch.stream.gate.gate_ineligible_reason`;
- :class:`~reservoir_tpu_torch.stream.interop.SampleServer`, the socket
  server behind the JVM shim stage (imported from
  :mod:`reservoir_tpu_torch.stream.interop`).
"""

from .bridge import DeviceSampler, DeviceStreamBridge
from .gate import SkipGate, gate_ineligible_reason
from .operator import AsyncRunningSample, RunningSample, Sample

__all__ = [
    "AsyncRunningSample",
    "DeviceSampler",
    "DeviceStreamBridge",
    "RunningSample",
    "Sample",
    "SkipGate",
    "gate_ineligible_reason",
]

"""Pass-through sampling operator (``object Sample`` + ``SampleImpl``).

The port's copy of the JAX package's ``stream/operator.py``.
Stream-semantics contract, mirrored from ``Sample.scala:13-19`` /
``SampleImpl.scala:27-57`` onto Python iterators:

- **emits** when upstream pushes — every upstream element is re-emitted
  downstream unchanged (``SampleImpl.scala:27-31``);
- **backpressures** when downstream backpressures — iteration is pull-based,
  nothing is consumed until the downstream asks (``SampleImpl.scala:33``);
- **completes** when upstream completes — the materialized future is
  fulfilled with the sample (``SampleImpl.scala:38-41``);
- **cancels**: graceful downstream cancellation delivers the partial sample;
  cancellation with a cause fails the future with it
  (``SampleImpl.scala:48-54``);
- **abrupt termination**: if the operator is dropped without any of the
  above, the future fails with :class:`AbruptStreamTermination`
  (the ``postStop`` backstop, ``SampleImpl.scala:56-57``).

The Akka ``Future[IndexedSeq[B]]`` materialized value becomes a
``concurrent.futures.Future`` — usable from sync and async code alike.
Validation happens **eagerly at flow construction** (``Sample.scala:52, 89``)
while sampler creation is deferred to materialization, so each ``run()``
gets a fresh, independent sampler (``Sample.scala:23-24``).

:meth:`Sample.device` samples on the card: each run's
:class:`~reservoir_tpu_torch.stream.bridge.DeviceSampler` buffers the
passing elements into ``[1, tile_size]`` tiles, each flushed to one launch
of the engine's kernel (``algl_update``, or ``distinct_update`` with
``distinct=True``), and the ragged remainder to one more at completion or
at a graceful cancel.  ``device="cpu"`` runs the plain torch version.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, AsyncIterable, Callable, Iterable, Optional, Union

import numpy as np

from ..config import validate_non_distinct_params
from ..errors import AbruptStreamTermination, SamplerClosedError

__all__ = ["Sample", "RunningSample", "AsyncRunningSample"]


class Sample:
    """Flow blueprint: pass-through sampling with a future materialized value.

    ``Sample(k)`` mirrors ``Sample.apply`` (``Sample.scala:49-54``);
    :meth:`distinct` mirrors ``Sample.distinct`` (``:86-91``);
    :meth:`device` routes sampling through a
    :class:`~reservoir_tpu_torch.engine.ReservoirEngine` on the card.

    Parameters are validated here, at graph-construction time; the sampler
    itself is created per :meth:`run` (fresh randomness and lifecycle per
    materialization, ``SampleImpl.scala:23-25``).
    """

    def __init__(
        self,
        max_sample_size: int,
        *,
        pre_allocate: bool = False,
        map_fn: Optional[Callable[[Any], Any]] = None,
        rng: Union[None, int, np.random.Generator] = None,
    ) -> None:
        from .. import api

        validate_non_distinct_params(
            max_sample_size, map_fn if map_fn is not None else (lambda x: x)
        )
        self._factory: Callable[[], Any] = lambda: api.sampler(
            max_sample_size,
            pre_allocate=pre_allocate,
            map_fn=map_fn,
            rng=rng,
        )

    @classmethod
    def distinct(
        cls,
        max_sample_size: int,
        *,
        map_fn: Optional[Callable[[Any], Any]] = None,
        hash_fn: Optional[Callable[[Any], int]] = None,
        rng: Union[None, int, np.random.Generator] = None,
    ) -> "Sample":
        """Distinct-value flow (``Sample.distinct``, ``Sample.scala:86-91``)."""
        from .. import api

        # eager validation identical to the core factory's (Sample.scala:89)
        validate_non_distinct_params(
            max_sample_size, map_fn if map_fn is not None else (lambda x: x)
        )
        if hash_fn is not None and not callable(hash_fn):
            raise TypeError("hash function must be callable (got %r)" % (hash_fn,))
        return cls.from_factory(
            lambda: api.distinct(
                max_sample_size, map_fn=map_fn, hash_fn=hash_fn, rng=rng
            )
        )

    @classmethod
    def device(
        cls,
        max_sample_size: int,
        *,
        key: Union[int, Any, None] = None,
        tile_size: int = 1024,
        element_dtype: Any = "int32",
        distinct: bool = False,
        reusable: bool = False,
        device: Optional[Any] = None,
    ) -> "Sample":
        """A flow whose sampling side runs on the engine: elements pass
        through on the host while tiles flush to the device reservoir
        (single logical stream; the many-stream scale path is
        :class:`~reservoir_tpu_torch.stream.bridge.DeviceStreamBridge`).
        ``device=None`` means the card and raises here without one;
        ``device="cpu"`` runs the plain torch version."""
        from ..config import SamplerConfig, validate_max_sample_size
        from ..convert import resolve_device
        from .bridge import DeviceSampler

        validate_max_sample_size(max_sample_size)
        config = SamplerConfig(
            max_sample_size=max_sample_size,
            num_reservoirs=1,
            tile_size=tile_size,
            element_dtype=element_dtype,
            distinct=distinct,
        )
        dev = resolve_device(device)
        return cls.from_factory(
            lambda: DeviceSampler(config, key=key, reusable=reusable, device=dev)
        )

    @classmethod
    def from_factory(cls, factory: Callable[[], Any]) -> "Sample":
        """Flow over any by-name sampler thunk (the ``Sample.flow`` helper,
        ``Sample.scala:23-24``) — one fresh sampler per materialization."""
        flow = cls.__new__(cls)
        flow._factory = factory
        return flow

    # ---------------------------------------------------------- materialize

    def run(self, source: Iterable[Any]) -> "RunningSample":
        """Materialize over ``source``: returns the pass-through iterator;
        its ``.sample`` future is the materialized value (``Keep.right``,
        ``Sample.scala:23-24``)."""
        return RunningSample(self._factory(), source)

    def run_async(self, source: AsyncIterable[Any]) -> "AsyncRunningSample":
        """Materialize over an async source (the Akka execution model's
        natural Python analog)."""
        return AsyncRunningSample(self._factory(), source)


class _RunningBase:
    """Completion protocol shared by the sync and async operators
    (``SampleImpl.scala:35-57``)."""

    def __init__(self, sampler: Any) -> None:
        self._sampler = sampler
        self._future: Future = Future()
        self._done = False

    @property
    def sample(self) -> Future:
        """The materialized value: a future of the final sample
        (``SampleImpl.scala:23, 62``)."""
        return self._future

    # -- tryCompleteSampler (SampleImpl.scala:35-36): fulfill with the
    # sampler's result iff it is still open and the promise untouched.
    def _try_complete(self) -> None:
        if self._future.done():
            return
        if getattr(self._sampler, "is_open", True):
            try:
                self._future.set_result(self._sampler.result())
            except BaseException as exc:  # result() itself failed
                self._future.set_exception(exc)
        else:
            # A closed sampler at completion means the factory violated the
            # fresh-sampler-per-run contract; fail loudly rather than leave
            # the future forever pending (drain() would deadlock).
            self._future.set_exception(
                SamplerClosedError(
                    "sampler was already closed at stream completion; "
                    "factories must produce a fresh sampler per run"
                )
            )

    def _fail(self, exc: BaseException) -> None:
        if not self._future.done():
            self._future.set_exception(exc)

    def cancel(self, cause: Optional[BaseException] = None) -> None:
        """Downstream cancellation (``onDownstreamFinish``,
        ``SampleImpl.scala:48-54``): graceful (no cause) delivers the partial
        sample; a cause fails the future with it.  Idempotent."""
        if self._done:
            return
        self._done = True
        if cause is None:
            self._try_complete()
        else:
            self._fail(cause)

    close = cancel  # context-manager / generator-protocol friendly alias

    def __del__(self) -> None:
        # postStop backstop (SampleImpl.scala:56-57): dropped without
        # completing -> abrupt termination.
        fut = getattr(self, "_future", None)
        if fut is not None and not fut.done():
            fut.set_exception(
                AbruptStreamTermination(
                    "stream operator terminated abruptly without completion"
                )
            )


class RunningSample(_RunningBase):
    """Materialized pass-through iterator over a sync source.

    Iterating pulls one upstream element, samples it, and re-emits it
    (``onPush``, ``SampleImpl.scala:27-31``).  Exhaustion completes the
    future with the sample; an upstream exception fails the future and
    propagates (``SampleImpl.scala:38-46``).
    """

    def __init__(self, sampler: Any, source: Iterable[Any]) -> None:
        super().__init__(sampler)
        self._it = iter(source)

    def __iter__(self) -> "RunningSample":
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        try:
            elem = next(self._it)
        except StopIteration:
            self._done = True
            self._try_complete()  # onUpstreamFinish (SampleImpl.scala:38-41)
            raise
        except BaseException as exc:
            self._done = True
            self._fail(exc)  # onUpstreamFailure (SampleImpl.scala:43-46)
            raise
        try:
            self._sampler.sample(elem)
        except BaseException as exc:
            self._done = True
            self._fail(exc)
            raise
        return elem

    def drain(self) -> Any:
        """Run the stream to completion discarding emitted elements
        (``Sink.ignore``) and return the sample — the common test/benchmark
        harness shape (``SampleTest.scala:32-37``)."""
        for _ in self:
            pass
        return self._future.result()


class AsyncRunningSample(_RunningBase):
    """Materialized pass-through async iterator (same protocol as
    :class:`RunningSample` over an ``AsyncIterable``)."""

    def __init__(self, sampler: Any, source: AsyncIterable[Any]) -> None:
        super().__init__(sampler)
        self._it = source.__aiter__()

    def __aiter__(self) -> "AsyncRunningSample":
        return self

    async def __anext__(self) -> Any:
        if self._done:
            raise StopAsyncIteration
        try:
            elem = await self._it.__anext__()
        except StopAsyncIteration:
            self._done = True
            self._try_complete()
            raise
        except BaseException as exc:
            self._done = True
            self._fail(exc)
            raise
        try:
            self._sampler.sample(elem)
        except BaseException as exc:
            self._done = True
            self._fail(exc)
            raise
        return elem

    async def drain(self) -> Any:
        """Async ``Sink.ignore`` + materialized value."""
        async for _ in self:
            pass
        return self._future.result()

"""JVM/Akka interop: a socket server that backs the reference's ``Sample``
stage with this package's samplers.

The port's copy of the JAX package's ``stream/interop.py``, with the same
wire protocol, so the JVM-side shim stage of ``examples/akka_interop/``
(``TpuSample.scala``) talks to either package's server unchanged.  The
stage keeps every Akka semantic locally (pass-through emit, backpressure,
completion protocol, ``SampleImpl.scala:27-57``) and delegates only the
*sampling state* over a socket — ``sampler.sample(elem)`` becomes a
buffered frame write, and ``result()`` a final round-trip.  TCP flow
control IS the backpressure coupling: if this server stalls, the stage's
writes block and the stage backpressures its upstream, exactly like a slow
in-process sampler.

Wire protocol (all integers big-endian):

  handshake  C->S:  magic ``RSV1`` | mode u8 (0 dup, 1 distinct) | k u32
  frames     C->S:  ``B`` | count u32 | count x i64     (sample_all batch)
             C->S:  ``C``                               (upstream complete)
             C->S:  ``F``                               (failure/cancel-with-
                                                         cause: discard)
  result     S->C:  ``R`` | size u32 | size x i64       (reply to ``C``)
             S->C:  ``A``                               (reply to ``F``)

The completion protocol maps 1:1 onto ``SampleImpl.scala``'s:
``onUpstreamFinish``/graceful ``onDownstreamFinish`` send ``C`` (deliver
the sample, ``:38-41, 48-52``); ``onUpstreamFailure``/cancel-with-cause
send ``F`` (``:43-46, 53-54``); dropping the connection without either is
the ``postStop`` abrupt-termination analog (``:56-57``) — the server
discards the partial sample.

Each connection runs on a thread of its own (a ``ThreadingTCPServer``).  A
factory that returns a card
:class:`~reservoir_tpu_torch.stream.bridge.DeviceSampler` puts each
connection's reservoir on the card: a ``B`` frame goes through
``DeviceSampler.sample_all``, one kernel launch a full tile (a frame of
65,536 elements is 64 launches at ``tile_size=1024``), and ``C`` flushes
the ragged remainder.  Each such sampler owns its engine, pinned buffer
and copy, so connections share nothing but the card's stream.  A mode-0
connection whose sampler holds int32 keeps each wire value's low 32 bits
(numpy's cast of the frame into the tile), as the JAX package's does.

Elements are i64 on the wire (the ``Sampler[Long, Long]`` shape of
BASELINE config 1).  ``map``/``hash`` hooks stay JVM-side: the shim
applies ``map`` to the *returned* elements, which yields identical
results for pure functions but calls ``map`` once per result element
instead of once per accept — the one observable deviation, documented in
the JAX package's ARCHITECTURE.md.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Callable, Optional

import numpy as np

__all__ = ["SampleServer"]

_MAGIC = b"RSV1"

# Largest batch a single ``B`` frame may carry: the wire
# count is untrusted u32, and without a cap a corrupt/malicious header
# could demand an 8*2^32 ~= 32 GiB allocation.  2^24 elements (128 MiB)
# is far beyond any sane shim flush (the JVM stage flushes ~2^16).
MAX_FRAME_ELEMS = 1 << 24

# Largest ``k`` a handshake may request, for the same reason: samplers
# preallocate O(k) state, so an untrusted u32 k near MAX_SIZE (2^31-3
# passes eager validation) would OOM the server from a few wire bytes.
MAX_HANDSHAKE_K = 1 << 24


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # preallocated buffer + recv_into: O(n) for large frames (``bytes``
    # concatenation re-copies the prefix per chunk, O(n^2))
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed mid-frame")
        got += r
    # hand the bytearray back as-is: every consumer (slice compare,
    # struct.unpack, np.frombuffer) takes the buffer protocol, and a
    # bytes() round-trip would re-copy each max-size frame
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection == one materialization
        sock = self.request
        head = _recv_exact(sock, len(_MAGIC) + 1 + 4)
        if head[: len(_MAGIC)] != _MAGIC:
            sock.close()
            return
        mode = head[len(_MAGIC)]
        (k,) = struct.unpack(">I", head[len(_MAGIC) + 1 :])
        if k > MAX_HANDSHAKE_K:
            sock.close()  # untrusted k: refuse before any O(k) allocation
            return
        sampler = self.server._make_sampler(mode, k)  # type: ignore[attr-defined]
        try:
            while True:
                tag = _recv_exact(sock, 1)
                if tag == b"B":
                    (count,) = struct.unpack(">I", _recv_exact(sock, 4))
                    if count > MAX_FRAME_ELEMS:
                        raise ConnectionError(
                            f"batch frame of {count} elements exceeds "
                            f"MAX_FRAME_ELEMS={MAX_FRAME_ELEMS}"
                        )
                    data = _recv_exact(sock, 8 * count)
                    elems = np.frombuffer(data, dtype=">i8").astype(np.int64)
                    sampler.sample_all(elems)
                elif tag == b"C":
                    res = np.asarray(sampler.result(), dtype=np.int64)
                    sock.sendall(
                        b"R"
                        + struct.pack(">I", res.shape[0])
                        + res.astype(">i8").tobytes()
                    )
                    return
                elif tag == b"F":
                    # failure/cancel-with-cause: discard the partial sample
                    # (the future fails JVM-side, SampleImpl.scala:43-46)
                    sock.sendall(b"A")
                    return
                else:
                    raise ConnectionError(f"unknown frame tag {tag!r}")
        except ConnectionError:
            # abrupt termination (postStop analog): nothing to deliver
            return


class SampleServer:
    """Serve reference-``Sample`` materializations over TCP.

    One connection per stream materialization; each gets a FRESH sampler
    from ``sampler_factory(mode, k)`` (the by-name-thunk semantics of
    ``Sample.scala:23-24``).  The default factory uses the host samplers
    (:mod:`reservoir_tpu_torch.api`); pass a factory returning a
    :class:`~reservoir_tpu_torch.stream.bridge.DeviceSampler` to put the
    sampling state on the card.

    Usage::

        with SampleServer() as srv:        # srv.address -> ("127.0.0.1", p)
            ...  # point the JVM shim at srv.address and run the Akka graph
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        sampler_factory: Optional[Callable[[int, int], object]] = None,
    ) -> None:
        self._factory = sampler_factory or self._default_factory
        self._server = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._server.daemon_threads = True
        self._server._make_sampler = self._factory  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    @staticmethod
    def _default_factory(mode: int, k: int):
        from .. import api

        return api.distinct(k) if mode == 1 else api.sampler(k)

    @property
    def address(self):
        return self._server.server_address

    def start(self) -> "SampleServer":
        self._thread.start()
        return self

    def close(self) -> None:
        # shutdown() blocks on an event only serve_forever() sets — calling
        # it when start() never ran would deadlock
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "SampleServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

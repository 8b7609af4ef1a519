"""The port's ``SampleServer`` (``reservoir_tpu_torch.stream.interop``)
against the JAX package's (``reservoir_tpu.stream.interop``), over the wire
protocol the JVM shim stage speaks.

Each case of the JAX package's own interop tests runs against both
packages' servers, each given the same seeded factory (host samplers, or
``DeviceSampler``: the port's with ``device="cpu"``, the JAX package's on
its CPU backend); the bytes each server sends back must be equal.  The
wire limits and the failure paths are held too."""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np
import pytest

import reservoir_tpu.api as JA
import reservoir_tpu_torch.api as TA
from reservoir_tpu.config import SamplerConfig as JConfig
from reservoir_tpu.stream import interop as JI
from reservoir_tpu.stream.bridge import DeviceSampler as JSampler
from reservoir_tpu_torch import DeviceSampler, SamplerConfig
from reservoir_tpu_torch.stream import interop as TI


def _connect(addr):
    s = socket.create_connection(addr, timeout=10)
    s.settimeout(10)
    return s


def _handshake(sock, mode: int, k: int) -> None:
    sock.sendall(b"RSV1" + bytes([mode]) + struct.pack(">I", k))


def _send_batch(sock, elems) -> None:
    arr = np.asarray(elems, dtype=">i8")
    sock.sendall(b"B" + struct.pack(">I", arr.shape[0]) + arr.tobytes())


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def _complete(sock) -> bytes:
    """Send ``C``; the whole reply, as bytes."""
    sock.sendall(b"C")
    head = _recv_exact(sock, 5)
    assert head[:1] == b"R"
    (size,) = struct.unpack(">I", head[1:])
    return head + _recv_exact(sock, 8 * size)


def _values(reply: bytes) -> list:
    return np.frombuffer(reply[5:], dtype=">i8").astype(np.int64).tolist()


def _host_factory(api):
    return lambda mode, k: api.distinct(k, rng=0) if mode == 1 else api.sampler(k, rng=0)


def _device_factory(package, tile=64, dtype="int32"):
    def make(mode, k):
        kw = dict(max_sample_size=k, num_reservoirs=1, tile_size=tile,
                  element_dtype="int64" if mode == 1 else dtype, distinct=mode == 1)
        if package == "jax":
            return JSampler(JConfig(**kw), key=0)
        return DeviceSampler(SamplerConfig(**kw), key=0, device="cpu")

    return make


def _servers(kind: str):
    """Both packages' servers with the same factory: host samplers seeded 0,
    or device samplers under key 0."""
    if kind == "host":
        return [JI.SampleServer(sampler_factory=_host_factory(JA)),
                TI.SampleServer(sampler_factory=_host_factory(TA))]
    return [JI.SampleServer(sampler_factory=_device_factory("jax")),
            TI.SampleServer(sampler_factory=_device_factory("port"))]


def _rng_stream(n, seed, lo=0, hi=1 << 40):
    return np.random.default_rng(seed).integers(lo, hi, n, dtype=np.int64)


def _one(sock, mode, k, batches):
    _handshake(sock, mode, k)
    for b in batches:
        _send_batch(sock, b)
    return _complete(sock)


def _case_uniform(addr):
    with _connect(addr) as s:
        return _one(s, 0, 8, [np.arange(1000, dtype=np.int64), 1000 + np.arange(500)])


def _case_uniform_wide_values(addr):
    with _connect(addr) as s:
        return _one(s, 0, 16, [_rng_stream(3_000, 1, -(2**62), 2**62), _rng_stream(40_000, 2)])


def _case_short_stream(addr):
    with _connect(addr) as s:
        return _one(s, 0, 50, [[5, 6, 7]])


def _case_empty_stream(addr):
    with _connect(addr) as s:
        return _one(s, 0, 4, [])


def _case_distinct(addr):
    with _connect(addr) as s:
        return _one(s, 1, 16, [[7] * 100 + [9] * 50])


def _case_distinct_zipf(addr):
    z = np.minimum(np.random.default_rng(3).random(30_000) ** -10.0, 1e7).astype(np.int64)
    with _connect(addr) as s:
        return _one(s, 1, 64, [z[:10_000], z[10_000:]])


def _case_failure_frame(addr):
    with _connect(addr) as s:
        _handshake(s, 0, 8)
        _send_batch(s, np.arange(100, dtype=np.int64))
        s.sendall(b"F")
        return _recv_exact(s, 1)


def _case_abrupt_disconnect(addr):
    s = _connect(addr)
    _handshake(s, 0, 8)
    _send_batch(s, np.arange(100, dtype=np.int64))
    s.close()  # no completion frame at all: the server keeps serving
    with _connect(addr) as s2:
        return _one(s2, 0, 4, [[1, 2]])


def _case_concurrent(addr):
    socks = []
    for i in range(4):
        s = _connect(addr)
        _handshake(s, 0, 10)
        _send_batch(s, np.arange(i * 100, i * 100 + 5 + 3_000 * i, dtype=np.int64))
        socks.append(s)
    replies = [_complete(s) for s in socks]
    for s in socks:
        s.close()
    return b"".join(replies)


WIRE_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
              if name.startswith("_case_")}


@pytest.mark.parametrize("factory", ["host", "device"])
@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_reply_bytes_equal_the_jax_package(case, factory):
    replies = []
    for srv in _servers(factory):
        with srv:
            replies.append(WIRE_CASES[case](srv.address))
    assert replies[1] == replies[0]


def test_replies_hold_what_the_protocol_promises():
    with TI.SampleServer() as srv:
        with _connect(srv.address) as s:
            res = _values(_one(s, 0, 8, [np.arange(1000, dtype=np.int64)]))
        assert len(res) == 8 and set(res) <= set(range(1000))
        with _connect(srv.address) as s:
            assert _values(_one(s, 0, 50, [[5, 6, 7]])) == [5, 6, 7]  # arrival order below k
        with _connect(srv.address) as s:
            assert sorted(_values(_one(s, 1, 16, [[7] * 100 + [9] * 50]))) == [7, 9]
        assert _case_failure_frame(srv.address) == b"A"


def test_mode_0_values_beyond_int32_wrap_as_in_the_jax_package():
    # an int32 DeviceSampler keeps each wire value's low 32 bits, in both
    stream = np.array([2**40 + 5, 2**31, -(2**33) - 1, 7, 2**63 - 1], np.int64)
    replies = []
    for srv in _servers("device"):
        with srv:
            with _connect(srv.address) as s:
                replies.append(_one(s, 0, 8, [stream]))
    assert replies[1] == replies[0]
    assert _values(replies[1]) == [5, -(2**31), -1, 7, -1]


def test_a_device_factory_flushes_each_full_tile_of_a_frame():
    flushed = []

    def factory(mode, k):
        s = _device_factory("port", tile=64)(mode, k)
        sample = s.engine.sample

        def counted(tile, valid=None, **kw):
            flushed.append(int(valid[0]))
            return sample(tile, valid=valid, **kw)

        s.engine.sample = counted
        return s

    data = _rng_stream(64 * 5 + 17, 4, 0, 2**31)
    with TI.SampleServer(sampler_factory=factory) as srv:
        with _connect(srv.address) as s:
            reply = _one(s, 0, 8, [data[:100], data[100:]])
    ref = DeviceSampler(SamplerConfig(8, 1, tile_size=64), key=0, device="cpu")
    ref.sample_all(data.astype(np.int32))
    assert _values(reply) == ref.result().astype(np.int64).tolist()
    # five full tiles as the frames arrive, the ragged 17 at C
    assert flushed == [64] * 5 + [17]


def test_concurrent_device_connections_are_independent():
    # the port's server runs each connection's DeviceSampler on its own
    # thread; each reply equals a sampler fed that connection's stream alone
    streams = [_rng_stream(1_000 + 177 * i, 10 + i, 0, 2**31) for i in range(4)]
    replies = [None] * 4
    with TI.SampleServer(sampler_factory=_device_factory("port")) as srv:
        def client(i):
            with socket.create_connection(srv.address, timeout=120) as s:
                _handshake(s, 0, 16)
                for chunk in np.array_split(streams[i], 3):
                    _send_batch(s, chunk)
                replies[i] = _complete(s)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    for i, data in enumerate(streams):
        ref = DeviceSampler(SamplerConfig(16, 1, tile_size=64), key=0, device="cpu")
        ref.sample_all(data.astype(np.int32))
        assert _values(replies[i]) == ref.result().astype(np.int64).tolist()


def test_default_factory_is_the_host_api():
    assert TI.SampleServer._default_factory(0, 4)._engine.__class__.__module__ == \
        "reservoir_tpu_torch.oracle.algorithm_l"
    assert TI.SampleServer._default_factory(1, 4)._engine.__class__.__module__ == \
        "reservoir_tpu_torch.oracle.bottom_k"
    assert (TI.MAX_FRAME_ELEMS, TI.MAX_HANDSHAKE_K) == (JI.MAX_FRAME_ELEMS, JI.MAX_HANDSHAKE_K)


def test_close_without_start_does_not_deadlock():
    TI.SampleServer().close()


@pytest.mark.parametrize("what", ["frame", "handshake_k", "magic", "tag"])
def test_untrusted_headers_drop_the_connection(what):
    with TI.SampleServer() as srv:
        sock = _connect(srv.address)
        if what == "frame":
            _handshake(sock, 0, 4)
            sock.sendall(b"B" + struct.pack(">I", TI.MAX_FRAME_ELEMS + 1))
        elif what == "handshake_k":
            _handshake(sock, 0, TI.MAX_HANDSHAKE_K + 1)
        elif what == "magic":
            sock.sendall(b"XXXX" + bytes([0]) + struct.pack(">I", 4))
        else:
            _handshake(sock, 0, 4)
            sock.sendall(b"Z")
        with pytest.raises((ConnectionError, AssertionError, socket.timeout, OSError)):
            sock.sendall(b"C")
            _recv_exact(sock, 1)
        sock.close()
        # and the server goes on serving
        with _connect(srv.address) as s2:
            assert _values(_one(s2, 0, 4, [[1, 2]])) == [1, 2]

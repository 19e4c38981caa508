"""The port's copy of the distributed runtime against the JAX package's.

* codec: the port's standard-library msgpack encoder is byte-equal to
  `msgpack.packb(obj, use_bin_type=True)` on generated nested values at
  every encoding boundary, and decodes msgpack's bytes; numpy integer,
  float32 and bool scalars raise TypeError in both.
* request plane: the port's server answers the JAX client and the JAX
  server answers the port's client (streams, remote errors, graceful
  cancel and kill), over loopback.
* FileDiscovery: JAX and port backends on one directory see each other's
  instances, and a revoked lease disappears for the other side.
* zmq event plane: a publish from one package is received by the other.
"""

import asyncio
import math
import struct

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime.cancellation import CancellationToken as JaxToken
from dynamo_tpu.runtime.discovery import FileDiscovery as JaxFileDiscovery
from dynamo_tpu.runtime.discovery import Instance as JaxInstance
from dynamo_tpu.runtime.event_plane import ZmqEventPlane as JaxZmq
from dynamo_tpu.runtime.request_plane import EngineError as JaxEngineError
from dynamo_tpu.runtime.request_plane import RequestPlaneClient as JaxClient
from dynamo_tpu.runtime.request_plane import RequestPlaneServer as JaxServer
from dynamo_tpu_torch.runtime import (
    CancellationToken,
    EngineError,
    FileDiscovery,
    Instance,
    RequestPlaneClient,
    RequestPlaneServer,
    ZmqEventPlane,
)
from dynamo_tpu_torch.runtime.codec import packb, unpackb
from dynamo_tpu_torch.runtime.discovery import make_discovery

# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

# every integer boundary of msgpack's encodings, and one past it
_INT_EDGES = sorted({v + d for v in (0, 127, 255, 2**16 - 1, 2**32 - 1,
                                     2**63 - 1, 2**64 - 1, -32, -128,
                                     -2**15, -2**31, -2**63)
                     for d in (-1, 0, 1)
                     if -2**63 <= v + d <= 2**64 - 1})
# byte lengths at which str/bin/array/map headers change form
_LEN_EDGES = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)


def _sized_str(n):
    return st.sampled_from(["a", "é", "€", "\U0001f600"]).map(
        lambda c: (c * n).encode()[:n].decode("utf-8", "ignore"))


_leaves = st.one_of(
    st.none(), st.booleans(),
    st.sampled_from(_INT_EDGES), st.integers(-2**63, 2**64 - 1),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(max_size=40), st.binary(max_size=40),
    st.sampled_from(_LEN_EDGES).flatmap(_sized_str),
    st.sampled_from(_LEN_EDGES).map(lambda n: bytes(range(256)) * (n // 256)
                                    + bytes(n % 256)),
)
_values = st.recursive(
    _leaves,
    lambda kids: st.one_of(
        st.lists(kids, max_size=20),
        st.lists(kids, max_size=4).map(tuple),
        st.dictionaries(st.text(max_size=8), kids, max_size=20),
        st.dictionaries(st.integers(-40, 300), kids, max_size=3)),
    max_leaves=40)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(_values)
def test_packb_is_byte_equal_to_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == want
    # decoding msgpack's bytes gives what msgpack decodes (compared through
    # the bytes again, so NaN and tuple-vs-list compare as msgpack sees them)
    assert packb(unpackb(want)) == want
    assert packb(unpackb(want)) == packb(
        msgpack.unpackb(want, raw=False, strict_map_key=False))


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_container_length_boundaries(n):
    for obj in ([i % 300 - 40 for i in range(n)],
                {str(i): i for i in range(n)}):
        want = msgpack.packb(obj, use_bin_type=True)
        assert packb(obj) == want
        assert unpackb(want) == obj


def test_floats_and_unpack_edges():
    for x in (0.0, -0.0, 1.5, math.inf, -math.inf, 2.0**-1074):
        assert packb(x) == msgpack.packb(x) == b"\xcb" + struct.pack(">d", x)
    assert math.isnan(unpackb(packb(math.nan)))
    # a float32 from another encoder decodes; a truncated or overlong
    # buffer and ext types raise
    assert unpackb(b"\xca" + struct.pack(">f", 0.5)) == 0.5
    for bad in (b"\xcd\x01", b"\x01\x02", b"\xd4\x01\x02"):
        with pytest.raises(ValueError):
            unpackb(bad)
    with pytest.raises(OverflowError):
        packb(2**64)
    with pytest.raises(OverflowError):
        packb(-2**63 - 1)


@pytest.mark.parametrize("scalar", [np.int64(3), np.int32(-1), np.uint8(7),
                                    np.float32(0.5), np.bool_(True),
                                    object(), {1, 2}])
def test_numpy_scalars_raise_type_error_like_msgpack(scalar):
    with pytest.raises(TypeError):
        msgpack.packb(scalar, use_bin_type=True)
    with pytest.raises(TypeError):
        packb(scalar)
    with pytest.raises(TypeError):
        packb({"k": [scalar]})


# ---------------------------------------------------------------------------
# request plane across the two packages
# ---------------------------------------------------------------------------


async def _handler(payload, ctx):
    """Echoes, then streams until stopped (or `n` items); "boom" raises."""
    if payload.get("boom"):
        raise RuntimeError("boom from the handler")
    yield {"echo": payload, "ctx": ctx.headers}
    for i in range(payload.get("n", 10**6)):
        if ctx.is_stopped():
            yield {"stopped_at": i}
            return
        yield {"i": i, "big": 2**64 - 1, "neg": -2**63, "f": 0.25}
        await asyncio.sleep(0.002)


@pytest.mark.parametrize("server_side,client_side", [
    ("torch", "jax"), ("jax", "torch")])
async def test_request_plane_interoperates(server_side, client_side):
    Server = RequestPlaneServer if server_side == "torch" else JaxServer
    Client, Token, Err = ((RequestPlaneClient, CancellationToken, EngineError)
                          if client_side == "torch"
                          else (JaxClient, JaxToken, JaxEngineError))
    server = Server("127.0.0.1", 0)
    server.register_handler("ns/c/generate", _handler, instance_id=42)
    addr = await server.start()
    client = Client()
    try:
        # a whole stream, with ctx headers and wire-range integers
        items = [x async for x in client.stream(
            addr, "ns/c/generate", {"n": 3, "b": b"\x00\xff"},
            ctx={"trace": "t1"}, instance_id=42)]
        assert items[0] == {"echo": {"n": 3, "b": b"\x00\xff"},
                            "ctx": {"trace": "t1"}}
        assert [x["i"] for x in items[1:]] == [0, 1, 2]
        assert items[1]["big"] == 2**64 - 1 and items[1]["neg"] == -2**63
        # remote errors: a raising handler and an unknown endpoint
        with pytest.raises(Err, match="RuntimeError: boom"):
            async for _ in client.stream(addr, "ns/c/generate",
                                         {"boom": True}, instance_id=42):
                pass
        with pytest.raises(Err, match="no handler"):
            async for _ in client.stream(addr, "ns/c/missing", {}):
                pass
        # graceful cancel: the handler sees the stop and ends its stream
        tok = Token()
        got = []
        async for x in client.stream(addr, "ns/c/generate", {}, token=tok,
                                     instance_id=42):
            got.append(x)
            if len(got) == 4:
                tok.stop()
        assert "stopped_at" in got[-1] and len(got) < 50
        # kill: the client stops at once and the server ends the handler
        tok = Token()
        got = []
        async for x in client.stream(addr, "ns/c/generate", {}, token=tok,
                                     instance_id=42):
            got.append(x)
            if len(got) == 3:
                tok.kill()
        assert len(got) == 3
        # the connection still serves after both
        again = [x async for x in client.stream(addr, "ns/c/generate",
                                                {"n": 1}, instance_id=42)]
        assert len(again) == 2
    finally:
        await client.close()
        await server.close()


# ---------------------------------------------------------------------------
# FileDiscovery on one directory
# ---------------------------------------------------------------------------


async def test_file_discovery_shared_between_packages(tmp_path):
    port = FileDiscovery(str(tmp_path), ttl_s=2.0, poll_s=0.02)
    jax_side = JaxFileDiscovery(str(tmp_path), ttl_s=2.0, poll_s=0.02)
    await port.start()
    await jax_side.start()
    try:
        pi = Instance("dynamo", "torchw", "generate", 7, "127.0.0.1:1",
                      {"model": "m"})
        ji = JaxInstance("dynamo", "jaxw", "generate", 9, "127.0.0.1:2", {})
        await port.put(pi.key(), pi.to_dict())
        await jax_side.put(ji.key(), ji.to_dict())
        for d in (port, jax_side):
            snap = await d.get_prefix("v1/instances/")
            assert snap == {pi.key(): pi.to_dict(), ji.key(): ji.to_dict()}
        assert JaxInstance.from_dict(
            (await jax_side.get_prefix(pi.key()))[pi.key()]) == JaxInstance(
            "dynamo", "torchw", "generate", 7, "127.0.0.1:1", {"model": "m"})

        # a watch from one side sees the other side's lease end
        seen = []

        async def watch(d, prefix, stop):
            async for ev in d.watch(prefix, cancel=stop):
                seen.append((ev.type, ev.key))

        stop = asyncio.Event()
        w = asyncio.create_task(watch(jax_side, "v1/instances/dynamo/torchw",
                                      stop))
        await asyncio.sleep(0.1)
        await port.revoke_lease()
        for _ in range(100):
            if ("delete", pi.key()) in seen:
                break
            await asyncio.sleep(0.02)
        stop.set()
        await w
        assert seen == [("put", pi.key()), ("delete", pi.key())]
        assert list(await port.get_prefix("v1/")) == [ji.key()]
    finally:
        await port.close()
        await jax_side.close()
    assert list(tmp_path.rglob("*.json")) == []


def test_unported_discovery_backends_raise():
    for backend in ("etcd", "kubernetes"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_discovery(backend)


# ---------------------------------------------------------------------------
# zmq event plane across the two packages
# ---------------------------------------------------------------------------


async def test_zmq_event_plane_crosses_packages(tmp_path):
    port_d = FileDiscovery(str(tmp_path), poll_s=0.02)
    jax_d = JaxFileDiscovery(str(tmp_path), poll_s=0.02)
    port_ep, jax_ep = ZmqEventPlane(port_d), JaxZmq(jax_d)
    payload = {"worker_id": 2**63 - 1, "hashes": [b"\x01" * 16],
               "kv_usage": 0.5, "nested": {"a": [1, None, True]}}
    try:
        for pub, sub, subject in ((port_ep, jax_ep, "kv_events.ns.torch"),
                                  (jax_ep, port_ep, "kv_events.ns.jax")):
            got = []
            stop = asyncio.Event()

            async def listen():
                async for s, msg in sub.subscribe("kv_events.ns.", cancel=stop):
                    got.append((s, msg))
                    stop.set()

            task = asyncio.create_task(listen())
            # PUB/SUB joins are asynchronous: publish until one arrives
            for _ in range(200):
                await pub.publish(subject, payload)
                if got:
                    break
                await asyncio.sleep(0.02)
            await asyncio.wait_for(task, 5)
            assert got[0] == (subject, payload)
    finally:
        await port_ep.close()
        await jax_ep.close()
        await port_d.close()
        await jax_d.close()

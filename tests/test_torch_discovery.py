"""The port's etcd and kubernetes discovery against the JAX package's (CPU).

* runtime/http.py: JSON calls, errors, the bearer token, per-call
  timeouts, chunked watch streams whose JSON lines the server splits
  across chunks or packs several to a chunk, a read timeout, and close()
  ending an open stream.
* EtcdDiscovery and KubeDiscovery against tests/fake_etcd.py and
  tests/fake_kube.py, the JAX tests' own scenarios (tests/test_etcd.py,
  tests/test_kube.py): kv round trips, snapshot + live watch, lease
  expiry and a stale renewTime surfacing as deletes, keepalive past the
  TTL, re-registration after a lost lease or a deleted Lease object,
  withdraw and restore, a runtime serving over each, the relist after a
  410 Gone.
* Cross reads on one fake: a JAX watcher sees a port put with equal key
  and value, and the other way round; the kube Lease bodies and the
  RFC 3339 stamps equal JAX's.
* The `auto` event plane: zmq under file and etcd discovery, in-process
  under kubernetes, in both packages; the repo's manifests select
  kubernetes discovery and set no event plane.
* A port worker registered through etcd is served by the unchanged JAX
  frontend (a completion, then the model withdrawn with the worker).
* chip_smoke.py's discovery phase at a tiny width on the CPU, and its
  standard-library fakes read by the JAX backends.
"""

import asyncio
import contextlib
import datetime
import json
import time
import uuid
from pathlib import Path

import aiohttp
import pytest

import chip_rehearsal
import chip_smoke
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime import kube as jax_kube
from dynamo_tpu.runtime.etcd import EtcdDiscovery as JaxEtcd
from dynamo_tpu.runtime.kube import KubeDiscovery as JaxKube
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import http
from dynamo_tpu_torch.runtime import kube as port_kube
from dynamo_tpu_torch.runtime.etcd import EtcdDiscovery, prefix_range_end
from dynamo_tpu_torch.runtime.http import HttpClient, HttpError
from dynamo_tpu_torch.runtime.kube import KubeDiscovery

from fake_etcd import FakeEtcd
from fake_kube import FakeKubeApiServer

REPO = Path(__file__).resolve().parent.parent


@contextlib.asynccontextmanager
async def fake_etcd():
    srv = await FakeEtcd().start()
    try:
        yield srv
    finally:
        await srv.close()


@contextlib.asynccontextmanager
async def fake_kube(cls=FakeKubeApiServer):
    srv = await cls().start()
    try:
        yield srv
    finally:
        await srv.close()


def kd(fake, cls=KubeDiscovery, **kw):
    kw.setdefault("ttl_s", 5.0)
    return cls(api_url=fake.endpoint, namespace="dyn", cluster_id="test",
               **kw)


async def _collect(disc, prefix, n, cancel=None):
    """The first n events of disc.watch(prefix)."""
    cancel = cancel or asyncio.Event()
    events = []
    async for ev in disc.watch(prefix, cancel=cancel):
        events.append(ev)
        if len(events) >= n:
            cancel.set()
    return events


# ---------------------------------------------------------------------------
# runtime/http.py
# ---------------------------------------------------------------------------


class _ChunkServer:
    """A standard-library HTTP server whose responses it scripts: a JSON
    body, or a chunked stream of the given chunks (then held open until
    the client leaves or `release` is set)."""

    def __init__(self, chunks=None, status=200, body=b"{}", delay=0.0,
                 ssl=None):
        self.chunks, self.status, self.body = chunks, status, body
        self.delay, self.ssl = delay, ssl
        self.seen = []  # request heads
        self.release = asyncio.Event()
        self._server = None

    async def start(self):
        self._server = await asyncio.start_server(self._handle, "127.0.0.1",
                                                  0, ssl=self.ssl)
        port = self._server.sockets[0].getsockname()[1]
        self.url = f"{'https' if self.ssl else 'http'}://127.0.0.1:{port}"
        return self

    async def close(self):
        self.release.set()
        self._server.close()
        await self._server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            head = (await reader.readuntil(b"\r\n\r\n")).decode()
            n = 0
            for line in head.split("\r\n"):
                if line.lower().startswith("content-length:"):
                    n = int(line.split(":")[1])
            body = await reader.readexactly(n)
            self.seen.append((head, body))
            await asyncio.sleep(self.delay)
            if self.chunks is None:
                writer.write(f"HTTP/1.1 {self.status} S\r\nContent-Length: "
                             f"{len(self.body)}\r\n\r\n".encode() + self.body)
                await writer.drain()
                return
            writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked"
                         b"\r\n\r\n")
            for c in self.chunks:
                writer.write(b"%x\r\n%s\r\n" % (len(c), c))
                await writer.drain()
                await asyncio.sleep(0.01)
            gone = asyncio.ensure_future(reader.read(1))
            rel = asyncio.ensure_future(self.release.wait())
            await asyncio.wait({gone, rel},
                               return_when=asyncio.FIRST_COMPLETED)
            gone.cancel()
            rel.cancel()
            if self.release.is_set():
                writer.write(b"0\r\n\r\n")
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


LINES = [json.dumps({"n": i, "pad": "x" * (7 * i)}).encode() + b"\n"
         for i in range(5)]


@pytest.mark.parametrize("split", ["one_line_across_chunks",
                                   "lines_packed_in_a_chunk", "bytewise"])
async def test_stream_yields_whole_lines_whatever_the_chunking(split):
    blob = b"".join(LINES)
    if split == "one_line_across_chunks":
        # every line cut in three, the cuts never on a newline
        chunks = [c for ln in LINES for c in (ln[:3], ln[3:9], ln[9:])]
    elif split == "lines_packed_in_a_chunk":
        chunks = [blob[:len(LINES[0]) + len(LINES[1]) + 4],
                  blob[len(LINES[0]) + len(LINES[1]) + 4:]]
    else:
        chunks = [blob[i:i + 1] for i in range(len(blob))]
    srv = await _ChunkServer(chunks).start()
    client = HttpClient(srv.url)
    try:
        got = []
        async with client.stream("POST", "/v3/watch", json={"a": 1}) as lines:
            async for line in lines:
                got.append(line)
                if len(got) == len(LINES):
                    break
        assert got == LINES
        # the etcd backend's line handler gives the same events either way
        assert [json.loads(g)["n"] for g in got] == list(range(5))
    finally:
        await client.close()
        await srv.close()


async def test_stream_ends_at_the_last_chunk_and_keeps_a_tail_line():
    srv = await _ChunkServer([b'{"a": 1}\n{"b"', b': 2}']).start()
    client = HttpClient(srv.url)
    try:
        srv.release.set()
        async with client.stream("GET", "/w") as lines:
            got = [json.loads(x) async for x in lines]
        assert got == [{"a": 1}, {"b": 2}]
    finally:
        await client.close()
        await srv.close()


async def test_close_ends_an_open_stream_without_a_task_left():
    srv = await _ChunkServer([LINES[0]]).start()
    client = HttpClient(srv.url)
    got, ended = [], asyncio.Event()

    async def read():
        try:
            async with client.stream("POST", "/v3/watch", json={}) as lines:
                async for line in lines:
                    got.append(line)
        except ConnectionError:
            ended.set()

    task = asyncio.create_task(read())
    for _ in range(200):
        if got:
            break
        await asyncio.sleep(0.01)
    await client.close()
    await asyncio.wait_for(task, 5)
    assert got == [LINES[0]] and ended.is_set()
    # the client keeps no task of its own alive
    assert not [t for t in asyncio.all_tasks()
                if "runtime/http.py" in repr(t.get_coro())]
    with pytest.raises(RuntimeError, match="closed"):
        await client.request("GET", "/")
    await srv.close()


async def test_json_call_token_errors_and_timeouts(monkeypatch):
    srv = await _ChunkServer(body=b'{"ok": true}').start()
    client = HttpClient(srv.url + "/base", token="tok")
    try:
        assert await client.call("POST", "/x", {"k": [1]},
                                 params={"watch": "true", "a": "b c"}) == \
            {"ok": True}
        head, body = srv.seen[-1]
        assert head.startswith("POST /base/x?watch=true&a=b+c HTTP/1.1")
        assert "Authorization: Bearer tok" in head
        assert json.loads(body) == {"k": [1]}
        srv.status, srv.body = 409, b'{"reason": "AlreadyExists"}'
        resp = await client.request("POST", "/x", json={})
        assert resp.status == 409 and resp.json()["reason"] == "AlreadyExists"
        with pytest.raises(HttpError) as e:
            await client.call("POST", "/x")
        assert e.value.status == 409
        srv.delay = 1.0
        with pytest.raises(asyncio.TimeoutError):
            monkeypatch.setattr(http, "DEFAULT_TIMEOUT_S", 0.2)
            await client.request("GET", "/slow")
    finally:
        await client.close()
        await srv.close()


async def test_stream_read_timeout_and_error_status():
    srv = await _ChunkServer([LINES[0]]).start()
    client = HttpClient(srv.url)
    try:
        with pytest.raises(asyncio.TimeoutError):
            async with client.stream("GET", "/w", read_timeout=0.2) as lines:
                async for _ in lines:
                    pass
        err = await _ChunkServer(status=410, body=b'{"code": 410}').start()
        c2 = HttpClient(err.url)
        with pytest.raises(HttpError) as e:
            async with c2.stream("GET", "/w"):
                pass
        assert e.value.status == 410
        await c2.close()
        await err.close()
    finally:
        await client.close()
        await srv.close()


def test_client_refuses_other_schemes():
    with pytest.raises(ValueError, match="unsupported URL"):
        HttpClient("unix:///var/run/x")


# ---------------------------------------------------------------------------
# EtcdDiscovery (tests/test_etcd.py's scenarios)
# ---------------------------------------------------------------------------


def test_prefix_range_end():
    assert prefix_range_end(b"v1/") == b"v10"
    assert prefix_range_end(b"a\xff") == b"b"
    assert prefix_range_end(b"\xff\xff") == b"\0"


async def test_etcd_put_get_delete_roundtrip():
    async with fake_etcd() as fake:
        d = EtcdDiscovery(fake.endpoint, ttl_s=5.0)
        await d.start()
        await d.put("v1/instances/ns/w/e/42", {"instance_id": 42})
        await d.put("v1/mdc/ns/model", {"name": "m"}, lease=False)
        assert await d.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/42": {"instance_id": 42}}
        assert await d.get_prefix("v1/") == {
            "v1/instances/ns/w/e/42": {"instance_id": 42},
            "v1/mdc/ns/model": {"name": "m"}}
        await d.delete("v1/instances/ns/w/e/42")
        assert await d.get_prefix("v1/instances/") == {}
        await d.close()


async def test_etcd_watch_snapshot_then_live_events():
    async with fake_etcd() as fake:
        d1 = EtcdDiscovery(fake.endpoint, ttl_s=5.0)
        d2 = EtcdDiscovery(fake.endpoint, ttl_s=5.0)
        await d1.put("v1/instances/ns/w/e/1", {"instance_id": 1})
        task = asyncio.create_task(_collect(d2, "v1/instances/", 3))
        await asyncio.sleep(0.3)
        await d1.put("v1/instances/ns/w/e/2", {"instance_id": 2})
        await d1.delete("v1/instances/ns/w/e/1")
        events = await asyncio.wait_for(task, timeout=5)
        assert [(e.type, e.key) for e in events] == [
            ("put", "v1/instances/ns/w/e/1"),
            ("put", "v1/instances/ns/w/e/2"),
            ("delete", "v1/instances/ns/w/e/1")]
        assert events[1].value == {"instance_id": 2}
        await d1.close()
        await d2.close()


async def test_etcd_lease_expiry_deletes_keys_and_notifies():
    async with fake_etcd() as fake:
        d1 = EtcdDiscovery(fake.endpoint, ttl_s=1.0)
        await d1.put("v1/instances/ns/w/e/7", {"instance_id": 7})
        d2 = EtcdDiscovery(fake.endpoint, ttl_s=5.0)
        cancel = asyncio.Event()
        events = []

        async def watch():
            async for ev in d2.watch("v1/instances/", cancel=cancel):
                events.append(ev)
                if ev.type == "delete":
                    cancel.set()

        task = asyncio.create_task(watch())
        await asyncio.sleep(0.2)
        # simulated crash: stop keepalive without revoking
        d1._closed.set()
        d1._ka_task.cancel()
        await asyncio.wait_for(task, timeout=6)
        assert (events[-1].type, events[-1].key) == (
            "delete", "v1/instances/ns/w/e/7")
        assert await d2.get_prefix("v1/instances/") == {}
        await d1._client.close()
        await d2.close()


async def test_etcd_keepalive_holds_lease_past_ttl():
    async with fake_etcd() as fake:
        d = EtcdDiscovery(fake.endpoint, ttl_s=1.0)
        await d.put("v1/instances/ns/w/e/9", {"instance_id": 9})
        probe = EtcdDiscovery(fake.endpoint, ttl_s=5.0)
        await asyncio.sleep(2.5)
        assert await probe.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/9": {"instance_id": 9}}
        await d.close()
        assert await probe.get_prefix("v1/instances/") == {}
        await probe.close()


async def test_etcd_expired_lease_reregisters_owned_keys():
    async with fake_etcd() as fake:
        d = EtcdDiscovery(fake.endpoint, ttl_s=1.0)
        await d.put("v1/instances/ns/w/e/5", {"instance_id": 5})
        old = d.lease_id
        fake._drop_lease(old)
        assert await d.get_prefix("v1/instances/") == {}
        for _ in range(40):
            await asyncio.sleep(0.1)
            if await d.get_prefix("v1/instances/"):
                break
        assert await d.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/5": {"instance_id": 5}}
        assert d.lease_id != old
        await d.close()


async def test_etcd_withdraw_restore_cycle():
    async with fake_etcd() as fake:
        d = EtcdDiscovery(fake.endpoint)
        await d.put("v1/instances/ns/w/e/3", {"instance_id": 3})
        await d.put("v1/mdc/ns/m", {"name": "m"}, lease=False)
        await d.withdraw_lease()
        assert await d.get_prefix("v1/instances/") == {}
        assert await d.get_prefix("v1/mdc/") == {"v1/mdc/ns/m": {"name": "m"}}
        await d.restore_lease()
        assert await d.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/3": {"instance_id": 3}}
        await d.close()


async def _echo_over(make_rt):
    async def echo(payload, ctx):
        for tok in payload["items"]:
            yield {"echo": tok}

    async with make_rt() as rt1, make_rt() as rt2:
        ep = rt1.namespace("ns").component("worker").endpoint("generate")
        await ep.serve_endpoint(echo)
        client = await (rt2.namespace("ns").component("worker")
                        .endpoint("generate").client()).start()
        await client.wait_for_instances()
        out = [item["echo"] async for item in
               client.generate({"items": [1, 2, 3]})]
        await client.close()
    return out


async def test_runtime_serves_over_etcd():
    async with fake_etcd() as fake:
        cid = uuid.uuid4().hex
        assert await _echo_over(lambda: DistributedRuntime(
            config=RuntimeConfig(discovery_backend="etcd",
                                 etcd_endpoint=fake.endpoint,
                                 event_plane="inproc"),
            cluster_id=cid)) == [1, 2, 3]


def test_runtime_config_reads_the_etcd_endpoint(monkeypatch):
    monkeypatch.setenv("DYN_ETCD_ENDPOINT", "http://etcd:2379")
    monkeypatch.setenv("DYN_DISCOVERY_BACKEND", "etcd")
    monkeypatch.setenv("DYN_EVENT_PLANE", "inproc")
    cfg = RuntimeConfig.from_env()
    assert (cfg.discovery_backend, cfg.etcd_endpoint) == (
        "etcd", "http://etcd:2379")
    assert cfg.etcd_endpoint == JaxRuntimeConfig.from_env().etcd_endpoint
    d = DistributedRuntime(config=cfg).discovery
    assert isinstance(d, EtcdDiscovery) and d.endpoint == "http://etcd:2379"


# ---------------------------------------------------------------------------
# KubeDiscovery (tests/test_kube.py's scenarios)
# ---------------------------------------------------------------------------


async def test_kube_put_get_delete_roundtrip():
    async with fake_kube() as fake:
        d = kd(fake)
        await d.start()
        await d.put("v1/instances/ns/w/e/42", {"instance_id": 42})
        await d.put("v1/mdc/ns/model", {"name": "m"}, lease=False)
        assert await d.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/42": {"instance_id": 42}}
        assert await d.get_prefix("v1/") == {
            "v1/instances/ns/w/e/42": {"instance_id": 42},
            "v1/mdc/ns/model": {"name": "m"}}
        await d.put("v1/instances/ns/w/e/42", {"instance_id": 42, "v": 2})
        assert (await d.get_prefix("v1/instances/"))[
            "v1/instances/ns/w/e/42"]["v"] == 2
        await d.delete("v1/instances/ns/w/e/42")
        assert await d.get_prefix("v1/instances/") == {}
        await d.close()


async def test_kube_watch_snapshot_then_live_events():
    async with fake_kube() as fake:
        d1, d2 = kd(fake), kd(fake)
        await d1.put("v1/instances/ns/w/e/1", {"instance_id": 1})
        task = asyncio.create_task(_collect(d2, "v1/instances/", 3))
        await asyncio.sleep(0.3)
        await d1.put("v1/instances/ns/w/e/2", {"instance_id": 2})
        await d1.delete("v1/instances/ns/w/e/1")
        events = await asyncio.wait_for(task, timeout=5)
        assert [(e.type, e.key) for e in events] == [
            ("put", "v1/instances/ns/w/e/1"),
            ("put", "v1/instances/ns/w/e/2"),
            ("delete", "v1/instances/ns/w/e/1")]
        assert events[1].value == {"instance_id": 2}
        await d1.close()
        await d2.close()


async def test_kube_stale_renew_time_surfaces_as_delete():
    async with fake_kube() as fake:
        d1 = kd(fake, ttl_s=1.0)
        await d1.put("v1/instances/ns/w/e/7", {"instance_id": 7})
        d2 = kd(fake, ttl_s=1.0)
        cancel = asyncio.Event()
        events = []

        async def watch():
            async for ev in d2.watch("v1/instances/", cancel=cancel):
                events.append(ev)
                if ev.type == "delete":
                    cancel.set()

        task = asyncio.create_task(watch())
        await asyncio.sleep(0.2)
        d1._closed.set()
        d1._ka_task.cancel()
        await asyncio.wait_for(task, timeout=6)
        assert (events[-1].type, events[-1].key) == (
            "delete", "v1/instances/ns/w/e/7")
        assert await d2.get_prefix("v1/instances/") == {}
        await d1._client.close()
        await d2.close()


async def test_kube_keepalive_holds_lease_past_ttl():
    async with fake_kube() as fake:
        d = kd(fake, ttl_s=1.0)
        await d.put("v1/instances/ns/w/e/9", {"instance_id": 9})
        probe = kd(fake)
        await asyncio.sleep(2.5)
        assert await probe.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/9": {"instance_id": 9}}
        await d.close()
        assert await probe.get_prefix("v1/instances/") == {}
        await probe.close()


async def test_kube_deleted_lease_object_reregisters():
    async with fake_kube() as fake:
        d = kd(fake, ttl_s=1.0)
        await d.put("v1/instances/ns/w/e/5", {"instance_id": 5})
        fake.leases.clear()
        assert await d.get_prefix("v1/instances/") == {}
        for _ in range(40):
            await asyncio.sleep(0.1)
            if await d.get_prefix("v1/instances/"):
                break
        assert await d.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/5": {"instance_id": 5}}
        await d.close()


async def test_kube_withdraw_restore_cycle():
    async with fake_kube() as fake:
        d = kd(fake)
        await d.put("v1/instances/ns/w/e/3", {"instance_id": 3})
        await d.put("v1/mdc/ns/m", {"name": "m"}, lease=False)
        await d.withdraw_lease()
        assert await d.get_prefix("v1/instances/") == {}
        assert await d.get_prefix("v1/mdc/") == {"v1/mdc/ns/m": {"name": "m"}}
        await d.restore_lease()
        assert await d.get_prefix("v1/instances/") == {
            "v1/instances/ns/w/e/3": {"instance_id": 3}}
        await d.close()


async def test_runtime_serves_over_kube_discovery(monkeypatch):
    async with fake_kube() as fake:
        # configured as a deployment configures it: the environment
        monkeypatch.setenv("DYN_K8S_API", fake.endpoint)
        monkeypatch.setenv("DYN_K8S_NAMESPACE", "dyn")
        cid = uuid.uuid4().hex
        assert await _echo_over(lambda: DistributedRuntime(
            config=RuntimeConfig(discovery_backend="kubernetes",
                                 event_plane="inproc"),
            cluster_id=cid)) == [1, 2, 3]


class _GoneOnceKube(FakeKubeApiServer):
    """A fake API server whose first watch answers 410 Gone (a
    resourceVersion too old), as a real one does after compaction."""

    gone = 0

    async def _h_watch(self, request):
        if not self.gone:
            self.gone += 1
            from aiohttp import web

            return web.json_response({"kind": "Status", "code": 410,
                                      "reason": "Expired"}, status=410)
        return await super()._h_watch(request)


@pytest.mark.parametrize("cls", [JaxKube, KubeDiscovery],
                         ids=["jax", "port"])
async def test_kube_watch_relists_after_410(cls):
    async with fake_kube(_GoneOnceKube) as fake:
        w = kd(fake, cls)
        d = kd(fake)
        await d.put("v1/instances/ns/w/e/1", {"instance_id": 1})
        task = asyncio.create_task(_collect(w, "v1/instances/", 2))
        for _ in range(100):
            if fake.gone and fake._watchers:
                break
            await asyncio.sleep(0.02)
        await d.put("v1/instances/ns/w/e/2", {"instance_id": 2})
        events = await asyncio.wait_for(task, timeout=5)
        assert fake.gone == 1
        assert [(e.type, e.key) for e in events] == [
            ("put", "v1/instances/ns/w/e/1"),
            ("put", "v1/instances/ns/w/e/2")]
        await d.close()
        await w.close()


def test_kube_lease_body_and_stamps_equal_jax(monkeypatch):
    monkeypatch.setenv("DYN_K8S_TOKEN", "t")
    port = KubeDiscovery(api_url="http://h:1", namespace="n",
                         cluster_id="c", ttl_s=3.0)
    jax = JaxKube(api_url="http://h:1", namespace="n", cluster_id="c",
                  ttl_s=3.0)
    assert port._name("v1/x") == jax._name("v1/x")
    assert port._leases_url("a").endswith(jax._leases_url("a")[len(
        jax.api):])
    for durable in (False, True):
        a = port._lease_body("v1/x", {"b": 1, "a": [2]}, durable)
        b = jax._lease_body("v1/x", {"b": 1, "a": [2]}, durable)
        for body in (a, b):
            body["spec"].pop("renewTime")
            body["spec"].pop("holderIdentity")
        assert a == b
    stamp = port_kube._now_rfc3339()
    assert jax_kube._parse_rfc3339(stamp) == port_kube._parse_rfc3339(stamp)
    assert abs(jax_kube._parse_rfc3339(stamp) - time.time()) < 5
    for s in ("2026-01-02T03:04:05Z", "2026-01-02T03:04:05.123456Z"):
        assert port_kube._parse_rfc3339(s) == jax_kube._parse_rfc3339(s)
    now = datetime.datetime.now(datetime.timezone.utc).timestamp()
    stale = {"metadata": {"annotations": {
        "dynamo.dev/key": "k", "dynamo.dev/value": "1"}},
        "spec": {"renewTime": "2020-01-01T00:00:00Z",
                 "leaseDurationSeconds": 5}}
    fresh = json.loads(json.dumps(stale))
    fresh["spec"]["renewTime"] = port_kube._now_rfc3339()
    durable = json.loads(json.dumps(stale))
    durable["metadata"]["annotations"]["dynamo.dev/durable"] = "1"
    for obj in (stale, fresh, durable):
        assert port._decode(obj, now) == jax._decode(obj, now)
    assert port._decode(stale, now) is None
    assert port._decode(durable, now) == ("k", 1)


async def test_kube_credentials_and_tls_from_a_ca_file(monkeypatch,
                                                      tmp_path):
    import ssl
    import subprocess

    monkeypatch.setenv("DYN_K8S_API", "http://api:6443/")
    monkeypatch.setenv("DYN_K8S_NAMESPACE", "ns1")
    monkeypatch.setenv("DYN_K8S_TOKEN", "tok")
    assert port_kube.resolve_k8s_credentials() == \
        jax_kube.resolve_k8s_credentials()
    # an https API server whose certificate only the CA file vouches for
    ca, key = tmp_path / "ca.crt", tmp_path / "k.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(ca), "-days", "1",
         "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(str(ca), str(key))
    body = json.dumps({"kind": "LeaseList", "items": [],
                       "metadata": {"resourceVersion": "7"}}).encode()
    srv = await _ChunkServer(body=body, ssl=server_ctx).start()
    try:
        monkeypatch.setenv("DYN_K8S_API", srv.url)
        monkeypatch.setenv("DYN_K8S_CA_CERT", str(ca))
        api, ns, tok, ctx = port_kube.resolve_k8s_credentials()
        assert (api, ns, tok) == (srv.url, "ns1", "tok")
        assert ctx is not None
        d = KubeDiscovery(cluster_id="c")
        assert await d._list() == ({}, "7")
        head, _ = srv.seen[-1]
        assert "Authorization: Bearer tok" in head
        assert "labelSelector=dynamo-cluster%3Dc" in head
        await d._client.close()
        # without the CA file the system trust store refuses the server
        monkeypatch.setenv("DYN_K8S_CA_CERT", str(tmp_path / "absent"))
        d = KubeDiscovery(cluster_id="c")
        with pytest.raises(ssl.SSLCertVerificationError):
            await d._list()
        await d._client.close()
    finally:
        await srv.close()


# ---------------------------------------------------------------------------
# the two packages on one fake
# ---------------------------------------------------------------------------


def _etcd_pair(fake):
    return EtcdDiscovery(fake.endpoint), JaxEtcd(fake.endpoint)


def _kube_pair(fake):
    return kd(fake), kd(fake, JaxKube)


@pytest.mark.parametrize("backend", ["etcd", "kubernetes"])
@pytest.mark.parametrize("writer", ["port", "jax"])
async def test_cross_package_watch_sees_the_other_put(backend, writer):
    ctx = fake_etcd() if backend == "etcd" else fake_kube()
    async with ctx as fake:
        port, jax = (_etcd_pair if backend == "etcd" else _kube_pair)(fake)
        w, r = (port, jax) if writer == "port" else (jax, port)
        key = "v1/instances/dynamo/backend/generate/77"
        value = {"instance_id": 77, "address": "127.0.0.1:9",
                 "metadata": {"model": "m", "nested": [1, None, 2.5]}}
        task = asyncio.create_task(_collect(r, "v1/instances/", 2))
        await asyncio.sleep(0.3)
        await w.put(key, value)
        await w.put("v1/mdc/dynamo/m/77", {"name": "m"}, lease=False)
        assert await r.get_prefix("v1/") == {key: value,
                                             "v1/mdc/dynamo/m/77":
                                             {"name": "m"}}
        await w.delete(key)
        events = await asyncio.wait_for(task, timeout=5)
        assert [(e.type, e.key, e.value) for e in events] == [
            ("put", key, value), ("delete", key, None)]
        await w.close()
        await r.close()


# ---------------------------------------------------------------------------
# the auto event plane (a reference quirk the port keeps)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,plane", [("file", "zmq"), ("etcd", "zmq"),
                                           ("kubernetes", "inproc")])
def test_auto_event_plane_follows_the_jax_rule(backend, plane, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("DYN_K8S_API", "http://127.0.0.1:1")
    kw = dict(discovery_backend=backend, discovery_path=str(tmp_path),
              etcd_endpoint="http://127.0.0.1:1", event_plane="auto")
    port = DistributedRuntime(config=RuntimeConfig(**kw))
    jax = JaxRuntime(config=JaxRuntimeConfig(**kw))
    kinds = {type(rt.event_plane).__name__.replace("EventPlane", "")
             .replace("InProc", "inproc").replace("Zmq", "zmq")
             for rt in (port, jax)}
    assert kinds == {plane}


def test_repo_manifests_select_kubernetes_discovery_and_no_event_plane():
    """Under the repo's own manifests a worker's KV events and load
    metrics stay in its pod: kubernetes discovery, and no manifest sets
    DYN_EVENT_PLANE, so `auto` picks the in-process plane (above)."""
    text = (REPO / "deploy" / "decode-workers.yaml").read_text()
    assert "DYN_DISCOVERY_BACKEND" in text and "kubernetes" in text
    for path in (REPO / "deploy").rglob("*.yaml"):
        assert "DYN_EVENT_PLANE" not in path.read_text(), path


# ---------------------------------------------------------------------------
# a port worker behind the JAX frontend, discovered through etcd
# ---------------------------------------------------------------------------

@pytest.mark.allow_slow_callbacks
async def test_jax_frontend_serves_a_port_worker_over_etcd():
    import torch

    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
    from dynamo_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
                      n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128,
                      dtype=torch.float32)
    async with fake_etcd() as fake:
        disc = dict(discovery_backend="etcd", etcd_endpoint=fake.endpoint,
                    event_plane="inproc")
        cid = uuid.uuid4().hex
        jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc),
                               cluster_id=cid).start()
        prt = await DistributedRuntime(config=RuntimeConfig(**disc),
                                       cluster_id=cid).start()
        tw = TorchEngineWorker(prt, EngineConfig(
            model_config=cfg, model_name="m-torch", block_size=4,
            num_blocks=128, max_blocks_per_seq=16, max_num_seqs=4,
            prefill_buckets=(8, 16, 32, 64), seed=7),
            tokenizer_cfg={"type": "mock", "vocab_size": 256},
            device="cpu")
        manager = ModelManager()
        watcher = service = None
        try:
            await tw.start()
            # the worker's keys are in etcd, in JAX's layout
            keys = {k.decode() for k in fake.kv}
            assert tw.card.key(tw.served.instance_id) in keys
            assert tw.served.instance.key() in keys
            watcher = await ModelWatcher(jrt, manager).start()
            service = await HttpService(jrt, manager, host="127.0.0.1",
                                        port=0).start()
            url = f"http://127.0.0.1:{service._runner.addresses[0][1]}"
            for _ in range(500):
                if manager.get("m-torch"):
                    break
                await asyncio.sleep(0.02)
            body = {"model": "m-torch", "prompt": "over etcd",
                    "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
            async with aiohttp.ClientSession() as s:
                async with s.post(f"{url}/v1/completions", json=body) as r:
                    assert r.status == 200, await r.text()
                    data = await r.json()
            assert data["usage"]["completion_tokens"] == 6
            assert data["choices"][0]["finish_reason"] == "length"
            await tw.close()
            for _ in range(500):
                if not manager.get("m-torch"):
                    break
                await asyncio.sleep(0.02)
            assert not manager.get("m-torch")
        finally:
            if service is not None:
                await service.close()
            if watcher is not None:
                await watcher.close()
            await tw.close()
            await prt.shutdown()
            await jrt.shutdown()


# ---------------------------------------------------------------------------
# chip_smoke.py's discovery phase and fakes, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", chip_smoke.DISCOVERY_BACKENDS)
def test_chip_smoke_discovery_phase_at_tiny_width(backend, monkeypatch):
    import torch

    from dynamo_tpu_torch.models import llama

    cfg = chip_rehearsal.rehearse(monkeypatch)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    out = chip_smoke.check_discovery(
        torch.device("cpu"), chip_smoke._engine_config("int8"), params,
        backend)
    assert out["launches"]["paged_decode_int8"] >= 2 * 31
    assert out["launches"]["packed_prefill_int8"] >= 2
    assert len(out["visible_ms"]) == 2 and out["lease_rtt_ms"] > 0


@pytest.mark.parametrize("cls", ["etcd", "kubernetes"])
async def test_chip_smoke_fakes_serve_the_jax_backends(cls, monkeypatch):
    """The JAX backends (aiohttp) round-trip, watch and expire through
    chip_smoke.py's standard-library fakes as through tests/fake_*.py."""
    if cls == "etcd":
        fake = await chip_smoke.FakeEtcdGateway().start()
        mk = lambda ttl=5.0: JaxEtcd(fake.endpoint, ttl_s=ttl)  # noqa: E731
    else:
        fake = await chip_smoke.FakeKubeApi().start()
        mk = lambda ttl=5.0: JaxKube(  # noqa: E731
            api_url=fake.endpoint, namespace=chip_smoke.K8S_NAMESPACE,
            cluster_id="c", token=chip_smoke.K8S_TOKEN, ttl_s=ttl)
    try:
        a, b = mk(1.0), mk()
        await a.put("v1/instances/x/1", {"i": 1})
        await a.put("v1/mdc/x", {"n": 1}, lease=False)
        task = asyncio.create_task(_collect(b, "v1/instances/", 2))
        await asyncio.sleep(0.3)
        await a.put("v1/instances/x/2", {"i": 2})
        events = await asyncio.wait_for(task, timeout=5)
        assert [(e.type, e.key) for e in events] == [
            ("put", "v1/instances/x/1"), ("put", "v1/instances/x/2")]
        # a crash: the lease expires (etcd) or goes stale (kube)
        a._closed.set()
        a._ka_task.cancel()
        for _ in range(100):
            if not await b.get_prefix("v1/instances/"):
                break
            await asyncio.sleep(0.1)
        assert await b.get_prefix("v1/instances/") == {}
        assert await b.get_prefix("v1/mdc/") == {"v1/mdc/x": {"n": 1}}
        if a._session is not None:
            await a._session.close()
        await b.close()
    finally:
        await fake.close()


@pytest.mark.parametrize("name", ["decode-workers", "prefill-workers"])
def test_torch_manifests_run_the_port_cli_on_a_gpu(name):
    """deploy/torch/ copies the TPU manifests for the port: the same
    discovery environment, the port's CLI with flags it accepts, one
    NVIDIA GPU a pod."""
    import yaml

    from dynamo_tpu_torch.engine.__main__ import build_args

    tpu = yaml.safe_load((REPO / "deploy" / f"{name}.yaml").read_text())
    gpu = yaml.safe_load((REPO / "deploy" / "torch" / f"{name}.yaml")
                         .read_text())
    (tc,) = tpu["spec"]["template"]["spec"]["containers"]
    (gc,) = gpu["spec"]["template"]["spec"]["containers"]
    assert gc["env"] == tc["env"]
    assert gc["command"][:3] == ["python", "-m", "dynamo_tpu_torch.engine"]
    assert gc["command"][3:] == tc["command"][3:]
    args = build_args().parse_args(gc["command"][3:])
    assert args.device == "cuda" and args.host_cache_blocks == 2048
    assert gc["resources"]["limits"] == {"nvidia.com/gpu": "1"}


@pytest.mark.parametrize("cls", [KubeDiscovery, JaxKube],
                         ids=["port", "jax"])
async def test_kube_delete_while_withdrawn_stays_deleted(cls):
    """An endpoint shut down while the canary holds its keys withdrawn:
    the port's restore leaves the deleted key out (the base class's
    contract); JAX's KubeDiscovery brings it back (ROADMAP Queue 3 item
    12)."""
    async with fake_kube() as fake:
        d = kd(fake, cls)
        await d.put("v1/instances/ns/w/e/3", {"instance_id": 3})
        await d.put("v1/instances/ns/w/e/4", {"instance_id": 4})
        await d.withdraw_lease()
        await d.delete("v1/instances/ns/w/e/4")
        await d.restore_lease()
        got = set(await d.get_prefix("v1/instances/"))
        want = {"v1/instances/ns/w/e/3"}
        if cls is JaxKube:
            want.add("v1/instances/ns/w/e/4")
        assert got == want
        await d.close()

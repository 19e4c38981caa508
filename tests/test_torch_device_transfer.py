"""The port's cross-process device tier of disagg (CPU), against the JAX
package's (dynamo_tpu/disagg/device_transfer.py).

* SenderChunkRegistry keeps JAX's semantics under one sequence of park,
  replace, release and sweep (an injected clock), and hands each dropped
  ref to its `on_drop` once.
* The opt-in (DYN_KV_TRANSFER_SERVER) parses as JAX's does for each value.
* A header without the capability is the JAX header, msgpack byte for
  byte; with it, the capability rides under "cuda_ipc" only.
* Across packages both ways the pull takes host frames and streams what
  the aggregated engines stream: a JAX receiver (opt-in off and on)
  pulling from a torch sender that advertises CUDA IPC, and a torch
  receiver with CUDA IPC pulling from a JAX sender whose header carries
  its transfer server's "transfer_addr" (a stub server).
* The device tier's control flow runs on the CPU through a handle-layer
  double installed here (host buffers, memmove copies): chunks asked
  `via: "cuda_ipc"`, widened eightfold, one staging buffer per request
  released chunk by chunk and on close, the load loop's sweep of a
  receiver that never closed, and a device chunk that fails mid-pull
  sending the rest of that pull to host frames; the blocks land as the
  sender gathered them and the streams equal the aggregated engines'.
"""

import asyncio
import ctypes
import itertools
import uuid

import msgpack
import pytest
import torch

from dynamo_tpu.disagg import device_transfer as jdt
from dynamo_tpu.disagg import transfer as jtransfer
from dynamo_tpu_torch.disagg import broker
from dynamo_tpu_torch.disagg import device_transfer as dt
from dynamo_tpu_torch.disagg import transfer
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.protocols import DISAGG_ANNOTATION, LLMEngineOutput
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from test_torch_disagg import (
    ECFG,
    PROMPT,
    _aggregated,
    _assert_same_blocks,
    _models,
    _record_gathers,
    _record_torch_injects,
    _req,
    _torch_params,
    _wait,
)

pytestmark = pytest.mark.allow_slow_callbacks

# 40 tokens -> 10 blocks of 4: two device chunks of up to 8 blocks
LONG_PROMPT = list(range(60, 100))


# ---------------------------------------------------------------------------
# the registry, the opt-in, the header
# ---------------------------------------------------------------------------


def test_registry_matches_jax_under_one_sequence():
    clock = [0.0]
    jreg, treg = jdt.SenderChunkRegistry(), None
    dropped = []
    treg = dt.SenderChunkRegistry(on_drop=dropped.append)
    jreg._now = treg._now = lambda: clock[0]
    ops = [("park", "a", 1, 0.0), ("park", "b", 2, 1.0),
           ("park", "a", 3, 2.0),          # replaces a's chunk 1
           ("sweep", 5.0, None, 6.0),      # nothing older than 1.0
           ("release", "b", None, 6.0), ("release", "zz", None, 6.0),
           ("park", "c", 4, 20.0), ("park", "d", 5, 21.0),
           ("sweep", 10.0, None, 30.5),    # a (2.0), c (20.0) go
           ("park", "d", 6, 31.0), ("sweep", 0.5, None, 40.0)]
    for op, x, y, t in ops:
        clock[0] = t
        if op == "park":
            got = (jreg.park(x, y, f"ref{y}"), treg.park(x, y, f"ref{y}"))
        elif op == "release":
            got = (jreg.release(x), treg.release(x))
        else:
            got = (jreg.sweep(x), treg.sweep(x))
        assert got[0] == got[1]
        assert len(jreg) == len(treg)
        assert dict(jreg._parked) == dict(treg._parked)
    assert len(treg) == 0
    # every ref parked was dropped once, in the order the registry let go
    assert dropped == ["ref1", "ref2", "ref3", "ref4", "ref5", "ref6"]
    treg.park("e", 7, "ref7")
    assert treg.clear() == 1 and dropped[-1] == "ref7" and not len(treg)


@pytest.mark.parametrize("value", ["1", "true", "TRUE", "yes", "On", "0",
                                   "false", "no", "off", "", "2", "enable",
                                   None])
def test_opt_in_parses_as_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("DYN_KV_TRANSFER_SERVER", raising=False)
    else:
        monkeypatch.setenv("DYN_KV_TRANSFER_SERVER", value)
    # a started server in both modules: the parse alone decides
    monkeypatch.setattr(jdt, "_server", "jax-server")
    monkeypatch.setattr(dt, "_server", "torch-server")
    on = jdt.get_transfer_server() == "jax-server"
    assert (dt.get_transfer_server() == "torch-server") == on
    assert dt.transfer_enabled() == on


def test_header_without_capability_is_jax_bytes():
    lo = transfer.KvLayout(num_layers=2, num_blocks=6, block_size=4,
                           kv_heads=2, head_dim=16, dtype="bfloat16")
    jlo = jtransfer.KvLayout.from_dict(lo.to_dict())
    mine = transfer.make_header(22, lo)
    assert msgpack.packb(mine) == msgpack.packb(jtransfer.make_header(22, jlo))
    cap = {"node": "boot", "device": "card"}
    with_cap = transfer.make_header(22, lo, ipc=cap)
    assert with_cap.pop("cuda_ipc") == cap
    assert msgpack.packb(with_cap) == msgpack.packb(mine)
    # a JAX sender's header keeps its own key, which the port ignores
    jh = jtransfer.make_header(22, jlo, transfer_addr="host:1")
    assert "transfer_addr" in jh and "cuda_ipc" not in jh


# ---------------------------------------------------------------------------
# the handle-layer double
# ---------------------------------------------------------------------------


class HostHandles:
    """csrc/kv_ipc.cu's entries on host memory: a buffer is a ctypes
    string buffer, a handle names its address, copies are memmoves.
    `fail_fetch_at` makes the n-th fetch (1-based) raise."""

    handle_size = 64

    def __init__(self, fail_fetch_at=None):
        self.buffers = {}
        self.events = itertools.count(1)
        self.fetches = 0
        self.opened = []
        self.fail_fetch_at = fail_fetch_at

    @staticmethod
    def _name(kind: bytes, n: int) -> bytes:
        return kind + n.to_bytes(8, "little") + bytes(55)

    def device_uuid(self):
        return "host-double"

    def malloc(self, nbytes):
        buf = ctypes.create_string_buffer(nbytes)
        self.buffers[ctypes.addressof(buf)] = buf
        return ctypes.addressof(buf)

    def free(self, ptr):
        del self.buffers[ptr]

    def mem_handle(self, ptr):
        return self._name(b"M", ptr)

    def open_mem(self, handle):
        self.opened.append(handle)
        return int.from_bytes(handle[1:9], "little")

    def close_mem(self, ptr):
        pass

    def event_create(self):
        return next(self.events)

    def event_handle(self, ev):
        return self._name(b"E", ev)

    def open_event(self, handle):
        return int.from_bytes(handle[1:9], "little")

    def event_destroy(self, ev):
        pass

    def copy(self, dst, src, nbytes, stream):
        ctypes.memmove(dst, src, nbytes)

    def record(self, ev, stream):
        pass

    def fetch(self, dst, src, nbytes, ev, stream):
        self.fetches += 1
        if self.fetches == self.fail_fetch_at:
            raise RuntimeError("kv_ipc_fetch: CUDA error 201 (planted)")
        ctypes.memmove(dst, src, nbytes)
        return 0.0, 0.0


@pytest.fixture
def ipc_double(monkeypatch):
    """Install a transfer server on the handle-layer double (CPU), as
    get_transfer_server would after a passing probe."""
    def install(**kw):
        srv = dt.IpcTransferServer(HostHandles(**kw), torch.device("cpu"),
                                   {"node": "boot", "device": "host-double"})
        monkeypatch.setenv("DYN_KV_TRANSFER_SERVER", "1")
        monkeypatch.setattr(dt, "_server", srv)
        monkeypatch.setattr(dt, "_server_failed", False)
        return srv
    return install


async def _torch_pair(rt, case="fp32", chunk_bytes=2048):
    _, tm, kv = _models(case)

    def cfg(role):
        return EngineConfig(model_config=tm, kv_cache_dtype=kv, role=role,
                            transfer_chunk_bytes=chunk_bytes, **ECFG)

    pw = await TorchEngineWorker(rt, cfg("prefill"), component="prefill",
                                 params=_torch_params(case),
                                 device="cpu").start()
    dw = await TorchEngineWorker(rt, cfg("decode"), component="backend",
                                 params=_torch_params(case),
                                 device="cpu").start()
    return pw, dw


async def _handoff(rt, pw, dw, prompt, rid, n=6):
    """Prefill hop on the prefill worker, then the decode request with its
    kv_transfer_params: the decode stream."""
    pclient = await rt.namespace("dynamo").component("prefill").endpoint(
        "generate").client().start()
    dclient = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        frames = [LLMEngineOutput.from_dict(o) async for o in
                  pclient.generate(_req(False, prompt, rid, n,
                                        [DISAGG_ANNOTATION]).to_dict())]
        req = _req(False, prompt, rid, n)
        req.disaggregated_params = frames[0].kv_transfer_params
        return [t async for o in dclient.generate(req.to_dict())
                for t in o.get("token_ids", [])]
    finally:
        await pclient.close()
        await dclient.close()


def _runtime():
    return DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex)


@pytest.mark.parametrize("case", ["fp32", "int8"])
async def test_device_tier_control_flow_on_the_double(case, ipc_double,
                                                      monkeypatch):
    """torch -> torch over the request plane (the broker off): the chunk
    ops ask via cuda_ipc, chunks are eight frames wide, one staging
    buffer serves the pull and returns to the pool on close, and the
    landed blocks are the sender's."""
    expect, jexpect = await _aggregated(case)
    assert expect == jexpect
    srv = ipc_double()
    monkeypatch.setattr(broker, "lookup_engine", lambda _id: None)
    rt = await _runtime().start()
    pw, dw = await _torch_pair(rt, case)
    sent, landed, vias = {}, {}, []
    _record_gathers(pw.engine, sent)
    _record_torch_injects(dw.engine, landed)
    inner = pw.engine.extract_parked_chunk

    async def extract(rid, start, count, **kw):
        vias.append((start, count, kw.get("to_host", True)))
        held = len(pw._chunk_refs)
        assert held <= 1  # chunk i is released before i + 1 is staged
        return await inner(rid, start, count, **kw)

    pw.engine.extract_parked_chunk = extract
    try:
        tokens = await _handoff(rt, pw, dw, PROMPT, "d1")
        assert tokens == expect
        stats = dw.pull_stats["d1"]
        assert stats["device_chunks"] == 1 and "host_chunks" not in stats
        # 6 blocks: one frame bound a chunk (2048 bytes), widened 8x
        assert vias == [(0, 6, False)]
        assert dw.engine.metrics["pull_blocks"] == 6
        assert "pull_host_chunk_bytes_max" not in dw.engine.metrics
        _assert_same_blocks(sent, landed, 1)
        await _wait(lambda: not pw.engine._parked, "parked KV released")
        assert len(pw._chunk_refs) == 0 and len(srv._free) == 1
        # the receiver opened the sender's buffer once
        assert len(srv.handles.opened) == 1
        # a second pull reuses the buffer and its opened handle
        assert await _handoff(rt, pw, dw, PROMPT, "d2") == expect
        assert dw.pull_stats["d2"]["device_chunks"] == 1
        assert len(srv._free) == 1 and len(srv.handles.opened) == 1
    finally:
        await pw.close()
        await dw.close()
        await rt.shutdown()
    # close freed the idle buffer
    assert not srv._free and not srv.handles.buffers


async def test_failed_device_chunk_sends_the_rest_to_host_frames(
        ipc_double, monkeypatch):
    """The second of two device chunks fails to copy: it and every later
    chunk of that pull arrive as host frames, and the stream holds."""
    expect, jexpect = await _aggregated("fp32", prompt=LONG_PROMPT)
    assert expect == jexpect
    srv = ipc_double(fail_fetch_at=2)
    monkeypatch.setattr(broker, "lookup_engine", lambda _id: None)
    rt = await _runtime().start()
    pw, dw = await _torch_pair(rt)
    sent, landed = {}, {}
    _record_gathers(pw.engine, sent)
    _record_torch_injects(dw.engine, landed)
    try:
        assert await _handoff(rt, pw, dw, LONG_PROMPT, "f1") == expect
        stats = dw.pull_stats["f1"]
        assert stats["device_chunks"] == 1 and stats["fallbacks"] == 1
        assert stats["host_chunks"] == 1
        assert stats["host_bytes"] == 2 * dw.engine.kv_wire_layout() \
            .block_bytes()
        assert dw.engine.metrics["pull_blocks"] == 10
        # blocks [8, 10) gathered twice: staged (not consumed), then as a
        # host frame; the landed bytes are the sender's either way
        _assert_same_blocks(sent, landed, 2)
        await _wait(lambda: not pw.engine._parked, "parked KV released")
        assert len(pw._chunk_refs) == 0 and len(srv._free) == 1
    finally:
        await pw.close()
        await dw.close()
        await rt.shutdown()


async def test_load_loop_sweeps_a_receiver_that_never_closed(ipc_double):
    srv = ipc_double()
    rt = await _runtime().start()
    pw, dw = await _torch_pair(rt)
    try:
        slot, _ = srv.stage([torch.zeros(8)])
        pw._chunk_refs.park("ghost", dt.next_uuid(), (srv, slot))
        pw._chunk_refs._now = lambda: 1e9  # far past the parked TTL
        await _wait(lambda: len(pw._chunk_refs) == 0, "swept", 5.0)
        assert srv._free == [slot]
    finally:
        await pw.close()
        await dw.close()
        await rt.shutdown()


# ---------------------------------------------------------------------------
# across packages: host frames both ways
# ---------------------------------------------------------------------------


class _StubJaxServer:
    def address(self):
        return "127.0.0.1:1"


@pytest.mark.parametrize("direction,opt_in", [("torch_to_jax", "0"),
                                              ("torch_to_jax", "1"),
                                              ("jax_to_torch", "1")])
async def test_cross_package_pulls_take_host_frames(direction, opt_in,
                                                    ipc_double, monkeypatch,
                                                    tmp_path):
    """A JAX receiver ignores the torch sender's "cuda_ipc", and a torch
    receiver (with the device tier itself) ignores the JAX sender's
    "transfer_addr": both pull host frames and stream what the
    aggregated engines stream."""
    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
    from test_torch_disagg import _jax_params, _record_jax_injects

    expect, jexpect = await _aggregated("fp32")
    assert expect == jexpect
    if opt_in == "1":
        ipc_double()  # the torch worker has the device tier
    else:
        monkeypatch.setenv("DYN_KV_TRANSFER_SERVER", "0")
    # the JAX worker, when it sends, advertises a transfer server
    monkeypatch.setattr(jdt, "get_transfer_server",
                        lambda: _StubJaxServer())
    jm, tm, kv = _models("fp32")
    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="inproc")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    jrole, trole = (("decode", "prefill") if direction == "torch_to_jax"
                    else ("prefill", "decode"))
    comp = {"prefill": "prefill", "decode": "backend"}
    jw = await JaxEngineWorker(jrt, JaxEngineConfig(
        model_config=jm, kv_cache_dtype=kv, transfer_chunk_bytes=2048,
        role=jrole, **ECFG), component=comp[jrole],
        params=_jax_params("fp32")).start()
    tw = await TorchEngineWorker(prt, EngineConfig(
        model_config=tm, kv_cache_dtype=kv, transfer_chunk_bytes=2048,
        role=trole, **ECFG), component=comp[trole],
        params=_torch_params("fp32"), device="cpu").start()
    sender, receiver = (tw, jw) if direction == "torch_to_jax" else (jw, tw)
    headers, vias = [], []
    # what each sender's open answers, and how each chunk was asked for
    if sender is tw:
        inner_extract = tw.engine.extract_parked_chunk

        async def extract(rid, start, count, **kw):
            vias.append(kw.get("to_host", True))
            return await inner_extract(rid, start, count, **kw)

        tw.engine.extract_parked_chunk = extract
        inner_open = jtransfer.RequestPlanePullSource.open

        async def jopen(self):
            headers.append(await inner_open(self))
            return headers[-1]

        monkeypatch.setattr(jtransfer.RequestPlanePullSource, "open", jopen)
    else:
        inner_open = transfer.RequestPlanePullSource.open

        async def topen(self):
            headers.append(await inner_open(self))
            return headers[-1]

        monkeypatch.setattr(transfer.RequestPlanePullSource, "open", topen)
    sent, landed = {}, {}
    _record_gathers(sender.engine, sent)
    (_record_torch_injects if receiver is tw
     else _record_jax_injects)(receiver.engine, landed)
    pclient = await jrt.namespace("dynamo").component("prefill").endpoint(
        "generate").client().start()
    dclient = await jrt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        await pclient.wait_for_instances()
        await dclient.wait_for_instances()
        from dynamo_tpu.protocols.llm import DISAGG_ANNOTATION as JAX_DISAGG
        frames = [o async for o in pclient.generate(
            _req(True, PROMPT, "x1", 6, [JAX_DISAGG]).to_dict())]
        req = _req(True, PROMPT, "x1", 6)
        req.disaggregated_params = frames[-1]["kv_transfer_params"]
        tokens = [t async for o in dclient.generate(req.to_dict())
                  for t in o.get("token_ids", [])]
        assert tokens == (expect if receiver is tw else jexpect)
        assert receiver.engine.metrics["prefill_tokens"] == 0
        assert receiver.engine.metrics["pull_blocks"] == 6
        assert len(sent) == 6  # one host frame a block (2048-byte bound)
        _assert_same_blocks(sent, landed)
        assert len(headers) == 1
        if sender is tw:
            assert ("cuda_ipc" in headers[0]) == (opt_in == "1")
            assert vias == [True] * 6
        else:
            assert headers[0]["transfer_addr"] == "127.0.0.1:1"
            stats = tw.pull_stats["x1"]
            assert stats["host_chunks"] == 6 and "device_chunks" not in stats
        await _wait(lambda: not sender.engine._parked, "parked KV released")
    finally:
        await pclient.close()
        await dclient.close()
        await tw.close()
        await jw.close()
        await prt.shutdown()
        await jrt.shutdown()

"""Tier-2 device-to-device KV transfer across processes: CUDA IPC.

The counterpart of dynamo_tpu/disagg/device_transfer.py, where the JAX
package moves device arrays between processes through its transfer
server.  Here the two processes share a card, and CUDA IPC is the
transport (csrc/kv_ipc.cu, built by ops/_build.py and loaded over
ctypes): the sender stages each chunk in a buffer of its own, and the
receiver opens that buffer's handle and copies the chunk out, device to
device.  Payload bytes never ride the request plane; only per-chunk
metadata does (the uuid, the buffer's and its event's handles, the
parts' dtypes, shapes and offsets), over the same `kv_pull` ops as the
host-staged tier.

Availability is probed once per process, with a real round trip: a
buffer and an event exported here, opened and written by a child
process, read back here.  It is opt-in, as in JAX: DYN_KV_TRANSFER_SERVER
in 1/true/yes/on.  Without it, on the CPU, or when the probe fails,
`get_transfer_server()` is None and pulls take host-staged frames.  The
capability rides the kv_pull header under its own key, "cuda_ipc":
{"node": the host's boot id, "device": the card's UUID}; a receiver
negotiates the tier per pull when both ends have it and name the same
node and card.  A JAX peer neither sends nor reads that key (and the
port ignores JAX's "transfer_addr"), so mixed pairs take host frames.
"""

from __future__ import annotations

import asyncio
import ctypes
import itertools
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import obs
from .transfer import RequestPlanePullSource, dtype_name, torch_dtype

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_server: Optional["IpcTransferServer"] = None
_server_failed = False
_uuid_counter = itertools.count(1)

# part offsets inside a staging buffer
_ALIGN = 256
# staging buffers are sized in these steps, so chunks of a few sizes share
# a buffer
_SLOT_STEP = 2 * 1024 * 1024
# the availability probe's buffer and its child's time limit
_PROBE_BYTES = 4096
_PROBE_TIMEOUT_S = 120.0


def transfer_enabled() -> bool:
    """The opt-in, parsed as the JAX package parses it."""
    return os.environ.get("DYN_KV_TRANSFER_SERVER", "0").lower() in (
        "1", "true", "yes", "on")


def get_transfer_server() -> Optional["IpcTransferServer"]:
    """The process-wide CUDA IPC transfer server, started at first use;
    None without the opt-in (DYN_KV_TRANSFER_SERVER), without CUDA, or
    when the probe's cross-process round trip fails."""
    global _server, _server_failed
    if not transfer_enabled():
        return None
    with _lock:
        if _server is not None or _server_failed:
            return _server
        try:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device")
            dev = torch.device("cuda", torch.cuda.current_device())
            handles = CudaIpcHandles(dev.index)
            handles.probe()
            _server = IpcTransferServer(handles, dev, capability(handles))
            logger.info("CUDA IPC transfer server on %s (%s)", dev,
                        _server.capability["device"])
        except Exception as e:
            logger.info("CUDA IPC unavailable (%s); device-to-device "
                        "pulls fall back to host staging", e)
            _server_failed = True
        return _server


def next_uuid() -> int:
    return next(_uuid_counter)


def capability(handles: "CudaIpcHandles") -> Dict[str, str]:
    """Where this process's buffers live: the host's boot id (two
    containers of one host share it) and the card's UUID."""
    with open("/proc/sys/kernel/random/boot_id") as f:
        node = f.read().strip()
    return {"node": node, "device": handles.device_uuid()}


_PROBE_PEER = """\
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
P, I = ctypes.c_void_p, ctypes.c_int
lib.kv_ipc_probe_peer.argtypes = [I, P, P, I, ctypes.c_size_t]
lib.kv_ipc_probe_peer.restype = I
sys.exit(lib.kv_ipc_probe_peer(int(sys.argv[2]), bytes.fromhex(sys.argv[3]),
                               bytes.fromhex(sys.argv[4]),
                               int(sys.argv[5]), int(sys.argv[6])))
"""


class CudaIpcHandles:
    """The handle layer: csrc/kv_ipc.cu's C entries, each checked.
    Pointers, events and streams are Python ints; handles are bytes.  A
    test may stand a double with the same methods in its place."""

    def __init__(self, device_index: int):
        from ..ops._build import load_library

        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        PF = ctypes.POINTER(ctypes.c_float)
        self.lib = load_library("kv_ipc", (
            ("kv_ipc_handle_size", (), I),
            ("kv_ipc_error_string", (I,), ctypes.c_char_p),
            ("kv_ipc_device_uuid", (I, P), I),
            ("kv_ipc_malloc", (I, S, ctypes.POINTER(P)), I),
            ("kv_ipc_free", (I, P), I),
            ("kv_ipc_mem_handle", (P, P), I),
            ("kv_ipc_open_mem", (I, P, ctypes.POINTER(P)), I),
            ("kv_ipc_close_mem", (I, P), I),
            ("kv_ipc_event_create", (I, ctypes.POINTER(P)), I),
            ("kv_ipc_event_handle", (P, P), I),
            ("kv_ipc_open_event", (I, P, ctypes.POINTER(P)), I),
            ("kv_ipc_event_destroy", (P,), I),
            ("kv_ipc_copy", (I, P, P, S, P), I),
            ("kv_ipc_record", (I, P, P), I),
            ("kv_ipc_fetch", (I, P, P, S, P, P, PF, PF), I),
            ("kv_ipc_fill", (I, P, I, S, P), I),
            ("kv_ipc_probe_peer", (I, P, P, I, S), I),
            ("kv_ipc_read", (I, P, P, S), I),
        ))
        self.device = device_index
        self.handle_size = self.lib.kv_ipc_handle_size()

    def _check(self, status: int, what: str) -> None:
        if status != 0:
            msg = self.lib.kv_ipc_error_string(status)
            raise RuntimeError(f"{what}: CUDA error {status}: "
                               f"{msg.decode() if msg else 'unknown'}")

    def _out_ptr(self, fn: str, *args) -> int:
        out = ctypes.c_void_p()
        self._check(getattr(self.lib, fn)(*args, ctypes.byref(out)), fn)
        return int(out.value or 0)

    def _handle(self, fn: str, obj: int) -> bytes:
        buf = ctypes.create_string_buffer(self.handle_size)
        self._check(getattr(self.lib, fn)(obj, buf), fn)
        return buf.raw

    def device_uuid(self) -> str:
        buf = ctypes.create_string_buffer(16)
        self._check(self.lib.kv_ipc_device_uuid(self.device, buf),
                    "kv_ipc_device_uuid")
        return buf.raw.hex()

    def malloc(self, nbytes: int) -> int:
        return self._out_ptr("kv_ipc_malloc", self.device, nbytes)

    def free(self, ptr: int) -> None:
        self._check(self.lib.kv_ipc_free(self.device, ptr), "kv_ipc_free")

    def mem_handle(self, ptr: int) -> bytes:
        return self._handle("kv_ipc_mem_handle", ptr)

    def open_mem(self, handle: bytes) -> int:
        return self._out_ptr("kv_ipc_open_mem", self.device, handle)

    def close_mem(self, ptr: int) -> None:
        self._check(self.lib.kv_ipc_close_mem(self.device, ptr),
                    "kv_ipc_close_mem")

    def event_create(self) -> int:
        return self._out_ptr("kv_ipc_event_create", self.device)

    def event_handle(self, ev: int) -> bytes:
        return self._handle("kv_ipc_event_handle", ev)

    def open_event(self, handle: bytes) -> int:
        return self._out_ptr("kv_ipc_open_event", self.device, handle)

    def event_destroy(self, ev: int) -> None:
        self._check(self.lib.kv_ipc_event_destroy(ev),
                    "kv_ipc_event_destroy")

    def copy(self, dst: int, src: int, nbytes: int, stream: int) -> None:
        self._check(self.lib.kv_ipc_copy(self.device, dst, src, nbytes,
                                         stream), "kv_ipc_copy")

    def record(self, ev: int, stream: int) -> None:
        self._check(self.lib.kv_ipc_record(self.device, ev, stream),
                    "kv_ipc_record")

    def fetch(self, dst: int, src: int, nbytes: int, ev: int,
              stream: int) -> Tuple[float, float]:
        """Wait for `ev` on `stream`, copy, block until landed: returns
        the device's (wait ms, copy ms)."""
        wait, cp = ctypes.c_float(), ctypes.c_float()
        self._check(self.lib.kv_ipc_fetch(
            self.device, dst, src, nbytes, ev, stream, ctypes.byref(wait),
            ctypes.byref(cp)), "kv_ipc_fetch")
        return float(wait.value), float(cp.value)

    def probe(self) -> None:
        """Raise unless a buffer and an event exported here can be opened
        and written by another process: a child (standard library only)
        waits on the event, overwrites the buffer, and this process reads
        the child's bytes back."""
        from ..ops._build import library_path

        ptr = self.malloc(_PROBE_BYTES)
        ev = self.event_create()
        try:
            self._check(self.lib.kv_ipc_fill(self.device, ptr, 0x5A,
                                             _PROBE_BYTES, ev), "kv_ipc_fill")
            proc = subprocess.run(
                [sys.executable, "-c", _PROBE_PEER,
                 str(library_path("kv_ipc")), str(self.device),
                 self.mem_handle(ptr).hex(), self.event_handle(ev).hex(),
                 str(0x5A), str(_PROBE_BYTES)],
                capture_output=True, timeout=_PROBE_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"the probe's peer exited {proc.returncode}: "
                    f"{proc.stderr.decode()[-500:]}")
            host = ctypes.create_string_buffer(_PROBE_BYTES)
            self._check(self.lib.kv_ipc_read(self.device, host, ptr,
                                             _PROBE_BYTES), "kv_ipc_read")
            if host.raw != bytes([0x5B]) * _PROBE_BYTES:
                raise RuntimeError("the probe's peer wrote other bytes")
        finally:
            self.event_destroy(ev)
            self.free(ptr)


class _Slot:
    """A staging buffer with its interprocess event."""

    def __init__(self, handles, nbytes: int):
        self.nbytes = nbytes
        self.ptr = handles.malloc(nbytes)
        self.event = handles.event_create()
        self.handle = handles.mem_handle(self.ptr)
        self.event_handle = handles.event_handle(self.event)


class IpcTransferServer:
    """Both ends of the device tier in one process.

    Sender: `stage(arrays)` copies a gathered chunk into a staging buffer
    (a pool grown to the number of chunks outstanding at once, each
    allocated once) on the current stream, records the buffer's event
    after the copies, and returns the buffer and the metadata the chunk
    op answers with; `release(buffer)` returns it to the pool once the
    receiver has consumed the chunk (SenderChunkRegistry).

    Receiver: `fetch(meta)` opens the sender's buffer and event handles
    (once per process each), waits for the event and copies the chunk
    into tensors of its own on a side stream, so the copy queues behind
    none of this engine's bursts, and returns once the copy has landed:
    the sender may reuse the buffer as soon as the next chunk op
    arrives."""

    def __init__(self, handles, device: torch.device,
                 capability: Dict[str, str]):
        self.handles = handles
        self.device = device
        self.capability = dict(capability)
        self._lock = threading.Lock()
        self._free: List[_Slot] = []
        self._opened: Dict[bytes, int] = {}
        self._events: Dict[bytes, int] = {}
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def reaches(self, cap: Any) -> bool:
        """True when a sender advertising `cap` shares this node and
        card."""
        return (isinstance(cap, dict)
                and cap.get("node") == self.capability["node"]
                and cap.get("device") == self.capability["device"])

    # -- sender ------------------------------------------------------------
    def stage(self, arrays) -> Tuple[_Slot, Dict[str, Any]]:
        parts, off = [], 0
        for a in arrays:
            parts.append([dtype_name(a.dtype), list(a.shape), off])
            off += -(-a.numel() * a.element_size() // _ALIGN) * _ALIGN
        slot = self._take(off)
        stream = (torch.cuda.current_stream(self.device).cuda_stream
                  if self.device.type == "cuda" else 0)
        for a, (_, _, o) in zip(arrays, parts):
            a = a.contiguous()
            self.handles.copy(slot.ptr + o, a.data_ptr(),
                              a.numel() * a.element_size(), stream)
        self.handles.record(slot.event, stream)
        return slot, {"handle": slot.handle, "event": slot.event_handle,
                      "nbytes": off, "parts": parts}

    def _take(self, nbytes: int) -> _Slot:
        with self._lock:
            fits = [s for s in self._free if s.nbytes >= nbytes]
            if fits:
                slot = min(fits, key=lambda s: s.nbytes)
                self._free.remove(slot)
                return slot
        return _Slot(self.handles,
                     max(_SLOT_STEP, -(-nbytes // _SLOT_STEP) * _SLOT_STEP))

    def release(self, slot: _Slot) -> None:
        with self._lock:
            self._free.append(slot)

    # -- receiver ----------------------------------------------------------
    def _open(self, handle: bytes, cache: Dict[bytes, int],
              opener: Callable[[bytes], int]) -> int:
        with self._lock:
            got = cache.get(handle)
            if got is None:
                got = cache[handle] = opener(handle)
            return got

    def fetch(self, meta: Dict[str, Any]
              ) -> Tuple[List[torch.Tensor], float, float]:
        """Blocking: the chunk's tensors on this process's device, and the
        device's event-wait and copy times in ms."""
        src = self._open(bytes(meta["handle"]), self._opened,
                         self.handles.open_mem)
        ev = self._open(bytes(meta["event"]), self._events,
                        self.handles.open_event)
        nbytes = int(meta["nbytes"])
        if self._stream is None:
            dst = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            wait_ms, copy_ms = self.handles.fetch(dst.data_ptr(), src,
                                                  nbytes, ev, 0)
        else:
            with torch.cuda.stream(self._stream):
                dst = torch.empty(nbytes, dtype=torch.uint8,
                                  device=self.device)
            wait_ms, copy_ms = self.handles.fetch(
                dst.data_ptr(), src, nbytes, ev, self._stream.cuda_stream)
            # the engine injects on its own stream: the buffer is not
            # reused before that stream's work queued at its free has run
            dst.record_stream(torch.cuda.default_stream(self.device))
        out = []
        for name, shape, off in meta["parts"]:
            dt = torch_dtype(name)
            n = 1
            for d in shape:
                n *= int(d)
            out.append(dst[off:off + n * dt.itemsize].view(dt)
                       .view(*shape))
        return out, wait_ms, copy_ms

    def close(self) -> None:
        """Free the idle staging buffers and close every handle this
        process opened (buffers out on a chunk stay with their
        registry)."""
        with self._lock:
            free, self._free = self._free, []
            opened, self._opened = self._opened, {}
            events, self._events = self._events, {}
        for slot in free:
            self.handles.event_destroy(slot.event)
            self.handles.free(slot.ptr)
        for ptr in opened.values():
            self.handles.close_mem(ptr)
        for ev in events.values():
            self.handles.event_destroy(ev)


class SenderChunkRegistry:
    """Sender-side refs for chunks staged for the device tier.

    The receiver copies a chunk out before it asks for the next one, so
    the registry keeps AT MOST ONE outstanding chunk per request
    (registering chunk i+1 releases chunk i) and drops everything for a
    request on close or TTL sweep: a receiver that dies mid-pull must not
    pin device memory forever (the worker sweeps from its load loop).
    `on_drop` receives each dropped ref (the worker returns the staging
    buffer to its pool)."""

    def __init__(self, on_drop: Optional[Callable[[Any], None]] = None):
        self._now = time.monotonic
        self._parked: Dict[str, Tuple[int, Any, float]] = {}
        self._on_drop = on_drop

    def _drop(self, entry) -> None:
        if entry is not None and self._on_drop is not None:
            self._on_drop(entry[1])

    def park(self, request_id: str, uuid: int, arrays) -> None:
        self._drop(self._parked.get(request_id))
        self._parked[request_id] = (uuid, arrays, self._now())

    def release(self, request_id: str) -> None:
        self._drop(self._parked.pop(request_id, None))

    def sweep(self, max_age_s: float = 120.0) -> int:
        """Drop refs whose receiver never finished; mirrors the engine's
        parked-KV TTL."""
        cutoff = self._now() - max_age_s
        stale = [r for r, (_, _, t) in self._parked.items() if t < cutoff]
        for r in stale:
            self.release(r)
        return len(stale)

    def clear(self) -> int:
        """Drop every ref (the worker's drain and close)."""
        ids = list(self._parked)
        for r in ids:
            self.release(r)
        return len(ids)

    def __len__(self) -> int:
        return len(self._parked)


class NegotiatedPullSource(RequestPlanePullSource):
    """Receiver pull source that negotiates the device tier per pull.

    Opens over the request plane like the host-staged tier (the base
    class).  If the sender's header advertises CUDA IPC on this node and
    card, and this process has it too, each chunk op asks for the chunk
    `via: "cuda_ipc"` and copies it device to device; otherwise chunks
    arrive as host byte frames.  A failed device chunk sends the rest of
    that pull to host frames.  `stats`, when given, accumulates this
    pull's counts and times: the open RPC's seconds, device and host
    chunks and bytes, the device chunks' RPC seconds and their
    event-wait and copy ms."""

    def __init__(self, client, params: Dict[str, Any],
                 device: Optional[torch.device] = None,
                 stats: Optional[Dict[str, float]] = None):
        super().__init__(client, params)
        self.device = device
        self.stats = stats if stats is not None else {}
        self._server: Optional[IpcTransferServer] = None

    @property
    def device_resident(self) -> bool:
        """True once the device tier is negotiated: chunks land as device
        tensors, so the receiver may size chunks for the device path."""
        return self._server is not None

    def _add(self, key: str, value: float) -> None:
        self.stats[key] = self.stats.get(key, 0) + value

    async def open(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        header = await super().open()
        self._add("open_s", time.perf_counter() - t0)
        cap = header.get("cuda_ipc")
        if cap and self.device is not None:
            srv = get_transfer_server()
            if srv is not None and srv.device == self.device \
                    and srv.reaches(cap):
                self._server = srv
                logger.info("kv pull %s: device to device over CUDA IPC",
                            self.params["request_id"])
        return header

    async def chunk(self, b0: int, n: int):
        if self._server is None:
            return await self._host_chunk(b0, n)
        try:
            return await self._device_chunk(b0, n)
        except Exception:
            # a failed device chunk (a handle that does not open, a peer
            # that refused) degrades the REST of this pull to host frames
            logger.warning("device chunk [%d,%d) failed; host-staged "
                           "fallback", b0, b0 + n, exc_info=True)
            self._server = None
            self._add("fallbacks", 1)
            return await self._host_chunk(b0, n)

    async def _host_chunk(self, b0: int, n: int):
        arrs = await RequestPlanePullSource.chunk(self, b0, n)
        self._add("host_chunks", 1)
        self._add("host_bytes", sum(a.numel() * a.element_size()
                                    for a in arrs))
        return arrs

    async def _device_chunk(self, b0: int, n: int):
        t0 = time.perf_counter()
        with obs.span("disagg_chunk", request_id=self.params["request_id"],
                      start=int(b0), count=int(n), via="cuda_ipc"):
            reply = await self._call({
                "op": "chunk", "request_id": self.params["request_id"],
                "start": int(b0), "count": int(n), "via": "cuda_ipc",
            })
        rpc_s = time.perf_counter() - t0
        if "uuid" not in reply:
            raise RuntimeError("sender refused a CUDA IPC chunk")
        if (int(reply["block_start"]), int(reply["block_count"])) != (b0, n):
            raise ValueError(
                f"sender staged blocks [{reply['block_start']},"
                f"{reply['block_start'] + reply['block_count']}) for a "
                f"request of [{b0},{b0 + n})")
        self._check_parts(reply["parts"], n)
        arrs, wait_ms, copy_ms = await asyncio.to_thread(
            self._server.fetch, reply)
        self._add("device_chunks", 1)
        self._add("device_bytes", int(reply["nbytes"]))
        self._add("rpc_s", rpc_s)
        self._add("wait_ms", wait_ms)
        self._add("copy_ms", copy_ms)
        return tuple(arrs)

    def _check_parts(self, parts, n: int) -> None:
        """The staged parts must be the header layout's chunk: a foreign
        shape or dtype must not land in the cache."""
        lo = self.layout
        want = [(lo.dtype, [lo.num_layers, n, lo.block_size, lo.kv_heads,
                            lo.head_dim]),
                (lo.dtype, [lo.num_layers, n, lo.block_size, lo.kv_heads,
                            lo.hd_v])]
        if lo.scales:
            want += [("float32", [lo.num_layers, n, lo.block_size,
                                  lo.kv_heads])] * 2
        got = [(p[0], [int(d) for d in p[1]]) for p in parts]
        if got != want:
            raise ValueError(f"staged chunk parts {got} do not match the "
                             f"layout's {want}")

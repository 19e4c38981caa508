"""Cross-worker G2 pull: onboard KV blocks from a peer's host tiers.

A copy of dynamo_tpu/kvbm/remote.py.  Every
worker publishes tiered KV events (router/events.py), so a
`RemoteBlockIndex` built from the same event stream the router consumes
tells any worker which peers hold a block's G2/G3/G4 copy.  The pull
rides the request plane (the `kvbm_pull` endpoint, host-staged like
disagg/transfer.py), and the pulled payloads are staged into the LOCAL
G2, where admission's `_try_onboard` finds them.

Flow (engine/core.py generate()):
  request arrives -> leading block hashes missing locally -> the index
  names the peer with the longest run -> pull over TCP -> stage into the
  local G2 -> admission onboards from G2 instead of recomputing prefill.

Frames carry raw bytes, numpy's dtype names and shapes, with the crc32
footer of kvbm/pools.py, as the JAX package's encode_block makes them.
On the request plane the block hashes travel as 16-byte big-endian bytes
(router/events.py hash_to_wire), as the KV events carry them, and plain
ints are read too: a 128-bit PLH is out of msgpack's integer range, so
int hashes cannot be encoded on the wire.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from .. import chaos
from ..disagg.transfer import dtype_name, torch_dtype
from ..router.events import (
    KvCacheEvent,
    hash_to_wire,
    kv_event_subject,
    wire_to_hash,
)
from ..runtime.retry import KVBM_POLICY, call_with_retry
from .pools import BlockIntegrityError, block_bytes, block_crc

logger = logging.getLogger(__name__)

# tiers a peer can serve from host memory or disk without device work.
# g4 rides the same path: a worker WITHOUT the shared mount pulls object
# store blobs through a peer that has one (the peer's fetch promotes the
# blob into its G2 and streams it)
PULLABLE_TIERS = ("g2", "g3", "g4")


class RemoteBlockIndex:
    """hash -> worker -> tiers for pullable (G2/G3/G4) blocks, built by
    following the component's KV event stream."""

    def __init__(self, runtime, namespace: str, component: str,
                 self_worker_id: int):
        self.runtime = runtime
        self.subject = kv_event_subject(namespace, component)
        self.self_id = self_worker_id
        # per-tier tracking: a G2 -> G3 demotion is (g3 stored, g2
        # removed) on the SAME worker, which must not erase the holder
        self.holders: Dict[int, Dict[int, Set[str]]] = {}
        # poisoned-source book: worker -> corrupt frames served.  A suspect
        # is dropped from the index (its future stored events re-admit it)
        self.suspects: Dict[int, int] = {}
        self._cancel = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "RemoteBlockIndex":
        self._task = asyncio.get_running_loop().create_task(self._follow())
        return self

    def apply(self, ev: KvCacheEvent) -> None:
        """Fold one KV event into the index."""
        if ev.op == "removed" and ev.tier == "g4":
            # shared-store GC: one sweep (by ANY worker, this one
            # included) kills the blob for every holder
            for h in ev.block_hashes:
                self._discard(h, None, "g4")
            return
        if ev.worker_id == self.self_id:
            return  # local blocks are found through the local kvbm
        if ev.op == "cleared":
            self.drop_worker(ev.worker_id)
        elif ev.tier not in PULLABLE_TIERS:
            return
        elif ev.op == "stored":
            for h in ev.block_hashes:
                self.holders.setdefault(h, {}).setdefault(
                    ev.worker_id, set()).add(ev.tier)
        elif ev.op == "removed":
            for h in ev.block_hashes:
                self._discard(h, ev.worker_id, ev.tier)

    def _discard(self, h: int, worker: Optional[int], tier: str) -> None:
        """Drop `tier` of hash `h` from `worker` (None: every worker)."""
        by_worker = self.holders.get(h)
        if by_worker is None:
            return
        for w in ([worker] if worker is not None else list(by_worker)):
            tiers = by_worker.get(w)
            if tiers is None:
                continue
            tiers.discard(tier)
            if not tiers:
                del by_worker[w]
        if not by_worker:
            del self.holders[h]

    async def _follow(self) -> None:
        try:
            async for _subj, payload in self.runtime.event_plane.subscribe(
                    self.subject, self._cancel):
                try:
                    ev = KvCacheEvent.from_wire(payload)
                except (KeyError, TypeError, ValueError, AttributeError):
                    continue
                self.apply(ev)
        except asyncio.CancelledError:
            pass

    def drop_worker(self, worker_id: int) -> None:
        for h in list(self.holders):
            by_worker = self.holders[h]
            by_worker.pop(worker_id, None)
            if not by_worker:
                del self.holders[h]

    def mark_suspect(self, worker_id: int) -> None:
        """A peer served a checksum-failed frame: record it and stop
        advertising anything it holds."""
        self.suspects[worker_id] = self.suspects.get(worker_id, 0) + 1
        logger.warning(
            "kvbm peer %d marked suspect (%d corrupt frames); dropping "
            "its advertised blocks", worker_id, self.suspects[worker_id])
        self.drop_worker(worker_id)

    def best_run(self, hashes: Sequence[int]) -> Tuple[Optional[int], int]:
        """(worker, run_length): the peer holding the longest leading run
        of `hashes`."""
        first = self.holders.get(hashes[0]) if hashes else None
        if not first:
            return None, 0
        best_w, best_n = None, 0
        for w in first:
            n = 0
            for h in hashes:
                if w not in self.holders.get(h, {}):
                    break
                n += 1
            if n > best_n:
                best_w, best_n = w, n
        return best_w, best_n

    async def close(self) -> None:
        self._cancel.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass


# wire member names, in payload-tuple order (scales ride for int8 blocks)
_WIRE_MEMBERS = ("k", "v", "ks", "vs")


def encode_block(h: int, *arrays: torch.Tensor) -> Dict:
    """Block payload -> wire frame: (k, v) or (k, v, ks, vs), an int8
    block's codes and fp32 scales verbatim, with the crc32 footer of
    kvbm/pools.py block_crc (dtype and shape committed); decode_block
    verifies it."""
    d: Dict = {"h": h, "crc": block_crc(arrays)}
    for name, t in zip(_WIRE_MEMBERS, arrays):
        d[name] = block_bytes(t).tobytes()
        d[name + "d"] = dtype_name(t.dtype)
        d[name + "shape"] = list(t.shape)
    return d


def decode_block(d: Dict) -> Tuple:
    """Wire frame -> (h, *arrays), CPU tensors, `h` an int whether the
    frame carries it as an int or as wire bytes.  Raises
    BlockIntegrityError when the payload does not match its crc footer (a
    frame without one, from a peer that predates it, passes)."""
    arrays = []
    for name in _WIRE_MEMBERS:
        if name not in d:
            continue
        dt, shape = torch_dtype(d[name + "d"]), tuple(d[name + "shape"])
        buf = bytearray(d[name])  # torch.frombuffer wants it writable
        if len(buf) != dt.itemsize * int(torch.Size(shape).numel()):
            raise ValueError(f"{len(buf)} bytes do not hold {shape} "
                             f"{d[name + 'd']}")
        arrays.append(torch.frombuffer(buf, dtype=dt).reshape(shape))
    h = wire_to_hash(d["h"])
    crc = d.get("crc")
    if crc is not None and block_crc(arrays) != int(crc):
        raise BlockIntegrityError(
            f"remote KV block {h:x} failed its crc32 footer")
    return (h, *arrays)


def _tamper_frame(frame: Dict) -> Dict:
    """Chaos "corrupt" action: flip one byte of the frame's first
    payload member before decode — the wire checksum, not the injector,
    must catch it."""
    out = dict(frame)
    for name in _WIRE_MEMBERS:
        if isinstance(out.get(name), (bytes, bytearray)) and out[name]:
            b = bytearray(out[name])
            b[0] ^= 0xFF
            out[name] = bytes(b)
            break
    return out


class RemoteKvbmPuller:
    """Client side: pull a run of blocks from the best-placed peer."""

    def __init__(self, index: RemoteBlockIndex, client,
                 max_blocks: int = 64, timeout_s: float = 10.0):
        self.index = index
        self.client = client  # kvbm_pull endpoint client
        self.max_blocks = max_blocks
        self.timeout_s = timeout_s
        # attribution hook the engine installs: fired once per corrupt
        # frame with (tier="remote", block hash)
        self.on_corruption = None

    async def fetch_run(self, hashes: Sequence[int]) -> List[Tuple]:
        """Blocks for the longest leading run a single peer holds (may
        return fewer than advertised: peers evict concurrently)."""
        hashes = list(hashes)[: self.max_blocks]
        worker, run = self.index.best_run(hashes)
        if worker is None or run == 0:
            return []
        want = hashes[:run]
        out: List[Tuple] = []

        async def pull() -> None:
            # each attempt restarts the run: the leading-run contract
            # below would reject a resumed walk with a gap anyway
            out.clear()
            async for frame in self.client.generate(
                    {"hashes": [hash_to_wire(h) for h in want]},
                    instance_id=worker):
                # chaos seam: peer pull fails partway through the run /
                # slow peer / corrupt frame (key carries the frame
                # ordinal for after=N)
                act = await chaos.ahit("kvbm.remote_pull",
                                       key=f"{worker}:{len(out)}")
                if frame.get("h") is None:
                    break  # the peer's end-of-run marker (evicted mid-walk)
                if act == "corrupt":
                    frame = _tamper_frame(frame)
                try:
                    out.append(decode_block(frame))
                except BlockIntegrityError:
                    # attribute at detection time and mark the source
                    # suspect before the retry policy decides anything
                    self.index.mark_suspect(worker)
                    if self.on_corruption is not None:
                        try:
                            self.on_corruption(
                                "remote", wire_to_hash(frame.get("h") or 0))
                        except Exception:
                            logger.warning("kv corruption attribution "
                                           "failed", exc_info=True)
                    raise

        try:
            # a transient peer hiccup re-pulls with jittered backoff; the
            # deadline wraps the WHOLE retried operation, so timeout_s
            # stays the hard give-up bound for a slow or dead peer
            await asyncio.wait_for(
                call_with_retry(
                    pull, KVBM_POLICY,
                    on_retry=lambda a, e: logger.warning(
                        "kvbm pull from %d failed (attempt %d): %s",
                        worker, a, e),
                ),
                timeout=self.timeout_s)
        except asyncio.TimeoutError:
            logger.warning("kvbm pull from %d timed out after %d blocks",
                           worker, len(out))
        except Exception:
            # the peer died or evicted: whatever arrived is still usable,
            # and the leading-run contract keeps partial results consistent
            logger.warning("kvbm pull from %d failed after %d blocks",
                           worker, len(out), exc_info=True)
            self.index.drop_worker(worker)
        # the leading-run contract: a gap invalidates the tail
        usable: List[Tuple] = []
        for blk, expect in zip(out, want):
            if blk[0] != expect:
                break
            usable.append(blk)
        return usable

"""KV event protocol + worker-side publisher (the publishing half of
dynamo_tpu/router/events.py, copied, with `KvCacheEvent.from_wire` for
kvbm/remote.py's index; the indexers the router runs are the
frontend's).

Workers publish `stored` / `removed` block events on the event plane under
`kv_events.{namespace}.{component}`.  Events carry monotonically increasing
per-worker ids so routers can detect gaps; the publisher mirrors recent events
into a local ring buffer and serves a `kv_events_replay` endpoint so a router
that missed events (or just started) can recover without a full engine dump.
A replay request carrying ``{"snapshot": true}`` answers with the current
resident blocks (grouped per tier, stamped with the latest assigned event
id) instead of the ring, for a router that subscribes late.

PLHs are 128-bit, which exceeds msgpack's integer range — on the wire they are
16-byte big-endian `bytes`; in memory they are ints.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

KV_EVENT_SUBJECT_PREFIX = "kv_events"


def hash_to_wire(h: int) -> bytes:
    return int(h).to_bytes(16, "big")


def wire_to_hash(b) -> int:
    if isinstance(b, int):
        return b
    return int.from_bytes(b, "big")


@dataclass
class KvCacheEvent:
    """One batch of block stores or removals on one worker."""

    worker_id: int
    event_id: int
    op: str  # "stored" | "removed" | "cleared"
    block_hashes: List[int] = field(default_factory=list)
    # for "stored": parent hash of the first block (lineage anchor), if any
    parent_hash: Optional[int] = None
    dp_rank: int = 0
    tier: str = "g1"  # g1=HBM, g2=host, g3=disk, g4=object store

    def to_wire(self) -> Dict[str, Any]:
        return {
            "worker_id": self.worker_id,
            "event_id": self.event_id,
            "op": self.op,
            "block_hashes": [hash_to_wire(h) for h in self.block_hashes],
            "parent_hash": (
                hash_to_wire(self.parent_hash) if self.parent_hash is not None else None
            ),
            "dp_rank": self.dp_rank,
            "tier": self.tier,
        }

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "KvCacheEvent":
        ph = d.get("parent_hash")
        return KvCacheEvent(
            worker_id=d["worker_id"],
            event_id=d["event_id"],
            op=d["op"],
            block_hashes=[wire_to_hash(b) for b in d.get("block_hashes", [])],
            parent_hash=wire_to_hash(ph) if ph is not None else None,
            dp_rank=d.get("dp_rank", 0),
            tier=d.get("tier", "g1"),
        )


def kv_event_subject(namespace: str, component: str) -> str:
    return f"{KV_EVENT_SUBJECT_PREFIX}.{namespace}.{component}"


class KvEventPublisher:
    """Assigns monotonic event ids, publishes, and keeps a replay ring."""

    def __init__(self, runtime, namespace: str, component: str, worker_id: int,
                 dp_rank: int = 0, ring_size: int = 4096):
        self.runtime = runtime
        self.subject = kv_event_subject(namespace, component)
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self._next_id = 0
        self._ring: deque[KvCacheEvent] = deque(maxlen=ring_size)
        self._out: deque[KvCacheEvent] = deque()
        self._drain_task: Optional[asyncio.Task] = None
        # resident-set mirror of the netted stream (loop-thread only,
        # like id assignment): hash -> tiers it is resident in.  The
        # stream is consolidator-netted PER TIER, so stored fires when a
        # block enters a tier and removed when it leaves one — the union
        # over tiers is exactly "this worker can serve the block", and
        # the per-tier split is what a tier-aware subscriber (the fleet
        # prefix cache) needs its snapshot grouped by.
        self._resident: Dict[int, set] = {}

    def _mk(self, op: str, block_hashes: Sequence[int],
            parent_hash: Optional[int], tier: str) -> KvCacheEvent:
        ev = KvCacheEvent(
            worker_id=self.worker_id,
            event_id=self._next_id,
            op=op,
            block_hashes=list(block_hashes),
            parent_hash=parent_hash,
            dp_rank=self.dp_rank,
            tier=tier,
        )
        self._next_id += 1
        self._ring.append(ev)
        return ev

    def enqueue_batch(self, stored: Sequence[int] = (),
                      removed: Sequence[int] = (),
                      parent_hash: Optional[int] = None,
                      tier: str = "g1") -> None:
        """Record one cache mutation's events and schedule publication.

        Synchronous and loop-thread only: event ids are assigned here, so
        wire order equals call order.  Removals publish BEFORE stores — the
        allocator evicts before it registers within one mutation, and if a
        hash is evicted and immediately re-registered, a router seeing
        stored(H) then removed(H) would drop a block the engine holds.
        A single drain task publishes FIFO so batches from concurrent
        mutations never interleave on the wire."""
        if removed:
            self._out.append(self._mk("removed", removed, None, tier))
            for h in removed:
                tiers = self._resident.get(int(h))
                if tiers is not None:
                    tiers.discard(tier)
                    if not tiers:
                        del self._resident[int(h)]
        if stored:
            self._out.append(self._mk("stored", stored, parent_hash, tier))
            for h in stored:
                self._resident.setdefault(int(h), set()).add(tier)
        self._kick()

    def _kick(self) -> None:
        if self._out and (self._drain_task is None or self._drain_task.done()):
            self._drain_task = asyncio.ensure_future(self._drain())

    async def _drain(self) -> None:
        while self._out:
            ev = self._out[0]  # keep at head until published
            try:
                await self.runtime.event_plane.publish(
                    self.subject, ev.to_wire()
                )
            except Exception:
                ev._publish_attempts = getattr(ev, "_publish_attempts", 0) + 1
                if ev._publish_attempts < 3:
                    logger.warning("kv event %d publish failed; retrying",
                                   ev.event_id, exc_info=True)
                    await asyncio.sleep(0.05 * ev._publish_attempts)
                    continue
                # drop and move on: the id gap makes routers recover the
                # event from the ring via kv_events_replay
                logger.error("kv event %d dropped after retries; routers "
                             "will gap-recover from the ring", ev.event_id)
            self._out.popleft()

    async def _flush(self) -> None:
        self._kick()
        if self._drain_task is not None:
            await asyncio.shield(self._drain_task)

    async def stored(self, block_hashes: Sequence[int],
                     parent_hash: Optional[int] = None, tier: str = "g1") -> None:
        if not block_hashes:
            return
        self.enqueue_batch(stored=block_hashes, parent_hash=parent_hash,
                           tier=tier)
        await self._flush()

    async def removed(self, block_hashes: Sequence[int], tier: str = "g1") -> None:
        if not block_hashes:
            return
        self.enqueue_batch(removed=block_hashes, tier=tier)
        await self._flush()

    async def cleared(self) -> None:
        self._out.append(self._mk("cleared", [], None, "g1"))
        self._resident.clear()
        self._kick()
        await self._flush()

    # -- recovery -----------------------------------------------------------
    def replay_since(self, since_event_id: int) -> List[Dict[str, Any]]:
        return [e.to_wire() for e in self._ring if e.event_id >= since_event_id]

    def snapshot_events(self) -> List[Dict[str, Any]]:
        """The snapshot-on-subscribe payload: the resident set as
        synthetic `stored` events (one per tier), each stamped with the
        LATEST assigned event id — applying them then continuing from
        the live stream is gap-free by construction (loop-thread
        consistency: ids and the mirror advance together)."""
        last_id = max(0, self._next_id - 1)
        by_tier: Dict[str, List[int]] = {}
        for h, tiers in self._resident.items():
            for tier in tiers:
                by_tier.setdefault(tier, []).append(h)
        return [
            KvCacheEvent(
                worker_id=self.worker_id, event_id=last_id, op="stored",
                block_hashes=hashes, dp_rank=self.dp_rank, tier=tier,
            ).to_wire()
            for tier, hashes in sorted(by_tier.items())
        ]

    async def replay_handler(self, payload, ctx):
        """Endpoint handler: events >= since_event_id from the ring —
        or, with ``snapshot: true``, the current resident set (the
        warm-cache replay a late subscriber needs when the ring cannot
        reach back to the worker's birth)."""
        if payload and payload.get("snapshot"):
            for wire_ev in self.snapshot_events():
                yield wire_ev
            return
        since = int(payload.get("since_event_id", 0)) if payload else 0
        for wire_ev in self.replay_since(since):
            yield wire_ev

"""Router replica synchronization.

A copy of dynamo_tpu/router/replica_sync.py without its chaos seams
(the port has no fault-injection plane).

Ref: lib/kv-router/src/sequences/replica_sync.rs and
docs/design-docs/router-design.md:166-180.  Every frontend replica runs its
own KvRouter; each router's ActiveSequences only sees its OWN routing
decisions, so with N frontends each router underestimates worker load by
~(N-1)/N and hot workers get dogpiled.  Replica sync broadcasts the three
slot-manager transitions on the event plane —

    add(request, worker, blocks, overlap)  at pick time
    prefill_done(request)                  at first token
    free(request)                          at completion

— and every router folds its peers' transitions into its slot manager,
keyed as "request_id@router_id" so ids never collide across replicas.

Two hardening layers on top of the live stream:

  * snapshot-on-subscribe (the kv-event late-joiner contract, applied to
    slot state): a freshly started replica publishes a `subscribe` frame;
    every peer answers with a `snapshot` of its own in-flight adds, built
    at enqueue time so the single-writer outbox keeps it consistent with
    the live frames queued around it.  Without this a late-started
    frontend underestimates fleet load until every in-flight request it
    never saw completes.
  * TTL stale-reap: peers heartbeat on the sync subject; a peer silent
    for `peer_ttl_s` is presumed crashed and ALL of its entries are
    freed, so a dead replica's phantom load decays instead of pinning
    workers "busy" forever.  A lost frame therefore costs one request's
    worth of load signal until reap, not correctness (the reference
    makes the same trade).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid
from typing import Dict, Optional, Set

logger = logging.getLogger(__name__)

DEFAULT_PEER_TTL_S = 30.0
# subscribe retries: pub/sub joins are async (ZMQ SUB connect, inproc
# generator start), so the hello loop re-requests a snapshot a few times
# until one lands or we conclude there are no peers
SUBSCRIBE_ATTEMPTS = 5
SUBSCRIBE_RETRY_S = 0.05


def router_sync_subject(namespace: str, component: str) -> str:
    return f"router_sync.{namespace}.{component}"


class RouterReplicaSync:
    """Publishes this router's slot transitions and applies the peers'."""

    def __init__(self, runtime, namespace: str, component: str, sequences,
                 router_id: Optional[str] = None,
                 peer_ttl_s: Optional[float] = None):
        self.runtime = runtime
        self.subject = router_sync_subject(namespace, component)
        self.sequences = sequences
        self.router_id = router_id or uuid.uuid4().hex[:12]
        self.peer_ttl_s = (
            peer_ttl_s if peer_ttl_s is not None
            else float(os.environ.get("DYN_ROUTER_SYNC_PEER_TTL_S",
                                      DEFAULT_PEER_TTL_S)))
        self._cancel = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        # single-writer queue: publish order == transition order on the
        # wire.  Independent fire-and-forget tasks could deliver free
        # before its add (the event plane's first publish suspends setting
        # up the socket), leaving phantom load on peers until stale-reap.
        # Snapshots ride the same queue, so a snapshot built from `_own`
        # at enqueue time can never contradict the live frames around it.
        self._outbox: asyncio.Queue = asyncio.Queue()
        self._send_task: Optional[asyncio.Task] = None
        self._reap_task: Optional[asyncio.Task] = None
        self._hello_task: Optional[asyncio.Task] = None
        # own in-flight entries (request_id -> transition state): the
        # source of truth for snapshot answers
        self._own: Dict[str, dict] = {}
        # peer bookkeeping for the TTL reap
        self._peer_keys: Dict[str, Set[str]] = {}
        self._last_seen: Dict[str, float] = {}
        self._snapshots_applied = 0

    async def start(self) -> "RouterReplicaSync":
        self._task = asyncio.create_task(self._recv_loop())
        self._send_task = asyncio.create_task(self._send_loop())
        self._reap_task = asyncio.create_task(self._reap_loop())
        self._hello_task = asyncio.create_task(self._hello_loop())
        return self

    async def close(self) -> None:
        self._cancel.set()
        for t in (self._task, self._send_task, self._reap_task,
                  self._hello_task):
            if t is not None:
                t.cancel()

    # -- outbound ----------------------------------------------------------
    def _publish(self, msg: dict) -> None:
        msg["router_id"] = self.router_id
        self._outbox.put_nowait(msg)

    async def _send_loop(self) -> None:
        try:
            while True:
                msg = await self._outbox.get()
                try:
                    await self.runtime.event_plane.publish(self.subject, msg)
                except Exception:
                    logger.warning("replica sync publish failed",
                                   exc_info=True)
        except asyncio.CancelledError:
            pass

    async def _hello_loop(self) -> None:
        """Announce ourselves until a peer's snapshot lands (or there
        plainly are no peers): the late-joiner half of the
        snapshot-on-subscribe contract."""
        try:
            for _ in range(SUBSCRIBE_ATTEMPTS):
                if self._snapshots_applied:
                    return
                self._publish({"op": "subscribe"})
                await asyncio.sleep(SUBSCRIBE_RETRY_S)
        except asyncio.CancelledError:
            pass

    async def _reap_loop(self) -> None:
        """Heartbeat + reap: a peer silent past the TTL is crashed, not
        idle — idle peers still heartbeat — so free everything it added."""
        interval = max(self.peer_ttl_s / 3.0, 0.01)
        try:
            while not self._cancel.is_set():
                await asyncio.sleep(interval)
                self._publish({"op": "hb"})
                now = time.monotonic()
                for peer, seen in list(self._last_seen.items()):
                    if now - seen > self.peer_ttl_s:
                        self.reap_peer(peer)
        except asyncio.CancelledError:
            pass

    def reap_peer(self, peer: str) -> int:
        keys = self._peer_keys.pop(peer, set())
        for key in keys:
            self.sequences.free(key)
        self._last_seen.pop(peer, None)
        if keys:
            logger.warning(
                "replica-sync peer %s silent > %.1fs: reaped %d phantom "
                "entries", peer, self.peer_ttl_s, len(keys))
        return len(keys)

    def publish_add(self, request_id: str, worker_id: int, blocks: int,
                    overlap_blocks: int) -> None:
        self._own[request_id] = {
            "worker_id": worker_id, "blocks": blocks,
            "overlap_blocks": overlap_blocks, "prefill_done": False,
        }
        self._publish({"op": "add", "request_id": request_id,
                       "worker_id": worker_id, "blocks": blocks,
                       "overlap_blocks": overlap_blocks})

    def publish_prefill_done(self, request_id: str) -> None:
        ent = self._own.get(request_id)
        if ent is not None:
            ent["prefill_done"] = True
        self._publish({"op": "prefill_done", "request_id": request_id})

    def publish_free(self, request_id: str) -> None:
        self._own.pop(request_id, None)
        self._publish({"op": "free", "request_id": request_id})

    # -- inbound -----------------------------------------------------------
    async def _recv_loop(self) -> None:
        try:
            async for _subj, msg in self.runtime.event_plane.subscribe(
                self.subject, cancel=self._cancel
            ):
                try:
                    self._apply(msg)
                except Exception:
                    # a malformed peer frame must not kill the loop — that
                    # would silently revert this router to single-replica
                    # load accounting
                    logger.warning("dropping malformed replica-sync frame "
                                   "%r", msg, exc_info=True)
        except asyncio.CancelledError:
            pass

    def _apply(self, msg: dict) -> None:
        peer = msg.get("router_id")
        if peer is None or peer == self.router_id:
            return  # own echo
        self._last_seen[peer] = time.monotonic()
        op = msg.get("op")
        if op == "hb":
            return
        if op == "subscribe":
            # answer with a snapshot of OUR in-flight adds, built now so
            # the outbox's single-writer ordering keeps it consistent:
            # a free already queued ahead of this snapshot has already
            # popped its entry from _own
            entries = [{"request_id": rid, **ent}
                       for rid, ent in self._own.items()]
            self._publish({"op": "snapshot", "to": peer,
                           "entries": entries})
            return
        if op == "snapshot":
            if msg.get("to") != self.router_id:
                return
            keys = self._peer_keys.setdefault(peer, set())
            for ent in msg.get("entries", ()):
                key = f"{ent['request_id']}@{peer}"
                self.sequences.add_request(
                    key, int(ent["worker_id"]), int(ent["blocks"]),
                    int(ent.get("overlap_blocks", 0)))
                if ent.get("prefill_done"):
                    self.sequences.mark_prefill_completed(key)
                keys.add(key)
            self._snapshots_applied += 1
            return
        key = f"{msg.get('request_id')}@{peer}"
        if op == "add":
            self.sequences.add_request(
                key, int(msg["worker_id"]), int(msg["blocks"]),
                int(msg.get("overlap_blocks", 0)),
            )
            self._peer_keys.setdefault(peer, set()).add(key)
        elif op == "prefill_done":
            self.sequences.mark_prefill_completed(key)
        elif op == "free":
            self.sequences.free(key)
            ks = self._peer_keys.get(peer)
            if ks is not None:
                ks.discard(key)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "router_id": self.router_id,
            "own_inflight": len(self._own),
            "peer_inflight": {p: len(self._peer_keys.get(p, ()))
                              for p in self._last_seen},
            "snapshots_applied": self._snapshots_applied,
            "peer_ttl_s": self.peer_ttl_s,
        }

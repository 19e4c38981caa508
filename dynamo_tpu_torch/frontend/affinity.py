"""Session affinity: sticky worker binding for multi-turn agent sessions.

Ref: lib/llm/src/session_affinity/{coordinator.rs,push_router.rs,
replica_sync.rs} and lib/llm/src/protocols/agents.rs.  Requests carrying a
coding-agent session header keep hitting the worker that already holds the
session's KV, so each follow-up turn re-prefills from that worker's hot
prefix cache instead of scattering across the fleet.  The binding is a
lease-counted entry with an idle TTL: it cannot expire while a request on
the session is still streaming, and the idle clock only starts when the
last concurrent request on the session completes.

Composition with routing: the coordinator wraps the pipeline's route hook
(`SessionAffinityRouter`).  A session's first request routes normally (KV
router, round-robin, ...) and the chosen worker becomes the binding;
concurrent first requests on the same session wait for the winner's bind
instead of racing to different workers (ref coordinator.rs
AffinityEntry::Initializing).  A bound worker that has died or is in the
migration avoid-set invalidates the binding and rebinds.

Frontend replicas converge via bind/invalidate events on the event plane
(ref replica_sync.rs), ordered by a wall-clock revision — last bind wins,
which matches the reference's refresh-on-newer-revision rule.

A copy of dynamo_tpu/frontend/affinity.py on the port's runtime (its
event plane, `runtime/aio.py spawn_retained`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..runtime.aio import spawn_retained

logger = logging.getLogger(__name__)

# ref session_affinity/mod.rs limits
MAX_SESSION_AFFINITY_TTL_S = 31_536_000.0
MAX_SESSION_AFFINITY_ENTRIES = 65_536
MAX_SESSION_AFFINITY_ID_BYTES = 256

# ref protocols/agents.rs header vocabulary, in priority order.  The
# dynamo-native header wins; agent-specific mappings prefer the child
# (subagent) id over the root session so sibling subagents don't all pin
# to one worker.
HEADER_DYNAMO_SESSION_ID = "x-dynamo-session-id"
HEADER_DYNAMO_SESSION_FINAL = "x-dynamo-session-final"
_AGENT_MAPPINGS: Tuple[Tuple[str, Optional[str]], ...] = (
    # (root session header, child/agent header)
    ("x-claude-code-session-id", "x-claude-code-agent-id"),
    ("session-id", None),
    ("x-session-id", None),
)


def session_affinity_from_headers(headers) -> Tuple[Optional[str], bool]:
    """Extract (session_id, session_final) from HTTP headers.

    `headers` is any case-insensitive mapping (runtime/http_server.py
    Headers in the port's frontend).
    """

    def get(name: str) -> Optional[str]:
        v = headers.get(name)
        if v is None:
            return None
        v = v.strip()
        return v or None

    final = (get(HEADER_DYNAMO_SESSION_FINAL) or "").lower() in (
        "1", "true", "yes", "on")
    sid = get(HEADER_DYNAMO_SESSION_ID)
    if sid is not None:
        return sid, final
    for root, child in _AGENT_MAPPINGS:
        root_id = get(root)
        if root_id is None:
            continue
        child_id = get(child) if child else None
        return child_id or root_id, final
    return None, final


def _revision() -> int:
    # wall-clock revision: comparable across frontend replicas, which is
    # all replica sync needs (last bind wins)
    return time.time_ns()


@dataclass
class _Entry:
    """Bound when worker_id is set; initializing while the first request
    on the session is still being routed."""

    worker_id: Optional[int] = None
    revision: int = 0
    active_leases: int = 0
    idle_deadline: float = 0.0
    ready: asyncio.Event = field(default_factory=asyncio.Event)

    @property
    def bound(self) -> bool:
        return self.worker_id is not None


class AffinityCoordinator:
    """Session-id → worker binding table with lease-counted idle TTL."""

    def __init__(self, ttl_s: float,
                 max_entries: int = MAX_SESSION_AFFINITY_ENTRIES,
                 max_id_bytes: int = MAX_SESSION_AFFINITY_ID_BYTES,
                 metrics=None):
        if not (1.0 <= ttl_s <= MAX_SESSION_AFFINITY_TTL_S):
            raise ValueError(
                f"session affinity TTL must be in [1, "
                f"{MAX_SESSION_AFFINITY_TTL_S:.0f}] seconds, got {ttl_s}")
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self.max_id_bytes = max_id_bytes
        self.entries: Dict[str, _Entry] = {}
        self.metrics = metrics
        self._reaper: Optional[asyncio.Task] = None
        self._sync_pub = None  # async callable(payload) | None
        # replica-sync publications in flight: the loop weak-refs tasks,
        # so an unreferenced publish could be gc'd mid-send (DYN005)
        self._pub_tasks: set = set()
        self._closed = False

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "AffinityCoordinator":
        if self._reaper is None:
            self._reaper = asyncio.get_running_loop().create_task(
                self._reap_loop())
        return self

    async def close(self) -> None:
        self._closed = True
        for t in (self._reaper, getattr(self, "_sync_task", None)):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        self._reaper = None

    async def _reap_loop(self) -> None:
        period = min(max(self.ttl_s / 4.0, 0.05), 30.0)
        while True:
            await asyncio.sleep(period)
            self._purge_expired()

    def _purge_expired(self) -> int:
        now = time.monotonic()
        dead = [sid for sid, e in self.entries.items()
                if e.bound and e.active_leases == 0 and now >= e.idle_deadline]
        for sid in dead:
            del self.entries[sid]
        return len(dead)

    # -- acquire / bind / release ----------------------------------------
    def _valid_id(self, session_id: str) -> bool:
        return 0 < len(session_id.encode("utf-8", "ignore")) <= self.max_id_bytes

    async def acquire(self, session_id: str) -> Optional[_Entry]:
        """Take a lease on the session's entry.

        Returns a Bound entry (route to entry.worker_id, then release()),
        or an Initializing entry owned by the caller (route normally, then
        bind() or abort()), or None when affinity should be skipped
        (invalid id / table full).
        """
        if not self._valid_id(session_id):
            self._count("rejected_id")
            return None
        while True:
            e = self.entries.get(session_id)
            if e is None:
                if len(self.entries) >= self.max_entries:
                    if self._purge_expired() == 0:
                        self._count("rejected_capacity")
                        return None
                    continue
                e = _Entry(revision=_revision())
                self.entries[session_id] = e
                return e  # initializing, caller must bind() or abort()
            if not e.bound:
                # another request on this session is routing right now:
                # wait for its bind so both land on the same worker.  The
                # timeout guards a binder that died without abort().
                try:
                    await asyncio.wait_for(e.ready.wait(), timeout=10.0)
                except asyncio.TimeoutError:
                    if self.entries.get(session_id) is e and not e.bound:
                        del self.entries[session_id]
                continue
            now = time.monotonic()
            if e.active_leases == 0 and now >= e.idle_deadline:
                del self.entries[session_id]
                continue
            e.active_leases += 1
            return e

    def bind(self, session_id: str, entry: _Entry, worker_id: int) -> None:
        entry.worker_id = worker_id
        entry.revision = _revision()
        entry.active_leases = 1
        entry.ready.set()
        if self.entries.get(session_id) is not entry:
            # superseded while routing (a waiter timed out and took over):
            # keep the local lease consistent but don't advertise a bind
            # the local table doesn't hold
            return
        self._publish({"op": "bind", "session_id": session_id,
                       "worker_id": worker_id, "revision": entry.revision})

    def abort(self, session_id: str, entry: _Entry) -> None:
        """Routing failed before a bind: drop the placeholder and wake
        waiters so they retake the entry."""
        if self.entries.get(session_id) is entry:
            del self.entries[session_id]
        entry.ready.set()

    def invalidate(self, session_id: str, entry: _Entry) -> None:
        """The bound worker is gone (lease expiry, migration avoid-set)."""
        if self.entries.get(session_id) is entry:
            del self.entries[session_id]
            self._count("invalidated")
            self._publish({"op": "invalidate", "session_id": session_id,
                           "revision": _revision()})

    def release(self, session_id: str, entry: _Entry,
                evict: bool = False) -> None:
        entry.active_leases = max(0, entry.active_leases - 1)
        if entry.active_leases == 0:
            entry.idle_deadline = time.monotonic() + self.ttl_s
        if evict and self.entries.get(session_id) is entry:
            # x-dynamo-session-final: the agent says this session is done
            del self.entries[session_id]
            self._publish({"op": "invalidate", "session_id": session_id,
                           "revision": _revision()})

    # -- replica sync -----------------------------------------------------
    async def enable_replica_sync(self, runtime, namespace: str,
                                  component: str) -> None:
        """Converge bindings across frontend replicas over the event plane
        (ref replica_sync.rs): bind/invalidate fan out, newer revision
        wins, and a remote bind never clobbers a local entry that has
        requests in flight (ref ReplicaApplyOutcome::IgnoredConflict)."""
        subject = f"session_affinity.{namespace}.{component}"
        plane = runtime.event_plane

        async def pub(payload: dict) -> None:
            try:
                await plane.publish(subject, payload)
            except Exception:
                logger.warning("affinity sync publish failed", exc_info=True)

        self._sync_pub = pub

        async def sub_loop() -> None:
            async for _subj, payload in plane.subscribe(subject,
                                                        self._sync_cancel):
                try:
                    self._apply_remote(payload)
                except Exception:
                    logger.warning("bad affinity sync payload %r", payload)

        self._sync_cancel = asyncio.Event()
        self._sync_task = asyncio.get_running_loop().create_task(sub_loop())

    def _apply_remote(self, p: dict) -> None:
        sid, rev = p["session_id"], int(p["revision"])
        e = self.entries.get(sid)
        if p["op"] == "bind":
            if e is not None and (e.active_leases > 0 or not e.bound
                                  or e.revision >= rev):
                return  # in-flight local state wins; stale update ignored
            ne = _Entry(worker_id=int(p["worker_id"]), revision=rev,
                        idle_deadline=time.monotonic() + self.ttl_s)
            ne.ready.set()
            self.entries[sid] = ne
        elif p["op"] == "invalidate":
            if e is not None and e.bound and e.active_leases == 0 \
                    and e.revision < rev:
                del self.entries[sid]

    def _publish(self, payload: dict) -> None:
        if self._sync_pub is not None:
            spawn_retained(self._sync_pub(payload), self._pub_tasks)

    def _count(self, what: str) -> None:
        if self.metrics is not None:
            self.metrics.inc("dynamo_affinity_events_total", event=what)


class SessionAffinityRouter:
    """Route hook wrapper: sticky session routing over any inner policy.

    Plugs into MigrationOperator.route (frontend/pipeline.py) — the same
    seam the KV router uses — so affinity composes with KV routing,
    migration avoid-sets, and disagg unchanged (ref push_router.rs
    SessionAffinityPushRouter wrapping PushRouter).
    """

    def __init__(self, coordinator: AffinityCoordinator, client,
                 inner=None):
        self.coordinator = coordinator
        self.client = client
        self.inner = inner
        # request_id -> (session_id, entry, evict_on_complete)
        self._held: Dict[str, Tuple[str, _Entry, bool]] = {}
        # expose the inner KV router's indexer for overlap introspection
        self.indexer = getattr(inner, "indexer", None)

    async def _route_inner(self, req, avoid):
        if self.inner is not None:
            return await self.inner(req, avoid=avoid)
        return None

    def _pick_fallback(self, avoid) -> Optional[int]:
        insts = [i for i in self.client.instances
                 if i.instance_id not in avoid]
        if not insts:
            return None
        return self.client.router.pick(insts).instance_id

    async def __call__(self, req, avoid=frozenset()):
        sid = getattr(req, "session_id", None)
        if not sid:
            return await self._route_inner(req, avoid)
        coord = self.coordinator
        # migration retry re-routes the same request_id: release the lease
        # taken by the previous attempt so it can't leak
        stale = self._held.pop(req.request_id, None)
        if stale is not None:
            coord.release(stale[0], stale[1])
        entry = await coord.acquire(sid)
        # a bound target may be dead or in the migration avoid-set; a raced
        # rebind may even re-bind it, so the usability check applies to
        # every bound entry we see (bounded: give up pinning after a few)
        for _ in range(3):
            if entry is None:  # table full / bad id: plain routing, no pin
                return await self._route_inner(req, avoid)
            if not entry.bound:
                break
            # bindings store TARGET ids (worker, dp_rank) so a session
            # stuck to rank r of a dp worker keeps landing on rank r —
            # its KV lives in that rank's cache, not "the worker's"
            tid = entry.worker_id
            targets = getattr(self.inner, "targets", None)
            wid, rank = (targets.resolve(tid) if targets is not None
                         else (tid, 0))
            if wid in self.client.instance_ids and wid not in avoid:
                coord._count("hit")
                req.dp_rank = rank
                if hasattr(self.inner, "charge"):
                    # keep the KV router's load accounting truthful for
                    # placements it didn't make
                    self.inner.charge(req, wid)
                self._held[req.request_id] = (sid, entry,
                                              req.session_final)
                return wid
            coord.release(sid, entry)
            coord.invalidate(sid, entry)
            entry = await coord.acquire(sid)
        else:
            # kept racing into unusable binds: route this one unpinned
            if entry is not None and entry.bound:
                coord.release(sid, entry)
            return await self._route_inner(req, avoid)
        try:
            choice = await self._route_inner(req, avoid)
            if choice is None:
                choice = self._pick_fallback(avoid)
        except BaseException:
            coord.abort(sid, entry)
            raise
        if choice is None:
            coord.abort(sid, entry)
            return None
        coord._count("bind")
        # bind the (worker, dp_rank) target the route actually picked
        from ..router.targets import target_id

        coord.bind(sid, entry, target_id(choice,
                                         getattr(req, "dp_rank", 0)))
        self._held[req.request_id] = (sid, entry, req.session_final)
        return choice

    # -- MigrationOperator protocol forwarding ----------------------------
    def mark_prefill_completed(self, request_id: str) -> None:
        if self.inner is not None and hasattr(self.inner,
                                              "mark_prefill_completed"):
            self.inner.mark_prefill_completed(request_id)

    def complete(self, request_id: str) -> None:
        held = self._held.pop(request_id, None)
        if held is not None:
            sid, entry, evict = held
            self.coordinator.release(sid, entry, evict=evict)
        if self.inner is not None and hasattr(self.inner, "complete"):
            self.inner.complete(request_id)

    async def close(self) -> None:
        await self.coordinator.close()
        if self.inner is not None and hasattr(self.inner, "close"):
            await self.inner.close()

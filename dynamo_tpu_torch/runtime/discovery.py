"""Discovery plane: lease-scoped KV store with prefix watch.

A copy of dynamo_tpu/runtime/discovery.py with the same keys, file
layout, leases and heartbeat, so a torch worker and JAX processes sharing
one FileDiscovery directory see each other.  Instances register under
`v1/instances/{ns}/{component}/{endpoint}/{instance_id}`, model cards
under `v1/mdc/{ns}/{model}/{instance_id}`, and consumers watch a prefix.
Entries are bound to a lease; when the owner dies the lease expires and
watchers see a delete.

Backends:
  * MemDiscovery  — in-process, shared per cluster_id (module-global, so
    it never sees the JAX package's MemDiscovery);
  * FileDiscovery — a directory tree on local disk with mtime heartbeats,
    for multi-process single-host clusters.
The etcd and kubernetes backends are not ported yet (ROADMAP.md).  The
chaos seams of the JAX module and the planner's quarantine actuation are
left out; the heartbeat still honours quarantine markers a planner
writes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

INSTANCE_PREFIX = "v1/instances"
MDC_PREFIX = "v1/mdc"
EVENT_ENDPOINT_PREFIX = "v1/events"
# quarantine markers (planner straggler quarantine): one leased key per
# held worker, `v1/quarantine/{instance_id}` — the breadcrumb that keeps
# a withdrawn worker VISIBLE.  withdraw_instance deletes the worker's
# routing keys, so without the marker the fleet aggregator (obs/fleet.py)
# would silently shrink; with it the worker shows up as
# state="quarantined" and stays scrapeable via the stashed system_addr.
QUARANTINE_PREFIX = "v1/quarantine"


def new_instance_id() -> int:
    return secrets.randbits(63)


@dataclass(frozen=True)
class Instance:
    """A live endpoint instance (ref: lib/runtime/src/component.rs:107)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    address: str  # request-plane address, "host:port"
    metadata: Dict[str, Any] = field(default_factory=dict, hash=False)

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    def key(self) -> str:
        return f"{INSTANCE_PREFIX}/{self.path}/{self.instance_id}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "instance_id": self.instance_id,
            "address": self.address,
            "metadata": self.metadata,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Instance":
        return Instance(
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=int(d["instance_id"]),
            address=d["address"],
            metadata=d.get("metadata", {}),
        )


@dataclass(frozen=True)
class WatchEvent:
    type: str  # "put" | "delete"
    key: str
    value: Optional[Dict[str, Any]] = None


def diff_snapshot(known: Dict[str, str], snap: Dict[str, Dict[str, Any]],
                  emit: Callable[[WatchEvent], None]) -> None:
    """Diff a fresh prefix snapshot against `known` (key -> canonical
    serialization), emitting puts for new/changed keys and deletes for
    vanished ones, then update `known` in place.  Shared by every
    poll/reconnect-style watch implementation so their event semantics
    cannot drift."""
    cur = {k: json.dumps(v, sort_keys=True) for k, v in snap.items()}
    for k, ser in cur.items():
        if known.get(k) != ser:
            emit(WatchEvent("put", k, snap[k]))
    for k in list(known):
        if k not in cur:
            emit(WatchEvent("delete", k))
    known.clear()
    known.update(cur)


class DiscoveryBackend:
    """Lease-scoped KV store with prefix watch."""

    async def start(self) -> None:  # pragma: no cover - trivial
        pass

    async def close(self) -> None:  # pragma: no cover - trivial
        pass

    async def put(self, key: str, value: Dict[str, Any], lease: bool = True) -> None:
        raise NotImplementedError

    async def delete(self, key: str) -> None:
        raise NotImplementedError

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        raise NotImplementedError

    def watch(
        self, prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[WatchEvent]:
        """Yields a `put` for every existing key, then live updates."""
        raise NotImplementedError

    async def revoke_lease(self) -> None:
        """Drop every key registered under this backend instance's lease."""
        raise NotImplementedError

    # -- health withdraw (runtime/health_check.py) ------------------------
    # Backends populate `_owned_values` on leased puts so an unhealthy
    # process can pull its instances out of discovery and put them back on
    # recovery, without losing the registered values.
    _owned_values: Dict[str, Dict[str, Any]]

    def _forget_withdrawn(self, key: str) -> None:
        """A real delete during the withdrawn window (endpoint shutdown)
        must not be resurrected by restore_lease."""
        getattr(self, "_withdrawn_values", {}).pop(key, None)

    async def withdraw_lease(self) -> None:
        """Temporarily remove every leased key (unhealthy process);
        `restore_lease` re-registers them.  Failure-partway semantics
        matter (a discovery outage causes them): keys stashed by an earlier
        partial attempt must survive a retry — they are no longer in
        `_owned_values` (delete() popped them), so resetting the stash
        here would lose their values forever."""
        # stash each key only after ITS delete: a concurrent legitimate
        # delete (endpoint shutdown mid-withdraw) either empties the
        # _owned_values slot before we process it (skipped below) or pops
        # it from _withdrawn_values after we stashed it — never resurrected
        if not hasattr(self, "_withdrawn_values"):
            self._withdrawn_values = {}
        owned = getattr(self, "_owned_values", {})
        for key in list(owned):
            value = owned.get(key)
            if value is None:
                continue
            await self.delete(key)
            self._withdrawn_values[key] = value

    async def restore_lease(self) -> None:
        """Re-register everything withdraw_lease stashed.  A put that
        fails partway (transient discovery outage) must keep the
        not-yet-restored keys stashed so the caller's retry (the next
        canary probe's reconcile) can finish the job.

        Keys whose instance is currently quarantine-marked
        (QUARANTINE_PREFIX — the planner withdrew this worker's routing
        identity while its process, and therefore its canary loop, kept
        running) are DEFERRED, not restored: re-putting them would
        resurrect the withdrawn identity mid-hold, silently routing
        traffic back to a known straggler.  They stay stashed —
        readmission restores the identity from the planner's own stash,
        and this process re-owns the keys at its next recovery once the
        marker is gone."""
        stash = getattr(self, "_withdrawn_values", {})
        self._withdrawn_values = {}
        deferred: Dict[str, Dict[str, Any]] = {}
        try:
            try:
                marks = await self.get_prefix(QUARANTINE_PREFIX)
            except Exception:
                marks = {}  # marker read must not block recovery
            held = {str(v.get("instance_id")) for v in marks.values()
                    if isinstance(v, dict)}
            while stash:
                key = next(iter(stash))
                if key.rsplit("/", 1)[-1] in held:
                    deferred[key] = stash.pop(key)
                    logger.warning(
                        "restore_lease: %s is quarantine-held; deferring "
                        "its re-registration", key)
                    continue
                await self.put(key, stash[key])
                stash.pop(key)
        finally:
            if stash or deferred:
                # failed partway and/or deferred: merge survivors back (a
                # concurrent withdraw may have stashed new keys meanwhile)
                for key, value in (list(stash.items())
                                   + list(deferred.items())):
                    self._withdrawn_values.setdefault(key, value)


# ---------------------------------------------------------------------------
# In-memory backend (per-process clusters, the unit/integration test default)
# ---------------------------------------------------------------------------


class _MemCluster:
    def __init__(self) -> None:
        self.store: Dict[str, Dict[str, Any]] = {}
        self.watchers: List[Tuple[str, asyncio.Queue]] = []

    def notify(self, ev: WatchEvent) -> None:
        for prefix, q in list(self.watchers):
            if ev.key.startswith(prefix):
                q.put_nowait(ev)


_MEM_CLUSTERS: Dict[str, _MemCluster] = {}


class MemDiscovery(DiscoveryBackend):
    def __init__(self, cluster_id: str = "default"):
        self.cluster_id = cluster_id
        self._cluster = _MEM_CLUSTERS.setdefault(cluster_id, _MemCluster())
        self._owned: set[str] = set()
        self._owned_values: Dict[str, Dict[str, Any]] = {}

    async def put(self, key: str, value: Dict[str, Any], lease: bool = True) -> None:
        self._cluster.store[key] = value
        if lease:
            self._owned.add(key)
            self._owned_values[key] = value
        self._cluster.notify(WatchEvent("put", key, value))

    async def delete(self, key: str) -> None:
        self._cluster.store.pop(key, None)
        self._owned.discard(key)
        self._owned_values.pop(key, None)
        self._forget_withdrawn(key)
        self._cluster.notify(WatchEvent("delete", key))

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        return {k: v for k, v in self._cluster.store.items() if k.startswith(prefix)}

    async def watch(
        self, prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[WatchEvent]:
        from .aio import iter_queue

        q: asyncio.Queue = asyncio.Queue()
        entry = (prefix, q)
        self._cluster.watchers.append(entry)
        try:
            for k, v in list(self._cluster.store.items()):
                if k.startswith(prefix):
                    yield WatchEvent("put", k, v)
            async for ev in iter_queue(q, cancel):
                yield ev
        finally:
            try:
                self._cluster.watchers.remove(entry)
            except ValueError:
                pass

    async def revoke_lease(self) -> None:
        for key in list(self._owned):
            await self.delete(key)

    async def close(self) -> None:
        await self.revoke_lease()


# ---------------------------------------------------------------------------
# File backend (multi-process single-host clusters, no external infra)
# ---------------------------------------------------------------------------


def _key_to_relpath(key: str) -> str:
    # key components never contain os separators other than '/'
    return key.replace("/", os.sep) + ".json"


class FileDiscovery(DiscoveryBackend):
    """Directory-tree KV store with mtime-heartbeat leases.

    Heartbeat task refreshes mtimes of owned keys every ttl/3; scanners treat
    files older than ttl as expired (delete + unlink).  Watch is poll-based
    (interval default 100ms) — fine for control-plane rates.
    """

    def __init__(self, root: str, ttl_s: float = 5.0, poll_s: float = 0.1):
        self.root = root
        self.ttl_s = ttl_s
        self.poll_s = poll_s
        self._owned: set[str] = set()
        self._owned_values: Dict[str, Dict[str, Any]] = {}
        self._hb_task: Optional[asyncio.Task] = None
        self._closed = asyncio.Event()
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, _key_to_relpath(key))

    async def start(self) -> None:
        if self._hb_task is None:
            self._hb_task = asyncio.create_task(self._heartbeat_loop())

    async def _heartbeat_loop(self) -> None:
        while not self._closed.is_set():
            missing: List[str] = []
            for key in list(self._owned):
                p = self._path(key)
                try:
                    os.utime(p, None)
                except FileNotFoundError:
                    missing.append(key)
            if missing:
                await self._reclaim(missing)
            try:
                await asyncio.wait_for(self._closed.wait(), timeout=self.ttl_s / 3)
            except asyncio.TimeoutError:
                pass

    async def _reclaim(self, missing: List[str]) -> None:
        """Owned keys whose files were deleted EXTERNALLY (this
        backend's own delete() pops ownership before unlinking).  Two
        legitimate causes, told apart by the quarantine marker:

          * a quarantine hold — the planner unlinked this worker's
            routing identity and holds a leased ``v1/quarantine/{id}``
            marker.  Leave the key down (but still owned, so the beat
            keeps checking): the hold is exactly as alive as that
            marker.
          * lease expiry — the files were reaped while this process was
            partitioned/suspended, or a holder died without readmitting
            (its leased marker expired with it).  The process is
            demonstrably back (it is heartbeating), so re-register.

        The marker gate is what makes a planner CRASH self-healing: a
        planner that dies mid-hold can never restore its in-memory
        stash, but its marker expires with its lease and the worker
        restores its own identity at the next beat instead of staying
        unroutable forever."""
        try:
            marks = await self.get_prefix(QUARANTINE_PREFIX)
        except Exception:
            return  # cannot read markers this beat: change nothing
        held = {str(v.get("instance_id")) for v in marks.values()
                if isinstance(v, dict)}
        for key in missing:
            if key.rsplit("/", 1)[-1] in held:
                continue  # quarantine hold: stays withdrawn, stays owned
            value = self._owned_values.get(key)
            if value is None:
                self._owned.discard(key)
                continue
            try:
                await self.put(key, value)
                logger.warning(
                    "file discovery: re-registered %s after external "
                    "delete (lease expiry or a released/expired "
                    "quarantine hold)", key)
            except Exception:
                logger.warning("file discovery: failed to re-register "
                               "%s; retrying next beat", key,
                               exc_info=True)

    async def put(self, key: str, value: Dict[str, Any], lease: bool = True) -> None:
        await self.start()
        p = self._path(key)

        def _write() -> None:
            # atomic tmp+rename, off the event loop: registration rides
            # the request path, and a put stalled on a slow/contended
            # filesystem must not stall every live stream with it
            os.makedirs(os.path.dirname(p), exist_ok=True)
            tmp = p + f".tmp{secrets.token_hex(4)}"
            with open(tmp, "w") as f:
                json.dump(value, f)
            os.replace(tmp, p)

        await asyncio.to_thread(_write)
        if lease:
            self._owned.add(key)
            self._owned_values[key] = value

    async def delete(self, key: str) -> None:
        self._owned.discard(key)
        self._owned_values.pop(key, None)
        self._forget_withdrawn(key)
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def _scan(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        now = time.time()
        base = self.root
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                if not fn.endswith(".json"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, base)
                key = rel[: -len(".json")].replace(os.sep, "/")
                if not key.startswith(prefix):
                    continue
                try:
                    st = os.stat(full)
                    if now - st.st_mtime > self.ttl_s:
                        # expired lease — reap so watchers converge
                        try:
                            os.unlink(full)
                        except OSError:
                            pass
                        continue
                    with open(full) as f:
                        out[key] = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue  # concurrent write/delete; next poll catches up
        return out

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        return await asyncio.get_event_loop().run_in_executor(None, self._scan, prefix)

    async def watch(
        self, prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[WatchEvent]:
        known: Dict[str, str] = {}
        while cancel is None or not cancel.is_set():
            try:
                snap = await self.get_prefix(prefix)
            except asyncio.CancelledError:
                raise
            except Exception:
                # transient scan failure (FS hiccup / injected outage):
                # keep the last known view and retry next poll — a
                # poll-based watch must not die on one bad snapshot
                logger.warning("file discovery scan failed; retrying",
                               exc_info=True)
                snap = None
            if snap is not None:
                pending: List[WatchEvent] = []
                diff_snapshot(known, snap, pending.append)
                for ev in pending:
                    yield ev
            try:
                if cancel is not None:
                    await asyncio.wait_for(cancel.wait(), timeout=self.poll_s)
                    break
                await asyncio.sleep(self.poll_s)
            except asyncio.TimeoutError:
                pass

    async def revoke_lease(self) -> None:
        for key in list(self._owned):
            await self.delete(key)

    async def close(self) -> None:
        self._closed.set()
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        await self.revoke_lease()


def make_discovery(backend: str, *, path: str = "", ttl_s: float = 5.0,
                   cluster_id: str = "default") -> DiscoveryBackend:
    if backend == "mem":
        return MemDiscovery(cluster_id=cluster_id)
    if backend == "file":
        # dev fixture: multi-process single-host with zero infra; use the
        # etcd backend for anything resembling production
        if not path:
            raise ValueError("file discovery requires DYN_DISCOVERY_PATH")
        return FileDiscovery(path, ttl_s=ttl_s)
    if backend in ("etcd", "kubernetes"):
        raise NotImplementedError(
            f"discovery backend {backend!r} is not ported to "
            "dynamo_tpu_torch yet (ROADMAP.md, Queue 1): use mem or file")
    raise ValueError(f"unknown discovery backend: {backend}")

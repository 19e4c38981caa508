"""Tiered KV manager: G2/G3/G4 placement, demotion and onboarding
lookups, a copy of dynamo_tpu/kvbm/manager.py whose blocks are CPU torch
tensors (pools.py).

The engine's scheduler thread calls into it synchronously; coordination
across workers rides the event plane (each worker advertises its
consolidated block set, and kvbm/remote.py pulls from peers).

  * offload(h, *payload): place a device block's payload into G2,
    demoting G2's LRU victims to G3 (or spilling them to G4, or dropping
    them) as capacity requires.
  * match_run(hashes): the longest leading run onboardable from
    G2, G3 and G4: the admission-time alternative to recomputing prefill.
  * fetch(h): read a block back for onboarding (a G3/G4 hit is promoted
    to G2, so a second onboard is a host-memory read).

Every mutation returns [(stored, removed, tier), ...] batches for the
engine to fold through KvEventConsolidator.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .breaker import TierBreaker
from .object_io import ObjectIO
from .object_store import ObjectStorePool
from .pools import Block, DiskBlockPool, HostBlockPool

logger = logging.getLogger(__name__)

TierEvents = List[Tuple[List[int], List[int], str]]


class _OffloadSkip:
    """Membership view the engine passes to coldest_evictable: skip blocks
    already held AND blocks recently dropped for capacity.  Without the
    cooldown, a G2 smaller than G1's cold set ping-pongs: every offload
    drops the previous coldest, which is re-offloaded next step, forever."""

    def __init__(self, mgr: "TieredKvManager"):
        self._m = mgr

    def __contains__(self, h: int) -> bool:
        return h in self._m or h in self._m._dropped


class TieredKvManager:
    def __init__(self, host_blocks: int, disk_dir: Optional[str] = None,
                 disk_blocks: int = 0, object_dir: Optional[str] = None,
                 object_ttl_s: Optional[float] = None,
                 io_deadline_s: float = 0.25,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0):
        self.g2 = HostBlockPool(host_blocks)
        self.g3 = (DiskBlockPool(disk_dir, disk_blocks)
                   if disk_dir and disk_blocks > 0 else None)
        # G4: cluster-shared content-addressed store; receives what the
        # local tier ladder would otherwise drop (object_store.py).  All
        # serving-path access goes through the ObjectIO thread so every
        # shared-FS touch is deadline-bounded off the scheduler.
        self.g4 = (ObjectStorePool(object_dir, ttl_s=object_ttl_s)
                   if object_dir else None)
        self._io = (ObjectIO(self.g4, deadline_s=io_deadline_s)
                    if self.g4 is not None else None)
        self.breaker = TierBreaker(
            ("g3", "g4"), threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s)
        self.stats = {"offloaded": 0, "onboarded": 0, "demoted": 0,
                      "dropped": 0, "disk_hits": 0}
        # attribution hook the engine installs: (tier, hash) per
        # checksum-failed consume (the engine's kv_integrity counters)
        self.on_corruption: Optional[Callable[[str, int], None]] = None
        if self.g3 is not None:
            self.g3.on_corruption = \
                lambda h: self._note_corruption("g3", h)
            self.g3.on_io_error = self._g3_io_error
        # cooldown FIFO of capacity-dropped hashes; bounded so entries age
        # out as churn elsewhere produces new drops
        self._dropped: "OrderedDict[int, None]" = OrderedDict()
        self._dropped_cap = max(64, host_blocks)
        self.offload_skip = _OffloadSkip(self)

    def close(self) -> None:
        """Release tier resources (G3 directory ownership in particular, so
        an in-process successor engine can take over the cache dir)."""
        if self.g3 is not None:
            self.g3.close()
        if self._io is not None:
            self._io.close()

    def _note_corruption(self, tier: str, h: int) -> None:
        key = f"{tier}_quarantined"
        self.stats[key] = self.stats.get(key, 0) + 1
        if self.on_corruption is not None:
            self.on_corruption(tier, h)

    def _g3_io_error(self) -> None:
        self.stats["g3_io_errors"] = self.stats.get("g3_io_errors", 0) + 1
        self.breaker.record_failure("g3")

    def _g4_failed(self, status: str) -> None:
        """Fold one failed ObjectIO op into the breaker + stats."""
        key = f"g4_{'timeouts' if status == 'timeout' else 'io_errors'}"
        self.stats[key] = self.stats.get(key, 0) + 1
        self.breaker.record_failure("g4")

    def tier_states(self) -> Dict[str, str]:
        """Breaker state per breakable tier — /debug/kv + fleet fold."""
        return self.breaker.states()

    def io_failure_counters(self) -> Dict[Tuple[str, str], int]:
        """(tier, action) -> count rows for
        dynamo_kv_integrity_failures_total (quarantine rows are kept by
        the engine, which sees every tier's corruptions including
        remote pulls)."""
        rows = {("g4", "timeout"): self.stats.get("g4_timeouts", 0),
                ("g4", "error"): self.stats.get("g4_io_errors", 0),
                ("g3", "error"): self.stats.get("g3_io_errors", 0)}
        return {k: v for k, v in rows.items() if v}

    def occupancy(self) -> dict:
        """Per-tier block occupancy for /metrics gauges (the engine's
        kv_occupancy merges this under the g1 allocator's).  G4 is the
        shared object store: capacity-unbounded (TTL-swept), so only
        `used` is reported — and counting it lists the shared directory,
        which is why occupancy() is called from the worker's 0.5s load
        loop, never from the scheduler step."""
        out = {"g2": {"used": len(self.g2), "capacity": self.g2.capacity,
                      "free": max(0, self.g2.capacity - len(self.g2))}}
        if self.g3 is not None:
            out["g3"] = {"used": len(self.g3),
                         "capacity": self.g3.capacity,
                         "free": max(0, self.g3.capacity - len(self.g3))}
        if self._io is not None:
            # bounded count through the I/O thread: a dark mount
            # degrades to the last observed count, never a stuck gauge
            out["g4"] = {"used": self._io.count()}
        return out

    def manifest(self) -> dict:
        """Per-tier resident hash sets (the pool ground truth a KV
        ledger's auditor reconciles against).  G4 is deliberately absent: the
        shared object store is mutated by every worker's TTL sweeps, so
        a per-worker audit of it would report other workers' legitimate
        activity as violations."""
        out = {"g2": set(self.g2.keys())}
        if self.g3 is not None:
            out["g3"] = set(self.g3.keys())
        return out

    def _mark_dropped(self, h: int) -> None:
        self._dropped[h] = None
        self._dropped.move_to_end(h)
        while len(self._dropped) > self._dropped_cap:
            self._dropped.popitem(last=False)

    def __contains__(self, h: int) -> bool:
        """Tier membership as admission sees it.  G2/G3 are in-memory
        book checks; G4 is one deadline-bounded stat on the I/O thread —
        and a tier whose breaker is open reports nothing, so match_run
        never promises blocks fetch() would refuse to read."""
        if h in self.g2:
            return True
        if (self.g3 is not None and h in self.g3
                and self.breaker.state("g3") != "open"):
            return True
        return self._g4_contains(h)

    def _g4_contains(self, h: int) -> bool:
        if self._io is None or not self.breaker.allow("g4"):
            return False
        st = self._io.contains(h)
        if st in ("hit", "miss"):
            self.breaker.record_ok("g4")
            return st == "hit"
        self._g4_failed(st)
        return False

    def offload(self, h: int, *arrays: torch.Tensor) -> TierEvents:
        """Place one block into G2 ((k, v), or (k, v, ks, vs) for an int8
        cache — the quantized payload moves verbatim); returns tier
        events."""
        events: TierEvents = [([h], [], "g2")]
        self.stats["offloaded"] += 1
        self._dropped.pop(h, None)
        for victim_h, blk in self.g2.put(h, *arrays):
            events.extend(self._demote(victim_h, blk))
        return events

    def _spill_to_g4(self, h: int, blk: Optional[Block]) -> TierEvents:
        """Last stop before dropping: park the block in the shared object
        store.  G4 events are still published per-worker — the
        consolidator nets them, and the router keeps seeing the prefix as
        onboardable somewhere."""
        if (self._io is not None and blk is not None
                and self.breaker.allow("g4")):
            st = self._io.put(h, blk)
            if st == "stored":
                self.breaker.record_ok("g4")
                self.stats["g4_spilled"] = self.stats.get("g4_spilled", 0) + 1
                return [([h], [], "g4")]
            if st == "exists":
                self.breaker.record_ok("g4")
                return []  # already in G4 (same content by construction)
            # timeout/error: the op may still land late on the I/O
            # thread, but we publish nothing — an unadvertised blob is
            # just a future re-spill or TTL reap, both safe
            self._g4_failed(st)
        self.stats["dropped"] += 1
        self._mark_dropped(h)
        return []

    def _demote(self, h: int, blk: Block) -> TierEvents:
        if self.g3 is None or not self.breaker.allow("g3"):
            # no G3, or its breaker is open (dying disk): skip straight
            # to the G4 spill / drop — degrade, don't wedge on writes
            events = self._spill_to_g4(h, blk)
            events.append(([], [h], "g2"))
            return events
        self.stats["demoted"] += 1
        if self.g4 is not None:
            dropped = self.g3.put_with_victims(h, *blk)
        else:
            dropped = [(old, None) for old in self.g3.put(h, *blk)]
        if h not in self.g3:
            # the write failed (pool dropped it + fed the breaker):
            # fall through to the G4 spill so the bytes still land somewhere
            events = self._spill_to_g4(h, blk)
            events.append(([], [h], "g2"))
            return events
        self.breaker.record_ok("g3")
        # one batch carries one tier: g3 store first, then the g2 removal,
        # so the consolidator never sees the block tierless in between
        events: TierEvents = [([h], [], "g3"), ([], [h], "g2")]
        for old, old_blk in dropped:
            events.extend(self._spill_to_g4(old, old_blk))
            events.append(([], [old], "g3"))
        return events

    def match_run(self, hashes: Sequence[int]) -> int:
        """Longest leading run of hashes onboardable right now (G2∪G3∪G4,
        minus any tier whose circuit breaker is open)."""
        n = 0
        for h in hashes:
            if h not in self:
                break
            n += 1
        return n

    def fetch(self, h: int) -> Tuple[Optional[Block], TierEvents, Optional[str]]:
        """Read one block for onboarding.  G3/G4 hits are promoted into G2.

        Returns (block, tier_events, src_tier); block is None on a miss
        (src_tier None).  src_tier names the tier that actually served the
        bytes: the engine's per-tier onboard accounting keys off it.  The events must be emitted even on a
        miss: an unreadable G3 file is dropped from the pool here, and the
        router must see that removal or it will keep routing prefixes to a
        block that can never onboard."""
        blk = self.g2.get(h)
        src: Optional[str] = "g2" if blk is not None else None
        events: TierEvents = []
        if (blk is None and self.g3 is not None
                and self.breaker.allow("g3")):
            was_held = h in self.g3
            blk = self.g3.get(h)
            if blk is not None:
                src = "g3"
                self.breaker.record_ok("g3")
                self.stats["disk_hits"] += 1
                events.append(([h], [], "g2"))
                for victim_h, victim in self.g2.put(h, *blk):
                    events.extend(self._demote(victim_h, victim))
            elif was_held:
                # unreadable or quarantined (the pool already attributed
                # a corruption); either way the router must see it gone
                events.append(([], [h], "g3"))
        if (blk is None and self._io is not None
                and self.breaker.allow("g4")):
            st, got = self._io.get(h)
            if st == "hit":
                self.breaker.record_ok("g4")
                # promote into G2 (the blob stays in G4 — it's shared)
                blk = got
                src = "g4"
                self.stats["g4_hits"] = self.stats.get("g4_hits", 0) + 1
                events.append(([h], [], "g2"))
                for victim_h, victim in self.g2.put(h, *blk):
                    events.extend(self._demote(victim_h, victim))
            elif st == "miss":
                self.breaker.record_ok("g4")
            elif st == "corrupt":
                # the pool already deleted the blob; the mount itself is
                # healthy (we got bytes, just wrong ones) so the breaker
                # is NOT fed — publish removed(g4) fleet-wide and
                # attribute the corruption; the caller recomputes
                self.breaker.record_ok("g4")
                events.append(([], [h], "g4"))
                self._note_corruption("g4", h)
            else:
                self._g4_failed(st)
        if blk is None:
            return None, events, None
        self.stats["onboarded"] += 1
        return blk, events, src

    def clear(self) -> TierEvents:
        events: TierEvents = []
        self._dropped.clear()
        g2 = self.g2.clear()
        if g2:
            events.append(([], g2, "g2"))
        if self.g3 is not None:
            g3 = self.g3.clear()
            if g3:
                events.append(([], g3, "g3"))
        return events

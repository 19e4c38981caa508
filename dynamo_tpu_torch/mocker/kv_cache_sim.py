"""Simulated paged KV cache with prefix caching and LRU eviction, a copy
of dynamo_tpu/mocker/kv_cache_sim.py without its chaos seam.

Block-granular cache keyed by PositionalLineageHash: an admitted
sequence reuses cached full blocks (prefix cache hit), allocates fresh
blocks for the rest, and on free its blocks stay cached (refcount 0,
LRU-evictable) until capacity pressure evicts them.  Every store/evict
is reported so the worker can publish KV events.

Tier simulation (fleet prefix cache): with `host_blocks` > 0 and/or a
shared :class:`SimObjectStore`, G1 evictions demote down the same
G2 (host) -> G4 (shared object store) ladder the real KVBM walks, and
admission onboards tier-resident blocks back into G1 instead of
recomputing prefill, emitting the same per-tier event batches and
ledger ops (stage/tier_evict/onboard/commit-with-parent) as
engine/core.py, so the router's tiered index and the G4 residency
policy run on the CPU.  The JAX module's G4 lookup runs through its
chaos seam (`kvbm.object_io`: stalls charged as simulated I/O time,
corrupt blobs quarantined); here a lookup asks the tier breaker and
reads the store.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class SimObjectStore:
    """Shared in-process G4: the mocker's stand-in for
    kvbm/object_store.py's ObjectStorePool.  Content-addressed by PLH,
    one instance SHARED by every simulated worker in a fleet test (the
    shared-FS mount analogue), with the same sweep contract — a
    residency callable upgrades the blind TTL verdict to hot/dead, and
    sweep returns the reaped hashes so the sweeper can publish
    removed(g4) fleet-wide."""

    def __init__(self, ttl_s: float = 3600.0):
        self.ttl_s = ttl_s
        self._blobs: Dict[int, float] = {}  # hash -> last-renewed time

    def __contains__(self, h: int) -> bool:
        return int(h) in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    def put(self, h: int) -> bool:
        """Idempotent content-addressed put; True when newly stored."""
        new = int(h) not in self._blobs
        self._blobs[int(h)] = time.monotonic()
        return new

    def quarantine(self, h: int) -> bool:
        """Delete a blob that failed verification (the sim analogue of
        ObjectStorePool.quarantine — fleet-wide, since the store is
        shared by every simulated worker)."""
        return self._blobs.pop(int(h), None) is not None

    def keys(self) -> List[int]:
        return list(self._blobs)

    def sweep(self, now: Optional[float] = None,
              residency=None) -> List[int]:
        """Same verdict ladder as ObjectStorePool.sweep: hot renews,
        dead reaps early, None falls back to the TTL clock."""
        now = now if now is not None else time.monotonic()
        reaped: List[int] = []
        for h, t in list(self._blobs.items()):
            verdict = residency(h) if residency is not None else None
            if verdict == "hot":
                self._blobs[h] = now
            elif verdict == "dead" or (verdict is None
                                       and now - t > self.ttl_s):
                del self._blobs[h]
                reaped.append(h)
        return reaped


def kv_dtype_capacity_blocks(num_blocks: int, kv_cache_dtype: str,
                             head_dim: int = 128) -> int:
    """Effective block capacity for a simulated cache at a given KV
    storage dtype: the SAME HBM budget that holds `num_blocks` bf16
    blocks holds 2*hd/(hd+4) as many int8 blocks (int8 data + one fp32
    scale per head_dim elements — quant/kv.py's exact byte ratio; 1.94x
    at the default head_dim 128).  Keeps router/planner tests honest
    about the 2x-blocks regime without a device or a real model config."""
    if kv_cache_dtype == "int8":
        return max(1, int(num_blocks * 2 * head_dim / (head_dim + 4)))
    return num_blocks


@dataclass
class CacheStepResult:
    stored: List[int] = field(default_factory=list)  # newly stored full-block PLHs
    removed: List[int] = field(default_factory=list)  # evicted PLHs
    cached_blocks: int = 0  # prefix-cache hits for this allocation
    # per-tier event batches beyond g1: [(stored, removed, tier), ...] —
    # the exact batch shape engine/core.py's _emit_tier_events feeds the
    # publisher, so the router sees identical wire traffic from the sim
    tier_events: List[Tuple[List[int], List[int], str]] = \
        field(default_factory=list)
    # blocks served into G1 from a lower tier this mutation, by source —
    # drives the engine's onboard-latency model + kv_onboard_* metrics
    onboarded: Dict[str, int] = field(default_factory=dict)


class KvCacheSim:
    def __init__(self, num_blocks: int, enable_prefix_caching: bool = True,
                 kv_cache_dtype: str = "bf16", ledger=None,
                 host_blocks: int = 0, object_store=None,
                 breaker=None):
        num_blocks = kv_dtype_capacity_blocks(num_blocks, kv_cache_dtype)
        self.kv_cache_dtype = kv_cache_dtype
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        # simulated KVBM tiers: a bounded G2 host LRU fed by G1
        # demotions, whose own overflow spills into the SHARED G4
        # object store (the fleet prefix cache).  Zero host_blocks with
        # a store attached spills G1 evictions straight to G4.
        self.host_blocks = max(0, host_blocks)
        self._g2: "OrderedDict[int, None]" = OrderedDict()
        self.g4 = object_store
        # the tier breaker (kvbm/breaker.py) every G4 lookup asks
        self.breaker = breaker
        # block-lifecycle ledger (obs/kv_ledger.py), hash-keyed — sim
        # blocks have no physical identity; partial blocks record as
        # anonymous per-seq counts.  Same accounting contract as
        # engine/block_allocator.py: this module is the only one
        # allowed to mutate the sim's books.
        self.ledger = ledger
        self.free_blocks = num_blocks
        # hash -> refcount of cached full blocks
        self._ref: Dict[int, int] = {}
        # refcount==0 cached blocks in LRU order (evictable)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # per-sequence holdings
        self._seq_full: Dict[str, List[int]] = {}
        self._seq_partial: Dict[str, int] = {}  # count of unhashed blocks held

    # -- capacity ---------------------------------------------------------
    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def evictable_blocks(self) -> int:
        return len(self._lru)

    def can_allocate(self, n_new: int) -> bool:
        return n_new <= self.free_blocks + self.evictable_blocks

    def _evict(self, n: int, out: CacheStepResult) -> bool:
        led = self.ledger
        while n > 0:
            if not self._lru:
                return False
            h, _ = self._lru.popitem(last=False)
            del self._ref[h]
            self.free_blocks += 1
            out.removed.append(h)
            if led is not None:
                led.evict(h, h)
            self._demote(h, out)
            n -= 1
        return True

    # -- tier plumbing ----------------------------------------------------
    def _tier_event(self, out: CacheStepResult, stored: List[int],
                    removed: List[int], tier: str) -> None:
        out.tier_events.append((stored, removed, tier))
        if self.ledger is not None:
            self.ledger.tier_batch(stored, removed, tier)

    def _demote(self, h: int, out: CacheStepResult) -> None:
        """G1 eviction spills to the G2 host LRU; a full G2 spills ITS
        LRU victim into the shared G4 store — the offload ladder the
        real engine's KVBM walks, one hop per pressure event."""
        if self.host_blocks <= 0:
            self._spill_g4(h, out)
            return
        if h in self._g2:
            self._g2.move_to_end(h)
            return
        while len(self._g2) >= self.host_blocks:
            victim, _ = self._g2.popitem(last=False)
            self._tier_event(out, [], [victim], "g2")
            self._spill_g4(victim, out)
        self._g2[h] = None
        self._tier_event(out, [h], [], "g2")

    def _spill_g4(self, h: int, out: CacheStepResult) -> None:
        if self.g4 is None:
            return
        self.g4.put(h)
        # stored(g4) is emitted per SPILLER (content-addressed dedup
        # lives in the store): the router attributes the blob to this
        # worker too, and the consolidator nets re-spills locally
        self._tier_event(out, [h], [], "g4")

    def _g4_lookup(self, h: int, out: CacheStepResult) -> bool:
        """Probe the shared store through the tier breaker (an open
        breaker prices G4 at recompute); the mount answered, so the
        breaker records OK."""
        if self.g4 is None:
            return False
        br = self.breaker
        if br is not None and not br.allow("g4"):
            return False
        if br is not None:
            br.record_ok("g4")
        return h in self.g4

    @property
    def g2_blocks(self) -> int:
        return len(self._g2)

    # -- sequence lifecycle ----------------------------------------------
    def lookup(self, block_hashes: Sequence[int]) -> int:
        """Number of leading blocks already cached (prefix match)."""
        if not self.enable_prefix_caching:
            return 0
        n = 0
        for h in block_hashes:
            if h in self._ref:
                n += 1
            else:
                break
        return n

    def allocate(
        self,
        seq_id: str,
        block_hashes: Sequence[int],
        total_blocks: int,
    ) -> Optional[CacheStepResult]:
        """Admit a sequence: reuse cached prefix blocks, allocate the rest.

        ``block_hashes`` are the PLHs of the prompt's full blocks;
        ``total_blocks`` includes the trailing partial block.  Returns None if
        capacity (after eviction) is insufficient.
        """
        out = CacheStepResult()
        hit = self.lookup(block_hashes)
        n_new = total_blocks - hit
        if n_new > self.free_blocks + self.evictable_blocks:
            return None
        if n_new > self.free_blocks:
            if not self._evict(n_new - self.free_blocks, out):
                return None

        led = self.ledger
        # pin the cache hits
        for h in block_hashes[:hit]:
            self._pin(h)
            if led is not None:
                led.pin(h, seq_id)
        # allocate + store the remaining full blocks; an eviction hole can
        # leave later blocks still cached — pin those instead of re-storing.
        # While the reuse run is still CONTIGUOUS from the g1 hit, a
        # g2/g4-resident block onboards into G1 instead of recomputing
        # prefill (the engine's _try_onboard path); the first true miss
        # breaks the run — prefix KV is position-addressed, so nothing
        # after a hole is reusable.
        run_alive = self.enable_prefix_caching
        for i in range(hit, len(block_hashes)):
            h = block_hashes[i]
            prev = block_hashes[i - 1] if i > 0 else None
            if h in self._ref:
                self._pin(h)
                if led is not None:
                    led.pin(h, seq_id)
                if run_alive:
                    out.cached_blocks += 1
                continue
            src = None
            if run_alive:
                if h in self._g2:
                    src = "g2"
                elif self._g4_lookup(h, out):
                    src = "g4"
            self.free_blocks -= 1
            self._ref[h] = 1
            out.stored.append(h)
            if led is not None:
                led.alloc(h, seq_id, h=h)
                # lineage: parent of block i is block i-1's PLH — what
                # the G4 residency policy walks (kvbm/residency.py)
                led.commit(h, h, parent=prev, seq=seq_id)
            if src is None:
                run_alive = False
                continue
            # onboard: promote the tier copy into G1.  The g2 copy
            # moves (host slot freed); the g4 blob STAYS — it is the
            # shared fleet copy every other worker scores on.
            out.onboarded[src] = out.onboarded.get(src, 0) + 1
            out.cached_blocks += 1
            if src == "g2":
                self._g2.pop(h, None)
                self._tier_event(out, [], [h], "g2")
            if led is not None:
                led.onboard(h, src, seq=seq_id)
        # partial blocks are held but unhashed
        n_partial = total_blocks - len(block_hashes)
        self.free_blocks -= n_partial
        if led is not None and n_partial:
            led.partial(seq_id, n_partial)

        self._seq_full[seq_id] = list(block_hashes)
        self._seq_partial[seq_id] = n_partial
        # realized reuse = g1 leading hits + the contiguous onboarded/
        # pinned extension counted above (forensic cached_tokens)
        out.cached_blocks += hit
        return out

    def _pin(self, h: int) -> None:
        rc = self._ref.get(h, 0)
        if rc == 0:
            self._lru.pop(h, None)
        self._ref[h] = rc + 1

    def grow(self, seq_id: str, completed_hash: Optional[int],
             need_new_block: bool) -> Optional[CacheStepResult]:
        """Decode-step growth: optionally a partial block became full
        (``completed_hash``), optionally a new partial block is needed."""
        out = CacheStepResult()
        led = self.ledger
        if completed_hash is not None:
            # the partial block the seq held gains its identity; the physical
            # slot it occupies is unchanged
            self._seq_partial[seq_id] -= 1
            full = self._seq_full[seq_id]
            parent = full[-1] if full else None
            full.append(completed_hash)
            if completed_hash in self._ref:
                # identical block already cached (e.g. same seed replay):
                # pin it so eviction can't take it out from under us; the
                # seq's partial slot is returned
                self._pin(completed_hash)
                self.free_blocks += 1
                if led is not None:
                    led.pin(completed_hash, seq_id)
            else:
                self._ref[completed_hash] = 1
                out.stored.append(completed_hash)
                if led is not None:
                    led.alloc(completed_hash, seq_id, h=completed_hash)
                    led.commit(completed_hash, completed_hash,
                               parent=parent, seq=seq_id)
            if led is not None:
                led.partial(seq_id, -1)
        if need_new_block:
            if self.free_blocks < 1 and not self._evict(1, out):
                return None
            self.free_blocks -= 1
            self._seq_partial[seq_id] += 1
            if led is not None:
                led.partial(seq_id, 1)
        return out

    def free(self, seq_id: str) -> CacheStepResult:
        """Release a sequence. Full blocks stay cached (LRU); partials drop."""
        out = CacheStepResult()
        led = self.ledger
        for h in self._seq_full.pop(seq_id, []):
            rc = self._ref.get(h, 1) - 1
            if rc <= 0:
                if self.enable_prefix_caching:
                    self._ref[h] = 0
                    self._lru[h] = None
                    self._lru.move_to_end(h)
                    if led is not None:
                        led.unpin(h, seq_id)
                        led.cache(h, seq_id)
                else:
                    del self._ref[h]
                    self.free_blocks += 1
                    out.removed.append(h)
                    if led is not None:
                        led.release(h, seq_id)
            else:
                self._ref[h] = rc
                if led is not None:
                    led.unpin(h, seq_id)
        self.free_blocks += self._seq_partial.pop(seq_id, 0)
        if led is not None:
            # seq_freed drops the seq's partial counts and arms the
            # finish-cadence audit
            led.seq_freed(seq_id)
        return out

    def clear_cached(self) -> List[int]:
        """Drop every unreferenced cached block; active sequences keep
        theirs (ref: clear_kv_blocks endpoint)."""
        removed: List[int] = []
        led = self.ledger
        while self._lru:
            h, _ = self._lru.popitem(last=False)
            del self._ref[h]
            self.free_blocks += 1
            removed.append(h)
            if led is not None:
                led.evict(h, h)
        return removed

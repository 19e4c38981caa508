"""Host-side physical block allocator with PLH prefix caching.

A copy of dynamo_tpu/engine/block_allocator.py.  Full blocks are
registered under their PositionalLineageHash for dedup/reuse; refcount-0
registered blocks stay cached in LRU order until evicted.  Block id 0 is the garbage block
(never allocated): inactive rows' KV writes land there and are never
read.

Every mutation returns the KV events (stored/removed hashes) the worker
publishes, so the router's view stays consistent with device memory;
`coldest_evictable` names the KVBM offload's candidates.

Accounting contract (obs/kv_ledger.py): every refcount/free-list
transition is also recorded onto the engine's KV ledger at its
definition site here, one ``if led is None`` pointer compare per
mutation when the ledger is off.  This module is the only place that
mutates the allocator's books: a mutation elsewhere is the silent
leak/double-free class the ledger's auditor exists to catch.  The
``engine.kv_account`` chaos seam deliberately seeds each violation
class (leak / double-free / orphan / refcount-drift) so the auditor's
detection is regression-provable.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import chaos


@dataclass
class AllocResult:
    block_ids: List[int]
    cached_blocks: int  # leading blocks reused from the prefix cache
    stored: List[int] = field(default_factory=list)
    removed: List[int] = field(default_factory=list)


@dataclass
class GrowResult:
    block_id: Optional[int] = None  # newly appended block, if requested
    stored: List[int] = field(default_factory=list)
    removed: List[int] = field(default_factory=list)


class BlockAllocator:
    def __init__(self, num_blocks: int, enable_prefix_caching: bool = True,
                 ledger=None):
        # id 0 reserved as the garbage block
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        self.ledger = ledger  # obs/kv_ledger.KvLedger | None (off)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._hash_to_block: Dict[int, int] = {}
        self._block_ref: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # hash, rc==0
        self._seq_blocks: Dict[str, List[int]] = {}

    # -- introspection ----------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        return len(self._lru)

    def usage(self) -> float:
        usable = self.num_blocks - 1
        return (usable - self.num_free) / max(1, usable)

    def lookup(self, hashes: Sequence[int]) -> int:
        if not self.enable_prefix_caching:
            return 0
        n = 0
        for h in hashes:
            if h in self._hash_to_block:
                n += 1
            else:
                break
        return n

    def seq_block_ids(self, seq_id: str) -> List[int]:
        return self._seq_blocks.get(seq_id, [])

    def coldest_evictable(self, n: int, exclude=(),
                          scan_limit: Optional[int] = None
                          ) -> List[Tuple[int, int]]:
        """Up to n (hash, block_id) pairs from the cold end of the LRU,
        skipping `exclude` hashes — offload candidates (the blocks the next
        evictions would destroy).  Does not mutate.

        scan_limit bounds the walk: once the cold end is fully excluded
        (already offloaded), an unbounded scan would cost O(num_blocks) of
        Python per scheduler step for an empty result.  Candidates cluster at
        the cold end and excluded entries there are evicted by allocation, so
        a bounded scan still finds fresh cold blocks as the head refreshes."""
        out: List[Tuple[int, int]] = []
        for i, h in enumerate(self._lru):
            if scan_limit is not None and i >= scan_limit:
                break
            if h in exclude:
                continue
            out.append((h, self._hash_to_block[h]))
            if len(out) >= n:
                break
        return out

    # -- internals --------------------------------------------------------
    def _evict_one(self, removed: List[int]) -> Optional[int]:
        if not self._lru:
            return None
        h, _ = self._lru.popitem(last=False)
        bid = self._hash_to_block.pop(h)
        self._block_ref.pop(bid, None)
        self._block_hash.pop(bid, None)
        removed.append(h)
        led = self.ledger
        if led is not None:
            led.evict(bid, h)
        return bid

    def _take_block(self, removed: List[int]) -> Optional[int]:
        if self._free:
            return self._free.pop()
        return self._evict_one(removed)

    def _pin(self, h: int) -> int:
        bid = self._hash_to_block[h]
        if self._block_ref.get(bid, 0) == 0:
            self._lru.pop(h, None)
        self._block_ref[bid] = self._block_ref.get(bid, 0) + 1
        return bid

    def _unpin(self, h: int) -> None:
        bid = self._hash_to_block[h]
        rc = self._block_ref.get(bid, 1) - 1
        self._block_ref[bid] = rc
        if rc == 0:
            self._lru[h] = None
            self._lru.move_to_end(h)

    def _release_one(self, bid: int, seq_id: Optional[str],
                     released: Optional[List[int]] = None) -> Optional[int]:
        """Shared free()/trim_blocks() tail: drop one block whose rc hit
        0 — back to the prefix cache when registered, else to the free
        list — with the matching ledger records.  Returns the hash whose
        registration was destroyed (a `removed` KV event), if any."""
        led = self.ledger
        h = self._block_hash.get(bid)
        if h is not None and self._hash_to_block.get(h) == bid \
                and self.enable_prefix_caching:
            self._block_ref[bid] = 0
            self._lru[h] = None
            self._lru.move_to_end(h)
            if led is not None:
                led.unpin(bid, seq_id)
                led.cache(bid, seq_id)
            return None
        self._block_ref.pop(bid, None)
        self._block_hash.pop(bid, None)
        self._free.append(bid)
        if released is not None:
            released.append(bid)
        if led is not None:
            led.release(bid, seq_id)
        if h is not None and self._hash_to_block.get(h) == bid:
            del self._hash_to_block[h]
            return h
        return None

    # -- lifecycle --------------------------------------------------------
    def allocate(self, seq_id: str, hashes: Sequence[int],
                 total_blocks: int) -> Optional[AllocResult]:
        """Admit a sequence needing `total_blocks` blocks, the first
        len(hashes) of which are full blocks with known PLHs."""
        led = self.ledger
        hit = self.lookup(hashes)
        res = AllocResult(block_ids=[], cached_blocks=hit)
        # pin the hits FIRST so the capacity check below counts only LRU
        # entries that are actually evictable (pinning removes hits from it)
        for h in hashes[:hit]:
            bid = self._pin(h)
            res.block_ids.append(bid)
            if led is not None:
                led.pin(bid, seq_id)
        n_new = total_blocks - hit
        if n_new > self.num_free + self.num_evictable:
            for h in hashes[:hit]:
                self._unpin(h)
                if led is not None:
                    bid = self._hash_to_block[h]
                    led.unpin(bid, seq_id)
                    if self._block_ref.get(bid, 0) == 0:
                        led.cache(bid, seq_id)
            return None
        # from here the loop cannot run out of blocks (single-threaded
        # scheduler owns the allocator)
        for _ in range(hit, total_blocks):
            bid = self._take_block(res.removed)
            assert bid is not None, "capacity invariant violated"
            self._block_ref[bid] = 1
            res.block_ids.append(bid)
            if led is not None:
                led.alloc(bid, seq_id)
        # chaos seam (engine.kv_account): an extra, unledgered refcount —
        # the precursor drift state the auditor must flag before it grows
        # into a leak
        if chaos.active() is not None and res.block_ids \
                and chaos.hit("engine.kv_account",
                              key=f"refcount_drift:{seq_id}") == "drop":
            self._block_ref[res.block_ids[-1]] += 1
        # Registration of the non-hit full blocks is DEFERRED to
        # commit_block, once prefill has materialized their K/V: registering
        # here would let a concurrent same-prefix request prefix-match
        # blocks whose cache contents are still zeros (the engine interleaves
        # prefill chunks with other admissions).
        self._seq_blocks[seq_id] = list(res.block_ids)
        return res

    def append_block(self, seq_id: str) -> GrowResult:
        """Grow a sequence by one (partial) block for decode."""
        res = GrowResult()
        bid = self._take_block(res.removed)
        if bid is None:
            return res  # caller must handle OOM (preempt)
        self._block_ref[bid] = 1
        self._seq_blocks[seq_id].append(bid)
        res.block_id = bid
        if self.ledger is not None:
            self.ledger.alloc(bid, seq_id)
        return res

    def trim_blocks(self, seq_id: str, keep: int) -> GrowResult:
        """Free a sequence's trailing blocks beyond its first `keep`
        (speculative-decode rollback: blocks grown to hold rejected draft
        tokens' KV return to the free list, so the accounting matches
        plain decode).  Trailing blocks are partial and unregistered by
        construction — registered/shared blocks only ever sit in the
        committed prefix, which the engine never trims past — but the
        release mirrors free()'s full handling for safety."""
        res = GrowResult()
        blocks = self._seq_blocks.get(seq_id)
        if blocks is None:
            return res
        led = self.ledger
        while len(blocks) > max(keep, 0):
            bid = blocks.pop()
            rc = self._block_ref.get(bid, 1) - 1
            if rc > 0:
                self._block_ref[bid] = rc
                if led is not None:
                    led.unpin(bid, seq_id)
                continue
            gone = self._release_one(bid, seq_id)
            if gone is not None:
                res.removed.append(gone)
        return res

    def commit_block(self, seq_id: str, block_index: int, h: int) -> GrowResult:
        """A sequence's partial block became full: register its PLH."""
        res = GrowResult()
        if not self.enable_prefix_caching:
            return res
        bid = self._seq_blocks[seq_id][block_index]
        if h not in self._hash_to_block:
            self._hash_to_block[h] = bid
            self._block_hash[bid] = h
            res.stored.append(h)
            led = self.ledger
            if led is not None:
                # lineage parent: the preceding block's registered hash
                # (None for the root) — what the ledger's fragmentation
                # attribution walks to find dead cached tails
                parent = None
                if block_index > 0:
                    parent = self._block_hash.get(
                        self._seq_blocks[seq_id][block_index - 1])
                led.commit(bid, h, parent=parent, seq=seq_id)
        return res

    def free(self, seq_id: str) -> GrowResult:
        """Release a sequence; registered blocks stay cached (LRU)."""
        res = GrowResult()
        blocks = self._seq_blocks.pop(seq_id, [])
        led = self.ledger
        if chaos.active() is not None and blocks:
            blocks = self._chaos_corrupt(seq_id, blocks)
        released: List[int] = []
        for bid in blocks:
            rc = self._block_ref.get(bid, 1) - 1
            if rc > 0:
                self._block_ref[bid] = rc
                if led is not None:
                    led.unpin(bid, seq_id)
                continue
            gone = self._release_one(bid, seq_id, released)
            if gone is not None:
                res.removed.append(gone)
        # chaos seam: return an already-freed id to the free list a
        # second time — the classic double-free the auditor must flag
        if chaos.active() is not None and released \
                and chaos.hit("engine.kv_account",
                              key=f"double_free:{seq_id}") == "drop":
            self._free.append(released[0])
        if led is not None:
            led.seq_freed(seq_id)
        return res

    def _chaos_corrupt(self, seq_id: str, blocks: List[int]) -> List[int]:
        """engine.kv_account seam, "drop" action: seed the accounting
        faults the ledger auditor exists to catch.  Each key names the
        violation class a rule's ``match=`` selects."""
        blocks = list(blocks)
        if blocks and chaos.hit("engine.kv_account",
                                key=f"leak:{seq_id}") == "drop":
            # "forget" the trailing block: free() never releases it and
            # the ledger keeps a dead owner — capacity silently lost
            blocks.pop()
        if blocks and chaos.hit("engine.kv_account",
                                key=f"orphan:{seq_id}") == "drop":
            # release a block behind the ledger's back (the rogue-code
            # path this module alone may take): the books now point at
            # a ghost
            bid = blocks.pop()
            self._block_ref.pop(bid, None)
            h = self._block_hash.pop(bid, None)
            if h is not None and self._hash_to_block.get(h) == bid:
                del self._hash_to_block[h]
            self._free.append(bid)
        return blocks

    def clear_cached(self) -> List[int]:
        """Drop every *unreferenced* cached block (active sequences keep
        theirs).  Safe to run between scheduler steps."""
        removed: List[int] = []
        led = self.ledger
        while self._lru:
            bid = self._evict_one(removed)
            if bid is not None:
                self._free.append(bid)
                if led is not None:
                    led.release(bid)
        return removed

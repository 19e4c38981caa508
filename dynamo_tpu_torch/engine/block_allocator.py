"""Host-side physical block allocator with PLH prefix caching.

A copy of dynamo_tpu/engine/block_allocator.py without its chaos seam and
its KV-ledger hooks (neither plane is part of the port yet).  Full blocks
are registered under their PositionalLineageHash for dedup/reuse;
refcount-0 registered blocks stay cached in LRU order until evicted.
Block id 0 is the garbage block (never allocated): inactive rows' KV
writes land there and are never read.

Every mutation returns the KV events (stored/removed hashes) the worker
publishes, so the router's view stays consistent with device memory;
`coldest_evictable` names the KVBM offload's candidates.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


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
    def __init__(self, num_blocks: int, enable_prefix_caching: bool = True):
        # id 0 reserved as the garbage block
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
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

    def seq_block_ids(self, seq_id: str) -> List[int]:
        return self._seq_blocks.get(seq_id, [])

    def coldest_evictable(self, n: int, exclude=(),
                          scan_limit: Optional[int] = None
                          ) -> List[Tuple[int, int]]:
        """Up to n (hash, block_id) pairs from the cold end of the LRU,
        skipping `exclude` hashes: offload candidates (the blocks the next
        evictions would destroy).  Does not mutate.

        scan_limit bounds the walk: once the cold end is fully excluded
        (already offloaded), an unbounded scan would cost O(num_blocks) of
        Python per scheduler step for an empty result."""
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

    # -- internals --------------------------------------------------------
    def _evict_one(self, removed: List[int]) -> Optional[int]:
        if not self._lru:
            return None
        h, _ = self._lru.popitem(last=False)
        bid = self._hash_to_block.pop(h)
        self._block_ref.pop(bid, None)
        self._block_hash.pop(bid, None)
        removed.append(h)
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

    def _release_one(self, bid: int) -> Optional[int]:
        """Drop one block whose rc hit 0: back to the prefix cache when
        registered, else to the free list.  Returns the hash whose
        registration was destroyed (a `removed` KV event), if any."""
        h = self._block_hash.get(bid)
        if h is not None and self._hash_to_block.get(h) == bid \
                and self.enable_prefix_caching:
            self._block_ref[bid] = 0
            self._lru[h] = None
            self._lru.move_to_end(h)
            return None
        self._block_ref.pop(bid, None)
        self._block_hash.pop(bid, None)
        self._free.append(bid)
        if h is not None and self._hash_to_block.get(h) == bid:
            del self._hash_to_block[h]
            return h
        return None

    # -- lifecycle --------------------------------------------------------
    def allocate(self, seq_id: str, hashes: Sequence[int],
                 total_blocks: int) -> Optional[AllocResult]:
        """Admit a sequence needing `total_blocks` blocks, the first
        len(hashes) of which are full blocks with known PLHs."""
        hit = self.lookup(hashes)
        res = AllocResult(block_ids=[], cached_blocks=hit)
        # pin the hits FIRST so the capacity check below counts only LRU
        # entries that are actually evictable (pinning removes hits from it)
        for h in hashes[:hit]:
            res.block_ids.append(self._pin(h))
        n_new = total_blocks - hit
        if n_new > self.num_free + self.num_evictable:
            for h in hashes[:hit]:
                self._unpin(h)
            return None
        # from here the loop cannot run out of blocks (single-threaded
        # scheduler owns the allocator)
        for _ in range(hit, total_blocks):
            bid = self._take_block(res.removed)
            assert bid is not None, "capacity invariant violated"
            self._block_ref[bid] = 1
            res.block_ids.append(bid)
        # Registration of the non-hit full blocks is DEFERRED to
        # commit_block, once prefill has materialized their K/V:
        # registering here would let a concurrent same-prefix request
        # prefix-match blocks whose cache contents are still zeros.
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
        return res

    def trim_blocks(self, seq_id: str, keep: int) -> GrowResult:
        """Free a sequence's trailing blocks beyond its first `keep`
        (speculative-decode rollback: blocks grown to hold rejected draft
        tokens' KV return to the free list, so the accounting matches
        plain decode).  Trailing blocks are partial and unregistered by
        construction, but the release mirrors free()'s full handling."""
        res = GrowResult()
        blocks = self._seq_blocks.get(seq_id)
        if blocks is None:
            return res
        while len(blocks) > max(keep, 0):
            bid = blocks.pop()
            rc = self._block_ref.get(bid, 1) - 1
            if rc > 0:
                self._block_ref[bid] = rc
                continue
            gone = self._release_one(bid)
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
        return res

    def free(self, seq_id: str) -> GrowResult:
        """Release a sequence; registered blocks stay cached (LRU)."""
        res = GrowResult()
        for bid in self._seq_blocks.pop(seq_id, []):
            rc = self._block_ref.get(bid, 1) - 1
            if rc > 0:
                self._block_ref[bid] = rc
                continue
            gone = self._release_one(bid)
            if gone is not None:
                res.removed.append(gone)
        return res

    def clear_cached(self) -> List[int]:
        """Drop every *unreferenced* cached block (active sequences keep
        theirs).  Safe to run between scheduler steps."""
        removed: List[int] = []
        while self._lru:
            bid = self._evict_one(removed)
            if bid is not None:
                self._free.append(bid)
        return removed

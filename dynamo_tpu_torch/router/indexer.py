"""KV indexer: which worker has which blocks, and prefix-overlap queries.

A copy of dynamo_tpu/router/indexer.py.  Its native engine is the port's
own copy of the C++ indexer (csrc/kv_indexer.cc, built and bound by
router/native_indexer.py).

Ref: lib/kv-router/src/indexer/ (RadixTree :49, ConcurrentRadixTree :118,
KvIndexer kv_indexer.rs:228).  Because PositionalLineageHashes chain their
whole prefix, a radix-tree prefix walk is equivalent to a front-to-back
membership walk over a flat hash→owners map — so the index is a hash map and
per-worker ownership is a bitmask, giving O(prefix_len) matches with tiny
constants.  A C++ implementation with the same semantics
(csrc/kv_indexer.cc, loaded via ctypes) replaces this pure-Python one
when built; both are cross-checked by tests/test_torch_native_indexer.py.

Event-stream integrity mirrors the reference (router-design.md:186-195):
per-worker monotonically increasing event ids; on a gap the caller replays
from the worker's local ring buffer (KvEventPublisher.replay_handler).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Set

logger = logging.getLogger(__name__)


class PyKvIndexer:
    """Pure-Python reference indexer (fallback when the C++ lib is absent)."""

    def __init__(self) -> None:
        self._owners: Dict[int, Set[int]] = {}  # hash -> worker ids
        self._worker_blocks: Dict[int, Set[int]] = {}  # worker -> hashes
        self.last_event_id: Dict[int, int] = {}

    # -- event application ------------------------------------------------
    def apply_stored(self, worker_id: int, hashes: Sequence[int]) -> None:
        wb = self._worker_blocks.setdefault(worker_id, set())
        for h in hashes:
            self._owners.setdefault(h, set()).add(worker_id)
            wb.add(h)

    def apply_removed(self, worker_id: int, hashes: Sequence[int]) -> None:
        wb = self._worker_blocks.get(worker_id)
        for h in hashes:
            owners = self._owners.get(h)
            if owners is not None:
                owners.discard(worker_id)
                if not owners:
                    del self._owners[h]
            if wb is not None:
                wb.discard(h)

    def remove_worker(self, worker_id: int) -> None:
        for h in self._worker_blocks.pop(worker_id, set()):
            owners = self._owners.get(h)
            if owners is not None:
                owners.discard(worker_id)
                if not owners:
                    del self._owners[h]
        self.last_event_id.pop(worker_id, None)

    def clear_worker(self, worker_id: int) -> None:
        for h in self._worker_blocks.get(worker_id, set()).copy():
            self.apply_removed(worker_id, [h])

    # -- queries ----------------------------------------------------------
    def find_matches(self, hashes: Sequence[int]) -> Dict[int, int]:
        """Per-worker longest consecutive prefix overlap (in blocks).

        Walk front-to-back keeping the set of workers that own every block
        so far; when a worker drops out, its overlap is the drop index."""
        overlaps: Dict[int, int] = {}
        active: Optional[Set[int]] = None
        end = len(hashes)
        for i, h in enumerate(hashes):
            owners = self._owners.get(h)
            if not owners:
                end = i
                break
            if active is None:
                active = set(owners)
            else:
                for w in active - owners:
                    overlaps[w] = i
                active &= owners
            if not active:
                break
        if active:
            for w in active:
                overlaps[w] = end
        return overlaps

    def worker_block_count(self, worker_id: int) -> int:
        return len(self._worker_blocks.get(worker_id, ()))

    @property
    def num_blocks(self) -> int:
        return len(self._owners)

    @property
    def workers(self) -> List[int]:
        return list(self._worker_blocks.keys())


def indexer_impl(ix) -> str:
    """Implementation tag for debug/metrics surfaces ("py" | "native").

    Unwraps the tier-aware layer (router/tiered_index.py) — the tag names
    the underlying membership engine, which is what perf A/Bs compare."""
    base = getattr(ix, "base", ix)
    return "py" if isinstance(base, PyKvIndexer) else "native"


def make_indexer(impl: Optional[str] = None):
    """C++ indexer when built (the default), Python fallback otherwise.

    `impl` (or env DYN_INDEXER) pins the choice: "native" builds the
    port's library when it is missing and raises with the compiler's
    output if that fails instead of silently degrading, "py" forces the
    reference implementation (parity tests, perf A/B), "auto" takes the
    native indexer when its library is already built."""
    impl = impl or os.environ.get("DYN_INDEXER", "auto")
    if impl not in ("auto", "py", "native"):
        raise ValueError(f"DYN_INDEXER={impl!r}: expected auto|py|native")
    if impl == "py":
        return PyKvIndexer()
    from . import native_indexer

    if impl == "native" or native_indexer.is_built():
        return native_indexer.NativeKvIndexer()
    return PyKvIndexer()

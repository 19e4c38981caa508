"""Lineage-driven G4 residency policy, a copy of
dynamo_tpu/kvbm/residency.py.

Blind TTL-by-mtime treats a hot shared-prefix lineage and a dead one
alike.  This policy upgrades each blob's sweep verdict from a KV
ledger's books:

    hot    the hash saw traffic within `hot_window_s`: the sweep touches
           the blob's mtime, so live lineages never TTL out
    dead   the blob's parent is gone from every tier this worker can see
           (its own books AND the shared store): reap early
    None   unknown: the TTL clock decides, unchanged

The port has no KV ledger yet, so its engine builds
`LineageResidency(None, pool)`, which answers None for every hash: the
TTL decides, as in the JAX engine with `kv_ledger` off.  The object
store stays policy-free; this module is the `residency` callable its
sweep accepts.
"""

from __future__ import annotations

import time
from typing import Optional

# traffic within this window marks a lineage hot (sweep cadence is the
# worker load loop's seconds-scale tick, so minutes-scale is "live")
DEFAULT_HOT_WINDOW_S = 300.0


class LineageResidency:
    """hash -> "hot" | "dead" | None, from the ledger's lineage books.

    Built per sweep (the resident set is snapshotted once, not per
    blob); pass the instance straight as ObjectStorePool.sweep's
    `residency` argument."""

    def __init__(self, ledger, pool=None,
                 hot_window_s: float = DEFAULT_HOT_WINDOW_S,
                 now: Optional[float] = None):
        self.ledger = ledger
        self.pool = pool
        self.hot_window_s = hot_window_s
        self._now = now if now is not None else time.monotonic()
        self._resident = (ledger.resident_hashes()
                          if ledger is not None else set())

    def __call__(self, h: int) -> Optional[str]:
        if self.ledger is None:
            return None
        if self.ledger.touched_within(h, self.hot_window_s, now=self._now):
            return "hot"
        known, parent = self.ledger.lineage_parent(h)
        if not known:
            return None  # commit record aged out: TTL decides
        if parent is None:
            return None  # lineage root: reachable by definition
        if parent in self._resident:
            return None
        if self.pool is not None and parent in self.pool:
            return None  # parent lives in the shared store itself
        return "dead"

    def verdicts(self, hashes) -> dict:
        """Debug surface (/debug/kv): verdict histogram + examples."""
        counts = {"hot": 0, "dead": 0, "ttl": 0}
        for h in hashes:
            v = self(h) or "ttl"
            counts[v] = counts.get(v, 0) + 1
        return counts

"""Cross-tier KV event consolidation, a copy of
dynamo_tpu/kvbm/consolidator.py.

The stream is **per-tier netted**:

  * `stored(tier=t)` is published when a block enters tier *t* and was not
    already resident there, and
  * `removed(tier=t)` when it leaves a tier it was resident in.

Duplicate mutations inside one tier net to nothing, so `stored(g1) ->
offload stored(g2) -> evict removed(g1)` tells the router precisely what
happened: the block moved from device memory to host memory.

G4 is the shared object store: any worker may sweep a blob another
worker spilled, so `removed(tier="g4")` passes through even when this
worker's books never saw the store: the consolidator must not eat a GC
notification because the sweeper was not the spiller.

Runs on the engine's scheduler thread (the thread of every cache
mutation), so net-event order equals mutation order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

# (stored_hashes, removed_hashes, tier) ready for KvEventPublisher
NetBatch = Tuple[List[int], List[int], str]


class KvEventConsolidator:
    def __init__(self) -> None:
        self._tiers: Dict[int, Set[str]] = {}

    def apply(self, stored: Sequence[int], removed: Sequence[int],
              tier: str) -> NetBatch:
        """Fold one tier's mutation into the cross-tier view.

        Removals are processed before stores (mirroring the publisher's
        removed-before-stored wire discipline) so an evict+re-register of the
        same hash inside one mutation nets out correctly."""
        net_removed: List[int] = []
        for h in removed:
            tiers = self._tiers.get(h)
            if tiers is None or tier not in tiers:
                if tier == "g4":
                    # shared-store GC: the sweeper may not be the spiller
                    net_removed.append(h)
                continue
            tiers.discard(tier)
            if not tiers:
                del self._tiers[h]
            net_removed.append(h)
        net_stored: List[int] = []
        for h in stored:
            tiers = self._tiers.get(h)
            if tiers is None:
                self._tiers[h] = {tier}
                net_stored.append(h)
            elif tier not in tiers:
                tiers.add(tier)
                net_stored.append(h)
        return net_stored, net_removed, tier

"""Fleet prefix cache: tier-aware ownership layered on the KV indexer.

A copy of dynamo_tpu/router/tiered_index.py.  The worker's load loop
prices its tiers with `compute_tier_costs`/`degraded_tier_costs` and
publishes them as `kv_tier_costs`; the port's KV router indexes with
`TieredKvIndexer`.

Ref: lib/kv-router/src/indexer/lower_tier.rs (the reference feeds G2/G3
indexers into routing) and the kvbm-design tier ladder G1→G4 treated as
one placement space.

The base indexer (PyKvIndexer or NativeKvIndexer — either works, so the
py/native parity the tests pin carries over by construction) keeps what it
always kept: UNION membership per worker, "worker w can serve block h from
some local tier".  This wrapper layers on top of it:

  * per-(worker, tier) residency for g1/g2/g3, rebuilt from the per-tier
    netted event stream (kvbm/consolidator.py) — base membership is
    derived: a worker enters the base set when its first local tier stores
    a block and leaves when its last local tier drops it;
  * a fleet-wide G4 set: the object store is shared (content-addressed,
    one blob per PLH), so a G4 hit scores for EVERY candidate worker, not
    just the spiller.  ``removed(tier="g4")`` from any worker (the sweeper
    need not be the spiller) drops the hash fleet-wide.

``find_matches_tiered`` extends the classic longest-leading-run overlap
through G4: a cold worker's run over a warm fleet's shared prefix is the
full G4-resident prefix, priced by the selector at tier cost instead of
free.  Staleness note: a spiller's snapshot may re-advertise a G4 blob a
peer already swept; the engine's onboard path treats a missing blob as a
broken run (ObjectStorePool.get -> None), so the cost is one shortened
onboard, never corruption.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Set, Tuple

logger = logging.getLogger(__name__)

TIERS = ("g1", "g2", "g3", "g4")
LOCAL_TIERS = ("g1", "g2", "g3")

# onboard-cost per block, as a fraction of recomputing the block's tokens
# (fallbacks when a worker has not yet published measured `kv_tier_costs`
# from its roofline plane; see `compute_tier_costs`).  g1 is free by
# definition; g4 rides a shared FS so it is priced closest to recompute.
DEFAULT_TIER_COSTS: Dict[str, float] = {
    "g1": 0.0, "g2": 0.1, "g3": 0.4, "g4": 0.7,
}

# default onboard bandwidth per tier (bytes/s) when the worker has no
# measurement: host->HBM staging, disk read, shared-FS read
DEFAULT_TIER_BW: Dict[str, float] = {
    "g2": 8e9, "g3": 1.5e9, "g4": 0.6e9,
}


def compute_tier_costs(prefill_flops_per_s: Optional[float],
                       flops_per_token: float,
                       bytes_per_block: float,
                       block_tokens: int,
                       tier_bw: Optional[Dict[str, float]] = None,
                       ) -> Dict[str, float]:
    """Per-tier onboard cost as a fraction of recompute cost.

    cost_t = (bytes_per_block / bw_t) / (block_tokens * flops_per_token
    / prefill_flops_per_s) — onboard seconds over recompute seconds for
    one block.  The worker computes this from its roofline plane's
    MEASURED prefill flops/s (FpmWindow phase rates) and publishes it in
    load_metrics as `kv_tier_costs`; the selector falls back to
    DEFAULT_TIER_COSTS for workers that have not measured yet."""
    if (not prefill_flops_per_s or prefill_flops_per_s <= 0
            or flops_per_token <= 0 or bytes_per_block <= 0
            or block_tokens <= 0):
        return dict(DEFAULT_TIER_COSTS)
    recompute_s = block_tokens * flops_per_token / prefill_flops_per_s
    if recompute_s <= 0:
        return dict(DEFAULT_TIER_COSTS)
    bw = dict(DEFAULT_TIER_BW)
    if tier_bw:
        bw.update({t: v for t, v in tier_bw.items() if v and v > 0})
    costs = {"g1": 0.0}
    for t in ("g2", "g3", "g4"):
        onboard_s = bytes_per_block / bw[t]
        costs[t] = round(onboard_s / recompute_s, 4)
    return costs


def degraded_tier_costs(costs: Optional[Dict[str, float]],
                        tier_states: Optional[Dict[str, str]],
                        ) -> Optional[Dict[str, float]]:
    """Fold circuit-breaker states (kvbm/breaker.py) into the costs a
    worker advertises: any non-closed tier is priced AT recompute (1.0),
    so the selector's overlap discount for blocks only reachable through
    that tier collapses to zero — it prices recompute instead of
    onboarding from a tier that times out.

    Publishing the degraded tier beats omitting it: a missing key makes
    the selector fall back to DEFAULT_TIER_COSTS, which would keep
    advertising a cheap tier this worker cannot actually read."""
    if not tier_states or all(s == "closed"
                              for s in tier_states.values()):
        return costs
    out = dict(costs) if costs else dict(DEFAULT_TIER_COSTS)
    for tier, st in tier_states.items():
        if st != "closed":
            out[tier] = 1.0
    return out


class TieredKvIndexer:
    """Tier-aware wrapper over either base indexer implementation.

    Exposes the full base surface (the router's ingestion/debug paths are
    unchanged) plus per-tier apply_* and `find_matches_tiered`."""

    def __init__(self, base) -> None:
        self.base = base
        # (worker, tier) -> resident hashes, local tiers only
        self._tier_blocks: Dict[Tuple[int, str], Set[int]] = {}
        # fleet-wide object-store membership + spiller attribution (the
        # attribution only serves clear_worker resync hygiene)
        self._g4: Set[int] = set()
        self._g4_by_worker: Dict[int, Set[int]] = {}

    # -- event application (per-tier netted stream) -----------------------
    @property
    def last_event_id(self) -> Dict[int, int]:
        return self.base.last_event_id

    def _local_tiers_holding(self, worker_id: int, h: int) -> bool:
        return any(h in self._tier_blocks.get((worker_id, t), ())
                   for t in LOCAL_TIERS)

    def apply_stored(self, worker_id: int, hashes: Sequence[int],
                     tier: str = "g1") -> None:
        if tier == "g4":
            wb = self._g4_by_worker.setdefault(worker_id, set())
            for h in hashes:
                self._g4.add(h)
                wb.add(h)
            return
        tb = self._tier_blocks.setdefault((worker_id, tier), set())
        new_union = [h for h in hashes
                     if not self._local_tiers_holding(worker_id, h)]
        for h in hashes:
            tb.add(h)
        if new_union:
            self.base.apply_stored(worker_id, new_union)

    def apply_removed(self, worker_id: int, hashes: Sequence[int],
                      tier: str = "g1") -> None:
        if tier == "g4":
            for h in hashes:
                self._g4.discard(h)
                for wb in self._g4_by_worker.values():
                    wb.discard(h)
            return
        tb = self._tier_blocks.get((worker_id, tier))
        gone_union: List[int] = []
        for h in hashes:
            if tb is not None:
                tb.discard(h)
            if not self._local_tiers_holding(worker_id, h):
                gone_union.append(h)
        if gone_union:
            self.base.apply_removed(worker_id, gone_union)

    def remove_worker(self, worker_id: int) -> None:
        """Worker left the fleet: drop its local tiers.  Its G4 blobs
        outlive it on the shared store and stay onboardable."""
        self.base.remove_worker(worker_id)
        for t in LOCAL_TIERS:
            self._tier_blocks.pop((worker_id, t), None)
        self._g4_by_worker.pop(worker_id, None)

    def clear_worker(self, worker_id: int) -> None:
        """Resync reset (gap recovery / `cleared` op): drop local tiers
        AND this worker's attributed G4 entries — the follow-up snapshot
        re-advertises whatever is still live, so stale blobs cannot
        accumulate across resyncs."""
        self.base.clear_worker(worker_id)
        for t in LOCAL_TIERS:
            self._tier_blocks.pop((worker_id, t), None)
        for h in self._g4_by_worker.pop(worker_id, set()):
            self._g4.discard(h)

    # -- queries ----------------------------------------------------------
    def find_matches(self, hashes: Sequence[int]) -> Dict[int, int]:
        return self.base.find_matches(hashes)

    def find_matches_tiered(self, hashes: Sequence[int],
                            candidates: Sequence[int],
                            ) -> Dict[int, Dict[str, int]]:
        """Per-candidate longest leading run, split by cheapest source.

        A block counts for worker w at its cheapest tier: g1 if HBM-
        resident on w, else g2/g3, else g4 when the shared store holds it
        (ANY candidate scores a G4 block — fleet-wide ownership).  The
        run for w breaks at the first block w cannot source anywhere.
        Returns {worker: {tier: blocks}} with only nonzero entries."""
        counts: Dict[int, Dict[str, int]] = {int(w): {} for w in candidates}
        active: Set[int] = set(counts)
        for h in hashes:
            if not active:
                break
            in_g4 = h in self._g4
            dropped: List[int] = []
            for w in active:
                tier = None
                for t in LOCAL_TIERS:
                    if h in self._tier_blocks.get((w, t), ()):
                        tier = t
                        break
                if tier is None and in_g4:
                    tier = "g4"
                if tier is None:
                    dropped.append(w)
                    continue
                c = counts[w]
                c[tier] = c.get(tier, 0) + 1
            active.difference_update(dropped)
        return {w: c for w, c in counts.items() if c}

    def worker_block_count(self, worker_id: int) -> int:
        return self.base.worker_block_count(worker_id)

    def tier_block_count(self, worker_id: int, tier: str) -> int:
        if tier == "g4":
            return len(self._g4_by_worker.get(worker_id, ()))
        return len(self._tier_blocks.get((worker_id, tier), ()))

    @property
    def g4_blocks(self) -> int:
        return len(self._g4)

    @property
    def num_blocks(self) -> int:
        return self.base.num_blocks

    @property
    def workers(self) -> List[int]:
        return self.base.workers


def make_tiered_indexer(impl: Optional[str] = None) -> TieredKvIndexer:
    from .indexer import make_indexer

    return TieredKvIndexer(make_indexer(impl))

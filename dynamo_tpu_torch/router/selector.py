"""Worker selection cost function.

A copy of dynamo_tpu/router/selector.py.

Ref: lib/kv-router/src/scheduling/selector.rs:100-265 (DefaultWorkerSelector)
and docs/design-docs/router-design.md:58-75.  Cost per worker:

    logit = overlap_weight * prefill_cost + decode_cost
    prefill_cost = blocks_to_compute + tier_priced_onboard_cost
    decode_cost  = potential_active_blocks                (load on the worker)

With the fleet prefix cache (router/tiered_index.py), an overlap run is no
longer uniformly free: each overlapped block is priced by its cheapest
source tier — G1 costs 0, G2/G3/G4 cost `tier_costs[t]` recompute-
equivalent blocks (onboard-bytes / tier bandwidth vs recompute-FLOPs /
chip rate, measured worker-side and published via load_metrics; capped at
1.0 because onboarding is never chosen when recompute is cheaper).  A
pure-G1 overlap reproduces the classic formula exactly.

Lower is better.  temperature == 0 picks argmin (deterministic); > 0 samples
from softmax(-logit / temperature), spreading hot prefixes across replicas.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from .tiered_index import DEFAULT_TIER_COSTS


@dataclass
class KvRouterConfig:
    overlap_score_weight: float = 1.0
    temperature: float = 0.0
    # workers above this KV utilization are deprioritized hard
    busy_kv_threshold: float = 0.95
    # tie-break / sampling RNG seed.  None (the default) seeds from OS
    # entropy so independent router replicas break cost ties DIFFERENTLY —
    # a shared constant seed would send every frontend's tied picks to the
    # same worker (thundering herd).  Set explicitly only in tests.
    seed: Optional[int] = None


@dataclass
class WorkerState:
    active_blocks: float = 0.0   # slot-manager estimate of decode load
    kv_usage: float = 0.0        # from load_metrics events
    kv_total_blocks: int = 0
    # per-tier onboard cost in recompute-equivalent blocks, published by
    # the worker from its roofline measurements (load_metrics
    # `kv_tier_costs`); defaults cover workers that have not measured yet
    tier_costs: Dict[str, float] = field(default_factory=dict)


def overlap_cost_blocks(tier_overlap: Dict[str, int],
                        tier_costs: Optional[Dict[str, float]] = None,
                        ) -> float:
    """Recompute-equivalent cost of sourcing an overlap run by tier."""
    cost = 0.0
    for t, blocks in tier_overlap.items():
        c = (tier_costs or {}).get(t)
        if c is None:
            c = DEFAULT_TIER_COSTS.get(t, 1.0)
        cost += blocks * min(1.0, max(0.0, c))
    return cost


class DefaultWorkerSelector:
    def __init__(self, config: Optional[KvRouterConfig] = None):
        self.config = config or KvRouterConfig()
        self._rng = random.Random(self.config.seed)

    def select(
        self,
        workers: Sequence[int],
        request_blocks: int,
        overlaps: Dict[int, int],
        states: Dict[int, "WorkerState"],
        avoid: Optional[set] = None,
        tier_overlaps: Optional[Dict[int, Dict[str, int]]] = None,
    ) -> Optional[int]:
        return self.select_verbose(workers, request_blocks, overlaps,
                                   states, avoid=avoid,
                                   tier_overlaps=tier_overlaps)[0]

    def select_verbose(
        self,
        workers: Sequence[int],
        request_blocks: int,
        overlaps: Dict[int, int],
        states: Dict[int, "WorkerState"],
        avoid: Optional[set] = None,
        tier_overlaps: Optional[Dict[int, Dict[str, int]]] = None,
    ) -> tuple:
        """(choice, logits): the pick plus every candidate's cost —
        what the router's decision attribution (kv_router.py) records
        on the forensics `routed` hop and scores regret against.  The
        pick itself is identical to select().

        `tier_overlaps` ({worker: {tier: blocks}}, from
        TieredKvIndexer.find_matches_tiered) supersedes `overlaps` for
        workers present in it: the run length is the tier sum and each
        block is priced at its source tier's cost."""
        cfg = self.config
        candidates = [w for w in workers if not avoid or w not in avoid]
        if not candidates:
            candidates = list(workers)
        if not candidates:
            return None, {}
        logits = {}
        for w in candidates:
            st = states.get(w) or WorkerState()
            by_tier = (tier_overlaps or {}).get(w)
            if by_tier is not None:
                overlap = sum(by_tier.values())
                onboard_cost = overlap_cost_blocks(by_tier, st.tier_costs)
            else:
                overlap = overlaps.get(w, 0)
                onboard_cost = 0.0
            prefill_cost = max(0, request_blocks - overlap) + onboard_cost
            decode_cost = st.active_blocks
            logit = cfg.overlap_score_weight * prefill_cost + decode_cost
            if st.kv_usage >= cfg.busy_kv_threshold:
                logit += 1e6  # effectively last resort
            logits[w] = logit

        if cfg.temperature <= 0.0:
            best = min(logits.values())
            ties = [w for w, l in logits.items() if l == best]
            return self._rng.choice(ties), logits
        # softmax over -logit/T
        mn = min(logits.values())
        weights = [
            math.exp(-(logits[w] - mn) / cfg.temperature) for w in candidates
        ]
        return self._rng.choices(candidates, weights=weights, k=1)[0], \
            logits

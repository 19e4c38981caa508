"""The per-tier onboard costs a worker advertises to the KV router.

Copies of dynamo_tpu/router/tiered_index.py `DEFAULT_TIER_COSTS`,
`DEFAULT_TIER_BW`, `compute_tier_costs` and `degraded_tier_costs`: the
worker's load loop prices onboarding a block from G2/G3/G4 against
recomputing it, from its measured prefill rate (planner/metrics.py
FpmWindow), and publishes the result as `kv_tier_costs` in
load_metrics, where the JAX KV router's tiered selector reads it.  The
tier-aware indexer itself stays the JAX frontend's.
"""

from __future__ import annotations

from typing import Dict, Optional

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

"""Pool classification policy, a copy of dynamo_tpu/global_router/policy.py.

Ref: the reference's global router routes on (ISL, predicted TTFT) for
prefill-bound work and (context length, ITL headroom) for decode-bound
work, with the conditional-disagg thresholds (eff-ISL >= 2048 AND
prefill ratio >= 0.7 — conditional_disagg.rs:11-18) deciding which
CLASS of pool a request wants before latency picks the pool within the
class:

    request class          preferred pool class   tie-break within class
    ---------------------  ---------------------  ----------------------
    long prompt, short     disagg (dedicated      lowest predicted TTFT
    completion (prefill-   prefill tier)          (per-token EWMA * ISL)
    bound)
    everything else        agg (no prefill hop    lowest inflight per
    (decode/ITL-bound)     to pay for)            frontend, then TTFT

A preferred class with no live pool falls back to the other class —
degraded placement beats a 503.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .pools import PoolView


@dataclass
class GlobalRouterConfig:
    # conditional-disagg thresholds (ref conditional_disagg.rs:11-18)
    disagg_min_isl: int = 2048
    disagg_ratio: float = 0.7
    # seconds of penalty per in-flight request per frontend: the ITL
    # proxy — a loaded pool predicts slower tokens even if its TTFT
    # history looks good
    load_penalty_s: float = 0.010
    # assumed completion length when the request doesn't say
    default_max_tokens: int = 256


@dataclass
class Decision:
    pool: str
    reason: str
    isl: int
    prefill_ratio: float
    scores: Dict[str, float] = field(default_factory=dict)

    def to_attrs(self) -> dict:
        return {"pool": self.pool, "pool_reason": self.reason,
                "pool_scores": self.scores}


class PoolClassifier:
    def __init__(self, config: GlobalRouterConfig = None):
        self.config = config or GlobalRouterConfig()

    def classify(self, pools: List[PoolView], isl: int,
                 max_tokens: int = 0) -> Decision:
        """Pick a pool for (isl, max_tokens) among pools that serve the
        model (caller pre-filters).  Raises ValueError on empty input."""
        if not pools:
            raise ValueError("no candidate pools")
        cfg = self.config
        osl = max_tokens or cfg.default_max_tokens
        ratio = isl / max(isl + osl, 1)
        prefill_bound = (isl >= cfg.disagg_min_isl
                         and ratio >= cfg.disagg_ratio)
        want = [p for p in pools if p.is_disagg == prefill_bound]
        fell_back = not want
        if fell_back:
            want = pools
        scores = {p.namespace: self._score(p, isl) for p in want}
        best = min(want, key=lambda p: scores[p.namespace])
        reason = ("disagg" if prefill_bound else "agg") + (
            "_fallback" if fell_back else "")
        if len(pools) == 1:
            reason = "only_pool"
        return Decision(pool=best.namespace, reason=reason, isl=isl,
                        prefill_ratio=round(ratio, 3),
                        scores={k: round(v, 6)
                                for k, v in scores.items()})

    def _score(self, pool: PoolView, isl: int) -> float:
        """Predicted time-to-first-token if routed to `pool` now: the
        TTFT EWMA model plus a load penalty per in-flight request per
        frontend (the ITL-headroom proxy)."""
        ttft = pool.predict_ttft(isl) or 0.0
        per_fe = pool.inflight / max(len(pool.frontends), 1)
        return ttft + self.config.load_penalty_s * per_fe


def estimate_isl(body: dict) -> int:
    """Token-count estimate from an OpenAI request body: exact for
    token-list prompts, ~4 chars/token for text (matches the byte
    tokenizer's block math closely enough for threshold routing)."""
    prompt = body.get("prompt")
    if isinstance(prompt, list):
        return len(prompt)
    if isinstance(prompt, str):
        return max(len(prompt) // 4, 1)
    total = 0
    for m in body.get("messages", ()) or ():
        c = m.get("content")
        if isinstance(c, str):
            total += len(c)
    return max(total // 4, 1)

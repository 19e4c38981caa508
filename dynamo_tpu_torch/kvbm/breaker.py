"""Per-tier circuit breakers for the KV cache fabric, a copy of
dynamo_tpu/kvbm/breaker.py.

A cache tier can only ever make serving *faster*, never *stuck*.  The
ObjectIO thread (object_io.py) bounds each G4 op with a deadline; this
module bounds the *sequence*: consecutive failures (timeouts, I/O
errors) trip the tier's breaker open, after which the manager stops
running ops against it and admission recomputes instead of onboarding.
After a cooldown the breaker half-opens and admits exactly ONE probe op;
its outcome re-closes or re-opens the breaker.

Checksum failures deliberately do NOT feed the breaker: a corrupt blob
means the *data* is bad (quarantine it, fleet-wide), not that the tier
is unreachable.

States encode as NUMERIC (0=closed, 1=half_open, 2=open) for the
`dynamo_kvbm_tier_state{tier}` gauge.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Sequence

logger = logging.getLogger(__name__)

STATES = ("closed", "half_open", "open")

# gauge encoding for dynamo_kvbm_tier_state{tier}
NUMERIC = {"closed": 0, "half_open": 1, "open": 2}


class TierBreaker:
    """Thread-safe (scheduler thread + I/O thread + event loop all
    consult it) per-tier breaker with half-open single-probe re-entry."""

    def __init__(self, tiers: Sequence[str] = ("g3", "g4"),
                 threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._st: Dict[str, dict] = {
            t: {"state": "closed", "fails": 0, "opened_t": 0.0,
                "probing": False, "trips": 0}
            for t in tiers
        }

    def allow(self, tier: str) -> bool:
        """May one op run against `tier` right now?  In half-open
        this CONSUMES the single probe slot — callers that only want to
        look (sweeps, debug) use state() instead."""
        st = self._st.get(tier)
        if st is None:
            return True  # untracked tier: breaker does not apply
        with self._lock:
            if st["state"] == "closed":
                return True
            now = self._clock()
            if (st["state"] == "open"
                    and now - st["opened_t"] >= self.cooldown_s):
                st["state"] = "half_open"
                st["probing"] = False
                logger.info("KV tier %s breaker half-open (probing)", tier)
            if st["state"] == "half_open" and not st["probing"]:
                st["probing"] = True  # exactly one probe in flight
                return True
            return False

    def record_ok(self, tier: str) -> None:
        st = self._st.get(tier)
        if st is None:
            return
        with self._lock:
            if st["state"] != "closed":
                logger.info("KV tier %s breaker closed (probe ok)", tier)
            st["state"] = "closed"
            st["fails"] = 0
            st["probing"] = False

    def record_failure(self, tier: str) -> None:
        st = self._st.get(tier)
        if st is None:
            return
        with self._lock:
            st["fails"] += 1
            st["probing"] = False
            if (st["state"] == "half_open"
                    or st["fails"] >= self.threshold):
                if st["state"] != "open":
                    st["trips"] += 1
                    logger.warning(
                        "KV tier %s breaker OPEN after %d consecutive "
                        "failures; pricing recompute for %.0fs",
                        tier, st["fails"], self.cooldown_s)
                st["state"] = "open"
                st["opened_t"] = self._clock()

    def state(self, tier: str) -> str:
        """Non-consuming read (never claims the half-open probe slot)."""
        st = self._st.get(tier)
        if st is None:
            return "closed"
        with self._lock:
            if (st["state"] == "open"
                    and self._clock() - st["opened_t"] >= self.cooldown_s):
                return "half_open"
            return st["state"]

    def states(self) -> Dict[str, str]:
        return {t: self.state(t) for t in self._st}

    def trips(self, tier: str) -> int:
        st = self._st.get(tier)
        return int(st["trips"]) if st is not None else 0

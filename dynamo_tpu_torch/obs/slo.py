"""Request SLO plane: per-request latency histograms, goodput, burn rate.

A copy of dynamo_tpu/obs/slo.py: the port's frontend holds a plane, and
the worker (engine/worker.py _slo_loop) reads its summaries on
``slo_metrics.{namespace}`` as it reads a JAX frontend's.

The span tracer (obs/__init__.py) decomposes *where* time goes; this
module answers *whether the users got what they were promised*.
Per-request JSONL ``request_end`` records (frontend/request_trace.py)
alone aggregate nothing onto ``/metrics``, so a TTFT claim or an SLA
planner loop would have no live observation surface.  The SloPlane is
that surface:

  * **Per-request histograms**, fed from ``RequestTracker.finish`` (the
    one funnel every terminal path already goes through — clean finish,
    client abort, drain-abort, dispatch failure):
    ``dynamo_frontend_ttft_seconds``, ``dynamo_frontend_e2e_seconds``,
    ``dynamo_frontend_queue_seconds`` (received → first worker
    dispatch: preprocessing + routing + admission wait).  Per-token ITL
    stays on the richer delta-stream probe
    (``dynamo_frontend_itl_seconds``, frontend/service.py).

  * **Terminal outcomes.**  Every request ends exactly once as
    ``ok`` | ``error`` | ``no_first_token`` (errored before ANY token:
    dispatch fail, drain reject, preprocess/encode failure).  The e2e
    histogram and the finished counter are labeled by outcome, so
    no-first-token requests count in every denominator WITHOUT
    polluting the TTFT histogram — a dispatch-failed request has no
    TTFT, but pretending it didn't happen would inflate goodput
    exactly when the fleet is dropping load.

  * **Goodput + multi-window burn rate**, driven by the configured
    targets (``--slo-ttft-ms`` / ``--slo-itl-ms``): a request is *good*
    iff it finished ok AND met every configured target (per-request avg
    ITL; a request with ≤1 token has no ITL and passes that check).
    ``dynamo_frontend_slo_goodput`` is the good fraction over the
    shortest window; ``dynamo_frontend_slo_burn_rate{window}`` is the
    SRE burn rate per window — bad-fraction over the error budget
    ``1 - objective`` — so 1.0 means "burning budget exactly at the
    allowed rate", >>1 means a fast burn (page), and the multi-window
    pattern separates a blip from a sustained breach.

  * **Planner feed.**  ``publish()`` pushes the rolling summary onto
    the event plane (``slo_metrics.{namespace}``); the planner's
    SloObserver folds it into every SLA tick diag (planner/metrics.py)
    — the breach signal an SLA controller actuates on, measured at
    the client edge where SLOs are actually defined.

Model-agnostic by construction: the mocker fleet behind the same
frontend exports identical metric names, so the whole plane is tier-1
testable CPU-only.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

SLO_SUBJECT_PREFIX = "slo_metrics"

# terminal outcomes (request_trace.py stamps them on the record too)
OUTCOME_OK = "ok"
OUTCOME_ERROR = "error"                    # errored after ≥1 token
OUTCOME_NO_FIRST_TOKEN = "no_first_token"  # errored before any token

def breach_reason(config, record: dict) -> Optional[str]:
    """Why one request_end record breached, or None when it was good.

    THE shared breach predicate: SloPlane's per-reason counters and the
    forensics plane's breach retention (obs/forensics.py) must agree on
    what a breach is, so both call this.  A non-ok outcome is always a
    breach reason (even with no latency targets configured — an errored
    request is a tail event worth pinning); with targets set, a missed
    TTFT/ITL target breaches with that target's name.  A request with
    ≤1 token has no ITL and passes that check (the goodput convention
    above)."""
    req = record.get("request", {})
    outcome = req.get("outcome", OUTCOME_OK)
    if outcome != OUTCOME_OK:
        return outcome
    if config is None or not config.targets_set:
        return None
    ttft_ms = req.get("ttft_ms")
    if config.ttft_ms is not None and (ttft_ms is None
                                       or ttft_ms > config.ttft_ms):
        return "ttft"
    itl_ms = req.get("avg_itl_ms")
    if config.itl_ms is not None and itl_ms is not None \
            and itl_ms > config.itl_ms:
        return "itl"
    return None


_E2E_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0, 120.0, 300.0)
_QUEUE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
_TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


@dataclass
class SloConfig:
    """Targets + windows.  Both targets None = histograms/outcomes only
    (always on); any target set = goodput/burn gauges light up."""

    ttft_ms: Optional[float] = None
    itl_ms: Optional[float] = None
    # SLO objective: the promised good-request fraction the error
    # budget derives from (burn rate 1.0 = burning exactly the budget)
    objective: float = 0.99
    # rolling windows, seconds, shortest first: goodput reads over the
    # shortest; burn rate is exported per window (multi-window burn —
    # short catches a fast burn, long confirms it is sustained)
    windows_s: Tuple[float, ...] = (60.0, 300.0, 1800.0)
    publish_interval_s: float = 1.0

    @property
    def targets_set(self) -> bool:
        return self.ttft_ms is not None or self.itl_ms is not None


class SloPlane:
    """Owns the frontend's request-level latency/SLO metric surface."""

    def __init__(self, metrics, config: Optional[SloConfig] = None,
                 frontend_id: Optional[int] = None):
        self.m = metrics
        self.config = config or SloConfig()
        import secrets

        self.frontend_id = frontend_id or secrets.randbits(48)
        # (finish_t, breach_reason-or-None) per finished request, pruned
        # to the longest window; bounded hard so a breach storm can't
        # grow unchecked.  Carrying the REASON (not just good/bad) is
        # what lets burn attribute by phase: a TTFT burn means the
        # prefill side is behind, an ITL burn the decode side — the
        # planner's burn actuation scales the matching pool
        # (planner/planner.py, the disagg P/D-ratio control input)
        self._finished: Deque[Tuple[float, Optional[str]]] = \
            deque(maxlen=65536)
        self._last_refresh_t = 0.0
        # one window scan serves refresh()+summary()+scrapes within its
        # TTL: the deque can hold 65536 entries and goodput()/
        # burn_rates() would otherwise each rescan it per caller
        self._counts_cache: Tuple[float, Optional[dict]] = (0.0, None)
        m = metrics
        m.histogram("dynamo_frontend_ttft_seconds",
                    "time to first streamed token", ("model",),
                    buckets=_TTFT_BUCKETS)
        m.histogram("dynamo_frontend_e2e_seconds",
                    "request end-to-end latency by terminal outcome",
                    ("model", "outcome"), buckets=_E2E_BUCKETS)
        m.histogram("dynamo_frontend_queue_seconds",
                    "request received to first worker dispatch "
                    "(preprocessing + routing + admission wait)",
                    ("model",), buckets=_QUEUE_BUCKETS)
        if self.config.targets_set:
            m.gauge("dynamo_frontend_slo_goodput",
                    "fraction of requests meeting every configured SLO "
                    "target over the shortest window")
            m.gauge("dynamo_frontend_slo_burn_rate",
                    "error-budget burn rate per rolling window "
                    "(1.0 = burning exactly the allowed budget)",
                    ("window",))

    # -- per-request ingestion (RequestTracker.finish calls this) ---------
    def observe_finish(self, tracker, record: dict) -> None:
        """Fold one finished request in.  Exceptions are swallowed with
        a log line — the SLO plane must never take down serving."""
        try:
            self._observe(tracker, record)
        except Exception:
            logger.warning("slo observation failed", exc_info=True)

    def _observe(self, tracker, record: dict) -> None:
        c = self.config
        req = record.get("request", {})
        model = tracker.model
        outcome = req.get("outcome", OUTCOME_OK)
        total_ms = float(req.get("total_time_ms", 0.0))
        ttft_ms = req.get("ttft_ms")
        itl_ms = req.get("avg_itl_ms")
        self.m.observe("dynamo_frontend_e2e_seconds", total_ms / 1000.0,
                       model=model, outcome=outcome)
        self.m.inc("dynamo_frontend_requests_finished_total",
                   model=model, outcome=outcome)
        if ttft_ms is not None:
            # only requests that produced a first token: dispatch-fail /
            # drain-reject requests have no TTFT and must not smuggle a
            # 0 or a sentinel into the latency distribution
            self.m.observe("dynamo_frontend_ttft_seconds",
                           ttft_ms / 1000.0, model=model)
        if req.get("queue_ms") is not None:
            self.m.observe("dynamo_frontend_queue_seconds",
                           float(req["queue_ms"]) / 1000.0, model=model)
        if not c.targets_set:
            return
        reason = breach_reason(c, record)
        good = reason is None
        if not good:
            self.m.inc("dynamo_frontend_slo_breach_total",
                       model=model, reason=reason)
        now = time.monotonic()
        self._finished.append((now, reason))
        self._counts_cache = (0.0, None)  # new data: cached scan stale
        # gauge refresh walks the rolling deque (up to its 65536 cap):
        # throttle the per-finish path so a busy frontend doesn't pay an
        # O(window) scan per completed request — scrapes and the publish
        # loop still refresh unconditionally
        if now - self._last_refresh_t >= 0.25:
            self.refresh()

    # -- rolling windows --------------------------------------------------
    _COUNTS_TTL_S = 0.2

    def _window_counts(
            self, now: float) -> Dict[float, Tuple[int, int, Dict[str, int]]]:
        """{window_s: (total, good, breaches-by-reason)} over the
        rolling deque — one full scan, cached briefly so
        refresh/summary/scrape callers within the same beat share it
        instead of each rescanning up to 65536 entries on the event
        loop."""
        cached_t, cached = self._counts_cache
        if cached is not None and 0.0 <= now - cached_t < self._COUNTS_TTL_S:
            return cached
        c = self.config
        longest = max(c.windows_s)
        while self._finished and now - self._finished[0][0] > longest:
            self._finished.popleft()
        out = {w: [0, 0, {}] for w in c.windows_s}
        for t, reason in self._finished:
            age = now - t
            for w in c.windows_s:
                if age <= w:
                    out[w][0] += 1
                    if reason is None:
                        out[w][1] += 1
                    else:
                        out[w][2][reason] = out[w][2].get(reason, 0) + 1
        counts = {w: (tot, good, dict(reasons))
                  for w, (tot, good, reasons) in out.items()}
        self._counts_cache = (now, counts)
        return counts

    def goodput(self, now: Optional[float] = None) -> Optional[float]:
        """Good fraction over the shortest window; None when idle."""
        if not self.config.targets_set:
            return None
        counts = self._window_counts(now or time.monotonic())
        tot, good, _ = counts[min(self.config.windows_s)]
        return good / tot if tot else None

    def burn_rates(self, now: Optional[float] = None) -> Dict[float, float]:
        """{window_s: burn rate} — bad fraction over the error budget."""
        c = self.config
        budget = max(1.0 - c.objective, 1e-6)
        out: Dict[float, float] = {}
        for w, (tot, good, _) in self._window_counts(
                now or time.monotonic()).items():
            if tot:
                out[w] = ((tot - good) / tot) / budget
        return out

    def burn_by_phase(self, now: Optional[float] = None) -> Dict[str, float]:
        """{breach reason: worst burn rate across windows} — the burn
        split the planner's phase-attributed actuation consumes: a
        ``ttft`` burn says the prefill pool is behind, an ``itl`` burn
        the decode pool (``error``/``no_first_token`` count too — an
        errored request burns budget regardless of phase).  Empty when
        nothing breached in any window."""
        c = self.config
        budget = max(1.0 - c.objective, 1e-6)
        out: Dict[str, float] = {}
        for _w, (tot, _good, reasons) in self._window_counts(
                now or time.monotonic()).items():
            if not tot:
                continue
            for reason, n in reasons.items():
                burn = (n / tot) / budget
                if burn > out.get(reason, 0.0):
                    out[reason] = burn
        return out

    def refresh(self) -> None:
        """Recompute the goodput/burn gauges from the rolling windows —
        called after finishes (throttled) AND on each /metrics scrape,
        so an idle frontend's gauges age out breaches instead of
        freezing on the last bad minute.  Empty windows report the
        no-breach values (goodput 1.0, burn 0.0): a breach that aged
        out must stop alerting, and `requests_finished_total` already
        distinguishes idle from healthy."""
        if not self.config.targets_set:
            return
        now = time.monotonic()
        self._last_refresh_t = now
        g = self.goodput(now)
        self.m.set("dynamo_frontend_slo_goodput",
                   1.0 if g is None else g)
        burns = self.burn_rates(now)
        for w in self.config.windows_s:
            self.m.set("dynamo_frontend_slo_burn_rate",
                       burns.get(w, 0.0), window=f"{int(w)}s")

    # -- planner feed -----------------------------------------------------
    def summary(self) -> dict:
        now = time.monotonic()
        counts = self._window_counts(now)
        tot, _good, _reasons = counts[min(self.config.windows_s)]
        g = self.goodput(now)
        return {
            "frontend_id": self.frontend_id,
            "goodput": 1.0 if g is None else g,
            "burn": {f"{int(w)}s": round(r, 4)
                     for w, r in self.burn_rates(now).items()},
            "burn_by_phase": {k: round(v, 4)
                              for k, v in self.burn_by_phase(now).items()},
            "requests": tot,
            "ttft_ms": self.config.ttft_ms,
            "itl_ms": self.config.itl_ms,
            "objective": self.config.objective,
        }

    async def publish(self, runtime, namespaces) -> None:
        """One summary push per served namespace onto the event plane —
        what the planner's SloObserver aggregates into tick diag."""
        payload = self.summary()
        for ns in namespaces:
            try:
                await runtime.event_plane.publish(
                    f"{SLO_SUBJECT_PREFIX}.{ns}", payload)
            except Exception:
                logger.warning("slo publish to %r failed", ns,
                               exc_info=True)

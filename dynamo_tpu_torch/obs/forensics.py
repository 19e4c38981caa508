"""Tail-latency forensics plane: always-on per-request hop timelines,
tail-exemplar retention, and the autopsy partition.

The SLO plane (obs/slo.py) says *that* p95 TTFT breached; the tracing
plane (obs/__init__.py) needs ``DYN_TRACE=1`` and only keeps a ring of
recent spans — by the time anyone looks, the tail request's timeline is
gone.  This module is the qualitative complement: every request carries
an ordered **hop timeline** (frontend/request_trace.py RequestTracker),
and this plane retains the exemplars worth autopsying:

  * **Hop taxonomy** (``HOP_KINDS`` — the DYN012 lint checks every
    ``tracker.hop(...)`` literal against it, the DYN006 pattern):

      received       tracker created (t=0 of the timeline)
      routed         router decision made; attrs carry the chosen
                     worker, per-candidate cost scores, predicted
                     overlap blocks, best rejected candidate, regret
      dispatched     one dispatch attempt opened (attempt n; every
                     attempt after the first is a migration — a
                     drain-abort/worker-death replay appends a second
                     dispatched hop to the SAME record)
      prefill_open   remote-prefill hop began (disagg)
      prefill_done   remote prefill returned (disagg)
      worker_stamp   worker-side facts stamped back via the stream
                     (realized prefix reuse, queue position at
                     admission, step counts) — attrs, not a boundary
      first_token    first token reached the frontend
      decode_stall   a token gap exceeded the stall threshold; attrs
                     carry the gap duration (coarse: capped count,
                     exact total in ``stall_ms``)
      finish         terminal outcome (implicit boundary: the record's
                     total_time_ms)

  * **Exact phase partition** (``phase_partition``): each exemplar's
    e2e decomposes into ``queue / route / prefill / transfer / decode /
    stall`` by telescoping over the boundary hops, so the six phases
    sum to the e2e *exactly* (tested to 1%) — no span recording or
    sampling involved, which is what makes the plane always-on.

  * **Tail-exemplar reservoir** (``ForensicsPlane``): per (model,
    wall-clock window) keep the slowest-K complete timelines by TTFT
    and by mean ITL, plus EVERY SLO breach (bounded); breaches
    additionally pin the correlated flight-recorder span snapshot by
    trace_id while ``DYN_TRACE=1`` — the ring's contents for that
    request survive past the ring.

  * **Serving**: ``dump()`` (schema ``dynamo.forensics.v1``) backs the
    token-gated ``/debug/requests`` route (runtime/system_status.py).

A copy of dynamo_tpu/obs/forensics.py: the port's HttpService keeps the
plane by default and registers its dump as the `frontend:{id}` source
of `/debug/requests`, as the JAX frontend does.

Env vocabulary (the request-trace config style)::

    DYN_FORENSICS=0          disable the plane (default: ON)
    DYN_FORENSICS_K=8        exemplars kept per (model, window, rank)
    DYN_FORENSICS_WINDOW_S=600
    DYN_STALL_THRESHOLD_S=0.25   decode-stall hop threshold
"""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

SCHEMA = "dynamo.forensics.v1"

# THE canonical hop taxonomy (the docstring table above): every
# RequestTracker.hop() call site names one of these (hop() raises on any
# other), so a typo'd hop cannot produce an orphan timeline row the
# partition and the autopsy never join on.  Extend this set and the
# docstring table together when adding a kind.
HOP_KINDS = frozenset({
    "received",
    "routed",
    "dispatched",
    "prefill_open",
    "prefill_done",
    "worker_stamp",
    "first_token",
    "decode_stall",
    "finish",
})

# the partition vocabulary, in render order
PHASES = ("queue", "route", "prefill", "transfer", "decode", "stall")

# hop kinds that act as phase BOUNDARIES in the partition sweep
# (worker_stamp/decode_stall/finish carry attrs, not boundaries)
_BOUNDARY_KINDS = ("routed", "dispatched", "prefill_open", "prefill_done",
                   "first_token")

DEFAULT_K = 8
DEFAULT_WINDOW_S = 600.0
MAX_WINDOWS = 2          # current + previous
BREACH_CAP = 64          # breach exemplars retained per (model, window)
PIN_SPANS = 64           # flight-recorder spans pinned per breach


def forensics_enabled() -> bool:
    """Plane on by default; DYN_FORENSICS=0 turns it off (the bench
    A/B smoke proves token streams are byte-identical either way)."""
    return os.environ.get("DYN_FORENSICS", "1").lower() not in (
        "0", "false", "no", "off")


def stall_threshold_s() -> float:
    try:
        return float(os.environ.get("DYN_STALL_THRESHOLD_S", "0.25"))
    except ValueError:
        return 0.25


# ---------------------------------------------------------------------------
# exact phase partition
# ---------------------------------------------------------------------------


def phase_partition(hops: List[dict], total_ms: float,
                    stall_ms: float = 0.0) -> Dict[str, float]:
    """Partition ``[0, total_ms]`` into PHASES *exactly* (telescoping
    over boundary hops, so the six values sum to total_ms by
    construction, modulo float rounding):

      received→routed          route   (preprocess + routing decision)
      routed→dispatched        queue   (admission / dispatch wait)
      received→prefill_open    queue   (disagg: the hop IS the first
                                        dispatch, so the wait before it
                                        is admission)
      prefill_open→prefill_done prefill (the remote prefill itself)
      dispatched→first_token   prefill (local path: worker queue +
                                        prefill compute) or transfer
                                        (disagg: KV pull + first decode)
      first_token→finish       decode, with the accumulated stall time
                               carved out as stall

    Only the FIRST occurrence of each boundary kind partitions (a
    migration's second dispatched hop restarts nothing — its wait is
    part of the decode/stall story the stall hops already tell)."""
    t: Dict[str, float] = {}
    for h in hops:
        k = h.get("hop")
        if k in _BOUNDARY_KINDS and k not in t:
            t[k] = float(h.get("t_ms", 0.0))
    out = {p: 0.0 for p in PHASES}
    prev = 0.0
    disagg = False        # a remote prefill completed
    dispatched = False
    for tv, k in sorted((v, k) for k, v in t.items()):
        seg = tv - prev
        if seg > 0.0:
            if k == "routed":
                out["route"] += seg
            elif k in ("dispatched", "prefill_open"):
                out["queue"] += seg
            elif k == "prefill_done":
                out["prefill"] += seg
            elif k == "first_token":
                out["transfer" if disagg
                    else ("prefill" if dispatched else "queue")] += seg
            prev = tv
        if k == "prefill_done":
            disagg = True
        elif k in ("dispatched", "prefill_open"):
            dispatched = True
    tail = total_ms - prev
    if tail > 0.0:
        if "first_token" in t:
            st = min(max(stall_ms, 0.0), tail)
            out["stall"] += st
            out["decode"] += tail - st
        else:
            # never produced a token: the terminal interval belongs to
            # whatever phase the request died in
            out["transfer" if disagg
                else ("prefill" if dispatched else "queue")] += tail
    return out


# ---------------------------------------------------------------------------
# exemplars + reservoir
# ---------------------------------------------------------------------------


@dataclass
class TailExemplar:
    """One retained request: the full request_end record (which carries
    the timeline), its partition, and — for breaches — the pinned span
    snapshot."""

    request_id: str
    model: str
    ts_unix: float
    outcome: str
    e2e_ms: float
    ttft_ms: Optional[float] = None
    avg_itl_ms: Optional[float] = None
    breach: Optional[str] = None
    partition: Dict[str, float] = field(default_factory=dict)
    record: Dict[str, Any] = field(default_factory=dict)
    spans: Optional[List[dict]] = None

    def to_dict(self) -> dict:
        d = {
            "request_id": self.request_id,
            "model": self.model,
            "ts_unix": round(self.ts_unix, 3),
            "outcome": self.outcome,
            "e2e_ms": round(self.e2e_ms, 3),
            "partition": {p: round(v, 3)
                          for p, v in self.partition.items()},
            "record": self.record,
        }
        if self.ttft_ms is not None:
            d["ttft_ms"] = round(self.ttft_ms, 3)
        if self.avg_itl_ms is not None:
            d["avg_itl_ms"] = round(self.avg_itl_ms, 3)
        if self.breach is not None:
            d["breach"] = self.breach
        if self.spans is not None:
            d["spans"] = self.spans
        return d


def _pin_spans(trace_id: Optional[str], limit: int = PIN_SPANS
               ) -> Optional[List[dict]]:
    """Snapshot the flight-recorder ring's spans for one trace_id —
    how a breach's timeline survives the ring's churn.  None when
    tracing is off or the request carries no trace_id."""
    if trace_id is None:
        return None
    from .. import obs

    tr = obs.tracer()
    if tr is None:
        return None
    with tr._lock:
        ring = list(tr.spans)
    now = time.monotonic()
    out = []
    for kind, t0, t1, track, attrs, tid in ring:
        if tid != trace_id:
            continue
        out.append({
            "kind": kind, "age_s": round(now - t1, 4),
            "dur_ms": round((t1 - t0) * 1e3, 3), "track": track,
            **({"attrs": attrs} if attrs else {}),
        })
    return out[-limit:]


class ForensicsPlane:
    """Tail-exemplar reservoir: per (model, wall-clock window) keep the
    slowest-K timelines by TTFT and by mean ITL, plus every breach.

    Fed from ``RequestTracker.finish`` (the one funnel every terminal
    path goes through), exactly like the SLO plane; exceptions are
    swallowed with a log line — forensics must never take down serving.
    Retention work is O(K) per finish (one ranked insert per
    criterion), which is what keeps the plane always-on."""

    def __init__(self, metrics=None, slo_config=None,
                 k: Optional[int] = None,
                 window_s: Optional[float] = None,
                 max_windows: int = MAX_WINDOWS,
                 breach_cap: int = BREACH_CAP):
        self.m = metrics
        self.slo_config = slo_config
        if k is None:
            try:
                k = int(os.environ.get("DYN_FORENSICS_K", str(DEFAULT_K)))
            except ValueError:
                k = DEFAULT_K
        if window_s is None:
            try:
                window_s = float(os.environ.get("DYN_FORENSICS_WINDOW_S",
                                                str(DEFAULT_WINDOW_S)))
            except ValueError:
                window_s = DEFAULT_WINDOW_S
        self.k = max(1, k)
        self.window_s = max(0.01, window_s)
        self.max_windows = max(1, max_windows)
        self.breach_cap = breach_cap
        # window_idx -> model -> {"ttft": [exemplars desc], "itl": [...],
        #                         "breach": deque}
        self._windows: "OrderedDict[int, Dict[str, dict]]" = OrderedDict()
        # predicted-vs-realized overlap accounting across finishes (the
        # router's own gauges are per-decision; this is the per-REQUEST
        # realized-reuse rate the bench tail block reports)
        self._realized_tokens = 0
        self._input_tokens = 0
        self._stamped = 0
        self._finished = 0
        if metrics is not None:
            metrics.gauge(
                "dynamo_frontend_realized_overlap_ratio",
                "worker-realized prefix-cache reuse over input tokens, "
                "across requests that stamped forensics back")

    # -- ingestion (RequestTracker.finish calls this) ---------------------
    def observe_finish(self, tracker, record: dict) -> None:
        try:
            self._observe(tracker, record)
        except Exception:
            logger.warning("forensics observation failed", exc_info=True)

    def _observe(self, tracker, record: dict) -> None:
        from .slo import breach_reason

        req = record.get("request", {})
        timeline = record.get("timeline") or {}
        model = req.get("model", "")
        total_ms = float(req.get("total_time_ms", 0.0))
        partition = timeline.get("partition") or phase_partition(
            timeline.get("hops") or [], total_ms,
            float(timeline.get("stall_ms", 0.0)))
        breach = breach_reason(self.slo_config, record)
        ex = TailExemplar(
            request_id=req.get("request_id", ""),
            model=model,
            ts_unix=time.time(),
            outcome=req.get("outcome", "ok"),
            e2e_ms=total_ms,
            ttft_ms=req.get("ttft_ms"),
            avg_itl_ms=req.get("avg_itl_ms"),
            breach=breach,
            partition=partition,
            record=record,
        )
        self._finished += 1
        stamp = timeline.get("worker")
        if stamp is not None:
            self._stamped += 1
            self._realized_tokens += int(stamp.get("cached_tokens") or 0)
            self._input_tokens += int(req.get("input_tokens") or 0)
            if self.m is not None and self._input_tokens:
                self.m.set("dynamo_frontend_realized_overlap_ratio",
                           self._realized_tokens / self._input_tokens)
        widx = int(ex.ts_unix // self.window_s)
        w = self._windows.setdefault(widx, {})
        while len(self._windows) > self.max_windows:
            self._windows.popitem(last=False)  # oldest window evicted first
        per = w.setdefault(model, {
            "ttft": [], "itl": [], "breach": deque(maxlen=self.breach_cap),
        })
        if breach is not None:
            # every breach is retained (bounded), and pins its span
            # snapshot NOW — the ring will have churned past this
            # request by the time anyone reads the dump
            ex.spans = _pin_spans(getattr(tracker, "trace_id", None))
            per["breach"].append(ex)
            if self.m is not None:
                self.m.inc("dynamo_frontend_forensics_retained_total",
                           kind="breach")
        for rank_key, metric in (("ttft", ex.ttft_ms),
                                 ("itl", ex.avg_itl_ms)):
            if metric is None:
                continue
            self._rank_insert(per[rank_key], rank_key, ex, metric)

    def _rank_insert(self, ranked: List[TailExemplar], rank_key: str,
                     ex: TailExemplar, metric: float) -> None:
        """Keep the K SLOWEST, descending: a full list evicts its
        fastest (last) entry — the eviction order the tests pin."""
        key = {"ttft": lambda e: e.ttft_ms or 0.0,
               "itl": lambda e: e.avg_itl_ms or 0.0}[rank_key]
        if len(ranked) >= self.k and metric <= key(ranked[-1]):
            return
        ranked.append(ex)
        ranked.sort(key=key, reverse=True)
        while len(ranked) > self.k:
            ranked.pop()  # fastest exemplar falls off
        if self.m is not None:
            self.m.inc("dynamo_frontend_forensics_retained_total",
                       kind=rank_key)

    # -- read side --------------------------------------------------------
    def realized_overlap(self) -> dict:
        return {
            "requests": self._finished,
            "stamped": self._stamped,
            "realized_tokens": self._realized_tokens,
            "input_tokens": self._input_tokens,
            "ratio": (round(self._realized_tokens / self._input_tokens, 4)
                      if self._input_tokens else None),
        }

    def worst(self, rank_key: str = "ttft",
              model: Optional[str] = None) -> Optional[TailExemplar]:
        """The single slowest retained exemplar by `rank_key` across
        windows (the bench tail block's p99 stand-in: the reservoir
        already IS the tail)."""
        key = {"ttft": lambda e: e.ttft_ms or 0.0,
               "itl": lambda e: e.avg_itl_ms or 0.0}[rank_key]
        best: Optional[TailExemplar] = None
        for w in self._windows.values():
            for m, per in w.items():
                if model is not None and m != model:
                    continue
                for ex in per[rank_key][:1]:
                    if best is None or key(ex) > key(best):
                        best = ex
        return best

    @staticmethod
    def _distinct(per: dict) -> int:
        """Distinct retained requests in one (model, window) bucket —
        the same exemplar commonly sits in both ranked lists (and the
        breach deque), and the count must agree with the tail
        autopsy's request_id dedupe, not double-count."""
        return len({e.request_id
                    for key in ("ttft", "itl", "breach")
                    for e in per[key]})

    def counts(self) -> dict:
        """Cheap retained-exemplar counts (the /debug/state tail line —
        the full payload lives on /debug/requests)."""
        n_ex = n_breach = 0
        for w in self._windows.values():
            for per in w.values():
                n_ex += self._distinct(per)
                n_breach += len(per["breach"])
        return {"exemplars": n_ex, "breaches": n_breach}

    def dump(self) -> dict:
        """The /debug/requests payload (schema dynamo.forensics.v1)."""
        models: Dict[str, list] = {}
        n_ex = n_breach = 0
        for widx, w in self._windows.items():
            for model, per in w.items():
                n_ex += self._distinct(per)
                n_breach += len(per["breach"])
                models.setdefault(model, []).append({
                    "window": widx,
                    "window_start_unix": widx * self.window_s,
                    "ttft": [e.to_dict() for e in per["ttft"]],
                    "itl": [e.to_dict() for e in per["itl"]],
                    "breach": [e.to_dict() for e in per["breach"]],
                })
        return {
            "schema": SCHEMA,
            "ts_unix": round(time.time(), 3),
            "window_s": self.window_s,
            "k": self.k,
            "exemplars": n_ex,
            "breaches": n_breach,
            "realized_overlap": self.realized_overlap(),
            "models": models,
        }


__all__ = [
    "HOP_KINDS",
    "PHASES",
    "SCHEMA",
    "ForensicsPlane",
    "TailExemplar",
    "forensics_enabled",
    "phase_partition",
    "stall_threshold_s",
]

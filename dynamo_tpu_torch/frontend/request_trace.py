"""Per-request trace records: who served it, how fast, and why it ended.

A copy of dynamo_tpu/frontend/request_trace.py: the same
`dynamo.request.trace.v1` records and hop timelines, and the same feed
of the tail-exemplar reservoir (obs/forensics.py ForensicsPlane).

Ref: lib/llm/src/request_trace/{types.rs,record.rs,sink.rs,config.rs} —
one `request_end` record per request in a stable JSONL schema
(`dynamo.request.trace.v1`), so a latency or routing regression can be
diagnosed per-request after the fact, not just from aggregate histograms.

Differences from the reference, by design:
- Sinks are file-JSONL and the structured logger (runtime/logging.py);
  the OTEL exporter is out of scope (zero-egress environment), but the
  W3C `traceparent` header is parsed and propagated so records join an
  external trace by trace_id.
- Payload capture (full request/response bodies) is omitted: records are
  metadata, never content — matching the reference's stated intent for
  finish metadata (types.rs: "traces remain metadata, not payload logs").

Config (ref config.rs env vocabulary):
    DYN_REQUEST_TRACE=1                 enable
    DYN_REQUEST_TRACE_FILE_PATH=...     JSONL sink (default when enabled:
                                        ./request_trace.jsonl)
    DYN_REQUEST_TRACE_SINKS=file,log    sink selection
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

SCHEMA = "dynamo.request.trace.v1"
X_REQUEST_ID_HEADER = "x-request-id"
TRACEPARENT_HEADER = "traceparent"
# stamped by the global router (global_router/service.py) on forward, so
# tail autopsies and request_end records name the pool that served it
X_POOL_HEADER = "x-dyn-pool"


# --------------------------- config / sinks ---------------------------------


@dataclass
class TraceConfig:
    enabled: bool = False
    sinks: tuple = ("file",)
    file_path: str = "request_trace.jsonl"

    @staticmethod
    def from_env() -> "TraceConfig":
        enabled = os.environ.get("DYN_REQUEST_TRACE", "").lower() in (
            "1", "true", "yes", "on")
        sinks = tuple(
            s.strip() for s in
            os.environ.get("DYN_REQUEST_TRACE_SINKS", "file").split(",")
            if s.strip() in ("file", "log"))
        return TraceConfig(
            enabled=enabled,
            sinks=sinks or ("file",),
            file_path=os.environ.get("DYN_REQUEST_TRACE_FILE_PATH",
                                     "request_trace.jsonl"),
        )


class TraceSink:
    """Fan-out writer for trace records."""

    def __init__(self, config: TraceConfig):
        self.config = config
        self._file = None
        if config.enabled and "file" in config.sinks:
            try:
                self._file = open(config.file_path, "a", buffering=1)
            except OSError:
                # an observability option must not take down serving
                logger.warning("request trace file %r not writable; file "
                               "sink disabled", config.file_path,
                               exc_info=True)

    def emit(self, record: Dict[str, Any]) -> None:
        if not self.config.enabled:
            return
        line = json.dumps(record, separators=(",", ":"))
        if self._file is not None:
            try:
                self._file.write(line + "\n")
            except OSError:
                logger.warning("request trace file write failed",
                               exc_info=True)
        if "log" in self.config.sinks:
            logger.info("request_trace", extra={"trace_record": record})

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# --------------------------- trace context ----------------------------------


def parse_traceparent(value: Optional[str]):
    """W3C traceparent: version-traceid-spanid-flags.  Returns
    (trace_id, parent_span_id) or (None, None)."""
    if not value:
        return None, None
    parts = value.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None, None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None, None  # W3C: ignore invalid traceparent, start fresh
    if set(parts[1]) <= set("0") or set(parts[2]) <= set("0"):
        return None, None
    return parts[1].lower(), parts[2].lower()


@dataclass
class RequestTracker:
    """Accumulates one request's timing/placement facts; emits the
    request_end record (ref record.rs emit_request_end).

    Forensics plane (obs/forensics.py): the tracker also accumulates an
    ordered **hop timeline** — received → routed → dispatched →
    remote-prefill open/done → first_token → coarse decode_stall hops →
    finish — with workers stamping realized prefix reuse / queue
    position / step counts back via ``worker_stamp`` hops, so
    migration, drain-abort, and disagg paths keep ONE coherent record
    across dispatch attempts.  Hop names come from ``obs.HOP_KINDS``
    (DYN012-checked); the cost is a handful of dict appends per request
    plus one gap compare per token delta, which is what lets the plane
    default on (``timeline_on``; byte-identical streams proven by the
    bench A/B smoke)."""

    request_id: str
    model: str
    sink: Optional[TraceSink] = None
    # SLO plane (obs/slo.py SloPlane): finish() feeds every terminal
    # record into the frontend's latency histograms / goodput windows
    slo: Optional[object] = None
    # forensics plane (obs/forensics.py ForensicsPlane): finish() offers
    # every terminal record to the tail-exemplar reservoir
    forensics: Optional[object] = None
    # hop-timeline recording switch (independent of the reservoir: tests
    # and the bench record timelines without a plane attached)
    timeline_on: bool = True
    x_request_id: Optional[str] = None
    trace_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    session_id: Optional[str] = None
    endpoint: str = "chat"
    input_tokens: int = 0
    # pool namespace the global router picked (X_POOL_HEADER); None when
    # the request hit this frontend directly
    pool: Optional[str] = None

    span_id: str = field(default_factory=lambda: secrets.token_hex(8))
    received_unix_ms: int = field(
        default_factory=lambda: int(time.time() * 1000))
    _t0: float = field(default_factory=time.monotonic)
    _dispatch_t: Optional[float] = None
    _first_token_t: Optional[float] = None
    _last_token_t: Optional[float] = None
    output_tokens: int = 0
    cached_tokens: Optional[int] = None
    queue_depth: Optional[int] = None
    decode_worker_id: Optional[int] = None
    prefill_worker_id: Optional[int] = None
    migrations: int = 0
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    tool_call_names: List[str] = field(default_factory=list)
    _dispatches: int = 0
    _finished: bool = False
    # -- hop timeline (obs/forensics.py vocabulary) -----------------------
    hops: List[Dict[str, Any]] = field(default_factory=list)
    # exact accumulated stall time (every stall counts here even past
    # the per-record hop cap — partition exactness depends on it)
    stall_ms: float = 0.0
    stall_threshold_s: float = 0.0  # 0 = resolve from env on first token
    # last worker_stamp facts (realized prefix reuse etc.) — the final
    # dispatch attempt's truth wins, matching decode_worker_id
    worker_stamp: Optional[Dict[str, Any]] = None
    _stall_hops: int = 0

    MAX_HOPS = 256          # decode_stall/worker_stamp flood guard
    MAX_STALL_HOPS = 64     # coarse stalls; stall_ms stays exact

    def hop(self, kind: str, at: Optional[float] = None, **attrs) -> None:
        """Append one timeline hop.  `at` backdates (monotonic clock);
        unregistered kinds raise — the same loud contract as
        ``chaos.rule()`` on an unregistered seam (a typo'd hop would be
        an orphan row the partition silently never joins on)."""
        from ..obs.forensics import HOP_KINDS

        if not self.timeline_on or self._finished:
            return
        if kind not in HOP_KINDS:
            raise ValueError(f"hop kind {kind!r} not in obs.HOP_KINDS")
        if not self.hops:
            self.hops.append({"hop": "received", "t_ms": 0.0})
        if len(self.hops) >= self.MAX_HOPS:
            return
        t = at if at is not None else time.monotonic()
        entry: Dict[str, Any] = dict(attrs)
        entry["hop"] = kind
        entry["t_ms"] = round((t - self._t0) * 1000.0, 3)
        self.hops.append(entry)

    @staticmethod
    def from_headers(headers, request_id: str, model: str,
                     sink: Optional[TraceSink], **kw) -> "RequestTracker":
        trace_id, parent = parse_traceparent(headers.get(TRACEPARENT_HEADER))
        return RequestTracker(
            request_id=request_id, model=model, sink=sink,
            x_request_id=headers.get(X_REQUEST_ID_HEADER) or request_id,
            trace_id=trace_id, parent_span_id=parent,
            pool=headers.get(X_POOL_HEADER), **kw)

    # -- hooks along the pipeline ----------------------------------------
    def on_dispatch(self, instance_id: Optional[int]) -> None:
        """Called per dispatch attempt (MigrationOperator): the last one
        wins as the decode worker; every attempt after the first counts
        as a migration.  Counted from an explicit attempt counter, NOT
        by comparing instance ids: a token-replay that lands back on the
        SAME instance (avoid set relaxed because it excluded every live
        worker) is still a migration the record must show."""
        self._dispatches += 1
        self.migrations = self._dispatches - 1
        self.decode_worker_id = instance_id
        self.hop("dispatched", attempt=self._dispatches,
                 **({"worker": instance_id} if instance_id is not None
                    else {}))
        if self._dispatch_t is None:
            # queue time = received -> FIRST dispatch (preprocessing +
            # routing + admission wait); replays don't re-queue
            self._dispatch_t = time.monotonic()

    def on_routed(self, instance_id: Optional[int],
                  decision: Optional[Dict[str, Any]] = None) -> None:
        """Router decision made (MigrationOperator, per attempt): the
        routed hop carries the decision's WHY — per-candidate cost
        scores, predicted overlap blocks, best rejected candidate,
        regret (router/kv_router.py decision dict) — so a tail autopsy
        can say not just where the request went but what it beat."""
        attrs: Dict[str, Any] = {"attempt": self._dispatches + 1}
        if instance_id is not None:
            attrs["worker"] = instance_id
        if self.pool is not None:
            attrs["pool"] = self.pool
        if decision:
            attrs.update(decision)
        self.hop("routed", **attrs)

    def on_worker_stamp(self, stamp: Dict[str, Any],
                        attempt: Optional[int] = None) -> None:
        """Worker-side facts stamped back via the stream (engine/mocker
        `forensic` metrics block): realized prefix-cache reuse, queue
        position at admission, step counts.  The LAST stamp wins as the
        record's truth (matching decode_worker_id after a migration),
        and realized reuse replaces the router-predicted cached_tokens
        the frontend guessed at first delta."""
        self.worker_stamp = dict(stamp)
        if stamp.get("cached_tokens") is not None:
            self.cached_tokens = int(stamp["cached_tokens"])
        self.hop("worker_stamp",
                 attempt=attempt if attempt is not None
                 else max(self._dispatches, 1),
                 **stamp)

    def mark_dispatching(self, at: Optional[float] = None) -> None:
        """Queue time ends the moment the request leaves the frontend
        for its FIRST worker — which in disaggregated mode is the
        remote-prefill hop, not the decode dispatch.  The pipeline
        calls this (backdated to the hop start via `at`) only when a
        remote prefill actually ran, so queue_ms neither absorbs a
        multi-second remote prefill as phantom admission wait nor
        hides the decode routing wait on local-path requests; the
        aggregated path stamps via on_dispatch as before."""
        if self._dispatch_t is None:
            self._dispatch_t = at if at is not None else time.monotonic()

    def on_prefill_worker(self, instance_id: int) -> None:
        self.prefill_worker_id = instance_id

    def add_tool_calls(self, calls) -> None:
        """Record tool-call names (never arguments) from parser output."""
        self.tool_call_names.extend(
            (tc.get("function") or {}).get("name") or tc.get("name", "")
            for tc in calls or [])

    def on_tokens(self, n: int) -> None:
        if n <= 0:
            return
        now = time.monotonic()
        if self._first_token_t is None:
            self._first_token_t = now
            self.hop("first_token", at=now)
        elif self.timeline_on and self._last_token_t is not None:
            # coarse decode-stall hops: a token gap past the threshold
            # is a stall.  stall_ms stays EXACT past the hop cap (the
            # partition subtracts it from decode), the hops are the
            # coarse where-did-it-stall markers
            if not self.stall_threshold_s:
                from ..obs.forensics import stall_threshold_s

                # -1 = explicitly disabled (DYN_STALL_THRESHOLD_S<=0);
                # 0 stays "unresolved" and would re-read env per token
                self.stall_threshold_s = stall_threshold_s() or -1.0
            gap = now - self._last_token_t
            if self.stall_threshold_s > 0.0 \
                    and gap >= self.stall_threshold_s:
                self.stall_ms += gap * 1000.0
                if self._stall_hops < self.MAX_STALL_HOPS:
                    self._stall_hops += 1
                    self.hop("decode_stall", at=now,
                             dur_ms=round(gap * 1000.0, 3))
        self._last_token_t = now
        self.output_tokens += n

    def traceparent(self) -> Optional[str]:
        """Outgoing context for downstream hops (worker annotations)."""
        if self.trace_id is None:
            return None
        return f"00-{self.trace_id}-{self.span_id}-01"

    def propagate(self, req) -> None:
        """Shared frontend-route hook (OpenAI + Anthropic surfaces):
        with timeline tracing on (obs/) and no inbound `traceparent`,
        mint a trace_id so this request's record, its frontend span,
        and every worker span still stitch into one trace; then ride
        the outgoing traceparent on the request annotations when either
        tracing plane wants it — and only then, or a service mesh
        injecting traceparent everywhere would flood worker logs."""
        from .. import obs

        if self.trace_id is None and obs.enabled():
            self.trace_id = secrets.token_hex(16)
        tp = self.traceparent()
        sink_on = self.sink is not None and self.sink.config.enabled
        if tp is not None and (sink_on or obs.enabled()):
            req.annotations = list(req.annotations) + [f"traceparent:{tp}"]

    # -- record ----------------------------------------------------------
    def finish(self, finish_reason: Optional[str] = None,
               error: Optional[str] = None) -> Dict[str, Any]:
        """Emit the request_end record — exactly once.

        Called on EVERY terminal path, not only clean finishes: client
        abort ("client_disconnected"), migration budget exhausted and
        drain-abort (the EngineError text, which carries the worker's
        failure marker), encoder/preprocess failures.  Error paths can
        race a clean finish (a stream teardown exception after the
        success record already emitted), so a second call returns the
        first record instead of double-counting the request."""
        if self._finished:
            return self._record
        self._finished = True
        now = time.monotonic()
        total_ms = (now - self._t0) * 1000.0
        ttft_ms = ((self._first_token_t - self._t0) * 1000.0
                   if self._first_token_t is not None else None)
        avg_itl_ms = None
        if (self.output_tokens > 1 and self._first_token_t is not None
                and self._last_token_t is not None
                and self._last_token_t > self._first_token_t):
            avg_itl_ms = ((self._last_token_t - self._first_token_t)
                          * 1000.0 / (self.output_tokens - 1))
        err_text = error or self.error
        # explicit terminal outcome (obs/slo.py vocabulary): errored
        # requests that never produced a first token — dispatch fail,
        # drain reject, preprocess/encode failure — must count in every
        # e2e/goodput denominator WITHOUT polluting the TTFT histogram,
        # and the label is how consumers tell the cases apart
        if err_text:
            outcome = ("error" if self._first_token_t is not None
                       else "no_first_token")
        else:
            outcome = "ok"
        request: Dict[str, Any] = {
            "request_id": self.request_id,
            "x_request_id": self.x_request_id,
            "model": self.model,
            "input_tokens": self.input_tokens,
            "output_tokens": self.output_tokens,
            "request_received_ms": self.received_unix_ms,
            "total_time_ms": round(total_ms, 3),
            "outcome": outcome,
        }
        if self.pool is not None:
            request["pool"] = self.pool
        if ttft_ms is not None:
            request["ttft_ms"] = round(ttft_ms, 3)
        if self._dispatch_t is not None:
            request["queue_ms"] = round(
                (self._dispatch_t - self._t0) * 1000.0, 3)
        if avg_itl_ms is not None:
            request["avg_itl_ms"] = round(avg_itl_ms, 3)
        if self.cached_tokens is not None:
            request["cached_tokens"] = self.cached_tokens
            if self.input_tokens:
                request["kv_hit_rate"] = round(
                    self.cached_tokens / self.input_tokens, 4)
        if self.queue_depth is not None:
            request["queue_depth"] = self.queue_depth
        worker: Dict[str, Any] = {}
        if self.decode_worker_id is not None:
            worker["decode_worker_id"] = self.decode_worker_id
        if self.prefill_worker_id is not None:
            worker["prefill_worker_id"] = self.prefill_worker_id
        if worker:
            request["worker"] = worker
        if self.migrations:
            request["migrations"] = self.migrations
        finish_md: Dict[str, Any] = {}
        if finish_reason or self.finish_reason:
            finish_md["finish_reason"] = finish_reason or self.finish_reason
        if self.tool_call_names:
            # names only — metadata, never arguments (ref types.rs)
            finish_md["tool_calls"] = [
                {"name": n} for n in self.tool_call_names]
        if finish_md:
            request["finish_reason_metadata"] = finish_md
        if error or self.error:
            request["error"] = error or self.error
        record: Dict[str, Any] = {
            "schema": SCHEMA,
            "event_type": "request_end",
            "event_time_unix_ms": int(time.time() * 1000),
            "event_source": "dynamo",
            "endpoint": self.endpoint,
            "request": request,
        }
        if self.trace_id is not None:
            record["trace"] = {
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_span_id": self.parent_span_id,
            }
        if self.session_id:
            record["agent_context"] = {"session_id": self.session_id}
        if self.hops:
            # forensics timeline: the terminal hop is appended directly
            # (the hop() gate is already closed by _finished, which is
            # what keeps a late on_tokens from mutating an emitted
            # record), and the partition is computed HERE so the JSONL
            # sink and the reservoir carry identical autopsies.  The
            # six phases sum to total_time_ms exactly by construction
            # (obs/forensics.py phase_partition).
            from ..obs.forensics import phase_partition

            self.hops.append({"hop": "finish",
                              "t_ms": round(total_ms, 3),
                              "outcome": outcome})
            partition = phase_partition(self.hops, total_ms,
                                        self.stall_ms)
            timeline: Dict[str, Any] = {
                "hops": self.hops,
                "stall_ms": round(self.stall_ms, 3),
                "partition": {p: round(v, 3)
                              for p, v in partition.items()},
            }
            if self.worker_stamp is not None:
                timeline["worker"] = self.worker_stamp
            record["timeline"] = timeline
        self._record = record
        if self.sink is not None:
            self.sink.emit(record)
        if self.slo is not None:
            # the one funnel every terminal path goes through: feed the
            # SLO plane's histograms/goodput (obs/slo.py; it guards its
            # own exceptions — a metrics bug must not fail the request)
            self.slo.observe_finish(self, record)
        if self.forensics is not None:
            # tail-exemplar reservoir (obs/forensics.py): retains this
            # record if it is tail-worthy or breached; guards its own
            # exceptions like the SLO plane
            self.forensics.observe_finish(self, record)
        return record

"""Timeline tracing plane: span-attributed engine steps + flight recorder.

A copy of dynamo_tpu/obs/__init__.py, so a torch worker's spans, Chrome
trace dumps and flight-recorder files are the JAX worker's, and the
port's report (`python -m dynamo_tpu_torch.obs.report <dump...>`, a copy
of JAX's) reduces them as JAX's does.  Named spans on every engine phase, exported as a Chrome
trace, as per-kind duration histograms on /metrics (`bind_metrics`) and
as the flight-recorder tail of /debug/state.

Design (the zero-cost-off contract):

  * **Module-global None check when disabled.**  Every hot-path helper
    (`begin()`, `end()`, `span()`) starts with ``if _TRACER is None``
    and allocates NOTHING on that branch: `begin()` returns the shared
    float ``0.0``, `span()` returns one process-wide no-op context
    manager.  The engine scheduler loop pays one pointer compare per
    phase when tracing is off.

  * **Thread-safe ring.**  Spans append to a bounded deque from both
    the scheduler thread and the event loop; the ring IS the flight
    recorder: `flight_dump()` snapshots the last N spans when a drain
    abort, an engine crash or a capture while serving fires, so a
    post-mortem always has the timeline that led up to the fault.

  * **Logical tracks.**  A span records the current thread name unless
    the caller pins a `track`.  Engine steps pin ``sched:<engine-id>``
    (the step runs on whichever pool thread `asyncio.to_thread` picked,
    but it is ONE logical timeline: the step lock serializes it), so
    the report's innermost-span attribution sees a well-nested track.

  * **Cross-process stitching.**  Request-scoped spans carry the
    `trace_id` the frontend minted (or received via W3C `traceparent`)
    and propagated through request annotations: one trace_id joins the
    frontend's `request` span and every worker's `worker_request` and
    pull spans for that request.

Span taxonomy (kind — where — what the time is):

  step             engine _sched_step: one scheduler iteration end to end
  sched            host scheduling: cancellations, KVBM offload sweep,
                   admission (allocation + prefix match), emitted only
                   when the device had nothing in flight (the host time
                   the device actually waited on)
  enqueue_ahead    the same host scheduling/dispatch-build work when it
                   runs WHILE the device is still executing in-flight
                   bursts (overlap_scheduling); counted as its own phase
                   so the wall partition stays exact, and excluded from
                   the report's sched_overhead_frac
  prefill_dispatch building + dispatching one packed prefill program,
                   including its FPM accounting
  decode_dispatch  building + dispatching one decode burst; attrs carry
                   ``cont`` (device-resident continuation vs full
                   upload), ``k``, ``lanes``
  device_wait      host blocked on a device readback (burst tokens,
                   prefill first tokens, verify windows, guided
                   candidates, KVBM copies)
  sample           host-side token acceptance: spec-decode rejection
                   sampling, guided-decoding candidate selection
  detok            incremental detokenization of one engine output (the
                   frontend's; the engine emits none, as in JAX)
  frame_egress     writing one SSE frame to the client socket (frontend)
  request          frontend: one HTTP request end to end (trace_id)
  worker_request   worker: serving one generate() stream (trace_id)
  kv_pull          decode engine: one whole disagg KV pull
  disagg_open/disagg_chunk
                   receiver-paced pull ops on the wire
  kvbm_offload     one batched G1->G2 offload sweep
  kvbm_onboard     one G2/G3/G4->G1 onboard scatter
  compile          one program captured (obs/compile_watch.py)

Env vocabulary:

    DYN_TRACE=1            install a process tracer at main() startup
    DYN_TRACE_OUT=path     Chrome trace JSON dump target; ``{pid}``
                           expands so multi-process fleets don't
                           clobber each other; dumped at exit and by
                           the flight recorder (sibling files)
    DYN_TRACE_RING=N       ring capacity in spans (default 16384)

Load a dump in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

DEFAULT_RING = 16384

# span kinds the engine-step partition is scored on (report.py groups
# everything else under its own name); kept here so engine, worker and
# report agree on the taxonomy
STEP_PHASES = ("sched", "enqueue_ahead", "prefill_dispatch",
               "decode_dispatch", "device_wait", "sample")

# THE canonical span taxonomy (the docstring table above, plus the
# capture watch's span), the JAX package's set: every obs.span()/obs.end()
# call site names one of these, so the JAX report and dashboards join a
# torch worker's spans on the same names.
SPAN_KINDS = frozenset(STEP_PHASES) | frozenset({
    "step",
    "detok",
    "frame_egress",
    "request",
    "worker_request",
    "kv_pull",
    "disagg_open",
    "disagg_chunk",
    "kvbm_offload",
    "kvbm_onboard",
    "compile",  # obs/compile_watch.py COMPILE_KIND (a graph capture)
})

# ---------------------------------------------------------------------------
# span record: a plain tuple, cheapest thing that can ride a deque
#   (kind, t0, t1, track, attrs|None, trace_id|None)
SpanTuple = Tuple[str, float, float, str, Optional[dict], Optional[str]]


class Tracer:
    """A bounded in-process span ring with Chrome-trace export.

    Install process-globally with ``with tracer:`` (or
    install()/uninstall()); the module helpers are no-ops while no
    tracer is installed."""

    def __init__(self, service: str = "dynamo", ring: int = DEFAULT_RING,
                 out_path: Optional[str] = None):
        self.service = service
        self.spans: "deque[SpanTuple]" = deque(maxlen=max(16, ring))
        self.out_path = out_path
        # monotonic epoch for ts=0, plus the unix time it corresponds to
        # so dumps from different processes can be coarsely aligned
        self._t0 = time.monotonic()
        self._epoch_unix_ms = time.time() * 1000.0
        self._lock = threading.Lock()
        self._metrics = None
        # flight-recorder rate limit: one dump per reason per cooldown
        self._flight_last: Dict[str, float] = {}
        self.flight_cooldown_s = 1.0
        self.flight_dumps: List[str] = []  # paths written (post-mortems)

    # -- recording --------------------------------------------------------
    def record(self, kind: str, t0: float, t1: float,
               attrs: Optional[dict] = None, trace_id: Optional[str] = None,
               track: Optional[str] = None) -> None:
        span = (kind, t0, t1,
                track or threading.current_thread().name, attrs, trace_id)
        with self._lock:
            self.spans.append(span)
        m = self._metrics
        if m is not None:
            try:
                m.observe("dynamo_trace_span_seconds", t1 - t0, kind=kind)
            except Exception:  # observability must never take down serving
                logger.warning("trace span metric failed", exc_info=True)
                self._metrics = None

    def bind_metrics(self, metrics) -> "Tracer":
        """Register the per-span-kind duration histogram on a
        MetricsHierarchy so `/metrics` on the system status server
        exposes phase latencies next to the engine gauges."""
        metrics.histogram(
            "dynamo_trace_span_seconds",
            "duration of timeline-tracer spans by kind", ("kind",),
            buckets=(1e-5, 1e-4, 2.5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                     2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 5.0))
        self._metrics = metrics
        return self

    # -- chrome trace export ----------------------------------------------
    def chrome_trace(self, spans=None) -> Dict[str, Any]:
        """Chrome trace-format JSON (Perfetto/chrome://tracing loadable):
        one "X" complete event per span, one metadata event per track,
        events sorted by start ts."""
        with self._lock:
            spans = list(self.spans) if spans is None else list(spans)
        pid = os.getpid()
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{self.service}:{pid}"},
        }]
        rows: List[Dict[str, Any]] = []
        for kind, t0, t1, track, attrs, trace_id in spans:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": track},
                })
            args: Dict[str, Any] = dict(attrs) if attrs else {}
            if trace_id is not None:
                args["trace_id"] = trace_id
            rows.append({
                "name": kind, "cat": "dynamo", "ph": "X", "pid": pid,
                "tid": tid,
                "ts": round((t0 - self._t0) * 1e6, 3),
                "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
                "args": args,
            })
        # sorted by start time: nested spans were appended at their END,
        # so ring order is t1 order — viewers and the report both want
        # per-track monotonic start ts
        rows.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": events + rows,
            "displayTimeUnit": "ms",
            "otherData": {
                "service": self.service,
                "pid": pid,
                "epoch_unix_ms": round(self._epoch_unix_ms, 3),
            },
        }

    def resolve_out_path(self) -> Optional[str]:
        if not self.out_path:
            return None
        return self.out_path.replace("{pid}", str(os.getpid()))

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring as Chrome trace JSON; returns the path (None
        when no target is configured)."""
        path = path or self.resolve_out_path()
        if path is None:
            return None
        try:
            with open(path, "w") as f:
                json.dump(self.chrome_trace(), f)
        except OSError:
            logger.warning("trace dump to %r failed", path, exc_info=True)
            return None
        return path

    def flight_dump(self, reason: str) -> Optional[str]:
        """Flight recorder: dump the last-N-spans ring next to the
        configured trace output (or the cwd) when a fault fires.
        Rate-limited per reason so a storm of injected frame drops
        doesn't grind serving into file I/O."""
        now = time.monotonic()
        last = self._flight_last.get(reason, 0.0)
        if now - last < self.flight_cooldown_s:
            return None
        self._flight_last[reason] = now
        safe = "".join(c if (c.isalnum() or c in "._-") else "-"
                       for c in reason)
        base = self.resolve_out_path()
        d = os.path.dirname(base) if base else "."
        path = os.path.join(d or ".",
                            f"dynflight-{safe}-{os.getpid()}.json")
        out = self.dump(path)
        if out is not None:
            self.flight_dumps.append(out)
            logger.warning("flight recorder dumped %d spans to %s (%s)",
                           len(self.spans), out, reason)
        return out

    # -- install ----------------------------------------------------------
    def install(self) -> "Tracer":
        global _TRACER
        _TRACER = self
        return self

    def uninstall(self) -> None:
        global _TRACER
        if _TRACER is self:
            _TRACER = None

    def __enter__(self) -> "Tracer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


_TRACER: Optional[Tracer] = None

def tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


# -- hot-path helpers --------------------------------------------------------
# begin()/end() is the zero-allocation pair for the scheduler loop: the
# disabled branch returns the shared 0.0 and end() drops a 0.0 handle even
# if a tracer appeared mid-span (a span must never report a bogus start).


def begin() -> float:
    """Span start handle: a monotonic timestamp, or 0.0 when disabled."""
    return time.monotonic() if _TRACER is not None else 0.0


def end(kind: str, t0: float, track: Optional[str] = None,
        trace_id: Optional[str] = None, **attrs) -> None:
    """Record [t0, now) as one span.  No-op when disabled or when the
    span began disabled (t0 == 0.0)."""
    tr = _TRACER
    if tr is None or t0 == 0.0:
        return
    tr.record(kind, t0, time.monotonic(), attrs or None, trace_id, track)


class _NullSpan:
    """Shared no-op context manager: span() allocates nothing when
    tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("kind", "track", "trace_id", "attrs", "_t0")

    def __init__(self, kind: str, track: Optional[str],
                 trace_id: Optional[str], attrs: Optional[dict]):
        self.kind = kind
        self.track = track
        self.trace_id = trace_id
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        tr = _TRACER
        if tr is not None and self._t0:
            tr.record(self.kind, self._t0, time.monotonic(), self.attrs,
                      self.trace_id, self.track)
        return False


def span(kind: str, track: Optional[str] = None,
         trace_id: Optional[str] = None, **attrs):
    """Context-manager span for non-hot paths (frontend, pulls, KVBM).
    Returns the shared no-op when tracing is disabled."""
    if _TRACER is None:
        return _NULL_SPAN
    return _Span(kind, track, trace_id, attrs or None)


def flight_dump(reason: str) -> Optional[str]:
    """Module-level flight-recorder trigger (drain/abort, engine crash,
    migration); no-op when tracing is disabled."""
    tr = _TRACER
    if tr is None:
        return None
    return tr.flight_dump(reason)


# -- log<->trace correlation -------------------------------------------------
# Workers bind the request's trace_id around one generate() stream (the
# frontend binds it for its handler task).  The
# logging filter (runtime/logging.py TraceIdFilter) stamps it onto every
# record emitted inside that context, so a request's log lines join its
# spans and request_end record on one id.  ContextVars follow asyncio
# task context, so concurrent requests never see each other's ids.
from contextvars import ContextVar as _ContextVar

_TRACE_ID_VAR: "_ContextVar[Optional[str]]" = _ContextVar(
    "dyn_trace_id", default=None)


def bind_trace_id(trace_id: Optional[str]):
    """Bind `trace_id` to the current (task) context for log
    correlation; None is a no-op.  Returns a reset token (or None)."""
    if trace_id is None:
        return None
    return _TRACE_ID_VAR.set(trace_id)


def unbind_trace_id(token) -> None:
    if token is not None:
        _TRACE_ID_VAR.reset(token)


def current_trace_id() -> Optional[str]:
    return _TRACE_ID_VAR.get()


def trace_id_from_annotations(annotations) -> Optional[str]:
    """The trace_id the frontend propagated via a
    ``traceparent:00-<trace>-<span>-01`` request annotation — how worker
    spans join the frontend's trace."""
    for a in annotations or ():
        if a.startswith("traceparent:"):
            parts = a.split(":", 1)[1].split("-")
            if len(parts) == 4 and len(parts[1]) == 32:
                return parts[1].lower()
    return None


def install_from_env() -> Optional[Tracer]:
    """Process-entry hook (engine/__main__.py): install a tracer when
    DYN_TRACE is set, dumping to DYN_TRACE_OUT at exit."""
    if os.environ.get("DYN_TRACE", "").lower() not in ("1", "true", "yes",
                                                       "on"):
        return None
    try:
        ring = int(os.environ.get("DYN_TRACE_RING", str(DEFAULT_RING)))
    except ValueError:
        ring = DEFAULT_RING
    tr = Tracer(ring=ring,
                out_path=os.environ.get("DYN_TRACE_OUT") or None).install()
    if tr.out_path:
        atexit.register(tr.dump)
    logger.info("timeline tracing enabled (ring=%d, out=%s)",
                ring, tr.out_path)
    return tr


__all__ = [
    "DEFAULT_RING",
    "SPAN_KINDS",
    "STEP_PHASES",
    "Tracer",
    "begin",
    "bind_trace_id",
    "current_trace_id",
    "enabled",
    "end",
    "flight_dump",
    "install_from_env",
    "span",
    "trace_id_from_annotations",
    "tracer",
    "unbind_trace_id",
]

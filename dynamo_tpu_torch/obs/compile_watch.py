"""The capture watch: every program the engine builds is an observed event.

The port's counterpart of dynamo_tpu/obs/compile_watch.py.  The JAX
engine's compile watchdog times every XLA compile and harvests each
compiled program's FLOPs and bytes from XLA's cost analysis; in the port
a program is built once, at its first run, and on CUDA captured as a
CUDA graph (engine/graphs.py), and its costs come from the per-program
cost count (obs/costs.py).  Every build of a decode burst, packed
prefill, spec-verify, draft catch-up/propose or guided top-M program
calls `CaptureWatch.on_capture` once, which emits what the JAX watch
emits for a compile:

  * a ``compile`` FPM record (``family``, ``seconds``, ``tokens``,
    ``serving``, ``flops``, ``bytes``), which the worker's load loop
    folds into ``dynamo_engine_compile_seconds{family}`` and the compile
    counters (`observe_compile_records`) and the JAX planner reads as it
    reads a JAX worker's;
  * a ``compile`` span on the engine's logical track;
  * when the build landed while requests were in flight (warm-up builds
    happen before any), a warning and a flight-recorder dump, because a
    capture while serving means a shape leaked past warm-up.

Family names are the JAX programs': decode (k = 1) and decode_multi
bursts, prefill_packed, spec_verify, decode_topk/decode_topk_wide,
draft_prefill and draft_propose; ``tokens`` is the capture's integer key
(k, the stream bucket T or the window M).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

# one place defines the compile FPM record's kind string; engine, workers,
# FpmWindow and the report all join on it
COMPILE_KIND = "compile"


class CaptureWatch:
    """Per-engine build observer: one record, span and (while serving)
    flight dump per program build."""

    def __init__(self, sink: Optional[Callable[[dict], None]] = None,
                 track: Optional[str] = None,
                 serving: Optional[Callable[[], bool]] = None):
        self.sink = sink          # fpm ring append (engine.fpm.append)
        self.track = track        # obs logical track for compile spans
        self._serving = serving or (lambda: False)

    def on_capture(self, family: str, tokens: int, seconds: float,
                   costs: Dict[str, float]) -> None:
        t1 = time.monotonic()
        serving = bool(self._serving())
        ev = {
            "t": t1, "kind": COMPILE_KIND, "family": family,
            "seconds": round(seconds, 6), "tokens": int(tokens),
            "serving": serving,
            "flops": costs["flops"], "bytes": costs["bytes"],
        }
        if self.sink is not None:
            self.sink(ev)
        from . import flight_dump, tracer

        tr = tracer()
        if tr is not None:
            tr.record(COMPILE_KIND, t1 - seconds, t1,
                      {k: v for k, v in ev.items()
                       if k not in ("t", "kind")},
                      None, self.track)
        if serving:
            # a program warm-up didn't build was built while requests
            # were in flight: every active stream stalled behind it
            logger.warning(
                "capture of %r (key %d) landed mid-serving: %.2fs stall",
                family, tokens, seconds)
            flight_dump(f"compile-{family}")


# builds range from ms (CPU test programs) to seconds (a capture of a
# full-depth program); the default buckets top out at 10s
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   20.0, 60.0)


def observe_compile_records(metrics, records) -> None:
    """Fold a drained FPM batch's compile records onto a worker's
    /metrics: the dynamo_engine_compile_seconds{family} histogram and
    the compile counters, the JAX worker's families."""
    hist = None
    for rec in records:
        if rec.get("kind") != COMPILE_KIND:
            continue
        if hist is None:
            hist = metrics.histogram(
                "dynamo_engine_compile_seconds",
                "XLA compile wall time per program family", ("family",),
                buckets=COMPILE_BUCKETS)
        family = str(rec.get("family", ""))
        hist.labels(**metrics.labels, family=family).observe(
            float(rec.get("seconds", 0.0)))
        metrics.inc("dynamo_engine_compiles_total", 1.0,
                    "XLA compiles per program family", family=family)
        if rec.get("serving"):
            metrics.inc("dynamo_engine_serving_compiles_total", 1.0,
                        "compiles that landed while requests were "
                        "in flight (each one is a serving stall)",
                        family=family)

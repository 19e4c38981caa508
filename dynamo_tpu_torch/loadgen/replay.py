"""Open-loop trace replay with TTFT/ITL capture, a copy of
dynamo_tpu/loadgen/replay.py.

The replayer is transport-agnostic: `client_fn(request_dict)` returns an
async iterator of LLMEngineOutput-shaped dicts (the worker contract), so
the same harness drives an in-proc engine, a request-plane client against
a live cluster, or (via an adapter) an HTTP frontend.  Metrics follow the
reference's benchmark definitions (docs/benchmarks/qwen3-32b-kv-routing.mdx:
TTFT, ITL, latency, goodput under TTFT/ITL SLOs).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..runtime.metrics import percentile
from .trace import TraceRow, materialize_tokens


@dataclass
class RequestResult:
    request_id: str
    scheduled_ms: float        # trace arrival offset
    start_t: float = 0.0       # wall time the request ARRIVED (its trace
    #                            slot) — not when the concurrency gate let
    #                            it through, so TTFT includes client-side
    #                            queueing (no coordinated omission)
    queue_wait_s: float = 0.0  # time spent waiting on the concurrency gate
    first_token_t: float = 0.0
    end_t: float = 0.0
    output_tokens: int = 0
    itls_s: List[float] = field(default_factory=list)
    error: Optional[str] = None

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.start_t

    @property
    def latency_s(self) -> float:
        return self.end_t - self.start_t


def _pct(xs: Sequence[float], q: float) -> float:
    return percentile(xs, q) if xs else float("nan")


@dataclass
class Report:
    results: List[RequestResult]
    wall_s: float

    def summary(self, slo_ttft_s: Optional[float] = None,
                slo_itl_s: Optional[float] = None) -> Dict[str, Any]:
        ok = [r for r in self.results if r.error is None
              and r.output_tokens > 0]
        errors = [r for r in self.results if r.error is not None]
        # a stream that ended cleanly but yielded no tokens (cancelled,
        # shed, empty) is DROPPED load — it must not vanish from the
        # accounting or the report looks clean while the cluster drops
        dropped = len(self.results) - len(ok) - len(errors)
        ttfts = [r.ttft_s for r in ok]
        itls = [i for r in ok for i in r.itls_s]
        out_toks = sum(r.output_tokens for r in ok)
        rep = {
            "requests": len(self.results),
            "completed": len(ok),
            "errors": len(errors),
            "dropped": dropped,
            "wall_s": round(self.wall_s, 3),
            "output_tokens_per_s": round(out_toks / self.wall_s, 2)
            if self.wall_s > 0 else 0.0,
            "request_rate_rps": round(len(ok) / self.wall_s, 3)
            if self.wall_s > 0 else 0.0,
            "ttft_s": {"p50": round(_pct(ttfts, 50), 4),
                       "p90": round(_pct(ttfts, 90), 4),
                       "p99": round(_pct(ttfts, 99), 4)},
            "itl_s": {"p50": round(_pct(itls, 50), 4),
                      "p90": round(_pct(itls, 90), 4),
                      "p99": round(_pct(itls, 99), 4)},
            # nonzero p99 queue wait = the concurrency gate saturated and
            # the replay degraded from open-loop toward closed-loop
            "queue_wait_s": {
                "p99": round(_pct([r.queue_wait_s for r in ok], 99), 4),
                "max": round(max((r.queue_wait_s for r in ok), default=0.0),
                             4)},
            "latency_s": {"p50": round(_pct([r.latency_s for r in ok], 50), 4),
                          "p99": round(_pct([r.latency_s for r in ok], 99), 4)},
        }
        if slo_ttft_s is not None or slo_itl_s is not None:
            good = 0
            for r in ok:
                if slo_ttft_s is not None and r.ttft_s > slo_ttft_s:
                    continue
                if slo_itl_s is not None and r.itls_s \
                        and float(np.mean(r.itls_s)) > slo_itl_s:
                    continue
                good += 1
            rep["goodput"] = {
                "slo_ttft_s": slo_ttft_s, "slo_itl_s": slo_itl_s,
                "good_requests": good,
                "good_rps": round(good / self.wall_s, 3)
                if self.wall_s > 0 else 0.0,
            }
        return rep


def row_to_request(row: TraceRow, block_size: int,
                   vocab_size: int = 32000) -> Dict[str, Any]:
    """PreprocessedRequest-shaped dict for the worker `generate` contract."""
    return {
        "token_ids": materialize_tokens(row, block_size, vocab_size),
        "request_id": row.request_id,
        "sampling": {"temperature": 0.0},
        "stop": {"max_tokens": row.output_length, "ignore_eos": True},
    }


async def replay(
    client_fn: Callable,
    rows: Sequence[TraceRow],
    *,
    block_size: int = 16,
    vocab_size: int = 32000,
    speedup: float = 1.0,
    max_concurrency: int = 256,
) -> Report:
    """Replay `rows` open-loop: each row is dispatched at
    timestamp/speedup; session follow-up turns (delay, no timestamp) fire
    `delay` ms after their session's previous turn completes."""
    t0 = time.perf_counter()
    sem = asyncio.Semaphore(max_concurrency)
    session_done: Dict[str, asyncio.Event] = {}
    results: List[RequestResult] = []

    async def one(row: TraceRow, wait_for: Optional[asyncio.Event],
                  done: Optional[asyncio.Event]) -> None:
        if wait_for is not None and row.timestamp is None:
            await wait_for.wait()
            if row.delay:
                await asyncio.sleep(row.delay / 1000.0 / speedup)
        else:
            target = (row.timestamp or 0.0) / 1000.0 / speedup
            now = time.perf_counter() - t0
            if target > now:
                await asyncio.sleep(target - now)
        res = RequestResult(row.request_id, row.timestamp or 0.0)
        results.append(res)
        req = row_to_request(row, block_size, vocab_size)
        res.start_t = time.perf_counter()
        async with sem:
            res.queue_wait_s = time.perf_counter() - res.start_t
            last_t = None
            try:
                async for out in client_fn(req):
                    now = time.perf_counter()
                    n = len(out.get("token_ids") or [])
                    if out.get("error"):
                        res.error = str(out["error"])
                        break
                    if n == 0:
                        continue
                    if res.output_tokens == 0:
                        res.first_token_t = now
                    elif last_t is not None:
                        # a burst of n tokens arriving together is n ITL
                        # samples of (gap / n) — token-level spacing
                        res.itls_s.extend([(now - last_t) / n] * n)
                    res.output_tokens += n
                    last_t = now
            except Exception as e:  # noqa: BLE001 — recorded, not fatal
                res.error = f"{type(e).__name__}: {e}"
            res.end_t = time.perf_counter()
        if done is not None:
            done.set()

    tasks = []
    for row in rows:
        wait_for = None
        done = None
        if row.session_id is not None:
            wait_for = session_done.get(row.session_id)
            done = asyncio.Event()
            session_done[row.session_id] = done
        tasks.append(asyncio.create_task(one(row, wait_for, done)))
    await asyncio.gather(*tasks)
    return Report(results=results, wall_s=time.perf_counter() - t0)

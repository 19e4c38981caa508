"""OBSERVE: the planner's observers, and the worker's windowed
forward-pass-metrics aggregation.

A copy of dynamo_tpu/planner/metrics.py.  The planner is a pure consumer
of what serving already publishes on the event plane:

  * `LoadObserver` reads `load_metrics.{ns}.{component}` (the worker's
    load loop, engine/worker.py, twice a second): the latest sample per
    worker, workers that stop publishing expired, aggregated per
    component; the cumulative counters (requests_total,
    prompt_tokens_total) differentiated over a sliding window into
    request rate and mean ISL for SLA planning;
  * `FpmObserver` reads `fpm.{ns}.{component}` (one record per
    dispatched program) through `FpmWindow`;
  * `SloObserver` reads `slo_metrics.{ns}` (obs/slo.py, the frontends'
    goodput and burn rates).

`FpmWindow` and `export_engine_gauges` are also what a worker runs on
its own FPM ring, so a bare `/metrics` scrape sees the headline engine
numbers (prefill MFU, per-phase roofline MFU/MBU, spec acceptance,
queue depth, decode tokens/s) without a planner in the deployment.  The
roofline reads the records' `xla_flops`/`xla_bytes`, which the port's
engine fills from its per-program cost counts (obs/costs.py) under the
JAX wire names.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

@dataclass
class WorkerSample:
    active_seqs: int = 0
    kv_usage: float = 0.0
    itl_ema_s: float = 0.0
    kv_cache_dtype: str = ""     # "" = worker predates the advertisement
    seen_t: float = field(default_factory=time.monotonic)


@dataclass
class AggregateLoad:
    workers: int = 0
    active_seqs: int = 0
    mean_kv_usage: float = 0.0
    req_per_s: float = 0.0       # fleet-wide arrival rate (windowed)
    mean_isl: float = 0.0        # mean prompt tokens per request (windowed)
    mean_itl_s: float = 0.0      # mean decode inter-token latency (EMA)
    # distinct KV storage dtypes live workers report (perf-model
    # fidelity input: PerfModel.check_kv_dtype)
    kv_dtypes: tuple = ()

    @property
    def active_per_worker(self) -> float:
        return self.active_seqs / self.workers if self.workers else 0.0


class LoadObserver:
    def __init__(self, runtime, namespace: str, component: str,
                 stale_after_s: float = 3.0, rate_window_s: float = 10.0):
        self.runtime = runtime
        self.subject = f"load_metrics.{namespace}.{component}"
        self.stale_after_s = stale_after_s
        self.rate_window_s = rate_window_s
        self.samples: Dict[int, WorkerSample] = {}
        # per-worker cumulative-counter history: (t, requests, prompt_toks)
        self._cum: Dict[int, Deque[Tuple[float, int, int]]] = {}
        self._cancel = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "LoadObserver":
        self._task = asyncio.create_task(self._loop())
        return self

    async def close(self) -> None:
        self._cancel.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        try:
            async for subj, payload in self.runtime.event_plane.subscribe(
                self.subject, cancel=self._cancel
            ):
                if subj != self.subject:
                    # subscription is prefix-matched on both planes: a
                    # sibling component ("backend2" vs "backend") must not
                    # leak into this fleet's aggregate
                    continue
                w = payload.get("worker_id")
                if w is None:
                    continue
                self.samples[w] = WorkerSample(
                    active_seqs=int(payload.get("active_seqs", 0)),
                    kv_usage=float(payload.get("kv_usage", 0.0)),
                    itl_ema_s=float(payload.get("itl_ema_s", 0.0)),
                    kv_cache_dtype=str(payload.get("kv_cache_dtype", "")),
                )
                if "requests_total" in payload:
                    hist = self._cum.setdefault(w, deque(maxlen=64))
                    req = int(payload.get("requests_total", 0))
                    ptok = int(payload.get("prompt_tokens_total", 0))
                    if hist and (req < hist[-1][1] or ptok < hist[-1][2]):
                        # restart detected at insertion: endpoints-only
                        # checks miss a restart whose new counters overtake
                        # the old window start
                        hist.clear()
                    hist.append((time.monotonic(), req, ptok))
        except asyncio.CancelledError:
            pass

    def _rates(self, now: float) -> Tuple[float, float]:
        """(fleet req/s, mean ISL) differentiated over the rate window.
        Counter resets (worker restart) discard that worker's window."""
        req_rate = 0.0
        d_req_total = 0
        d_tok_total = 0
        for w, hist in list(self._cum.items()):
            if w not in self.samples:
                del self._cum[w]
                continue
            while len(hist) > 1 and now - hist[0][0] > self.rate_window_s:
                hist.popleft()
            if len(hist) < 2:
                continue
            t0, r0, p0 = hist[0]
            t1, r1, p1 = hist[-1]
            dt = max(t1 - t0, 1e-6)
            req_rate += (r1 - r0) / dt
            d_req_total += r1 - r0
            d_tok_total += p1 - p0
        mean_isl = d_tok_total / d_req_total if d_req_total else 0.0
        return req_rate, mean_isl

    def aggregate(self) -> AggregateLoad:
        now = time.monotonic()
        for w in [w for w, s in self.samples.items()
                  if now - s.seen_t > self.stale_after_s]:
            del self.samples[w]  # dead or scaled-away worker
        live = list(self.samples.values())
        if not live:
            return AggregateLoad()
        req_rate, mean_isl = self._rates(now)
        itls = [s.itl_ema_s for s in live if s.itl_ema_s > 0]
        return AggregateLoad(
            workers=len(live),
            active_seqs=sum(s.active_seqs for s in live),
            mean_kv_usage=sum(s.kv_usage for s in live) / len(live),
            req_per_s=req_rate,
            mean_isl=mean_isl,
            mean_itl_s=sum(itls) / len(itls) if itls else 0.0,
            kv_dtypes=tuple(sorted({s.kv_cache_dtype for s in live
                                    if s.kv_cache_dtype})),
        )


class FpmWindow:
    """Sliding-window FPM aggregation, no runtime attached: feed it
    records (`add`) and read the derived engine numbers.  The planner's
    FpmObserver subclasses this with an event-plane subscription; a
    worker feeds its OWN fpm ring through one so `/metrics` scrapes see
    the headline engine numbers (prefill MFU, spec acceptance, queue
    depth, decode tok/s) without a planner in the deployment."""

    def __init__(self, window_s: float = 20.0):
        self.window_s = window_s
        # per-worker deques of (recv_t, record)
        self._steps: Dict[int, Deque[Tuple[float, dict]]] = {}

    def add(self, worker_id: int, rec: dict) -> None:
        if isinstance(rec, dict):
            self._steps.setdefault(
                worker_id, deque(maxlen=4096)
            ).append((time.monotonic(), rec))

    def _window(self):
        cutoff = time.monotonic() - self.window_s
        for w in list(self._steps):
            dq = self._steps[w]
            while dq and dq[0][0] < cutoff:
                dq.popleft()
            if not dq:
                del self._steps[w]
        return self._steps

    def decode_itl_s(self) -> float:
        """Fleet decode ITL: dispatch-gap time per token-step, weighted
        by fused burst size (gap covers k steps once the pipeline is
        saturated).  0.0 when no decode records are in the window.

        gap_s == 0.0 marks the first burst after an idle stretch (the
        engine zeroes it); the 1s ceiling here drops anything that still
        smells like request-boundary idleness rather than decode."""
        gap_total, steps_total = 0.0, 0
        for dq in self._window().values():
            for _, rec in dq:
                if rec.get("kind") != "decode":
                    continue
                gap = float(rec.get("gap_s", 0.0))
                k = int(rec.get("k", 1))
                if 0.0 < gap < 1.0 and k > 0:
                    gap_total += gap
                    steps_total += k
        return gap_total / steps_total if steps_total else 0.0

    def decode_itl_p95_s(self) -> float:
        """p95 per-token decode latency over the window's dispatch gaps
        (each gap contributes one sample at gap/k).  The fleet
        aggregator compares each worker's p95 against the fleet median
        to flag stragglers — tail latency is where a sick worker shows
        first, long before its mean moves.  0.0 when no decode records
        are in the window.

        Unlike decode_itl_s there is no gap ceiling here: both engines
        already clamp idle-period gaps to 0.0 AT THE RECORD SOURCE
        (their own >1s heuristic), which bounds what a tail detector
        can see — a worker wedged harder than that surfaces through the
        fleet plane's scrape-timeout `unreachable` mark and the
        serving-compile hotspots instead, not through this number."""
        from ..runtime.metrics import percentile

        samples = []
        for dq in self._window().values():
            for _, rec in dq:
                if rec.get("kind") != "decode":
                    continue
                gap = float(rec.get("gap_s", 0.0))
                k = int(rec.get("k", 1))
                if gap > 0.0 and k > 0:
                    samples.append(gap / k)
        return percentile(samples, 95.0)

    def prefill_tokens_per_s(self) -> float:
        """Fleet prefill token rate over the window (0.0 when idle).

        Spans use each record's OWN engine timestamp ("t", monotonic on
        that worker) per worker — a publish batches many records under
        one receive time, and monotonic clocks do not compare across
        workers — then per-worker rates sum.  A first-to-last dispatch
        span excludes the LAST program's own duration, so it is scaled by
        n/(n-1) (the mean inter-dispatch gap stands in for the missing
        tail); a single-record window falls back to tokens/window_s
        instead of reporting 0.0."""
        total_rate = 0.0
        for dq in self._window().values():
            toks, n, t0, t1 = 0, 0, None, None
            for _recv_t, rec in dq:
                if rec.get("kind") != "prefill":
                    continue
                toks += int(rec.get("tokens", 0))
                n += 1
                t = float(rec.get("t", 0.0))
                t0 = t if t0 is None else min(t0, t)
                t1 = t if t1 is None else max(t1, t)
            if not toks:
                continue
            if n >= 2 and t1 > t0:
                span = (t1 - t0) * n / (n - 1)
            else:
                span = self.window_s  # one dispatch: rate is a floor
            total_rate += toks / span
        return total_rate

    def prefill_mfu(self, peak_tflops: float = 0.0) -> float:
        """Window-mean prefill-phase MFU, token-weighted across workers.

        Records carrying their own `mfu` field (workers whose config
        pins peak_tflops compute it at dispatch) always count; records
        with only `flops` + a plausible `gap_s` fold in against the
        caller's peak_tflops, token-weighted alongside the rest — but
        only records marked `synced` (a blocking device fetch landed in
        the gap; jit dispatch is async, so a sync-free gap measures host
        enqueue time and flops/gap would overstate MFU without bound —
        the same gate the engine applies at dispatch), and the result is
        clamped to 1.0 like the engine's own records.  With
        peak_tflops=0 (the planner's default: it cannot know a
        heterogeneous fleet's peaks) fallback workers are ignored.  0.0
        when nothing in the window carries enough to tell."""
        w_mfu, w_tok = 0.0, 0
        flops_total, gap_total, fb_tok = 0.0, 0.0, 0
        for dq in self._window().values():
            for _, rec in dq:
                if rec.get("kind") != "prefill":
                    continue
                toks = int(rec.get("tokens", 0))
                if "mfu" in rec:
                    w_mfu += float(rec["mfu"]) * toks
                    w_tok += toks
                elif rec.get("flops") and rec.get("synced") \
                        and 0.0 < float(rec.get("gap_s", 0.0)) < 1.0:
                    flops_total += float(rec["flops"])
                    gap_total += float(rec["gap_s"])
                    fb_tok += toks
        if peak_tflops > 0.0 and gap_total > 0.0 and fb_tok:
            w_mfu += min(flops_total / gap_total
                         / (peak_tflops * 1e12), 1.0) * fb_tok
            w_tok += fb_tok
        return w_mfu / w_tok if w_tok else 0.0

    def spec_acceptance(self) -> Optional[float]:
        """Fleet speculative-decoding acceptance rate over the window:
        Σ accepted / Σ proposed across spec_verify records (one per
        packed verify dispatch, engine/core.py _spec_step).  The SLA
        planner surfaces it per tick so acceptance regressions — a
        proposer gone stale, a workload shift away from repetition —
        are visible next to ITL/MFU.  None when nothing speculated in
        the window — a REAL 0.0 (every draft rejected) is exactly the
        regression this metric exists to expose and must not be
        conflated with idle."""
        proposed, accepted = 0, 0
        for dq in self._window().values():
            for _, rec in dq:
                if rec.get("kind") != "spec_verify":
                    continue
                proposed += int(rec.get("proposed", 0))
                accepted += int(rec.get("accepted", 0))
        return accepted / proposed if proposed else None

    def prefill_queue_depth(self) -> float:
        """Fleet chunk-queue depth: each worker's most recent prefill
        record's `queue_depth` (waiting + still-prefilling slots at that
        dispatch), summed across workers — the prefill-pressure signal
        the SLA planner reads next to TTFT.  0.0 with no records."""
        total = 0.0
        for dq in self._window().values():
            for _, rec in reversed(dq):
                if rec.get("kind") == "prefill" and "queue_depth" in rec:
                    total += float(rec["queue_depth"])
                    break
        return total

    # -- roofline (the per-program cost counts, obs/costs.py) -------------
    _PHASE_GATES = {
        # prefill gaps measure device time only when a blocking fetch
        # landed inside (the engine marks those `synced`); decode and
        # spec-verify gaps are device time whenever plausible (decode:
        # saturated pipeline convention; spec: the verify fetch blocks)
        "prefill": lambda rec: rec.get("synced"),
        "decode": lambda rec: True,
        "spec_verify": lambda rec: True,
    }

    def _phase_rates(self, kind: str):
        """(flops/s, bytes/s) for one dispatch kind over the window,
        from the records' cost fields (xla_flops/xla_bytes) — per-worker
        Σcost/Σgap summed across workers, same gap plausibility gates
        as the token-rate derivations.  (0, 0) when nothing qualifies."""
        gate = self._PHASE_GATES.get(kind, lambda rec: True)
        flops_rate = bytes_rate = 0.0
        for dq in self._window().values():
            flops = byts = gaps = 0.0
            for _, rec in dq:
                if rec.get("kind") != kind or "xla_flops" not in rec:
                    continue
                gap = float(rec.get("gap_s", 0.0))
                if not 0.0 < gap < 1.0 or not gate(rec):
                    continue
                flops += float(rec["xla_flops"])
                byts += float(rec.get("xla_bytes", 0.0))
                gaps += gap
            if gaps > 0.0:
                flops_rate += flops / gaps
                bytes_rate += byts / gaps
        return flops_rate, bytes_rate

    def phase_mfu(self, kind: str, peak_tflops: float) -> float:
        """Window MFU for one dispatch kind from the records' counted
        FLOPs (fleet flops/s over the accelerator peak, clamped to 1.0).
        0.0 when the peak is unknown or nothing in the window carries
        costs."""
        if peak_tflops <= 0.0:
            return 0.0
        flops_rate, _ = self._phase_rates(kind)
        return min(flops_rate / (peak_tflops * 1e12), 1.0) \
            if flops_rate else 0.0

    def phase_mbu(self, kind: str, peak_hbm_gbps: float) -> float:
        """Window memory-bandwidth utilization for one dispatch kind
        (counted bytes over peak HBM bandwidth) — the
        binding roofline axis for decode, which is bandwidth-bound long
        before it is FLOPs-bound."""
        if peak_hbm_gbps <= 0.0:
            return 0.0
        _, bytes_rate = self._phase_rates(kind)
        return min(bytes_rate / (peak_hbm_gbps * 1e9), 1.0) \
            if bytes_rate else 0.0

    def compile_stats(self) -> dict:
        """Compile events in the window (obs/compile_watch.py records):
        total count, how many landed mid-serving, and per-family
        count/seconds/serving.  The planner surfaces this per tick —
        repeated steady-state compiles are a recompile storm (a shape
        leaking past warmup) stalling the fleet invisibly to token
        metrics; the per-family `serving` split is what lets the storm
        diag name the guilty family instead of a restarting worker's
        innocent warmup programs."""
        families: Dict[str, dict] = {}
        total = serving = 0
        for dq in self._window().values():
            for _, rec in dq:
                if rec.get("kind") != "compile":
                    continue
                total += 1
                fam = str(rec.get("family", ""))
                f = families.setdefault(
                    fam, {"count": 0, "seconds": 0.0, "serving": 0})
                f["count"] += 1
                f["seconds"] = round(
                    f["seconds"] + float(rec.get("seconds", 0.0)), 6)
                if rec.get("serving"):
                    serving += 1
                    f["serving"] += 1
        return {"total": total, "serving": serving, "families": families}

    def decode_tokens_per_s(self) -> float:
        """Fleet decode token rate over the window: with the pipeline
        saturated a decode record's gap covers k steps for every lane,
        so that burst emitted k·lanes tokens in gap seconds.  Per-worker
        rate Σ(k·lanes)/Σgap over plausible gaps (the decode_itl_s
        gate), summed across workers; 0.0 when idle."""
        total_rate = 0.0
        for dq in self._window().values():
            toks, gaps = 0, 0.0
            for _, rec in dq:
                if rec.get("kind") != "decode":
                    continue
                gap = float(rec.get("gap_s", 0.0))
                if not 0.0 < gap < 1.0:
                    continue
                toks += int(rec.get("k", 1)) * int(rec.get("lanes", 0))
                gaps += gap
            if toks and gaps > 0.0:
                total_rate += toks / gaps
        return total_rate


def export_engine_gauges(metrics, fw: FpmWindow, peak_tflops: float = 0.0,
                         peak_hbm_gbps: float = 0.0,
                         occupancy: Optional[dict] = None,
                         kv_ledger=None) -> None:
    """The worker load loop's /metrics gauge surface, the JAX workers'
    (engine/worker.py): the headline FPM aggregates, the per-phase
    roofline MFU/MBU, KV occupancy by tier and the KV ledger's onboard,
    violation and attribution gauges, under the JAX names."""
    metrics.set("dynamo_engine_prefill_mfu", fw.prefill_mfu(peak_tflops))
    metrics.set("dynamo_engine_prefill_queue_depth",
                fw.prefill_queue_depth())
    metrics.set("dynamo_engine_prefill_tokens_per_s",
                fw.prefill_tokens_per_s())
    metrics.set("dynamo_engine_decode_tokens_per_s",
                fw.decode_tokens_per_s())
    acc = fw.spec_acceptance()
    if acc is not None:
        metrics.set("dynamo_engine_spec_acceptance", acc)
    # roofline: gate on the PEAK being configured, not on the value —
    # an idle window must drive the gauge to 0.0, or a dashboard reads
    # the last busy minute's utilization forever.  One window scan per
    # phase serves BOTH gauges (_phase_rates returns the pair; calling
    # phase_mfu + phase_mbu would scan twice).
    for phase in ("prefill", "decode", "spec_verify"):
        if peak_tflops <= 0.0 and peak_hbm_gbps <= 0.0:
            continue
        flops_rate, bytes_rate = fw._phase_rates(phase)
        if peak_tflops > 0.0:
            metrics.set("dynamo_engine_mfu",
                        min(flops_rate / (peak_tflops * 1e12), 1.0),
                        phase=phase)
        if peak_hbm_gbps > 0.0:
            metrics.set("dynamo_engine_mbu",
                        min(bytes_rate / (peak_hbm_gbps * 1e9), 1.0),
                        phase=phase)
    for tier, occ in (occupancy or {}).items():
        for state in ("used", "free", "capacity"):
            if state in occ:
                metrics.set(f"dynamo_engine_kv_blocks_{state}",
                            occ[state], tier=tier)
    if kv_ledger is not None:
        # blocks served back into G1 by source tier
        for tier, n in kv_ledger.onboard_counts().items():
            metrics.set("dynamo_engine_kv_onboard_total", float(n),
                        "KV blocks onboarded into HBM by source tier "
                        "(g2 host / g3 disk / g4 shared object store)",
                        tier=tier)
        # the auditor's monotonic totals per class and tier: any sample
        # is a capacity-integrity signal
        for kind, tiers in kv_ledger.violations_by_kind().items():
            for tier, n in tiers.items():
                metrics.set("dynamo_kv_ledger_violations_total",
                            float(n),
                            "kv-ledger audit violations by class "
                            "(obs/kv_ledger.py): leak / double-free / "
                            "orphan / refcount-drift",
                            kind=kind, tier=tier)
        # per-tier occupancy attributed by lifecycle state
        for tier, states in kv_ledger.attribution().items():
            for state in ("active", "prefix_cached",
                          "pinned_by_transfer", "partial"):
                if state in states:
                    metrics.set("dynamo_kv_ledger_blocks",
                                float(states[state]),
                                "per-tier KV occupancy attributed by "
                                "lifecycle state (obs/kv_ledger.py)",
                                tier=tier, state=state)


class FpmObserver(FpmWindow):
    """Forward-pass-metrics consumer (ref fpm_publisher.rs + the
    reference's instrumented_scheduler.py): workers stream one record per
    dispatched program on `fpm.{ns}.{component}`; this observer keeps a
    sliding window per worker and derives the measured decode ITL
    (Σ dispatch gaps / Σ tokens-per-lane) and prefill throughput —
    finer-grained and fresher than the 0.5s EMA in load_metrics, and the
    input the SLA planner's perf model regresses on online."""

    def __init__(self, runtime, namespace: str, component: str,
                 window_s: float = 20.0):
        super().__init__(window_s=window_s)
        self.runtime = runtime
        self.subject = f"fpm.{namespace}.{component}"
        self._cancel = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "FpmObserver":
        self._task = asyncio.create_task(self._loop())
        return self

    async def close(self) -> None:
        self._cancel.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        try:
            async for subj, payload in self.runtime.event_plane.subscribe(
                self.subject, cancel=self._cancel
            ):
                if subj != self.subject:
                    continue
                w = payload.get("worker_id")
                steps = payload.get("steps")
                if w is None or not isinstance(steps, list):
                    continue
                for rec in steps:
                    self.add(w, rec)
        except asyncio.CancelledError:
            pass


@dataclass
class SloSample:
    goodput: float = 1.0
    max_burn: float = 0.0
    # phase-attributed burn (obs/slo.py burn_by_phase): TTFT burn says
    # the prefill side is behind, ITL burn the decode side — the
    # planner's burn actuation scales the matching pool
    burn_by_phase: dict = field(default_factory=dict)
    requests: int = 0
    seen_t: float = field(default_factory=time.monotonic)


class SloObserver:
    """Frontend SLO telemetry consumer: frontends publish their rolling
    goodput / burn-rate summary on ``slo_metrics.{namespace}``
    (obs/slo.py SloPlane.publish) and the planner reads the aggregate
    into its tick diag — the SLA controller's breach signal, observed at
    the only place TTFT/ITL are really measured (the client-facing
    edge), not inferred from worker-side proxies."""

    def __init__(self, runtime, namespace: str, stale_after_s: float = 10.0):
        self.runtime = runtime
        self.subject = f"slo_metrics.{namespace}"
        self.stale_after_s = stale_after_s
        self.samples: Dict[int, SloSample] = {}
        self._cancel = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "SloObserver":
        self._task = asyncio.create_task(self._loop())
        return self

    async def close(self) -> None:
        self._cancel.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        try:
            async for subj, payload in self.runtime.event_plane.subscribe(
                self.subject, cancel=self._cancel
            ):
                if subj != self.subject:
                    continue
                fid = payload.get("frontend_id")
                if fid is None:
                    continue
                burns = payload.get("burn") or {}
                phases = payload.get("burn_by_phase") or {}
                self.samples[fid] = SloSample(
                    goodput=float(payload.get("goodput", 1.0)),
                    max_burn=max((float(v) for v in burns.values()),
                                 default=0.0),
                    burn_by_phase={str(k): float(v)
                                   for k, v in phases.items()},
                    requests=int(payload.get("requests", 0)),
                )
        except asyncio.CancelledError:
            pass

    def aggregate(self) -> Optional[dict]:
        """Request-weighted goodput and worst burn rate across live
        frontends; None when no frontend reported recently (an SLO
        plane that is off must not read as 'all requests good')."""
        now = time.monotonic()
        for fid in [f for f, s in self.samples.items()
                    if now - s.seen_t > self.stale_after_s]:
            del self.samples[fid]
        live = list(self.samples.values())
        if not live:
            return None
        total = sum(s.requests for s in live)
        if total:
            goodput = sum(s.goodput * s.requests for s in live) / total
        else:
            goodput = min(s.goodput for s in live)
        phases: Dict[str, float] = {}
        for s in live:
            for k, v in s.burn_by_phase.items():
                if v > phases.get(k, 0.0):
                    phases[k] = v
        return {
            "goodput": round(goodput, 4),
            "max_burn": round(max(s.max_burn for s in live), 4),
            "burn_by_phase": {k: round(v, 4) for k, v in phases.items()},
            "requests": total,
            "frontends": len(live),
        }

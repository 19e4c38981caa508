"""The worker's windowed forward-pass-metrics aggregation.

Copies of dynamo_tpu/planner/metrics.py `FpmWindow` and
`export_engine_gauges`, the two pieces a worker runs on its own FPM ring
so a bare `/metrics` scrape sees the headline engine numbers (prefill
MFU, per-phase roofline MFU/MBU, spec acceptance, queue depth, decode
tokens/s) without a planner in the deployment.  The roofline reads the
records' `xla_flops`/`xla_bytes`, which the port's engine fills from its
per-program cost counts (obs/costs.py) under the JAX wire names.  The
planner itself (observers, the SLA loop) is not ported: the JAX planner
reads a torch worker's records over the event plane unchanged.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple


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
                         occupancy: Optional[dict] = None) -> None:
    """The worker load loop's /metrics gauge surface, the JAX workers'
    (engine/worker.py): the headline FPM aggregates, the per-phase
    roofline MFU/MBU and KV occupancy by tier, under the JAX names.  The
    JAX function's KV-ledger gauges are left out with the ledger (not
    ported)."""
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

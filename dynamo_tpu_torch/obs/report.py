"""Gap-attribution report: reduce a Chrome trace dump to the numbers the
overlapped scheduler is scored on.

    python -m dynamo_tpu_torch.obs.report trace.json [more-dumps.json ...]
        [--peak-tflops N] [--peak-hbm-gbps N]

A copy of dynamo_tpu/obs/report.py, so one set of dumps reduces to the
same report through either package.  "Served is 0.40 of raw" is a
symptom; this report turns a recorded timeline into the ranked
culprits: what fraction of engine wall time is host scheduling vs
device wait vs dispatch build vs idle, how often decode ran as a
device-resident continuation burst, and the p50/p95 of every phase.
Multiple dumps (frontend + each worker) merge; engine tracks are
recognized by their ``sched:`` prefix (obs/__init__.py pins step spans
there).

The report also prints a **per-phase roofline table**: the capture
watch (obs/compile_watch.py) stamps every ``compile`` span with the
program's FLOPs/bytes, and prefill/decode dispatch spans carry their
program's costs + the dispatch gap — so the table shows, per phase,
measured FLOP/s and bytes/s (MFU/MBU when the peaks are given), the
cost-count MFU next to the engine's hand-estimated one (``est_mfu``;
the two should agree within tens of percent; a large gap means one of
them is lying), and every compile with its family, duration, and
whether it landed mid-serving.  In a port trace the FLOPs and bytes
are the port's analytic count of each program (obs/costs.py), which
stands in for the XLA cost analysis a JAX trace carries: they ride
under the same keys (``flops``/``bytes`` on ``compile`` spans,
``xla_flops``/``xla_bytes`` on dispatch spans), and the report reads
either the same way.

Attribution is **innermost-span self time**: on one track, every
instant belongs to the deepest span covering it, so nesting (``step``
wraps ``sched`` wraps nothing; ``decode_dispatch`` wraps
``device_wait``) never double-counts and the partition sums to wall
time exactly — ``step_other`` is the step loop's unattributed host
overhead, ``idle`` the time outside any span (scheduler parked, or the
device running ahead of a host with nothing to do).  The acceptance
bar "phases sum to ≥95% of wall" is therefore a property of the
recording, checked here, not an accounting trick.

**Overlapped-scheduler semantics** (engine ``overlap_scheduling``):
host scheduling performed while the device still has in-flight work is
recorded as ``enqueue_ahead`` rather than ``sched`` — the device never
waited on it, so it is EXCLUDED from ``sched_overhead_frac`` (which
thereby means exactly "host time the device idled for") and surfaced
separately as ``enqueue_ahead_frac``.  The partition stays exact: both
kinds are named slices of ``wall_fractions``.  A healthy overlapped
run shows sched_overhead ≤ ~0.02, enqueue_ahead absorbing the host
work, device_wait carrying only the deliberate deferred readbacks, and
``cont_burst_frac`` near 1 in decode-dominated stretches.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Tuple

from ..runtime.metrics import percentile

ENGINE_TRACK_PREFIX = "sched:"


def events_of_doc(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The X-phase events of ONE Chrome-trace document, each event's
    track resolved to "<service>:<pid>/<thread-name>" — the in-memory
    half of load_events, so a benchmark can reduce a Tracer's
    chrome_trace() without a filesystem round trip."""
    out: List[Dict[str, Any]] = []
    other = doc.get("otherData", {})
    proc = f"{other.get('service', 'proc')}:{other.get('pid', 0)}"
    names: Dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        out.append({
            "name": ev["name"],
            "track": f"{proc}/{names.get(ev['tid'], ev['tid'])}",
            "ts": float(ev["ts"]),
            "dur": float(ev.get("dur", 0.0)),
            "args": ev.get("args", {}) or {},
        })
    return out


def load_events(paths: Iterable[str]) -> List[Dict[str, Any]]:
    """Merge the X-phase events of several dumps; same-named tracks from
    different processes stay distinct (see events_of_doc)."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        with open(path) as f:
            out.extend(events_of_doc(json.load(f)))
    return out


def _self_times(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """Innermost-covering-span self time per kind on ONE track, in µs.

    Events must be well nested per track (they are: each track is one
    serialized timeline).  Sweep the start/end boundaries with a stack;
    each elapsed segment is charged to the span open on top."""
    bounds: List[Tuple[float, int, int]] = []  # (t, +1 open | -1 close, idx)
    for i, ev in enumerate(events):
        if ev["dur"] <= 0.0:
            # a zero-width span has zero self time by definition; in the
            # sweep its close would sort before its own open and the
            # ghost entry would swallow the track's unattributed time
            continue
        bounds.append((ev["ts"], 1, i))
        bounds.append((ev["ts"] + ev["dur"], -1, i))
    # at equal t, close before open EXCEPT a parent opening at the same
    # instant as its child: opens sort by (t, kind=1) after closes —
    # and among same-t opens, longer spans (parents) first
    bounds.sort(key=lambda b: (b[0], b[1] == 1,
                               -events[b[2]]["dur"] if b[1] == 1
                               else events[b[2]]["dur"]))
    self_us: Dict[str, float] = defaultdict(float)
    stack: List[int] = []
    last_t = None
    for t, kind, idx in bounds:
        if last_t is not None and stack and t > last_t:
            self_us[events[stack[-1]]["name"]] += t - last_t
        last_t = t
        if kind == 1:
            stack.append(idx)
        else:
            if idx in stack:  # tolerate slight overlap from clock jitter
                stack.remove(idx)
    return dict(self_us)


def roofline(events: List[Dict[str, Any]], peak_tflops: float = 0.0,
             peak_hbm_gbps: float = 0.0) -> Dict[str, Any]:
    """Per-phase roofline from compile spans + dispatch-span attrs.

    Phase rates use the same gates as the live gauges
    (planner/metrics.py FpmWindow): plausible dispatch gaps only, and
    prefill only where a device sync landed in the gap (``synced``) —
    an async enqueue gap measures host time and would inflate MFU."""
    compiles: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev["name"] != "compile":
            continue
        a = ev["args"]
        fam = str(a.get("family", ""))
        c = compiles.setdefault(fam, {
            "count": 0, "seconds": 0.0, "serving": 0, "variants": set(),
        })
        c["count"] += 1
        c["seconds"] = round(c["seconds"] + float(a.get("seconds", 0.0)), 6)
        c["serving"] += int(bool(a.get("serving")))
        tokens = int(a.get("tokens", 0))
        c["variants"].add(tokens)
        if a.get("flops") and tokens >= c.get("_cost_tokens", -1):
            # deterministic representative: the LARGEST token variant's
            # costs (dump merge order is not chronological, so
            # last-seen-wins would flip the intensity verdict run to
            # run); `variants` says how many shapes the family compiled
            c["_cost_tokens"] = tokens
            c["flops"] = float(a["flops"])
            c["bytes"] = float(a.get("bytes", 0.0))
            if c["bytes"]:
                c["intensity"] = round(c["flops"] / c["bytes"], 3)
    for c in compiles.values():
        c["variants"] = len(c.pop("variants"))
        c.pop("_cost_tokens", None)

    phases: Dict[str, Dict[str, Any]] = {}
    for phase, span_name, need_sync in (("prefill", "prefill_dispatch",
                                         True),
                                        ("decode", "decode_dispatch",
                                         False)):
        flops = byts = gaps = 0.0
        est_mfu_w = est_gaps = 0.0
        n_all = n_used = 0
        for ev in events:
            if ev["name"] != span_name:
                continue
            n_all += 1
            a = ev["args"]
            gap = float(a.get("gap_s", 0.0))
            if "xla_flops" not in a or not 0.0 < gap < 1.0:
                continue
            if need_sync and not a.get("synced"):
                continue
            n_used += 1
            flops += float(a["xla_flops"])
            byts += float(a.get("xla_bytes", 0.0))
            gaps += gap
            if "est_mfu" in a:
                # gap-weighted: a per-record mfu is flops_i/gap_i, so
                # weighting by gap recovers Σflops/Σgap — the same
                # aggregation as the cost-analysis rate above, making
                # mfu vs est_mfu a pure FLOP-count comparison instead
                # of a mean-of-ratios artifact
                est_mfu_w += float(a["est_mfu"]) * gap
                est_gaps += gap
        if not n_all:
            continue
        # 4 significant digits, not 4 decimals: a CPU test run's MFU at
        # an accelerator's peak is ~1e-7 and must not round to a vacuous 0.0
        sig4 = lambda x: float(f"{x:.4g}")  # noqa: E731
        entry: Dict[str, Any] = {"dispatches": n_all,
                                 "costed_dispatches": n_used}
        if gaps > 0.0:
            entry["xla_flops_per_s"] = round(flops / gaps, 1)
            entry["xla_bytes_per_s"] = round(byts / gaps, 1)
            if peak_tflops > 0.0:
                entry["mfu"] = sig4(
                    min(flops / gaps / (peak_tflops * 1e12), 1.0))
            if peak_hbm_gbps > 0.0:
                entry["mbu"] = sig4(
                    min(byts / gaps / (peak_hbm_gbps * 1e9), 1.0))
        if est_gaps > 0.0:
            # the engine's own hand-estimated MFU (pre-roofline path),
            # printed next to the cost-analysis number so divergence is
            # visible at a glance
            entry["est_mfu"] = sig4(est_mfu_w / est_gaps)
        phases[phase] = entry
    return {"compiles": compiles, "phases": phases}


def report(events: List[Dict[str, Any]], peak_tflops: float = 0.0,
           peak_hbm_gbps: float = 0.0) -> Dict[str, Any]:
    by_track: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for ev in events:
        by_track[ev["track"]].append(ev)

    # -- engine-track wall partition --------------------------------------
    engine_tracks = [t for t, evs in by_track.items()
                     if ENGINE_TRACK_PREFIX in t
                     or any(e["name"] == "step" for e in evs)]
    wall_us = 0.0
    phase_us: Dict[str, float] = defaultdict(float)
    for t in engine_tracks:
        evs = sorted(by_track[t], key=lambda e: e["ts"])
        if not evs:
            continue
        t0 = min(e["ts"] for e in evs)
        t1 = max(e["ts"] + e["dur"] for e in evs)
        wall_us += t1 - t0
        for kind, us in _self_times(evs).items():
            key = "step_other" if kind == "step" else kind
            phase_us[key] += us
    idle_us = max(0.0, wall_us - sum(phase_us.values()))

    # -- per-kind latency stats (all tracks) ------------------------------
    durs: Dict[str, List[float]] = defaultdict(list)
    for ev in events:
        durs[ev["name"]].append(ev["dur"])
    kinds = {
        k: {
            "count": len(v),
            "total_s": round(sum(v) / 1e6, 6),
            "p50_ms": round(percentile(v, 50) / 1e3, 4),
            "p95_ms": round(percentile(v, 95) / 1e3, 4),
        }
        for k, v in sorted(durs.items())
    }

    # -- headline gap numbers ---------------------------------------------
    decode = [ev for ev in events if ev["name"] == "decode_dispatch"]
    cont = sum(1 for ev in decode if ev["args"].get("cont"))
    steps = [ev for ev in events if ev["name"] == "step"]
    gap: Dict[str, Any] = {}
    if wall_us > 0:
        frac = {k: round(us / wall_us, 4)
                for k, us in sorted(phase_us.items(),
                                    key=lambda kv: -kv[1])}
        frac["idle"] = round(idle_us / wall_us, 4)
        gap = {
            "engine_wall_s": round(wall_us / 1e6, 6),
            # what the overlapped scheduler must drive to ~0: host time
            # spent deciding WHILE THE DEVICE WAITED.  Host scheduling
            # that ran with device work still in flight reports as
            # `enqueue_ahead` (overlap_scheduling) and is deliberately
            # excluded here — the device never waited on it; it still
            # appears in wall_fractions/enqueue_ahead_frac so the
            # partition stays exact
            "sched_overhead_frac": round(
                (phase_us.get("sched", 0.0)
                 + phase_us.get("step_other", 0.0)) / wall_us, 4),
            "enqueue_ahead_frac": round(
                phase_us.get("enqueue_ahead", 0.0) / wall_us, 4),
            "device_wait_frac": round(
                phase_us.get("device_wait", 0.0) / wall_us, 4),
            # time the scheduler wasn't even stepping: with work queued
            # this is device-idle the host never filled
            "idle_frac": round(idle_us / wall_us, 4),
            "device_idle_per_step_ms": round(
                (idle_us + phase_us.get("sched", 0.0)
                 + phase_us.get("step_other", 0.0))
                / max(len(steps), 1) / 1e3, 4),
            "wall_fractions": frac,
        }
        if decode:
            gap["cont_burst_frac"] = round(cont / len(decode), 4)
    trace_ids = {ev["args"]["trace_id"] for ev in events
                 if "trace_id" in ev["args"]}
    fpc = fleet_prefix_cache(events)
    return {
        "spans": len(events),
        "tracks": len(by_track),
        "engine_tracks": len(engine_tracks),
        "distinct_trace_ids": len(trace_ids),
        "gap": gap,
        "kinds": kinds,
        "roofline": roofline(events, peak_tflops, peak_hbm_gbps),
        **({"fleet_prefix_cache": fpc} if fpc else {}),
    }


def fleet_prefix_cache(events: List[Dict[str, Any]]):
    """TTFT attributed to tier hits: every block a ``kvbm_onboard`` span
    served back into G1 skipped its share of prefill recompute and paid
    the tier transfer instead.  Saved time per tier = onboarded tokens ×
    the SAME trace's measured prefill seconds/token; the net headline
    subtracts the transfer time actually spent inside the onboard spans.
    None when the trace has no onboard spans (section omitted)."""
    onboards = [ev for ev in events if ev["name"] == "kvbm_onboard"]
    if not onboards:
        return None
    prefill = [ev for ev in events if ev["name"] == "prefill_dispatch"
               and ev["args"].get("tokens")]
    tok = sum(float(e["args"]["tokens"]) for e in prefill)
    s_per_tok = (sum(e["dur"] for e in prefill) / 1e6 / tok) \
        if tok > 0 else 0.0
    by_tier: Dict[str, Dict[str, float]] = {}
    onboard_s = 0.0
    for ev in onboards:
        a = ev["args"]
        onboard_s += ev["dur"] / 1e6
        blocks = float(a.get("blocks") or 0)
        toks_per_block = (float(a.get("tokens") or 0) / blocks
                          if blocks else 0.0)
        for k, v in a.items():
            if k.startswith("from_"):
                d = by_tier.setdefault(k[5:], {"blocks": 0,
                                               "tokens": 0.0})
                d["blocks"] += int(v)
                d["tokens"] += float(v) * toks_per_block
    total_saved = 0.0
    tiers: Dict[str, Any] = {}
    for t, d in sorted(by_tier.items()):
        saved = d["tokens"] * s_per_tok
        total_saved += saved
        tiers[t] = {"blocks": int(d["blocks"]),
                    "recompute_saved_s": round(saved, 6)}
    return {
        "onboard_spans": len(onboards),
        "onboard_s": round(onboard_s, 6),
        "prefill_s_per_token": round(s_per_tok, 9),
        "by_tier": tiers,
        "ttft_saved_s": round(total_saved - onboard_s, 6),
    }


# ---------------------------------------------------------------------------
# tail autopsy (forensics dumps — obs/forensics.py dynamo.forensics.v1)
# ---------------------------------------------------------------------------


def forensics_docs(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The forensics dumps inside one JSON document: a raw
    ForensicsPlane.dump(), or a /debug/requests response wrapping one
    dump per registered source."""
    out = []
    if doc.get("schema") == "dynamo.forensics.v1":
        out.append(doc)
    for v in (doc.get("sources") or {}).values():
        if isinstance(v, dict) and v.get("schema") == "dynamo.forensics.v1":
            out.append(v)
    return out


def tail_autopsy(dumps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce forensics dumps to the tail-autopsy section: per model,
    the worst exemplar by TTFT and by mean ITL with their EXACT
    queue/route/prefill/transfer/decode/stall partitions, the mean
    phase mix across every retained exemplar, breach counts by reason,
    and the partition-exactness check (max |Σphases − e2e| / e2e — a
    property of the recording, verified here on every exemplar, not an
    accounting trick)."""
    per_model: Dict[str, Dict[str, Any]] = {}
    realized = {"realized_tokens": 0, "input_tokens": 0}
    for dump in dumps:
        ro = dump.get("realized_overlap") or {}
        realized["realized_tokens"] += int(ro.get("realized_tokens") or 0)
        realized["input_tokens"] += int(ro.get("input_tokens") or 0)
        for model, windows in (dump.get("models") or {}).items():
            m = per_model.setdefault(model, {
                "seen": {}, "breach_reasons": {}, "breaches": 0,
            })
            for w in windows:
                for kind in ("ttft", "itl", "breach"):
                    for ex in w.get(kind) or ():
                        # the same exemplar can sit in several ranked
                        # lists; dedupe by request id
                        m["seen"][ex.get("request_id", id(ex))] = ex
                for ex in w.get("breach") or ():
                    m["breaches"] += 1
                    r = ex.get("breach", "unknown")
                    m["breach_reasons"][r] = \
                        m["breach_reasons"].get(r, 0) + 1
    models: Dict[str, Any] = {}
    n_total = 0
    worst_err = 0.0
    for model, m in per_model.items():
        exemplars = list(m["seen"].values())
        n_total += len(exemplars)
        phase_sum: Dict[str, float] = {}
        e2e_sum = 0.0
        for ex in exemplars:
            part = ex.get("partition") or {}
            e2e = float(ex.get("e2e_ms") or 0.0)
            e2e_sum += e2e
            for p, v in part.items():
                phase_sum[p] = phase_sum.get(p, 0.0) + float(v)
            if e2e > 0.0:
                worst_err = max(worst_err, abs(
                    sum(float(v) for v in part.values()) - e2e) / e2e)

        def _brief(ex):
            if ex is None:
                return None
            return {k: ex.get(k) for k in
                    ("request_id", "ttft_ms", "avg_itl_ms", "e2e_ms",
                     "outcome", "breach", "partition") if k in ex}

        models[model] = {
            "exemplars": len(exemplars),
            "breaches": m["breaches"],
            "breach_reasons": m["breach_reasons"],
            # mean phase mix over the retained tail (fractions of the
            # summed e2e, so phases with rounding dust stay comparable)
            "phase_mix": ({p: round(v / e2e_sum, 4)
                           for p, v in sorted(phase_sum.items(),
                                              key=lambda kv: -kv[1])}
                          if e2e_sum > 0.0 else {}),
            "worst_ttft": _brief(max(
                (e for e in exemplars if e.get("ttft_ms") is not None),
                key=lambda e: e["ttft_ms"], default=None)),
            "worst_itl": _brief(max(
                (e for e in exemplars if e.get("avg_itl_ms") is not None),
                key=lambda e: e["avg_itl_ms"], default=None)),
        }
    return {
        "exemplars": n_total,
        "partition_err_max": round(worst_err, 6),
        "realized_overlap_ratio": (
            round(realized["realized_tokens"] / realized["input_tokens"], 4)
            if realized["input_tokens"] else None),
        "models": models,
    }


# ---------------------------------------------------------------------------
# KV accounting (kv-ledger dumps — obs/kv_ledger.py dynamo.kv_ledger.v1)
# ---------------------------------------------------------------------------


def kv_ledger_docs(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The kv-ledger dumps inside one JSON document: a raw
    KvLedger.dump(), or a /debug/kv response wrapping one dump per
    registered worker source (and the fleet CLI's --json snapshot,
    whose worker views carry `kv_ledger` blocks)."""
    out = []
    if doc.get("schema") == "dynamo.kv_ledger.v1":
        out.append(doc)
    for v in (doc.get("sources") or {}).values():
        if isinstance(v, dict) and v.get("schema") == "dynamo.kv_ledger.v1":
            out.append(v)
    for w in doc.get("workers") or ():
        v = w.get("kv_ledger") if isinstance(w, dict) else None
        if isinstance(v, dict) and v.get("schema") == "dynamo.kv_ledger.v1":
            out.append(v)
    return out


def kv_accounting(dumps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce kv-ledger dumps to the KV-accounting section: total audit
    violations by kind+tier (with the first few violation details kept
    verbatim — block id, hash, seq_id are the leak report's lead), the
    fleet-summed per-tier occupancy attribution, worst fragmentation,
    and whether every reporting worker's LAST audit reconciled clean."""
    from .fleet import reduce_kv_ledgers

    dumps = [d for d in dumps if d.get("enabled", True)]
    rollup = reduce_kv_ledgers(dumps) or {
        "workers_reporting": 0, "violations": {}, "violations_total": 0,
        "occupancy": {},
    }
    examples: List[Dict[str, Any]] = []
    clean = True
    worst_frag = 0.0
    ops: Dict[str, int] = {}
    for d in dumps:
        audit = d.get("audit") or d.get("last_audit") or {}
        if audit and not audit.get("clean", True):
            clean = False
            examples.extend(audit.get("violations", ())[:4])
        frag = ((d.get("attribution") or {}).get("g1") or {}).get(
            "fragmentation") or {}
        worst_frag = max(worst_frag, float(frag.get("dead_frac", 0.0)))
        for op, n in (d.get("counts") or {}).items():
            ops[op] = ops.get(op, 0) + int(n)
    return {
        **rollup,
        "reconciled_clean": clean,
        "violation_examples": examples[:8],
        "dead_cached_frac_max": round(worst_frag, 4),
        "ops": ops,
    }


# ---------------------------------------------------------------------------
# Planner actuation (planner/planner.py Planner.debug_state() dumps)
# ---------------------------------------------------------------------------


def planner_docs(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The planner control-plane states inside one JSON document: a raw
    ``Planner.debug_state()`` dump, or a /debug/state response wrapping
    a ``planner:{component}`` source."""
    def _is_planner(v) -> bool:
        return (isinstance(v, dict) and v.get("kind") == "planner"
                and "decisions" in v)

    out = [doc] if _is_planner(doc) else []
    out.extend(v for v in (doc.get("sources") or {}).values()
               if _is_planner(v))
    return out


def actuation_report(dumps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce planner debug-state dumps to the actuation section: scale
    decisions by direction, burn-forced scale-ups, quarantine
    holds/strikes/event counts, spawn-governor failure and breaker
    totals, and drain escalations — 'what did the control plane DO' as
    one rollup next to the report's 'where did the time go'."""
    planners = []
    ups = downs = burn_ups = 0
    q_events: Dict[str, int] = {}
    held = 0
    strikes = 0
    spawn = {"failures_total": 0, "breaker_opens_total": 0,
             "breaker_open": False}
    drain_escalations = 0
    for d in dumps:
        decisions = [x for x in (d.get("decisions") or ())
                     if isinstance(x, dict)]
        for dec in decisions:
            applied = dec.get("applied")
            current = dec.get("current")
            if applied is None or current is None:
                continue
            if applied > current:
                ups += 1
            elif applied < current:
                downs += 1
            if dec.get("burn_actuation"):
                burn_ups += 1
        q = d.get("quarantine") or {}
        held += len(q.get("held") or {})
        strikes += sum(int(n) for n in (q.get("strikes") or {}).values())
        for ev in q.get("events") or ():
            kind = str(ev.get("kind", "unknown"))
            q_events[kind] = q_events.get(kind, 0) + 1
        sp = d.get("spawn") or {}
        spawn["failures_total"] += int(sp.get("failures_total", 0))
        spawn["breaker_opens_total"] += \
            int(sp.get("breaker_opens_total", 0))
        spawn["breaker_open"] |= bool(sp.get("breaker_open"))
        drain_escalations += int(d.get("drain_escalations", 0))
        planners.append({
            "component": d.get("component"),
            "mode": d.get("mode"),
            "phase": d.get("phase") or "any",
            "decisions": len(decisions),
        })
    return {
        "planners": planners,
        "scale_ups": ups,
        "scale_downs": downs,
        "burn_actuations": burn_ups,
        "quarantine": {"held": held, "strikes": strikes,
                       "events": q_events},
        "spawn": spawn,
        "drain_escalations": drain_escalations,
    }


def report_paths(paths: Iterable[str], peak_tflops: float = 0.0,
                 peak_hbm_gbps: float = 0.0) -> Dict[str, Any]:
    """Reduce a mixed set of dumps: Chrome traces feed the gap/roofline
    sections, forensics dumps (/debug/requests or ForensicsPlane.dump
    files) feed the tail-autopsy section, kv-ledger dumps (/debug/kv or
    fleet --json snapshots) feed the KV-accounting section, and planner
    debug-state dumps feed the actuation section — pass any mix and the
    report carries what it finds."""
    events: List[Dict[str, Any]] = []
    tails: List[Dict[str, Any]] = []
    ledgers: List[Dict[str, Any]] = []
    planners: List[Dict[str, Any]] = []
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        found = forensics_docs(doc)
        led = kv_ledger_docs(doc)
        plans = planner_docs(doc)
        ledgers.extend(led)
        planners.extend(plans)
        if found:
            tails.extend(found)
        elif not led and not plans:
            events.extend(events_of_doc(doc))
    rep = report(events, peak_tflops, peak_hbm_gbps)
    if tails:
        rep["tail"] = tail_autopsy(tails)
    if ledgers:
        rep["kv"] = kv_accounting(ledgers)
    if planners:
        rep["actuation"] = actuation_report(planners)
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "dynamo_tpu_torch.obs.report",
        description="Gap-attribution report over Chrome trace dumps "
                    "(DYN_TRACE_OUT); "
                    "forensics dumps (/debug/requests JSON or "
                    "ForensicsPlane.dump files) additionally render "
                    "the tail-autopsy section, kv-ledger dumps "
                    "(/debug/kv JSON or fleet --json snapshots) the "
                    "KV-accounting section, and planner debug-state "
                    "dumps the actuation section.")
    p.add_argument("paths", nargs="+",
                   help="Chrome trace JSON dump(s), dynamo.forensics.v1 "
                        "dumps, and/or dynamo.kv_ledger.v1 dumps")
    p.add_argument("--indent", type=int, default=2,
                   help="JSON indent (0 = one line)")
    p.add_argument("--peak-tflops", type=float, default=0.0,
                   help="accelerator peak TFLOP/s: the roofline table "
                        "reports per-phase MFU (0 = rates only)")
    p.add_argument("--peak-hbm-gbps", type=float, default=0.0,
                   help="accelerator peak HBM GB/s: the roofline table "
                        "reports per-phase MBU (0 = rates only)")
    args = p.parse_args(argv)
    rep = report_paths(args.paths, args.peak_tflops, args.peak_hbm_gbps)
    json.dump(rep, sys.stdout, indent=args.indent or None)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

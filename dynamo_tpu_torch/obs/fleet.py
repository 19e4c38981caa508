"""Fleet aggregator: one merged view of every live instance's state.

A copy of dynamo_tpu/obs/fleet.py on the port's standard-library HTTP
client (runtime/http.py) where the JAX module uses aiohttp, and its own
reading of the text exposition where JAX's uses prometheus_client
(neither is on the machines the port serves on).  It discovers every
live instance through the discovery backend (each instance advertises
its system-status address in its discovery metadata,
runtime/component.py), scrapes `/metrics` and the token-gated
`/debug/state` concurrently with bounded retries (runtime/retry.py),
tolerates partial failure by marking individual workers ``stale`` /
``unreachable`` instead of failing the snapshot, and reduces the result
to the signals the planner reads:

  * per-worker KV occupancy + fleet-minimum KV headroom,
  * load imbalance (max/mean tokens-in-flight) and goodput spread,
  * straggler detection (per-worker decode ITL p95 vs fleet median),
  * serving-recompile hotspots and drain states.

Exported three ways: ``dynamo_fleet_*`` gauges (`export_fleet_gauges`),
the planner's per-tick diag (`FleetObserver` → planner/planner.py
``fleet_imbalance`` / ``fleet_straggler`` / ``fleet_kv_headroom``, and
the straggler quarantine), and the operator CLI::

    python -m dynamo_tpu_torch.obs.fleet [--json] [--watch] [--namespace ns]

which resolves the discovery backend from the same ``DYN_*`` env the
fleet itself runs on (read-only: it never reaps a lease) and reads the
admin token from ``DYN_ADMIN_TOKEN``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..runtime.discovery import INSTANCE_PREFIX, QUARANTINE_PREFIX, Instance
from ..runtime.http import HttpClient, HttpError
from ..runtime.metrics import percentile
from ..runtime.retry import RetryPolicy, call_with_retry

logger = logging.getLogger(__name__)

# two quick tries per surface: a scrape rides incident paths, so it must
# give up fast and mark the worker rather than hang the snapshot
SCRAPE_POLICY = RetryPolicy(max_attempts=2, base_s=0.05, cap_s=0.25)

# a worker whose decode ITL p95 exceeds this multiple of the fleet
# median is flagged a straggler
STRAGGLER_RATIO = 2.0

WORKER_ENDPOINTS = ("generate", "http")


@dataclass
class WorkerView:
    """One instance's slice of the fleet snapshot."""

    worker_id: int
    kind: str                 # engine | mocker | frontend | unknown
    namespace: str
    component: str
    endpoint: str
    address: str
    system_addr: str
    state: str                # live | stale | unreachable
    debug: Optional[dict] = None    # this worker's /debug/state source
    metrics: Dict[str, float] = field(default_factory=dict)
    # this frontend's /debug/requests forensics dump (tail exemplars;
    # obs/forensics.py) — best-effort, never affects `state`
    tail: Optional[dict] = None
    # this worker's /debug/kv kv-ledger dump (obs/kv_ledger.py:
    # attributed occupancy + audit) — best-effort, never affects `state`
    kv_ledger: Optional[dict] = None
    error: str = ""

    def to_dict(self) -> dict:
        return {
            "worker_id": self.worker_id, "kind": self.kind,
            "namespace": self.namespace, "component": self.component,
            "endpoint": self.endpoint, "address": self.address,
            "system_addr": self.system_addr, "state": self.state,
            "debug": self.debug, "metrics": self.metrics,
            **({"tail": self.tail} if self.tail is not None else {}),
            **({"kv_ledger": self.kv_ledger}
               if self.kv_ledger is not None else {}),
            **({"error": self.error} if self.error else {}),
        }


@dataclass
class FleetSnapshot:
    ts_unix: float
    workers: List[WorkerView]
    frontends: List[WorkerView]
    summary: dict

    def to_dict(self) -> dict:
        return {
            "ts_unix": self.ts_unix,
            "summary": self.summary,
            "workers": [w.to_dict() for w in self.workers],
            "frontends": [f.to_dict() for f in self.frontends],
        }


# ---------------------------------------------------------------------------
# scraping
# ---------------------------------------------------------------------------


class PermanentScrapeError(Exception):
    """A 4xx scrape response (bad/missing admin token, unknown route):
    deterministic, so retrying it only doubles the load and latency of
    every snapshot — fail the surface immediately."""


async def _fetch(client: HttpClient, path: str, headers: dict,
                 timeout_s: float) -> str:
    async def once() -> str:
        r = await asyncio.wait_for(
            client.request("GET", path, headers=headers), timeout_s)
        if 400 <= r.status < 500:
            raise PermanentScrapeError(
                f"HTTP {r.status} from {client.netloc}{path}")
        r.raise_for_status()
        return r.body.decode("utf-8", "replace")

    # retry transport + 5xx failures only; PermanentScrapeError is not
    # in retry_on, so it propagates on the first attempt
    return await call_with_retry(
        once, SCRAPE_POLICY,
        retry_on=(HttpError, asyncio.TimeoutError, OSError))


def _label_value(rest: str, j: int) -> Tuple[str, int]:
    """The quoted label value starting at rest[j] (past its opening
    quote), unescaped, and the index past its closing quote."""
    out = []
    while rest[j] != '"':
        if rest[j] == "\\":
            nxt = rest[j + 1]
            out.append("\n" if nxt == "n" else nxt)
            j += 2
        else:
            out.append(rest[j])
            j += 1
    return "".join(out), j + 1


def _sample(line: str) -> Tuple[str, Dict[str, str], float]:
    """(name, labels, value) of one sample line of a text exposition."""
    labels: Dict[str, str] = {}
    if "{" not in line:
        name, value = line.split()[:2]
        return name, labels, float(value)
    name, rest = line.split("{", 1)
    i = 0
    while rest[i] != "}":
        eq = rest.index("=", i)
        key = rest[i:eq].strip(", ")
        labels[key], i = _label_value(rest, eq + 2)
        while rest[i] in ", ":
            i += 1
    return name.strip(), labels, float(rest[i + 1:].split()[0])


def _parse_headline_metrics(text: str) -> Dict[str, float]:
    """A small, stable extract of a scrape: per-phase roofline and the
    frontend goodput gauge — enough for the merged view without
    shipping whole scrape bodies around.  Every family read is a gauge,
    whose one sample line per label set carries the family's name; a
    line that does not parse is skipped."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name, labels, value = _sample(line)
        except (IndexError, ValueError):
            continue
        if name in ("dynamo_engine_mfu", "dynamo_engine_mbu"):
            out[f"{name}:{labels.get('phase', '')}"] = value
        elif name in ("dynamo_frontend_slo_goodput",
                      "dynamo_engine_itl_ema_seconds",
                      # router decision attribution (kv_router.py):
                      # index-staleness + realized reuse, scraped into
                      # the merged view so a stale indexer is visible
                      # fleet-wide
                      "dynamo_router_overlap_staleness_ratio",
                      "dynamo_frontend_realized_overlap_ratio"):
            out[name] = value
    return out


async def _scrape_addr(addr: str, token: str,
                       timeout_s: float,
                       want_requests: bool = False,
                       want_kv: bool = False
                       ) -> Tuple[Optional[dict],
                                  Optional[Dict[str, float]],
                                  Optional[dict], Optional[dict], str]:
    """(debug_state, headline_metrics, forensics, kv, error) for one
    process; each surface fails independently (partial data beats
    none).  The forensics surface (/debug/requests, obs/forensics.py)
    is scraped only for frontend-bearing addresses, the KV-accounting
    surface (/debug/kv, obs/kv_ledger.py) only for worker-bearing
    ones, and NEITHER affects the live/stale classification — tail
    exemplars and ledger audits are incident context, not a health
    signal."""
    headers = {"X-Dyn-Admin-Token": token} if token else {}
    client = HttpClient(f"http://{addr}")
    debug: Optional[dict] = None
    metrics: Optional[Dict[str, float]] = None
    forensics: Optional[dict] = None
    kv: Optional[dict] = None
    errs = []
    try:
        body = await _fetch(client, "/debug/state", headers, timeout_s)
        debug = json.loads(body)
    except Exception as e:
        errs.append(f"debug/state: {type(e).__name__}: {e}")
    try:
        text = await _fetch(client, "/metrics", {}, timeout_s)
        metrics = _parse_headline_metrics(text)
    except Exception as e:
        errs.append(f"metrics: {type(e).__name__}: {e}")
    if want_requests:
        try:
            body = await _fetch(client, "/debug/requests", headers,
                               timeout_s)
            forensics = json.loads(body)
        except Exception:
            logger.debug("forensics scrape of %s failed", addr,
                         exc_info=True)
    if want_kv:
        try:
            body = await _fetch(client, "/debug/kv", headers, timeout_s)
            kv = json.loads(body)
        except Exception:
            logger.debug("kv-ledger scrape of %s failed", addr,
                         exc_info=True)
    return debug, metrics, forensics, kv, "; ".join(errs)


async def snapshot(discovery, namespace: Optional[str] = None,
                   token: Optional[str] = None,
                   timeout_s: float = 2.0) -> FleetSnapshot:
    """Discover + scrape + merge.  Never raises on a sick worker: each
    worker degrades to ``stale``/``unreachable`` individually, so one
    SIGSTOP'd process cannot blind the operator to the rest."""
    if token is None:
        token = os.environ.get("DYN_ADMIN_TOKEN", "")
    snap = await discovery.get_prefix(INSTANCE_PREFIX + "/")
    instances: List[Instance] = []
    for v in snap.values():
        try:
            inst = Instance.from_dict(v)
        except (KeyError, TypeError, ValueError):
            continue  # foreign/corrupt entry must not kill the snapshot
        if namespace and inst.namespace != namespace:
            continue
        instances.append(inst)
    # one view per instance_id (a worker registers generate + aux
    # endpoints under one id); prefer its primary endpoint's entry
    instances.sort(key=lambda i: (i.endpoint not in WORKER_ENDPOINTS,
                                  i.endpoint, i.key()))
    primary: Dict[int, Instance] = {}
    for inst in instances:
        primary.setdefault(inst.instance_id, inst)

    # quarantine markers (runtime/discovery.py QUARANTINE_PREFIX): a
    # held worker's routing keys are withdrawn, so without the marker it
    # would silently vanish from this snapshot — the marker keeps it on
    # the board as state="quarantined", and its system_addr keeps it
    # scrapeable (the process is alive by design: lease-withdrawal mark,
    # not a kill)
    qsnap = await discovery.get_prefix(QUARANTINE_PREFIX + "/")
    qrecs: List[dict] = []
    for v in qsnap.values():
        try:
            iid = int(v["instance_id"])
        except (KeyError, TypeError, ValueError):
            continue  # corrupt marker must not kill the snapshot
        if namespace and v.get("namespace") \
                and v["namespace"] != namespace:
            continue
        if iid in primary:
            continue  # readmission race: the restored live view wins
        qrecs.append(v)

    by_addr: Dict[str, List[Instance]] = {}
    for inst in primary.values():
        addr = str(inst.metadata.get("system_addr", ""))
        if addr:
            by_addr.setdefault(addr, []).append(inst)

    def _frontendish(insts: List[Instance]) -> bool:
        return any(i.endpoint == "http"
                   or i.metadata.get("kind") == "frontend"
                   for i in insts)

    def _workerish(insts: List[Instance]) -> bool:
        # any non-frontend instance at the address can carry a KV
        # ledger (co-located frontend+worker addresses scrape both)
        return any(i.endpoint != "http"
                   and i.metadata.get("kind") != "frontend"
                   for i in insts)

    # (addr -> (want_requests, want_kv)); quarantined workers scrape as
    # worker-bearing addresses
    plan: Dict[str, Tuple[bool, bool]] = {
        addr: (_frontendish(insts), _workerish(insts))
        for addr, insts in by_addr.items()}
    for rec in qrecs:
        addr = str(rec.get("system_addr", ""))
        if addr and addr not in plan:
            plan[addr] = (False, True)

    scraped: Dict[str, tuple] = {}
    if plan:
        results = await asyncio.gather(
            *(_scrape_addr(addr, token, timeout_s,
                           want_requests=fr, want_kv=wk)
              for addr, (fr, wk) in plan.items()))
        scraped = dict(zip(plan, results))

    workers: List[WorkerView] = []
    frontends: List[WorkerView] = []
    for inst in primary.values():
        addr = str(inst.metadata.get("system_addr", ""))
        view = WorkerView(
            worker_id=inst.instance_id, kind="unknown",
            namespace=inst.namespace, component=inst.component,
            endpoint=inst.endpoint, address=inst.address,
            system_addr=addr, state="unreachable",
        )
        if not addr:
            view.error = "no system_addr advertised (DYN_SYSTEM_PORT off?)"
        else:
            debug, metrics, forensics, kv, err = scraped[addr]
            view.error = err
            view.metrics = metrics or {}
            if forensics is not None:
                # ONLY this instance's forensics source (keyed
                # "frontend:<instance_id>" by the HttpService) — a
                # strict match, because co-located workers share the
                # same system_addr and must not have the frontend's
                # whole tail dump misattributed onto their views
                srcs = forensics.get("sources") or {}
                view.tail = next(
                    (v for k, v in srcs.items()
                     if k.endswith(f":{inst.instance_id}")), None)
            if kv is not None:
                # strict instance match, the same co-location rule:
                # workers key their kv source "kv:<instance_id>"
                srcs = kv.get("sources") or {}
                view.kv_ledger = next(
                    (v for k, v in srcs.items()
                     if k.endswith(f":{inst.instance_id}")), None)
            if debug is not None:
                sources = debug.get("sources", {})
                mine = next(
                    (s for s in sources.values() if isinstance(s, dict)
                     and s.get("instance_id") == inst.instance_id), None)
                view.debug = mine
                if mine is None:
                    # the process answered but doesn't claim this
                    # instance (restart race / half-registered worker)
                    view.state = "stale"
                    view.error = (view.error or
                                  "instance missing from /debug/state")
                else:
                    view.kind = str(mine.get("kind", "unknown"))
                    view.state = "live" if metrics is not None else "stale"
            elif metrics is not None:
                view.state = "stale"
        if view.endpoint == "http" or view.kind == "frontend" \
                or inst.metadata.get("kind") == "frontend":
            view.kind = view.kind if view.kind != "unknown" else "frontend"
            frontends.append(view)
        else:
            workers.append(view)

    for rec in qrecs:
        iid = int(rec["instance_id"])
        addr = str(rec.get("system_addr", ""))
        view = WorkerView(
            worker_id=iid, kind="unknown",
            namespace=str(rec.get("namespace", "")),
            component=str(rec.get("component", "")),
            endpoint="", address="", system_addr=addr,
            state="quarantined")
        if not addr:
            view.error = "no system_addr in quarantine marker"
        else:
            debug, metrics, _forensics, kv, err = scraped[addr]
            view.error = err
            view.metrics = metrics or {}
            if kv is not None:
                srcs = kv.get("sources") or {}
                view.kv_ledger = next(
                    (v for k, v in srcs.items()
                     if k.endswith(f":{iid}")), None)
            if debug is not None:
                mine = next(
                    (s for s in (debug.get("sources") or {}).values()
                     if isinstance(s, dict)
                     and s.get("instance_id") == iid), None)
                view.debug = mine
                if mine is not None:
                    view.kind = str(mine.get("kind", "unknown"))
        workers.append(view)

    # quarantined workers are ON the board but OUT of the reductions:
    # their ITL/load must not re-list them as stragglers (the planner's
    # hold owns them) nor skew imbalance for the in-rotation fleet
    summary = summarize_states(
        [w.debug for w in workers if w.debug is not None
         and w.state == "live"],
        frontend_states=[f.debug for f in frontends
                         if f.debug is not None],
        stale=sum(w.state == "stale" for w in workers),
        stale_states=[w.debug for w in workers if w.debug is not None
                      and w.state == "stale"],
        unreachable=sum(w.state == "unreachable" for w in workers),
        kv_states=[w.kv_ledger for w in workers
                   if w.kv_ledger is not None],
        quarantined=sum(w.state == "quarantined" for w in workers),
    )
    return FleetSnapshot(ts_unix=time.time(), workers=workers,
                         frontends=frontends, summary=summary)


# ---------------------------------------------------------------------------
# reduction (pure: also fed directly from in-process worker.debug_state()
# dicts)
# ---------------------------------------------------------------------------


def _g1_headroom(state: dict) -> Optional[float]:
    g1 = (state.get("kv") or {}).get("g1") or {}
    cap = g1.get("capacity", 0)
    if not cap:
        return None
    return g1.get("free", 0) / cap


def reduce_kv_ledgers(kv_states: List[dict]) -> Optional[dict]:
    """Fleet rollup of per-worker kv-ledger dumps (obs/kv_ledger.py
    /debug/kv sources): total violations by kind, per-tier occupancy
    attributed by lifecycle state, and how many workers reported.
    Pure — benches feed it worker dumps directly."""
    kv_states = [s for s in kv_states
                 if isinstance(s, dict) and s.get("enabled", True)
                 and s.get("schema") == "dynamo.kv_ledger.v1"]
    if not kv_states:
        return None
    violations: Dict[str, int] = {}
    occupancy: Dict[str, Dict[str, int]] = {}
    onboards: Dict[str, int] = {}
    g4_residency: Dict[str, int] = {}
    g4_workers = 0
    # degraded-mode fold: tier -> breaker-state -> worker count, plus
    # total integrity failures ((tier, action) quarantine/timeout rows)
    tier_states: Dict[str, Dict[str, int]] = {}
    integrity: Dict[str, int] = {}
    for s in kv_states:
        for kind, tiers in (s.get("violations_total") or {}).items():
            violations[kind] = violations.get(kind, 0) \
                + sum(int(n) for n in tiers.values())
        for tier, st in (s.get("tier_state") or {}).items():
            by_state = tier_states.setdefault(tier, {})
            by_state[st] = by_state.get(st, 0) + 1
        for key, n in (s.get("integrity") or {}).items():
            integrity[key] = integrity.get(key, 0) + int(n)
        for tier, states_ in (s.get("attribution") or {}).items():
            dst = occupancy.setdefault(tier, {})
            for state in ("active", "prefix_cached",
                          "pinned_by_transfer", "partial"):
                if state in states_:
                    dst[state] = dst.get(state, 0) + int(states_[state])
        # fleet prefix cache: onboard totals by source tier + the G4
        # lineage-residency verdicts (each worker samples its own view
        # of the shared store; the fold is a fleet-health histogram,
        # not a dedup — overlapping samples are fine for a headline)
        for tier, n in (s.get("onboards_by_tier") or {}).items():
            onboards[tier] = onboards.get(tier, 0) + int(n)
        g4 = s.get("g4")
        if isinstance(g4, dict):
            g4_workers += 1
            for verdict, n in (g4.get("residency") or {}).items():
                g4_residency[verdict] = g4_residency.get(verdict, 0) \
                    + int(n)
    out = {
        "workers_reporting": len(kv_states),
        "violations": violations,
        "violations_total": sum(violations.values()),
        "occupancy": occupancy,
    }
    if onboards:
        out["onboards_by_tier"] = onboards
    if g4_workers:
        out["g4"] = {"workers_reporting": g4_workers,
                     "residency": g4_residency}
    if tier_states:
        out["tier_state"] = tier_states
    if integrity:
        out["integrity_failures"] = integrity
    return out


def summarize_states(states: List[dict], frontend_states: List[dict] = (),
                     stale: int = 0, unreachable: int = 0,
                     stale_states: List[dict] = (),
                     kv_states: List[dict] = (),
                     quarantined: int = 0) -> dict:
    """Reduce per-worker /debug/state dicts to the fleet headline:
    imbalance, stragglers, KV headroom, recompile hotspots, drain
    states, goodput spread.  Pure — no I/O — so benches and tests feed
    it worker states directly.

    `states` are the LIVE workers (fully scraped); `stale_states` are
    dumps from partially-scraped workers — their load/KV/straggler data
    still folds into the reduction (real signal beats a blind spot) but
    they count under `stale`, not `live`, so worker counts stay disjoint
    (live + stale + unreachable + quarantined = workers).  `quarantined`
    workers are counted but NEVER folded into the load/straggler/KV
    reductions: they are out of rotation — the planner's hold owns
    them, and their outlier ITL must not re-list them as stragglers."""
    live = len(states)
    states = list(states) + list(stale_states)
    toks = [int(s.get("tokens_in_flight", 0)) for s in states]
    mean_t = sum(toks) / len(toks) if toks else 0.0
    imbalance = (max(toks) / mean_t) if mean_t > 0 else 1.0
    itls = [float(s.get("itl_p95_s", 0.0)) for s in states
            if float(s.get("itl_p95_s", 0.0)) > 0.0]
    itl_median = percentile(itls, 50.0)
    stragglers = sorted(
        s.get("instance_id") for s in states
        if itl_median > 0.0
        and float(s.get("itl_p95_s", 0.0)) > STRAGGLER_RATIO * itl_median)
    headrooms = {s.get("instance_id"): _g1_headroom(s) for s in states
                 if _g1_headroom(s) is not None}
    hotspots: Dict[str, int] = {}
    for s in states:
        for fam, st in ((s.get("compile") or {}).get("families")
                        or {}).items():
            if st.get("serving"):
                hotspots[fam] = hotspots.get(fam, 0) + int(st["serving"])
    goodputs = [float(f["slo"]["goodput"]) for f in frontend_states
                if isinstance(f.get("slo"), dict)
                and f["slo"].get("goodput") is not None]
    # router decision attribution (kv_router.py overlap_stats via the
    # frontend's debug dump): the WORST per-model staleness across all
    # frontends — the indexer-accuracy headline
    stalenesses = [
        float(st["staleness_ratio"])
        for f in frontend_states
        for st in (f.get("router") or {}).values()
        if isinstance(st, dict) and st.get("staleness_ratio") is not None]
    # tail-forensics headline (obs/forensics.py counts via debug dump)
    tails = [f["tail"] for f in frontend_states
             if isinstance(f.get("tail"), dict)]
    return {
        "workers": live + stale + unreachable + quarantined,
        "live": live,
        "stale": stale,
        "unreachable": unreachable,
        # held out of rotation by the planner's straggler quarantine
        # (discovery quarantine markers) — counted separately so the
        # fleet does not appear to SHRINK while a worker is held
        "quarantined": quarantined,
        "draining": sum(bool(s.get("draining")) for s in states),
        "active_seqs_total": sum(int(s.get("active_seqs", 0))
                                 for s in states),
        "tokens_in_flight": {
            "total": sum(toks), "max": max(toks) if toks else 0,
            "mean": round(mean_t, 3),
        },
        "imbalance": round(imbalance, 4),
        "itl_p95_median_s": round(itl_median, 6),
        "stragglers": stragglers,
        "straggler_count": len(stragglers),
        "kv_headroom_min": (round(min(headrooms.values()), 4)
                            if headrooms else 1.0),
        "serving_compile_hotspots": hotspots,
        "frontends": len(frontend_states),
        "goodput": ({"min": round(min(goodputs), 4),
                     "max": round(max(goodputs), 4),
                     "spread": round(max(goodputs) - min(goodputs), 4)}
                    if goodputs else None),
        "router_staleness_max": (round(max(stalenesses), 4)
                                 if stalenesses else None),
        "tail": ({"exemplars": sum(int(t.get("exemplars", 0))
                                   for t in tails),
                  "breaches": sum(int(t.get("breaches", 0))
                                  for t in tails)}
                 if tails else None),
        # KV-accounting rollup (obs/kv_ledger.py /debug/kv dumps):
        # per-tier occupancy attributed by state + total audit
        # violations — a nonzero violation count means kv_headroom_min
        # above cannot be trusted
        "kv_ledger": reduce_kv_ledgers(list(kv_states)),
    }


# ---------------------------------------------------------------------------
# prometheus export
# ---------------------------------------------------------------------------

# families carrying a per-instance `worker` label (the scrape-contract
# test pins this set; removal on worker departure iterates it)
PER_WORKER_FAMILIES = (
    "dynamo_fleet_up",
    "dynamo_fleet_kv_usage",
    "dynamo_fleet_kv_headroom",
    "dynamo_fleet_kv_free_blocks",
    "dynamo_fleet_active_seqs",
    "dynamo_fleet_tokens_in_flight",
    "dynamo_fleet_itl_p95_seconds",
    "dynamo_fleet_serving_compiles",
    "dynamo_fleet_draining",
)


def export_fleet_gauges(metrics, snap: FleetSnapshot,
                        prev_workers: Optional[Set[str]] = None
                        ) -> Set[str]:
    """Export a snapshot as ``dynamo_fleet_*`` gauges on a
    MetricsHierarchy.  Per-instance families carry a ``worker`` label;
    labels from workers that left the fleet are removed (a scaled-away
    worker must not freeze its last value into every future scrape).
    Returns the current worker-label set for the next call's
    `prev_workers`."""
    current: Set[str] = set()
    for w in snap.workers:
        lbl = str(w.worker_id)
        current.add(lbl)
        metrics.set("dynamo_fleet_up",
                    1.0 if w.state == "live" else 0.0,
                    "1 = worker scraped fully this snapshot",
                    worker=lbl)
        d = w.debug
        if d is None:
            continue
        metrics.set("dynamo_fleet_kv_usage",
                    float(d.get("kv_usage", 0.0)), worker=lbl)
        hr = _g1_headroom(d)
        if hr is not None:
            metrics.set("dynamo_fleet_kv_headroom", hr, worker=lbl)
            metrics.set("dynamo_fleet_kv_free_blocks",
                        float((d["kv"]["g1"]).get("free", 0)), worker=lbl)
        metrics.set("dynamo_fleet_active_seqs",
                    float(d.get("active_seqs", 0)), worker=lbl)
        metrics.set("dynamo_fleet_tokens_in_flight",
                    float(d.get("tokens_in_flight", 0)), worker=lbl)
        metrics.set("dynamo_fleet_itl_p95_seconds",
                    float(d.get("itl_p95_s", 0.0)), worker=lbl)
        metrics.set("dynamo_fleet_serving_compiles",
                    float((d.get("compile") or {}).get("serving", 0)),
                    worker=lbl)
        metrics.set("dynamo_fleet_draining",
                    1.0 if d.get("draining") else 0.0, worker=lbl)
    s = snap.summary
    for state in ("live", "stale", "unreachable", "draining",
                  "quarantined"):
        metrics.set("dynamo_fleet_workers", float(s.get(state, 0)),
                    "worker count by scrape/drain state", state=state)
    metrics.set("dynamo_fleet_load_imbalance", float(s["imbalance"]))
    metrics.set("dynamo_fleet_straggler_workers",
                float(s["straggler_count"]))
    metrics.set("dynamo_fleet_kv_headroom_min",
                float(s["kv_headroom_min"]))
    metrics.set("dynamo_fleet_frontends", float(s["frontends"]))
    if s.get("router_staleness_max") is not None:
        metrics.set("dynamo_fleet_router_staleness_max",
                    float(s["router_staleness_max"]),
                    "worst per-model router overlap-staleness ratio "
                    "across frontends (kv_router.py overlap_stats)")
    else:
        metrics.remove("dynamo_fleet_router_staleness_max")
    if s.get("tail") is not None:
        metrics.set("dynamo_fleet_tail_breaches",
                    float(s["tail"]["breaches"]),
                    "SLO-breach exemplars retained across frontends "
                    "(obs/forensics.py)")
    else:
        metrics.remove("dynamo_fleet_tail_breaches")
    if s.get("kv_ledger") is not None:
        metrics.set("dynamo_fleet_kv_violations",
                    float(s["kv_ledger"]["violations_total"]),
                    "total kv-ledger audit violations across the fleet "
                    "(obs/kv_ledger.py; nonzero = the KV headroom "
                    "signals are built on corrupted books)")
    else:
        metrics.remove("dynamo_fleet_kv_violations")
    if s.get("goodput") is not None:
        metrics.set("dynamo_fleet_goodput_spread",
                    float(s["goodput"]["spread"]))
        metrics.set("dynamo_fleet_goodput_min",
                    float(s["goodput"]["min"]))
    else:
        # all frontends gone/unscraped: drop the samples rather than
        # freeze the last spread into every future scrape (0.0 would
        # read "no spread" and a frozen min would read as live data)
        metrics.remove("dynamo_fleet_goodput_spread")
        metrics.remove("dynamo_fleet_goodput_min")
    # drop labels of departed workers
    for gone in (prev_workers or set()) - current:
        for name in PER_WORKER_FAMILIES:
            metrics.remove(name, worker=gone)
    return current


# ---------------------------------------------------------------------------
# periodic observer (planner + long-running exporters)
# ---------------------------------------------------------------------------


class FleetObserver:
    """Background snapshot refresher: planners read `.summary()` per
    tick, exporters get the gauges updated on the given hierarchy.
    Scrape failures degrade the snapshot, never the loop."""

    def __init__(self, runtime=None, discovery=None,
                 namespace: Optional[str] = None, interval_s: float = 2.0,
                 timeout_s: float = 2.0, token: Optional[str] = None,
                 metrics=None):
        if discovery is None:
            if runtime is None:
                raise ValueError("FleetObserver needs runtime= or "
                                 "discovery=")
            discovery = runtime.discovery
        self.discovery = discovery
        self.namespace = namespace
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.token = token
        self.metrics = metrics if metrics is not None else (
            runtime.metrics.scoped(component="fleet")
            if runtime is not None else None)
        self.snapshot: Optional[FleetSnapshot] = None
        self._prev_workers: Set[str] = set()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "FleetObserver":
        if self._task is None:
            self._task = asyncio.create_task(self._loop())
        return self

    async def _loop(self) -> None:
        try:
            while True:
                try:
                    await self.refresh()
                except Exception:
                    logger.warning("fleet snapshot failed; retrying",
                                   exc_info=True)
                await asyncio.sleep(self.interval_s)
        except asyncio.CancelledError:
            pass

    async def refresh(self) -> FleetSnapshot:
        snap = await snapshot(self.discovery, namespace=self.namespace,
                              token=self.token, timeout_s=self.timeout_s)
        self.snapshot = snap
        if self.metrics is not None:
            self._prev_workers = export_fleet_gauges(
                self.metrics, snap, self._prev_workers)
        return snap

    def summary(self, max_age_s: Optional[float] = None) -> Optional[dict]:
        """The latest snapshot's summary, or None when there is none OR
        it has gone stale (default: 5 refresh intervals old).  A
        discovery outage must not keep feeding the planner a frozen
        half-hour-old imbalance as if it were live."""
        if self.snapshot is None:
            return None
        if max_age_s is None:
            max_age_s = 5.0 * max(self.interval_s, self.timeout_s)
        if time.time() - self.snapshot.ts_unix > max_age_s:
            return None
        return self.snapshot.summary

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _human(snap: FleetSnapshot) -> str:
    s = snap.summary
    lines = [
        f"fleet @ {time.strftime('%H:%M:%S', time.localtime(snap.ts_unix))}"
        f"  workers={s['workers']} (live={s['live']} stale={s['stale']} "
        f"unreachable={s['unreachable']} draining={s['draining']} "
        f"quarantined={s.get('quarantined', 0)})  "
        f"frontends={s['frontends']}",
        f"  imbalance={s['imbalance']:.2f}  "
        f"stragglers={s['straggler_count']}  "
        f"kv_headroom_min={s['kv_headroom_min']:.2%}  "
        f"active_seqs={s['active_seqs_total']}",
    ]
    if s["serving_compile_hotspots"]:
        lines.append(f"  RECOMPILE HOTSPOTS: "
                     f"{s['serving_compile_hotspots']}")
    kvl = s.get("kv_ledger")
    if kvl and kvl["violations_total"]:
        lines.append(f"  KV LEDGER VIOLATIONS: {kvl['violations']}")
    hdr = (f"  {'worker':>20} {'component':>12} {'state':>12} "
           f"{'act':>5} {'kv_used':>16} {'itl_p95_ms':>10} flags")
    lines.append(hdr)
    for w in snap.workers:
        d = w.debug or {}
        g1 = (d.get("kv") or {}).get("g1") or {}
        flags = []
        if d.get("draining"):
            flags.append("draining")
        if w.worker_id in s["stragglers"]:
            flags.append("STRAGGLER")
        if w.error and w.state != "live":
            flags.append(w.error.split(";")[0][:48])
        lines.append(
            f"  {w.worker_id:>20} {w.component:>12} {w.state:>12} "
            f"{d.get('active_seqs', '-'):>5} "
            f"{g1.get('used', '-'):>7}/{g1.get('capacity', '-'):<8} "
            f"{1e3 * float(d.get('itl_p95_s', 0.0)):>10.2f} "
            f"{' '.join(flags)}")
    for f in snap.frontends:
        d = f.debug or {}
        slo = d.get("slo") or {}
        lines.append(
            f"  {f.worker_id:>20} {'frontend':>12} {f.state:>12} "
            f"{d.get('inflight', '-'):>5} "
            f"goodput={slo.get('goodput', '-')} "
            f"models={','.join(d.get('models', []))}")
    return "\n".join(lines)


async def _amain(args: argparse.Namespace) -> int:
    from ..runtime.config import RuntimeConfig
    from ..runtime.discovery import make_discovery

    cfg = RuntimeConfig.from_env()
    # read_only: the CLI observes, it must never reap lease files —
    # run it with the FLEET'S DYN_LEASE_TTL (a shorter TTL here hides
    # workers whose heartbeat period exceeds it)
    disco = make_discovery(
        cfg.discovery_backend, path=cfg.discovery_path,
        ttl_s=cfg.lease_ttl_s,
        cluster_id=os.environ.get("DYN_CLUSTER_ID", "default"),
        etcd_endpoint=cfg.etcd_endpoint, read_only=True)
    await disco.start()
    try:
        while True:
            snap = await snapshot(disco, namespace=args.namespace or None,
                                  timeout_s=args.timeout_s)
            if args.json:
                print(json.dumps(snap.to_dict(), default=repr), flush=True)
            else:
                print(_human(snap), flush=True)
            if not args.watch:
                break
            await asyncio.sleep(args.interval)
    finally:
        await disco.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        "dynamo_tpu_torch.obs.fleet",
        description="one-shot or watching fleet snapshot: discovery-"
                    "driven scrape of every instance's /metrics + "
                    "/debug/state (DYN_ADMIN_TOKEN), merged into per-"
                    "worker KV/load/health plus imbalance, straggler, "
                    "and headroom signals")
    p.add_argument("--json", action="store_true",
                   help="machine output: one JSON snapshot per line")
    p.add_argument("--watch", action="store_true",
                   help="keep snapshotting every --interval seconds")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--namespace", default="",
                   help="restrict to one namespace (default: all)")
    p.add_argument("--timeout-s", type=float, default=2.0,
                   help="per-surface scrape timeout before a worker is "
                        "marked stale/unreachable")
    args = p.parse_args(argv)
    try:
        return asyncio.run(_amain(args))
    except BrokenPipeError:
        # stdout consumer (head, a closed pager) went away mid-print —
        # normal CLI lifecycle, not an error
        import sys

        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    raise SystemExit(main())

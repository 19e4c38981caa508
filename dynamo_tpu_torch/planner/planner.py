"""The planner control loop: PROPOSE + RECONCILE around observe/predict.

A copy of dynamo_tpu/planner/planner.py without its chaos seam.  Per
tick:

  1. OBSERVE   aggregate fleet load (planner/metrics.py) + the fleet
               introspection summary (obs/fleet.py) + the frontend SLO
               plane's goodput/burn (obs/slo.py via SloObserver)
  2. PREDICT   next-window active sequences (planner/predictor.py)
  3. PROPOSE   replicas = ceil(predicted / target_active_per_replica)
               (or the SLA perf-model inversion against a profile the
               profiler took); KV pressure forces +1; a FAST SLO BURN
               (threshold `burn_up_threshold`, phase-attributed: TTFT
               burn → prefill pools, ITL burn → decode pools) forces
               scale-up AHEAD of the predictor
  4. RECONCILE clamp to [min, max], one scale step per cooldown window,
               scale down only after `down_stable_ticks` consecutive
               under-target observations (down is cheap to delay, up is
               not); straggler quarantine reconciles here too
               (lease-withdrawal mark + hold + canary re-probe)
  5. EXECUTE   connector.scale(n) up / connector.drain(n) down (the
               drain-gated path: victims' routing identity withdrawn,
               in-flight streams finish or migrate via token replay,
               hard stop last) — every actuation counted in
               ``dynamo_planner_actuations_total{kind}``

Actuation kinds (the `dynamo_planner_*` vocabulary): ``scale_up``,
``scale_down``, ``burn_up`` (a scale_up forced by burn), ``quarantine``,
``requarantine``, ``readmit``, ``breaker_open``.  The tick's view is on
the runtime's /debug/state under ``planner:{component}``.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from .. import obs
from .connectors import Connector
from .metrics import FpmObserver, LoadObserver, SloObserver
from .predictor import make_predictor

logger = logging.getLogger(__name__)

# which SLO breach reasons actuate which planner phase: a planner
# instance scaling a disagg prefill pool must not scale on decode-side
# ITL burn and vice versa — this split is what makes the P/D ratio
# CONTROLLED instead of both pools chasing total burn
PHASE_BURN_REASONS = {
    "prefill": ("ttft",),
    "decode": ("itl",),
}


@dataclass
class PlannerConfig:
    interval_s: float = 2.0
    min_replicas: int = 1
    max_replicas: int = 8
    # capacity target: sustained active sequences one replica should carry
    target_active_per_replica: float = 4.0
    # KV pressure: mean usage above this proposes one extra replica
    kv_pressure_threshold: float = 0.85
    cooldown_s: float = 5.0          # min seconds between scale actions
    max_step: int = 2                # max replica delta per action
    down_stable_ticks: int = 3       # consecutive low ticks before down
    predictor: str = "ema"
    predictor_window: int = 8
    # -- SLA mode (ref planner-design.md "Throughput-Based Scaling"):
    # PROPOSE inverts a profiled perf model under latency targets instead
    # of a fixed active-per-replica constant.  Requires a perf model
    # (PerfModel instance or perf_model_path profile JSON).
    mode: str = "load"               # "load" | "sla"
    ttft_target_s: Optional[float] = None
    itl_target_s: Optional[float] = None
    perf_model_path: Optional[str] = None
    # consume the workers' forward-pass-metrics stream (fpm.{ns}.{comp})
    # for the online perf-model regression: per-program dispatch records
    # beat the 0.5s itl_ema_s scalar both in freshness and in resolution
    consume_fpm: bool = True
    # -- burn-rate actuation (obs/slo.py burn_by_phase): a fast burn at
    # or past this threshold forces +1 replica ahead of the load
    # predictor (0 disables).  2.0 = burning the error budget at twice
    # the allowed rate — the classic fast-burn page threshold.
    burn_up_threshold: float = 2.0
    # which disagg pool this planner instance scales: "" (whole fleet —
    # any burn actuates), "prefill" (TTFT burn only), "decode" (ITL
    # burn only).  One planner per pool is the disagg deployment shape;
    # the phase split is what controls the P/D ratio.
    phase: str = ""
    # -- drain-gated scale-down: EXECUTE scale-downs through
    # connector.drain() (victims' leases withdrawn, bounded in-flight
    # grace, migration for the rest) instead of a hard stop
    drain_on_scale_down: bool = True
    # -- straggler quarantine (the fleet_straggler actuation): drain the
    # ITL-p95 outlier out of rotation (lease-withdrawal mark, not a
    # process kill), hold, canary re-probe, readmit.  Requires fleet=.
    quarantine: bool = True
    quarantine_hold_s: float = 30.0     # readmission delay rule
    # hysteresis: each re-quarantine of the same worker (and each failed
    # readmission probe) multiplies its hold — a flapping worker decays
    # out of rotation instead of oscillating through it
    quarantine_flap_factor: float = 2.0
    # never hold more than this fraction of the fleet (and never the
    # last worker): quarantine sheds a sick MINORITY; a majority-slow
    # fleet is a capacity problem the scale loop owns
    quarantine_max_frac: float = 0.34
    quarantine_probe: bool = True       # canary re-probe before readmit
    quarantine_probe_timeout_s: float = 5.0


@dataclass
class QuarantineEntry:
    keys: Dict[str, dict]       # withdrawn discovery keys (the stash)
    until: float                # monotonic readmission time
    hold_s: float               # current hold (grows on flap)
    since: float = dc_field(default_factory=time.monotonic)


class StragglerQuarantine:
    """The fleet_straggler actuation: pull an ITL-p95 outlier out of
    rotation by withdrawing its discovery keys (instance + MDC — the
    same identity a graceful drain withdraws), hold it for a delay
    rule, canary re-probe, and readmit by restoring the stash.

    The worker process is NEVER touched: its load loop, debug surface
    and engine keep running — routers just stop seeing it, so in-flight
    work finishes normally and the worker stays probeable.  Flapping is
    guarded by hysteresis: every re-quarantine of the same worker (and
    every failed readmission probe) multiplies its hold by
    ``flap_factor``, so a persistently sick worker decays out of
    rotation instead of oscillating through it."""

    def __init__(self, discovery, *, namespace: str, component: str,
                 hold_s: float = 30.0, flap_factor: float = 2.0,
                 max_frac: float = 0.34, probe: bool = True,
                 probe_timeout_s: float = 5.0,
                 strike_ttl_s: float = 3600.0, runtime=None):
        self.discovery = discovery
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.hold_s = hold_s
        self.flap_factor = flap_factor
        self.max_frac = max_frac
        self.probe = probe
        self.probe_timeout_s = probe_timeout_s
        self.held: Dict[int, QuarantineEntry] = {}
        # strikes per instance: survives readmission, so a repeat
        # offender's next hold starts longer (the hysteresis) — but NOT
        # forever: entries idle past strike_ttl_s are pruned (restarted
        # workers get fresh random instance ids, so a long-lived planner
        # would otherwise accrete a strike per id that ever straggled)
        self.strikes: Dict[int, int] = {}
        self.strike_ttl_s = strike_ttl_s
        self._strike_t: Dict[int, float] = {}
        self.events: deque = deque(maxlen=256)

    def _cap(self, fleet_size: int) -> int:
        """Max workers held at once: ≤ max_frac of the fleet, never the
        last worker, but at least 1 once there is a worker to spare."""
        if fleet_size <= 1:
            return 0
        return min(fleet_size - 1,
                   max(1, int(fleet_size * self.max_frac)))

    async def _reprobe(self, instance_id: int) -> Optional[bool]:
        """Canary re-probe through the quarantined worker's own handler
        (in-process fleets); None = unprobeable from here (subprocess/
        remote worker) — the delay rule alone decides."""
        if not self.probe or self.runtime is None:
            return None
        from ..protocols.llm import CANARY_GENERATE_PAYLOAD
        from ..runtime.health_check import probe_endpoint

        path = f"{self.namespace}/{self.component}/generate"
        return await probe_endpoint(
            self.runtime, path, instance_id,
            dict(CANARY_GENERATE_PAYLOAD), self.probe_timeout_s)

    async def _mark(self, iid: int, e: QuarantineEntry,
                    strikes: int) -> None:
        """Best-effort quarantine breadcrumb (runtime/discovery.py
        QUARANTINE_PREFIX): keeps the withdrawn worker VISIBLE — the
        fleet aggregator (obs/fleet.py) reads the marker, reports the
        worker as state="quarantined" and keeps scraping it via the
        stashed system_addr instead of letting it silently vanish from
        the board."""
        from ..runtime.discovery import mark_quarantined

        try:
            await mark_quarantined(
                self.discovery, iid, e.keys,
                {"hold_s": round(e.hold_s, 3), "strikes": strikes,
                 "held_by": self.component})
        except Exception:  # the mark must never fail the actuation
            logger.warning("failed to publish quarantine marker for %d",
                           iid, exc_info=True)

    async def _unmark(self, iid: int) -> None:
        from ..runtime.discovery import unmark_quarantined

        try:
            await unmark_quarantined(self.discovery, iid)
        except Exception:
            logger.warning("failed to clear quarantine marker for %d",
                           iid, exc_info=True)

    async def reconcile(self, fleet_summary: dict,
                        now: Optional[float] = None) -> List[dict]:
        """One quarantine pass against the tick's fleet summary;
        returns the actions taken (kind: quarantine | requarantine |
        readmit).  Quarantined workers' ROUTING keys are gone, so
        `stragglers` never re-lists a held worker and `live` counts
        only the in-rotation fleet — but each held worker leaves a
        quarantine marker behind, so the fleet board still shows it."""
        from ..runtime.discovery import (restore_instance,
                                         withdraw_instance)

        now = time.monotonic() if now is None else now
        actions: List[dict] = []
        # readmission pass first: frees quarantine capacity for new
        # stragglers within the same tick
        for iid in list(self.held):
            e = self.held[iid]
            if now < e.until:
                continue
            ok = await self._reprobe(iid)
            if ok is False:
                # still sick: hold longer (hysteresis), keep the stash
                e.hold_s *= self.flap_factor
                e.until = now + e.hold_s
                self._strike_t[iid] = now  # hysteresis stays fresh
                actions.append({"kind": "requarantine", "worker": iid,
                                "hold_s": round(e.hold_s, 3)})
                await self._mark(iid, e, self.strikes.get(iid, 1))
                logger.warning(
                    "quarantine re-probe failed for worker %d; holding "
                    "another %.1fs", iid, e.hold_s)
                continue
            await restore_instance(self.discovery, e.keys)
            del self.held[iid]
            await self._unmark(iid)
            # strike decay clocks from the END of the hold: a worker
            # that flapped through a hold longer than strike_ttl_s must
            # not lose its hysteresis the tick after readmission
            if iid in self._strike_t:
                self._strike_t[iid] = now
            actions.append({"kind": "readmit", "worker": iid})
            logger.warning("readmitted worker %d from quarantine "
                           "(probe=%s)", iid, ok)
        # quarantine pass
        fleet_size = int(fleet_summary.get("live", 0)) + len(self.held)
        for iid in fleet_summary.get("stragglers") or ():
            if iid is None or iid in self.held:
                continue
            if len(self.held) >= self._cap(fleet_size):
                logger.warning(
                    "straggler %s NOT quarantined: cap %d/%d held "
                    "(fleet %d)", iid, len(self.held),
                    self._cap(fleet_size), fleet_size)
                break
            keys = await withdraw_instance(self.discovery, int(iid))
            if not keys:
                continue  # already gone: raced a drain/crash
            strikes = self.strikes.get(iid, 0) + 1
            self.strikes[iid] = strikes
            self._strike_t[iid] = now
            hold = self.hold_s * (self.flap_factor ** (strikes - 1))
            entry = QuarantineEntry(keys=keys, until=now + hold,
                                    hold_s=hold)
            self.held[int(iid)] = entry
            await self._mark(int(iid), entry, strikes)
            actions.append({"kind": "quarantine", "worker": iid,
                            "hold_s": round(hold, 3),
                            "strikes": strikes})
            logger.warning(
                "quarantined straggler worker %s for %.1fs (strike %d, "
                "%d keys withdrawn)", iid, hold, strikes, len(keys))
        # hysteresis expiry: strike history for ids idle past the TTL
        # (not currently held) is dropped — restarted workers mint fresh
        # random ids, so without pruning a long-lived planner's strike
        # map grows one entry per id that ever straggled
        for iid in [i for i, t in self._strike_t.items()
                    if i not in self.held
                    and now - t > self.strike_ttl_s]:
            del self._strike_t[iid]
            self.strikes.pop(iid, None)
        for a in actions:
            self.events.append({"t": now, **a})
        return actions

    async def release_all(self) -> None:
        """Planner shutdown: restore every held worker — a dead planner
        must not leave the fleet smaller than it found it."""
        from ..runtime.discovery import restore_instance

        for iid in list(self.held):
            try:
                await restore_instance(self.discovery,
                                       self.held.pop(iid).keys)
                await self._unmark(iid)
            except Exception:
                logger.exception("failed to restore quarantined worker "
                                 "%d at shutdown", iid)

    def state(self) -> dict:
        now = time.monotonic()
        return {
            "held": {str(i): {"hold_s": round(e.hold_s, 3),
                              "remaining_s": round(max(0.0, e.until - now),
                                                   3),
                              "keys": len(e.keys)}
                     for i, e in self.held.items()},
            "strikes": {str(i): n for i, n in self.strikes.items()},
            "events": list(self.events)[-16:],
        }


class Planner:
    def __init__(self, runtime, namespace: str, component: str,
                 connector: Connector,
                 config: Optional[PlannerConfig] = None,
                 perf_model=None, fleet=None):
        """fleet: an obs.fleet.FleetObserver (or anything with a
        ``summary() -> dict|None``) whose snapshot the tick folds into
        diag — the imbalance/straggler/KV-headroom inputs the SLA
        controller and the quarantine read."""
        self.config = config or PlannerConfig()
        if self.config.phase not in ("", "prefill", "decode"):
            raise ValueError(
                f"unknown planner phase {self.config.phase!r}: expected "
                f"'', 'prefill' or 'decode'")
        self.namespace = namespace
        self.component = component
        self.runtime = runtime
        self.observer = LoadObserver(runtime, namespace, component)
        self.fpm: Optional[FpmObserver] = (
            FpmObserver(runtime, namespace, component)
            if self.config.consume_fpm else None)
        # frontend SLO telemetry (obs/slo.py publish): goodput/burn-rate
        # measured at the client edge — the breach signal the SLA
        # controller actuates on
        self.slo: Optional[SloObserver] = (
            SloObserver(runtime, namespace) if runtime is not None
            else None)
        self.predictor = make_predictor(self.config.predictor,
                                        self.config.predictor_window)
        # second forecast stream for SLA mode: request arrival rate
        self.rate_predictor = make_predictor(self.config.predictor,
                                             self.config.predictor_window)
        self.perf_model = perf_model
        if self.perf_model is None and self.config.perf_model_path:
            from .perf_model import PerfModel
            self.perf_model = PerfModel.load(self.config.perf_model_path)
        if self.config.mode == "sla":
            if self.perf_model is None:
                raise ValueError("sla mode requires a perf model "
                                 "(perf_model= or perf_model_path=)")
            if not (self.config.itl_target_s or self.config.ttft_target_s):
                raise ValueError("sla mode requires at least one of "
                                 "itl_target_s / ttft_target_s")
        self.connector = connector
        self.fleet = fleet
        # actuation metric surface (dynamo_planner_* counters/gauges);
        # None on runtime-less bare planners (unit tests)
        self.m = (runtime.metrics.scoped(component="planner")
                  if runtime is not None else None)
        # straggler quarantine (the fleet_straggler actuation): only
        # meaningful with a fleet observer feeding straggler lists, but
        # constructed whenever a runtime gives us discovery access
        self.quarantine: Optional[StragglerQuarantine] = (
            StragglerQuarantine(
                runtime.discovery, namespace=namespace,
                component=component, runtime=runtime,
                hold_s=self.config.quarantine_hold_s,
                flap_factor=self.config.quarantine_flap_factor,
                max_frac=self.config.quarantine_max_frac,
                probe=self.config.quarantine_probe,
                probe_timeout_s=self.config.quarantine_probe_timeout_s)
            if runtime is not None and self.config.quarantine else None)
        # last tick's full diag (fleet signals included), action or not:
        # operators and tests read the tick's view here — `decisions`
        # only records ticks that actually scaled
        self.last_diag: dict = {}
        self._task: Optional[asyncio.Task] = None
        self._last_action_t = 0.0
        self._low_ticks = 0
        # serving-compile count at the last storm warning: re-warn only
        # when NEW mid-serving compiles appear, not per tick while one
        # event ages through the FPM window
        self._storm_warned = 0
        # breaker-open transitions already flight-dumped/counted
        self._breaker_seen = 0
        # audit trail (observability); bounded like the predictor window
        self.decisions: deque = deque(maxlen=256)
        # control-plane introspection on /debug/state (runtime/
        # system_status.py): the tick's last view, recent decisions,
        # quarantine + spawn-governor state
        self._debug_source_name: Optional[str] = None
        if runtime is not None:
            self._debug_source_name = f"planner:{component}"
            runtime.register_debug_source(self._debug_source_name,
                                          self.debug_state)

    def debug_state(self) -> dict:
        gov = getattr(self.connector, "governor", None)
        return {
            "kind": "planner",
            "namespace": self.namespace,
            "component": self.component,
            "mode": self.config.mode,
            "phase": self.config.phase,
            "last_diag": dict(self.last_diag),
            "decisions": list(self.decisions)[-8:],
            "quarantine": (self.quarantine.state()
                           if self.quarantine is not None else None),
            "spawn": gov.state() if gov is not None else None,
            "drain_escalations": getattr(self.connector,
                                         "drain_escalations", 0),
        }

    async def start(self) -> "Planner":
        await self.observer.start()
        if self.fpm is not None:
            await self.fpm.start()
        if self.slo is not None:
            await self.slo.start()
        self._task = asyncio.create_task(self._loop())
        return self

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self.fpm is not None:
            await self.fpm.close()
        if self.slo is not None:
            await self.slo.close()
        if self.quarantine is not None:
            # a dying planner must not leave held workers invisible
            await self.quarantine.release_all()
        if self._debug_source_name is not None:
            try:
                self.runtime.unregister_debug_source(
                    self._debug_source_name)
            except Exception:  # pragma: no cover - best effort
                pass
            self._debug_source_name = None
        await self.observer.close()

    async def _loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.config.interval_s)
                try:
                    await self.tick()
                except Exception:
                    logger.exception("planner tick failed")
        except asyncio.CancelledError:
            pass

    def _count(self, kind: str) -> None:
        """dynamo_planner_actuations_total{kind}: every actuation the
        loop takes is countable, so 'did the planner act on X' is a
        metrics query, not a log grep."""
        m = getattr(self, "m", None)
        if m is not None:
            m.inc("dynamo_planner_actuations_total",
                  doc="planner actuations by kind: scale_up / scale_down "
                      "/ burn_up / quarantine / requarantine / readmit / "
                      "breaker_open", kind=kind)

    def _burn_for_phase(self, slo: dict) -> float:
        """The burn rate that actuates THIS planner's pool: a
        phase-scoped planner (disagg) reads only its pool's breach
        reason; a whole-fleet planner reads the worst burn of any
        kind (errors included — an errored request burns budget
        regardless of phase)."""
        reasons = PHASE_BURN_REASONS.get(self.config.phase)
        if reasons is None:
            return float(slo.get("max_burn", 0.0))
        phases = slo.get("burn_by_phase") or {}
        return max((float(phases.get(r, 0.0)) for r in reasons),
                   default=0.0)

    async def tick(self) -> Optional[int]:
        """One control iteration; returns the applied replica count if a
        scale action was taken, else None."""
        c = self.config
        load = self.observer.aggregate()
        current = await self.connector.current_replicas()
        if current > 0 and load.workers == 0:
            # replicas exist but none are reporting: telemetry loss (or
            # workers still booting), not zero load.  HOLD — scaling down a
            # busy fleet on lost metrics kills mid-flight requests.
            logger.warning("planner: %d replicas but no load samples; "
                           "holding", current)
            return None
        self.predictor.observe(float(load.active_seqs))
        predicted = self.predictor.predict()
        diag = {}
        burn_forced = False

        if c.mode == "sla":
            proposed = self._propose_sla(load, predicted, diag)
        else:
            proposed = math.ceil(predicted / c.target_active_per_replica)
        # fleet introspection plane (obs/fleet.py): the merged-scrape
        # signals the SLA controller and the KV-aware cost function
        # read — imbalance says load is skewed even when the mean looks
        # fine, headroom says where admission will park next, a
        # straggler says p95 will breach before the mean ITL moves
        fleet = getattr(self, "fleet", None)  # tests build bare planners
        fs = fleet.summary() if fleet is not None else None
        if fs is not None:
            diag["fleet_imbalance"] = fs["imbalance"]
            diag["fleet_straggler"] = fs["straggler_count"]
            diag["fleet_kv_headroom"] = fs["kv_headroom_min"]
            if fs.get("unreachable"):
                diag["fleet_unreachable"] = fs["unreachable"]
            if fs.get("draining"):
                diag["fleet_draining"] = fs["draining"]
        # straggler quarantine: drain the ITL-p95 outliers out of
        # rotation (lease-withdrawal mark), hold + re-probe + readmit
        await self._quarantine_step(fs, diag)
        # frontend SLO plane: goodput/burn measured at the client edge.
        # A FAST BURN forces scale-up ahead of the load predictor — the
        # predictor needs a window of worse load to move, but a burn
        # says users are ALREADY missing the SLO now.  Phase-attributed
        # (obs/slo.py): TTFT burn actuates prefill pools, ITL burn
        # decode pools, so the disagg P/D ratio is controlled instead
        # of both pools chasing total burn.
        slo = (self.slo.aggregate()
               if getattr(self, "slo", None) is not None else None)
        if slo is not None:
            diag["slo_goodput"] = slo["goodput"]
            diag["slo_burn"] = slo["max_burn"]
            if slo.get("burn_by_phase"):
                diag["slo_burn_by_phase"] = slo["burn_by_phase"]
            burn = self._burn_for_phase(slo)
            if c.burn_up_threshold and burn >= c.burn_up_threshold \
                    and current < c.max_replicas and proposed <= current:
                proposed = current + 1
                burn_forced = True
                diag["burn_actuation"] = {
                    "burn": round(burn, 4),
                    "phase": c.phase or "any",
                    "threshold": c.burn_up_threshold,
                }
                logger.warning(
                    "planner: fast SLO burn %.2f ≥ %.2f (%s) — forcing "
                    "scale-up %d->%d ahead of the predictor", burn,
                    c.burn_up_threshold, c.phase or "any", current,
                    proposed)
        # spawn governor visibility (connector backoff/breaker): the
        # crashloop guard's state rides every tick's diag, and a breaker
        # OPEN transition is flight-dumped + counted exactly once
        self._governor_step(diag)
        self.last_diag = diag
        if load.workers and load.mean_kv_usage >= c.kv_pressure_threshold:
            proposed += 1
        # min_replicas=0 is scale-to-zero: the floor comes only from config
        proposed = max(c.min_replicas, min(c.max_replicas, proposed))

        # RECONCILE
        held = (len(self.quarantine.held)
                if getattr(self, "quarantine", None) is not None else 0)
        if held and proposed < current:
            # the quarantine owns the held capacity: a held worker keeps
            # publishing near-idle load (its process runs by design), so
            # acting on the dip would drain a HEALTHY worker and halve
            # effective capacity exactly while the fleet is degraded.
            # Scale-down waits for the hold to resolve; scale-UP stays
            # armed (burn actuates if the lost capacity breaches SLO).
            diag["scale_down_held_by_quarantine"] = held
            self._low_ticks = 0
            return None
        if proposed < current:
            self._low_ticks += 1
            if self._low_ticks < c.down_stable_ticks:
                return None
        else:
            self._low_ticks = 0
        if proposed == current:
            return None
        now = time.monotonic()
        if now - self._last_action_t < c.cooldown_s:
            return None
        step = max(-c.max_step, min(c.max_step, proposed - current))
        target = current + step

        # EXECUTE (an actuation that raises fails this tick; the loop
        # retries next tick since _last_action_t only advances after the
        # connector call returns)
        drain = (getattr(self.connector, "drain", None)
                 if c.drain_on_scale_down else None)
        if target < current and drain is not None:
            # drain-gated scale-down: victims' routing identity is
            # withdrawn first, in-flight streams finish or migrate via
            # token replay, the hard stop lands last — token-identical
            # to a fault-free run
            applied = await drain(target)
        else:
            applied = await self.connector.scale(target)
        if applied == current:
            # EXECUTE moved nothing (spawn governor backing off / breaker
            # open): NOT an actuation — no counter, no decision, and the
            # cooldown is not consumed, so the next tick retries the
            # moment the governor allows
            logger.warning("planner: EXECUTE %d->%d applied nothing "
                           "(spawn blocked?)", current, target)
            return None
        self._count("scale_down" if applied < current else "scale_up")
        if burn_forced and applied > current:
            # the burn actuation is counted when it LANDS, not while the
            # forced proposal waits out a cooldown
            self._count("burn_up")
        self._last_action_t = now
        self._low_ticks = 0  # hysteresis restarts after every action
        decision = {
            "t": now, "observed_active": load.active_seqs,
            "predicted": predicted, "kv_usage": load.mean_kv_usage,
            "current": current, "proposed": proposed, "applied": applied,
            **diag,
        }
        self.decisions.append(decision)
        logger.info("planner: active=%d predicted=%.1f kv=%.2f %d->%d",
                    load.active_seqs, predicted, load.mean_kv_usage,
                    current, applied)
        return applied

    async def _quarantine_step(self, fs: Optional[dict],
                               diag: dict) -> None:
        q = getattr(self, "quarantine", None)
        if q is None or fs is None:
            return
        try:
            actions = await q.reconcile(fs)
        except Exception:
            # quarantine must never take the scale loop down with it
            logger.exception("quarantine reconcile failed")
            actions = []
        for a in actions:
            self._count(a["kind"])
            if a["kind"] in ("quarantine", "requarantine"):
                # post-mortem: the spans that led up to the outlier call
                obs.flight_dump(f"planner.{a['kind']}")
        if actions:
            diag["quarantine_actions"] = actions
        if q.held:
            diag["quarantined"] = sorted(q.held)
        m = getattr(self, "m", None)
        if m is not None:
            m.set("dynamo_planner_quarantined_workers", float(len(q.held)),
                  "workers currently held out of rotation by the "
                  "straggler quarantine")

    def _governor_step(self, diag: dict) -> None:
        gov = getattr(self.connector, "governor", None)
        if gov is None:
            return
        st = gov.state()
        if st["failures_total"] or st["breaker_open"]:
            diag["spawn"] = st
        esc = getattr(self.connector, "drain_escalations", 0)
        if esc:
            diag["drain_escalations"] = esc
        m = getattr(self, "m", None)
        if m is not None:
            m.set("dynamo_planner_spawn_failures",
                  float(st["failures_total"]),
                  "cumulative replica spawn failures (boot crashes "
                  "included) seen by the connector's governor")
            m.set("dynamo_planner_spawn_breaker_open",
                  1.0 if st["breaker_open"] else 0.0,
                  "1 while the spawn circuit breaker refuses respawns")
            m.set("dynamo_planner_spawn_backoff_seconds",
                  float(st["backoff_remaining_s"]),
                  "seconds until the governor allows the next spawn")
            m.set("dynamo_planner_drain_escalations",
                  float(esc),
                  "scale-down victims that ignored drain and were "
                  "escalated to a hard stop")
        if st["breaker_opens_total"] > getattr(self, "_breaker_seen", 0):
            # the OPEN transition, exactly once per trip
            self._breaker_seen = st["breaker_opens_total"]
            self._count("breaker_open")
            obs.flight_dump("planner.breaker")
            logger.error(
                "planner: spawn circuit breaker OPEN (%s) — a worker "
                "is crashlooping at boot; respawns paused", st)

    def _propose_sla(self, load, predicted_active: float, diag: dict) -> int:
        """SLA PROPOSE: invert the perf model under TTFT/ITL targets.

        decode bound — replicas so per-replica concurrency keeps
        estimated ITL <= target;
        prefill/TTFT bound — replicas so per-replica request rate stays
        within the profiled rate that holds TTFT <= target at the
        observed ISL.  The larger bound wins (on a disagg fleet each
        planner instance watches its own component, so only the relevant
        bound binds).  Ref: planner-design.md Steps 3-4."""
        c = self.config
        pm = self.perf_model
        isl = load.mean_isl or None
        # profile fidelity: an ITL surface measured at one KV storage
        # dtype must not silently steer a fleet serving the other
        # (int8 halves decode HBM traffic and ~doubles the block pool)
        mismatched = pm.check_kv_dtype(load.kv_dtypes)
        if mismatched:
            diag["kv_dtype_mismatch"] = {
                "profile": pm.kv_cache_dtype, "workers": mismatched}
        # online correction from live decode latency: prefer the FPM
        # stream's per-program dispatch gaps; fall back to the coarse
        # itl_ema_s scalar in load_metrics
        fpm_itl = self.fpm.decode_itl_s() if self.fpm is not None else 0.0
        measured = fpm_itl or load.mean_itl_s
        if measured > 0 and load.workers and load.active_seqs:
            pm.observe_itl(load.active_per_worker, measured, isl)
            diag["fpm_itl_s"] = fpm_itl
        if self.fpm is not None:
            # prefill-pressure diagnostics off the same stream: phase MFU
            # (workers emit it when their config pins peak_tflops) and
            # chunk-queue depth — surfaced per tick so operators can see
            # a prefill-bound fleet even while the ITL bound is quiet
            mfu = self.fpm.prefill_mfu()
            depth = self.fpm.prefill_queue_depth()
            if mfu:
                diag["prefill_mfu"] = mfu
            if depth:
                diag["prefill_queue_depth"] = depth
            # speculative-decoding acceptance off the same stream: a
            # fleet whose acceptance sags decodes more passes per token,
            # which shows up here before it shows up in ITL.  None =
            # idle; a real 0.0 (total rejection) IS the regression and
            # must appear in the tick
            spec = self.fpm.spec_acceptance()
            if spec is not None:
                diag["spec_acceptance"] = spec
            # compile watchdog off the same stream: steady-state
            # recompiles stall every in-flight request for the compile's
            # full wall time while staying invisible to token metrics —
            # repeated serving-time compiles in one window are a storm
            # (a shape leaking past warmup) the operator must see here
            comp = self.fpm.compile_stats()
            if comp["total"]:
                diag["compiles"] = comp["families"]
            if comp["serving"]:
                diag["recompile_storm"] = {
                    "serving_compiles": comp["serving"],
                    # only families whose compiles landed MID-SERVING:
                    # a restarting worker's warmup programs share the
                    # window and must not be named as culprits
                    "families": sorted(
                        f for f, v in comp["families"].items()
                        if v.get("serving")),
                }
                # warn when NEW serving compiles appeared, not on every
                # tick the same event spends inside the 20s window
                if comp["serving"] > self._storm_warned:
                    logger.warning(
                        "planner: %d compile(s) landed mid-serving "
                        "this window (%s) — warmup is not covering a "
                        "served shape", comp["serving"],
                        diag["recompile_storm"])
                self._storm_warned = comp["serving"]
            else:
                self._storm_warned = 0
        # (frontend SLO goodput/burn now folds in at tick() level — the
        # burn actuation applies to load mode too, not just SLA mode)

        # decode bound: ITL capacity when targeted, else the load-mode
        # constant — an arrival lull must never scale away a fleet that is
        # still busy decoding long sequences
        if c.itl_target_s:
            cap = pm.max_active_for_itl(c.itl_target_s, isl)
            diag["itl_capacity"] = cap
        else:
            cap = c.target_active_per_replica
        n_itl = math.ceil(predicted_active / cap) if predicted_active else 0

        self.rate_predictor.observe(load.req_per_s)
        pred_rate = self.rate_predictor.predict()
        n_ttft = 0
        if c.ttft_target_s and pred_rate > 0:
            rps_cap = pm.max_rps_for_ttft(isl or 512.0, c.ttft_target_s)
            n_ttft = math.ceil(pred_rate / rps_cap)
            diag["ttft_rps_capacity"] = rps_cap
        diag.update(pred_req_rate=pred_rate, mean_isl=load.mean_isl,
                    n_itl=n_itl, n_ttft=n_ttft,
                    itl_correction=pm.itl_correction)
        return max(n_itl, n_ttft)

"""KvRouter: KV-cache-aware instance selection.

A copy of dynamo_tpu/router/kv_router.py on the port's runtime: the
same subjects, replay requests, decisions and `dynamo_router_*`
metric families, so a torch frontend routes as the JAX one does.

Ref: lib/llm/src/kv_router.rs:201 (find_best_match) + kv_router/scheduler.rs.
Subscribes to the KV event stream and per-worker load metrics, maintains the
indexer + slot manager, and picks the best worker for each request:

    overlap = indexer.find_matches(request PLHs)       (hot loop #1)
    logit   = overlap_weight*(blocks-overlap) + active_blocks
    pick    = argmin / softmax-temperature sample

Event-stream gaps are recovered through the worker's `kv_events_replay`
endpoint; dead workers (instance delete) are purged from the index.
Implements the frontend's route-hook protocol: awaitable pick(request, avoid)
plus completion callbacks for slot accounting.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from ..protocols import ModelDeploymentCard, PreprocessedRequest
from ..runtime import Client, DistributedRuntime
from ..tokens import compute_block_hashes_for_request
from .events import KvCacheEvent, kv_event_subject
from .indexer import indexer_impl
from .replica_sync import RouterReplicaSync
from .selector import DefaultWorkerSelector, KvRouterConfig, WorkerState
from .tiered_index import make_tiered_indexer
from .sequences import ActiveSequences
from .targets import TargetMap

logger = logging.getLogger(__name__)


class KvRouter:
    def __init__(self, runtime: DistributedRuntime, namespace: str,
                 component: str, client: Client,
                 block_size: int = 64,
                 config: Optional[KvRouterConfig] = None,
                 replica_sync: bool = True):
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.client = client  # generate-endpoint client (instance discovery)
        self.block_size = block_size
        # tier-aware fleet prefix cache: per-(worker, tier) ownership
        # over either base indexer impl + the fleet-wide G4 set
        self.indexer = make_tiered_indexer()
        self.selector = DefaultWorkerSelector(config)
        self.sequences = ActiveSequences()
        # LoRA replica placement (lora/routing.py): adapter-carrying
        # requests route within the adapter's HRW replica set so bank
        # slots and prefix caches stay warm there
        import os

        from ..lora.routing import LoraReplicaSelector

        self.lora_selector = LoraReplicaSelector(
            replica_factor=int(os.environ.get("DYN_LORA_REPLICAS", "2")))
        # multi-router slot-state convergence (replica_sync.py)
        self.sync: Optional[RouterReplicaSync] = (
            RouterReplicaSync(runtime, namespace, component, self.sequences)
            if replica_sync else None
        )
        self.states: Dict[int, WorkerState] = {}
        # (worker, dp_rank) -> target id (ref WorkerWithDpRank): every
        # structure below (indexer, states, sequences) is keyed by TARGET
        self.targets = TargetMap()
        # per-worker routing observability (ref metrics.rs): a skewed
        # fleet or a dead-prefix regression shows up here first
        self._metrics = runtime.metrics.scoped(component="router")
        _OVERLAP_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
        self._metrics.histogram(
            "dynamo_router_overlap_blocks",
            "prefix-cache overlap of the chosen worker (blocks)",
            buckets=_OVERLAP_BUCKETS)
        # decision attribution (forensics plane): what the chosen
        # worker BEAT, and whether the index's predictions hold up —
        # the indexer-staleness feedback
        self._metrics.histogram(
            "dynamo_router_overlap_best_rejected_blocks",
            "prefix-cache overlap of the best rejected candidate per "
            "decision (what routing left on the table)",
            buckets=_OVERLAP_BUCKETS)
        self._metrics.histogram(
            "dynamo_router_overlap_realized_blocks",
            "worker-realized prefix-cache reuse of routed requests "
            "(stamped back via the stream's forensic block)",
            buckets=_OVERLAP_BUCKETS)
        self._metrics.histogram(
            "dynamo_router_decision_regret_blocks",
            "chosen candidate's cost minus the best candidate's cost "
            "(block units; 0 = argmin picked — nonzero under "
            "temperature sampling or avoid sets)",
            buckets=_OVERLAP_BUCKETS)
        # per-decision records awaiting their realized-overlap stamp
        # (MigrationOperator pops one per routed attempt); bounded so
        # never-dispatched requests can't grow it
        from collections import OrderedDict, deque

        self._decisions: "OrderedDict[str, dict]" = OrderedDict()
        self._pred_real: "deque" = deque(maxlen=512)
        self._cancel = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self._replay_client: Optional[Client] = None
        self._known_workers: set[int] = set()
        self._recovering: set[int] = set()   # workers with replay in flight
        self._recover_tasks: set[asyncio.Task] = set()  # strong refs
        # workers whose warm resident set was replayed to this router
        # (snapshot-on-subscribe — see _sync_worker); retried next watch
        # tick on failure
        self._synced_workers: set[int] = set()

    async def start(self) -> "KvRouter":
        self._tasks = [
            asyncio.create_task(self._event_loop()),
            asyncio.create_task(self._load_loop()),
            asyncio.create_task(self._instance_watch_loop()),
        ]
        ep = (self.runtime.namespace(self.namespace)
              .component(self.component).endpoint("kv_events_replay"))
        self._replay_client = await ep.client().start()
        if self.sync is not None:
            await self.sync.start()
        return self

    async def close(self) -> None:
        self._cancel.set()
        if self.sync is not None:
            await self.sync.close()
        for t in list(self._tasks) + list(self._recover_tasks):
            t.cancel()
        if self._replay_client is not None:
            await self._replay_client.close()
        # self.client is owned by the ModelWatcher, not closed here

    # -- event ingestion (hot loop #3 in the reference) --------------------
    async def _event_loop(self) -> None:
        subject = kv_event_subject(self.namespace, self.component)
        try:
            async for _subj, payload in self.runtime.event_plane.subscribe(
                subject, cancel=self._cancel
            ):
                self._apply_event(KvCacheEvent.from_wire(payload))
        except asyncio.CancelledError:
            pass

    def _apply_event(self, ev: KvCacheEvent) -> None:
        tid = self.targets.observe(ev.worker_id, ev.dp_rank)
        last = self.indexer.last_event_id.get(tid)
        # Gap in two forms: missed events mid-stream (last known, jump > 1)
        # and a router that subscribed after the worker started publishing
        # (first observed event from an unknown worker has event_id > 0 —
        # everything stored before subscription must be replayed or it stays
        # invisible to routing forever).
        expected_next = 0 if last is None else last + 1
        if (ev.event_id > expected_next
                and tid not in self._recovering):
            # recover from the worker's ring buffer (hold a strong task
            # ref — the loop only keeps weak ones)
            self._recovering.add(tid)
            task = asyncio.ensure_future(
                self._recover(tid, expected_next)
            )
            self._recover_tasks.add(task)
            task.add_done_callback(self._recover_tasks.discard)
        self.indexer.last_event_id[tid] = max(
            ev.event_id, last if last is not None else -1
        )
        if ev.op == "stored":
            self.indexer.apply_stored(tid, ev.block_hashes, tier=ev.tier)
        elif ev.op == "removed":
            self.indexer.apply_removed(tid, ev.block_hashes, tier=ev.tier)
        elif ev.op == "cleared":
            self.indexer.clear_worker(tid)

    async def _recover(self, tid: int, since: int) -> None:
        if self._replay_client is None:
            self._recovering.discard(tid)
            return
        worker_id, dp_rank = self.targets.resolve(tid)
        try:
            events = []
            async for wire_ev in self._replay_client.generate(
                {"since_event_id": since, "dp_rank": dp_rank},
                instance_id=worker_id,
            ):
                events.append(KvCacheEvent.from_wire(wire_ev))
            if events and events[0].event_id > since:
                # the worker's replay ring evicted part of the requested
                # range: blocks stored in the lost events would stay
                # invisible if we just applied the tail.  Ask for the
                # worker's resident-set SNAPSHOT instead (the
                # snapshot-on-subscribe surface) — the warm cache in
                # full, not the ring's recent churn.
                logger.warning(
                    "replay ring for target %d starts at %d > requested %d; "
                    "replacing its index with the worker's resident "
                    "snapshot", tid, events[0].event_id, since,
                )
                events = []
                async for wire_ev in self._replay_client.generate(
                    {"snapshot": True, "dp_rank": dp_rank},
                    instance_id=worker_id,
                ):
                    ev = KvCacheEvent.from_wire(wire_ev)
                    if ev.dp_rank == dp_rank:
                        events.append(ev)
                # top-up: live events that raced the snapshot fetch may
                # already sit in the index (and would be wiped by the
                # clear below) — re-request the ring tail PAST the
                # snapshot's stamp and append it, so removals/stores
                # from the fetch window land after the resident set.
                # The ring covers this range by construction (the
                # events are seconds old).
                snap_id = max((e.event_id for e in events), default=-1)
                if snap_id >= 0:
                    async for wire_ev in self._replay_client.generate(
                        {"since_event_id": snap_id + 1,
                         "dp_rank": dp_rank},
                        instance_id=worker_id,
                    ):
                        events.append(KvCacheEvent.from_wire(wire_ev))
                self.indexer.clear_worker(tid)
            for ev in events:
                if ev.op == "stored":
                    self.indexer.apply_stored(tid, ev.block_hashes,
                                              tier=ev.tier)
                elif ev.op == "removed":
                    self.indexer.apply_removed(tid, ev.block_hashes,
                                               tier=ev.tier)
                elif ev.op == "cleared":
                    self.indexer.clear_worker(tid)
            logger.info("recovered %d kv events for target %d since %d",
                        len(events), tid, since)
        except Exception:
            logger.warning("kv event recovery failed for target %d; "
                           "dropping its index", tid, exc_info=True)
            self.indexer.remove_worker(tid)
        finally:
            self._recovering.discard(tid)

    async def _sync_worker(self, worker_id: int) -> None:
        """Snapshot-on-subscribe (the ingestion contract): replay a
        newly-discovered worker's CURRENT resident blocks into the index.
        Without it, a router that subscribed after the fleet warmed
        predicts 0 overlap forever — pure cache hits fire no new KV
        events."""
        if self._replay_client is None:
            self._synced_workers.discard(worker_id)
            return
        try:
            n = 0
            async for wire_ev in self._replay_client.generate(
                {"snapshot": True}, instance_id=worker_id,
            ):
                ev = KvCacheEvent.from_wire(wire_ev)
                if ev.op != "stored":
                    continue
                tid = self.targets.observe(ev.worker_id, ev.dp_rank)
                last = self.indexer.last_event_id.get(tid)
                if last is not None and last > ev.event_id:
                    # the live stream (and its own gap recovery) ran
                    # AHEAD of this snapshot while it was in flight:
                    # applying the older resident set would resurrect
                    # blocks a newer `removed` event already retired
                    # (removals fire once — the stale store would stand
                    # forever).  The ahead view is already complete for
                    # this target: its first live event triggered the
                    # replay-from-birth/snapshot recovery path.
                    continue
                self.indexer.apply_stored(tid, ev.block_hashes,
                                          tier=ev.tier)
                self.indexer.last_event_id[tid] = max(
                    ev.event_id, last if last is not None else -1)
                n += len(ev.block_hashes)
            if n:
                logger.info("synced %d resident kv blocks from worker %d "
                            "(snapshot-on-subscribe)", n, worker_id)
        except Exception:
            # retried on the next watch tick (the worker may still be
            # registering its replay endpoint)
            self._synced_workers.discard(worker_id)
            logger.debug("kv snapshot sync of worker %d failed",
                         worker_id, exc_info=True)

    async def _load_loop(self) -> None:
        subject = f"load_metrics.{self.namespace}.{self.component}"
        try:
            async for _subj, payload in self.runtime.event_plane.subscribe(
                subject, cancel=self._cancel
            ):
                w = payload.get("worker_id")
                if w is None:
                    continue
                # per-rank load when the worker reports dp ranks
                # (ref: per-dp_rank publishers, vllm/main.py:379-425)
                ranks = payload.get("ranks")
                tier_costs = payload.get("kv_tier_costs") or {}
                if ranks:
                    for r in ranks:
                        tid = self.targets.observe(
                            w, int(r.get("dp_rank", 0)))
                        st = self.states.setdefault(tid, WorkerState())
                        st.kv_usage = r.get("kv_usage",
                                            payload.get("kv_usage", 0.0))
                        st.kv_total_blocks = r.get(
                            "kv_total_blocks",
                            payload.get("kv_total_blocks", 0))
                        if tier_costs:
                            st.tier_costs = dict(tier_costs)
                else:
                    st = self.states.setdefault(w, WorkerState())
                    st.kv_usage = payload.get("kv_usage", 0.0)
                    st.kv_total_blocks = payload.get("kv_total_blocks", 0)
                    if tier_costs:
                        st.tier_costs = dict(tier_costs)
        except asyncio.CancelledError:
            pass

    async def _instance_watch_loop(self) -> None:
        """Purge dead workers from the index when their lease disappears."""
        ticks = 0
        try:
            while not self._cancel.is_set():
                await asyncio.sleep(0.5)
                ticks += 1
                if ticks % 60 == 0:  # crashed-client slot bookkeeping reaper
                    reaped = self.sequences.reap_stale()
                    if reaped:
                        logger.info("reaped %d stale routed requests", reaped)
                live = set(self.client.instance_ids)
                if not live and not self._known_workers:
                    continue
                for gone in self._known_workers - live:
                    logger.info("worker %d gone; purging from KV index", gone)
                    self._synced_workers.discard(gone)
                    for tid in self.targets.remove_worker(gone):
                        self.indexer.remove_worker(tid)
                        self.sequences.remove_worker(tid)
                        self.states.pop(tid, None)
                # snapshot-on-subscribe: every live worker this router
                # has not yet synced gets its warm resident set replayed
                # (covers both a late-started router against a warm
                # fleet and a worker that joined after us); failures
                # un-mark so the next tick retries
                for w in live - self._synced_workers:
                    self._synced_workers.add(w)
                    task = asyncio.ensure_future(self._sync_worker(w))
                    self._recover_tasks.add(task)
                    task.add_done_callback(self._recover_tasks.discard)
                self._known_workers = live
        except asyncio.CancelledError:
            pass

    # -- routing (route-hook protocol for MigrationOperator) ---------------
    async def __call__(self, request: PreprocessedRequest,
                       avoid: Optional[set] = None) -> Optional[int]:
        return await self.pick(request, avoid=avoid)

    async def pick(self, request: PreprocessedRequest,
                   avoid: Optional[set] = None) -> Optional[int]:
        workers = self.client.instance_ids
        if not workers:
            await self.client.wait_for_instances()
            workers = self.client.instance_ids
        if request.lora_name:
            workers = self.lora_selector.filter(request.lora_name, workers,
                                                avoid=avoid)
        # expand workers to (worker, dp_rank) TARGETS — each rank holds a
        # disjoint KV cache, so cost/overlap are per rank
        # (ref WorkerWithDpRank).  `avoid` carries instance ids
        # (migration): avoiding a worker avoids all its ranks.
        candidates: list[int] = []
        for w in workers:
            candidates.extend(self.targets.targets_of(w))
        avoid_targets = None
        if avoid:
            avoid_targets = set()
            for w in avoid:
                avoid_targets.update(self.targets.targets_of(w))
        hashes = compute_block_hashes_for_request(
            request.token_ids, self.block_size, lora_name=request.lora_name,
            media_hashes=request.media_hashes,
        )
        # tier-aware overlap (fleet prefix cache): the run extends past
        # local residency through the shared G4 store, and the selector
        # prices each block at its cheapest source tier
        tier_overlaps = self.indexer.find_matches_tiered(hashes, candidates)
        overlaps = {w: sum(c.values()) for w, c in tier_overlaps.items()}
        request_blocks = (len(request.token_ids) + self.block_size - 1) \
            // self.block_size
        # refresh decode-load estimates from the slot manager
        for t in candidates:
            st = self.states.setdefault(t, WorkerState())
            st.active_blocks = self.sequences.active_blocks(t)
        choice, logits = self.selector.select_verbose(
            candidates, request_blocks, overlaps, self.states,
            avoid=avoid_targets, tier_overlaps=tier_overlaps,
        )
        if choice is not None:
            blocks = request_blocks + (request.stop.max_tokens
                                       // self.block_size)
            overlap = overlaps.get(choice, 0)
            self.sequences.add_request(
                request.request_id, choice, blocks, overlap
            )
            if self.sync is not None:
                self.sync.publish_add(request.request_id, choice, blocks,
                                      overlap)
            self._metrics.inc("dynamo_router_routed_requests_total",
                              worker=str(choice))
            self._metrics.observe("dynamo_router_overlap_blocks", overlap)
            for t_name, t_blocks in tier_overlaps.get(choice, {}).items():
                self._metrics.inc(
                    "dynamo_router_overlap_by_tier", t_blocks,
                    "chosen-worker overlap blocks by cheapest source tier",
                    tier=t_name)
            self._record_decision(request.request_id, choice,
                                  request_blocks, overlap, logits,
                                  overlaps,
                                  by_tier=tier_overlaps.get(choice))
            # the wire needs the instance; the engine needs the rank
            worker_id, dp_rank = self.targets.resolve(choice)
            request.dp_rank = dp_rank
            return worker_id
        self._metrics.inc("dynamo_router_no_worker_total")
        return None

    # -- decision attribution / predicted-vs-realized feedback -------------
    def _record_decision(self, request_id: str, choice: int,
                         request_blocks: int, overlap: int,
                         logits: Dict[int, float],
                         overlaps: Dict[int, int],
                         by_tier: Optional[Dict[str, int]] = None) -> dict:
        """One decision record per pick: the chosen target's predicted
        overlap + cost, every candidate's score (top-8 by cost), the
        best REJECTED candidate (what routing left on the table: the
        overlap histogram alone only shows the winner), and the
        decision's regret vs the argmin.  The record
        rides the forensics `routed` hop and is the correlation anchor
        for the worker's realized-reuse stamp (on_realized)."""
        chosen = logits.get(choice, 0.0)
        best = min(logits.values()) if logits else 0.0
        regret = max(0.0, chosen - best)
        rejected = {t: c for t, c in logits.items() if t != choice}
        decision: dict = {
            "target": choice,
            "predicted_overlap_blocks": int(overlap),
            **({"overlap_by_tier": dict(by_tier)} if by_tier else {}),
            "request_blocks": int(request_blocks),
            "score": round(chosen, 3),
            "regret": round(regret, 3),
            "scores": {str(t): round(c, 3) for t, c in
                       sorted(logits.items(), key=lambda kv: kv[1])[:8]},
        }
        if rejected:
            t = min(rejected, key=rejected.get)
            decision["best_rejected"] = {
                "target": t, "score": round(rejected[t], 3),
                "overlap_blocks": int(overlaps.get(t, 0)),
            }
            self._metrics.observe(
                "dynamo_router_overlap_best_rejected_blocks",
                overlaps.get(t, 0))
        self._metrics.observe("dynamo_router_decision_regret_blocks",
                              regret)
        self._decisions[request_id] = decision
        while len(self._decisions) > 4096:
            self._decisions.popitem(last=False)
        return decision

    def pop_decision(self, request_id: str) -> Optional[dict]:
        """Hand the latest decision for `request_id` to the dispatcher
        (frontend MigrationOperator) — popped so a migration's re-route
        records a fresh decision for its own attempt."""
        return self._decisions.pop(request_id, None)

    def on_realized(self, decision: Optional[dict],
                    realized_tokens) -> None:
        """Worker-realized prefix reuse for one routed attempt (stamped
        back via the stream's forensic block): the ONE signal that says
        whether the indexer's predictions are accurate or stale.
        Staleness ratio = 1 - matched/predicted over a rolling window,
        where matched = min(predicted, realized) per decision — 0 means
        every predicted block was actually reused, 1 means the index
        promised overlap the workers no longer had."""
        if realized_tokens is None:
            return
        realized = max(0, int(realized_tokens)) // self.block_size
        predicted = int((decision or {}).get(
            "predicted_overlap_blocks", 0))
        self._metrics.observe("dynamo_router_overlap_realized_blocks",
                              realized)
        self._pred_real.append((predicted, realized))
        preds = sum(p for p, _ in self._pred_real)
        if preds:
            matched = sum(min(p, r) for p, r in self._pred_real)
            self._metrics.set("dynamo_router_overlap_staleness_ratio",
                              1.0 - matched / preds,
                              "rolling fraction of router-predicted "
                              "overlap blocks the workers did NOT "
                              "actually reuse (0 = index accurate)")

    def overlap_stats(self) -> dict:
        """Predicted-vs-realized rollup for /debug/state and the fleet
        reduction (obs/fleet.py surfaces the max staleness across
        frontends)."""
        n = len(self._pred_real)
        preds = sum(p for p, _ in self._pred_real)
        reals = sum(r for _, r in self._pred_real)
        matched = sum(min(p, r) for p, r in self._pred_real)
        return {
            "decisions": n,
            "predicted_blocks": preds,
            "realized_blocks": reals,
            "staleness_ratio": (round(1.0 - matched / preds, 4)
                                if preds else None),
            "realized_minus_predicted_mean": (round((reals - preds) / n, 3)
                                              if n else None),
            "indexer_impl": indexer_impl(self.indexer),
            "g4_blocks": getattr(self.indexer, "g4_blocks", 0),
            **({"replica_sync": self.sync.stats()}
               if self.sync is not None else {}),
        }

    def charge(self, request: PreprocessedRequest, worker_id: int) -> None:
        """Record a placement decided outside this router (session
        affinity, explicit backend_instance_id) so the worker's load
        accounting stays truthful for subsequent picks."""
        from .targets import target_id

        # account under the actual (worker, dp_rank) target — a session
        # pinned to rank r must charge rank r, not rank 0
        tid = target_id(worker_id, getattr(request, "dp_rank", 0))
        hashes = compute_block_hashes_for_request(
            request.token_ids, self.block_size, lora_name=request.lora_name,
            media_hashes=request.media_hashes,
        )
        overlap = self.indexer.find_matches(hashes).get(tid, 0)
        blocks = ((len(request.token_ids) + self.block_size - 1)
                  // self.block_size
                  + request.stop.max_tokens // self.block_size)
        self.sequences.add_request(request.request_id, tid, blocks,
                                   overlap)
        if self.sync is not None:
            self.sync.publish_add(request.request_id, tid, blocks,
                                  overlap)
        self._metrics.inc("dynamo_router_routed_requests_total",
                          worker=str(tid))

    def mark_prefill_completed(self, request_id: str) -> None:
        self.sequences.mark_prefill_completed(request_id)
        if self.sync is not None:
            self.sync.publish_prefill_done(request_id)

    def complete(self, request_id: str) -> None:
        # a decision that never got dispatched/stamped must not outlive
        # its request (the dict is bounded anyway; this is hygiene)
        self._decisions.pop(request_id, None)
        self.sequences.free(request_id)
        if self.sync is not None:
            self.sync.publish_free(request_id)


def make_kv_route_factory(runtime: DistributedRuntime, *,
                          overlap_score_weight: float = 1.0,
                          temperature: float = 0.0):
    """Frontend hook: build one KvRouter per discovered model."""

    async def factory(mdc: ModelDeploymentCard, client: Client) -> KvRouter:
        router = KvRouter(
            runtime, mdc.namespace, mdc.component, client,
            block_size=mdc.kv_cache_block_size,
            config=KvRouterConfig(
                overlap_score_weight=overlap_score_weight,
                temperature=temperature,
            ),
        )
        return await router.start()

    return factory

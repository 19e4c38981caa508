"""Mocker worker: registers a simulated engine as a Dynamo-style worker,
a copy of dynamo_tpu/mocker/worker.py without its chaos seam
(`worker.drain`, which wedged or failed a drain on a rule).

The worker contract every backend implements: serve `generate` (+
`clear_kv_blocks`, `kv_events_replay`, `embed`), publish the
ModelDeploymentCard, emit KV events and periodic load metrics under the
JAX worker's subjects and names.  It runs on the port's runtime and
takes no device.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .. import obs
from ..protocols import LLMEngineOutput, ModelDeploymentCard, PreprocessedRequest
from ..protocols.model_card import register_model
from ..router.events import KvEventPublisher
from ..runtime import DistributedRuntime
from .engine import MockEngine, MockEngineArgs
from .kv_cache_sim import kv_dtype_capacity_blocks

logger = logging.getLogger(__name__)

LOAD_SUBJECT_PREFIX = "load_metrics"


class MockerWorker:
    def __init__(self, runtime: DistributedRuntime, args: MockEngineArgs,
                 namespace: str = "dynamo", component: str = "mocker",
                 migration_limit: int = 0, reasoning_parser: str = ""):
        self.runtime = runtime
        self.args = args
        self.namespace = namespace
        self.component = component
        self.migration_limit = migration_limit
        self.reasoning_parser = reasoning_parser
        self.publisher: Optional[KvEventPublisher] = None
        self.engine: Optional[MockEngine] = None
        self.served = None
        self._load_task: Optional[asyncio.Task] = None
        # local FPM window: load loop feeds it; /debug/state reads
        # compile stats + ITL p95 (same shape as the JAX worker, so the
        # fleet plane is tier-1 testable CPU-only)
        from ..planner.metrics import FpmWindow

        self._fpm_window = FpmWindow()
        self._debug_source_name: Optional[str] = None

    @property
    def card(self) -> ModelDeploymentCard:
        return ModelDeploymentCard(
            name=self.args.model_name,
            namespace=self.namespace,
            component=self.component,
            endpoint="generate",
            tokenizer={"type": "byte"},
            kv_cache_block_size=self.args.block_size,
            migration_limit=self.migration_limit,
            runtime_config={
                # EFFECTIVE capacity: int8 simulation scales the pool
                # (kv_cache_sim.kv_dtype_capacity_blocks), and routers
                # cost workers by what they actually hold
                "total_kv_blocks": kv_dtype_capacity_blocks(
                    self.args.num_blocks, self.args.kv_cache_dtype),
                "max_num_seqs": self.args.max_num_seqs,
                "role": self.args.role,
                # same advertisement shape as the JAX worker
                "kv_cache_dtype": self.args.kv_cache_dtype,
                # simulated speculative decoding knobs (same shape the
                # JAX worker advertises: planners/routers can see the
                # configured draft length)
                **({"speculative": dict(self.args.speculative)}
                   if self.args.speculative is not None else {}),
                **({"reasoning_parser": self.reasoning_parser}
                   if self.reasoning_parser else {}),
                # same tracing-capability advertisement as the JAX worker
                **({"tracing": True} if obs.enabled() else {}),
            },
        )

    async def start(self) -> "MockerWorker":
        rt = self.runtime
        ns = rt.namespace(self.namespace)
        comp = ns.component(self.component)
        gen_ep = comp.endpoint("generate")

        # instance id first so the publisher tags events correctly
        from ..runtime.discovery import new_instance_id

        instance_id = new_instance_id()
        # dp ranks: one simulated engine + one event publisher per rank —
        # each rank is a distinct routing target with its own KV cache
        dp = max(1, self.args.dp_size)
        self.publishers = [
            KvEventPublisher(rt, self.namespace, self.component,
                             worker_id=instance_id, dp_rank=r)
            for r in range(dp)
        ]
        self.publisher = self.publishers[0]
        self.engines = [MockEngine(self.args, kv_event_publisher=p)
                        for p in self.publishers]
        self.engine = self.engines[0]

        async def generate_handler(payload, ctx):
            request = PreprocessedRequest.from_dict(payload)
            eng = self.engines[request.dp_rank % len(self.engines)]
            ntok = 0
            # log<->trace correlation + worker-side request span (same
            # contract as the JAX engine worker: trace_id from the
            # propagated traceparent annotation)
            bind_tok = obs.bind_trace_id(
                obs.trace_id_from_annotations(request.annotations))
            t_obs = obs.begin()
            try:
                async for out in eng.generate(request, token=ctx.token):
                    ntok += len(out.token_ids)
                    yield out.to_dict()
            finally:
                obs.end("worker_request", t_obs,
                        trace_id=obs.trace_id_from_annotations(
                            request.annotations) if t_obs else None,
                        request_id=request.request_id, tokens=ntok)
                tp = next((a.split(":", 1)[1] for a in request.annotations
                           if a.startswith("traceparent:")), None)
                if tp is not None:
                    logger.info("request served", extra={
                        "request_id": request.request_id,
                        "traceparent": tp, "output_tokens": ntok})
                obs.unbind_trace_id(bind_tok)

        async def clear_handler(payload, ctx):
            n = 0
            for eng in self.engines:
                n += await eng.clear_kv_blocks()
            yield {"cleared_blocks": n}

        async def replay_handler(payload, ctx):
            # per-rank replay rings: the router asks for a specific
            # rank.  A snapshot request WITHOUT a rank (a late
            # subscriber syncing a just-discovered worker — it cannot
            # know the ranks yet) answers with every rank's resident
            # set; the events carry dp_rank, so the router indexes each
            # rank's blocks under its own target.
            if (payload or {}).get("snapshot") \
                    and "dp_rank" not in (payload or {}):
                for pub in self.publishers:
                    for ev in pub.snapshot_events():
                        yield ev
                return
            r = int((payload or {}).get("dp_rank", 0))
            pub = self.publishers[r % len(self.publishers)]
            async for ev in pub.replay_handler(payload, ctx):
                yield ev

        async def embed_handler(payload, ctx):
            # deterministic unit vector from the token ids (test double
            # for the JAX engine's pooled embed_text)
            import hashlib

            import numpy as np

            toks = payload["token_ids"]
            seed = int.from_bytes(hashlib.sha256(
                np.asarray(toks, np.int64).tobytes()).digest()[:8], "big")
            vec = np.random.default_rng(seed).standard_normal(32)
            vec = vec / np.linalg.norm(vec)
            yield {"embedding": vec.tolist(), "dim": 32}

        from ..protocols.llm import CANARY_GENERATE_PAYLOAD

        self.served = await gen_ep.serve_endpoint(
            generate_handler,
            metadata={"model": self.args.model_name, "role": self.args.role},
            instance_id=instance_id,
            health_check_payload=CANARY_GENERATE_PAYLOAD,
        )
        self._aux_served = [
            await comp.endpoint("clear_kv_blocks").serve_endpoint(
                clear_handler, instance_id=instance_id
            ),
            await comp.endpoint("kv_events_replay").serve_endpoint(
                replay_handler, instance_id=instance_id
            ),
            await comp.endpoint("embed").serve_endpoint(
                embed_handler, instance_id=instance_id
            ),
        ]
        await register_model(rt, self.card, instance_id)
        self._load_task = asyncio.create_task(self._load_loop())
        # fleet introspection: this worker's live state on /debug/state
        self._debug_source_name = f"worker:{instance_id}"
        rt.register_debug_source(self._debug_source_name, self.debug_state)
        # KV-accounting plane (obs/kv_ledger.py): same /debug/kv
        # contract the JAX worker serves, from the simulated ledgers
        self._kv_source_name = f"kv:{instance_id}"
        rt.register_kv_source(self._kv_source_name, self.kv_debug)
        logger.info("mocker worker %d serving model %s",
                    instance_id, self.args.model_name)
        return self

    def _merged_ledgers(self):
        from ..obs.kv_ledger import MergedLedgers

        merged = MergedLedgers(e.kv_ledger
                               for e in getattr(self, "engines", []))
        return merged if merged else None

    def kv_debug(self) -> dict:
        """/debug/kv source (the JAX worker's contract, dp-rank-merged):
        attribution + violation totals over every rank's ledger, a
        fresh on-demand audit per rank, and rank 0's full dump (tape
        tail included)."""
        base = {
            "kind": "mocker",
            "instance_id": (self.served.instance_id
                            if self.served is not None else None),
            "namespace": self.namespace,
            "component": self.component,
        }
        engines = [e for e in getattr(self, "engines", [])
                   if e.kv_ledger is not None]
        if not engines:
            return {**base, "schema": "dynamo.kv_ledger.v1",
                    "enabled": False}
        audits = [e.audit_kv(where="on_demand") for e in engines]
        merged = self._merged_ledgers()
        out = {**base, **engines[0].kv_ledger.dump(),
               "audit": audits[0]}
        if len(engines) > 1:
            out["attribution"] = merged.attribution()
            out["violations_total"] = merged.violations_by_kind()
            out["ranks"] = [{"dp_rank": r, "audit": a}
                            for r, a in enumerate(audits)]
        store = self.args.object_store
        if store is not None:
            # G4 residency view (the JAX worker's contract): lineage
            # verdict histogram over a bounded blob sample
            from ..kvbm.residency import LineageResidency

            keys = store.keys()[:2048]
            res = LineageResidency(engines[0].kv_ledger, pool=store)
            out["g4"] = {"blobs_total": len(store),
                         "blobs_sampled": len(keys),
                         "residency": res.verdicts(keys)}
        # KV-integrity plane (same keys as the JAX worker's kv_debug):
        # breaker states + (tier, action) failure counters, rank-merged
        states = engines[0].tier_states() if engines else {}
        if states:
            out["tier_state"] = states
        integ: dict = {}
        for e in engines:
            for (t, action), n in e.kv_integrity_counters().items():
                k = f"{t}:{action}"
                integ[k] = integ.get(k, 0) + n
        if integ:
            out["integrity"] = integ
        return out

    def debug_state(self) -> dict:
        """Live scheduler/KV/drain snapshot for /debug/state — the same
        contract JaxEngineWorker.debug_state serves, from the simulated
        engines (summed across dp ranks; each rank owns its own KV
        pool, so used/capacity SUM like the load loop's gauges)."""
        engines = getattr(self, "engines", None) or (
            [self.engine] if self.engine else [])
        slots = []
        waiting = []
        for eng in engines:
            for seq in list(eng.running):
                slots.append({
                    "request_id": seq.request_id,
                    "prompt_len": seq.num_prompt_tokens,
                    "generated": seq.generated,
                    "prefilling": seq.prefill_pos < seq.num_prompt_tokens,
                    "pulling": False,
                    "inflight": 0,
                    "cached_tokens": seq.cached_blocks
                    * self.args.block_size,
                })
            waiting.extend(s.request_id for s in list(eng.waiting))
        used = sum(e.cache.used_blocks for e in engines)
        cap = sum(e.cache.num_blocks for e in engines)
        weights = [e.num_active_seqs for e in engines] or [1]
        if not any(weights):
            weights = [1] * len(weights)
        itl = (sum(w * e.itl_ema_s for w, e in zip(weights, engines))
               / sum(weights)) if engines else 0.0
        fw = self._fpm_window
        return {
            "kind": "mocker",
            "instance_id": (self.served.instance_id
                            if self.served is not None else None),
            "namespace": self.namespace,
            "component": self.component,
            "model": self.args.model_name,
            "role": self.args.role,
            "draining": any(e.draining for e in engines),
            "dead": any(e.dead for e in engines),
            "active_seqs": sum(e.num_active_seqs for e in engines),
            "waiting": waiting,
            "slots": slots,
            "tokens_in_flight": sum(
                s["prompt_len"] + s["generated"] for s in slots),
            "kv": {
                "g1": {"used": used, "free": cap - used,
                       "capacity": cap},
                **({"g2": {"used": sum(e.cache.g2_blocks
                                       for e in engines),
                           "capacity": self.args.host_blocks
                           * len(engines)}}
                   if self.args.host_blocks else {}),
                **({"g4": {"used": len(self.args.object_store)}}
                   if self.args.object_store is not None else {}),
            },
            "kv_usage": (sum(e.kv_usage() for e in engines)
                         / len(engines)) if engines else 0.0,
            "kv_cache_dtype": self.args.kv_cache_dtype,
            "itl_ema_s": itl,
            "itl_p95_s": fw.decode_itl_p95_s(),
            "compile": fw.compile_stats(),
            "engine_metrics": ({k: sum(e.metrics[k] for e in engines)
                                for k in engines[0].metrics}
                               if engines else {}),
            "config": dict(self.card.runtime_config),
        }

    async def _load_loop(self) -> None:
        """Periodic load metrics for least-loaded / KV routing cost inputs."""
        subject = f"{LOAD_SUBJECT_PREFIX}.{self.namespace}.{self.component}"
        fpm_subject = f"fpm.{self.namespace}.{self.component}"
        m = self.runtime.metrics.scoped(component=self.component)
        tr = obs.tracer()
        if tr is not None:
            tr.bind_metrics(m)
        # local FPM aggregation mirrors the JAX worker: /metrics scrapes
        # see spec acceptance etc. without a planner attached (and
        # /debug/state reads compile stats + ITL p95 off the window)
        fw = self._fpm_window
        ticks = 0
        while True:
            await asyncio.sleep(0.25)
            if self.engine is None or self.served is None:
                continue
            ticks += 1
            # drain the simulated FPM rings (spec_verify acceptance
            # records) onto the same subject the JAX worker uses, so
            # FpmObserver.spec_acceptance works against the mocker
            steps = []
            for eng in self.engines:
                while eng.fpm and len(steps) < 512:
                    steps.append(eng.fpm.popleft())
            for rec in steps:
                fw.add(self.served.instance_id, rec)
            # same compile histogram + the SHARED gauge surface
            # (planner/metrics.py export_engine_gauges — one definition
            # with the JAX worker is what keeps the CPU-only export
            # byte-name-compatible).  Simulated occupancy: the dp ranks
            # each own a pool, so g1 sums them.
            from ..obs.compile_watch import observe_compile_records
            from ..planner.metrics import export_engine_gauges

            observe_compile_records(m, steps)
            used = sum(e.cache.used_blocks for e in self.engines)
            cap = sum(e.cache.num_blocks for e in self.engines)
            occ = {"g1": {"used": used, "free": cap - used,
                          "capacity": cap}}
            store = self.args.object_store
            if self.args.host_blocks:
                g2u = sum(e.cache.g2_blocks for e in self.engines)
                g2c = self.args.host_blocks * len(self.engines)
                occ["g2"] = {"used": g2u, "free": g2c - g2u,
                             "capacity": g2c}
            if store is not None:
                occ["g4"] = {"used": len(store)}
            export_engine_gauges(
                m, fw, peak_tflops=self.args.peak_tflops,
                peak_hbm_gbps=self.args.peak_hbm_gbps,
                occupancy=occ,
                kv_ledger=self._merged_ledgers())
            if store is not None and ticks % 40 == 0:
                # G4 sweep cadence (the JAX worker's load-loop parity):
                # lineage verdicts upgrade the TTL, and the swept hashes
                # publish removed(g4) — one sweep kills the blob for
                # every holder's router/consolidator books fleet-wide
                from ..kvbm.residency import LineageResidency

                led = self.engines[0].kv_ledger
                res = (LineageResidency(led, pool=store)
                       if led is not None else None)
                swept = store.sweep(None, res)
                if swept:
                    self.publisher.enqueue_batch(removed=swept, tier="g4")
                    if led is not None:
                        led.tier_batch([], swept, "g4")
            if steps:
                try:
                    await self.runtime.event_plane.publish(fpm_subject, {
                        "worker_id": self.served.instance_id,
                        "steps": steps,
                    })
                except Exception:
                    logger.warning("fpm publish failed", exc_info=True)
            # cross-rank ITL: weight each engine's EMA by its active
            # sequences (an idle rank's stale EMA must not drag the
            # worker-level signal the SLA planner consumes); totals SUM
            # across ranks — each rank owns its own KV pool
            weights = [e.num_active_seqs for e in self.engines]
            if not any(weights):
                weights = [1] * len(self.engines)
            itl = sum(w * e.itl_ema_s
                      for w, e in zip(weights, self.engines)) \
                / sum(weights)
            # tier costs from the timing model itself: onboard seconds
            # per block vs the prefill recompute it displaces — the same
            # ratio the JAX worker derives from measured roofline rates
            # (router/tiered_index.compute_tier_costs), known in closed
            # form here.  speedup_ratio scales both sides, so it cancels.
            tier_costs = None
            if self.args.host_blocks or store is not None:
                recompute = (self.args.block_size
                             * self.args.prefill_s_per_token)
                if recompute > 0:
                    tier_costs = {
                        "g1": 0.0,
                        "g2": min(1.0, self.args.g2_onboard_s_per_block
                                  / recompute),
                        "g4": min(1.0, self.args.g4_onboard_s_per_block
                                  / recompute),
                    }
            # tier breakers (KV-integrity plane): merge per-rank states
            # (worst wins — the ranks share one simulated mount), price
            # any non-closed tier at recompute in the advertised costs,
            # and export the same gauges the JAX worker exports
            from ..kvbm.breaker import NUMERIC as _TIER_NUMERIC
            from ..router.tiered_index import degraded_tier_costs

            tier_states = {}
            for e in self.engines:
                for t, s in e.tier_states().items():
                    if (_TIER_NUMERIC.get(s, 0) >= _TIER_NUMERIC.get(
                            tier_states.get(t, "closed"), 0)):
                        tier_states[t] = s
            if tier_states:
                tier_costs = degraded_tier_costs(tier_costs, tier_states)
                for t, s in tier_states.items():
                    m.set("dynamo_kvbm_tier_state",
                          float(_TIER_NUMERIC.get(s, 0)),
                          "KV tier circuit-breaker state "
                          "(0=closed, 1=half_open, 2=open)", tier=t)
            integ: dict = {}
            for e in self.engines:
                for (t, action), n in e.kv_integrity_counters().items():
                    integ[(t, action)] = integ.get((t, action), 0) + n
            for (t, action), n in integ.items():
                m.set("dynamo_kv_integrity_failures_total", float(n),
                      "KV integrity/I-O failures by tier and action",
                      tier=t, action=action)
            await self.runtime.event_plane.publish(subject, {
                "worker_id": self.served.instance_id,
                "active_seqs": sum(e.num_active_seqs for e in self.engines),
                "kv_usage": (sum(e.kv_usage() for e in self.engines)
                             / len(self.engines)),
                "kv_total_blocks": sum(e.cache.num_blocks
                                       for e in self.engines),
                "kv_cache_dtype": self.args.kv_cache_dtype,
                # per-rank load: the router costs each rank separately
                **({"dp_size": len(self.engines),
                    "ranks": [{"dp_rank": r, "kv_usage": e.kv_usage(),
                               "kv_total_blocks": e.cache.num_blocks}
                              for r, e in enumerate(self.engines)]}
                   if len(self.engines) > 1 else {}),
                # SLA-planner inputs (planner/metrics.py differentiates)
                "requests_total": sum(e.metrics["requests"]
                                      for e in self.engines),
                "prompt_tokens_total": sum(e.metrics["prompt_tokens"]
                                           for e in self.engines),
                "itl_ema_s": itl,
                # router cost input: per-tier onboard price relative to
                # recompute (selector.overlap_cost_blocks consumes this)
                **({"kv_tier_costs": tier_costs} if tier_costs else {}),
            })

    async def drain(self, deadline_s: float = 5.0) -> None:
        """Graceful drain (SIGTERM path): withdraw this worker's routing
        identity from discovery, reject new work, let in-flight requests
        finish until the deadline, then error the rest with the
        migratable "worker draining" marker so the frontend replays them
        on surviving workers — zero client-visible failures.

        Only THIS worker's keys are deleted (not the runtime lease):
        co-resident workers on the same runtime keep serving."""
        import time

        from ..protocols.model_card import deregister_model

        for eng in getattr(self, "engines", []):
            eng.draining = True
        if self.served is not None:
            logger.warning("draining mocker worker %d (deadline %.1fs)",
                           self.served.instance_id, deadline_s)
            await deregister_model(self.runtime, self.card,
                                   self.served.instance_id)
            await self.runtime.discovery.delete(self.served.instance.key())
        t0 = time.monotonic()
        while (any(e.num_active_seqs for e in getattr(self, "engines", []))
               and time.monotonic() - t0 < deadline_s):
            await asyncio.sleep(0.02)
        for eng in getattr(self, "engines", []):
            eng.drain_abort()

    async def close(self) -> None:
        from ..protocols.model_card import deregister_model

        if self._debug_source_name is not None:
            self.runtime.unregister_debug_source(self._debug_source_name)
            self._debug_source_name = None
        if getattr(self, "_kv_source_name", None) is not None:
            self.runtime.unregister_kv_source(self._kv_source_name)
            self._kv_source_name = None
        if self._load_task is not None:
            self._load_task.cancel()
        for eng in getattr(self, "engines", []) or (
                [self.engine] if self.engine else []):
            await eng.close()
        if self.served is not None:
            await deregister_model(self.runtime, self.card,
                                   self.served.instance_id)
        for served in getattr(self, "_aux_served", []):
            await served.shutdown()
        if self.served is not None:
            await self.served.shutdown()

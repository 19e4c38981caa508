"""Torch engine worker: serves TorchEngine under the standard worker contract.

The counterpart of dynamo_tpu/engine/worker.py (`JaxEngineWorker`) for an
aggregated, single-process, single-GPU worker, on the port's own copy of
the distributed runtime (runtime/).  It keeps that worker's contract, so
the unchanged JAX frontend and its KV router serve it like any other:

  * the model deployment card (MDC), published in discovery once the
    engine is warm, withdrawn on drain and close; with a checkpoint
    (config.model_path) it carries the checkpoint's tokenizer.json inline
    and its chat template, so frontends on other hosts can build them;
  * the `generate`, `clear_kv_blocks`, `kv_events_replay` and `kv_pull`
    endpoints on the TCP request plane, `generate` with the canary health
    check; `kv_pull` serves the disagg pull's open/chunk/close ops
    (disagg/transfer.py) on a prefill worker's parked KV, and the engine
    is registered with the in-process broker (disagg/broker.py), so a
    decode worker in the same process pulls device-resident chunks, one
    in another process on the same card copies chunks over CUDA IPC
    when both opted in (DYN_KV_TRANSFER_SERVER; the header's
    "cuda_ipc", disagg/device_transfer.py), and any other pulls
    host-staged frames over the request plane;
  * with KVBM on (config.host_cache_blocks > 0 and kvbm_remote), the
    `kvbm_pull` endpoint, which streams this worker's host-tier copies of
    a block run (kvbm/remote.py), and the puller the engine prefetches a
    prompt's missing blocks from peers with (a RemoteBlockIndex following
    the KV event stream);
  * KV events on `kv_events.{ns}.{comp}` (router/events.py), netted by the
    engine's consolidator, tiers g1-g4;
  * load metrics on `load_metrics.{ns}.{comp}` (with `kv_tier_costs`,
    the per-tier onboard costs the KV router's tiered selector reads,
    priced from the measured prefill rate and degraded under an open
    breaker) and the engine's forward-pass-metrics records on
    `fpm.{ns}.{comp}`, every 0.5 s, and a GC sweep of the shared G4 store
    every 30 s;
  * the /metrics surface of the runtime's system-status server
    (runtime/system_status.py), fed by the same load loop: the FPM
    window's gauges (planner/metrics.py export_engine_gauges: prefill
    MFU, per-phase roofline `dynamo_engine_mfu`/`dynamo_engine_mbu` from
    the per-program cost counts against config.peak_tflops and
    peak_hbm_gbps, KV blocks by tier), the capture watch's compile
    histogram, the breaker and integrity gauges, the four
    `dynamo_engine_*` load gauges and, with tracing on, the span
    histogram; `/debug/state` merges this worker's `debug_state`;
  * each generate() stream is a `worker_request` span carrying the
    frontend's trace id (bound for log correlation meanwhile), and the
    MDC advertises `"tracing": True` while a tracer is installed;
  * guided decoding validates candidate text with the model's tokenizer,
    built from the MDC's tokenizer entry (frontend/tokenizer.py), or the
    byte mock where it cannot be built;
  * the SLO feed: the frontends' burn rates on `slo_metrics.{ns}`
    (obs/slo.py), the worst window into TorchEngine.set_slo_burn;
  * drain on SIGTERM (engine/__main__.py): withdraw the routing identity,
    let in-flight requests finish until a deadline, abort the rest with
    the migratable "worker draining" marker.

Not ported yet (ROADMAP.md): multi-host slices, the `embed` endpoint,
and the KV ledger's /debug/kv source.

The `kvbm_pull` wire carries block hashes as 16-byte big-endian bytes
(router/events.py hash_to_wire), as the KV events do, and accepts plain
ints: a 128-bit PLH is out of msgpack's integer range, so the JAX
worker's int hashes cannot be encoded on the request plane at all.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, Optional

from .. import obs
from ..device import DeviceLike
from ..disagg import broker
from ..disagg.device_transfer import (
    NegotiatedPullSource,
    SenderChunkRegistry,
    get_transfer_server,
    next_uuid,
)
from ..disagg.transfer import encode_chunk_frame, make_header
from ..frontend.tokenizer import tokenizer_from_mdc
from ..models.loader import load_chat_template
from ..kvbm import breaker as kvbm_breaker
from ..obs.compile_watch import observe_compile_records
from ..obs.slo import SLO_SUBJECT_PREFIX
from ..planner.metrics import FpmWindow, export_engine_gauges
from ..protocols import (
    CANARY_GENERATE_PAYLOAD,
    ModelDeploymentCard,
    PreprocessedRequest,
    deregister_model,
    register_model,
)
from ..kvbm.remote import RemoteBlockIndex, RemoteKvbmPuller, encode_block
from ..router.events import KvEventPublisher, hash_to_wire, wire_to_hash
from ..router.tiered_index import compute_tier_costs, degraded_tier_costs
from ..runtime import DistributedRuntime
from ..runtime.discovery import new_instance_id
from .config import EngineConfig
from .core import TorchEngine

logger = logging.getLogger(__name__)

LOAD_SUBJECT_PREFIX = "load_metrics"
FPM_SUBJECT_PREFIX = "fpm"
# load-loop ticks (0.5 s each) between G4 sweeps
G4_SWEEP_TICKS = 60
# decode-side pulls whose tier stats the worker keeps (pull_stats)
PULL_STATS_KEPT = 256


class TorchEngineWorker:
    def __init__(self, runtime: DistributedRuntime, config: EngineConfig,
                 namespace: str = "dynamo", component: str = "backend",
                 migration_limit: int = 3,
                 tokenizer_cfg: Optional[dict] = None,
                 params=None, device: DeviceLike = "cuda"):
        """`params`: the port's parameter tree on `device`, or None for
        the checkpoint at config.model_path, else random weights from
        config.seed (TorchEngine)."""
        self.runtime = runtime
        self.config = config
        self.namespace = namespace
        self.component = component
        self.migration_limit = migration_limit
        self._chat_template: Optional[str] = None
        if tokenizer_cfg is None and config.model_path:
            eos_ids = config.resolve_eos_ids()
            # the tokenizer ships inline: a worker-local path would not
            # resolve on a frontend's host
            with open(os.path.join(config.model_path,
                                   "tokenizer.json")) as f:
                tokenizer_cfg = {"type": "hf", "json": f.read(),
                                 "eos_id": eos_ids[0] if eos_ids else None}
            self._chat_template = load_chat_template(config.model_path)
        self.tokenizer_cfg = tokenizer_cfg or {
            "type": "mock", "vocab_size": config.resolve_model().vocab_size}
        self.device = device
        self._params = params
        self.engine: Optional[TorchEngine] = None
        self.publisher: Optional[KvEventPublisher] = None
        self.served = None
        self._aux_served: list = []
        self._load_task: Optional[asyncio.Task] = None
        self._slo_task: Optional[asyncio.Task] = None
        self._slo_cancel = asyncio.Event()
        self._pull_clients: dict = {}
        # device-tier chunks staged for a receiver: (server, buffer) per
        # request, the buffer back to the server's pool once consumed
        self._chunk_refs = SenderChunkRegistry(
            on_drop=lambda ref: ref[0].release(ref[1]))
        # per decode-side pull (request id): its chunks and bytes by tier
        # and the device chunks' RPC s, event-wait ms and copy ms
        self.pull_stats: "OrderedDict[str, Dict[str, float]]" = \
            OrderedDict()
        self._broker_id: Optional[int] = None
        self._kvbm_index: Optional[RemoteBlockIndex] = None
        self._kvbm_pull_client = None
        # the worker's own FPM window: the load loop feeds it, /metrics
        # and /debug/state read the engine numbers off it
        self._fpm_window = FpmWindow()
        self._debug_source_name: Optional[str] = None
        self.tier_costs: Optional[Dict[str, float]] = None

    @property
    def card(self) -> ModelDeploymentCard:
        m = self.config.resolve_model()
        eng = self.engine
        return ModelDeploymentCard(
            name=self.config.served_name,
            namespace=self.namespace,
            component=self.component,
            endpoint="generate",
            tokenizer=self.tokenizer_cfg,
            chat_template=self._chat_template,
            context_length=min(m.max_context, self.config.max_context),
            kv_cache_block_size=self.config.block_size,
            migration_limit=self.migration_limit,
            # JAX's runtime_config keys with this worker's effective values
            runtime_config={
                "total_kv_blocks": self.config.num_blocks,
                "max_num_seqs": self.config.max_num_seqs,
                "model_preset": self.config.model,
                "tp": self.config.tp,
                "dp": self.config.dp,
                "role": self.config.role,
                "kv_cache_dtype": (eng.kv_dtype if eng is not None
                                   else self.config.kv_cache_dtype),
                "prefill_chunk_tokens": self.config.chunk_budget,
                "prefill_packed": True,
                # "auto" = the CUDA kernels on CUDA tensors, "torch" = the
                # plain versions
                "attn_impl": (eng.model_cfg.attn_impl if eng is not None
                              else (self.config.attn_impl or "auto")),
                # a family without packed prefill (MLA) has no such
                # knob: "auto", as the JAX worker advertises it
                "packed_attn_impl": (
                    getattr(eng.model_cfg, "packed_attn_impl", "auto")
                    if eng is not None
                    else (self.config.packed_attn_impl or "auto")),
                # the effective mode (MLA falls back to "off", as JAX's)
                "sampling_epilogue": (eng.sampling_epilogue
                                      if eng is not None
                                      else self.config.sampling_epilogue),
                "overlap_scheduling": self.config.overlap_scheduling,
                # speculative decoding: the proposer and max draft length,
                # only where the engine speculates (live acceptance rides
                # the FPM stream's spec_verify records)
                **({"speculative": {"proposer": self.config.spec_decode,
                                    "k": self.config.spec_k}}
                   if eng is not None and eng.spec_enabled else {}),
                # the timeline-tracing capability (obs/)
                **({"tracing": True} if obs.enabled() else {}),
            },
        )

    async def start(self) -> "TorchEngineWorker":
        rt = self.runtime
        instance_id = new_instance_id()
        self.publisher = KvEventPublisher(
            rt, self.namespace, self.component, worker_id=instance_id)

        def kv_event_sink(stored, removed, tier):
            # on the loop thread (the engine hands batches over with
            # call_soon_threadsafe, in mutation order): ids are assigned
            # here and one drain task publishes them FIFO
            self.publisher.enqueue_batch(stored=stored, removed=removed,
                                         tier=tier)

        self.engine = TorchEngine(self.config, params=self._params,
                                  device=self.device,
                                  kv_event_sink=kv_event_sink,
                                  kv_pull_fn=self._kv_pull)
        self._params = None  # the engine holds them now
        self.engine.transfer_identity = {
            "instance_id": instance_id,
            "namespace": self.namespace,
            "component": self.component,
        }
        # guided decoding validates candidate text with the MODEL'S
        # tokenizer (the engine falls back to the byte mock, which the
        # mock cards' frontends use too)
        try:
            self.engine.guided_codec = tokenizer_from_mdc(
                self.tokenizer_cfg)
        except Exception:
            logger.warning("guided codec unavailable; guided decoding "
                           "will use the byte fallback", exc_info=True)

        async def generate_handler(payload, ctx):
            request = PreprocessedRequest.from_dict(payload)
            ntok = 0
            tid = obs.trace_id_from_annotations(request.annotations)
            # log<->trace correlation: every record logged while serving
            # the stream carries the frontend's trace id
            bind_tok = obs.bind_trace_id(tid)
            # the worker-side request span, joined to the frontend's
            # `request` span by the propagated trace id
            t_obs = obs.begin()
            try:
                async for out in self.engine.generate(request,
                                                      token=ctx.token):
                    ntok += len(out.token_ids)
                    yield out.to_dict()
            finally:
                obs.end("worker_request", t_obs, trace_id=tid,
                        request_id=request.request_id, tokens=ntok)
                obs.unbind_trace_id(bind_tok)

        async def clear_handler(payload, ctx):
            n = await self.engine.clear_kv_blocks()
            yield {"cleared_blocks": n}

        async def kv_pull_handler(payload, ctx):
            """Receiver-paced pull ops (disagg/transfer.py): open ->
            header (with the CUDA IPC capability where this process has
            it), chunk -> one gathered chunk as host bytes or, asked
            `via: "cuda_ipc"`, staged in a device buffer whose handles
            the answer carries; close -> release.  Each chunk is ONE
            scheduler op on this engine, so its other requests
            interleave with the extraction."""
            op = payload.get("op")
            rid = payload["request_id"]
            if op == "open":
                n_blocks, prompt_len = await self.engine.parked_info(rid)
                srv = self._transfer_server()
                yield make_header(prompt_len,
                                  self.engine.kv_wire_layout(n_blocks),
                                  ipc=srv.capability if srv else None)
            elif op == "chunk":
                b0, n = int(payload["start"]), int(payload["count"])
                srv = (self._transfer_server()
                       if payload.get("via") == "cuda_ipc" else None)
                if srv is not None:
                    # asking for chunk i+1 proves chunk i was copied out:
                    # its buffer goes back to the pool before this one is
                    # staged
                    self._chunk_refs.release(rid)
                    arrs = await self.engine.extract_parked_chunk(
                        rid, b0, n, to_host=False)
                    # the copies and the event record queue on the
                    # engine's stream after the gather
                    slot, meta = srv.stage(arrs)
                    uid = next_uuid()
                    self._chunk_refs.park(rid, uid, (srv, slot))
                    yield {"uuid": uid, "block_start": b0,
                           "block_count": n, **meta}
                else:
                    arrs = await self.engine.extract_parked_chunk(
                        rid, b0, n)
                    yield encode_chunk_frame(b0, *arrs)
            elif op == "close":
                self._chunk_refs.release(rid)
                await self.engine.release_parked(rid)
                yield {}
            else:
                raise ValueError(f"unknown kv_pull op {op!r}")

        async def kvbm_pull_handler(payload, ctx):
            """Cross-worker pull (kvbm/remote.py): stream this worker's
            host-tier copies of the requested block run; a None hash marks
            where the run broke (a peer eviction)."""
            hashes = [wire_to_hash(h)
                      for h in list(payload.get("hashes", []))[:128]]
            blocks = await self.engine.read_host_blocks(hashes)
            for h, *arrays in blocks:
                frame = encode_block(h, *arrays)
                frame["h"] = hash_to_wire(h)
                yield frame
            if len(blocks) < len(hashes):
                yield {"h": None}

        comp = rt.namespace(self.namespace).component(self.component)
        self.served = await comp.endpoint("generate").serve_endpoint(
            generate_handler,
            metadata={"model": self.config.served_name},
            instance_id=instance_id,
            health_check_payload=CANARY_GENERATE_PAYLOAD,
        )
        self._aux_served = [
            await comp.endpoint("clear_kv_blocks").serve_endpoint(
                clear_handler, instance_id=instance_id),
            await comp.endpoint("kv_events_replay").serve_endpoint(
                self.publisher.replay_handler, instance_id=instance_id),
            await comp.endpoint("kv_pull").serve_endpoint(
                kv_pull_handler, instance_id=instance_id),
        ]
        if self.engine.kvbm is not None and self.config.kvbm_remote:
            self._aux_served.append(
                await comp.endpoint("kvbm_pull").serve_endpoint(
                    kvbm_pull_handler, instance_id=instance_id))
            self._kvbm_index = await RemoteBlockIndex(
                rt, self.namespace, self.component, instance_id).start()
            self._kvbm_pull_client = await (
                comp.endpoint("kvbm_pull").client().start())
            puller = RemoteKvbmPuller(
                self._kvbm_index, self._kvbm_pull_client,
                max_blocks=self.config.kvbm_remote_max_blocks)
            # corrupt pulled frames count like every other tier's
            # (tier "remote"), and the index marks the peer suspect
            puller.on_corruption = self.engine._note_kv_corruption
            self.engine.remote_kvbm_fetch = puller.fetch_run
        # co-resident engines pull device-resident chunks through the
        # process broker; registered once every endpoint is up, so a
        # failed start leaks no half-built engine into the registry
        broker.register_engine(instance_id, self.engine)
        self._broker_id = instance_id
        if self.engine.device.type == "cuda":
            # the opt-in's probe (a child process) runs before any pull
            await asyncio.to_thread(get_transfer_server)
        if self.config.warmup:
            # before the model becomes discoverable, so no request pays
            # for a kernel build; the step lock keeps a canary's step out
            await asyncio.to_thread(self.engine.warmup_decode)
        await register_model(rt, self.card, instance_id)
        self._load_task = asyncio.create_task(self._load_loop())
        # fleet introspection: this worker's live state on /debug/state
        self._debug_source_name = f"worker:{instance_id}"
        rt.register_debug_source(self._debug_source_name, self.debug_state)
        # SLA-aware admission input: the frontends' published SLO burn
        # rate into the engine, where a sustained burn makes prefill
        # chunks yield budget to decode (stale signals decay engine-side,
        # slo_burn_stale_s)
        self._slo_task = asyncio.create_task(self._slo_loop())
        logger.info("torch engine worker %d serving %s on %s", instance_id,
                    self.config.served_name, self.engine.device)
        return self

    def debug_state(self) -> dict:
        """Live scheduler/KV/drain snapshot for /debug/state and the fleet
        aggregator, with the JAX worker's keys.  Read-only over structures
        the scheduler thread mutates: copies first and tolerates a torn
        read (a debug dump never takes the step lock)."""
        eng = self.engine
        slots = []
        for s in list(eng._slots):
            if s is None:
                continue
            slots.append({
                "request_id": s.request.request_id,
                "prompt_len": s.prompt_len,
                "generated": s.generated,
                "prefilling": s.prefilling,
                "pulling": s.pulling,
                "inflight": s.inflight,
                "cached_tokens": s.cached_tokens,
            })
        fw = self._fpm_window
        return {
            "kind": "engine",
            "instance_id": (self.served.instance_id
                            if self.served is not None else None),
            "namespace": self.namespace,
            "component": self.component,
            "model": self.config.served_name,
            "role": self.config.role,
            "draining": eng.draining,
            "active_seqs": eng.num_active_seqs,
            "waiting": [s.request.request_id for s in list(eng.waiting)],
            "slots": slots,
            "tokens_in_flight": sum(
                s["prompt_len"] + s["generated"] for s in slots),
            "kv": eng.kv_occupancy(),
            "kv_usage": eng.kv_usage(),
            "kv_cache_dtype": eng.kv_dtype,
            "itl_ema_s": eng.itl_ema_s,
            "itl_p95_s": fw.decode_itl_p95_s(),
            "compile": fw.compile_stats(),
            "engine_metrics": dict(eng.metrics),
            "config": dict(self.card.runtime_config),
        }

    def _transfer_server(self):
        """The process's CUDA IPC server where the opt-in holds and it
        lives on the engine's device; else None."""
        srv = get_transfer_server()
        if srv is None or self.engine is None \
                or srv.device != self.engine.device:
            return None
        return srv

    async def _kv_pull(self, params: dict):
        """Decode-side pull source, best tier first: an engine of this
        process (broker: chunks stay on the device), else the sender's
        `kv_pull` endpoint over the request plane, chunks copied over
        CUDA IPC when both ends have it (negotiated per pull), else
        host-staged frames.  The engine validates the sender's layout."""
        src_engine = broker.lookup_engine(params["instance_id"])
        if src_engine is not None and src_engine is not self.engine:
            return broker.LocalEnginePullSource(src_engine,
                                                params["request_id"])
        key = (params.get("namespace", self.namespace),
               params.get("component", self.component))
        client = self._pull_clients.get(key)
        if client is None:
            ep = (self.runtime.namespace(key[0]).component(key[1])
                  .endpoint("kv_pull"))
            client = await ep.client().start()
            await client.wait_for_instances()
            self._pull_clients[key] = client
        stats = self.pull_stats[params["request_id"]] = {}
        while len(self.pull_stats) > PULL_STATS_KEPT:
            self.pull_stats.popitem(last=False)
        return NegotiatedPullSource(client, params,
                                    device=self.engine.device, stats=stats)

    async def _slo_loop(self) -> None:
        """Fold every frontend SLO summary into the engine's burn signal
        (the worst window wins, as the planner's SloObserver reduces
        it)."""
        subject = f"{SLO_SUBJECT_PREFIX}.{self.namespace}"
        try:
            async for subj, payload in self.runtime.event_plane.subscribe(
                    subject, cancel=self._slo_cancel):
                if subj != subject or self.engine is None:
                    continue
                try:
                    burns = payload.get("burn")
                    self.engine.set_slo_burn(
                        max((float(v) for v in burns.values()),
                            default=0.0)
                        if isinstance(burns, dict) else 0.0)
                except Exception:
                    # one malformed event (a non-dict payload included)
                    # must not kill the feed: a dead subscription would
                    # disable SLA-aware admission for the worker's life
                    logger.warning("malformed slo payload: %r", payload,
                                   exc_info=True)
        except asyncio.CancelledError:
            pass

    async def _load_loop(self) -> None:
        subject = f"{LOAD_SUBJECT_PREFIX}.{self.namespace}.{self.component}"
        fpm_subject = f"{FPM_SUBJECT_PREFIX}.{self.namespace}.{self.component}"
        plane = self.runtime.event_plane
        # this worker's /metrics surface on the system-status server
        m = self.runtime.metrics.scoped(component=self.component)
        tr = obs.tracer()
        if tr is not None:
            # per-span-kind duration histograms next to the engine gauges
            tr.bind_metrics(m)
        fw = self._fpm_window
        ticks = 0
        while True:
            await asyncio.sleep(0.5)
            ticks += 1
            eng, wid = self.engine, self.served.instance_id
            if ticks % G4_SWEEP_TICKS == 0:
                # the shared store is swept by every mounted worker
                try:
                    await eng.sweep_kvbm_g4()
                except Exception:
                    logger.warning("g4 sweep failed", exc_info=True)
            # device-tier buffers whose receiver died mid-pull (the
            # engine's parked-KV TTL)
            self._chunk_refs.sweep(eng.parked_ttl_s)
            steps = []
            while eng.fpm and len(steps) < 512:
                steps.append(eng.fpm.popleft())
            for rec in steps:
                fw.add(wid, rec)
            # capture-watch records -> the per-family compile histogram,
            # then the gauge surface: headline FPM aggregates, per-phase
            # roofline MFU/MBU from the cost counts over dispatch gaps,
            # KV occupancy per tier
            observe_compile_records(m, steps)
            export_engine_gauges(
                m, fw, peak_tflops=self.config.peak_tflops,
                peak_hbm_gbps=self.config.peak_hbm_gbps,
                occupancy=eng.kv_occupancy())
            # per-tier onboard costs for the router's tiered selector:
            # the measured prefill rate over the cache's per-block bytes,
            # recomputed each tick as the window fills (the selector
            # falls back to its defaults until the first publish)
            flops_rate, _ = fw._phase_rates("prefill")
            tok_rate = fw.prefill_tokens_per_s()
            if flops_rate > 0.0 and tok_rate > 0.0:
                self.tier_costs = compute_tier_costs(
                    prefill_flops_per_s=flops_rate,
                    flops_per_token=flops_rate / tok_rate,
                    bytes_per_block=eng.kv_block_bytes(),
                    block_tokens=self.config.block_size)
            tier_costs = self.tier_costs
            # degraded mode: a non-closed tier is priced AT recompute, so
            # the selector stops steering traffic toward its blocks
            if eng.kvbm is not None:
                states = eng.kvbm.tier_states()
                tier_costs = degraded_tier_costs(tier_costs, states)
                for tier, st in states.items():
                    m.set("dynamo_kvbm_tier_state",
                          float(kvbm_breaker.NUMERIC.get(st, 0)),
                          "KV tier circuit-breaker state "
                          "(0=closed, 1=half_open, 2=open)", tier=tier)
            for (tier, action), n in eng.kv_integrity_counters().items():
                m.set("dynamo_kv_integrity_failures_total", float(n),
                      "checksum quarantines and deadline/breaker I/O "
                      "failures across the KV cache fabric",
                      tier=tier, action=action)
            try:
                if steps:
                    await plane.publish(fpm_subject,
                                        {"worker_id": wid, "steps": steps})
                await plane.publish(subject, {
                    "worker_id": wid,
                    "active_seqs": eng.num_active_seqs,
                    "kv_usage": eng.kv_usage(),
                    "kv_total_blocks": self.config.num_blocks,
                    **({"kv_tier_costs": tier_costs} if tier_costs
                       else {}),
                    "kv_cache_dtype": eng.kv_dtype,
                    "engine_metrics": dict(eng.metrics),
                    "requests_total": eng.metrics["requests"],
                    "prompt_tokens_total": eng.metrics["prompt_tokens"],
                    "itl_ema_s": eng.itl_ema_s,
                })
            except Exception:
                logger.warning("load/fpm publish failed", exc_info=True)
            m.set("dynamo_engine_active_seqs", eng.num_active_seqs)
            m.set("dynamo_engine_waiting_seqs", len(eng.waiting))
            m.set("dynamo_engine_kv_usage", eng.kv_usage())
            m.set("dynamo_engine_itl_ema_seconds", eng.itl_ema_s)

    async def drain(self, deadline_s: float = 5.0) -> None:
        """Graceful drain (the SIGTERM path): withdraw this worker's
        routing identity from discovery, reject new work with the
        migratable "worker draining" marker, let in-flight requests
        finish until the deadline, then drain_abort() the rest so the
        frontend's token-replay migration moves them to surviving
        workers.  Only this worker's keys are deleted."""
        if self.engine is None:
            return
        self.engine.draining = True
        if self.served is not None:
            logger.warning("draining torch engine worker %d (deadline "
                           "%.1fs)", self.served.instance_id, deadline_s)
            await deregister_model(self.runtime, self.card,
                                   self.served.instance_id)
            await self.runtime.discovery.delete(self.served.instance.key())
        t0 = time.monotonic()
        while (self.engine.num_active_seqs
               and time.monotonic() - t0 < deadline_s):
            await asyncio.sleep(0.02)
        self.engine.drain_abort()
        logger.info("drain: dropped %d staged device-tier chunk refs",
                    self._chunk_refs.clear())

    async def close(self) -> None:
        if self._debug_source_name is not None:
            self.runtime.unregister_debug_source(self._debug_source_name)
            self._debug_source_name = None
        if self._broker_id is not None:
            broker.deregister_engine(self._broker_id)
            self._broker_id = None
        for client in self._pull_clients.values():
            await client.close()
        self._pull_clients = {}
        if self._kvbm_index is not None:
            await self._kvbm_index.close()
            self._kvbm_index = None
        if self._kvbm_pull_client is not None:
            await self._kvbm_pull_client.close()
            self._kvbm_pull_client = None
        if self._load_task is not None:
            self._load_task.cancel()
            await asyncio.gather(self._load_task, return_exceptions=True)
            self._load_task = None
        if self._slo_task is not None:
            self._slo_cancel.set()
            self._slo_task.cancel()
            await asyncio.gather(self._slo_task, return_exceptions=True)
            self._slo_task = None
        self._chunk_refs.clear()
        srv = self._transfer_server()
        if srv is not None:
            srv.close()
        if self.engine is not None:
            await self.engine.close()
        if self.served is not None:
            await deregister_model(self.runtime, self.card,
                                   self.served.instance_id)
        for served in self._aux_served:
            await served.shutdown()
        self._aux_served = []
        if self.served is not None:
            await self.served.shutdown()

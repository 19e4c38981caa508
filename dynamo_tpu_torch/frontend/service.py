"""OpenAI-compatible HTTP service + model discovery.

A copy of dynamo_tpu/frontend/service.py on the port's own HTTP server
(runtime/http_server.py) instead of aiohttp: the same routes
(/v1/models, /v1/completions and /v1/chat/completions, streamed and
unary, /v1/embeddings, /health, /metrics, the Anthropic family
/v1/messages in frontend/anthropic.py, Responses, Files and Batches in
frontend/openai_extra.py), status codes, JSON bodies, SSE events and
`dynamo_frontend_*` metric families.

The ModelWatcher serves the three card roles as JAX's does: decode
(`both`/`decode`) workers behind the model's route, a prefill fleet
behind a PrefillOrchestrator (disagg/prefill_router.py) and an encoder
fleet behind an EncoderHop (multimodal/hop.py); with a session-affinity
TTL it wraps the route in a SessionAffinityRouter (frontend/affinity.py),
and with `namespaces` it serves only those pools' cards.  The service
keeps the forensics plane (obs/forensics.py) unless DYN_FORENSICS=0.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Dict, Optional

from .. import obs
from ..protocols import ModelDeploymentCard
from ..runtime import (
    DistributedRuntime,
    EngineError,
    RouterMode,
)
from ..runtime.discovery import MDC_PREFIX
from ..runtime.http_server import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from .pipeline import ModelPipeline

logger = logging.getLogger(__name__)


class ModelManager:
    """model name → pipeline; populated by the watcher."""

    def __init__(self) -> None:
        self.models: Dict[str, ModelPipeline] = {}

    def get(self, name: str) -> Optional[ModelPipeline]:
        return self.models.get(name)

    def list_models(self) -> list[Dict[str, Any]]:
        return [
            {"id": name, "object": "model", "owned_by": "dynamo_tpu",
             "created": 0}
            for name in sorted(self.models)
        ]


class ModelWatcher:
    """Subscribes to `v1/mdc/**`; builds/tears down per-model pipelines."""

    def __init__(self, runtime: DistributedRuntime, manager: ModelManager,
                 router_mode: RouterMode = RouterMode.ROUND_ROBIN,
                 make_route=None, disagg_config=None,
                 session_affinity_ttl: Optional[float] = None,
                 namespaces: Optional[set] = None):
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        # make_route(mdc) -> optional coroutine route(req, avoid) -> instance_id
        self.make_route = make_route
        self.disagg_config = disagg_config
        # sticky agent-session routing (ref session_affinity/): None = off
        self.session_affinity_ttl = session_affinity_ttl
        # pool scoping (global_router/): a pool frontend serves ONLY its
        # own namespace's models; None = watch every namespace (the
        # single-frontend deployments that predate pools)
        self.namespaces = namespaces
        self._cancel = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._clients: Dict[str, Any] = {}        # model name -> client
        self._key_to_name: Dict[str, str] = {}    # discovery key -> model name
        self._key_role: Dict[str, str] = {}       # discovery key -> role
        self._model_keys: Dict[str, set] = {}     # model name -> decode keys
        self._prefill_keys: Dict[str, set] = {}   # model name -> prefill keys
        self._prefill_orchs: Dict[str, Any] = {}  # model name -> orchestrator
        self._encoder_keys: Dict[str, set] = {}   # model name -> encoder keys
        self._encoder_hops: Dict[str, Any] = {}   # model name -> EncoderHop

    async def start(self) -> "ModelWatcher":
        if self._task is None:
            self._task = asyncio.create_task(self._loop())
        return self

    async def _loop(self) -> None:
        try:
            async for ev in self.runtime.discovery.watch(
                MDC_PREFIX + "/", cancel=self._cancel
            ):
                try:
                    if ev.type == "put" and ev.value:
                        mdc = ModelDeploymentCard.from_dict(ev.value)
                        if (self.namespaces is not None
                                and mdc.namespace not in self.namespaces):
                            continue
                        await self._add(ev.key, mdc)
                    elif ev.type == "delete":
                        await self._remove_by_key(ev.key)
                except Exception:
                    logger.exception("model watcher failed applying %s", ev)
        except asyncio.CancelledError:
            pass

    async def _add(self, key: str, mdc: ModelDeploymentCard) -> None:
        self._key_to_name[key] = mdc.name
        role = mdc.runtime_config.get("role", "both")
        if role == "prefill":
            self._key_role[key] = "prefill"
            await self._add_prefill(key, mdc)
            return
        if role == "encoder":
            self._key_role[key] = "encoder"
            await self._add_encoder(key, mdc)
            return
        self._key_role[key] = "decode"
        self._model_keys.setdefault(mdc.name, set()).add(key)
        existing = self.manager.models.get(mdc.name)
        if existing is not None:
            if existing.mdc.to_dict() == mdc.to_dict():
                return
            # MDC update (new template/tokenizer/limits): rebuild the
            # pipeline but keep the existing endpoint client, route hook,
            # and prefill orchestrator (dropping prefill here would silently
            # disable disaggregated serving until the prefill card republishes)
            self.manager.models[mdc.name] = ModelPipeline(
                mdc, existing.client, route=existing.migration.route,
                prefill=existing.prefill or self._prefill_orchs.get(mdc.name),
                encoder=existing.encoder or self._encoder_hops.get(mdc.name),
            )
            logger.info("model %s updated", mdc.name)
            return
        ep = (
            self.runtime.namespace(mdc.namespace)
            .component(mdc.component)
            .endpoint(mdc.endpoint)
        )
        client = await ep.client(self.router_mode).start()
        route = None
        if self.make_route is not None:
            route = await self.make_route(mdc, client)
        if self.session_affinity_ttl is not None:
            from .affinity import AffinityCoordinator, SessionAffinityRouter

            coord = AffinityCoordinator(
                self.session_affinity_ttl,
                metrics=self.runtime.metrics.scoped(component="frontend"),
            ).start()
            await coord.enable_replica_sync(self.runtime, mdc.namespace,
                                            mdc.component)
            route = SessionAffinityRouter(coord, client, inner=route)
        self.manager.models[mdc.name] = ModelPipeline(
            mdc, client, route=route,
            prefill=self._prefill_orchs.get(mdc.name),
            encoder=self._encoder_hops.get(mdc.name),
        )
        self._clients[mdc.name] = client
        logger.info("model %s registered (endpoint %s/%s/%s)",
                    mdc.name, mdc.namespace, mdc.component, mdc.endpoint)

    async def _add_prefill(self, key: str, mdc: ModelDeploymentCard) -> None:
        """A prefill-fleet card: attach a PrefillOrchestrator to the model's
        pipeline instead of serving it directly (ref: PrefillRouter)."""
        from ..disagg.prefill_router import PrefillOrchestrator

        self._prefill_keys.setdefault(mdc.name, set()).add(key)
        if mdc.name in self._prefill_orchs:
            return
        ep = (
            self.runtime.namespace(mdc.namespace)
            .component(mdc.component)
            .endpoint(mdc.endpoint)
        )
        pclient = await ep.client(RouterMode.ROUND_ROBIN).start()
        orch = PrefillOrchestrator(
            pclient, config=self.disagg_config,
            decode_overlap_fn=self._make_overlap_fn(mdc.name),
        )
        self._prefill_orchs[mdc.name] = orch
        pipeline = self.manager.models.get(mdc.name)
        if pipeline is not None:
            pipeline.prefill = orch
        logger.info("prefill fleet attached for model %s (%s/%s)",
                    mdc.name, mdc.namespace, mdc.component)

    async def _add_encoder(self, key: str, mdc: ModelDeploymentCard) -> None:
        """An encoder-fleet card: attach an EncoderHop to the model's
        pipeline (ref: encoder_router.rs — the encode hop of
        encode/prefill/decode disaggregation)."""
        from ..multimodal.hop import EncoderHop

        self._encoder_keys.setdefault(mdc.name, set()).add(key)
        if mdc.name in self._encoder_hops:
            return
        ep = (
            self.runtime.namespace(mdc.namespace)
            .component(mdc.component)
            .endpoint(mdc.endpoint)
        )
        eclient = await ep.client(RouterMode.ROUND_ROBIN).start()
        hop = EncoderHop(
            eclient,
            image_token_id=int(
                mdc.runtime_config.get("image_token_id", 0)),
        )
        self._encoder_hops[mdc.name] = hop
        pipeline = self.manager.models.get(mdc.name)
        if pipeline is not None:
            pipeline.encoder = hop
        logger.info("encoder fleet attached for model %s (%s/%s)",
                    mdc.name, mdc.namespace, mdc.component)

    def _make_overlap_fn(self, name: str):
        """Effective-ISL input for conditional disagg: best decode-fleet
        prefix overlap, from the model's KV router index (0 without one)."""

        async def overlap(request) -> int:
            pipeline = self.manager.models.get(name)
            if pipeline is None:
                return 0
            route = pipeline.migration.route
            indexer = getattr(route, "indexer", None)
            if indexer is None:
                return 0
            from ..tokens import compute_block_hashes_for_request

            bs = pipeline.mdc.kv_cache_block_size
            hashes = compute_block_hashes_for_request(
                request.token_ids, bs, lora_name=request.lora_name,
                media_hashes=request.media_hashes,
            )
            overlaps = indexer.find_matches(hashes)
            return max(overlaps.values(), default=0) * bs

        return overlap

    async def _remove_by_key(self, key: str) -> None:
        name = self._key_to_name.pop(key, None)
        if name is None:
            return
        role = self._key_role.pop(key, "decode")
        if role == "prefill":
            pkeys = self._prefill_keys.get(name)
            if pkeys is not None:
                pkeys.discard(key)
                if pkeys:
                    return
            self._prefill_keys.pop(name, None)
            orch = self._prefill_orchs.pop(name, None)
            pipeline = self.manager.models.get(name)
            if pipeline is not None:
                pipeline.prefill = None  # fall back to aggregated serving
            if orch is not None:
                await orch.close()
            logger.info("prefill fleet for %s gone; serving aggregated", name)
            return
        if role == "encoder":
            ekeys = self._encoder_keys.get(name)
            if ekeys is not None:
                ekeys.discard(key)
                if ekeys:
                    return
            self._encoder_keys.pop(name, None)
            hop = self._encoder_hops.pop(name, None)
            pipeline = self.manager.models.get(name)
            if pipeline is not None:
                pipeline.encoder = None  # multimodal requests now fail fast
            if hop is not None:
                await hop.client.close()
            logger.info("encoder fleet for %s gone", name)
            return
        keys = self._model_keys.get(name)
        if keys is not None:
            keys.discard(key)
            if keys:
                return  # other workers still serve this model
        self._model_keys.pop(name, None)
        pipeline = self.manager.models.pop(name, None)
        await self._close_route(pipeline)
        client = self._clients.pop(name, None)
        if client is not None:
            await client.close()
        logger.info("model %s deregistered (last worker gone)", name)

    @staticmethod
    async def _close_route(pipeline) -> None:
        route = getattr(getattr(pipeline, "migration", None), "route", None)
        if route is not None and hasattr(route, "close"):
            await route.close()
        ec = getattr(pipeline, "embed_client", None)
        if ec is not None:
            await ec.close()

    async def close(self) -> None:
        self._cancel.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for orch in self._prefill_orchs.values():
            await orch.close()
        for hop in self._encoder_hops.values():
            await hop.client.close()
        for pipeline in self.manager.models.values():
            await self._close_route(pipeline)
        for client in self._clients.values():
            await client.close()


class _LatencyProbe:
    """Per-token ITL / output-token recorder over the delta stream.
    (Request-level TTFT/e2e/queue moved to the SLO plane — obs/slo.py —
    fed once per request from RequestTracker.finish; the probe keeps
    the per-token ITL samples a request-level average can't give.)"""

    def __init__(self, metrics, model: str):
        self.m = metrics
        self.model = model
        self.last: Optional[float] = None

    def on_delta(self, token_count: int) -> None:
        if token_count <= 0:
            return
        now = time.monotonic()
        if self.last is not None:
            # a burst of n tokens arriving together = n ITL samples of
            # gap/n (token-level spacing, same convention as loadgen)
            per_tok = (now - self.last) / token_count
            for _ in range(token_count):
                self.m.observe("dynamo_frontend_itl_seconds", per_tok,
                               model=self.model)
        self.last = now
        self.m.inc("dynamo_frontend_output_tokens_total", token_count,
                   model=self.model)


class HttpService:
    def __init__(self, runtime: DistributedRuntime, manager: ModelManager,
                 host: str = "0.0.0.0", port: int = 8000,
                 busy_threshold: Optional[int] = None,
                 slo=None, advertise: Optional[bool] = None):
        self.runtime = runtime
        self.manager = manager
        self.host = host
        self.port = port
        self.busy_threshold = busy_threshold
        # discovery advertisement: None (default) registers the frontend
        # instance only when a system-status server is up (the pre-pool
        # behavior — obs/fleet.py needs system_addr to scrape it); True
        # forces registration so the global router can discover this
        # frontend as a pool member even without DYN_SYSTEM_PORT
        self.advertise = advertise
        self.inflight = 0
        self._slo_task: Optional[asyncio.Task] = None
        self._fleet_instance = None
        self._fleet_instance_id: Optional[int] = None
        from .request_trace import TraceConfig, TraceSink

        self.trace_sink = TraceSink(TraceConfig.from_env())
        m = runtime.metrics.scoped(component="frontend")
        self._m_requests = m
        # latency surface (ref metrics.rs: the reference's frontend
        # exports TTFT/ITL/inflight so routing regressions are diagnosable
        # from /metrics alone).  Request-level TTFT/e2e/queue histograms
        # + goodput/burn-rate live on the SLO plane (obs/slo.py), fed
        # from RequestTracker.finish; the per-token ITL histogram stays
        # here on the delta-stream probe.
        _lat_buckets = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
        m.histogram("dynamo_frontend_itl_seconds",
                    "inter-token latency (per-token delta gaps)",
                    ("model",), buckets=_lat_buckets)
        from ..obs.slo import SloConfig, SloPlane

        self.slo_plane = SloPlane(m, slo or SloConfig())
        # forensics plane (obs/forensics.py): always-on tail-exemplar
        # reservoir fed from RequestTracker.finish, served on the
        # token-gated /debug/requests route (runtime/system_status.py).
        # DYN_FORENSICS=0 disables BOTH the reservoir and per-request
        # hop recording (timeline_on below).
        from ..obs.forensics import ForensicsPlane, forensics_enabled

        self.forensics = (ForensicsPlane(m,
                                         slo_config=self.slo_plane.config)
                          if forensics_enabled() else None)
        self.server = HttpServer(host, port)
        self.server.add_get("/v1/models", self.h_models)
        self.server.add_post("/v1/chat/completions", self.h_chat)
        self.server.add_post("/v1/completions", self.h_completions)
        self.server.add_post("/v1/embeddings", self.h_embeddings)
        self.server.add_get("/health", self.h_health)
        self.server.add_get("/metrics", self.h_metrics)
        # Anthropic Messages API (ref anthropic.rs): same pipelines,
        # Anthropic request/SSE shapes
        from .anthropic import AnthropicRoutes

        AnthropicRoutes(self).mount(self.server)
        # Responses + Files + Batches (ref openai.rs:2297,3112)
        from .openai_extra import ExtraRoutes

        self.extra = ExtraRoutes(self)
        self.extra.mount(self.server)

    @property
    def bound_port(self) -> Optional[int]:
        """The port the server listens on (port 0 picks a free one)."""
        return self.server.bound_port

    # -- helpers ----------------------------------------------------------
    def _inflight_delta(self, d: int) -> None:
        self.inflight += d
        self._m_requests.set("dynamo_frontend_inflight", self.inflight)

    def _busy(self) -> bool:
        return (
            self.busy_threshold is not None
            and self.inflight >= self.busy_threshold
        )

    @staticmethod
    def _error(status: int, msg: str, etype: str = "invalid_request_error"):
        return json_response(
            {"error": {"message": msg, "type": etype}}, status=status
        )

    # -- routes -----------------------------------------------------------
    async def h_health(self, request: Request) -> Response:
        return json_response(
            {"status": "healthy", "models": sorted(self.manager.models)}
        )

    async def h_metrics(self, request: Request) -> Response:
        # age the goodput/burn windows on scrape, so an idle frontend's
        # gauges roll past a breach instead of freezing on it
        self.slo_plane.refresh()
        return Response(body=self.runtime.metrics.render(),
                        content_type="text/plain")

    async def h_models(self, request: Request) -> Response:
        data = self.manager.list_models()
        for name, base in sorted(self._lora_adapters().items()):
            data.append({"id": name, "object": "model",
                         "owned_by": "dynamo_tpu", "created": 0,
                         "parent": base})
        return json_response({"object": "list", "data": data})

    _LORA_SCAN_TTL_S = 5.0

    def _lora_adapters(self) -> Dict[str, str]:
        """adapter name -> base model, from the shared DYN_LORA_PATH tree
        (the same tree workers lazy-load from — ref lora/source.rs).
        Cached with a short TTL: the scan reads adapter_config.json per
        adapter and must not run per request on the event loop."""
        now = time.monotonic()
        cached = getattr(self, "_lora_scan", None)
        if cached is not None and now < cached[0]:
            return cached[1]
        root = os.environ.get("DYN_LORA_PATH")
        out: Dict[str, str] = {}
        if root:
            from ..lora.source import LocalLoraSource

            src = LocalLoraSource(root)
            for name in src.list():
                try:
                    out[name] = src.config(name).get(
                        "base_model_name_or_path") or ""
                except (OSError, json.JSONDecodeError):
                    continue
        self._lora_scan = (now + self._LORA_SCAN_TTL_S, out)
        return out

    def _resolve_pipeline(self, model: str):
        """Model name -> (pipeline, lora_name).  An adapter name resolves
        to its base model's pipeline with lora_name set (the engine
        applies the adapter; hashing/routing salt on it)."""
        pipeline = self.manager.get(model)
        if pipeline is not None:
            return pipeline, None
        base = self._lora_adapters().get(model)
        if base is None:
            return None, None
        p = self.manager.get(base)
        if p is None and len(self.manager.models) == 1:
            # single-model deployment whose served name differs from the
            # adapter's recorded base: serve it anyway (ref behavior:
            # adapters are deployment-scoped)
            p = next(iter(self.manager.models.values()))
        return p, (model if p is not None else None)

    async def h_chat(self, request: Request):
        return await self._handle_inference(request, chat=True)

    async def h_completions(self, request: Request):
        return await self._handle_inference(request, chat=False)

    async def h_embeddings(self, request: Request) -> Response:
        """/v1/embeddings: input (string | [string] | [ints] | [[ints]])
        -> pooled vectors from the worker fleet's `embed` endpoint (ref:
        the reference's embeddings route family).  Shares the inference
        routes' overload gate and request metrics — a dense forward per
        item is not a cheap route."""
        if self._busy():
            return self._error(503, "service busy", "overloaded_error")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return self._error(400, "invalid JSON body")
        model = body.get("model", "")
        pipeline = self.manager.get(model)
        if pipeline is None:
            return self._error(
                404, f"model {model!r} not found; available: "
                     f"{sorted(self.manager.models)}", "not_found_error")
        raw = body.get("input")
        if raw is None:
            return self._error(400, "'input' is required")
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, list) and raw \
                and all(isinstance(x, int) for x in raw):
            inputs = [raw]
        elif isinstance(raw, list):
            inputs = raw
        else:
            return self._error(400, "'input' must be a string, token "
                                    "array, or list thereof")
        try:
            tok_lists = [
                list(item) if isinstance(item, list)
                else pipeline.preprocessor.tokenizer.encode(item)
                for item in inputs
            ]
        except (TypeError, ValueError, AttributeError) as e:
            return self._error(400, f"invalid embedding input: {e}")
        async with pipeline.embed_lock:  # concurrent first calls race
            client = pipeline.embed_client
            if client is None:
                mdc = pipeline.mdc
                ep = (self.runtime.namespace(mdc.namespace)
                      .component(mdc.component).endpoint("embed"))
                client = await ep.client().start()
                pipeline.embed_client = client

        async def one(i: int, toks: list) -> dict:
            async for out in client.generate({"token_ids": toks}):
                return {"object": "embedding", "index": i,
                        "embedding": out["embedding"]}
            raise EngineError("embed endpoint returned no frames")

        self._inflight_delta(+1)
        self._m_requests.inc("dynamo_frontend_requests_total", model=model)
        t0 = time.monotonic()
        try:
            data = await asyncio.gather(
                *(one(i, t) for i, t in enumerate(tok_lists)))
        except Exception as e:
            msg = str(e)
            if "tokens; embedding max is" in msg:
                # deterministic client error surfaced from the engine
                return self._error(400, msg)
            logger.exception("embeddings failed")
            return self._error(
                500, f"embeddings failed (does this model family support "
                     f"embedding?): {e}", "server_error")
        finally:
            self._inflight_delta(-1)
            self._m_requests.observe(
                "dynamo_frontend_request_duration_seconds",
                time.monotonic() - t0, model=model)
        prompt_tokens = sum(len(t) for t in tok_lists)
        return json_response({
            "object": "list", "model": model, "data": list(data),
            "usage": {"prompt_tokens": prompt_tokens,
                      "total_tokens": prompt_tokens},
        })

    async def _handle_inference(self, request: Request, chat: bool):
        if self._busy():
            return self._error(503, "service busy", "overloaded_error")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return self._error(400, "invalid JSON body")
        model = body.get("model", "")
        pipeline, lora_name = self._resolve_pipeline(model)
        if pipeline is None:
            return self._error(
                404, f"model {model!r} not found; available: "
                     f"{sorted(self.manager.models)}", "not_found_error")
        if chat and not isinstance(body.get("messages"), list):
            return self._error(400, "'messages' must be a list")
        try:
            req = (pipeline.preprocessor.preprocess_chat(body) if chat
                   else pipeline.preprocessor.preprocess_completion(body))
        except Exception as e:
            return self._error(400, f"preprocessing failed: {e}")
        if lora_name is not None:
            req.lora_name = lora_name
        # agent session identity from headers (ref protocols/agents.rs)
        from .affinity import session_affinity_from_headers

        req.session_id, req.session_final = session_affinity_from_headers(
            request.headers)
        # per-request trace record (ref request_trace/): placement, timing,
        # finish metadata — emitted at request end when tracing is enabled
        from .request_trace import RequestTracker

        tracker = RequestTracker.from_headers(
            request.headers, req.request_id, model, self.trace_sink,
            slo=self.slo_plane, forensics=self.forensics,
            timeline_on=self.forensics is not None,
            session_id=req.session_id,
            endpoint="chat" if chat else "completions",
            input_tokens=len(req.token_ids))
        # mint/propagate the trace context (request_trace.propagate):
        # worker logs and timeline spans join the same trace_id
        tracker.propagate(req)
        # log<->trace correlation: every log record emitted while this
        # handler runs carries the trace_id (runtime/logging.py
        # TraceIdFilter), so log lines, spans, and the request_end
        # record all join on one id.  Unbound in the finally below:
        # keep-alive requests share the connection's task context, and
        # a leaked binding would stamp THIS request's id onto the next
        # request's logs.  Bound just before the try whose finally
        # unbinds it — the encoder block below has early returns that
        # would otherwise leak the binding.
        if req.multimodal and pipeline.encoder is not None:
            # encode here (not inside the pipeline) so usage accounting
            # and conditional disagg see the spliced placeholder tokens
            try:
                req = await pipeline.encoder.encode_and_attach(req)
            except Exception as e:
                logger.exception("encoder hop failed")
                tracker.finish(error=f"media encoding failed: {e}")
                return self._error(502, f"media encoding failed: {e}",
                                   "server_error")
            if len(req.token_ids) >= pipeline.mdc.context_length:
                # re-validate: the splice can push a prompt that passed
                # preprocessing past the context window
                tracker.finish(error="context length exceeded after "
                                     "multimodal splice")
                return self._error(
                    400, f"prompt is {len(req.token_ids)} tokens with "
                         f"image placeholders, exceeding the model's "
                         f"context length of {pipeline.mdc.context_length}")

        # output parsers (ref preprocessor.rs stream parsers): tool-call
        # extraction when the request advertises tools; reasoning spans
        # when the model card declares a reasoning parser
        from .parsers import OutputParser

        forced_tool = "forced_tool_call" in (req.annotations or [])
        parser = (OutputParser.for_request(pipeline, body)
                  if chat and not forced_tool else None)
        include_usage = bool(
            (body.get("stream_options") or {}).get("include_usage"))

        token = self.runtime.root_token.child()
        self._inflight_delta(+1)
        self._m_requests.inc("dynamo_frontend_requests_total", model=model)
        t0 = time.monotonic()
        t_obs = obs.begin()
        bind_tok = obs.bind_trace_id(tracker.trace_id)
        try:
            if body.get("stream"):
                return await self._stream_response(
                    request, pipeline, req, token, chat, model,
                    parser=parser, include_usage=include_usage,
                    tracker=tracker)
            return await self._unary_response(pipeline, req, token, chat,
                                              model, parser=parser,
                                              tracker=tracker)
        finally:
            obs.end("request", t_obs, trace_id=tracker.trace_id,
                    request_id=req.request_id, model=model)
            obs.unbind_trace_id(bind_tok)
            self._inflight_delta(-1)
            self._m_requests.observe(
                "dynamo_frontend_request_duration_seconds",
                time.monotonic() - t0, model=model)
            token.detach()

    @staticmethod
    def _kv_overlap_tokens(pipeline: ModelPipeline,
                           request_id: str) -> Optional[int]:
        """Best-effort cached-prefix size from the KV router's slot
        manager (None when no KV router is attached)."""
        route = pipeline.migration.route
        seqs = getattr(route, "sequences", None)
        if seqs is None:
            seqs = getattr(getattr(route, "inner", None), "sequences", None)
        if seqs is None:
            return None
        return seqs.overlap_of(request_id) * pipeline.mdc.kv_cache_block_size

    async def _unary_response(self, pipeline: ModelPipeline, req, token,
                              chat: bool, model: str,
                              parser=None, tracker=None) -> Response:
        text_parts: list[str] = []
        reasoning_parts: list[str] = []
        tool_calls: list[dict] = []
        finish = None
        ntok = 0

        def feed(text: str) -> None:
            if parser is None:
                text_parts.append(text)
                return
            out = parser.push(text)
            text_parts.append(out.content)
            reasoning_parts.append(out.reasoning)
            tool_calls.extend(out.tool_calls)

        probe = _LatencyProbe(self._m_requests, model)
        try:
            async for d in pipeline.generate_deltas(req, token=token,
                                                    tracker=tracker):
                if tracker is not None and ntok == 0 and d.token_count:
                    tracker.cached_tokens = self._kv_overlap_tokens(
                        pipeline, req.request_id)
                feed(d.text)
                probe.on_delta(d.token_count)
                if tracker is not None:
                    tracker.on_tokens(d.token_count)
                ntok += d.token_count
                if d.finish_reason:
                    finish = d.finish_reason
        except asyncio.CancelledError:
            token.kill()  # client went away; stop the engine
            if tracker is not None:
                tracker.finish(error="client_disconnected")
            raise
        except Exception as e:
            logger.exception("generation failed")
            if tracker is not None:
                tracker.finish(error=str(e))
            return self._error(500, f"generation failed: {e}", "server_error")
        if parser is not None:
            out = parser.flush()
            text_parts.append(out.content)
            reasoning_parts.append(out.reasoning)
            tool_calls.extend(out.tool_calls)
        text = "".join(text_parts)
        if chat and "forced_tool_call" in (req.annotations or []):
            # guided tool envelope (preprocessor tool_choice): the text
            # IS {"name":..., "arguments": {...}} — wrap as a tool call
            from .parsers import envelope_to_tool_call

            call = envelope_to_tool_call(text)
            if call is not None:
                tool_calls = [call]
                text = ""
        usage = {
            "prompt_tokens": len(req.token_ids),
            "completion_tokens": ntok,
            "total_tokens": len(req.token_ids) + ntok,
        }
        rid = req.request_id
        created = int(time.time())
        if chat:
            message: Dict[str, Any] = {"role": "assistant", "content": text}
            reasoning = "".join(reasoning_parts)
            if reasoning:
                message["reasoning_content"] = reasoning
            if tool_calls:
                message["tool_calls"] = tool_calls
                finish = "tool_calls"
            payload = {
                "id": rid, "object": "chat.completion", "created": created,
                "model": model,
                "choices": [{
                    "index": 0,
                    "message": message,
                    "finish_reason": finish or "stop",
                }],
                "usage": usage,
            }
        else:
            payload = {
                "id": rid, "object": "text_completion", "created": created,
                "model": model,
                "choices": [{"index": 0, "text": text,
                             "finish_reason": finish or "stop"}],
                "usage": usage,
            }
        headers = {}
        if tracker is not None:
            tracker.add_tool_calls(tool_calls)
            tracker.finish(finish_reason=(payload["choices"][0]
                                          .get("finish_reason")))
            headers["X-Request-Id"] = tracker.x_request_id
        return json_response(payload, headers=headers)

    async def _stream_response(self, request: Request,
                               pipeline: ModelPipeline, req, token,
                               chat: bool, model: str, parser=None,
                               include_usage: bool = False,
                               tracker=None) -> StreamResponse:
        hdrs = {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        }
        if tracker is not None:
            hdrs["X-Request-Id"] = tracker.x_request_id
        resp = StreamResponse(headers=hdrs)
        await resp.prepare(request)
        rid = req.request_id
        created = int(time.time())

        def chunk(delta_text: Optional[str], finish: Optional[str],
                  first: bool = False, reasoning: str = "",
                  tool_calls: Optional[list] = None) -> bytes:
            if chat:
                delta: Dict[str, Any] = {}
                if first:
                    delta["role"] = "assistant"
                if delta_text:
                    delta["content"] = delta_text
                if reasoning:
                    delta["reasoning_content"] = reasoning
                if tool_calls:
                    delta["tool_calls"] = tool_calls
                choice = {"index": 0, "delta": delta, "finish_reason": finish}
                obj = {"id": rid, "object": "chat.completion.chunk",
                       "created": created, "model": model, "choices": [choice]}
            else:
                obj = {"id": rid, "object": "text_completion",
                       "created": created, "model": model,
                       "choices": [{"index": 0, "text": delta_text or "",
                                    "finish_reason": finish}]}
            return f"data: {json.dumps(obj)}\n\n".encode()

        def usage_chunk(ntok: int) -> bytes:
            # stream_options.include_usage: a final chunk with empty
            # choices carrying the usage block (OpenAI semantics)
            obj = {"id": rid,
                   "object": ("chat.completion.chunk" if chat
                              else "text_completion"),
                   "created": created, "model": model, "choices": [],
                   "usage": {"prompt_tokens": len(req.token_ids),
                             "completion_tokens": ntok,
                             "total_tokens": len(req.token_ids) + ntok}}
            return f"data: {json.dumps(obj)}\n\n".encode()

        first = True
        ntok = 0
        saw_tools = False
        disconnected = False
        final_finish = None
        # forced tool_choice (guided envelope): the whole output IS one
        # tool call — buffer it and emit a single tool_calls delta at the
        # end instead of streaming raw JSON as content
        forced_tool = chat and "forced_tool_call" in (req.annotations or [])
        forced_parts: list[str] = []
        probe = _LatencyProbe(self._m_requests, model)
        try:
            async for d in pipeline.generate_deltas(req, token=token,
                                                    tracker=tracker):
                if tracker is not None and ntok == 0 and d.token_count:
                    tracker.cached_tokens = self._kv_overlap_tokens(
                        pipeline, req.request_id)
                probe.on_delta(d.token_count)
                if tracker is not None:
                    tracker.on_tokens(d.token_count)
                ntok += d.token_count
                finish = d.finish_reason
                text, reasoning, calls = d.text, "", None
                if parser is not None:
                    out = parser.push(d.text)
                    if finish is not None:
                        fl = parser.flush()
                        out.content += fl.content
                        out.reasoning += fl.reasoning
                        out.tool_calls.extend(fl.tool_calls)
                    text, reasoning, calls = (out.content, out.reasoning,
                                              out.tool_calls)
                    saw_tools |= bool(calls)
                    if finish is not None and saw_tools:
                        finish = "tool_calls"
                if forced_tool:
                    forced_parts.append(text or "")
                    if finish is not None:
                        from .parsers import envelope_to_tool_call

                        call = envelope_to_tool_call("".join(forced_parts))
                        if call is not None:
                            if tracker is not None:
                                tracker.add_tool_calls([call])
                            await resp.write(chunk(None, None, first,
                                                   tool_calls=[call]))
                            finish = "tool_calls"
                        else:
                            # not a parseable envelope: fall back to the
                            # buffered text as one content chunk
                            await resp.write(chunk("".join(forced_parts),
                                                   None, first))
                        first = False
                        await resp.write(chunk(None, finish))
                        final_finish = finish
                        break
                    continue
                if text or reasoning or calls or finish or first:
                    if calls and tracker is not None:
                        tracker.add_tool_calls(calls)
                    t_obs = obs.begin()
                    await resp.write(chunk(text, finish, first,
                                           reasoning=reasoning,
                                           tool_calls=calls))
                    obs.end("frame_egress", t_obs,
                            tokens=d.token_count,
                            trace_id=(tracker.trace_id
                                      if tracker is not None else None))
                    first = False
                if d.finish_reason:
                    final_finish = finish or d.finish_reason
                    break
            if include_usage:
                await resp.write(usage_chunk(ntok))
            await resp.write(b"data: [DONE]\n\n")
            if tracker is not None:
                tracker.finish(finish_reason=final_finish)
        except (ConnectionResetError, asyncio.CancelledError):
            token.kill()  # client went away; stop the engine
            disconnected = True
            if tracker is not None:
                tracker.finish(error="client_disconnected")
        except Exception as e:
            logger.exception("stream failed")
            if tracker is not None:
                tracker.finish(error=str(e))
            err = {"error": {"message": str(e), "type": "server_error"}}
            try:
                await resp.write(f"data: {json.dumps(err)}\n\n".encode())
            except ConnectionResetError:
                disconnected = True
        if not disconnected:
            try:
                await resp.write_eof()
            except ConnectionResetError:
                pass
        return resp

    def debug_state(self) -> dict:
        """Frontend half of /debug/state (fleet introspection plane):
        served models, in-flight count, the SLO plane's rolling
        summary, and — when KV routers are attached — each router's
        predicted-vs-realized overlap stats (the indexer-staleness
        signal the fleet reduction surfaces)."""
        state = {
            "kind": "frontend",
            "instance_id": self._fleet_instance_id,
            "pool": self.runtime.config.namespace,
            "models": sorted(self.manager.models),
            "inflight": self.inflight,
            "busy_threshold": self.busy_threshold,
            "slo": self.slo_plane.summary(),
        }
        from .pipeline import _route_attr

        routers = {}
        for name, p in self.manager.models.items():
            fn = _route_attr(p.migration.route, "overlap_stats")
            if fn is not None:
                routers[name] = fn()
        if routers:
            state["router"] = routers
        if self.forensics is not None:
            state["tail"] = {
                **self.forensics.counts(),
                "realized_overlap":
                    self.forensics.realized_overlap()["ratio"],
            }
        return state

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> "HttpService":
        await self.server.start()
        if self.slo_plane.config.targets_set:
            self._slo_task = asyncio.create_task(self._slo_publish_loop())
        # fleet introspection plane: register the frontend's state dump
        # and — when a system-status server is up — a discovery instance
        # under {ns}/frontend/http so obs/fleet.py discovers this
        # process the same way it discovers workers (no router watches
        # that component/endpoint, so serving is unaffected)
        rt = self.runtime
        from ..runtime.discovery import Instance, new_instance_id

        self._fleet_instance_id = new_instance_id()
        rt.register_debug_source(f"frontend:{self._fleet_instance_id}",
                                 self.debug_state)
        if self.forensics is not None:
            # tail-exemplar dump on the token-gated /debug/requests
            # route (runtime/system_status.py)
            rt.register_forensics_source(
                f"frontend:{self._fleet_instance_id}", self.forensics.dump)
        self._fleet_instance = None
        advertise = (self.advertise if self.advertise is not None
                     else bool(rt.system_address))
        if advertise:
            port = self.server.bound_port
            http_addr = f"{rt.config.tcp_host}:{port}"
            metadata = {"kind": "frontend", "http_addr": http_addr,
                        "pool": rt.config.namespace}
            if rt.system_address:
                metadata["system_addr"] = rt.system_address
            self._fleet_instance = Instance(
                namespace=rt.config.namespace, component="frontend",
                endpoint="http", instance_id=self._fleet_instance_id,
                address=http_addr,
                metadata=metadata,
            )
            await rt.discovery.put(self._fleet_instance.key(),
                                   self._fleet_instance.to_dict())
        logger.info("HTTP service on %s:%d", self.host, self.server.bound_port)
        return self

    async def _slo_publish_loop(self) -> None:
        """Periodic SLO summary onto the event plane, one publish per
        namespace currently serving models — the planner's SloObserver
        folds it into SLA tick diag (an SLA controller's breach
        input)."""
        try:
            while True:
                await asyncio.sleep(self.slo_plane.config.publish_interval_s)
                namespaces = {p.mdc.namespace
                              for p in self.manager.models.values()}
                if namespaces:
                    await self.slo_plane.publish(self.runtime, namespaces)
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        if getattr(self, "_fleet_instance_id", None) is not None:
            self.runtime.unregister_debug_source(
                f"frontend:{self._fleet_instance_id}")
            self.runtime.unregister_forensics_source(
                f"frontend:{self._fleet_instance_id}")
        if getattr(self, "_fleet_instance", None) is not None:
            try:
                await self.runtime.discovery.delete(
                    self._fleet_instance.key())
            except Exception:
                logger.warning("fleet instance deregistration failed",
                               exc_info=True)
            self._fleet_instance = None
        # cancel in-flight batch jobs BEFORE tearing the pipelines down
        # (a running batch would keep calling handlers on a dead service)
        await self.extra.close()
        if self._slo_task is not None:
            self._slo_task.cancel()
            try:
                await self._slo_task
            except asyncio.CancelledError:
                pass
            self._slo_task = None
        # ends the open streams: their handlers are cancelled, which
        # kills each request's token and so its worker stream
        await self.server.close()
        self.trace_sink.close()

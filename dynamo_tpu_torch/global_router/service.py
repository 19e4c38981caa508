"""The global-router HTTP process: classify, pick a pool, forward.

A copy of dynamo_tpu/global_router/service.py on the port's HTTP server
(runtime/http_server.py) and client (runtime/http.py `open_raw`) in
place of aiohttp, which the machines the port serves on do not have.  It
exposes the same OpenAI surface the frontends do.  Per request it
estimates ISL from the body, classifies against the live pool set
(policy.py), picks a frontend inside the chosen pool by power-of-two
choices on local in-flight counts, and proxies the request byte for byte: the status, the content
type and every body chunk pass through untouched as they arrive, so
token streams are identical to hitting the pool frontend directly.  The
forward stamps `x-dyn-pool` so the frontend's request tracker (and
therefore the `routed` hop + request_end record) names the pool.

Failure posture: a frontend that refuses the connection goes on a short
cooldown (`FRONTEND_COOLDOWN_S`) and the request retries the pool's
other frontends before a 502; a classifier fault (chaos seam
`grouter.classify`) degrades to round-robin over the model's pools: a
policy bug must never drop traffic.

Observability: `dynamo_grouter_*` metrics (per-pool route counts by
reason, classification latency, pool/frontend gauges) plus a background
scrape of each frontend's /metrics that re-exports the cross-replica
spread of `dynamo_router_overlap_staleness_ratio` per pool, the
replica-sync health signal: replicas sharing one slot view should agree
on staleness, so a wide spread means a replica's view has drifted.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import Counter, deque
from typing import Dict, Optional

from .. import chaos
from ..runtime.http import HttpClient
from ..runtime.http_server import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from .policy import Decision, GlobalRouterConfig, PoolClassifier, \
    estimate_isl
from .pools import PoolDirectory, PoolView

logger = logging.getLogger(__name__)

# request headers never forwarded (hop-by-hop / recomputed)
_DROP_HEADERS = frozenset({
    "host", "content-length", "connection", "keep-alive",
    "transfer-encoding", "upgrade", "te", "trailer", "expect",
})
FRONTEND_COOLDOWN_S = 2.0
CONNECT_TIMEOUT_S = 5.0  # aiohttp's sock_connect in the JAX service
SCRAPE_TIMEOUT_S = 2.0


class GlobalRouterService:
    def __init__(self, runtime, host: str = "0.0.0.0", port: int = 8080,
                 config: Optional[GlobalRouterConfig] = None,
                 staleness_scrape_s: float = 2.0):
        self.runtime = runtime
        self.host = host
        self.port = port
        self.config = config or GlobalRouterConfig()
        self.directory = PoolDirectory(runtime)
        self.classifier = PoolClassifier(self.config)
        self.staleness_scrape_s = staleness_scrape_s
        self._clients: Dict[str, HttpClient] = {}  # http_addr -> client
        self._scrape_task: Optional[asyncio.Task] = None
        self._cancel = asyncio.Event()
        self._fe_inflight: Dict[str, int] = {}   # http_addr -> count
        self._fe_down: Dict[str, float] = {}     # http_addr -> down-at
        self._routed: Counter = Counter()        # (pool, reason) -> n
        self._route_lat_s: deque = deque(maxlen=4096)
        self._staleness: Dict[str, dict] = {}    # pool -> scrape rollup
        self._rr = 0

        m = runtime.metrics.scoped(component="grouter")
        self._m = m
        m.counter("dynamo_grouter_routed_total",
                  "requests forwarded, by pool and classification reason",
                  ("pool", "reason"))
        m.counter("dynamo_grouter_forward_errors_total",
                  "forward attempts that failed (per pool)", ("pool",))
        m.counter("dynamo_grouter_classify_errors_total",
                  "classifier faults degraded to round-robin")
        m.gauge("dynamo_grouter_pools", "pools currently discovered")
        m.gauge("dynamo_grouter_pool_frontends",
                "frontend replicas per pool", ("pool",))
        m.gauge("dynamo_grouter_pool_inflight",
                "in-flight forwarded requests per pool", ("pool",))
        m.histogram("dynamo_grouter_classify_seconds",
                    "pool classification latency",
                    buckets=(1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2))
        m.histogram("dynamo_grouter_route_seconds",
                    "receive -> forward-started latency (classify + "
                    "frontend pick)",
                    buckets=(1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1))
        m.gauge("dynamo_grouter_staleness_spread",
                "max-min dynamo_router_overlap_staleness_ratio across a "
                "pool's frontend replicas (0 = replicas agree)",
                ("pool",))

        self.app = HttpServer(host, port)
        self.app.add_post("/v1/chat/completions", self._handle)
        self.app.add_post("/v1/completions", self._handle)
        self.app.add_get("/v1/models", self.h_models)
        self.app.add_get("/health", self.h_health)
        self.app.add_get("/metrics", self.h_metrics)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "GlobalRouterService":
        await self.directory.start()
        await self.app.start()
        self.port = self.app.bound_port
        self._scrape_task = asyncio.create_task(self._staleness_loop())
        self.runtime.register_debug_source("grouter", self.debug_state)
        logger.info("global router on %s:%d", self.host, self.port)
        return self

    async def close(self) -> None:
        self._cancel.set()
        if self._scrape_task is not None:
            self._scrape_task.cancel()
        await self.directory.close()
        for client in self._clients.values():
            await client.close()
        await self.app.close()

    def _client(self, addr: str) -> HttpClient:
        client = self._clients.get(addr)
        if client is None:
            client = self._clients[addr] = HttpClient(f"http://{addr}")
        return client

    # -- routes ------------------------------------------------------------
    async def h_health(self, request: Request) -> Response:
        return json_response({
            "status": "ok", "pools": len(self.directory.pools())})

    async def h_metrics(self, request: Request) -> Response:
        pools = self.directory.pools()
        self._m.set("dynamo_grouter_pools", float(len(pools)))
        for ns, p in pools.items():
            self._m.set("dynamo_grouter_pool_frontends",
                        float(len(p.frontends)), pool=ns)
        return Response(body=self.runtime.metrics.render(),
                        content_type="text/plain; charset=utf-8")

    async def h_models(self, request: Request) -> Response:
        return json_response({
            "object": "list",
            "data": [{"id": m, "object": "model"}
                     for m in self.directory.models()]})

    async def _handle(self, request: Request):
        t0 = time.monotonic()
        try:
            body = await request.json()
        except Exception:
            return json_response({"error": "invalid JSON body"},
                                 status=400)
        model = body.get("model")
        pools = self.directory.pools_for_model(model) if model else []
        if not pools:
            return json_response(
                {"error": f"model {model!r} not served by any pool"},
                status=404)
        isl = estimate_isl(body)
        max_tokens = int(body.get("max_tokens") or 0)
        tc = time.monotonic()
        try:
            await chaos.ahit("grouter.classify", key=model)
            decision = self.classifier.classify(pools, isl, max_tokens)
        except Exception:
            # a policy fault must degrade, not drop: round-robin over
            # the model's pools and keep serving
            self._m.inc("dynamo_grouter_classify_errors_total")
            self._rr += 1
            pool = pools[self._rr % len(pools)]
            decision = Decision(pool=pool.namespace,
                                reason="classify_error_rr", isl=isl,
                                prefill_ratio=0.0)
        self._m.observe("dynamo_grouter_classify_seconds",
                        time.monotonic() - tc)
        pool = self.directory.pools().get(decision.pool)
        if pool is None or not pool.frontends:
            return json_response(
                {"error": f"pool {decision.pool} lost its frontends"},
                status=503)
        return await self._forward(request, body, pool, decision, t0)

    # -- forwarding --------------------------------------------------------
    def _pick_frontend(self, pool: PoolView) -> Optional[str]:
        """P2C on local in-flight counts, skipping cooled-down addrs
        (all-down falls back to ignoring the cooldown)."""
        now = time.monotonic()
        addrs = [f.http_addr for f in pool.frontends.values()]
        live = [a for a in addrs
                if now - self._fe_down.get(a, -1e9) > FRONTEND_COOLDOWN_S]
        cand = live or addrs
        if not cand:
            return None
        # deterministic P2C: the two least-loaded of a rotating pair
        if len(cand) > 2:
            self._rr += 1
            i = self._rr % len(cand)
            cand = [cand[i], cand[(i + 1) % len(cand)]]
        return min(cand, key=lambda a: self._fe_inflight.get(a, 0))

    async def _forward(self, request: Request, body: dict,
                       pool: PoolView, decision: Decision, t0: float):
        headers = {k: v for k, v in request.headers.items()
                   if k.lower() not in _DROP_HEADERS}
        headers["x-dyn-pool"] = pool.namespace
        headers["Content-Type"] = "application/json"
        raw = json.dumps(body).encode()
        tried = set()
        pool.inflight += 1
        self._m.set("dynamo_grouter_pool_inflight", float(pool.inflight),
                    pool=pool.namespace)
        try:
            for _ in range(max(len(pool.frontends), 1)):
                addr = self._pick_frontend(pool)
                if addr is None or addr in tried:
                    break
                tried.add(addr)
                self._fe_inflight[addr] = (
                    self._fe_inflight.get(addr, 0) + 1)
                try:
                    return await self._stream_through(
                        request, addr, raw, headers, pool, decision, t0)
                except (OSError, asyncio.TimeoutError):
                    # connection-level failure before any byte reached
                    # the client: cool the frontend down and try the
                    # pool's next replica
                    self._fe_down[addr] = time.monotonic()
                    self._m.inc("dynamo_grouter_forward_errors_total",
                                pool=pool.namespace)
                    logger.warning("frontend %s unreachable, retrying "
                                   "in pool %s", addr, pool.namespace)
                finally:
                    self._fe_inflight[addr] -= 1
            return json_response(
                {"error": f"no reachable frontend in pool "
                          f"{pool.namespace}"}, status=502)
        finally:
            pool.inflight -= 1
            self._m.set("dynamo_grouter_pool_inflight",
                        float(pool.inflight), pool=pool.namespace)

    async def _stream_through(self, request: Request, addr: str,
                              raw: bytes, headers: dict, pool: PoolView,
                              decision: Decision,
                              t0: float) -> StreamResponse:
        t_send = time.monotonic()
        async with self._client(addr).open_raw(
                "POST", request.path, data=raw, headers=headers,
                connect_timeout=CONNECT_TIMEOUT_S) as (status, rhdrs,
                                                       chunks):
            # forward started: route latency is classify + pick + connect
            self._route_lat_s.append(t_send - t0)
            self._m.observe("dynamo_grouter_route_seconds", t_send - t0)
            self._routed[(pool.namespace, decision.reason)] += 1
            self._m.inc("dynamo_grouter_routed_total",
                        pool=pool.namespace, reason=decision.reason)
            resp = StreamResponse(status=status)
            ct = rhdrs.get("content-type")
            if ct:
                resp.headers["Content-Type"] = ct
            await resp.prepare(request)
            first = True
            try:
                async for chunk in chunks:
                    if first:
                        pool.observe_ttft(decision.isl,
                                          time.monotonic() - t_send)
                        first = False
                    await resp.write(chunk)
            except (OSError, asyncio.TimeoutError, ValueError):
                # once bytes reached the client a retry would corrupt
                # the stream: end it (the client sees a truncated SSE
                # stream, the same contract as a dying frontend)
                logger.warning("upstream died mid-stream (%s)", addr)
            await resp.write_eof()
            return resp

    # -- replica-sync health scrape ---------------------------------------
    async def _staleness_loop(self) -> None:
        try:
            while not self._cancel.is_set():
                await asyncio.sleep(self.staleness_scrape_s)
                for ns, pool in list(self.directory.pools().items()):
                    await self._scrape_pool(ns, pool)
        except asyncio.CancelledError:
            pass

    async def _scrape_pool(self, ns: str, pool: PoolView) -> None:
        per_fe: Dict[str, float] = {}
        for fe in list(pool.frontends.values()):
            try:
                r = await asyncio.wait_for(
                    self._client(fe.http_addr).request("GET", "/metrics"),
                    SCRAPE_TIMEOUT_S)
                val = _parse_staleness(r.body.decode("utf-8", "replace"))
                if val is not None:
                    per_fe[fe.http_addr] = val
            except Exception:
                continue  # an unreachable replica just skips one sample
        if per_fe:
            spread = (max(per_fe.values()) - min(per_fe.values())
                      if len(per_fe) > 1 else 0.0)
            self._m.set("dynamo_grouter_staleness_spread", spread,
                        pool=ns)
            self._staleness[ns] = {
                "per_frontend": {a: round(v, 4)
                                 for a, v in per_fe.items()},
                "spread": round(spread, 4),
            }

    # -- introspection -----------------------------------------------------
    def route_latency_quantiles(self) -> dict:
        lat = sorted(self._route_lat_s)
        if not lat:
            return {"count": 0}

        def q(p):
            return round(lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3,
                         3)

        return {"count": len(lat), "p50_ms": q(0.50), "p99_ms": q(0.99),
                "max_ms": round(lat[-1] * 1e3, 3)}

    def debug_state(self) -> dict:
        return {
            "kind": "global_router",
            "pools": {ns: p.to_dict()
                      for ns, p in self.directory.pools().items()},
            "routed": {f"{pool}/{reason}": n
                       for (pool, reason), n in self._routed.items()},
            "route_latency": self.route_latency_quantiles(),
            "staleness": self._staleness,
        }


def _parse_staleness(metrics_text: str) -> Optional[float]:
    """Pull dynamo_router_overlap_staleness_ratio out of a Prometheus
    text exposition; the max across label sets (one per served model)
    is the replica's staleness."""
    vals = []
    for line in metrics_text.splitlines():
        if (line.startswith("dynamo_router_overlap_staleness_ratio")
                and not line.startswith("#")):
            try:
                vals.append(float(line.rsplit(None, 1)[-1]))
            except ValueError:
                continue
    return max(vals) if vals else None

"""Pool discovery: namespaces as first-class routing targets, a copy of
dynamo_tpu/global_router/pools.py over the port's discovery.

A pool is a namespace with at least one advertised frontend.  The
directory watches the SAME two discovery prefixes the rest of the stack
already populates — `v1/instances/**` for frontend instances (HttpService
registers `{ns}/frontend/http` with an `http_addr` in its metadata) and
`v1/mdc/**` for model cards (whose `runtime_config.role` says whether
the namespace runs a disagg prefill tier) — so pools need no new
registration protocol: labeling a deployment's namespace IS joining a
pool.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..protocols.model_card import ModelDeploymentCard
from ..runtime.discovery import INSTANCE_PREFIX, MDC_PREFIX, Instance

logger = logging.getLogger(__name__)


@dataclass
class FrontendView:
    instance_id: int
    http_addr: str
    pool: str


@dataclass
class PoolView:
    """One pool namespace: its frontend tier + the models it serves,
    plus the load/latency signals the service feeds back per forward."""

    namespace: str
    frontends: Dict[int, FrontendView] = field(default_factory=dict)
    models: Dict[str, set] = field(default_factory=dict)  # name -> roles
    inflight: int = 0
    # TTFT model for (ISL, predicted TTFT) classification: a per-token
    # EWMA (prefill scales with ISL) plus a flat EWMA floor for short
    # prompts; None until the first completed forward
    ttft_per_token_ewma_s: Optional[float] = None
    ttft_ewma_s: Optional[float] = None

    @property
    def is_disagg(self) -> bool:
        return any("prefill" in roles for roles in self.models.values())

    def serves(self, model: str) -> bool:
        return model in self.models

    def observe_ttft(self, isl: int, ttft_s: float, alpha: float = 0.2):
        def ewma(cur, x):
            return x if cur is None else (1 - alpha) * cur + alpha * x

        self.ttft_ewma_s = ewma(self.ttft_ewma_s, ttft_s)
        if isl > 0:
            self.ttft_per_token_ewma_s = ewma(
                self.ttft_per_token_ewma_s, ttft_s / isl)

    def predict_ttft(self, isl: int) -> Optional[float]:
        if self.ttft_per_token_ewma_s is not None:
            return self.ttft_per_token_ewma_s * max(isl, 1)
        return self.ttft_ewma_s

    def to_dict(self) -> dict:
        return {
            "namespace": self.namespace,
            "kind": "disagg" if self.is_disagg else "agg",
            "frontends": sorted(f.http_addr
                                for f in self.frontends.values()),
            "models": {m: sorted(r) for m, r in self.models.items()},
            "inflight": self.inflight,
            "predicted_ttft_ms_at_1k": (
                round(self.predict_ttft(1024) * 1000.0, 3)
                if self.predict_ttft(1024) is not None else None),
        }


class PoolDirectory:
    """Watches discovery and maintains the namespace -> PoolView map."""

    def __init__(self, runtime):
        self.runtime = runtime
        self._pools: Dict[str, PoolView] = {}
        self._cancel = asyncio.Event()
        self._inst_task: Optional[asyncio.Task] = None
        self._mdc_task: Optional[asyncio.Task] = None
        # discovery key -> (namespace, instance_id) / (namespace, model)
        self._inst_keys: Dict[str, tuple] = {}
        self._mdc_keys: Dict[str, tuple] = {}
        self.last_change_unix = time.time()

    async def start(self) -> "PoolDirectory":
        self._inst_task = asyncio.create_task(self._watch_instances())
        self._mdc_task = asyncio.create_task(self._watch_mdc())
        return self

    async def close(self) -> None:
        self._cancel.set()
        for t in (self._inst_task, self._mdc_task):
            if t is not None:
                t.cancel()

    # -- views -------------------------------------------------------------
    def pools(self) -> Dict[str, PoolView]:
        return self._pools

    def pools_for_model(self, model: str) -> List[PoolView]:
        return [p for p in self._pools.values()
                if p.serves(model) and p.frontends]

    def models(self) -> List[str]:
        seen = set()
        for p in self._pools.values():
            if p.frontends:
                seen.update(p.models)
        return sorted(seen)

    def _pool(self, namespace: str) -> PoolView:
        return self._pools.setdefault(namespace, PoolView(namespace))

    def _gc(self, namespace: str) -> None:
        p = self._pools.get(namespace)
        if p is not None and not p.frontends and not p.models:
            del self._pools[namespace]

    # -- watches -----------------------------------------------------------
    async def _watch_instances(self) -> None:
        try:
            async for ev in self.runtime.discovery.watch(
                INSTANCE_PREFIX + "/", cancel=self._cancel
            ):
                try:
                    self._apply_instance(ev)
                except Exception:
                    logger.exception("pool directory failed applying %s",
                                     ev)
        except asyncio.CancelledError:
            pass

    def _apply_instance(self, ev) -> None:
        if ev.type == "put" and ev.value:
            inst = Instance.from_dict(ev.value)
            if inst.component != "frontend" or inst.endpoint != "http":
                return
            addr = inst.metadata.get("http_addr") or inst.address
            if not addr:
                return
            self._pool(inst.namespace).frontends[inst.instance_id] = (
                FrontendView(inst.instance_id, addr, inst.namespace))
            self._inst_keys[ev.key] = (inst.namespace, inst.instance_id)
            self.last_change_unix = time.time()
        elif ev.type == "delete" and ev.key in self._inst_keys:
            ns, iid = self._inst_keys.pop(ev.key)
            pool = self._pools.get(ns)
            if pool is not None:
                pool.frontends.pop(iid, None)
                self._gc(ns)
            self.last_change_unix = time.time()

    async def _watch_mdc(self) -> None:
        try:
            async for ev in self.runtime.discovery.watch(
                MDC_PREFIX + "/", cancel=self._cancel
            ):
                try:
                    self._apply_mdc(ev)
                except Exception:
                    logger.exception("pool directory failed applying %s",
                                     ev)
        except asyncio.CancelledError:
            pass

    def _apply_mdc(self, ev) -> None:
        if ev.type == "put" and ev.value:
            mdc = ModelDeploymentCard.from_dict(ev.value)
            role = mdc.runtime_config.get("role", "both")
            self._pool(mdc.namespace).models.setdefault(
                mdc.name, set()).add(role)
            self._mdc_keys[ev.key] = (mdc.namespace, mdc.name, role)
            self.last_change_unix = time.time()
        elif ev.type == "delete" and ev.key in self._mdc_keys:
            ns, name, role = self._mdc_keys.pop(ev.key)
            pool = self._pools.get(ns)
            if pool is not None:
                # only drop the role if no OTHER card still claims it
                still = {r for (n2, m2, r) in self._mdc_keys.values()
                         if n2 == ns and m2 == name}
                roles = pool.models.get(name)
                if roles is not None:
                    roles.intersection_update(still)
                    if not roles:
                        pool.models.pop(name, None)
                self._gc(ns)
            self.last_change_unix = time.time()

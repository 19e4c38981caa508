"""The reconcile loop: spec ConfigMaps -> converged Deployment set.

A copy of dynamo_tpu/operator/reconciler.py — level-triggered
reconciliation: every pass reads the desired state (spec ConfigMaps),
reads the actual state (Deployments labeled with the graph name), and
applies the difference.  It speaks the Kubernetes JSON API through the
port's standard-library client (runtime/http.py HttpClient), as
runtime/kube.py and planner/connectors.py do, where the JAX reconciler
uses aiohttp; it sends the same requests in the same order.

Drift rules:
  * missing Deployment           -> create
  * HASH_ANN differs             -> merge-patch template/labels (rolling
                                    update via the Deployment machinery)
  * REPLICAS_ANN differs         -> the SPEC's replica count changed:
                                    patch replicas too (spec wins)
  * REPLICAS_ANN equal           -> leave replicas alone — the planner's
                                    KubernetesConnector owns scale drift
  * stray graph-labeled objects  -> delete (component removed from spec)
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

from .spec import (
    GRAPH_LABEL,
    GRAPH_NAME_LABEL,
    HASH_ANN,
    REPLICAS_ANN,
    GraphSpec,
    render_deployments,
)

logger = logging.getLogger(__name__)


class GraphOperator:
    def __init__(self, api_url: str = "", namespace: str = "",
                 token: str = "", interval_s: float = 10.0):
        from ..runtime.kube import resolve_k8s_credentials

        self.api, self.namespace, self.token, self._ssl = \
            resolve_k8s_credentials(api_url, namespace, token)
        self.interval_s = interval_s
        self._client = None
        self._closed = asyncio.Event()
        # reconcile-pass counters (observability + test hooks)
        self.stats = {"created": 0, "patched": 0, "scaled": 0,
                      "deleted": 0, "errors": 0, "passes": 0}

    # -- transport --------------------------------------------------------

    def _http(self):
        from ..runtime.http import HttpClient

        if self._client is None or self._client.closed:
            self._client = HttpClient(self.api, token=self.token,
                                      ssl_context=self._ssl)
        return self._client

    def _cm_path(self) -> str:
        return f"/api/v1/namespaces/{self.namespace}/configmaps"

    def _dep_path(self, name: str = "") -> str:
        base = f"/apis/apps/v1/namespaces/{self.namespace}/deployments"
        return f"{base}/{name}" if name else base

    # -- desired state ----------------------------------------------------

    async def load_specs(self) -> Tuple[List[GraphSpec], Optional[set]]:
        """All graph specs: ConfigMaps labeled GRAPH_LABEL=1, spec JSON in
        data["spec"].  A malformed spec is logged and skipped — one bad
        graph must not stall reconciliation of the others.

        Returns (specs, quarantine): quarantine is the set of graph NAMES
        whose spec failed to parse (their live Deployments must NOT be
        reaped as strays — a config typo must never take down a running
        fleet), or None when a spec was so broken its graph name is
        unknowable (the caller then skips stray deletion entirely)."""
        params = {"labelSelector": f"{GRAPH_LABEL}=1"}
        out = await self._http().call("GET", self._cm_path(), params=params)
        specs: List[GraphSpec] = []
        quarantine: Optional[set] = set()
        for obj in out.get("items", []):
            name = (obj.get("metadata") or {}).get("name", "?")
            doc = None
            try:
                doc = json.loads((obj.get("data") or {}).get("spec", ""))
                specs.append(GraphSpec.parse(doc))
            except Exception:
                # ANY malformed spec (bad JSON, wrong shapes, surprise
                # types) must quarantine that graph, never wedge the
                # reconcile loop for the others
                self.stats["errors"] += 1
                logger.warning("graph ConfigMap %s has invalid spec; "
                               "skipping", name, exc_info=True)
                gname = doc.get("name") if isinstance(doc, dict) else None
                if quarantine is not None and isinstance(gname, str) \
                        and gname:
                    quarantine.add(gname)
                else:
                    quarantine = None  # name unknowable: freeze deletes
        return specs, quarantine

    # -- actual state -----------------------------------------------------

    async def _list_owned(self) -> Dict[str, Dict[str, Any]]:
        """Deployments this operator manages (any graph), by name."""
        params = {"labelSelector": GRAPH_NAME_LABEL}
        out = await self._http().call("GET", self._dep_path(), params=params)
        return {(o.get("metadata") or {}).get("name"): o
                for o in out.get("items", [])}

    # -- reconcile --------------------------------------------------------

    @staticmethod
    def _drift(existing: Dict[str, Any],
               desired: Dict[str, Any]) -> Tuple[bool, Optional[int]]:
        """(template drifted?, replicas to set or None)."""
        e_ann = (existing.get("metadata") or {}).get("annotations") or {}
        d_ann = desired["metadata"]["annotations"]
        drifted = e_ann.get(HASH_ANN) != d_ann[HASH_ANN]
        replicas = None
        if e_ann.get(REPLICAS_ANN) != d_ann[REPLICAS_ANN]:
            replicas = int(desired["spec"]["replicas"])
        return drifted, replicas

    async def reconcile_once(self) -> None:
        specs, quarantine = await self.load_specs()
        desired: Dict[str, Dict[str, Any]] = {}
        for spec in specs:
            desired.update(render_deployments(spec))
        existing = await self._list_owned()

        for name, manifest in desired.items():
            try:
                if name not in existing:
                    resp = await self._http().request(
                        "POST", self._dep_path(), json=manifest)
                    if resp.status == 409:
                        # raced another operator replica; next pass
                        # converges via the patch path
                        continue
                    resp.raise_for_status()
                    self.stats["created"] += 1
                    logger.info("operator created %s", name)
                    continue
                drifted, replicas = self._drift(existing[name], manifest)
                if not drifted and replicas is None:
                    continue
                patch: Dict[str, Any] = {
                    "metadata": {
                        "labels": manifest["metadata"]["labels"],
                        "annotations": manifest["metadata"]["annotations"],
                    },
                    "spec": {},
                }
                if drifted:
                    patch["spec"]["template"] = \
                        manifest["spec"]["template"]
                    patch["spec"]["strategy"] = \
                        manifest["spec"]["strategy"]
                if replicas is not None:
                    patch["spec"]["replicas"] = replicas
                    self.stats["scaled"] += 1
                await self._http().call(
                    "PATCH", self._dep_path(name), patch,
                    headers={"Content-Type":
                             "application/merge-patch+json"})
                self.stats["patched"] += 1
                logger.info("operator patched %s (template=%s replicas=%s)",
                            name, drifted, replicas)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.stats["errors"] += 1
                logger.warning("reconcile of %s failed", name,
                               exc_info=True)

        for name in set(existing) - set(desired):
            if quarantine is None:
                break  # an unparseable spec froze stray deletion
            owner = ((existing[name].get("metadata") or {})
                     .get("labels") or {}).get(GRAPH_NAME_LABEL)
            if owner in quarantine:
                continue  # its spec is broken, not gone: keep it running
            try:
                resp = await self._http().request(
                    "DELETE", self._dep_path(name))
                if resp.status != 404:
                    resp.raise_for_status()
                self.stats["deleted"] += 1
                logger.info("operator deleted stray %s", name)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.stats["errors"] += 1
                logger.warning("delete of %s failed", name, exc_info=True)
        self.stats["passes"] += 1

    async def run(self) -> None:
        """Level-triggered loop: reconcile, sleep, repeat.  Every pass
        re-reads both sides, so missed watch events cannot wedge it (the
        reference controller's resync period plays the same role)."""
        while not self._closed.is_set():
            try:
                await self.reconcile_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.stats["errors"] += 1
                logger.warning("reconcile pass failed", exc_info=True)
            try:
                await asyncio.wait_for(self._closed.wait(),
                                       timeout=self.interval_s)
            except asyncio.TimeoutError:
                pass

    async def close(self) -> None:
        self._closed.set()
        if self._client is not None and not self._client.closed:
            await self._client.close()

"""Kubernetes discovery backend: Lease objects as the discovery KV.

A copy of dynamo_tpu/runtime/kube.py with the same object names,
annotations, labels, timestamps and staleness rule, so a torch worker and
JAX processes in one namespace see each other.  It speaks the API
server's JSON interface through the port's standard-library client
(runtime/http.py) where the JAX module uses aiohttp:

  * every discovery key is one `coordination.k8s.io/v1 Lease` object,
    named by a hash of (cluster, key), carrying the real key + value in
    annotations and labeled with the cluster id for selector scans
  * liveness: the owner renews `spec.renewTime` every ttl/3 (the
    keepalive).  A crashed process stops renewing; readers treat a
    renewTime older than the lease duration as gone, the same
    failure-detection primitive etcd leases give (the API server
    deletes nothing by itself)
  * durable keys (put(lease=False), e.g. model cards) are marked with a
    durable annotation and never go stale
  * watch: list+diff snapshots accelerated by the API server's watch
    stream; reconnects (a 410 Gone included) and staleness sweeps
    re-list and diff, so consumers never miss a delete across a gap

Select with DYN_DISCOVERY_BACKEND=kubernetes.  In-cluster credentials
(service-account token, CA and https://kubernetes.default.svc) are
picked up automatically; DYN_K8S_API / DYN_K8S_NAMESPACE / DYN_K8S_TOKEN
/ DYN_K8S_CA_CERT override them.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import json
import logging
import os
from typing import Any, AsyncIterator, Dict, Optional

from .discovery import DiscoveryBackend, WatchEvent, diff_snapshot
from .http import HttpClient

logger = logging.getLogger(__name__)

LEASES = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"
ANN_KEY = "dynamo.dev/key"
ANN_VALUE = "dynamo.dev/value"
ANN_DURABLE = "dynamo.dev/durable"
LABEL_CLUSTER = "dynamo-cluster"
MERGE_PATCH = {"Content-Type": "application/merge-patch+json"}

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def resolve_k8s_credentials(api_url: str = "", namespace: str = "",
                            token: str = ""):
    """(api, namespace, token, ssl_context) from explicit args, DYN_K8S_*
    env, or the pod's in-cluster service account, resolved as the JAX
    module does.  The in-cluster API server presents a cert signed by the
    cluster's own CA (ca.crt in the SA dir), which the system trust store
    does not contain, so the context loads it."""
    api = (api_url or os.environ.get("DYN_K8S_API")
           or "https://kubernetes.default.svc").rstrip("/")
    ns = namespace or os.environ.get("DYN_K8S_NAMESPACE", "")
    if not ns:
        try:
            with open(os.path.join(_SA_DIR, "namespace")) as f:
                ns = f.read().strip()
        except OSError:
            ns = "default"
    tok = token or os.environ.get("DYN_K8S_TOKEN", "")
    if not tok:
        try:
            with open(os.path.join(_SA_DIR, "token")) as f:
                tok = f.read().strip()
        except OSError:
            pass
    ssl_ctx = None
    if api.startswith("https://"):
        import ssl

        ca = os.environ.get("DYN_K8S_CA_CERT",
                            os.path.join(_SA_DIR, "ca.crt"))
        if os.path.isfile(ca):
            ssl_ctx = ssl.create_default_context(cafile=ca)
    return api, ns, tok, ssl_ctx


def _now_rfc3339() -> str:
    return (datetime.datetime.now(datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z")


def _parse_rfc3339(s: str) -> float:
    s = s.rstrip("Z")
    if "." not in s:
        s += ".0"
    dt = datetime.datetime.strptime(s, "%Y-%m-%dT%H:%M:%S.%f")
    return dt.replace(tzinfo=datetime.timezone.utc).timestamp()


class KubeDiscovery(DiscoveryBackend):
    def __init__(self, api_url: str = "", namespace: str = "",
                 cluster_id: str = "default", ttl_s: float = 5.0,
                 token: str = ""):
        self.api, self.namespace, self.token, self._ssl = \
            resolve_k8s_credentials(api_url, namespace, token)
        self.cluster_id = cluster_id
        self.ttl_s = ttl_s
        self.holder = f"dyn-{os.getpid()}-{id(self) & 0xFFFF:04x}"
        self._client = HttpClient(self.api, token=self.token,
                                  ssl_context=self._ssl)
        self._ka_task: Optional[asyncio.Task] = None
        self._closed = asyncio.Event()
        self._owned: Dict[str, Dict[str, Any]] = {}  # leased key -> value
        self._owned_values = self._owned  # withdraw/restore (base class)

    # -- transport --------------------------------------------------------

    def _http(self) -> HttpClient:
        if self._closed.is_set():
            raise RuntimeError("KubeDiscovery is closed")
        return self._client

    def _leases_url(self, name: str = "") -> str:
        """The Leases path under the API root (name: one object)."""
        base = LEASES.format(ns=self.namespace)
        return f"{base}/{name}" if name else base

    def _name(self, key: str) -> str:
        h = hashlib.sha1(
            f"{self.cluster_id}\x00{key}".encode()).hexdigest()
        return f"dyn-{h}"

    # -- object mapping ---------------------------------------------------

    def _lease_body(self, key: str, value: Dict[str, Any],
                    durable: bool) -> Dict[str, Any]:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self._name(key),
                "labels": {LABEL_CLUSTER: self.cluster_id},
                "annotations": {
                    ANN_KEY: key,
                    ANN_VALUE: json.dumps(value, sort_keys=True),
                    **({ANN_DURABLE: "1"} if durable else {}),
                },
            },
            "spec": {
                "holderIdentity": self.holder,
                "leaseDurationSeconds": int(round(self.ttl_s)),
                "renewTime": _now_rfc3339(),
            },
        }

    def _decode(self, obj: Dict[str, Any],
                now: Optional[float] = None):
        """Lease object -> (key, value) or None when stale/foreign."""
        meta = obj.get("metadata", {})
        ann = meta.get("annotations") or {}
        key = ann.get(ANN_KEY)
        if key is None:
            return None
        if ann.get(ANN_DURABLE) != "1":
            renew = (obj.get("spec") or {}).get("renewTime")
            dur = (obj.get("spec") or {}).get(
                "leaseDurationSeconds", int(round(self.ttl_s)))
            if renew is None:
                return None
            now = now if now is not None else \
                datetime.datetime.now(datetime.timezone.utc).timestamp()
            if now - _parse_rfc3339(renew) > dur:
                return None  # holder stopped renewing: gone
        try:
            return key, json.loads(ann.get(ANN_VALUE, "null"))
        except ValueError:
            return None

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        if self._ka_task is None:
            self._ka_task = asyncio.create_task(self._keepalive_loop())

    async def _keepalive_loop(self) -> None:
        interval = self.ttl_s / 3.0
        while not self._closed.is_set():
            try:
                await asyncio.wait_for(self._closed.wait(), timeout=interval)
                return
            except asyncio.TimeoutError:
                pass
            for key, value in list(self._owned.items()):
                try:
                    await self._renew(key)
                except Exception:
                    # re-put under a fresh object: a deleted/expired lease
                    # must not leave a healthy worker invisible forever
                    try:
                        await self.put(key, value, lease=True)
                    except Exception:
                        logger.warning("kube keepalive re-put failed for "
                                       "%s", key, exc_info=True)

    async def _renew(self, key: str) -> None:
        patch = {"spec": {"renewTime": _now_rfc3339()}}
        (await self._http().request(
            "PATCH", self._leases_url(self._name(key)), json=patch,
            headers=MERGE_PATCH)).raise_for_status()

    # -- KV ---------------------------------------------------------------

    async def put(self, key: str, value: Dict[str, Any],
                  lease: bool = True) -> None:
        await self.start()
        body = self._lease_body(key, value, durable=not lease)
        resp = await self._http().request("POST", self._leases_url(),
                                          json=body)
        if resp.status == 409:  # exists: replace via merge patch
            patch = json.loads(json.dumps(body))
            if lease:
                # merge-patch leaves absent keys intact: a key first
                # written durable and later re-put with lease=True
                # would otherwise keep the durable marker and never go
                # stale; null explicitly deletes it
                patch["metadata"]["annotations"][ANN_DURABLE] = None
            (await self._http().request(
                "PATCH", self._leases_url(body["metadata"]["name"]),
                json=patch, headers=MERGE_PATCH)).raise_for_status()
        else:
            resp.raise_for_status()
        if lease:
            self._owned[key] = value

    async def delete(self, key: str) -> None:
        self._owned.pop(key, None)
        self._forget_withdrawn(key)
        resp = await self._http().request(
            "DELETE", self._leases_url(self._name(key)))
        if resp.status != 404:
            resp.raise_for_status()

    async def _list(self):
        """(snapshot dict for live keys under this cluster, resourceVersion)."""
        params = {"labelSelector": f"{LABEL_CLUSTER}={self.cluster_id}"}
        out = await self._http().call("GET", self._leases_url(),
                                      params=params)
        snap: Dict[str, Dict[str, Any]] = {}
        now = datetime.datetime.now(datetime.timezone.utc).timestamp()
        for obj in out.get("items", []):
            kv = self._decode(obj, now)
            if kv is not None:
                snap[kv[0]] = kv[1]
        rv = (out.get("metadata") or {}).get("resourceVersion", "0")
        return snap, rv

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        snap, _ = await self._list()
        return {k: v for k, v in snap.items() if k.startswith(prefix)}

    async def watch(
        self, prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[WatchEvent]:
        """Snapshot + API-server watch stream, re-snapshotting every
        ttl/2 so staleness (a holder that stopped renewing: the API
        server emits no event for that) surfaces as a delete within one
        sweep.  Reconnect gaps are closed by the same diff."""
        known: Dict[str, str] = {}
        queue: asyncio.Queue = asyncio.Queue()

        def emit(ev: WatchEvent) -> None:
            queue.put_nowait(ev)

        while not (cancel is not None and cancel.is_set()):
            try:
                snap, rv = await self._list()
            except Exception:
                if self._closed.is_set():
                    return
                logger.warning("kube list failed; retrying", exc_info=True)
                await asyncio.sleep(0.5)
                continue
            diff_snapshot(
                known, {k: v for k, v in snap.items()
                        if k.startswith(prefix)}, emit)
            while not queue.empty():
                yield queue.get_nowait()
            try:
                async for ev in self._watch_stream(rv, prefix, known):
                    yield ev
                    if cancel is not None and cancel.is_set():
                        return
            except asyncio.TimeoutError:
                continue  # staleness sweep: loop back to re-snapshot
            except Exception:
                if self._closed.is_set() or (
                        cancel is not None and cancel.is_set()):
                    return
                logger.warning("kube watch dropped; re-snapshotting",
                               exc_info=True)
                await asyncio.sleep(0.2)

    async def _watch_stream(self, rv: str, prefix: str,
                            known: Dict[str, str]):
        """One API-server watch connection, bounded to the staleness-sweep
        interval by WALL CLOCK, not read idleness: in a busy cluster every
        live worker renews its Lease each ttl/3, so the stream never idles
        long enough for a read timeout to fire, yet the API server emits
        no event for a holder that simply stops renewing.  Returning after
        ttl/2 regardless of traffic guarantees the caller's list+diff
        sweep runs and surfaces crashed holders as deletes.  Raises
        TimeoutError on a genuinely idle stream (same effect)."""
        params = {
            "labelSelector": f"{LABEL_CLUSTER}={self.cluster_id}",
            "watch": "true", "resourceVersion": rv,
        }
        sweep = max(self.ttl_s / 2, 1.0)
        deadline = asyncio.get_running_loop().time() + sweep
        async with self._http().stream("GET", self._leases_url(),
                                       params=params,
                                       read_timeout=sweep) as lines:
            async for line in lines:
                if asyncio.get_running_loop().time() >= deadline:
                    return  # sweep due: caller re-snapshots
                if not line.strip():
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                etype = ev.get("type")
                obj = ev.get("object", {})
                kv = self._decode(obj)
                if etype in ("ADDED", "MODIFIED"):
                    if kv is None:
                        continue
                    key, value = kv
                    if not key.startswith(prefix):
                        continue
                    ser = json.dumps(value, sort_keys=True)
                    if known.get(key) != ser:
                        known[key] = ser
                        yield WatchEvent("put", key, value)
                elif etype == "DELETED":
                    ann = (obj.get("metadata") or {}).get(
                        "annotations") or {}
                    key = ann.get(ANN_KEY)
                    if key and key.startswith(prefix) and key in known:
                        known.pop(key, None)
                        yield WatchEvent("delete", key)

    # -- lease management (base-class contract) ---------------------------

    async def revoke_lease(self) -> None:
        for key in list(self._owned):
            try:
                await self.delete(key)
            except Exception:
                logger.warning("kube revoke failed for %s", key,
                               exc_info=True)

    async def close(self) -> None:
        if self._closed.is_set():
            return
        try:
            await self.revoke_lease()
        finally:
            self._closed.set()
            if self._ka_task is not None:
                self._ka_task.cancel()
                self._ka_task = None
            await self._client.close()

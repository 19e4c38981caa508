"""Canary health checks: detect alive-but-wedged workers.

A copy of dynamo_tpu/runtime/health_check.py.  Lease expiry
catches dead processes, but a process whose engine is wedged keeps its
lease alive while every routed request times out.  The canary closes
that gap: per served endpoint, a timer armed by inactivity sends a real
(tiny) request through the endpoint's own handler; failure or timeout
marks the endpoint not ready, and the process then withdraws its
discovery lease (DYN_HEALTH_WITHDRAW, default on), so routers purge it
and in-flight requests migrate.  A later canary that succeeds restores
the lease.  Any successfully streamed response frame on the endpoint
resets the timer, so a busy worker is never canaried.  Each transition
counts on `dynamo_health_transitions_total`, and `statuses()` is what
the system-status server's /health reports per endpoint.
"""

from __future__ import annotations

import asyncio
import logging
import os
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


@dataclass
class HealthCheckConfig:
    canary_wait_s: float = 30.0      # idle time before a canary fires
    request_timeout_s: float = 10.0  # canary must finish within this
    withdraw: bool = True            # unhealthy -> drop discovery lease

    @staticmethod
    def from_env() -> "HealthCheckConfig":
        return HealthCheckConfig(
            canary_wait_s=float(os.environ.get("DYN_CANARY_WAIT_S", 30.0)),
            request_timeout_s=float(
                os.environ.get("DYN_HEALTH_CHECK_TIMEOUT_S", 10.0)),
            withdraw=os.environ.get("DYN_HEALTH_WITHDRAW", "1").lower()
            in ("1", "true", "yes", "on"),
        )


async def probe_endpoint(runtime, path: str, instance_id: Optional[int],
                         payload: Dict[str, Any],
                         timeout_s: float) -> Optional[bool]:
    """One canary-style probe of a served endpoint through its OWN
    handler: drains a tiny real request and judges success like the
    canary loop does.  Returns True/False for a completed probe, or
    None when the handler is not resolvable in this process (a
    subprocess/remote worker) — callers with only a remote view (the
    planner's quarantine re-probe) fall back to their delay rule.

    SystemHealth's canary treats None as failure: its own process MUST
    hold the handler."""
    from .cancellation import CancellationToken
    from .request_plane import RequestContext

    handler = runtime.request_server._resolve_handler(path, instance_id)
    if handler is None:
        return None
    payload = {**payload, "request_id": f"canary-{secrets.token_hex(6)}"}
    token = CancellationToken()
    ctx = RequestContext(payload["request_id"], token, {"canary": True})

    async def drain() -> bool:
        async for item in handler(payload, ctx):
            if isinstance(item, dict) and (
                    item.get("finish_reason") == "error"
                    or "error" in item and item["error"]):
                return False
        return True

    try:
        return await asyncio.wait_for(drain(), timeout=timeout_s)
    except asyncio.TimeoutError:
        token.kill()  # free whatever the wedged probe holds
        logger.warning("canary timed out on %s:%s", path, instance_id)
        return False
    except Exception:
        logger.warning("canary failed on %s:%s", path, instance_id,
                       exc_info=True)
        return False
    finally:
        token.detach()


@dataclass
class _Target:
    path: str
    instance_id: Optional[int]
    payload: Dict[str, Any]          # template; request_id minted per probe
    ready: bool = True
    last_result_t: float = 0.0
    activity: asyncio.Event = field(default_factory=asyncio.Event)
    task: Optional[asyncio.Task] = None
    # deregistered: the loop must exit even if its cancellation is lost
    # (py3.10 wait_for swallows a cancel that races the inner future
    # completing — exactly what happens when drain's last stream frames
    # fire on_activity while close() cancels the canary)
    closed: bool = False

    @property
    def subject(self) -> str:
        return f"{self.path}:{self.instance_id}"


class SystemHealth:
    """Per-process endpoint health registry + canary scheduler."""

    def __init__(self, runtime, config: Optional[HealthCheckConfig] = None):
        self.runtime = runtime
        self.config = config or HealthCheckConfig.from_env()
        self.targets: Dict[str, _Target] = {}
        self._withdrawn = False
        self._lease_lock: Optional[asyncio.Lock] = None
        self._reconcile_tasks: set = set()  # strong refs (GC pitfall)

    # -- registration (Endpoint.serve_endpoint) ---------------------------
    def register_target(self, path: str, instance_id: Optional[int],
                        payload: Dict[str, Any]) -> None:
        t = _Target(path=path, instance_id=instance_id, payload=payload)
        self.targets[t.subject] = t
        t.task = asyncio.get_running_loop().create_task(
            self._canary_loop(t))
        logger.info("canary armed for %s (wait %.0fs)", t.subject,
                    self.config.canary_wait_s)

    async def deregister_target(self, path: str,
                                instance_id: Optional[int]) -> None:
        t = self.targets.pop(f"{path}:{instance_id}", None)
        if t is not None and t.task is not None:
            t.closed = True
            t.task.cancel()
            try:
                await t.task
            except asyncio.CancelledError:
                pass
        # dropping a not-ready target can flip aggregate health
        self._maybe_reconcile()

    async def close(self) -> None:
        for t in list(self.targets.values()):
            await self.deregister_target(t.path, t.instance_id)
        for task in list(self._reconcile_tasks):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    # -- signals ----------------------------------------------------------
    def notify_activity(self, path: str,
                        instance_id: Optional[int]) -> None:
        """A response frame streamed successfully on this endpoint: reset
        the canary timer and count as proof of health."""
        t = self.targets.get(f"{path}:{instance_id}")
        if t is not None:
            t.activity.set()
            if not t.ready:
                self._set_ready(t, True)

    @property
    def healthy(self) -> bool:
        return all(t.ready for t in self.targets.values())

    def statuses(self) -> Dict[str, str]:
        return {t.subject: ("ready" if t.ready else "not_ready")
                for t in self.targets.values()}

    # -- canary machinery -------------------------------------------------
    async def _canary_loop(self, t: _Target) -> None:
        while not t.closed:
            try:
                await asyncio.wait_for(t.activity.wait(),
                                       timeout=self.config.canary_wait_s)
                t.activity.clear()
                continue  # organic traffic proved health; re-arm
            except asyncio.TimeoutError:
                pass
            if t.closed:
                return
            ok = await self._probe(t)
            t.last_result_t = time.monotonic()
            if ok != t.ready:
                self._set_ready(t, ok)
            else:
                # retry a reconcile that failed earlier (e.g. transient
                # discovery outage): every probe re-checks desired state
                self._maybe_reconcile()
            # on failure keep probing at the same cadence so recovery is
            # detected

    async def _probe(self, t: _Target) -> bool:
        # None (handler deregistered from under us) counts as failure:
        # this process MUST hold its own endpoint's handler
        return await probe_endpoint(
            self.runtime, t.path, t.instance_id, t.payload,
            self.config.request_timeout_s) is True

    def _set_ready(self, t: _Target, ready: bool) -> None:
        t.ready = ready
        logger.warning("endpoint %s -> %s", t.subject,
                       "ready" if ready else "NOT READY")
        m = self.runtime.metrics.scoped(component="health")
        m.inc("dynamo_health_transitions_total",
              endpoint=t.path, to="ready" if ready else "not_ready")
        self._maybe_reconcile()

    def _maybe_reconcile(self) -> None:
        if not self.config.withdraw or self._withdrawn == (not self.healthy):
            return
        task = asyncio.get_running_loop().create_task(
            self._reconcile_lease())
        self._reconcile_tasks.add(task)
        task.add_done_callback(self._reconcile_tasks.discard)

    async def _reconcile_lease(self) -> None:
        """Withdraw the process's discovery lease while unhealthy; restore
        it when every endpoint is ready again.  Serialized by a lock —
        rapid flaps (withdraw mid-flight when health recovers) must not
        interleave the backend's per-key awaits — and _withdrawn only
        advances after the backend call succeeds, so a failed attempt is
        retried by the next probe's _maybe_reconcile."""
        if self._lease_lock is None:
            self._lease_lock = asyncio.Lock()
        async with self._lease_lock:
            want_withdrawn = not self.healthy  # re-read under the lock
            if want_withdrawn == self._withdrawn:
                return
            try:
                if want_withdrawn:
                    logger.warning("withdrawing discovery lease (unhealthy)")
                    await self.runtime.discovery.withdraw_lease()
                else:
                    logger.warning("restoring discovery lease (recovered)")
                    await self.runtime.discovery.restore_lease()
                self._withdrawn = want_withdrawn
            except Exception:
                logger.exception("lease reconcile failed (will retry on "
                                 "next canary result)")

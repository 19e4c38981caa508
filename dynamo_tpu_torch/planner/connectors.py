"""EXECUTE: connectors that change the fleet.

A copy of dynamo_tpu/planner/connectors.py without its chaos seams.  The
planner core never spawns anything itself; it hands a desired replica
count to a connector.  CallbackConnector adapts any async spawn/stop
pair (tests use it with in-process TorchEngineWorkers);
SubprocessConnector manages `python -m <module>` worker processes on
this host (`dynamo_tpu_torch.engine` for the port's worker);
KubernetesConnector patches a Deployment's scale subresource.

Robust actuation:

  * **Drain-gated scale-down** — ``Connector.drain(replicas)`` is the
    scale-down verb the planner's RECONCILE uses: each victim's routing
    identity is withdrawn FIRST (stops new routing), in-flight streams
    get a bounded grace to finish or migrate via the frontend's
    token-replay path, and only then does the hard stop land
    (TERM→KILL for subprocesses, the ``stop`` callback for in-process
    workers).  A worker that ignores drain is escalated past after the
    deadline; its streams migrate exactly like a crash, so scale-down
    during live traffic stays token-identical to a fault-free run.

  * **Crashloop-proof spawn** — every spawn routes through a
    :class:`SpawnGovernor`: consecutive failures back off
    exponentially, and a streak past the threshold opens a circuit
    breaker that refuses spawns for a cool-off window (half-open after:
    one probe spawn, success closes it).  Without this a worker that
    dies at boot is silently respawned every planner tick, forever.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
import time
from typing import Awaitable, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


class SpawnGovernor:
    """Spawn-failure governor: exponential backoff per consecutive
    failure, circuit breaker past a streak threshold.

    The governor never raises — it answers ``allow()`` and the
    connector simply stops spawning this round; the planner's next tick
    retries once the backoff (or breaker cool-off) expires.  A success
    closes everything.  Counters are cumulative so the planner can
    export them as ``dynamo_planner_*`` metrics."""

    def __init__(self, backoff_base_s: float = 1.0,
                 backoff_max_s: float = 30.0,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 60.0):
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.failures = 0            # consecutive streak
        self.failures_total = 0
        self.successes_total = 0
        self.breaker_opens_total = 0
        self.not_before = 0.0        # monotonic: next attempt allowed at
        self.breaker_open_until = 0.0

    def allow(self, now: Optional[float] = None) -> bool:
        return self.why_blocked(now) is None

    def why_blocked(self, now: Optional[float] = None) -> Optional[str]:
        now = time.monotonic() if now is None else now
        if now < self.breaker_open_until:
            return "breaker_open"
        if now < self.not_before:
            return "backoff"
        return None

    def record_success(self) -> None:
        self.successes_total += 1
        self.failures = 0
        self.not_before = 0.0
        self.breaker_open_until = 0.0

    def record_failure(self, now: Optional[float] = None) -> bool:
        """Returns True when this failure OPENED the breaker (the
        transition — callers snapshot the flight recorder on it, not on
        every failure while it stays open)."""
        now = time.monotonic() if now is None else now
        self.failures += 1
        self.failures_total += 1
        backoff = min(self.backoff_base_s * (2 ** (self.failures - 1)),
                      self.backoff_max_s)
        self.not_before = now + backoff
        if self.failures >= self.breaker_threshold:
            newly_open = now >= self.breaker_open_until
            self.breaker_open_until = now + self.breaker_reset_s
            if newly_open:
                self.breaker_opens_total += 1
                logger.error(
                    "spawn circuit breaker OPEN after %d consecutive "
                    "failures (cool-off %.0fs)", self.failures,
                    self.breaker_reset_s)
            return newly_open
        return False

    @property
    def breaker_open(self) -> bool:
        return time.monotonic() < self.breaker_open_until

    def state(self) -> dict:
        now = time.monotonic()
        return {
            "failure_streak": self.failures,
            "failures_total": self.failures_total,
            "successes_total": self.successes_total,
            "breaker_opens_total": self.breaker_opens_total,
            "breaker_open": now < self.breaker_open_until,
            "backoff_remaining_s": round(max(
                0.0, max(self.not_before, self.breaker_open_until) - now),
                3),
        }


class Connector:
    """scale() must be idempotent and return the applied replica count.

    ``drain(replicas)`` is the drain-gated scale-down verb: same
    contract as scale(), but victims get their routing identity
    withdrawn and a bounded grace for in-flight work before the hard
    stop.  The base implementation delegates to scale() — a connector
    whose stop path is already drain-gated (SubprocessConnector: the
    worker's SIGTERM handler runs its own drain) needs nothing more."""

    async def current_replicas(self) -> int:
        raise NotImplementedError

    async def scale(self, replicas: int) -> int:
        raise NotImplementedError

    async def drain(self, replicas: int) -> int:
        return await self.scale(replicas)

    async def close(self) -> None:
        pass


class CallbackConnector(Connector):
    """spawn() -> handle, stop(handle); newest workers are stopped first
    (they hold the least prefix cache).

    An optional ``drain(handle, deadline_s)`` callback makes
    ``drain(replicas)`` scale-down drain-gated: the callback is awaited
    under ``drain_deadline_s + drain_escalate_margin_s`` (the worker's
    own drain bounds itself at deadline_s and then drain-aborts; the
    margin only matters for a worker that IGNORES drain, which is
    escalated straight to stop, counted in ``drain_escalations``)."""

    def __init__(self, spawn: Callable[[], Awaitable],
                 stop: Callable[[object], Awaitable[None]],
                 drain: Optional[Callable[[object, float],
                                          Awaitable[None]]] = None,
                 drain_deadline_s: float = 5.0,
                 drain_escalate_margin_s: float = 2.0,
                 governor: Optional[SpawnGovernor] = None):
        self._spawn = spawn
        self._stop = stop
        self._drain = drain
        self.drain_deadline_s = drain_deadline_s
        self.drain_escalate_margin_s = drain_escalate_margin_s
        self.governor = governor or SpawnGovernor()
        self.drain_escalations = 0
        self.handles: List[object] = []

    async def current_replicas(self) -> int:
        return len(self.handles)

    async def scale(self, replicas: int) -> int:
        while len(self.handles) < replicas:
            if not self.governor.allow():
                logger.warning(
                    "spawn blocked (%s): %d/%d replicas",
                    self.governor.why_blocked(), len(self.handles),
                    replicas)
                break
            try:
                handle = await self._spawn()
            except Exception:
                self.governor.record_failure()
                logger.warning("replica spawn failed (streak %d)",
                               self.governor.failures, exc_info=True)
                break
            self.governor.record_success()
            self.handles.append(handle)
        while len(self.handles) > replicas:
            await self._stop(self.handles.pop())
        return len(self.handles)

    async def drain(self, replicas: int) -> int:
        while len(self.handles) > replicas:
            handle = self.handles.pop()
            if self._drain is not None:
                try:
                    await asyncio.wait_for(
                        self._drain(handle, self.drain_deadline_s),
                        self.drain_deadline_s
                        + self.drain_escalate_margin_s)
                except Exception:
                    # a drain that wedges or raises must not hold
                    # RECONCILE hostage: escalate to the
                    # hard stop — in-flight streams migrate via token
                    # replay exactly like a crash
                    self.drain_escalations += 1
                    logger.warning(
                        "worker ignored drain (deadline %.1fs); "
                        "escalating to stop", self.drain_deadline_s,
                        exc_info=True)
            await self._stop(handle)
        if len(self.handles) < replicas:
            return await self.scale(replicas)
        return len(self.handles)

    async def close(self) -> None:
        # bypass the governor: close() must always tear down
        while self.handles:
            await self._stop(self.handles.pop())


class SubprocessConnector(Connector):
    """One replica == one `python -m <module> <args>` process.

    Processes inherit the planner's discovery environment.  Scale-down IS
    drain-gated here: SIGTERM runs the worker's installed drain handler
    (runtime/aio.py install_drain_handler → worker.drain(): lease
    withdrawal, bounded in-flight grace, drain-abort → token-replay
    migration), and only a worker that ignores SIGTERM past
    ``term_grace_s`` gets the KILL escalation — size term_grace_s to
    the workers' ``--drain-deadline-s`` plus margin.

    A spawned process that exits within ``early_exit_s`` counts as a
    spawn FAILURE (a worker that dies at boot): the governor backs off
    and eventually opens the breaker instead of letting the planner
    respawn the crashloop every tick.

    Replicas' output goes to /dev/null, as JAX's; with ``log_dir`` each
    replica's stdout and stderr go to ``{log_dir}/replica-{n}.log``
    instead (n counts spawns from 0; ``logs`` maps a process to its
    file), so the caller can read what a worker logged, its kernel
    launches at exit among it."""

    def __init__(self, module: str, args: Sequence[str] = (),
                 term_grace_s: float = 5.0,
                 early_exit_s: float = 10.0,
                 governor: Optional[SpawnGovernor] = None,
                 log_dir: str = ""):
        self.module = module
        self.args = list(args)
        self.term_grace_s = term_grace_s
        self.early_exit_s = early_exit_s
        self.governor = governor or SpawnGovernor()
        self.log_dir = log_dir
        self.logs: Dict[int, str] = {}  # pid -> log file
        self.drain_escalations = 0
        self.procs: List[asyncio.subprocess.Process] = []
        # id(proc) -> {"t": spawn time, "credited": success recorded}
        self._meta: Dict[int, dict] = {}

    async def current_replicas(self) -> int:
        now = time.monotonic()
        live = []
        for p in self.procs:
            meta = self._meta.setdefault(
                id(p), {"t": now, "credited": False})
            if p.returncode is None:
                if not meta["credited"] \
                        and now - meta["t"] >= self.early_exit_s:
                    # survived the boot window: the streak resets
                    meta["credited"] = True
                    self.governor.record_success()
                live.append(p)
                continue
            self._meta.pop(id(p), None)
            if not meta["credited"] and now - meta["t"] < self.early_exit_s:
                self.governor.record_failure(now)
                logger.warning(
                    "worker pid %d exited rc=%s %.1fs after spawn: boot "
                    "crash (spawn failure streak %d)", p.pid, p.returncode,
                    now - meta["t"], self.governor.failures)
        self.procs = live
        return len(live)

    async def scale(self, replicas: int) -> int:
        await self.current_replicas()  # drop crashed procs first
        while len(self.procs) < replicas:
            now = time.monotonic()
            if not self.governor.allow(now):
                logger.warning("spawn blocked (%s): %d/%d replicas",
                               self.governor.why_blocked(now),
                               len(self.procs), replicas)
                break
            try:
                proc = await self._spawn()
            except Exception:
                self.governor.record_failure()
                logger.warning("spawn of %s failed (streak %d)",
                               self.module, self.governor.failures,
                               exc_info=True)
                break
            logger.info("planner spawned %s pid=%d", self.module, proc.pid)
            # success is credited only after the proc survives
            # early_exit_s (current_replicas), not at spawn — a
            # boot-crasher must not reset the streak by forking
            self._meta[id(proc)] = {"t": time.monotonic(),
                                    "credited": False}
            self.procs.append(proc)
        while len(self.procs) > replicas:
            proc = self.procs.pop()
            self._meta.pop(id(proc), None)
            await self._terminate(proc)
        return len(self.procs)

    async def _spawn(self):
        if not self.log_dir:
            return await asyncio.create_subprocess_exec(
                sys.executable, "-m", self.module, *self.args,
                stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.DEVNULL,
            )
        path = os.path.join(self.log_dir, f"replica-{len(self.logs)}.log")
        with open(path, "w") as out:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", self.module, *self.args,
                stdout=out, stderr=asyncio.subprocess.STDOUT,
            )
        self.logs[proc.pid] = path
        return proc

    async def _terminate(self, proc) -> None:
        if proc.returncode is not None:
            return
        proc.send_signal(signal.SIGTERM)
        try:
            await asyncio.wait_for(proc.wait(), self.term_grace_s)
        except asyncio.TimeoutError:
            self.drain_escalations += 1
            logger.warning("pid %d ignored SIGTERM; killing", proc.pid)
            proc.kill()
            await proc.wait()

    async def close(self) -> None:
        # bypass the governor: close() must always tear down
        while self.procs:
            proc = self.procs.pop()
            self._meta.pop(id(proc), None)
            await self._terminate(proc)


class KubernetesConnector(Connector):
    """One replica == one pod of a Deployment: scaling patches the
    Deployment's scale subresource through the API server's JSON
    interface, with the port's standard-library HTTP client
    (runtime/http.py) where the JAX connector uses aiohttp.

    The unit is a plain Deployment (deploy/ manifests), so any K8s
    cluster works without CRDs.

    Drain semantics: scale-down is drain-gated by the POD LIFECYCLE,
    not by this connector — kubelet sends the victim pod SIGTERM, the
    worker's installed drain handler withdraws its lease and lets
    in-flight streams finish or migrate, and the KILL escalation is
    ``terminationGracePeriodSeconds`` (size it to the worker's
    ``--drain-deadline-s`` plus margin).  Which pod the Deployment
    controller deletes is its choice — workers must therefore all be
    drain-clean."""

    def __init__(self, deployment: str, namespace: str = "",
                 api_url: str = "", token: str = ""):
        from ..runtime.kube import resolve_k8s_credentials

        self.deployment = deployment
        # ONE credential/namespace resolution shared with the discovery
        # backend (runtime/kube.py): same in-cluster namespace file, same
        # cluster-CA TLS context
        self.api, self.namespace, self.token, self._ssl = \
            resolve_k8s_credentials(api_url, namespace, token)
        self._client = None

    def _http(self):
        from ..runtime.http import HttpClient

        if self._client is None or self._client.closed:
            self._client = HttpClient(self.api, token=self.token,
                                      ssl_context=self._ssl)
        return self._client

    def _scale_path(self) -> str:
        return (f"/apis/apps/v1/namespaces/{self.namespace}"
                f"/deployments/{self.deployment}/scale")

    async def current_replicas(self) -> int:
        out = await self._http().call("GET", self._scale_path())
        return int(out.get("spec", {}).get("replicas", 0))

    async def scale(self, replicas: int) -> int:
        patch = {"spec": {"replicas": int(replicas)}}
        out = await self._http().call(
            "PATCH", self._scale_path(), patch,
            headers={"Content-Type": "application/merge-patch+json"})
        applied = int(out.get("spec", {}).get("replicas", replicas))
        logger.info("k8s scaled %s/%s to %d", self.namespace,
                    self.deployment, applied)
        return applied

    async def close(self) -> None:
        if self._client is not None and not self._client.closed:
            await self._client.close()

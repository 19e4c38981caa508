"""Per-process system status server: /health /live /metrics and the
token-gated admin debug surface /debug/state, /debug/requests, /debug/kv
and /debug/profile.

A copy of dynamo_tpu/runtime/system_status.py with the same routes,
status codes and JSON bodies, on the standard library: the JAX module
serves with aiohttp, which the machines the port serves on do not have,
so this one is a minimal HTTP/1.1 server over asyncio streams (one
request per connection, `Connection: close`).  `/debug/state` is a JSON
dump of everything a live incident needs that pre-aggregated gauges
can't give (the registered sources: scheduler slots, in-flight request
ids, KV occupancy per tier, capture-watch family stats, effective
config; the flight recorder's last-N spans), and `/debug/profile`
captures a time-bounded `torch.profiler` trace (CPU and CUDA activities,
exported as a Chrome trace) plus a device-memory snapshot
(`torch.cuda.memory_stats()` and `mem_get_info()`) on demand.

Exposure model: the server binds `host` (default 0.0.0.0 so k8s probes
and Prometheus can reach it); /health, /live and /metrics carry no
secrets and stay open, while every /debug/* route requires the
DYN_ADMIN_TOKEN shared secret (constant-time compare; no token
configured = 403, fail closed).  Workers register callables via
`DistributedRuntime.register_debug_source`, so the dump reflects
whatever serves in this process without the server knowing any
engine's shape.  A server that cannot bind raises.
"""

from __future__ import annotations

import asyncio
import hmac
import inspect
import json
import logging
import math
import os
import tempfile
import time
from dataclasses import asdict
from http import HTTPStatus
from typing import TYPE_CHECKING, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .metrics import CONTENT_TYPE

if TYPE_CHECKING:
    from .distributed import DistributedRuntime

logger = logging.getLogger(__name__)

# profiler capture bounds: long enough for a few scheduler steps on a
# busy fleet, short enough that an operator can't wedge a worker behind
# an hour-long trace
PROFILE_MIN_S = 0.05
PROFILE_MAX_S = 60.0

# /debug/state flight-recorder tail: enough spans to see the steps that
# led up to an incident without shipping the whole 16k ring per scrape
DEFAULT_FLIGHT_SPANS = 64
MAX_FLIGHT_SPANS = 4096

# request head and body bounds: the routes take a query string at most
MAX_HEAD_BYTES = 16384
MAX_BODY_BYTES = 65536
READ_TIMEOUT_S = 10.0

JSON_TYPE = "application/json; charset=utf-8"


class Request:
    """One parsed request: method, path, query (first value per key) and
    headers (case-insensitive lookup through `header`)."""

    def __init__(self, method: str, target: str, headers: Dict[str, str]):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path
        self.query = {k: v[0] for k, v in
                      parse_qs(parts.query, keep_blank_values=True).items()}
        self.headers = headers

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


# a response: (status, content type, body)
Response = Tuple[int, str, bytes]


def json_response(obj, status: int = 200) -> Response:
    return status, JSON_TYPE, json.dumps(obj).encode()


class SystemStatusServer:
    def __init__(self, runtime: "DistributedRuntime", port: int,
                 host: str = "0.0.0.0"):
        self.runtime = runtime
        self.host = host
        self.port = port
        self.bound_port: Optional[int] = None  # actual port once started
        self._server: Optional[asyncio.AbstractServer] = None
        self._started_t = time.monotonic()
        self._profile_lock = asyncio.Lock()
        self._routes = {
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._live,
            ("GET", "/metrics"): self._metrics,
            ("GET", "/debug/state"): self._debug_state,
            ("GET", "/debug/requests"): self._debug_requests,
            ("GET", "/debug/kv"): self._debug_kv,
            ("GET", "/debug/profile"): self._debug_profile,
            ("POST", "/debug/profile"): self._debug_profile,
        }

    # -- open routes ------------------------------------------------------
    async def _health(self, request: Request) -> Response:
        shutting_down = self.runtime.root_token.is_stopped()
        canaries_ok = self.runtime.system_health.healthy
        healthy = not shutting_down and canaries_ok
        status = ("shutting_down" if shutting_down
                  else "healthy" if canaries_ok else "unhealthy")
        return json_response(
            {"status": status,
             "worker_id": self.runtime.worker_id,
             "endpoints": self.runtime.system_health.statuses()},
            status=200 if healthy else 503,
        )

    async def _live(self, request: Request) -> Response:
        return json_response({"status": "live"})

    async def _metrics(self, request: Request) -> Response:
        return 200, CONTENT_TYPE, self.runtime.metrics.render()

    # -- admin gate -------------------------------------------------------
    def _authorize(self, request: Request) -> Optional[Response]:
        """None = authorized; else the error response.  The token rides
        `Authorization: Bearer <tok>` or `X-Dyn-Admin-Token`."""
        token = self.runtime.config.admin_token
        if not token:
            return json_response(
                {"error": "admin surface disabled: set DYN_ADMIN_TOKEN "
                          "on this process to enable /debug/*"},
                status=403)
        given = request.header("X-Dyn-Admin-Token")
        if not given:
            auth = request.header("Authorization")
            if auth.startswith("Bearer "):
                given = auth[len("Bearer "):]
        if not hmac.compare_digest(given.encode(), token.encode()):
            return json_response({"error": "unauthorized"}, status=401)
        return None

    # -- /debug/state -----------------------------------------------------
    async def _debug_state(self, request: Request) -> Response:
        err = self._authorize(request)
        if err is not None:
            return err
        try:
            n_spans = int(request.query.get("spans", DEFAULT_FLIGHT_SPANS))
        except ValueError:
            n_spans = DEFAULT_FLIGHT_SPANS
        n_spans = max(0, min(n_spans, MAX_FLIGHT_SPANS))
        rt = self.runtime
        cfg = asdict(rt.config)
        cfg["admin_token"] = "***" if cfg.get("admin_token") else ""
        state = {
            "worker_id": rt.worker_id,
            "pid": os.getpid(),
            "ts_unix": time.time(),
            "uptime_s": round(time.monotonic() - self._started_t, 3),
            "health": {
                "shutting_down": rt.root_token.is_stopped(),
                "healthy": rt.system_health.healthy,
                "endpoints": rt.system_health.statuses(),
            },
            "config": cfg,
            "sources": await self._merge_sources(rt.debug_sources, "debug"),
            "flight": self._flight_tail(n_spans),
        }
        # sources can carry non-JSON leaves (numpy scalars, enums);
        # degrade them to repr instead of 500ing the whole dump
        return 200, JSON_TYPE, json.dumps(state, default=repr).encode()

    @staticmethod
    def _flight_tail(n: int) -> dict:
        """Last-N spans of the in-process flight recorder (obs/), plus
        any post-mortem dumps it already wrote.  Empty when tracing is
        off: the dump stays valid, just without a timeline."""
        from .. import obs

        tr = obs.tracer()
        if tr is None or n == 0:
            return {"enabled": tr is not None, "spans": []}
        with tr._lock:
            tail = list(tr.spans)[-n:]
        now = time.monotonic()
        return {
            "enabled": True,
            "dumps": list(tr.flight_dumps),
            "spans": [
                {"kind": kind, "age_s": round(now - t1, 4),
                 "dur_ms": round((t1 - t0) * 1e3, 3), "track": track,
                 **({"attrs": attrs} if attrs else {}),
                 **({"trace_id": trace_id} if trace_id else {})}
                for kind, t0, t1, track, attrs, trace_id in tail
            ],
        }

    @staticmethod
    async def _merge_sources(registry: dict, what: str) -> dict:
        """Collect one registry's source callables (sync or async) into
        a name->dump dict; a broken source degrades to an error entry
        instead of killing the whole dump."""
        sources = {}
        for name, fn in list(registry.items()):
            try:
                v = fn()
                if inspect.isawaitable(v):
                    v = await v
                sources[name] = v
            except Exception as e:  # a broken source must not kill the dump
                logger.warning("%s source %s failed", what, name,
                               exc_info=True)
                sources[name] = {"error": f"{type(e).__name__}: {e}"}
        return sources

    # -- /debug/requests and /debug/kv ------------------------------------
    async def _merged(self, request: Request, registry: dict,
                      what: str) -> Response:
        err = self._authorize(request)
        if err is not None:
            return err
        body = json.dumps({
            "worker_id": self.runtime.worker_id,
            "pid": os.getpid(),
            "ts_unix": time.time(),
            "sources": await self._merge_sources(registry, what),
        }, default=repr)
        return 200, JSON_TYPE, body.encode()

    async def _debug_requests(self, request: Request) -> Response:
        """Tail-latency forensics dump: per registered source (none in
        the port yet), token-gated like /debug/state."""
        return await self._merged(request, self.runtime.forensics_sources,
                                  "forensics")

    async def _debug_kv(self, request: Request) -> Response:
        """KV-accounting dump: per registered source (none in the port
        yet), token-gated like /debug/state."""
        return await self._merged(request, self.runtime.kv_sources, "kv")

    # -- /debug/profile ---------------------------------------------------
    async def _debug_profile(self, request: Request) -> Response:
        """On-demand, time-bounded `torch.profiler` capture plus a device
        memory snapshot.  One capture at a time per process (409 while
        busy); a profiler that cannot run answers status "unavailable",
        never a 500."""
        err = self._authorize(request)
        if err is not None:
            return err
        try:
            duration_s = float(request.query.get("duration_s", "1.0"))
        except ValueError:
            duration_s = float("nan")
        if not math.isfinite(duration_s):
            return json_response(
                {"error": "duration_s must be a finite number"}, status=400)
        duration_s = min(max(duration_s, PROFILE_MIN_S), PROFILE_MAX_S)
        if self._profile_lock.locked():
            return json_response(
                {"error": "a profiler capture is already running"},
                status=409)
        async with self._profile_lock:
            out_dir = os.environ.get("DYN_PROFILE_DIR") or tempfile.mkdtemp(
                prefix=f"dynprof-{os.getpid()}-")
            result: dict = {"worker_id": self.runtime.worker_id,
                            "pid": os.getpid(),
                            "duration_s": duration_s,
                            "out_dir": out_dir}
            stamp = f"{int(time.time())}-{os.getpid()}"
            trace_dir = os.path.join(out_dir, f"trace-{stamp}")
            try:
                result["backend"], result["trace_file"] = \
                    await _capture_trace(trace_dir, duration_s)
                result["status"] = "ok"
                result["trace_dir"] = trace_dir
            except Exception as e:
                logger.warning("profiler trace capture failed",
                               exc_info=True)
                result["status"] = "unavailable"
                result["error"] = f"{type(e).__name__}: {e}"
            try:
                mem_path = os.path.join(out_dir, f"memory-{stamp}.json")
                await asyncio.to_thread(_save_memory_snapshot, mem_path)
                result["memory_profile"] = mem_path
            except Exception as e:
                result["memory_profile_error"] = f"{type(e).__name__}: {e}"
            return json_response(result)

    # -- HTTP -------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                request = await asyncio.wait_for(self._read_request(reader),
                                                 READ_TIMEOUT_S)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                    asyncio.LimitOverrunError, ConnectionError):
                return
            if request is None:
                resp = json_response({"error": "bad request"}, status=400)
            else:
                resp = await self._dispatch(request)
            status, ctype, body = resp
            head = (f"HTTP/1.1 {status} {HTTPStatus(status).phrase}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n").encode()
            writer.write(head + body)
            await writer.drain()
        except ConnectionError:
            pass
        except Exception:
            logger.warning("system status request failed", exc_info=True)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader
                            ) -> Optional[Request]:
        """The request head (and a body, which no route reads); None when
        it is malformed."""
        head = await reader.readuntil(b"\r\n\r\n")
        if len(head) > MAX_HEAD_BYTES:
            return None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            return None
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            return None
        if n < 0 or n > MAX_BODY_BYTES:
            return None
        if n:
            await reader.readexactly(n)
        return Request(parts[0].upper(), parts[1], headers)

    async def _dispatch(self, request: Request) -> Response:
        handler = self._routes.get((request.method, request.path))
        if handler is not None:
            try:
                return await handler(request)
            except Exception as e:
                logger.warning("%s %s failed", request.method, request.path,
                               exc_info=True)
                return json_response(
                    {"error": f"{type(e).__name__}: {e}"}, status=500)
        if any(path == request.path for _, path in self._routes):
            return json_response({"error": "method not allowed"},
                                 status=405)
        return json_response({"error": "not found"}, status=404)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=MAX_HEAD_BYTES)
        # port 0 = ephemeral: record what the OS picked so the runtime
        # can advertise a scrapeable address in discovery metadata
        self.bound_port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


async def _capture_trace(trace_dir: str,
                         duration_s: float) -> Tuple[str, str]:
    """Profile the whole process (every thread's operators and, on CUDA,
    every kernel the device runs, graph replays' included) for
    duration_s, then export a Chrome trace into trace_dir.  The profiler
    starts and stops on the event loop's thread (its CUPTI client
    registers with the thread that first starts it, which in a serving
    process is the loop's); the wait and the export run off it.
    Returns (backend, trace file)."""
    import torch

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    await asyncio.to_thread(os.makedirs, trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        await asyncio.sleep(duration_s)
        if cuda:
            # the kernels queued inside the window land in the trace
            await asyncio.to_thread(torch.cuda.synchronize)
    finally:
        prof.stop()
    path = os.path.join(trace_dir, "trace.json")
    await asyncio.to_thread(prof.export_chrome_trace, path)
    return ("cuda" if cuda else "cpu"), path


def _save_memory_snapshot(path: str) -> None:
    """The device-memory snapshot: the caching allocator's statistics and
    the device's free/total bytes, as JSON.  Raises without CUDA."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: no device-memory snapshot")
    free, total = torch.cuda.mem_get_info()
    with open(path, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(),
                   "mem_get_info": {"free": free, "total": total},
                   "memory_stats": torch.cuda.memory_stats()}, f)

"""A fleet behind both frontends, for the port frontend's CPU tests.

`LoopThread` runs an event loop on its own thread, so one fleet (workers,
runtimes, frontends, an aiohttp session) serves every test of a module:
a test hands its coroutine to `loop.run(...)`.  `Frontends` is a JAX
runtime with the JAX `HttpService` and a port runtime with the port's,
both in kv mode over one file-discovery directory and the zmq event
plane (as tests/test_torch_frontend.py's `_Stack`), with each watcher's
keyword arguments given by the caller.  `post` and `sse` read a response
as the comparisons want it: ids and timestamps scrubbed, an SSE stream
as its list of (event name, data) pairs.
"""

import asyncio
import json
import threading

import aiohttp

WAIT_S = 60.0
# per-request ids and clocks, which differ between any two responses
SCRUB = frozenset({"id", "created", "created_at", "completed_at",
                   "item_id", "call_id", "input_file_id", "output_file_id",
                   "error_file_id", "ts_unix"})


class LoopThread:
    """An event loop on a daemon thread; `run` waits for a coroutine's
    result from the calling thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="fleet-loop", daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 2 * WAIT_S):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        async def cancel_rest():
            me = asyncio.current_task()
            rest = [t for t in asyncio.all_tasks() if t is not me]
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)

        self.run(cancel_rest())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


async def wait_for(pred, what: str, timeout: float = WAIT_S) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        if loop.time() > end:
            raise AssertionError(f"{what} never came within {timeout:.0f} s")
        await asyncio.sleep(0.02)


def scrub(obj):
    """A body or an SSE event with its ids and timestamps taken out."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in SCRUB}
    if isinstance(obj, (list, tuple)):
        return type(obj)(scrub(v) for v in obj)
    return obj


def sse_events(text: str) -> list:
    """A text/event-stream body as [(event name or None, data)], each
    data parsed as JSON where it is JSON."""
    out = []
    for block in text.split("\n\n"):
        name, data = None, None
        for line in block.split("\n"):
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = line[len("data: "):]
        if data is None:
            continue
        try:
            data = json.loads(data)
        except json.JSONDecodeError:
            pass
        out.append((name, data))
    return out


async def read(r) -> tuple:
    """(status, scrubbed body): an SSE stream as its scrubbed events, a
    JSON body scrubbed, else the text."""
    text = await r.text()
    if r.headers.get("Content-Type", "").startswith("text/event-stream"):
        return r.status, [(n, scrub(d)) for n, d in sse_events(text)]
    try:
        return r.status, scrub(json.loads(text))
    except json.JSONDecodeError:
        return r.status, text


class Frontends:
    """The JAX and the port frontends over one cluster directory."""

    async def start(self, cluster_dir, jax_watch=None, port_watch=None,
                    busy_threshold=None):
        from dynamo_tpu.frontend import HttpService as JaxService
        from dynamo_tpu.frontend import ModelManager as JaxManager
        from dynamo_tpu.frontend import ModelWatcher as JaxWatcher
        from dynamo_tpu.router.kv_router import \
            make_kv_route_factory as jax_kv_factory
        from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
        from dynamo_tpu.runtime import RouterMode as JaxMode
        from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

        from dynamo_tpu_torch.frontend.service import (
            HttpService,
            ModelManager,
            ModelWatcher,
        )
        from dynamo_tpu_torch.router.kv_router import make_kv_route_factory
        from dynamo_tpu_torch.runtime import (
            DistributedRuntime,
            RouterMode,
            RuntimeConfig,
        )

        disc = dict(discovery_backend="file",
                    discovery_path=str(cluster_dir), event_plane="zmq")
        self.jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
        self.prt = await DistributedRuntime(
            config=RuntimeConfig(**disc)).start()
        # many watches scanning one directory at 10 Hz starve the CPU
        # workers' scheduler threads of the interpreter lock; 2 Hz is ample
        for rt in (self.jrt, self.prt):
            rt.discovery.poll_s = 0.5
        self.jmanager, self.pmanager = JaxManager(), ModelManager()
        self.jwatcher = await JaxWatcher(
            self.jrt, self.jmanager, router_mode=JaxMode.KV,
            make_route=jax_kv_factory(self.jrt), **(jax_watch or {})).start()
        self.pwatcher = await ModelWatcher(
            self.prt, self.pmanager, router_mode=RouterMode.KV,
            make_route=make_kv_route_factory(self.prt),
            **(port_watch or {})).start()
        self.jservice = await JaxService(
            self.jrt, self.jmanager, host="127.0.0.1", port=0,
            busy_threshold=busy_threshold).start()
        self.pservice = await HttpService(
            self.prt, self.pmanager, host="127.0.0.1", port=0,
            busy_threshold=busy_threshold).start()
        self.urls = [
            f"http://127.0.0.1:{self.jservice._runner.addresses[0][1]}",
            f"http://127.0.0.1:{self.pservice.bound_port}"]
        self.managers = (self.jmanager, self.pmanager)
        self.services = (self.jservice, self.pservice)
        self.session = aiohttp.ClientSession()
        return self

    async def wait_model(self, name: str, n: int = 1, pred=None):
        for mgr in self.managers:
            await wait_for(lambda: mgr.get(name) is not None
                           and len(mgr.get(name).client.instances) >= n
                           and (pred is None or pred(mgr.get(name))),
                           f"model {name} in both frontends")

    async def post(self, url: str, path: str, body=None, **kw) -> tuple:
        if body is not None:
            kw["json"] = body
        async with self.session.post(url + path, **kw) as r:
            return await read(r)

    async def get(self, url: str, path: str, method: str = "GET") -> tuple:
        async with self.session.request(method, url + path) as r:
            return await read(r)

    async def close(self):
        await self.session.close()
        await self.pservice.close()
        await self.jservice.close()
        await self.pwatcher.close()
        await self.jwatcher.close()
        await self.prt.shutdown()
        await self.jrt.shutdown()

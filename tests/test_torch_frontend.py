"""The port's OpenAI frontend against the JAX package's (CPU).

* `OpenAIPreprocessor` gives JAX's `PreprocessedRequest`s (request id
  aside) for chats with tools, tool_choice and response_format and for
  completions with stops; `OutputParser` gives JAX's deltas.
* The HTTP server (runtime/http_server.py): keep-alive, chunked request
  bodies, `Expect: 100-continue`, case-insensitive headers, aiohttp's
  404/405/413, and `close()` ending an open stream.
* End to end over file discovery and the zmq event plane: one lockstep
  TorchEngineWorker on the CPU behind both the JAX `HttpService` with its
  KV router and the port's.  /v1/models, unary and streamed completions
  and chats (stop strings, tools, usage chunks) and /v1/embeddings give
  equal bodies and SSE events, ids and timestamps aside; bad JSON, an
  unknown model, a bad `messages`, a busy service and a worker error give
  equal status codes and bodies; both routers' indexers score the served
  prefix alike.
* Migration: a scripted stub worker that fails after two tokens, served
  alike to both frontends, migrates and completes as under JAX; a client
  that drops a stream cancels it at the worker, through either frontend.
* The CLI: `python -m dynamo_tpu_torch.frontend --router-mode kv` prints
  its ready line, serves a torch CLI worker over file discovery (HTTP,
  and KServe on `--grpc-port` with the same text), exits 0 on SIGTERM,
  and serves KServe alone with no worker.
"""

import asyncio
import json
import os
import selectors
import signal
import subprocess
import sys

import aiohttp
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.frontend.parsers import OutputParser
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.service import (
    HttpService,
    ModelManager,
    ModelWatcher,
)
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import LLMEngineOutput, ModelDeploymentCard
from dynamo_tpu_torch.protocols import PreprocessedRequest
from dynamo_tpu_torch.protocols.model_card import register_model
from dynamo_tpu_torch.router.kv_router import make_kv_route_factory
from dynamo_tpu_torch.runtime import DistributedRuntime, RouterMode, RuntimeConfig
from dynamo_tpu_torch.runtime.http_server import (
    HttpServer,
    StreamResponse,
    json_response,
)

# the end-to-end cases run CPU forwards inside their async bodies
pytestmark = pytest.mark.allow_slow_callbacks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0
SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
# lockstep decode, one token a frame: both frontends see the same frames,
# so their SSE events can be compared one for one
LOCKSTEP = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
                max_num_seqs=4, prefill_buckets=(8, 16, 32, 64, 128),
                seed=7, overlap_scheduling=False, decode_fused_steps=1)
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather by city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU forwards gain nothing from torch's intra-op threads, and
    that spinning pool starves the discovery and event-plane threads the
    end-to-end cases run beside (a request then takes seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


async def _wait(pred, what: str, timeout: float = WAIT_S) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        if loop.time() > end:
            raise AssertionError(f"{what} never came within {timeout:.0f} s")
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# preprocessor and parsers against JAX's
# ---------------------------------------------------------------------------

_CARD = dict(name="m", context_length=512,
             tokenizer={"type": "mock", "vocab_size": 256})
_TEMPLATE_WITH_TOOLS = (
    "{% if tools %}[tools:{{ tools|length }}]{% endif %}"
    "{% for m in messages %}<{{ m['role'] }}>{{ m['content'] }}"
    "{% endfor %}<assistant>")


def _chat_bodies():
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "weather in Paris?"}]
    return [
        {"messages": msgs, "max_tokens": 9, "temperature": 0.3,
         "top_p": 0.9, "top_k": 5, "seed": 11, "stop": "\n"},
        {"messages": msgs, "tools": TOOLS},
        {"messages": msgs, "tools": TOOLS, "tool_choice": "required"},
        {"messages": msgs, "tools": TOOLS,
         "tool_choice": {"type": "function",
                         "function": {"name": "get_weather"}}},
        {"messages": msgs, "response_format": {
            "type": "json_schema", "json_schema": {"schema": {
                "type": "object", "properties": {"a": {"type": "integer"}}}}}},
        {"messages": msgs, "response_format": {"type": "json_object"},
         "ignore_eos": True, "frequency_penalty": 0.5,
         "nvext": {"annotations": ["x"]}, "lora_name": "ad"},
        {"messages": msgs, "max_completion_tokens": 10000},
    ]


@pytest.mark.parametrize("template", [None, _TEMPLATE_WITH_TOOLS])
def test_preprocessor_matches_jax(template):
    from dynamo_tpu.frontend.preprocessor import \
        OpenAIPreprocessor as JaxPreprocessor
    from dynamo_tpu.protocols import ModelDeploymentCard as JaxCard

    ours = OpenAIPreprocessor(ModelDeploymentCard(chat_template=template,
                                                  **_CARD))
    theirs = JaxPreprocessor(JaxCard(chat_template=template, **_CARD))

    def same(a, b):
        da, db = a.to_dict(), b.to_dict()
        da.pop("request_id")
        db.pop("request_id")
        assert da == db

    for body in _chat_bodies():
        same(ours.preprocess_chat(body), theirs.preprocess_chat(body))
    for body in ({"prompt": "once upon a time", "stop": ["the", "end"],
                  "max_tokens": 7},
                 {"prompt": ["a", "b"], "temperature": 0.0},
                 {"prompt": "x", "request_id": "fixed"}):
        same(ours.preprocess_completion(body),
             theirs.preprocess_completion(body))
    bad = {"messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
           "tool_choice": {"function": {"name": "nope"}}}
    for p in (ours, theirs):
        with pytest.raises(ValueError, match="unknown tool"):
            p.preprocess_chat(bad)
        with pytest.raises(ValueError, match="context length"):
            p.preprocess_completion({"prompt": "y" * 600})


@pytest.mark.parametrize("reasoning", [False, "deepseek_r1", "think"])
def test_output_parser_matches_jax(reasoning):
    from dynamo_tpu.frontend.parsers import OutputParser as JaxParser

    text = ("<think>plan the call</think>Sure. <tool_call>{\"name\": "
            "\"get_weather\", \"arguments\": {\"city\": \"Paris\"}}"
            "</tool_call> done <tool_ca")
    for step in (1, 3, 7, len(text)):
        ours = OutputParser(reasoning=reasoning, tools=True)
        theirs = JaxParser(reasoning=reasoning, tools=True)
        chunks = [text[i:i + step] for i in range(0, len(text), step)]
        for piece in chunks + [None]:
            a = ours.push(piece) if piece is not None else ours.flush()
            b = theirs.push(piece) if piece is not None else theirs.flush()
            assert (a.content, a.reasoning) == (b.content, b.reasoning)
            for ca, cb in zip(a.tool_calls, b.tool_calls):
                assert ca.pop("id").startswith("call_")
                cb.pop("id")
            assert a.tool_calls == b.tool_calls
        assert ours.saw_tool_call == theirs.saw_tool_call


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


async def _raw(port: int, data: bytes, until: bytes = b"") -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = b""
    while not until or until not in out:
        chunk = await asyncio.wait_for(reader.read(65536), WAIT_S)
        if not chunk:
            break
        out += chunk
    writer.close()
    return out


async def test_http_server_keepalive_bodies_headers_and_errors():
    server = HttpServer("127.0.0.1", 0)
    seen = []

    async def echo(request):
        seen.append((request.headers.get("X-Session-ID"),
                     request.headers.get("x-session-id"),
                     "X-SESSION-ID" in request.headers))
        return json_response({"body": await request.json(),
                              "q": request.query}, status=201)

    server.add_post("/echo", echo)
    await server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        # keep-alive: aiohttp's pooled connection serves every request
        conn = aiohttp.TCPConnector(limit=1)
        async with aiohttp.ClientSession(connector=conn) as s:
            for i in range(3):
                async with s.post(f"{url}/echo?a={i}", json={"i": i},
                                  headers={"x-session-id": "s"}) as r:
                    assert r.status == 201
                    assert r.headers["Content-Type"] == \
                        "application/json; charset=utf-8"
                    assert await r.json() == {"body": {"i": i},
                                              "q": {"a": str(i)}}
            assert len(server._conn_tasks) == 1
            async with s.get(f"{url}/echo") as r:
                assert (r.status, await r.text()) == (
                    405, "405: Method Not Allowed")
            async with s.get(f"{url}/none") as r:
                assert (r.status, await r.text()) == (404, "404: Not Found")
            async with s.post(f"{url}/echo",
                              data=b"x" * (1024 ** 2 + 1)) as r:
                assert r.status == 413
        assert seen == [("s", "s", True)] * 3
        # a chunked body after a 100-continue, then a pipelined request
        # on the same connection
        body = b'{"k": [1, 2]}'
        req = (b"POST /echo HTTP/1.1\r\nHost: x\r\nExpect: 100-continue\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n"
               + b"%x\r\n%s\r\n0\r\n\r\n" % (len(body), body)
               + b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
               b"Connection: close\r\n\r\n{}")
        out = await _raw(server.bound_port, req)
        assert out.startswith(b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 201")
        assert out.count(b"HTTP/1.1 201 Created") == 2
        assert b'{"body": {"k": [1, 2]}, "q": {}}' in out
        assert out.endswith(b'{"body": {}, "q": {}}')
        out = await _raw(server.bound_port, b"GARBAGE\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 400 ")
    finally:
        await server.close()


async def test_http_server_close_ends_open_streams():
    server = HttpServer("127.0.0.1", 0)
    cancelled = asyncio.Event()

    async def forever(request):
        resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        try:
            while True:
                await resp.write(b"data: tick\n\n")
                await asyncio.sleep(0.01)
        except asyncio.CancelledError:
            cancelled.set()
            raise

    server.add_get("/s", forever)
    await server.start()
    reader, writer = await asyncio.open_connection("127.0.0.1",
                                                  server.bound_port)
    writer.write(b"GET /s HTTP/1.1\r\nHost: x\r\n\r\n")
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), WAIT_S)
    assert b"Transfer-Encoding: chunked" in head
    assert b"data: tick" in await asyncio.wait_for(reader.read(100), WAIT_S)
    await asyncio.wait_for(server.close(), WAIT_S)
    assert cancelled.is_set()
    # the connection ends: the read sees its end instead of waiting
    await asyncio.wait_for(reader.read(), WAIT_S)
    writer.close()
    assert not server._conn_tasks


# ---------------------------------------------------------------------------
# both frontends in front of one torch worker
# ---------------------------------------------------------------------------


def _scrub(obj):
    """A response body or SSE event with its per-request id and
    timestamp taken out."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


async def _post(session, url, path, body, raw=None):
    kw = {"data": raw} if raw is not None else {"json": body}
    async with session.post(url + path, **kw) as r:
        text = await r.text()
        if body is not None and body.get("stream") and r.status == 200:
            events = [ln[len("data: "):] for ln in text.split("\n\n")
                      if ln.startswith("data: ")]
            return r.status, [e if e == "[DONE]" else _scrub(json.loads(e))
                              for e in events]
        try:
            return r.status, _scrub(json.loads(text))
        except json.JSONDecodeError:
            return r.status, text


class _Stack:
    """A JAX runtime with the JAX frontend and a port runtime with the
    port's, both in kv mode, over one file-discovery directory and the
    zmq event plane."""

    async def start(self, tmp_path, busy_threshold=None):
        from dynamo_tpu.frontend import HttpService as JaxService
        from dynamo_tpu.frontend import ModelManager as JaxManager
        from dynamo_tpu.frontend import ModelWatcher as JaxWatcher
        from dynamo_tpu.router.kv_router import \
            make_kv_route_factory as jax_kv_factory
        from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
        from dynamo_tpu.runtime import RouterMode as JaxMode
        from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

        disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                    event_plane="zmq")
        self.jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
        self.prt = await DistributedRuntime(
            config=RuntimeConfig(**disc)).start()
        # a dozen watches scanning one directory at file discovery's
        # 10 Hz starve the CPU worker's scheduler thread of the
        # interpreter lock (a request then takes seconds); 2 Hz is ample
        for rt in (self.jrt, self.prt):
            rt.discovery.poll_s = 0.5
        self.jmanager, self.pmanager = JaxManager(), ModelManager()
        self.jwatcher = await JaxWatcher(
            self.jrt, self.jmanager, router_mode=JaxMode.KV,
            make_route=jax_kv_factory(self.jrt)).start()
        self.pwatcher = await ModelWatcher(
            self.prt, self.pmanager, router_mode=RouterMode.KV,
            make_route=make_kv_route_factory(self.prt)).start()
        self.jservice = await JaxService(
            self.jrt, self.jmanager, host="127.0.0.1", port=0,
            busy_threshold=busy_threshold).start()
        self.pservice = await HttpService(
            self.prt, self.pmanager, host="127.0.0.1", port=0,
            busy_threshold=busy_threshold).start()
        self.urls = [
            f"http://127.0.0.1:{self.jservice._runner.addresses[0][1]}",
            f"http://127.0.0.1:{self.pservice.bound_port}"]
        return self

    async def wait_model(self, name: str, n: int = 1):
        for mgr in (self.jmanager, self.pmanager):
            await _wait(lambda: mgr.get(name) is not None
                        and len(mgr.get(name).client.instances) >= n,
                        f"model {name} in both frontends")

    async def close(self):
        await self.pservice.close()
        await self.jservice.close()
        await self.pwatcher.close()
        await self.jwatcher.close()


async def test_both_frontends_give_equal_bodies_streams_and_errors(tmp_path):
    from dynamo_tpu.tokens import compute_block_hashes_for_request as jax_plh

    from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

    stack = await _Stack().start(tmp_path)
    tok = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    worker = TorchEngineWorker(stack.prt, EngineConfig(
        model_config=FP32, model_name="m", **LOCKSTEP),
        tokenizer_cfg=tok, device="cpu")

    async def broken(payload, ctx):
        yield LLMEngineOutput(
            finish_reason="error",
            error="worker engine error: HBM OOM during prefill").to_dict()

    try:
        await worker.start()
        await stack.prt.namespace("dynamo").component("broken").endpoint(
            "generate").serve_endpoint(broken, instance_id=1)
        await register_model(stack.prt, ModelDeploymentCard(
            name="broken", component="broken", tokenizer=tok))
        await stack.wait_model("m")
        await stack.wait_model("broken")
        prompt = "the quick brown fox jumps over the lazy dog"
        greedy = {"model": "m", "max_tokens": 8, "temperature": 0.0,
                  "ignore_eos": True}
        chat = dict(greedy, messages=[{"role": "user", "content": prompt}])
        cases = [
            ("/v1/completions", dict(greedy, prompt=prompt)),
            ("/v1/completions", dict(greedy, prompt=prompt, stream=True,
                                     stream_options={"include_usage": True})),
            ("/v1/chat/completions", chat),
            ("/v1/chat/completions", dict(chat, stream=True)),
            ("/v1/chat/completions", dict(chat, tools=TOOLS)),
            ("/v1/chat/completions", dict(chat, tools=TOOLS, stream=True)),
            ("/v1/completions", dict(greedy, prompt=prompt, max_tokens=3,
                                     temperature=0.8, seed=5)),
            ("/v1/embeddings", {"model": "m", "input": [prompt, "a b"]}),
            ("/v1/embeddings", {"model": "m", "input": [1, 2, 3]}),
            # error paths
            ("/v1/chat/completions", {"model": "nope", "messages": []}),
            ("/v1/chat/completions", {"model": "m", "messages": "bad"}),
            ("/v1/completions", {"model": "m", "prompt": "y" * 600}),
            ("/v1/embeddings", {"model": "m"}),
            ("/v1/embeddings", {"model": "nope", "input": "x"}),
            ("/v1/chat/completions", dict(chat, model="broken")),
            ("/v1/chat/completions", dict(chat, model="broken",
                                          stream=True)),
        ]
        async with aiohttp.ClientSession() as s:
            async with s.get(stack.urls[0] + "/v1/models") as a, \
                    s.get(stack.urls[1] + "/v1/models") as b:
                assert a.status == b.status == 200
                assert await a.json() == await b.json()
            async with s.get(stack.urls[0] + "/health") as a, \
                    s.get(stack.urls[1] + "/health") as b:
                assert await a.json() == await b.json()
            async def both(path, body):
                # each frontend's request starts from a cold prefix cache,
                # so both run the same prefill (a cached prefix changes
                # the packing, and with it the fp32 rounding)
                got = []
                for url in stack.urls:
                    await worker.engine.clear_kv_blocks()
                    got.append(await _post(s, url, path, body))
                return got

            for path, body in cases:
                got = await both(path, body)
                assert got[0] == got[1], (path, body)
            unary = await _post(s, stack.urls[1], "/v1/completions",
                                dict(greedy, prompt=prompt))
            assert unary[0] == 200
            assert unary[1]["usage"]["completion_tokens"] == 8
            # a stop string taken from the greedy text: held back across
            # deltas and cut alike
            text = unary[1]["choices"][0]["text"]
            stop = text[3:5]
            for stream in (False, True):
                body = dict(greedy, prompt=prompt, stop=[stop],
                            stream=stream)
                got = await both("/v1/completions", body)
                assert got[0] == got[1]
            got = [await _post(s, url, "/v1/chat/completions", None,
                               raw=b"not json") for url in stack.urls]
            assert got[0] == got[1] == (
                400, {"error": {"message": "invalid JSON body",
                                "type": "invalid_request_error"}})
            for url in stack.urls:
                async with s.get(url + "/v1/nothing") as r:
                    assert (r.status, await r.text()) == (
                        404, "404: Not Found")
            metrics = []
            for url in stack.urls:
                async with s.get(url + "/metrics") as r:
                    metrics.append({ln.split("{")[0].split(" ")[0]
                                    for ln in (await r.text()).splitlines()
                                    if ln and not ln.startswith("#")})
            want = {"dynamo_frontend_requests_total",
                    "dynamo_frontend_itl_seconds_bucket",
                    "dynamo_frontend_request_duration_seconds_bucket",
                    "dynamo_frontend_ttft_seconds_bucket",
                    "dynamo_router_overlap_blocks_bucket",
                    "dynamo_router_overlap_realized_blocks_bucket"}
            assert want <= metrics[0] and want <= metrics[1]
        # both routers' indexers score the served prompt's blocks alike
        iid = worker.served.instance_id
        ids = [3 + b for b in prompt.encode()]
        hashes = compute_block_hashes_for_request(ids, 4)
        assert hashes == jax_plh(ids, 4)
        jrouter = stack.jmanager.get("m").migration.route
        prouter = stack.pmanager.get("m").migration.route
        await _wait(lambda: prouter.indexer.find_matches(hashes)
                    == jrouter.indexer.find_matches(hashes)
                    == {iid: len(hashes)}, "equal index scores")
        assert (prouter.indexer.find_matches_tiered(hashes, [iid])
                == jrouter.indexer.find_matches_tiered(hashes, [iid]))
    finally:
        await stack.close()
        await worker.close()
        await stack.prt.shutdown()
        await stack.jrt.shutdown()


async def test_busy_frontends_answer_503_alike(tmp_path, monkeypatch):
    """busy_threshold 0: every inference and embedding request is shed
    with the same 503; /v1/models still lists the model and, from
    DYN_LORA_PATH, its adapter alias alike."""
    lora = tmp_path / "lora"
    (lora / "ad1").mkdir(parents=True)
    (lora / "ad1" / "adapter_config.json").write_text(json.dumps(
        {"base_model_name_or_path": "s", "r": 4}))
    monkeypatch.setenv("DYN_LORA_PATH", str(lora))
    stack = await _Stack().start(tmp_path / "cluster", busy_threshold=0)

    async def gen(payload, ctx):
        yield LLMEngineOutput(token_ids=[65], finish_reason="length"
                              ).to_dict()

    try:
        await stack.prt.namespace("dynamo").component("stub").endpoint(
            "generate").serve_endpoint(gen, instance_id=3)
        await register_model(stack.prt, ModelDeploymentCard(
            name="s", component="stub"))
        await stack.wait_model("s")
        async with aiohttp.ClientSession() as s:
            for path in ("/v1/completions", "/v1/embeddings"):
                got = [await _post(s, url, path, {"model": "s",
                                                  "prompt": "x"})
                       for url in stack.urls]
                assert got[0] == got[1] == (503, {"error": {
                    "message": "service busy", "type": "overloaded_error"}})
            models = []
            for url in stack.urls:
                async with s.get(url + "/v1/models") as r:
                    models.append(await r.json())
            assert models[0] == models[1]
            assert [m["id"] for m in models[1]["data"]] == ["s", "ad1"]
    finally:
        await stack.close()
        await stack.prt.shutdown()
        await stack.jrt.shutdown()


async def test_migration_and_dropped_streams_alike(tmp_path):
    """A stub that fails after two tokens: both frontends replay onto the
    healthy stub and stream the same text.  A client that drops a stream
    midway cancels the stub's stream through either frontend."""
    stack = await _Stack().start(tmp_path)
    comp = stack.prt.namespace("dynamo").component("stubs")
    replays, cancels, slow_started = [], [], []

    async def flaky(payload, ctx):
        yield LLMEngineOutput(token_ids=[101]).to_dict()
        yield LLMEngineOutput(token_ids=[102]).to_dict()
        raise RuntimeError("connection lost (worker died)")

    async def healthy(payload, ctx):
        req = PreprocessedRequest.from_dict(payload)
        replays.append(req.token_ids[-2:])
        for t in range(req.stop.max_tokens - 1):
            yield LLMEngineOutput(token_ids=[70 + t]).to_dict()
        yield LLMEngineOutput(token_ids=[99],
                              finish_reason="length").to_dict()

    async def slow(payload, ctx):
        slow_started.append(1)
        try:
            for t in range(10000):
                yield LLMEngineOutput(token_ids=[65 + t % 20]).to_dict()
                await asyncio.sleep(0.01)
        finally:
            cancels.append(ctx.is_stopped())

    try:
        await comp.endpoint("generate").serve_endpoint(flaky, instance_id=1)
        await comp.endpoint("generate").serve_endpoint(healthy,
                                                       instance_id=2)
        await comp.endpoint("slow").serve_endpoint(slow, instance_id=3)
        await register_model(stack.prt, ModelDeploymentCard(
            name="mig", component="stubs", migration_limit=3))
        await register_model(stack.prt, ModelDeploymentCard(
            name="slow", component="stubs", endpoint="slow"))
        await stack.wait_model("mig", n=2)
        await stack.wait_model("slow")
        attempts = []

        async def route(r, avoid=()):
            choice = 1 if 1 not in avoid else 2
            attempts.append(choice)
            return choice

        # the KV routers step aside for the scripted route, and come
        # back before the watchers close them
        kv_routes = [(m.get("mig").migration, m.get("mig").migration.route)
                     for m in (stack.jmanager, stack.pmanager)]
        for migration, _ in kv_routes:
            migration.route = route
        body = {"model": "mig", "prompt": "abc", "max_tokens": 6,
                "ignore_eos": True}
        async with aiohttp.ClientSession() as s:
            for stream in (False, True):
                got = [await _post(s, url, "/v1/completions",
                                   dict(body, stream=stream))
                       for url in stack.urls]
                assert got[0] == got[1] and got[0][0] == 200
        assert attempts == [1, 2] * 4
        assert replays == [[101, 102]] * 4
        # a dropped stream: the client reads two events and resets
        for i, (url, service) in enumerate(zip(
                stack.urls, (stack.jservice, stack.pservice))):
            port = int(url.rsplit(":", 1)[1])
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            req = json.dumps({"model": "slow", "prompt": "x",
                              "max_tokens": 5000, "stream": True}).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(req), req))
            await writer.drain()
            seen = b""
            while seen.count(b"data: ") < 2:
                seen += await asyncio.wait_for(reader.read(4096), WAIT_S)
            writer.transport.abort()
            await _wait(lambda: len(cancels) == i + 1,
                        "the stub's stream cancelled")
            assert cancels[i] is True
            await _wait(lambda: service.inflight == 0,
                        "the frontend's in-flight count back to 0")
        assert len(slow_started) == 2
        for migration, kv_route in kv_routes:
            migration.route = kv_route
    finally:
        await stack.close()
        await stack.prt.shutdown()
        await stack.jrt.shutdown()


def test_slo_plane_matches_jax():
    """The same request_end records through both SloPlanes (targets set):
    equal summaries, frontend id aside, and equal metric samples."""
    from dynamo_tpu.obs.slo import SloConfig as JaxSloConfig
    from dynamo_tpu.obs.slo import SloPlane as JaxSloPlane
    from dynamo_tpu.runtime.metrics import MetricsHierarchy as JaxMetrics

    from dynamo_tpu_torch.obs.slo import SloConfig, SloPlane
    from dynamo_tpu_torch.runtime.metrics import MetricsHierarchy

    kw = dict(ttft_ms=50.0, itl_ms=10.0, objective=0.9)
    ours = SloPlane(MetricsHierarchy().scoped(component="frontend"),
                    SloConfig(**kw), frontend_id=7)
    theirs = JaxSloPlane(JaxMetrics().scoped(component="frontend"),
                         JaxSloConfig(**kw), frontend_id=7)

    class Tracker:
        model = "m"

    records = [
        {"request": {"outcome": "ok", "total_time_ms": 120.0,
                     "ttft_ms": 30.0, "avg_itl_ms": 5.0, "queue_ms": 1.5}},
        {"request": {"outcome": "ok", "total_time_ms": 300.0,
                     "ttft_ms": 80.0, "avg_itl_ms": 4.0, "queue_ms": 2.0}},
        {"request": {"outcome": "ok", "total_time_ms": 90.0,
                     "ttft_ms": 20.0, "avg_itl_ms": 25.0}},
        {"request": {"outcome": "no_first_token", "total_time_ms": 3.0}},
        {"request": {"outcome": "error", "total_time_ms": 40.0,
                     "ttft_ms": 10.0}},
    ]
    for rec in records:
        ours.observe_finish(Tracker(), rec)
        theirs.observe_finish(Tracker(), rec)
    ours.refresh()
    theirs.refresh()
    assert ours.summary() == theirs.summary()
    assert ours.summary()["burn_by_phase"] == {
        "ttft": 2.0, "itl": 2.0, "no_first_token": 2.0, "error": 2.0}

    def samples(text: bytes):
        from prometheus_client.parser import text_string_to_metric_families

        return sorted((x.name, sorted(x.labels.items()), x.value)
                      for fam in text_string_to_metric_families(text.decode())
                      for x in fam.samples if not x.name.endswith("_created"))

    assert samples(ours.m.render()) == samples(theirs.m.render())


# ---------------------------------------------------------------------------
# python -m dynamo_tpu_torch.frontend
# ---------------------------------------------------------------------------

CLI_READY_S = 120.0


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, DYN_LOG_LEVEL="WARNING",
               OMP_NUM_THREADS="1", **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def _ready_line(proc, what: str) -> str:
    """The CLI's next stdout line; fails naming `what` (with its stderr,
    the process killed first so the read ends) when none came within
    CLI_READY_S."""
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        line = proc.stdout.readline() if sel.select(CLI_READY_S) else ""
    finally:
        sel.close()
    if not line:
        proc.kill()
        raise AssertionError(f"no ready line from {what} within "
                             f"{CLI_READY_S:.0f} s: "
                             f"{proc.stderr.read()[-4000:]}")
    return line


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


async def _kserve(port: int, name: str, req, resp_cls):
    """One unary KServe RPC to 127.0.0.1:`port`."""
    import grpc.aio

    from dynamo_tpu_torch.frontend.kserve import SERVICE

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_unary(
            f"/{SERVICE}/{name}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        return await asyncio.wait_for(call(req), WAIT_S)


@pytest.mark.parametrize("flags", [["--grpc-port"]])
def test_cli_refuses_unported_flags(flags, tmp_path):
    """No flag of the JAX frontend's CLI is refused any more: with
    `--grpc-port` on a free port the CLI serves KServe beside HTTP (live,
    not ready with no model, the model unknown) and exits 0 on SIGTERM."""
    from dynamo_tpu_torch.frontend import kserve_pb2 as pb

    port = _free_port()
    env = _env(DYN_DISCOVERY_BACKEND="file",
               DYN_DISCOVERY_PATH=str(tmp_path / "cluster"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--host",
         "127.0.0.1", "--port", "0", *flags, str(port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    try:
        assert _ready_line(proc, "the frontend").startswith("ready port=")

        async def ask():
            return (
                await _kserve(port, "ServerLive", pb.ServerLiveRequest(),
                              pb.ServerLiveResponse),
                await _kserve(port, "ServerReady", pb.ServerReadyRequest(),
                              pb.ServerReadyResponse),
                await _kserve(port, "ModelReady",
                              pb.ModelReadyRequest(name="tiny"),
                              pb.ModelReadyResponse))

        live, ready, model = asyncio.run(ask())
        assert live.live and not ready.ready and not model.ready
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_cli_takes_every_jax_flag():
    from dynamo_tpu.frontend.__main__ import build_args as jax_args

    from dynamo_tpu_torch.frontend.__main__ import build_args, unported

    ours = {a.dest: a.default for a in build_args()._actions}
    theirs = {a.dest: a.default for a in jax_args()._actions}
    assert ours == theirs
    assert unported(build_args().parse_args(
        ["--session-affinity-ttl", "0.5"])) == []


def test_cli_serves_a_torch_cli_worker_and_exits_on_sigterm(tmp_path):
    from dynamo_tpu_torch.frontend import kserve_pb2 as pb

    grpc_port = _free_port()
    env = _env(DYN_DISCOVERY_BACKEND="file",
               DYN_DISCOVERY_PATH=str(tmp_path / "cluster"))
    worker = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.engine", "--device", "cpu",
         "--model", "tiny", "--block-size", "16", "--num-blocks", "64",
         "--max-blocks-per-seq", "8", "--max-num-seqs", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    frontend = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--host",
         "127.0.0.1", "--port", "0", "--router-mode", "kv",
         "--grpc-port", str(grpc_port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    try:
        line = _ready_line(frontend, "the frontend")
        assert line.startswith("ready port="), line
        port = int(line.strip().split("=", 1)[1])
        assert port > 0
        assert _ready_line(worker, "the worker").startswith("ready ")

        async def drive():
            url = f"http://127.0.0.1:{port}"
            async with aiohttp.ClientSession() as s:
                loop = asyncio.get_running_loop()
                end = loop.time() + WAIT_S
                while True:
                    async with s.get(url + "/v1/models") as r:
                        models = (await r.json())["data"]
                    if models or loop.time() > end:
                        break
                    await asyncio.sleep(0.1)
                assert [m["id"] for m in models] == ["tiny"], \
                    "no model discovered by the frontend"
                body = {"model": "tiny", "prompt": "hello", "max_tokens": 4,
                        "ignore_eos": True, "temperature": 0.0}
                async with s.post(url + "/v1/completions", json=body) as r:
                    assert r.status == 200, await r.text()
                    data = await r.json()
            assert data["usage"]["completion_tokens"] == 4
            # the same request through the CLI's KServe service
            req = pb.ModelInferRequest(model_name="tiny", id="cli-grpc")
            t = req.inputs.add()
            t.name, t.datatype = "text_input", "BYTES"
            t.contents.bytes_contents.append(b"hello")
            req.parameters["max_tokens"].int64_param = 4
            req.parameters["ignore_eos"].bool_param = True
            resp = await _kserve(grpc_port, "ModelInfer", req,
                                 pb.ModelInferResponse)
            assert resp.outputs[0].contents.bytes_contents[0].decode() \
                == data["choices"][0]["text"]
            assert resp.parameters["finish_reason"].string_param == "length"

        asyncio.run(drive())
        frontend.send_signal(signal.SIGTERM)
        assert frontend.wait(timeout=60) == 0, frontend.stderr.read()
    finally:
        for proc in (frontend, worker):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
            proc.stdout.close()
            proc.stderr.close()

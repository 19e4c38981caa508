"""The torch engine worker against the JAX package (CPU).

* KvEventPublisher: the port's wire payloads equal the JAX publisher's
  for the same batches, and so do their msgpack bytes.
* TorchEngine and JaxEngine on the tiny fp32 config with converted
  weights emit the same netted stored/removed sequences for the same
  requests (a prefix hit, eviction under a small pool, clear_kv_blocks).
* End to end: the unchanged JAX frontend (HttpService, ModelWatcher in
  RouterMode.KV, the KV route factory) on a JAX runtime, in front of a
  TorchEngineWorker on the port's runtime and a JaxEngineWorker serving
  the same converted weights, over FileDiscovery in one directory and the
  zmq event plane: greedy /v1/completions give the same token ids from
  both, the frontend's KV indexer scores the torch worker's blocks, and
  load_metrics, FPM records and kv_events_replay answer.
* A worker serving a checkpoint (model_path) publishes the JAX worker's
  MDC: the inline "hf" tokenizer, the chat template, the effective
  sampling_epilogue.
* Drain: in-flight requests finish, new ones get the migratable marker,
  the rest are aborted with it at the deadline.
* `python -m dynamo_tpu_torch.engine --device cpu` registers, and SIGTERM
  deregisters it; without CUDA and without --device it exits non-zero;
  its --model-path and --sampling-epilogue are the JAX CLI's.
"""

import asyncio
import json
import os
import selectors
import signal
import subprocess
import sys
import time
import uuid

import aiohttp
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.router.events import KvEventPublisher as JaxPublisher
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, TorchEngineWorker
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    DRAIN_ABORT,
    DRAIN_REJECT,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.router.events import KvEventPublisher
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.codec import packb
from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)


def _jax_and_torch_params(**kw):
    """A JaxEngine and the port's parameter tree of its weights.  The JAX
    engine runs its lockstep scheduler (overlap_scheduling=False, single
    decode steps), as the port engine of the KV-event test below does:
    the overlapped scheduler grows and frees blocks in other batches,
    which nets to other event batches (tests/test_torch_overlap.py holds
    the overlapped port to the overlapped JaxEngine)."""
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32,
                                   decode_fused_steps=1,
                                   overlap_scheduling=False, **kw))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    return je, params_from_numpy(tree, FP32, device="cpu")


# ---------------------------------------------------------------------------
# KvEventPublisher wire payloads
# ---------------------------------------------------------------------------


class _Recorder:
    """A runtime stand-in whose event plane records what is published."""

    def __init__(self):
        self.sent = []
        self.event_plane = self

    async def publish(self, subject, payload):
        self.sent.append((subject, payload))


async def test_publisher_wire_payloads_equal_jax():
    big = (1 << 127) + 12345  # a 128-bit PLH: bytes on the wire
    batches = [dict(stored=[1, 2, big]), dict(removed=[2], stored=[7, 8]),
               dict(removed=[1, big], tier="g1"),
               dict(stored=[5], parent_hash=big), dict(removed=[9])]
    sides = []
    for cls in (KvEventPublisher, JaxPublisher):
        rt = _Recorder()
        pub = cls(rt, "ns", "comp", worker_id=(1 << 63) - 5)
        for b in batches:
            pub.enqueue_batch(**b)
        await pub._flush()
        await pub.cleared()
        replay = [e async for e in pub.replay_handler({"since_event_id": 2},
                                                      None)]
        pub.enqueue_batch(stored=[11, 12])
        await pub._flush()
        snap = [e async for e in pub.replay_handler({"snapshot": True}, None)]
        sides.append((rt.sent, replay, snap))
    assert sides[0] == sides[1]
    sent = sides[0][0]
    assert [s for s, _ in sent] == ["kv_events.ns.comp"] * len(sent)
    assert [p["op"] for _, p in sent] == [
        "stored", "removed", "stored", "removed", "stored", "removed",
        "cleared", "stored"]
    for _, p in sent:
        assert packb(p) == msgpack.packb(p, use_bin_type=True)


# ---------------------------------------------------------------------------
# netted KV events: TorchEngine against JaxEngine
# ---------------------------------------------------------------------------


def _req(jax_side, tokens, rid, n):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0),
             stop=T(max_tokens=n, ignore_eos=True))


async def _idle(eng, timeout_s: float = 30.0):
    """Wait until `eng` holds no request, no unread burst and no deferred
    first token, and no scheduler step is running.  A stream ends while
    the step that read its finish is still running: in overlap mode that
    step goes on to the adaptive-fusion clock (`_fused_k`), which resets
    its ramp if the next request is already waiting.  Both engines do so,
    so the next arrival waits for this state, not for the stream's end."""
    deadline = time.monotonic() + timeout_s
    while (eng.waiting or eng._inflight or eng._pending_first
           or any(s is not None for s in eng._slots)
           or eng._step_lock.locked()):
        assert time.monotonic() < deadline, "the engine did not go idle"
        await asyncio.sleep(0.002)


async def _drive(eng, jax_side, events):
    """The scenario, one request at a time, each sent once the engine is
    idle (_idle): returns greedy streams; KV event batches land in
    `events` through the engine's sink."""
    out = []

    async def run(tokens, rid, n):
        await _idle(eng)
        toks = []
        async for o in eng.generate(_req(jax_side, tokens, rid, n)):
            toks.extend(o.token_ids)
        out.append(toks)

    base = list(range(30, 50))            # 5 full blocks of 4
    await run(base, "a", 6)
    await run(base + [7, 7, 7], "b", 5)   # prefix hit on 5 blocks
    # the pool holds 11 usable blocks: these evict cached blocks
    await run(list(range(100, 128)), "c", 4)
    await run(list(range(60, 80)), "d", 3)
    n = await eng.clear_kv_blocks()
    await asyncio.sleep(0.05)  # the sink runs on the loop thread
    events.append(("cleared", n))
    await run(base, "e", 2)
    await asyncio.sleep(0.05)
    return out


async def test_netted_kv_events_match_jax_engine():
    kw = {**COMMON, "num_blocks": 12}
    je, params = _jax_and_torch_params(**kw)
    te_events, je_events = [], []
    te = TorchEngine(EngineConfig(model_config=FP32, decode_fused_steps=1,
                                  overlap_scheduling=False, **kw),
                     params=params, device="cpu",
                     kv_event_sink=lambda s, r, t: te_events.append(
                         (list(s), list(r), t)))
    je.kv_event_sink = lambda s, r, t: je_events.append((list(s), list(r), t))
    je._sink_takes_tier = True
    try:
        jres = await _drive(je, True, je_events)
        tres = await _drive(te, False, te_events)
    finally:
        await je.close()
        await te.close()
    assert tres == jres
    assert te_events == je_events
    # one FPM record per prefill dispatch and decode step, with the JAX
    # engine's keys and values (timing, XLA cost analysis and JAX's
    # compile-watch records aside)
    timing = {"t", "gap_s", "synced", "est_mfu", "mfu"}

    def records(eng):
        return [{k: v for k, v in r.items()
                 if k not in timing and not k.startswith("xla_")}
                for r in eng.fpm if r["kind"] in ("prefill", "decode")]

    # every other record is a program build's (the capture watch's
    # compile records, as JAX's compile watch emits)
    assert records(te) == records(je) and len(records(te)) == sum(
        r["kind"] != "compile" for r in te.fpm)
    batches = [e for e in te_events if e[0] != "cleared"]
    stored = [h for s, _, _ in batches for h in s]
    removed = [h for _, r, _ in batches for h in r]
    # the first request's five full blocks are stored under its PLHs, the
    # prefix hit stores none of them again, eviction and the clear remove
    assert stored[:5] == compute_block_hashes_for_request(
        list(range(30, 50)), 4)
    assert len(removed) > 10 and ("cleared", 10) in te_events
    assert {t for _, _, t in batches} == {"g1"}


# ---------------------------------------------------------------------------
# end to end behind the unchanged JAX frontend
# ---------------------------------------------------------------------------


def _record_streams(engine, into):
    """Wrap engine.generate to record each request's token ids."""
    inner = engine.generate

    async def generate(request, token=None):
        toks = into.setdefault(request.request_id, [])
        async for out in inner(request, token=token):
            toks.extend(out.token_ids)
            yield out

    engine.generate = generate


async def _wait(pred, what, timeout=10.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


async def _complete(session, url, model, prompt, stream):
    body = {"model": model, "prompt": prompt, "max_tokens": 6,
            "temperature": 0.0, "ignore_eos": True, "stream": stream}
    async with session.post(f"{url}/v1/completions", json=body) as r:
        assert r.status == 200, await r.text()
        if not stream:
            d = await r.json()
            return d["choices"][0]["text"], d["choices"][0]["finish_reason"]
        text, finish = [], None
        async for line in r.content:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ch = json.loads(line[len("data: "):])["choices"][0]
            text.append(ch["text"])
            finish = ch["finish_reason"] or finish
        return "".join(text), finish


async def test_jax_frontend_serves_torch_worker_like_jax_worker(tmp_path):
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.router.kv_router import make_kv_route_factory
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RouterMode
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
    from dynamo_tpu.tokens import compute_block_hashes_for_request as jax_plh

    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    je, params = _jax_and_torch_params(**COMMON)
    tok_cfg = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    jw = JaxEngineWorker(jrt, JaxEngineConfig(
        model_config=JAX_FP32, model_name="m-jax", **COMMON),
        component="jaxw", tokenizer_cfg=tok_cfg, params=je.params)
    await je.close()
    tw = TorchEngineWorker(prt, EngineConfig(
        model_config=FP32, model_name="m-torch", **COMMON),
        component="torchw", tokenizer_cfg=tok_cfg, params=params,
        device="cpu")
    manager = ModelManager()
    watcher = service = None
    try:
        await jw.start()
        await tw.start()
        streams = {}
        _record_streams(jw.engine, streams)
        _record_streams(tw.engine, streams)
        tid = tw.served.instance_id
        card = tw.card.runtime_config
        assert card["kv_cache_dtype"] == "bf16" and card["attn_impl"] == "auto"
        loads, fpms = [], []

        async def listen(subject, into):
            async for _, msg in jrt.event_plane.subscribe(subject):
                into.append(msg)

        listeners = [asyncio.create_task(listen("load_metrics.dynamo.torchw",
                                                loads)),
                     asyncio.create_task(listen("fpm.dynamo.torchw", fpms))]
        watcher = await ModelWatcher(
            jrt, manager, router_mode=RouterMode.KV,
            make_route=make_kv_route_factory(jrt)).start()
        service = await HttpService(jrt, manager, host="127.0.0.1",
                                    port=0).start()
        url = f"http://127.0.0.1:{service._runner.addresses[0][1]}"
        await _wait(lambda: manager.get("m-jax") and manager.get("m-torch"),
                    "both models")
        prompts = ["the quick brown fox", "paged attention on a GPU",
                   "the quick brown fox jumps over"]
        async with aiohttp.ClientSession() as s:
            for stream in (False, True):
                for p in prompts:
                    got = [await _complete(s, url, m, p, stream)
                           for m in ("m-jax", "m-torch")]
                    assert got[0] == got[1] and got[0][1] == "length"
        # greedy token ids, request by request: each prompt went to the
        # JAX worker, then to the torch worker
        ids = [v for k, v in streams.items() if not k.startswith("canary")]
        assert len(ids) == 12 and all(len(t) == 6 for t in ids)
        assert ids[0::2] == ids[1::2]

        # the frontend's KV indexer holds the torch worker's blocks, and
        # scores them for a prompt that shares a prefix with one served
        router = manager.get("m-torch").migration.route
        shared = [3 + b for b in "the quick brown fox jumps over".encode()]
        hashes = jax_plh(shared + [9, 9, 9, 9], 4)
        assert hashes[:7] == compute_block_hashes_for_request(shared, 4)[:7]

        def overlap():
            m = router.indexer.find_matches_tiered(
                hashes, router.targets.targets_of(tid))
            return sum(sum(c.values()) for c in m.values())

        await _wait(lambda: overlap() >= 7, "indexed torch blocks")

        # load_metrics and FPM records arrive; kv_events_replay answers
        await _wait(lambda: loads and fpms, "load_metrics and fpm")
        assert loads[-1]["worker_id"] == tid
        assert loads[-1]["kv_cache_dtype"] == "bf16"
        assert 0.0 <= loads[-1]["kv_usage"] <= 1.0
        # dispatch records and, as from a JAX worker, the program builds'
        # compile records
        kinds = {r["kind"] for m in fpms for r in m["steps"]}
        assert kinds == {"prefill", "decode", "compile"}
        rclient = await jrt.namespace("dynamo").component("torchw").endpoint(
            "kv_events_replay").client().start()
        replay = [e async for e in rclient.generate({"since_event_id": 0})]
        assert replay and all(e["worker_id"] == tid for e in replay)
        assert any(e["op"] == "stored" for e in replay)
        await rclient.close()
        for t in listeners:
            t.cancel()
        await asyncio.gather(*listeners, return_exceptions=True)
    finally:
        if service is not None:
            await service.close()
        if watcher is not None:
            await watcher.close()
        await tw.close()
        await jw.close()
        await prt.shutdown()
        await jrt.shutdown()


# ---------------------------------------------------------------------------
# a worker serving a checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epilogue", ["off", "fused"])
async def test_checkpoint_worker_publishes_the_jax_workers_mdc(
        epilogue, tmp_path, monkeypatch):
    """With a model_path the worker ships the checkpoint's tokenizer.json
    inline as the "hf" tokenizer with its first eos id, and its chat
    template: the published MDC equals the JAX worker's card for the same
    config, the effective sampling_epilogue included."""
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from test_torch_loader import write_checkpoint

    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    path = write_checkpoint(tmp_path / "tiny-ck", "qwen3")
    kw = dict(model_path=path, sampling_epilogue=epilogue, block_size=4,
              num_blocks=32, max_blocks_per_seq=8, max_num_seqs=2,
              prefill_buckets=(8, 16))
    want = JaxEngineWorker(None, JaxEngineConfig(**kw)).card.to_dict()
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    w = await TorchEngineWorker(rt, EngineConfig(**kw), device="cpu").start()
    try:
        published = await rt.discovery.get_prefix(
            w.card.key(w.served.instance_id))
        assert list(published.values()) == [want]
        with open(os.path.join(path, "tokenizer.json")) as f:
            assert want["tokenizer"] == {"type": "hf", "json": f.read(),
                                         "eos_id": 2}
        assert want["chat_template"].startswith("{% for m in messages %}")
        assert want["name"] == "tiny-ck"
        assert want["runtime_config"]["sampling_epilogue"] == epilogue
        assert w.engine.graphs.epilogue is (epilogue == "fused")
    finally:
        await w.close()
        await rt.shutdown()


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------


async def test_drain_finishes_in_flight_and_rejects_new():
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    w = await TorchEngineWorker(rt, EngineConfig(model_config=FP32, **COMMON),
                                device="cpu").start()
    addr, path = w.served.instance.address, w.served.endpoint.path
    iid = w.served.instance_id

    async def call(tokens, n):
        payload = PreprocessedRequest(
            token_ids=tokens, request_id=uuid.uuid4().hex,
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=n, ignore_eos=True)).to_dict()
        return [o async for o in rt.request_client.stream(
            addr, path, payload, instance_id=iid)]

    try:
        assert await rt.discovery.get_prefix(w.card.key(iid))
        inflight = [asyncio.create_task(call([5, 6, 7, 8, 9], 24))
                    for _ in range(2)]
        await _wait(lambda: w.engine.metrics["decode_steps"] > 0, "decode")
        drain = asyncio.create_task(w.drain(deadline_s=60.0))
        await _wait(lambda: w.engine.draining, "draining")
        rejected = await call([1, 2, 3], 4)
        assert rejected[-1]["error"] == DRAIN_REJECT
        done = await asyncio.gather(*inflight)
        assert all(o[-1]["finish_reason"] == "length"
                   and sum(len(x["token_ids"]) for x in o) == 24
                   for o in done)
        await drain
        assert not await rt.discovery.get_prefix(w.card.key(iid))
        assert not await rt.discovery.get_prefix(w.served.instance.key())

        # the deadline passes: what is still running is aborted with the
        # migratable marker, and its slot is freed
        w.engine.draining = False
        late = asyncio.create_task(call([5, 6, 7], 40))
        await _wait(lambda: w.engine.num_active_seqs, "late request")
        await w.drain(deadline_s=0.0)
        out = await late
        assert out[-1]["error"] == DRAIN_ABORT
        await _wait(lambda: w.engine.num_active_seqs == 0, "reaped slot")
    finally:
        await w.close()
        await rt.shutdown()


async def test_canary_withdraws_and_restores_the_lease():
    """The canary runs CANARY_GENERATE_PAYLOAD through the real generate
    handler; a failing engine withdraws the worker's discovery lease and
    a recovered one restores it."""
    from dynamo_tpu_torch.protocols import LLMEngineOutput
    from dynamo_tpu_torch.runtime.health_check import HealthCheckConfig

    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    rt.system_health.config = HealthCheckConfig(canary_wait_s=0.05,
                                                request_timeout_s=10.0)
    w = await TorchEngineWorker(rt, EngineConfig(model_config=FP32, **COMMON),
                                device="cpu").start()
    key = w.served.instance.key()
    healthy = w.engine.generate

    async def broken(request, token=None):
        yield LLMEngineOutput(finish_reason="error", error="wedged")

    async def listed():
        return bool(await rt.discovery.get_prefix(key))

    try:
        await _wait(lambda: w.engine.metrics["requests"] >= 1, "a canary")
        assert await listed() and rt.system_health.healthy
        w.engine.generate = broken
        await _wait(lambda: not rt.system_health.healthy, "unhealthy")
        for _ in range(200):
            if not await listed():
                break
            await asyncio.sleep(0.02)
        assert not await listed()
        w.engine.generate = healthy
        await _wait(lambda: rt.system_health.healthy, "recovered")
        for _ in range(200):
            if await listed():
                break
            await asyncio.sleep(0.02)
        assert await listed()
    finally:
        await w.close()
        await rt.shutdown()


# ---------------------------------------------------------------------------
# python -m dynamo_tpu_torch.engine
# ---------------------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, DYN_LOG_LEVEL="WARNING",
               **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def _readline(proc, timeout: float) -> str:
    """The process's next stdout line, or "" at exit or after `timeout`."""
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        return proc.stdout.readline() if sel.select(timeout) else ""
    finally:
        sel.close()


# seconds a CLI worker may take to print its ready line, and a client to
# discover it, beside the suite's six busy workers (a loaded run saw a
# ready line after ~50 s, then a client's 10 s default discovery wait
# run out)
CLI_READY_S = 120.0
DISCOVERY_S = 60.0


def _ready_line(proc, what: str = "the worker") -> str:
    """The CLI's ready line; fails naming it (with the process's stderr,
    the process killed first so the read ends) when none came within
    CLI_READY_S."""
    line = _readline(proc, timeout=CLI_READY_S)
    if not line:
        proc.kill()
        raise AssertionError(f"no ready line from {what} within "
                             f"{CLI_READY_S:.0f} s: "
                             f"{proc.stderr.read()[-4000:]}")
    return line


async def _discover(client, what: str = "dynamo/backend/generate"):
    """The client's instances, or a failure naming the endpoint that no
    instance of appeared within DISCOVERY_S."""
    try:
        return await client.wait_for_instances(DISCOVERY_S)
    except TimeoutError:
        raise AssertionError(f"no instance of {what} discovered within "
                             f"{DISCOVERY_S:.0f} s") from None


def test_engine_cli_registers_and_sigterm_deregisters(tmp_path):
    disc = tmp_path / "cluster"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.engine", "--device", "cpu",
         "--model", "tiny", "--block-size", "16", "--num-blocks", "64",
         "--max-blocks-per-seq", "8", "--max-num-seqs", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=str(disc)))
    try:
        line = _ready_line(proc)
        assert line.startswith("ready instance_id="), line
        iid = line.strip().split("=", 1)[1]
        mdc = disc / "v1" / "mdc" / "dynamo" / "tiny" / f"{iid}.json"
        card = json.loads(mdc.read_text())
        assert card["runtime_config"]["overlap_scheduling"] is True
        assert (disc / "v1" / "instances" / "dynamo" / "backend" / "generate"
                / f"{iid}.json").exists()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not mdc.exists()
        assert not list((disc / "v1" / "instances").rglob("*.json"))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_engine_cli_scheduler_flags():
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    cfg = engine_config(build_args().parse_args([]))
    assert (cfg.overlap_scheduling, cfg.decode_fuse_adaptive,
            cfg.decode_fused_steps, cfg.decode_pipeline_depth) == (
                True, True, 8, 4)
    cfg = engine_config(build_args().parse_args(
        ["--no-overlap-scheduling", "--no-adaptive-fusion"]))
    assert not cfg.overlap_scheduling and not cfg.decode_fuse_adaptive


def test_engine_cli_model_path_and_epilogue_flags():
    """--model-path and --sampling-epilogue, with the JAX CLI's names,
    defaults and choices."""
    from dynamo_tpu.engine.__main__ import build_args as jax_args
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    for argv in ([], ["--model-path", "/ck", "--sampling-epilogue",
                      "fused"]):
        args = build_args().parse_args(argv)
        jargs = jax_args().parse_args(argv)
        assert (args.model_path, args.sampling_epilogue) == (
            jargs.model_path, jargs.sampling_epilogue)
    cfg = engine_config(args)
    assert (cfg.model_path, cfg.sampling_epilogue) == ("/ck", "fused")
    with pytest.raises(SystemExit):
        build_args().parse_args(["--sampling-epilogue", "pallas"])


def test_engine_cli_without_cuda_exits_nonzero():
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.engine", "--model", "tiny"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "torch.cuda is not available" in out.stderr
    assert "ready" not in out.stdout

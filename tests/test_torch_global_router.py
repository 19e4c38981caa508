"""The port's global router against the JAX package's (CPU, host only).

* `PoolClassifier` decisions over a table of pool states (classes,
  fallbacks, the only pool, TTFT and load tie-breaks) and
  `estimate_isl` on request shapes: equal to JAX's, exactly;
* `PoolDirectory` on each package's runtime fed the same discovery
  records (frontends, agg and prefill cards, non-frontend instances,
  deletions): the same pool views after every step;
* a closed loop on the port alone: a mocker agg pool and a mocker
  disagg pool (decode + prefill workers), each behind a port frontend,
  and a tiny fp32 TorchEngine pool: short prompts route agg, long ones
  disagg, every response (status, content type, SSE events, ids and
  clocks aside) equals the same request sent to the pool's frontend
  directly; the route counts on /metrics, the 404 for an unknown model,
  the merged /v1/models, a frontend that refuses connections cooled
  down and retried, the staleness scrape;
* a classifier that raises degrades to round-robin and keeps serving;
* a frontend that joins late inherits the in-flight slot picture;
* the CLI's flags, and `python -m dynamo_tpu_torch.global_router`
  printing `ready port=N` and exiting 0 on SIGTERM.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import uuid

import aiohttp
import pytest
import torch
from test_torch_worker import CLI_READY_S, _readline
from torch_fleet import scrub, sse_events

import dynamo_tpu.global_router as jax_gr
import dynamo_tpu.global_router.__main__ as jax_cli
import dynamo_tpu.global_router.policy as jax_policy
import dynamo_tpu.protocols.model_card as jax_card
import dynamo_tpu.runtime as jax_runtime
import dynamo_tpu.runtime.discovery as jax_discovery
import dynamo_tpu_torch.global_router as port_gr
import dynamo_tpu_torch.global_router.__main__ as port_cli
import dynamo_tpu_torch.global_router.policy as port_policy
import dynamo_tpu_torch.protocols.model_card as port_card
import dynamo_tpu_torch.runtime as port_runtime
import dynamo_tpu_torch.runtime.discovery as port_discovery
from dynamo_tpu_torch.disagg.prefill_router import ConditionalDisaggConfig
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.frontend.pipeline import _route_attr
from dynamo_tpu_torch.frontend.service import (
    HttpService,
    ModelManager,
    ModelWatcher,
)
from dynamo_tpu_torch.mocker import MockEngineArgs, MockerWorker
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.router.kv_router import make_kv_route_factory
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    RouterMode,
    RuntimeConfig,
)

# the TorchEngine pool runs CPU forwards inside the event loop
pytestmark = pytest.mark.allow_slow_callbacks

SIDES = {"jax": (jax_gr, jax_policy, jax_card, jax_runtime, jax_discovery),
         "port": (port_gr, port_policy, port_card, port_runtime,
                  port_discovery)}
MODEL = "gr-model"
TINY = "gr-tiny"
WAIT_S = 30.0


# ------------------------------ classifier --------------------------------

def _pool(gr, ns, disagg=False, n_fe=1, per_tok=None, flat=None,
          inflight=0):
    p = gr.PoolView(ns)
    for i in range(n_fe):
        p.frontends[i] = gr.FrontendView(i, f"127.0.0.1:{9000 + i}", ns)
    p.models[MODEL] = {"both", "prefill"} if disagg else {"both"}
    p.ttft_per_token_ewma_s, p.ttft_ewma_s = per_tok, flat
    p.inflight = inflight
    return p


# name: ([pool kwargs], [(isl, max_tokens)], config kwargs)
CLASSIFY = {
    "both_classes": ([dict(ns="agg"), dict(ns="dis", disagg=True)],
                     [(4096, 64), (4096, 8192), (100, 256), (2048, 0),
                      (2047, 10), (5000, 2143)], {}),
    "fallbacks": ([dict(ns="a0"), dict(ns="a1", inflight=3)],
                  [(4096, 64), (100, 256)], {}),
    "disagg_only": ([dict(ns="d0", disagg=True),
                     dict(ns="d1", disagg=True, flat=0.2)],
                    [(100, 256), (4096, 64)], {}),
    "only_pool": ([dict(ns="solo")], [(4096, 64), (1, 1)], {}),
    "ttft_then_load": ([dict(ns="fast", per_tok=1e-5),
                        dict(ns="slow", per_tok=5e-5)],
                       [(1000, 512)], dict(load_penalty_s=0.010)),
    "load_flips": ([dict(ns="fast", per_tok=1e-5, inflight=8),
                    dict(ns="slow", per_tok=5e-5)],
                   [(1000, 512)], dict(load_penalty_s=0.010)),
    "per_frontend_load": ([dict(ns="wide", n_fe=4, inflight=8, flat=0.05),
                           dict(ns="narrow", inflight=3, flat=0.05)],
                          [(10, 5), (3000, 100)],
                          dict(disagg_min_isl=64, disagg_ratio=0.5)),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY))
def test_classifier_decisions_equal_jax(case):
    pools_kw, asks, cfg_kw = CLASSIFY[case]
    out = {}
    for side, (gr, *_rest) in SIDES.items():
        c = gr.PoolClassifier(gr.GlobalRouterConfig(**cfg_kw))
        pools = [_pool(gr, **kw) for kw in pools_kw]
        out[side] = [vars(c.classify(pools, isl, mt)) for isl, mt in asks]
        with pytest.raises(ValueError) as err:
            c.classify([], isl=10)
        out[side].append(str(err.value))
        out[side].append([p.to_dict() for p in pools])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("body", [
    {"prompt": [1, 2, 3, 4, 5]}, {"prompt": "x" * 400}, {"prompt": ""},
    {"messages": [{"role": "user", "content": "y" * 80},
                  {"role": "assistant", "content": [{"type": "text"}]}]},
    {}, {"messages": None}, {"prompt": "abc"}])
def test_estimate_isl_equal_jax(body):
    assert port_policy.estimate_isl(body) == jax_policy.estimate_isl(body)


# ------------------------------ directory ---------------------------------

def _records(side):
    """The discovery steps: (op, key, value) lists, one per checkpoint."""
    _, _, card, _, disc = SIDES[side]
    fe = disc.Instance(namespace="pa", component="frontend", endpoint="http",
                       instance_id=11, address="127.0.0.1:8101",
                       metadata={"http_addr": "127.0.0.1:8101"})
    fe2 = disc.Instance(namespace="pb", component="frontend",
                        endpoint="http", instance_id=12,
                        address="127.0.0.1:8102", metadata={})
    w = disc.Instance(namespace="pa", component="backend",
                      endpoint="generate", instance_id=13,
                      address="127.0.0.1:9999")
    mdc = card.ModelDeploymentCard(name=MODEL, namespace="pa",
                                   runtime_config={"role": "both"})
    pmdc = card.ModelDeploymentCard(name=MODEL, namespace="pa",
                                    component="prefill",
                                    runtime_config={"role": "prefill"})
    bmdc = card.ModelDeploymentCard(name="other", namespace="pb")
    put = lambda k, v: ("put", k, v.to_dict())  # noqa: E731
    return [
        [put(fe.key(), fe), put(mdc.key(instance_id=1), mdc)],
        [put(pmdc.key(instance_id=2), pmdc), put(w.key(), w),
         put(fe2.key(), fe2), put(bmdc.key(instance_id=3), bmdc)],
        [("delete", pmdc.key(instance_id=2), None)],
        [("delete", fe.key(), None)],
        [("delete", mdc.key(instance_id=1), None),
         ("delete", fe2.key(), None)],
        [("delete", bmdc.key(instance_id=3), None)],
    ]


def _view(d):
    return ({ns: p.to_dict() for ns, p in sorted(d.pools().items())},
            {ns: sorted(p.frontends) for ns, p in d.pools().items()},
            d.models(), [p.namespace for p in d.pools_for_model(MODEL)])


async def _directory_run(side):
    gr, _, _, runtime, _ = SIDES[side]
    rt = await runtime.DistributedRuntime(
        config=runtime.RuntimeConfig(discovery_backend="mem",
                                     event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    d = await gr.PoolDirectory(rt).start()
    views = []
    try:
        for step in _records(side):
            for op, key, val in step:
                await (rt.discovery.put(key, val) if op == "put"
                       else rt.discovery.delete(key))
            # the watch applies the step: wait until the view settles
            last, same = None, 0
            while same < 5:
                await asyncio.sleep(0.02)
                v = _view(d)
                same = same + 1 if v == last else 0
                last = v
            views.append(last)
    finally:
        await d.close()
        await rt.shutdown()
    return views


async def test_pool_directory_state_equal_jax():
    jax_views = await _directory_run("jax")
    port_views = await _directory_run("port")
    assert port_views == jax_views
    assert port_views[1][0]["pa"]["kind"] == "disagg"
    assert port_views[2][0]["pa"]["kind"] == "agg"
    assert port_views[-1][0] == {}


# ------------------------------ closed loop -------------------------------

# the global router estimates ~4 chars a token, the byte tokenizer counts
# one a char: thresholds scaled down to CPU milliseconds
GROUTER_MIN_ISL = 64
FRONTEND_MIN_ISL = 256
LONG_CHARS = 400
SHORT_CHARS = 60
SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
ENGINE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=64,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64, 128, 256),
              seed=7)


def _rt(cluster, ns):
    return DistributedRuntime(
        config=RuntimeConfig(discovery_backend="mem", event_plane="inproc",
                             namespace=ns), cluster_id=cluster)


async def start_pool(cluster, ns, *, disagg=False, frontends=1,
                     engine_kw=None, tiny=False):
    wrt = await _rt(cluster, ns).start()
    if tiny:
        cfg = EngineConfig(model_config=LlamaConfig(dtype=torch.float32,
                                                    **SHAPES),
                           model_name=TINY, **ENGINE)
        workers = [await TorchEngineWorker(
            wrt, cfg, namespace=ns,
            tokenizer_cfg={"type": "mock", "vocab_size": 256},
            device="cpu").start()]
    else:
        common = dict(model_name=MODEL, block_size=16, base_step_s=0.0005,
                      prefill_s_per_token=0.0, decode_s_per_seq=0.0)
        common.update(engine_kw or {})
        workers = [await MockerWorker(wrt, MockEngineArgs(**common),
                                      namespace=ns).start()]
        if disagg:
            workers.append(await MockerWorker(
                wrt, MockEngineArgs(role="prefill", **common),
                namespace=ns, component="prefill").start())
    pool = {"ns": ns, "cluster": cluster, "wrt": wrt, "workers": workers,
            "frontends": []}
    for _ in range(frontends):
        await add_frontend(pool)
    return pool


async def add_frontend(pool, serve=True):
    ns = pool["ns"]
    rt = await _rt(pool["cluster"], ns).start()
    manager = ModelManager()
    watcher = await ModelWatcher(
        rt, manager, router_mode=RouterMode.KV,
        make_route=make_kv_route_factory(rt),
        disagg_config=ConditionalDisaggConfig(
            min_effective_isl=FRONTEND_MIN_ISL, min_effective_ratio=0.7),
        namespaces={ns}).start()
    fe = {"rt": rt, "manager": manager, "watcher": watcher, "svc": None}
    if serve:
        fe["svc"] = await HttpService(rt, manager, host="127.0.0.1", port=0,
                                      advertise=True).start()
        fe["url"] = f"http://127.0.0.1:{fe['svc'].bound_port}"
    pool["frontends"].append(fe)
    return fe


async def stop_frontend(fe):
    if fe["svc"] is not None:
        await fe["svc"].close()
    await fe["watcher"].close()
    await fe["rt"].shutdown()


async def stop_pool(pool):
    for fe in pool["frontends"]:
        await stop_frontend(fe)
    for w in pool["workers"]:
        await w.close()
    await pool["wrt"].shutdown()


async def until(pred, what):
    loop = asyncio.get_running_loop()
    end = loop.time() + WAIT_S
    while not pred():
        assert loop.time() < end, f"{what} never came"
        await asyncio.sleep(0.02)


async def start_grouter(cluster, pools, n_pools, model=MODEL, **cfg):
    grt = await _rt(cluster, "global").start()
    grouter = await port_gr.GlobalRouterService(
        grt, host="127.0.0.1", port=0,
        config=port_gr.GlobalRouterConfig(**cfg),
        staleness_scrape_s=0.2).start()
    for pool in pools:
        for fe in pool["frontends"]:
            await until(lambda: fe["manager"].get(
                TINY if "tiny" in pool["ns"] else model), "the model")
    await until(lambda: len(grouter.directory.pools_for_model(model))
                >= n_pools, "the pools")
    return grt, grouter


async def fetch(session, url, body):
    """(status, content type, scrubbed SSE events or body) of one POST."""
    async with session.post(f"{url}/v1/completions", json=body) as r:
        text = await r.text()
        ct = r.headers.get("Content-Type", "")
    if ct.startswith("text/event-stream"):
        return r.status, ct, [(n, scrub(d)) for n, d in sse_events(text)]
    return r.status, ct, scrub(json.loads(text))


def trace(n_per_class, max_tokens=8):
    reqs = []
    for i in range(n_per_class):
        reqs.append({"model": MODEL, "prompt": "s" * SHORT_CHARS + str(i),
                     "max_tokens": max_tokens, "stream": True,
                     "seed": 100 + i})
        reqs.append({"model": MODEL, "prompt": "l" * LONG_CHARS + str(i),
                     "max_tokens": max_tokens, "stream": i % 2 == 0,
                     "seed": 200 + i})
    return reqs


def _metric(text, name, **labels):
    for line in text.splitlines():
        if line.startswith(name + "{") and all(
                f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(None, 1)[-1])
    return None


async def test_grouter_closed_loop_routes_both_classes_byte_identical():
    cluster = uuid.uuid4().hex
    agg = await start_pool(cluster, "pool0")
    dis = await start_pool(cluster, "pool1", disagg=True)
    tiny = await start_pool(cluster, "pool-tiny", tiny=True)
    grt, grouter = await start_grouter(
        cluster, [agg, dis, tiny], 2, disagg_min_isl=GROUTER_MIN_ISL,
        disagg_ratio=0.7)
    url = f"http://127.0.0.1:{grouter.port}"
    try:
        reqs = trace(3)
        async with aiohttp.ClientSession() as s:
            via = await asyncio.gather(*(fetch(s, url, b) for b in reqs))
            direct = await asyncio.gather(*(
                fetch(s, (agg if i % 2 == 0 else dis)["frontends"][0]["url"],
                      b) for i, b in enumerate(reqs)))
            # the TorchEngine pool: greedy, equal to its frontend's answer
            tb = [{"model": TINY, "prompt": "hello tiny", "max_tokens": 6,
                   "temperature": 0.0, "stream": st} for st in (True, False)]
            tvia = [await fetch(s, url, b) for b in tb]
            tdirect = [await fetch(s, tiny["frontends"][0]["url"], b)
                       for b in tb]
            async with s.post(f"{url}/v1/completions",
                              json={"model": "nope", "prompt": "x"}) as r:
                missing = r.status
            async with s.get(f"{url}/v1/models") as r:
                models = [m["id"] for m in (await r.json())["data"]]
            # the staleness scrape reads each frontend's /metrics
            await until(lambda: {"pool0", "pool1"} <= set(
                grouter._staleness), "the staleness scrape")
            async with s.get(f"{url}/metrics") as r:
                metrics = await r.text()
        assert via == direct, "the proxy changed a response"
        assert tvia == tdirect
        assert all(v[0] == 200 and v[2] for v in via + tvia)
        assert [v[1].split(";")[0] for v in via[:2]] == [
            "text/event-stream", "text/event-stream"]
        assert via[3][1].startswith("application/json")
        routed = dict(grouter._routed)
        assert routed == {("pool0", "agg"): 3, ("pool1", "disagg"): 3,
                          ("pool-tiny", "only_pool"): 2}
        assert _metric(metrics, "dynamo_grouter_routed_total",
                       pool="pool1", reason="disagg") == 3.0
        assert _metric(metrics, "dynamo_grouter_staleness_spread",
                       pool="pool0") == 0.0
        assert grouter.route_latency_quantiles()["count"] == 8
        assert missing == 404 and models == sorted([TINY, MODEL])
        assert grouter.debug_state()["pools"]["pool1"]["kind"] == "disagg"

        # a frontend that refuses connections: cooled down, the request
        # retried on the pool's other frontend; with none left, a 502
        dead = {"http_addr": "127.0.0.1:1", "instance_id": 999}
        view = grouter.directory.pools()["pool0"]
        view.frontends[999] = port_gr.FrontendView(999, dead["http_addr"],
                                                   "pool0")
        grouter._fe_inflight[agg["frontends"][0]["url"][7:]] = 5
        async with aiohttp.ClientSession() as s:
            got = await fetch(s, url, reqs[0])
        assert got == via[0] and "127.0.0.1:1" in grouter._fe_down
        assert _metric(grouter.runtime.metrics.render().decode(),
                       "dynamo_grouter_forward_errors_total",
                       pool="pool0") == 1.0
        view.frontends.clear()
        view.frontends[999] = port_gr.FrontendView(999, dead["http_addr"],
                                                   "pool0")
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{url}/v1/completions", json=reqs[0]) as r:
                assert r.status == 502
    finally:
        await grouter.close()
        await grt.shutdown()
        for p in (agg, dis, tiny):
            await stop_pool(p)


class _Broken(port_gr.PoolClassifier):
    """A classifier whose every decision raises."""

    def classify(self, pools, isl, max_tokens=0):
        raise RuntimeError("policy bug")


async def test_classifier_fault_degrades_to_round_robin():
    cluster = uuid.uuid4().hex
    p0 = await start_pool(cluster, "pool0")
    p1 = await start_pool(cluster, "pool1")
    grt, grouter = await start_grouter(cluster, [p0, p1], 2)
    url = f"http://127.0.0.1:{grouter.port}"
    body = {"model": MODEL, "prompt": "hello world", "max_tokens": 4,
            "stream": True, "seed": 5}
    try:
        async with aiohttp.ClientSession() as s:
            good = await fetch(s, url, body)
            grouter.classifier = _Broken(grouter.config)
            degraded = [await fetch(s, url, body) for _ in range(2)]
        assert good[0] == 200 and degraded == [good, good]
        routed = dict(grouter._routed)
        assert routed[("pool0", "classify_error_rr")] == 1
        assert routed[("pool1", "classify_error_rr")] == 1
        assert _metric(grt.metrics.render().decode(),
                       "dynamo_grouter_classify_errors_total") == 2.0
    finally:
        await grouter.close()
        await grt.shutdown()
        await stop_pool(p0)
        await stop_pool(p1)


async def test_late_joining_frontend_inherits_inflight_slots():
    cluster = uuid.uuid4().hex
    # slow steps keep the requests in flight while the second frontend
    # (a watcher alone) starts
    pool = await start_pool(cluster, "poolz",
                            engine_kw=dict(base_step_s=0.02))
    fe_a = pool["frontends"][0]
    try:
        await until(lambda: fe_a["manager"].get(MODEL), "the model")
        bodies = [{"model": MODEL, "prompt": "p" * 120 + str(i),
                   "max_tokens": 60, "stream": True, "seed": i}
                  for i in range(3)]
        async with aiohttp.ClientSession() as s:
            inflight = [asyncio.ensure_future(fetch(s, fe_a["url"], b))
                        for b in bodies]
            try:
                seqs_a = _route_attr(
                    fe_a["manager"].get(MODEL).migration.route, "sequences")
                await until(lambda: len(seqs_a._reqs) >= 3, "the slots")
                fe_b = await add_frontend(pool, serve=False)
                await until(lambda: fe_b["manager"].get(MODEL),
                            "the model on the late frontend")
                route_b = fe_b["manager"].get(MODEL).migration.route
                seqs_b = _route_attr(route_b, "sequences")
                await until(lambda: len([k for k in seqs_b._reqs
                                         if "@" in k]) >= 3,
                            "the in-flight slots on the late frontend")
                assert _route_attr(route_b, "sync").stats()[
                    "snapshots_applied"] >= 1
                wid = pool["workers"][0].served.instance_id
                assert seqs_b.active_blocks(wid) > 0
            finally:
                texts = await asyncio.gather(*inflight)
        assert all(t[0] == 200 and t[2] for t in texts)
        await until(lambda: not seqs_a._reqs, "the slots freed")
    finally:
        await stop_pool(pool)


def test_global_router_cli_flags_and_lifecycle(tmp_path):
    argv = ["--host", "127.0.0.1", "--port", "0", "--disagg-min-isl",
            "1024", "--disagg-ratio", "0.6", "--load-penalty-ms", "5",
            "--staleness-scrape-s", "1"]
    assert vars(port_cli.build_args().parse_args(argv)) == \
        vars(jax_cli.build_args().parse_args(argv))
    env = dict(os.environ, DYN_DISCOVERY_BACKEND="file",
               DYN_DISCOVERY_PATH=str(tmp_path / "cluster"),
               DYN_EVENT_PLANE="inproc")
    err = open(tmp_path / "stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.global_router", *argv],
        env=env, stdout=subprocess.PIPE, stderr=err, text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    try:
        line, end = "", time.monotonic() + CLI_READY_S
        while not line.startswith("ready port="):
            line = _readline(proc, max(0.0, end - time.monotonic()))
            assert line, ("no ready line from the router: "
                          + (tmp_path / "stderr.log").read_text()[-3000:])
        port = int(line.strip().split("=", 1)[1])
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok", "pools": 0}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()

"""The port's system-status server against the JAX package's (CPU).

dynamo_tpu_torch/runtime/system_status.py is a standard-library HTTP/1.1
server; dynamo_tpu/runtime/system_status.py serves the same routes with
aiohttp.  On one runtime of each (mem discovery, an ephemeral
DYN_SYSTEM_PORT, an admin token):

* every route answers with the JAX server's status code and JSON keys,
  with and without the token (/debug/* closed with no token configured:
  403; a wrong token: 401), /debug/profile's clamps, 400 and the 409 while
  a capture runs, and 503 on /health once the runtime shuts down;
* an ephemeral port is bound and advertised as every served instance's
  `system_addr`;
* the unchanged JAX fleet aggregator (dynamo_tpu/obs/fleet.py) scrapes a
  torch worker's /debug/state and /metrics as it scrapes a JAX worker's,
  both registered in one FileDiscovery directory;
* `python -m dynamo_tpu_torch.engine` with DYN_SYSTEM_PORT, an admin
  token and DYN_TRACE starts, serves the routes and dumps its trace.
"""

import asyncio
import time
import uuid

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.system_status import (
    PROFILE_MAX_S,
    PROFILE_MIN_S,
)

# the engine test below runs model work inside the async body
pytestmark = pytest.mark.allow_slow_callbacks

TOKEN = "s3cret"


async def _runtimes(**over):
    """(JAX runtime, port runtime), each with its own mem cluster, an
    ephemeral system port and the admin token."""
    kw = {**dict(discovery_backend="mem", event_plane="inproc",
                 system_port=-1, admin_token=TOKEN), **over}
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**kw),
                           cluster_id=uuid.uuid4().hex).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**kw),
                                   cluster_id=uuid.uuid4().hex).start()
    return jrt, prt


async def _get(session, rt, path, method="GET", headers=None):
    url = f"http://{rt.system_address}{path}"
    async with session.request(method, url, headers=headers or {}) as r:
        body = await r.read()
        ctype = r.headers.get("Content-Type", "")
        return r.status, ctype, body


def _keys(status, ctype, body):
    import json

    if "json" not in ctype:
        return status, None
    return status, sorted(json.loads(body))


AUTH = {"X-Dyn-Admin-Token": TOKEN}
CASES = [
    ("/health", "GET", {}),
    ("/live", "GET", {}),
    ("/debug/state", "GET", {}),
    ("/debug/state", "GET", {"X-Dyn-Admin-Token": "wrong"}),
    ("/debug/state", "GET", AUTH),
    ("/debug/state?spans=3", "GET", {"Authorization": f"Bearer {TOKEN}"}),
    ("/debug/state?spans=bogus", "GET", AUTH),
    ("/debug/requests", "GET", AUTH),
    ("/debug/requests", "GET", {}),
    ("/debug/kv", "GET", AUTH),
    ("/debug/kv", "GET", {"Authorization": "Bearer nope"}),
    ("/debug/profile?duration_s=nan", "GET", AUTH),
    ("/debug/profile?duration_s=abc", "POST", AUTH),
    ("/debug/profile", "GET", {}),
]


@pytest.mark.parametrize("path,method,headers", CASES,
                         ids=[f"{m} {p} {sorted(h)}" for p, m, h in CASES])
async def test_route_codes_and_keys_equal_jax(path, method, headers):
    jrt, prt = await _runtimes()
    try:
        async with aiohttp.ClientSession() as s:
            want = await _get(s, jrt, path, method, headers)
            got = await _get(s, prt, path, method, headers)
        assert _keys(*got) == _keys(*want)
        assert ("json" in got[1]) == ("json" in want[1])
    finally:
        await jrt.shutdown()
        await prt.shutdown()


async def test_metrics_route_serves_the_text_format():
    from prometheus_client.parser import text_string_to_metric_families

    jrt, prt = await _runtimes()
    try:
        for rt in (jrt, prt):
            rt.metrics.scoped(component="backend").set(
                "dynamo_engine_kv_usage", 0.5)
        async with aiohttp.ClientSession() as s:
            want = await _get(s, jrt, "/metrics")
            got = await _get(s, prt, "/metrics")
        assert got[0] == want[0] == 200
        assert got[1].startswith("text/plain")
        fams = [f.name for f in text_string_to_metric_families(
            got[2].decode())]
        assert fams == [f.name for f in text_string_to_metric_families(
            want[2].decode())] == ["dynamo_engine_kv_usage"]
    finally:
        await jrt.shutdown()
        await prt.shutdown()


async def test_profile_capture_keys_clamps_and_409(tmp_path, monkeypatch):
    """A capture answers status "ok" with the JAX keys (the device-memory
    snapshot needs CUDA: on the CPU the port reports why, as JAX reports a
    failed snapshot), the duration is clamped, and a second request
    while one captures gets 409 from both servers."""
    import json

    monkeypatch.setenv("DYN_PROFILE_DIR", str(tmp_path))
    jrt, prt = await _runtimes()
    try:
        async with aiohttp.ClientSession() as s:
            bodies = {}
            for name, rt in (("jax", jrt), ("torch", prt)):
                first = asyncio.create_task(_get(
                    s, rt, "/debug/profile?duration_s=0.4", "POST", AUTH))
                await asyncio.sleep(0.1)
                busy = await _get(s, rt, "/debug/profile?duration_s=0.1",
                                  headers=AUTH)
                assert busy[0] == 409, name
                st, _, body = await first
                assert st == 200
                bodies[name] = json.loads(body)
            clamped = json.loads((await _get(
                s, prt, "/debug/profile?duration_s=0", headers=AUTH))[2])
        j, t = bodies["jax"], bodies["torch"]
        assert j["status"] == t["status"] == "ok"
        memory = {"memory_profile", "memory_profile_error", "trace_file"}
        assert set(t) - memory == set(j) - memory
        assert t["backend"] == ("cuda" if torch.cuda.is_available()
                                else "cpu")
        trace = json.load(open(t["trace_file"]))
        assert trace["traceEvents"]
        assert t["trace_dir"].startswith(str(tmp_path))
        if not torch.cuda.is_available():
            assert "memory_profile_error" in t
        assert clamped["duration_s"] == PROFILE_MIN_S
        from dynamo_tpu.runtime import system_status as jax_status

        assert (PROFILE_MIN_S, PROFILE_MAX_S) == (jax_status.PROFILE_MIN_S,
                                                  jax_status.PROFILE_MAX_S)
    finally:
        await jrt.shutdown()
        await prt.shutdown()


async def test_no_token_configured_closes_the_admin_routes():
    jrt, prt = await _runtimes(admin_token="")
    try:
        async with aiohttp.ClientSession() as s:
            for path in ("/debug/state", "/debug/kv", "/debug/requests",
                         "/debug/profile"):
                got = await _get(s, prt, path, headers=AUTH)
                want = await _get(s, jrt, path, headers=AUTH)
                assert got[0] == want[0] == 403
                assert _keys(*got) == _keys(*want)
            assert (await _get(s, prt, "/live"))[0] == 200
    finally:
        await jrt.shutdown()
        await prt.shutdown()


async def test_health_is_503_once_shutting_down():
    import json

    jrt, prt = await _runtimes()
    try:
        async with aiohttp.ClientSession() as s:
            for rt in (jrt, prt):
                ok = await _get(s, rt, "/health")
                assert ok[0] == 200
                assert json.loads(ok[2])["status"] == "healthy"
                rt.root_token.kill()
                down = await _get(s, rt, "/health")
                assert down[0] == 503
                assert json.loads(down[2])["status"] == "shutting_down"
                assert (await _get(s, rt, "/live"))[0] == 200
    finally:
        await jrt.shutdown()
        await prt.shutdown()


async def test_unknown_route_and_malformed_request():
    _, prt = await _runtimes()
    try:
        async with aiohttp.ClientSession() as s:
            assert (await _get(s, prt, "/nope"))[0] == 404
            assert (await _get(s, prt, "/live", "DELETE"))[0] == 405
        host, port = prt.system_address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(b"garbage\r\n\r\n")
        await writer.drain()
        head = await reader.read(64)
        writer.close()
        assert head.startswith(b"HTTP/1.1 400 ")
    finally:
        await prt.shutdown()
    # the port is released on shutdown
    with pytest.raises(OSError):
        await asyncio.open_connection(host, int(port))


async def test_ephemeral_port_is_advertised_as_system_addr():
    from dynamo_tpu_torch.runtime.discovery import INSTANCE_PREFIX

    _, prt = await _runtimes()
    try:
        port = int(prt.system_address.rsplit(":", 1)[1])
        assert port > 0 and prt.system_address.startswith("127.0.0.1:")

        async def handler(payload, ctx):
            yield {"ok": True}

        ep = prt.namespace("ns").component("c").endpoint("e")
        served = await ep.serve_endpoint(handler)
        snap = await prt.discovery.get_prefix(INSTANCE_PREFIX)
        metas = [v["metadata"] for v in snap.values()]
        assert metas and all(m["system_addr"] == prt.system_address
                             for m in metas)
        await served.shutdown()
    finally:
        await prt.shutdown()


async def test_a_port_in_use_raises():
    _, prt = await _runtimes()
    port = int(prt.system_address.rsplit(":", 1)[1])
    try:
        rt2 = DistributedRuntime(config=RuntimeConfig(
            discovery_backend="mem", event_plane="inproc",
            system_port=port), cluster_id=uuid.uuid4().hex)
        with pytest.raises(OSError):
            await rt2.start()
        await rt2.shutdown()
    finally:
        await prt.shutdown()


# -- the JAX fleet aggregator over a torch worker ---------------------------


async def test_fleet_aggregator_scrapes_torch_worker_like_jax_worker(
        tmp_path, monkeypatch):
    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine import JaxEngine
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dynamo_tpu.obs import fleet
    from dynamo_tpu.runtime.discovery import FileDiscovery
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
    from dynamo_tpu_torch.models.convert import params_from_numpy
    from dynamo_tpu_torch.models.llama import LlamaConfig

    monkeypatch.setenv("DYN_ADMIN_TOKEN", TOKEN)
    shapes = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
                  n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
    common = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
                  max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7,
                  peak_tflops=1.0, peak_hbm_gbps=10.0)
    jcfg = JaxLlamaConfig(dtype=jnp.float32, **shapes)
    je = JaxEngine(JaxEngineConfig(model_config=jcfg, **common))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    params = params_from_numpy(tree, LlamaConfig(dtype=torch.float32,
                                                 **shapes), device="cpu")
    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq", system_port=-1, admin_token=TOKEN)
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    tok = {"type": "mock", "vocab_size": shapes["vocab_size"]}
    jw = JaxEngineWorker(jrt, JaxEngineConfig(model_config=jcfg,
                                              **common),
                         component="jaxw", tokenizer_cfg=tok,
                         params=je.params)
    await je.close()
    tw = TorchEngineWorker(prt, EngineConfig(
        model_config=LlamaConfig(dtype=torch.float32, **shapes), **common),
        component="torchw", tokenizer_cfg=tok, params=params, device="cpu")
    try:
        await jw.start()
        await tw.start()
        from dynamo_tpu_torch.protocols import PreprocessedRequest
        from dynamo_tpu_torch.protocols import StopConditions

        # some work, so the FPM window and the roofline gauges fill
        for i in range(2):
            req = PreprocessedRequest(token_ids=list(range(3, 30 + i)),
                                      request_id=f"r{i}",
                                      stop=StopConditions(max_tokens=8,
                                                          ignore_eos=True))
            async for _ in tw.engine.generate(req):
                pass
        from dynamo_tpu.protocols import PreprocessedRequest as JReq
        from dynamo_tpu.protocols import StopConditions as JStop

        for i in range(2):
            req = JReq(token_ids=list(range(3, 30 + i)), request_id=f"j{i}",
                       stop=JStop(max_tokens=8, ignore_eos=True))
            async for _ in jw.engine.generate(req):
                pass
        await asyncio.sleep(1.2)  # two load-loop ticks
        observer = FileDiscovery(str(tmp_path), read_only=True)
        snap = await fleet.snapshot(observer, token=TOKEN, timeout_s=5.0)
        views = {w.component: w for w in snap.workers}
        tv, jv = views["torchw"], views["jaxw"]
        assert tv.state == jv.state == "live", (tv.error, jv.error)
        assert tv.kind == jv.kind == "engine"
        assert tv.system_addr == prt.system_address
        assert set(tv.debug) == set(jv.debug)
        assert set(tv.metrics) == set(jv.metrics)
        assert tv.metrics["dynamo_engine_mbu:decode"] > 0.0
        assert snap.summary["workers"] == 2
    finally:
        await tw.close()
        await jw.close()
        await prt.shutdown()
        await jrt.shutdown()


# -- python -m dynamo_tpu_torch.engine with DYN_SYSTEM_PORT ----------------


def test_engine_cli_serves_the_status_routes_and_dumps_its_trace(tmp_path):
    """The CLI starts with DYN_SYSTEM_PORT set (an ephemeral port),
    advertises it as system_addr, answers /health, /live, /metrics and the
    token-gated /debug/state, and with DYN_TRACE dumps its Chrome trace at
    exit after SIGTERM."""
    import json
    import signal
    import subprocess
    import sys
    import urllib.error
    import urllib.request

    from test_torch_worker import REPO, _env, _readline

    disc = tmp_path / "cluster"
    trace = tmp_path / "trace.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.engine", "--device", "cpu",
         "--model", "tiny", "--block-size", "16", "--num-blocks", "64",
         "--max-blocks-per-seq", "8", "--max-num-seqs", "2",
         "--peak-tflops", "1", "--peak-hbm-gbps", "10"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=str(disc),
                 DYN_EVENT_PLANE="inproc", DYN_SYSTEM_PORT="-1",
                 DYN_ADMIN_TOKEN=TOKEN, DYN_TRACE="1",
                 DYN_TRACE_OUT=str(trace)))
    try:
        line = _readline(proc, timeout=90.0)
        assert line.startswith("ready instance_id="), proc.stderr.read()
        iid = line.strip().split("=", 1)[1]
        inst = json.loads((disc / "v1" / "instances" / "dynamo" / "backend"
                           / "generate" / f"{iid}.json").read_text())
        addr = inst["metadata"]["system_addr"]

        def get(path, token=None):
            req = urllib.request.Request(
                f"http://{addr}{path}",
                headers={"X-Dyn-Admin-Token": token} if token else {})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        assert get("/live")[0] == 200
        assert json.loads(get("/health")[1])["status"] == "healthy"
        assert get("/debug/state")[0] == 401
        st, body = get("/debug/state", TOKEN)
        state = json.loads(body)
        src = state["sources"][f"worker:{iid}"]
        assert st == 200 and src["kind"] == "engine"
        assert src["config"]["tracing"] is True
        assert state["flight"]["enabled"]
        for _ in range(50):  # the load loop's first tick
            st, body = get("/metrics")
            if b"dynamo_engine_active_seqs" in body:
                break
            time.sleep(0.1)
        assert st == 200 and b"dynamo_engine_kv_blocks_capacity" in body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        doc = json.loads(trace.read_text())
        kinds = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert "compile" in kinds  # warm-up's captures
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()

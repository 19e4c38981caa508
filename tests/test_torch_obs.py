"""The port's timeline tracing plane against the JAX package's (CPU).

* The copied tracer (dynamo_tpu_torch/obs): disabled helpers are no-ops
  that allocate nothing, the ring is bounded, the Chrome trace equals the
  JAX tracer's for the same spans and is monotonic per track, the span
  histogram lands on /metrics, the flight recorder dumps (rate limited),
  install_from_env reads DYN_TRACE/DYN_TRACE_OUT, and the trace-id
  context stamps log records.
* TorchEngine and JaxEngine, default schedulers, the same converted
  weights and requests: the same set of span kinds; the port's greedy
  streams are bit-identical with tracing on and off; the JAX report
  (dynamo_tpu/obs/report.py) partitions a torch trace's step wall.
* End to end: the unchanged JAX frontend mints a trace id, and a torch
  worker's `worker_request` span carries it.
"""

import asyncio
import json
import logging
import os

import aiohttp
import numpy as np
import pytest

from dynamo_tpu import obs as jax_obs
from dynamo_tpu.obs.report import report_paths
from dynamo_tpu_torch import obs
from dynamo_tpu_torch.runtime.logging import TraceIdFilter
from dynamo_tpu_torch.runtime.metrics import MetricsHierarchy
from test_torch_overlap import (
    PROMPTS,
    SAMPLING,
    _collect,
    _req,
    jax_engine,
    torch_engine,
)

pytestmark = pytest.mark.allow_slow_callbacks


@pytest.fixture(autouse=True)
def _no_tracer():
    yield
    for mod in (obs, jax_obs):
        tr = mod.tracer()
        if tr is not None:
            tr.uninstall()


def test_disabled_helpers_are_shared_no_ops():
    assert obs.tracer() is None and not obs.enabled()
    assert obs.begin() == 0.0
    s1, s2 = obs.span("sched"), obs.span("step", track="x", k=1)
    assert s1 is s2  # the one process-wide no-op: nothing allocated
    with s1:
        pass
    obs.end("sched", obs.begin())
    assert obs.flight_dump("x") is None
    # a span that began disabled never reports, even once a tracer exists
    t0 = obs.begin()
    tr = obs.Tracer().install()
    obs.end("sched", t0)
    assert not tr.spans


def test_ring_is_bounded_and_chrome_trace_equals_jax():
    spans = []
    rng = np.random.default_rng(0)
    t = 100.0
    for i in range(40):
        d = float(rng.uniform(1e-4, 1e-2))
        spans.append((("sched", "step", "device_wait")[i % 3], t, t + d,
                      ("sched:1", "loop")[i % 2],
                      {"k": i} if i % 5 == 0 else None,
                      "ab" * 16 if i % 7 == 0 else None))
        t += d / 2
    docs = []
    for mod in (jax_obs, obs):
        tr = mod.Tracer(service="w", ring=16)
        tr._t0 = 100.0
        tr._epoch_unix_ms = 0.0
        for sp in spans:
            tr.record(sp[0], sp[1], sp[2], sp[4], sp[5], sp[3])
        assert len(tr.spans) == 16  # the ring keeps the newest
        docs.append(tr.chrome_trace())
    assert docs[0] == docs[1]
    rows = [e for e in docs[1]["traceEvents"] if e["ph"] == "X"]
    for tid in {e["tid"] for e in rows}:
        ts = [e["ts"] for e in rows if e["tid"] == tid]
        assert ts == sorted(ts)
    assert obs.SPAN_KINDS == jax_obs.SPAN_KINDS
    assert obs.STEP_PHASES == jax_obs.STEP_PHASES


def test_span_histogram_lands_on_metrics():
    from prometheus_client.parser import text_string_to_metric_families

    m = MetricsHierarchy(namespace="dynamo").scoped(component="backend")
    tr = obs.Tracer().install().bind_metrics(m)
    with obs.span("kv_pull", request_id="r"):
        pass
    obs.end("sched", obs.begin(), track="t")
    fams = {f.name: f for f in text_string_to_metric_families(
        m.render().decode())}
    counts = {s.labels["kind"]: s.value
              for s in fams["dynamo_trace_span_seconds"].samples
              if s.name.endswith("_count")}
    assert counts == {"kv_pull": 1.0, "sched": 1.0}
    assert len(tr.spans) == 2


def test_flight_recorder_dumps_and_rate_limits(tmp_path):
    tr = obs.Tracer(out_path=str(tmp_path / "trace-{pid}.json")).install()
    obs.end("step", obs.begin(), track="sched:1")
    first = obs.flight_dump("drain_abort")
    assert first == str(tmp_path / f"dynflight-drain_abort-{os.getpid()}"
                                    ".json")
    assert obs.flight_dump("drain_abort") is None  # inside the cooldown
    assert obs.flight_dump("engine crash") is not None
    doc = json.load(open(first))
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] \
        == ["step"]
    assert tr.flight_dumps[0] == first
    assert tr.dump() == str(tmp_path / f"trace-{os.getpid()}.json")


def test_install_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("DYN_TRACE", raising=False)
    assert obs.install_from_env() is None
    monkeypatch.setenv("DYN_TRACE", "1")
    monkeypatch.setenv("DYN_TRACE_OUT", str(tmp_path / "t.json"))
    monkeypatch.setenv("DYN_TRACE_RING", "64")
    tr = obs.install_from_env()
    assert obs.tracer() is tr and tr.spans.maxlen == 64
    assert tr.out_path == str(tmp_path / "t.json")


def test_trace_id_context_and_annotations():
    tid = "0af7651916cd43dd8448eb211c80319c"
    ann = [f"traceparent:00-{tid}-b7ad6b7169203331-01", "other"]
    assert obs.trace_id_from_annotations(ann) \
        == jax_obs.trace_id_from_annotations(ann) == tid
    assert obs.trace_id_from_annotations(["traceparent:bad"]) is None
    rec = logging.LogRecord("x", logging.INFO, "", 0, "m", (), None)
    tok = obs.bind_trace_id(tid)
    try:
        assert TraceIdFilter().filter(rec) and rec.trace_id == tid
    finally:
        obs.unbind_trace_id(tok)
    rec2 = logging.LogRecord("x", logging.INFO, "", 0, "m", (), None)
    TraceIdFilter().filter(rec2)
    assert not hasattr(rec2, "trace_id")


# -- engines ---------------------------------------------------------------


async def _serve(eng, jax_side, tag, n=10):
    async def one(i):
        await asyncio.sleep(i * 0.05)
        return await _collect(eng, _req(jax_side, PROMPTS[i], f"{tag}{i}",
                                        n, SAMPLING[i]))

    try:
        return await asyncio.gather(*[one(i) for i in range(len(PROMPTS))])
    finally:
        await eng.close()


async def test_torch_and_jax_engines_emit_the_same_span_kinds(tmp_path):
    kinds = {}
    for name, mod, make, jax_side in (("jax", jax_obs, jax_engine, True),
                                      ("torch", obs, torch_engine, False)):
        # programs built mid-serving dump the flight recorder next to
        # the trace target
        tr = mod.Tracer(out_path=str(tmp_path / f"{name}.json")).install()
        try:
            await _serve(make(), jax_side, name)
        finally:
            tr.uninstall()
        kinds[name] = {s[0] for s in tr.spans}
    assert kinds["torch"] == kinds["jax"]
    assert {"step", "sched", "enqueue_ahead", "prefill_dispatch",
            "decode_dispatch", "device_wait", "compile"} <= kinds["torch"]
    assert kinds["torch"] <= obs.SPAN_KINDS


async def test_greedy_streams_bit_identical_with_tracing_on(tmp_path):
    off = await _serve(torch_engine(), False, "off")
    tr = obs.Tracer(out_path=str(tmp_path / "on.json")).install()
    try:
        on = await _serve(torch_engine(), False, "on")
    finally:
        tr.uninstall()
    assert on == off and tr.spans


async def test_jax_report_partitions_a_torch_trace(tmp_path):
    tr = obs.Tracer(out_path=str(tmp_path / "torch.json")).install()
    try:
        await _serve(torch_engine(), False, "rep", n=16)
    finally:
        tr.uninstall()
    path = tr.dump()
    gap = report_paths([path])["gap"]
    fr = gap["wall_fractions"]
    assert abs(sum(fr.values()) - 1.0) < 0.01
    named = sum(v for k, v in fr.items() if k != "idle")
    assert named >= 0.9
    assert {"decode_dispatch", "prefill_dispatch"} <= set(fr)


# -- end to end: a JAX frontend's trace id on a torch worker's span ---------


async def test_jax_frontend_trace_id_lands_on_torch_worker_span(
        tmp_path, monkeypatch):
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
    from dynamo_tpu_torch.models.convert import params_from_numpy
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from test_torch_overlap import COMMON, FP32, _params

    trace_file = tmp_path / "rt.jsonl"
    monkeypatch.setenv("DYN_REQUEST_TRACE", "1")
    monkeypatch.setenv("DYN_REQUEST_TRACE_FILE_PATH", str(trace_file))
    jtr = jax_obs.Tracer(out_path=str(tmp_path / "jax.json")).install()
    ptr = obs.Tracer(out_path=str(tmp_path / "torch.json")).install()
    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    worker = TorchEngineWorker(
        prt, EngineConfig(model_config=FP32, model_name="stitch", **COMMON),
        tokenizer_cfg={"type": "mock", "vocab_size": 256},
        params=params_from_numpy(_params(), FP32, device="cpu"),
        device="cpu")
    manager = ModelManager()
    watcher = service = None
    try:
        await worker.start()
        assert worker.card.runtime_config.get("tracing") is True
        watcher = await ModelWatcher(jrt, manager).start()
        service = await HttpService(jrt, manager, host="127.0.0.1",
                                    port=0).start()
        port = service._runner.addresses[0][1]
        for _ in range(250):
            if manager.get("stitch"):
                break
            await asyncio.sleep(0.02)
        async with aiohttp.ClientSession() as s:
            body = {"model": "stitch", "prompt": "hello", "max_tokens": 4,
                    "ignore_eos": True}
            async with s.post(f"http://127.0.0.1:{port}/v1/completions",
                              json=body) as r:
                assert r.status == 200, await r.text()
        rec = json.loads(trace_file.read_text().strip().splitlines()[-1])
        tid = rec["trace"]["trace_id"]
        assert tid and len(tid) == 32
        req_span = next(sp for sp in jtr.spans if sp[0] == "request")
        wrk_span = next(sp for sp in ptr.spans if sp[0] == "worker_request")
        assert req_span[5] == wrk_span[5] == tid
        assert wrk_span[4]["tokens"] == 4
    finally:
        jtr.uninstall()
        ptr.uninstall()
        if service is not None:
            await service.close()
        if watcher is not None:
            await watcher.close()
        await worker.close()
        await prt.shutdown()
        await jrt.shutdown()

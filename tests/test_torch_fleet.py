"""The port's fleet observer (obs/fleet.py) against the JAX package's (CPU).

* A port TorchEngineWorker with a status server over file discovery is
  scraped once by the port's `snapshot`; JAX's `summarize_states`,
  `export_fleet_gauges` and headline-metrics extract give on the same
  scraped `/metrics` and `/debug/state` what the port's give, and JAX's
  own `snapshot` of the same fleet classifies it alike.
* `summarize_states` on synthetic fleets (stragglers, stale and
  quarantined workers, KV ledgers, frontends' goodput, router staleness
  and tails) equals JAX's.
* A `read_only` FileDiscovery never reaps an expired lease (a
  participant does); `python -m dynamo_tpu_torch.obs.fleet --json`
  prints the live worker and reaps nothing.
* `FleetObserver.summary` goes None once its snapshot is stale, alike.
"""

import asyncio
import json
import os
import sys
import time
import uuid

import pytest
import torch

from dynamo_tpu.obs import fleet as jax_fleet
from dynamo_tpu.runtime.discovery import FileDiscovery as JaxFileDiscovery
from dynamo_tpu.runtime.metrics import MetricsHierarchy as JaxMetrics
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.obs import fleet
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, make_discovery
from dynamo_tpu_torch.runtime.metrics import MetricsHierarchy

# the worker's forwards run inside the async bodies
pytestmark = pytest.mark.allow_slow_callbacks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "fleet-token"
SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
ENGINE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32), seed=7,
              overlap_scheduling=False, decode_fused_steps=1)


def _samples(text: str) -> set:
    """A rendered registry's samples as a set of (name, labels, value)."""
    from prometheus_client.parser import text_string_to_metric_families

    return {(s.name, tuple(sorted(s.labels.items())), s.value)
            for fam in text_string_to_metric_families(text)
            for s in fam.samples}


async def _serve(worker, n: int) -> None:
    async def one(i):
        req = PreprocessedRequest(
            token_ids=[3 + i, 4, 5, 6, 7, 8], request_id=f"f-{i}",
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=8, ignore_eos=True))
        async for _ in worker.engine.generate(req):
            pass

    await asyncio.gather(*(one(i) for i in range(n)))


async def test_port_worker_scrape_reduces_like_jax(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path / "cluster")
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=root, event_plane="inproc",
        system_port=-1, admin_token=TOKEN),
        cluster_id=uuid.uuid4().hex).start()
    worker = await TorchEngineWorker(
        rt, EngineConfig(model_config=LlamaConfig(dtype=torch.float32,
                                                  **SHAPES),
                         model_name="m", **ENGINE),
        tokenizer_cfg={"type": "mock", "vocab_size": 256},
        device="cpu").start()
    port_disc = FileDiscovery(root, read_only=True)
    jax_disc = JaxFileDiscovery(root, read_only=True)
    client = fleet.HttpClient(f"http://{rt.system_address}")
    try:
        await _serve(worker, 3)
        # the worker's load loop (every 0.5 s) sets the ITL gauge
        end = time.monotonic() + 30.0
        while True:
            metrics_text = (await client.request("GET", "/metrics")) \
                .body.decode()
            if "\ndynamo_engine_itl_ema_seconds" in metrics_text:
                break
            assert time.monotonic() < end, \
                "the worker's ITL gauge never came within 30 s"
            await asyncio.sleep(0.05)
        snap = await fleet.snapshot(port_disc, token=TOKEN)
        jsnap = await jax_fleet.snapshot(jax_disc, token=TOKEN)
    finally:
        await worker.close()
        await rt.shutdown()
        torch.set_num_threads(n)
    (view,) = snap.workers
    assert view.state == "live" and view.kind == "engine", view.to_dict()
    assert view.worker_id == worker.served.instance_id
    assert view.debug["instance_id"] == view.worker_id
    # JAX's own scrape of the same fleet classifies it alike
    assert [(w.worker_id, w.state, w.kind, sorted(w.metrics))
            for w in jsnap.workers] == [(view.worker_id, "live", "engine",
                                         sorted(view.metrics))]
    # the same scraped states through both reductions
    states = [w.debug for w in snap.workers]
    kv = [w.kv_ledger for w in snap.workers if w.kv_ledger is not None]
    assert fleet.summarize_states(states, kv_states=kv) \
        == jax_fleet.summarize_states(states, kv_states=kv) == snap.summary
    assert fleet._parse_headline_metrics(metrics_text) \
        == jax_fleet._parse_headline_metrics(metrics_text)
    # the same snapshot through both exporters
    jviews = [jax_fleet.WorkerView(**{k: getattr(w, k) for k in (
        "worker_id", "kind", "namespace", "component", "endpoint",
        "address", "system_addr", "state", "debug", "metrics", "tail",
        "kv_ledger", "error")}) for w in snap.workers]
    jsnap2 = jax_fleet.FleetSnapshot(ts_unix=snap.ts_unix, workers=jviews,
                                     frontends=[], summary=snap.summary)
    pm, jm = MetricsHierarchy(), JaxMetrics()
    prev = fleet.export_fleet_gauges(pm, snap, {"gone"})
    jprev = jax_fleet.export_fleet_gauges(jm, jsnap2, {"gone"})
    assert prev == jprev == {str(view.worker_id)}
    assert _samples(pm.render().decode()) == _samples(jm.render().decode())
    assert json.dumps(snap.to_dict(), sort_keys=True, default=repr) \
        == json.dumps(jsnap2.to_dict(), sort_keys=True, default=repr)


def _w(iid, toks=0, itl=0.0, free=None, cap=100, **kw):
    s = {"instance_id": iid, "kind": "engine", "tokens_in_flight": toks,
         "itl_p95_s": itl, "active_seqs": toks // 10}
    if free is not None:
        s["kv"] = {"g1": {"free": free, "capacity": cap, "used": cap - free}}
    s.update(kw)
    return s


LEDGER = {"schema": "dynamo.kv_ledger.v1", "enabled": True,
          "violations_total": {"leak": {"g1": 2}},
          "attribution": {"g1": {"active": 5, "prefix_cached": 3}},
          "tier_state": {"g3": "open"}, "integrity": {"g3:quarantine": 1},
          "onboards_by_tier": {"g2": 4},
          "g4": {"residency": {"resident": 2}}}
FLEETS = {
    "empty": dict(states=[]),
    "balanced": dict(states=[_w(1, 100, 0.01, 50), _w(2, 100, 0.011, 60)]),
    "straggler": dict(states=[_w(1, 100, 0.01, 80), _w(2, 300, 0.01, 10),
                              _w(3, 90, 0.05, 70, draining=True)]),
    "stale_and_unreachable": dict(
        states=[_w(1, 50, 0.01, 40)], stale=1, unreachable=2,
        stale_states=[_w(2, 500, 0.2, 5)]),
    "quarantined": dict(states=[_w(1, 10, 0.01)], quarantined=1),
    "compile_hotspots": dict(states=[
        _w(1, compile={"families": {"decode": {"serving": 2},
                                    "prefill": {"serving": 0}}}),
        _w(2, compile={"families": {"decode": {"serving": 1}}})]),
    "frontends": dict(states=[_w(1, 10)], frontend_states=[
        {"slo": {"goodput": 0.9}, "router": {"m": {"staleness_ratio": 0.2}},
         "tail": {"exemplars": 3, "breaches": 1}},
        {"slo": {"goodput": 0.5}, "router": {"m": {"staleness_ratio": 0.4},
                                             "x": "junk"}},
        {"slo": "off"}]),
    "kv_ledgers": dict(states=[_w(1)], kv_states=[
        LEDGER, dict(LEDGER, enabled=False), {"schema": "other"}, "junk"]),
}


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_summarize_states_equal_jax(case):
    kw = FLEETS[case]
    assert fleet.summarize_states(**kw) == jax_fleet.summarize_states(**kw)


def _expired_lease(root: str, ttl_s: float) -> str:
    path = os.path.join(root, "v1", "instances", "dynamo", "backend",
                        "generate", "7.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"namespace": "dynamo", "component": "backend",
                   "endpoint": "generate", "instance_id": 7,
                   "address": "127.0.0.1:1", "metadata": {}}, f)
    old = time.time() - 10 * ttl_s
    os.utime(path, (old, old))
    return path


@pytest.mark.parametrize("read_only", [True, False])
async def test_read_only_file_discovery_never_reaps(read_only, tmp_path):
    root = str(tmp_path)
    path = _expired_lease(root, 1.0)
    disc = make_discovery("file", path=root, ttl_s=1.0, read_only=read_only)
    jdisc = JaxFileDiscovery(root, ttl_s=1.0, read_only=read_only)
    assert await disc.get_prefix("v1/instances") == {}
    assert os.path.exists(path) == read_only
    if read_only:
        # JAX's observer sees the same (nothing live) and reaps nothing
        assert await jdisc.get_prefix("v1/instances") == {}
        assert os.path.exists(path)


async def test_fleet_cli_lists_the_worker_and_reaps_nothing(tmp_path):
    root = str(tmp_path / "cluster")
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=root, event_plane="inproc",
        system_port=-1, admin_token=TOKEN),
        cluster_id=uuid.uuid4().hex).start()
    ep = rt.namespace("dynamo").component("backend").endpoint("generate")

    async def handler(request, context):
        yield {"ok": True}

    served = await ep.serve_endpoint(handler)
    expired = _expired_lease(root, 5.0)
    env = dict(os.environ, PYTHONPATH=REPO, DYN_DISCOVERY_BACKEND="file",
               DYN_DISCOVERY_PATH=root, DYN_ADMIN_TOKEN=TOKEN,
               DYN_LOG_LEVEL="WARNING")
    try:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.obs.fleet", "--json",
            cwd=REPO, env=env, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(proc.communicate(), 120)
    finally:
        await served.shutdown()
        await rt.shutdown()
    assert proc.returncode == 0, err.decode()[-2000:]
    snap = json.loads(out.decode().strip().splitlines()[-1])
    assert [w["worker_id"] for w in snap["workers"]] == [served.instance_id]
    assert snap["summary"]["workers"] == 1
    assert os.path.exists(expired)


class _Disc:
    async def get_prefix(self, prefix):
        return {}


@pytest.mark.parametrize("side", ["jax", "port"])
async def test_fleet_observer_summary_goes_stale(side):
    mod = jax_fleet if side == "jax" else fleet
    obs_ = mod.FleetObserver(discovery=_Disc(), interval_s=0.1,
                             timeout_s=0.1)
    assert obs_.summary() is None
    snap = await obs_.refresh()
    assert obs_.summary() == snap.summary
    assert snap.summary["workers"] == 0 and snap.summary["imbalance"] == 1.0
    snap.ts_unix -= 10.0
    assert obs_.summary() is None
    assert obs_.summary(max_age_s=60.0) == snap.summary

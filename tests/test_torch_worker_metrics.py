"""The torch worker's load loop, tier costs and routing against the JAX
package's (CPU).

* A TorchEngineWorker and a JaxEngineWorker with the same config (KVBM
  host tier, the roofline peaks), the same converted weights and the same
  requests publish load_metrics with the same keys and expose the same
  /metrics gauge families (the KV ledger, which the port has not, off on
  the JAX side); `kv_tier_costs` equals JAX's compute_tier_costs on the
  worker's own measured rates, and its degraded form under an open
  breaker equals JAX's degraded_tier_costs; the JAX KV router's selector
  prices a torch worker's G4 overlap with those costs.
* The tier-cost functions equal JAX's on the same inputs.
* The push router's round robin picks what JAX's ROUND_ROBIN picks over
  the same changing pools, and an endpoint client routes round robin or
  to the instance a caller names.
* File discovery (the class and make_discovery's) reaps an expired lease
  file as JAX's does.
"""

import asyncio
import os
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.router import tiered_index as jax_tiers
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu.runtime.discovery import FileDiscovery as JaxFileDiscovery
from dynamo_tpu.runtime.discovery import Instance as JaxInstance
from dynamo_tpu.runtime.discovery import make_discovery as jax_make_discovery
from dynamo_tpu.runtime.push_router import PushRouter as JaxPushRouter
from dynamo_tpu.runtime.push_router import RouterMode as JaxMode
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.router import tiered_index
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import (
    FileDiscovery,
    Instance,
    make_discovery,
)
from dynamo_tpu_torch.runtime.push_router import PushRouter
from test_torch_overlap import FP32, JAX_FP32, SHAPES

pytestmark = pytest.mark.allow_slow_callbacks

WCOMMON = dict(block_size=4, num_blocks=48, max_blocks_per_seq=16,
               max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7,
               host_cache_blocks=64, peak_tflops=1.0, peak_hbm_gbps=10.0)
PROMPTS = [list(range(3, 40)), list(range(50, 75)), list(range(3, 30)),
           list(range(100, 140))]


def _families(text: str) -> set:
    from prometheus_client.parser import text_string_to_metric_families

    return {f.name for f in text_string_to_metric_families(text)
            if f.name.startswith(("dynamo_engine_", "dynamo_kv",
                                  "dynamo_trace_"))
            and not f.name.endswith("_created")}


async def _workers(monkeypatch):
    """(JAX runtime, JAX worker, port runtime, port worker, loads by
    side), each on its own mem cluster with the same config and weights,
    load_metrics collected from each event plane."""
    from dynamo_tpu.engine.worker import JaxEngineWorker

    monkeypatch.setenv("DYN_KV_LEDGER", "0")
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **WCOMMON))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    kw = dict(discovery_backend="mem", event_plane="inproc")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**kw),
                           cluster_id=uuid.uuid4().hex).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**kw),
                                   cluster_id=uuid.uuid4().hex).start()
    tok = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    jw = JaxEngineWorker(jrt, JaxEngineConfig(model_config=JAX_FP32,
                                              **WCOMMON),
                         tokenizer_cfg=tok, params=je.params)
    await je.close()
    tw = TorchEngineWorker(prt, EngineConfig(model_config=FP32, **WCOMMON),
                           tokenizer_cfg=tok,
                           params=params_from_numpy(tree, FP32,
                                                    device="cpu"),
                           device="cpu")
    await jw.start()
    await tw.start()
    loads = {"jax": [], "torch": []}
    tasks = []
    for name, rt in (("jax", jrt), ("torch", prt)):
        async def listen(rt=rt, into=loads[name]):
            async for _, msg in rt.event_plane.subscribe(
                    "load_metrics.dynamo.backend"):
                into.append(msg)

        tasks.append(asyncio.create_task(listen()))
    return jrt, jw, prt, tw, loads, tasks


async def _serve(worker, jax_side):
    if jax_side:
        from dynamo_tpu.protocols import PreprocessedRequest as R
        from dynamo_tpu.protocols import StopConditions as S
    else:
        R, S = PreprocessedRequest, StopConditions
    for i, p in enumerate(PROMPTS):
        req = R(token_ids=p, request_id=f"w{i}",
                stop=S(max_tokens=6, ignore_eos=True))
        async for _ in worker.engine.generate(req):
            pass


async def _close(jrt, jw, prt, tw, tasks):
    for t in tasks:
        t.cancel()
    await tw.close()
    await jw.close()
    await prt.shutdown()
    await jrt.shutdown()


async def test_load_metrics_keys_and_gauges_equal_jax(monkeypatch):
    jrt, jw, prt, tw, loads, tasks = await _workers(monkeypatch)
    try:
        await _serve(jw, True)
        await _serve(tw, False)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10.0 and not all(
                any("kv_tier_costs" in m for m in v)
                for v in loads.values()):
            await asyncio.sleep(0.1)
        last = {k: next(m for m in reversed(v) if "kv_tier_costs" in m)
                for k, v in loads.items()}
        assert set(last["torch"]) == set(last["jax"])
        assert set(last["torch"]["kv_tier_costs"]) == {"g1", "g2", "g3",
                                                      "g4"}
        jfam = _families(jrt.metrics.render().decode())
        tfam = _families(prt.metrics.render().decode())
        assert tfam == jfam
        assert {"dynamo_engine_mfu", "dynamo_engine_mbu",
                "dynamo_engine_compile_seconds", "dynamo_kvbm_tier_state",
                "dynamo_engine_active_seqs", "dynamo_engine_waiting_seqs",
                "dynamo_engine_kv_usage",
                "dynamo_engine_itl_ema_seconds"} <= tfam
        # the costs are JAX's formula on the worker's own measured rates
        fw = tw._fpm_window
        flops_rate, _ = fw._phase_rates("prefill")
        want = jax_tiers.compute_tier_costs(
            prefill_flops_per_s=flops_rate,
            flops_per_token=flops_rate / fw.prefill_tokens_per_s(),
            bytes_per_block=tw.engine.kv_block_bytes(),
            block_tokens=WCOMMON["block_size"])
        assert tw.tier_costs == want
        # (at this width a CPU recompute is slow, so the cheap tiers
        # round to 0 at the formula's 4 decimals)
        assert 0.0 == want["g1"] <= want["g2"] <= want["g3"] < want["g4"]
        assert tw.engine.kv_block_bytes() == jw.engine.kv_block_bytes()

        # an open breaker prices its tier at recompute, as JAX does
        br = tw.engine.kvbm.breaker
        for _ in range(tw.config.kv_breaker_threshold):
            br.record_failure("g4")
        assert tw.engine.kvbm.tier_states()["g4"] == "open"
        n = len(loads["torch"])
        t0 = time.monotonic()
        while len(loads["torch"]) < n + 2 and time.monotonic() - t0 < 5:
            await asyncio.sleep(0.05)
        got = loads["torch"][-1]["kv_tier_costs"]
        assert got == jax_tiers.degraded_tier_costs(
            tw.tier_costs, tw.engine.kvbm.tier_states())
        assert got["g4"] == 1.0 and got["g2"] == tw.tier_costs["g2"]
        assert 'tier="g4"} 2.0' in prt.metrics.render().decode()

        # the JAX KV router's selector prices the torch worker's overlap
        from dynamo_tpu.router.selector import (
            DefaultWorkerSelector,
            KvRouterConfig,
            WorkerState,
        )

        sel = DefaultWorkerSelector(KvRouterConfig(seed=0))
        states = {1: WorkerState(tier_costs=dict(tw.tier_costs)),
                  2: WorkerState(tier_costs=dict(got))}
        choice, logits = sel.select_verbose(
            [1, 2], 10, {}, states,
            tier_overlaps={1: {"g4": 8}, 2: {"g4": 8}})
        assert logits[1] == pytest.approx(2 + 8 * tw.tier_costs["g4"])
        assert logits[2] == pytest.approx(2 + 8 * 1.0)
        assert choice == 1
    finally:
        await _close(jrt, jw, prt, tw, tasks)


@pytest.mark.parametrize("case", [
    (1e12, 1e9, 1e6, 128, None),
    (5e11, 2e8, 65536, 16, {"g2": 2e10}),
    (0.0, 1e9, 1e6, 128, None),
    (1e12, 0.0, 1e6, 128, None),
    (3e9, 1e7, 2e5, 4, {"g3": 0, "g4": 1e9}),
])
def test_tier_cost_functions_equal_jax(case):
    rate, per_tok, bpb, bt, bw = case
    want = jax_tiers.compute_tier_costs(rate, per_tok, bpb, bt, bw)
    got = tiered_index.compute_tier_costs(rate, per_tok, bpb, bt, bw)
    assert got == want
    for states in (None, {"g2": "closed"}, {"g2": "open"},
                   {"g3": "half_open", "g4": "open"}):
        assert tiered_index.degraded_tier_costs(got, states) \
            == jax_tiers.degraded_tier_costs(want, states)
    assert tiered_index.DEFAULT_TIER_COSTS == jax_tiers.DEFAULT_TIER_COSTS
    assert tiered_index.DEFAULT_TIER_BW == jax_tiers.DEFAULT_TIER_BW


def _instances(cls, n):
    return [cls(namespace="ns", component="c", endpoint="e",
                instance_id=1000 + 7 * i, address=f"127.0.0.1:{9000 + i}")
            for i in range(n)]


# pool sizes step by step: fixed pools, growing, shrinking, churning
POOLS = {"one": [1] * 12, "three": [3] * 12, "grow": [1, 2, 3, 4, 5] * 3,
         "shrink": [5, 4, 3, 2, 1] * 3, "churn": [2, 5, 3, 1, 4] * 4,
         "rand": [int(n) for n in
                  np.random.default_rng(11).integers(1, 6, 40)]}


@pytest.mark.parametrize("pools", sorted(POOLS))
def test_push_router_round_robin_picks_as_jax(pools):
    picks = []
    for router, inst_cls in ((JaxPushRouter(JaxMode.ROUND_ROBIN),
                              JaxInstance), (PushRouter(), Instance)):
        insts = _instances(inst_cls, 5)[::-1]  # picks go by instance id
        picks.append([router.pick(insts[:n]).instance_id
                      for n in POOLS[pools]])
    assert picks[0] == picks[1]
    with pytest.raises(RuntimeError):
        PushRouter().pick([])


@pytest.mark.parametrize("named", [False, True])
async def test_client_routes_round_robin_or_to_a_named_instance(named):
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    try:
        served = []
        for name in ("a", "b"):
            async def handler(payload, ctx, name=name):
                yield {"from": name}

            served.append(await rt.namespace("ns").component("c").endpoint(
                "e").serve_endpoint(handler))
        by_id = dict(zip((s.instance_id for s in served), ("a", "b")))
        client = await rt.namespace("ns").component("c").endpoint(
            "e").client().start()
        await client.wait_for_instances()
        while len(client.instances) < 2:
            await asyncio.sleep(0.01)
        target = max(by_id) if named else None
        got = [[x async for x in client.generate({}, instance_id=target)]
               for _ in range(4)]
        if named:
            assert got == [[{"from": by_id[target]}]] * 4
        else:
            order = [by_id[i] for i in sorted(by_id)]
            assert got == [[{"from": n}] for n in order * 2]
        with pytest.raises(RuntimeError, match="not found"):
            [x async for x in client.generate({}, instance_id=1)]
        await client.close()
        for s in served:
            await s.shutdown()
    finally:
        await rt.shutdown()


@pytest.mark.parametrize("via", ["class", "make_discovery"])
async def test_file_discovery_reaps_an_expired_lease_as_jax(tmp_path, via):
    seen = []
    for root, cls, make in (
            (tmp_path / "jax", JaxFileDiscovery,
             jax_make_discovery), (tmp_path / "torch", FileDiscovery,
                                   make_discovery)):
        owner = cls(str(root), ttl_s=0.2)
        await owner.put("v1/instances/ns/c/e/1", {"x": 1})
        await owner.put("v1/instances/ns/c/e/2", {"x": 2})
        stale = root / "v1" / "instances" / "ns" / "c" / "e" / "1.json"
        old = time.time() - 60
        os.utime(stale, (old, old))
        reader = (cls(str(root), ttl_s=0.2) if via == "class" else
                  make("file", path=str(root), ttl_s=0.2))
        seen.append((await reader.get_prefix("v1/instances"),
                     stale.exists(),
                     sorted(p.name for p in root.rglob("*.json"))))
        await owner.close()
    assert seen[0] == seen[1]
    assert seen[1] == ({"v1/instances/ns/c/e/2": {"x": 2}}, False,
                       ["2.json"])

"""Tensor- and data-parallel TorchEngines, one process per rank (CPU,
fp32, the tiny preset's widths: nh 8 over nkv 4, 2 layers).

Each test spawns its ranks (parallel/multihost.py launch_ranks, gloo on
the CPU) and bounds them: the suite's runner gives every async test
120 s, and the engines' mesh_timeout_s (30 s) bounds every join and
collective, so a rank that never joins or hangs fails its test by name.

* The greedy stream of JAX's tests/test_engine.py
  test_tensor_parallel_invariance (prompt 60..74, 5 tokens) from a tp=2
  TorchEngine equals JAX's engine(tp=2) and the port's tp=1 engine on
  the same weights, and so do concurrent streams; also on an int8 KV
  cache, and for dp=2, tp=2 (four ranks).  Every rank replays the
  stream and reports its kernel launch counts at close, and no rank
  process outlives close.
* A tp=2 TorchEngineWorker, warmed up through the step stream, serves
  over the port's runtime: its MDC's tp/dp equal the JAX worker's for
  the same config, its stream equals tp=1's, a disaggregated hop is
  parked and its blocks gather into the logical payload, and a guided
  request and an embed call are served as tp=1's worker serves them.
* A follower killed mid-service makes the leader's streams fail within
  the mesh timeout, and close still leaves no rank behind.
"""

import asyncio
import dataclasses
import multiprocessing as mp
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.worker import TorchEngineWorker
from dynamo_tpu_torch.models import PRESETS
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

pytestmark = pytest.mark.allow_slow_callbacks

# the tiny preset's widths, 2 of its 4 layers: each test then takes
# ~20 s alone, well inside the runner's 120 s beside the suite's workers
JAX_TINY = dataclasses.replace(JAX_PRESETS["tiny"], dtype=jnp.float32,
                               n_layers=2)
TINY = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32, n_layers=2)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
PROMPT = list(range(60, 75))  # JAX's test_tensor_parallel_invariance
PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8], list(range(30, 50))]
MESH_TIMEOUT_S = 30.0


def _req(jax_side, tokens, rid, n, **sampling):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0, **sampling),
             stop=T(max_tokens=n, ignore_eos=True))


async def _collect(eng, req):
    toks, last = [], None
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
        last = out
    return toks, last


async def _streams(eng, jax_side=False):
    """PROMPT alone, then PROMPTS at once: the greedy token lists."""
    one = (await _collect(eng, _req(jax_side, PROMPT, "p", 5)))[0]
    many = await asyncio.gather(*[
        _collect(eng, _req(jax_side, p, f"c{i}", 6))
        for i, p in enumerate(PROMPTS)])
    return [one] + [t for t, _ in many]


def _ranks_left() -> list:
    return [p for p in mp.active_children() if p.name.startswith(
        "dynamo-rank")]


@pytest.mark.parametrize("mesh_kw,kv", [
    (dict(tp=2), "bf16"), (dict(tp=2), "int8"), (dict(dp=2, tp=2), "bf16"),
], ids=["tp2", "tp2-int8", "dp2-tp2"])
async def test_tp_engine_streams_equal_jax_and_tp1(mesh_kw, kv):
    kw = {**COMMON, "kv_cache_dtype": kv}
    je = JaxEngine(JaxEngineConfig(model_config=JAX_TINY, **mesh_kw, **kw))
    try:
        want = await _streams(je, jax_side=True)
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      je.params)
    finally:
        await je.close()
    t1 = TorchEngine(EngineConfig(model_config=TINY, **kw),
                     params=params_from_numpy(tree, TINY, "cpu"),
                     device="cpu")
    try:
        one = await _streams(t1)
    finally:
        await t1.close()
    world = mesh_kw.get("dp", 1) * mesh_kw["tp"]
    te = TorchEngine(EngineConfig(model_config=TINY, **mesh_kw, **kw),
                     params=tree, device="cpu",
                     mesh_timeout_s=MESH_TIMEOUT_S)
    try:
        assert te.mesh.backend == "gloo" and te.mesh.world == world
        assert te.kv[0].shape[1] == TINY.n_kv_heads // mesh_kw["tp"]
        got = await _streams(te)
    finally:
        await te.close()
    assert got == want == one
    assert all(len(t) in (5, 6) for t in got)
    # every rank replayed the stream and reported at stop
    assert sorted(te.rank_launches) == list(range(1, world))
    assert not _ranks_left()


async def test_tp_worker_serves_and_refuses_what_a_mesh_does_not():
    from dynamo_tpu.engine.worker import JaxEngineWorker

    kw = dict(model_config=TINY, **COMMON)
    jkw = dict(model_config=JAX_TINY, **COMMON)
    want_card = JaxEngineWorker(None, JaxEngineConfig(tp=2, **jkw)) \
        .card.to_dict()["runtime_config"]
    tree = {"params": None}
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    w1 = await TorchEngineWorker(rt, EngineConfig(**kw), device="cpu",
                                 component="tp1").start()
    try:
        one = await _streams(w1.engine)
        one_guided = (await _collect(w1.engine, _req(
            False, PROMPT, "g", 8, guided_json={"type": "object"})))[0]
        one_embed = await w1.engine.embed([1, 2, 3])
        params = w1.engine.params
        tree["params"] = {
            "embedding": params["embedding"].numpy(),
            "final_norm": {"norm": params["final_norm"]["norm"].numpy()},
            "lm_head": params["lm_head"].numpy(),
            "layers": [{k: ({"norm": v["norm"].numpy()}
                            if isinstance(v, dict) else v.numpy())
                        for k, v in layer.items()}
                       for layer in params["layers"]]}
    finally:
        await w1.close()
    # warm-up's dispatches, snapshot and restore go through the stream
    w = await TorchEngineWorker(rt, EngineConfig(tp=2, warmup=True, **kw),
                                device="cpu", params=tree["params"],
                                component="tp2").start()
    try:
        card = w.card.to_dict()["runtime_config"]
        assert (card["tp"], card["dp"]) == (want_card["tp"],
                                            want_card["dp"]) == (2, 1)
        published = await rt.discovery.get_prefix(
            w.card.key(w.served.instance_id))
        assert [c["runtime_config"]["tp"] for c in published.values()] == [2]
        assert w.engine.kv_wire_layout().kv_heads == TINY.n_kv_heads
        assert await _streams(w.engine) == one
        # guided decoding: the top-M steps ride the stream
        guided = _req(False, PROMPT, "g", 8,
                      guided_json={"type": "object"})
        toks, last = await _collect(w.engine, guided)
        assert last.finish_reason == "stop", last.error
        assert toks == one_guided
        # a disaggregated hop is served: parked, one frame back, and its
        # blocks gathered from both ranks into the logical payload
        hop = _req(False, PROMPT, "d", 3)
        hop.annotations = [DISAGG_ANNOTATION]
        toks, last = await _collect(w.engine, hop)
        assert last.finish_reason == "stop" and toks == one[0][:1]
        assert last.kv_transfer_params["prompt_len"] == len(PROMPT)
        nb = -(-len(PROMPT) // COMMON["block_size"])
        arrs = await w.engine.extract_parked_chunk("d", 0, nb)
        assert [a.shape[3] for a in arrs] == [TINY.n_kv_heads] * 2
        await w.engine.release_parked("d")
        # embed: every rank runs the forward, the leader reads the vector
        assert w.engine.supports_embedding
        np.testing.assert_allclose(await w.engine.embed([1, 2, 3]),
                                   one_embed, atol=1e-5, rtol=0)
        # the mesh still serves after the guided and embed steps
        assert (await _collect(w.engine, _req(False, PROMPT, "p2", 5)))[0] \
            == one[0]
    finally:
        await w.close()
        await rt.shutdown()
    assert sorted(w.engine.rank_launches) == [1]
    assert not _ranks_left()


async def test_killed_follower_fails_the_leader_within_the_timeout():
    te = TorchEngine(EngineConfig(model_config=TINY, tp=2, **COMMON),
                     device="cpu", mesh_timeout_s=MESH_TIMEOUT_S)
    try:
        toks, last = await _collect(te, _req(False, PROMPT, "a", 4))
        assert len(toks) == 4 and last.finish_reason == "length"
        te._ranks.procs[0].kill()
        te._ranks.procs[0].join(10)
        t0 = time.monotonic()
        toks, last = await _collect(te, _req(False, PROMPT, "b", 4))
        assert last.finish_reason == "error"
        assert time.monotonic() - t0 < MESH_TIMEOUT_S
    finally:
        await te.close()
    assert not _ranks_left()

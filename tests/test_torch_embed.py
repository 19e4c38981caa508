"""The port's pooled text embedding against the JAX package's (CPU).

* models/llama.py embed_text equals JAX's embed_text within 1e-5 on
  fp32 `tiny` and `tiny-moe` (dense and capacity dispatch), at several
  lengths inside one bucket; a bf16 run keeps the residual stream in
  bf16 and stays within cosine 0.999 of fp32.
* TorchEngine.embed equals JaxEngine.embed on the same converted
  weights (bucketing, the "embedding max is N" error), and its first
  call at each bucket is one capture-watch "embed" record carrying the
  cost count; the count equals FlopCounterMode's over the same call.
* The MLA family has no embed_text in either package, so neither its
  engine nor its worker serves `embed`.
* Embeds sent between the overlapped scheduler's decode bursts leave
  the greedy streams as they are without them.
* The unchanged JAX frontend's /v1/embeddings on a TorchEngineWorker
  equals the same route on a JaxEngineWorker with the same weights,
  within 1e-5.
* chip_smoke.py's embed phase at a tiny width on the CPU.
"""

import asyncio
import dataclasses
import time
import uuid

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_rehearsal
import chip_smoke
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import deepseek as jax_deepseek
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, TorchEngineWorker
from dynamo_tpu_torch.models import deepseek
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.obs.costs import embed_terms, program_costs
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

# engine tests run model work inside the async bodies
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)


def _configs(preset: str, dispatch: str = "dense"):
    jc = dataclasses.replace(jl.PRESETS[preset], dtype=jnp.float32)
    tc = dataclasses.replace(llama.PRESETS[preset], dtype=torch.float32)
    if jc.n_experts:
        jc = dataclasses.replace(jc, moe_dispatch=dispatch)
        tc = dataclasses.replace(tc, moe_dispatch=dispatch)
    return jc, tc


def _both_params(jc, tc, seed=3):
    jp = jl.init_params(jc, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_numpy(tree, tc, device="cpu")


@pytest.mark.parametrize("n", [1, 13, 32])
@pytest.mark.parametrize("preset,dispatch", [("tiny", "dense"),
                                             ("tiny-moe", "dense"),
                                             ("tiny-moe", "capacity")])
def test_embed_text_matches_jax(preset, dispatch, n):
    jc, tc = _configs(preset, dispatch)
    jp, tp = _both_params(jc, tc)
    toks = np.zeros(32, np.int32)
    toks[:n] = np.random.default_rng(n).integers(0, jc.vocab_size, n)
    want = np.asarray(jl.embed_text(jp, jc, jnp.asarray(toks), jnp.int32(n)))
    got = llama.embed_text(tp, tc, torch.from_numpy(toks), n)
    assert got.dtype == torch.float32 and got.shape == (jc.d_model,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert abs(float(got.norm()) - 1.0) < 1e-5
    # the padding past n changes nothing
    toks[n:] = 7
    again = llama.embed_text(tp, tc, torch.from_numpy(toks), n)
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)


def test_bf16_embed_keeps_the_residual_stream_bf16(monkeypatch):
    cfg = llama.PRESETS["tiny"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (32,),
                         generator=torch.Generator().manual_seed(1))
    seen = []
    ffn = llama._ffn

    def spy(layer, c, h, valid=None):
        seen.append(h.dtype)
        return ffn(layer, c, h, valid=valid)

    monkeypatch.setattr(llama, "_ffn", spy)
    vec = llama.embed_text(params, cfg, toks.int(), 29)
    assert seen and set(seen) == {torch.bfloat16}
    p32 = {"embedding": params["embedding"].float(),
           "final_norm": params["final_norm"],
           "layers": [{k: ({kk: vv.float() for kk, vv in v.items()}
                           if isinstance(v, dict) else v.float())
                       for k, v in layer.items()}
                      for layer in params["layers"]]}
    ref = llama.embed_text(p32, dataclasses.replace(cfg, dtype=torch.float32),
                           toks.int(), 29)
    assert float(torch.dot(vec, ref)) >= 0.999


def _engines(**kw):
    from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig

    je = JaxEngine(JaxEngineConfig(
        model_config=JaxLlamaConfig(dtype=jnp.float32, **SHAPES), **COMMON,
        **kw))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    cfg = llama.LlamaConfig(dtype=torch.float32, **SHAPES)
    te = TorchEngine(EngineConfig(model_config=cfg, **COMMON, **kw),
                     params=params_from_numpy(tree, cfg, device="cpu"),
                     device="cpu")
    return je, te


async def test_engine_embed_matches_jax_engine_and_is_watched():
    je, te = _engines()
    try:
        assert te.supports_embedding and je.supports_embedding
        rng = np.random.default_rng(0)
        for n in (3, 8, 9, 40, 64):
            toks = rng.integers(0, 256, n).tolist()
            want, got = await je.embed(toks), await te.embed(toks)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        for eng in (je, te):
            with pytest.raises(ValueError) as e:
                await eng.embed([1] * 65)
            assert str(e.value) == ("input is 65 tokens; embedding max "
                                    "is 64")
        recs = [r for r in te.fpm if r.get("kind") == "compile"
                and r["family"] == "embed"]
        # buckets 8, 16, 64: one record each, the first call's
        assert sorted(r["tokens"] for r in recs) == [8, 16, 64]
        for r in recs:
            want = program_costs(te.model_cfg, "embed", r["tokens"],
                                 max_blocks=16, block_size=4)
            assert (r["flops"], r["bytes"]) == (want["flops"], want["bytes"])
            assert r["serving"] is False
    finally:
        await je.close()
        await te.close()


@pytest.mark.parametrize("preset,dispatch", [("tiny", "dense"),
                                             ("tiny-moe", "dense"),
                                             ("tiny-moe", "capacity")])
def test_embed_cost_count_equals_flop_counter(preset, dispatch):
    _, tc = _configs(preset, dispatch)
    params = llama.init_params(tc, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    T = 32
    with FlopCounterMode(display=False) as fc:
        llama.embed_text(params, tc, torch.zeros(T, dtype=torch.int32), 20)
    t = embed_terms(tc, T)
    assert t["attn_flops"] == \
        2 * 2 * T * T * tc.n_heads * tc.head_dim * tc.n_layers
    counted = fc.get_total_flops()
    assert abs(t["matmul_flops"] + t["attn_flops"] - counted) \
        <= 0.01 * counted
    assert t["kv_read_bytes"] == t["kv_write_bytes"] == 0
    assert t["out_bytes"] == 4 * tc.d_model


async def test_mla_family_serves_no_embed():
    assert not hasattr(jax_deepseek, "embed_text")
    assert not hasattr(deepseek, "embed_text")
    rt = await DistributedRuntime(config=RuntimeConfig(
        event_plane="inproc"), cluster_id=uuid.uuid4().hex).start()
    worker = TorchEngineWorker(rt, EngineConfig(
        model="tiny-mla", block_size=16, num_blocks=64, max_blocks_per_seq=8,
        max_num_seqs=2, prefill_buckets=(16, 32), warmup=False),
        device="cpu")
    try:
        await worker.start()
        assert not worker.engine.supports_embedding
        with pytest.raises(RuntimeError, match="has no embed_text"):
            await worker.engine.embed([1, 2, 3])
        keys = await rt.discovery.get_prefix("v1/instances/")
        eps = {k.split("/")[4] for k in keys}
        assert "generate" in eps and "embed" not in eps
    finally:
        await worker.close()
        await rt.shutdown()


async def test_embeds_between_decode_bursts_leave_streams_unchanged():
    cfg = llama.LlamaConfig(dtype=torch.float32, **SHAPES)
    rng = np.random.default_rng(4)
    reqs = [PreprocessedRequest(
        token_ids=rng.integers(0, 256, n).tolist(), request_id=f"r{n}",
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=24, ignore_eos=True))
        for n in (5, 19, 33)]

    async def run(with_embeds: bool):
        eng = TorchEngine(EngineConfig(model_config=cfg, **COMMON),
                          device="cpu")
        try:
            async def one(r):
                return [t async for out in eng.generate(r)
                        for t in out.token_ids]

            async def embeds():
                vecs = []
                for i in range(12):
                    vecs.append(await eng.embed([i + 1] * (3 + i)))
                    await asyncio.sleep(0)
                return vecs

            jobs = [one(r) for r in reqs]
            if with_embeds:
                jobs.append(embeds())
            out = await asyncio.gather(*jobs)
            return out[:len(reqs)], (out[-1] if with_embeds else None)
        finally:
            await eng.close()

    plain, _ = await run(False)
    busy, vecs = await run(True)
    assert busy == plain and all(len(s) == 24 for s in plain)
    assert len(vecs) == 12 and all(abs(np.linalg.norm(v) - 1) < 1e-5
                                   for v in vecs)


async def test_jax_frontend_embeddings_from_torch_worker_equal_jax_worker(
        tmp_path):
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    je, te = _engines()
    await te.close()
    tok_cfg = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    jw = JaxEngineWorker(jrt, JaxEngineConfig(
        model_config=JaxLlamaConfig(dtype=jnp.float32, **SHAPES),
        model_name="e-jax", **COMMON), component="jaxw",
        tokenizer_cfg=tok_cfg, params=je.params)
    await je.close()
    tw = TorchEngineWorker(prt, EngineConfig(
        model_config=te.model_cfg, model_name="e-torch", **COMMON),
        component="torchw", tokenizer_cfg=tok_cfg, params=te.params,
        device="cpu")
    manager = ModelManager()
    watcher = service = None
    try:
        await jw.start()
        await tw.start()
        watcher = await ModelWatcher(jrt, manager).start()
        service = await HttpService(jrt, manager, host="127.0.0.1",
                                    port=0).start()
        url = f"http://127.0.0.1:{service._runner.addresses[0][1]}"
        for _ in range(500):
            if manager.get("e-jax") and manager.get("e-torch"):
                break
            await asyncio.sleep(0.02)
        inputs = ["pooled text embeddings", "a", [5, 9, 13, 200]]
        got = {}
        async with aiohttp.ClientSession() as s:
            for model in ("e-jax", "e-torch"):
                async with s.post(f"{url}/v1/embeddings", json={
                        "model": model, "input": inputs}) as r:
                    assert r.status == 200, await r.text()
                    got[model] = await r.json()
            async with s.post(f"{url}/v1/embeddings", json={
                    "model": "e-torch", "input": [[1] * 65]}) as r:
                assert r.status == 400
                assert "embedding max is 64" in await r.text()
        a, b = got["e-jax"], got["e-torch"]
        assert a["usage"] == b["usage"]
        assert [d["index"] for d in b["data"]] == [0, 1, 2]
        for x, y in zip(a["data"], b["data"]):
            assert len(y["embedding"]) == SHAPES["d_model"]
            np.testing.assert_allclose(y["embedding"], x["embedding"],
                                       atol=1e-5, rtol=0)
    finally:
        if service is not None:
            await service.close()
        if watcher is not None:
            await watcher.close()
        await tw.close()
        await jw.close()
        await prt.shutdown()
        await jrt.shutdown()


def test_chip_smoke_embed_phase_at_tiny_width(monkeypatch):
    cfg = chip_rehearsal.rehearse(monkeypatch)
    cpu = torch.device("cpu")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), cpu)

    async def run():
        async with chip_smoke._serving_worker(
                cpu, chip_smoke._engine_config("bf16"), params) as (
                rt, worker, _, _):
            return await chip_smoke._embed_phase(
                rt, worker, chip_smoke._requests(cfg.vocab_size))

    t0 = time.perf_counter()
    out = asyncio.run(run())
    assert time.perf_counter() - t0 < 120
    rows = out["rows"]
    assert sorted(rows) == list(chip_smoke.EMBED_LENGTHS)
    assert all(r["dim"] == cfg.d_model and r["cosine"] >= 0.999
               for r in rows.values())
    assert rows[chip_smoke.EMBED_FAULT_LEN]["fault_cosine"] < 0.999
    assert set(out["launches"].values()) == {0}

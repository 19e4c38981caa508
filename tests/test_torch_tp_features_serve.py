"""LoRA, the fused sampling epilogue, the MoE and MLA families with the
features, guided decoding and `embed` served by tensor-parallel engines
and a worker, one process per rank (CPU, fp32).

* LoRA at tp = 2: a mixed batch (base, two adapters at once) streams
  what JAX's engine at tp = 2 and the port's tp = 1 engine stream; then
  an adapter of two targets (q, v) loads into the slot a four-target
  adapter held, and its stream equals tp = 1's and a fresh engine's
  with that adapter in a clean slot (every rank cleared the slot: the
  lora_write step).
* The fused epilogue at tp = 2 (each rank streams its vocab slice, one
  gather of statistics a step): greedy streams equal the off path's at
  tp = 2, JAX's engine at tp = 2 with the epilogue and the port's tp = 1
  engine with it; seeded sampled streams equal JAX's and tp = 1's.
* The MoE family (dense dispatch) with the fused epilogue and n-gram
  speculation, and the MLA family with both asked (each falls back, as
  JAX's engine does: no hidden-state decode, no packed verify), at
  tp = 2: streams equal JAX's engine at tp = 2 and tp = 1's.
* A tp = 2 TorchEngineWorker and a tp = 2 JaxEngineWorker behind the
  JAX frontend: a response_format json_schema chat and /v1/embeddings
  answer alike (the guided text equal, the vectors within 1e-5).
"""

import asyncio
import json
import multiprocessing as mp
import os

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import deepseek as jd
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.worker import TorchEngineWorker
from dynamo_tpu_torch.guided import JsonSchemaGuide
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from test_lora import write_peft_adapter
from test_torch_overlap import _collect, _req
from test_torch_tp_families import _family_cfgs, _np_tree

pytestmark = pytest.mark.allow_slow_callbacks

# tests/test_torch_spec.py's widths with a 4096-token vocabulary: each
# rank's slice (2048) is one epilogue tile, tp = 1's two
SHAPES = dict(name="tiny32", vocab_size=4096, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = jl.LlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = tl.LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
PROMPTS = [list(range(60, 75)), [3, 1, 4, 1, 5, 9],
           [2, 7, 1, 8, 2, 8, 1, 8], list(range(30, 50))]
MESH_TIMEOUT_S = 30.0


def _tree(jcfg=JAX_FP32, seed=7):
    return _np_tree(jl.init_params(jcfg, jax.random.PRNGKey(seed)))


def _ranks_left() -> list:
    return [p for p in mp.active_children() if p.name.startswith(
        "dynamo-rank")]


async def _concurrent(eng, jax_side, n, sampling=(0.0, 0, 1.0, 0),
                      prompts=PROMPTS, lora=None):
    """Every prompt at once (request i under adapter lora[i], when
    given): the token lists."""
    reqs = []
    for i, p in enumerate(prompts):
        r = _req(jax_side, p, f"c{i}", n, sampling)
        if lora is not None:
            r.lora_name = lora[i]
        reqs.append(r)
    return list(await asyncio.gather(*[_collect(eng, r) for r in reqs]))


async def _closing(eng, coro):
    try:
        return await coro
    finally:
        await eng.close()


def _tp2(cfg, tree, **kw):
    return TorchEngine(EngineConfig(model_config=cfg, tp=2, **kw),
                       params=tree, device="cpu",
                       mesh_timeout_s=MESH_TIMEOUT_S)


def _tp1(cfg, tree, **kw):
    return TorchEngine(EngineConfig(model_config=cfg, **kw),
                       params=params_from_numpy(tree, cfg, "cpu"),
                       device="cpu")


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def write_partial_adapter(root, name, cfg, rank, alpha, seed):
    """A PEFT adapter of the q and v projections only (the standard
    layout, written as write_peft_adapter writes all four)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha,
                   "target_modules": ["q_proj", "v_proj"]}, f)
    dims = {"q": (cfg.d_model, cfg.q_dim), "v": (cfg.d_model, cfg.kv_dim)}
    tensors = {}
    for li in range(cfg.n_layers):
        for t, (d_in, d_out) in dims.items():
            p = f"base_model.model.model.layers.{li}.self_attn.{t}_proj"
            tensors[f"{p}.lora_A.weight"] = rng.normal(
                0, 0.3, (rank, d_in)).astype(np.float32)
            tensors[f"{p}.lora_B.weight"] = rng.normal(
                0, 0.3, (d_out, rank)).astype(np.float32)
    save_file(tensors, os.path.join(d, "adapter_model.safetensors"))


async def test_tp_lora_mixed_batch_and_reused_slot_equal_jax_and_tp1(
        tmp_path):
    root = str(tmp_path)
    write_peft_adapter(root, "ad1", JAX_FP32, rank=2, alpha=2, seed=11)
    write_peft_adapter(root, "ad2", JAX_FP32, rank=4, alpha=4, seed=22)
    write_partial_adapter(root, "qv", JAX_FP32, rank=3, alpha=6, seed=33)
    kw = dict(COMMON, lora_max_adapters=2, lora_rank=4, lora_dir=root)
    tree = _tree()
    names = [None, "ad1", "ad2", None]

    async def serve(eng, jax_side):
        mixed = await _concurrent(eng, jax_side, 6, lora=names)
        if jax_side:
            return mixed, None
        # "qv" evicts the least recently used of ad1/ad2 into its slot:
        # a slot that held all four targets
        partial = await _collect(eng, _lreq(PROMPTS[0], "qv"))
        return mixed, (partial, dict(eng._lora_slots))

    def _lreq(p, name):
        r = _req(False, p, f"l-{name}", 6)
        r.lora_name = name
        return r

    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, tp=2, **kw),
                   params=jax.tree_util.tree_map(jnp.asarray, tree))
    want, _ = await _closing(je, serve(je, True))
    t1 = _tp1(FP32, tree, **kw)
    one, (one_qv, slots1) = await _closing(t1, serve(t1, False))
    te = _tp2(FP32, tree, **kw)
    try:
        # each rank's bank holds its shard: q's columns of its heads
        assert te.lora_bank["B_q"].shape[-1] == FP32.q_dim // 2
        assert te.lora_bank["A_o"].shape[2] == FP32.q_dim // 2
        got, (got_qv, slots) = await serve(te, False)
    finally:
        await te.close()
    assert got == want == one
    assert len({tuple(t) for t in got[:3]}) == 3  # adapters move streams
    # the two concurrent loads race to their slots (as in
    # tests/test_torch_lora.py), so either may be the one "qv" evicted:
    # both held all four targets
    for sl in (slots, slots1):
        assert "qv" in sl and set(sl.values()) == {1, 2}
    assert got_qv == one_qv
    fresh = _tp1(FP32, tree, **kw)
    clean = await _closing(fresh, _collect(fresh, _lreq(PROMPTS[0], "qv")))
    assert got_qv == clean and got_qv != got[0]
    assert sorted(te.rank_launches) == [1]
    assert not _ranks_left()


# ---------------------------------------------------------------------------
# the fused epilogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
async def test_tp_fused_epilogue_streams_equal_off_jax_and_tp1(sampled):
    sampling = (0.8, 40, 0.9, 1234) if sampled else (0.0, 0, 1.0, 0)
    kw = dict(COMMON, sampling_epilogue="fused")
    tree = _tree()
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, tp=2, **kw),
                   params=jax.tree_util.tree_map(jnp.asarray, tree))
    want = await _closing(je, _concurrent(je, True, 8, sampling))
    t1 = _tp1(FP32, tree, **kw)
    one = await _closing(t1, _concurrent(t1, False, 8, sampling))
    te = _tp2(FP32, tree, **kw)
    try:
        assert te.sampling_epilogue == "fused" and te.graphs.epilogue
        got = await _concurrent(te, False, 8, sampling)
    finally:
        await te.close()
    assert got == want == one
    if not sampled:
        off = _tp2(FP32, tree, **COMMON)
        assert await _closing(off, _concurrent(off, False, 8)) == got
    assert not _ranks_left()


# ---------------------------------------------------------------------------
# the MoE and MLA families with the features asked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["moe", "mla"])
async def test_tp_families_with_fused_and_ngram_equal_jax_and_tp1(family):
    jcfg, cfg = _family_cfgs(family, "dense")
    kw = dict(COMMON, sampling_epilogue="fused", spec_decode="ngram")
    init = jl.init_params if family == "moe" else jd.init_params
    tree = _np_tree(init(jcfg, jax.random.PRNGKey(0)))
    je = JaxEngine(JaxEngineConfig(model_config=jcfg, tp=2, **kw),
                   params=jax.tree_util.tree_map(jnp.asarray, tree))
    want = await _closing(je, _concurrent(je, True, 12))
    t1 = _tp1(cfg, tree, **kw)
    one = await _closing(t1, _concurrent(t1, False, 12))
    te = _tp2(cfg, tree, **kw)
    try:
        if family == "moe":
            # the combine and the verify program run on the mesh
            assert te.graphs.epilogue and te.spec_enabled
        else:
            # JAX's fallbacks: no hidden-state decode, no packed verify
            assert te.sampling_epilogue == "off" and not te.spec_enabled
        got = await _concurrent(te, False, 12)
    finally:
        await te.close()
    assert got == want == one
    assert sorted(te.rank_launches) == [1]
    assert not _ranks_left()


# ---------------------------------------------------------------------------
# guided decoding and embed through the JAX frontend
# ---------------------------------------------------------------------------

SCHEMA = {"type": "object", "properties": {"city": {"type": "string"},
                                           "unit": {"enum": ["c", "f"]}}}


async def test_tp_worker_guided_and_embed_equal_the_jax_worker(tmp_path):
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    shapes = dict(SHAPES, vocab_size=300)  # the byte mock needs >= 259
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **shapes)
    cfg = tl.LlamaConfig(dtype=torch.float32, **shapes)
    tree = _tree(jcfg)
    tok_cfg = {"type": "mock", "vocab_size": shapes["vocab_size"]}
    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    jw = JaxEngineWorker(jrt, JaxEngineConfig(
        model_config=jcfg, model_name="g-jax", tp=2, **COMMON),
        component="jaxw", tokenizer_cfg=tok_cfg,
        params=jax.tree_util.tree_map(jnp.asarray, tree))
    tw = TorchEngineWorker(prt, EngineConfig(
        model_config=cfg, model_name="g-torch", tp=2, **COMMON),
        component="torchw", tokenizer_cfg=tok_cfg, params=tree,
        device="cpu")
    manager = ModelManager()
    watcher = service = None
    try:
        await jw.start()
        await tw.start()
        assert tw.engine.mesh.world == 2 and tw.engine.supports_embedding
        watcher = await ModelWatcher(jrt, manager).start()
        service = await HttpService(jrt, manager, host="127.0.0.1",
                                    port=0).start()
        url = f"http://127.0.0.1:{service._runner.addresses[0][1]}"
        for _ in range(500):
            if manager.get("g-jax") and manager.get("g-torch"):
                break
            await asyncio.sleep(0.02)
        msgs = [{"role": "user", "content": "weather?"}]
        got = {}
        async with aiohttp.ClientSession() as s:
            for model in ("g-jax", "g-torch"):
                async with s.post(f"{url}/v1/chat/completions", json={
                        "model": model, "messages": msgs, "max_tokens": 48,
                        "temperature": 0.0, "response_format": {
                            "type": "json_schema",
                            "json_schema": {"schema": SCHEMA}}}) as r:
                    assert r.status == 200, await r.text()
                    chat = await r.json()
                async with s.post(f"{url}/v1/embeddings", json={
                        "model": model,
                        "input": ["pooled", [5, 9, 13, 200]]}) as r:
                    assert r.status == 200, await r.text()
                    got[model] = (chat["choices"][0]["message"]["content"],
                                  await r.json())
        (jtext, jemb), (ttext, temb) = got["g-jax"], got["g-torch"]
        assert ttext == jtext
        assert JsonSchemaGuide(SCHEMA).done(ttext.strip()), ttext
        assert jemb["usage"] == temb["usage"]
        for x, y in zip(jemb["data"], temb["data"]):
            assert len(y["embedding"]) == shapes["d_model"]
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
    assert sorted(tw.engine.rank_launches) == [1]
    assert not _ranks_left()

"""TorchEngine against JaxEngine on the same converted weights (CPU).

Both engines serve the tests/test_engine.py FP32 config with the JAX
engine's parameters (converted through models/convert.py), each with its
default scheduler (overlapped, fused decode bursts, adaptive fusion), and
their greedy token streams must be identical, token for token, across
concurrent requests packed into one prefill dispatch, a prefix-cache hit
and stop conditions.  Seeded sampled streams are compared in
tests/test_torch_overlap.py.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.runtime import CancellationToken
from dynamo_tpu.tokens import TokenBlockSequence as JaxBlocks
from dynamo_tpu.tokens import compute_block_hashes_for_request as jax_hashes
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.tokens import TokenBlockSequence
from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)


def engines(**over):
    """A JaxEngine and a TorchEngine serving the same weights."""
    kw = {**COMMON, **over}
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **kw))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    te = TorchEngine(EngineConfig(model_config=FP32, **kw),
                     params=params_from_numpy(tree, FP32, device="cpu"),
                     device="cpu")
    return je, te


def _req(jax_side, tokens, rid, n, **stop):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    stop.setdefault("ignore_eos", True)
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0), stop=T(max_tokens=n, **stop))


async def _collect(eng, req, token=None):
    toks, finish = [], None
    async for out in eng.generate(req, token=token):
        toks.extend(out.token_ids)
        finish = out.finish_reason
    return toks, finish


async def _both(je, te, prompts, n, **stop):
    """Every prompt sent at once to each engine: (jax, torch) results."""
    res = []
    for side, eng in ((True, je), (False, te)):
        res.append(await asyncio.gather(*[
            _collect(eng, _req(side, p, f"r{i}", n, **stop))
            for i, p in enumerate(prompts)]))
    return res


async def test_greedy_streams_match_jax_engine():
    """Concurrent requests (one packed prefill dispatch, then batched
    decode) and a prefix-cache hit: identical greedy streams."""
    je, te = engines()
    try:
        prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8],
                   list(range(30, 50)), [14, 14, 2]]
        jres, tres = await _both(je, te, prompts, 8)
        assert tres == jres
        assert all(f == "length" and len(t) == 8 for t, f in tres)
        # the four prompts (37 tokens) went through ONE packed dispatch
        assert te.metrics["prefill_steps"] == 1
        assert te.metrics["prefill_tokens"] == 37

        # shares 5 full blocks (20 tokens) with prompts[2]
        hit = list(range(30, 50)) + [7, 7, 7]
        j0, t0 = (je.metrics["cache_hit_tokens"],
                  te.metrics["cache_hit_tokens"])
        jres, tres = await _both(je, te, [hit], 6)
        assert tres == jres
        assert te.metrics["cache_hit_tokens"] - t0 == 20
        assert je.metrics["cache_hit_tokens"] - j0 == 20
    finally:
        await je.close()
        await te.close()


async def test_greedy_streams_match_jax_engine_int8():
    """The same concurrent requests and prefix-cache hit on an int8 KV
    cache (quantize-on-write, dequantizing reads) in both engines."""
    je, te = engines(kv_cache_dtype="int8")
    try:
        assert len(te.kv) == 4 and te.kv[0].dtype == torch.int8
        prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8],
                   list(range(30, 50)), [14, 14, 2]]
        jres, tres = await _both(je, te, prompts, 8)
        assert tres == jres
        assert all(f == "length" and len(t) == 8 for t, f in tres)
        assert te.metrics["prefill_steps"] == 1
        hit = list(range(30, 50)) + [7, 7, 7]
        jres, tres = await _both(je, te, [hit], 6)
        assert tres == jres
        assert te.metrics["cache_hit_tokens"] == 20
    finally:
        await je.close()
        await te.close()


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_kv_hbm_budget_sizes_the_pool_like_jax(kv_cache_dtype):
    """kv_hbm_gb overwrites config.num_blocks with what the budget holds,
    the same count as the JAX engine; int8 holds more blocks."""
    je, te = engines(kv_cache_dtype=kv_cache_dtype, kv_hbm_gb=0.0005)
    assert te.config.num_blocks == je.config.num_blocks
    assert te.kv[0].shape[2] == te.config.num_blocks
    assert te.allocator.num_free == te.config.num_blocks - 1
    # tiny32: 2048 bytes per fp32 block, 640 per int8 block
    assert te.config.num_blocks == {"bf16": 244, "int8": 781}[
        kv_cache_dtype]


def test_kv_cache_dtype_is_validated():
    with pytest.raises(ValueError):
        EngineConfig(kv_cache_dtype="fp8")
    assert EngineConfig(kv_cache_dtype="int8").kv_cache_dtype == "int8"


async def test_stop_conditions_match_jax_engine():
    """max_tokens ends with "length"; a stop token id and an eos id end
    with "stop" on the same token in both engines."""
    je, te = engines()
    try:
        prompt = [5, 9, 13, 2, 7, 11, 3, 1, 8, 20]
        (jfree,), (tfree,) = await _both(je, te, [prompt], 10)
        assert tfree == jfree and tfree[1] == "length"
        stream = tfree[0]
        stop_tok = stream[3]
        (js,), (ts,) = await _both(je, te, [prompt], 10,
                                   stop_token_ids=[stop_tok])
        assert ts == js
        assert ts[1] == "stop" and ts[0][-1] == stop_tok
        assert ts[0] == stream[:stream.index(stop_tok) + 1]
        eos = stream[5]
        je.eos_ids = te.eos_ids = frozenset({eos})
        (je_, ), (te_, ) = await _both(je, te, [prompt], 10,
                                       ignore_eos=False)
        assert te_ == je_
        assert te_[1] == "stop" and te_[0] == stream[:stream.index(eos) + 1]
    finally:
        await je.close()
        await te.close()


async def test_preemption_replays_to_the_same_streams():
    """11 usable blocks for three sequences that grow to 5 blocks each:
    decode runs out of blocks, preempts, and the replayed sequences still
    produce the JAX engine's greedy streams."""
    je, te = engines(num_blocks=12)
    try:
        prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
                   [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
                   [14, 14, 2, 7, 7, 1, 0, 9, 9, 4]]
        jres, tres = await _both(je, te, prompts, 10)
        assert tres == jres
        assert all(f == "length" and len(t) == 10 for t, f in tres)
        assert te.metrics["preemptions"] > 0
    finally:
        await je.close()
        await te.close()


async def test_cancellation_frees_blocks():
    _, te = engines()
    free0 = te.allocator.num_free
    token = CancellationToken()
    req = _req(False, list(range(12)), "cancelme", 10_000)
    got = []

    async def consume():
        async for out in te.generate(req, token=token):
            got.append(out)
            if len(got) == 3:
                token.stop()

    try:
        await asyncio.wait_for(consume(), timeout=60)
        assert got[-1].finish_reason == "cancelled"
        for _ in range(400):
            if all(s is None for s in te._slots) and not te.waiting:
                break
            await asyncio.sleep(0.02)
        assert all(s is None for s in te._slots) and not te.waiting
        # committed full blocks stay cached (evictable); nothing is held
        assert te.allocator.num_free + te.allocator.num_evictable == free0
    finally:
        await te.close()


@pytest.mark.parametrize("block_size,lora", [(4, None), (64, None),
                                             (16, "adapter-a")])
def test_block_hashes_equal_jax(block_size, lora):
    rng = np.random.default_rng(block_size)
    tokens = rng.integers(0, 128256, 300).tolist()
    want = jax_hashes(tokens, block_size, lora_name=lora)
    assert compute_block_hashes_for_request(tokens, block_size,
                                            lora_name=lora) == want
    seq, jseq = TokenBlockSequence(block_size=block_size), JaxBlocks(
        block_size=block_size)
    for t in tokens:
        assert seq.append(t) == jseq.append(t)
    assert seq.block_hashes == jseq.block_hashes


async def test_unsupported_request_features_error():
    _, te = engines()
    try:
        req = _req(False, [1, 2, 3], "lora", 4)
        req.lora_name = "x"
        (toks, finish) = await _collect(te, req)
        assert finish == "error" and toks == []
        long = _req(False, list(range(70)), "long", 4)  # max_context 64
        assert (await _collect(te, long))[1] == "error"
    finally:
        await te.close()

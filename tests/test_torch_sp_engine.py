"""Sequence-parallel TorchEngines, one process per rank (CPU, fp32), on
the config of JAX's tests/test_engine.py
test_ring_attention_prefill_long_prompt_matches_chunked: the 2-layer
FP32 tiny model, block 4, prefill buckets (8, 16) and a 40-token prompt,
past the largest bucket, so a cold one takes the ring prefill.

* sp=2: the greedy stream of the long prompt equals JaxEngine(sp=2)'s
  and the sp=1 engine's chunked one, with exactly one ring prefill
  (`ring_prefills`); a short prompt stays on the packed path and streams
  what sp=1 streams.
* tp=2 x sp=2 (four ranks), on the fp32 cache and on an int8 cache: the
  long prompt streams what JaxEngine(tp=2, sp=2) and the sp=1 engine
  stream, with one ring prefill; as a cold disaggregated hop its parked
  blocks, gathered from the s = 0 tensor group into the logical payload,
  equal JaxEngine(tp=2, sp=2)'s, and on the fp32 cache the sp=1
  engine's, within fp32 tolerance.  On the int8 cache (codes within one
  step, scales at the tolerance) only the first layer's blocks are held
  to sp=1's: its chunked prefill attends to the quantized K/V of the
  chunks before, the ring to the fresh K/V, as in JAX, so later layers'
  inputs differ by that rounding.  Every rank replays the stream and no
  rank outlives close.

The engines' mesh_timeout_s bounds every join and collective, so a rank
that hangs fails its test by name.
"""

import multiprocessing as mp

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
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

pytestmark = pytest.mark.allow_slow_callbacks

# tests/test_engine.py's FP32 config and the ring test's engine settings
FP32 = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
            n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **FP32)
TORCH_FP32 = LlamaConfig(dtype=torch.float32, **FP32)
BASE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
            max_num_seqs=2, prefill_buckets=(8, 16), seed=7)
PROMPT = list(range(1, 41))  # 40 tokens > the largest bucket (16)
SHORT = list(range(50, 60))
MESH_TIMEOUT_S = 30.0
FWD = dict(rtol=1e-5, atol=1e-5)


def _req(jax_side, tokens, rid, n, disagg=False):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    req = R(token_ids=list(tokens), request_id=rid,
            sampling=S(temperature=0.0),
            stop=T(max_tokens=n, ignore_eos=True))
    if disagg:
        req.annotations = [DISAGG_ANNOTATION]
    return req


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


def _ranks_left() -> list:
    return [p for p in mp.active_children() if p.name.startswith(
        "dynamo-rank")]


def _torch_tree(tree):
    return params_from_numpy(tree, TORCH_FP32, "cpu")


async def _jax_stream(kv: str, hop: bool = False, **mesh):
    """JaxEngine's greedy stream of PROMPT, its weights as numpy and,
    with `hop`, its blocks of PROMPT as a cold hop (_hop_blocks)."""
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32,
                                   kv_cache_dtype=kv, **mesh, **BASE))
    try:
        toks = await _collect(je, _req(True, PROMPT, "j", 5))
        assert je.metrics.get("ring_prefills", 0) == 1
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      je.params)
        blocks = await _hop_blocks(je, "h", jax_side=True) if hop else None
    finally:
        await je.close()
    return toks, tree, blocks


async def _hop_blocks(eng, rid: str, jax_side: bool = False) -> tuple:
    """PROMPT as a disaggregated hop, cold (the prefix cache cleared
    first): its parked blocks as the logical payload (gathered over the
    leader's tensor group), host numpy in the universal layout."""
    await eng.clear_kv_blocks()
    toks = await _collect(eng, _req(jax_side, PROMPT, rid, 3, disagg=True))
    assert len(toks) == 1
    nb = -(-len(PROMPT) // BASE["block_size"])
    arrs = await eng.extract_parked_chunk(rid, 0, nb)
    await eng.release_parked(rid)
    if jax_side:
        return tuple(np.asarray(a, np.float32)
                     if np.issubdtype(np.asarray(a).dtype, np.floating)
                     else np.asarray(a) for a in arrs)
    return tuple(a.float().numpy() if a.is_floating_point() else a.numpy()
                 for a in (x.cpu() for x in arrs))


def _same_blocks(got, want, int8: bool, layers=slice(None)) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g[layers], w[layers]
        assert g.shape == w.shape
        if int8 and i < 2:
            np.testing.assert_allclose(g.astype(np.int32),
                                       w.astype(np.int32), rtol=0, atol=1)
        else:
            np.testing.assert_allclose(g, w, **FWD)


async def test_sp2_engine_streams_equal_jax_and_sp1():
    want, tree, _ = await _jax_stream("bf16", sp=2)
    one = TorchEngine(EngineConfig(model_config=TORCH_FP32, **BASE),
                      params=_torch_tree(tree), device="cpu")
    try:
        chunked = await _collect(one, _req(False, PROMPT, "c", 5))
        short1 = await _collect(one, _req(False, SHORT, "s", 3))
        assert one.metrics.get("ring_prefills", 0) == 0
    finally:
        await one.close()
    te = TorchEngine(EngineConfig(model_config=TORCH_FP32, sp=2, **BASE),
                     params=tree, device="cpu",
                     mesh_timeout_s=MESH_TIMEOUT_S)
    try:
        assert te.mesh.world == 2 and te.mesh.ring.size == 2
        toks = await _collect(te, _req(False, PROMPT, "r", 5))
        assert te.metrics.get("ring_prefills", 0) == 1, \
            "the long prompt did not take the ring prefill"
        # a short prompt stays on the (cheaper) packed path
        short = await _collect(te, _req(False, SHORT, "s", 3))
        assert te.metrics.get("ring_prefills", 0) == 1
        recs = [r for r in te.fpm if r.get("family") == "prefill_ring"]
        assert [r["tokens"] for r in recs] == [64] and recs[0]["flops"] > 0
    finally:
        await te.close()
    assert toks == want == chunked
    assert short == short1 and len(short) == 3
    assert sorted(te.rank_launches) == [1]
    assert not _ranks_left()


async def test_tp2_sp2_engine_streams_and_blocks_equal_jax_and_sp1():
    for kv in ("bf16", "int8"):
        want, tree, jax_blocks = await _jax_stream(kv, hop=True, tp=2,
                                                   sp=2)
        cfg = dict(model_config=TORCH_FP32, kv_cache_dtype=kv, **BASE)
        one = TorchEngine(EngineConfig(**cfg), params=_torch_tree(tree),
                          device="cpu")
        try:
            chunked = await _collect(one, _req(False, PROMPT, "c", 5))
            ref = await _hop_blocks(one, "h")
        finally:
            await one.close()
        te = TorchEngine(EngineConfig(tp=2, sp=2, **cfg), params=tree,
                         device="cpu", mesh_timeout_s=MESH_TIMEOUT_S)
        try:
            assert te.mesh.world == 4
            assert te.kv[0].shape[1] == FP32["n_kv_heads"] // 2
            toks = await _collect(te, _req(False, PROMPT, "r", 5))
            got = await _hop_blocks(te, "h")
            assert te.metrics.get("ring_prefills", 0) == 2
        finally:
            await te.close()
        assert toks == want == chunked, kv
        int8 = kv == "int8"
        _same_blocks(got, jax_blocks, int8)
        _same_blocks(got, ref, int8, slice(0, 1) if int8 else slice(None))
        assert sorted(te.rank_launches) == [1, 2, 3]
        assert not _ranks_left()

"""Packed prefill as one program per bucket (engine/graphs.py
PrefillPrograms) against the JAX engine's one jitted program per bucket.

* A bucket's descriptor packs the planner's arrays into one int32 buffer
  and its views unpack them again (floats by their bits).
* A plan padded to max_prefill_seqs rows and full-width tables gives the
  first tokens of the unpadded plan and of the JAX engine's packed
  prefill program, greedy and seeded-sampled.
* The buckets are the planner's ladder (the seven default
  prefill_buckets); warmup_decode builds each once and serving builds
  none (the counts gate, as for the decode programs).
* Prompts spanning every bucket give the JaxEngine's streams on both
  cache dtypes.

tests/test_torch_prefill_graphs_gpu.py holds the card's side (it imports
no JAX, so it runs on a machine without it).
"""

import asyncio
from types import SimpleNamespace

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
from dynamo_tpu_torch.engine.prefill import plan_packed_prefill
from dynamo_tpu_torch.engine.sampler import sample_tokens
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = llama.LlamaConfig(dtype=torch.float32, **SHAPES)
# a 64-token chunk budget: the ladder is the four buckets
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64),
              max_batch_tokens=64, seed=7)
# (temperature, top_k, top_p, seed) per row: greedy and seeded rows
SAMPLING = [(0.0, 0, 1.0, 0), (0.9, 0, 0.95, 1234), (1.3, 20, 1.0, 77)]
_JAX = {}


def _params():
    if "tree" not in _JAX:
        je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **COMMON))
        _JAX["tree"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), je.params)
    return _JAX["tree"]


def torch_engine(**over) -> TorchEngine:
    return TorchEngine(EngineConfig(model_config=FP32, **{**COMMON, **over}),
                       params=params_from_numpy(_params(), FP32,
                                                device="cpu"),
                       device="cpu")


def _slots(lens, tables_from=1):
    """Planner-facing stand-ins of three prefilling slots with distinct
    blocks and the SAMPLING rows."""
    out, nxt = [], tables_from
    rng = np.random.default_rng(4)
    for i, n in enumerate(lens):
        table = np.zeros(COMMON["max_blocks_per_seq"], np.int32)
        need = -(-n // COMMON["block_size"])
        table[:need] = np.arange(nxt, nxt + need)
        nxt += need
        temp, top_k, top_p, seed = SAMPLING[i]
        out.append(SimpleNamespace(
            prompt_len=n, prefill_pos=0, block_table=table,
            seq=SimpleNamespace(tokens=rng.integers(0, 256, n).tolist()),
            sampling_seed=seed,
            request=SimpleNamespace(sampling=SimpleNamespace(
                temperature=temp, top_k=top_k, top_p=top_p))))
    return out


def _plan(lens=(13, 7, 9)):
    return plan_packed_prefill(_slots(lens), 64, block_size=4,
                               max_blocks_per_seq=COMMON["max_blocks_per_seq"],
                               min_bucket=8, with_lora=False)


def test_descriptor_packs_and_unpacks():
    eng = torch_engine(max_prefill_seqs=8)
    g = eng.prefill_graphs
    assert g.buckets == (8, 16, 32, 64) and g.rows == 8
    plan = _plan()
    a = g.pad(plan.arrays)
    T = g.upload(a)
    assert T == plan.bucket == 32
    d = g.d[T]
    for name in ("toks", "positions", "seg_ids", "last_idx", "seeds",
                 "top_ks", "temps", "top_ps"):
        got = getattr(d, name).numpy()
        assert np.array_equal(got, a[name]), name
    assert np.array_equal(d.valid.numpy() != 0, a["valid"])
    assert np.array_equal(d.tables.numpy(), a["tables"])
    assert d.temps.dtype == torch.float32 and d.tables.is_contiguous()
    # the padding rows: no token, last_idx 0, an all-zero table, top_p 1
    S = len(plan.arrays["last_idx"])
    assert S == 4 and not a["tables"][S:].any() and not a["last_idx"][S:].any()
    assert (a["top_ps"][S:] == 1.0).all()
    assert np.array_equal(a["tables"][:S, :plan.arrays["tables"].shape[1]],
                          plan.arrays["tables"])
    with pytest.raises(ValueError, match="no prefill program"):
        g.upload(g.host_descriptor(16) | {"toks": np.zeros(128, np.int32)})
    # the default config's ladder is the seven prefill_buckets
    dflt = TorchEngine(EngineConfig(model_config=FP32, block_size=4,
                                    num_blocks=16, max_blocks_per_seq=8),
                       params=params_from_numpy(_params(), FP32,
                                                device="cpu"), device="cpu")
    assert dflt.prefill_graphs.buckets == EngineConfig().prefill_buckets
    assert len(dflt.prefill_graphs.buckets) == 7


def test_padded_plan_first_tokens_equal_unpadded_and_jax():
    """Three rows, greedy and two seeded-sampled: the bucket's program on
    the plan padded to 8 rows and 32-block tables, the model on the
    unpadded plan, and the JAX engine's packed-prefill program give the
    same first tokens (and the two port paths the same logits)."""
    eng = torch_engine(max_prefill_seqs=8)
    plan = _plan()
    g = eng.prefill_graphs
    T = g.upload(g.pad(plan.arrays))
    padded = g.run(T).clone()
    logits_padded = g.logits[T].clone()
    # the unpadded plan through the model on a fresh cache
    a = {k: torch.from_numpy(v) for k, v in plan.arrays.items()}
    kv = tuple(torch.zeros_like(t) for t in eng.kv)
    logits, _ = llama.prefill_packed(eng.params, FP32, kv, a["toks"],
                                     a["positions"], a["seg_ids"],
                                     a["tables"], a["last_idx"], a["valid"])
    tok = sample_tokens(logits, a["seeds"], torch.zeros_like(a["seeds"]),
                        a["temps"], a["top_ks"], a["top_ps"])
    S = len(plan.slots)
    assert torch.equal(padded[:S], tok[:S])
    torch.testing.assert_close(logits_padded[:S], logits[:S], rtol=1e-5,
                               atol=1e-5)
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **COMMON))
    j = plan.arrays
    jtok, je.kv = je._jit_prefill_packed(
        je.params, je.kv, *(jnp.asarray(j[k]) for k in (
            "toks", "positions", "seg_ids", "tables", "last_idx", "valid",
            "seeds", "temps", "top_ks", "top_ps")), None, None)
    assert padded[:S].tolist() == np.asarray(jtok)[:S].tolist()
    # the sampled rows did not degenerate to greedy
    assert padded[1] != int(torch.argmax(logits[1]))


def _req(jax_side, tokens, rid, n):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0),
             stop=T(max_tokens=n, ignore_eos=True))


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        toks.extend(out.token_ids)
    return toks


# one prompt per bucket of the ladder, and one chunked across two
PROMPTS = [list(range(3, 8)), list(range(20, 32)), list(range(40, 65)),
           list(range(70, 120)), list(range(130, 230))]


async def _serve_each(eng, jax_side):
    try:
        return [await _collect(eng, _req(jax_side, p, f"p{i}", 6))
                for i, p in enumerate(PROMPTS)]
    finally:
        await eng.close()


async def test_warmup_builds_every_bucket_and_serving_builds_none():
    eng = torch_engine()
    await asyncio.to_thread(eng.warmup_decode)
    want = {T: 1 for T in (8, 16, 32, 64)}
    assert eng.prefill_graphs.counts == want
    # warm-up left the decode programs' state as it found it
    assert eng._last_desc is None and not eng._inflight
    res = await _serve_each(eng, False)
    assert eng.prefill_graphs.counts == want
    assert all(len(t) == 6 for t in res)
    buckets = {r["bucket"] for r in eng.fpm if r["kind"] == "prefill"}
    assert buckets == {8, 16, 32, 64}


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
async def test_prompts_over_every_bucket_equal_jax_engine(kv_cache_dtype):
    tres = await _serve_each(torch_engine(kv_cache_dtype=kv_cache_dtype),
                             False)
    jres = await _serve_each(JaxEngine(JaxEngineConfig(
        model_config=JAX_FP32, kv_cache_dtype=kv_cache_dtype, **COMMON)),
        True)
    assert tres == jres and all(len(t) == 6 for t in tres)

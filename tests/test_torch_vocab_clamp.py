"""Token ids past the vocabulary, the port against the JAX package (CPU).

JAX gathers the embedding row with clamped indexing: a negative id wraps
once, then every id is clamped to [0, V-1].  The port clamps at the
gather (parallel/mesh.py clamp_ids, inside models/llama.py `_embed` and
the vocab-parallel `TensorGroup.embed`), not at admission, so block
hashes, KV events and the n-gram proposer keep the raw ids as JAX's do.

* `clamp_ids` against a JAX gather on the same ids;
* TorchEngine against JaxEngine (fp32 tiny32, vocab 256) on the prompt
  [3, 1000, 5, 30000], greedy: equal streams and equal KV events, and the
  engine then serves a normal request whose stream equals JAX's;
* the tp = 2 lookup and a prefill on ids past the vocabulary, ranks as
  threads over one gloo group, equal to tp = 1's (no spawned process).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tp import CFG as TP_CFG
from test_torch_tp import _cache, _jax_params, run_ranks

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.tokens import compute_block_hashes_for_request as jax_hashes
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.parallel.mesh import clamp_ids, shard_config
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32), seed=7)
OOV_PROMPT = [3, 1000, 5, 30000]


@pytest.mark.parametrize("ids", [[3, 12, -1, -15], [0, 9, 10, -10, 10**6],
                                 [-11, -20, 5]])
def test_clamp_ids_equal_jax_gather(ids):
    table = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids, jnp.int32)])
    got = torch.from_numpy(table)[clamp_ids(torch.tensor(ids), 10)]
    np.testing.assert_array_equal(got.numpy(), want)


def _req(jax_side, tokens, rid, n):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0),
             stop=T(max_tokens=n, ignore_eos=True))


async def _serve(eng, jax_side, events):
    """The out-of-vocabulary prompt, then a normal one, on one engine:
    [(tokens, finish, error)] and the KV events (the sink runs on the
    loop thread)."""
    out = []
    for rid, prompt, n in (("oov", OOV_PROMPT, 3),
                           ("next", [7, 8, 9, 10, 11, 12], 4)):
        toks, finish, err = [], None, None
        async for o in eng.generate(_req(jax_side, prompt, rid, n)):
            toks.extend(o.token_ids)
            finish, err = o.finish_reason, o.error
        out.append((toks, finish, err))
    await asyncio.sleep(0.05)
    return out, list(events)


async def test_out_of_vocab_prompt_streams_equal_jax():
    je_events, te_events = [], []
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **COMMON),
                   kv_event_sink=lambda s, r, t="g1": je_events.append(
                       (list(s), list(r), t)))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    te = TorchEngine(EngineConfig(model_config=FP32, **COMMON),
                     params=params_from_numpy(tree, FP32, device="cpu"),
                     device="cpu",
                     kv_event_sink=lambda s, r, t="g1": te_events.append(
                         (list(s), list(r), t)))
    try:
        jres = await _serve(je, True, je_events)
        tres = await _serve(te, False, te_events)
    finally:
        await je.close()
        await te.close()
    assert tres == jres
    streams, events = tres
    assert [(len(t), f, e) for t, f, e in streams] == [
        (3, "length", None), (4, "length", None)]
    # the prompt's one full block is stored under the RAW ids' hash
    stored = [h for s, _, _ in events for h in s]
    assert stored[0] == compute_block_hashes_for_request(OOV_PROMPT, 4)[0]
    assert stored[0] == jax_hashes(OOV_PROMPT, 4)[0]


@pytest.mark.parametrize("what", ["embed", "prefill"])
def test_tp2_lookup_of_ids_past_the_vocabulary_equals_tp1(what):
    full = _jax_params()
    V = TP_CFG.vocab_size
    ids = torch.tensor([3, V + 5, -1, 10 * V, V - 1, -(2 * V), 0, 77],
                       dtype=torch.int32)

    def run(params, cfg):
        if what == "embed":
            return llama._embed(params, cfg, ids)
        kv = _cache(cfg, 8, 4, False)
        tables = torch.arange(1, 4, dtype=torch.int32)
        return llama.prefill(params, cfg, kv, ids, torch.arange(8),
                             tables, 0, 8)[0]

    want = run(params_from_numpy(full, TP_CFG, "cpu"), TP_CFG)
    # the clamp, not zeros: an id past V reads the last row
    if what == "embed":
        np.testing.assert_array_equal(want[1].numpy(), want[4].numpy())
        np.testing.assert_array_equal(want[5].numpy(), want[6].numpy())
    local = shard_config(TP_CFG, 2)

    def body(r, group):
        params = params_from_numpy(full, TP_CFG, "cpu", rank=r, tp=2)
        params["tp"] = group
        return run(params, local)

    for got in run_ranks(2, body):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

"""Speculative decoding, the vocab-parallel sampling epilogue and the
sharded LoRA bank on a tensor-parallel mesh (CPU, fp32).

* The vocab-parallel combine (ops/fused_sampling.py `_combine_ranks`,
  parallel/mesh.py TensorGroup.gather_stats), ranks as threads over one
  in-process gloo store (tests/test_torch_tp.py run_ranks): each rank
  streams its slice of an integer-valued projection (so logits tie
  exactly), and the combined statistics equal fused_sample_stats over
  the whole vocabulary, the window and the maximum bit for bit, with
  ties planted across the ranks' edge, at a local tile edge and at the
  window's CAP edge; greedy and sampled tokens equal the whole
  vocabulary's on every rank.
* The sharded adapter bank (lora/bank.py shard_adapter): each target's
  delta on the ranks' shards gives the whole bank's (q, k, v by their
  columns, o as the sum over the group), also with the kv heads
  replicated; and a tp = 2 decode step with a mixed-adapter batch
  equals tp = 1's logits.
* Spawned-rank engines with speculative decoding: n-gram at tp = 2 and
  dp = 2 x tp = 2, and draft == target at tp = 2, each stream, spec
  counters and spec_verify FPM records equal to JAX's engine at the same
  mesh and to the port's tp = 1 engine on the same weights; the draft
  runs whole on the leader, followers replay the verify steps.
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.sampler import CAP
from dynamo_tpu_torch.lora.bank import (
    empty_bank,
    lora_delta,
    shard_adapter,
    write_adapter,
)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.ops import fused_sampling as fs
from dynamo_tpu_torch.parallel.mesh import shard_config
from test_lora import random_adapter_arrays
from test_torch_overlap import _collect, _req
from test_torch_spec import settled, spec_counts, spec_records
from test_torch_tp import run_ranks

pytestmark = pytest.mark.allow_slow_callbacks

# tests/test_torch_spec.py's widths (nh 4 over nkv 2, so tp = 2 divides)
SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = jl.LlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = tl.LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=256, max_blocks_per_seq=64,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
REPEAT_PROMPT = [5, 9, 13, 2] * 6
RANDOM_PROMPT = list(map(int, np.random.default_rng(11).integers(1, 250,
                                                                 24)))
MESH_TIMEOUT_S = 30.0


def _ranks_left() -> list:
    return [p for p in mp.active_children() if p.name.startswith(
        "dynamo-rank")]


# ---------------------------------------------------------------------------
# the vocab-parallel combine, ranks as threads
# ---------------------------------------------------------------------------

V, D, B = 640, 16, 4


def _projection(plant: str, tp: int):
    """Integer-valued h [B, D] (entries 1, 2) and w [D, V] (entries
    -3..3), so every logit is an exact small integer and equal logits are
    equal floats on any path.  Planted columns of all 3s hold every row's
    largest logit, 3 * sum(h[b]): a pair across the ranks' edge, a pair
    across a local tile edge (tile 64), or, for "cap-edge", a run of
    CAP + 6 equal columns across the ranks' edge, so the window's CAP-th
    and next places tie."""
    g = torch.Generator().manual_seed(3)
    h = torch.randint(1, 3, (B, D), generator=g).float()
    w = torch.randint(-3, 4, (D, V), generator=g).float()
    edge = V // tp
    cols = {"rank-edge": [edge - 1, edge],
            "tile-edge": [edge + 63, edge + 64],
            "cap-edge": list(range(edge - CAP // 2 - 3,
                                   edge + CAP // 2 + 3))}[plant]
    w[:, cols] = 3.0
    return h, w, cols


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("plant", ["rank-edge", "tile-edge", "cap-edge"])
def test_vocab_parallel_combine_equals_the_whole_vocabulary(plant, tp):
    h, w, cols = _projection(plant, tp)
    temps = torch.tensor([0.0, 0.7, 1.0, 1.3])
    seeds = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    steps = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    top_k = torch.tensor([0, 0, 8, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 1.0, 0.8])
    tile = 64
    want = fs.fused_sample_stats(h, w, temps, tile=tile)
    want_greedy = fs.fused_greedy_tokens(h, w, tile=tile)
    want_tok = fs.fused_sample_tokens(h, w, seeds, steps, temps, top_k,
                                      top_p, tile=tile)
    logits = h @ w
    assert torch.equal(want_greedy, torch.argmax(logits, dim=-1).int())
    # the planted ties are the rows' maxima, the first of them wins
    for b in range(B):
        top = torch.nonzero(logits[b] == logits[b].max())[:, 0].tolist()
        assert top == cols and int(want_greedy[b]) == cols[0]

    def body(r, group):
        n = V // tp
        wl = w[:, r * n:(r + 1) * n].contiguous()
        return (fs.fused_sample_stats(h, wl, temps, tile=tile, group=group),
                fs.fused_greedy_tokens(h, wl, tile=tile, group=group),
                fs.fused_sample_tokens(h, wl, seeds, steps, temps, top_k,
                                       top_p, tile=tile, group=group))

    for stats, greedy, tok in run_ranks(tp, body):
        bv, bi, rv, ri, lse = stats
        assert torch.equal(bv, want[0]) and torch.equal(bi, want[1])
        assert torch.equal(rv, want[2]) and torch.equal(ri, want[3])
        torch.testing.assert_close(lse, want[4], rtol=1e-6, atol=1e-6)
        assert torch.equal(greedy, want_greedy)
        assert torch.equal(tok, want_tok)


# ---------------------------------------------------------------------------
# the sharded adapter bank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_replicated", [False, True],
                         ids=["kv-sliced", "kv-replicated"])
def test_sharded_lora_deltas_give_the_whole_banks(kv_replicated):
    cfg, tp, rank, slots = FP32, 2, 4, 3
    adapters = {s: random_adapter_arrays(cfg, rank, seed=s)
                for s in range(1, slots)}

    def bank(q_dim, kv_dim, r=0, tp_=1):
        b = empty_bank(cfg.n_layers, slots, rank, cfg.d_model, q_dim,
                       kv_dim, dtype=torch.float32,
                       device=torch.device("cpu"))
        for s, t in adapters.items():
            write_adapter(b, s, shard_adapter(t, r, tp_, kv_replicated))
        return b

    whole = bank(cfg.q_dim, cfg.kv_dim)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, cfg.d_model, generator=g)
    xo = torch.randn(5, cfg.q_dim, generator=g)
    idx = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32)
    li = 1

    def delta(b, t, inp):
        return lora_delta(inp, b[f"A_{t}"][li], b[f"B_{t}"][li], idx)

    want = {t: delta(whole, t, x) for t in "qkv"}
    want["o"] = delta(whole, "o", xo)

    def body(r, group):
        kvd = cfg.kv_dim if kv_replicated else cfg.kv_dim // tp
        b = bank(cfg.q_dim // tp, kvd, r, tp)
        n = cfg.q_dim // tp
        out = {t: delta(b, t, x) for t in "qkv"}
        out["o"] = group.all_reduce(
            delta(b, "o", xo[:, r * n:(r + 1) * n].contiguous()))
        return out

    parts = run_ranks(tp, body)
    for t in "qkv":
        if t != "q" and kv_replicated:
            for p in parts:  # whole on every rank, never summed
                torch.testing.assert_close(p[t], want[t], rtol=1e-5,
                                           atol=1e-5)
        else:
            torch.testing.assert_close(torch.cat([p[t] for p in parts], 1),
                                       want[t], rtol=1e-5, atol=1e-5)
    for p in parts:
        torch.testing.assert_close(p["o"], want["o"], rtol=1e-5, atol=1e-5)
    assert float(want["o"].abs().max()) > 0


def test_tp_decode_with_a_mixed_adapter_batch_equals_tp1():
    cfg, tp, rank, slots = FP32, 2, 4, 3
    full = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jl.init_params(JAX_FP32, jax.random.PRNGKey(7)))
    adapters = {s: random_adapter_arrays(cfg, rank, seed=10 + s)
                for s in range(1, slots)}
    nb, bs, mb = 16, 4, 4
    tables = torch.arange(1, 1 + 3 * mb, dtype=torch.int32).reshape(3, mb)
    toks = torch.tensor([7, 100, 42], dtype=torch.int32)
    ctx = torch.tensor([0, 3, 6], dtype=torch.int32)
    idx = torch.tensor([2, 0, 1], dtype=torch.int32)

    def run(params, lcfg, kv_heads, r=0, tp_=1):
        b = empty_bank(lcfg.n_layers, slots, rank, lcfg.d_model,
                       lcfg.q_dim, lcfg.kv_dim, dtype=torch.float32,
                       device=torch.device("cpu"))
        for s, t in adapters.items():
            write_adapter(b, s, shard_adapter(t, r, tp_))
        kv = tuple(torch.zeros(cfg.n_layers, kv_heads, nb, bs,
                               cfg.head_dim) for _ in range(2))
        logits, _ = tl.decode(params, lcfg, kv, toks, ctx, tables, ctx,
                              lora_bank=b, adapter_idx=idx)
        return logits

    want = run(params_from_numpy(full, cfg, "cpu"), cfg, cfg.n_kv_heads)
    local = shard_config(cfg, tp)

    def body(r, group):
        params = params_from_numpy(full, cfg, "cpu", rank=r, tp=tp)
        params["tp"] = group
        return run(params, local, local.n_kv_heads, r, tp)

    for got in run_ranks(tp, body):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the adapters move the logits: a bank-less step differs
    plain, _ = tl.decode(params_from_numpy(full, cfg, "cpu"), cfg,
                         tuple(torch.zeros(cfg.n_layers, cfg.n_kv_heads, nb,
                                           bs, cfg.head_dim)
                               for _ in range(2)),
                         toks, ctx, tables, ctx)
    assert not torch.allclose(plain[0], want[0], atol=1e-3)


# ---------------------------------------------------------------------------
# spawned-rank engines with speculative decoding
# ---------------------------------------------------------------------------

_TREE = {}


def _tree():
    """JaxEngine's weights at seed 7 as numpy: the weights of the JAX
    engine, and of its draft == target."""
    if "tree" not in _TREE:
        _TREE["tree"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            jl.init_params(JAX_FP32, jax.random.PRNGKey(7)))
    return _TREE["tree"]


async def _serve_two(eng, jax_side, n):
    """A repetition prompt, then a random prompt ending in it (the draft
    catches up over the random head): one after the other, so the spec
    records' order is the engines' own."""
    out = []
    for i, p in enumerate((REPEAT_PROMPT, RANDOM_PROMPT + REPEAT_PROMPT)):
        out.append(await _collect(eng, _req(jax_side, p, f"s{i}", n)))
    return out


# (proposer, mesh, tokens a request): the n-gram table first matches
# late in this model's streams (tests/test_torch_spec.py serves 96)
SPEC_CASES = {
    "ngram-tp2": ("ngram", dict(tp=2), 96),
    "ngram-dp2-tp2": ("ngram", dict(dp=2, tp=2), 96),
    "draft-tp2": ("draft", dict(tp=2), 40),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
async def test_spec_engine_streams_counters_records_equal_jax_and_tp1(case):
    proposer, mesh_kw, n = SPEC_CASES[case]
    draft = proposer == "draft"
    kw = {**COMMON, "spec_decode": proposer, "spec_k": 4}
    je = JaxEngine(JaxEngineConfig(
        model_config=JAX_FP32, **mesh_kw, **kw,
        **({"spec_draft_config": JAX_FP32} if draft else {})))
    try:
        want = await _serve_two(je, True, n)
    finally:
        await je.close()
        await settled(je)
    jcounts, jrecs = spec_counts(je), spec_records(je)
    tkw = {**kw, **({"spec_draft_config": FP32} if draft else {})}

    def draft_params():
        return params_from_numpy(_tree(), FP32, "cpu") if draft else None

    t1 = TorchEngine(EngineConfig(model_config=FP32, **tkw),
                     params=params_from_numpy(_tree(), FP32, "cpu"),
                     device="cpu", draft_params=draft_params())
    try:
        one = await _serve_two(t1, False, n)
    finally:
        await t1.close()
    world = mesh_kw.get("dp", 1) * mesh_kw["tp"]
    te = TorchEngine(EngineConfig(model_config=FP32, **mesh_kw, **tkw),
                     params=_tree(), device="cpu",
                     draft_params=draft_params(),
                     mesh_timeout_s=MESH_TIMEOUT_S)
    try:
        assert te.spec_enabled and te.verify_graphs.cfg == te.shard_cfg
        got = await _serve_two(te, False, n)
    finally:
        await te.close()
    assert got == want == one
    assert spec_counts(te) == jcounts == spec_counts(t1)
    assert spec_counts(te)["spec_accepted"] > 0
    assert spec_records(te) == jrecs == spec_records(t1)
    if draft:
        # the draft ran whole on the leader: its catch-up and propose
        # programs never rode the stream
        assert te.proposer.cfg == FP32
        assert te.proposer.metrics["catchup_dispatches"] > 0
    assert sorted(te.rank_launches) == list(range(1, world))
    assert not _ranks_left()

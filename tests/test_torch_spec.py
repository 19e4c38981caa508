"""The port's speculative decoding (CPU) against the JAX package's.

* block_allocator.trim_blocks: the same allocator state and events.
* sampler.spec_window_weights / spec_accept_tokens, spec/ngram.py and
  spec/verify.py plan_spec_verify: equal results on the same inputs (and
  the same host RNG).
* models/llama.py spec_verify_packed against JAX's (fp32 logits and
  written KV within 1e-5) and against the port's own prefill_packed
  (last-position logits equal, KV bit-equal); prefill and
  paged_prefill_attention (the draft's catch-up) against JAX's on a
  float and an int8 cache.
* TorchEngine against JaxEngine with the same config and weights
  (tests/test_speculative.py's FP32 config and engine defaults, weights
  carried across through models/convert.py): greedy n-gram streams,
  spec counters, spec_verify FPM records and KV events; draft == target;
  seeded sampled streams; the adaptive collapse under a hostile
  proposer; the spec-then-plain stale-chain case; KV rollback
  accounting; preemption mid-spec; an int8 cache.  Greedy spec streams
  also equal the port's spec-off streams.
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
from dynamo_tpu.engine.block_allocator import BlockAllocator as JaxAllocator
from dynamo_tpu.engine.sampler import spec_accept_tokens as jax_accept
from dynamo_tpu.engine.sampler import spec_window_weights as jax_weights
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.spec import NgramProposer as JaxNgram
from dynamo_tpu.spec import plan_spec_verify as jax_plan
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator
from dynamo_tpu_torch.engine.sampler import CAP, spec_accept_tokens, \
    spec_window_weights
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import (
    kv_cache_from_numpy,
    kv_cache_to_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.spec import NgramProposer, plan_spec_verify
from test_torch_overlap import _collect, _req

pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = jl.LlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = tl.LlamaConfig(dtype=torch.float32, **SHAPES)
# tests/test_speculative.py's engine defaults
COMMON = dict(block_size=4, num_blocks=256, max_blocks_per_seq=64,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
REPEAT_PROMPT = [5, 9, 13, 2] * 6
RANDOM_PROMPT = list(map(int, np.random.default_rng(11).integers(1, 250,
                                                                 24)))

_PARAMS = {}


def _params():
    """JaxEngine's weights at seed 7 (init_params(PRNGKey(7))) as numpy:
    the weights of the JAX engine, and of its draft == target."""
    if "tree" not in _PARAMS:
        _PARAMS["tree"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            jl.init_params(JAX_FP32, jax.random.PRNGKey(7)))
    return _PARAMS["tree"]


def _torch_params():
    return params_from_numpy(_params(), FP32, device="cpu")


def engines(events=None, draft=False, **over):
    """(JaxEngine, TorchEngine) with the same config and weights; with
    `events` a dict, each engine's netted KV events land in its list."""
    kw = {**COMMON, **over}
    if draft:
        kw["spec_draft_config"] = JAX_FP32
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **kw))
    if draft:
        kw["spec_draft_config"] = FP32
    te = TorchEngine(EngineConfig(model_config=FP32, **kw),
                     params=_torch_params(), device="cpu",
                     draft_params=_torch_params() if draft else None)
    if events is not None:
        for name, eng in (("jax", je), ("torch", te)):
            events[name] = []
            eng.kv_event_sink = (lambda s, r, t, into=events[name]:
                                 into.append((list(s), list(r), t)))
        je._sink_takes_tier = True
    return je, te


async def serve(je, te, prompts, n, sampling=(0.0, 0, 1.0, 0)):
    """The prompts through both engines at once per engine; closes them
    and waits out each one's last step (`settled`).  Returns (jax
    streams, torch streams)."""
    out = []
    for eng, jax_side in ((je, True), (te, False)):
        try:
            out.append(list(await asyncio.gather(*[
                _collect(eng, _req(jax_side, p, f"r{i}", n, sampling))
                for i, p in enumerate(prompts)])))
            await asyncio.sleep(0.05)  # the sinks run on the loop thread
        finally:
            await eng.close()
            await settled(eng)
    return out


# seconds a closed engine's last scheduler step may still run
SETTLE_S = 60.0


async def settled(eng) -> None:
    """Wait out the scheduler step still running on a closed engine's
    thread.  The step that pushes a stream's last token books the spec
    counters and the spec_verify FPM record after the push, and JAX's
    close waits that step out only with KVBM on (dynamo_tpu/engine/
    core.py JaxEngine.close): read right after it, a busy host's JAX
    counters miss the last round (ROADMAP.md Queue 3 item 18)."""
    lock = eng._step_lock
    if not await asyncio.to_thread(lock.acquire, True, SETTLE_S):
        raise AssertionError(f"{type(eng).__name__}'s scheduler step was "
                             f"still running {SETTLE_S:.0f} s after close")
    lock.release()


def spec_counts(eng) -> dict:
    return {k: eng.metrics.get(k, 0)
            for k in ("spec_steps", "spec_proposed", "spec_accepted")}


def spec_records(eng) -> list:
    return [(r["lanes"], r["proposed"], r["accepted"], r["tokens"])
            for r in eng.fpm if r["kind"] == "spec_verify"]


async def plain_stream(prompt, n, **over):
    """The port's spec-off greedy stream."""
    te = TorchEngine(EngineConfig(model_config=FP32, **{**COMMON, **over}),
                     params=_torch_params(), device="cpu")
    try:
        return await _collect(te, _req(False, prompt, "plain", n))
    finally:
        await te.close()


# -- host-side pieces ------------------------------------------------------


def test_trim_blocks_matches_jax():
    """Grow, commit, trim and free through both allocators: the same
    block ids, free and evictable counts and events at every step,
    including a trim of a shared (prefix-hit) block and of a registered
    one."""
    allocs = [JaxAllocator(num_blocks=16), BlockAllocator(16)]

    def both(fn):
        res = [fn(a) for a in allocs]
        views = [(sorted(r.stored), sorted(r.removed),
                  getattr(r, "block_id", None)) if r is not None else None
                 for r in res]
        assert views[0] == views[1]
        assert [(a.num_free, a.num_evictable) for a in allocs][0] \
            == [(a.num_free, a.num_evictable) for a in allocs][1]
        return res

    both(lambda a: a.allocate("s", [], 2))
    for _ in range(3):
        both(lambda a: a.append_block("s"))
    both(lambda a: a.commit_block("s", 0, 111))
    both(lambda a: a.commit_block("s", 3, 444))
    both(lambda a: a.trim_blocks("s", 2))  # drops 444's block: removed
    assert allocs[0].seq_block_ids("s") == allocs[1].seq_block_ids("s")
    both(lambda a: a.allocate("t", [111], 2))  # shares block 0 of s
    both(lambda a: a.trim_blocks("t", 0))      # unpins the shared block
    both(lambda a: a.trim_blocks("missing", 0))
    both(lambda a: a.free("s"))
    both(lambda a: a.free("t"))
    assert allocs[1].num_free == 15 - allocs[1].num_evictable


def _fake_rows(rng, n, peaked=2.0, vocab=200):
    """[n, CAP] sorted scaled logits with ids out of a larger vocab, and
    a logsumexp over the whole vocab."""
    logits = rng.normal(0.0, peaked, size=(n, vocab))
    order = np.argsort(-logits, axis=1, kind="stable")[:, :CAP]
    vals = np.take_along_axis(logits, order, axis=1)
    lse = np.log(np.exp(logits).sum(axis=1))
    return order.astype(np.int64), vals.astype(np.float32), lse


def test_spec_accept_tokens_and_weights_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(60):
        k = 1 + trial % 4
        ids, vals, lse = _fake_rows(rng, k + 1, peaked=0.5 + trial % 3)
        greedy = trial % 5 == 0
        top_k = (0, 4, 20)[trial % 3]
        top_p = (1.0, 0.9, 0.5)[trial % 3]
        drafts = [int(ids[i, (0, 1, 3, 70)[(trial + i) % 4] % CAP])
                  for i in range(k)]
        for i in range(k + 1):
            np.testing.assert_array_equal(
                spec_window_weights(vals[i], lse[i], top_k, top_p),
                jax_weights(vals[i], lse[i], top_k, top_p))
        got = spec_accept_tokens(ids, vals, lse, drafts, greedy=greedy,
                                 top_k=top_k, top_p=top_p,
                                 rng=np.random.default_rng(trial))
        want = jax_accept(ids, vals, lse, drafts, greedy=greedy,
                          top_k=top_k, top_p=top_p,
                          rng=np.random.default_rng(trial))
        assert got == want


def test_ngram_proposer_matches_jax():
    rng = np.random.default_rng(3)
    for trial in range(200):
        mx = 1 + trial % 4
        mn = 1 + (trial // 4) % mx
        toks = list(map(int, rng.integers(0, 6, rng.integers(0, 40))))
        k = 1 + trial % 6
        assert NgramProposer(mx, mn).propose(toks, k) \
            == JaxNgram(mx, mn).propose(toks, k)
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=1, min_ngram=2)


def test_plan_spec_verify_matches_jax():
    rng = np.random.default_rng(5)

    def slot(ctx):
        table = np.zeros(16, np.int32)
        used = -(-(ctx + 5) // 4)
        table[:used] = rng.permutation(60)[:used] + 1
        return SimpleNamespace(
            ctx_len=ctx, last_token=int(rng.integers(0, 256)),
            block_table=table,
            request=SimpleNamespace(sampling=SimpleNamespace(
                temperature=float(rng.choice([0.0, 0.7])))))

    for n in (1, 2, 3):
        rows = [(slot(int(rng.integers(1, 40))),
                 list(map(int, rng.integers(0, 256, rng.integers(1, 5)))))
                for _ in range(n)]
        got = plan_spec_verify(rows, block_size=4, max_blocks_per_seq=16)
        want = jax_plan(rows, block_size=4, max_blocks_per_seq=16)
        assert (got.offsets, got.tokens, got.bucket) \
            == (want.offsets, want.tokens, want.bucket)
        assert sorted(got.arrays) == sorted(want.arrays)
        for name, a in want.arrays.items():
            np.testing.assert_array_equal(got.arrays[name], a)


# -- the model: spec_verify_packed and the draft's prefill ------------------


def _verify_stream():
    """Two verify rows (contexts 9 and 6, 3 and 5 tokens) packed into a
    16-token stream, over caches that hold their contexts."""
    toks = np.array([7, 8, 9, 31, 32, 33, 34, 35] + [0] * 8, np.int32)
    pos = np.array([9, 10, 11, 6, 7, 8, 9, 10] + [0] * 8, np.int32)
    seg = np.array([0] * 3 + [1] * 5 + [0] * 8, np.int32)
    valid = np.arange(16) < 8
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    return toks, pos, seg, valid, tables


def _filled_caches(rng, nb=8, bs=4):
    """Random fp32 K/V in the JAX layout (garbage block 0 included)."""
    shape = jl.kv_cache_shapes(JAX_FP32, nb, bs)[0]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_spec_verify_packed_matches_jax():
    params = _params()
    k0, v0 = _filled_caches(np.random.default_rng(1))
    toks, pos, seg, valid, tables = _verify_stream()
    jlog, jkv = jl.spec_verify_packed(
        jax.tree_util.tree_map(jnp.asarray, params), JAX_FP32,
        (jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(seg), jnp.asarray(tables),
        jnp.asarray(valid))
    tkv = kv_cache_from_numpy(k0, v0, device="cpu")
    tlog, tkv = tl.spec_verify_packed(
        _torch_params(), FP32, tkv,
        *(torch.from_numpy(a) for a in (toks, pos, seg, tables, valid)))
    assert tlog.shape == (16, FP32.vocab_size)
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid],
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(kv_cache_to_numpy(tkv), jkv):
        np.testing.assert_allclose(got[:, :, 1:],
                                   np.asarray(want)[:, :, 1:],
                                   rtol=1e-5, atol=1e-5)


def test_spec_verify_packed_matches_own_prefill_packed():
    """tests/test_speculative.py:86 on the port: the verify program is
    prefill_packed minus the last-token gather."""
    toks, pos, seg, valid, tables = _verify_stream()
    pos = np.where(valid, pos - pos[[0, 0, 0, 3, 3, 3, 3, 3] + [0] * 8],
                   0).astype(np.int32)  # two prompts from position 0
    last = np.array([2, 7], np.int32)
    t = [torch.from_numpy(a) for a in (toks, pos, seg, tables)]
    shape = tl.kv_cache_shapes(FP32, 8, 4)[0]
    kv_a = (torch.zeros(shape), torch.zeros(shape))
    kv_b = (torch.zeros(shape), torch.zeros(shape))
    params = _torch_params()
    lg_a, _ = tl.prefill_packed(params, FP32, kv_a, *t,
                                torch.from_numpy(last),
                                torch.from_numpy(valid))
    lg_b, _ = tl.spec_verify_packed(params, FP32, kv_b, *t,
                                    torch.from_numpy(valid))
    for i in range(2):
        torch.testing.assert_close(lg_b[last[i]], lg_a[i], rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(kv_a, kv_b):
        assert torch.equal(a, b)


BF16 = (jl.LlamaConfig(name="tiny-gqa-bf16", n_heads=8, n_kv_heads=2,
                       head_dim=8, vocab_size=256, d_model=64, n_layers=2,
                       ffn_dim=128),
        tl.LlamaConfig(name="tiny-gqa-bf16", n_heads=8, n_kv_heads=2,
                       head_dim=8, vocab_size=256, d_model=64, n_layers=2,
                       ffn_dim=128))


@pytest.mark.parametrize("case", ["fp32", "fp32-int8", "bf16"])
def test_prefill_matches_jax(case):
    """The draft's catch-up: two chunks of one sequence (7 tokens, then 5
    after them) through prefill, on a float cache (fp32, bf16 model) and
    an int8 one (fp32 model: the bf16 model's one-ulp K/V differences
    move int8 codes across half steps).  Logits within 1e-5 (fp32) or
    two bf16 ulps (3e-2, as tests/test_torch_model.py); caches likewise,
    int8 codes within one step."""
    jcfg, tcfg = (JAX_FP32, FP32) if case.startswith("fp32") else BF16
    int8 = case.endswith("int8")
    tol = dict(rtol=1e-5, atol=1e-5) if case.startswith("fp32") \
        else dict(rtol=0, atol=3e-2)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jparams), tcfg, device="cpu")
    nb, bs = 8, 4
    shape = jl.kv_cache_shapes(jcfg, nb, bs)[0]
    if int8:
        sshape = jl.kv_cache_scale_shapes(jcfg, nb, bs)[0]
        jkv = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
               jnp.zeros(sshape), jnp.zeros(sshape))
        tkv = tuple(torch.zeros(s, dtype=torch.int8)
                    for s in tl.kv_cache_shapes(tcfg, nb, bs)) + tuple(
            torch.zeros(s) for s in tl.kv_cache_scale_shapes(tcfg, nb, bs))
    else:
        jkv = (jnp.zeros(shape, jcfg.dtype), jnp.zeros(shape, jcfg.dtype))
        tkv = tuple(torch.zeros(s, dtype=tcfg.dtype)
                    for s in tl.kv_cache_shapes(tcfg, nb, bs))
    table = np.array([3, 1, 6, 2, 0, 0], np.int32)
    prompt = [5, 9, 13, 2, 7, 11, 3, 40, 41, 42, 43, 44]
    for ctx, chunk in ((0, 7), (7, 5)):
        toks = np.zeros(8, np.int32)
        toks[:chunk] = prompt[ctx:ctx + chunk]
        pos = ctx + np.arange(8, dtype=np.int32)
        jlog, jkv = jl.prefill(jparams, jcfg, jkv, jnp.asarray(toks),
                               jnp.asarray(pos), jnp.asarray(table),
                               jnp.int32(ctx), jnp.int32(chunk))
        tlog, tkv = tl.prefill(tparams, tcfg, tkv, torch.from_numpy(toks),
                               torch.from_numpy(pos),
                               torch.from_numpy(table), ctx, chunk)
        np.testing.assert_allclose(tlog.float().numpy(), np.asarray(jlog),
                                   **tol)
    for i, (got, want) in enumerate(zip(kv_cache_to_numpy(tkv), jkv)):
        got, want = got[:, :, 1:], np.asarray(want, np.float32
                                              if i >= 2 or not int8
                                              else np.int8)[:, :, 1:]
        if int8 and i < 2:
            np.testing.assert_allclose(got.astype(np.int32),
                                       want.astype(np.int32), rtol=0, atol=1)
        else:
            np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_catchup_program_writes_what_prefill_writes(int8):
    """The draft's catch-up program (engine/graphs.py CatchupPrograms,
    its body eager on the CPU: one packed segment, the start position and
    length in its descriptor) writes the draft cache that models/llama.py
    prefill writes, two chunks of one sequence (7 tokens, then 5 after
    them, bucket 8 both times) on an fp32 model.  Each position's K and V
    vectors within a relative L2 error of 1e-5 (the two attentions sum in
    another order; 5.6e-7 measured), or 3e-2 dequantized on an int8 cache
    (1.5e-2 measured): the packed body attends to its own chunk through
    the int8 cache, as the engine's packed prefill and JAX's do, where
    prefill attends to the fresh K/V, so the second layer's inputs differ
    by a quantization step (up to 1/127 of a row's largest value)."""
    from dynamo_tpu_torch.engine.graphs import CatchupPrograms

    tparams = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jl.init_params(JAX_FP32, jax.random.PRNGKey(3))), FP32,
        device="cpu")
    nb, bs, mb = 8, 4, 6
    if int8:
        kv = tuple(torch.zeros(s, dtype=torch.int8)
                   for s in tl.kv_cache_shapes(FP32, nb, bs)) + tuple(
            torch.zeros(s) for s in tl.kv_cache_scale_shapes(FP32, nb, bs))
    else:
        kv = tuple(torch.zeros(s) for s in tl.kv_cache_shapes(FP32, nb, bs))
    ref = tuple(t.clone() for t in kv)
    progs = CatchupPrograms(tparams, FP32, kv, 1, mb, (8, 16),
                            torch.device("cpu"))
    table = np.array([3, 1, 6, 2, 0, 0], np.int32)
    prompt = [5, 9, 13, 2, 7, 11, 3, 40, 41, 42, 43, 44]
    for ctx, chunk in ((0, 7), (7, 5)):
        a = progs.host_descriptor(8)
        a["toks"][:chunk] = prompt[ctx:ctx + chunk]
        a["positions"][:chunk] = np.arange(ctx, ctx + chunk)
        a["valid"][:chunk] = True
        a["tables"][0] = table
        assert progs.run(progs.upload(a)) is None
        toks = np.zeros(8, np.int32)
        toks[:chunk] = prompt[ctx:ctx + chunk]
        tl.prefill(tparams, FP32, ref, torch.from_numpy(toks),
                   torch.from_numpy(ctx + np.arange(8, dtype=np.int32)),
                   torch.from_numpy(table), ctx, chunk)
    assert progs.counts == {8: 1}
    if int8:
        # per position, the dequantized K and V vectors
        kv = [c.float() * s[..., None] for c, s in zip(kv[:2], kv[2:])]
        ref = [c.float() * s[..., None] for c, s in zip(ref[:2], ref[2:])]
    for got, want in zip(kv, ref):
        # block 0 is the garbage block either side may write
        got, want = got[:, :, 1:].float(), want[:, :, 1:].float()
        err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp(min=1e-9)
        assert float(err.max()) <= (3e-2 if int8 else 1e-5)
        assert float(got.abs().max()) > 0


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_prefill_attention_matches_jax(int8):
    """The chunk's own K/V at full precision, the cached context (random,
    bf16 or int8 codes with their scales) through the table, masked at
    ctx_len; rows past true_len pad."""
    rng = np.random.default_rng(9)
    L, nkv, nb, bs, hd, nh, T = 2, 2, 6, 4, 8, 4, 8
    q = rng.standard_normal((T, nh, hd)).astype(np.float32)
    k = rng.standard_normal((T, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((T, nkv, hd)).astype(np.float32)
    table = np.array([4, 2, 5, 0], np.int32)
    if int8:
        kc = rng.integers(-127, 128, (L, nkv, nb, hd, bs)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, nkv, nb, hd, bs)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, nkv, nb, bs)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, nkv, nb, bs)).astype(np.float32)
        jcache = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkv = kv_cache_from_numpy(kc, vc, device="cpu", k_scale=ks,
                                  v_scale=vs)
        tcache = dict(k_scale=tkv[2], v_scale=tkv[3])
    else:
        kc = rng.standard_normal((L, nkv, nb, hd, bs)).astype(np.float32)
        vc = rng.standard_normal((L, nkv, nb, hd, bs)).astype(np.float32)
        kc, vc = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in (kc, vc))
        jcache, tcache = {}, {}
        tkv = kv_cache_from_numpy(kc, vc, device="cpu",
                                  dtype=torch.bfloat16)
    jkc = jnp.asarray(kc) if int8 else jnp.asarray(kc, jnp.bfloat16)
    jvc = jnp.asarray(vc) if int8 else jnp.asarray(vc, jnp.bfloat16)
    for ctx, true_len in ((5, 8), (9, 3), (0, 6)):
        want = jpa.paged_prefill_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jkc, jvc, 1,
            jnp.asarray(table), jnp.int32(ctx), jnp.int32(true_len),
            **jcache)
        got = tpa.paged_prefill_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tkv[0], tkv[1], 1, torch.from_numpy(table), ctx, true_len,
            **tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# -- engines: TorchEngine against JaxEngine --------------------------------


async def test_ngram_greedy_streams_counters_records_events_match_jax():
    """One repetition request through both spec engines: the stream
    equals JAX's and the port's spec-off stream; spec counters, the
    spec_verify FPM records' sequence and the netted KV events equal
    JAX's; every record carries the planner's keys and the verify
    program's cost count (xla_flops/xla_bytes, obs/costs.py)."""
    events = {}
    je, te = engines(events, spec_decode="ngram", spec_k=4)
    assert te.spec_enabled and je.spec_enabled
    (jres,), (tres,) = await serve(je, te, [REPEAT_PROMPT], 96)
    assert tres == jres == await plain_stream(REPEAT_PROMPT, 96)
    assert spec_counts(te) == spec_counts(je)
    assert spec_counts(te)["spec_accepted"] > 0
    assert spec_records(te) == spec_records(je) and spec_records(te)
    for r in te.fpm:
        if r["kind"] == "spec_verify":
            assert {"proposed", "accepted", "lanes", "gap_s"} <= set(r)
            assert r["xla_flops"] > 0 and r["xla_bytes"] > 0
    assert events["torch"] == events["jax"] and len(events["torch"]) > 3
    assert te.verify_graphs.counts  # the bucket programs ran (eagerly)


async def test_draft_equals_target_matches_jax():
    """Draft == target (same config and weights): streams equal spec-off,
    and the acceptance counts equal JAX's (a count that differed would
    come from an fp32 near-tie between the decode and verify programs;
    none occurs on this stream)."""
    je, te = engines(draft=True, spec_decode="draft", spec_k=4)
    (jres,), (tres,) = await serve(je, te, [REPEAT_PROMPT], 48)
    assert tres == jres == await plain_stream(REPEAT_PROMPT, 48)
    assert spec_counts(te) == spec_counts(je)
    m = spec_counts(te)
    assert m["spec_proposed"] > 0
    assert m["spec_accepted"] >= m["spec_proposed"] // 2
    assert te.proposer.metrics["catchup_dispatches"] > 0
    # every catch-up ran through a bucket's program
    assert te.proposer.catchup.counts


async def test_draft_catchup_programs_built_by_warmup_only():
    """Warm-up builds every catch-up program (one per prefill bucket)
    beside the propose bursts; serving catch-ups build none, and the
    stream and spec counters equal JAX's."""
    je, te = engines(draft=True, spec_decode="draft", spec_k=4)
    await asyncio.to_thread(te.warmup_decode)
    built = (dict(te.proposer.catchup.counts),
             dict(te.proposer.programs.counts))
    assert built[0] == {T: 1 for T in COMMON["prefill_buckets"]}
    assert built[1] == {(True, k): 1 for k in range(1, 5)}
    (jres,), (tres,) = await serve(je, te, [RANDOM_PROMPT + REPEAT_PROMPT],
                                   32)
    assert tres == jres
    assert spec_counts(te) == spec_counts(je)
    assert te.proposer.metrics["catchup_dispatches"] > 1
    assert (te.proposer.catchup.counts, te.proposer.programs.counts) == built


async def test_sampled_spec_streams_match_jax():
    """Seeded sampled requests (T 0.2, where this tiny model's argmax
    carries enough mass for some drafts to be accepted) under the draft
    proposer and the n-gram one: the same host RNG stream (keyed by seed
    and position) accepts, rejects and draws the same tokens as JAX's;
    another seed gives another stream."""
    for proposer, seed, n in (("draft", 42, 24), ("ngram", 9, 48)):
        je, te = engines(draft=proposer == "draft", spec_decode=proposer)
        jres, tres = await serve(je, te, [REPEAT_PROMPT], n,
                                 (0.2, 0, 1.0, seed))
        assert tres == jres
        assert spec_counts(te) == spec_counts(je)
        m = spec_counts(te)
        assert 0 < m["spec_accepted"] < m["spec_proposed"] or \
            proposer == "ngram" and m["spec_steps"] > 0
        if proposer == "draft":
            other = TorchEngine(
                EngineConfig(model_config=FP32, spec_decode="draft",
                             spec_draft_config=FP32, **COMMON),
                params=_torch_params(), device="cpu",
                draft_params=_torch_params())
            try:
                assert await _collect(other, _req(
                    False, REPEAT_PROMPT, "o", n, (0.2, 0, 1.0, 9))) != tres
            finally:
                await other.close()


async def test_adaptive_collapse_uses_jax_dispatch_count():
    """tests/test_speculative.py:193: a proposer that only drafts garbage
    collapses k to 0; the backed-off probes give the same number of
    verify dispatches as JAX's, and the stream stays plain decode's."""
    class HostileProposer:
        def propose(self, tokens, k, **kw):
            return [251] * k

    je, te = engines(spec_decode="ngram", spec_k=4, spec_probe_interval=64)
    je.proposer = te.proposer = HostileProposer()
    (jres,), (tres,) = await serve(je, te, [RANDOM_PROMPT], 64)
    assert tres == jres == await plain_stream(RANDOM_PROMPT, 64)
    assert spec_counts(te) == spec_counts(je)
    assert spec_counts(te)["spec_steps"] <= 12


async def test_spec_then_plain_decode_does_not_chain_stale_tokens():
    """tests/test_speculative.py:226 on the port: two concurrent greedy
    streams, fused bursts and intermittent speculation; after a slot
    speculates, the next burst uploads its true last token."""
    rng = np.random.default_rng(17)
    prompts = [list(map(int, rng.integers(1, 250, 32))) for _ in range(2)]
    kw = dict(max_num_seqs=2, decode_fused_steps=8, block_size=16,
              num_blocks=64, max_blocks_per_seq=16, prefill_buckets=(16, 32))
    je, te = engines(spec_decode="ngram", spec_k=4, **kw)
    jres, tres = await serve(je, te, prompts, 96)
    plain = TorchEngine(EngineConfig(model_config=FP32, **{**COMMON, **kw}),
                        params=_torch_params(), device="cpu")
    try:
        expect = list(await asyncio.gather(*[
            _collect(plain, _req(False, p, f"p{i}", 96))
            for i, p in enumerate(prompts)]))
    finally:
        await plain.close()
    assert tres == expect == jres
    assert te.metrics["spec_steps"] > 0


async def test_kv_rollback_accounting_matches_plain_and_jax():
    """tests/test_speculative.py:342: right after every verify round each
    speculating slot holds exactly the blocks its materialized context
    needs (the rejected drafts' growth rolled back), in both engines,
    round for round; after serving, the free and evictable counts equal
    plain decode's and JAX's spec engine's."""
    je, te = engines(spec_decode="ngram", spec_k=4)
    held = {"jax": [], "torch": []}
    for name, eng in (("jax", je), ("torch", te)):
        def step(eng=eng, into=held[name], inner=eng._spec_step):
            inner()
            into.extend(
                (len(eng.allocator.seq_block_ids(s.request.request_id)),
                 max(-(-s.ctx_len // eng.config.block_size), 1))
                for s in eng._slots
                if s is not None and s.index in eng._specced)
        eng._spec_step = step
    await serve(je, te, [REPEAT_PROMPT], 96)
    assert held["torch"] == held["jax"] and held["torch"]
    assert all(n == need for n, need in held["torch"])
    plain = TorchEngine(EngineConfig(model_config=FP32, **COMMON),
                        params=_torch_params(), device="cpu")
    try:
        await _collect(plain, _req(False, REPEAT_PROMPT, "p", 96))
    finally:
        await plain.close()
    assert te.metrics["spec_proposed"] > te.metrics["spec_accepted"]
    counts = [(e.allocator.num_free, e.allocator.num_evictable)
              for e in (te, plain, je)]
    assert counts[0] == counts[1] == counts[2]


async def test_preemption_mid_spec_matches_jax():
    """13 usable blocks of 4 for three repetition streams under n-gram
    speculation: verify growth and decode bursts run out of blocks,
    slots are preempted and replayed (draft_pos reset), and the streams
    still equal JAX's spec engine's and the port's spec-off streams."""
    prompts = [[5, 9, 13, 2] * 3, [7, 1, 7, 1] * 3, [3, 3, 8, 8] * 3]
    kw = dict(num_blocks=14)
    je, te = engines(spec_decode="ngram", spec_k=4, **kw)
    jres, tres = await serve(je, te, prompts, 20)
    assert te.metrics["preemptions"] > 0 and te.metrics["spec_steps"] > 0
    assert tres == jres
    plain = TorchEngine(EngineConfig(model_config=FP32, **{**COMMON, **kw}),
                        params=_torch_params(), device="cpu")
    try:
        expect = list(await asyncio.gather(*[
            _collect(plain, _req(False, p, f"p{i}", 20))
            for i, p in enumerate(prompts)]))
    finally:
        await plain.close()
    assert tres == expect


async def test_int8_cache_ngram_matches_jax():
    je, te = engines(spec_decode="ngram", spec_k=4, kv_cache_dtype="int8")
    (jres,), (tres,) = await serve(je, te, [REPEAT_PROMPT], 64)
    assert tres == jres
    assert tres == await plain_stream(REPEAT_PROMPT, 64,
                                      kv_cache_dtype="int8")
    assert spec_counts(te) == spec_counts(je)
    assert len(te.kv) == 4 and spec_counts(te)["spec_steps"] > 0


def test_spec_config():
    """Unknown proposers raise the JAX engine's ValueError; a draft needs a
    source and the target's vocab; "off" is the default."""
    with pytest.raises(ValueError) as want:
        JaxEngine(JaxEngineConfig(model_config=JAX_FP32, num_blocks=16,
                                  spec_decode="bogus"))
    with pytest.raises(ValueError) as got:
        EngineConfig(model_config=FP32, num_blocks=16, spec_decode="bogus")
    assert str(got.value) == str(want.value)
    assert EngineConfig().spec_decode == "off"
    assert not TorchEngine(EngineConfig(model_config=FP32, num_blocks=16),
                           params=_torch_params(),
                           device="cpu").spec_enabled
    with pytest.raises(ValueError, match="needs spec_draft_config"):
        TorchEngine(EngineConfig(model_config=FP32, num_blocks=16,
                                 spec_decode="draft"),
                    params=_torch_params(), device="cpu")
    small = tl.LlamaConfig(dtype=torch.float32, **{**SHAPES,
                                                   "vocab_size": 128})
    with pytest.raises(ValueError, match="draft vocab"):
        TorchEngine(EngineConfig(model_config=FP32, num_blocks=16,
                                 spec_decode="draft",
                                 spec_draft_config=small),
                    params=_torch_params(), device="cpu")

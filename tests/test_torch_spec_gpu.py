"""Speculative decoding's verify programs and K3 at verify shapes, on a
card.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_spec_gpu.py

* A replayed verify bucket (engine/graphs.py VerifyPrograms) writes what
  its eager body writes, bit for bit: candidate ids, values and lse.
* K3 at the verify shape (4 rows x 5 tokens at contexts 1800/500/100/37,
  one 32-token stream) agrees with its plain version within the per-row
  relative L2 bound of chip_smoke.py (1e-2), bf16 and int8.
* Serving under spec_decode="ngram" speculates and builds no program:
  warm-up captured every decode, prefill and verify program and the
  draft-free engine's counts stay as warm-up left them.
* Serving under spec_decode="draft" (the tiny preset as its own draft)
  builds no draft program either: warm-up captured the draft's propose
  bursts and one catch-up program per prefill bucket, and every
  catch-up ran from them.
"""

import asyncio
import math

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

VERIFY_LENS = (1800, 500, 100, 37)
REL_TOL = 1e-2


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _engine(**over):
    kw = dict(model="tiny", block_size=128, num_blocks=96,
              max_blocks_per_seq=16, max_num_seqs=4, spec_decode="ngram")
    kw.update(over)
    return TorchEngine(EngineConfig(**kw), device="cuda")


@pytest.mark.gpu
def test_verify_replay_equals_eager_on_gpu():
    _needs_card()
    eng = _engine()
    eng.warmup_decode()
    g = eng.verify_graphs
    assert g.counts == {T: 1 for T in g.buckets} and 32 in g.buckets
    a = g.host_descriptor(32)
    rng = np.random.default_rng(3)
    nxt, off = 1, 0
    for row, ctx in enumerate(VERIFY_LENS):
        need = -(-(ctx + 5) // 128)
        a["tables"][row, :need] = np.arange(nxt, nxt + need)
        nxt += need
        a["toks"][off:off + 5] = rng.integers(0, 32000, 5)
        a["positions"][off:off + 5] = ctx + np.arange(5)
        a["seg_ids"][off:off + 5] = row
        a["valid"][off:off + 5] = True
        a["temps_t"][off:off + 5] = 0.7 if row == 1 else 0.0
        off += 5
    g.upload(a)
    eager = [t.clone() for t in g.run_eager(32)]
    for _ in range(2):
        g.upload(a)
        replay = g.run(32)
        torch.cuda.synchronize()
        for r, e in zip(replay, eager):
            assert torch.equal(r, e)
    assert g.counts == {T: 1 for T in g.buckets}


def _row_rel_err(out, ref):
    out, ref = out.float(), ref.float()
    den = ref.norm(dim=-1)
    live = den > 0
    return ((out - ref).norm(dim=-1)[live] / den[live]).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k3_at_verify_shape_matches_plain_on_gpu(int8):
    """llama-8b heads (32 over 8, hd 128) and blocks of 128."""
    _needs_card()
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
    from dynamo_tpu_torch.ops.packed_prefill import (
        packed_prefill_attention_ref,
    )
    from dynamo_tpu_torch.quant.kv import quantize_tokens

    dev = torch.device("cuda")
    nh, nkv, hd, bs, T = 32, 8, 128, 128, 32
    need = [-(-(c + 5) // bs) for c in VERIFY_LENS]
    nb = 1 + sum(need)
    gen = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn(1, nkv, nb, bs, hd, generator=gen, device=dev)
    v = torch.randn(1, nkv, nb, bs, hd, generator=gen, device=dev)
    tables = torch.zeros(4, 16, dtype=torch.int32)
    seg = torch.zeros(T, dtype=torch.int32)
    pos = torch.zeros(T, dtype=torch.int32)
    valid = torch.zeros(T, dtype=torch.bool)
    nxt = 1
    for row, (ctx, n) in enumerate(zip(VERIFY_LENS, need)):
        tables[row, :n] = torch.arange(nxt, nxt + n)
        nxt += n
        seg[row * 5:row * 5 + 5] = row
        pos[row * 5:row * 5 + 5] = ctx + torch.arange(5)
        valid[row * 5:row * 5 + 5] = True
    args = [t.to(dev) for t in (tables, seg, pos, valid)]
    q = torch.randn(T, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    if int8:
        (kq, ks), (vq, vs) = quantize_tokens(k), quantize_tokens(v)
        cache = (kq, vq, ks, vs)
        out = k3.packed_prefill_int8(q, *cache, 0, *args)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        cache = (k.to(torch.bfloat16), v.to(torch.bfloat16))
        out = k3.packed_prefill(q, *cache, 0, *args)
        scales = {}
    ref = packed_prefill_attention_ref(q, cache[0], cache[1], 0, *args,
                                       round_scaled_q=True, **scales)
    torch.cuda.synchronize()
    assert _row_rel_err(out[valid.to(dev)], ref[valid.to(dev)]) <= REL_TOL
    assert bool((out[~valid.to(dev)] == 0).all())
    assert math.isfinite(out.float().abs().max().item())


@pytest.mark.gpu
def test_spec_serving_builds_no_program_on_gpu():
    _needs_card()
    asyncio.run(_serve_spec())


async def _serve_spec():
    eng = _engine()
    await asyncio.to_thread(eng.warmup_decode)
    built = (dict(eng.graphs.counts), dict(eng.prefill_graphs.counts),
             dict(eng.verify_graphs.counts))
    pattern = list(np.random.default_rng(2).integers(0, 32000, 64))
    reqs = [PreprocessedRequest(
        token_ids=[int(t) for t in pattern * 4][i:], request_id=f"s{i}",
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=48, ignore_eos=True))
        for i in range(3)]

    async def one(r):
        toks = []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
        return toks

    try:
        outs = await asyncio.gather(*[one(r) for r in reqs])
    finally:
        await eng.close()
    assert all(len(t) == 48 for t in outs)
    assert eng.metrics.get("spec_steps", 0) > 0
    assert (eng.graphs.counts, eng.prefill_graphs.counts,
            eng.verify_graphs.counts) == built


@pytest.mark.gpu
def test_draft_serving_builds_no_program_on_gpu():
    _needs_card()
    asyncio.run(_serve_draft())


async def _serve_draft():
    from dynamo_tpu_torch.models.llama import PRESETS

    eng = _engine(spec_decode="draft", spec_draft_config=PRESETS["tiny"])
    await asyncio.to_thread(eng.warmup_decode)
    cp = eng.proposer.catchup
    built = (dict(eng.proposer.programs.counts), dict(cp.counts))
    assert built[1] == {T: 1 for T in cp.buckets}
    assert built[0] == {(True, k): 1 for k in range(1, 5)}
    rng = np.random.default_rng(3)
    reqs = [PreprocessedRequest(
        token_ids=[int(t) for t in rng.integers(0, 32000, n)],
        request_id=f"d{i}", sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=24, ignore_eos=True))
        for i, n in enumerate((300, 40, 7))]

    async def one(r):
        toks = []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
        return toks

    try:
        outs = await asyncio.gather(*[one(r) for r in reqs])
    finally:
        await eng.close()
    assert all(len(t) == 24 for t in outs)
    assert eng.metrics.get("spec_steps", 0) > 0
    assert eng.proposer.metrics["catchup_dispatches"] > 0
    assert (dict(eng.proposer.programs.counts), dict(cp.counts)) == built

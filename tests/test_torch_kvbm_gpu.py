"""KVBM offload and onboard on a card (engine/core.py, ops/kv_transfer.py).

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_kvbm_gpu.py

The offload must stay off the critical path of the captured decode
bursts: with k = 8 bursts in flight, an offload pass makes no
synchronizing CUDA call, and its copies still read the blocks before a
later write to them (stream order).  Offload then onboard is bit-exact on
bf16 and int8 caches, and serving with onboards between decode replays
captures no program again.
"""

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.ops.kv_transfer import blocks_from_host, blocks_to_host
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

BS = 128


def _engine(**kw) -> TorchEngine:
    cfg = dict(model="tiny", block_size=BS, num_blocks=24,
               max_blocks_per_seq=8, max_num_seqs=4, host_cache_blocks=32,
               offload_watermark_blocks=64)
    cfg.update(kw)
    return TorchEngine(EngineConfig(**cfg), device="cuda")


def _req(tokens, rid, n=8):
    return PreprocessedRequest(
        token_ids=list(tokens), request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=n, ignore_eos=True))


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        toks.extend(out.token_ids)
    return toks


def _prompt(seed, n=3 * BS + 10):
    return np.random.default_rng(seed).integers(0, 32000, n).tolist()


@pytest.mark.gpu
def test_offload_with_bursts_in_flight_never_synchronizes_on_gpu():
    """On a card: sixteen k = 8 decode bursts queued, then an offload pass
    under torch.cuda.set_sync_debug_mode("error"): no synchronizing call,
    nothing committed yet; the blocks are then overwritten on the stream,
    and what lands in G2 is what the blocks held before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    eng = _engine()
    eng.warmup_decode()

    async def run():
        await _collect(eng, _req(_prompt(1), "a"))  # evictable blocks
        with eng._step_lock:  # the idle loop stays out of the way
            cands = eng.allocator.coldest_evictable(16)
            assert len(cands) >= 3 and not eng._offloading
            before = blocks_to_host(eng.kv, [b for _, b in cands])
            ids = torch.tensor([b for _, b in cands], device="cuda")
            torch.cuda.synchronize()
            d = eng.graphs.host_descriptor()
            d["tokens"][:2], d["positions"][:2] = (7, 9), (40, 12)
            d["ctx_lens"][:2], d["steps"][:2] = (40, 12), 1
            d["valid"][:2] = True
            d["tables"][0, :1], d["tables"][1, :1] = 20, 21  # not offloaded
            eng.graphs.upload(d)
            for _ in range(16):
                eng.graphs.run(True, 8)
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._maybe_offload()
                for t in eng.kv:  # a later write to the offloaded blocks
                    t.index_fill_(2, ids, 0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            in_flight = bool(eng._offloading)
            early = [h for h, _ in cands if h in eng.kvbm.g2]
            torch.cuda.synchronize()
            eng._commit_offloads()
        await eng.close()
        return cands, before, in_flight, early

    cands, before, in_flight, early = asyncio.run(run())
    assert in_flight and not early  # committed at a later step
    assert not eng._offloading
    for (h, _), want in zip(cands, before):
        got = eng.kvbm.g2.get(h)
        assert got is not None and all(t.is_pinned() for t in got)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert eng.kvbm.stats["offloaded"] >= len(cands)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_offload_then_onboard_is_bit_exact_on_gpu(kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    eng = _engine(kv_cache_dtype=kv_dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in eng.kv:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device="cuda", dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    src, dst = [3, 9, 4], [11, 2, 17]
    blocks = blocks_to_host(eng.kv, src)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    assert all(t.is_pinned() for b in blocks for t in b)
    assert len(blocks[0]) == (4 if kv_dtype == "int8" else 2)
    # a pageable copy (a block read back from disk) uploads the same
    pageable = [tuple(t.clone() for t in b) for b in blocks[1:]]
    blocks_from_host(eng.kv, [blocks[0]] + pageable, dst)
    torch.cuda.synchronize()
    for t in eng.kv:
        for s, d in zip(src, dst):
            assert torch.equal(t[:, :, d], t[:, :, s])


@pytest.mark.gpu
def test_onboard_between_decode_replays_captures_nothing_on_gpu():
    """On a card: a prompt pushed out of G1 by churn comes back from G2
    on its repeat (blocks onboarded, the tail alone prefilled) after the
    churn's decode replays, with the greedy tokens of a repeat that hit
    the same blocks in G1, and every program stays captured once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

    # 15 usable blocks: the churn's 18 registered blocks push A's 3 out
    eng = _engine(num_blocks=16)
    eng.warmup_decode()
    dec, pre = dict(eng.graphs.counts), dict(eng.prefill_graphs.counts)
    a = _prompt(1)
    a_hashes = compute_block_hashes_for_request(a, BS)[:3]

    async def run():
        await _collect(eng, _req(a, "a1"))
        ref = await _collect(eng, _req(a, "a2"))  # a G1 prefix hit
        churn = [asyncio.create_task(_collect(eng, _req(_prompt(10 + i),
                                                        f"c{i}", 24)))
                 for i in range(6)]
        for t in churn:
            await t
        evicted = eng.allocator.lookup(a_hashes) == 0
        before = eng.metrics["prefill_tokens"]
        again = await _collect(eng, _req(a, "a3"))
        prefilled = eng.metrics["prefill_tokens"] - before
        await eng.close()
        return ref, again, evicted, prefilled

    ref, again, evicted, prefilled = asyncio.run(run())
    assert evicted, "the prompt kept a block in G1"
    assert again == ref
    assert eng.metrics["kv_onboard_g2"] == 3 and prefilled == 10
    assert eng.graphs.counts == dec == {k: 1 for k in dec}
    assert eng.prefill_graphs.counts == pre == {k: 1 for k in pre}

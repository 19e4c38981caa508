"""Sequence parallelism on a card: ring attention over two ranks of
cuda:0 (threads over a gloo ring group, which stages every shard through
the host) at llama-8b's head counts against the plain version, and an
sp=2 TorchEngine (rank 1 spawned, both ranks on cuda:0, eager) whose
long prompt takes the ring prefill and whose decode and short-prompt
prefill launch K1 and K3 on both ranks alike.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_sp_gpu.py
"""

import asyncio
import dataclasses
import datetime
import threading

import pytest
import torch
import torch.distributed as dist

from dynamo_tpu_torch.models.llama import PRESETS
from dynamo_tpu_torch.ops.ring_attention import (
    attention_reference,
    ring_attention,
)
from dynamo_tpu_torch.parallel.mesh import RingGroup

CFG = PRESETS["llama-8b"]
REL_TOL = 1e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ring_threads(sp: int, body) -> list:
    store = dist.HashStore()
    out, errs = [None] * sp, []

    def run(r):
        try:
            torch.cuda.set_device(0)
            pg = dist.ProcessGroupGloo(dist.PrefixStore("sp", store), r, sp,
                                       datetime.timedelta(seconds=60))
            out[r] = body(RingGroup("gloo", pg, r, sp))
        except BaseException as e:  # re-raised on the test's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


@pytest.mark.gpu
def test_ring_attention_on_gpu_equals_plain():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, sp = 2048, 2
    q, k, v = (torch.randn(1, T, h, CFG.head_dim, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for h in (CFG.n_heads, CFG.n_kv_heads, CFG.n_kv_heads))
    ref = attention_reference(q, k, v)
    tq = T // sp
    seen = [[] for _ in range(sp)]

    def body(ring):
        s = ring.rank
        return ring_attention(
            q[:, s * tq:(s + 1) * tq], k[:, s * tq:(s + 1) * tq],
            v[:, s * tq:(s + 1) * tq], ring,
            on_shard=lambda src, ks, vs: seen[s].append(src))

    out = torch.cat(_ring_threads(sp, body), dim=1)
    assert out.dtype == torch.bfloat16 and out.is_cuda
    o, r = out.float().flatten(2), ref.float().flatten(2)
    rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-6)).max()
    assert rel.item() <= REL_TOL
    # each rank saw its own shard first, then the others in ring order
    assert seen == [[0, 1], [1, 0]]


@pytest.mark.gpu
def test_sp2_engine_on_gpu_rings_and_launches_on_both_ranks():
    _cuda()
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.ops import launch_counts
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    # the tiny preset's widths (hd 64, which the kernels take), bf16
    mc = dataclasses.replace(PRESETS["tiny"], n_layers=2)
    cfg = EngineConfig(model_config=mc, sp=2, block_size=64,
                       max_blocks_per_seq=32, num_blocks=128,
                       max_num_seqs=2, prefill_buckets=(32, 64, 128))

    def req(n, rid):
        return PreprocessedRequest(
            token_ids=[(7 * i) % 3000 + 1 for i in range(n)],
            request_id=rid, sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=8, ignore_eos=True))

    async def collect(eng, r):
        toks = []
        async for out in eng.generate(r):
            toks.extend(out.token_ids)
        return toks

    async def run():
        before = launch_counts()
        eng = TorchEngine(cfg, devices=["cuda:0", "cuda:0"],
                          cuda_graphs=False, mesh_timeout_s=120)
        try:
            long = await collect(eng, req(600, "long"))
            assert eng.metrics["ring_prefills"] == 1
            short = await collect(eng, req(40, "short"))
            assert eng.metrics["ring_prefills"] == 1
        finally:
            await eng.close()
        mine = {k: v - before[k] for k, v in launch_counts().items()}
        return long, short, mine, eng

    long, short, mine, eng = asyncio.run(run())
    assert len(long) == len(short) == 8
    for name in ("paged_decode", "packed_prefill"):
        assert mine[name] > 0 and eng.rank_launches[1][name] == mine[name]
    assert len(eng.ring_calls_ms) == 1 and eng.ring_calls_ms[0] > 0
    assert len(eng.rank_metrics[1]["ring_calls_ms"]) == 1
    # each rank sent its K/V shard once a layer (T_pad 1024, Tq 512, bf16);
    # rank 1, which holds the last prompt row, also sent that row
    kv = mc.n_layers * 2 * 512 * mc.n_kv_heads * mc.head_dim * 2
    assert eng.metrics["ring_bytes"] == kv
    assert eng.rank_metrics[1]["ring_bytes"] == kv + mc.d_model * 2

"""K1 and K3 at a tp=2 rank's slab on a card (ops/paged_attention.py
paged_attention_decode_tp, ops/packed_prefill.py
packed_prefill_attention_tp), the gloo mesh's refusal of CUDA graphs,
and the cross-rank KV moves on cuda:0 (parallel/mesh.py gather_slabs,
ops/kv_transfer.py inject_universal's `heads`): two ranks as threads
over a gloo group, their slabs gathered into the logical blocks equal
to the plain torch gather of the whole cache, and a logical payload
injected per rank equal to the plain slice of it, for a bf16 cache, an
int8 cache with its scale planes and MLA's latent pair (whole on every
rank).  K3 also on the verify stream of a speculative round (four rows
of five tokens after 1800, 500, 100 and 37 cached positions, T = 32)
at a rank's slab; and the vocab-parallel sampling epilogue
(ops/fused_sampling.py) on two ranks' CUDA tensors of llama-8b's
vocabulary, its greedy tokens equal to the off path's argmax over the
gathered logits (integer-valued inputs: every product is exact, so the
two paths round the same values) and its statistics to the whole
vocabulary's.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_tp_gpu.py

A rank of llama-8b at tp=2 holds 16 query heads over 4 kv heads (group
4): each rank's kernel launch on its slab of the whole q and cache is
held to the plain version on the same slab (q * 1/sqrt(hd) rounded as
the kernels round it) within 1e-2 per-row relative L2, the tolerance
chip_smoke.py holds the kernels to, in both modes.
"""

import dataclasses
import datetime
import threading

import pytest
import torch
import torch.distributed as dist

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.llama import PRESETS
from dynamo_tpu_torch.ops import fused_sampling as fs
from dynamo_tpu_torch.ops.kv_transfer import (
    gather_universal,
    inject_universal,
)
from dynamo_tpu_torch.parallel import mesh
from dynamo_tpu_torch.ops.packed_prefill import (
    packed_prefill_attention_ref,
    packed_prefill_attention_tp,
)
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode_ref,
    paged_attention_decode_tp,
    tp_slab,
)
from dynamo_tpu_torch.quant.kv import quantize_tokens

CFG = PRESETS["llama-8b"]
TP = 2
REL_TOL = 1e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _rel(out, ref) -> float:
    o, r = out.float().flatten(1), ref.float().flatten(1)
    return ((o - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-6)).max().item()


def _cache(gen, nb: int, bs: int, int8: bool):
    """(k, v) bf16 caches [2, nkv, nb, bs, hd] of the whole model, or
    their int8 codes and scale planes."""
    shape = (2, CFG.n_kv_heads, nb, bs, CFG.head_dim)
    kv = [torch.randn(shape, generator=gen, device="cuda")
          .to(torch.bfloat16) for _ in "kv"]
    if not int8:
        return kv[0], kv[1], None, None
    out = []
    for t in kv:
        codes, scale = quantize_tokens(t.reshape(-1, 1, CFG.head_dim))
        out.append((codes.reshape(shape).contiguous(),
                    scale.reshape(shape[:-1]).contiguous()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k1_on_each_rank_slab_equals_plain_on_gpu(int8):
    from dynamo_tpu_torch.ops import cuda_paged_attention as k1

    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    bs, mb = 128, 16
    lens = [1, 127, 128, 129, 2048, 700, 1500, 2047]
    B = len(lens)
    nb = 1 + B * mb
    kc, vc, ks, vs = _cache(gen, nb, bs, int8)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2))
    tables = (perm[:B * mb] + 1).reshape(B, mb).to(torch.int32).cuda()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(B, CFG.n_heads, CFG.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    fn = k1.paged_decode_int8 if int8 else k1.paged_decode
    for r in range(TP):
        before = fn.launches
        out = paged_attention_decode_tp(q, kc, vc, 1, tables, kv_lens,
                                        rank=r, tp=TP, k_scale=ks,
                                        v_scale=vs)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        qs, kcs, vcs, kss, vss = tp_slab(q, kc, vc, ks, vs, r, TP)
        assert qs.shape[1] == 16 and kcs.shape[1] == 4
        ref = paged_attention_decode_ref(qs, kcs, vcs, 1, tables, kv_lens,
                                         round_scaled_q=True, k_scale=kss,
                                         v_scale=vss)
        assert out.shape == (B, 16, CFG.head_dim)
        assert _rel(out, ref) < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k3_on_each_rank_slab_equals_plain_on_gpu(int8):
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3

    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    bs, mb = 128, 8
    lens, ctx0 = [300, 100, 73, 37], [0, 128, 0, 5]
    S, T = len(lens), 512
    nb = 1 + S * mb
    kc, vc, ks, vs = _cache(gen, nb, bs, int8)
    tables = torch.arange(1, 1 + S * mb, dtype=torch.int32,
                          device="cuda").reshape(S, mb)
    seg, pos = [], []
    for s, (n, c) in enumerate(zip(lens, ctx0)):
        seg += [s] * n
        pos += list(range(c, c + n))
    n = len(seg)
    seg_t = torch.tensor(seg + [0] * (T - n), dtype=torch.int32,
                         device="cuda")
    pos_t = torch.tensor(pos + [0] * (T - n), dtype=torch.int32,
                         device="cuda")
    valid = torch.arange(T, device="cuda") < n
    q = torch.randn(T, CFG.n_heads, CFG.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    fn = k3.packed_prefill_int8 if int8 else k3.packed_prefill
    for r in range(TP):
        before = fn.launches
        out = packed_prefill_attention_tp(q, kc, vc, 0, tables, seg_t,
                                          pos_t, valid, rank=r, tp=TP,
                                          k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        qs, kcs, vcs, kss, vss = tp_slab(q, kc, vc, ks, vs, r, TP)
        ref = packed_prefill_attention_ref(qs, kcs, vcs, 0, tables, seg_t,
                                           pos_t, valid, round_scaled_q=True,
                                           k_scale=kss, v_scale=vss)
        assert bool((out[~valid] == 0).all())
        assert _rel(out[valid], ref[valid]) < REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_k3_verify_stream_on_each_rank_slab_equals_plain_on_gpu(int8):
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3

    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    bs, mb = 128, 16
    ctx0, n_tok = [1800, 500, 100, 37], 5
    S, T = len(ctx0), 32
    nb = 1 + S * mb
    kc, vc, ks, vs = _cache(gen, nb, bs, int8)
    tables = torch.arange(1, 1 + S * mb, dtype=torch.int32,
                          device="cuda").reshape(S, mb)
    seg = [s for s in range(S) for _ in range(n_tok)]
    pos = [c + i for c in ctx0 for i in range(n_tok)]
    seg_t = torch.tensor(seg + [0] * (T - len(seg)), dtype=torch.int32,
                         device="cuda")
    pos_t = torch.tensor(pos + [0] * (T - len(pos)), dtype=torch.int32,
                         device="cuda")
    valid = torch.arange(T, device="cuda") < len(seg)
    q = torch.randn(T, CFG.n_heads, CFG.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    fn = k3.packed_prefill_int8 if int8 else k3.packed_prefill
    for r in range(TP):
        before = fn.launches
        out = packed_prefill_attention_tp(q, kc, vc, 1, tables, seg_t,
                                          pos_t, valid, rank=r, tp=TP,
                                          k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        qs, kcs, vcs, kss, vss = tp_slab(q, kc, vc, ks, vs, r, TP)
        assert qs.shape[1] == 16 and kcs.shape[1] == 4
        ref = packed_prefill_attention_ref(qs, kcs, vcs, 1, tables, seg_t,
                                           pos_t, valid, round_scaled_q=True,
                                           k_scale=kss, v_scale=vss)
        assert bool((out[~valid] == 0).all())
        assert _rel(out[valid], ref[valid]) < REL_TOL


@pytest.mark.gpu
def test_vocab_parallel_epilogue_on_two_ranks_equals_the_off_argmax_on_gpu():
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    B, d, V = 4, CFG.d_model, CFG.vocab_size
    h = torch.randint(-2, 3, (B, d), generator=g, device="cuda").to(
        torch.bfloat16)
    w = torch.randint(-3, 4, (d, V), generator=g, device="cuda").to(
        torch.bfloat16)
    temps = torch.tensor([0.0, 0.7, 1.0, 1.3], device="cuda")
    # fp32 reductions throughout: the integer products then sum exactly
    # whatever split of the reduction cuBLAS picks for a shape
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _epilogue_ranks(h, w, temps)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced


def _epilogue_ranks(h, w, temps):
    V = w.shape[1]
    whole = fs.fused_sample_stats(h, w, temps)
    store = dist.HashStore()
    out, errs = [None] * TP, []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("voc", store), r, TP,
                                       datetime.timedelta(seconds=60))
            group = mesh.TensorGroup("gloo", pg, r, TP)
            n = V // TP
            wl = w[:, r * n:(r + 1) * n].contiguous()
            off = group.gather_vocab((h @ wl).float())
            out[r] = (torch.argmax(off, dim=-1).to(torch.int32),
                      fs.fused_greedy_tokens(h, wl, group=group),
                      fs.fused_sample_stats(h, wl, temps, group=group))
            torch.cuda.synchronize()
        except BaseException as e:  # re-raised on the test's thread
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(TP)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errs and not any(t.is_alive() for t in threads), errs
    for want, greedy, stats in out:
        assert torch.equal(greedy, want)
        assert torch.equal(greedy.long(), whole[1])
        for a, b in zip(stats[:4], whole[:4]):
            assert torch.equal(a, b)
        torch.testing.assert_close(stats[4], whole[4], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.gpu
def test_gloo_mesh_refuses_cuda_graphs_on_gpu():
    """Two ranks on one card talk through gloo, which a CUDA graph cannot
    capture: the engine raises before it spawns a rank."""
    _cuda()
    cfg = EngineConfig(model_config=dataclasses.replace(PRESETS["tiny"],
                                                        n_layers=1),
                       tp=2, block_size=128, num_blocks=8,
                       max_blocks_per_seq=4, max_num_seqs=2)
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        TorchEngine(cfg, devices=["cuda:0", "cuda:0"])


def _kv_case(kind: str, gen):
    """A whole cache on cuda:0 at llama-8b's kv heads (or MLA's latent
    pair at deepseek-v2-lite's widths), 2 layers, 9 blocks of 128."""
    nb, bs = 9, 128
    if kind == "mla":
        return tuple(torch.randn((2, 1, nb, bs, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for d in (512, 64))
    kc, vc, ks, vs = _cache(gen, nb, bs, kind == "int8")
    return (kc, vc) if ks is None else (kc, vc, ks, vs)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8", "mla"])
def test_rank_gather_and_inject_equal_the_plain_moves_on_gpu(kind):
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    whole = _kv_case(kind, gen)
    ids = [7, 2, 5, 1]
    want = gather_universal(whole, ids)
    payload = [torch.randn(a.shape, generator=gen, device="cuda")
               .to(a.dtype) if a.is_floating_point() else
               torch.randint(-127, 128, a.shape, generator=gen,
                             device="cuda").to(a.dtype) for a in want]
    replicated = kind == "mla"
    store = dist.HashStore()
    out, errs = [None] * TP, []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("kv", store), r, TP,
                                       datetime.timedelta(seconds=60))
            group = mesh.TensorGroup("gloo", pg, r, TP)
            heads = (None if replicated else
                     mesh.kv_cache_spec(r, TP, whole[0].shape[1]))
            kv = tuple((t if heads is None else t[:, heads]).clone()
                       for t in whole)
            slab = gather_universal(kv, ids)
            got = slab if replicated else mesh.gather_slabs(group, slab)
            inject_universal(kv, *payload[:2], ids, *payload[2:],
                             heads=heads)
            torch.cuda.synchronize()
            out[r] = (got, kv, heads)
        except BaseException as e:  # re-raised on the test's thread
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(TP)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errs and not any(t.is_alive() for t in threads), errs
    for got, w in zip(out[0][0], want):
        assert got.shape == w.shape and torch.equal(got.cuda(), w)
    for _, kv, heads in out:
        for b, p in zip(gather_universal(kv, ids),
                        mesh.payload_slab(payload, heads)):
            assert torch.equal(b, p)

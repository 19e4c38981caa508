"""Packed multi-sequence prefill over the paged KV cache.

The counterpart of dynamo_tpu/ops/packed_prefill.py.  Several prompts'
chunks (and prompt tails after prefix-cache hits) run as ONE
padding-free token stream with segment ids:

    tokens    [T]      packed stream (chunks back to back, tail padded)
    seg_ids   [T]      which segment row each token belongs to
    positions [T]      each token's ABSOLUTE position in its sequence
    tables    [S, mb]  per-segment block tables
    valid     [T]      False for the padded tail (writes -> garbage)

KV writes scatter each token into its own segment's paged block first
(in place; see ops/paged_attention.py); attention then reads everything,
cached prefix AND this chunk, back through the block table, masked
causal-within-segment by absolute position (token t sees its segment's
cache positions [0, positions[t]]).

`packed_prefill_attention` dispatches: "auto" goes through the kernel's
wrapper (ops/cuda_packed_prefill.py: CUDA kernel K3 on CUDA tensors, its
bf16 or int8 entry point; the plain version on CPU tensors); "torch" runs
the plain version anywhere.  Cache layout and conventions, the int8
cache's scale planes included, are those of ops/paged_attention.py: on
an int8 cache the chunk's own K/V round-trip the quantizer before
attention reads them back, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from .paged_attention import (
    NEG_INF,
    _gather_ctx,
    _q_operand,
    _store_kv,
    check_kv_scales,
)

# the packed-prefill dispatch's impl vocabulary
PACKED_IMPLS = ("auto", "torch")


def write_packed_kv(
    k_cache: torch.Tensor,       # [L, nkv, nblocks, bs, hd]
    v_cache: torch.Tensor,
    layer: int,
    k: torch.Tensor,             # [T, nkv, hd] packed-stream keys
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [S, mb] int32
    seg_ids: torch.Tensor,       # [T] int32 segment row per token
    positions: torch.Tensor,     # [T] int32 absolute position per token
    valid: torch.Tensor,         # [T] bool (False = padded tail)
    k_scale: torch.Tensor = None,  # [L, nkv, nblocks, bs] fp32 (int8)
    v_scale: torch.Tensor = None,
) -> None:
    """Scatter a packed chunk's K/V into each token's own sequence blocks,
    in place (the JAX version returns new cache arrays).  Padding tokens
    land in the garbage block; the table column is clamped to the table
    width, mirroring JAX's clamped gather."""
    bs = k_cache.shape[3]
    mb = block_tables.shape[1]
    col = torch.clamp(positions.long() // bs, max=mb - 1)
    blocks = block_tables[seg_ids.long(), col]
    blocks = torch.where(valid, blocks, torch.zeros_like(blocks))
    _store_kv(k_cache, v_cache, layer, k, v, blocks, positions.long() % bs,
              k_scale, v_scale)


def packed_prefill_attention_ref(
    q: torch.Tensor,             # [T, nh, hd] packed-stream queries (rope'd)
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,  # [S, mb]
    seg_ids: torch.Tensor,       # [T]
    positions: torch.Tensor,     # [T]
    valid: torch.Tensor,         # [T]
    round_scaled_q: bool = False,
    k_scale: torch.Tensor = None,  # [L, nkv, num_blocks, bs] fp32 (int8)
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """The plain version of kernel K3: what `_segment_flash` computes per
    segment, written as an exact segment-causal softmax over each
    segment's gathered context in fp32.  Tokens no segment owns (the
    padded tail) output exactly 0.  round_scaled_q: as in
    paged_attention_decode_ref (the kernels' rounding of q * 1/sqrt(hd)
    to q's dtype; off by default, as in the JAX reference path).  An int8
    cache's context is dequantized in fp32 with its scales."""
    check_kv_scales(k_cache, k_scale, v_scale)
    T, nh, hd = q.shape
    nkv = k_cache.shape[1]
    group = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qop, factor = _q_operand(q, scale, round_scaled_q)
    out = torch.zeros(T, nh, hd, dtype=torch.float32, device=q.device)
    for s in range(block_tables.shape[0]):
        idx = torch.nonzero((seg_ids == s) & valid).squeeze(1)
        if idx.numel() == 0:
            continue
        qs = qop[idx].reshape(-1, nkv, group, hd)  # [Ts, nkv, g, hd]
        k = _gather_ctx(k_cache, layer, block_tables[s],
                        k_scale).float()  # [nkv, C, hd]
        v = _gather_ctx(v_cache, layer, block_tables[s], v_scale).float()
        sc = torch.einsum("tkgh,ksh->tkgs", qs, k) * factor
        span = torch.arange(k.shape[1], device=q.device)
        mask = span[None, :] <= positions[idx].long()[:, None]  # [Ts, C]
        sc = sc.masked_fill(~mask[:, None, None, :], NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("tkgs,ksh->tkgh", p, v)
        out[idx] = o.reshape(-1, nh, hd)
    return out.to(q.dtype)


def packed_prefill_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,
    seg_ids: torch.Tensor,
    positions: torch.Tensor,
    valid: torch.Tensor,
    impl: str = "auto",
    k_scale: torch.Tensor = None,
    v_scale: torch.Tensor = None,
    plan=None,
) -> torch.Tensor:
    """Causal-within-segment attention for a packed prefill chunk.

    Every token attends to its OWN segment's paged cache over absolute
    positions [0, positions[t]]: the cached prefix plus the chunk itself,
    whose K/V write_packed_kv already scattered in.

    impl: "auto" (the kernel wrapper: CUDA kernel K3 on CUDA tensors,
    the plain version on CPU tensors) or "torch" (the plain version on
    any device).  k_scale/v_scale: an int8 cache's scale planes; they
    select K3's int8 entry point.  plan: K3's tile plan for this dispatch
    (`packed_attention_plan`), computed per call when absent."""
    if impl not in PACKED_IMPLS:
        raise ValueError(f"unknown packed-prefill impl {impl!r}; expected "
                         + " | ".join(PACKED_IMPLS))
    if impl == "torch":
        return packed_prefill_attention_ref(q, k_cache, v_cache, layer,
                                            block_tables, seg_ids,
                                            positions, valid,
                                            k_scale=k_scale, v_scale=v_scale)
    from .cuda_packed_prefill import packed_prefill, packed_prefill_int8

    if check_kv_scales(k_cache, k_scale, v_scale):
        return packed_prefill_int8(q, k_cache, v_cache, k_scale, v_scale,
                                   layer, block_tables, seg_ids, positions,
                                   valid, plan=plan)
    return packed_prefill(q, k_cache, v_cache, layer, block_tables, seg_ids,
                          positions, valid, plan=plan)


def packed_attention_plan(k_cache: torch.Tensor, n_heads: int,
                          block_tables: torch.Tensor, seg_ids: torch.Tensor,
                          positions: torch.Tensor, valid: torch.Tensor,
                          impl: str = "auto"):
    """K3's tile plan for one packed dispatch (the same for all its
    layers), or None where no kernel runs (impl "torch", CPU tensors)."""
    if impl != "auto" or not k_cache.is_cuda:
        return None
    from .cuda_packed_prefill import packed_prefill_plan

    return packed_prefill_plan(seg_ids, positions, valid, block_tables,
                               n_heads, k_cache.shape[1], k_cache.shape[3])

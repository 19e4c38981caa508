"""Paged Multi-head Latent Attention (MLA): the DeepSeek family's
attention over a compressed latent KV cache.

The counterpart of dynamo_tpu/ops/mla_attention.py, plain torch as the
JAX package's is plain jnp (no Pallas kernel: the JAX engine's MLA
consults neither attention kernel).  Every product runs in fp32 on fp32
upcasts of its operands, and each output is cast back to the query's
dtype at the end, as in JAX.

MLA caches, per token, a latent pair instead of per-head K/V:
    c    [R]   the normed KV latent (R = kv_lora_rank, 512 at DeepSeek V2)
    k_R  [dr]  the decoupled, shared rope key (dr = qk_rope_head_dim)
The two caches take the port's block layout with one head,
    c_cache  [L, 1, num_blocks, block_size, R]
    kr_cache [L, 1, num_blocks, block_size, dr]
so a block's positions are contiguous rows and the gather of a table is
an index and a reshape (the JAX package's [..., R, bs] needs a swap);
every block op (the cache writes of ops/paged_attention.py, KVBM, the
disagg transfers of ops/kv_transfer.py) works on them per member.

Decode is weight-absorbed: per head
    score_t = q_nope . (W_UK c_t) + q_rope . k_R_t
            = (q_nope W_UK^T) . c_t + q_rope . k_R_t
so no per-head key is made: the queries are absorbed into latent space
([B, nh, R], models/deepseek.py `_absorb_q`), attention runs against the
cache directly, and the context (sum_t p_t c_t) is up-projected once by
W_UV.  Decode is batched over rows (no host loop), so the decode bursts
capture as CUDA graphs.  Prefill up-projects the gathered context and
the chunk's latents to per-head K/V (the non-absorbed form).

Both gather the full table width S = max_blocks * block_size, as JAX
does, and mask by length: a semantics copy, not an optimisation.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def score_scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) computed in fp32, as `1.0 / jnp.sqrt(
    jnp.float32(head_dim))` is (the value is exact in fp32, so scaling
    an fp32 tensor by it rounds as JAX's does)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(head_dim))))


def _gather_latent(cache: torch.Tensor, layer: int,
                   block_tables: torch.Tensor) -> torch.Tensor:
    """[L, 1, nb, bs, D] + tables [..., max_blocks] -> [..., S, D], S =
    max_blocks * bs."""
    g = cache[layer, 0][block_tables.long()]      # [..., mb, bs, D]
    return g.reshape(*g.shape[:-3], -1, g.shape[-1])


def mla_prefill_attention(
    q_nope: torch.Tensor,       # [T, nh, dn] (no rope)
    q_rope: torch.Tensor,       # [T, nh, dr] (rope applied)
    c: torch.Tensor,            # [T, R] this chunk's latents (normed)
    kr: torch.Tensor,           # [T, dr] this chunk's rope keys
    c_cache: torch.Tensor,
    kr_cache: torch.Tensor,
    layer: int,
    block_table: torch.Tensor,  # [max_blocks]
    ctx_len,                    # cached tokens the chunk attends to
    true_len,                   # valid tokens of the chunk
    w_uk: torch.Tensor,         # [nh, R, dn]
    w_uv: torch.Tensor,         # [nh, R, dv]
) -> torch.Tensor:
    """The chunk's tokens attend to the cached context (positions below
    ctx_len) and to the chunk causally (below true_len), the context
    up-projected from its latents.  Returns [T, nh, dv]."""
    T, nh, dn = q_nope.shape
    dr = q_rope.shape[-1]
    scale = score_scale(dn + dr)
    c_ctx = _gather_latent(c_cache, layer, block_table)     # [S, R]
    kr_ctx = _gather_latent(kr_cache, layer, block_table)   # [S, dr]
    S = c_ctx.shape[0]
    c_all = torch.cat([c_ctx.float(), c.float()], dim=0)     # [S+T, R]
    kr_all = torch.cat([kr_ctx.float(), kr.float()], dim=0)  # [S+T, dr]
    k_nope = torch.einsum("sr,hrd->hsd", c_all, w_uk.float())
    v_all = torch.einsum("sr,hrd->hsd", c_all, w_uv.float())
    s = torch.einsum("thd,hsd->ths", q_nope.float(), k_nope)
    s = s + torch.einsum("thd,sd->ths", q_rope.float(), kr_all)
    s = s * scale                                            # [T, nh, S+T]
    dev = q_nope.device
    i = torch.arange(T, device=dev)[:, None, None]
    j = torch.arange(S + T, device=dev)[None, None, :]
    mask = torch.where(j < S, j < ctx_len,
                       ((j - S) <= i) & ((j - S) < true_len))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("ths,hsd->thd", p, v_all)
    return out.to(q_nope.dtype)


def mla_decode_attention(
    q_abs: torch.Tensor,         # [B, nh, R] absorbed queries
    q_rope: torch.Tensor,        # [B, nh, dr]
    c_cache: torch.Tensor,
    kr_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_blocks]
    kv_lens: torch.Tensor,       # [B] valid tokens (the new one included)
    w_uv: torch.Tensor,          # [nh, R, dv]
    scale: float,
) -> torch.Tensor:
    """One weight-absorbed decode step over the latent cache, every row
    at once.  Returns [B, nh, dv]."""
    c_ctx = _gather_latent(c_cache, layer, block_tables).float()  # [B,S,R]
    kr_ctx = _gather_latent(kr_cache, layer, block_tables).float()
    s = torch.einsum("bhr,bsr->bhs", q_abs.float(), c_ctx)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_ctx)
    s = s * scale
    pos = torch.arange(c_ctx.shape[1], device=c_ctx.device)
    s = torch.where(pos[None, None, :] < kv_lens[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)                                  # [B,nh,S]
    ctx = torch.einsum("bhs,bsr->bhr", p, c_ctx)
    out = torch.einsum("bhr,hrd->bhd", ctx, w_uv.float())
    return out.to(q_abs.dtype)


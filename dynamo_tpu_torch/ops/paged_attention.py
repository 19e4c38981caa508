"""Paged KV-cache ops: cache writes, single-token decode attention and
one sequence's chunked prefill attention.

The counterpart of dynamo_tpu/ops/paged_attention.py.

Cache layout (per tensor): [n_layers, n_kv_heads, num_blocks, block_size,
head_dim].  Head-major like the JAX package, so one (head, block) slab is
contiguous (32 KiB at bs = hd = 128 in bf16), but with head_dim innermost
instead of the TPU's transposed [..., hd, bs]: the transposition was a
TPU lane-alignment choice with no meaning on a GPU, and with hd innermost
one position's key is 256 contiguous bytes, so 16-byte vector loads
coalesce.  models/convert.py is the only place the two layouts meet.

Conventions (shared with the JAX package):
  * physical block 0 is the GARBAGE block: inactive rows' writes land
    there and are never read; allocators hand out ids >= 1.
  * sequence validity is carried by lengths and enforced with masks.

Unlike the JAX functions, which return new arrays, every write here is an
in-place scatter into the cache tensors (`index_put_`), which saves a
copy of the multi-GiB cache per layer.  `index_put_` does not drop
out-of-range indices the way JAX's `mode="drop"` does, so every caller
routes invalid rows to block 0 instead, as the JAX code already does.

Int8 KV cache (quant/kv.py, engine `kv_cache_dtype="int8"`): the caches
hold int8 codes and every write and read takes the fp32 scale planes
`k_scale`/`v_scale` [L, nkv, num_blocks, bs].  A write quantizes k/v per
(token, head) and scatters codes and scales with the same blocks and
offsets; a plain read dequantizes the gathered context in fp32, as the
JAX "jnp" path does.  The quantize-on-write stays plain torch, as it
stays XLA outside any Pallas kernel in the JAX package.

`paged_attention_decode` dispatches: "auto" goes through the kernel's
wrapper (ops/cuda_paged_attention.py), which launches the hand-written
CUDA kernel for CUDA tensors (the bf16 or the int8 entry point) and uses
`paged_attention_decode_ref` for CPU tensors; "torch" runs the plain
version on any device (the yardstick the kernel is held to on the card).

Tensor parallelism (parallel/mesh.py): a rank holds the kv heads of its
slab, and the query heads of their groups, so its forward calls these
functions on its local tensors and the kernels see the slab's shapes
(llama-8b at tp = 2: nh 16 over nkv 4).  `paged_attention_decode_tp`,
the counterpart of JAX's `kernel_tp_call`/`_decode_pallas_tp` for one
shard, takes the whole q and cache and runs the op on rank r's slab
(`tp_slab`): what holds a rank's result against the whole computation.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import head_slabs
from ..quant.kv import quantize_tokens

NEG_INF = -1e30

# the decode dispatch's impl vocabulary (engine/config.py validates
# attn_impl against it)
DECODE_IMPLS = ("auto", "torch")


# ---------------------------------------------------------------------------
# cache writes (block scatter, in place)
# ---------------------------------------------------------------------------


def check_kv_scales(k_cache: torch.Tensor, k_scale, v_scale) -> bool:
    """True for an int8 cache passed with both scale planes, False for a
    float cache passed with none; anything else raises."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    quantized = k_cache.dtype == torch.int8
    if quantized and k_scale is None:
        raise TypeError("an int8 KV cache needs its k_scale/v_scale planes")
    if not quantized and k_scale is not None:
        raise TypeError(f"scale planes passed with a {k_cache.dtype} cache "
                        "(they belong to an int8 cache)")
    return quantized


def _store_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
              k: torch.Tensor, v: torch.Tensor, blocks: torch.Tensor,
              offsets: torch.Tensor, k_scale: torch.Tensor = None,
              v_scale: torch.Tensor = None) -> None:
    """Shared scatter tail for every write site: k/v [T, nkv, hd] land at
    cache[layer, :, blocks, offsets, :] (target [nkv, T, hd]), and for an
    int8 cache their per-(token, head) scales at scale[layer, :, blocks,
    offsets] (target [nkv, T]) with the SAME blocks/offsets.  In place."""
    blocks = blocks.long()
    offsets = offsets.long()
    if check_kv_scales(k_cache, k_scale, v_scale):
        k, ks = quantize_tokens(k)
        v, vs = quantize_tokens(v)
        k_scale[layer][:, blocks, offsets] = ks.transpose(0, 1)
        v_scale[layer][:, blocks, offsets] = vs.transpose(0, 1)
    k_cache[layer][:, blocks, offsets] = k.transpose(0, 1).to(k_cache.dtype)
    v_cache[layer][:, blocks, offsets] = v.transpose(0, 1).to(v_cache.dtype)


def write_token_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int,
                   k: torch.Tensor,             # [B, nkv, hd]
                   v: torch.Tensor,
                   block_tables: torch.Tensor,  # [B, max_blocks] int32
                   ctx_lens: torch.Tensor,      # [B] position to write
                   k_scale: torch.Tensor = None,  # [L, nkv, nb, bs] (int8)
                   v_scale: torch.Tensor = None,
                   ) -> None:
    """Decode-step KV write: each row's token at position ctx_lens[b].
    In-place scatter (the JAX version returns new cache arrays).  The
    table column is clamped to the table width, mirroring JAX's clamped
    gather."""
    bs = k_cache.shape[3]
    B, mb = block_tables.shape
    col = torch.clamp(ctx_lens.long() // bs, max=mb - 1)
    rows = torch.arange(B, device=block_tables.device)
    blocks = block_tables[rows, col]
    _store_kv(k_cache, v_cache, layer, k, v, blocks, ctx_lens.long() % bs,
              k_scale, v_scale)


def write_prompt_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    layer: int,
                    k: torch.Tensor,            # [T, nkv, hd] new tokens' keys
                    v: torch.Tensor,
                    block_table: torch.Tensor,  # [max_blocks] int32
                    ctx_len,                    # tokens already in cache
                    true_len,                   # valid entries of k/v
                    k_scale: torch.Tensor = None,  # [L, nkv, nb, bs] (int8)
                    v_scale: torch.Tensor = None,
                    ) -> None:
    """One sequence's chunk write: token i at position ctx_len + i, the
    rows past true_len to the garbage block.  In place; the table column
    is clamped to the table width, mirroring JAX's clamped gather.
    ctx_len/true_len: ints or 0-d tensors."""
    T = k.shape[0]
    bs = k_cache.shape[3]
    idx = torch.arange(T, device=k.device)
    pos = idx + ctx_len
    col = torch.clamp(pos // bs, max=block_table.shape[0] - 1)
    blocks = torch.where(idx < true_len, block_table.long()[col],
                         torch.zeros_like(col))
    _store_kv(k_cache, v_cache, layer, k, v, blocks, pos % bs,
              k_scale, v_scale)


# ---------------------------------------------------------------------------
# attention reads
# ---------------------------------------------------------------------------


def _gather_ctx(cache: torch.Tensor, layer: int, block_table: torch.Tensor,
                scale: torch.Tensor = None) -> torch.Tensor:
    """[L, nkv, nb, bs, hd] + [max_blocks] -> [nkv, max_blocks * bs, hd];
    `scale` [L, nkv, nb, bs] dequantizes an int8 cache to fp32."""
    g = _gather_blocks(cache, layer, block_table, scale)  # [nkv, mb, bs, hd]
    return g.reshape(g.shape[0], -1, g.shape[-1])


def _gather_blocks(cache: torch.Tensor, layer: int, tables: torch.Tensor,
                   scale: torch.Tensor = None) -> torch.Tensor:
    """cache[layer][:, tables]: the blocks of any table shape, dequantized
    in fp32 by the same gather of `scale` for an int8 cache."""
    tables = tables.long()
    g = cache[layer][:, tables]
    if scale is None:
        return g
    return g.float() * scale[layer][:, tables][..., None]


def _q_operand(q: torch.Tensor, scale: float,
               round_to_q: bool) -> tuple[torch.Tensor, float]:
    """(fp32 query operand, factor for the scores).  round_to_q: q is
    pre-scaled and rounded to its dtype, as the kernels do
    (pallas_paged_attention.py:340-341); else the scores are scaled, as
    the JAX reference paths do."""
    if round_to_q:
        return (q.float() * scale).to(q.dtype).float(), 1.0
    return q.float(), scale


def paged_attention_decode_ref(
    q: torch.Tensor,             # [B, nh, hd]
    k_cache: torch.Tensor,       # [L, nkv, num_blocks, bs, hd]
    v_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    kv_lens: torch.Tensor,       # [B] valid tokens (incl. the one just written)
    round_scaled_q: bool = False,
    k_scale: torch.Tensor = None,  # [L, nkv, num_blocks, bs] fp32 (int8)
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """The plain version of kernel K1, mirroring
    paged_attention_decode_jnp with fp32-upcast operands: gather each
    row's context through its block table, mask positions >= kv_len,
    exact softmax, fp32 accumulation.  kv_lens are clamped to >= 1 as the
    kernels (TPU and CUDA) clamp them.  round_scaled_q=True also rounds
    q * 1/sqrt(hd) to q's dtype before the product, as the kernels do, so
    the kernel and this version compute the same function for every
    input; it is off by default, as in the JAX package's reference
    path.  An int8 cache's context is dequantized in fp32 with its
    scales, as the JAX "jnp" impl does."""
    check_kv_scales(k_cache, k_scale, v_scale)
    B, nh, hd = q.shape
    nkv = k_cache.shape[1]
    group = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    # [nkv, B, mb, bs, hd]
    kb = _gather_blocks(k_cache, layer, tables, k_scale)
    vb = _gather_blocks(v_cache, layer, tables, v_scale)
    S = kb.shape[2] * kb.shape[3]
    kb = kb.reshape(nkv, B, S, hd).transpose(0, 1).float()  # [B, nkv, S, hd]
    vb = vb.reshape(nkv, B, S, hd).transpose(0, 1).float()
    qg, factor = _q_operand(q, scale, round_scaled_q)
    qg = qg.reshape(B, nkv, group, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg, kb) * factor
    lens = torch.clamp(kv_lens.long(), min=1)
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, vb)
    return o.reshape(B, nh, hd).to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,            # [T, nh, hd] (rope applied)
    k: torch.Tensor,            # [T, nkv, hd] this chunk's keys
    v: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    block_table: torch.Tensor,  # [max_blocks] int32
    ctx_len,                    # cached tokens this chunk attends to
    true_len,                   # valid tokens in the chunk
    k_scale: torch.Tensor = None,  # int8 cache: dequant scales (quant/kv.py)
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """One sequence's chunk attends to (cached context) ++ (chunk,
    causally), in fp32, as the JAX package's `paged_prefill_attention`:
    the chunk's own K/V attend at full precision (fresh from the
    projection); only the cached context dequantizes on an int8 cache.
    Plain torch, as it is XLA there (no Pallas kernel): the draft model's
    catch-up prefill (spec/draft.py) is its one caller."""
    check_kv_scales(k_cache, k_scale, v_scale)
    T, nh, hd = q.shape
    nkv = k_cache.shape[1]
    group = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    k_ctx = _gather_ctx(k_cache, layer, block_table, k_scale).float()
    v_ctx = _gather_ctx(v_cache, layer, block_table, v_scale).float()
    S = k_ctx.shape[1]
    qg = q.float().reshape(T, nkv, group, hd)
    s_ctx = torch.einsum("tkgh,ksh->tkgs", qg, k_ctx) * scale
    ctx_mask = torch.arange(S, device=q.device) < ctx_len
    s_ctx = s_ctx.masked_fill(~ctx_mask, NEG_INF)
    s_self = torch.einsum("tkgh,skh->tkgs", qg, k.float()) * scale
    i = torch.arange(T, device=q.device)
    causal = (i[None, :] <= i[:, None]) & (i[None, :] < true_len)
    s_self = s_self.masked_fill(~causal[:, None, None, :], NEG_INF)
    p = torch.softmax(torch.cat([s_ctx, s_self], dim=-1), dim=-1)
    out = (torch.einsum("tkgs,ksh->tkgh", p[..., :S], v_ctx)
           + torch.einsum("tkgs,skh->tkgh", p[..., S:], v.float()))
    return out.reshape(T, nh, hd).to(q.dtype)


def paged_attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    impl: str = "auto",
    k_scale: torch.Tensor = None,
    v_scale: torch.Tensor = None,
) -> torch.Tensor:
    """Single-token batched paged attention (the decode hot loop).

    impl: "auto" (the kernel wrapper: CUDA kernel K1 on CUDA tensors,
    the plain version on CPU tensors) or "torch" (the plain version on
    any device).  k_scale/v_scale: an int8 cache's scale planes; they
    select K1's int8 entry point."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected "
                         + " | ".join(DECODE_IMPLS))
    if impl == "torch":
        return paged_attention_decode_ref(q, k_cache, v_cache, layer,
                                          block_tables, kv_lens,
                                          k_scale=k_scale, v_scale=v_scale)
    from .cuda_paged_attention import paged_decode, paged_decode_int8

    if check_kv_scales(k_cache, k_scale, v_scale):
        return paged_decode_int8(q, k_cache, v_cache, k_scale, v_scale,
                                 layer, block_tables, kv_lens)
    return paged_decode(q, k_cache, v_cache, layer, block_tables, kv_lens)


def tp_slab(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            k_scale: torch.Tensor, v_scale: torch.Tensor, rank: int,
            tp: int) -> tuple:
    """Rank's slab of the whole tensors, each contiguous (a copy): query
    heads [r*nh/tp, (r+1)*nh/tp) of q [..., nh, hd] against kv heads
    [r*nkv/tp, (r+1)*nkv/tp) of the caches [L, nkv, ...] and of an int8
    cache's scale planes.  GQA groups are kv-major and contiguous, so
    the slab holds every query head of its kv heads and needs nothing
    from another rank (the row-parallel wo downstream sums the ranks).
    Raises unless tp divides nh and nkv."""
    qh, kh = head_slabs(q.shape[-2], k_cache.shape[1], rank, tp)

    def cut(t):
        return None if t is None else t[:, kh].contiguous()

    return (q[..., qh, :].contiguous(), cut(k_cache), cut(v_cache),
            cut(k_scale), cut(v_scale))


def paged_attention_decode_tp(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, layer: int,
                              block_tables: torch.Tensor,
                              kv_lens: torch.Tensor, *, rank: int, tp: int,
                              impl: str = "auto",
                              k_scale: torch.Tensor = None,
                              v_scale: torch.Tensor = None) -> torch.Tensor:
    """Rank's share of tensor-parallel decode attention: K1 (or the plain
    version, by `impl` and the device as `paged_attention_decode`) on
    rank's slab of the whole q [B, nh, hd] and cache.  Returns
    [B, nh/tp, hd], the rank's heads of the whole op's output."""
    qs, ks, vs, kss, vss = tp_slab(q, k_cache, v_cache, k_scale, v_scale,
                                   rank, tp)
    return paged_attention_decode(qs, ks, vs, layer, block_tables, kv_lens,
                                  impl=impl, k_scale=kss, v_scale=vss)

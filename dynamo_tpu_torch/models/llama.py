"""Llama-family decoder over a paged KV cache, in PyTorch.

The counterpart of dynamo_tpu/models/llama.py (dense families): plain
functions over a parameter dict with the JAX package's tree and names
({"embedding", "final_norm", "lm_head", "layers": [...]}, weights stored
[in, out] so `x @ w` reads the same), so weights carry across through
models/convert.py unchanged.  The large products stay `torch.matmul`, as
the JAX package leaves them to XLA; attention goes through the paged ops
(ops/paged_attention.py, ops/packed_prefill.py), whose dispatch launches
the hand-written CUDA kernels on CUDA tensors.

Weights are bf16 by default; norms are fp32 and activations are computed
in fp32 around the norms and rotary embedding, as in the JAX package.
The KV cache is a (k, v) tuple in the port's layout
[L, nkv, num_blocks, block_size, hd], or (k, v, k_scale, v_scale) for an
int8 cache (quant/kv.py), and is updated IN PLACE: the functions still
return it, so call sites read like the JAX ones.
The MoE paths are not ported yet and raise (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..lora.bank import bank_layer, lora_delta, masked_delta, slot_onehot
from ..ops.packed_prefill import (
    packed_attention_plan,
    packed_prefill_attention,
    write_packed_kv,
)
from ..ops.paged_attention import (
    paged_attention_decode,
    paged_prefill_attention,
    write_prompt_kv,
    write_token_kv,
)
from ..quant.kv import unpack_kv

Params = Dict[str, Any]
# (k, v) or, for an int8 cache, (k, v, k_scale, v_scale)
KVCache = Tuple[torch.Tensor, ...]


@dataclass(frozen=True)
class LlamaConfig:
    name: str = "tiny"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 64
    ffn_dim: int = 1408
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    qk_norm: bool = False  # Qwen3-style per-head q/k RMSNorm
    tie_embeddings: bool = False
    max_context: int = 8192
    dtype: torch.dtype = torch.bfloat16
    # decode attention: "auto" (kernel K1 on CUDA tensors, the plain
    # version on CPU tensors) | "torch" (the plain version anywhere)
    attn_impl: str = "auto"
    # packed-prefill attention: "auto" (kernel K3 / plain) | "torch"
    packed_attn_impl: str = "auto"
    eos_token_ids: Tuple[int, ...] = (2,)
    # MoE (Mixtral family) is a later slice of the port
    n_experts: int = 0

    def __post_init__(self):
        if self.n_experts > 0:
            raise NotImplementedError(
                "MoE (n_experts > 0) is not ported to dynamo_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 9: MoE and MLA)")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def kv_cache_shapes(cfg: LlamaConfig, num_blocks: int,
                    block_size: int) -> tuple:
    """(k, v) cache shapes in the port's head-major layout with head_dim
    innermost (ops/paged_attention.py)."""
    shape = (cfg.n_layers, cfg.n_kv_heads, num_blocks, block_size,
             cfg.head_dim)
    return shape, shape


def kv_cache_scale_shapes(cfg: LlamaConfig, num_blocks: int,
                          block_size: int) -> tuple:
    """(k_scale, v_scale) shapes of an int8 cache (quant/kv.py): one fp32
    scale per (layer, kv head, block, position), the JAX package's
    layout."""
    shape = (cfg.n_layers, cfg.n_kv_heads, num_blocks, block_size)
    return shape, shape


# the dense presets of the JAX package, with torch dtypes
PRESETS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(),
    "tiny-gqa": LlamaConfig(name="tiny-gqa", n_heads=8, n_kv_heads=2),
    "llama-1b": LlamaConfig(
        name="llama-1b", vocab_size=128256, d_model=2048, n_layers=16,
        n_heads=32, n_kv_heads=8, head_dim=64, ffn_dim=8192,
        max_context=131072,
    ),
    "llama-3b": LlamaConfig(
        name="llama-3b", vocab_size=128256, d_model=3072, n_layers=28,
        n_heads=24, n_kv_heads=8, head_dim=128, ffn_dim=8192,
        max_context=131072,
    ),
    "llama-8b": LlamaConfig(
        name="llama-8b", vocab_size=128256, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=14336,
        max_context=131072,
    ),
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """Random-init parameters with the JAX package's shapes and scales
    (normal * 1/sqrt(fan_in), embedding * 0.02, norms 1).  The draws come
    from `generator` (on `device`, default the generator's), so they are
    not the JAX package's values: tests that compare the two convert the
    JAX parameters instead (models/convert.py)."""
    dev = torch.device(device) if device is not None else generator.device

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def ones(n):
        return {"norm": torch.ones(n, dtype=torch.float32, device=dev)}

    params: Params = {"embedding": dense((cfg.vocab_size, cfg.d_model),
                                         scale=0.02),
                      "final_norm": ones(cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.d_model, cfg.vocab_size))
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(cfg.d_model),
            "mlp_norm": ones(cfg.d_model),
            "wq": dense((cfg.d_model, cfg.q_dim)),
            "wk": dense((cfg.d_model, cfg.kv_dim)),
            "wv": dense((cfg.d_model, cfg.kv_dim)),
            "wo": dense((cfg.q_dim, cfg.d_model)),
            "w_gate": dense((cfg.d_model, cfg.ffn_dim)),
            "w_up": dense((cfg.d_model, cfg.ffn_dim)),
            "w_down": dense((cfg.ffn_dim, cfg.d_model)),
        }
        if cfg.qk_norm:
            layer["q_norm"] = ones(cfg.head_dim)
            layer["k_norm"] = ones(cfg.head_dim)
        layers.append(layer)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [..., seq, heads, hd], positions: [..., seq]."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., :, None].float() * freqs  # [..., seq, half]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(layer, cfg: LlamaConfig, x: torch.Tensor,
         positions: torch.Tensor, lora=None):
    """x: [..., seq, d] -> q [..., seq, nh, hd], k/v [..., seq, nkv, hd].

    `lora`: optional (bank_layer, selector) from _lora_ctx: batched
    low-rank deltas added to the projections (lora/bank.py); slot 0 is
    zeros, so mixed base/adapter batches share this program."""
    *lead, seq, _ = x.shape
    zq = x @ layer["wq"]
    zk = x @ layer["wk"]
    zv = x @ layer["wv"]
    if lora is not None:
        bl, sel = lora
        zq = zq + _lora_delta(x, bl["A_q"], bl["B_q"], sel)
        zk = zk + _lora_delta(x, bl["A_k"], bl["B_k"], sel)
        zv = zv + _lora_delta(x, bl["A_v"], bl["B_v"], sel)
    q = zq.reshape(*lead, seq, cfg.n_heads, cfg.head_dim)
    k = zk.reshape(*lead, seq, cfg.n_kv_heads, cfg.head_dim)
    v = zv.reshape(*lead, seq, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"]["norm"], cfg.rms_eps)
        k = rms_norm(k, layer["k_norm"]["norm"], cfg.rms_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_kv(fn, kv_cache: KVCache, layer: int, *args) -> None:
    """A cache write through `fn` (write_token_kv or write_packed_kv),
    threading the scale planes when the cache is int8.  In place."""
    k, v, ks, vs = unpack_kv(kv_cache)
    fn(k, v, layer, *args, k_scale=ks, v_scale=vs)


def _attn_out(layer, attn_flat: torch.Tensor, lora=None) -> torch.Tensor:
    o = attn_flat @ layer["wo"]
    if lora is not None:
        bl, sel = lora
        o = o + _lora_delta(attn_flat, bl["A_o"], bl["B_o"], sel)
    return o


def _lora_sel(lora_bank, adapter_idx, dtype: torch.dtype):
    """The adapter selector of one forward pass: None without a bank, a
    scalar index as it is, else the rows' one-hot over the bank's slots
    (lora/bank.py slot_onehot), built once for every layer and target."""
    if lora_bank is None or adapter_idx is None:
        return None
    if adapter_idx.ndim == 0:
        return adapter_idx
    return slot_onehot(adapter_idx, lora_bank["A_q"].shape[1], dtype)


def _lora_ctx(lora_bank, sel, li):
    """Per-layer LoRA context for _qkv/_attn_out, or None when disabled."""
    if sel is None:
        return None
    return bank_layer(lora_bank, li), sel


def _lora_delta(x, A, B, sel):
    """lora/bank.py's delta for a selector of _lora_sel."""
    if sel.ndim == 0:
        return lora_delta(x, A, B, sel)
    return masked_delta(x, A, B, sel)


def _mlp(layer, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ layer["w_gate"])
            * (x @ layer["w_up"])) @ layer["w_down"]


def unembed_weight(params, cfg: LlamaConfig) -> torch.Tensor:
    """The [d, vocab] final-projection matrix (embedding.T when tied)."""
    if cfg.tie_embeddings:
        return params["embedding"].T
    return params["lm_head"]


def _final_norm(params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"]["norm"], cfg.rms_eps)


def _logits(params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    return (_final_norm(params, cfg, x) @ unembed_weight(params, cfg)).float()


# ---------------------------------------------------------------------------
# packed prefill: several sequences' chunks as one padding-free stream
# ---------------------------------------------------------------------------


def prefill_packed(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [T] int32 packed stream (tail padded)
    positions: torch.Tensor,     # [T] int32 absolute position per token
    seg_ids: torch.Tensor,       # [T] int32 segment row per token
    block_tables: torch.Tensor,  # [S, mb] int32 per-segment block tables
    last_idx: torch.Tensor,      # [S] int32 packed index of each segment's
    #                              last token this chunk (0 for unused rows)
    valid: torch.Tensor,         # [T] bool: False on the padded tail
    lora_bank=None,              # stacked adapter bank (lora/bank.py)
    adapter_idx=None,            # [T] int32: bank slot PER TOKEN
):
    """Packed multi-sequence prefill (ops/packed_prefill.py): K/V scatter
    into each token's own blocks, attention is causal-within-segment over
    each segment's paged context.  Returns (logits [S, vocab] at each
    segment's last packed token, kv_cache updated in place)."""
    x = _packed_forward(params, cfg, kv_cache, token_ids, positions,
                        seg_ids, block_tables, valid, lora_bank,
                        adapter_idx)
    return _logits(params, cfg, x[last_idx.long()]), kv_cache


def prefill_packed_kv(params: Params, cfg: LlamaConfig, kv_cache: KVCache,
                      token_ids, positions, seg_ids, block_tables,
                      valid) -> KVCache:
    """prefill_packed's K/V writes alone, no logits: the draft model's
    catch-up (spec/draft.py), as the JAX proposer's `_prefill_impl`
    returns its cache alone.  Returns kv_cache, updated in place."""
    _packed_forward(params, cfg, kv_cache, token_ids, positions, seg_ids,
                    block_tables, valid)
    return kv_cache


def _packed_forward(params, cfg: LlamaConfig, kv_cache: KVCache,
                    token_ids, positions, seg_ids, block_tables, valid,
                    lora_bank=None, adapter_idx=None):
    """The packed-stream transformer body.  Returns the final hidden
    states [T, d] (before the final norm).  K3's tile plan depends only on
    the stream's layout, so it is computed once here for every layer, as
    is the per-token adapter one-hot with a bank."""
    k_cache, v_cache, k_scale, v_scale = unpack_kv(kv_cache)
    T = token_ids.shape[0]
    plan = packed_attention_plan(k_cache, cfg.n_heads, block_tables,
                                 seg_ids, positions, valid,
                                 impl=cfg.packed_attn_impl)
    sel = _lora_sel(lora_bank, adapter_idx, cfg.dtype)
    x = params["embedding"][token_ids.long()].to(cfg.dtype)  # [T, d]
    for li, layer in enumerate(params["layers"]):
        lctx = _lora_ctx(lora_bank, sel, li)
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        q, k, v = _qkv(layer, cfg, h, positions, lora=lctx)  # [T, nh, hd]
        _write_kv(write_packed_kv, kv_cache, li, k, v, block_tables,
                  seg_ids, positions, valid)
        attn = packed_prefill_attention(
            q, k_cache, v_cache, li, block_tables, seg_ids, positions,
            valid, impl=cfg.packed_attn_impl, k_scale=k_scale,
            v_scale=v_scale, plan=plan)
        x = x + _attn_out(layer, attn.reshape(T, cfg.q_dim), lora=lctx)
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        x = x + _mlp(layer, h)
    return x


def spec_verify_packed(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [T] int32 packed verify stream
    positions: torch.Tensor,     # [T] int32 absolute position per token
    seg_ids: torch.Tensor,       # [T] int32 segment row per token
    block_tables: torch.Tensor,  # [S, mb] int32 per-segment block tables
    valid: torch.Tensor,         # [T] bool: False on the padded tail
):
    """Speculative-decoding verification (spec/): each speculating
    sequence's row [last_token, d1..dk] runs through the same packed
    segment-id path as chunked prefill (K3 on the card), K/V written in
    place for every draft position (rejected tails are overwritten when
    the sequence reaches those positions), with logits at EVERY packed
    position.  Returns (logits [T, vocab], kv_cache updated in place)."""
    x = _packed_forward(params, cfg, kv_cache, token_ids, positions,
                        seg_ids, block_tables, valid)
    return _logits(params, cfg, x), kv_cache


# ---------------------------------------------------------------------------
# prefill: one sequence's chunk attends to its cached context + itself
# ---------------------------------------------------------------------------


def prefill(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [T_pad] int32 (one sequence, padded)
    positions: torch.Tensor,     # [T_pad] int32 absolute positions
    block_table: torch.Tensor,   # [max_blocks] int32 physical block ids
    ctx_len,                     # tokens already cached (int or 0-d)
    true_len,                    # valid tokens in token_ids (int or 0-d)
    lora_bank=None,              # stacked adapter bank (lora/bank.py)
    adapter_idx=None,            # scalar int32: this sequence's bank slot
):
    """One sequence's prompt chunk: its tokens attend to ctx_len cached
    tokens through the block table plus themselves causally
    (ops/paged_attention.py paged_prefill_attention, plain torch as the
    JAX package's is XLA), their K/V written into the cache in place.
    The draft model's catch-up (spec/draft.py) runs it.  Returns (logits
    [vocab] at the last valid token, kv_cache)."""
    k_cache, v_cache, k_scale, v_scale = unpack_kv(kv_cache)
    T = token_ids.shape[0]
    sel = _lora_sel(lora_bank, adapter_idx, cfg.dtype)
    x = params["embedding"][token_ids.long()].to(cfg.dtype)  # [T, d]
    for li, layer in enumerate(params["layers"]):
        lctx = _lora_ctx(lora_bank, sel, li)
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        q, k, v = _qkv(layer, cfg, h, positions, lora=lctx)  # [T, nh, hd]
        _write_kv(write_prompt_kv, kv_cache, li, k, v, block_table,
                  ctx_len, true_len)
        attn = paged_prefill_attention(q, k, v, k_cache, v_cache, li,
                                       block_table, ctx_len, true_len,
                                       k_scale=k_scale, v_scale=v_scale)
        x = x + _attn_out(layer, attn.reshape(T, cfg.q_dim), lora=lctx)
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        x = x + _mlp(layer, h)
    last = max(int(true_len) - 1, 0)
    return _logits(params, cfg, x[last]), kv_cache


# ---------------------------------------------------------------------------
# decode: one token per active row, batched
# ---------------------------------------------------------------------------


def decode(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [B] int32, last sampled token per row
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    ctx_lens: torch.Tensor,      # [B] int32, tokens in cache BEFORE this step
    valid: Optional[torch.Tensor] = None,  # [B] bool: active (non-padding) rows
    lora_bank=None,              # stacked adapter bank (lora/bank.py)
    adapter_idx=None,            # [B] int32: bank slot per row
):
    """One decode step for B rows: writes each token's K/V, attends over
    the paged context.  Returns (logits [B, vocab], kv_cache updated in
    place).  The engine decodes at a fixed B = max_num_seqs with
    full-width tables: a padding row has an all-zero table, so its write
    lands in the garbage block 0.  `valid` keeps the JAX signature; the
    dense layers do not read it (JAX's MoE capacity does)."""
    x = _decode_trunk(params, cfg, kv_cache, token_ids, positions,
                      block_tables, ctx_lens, lora_bank, adapter_idx)
    return _logits(params, cfg, x), kv_cache


def decode_multi(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [B] int32
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    ctx_lens: torch.Tensor,      # [B] int32
    num_steps: int,
    sample_fn=None,              # (logits [B, V], step_idx) -> tokens [B]
    valid: Optional[torch.Tensor] = None,  # [B] bool: active rows
    lora_bank=None,              # stacked adapter bank (lora/bank.py)
    adapter_idx=None,            # [B] int32: bank slot per row
):
    """`num_steps` decode steps in one call, the counterpart of the JAX
    package's lax.scan burst: each step's sampled ids feed the next step
    on the device, and positions and ctx_lens advance by one per step.
    The block tables are fixed across the burst, so callers allocate the
    blocks of positions [ctx, ctx + num_steps) beforehand.  Nothing reads
    the host, so the burst can be captured as one CUDA graph
    (engine/graphs.py).  Returns (tokens [num_steps, B] int32, kv_cache
    updated in place)."""
    if sample_fn is None:
        def sample_fn(logits, _):
            return torch.argmax(logits, dim=-1).to(torch.int32)

    return _burst(decode, params, cfg, kv_cache, token_ids, positions,
                  block_tables, ctx_lens, num_steps, sample_fn, valid,
                  lora_bank, adapter_idx)


def decode_hidden(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [B] int32
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    ctx_lens: torch.Tensor,      # [B] int32
    valid: Optional[torch.Tensor] = None,
    lora_bank=None,
    adapter_idx=None,
):
    """decode minus the final projection: returns (final-norm hidden
    [B, d] in cfg.dtype, kv_cache updated in place).  The fused sampling
    epilogue (ops/fused_sampling.py) contracts it with unembed_weight tile
    by tile; `_logits` is `(this hidden @ unembed_weight).float()`."""
    x = _decode_trunk(params, cfg, kv_cache, token_ids, positions,
                      block_tables, ctx_lens, lora_bank, adapter_idx)
    return _final_norm(params, cfg, x), kv_cache


def decode_multi_hidden(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [B] int32
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    ctx_lens: torch.Tensor,      # [B] int32
    num_steps: int,
    sample_fn,                   # (hidden [B, d], step_idx) -> tokens [B]
    valid: Optional[torch.Tensor] = None,
    lora_bank=None,
    adapter_idx=None,
):
    """decode_multi with the fused sampling epilogue: each step hands
    `sample_fn` the final-norm hidden state instead of logits, so no
    [B, vocab] tensor exists in the burst.  Same chaining and position
    bookkeeping as decode_multi.  Returns (tokens [num_steps, B] int32,
    kv_cache updated in place)."""
    return _burst(decode_hidden, params, cfg, kv_cache, token_ids,
                  positions, block_tables, ctx_lens, num_steps, sample_fn,
                  valid, lora_bank, adapter_idx)


def _burst(step_fn, params, cfg: LlamaConfig, kv_cache: KVCache, token_ids,
           positions, block_tables, ctx_lens, num_steps: int, sample_fn,
           valid, lora_bank=None, adapter_idx=None):
    """`num_steps` steps of `step_fn` (decode or decode_hidden), each
    step's tokens (sample_fn of its output) the next step's input."""
    lora = ({"lora_bank": lora_bank, "adapter_idx": adapter_idx}
            if lora_bank is not None else {})
    toks = []
    for step in range(num_steps):
        out, kv_cache = step_fn(params, cfg, kv_cache, token_ids, positions,
                                block_tables, ctx_lens, valid=valid, **lora)
        token_ids = sample_fn(out, step).to(torch.int32)
        toks.append(token_ids)
        positions = positions + 1
        ctx_lens = ctx_lens + 1
    return torch.stack(toks), kv_cache


def _decode_trunk(params, cfg: LlamaConfig, kv_cache: KVCache, token_ids,
                  positions, block_tables, ctx_lens, lora_bank=None,
                  adapter_idx=None):
    """The decode layer stack.  Returns the hidden states [B, d] before
    the final norm."""
    k_cache, v_cache, k_scale, v_scale = unpack_kv(kv_cache)
    sel = _lora_sel(lora_bank, adapter_idx, cfg.dtype)
    x = params["embedding"][token_ids.long()].to(cfg.dtype)  # [B, d]
    pos1 = positions[:, None]  # [B, 1] for rope
    kv_lens = ctx_lens + 1
    for li, layer in enumerate(params["layers"]):
        lctx = _lora_ctx(lora_bank, sel, li)
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        q, k, v = _qkv(layer, cfg, h[:, None, :], pos1, lora=lctx)
        _write_kv(write_token_kv, kv_cache, li, k[:, 0], v[:, 0],
                  block_tables, ctx_lens)
        attn = paged_attention_decode(q[:, 0], k_cache, v_cache, li,
                                      block_tables, kv_lens,
                                      impl=cfg.attn_impl, k_scale=k_scale,
                                      v_scale=v_scale)  # [B, nh, hd]
        x = x + _attn_out(layer, attn.reshape(x.shape[0], cfg.q_dim),
                          lora=lctx)
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        x = x + _mlp(layer, h)
    return x

"""Llama-family decoder over a paged KV cache, in PyTorch.

The counterpart of dynamo_tpu/models/llama.py (dense and MoE): plain
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

MoE (the Mixtral family, `n_experts > 0`): the routed MLP replaces the
dense one in every forward (`_ffn`), with JAX's two dispatches: "dense"
(every expert computes every token, the router weights mask the
combine; dropless and batch-invariant) and "capacity" (GShard one-hot
placement into per-expert buffers of C slots, overflow dropped).  Both
are static-shape tensor programs (no host read, no data-dependent
size), so the decode, packed-prefill and verify programs capture them
as CUDA graphs.  Every forward passes its `valid` rows, so padding
claims no expert capacity.  Capacity dispatch is not packed-safe
(segments would share one capacity pool): the engine serves it through
the padded `prefill` and `prefill_batched` instead, as JAX does.
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
    # MoE (Mixtral family): 0 experts = the dense MLP.  moe_dispatch
    # "dense" (dropless, batch-invariant; E/k x the routed FLOPs) or
    # "capacity" (GShard: an expert's tokens past
    # C = ceil(T*k/E * moe_capacity_factor) are dropped), as in JAX
    n_experts: int = 0
    experts_per_token: int = 2
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25

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


# the JAX package's presets, with torch dtypes
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
    # needs tensor parallelism to fit (ROADMAP.md Queue 1 item 8)
    "llama-70b": LlamaConfig(
        name="llama-70b", vocab_size=128256, d_model=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, head_dim=128, ffn_dim=28672,
        max_context=131072,
    ),
    "qwen3-32b": LlamaConfig(
        name="qwen3-32b", vocab_size=151936, d_model=5120, n_layers=64,
        n_heads=64, n_kv_heads=8, head_dim=128, ffn_dim=25600,
        qk_norm=True, rope_theta=1000000.0, max_context=40960,
    ),
    # MoE family
    "tiny-moe": LlamaConfig(
        name="tiny-moe", vocab_size=256, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128,
        n_experts=4, experts_per_token=2,
    ),
    "mixtral-8x7b": LlamaConfig(
        name="mixtral-8x7b", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=14336,
        rope_theta=1000000.0, max_context=32768,
        n_experts=8, experts_per_token=2,
    ),
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """Random-init parameters with the JAX package's shapes and scales
    (normal * 1/sqrt(fan_in), embedding * 0.02, norms 1; a MoE layer's
    router `moe_gate` [d, E] and expert stacks `moe_w_gate`/`moe_w_up`
    [E, d, ffn] and `moe_w_down` [E, ffn, d] instead of the dense MLP,
    each scaled by its fan-in).  The draws come
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
        }
        if cfg.n_experts > 0:
            E, d, f = cfg.n_experts, cfg.d_model, cfg.ffn_dim
            layer["moe_gate"] = dense((d, E))
            layer["moe_w_gate"] = dense((E, d, f), scale=1.0 / math.sqrt(d))
            layer["moe_w_up"] = dense((E, d, f), scale=1.0 / math.sqrt(d))
            layer["moe_w_down"] = dense((E, f, d), scale=1.0 / math.sqrt(f))
        else:
            layer["w_gate"] = dense((cfg.d_model, cfg.ffn_dim))
            layer["w_up"] = dense((cfg.d_model, cfg.ffn_dim))
            layer["w_down"] = dense((cfg.ffn_dim, cfg.d_model))
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


def _moe_router(layer, cfg: LlamaConfig, x: torch.Tensor):
    """Top-k routing of x [T, d]: (weights [T, k] fp32, the softmax of
    the k selected fp32 router logits; expert ids [T, k] int64).  The
    selection keeps `lax.top_k`'s order, the lower expert first among
    equal logits (capacity positions depend on the slot order), through
    a stable descending sort: `torch.topk` promises no order for ties."""
    router = x.float() @ layer["moe_gate"].float()  # [T, E]
    vals, ids = torch.sort(router, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return torch.softmax(vals[:, :k], dim=-1), ids[:, :k]


def moe_dispatch_dense(layer, cfg: LlamaConfig, x: torch.Tensor,
                       top_w: torch.Tensor, top_e: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dropless masked-dense dispatch for precomputed routing (top_w,
    top_e [T, k]): every expert computes every token ([E, T, ffn]
    batched products), and the [T, E] router weight matrix, zero off the
    selected experts and on invalid rows, masks the combine in
    cfg.dtype.  Batch-invariant by construction."""
    T = x.shape[0]
    wmat = torch.zeros(T, cfg.n_experts, dtype=torch.float32,
                       device=x.device).scatter_(1, top_e, top_w)
    if valid is not None:
        wmat = wmat * valid.to(torch.float32)[:, None]
    h = torch.nn.functional.silu(torch.matmul(x, layer["moe_w_gate"])) \
        * torch.matmul(x, layer["moe_w_up"])             # [E, T, ffn]
    eout = torch.matmul(h, layer["moe_w_down"])           # [E, T, d]
    return torch.einsum("etd,te->td", eout, wmat.to(cfg.dtype))


def _moe_mlp_dense(layer, cfg: LlamaConfig, x: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    top_w, top_e = _moe_router(layer, cfg, x)
    return moe_dispatch_dense(layer, cfg, x, top_w, top_e, valid)


def moe_capacity(cfg: LlamaConfig, T: int) -> int:
    """An expert's buffer slots for a T-token dispatch, with JAX's float
    expression order: max(1, ceil(T * k / E * capacity_factor))."""
    return max(1, math.ceil(T * cfg.experts_per_token / cfg.n_experts
                            * cfg.moe_capacity_factor))


def moe_dispatch_capacity(layer, cfg: LlamaConfig, x: torch.Tensor,
                          top_w: torch.Tensor, top_e: torch.Tensor,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """GShard capacity dispatch for precomputed routing, JAX's
    formulation: each (token, slot) in flattened order takes the next
    position of its expert's buffer of C = moe_capacity(cfg, T) slots (a
    cumsum over the one-hot assignments), a position past C places
    nothing (the token's expert output is dropped; its residual passes
    through), and one-hot dispatch [T*k, E, C] and combine tensors move
    the tokens in and out with products.  Rows with valid False claim no
    position.  Static shapes throughout."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(cfg, T)
    e_flat = top_e.reshape(-1)                           # [Tk]
    w_flat = top_w.reshape(-1)
    onehot = (e_flat[:, None] == torch.arange(
        E, device=x.device)).to(torch.int32)             # [Tk, E]
    if valid is not None:
        onehot = onehot * valid.to(torch.int32).repeat_interleave(k)[:, None]
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                       e_flat[:, None])[:, 0]            # [Tk]
    # jax.nn.one_hot(pos, C): an all-zero row for pos >= C (the drop)
    slot = (pos[:, None] == torch.arange(C, device=x.device)).float()
    disp = onehot.float()[:, :, None] * slot[:, None, :]  # [Tk, E, C]
    comb = disp * w_flat[:, None, None]
    x_rep = x.repeat_interleave(k, dim=0)                # [Tk, d]
    ein = torch.einsum("sec,sd->ecd", disp.to(cfg.dtype), x_rep)
    h = torch.nn.functional.silu(torch.matmul(ein, layer["moe_w_gate"])) \
        * torch.matmul(ein, layer["moe_w_up"])           # [E, C, ffn]
    eout = torch.matmul(h, layer["moe_w_down"])           # [E, C, d]
    out = torch.einsum("sec,ecd->sd", comb.to(cfg.dtype), eout)
    # the k slots summed in fp32, as jnp.sum upcasts bf16 operands
    return out.reshape(T, k, d).float().sum(dim=1).to(x.dtype)


def _moe_mlp(layer, cfg: LlamaConfig, x: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    top_w, top_e = _moe_router(layer, cfg, x)
    return moe_dispatch_capacity(layer, cfg, x, top_w, top_e, valid)


def _ffn(layer, cfg: LlamaConfig, x: torch.Tensor,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense MLP, or the routed one over x [..., d] (leading dims
    flattened into one dispatch, `valid` [...] with them).  Raises
    JAX's ValueError on an unknown moe_dispatch."""
    if cfg.n_experts <= 0:
        return _mlp(layer, x)
    if cfg.moe_dispatch not in ("dense", "capacity"):
        raise ValueError(
            f"moe_dispatch must be 'dense' or 'capacity', "
            f"got {cfg.moe_dispatch!r}")
    lead = x.shape[:-1]
    if valid is not None:
        valid = valid.reshape(-1)
    moe = _moe_mlp if cfg.moe_dispatch == "capacity" else _moe_mlp_dense
    out = moe(layer, cfg, x.reshape(-1, x.shape[-1]), valid)
    return out.reshape(*lead, x.shape[-1])


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
    each segment's paged context.  Capacity-dispatch MoE is not
    packed-safe (the segments would share one expert-capacity pool); the
    engine serves it through `prefill`/`prefill_batched`, as JAX does.
    Returns (logits [S, vocab] at each segment's last packed token,
    kv_cache updated in place)."""
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
        x = x + _ffn(layer, cfg, h, valid=valid)
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
    # padding past true_len must not claim MoE expert capacity
    valid = (torch.arange(T, device=token_ids.device) < true_len
             if cfg.n_experts > 0 else None)
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
        x = x + _ffn(layer, cfg, h, valid=valid)
    last = max(int(true_len) - 1, 0)
    return _logits(params, cfg, x[last]), kv_cache


def prefill_batched(
    params: Params,
    cfg: LlamaConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [Bp, T_pad] int32 (a chunk per row)
    positions: torch.Tensor,     # [Bp, T_pad] int32 absolute positions
    block_tables: torch.Tensor,  # [Bp, max_blocks] int32
    ctx_lens,                    # [Bp] tokens already cached per row
    true_lens,                   # [Bp] valid tokens per row
    lora_bank=None,              # stacked adapter bank (lora/bank.py)
    adapter_idx=None,            # [Bp] int32: bank slot per row
):
    """Several sequences' padded chunks in one call, the counterpart of
    the JAX package's `prefill_batched` and the same function as
    `prefill` per row: each row's K/V writes and plain padded attention
    (ops/paged_attention.py) run per row over the shared cache, a row
    with true_len 0 writes only the garbage block, and MoE dispatches
    per row, so each sequence keeps its own expert-capacity pool as in
    the B = 1 program (co-scheduled requests never capacity-drop each
    other's tokens).  Reads the lengths on the host (pass host arrays or
    CPU tensors): the engine runs it eagerly.  Returns (logits [Bp,
    vocab] at each row's last valid token, kv_cache updated in
    place)."""
    k_cache, v_cache, k_scale, v_scale = unpack_kv(kv_cache)
    Bp, T = token_ids.shape
    ctx = [int(c) for c in ctx_lens]
    lens = [int(n) for n in true_lens]
    sel = _lora_sel(lora_bank, adapter_idx, cfg.dtype)
    span = torch.arange(T, device=token_ids.device)
    valid = torch.stack([span < n for n in lens])             # [Bp, T]
    x = params["embedding"][token_ids.long()].to(cfg.dtype)  # [Bp, T, d]
    for li, layer in enumerate(params["layers"]):
        lctx = _lora_ctx(lora_bank, sel, li)
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        q, k, v = _qkv(layer, cfg, h, positions, lora=lctx)  # [Bp,T,nh,hd]
        attn = []
        for b in range(Bp):
            _write_kv(write_prompt_kv, kv_cache, li, k[b], v[b],
                      block_tables[b], ctx[b], lens[b])
            attn.append(paged_prefill_attention(
                q[b], k[b], v[b], k_cache, v_cache, li, block_tables[b],
                ctx[b], lens[b], k_scale=k_scale, v_scale=v_scale))
        attn = torch.stack(attn)
        x = x + _attn_out(layer, attn.reshape(Bp, T, cfg.q_dim), lora=lctx)
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        if cfg.n_experts > 0:
            x = x + torch.stack([_ffn(layer, cfg, h[b], valid=valid[b])
                                 for b in range(Bp)])
        else:
            x = x + _ffn(layer, cfg, h)
    xl = torch.stack([x[b, max(n - 1, 0)] for b, n in enumerate(lens)])
    return _logits(params, cfg, xl), kv_cache


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
    lands in the garbage block 0.  `valid` reaches the MoE dispatch
    (padding rows claim no expert capacity); the dense layers do not
    read it."""
    x = _decode_trunk(params, cfg, kv_cache, token_ids, positions,
                      block_tables, ctx_lens, valid, lora_bank, adapter_idx)
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
                      block_tables, ctx_lens, valid, lora_bank, adapter_idx)
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
                  positions, block_tables, ctx_lens, valid=None,
                  lora_bank=None, adapter_idx=None):
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
        x = x + _ffn(layer, cfg, h, valid=valid)
    return x

"""DeepSeek-family decoder (MLA attention + DeepSeekMoE) over the paged
latent cache, in PyTorch.

The counterpart of dynamo_tpu/models/deepseek.py, with the functional
contract of models/llama.py (prefill / prefill_batched / decode /
decode_multi over a paged cache, the cache updated IN PLACE and still
returned), so the engine serves both families through
`models.get_family(cfg)`.  The parameter tree and its names are the JAX
package's, weights stored [in, out], so models/convert.py carries them
across unchanged.

Architecture (DeepSeek V2/V3 lineage):
  * MLA: queries optionally LoRA-compressed (q_lora_rank), K/V
    compressed to a kv_lora_rank latent plus a decoupled shared rope key;
    the cache holds (latent, rope key) pairs (ops/mla_attention.py).
    Decode runs the weight-absorbed form, prefill up-projects per chunk.
  * DeepSeekMoE: first_k_dense dense layers, then MoE layers with
    n_shared_experts always-on experts plus top-k routed experts,
    dispatched by models/llama.py's dense or capacity dispatch and scaled
    by routed_scaling_factor.  V2 routes by softmax (group max when
    n_group > 1), V3 by sigmoid plus the e_score_correction_bias
    (`moe_gate_bias`, fp32) for the choice only, group top-2 sums,
    renormalized.

The family has no packed prefill, no spec verify, no LoRA and no
hidden-state decode surface, and no int8 cache (no
`kv_cache_scale_shapes`): the engine serves its prefill through the
padded programs and falls back to bf16 and the "off" epilogue, as the
JAX engine does.  YaRN long-context scaling is not implemented, as in
JAX.

Tensor parallelism (parallel/mesh.py, JAX's sharding rules): a rank
holds its heads through the query projection (wq or wq_b, columns), the
latent up-projections w_uk/w_uv (axis 0) and wo (rows), its experts
(the moe_w_* stacks on the expert axis), its columns of the shared
experts and of the dense layers' MLP, and its slice of the vocabulary;
wq_a, wkv_a, the router and the norms are whole, and so is the latent
cache, which every rank writes alike.  It runs the functions below with
its shard's config (shard_config: its heads and experts), the tensor
group on the tree as `params["tp"]`, as models/llama.py does: the
embedding and logits are vocab-parallel, wo is followed by one sum and
each layer's MLP (routed, shared and dense parts together) by one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.mla_attention import (
    mla_decode_attention,
    mla_prefill_attention,
    score_scale,
)
from ..ops.paged_attention import write_prompt_kv, write_token_kv
from ..parallel.mesh import shard_leaf
from .llama import (
    _burst,
    _embed,
    _logits,
    _mlp,
    _reduce,
    _expert_shard,
    moe_dispatch_capacity,
    moe_dispatch_dense,
    rms_norm,
    rope,
)

Params = Dict[str, Any]
KVCache = Tuple[torch.Tensor, torch.Tensor]  # (latent, rope key)


@dataclass(frozen=True)
class DeepseekConfig:
    name: str = "tiny-mla"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    # MLA dims
    q_lora_rank: int = 0          # 0 = full query projection (V2-Lite)
    kv_lora_rank: int = 64        # R: latent cache dim per token
    qk_nope_head_dim: int = 32
    qk_rope_head_dim: int = 16    # dr: shared rope key dim per token
    v_head_dim: int = 32
    # FFN / DeepSeekMoE
    ffn_dim: int = 1408           # dense layers
    moe_ffn_dim: int = 0          # per-expert hidden (0 -> ffn_dim)
    n_experts: int = 0            # 0 = all layers dense
    experts_per_token: int = 2
    n_shared_experts: int = 0     # always-on experts (hidden n * moe_ffn)
    first_k_dense: int = 1        # leading dense layers before MoE starts
    routed_scaling_factor: float = 1.0
    moe_dispatch: str = "dense"   # models/llama.py: dense | capacity
    moe_capacity_factor: float = 1.25
    # router semantics (HF DeepseekV3TopkRouter / V2 MoEGate): V2
    # softmax scores, plain top-k, no renorm; V3 sigmoid scores plus
    # e_score_correction_bias for the CHOICE (weights stay the raw
    # scores), group-limited top-k, renormalized
    moe_scoring: str = "softmax"  # "softmax" | "sigmoid"
    norm_topk_prob: bool = False
    n_group: int = 1              # expert groups for group-limited top-k
    topk_group: int = 1           # groups kept
    # misc
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    max_context: int = 8192
    dtype: torch.dtype = torch.bfloat16
    # the plain attention (JAX's "jnp"): the absorbed decode never
    # consults an attention kernel (SUPPORTED_ATTN_IMPLS)
    attn_impl: str = "torch"
    eos_token_ids: Tuple[int, ...] = (2,)
    qk_norm: bool = False         # unused; the surface of LlamaConfig

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.qk_head_dim

    def _moe_layer(self, li: int) -> bool:
        return self.n_experts > 0 and li >= self.first_k_dense


# the absorbed MLA decode dispatches to no attention kernel, so an engine
# attn_impl other than the plain one would be ignored: the engine
# config rejects it against this set (engine/config.py resolve_model)
SUPPORTED_ATTN_IMPLS = ("torch",)

# the JAX package's presets, with torch dtypes
PRESETS: Dict[str, DeepseekConfig] = {
    # test scale
    "tiny-mla": DeepseekConfig(),
    "tiny-mla-moe": DeepseekConfig(
        name="tiny-mla-moe", vocab_size=256, d_model=64, n_layers=3,
        n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, ffn_dim=128, moe_ffn_dim=64,
        n_experts=4, experts_per_token=2, n_shared_experts=1,
        first_k_dense=1,
    ),
    # public architecture shapes
    "deepseek-v2-lite": DeepseekConfig(
        name="deepseek-v2-lite", vocab_size=102400, d_model=2048,
        n_layers=27, n_heads=16, q_lora_rank=0, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        ffn_dim=10944, moe_ffn_dim=1408, n_experts=64,
        experts_per_token=6, n_shared_experts=2, first_k_dense=1,
        routed_scaling_factor=1.0, rope_theta=10000.0,
        max_context=163840,
    ),
    # DeepSeek-R1 (the V3 architecture); needs tensor parallelism to fit
    # (ROADMAP.md Queue 1 item 8)
    "deepseek-r1": DeepseekConfig(
        name="deepseek-r1", vocab_size=129280, d_model=7168,
        n_layers=61, n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        ffn_dim=18432, moe_ffn_dim=2048, n_experts=256,
        experts_per_token=8, n_shared_experts=1, first_k_dense=3,
        routed_scaling_factor=2.5, moe_scoring="sigmoid",
        norm_topk_prob=True, n_group=8, topk_group=4,
        rope_theta=10000.0, max_context=163840,
    ),
}


def kv_cache_shapes(cfg: DeepseekConfig, num_blocks: int,
                    block_size: int) -> tuple:
    """(latent cache, rope-key cache) in the port's block layout with one
    head (ops/mla_attention.py).  The family has no
    `kv_cache_scale_shapes` on purpose: the latent is already a ~4x
    compression of per-head K/V, and the absorbed decode reads it inside
    products where per-position int8 scales do not factor out, so the
    engine falls back to a bf16 cache, as JAX's does."""
    return ((cfg.n_layers, 1, num_blocks, block_size, cfg.kv_lora_rank),
            (cfg.n_layers, 1, num_blocks, block_size, cfg.qk_rope_head_dim))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: DeepseekConfig, generator: torch.Generator,
                device: Optional[torch.device] = None,
                shard: Optional[Tuple[int, int]] = None) -> Params:
    """Random-init parameters with the JAX package's tree, shapes and
    scales (normal * 1/sqrt(fan_in), the embedding * 0.02, w_uk/w_uv *
    1/sqrt(R), norms 1, a V3 router's `moe_gate_bias` fp32 zeros).  The
    draws come from `generator` (on `device`, default the generator's),
    so they are not the JAX package's values.

    shard=(rank, tp): rank's tensor-parallel shard of the same tree (the
    full one cut by parallel/mesh.py shard_params), each tensor drawn
    whole in the same order and cut at once, as models/llama.py's."""
    dev = torch.device(device) if device is not None else generator.device
    rank, tp = shard if shard is not None else (0, 1)

    def dense(shape, scale=None, name=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (shard_leaf(name, w, rank, tp) * scale).to(cfg.dtype)

    def ones(n):
        return {"norm": torch.ones(n, dtype=torch.float32, device=dev)}

    R, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv, d = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.d_model
    params: Params = {"embedding": dense((cfg.vocab_size, d), scale=0.02,
                                         name="embedding"),
                      "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), name="lm_head")
    layers = []
    for li in range(cfg.n_layers):
        layer: Params = {
            "attn_norm": ones(d),
            "mlp_norm": ones(d),
            "wkv_a": dense((d, R + dr)),
            "kv_a_norm": ones(R),
            "w_uk": dense((cfg.n_heads, R, dn), scale=1.0 / math.sqrt(R),
                          name="w_uk"),
            "w_uv": dense((cfg.n_heads, R, dv), scale=1.0 / math.sqrt(R),
                          name="w_uv"),
            "wo": dense((cfg.n_heads * dv, d), name="wo"),
        }
        if cfg.q_lora_rank > 0:
            layer["wq_a"] = dense((d, cfg.q_lora_rank))
            layer["q_a_norm"] = ones(cfg.q_lora_rank)
            layer["wq_b"] = dense((cfg.q_lora_rank, cfg.q_dim), name="wq_b")
        else:
            layer["wq"] = dense((d, cfg.q_dim), name="wq")
        if cfg._moe_layer(li):
            E = cfg.n_experts
            f = cfg.moe_ffn_dim or cfg.ffn_dim
            layer["moe_gate"] = dense((d, E))
            if cfg.moe_scoring == "sigmoid":
                # the V3 choice bias (loaded from checkpoints)
                layer["moe_gate_bias"] = torch.zeros(E, dtype=torch.float32,
                                                     device=dev)
            layer["moe_w_gate"] = dense((E, d, f), scale=1.0 / math.sqrt(d),
                                        name="moe_w_gate")
            layer["moe_w_up"] = dense((E, d, f), scale=1.0 / math.sqrt(d),
                                      name="moe_w_up")
            layer["moe_w_down"] = dense((E, f, d), scale=1.0 / math.sqrt(f),
                                        name="moe_w_down")
            if cfg.n_shared_experts > 0:
                sf = cfg.n_shared_experts * f
                layer["shared"] = {"w_gate": dense((d, sf), name="w_gate"),
                                   "w_up": dense((d, sf), name="w_up"),
                                   "w_down": dense((sf, d), name="w_down")}
        else:
            layer["w_gate"] = dense((d, cfg.ffn_dim), name="w_gate")
            layer["w_up"] = dense((d, cfg.ffn_dim), name="w_up")
            layer["w_down"] = dense((cfg.ffn_dim, d), name="w_down")
        layers.append(layer)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _q_proj(layer, cfg: DeepseekConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """x [..., T, d] -> (q_nope [..., T, nh, dn], q_rope [..., T, nh, dr]
    with rope applied)."""
    *lead, T, _ = x.shape
    if cfg.q_lora_rank > 0:
        q = rms_norm(x @ layer["wq_a"], layer["q_a_norm"]["norm"],
                     cfg.rms_eps) @ layer["wq_b"]
    else:
        q = x @ layer["wq"]
    q = q.reshape(*lead, T, cfg.n_heads, cfg.qk_head_dim)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(layer, cfg: DeepseekConfig, x: torch.Tensor,
               positions: torch.Tensor):
    """x [..., T, d] -> (c [..., T, R] the normed latent, kr [..., T, dr]
    the rope-applied shared key)."""
    R = cfg.kv_lora_rank
    kv = x @ layer["wkv_a"]                       # [..., T, R + dr]
    c = rms_norm(kv[..., :R], layer["kv_a_norm"]["norm"], cfg.rms_eps)
    kr = rope(kv[..., None, R:], positions, cfg.rope_theta)[..., 0, :]
    return c, kr


def _top_k(x: torch.Tensor, k: int):
    """(values, ids) of the k largest along the last axis in `lax.top_k`'s
    order, the lower index first among equals, through a stable
    descending sort (`torch.topk` promises no order for ties)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _ds_router(layer, cfg: DeepseekConfig, x: torch.Tensor):
    """DeepSeek routing of x [T, d] -> (weights [T, k] fp32, expert ids
    [T, k] int64), HF DeepseekV3TopkRouter's: the scores are sigmoid
    (V3) or softmax (V2); the CHOICE adds `moe_gate_bias` and keeps the
    topk_group best groups (a group's score the sum of its top 2 under
    sigmoid, its max under softmax; the other groups' choice scores set
    to 0.0, not -inf, as JAX does); the weights are the chosen experts'
    raw scores, optionally renormalized, times routed_scaling_factor."""
    T = x.shape[0]
    # the router is whole on every tensor-parallel rank: E counts every
    # expert, whatever the rank's config holds
    E, k = layer["moe_gate"].shape[-1], cfg.experts_per_token
    logits = x.float() @ layer["moe_gate"].float()
    if cfg.moe_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    choice = (scores + layer["moe_gate_bias"] if "moe_gate_bias" in layer
              else scores)
    if cfg.n_group > 1:
        per = E // cfg.n_group
        g = choice.reshape(T, cfg.n_group, per)
        if cfg.moe_scoring == "sigmoid":
            group_scores = _top_k(g, 2)[0].sum(-1)      # [T, n_group]
        else:
            group_scores = g.max(dim=-1).values
        _, keep = _top_k(group_scores, cfg.topk_group)
        gmask = torch.zeros(T, cfg.n_group, dtype=torch.bool,
                            device=x.device).scatter_(1, keep, True)
        choice = torch.where(gmask.repeat_interleave(per, dim=1), choice,
                             0.0)
    _, top_e = _top_k(choice, k)
    top_w = torch.gather(scores, 1, top_e)
    if cfg.norm_topk_prob:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return top_w * cfg.routed_scaling_factor, top_e


def _ds_ffn(layer, cfg: DeepseekConfig, x: torch.Tensor,
            valid: Optional[torch.Tensor] = None,
            shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """A dense layer's MLP, or DeepSeekMoE over x [T, d]: the shared
    experts plus the routed ones (`_ds_router`, then models/llama.py's
    dispatch over the moe_* keys; `valid` [T] rows claim expert
    capacity).  Under tp (`shard`, llama.py `_expert_shard`) it is the
    rank's partial sum (its routed experts, its columns of the shared
    experts or of the dense MLP): the caller reduces it once."""
    if "moe_gate" not in layer:
        return _mlp(layer, x)
    top_w, top_e = _ds_router(layer, cfg, x)
    dispatch = (moe_dispatch_capacity if cfg.moe_dispatch == "capacity"
                else moe_dispatch_dense)
    out = dispatch(layer, cfg, x, top_w, top_e, valid, shard)
    if "shared" in layer:
        out = out + _mlp(layer["shared"], x)
    return out


def _absorb_q(layer, q_nope: torch.Tensor) -> torch.Tensor:
    """q_nope [..., nh, dn] @ w_uk^T -> the absorbed query [..., nh, R],
    an fp32 product cast back to q_nope's dtype, as in JAX."""
    return torch.einsum("...hd,hrd->...hr", q_nope.float(),
                        layer["w_uk"].float()).to(q_nope.dtype)


def _attn_layer_prefill(layer, cfg: DeepseekConfig, kv_cache: KVCache,
                        li: int, h: torch.Tensor, positions, block_table,
                        ctx_len, true_len) -> torch.Tensor:
    """One sequence's chunk through layer li's MLA: its latents written
    into the cache (in place), then attention.  Returns [T, nh * dv]."""
    c_cache, kr_cache = kv_cache
    q_nope, q_rope = _q_proj(layer, cfg, h, positions)
    c, kr = _kv_latent(layer, cfg, h, positions)
    write_prompt_kv(c_cache, kr_cache, li, c[:, None, :], kr[:, None, :],
                    block_table, ctx_len, true_len)
    attn = mla_prefill_attention(q_nope, q_rope, c, kr, c_cache, kr_cache,
                                 li, block_table, ctx_len, true_len,
                                 layer["w_uk"], layer["w_uv"])
    return attn.reshape(h.shape[0], -1)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill(
    params: Params,
    cfg: DeepseekConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [T_pad] int32 (one sequence, padded)
    positions: torch.Tensor,     # [T_pad] int32
    block_table: torch.Tensor,   # [max_blocks] int32
    ctx_len,                     # tokens already cached (int or 0-d)
    true_len,                    # valid tokens in token_ids (int or 0-d)
):
    """models/llama.py prefill's contract over the latent cache pair.
    Returns (logits [vocab] at the last valid token, kv_cache updated in
    place)."""
    T = token_ids.shape[0]
    valid = torch.arange(T, device=token_ids.device) < true_len
    x = _embed(params, cfg, token_ids)                        # [T, d]
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        x = x + _reduce(params, _attn_layer_prefill(
            layer, cfg, kv_cache, li, h, positions, block_table, ctx_len,
            true_len) @ layer["wo"])
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        x = x + _reduce(params, _ds_ffn(layer, cfg, h, valid=valid,
                                        **_expert_shard(params)))
    last = max(int(true_len) - 1, 0)
    return _logits(params, cfg, x[last]), kv_cache


def prefill_batched(
    params: Params,
    cfg: DeepseekConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [Bp, T_pad] int32
    positions: torch.Tensor,     # [Bp, T_pad] int32
    block_tables: torch.Tensor,  # [Bp, max_blocks] int32
    ctx_lens,                    # [Bp] tokens already cached per row
    true_lens,                   # [Bp] valid tokens per row
):
    """Several sequences' padded chunks in one call, `prefill` per row
    (models/llama.py prefill_batched's contract): each row's latent
    writes and attention, and each MoE layer's dispatch, per row, so
    co-scheduled sequences keep separate expert-capacity pools, as JAX's
    vmap does.  Reads the lengths on the host.  Returns (logits
    [Bp, vocab] at each row's last valid token, kv_cache updated in
    place)."""
    Bp, T = token_ids.shape
    ctx = [int(c) for c in ctx_lens]
    lens = [int(n) for n in true_lens]
    span = torch.arange(T, device=token_ids.device)
    valid = [span < n for n in lens]
    x = _embed(params, cfg, token_ids)                       # [Bp, T, d]
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        attn = torch.stack([
            _attn_layer_prefill(layer, cfg, kv_cache, li, h[b], positions[b],
                                block_tables[b], ctx[b], lens[b])
            for b in range(Bp)])
        x = x + _reduce(params, attn @ layer["wo"])
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        x = x + _reduce(params, torch.stack([
            _ds_ffn(layer, cfg, h[b], valid=valid[b], **_expert_shard(params))
            for b in range(Bp)]))
    xl = torch.stack([x[b, max(n - 1, 0)] for b, n in enumerate(lens)])
    return _logits(params, cfg, xl), kv_cache


# ---------------------------------------------------------------------------
# decode (weight-absorbed)
# ---------------------------------------------------------------------------


def decode(
    params: Params,
    cfg: DeepseekConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [B] int32
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    ctx_lens: torch.Tensor,      # [B] int32, tokens cached BEFORE this step
    valid: Optional[torch.Tensor] = None,  # [B] bool: active rows
):
    """One weight-absorbed decode step for B rows, every row at once (no
    host read, so the engine captures the bursts as CUDA graphs): each
    token's latent pair is written at ctx_lens (a padding row's all-zero
    table sends it to the garbage block 0), the absorbed queries attend
    over the latent cache.  `valid` reaches the MoE dispatch.  Returns
    (logits [B, vocab], kv_cache updated in place)."""
    c_cache, kr_cache = kv_cache
    x = _embed(params, cfg, token_ids)                       # [B, d]
    B = x.shape[0]
    pos1 = positions[:, None]
    scale = score_scale(cfg.qk_head_dim)
    kv_lens = ctx_lens + 1
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"]["norm"], cfg.rms_eps)
        q_nope, q_rope = _q_proj(layer, cfg, h[:, None, :], pos1)
        c, kr = _kv_latent(layer, cfg, h[:, None, :], pos1)
        write_token_kv(c_cache, kr_cache, li, c, kr, block_tables, ctx_lens)
        q_abs = _absorb_q(layer, q_nope[:, 0])              # [B, nh, R]
        attn = mla_decode_attention(q_abs, q_rope[:, 0], c_cache, kr_cache,
                                    li, block_tables, kv_lens, layer["w_uv"],
                                    scale)                  # [B, nh, dv]
        x = x + _reduce(params, attn.reshape(B, -1) @ layer["wo"])
        h = rms_norm(x, layer["mlp_norm"]["norm"], cfg.rms_eps)
        x = x + _reduce(params, _ds_ffn(layer, cfg, h, valid=valid,
                                        **_expert_shard(params)))
    return _logits(params, cfg, x), kv_cache


def decode_multi(
    params: Params,
    cfg: DeepseekConfig,
    kv_cache: KVCache,
    token_ids: torch.Tensor,     # [B] int32
    positions: torch.Tensor,     # [B] int32
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    ctx_lens: torch.Tensor,      # [B] int32
    num_steps: int,
    sample_fn=None,              # (logits [B, V], step_idx) -> tokens [B]
    valid: Optional[torch.Tensor] = None,
):
    """`num_steps` decode steps in one call (models/llama.py decode_multi's
    contract): each step's sampled ids feed the next on the device.
    Returns (tokens [num_steps, B] int32, kv_cache updated in place)."""
    if sample_fn is None:
        def sample_fn(logits, _):
            return torch.argmax(logits, dim=-1).to(torch.int32)

    return _burst(decode, params, cfg, kv_cache, token_ids, positions,
                  block_tables, ctx_lens, num_steps, sample_fn, valid)


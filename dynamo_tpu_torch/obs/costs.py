"""The per-program cost count: FLOPs and bytes of each captured program.

The port's counterpart of dynamo_tpu/obs/compile_watch.py `xla_costs`:
the JAX engine reads each compiled program's FLOPs and bytes accessed
off XLA's cost analysis, which includes the Pallas kernels' own
`CostEstimate`s; the port has no compiler to ask, so it counts them from
the model config, the program's family and its capture key (the decode
burst k, or the stream bucket T), at the program's captured shapes.
The count is computed once per program when engine/graphs.py builds it,
and the engine stamps it on the FPM records as `xla_flops`/`xla_bytes`,
the names the roofline readers (planner/metrics.py FpmWindow, the JAX
planner) join on.

What is counted, per trunk pass of n tokens through L layers:

  * the matmuls: 2·n·(d·q + 2·d·kv + q·d + 3·d·ffn) per layer, the
    lm_head's 2·rows·d·vocab for the rows the program projects, and
    with a LoRA bank mounted the per-row masked delta of every target
    (x·A for every slot, then the [n, N·r] x [N·r, d_out] product);
  * a MoE layer (n_experts E > 0, experts_per_token k) replaces the
    dense MLP's 2·n·3·d·ffn with the router's 2·n·d·E and, under dense
    dispatch, every expert on every token, 2·n·E·3·d·ffn, plus the
    combine's 2·n·E·d; under capacity dispatch, per dispatch pool of m
    tokens with C = moe_capacity(m) slots an expert, 2·E·C·3·d·ffn plus
    the dispatch and combine products, 2·(m·k)·E·C·d each (one pool per
    program, one per row in the padded batched prefill);
  * attention by the Pallas kernels' cost formulas, so a torch worker's
    roofline reads as a JAX worker's: K1 (`paged_attention_decode_pallas`)
    per layer and step 2·2·B·nh·hd·max_blocks·bs FLOPs and
    2·B·nkv·max_blocks·bs·pos_bytes bytes; K3
    (`packed_prefill_attention_pallas`) per layer 2·2·Tp·nh·hd·chunks·C
    FLOPs and 2·tiles·nkv·chunks·C·pos_bytes bytes at the bucket's tiles
    (TB = min(128, pow2(T)), chunks of 8 blocks, C = 8·bs); pos_bytes is
    hd x the cache element size, plus one fp32 scale for int8;
  * bytes: every weight the program reads (each step of a burst reads
    them again), the LoRA bank, the embedding rows looked up, the K/V
    written (n tokens), the attention reads above, and the fp32 logits
    rows the program writes (none under the fused epilogue or in the
    catch-up program, which projects nothing).  A MoE layer reads
    every expert's weights and the router on every trunk pass;
  * the padded prefill programs of capacity-dispatch MoE (family
    prefill_padded, key (rows, T)) attend by the plain padded path:
    2·2·T·nh·hd·(S + T) FLOPs a row and layer over its S = max_blocks·bs
    context positions, whose K/V it reads (2·nkv·S·pos_bytes a row).

The DeepSeek MLA family (models/deepseek.py) has its own terms, from
the latent cache of R + dr elements a position (R = kv_lora_rank, dr =
qk_rope_head_dim) and the absorbed decode (ops/mla_attention.py):

  * the matmuls outside attention: the query projection (through the
    q_lora_rank bottleneck when it has one), the latent projection
    d·(R + dr) and the output nh·dv·d, 2·n·(...) per layer; the MLP of
    each of the first_k_dense dense layers; a MoE layer's router,
    routed experts by dispatch (as above, at the per-expert width
    moe_ffn_dim) and n_shared_experts always-on experts, 2·n·3·d·(ns·f);
  * decode attention per layer, step and row over S = max_blocks·bs
    positions: the absorption 2·nh·dn·R, scores 2·nh·S·(R + dr), the
    context 2·nh·S·R and its up-projection 2·nh·R·dv FLOPs, and the
    latents read, S·(R + dr) elements;
  * padded prefill attention per layer and row: the up-projection of the
    S + T latents to keys and values, 2·(S + T)·R·nh·(dn + dv), the
    scores 2·T·nh·(S + T)·(dn + dr) and the values 2·T·nh·(S + T)·dv,
    reading S·(R + dr) elements;
  * bytes: every weight (w_uk and w_uv included, every expert of a MoE
    layer, the V3 router's fp32 bias), the latents written (n·(R + dr)
    elements a layer), and the logits rows.
The family builds decode, guided and prefill_padded programs only (no
packed prefill, verify or catch-up), with a bf16 cache and no LoRA.

Elementwise work (norms, rope, softmax, sampling) is left out, as it is
small next to these terms.  `program_terms` returns the terms by name
(the tests hold the matmul term against torch's FlopCounterMode and the
attention terms against the Pallas formulas); `program_costs` sums them
into {"flops", "bytes"}.
"""

from __future__ import annotations

from typing import Dict

from ..models.deepseek import DeepseekConfig
from ..models.llama import moe_capacity

# the Pallas kernels' tiling constants (pallas_packed_prefill.py: the
# default chunk_cols and the token tile's cap)
K3_CHUNK_COLS = 8
K3_MAX_TOKEN_BLOCK = 128


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _elem_bytes(dtype) -> int:
    return dtype.itemsize


def pos_bytes(cfg, int8: bool) -> int:
    """Bytes per cached context position per kv head, as the Pallas
    kernels count them: hd elements, plus one fp32 scale for int8."""
    return cfg.head_dim * (1 if int8 else _elem_bytes(cfg.dtype)) \
        + (4 if int8 else 0)


def k1_costs(cfg, B: int, max_blocks: int, block_size: int,
             int8: bool) -> Dict[str, int]:
    """K1's CostEstimate for one layer and step (pallas_paged_attention.py
    `paged_attention_decode_pallas`)."""
    span = max_blocks * block_size
    return {"flops": 2 * 2 * B * cfg.n_heads * cfg.head_dim * span,
            "bytes": 2 * B * cfg.n_kv_heads * span * pos_bytes(cfg, int8)}


def k3_costs(cfg, T: int, max_blocks: int, block_size: int,
             int8: bool) -> Dict[str, int]:
    """K3's CostEstimate for one layer over a T-token stream
    (pallas_packed_prefill.py `packed_prefill_attention_pallas`)."""
    TB = min(K3_MAX_TOKEN_BLOCK, _pow2(T))
    n_tiles = -(-T // TB)
    Tp = n_tiles * TB
    bpc = max(1, min(max_blocks, K3_CHUNK_COLS))
    n_chunks = -(-max_blocks // bpc)
    C = bpc * block_size
    return {"flops": 2 * 2 * Tp * cfg.n_heads * cfg.head_dim * n_chunks * C,
            "bytes": 2 * n_tiles * cfg.n_kv_heads * n_chunks * C
            * pos_bytes(cfg, int8)}


def _attn_weights(cfg) -> int:
    """Matmul weight elements of one layer's attention projections."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return d * q + 2 * d * kv + q * d


def _dense_weights(cfg) -> int:
    """Matmul weight elements of one layer: the attention projections,
    and the dense MLP or, for MoE, the router and every expert."""
    d, f, E = cfg.d_model, cfg.ffn_dim, cfg.n_experts
    if E > 0:
        return _attn_weights(cfg) + d * E + E * 3 * d * f
    return _attn_weights(cfg) + 3 * d * f


def _routed_flops(cfg, n: int, f: int, pools: int = 1) -> int:
    """A MoE layer's router and routed experts (of hidden width f) over
    n tokens in the config's dispatch, over `pools` equal dispatch pools
    (capacity dispatch sizes C per pool)."""
    d, E, k = cfg.d_model, cfg.n_experts, cfg.experts_per_token
    router = 2 * n * d * E
    if cfg.moe_dispatch != "capacity":
        return router + 2 * n * E * 3 * d * f + 2 * n * E * d
    m = n // pools
    C = moe_capacity(cfg, m)
    return router + pools * (2 * E * C * 3 * d * f
                             + 2 * 2 * (m * k) * E * C * d)


def _mlp_flops(cfg, n: int, pools: int = 1) -> int:
    """One layer's MLP FLOPs over n tokens: the dense MLP, or the router
    and the experts (_routed_flops)."""
    if cfg.n_experts <= 0:
        return 2 * n * 3 * cfg.d_model * cfg.ffn_dim
    return _routed_flops(cfg, n, cfg.ffn_dim, pools)


def padded_attn_costs(cfg, T: int, max_blocks: int, block_size: int,
                      int8: bool) -> Dict[str, int]:
    """One row's plain padded prefill attention for one layer
    (ops/paged_attention.py paged_prefill_attention): scores and values
    over the S gathered context positions and the T chunk tokens."""
    S = max_blocks * block_size
    return {"flops": 2 * 2 * T * cfg.n_heads * cfg.head_dim * (S + T),
            "bytes": 2 * cfg.n_kv_heads * S * pos_bytes(cfg, int8)}


def _lora_dims(cfg):
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return ((d, q), (d, kv), (d, kv), (q, d))  # lora/bank.py TARGETS


def weight_bytes(cfg, lm_head: bool = True) -> int:
    """Bytes of the weights one trunk pass reads: every layer's matmul
    weights and fp32 norms, the final norm and (when the program
    projects) the [d, vocab] unembedding.  The embedding table is read
    by lookup (counted per token), not whole."""
    if isinstance(cfg, DeepseekConfig):
        return mla_weight_bytes(cfg, lm_head)
    wb = _elem_bytes(cfg.dtype)
    norms = 2 * cfg.d_model + (2 * cfg.head_dim if cfg.qk_norm else 0)
    n = cfg.n_layers * (_dense_weights(cfg) * wb + 4 * norms) \
        + 4 * cfg.d_model
    if lm_head:
        n += cfg.d_model * cfg.vocab_size * wb
    return n


def _trunk_terms(cfg, n: int, attn: Dict[str, int], int8: bool,
                 lora: tuple, logits_rows: int,
                 write_logits: bool, pools: int = 1) -> Dict[str, float]:
    """One pass of n tokens through the layer stack plus the projection
    of `logits_rows` rows; `attn` is one layer's attention cost; `lora`
    is (slots, rank), (0, 0) without a bank; `pools` the MoE dispatch
    pools the n tokens split into."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    wb = _elem_bytes(cfg.dtype)
    slots, rank = lora
    lora_flops = lora_bytes = 0
    if slots:
        for d_in, d_out in _lora_dims(cfg):
            lora_flops += 2 * n * slots * rank * (d_in + d_out)
            lora_bytes += slots * rank * (d_in + d_out) * wb
    kv_write = n * 2 * cfg.n_kv_heads * pos_bytes(cfg, int8)
    return {
        "matmul_flops": L * (2 * n * _attn_weights(cfg)
                             + _mlp_flops(cfg, n, pools) + lora_flops)
        + 2 * logits_rows * d * V,
        "attn_flops": L * attn["flops"],
        "weight_bytes": weight_bytes(cfg, lm_head=logits_rows > 0)
        + L * lora_bytes + n * d * wb,
        "kv_read_bytes": L * attn["bytes"],
        "kv_write_bytes": L * kv_write,
        "out_bytes": logits_rows * V * 4 if write_logits else 0,
    }


def program_terms(cfg, family: str, key, *, rows: int = 0, max_blocks: int,
                  block_size: int, int8: bool = False, lora=(0, 0),
                  epilogue: bool = False) -> Dict[str, float]:
    """The cost terms of one program.  `family` is decode, prefill,
    verify, catchup, guided or prefill_padded; `key` its build key:
    (greedy, k) for decode, the stream bucket T for
    prefill/verify/catchup, the window M for guided, (rows, T) for
    prefill_padded.  `rows` is the lane count B (decode, guided) or the
    row count of a bucket's descriptor (prefill: padded segments,
    catchup: 1; verify projects every stream position); prefill_padded
    takes its rows from the key.  Raises on a family it does not know:
    every program must have a count."""
    if isinstance(cfg, DeepseekConfig):
        return _mla_program_terms(cfg, family, key, rows=rows,
                                  max_blocks=max_blocks,
                                  block_size=block_size)
    if family == "decode":
        _, k = key
        one = _trunk_terms(cfg, rows, k1_costs(cfg, rows, max_blocks,
                                               block_size, int8),
                           int8, lora, rows, not epilogue)
        return {n: k * v for n, v in one.items()}
    if family == "guided":
        return _trunk_terms(cfg, rows, k1_costs(cfg, rows, max_blocks,
                                                block_size, int8),
                            int8, (0, 0), rows, True)
    if family in ("prefill", "verify", "catchup"):
        T = int(key)
        attn = k3_costs(cfg, T, max_blocks, block_size, int8)
        if family == "prefill":
            return _trunk_terms(cfg, T, attn, int8, lora, rows, True)
        if family == "verify":
            return _trunk_terms(cfg, T, attn, int8, (0, 0), T, True)
        return _trunk_terms(cfg, T, attn, int8, (0, 0), 0, False)
    if family == "prefill_padded":
        R, T = key
        attn = padded_attn_costs(cfg, T, max_blocks, block_size, int8)
        return _trunk_terms(cfg, R * T, {k: R * v for k, v in attn.items()},
                            int8, lora, R, True, pools=R)
    raise ValueError(f"no cost count for program family {family!r}")


# -- the MLA family ----------------------------------------------------------


def mla_pos_bytes(cfg) -> int:
    """Bytes of one cached position of the latent pair: R + dr elements."""
    return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * _elem_bytes(cfg.dtype)


def _mla_expert_dim(cfg) -> int:
    return cfg.moe_ffn_dim or cfg.ffn_dim


def _mla_proj_weights(cfg) -> int:
    """Weight elements of one layer's matmuls outside attention: the
    query projection (through its LoRA bottleneck), the latent
    projection and the output projection."""
    d, qr = cfg.d_model, cfg.q_lora_rank
    q = d * qr + qr * cfg.q_dim if qr > 0 else d * cfg.q_dim
    return q + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) \
        + cfg.n_heads * cfg.v_head_dim * d


def _mla_up_weights(cfg) -> int:
    """Elements of one layer's up-projections w_uk and w_uv."""
    return cfg.n_heads * cfg.kv_lora_rank * (cfg.qk_nope_head_dim
                                             + cfg.v_head_dim)


def _mla_ffn_weights(cfg, li: int) -> int:
    """Weight elements of layer li's MLP: the dense MLP, or the router,
    every routed expert and the shared experts."""
    d = cfg.d_model
    if not cfg._moe_layer(li):
        return 3 * d * cfg.ffn_dim
    E, f = cfg.n_experts, _mla_expert_dim(cfg)
    return d * E + E * 3 * d * f + 3 * d * cfg.n_shared_experts * f


def _mla_mlp_flops(cfg, li: int, n: int, pools: int = 1) -> int:
    """Layer li's MLP FLOPs over n tokens (`pools` equal capacity
    pools): the dense MLP, or the router, the routed experts of the
    config's dispatch and the shared experts."""
    d = cfg.d_model
    if not cfg._moe_layer(li):
        return 2 * n * 3 * d * cfg.ffn_dim
    f = _mla_expert_dim(cfg)
    return (_routed_flops(cfg, n, f, pools)
            + 2 * n * 3 * d * cfg.n_shared_experts * f)


def mla_weight_bytes(cfg, lm_head: bool = True) -> int:
    """weight_bytes of the MLA family: every layer's projections,
    up-projections and MLP (each expert of a MoE layer), its fp32 norms
    (attn, mlp, the latent's and the query bottleneck's) and a V3
    router's fp32 bias, the final norm and the unembedding."""
    wb = _elem_bytes(cfg.dtype)
    norms = 2 * cfg.d_model + cfg.kv_lora_rank + cfg.q_lora_rank
    n = 4 * cfg.d_model
    for li in range(cfg.n_layers):
        n += (_mla_proj_weights(cfg) + _mla_up_weights(cfg)
              + _mla_ffn_weights(cfg, li)) * wb + 4 * norms
        if cfg._moe_layer(li) and cfg.moe_scoring == "sigmoid":
            n += 4 * cfg.n_experts
    if lm_head:
        n += cfg.d_model * cfg.vocab_size * wb
    return n


def mla_decode_attn_costs(cfg, B: int, max_blocks: int,
                          block_size: int) -> Dict[str, int]:
    """One layer's absorbed decode step for B rows over the full table
    width (ops/mla_attention.py mla_decode_attention, with the query's
    absorption of models/deepseek.py `_absorb_q`)."""
    S = max_blocks * block_size
    R, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    flops = 2 * B * cfg.n_heads * (cfg.qk_nope_head_dim * R + S * (R + dr)
                                   + S * R + R * cfg.v_head_dim)
    return {"flops": flops, "bytes": B * S * mla_pos_bytes(cfg)}


def mla_prefill_attn_costs(cfg, T: int, max_blocks: int,
                           block_size: int) -> Dict[str, int]:
    """One row's padded prefill attention for one layer
    (mla_prefill_attention): the up-projection of the S gathered and T
    chunk latents, then scores and values over S + T positions."""
    S = max_blocks * block_size
    N = S + T
    nh, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    flops = 2 * N * cfg.kv_lora_rank * nh * (dn + dv) \
        + 2 * T * nh * N * (dn + cfg.qk_rope_head_dim) + 2 * T * nh * N * dv
    return {"flops": flops, "bytes": S * mla_pos_bytes(cfg)}


def _mla_trunk_terms(cfg, n: int, attn: Dict[str, int], logits_rows: int,
                     pools: int = 1) -> Dict[str, float]:
    """_trunk_terms of the MLA family: n tokens through the layer stack,
    `attn` one layer's attention cost, then `logits_rows` rows
    projected (their fp32 logits written)."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    matmul = sum(2 * n * _mla_proj_weights(cfg)
                 + _mla_mlp_flops(cfg, li, n, pools) for li in range(L))
    return {
        "matmul_flops": matmul + 2 * logits_rows * d * V,
        "attn_flops": L * attn["flops"],
        "weight_bytes": mla_weight_bytes(cfg, lm_head=logits_rows > 0)
        + n * d * _elem_bytes(cfg.dtype),
        "kv_read_bytes": L * attn["bytes"],
        "kv_write_bytes": L * n * mla_pos_bytes(cfg),
        "out_bytes": logits_rows * V * 4,
    }


def _mla_program_terms(cfg, family: str, key, *, rows: int,
                       max_blocks: int, block_size: int) -> Dict[str, float]:
    """program_terms of the MLA family: decode (k steps of B = rows),
    guided (one step) and prefill_padded ((rows, T) from the key)."""
    if family in ("decode", "guided"):
        k = key[1] if family == "decode" else 1
        one = _mla_trunk_terms(cfg, rows, mla_decode_attn_costs(
            cfg, rows, max_blocks, block_size), rows)
        return {n: k * v for n, v in one.items()}
    if family == "prefill_padded":
        R, T = key
        attn = mla_prefill_attn_costs(cfg, T, max_blocks, block_size)
        return _mla_trunk_terms(cfg, R * T,
                                {k: R * v for k, v in attn.items()}, R,
                                pools=R)
    raise ValueError(f"no cost count for program family {family!r} of the "
                     "MLA family (no packed prefill, verify or catch-up)")


def program_costs(cfg, family: str, key, **shape) -> Dict[str, float]:
    """{"flops", "bytes"} of one captured program (program_terms summed),
    the shape of the JAX watch's `xla_costs` entries."""
    t = program_terms(cfg, family, key, **shape)
    return {"flops": float(t["matmul_flops"] + t["attn_flops"]),
            "bytes": float(t["weight_bytes"] + t["kv_read_bytes"]
                           + t["kv_write_bytes"] + t["out_bytes"])}

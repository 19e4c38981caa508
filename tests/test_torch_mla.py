"""The port's DeepSeek MLA family against dynamo_tpu's (CPU, fp32).

The JAX package's parameters (init_params from a seed) cross to the
port through models/convert.py, inputs are made from numpy seeds, and
the same calls run through both packages:

* ops/mla_attention.py: the non-absorbed prefill and the absorbed
  decode against JAX's at R != dr, with no context, a context ending
  mid-block and a full table, to 1e-5 relative; the absorbed decode
  against a materialised non-absorbed oracle (tests/test_mla.py:138's
  identity) to 1e-5;
* `_ds_router` against JAX's: V2 softmax (one group, and group-limited
  by the group max), V3 sigmoid with a nonzero, partly negative choice
  bias, group top-2 sums, renormalized and scaled, each on random and on
  planted-tie logits: ids equal, weights within 1e-6;
* `prefill` (two chunks), `prefill_batched`, `decode` and
  `decode_multi` against JAX's at tests/test_mla.py's MLA32 (q_lora_rank
  24) and MLA32_MOE (shared experts, first_k_dense), in dense and
  capacity dispatch, and a V3-routed variant: logits within 1e-4
  relative, caches within 1e-5 through kv_cache_to_numpy;
* TorchEngine against JaxEngine: tiny-mla's greedy streams byte for
  byte (tests/test_mla.py:217's config), MLA32_MOE in both dispatches;
  the prefill through the padded programs, no packed or verify program;
* the fallbacks with JAX's texts: int8 -> bf16, fused -> off, spec ->
  plain decode, LoRA -> ValueError, packed_attn_impl -> ValueError, and
  attn_impl outside the family's plain one -> ValueError;
* a torch -> torch disagg round trip on the latent pair (both tiers):
  blocks bit-equal after inject, the stream equal to the aggregated
  engines' (tests/test_disagg.py:229);
* obs/costs.py's MLA terms against a count by hand, FlopCounterMode and
  the parameter tree's bytes;
* the worker's MDC advertises the effective settings (a fused, int8
  request on an MLA engine: "off" and bf16), as the JAX worker's; the
  CLI serves the DeepSeek presets and a DeepSeek checkpoint.
"""

import asyncio
import dataclasses
import logging
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import deepseek as jd
from dynamo_tpu.ops import mla_attention as jmla
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.disagg import broker
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, TorchEngineWorker
from dynamo_tpu_torch.models import deepseek as td
from dynamo_tpu_torch.models import get_family
from dynamo_tpu_torch.models.convert import (
    kv_cache_from_numpy,
    kv_cache_to_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.obs.costs import (
    mla_weight_bytes,
    program_costs,
    program_terms,
)
from dynamo_tpu_torch.ops import mla_attention as tmla
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

pytestmark = pytest.mark.allow_slow_callbacks

ATTN = 1e-5   # relative, the attention ops
LOGITS = 1e-4  # relative, the model's logits
CACHE = dict(rtol=1e-5, atol=1e-5)

# tests/test_mla.py's configs
MLA32 = dict(name="mla32", vocab_size=256, d_model=64, n_layers=2,
             n_heads=4, q_lora_rank=24, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             ffn_dim=128)
MLA32_MOE = dict(name="mla32-moe", vocab_size=256, d_model=64, n_layers=3,
                 n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16, ffn_dim=128,
                 moe_ffn_dim=64, n_experts=4, experts_per_token=2,
                 n_shared_experts=1, first_k_dense=1,
                 routed_scaling_factor=1.5)
# the V3 lineage: a query bottleneck, sigmoid routing with the choice
# bias over 2 groups, renormalized and scaled
MLA32_V3 = dict(MLA32_MOE, name="mla32-v3", q_lora_rank=24, n_experts=8,
                moe_scoring="sigmoid", norm_topk_prob=True, n_group=4,
                topk_group=2, routed_scaling_factor=2.5)


def cfgs(shapes, **kw):
    """(JAX config, port config) of `shapes` in fp32."""
    base = {**shapes, **kw}
    return (jd.DeepseekConfig(dtype=jnp.float32, **base),
            td.DeepseekConfig(dtype=torch.float32, **base))


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)


def _with_bias(tree, seed=3):
    """A V3 tree's zero choice biases replaced by random ones, partly
    negative (so a masked group's 0.0 can outrank a kept expert)."""
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        if "moe_gate_bias" in layer:
            n = layer["moe_gate_bias"].shape[0]
            layer["moe_gate_bias"] = (rng.standard_normal(n) * 0.4
                                      ).astype(np.float32)
    return tree


def _params(jcfg, tcfg, seed=0):
    tree = _with_bias(_numpy_tree(jd.init_params(jcfg,
                                                 jax.random.PRNGKey(seed))))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, params_from_numpy(tree, tcfg, device="cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- presets and parameters -------------------------------------------------


def test_presets_equal_jax():
    """Every JAX DeepSeek preset has a port preset with equal fields (the
    dtype by name, the plain attention by each package's name for it),
    and the merged table holds both families."""
    from dynamo_tpu.models import PRESETS as JAX_PRESETS
    from dynamo_tpu_torch.models import PRESETS

    assert list(td.PRESETS) == list(jd.PRESETS)
    for name, j in jd.PRESETS.items():
        t = td.PRESETS[name]
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert str(tf.pop("dtype")).split(".")[-1] == \
            jnp.dtype(jf.pop("dtype")).name, name
        assert (tf.pop("attn_impl"), jf.pop("attn_impl")) == ("torch", "jnp")
        assert tf == jf, name
    assert list(PRESETS) == list(JAX_PRESETS)
    assert get_family(PRESETS["deepseek-v2-lite"]) is td
    assert td.SUPPORTED_ATTN_IMPLS == ("torch",)
    assert not hasattr(td, "kv_cache_scale_shapes")
    assert td.kv_cache_shapes(td.PRESETS["deepseek-v2-lite"], 7, 128) == (
        (27, 1, 7, 128, 512), (27, 1, 7, 128, 64))


@pytest.mark.parametrize("shapes", [MLA32, MLA32_MOE, MLA32_V3],
                         ids=["mla32", "mla32-moe", "mla32-v3"])
def test_init_params_match_jax_tree(shapes):
    """The port's random init has JAX's tree, shapes and dtypes (norms
    and the V3 choice bias fp32), and each weight's scale."""
    jcfg, tcfg = cfgs(shapes)
    jp = jd.init_params(jcfg, jax.random.PRNGKey(0))
    tp = td.init_params(tcfg, torch.Generator().manual_seed(0))
    assert sorted(jp) == sorted(tp)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            if isinstance(jl[k], dict):
                assert sorted(jl[k]) == sorted(tl[k])
                continue
            assert tuple(tl[k].shape) == jl[k].shape, k
    lay = td.init_params(td.DeepseekConfig(**{**MLA32_V3, "kv_lora_rank": 512}),
                         torch.Generator().manual_seed(1))["layers"][1]
    assert lay["moe_gate_bias"].dtype == torch.float32
    assert lay["moe_w_up"].dtype == torch.bfloat16
    assert abs(lay["w_uk"].float().std().item() * 512 ** 0.5 - 1) < 0.05


# -- the attention ops ------------------------------------------------------

BS, NB = 4, 16
NH, DN, DR, DV, R = 4, 16, 8, 16, 32


def _latent_caches(rng):
    """Random latent and rope-key caches (R != dr), JAX's layout and the
    port's."""
    c = rng.standard_normal((2, 1, NB, R, BS)).astype(np.float32)
    kr = rng.standard_normal((2, 1, NB, DR, BS)).astype(np.float32)
    return (jnp.asarray(c), jnp.asarray(kr)), kv_cache_from_numpy(
        c, kr, device="cpu")


# (context tokens, chunk tokens): none, mid-block, the full table
PREFILL_CASES = [(0, 7), (6, 5), (20, 12)]


@pytest.mark.parametrize("ctx,T", PREFILL_CASES,
                         ids=[f"ctx{c}-T{t}" for c, t in PREFILL_CASES])
def test_prefill_attention_matches_jax(ctx, T):
    rng = np.random.default_rng(ctx + T)
    jkv, tkv = _latent_caches(rng)
    Tp = 12
    q_nope = rng.standard_normal((Tp, NH, DN)).astype(np.float32)
    q_rope = rng.standard_normal((Tp, NH, DR)).astype(np.float32)
    c = rng.standard_normal((Tp, R)).astype(np.float32)
    kr = rng.standard_normal((Tp, DR)).astype(np.float32)
    w_uk = rng.standard_normal((NH, R, DN)).astype(np.float32) / R ** 0.5
    w_uv = rng.standard_normal((NH, R, DV)).astype(np.float32) / R ** 0.5
    table = np.array([3, 7, 1, 9, 2, 11, 4, 5], np.int32)
    args = (q_nope, q_rope, c, kr)
    want = jmla.mla_prefill_attention(
        *map(jnp.asarray, args), *jkv, 1, jnp.asarray(table),
        jnp.int32(ctx), jnp.int32(T), jnp.asarray(w_uk), jnp.asarray(w_uv))
    got = tmla.mla_prefill_attention(
        *map(torch.from_numpy, args), *tkv, 1, torch.from_numpy(table), ctx,
        T, torch.from_numpy(w_uk), torch.from_numpy(w_uv))
    assert got.shape == (Tp, NH, DV)
    assert _rel(got.numpy()[:T], np.asarray(want)[:T]) <= ATTN


@pytest.mark.parametrize("lens", [[1, 1, 1], [6, 13, 3], [32, 32, 17]],
                         ids=["one", "mid-block", "full"])
def test_decode_attention_matches_jax_and_the_oracle(lens):
    """The absorbed decode of three rows against JAX's, and against a
    materialised non-absorbed oracle on the same cache."""
    rng = np.random.default_rng(sum(lens))
    jkv, tkv = _latent_caches(rng)
    B = len(lens)
    q_nope = rng.standard_normal((B, NH, DN)).astype(np.float32)
    q_rope = rng.standard_normal((B, NH, DR)).astype(np.float32)
    w_uk = rng.standard_normal((NH, R, DN)).astype(np.float32) / R ** 0.5
    w_uv = rng.standard_normal((NH, R, DV)).astype(np.float32) / R ** 0.5
    tables = rng.integers(1, NB, (B, 8)).astype(np.int32)
    q_abs = np.einsum("bhd,hrd->bhr", q_nope, w_uk).astype(np.float32)
    scale = 1.0 / np.sqrt(np.float32(DN + DR))
    want = jmla.mla_decode_attention(
        jnp.asarray(q_abs), jnp.asarray(q_rope), *jkv, 0,
        jnp.asarray(tables), jnp.asarray(lens, jnp.int32),
        jnp.asarray(w_uv), scale)
    got = tmla.mla_decode_attention(
        torch.from_numpy(q_abs), torch.from_numpy(q_rope), *tkv, 0,
        torch.from_numpy(tables), torch.tensor(lens, dtype=torch.int32),
        torch.from_numpy(w_uv), tmla.score_scale(DN + DR))
    assert _rel(got.numpy(), np.asarray(want)) <= ATTN
    # the oracle: per-head keys W_UK c_t ++ the shared rope key
    c = tmla._gather_latent(tkv[0], 0, torch.from_numpy(tables)).numpy()
    kr = tmla._gather_latent(tkv[1], 0, torch.from_numpy(tables)).numpy()
    k = np.concatenate([np.einsum("bsr,hrd->bhsd", c, w_uk),
                        np.broadcast_to(kr[:, None], (B, NH, *kr.shape[1:]))],
                       axis=-1)
    q = np.concatenate([q_nope, q_rope], axis=-1)
    s = np.einsum("bhd,bhsd->bhs", q, k) * scale
    s = np.where(np.arange(s.shape[-1])[None, None] < np.array(lens)[:, None,
                                                                      None],
                 s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    oracle = np.einsum("bhs,bhsd->bhd", p, np.einsum("bsr,hrd->bhsd", c,
                                                     w_uv))
    assert _rel(got.numpy(), oracle) <= ATTN


def test_score_scale_rounds_like_jax():
    for hd in (24, 192, 48):
        assert np.float32(tmla.score_scale(hd)) == np.asarray(
            1.0 / jnp.sqrt(jnp.float32(hd)))


# -- routing ----------------------------------------------------------------

ROUTERS = {
    "v2-softmax": dict(n_experts=8, experts_per_token=3),
    "v2-group-max": dict(n_experts=8, experts_per_token=3, n_group=4,
                         topk_group=2),
    "v3-sigmoid": dict(n_experts=8, experts_per_token=3, n_group=4,
                       topk_group=2, moe_scoring="sigmoid",
                       norm_topk_prob=True, routed_scaling_factor=2.5),
}


def _router_inputs(variant, ties, seed=5):
    """(layer in JAX arrays, the port's layer, x [40, d]): with `ties`
    small-integer activations over dyadic router columns where experts
    4-7 repeat 0-3, so scores, biases, group scores and choices tie
    exactly in both packages."""
    rng = np.random.default_rng(seed)
    d, E = 64, 8
    if ties:
        x = rng.integers(-2, 3, (40, d)).astype(np.float32)
        g = (rng.integers(-2, 3, (d, E)) * 0.0625).astype(np.float32)
        g[:, 4:] = g[:, :4]
        bias = (rng.integers(-4, 4, E) * 0.125).astype(np.float32)
        bias[4:] = bias[:4]
    else:
        x = rng.standard_normal((40, d)).astype(np.float32)
        g = (rng.standard_normal((d, E)) / 8).astype(np.float32)
        bias = (rng.standard_normal(E) * 0.4).astype(np.float32)
    lay = {"moe_gate": g}
    if ROUTERS[variant].get("moe_scoring") == "sigmoid":
        lay["moe_gate_bias"] = bias
    return ({k: jnp.asarray(v) for k, v in lay.items()},
            {k: torch.from_numpy(v) for k, v in lay.items()}, x)


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
@pytest.mark.parametrize("variant", sorted(ROUTERS))
def test_router_matches_jax(variant, ties):
    jcfg, tcfg = cfgs(MLA32_MOE, **ROUTERS[variant])
    jlay, tlay, x = _router_inputs(variant, ties)
    jw, je = jd._ds_router(jlay, jcfg, jnp.asarray(x))
    tw, te = td._ds_router(tlay, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    if ties:
        # tied experts ranked lower id first: a pair (e, e + 4) with
        # both chosen appears in that order
        ids = te.numpy()
        for row in ids:
            for a in range(4):
                if a in row and a + 4 in row:
                    assert list(row).index(a) < list(row).index(a + 4)
        assert any(a in row and a + 4 in row for row in ids for a in range(4))


def test_masked_groups_score_zero_not_minus_inf():
    """V3 group masking sets the other groups' choice scores to 0.0, as
    JAX does: with every bias below -1 a kept group's experts score
    below 0, so the router picks from the masked ones."""
    jcfg, tcfg = cfgs(MLA32_MOE, **ROUTERS["v3-sigmoid"])
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((64, 8)) / 8).astype(np.float32)
    bias = np.full(8, -2.0, np.float32)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    jw, je = jd._ds_router({"moe_gate": jnp.asarray(g),
                            "moe_gate_bias": jnp.asarray(bias)}, jcfg,
                           jnp.asarray(x))
    tw, te = td._ds_router({"moe_gate": torch.from_numpy(g),
                            "moe_gate_bias": torch.from_numpy(bias)}, tcfg,
                           torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=0)


def test_block_ops_move_the_latent_pair():
    """Each block op works per member on the MLA pair (widths R and dr):
    bytes per block from both shapes, the disagg gather/inject and the
    KVBM host copies round-trip blocks bit for bit."""
    from dynamo_tpu_torch.ops.kv_transfer import (
        blocks_from_host,
        blocks_to_host,
        gather_universal,
        inject_universal,
    )
    from dynamo_tpu_torch.quant.kv import (
        blocks_for_hbm_budget,
        kv_cache_bytes_per_block,
    )

    _, tcfg = cfgs(MLA32)
    per = kv_cache_bytes_per_block(td, tcfg, BS, "bf16")
    assert per == 2 * (R + DR) * BS * 4
    assert blocks_for_hbm_budget(td, tcfg, BS, "bf16", 10 * per + 3) == 10
    rng = np.random.default_rng(1)
    _, kv = _latent_caches(rng)
    ids = [3, 9, 4]
    payload = gather_universal(kv, ids)
    assert [tuple(p.shape) for p in payload] == [(2, 3, BS, 1, R),
                                                 (2, 3, BS, 1, DR)]
    fresh = tuple(torch.zeros_like(t) for t in kv)
    inject_universal(fresh, *payload, [5, 6, 7])
    for a, b in zip(fresh, kv):
        assert torch.equal(a[:, :, 5:8], b[:, :, ids])
    host = blocks_to_host(kv, ids)
    back = tuple(torch.zeros_like(t) for t in kv)
    blocks_from_host(back, host, [1, 2, 8])
    for a, b in zip(back, kv):
        assert torch.equal(a[:, :, [1, 2, 8]], b[:, :, ids])


# -- the model's forwards ---------------------------------------------------


def _caches(jcfg, tcfg, nb=32, bs=BS):
    return (tuple(jnp.zeros(s, jnp.float32)
                  for s in jd.kv_cache_shapes(jcfg, nb, bs)),
            tuple(torch.zeros(s) for s in td.kv_cache_shapes(tcfg, nb, bs)))


def _same_caches(tkv, jkv):
    for got, want in zip(kv_cache_to_numpy(tkv), jkv):
        np.testing.assert_allclose(got[:, :, 1:], np.asarray(want)[:, :, 1:],
                                   **CACHE)


FWD_CASES = [("mla32", MLA32, "dense"), ("mla32-moe", MLA32_MOE, "dense"),
             ("mla32-moe", MLA32_MOE, "capacity"),
             ("mla32-v3", MLA32_V3, "dense"),
             ("mla32-v3", MLA32_V3, "capacity")]


@pytest.mark.parametrize("shapes,dispatch", [c[1:] for c in FWD_CASES],
                         ids=[f"{n}-{d}" for n, _, d in FWD_CASES])
def test_forwards_match_jax(shapes, dispatch):
    """`prefill` of one prompt in two chunks (the second after a cached
    prefix), then `decode` at 4 lanes (2 padding) and a 3-step greedy
    `decode_multi`; `prefill_batched` of two rows of different lengths
    on fresh caches.  Logits, tokens and caches against JAX's."""
    jcfg, tcfg = cfgs(shapes, moe_dispatch=dispatch, moe_capacity_factor=1.0)
    jp, tp = _params(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(8)
    T = 16
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (16, 11)]
    tables = np.zeros((2, 8), np.int32)
    for i in range(2):
        tables[i, :5] = 1 + i * 8 + np.arange(5)
    jkv, tkv = _caches(jcfg, tcfg)
    for ctx, n in ((0, 10), (10, 6)):
        toks = np.zeros(T, np.int32)
        toks[:n] = prompts[0][ctx:ctx + n]
        pos = ctx + np.arange(T, dtype=np.int32)
        jl, jkv = jd.prefill(jp, jcfg, jkv, jnp.asarray(toks),
                             jnp.asarray(pos), jnp.asarray(tables[0]),
                             jnp.int32(ctx), jnp.int32(n))
        tl, tkv = td.prefill(tp, tcfg, tkv, torch.from_numpy(toks),
                             torch.from_numpy(pos),
                             torch.from_numpy(tables[0]), ctx, n)
        assert _rel(tl.numpy(), np.asarray(jl)) <= LOGITS
    _same_caches(tkv, jkv)
    lanes = dict(tokens=np.int32([17, 0, 23, 0]),
                 positions=np.int32([16, 0, 0, 0]),
                 tables=np.stack([tables[0], np.zeros(8, np.int32),
                                  tables[1], np.zeros(8, np.int32)]),
                 ctx=np.int32([16, 0, 0, 0]))
    valid = np.array([True, False, True, False])
    order = ("tokens", "positions", "tables", "ctx")
    jdl, jkv = jd.decode(jp, jcfg, jkv, *(jnp.asarray(lanes[k])
                                          for k in order),
                         valid=jnp.asarray(valid))
    tdl, tkv = td.decode(tp, tcfg, tkv, *(torch.from_numpy(lanes[k])
                                          for k in order),
                         valid=torch.from_numpy(valid))
    assert _rel(tdl.numpy()[valid], np.asarray(jdl)[valid]) <= LOGITS
    nxt = dict(lanes, positions=lanes["positions"] + 1, ctx=lanes["ctx"] + 1)
    jt, jkv = jd.decode_multi(jp, jcfg, jkv, *(jnp.asarray(nxt[k])
                                               for k in order), 3,
                              valid=jnp.asarray(valid))
    tt, tkv = td.decode_multi(tp, tcfg, tkv, *(torch.from_numpy(nxt[k])
                                               for k in order), 3,
                              valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tt.numpy()[:, valid],
                                  np.asarray(jt)[:, valid])
    _same_caches(tkv, jkv)

    toks = np.zeros((2, T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    lens = np.int32([16, 11])
    jkv, tkv = _caches(jcfg, tcfg)
    jl, jkv = jd.prefill_batched(jp, jcfg, jkv, jnp.asarray(toks),
                                 jnp.asarray(pos), jnp.asarray(tables),
                                 jnp.zeros(2, jnp.int32), jnp.asarray(lens))
    tl, tkv = td.prefill_batched(tp, tcfg, tkv, torch.from_numpy(toks),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(tables),
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.from_numpy(lens))
    assert _rel(tl.numpy(), np.asarray(jl)) <= LOGITS
    _same_caches(tkv, jkv)


# -- engines ----------------------------------------------------------------

COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
PROMPTS = [[5, 9, 13, 2, 7, 11, 3, 1, 8, 20], [3, 1, 4, 1, 5, 9],
           list(range(30, 50)), [14, 14, 2]]


def _req(jax_side, tokens, rid, n, annotations=()):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0),
             stop=T(max_tokens=n, ignore_eos=True),
             annotations=list(annotations))


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        toks.extend(out.token_ids)
    return toks


def _engines(jkw, tkw):
    """A JaxEngine and a TorchEngine on the JAX engine's weights."""
    je = JaxEngine(JaxEngineConfig(**jkw))
    mc = EngineConfig(**tkw).resolve_model()
    te = TorchEngine(EngineConfig(**tkw), params=params_from_numpy(
        _numpy_tree(je.params), mc, device="cpu"), device="cpu")
    return je, te


ENGINE_CASES = {
    "tiny-mla": (dict(model="tiny-mla"), dict(model="tiny-mla")),
    "mla32-moe-dense": tuple(dict(model_config=c) for c in cfgs(MLA32_MOE)),
    "mla32-moe-capacity": tuple(dict(model_config=c) for c in cfgs(
        MLA32_MOE, moe_dispatch="capacity")),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
async def test_engine_streams_match_jax(case):
    """The four prompts at once through both engines: greedy streams
    equal byte for byte; the port's prefill ran the padded programs and
    built no packed or verify program."""
    jkw, tkw = ENGINE_CASES[case]
    je, te = _engines({**jkw, **COMMON}, {**tkw, **COMMON})
    try:
        assert te.family is td and te.prefill_graphs is None
        assert te.padded_prefill is not None and not te._packed_prefill_ok
        res = []
        for side, eng in ((True, je), (False, te)):
            res.append(await asyncio.gather(*[
                _collect(eng, _req(side, p, f"r{i}", 8))
                for i, p in enumerate(PROMPTS)]))
        assert res[1] == res[0] and all(len(t) == 8 for t in res[1])
        assert te.padded_prefill.counts and te.verify_graphs is None
        assert te.metrics["prefill_steps"] == je.metrics["prefill_steps"]
        recs = [r for r in te.fpm if r["kind"] == "prefill"]
        assert recs and all(r["xla_flops"] > 0 for r in recs)
    finally:
        await je.close()
        await te.close()


async def test_prefix_rerun_matches_jax():
    """A rerun of a prompt takes the cached prefix (the latent blocks)
    plus a short tail, both engines alike."""
    jkw, tkw = ENGINE_CASES["mla32-moe-dense"]
    je, te = _engines({**jkw, **COMMON, "max_num_seqs": 2},
                      {**tkw, **COMMON, "max_num_seqs": 2})
    prompt = list(range(40, 62))
    try:
        runs = []
        for tag in ("a", "b"):
            runs.append([await _collect(je, _req(True, prompt, tag, 6)),
                         await _collect(te, _req(False, prompt, tag, 6))])
        assert runs[0][1] == runs[0][0] and runs[1][1] == runs[1][0]
        assert runs[1][1] == runs[0][1]
        assert te.metrics["cache_hit_tokens"] == \
            je.metrics["cache_hit_tokens"] > 0
    finally:
        await je.close()
        await te.close()


def test_warmup_builds_decode_guided_and_padded_programs_only():
    te = TorchEngine(EngineConfig(model="tiny-mla", **COMMON), device="cpu")
    te.warmup_decode()
    assert set(te.padded_prefill.counts) == set(te._padded_shapes())
    assert te.graphs.counts == {(g, k): 1 for g in (True, False)
                                for k in te._fuse_ladder()}
    assert set(te.guided_graphs.counts) == {32, 256}
    assert te.prefill_graphs is None and te.verify_graphs is None
    fams = te._program_families()
    assert te.padded_prefill in fams and None not in fams


# -- the fallbacks ----------------------------------------------------------


def _warnings(caplog, loggers):
    return sorted(r.getMessage() for r in caplog.records
                  if r.name in loggers and r.levelno == logging.WARNING)


FALLBACKS = {
    "int8": dict(kv_cache_dtype="int8"),
    "fused": dict(sampling_epilogue="fused"),
    "spec": dict(spec_decode="ngram"),
}


@pytest.mark.parametrize("what", sorted(FALLBACKS))
def test_fallbacks_match_jax(what, caplog):
    """int8 falls back to a bf16 cache, fused to "off", spec to plain
    decode, each with JAX's warning."""
    kw = {**COMMON, "model": "tiny-mla", **FALLBACKS[what]}
    with caplog.at_level(logging.WARNING):
        je = JaxEngine(JaxEngineConfig(**kw))
        jwarn = _warnings(caplog, {"dynamo_tpu.engine.core"})
        caplog.clear()
        te = TorchEngine(EngineConfig(**kw), device="cpu")
        twarn = _warnings(caplog, {"dynamo_tpu_torch.engine.core"})
    assert twarn == jwarn and len(twarn) == 1
    assert (te.kv_dtype, je.kv_dtype) == ("bf16", "bf16")
    assert len(te.kv) == 2 and te.kv[0].dtype == torch.bfloat16
    assert te.sampling_epilogue == je.sampling_epilogue
    assert te.graphs.epilogue is False
    assert te.proposer is None and te.verify_graphs is None
    assert not te.spec_enabled
    asyncio.run(je.close())


@pytest.mark.parametrize("what", ["lora", "packed_attn_impl"])
def test_config_errors_match_jax(what, tmp_path):
    kw = {**COMMON, "model": "tiny-mla"}
    kw.update({"lora": dict(lora_max_adapters=2, lora_dir=str(tmp_path)),
               "packed_attn_impl": dict(packed_attn_impl="torch")}[what])
    jkw = dict(kw)
    if what == "packed_attn_impl":
        jkw["packed_attn_impl"] = "xla"
    with pytest.raises(ValueError) as want:
        JaxEngine(JaxEngineConfig(**jkw))
    with pytest.raises(ValueError) as got:
        TorchEngine(EngineConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_attn_impl_outside_the_plain_one_raises():
    with pytest.raises(ValueError) as want:
        JaxEngine(JaxEngineConfig(model="tiny-mla", attn_impl="pallas"))
    with pytest.raises(ValueError) as got:
        TorchEngine(EngineConfig(model="tiny-mla", attn_impl="auto"),
                    device="cpu")
    assert str(want.value) == ("attn_impl for model family DeepseekConfig "
                               "must be one of jnp, got 'pallas'")
    assert str(got.value) == ("attn_impl for model family DeepseekConfig "
                              "must be one of torch, got 'auto'")
    ok = EngineConfig(model="tiny-mla", attn_impl="torch").resolve_model()
    assert ok.attn_impl == "torch"


# -- disaggregated serving on the latent pair --------------------------------


def _record_gathers(engine, into):
    inner = engine.extract_parked_chunk

    async def extract(request_id, start, count, **kw):
        arrs = await inner(request_id, start, count, **kw)
        into[start] = [a.detach().cpu().clone() for a in arrs]
        return arrs

    engine.extract_parked_chunk = extract


def _record_injects(engine, into):
    from dynamo_tpu_torch.ops.kv_transfer import gather_universal

    inner = engine._inject_pulled_chunk

    def inject(slot, b0, n, arrs):
        inner(slot, b0, n, arrs)
        ids = engine.allocator.seq_block_ids(slot.request.request_id)
        into[b0] = gather_universal(engine.kv, ids[b0:b0 + n])

    engine._inject_pulled_chunk = inject


@pytest.mark.parametrize("tier", ["broker", "host"])
async def test_disagg_round_trip_on_the_latent_pair(tier, monkeypatch):
    """tests/test_disagg.py:229 on the port: a torch prefill worker parks
    an MLA prompt's latent blocks, a torch decode worker pulls them
    (the wire layout carries head_dim_v = dr), every block lands
    bit-equal, and the stream equals the aggregated engines'."""
    jcfg, tcfg = cfgs(MLA32)
    ecfg = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
                max_num_seqs=2, prefill_buckets=(8, 16, 32), seed=7)
    prompt = list(range(30, 52))
    je, te = _engines({"model_config": jcfg, **ecfg},
                      {"model_config": tcfg, **ecfg})
    try:
        want = await _collect(je, _req(True, prompt, "agg", 6))
        assert await _collect(te, _req(False, prompt, "agg", 6)) == want
    finally:
        await je.close()
        await te.close()
    params = te.params
    layout = te.kv_wire_layout()
    assert (layout.kv_heads, layout.head_dim, layout.head_dim_v) == (1, 32, 8)
    if tier == "host":
        monkeypatch.setattr(broker, "lookup_engine", lambda _id: None)
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    pw = await TorchEngineWorker(rt, EngineConfig(
        model_config=tcfg, role="prefill", transfer_chunk_bytes=1024,
        **ecfg), component="prefill", params=params, device="cpu").start()
    dw = await TorchEngineWorker(rt, EngineConfig(
        model_config=tcfg, role="decode", transfer_chunk_bytes=1024,
        **ecfg), component="backend", params=params, device="cpu").start()
    sent, landed = {}, {}
    _record_gathers(pw.engine, sent)
    _record_injects(dw.engine, landed)
    pclient = await rt.namespace("dynamo").component("prefill").endpoint(
        "generate").client().start()
    dclient = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        frames = [LLMEngineOutput.from_dict(o) async for o in
                  pclient.generate(_req(False, prompt, "d1", 6,
                                        [DISAGG_ANNOTATION]).to_dict())]
        assert len(frames) == 1
        kvp = frames[0].kv_transfer_params
        assert kvp["first_token"] == want[0]
        req = _req(False, prompt, "d1", 6)
        req.disaggregated_params = kvp
        tokens = [t async for o in dclient.generate(req.to_dict())
                  for t in o.get("token_ids", [])]
        assert tokens == want
        assert dw.engine.metrics["prefill_tokens"] == 0
        assert dw.engine.metrics["pull_blocks"] == 6
        assert sent and sorted(sent) == sorted(landed)
        if tier == "host":
            assert len(sent) > 1
        for b0 in sent:
            for a, b in zip(sent[b0], landed[b0]):
                assert torch.equal(a, b.cpu())
    finally:
        await pclient.close()
        await dclient.close()
        await pw.close()
        await dw.close()
        await rt.shutdown()


# -- cost counts ------------------------------------------------------------

CBS, CNB, CMB, CB = 4, 32, 6, 3


def _cost_setup(shapes, **kw):
    cfg = td.DeepseekConfig(dtype=torch.float32, **{**shapes, **kw})
    params = td.init_params(cfg, torch.Generator().manual_seed(0))
    kv = tuple(torch.zeros(s) for s in td.kv_cache_shapes(cfg, CNB, CBS))
    return cfg, params, kv


def test_mla_terms_by_hand():
    """MLA32_MOE's decode step at B = 3 over 6-block tables and a padded
    2 x 8 prefill, counted by hand from the config."""
    cfg, _, _ = _cost_setup(MLA32_MOE)
    d, nh, R, dr, dn, dv = 64, 4, 32, 8, 16, 16
    E, k, f, sf, ffn, V, L = 4, 2, 64, 64, 128, 256, 3
    S = CMB * CBS
    proj = d * nh * (dn + dr) + d * (R + dr) + nh * dv * d
    moe = d * E + 3 * d * E * f + E * d + 3 * d * sf  # + the combine
    mlp = [3 * d * ffn, moe, moe]
    B = CB
    t = program_terms(cfg, "decode", (True, 1), rows=B, max_blocks=CMB,
                      block_size=CBS)
    assert t["matmul_flops"] == 2 * B * (L * proj + sum(mlp)) + 2 * B * d * V
    assert t["attn_flops"] == L * 2 * B * nh * (
        dn * R + S * (R + dr) + S * R + R * dv)
    assert t["kv_read_bytes"] == L * B * S * (R + dr) * 4
    assert t["kv_write_bytes"] == L * B * (R + dr) * 4
    assert t["out_bytes"] == B * V * 4
    up = nh * R * (dn + dv)
    weights = (L * (proj + up) + 3 * d * ffn
               + 2 * (d * E + 3 * d * E * f + 3 * d * sf) + d * V) * 4
    norms = L * (2 * d + R) * 4 + d * 4
    assert t["weight_bytes"] == weights + norms + B * d * 4
    p = program_terms(cfg, "prefill_padded", (2, 8), max_blocks=CMB,
                      block_size=CBS)
    N = S + 8
    assert p["attn_flops"] == 2 * L * (
        2 * N * R * nh * (dn + dv) + 2 * 8 * nh * N * (dn + dr)
        + 2 * 8 * nh * N * dv)
    assert p["kv_read_bytes"] == 2 * L * S * (R + dr) * 4
    with pytest.raises(ValueError, match="MLA family"):
        program_terms(cfg, "prefill", 16, rows=4, max_blocks=CMB,
                      block_size=CBS)


@pytest.mark.parametrize("shapes", [MLA32, MLA32_MOE, MLA32_V3],
                         ids=["mla32", "mla32-moe", "mla32-v3"])
def test_weight_bytes_equal_the_tree(shapes):
    """The counted weights are the tree's bytes but the embedding."""
    cfg, params, _ = _cost_setup(shapes)
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p16 = td.init_params(cfg16, torch.Generator().manual_seed(0))
    for c, p in ((cfg, params), (cfg16, p16)):
        tree = sum(t.numel() * t.element_size() for t in _leaves(p))
        emb = p["embedding"].numel() * p["embedding"].element_size()
        assert mla_weight_bytes(c) == tree - emb


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


COST_CASES = [("mla32", MLA32, "dense", "decode", (True, 2)),
              ("mla32-moe", MLA32_MOE, "dense", "decode", (False, 1)),
              ("mla32-moe", MLA32_MOE, "capacity", "decode", (True, 1)),
              ("mla32-v3", MLA32_V3, "dense", "guided", 8),
              ("mla32-moe", MLA32_MOE, "dense", "prefill_padded", (1, 16)),
              ("mla32-moe", MLA32_MOE, "capacity", "prefill_padded", (2, 8)),
              ("mla32-v3", MLA32_V3, "capacity", "prefill_padded", (4, 8))]


@pytest.mark.parametrize(
    "shapes,dispatch,family,key", [c[1:] for c in COST_CASES],
    ids=[f"{n}-{d}-{f}-{k}" for n, _, d, f, k in COST_CASES])
def test_mla_flops_equal_flop_counter(shapes, dispatch, family, key):
    """Every product of an MLA program's body (projections, the
    absorption, the attention's, the router, both dispatches, the
    shared experts, the lm_head) counted by FlopCounterMode equals the
    matmul plus attention terms; the program records its count."""
    from dynamo_tpu_torch.engine.graphs import (
        DecodePrograms,
        GuidedPrograms,
        PaddedPrefillPrograms,
    )

    cfg, params, kv = _cost_setup(shapes, moe_dispatch=dispatch)
    cpu = torch.device("cpu")
    if family == "decode":
        progs = DecodePrograms(params, cfg, kv, CB, CMB, cpu, capture=False)

        def run():
            progs.run(*key)
    elif family == "guided":
        progs = GuidedPrograms(params, cfg, kv, CB, CMB, (key,), cpu,
                               capture=False)

        def run():
            progs.run(key)
    else:
        progs = PaddedPrefillPrograms(params, cfg, kv, CMB, cpu)
        rows, T = key
        a = {"toks": np.ones((rows, T), np.int32),
             "positions": np.tile(np.arange(T, dtype=np.int32), (rows, 1)),
             "tables": np.tile(np.arange(1, CMB + 1, dtype=np.int32),
                               (rows, 1)),
             "ctx_lens": np.zeros(rows, np.int32),
             "true_lens": np.full(rows, T - 3, np.int32),
             "seeds": np.zeros(rows, np.int32),
             "temps": np.zeros(rows, np.float32),
             "top_ks": np.zeros(rows, np.int32),
             "top_ps": np.ones(rows, np.float32)}

        def run():
            progs.run(a)
    with FlopCounterMode(display=False) as fc:
        run()
    terms = program_terms(cfg, family, key, **progs._cost_shape())
    assert fc.get_total_flops() == terms["matmul_flops"] + terms["attn_flops"]
    assert progs.costs[key] == program_costs(cfg, family, key,
                                             **progs._cost_shape())


# -- the worker and the CLI -------------------------------------------------


async def test_worker_advertises_the_effective_settings():
    """A worker asked for the fused epilogue and an int8 cache on an MLA
    engine advertises "off" and bf16, as the JAX worker's MDC does for
    the same config, and serves the request."""
    from dynamo_tpu.engine.worker import JaxEngineWorker

    kw = dict(model="tiny-mla", block_size=4, num_blocks=64,
              max_blocks_per_seq=16, max_num_seqs=2,
              prefill_buckets=(8, 16, 32), seed=3,
              sampling_epilogue="fused", kv_cache_dtype="int8")
    want = JaxEngineWorker(None, JaxEngineConfig(**kw))
    want.engine = JaxEngine(want.config)
    want_rc = want.card.to_dict()["runtime_config"]
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc",
        tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
    w = await TorchEngineWorker(rt, EngineConfig(**kw), device="cpu").start()
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        published = list((await rt.discovery.get_prefix(
            w.card.key(w.served.instance_id))).values())
        assert len(published) == 1
        rc = published[0]["runtime_config"]
        assert rc["sampling_epilogue"] == "off"
        assert rc["kv_cache_dtype"] == "bf16"
        assert rc["packed_attn_impl"] == "auto"
        assert rc["attn_impl"] == "torch"
        assert w.engine.sampling_epilogue == "off"
        # JAX's MDC for the same config, but the plain attention's name
        assert (want_rc.pop("attn_impl"), rc.pop("attn_impl")) == (
            "jnp", "torch")
        assert rc == want_rc
        await client.wait_for_instances()
        got = []
        async for out in client.generate(
                _req(False, [5, 9, 13, 2, 7], "t", 6).to_dict()):
            got.extend(out.get("token_ids", []))
        assert len(got) == 6
    finally:
        await client.close()
        await w.close()
        await rt.shutdown()
        await want.engine.close()


def test_cli_serves_the_deepseek_presets_and_checkpoints(tmp_path,
                                                         monkeypatch):
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config
    from test_torch_loader import write_deepseek_checkpoint

    for name in ("tiny-mla", "tiny-mla-moe", "deepseek-v2-lite",
                 "deepseek-r1"):
        mc = engine_config(build_args().parse_args(
            ["--model", name])).resolve_model()
        assert mc == td.PRESETS[name]
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    for lineage in ("v2", "v3"):
        path = write_deepseek_checkpoint(tmp_path / f"ds-{lineage}", lineage)
        mc = engine_config(build_args().parse_args(
            ["--model-path", path])).resolve_model()
        assert isinstance(mc, td.DeepseekConfig)
        assert mc.name == f"ds-{lineage}"
    assert "falls back to bf16" in build_args().format_help().replace(
        "\n", " ").replace("  ", " ")

"""The per-program cost count (dynamo_tpu_torch/obs/costs.py) on the CPU.

* The matmul term of every program family (decode bursts greedy,
  sampled and under the fused epilogue, with and without a LoRA bank;
  packed prefill with and without a bank; spec verify; the draft's
  catch-up; the guided top-M step) equals what torch's FlopCounterMode
  counts over the program's plain body at a tiny width, within 1%, with
  the attention calls stubbed out (attention is counted by the kernels'
  formulas, not by the plain version's products).  So do the MoE terms
  (the router, every expert under dense dispatch, the capacity buffers
  and the dispatch/combine products under capacity dispatch) in the
  decode, packed-prefill, verify and guided programs and in the padded
  B = 1 and batched prefill of capacity dispatch; the padded programs'
  attention term equals the plain padded path's products.
* The K1 and K3 terms equal the CostEstimates the JAX package's Pallas
  kernels compute for the same shapes (read off their `pallas_call`),
  exactly, bf16 and int8.
* Against JAX's XLA cost analysis of the same packed-prefill program on
  the CPU, the FLOPs agree within 25%, the count below XLA's (it leaves
  the elementwise work out and counts attention by K3's tile formula,
  where XLA counts the reference path's ops).  The prefill record's
  byte total equals a hand formula from the model's dimensions, and its
  ratio to XLA's (which sums every op's operands and results) stays
  within 2x of the measured one.
* Prefill, decode and spec_verify FPM records carry xla_flops/xla_bytes,
  every program an engine builds has a count, and the FpmWindow roofline
  from torch records is non-zero and equals the JAX FpmWindow's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dynamo_tpu_torch.engine.graphs import (
    CatchupPrograms,
    DecodePrograms,
    GuidedPrograms,
    PrefillPrograms,
    VerifyPrograms,
)
from dynamo_tpu_torch.lora.bank import empty_bank
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.obs.costs import (
    k1_costs,
    k3_costs,
    program_costs,
    program_terms,
)
from test_torch_overlap import (
    COMMON,
    PROMPTS,
    SHAPES,
    _collect,
    _req,
    jax_engine,
    torch_engine,
)

pytestmark = pytest.mark.allow_slow_callbacks

CFG = LlamaConfig(name="cost", vocab_size=96, d_model=32, n_layers=2,
                  n_heads=4, n_kv_heads=2, head_dim=8, ffn_dim=48,
                  dtype=torch.float32)
BS, NB, MB, B = 4, 32, 6, 3


def _setup(int8=False):
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(CFG, gen, torch.device("cpu"))
    kv = tuple(torch.zeros(s, dtype=torch.int8 if int8 else CFG.dtype)
               for s in llama.kv_cache_shapes(CFG, NB, BS))
    if int8:
        kv += tuple(torch.zeros(s) for s in
                    llama.kv_cache_scale_shapes(CFG, NB, BS))
    return params, kv


def _bank():
    return empty_bank(CFG.n_layers, 3, 4, CFG.d_model, CFG.q_dim,
                      CFG.kv_dim, CFG.dtype, torch.device("cpu"))


def _programs(family, params, kv, bank=None, epilogue=False):
    cpu = torch.device("cpu")
    if family == "decode":
        return DecodePrograms(params, CFG, kv, B, MB, cpu, capture=False,
                              epilogue=epilogue, lora_bank=bank)
    if family == "prefill":
        return PrefillPrograms(params, CFG, kv, B, MB, (16, 32), cpu,
                               capture=False, lora_bank=bank)
    if family == "verify":
        return VerifyPrograms(params, CFG, kv, 4, MB, (8, 16), cpu,
                              capture=False)
    if family == "catchup":
        return CatchupPrograms(params, CFG, kv, 1, MB, (16,), cpu,
                               capture=False)
    return GuidedPrograms(params, CFG, kv, B, MB, (8, 32), cpu,
                          capture=False)


def _counted_matmul_flops(progs, run, monkeypatch) -> int:
    """FlopCounterMode over one eager run with the attention ops stubbed
    (zeros of their output shape, no products)."""
    def decode_stub(q, *a, **k):
        return torch.zeros_like(q)

    def packed_stub(q, *a, **k):
        return torch.zeros_like(q)

    monkeypatch.setattr(llama, "paged_attention_decode", decode_stub)
    monkeypatch.setattr(llama, "packed_prefill_attention", packed_stub)
    with FlopCounterMode(display=False) as fc:
        run(progs)
    return fc.get_total_flops()


CASES = [
    ("decode", (True, 1), {}),
    ("decode", (True, 3), {}),
    ("decode", (False, 2), {}),
    ("decode", (True, 2), {"epilogue": True}),
    ("decode", (False, 2), {"bank": True}),
    ("prefill", 16, {}),
    ("prefill", 32, {"bank": True}),
    ("verify", 16, {}),
    ("catchup", 16, {}),
    ("guided", 8, {}),
    ("guided", 32, {}),
]


@pytest.mark.parametrize("family,key,opts", CASES,
                         ids=[f"{f}-{k}-{sorted(o)}" for f, k, o in CASES])
def test_matmul_term_equals_flop_counter(family, key, opts, monkeypatch):
    params, kv = _setup()
    bank = _bank() if opts.get("bank") else None
    progs = _programs(family, params, kv, bank=bank,
                      epilogue=opts.get("epilogue", False))
    if family == "decode":
        def run(p):
            p.run_eager(*key)
    else:
        def run(p):
            p.run_eager(key)
    counted = _counted_matmul_flops(progs, run, monkeypatch)
    terms = program_terms(CFG, family, key, **progs._cost_shape())
    assert counted > 0
    assert abs(terms["matmul_flops"] - counted) <= 0.01 * counted
    # the program records its count at its first (eager) build
    run_key = key
    progs.run(*run_key) if family == "decode" else progs.run(run_key)
    assert progs.costs[run_key] == program_costs(
        CFG, family, key, **progs._cost_shape())


def _pallas_estimate(monkeypatch, module, fn, *args, **kw):
    """The CostEstimate a JAX Pallas wrapper passes to pallas_call."""
    seen = {}

    def fake_call(kernel, *, out_shape, cost_estimate, **rest):
        seen["est"] = cost_estimate
        return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(module.pl, "pallas_call", fake_call)
    fn(*args, **kw)
    est = seen["est"]
    return {"flops": int(est.flops), "bytes": int(est.bytes_accessed)}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,mb,bs", [(8, 16, 128), (4, 16, 128),
                                     (1, 64, 128), (3, 6, 4)])
def test_k1_term_equals_pallas_cost_estimate(int8, b, mb, bs, monkeypatch):
    from dynamo_tpu.ops import pallas_paged_attention as pa

    cfg = llama.PRESETS["llama-8b"]
    L, nkv, hd, nh = 2, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    dt = jnp.int8 if int8 else jnp.bfloat16
    kc = jnp.zeros((L, nkv, mb + 1, hd, bs), dt)
    scales = ({"k_scale": jnp.zeros((L, nkv, mb + 1, bs)),
               "v_scale": jnp.zeros((L, nkv, mb + 1, bs))} if int8 else {})
    want = _pallas_estimate(
        monkeypatch, pa, pa.paged_attention_decode_pallas,
        jnp.zeros((b, nh, hd), jnp.bfloat16), kc, kc, 1,
        jnp.zeros((b, mb), jnp.int32), jnp.ones((b,), jnp.int32), **scales)
    assert k1_costs(cfg, b, mb, bs, int8) == want


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,mb,bs", [(2048, 16, 128), (32, 16, 128),
                                     (512, 64, 128), (8, 6, 4),
                                     (200, 12, 16)])
def test_k3_term_equals_pallas_cost_estimate(int8, T, mb, bs, monkeypatch):
    from dynamo_tpu.ops import pallas_packed_prefill as pp

    cfg = llama.PRESETS["llama-8b"]
    L, nkv, hd, nh = 2, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    dt = jnp.int8 if int8 else jnp.bfloat16
    kc = jnp.zeros((L, nkv, mb + 1, hd, bs), dt)
    scales = ({"k_scale": jnp.zeros((L, nkv, mb + 1, bs)),
               "v_scale": jnp.zeros((L, nkv, mb + 1, bs))} if int8 else {})
    S = 4
    want = _pallas_estimate(
        monkeypatch, pp, pp.packed_prefill_attention_pallas,
        jnp.zeros((T, nh, hd), jnp.bfloat16), kc, kc, 1,
        jnp.zeros((S, mb), jnp.int32), jnp.zeros((T,), jnp.int32),
        jnp.arange(T, dtype=jnp.int32), jnp.ones((T,), bool), **scales)
    assert k3_costs(cfg, T, mb, bs, int8) == want


def _moe_cfg(dispatch):
    return LlamaConfig(**{**CFG.__dict__, "name": "cost-moe",
                          "n_experts": 4, "experts_per_token": 2,
                          "moe_dispatch": dispatch})


MOE_CASES = [
    ("dense", "decode", (True, 2)),
    ("dense", "prefill", 16),
    ("dense", "verify", 8),
    ("dense", "guided", 8),
    ("capacity", "decode", (False, 1)),
    ("capacity", "prefill", 32),
    ("capacity", "prefill_padded", (1, 16)),
    ("capacity", "prefill_padded", (2, 16)),
    ("capacity", "prefill_padded", (4, 8)),
]


@pytest.mark.parametrize("dispatch,family,key", MOE_CASES,
                         ids=[f"{d}-{f}-{k}" for d, f, k in MOE_CASES])
def test_moe_terms_equal_flop_counter(dispatch, family, key, monkeypatch):
    """The MoE programs' matmul term against FlopCounterMode over the
    plain body (attention stubbed); the padded programs' attention term
    against the FLOPs of the plain padded attention alone."""
    from dynamo_tpu_torch.engine.graphs import PaddedPrefillPrograms

    cfg = _moe_cfg(dispatch)
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen, torch.device("cpu"))
    kv = tuple(torch.zeros(s) for s in llama.kv_cache_shapes(cfg, NB, BS))
    cpu = torch.device("cpu")
    if family == "prefill_padded":
        progs = PaddedPrefillPrograms(params, cfg, kv, MB, cpu)
        rows, T = key
        rng = np.random.default_rng(0)
        a = {"toks": rng.integers(0, 96, (rows, T)).astype(np.int32),
             "positions": np.tile(np.arange(T, dtype=np.int32), (rows, 1)),
             "tables": np.tile(np.arange(1, MB + 1, dtype=np.int32),
                               (rows, 1)),
             "ctx_lens": np.zeros(rows, np.int32),
             "true_lens": np.full(rows, T - 3, np.int32),
             "seeds": np.zeros(rows, np.int32),
             "temps": np.zeros(rows, np.float32),
             "top_ks": np.zeros(rows, np.int32),
             "top_ps": np.ones(rows, np.float32)}

        def run(p):
            p.run(a)

        monkeypatch.setattr(llama, "paged_prefill_attention",
                            lambda q, *x, **k: torch.zeros_like(q))
    else:
        if family == "decode":
            progs = DecodePrograms(params, cfg, kv, B, MB, cpu,
                                   capture=False)
        elif family == "guided":
            progs = GuidedPrograms(params, cfg, kv, B, MB, (8,), cpu,
                                   capture=False)
        elif family == "prefill":
            progs = PrefillPrograms(params, cfg, kv, B, MB, (16, 32), cpu,
                                    capture=False)
        else:
            progs = VerifyPrograms(params, cfg, kv, 4, MB, (8,), cpu,
                                   capture=False)

        def run(p):
            p.run_eager(*key) if family == "decode" else p.run_eager(key)

    counted = _counted_matmul_flops(progs, run, monkeypatch)
    terms = program_terms(cfg, family, key, **progs._cost_shape())
    assert abs(terms["matmul_flops"] - counted) <= 0.01 * counted
    dense = program_terms(CFG, "prefill", 16, rows=B, max_blocks=MB,
                          block_size=BS)
    if family == "prefill" and dispatch == "dense":
        # every expert on every token: more than the dense model's MLP
        assert terms["matmul_flops"] > dense["matmul_flops"]
        assert terms["weight_bytes"] > dense["weight_bytes"]
    if family == "prefill_padded":
        monkeypatch.undo()
        with FlopCounterMode(display=False) as fc:
            q = torch.zeros(key[1], cfg.n_heads, cfg.head_dim)
            k = torch.zeros(key[1], cfg.n_kv_heads, cfg.head_dim)
            llama.paged_prefill_attention(q, k, k, *kv[:2], 0,
                                          torch.zeros(MB, dtype=torch.int32),
                                          0, key[1])
        per_row = fc.get_total_flops() * cfg.n_layers
        assert terms["attn_flops"] == key[0] * per_row
        assert progs.costs[key] == program_costs(cfg, family, key,
                                                 **progs._cost_shape())


def test_int8_and_bank_move_the_bytes():
    shape = dict(rows=4, max_blocks=16, block_size=128)
    cfg = llama.PRESETS["llama-8b"]
    bf16 = program_terms(cfg, "decode", (True, 1), **shape)
    int8 = program_terms(cfg, "decode", (True, 1), int8=True, **shape)
    # hd bytes + a 4-byte scale against 2 x hd per position
    assert int8["kv_read_bytes"] / bf16["kv_read_bytes"] == (128 + 4) / 256
    bank = program_terms(cfg, "decode", (True, 1), lora=(5, 16), **shape)
    assert bank["matmul_flops"] > bf16["matmul_flops"]
    assert bank["weight_bytes"] > bf16["weight_bytes"]
    # a 4-lane llama-8b decode step reads the weights once (16.06 GB of
    # parameters, less the [128256, 4096] embedding table, of which it
    # looks up 4 rows) plus at most a full table's KV
    w = bf16["weight_bytes"]
    params = 2 * (cfg.n_layers * (4096 * 4096 * 2 + 4096 * 1024 * 2
                                  + 3 * 4096 * 14336)
                  + 2 * 128256 * 4096)
    assert w == params - 2 * 128256 * 4096 + 4 * 4096 * 2 \
        + 4 * (2 * cfg.n_layers + 1) * 4096
    assert 15.0e9 < w < 15.1e9 and 16.0e9 < params < 16.1e9
    total = program_costs(cfg, "decode", (True, 1), **shape)["bytes"]
    full_table = 2 * 4 * cfg.n_kv_heads * 16 * 128 * 256 * cfg.n_layers
    assert w < total <= w + full_table + bf16["kv_write_bytes"] \
        + bf16["out_bytes"]
    with pytest.raises(ValueError, match="no cost count"):
        program_costs(cfg, "moe", 1, **shape)


async def _serve(eng, jax_side, n=8, k=None):
    try:
        return await asyncio.gather(*[
            _collect(eng, _req(jax_side, PROMPTS[i], f"c{i}", n))
            for i in range(len(PROMPTS))])
    finally:
        await eng.close()


async def test_prefill_count_against_jax_xla_cost_analysis():
    je, te = jax_engine(), torch_engine()
    await _serve(je, True)
    await _serve(te, False)

    def prefill(eng):
        return {r["bucket"]: (r["xla_flops"], r["xla_bytes"])
                for r in eng.fpm if r["kind"] == "prefill"
                and "xla_flops" in r}

    jp, tp = prefill(je), prefill(te)
    assert jp and set(jp) == set(tp)
    L, d, V = SHAPES["n_layers"], SHAPES["d_model"], SHAPES["vocab_size"]
    nkv, hd = SHAPES["n_kv_heads"], SHAPES["head_dim"]
    q, kv, f = SHAPES["n_heads"] * hd, nkv * hd, SHAPES["ffn_dim"]
    bs, mb = COMMON["block_size"], COMMON["max_blocks_per_seq"]
    rows = te.config.max_prefill_seqs
    for bucket, (jf, jb) in jp.items():
        tf, tb = tp[bucket]
        # the count leaves elementwise work out and counts attention by
        # K3's tile formula: at this tiny width it is 0.80 of XLA's
        assert 0.75 * jf <= tf <= jf, (bucket, tf, jf)
        # the byte total by hand, fp32 throughout: every layer's matmul
        # weights and its two norms, the final norm, the unembedding,
        # the T embedding rows looked up, K3's reads (2 x tiles x nkv x
        # chunks x C positions of hd elements), the T tokens' K/V
        # written, and the rows' fp32 logits
        T = bucket
        tile = min(128, 1 << (T - 1).bit_length())
        chunks, C = -(-mb // min(mb, 8)), min(mb, 8) * bs
        want = (L * (d * q + 2 * d * kv + q * d + 3 * d * f + 2 * d) * 4
                + d * 4 + d * V * 4 + T * d * 4
                + L * 2 * -(-T // tile) * nkv * chunks * C * hd * 4
                + L * T * 2 * nkv * hd * 4 + rows * V * 4)
        assert tb == want, (bucket, tb, want)
        # XLA's CPU count sums every op's operands and results on the
        # reference attention path (the whole cache gathered per layer),
        # so it is far larger: 0.0234 of it at T = 64 with this jax
        # (447744 against 19149188 bytes), held to within 2x of that
        assert 0.0117 <= tb / jb <= 0.0468, (bucket, tb, jb)


async def test_records_carry_costs_and_every_build_is_counted():
    from dynamo_tpu.planner.metrics import FpmWindow as JaxWindow
    from dynamo_tpu_torch.planner.metrics import FpmWindow

    eng = torch_engine(spec_decode="ngram", spec_k=4, max_blocks_per_seq=32)
    await _collect(eng, _req(False, [5, 9, 13, 2] * 6, "spec", 48))
    await _collect(eng, _req(False, PROMPTS[1], "plain", 8))
    await eng.close()
    kinds = {}
    for r in eng.fpm:
        kinds.setdefault(r["kind"], []).append(r)
    for kind in ("prefill", "decode", "spec_verify"):
        assert kinds[kind], kind
        for r in kinds[kind]:
            assert r["xla_flops"] > 0 and r["xla_bytes"] > 0, (kind, r)
    for progs in eng._program_families():
        assert set(progs.costs) == set(progs.counts)
    assert {r["family"] for r in kinds["compile"]} >= {
        "prefill_packed", "spec_verify"}
    # the roofline gauges' inputs, read by the port's and JAX's windows
    windows = [FpmWindow(window_s=1e6), JaxWindow(window_s=1e6)]
    for w in windows:
        for r in eng.fpm:
            w.add(1, r)
    for phase in ("prefill", "decode", "spec_verify"):
        rates = [w._phase_rates(phase) for w in windows]
        assert rates[0] == rates[1]
    assert windows[0].phase_mbu("decode", 1.0) > 0.0
    assert windows[0].phase_mfu("decode", 1.0) > 0.0
    assert windows[0].compile_stats() == windows[1].compile_stats()

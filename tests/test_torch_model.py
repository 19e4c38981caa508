"""The port's Llama model against dynamo_tpu.models.llama.

The JAX package's parameters (init_params from a seed) cross to the port
through models/convert.py (bf16 upcast to float32 by the test, exact),
and the same packed prefill plus decode step runs through both on the
CPU.  Tolerances: fp32 logits within 1e-5 absolute and relative (the
same sums in another order); bf16 logits within 3e-2 absolute: both
packages round activations to bf16 after every product and norm, but XLA
and PyTorch fuse and order those roundings differently.  The logits here
reach about 4, where one bf16 ulp is 1.6e-2, and the two packages differ
by about one ulp (2.0e-2 measured), so the bound is two ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import (
    kv_cache_from_numpy,
    kv_cache_to_numpy,
    params_from_numpy,
)

pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(vocab_size=256, d_model=64, n_layers=2, ffn_dim=128)
CONFIGS = {
    # the tests/test_engine.py FP32 config
    "fp32": (jl.LlamaConfig(name="tiny32", n_heads=4, n_kv_heads=2,
                            head_dim=16, dtype=jnp.float32, **SHAPES),
             tl.LlamaConfig(name="tiny32", n_heads=4, n_kv_heads=2,
                            head_dim=16, dtype=torch.float32, **SHAPES),
             dict(rtol=1e-5, atol=1e-5)),
    # Qwen3-style per-head q/k norms (the qk_norm branch of _qkv)
    "fp32-qknorm": (jl.LlamaConfig(name="tiny32-qk", n_heads=4,
                                   n_kv_heads=2, head_dim=16, qk_norm=True,
                                   dtype=jnp.float32, **SHAPES),
                    tl.LlamaConfig(name="tiny32-qk", n_heads=4,
                                   n_kv_heads=2, head_dim=16, qk_norm=True,
                                   dtype=torch.float32, **SHAPES),
                    dict(rtol=1e-5, atol=1e-5)),
    # tiny-gqa's head grouping (8 heads over 2 kv heads) in bf16
    "bf16-gqa": (jl.LlamaConfig(name="tiny-gqa-bf16", n_heads=8,
                                n_kv_heads=2, head_dim=8, **SHAPES),
                 tl.LlamaConfig(name="tiny-gqa-bf16", n_heads=8,
                                n_kv_heads=2, head_dim=8, **SHAPES),
                 dict(rtol=0, atol=3e-2)),
}


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def test_params_from_numpy():
    jcfg, tcfg, _ = CONFIGS["bf16-gqa"]
    tree = _numpy_tree(jl.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    assert params["embedding"].dtype == torch.bfloat16
    assert params["final_norm"]["norm"].dtype == torch.float32
    assert params["layers"][1]["attn_norm"]["norm"].dtype == torch.float32
    assert len(params["layers"]) == jcfg.n_layers
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        got = params["layers"][1][name].float().numpy()
        np.testing.assert_array_equal(got, tree["layers"][1][name])
    # the bf16 round trip through float32 is exact
    np.testing.assert_array_equal(params["lm_head"].float().numpy(),
                                  tree["lm_head"])
    with pytest.raises(TypeError):
        params_from_numpy({"w": np.zeros(2, np.int8)}, tcfg, device="cpu")


def test_kv_cache_round_trip():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 5, 8, 4)).astype(np.float32)  # hd=8, bs=4
    v = rng.standard_normal((2, 3, 5, 8, 4)).astype(np.float32)
    tk, tv = kv_cache_from_numpy(k, v, device="cpu")
    assert tk.shape == (2, 3, 5, 4, 8) and tk.is_contiguous()
    # position p of block b, head dim d: JAX [.., d, p] is the port's [.., p, d]
    assert tk[1, 2, 3, 1, 6].item() == k[1, 2, 3, 6, 1]
    back_k, back_v = kv_cache_to_numpy((tk, tv))
    np.testing.assert_array_equal(back_k, k)
    np.testing.assert_array_equal(back_v, v)


def test_kv_cache_round_trip_int8():
    """int8 codes cross transposed like the data and stay int8; the scale
    planes cross unchanged."""
    rng = np.random.default_rng(1)
    k = rng.integers(-127, 128, (2, 3, 5, 8, 4)).astype(np.int8)
    v = rng.integers(-127, 128, (2, 3, 5, 8, 4)).astype(np.int8)
    ks = rng.random((2, 3, 5, 4)).astype(np.float32)
    vs = rng.random((2, 3, 5, 4)).astype(np.float32)
    tk, tv, tks, tvs = kv_cache_from_numpy(k, v, device="cpu", k_scale=ks,
                                           v_scale=vs)
    assert tk.dtype == torch.int8 and tk.shape == (2, 3, 5, 4, 8)
    assert tks.dtype == torch.float32 and tks.shape == ks.shape
    assert tk[1, 2, 3, 1, 6].item() == k[1, 2, 3, 6, 1]
    for got, want in zip(kv_cache_to_numpy((tk, tv, tks, tvs)),
                         (k, v, ks, vs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _packed_inputs(bs):
    """Two prompts (7 and 5 tokens) packed into one 16-token stream with a
    padded tail, then one decode step for each."""
    toks = np.array([5, 9, 13, 2, 7, 11, 3, 40, 41, 42, 43, 44] + [0] * 4,
                    np.int32)
    pos = np.array(list(range(7)) + list(range(5)) + [0] * 4, np.int32)
    seg = np.array([0] * 7 + [1] * 5 + [0] * 4, np.int32)
    valid = np.arange(16) < 12
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    last = np.array([6, 11], np.int32)
    dec = dict(tokens=np.array([17, 23], np.int32),
               positions=np.array([7, 5], np.int32),
               ctx=np.array([7, 5], np.int32))
    return toks, pos, seg, valid, tables, last, dec


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_packed_and_decode_match_jax(name):
    jcfg, tcfg, tol = CONFIGS[name]
    bs, nb = 4, 8
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    toks, pos, seg, valid, tables, last, dec = _packed_inputs(bs)

    shape = jl.kv_cache_shapes(jcfg, nb, bs)[0]
    jkv = (jnp.zeros(shape, jcfg.dtype), jnp.zeros(shape, jcfg.dtype))
    jlog, jkv = jl.prefill_packed(
        jparams, jcfg, jkv, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(seg), jnp.asarray(tables), jnp.asarray(last),
        jnp.asarray(valid))
    jdec, jkv = jl.decode(
        jparams, jcfg, jkv, jnp.asarray(dec["tokens"]),
        jnp.asarray(dec["positions"]), jnp.asarray(tables),
        jnp.asarray(dec["ctx"]))

    tkv = tuple(torch.zeros(s, dtype=tcfg.dtype)
                for s in tl.kv_cache_shapes(tcfg, nb, bs))
    t = {k: torch.from_numpy(v) for k, v in dict(
        toks=toks, pos=pos, seg=seg, valid=valid, tables=tables,
        last=last).items()}
    tlog, tkv = tl.prefill_packed(tparams, tcfg, tkv, t["toks"], t["pos"],
                                  t["seg"], t["tables"], t["last"],
                                  t["valid"])
    tdec, tkv = tl.decode(tparams, tcfg, tkv,
                          torch.from_numpy(dec["tokens"]),
                          torch.from_numpy(dec["positions"]), t["tables"],
                          torch.from_numpy(dec["ctx"]))

    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), **tol)
    # the caches agree outside the garbage block, through the conversion
    tk, tv = kv_cache_to_numpy(tkv)
    for got, want in ((tk, jkv[0]), (tv, jkv[1])):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], **tol)


@pytest.mark.parametrize("name", ["fp32", "fp32-qknorm"])
def test_prefill_packed_and_decode_int8_match_jax(name):
    """The same prefill and decode step on an int8 cache (k, v, k_scale,
    v_scale), in the fp32 configs, where the two packages compute the
    same fp32 sums (the bf16 config's one-ulp K/V differences move int8
    codes across half steps, which the logits then amplify past the
    bf16 bound): logits within 1e-5, and the caches carried
    back through kv_cache_to_numpy agree: codes within one step (where
    the two packages' K/V differ by a rounding, a code on a half step
    may round the other way), scales at the tolerance."""
    jcfg, tcfg, tol = CONFIGS[name]
    bs, nb = 4, 8
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    toks, pos, seg, valid, tables, last, dec = _packed_inputs(bs)

    shape = jl.kv_cache_shapes(jcfg, nb, bs)[0]
    sshape = jl.kv_cache_scale_shapes(jcfg, nb, bs)[0]
    jkv = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
           jnp.zeros(sshape, jnp.float32), jnp.zeros(sshape, jnp.float32))
    jlog, jkv = jl.prefill_packed(
        jparams, jcfg, jkv, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(seg), jnp.asarray(tables), jnp.asarray(last),
        jnp.asarray(valid))
    jdec, jkv = jl.decode(
        jparams, jcfg, jkv, jnp.asarray(dec["tokens"]),
        jnp.asarray(dec["positions"]), jnp.asarray(tables),
        jnp.asarray(dec["ctx"]))

    assert tl.kv_cache_scale_shapes(tcfg, nb, bs)[0] == sshape
    tkv = tuple(torch.zeros(s, dtype=torch.int8)
                for s in tl.kv_cache_shapes(tcfg, nb, bs)) + tuple(
        torch.zeros(s) for s in tl.kv_cache_scale_shapes(tcfg, nb, bs))
    t = {k: torch.from_numpy(v) for k, v in dict(
        toks=toks, pos=pos, seg=seg, valid=valid, tables=tables,
        last=last).items()}
    tlog, tkv = tl.prefill_packed(tparams, tcfg, tkv, t["toks"], t["pos"],
                                  t["seg"], t["tables"], t["last"],
                                  t["valid"])
    tdec, tkv = tl.decode(tparams, tcfg, tkv,
                          torch.from_numpy(dec["tokens"]),
                          torch.from_numpy(dec["positions"]), t["tables"],
                          torch.from_numpy(dec["ctx"]))
    assert len(tkv) == 4

    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), **tol)
    got = kv_cache_to_numpy(tkv)
    for i, (g, w) in enumerate(zip(got, jkv)):
        g, w = g[:, :, 1:], np.asarray(w)[:, :, 1:]
        if i < 2:
            assert g.dtype == np.int8
            np.testing.assert_allclose(g.astype(np.int32),
                                       w.astype(np.int32), rtol=0, atol=1)
        else:
            np.testing.assert_allclose(g, w, **tol)


def _int8_or_float_caches(jcfg, tcfg, nb, bs, int8):
    shape = jl.kv_cache_shapes(jcfg, nb, bs)[0]
    if not int8:
        return ((jnp.zeros(shape, jcfg.dtype), jnp.zeros(shape, jcfg.dtype)),
                tuple(torch.zeros(s, dtype=tcfg.dtype)
                      for s in tl.kv_cache_shapes(tcfg, nb, bs)))
    sshape = jl.kv_cache_scale_shapes(jcfg, nb, bs)[0]
    jkv = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
           jnp.zeros(sshape, jnp.float32), jnp.zeros(sshape, jnp.float32))
    tkv = tuple(torch.zeros(s, dtype=torch.int8)
                for s in tl.kv_cache_shapes(tcfg, nb, bs)) + tuple(
        torch.zeros(s) for s in tl.kv_cache_scale_shapes(tcfg, nb, bs))
    return jkv, tkv


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["argmax", "sampled"])
def test_decode_multi_matches_jax(int8, sampled):
    """A 5-step burst after the packed prefill, at the engine's fixed
    batch: 4 lanes of which 1 and 3 are padding (all-zero tables, so
    their writes land in the garbage block), tables covering the whole
    burst.  Tokens equal, argmax or drawn by each package's stateless
    sampler with the running step; the caches agree outside block 0 as
    in the single-step tests."""
    from dynamo_tpu.engine.sampler import sample_tokens as jax_sample
    from dynamo_tpu_torch.engine.sampler import sample_tokens

    jcfg, tcfg, tol = CONFIGS["fp32"]
    bs, nb, k = 4, 8, 5
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    toks, pos, seg, valid, tables, last, _ = _packed_inputs(bs)
    jkv, tkv = _int8_or_float_caches(jcfg, tcfg, nb, bs, int8)
    _, jkv = jl.prefill_packed(
        jparams, jcfg, jkv, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(seg), jnp.asarray(tables), jnp.asarray(last),
        jnp.asarray(valid))
    t = [torch.from_numpy(a) for a in (toks, pos, seg, tables, last, valid)]
    tl.prefill_packed(tparams, tcfg, tkv, *t)

    lanes = dict(
        tokens=np.int32([17, 0, 23, 0]), positions=np.int32([7, 0, 5, 0]),
        ctx=np.int32([7, 0, 5, 0]),
        tables=np.int32([[1, 2, 3, 0], [0] * 4, [4, 5, 6, 0], [0] * 4]),
        valid=np.array([True, False, True, False]))
    samp = dict(seeds=np.int32([3, 0, 99, 0]), steps=np.int32([1, 1, 1, 1]),
                temps=np.float32([0.9, 0.0, 1.2, 0.0]),
                top_ks=np.int32([0, 0, 8, 0]),
                top_ps=np.float32([0.95, 1.0, 1.0, 1.0]))
    jfn = tfn = None
    if sampled:
        js = {n: jnp.asarray(v) for n, v in samp.items()}
        ts = {n: torch.from_numpy(v) for n, v in samp.items()}

        def jfn(logits, i):
            return jax_sample(logits, js["seeds"], js["steps"] + i,
                              js["temps"], js["top_ks"], js["top_ps"])

        def tfn(logits, i):
            return sample_tokens(logits, ts["seeds"], ts["steps"] + i,
                                 ts["temps"], ts["top_ks"], ts["top_ps"])

    jtoks, jkv = jl.decode_multi(
        jparams, jcfg, jkv, jnp.asarray(lanes["tokens"]),
        jnp.asarray(lanes["positions"]), jnp.asarray(lanes["tables"]),
        jnp.asarray(lanes["ctx"]), k, jfn, valid=jnp.asarray(lanes["valid"]))
    ttoks, tkv = tl.decode_multi(
        tparams, tcfg, tkv, *(torch.from_numpy(lanes[n]) for n in (
            "tokens", "positions", "tables", "ctx")), k, tfn,
        valid=torch.from_numpy(lanes["valid"]))
    assert ttoks.shape == (k, 4) and ttoks.dtype == torch.int32
    np.testing.assert_array_equal(ttoks.numpy()[:, [0, 2]],
                                  np.asarray(jtoks)[:, [0, 2]])
    got = kv_cache_to_numpy(tkv)
    for i, (g, w) in enumerate(zip(got, jkv)):
        g, w = g[:, :, 1:], np.asarray(w)[:, :, 1:]
        if int8 and i < 2:
            np.testing.assert_allclose(g.astype(np.int32),
                                       w.astype(np.int32), rtol=0, atol=1)
        else:
            np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


def test_moe_and_unknown_impls_raise():
    """An unknown attention impl raises, and so does an unknown MoE
    dispatch, with JAX's ValueError (a MoE config builds: the family is
    ported, tests/test_torch_moe.py)."""
    moe = dict(n_layers=1, n_experts=4, moe_dispatch="grouped",
               dtype=torch.float32)
    jmoe = jl.LlamaConfig(**{**moe, "dtype": jnp.float32})
    tmoe = tl.LlamaConfig(**moe)
    layer = {"moe_gate": torch.zeros(tmoe.d_model, 4)}
    with pytest.raises(ValueError) as want:
        jl._ffn({"moe_gate": jnp.zeros((jmoe.d_model, 4))}, jmoe,
                jnp.zeros((1, jmoe.d_model)))
    with pytest.raises(ValueError) as got:
        tl._ffn(layer, tmoe, torch.zeros(1, tmoe.d_model))
    assert str(got.value) == str(want.value)
    cfg = CONFIGS["fp32"][1]
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    assert params["layers"][0]["wq"].shape == (64, 64)
    assert params["embedding"].device.type == "cpu"
    bad = tl.LlamaConfig(**{**cfg.__dict__, "attn_impl": "pallas"})
    kv = tuple(torch.zeros(s) for s in tl.kv_cache_shapes(cfg, 4, 4))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tl.decode(params, bad, kv, one, one,
                  torch.ones(1, 1, dtype=torch.int32), one)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_decode_hidden_and_unembed_match_jax(tied):
    """decode_hidden returns the final-norm hidden state JAX's returns,
    unembed_weight the same [d, vocab] matrix (embedding.T when tied),
    and their product is decode's logits: the operands of the fused
    epilogue."""
    jcfg, tcfg, tol = CONFIGS["fp32"]
    jcfg = jl.LlamaConfig(**{**jcfg.__dict__, "tie_embeddings": tied})
    tcfg = tl.LlamaConfig(**{**tcfg.__dict__, "tie_embeddings": tied})
    bs, nb = 4, 8
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    assert ("lm_head" in tparams) is not tied
    toks, pos, seg, valid, tables, last, dec = _packed_inputs(bs)
    jkv, tkv = _int8_or_float_caches(jcfg, tcfg, nb, bs, False)
    _, jkv = jl.prefill_packed(
        jparams, jcfg, jkv, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(seg), jnp.asarray(tables), jnp.asarray(last),
        jnp.asarray(valid))
    tl.prefill_packed(tparams, tcfg, tkv, *(torch.from_numpy(a) for a in (
        toks, pos, seg, tables, last, valid)))
    jh, _ = jl.decode_hidden(
        jparams, jcfg, jkv, jnp.asarray(dec["tokens"]),
        jnp.asarray(dec["positions"]), jnp.asarray(tables),
        jnp.asarray(dec["ctx"]))
    args = (torch.from_numpy(dec["tokens"]),
            torch.from_numpy(dec["positions"]), torch.from_numpy(tables),
            torch.from_numpy(dec["ctx"]))
    kv0 = tuple(t.clone() for t in tkv)
    th, _ = tl.decode_hidden(tparams, tcfg, tkv, *args)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    uw = tl.unembed_weight(tparams, tcfg)
    np.testing.assert_array_equal(
        uw.numpy(), np.asarray(jl.unembed_weight(jparams, jcfg)))
    logits, _ = tl.decode(tparams, tcfg, kv0, *args)
    np.testing.assert_array_equal((th @ uw).float().numpy(), logits.numpy())


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["argmax", "sampled"])
def test_decode_multi_hidden_with_fused_epilogue_matches_jax(sampled):
    """A 5-step burst through decode_multi_hidden with each package's
    fused epilogue (ops/fused_sampling.py, tile 64 over the 256-token
    vocab: four tiles) gives JAX's tokens, and the port's decode_multi
    with the plain sampler gives the same."""
    from dynamo_tpu.ops import fused_sampling as jf
    from dynamo_tpu_torch.engine.sampler import sample_tokens
    from dynamo_tpu_torch.ops import fused_sampling as tf

    jcfg, tcfg, _ = CONFIGS["fp32"]
    bs, nb, k = 4, 8, 5
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(_numpy_tree(jparams), tcfg, device="cpu")
    toks, pos, seg, valid, tables, last, _ = _packed_inputs(bs)
    jkv, tkv = _int8_or_float_caches(jcfg, tcfg, nb, bs, False)
    _, jkv = jl.prefill_packed(
        jparams, jcfg, jkv, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(seg), jnp.asarray(tables), jnp.asarray(last),
        jnp.asarray(valid))
    tl.prefill_packed(tparams, tcfg, tkv, *(torch.from_numpy(a) for a in (
        toks, pos, seg, tables, last, valid)))
    kv_off = tuple(t.clone() for t in tkv)
    lanes = dict(tokens=np.int32([17, 23]), positions=np.int32([7, 5]),
                 ctx=np.int32([7, 5]),
                 tables=np.int32([[1, 2, 3, 0], [4, 5, 6, 0]]))
    samp = dict(seeds=np.int32([3, 99]), steps=np.int32([1, 1]),
                temps=np.float32([0.9, 1.2] if sampled else [0.0, 0.0]),
                top_ks=np.int32([0, 8]), top_ps=np.float32([0.95, 1.0]))
    js = {n: jnp.asarray(v) for n, v in samp.items()}
    ts = {n: torch.from_numpy(v) for n, v in samp.items()}
    juw = jl.unembed_weight(jparams, jcfg)
    tuw = tl.unembed_weight(tparams, tcfg)

    def jfn(h, i):
        if not sampled:
            return jf.fused_greedy_tokens(h, juw, tile=64)
        return jf.fused_sample_tokens(h, juw, js["seeds"], js["steps"] + i,
                                      js["temps"], js["top_ks"],
                                      js["top_ps"], tile=64)

    def tfn(h, i):
        if not sampled:
            return tf.fused_greedy_tokens(h, tuw, tile=64)
        return tf.fused_sample_tokens(h, tuw, ts["seeds"], ts["steps"] + i,
                                      ts["temps"], ts["top_ks"],
                                      ts["top_ps"], tile=64)

    def tref(logits, i):
        return sample_tokens(logits, ts["seeds"], ts["steps"] + i,
                             ts["temps"], ts["top_ks"], ts["top_ps"])

    jtoks, _ = jl.decode_multi_hidden(
        jparams, jcfg, jkv, *(jnp.asarray(lanes[n]) for n in (
            "tokens", "positions", "tables", "ctx")), k, jfn)
    targs = [torch.from_numpy(lanes[n]) for n in ("tokens", "positions",
                                                  "tables", "ctx")]
    ttoks, _ = tl.decode_multi_hidden(tparams, tcfg, tkv, *targs, k, tfn)
    off, _ = tl.decode_multi(tparams, tcfg, kv_off, *targs, k, tref)
    assert ttoks.shape == (k, 2) and ttoks.dtype == torch.int32
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(ttoks.numpy(), off.numpy())

"""The port's LoRA serving (CPU) against the JAX package's.

* lora/bank.py: lora_delta with a scalar, a [B] and a [T] index;
  write_adapter and clear_slot write in place (the tensors keep their
  identities) and hold the values JAX's functional writes give.
* lora/source.py: LocalLoraSource.load and padded_to on fp32 and bf16
  PEFT files equal JAX's (tensors, rank, scaling, base model, errors).
* models/llama.py with a bank: prefill_packed (a [T] per-token index),
  decode, decode_multi, decode_hidden and decode_multi_hidden (a [B]
  index) and prefill (a scalar one) against JAX's, logits and written KV
  within 1e-5 (tests/test_lora.py's tiny fp32 CFG, weights and banks
  carried across through models/convert.py); the dense-merge oracle and
  clear_slot tests of tests/test_lora.py, mirrored.
* TorchEngine against JaxEngine with the same config: the mixed batch of
  tests/test_lora.py (streams equal JAX's and the merged-weight
  engines'), the unknown-adapter errors, the LRU slot choice and
  eviction order, KV events with adapter-salted hashes, a lane that
  changes adapter between bursts, an int8 cache.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.lora import bank as jbank
from dynamo_tpu.lora.source import LocalLoraSource as JaxSource
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.lora import bank as tbank
from dynamo_tpu_torch.lora import LocalLoraSource
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import (
    bank_from_numpy,
    kv_cache_to_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.tokens import compute_block_hashes_for_request
from test_lora import (
    CFG,
    RANK,
    merged_params,
    random_adapter_arrays,
    write_peft_adapter,
)
from test_torch_overlap import _collect, _req

pytestmark = pytest.mark.allow_slow_callbacks

TCFG = tl.LlamaConfig(name="tiny32", vocab_size=128, d_model=32, n_layers=2,
                      n_heads=4, n_kv_heads=2, head_dim=8, ffn_dim=64,
                      dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = [3, 14, 15, 9, 2, 6]
# tests/test_lora.py's engine config
ENGINE = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16), decode_fused_steps=2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _params(seed=0):
    return _np(jl.init_params(CFG, jax.random.PRNGKey(seed)))


def _banks(n_slots=3, seeds=(1, 2)):
    """(JAX bank, torch bank, adapters): adapter seeds[i] in slot i + 1."""
    jb = jbank.empty_bank(CFG.n_layers, n_slots, RANK, CFG.d_model,
                          CFG.q_dim, CFG.kv_dim, dtype=jnp.float32)
    ads = [random_adapter_arrays(CFG, RANK, seed=s) for s in seeds]
    for i, ad in enumerate(ads):
        jb = jbank.write_adapter(jb, i + 1, ad)
    return jb, bank_from_numpy(_np(jb), torch.float32, "cpu"), ads


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# ------------------------- bank math ----------------------------------------


@pytest.mark.parametrize("kind", ["scalar", "per-lane", "per-token"])
def test_lora_delta_matches_jax(kind):
    """A scalar index (one sequence), [B] per decode lane over x
    [B, 1, d] and [T] per packed token over x [T, d]."""
    jb, tb, _ = _banks()
    rng = np.random.default_rng(3)
    if kind == "scalar":
        x, idx = rng.normal(size=(5, CFG.d_model)), np.int32(2)
    elif kind == "per-lane":
        x = rng.normal(size=(3, 1, CFG.d_model))
        idx = np.array([0, 2, 1], np.int32)
    else:
        x = rng.normal(size=(9, CFG.d_model))
        idx = np.array([1, 1, 0, 2, 2, 2, 0, 1, 0], np.int32)
    x = x.astype(np.float32)
    for li in range(CFG.n_layers):
        jl_ = jbank.bank_layer(jb, li)
        tl_ = tbank.bank_layer(tb, li)
        for t in tbank.TARGETS:
            # q_dim == d_model in CFG: the same x feeds every target
            want = jbank.lora_delta(jnp.asarray(x), jl_[f"A_{t}"],
                                    jl_[f"B_{t}"], jnp.asarray(idx))
            got = tbank.lora_delta(_t(x), tl_[f"A_{t}"], tl_[f"B_{t}"],
                                   _t(idx))
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_write_and_clear_slot_in_place_match_jax():
    """write_adapter and clear_slot write into the same tensors (the
    captured graphs hold their addresses) and give JAX's values."""
    jb = jbank.empty_bank(CFG.n_layers, 3, RANK, CFG.d_model, CFG.q_dim,
                          CFG.kv_dim, dtype=jnp.float32)
    tb = tbank.empty_bank(CFG.n_layers, 3, RANK, CFG.d_model, CFG.q_dim,
                          CFG.kv_dim, dtype=torch.float32,
                          device=torch.device("cpu"))
    ids = {k: v.data_ptr() for k, v in tb.items()}
    objs = {k: id(v) for k, v in tb.items()}
    ad = random_adapter_arrays(CFG, RANK, seed=5)
    # a subset of targets: the rest of the slot stays as it was
    part = {k: v for k, v in random_adapter_arrays(CFG, RANK, 6).items()
            if k.endswith("_q")}
    jb = jbank.write_adapter(jbank.write_adapter(jb, 2, ad), 1, part)
    assert tbank.write_adapter(tbank.write_adapter(tb, 2, ad), 1, part) is tb
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jb = jbank.clear_slot(jb, 2)
    assert tbank.clear_slot(tb, 2) is tb
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        assert tb[k].data_ptr() == ids[k] and id(tb[k]) == objs[k]
    with pytest.raises(KeyError, match="A_x"):
        tbank.write_adapter(tb, 1, {"A_x": ad["A_q"]})


# ------------------------- PEFT source ---------------------------------------


def _write_bf16_adapter(root, name, rank, alpha, seed):
    """write_peft_adapter's layout with bf16 tensors (ml_dtypes on the
    JAX side of the test only)."""
    import ml_dtypes
    from safetensors.numpy import save_file

    raw = write_peft_adapter(root, name, CFG, rank=rank, alpha=alpha,
                             seed=seed)
    save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in raw.items()},
              os.path.join(root, name, "adapter_model.safetensors"))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_local_source_matches_jax(dtype, tmp_path):
    root = str(tmp_path)
    if dtype == "fp32":
        write_peft_adapter(root, "my-adapter", CFG, rank=2, alpha=4, seed=7)
    else:
        _write_bf16_adapter(root, "my-adapter", rank=2, alpha=4, seed=7)
    src, jsrc = LocalLoraSource(root), JaxSource(root)
    assert src.list() == jsrc.list() == ["my-adapter"]
    ad, jad = src.load("my-adapter", CFG.n_layers), \
        jsrc.load("my-adapter", CFG.n_layers)
    assert (ad.name, ad.rank, ad.scaling, ad.base_model) == \
        (jad.name, jad.rank, jad.scaling, jad.base_model) == \
        ("my-adapter", 2, 2.0, "tiny32")
    assert ad.tensors.keys() == jad.tensors.keys()
    for k in ad.tensors:
        assert ad.tensors[k].dtype == jad.tensors[k].dtype == np.float32
        np.testing.assert_array_equal(ad.tensors[k], jad.tensors[k])
    p, jp = ad.padded_to(8), jad.padded_to(8)
    for k in p.tensors:
        np.testing.assert_array_equal(p.tensors[k], jp.tensors[k])
    assert ad.padded_to(2) is ad
    with pytest.raises(ValueError) as want:
        jad.padded_to(1)
    with pytest.raises(ValueError) as got:
        ad.padded_to(1)
    assert str(got.value) == str(want.value)


def test_source_without_lora_weights_raises_jax_error(tmp_path):
    from safetensors.numpy import save_file

    d = tmp_path / "empty"
    d.mkdir()
    (d / "adapter_config.json").write_text(json.dumps({"r": 4}))
    save_file({"other.weight": np.zeros(3, np.float32)},
              str(d / "adapter_model.safetensors"))
    with pytest.raises(ValueError) as want:
        JaxSource(str(tmp_path)).load("empty", 2)
    with pytest.raises(ValueError) as got:
        LocalLoraSource(str(tmp_path)).load("empty", 2)
    assert str(got.value) == str(want.value)
    assert LocalLoraSource(str(tmp_path / "nope")).list() == []


# ------------------------- the model with a bank -----------------------------


def _caches():
    jk, jv = jl.kv_cache_shapes(CFG, 16, 4)
    tk, tv = tl.kv_cache_shapes(TCFG, 16, 4)
    return ((jnp.zeros(jk, jnp.float32), jnp.zeros(jv, jnp.float32)),
            (torch.zeros(tk), torch.zeros(tv)))


def _same_kv(tkv, jkv):
    for got, want in zip(kv_cache_to_numpy(tkv), jkv):
        np.testing.assert_allclose(got[:, :, 1:], np.asarray(want)[:, :, 1:],
                                   **TOL)


def test_prefill_packed_per_token_adapters_match_jax():
    """Three segments (base, adapter 1, adapter 2) in one packed stream,
    each token its own slot."""
    params, (jb, tb, _) = _params(), _banks()
    T = 16
    toks = np.zeros(T, np.int32)
    toks[:13] = np.random.default_rng(2).integers(0, 128, 13)
    seg = np.array([0] * 5 + [1] * 4 + [2] * 4 + [0] * 3, np.int32)
    pos = np.array(list(range(5)) + list(range(4)) + list(range(4))
                   + [0] * 3, np.int32)
    valid = np.arange(T) < 13
    lidx = np.array([0] * 5 + [1] * 4 + [2] * 4 + [0] * 3, np.int32)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    last = np.array([4, 8, 12], np.int32)
    jkv, tkv = _caches()
    jlog, jkv = jl.prefill_packed(
        jax.tree_util.tree_map(jnp.asarray, params), CFG, jkv,
        *(jnp.asarray(a) for a in (toks, pos, seg, tables, last, valid)),
        lora_bank=jb, adapter_idx=jnp.asarray(lidx))
    tlog, tkv = tl.prefill_packed(
        params_from_numpy(params, TCFG, "cpu"), TCFG, tkv,
        *(_t(a) for a in (toks, pos, seg, tables, last, valid)),
        lora_bank=tb, adapter_idx=_t(lidx))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _same_kv(tkv, jkv)
    # the adapters moved the logits (the bank is really read)
    plain, _ = tl.prefill_packed(
        params_from_numpy(params, TCFG, "cpu"), TCFG, _caches()[1],
        *(_t(a) for a in (toks, pos, seg, tables, last, valid)))
    assert torch.equal(plain[0], tlog[0])
    assert not torch.allclose(plain[1:], tlog[1:], atol=1e-3)


def _decode_inputs():
    toks = np.array([5, 9, 13], np.int32)
    pos = np.array([3, 1, 0], np.int32)
    tables = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    return toks, pos, tables, pos.copy(), np.array([0, 1, 2], np.int32)


@pytest.mark.parametrize("fn", ["decode", "decode_hidden", "decode_multi",
                                "decode_multi_hidden"])
def test_decode_family_per_lane_adapters_match_jax(fn):
    """Three lanes on adapters 0, 1, 2 over a random cache: logits (or
    final-norm hidden states, or the burst's greedy tokens) and the
    written KV within 1e-5."""
    params, (jb, tb, _) = _params(), _banks()
    toks, pos, tables, ctx, lidx = _decode_inputs()
    rng = np.random.default_rng(4)
    jkv, _ = _caches()
    jkv = tuple(jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
                for a in jkv)
    from dynamo_tpu_torch.models.convert import kv_cache_from_numpy

    tkv = kv_cache_from_numpy(*(np.asarray(a) for a in jkv), device="cpu")
    jargs = (jax.tree_util.tree_map(jnp.asarray, params), CFG, jkv,
             *(jnp.asarray(a) for a in (toks, pos, tables, ctx)))
    targs = (params_from_numpy(params, TCFG, "cpu"), TCFG, tkv,
             *(_t(a) for a in (toks, pos, tables, ctx)))
    jlora = dict(lora_bank=jb, adapter_idx=jnp.asarray(lidx))
    tlora = dict(lora_bank=tb, adapter_idx=_t(lidx))
    if fn in ("decode", "decode_hidden"):
        want, jkv = getattr(jl, fn)(*jargs, **jlora)
        got, tkv = getattr(tl, fn)(*targs, **tlora)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   **TOL)
    else:
        uw = jl.unembed_weight(jargs[0], CFG)

        def jsample(out, _):
            return jnp.argmax(out @ uw if fn.endswith("hidden") else out,
                              axis=-1)

        tuw = tl.unembed_weight(targs[0], TCFG)

        def tsample(out, _):
            return torch.argmax(out @ tuw if fn.endswith("hidden") else out,
                                dim=-1)

        want, jkv = getattr(jl, fn)(*jargs, 3, jsample, **jlora)
        got, tkv = getattr(tl, fn)(*targs, 3, tsample, **tlora)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_kv(tkv, jkv)


def test_prefill_matches_dense_merge_oracle():
    """tests/test_lora.py's oracle on the port: adapter slot 1 equals the
    dense-merged weights; slot 0 equals the base model (and JAX's)."""
    params, (jb, tb, (ad, _)) = _params(), _banks()
    toks = _t(np.arange(8) % 50, torch.int32)
    pos = torch.arange(8, dtype=torch.int32)
    table = torch.arange(1, 3, dtype=torch.int32)
    tp = params_from_numpy(params, TCFG, "cpu")
    merged = params_from_numpy(_np(merged_params(params, ad)), TCFG, "cpu")

    def run(p, **kw):
        return tl.prefill(p, TCFG, _caches()[1], toks, pos, table, 0, 8,
                          **kw)[0]

    bank = run(tp, lora_bank=tb, adapter_idx=torch.tensor(1))
    torch.testing.assert_close(bank, run(merged), rtol=2e-4, atol=2e-4)
    zero = run(tp, lora_bank=tb, adapter_idx=torch.tensor(0))
    assert torch.equal(zero, run(tp))
    want, _ = jl.prefill(
        jax.tree_util.tree_map(jnp.asarray, params), CFG, _caches()[0],
        jnp.asarray(toks.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(table.numpy()), jnp.int32(0), jnp.int32(8),
        lora_bank=jb, adapter_idx=jnp.int32(1))
    np.testing.assert_allclose(bank.numpy(), np.asarray(want), **TOL)


def test_clear_slot_restores_base():
    tb = tbank.empty_bank(CFG.n_layers, 2, RANK, CFG.d_model, CFG.q_dim,
                          CFG.kv_dim, dtype=torch.float32,
                          device=torch.device("cpu"))
    tbank.clear_slot(tbank.write_adapter(
        tb, 1, random_adapter_arrays(CFG, RANK, seed=3)), 1)
    bl = tbank.bank_layer(tb, 0)
    d = tbank.lora_delta(torch.ones(2, CFG.d_model), bl["A_q"], bl["B_q"],
                         torch.tensor([1, 1], dtype=torch.int32))
    assert float(d.abs().max()) == 0.0


# ------------------------- the engine ----------------------------------------


def _adapters(root):
    write_peft_adapter(root, "ad1", CFG, rank=2, alpha=2, seed=11)
    write_peft_adapter(root, "ad2", CFG, rank=4, alpha=4, seed=22)
    write_peft_adapter(root, "ad3", CFG, rank=3, alpha=6, seed=33)


def engines(params, events=None, **over):
    """(JaxEngine, TorchEngine) with the same config and weights; with
    `events` a dict, each engine's netted KV events land in its list."""
    kw = {**ENGINE, **over}
    je = JaxEngine(JaxEngineConfig(model_config=CFG, **kw),
                   params=jax.tree_util.tree_map(jnp.asarray, params))
    te = TorchEngine(EngineConfig(model_config=TCFG, **kw),
                     params=params_from_numpy(params, TCFG, "cpu"),
                     device="cpu")
    if events is not None:
        for name, eng in (("jax", je), ("torch", te)):
            events[name] = []
            eng.kv_event_sink = (lambda s, r, t, into=events[name]:
                                 into.append((list(s), list(r), t)))
        je._sink_takes_tier = True
    return je, te


def _lreq(jax_side, rid, lora, n=8, tokens=PROMPT):
    req = _req(jax_side, tokens, rid, n)
    req.lora_name = lora
    return req


async def _mixed(eng, jax_side, names=(None, "ad1", "ad2")):
    try:
        return list(await asyncio.gather(*[
            _collect(eng, _lreq(jax_side, f"r-{n}", n)) for n in names]))
    finally:
        await eng.close()


async def test_engine_serves_mixed_lora_batch_like_jax(tmp_path):
    """tests/test_lora.py's mixed batch (base, ad1, ad2 at once) on the
    port: streams equal JAX's, and each equals a bank-less port engine
    whose weights were dense-merged with that adapter; the slots taken
    are JAX's set (two concurrent loads race to their slots, in either
    engine)."""
    _adapters(str(tmp_path))
    params = _params(3)
    lora = dict(lora_max_adapters=4, lora_rank=4, lora_dir=str(tmp_path))
    je, te = engines(params, **lora)
    jres = await _mixed(je, True)
    tres = await _mixed(te, False)
    assert tres == jres
    # the two loads race to their slots, in either engine
    assert set(te._lora_slots) == set(je._lora_slots) == {"ad1", "ad2"}
    assert set(te._lora_slots.values()) == {1, 2}
    assert te.lora_bank["A_q"].shape == (CFG.n_layers, 5, CFG.d_model, 4)
    src = LocalLoraSource(str(tmp_path))
    for name, got in zip((None, "ad1", "ad2"), tres):
        p = params if name is None else _np(merged_params(
            params, src.load(name, CFG.n_layers).tensors))
        ref = TorchEngine(EngineConfig(model_config=TCFG, **ENGINE),
                          params=params_from_numpy(p, TCFG, "cpu"),
                          device="cpu")
        try:
            assert await _collect(ref, _lreq(False, "ref", None)) == got
        finally:
            await ref.close()
    assert len({tuple(t) for t in tres}) == 3


async def test_unknown_and_disabled_adapter_errors_match_jax(tmp_path):
    async def first_error(eng, jax_side, name):
        try:
            outs = [o async for o in eng.generate(
                _lreq(jax_side, "r", name, 2, [1, 2, 3]))]
            assert outs[-1].finish_reason == "error"
            return outs[-1].error
        finally:
            await eng.close()

    params = _params()
    for over in (dict(lora_max_adapters=2, lora_rank=4,
                      lora_dir=str(tmp_path)),
                 dict(lora_max_adapters=2, lora_rank=4),
                 {}):
        je, te = engines(params, **over)
        want = await first_error(je, True, "nope")
        got = await first_error(te, False, "nope")
        assert got == want and "nope" in got
    assert EngineConfig(lora_max_adapters=2).lora_max_adapters == 2


async def test_lru_slot_choice_and_eviction_match_jax(tmp_path):
    """Two slots, adapters served one at a time: ad1, ad2, ad1 (ad2 is now
    the least recently used), ad3 (evicts ad2 into its slot), ad2 (evicts
    ad1).  After each request the slot map and the LRU order equal JAX's,
    and ad3's stream on the evicting engine equals its stream on a fresh
    engine."""
    _adapters(str(tmp_path))
    params = _params(3)
    lora = dict(lora_max_adapters=2, lora_rank=4, lora_dir=str(tmp_path))
    je, te = engines(params, **lora)
    order = ["ad1", "ad2", "ad1", "ad3", "ad2"]
    seen = {"jax": [], "torch": []}
    streams = {"jax": [], "torch": []}
    for name, eng, side in (("jax", je, True), ("torch", te, False)):
        try:
            for i, ad in enumerate(order):
                streams[name].append(await _collect(
                    eng, _lreq(side, f"r{i}", ad, 4)))
                seen[name].append((dict(eng._lora_slots),
                                   list(eng._lora_lru)))
        finally:
            await eng.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][3] == ({"ad1": 1, "ad3": 2}, ["ad1", "ad3"])
    assert seen["torch"][4] == ({"ad3": 2, "ad2": 1}, ["ad3", "ad2"])
    assert streams["torch"] == streams["jax"]
    _, fresh = engines(params, **lora)
    try:
        assert await _collect(fresh, _lreq(False, "f", "ad3", 4)) \
            == streams["torch"][3]
        assert await _collect(fresh, _lreq(False, "g", "ad2", 4)) \
            == streams["torch"][4]
    finally:
        await fresh.close()


async def test_kv_events_carry_adapter_salted_hashes(tmp_path):
    """A 10-token prompt (two full blocks) served base and under ad1: the
    netted KV events equal JAX's, and the adapter's stored hashes are
    its name-salted block hashes, disjoint from the base ones."""
    _adapters(str(tmp_path))
    prompt = list(range(20, 30))
    events = {}
    je, te = engines(_params(3), events, lora_max_adapters=2, lora_rank=4,
                     lora_dir=str(tmp_path))
    for eng, side in ((je, True), (te, False)):
        try:
            for name in (None, "ad1"):
                await _collect(eng, _lreq(side, f"r-{name}", name, 3,
                                          prompt))
            await asyncio.sleep(0.05)  # the sinks run on the loop thread
        finally:
            await eng.close()
    assert events["torch"] == events["jax"]
    stored = [h for s, _, _ in events["torch"] for h in s]
    base = compute_block_hashes_for_request(prompt, 4)
    salted = compute_block_hashes_for_request(prompt, 4, lora_name="ad1")
    assert set(base[:2]) <= set(stored) and set(salted[:2]) <= set(stored)
    assert not set(base) & set(salted)


async def test_lane_changing_adapter_does_not_chain_stale_lidx(tmp_path):
    """One decode lane: an ad1 request, then an ad2 request admitted into
    the freed lane while the first one's bursts may still be in flight.
    Both streams equal JAX's and their streams served alone; a
    descriptor that differs from the last one only in a lane's adapter
    is no continuation."""
    _adapters(str(tmp_path))
    params = _params(3)
    lora = dict(lora_max_adapters=2, lora_rank=4, lora_dir=str(tmp_path),
                max_num_seqs=1)

    async def back_to_back(eng, side):
        try:
            return list(await asyncio.gather(
                _collect(eng, _lreq(side, "a", "ad1", 9)),
                _collect(eng, _lreq(side, "b", "ad2", 9))))
        finally:
            await eng.close()

    je, te = engines(params, **lora)
    jres = await back_to_back(je, True)
    tres = await back_to_back(te, False)
    assert tres == jres
    for got, name in zip(tres, ("ad1", "ad2")):
        _, alone = engines(params, **lora)
        try:
            assert await _collect(alone, _lreq(False, "x", name, 9)) == got
        finally:
            await alone.close()
    # the continuation check reads the lidx lane
    a = te.graphs.host_descriptor()
    a["valid"][0] = True
    a["lidx"][0] = 2
    te._last_desc = {**{n: v for n, v in a.items()
                        if n not in ("tokens", "use_chain")}, "k": 2}
    te._last_desc["lidx"] = np.array([1], np.int32)
    for n in ("positions", "ctx_lens", "steps"):
        te._last_desc[n] = a[n] - 2
    assert not te._is_continuation(a, [], 2)
    te._last_desc["lidx"] = np.array([2], np.int32)
    assert te._is_continuation(a, [], 2)


async def test_int8_cache_mixed_batch_matches_jax(tmp_path):
    _adapters(str(tmp_path))
    params = _params(3)
    je, te = engines(params, kv_cache_dtype="int8", lora_max_adapters=4,
                     lora_rank=4, lora_dir=str(tmp_path))
    jres = await _mixed(je, True, (None, "ad2", "ad1"))
    tres = await _mixed(te, False, (None, "ad2", "ad1"))
    assert tres == jres
    assert set(te._lora_slots) == {"ad2", "ad1"}

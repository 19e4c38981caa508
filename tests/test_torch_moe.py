"""The port's MoE family (Mixtral) against dynamo_tpu.models.llama.

The JAX package's parameters (init_params from a seed, fp32) cross to
the port through models/convert.py, inputs are made from numpy seeds,
and the same calls run through both packages on the CPU:

* routing and both dispatches (`_moe_router`, `moe_dispatch_dense`,
  `moe_dispatch_capacity`) to rtol/atol 2e-4, as tests/test_moe.py holds
  the JAX functions: capacity overflow (capacity factor 0.25), `valid`
  masks, and router logits with planted ties, where the expert order of
  equal logits (`lax.top_k`: the lower id first) decides the capacity
  positions;
* the model's forwards: `prefill`, `prefill_batched` (each row its own
  capacity pool, as tests/test_moe.py:188), `prefill_packed`, `decode`,
  `decode_multi` and `spec_verify_packed`, in both dispatches, to
  1e-5 in fp32;
* TorchEngine against JaxEngine on the same converted weights: greedy
  streams equal with dense dispatch (packed prefill), with capacity
  dispatch for one slot (the padded B = 1 program) and for co-scheduled
  arrivals (`prefill_batched` with JAX's equal budget shares), and a
  prefix-cache rerun equal to the first run (tests/test_moe.py:112);
  capacity dispatch never reaches the packed programs;
* the preset table equals JAX's, and an unknown moe_dispatch raises
  JAX's ValueError.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import (
    kv_cache_to_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

pytestmark = pytest.mark.allow_slow_callbacks

TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_moe.py's
FWD = dict(rtol=1e-5, atol=1e-5)     # fp32 forwards, as test_torch_model
# tiny-moe's shapes in fp32, one layer for the dispatch tests
MOE = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
           head_dim=16, ffn_dim=128, n_experts=4, experts_per_token=2)


def cfgs(n_layers=2, **kw):
    """(JAX config, port config) of an fp32 tiny-moe variant."""
    base = {**MOE, "name": "moe32", "n_layers": n_layers, **kw}
    return (jl.LlamaConfig(dtype=jnp.float32, **base),
            tl.LlamaConfig(dtype=torch.float32, **base))


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)


def _params(jcfg, tcfg, seed=0):
    jp = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(_numpy_tree(jp), tcfg, device="cpu")


def test_presets_equal_jax():
    """Every JAX preset has a port preset with equal fields, the dtype
    compared by name (jnp.bfloat16 against torch.bfloat16)."""
    assert list(tl.PRESETS) == list(jl.PRESETS)
    for name, j in jl.PRESETS.items():
        t = tl.PRESETS[name]
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert set(jf) == set(tf), name
        assert str(tf.pop("dtype")).split(".")[-1] == \
            jnp.dtype(jf.pop("dtype")).name, name
        assert tf == jf, name
    assert tl.PRESETS["mixtral-8x7b"].n_experts == 8
    assert tl.PRESETS["tiny-moe"].moe_dispatch == "dense"


def test_init_params_moe_shapes_match_jax():
    jcfg, tcfg = cfgs()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.init_params(tcfg, torch.Generator().manual_seed(0))
    for jlay, tlay in zip(jp["layers"], tp["layers"]):
        assert sorted(jlay) == sorted(tlay)
        for k in jlay:
            if k.endswith("norm"):
                continue
            assert tuple(tlay[k].shape) == jlay[k].shape, k
            assert tlay[k].dtype == torch.float32
    # the scales: each weight's std is 1/sqrt(its fan-in)
    lay = tl.init_params(cfgs(ffn_dim=1024)[1],
                         torch.Generator().manual_seed(1))["layers"][0]
    for k, fan in (("moe_w_gate", 64), ("moe_w_down", 1024)):
        assert abs(lay[k].std().item() * fan ** 0.5 - 1.0) < 0.05, k


def test_params_from_numpy_carries_the_expert_stacks():
    """The bf16 tiny-moe tree through models/convert.py: the router and
    the 3-D expert stacks take the model's dtype (no "norm" key), the
    norms stay fp32, every value exact."""
    jcfg = jl.PRESETS["tiny-moe"]
    tree = _numpy_tree(jl.init_params(jcfg, jax.random.PRNGKey(2)))
    got = params_from_numpy(tree, tl.PRESETS["tiny-moe"], device="cpu")
    lay = got["layers"][1]
    for k in ("moe_gate", "moe_w_gate", "moe_w_up", "moe_w_down"):
        assert lay[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(lay[k].float().numpy(),
                                      tree["layers"][1][k])
    assert lay["moe_w_down"].shape == (4, 128, 64)
    assert lay["mlp_norm"]["norm"].dtype == torch.float32


def _x(T, seed=1, ties=False, d=64):
    """Random activations; with `ties` small integers, so the router
    logits over _tie_gate's dyadic columns are exact in any summation
    order and equal columns give equal logits in both packages."""
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(-2, 3, (T, d)).astype(np.float32)
    return rng.standard_normal((T, d)).astype(np.float32)


def _tie_gate(d=64, E=4, seed=9):
    """Router columns in quarters with 2 == 0 and 3 == 1: every token's
    logits tie pairwise, so its top 2 are one tied pair, picked in
    expert order."""
    g = np.random.default_rng(seed).integers(-1, 2, (d, E)) * 0.25
    g[:, 2], g[:, 3] = g[:, 0], g[:, 1]
    return g.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
def test_router_matches_jax(ties):
    jcfg, tcfg = cfgs(n_layers=1)
    jp, tp = _params(jcfg, tcfg)
    jlay, tlay = dict(jp["layers"][0]), tp["layers"][0]
    if ties:
        g = _tie_gate()
        jlay["moe_gate"] = jnp.asarray(g)
        tlay = {**tlay, "moe_gate": torch.from_numpy(g)}
    x = _x(37, ties=ties)
    jw, je = jl._moe_router(jlay, jcfg, jnp.asarray(x))
    tw, te = tl._moe_router(tlay, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    if ties:
        # exact logits, ranked with the lower id first among equals
        want = np.argsort(-(x @ g), axis=1, kind="stable")[:, :2]
        np.testing.assert_array_equal(te.numpy(), want)
        assert (te[:, 1] - te[:, 0] == 2).sum() > 30


# (dispatch, capacity factor, valid mask, planted ties)
DISPATCH_CASES = [
    ("dense", 1.25, False, False),
    ("dense", 1.25, True, False),
    ("capacity", 1.25, False, False),
    ("capacity", 1.25, True, False),
    ("capacity", 0.25, False, False),   # overflow: most tokens dropped
    ("capacity", 0.25, True, True),
    ("capacity", 1.0, False, True),
    ("capacity", 2.0, True, False),     # E/k: dropless
]


@pytest.mark.parametrize(
    "dispatch,cf,masked,ties", DISPATCH_CASES,
    ids=[f"{d}-cf{c}-{'valid' if m else 'all'}-{'ties' if t else 'plain'}"
         for d, c, m, t in DISPATCH_CASES])
def test_dispatch_matches_jax(dispatch, cf, masked, ties):
    jcfg, tcfg = cfgs(n_layers=1, moe_dispatch=dispatch,
                      moe_capacity_factor=cf)
    jp, tp = _params(jcfg, tcfg, seed=2)
    jlay, tlay = dict(jp["layers"][0]), dict(tp["layers"][0])
    if ties:
        g = _tie_gate()
        jlay["moe_gate"], tlay["moe_gate"] = jnp.asarray(g), \
            torch.from_numpy(g)
    T = 24
    x = _x(T, seed=3, ties=ties)
    valid = (np.random.default_rng(4).random(T) < 0.6) if masked else None
    jfn = jl._moe_mlp if dispatch == "capacity" else jl._moe_mlp_dense
    tfn = tl._moe_mlp if dispatch == "capacity" else tl._moe_mlp_dense
    want = np.asarray(jfn(jlay, jcfg, jnp.asarray(x),
                          None if valid is None else jnp.asarray(valid)))
    got = tfn(tlay, tcfg, torch.from_numpy(x),
              None if valid is None else torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # _ffn flattens leading dims the same way
    got3 = tl._ffn(tlay, tcfg, torch.from_numpy(x).reshape(4, 6, -1),
                   None if valid is None
                   else torch.from_numpy(valid).reshape(4, 6))
    np.testing.assert_allclose(got3.reshape(T, -1).numpy(), want, **TOL)
    if masked and dispatch == "dense":
        assert np.abs(got[~valid]).max() == 0.0
    if cf == 0.25:
        # C = ceil(24 * 2 / 4 * 0.25) = 3 slots an expert: most tokens
        # get nothing
        assert tl.moe_capacity(tcfg, T) == 3
        assert (np.abs(got).sum(axis=1) == 0).sum() > T // 3


def test_capacity_overflow_drops_tokens_like_jax():
    """tests/test_moe.py:66 on the port: one slot per expert, every token
    routed to expert 2: only the first token gets its expert's output."""
    jcfg, tcfg = cfgs(n_layers=1, experts_per_token=1,
                      moe_dispatch="capacity", moe_capacity_factor=0.25)
    jp, tp = _params(jcfg, tcfg)
    gate = np.zeros((64, 4), np.float32)
    gate[:, 2] = 1.0
    tlay = {**tp["layers"][0], "moe_gate": torch.from_numpy(gate)}
    x = torch.ones(4, 64)
    out = tl._moe_mlp(tlay, tcfg, x)
    g = torch.nn.functional.silu(x[0] @ tlay["moe_w_gate"][2]) \
        * (x[0] @ tlay["moe_w_up"][2])
    np.testing.assert_allclose(out[0].numpy(),
                               (g @ tlay["moe_w_down"][2]).numpy(), **TOL)
    assert out[1:].abs().max().item() == 0.0


def test_unknown_dispatch_raises_like_jax():
    jcfg, tcfg = cfgs(n_layers=1, moe_dispatch="sparse")
    jp, tp = _params(jcfg, tcfg)
    with pytest.raises(ValueError) as want:
        jl._ffn(jp["layers"][0], jcfg, jnp.zeros((2, 64)))
    with pytest.raises(ValueError) as got:
        tl._ffn(tp["layers"][0], tcfg, torch.zeros(2, 64))
    assert str(got.value) == str(want.value)


# -- model forwards ---------------------------------------------------------

BS, NB = 4, 16


def _caches(jcfg, tcfg):
    shape = jl.kv_cache_shapes(jcfg, NB, BS)[0]
    return ((jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)),
            tuple(torch.zeros(s) for s in tl.kv_cache_shapes(tcfg, NB, BS)))


def _same_caches(tkv, jkv):
    for got, want in zip(kv_cache_to_numpy(tkv), jkv):
        np.testing.assert_allclose(got[:, :, 1:],
                                   np.asarray(want)[:, :, 1:], **FWD)


def _packed():
    """Two prompts (7 and 5 tokens) packed into a 16-token stream with a
    padded tail."""
    rng = np.random.default_rng(6)
    toks = np.zeros(16, np.int32)
    toks[:12] = rng.integers(1, 256, 12)
    pos = np.array(list(range(7)) + list(range(5)) + [0] * 4, np.int32)
    seg = np.array([0] * 7 + [1] * 5 + [0] * 4, np.int32)
    valid = np.arange(16) < 12
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    last = np.array([6, 11], np.int32)
    return toks, pos, seg, tables, last, valid


DISPATCHES = ["dense", "capacity"]


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_prefill_packed_decode_and_multi_match_jax(dispatch):
    """prefill_packed, then one decode step at 4 lanes (2 padding), then a
    3-step greedy decode_multi burst: logits, tokens and caches."""
    jcfg, tcfg = cfgs(moe_dispatch=dispatch, moe_capacity_factor=1.0)
    jp, tp = _params(jcfg, tcfg, seed=5)
    jkv, tkv = _caches(jcfg, tcfg)
    arrs = _packed()
    jlog, jkv = jl.prefill_packed(jp, jcfg, jkv, *map(jnp.asarray, arrs))
    tlog, tkv = tl.prefill_packed(tp, tcfg, tkv,
                                  *map(torch.from_numpy, arrs))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD)
    lanes = dict(tokens=np.int32([17, 0, 23, 0]),
                 positions=np.int32([7, 0, 5, 0]),
                 tables=np.int32([[1, 2, 3, 0], [0] * 4, [4, 5, 6, 0],
                                  [0] * 4]),
                 ctx=np.int32([7, 0, 5, 0]))
    valid = np.array([True, False, True, False])
    order = ("tokens", "positions", "tables", "ctx")
    jdec, jkv = jl.decode(jp, jcfg, jkv, *(jnp.asarray(lanes[n])
                                           for n in order),
                          valid=jnp.asarray(valid))
    tdec, tkv = tl.decode(tp, tcfg, tkv, *(torch.from_numpy(lanes[n])
                                           for n in order),
                          valid=torch.from_numpy(valid))
    np.testing.assert_allclose(tdec.numpy()[[0, 2]],
                               np.asarray(jdec)[[0, 2]], **FWD)
    nxt = dict(lanes, positions=lanes["positions"] + 1,
               ctx=lanes["ctx"] + 1)
    jtoks, jkv = jl.decode_multi(jp, jcfg, jkv, *(jnp.asarray(nxt[n])
                                                  for n in order), 3,
                                 valid=jnp.asarray(valid))
    ttoks, tkv = tl.decode_multi(tp, tcfg, tkv, *(torch.from_numpy(nxt[n])
                                                  for n in order), 3,
                                 valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ttoks.numpy()[:, [0, 2]],
                                  np.asarray(jtoks)[:, [0, 2]])
    _same_caches(tkv, jkv)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_prefill_and_prefill_batched_match_jax(dispatch):
    """The padded B = 1 `prefill` of two chunks (the second after a
    cached prefix), and `prefill_batched` of two rows with different
    lengths in one call, against JAX's: logits and caches.  With
    capacity dispatch each batched row keeps its own pool, so the rows'
    logits also equal B = 1 prefill's (tests/test_moe.py:188)."""
    jcfg, tcfg = cfgs(moe_dispatch=dispatch, moe_capacity_factor=1.0)
    jp, tp = _params(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(8)
    T = 16
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (16, 11)]
    tables = np.zeros((2, 8), np.int32)
    for i in range(2):
        tables[i, :4] = 1 + i * 8 + np.arange(4)

    # B = 1: row 0 in two chunks (10 then 6 tokens, each padded to 16)
    jkv, tkv = _caches(jcfg, tcfg)
    for ctx, n in ((0, 10), (10, 6)):
        toks = np.zeros(T, np.int32)
        toks[:n] = prompts[0][ctx:ctx + n]
        pos = ctx + np.arange(T, dtype=np.int32)
        jlog, jkv = jl.prefill(jp, jcfg, jkv, jnp.asarray(toks),
                               jnp.asarray(pos), jnp.asarray(tables[0]),
                               jnp.int32(ctx), jnp.int32(n))
        tlog, tkv = tl.prefill(tp, tcfg, tkv, torch.from_numpy(toks),
                               torch.from_numpy(pos),
                               torch.from_numpy(tables[0]), ctx, n)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD)
    _same_caches(tkv, jkv)

    # batched: both prompts from position 0, rows 16 and 11 tokens long
    toks = np.zeros((2, T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    lens = np.int32([16, 11])
    jkv, tkv = _caches(jcfg, tcfg)
    jlog, jkv = jl.prefill_batched(jp, jcfg, jkv, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(tables),
                                   jnp.zeros(2, jnp.int32),
                                   jnp.asarray(lens))
    tlog, tkv = tl.prefill_batched(tp, tcfg, tkv, torch.from_numpy(toks),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(tables),
                                   torch.zeros(2, dtype=torch.int32),
                                   torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD)
    _same_caches(tkv, jkv)
    for i in range(2):
        _, solo_kv = _caches(jcfg, tcfg)
        solo, _ = tl.prefill(tp, tcfg, solo_kv, torch.from_numpy(toks[i]),
                             torch.from_numpy(pos[i]),
                             torch.from_numpy(tables[i]), 0, int(lens[i]))
        np.testing.assert_allclose(tlog[i].numpy(), solo.numpy(), **FWD)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_spec_verify_packed_matches_jax(dispatch):
    jcfg, tcfg = cfgs(moe_dispatch=dispatch)
    jp, tp = _params(jcfg, tcfg, seed=6)
    jkv, tkv = _caches(jcfg, tcfg)
    toks, pos, seg, tables, _, valid = _packed()
    jlog, jkv = jl.spec_verify_packed(jp, jcfg, jkv, *map(
        jnp.asarray, (toks, pos, seg, tables, valid)))
    tlog, tkv = tl.spec_verify_packed(tp, tcfg, tkv, *map(
        torch.from_numpy, (toks, pos, seg, tables, valid)))
    np.testing.assert_allclose(tlog.numpy()[valid],
                               np.asarray(jlog)[valid], **FWD)
    _same_caches(tkv, jkv)


# -- engines ----------------------------------------------------------------

COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)


def engines(dispatch="dense", cf=1.25, **over):
    """A JaxEngine and a TorchEngine serving the same fp32 tiny-moe
    weights."""
    jcfg, tcfg = cfgs(moe_dispatch=dispatch, moe_capacity_factor=cf)
    kw = {**COMMON, **over}
    je = JaxEngine(JaxEngineConfig(model_config=jcfg, **kw))
    te = TorchEngine(EngineConfig(model_config=tcfg, **kw),
                     params=params_from_numpy(_numpy_tree(je.params), tcfg,
                                              device="cpu"),
                     device="cpu")
    return je, te


def _req(jax_side, tokens, rid, n):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0),
             stop=T(max_tokens=n, ignore_eos=True))


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


async def _both(je, te, prompts, n, tag="r"):
    res = []
    for side, eng in ((True, je), (False, te)):
        res.append(await asyncio.gather(*[
            _collect(eng, _req(side, p, f"{tag}{i}", n))
            for i, p in enumerate(prompts)]))
    return res


def _spy(te, monkeypatch):
    """Count the engine's packed-prefill program runs and its padded
    dispatches by rows."""
    seen = {"packed": 0, "padded": []}
    run = te.prefill_graphs.run

    def packed(T):
        seen["packed"] += 1
        return run(T)

    monkeypatch.setattr(te.prefill_graphs, "run", packed)
    if te.padded_prefill is not None:
        prun = te.padded_prefill.run

        def padded(a):
            seen["padded"].append(len(a["true_lens"]))
            return prun(a)

        monkeypatch.setattr(te.padded_prefill, "run", padded)
    return seen


PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8], list(range(30, 50)),
           [14, 14, 2]]


async def test_dense_dispatch_streams_match_jax(monkeypatch):
    """Dense dispatch keeps the packed path: the four prompts in one
    packed dispatch, greedy streams equal to JaxEngine's."""
    je, te = engines("dense")
    seen = _spy(te, monkeypatch)
    try:
        assert te.padded_prefill is None
        jres, tres = await _both(je, te, PROMPTS, 8)
        assert tres == jres and all(len(t) == 8 for t in tres)
        assert seen["packed"] == 1 and te.metrics["prefill_steps"] == 1
    finally:
        await je.close()
        await te.close()


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
async def test_capacity_single_slot_streams_match_jax(cf, monkeypatch):
    """One slot at a time: the padded B = 1 program (a 20-token prompt in
    a 32 bucket, then a 3-token one in an 8 bucket), greedy streams equal
    to JaxEngine's; the packed programs never run.  At capacity factor
    0.5 the padded bucket drops tokens, so the padding must equal JAX's
    for the streams to agree."""
    je, te = engines("capacity", cf)
    seen = _spy(te, monkeypatch)
    try:
        for i, p in enumerate((list(range(30, 50)), [14, 14, 2])):
            jres, tres = await _both(je, te, [p], 6, tag=f"s{i}-")
            assert tres == jres and len(tres[0]) == 6
        assert seen["packed"] == 0
        assert seen["padded"] and set(seen["padded"]) == {1}
        recs = [r for r in te.fpm if r["kind"] == "prefill"]
        assert recs and not any(r["packed"] for r in recs)
        assert all(r["xla_flops"] > 0 and r["xla_bytes"] > 0 for r in recs)
    finally:
        await je.close()
        await te.close()


async def test_capacity_coscheduled_streams_match_jax(monkeypatch):
    """Four arrivals at once: prefill_batched rows with JAX's equal
    budget shares (a 16-token chunk budget: 2 rows of 8, then the rest),
    greedy streams equal to JaxEngine's, the packed programs unused."""
    je, te = engines("capacity", max_batch_tokens=16)
    seen = _spy(te, monkeypatch)
    try:
        jres, tres = await _both(je, te, PROMPTS, 6)
        assert tres == jres and all(len(t) == 6 for t in tres)
        assert seen["packed"] == 0
        assert any(rows > 1 for rows in seen["padded"])
        assert te.metrics["prefill_steps"] == je.metrics["prefill_steps"]
    finally:
        await je.close()
        await te.close()


@pytest.mark.parametrize("dispatch", DISPATCHES)
async def test_prefix_cache_rerun_matches_jax(dispatch):
    """tests/test_moe.py:112 on both engines: a rerun of the same prompt
    takes the cached prefix plus a short tail, and both runs' streams
    equal JaxEngine's; with dense dispatch (batch-invariant) the rerun
    also equals the first run."""
    je, te = engines(dispatch, max_num_seqs=2)
    prompt = [3 + ord(c) for c in "hello mixture of experts"]
    try:
        first = await _both(je, te, [prompt], 8, tag="a")
        second = await _both(je, te, [prompt], 8, tag="b")
        assert first[1] == first[0] and second[1] == second[0]
        if dispatch == "dense":
            assert second[1] == first[1]
        assert te.metrics["cache_hit_tokens"] > 0
        assert te.metrics["cache_hit_tokens"] == \
            je.metrics["cache_hit_tokens"]
    finally:
        await je.close()
        await te.close()


def test_warmup_builds_the_padded_programs():
    """Under capacity dispatch warm-up runs every padded shape serving
    can reach (B = 1 at each bucket, and each batched row count at the
    buckets its budget share allows), each with a cost count, and serving
    builds nothing more; the packed programs are not built."""
    _, tcfg = cfgs(moe_dispatch="capacity")
    te = TorchEngine(EngineConfig(model_config=tcfg, **COMMON),
                     device="cpu")
    te.warmup_decode()
    built = dict(te.padded_prefill.counts)
    want = {(1, T) for T in COMMON["prefill_buckets"]}
    # max_prefill_seqs 4 over a 2048 budget: 2 rows (share 1024) and 3-4
    # rows (padded to 4, share 512 or 682) reach every bucket here
    want |= {(r, T) for r in (2, 4) for T in COMMON["prefill_buckets"]}
    assert set(built) == want and set(built.values()) == {1}
    assert all(te.padded_prefill.costs[k]["flops"] > 0 for k in built)
    assert te.prefill_graphs.counts == {}

    async def run():
        try:
            await asyncio.gather(*[
                _collect(te, _req(False, p, f"w{i}", 4))
                for i, p in enumerate(PROMPTS)])
        finally:
            await te.close()

    asyncio.run(run())
    assert te.padded_prefill.counts == built


async def test_cli_and_worker_serve_the_moe_presets_and_a_mixtral(tmp_path,
                                                                  monkeypatch):
    """No new flag: the CLI's --model takes tiny-moe and mixtral-8x7b and
    --model-path a Mixtral checkpoint; a TorchEngineWorker on the
    tiny-moe preset publishes the JAX worker's MDC for the same config
    and streams through its request plane what a TorchEngine on the same
    weights streams."""
    import uuid

    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from test_torch_loader import write_checkpoint

    for name in ("tiny-moe", "mixtral-8x7b"):
        mc = engine_config(build_args().parse_args(
            ["--model", name])).resolve_model()
        assert mc == tl.PRESETS[name] and mc.n_experts > 0
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    path = write_checkpoint(tmp_path / "mixtral-ck", "mixtral")
    mc = engine_config(build_args().parse_args(
        ["--model-path", path])).resolve_model()
    assert (mc.n_experts, mc.experts_per_token, mc.name) == (
        4, 2, "mixtral-ck")

    kw = dict(model="tiny-moe", block_size=4, num_blocks=64,
              max_blocks_per_seq=16, max_num_seqs=2,
              prefill_buckets=(8, 16, 32), seed=3)
    want_card = JaxEngineWorker(None, JaxEngineConfig(**kw)).card.to_dict()
    toks = [5, 9, 13, 2, 7, 11, 3, 1, 40, 41]
    direct = TorchEngine(EngineConfig(**kw), device="cpu")
    want = await _collect(direct, _req(False, toks, "d", 8))
    await direct.close()
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc",
        tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
    w = await TorchEngineWorker(rt, EngineConfig(**kw), params=direct.params,
                                device="cpu").start()
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        published = await rt.discovery.get_prefix(
            w.card.key(w.served.instance_id))
        assert list(published.values()) == [want_card]
        await client.wait_for_instances()
        got = []
        async for out in client.generate(_req(False, toks, "t", 8).to_dict()):
            got.extend(out.get("token_ids", []))
        assert got == want and len(got) == 8
    finally:
        await client.close()
        await w.close()
        await rt.shutdown()

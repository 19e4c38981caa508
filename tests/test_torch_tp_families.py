"""The MoE and MLA families on a tensor-parallel mesh (CPU, fp32).

* The tp forward of models/llama.py's MoE layers (dense and capacity
  dispatch) and of models/deepseek.py (tiny-mla, dense; tiny-mla-moe in
  both dispatches), ranks as threads over one in-process gloo store
  (tests/test_torch_tp.py run_ranks): at tp = 2 and 4 the logits (and a
  burst's tokens) equal tp = 1's within 1e-5, and each rank's cache
  equals its slab of tp = 1's (MLA's latent pair: the whole cache).
* parallel/mesh.py shard_config gives each family its local counts.
* Weights by shard: init_params(shard=) and params_from_numpy(rank, tp)
  of both families, and the shard loads of synthesized Mixtral and
  DeepSeek checkpoints (and of the weight cache), each equal to the
  whole tree cut by shard_params.
* Spawned-rank engines (parallel/multihost.py): the greedy streams of a
  tp = 2 and a dp = 2 x tp = 2 TorchEngine of the MoE family (dense and
  capacity) and of the MLA family equal a JAX engine's at the same mesh
  and the port's tp = 1 engine's on the same numpy weights; both ranks
  of the MoE engine launch the same kernels.
"""

import asyncio
import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import deepseek as jd
from dynamo_tpu.models import llama as jl
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import deepseek as td
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.parallel import mesh
from dynamo_tpu_torch.parallel.mesh import shard_config, shard_params
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from test_torch_tp import _assert_trees_equal, _forward, run_ranks

pytestmark = pytest.mark.allow_slow_callbacks

# tiny-moe's widths with 8 heads over 4 kv heads, so tp = 4 divides them
MOE = dict(name="tiny-moe-tp", vocab_size=256, d_model=64, n_layers=2,
           n_heads=8, n_kv_heads=4, head_dim=16, ffn_dim=128, n_experts=4,
           experts_per_token=2)
# tiny-mla cut to 2 layers, and tiny-mla-moe
MLA = dict(jd.PRESETS["tiny-mla"].__dict__, n_layers=2)
MLA_MOE = dict(jd.PRESETS["tiny-mla-moe"].__dict__)
for _d in (MLA, MLA_MOE):
    _d.pop("dtype")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def moe_cfgs(dispatch="dense", **kw):
    base = {**MOE, "moe_dispatch": dispatch, **kw}
    return (jl.LlamaConfig(dtype=jnp.float32, **base),
            tl.LlamaConfig(dtype=torch.float32, **base))


def mla_cfgs(shapes, dispatch="dense", **kw):
    base = {**shapes, "moe_dispatch": dispatch, **kw}
    return (jd.DeepseekConfig(dtype=jnp.float32, **base),
            td.DeepseekConfig(dtype=torch.float32, **base))


def _jax_tree(jcfg, seed=0):
    init = jd.init_params if isinstance(jcfg, jd.DeepseekConfig) \
        else jl.init_params
    return _np_tree(init(jcfg, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# shard_config
# ---------------------------------------------------------------------------


def test_shard_config_gives_each_family_its_local_counts():
    _, moe = moe_cfgs()
    local = shard_config(moe, 4)
    assert (local.n_heads, local.n_kv_heads, local.n_experts,
            local.ffn_dim) == (2, 1, 1, 128)  # an expert's width whole
    _, mla = mla_cfgs(MLA_MOE)
    local = shard_config(mla, 2)
    assert (local.n_heads, local.n_experts, local.ffn_dim,
            local.moe_ffn_dim, local.kv_lora_rank,
            local.qk_rope_head_dim) == (2, 2, 64, 64, 32, 8)
    # moe_ffn_dim 0 reads ffn_dim: the routed experts stay whole
    local = shard_config(dataclasses.replace(mla, moe_ffn_dim=0), 2)
    assert (local.ffn_dim, local.moe_ffn_dim) == (64, 128)
    dense = shard_config(mla_cfgs(MLA)[1], 4)
    assert (dense.n_heads, dense.ffn_dim) == (2, 352)
    with pytest.raises(ValueError, match="n_experts of 4 does not divide"):
        shard_config(dataclasses.replace(moe, n_kv_heads=8), 8)
    assert mesh.kv_heads_replicated(mla)
    assert not mesh.kv_heads_replicated(moe)


# ---------------------------------------------------------------------------
# the tp forward, ranks as threads
# ---------------------------------------------------------------------------


def _mla_cache(cfg, nb, bs):
    return tuple(torch.zeros(s) for s in td.kv_cache_shapes(cfg, nb, bs))


def _mla_forward(name, params, cfg, kv):
    """One call of deepseek forward `name` on a fixed workload."""
    g = torch.Generator().manual_seed(5)
    mb = 6
    tables = torch.arange(1, 1 + 3 * mb, dtype=torch.int32).reshape(3, mb)
    if name == "prefill":
        toks = torch.randint(0, cfg.vocab_size, (8,), generator=g,
                             dtype=torch.int32)
        return td.prefill(params, cfg, kv, toks, torch.arange(8) + 3,
                          tables[0], 3, 6)[0]
    if name == "prefill_batched":
        toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                             dtype=torch.int32)
        pos = torch.arange(8).repeat(2, 1)
        return td.prefill_batched(params, cfg, kv, toks, pos, tables[:2],
                                  [0, 0], [8, 5])[0]
    toks = torch.randint(0, cfg.vocab_size, (3,), generator=g,
                         dtype=torch.int32)
    ctx = torch.tensor([0, 4, 9], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    if name == "decode":
        return td.decode(params, cfg, kv, toks, ctx, tables, ctx,
                         valid=valid)[0]
    return td.decode_multi(params, cfg, kv, toks, ctx, tables, ctx, 3,
                           valid=valid)[0]


FORWARD_CASES = {
    "moe-dense": ("moe", "dense", ["decode", "decode_multi",
                                   "prefill_packed", "prefill",
                                   "prefill_batched"]),
    # capacity dispatch is not packed-safe: the engine never packs it
    "moe-capacity": ("moe", "capacity", ["decode", "decode_multi",
                                         "prefill", "prefill_batched"]),
    "tiny-mla": ("mla", "dense", ["decode", "decode_multi", "prefill",
                                  "prefill_batched"]),
    "tiny-mla-moe-dense": ("mla-moe", "dense", ["decode", "decode_multi",
                                                "prefill",
                                                "prefill_batched"]),
    "tiny-mla-moe-capacity": ("mla-moe", "capacity", ["decode", "prefill",
                                                      "prefill_batched"]),
}


def _family_cfgs(family, dispatch):
    if family == "moe":
        return moe_cfgs(dispatch)
    return mla_cfgs(MLA if family == "mla" else MLA_MOE, dispatch)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_tp_forward_equals_tp1(case, tp):
    """Every forward of the family at tp equals tp = 1's on the same
    weights (one thread per rank); each rank's cache is its slab of
    tp = 1's, or the whole latent pair for MLA."""
    family, dispatch, names = FORWARD_CASES[case]
    jcfg, cfg = _family_cfgs(family, dispatch)
    full = _jax_tree(jcfg)
    whole = params_from_numpy(full, cfg, "cpu")
    local = shard_config(cfg, tp)
    mla = family != "moe"
    fwd = _mla_forward if mla else _forward

    def cache(c):
        return _mla_cache(c, 24, 4) if mla else tuple(
            torch.zeros(s) for s in tl.kv_cache_shapes(c, 24, 4))

    want = {}
    for name in names:
        kv1 = cache(cfg)
        want[name] = (fwd(name, whole, cfg, kv1), kv1)

    def body(r, group):
        params = params_from_numpy(full, cfg, "cpu", rank=r, tp=tp)
        params["tp"] = group
        out = {}
        for name in names:
            kv = cache(local)
            out[name] = (fwd(name, params, local, kv), kv)
        return out

    for r, outs in enumerate(run_ranks(tp, body)):
        for name, (got, kv) in outs.items():
            ref, kv1 = want[name]
            if name == "decode_multi":
                assert torch.equal(got, ref), (name, r)
            else:
                np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL,
                                           err_msg=f"{name} rank {r}")
            heads = (slice(None) if mla else
                     mesh.kv_cache_spec(r, tp, kv1[0].shape[1]))
            for a, b in zip(kv, kv1):
                np.testing.assert_allclose(a.numpy(), b[:, heads].numpy(),
                                           **TOL, err_msg=f"{name} cache")


def test_dense_dispatch_stays_batch_invariant_per_rank():
    """A token's routed MLP on a rank does not depend on the other rows
    of its batch beyond the products' rounding: dense dispatch drops
    nothing, whatever the batch (JAX tests/test_moe.py's property, per
    expert shard; the engine test below holds a prefix rerun's tokens
    identical)."""
    jcfg, cfg = moe_cfgs()
    full = _jax_tree(jcfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, cfg.d_model)).astype(np.float32))
    local = shard_config(cfg, 2)
    for r in range(2):
        layer = params_from_numpy(full, cfg, "cpu", rank=r,
                                  tp=2)["layers"][0]
        batch = tl._ffn(layer, local, x, shard=(r, 2))
        alone = torch.cat([tl._ffn(layer, local, x[i:i + 1], shard=(r, 2))
                           for i in range(6)])
        np.testing.assert_allclose(batch.numpy(), alone.numpy(), **TOL)


# ---------------------------------------------------------------------------
# weights by shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["moe", "mla", "mla-moe"])
def test_random_and_converted_weights_by_shard(family):
    jcfg, cfg = _family_cfgs(family, "dense")
    mod = tl if family == "moe" else td
    whole = mod.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.device("cpu"))
    full = _jax_tree(jcfg)
    conv = params_from_numpy(full, cfg, "cpu")
    for r in range(2):
        _assert_trees_equal(
            mod.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.device("cpu"), shard=(r, 2)),
            shard_params(whole, r, 2))
        _assert_trees_equal(params_from_numpy(full, cfg, "cpu", rank=r,
                                              tp=2),
                            shard_params(conv, r, 2))


@pytest.mark.parametrize("variant", ["mixtral", "deepseek-v2", "deepseek-v3"])
def test_checkpoint_and_cache_load_by_shard(variant, tmp_path, monkeypatch):
    """Synthesized checkpoints (tests/test_torch_loader.py's writers):
    expert stacks cut on the expert axis, kv_b_proj split into w_uk/w_uv
    and cut by head."""
    from dynamo_tpu_torch.models.loader import load_params
    from test_torch_loader import write_checkpoint, write_deepseek_checkpoint

    monkeypatch.delenv("DYN_WEIGHT_CACHE", raising=False)
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    path = (write_checkpoint(tmp_path / "ck", variant)
            if variant == "mixtral" else
            write_deepseek_checkpoint(tmp_path / "ck", variant[-2:]))
    whole = load_params(path, device="cpu", host_cache=False)
    for r in range(2):
        _assert_trees_equal(load_params(path, device="cpu", host_cache=False,
                                        shard=(r, 2)),
                            shard_params(whole, r, 2))
    load_params(path, device="cpu")  # a tp = 1 load fills the cache
    for r in range(2):
        _assert_trees_equal(load_params(path, device="cpu", shard=(r, 2)),
                            shard_params(whole, r, 2))


# ---------------------------------------------------------------------------
# spawned-rank engines against JAX's engine at the same mesh
# ---------------------------------------------------------------------------

COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
PROMPTS = [list(range(60, 75)), [3, 1, 4, 1, 5, 9],
           [2, 7, 1, 8, 2, 8, 1, 8], list(range(30, 50))]
MESH_TIMEOUT_S = 30.0


def _req(jax_side, tokens, rid, n):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=0.0),
             stop=T(max_tokens=n, ignore_eos=True))


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        toks.extend(out.token_ids)
    return toks


async def _streams(eng, jax_side=False):
    """The four prompts at once, then the first again (a prefix rerun:
    the cached blocks plus a short tail)."""
    many = await asyncio.gather(*[
        _collect(eng, _req(jax_side, p, f"c{i}", 6))
        for i, p in enumerate(PROMPTS)])
    again = await _collect(eng, _req(jax_side, PROMPTS[0], "again", 6))
    return list(many) + [again]


ENGINE_CASES = {
    "moe-dense-tp2": ("moe", "dense", dict(tp=2)),
    "moe-capacity-tp2": ("moe", "capacity", dict(tp=2)),
    "mla-moe-dense-tp2": ("mla-moe", "dense", dict(tp=2)),
    "moe-dense-dp2-tp2": ("moe", "dense", dict(dp=2, tp=2)),
    "mla-moe-capacity-dp2-tp2": ("mla-moe", "capacity", dict(dp=2, tp=2)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
async def test_family_engine_streams_equal_jax_and_tp1(case):
    family, dispatch, mesh_kw = ENGINE_CASES[case]
    jcfg, cfg = _family_cfgs(family, dispatch)
    je = JaxEngine(JaxEngineConfig(model_config=jcfg, **mesh_kw, **COMMON))
    try:
        want = await _streams(je, jax_side=True)
        tree = _np_tree(je.params)
    finally:
        await je.close()
    t1 = TorchEngine(EngineConfig(model_config=cfg, **COMMON),
                     params=params_from_numpy(tree, cfg, "cpu"),
                     device="cpu")
    try:
        one = await _streams(t1)
    finally:
        await t1.close()
    world = mesh_kw.get("dp", 1) * mesh_kw["tp"]
    te = TorchEngine(EngineConfig(model_config=cfg, **mesh_kw, **COMMON),
                     params=tree, device="cpu",
                     mesh_timeout_s=MESH_TIMEOUT_S)
    try:
        local = shard_config(cfg, mesh_kw["tp"])
        assert te.shard_cfg == local
        assert te.params["layers"][-1]["moe_w_gate"].shape[0] \
            == cfg.n_experts // mesh_kw["tp"]
        got = await _streams(te)
    finally:
        await te.close()
    assert got == want == one
    assert got[-1] == got[0]  # the prefix rerun streams alike
    assert sorted(te.rank_launches) == list(range(1, world))
    assert not [p for p in mp.active_children()
                if p.name.startswith("dynamo-rank")]

"""Disaggregated serving and the KVBM tiers on a tensor-parallel mesh
(CPU, spawned gloo ranks; tests/test_torch_disagg.py's tiny32 model:
nh 4 over nkv 2, 2 layers).

* The step stream's KV moves (parallel/multihost.py, parallel/mesh.py):
  a bf16 payload crosses the stream bit-exact; the ranks' slabs
  gathered over a gloo group (ranks as threads) equal the whole cache's
  gather, and each rank's slab of a logical payload is what its cache
  holds after the inject; a follower engine keeps no KVBM tiers.
* Disaggregated serving across tp, as JAX's tests/test_disagg.py
  test_disagg_resharding_prefill_tp1_decode_tp2 holds it: a tp=1
  prefill worker feeds a tp=2 decode worker and a tp=2 prefill worker a
  tp=1 decode worker, on a bf16 model's cache and on an int8 cache, over
  host-staged frames (one pair through the in-process broker), and the
  decode side streams what an aggregated tp=1 engine streams, without
  prefilling; a JAX prefill worker feeds a torch tp=2 decode worker.
* KVBM under tp=2: a prompt's blocks offloaded to G2 (the ranks' slabs
  gathered) are onboarded on its repeat (the payload injected on every
  rank), and the streams equal a tp=1 engine's.
"""

import asyncio
import dataclasses
import datetime
import multiprocessing as mp
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.disagg import broker
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.worker import TorchEngineWorker
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops.kv_transfer import (
    gather_universal,
    inject_universal,
)
from dynamo_tpu_torch.parallel import mesh
from dynamo_tpu_torch.parallel.multihost import from_wire, to_wire
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
ECFG = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
            max_num_seqs=2, prefill_buckets=(8, 16, 32), seed=7)
PROMPT = list(range(30, 52))  # 22 tokens -> 6 blocks
# cache case -> (JAX model dtype, port model dtype, kv_cache_dtype)
CASES = {"fp32": (jnp.float32, torch.float32, "bf16"),
         "bf16": (jnp.bfloat16, torch.bfloat16, "bf16"),
         "int8": (jnp.float32, torch.float32, "int8")}
_WEIGHTS = {}


def _models(case):
    jdt, tdt, kv = CASES[case]
    return (JaxLlamaConfig(dtype=jdt, **SHAPES),
            LlamaConfig(dtype=tdt, **SHAPES), kv)


def _weights(case):
    """The JAX engine's weights (seed 7) for `case` as numpy float32 (a
    bf16 model upcasts exactly), once per process."""
    jdt = CASES[case][0]
    if jdt not in _WEIGHTS:
        je = JaxEngine(JaxEngineConfig(model_config=_models(case)[0],
                                       **ECFG))
        _WEIGHTS[jdt] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), je.params)
    return _WEIGHTS[jdt]


def _params(case, tp):
    """The port's tree (tp = 1) or the whole numpy tree (a mesh)."""
    tree = _weights(case)
    return tree if tp > 1 else params_from_numpy(tree, _models(case)[1],
                                                 device="cpu")


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


async def _aggregated(case, prompt=PROMPT, n=6):
    _, tm, kv = _models(case)
    te = TorchEngine(EngineConfig(model_config=tm, kv_cache_dtype=kv, **ECFG),
                     params=_params(case, 1), device="cpu")
    try:
        return await _collect(te, _req(False, prompt, "agg", n))
    finally:
        await te.close()


def _ranks_left() -> list:
    return [p for p in mp.active_children()
            if p.name.startswith("dynamo-rank")]


# ---------------------------------------------------------------------------
# the KV moves
# ---------------------------------------------------------------------------


def test_bf16_payload_crosses_the_stream_bit_exact():
    t = torch.randn(2, 3, 4, 2, 8).to(torch.bfloat16)
    wire = to_wire(t)
    assert wire.dtype == np.int16
    back = from_wire(wire, torch.bfloat16)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    codes = torch.randint(-127, 128, (2, 3), dtype=torch.int8)
    assert torch.equal(from_wire(to_wire(codes), torch.int8), codes)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_slabs_gather_into_the_logical_payload_and_inject_back(tp, int8):
    """Each rank's cache is its kv-head slab of one whole cache: the
    slabs gathered to rank 0 equal the whole cache's gather (scale
    planes too), and a logical payload injected with each rank's
    `heads` leaves each rank holding its slab of it."""
    rng = np.random.default_rng(4)
    L, nkv, nb, bs, hd = 2, 4, 12, 4, 8
    whole = [torch.from_numpy(rng.standard_normal((L, nkv, nb, bs, hd))
                              .astype(np.float32)) for _ in "kv"]
    if int8:
        whole = [(w * 40).to(torch.int8) for w in whole]
        whole += [torch.from_numpy(rng.uniform(0.01, 0.02, (L, nkv, nb, bs))
                                   .astype(np.float32)) for _ in "kv"]
    ids = [5, 2, 9]
    want = gather_universal(tuple(whole), ids)
    payload = [torch.from_numpy(rng.standard_normal(a.shape)
                                .astype(np.float32)).to(a.dtype)
               for a in want]
    store = dist.HashStore()
    out, errs = [None] * tp, []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("kv", store), r, tp,
                                       datetime.timedelta(seconds=30))
            group = mesh.TensorGroup("gloo", pg, r, tp)
            heads = mesh.kv_cache_spec(r, tp, nkv)
            kv = tuple(w[:, heads].clone() for w in whole)
            got = mesh.gather_slabs(group, gather_universal(kv, ids))
            inject_universal(kv, payload[0], payload[1], ids, *payload[2:],
                             heads=heads)
            out[r] = (got, kv, heads)
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs and not any(t.is_alive() for t in threads)
    assert out[0][0] is not None and all(o[0] is None for o in out[1:])
    for g, w in zip(out[0][0], want):
        assert g.shape == w.shape and torch.equal(g, w)
    for got, kv, heads in out:
        back = gather_universal(kv, ids)
        for b, p in zip(back, mesh.payload_slab(payload, heads)):
            assert torch.equal(b, p)


def test_a_follower_engine_keeps_no_tiers(tmp_path):
    """A rank built from the leader's KVBM config (a follower: `mesh`
    given) has no tier manager and makes no G3 directory."""
    _, tm, _ = _models("fp32")
    cfg = EngineConfig(model_config=tm, tp=2, host_cache_blocks=8,
                       disk_cache_dir=str(tmp_path / "g3"),
                       disk_cache_blocks=8, **ECFG)
    follower = mesh.Mesh(mesh.MeshConfig(tp=2), 1, torch.device("cpu"),
                         "gloo", None, None, None)
    eng = TorchEngine(cfg, params=_weights("fp32"), device="cpu",
                      mesh=follower)
    assert eng.kvbm is None and not (tmp_path / "g3").exists()
    assert eng.kv[0].shape[1] == SHAPES["n_kv_heads"] // 2
    assert eng._kv_heads == slice(1, 2)


# ---------------------------------------------------------------------------
# disaggregated serving across tp
# ---------------------------------------------------------------------------

HOPS = {
    # (prefill tp, decode tp, cache case, tier)
    "tp1-to-tp2-bf16": (1, 2, "bf16", "host"),
    "tp2-to-tp1-bf16": (2, 1, "bf16", "broker"),
    "tp1-to-tp2-int8": (1, 2, "int8", "host"),
    "tp2-to-tp1-int8": (2, 1, "int8", "host"),
}


@pytest.mark.parametrize("hop", list(HOPS))
async def test_disagg_across_tp_streams_the_aggregated_tp1(hop, monkeypatch):
    ptp, dtp, case, tier = HOPS[hop]
    _, tm, kv = _models(case)
    expect = await _aggregated(case)
    if tier == "host":
        monkeypatch.setattr(broker, "lookup_engine", lambda _id: None)
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    workers = []
    try:
        for role, tp, comp in (("prefill", ptp, "prefill"),
                               ("decode", dtp, "backend")):
            workers.append(await TorchEngineWorker(rt, EngineConfig(
                model_config=tm, kv_cache_dtype=kv, role=role, tp=tp,
                transfer_chunk_bytes=2048, **ECFG), component=comp,
                params=_params(case, tp), device="cpu").start())
        pw, dw = workers
        sent = []
        inner = pw.engine.extract_parked_chunk

        async def extract(request_id, start, count, **kw):
            arrs = await inner(request_id, start, count, **kw)
            sent.append([tuple(a.shape) for a in arrs])
            return arrs

        pw.engine.extract_parked_chunk = extract
        pclient = await rt.namespace("dynamo").component("prefill") \
            .endpoint("generate").client().start()
        dclient = await rt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        try:
            frames = [o async for o in pclient.generate(_req(
                False, PROMPT, "h1", 6, [DISAGG_ANNOTATION]).to_dict())]
            assert len(frames) == 1, frames
            params = frames[0]["kv_transfer_params"]
            assert params["first_token"] == expect[0]
            req = _req(False, PROMPT, "h1", 6)
            req.disaggregated_params = params
            tokens = [t async for o in dclient.generate(req.to_dict())
                      for t in o.get("token_ids", [])]
        finally:
            await pclient.close()
            await dclient.close()
        assert tokens == expect and len(expect) == 6
        assert dw.engine.metrics["prefill_tokens"] == 0
        assert dw.engine.metrics["pull_blocks"] == 6
        # the payload is logical: every kv head, whatever the sender's tp
        assert sent and all(s[0][3] == SHAPES["n_kv_heads"] for s in sent)
        assert (tier == "host") == (len(sent) > 1)
        for w in workers:
            lay = w.engine.kv_wire_layout()
            assert (lay.kv_heads, lay.tp) == (SHAPES["n_kv_heads"],
                                              w.config.tp)
        await asyncio.sleep(0.2)  # the pull's close releases the park
        assert not pw.engine._parked
    finally:
        for w in workers:
            await w.close()
        await rt.shutdown()
    ranks = [w.engine.rank_launches for w in workers if w.config.tp > 1]
    assert [sorted(r) for r in ranks] == [[1]]
    assert not _ranks_left()


async def test_jax_prefill_feeds_a_torch_tp2_decode(tmp_path):
    from dynamo_tpu.disagg.prefill_router import (
        ConditionalDisaggConfig,
        PrefillOrchestrator,
    )
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    jm, tm, kv = _models("fp32")
    expect = await _aggregated("fp32")
    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="inproc")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    jw = await JaxEngineWorker(jrt, JaxEngineConfig(
        model_config=jm, transfer_chunk_bytes=2048, role="prefill", **ECFG),
        component="prefill", params=jax.tree_util.tree_map(
            jnp.asarray, _weights("fp32"))).start()
    tw = await TorchEngineWorker(prt, EngineConfig(
        model_config=tm, role="decode", tp=2, **ECFG), component="backend",
        params=_params("fp32", 2), device="cpu").start()
    pclient = await jrt.namespace("dynamo").component("prefill").endpoint(
        "generate").client().start()
    dclient = await jrt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    orch = PrefillOrchestrator(pclient,
                               ConditionalDisaggConfig(always_remote=True))
    try:
        await pclient.wait_for_instances()
        await dclient.wait_for_instances()
        routed = await orch.maybe_prefill(_req(True, PROMPT, "x1", 6))
        assert routed.disaggregated_params is not None
        tokens = []
        async for item in dclient.generate(routed.to_dict()):
            tokens.extend(item.get("token_ids", []))
        assert tokens == expect
        assert tw.engine.metrics["prefill_tokens"] == 0
        assert tw.engine.metrics["pull_blocks"] == 6
    finally:
        await orch.close()
        await pclient.close()
        await dclient.close()
        await tw.close()
        await jw.close()
        await prt.shutdown()
        await jrt.shutdown()
    assert sorted(tw.engine.rank_launches) == [1]
    assert not _ranks_left()


# ---------------------------------------------------------------------------
# KVBM under tp
# ---------------------------------------------------------------------------

PROMPT_A = list(range(1, 13))  # 3 full blocks
CHURN = [[50 + 7 * i + j for j in range(12)] for i in range(6)]
KVBM = dict(block_size=4, num_blocks=16, max_blocks_per_seq=8,
            max_num_seqs=2, prefill_buckets=(8, 16, 32), seed=7,
            host_cache_blocks=64, offload_watermark_blocks=16)


async def _kvbm_scenario(eng):
    """Prompt A, the churn that pushes its blocks out of G1, A again:
    (first stream, repeat stream, the repeat's prefill tokens)."""
    first = await _collect(eng, _req(False, PROMPT_A, "a1", 4))
    for i, p in enumerate(CHURN):
        await _collect(eng, _req(False, p, f"churn{i}", 2))
    pre = eng.metrics["prefill_tokens"]
    again = await _collect(eng, _req(False, PROMPT_A, "a2", 4))
    return first, again, eng.metrics["prefill_tokens"] - pre


@pytest.mark.parametrize("kv", ["bf16", "int8"])
async def test_tp2_kvbm_onboards_the_repeat_like_tp1(kv):
    _, tm, _ = _models("fp32")
    res = {}
    for tp in (1, 2):
        eng = TorchEngine(EngineConfig(model_config=tm, tp=tp,
                                       kv_cache_dtype=kv, **KVBM),
                          params=_params("fp32", tp), device="cpu",
                          mesh_timeout_s=30.0)
        try:
            out = await _kvbm_scenario(eng)
        finally:
            await eng.close()
        res[tp] = (out, eng.metrics.get("kv_onboard_g2", 0),
                   eng.metrics.get("onboarded_tokens", 0))
    (first, again, pre), g2, onboarded = res[2]
    assert first == again == res[1][0][0] == res[1][0][1]
    assert res[2] == res[1]
    assert g2 > 0 and onboarded >= 8 and pre <= 8
    assert not _ranks_left()

"""The port's overlapped scheduler (CPU), mirroring tests/test_overlap.py.

* With its defaults (overlapped, decode_fused_steps=8, pipeline depth 4,
  adaptive fusion) TorchEngine gives the default JaxEngine's greedy AND
  seeded sampled streams, token for token, under staggered arrivals, on
  the bf16-config (fp32 here) and the int8 cache: the stateless sampler
  draws from fold_in(PRNGKey(seed), step) in both.
* The port's overlapped and lockstep modes give byte-identical greedy
  streams under mixed arrivals, mid-stream cancellation, preemption and
  a drain abort mid-overlap.
* Adaptive fusion ramps to the full burst and de-fuses on an arrival
  (FPM `k`); steady-state serving builds no new decode program
  (`graphs.counts`, the counterpart of compile_watch.counts).
* The overlapped port's netted KV events and FPM records equal the
  overlapped JaxEngine's (tests/test_torch_worker.py holds the lockstep
  ones); each request is sent once the engines are idle (_drive).
* With sampling_epilogue="fused" the streams equal the fused JaxEngine's
  and the port's own "off" streams, and serving builds no program.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    DRAIN_ABORT,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import CancellationToken
from test_torch_worker import _drive

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
PROMPTS = [list(range(7, 20)), list(range(40, 49)), list(range(7, 15)),
           [3, 1, 4, 1, 5, 9, 2, 6]]
# (temperature, top_k, top_p, seed) per prompt: greedy and seeded rows
SAMPLING = [(0.0, 0, 1.0, 0), (0.9, 0, 0.95, 1234), (0.0, 0, 1.0, 0),
            (1.3, 20, 1.0, 77)]

_JAX_PARAMS = {}


def _params():
    """The JAX engine's weights (seed 7), once per process, as numpy."""
    if "tree" not in _JAX_PARAMS:
        je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **COMMON))
        _JAX_PARAMS["tree"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), je.params)
    return _JAX_PARAMS["tree"]


def torch_engine(**over) -> TorchEngine:
    kw = {**COMMON, **over}
    return TorchEngine(EngineConfig(model_config=FP32, **kw),
                       params=params_from_numpy(_params(), FP32,
                                                device="cpu"),
                       device="cpu")


def jax_engine(**over) -> JaxEngine:
    return JaxEngine(JaxEngineConfig(model_config=JAX_FP32,
                                     **{**COMMON, **over}))


def _req(jax_side, tokens, rid, n, sampling=(0.0, 0, 1.0, 0)):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    temp, top_k, top_p, seed = sampling
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=temp, top_k=top_k, top_p=top_p,
                        seed=seed),
             stop=T(max_tokens=n, ignore_eos=True))


async def _collect(eng, req, token=None):
    toks = []
    async for out in eng.generate(req, token=token):
        if out.finish_reason == "error":
            raise RuntimeError(out.error)
        toks.extend(out.token_ids)
    return toks


async def _staggered(eng, jax_side, tag, n_tokens=14, stagger_s=0.1,
                     sampled=False):
    """Every prompt arriving mid-decode of the earlier ones."""
    async def one(i):
        await asyncio.sleep(i * stagger_s)
        return await _collect(eng, _req(
            jax_side, PROMPTS[i], f"{tag}-r{i}", n_tokens,
            SAMPLING[i] if sampled else (0.0, 0, 1.0, 0)))

    try:
        return await asyncio.gather(*[one(i) for i in range(len(PROMPTS))])
    finally:
        await eng.close()


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
async def test_default_streams_match_default_jax_engine(kv_cache_dtype):
    """Greedy and seeded sampled requests under staggered arrivals: the
    port's default engine streams exactly what the default JaxEngine
    streams, on both cache dtypes."""
    te = torch_engine(kv_cache_dtype=kv_cache_dtype)
    assert (te.config.decode_fused_steps, te.config.decode_pipeline_depth,
            te.config.overlap_scheduling,
            te.config.decode_fuse_adaptive) == (8, 4, True, True)
    tres = await _staggered(te, False, "t", n_tokens=20, sampled=True)
    jres = await _staggered(jax_engine(kv_cache_dtype=kv_cache_dtype), True,
                            "j", n_tokens=20, sampled=True)
    assert tres == jres
    assert all(len(t) == 20 for t in tres)
    # the sampled rows did not degenerate to greedy
    greedy = await _staggered(torch_engine(kv_cache_dtype=kv_cache_dtype),
                              False, "g", n_tokens=20)
    assert tres[1] != greedy[1] and tres[3] != greedy[3]
    assert tres[0] == greedy[0] and tres[2] == greedy[2]
    assert te.metrics["decode_bursts"] < te.metrics["decode_steps"]


async def test_overlap_and_lockstep_byte_identical_mixed_arrivals():
    sync = await _staggered(torch_engine(overlap_scheduling=False), False,
                            "sync")
    over_engine = torch_engine()
    over = await _staggered(over_engine, False, "over")
    assert over == sync
    assert over_engine.metrics["decode_tokens"] > 0


async def test_byte_identity_mid_stream_cancellation():
    """Cancelling one stream mid-decode, racing in-flight bursts and a
    deferred first token, leaves the survivor's stream as in lockstep;
    the cancelled slot is reaped."""
    async def run(overlap: bool, tag: str):
        eng = torch_engine(overlap_scheduling=overlap)
        token = CancellationToken()
        got = []

        async def victim():
            async for out in eng.generate(
                    _req(False, list(range(20, 32)), f"{tag}-v", 10_000),
                    token=token):
                got.append(out)
                if len(got) == 12:
                    token.stop()

        async def survivor():
            await asyncio.sleep(0.05)
            return await _collect(eng, _req(False, PROMPTS[0], f"{tag}-s",
                                            16))

        try:
            _, toks = await asyncio.wait_for(
                asyncio.gather(victim(), survivor()), timeout=120)
            assert got[-1].finish_reason == "cancelled"
            for _ in range(600):
                if all(s is None for s in eng._slots) and not eng.waiting:
                    break
                await asyncio.sleep(0.02)
            assert all(s is None for s in eng._slots)
        finally:
            await eng.close()
        return toks

    assert await run(True, "over") == await run(False, "sync")


async def test_preemption_byte_identical_and_equal_to_jax():
    """11 usable blocks for three sequences growing to 5 blocks each:
    bursts degrade and preempt, and the replayed streams still equal the
    lockstep port's and the default JaxEngine's."""
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
               [14, 14, 2, 7, 7, 1, 0, 9, 9, 4]]

    async def run(eng, jax_side):
        try:
            return await asyncio.gather(*[
                _collect(eng, _req(jax_side, p, f"p{i}", 10))
                for i, p in enumerate(prompts)])
        finally:
            await eng.close()

    over = torch_engine(num_blocks=12)
    res = await run(over, False)
    assert over.metrics["preemptions"] > 0
    assert res == await run(torch_engine(num_blocks=12,
                                         overlap_scheduling=False), False)
    assert res == await run(jax_engine(num_blocks=12), True)


async def test_drain_abort_mid_overlap():
    """drain_abort with unread bursts and deferred first tokens in
    flight: every stream ends with the migratable marker, and what was
    emitted is a prefix of the fault-free stream."""
    ref = await _staggered(torch_engine(), False, "ref", n_tokens=48,
                           stagger_s=0.02)
    eng = torch_engine()
    streams = {i: [] for i in range(len(PROMPTS))}
    errors = {}
    last = len(PROMPTS) - 1

    async def one(i):
        await asyncio.sleep(i * 0.02)
        async for out in eng.generate(_req(False, PROMPTS[i], f"d-r{i}",
                                           48)):
            if out.finish_reason == "error":
                errors[i] = out.error
                return
            streams[i].extend(out.token_ids)
            # mid-stream, once the last arrival is admitted: an earlier
            # drain would reject it before admission (DRAIN_REJECT)
            if len(streams[0]) >= 10 and streams[last] \
                    and not eng.draining:
                eng.drain_abort()

    try:
        await asyncio.wait_for(asyncio.gather(*[one(i) for i in streams]),
                               timeout=120)
        assert errors and all(DRAIN_ABORT in e for e in errors.values())
        for i, toks in streams.items():
            assert toks == ref[i][:len(toks)]
        for _ in range(600):
            if all(s is None for s in eng._slots):
                break
            await asyncio.sleep(0.02)
        assert all(s is None for s in eng._slots) and not eng._inflight
    finally:
        await eng.close()


async def test_adaptive_fusion_ramps_and_defuses_on_arrival():
    """A decode-only stretch ramps the burst to decode_fused_steps; an
    arrival de-fuses the burst dispatched right after its prefill to the
    interleave size (FPM records' k)."""
    eng = torch_engine(max_num_seqs=2, block_size=16,
                       prefill_buckets=(16, 32))
    arrived = asyncio.Event()

    async def first():
        toks = []
        async for out in eng.generate(_req(False, list(range(7, 20)),
                                           "ramp-r1", 80)):
            toks.extend(out.token_ids)
            if len(toks) >= 40 and not arrived.is_set():
                arrived.set()
        return toks

    async def second():
        await arrived.wait()  # mid r1's decode-only stretch
        mark = len(eng.fpm)
        return mark, await _collect(eng, _req(False, list(range(40, 49)),
                                              "ramp-r2", 8))

    try:
        toks1, (mark, toks2) = await asyncio.gather(first(), second())
    finally:
        await eng.close()
    assert len(toks1) == 80 and len(toks2) == 8
    recs = list(eng.fpm)
    ks = [r["k"] for r in recs if r["kind"] == "decode"]
    assert max(ks) == 8 and 4 in ks
    pre = [i for i, r in enumerate(recs) if r["kind"] == "prefill"
           and i >= mark]
    assert pre, "the second request's prefill was not recorded"
    after = [r["k"] for r in recs[pre[0]:] if r["kind"] == "decode"]
    assert after and after[0] <= TorchEngine.INTERLEAVE_BURST
    # and the ramp came back to full fusion once r2 was decoding alone
    assert 8 in after


async def test_serving_steady_state_builds_no_program():
    """warmup_decode builds every (greedy, k) rung of the ladder once;
    serving greedy and sampled traffic afterwards builds nothing more."""
    eng = torch_engine(block_size=16, max_blocks_per_seq=8)
    assert eng._fuse_ladder() == [1, 4, 8]
    await asyncio.to_thread(eng.warmup_decode)
    want = {(g, k): 1 for g in (True, False) for k in (1, 4, 8)}
    assert eng.graphs.counts == want
    # warm-up leaves no trace in the continuation state or the chain
    assert eng._last_desc is None and not eng._inflight
    assert int(eng.graphs.chain.abs().sum()) == 0
    try:
        for i in range(3):
            await asyncio.gather(*[
                _collect(eng, _req(False, [5 + i, 9, 13, 2, 7, 11, 3, j],
                                   f"w{i}-{j}", 40, SAMPLING[j]))
                for j in range(2)])
    finally:
        await eng.close()
    assert eng.graphs.counts == want
    # bursts that needed no new block re-used the device descriptor
    assert eng.metrics["cont_bursts"] > 0


async def test_fused_epilogue_streams_match_jax_and_off():
    """sampling_epilogue="fused": under staggered arrivals the port's
    default engine streams, greedy and seeded, what the fused JaxEngine
    streams and what the port streams with "off"; warm-up builds every
    (greedy, k) program, each with the epilogue, and serving builds
    none."""
    te = torch_engine(sampling_epilogue="fused")
    assert te.graphs.epilogue
    await asyncio.to_thread(te.warmup_decode)
    want = {(g, k): 1 for g in (True, False) for k in (1, 4, 8)}
    assert te.graphs.counts == want
    fused = await _staggered(te, False, "f", n_tokens=20, sampled=True)
    assert te.graphs.counts == want
    assert te.metrics["decode_bursts"] < te.metrics["decode_steps"]
    jres = await _staggered(jax_engine(sampling_epilogue="fused"), True,
                            "j", n_tokens=20, sampled=True)
    off = await _staggered(torch_engine(), False, "o", n_tokens=20,
                           sampled=True)
    assert fused == jres
    assert fused == off
    assert all(len(t) == 20 for t in fused)


async def test_overlapped_kv_events_match_overlapped_jax_engine():
    """tests/test_torch_worker.py's scenario (a prefix hit, eviction under
    an 11-block pool, a clear), one request at a time, through the
    overlapped port and the overlapped JaxEngine."""
    te_events, je_events = [], []
    te = torch_engine(num_blocks=12)
    te.kv_event_sink = lambda s, r, t: te_events.append(
        (list(s), list(r), t))
    je = jax_engine(num_blocks=12)
    je.kv_event_sink = lambda s, r, t: je_events.append(
        (list(s), list(r), t))
    je._sink_takes_tier = True
    try:
        jres = await _drive(je, True, je_events)
        tres = await _drive(te, False, te_events)
    finally:
        await je.close()
        await te.close()
    assert tres == jres
    assert te_events == je_events and len(te_events) > 5
    timing = {"t", "gap_s", "synced", "est_mfu", "mfu"}

    def records(eng):
        return [{k: v for k, v in r.items()
                 if k not in timing and not k.startswith("xla_")}
                for r in eng.fpm if r["kind"] in ("prefill", "decode")]

    assert records(te) == records(je)
    assert {r["k"] for r in records(te) if r["kind"] == "decode"} > {1}


async def test_reused_request_id_takes_no_stale_burst():
    """A request that reuses the id of one that just finished while its
    overshoot bursts were still in flight (a long neighbour keeps the
    pipeline full) streams what the first one streamed.  Lanes are keyed
    by (request id, epoch); with the epoch counted per slot from 0, both
    slots had the same key, and the repeat, admitted into the same lane,
    took the earlier slot's stale tokens while it was still prefilling
    (the repeat parting of test_graphed_engine_equals_eager_engine_on_gpu
    below, ROADMAP Queue 3 item 8)."""
    eng = torch_engine()
    try:
        long = asyncio.ensure_future(_collect(eng, _req(
            False, PROMPTS[0], "long", 60)))
        first = await _collect(eng, _req(False, PROMPTS[1], "x", 6,
                                         SAMPLING[1]))
        again = await _collect(eng, _req(False, PROMPTS[1], "x", 6,
                                         SAMPLING[1]))
        await long
    finally:
        await eng.close()
    assert len(first) == 6
    assert again == first


@pytest.mark.gpu
def test_graphed_engine_equals_eager_engine_on_gpu():
    """On a card: the tiny preset (bf16, hd 64) served with its decode
    programs captured by warm-up streams what the same engine streams
    with the programs run eagerly, greedy and sampled, and serving
    captures nothing more.  It runs its own event loop, so it needs no
    async support from the suite's conftest (`--noconftest` on a GPU
    host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    asyncio.run(_graphed_against_eager())


async def _graphed_against_eager():
    reqs = [_req(False, list(range(3 + i, 3 + i + n)), f"g{i}", 40,
                 SAMPLING[i]) for i, n in enumerate((300, 40, 7, 129))]
    res = {}
    for graphs in (True, False):
        eng = TorchEngine(EngineConfig(model="tiny", block_size=128,
                                       num_blocks=64, max_blocks_per_seq=8,
                                       max_num_seqs=4), device="cuda",
                          cuda_graphs=graphs)
        await asyncio.to_thread(eng.warmup_decode)
        built = dict(eng.graphs.counts)
        try:
            res[graphs] = [await asyncio.gather(*[_collect(eng, r)
                                                  for r in reqs])
                           for _ in range(2)]
        finally:
            await eng.close()
        assert eng.graphs.counts == built
        assert res[graphs][0] == res[graphs][1]
    assert res[True] == res[False]

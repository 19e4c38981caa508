"""The port's disaggregated prefill/decode against the JAX package's (CPU).

* The chunk-frame codec (dynamo_tpu_torch/disagg/transfer.py) writes the
  bytes the JAX codec writes, crc32 footer included, and each decodes the
  other's frames to the same arrays, on fp32, bf16 (without ml_dtypes on
  the port's side) and int8 with scale planes; corrupt frames and
  mismatched layouts raise the JAX codec's errors.
* gather_universal / inject_universal (ops/kv_transfer.py) equal the
  JAX engine's _gather_impl bit for bit on a converted cache, and an
  inject followed by a gather is the identity, on both cache dtypes.
* A torch prefill worker hands its KV to a torch decode worker through
  the broker tier and through host-staged frames: the streams equal an
  aggregated TorchEngine's and JaxEngine's, the decode side prefills
  nothing and the parked entry is released.
* Across frameworks, both directions (a JAX prefill worker and a torch
  decode worker, and the reverse), routed by the JAX PrefillOrchestrator
  over one file-discovery cluster: streams equal the aggregated engines',
  and every injected block is byte-identical to the sender's gathered
  block, on fp32, bf16 and int8 caches.
* The streaming pull overlaps other slots' decode with its host memory
  bounded by one chunk a step, an external cancel propagates, a parked
  entry expires after its TTL, a first token missing from the metadata
  is recomputed to the same value, and the KV events of a prefill hop
  and its pull equal the JAX engines'.
"""

import asyncio
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import transfer as jtransfer
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.protocols.llm import DISAGG_ANNOTATION as JAX_DISAGG
from dynamo_tpu_torch.disagg import broker
from dynamo_tpu_torch.disagg import transfer
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, TorchEngineWorker
from dynamo_tpu_torch.models.convert import kv_cache_from_numpy, params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops.kv_transfer import gather_universal, inject_universal
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
# tests/test_disagg.py's engine config
ECFG = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
            max_num_seqs=2, prefill_buckets=(8, 16, 32), seed=7)
PROMPT = list(range(30, 52))  # 22 tokens -> 6 blocks
# cache case -> (JAX model dtype, port model dtype, kv_cache_dtype): the
# "bf16" cache holds the model's dtype, so fp32 runs an fp32 model
CASES = {"fp32": (jnp.float32, torch.float32, "bf16"),
         "bf16": (jnp.bfloat16, torch.bfloat16, "bf16"),
         "int8": (jnp.float32, torch.float32, "int8")}
_WEIGHTS = {}


def _models(case):
    jdt, tdt, kv = CASES[case]
    return (JaxLlamaConfig(dtype=jdt, **SHAPES), LlamaConfig(dtype=tdt,
                                                             **SHAPES), kv)


def _weights(case):
    """The JAX engine's weights (seed 7) for `case`, as numpy float32
    (bf16 upcasts exactly), once per process."""
    jdt = CASES[case][0]
    if jdt not in _WEIGHTS:
        je = JaxEngine(JaxEngineConfig(model_config=_models(case)[0],
                                       **ECFG))
        _WEIGHTS[jdt] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), je.params)
    return _WEIGHTS[jdt]


def _torch_params(case):
    return params_from_numpy(_weights(case), _models(case)[1], device="cpu")


def _jax_params(case):
    jdt = CASES[case][0]
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                  _weights(case))


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


async def _aggregated(case, n=6, prompt=PROMPT):
    """The greedy stream of an aggregated TorchEngine and JaxEngine."""
    jm, tm, kv = _models(case)
    te = TorchEngine(EngineConfig(model_config=tm, kv_cache_dtype=kv, **ECFG),
                     params=_torch_params(case), device="cpu")
    je = JaxEngine(JaxEngineConfig(model_config=jm, kv_cache_dtype=kv,
                                   **ECFG), params=_jax_params(case))
    try:
        return (await _collect(te, _req(False, prompt, "agg", n)),
                await _collect(je, _req(True, prompt, "agg", n)))
    finally:
        await te.close()
        await je.close()


def _raw(a) -> bytes:
    """Bytes of a torch tensor or a numpy array (any dtype)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


async def _wait(pred, what, timeout=20.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out waiting: {what}"
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# the chunk-frame codec
# ---------------------------------------------------------------------------


def _payload(dtype: str, seed=3, nb=6):
    """Universal-layout (k, v[, ks, vs]) as numpy float32 and the port's
    tensors of `dtype` ("float32" | "bfloat16" | "int8")."""
    rng = np.random.default_rng(seed)
    shape = (2, nb, 4, 2, 8)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.random(shape[:4]).astype(np.float32) for _ in range(2))
        return (k, v, ks, vs), tuple(torch.from_numpy(a) for a in
                                     (k, v, ks, vs))
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    t = tuple(torch.from_numpy(a).to(tdt) for a in (k, v))
    # the values bf16 holds, so both sides carry the same numbers
    return tuple(x.float().numpy() for x in t), t


def _jax_arrays(arrs, dtype):
    if dtype != "bfloat16":
        return arrs
    return tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunk_frames_equal_jax_codec_both_ways(dtype):
    f32, tens = _payload(dtype)
    jarrs = _jax_arrays(f32, dtype)
    layout = transfer.KvLayout.of(tens[0], scales=dtype == "int8")
    jlayout = jtransfer.KvLayout.of(jarrs[0], scales=dtype == "int8")
    assert layout.to_dict() == jlayout.to_dict()
    assert layout.block_bytes() == jlayout.block_bytes()
    for b0, n in ((0, 2), (2, 3), (5, 1)):
        mine = transfer.encode_chunk_frame(
            b0, *(t[:, b0:b0 + n] for t in tens))
        theirs = jtransfer.encode_chunk_frame(
            b0, *(a[:, b0:b0 + n] for a in jarrs))
        assert mine == theirs  # bytes, crc32 footer included
        # the port's frame through JAX's decoder, and JAX's through the
        # port's
        jout = jtransfer.decode_chunk_frame(mine, jlayout)
        out = transfer.decode_chunk_frame(theirs, layout)
        assert jout[:2] == out[:2] == (b0, n)
        for j, t, ref in zip(jout[2:], out[2:], tens):
            assert t.dtype == ref.dtype and _raw(t) == _raw(j)
            assert torch.equal(t, ref[:, b0:b0 + n])


def test_corrupt_frames_raise_the_jax_codecs_errors():
    _, tens = _payload("int8")
    jarrs = tuple(t.numpy() for t in tens)
    layout = transfer.KvLayout.of(tens[0], scales=True)
    jlayout = jtransfer.KvLayout.of(jarrs[0], scales=True)

    def both(mutate):
        msgs = []
        for mod, lo, arrs in ((transfer, layout, tens),
                              (jtransfer, jlayout, jarrs)):
            frame = mod.encode_chunk_frame(5, *(a[:, 5:6] for a in arrs))
            mutate(frame)
            with pytest.raises(ValueError) as e:
                mod.decode_chunk_frame(frame, lo)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return msgs[0]

    assert "out of bounds" in both(lambda f: f.update(block_count=4))
    assert "crc32" in both(lambda f: f.update(
        k=bytes([f["k"][0] ^ 1]) + f["k"][1:]))
    assert "missing scale planes" in both(
        lambda f: (f.pop("ks"), f.pop("vs"), f.pop("crc")))
    # mismatched dtypes (and scales) are refused; tp may differ freely
    f32 = transfer.KvLayout.of(_payload("float32")[1][0])
    bf16 = transfer.KvLayout.of(_payload("bfloat16")[1][0])
    for a, b, field in ((f32, bf16, "dtype"), (layout, f32, "dtype")):
        with pytest.raises(ValueError, match=field):
            a.check_compatible(b)
    f32.check_compatible(transfer.KvLayout.of(_payload("float32")[1][0],
                                              tp=4))
    assert f32.blocks_per_chunk(2 * f32.block_bytes()) == 2
    assert f32.blocks_per_chunk(1) == 1


# ---------------------------------------------------------------------------
# gather and inject against the JAX engine's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_gather_equals_jax_and_inject_inverts_it(kv_dtype):
    """A JAX cache with random contents and its converted port cache: the
    port's gather equals JaxEngine._gather_impl bit for bit, and an
    inject of gathered blocks into other blocks reads back the same."""
    rng = np.random.default_rng(11)
    L, nkv, NB, hd, bs = 2, 2, 12, 16, 4
    if kv_dtype == "int8":
        k, v = (rng.integers(-127, 128, (L, nkv, NB, hd, bs)).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.random((L, nkv, NB, bs)).astype(np.float32)
                  for _ in range(2))
        jkv = tuple(jnp.asarray(a) for a in (k, v, ks, vs))
        kv = kv_cache_from_numpy(k, v, device="cpu", k_scale=ks, v_scale=vs)
    else:
        k, v = (rng.normal(size=(L, nkv, NB, hd, bs)).astype(np.float32)
                for _ in range(2))
        jkv = (jnp.asarray(k), jnp.asarray(v))
        kv = kv_cache_from_numpy(k, v, device="cpu")
    ids = [7, 2, 9, 3]
    want = JaxEngine._gather_impl(jkv, jnp.asarray(ids, jnp.int32))
    got = gather_universal(kv, ids)
    assert len(got) == len(want) == len(kv)
    for g, w in zip(got, want):
        assert g.is_contiguous() and _raw(g) == _raw(np.asarray(w))
    dst = [1, 4, 5, 11]
    inject_universal(kv, *got[:2], dst, *got[2:])
    for g, again in zip(got, gather_universal(kv, dst)):
        assert torch.equal(g, again)
    # the JAX inject of the same payload writes the same cache
    jkv = JaxEngine._inject_impl(jkv, *(jnp.asarray(np.asarray(w))
                                        for w in want[:2]),
                                 jnp.asarray(dst, jnp.int32),
                                 *(jnp.asarray(np.asarray(w))
                                   for w in want[2:]))
    for t, j in zip(kv, kv_cache_from_numpy(
            *(np.asarray(a) for a in jkv[:2]), device="cpu",
            **({"k_scale": np.asarray(jkv[2]), "v_scale": np.asarray(jkv[3])}
               if len(jkv) == 4 else {}))):
        assert torch.equal(t, j)
    # an int8 cache needs the scale planes, a bf16 one takes none
    planes = () if len(kv) == 4 else (got[0][..., 0], got[1][..., 0])
    with pytest.raises(ValueError, match="scale planes"):
        inject_universal(kv, got[0], got[1], dst, *planes)


# ---------------------------------------------------------------------------
# torch -> torch through the port's runtime
# ---------------------------------------------------------------------------


def _fresh_runtime():
    return DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex)


def _record_gathers(engine, into):
    """Wrap a sender's extract_parked_chunk to record each chunk it
    gathers (host copies), keyed by its first block."""
    inner = engine.extract_parked_chunk

    async def extract(request_id, start, count, **kw):
        arrs = await inner(request_id, start, count, **kw)
        into[start] = [a.detach().cpu().clone() if isinstance(a, torch.Tensor)
                       else np.array(a) for a in arrs]
        return arrs

    engine.extract_parked_chunk = extract


def _record_torch_injects(engine, into):
    """Wrap a torch receiver's _inject_pulled_chunk to gather back the
    blocks each chunk was written into, keyed by its first block."""
    inner = engine._inject_pulled_chunk

    def inject(slot, b0, n, arrs):
        inner(slot, b0, n, arrs)
        ids = engine.allocator.seq_block_ids(slot.request.request_id)
        into[b0] = gather_universal(engine.kv, ids[b0:b0 + n])

    engine._inject_pulled_chunk = inject


def _assert_same_blocks(sent, landed, n_chunks=None):
    assert sent and sorted(sent) == sorted(landed)
    if n_chunks is not None:
        assert len(sent) == n_chunks
    for b0 in sent:
        assert [_raw(a) for a in sent[b0]] == [_raw(a) for a in landed[b0]]


@pytest.mark.parametrize("tier", ["broker", "host"])
@pytest.mark.parametrize("case", ["fp32", "int8"])
async def test_torch_prefill_hands_off_to_torch_decode(tier, case,
                                                       monkeypatch):
    _, tm, kv = _models(case)
    expect, jexpect = await _aggregated(case)
    assert expect == jexpect and len(expect) == 6
    if tier == "host":
        monkeypatch.setattr(broker, "lookup_engine", lambda _id: None)
    rt = await _fresh_runtime().start()
    # a small frame bound, so the host tier moves several chunks
    pw = await TorchEngineWorker(rt, EngineConfig(
        model_config=tm, kv_cache_dtype=kv, role="prefill",
        transfer_chunk_bytes=2048, **ECFG), component="prefill",
        params=_torch_params(case), device="cpu").start()
    dw = await TorchEngineWorker(rt, EngineConfig(
        model_config=tm, kv_cache_dtype=kv, role="decode",
        transfer_chunk_bytes=2048, **ECFG), component="backend",
        params=_torch_params(case), device="cpu").start()
    sent, landed = {}, {}
    _record_gathers(pw.engine, sent)
    _record_torch_injects(dw.engine, landed)
    pclient = await rt.namespace("dynamo").component("prefill").endpoint(
        "generate").client().start()
    dclient = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        assert pw.card.runtime_config["role"] == "prefill"
        assert dw.card.runtime_config["role"] == "decode"
        frames = [LLMEngineOutput.from_dict(o) async for o in pclient.generate(
            _req(False, PROMPT, "d1", 6, [DISAGG_ANNOTATION]).to_dict())]
        assert len(frames) == 1 and frames[0].finish_reason == "stop"
        params = frames[0].kv_transfer_params
        assert params["engine"] == "jax"  # the wire protocol's name
        assert params["first_token"] == expect[0] == frames[0].token_ids[0]
        assert params["prompt_len"] == len(PROMPT)
        assert params["component"] == "prefill"
        assert "d1" in pw.engine._parked
        req = _req(False, PROMPT, "d1", 6)
        req.disaggregated_params = params
        tokens = [t async for o in dclient.generate(req.to_dict())
                  for t in o.get("token_ids", [])]
        assert tokens == expect
        # the decode side computed no prefill token; it pulled all six
        # blocks, in several chunks on the host tier
        assert dw.engine.metrics["prefill_tokens"] == 0
        assert dw.engine.metrics["pull_blocks"] == 6
        _assert_same_blocks(sent, landed, 1 if tier == "broker" else None)
        if tier == "host":
            assert len(sent) > 1
            bound = dw.engine.kv_wire_layout().blocks_per_chunk(2048) \
                * dw.engine.kv_wire_layout().block_bytes()
            assert 0 < dw.engine.metrics["pull_host_chunk_bytes_max"] <= bound
        else:
            assert "pull_host_chunk_bytes_max" not in dw.engine.metrics
        await _wait(lambda: not pw.engine._parked, "parked KV released")
    finally:
        await pclient.close()
        await dclient.close()
        await pw.close()
        await dw.close()
        await rt.shutdown()
    assert broker.lookup_engine(pw.served.instance_id) is None


# ---------------------------------------------------------------------------
# across frameworks, both directions
# ---------------------------------------------------------------------------


def _record_jax_injects(engine, into):
    inner = engine._inject_pulled_chunk

    def inject(slot, b0, n, arrs):
        inner(slot, b0, n, arrs)
        ids = engine.allocator.seq_block_ids(slot.request.request_id)
        into[b0] = [np.asarray(a) for a in JaxEngine._gather_impl(
            engine.kv, jnp.asarray(ids[b0:b0 + n], jnp.int32))]

    engine._inject_pulled_chunk = inject


@pytest.mark.parametrize("case", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
async def test_cross_framework_handoff(direction, case, tmp_path):
    from dynamo_tpu.disagg.prefill_router import (
        ConditionalDisaggConfig,
        PrefillOrchestrator,
    )
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    jm, tm, kv = _models(case)
    expect, jexpect = await _aggregated(case)
    assert len(expect) == 6
    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="inproc")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    roles = (("prefill", "backend") if direction == "jax_to_torch"
             else ("backend", "prefill"))
    jw = await JaxEngineWorker(jrt, JaxEngineConfig(
        model_config=jm, kv_cache_dtype=kv, transfer_chunk_bytes=2048,
        role="prefill" if roles[0] == "prefill" else "decode", **ECFG),
        component=roles[0], params=_jax_params(case)).start()
    tw = await TorchEngineWorker(prt, EngineConfig(
        model_config=tm, kv_cache_dtype=kv, transfer_chunk_bytes=2048,
        role="prefill" if roles[1] == "prefill" else "decode", **ECFG),
        component=roles[1], params=_torch_params(case),
        device="cpu").start()
    sender, receiver = ((jw, tw) if direction == "jax_to_torch"
                        else (tw, jw))
    sent, landed = {}, {}
    _record_gathers(sender.engine, sent)
    (_record_torch_injects if receiver is tw
     else _record_jax_injects)(receiver.engine, landed)
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
        dp = routed.disaggregated_params
        assert dp is not None and dp["engine"] == "jax"
        assert dp["first_token"] == jexpect[0]
        tokens = []
        async for item in dclient.generate(routed.to_dict()):
            tokens.extend(item.get("token_ids", []))
        # the decode side's own aggregated engine is the reference for
        # every token after the transferred first one
        want = expect if receiver is tw else jexpect
        assert tokens == want
        assert receiver.engine.metrics["prefill_tokens"] == 0
        assert receiver.engine.metrics["pull_blocks"] == 6
        _assert_same_blocks(sent, landed)
        assert len(sent) > 1  # several host-staged frames
        await _wait(lambda: not sender.engine._parked, "parked KV released")
    finally:
        await orch.close()
        await dclient.close()
        await tw.close()
        await jw.close()
        await prt.shutdown()
        await jrt.shutdown()


# ---------------------------------------------------------------------------
# pull behaviour (engine level, as tests/test_disagg.py)
# ---------------------------------------------------------------------------


def _engine(case="fp32", **over):
    _, tm, kv = _models(case)
    return TorchEngine(EngineConfig(model_config=tm, kv_cache_dtype=kv,
                                    **{**ECFG, **over}),
                       params=_torch_params(case), device="cpu")


async def _park(src, rid, n=4, prompt=PROMPT):
    out = None
    async for o in src.generate(_req(False, prompt, rid, n,
                                     [DISAGG_ANNOTATION])):
        out = o
    assert out.finish_reason == "stop"
    return out.kv_transfer_params


class _EngineSource:
    """A pull source over a torch engine's parked KV, host-staged."""

    def __init__(self, engine, rid, delay_s=0.0):
        self.engine, self.rid, self.delay_s = engine, rid, delay_s

    async def open(self):
        n_blocks, plen = await self.engine.parked_info(self.rid)
        return transfer.make_header(plen,
                                    self.engine.kv_wire_layout(n_blocks))

    async def chunk(self, b0, n):
        await asyncio.sleep(self.delay_s)
        return await self.engine.extract_parked_chunk(self.rid, b0, n)

    async def close(self):
        await self.engine.release_parked(self.rid)


async def test_streaming_pull_overlaps_decode_and_bounds_host_memory():
    """A slow one-block-a-chunk pull streams into the decode engine while
    it decodes another request: that request's tokens keep coming during
    the pull, and the largest host chunk is one block, not the prompt."""
    expect, _ = await _aggregated("fp32", n=4)
    src, dst = _engine(role="prefill"), _engine(role="decode")
    params = await _park(src, "d1")
    assert params["first_token"] == expect[0]

    async def pull_fn(dp):
        return _EngineSource(src, dp["request_id"], delay_s=0.03)

    dst.kv_pull_fn = pull_fn
    dst.config.transfer_chunk_bytes = 1  # one block per chunk
    bg_times = []

    async def run_bg():
        async for _ in dst.generate(_req(False, range(8), "bg", 60)):
            bg_times.append(time.monotonic())

    bg = asyncio.create_task(run_bg())
    while not bg_times:  # bg is decoding before the pull starts
        await asyncio.sleep(0.005)
    t_start = time.monotonic()
    dis = _req(False, PROMPT, "d1", 4)
    dis.disaggregated_params = params
    tokens, t_first = [], None
    async for out in dst.generate(dis):
        if t_first is None and out.token_ids:
            t_first = time.monotonic()
        tokens.extend(out.token_ids)
    await bg
    try:
        assert tokens == expect
        assert dst.metrics["prefill_tokens"] <= 8  # only bg's own prompt
        during = [t for t in bg_times if t_start < t < t_first]
        assert len(during) >= 3, (
            f"decode stalled during the pull: {len(during)} tokens in "
            f"{t_first - t_start:.3f} s")
        lo = dst.kv_wire_layout(0)
        assert dst.metrics["pull_host_chunk_bytes_max"] <= lo.block_bytes()
        assert dst.metrics["pull_blocks"] == 6
        assert not src._parked  # the source's close released it
    finally:
        await src.close()
        await dst.close()


async def test_stream_pull_external_cancel_propagates(caplog):
    """A cancel of the pull task while it awaits its prefetch propagates:
    no local-prefill fallback runs, and every block is freed."""
    src, dst = _engine(role="prefill"), _engine(role="decode")
    params = await _park(src, "c1")
    chunk_started = asyncio.Event()

    class HangingSource:
        async def open(self):
            n_blocks, plen = await src.parked_info("c1")
            return transfer.make_header(plen, src.kv_wire_layout(n_blocks))

        async def chunk(self, b0, n):
            chunk_started.set()
            await asyncio.Event().wait()  # hangs until cancelled

        async def close(self):
            pass

    async def pull_fn(dp):
        return HangingSource()

    dst.kv_pull_fn = pull_fn
    dst.config.transfer_chunk_bytes = 1

    async def consume():
        dis = _req(False, PROMPT, "c1", 4)
        dis.disaggregated_params = params
        async for _ in dst.generate(dis):
            pass

    consumer = asyncio.create_task(consume())
    await asyncio.wait_for(chunk_started.wait(), 20.0)
    await asyncio.sleep(0.05)  # the pull parks on the hanging prefetch
    consumer.cancel()
    with pytest.raises(asyncio.CancelledError):
        await consumer
    try:
        await _wait(lambda: dst.allocator.num_free
                    == dst.config.num_blocks - 1, "blocks freed")
        assert "local prefill fallback" not in caplog.text
        assert "pull_blocks" not in dst.metrics
    finally:
        await src.close()
        await dst.close()


async def test_parked_kv_expires_after_its_ttl():
    src = _engine(role="prefill")
    src.parked_ttl_s = 0.2
    events = []
    src.kv_event_sink = lambda s, r, t: events.append((list(s), list(r)))
    try:
        await _park(src, "t1")
        assert "t1" in src._parked
        free = src.allocator.num_free
        await _wait(lambda: not src._parked, "the TTL reaper", timeout=10.0)
        # the reaper freed the sequence: its full blocks stay cached, its
        # partial block returns to the free list
        assert src.allocator.num_free == free + 1
        with pytest.raises(KeyError):
            await src.parked_info("t1")
    finally:
        await src.close()


@pytest.mark.parametrize("case", ["fp32", "int8"])
async def test_missing_first_token_is_recomputed(case):
    """Transfer metadata without the first token: the decode side
    recomputes it from the last prompt position (a one-row packed
    prefill) to the prefill side's value, and streams on."""
    expect, _ = await _aggregated(case, n=5)
    src, dst = _engine(case, role="prefill"), _engine(case, role="decode")
    params = await _park(src, "m1", n=5)

    async def pull_fn(dp):
        return _EngineSource(src, dp["request_id"])

    dst.kv_pull_fn = pull_fn
    params = {k: v for k, v in params.items() if k != "first_token"}
    dis = _req(False, PROMPT, "m1", 5)
    dis.disaggregated_params = params
    try:
        assert await _collect(dst, dis) == expect
        assert dst.metrics["prefill_tokens"] == 0
        assert dst.prefill_graphs.counts == {8: 1}
    finally:
        await src.close()
        await dst.close()


async def test_disagg_kv_events_equal_jax_engines():
    """A prefill hop, its pull and the decode, on a torch pair and on a
    JAX pair: each side's netted KV events equal its JAX counterpart's."""
    jm, tm, kv = _models("fp32")
    pairs = {}
    for side in ("torch", "jax"):
        evs = {"src": [], "dst": []}
        if side == "torch":
            src, dst = _engine(role="prefill"), _engine(role="decode")
        else:
            src, dst = (JaxEngine(JaxEngineConfig(
                model_config=jm, role=r, **ECFG), params=_jax_params("fp32"))
                for r in ("prefill", "decode"))
            src._sink_takes_tier = dst._sink_takes_tier = True
        for name, eng in (("src", src), ("dst", dst)):
            eng.kv_event_sink = (lambda s, r, t, into=evs[name]:
                                 into.append((list(s), list(r), t)))
        jax_side = side == "jax"
        out = None
        async for o in src.generate(_req(jax_side, PROMPT, "e1", 4,
                                         [JAX_DISAGG])):
            out = o
        params = out.kv_transfer_params

        async def pull_fn(dp, src=src):
            if jax_side:
                from dynamo_tpu.disagg.broker import LocalEnginePullSource

                return LocalEnginePullSource(src, dp["request_id"])
            return broker.LocalEnginePullSource(src, dp["request_id"])

        dst.kv_pull_fn = pull_fn
        dis = _req(jax_side, PROMPT, "e1", 4)
        dis.disaggregated_params = params
        toks = []
        async for o in dst.generate(dis):
            toks.extend(o.token_ids)
        await _wait(lambda: not src._parked, "released")
        await asyncio.sleep(0.05)  # the sinks run on the loop thread
        await src.close()
        await dst.close()
        pairs[side] = (toks, evs)
    assert pairs["torch"] == pairs["jax"]
    toks, evs = pairs["torch"]
    assert len(toks) == 4 and evs["src"] and evs["dst"]

"""The port's cross-worker KVBM pull against the JAX package's (CPU).

* torch -> torch: a TorchEngineWorker whose G2 holds a prompt's blocks
  serves them over `kvbm_pull` to a second one, which stages them in its
  own G2 and onboards them instead of prefilling: streams equal, the
  pulled blocks byte-equal in both G2s and in the puller's device cache,
  on fp32 and int8 caches.
* JAX <-> torch over one file-discovery cluster and the zmq event plane
  (both packages reach it): each side's index learns the other's G2
  blocks, but no block crosses.  The JAX worker puts 128-bit PLHs on the
  request plane as msgpack ints, which msgpack cannot encode (its pull
  fails before it is sent); the port sends them as 16-byte wire bytes,
  which the JAX handler does not look up.  Both degrade to a local
  prefill with the reference stream (ROADMAP.md Queue 3).
* encode_block frames equal JAX's both ways, on fp32, bf16 and int8
  blocks; a tampered frame raises BlockIntegrityError and marks the
  serving peer suspect; the remote index follows a KV event stream to
  the JAX index's holders.
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu.kvbm.pools import BlockIntegrityError as JaxIntegrityError
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.kvbm import remote
from dynamo_tpu_torch.kvbm.pools import BlockIntegrityError, block_bytes
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops.kv_transfer import blocks_to_host
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.router.events import KvCacheEvent
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

from test_torch_kvbm import np_block, same_bytes, to_torch

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
# every step offloads (watermark above the pool), so a finished prompt's
# blocks reach G2 in the next step
ECFG = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
            max_num_seqs=2, prefill_buckets=(8, 16, 32), seed=7,
            host_cache_blocks=32, offload_watermark_blocks=64,
            kv_io_deadline_s=10.0)
PROMPT = list(range(30, 52))  # 22 tokens: 5 full blocks, then the tail
TICK = [200, 201, 202]  # one more request, so a step offloads PROMPT's
_WEIGHTS = {}


def _weights():
    if not _WEIGHTS:
        je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **ECFG))
        _WEIGHTS["np"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), je.params)
    return _WEIGHTS["np"]


def _req(jax_side, tokens, rid, n=6):
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


async def _wait(pred, what, timeout=20.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out waiting: {what}"
        await asyncio.sleep(0.02)


def _same(a, b) -> bool:
    """Two torch blocks hold the same bytes, shapes and dtypes."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and block_bytes(x).tobytes() == block_bytes(y).tobytes()
        for x, y in zip(a, b))


def _hashes():
    return compute_block_hashes_for_request(PROMPT, ECFG["block_size"])


async def _fill_g2(worker, jax_side):
    """Serve PROMPT, then a tick whose step offloads PROMPT's blocks;
    returns PROMPT's stream."""
    out = await _collect(worker.engine, _req(jax_side, PROMPT, "a"))
    await _collect(worker.engine, _req(jax_side, TICK, "tick", 2))
    await _wait(lambda: all(h in worker.engine.kvbm.g2
                            for h in _hashes()[:5]), "PROMPT in G2")
    return out


@pytest.mark.parametrize("cache", ["fp32", "int8"])
async def test_torch_to_torch_pull_onboards_byte_equal_blocks(cache):
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc",
        tcp_host="127.0.0.1")).start()
    cfg = dict(ECFG, kv_cache_dtype="int8" if cache == "int8" else "bf16")
    workers = []
    try:
        for _ in range(2):
            workers.append(await TorchEngineWorker(
                rt, EngineConfig(model_config=FP32, **cfg),
                params=params_from_numpy(_weights(), FP32, device="cpu"),
                device="cpu").start())
        w1, w2 = workers
        expect = await _fill_g2(w1, False)
        hashes = _hashes()
        w1_id = w1.served.instance_id
        await _wait(lambda: w2._kvbm_index.best_run(hashes) == (w1_id, 5),
                    "the puller's index sees w1's G2 run")
        got = await _collect(w2.engine, _req(False, PROMPT, "b"))
        m = w2.engine.metrics
        assert got == expect
        assert m["remote_onboarded"] == 5
        assert m["kv_onboard_g2"] == 5 and m["onboarded_tokens"] == 20
        assert m["prefill_tokens"] == 2  # the tail after 5 blocks
        for h in hashes[:5]:
            src = w1.engine.kvbm.g2.get(h)
            staged = w2.engine.kvbm.g2.get(h)
            assert len(src) == (4 if cache == "int8" else 2)
            assert _same(staged, src)
            bid = w2.engine.allocator._hash_to_block[h]
            (landed,) = blocks_to_host(w2.engine.kv, [bid])
            assert _same(landed, src)
    finally:
        for w in workers:
            await w.close()
        await rt.shutdown()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
async def test_jax_and_torch_pulls_degrade_to_prefill(direction, tmp_path):
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    jw = tw = None
    try:
        jw = await JaxEngineWorker(jrt, JaxEngineConfig(
            model_config=JAX_FP32, **ECFG), params=jax.tree_util.tree_map(
                jnp.asarray, _weights())).start()
        tw = await TorchEngineWorker(prt, EngineConfig(
            model_config=FP32, **ECFG), params=params_from_numpy(
                _weights(), FP32, device="cpu"), device="cpu").start()
        src, dst = (jw, tw) if direction == "jax_to_torch" else (tw, jw)
        expect = await _fill_g2(src, src is jw)
        hashes = _hashes()
        src_id = src.served.instance_id
        await _wait(lambda: dst._kvbm_index.best_run(hashes) == (src_id, 5),
                    "the other package's index sees the G2 run")
        got = await _collect(dst.engine, _req(dst is jw, PROMPT, "b"))
        m = dst.engine.metrics
        assert got == expect
        assert "remote_onboarded" not in m
        assert m.get("onboarded_tokens", 0) == 0
        assert m["prefill_tokens"] == len(PROMPT)  # all recomputed
        if dst is jw:
            # msgpack refused the request; the JAX puller gave the peer up
            assert dst._kvbm_index.best_run(hashes) == (None, 0)
        else:
            # the JAX handler answered the wire-byte hashes end-of-run
            assert dst._kvbm_index.best_run(hashes) == (src_id, 5)
    finally:
        for w in (tw, jw):
            if w is not None:
                await w.close()
        await prt.shutdown()
        await jrt.shutdown()


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_encode_block_frames_equal_jax_both_ways(kind):
    nb = np_block(kind, 21)
    h = (1 << 127) | 77
    frame = remote.encode_block(h, *to_torch(nb))
    jframe = jremote.encode_block(h, *nb)
    assert frame == jframe
    th, *tarr = remote.decode_block(jframe)
    assert th == h and same_bytes(tarr, nb)
    jh, *jarr = jremote.decode_block(frame)
    assert jh == h and all(np.array_equal(a.view(np.uint8),
                                          b.view(np.uint8))
                           for a, b in zip(jarr, nb))
    # the port's wire form of the hash decodes to the same block
    wire = dict(frame, h=h.to_bytes(16, "big"))
    assert remote.decode_block(wire)[0] == h
    bad = dict(frame, k=bytes([frame["k"][0] ^ 0xFF]) + frame["k"][1:])
    with pytest.raises(BlockIntegrityError):
        remote.decode_block(bad)
    with pytest.raises(JaxIntegrityError):
        jremote.decode_block(bad)
    legacy = dict(frame)
    del legacy["crc"]
    assert remote.decode_block(legacy)[0] == h


async def test_tampered_frame_marks_peer_suspect_and_attributes():
    nb = to_torch(np_block("fp32", 15))

    class FakeClient:
        def __init__(self, tamper):
            self.tamper = tamper

        async def generate(self, payload, instance_id=None):
            for h in payload["hashes"]:
                frame = remote.encode_block(h, *nb)
                if self.tamper:
                    frame["k"] = bytes([frame["k"][0] ^ 0xFF]) \
                        + frame["k"][1:]
                yield frame

    idx = remote.RemoteBlockIndex(None, "ns", "comp", self_worker_id=0)
    for h in (10, 11):
        idx.holders.setdefault(h, {}).setdefault(5, set()).add("g2")
    puller = remote.RemoteKvbmPuller(idx, FakeClient(True), timeout_s=2.0)
    seen = []
    puller.on_corruption = lambda tier, h: seen.append((tier, h))
    assert await puller.fetch_run([10, 11]) == []
    # each of KVBM_POLICY's attempts detects, attributes and marks again
    tries = remote.KVBM_POLICY.max_attempts
    assert idx.suspects == {5: tries}
    assert 5 not in idx.holders.get(10, {})
    assert seen == [("remote", 10)] * tries
    for h in (10, 11):  # re-advertised, a clean peer: pulls verify
        idx.holders.setdefault(h, {}).setdefault(5, set()).add("g2")
    puller.client = FakeClient(False)
    got = await puller.fetch_run([10, 11])
    assert [b[0] for b in got] == [10, 11]
    assert all(torch.equal(a, b) for a, b in zip(got[0][1:], nb))


async def test_remote_index_follows_events_like_jax():
    big = (1 << 127) | 3
    evs = [KvCacheEvent(7, 0, "stored", [1, 2, big], tier="g2"),
           KvCacheEvent(8, 0, "stored", [1, 2], tier="g2"),
           KvCacheEvent(7, 1, "stored", [2], tier="g3"),
           KvCacheEvent(7, 2, "removed", [2], tier="g2"),
           KvCacheEvent(8, 1, "stored", [1], tier="g1"),
           KvCacheEvent(9, 0, "stored", [5], tier="g4"),
           KvCacheEvent(0, 0, "stored", [6], tier="g2"),  # ourselves
           KvCacheEvent(8, 2, "removed", [5], tier="g4"),  # fleet-wide
           KvCacheEvent(8, 3, "cleared", []),
           KvCacheEvent(7, 3, "stored", [9], tier="g2")]

    class Plane:
        async def subscribe(self, subject, cancel):
            for ev in evs:
                yield subject, ev.to_wire()
            yield subject, {"junk": True}
            await cancel.wait()

    class Runtime:
        event_plane = Plane()

    holders = []
    for mod in (remote, jremote):
        idx = await mod.RemoteBlockIndex(Runtime(), "ns", "comp", 0).start()
        await asyncio.sleep(0.05)
        holders.append(idx.holders)
        await idx.close()
    assert holders[0] == holders[1]
    assert holders[0] == {1: {7: {"g2"}}, 2: {7: {"g3"}},
                          big: {7: {"g2"}}, 9: {7: {"g2"}}}

"""The port's KVBM (dynamo_tpu_torch/kvbm/) against the JAX package's (CPU).

* block_crc of fp32, bf16 and int8 blocks (torch tensors in the port,
  numpy arrays in JAX, bf16 through ml_dtypes there only) is equal, and
  so are the G3 and G4 blobs: a blob written by either package is read
  and verified by the other, through a shared G4 directory too.
* The same sequence of offload / fetch / match_run / clear on the two
  TieredKvManagers gives equal tier events, stats and bytes; a flipped
  byte in a G3 file is quarantined, attributed and published as a
  removal by both; the consolidators pass a foreign G4 removal through;
  coldest_evictable gives the same candidates.
* TorchEngine against JaxEngine on converted weights, fp32 and int8
  caches, in tests/test_kvbm.py's scenarios (a prefix onboarded from G2
  instead of recomputed; from G3 under host pressure) and a G4 one: equal
  streams, equal KV event sequences (tiers g1-g4), equal onboarded
  tokens, per-tier onboard counts, prefill-token deltas and tier
  occupancy; the G4 sweep reaps expired blobs and publishes removed(g4).
* The engines' KVBM config errors are JAX's, and the CLI takes the JAX
  CLI's KVBM flags with its defaults.
"""

import asyncio

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine.block_allocator import BlockAllocator as JaxAllocator
from dynamo_tpu.kvbm import KvEventConsolidator as JaxConsolidator
from dynamo_tpu.kvbm import TieredKvManager as JaxManager
from dynamo_tpu.kvbm import object_store as jobject_store
from dynamo_tpu.kvbm import pools as jpools
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator
from dynamo_tpu_torch.engine.config import _UNPORTED
from dynamo_tpu_torch.kvbm import KvEventConsolidator, TieredKvManager
from dynamo_tpu_torch.kvbm import object_store, pools
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

# engine tests run model work inside the async bodies (JAX compiles,
# CPU forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = JaxLlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
DTYPES = ("fp32", "bf16", "int8")


def eng_kwargs(**kw):
    """tests/test_kvbm.py's engine config, lockstep in both engines (the
    KV event sequences of an overlapped pair net into other batches,
    tests/test_torch_worker.py)."""
    d = dict(block_size=4, num_blocks=16, max_blocks_per_seq=8,
             max_num_seqs=2, prefill_buckets=(8, 16, 32), seed=7,
             overlap_scheduling=False, decode_fused_steps=1,
             kv_io_deadline_s=10.0)
    d.update(kw)
    return d


# ---------------------------------------------------------------------------
# blocks in both packages
# ---------------------------------------------------------------------------


def np_block(kind: str, seed: int, shape=(2, 4, 2, 8)):
    """A JAX-side block (numpy): (k, v), plus fp32 scales for int8."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.random(shape[:-1]).astype(np.float32)
                  for _ in range(2))
        return k, v, ks, vs
    dt = np.float32 if kind == "fp32" else ml_dtypes.bfloat16
    return tuple(rng.normal(size=shape).astype(dt) for _ in range(2))


def to_torch(blk):
    """The same bytes as torch tensors (bf16 through a uint16 view)."""
    out = []
    for a in blk:
        if a.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(a.view(np.uint16).copy())
                       .view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a.copy()))
    return tuple(out)


def same_bytes(tblk, nblk) -> bool:
    return len(tblk) == len(nblk) and all(
        pools.block_bytes(t).tobytes() == np.ascontiguousarray(a).tobytes()
        and tuple(t.shape) == a.shape
        for t, a in zip(tblk, nblk))


@pytest.mark.parametrize("kind", DTYPES)
def test_block_crc_equals_jax(kind):
    nb = np_block(kind, 1)
    assert pools.block_crc(to_torch(nb)) == jpools.block_crc(nb)
    # a 1-D member and a transposed (non-contiguous) one render alike
    flat = tuple(a.reshape(-1) for a in nb)
    assert pools.block_crc(to_torch(flat)) == jpools.block_crc(flat)
    t = to_torch(nb)
    tt = (t[0].transpose(1, 2),) + t[1:]
    nt = (np.ascontiguousarray(nb[0].transpose(0, 2, 1, 3)),) + nb[1:]
    assert pools.block_crc(tt) == jpools.block_crc(nt)


@pytest.mark.parametrize("kind", DTYPES)
def test_g3_blob_crosses_packages_both_ways(kind, tmp_path):
    nb = np_block(kind, 2)
    jpool = jpools.DiskBlockPool(str(tmp_path / "jax"), 4)
    tpool = pools.DiskBlockPool(str(tmp_path / "torch"), 4)
    try:
        jpool.put(11, *nb)
        blk, crc = pools.read_block_file(jpool._path(11))
        pools.verify_block(blk, crc)
        assert crc == jpools.block_crc(nb) and same_bytes(blk, nb)
        tpool.put(12, *to_torch(nb))
        jblk, jcrc = jpools.read_block_file(tpool._path(12))
        jpools.verify_block(jblk, jcrc)
        assert jcrc == crc
        assert [a.dtype for a in jblk] == [a.dtype for a in nb]
        assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                   for a, b in zip(jblk, nb))
        # the files are byte for byte the same npz
        with open(jpool._path(11), "rb") as f1, \
                open(tpool._path(12), "rb") as f2:
            assert f1.read() == f2.read()
    finally:
        jpool.close()
        tpool.close()


@pytest.mark.parametrize("kind", DTYPES)
def test_shared_g4_directory_crosses_packages(kind, tmp_path):
    nb = np_block(kind, 3)
    jstore = jobject_store.ObjectStorePool(str(tmp_path))
    tstore = object_store.ObjectStorePool(str(tmp_path))
    h1, h2 = (1 << 127) | 5, (3 << 120) | 9
    assert jstore.put(h1, *nb)
    assert not tstore.put(h1, *to_torch(nb))  # same content, already there
    assert same_bytes(tstore.get(h1), nb)
    assert tstore.put(h2, *to_torch(nb))
    got = jstore.get(h2)
    assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
               for a, b in zip(got, nb))
    assert sorted(tstore.keys()) == sorted(jstore.keys()) == sorted([h1, h2])


def test_pools_reject_another_owner_and_keep_foreign_files(tmp_path):
    d = tmp_path / "g3"
    d.mkdir()
    (d / "notes.txt").write_text("keep")
    (d / ("ab" * 16 + ".npz")).write_bytes(b"stale")
    pool = pools.DiskBlockPool(str(d), 2)
    try:
        assert (d / "notes.txt").exists()
        assert not (d / ("ab" * 16 + ".npz")).exists()
        with pytest.raises(RuntimeError, match="owned by another engine"):
            pools.DiskBlockPool(str(d), 2)
    finally:
        pool.close()
    pools.DiskBlockPool(str(d), 2).close()  # released with the first


# ---------------------------------------------------------------------------
# the tiered managers
# ---------------------------------------------------------------------------


def _run_ops(mgr, blk_fn, tmp):
    """One fixed op sequence; returns (events, fetched blocks, stats,
    match runs, occupancy, manifest)."""
    events, fetched, runs = [], [], []
    for h in range(1, 9):  # G2 holds 2: the rest demote to G3 (cap 3)
        events.append(mgr.offload(h, *blk_fn(h)))  # and spill to G4
    runs.append(mgr.match_run([1, 2, 3, 4, 5, 6, 7, 8, 99]))
    runs.append(mgr.match_run([99, 1]))
    for h in (8, 6, 1, 99, 3):
        blk, ev, src = mgr.fetch(h)
        events.append(ev)
        fetched.append((src, blk))
    mgr.offload(2, *blk_fn(2))  # already held somewhere: a refresh
    events.append(mgr.clear())
    runs.append(mgr.match_run([1, 2, 3]))
    return (events, fetched, dict(mgr.stats), runs, mgr.occupancy(),
            mgr.manifest())


@pytest.mark.parametrize("kind", DTYPES)
def test_manager_sequence_equals_jax(kind, tmp_path):
    def make(cls, side):
        return cls(2, disk_dir=str(tmp_path / side / "g3"), disk_blocks=3,
                   object_dir=str(tmp_path / side / "g4"),
                   io_deadline_s=10.0)

    jm, tm = make(JaxManager, "jax"), make(TieredKvManager, "torch")
    try:
        jres = _run_ops(jm, lambda h: np_block(kind, h), tmp_path)
        tres = _run_ops(tm, lambda h: to_torch(np_block(kind, h)), tmp_path)
    finally:
        jm.close()
        tm.close()
    assert tres[0] == jres[0]  # tier events
    assert [s for s, _ in tres[1]] == [s for s, _ in jres[1]]
    for (_, tb), (_, jb) in zip(tres[1], jres[1]):
        assert (tb is None) == (jb is None)
        if tb is not None:
            assert same_bytes(tb, jb)
    assert tres[2:] == jres[2:]  # stats, runs, occupancy, manifest
    assert tres[2]["demoted"] and tres[2].get("g4_spilled")
    assert tres[2].get("g4_hits") and tres[2]["disk_hits"]


def _flip_first_byte(path):
    """Rewrite a G3 blob with one payload byte flipped and its true crc
    kept (a valid npz whose footer no longer matches: only the checksum
    can catch it)."""
    with np.load(path) as z:
        payload = {n: z[n] for n in z.files}
    payload["k"] = payload["k"].copy()
    payload["k"].reshape(-1)[0] ^= 0xFF
    np.savez(path, **payload)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_flipped_g3_byte_quarantines_like_jax(kind, tmp_path):
    out = []
    for cls, conv, side in ((JaxManager, lambda b: b, "jax"),
                            (TieredKvManager, to_torch, "torch")):
        mgr = cls(1, disk_dir=str(tmp_path / side), disk_blocks=4)
        try:
            seen = []
            mgr.on_corruption = lambda tier, h: seen.append((tier, h))
            mgr.offload(1, *conv(np_block(kind, 10)))
            mgr.offload(2, *conv(np_block(kind, 11)))  # 1 demotes to g3
            assert 1 in mgr.g3
            _flip_first_byte(mgr.g3._path(1))
            blk, events, src = mgr.fetch(1)
            out.append((blk, events, src, seen, dict(mgr.stats),
                        1 in mgr.g3, mgr.tier_states()))
            assert not (tmp_path / side / f"{1:032x}.npz").exists()
        finally:
            mgr.close()
    assert out[0] == out[1]
    blk, events, src, seen, stats, held, states = out[1]
    assert blk is None and src is None and not held
    assert ([], [1], "g3") in events and seen == [("g3", 1)]
    assert stats["g3_quarantined"] == 1 and states["g3"] == "closed"


def test_g4_corrupt_blob_quarantines_with_attribution(tmp_path):
    mgr = TieredKvManager(2, object_dir=str(tmp_path), io_deadline_s=10.0)
    try:
        seen = []
        mgr.on_corruption = lambda tier, h: seen.append((tier, h))
        blk = to_torch(np_block("bf16", 12))
        mgr.g4.put(0xBEEF, *blk)
        path = mgr.g4._path(0xBEEF)
        with np.load(path) as z:
            payload = {n: z[n] for n in z.files}
        payload["v"] = payload["v"].copy()
        payload["v"].reshape(-1)[-1] ^= 0x01
        with open(path, "wb") as f:
            np.savez(f, **payload)
        got, events, src = mgr.fetch(0xBEEF)
        assert got is None and src is None
        assert ([], [0xBEEF], "g4") in events
        assert seen == [("g4", 0xBEEF)]
        assert mgr.stats["g4_quarantined"] == 1
        assert mgr.tier_states()["g4"] == "closed"  # data, not the tier
        assert 0xBEEF not in mgr.g4
        mgr.g4.put(0xBEEF, *blk)  # a clean re-spill heals it
        got, _, src = mgr.fetch(0xBEEF)
        assert src == "g4" and all(torch.equal(a, b)
                                   for a, b in zip(got, blk))
    finally:
        mgr.close()


def test_consolidator_g4_removal_passes_through_like_jax():
    steps = [([], [7], "g4"), ([8], [], "g4"), ([8], [], "g4"),
             ([5], [], "g1"), ([5], [], "g2"), ([], [5], "g1"),
             ([5], [5], "g2"), ([], [5], "g2"), ([], [8], "g4"),
             ([], [8], "g4")]
    mine, ref = KvEventConsolidator(), JaxConsolidator()
    got = [mine.apply(*s) for s in steps]
    assert got == [ref.apply(*s) for s in steps]
    assert got[0] == ([], [7], "g4") and got[2] == ([], [], "g4")


def test_coldest_evictable_equals_jax():
    allocs = (BlockAllocator(12), JaxAllocator(12))
    for a in allocs:
        for i in range(4):
            r = a.allocate(f"s{i}", [], 2)
            for j in range(2):
                a.commit_block(f"s{i}", j, 100 * i + j + 1)
        a.free("s2")
        a.free("s0")
        a.free("s3")
        a.allocate("s5", [201, 202], 2)  # s2's prefix, pinned again
    for kw in (dict(n=3), dict(n=8, exclude={1, 302}),
               dict(n=8, scan_limit=2), dict(n=0)):
        assert allocs[0].coldest_evictable(**kw) == \
            allocs[1].coldest_evictable(**kw)
    assert [h for h, _ in allocs[0].coldest_evictable(8)] == [1, 2, 301, 302]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

_PARAMS = {}


def _params():
    """JaxEngine's weights (seed 7) and the port's tree of them."""
    if not _PARAMS:
        je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, **eng_kwargs()))
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      je.params)
        _PARAMS["jax"] = je.params
        _PARAMS["torch"] = params_from_numpy(tree, FP32, device="cpu")
    return _PARAMS["jax"], _PARAMS["torch"]


def _req(jax_side, tokens, n, rid):
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


PROMPT_A = list(range(1, 13))  # 3 full blocks


async def _scenario(eng, jax_side, churn):
    """Prompt A, the churn prompts that push A's blocks out of G1, A
    again: (first stream, repeat stream, repeat's prefill tokens)."""
    out1 = await _collect(eng, _req(jax_side, PROMPT_A, 4, "a1"))
    for i, p in enumerate(churn):
        await _collect(eng, _req(jax_side, p, 2, f"churn{i}"))
    pre = eng.metrics["prefill_tokens"]
    out2 = await _collect(eng, _req(jax_side, PROMPT_A, 4, "a2"))
    return out1, out2, eng.metrics["prefill_tokens"] - pre


SCENARIOS = {
    # tests/test_kvbm.py test_offload_onboard_instead_of_recompute
    "g2": (dict(host_cache_blocks=64, offload_watermark_blocks=16),
           [[50 + 7 * i + j for j in range(12)] for i in range(6)]),
    # tests/test_kvbm.py test_disk_tier_survives_host_pressure
    "g3": (dict(host_cache_blocks=2, offload_watermark_blocks=16,
                disk_cache_blocks=32),
           [[60 + 5 * i + j for j in range(12)] for i in range(6)]),
    # the same pressure with the shared object store under G2
    "g4": (dict(host_cache_blocks=2, offload_watermark_blocks=16),
           [[60 + 5 * i + j for j in range(12)] for i in range(6)]),
}


@pytest.mark.parametrize("cache", ["fp32", "int8"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
async def test_engine_tiers_equal_jax_engine(scenario, cache, tmp_path):
    kv, churn = SCENARIOS[scenario]
    jparams, tparams = _params()
    res = {}
    for side in ("jax", "torch"):
        kw = dict(kv)
        if scenario == "g3":
            kw["disk_cache_dir"] = str(tmp_path / side / "g3")
        if scenario == "g4":
            kw["object_store_dir"] = str(tmp_path / side / "g4")
        kw["kv_cache_dtype"] = "int8" if cache == "int8" else "bf16"
        events = []

        def sink(stored, removed, tier="g1", into=events):
            into.append((list(stored), list(removed), tier))

        if side == "jax":
            eng = JaxEngine(JaxEngineConfig(model_config=JAX_FP32,
                                            **eng_kwargs(**kw)),
                            params=jparams, kv_event_sink=sink)
        else:
            eng = TorchEngine(EngineConfig(model_config=FP32,
                                           **eng_kwargs(**kw)),
                              params=tparams, device="cpu",
                              kv_event_sink=sink)
        try:
            out = await _scenario(eng, side == "jax", churn)
            await asyncio.sleep(0.05)  # the sink runs on the loop thread
            occupancy = eng.kv_occupancy()
        finally:
            await eng.close()
        m = eng.metrics
        res[side] = dict(
            streams=out[:2], prefill_delta=out[2], events=events,
            occupancy=occupancy,
            stats=dict(eng.kvbm.stats),
            onboarded=m.get("onboarded_tokens", 0),
            by_tier={t: m.get(f"kv_onboard_{t}", 0)
                     for t in ("g2", "g3", "g4")})
    t, j = res["torch"], res["jax"]
    assert t["streams"][0] == t["streams"][1] == j["streams"][0] \
        == j["streams"][1]
    assert t == j
    # the repeat's prefix came back from the tier, not from a recompute
    assert t["onboarded"] >= 8 and t["prefill_delta"] <= 8
    assert t["by_tier"][scenario] > 0
    assert {tier for *_, tier in t["events"]} >= {"g1", "g2", scenario}
    seen = set()  # every net removal follows a store of the same tier
    for stored, removed, tier in t["events"]:
        for h in removed:
            assert (h, tier) in seen
            seen.discard((h, tier))
        seen.update((h, tier) for h in stored)


async def test_engine_g4_sweep_publishes_removals(tmp_path):
    """sweep_kvbm_g4 reaps the shared store's expired blobs (no ledger:
    the TTL decides) and publishes removed(g4) for them, so a later
    re-spill emits stored(g4) again."""
    kv, churn = SCENARIOS["g4"]
    events = []
    eng = TorchEngine(EngineConfig(model_config=FP32, **eng_kwargs(
        object_store_dir=str(tmp_path), object_store_ttl_s=0.0, **kv)),
        params=_params()[1], device="cpu",
        kv_event_sink=lambda s, r, t: events.append((s, r, t)))
    try:
        await _scenario(eng, False, churn)
        spilled = set(eng.kvbm.g4.keys())
        assert spilled and eng.kv_occupancy()["g4"]["used"] == len(spilled)
        await asyncio.sleep(0.01)  # every blob older than the 0 s TTL
        assert await eng.sweep_kvbm_g4() == len(spilled)
        await asyncio.sleep(0.05)
        removed = {h for _, r, t in events if t == "g4" for h in r}
        assert removed == spilled and not list(eng.kvbm.g4.keys())
        assert await eng.sweep_kvbm_g4() == 0
    finally:
        await eng.close()


def test_engine_kvbm_config_errors_equal_jax(tmp_path):
    cases = [dict(disk_cache_dir=str(tmp_path / "a"), disk_cache_blocks=4),
             dict(host_cache_blocks=4, disk_cache_dir=str(tmp_path / "b")),
             dict(object_store_dir=str(tmp_path / "c"))]
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            JaxEngine(JaxEngineConfig(model_config=JAX_FP32,
                                      **eng_kwargs(**kw)))
        with pytest.raises(ValueError) as terr:
            TorchEngine(EngineConfig(model_config=FP32, **eng_kwargs(**kw)),
                        params=_params()[1], device="cpu")
        assert str(terr.value) == str(jerr.value)
    assert sorted(_UNPORTED) == sorted(["dp", "tp", "sp"])


def test_engine_cli_kvbm_flags_equal_jax(monkeypatch):
    from dynamo_tpu.engine.__main__ import build_args as jax_args
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    names = ("host_cache_blocks", "offload_watermark_blocks",
             "disk_cache_dir", "disk_cache_blocks", "object_store_dir",
             "kv_io_deadline_s", "kv_breaker_threshold",
             "kv_breaker_cooldown_s", "no_kvbm_remote")
    monkeypatch.setenv("DYN_KVBM_OBJECT_DIR", "/shared/g4")
    for argv in ([], ["--host-cache-blocks", "96",
                      "--offload-watermark-blocks", "64",
                      "--disk-cache-dir", "/d", "--disk-cache-blocks", "8",
                      "--object-store-dir", "/o", "--kv-io-deadline-s",
                      "0.5", "--kv-breaker-threshold", "5",
                      "--kv-breaker-cooldown-s", "9", "--no-kvbm-remote"]):
        args, jargs = build_args().parse_args(argv), jax_args().parse_args(
            argv)
        assert [getattr(args, n) for n in names] == \
            [getattr(jargs, n) for n in names]
    assert jargs.object_store_dir == "/o"
    cfg = engine_config(args)
    assert (cfg.host_cache_blocks, cfg.offload_watermark_blocks,
            cfg.disk_cache_dir, cfg.disk_cache_blocks, cfg.object_store_dir,
            cfg.kv_io_deadline_s, cfg.kv_breaker_threshold,
            cfg.kv_breaker_cooldown_s, cfg.kvbm_remote) == (
                96, 64, "/d", 8, "/o", 0.5, 5, 9.0, False)
    assert engine_config(build_args().parse_args([])).object_store_dir \
        == "/shared/g4"

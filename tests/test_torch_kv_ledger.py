"""The port's KV ledger and its auditor against the JAX package's (CPU).

* The same operation sequences through JAX's BlockAllocator + KvLedger
  and the port's (allocate with prefix hits, commit, append, trim,
  free to the cache, eviction, clear, park/unpark, onboard, tier
  batches, corruption) give equal dumps, attributions and violation
  totals; each seeded fault (leak, orphan, double free, refcount drift,
  corrupt), made by mutating the books directly as JAX's fault seam
  does, gets the same verdict on both sides.  The KVBM manifest audit,
  the on/off gate, MergedLedgers and LineageResidency's verdicts equal
  JAX's.
* TorchEngine and JaxEngine serve the same requests with the ledger on
  (prefix reuse, eviction, a cache clear, preemption, speculative
  rollback, a parked disagg prefill): zero violations and equal
  attribution on both sides, and equal `metrics["forensic"]` stamps on
  exactly the first-token and finish frames.  With prefill_packed=False
  the port prefills on the padded programs and its greedy streams equal
  JaxEngine's.
* Workers: a torch worker's /debug/kv has the JAX worker's keys and
  schema, the JAX fleet tools read it, its gauges and MDC fields equal
  the JAX worker's, the CLI's new flags parse as JAX's, a JAX
  RequestTracker records the torch worker's `worker_stamp` hop, and a
  reasoning parser on its card makes the JAX frontend split <think>.
"""

import asyncio
import json
import time
import uuid

import aiohttp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.engine.block_allocator import BlockAllocator as JaxAllocator
from dynamo_tpu.kvbm.manager import TieredKvManager as JaxKvbm
from dynamo_tpu.kvbm.residency import LineageResidency as JaxResidency
from dynamo_tpu.obs import kv_ledger as jax_ledger
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.block_allocator import BlockAllocator
from dynamo_tpu_torch.kvbm.manager import TieredKvManager
from dynamo_tpu_torch.kvbm.residency import LineageResidency
from dynamo_tpu_torch.obs import kv_ledger
from dynamo_tpu_torch.protocols import DISAGG_ANNOTATION
from test_torch_overlap import (
    COMMON,
    FP32,
    JAX_FP32,
    SHAPES,
    _collect,
    _params,
    _req,
    jax_engine,
    torch_engine,
)
from test_torch_worker import _idle

pytestmark = pytest.mark.allow_slow_callbacks

H = lambda i: (0xABC0000 + i) << 64  # noqa: E731  128-bit PLH stand-ins

SIDES = {"jax": (JaxAllocator, jax_ledger.KvLedger),
         "torch": (BlockAllocator, kv_ledger.KvLedger)}


def _norm_dump(d: dict) -> dict:
    """A dump without its clock readings (event ages, audit time)."""
    d = json.loads(json.dumps(d))
    for e in d["events_tail"]:
        e.pop("age_s")
    if d.get("last_audit"):
        d["last_audit"].pop("ts_unix")
    return d


# ---------------------------------------------------------------------------
# the ledger and the allocator, op by op
# ---------------------------------------------------------------------------


def _lifecycle(alloc_cls, ledger_cls, fault: str):
    """A G1 lifecycle through allocator + ledger, then `fault` seeded by
    mutating the books directly; returns what both sides must agree on."""
    led = ledger_cls()
    a = alloc_cls(12, ledger=led)
    audits = []

    def audit(live, parked=(), where="t"):
        v = led.audit_allocator(a, live, parked)
        audits.append(led.finish_audit(v, where=where)["violations"])

    led.bind_seq("s1", "trace-1")
    a.allocate("s1", [H(1), H(2)], 3)
    a.commit_block("s1", 0, H(1))
    a.commit_block("s1", 1, H(2))
    a.append_block("s1")
    audit(["s1"])
    a.trim_blocks("s1", 3)  # the spec rollback's trim
    a.free("s1")
    audit([])
    # a prefix hit pins the cached blocks; a capacity miss rolls back
    a.allocate("s2", [H(1), H(2), H(3)], 4)
    a.commit_block("s2", 2, H(3))
    assert a.allocate("big", [H(1)], 40) is None
    led.park("s2")
    audit([], parked=["s2"])
    led.unpark("s2")
    a.free("s2")
    led.onboard(H(2), "g2", seq="s3")
    led.tier_batch([H(7), H(8)], [], "g2")
    led.tier_batch([H(9)], [H(7)], "g3")
    led.tier_batch([H(10)], [], "g4")
    # fresh allocations evict the LRU-coldest cached blocks
    a.allocate("s3", [], 9)
    audit(["s3"])
    a.free("s3")
    a.allocate("s4", [], 3)
    a.commit_block("s4", 0, H(20))
    if fault == "leak":
        # "forget" the trailing block: free never releases it
        # dynlint: disable=DYN013 seeding the fault the auditor must catch
        a._seq_blocks["s4"].pop()
    elif fault == "orphan":
        # release behind the ledger's back: the books point at a ghost
        # dynlint: disable=DYN013 seeding the fault the auditor must catch
        bid = a._seq_blocks["s4"].pop()
        # dynlint: disable=DYN013 seeding the fault the auditor must catch
        a._block_ref.pop(bid)
        # dynlint: disable=DYN013 seeding the fault the auditor must catch
        a._free.append(bid)
    elif fault == "refcount_drift":
        # dynlint: disable=DYN013 seeding the fault the auditor must catch
        a._block_ref[a._seq_blocks["s4"][0]] += 1
    if fault != "double_free":
        a.free("s4")
    else:
        a.free("s4")
        # a freed id back on the free list a second time
        # dynlint: disable=DYN013 seeding the fault the auditor must catch
        a._free.append(a._free[-1])
    if fault == "corrupt":
        led.corruption("g3", H(9))
    audit([])
    removed = a.clear_cached()
    audit([], where="clear")
    return {"dump": _norm_dump(led.dump(tail=4096)),
            "attribution": led.attribution(),
            "violations": led.violations_by_kind(),
            "audits": audits, "removed": removed,
            "onboards": led.onboard_counts(),
            "resident": sorted(led.resident_hashes())}


FAULTS = {"clean": None, "leak": "leak", "orphan": "orphan",
          "double_free": "double-free", "refcount_drift": "refcount-drift",
          "corrupt": "corrupt"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_ledger_books_and_auditor_verdicts_equal_jax(fault):
    got = {side: _lifecycle(*SIDES[side], fault) for side in SIDES}
    assert got["torch"] == got["jax"]
    verdict = got["torch"]["violations"]
    if FAULTS[fault] is None:
        assert verdict == {} and not any(got["torch"]["audits"])
    else:
        assert FAULTS[fault] in verdict, verdict
    ops = {e["op"] for e in got["torch"]["dump"]["events_tail"]}
    assert {"alloc", "pin", "unpin", "cache", "commit", "evict", "release",
            "park", "unpark", "stage", "tier_evict", "onboard"} <= ops
    assert got["torch"]["dump"]["schema"] == "dynamo.kv_ledger.v1"


def test_ledger_constants_gate_and_merge_equal_jax(monkeypatch):
    assert kv_ledger.LEDGER_OPS == jax_ledger.LEDGER_OPS
    assert kv_ledger.VIOLATION_KINDS == jax_ledger.VIOLATION_KINDS
    assert kv_ledger.DEFAULT_RING == jax_ledger.DEFAULT_RING
    assert kv_ledger.LINEAGE_CAP == jax_ledger.LINEAGE_CAP
    for env in (None, "0", "1", "false", "off", "no", "yes"):
        if env is None:
            monkeypatch.delenv("DYN_KV_LEDGER", raising=False)
        else:
            monkeypatch.setenv("DYN_KV_LEDGER", env)
        for override in (None, True, False):
            assert kv_ledger.ledger_enabled(override) \
                == jax_ledger.ledger_enabled(override)
    monkeypatch.setenv("DYN_KV_LEDGER_RING", "100")
    assert kv_ledger.KvLedger().events.maxlen \
        == jax_ledger.KvLedger().events.maxlen == 100
    merged = {}
    for side, mod in (("jax", jax_ledger), ("torch", kv_ledger)):
        leds = []
        for n in (2, 3):
            led = mod.KvLedger()
            a = SIDES[side][0](8, ledger=led)
            a.allocate("s", [H(1)], n)
            a.commit_block("s", 0, H(1))
            led.onboard(H(1), "g2")
            led.corruption("g3", H(5))
            leds.append(led)
        m = mod.MergedLedgers([None, *leds])
        merged[side] = (bool(m), m.attribution(), m.violations_by_kind(),
                        m.onboard_counts())
    assert merged["torch"] == merged["jax"]
    assert not kv_ledger.MergedLedgers([None])


@pytest.mark.parametrize("g3", [False, True])
def test_kvbm_manifest_audit_equals_jax(tmp_path, g3):
    """Tier books against the pool manifests: staged and demoted blocks
    reconcile clean; a pool mutation behind the ledger is an orphan
    (ledger only) or a leak (pool only), on both sides alike."""
    out = {}
    for side, mgr_cls, mk in (
            ("jax", JaxKvbm, lambda: np.zeros((1, 2, 1, 4), np.float32)),
            ("torch", TieredKvManager,
             lambda: torch.zeros((1, 2, 1, 4), dtype=torch.float32))):
        led = SIDES[side][1]()
        kw = (dict(disk_dir=str(tmp_path / side), disk_blocks=3) if g3
              else {})
        mgr = mgr_cls(2, **kw)
        k = mk()
        verdicts = []

        def feed(batches, led=led):
            for stored, removed, tier in batches:
                led.tier_batch(stored, removed, tier)

        for i in range(6):
            feed(mgr.offload(H(i), k, k))
            verdicts.append(led.audit_kvbm(mgr))
        mgr.g2.drop(mgr.g2.keys()[0])
        verdicts.append(led.audit_kvbm(mgr))
        mgr.g2.put(H(40), k, k)
        verdicts.append(led.audit_kvbm(mgr))
        out[side] = (verdicts, led.attribution(),
                     {t: sorted(s) for t, s in mgr.manifest().items()})
        mgr.close()
    assert out["torch"] == out["jax"]
    kinds = [sorted({v["kind"] for v in vs}) for vs in out["torch"][0]]
    assert kinds[:6] == [[]] * 6 and kinds[6] == ["orphan"]
    assert kinds[7] == ["leak", "orphan"]


def test_lineage_residency_verdicts_equal_jax():
    """The G4 residency policy read off each side's ledger: hot within
    the window, then root / live parent -> TTL, parent gone -> dead,
    parent in the shared store -> TTL, unknown -> TTL."""
    class Store:  # a parent alive only in the shared store
        def __contains__(self, h):
            return h == H(999)

    got = {}
    for side, res_cls in (("jax", JaxResidency), ("torch", LineageResidency)):
        led = SIDES[side][1]()
        a = SIDES[side][0](8, ledger=led)
        a.allocate("s", [], 3)
        a.commit_block("s", 0, H(101))
        a.commit_block("s", 1, H(102))
        led.commit(99, H(103), parent=H(999), seq="s")
        led.commit(98, H(104), parent=H(998), seq="s")
        led.tier_batch([H(105)], [], "g4")
        hashes = [H(i) for i in (101, 102, 103, 104, 105, 555)]
        later = time.monotonic() + 1000.0
        got[side] = (
            [res_cls(led)(h) for h in hashes],
            [res_cls(led, now=later)(h) for h in hashes],
            [res_cls(led, pool=Store(), now=later)(h) for h in hashes],
            res_cls(led, now=later).verdicts(hashes),
            [res_cls(None)(h) for h in hashes])
    assert got["torch"] == got["jax"]
    assert got["torch"][1][3] == "dead" and got["torch"][2][2] is None


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


async def _stamped(eng, jax_side, tokens, rid, n, annotations=()):
    """(tokens, [(frame index, forensic stamp)], frame count)."""
    req = _req(jax_side, tokens, rid, n)
    req.annotations = list(annotations)
    toks, stamps, i = [], [], 0
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        toks.extend(out.token_ids)
        if out.metrics and "forensic" in out.metrics:
            stamps.append((i, dict(out.metrics["forensic"])))
        i += 1
    return toks, stamps, i


async def _sequential(eng, jax_side):
    """One request at a time, each once the engine is idle: a cold
    prompt, its prefix hit, prompts that evict cached blocks, a cache
    clear, the first prompt again."""
    base = list(range(30, 50))
    out = []
    for tokens, rid, n in ((base, "a", 6), (base + [7, 7, 7], "b", 5),
                           (list(range(100, 128)), "c", 4),
                           (list(range(60, 80)), "d", 3)):
        await _idle(eng)
        out.append(await _stamped(eng, jax_side, tokens, rid, n))
    await _idle(eng)
    await eng.clear_kv_blocks()
    out.append(await _stamped(eng, jax_side, base, "e", 2))
    await _idle(eng)
    return out


async def _books(eng) -> tuple:
    report = await eng.audit_kv()
    assert report["clean"], report
    return eng.kv_ledger.attribution(), eng.kv_ledger.violations_by_kind()


@pytest.mark.parametrize("mode", ["lockstep", "overlap"])
async def test_engine_books_and_forensic_stamps_equal_jax(mode):
    kw = dict(num_blocks=12)
    if mode == "lockstep":
        kw.update(overlap_scheduling=False, decode_fused_steps=1)
    got = {}
    for side, make in (("jax", jax_engine), ("torch", torch_engine)):
        eng = make(**kw)
        try:
            assert eng.kv_ledger is not None
            assert eng.allocator.ledger is eng.kv_ledger
            streams = await _sequential(eng, side == "jax")
            # the finish cadence swept on its own
            assert eng.kv_ledger.last_audit is not None
            got[side] = (streams, await _books(eng))
        finally:
            await eng.close()
    assert got["torch"] == got["jax"]
    for toks, stamps, frames in got["torch"][0]:
        # the stamp rides exactly the first-token and the finish frame
        assert [i for i, _ in stamps] == [0, frames - 1]
        assert stamps[-1][1]["generated"] == len(toks)
    # the prefix hit's realized reuse (5 cached blocks of 4)
    _, b_stamps, _ = got["torch"][0][1]
    assert b_stamps[0][1]["cached_tokens"] == 20
    assert got["torch"][1][0]["g1"]["prefix_cached"] > 0


async def test_engine_preemption_and_queue_positions_equal_jax():
    """Three sequences outgrow 11 usable blocks: preemption frees and
    replays; every request arrives at once, so the stamps carry the
    waiting-queue positions.  Books clean and equal on both sides."""
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
               [14, 14, 2, 7, 7, 1, 0, 9, 9, 4]]
    got = {}
    for side, make in (("jax", jax_engine), ("torch", torch_engine)):
        eng = make(num_blocks=12)
        try:
            res = await asyncio.gather(*[
                _stamped(eng, side == "jax", p, f"p{i}", 10)
                for i, p in enumerate(prompts)])
            await _idle(eng)
            assert eng.metrics["preemptions"] > 0
            got[side] = (res, await _books(eng))
        finally:
            await eng.close()
    assert got["torch"] == got["jax"]
    assert [s[0][1]["queue_pos"] for _, s, _ in got["torch"][0]] \
        == [0, 1, 2]


async def test_engine_spec_rollback_books_equal_jax():
    """N-gram speculation grows blocks for drafts and trims the rejected
    tail each round: the trims are ledgered, the books stay clean and
    equal JAX's."""
    prompt = [5, 6, 7, 8] * 6
    got = {}
    for side, make in (("jax", jax_engine), ("torch", torch_engine)):
        eng = make(spec_decode="ngram", spec_k=4, overlap_scheduling=False,
                   decode_fused_steps=1)
        try:
            res = await _stamped(eng, side == "jax", prompt, "spec", 40)
            await _idle(eng)
            assert eng.metrics.get("spec_steps", 0) > 0
            got[side] = (res, await _books(eng),
                         eng.kv_ledger.dump(tail=0)["counts"])
        finally:
            await eng.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][2]["release"] > 0


async def test_engine_parked_prefill_books_equal_jax():
    """A disagg prefill hop parks its blocks (pinned by the transfer)
    and stamps its one frame; releasing them returns the blocks to the
    prefix cache, on both sides alike."""
    got = {}
    for side, make in (("jax", jax_engine), ("torch", torch_engine)):
        eng = make(role="prefill", overlap_scheduling=False,
                   decode_fused_steps=1)
        try:
            res = await _stamped(eng, side == "jax", list(range(30, 44)),
                                 "park1", 4, annotations=[DISAGG_ANNOTATION])
            parked = await _books(eng)
            await eng.release_parked("park1")
            got[side] = (res, parked, await _books(eng))
        finally:
            await eng.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][1][0]["g1"]["pinned_by_transfer"] > 0
    assert got["torch"][2][0]["g1"]["pinned_by_transfer"] == 0
    assert len(got["torch"][0][1]) == 1  # the one frame is stamped


@pytest.mark.parametrize("ledger", [False, True])
async def test_ledger_off_is_none_and_serves_alike(ledger, monkeypatch):
    monkeypatch.setenv("DYN_KV_LEDGER", "0" if ledger else "1")
    eng = torch_engine(kv_ledger=ledger)
    try:
        assert (eng.kv_ledger is not None) == ledger
        assert eng.allocator.ledger is eng.kv_ledger
        toks = await _collect(eng, _req(False, list(range(10)), "r1", 4))
        assert len(toks) == 4
        assert (await eng.audit_kv() != {}) == ledger
    finally:
        await eng.close()


async def test_unpacked_prefill_streams_equal_jax():
    """prefill_packed=False: a dense model prefills on the padded
    programs (one slot: `prefill`; several: `prefill_batched`), and its
    greedy streams equal the JaxEngine's with the same setting and the
    port's packed ones."""
    prompts = [list(range(7, 60)), list(range(40, 49)), list(range(7, 15)),
               [3, 1, 4, 1, 5, 9, 2, 6] * 5]

    async def run(eng, jax_side):
        try:
            return await asyncio.gather(*[
                _collect(eng, _req(jax_side, p, f"u{i}", 12))
                for i, p in enumerate(prompts)])
        finally:
            await eng.close()

    te = torch_engine(prefill_packed=False, prefill_chunk_tokens=32)
    assert not te._packed_prefill_ok and te.padded_prefill is not None
    got = await run(te, False)
    recs = [r for r in te.fpm if r["kind"] == "prefill"]
    assert recs and not any(r["packed"] for r in recs)
    assert te.padded_prefill.counts  # the padded shapes ran
    assert got == await run(jax_engine(prefill_packed=False,
                                       prefill_chunk_tokens=32), True)
    assert got == await run(torch_engine(prefill_chunk_tokens=32), False)


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


async def _worker_pair(jrt, prt, **kw):
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.models.convert import params_from_numpy

    tok = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    cfg = {**COMMON, **kw}
    jw = JaxEngineWorker(jrt, JaxEngineConfig(model_config=JAX_FP32, **cfg),
                         tokenizer_cfg=tok)
    tw = TorchEngineWorker(prt, EngineConfig(model_config=FP32, **cfg),
                           tokenizer_cfg=tok,
                           params=params_from_numpy(_params(), FP32,
                                                    device="cpu"),
                           device="cpu")
    return jw, tw


async def test_debug_kv_and_ledger_gauges_equal_jax_worker(tmp_path):
    from dynamo_tpu.obs.fleet import reduce_kv_ledgers
    from dynamo_tpu.obs.report import kv_accounting, kv_ledger_docs
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from test_torch_system_status import AUTH, TOKEN, _get

    kw = dict(discovery_backend="mem", event_plane="inproc",
              system_port=-1, admin_token=TOKEN)
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**kw),
                           cluster_id=uuid.uuid4().hex).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**kw),
                                   cluster_id=uuid.uuid4().hex).start()
    g4 = dict(host_cache_blocks=4, object_store_dir=str(tmp_path))
    jw, tw = await _worker_pair(jrt, prt, **g4)
    try:
        await jw.start()
        await tw.start()
        for w, side in ((jw, True), (tw, False)):
            for i, p in enumerate((list(range(30, 50)),
                                   list(range(30, 50)) + [1, 2])):
                await _collect(w.engine, _req(side, p, f"k{i}", 4))
        docs = {}
        async with aiohttp.ClientSession() as s:
            for name, rt, w in (("jax", jrt, jw), ("torch", prt, tw)):
                st, _, _ = await _get(s, rt, "/debug/kv")
                assert st == 401
                st, _, body = await _get(s, rt, "/debug/kv", headers=AUTH)
                assert st == 200
                state = json.loads(body)
                docs[name] = state
                src = state["sources"][f"kv:{w.served.instance_id}"]
                assert src["schema"] == "dynamo.kv_ledger.v1"
                assert src["enabled"] is True and src["audit"]["clean"]
        tsrc = next(iter(docs["torch"]["sources"].values()))
        jsrc = next(iter(docs["jax"]["sources"].values()))
        assert set(tsrc) == set(jsrc)
        assert set(tsrc["attribution"]["g1"]) == set(jsrc["attribution"]["g1"])
        assert set(tsrc["g4"]) == set(jsrc["g4"])
        assert set(tsrc["g4"]["residency"]) == {"hot", "dead", "ttl"}
        # the JAX report and fleet tools read the port's dump
        for name in ("jax", "torch"):
            found = kv_ledger_docs(docs[name])
            assert found and kv_accounting(found)["reconciled_clean"]
        roll = reduce_kv_ledgers([tsrc, jsrc])
        assert roll["violations_total"] == 0
        assert roll["occupancy"]["g1"]["prefix_cached"] > 0
        # the ledger's gauge families on /metrics, as the JAX worker's
        await asyncio.sleep(1.2)  # two load-loop ticks
        fams = []
        for rt in (jrt, prt):
            text = rt.metrics.render().decode()
            fams.append({ln.split("{")[0] for ln in text.splitlines()
                         if ln.startswith(("dynamo_kv_ledger",
                                           "dynamo_engine_kv_onboard"))})
        assert fams[0] == fams[1] and "dynamo_kv_ledger_blocks" in fams[1]
    finally:
        await tw.close()
        await jw.close()
        assert not prt.kv_sources  # close() unregisters
        await prt.shutdown()
        await jrt.shutdown()


def test_mdc_fields_and_cli_flags_equal_jax():
    from dynamo_tpu.engine.__main__ import build_args as jax_args
    from dynamo_tpu.engine.worker import JaxEngineWorker
    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    for over in ({}, {"prefill_packed": False},
                 {"reasoning_parser": "deepseek_r1"}):
        want = JaxEngineWorker(None, JaxEngineConfig(
            model_config=JAX_FP32, **COMMON, **over)).card.runtime_config
        got = TorchEngineWorker(None, EngineConfig(
            model_config=FP32, **COMMON, **over)).card.runtime_config
        for key in ("prefill_packed", "reasoning_parser"):
            assert got.get(key, "absent") == want.get(key, "absent")
    names = ("no_packed_prefill", "reasoning_parser", "slo_yield_burn")
    for argv in ([], ["--no-packed-prefill", "--reasoning-parser",
                      "deepseek_r1", "--slo-yield-burn", "2.5"]):
        j = jax_args().parse_args(argv)
        t = build_args().parse_args(argv)
        assert {n: getattr(t, n) for n in names} \
            == {n: getattr(j, n) for n in names}
        cfg = engine_config(t)
        assert (cfg.prefill_packed, cfg.reasoning_parser,
                cfg.slo_yield_burn) == (not j.no_packed_prefill,
                                        j.reasoning_parser,
                                        j.slo_yield_burn)
    jd, td = JaxEngineConfig(), EngineConfig()
    for f in ("kv_ledger", "prefill_packed", "reasoning_parser",
              "slo_yield_burn"):
        assert getattr(td, f) == getattr(jd, f)
    for f in ("tp", "dp", "sp"):
        assert getattr(EngineConfig(**{f: 2}), f) == 2
    with pytest.raises(ValueError, match=">= 1"):
        EngineConfig(sp=0)


async def test_jax_tracker_and_reasoning_parser_over_a_torch_worker(tmp_path):
    """The JAX frontend's dispatch operator feeds its RequestTracker the
    torch worker's stamps (the `worker_stamp` hop); a reasoning parser
    named on the torch worker's card makes the JAX HTTP frontend split
    the output into reasoning_content."""
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.frontend.pipeline import MigrationOperator
    from dynamo_tpu.frontend.request_trace import RequestTracker
    from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols import StopConditions as JaxStop
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.models.convert import params_from_numpy
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="inproc")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    tok = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    workers = []
    for name, parser in (("m-think", "deepseek_r1"), ("m-plain", "")):
        workers.append(TorchEngineWorker(
            prt, EngineConfig(model_config=FP32, model_name=name,
                              reasoning_parser=parser, **COMMON),
            component=name, tokenizer_cfg=tok,
            params=params_from_numpy(_params(), FP32, device="cpu"),
            device="cpu"))
    manager = ModelManager()
    watcher = service = client = None
    try:
        for w in workers:
            await w.start()
        client = await jrt.namespace("dynamo").component("m-plain") \
            .endpoint("generate").client().start()
        await client.wait_for_instances()
        op = MigrationOperator(client, migration_limit=0)
        tr = RequestTracker(request_id="fx", model="m-plain")
        req = JaxRequest(token_ids=list(range(30, 50)), request_id="fx",
                         stop=JaxStop(max_tokens=5, ignore_eos=True))
        async for _ in op.generate(req, tracker=tr):
            pass
        rec = tr.finish(finish_reason="length")
        hops = [h for h in rec["timeline"]["hops"]
                if h["hop"] == "worker_stamp"]
        assert len(hops) == 2  # the first-token and the finish frame
        assert hops[-1]["generated"] == 5 and hops[-1]["queue_pos"] == 0
        assert tr.worker_stamp["prefill_chunks"] >= 1

        watcher = await ModelWatcher(jrt, manager).start()
        service = await HttpService(jrt, manager, host="127.0.0.1",
                                    port=0).start()
        url = f"http://127.0.0.1:{service._runner.addresses[0][1]}"
        t0 = time.monotonic()
        while not (manager.get("m-think") and manager.get("m-plain")):
            assert time.monotonic() - t0 < 20, "models never appeared"
            await asyncio.sleep(0.05)
        out = {}
        async with aiohttp.ClientSession() as s:
            for model in ("m-think", "m-plain"):
                body = {"model": model, "max_tokens": 6,
                        "temperature": 0.0, "ignore_eos": True,
                        "messages": [{"role": "user", "content": "hi"}]}
                async with s.post(f"{url}/v1/chat/completions",
                                  json=body) as r:
                    assert r.status == 200, await r.text()
                    out[model] = (await r.json())["choices"][0]["message"]
        # deepseek_r1 starts inside the reasoning span: with no </think>
        # in the output, all of it is reasoning; the plain card has none
        assert out["m-think"].get("reasoning_content")
        assert not out["m-think"].get("content")
        assert out["m-plain"]["content"] \
            and not out["m-plain"].get("reasoning_content")
        assert out["m-think"]["reasoning_content"] == out["m-plain"]["content"]
    finally:
        if service is not None:
            await service.close()
        if watcher is not None:
            await watcher.close()
        if client is not None:
            await client.close()
        for w in workers:
            await w.close()
        await prt.shutdown()
        await jrt.shutdown()

"""The port's KV router and push router against the JAX package's (CPU).

* Units, seeded: `PyKvIndexer`, `TieredKvIndexer`, `DefaultWorkerSelector`
  (one `seed`), `ActiveSequences`, `target_id`/`TargetMap`,
  `rendezvous_ranking`/`LoraReplicaSelector` and `PushRouter` in every
  mode give the JAX copies' answers on the same event sequences, loads
  and requests; `Client.generate(avoid=)` skips the avoided instances as
  JAX's does; `KvRouter.pick` makes the same decisions, with the same
  decision records, on the same events and loads.
* End to end on the port's runtime: gap recovery through
  `kv_events_replay`, a late router's full replay, snapshot-on-subscribe,
  two router replicas converging, and two tiny CPU workers behind the
  port's frontend, where a request sharing a prefix goes to the warm
  worker and a cold one goes by load.
"""

import asyncio
import random
import uuid

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.lora.routing import LoraReplicaSelector as JaxLoraSelector
from dynamo_tpu.lora.routing import rendezvous_ranking as jax_ranking
from dynamo_tpu.router.indexer import PyKvIndexer as JaxPyIndexer
from dynamo_tpu.router.selector import DefaultWorkerSelector as JaxSelector
from dynamo_tpu.router.selector import KvRouterConfig as JaxRouterConfig
from dynamo_tpu.router.selector import WorkerState as JaxWorkerState
from dynamo_tpu.router.sequences import ActiveSequences as JaxSequences
from dynamo_tpu.router.targets import TargetMap as JaxTargetMap
from dynamo_tpu.router.targets import target_id as jax_target_id
from dynamo_tpu.router.tiered_index import TieredKvIndexer as JaxTiered
from dynamo_tpu.runtime.push_router import PushRouter as JaxPushRouter
from dynamo_tpu.runtime.push_router import RouterMode as JaxRouterMode
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.lora.routing import LoraReplicaSelector, rendezvous_ranking
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.router.events import KvEventPublisher
from dynamo_tpu_torch.router.indexer import (
    PyKvIndexer,
    indexer_impl,
    make_indexer,
)
from dynamo_tpu_torch.router.kv_router import KvRouter
from dynamo_tpu_torch.router.selector import (
    DefaultWorkerSelector,
    KvRouterConfig,
    WorkerState,
)
from dynamo_tpu_torch.router.sequences import ActiveSequences
from dynamo_tpu_torch.router.targets import TargetMap, target_id
from dynamo_tpu_torch.router.tiered_index import TieredKvIndexer
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    Instance,
    RouterMode,
    RuntimeConfig,
)
from dynamo_tpu_torch.runtime.http import HttpClient
from dynamo_tpu_torch.runtime.push_router import PushRouter

# the end-to-end cases run CPU forwards inside their async bodies
pytestmark = pytest.mark.allow_slow_callbacks

WAIT_S = 10.0


def H(i: int) -> int:
    """A 128-bit-wide block hash, as the wire carries them."""
    return (i << 70) | (i * 2654435761 + 17)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU forwards gain nothing from torch's intra-op threads, and
    that spinning pool starves the discovery and event-plane threads the
    end-to-end cases run beside (a request then takes seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


async def _wait(pred, what: str, timeout: float = WAIT_S) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        if loop.time() > end:
            raise AssertionError(f"{what} never came within {timeout:.0f} s")
        await asyncio.sleep(0.02)


def _runtime() -> DistributedRuntime:
    return DistributedRuntime(
        config=RuntimeConfig(discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex)


# ---------------------------------------------------------------------------
# units against the JAX copies
# ---------------------------------------------------------------------------

_EVENTS = st.lists(
    st.tuples(st.sampled_from(["stored", "removed", "clear", "drop"]),
              st.integers(0, 3),
              st.lists(st.integers(0, 11), min_size=1, max_size=6),
              st.sampled_from(["g1", "g2", "g3", "g4"])),
    max_size=40)
_QUERIES = st.lists(st.lists(st.integers(0, 11), max_size=10), min_size=1,
                    max_size=5)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(events=_EVENTS, queries=_QUERIES)
def test_indexers_match_jax_on_event_sequences(events, queries):
    """PyKvIndexer and TieredKvIndexer (over it) give JAX's overlaps,
    per-tier overlaps and block counts after the same events."""
    ours = [PyKvIndexer(), TieredKvIndexer(PyKvIndexer())]
    theirs = [JaxPyIndexer(), JaxTiered(JaxPyIndexer())]
    for op, w, blocks, tier in events:
        hs = [H(b) for b in blocks]
        for ix in ours + theirs:
            tiered = hasattr(ix, "find_matches_tiered")
            if op == "stored":
                (ix.apply_stored(w, hs, tier=tier) if tiered
                 else ix.apply_stored(w, hs))
            elif op == "removed":
                (ix.apply_removed(w, hs, tier=tier) if tiered
                 else ix.apply_removed(w, hs))
            elif op == "clear":
                ix.clear_worker(w)
            else:
                ix.remove_worker(w)
    for q in queries:
        hs = [H(b) for b in q]
        for a, b in zip(ours, theirs):
            assert a.find_matches(hs) == b.find_matches(hs)
        assert (ours[1].find_matches_tiered(hs, [0, 1, 2, 3])
                == theirs[1].find_matches_tiered(hs, [0, 1, 2, 3]))
    for a, b in zip(ours, theirs):
        assert a.num_blocks == b.num_blocks
        assert sorted(a.workers) == sorted(b.workers)
        for w in range(4):
            assert a.worker_block_count(w) == b.worker_block_count(w)
    assert ours[1].g4_blocks == theirs[1].g4_blocks


def test_make_indexer_auto_is_py_and_native_raises(monkeypatch):
    """`auto` is the Python indexer until the port's native library is
    built, and the native one after; `native` builds it (its failures
    raise: tests/test_torch_native_indexer.py); `py` pins the Python
    one; an unknown name raises."""
    from dynamo_tpu_torch.router import native_indexer

    assert isinstance(make_indexer("py"), PyKvIndexer)
    monkeypatch.setattr(native_indexer, "is_built", lambda: False)
    assert isinstance(make_indexer(), PyKvIndexer)
    monkeypatch.undo()
    assert indexer_impl(make_indexer("native")) == "native"
    assert indexer_impl(make_indexer()) == "native"
    monkeypatch.setenv("DYN_INDEXER", "native")
    assert indexer_impl(make_indexer()) == "native"
    monkeypatch.setenv("DYN_INDEXER", "py")
    assert isinstance(make_indexer(), PyKvIndexer)
    with pytest.raises(ValueError):
        make_indexer("cuda")


_STATES = st.dictionaries(
    st.integers(0, 5),
    st.tuples(st.integers(0, 40), st.floats(0, 1), st.integers(0, 12),
              st.sampled_from([{}, {"g2": 0.3, "g4": 0.9}])),
    min_size=1, max_size=6)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(states=_STATES, request_blocks=st.integers(1, 16),
       temperature=st.sampled_from([0.0, 0.5, 2.0]),
       weight=st.sampled_from([0.5, 1.0, 2.0]), seed=st.integers(0, 99),
       tiered=st.booleans(), avoid=st.sets(st.integers(0, 5), max_size=2))
def test_selector_matches_jax_under_one_seed(states, request_blocks,
                                             temperature, weight, seed,
                                             tiered, avoid):
    """Same seed, loads and overlaps: the same picks in the same order
    (ties and softmax draws included) and the same logits."""
    ours = DefaultWorkerSelector(KvRouterConfig(
        overlap_score_weight=weight, temperature=temperature, seed=seed))
    theirs = JaxSelector(JaxRouterConfig(
        overlap_score_weight=weight, temperature=temperature, seed=seed))
    workers = sorted(states)
    ws, jws, overlaps, tier_overlaps = {}, {}, {}, {}
    for w, (active, usage, overlap, costs) in states.items():
        ws[w] = WorkerState(active_blocks=float(active), kv_usage=usage,
                            tier_costs=dict(costs))
        jws[w] = JaxWorkerState(active_blocks=float(active), kv_usage=usage,
                                tier_costs=dict(costs))
        overlaps[w] = overlap
        tier_overlaps[w] = {"g1": overlap // 2, "g4": overlap - overlap // 2}
        tier_overlaps[w] = {t: n for t, n in tier_overlaps[w].items() if n}
    kw = dict(avoid=avoid, tier_overlaps=tier_overlaps if tiered else None)
    for _ in range(5):
        assert (ours.select_verbose(workers, request_blocks, overlaps, ws,
                                    **kw)
                == theirs.select_verbose(workers, request_blocks, overlaps,
                                         jws, **kw))


def test_active_sequences_match_jax():
    rng = random.Random(3)
    ours, theirs = ActiveSequences(), JaxSequences()
    live = []
    for i in range(300):
        op = rng.random()
        if op < 0.45 or not live:
            rid = f"r{i}"
            args = (rid, rng.randrange(4), rng.randrange(1, 30),
                    rng.randrange(0, 10))
            ours.add_request(*args)
            theirs.add_request(*args)
            live.append(rid)
        elif op < 0.7:
            rid = rng.choice(live)
            ours.mark_prefill_completed(rid)
            theirs.mark_prefill_completed(rid)
        elif op < 0.95:
            rid = live.pop(rng.randrange(len(live)))
            assert ours.free(rid) == theirs.free(rid)
        else:
            w = rng.randrange(4)
            ours.remove_worker(w)
            theirs.remove_worker(w)
        for w in range(4):
            assert ours.active_blocks(w) == theirs.active_blocks(w)
            assert ours.active_requests(w) == theirs.active_requests(w)
        for rid in live[-3:]:
            assert ours.overlap_of(rid) == theirs.overlap_of(rid)
    assert ours.active_requests() == theirs.active_requests()


@settings(max_examples=100, deadline=None, database=None, derandomize=True)
@given(worker=st.integers(0, 2 ** 63 - 1), rank=st.integers(0, 64))
def test_target_ids_are_jax_bit_for_bit(worker, rank):
    assert target_id(worker, rank) == jax_target_id(worker, rank)


def test_target_map_matches_jax():
    ours, theirs = TargetMap(), JaxTargetMap()
    rng = random.Random(5)
    for _ in range(200):
        w, r = rng.randrange(1 << 62), rng.randrange(4)
        if rng.random() < 0.8:
            assert ours.observe(w, r) == theirs.observe(w, r)
        else:
            assert sorted(ours.remove_worker(w)) == sorted(
                theirs.remove_worker(w))
        assert ours.targets_of(w) == theirs.targets_of(w)
    assert ours._by_tid == theirs._by_tid
    for tid in list(ours._by_tid) + [12345]:
        assert ours.resolve(tid) == theirs.resolve(tid)


def test_lora_replica_placement_matches_jax():
    workers = [random.Random(i).randrange(1 << 62) for i in range(7)]
    for name in ("a", "sql-adapter", "x" * 40):
        assert rendezvous_ranking(name, workers) == jax_ranking(name, workers)
        for k in (1, 2, 3, 9):
            ours, theirs = LoraReplicaSelector(k), JaxLoraSelector(k)
            assert ours.replica_set(name, workers) == theirs.replica_set(
                name, workers)
            for avoid in (None, set(workers[:2]), set(workers)):
                assert ours.filter(name, workers, avoid=avoid) == \
                    theirs.filter(name, workers, avoid=avoid)
    assert LoraReplicaSelector().filter(None, workers) == workers


@pytest.mark.parametrize("mode", [m.value for m in RouterMode])
def test_push_router_modes_match_jax(mode):
    """Every mode, seeded alike, with in-flight counts moving: the same
    instance each time."""
    from dynamo_tpu.runtime.discovery import Instance as JaxInstance

    ours, theirs = PushRouter(RouterMode(mode)), JaxPushRouter(
        JaxRouterMode(mode))
    mk = dict(namespace="ns", component="c", endpoint="generate",
              address="tcp://127.0.0.1:1")
    insts = [Instance(instance_id=i, **mk) for i in (30, 10, 20, 40)]
    jinsts = [JaxInstance(instance_id=i, **mk) for i in (30, 10, 20, 40)]
    rng = random.Random(1)
    for step in range(40):
        n = rng.randrange(1, 5)
        random.seed(step)
        a = ours.pick(insts[:n]).instance_id
        random.seed(step)
        b = theirs.pick(jinsts[:n]).instance_id
        assert a == b, (mode, step)
        ours.on_dispatch(a)
        theirs.on_dispatch(b)
        if rng.random() < 0.4:
            done = rng.choice(list(ours.inflight) or [a])
            ours.on_complete(done)
            theirs.on_complete(done)
        assert dict(ours.inflight) == dict(theirs.inflight)
    with pytest.raises(RuntimeError):
        ours.pick([])


async def test_client_avoid_and_modes_on_the_runtime():
    """Client(endpoint, router_mode): round robin over live instances,
    the avoid set skipped while an alternative exists (then ignored),
    on_pick told the choice, and in-flight counts released."""
    rt = await _runtime().start()
    comp = rt.namespace("ns").component("w")
    served = []

    def handler_for(iid):
        async def handler(payload, ctx):
            served.append(iid)
            yield {"iid": iid}
        return handler

    for iid in (1, 2, 3):
        await comp.endpoint("generate").serve_endpoint(handler_for(iid),
                                                       instance_id=iid)
    client = await comp.endpoint("generate").client(
        RouterMode.ROUND_ROBIN).start()
    try:
        await _wait(lambda: len(client.instances) == 3, "three instances")
        picks = []
        for _ in range(6):
            async for _ in client.generate({}, on_pick=picks.append):
                pass
        assert picks == [1, 2, 3, 1, 2, 3] == served
        for _ in range(4):
            async for out in client.generate({}, avoid={1, 2}):
                assert out == {"iid": 3}
        async for out in client.generate({}, avoid={1, 2, 3}):
            assert out["iid"] in (1, 2, 3)
        assert not client.router.inflight
        assert sorted(client.instance_ids) == [1, 2, 3]
        async for out in client.direct({}, 2):
            assert out == {"iid": 2}
    finally:
        await client.close()
        await rt.shutdown()


class _FakeClient:
    """The generate-endpoint client a KvRouter asks for live instances."""

    def __init__(self, ids):
        self.instance_ids = list(ids)

    async def wait_for_instances(self, timeout: float = 10.0):
        return self.instance_ids


async def test_kv_router_pick_matches_jax_decisions():
    """Both KvRouters fed the same KV events (tiers, dp ranks, a gap-free
    stream), the same load_metrics and the same requests: equal picks,
    dp ranks, decision records and overlap stats."""
    from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols import StopConditions as JaxStop
    from dynamo_tpu.router.events import KvCacheEvent as JaxEvent
    from dynamo_tpu.router.kv_router import KvRouter as JaxKvRouter
    from dynamo_tpu.router.selector import WorkerState as JWS
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
    from dynamo_tpu_torch.router.events import KvCacheEvent
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

    prt = await _runtime().start()
    jrt = await JaxRuntime(config=JaxRuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    workers = [11, 22, 33]
    cfg = dict(overlap_score_weight=1.0, temperature=0.5, seed=4)
    ours = KvRouter(prt, "ns", "w", _FakeClient(workers), block_size=4,
                    config=KvRouterConfig(**cfg), replica_sync=False)
    theirs = JaxKvRouter(jrt, "ns", "w", _FakeClient(workers), block_size=4,
                         config=JaxRouterConfig(**cfg), replica_sync=False)
    rng = random.Random(9)
    prompts = [[rng.randrange(256) for _ in range(rng.randrange(8, 40))]
               for _ in range(6)]
    eid = {}
    try:
        for step in range(60):
            w = rng.choice(workers)
            rank = rng.randrange(2)
            p = rng.choice(prompts)
            hs = compute_block_hashes_for_request(p, 4)
            n = rng.randrange(1, len(hs) + 1)
            op = "stored" if rng.random() < 0.8 else "removed"
            e = eid.get((w, rank), 0)
            eid[(w, rank)] = e + 1
            wire = KvCacheEvent(worker_id=w, event_id=e, op=op,
                                block_hashes=hs[:n],
                                tier=rng.choice(["g1", "g1", "g2"]),
                                dp_rank=rank).to_wire()
            ours._apply_event(KvCacheEvent.from_wire(wire))
            theirs._apply_event(JaxEvent.from_wire(wire))
        for w in workers:
            for r in range(2):
                for router, ws in ((ours, WorkerState), (theirs, JWS)):
                    tid = router.targets.observe(w, r)
                    router.states[tid] = ws(kv_usage=rng.random() * 0.5,
                                            kv_total_blocks=64)
        for i in range(12):
            p = rng.choice(prompts) + [rng.randrange(256)
                                       for _ in range(rng.randrange(4))]
            stop = dict(max_tokens=rng.randrange(1, 20), ignore_eos=True)
            a_req = PreprocessedRequest(token_ids=p, request_id=f"q{i}",
                                        stop=StopConditions(**stop))
            b_req = JaxRequest(token_ids=p, request_id=f"q{i}",
                               stop=JaxStop(**stop))
            avoid = {workers[i % 3]} if i % 4 == 3 else None
            a = await ours.pick(a_req, avoid=avoid)
            b = await theirs.pick(b_req, avoid=avoid)
            assert (a, a_req.dp_rank) == (b, b_req.dp_rank)
            assert ours.pop_decision(f"q{i}") == theirs.pop_decision(
                f"q{i}")
            if i % 2:
                ours.complete(f"q{i}")
                theirs.complete(f"q{i}")
        ours.on_realized({"predicted_overlap_blocks": 3}, 8)
        theirs.on_realized({"predicted_overlap_blocks": 3}, 8)
        a_stats, b_stats = ours.overlap_stats(), theirs.overlap_stats()
        a_stats.pop("indexer_impl")
        b_stats.pop("indexer_impl")
        assert a_stats == b_stats
    finally:
        await prt.shutdown()
        await jrt.shutdown()


# ---------------------------------------------------------------------------
# end to end on the port's runtime
# ---------------------------------------------------------------------------


async def _publisher_and_router(rt, worker_id: int, late: bool = False,
                                before=()):
    comp = rt.namespace("ns").component("w")
    pub = KvEventPublisher(rt, "ns", "w", worker_id=worker_id)
    await comp.endpoint("kv_events_replay").serve_endpoint(
        pub.replay_handler, instance_id=worker_id)
    for batch in before:
        await pub.stored(batch)
    await asyncio.sleep(0.05)
    gen_client = await comp.endpoint("generate").client().start()
    router = await KvRouter(rt, "ns", "w", gen_client, block_size=4).start()
    await asyncio.sleep(0.05)
    return pub, gen_client, router


async def test_kv_router_event_gap_recovery():
    """An event dropped on the floor is recovered through the worker's
    kv_events_replay endpoint (tests/test_router.py's case)."""
    rt = await _runtime().start()
    pub, gen_client, router = await _publisher_and_router(rt, 7)
    try:
        hs = [H(i) for i in range(10)]
        await pub.stored(hs[:3])            # event 0: delivered
        pub._mk("stored", hs[3:6], None, "g1")  # event 1: never published
        await pub.stored(hs[6:10])          # event 2: the gap shows
        await _wait(lambda: router.indexer.worker_block_count(7) >= 10,
                    "the replayed blocks")
        assert router.indexer.worker_block_count(7) == 10
        assert router.indexer.find_matches(hs) == {7: 10}
    finally:
        await router.close()
        await gen_client.close()
        await rt.shutdown()


async def test_kv_router_late_join_full_replay():
    """A router that subscribes after the worker published events 0 and 1
    replays them on its first observed event."""
    rt = await _runtime().start()
    hs = [H(i) for i in range(8)]
    pub, gen_client, router = await _publisher_and_router(
        rt, 9, before=(hs[:3], hs[3:5]))
    try:
        await pub.stored(hs[5:8])
        await _wait(lambda: router.indexer.worker_block_count(9) >= 8,
                    "the late router's replay")
        assert router.indexer.find_matches(hs) == {9: 8}
    finally:
        await router.close()
        await gen_client.close()
        await rt.shutdown()


async def test_kv_router_snapshot_on_subscribe():
    """A router started against a warm worker that publishes nothing new
    gets its resident set through the snapshot on discovery."""
    rt = await _runtime().start()
    comp = rt.namespace("ns").component("w")

    async def gen(payload, ctx):
        yield {}

    await comp.endpoint("generate").serve_endpoint(gen, instance_id=5)
    hs = [H(i) for i in range(6)]
    pub, gen_client, router = await _publisher_and_router(
        rt, 5, before=(hs[:4], hs[4:]))
    try:
        await _wait(lambda: router.indexer.worker_block_count(5) >= 6,
                    "the snapshot")
        assert router.indexer.find_matches(hs) == {5: 6}
    finally:
        await router.close()
        await gen_client.close()
        await rt.shutdown()


async def test_router_replica_sync_converges():
    """Two router replicas over one worker: each one's slot manager
    follows the other's add, prefill_done and free."""
    rt = await _runtime().start()
    comp = rt.namespace("dynamo").component("stub")

    async def gen(payload, ctx):
        yield {}

    served = await comp.endpoint("generate").serve_endpoint(gen)
    wid = served.instance_id
    cA = await comp.endpoint("generate").client().start()
    cB = await comp.endpoint("generate").client().start()
    rA = await KvRouter(rt, "dynamo", "stub", cA, block_size=4).start()
    rB = await KvRouter(rt, "dynamo", "stub", cB, block_size=4).start()
    try:
        await cA.wait_for_instances()
        await cB.wait_for_instances()
        req = PreprocessedRequest(
            token_ids=list(range(40)), request_id="r1",
            stop=StopConditions(max_tokens=8, ignore_eos=True))
        assert await rA.pick(req) == wid
        await _wait(lambda: rB.sequences.active_blocks(wid) > 0,
                    "replica B's view of A's add")
        assert rB.sequences.active_blocks(wid) == \
            rA.sequences.active_blocks(wid)
        assert rB.sequences.active_requests(wid) == 1
        rA.mark_prefill_completed("r1")
        key = f"r1@{rA.sync.router_id}"
        await _wait(lambda: rB.sequences._reqs.get(key) is not None
                    and rB.sequences._reqs[key].prefill_done,
                    "replica B's view of A's prefill_done")
        rA.complete("r1")
        await _wait(lambda: rB.sequences.active_requests(wid) == 0,
                    "replica B's view of A's free")
        assert rB.sequences.active_blocks(wid) == 0.0
    finally:
        await rA.close()
        await rB.close()
        await cA.close()
        await cB.close()
        await rt.shutdown()


SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
WORKER = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)


async def test_port_frontend_routes_to_the_warm_worker(monkeypatch):
    """Two tiny CPU workers (one set of weights) behind the port's
    frontend in kv mode: a prompt warmed on one worker sends a request
    sharing its prefix there through HTTP, with the predicted overlap on
    the decision and the realized reuse on the histogram; a cold prompt
    goes by load.  The native indexer's library is built first, so the
    default DYN_INDEXER (auto) gives the router the native indexer."""
    from dynamo_tpu_torch.frontend.service import (
        HttpService,
        ModelManager,
        ModelWatcher,
    )
    from dynamo_tpu_torch.router import native_indexer
    from dynamo_tpu_torch.router.kv_router import make_kv_route_factory

    monkeypatch.delenv("DYN_INDEXER", raising=False)
    native_indexer.build()

    rt = await _runtime().start()
    tok = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
    w1 = TorchEngineWorker(rt, EngineConfig(model_config=FP32,
                                            model_name="m", **WORKER),
                           tokenizer_cfg=tok, device="cpu")
    await w1.start()
    w2 = TorchEngineWorker(rt, EngineConfig(model_config=FP32,
                                            model_name="m", **WORKER),
                           tokenizer_cfg=tok, params=w1.engine.params,
                           device="cpu")
    await w2.start()
    manager = ModelManager()
    watcher = await ModelWatcher(rt, manager, router_mode=RouterMode.KV,
                                 make_route=make_kv_route_factory(rt)
                                 ).start()
    service = await HttpService(rt, manager, host="127.0.0.1",
                                port=0).start()
    http = HttpClient(f"http://127.0.0.1:{service.bound_port}")
    i1, i2 = w1.served.instance_id, w2.served.instance_id
    try:
        await _wait(lambda: manager.get("m") is not None, "model m")
        pipeline = manager.get("m")
        await _wait(lambda: len(pipeline.client.instances) == 2,
                    "both workers")
        router = pipeline.migration.route
        served = {i1: [], i2: []}
        for w, iid in ((w1, i1), (w2, i2)):
            orig = w.engine.generate

            def spy(req, *a, _orig=orig, _iid=iid, **kw):
                served[_iid].append(req.request_id)
                return _orig(req, *a, **kw)

            w.engine.generate = spy
        warm = "the quick brown fox jumps over the lazy dog again"
        req = PreprocessedRequest(
            token_ids=[3 + b for b in warm.encode()], request_id="warm",
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=2, ignore_eos=True))
        async for _ in pipeline.client.generate(req.to_dict(),
                                                instance_id=i1):
            pass
        n_blocks = len(req.token_ids) // 4
        await _wait(lambda: router.indexer.worker_block_count(i1)
                    >= n_blocks, "the warm worker's blocks in the index")
        body = {"model": "m", "prompt": warm + " and again",
                "max_tokens": 3, "temperature": 0.0, "ignore_eos": True}
        for i in range(3):
            r = await http.call("POST", "/v1/completions", body)
            assert r["usage"]["completion_tokens"] == 3
        assert len(served[i1]) == 4 and not served[i2], served
        metrics = (await http.request("GET", "/metrics")).body.decode()
        assert "dynamo_router_overlap_realized_blocks_count" in metrics
        sums = [ln for ln in metrics.splitlines() if ln.startswith(
            "dynamo_router_overlap_blocks_sum")]
        assert sums and float(sums[0].rsplit(" ", 1)[1]) >= 3 * n_blocks
        # a cold prompt goes by load: w1 carries phantom in-flight blocks
        for i in range(4):
            router.sequences.add_request(f"fake{i}", i1, 20, 0)
        cold = dict(body, prompt="completely different words here")
        await http.call("POST", "/v1/completions", cold)
        assert len(served[i2]) == 1, served
        stats = router.overlap_stats()
        assert stats["decisions"] == 4
        assert stats["indexer_impl"] == "native"
    finally:
        await http.close()
        await service.close()
        await watcher.close()
        await w1.close()
        await w2.close()
        await rt.shutdown()

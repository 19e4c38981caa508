"""The port's mocker against the JAX package's (CPU, host only).

Exact equality is the tolerance: the mocker is host code, so the same
arguments, seed and requests must give the same results on both sides.

* `KvCacheSim` op sequences (prefix hits, LRU eviction, the capacity
  refusal, decode growth, the G2 -> G4 demotion chain, onboarding and
  the run that breaks at a miss, int8 capacity), each with a KvLedger:
  every step's result, the sim's counters, the ledger's attribution and
  `audit_sim`'s verdicts, also on books broken on purpose;
  `SimObjectStore.sweep`'s verdict ladder;
* `MockEngine` scenarios (concurrent requests with chunked prefill and a
  queue, preemption, simulated speculation, lockstep, canned and guided
  text, the death and flaky faults, the drain markers, the G2/G4 tiers
  across two engines sharing a store): token streams, finish reasons,
  errors, KV event batches, the metrics counters and the FPM records
  (timing fields aside), with a large `speedup_ratio`;
* `MockerWorker` with two simulated dp ranks and speculation: streams by
  rank, the MDC, the KV events on the event plane, the load-metrics
  payload and the /metrics names it exports;
* the CLI's flags.
"""

import asyncio
import time
import uuid

import pytest
from test_torch_worker import CLI_READY_S, _readline

import dynamo_tpu.mocker as jax_mocker
import dynamo_tpu.mocker.__main__ as jax_mocker_cli
import dynamo_tpu.mocker.kv_cache_sim as jax_sim
import dynamo_tpu.obs.kv_ledger as jax_ledger
import dynamo_tpu.protocols as jax_protocols
import dynamo_tpu.runtime as jax_runtime
import dynamo_tpu_torch.mocker as port_mocker
import dynamo_tpu_torch.mocker.__main__ as port_mocker_cli
import dynamo_tpu_torch.mocker.kv_cache_sim as port_sim
import dynamo_tpu_torch.obs.kv_ledger as port_ledger
import dynamo_tpu_torch.protocols as port_protocols
import dynamo_tpu_torch.runtime as port_runtime

SIDES = {
    "jax": (jax_mocker, jax_sim, jax_ledger, jax_protocols, jax_runtime),
    "port": (port_mocker, port_sim, port_ledger, port_protocols,
             port_runtime),
}


# ------------------------------ KvCacheSim --------------------------------

def _res(r):
    if r is None:
        return None
    return (r.stored, r.removed, r.cached_blocks, r.tier_events,
            r.onboarded)


# each op: ("alloc", seq, hashes, total) | ("grow", seq, hash, new) |
# ("free", seq) | ("clear",) | ("put", h) (into the shared store)
SIM_SCRIPTS = {
    "prefix_evict": (dict(num_blocks=8), [
        ("alloc", "a", [1, 2, 3, 4], 4), ("alloc", "b", [1, 2, 3, 4], 4),
        ("free", "a"), ("free", "b"),
        ("alloc", "c", [10, 11, 12, 13, 14, 15, 16, 17], 8),
        ("free", "c"), ("clear",)]),
    "capacity": (dict(num_blocks=4), [
        ("alloc", "a", [1, 2, 3, 4, 5, 6, 7, 8], 8),
        ("alloc", "b", [1, 2], 3), ("alloc", "c", [9], 2)]),
    "grow": (dict(num_blocks=6), [
        ("alloc", "a", [1, 2], 3), ("grow", "a", 3, True),
        ("grow", "a", None, False), ("alloc", "b", [1, 2, 3], 4),
        ("grow", "b", 3, True), ("free", "a"), ("free", "b"),
        ("alloc", "c", [7, 8, 9, 10, 11], 6), ("grow", "c", 12, True)]),
    "no_prefix_cache": (dict(num_blocks=8, enable_prefix_caching=False), [
        ("alloc", "a", [1, 2, 3], 4), ("free", "a"),
        ("alloc", "b", [1, 2, 3], 4), ("free", "b")]),
    "int8": (dict(num_blocks=5, kv_cache_dtype="int8"), [
        ("alloc", "a", list(range(1, 10)), 9),
        ("alloc", "b", [20], 1)]),
    "demotion_g4": (dict(num_blocks=8, host_blocks=2, store=True), [
        ("alloc", "a", [1001, 1002, 1003, 1004], 4), ("free", "a"),
        ("alloc", "j", [2000 + i for i in range(8)], 8), ("free", "j"),
        ("alloc", "b", [1001, 1002, 1003, 1004], 4)]),
    "g2_onboard": (dict(num_blocks=4, host_blocks=4), [
        ("alloc", "a", [11, 12], 2), ("free", "a"),
        ("alloc", "j", [21, 22, 23, 24], 4), ("free", "j"),
        ("alloc", "b", [11, 12], 2)]),
    "run_breaks": (dict(num_blocks=8, store=True), [
        ("put", 31), ("put", 33), ("alloc", "a", [31, 32, 33], 3)]),
    "straight_to_g4": (dict(num_blocks=3, store=True), [
        ("alloc", "a", [5, 6, 7], 3), ("free", "a"),
        ("alloc", "b", [8, 9], 3), ("free", "b"),
        ("alloc", "c", [5, 6], 2)]),
}


def _sim_run(side, name):
    _, sim_mod, led_mod = SIDES[side][:3]
    kw, ops = SIM_SCRIPTS[name]
    kw = dict(kw)
    store = sim_mod.SimObjectStore() if kw.pop("store", False) else None
    led = led_mod.KvLedger()
    sim = sim_mod.KvCacheSim(ledger=led, object_store=store, **kw)
    live, out = set(), []
    for op in ops:
        if op[0] == "alloc":
            r = sim.allocate(op[1], op[2], op[3])
            if r is not None:
                live.add(op[1])
        elif op[0] == "grow":
            r = sim.grow(op[1], op[2], op[3])
        elif op[0] == "free":
            r = sim.free(op[1])
            live.discard(op[1])
        elif op[0] == "clear":
            r = sim.clear_cached()
        else:
            r = store.put(op[1])
        out.append((_res(r) if hasattr(r, "stored") else r,
                    sim.used_blocks, sim.free_blocks, sim.evictable_blocks,
                    sim.g2_blocks, sorted(store.keys()) if store else None,
                    led.attribution(),
                    led.audit_sim(sim, live)))
    out.append((sim.num_blocks, led.onboard_counts()))
    return out, sim, led, live


@pytest.mark.parametrize("name", sorted(SIM_SCRIPTS))
def test_kv_cache_sim_ops_equal_jax(name):
    port, jax = _sim_run("port", name)[0], _sim_run("jax", name)[0]
    assert port == jax
    if name == "demotion_g4":
        # the prefix came back onboarded from G2/G4, not recomputed
        assert port[-2][0][2] == 4 and port[-1][1]
    if name == "capacity":
        assert port[0][0] is None


# faults made by mutating the sim's books directly
SIM_FAULTS = ("leak", "orphan", "drift", "double_free", "owner_gone")


def _break_books(sim, fault):
    if fault == "leak":
        # dynlint: disable=DYN013 deliberately corrupting the sim books to prove the auditor catches it
        sim._ref[999] = 1
    elif fault == "orphan":
        # dynlint: disable=DYN013 deliberately corrupting the sim books to prove the auditor catches it
        sim._ref.pop(3)
    elif fault == "drift":
        # dynlint: disable=DYN013 deliberately corrupting the sim books to prove the auditor catches it
        sim._ref[1] = 5
    elif fault == "double_free":
        sim.free_blocks += 2


@pytest.mark.parametrize("fault", SIM_FAULTS)
def test_audit_sim_verdicts_equal_jax(fault):
    got = {}
    for side, mods in SIDES.items():
        led = mods[2].KvLedger()
        sim = mods[1].KvCacheSim(num_blocks=16, ledger=led)
        sim.allocate("a", [1, 2, 3], 4)
        sim.free("a")
        sim.allocate("x", [1, 2, 40], 4)
        live = {"x"} if fault != "owner_gone" else set()
        _break_books(sim, fault)
        viol = led.audit_sim(sim, live)
        report = led.finish_audit(viol, where="test")
        got[side] = (viol, {k: v for k, v in report.items()
                            if k != "ts_unix"},
                     led.violations_by_kind(), led.attribution())
    assert got["port"] == got["jax"]
    assert got["port"][0], "the fault went unseen"


def test_kv_dtype_capacity_and_store_sweep_equal_jax():
    for nb in (1, 5, 4096):
        for dt in ("bf16", "int8"):
            for hd in (64, 128):
                assert port_sim.kv_dtype_capacity_blocks(nb, dt, hd) == \
                    jax_sim.kv_dtype_capacity_blocks(nb, dt, hd)
    out = {}
    for side, mods in SIDES.items():
        store = mods[1].SimObjectStore(ttl_s=10.0)
        for h in (1, 2, 3):
            store.put(h)
        t0 = max(store._blobs.values())
        res = {1: "hot", 2: "dead"}.get
        out[side] = (sorted(store.sweep(now=t0 + 20.0, residency=res)),
                     store.sweep(now=t0 + 25.0), store.quarantine(1),
                     store.quarantine(1), len(store))
    assert out["port"] == out["jax"] == ([2, 3], [], True, False, 0)


# ------------------------------ MockEngine --------------------------------

class _Pub:
    """A KV event publisher that records every batch."""

    worker_id = 7

    def __init__(self):
        self.batches = []

    def enqueue_batch(self, stored=(), removed=(), tier="g1"):
        self.batches.append((list(stored), list(removed), tier))

    async def removed(self, hashes):
        self.batches.append(([], list(hashes), "clear"))


FAST = dict(block_size=4, num_blocks=64, base_step_s=0.0005,
            prefill_s_per_token=0.0, decode_s_per_seq=0.0,
            speedup_ratio=1000.0, kv_ledger=True)
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "n": {"type": "integer"}},
    "required": ["name", "n"]}

# name: (engine args, [(prompt, max_tokens, options)], drive)
ENGINE_SCENARIOS = {
    "concurrent": (dict(max_num_seqs=4, max_batch_tokens=12),
                   [(list(range(i * 5, i * 5 + 14)), 6, {})
                    for i in range(6)]
                   + [(list(range(0, 14)), 4, {"seed": 3})], "gather"),
    "preempt": (dict(num_blocks=10, max_num_seqs=4),
                [(list(range(i * 11, i * 11 + 8)), 14, {})
                 for i in range(3)], "gather"),
    "spec": (dict(speculative={"k": 3, "acceptance": 0.6}),
             [([5, 6, 7, 8, 9], 12, {}), ([1, 2, 3], 9, {"seed": 11})],
             "gather"),
    "lockstep": (dict(overlap_scheduling=False, decode_fused_steps=1,
                      enable_chunked_prefill=False, max_batch_tokens=8),
                 [(list(range(20)), 5, {}), (list(range(3, 9)), 7, {})],
                 "gather"),
    "eos": (dict(vocab_size=40), [(list(range(i, i + 6)), 300,
                                   {"ignore_eos": False})
                                  for i in range(3)], "gather"),
    "canned_and_guided": (dict(canned_text="hi <tool>x</tool>"),
                          [([1, 2, 3], 64, {"ignore_eos": False}),
                           ([4, 5], 200, {"ignore_eos": False,
                                          "guided_json": SCHEMA})],
                          "serial"),
    "fail_after": (dict(fail_after_tokens=5),
                   [([1, 2, 3, 4, 5], 8, {}), ([6, 7, 8], 8, {})],
                   "gather_then_one"),
    "flaky": (dict(flaky=0.2, fault_seed=4),
              [(list(range(i, i + 5)), 10, {}) for i in range(4)], "gather"),
    # 50 ms steps: the abort lands while the third step sleeps
    "drain": (dict(base_step_s=0.05, speedup_ratio=1.0),
              [([1, 2, 3, 4, 5, 6], 50, {})], "drain"),
    "tiers": (dict(num_blocks=8, host_blocks=2),
              [(list(range(16)), 2, {"seed": 1})]
              + [(list(range(100 + 16 * i, 116 + 16 * i)), 2, {})
                 for i in range(4)], "tiers"),
    "clear": (dict(), [(list(range(12)), 3, {}), (list(range(12)), 3, {})],
              "clear"),
}


def _request(protocols, prompt, n, i, opts):
    opts = dict(opts)
    sampling = protocols.SamplingOptions(seed=opts.pop("seed", None),
                                         guided_json=opts.pop(
                                             "guided_json", None))
    stop = protocols.StopConditions(
        max_tokens=n, ignore_eos=opts.pop("ignore_eos", True))
    return protocols.PreprocessedRequest(
        token_ids=list(prompt), request_id=f"r{i}", sampling=sampling,
        stop=stop)


async def _collect(eng, req):
    toks, last = [], None
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
        last = out
    return toks, last.finish_reason, last.error, last.metrics


def _fpm(eng):
    timing = {"t", "gap_s", "mfu", "est_mfu"}
    return [{k: v for k, v in r.items() if k not in timing}
            for r in eng.fpm]


async def _engine_run(side, name):
    mocker, sim_mod, _, protocols = SIDES[side][:4]
    kw, reqs, drive = ENGINE_SCENARIOS[name]
    store = sim_mod.SimObjectStore() if drive == "tiers" else None
    args = mocker.MockEngineArgs(**{**FAST, **kw, "object_store": store})
    pub = _Pub()
    eng = mocker.MockEngine(args, kv_event_publisher=pub)
    engines = [eng]
    reqs = [_request(protocols, p, n, i, o)
            for i, (p, n, o) in enumerate(reqs)]
    try:
        if drive == "gather":
            res = await asyncio.gather(*[_collect(eng, r) for r in reqs])
        elif drive == "serial" or drive == "tiers":
            res = [await _collect(eng, r) for r in reqs]
            if drive == "tiers":
                # a cold engine on the same store serves the first prompt
                # by onboarding it from G4
                cold = mocker.MockEngine(
                    mocker.MockEngineArgs(**{**FAST, **kw, "num_blocks": 16,
                                             "object_store": store}),
                    kv_event_publisher=pub)
                engines.append(cold)
                reqs[0].request_id = "cold"
                res.append(await _collect(cold, reqs[0]))
        elif drive == "gather_then_one":
            res = await asyncio.gather(*[_collect(eng, r) for r in reqs])
            res.append(await _collect(eng, reqs[0]))
        elif drive == "clear":
            res = [await _collect(eng, reqs[0])]
            res.append(await eng.clear_kv_blocks())
            res.append(await _collect(eng, reqs[1]))
        else:  # drain: abort after the first token, then reject
            stream = eng.generate(reqs[0])
            toks = list((await stream.__anext__()).token_ids)
            eng.drain_abort()
            async for out in stream:
                toks.extend(out.token_ids)
            res = [(toks, out.finish_reason, out.error),
                   await _collect(eng, reqs[0])]
        audits = [e.audit_kv()["clean"] for e in engines]
    finally:
        for e in engines:
            await e.close()
    return (res, pub.batches, [dict(e.metrics) for e in engines],
            [_fpm(e) for e in engines], audits,
            [e.kv_ledger.attribution() for e in engines],
            [e.kv_integrity_counters() for e in engines],
            [e.tier_states() for e in engines])


@pytest.mark.parametrize("name", sorted(ENGINE_SCENARIOS))
async def test_mock_engine_equal_jax(name):
    jax_out = await _engine_run("jax", name)
    port_out = await _engine_run("port", name)
    assert port_out == jax_out
    res, batches, metrics = port_out[:3]
    if name == "eos":
        # a reference quirk the port reproduces: a preempted sequence's
        # re-admission evicts, from the LRU, prefix-hit blocks it then
        # pins without a slot, so the sim's free counter runs ahead of
        # the ledger's books (JAX's audit says "double-free" alike)
        assert metrics[0]["preemptions"] > 0 and not all(port_out[4])
    else:
        assert all(port_out[4]), "the ledger's audit found violations"
    if name == "spec":
        assert metrics[0]["spec_accepted"] > 0
    if name == "preempt":
        assert metrics[0]["preemptions"] > 0
    if name == "tiers":
        assert metrics[1]["kv_onboard_g4"] >= 4
        assert {t for _, _, t in batches} >= {"g1", "g2", "g4"}
    if name == "fail_after":
        assert res[-1][2] == port_mocker.engine.DEATH_ERROR
    if name == "drain":
        assert (res[0][2], res[1][2]) == (port_protocols.DRAIN_ABORT,
                                          port_protocols.DRAIN_REJECT)
    if name == "flaky":
        assert port_mocker.engine.FLAKY_ERROR in [r[2] for r in res]
    if name == "canned_and_guided":
        assert bytes(t - 3 for t in res[0][0][:-1]) == b"hi <tool>x</tool>"


# ------------------------------ MockerWorker ------------------------------

async def _worker_run(side):
    mocker, _, _, protocols, runtime = SIDES[side]
    rt = await runtime.DistributedRuntime(
        config=runtime.RuntimeConfig(discovery_backend="mem",
                                     event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    loads, kv = [], []

    async def take(subject, into):
        async for _, msg in rt.event_plane.subscribe(subject):
            into.append(msg)

    tasks = [asyncio.ensure_future(take("load_metrics.dynamo.backend",
                                        loads)),
             asyncio.ensure_future(take("kv_events.dynamo", kv))]
    await asyncio.sleep(0.05)
    args = mocker.MockEngineArgs(
        **{**FAST, "model_name": "m", "dp_size": 2,
           "speculative": {"k": 2, "acceptance": 0.5}})
    worker = await mocker.MockerWorker(rt, args, component="backend").start()
    client = await (rt.namespace("dynamo").component("backend")
                    .endpoint("generate").client()).start()
    try:
        await client.wait_for_instances()
        streams = []
        for rank in (0, 1, 1):
            req = _request(protocols, list(range(10 + rank)), 5, rank, {})
            req.dp_rank = rank
            toks = []
            async for out in client.generate(req.to_dict()):
                toks.extend(out.get("token_ids") or [])
            streams.append(toks)
        deadline = asyncio.get_running_loop().time() + 10.0
        while (not loads or not loads[-1]["requests_total"] == 3) \
                and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)
        card = worker.card.to_dict()
        # prometheus_client's `_created` samples aside (the JAX side
        # renders through it)
        names = sorted({ln.split("{")[0].split(" ")[0]
                        for ln in rt.metrics.render().decode().splitlines()
                        if ln.startswith("dynamo_")} - {
            "dynamo_engine_compile_seconds_created",
            "dynamo_engine_compiles_created"})
        state = worker.debug_state()
    finally:
        await client.close()
        await worker.close()
        for t in tasks:
            t.cancel()
        await rt.shutdown()
    last = loads[-1]
    load = {k: v for k, v in last.items() if k not in ("worker_id",
                                                       "itl_ema_s")}
    events = [(e["dp_rank"], e["op"], e.get("block_hashes"),
               e.get("tier")) for e in kv]
    return (streams, {k: v for k, v in card.items()},
            sorted(last), load, events, names, sorted(state))


async def test_mocker_worker_equal_jax():
    jax_out = await _worker_run("jax")
    port_out = await _worker_run("port")
    assert port_out == jax_out
    streams, card, keys, load = port_out[:4]
    assert [len(s) >= 5 for s in streams] == [True] * 3
    assert load["dp_size"] == 2 and len(load["ranks"]) == 2
    assert "dynamo_engine_spec_acceptance" in port_out[5]
    assert card["runtime_config"]["speculative"] == {"k": 2,
                                                     "acceptance": 0.5}


def test_mocker_cli_takes_the_jax_flags():
    argv = ["--model-name", "x", "--namespace", "pool-a", "--block-size",
            "16", "--num-blocks", "128", "--max-num-seqs", "8",
            "--speedup-ratio", "5", "--no-prefix-caching", "--num-workers",
            "2", "--role", "prefill", "--spec-k", "3", "--kv-cache-dtype",
            "int8", "--peak-tflops", "900", "--sim-recompile-every", "4",
            "--fail-after-tokens", "9", "--wedge-after", "3", "--flaky",
            "0.1", "--fault-seed", "2", "--drain-deadline-s", "1",
            "--no-overlap-scheduling", "--decode-fused-steps", "4"]
    assert vars(port_mocker_cli.build_args().parse_args(argv)) == \
        vars(jax_mocker_cli.build_args().parse_args(argv))


def test_planner_cli_spawns_a_port_mocker(tmp_path):
    """`python -m dynamo_tpu_torch.planner --worker-module
    dynamo_tpu_torch.mocker` spawns one mocker replica over file
    discovery; it serves a request through the port's runtime; SIGTERM
    drains it and the planner exits 0."""
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DYN_DISCOVERY_BACKEND="file",
               DYN_DISCOVERY_PATH=str(tmp_path / "cluster"), PYTHONPATH=repo)
    err = open(tmp_path / "planner.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.planner",
         "--worker-module", "dynamo_tpu_torch.mocker",
         "--worker-arg=--component=backend",
         "--worker-arg=--model-name=spawned", "--min-replicas", "1",
         "--max-replicas", "1", "--interval", "0.5"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=err, text=True)

    async def serve_one():
        rt = await port_runtime.DistributedRuntime(
            config=port_runtime.RuntimeConfig(
                discovery_backend="file",
                discovery_path=str(tmp_path / "cluster"),
                event_plane="inproc")).start()
        client = await (rt.namespace("dynamo").component("backend")
                        .endpoint("generate").client()).start()
        try:
            await asyncio.wait_for(client.wait_for_instances(), 60)
            req = _request(port_protocols, [1, 2, 3, 4], 5, 0, {})
            toks = []
            async for out in client.generate(req.to_dict()):
                toks.extend(out.get("token_ids") or [])
            cards = await rt.discovery.get_prefix("v1/mdc/dynamo/")
            return toks, [c["name"] for c in cards.values()]
        finally:
            await client.close()
            await rt.shutdown()

    try:
        line, end = "", time.monotonic() + CLI_READY_S
        while "planner running" not in line:
            line = _readline(proc, max(0.0, end - time.monotonic()))
            assert line, ("no 'planner running' line from the planner: "
                          + (tmp_path / "planner.log").read_text()[-3000:])
        toks, names = asyncio.run(serve_one())
        assert len(toks) == 5 and names == ["spawned"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            # SIGTERM first: the planner's connector stops its replicas
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        proc.stdout.close()
        err.close()

"""The port's chaos plane and its seams against the JAX package's (CPU).

Exact equality is the tolerance throughout: the plane is host code, and
greedy streams are token ids.

* The plane: the same ACTIONS and SEAMS, and for any seed, rule set and
  call order the same injections, outcomes and error texts in both
  packages (hypothesis over seeds and rule sets); `after`/`times`/
  `match`, a scoped install, the unregistered-seam refusal, and an
  injected error classified migratable by the port's `is_migratable`.
* The scenarios of tests/test_chaos.py, each run on the port's mocker
  fleet behind the port's migration pipeline and on JAX's behind JAX's:
  the faulted run's tokens equal the same package's fault-free run and
  JAX's, the injections fired are the same, and exhausted budgets fail
  typed in both.
* The engine-step crash and the KV-pull failure (one chunk absorbed by
  a retry, then a persistent one falling back to local prefill) on the
  port's TorchEngine workers, with tokens equal to JaxEngine's on the
  same weights; the drain of a TorchEngineWorker.
"""

import asyncio
import os
import signal
import types
import uuid

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import dynamo_tpu.chaos as jax_chaos
import dynamo_tpu.frontend as jax_frontend
import dynamo_tpu.frontend.pipeline as jax_pipeline
import dynamo_tpu.mocker as jax_mocker
import dynamo_tpu.protocols as jax_protocols
import dynamo_tpu.runtime as jax_runtime
import dynamo_tpu.runtime.aio as jax_aio
import dynamo_tpu.runtime.discovery as jax_discovery
import dynamo_tpu.runtime.retry as jax_retry
import dynamo_tpu_torch.chaos as port_chaos
import dynamo_tpu_torch.frontend.pipeline as port_pipeline
import dynamo_tpu_torch.frontend.service as port_frontend
import dynamo_tpu_torch.mocker as port_mocker
import dynamo_tpu_torch.protocols as port_protocols
import dynamo_tpu_torch.runtime as port_runtime
import dynamo_tpu_torch.runtime.aio as port_aio
import dynamo_tpu_torch.runtime.discovery as port_discovery
import dynamo_tpu_torch.runtime.retry as port_retry
from dynamo_tpu_torch.protocols import DRAIN_ABORT, DRAIN_REJECT

pytestmark = pytest.mark.chaos


def _pkg(chaos, frontend, pipeline, mocker, protocols, runtime, aio,
         discovery, retry):
    return types.SimpleNamespace(
        chaos=chaos, ModelManager=frontend.ModelManager,
        ModelWatcher=frontend.ModelWatcher,
        is_migratable=pipeline.is_migratable,
        MockEngineArgs=mocker.MockEngineArgs,
        MockerWorker=mocker.MockerWorker, protocols=protocols,
        runtime=runtime, aio=aio, discovery=discovery, retry=retry)


PKGS = {
    "jax": _pkg(jax_chaos, jax_frontend, jax_pipeline, jax_mocker,
                jax_protocols, jax_runtime, jax_aio, jax_discovery,
                jax_retry),
    "port": _pkg(port_chaos, port_frontend, port_pipeline, port_mocker,
                 port_protocols, port_runtime, port_aio, port_discovery,
                 port_retry),
}


# ------------------------------ the plane --------------------------------


def test_registry_and_actions_equal_jax():
    assert port_chaos.SEAMS == jax_chaos.SEAMS
    assert port_chaos.ACTIONS == jax_chaos.ACTIONS
    assert port_chaos.WEDGE_DEFAULT_S == jax_chaos.WEDGE_DEFAULT_S
    for seam in sorted(port_chaos.SEAMS):
        assert f"  {seam} " in port_chaos.__doc__, seam


async def test_seams_are_noops_when_uninstalled():
    assert port_chaos.active() is None
    assert port_chaos.hit("engine.step", key="x") is None
    assert await port_chaos.ahit("request_plane.frame", key="y") is None


_SEAM = st.sampled_from(["engine.step", "request_plane.frame",
                         "kvbm.object_io"])
_RULE = st.tuples(
    _SEAM,
    st.sampled_from(["fail", "drop", "truncate", "corrupt", "stall",
                     "delay"]),
    st.sampled_from([1.0, 0.5, 0.2]),
    st.integers(0, 3),
    st.one_of(st.none(), st.integers(1, 4)),
    st.sampled_from(["", "k1", "k2"]),
)


def _drive(chaos, seed, rules, calls):
    plane = chaos.ChaosPlane(seed=seed)
    for seam, action, p, after, times, match in rules:
        plane.rule(seam, action, p=p, after=after, times=times,
                   match=match)
    outcomes = []
    with plane:
        for seam, key in calls:
            try:
                outcomes.append(chaos.hit(seam, key=key))
            except chaos.ChaosError as e:
                outcomes.append(("raised", str(e)))
    return outcomes, [(i.seam, i.key, i.action, i.n)
                      for i in plane.injections], \
        [(r.hits, r.fired) for r in plane.rules]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31), rules=st.lists(_RULE, max_size=4),
       calls=st.lists(st.tuples(_SEAM, st.sampled_from(
           [None, "k0", "k1", "k2"])), max_size=40))
def test_seeded_injections_identical_to_jax(seed, rules, calls):
    """One seed, one rule set and one call order inject identically in
    both packages: outcomes, error texts, injection records, per-rule
    counters."""
    assert _drive(port_chaos, seed, rules, calls) == \
        _drive(jax_chaos, seed, rules, calls)


@pytest.mark.parametrize("side", sorted(PKGS))
def test_after_times_and_match_semantics(side):
    chaos = PKGS[side].chaos
    plane = chaos.ChaosPlane(seed=0).rule(
        "engine.step", "fail", after=2, times=2, match="good")
    with plane:
        outcomes = []
        for key in ["bad", "good", "good", "good", "good", "good"]:
            try:
                chaos.hit("engine.step", key=key)
                outcomes.append("ok")
            except chaos.ChaosError:
                outcomes.append("fail")
    assert outcomes == ["ok", "ok", "ok", "fail", "fail", "ok"]
    assert plane.fired() == 2
    assert [i.n for i in plane.injections] == [1, 2]


def test_install_is_scoped_and_rejects_unknown_seams():
    plane = port_chaos.ChaosPlane(seed=1).rule("engine.step", "fail")
    with plane:
        assert port_chaos.active() is plane
        # the JAX package's plane is a separate registry
        assert jax_chaos.active() is None
    assert port_chaos.active() is None
    port_chaos.hit("engine.step")  # uninstalled again: no raise
    with pytest.raises(ValueError, match="unknown chaos seam"):
        # dynlint: disable=DYN006 the typo is the point: negative test for the registry validation
        port_chaos.ChaosPlane(seed=0).rule("engine.stpe", "fail")
    with pytest.raises(ValueError, match="unknown chaos action"):
        port_chaos.ChaosPlane(seed=0).rule("engine.step", "explode")


def test_injected_errors_classify_as_migratable():
    plane = port_chaos.ChaosPlane(seed=0).rule(
        "request_plane.frame", "truncate", times=1)
    with plane:
        with pytest.raises(port_chaos.ChaosError) as ei:
            port_chaos.hit("request_plane.frame", key="p:1")
    is_migratable = port_pipeline.is_migratable
    assert is_migratable(ei.value)
    assert str(ei.value) == ("connection lost (chaos: "
                             "request_plane.frame truncated)")
    assert is_migratable(RuntimeError("worker engine error: loop crashed"))
    # the drain markers, and a text that only starts with one
    assert is_migratable(port_runtime.EngineError(DRAIN_ABORT))
    assert is_migratable(port_runtime.EngineError(
        DRAIN_REJECT.split(":")[0] + ": migrating"))
    assert is_migratable(RuntimeError("worker stalled: no stream frame"))
    assert not is_migratable(RuntimeError("schema validation failed"))


def test_flight_recorder_dumps_on_injection(tmp_path):
    """An injection snapshots the port's timeline ring, named after its
    seam, as JAX's does."""
    from dynamo_tpu_torch import obs

    tr = obs.Tracer(out_path=str(tmp_path / "trace.json"))
    tr.install()
    try:
        with obs.span("step"):
            pass
        plane = port_chaos.ChaosPlane(seed=3).rule("engine.step", "drop")
        with plane:
            assert port_chaos.hit("engine.step", key="m") == "drop"
    finally:
        tr.uninstall()
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("dynflight-chaos.engine.step-")]
    assert dumps, os.listdir(tmp_path)


# ------------------------- mocker fleet scenarios -------------------------


def fresh_runtime(p):
    cfg = p.runtime.RuntimeConfig(discovery_backend="mem",
                                  event_plane="inproc")
    return p.runtime.DistributedRuntime(config=cfg,
                                        cluster_id=uuid.uuid4().hex)


def greedy_req(p, rid, max_tokens=8, seed=1234, prompt=None):
    P = p.protocols
    return P.PreprocessedRequest(
        token_ids=list(prompt or [5, 6, 7, 8]), request_id=rid,
        sampling=P.SamplingOptions(temperature=0.0, seed=seed),
        stop=P.StopConditions(max_tokens=max_tokens, ignore_eos=True))


BASE = dict(model_name="chaos-model", block_size=4, base_step_s=0.0005,
            prefill_s_per_token=0.0, decode_s_per_seq=0.0)


async def _until(cond, what, timeout_s=10.0):
    """Poll `cond` until true; fail naming `what` past the bound."""
    deadline = asyncio.get_running_loop().time() + timeout_s
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"{what} never arrived within "
                                 f"{timeout_s} s")
        await asyncio.sleep(0.02)


class Fleet:
    """n mocker workers + a watcher and its pipeline on one runtime."""

    def __init__(self, p, rt, workers, watcher, pipeline):
        self.p, self.rt, self.workers = p, rt, workers
        self.watcher, self.pipeline = watcher, pipeline

    @classmethod
    async def start(cls, p, n_workers=2, migration_limit=3,
                    worker_args=None, **engine_kw):
        rt = await fresh_runtime(p).start()
        args = p.MockEngineArgs(**{**BASE, **engine_kw})
        workers = []
        for i in range(n_workers):
            wa = args if worker_args is None else worker_args[i]
            workers.append(await p.MockerWorker(
                rt, wa, migration_limit=migration_limit).start())
        manager = p.ModelManager()
        watcher = await p.ModelWatcher(rt, manager).start()
        await _until(lambda: manager.get("chaos-model") is not None,
                     "the model's pipeline")
        pipeline = manager.get("chaos-model")
        await pipeline.client.wait_for_instances()
        await _until(lambda: len(pipeline.client.instances) == n_workers,
                     f"{n_workers} routable instances")
        return cls(p, rt, workers, watcher, pipeline)

    async def collect(self, req):
        tokens = []
        async for out in self.pipeline.migration.generate(req):
            assert out.finish_reason != "error", out.error
            tokens.extend(out.token_ids)
        return tokens

    async def close(self):
        self.pipeline.migration.route = None
        await self.watcher.close()
        for w in self.workers:
            await w.close()
        await self.rt.shutdown()


async def _both(scenario):
    """Run `scenario(p)` on each package's fleet; returns {side: result}."""
    return {side: await scenario(PKGS[side]) for side in ("jax", "port")}


async def _faulted_vs_baseline(p, n_tokens, rule, rid, **fleet_kw):
    """A fault-free request, then the same request under `rule`."""
    fleet = await Fleet.start(p, **fleet_kw)
    try:
        baseline = await fleet.collect(greedy_req(p, f"ff-{rid}", n_tokens))
        plane = p.chaos.ChaosPlane(seed=rule[0])
        plane.rule(*rule[1], **rule[2])
        with plane:
            faulted = await fleet.collect(
                greedy_req(p, f"ch-{rid}", n_tokens))
        return baseline, faulted, [(i.seam, i.action, i.n)
                                   for i in plane.injections]
    finally:
        await fleet.close()


FRAME_RULES = {
    # a stream truncated mid-decode: what a worker death looks like
    "killed_mid_decode": (10, (7, ("request_plane.frame", "truncate"),
                               dict(after=3, times=1, match="generate"))),
    # delays never corrupt content
    "delayed_frames": (8, (3, ("request_plane.frame", "delay"),
                           dict(delay_s=0.05, after=2, times=2,
                                match="generate"))),
    # the pick-vs-death race: replays with zero emitted tokens
    "dispatch_failure": (8, (11, ("request_plane.dispatch", "fail"),
                             dict(times=1, error="connection lost "
                                  "(chaos: dispatch)"))),
    # a window of discovery failures: requests do not touch discovery
    "discovery_outage": (8, (23, ("discovery.op", "fail"),
                             dict(error="injected discovery outage"))),
    # the mocker's scheduler crashes on step 5: streams fail with the
    # worker-engine-error marker and replay on the survivor
    "engine_step_crash": (40, (13, ("engine.step", "fail"),
                               dict(after=4, times=1,
                                    error="worker engine error: chaos "
                                          "crash on step N"))),
}


@pytest.mark.parametrize("name", sorted(FRAME_RULES))
async def test_faulted_stream_token_identical(name):
    n, rule = FRAME_RULES[name]
    got = await _both(lambda p: _faulted_vs_baseline(p, n, rule, name))
    base, faulted, fired = got["port"]
    assert len(base) == n
    assert faulted == base
    assert got["port"] == got["jax"]
    if name == "discovery_outage":
        assert fired == []  # the request path never touched discovery
    else:
        assert fired and fired == got["jax"][2]


async def test_dropped_frame_loses_its_tokens_as_jax():
    """A dropped DATA frame is lost on the wire: the stream completes
    with fewer tokens, the same ones missing in both packages."""
    rule = (5, ("request_plane.frame", "drop"),
            dict(after=2, times=1, match="generate"))
    got = await _both(lambda p: _faulted_vs_baseline(p, 8, rule, "drop"))
    base, faulted, fired = got["port"]
    assert fired == [("request_plane.frame", "drop", 1)]
    assert len(faulted) < len(base)
    assert got["port"] == got["jax"]


async def _engine_crash_dead_worker(p):
    fleet = await Fleet.start(p)
    try:
        plane = p.chaos.ChaosPlane(seed=13).rule(
            "engine.step", "fail", after=4, times=1,
            error="worker engine error: chaos crash on step N")
        with plane:
            await fleet.collect(greedy_req(p, "ch-5", 40))
        dead = [w for w in fleet.workers
                if w.engine._task is not None and w.engine._task.done()]
        outs = [o async for o in dead[0].engine.generate(
            greedy_req(p, "post-crash", 2))]
        return len(dead), outs[0].finish_reason, \
            p.is_migratable(RuntimeError(outs[0].error))
    finally:
        await fleet.close()


async def test_crashed_mocker_engine_fails_fast_migratable():
    got = await _both(_engine_crash_dead_worker)
    assert got["port"] == (1, "error", True) == got["jax"]


async def _exhausted(p):
    fleet = await Fleet.start(p, migration_limit=1)
    try:
        plane = p.chaos.ChaosPlane(seed=5).rule(
            "request_plane.dispatch", "fail",
            error="connection lost (chaos: dispatch)")  # unlimited
        with plane:
            with pytest.raises((p.runtime.EngineError, RuntimeError)) as ei:
                await fleet.collect(greedy_req(p, "ch-4", 8))
        return p.is_migratable(ei.value), plane.fired(), \
            type(ei.value).__name__
    finally:
        await fleet.close()


async def test_exhausted_migration_budget_fails_typed():
    got = await _both(_exhausted)
    assert got["port"] == (True, 2, got["jax"][2]) and \
        got["port"] == got["jax"]


async def _mocker_death(p):
    faulty = p.MockEngineArgs(fail_after_tokens=3, **BASE)
    healthy = p.MockEngineArgs(**BASE)
    fleet = await Fleet.start(p, worker_args=[faulty, healthy])
    try:
        faulty_id = fleet.workers[0].served.instance_id
        healthy_id = fleet.workers[1].served.instance_id

        async def route_healthy(req, avoid=()):
            return healthy_id

        fleet.pipeline.migration.route = route_healthy
        baseline = await fleet.collect(greedy_req(p, "ff-6", 10))
        picks = []

        async def route(req, avoid=()):
            iid = faulty_id if faulty_id not in avoid else healthy_id
            picks.append(iid)
            return iid

        fleet.pipeline.migration.route = route
        faulted = await fleet.collect(greedy_req(p, "ch-6", 10))
        assert picks[0] == faulty_id and picks[-1] == healthy_id
        assert fleet.workers[0].engine.dead
        return baseline, faulted
    finally:
        await fleet.close()


async def test_mocker_death_token_identical():
    got = await _both(_mocker_death)
    assert got["port"][0] == got["port"][1]
    assert got["port"] == got["jax"]


async def _flaky(p):
    fleet = await Fleet.start(
        p, migration_limit=30,
        worker_args=[p.MockEngineArgs(flaky=0.2, fault_seed=99, **BASE),
                     p.MockEngineArgs(flaky=0.2, fault_seed=77, **BASE)])
    clean = await Fleet.start(p)
    try:
        baselines = [await clean.collect(
            greedy_req(p, f"ff-7-{i}", 6, seed=100 + i)) for i in range(4)]
        before = sum(w.engines[0].metrics["requests"]
                     for w in fleet.workers)
        got = [await fleet.collect(
            greedy_req(p, f"ch-7-{i}", 6, seed=100 + i)) for i in range(4)]
        attempts = sum(w.engines[0].metrics["requests"]
                       for w in fleet.workers) - before
        return baselines, got, attempts
    finally:
        await clean.close()
        await fleet.close()


async def test_flaky_streams_all_complete_exactly():
    got = await _both(_flaky)
    baselines, faulted, attempts = got["port"]
    assert faulted == baselines
    assert attempts > 4, "no flaky drop ever fired"
    # the attempt counts depend on which worker round robin hands each
    # request, and instance ids are random: only the tokens compare
    assert got["port"][:2] == got["jax"][:2]


async def _wedged(p):
    wedgy = p.MockEngineArgs(wedge_after=4, **BASE)
    fleet = await Fleet.start(p, worker_args=[wedgy,
                                              p.MockEngineArgs(**BASE)])
    try:
        wedgy_id = fleet.workers[0].served.instance_id
        healthy_id = fleet.workers[1].served.instance_id

        async def route_healthy(req, avoid=()):
            return healthy_id

        fleet.pipeline.migration.route = route_healthy
        baseline = await fleet.collect(greedy_req(p, "ff-8", 10))
        fleet.pipeline.migration.stream_idle_s = 0.4

        async def route(req, avoid=()):
            return wedgy_id if wedgy_id not in avoid else healthy_id

        fleet.pipeline.migration.route = route
        faulted = await fleet.collect(greedy_req(p, "ch-8", 10))
        fleet.pipeline.migration.stream_idle_s = None
        return baseline, faulted
    finally:
        await fleet.close()


async def test_wedged_worker_rescued_by_idle_bound():
    got = await _both(_wedged)
    assert got["port"][0] == got["port"][1]
    assert got["port"] == got["jax"]


async def _file_watch_outage(p, root):
    disco = p.discovery.FileDiscovery(root, ttl_s=5.0, poll_s=0.05)
    await disco.start()
    try:
        await disco.put("v1/instances/a", {"v": 1})
        seen = {}
        cancel = asyncio.Event()

        async def follow():
            async for ev in disco.watch("v1/instances/", cancel=cancel):
                if ev.type == "put":
                    seen[ev.key] = ev.value

        task = asyncio.create_task(follow())
        await _until(lambda: "v1/instances/a" in seen, "the first put")
        plane = p.chaos.ChaosPlane(seed=21).rule(
            "discovery.op", "fail", match="get:v1/instances/", times=3,
            error="injected discovery outage")
        with plane:
            await disco.put("v1/instances/b", {"v": 2})
            await _until(lambda: "v1/instances/b" in seen,
                         "the put made during the outage")
        cancel.set()
        await asyncio.wait_for(task, timeout=5)
        return plane.fired(), seen["v1/instances/b"]
    finally:
        await disco.close()


async def test_file_discovery_watch_survives_transient_outage(tmp_path):
    got = {side: await _file_watch_outage(PKGS[side],
                                          str(tmp_path / side))
           for side in ("jax", "port")}
    assert got["port"] == (3, {"v": 2}) == got["jax"]


async def test_missed_heartbeats_expire_the_lease(tmp_path):
    """discovery.lease: a file-discovery process whose heartbeats fail
    lets its keys age past the TTL; a reader reaps them, and the keys
    come back once the beats resume."""
    owner = port_discovery.FileDiscovery(str(tmp_path), ttl_s=0.6,
                                         poll_s=0.05)
    reader = port_discovery.FileDiscovery(str(tmp_path), ttl_s=0.6,
                                          poll_s=0.05)
    await owner.start()
    try:
        await owner.put("v1/instances/w", {"v": 1})
        plane = port_chaos.ChaosPlane(seed=4).rule(
            "discovery.lease", "fail", error="injected missed beat")
        with plane:
            async def gone():
                return "v1/instances/w" not in await reader.get_prefix(
                    "v1/instances/")

            deadline = asyncio.get_running_loop().time() + 10
            while not await gone():
                assert asyncio.get_running_loop().time() < deadline, \
                    "the lease never expired while beats failed"
                await asyncio.sleep(0.1)
        assert plane.fired("discovery.lease") >= 1
        deadline = asyncio.get_running_loop().time() + 10
        while "v1/instances/w" not in await reader.get_prefix(
                "v1/instances/"):
            assert asyncio.get_running_loop().time() < deadline, \
                "the key never came back after the beats resumed"
            await asyncio.sleep(0.1)
    finally:
        await owner.close()
        await reader.close()


async def _drain(p):
    fleet = await Fleet.start(p, decode_s_per_seq=0.01)
    try:
        baseline = [await fleet.collect(
            greedy_req(p, f"ff-10-{i}", 12, seed=200 + i))
            for i in range(4)]
        tasks = [asyncio.create_task(fleet.collect(
            greedy_req(p, f"ch-10-{i}", 12, seed=200 + i)))
            for i in range(4)]
        await _until(lambda: any(e.num_active_seqs for w in fleet.workers
                                 for e in w.engines), "in-flight streams")
        drained = fleet.workers[0]
        key = drained.served.instance.key()
        await drained.drain(deadline_s=0.05)
        results = list(await asyncio.gather(*tasks))
        assert key not in await fleet.rt.discovery.get_prefix(
            "v1/instances")
        outs = [o async for o in drained.engines[0].generate(
            greedy_req(p, "post-drain", 2))]
        return baseline, results, outs[0].finish_reason, \
            "draining" in outs[0].error
    finally:
        await fleet.close()


async def test_drain_migrates_inflight_zero_client_errors():
    got = await _both(_drain)
    baseline, results, reason, marked = got["port"]
    assert results == baseline and reason == "error" and marked
    assert got["port"] == got["jax"]


async def test_sigterm_triggers_graceful_drain():
    """SIGTERM -> the port's install_drain_handler -> worker.drain(),
    with the in-flight stream completing on the survivor."""
    p = PKGS["port"]
    fleet = await Fleet.start(p, decode_s_per_seq=0.01)
    try:
        baseline = await fleet.collect(greedy_req(p, "ff-11", 12))
        drained = asyncio.Event()

        async def drain_all():
            await fleet.workers[0].drain(deadline_s=0.05)
            drained.set()

        p.aio.install_drain_handler(drain_all, signals=(signal.SIGTERM,))
        task = asyncio.create_task(fleet.collect(
            greedy_req(p, "ch-11", 12)))
        await _until(lambda: any(e.num_active_seqs for w in fleet.workers
                                 for e in w.engines), "in-flight streams")
        os.kill(os.getpid(), signal.SIGTERM)
        await asyncio.wait_for(drained.wait(), timeout=10)
        assert await asyncio.wait_for(task, timeout=10) == baseline
        asyncio.get_running_loop().remove_signal_handler(signal.SIGTERM)
    finally:
        await fleet.close()


async def _avoid_relaxes(p):
    fleet = await Fleet.start(p, migration_limit=6)
    try:
        ids = sorted(fleet.pipeline.client.instance_ids)
        seen = []

        async def route(req, avoid=()):
            seen.append(len(set(avoid)))
            for iid in ids:
                if iid not in avoid:
                    return iid
            raise AssertionError("avoid excluded everyone and was not "
                                 "relaxed")

        fleet.pipeline.migration.route = route
        plane = p.chaos.ChaosPlane(seed=31).rule(
            "request_plane.dispatch", "fail", times=2,
            error="connection lost (chaos: blip)")
        with plane:
            tokens = await fleet.collect(greedy_req(p, "ch-12", 8))
        return len(tokens), seen
    finally:
        await fleet.close()


async def test_avoid_set_relaxes_when_it_excludes_every_live_instance():
    got = await _both(_avoid_relaxes)
    assert got["port"] == (8, [0, 1, 0]) == got["jax"]


async def _backoff(p):
    fleet = await Fleet.start(p, migration_limit=2)
    try:
        fleet.pipeline.migration.retry_policy = p.retry.RetryPolicy(
            max_attempts=1 << 10, base_s=0.001, cap_s=0.002)
        plane = p.chaos.ChaosPlane(seed=37).rule(
            "request_plane.dispatch", "fail",
            error="connection lost (chaos)")
        with plane:
            with pytest.raises((p.runtime.EngineError, RuntimeError)):
                await fleet.collect(greedy_req(p, "ch-13", 4))
        return plane.fired()
    finally:
        await fleet.close()


async def test_migration_backoff_exhausts_the_budget():
    got = await _both(_backoff)
    assert got["port"] == 3 == got["jax"]


# ------------------------- TorchEngine scenarios --------------------------


def _torch_params():
    from dynamo_tpu_torch.models.convert import params_from_numpy
    from test_torch_overlap import FP32, _params

    return params_from_numpy(_params(), FP32, device="cpu")


async def _jax_greedy(prompt, n):
    """JaxEngine's greedy tokens on the tiny fp32 model (seed 7)."""
    from test_torch_overlap import _collect, _req, jax_engine

    eng = jax_engine()
    try:
        return await _collect(eng, _req(True, prompt, "jax-ref", n))
    finally:
        await eng.close()


async def _torch_worker(rt, component="backend", **over):
    from dynamo_tpu_torch.engine import EngineConfig
    from dynamo_tpu_torch.engine.worker import TorchEngineWorker
    from test_torch_overlap import COMMON, FP32

    return await TorchEngineWorker(
        rt, EngineConfig(model_config=FP32, **{**COMMON, **over}),
        component=component, params=_torch_params(),
        device="cpu").start()


@pytest.mark.allow_slow_callbacks
async def test_torch_engine_step_crash_migrates_token_identical():
    """engine.step "fail" on the TorchEngine that serves a request
    mid-decode: its loop dies, the stream errors with the migratable
    marker, the request replays on the other worker, and the greedy
    tokens equal the fault-free run's and JaxEngine's."""
    p = PKGS["port"]
    prompt = [5, 6, 7, 8]
    expect = await _jax_greedy(prompt, 40)
    rt = await fresh_runtime(p).start()
    workers = [await _torch_worker(rt) for _ in range(2)]
    manager = p.ModelManager()
    watcher = await p.ModelWatcher(rt, manager).start()
    try:
        name = workers[0].engine.config.served_name
        await _until(lambda: manager.get(name) is not None,
                     "the model's pipeline")
        pipeline = manager.get(name)
        await _until(lambda: len(pipeline.client.instances) == 2,
                     "2 routable instances")
        fleet = Fleet(p, rt, workers, watcher, pipeline)
        baseline = await fleet.collect(greedy_req(p, "ff", 40,
                                                  prompt=prompt))
        plane = p.chaos.ChaosPlane(seed=13).rule(
            "engine.step", "fail", after=4, times=1,
            error="worker engine error: chaos crash on step N")
        with plane:
            faulted = await fleet.collect(greedy_req(p, "ch", 40,
                                                     prompt=prompt))
        assert plane.fired() == 1
        assert faulted == baseline == expect
        dead = [w for w in workers if w.engine._task is not None
                and w.engine._task.done()]
        assert len(dead) == 1
        outs = [o async for o in dead[0].engine.generate(
            greedy_req(p, "post-crash", 2))]
        assert outs[0].finish_reason == "error"
        assert p.is_migratable(RuntimeError(outs[0].error))
    finally:
        await watcher.close()
        for w in workers:
            await w.close()
        await rt.shutdown()


async def _disagg_pull_run(rt, p, rid, prompt):
    from dynamo_tpu_torch.disagg.prefill_router import (
        ConditionalDisaggConfig,
        PrefillOrchestrator,
    )

    pclient = await (rt.namespace("dynamo").component("prefill")
                     .endpoint("generate").client()).start()
    dclient = await (rt.namespace("dynamo").component("backend")
                     .endpoint("generate").client()).start()
    orch = PrefillOrchestrator(
        pclient, ConditionalDisaggConfig(always_remote=True))
    try:
        routed = await orch.maybe_prefill(greedy_req(p, rid, 6,
                                                     prompt=prompt))
        assert routed.disaggregated_params is not None
        tokens = []
        async for item in dclient.generate(routed.to_dict()):
            out = p.protocols.LLMEngineOutput.from_dict(item)
            assert out.finish_reason != "error", out.error
            tokens.extend(out.token_ids)
        return tokens
    finally:
        await orch.close()
        await pclient.close()
        await dclient.close()


@pytest.mark.allow_slow_callbacks
async def test_kv_pull_chunk_failure_retry_then_fallback():
    """disagg.pull.chunk on the port's prefill -> decode pair: a pull
    failing once is absorbed by the retry (no local prefill), one that
    keeps failing falls back to local prefill; both streams equal the
    aggregated JaxEngine's.  Then the decode worker drains."""
    p = PKGS["port"]
    prompt = list(range(30, 52))
    expect = await _jax_greedy(prompt, 6)
    rt = await fresh_runtime(p).start()
    prefill_w = await _torch_worker(rt, "prefill", role="prefill")
    decode_w = await _torch_worker(rt, "backend", role="decode")
    try:
        plane = p.chaos.ChaosPlane(seed=17).rule(
            "disagg.pull.chunk", "fail", times=1,
            error="injected pull chunk failure")
        with plane:
            tokens = await _disagg_pull_run(rt, p, "chaos-pull-1", prompt)
        assert plane.fired() == 1
        assert tokens == expect
        assert decode_w.engine.metrics["prefill_tokens"] == 0, \
            "the retry should have absorbed the fault"

        plane = p.chaos.ChaosPlane(seed=19).rule(
            "disagg.pull.chunk", "fail",
            error="injected pull chunk failure")  # unlimited
        with plane:
            tokens = await _disagg_pull_run(rt, p, "chaos-pull-2", prompt)
        assert plane.fired() >= 3  # the whole retry budget
        assert tokens == expect
        assert decode_w.engine.metrics["prefill_tokens"] > 0, \
            "the fallback should have prefilled locally"

        key = decode_w.served.instance.key()
        await decode_w.drain(deadline_s=0.01)
        assert key not in await rt.discovery.get_prefix("v1/instances")
        outs = [o async for o in decode_w.engine.generate(
            greedy_req(p, "post-drain", 2))]
        assert outs[0].finish_reason == "error"
        assert "draining" in outs[0].error
    finally:
        await prefill_w.close()
        await decode_w.close()
        await rt.shutdown()


# ------------------------- one test for each seam -------------------------


def _blk(side, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(2, 4, 2, 8)).astype(np.float32)
            for _ in range(2))
    return (k, v) if side == "jax" else (torch.from_numpy(k),
                                         torch.from_numpy(v))


def _kvbm(side):
    if side == "jax":
        from dynamo_tpu.kvbm import manager, object_store, pools
    else:
        from dynamo_tpu_torch.kvbm import manager, object_store, pools
    return manager, object_store, pools


def _g4_corrupt(side, root):
    manager, object_store, pools = _kvbm(side)
    chaos = PKGS[side].chaos
    pool = object_store.ObjectStorePool(os.path.join(root, "pool"))
    k, v = _blk(side, 5)
    assert pool.put(0xABC, k, v)
    plane = chaos.ChaosPlane(seed=1).rule("kvbm.object_io", "corrupt",
                                          times=1, match="get:")
    with plane:
        with pytest.raises(pools.BlockIntegrityError, match="quarantined"):
            pool.get(0xABC)
    assert 0xABC not in pool and pool.get(0xABC) is None
    mgr = manager.TieredKvManager(host_blocks=2,
                                  object_dir=os.path.join(root, "g4"))
    try:
        seen = []
        mgr.on_corruption = lambda tier, h: seen.append((tier, h))
        mgr.g4.put(0xBEEF, k, v)
        plane = chaos.ChaosPlane(seed=2).rule(
            "kvbm.object_io", "corrupt", times=1, match="get:")
        with plane:
            got, events, src = mgr.fetch(0xBEEF)
        out = (got, events, src, seen, mgr.stats.get("g4_quarantined"),
               mgr.tier_states()["g4"], 0xBEEF in mgr.g4)
        mgr.g4.put(0xBEEF, k, v)  # a clean re-spill heals the namespace
        got2, _, src2 = mgr.fetch(0xBEEF)
        return out + (src2, [a.tolist() for a in got2]), \
            [(i.seam, i.key, i.action, i.n) for i in plane.injections]
    finally:
        mgr.close()


def test_g4_corrupt_is_quarantined_as_jax(tmp_path):
    """kvbm.object_io "corrupt": the crc (not the injector) catches it,
    the blob goes fleet-wide, the manager publishes removed(g4),
    attributes and recomputes; a data fault leaves the breaker closed."""
    got = {side: _g4_corrupt(side, str(tmp_path / side))
           for side in ("jax", "port")}
    (out, injections) = got["port"]
    assert out[:7] == (None, [([], [0xBEEF], "g4")], None,
                       [("g4", 0xBEEF)], 1, "closed", False)
    assert out[7] == "g4"
    assert got["port"] == got["jax"]


def _g4_stall(side, root, monkeypatch):
    import time

    manager, object_store, _ = _kvbm(side)
    chaos = PKGS[side].chaos
    monkeypatch.setattr(object_store, "_STALL_S", 0.05)
    mgr = manager.TieredKvManager(host_blocks=2, object_dir=root,
                                  io_deadline_s=0.01, breaker_threshold=3,
                                  breaker_cooldown_s=0.3)
    try:
        k, v = _blk(side, 13)
        mgr.g4.put(0xFEED, k, v)
        plane = chaos.ChaosPlane(seed=3).rule("kvbm.object_io", "stall",
                                              times=3, match="get:")
        with plane:
            misses = [mgr.fetch(0xFEED)[0] for _ in range(3)]
        seen = (misses, mgr.tier_states()["g4"], mgr.breaker.trips("g4"),
                mgr.io_failure_counters()[("g4", "timeout")],
                mgr.match_run([0xFEED]))
        time.sleep(0.35)  # cooldown, and the wedged I/O thread drains
        half = mgr.tier_states()["g4"]
        _, _, src = mgr.fetch(0xFEED)  # the single probe
        return seen + (half, src, mgr.tier_states()["g4"])
    finally:
        mgr.close()


def test_g4_stalls_hit_the_deadline_and_trip_the_breaker(tmp_path,
                                                         monkeypatch):
    """kvbm.object_io "stall": a hung mount turns into bounded timeouts;
    three trip the breaker (G4 advertises nothing), and after the
    cooldown one probe re-closes it."""
    got = {side: _g4_stall(side, str(tmp_path / side), monkeypatch)
           for side in ("jax", "port")}
    assert got["port"] == ([None] * 3, "open", 1, 3, 0, "half_open",
                           "g4", "closed")
    assert got["port"] == got["jax"]


def _sim_g4(side):
    if side == "jax":
        from dynamo_tpu.kvbm.breaker import TierBreaker
        from dynamo_tpu.mocker.kv_cache_sim import KvCacheSim, SimObjectStore
        from dynamo_tpu.obs.kv_ledger import KvLedger
    else:
        from dynamo_tpu_torch.kvbm.breaker import TierBreaker
        from dynamo_tpu_torch.mocker.kv_cache_sim import (
            KvCacheSim,
            SimObjectStore,
        )
        from dynamo_tpu_torch.obs.kv_ledger import KvLedger
    chaos = PKGS[side].chaos
    led, store, seen = KvLedger(), SimObjectStore(), []
    sim = KvCacheSim(num_blocks=8, ledger=led, object_store=store,
                     breaker=TierBreaker(("g4",), threshold=3),
                     g4_deadline_s=0.05,
                     on_corruption=lambda t, h: seen.append((t, h)))
    store.put(101)
    with chaos.ChaosPlane(seed=7).rule("kvbm.object_io", "corrupt",
                                       times=1, match="get:"):
        out = sim.allocate("s1", [101], 1)
    corrupt = (out.onboarded, out.tier_events, 101 in store, seen,
               led.violations_by_kind(), sim.breaker.state("g4"))
    clk = [0.0]
    br = TierBreaker(("g4",), threshold=3, cooldown_s=5.0,
                     clock=lambda: clk[0])
    store = SimObjectStore()
    sim = KvCacheSim(num_blocks=16, object_store=store, breaker=br,
                     g4_deadline_s=0.05)
    for h in (201, 202, 203, 204):
        store.put(h)
    with chaos.ChaosPlane(seed=8).rule("kvbm.object_io", "stall",
                                       times=3, match="get:"):
        for i, h in enumerate((201, 202, 203)):
            sim.allocate(f"s{i}", [h], 1)
    stall = (round(sim.io_penalty_s, 9), sim.io_failures, br.state("g4"),
             sim.allocate("s4", [204], 1).onboarded)
    clk[0] = 5.0
    sim.free("s4")
    sim.clear_cached()
    return corrupt, stall, sim.allocate("s5", [204], 1).onboarded, \
        br.state("g4")


def test_mocker_sim_g4_corrupt_and_stall_equal_jax():
    """The mocker's kvbm.object_io lookups: corrupt quarantines and
    attributes, stalls charge the deadline as simulated time and trip
    the breaker."""
    got = {side: _sim_g4(side) for side in ("jax", "port")}
    corrupt, stall, onboarded, state = got["port"]
    assert corrupt[0] == {} and 101 not in [corrupt[2]]
    assert stall[:3] == (0.15, {"timeout": 3}, "open")
    assert onboarded == {"g4": 1} and state == "closed"
    assert got["port"] == got["jax"]


async def _remote_corrupt(side):
    if side == "jax":
        from dynamo_tpu.kvbm import remote
    else:
        from dynamo_tpu_torch.kvbm import remote
    chaos = PKGS[side].chaos
    k, v = _blk(side, 15)

    class FakeClient:
        async def generate(self, payload, instance_id=None):
            for h in payload["hashes"]:
                yield remote.encode_block(h, k, v)

    idx = remote.RemoteBlockIndex(None, "ns", "comp", self_worker_id=0)
    for h in (10, 11):
        idx.holders.setdefault(h, {}).setdefault(5, set()).add("g2")
    puller = remote.RemoteKvbmPuller(idx, FakeClient(), timeout_s=2.0)
    seen = []
    puller.on_corruption = lambda tier, h: seen.append((tier, h))
    # every frame from peer 5 decodes corrupt (retries included)
    with chaos.ChaosPlane(seed=4).rule("kvbm.remote_pull", "corrupt",
                                       match="5:"):
        out = await puller.fetch_run([10, 11])
    dropped = 5 not in idx.holders.get(10, {})
    for h in (10, 11):
        idx.holders.setdefault(h, {}).setdefault(5, set()).add("g2")
    out2 = await puller.fetch_run([10, 11])
    return out, idx.suspects.get(5, 0) >= 1, dropped, seen[:1], \
        [b[0] for b in out2], [a.tolist() for a in out2[0][1:]]


async def test_remote_pull_corrupt_frame_marks_the_source_suspect():
    """kvbm.remote_pull "corrupt": the wire crc catches the flipped
    byte, the peer is marked suspect before the retry policy runs, and
    the corruption is attributed to tier "remote"."""
    got = {side: await _remote_corrupt(side) for side in ("jax", "port")}
    assert got["port"][:5] == ([], True, True, [("remote", 10)], [10, 11])
    assert got["port"] == got["jax"]


def _kv_account(side, kind):
    if side == "jax":
        from dynamo_tpu.engine.block_allocator import BlockAllocator
        from dynamo_tpu.obs.kv_ledger import KvLedger
    else:
        from dynamo_tpu_torch.engine.block_allocator import BlockAllocator
        from dynamo_tpu_torch.obs.kv_ledger import KvLedger
    chaos = PKGS[side].chaos
    led = KvLedger()
    a = BlockAllocator(16, ledger=led)
    plane = chaos.ChaosPlane(seed=3).rule("engine.kv_account", "drop",
                                          match=f"{kind}:", times=1)
    with plane:
        a.allocate("victim", [], 3)
        a.free("victim")
    viol = led.audit_allocator(a, live_seqs=[])
    report = led.finish_audit(viol, where="test")
    return plane.fired("engine.kv_account"), report["clean"], viol, \
        led.violations_by_kind()


@pytest.mark.parametrize("kind", ["leak", "double_free", "orphan",
                                  "refcount_drift"])
def test_kv_account_faults_get_jax_audit_findings(kind):
    """engine.kv_account "drop" seeds each accounting fault class in the
    port's BlockAllocator; the port's auditor names it with the same
    findings as JAX's."""
    got = {side: _kv_account(side, kind) for side in ("jax", "port")}
    fired, clean, viol, totals = got["port"]
    expect = kind.replace("_", "-")
    assert fired == 1 and not clean
    assert expect in {v["kind"] for v in viol}
    assert totals[expect]["g1"] >= 1
    assert got["port"] == got["jax"]


@pytest.mark.allow_slow_callbacks
async def test_kv_account_faults_named_by_the_engine_audit():
    """The four classes seeded one after another into a TorchEngine
    with the ledger on are each named by `engine.audit_kv()`, in an
    order where no fault feeds the next: a refcount drift and a leak
    keep their blocks off the free list, an orphan puts a block the
    ledger still owns back on it, a double free breaks the free list
    for whatever follows."""
    from test_torch_overlap import _collect, _req, torch_engine

    eng = torch_engine()
    try:
        await _collect(eng, _req(False, [9, 8, 7], "warm", 2))
        for i, kind in enumerate(["refcount_drift", "leak", "orphan",
                                  "double_free"]):
            plane = port_chaos.ChaosPlane(seed=i).rule(
                "engine.kv_account", "drop", match=f"{kind}:", times=1)
            with plane:
                await _collect(eng, _req(False, [20 + i, 3, 4, 5, 6],
                                         f"victim-{kind}", 3))
                # the slot is freed a step after its last frame
                await _until(lambda: eng.num_active_seqs == 0,
                             f"the free of victim-{kind}")
            assert plane.fired() == 1, kind
            report = await eng.audit_kv()
            assert kind.replace("_", "-") in \
                {v["kind"] for v in report["violations"]}, (kind, report)
    finally:
        await eng.close()


def _planner_mods(side):
    if side == "jax":
        import dynamo_tpu.planner as planner
        import dynamo_tpu.planner.metrics as pmetrics
        import dynamo_tpu.planner.predictor as predictor
    else:
        import dynamo_tpu_torch.planner as planner
        import dynamo_tpu_torch.planner.metrics as pmetrics
        import dynamo_tpu_torch.planner.predictor as predictor
    return planner, pmetrics, predictor


async def _planner_scale_fault(side):
    from collections import deque

    from test_planner_actuation import _FakeConnector

    planner, pmetrics, predictor = _planner_mods(side)
    chaos = PKGS[side].chaos
    conn = _FakeConnector(replicas=1)
    p = planner.Planner.__new__(planner.Planner)
    p.config = planner.PlannerConfig(min_replicas=1, max_replicas=4,
                                     cooldown_s=0.0,
                                     target_active_per_replica=2.0)
    p.connector = conn
    load = pmetrics.AggregateLoad(workers=1, active_seqs=8,
                                  mean_kv_usage=0.1)
    p.observer = types.SimpleNamespace(aggregate=lambda: load)
    p.predictor = predictor.make_predictor("constant")
    p._task, p._last_action_t, p._low_ticks = None, 0.0, 0
    p.decisions = deque()
    plane = chaos.ChaosPlane(seed=5).rule("planner.scale", "fail",
                                          times=1)
    with plane:
        with pytest.raises(chaos.ChaosError):
            await p.tick()
        untouched = list(conn.calls)
        retried = await p.tick()
    return untouched, retried, conn.calls


async def test_planner_scale_fault_is_survived_by_the_loop():
    """planner.scale "fail": the tick raises before EXECUTE, the next
    tick retries clean."""
    got = {side: await _planner_scale_fault(side)
           for side in ("jax", "port")}
    assert got["port"] == ([], 3, [("scale", 3)]) == got["jax"]


async def _spawn_fault(side):
    planner, _, _ = _planner_mods(side)
    chaos = PKGS[side].chaos
    rt = await fresh_runtime(PKGS[side]).start()
    try:
        async def bad_spawn():
            raise AssertionError("unreachable: chaos fails first")

        async def stop(w):
            pass

        conn = planner.CallbackConnector(
            bad_spawn, stop, governor=planner.SpawnGovernor(
                backoff_base_s=0.05, backoff_max_s=0.2,
                breaker_threshold=3, breaker_reset_s=30.0))
        pl = planner.Planner(
            rt, "dynamo", "mocker", conn,
            config=planner.PlannerConfig(min_replicas=2, max_replicas=4,
                                         cooldown_s=0.0, quarantine=False))
        await pl.observer.start()
        plane = chaos.ChaosPlane(seed=1).rule("connector.spawn", "fail")
        with plane:
            for _ in range(12):
                await pl.tick()
                await asyncio.sleep(0.03)
        out = (plane.fired("connector.spawn"), conn.governor.breaker_open,
               pl.last_diag["spawn"]["breaker_open"],
               pl.debug_state()["spawn"]["breaker_open"])
        await pl.close()
        await conn.close()
        return out
    finally:
        await rt.shutdown()


async def test_spawn_faults_are_absorbed_by_the_governor():
    """connector.spawn "fail" on every spawn: the governor backs off and
    its breaker opens after three, instead of a spawn each tick."""
    got = {side: await _spawn_fault(side) for side in ("jax", "port")}
    assert got["port"] == (3, True, True, True) == got["jax"]


async def _drain_wedge(side):
    planner, _, _ = _planner_mods(side)
    p = PKGS[side]
    rt = await fresh_runtime(p).start()
    try:
        args = p.MockEngineArgs(**{**BASE, "decode_s_per_seq": 0.01})
        conn = planner.CallbackConnector(
            spawn=lambda: p.MockerWorker(rt, args,
                                         migration_limit=3).start(),
            stop=lambda w: w.close(),
            drain=lambda w, d: w.drain(deadline_s=d),
            drain_deadline_s=0.15, drain_escalate_margin_s=0.2)
        await conn.scale(2)
        manager = p.ModelManager()
        watcher = await p.ModelWatcher(rt, manager).start()
        await _until(lambda: manager.get("chaos-model") is not None,
                     "the model's pipeline")
        pipeline = manager.get("chaos-model")
        await _until(lambda: len(pipeline.client.instances) == 2,
                     "2 routable instances")
        fleet = Fleet(p, rt, [], watcher, pipeline)
        baseline = [await fleet.collect(
            greedy_req(p, f"ff2-{i}", 12, seed=400 + i)) for i in range(3)]
        plane = p.chaos.ChaosPlane(seed=7).rule("worker.drain", "wedge",
                                                times=1)
        with plane:
            tasks = [asyncio.create_task(fleet.collect(
                greedy_req(p, f"ch2-{i}", 12, seed=400 + i)))
                for i in range(3)]
            await _until(lambda: any(e.num_active_seqs for w in conn.handles
                                     for e in w.engines),
                         "in-flight streams")
            applied = await conn.drain(1)
            results = list(await asyncio.gather(*tasks))
        await watcher.close()
        await conn.close()
        return applied, plane.fired("worker.drain"), \
            conn.drain_escalations, results == baseline, results
    finally:
        await rt.shutdown()


async def test_wedged_drain_escalates_to_stop_token_identical():
    """worker.drain "wedge": the victim ignores drain, the connector's
    bounded wait escalates to the hard stop, and the orphaned streams
    migrate token-identically."""
    got = {side: await _drain_wedge(side) for side in ("jax", "port")}
    assert got["port"][:4] == (1, 1, 1, True)
    assert got["port"] == got["jax"]


async def test_classifier_seam_fault_degrades_to_round_robin():
    """grouter.classify "fail": the port's global router degrades to
    round robin over the pools, with the same bytes as a healthy
    route."""
    from test_torch_global_router import (
        MODEL,
        fetch,
        start_grouter,
        start_pool,
        stop_pool,
    )

    import aiohttp

    cluster = uuid.uuid4().hex
    p0 = await start_pool(cluster, "pool0")
    grt, grouter = await start_grouter(cluster, [p0], 1)
    url = f"http://127.0.0.1:{grouter.port}"
    body = {"model": MODEL, "prompt": "hello world", "max_tokens": 4,
            "stream": True, "seed": 5}
    plane = port_chaos.ChaosPlane(seed=7).rule("grouter.classify", "fail",
                                               times=1)
    try:
        async with aiohttp.ClientSession() as s:
            with plane:
                first = await fetch(s, url, body)
                second = await fetch(s, url, body)
        assert plane.fired() == 1
        assert first[0] == 200 and first == second
        routed = dict(grouter._routed)
        assert routed.get(("pool0", "classify_error_rr")) == 1
        assert routed.get(("pool0", "only_pool")) == 1
    finally:
        await grouter.close()
        await grt.shutdown()
        await stop_pool(p0)


async def test_snapshot_fault_is_survived_and_retried():
    """router_sync.snapshot "fail": the peer drops that one answer and
    stays alive; the joiner's subscribe retry converges."""
    from dynamo_tpu_torch.router.replica_sync import RouterReplicaSync
    from dynamo_tpu_torch.router.sequences import ActiveSequences

    cluster = uuid.uuid4().hex
    stacks = []

    async def make_sync(router_id):
        rt = await port_runtime.DistributedRuntime(
            config=port_runtime.RuntimeConfig(discovery_backend="mem",
                                              event_plane="inproc"),
            cluster_id=cluster).start()
        seqs = ActiveSequences()
        sync = await RouterReplicaSync(rt, "ns", "comp", seqs,
                                       router_id=router_id,
                                       peer_ttl_s=5.0).start()
        stacks.append((rt, sync))
        return seqs, sync

    try:
        _, a = await make_sync("ra")
        plane = port_chaos.ChaosPlane(seed=3).rule("router_sync.snapshot",
                                                   "fail", times=1)
        a.publish_add("s1", worker_id=0, blocks=2, overlap_blocks=0)
        with plane:
            b_seqs, _ = await make_sync("rb")
            await _until(lambda: "s1@ra" in b_seqs._reqs,
                         "the joiner's snapshot after the fault")
            assert plane.fired() == 1
            a.publish_add("s2", worker_id=0, blocks=2, overlap_blocks=0)
            await _until(lambda: "s2@ra" in b_seqs._reqs,
                         "live traffic after the fault")
    finally:
        for rt, sync in stacks:
            await sync.close()
            await rt.shutdown()


def test_every_seam_is_wired_in_the_port():
    """Each registered seam is named by a hit()/ahit() call in the
    port's sources, at the JAX call sites' counterparts, and every seam
    a call names is registered: the literals the JAX package's lint
    checks statically, checked here over the port."""
    import ast
    from pathlib import Path

    root = Path(port_chaos.__file__).parents[1]
    sites = {}
    for path in root.rglob("*.py"):
        rel = path.relative_to(root)
        if rel.parts[0] in ("chaos", "_build"):  # _build: build outputs
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("hit", "ahit")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "chaos"):
                seam = node.args[0].value
                sites.setdefault(seam, set()).add(
                    str(path.relative_to(root)))
    assert set(sites) == set(port_chaos.SEAMS)
    assert sites == {
        "request_plane.dispatch": {"runtime/component.py"},
        "request_plane.frame": {"runtime/request_plane.py"},
        "discovery.op": {"runtime/discovery.py", "runtime/etcd.py"},
        "discovery.lease": {"runtime/discovery.py", "runtime/etcd.py"},
        "disagg.pull.chunk": {"engine/core.py"},
        "kvbm.remote_pull": {"kvbm/remote.py"},
        "kvbm.object_io": {"kvbm/object_store.py",
                           "mocker/kv_cache_sim.py"},
        "engine.step": {"engine/core.py", "mocker/engine.py"},
        "engine.kv_account": {"engine/block_allocator.py"},
        "planner.scale": {"planner/planner.py"},
        "connector.spawn": {"planner/connectors.py"},
        "worker.drain": {"engine/worker.py", "mocker/worker.py"},
        "grouter.classify": {"global_router/service.py"},
        "router_sync.snapshot": {"router/replica_sync.py"},
    }


async def test_etcd_missed_keepalives_expire_then_reregister():
    """discovery.lease and discovery.op on the etcd backend: failed
    keepalives let the lease expire (a watcher sees the delete), the
    next keepalive re-registers the keys; a failed op reaches its
    caller as the injected error."""
    from fake_etcd import FakeEtcd

    from dynamo_tpu_torch.runtime.etcd import EtcdDiscovery

    fake = await FakeEtcd().start()
    owner = EtcdDiscovery(fake.endpoint, ttl_s=1.0)
    reader = EtcdDiscovery(fake.endpoint, ttl_s=5.0)
    key = "v1/instances/ns/w/e/7"
    try:
        await owner.put(key, {"instance_id": 7})
        plane = port_chaos.ChaosPlane(seed=9).rule(
            "discovery.lease", "fail", times=6,
            error="injected missed keepalive")
        with plane:
            deadline = asyncio.get_running_loop().time() + 10
            while key in await reader.get_prefix("v1/instances/"):
                assert asyncio.get_running_loop().time() < deadline, \
                    "the lease never expired while keepalives failed"
                await asyncio.sleep(0.1)
        assert plane.fired("discovery.lease") >= 1
        deadline = asyncio.get_running_loop().time() + 10
        while key not in await reader.get_prefix("v1/instances/"):
            assert asyncio.get_running_loop().time() < deadline, \
                "the keys never came back after the keepalives resumed"
            await asyncio.sleep(0.1)
        plane = port_chaos.ChaosPlane(seed=10).rule(
            "discovery.op", "fail", times=1, match="get:",
            error="injected discovery outage")
        with plane:
            with pytest.raises(port_chaos.ChaosError,
                               match="discovery outage"):
                await reader.get_prefix("v1/instances/")
            assert key in await reader.get_prefix("v1/instances/")
    finally:
        await owner.close()
        await reader.close()
        await fake.close()

"""The port's session affinity against the JAX package's (CPU).

The scenarios of tests/test_affinity.py run against both packages'
`AffinityCoordinator` and `SessionAffinityRouter` (parametrized by
`impl`), each over its own runtime with two stub workers: the headers,
bind / release / TTL expiry, concurrent first requests waiting for the
winner's bind, abort waking waiters, the capacity and id caps, replica
sync between two coordinators over the event plane, sticky routing with
failover to the survivor, the migration avoid set beating the binding,
`x-dynamo-session-final` evicting it, and the TTL reaper.  Then both
frontends with `session_affinity_ttl` over two port stub workers
(tests/torch_fleet.py): the watcher wraps the KV route (its indexer
passed through), and a session's turns stay on one worker until the
final turn releases the binding, alike.
"""

import asyncio
import types
import uuid

import pytest

from torch_fleet import LoopThread, wait_for

IMPLS = ("jax", "port")


def _pkg(impl: str):
    """The names a scenario needs, from one package."""
    if impl == "jax":
        from dynamo_tpu.frontend import affinity
        from dynamo_tpu.protocols import (
            LLMEngineOutput,
            PreprocessedRequest,
            StopConditions,
        )
        from dynamo_tpu.runtime import (
            DistributedRuntime,
            RouterMode,
            RuntimeConfig,
        )
    else:
        from dynamo_tpu_torch.frontend import affinity
        from dynamo_tpu_torch.protocols import (
            LLMEngineOutput,
            PreprocessedRequest,
            StopConditions,
        )
        from dynamo_tpu_torch.runtime import (
            DistributedRuntime,
            RouterMode,
            RuntimeConfig,
        )
    return types.SimpleNamespace(
        affinity=affinity, Coordinator=affinity.AffinityCoordinator,
        Router=affinity.SessionAffinityRouter,
        headers=affinity.session_affinity_from_headers,
        Output=LLMEngineOutput, Request=PreprocessedRequest,
        Stop=StopConditions, Runtime=DistributedRuntime,
        Mode=RouterMode, Config=RuntimeConfig)


async def _runtime(p):
    return await p.Runtime(config=p.Config(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()


HEADER_CASES = [
    {},
    {"x-dynamo-session-id": "d1", "x-claude-code-session-id": "c1"},
    {"x-claude-code-session-id": "root", "x-claude-code-agent-id": "sub"},
    {"session-id": "codex"},
    {"x-session-id": "oc"},
    {"x-session-id": "oc", "x-dynamo-session-final": "true"},
    {"x-session-id": "  "},
    {"x-dynamo-session-final": "yes"},
]


@pytest.mark.parametrize("headers", HEADER_CASES)
def test_header_extraction_equals_jax(headers):
    assert _pkg("port").headers(headers) == _pkg("jax").headers(headers)


@pytest.mark.parametrize("impl", IMPLS)
async def test_bind_release_ttl_expiry(impl):
    coord = _pkg(impl).Coordinator(ttl_s=1.0).start()
    e = await coord.acquire("s1")
    assert e is not None and not e.bound
    coord.bind("s1", e, 42)
    e2 = await coord.acquire("s1")
    assert e2.bound and e2.worker_id == 42
    coord.release("s1", e2)
    coord.release("s1", e)
    e3 = await coord.acquire("s1")
    assert e3.worker_id == 42
    coord.release("s1", e3)
    e3.idle_deadline = 0.0  # force expiry
    e4 = await coord.acquire("s1")
    assert not e4.bound
    coord.abort("s1", e4)
    await coord.close()


@pytest.mark.parametrize("impl", IMPLS)
async def test_concurrent_first_requests_converge(impl):
    coord = _pkg(impl).Coordinator(ttl_s=5.0).start()
    e1 = await coord.acquire("s")
    got = []

    async def second():
        e = await coord.acquire("s")
        got.append(e.worker_id)

    t = asyncio.create_task(second())
    await asyncio.sleep(0.05)
    assert not got  # blocked on the initializing entry
    coord.bind("s", e1, 7)
    await asyncio.wait_for(t, 2.0)
    assert got == [7]
    await coord.close()


@pytest.mark.parametrize("impl", IMPLS)
async def test_abort_unblocks_waiters(impl):
    coord = _pkg(impl).Coordinator(ttl_s=5.0).start()
    e1 = await coord.acquire("s")
    t = asyncio.create_task(coord.acquire("s"))
    await asyncio.sleep(0.02)
    coord.abort("s", e1)
    e2 = await asyncio.wait_for(t, 2.0)
    assert e2 is not None and not e2.bound
    coord.abort("s", e2)
    await coord.close()


@pytest.mark.parametrize("impl", IMPLS)
async def test_capacity_and_id_caps_skip_affinity(impl):
    p = _pkg(impl)
    coord = p.Coordinator(ttl_s=60.0, max_entries=2).start()
    for i in range(2):
        e = await coord.acquire(f"s{i}")
        coord.bind(f"s{i}", e, i)
        coord.release(f"s{i}", e)
    assert await coord.acquire("s-over") is None
    assert await coord.acquire("x" * 300) is None
    with pytest.raises(ValueError):
        p.Coordinator(ttl_s=0.5)
    await coord.close()


@pytest.mark.parametrize("impl", IMPLS)
async def test_reaper_purges_idle_bindings(impl):
    coord = _pkg(impl).Coordinator(ttl_s=1.0).start()
    e = await coord.acquire("s")
    coord.bind("s", e, 3)
    coord.release("s", e)
    e.idle_deadline = 0.0
    await wait_for(lambda: "s" not in coord.entries, "the reaper's purge",
                   timeout=5.0)
    await coord.close()


@pytest.mark.parametrize("impl", IMPLS)
async def test_replica_sync_converges(impl):
    p = _pkg(impl)
    rt = await _runtime(p)
    try:
        a = p.Coordinator(ttl_s=30.0).start()
        b = p.Coordinator(ttl_s=30.0).start()
        await a.enable_replica_sync(rt, "ns", "comp")
        await b.enable_replica_sync(rt, "ns", "comp")
        e = await a.acquire("shared")
        a.bind("shared", e, 99)
        a.release("shared", e)
        await wait_for(lambda: b.entries.get("shared") is not None
                       and b.entries["shared"].bound, "the remote bind")
        be = await b.acquire("shared")
        assert be.bound and be.worker_id == 99
        b.release("shared", be)
        # an invalidate converges too (b's entry is idle)
        a.invalidate("shared", a.entries["shared"])
        await wait_for(lambda: "shared" not in b.entries,
                       "the remote invalidate")
        await a.close()
        await b.close()
    finally:
        await rt.shutdown()


async def _stub_fleet(p, rt, n=2):
    """n stub workers on `rt` (component "stubs"), each counting the
    requests it served; (served endpoints, counts, client)."""
    counts = {}
    served = []
    for iid in range(1, n + 1):
        counts[iid] = 0

        async def gen(payload, ctx, _iid=iid):
            counts[_iid] += 1
            yield p.Output(token_ids=[65], finish_reason="length").to_dict()

        served.append(await rt.namespace("dynamo").component(
            "stubs").endpoint("generate").serve_endpoint(gen,
                                                         instance_id=iid))
    client = await rt.namespace("dynamo").component("stubs").endpoint(
        "generate").client(p.Mode.ROUND_ROBIN).start()
    await wait_for(lambda: len(client.instances) >= n, "the stub workers")
    return served, counts, client


def _req(p, rid, sid=None, final=False):
    return p.Request(token_ids=list(range(8)), request_id=rid,
                     stop=p.Stop(max_tokens=2), session_id=sid,
                     session_final=final)


@pytest.mark.parametrize("impl", IMPLS)
async def test_sticky_routing_and_failover(impl):
    p = _pkg(impl)
    rt = await _runtime(p)
    try:
        served, _, client = await _stub_fleet(p, rt)
        router = p.Router(p.Coordinator(ttl_s=30.0).start(), client)
        first = await router(_req(p, "r1", sid="sess"))
        assert first in client.instance_ids
        router.complete("r1")
        for i in range(4):
            assert await router(_req(p, f"r{i + 2}", sid="sess")) == first
            router.complete(f"r{i + 2}")
        assert await router(_req(p, "n0")) is None  # no session, no pin
        dead = next(s for s in served if s.instance_id == first)
        await dead.shutdown()
        await wait_for(lambda: first not in client.instance_ids,
                       "the bound worker gone")
        second = await router(_req(p, "rf", sid="sess"))
        assert second != first and second in client.instance_ids
        router.complete("rf")
        await router.close()
        await client.close()
    finally:
        await rt.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
async def test_avoid_set_overrides_binding(impl):
    p = _pkg(impl)
    rt = await _runtime(p)
    try:
        _, _, client = await _stub_fleet(p, rt)
        router = p.Router(p.Coordinator(ttl_s=30.0).start(), client)
        first = await router(_req(p, "r1", sid="s"))
        second = await router(_req(p, "r1", sid="s"), avoid={first})
        assert second != first
        router.complete("r1")
        assert await router(_req(p, "r2", sid="s")) == second
        router.complete("r2")
        await router.close()
        await client.close()
    finally:
        await rt.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
async def test_session_final_evicts_binding(impl):
    p = _pkg(impl)
    rt = await _runtime(p)
    try:
        _, _, client = await _stub_fleet(p, rt)
        coord = p.Coordinator(ttl_s=30.0).start()
        router = p.Router(coord, client)
        await router(_req(p, "r1", sid="s", final=True))
        assert coord.entries["s"].bound
        router.complete("r1")
        assert "s" not in coord.entries
        await router.close()
        await client.close()
    finally:
        await rt.shutdown()


# ---------------------------------------------------------------------------
# both frontends with a session-affinity TTL
# ---------------------------------------------------------------------------


def test_http_session_turns_stay_on_one_worker_alike(tmp_path):
    from dynamo_tpu.frontend.affinity import \
        SessionAffinityRouter as JaxAffinityRouter
    from dynamo_tpu_torch.frontend.affinity import SessionAffinityRouter
    from dynamo_tpu_torch.protocols import ModelDeploymentCard
    from dynamo_tpu_torch.protocols.model_card import register_model
    from torch_fleet import Frontends

    p = _pkg("port")
    loop = LoopThread()

    async def run():
        fe = await Frontends().start(
            tmp_path, jax_watch={"session_affinity_ttl": 30.0},
            port_watch={"session_affinity_ttl": 30.0})
        try:
            _, counts, client = await _stub_fleet(p, fe.prt)
            await client.close()
            await register_model(fe.prt, ModelDeploymentCard(
                name="aff", component="stubs"))
            await fe.wait_model("aff", n=2)
            routes = [m.get("aff").migration.route for m in fe.managers]
            kinds = [type(r) for r in routes]
            passed = [r.indexer is r.inner.indexer is not None
                      for r in routes]
            body = {"model": "aff", "max_tokens": 2, "ignore_eos": True,
                    "messages": [{"role": "user", "content": "hi"}]}
            out = []
            for url, route in zip(fe.urls, routes):
                before = dict(counts)
                statuses = []
                for turn in range(4):
                    hdrs = {"x-claude-code-session-id": f"cc-{url}"}
                    if turn == 3:
                        hdrs["x-dynamo-session-final"] = "1"
                    async with fe.session.post(
                            url + "/v1/chat/completions", json=body,
                            headers=hdrs) as r:
                        statuses.append(r.status)
                    if turn == 2:
                        bound = route.coordinator.entries[
                            f"cc-{url}"].bound
                got = sorted(counts[i] - before[i] for i in counts)
                out.append((statuses, got, bound,
                            f"cc-{url}" in route.coordinator.entries))
            return kinds, passed, out
        finally:
            await fe.close()

    try:
        kinds, passed, out = loop.run(run())
    finally:
        loop.close()
    assert kinds == [JaxAffinityRouter, SessionAffinityRouter]
    assert passed == [True, True]
    for statuses, got, bound, left in out:
        assert statuses == [200] * 4
        assert got == [0, 4] and bound and not left

"""The port's standalone router (`python -m dynamo_tpu_torch.router`)
against JAX's (`python -m dynamo_tpu.router`), on the CPU.

Two of the port's mocker workers serve the `backend` component over
file discovery and the zmq event plane in the test's process.  Each
package's router CLI runs as two processes of its own (two router
instances, as replicas behind one fleet), one package after the other,
and answers the same requests; exact equality is the tolerance:

* requests that follow a prompt warmed on one worker get the same
  `instance_id`, `request_blocks` and `overlap_blocks` from both
  packages, and `mark_prefill_completed`/`free` answer `{"ok": true}`;
* affinity: a request held (not freed) at one instance steers that
  instance's next cold pick to the other worker; a `free` sent to the
  other instance leaves it held; a `free` sent to its own instance
  releases it — the same answers in both packages;
* the `no_workers_available` answer, with the selector made to choose
  nothing (in both packages no unpatched request reaches it: the
  handler passes no avoid set and the selector relaxes one that
  excludes every worker), from each package's `main()` in-process.
"""

import asyncio
import os
import sys
import uuid

import pytest

import dynamo_tpu.protocols as jax_protocols
import dynamo_tpu.router.__main__ as jax_main
import dynamo_tpu.router.kv_router as jax_kv_router
import dynamo_tpu.runtime as jax_runtime
import dynamo_tpu_torch.router.__main__ as port_main
import dynamo_tpu_torch.router.kv_router as port_kv_router
from dynamo_tpu_torch.mocker import MockEngineArgs, MockerWorker
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

BLOCK = 16
READY_S = 120.0  # a router CLI's ready line beside six busy test workers
WAIT_S = 30.0
MODULES = {"jax": "dynamo_tpu.router", "port": "dynamo_tpu_torch.router"}

WARM_A = list(range(100, 164))    # 4 blocks, warmed on worker 0
WARM_B = list(range(300, 364))    # 4 blocks, warmed on worker 1


def _req(rid, tokens, n=4):
    return PreprocessedRequest(
        token_ids=list(tokens), request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=n, ignore_eos=True))


# prompts whose best worker is decided by the warmed prefixes
ROUTED = [
    ("a-full", WARM_A + [7, 8, 9]),
    ("b-full", WARM_B + [1, 2]),
    ("a-half", WARM_A[:32] + [500 + i for i in range(20)]),
    ("b-two", WARM_B[:BLOCK]),
    ("a-exact", WARM_A),
]


async def _one(client, payload):
    out = [item async for item in client.generate(payload)]
    assert len(out) == 1, out
    return out[0]


async def _until(coro_fn, what):
    deadline = asyncio.get_running_loop().time() + WAIT_S
    while True:
        got = await coro_fn()
        if got:
            return got
        assert asyncio.get_running_loop().time() < deadline, \
            f"{what} never came within {WAIT_S:.0f} s"
        await asyncio.sleep(0.1)


async def _start_router(module, component, env):
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", module, "--block-size", str(BLOCK),
        "--router-component", component, env=env,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), READY_S)
    except asyncio.TimeoutError:
        line = b""
    if not line.startswith(b"ready instance_id="):
        proc.kill()
        await proc.wait()
        raise AssertionError(f"no ready line from {module} "
                             f"({component}) within {READY_S:.0f} s")
    return proc, int(line.split(b"=", 1)[1])


async def _stop(proc):
    if proc.returncode is None:
        proc.terminate()
        try:
            await asyncio.wait_for(proc.wait(), 20)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()


async def _side(rt, env, module, workers):
    """Two router instances of one package; the same questions."""
    comps = ("r1-" + uuid.uuid4().hex[:6], "r2-" + uuid.uuid4().hex[:6])
    procs = []
    clients = {}
    try:
        for comp in comps:
            procs.append(await _start_router(module, comp, env))
        for comp in comps:
            ns = rt.namespace("dynamo").component(comp)
            clients[comp] = {ep: await ns.endpoint(ep).client().start()
                             for ep in ("find_best_worker",
                                        "mark_prefill_completed", "free")}
            await clients[comp]["find_best_worker"].wait_for_instances(
                timeout=WAIT_S)
        r1, r2 = (clients[c] for c in comps)
        ids = {procs[0][1]: "r1", procs[1][1]: "r2"}

        async def pick(c, rid, tokens):
            ans = await _one(c["find_best_worker"], _req(rid, tokens)
                             .to_dict())
            ans["router_instance_id"] = ids[ans["router_instance_id"]]
            return ans

        async def free(c, rid):
            return await _one(c["free"], {"request_id": rid})

        # the routers have seen both warm-ups once each names its worker
        for rid, tokens, w in (("probe-a", WARM_A, 0),
                               ("probe-b", WARM_B, 1)):
            for c in (r1, r2):
                async def warmed():
                    ans = await pick(c, rid, tokens)
                    await free(c, rid)
                    return ans["overlap_blocks"] == 4 and ans
                ans = await _until(warmed, f"{module} seeing {rid}")
                assert ans["instance_id"] == workers[w]
        routed = []
        for rid, tokens in ROUTED:
            ans = await pick(r1, rid, tokens)
            ok = await _one(r1["mark_prefill_completed"],
                            {"request_id": rid})
            routed.append((ans, ok, await free(r1, rid)))
        # affinity: r1 holds a 3-block request on one worker (cold: a
        # tie, either worker) and a 2-block one on the other, so a
        # 1-block probe's pick says whether the first is still held
        hold1 = await pick(r1, "hold-1", [900 + i for i in range(40)])
        w_h = hold1["instance_id"]
        probe1 = await pick(r1, "probe-1", [950 + i for i in range(10)])
        await free(r1, "probe-1")
        hold2 = await pick(r1, "hold-2", [1000 + i for i in range(20)])
        steered = (probe1["instance_id"] != w_h,
                   hold2["instance_id"] != w_h)
        # a free sent to the other instance leaves hold-1 held
        wrong = await free(r2, "hold-1")
        probe2 = await pick(r1, "probe-2", [1100 + i for i in range(10)])
        await free(r1, "probe-2")
        still_held = probe2["instance_id"] != w_h
        # sent to its own instance, it releases it
        right = await free(r1, "hold-1")
        probe3 = await pick(r1, "probe-3", [1200 + i for i in range(10)])
        await free(r1, "probe-3")
        released = probe3["instance_id"] == w_h
        await free(r1, "hold-2")
        affinity = (steered, wrong, still_held, right, released,
                    hold1["router_instance_id"], hold1["request_blocks"],
                    probe2["request_blocks"], probe2["overlap_blocks"])
        return routed, affinity
    finally:
        for c in clients.values():
            for cl in c.values():
                await cl.close()
        for proc, _ in procs:
            await _stop(proc)


@pytest.mark.allow_slow_callbacks
async def test_standalone_routers_answer_alike(tmp_path):
    disco = dict(discovery_backend="file", discovery_path=str(tmp_path),
                 event_plane="zmq")
    rt = await DistributedRuntime(config=RuntimeConfig(**disco)).start()
    args = MockEngineArgs(model_name="route-model", block_size=BLOCK,
                          base_step_s=0.0005, prefill_s_per_token=0.0,
                          decode_s_per_seq=0.0)
    workers = [await MockerWorker(rt, args, component="backend").start()
               for _ in range(2)]
    env = {**os.environ, "DYN_DISCOVERY_BACKEND": "file",
           "DYN_DISCOVERY_PATH": str(tmp_path), "DYN_EVENT_PLANE": "zmq",
           "JAX_PLATFORMS": "cpu"}
    try:
        ids = [w.served.instance_id for w in workers]
        gen = await (rt.namespace("dynamo").component("backend")
                     .endpoint("generate").client()).start()
        for tokens, iid in ((WARM_A, ids[0]), (WARM_B, ids[1])):
            async for _ in gen.generate(_req(f"warm-{iid}", tokens)
                                        .to_dict(), instance_id=iid):
                pass
        await gen.close()
        got = {side: await _side(rt, env, MODULES[side], ids)
               for side in ("jax", "port")}
    finally:
        for w in workers:
            await w.close()
        await rt.shutdown()
    routed, affinity = got["port"]
    want = {"a-full": (0, 4, 5), "b-full": (1, 4, 5), "a-half": (0, 2, 4),
            "b-two": (1, 1, 1), "a-exact": (0, 4, 4)}
    for (rid, _), (ans, ok, freed) in zip(ROUTED, routed):
        w, overlap, blocks = want[rid]
        assert ans == {"instance_id": ids[w], "router_instance_id": "r1",
                       "request_blocks": blocks,
                       "overlap_blocks": overlap}, rid
        assert ok == freed == {"ok": True}
    assert affinity == ((True, True), {"ok": True}, True, {"ok": True},
                        True, "r1", 3, 1, 0)
    assert got["port"] == got["jax"]


def test_flags_equal_jax():
    j, p = jax_main.build_args(), port_main.build_args()
    jd = {a.dest: (a.default, a.type) for a in j._actions}
    pd = {a.dest: (a.default, a.type) for a in p._actions}
    assert pd == jd
    argv = ["--namespace", "n", "--component", "c", "--router-component",
            "r", "--block-size", "32", "--kv-overlap-score-weight", "0.5",
            "--router-temperature", "0.7"]
    assert vars(p.parse_args(argv)) == vars(j.parse_args(argv))


async def _no_workers(main, kv_router, runtime, protocols, monkeypatch):
    """main() in-process on mem discovery, its selector made to choose
    nothing; the find_best_worker answer."""
    cluster = uuid.uuid4().hex

    async def nobody(self, request, avoid=None):
        return None

    monkeypatch.setattr(kv_router.KvRouter, "pick", nobody)
    monkeypatch.setattr(sys, "argv", ["router", "--router-component",
                                      "solo"])
    monkeypatch.setattr(runtime.DistributedRuntime, "detached",
                        classmethod(lambda cls, **kw: cls(
                            config=runtime.RuntimeConfig(
                                discovery_backend="mem",
                                event_plane="inproc"),
                            cluster_id=cluster)))
    task = asyncio.create_task(main.main())
    rt = await runtime.DistributedRuntime(config=runtime.RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=cluster).start()
    try:
        client = await (rt.namespace("dynamo").component("solo")
                        .endpoint("find_best_worker").client()).start()
        await client.wait_for_instances(timeout=WAIT_S)
        req = protocols.PreprocessedRequest(
            token_ids=[1, 2, 3], request_id="x",
            sampling=protocols.SamplingOptions(temperature=0.0),
            stop=protocols.StopConditions(max_tokens=2))
        iid = next(iter(client.instance_ids))
        out = [i async for i in client.generate(req.to_dict())]
        await client.close()
        return out, iid
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await rt.shutdown()


@pytest.mark.parametrize("side", ["jax", "port"])
async def test_no_workers_available_answer(side, monkeypatch):
    import dynamo_tpu_torch.protocols as port_protocols
    import dynamo_tpu_torch.runtime as port_runtime

    mods = {"jax": (jax_main, jax_kv_router, jax_runtime, jax_protocols),
            "port": (port_main, port_kv_router, port_runtime,
                     port_protocols)}[side]
    out, iid = await _no_workers(*mods, monkeypatch)
    assert out == [{"error": "no_workers_available",
                    "router_instance_id": iid}]

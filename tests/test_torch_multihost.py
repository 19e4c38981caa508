"""Multihost: a mesh spread over one launcher per host (CPU, fp32), held
against JAX's tests/test_multihost.py.

Two launchers on one machine stand in for two hosts, as JAX's test
stands two engines in for two host shards.

* The launcher context: `MultihostContext.detect` against JAX's for the
  same DYN_MH_RANK / DYN_MH_WORLD (JAX's test_context_detect_env), the
  coordinator from `initialize`'s argument and from
  JAX_COORDINATOR_ADDRESS, the variable jax.distributed.initialize
  reads; a mesh the launchers do not divide is refused.
* `group_backend` over (host, card) identities: two hosts' cuda:0 are
  two cards (NCCL), one card is gloo, and the CPU is gloo.
* JAX's test_follower_kv_matches_leader_after_serving at tp = 2: a leader
  and a follower TorchEngineWorker in one process, each its own
  launcher, the follower's replay on a thread.  Only the leader is
  served, registered, publishes KV events and load metrics and holds
  KVBM tiers; the follower reports the follower role, drains nothing and
  replays until the leader's stop.  The leader's greedy streams equal
  JaxEngine's at tp = 2 and the port's tp = 1 engine's; the follower's
  kv-head slab equals the matching slab of the JAX engine's cache within
  fp32 rounding (FWD), all three on the lockstep reference scheduler.
* `python -m dynamo_tpu_torch.engine --device cpu --tp 2` as a leader
  and a follower launcher on one file-discovery directory, the follower
  started first: exactly one instance is discoverable, KV events and
  load metrics carry only the leader's id, the follower exits 0 after
  the leader's drain, and a leader whose follower never starts fails
  within DYN_MH_BARRIER_TIMEOUT_S naming rank 1.
"""

import asyncio
import inspect
import signal
import socket
import subprocess
import sys
import time
import uuid

import jax
import jax._src.distributed as jax_distributed
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel.multihost import MultihostContext as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.worker import TorchEngineWorker
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.parallel import mesh as pmesh
from dynamo_tpu_torch.parallel import multihost
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.parallel.multihost import MultihostContext
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from test_torch_overlap import _collect, _req
from test_torch_spec import settled
from test_torch_worker import REPO, _discover, _env, _readline

pytestmark = pytest.mark.allow_slow_callbacks

# JAX's test_multihost.py FP32 config
SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JAX_FP32 = jl.LlamaConfig(dtype=jnp.float32, **SHAPES)
FP32 = tl.LlamaConfig(dtype=torch.float32, **SHAPES)
ECFG = dict(block_size=4, num_blocks=32, max_blocks_per_seq=8,
            max_num_seqs=2, prefill_buckets=(8, 16), seed=5)
# the caches are compared on the lockstep reference scheduler: a fused,
# overlapped burst overshoots a stream's end into scratch positions, and
# how far depends on when the next request arrives, in JAX's engine too
LOCKSTEP = dict(overlap_scheduling=False, decode_fused_steps=1)
PROMPTS = (list(range(3, 17)), [7, 1, 9, 4, 4, 2, 30, 31, 5, 8])
NEW = 6
FWD = dict(rtol=1e-5, atol=1e-5)
# every join and collective of a test's mesh, seconds
MESH_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the launcher context
# ---------------------------------------------------------------------------


def test_context_detect_env(monkeypatch):
    monkeypatch.setattr(multihost, "_initialized", None)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("DYN_MH_RANK", "2")
    monkeypatch.setenv("DYN_MH_WORLD", "4")
    ctx, jctx = MultihostContext.detect(), JaxContext.detect()
    assert (ctx.rank, ctx.world, ctx.is_leader) == \
        (jctx.rank, jctx.world, jctx.is_leader) == (2, 4, False)
    assert ctx.coordinator is None
    with pytest.raises(ValueError, match="4 launchers need a coordinator"):
        ctx.store_address()
    monkeypatch.setenv("DYN_MH_RANK", "0")
    assert MultihostContext.detect().is_leader and JaxContext.detect() \
        .is_leader
    # the coordinator: jax.distributed.initialize's own variable
    assert "'JAX_COORDINATOR_ADDRESS'" in inspect.getsource(jax_distributed)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.7:6379")
    assert MultihostContext.detect().store_address() == ("10.0.0.7", 6379)
    monkeypatch.delenv("DYN_MH_RANK")
    monkeypatch.delenv("DYN_MH_WORLD")
    assert MultihostContext.detect() == MultihostContext()  # single
    assert MultihostContext().store_address() == ("127.0.0.1", 0)


def test_initialize_takes_the_coordinator_from_argument_or_env(monkeypatch):
    monkeypatch.setattr(multihost, "_initialized", None)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    for k in ("DYN_MH_RANK", "DYN_MH_WORLD"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize()
    ctx = multihost.initialize("host-a:1234", num_processes=3, process_id=1)
    assert ctx == MultihostContext(1, 3, "host-a:1234")
    assert MultihostContext.detect() == ctx
    assert ctx.store_address() == ("host-a", 1234)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "[::1]:77")
    monkeypatch.setenv("DYN_MH_RANK", "1")
    monkeypatch.setenv("DYN_MH_WORLD", "2")
    ctx = multihost.initialize()
    assert (ctx.rank, ctx.world, ctx.store_address()) == (1, 2,
                                                          ("::1", 77))
    # the environment's launcher with initialize's coordinator
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "elsewhere:1")
    assert MultihostContext.detect().coordinator == "[::1]:77"
    with pytest.raises(ValueError, match="not host:port"):
        multihost.initialize("no-port")


def test_a_mesh_the_launchers_do_not_divide_is_refused():
    cfg = MeshConfig(dp=1, tp=2)
    assert [list(pmesh.launcher_ranks(cfg, 2, h)) for h in (0, 1)] == \
        [[0], [1]]
    assert list(pmesh.launcher_ranks(MeshConfig(dp=2, tp=2), 2, 1)) == \
        [2, 3]
    assert pmesh.mesh_devices(MeshConfig(dp=2, tp=2), ["cpu"] * 2, 2) == \
        [torch.device("cpu")] * 2
    for hosts in (3, 0):
        with pytest.raises(ValueError, match="does not divide over"):
            pmesh.launcher_ranks(cfg, hosts)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        pmesh.mesh_devices(MeshConfig(dp=2, tp=2), ["cpu"], 2)
    mh = MultihostContext(0, 3, f"127.0.0.1:{_free_port()}")
    with pytest.raises(ValueError, match="2 ranks does not divide over 3"):
        TorchEngine(EngineConfig(model_config=FP32, tp=2, **ECFG),
                    device="cpu", mh=mh)


def test_group_backend_over_host_and_card_identities():
    a0 = {"node": "host-a", "device": "cuda:0"}
    b0 = {"node": "host-b", "device": "cuda:0"}
    assert pmesh.group_backend([a0, b0]) == "nccl"   # two cards
    assert pmesh.group_backend([a0, dict(a0)]) == "gloo"  # one card
    assert pmesh.group_backend([{"node": "h", "device": "cuda:0"},
                                {"node": "h", "device": "cuda:1"}]) == "nccl"
    assert pmesh.group_backend([{"node": "a", "device": "cpu"},
                                {"node": "b", "device": "cpu"}]) == "gloo"
    # devices of this host, as every single-launcher mesh names them
    dev = torch.device
    assert pmesh.group_backend([dev("cuda:0"), dev("cuda:1")]) == "nccl"
    assert pmesh.group_backend([dev("cuda:0"), dev("cuda:0")]) == "gloo"
    assert pmesh.rank_identity(dev("cpu")) == {"node": pmesh.node_id(),
                                               "device": "cpu"}


# ---------------------------------------------------------------------------
# a leader and a follower worker in one process
# ---------------------------------------------------------------------------


async def _jax_reference():
    """JaxEngine at tp = 2 (warmed up as the port's leader warms up):
    the greedy streams of PROMPTS, its cache (k, v) as numpy and its
    weights as a numpy tree."""
    je = JaxEngine(JaxEngineConfig(model_config=JAX_FP32, tp=2, **ECFG,
                                   **LOCKSTEP))
    try:
        await asyncio.to_thread(je.warmup_decode)
        toks = [await _collect(je, _req(True, p, f"j{i}", NEW))
                for i, p in enumerate(PROMPTS)]
    finally:
        await je.close()
        await settled(je)
    kv = tuple(np.asarray(a, np.float32) for a in je.kv[:2])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    return toks, kv, tree


async def _listen(rt, subject, into):
    async for _, msg in rt.event_plane.subscribe(subject):
        into.append(msg)


async def _wait_for(pred, what, timeout_s=MESH_TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"no {what} within {timeout_s:.0f} s")
        await asyncio.sleep(0.02)


async def test_follower_kv_matches_leader_after_serving():
    want, jkv, tree = await _jax_reference()
    t1 = TorchEngine(EngineConfig(model_config=FP32, **ECFG, **LOCKSTEP),
                     params=params_from_numpy(tree, FP32, "cpu"),
                     device="cpu")
    try:
        one = [await _collect(t1, _req(False, p, f"t{i}", NEW))
               for i, p in enumerate(PROMPTS)]
    finally:
        await t1.close()

    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    coord = f"127.0.0.1:{_free_port()}"
    cfg = EngineConfig(model_config=FP32, tp=2, host_cache_blocks=16,
                       **ECFG, **LOCKSTEP)
    workers = [TorchEngineWorker(
        rt, cfg, params=tree, device="cpu", cuda_graphs=False,
        mh=MultihostContext(r, 2, coord)) for r in (1, 0)]
    follower, leader = workers
    events, loads = [], []
    listeners = [asyncio.create_task(_listen(rt, f"{s}.dynamo.backend", into))
                 for s, into in (("kv_events", events),
                                 ("load_metrics", loads))]
    client = None
    try:
        await asyncio.wait_for(
            asyncio.gather(follower.start(), leader.start()), MESH_TIMEOUT_S)
        # one routing identity: the leader's
        assert follower.served is None and leader.served is not None
        lid = leader.served.instance_id
        assert follower.publisher is None and follower._load_task is None
        assert follower.debug_state() == {"kind": "engine",
                                          "role": "follower", "rank": 1}
        assert leader.debug_state()["instance_id"] == lid
        # KVBM tiers on the leader only; the follower holds its kv heads
        assert leader.engine.kvbm is not None
        assert follower.engine.kvbm is None
        assert follower.engine.mesh.rank == 1
        assert follower.engine.kv[0].shape[1] == SHAPES["n_kv_heads"] // 2
        client = await rt.namespace("dynamo").component("backend") \
            .endpoint("generate").client().start()
        instances = await _discover(client)
        assert [i.instance_id for i in instances] == [lid]
        got = []
        for i, p in enumerate(PROMPTS):
            toks = []
            async for item in client.generate(PreprocessedRequest(
                    token_ids=p, request_id=f"mh{i}",
                    sampling=SamplingOptions(temperature=0.0),
                    stop=StopConditions(max_tokens=NEW,
                                        ignore_eos=True)).to_dict()):
                toks.extend(item.get("token_ids", []))
            got.append(toks)
        assert got == want == one
        await _wait_for(lambda: events and loads, "kv events and loads")
        assert {e["worker_id"] for e in events} == {lid}
        assert {m["worker_id"] for m in loads} == {lid}
        # a follower's drain is a no-op; its replay runs until the stop
        await follower.drain()
        assert not follower.engine.draining
        assert not follower.replay_done.done() and follower.replay_alive
        await client.close()
        client = None
        await leader.close()
        steps = await asyncio.wait_for(follower.replay_done, MESH_TIMEOUT_S)
        assert steps > 0 and leader.engine.rank_metrics[1][
            "steps_replayed"] == steps
        assert sorted(leader.engine.rank_launches) == [1]
        # the follower's slab: kv heads [1, 2) of JAX's cache, whose
        # blocks are [hd, bs] (head-major transposed) where the port's
        # are [bs, hd]
        heads = pmesh.kv_cache_spec(1, 2, SHAPES["n_kv_heads"])
        for mine, whole in zip(follower.engine.kv[:2], jkv):
            np.testing.assert_allclose(
                mine.float().numpy(),
                np.swapaxes(whole[:, heads], -1, -2), **FWD)
    finally:
        if client is not None:
            await client.close()
        for t in listeners:
            t.cancel()
        await asyncio.gather(*listeners, return_exceptions=True)
        await leader.close()
        await follower.close()
        await rt.shutdown()
    assert not follower.replay_alive


# ---------------------------------------------------------------------------
# python -m dynamo_tpu_torch.engine: a leader and a follower launcher
# ---------------------------------------------------------------------------

# warm-up's replay is the in-process test's (its leader warms up)
CLI = [sys.executable, "-m", "dynamo_tpu_torch.engine", "--device", "cpu",
       "--model", "tiny", "--tp", "2", "--block-size", "16",
       "--num-blocks", "64", "--max-blocks-per-seq", "8",
       "--max-num-seqs", "2", "--no-warmup"]
# seconds a launcher may take to start and join under a busy suite
CLI_WAIT_S = 150.0


def _launcher(rank: int, disc, port: int, barrier_s: float):
    return subprocess.Popen(
        CLI, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(
            DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=str(disc),
            DYN_MH_RANK=str(rank), DYN_MH_WORLD="2",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            DYN_MH_BARRIER_TIMEOUT_S=str(barrier_s)))


def _ready(proc, what: str) -> str:
    line = _readline(proc, timeout=CLI_WAIT_S)
    if not line:
        proc.kill()
        raise AssertionError(f"no ready line from the {what} within "
                             f"{CLI_WAIT_S:.0f} s: {proc.stderr.read()}")
    return line.strip()


def _exit_code(proc, what: str, timeout_s: float) -> int:
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"the {what} did not exit within "
                             f"{timeout_s:.0f} s") from None


async def _serve_through_discovery(disc):
    """Over the launchers' discovery: the discoverable instances, two
    greedy streams and the KV events and load metrics seen meanwhile."""
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=str(disc),
        event_plane="zmq")).start()
    events, loads = [], []
    listeners = [asyncio.create_task(_listen(rt, f"{s}.dynamo.backend", into))
                 for s, into in (("kv_events", events),
                                 ("load_metrics", loads))]
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        ids = [i.instance_id for i in await _discover(client)]
        streams = []
        for i, p in enumerate(PROMPTS):
            toks = []
            async for item in client.generate(PreprocessedRequest(
                    token_ids=p, request_id=f"cli{i}",
                    sampling=SamplingOptions(temperature=0.0),
                    stop=StopConditions(max_tokens=NEW,
                                        ignore_eos=True)).to_dict()):
                toks.extend(item.get("token_ids", []))
            streams.append(toks)
        await _wait_for(lambda: events and loads, "kv events and loads",
                        CLI_WAIT_S)
    finally:
        await client.close()
        for t in listeners:
            t.cancel()
        await asyncio.gather(*listeners, return_exceptions=True)
        await rt.shutdown()
    return ids, streams, events, loads


def test_engine_cli_leader_and_follower_launchers(tmp_path):
    disc = tmp_path / "cluster"
    port = _free_port()
    # the follower launcher first: it waits for the leader's store
    follower = _launcher(1, disc, port, CLI_WAIT_S)
    # a leader whose follower never starts, beside them
    lone = _launcher(0, tmp_path / "lone", _free_port(), 3.0)
    leader = None
    try:
        leader = _launcher(0, disc, port, CLI_WAIT_S)
        assert _ready(follower, "follower") == "ready follower rank=1/2"
        line = _ready(leader, "leader")
        assert line.startswith("ready instance_id="), line
        lid = int(line.split("=", 1)[1])
        ids, streams, events, loads = asyncio.run(
            _serve_through_discovery(disc))
        assert ids == [lid]
        assert [len(s) for s in streams] == [NEW] * len(PROMPTS)
        assert {e["worker_id"] for e in events} == {lid}
        assert {m["worker_id"] for m in loads} == {lid}
        # every endpoint's instance file is the leader's
        assert {f.stem for f in (disc / "v1" / "instances").rglob(
            "*.json")} == {str(lid)}
        leader.send_signal(signal.SIGTERM)
        assert _exit_code(leader, "leader", CLI_WAIT_S) == 0, \
            leader.stderr.read()
        assert _exit_code(follower, "follower", CLI_WAIT_S) == 0, \
            follower.stderr.read()
        assert not list((disc / "v1" / "instances").rglob("*.json"))
        # the lone leader: the barrier names the launcher that never came
        assert _exit_code(lone, "lone leader", CLI_WAIT_S) != 0
        err = lone.stderr.read()
        assert "multi-host barrier timeout: ranks [1]" in err, err
        assert "ready" not in lone.stdout.read()
    finally:
        for p in (follower, lone, leader):
            if p is None:
                continue
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
            p.stdout.close()
            p.stderr.close()

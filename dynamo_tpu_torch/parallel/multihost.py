"""One process per rank: the leader's step stream, replayed by followers.

The counterpart of dynamo_tpu/parallel/multihost.py.  There, a TPU slice
runs ONE jit program over N hosts and every process must execute the
same sequence of jit calls; the leader's scheduler publishes each call
as a step descriptor (kind + host arrays) and followers replay it.  The
port's tensor parallelism has the same shape even on one host: every
rank is a process (parallel/mesh.py), and its collectives pair up only
if every rank runs the same programs in the same order.  So:

  * the leader (rank 0, the engine the caller built) spawns the other
    ranks (`launch_ranks`, start method "spawn"; each starts in
    `follower_main`, which imports only the port), and owns the block
    allocator, the scheduler, the KV events and the ledger;
  * before it runs a program (warm-up dispatches included) it publishes
    the step, `(seq, kind, {name: ndarray})`, with the JAX engine's kind
    names and descriptor keys (engine/core.py `_publish`);
  * each follower builds an engine on its device with its shard and runs
    `TorchEngine.apply_step` on every step, in order, until `stop`,
    discarding what it samples.

The stream rides the mesh's step group: per step the root broadcasts a
length, then the frame (the port's msgpack codec; arrays as raw bytes
with their dtype and shape, JAX's `_pack`).  Sequence numbers make a gap
fatal on the follower (StepGapError), as in JAX: a follower that missed
a step has diverged and its next collective would pair with the wrong
one.  The transport is a pair of callables, so the protocol is tested
over a queue too.

At close the leader publishes `stop`, each follower writes its kernel
launch counts into the mesh's store and exits, and the leader joins every
rank with a timeout and kills one that does not exit, so no process keeps
the device.  A rank that dies mid-stream closes its sockets: the
leader's next collective raises, its engine loop fails every stream.

The cross-rank KV moves ride the stream as JAX's `gather` (descriptor
`ids`) and `inject` (`kb`, `vb`, `ids`, plus `ksb`, `vsb` for an int8
cache) kinds: a gather is a collective every rank of the leader's tensor
group runs, its kv-head slabs gathered into the logical blocks on the
leader (parallel/mesh.py gather_slabs), which alone consumes them (a
disagg pull's chunk, a KVBM offload); an inject carries the whole
logical payload (a pulled disagg chunk, a KVBM onboard), so followers
need no tiers and no transport of their own, and each writes its slab.
A bf16 payload crosses as its raw bits (`to_wire`/`from_wire`).

The features' kinds, JAX's names and keys: `spec_verify` (the verify
stream: toks, positions, seg_ids, tables, valid, temps_t; followers
keep the KV evolution, the acceptance is the leader's), `lora_write`
(slot, and the adapter's whole bank tensors A_q .. B_o, a bf16 one as
raw bits; each rank clears the slot and writes its shard),
`decode_topk` and `decode_topk_wide` (guided decoding's lane
descriptor: tokens, positions, tables, ctx_lens, valid) and `embed`
(toks, true_len).  The ring prefill's `prefill_ring` (toks,
positions, block_table, true_len, seed, temp, top_k, top_p): every rank
runs its rows of the ring and writes the whole prompt's K/V, the
leader samples.  With an adapter bank, prefill, prefill_packed,
prefill_batch and the decode kinds carry the `lidx` lane, as JAX's
programs take their lora arguments.  A draft model's programs never
ride the stream: the draft runs whole on the leader's device.

Ranks across hosts.  A mesh of dp * tp * sp ranks may be spread over H
launchers, one per host, as JAX spreads a slice over its processes:
launcher h of H owns ranks h * L .. (h + 1) * L - 1, L = world / H (a
world H does not divide is refused), is its own first local rank and
spawns the rest, as a single launcher spawns ranks 1.. .  The launcher
environment is JAX's:

  * DYN_MH_RANK / DYN_MH_WORLD: this launcher and the launcher count
    (`MultihostContext.detect`; `world` counts launchers, as JAX's
    process_count does);
  * JAX_COORDINATOR_ADDRESS (host:port), the variable
    jax.distributed.initialize itself reads: the leader hosts the mesh's
    store there and every launcher connects to it (`initialize` fixes it
    for the process; `detect` reads it);
  * DYN_MH_BARRIER_TIMEOUT_S (60 s, JAX's default): how long the leader
    waits for the other launchers' ranks (`launch_ranks`), and a
    follower launcher for the leader's store (`join_ranks`); each raises
    naming the ranks or the store that never came.

Launcher 0 is the leader (engine/core.py, the worker's engine, as on one
host).  A follower launcher's first rank is its worker's engine
(engine/worker.py `_start_follower`, built from the joined mesh through
the `mesh=` path spawned ranks take) and replays the stream on a thread;
with no params from a pipe it takes its weights from config.model_path
or config.seed on its own host.  Only the leader's worker has a routing
identity.  The leader's `stop` ends every rank: each reports its launch
counts and metrics into the store, where the leader's close reads the
remote ones too, bounded.  A follower's replay blocks in a gloo receive,
which nothing but the leader's next frame (or its exit) ends.
"""

from __future__ import annotations

import datetime
import json
import logging
import multiprocessing as mp
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.codec import packb, unpackb
from .mesh import (
    DEFAULT_TIMEOUT_S,
    STORE_HOST,
    Mesh,
    MeshConfig,
    join,
    launcher_ranks,
    make_mesh,
    mesh_devices,
    rendezvous,
)

logger = logging.getLogger(__name__)

# the kind that ends a follower
STOP = "stop"
# seconds the leader waits for a rank to exit after `stop`
JOIN_TIMEOUT_S = 30.0


# the coordinator's host:port, the variable jax.distributed reads
COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
# seconds the leader waits for the other launchers' ranks, and a follower
# launcher for the leader's store (JAX's variable and default)
BARRIER_ENV = "DYN_MH_BARRIER_TIMEOUT_S"
BARRIER_TIMEOUT_S = 60.0


def barrier_timeout_s() -> float:
    return float(os.environ.get(BARRIER_ENV, BARRIER_TIMEOUT_S))


@dataclass(frozen=True)
class MultihostContext:
    """Who this launcher is: launcher `rank` of `world` (hosts), rank 0
    leads; `coordinator` is the host:port the leader hosts the mesh's
    store on (None: 127.0.0.1 and a free port, one launcher only)."""

    rank: int = 0
    world: int = 1
    coordinator: Optional[str] = None

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @classmethod
    def detect(cls) -> "MultihostContext":
        """DYN_MH_RANK/DYN_MH_WORLD override, as JAX's (the coordinator
        then `initialize`'s, else JAX_COORDINATOR_ADDRESS); otherwise what
        `initialize` fixed, else a single launcher."""
        if "DYN_MH_RANK" in os.environ:
            coord = (_initialized.coordinator if _initialized is not None
                     else os.environ.get(COORDINATOR_ENV))
            return cls(rank=int(os.environ["DYN_MH_RANK"]),
                       world=int(os.environ.get("DYN_MH_WORLD", "1")),
                       coordinator=coord or None)
        return _initialized if _initialized is not None else cls()

    def store_address(self) -> Tuple[str, int]:
        """(host, port) of the mesh's store: the coordinator's, or
        127.0.0.1 and port 0 (any free one) for a single launcher without
        one.  Raises ValueError for several launchers without one."""
        if self.coordinator is None:
            if self.world > 1:
                raise ValueError(
                    f"{self.world} launchers need a coordinator: "
                    f"initialize(coordinator) or {COORDINATOR_ENV}=host:port")
            return STORE_HOST, 0
        host, sep, port = self.coordinator.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"coordinator {self.coordinator!r} is not "
                             "host:port")
        return host.strip("[]"), int(port)


# what `initialize` fixed for this process (None: not called)
_initialized: Optional[MultihostContext] = None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> MultihostContext:
    """Fix this process's launcher context, with jax.distributed's
    signature: `coordinator` (host:port, default JAX_COORDINATOR_ADDRESS,
    the variable jax.distributed.initialize reads) is where the leader
    hosts the mesh's store; `num_processes` and `process_id` default to
    DYN_MH_WORLD and DYN_MH_RANK.  `MultihostContext.detect` returns it
    from then on.  Raises ValueError without a coordinator."""
    global _initialized
    coordinator = coordinator or os.environ.get(COORDINATOR_ENV)
    if not coordinator:
        raise ValueError("coordinator_address should be defined: pass it, "
                         f"or set {COORDINATOR_ENV}=host:port")
    ctx = MultihostContext(
        rank=(process_id if process_id is not None
              else int(os.environ.get("DYN_MH_RANK", "0"))),
        world=(num_processes if num_processes is not None
               else int(os.environ.get("DYN_MH_WORLD", "1"))),
        coordinator=coordinator)
    ctx.store_address()  # a malformed address fails here, not at join
    _initialized = ctx
    return ctx


# ---------------------------------------------------------------------------
# the step stream
# ---------------------------------------------------------------------------


def _pack(arrays: Dict[str, np.ndarray]) -> Dict[str, dict]:
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        out[k] = {"b": np.ascontiguousarray(a).tobytes(),
                  "shape": list(a.shape), "dtype": a.dtype.name}
    return out


def _unpack(wire: Dict[str, dict]) -> Dict[str, np.ndarray]:
    return {k: np.frombuffer(d["b"], dtype=np.dtype(d["dtype"]))
            .reshape(d["shape"]).copy()
            for k, d in wire.items()}


def to_wire(t) -> np.ndarray:
    """A KV payload tensor (or array) as a host numpy array for a step's
    descriptor.  numpy has no bfloat16 (the port does not import
    ml_dtypes), so a bf16 tensor crosses as its raw bits, int16;
    `from_wire` reads them back into the receiving cache's dtype."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def from_wire(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """`to_wire`'s array as a CPU tensor: int16 bits into a bf16 cache
    are the bf16 values; any other array is its own dtype (the inject
    casts it to the cache's)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16 and a.dtype == np.int16:
        return t.view(torch.bfloat16)
    return t


def encode_step(seq: int, kind: str, arrays: Dict[str, np.ndarray]) -> bytes:
    return packb({"seq": seq, "kind": kind, "arrays": _pack(arrays)})


def decode_step(frame: bytes) -> Tuple[int, str, Dict[str, np.ndarray]]:
    msg = unpackb(frame)
    return msg["seq"], msg["kind"], _unpack(msg["arrays"])


# how long a follower waits for the next step's length: as long as the
# leader idles (a leader that is gone closes its sockets, and the wait
# raises at once)
IDLE_WAIT = datetime.timedelta(days=365)


class GroupTransport:
    """Frames over a gloo group, broadcast from rank `root`: a length
    (int64), then the bytes.  `send` on the root, `recv` on every other
    rank; each blocks until the group has the frame, or raises when a
    peer is gone or the group's timeout passes, except that `recv` waits
    for the length up to IDLE_WAIT: an idle leader sends nothing."""

    def __init__(self, pg, root: int = 0):
        self.pg = pg
        self.opts = dist.BroadcastOptions()
        self.opts.rootRank = root
        self.idle = dist.BroadcastOptions()
        self.idle.rootRank = root
        self.idle.timeout = IDLE_WAIT

    def send(self, frame: bytes) -> None:
        for t in (torch.tensor([len(frame)], dtype=torch.int64),
                  torch.frombuffer(bytearray(frame), dtype=torch.uint8)):
            self.pg.broadcast([t], self.opts).wait()

    def recv(self) -> bytes:
        n = torch.zeros(1, dtype=torch.int64)
        self.pg.broadcast([n], self.idle).wait()
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self.pg.broadcast([buf], self.opts).wait()
        return buf.numpy().tobytes()


class StepBroadcaster:
    """Leader side: the ordered step stream.  `publish_step` runs on the
    thread that then runs the program (the scheduler's, or warm-up's
    under the step lock), so wire order is execution order."""

    def __init__(self, send: Callable[[bytes], None]):
        self._send = send
        self._seq = 0

    @property
    def published(self) -> int:
        """Steps published so far, `stop` included."""
        return self._seq

    def publish_step(self, kind: str,
                     arrays: Optional[Dict[str, np.ndarray]] = None) -> int:
        seq = self._seq
        self._seq += 1
        self._send(encode_step(seq, kind, arrays or {}))
        return seq


class StepGapError(RuntimeError):
    """A follower missed a step: its program sequence has diverged from
    the leader's and its next collective would pair with the wrong one."""


class StepFollower:
    """Follower side: yields (kind, arrays) strictly in order until
    `stop`."""

    def __init__(self, recv: Callable[[], bytes]):
        self._recv = recv
        self._next = 0

    def steps(self) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
        while True:
            seq, kind, arrays = decode_step(self._recv())
            if seq != self._next:
                raise StepGapError(
                    f"expected step {self._next}, got {seq}: this follower "
                    "has diverged from the leader and must restart")
            self._next += 1
            if kind == STOP:
                return
            yield kind, arrays


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


@dataclass
class RankProcesses:
    """A launcher's mesh and the processes of its other local ranks.  On
    the leader `reports` lists every other rank, whose reports its close
    collects, and `remote` those of other launchers."""

    mesh: Mesh
    procs: List[mp.Process]
    reports: List[int] = field(default_factory=list)
    remote: List[int] = field(default_factory=list)
    # per rank, its kernel launch counts and its engine's numeric metrics
    # as it reported them at stop
    launches: Dict[int, Dict[str, int]] = field(default_factory=dict)
    metrics: Dict[int, Dict[str, float]] = field(default_factory=dict)

    def close(self, publish_stop: Optional[Callable[[], None]] = None,
              timeout_s: float = JOIN_TIMEOUT_S) -> None:
        """Stop every rank: `publish_stop` (skipped when the stream is
        broken), join each local process with a timeout, kill one still
        alive, then read the launch counts and metrics the ranks left in
        the store, waiting up to the same deadline for the remote ranks'
        (they have no process here to join)."""
        if publish_stop is not None:
            try:
                publish_stop()
            except RuntimeError:
                logger.warning("stop not delivered to every rank; killing "
                               "the ranks left", exc_info=True)
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                logger.warning("rank process %s did not exit; killing it",
                               p.name)
                p.kill()
                p.join(5.0)
        store = self.mesh.store
        for r in self.reports:
            keys = [f"launches/{r}", f"metrics/{r}"]
            while r in self.remote and not store.check(keys) \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            for into, key in zip((self.launches, self.metrics), keys):
                if store.check([key]):
                    into[r] = json.loads(store.get(key))
                else:
                    logger.warning("rank %d left no %s", r, key)


def _await_joins(store, procs: Dict[int, mp.Process],
                 timeout_s: float) -> None:
    """Wait until every spawned rank ({rank: process}) has joined the
    store; raise naming a rank that died or did not join within
    timeout_s."""
    deadline = time.monotonic() + timeout_s
    pending = dict(procs)
    while pending:
        for r, p in list(pending.items()):
            if store.check([f"joined/{r}"]):
                del pending[r]
            elif not p.is_alive():
                raise RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                   "before joining the mesh")
        if pending and time.monotonic() > deadline:
            raise RuntimeError(f"ranks {sorted(pending)} did not join the "
                               f"mesh within {timeout_s:.0f} s")
        time.sleep(0.02)


def _await_remote(store, ranks: List[int], per_host: int,
                  timeout_s: float) -> None:
    """The leader's barrier: wait until every rank of the other launchers
    has joined; it holds no process of theirs, only store keys.  Raises,
    as JAX's barrier does, naming the ranks (and their launchers) that
    never joined within timeout_s."""
    deadline = time.monotonic() + timeout_s
    pending = list(ranks)
    while pending:
        pending = [r for r in pending if not store.check([f"joined/{r}"])]
        if pending and time.monotonic() > deadline:
            hosts = sorted({r // per_host for r in pending})
            raise RuntimeError(
                f"multi-host barrier timeout: ranks {pending} (launchers "
                f"{hosts}) never joined the mesh within {timeout_s:.0f} s "
                f"({BARRIER_ENV})")
        time.sleep(0.02)


def _spawn_local(config, ranks: range, host: str, port: int,
                 devs: List[str], cuda_graphs: bool, timeout_s: float):
    """Spawn the launcher's local ranks after its first, each
    `follower_main` on its device; returns ({rank: process}, [pipe])."""
    ctx = mp.get_context("spawn")
    procs: Dict[int, mp.Process] = {}
    pipes = []
    try:
        for i, r in enumerate(ranks):
            if i == 0:
                continue
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=follower_main, name=f"dynamo-rank{r}",
                            args=(config, r, host, port, devs[i], recv,
                                  cuda_graphs, timeout_s),
                            daemon=True)
            p.start()
            recv.close()
            procs[r] = p
            pipes.append(send)
    except BaseException:
        _kill(procs.values())
        raise
    return procs, pipes


def _kill(procs) -> None:
    for p in procs:
        p.kill()
        p.join(5.0)


def _hand_params(pipes, params) -> None:
    for send in pipes:
        send.send(params)
        send.close()


def launch_ranks(config, devices, params, cuda_graphs: bool,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 mh: Optional[MultihostContext] = None) -> RankProcesses:
    """The leader's side (launcher 0 of mh.world) of a mesh of config.dp *
    config.tp * config.sp ranks: host the store (at the coordinator, or
    on 127.0.0.1), spawn its local ranks 1.. on `devices` (each
    `follower_main`), wait for them to join, then wait up to
    DYN_MH_BARRIER_TIMEOUT_S for the other launchers' ranks, hand each
    local rank `params` (the full numpy tree or None) and make rank 0's
    Mesh.  The tree goes through a pipe once every rank is up, not with
    the spawn's arguments: a start blocks until its child has read
    those, after its imports, so large arguments would start the ranks
    one after another.  Raises (the spawned ranks killed) when a rank
    dies or does not join."""
    mh = mh or MultihostContext()
    mcfg = MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp)
    ranks = launcher_ranks(mcfg, mh.world, 0)
    devs = [str(d) for d in mesh_devices(mcfg, devices, mh.world)]
    world = mcfg.num_devices
    host, port = mh.store_address()
    store = rendezvous(0, world, port, timeout_s, host)
    join(store, 0, devs[0])
    procs, pipes = _spawn_local(config, ranks, host, store.port, devs,
                                cuda_graphs, timeout_s)
    remote = [r for r in range(world) if r not in ranks]
    try:
        _await_joins(store, procs, timeout_s)
        _await_remote(store, remote, len(ranks), barrier_timeout_s())
        _hand_params(pipes, params)
        mesh = make_mesh(mcfg, devs[0], 0, store, timeout_s)
    except BaseException:
        _kill(procs.values())
        raise
    return RankProcesses(mesh, list(procs.values()),
                         reports=list(range(1, world)), remote=remote)


def _connect(rank: int, world: int, host: str, port: int,
             timeout_s: float):
    """A follower launcher's connection to the leader's store, which may
    not be up yet: retried until timeout_s, then raised naming it."""
    try:
        return rendezvous(rank, world, port, timeout_s, host)
    except RuntimeError as e:
        raise RuntimeError(
            f"rank {rank}: the leader's store at {host}:{port} never came "
            f"within {timeout_s:.0f} s ({BARRIER_ENV}); "
            f"{str(e).splitlines()[0]}") from None


def join_ranks(config, devices, params, cuda_graphs: bool,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               mh: Optional[MultihostContext] = None) -> RankProcesses:
    """A follower launcher's side (mh.rank > 0): connect to the leader's
    store at the coordinator (waiting for it up to
    DYN_MH_BARRIER_TIMEOUT_S), join as its first local rank, spawn its
    other local ranks on `devices`, wait for them, hand them `params`
    (None: each takes the weights from config.model_path or config.seed)
    and make the first rank's Mesh.  The caller builds that rank's
    engine with `mesh=` and replays (`replay`)."""
    mh = mh or MultihostContext.detect()
    if mh.is_leader:
        raise ValueError("join_ranks is a follower launcher's; the leader "
                         "launches (launch_ranks)")
    mcfg = MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp)
    ranks = launcher_ranks(mcfg, mh.world, mh.rank)
    devs = [str(d) for d in mesh_devices(mcfg, devices, mh.world)]
    host, port = mh.store_address()
    store = _connect(ranks.start, mcfg.num_devices, host, port,
                     barrier_timeout_s())
    join(store, ranks.start, devs[0])
    procs, pipes = _spawn_local(config, ranks, host, port, devs,
                                cuda_graphs, timeout_s)
    try:
        _await_joins(store, procs, timeout_s)
        _hand_params(pipes, params)
        mesh = make_mesh(mcfg, devs[0], ranks.start, store, timeout_s)
    except BaseException:
        _kill(procs.values())
        raise
    return RankProcesses(mesh, list(procs.values()))


def replay(engine, mesh: Mesh) -> int:
    """A follower rank's life after its engine is built: run the leader's
    steps in order until `stop`, then leave its kernel launch counts and
    its engine's numeric metrics (with each ring prefill call's ms and,
    on a CUDA rank, its peak allocated bytes) in the store for the
    leader.  Returns the steps replayed."""
    from ..ops import launch_counts

    follower = StepFollower(GroupTransport(mesh.step).recv)
    n = 0
    for kind, arrays in follower.steps():
        engine.apply_step(kind, arrays)
        n += 1
    stats = {k: v for k, v in engine.metrics.items()
             if isinstance(v, (int, float))}
    stats["ring_calls_ms"] = engine.ring_calls_ms
    stats["steps_replayed"] = n
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        stats["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(mesh.device)
    mesh.store.set(f"launches/{mesh.rank}", json.dumps(launch_counts()))
    mesh.store.set(f"metrics/{mesh.rank}", json.dumps(stats))
    logger.info("rank %d replayed %d steps", mesh.rank, n)
    return n


def follower_main(config, rank: int, host: str, port: int, device: str,
                  params_pipe, cuda_graphs: bool, timeout_s: float) -> None:
    """A spawned rank: join the mesh at host:port, build this rank's
    engine on `device` (its shard of the params its launcher sends down
    `params_pipe`, or, for None, of the weights at config.model_path or
    from config.seed) and replay the leader's steps until `stop`."""
    from ..engine.core import TorchEngine

    logging.basicConfig(level=logging.INFO,
                        format=f"rank{rank} %(levelname)s %(name)s: "
                               "%(message)s")
    world = config.dp * config.tp * config.sp
    store = rendezvous(rank, world, port, timeout_s, host)
    join(store, rank, device)
    if not params_pipe.poll(timeout_s):
        raise RuntimeError(f"rank {rank}: no params from its launcher "
                           f"within {timeout_s:.0f} s")
    params = params_pipe.recv()
    params_pipe.close()
    mesh = make_mesh(MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp),
                     device, rank, store, timeout_s)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    else:
        # CPU ranks share the host's cores with the leader
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    engine = TorchEngine(config, params=params, device=mesh.device,
                         cuda_graphs=cuda_graphs, mesh=mesh)
    del params
    replay(engine, mesh)

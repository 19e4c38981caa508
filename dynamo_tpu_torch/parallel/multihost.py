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

What is left to a later step (ROADMAP.md): ranks across hosts (a
launcher per host, the leader's worker gating the followers' identity).
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
    Mesh,
    MeshConfig,
    make_mesh,
    mesh_devices,
    rendezvous,
)

logger = logging.getLogger(__name__)

# the kind that ends a follower
STOP = "stop"
# seconds the leader waits for a rank to exit after `stop`
JOIN_TIMEOUT_S = 30.0


@dataclass(frozen=True)
class MultihostContext:
    """Who this process is in its mesh: rank 0 leads."""

    rank: int = 0
    world: int = 1

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    @classmethod
    def detect(cls) -> "MultihostContext":
        """DYN_MH_RANK/DYN_MH_WORLD, as JAX's; a single process
        otherwise (the port has no process-wide distributed runtime to
        ask: a mesh's ranks are its engine's, parallel/mesh.py)."""
        if "DYN_MH_RANK" in os.environ:
            return cls(rank=int(os.environ["DYN_MH_RANK"]),
                       world=int(os.environ.get("DYN_MH_WORLD", "1")))
        return cls()


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
    """The leader's mesh and the processes of the other ranks."""

    mesh: Mesh
    procs: List[mp.Process]
    # per rank, its kernel launch counts and its engine's numeric metrics
    # as it reported them at stop
    launches: Dict[int, Dict[str, int]] = field(default_factory=dict)
    metrics: Dict[int, Dict[str, float]] = field(default_factory=dict)

    def close(self, publish_stop: Optional[Callable[[], None]] = None,
              timeout_s: float = JOIN_TIMEOUT_S) -> None:
        """Stop every rank: `publish_stop` (skipped when the stream is
        broken), join each with a timeout, kill one still alive, then
        read the launch counts and metrics the ranks left in the
        store."""
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
        for r in range(1, self.mesh.world):
            for into, key in ((self.launches, f"launches/{r}"),
                              (self.metrics, f"metrics/{r}")):
                if store.check([key]):
                    into[r] = json.loads(store.get(key))


def _await_joins(store, procs: List[mp.Process], timeout_s: float) -> None:
    """Wait until every spawned rank has connected to the store; raise
    naming a rank that died or did not join within timeout_s."""
    deadline = time.monotonic() + timeout_s
    pending = {r: p for r, p in enumerate(procs, start=1)}
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


def launch_ranks(config, devices, params, cuda_graphs: bool,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> RankProcesses:
    """Rank 0's side of a mesh of config.dp * config.tp * config.sp
    ranks on `devices`: host the store, spawn ranks 1.. (each
    `follower_main` on its device), wait for them to join, hand each
    `params` (the full numpy tree or None) and make rank 0's Mesh.  The tree goes through a
    pipe once every rank is up, not with the spawn's arguments: a start
    blocks until its child has read those, after its imports, so large
    arguments would start the ranks one after another.  Raises (the
    spawned ranks killed) when a rank dies or does not join."""
    mcfg = MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp)
    devs = [str(d) for d in mesh_devices(mcfg, devices)]
    world = mcfg.num_devices
    store = rendezvous(0, world, 0, timeout_s)
    ctx = mp.get_context("spawn")
    procs: List[mp.Process] = []
    pipes = []
    try:
        for r in range(1, world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=follower_main, name=f"dynamo-rank{r}",
                            args=(config, r, store.port, devs, recv,
                                  cuda_graphs, timeout_s),
                            daemon=True)
            p.start()
            recv.close()
            procs.append(p)
            pipes.append(send)
        _await_joins(store, procs, timeout_s)
        for send in pipes:
            send.send(params)
            send.close()
        mesh = make_mesh(mcfg, devs, 0, store, timeout_s)
    except BaseException:
        for p in procs:
            p.kill()
            p.join(5.0)
        raise
    return RankProcesses(mesh, procs)


def follower_main(config, rank: int, port: int, devices: List[str],
                  params_pipe, cuda_graphs: bool, timeout_s: float) -> None:
    """A spawned rank: join the mesh, build this rank's engine (its shard
    of the params the leader sends down `params_pipe`, or, for None, of
    the weights the leader's engine loads or makes from config.seed) and
    replay the leader's steps until `stop`; then leave the kernel launch
    counts and the engine's numeric metrics (with each ring prefill
    call's ms and, on a CUDA rank, its peak allocated bytes) in the
    store for the leader."""
    from ..engine.core import TorchEngine
    from ..ops import launch_counts

    logging.basicConfig(level=logging.INFO,
                        format=f"rank{rank} %(levelname)s %(name)s: "
                               "%(message)s")
    world = config.dp * config.tp * config.sp
    store = rendezvous(rank, world, port, timeout_s)
    store.set(f"joined/{rank}", "1")
    if not params_pipe.poll(timeout_s):
        raise RuntimeError(f"rank {rank}: no params from the leader within "
                           f"{timeout_s:.0f} s")
    params = params_pipe.recv()
    params_pipe.close()
    mesh = make_mesh(MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp),
                     devices, rank, store, timeout_s)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    else:
        # CPU ranks share the host's cores with the leader
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    engine = TorchEngine(config, params=params, device=mesh.device,
                         cuda_graphs=cuda_graphs, mesh=mesh)
    del params
    follower = StepFollower(GroupTransport(mesh.step).recv)
    n = 0
    for kind, arrays in follower.steps():
        engine.apply_step(kind, arrays)
        n += 1
    stats = {k: v for k, v in engine.metrics.items()
             if isinstance(v, (int, float))}
    stats["ring_calls_ms"] = engine.ring_calls_ms
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        stats["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(mesh.device)
    store.set(f"launches/{rank}", json.dumps(launch_counts()))
    store.set(f"metrics/{rank}", json.dumps(stats))
    logger.info("rank %d replayed %d steps", rank, n)

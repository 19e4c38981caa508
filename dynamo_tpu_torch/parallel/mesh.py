"""The device mesh of a tensor-, data- and sequence-parallel engine, and
its sharding rules.

The counterpart of dynamo_tpu/parallel/mesh.py.  Axes, as there:

  dp  data parallel: replicas of the model, each with its own KV cache
      (every replica runs the same step stream, so they compute alike);
  tp  tensor parallel: attention heads, the MLP's hidden width, the
      experts of a MoE layer and the vocabulary split over the ranks of
      one replica, the KV cache over its kv heads (Megatron's layout;
      MLA's latent cache, one head, is whole on every rank);
  sp  sequence parallel: the ring prefill's axis (models/llama.py
      prefill_ring over ops/ring_attention.py).  The cache stays whole
      over sp (JAX's kv_cache_spec names no sp axis), so the ranks at
      s != 0 hold replicas of their s = 0 peer's slab and run every
      other program alike.

JAX runs a mesh as ONE program: GSPMD places the shards and inserts the
collectives.  PyTorch has neither, so here every rank is a process with
its own device, its own shard of the weights and cache, and process
groups (torch.distributed) for the collectives the forward needs
(models/llama.py, models/deepseek.py) and for the leader's step
stream (multihost.py).  The stream's gather and inject steps make the
cross-rank KV moves of disaggregation and the KVBM tiers: the ranks'
kv-head slabs gathered into the leader's logical blocks over the tensor
group (`gather_slabs`), and a rank's slab cut out of a logical payload
(`payload_slab`).
Rank r sits at mesh coordinates (dp, tp, sp) in the order of JAX's
`reshape(dp, tp, sp)`: r = (d * tp + t) * sp + s.

Groups are made from the process-group classes themselves over one
TCPStore (rank 0 hosts it on the coordinator's port, parallel/
multihost.py; the others connect to it), not through
`init_process_group`: the default group is a process-wide singleton, and
a process may hold one tensor-parallel engine after another, or a
tensor-parallel engine beside a single-device one.  The store's host is
the coordinator's (`rendezvous(..., host=)`); a mesh built without one
meets on 127.0.0.1 (`STORE_HOST`).  TCPStore's server listens on every
interface, so ranks on other hosts reach it at the coordinator's
address.

Each rank announces itself at join (`join`): `joined/{rank}` holds its
(host, card) identity, `{"node", "device"}` as disagg/device_transfer.py
names a card: the host's boot id, and the card's UUID (or "cpu").  A
group's backend follows from its members' identities (`group_backend`),
so two hosts' cuda:0 are two cards, and two ranks of one card (on one
host or two launchers of one machine) are one.  Each rank has

  * a tensor group (`Mesh.tensor`), the tp ranks that share its (d, s): NCCL
    where every rank of the group has a CUDA card of its own, gloo
    where ranks share a card or run on the CPU (NCCL refuses two ranks
    on one device);
  * a ring group (`Mesh.ring`, None at sp = 1), the sp ranks that share
    its (d, t), consecutive ranks in ring order: the ring prefill's
    neighbour exchange, and the gather and broadcast around it
    (`RingGroup`); its backend follows the same rule;
  * the step group (`Mesh.step`), every rank, gloo on the CPU: the step
    stream's transport.

The s = 0 tensor group of the leader's dp replica is the one that
gathers the logical KV blocks (`gather_slabs`); every other tensor
group holds a replica of a slab that group already has.

Every group is made with a bounded timeout, so a rank that hangs
surfaces as an error on the others; one that dies closes its sockets,
and gloo raises at once.

The gloo groups bind where torch's own ProcessGroupGloo constructor
binds them: to the interfaces named in GLOO_SOCKET_IFNAME when it is
set, else to the address this host's name resolves to (loopback only
when the name resolves to no usable address).  A mesh across hosts
therefore needs each host's name to resolve to an address the other
hosts reach, or GLOO_SOCKET_IFNAME set on every launcher.  NCCL picks
its own interfaces (NCCL_SOCKET_IFNAME).

`parallel/compat.py` of the JAX package (a shim over JAX versions'
shard_map spellings) has no counterpart: nothing here maps over shards.
"""

from __future__ import annotations

import datetime
import json
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a collective, a join or a group's rendezvous may wait for a peer
DEFAULT_TIMEOUT_S = 300.0
# the rendezvous host of a mesh built without a coordinator (every rank
# on this machine)
STORE_HOST = "127.0.0.1"


@dataclass
class MeshConfig:
    dp: int = 1
    tp: int = 1
    sp: int = 1  # sequence parallel: the ring axis

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.sp


def launcher_ranks(cfg: MeshConfig, hosts: int = 1,
                   host: int = 0) -> range:
    """The ranks launcher `host` of `hosts` owns: L = num_devices / hosts
    consecutive ranks from host * L, as JAX's processes each hold their
    local devices.  Raises ValueError when `hosts` does not divide the
    mesh."""
    world = cfg.num_devices
    if hosts < 1 or world % hosts:
        raise ValueError(f"a mesh of {world} ranks does not divide over "
                         f"{hosts} launchers")
    if not 0 <= host < hosts:
        raise ValueError(f"launcher {host} outside {hosts} launchers")
    n = world // hosts
    return range(host * n, (host + 1) * n)


def mesh_devices(cfg: MeshConfig, devices: Sequence,
                 hosts: int = 1) -> List[torch.device]:
    """The devices of one launcher's ranks: the first num_devices / hosts
    of `devices` as torch.devices, in rank order; raises JAX's ValueError
    when there are fewer (and launcher_ranks' when `hosts` does not
    divide the mesh).  A device may repeat (["cuda:0", "cuda:0"], ["cpu",
    "cpu"]): the counterpart of JAX's virtual CPU mesh."""
    n = len(launcher_ranks(cfg, hosts))
    devices = list(devices)
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return [torch.device(d) for d in devices[:n]]


def rank_coords(cfg: MeshConfig, rank: int) -> Tuple[int, int, int]:
    """Rank -> its (dp, tp, sp) coordinates."""
    if not 0 <= rank < cfg.num_devices:
        raise ValueError(f"rank {rank} outside a mesh of "
                         f"{cfg.num_devices} ranks")
    return (rank // (cfg.tp * cfg.sp), (rank // cfg.sp) % cfg.tp,
            rank % cfg.sp)


def tensor_group_ranks(cfg: MeshConfig, dp_rank: int,
                       sp_rank: int = 0) -> List[int]:
    """The ranks of the tensor group at (dp_rank, sp_rank), in tp
    order."""
    return [(dp_rank * cfg.tp + t) * cfg.sp + sp_rank for t in range(cfg.tp)]


def ring_group_ranks(cfg: MeshConfig, dp_rank: int,
                     tp_rank: int) -> List[int]:
    """The ranks of the ring group at (dp_rank, tp_rank), in ring order:
    consecutive ranks, since r = (d * tp + t) * sp + s."""
    base = (dp_rank * cfg.tp + tp_rank) * cfg.sp
    return list(range(base, base + cfg.sp))


def node_id() -> str:
    """This host's identity: its boot id (two containers of one host share
    it, as disagg/device_transfer.py's capability reads it), else its
    name."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return socket.gethostname()


def rank_identity(device: torch.device) -> Dict[str, str]:
    """A rank's (host, card) identity, `{"node", "device"}`: the device
    is "cpu", or "cuda:" and the card's UUID where torch reports one (two
    processes that see one card under different indices name it alike),
    else the device's name."""
    device = torch.device(device)
    card = str(device)
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid",
                       None)
        if uuid is not None:
            card = f"cuda:{uuid}"
    return {"node": node_id(), "device": card}


def group_backend(members: Sequence) -> str:
    """"nccl" when every rank of a group has a CUDA card of its own, else
    "gloo" (ranks on the CPU, or ranks sharing a card).  A member is a
    rank's identity (`rank_identity`'s {"node", "device"}), or a
    torch.device of this host."""
    ids = [("", str(m)) if isinstance(m, torch.device)
           else (m["node"], m["device"]) for m in members]
    cuda = all(dev.startswith("cuda") for _, dev in ids)
    return "nccl" if cuda and len(set(ids)) == len(ids) else "gloo"


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def param_sharding_rules() -> Dict[str, Optional[int]]:
    """The axis each parameter splits over tp, by its innermost tree key:
    JAX's PartitionSpec table (the "tp" entry's position; None =
    replicated).  Column-parallel projections split their output
    features, row-parallel ones their input features (one all-reduce
    after each), the embedding and lm_head the vocabulary."""
    return {
        "embedding": 0,      # [vocab, d_model]
        "wq": 1,             # [d_model, q_heads*hd]
        "wk": 1,             # [d_model, kv_heads*hd]
        "wv": 1,
        "wo": 0,             # [q_heads*hd, d_model]
        "w_gate": 1,         # [d_model, ffn]
        "w_up": 1,
        "w_down": 0,         # [ffn, d_model]
        "norm": None,
        "lm_head": 1,        # [d_model, vocab]
        # MoE (expert-sharded over tp)
        "moe_gate": None,
        "moe_w_gate": 0,     # [experts, d_model, ffn]
        "moe_w_up": 0,
        "moe_w_down": 0,
        # MLA (DeepSeek family): heads through the query up-projection and
        # the latent up-projections; the shared latent path is replicated
        "wq_a": None,        # [d_model, q_lora_rank]
        "wq_b": 1,           # [q_lora_rank, nh*qk_head]
        "wkv_a": None,       # [d_model, R+dr]
        "w_uk": 0,           # [nh, R, dn]
        "w_uv": 0,           # [nh, R, dv]
    }


def chunk_range(n: int, rank: int, tp: int, what: str = "axis"
                ) -> Tuple[int, int]:
    """[lo, hi) of rank's contiguous chunk of n; raises unless tp divides
    n."""
    if n % tp:
        raise ValueError(f"{what} of {n} does not divide over tp={tp}")
    step = n // tp
    return rank * step, (rank + 1) * step


def shard_leaf(name: Optional[str], leaf, rank: int, tp: int):
    """Rank's shard of one parameter (a numpy array or a tensor) by the
    rule of its innermost key `name`: a contiguous chunk along the rule's
    axis, the whole leaf where the rule (or the name) has none.  A torch
    shard is a fresh tensor, so the full one can be freed."""
    axis = param_sharding_rules().get(name) if tp > 1 else None
    if axis is None:
        return leaf
    lo, hi = chunk_range(leaf.shape[axis], rank, tp, f"{name} axis {axis}")
    out = leaf[(slice(None),) * axis + (slice(lo, hi),)]
    if isinstance(out, torch.Tensor):
        return out.clone(memory_format=torch.contiguous_format)
    return out


def shard_params(params: Any, rank: int, tp: int) -> Any:
    """Rank's shard of a full parameter tree (nested dicts and lists of
    numpy arrays or tensors): each leaf cut by the rule of the innermost
    dict key on its path, the tree's structure kept."""

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return shard_leaf(name, node, rank, tp)

    return walk(params, None)


def kv_cache_spec(rank: int, tp: int, n_kv_heads: int) -> slice:
    """Rank's kv heads of the cache [L, nkv, blocks, bs, hd] (axis 1):
    the same split as the attention heads, so a rank's slab is one
    contiguous range of heads."""
    return slice(*chunk_range(n_kv_heads, rank, tp, "n_kv_heads"))


def kv_scale_spec(rank: int, tp: int, n_kv_heads: int) -> slice:
    """Rank's kv heads of an int8 cache's scale planes [L, nkv, blocks,
    bs] (axis 1): the cache's split, so a rank's scale planes sit beside
    its slab."""
    return kv_cache_spec(rank, tp, n_kv_heads)


def head_slabs(n_heads: int, n_kv_heads: int, rank: int,
               tp: int) -> Tuple[slice, slice]:
    """(query heads, kv heads) of rank's attention slab: GQA groups are
    kv-major and contiguous, so kv head j's whole query group, heads
    [j*g, (j+1)*g), lives on the rank that holds j.  Raises unless tp
    divides both counts."""
    kv = kv_cache_spec(rank, tp, n_kv_heads)
    q = slice(*chunk_range(n_heads, rank, tp, "n_heads"))
    return q, kv


def shard_config(cfg, tp: int):
    """The model config a rank runs, its local counts (the vocabulary
    stays whole: the logits are gathered).  tp = 1 returns cfg itself.

      * Llama, dense: heads, kv heads and the MLP width divided by tp;
      * Llama, MoE: heads, kv heads and the experts divided by tp, each
        expert's width whole (the stacks split on the expert axis);
      * MLA: the heads, the experts and ffn_dim (the dense layers' MLP
        and the shared experts' columns) divided by tp, the latent ranks
        and each routed expert's width whole.

    Raises unless tp divides each count it divides."""
    if tp == 1:
        return cfg
    import dataclasses

    moe = getattr(cfg, "n_experts", 0) > 0
    names = ["n_heads", "vocab_size"]
    if hasattr(cfg, "n_kv_heads"):
        names.append("n_kv_heads")
    if moe:
        names.append("n_experts")
    if not moe or hasattr(cfg, "kv_lora_rank"):
        names.append("ffn_dim")
    for name in names:
        chunk_range(getattr(cfg, name), 0, tp, name)
    local = {n: getattr(cfg, n) // tp for n in names if n != "vocab_size"}
    if hasattr(cfg, "kv_lora_rank") and moe:
        # a routed expert keeps its width: moe_ffn_dim 0 reads ffn_dim
        local["moe_ffn_dim"] = cfg.moe_ffn_dim or cfg.ffn_dim
        sf = cfg.n_shared_experts * local["moe_ffn_dim"]
        chunk_range(sf, 0, tp, "the shared experts' width")
    return dataclasses.replace(cfg, **local)


def kv_heads_replicated(cfg) -> bool:
    """True where every rank holds the whole cache (MLA's latent pair:
    one head, replicated), False where a rank holds its kv heads."""
    return not hasattr(cfg, "n_kv_heads")


# ---------------------------------------------------------------------------
# the cross-rank KV moves (KV payloads in the universal transfer layout,
# ops/kv_transfer.py: [L, nb, bs, nkv, hd], scale planes [L, nb, bs, nkv])
# ---------------------------------------------------------------------------

# the kv-head axis of every universal payload array
KV_HEAD_AXIS = 3


def payload_slab(arrays, heads: Optional[slice]) -> tuple:
    """A rank's slab of a logical payload: each array's kv heads `heads`,
    contiguous (None: the whole payload, as a replicated cache takes
    it)."""
    if heads is None:
        return tuple(arrays)
    return tuple(a[(slice(None),) * KV_HEAD_AXIS + (heads,)].contiguous()
                 for a in arrays)


def gather_slabs(group: "TensorGroup", slab) -> Optional[tuple]:
    """The leader's logical payload from every rank's slab (`slab`: one
    rank's arrays in the universal layout, in payload order): each array
    gathered to group rank 0 and concatenated over the kv heads in rank
    order.  Every rank of the group calls this with its own slab; rank 0
    gets the payload, the others None."""
    parts = [group.gather(a) for a in slab]
    if group.rank != 0:
        return None
    return tuple(torch.cat(p, dim=KV_HEAD_AXIS) for p in parts)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def rendezvous(rank: int, world: int, port: int = 0,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               host: str = STORE_HOST) -> dist.TCPStore:
    """The mesh's store at host:port: rank 0 hosts it (port 0 = any free
    port; read the one it took from `.port`), the others connect to it,
    retrying until timeout_s."""
    return dist.TCPStore(host, port, world, rank == 0,
                         timeout=_timeout(timeout_s),
                         wait_for_workers=False)


def join(store, rank: int, device: torch.device) -> None:
    """Announce `rank` in the store with its identity (`joined/{rank}`):
    the key the leader waits on and each group's backend reads."""
    store.set(f"joined/{rank}", json.dumps(rank_identity(device)))


def _identities(store, ranks: Sequence[int]) -> List[Dict[str, str]]:
    """The joined identities of `ranks` (a get waits for a key up to the
    store's timeout)."""
    return [json.loads(store.get(f"joined/{r}")) for r in ranks]


def clamp_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Token ids as JAX's gather reads them: a negative id wraps once
    (id + vocab), then every id is clamped to [0, vocab - 1], so an id
    past the vocabulary reads the last row and the lookup never faults.
    Block hashes, KV events and the n-gram proposer keep the raw ids;
    only the embedding gather sees these."""
    ids = ids.long()
    return torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)


class TensorGroup:
    """The collectives of a rank's tensor-parallel forward, over its
    tensor group: the sum after each row-parallel product, the
    vocab-parallel embedding lookup, the gather of the vocab-parallel
    logits and of the fused epilogue's statistics; and the gather of the
    ranks' KV slabs to the leader (`gather_slabs`)."""

    def __init__(self, backend: str, pg, rank: int, size: int):
        self.backend, self.pg, self.rank, self.size = backend, pg, rank, size

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in place (x contiguous); returns x."""
        self.pg.allreduce([x]).wait()
        return x

    def embed(self, table: torch.Tensor, ids: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """The vocab-parallel lookup: each rank gathers the ids its rows
        [rank*V/tp, (rank+1)*V/tp) hold, zeros elsewhere, and the sum
        over the group is the full embedding.  The ids are first clamped
        to the whole vocabulary V as JAX's gather clamps them (a negative
        id wraps once, then [0, V-1]), so an id past V reads the last
        rank's last row instead of zeros.  ids any shape; returns
        [*ids.shape, d] in dtype."""
        n = table.shape[0]
        local = clamp_ids(ids, n * self.size) - self.rank * n
        mine = (local >= 0) & (local < n)
        x = table[torch.where(mine, local, 0)].to(dtype)
        x = x * mine[..., None].to(dtype)
        return self.all_reduce(x.contiguous())

    def gather(self, x: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's x (one shape and dtype on all ranks) on group rank
        0, in rank order; None on the others.  NCCL gathers x where it
        lies; gloo gathers host copies (its gather of CUDA tensors varies
        between torch builds), so rank 0 gets CPU tensors there."""
        x = (x if self.backend == "nccl" else x.cpu()).contiguous()
        opts = dist.GatherOptions()
        opts.rootRank = 0
        outs = ([[torch.empty_like(x) for _ in range(self.size)]]
                if self.rank == 0 else [])
        self.pg.gather(outs, [x], opts).wait()
        return outs[0] if self.rank == 0 else None

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The full [..., V] logits from each rank's vocab slice [...,
        V/tp] (rank order along the last axis).  NCCL gathers them; gloo,
        whose all-gather of CUDA tensors varies between torch builds,
        sums each slice into a zeroed [..., V] buffer instead."""
        n = logits.shape[-1]
        if self.backend == "nccl":
            parts = torch.empty((self.size, *logits.shape),
                                dtype=logits.dtype, device=logits.device)
            self.pg._allgather_base(parts, logits.contiguous()).wait()
            return torch.cat(list(parts.unbind(0)), dim=-1)
        full = torch.zeros((*logits.shape[:-1], n * self.size),
                           dtype=logits.dtype, device=logits.device)
        full[..., self.rank * n:(self.rank + 1) * n] = logits
        return self.all_reduce(full)

    def gather_stats(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (one shape and dtype on all ranks) on every rank,
        stacked in rank order: [size, *x.shape].  The vocab-parallel
        sampling epilogue's one collective a step (ops/fused_sampling.py:
        each rank's [B, 2 CAP + 3] statistics, not its [B, V/tp]
        logits).  NCCL all-gathers; gloo sums each rank's row into a
        zeroed buffer, as gather_vocab does (adding zeros is exact)."""
        out_shape = (self.size, *x.shape)
        if self.backend == "nccl":
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            self.pg._allgather_base(out, x.contiguous()).wait()
            return out
        out = torch.zeros(out_shape, dtype=x.dtype, device=x.device)
        out[self.rank] = x
        return self.all_reduce(out)


class RingGroup:
    """The collectives of the sequence-parallel ring over a rank's ring
    group (`rank` its position s, `size` the sp ranks): the neighbour
    exchange that rotates K/V shards (ops/ring_attention.py) and
    activations (parallel/pipeline.py), and the gather, broadcast and
    sum around them.

    gloo stages every tensor but a sum through a host copy, as
    TensorGroup.gather does, and hands the result back on the input's
    device.  NCCL moves tensors where they lie; its exchange is one
    all-to-all whose only non-empty splits are the two neighbours, a
    single collective, so no pair of sends can wait on each other."""

    def __init__(self, backend: str, pg, rank: int, size: int):
        self.backend, self.pg, self.rank, self.size = backend, pg, rank, size
        self.next = (rank + 1) % size
        self.prev = (rank - 1) % size
        self.sent_bytes = 0  # bytes this rank has put on the ring

    def _staged(self, x: torch.Tensor, sends: bool = True) -> torch.Tensor:
        t = (x if self.backend == "nccl" else x.detach().cpu()).contiguous()
        if sends:
            self.sent_bytes += t.numel() * t.element_size()
        return t

    def exchange(self, x: torch.Tensor) -> Callable[[], torch.Tensor]:
        """Send x to the next rank and receive the previous rank's tensor
        of x's shape and dtype; returns a wait() that gives it, on x's
        device.  Both transfers are posted before either is waited on,
        so the caller computes while they run, and sp = 2, where both
        neighbours are one rank, cannot deadlock."""
        send = self._staged(x)
        recv = torch.empty_like(send)
        if self.backend == "nccl":
            n = send.shape[0]
            ins = [n if r == self.next else 0 for r in range(self.size)]
            outs = [n if r == self.prev else 0 for r in range(self.size)]
            works = [self.pg.alltoall_base(recv, send, outs, ins,
                                           dist.AllToAllOptions())]
        else:
            works = [self.pg.recv([recv], self.prev, 0),
                     self.pg.send([send], self.next, 0)]

        def wait() -> torch.Tensor:
            for w in works:
                w.wait()
            return recv.to(x.device)

        return wait

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (one shape and dtype on all ranks), concatenated
        along dim 0 in ring order, on x's device."""
        src = self._staged(x)
        if self.backend == "nccl":
            out = torch.empty((self.size * src.shape[0], *src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            self.pg._allgather_base(out, src).wait()
            return out
        outs = [torch.empty_like(src) for _ in range(self.size)]
        self.pg.allgather([outs], [src]).wait()
        return torch.cat(outs).to(x.device)

    def broadcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """Ring rank `root`'s x on every rank (x gives the shape and dtype
        elsewhere), on x's device."""
        t = self._staged(x, sends=self.rank == root)
        if t is x:
            t = t.clone()
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        self.pg.broadcast([t], opts).wait()
        return t.to(x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ring, in place (x contiguous); returns x."""
        self.pg.allreduce([x]).wait()
        return x


def _gloo(store, name: str, rank: int, size: int, timeout_s: float):
    return dist.ProcessGroupGloo(dist.PrefixStore(name, store), rank, size,
                                 _timeout(timeout_s))


def _nccl(store, name: str, rank: int, ranks: List[int], timeout_s: float):
    opts = dist.ProcessGroupNCCL.Options()
    opts.is_high_priority_stream = False
    opts._timeout = _timeout(timeout_s)
    opts.global_ranks_in_group = ranks
    opts.group_name = name
    return dist.ProcessGroupNCCL(dist.PrefixStore(name, store), rank,
                                 len(ranks), opts)


@dataclass
class Mesh:
    """One rank's place in the mesh: its coordinates, its device and its
    groups (`tensor` is None at tp = 1, `ring` at sp = 1)."""

    cfg: MeshConfig
    rank: int
    device: torch.device
    backend: str                      # the tensor groups' backend
    store: Any                        # the TCPStore (rank 0 hosts it)
    step: Any                         # every rank, gloo on the CPU
    tensor: Optional[TensorGroup]
    timeout_s: float = DEFAULT_TIMEOUT_S
    ring: Optional[RingGroup] = None

    @property
    def world(self) -> int:
        return self.cfg.num_devices

    @property
    def dp_rank(self) -> int:
        return rank_coords(self.cfg, self.rank)[0]

    @property
    def tp_rank(self) -> int:
        return rank_coords(self.cfg, self.rank)[1]

    @property
    def sp_rank(self) -> int:
        return rank_coords(self.cfg, self.rank)[2]

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


def make_mesh(cfg: MeshConfig, device, rank: int, store,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Rank's Mesh over `store` (rendezvous), `device` its own: every rank
    of the mesh calls this with the same cfg once it has joined (`join`);
    each group's backend follows from its members' joined identities, and
    each group's construction waits for its members.  Every rank builds
    its groups in one order (step, tensor, ring) and the groups of each
    kind are disjoint, so no two ranks wait on each other's next
    group."""
    d, t, s = rank_coords(cfg, rank)
    ranks = tensor_group_ranks(cfg, d, s)
    backend = group_backend(_identities(store, ranks))
    step = _gloo(store, "step", rank, cfg.num_devices, timeout_s)
    tensor = None
    if cfg.tp > 1:
        name = f"tp{d}.{s}"
        pg = (_nccl(store, name, t, ranks, timeout_s) if backend == "nccl"
              else _gloo(store, name, t, cfg.tp, timeout_s))
        tensor = TensorGroup(backend, pg, t, cfg.tp)
    ring = None
    if cfg.sp > 1:
        rranks = ring_group_ranks(cfg, d, t)
        rbackend = group_backend(_identities(store, rranks))
        name = f"sp{d}.{t}"
        pg = (_nccl(store, name, s, rranks, timeout_s)
              if rbackend == "nccl"
              else _gloo(store, name, s, cfg.sp, timeout_s))
        ring = RingGroup(rbackend, pg, s, cfg.sp)
    return Mesh(cfg, rank, torch.device(device), backend, store, step,
                tensor, timeout_s, ring)


def default_devices(cfg: MeshConfig, device: torch.device) -> List[str]:
    """The devices of a mesh whose caller lists none: every rank on the CPU
    when `device` is the CPU, else the visible CUDA devices in order
    (`mesh_devices` takes the first cfg.num_devices, or raises)."""
    if device.type == "cpu":
        return ["cpu"] * cfg.num_devices
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]

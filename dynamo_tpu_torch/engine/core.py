"""The PyTorch engine core: continuous batching over a paged KV cache.

The counterpart of dynamo_tpu/engine/core.py (`JaxEngine`), with the
same request contract (`generate(PreprocessedRequest, token=None)` ->
async stream of `LLMEngineOutput`) and the same scheduling of the main
path, the overlapped scheduler by default.  Each scheduler step runs on
a worker thread, as `_sched_step` does there:

  * cancellations are reaped and waiting requests admitted through the
    block allocator, reusing prefix-cache hits (engine/block_allocator.py);
  * the previous step's deferred first tokens are read back and emitted;
  * ONE budget-capped packed prefill dispatch runs the prefilling slots'
    chunks as a single padding-free stream (engine/prefill.py plans it;
    the bucket's program, models/llama.py prefill_packed and the
    sampler, is replayed from a captured CUDA graph, engine/graphs.py
    PrefillPrograms; kernel K3 attends); in overlap mode its first
    tokens are read back one step late.  Capacity-dispatch MoE is not
    packed-safe: its slots take the JAX engine's padded programs
    instead (one slot: `prefill` padded to its bucket; several:
    `prefill_batched` with equal budget shares), run eagerly
    (engine/graphs.py PaddedPrefillPrograms);
  * ONE decode burst runs every slot past prefill: k fused decode steps
    (k on the fusion ladder, adapted to pending work) at the fixed batch
    B = max_num_seqs, replayed from a captured CUDA graph
    (engine/graphs.py; kernel K1 attends).  Up to decode_pipeline_depth-1
    bursts stay unread while the next runs, their sampled ids chained on
    the device; a steady-state burst re-dispatches the device descriptor
    with an in-program advance and uploads nothing;
  * the oldest burst's tokens stream back, blocks are committed to the
    prefix cache once their K/V is materialized, and stop conditions
    finish requests (a mid-burst finish discards the overshoot).

The model family is bound once (`self.family`, models/__init__.py
get_family): Llama, Qwen and Mixtral (models/llama.py), or the DeepSeek
MLA family (models/deepseek.py), whose engine has no packed prefill, no
verify path, no int8 cache, no LoRA and no hidden-state decode: its
prefill takes the padded programs, and int8, the fused epilogue and
speculative decoding fall back to bf16, "off" and plain decode with the
JAX engine's warnings (LoRA and a packed_attn_impl raise its errors).
The decode bursts capture as Llama's do.

`overlap_scheduling=False` is the lockstep reference mode (dispatch,
block on the device, emit), greedy byte-identical to the overlapped one.

Every block allocator mutation's KV events (stored/removed hashes) are
netted through the consolidator on the scheduler thread, in mutation
order, and handed to `kv_event_sink(stored, removed, tier)` on the event
loop's thread (engine/worker.py publishes them); every prefill dispatch
and decode burst appends one forward-pass-metrics record to `fpm`, with
the keys of the JAX engine's records.

With `sampling_epilogue="fused"` every decode program streams the final
projection through ops/fused_sampling.py instead of materializing the
logits.  Weights come from `params`, from the HF checkpoint at
`config.model_path` (models/loader.py, through the host weight cache),
or are random from config.seed.

Disaggregated serving (the JAX engine's park/pull/inject): a request
annotated DISAGG_ANNOTATION is a prefill hop, whose KV is parked when its
prompt completes (one frame with finish_reason "stop" and
kv_transfer_params goes back); the decode worker's pull reads it chunk
by chunk (extract_parked_chunk, one scheduler op each) and releases it.
A request whose disaggregated_params name engine "jax" (the wire
protocol, not the framework) is pulled instead of prefilled: its slot
sits admitted but idle while `_stream_pull` injects chunk after chunk
(ops/kv_transfer.py), other slots decoding in between, then streams on
from the transferred first token.  A failed pull falls back to local
prefill, as in the JAX engine.  Scheduler ops (`_call_on_scheduler`)
run between steps under the step lock.

KVBM (the JAX engine's tiers, kvbm/): with host_cache_blocks > 0 each
step copies the coldest evictable device blocks to G2 before eviction
destroys them (`_maybe_offload`).  On CUDA the gather is enqueued behind
the bursts in flight, the copies into pinned host tensors run on a side
stream, and the blocks commit to G2 (stored(g2)) at a later step, once
their event has completed: the scheduler never waits on an offload, and
nothing reads the bytes before they landed.  On the CPU the copy is synchronous and the
blocks commit in the same step, as in the JAX engine.  G2's victims
demote to G3 (a disk directory) and spill to G4 (a shared object store)
on the scheduler thread, as in JAX.  Admission extends a device prefix
hit with a run onboarded from G2/G3/G4 (`_try_onboard`: each block's
host tensors uploaded into a staging buffer, one in-place inject) instead
of prefilling it again, and `generate` first pulls a prompt's missing
leading blocks from a peer's host tiers into G2 (`_remote_prefetch`,
kvbm/remote.py, installed by the worker).  A failed tier read or pull
falls back to local prefill.

Speculative decoding (the JAX engine's, spec/): with spec_decode
"ngram" or "draft" each step after the prefill dispatch proposes drafts
for the decoding slots, scores them in one packed verify dispatch (a
captured program per stream bucket, kernel K3 attends), accepts on the
host and rolls rejected block growth back (`_spec_step`); those slots
skip the step's decode burst.

LoRA (the JAX engine's, lora/): with lora_max_adapters > 0 a stacked
adapter bank (slot 0 all zeros) sits in every captured decode and
prefill program, read through a `lidx` lane per decode lane and per
packed token, so base and adapter requests share each dispatch.
Adapters load from lora_dir on their first request (`_resolve_lora`:
the file read off the scheduler, the in-place bank write a scheduler
op, LRU eviction among slots no sequence references).  Block hashes are
salted by the adapter's name.

Guided decoding (the JAX engine's, guided/): a request with
sampling.guided_json steps alone, one token a scheduler step, through
the guided top-M program (engine/graphs.py GuidedPrograms; M = 32, then
a widened 256 when no candidate fits): the host tries the candidates in
sampled order and keeps the first whose text is still a valid prefix of
a schema-conforming document (the codec: `guided_codec`, installed by
the worker from its MDC, else the byte mock), and closes the document
canonically when nothing fits or the budget runs out.  Guided slots
take no decode burst and no speculation.

`set_slo_burn` (fed by the worker's SLO subscription) scales the
prefill chunk budget down while the frontends report an error-budget
burn above slo_yield_burn, as in the JAX engine.

Observability (obs/): every scheduler phase is a timeline span of the
JAX engine's taxonomy on one logical track per engine (`step`, `sched`
or `enqueue_ahead`, `prefill_dispatch`, `decode_dispatch`,
`device_wait`, `sample`, `kvbm_offload`/`kvbm_onboard`, `kv_pull`), one
`None` check each when tracing is off; every program build is recorded
by the capture watch (`capture_watch`, obs/compile_watch.py), and the
prefill, decode and spec_verify FPM records carry the program's cost
count (obs/costs.py) under the JAX names `xla_flops`/`xla_bytes`.  A
drain abort and an engine crash dump the flight recorder.

The KV ledger (obs/kv_ledger.py, on unless `kv_ledger=False` or
DYN_KV_LEDGER=0) keeps a second set of block books: the allocator records
every G1 transition into it, `_emit_events` every KVBM tier batch, the
disagg park/unpark and the onboard marks land beside them, and the
auditor reconciles them against the allocator, the live slots and the
pool manifests on the step after a finish, on the idle tick and on
demand (`audit_kv`, the worker's /debug/kv), always between steps under
the step lock.  The G4 sweep reads its lineage books
(kvbm/residency.py).  Every stream's first-token and finish frames carry
`metrics["forensic"]` (`_forensic`: realized prefix reuse, queue
position, prefill chunks, tokens generated), as the JAX engine's.
`prefill_packed=False` routes every family to the padded programs.

`embed(token_ids)` serves the worker's `embed` endpoint for a family
with `embed_text` (the Llama family, dense and MoE; not MLA, as in
JAX): the family's pooled embedding padded to a prefill bucket, run
eagerly between steps on the scheduler's thread (an `embed_fetch`
device_wait span; the first call at a bucket is the capture watch's
"embed" record).

Tensor and data parallelism (parallel/): with dp * tp > 1 the engine the
caller builds is rank 0 of a mesh.  It spawns the other ranks
(parallel/multihost.py launch_ranks), each of which builds an engine on
its own device with its shard of the weights (models/llama.py's tp
forward, its config `shard_cfg`) and of the cache (its kv heads, from
the same num_blocks: kv_hbm_gb budgets the whole cache, each rank holds
1/tp of it), and replays the leader's step stream through `apply_step`.
The leader alone schedules, allocates blocks and emits KV events; before
it runs a program, warm-up's included, it publishes the step
(`_publish`, the JAX engine's kind names and descriptor keys), so every
rank runs the same programs, and so the same collectives, in the same
order.  The step kinds are prefill_packed, prefill and prefill_batch
(prefill_packed=False and the padded programs of capacity MoE and MLA),
decode, decode_multi and decode_cont, warm-up's
decode_snapshot/decode_restore of the decode descriptor, and the KV
moves `gather` and `inject` (JAX's descriptor keys): a disagg pull's
chunk and a KVBM offload gather the ranks' kv-head slabs into the
leader's logical blocks over the tensor group (`_gather_kv`), a pulled
chunk and a KVBM onboard inject a logical payload that rides the
stream, each rank writing its slab (`_inject_kv`; MLA's latent cache is
whole on every rank).  So a mesh serves the disagg roles (a payload
holds every kv head, whatever either side's tp) and the KVBM tiers,
which the leader alone holds, and the MoE and MLA families through
their tensor-parallel forwards.  The rest of the JAX engine's step kinds
serve the other features on a mesh: speculation's `spec_verify` (the
leader proposes, with the n-gram table or a draft model whole on its own
device whose programs never ride the stream, then publishes the verify
stream; acceptance, rollback and the adaptive collapse stay its own),
`lora_write` (the adapter's whole tensors ride the stream; every rank
clears the slot and writes its shard, lora/bank.py shard_adapter),
guided decoding's `decode_topk` and `decode_topk_wide` (the leader alone
tries the candidates), and `embed` (a collective whose vector the leader
alone consumes).  The fused epilogue streams each rank's vocab slice and
combines the ranks' statistics in one gather a step
(ops/fused_sampling.py).  On a gloo mesh (ranks sharing a device) the
programs run eagerly: gloo's collectives cannot be captured, and
cuda_graphs=True raises.  `close` stops and joins every rank.

Multihost (`mh`, parallel/multihost.py): the mesh may be spread over
mh.world launchers, one per host.  The leader (launcher 0) hosts the
store at mh.coordinator, spawns only its own local ranks and waits up to
DYN_MH_BARRIER_TIMEOUT_S for the other launchers' ranks, whose first
rank's engine each launcher's worker builds with `mesh=`
(engine/worker.py).  A leader whose tensor group reaches other hosts
learns the group's backend only once the mesh is made; CUDA graphs on a
gloo group then fail there, after the launch.

Sequence parallelism (sp > 1, the JAX engine's long-context path): the
mesh's ranks at s != 0 hold replicas of their s = 0 peer's cache slab
and run every step alike.  A cold, adapter-less prompt past the largest
prefill bucket, alone in the step (`_ring_eligible`, JAX's predicate,
tested before the packed and the padded paths, as JAX orders them),
takes the ring program (`_prefill_ring_one`): padded to a pow2 multiple
of sp x the smallest bucket, published as JAX's `prefill_ring` step,
run eagerly on every rank (models/llama.py prefill_ring: each rank its
rows, the whole prompt's K/V written into every rank's cache), its first
token sampled on the leader; `metrics["ring_prefills"]`, the ring's ms
and bytes, the capture watch's "prefill_ring" record at each new T_pad,
no FPM record (as in JAX).  The DeepSeek family has no ring and runs
replicated on an sp mesh, as in JAX.

Not here yet (ROADMAP.md): penalties (the JAX engine ignores them too).
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import logging
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import chaos, obs
from ..device import DeviceLike, resolve_device
from ..disagg.transfer import KvLayout, dtype_name, make_transfer_params
from ..kvbm.consolidator import KvEventConsolidator
from ..kvbm.manager import TieredKvManager
from ..kvbm.residency import LineageResidency
from ..lora.bank import clear_slot, empty_bank, shard_adapter, write_adapter
from ..lora.source import LocalLoraSource
from ..models import get_family
from ..obs.compile_watch import CaptureWatch
from ..obs.costs import program_costs
from ..obs.kv_ledger import KvLedger, ledger_enabled
from ..ops.kv_transfer import (
    blocks_from_host,
    blocks_to_host,
    gather_universal,
    inject_universal,
)
from ..parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    Mesh,
    MeshConfig,
    default_devices,
    gather_slabs,
    group_backend,
    kv_cache_spec,
    kv_heads_replicated,
    mesh_devices,
    shard_config,
    tensor_group_ranks,
)
from ..parallel.multihost import (
    STOP,
    GroupTransport,
    MultihostContext,
    StepBroadcaster,
    from_wire,
    launch_ranks,
    to_wire,
)
from ..protocols import (
    DISAGG_ANNOTATION,
    DRAIN_ABORT,
    DRAIN_REJECT,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..quant.kv import blocks_for_hbm_budget
from ..runtime.aio import CANCELLED, next_or_cancel
from ..runtime.retry import PULL_POLICY, call_with_retry
from ..tokens import (
    TokenBlockSequence,
    compute_block_hashes_for_request,
    request_salt,
)
from .block_allocator import BlockAllocator, GrowResult
from .config import EngineConfig
from .graphs import (
    DecodePrograms,
    GuidedPrograms,
    PaddedPrefillPrograms,
    PrefillPrograms,
    Readback,
    VerifyPrograms,
    check_capture,
)
from .prefill import _pow2, plan_packed_prefill
from .sampler import sample_tokens, spec_accept_tokens

logger = logging.getLogger(__name__)


def _set_result_safe(fut: asyncio.Future, value) -> None:
    if not fut.done():
        fut.set_result(value)


def _set_exception_safe(fut: asyncio.Future, err: BaseException) -> None:
    if not fut.done():
        fut.set_exception(err)


@dataclass
class _Slot:
    index: int
    request: PreprocessedRequest
    seq: TokenBlockSequence
    out_q: asyncio.Queue
    block_table: np.ndarray  # [max_blocks_per_seq] int32
    ctx_len: int = 0         # tokens materialized in the cache
    prompt_len: int = 0      # fixed at admit (seq grows as tokens append)
    prefill_pos: int = 0     # next prompt position to compute
    last_token: int = 0
    generated: int = 0
    committed_blocks: int = 0
    sampling_seed: int = 0
    finished: bool = False
    cancel_requested: bool = False
    cached_tokens: int = 0   # prefix-cache reuse (for metrics)
    enqueued_t: float = 0.0
    # the forensic stamp's facts (_forensic): waiting-queue position at
    # enqueue and prefill chunk count
    queue_pos: int = 0
    prefill_chunks: int = 0
    first_token_t: float = 0.0
    last_push_t: float = 0.0
    # decode pipelining: tokens the device has decoded for this slot that
    # the host has not read back yet
    inflight: int = 0
    # the serial of this admission, unique per engine and renewed on
    # preemption: the (seq_id, epoch) lane identity then never matches a
    # burst dispatched for an earlier slot, even one that carried the
    # same request id and finished with bursts still in flight
    epoch: int = 0
    # overlapped scheduling: the prompt is prefilled but its first token
    # is still being read back (_pending_first); decode skips the slot
    # until the next step's flush emits it
    awaiting_first: bool = False
    # disaggregation: a prefill-only hop whose KV is parked for pulling
    disagg_prefill: bool = False
    # decode side of a disagg pull: the slot sits admitted but idle while
    # the pull task injects chunks into its blocks (prefill and decode
    # skip it until the pull finishes or falls back)
    pulling: bool = False
    admitted: Optional[asyncio.Event] = None  # set (loop thread) on admit
    # speculative decoding (spec/): adaptive draft length (-1 = take the
    # engine default on the first attempt; 0 = collapsed to plain
    # decode), acceptance-rate EMA (a neutral 0.5 prior on the first
    # attempt), the generated-token count at which a collapsed or
    # pipelined slot next probes, the probe backoff, and the number of
    # leading positions whose DRAFT-model KV matches the real sequence
    spec_k_cur: int = -1
    spec_accept_ema: float = -1.0
    spec_probe_at: int = 0
    spec_backoff: int = 0
    draft_pos: int = 0
    # adapter bank slot (0 = no adapter)
    lora_idx: int = 0
    # guided decoding (guided/json_prefix.py): a constrained slot steps
    # through _guided_step; guided_out holds its emitted document tokens
    guide: Optional[Any] = None
    guided_out: List[int] = field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.prompt_len


@dataclass
class _Parked:
    """A finished disagg prefill whose KV awaits pulling by decode."""

    seq_id: str
    block_ids: list
    prompt_len: int
    expires_t: float


KvEventSink = Callable[[List[int], List[int], str], None]


class _OffloadExclude:
    """The hashes an offload pass skips: those the KVBM tiers hold or
    recently dropped (kvbm/manager.py _OffloadSkip) and those whose copy
    to the host is still in flight."""

    def __init__(self, kvbm: TieredKvManager, pending: set):
        self._skip, self._pending = kvbm.offload_skip, pending

    def __contains__(self, h: int) -> bool:
        return h in self._pending or h in self._skip


def _ladder(lo: int, top: int) -> List[int]:
    """lo, 2 lo, 4 lo, ... up to the first that holds `top`: the stream
    buckets of a packed planner (engine/prefill.py _pow2)."""
    out = [lo]
    while out[-1] < top:
        out.append(out[-1] * 2)
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


# the FPM record fields a dispatch span carries (when tracing)
_PREFILL_SPAN_FIELDS = ("tokens", "bucket", "gap_s", "synced", "mfu",
                        "est_mfu", "xla_flops", "xla_bytes")
_DECODE_SPAN_FIELDS = ("gap_s", "xla_flops", "xla_bytes")


def _span_fields(rec: Optional[dict], keys: tuple) -> dict:
    return {} if rec is None else {k: rec[k] for k in keys if k in rec}


class TorchEngine:
    # decode burst size while prefill/admission work is pending: a short
    # burst bounds how long a chunk waits behind decode while amortizing
    # the dispatch 4x (the JAX engine's value)
    INTERLEAVE_BURST = 4
    # guided decoding's candidate window, and the widened retry's (the
    # JAX engine's values)
    GUIDED_TOPM = 32
    GUIDED_TOPM_WIDE = 256

    def __init__(self, config: EngineConfig, params=None,
                 device: DeviceLike = "cuda",
                 kv_event_sink: Optional[KvEventSink] = None,
                 cuda_graphs: bool = True,
                 prefill_graphs: Optional[bool] = None,
                 kv_pull_fn: Optional[Callable] = None,
                 draft_params=None,
                 devices: Optional[List[DeviceLike]] = None,
                 mesh: Optional[Mesh] = None,
                 mesh_timeout_s: float = DEFAULT_TIMEOUT_S,
                 mh: Optional[MultihostContext] = None):
        """`params`: the port's parameter tree on `device` (for example
        from models/convert.py params_from_numpy); None loads the
        checkpoint at config.model_path, or makes random weights from
        config.seed on the device without one.  `kv_event_sink(stored,
        removed, tier)`: called on the event loop's thread with each
        netted batch of KV events, in mutation order (engine/worker.py
        passes KvEventPublisher.enqueue_batch).  `cuda_graphs=False` runs
        the decode and prefill programs eagerly on CUDA too (a
        measurement baseline; on the CPU they always run eagerly);
        `prefill_graphs` overrides it for the prefill programs alone.
        `kv_pull_fn(disaggregated_params)`: an async callable returning
        the PullSource of a remote prefill's parked KV (set by the
        worker; the engine stays transport-agnostic).  `draft_params`:
        the draft model's weights under spec_decode="draft" (None: loaded
        from spec_draft_model_path, or random from config.seed).

        With config.dp * config.tp * config.sp > 1 this engine is rank 0 of
        a mesh on `devices` (default: `device` repeated when it is the CPU,
        else the first dp * tp * sp visible CUDA devices; raises as JAX's
        make_mesh when there are fewer), and `device` is ignored.
        `params` is then the full parameter tree as numpy arrays (or
        None), and each rank cuts its shard; on a gloo mesh (ranks sharing
        a device) pass cuda_graphs=False.  A rank, hung or gone, surfaces as an error
        within `mesh_timeout_s`.  `mesh`: a spawned rank's Mesh
        (parallel/multihost.py follower_main), which makes this engine a
        follower: it replays steps through `apply_step` and never
        schedules.  `mh`: the leader's launcher context (None: one
        launcher), whose mh.world launchers share the mesh; `devices` are
        then this host's, the first world / mh.world of them its
        ranks'."""
        self.config = config
        world = config.dp * config.tp * config.sp
        devs, backend = None, None
        self._mh = mh or MultihostContext()
        if world > 1 and mesh is None:
            mcfg = MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp)
            devs = mesh_devices(mcfg, devices if devices is not None
                                else default_devices(mcfg,
                                                     resolve_device(device)),
                                self._mh.world)
            device = devs[0]
            group = tensor_group_ranks(mcfg, 0)
            # a group that reaches another launcher's ranks: its backend
            # is known once the mesh is made (checked after the launch)
            if max(group) < len(devs):
                backend = group_backend([devs[r] for r in group])
        elif mesh is not None:
            device, backend = mesh.device, mesh.backend
        self.device = resolve_device(device)
        check_capture(backend, self.device,
                      cuda_graphs or bool(prefill_graphs))
        # the mesh (parallel/mesh.py): None for a single-device engine; the
        # leader launches the other ranks at the end of __init__
        self.mesh: Optional[Mesh] = mesh
        self._ranks = None  # the leader's spawned ranks
        # rank -> its kernel launch counts and its engine's numeric
        # metrics (with the ring prefill's bytes, each ring call's ms
        # under "ring_calls_ms" and a CUDA rank's peak memory), as
        # reported at close
        self.rank_launches: Dict[int, Dict[str, int]] = {}
        self.rank_metrics: Dict[int, Dict[str, float]] = {}
        self._steps: Optional[StepBroadcaster] = None
        self._warm_snap = None  # a follower's copy of warm-up's snapshot
        tp_rank = mesh.tp_rank if mesh is not None else 0
        self._tp_rank = tp_rank
        self.model_cfg = config.resolve_model()
        # the model family's module (models/__init__.py get_family): every
        # forward, init and cache shape below goes through it, and what
        # the family lacks is detected by its attributes, as in JAX
        self.family = get_family(self.model_cfg)
        self.eos_ids = frozenset(config.resolve_eos_ids())
        # the EFFECTIVE fused-sampling epilogue, as the attention impls and
        # the cache dtype: a family without the hidden-state decode
        # surface (MLA) falls back to "off" with JAX's warning, and the
        # worker's MDC advertises this, never a mode the engine does not run
        self.sampling_epilogue = config.sampling_epilogue
        if self.sampling_epilogue == "fused" and not (
                hasattr(self.family, "decode_hidden")
                and hasattr(self.family, "unembed_weight")
                and hasattr(self.family, "decode_multi_hidden")):
            logger.warning(
                "model family %r has no hidden-state decode surface; "
                "sampling_epilogue falls back to off",
                type(self.model_cfg).__name__)
            self.sampling_epilogue = "off"
        # LoRA needs a family whose prefill takes the adapter bank
        if config.lora_max_adapters > 0 and "lora_bank" not in \
                inspect.signature(self.family.prefill).parameters:
            raise ValueError(
                f"model family {self.model_cfg.name!r} does not support "
                "LoRA serving")
        # a rank runs its shard's widths (parallel/mesh.py shard_config);
        # model_cfg stays the whole model's (the MDC, the cache budget)
        self.shard_cfg = shard_config(self.model_cfg, config.tp)
        # the kv heads of a logical KV payload this rank's cache holds
        # (ops/kv_transfer.py inject_universal's `heads`); None where the
        # cache is whole (tp = 1, or MLA's replicated latent pair)
        self._kv_heads = (
            kv_cache_spec(tp_rank, config.tp, self.model_cfg.n_kv_heads)
            if config.tp > 1 and not kv_heads_replicated(self.model_cfg)
            else None)
        shard = (tp_rank, config.tp) if config.tp > 1 else None
        mesh_params = None
        if world > 1 and params is not None:
            # every rank cuts its own shard of the whole numpy tree
            if not isinstance(params.get("embedding"), np.ndarray):
                raise TypeError(
                    "under dp * tp * sp > 1 the engine takes the whole "
                    "parameter tree as numpy arrays (models/convert.py's "
                    "input); each rank places its own shard")
            mesh_params = params
        if params is None and config.model_path:
            from ..models.loader import load_params

            # the mesh's leader (or a single device) fills the host
            # weight cache with the whole tree; followers only read it
            params = load_params(config.model_path, self.model_cfg,
                                 device=self.device, shard=shard,
                                 fill_cache=mesh is None)
        elif params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = self.family.init_params(
                self.model_cfg, gen, self.device,
                **({"shard": shard} if shard is not None else {}))
        elif mesh_params is not None:
            from ..models.convert import params_from_numpy

            params = params_from_numpy(mesh_params, self.model_cfg,
                                       self.device, rank=tp_rank,
                                       tp=config.tp)
        self.params = params
        # the EFFECTIVE cache dtype: a family without a quantized cache
        # (MLA: no kv_cache_scale_shapes) falls back to bf16 with JAX's
        # warning.  The dtype sizes the block pool: with a kv_hbm_gb
        # budget the block count derives from bytes per block, so int8
        # holds ~2x the blocks of bf16 in the same memory;
        # config.num_blocks is updated in place so the allocator and the
        # cache agree
        self.kv_dtype = config.kv_cache_dtype
        if self.kv_dtype == "int8" \
                and not hasattr(self.family, "kv_cache_scale_shapes"):
            logger.warning(
                "model family %r has no quantized KV path; "
                "kv_cache_dtype falls back to bf16", self.model_cfg.name)
            self.kv_dtype = "bf16"
        if config.kv_hbm_gb > 0:
            config.num_blocks = blocks_for_hbm_budget(
                self.family, self.model_cfg, config.block_size,
                self.kv_dtype, int(config.kv_hbm_gb * 1e9))
        self.kv = self._init_kv_cache()
        # the KV block-lifecycle ledger (obs/kv_ledger.py): books recorded
        # at the allocator's own mutation sites, reconciled by the auditor
        # on the step after a finish, on the idle tick and on demand
        # (/debug/kv); None when off, every hook then a pointer compare
        self.kv_ledger: Optional[KvLedger] = (
            KvLedger() if ledger_enabled(config.kv_ledger) else None)
        self.allocator = BlockAllocator(config.num_blocks,
                                        config.enable_prefix_caching,
                                        ledger=self.kv_ledger)
        self.waiting: List[_Slot] = []
        self._qlock = threading.Lock()      # guards `waiting` across threads
        self._step_lock = threading.Lock()  # held for each _sched_step run
        self._slots: List[Optional[_Slot]] = [None] * config.max_num_seqs
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop_ref: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        self.kv_event_sink = kv_event_sink
        self._consolidator = KvEventConsolidator()
        # KVBM tiers: router-visible events of every tier are netted
        # through the consolidator, so a block offloaded to G2 survives
        # its G1 eviction in the router's view
        self.kvbm: Optional[TieredKvManager] = None
        if config.disk_cache_dir and config.host_cache_blocks <= 0:
            raise ValueError(
                "disk_cache_dir (G3) requires host_cache_blocks > 0: the "
                "disk tier is fed only by demotion from the host tier")
        if config.disk_cache_dir and config.disk_cache_blocks <= 0:
            raise ValueError(
                "disk_cache_dir (G3) requires disk_cache_blocks > 0")
        if config.object_store_dir and config.host_cache_blocks <= 0:
            raise ValueError(
                "object_store_dir (G4) requires host_cache_blocks > 0: the "
                "object tier is fed by demotion down the tier ladder")
        # a follower (`mesh` given) keeps no tiers: its cache evolves from
        # the leader's gather and inject steps alone
        if config.host_cache_blocks > 0 and mesh is None:
            self.kvbm = TieredKvManager(
                config.host_cache_blocks,
                disk_dir=config.disk_cache_dir,
                disk_blocks=config.disk_cache_blocks,
                object_dir=config.object_store_dir,
                object_ttl_s=config.object_store_ttl_s,
                io_deadline_s=config.kv_io_deadline_s,
                breaker_threshold=config.kv_breaker_threshold,
                breaker_cooldown_s=config.kv_breaker_cooldown_s)
            self.kvbm.on_corruption = self._note_kv_corruption
        # (tier, action) -> count of checksum quarantines across the KV
        # cache fabric (g3/g4/remote), via _note_kv_corruption
        self.kv_integrity: Dict[Tuple[str, str], int] = {}
        # cross-worker pull (kvbm/remote.py): installed by the worker;
        # async callable(hashes) -> [(h, *payload), ...]
        self.remote_kvbm_fetch: Optional[Callable] = None
        self._offload_watermark = (config.offload_watermark_blocks
                                   or config.num_blocks // 4)
        # offloads whose device-to-host copies are in flight, oldest
        # first: (event or None, [(hash, host block), ...]), and their
        # hashes (skipped by the next offload passes)
        self._offloading: deque = deque()
        self._offload_pending: set = set()
        # the offload's device-to-host copies run on a side stream, so
        # they overlap the next bursts instead of queueing before them
        self._offload_stream = (torch.cuda.Stream(self.device)
                                if self.kvbm is not None
                                and self.device.type == "cuda" else None)
        # LoRA: the stacked adapter bank (lora/bank.py; slot 0 the all-zero
        # no-adapter slot) and the name -> slot registry: adapters load
        # from lora_dir on their first request, the least recently used
        # slot no sequence references is evicted; a pin holds a slot
        # between its resolution and the request's enqueue
        self.lora_bank: Optional[Dict[str, torch.Tensor]] = None
        self._lora_slots: Dict[str, int] = {}   # name -> bank slot (>= 1)
        self._lora_lru: List[str] = []          # LRU order, oldest first
        self._lora_pins: Dict[int, int] = {}    # slot -> pins
        self._lora_source: Optional[LocalLoraSource] = None
        if config.lora_max_adapters > 0:
            # a tensor-parallel rank holds its shard of every adapter, in a
            # bank of its shard's widths (lora/bank.py shard_adapter)
            mc = self.shard_cfg
            self.lora_bank = empty_bank(
                mc.n_layers, config.lora_max_adapters + 1, config.lora_rank,
                mc.d_model, mc.q_dim, mc.kv_dim, dtype=mc.dtype,
                device=self.device)
            if config.lora_dir:
                self._lora_source = LocalLoraSource(config.lora_dir)
        # the decode programs (engine/graphs.py) and the overlapped
        # scheduler's state: dispatched-but-unread bursts, the owner of
        # each lane's device chain, the host mirror of the last full
        # descriptor (_is_continuation), deferred first-token readbacks
        # and the adaptive fusion ramp's clock
        self.graphs = DecodePrograms(self.params, self.shard_cfg, self.kv,
                                     config.max_num_seqs,
                                     config.max_blocks_per_seq, self.device,
                                     capture=cuda_graphs,
                                     epilogue=self.sampling_epilogue
                                     == "fused", lora_bank=self.lora_bank)
        # one packed-prefill program per bucket the planner can give:
        # the pow2 ladder from the smallest bucket to the first one that
        # holds the chunk budget; none for a family without packed
        # prefill (MLA)
        packed = hasattr(self.family, "prefill_packed")
        self.prefill_graphs: Optional[PrefillPrograms] = None
        if packed:
            self.prefill_graphs = PrefillPrograms(
                self.params, self.shard_cfg, self.kv,
                config.max_prefill_seqs, config.max_blocks_per_seq,
                _ladder(config.prefill_buckets[0], config.chunk_budget),
                self.device,
                capture=cuda_graphs if prefill_graphs is None
                else prefill_graphs, lora_bank=self.lora_bank)
        # prefill_packed=False, a family without packed prefill, and
        # capacity-dispatch MoE, which is not packed-safe (a packed stream
        # would merge the sequences' expert-capacity pools), take the
        # padded programs, as the JAX engine's `_packed_prefill_ok` routes
        # them
        mc = self.shard_cfg
        self._packed_prefill_ok = config.prefill_packed and packed and not (
            getattr(mc, "n_experts", 0) > 0
            and getattr(mc, "moe_dispatch", "dense") == "capacity")
        self.padded_prefill: Optional[PaddedPrefillPrograms] = None
        if not self._packed_prefill_ok:
            self.padded_prefill = PaddedPrefillPrograms(
                self.params, mc, self.kv, config.max_blocks_per_seq,
                self.device, lora_bank=self.lora_bank)
        # guided decoding's candidate programs (top-M at M = GUIDED_TOPM
        # and the widened GUIDED_TOPM_WIDE), both built by warm-up; the
        # token<->text codec (the worker installs the model's tokenizer;
        # None falls back to the byte mock)
        self.guided_graphs = GuidedPrograms(
            self.params, self.shard_cfg, self.kv, config.max_num_seqs,
            config.max_blocks_per_seq,
            (self.GUIDED_TOPM, self.GUIDED_TOPM_WIDE), self.device,
            capture=cuda_graphs)
        self.guided_codec = None
        # speculative decoding (spec/): the proposer and one verify
        # program per pow2 stream length a round can give (rows
        # [last_token, d1..dk], at most spec_k + 1 tokens a slot, capped
        # by the chunk budget; the planner's smallest bucket is 8), rows
        # padded to _pow2(max_num_seqs)
        self.proposer = None
        self.verify_graphs: Optional[VerifyPrograms] = None
        if config.spec_decode != "off" \
                and not hasattr(self.family, "spec_verify_packed"):
            # MLA has no packed verify path: plain decode, as JAX serves it
            logger.warning(
                "model family %r has no spec_verify_packed; speculative "
                "decoding disabled (plain decode)", self.model_cfg.name)
        elif config.spec_decode != "off":
            from ..spec import make_proposer

            if mesh is None:
                # the leader proposes; a follower replays the verify steps
                # alone (a draft model runs whole on the leader's device,
                # and its programs never ride the stream, as in JAX)
                self.proposer = make_proposer(config, self.device,
                                              params=draft_params,
                                              capture=cuda_graphs)
            self.verify_graphs = VerifyPrograms(
                self.params, self.shard_cfg, self.kv,
                _pow2(config.max_num_seqs), config.max_blocks_per_seq,
                _ladder(8, min(config.max_num_seqs * (config.spec_k + 1),
                               config.chunk_budget)),
                self.device, capture=cuda_graphs)
        # timeline spans: steps run on whatever pool thread to_thread
        # picked, but the step lock serializes them, so every step-phase
        # span (and capture span) is pinned to ONE logical track per
        # engine
        self._obs_track = f"sched:{id(self):x}"
        # every program build is an observed event (the JAX engine's
        # compile watch): counted, timed, span-recorded and costed
        self.capture_watch = CaptureWatch(
            sink=lambda rec: self.fpm.append(rec), track=self._obs_track,
            serving=lambda: any(s is not None for s in self._slots))
        for progs in self._program_families():
            progs.watch = self.capture_watch
        # the embed buckets run so far (embed(): the first call at a
        # bucket is the watch's "embed" record)
        self._embed_buckets: set = set()
        # slot indexes that speculated this scheduler step (they emitted
        # synchronously; the decode burst skips them)
        self._specced: frozenset = frozenset()
        self._fpm_last_spec_t = 0.0
        self._overlap = bool(config.overlap_scheduling)
        self._inflight: deque = deque()
        self._chain_owner: List[Optional[Tuple[str, int]]] = \
            [None] * config.max_num_seqs  # (seq_id, epoch) per lane
        self._epochs = itertools.count()  # _Slot.epoch serials
        self._last_desc: Optional[Dict[str, Any]] = None
        self._pending_first: List[dict] = []
        self._decode_only_run = 0
        # graceful drain (engine/worker.py drain()): set to reject new
        # requests with the migratable "worker draining" marker
        self.draining = False
        # disaggregation: (fn, future) scheduler ops run between steps,
        # parked prefills by request id, the identity advertised in
        # kv_transfer_params (set by the worker) and the pull source
        # factory
        self._sched_calls: List[tuple] = []
        self._parked: Dict[str, _Parked] = {}
        self.parked_ttl_s = 120.0
        self.transfer_identity: Dict[str, Any] = {}
        self.kv_pull_fn = kv_pull_fn
        # decode_steps counts fused model steps (k per burst),
        # decode_bursts the dispatches, cont_bursts those that re-used the
        # device descriptor
        self.metrics: Dict[str, Any] = {
            "steps": 0, "prefill_steps": 0, "decode_steps": 0,
            "decode_bursts": 0, "cont_bursts": 0,
            "prefill_tokens": 0, "decode_tokens": 0, "cache_hit_tokens": 0,
            "preemptions": 0, "step_time_s": 0.0, "requests": 0,
            "prompt_tokens": 0,
        }
        if self.kvbm is not None:
            # scheduler-thread seconds in offload passes (the enqueue of
            # gathers and copies, and the commits with their G3/G4
            # writes), seconds an idle engine waited for copies in flight
            # (_finish_offloads; a step never waits), and the bytes
            # committed to G2
            self.metrics.update(offload_s=0.0, offload_wait_s=0.0,
                                offloaded_bytes=0)
        self.itl_ema_s = 0.0  # streamed inter-token latency (SLA planner)
        # SLA-aware admission: the frontends' worst SLO burn rate and when
        # it was reported (set_slo_burn); stale signals decay to 0
        self._slo_burn = 0.0
        self._slo_burn_t = 0.0
        # forward-pass metrics: one record per prefill dispatch, decode
        # burst, verify dispatch and program build, with the JAX engine's
        # keys (xla_flops/xla_bytes from the per-program cost count); the
        # worker drains this ring onto the event plane
        self.fpm: deque = deque(maxlen=4096)
        self._fpm_last_decode_t = 0.0
        self._fpm_last_prefill_t = 0.0
        # time of the last blocking device read (the sampled tokens)
        self._fpm_sync_t = 0.0
        # dense matmul FLOPs per prompt token, ~2 x params without the
        # embedding (a lookup) and the lm_head (last-token rows only);
        # attention is left out, as in the JAX engine's hand count (the
        # records' `flops`/`est_mfu`; `mfu` reads the cost count)
        skip = {id(params.get(k)) for k in ("embedding", "lm_head")}
        n_params = sum(t.numel() for t in _tensors(params)
                       if id(t) not in skip)
        self._flops_per_token = 2.0 * max(n_params, 1)
        if devs is not None:
            # rank 0: spawn the other ranks (each builds its engine from
            # this config on its device, with its shard) and join them
            self._ranks = launch_ranks(config, devs, mesh_params,
                                       cuda_graphs, mesh_timeout_s,
                                       self._mh)
            self.mesh = self._ranks.mesh
            self._steps = StepBroadcaster(
                GroupTransport(self.mesh.step).send)
            if backend is None:
                try:
                    check_capture(self.mesh.backend, self.device,
                                  cuda_graphs or bool(prefill_graphs))
                except ValueError:
                    self._ranks.close(partial(self._publish, STOP))
                    raise
        if self.mesh is not None and self.mesh.tensor is not None:
            # the forward's collectives ride the tree (models/llama.py)
            self.params["tp"] = self.mesh.tensor
        # the sequence-parallel ring prefill: the long-context path for
        # cold prompts past the largest bucket when the mesh has an sp
        # axis and the family a prefill_ring (DeepSeek has none: on an sp
        # mesh it runs replicated with no ring, as in JAX)
        self._ring = self.mesh.ring if self.mesh is not None else None
        self._ring_ok = config.sp > 1 and hasattr(self.family,
                                                  "prefill_ring")
        self._ring_lengths: set = set()  # T_pad of the ring calls so far
        self.ring_calls_ms: List[float] = []  # each ring call's ms

    @property
    def steps_published(self) -> int:
        """The leader's steps on the stream so far, `stop` included (0
        off a mesh and on a follower)."""
        return self._steps.published if self._steps is not None else 0

    def _program_families(self) -> list:
        """Every program family this engine builds (the capture watch's
        sources)."""
        fams = [self.graphs, self.guided_graphs]
        for progs in (self.prefill_graphs, self.padded_prefill,
                      self.verify_graphs):
            if progs is not None:
                fams.append(progs)
        for name in ("programs", "catchup"):
            progs = getattr(self.proposer, name, None)
            if progs is not None:
                fams.append(progs)
        return fams

    # -- the step stream (parallel/multihost.py) -----------------------------
    def _publish(self, kind: str,
                 arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        """The leader's step, published before it runs the program; a
        no-op off a mesh and on a follower."""
        if self._steps is not None:
            self._steps.publish_step(kind, arrays)

    def _dispatch_decode(self, a: Dict[str, np.ndarray], greedy: bool,
                         k: int) -> Readback:
        """A full decode dispatch: upload the descriptor `a` and run
        program (greedy, k); the step is JAX's decode (k = 1) or
        decode_multi with k in the descriptor."""
        self._publish("decode_multi" if k > 1 else "decode",
                      {**a, "k": np.int32(k)} if k > 1 else a)
        self.graphs.upload(a)
        return self.graphs.run(greedy, k)

    def _dispatch_decode_cont(self, k: int, advance: int,
                              greedy: bool) -> Readback:
        """A continuation burst: the device descriptor advanced in the
        program, nothing uploaded (JAX's decode_cont)."""
        self._publish("decode_cont", {"k": np.int32(k),
                                      "advance": np.int32(advance),
                                      "greedy": np.int32(greedy)})
        self.graphs.continuation(advance)
        return self.graphs.run(greedy, k)

    def _dispatch_packed(self, a: Dict[str, np.ndarray]) -> torch.Tensor:
        """Bucket len(a["toks"])'s packed-prefill program on the padded
        descriptor `a`; returns its sampled tokens."""
        self._publish("prefill_packed", a)
        return self.prefill_graphs.run(self.prefill_graphs.upload(a))

    def _dispatch_padded(self, a: Dict[str, np.ndarray]) -> torch.Tensor:
        """A padded prefill dispatch (PaddedPrefillPrograms.run's arrays);
        one row is JAX's prefill step, with its keys, several its
        prefill_batch."""
        if a["toks"].shape[0] == 1:
            self._publish("prefill", {
                "toks": a["toks"][0], "positions": a["positions"][0],
                "block_table": a["tables"][0],
                "pos": np.int32(a["ctx_lens"][0]),
                "chunk": np.int32(a["true_lens"][0]),
                "seed": np.int32(a["seeds"][0]),
                "temp": np.float32(a["temps"][0]),
                "top_k": np.int32(a["top_ks"][0]),
                "top_p": np.float32(a["top_ps"][0]),
                **({"lidx": np.int32(a["lidx"][0])} if "lidx" in a
                   else {})})
        else:
            self._publish("prefill_batch", a)
        return self.padded_prefill.run(a)

    def _dispatch_verify(self, a: Dict[str, np.ndarray]) -> tuple:
        """A verify dispatch: the planner's arrays `a` (JAX's spec_verify
        descriptor) on their bucket's program; returns its static (ids,
        vals, lse)."""
        self._publish("spec_verify", a)
        g = self.verify_graphs
        return g.run(g.upload(g.pad(a)))

    def _dispatch_guided(self, a: Dict[str, np.ndarray], m: int) -> tuple:
        """A guided top-M step on the lane descriptor `a` (JAX's
        decode_topk, or decode_topk_wide for the widened M); returns the
        (ids, vals) readbacks."""
        self._publish("decode_topk" if m == self.GUIDED_TOPM
                      else "decode_topk_wide", a)
        self.guided_graphs.upload(a)
        return self.guided_graphs.run(m)

    def _write_lora(self, slot: int, tensors: Dict[str, Any]) -> None:
        """Adapter bank slot `slot` cleared, then written with this
        rank's shard of `tensors` (the adapter's whole bank tensors), in
        place: a reused slot keeps nothing of its last adapter, whose
        untargeted projections an adapter of fewer targets would inherit.
        Published first as JAX's lora_write with the whole tensors, so
        every rank writes its shard."""
        if self._steps is not None:
            self._publish("lora_write", {
                "slot": np.int32(slot),
                **{k: to_wire(v) for k, v in tensors.items()}})
        clear_slot(self.lora_bank, slot)
        write_adapter(self.lora_bank, slot, shard_adapter(
            tensors, self._tp_rank, self.config.tp,
            kv_replicated=kv_heads_replicated(self.model_cfg)))

    def apply_step(self, kind: str, a: Dict[str, np.ndarray]) -> None:
        """A follower: run one of the leader's steps, the program the
        leader ran, on this rank's shards (parallel/multihost.py).  What
        it samples, the verify windows, the guided candidates and the
        embedding included, is discarded: the decisions they feed are the
        leader's, and the decode chain stays symmetric with the leader's,
        since every burst runs here too."""
        if kind == "prefill_packed":
            self._dispatch_packed(a)
        elif kind == "prefill":
            self._dispatch_padded({
                "toks": a["toks"][None], "positions": a["positions"][None],
                "tables": a["block_table"][None],
                "ctx_lens": a["pos"].reshape(1),
                "true_lens": a["chunk"].reshape(1),
                "seeds": a["seed"].reshape(1), "temps": a["temp"].reshape(1),
                "top_ks": a["top_k"].reshape(1),
                "top_ps": a["top_p"].reshape(1),
                **({"lidx": a["lidx"].reshape(1)} if "lidx" in a else {})})
        elif kind == "prefill_batch":
            self._dispatch_padded(a)
        elif kind in ("decode", "decode_multi"):
            k = int(a.pop("k", 1))
            self._dispatch_decode(a, bool(np.all(a["temps"] <= 0.0)), k)
        elif kind == "decode_cont":
            self._dispatch_decode_cont(int(a["k"]), int(a["advance"]),
                                       bool(int(a["greedy"])))
        elif kind == "decode_snapshot":
            self._warm_snap = self.graphs.snapshot()
        elif kind == "decode_restore":
            self.graphs.restore(self._warm_snap)
            self._warm_snap = None
        elif kind == "spec_verify":
            # the KV evolution of the leader's verify; acceptance, rollback
            # and the adaptive collapse are the leader's
            self._dispatch_verify(a)
        elif kind in ("decode_topk", "decode_topk_wide"):
            self._dispatch_guided(a, self.GUIDED_TOPM if kind == "decode_topk"
                                  else self.GUIDED_TOPM_WIDE)
        elif kind == "lora_write":
            dt = self.lora_bank["A_q"].dtype
            self._write_lora(int(a.pop("slot")),
                             {k: from_wire(v, dt) for k, v in a.items()})
        elif kind == "embed":
            # a collective of the tensor group; the vector is the leader's
            self._run_embed(a["toks"], int(a["true_len"]))
        elif kind == "prefill_ring":
            # every rank runs its rows of the ring; the token is the
            # leader's
            self._dispatch_ring(a)
        elif kind == "gather":
            # read-only, but the slabs' gather is a collective of the
            # leader's tensor group; the payload is the leader's
            self._gather_slab(a["ids"])
        elif kind == "inject":
            # a KVBM onboard or a pulled disagg chunk: the whole logical
            # payload rides the stream, so followers need no tiers and no
            # transport of their own; each writes its slab
            dt = self.kv[0].dtype
            arrs = [from_wire(a["kb"], dt), from_wire(a["vb"], dt)]
            if "ksb" in a:
                arrs += [from_wire(a["ksb"], torch.float32),
                         from_wire(a["vsb"], torch.float32)]
            inject_universal(self.kv, arrs[0], arrs[1], a["ids"], *arrs[2:],
                             heads=self._kv_heads)
        else:
            raise ValueError(f"unknown step kind {kind!r}")

    # -- the cross-rank KV moves (parallel/mesh.py) --------------------------
    def _gather_slab(self, ids) -> Optional[tuple]:
        """This rank's part of a gather of blocks `ids`: its slab in the
        universal layout, gathered over the s = 0 tensor group of the
        leader's dp replica when the cache is split over kv heads (the
        logical payload on the leader, None on the other ranks; a rank at
        s != 0 holds a replica of its s = 0 peer's slab).  A replicated
        cache (tp = 1, MLA's latent pair) is the leader's own; the other
        ranks then do nothing."""
        sharded = self._kv_heads is not None
        if self.mesh is not None and not self.mesh.is_leader and (
                not sharded or self.mesh.dp_rank != 0
                or self.mesh.sp_rank != 0):
            return None
        slab = gather_universal(self.kv, ids)
        if not sharded:
            return slab
        return gather_slabs(self.mesh.tensor, slab)

    def _gather_kv(self, ids) -> tuple:
        """The leader's gather of blocks `ids` as the logical payload
        (every kv head): published as JAX's `gather` step first, so every
        rank takes part.  Off a mesh, the cache's own gather."""
        self._publish("gather", {"ids": np.asarray(ids, np.int32)})
        return self._gather_slab(ids)

    def _gather_host_blocks(self, ids) -> List[tuple]:
        """Blocks `ids` gathered (`_gather_kv`) as one host tensor tuple
        each, in blocks_to_host's per-block layout; synchronous."""
        arrs = [a.cpu() for a in self._gather_kv(ids)]
        # a tensor of its own per block, never a view of the batch
        return [tuple(a[:, i].clone(memory_format=torch.contiguous_format)
                      for a in arrs) for i in range(len(ids))]

    def _inject_kv(self, ids, arrs) -> None:
        """Write the logical payload `arrs` ((kb, vb) or, int8, (kb, vb,
        ksb, vsb), universal layout, host or device) into blocks `ids`:
        published first as JAX's `inject` step with the whole payload
        (followers write their slabs of it), then this rank's slab."""
        if self._steps is not None:
            desc = {"kb": to_wire(arrs[0]), "vb": to_wire(arrs[1]),
                    "ids": np.asarray(ids, np.int32)}
            if len(arrs) == 4:
                desc["ksb"], desc["vsb"] = to_wire(arrs[2]), to_wire(arrs[3])
            self._publish("inject", desc)
        inject_universal(self.kv, arrs[0], arrs[1], ids, *arrs[2:],
                         heads=self._kv_heads)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._loop_ref = asyncio.get_running_loop()
            self._task = asyncio.create_task(self._loop())

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        # a step already running in its thread is not stopped by the
        # cancel: wait it out before tearing the streams down
        await asyncio.to_thread(self._step_lock.acquire)
        self._step_lock.release()
        self._fail_all_streams()
        self._inflight.clear()  # unread bursts: their streams are dead
        self._pending_first.clear()
        calls, self._sched_calls = self._sched_calls, []
        for _, fut in calls:
            _set_exception_safe(fut, RuntimeError("engine closed"))
        if self.kvbm is not None:
            # the step lock was waited out above: no step is mid-write
            # into the G3 directory whose ownership close() releases
            self._offloading.clear()
            self._offload_pending.clear()
            self.kvbm.close()
        if self._ranks is not None:
            # stop every rank, join it (killed past the timeout) and keep
            # the kernel launches each reported
            ranks, self._ranks = self._ranks, None
            await asyncio.to_thread(ranks.close,
                                    partial(self._publish, STOP))
            self.rank_launches = ranks.launches
            self.rank_metrics = ranks.metrics

    def _fail_all_streams(
        self,
        error: str = "worker engine error: engine loop failed or shut down",
    ) -> None:
        """Terminate every in-flight stream (shutdown or loop crash)."""
        err = LLMEngineOutput(finish_reason="error", error=error)
        with self._qlock:
            stuck = list(self.waiting) + [
                s for s in self._slots if s is not None]
            self.waiting.clear()
        for slot in stuck:
            if not slot.finished:
                slot.finished = True
                slot.cancel_requested = True
                slot.out_q.put_nowait(err)

    def _init_kv_cache(self) -> tuple:
        """(k, v) in the model's dtype, or for an int8 cache (k, v int8,
        k_scale, v_scale fp32) (quant/kv.py); zeros.  A tensor-parallel
        rank holds its kv heads only."""
        m, c = self.shard_cfg, self.config
        int8 = self.kv_dtype == "int8"
        kv = [torch.zeros(shape, dtype=torch.int8 if int8 else m.dtype,
                          device=self.device)
              for shape in self.family.kv_cache_shapes(m, c.num_blocks,
                                                       c.block_size)]
        if int8:
            kv += [torch.zeros(shape, dtype=torch.float32, device=self.device)
                   for shape in self.family.kv_cache_scale_shapes(
                       m, c.num_blocks, c.block_size)]
        return tuple(kv)

    def kv_usage(self) -> float:
        return self.allocator.usage()

    def kv_occupancy(self) -> Dict[str, Dict[str, int]]:
        """Block occupancy per storage tier: g1 = the device allocator (id
        0 is the garbage block, so capacity is num_blocks - 1), g2..g4 =
        the KVBM tiers when enabled (kvbm/manager.py occupancy; G4 lists
        the shared directory, so this is for the worker's load loop, never
        the scheduler step)."""
        a = self.allocator
        usable = a.num_blocks - 1
        out: Dict[str, Dict[str, int]] = {"g1": {
            "used": usable - a.num_free, "free": a.num_free,
            "capacity": usable, "evictable": a.num_evictable,
        }}
        if self.kvbm is not None:
            out.update(self.kvbm.occupancy())
        return out

    def kv_block_bytes(self) -> int:
        """Host-tier bytes one block's payload moves when onboarded (all
        cache components, per physical block): the numerator of the
        worker's published per-tier onboard costs."""
        return int(sum(t.numel() * t.element_size() for t in self.kv)
                   // max(1, self.config.num_blocks))

    def kv_integrity_counters(self) -> Dict[Tuple[str, str], int]:
        """(tier, action) -> count rows for the integrity-failure gauge:
        the quarantines recorded here plus the KVBM manager's I/O
        timeouts and errors."""
        out = dict(self.kv_integrity)
        if self.kvbm is not None:
            for k, v in self.kvbm.io_failure_counters().items():
                out[k] = out.get(k, 0) + v
        return out

    async def sweep_kvbm_g4(self) -> int:
        """One GC pass over the shared G4 store (the worker's load loop
        calls it on a slow cadence; the sweep lists a shared directory, so
        it runs in a thread, never on the scheduler).  The KV ledger's
        lineage books renew hot blobs and reap dead ones early; the rest,
        and every blob with the ledger off, age by TTL
        (kvbm/residency.py).  Reaped hashes are
        folded through the consolidator as a scheduler op, so a later
        re-spill of the same hash emits stored(g4) again."""
        if self.kvbm is None or self.kvbm.g4 is None:
            return 0
        if self.kvbm.breaker.state("g4") == "open":
            return 0  # the tier is dark: let the half-open probe decide
        res = LineageResidency(self.kv_ledger, pool=self.kvbm.g4)
        try:
            swept = await asyncio.to_thread(self.kvbm.g4.sweep, None, res)
        except OSError:
            logger.warning("G4 residency sweep failed", exc_info=True)
            return 0
        if swept:
            await self._call_on_scheduler(
                lambda: self._emit_tier_events([([], list(swept), "g4")]))
        return len(swept)

    def _note_kv_corruption(self, tier: str, h: Optional[int]) -> None:
        """One checksum-failed consume anywhere in the fabric (G3 pool, G4
        object store, remote pull): count it and attribute it in the KV
        ledger (violation kind `corrupt`, a flight-recorder snapshot on
        each tier's first).  The caller already quarantined the bytes and
        degraded to a miss (recompute), so this hook is forensic and must
        never raise."""
        try:
            key = (tier, "quarantine")
            self.kv_integrity[key] = self.kv_integrity.get(key, 0) + 1
            if self.kv_ledger is not None:
                self.kv_ledger.corruption(tier, h)
        except Exception:
            logger.warning("kv corruption attribution failed",
                           exc_info=True)

    # -- KV ledger audit (obs/kv_ledger.py) --------------------------------
    def _audit_ledger_locked(self, where: str = "step") -> dict:
        """One reconciliation sweep: the ledger's books against the
        allocator's free list and refcounts, the scheduler's live slots
        (every admitted slot owns its blocks until it finishes, bursts
        still in flight included: a finish frees at once and in-flight
        lanes of a freed slot are discarded), the waiting queue, the
        parked transfers and the KVBM pool manifests.  The caller holds
        the step lock (or is the step)."""
        led = self.kv_ledger
        if led is None:
            return {}
        live = [self._seq_id(s) for s in self._slots if s is not None]
        with self._qlock:
            live += [self._seq_id(s) for s in self.waiting]
        parked = [p.seq_id for p in self._parked.values()]
        viol = led.audit_allocator(self.allocator, live, parked)
        viol += led.audit_kvbm(self.kvbm)
        return led.finish_audit(viol, where=where)

    def _audit_ledger(self, where: str = "on_demand") -> dict:
        with self._step_lock:
            if self._closed:
                return {}
            return self._audit_ledger_locked(where)

    async def audit_kv(self) -> dict:
        """On-demand reconciliation (the /debug/kv handler's entry
        point): takes the step lock off the event loop, so it runs
        between steps and never inside a capture."""
        if self.kv_ledger is None:
            return {}
        return await asyncio.to_thread(self._audit_ledger)

    @property
    def spec_enabled(self) -> bool:
        """Speculative decoding is active (what the worker advertises in
        its MDC)."""
        return self.proposer is not None

    def set_slo_burn(self, burn: float) -> None:
        """SLA-aware admission input: the worst SLO error-budget burn
        rate the frontends currently report (fed by the worker's
        slo_metrics subscription).  Any-thread safe (two float stores);
        read by _prefill_step, where a burn above config.slo_yield_burn
        makes prefill chunks yield budget to decode."""
        self._slo_burn = float(burn)
        self._slo_burn_t = time.monotonic()

    def _effective_slo_burn(self) -> float:
        """The last reported burn, or 0.0 once it has gone stale (a dead
        frontend or a disabled SLO plane must not throttle prefill
        forever)."""
        if time.monotonic() - self._slo_burn_t > \
                self.config.slo_burn_stale_s:
            return 0.0
        return self._slo_burn

    @property
    def num_active_seqs(self) -> int:
        return sum(s is not None for s in self._slots) + len(self.waiting)

    async def clear_kv_blocks(self) -> int:
        """Drop every unreferenced prefix-cache block, between steps; the
        removals are emitted under the step lock, so they reach the wire
        before the stores of any later step."""
        if self._loop_ref is None:
            self._loop_ref = asyncio.get_running_loop()

        def clear() -> int:
            with self._step_lock:
                removed = self.allocator.clear_cached()
                self._emit_events(GrowResult(removed=removed))
                if self.kvbm is not None:
                    # offloads still in flight never reached a tier
                    self._offloading.clear()
                    self._offload_pending.clear()
                    self._emit_tier_events(self.kvbm.clear())
                return len(removed)

        return await asyncio.to_thread(clear)

    @property
    def supports_embedding(self) -> bool:
        return hasattr(self.family, "embed_text")

    async def embed(self, token_ids: List[int]) -> np.ndarray:
        """Pooled text embedding (the family's embed_text), padded to a
        prefill bucket as the JAX engine's, and run between scheduler
        steps on the scheduler's thread, so its work queues on the
        engine's stream behind the bursts already dispatched and no
        burst's readback is reordered.  On a mesh it is JAX's `embed`
        step: every rank of the tensor group runs the forward.  Returns
        the fp32 unit vector."""
        if not self.supports_embedding:
            raise RuntimeError(
                f"model family {self.family.__name__} has no embed_text")
        if len(token_ids) > self.config.prefill_buckets[-1]:
            raise ValueError(
                f"input is {len(token_ids)} tokens; embedding max is "
                f"{self.config.prefill_buckets[-1]}")
        bucket = self._bucket_for(len(token_ids))
        toks = np.zeros(bucket, np.int32)
        toks[: len(token_ids)] = token_ids
        self.start()
        return await self._call_on_scheduler(
            partial(self._run_embed, toks, len(token_ids)))

    def _run_embed(self, toks: np.ndarray, true_len: int) -> np.ndarray:
        """One embed call, eager, published first as JAX's embed step
        (a rank runs its shard's forward, its sums over the group).  The
        first call at a bucket is recorded by the capture watch as family
        "embed" with its cost count (obs/costs.py), as the JAX watch
        records the jitted program's compile."""
        self._publish("embed", {"toks": toks,
                                "true_len": np.int32(true_len)})
        t0 = time.perf_counter()
        vec = self.family.embed_text(
            self.params, self.shard_cfg,
            torch.from_numpy(toks).to(self.device), true_len)
        t_obs = obs.begin()
        out = vec.float().cpu().numpy()
        obs.end("device_wait", t_obs, track=self._obs_track,
                what="embed_fetch")
        T = len(toks)
        if T not in self._embed_buckets:
            self._embed_buckets.add(T)
            self.capture_watch.on_capture(
                "embed", T, time.perf_counter() - t0,
                program_costs(self.model_cfg, "embed", T,
                              max_blocks=self.config.max_blocks_per_seq,
                              block_size=self.config.block_size))
        return out

    def drain_abort(self) -> None:
        """Graceful-drain deadline: error every in-flight stream with the
        migratable "worker draining" marker, so the frontend replays each
        request on a surviving worker; the scheduler reaps the slots."""
        self.draining = True
        # flight recorder: the last N spans are the timeline that led to
        # the abort; dumped before the streams are torn down
        obs.flight_dump("drain_abort")
        self._fail_all_streams(error=DRAIN_ABORT)
        self._wake.set()

    # -- scheduler ops ------------------------------------------------------
    def _call_on_scheduler(self, fn) -> asyncio.Future:
        """Run `fn()` between scheduler steps, under the step lock (the
        allocator and the KV cache belong to the scheduler), as the JAX
        engine's _call_on_scheduler; the future takes its result or its
        exception."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if self._closed:
            fut.set_exception(RuntimeError("engine closed"))
            return fut
        self._sched_calls.append((fn, fut))
        self._wake.set()
        if self._task is None or self._task.done():
            # no live loop to drain for us (unstarted or crashed)
            self._between_steps()
        return fut

    def _between_steps(self) -> None:
        """Run the queued scheduler ops and reap expired parked KV, under
        the step lock."""
        with self._step_lock:
            while self._sched_calls:
                fn, fut = self._sched_calls.pop(0)
                try:
                    result = fn()
                except Exception as e:  # surface to the caller
                    self._resolve(_set_exception_safe, fut, e)
                else:
                    self._resolve(_set_result_safe, fut, result)
            self._reap_parked()

    def _resolve(self, setter, fut: asyncio.Future, value) -> None:
        if self._loop_ref is not None:
            self._loop_ref.call_soon_threadsafe(setter, fut, value)
        else:
            setter(fut, value)

    # -- disaggregation: parked prefills and KV extraction ------------------
    def kv_wire_layout(self, n_blocks: int = 0) -> KvLayout:
        """This engine's KvLayout for wire headers and validation, from
        its own cache tensors ([L, nkv, NB, bs, hd]); kv_heads is the
        whole model's (a payload is logical, whatever the tp), tp and dp
        the mesh's (advisory)."""
        k, v = self.kv[0], self.kv[1]
        return KvLayout(
            num_layers=k.shape[0], num_blocks=n_blocks,
            block_size=self.config.block_size,
            kv_heads=self.family.kv_cache_shapes(
                self.model_cfg, 1, self.config.block_size)[0][1],
            head_dim=k.shape[4], dtype=dtype_name(k.dtype),
            tp=self.config.tp, dp=self.config.dp,
            head_dim_v=v.shape[4] if v.shape[4] != k.shape[4] else 0,
            scales=len(self.kv) == 4)

    async def parked_info(self, request_id: str) -> Tuple[int, int]:
        """(n_blocks, prompt_len) of a parked prefill (the pull's open)."""

        def info():
            parked = self._parked.get(request_id)
            if parked is None:
                raise KeyError(f"no parked KV for request {request_id!r}")
            return len(parked.block_ids), parked.prompt_len

        return await self._call_on_scheduler(info)

    async def extract_parked_chunk(self, request_id: str, start: int,
                                   count: int, *, to_host: bool = True):
        """Blocks [start, start+count) of a parked prefill in the
        universal transfer layout (ops/kv_transfer.py) — ONE scheduler op
        per chunk, so decode bursts interleave with a long extraction.
        to_host=False leaves the chunk on the device (the broker tier);
        to_host=True returns CPU tensors, read back through pinned
        memory.  On a mesh the chunk is the ranks' slabs gathered into
        the logical blocks (`_gather_kv`)."""

        def gather():
            parked = self._parked.get(request_id)
            if parked is None:
                raise KeyError(f"no parked KV for request {request_id!r}")
            chunk_ids = parked.block_ids[start:start + count]
            if len(chunk_ids) != count:
                raise ValueError(
                    f"chunk [{start},{start + count}) out of range for "
                    f"{len(parked.block_ids)} parked blocks")
            arrs = self._gather_kv(chunk_ids)
            if not to_host:
                return tuple(a.to(self.device) for a in arrs)
            if not arrs[0].is_cuda:
                return arrs
            host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                    for a in arrs]
            for h, a in zip(host, arrs):
                h.copy_(a, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            return tuple(host)

        return await self._call_on_scheduler(gather)

    async def release_parked(self, request_id: str) -> None:
        def release():
            parked = self._parked.pop(request_id, None)
            if parked is not None:
                if self.kv_ledger is not None:
                    self.kv_ledger.unpark(parked.seq_id)
                self._emit_events(self.allocator.free(parked.seq_id))

        await self._call_on_scheduler(release)

    def _expired_parks(self) -> List[str]:
        now = time.monotonic()
        return [r for r, p in list(self._parked.items())
                if now > p.expires_t]

    def _reap_parked(self) -> None:
        for rid in self._expired_parks():
            logger.warning("parked KV for %s expired unpulled", rid)
            parked = self._parked.pop(rid)
            if self.kv_ledger is not None:
                self.kv_ledger.unpark(parked.seq_id)
            self._emit_events(self.allocator.free(parked.seq_id))

    def _park_prefilled(self, slot: _Slot, first_token: int) -> None:
        """Disagg prefill done: keep the KV, hand back transfer metadata
        in one frame.  The park moves no KV, so on a mesh it publishes no
        step: the leader's books hold the blocks, and every rank's
        cache keeps its slab of them until the pull's gathers."""
        seq_id = self._seq_id(slot)
        rid = slot.request.request_id
        self._parked[rid] = _Parked(
            seq_id=seq_id,
            block_ids=list(self.allocator.seq_block_ids(seq_id)),
            prompt_len=slot.ctx_len,
            expires_t=time.monotonic() + self.parked_ttl_s,
        )
        if self.kv_ledger is not None:
            # attribution: the blocks are pinned by the transfer now,
            # awaiting the decode side's pull
            self.kv_ledger.park(seq_id)
        slot.finished = True
        if slot.index >= 0:
            self._slots[slot.index] = None
            slot.index = -1
        params = make_transfer_params(
            instance_id=self.transfer_identity.get("instance_id", 0),
            request_id=rid,
            prompt_len=self._parked[rid].prompt_len,
            first_token=first_token,
            block_size=self.config.block_size,
            num_layers=self.model_cfg.n_layers,
        )
        params.update({k: v for k, v in self.transfer_identity.items()
                       if k != "instance_id"})
        out = LLMEngineOutput(
            token_ids=[first_token], finish_reason="stop",
            kv_transfer_params=params,
            # the prefill hop's realized reuse and queue facts ride its
            # one frame
            metrics={"ttft_s": slot.first_token_t - slot.enqueued_t,
                     "forensic": self._forensic(slot)})
        if self._loop_ref is not None:
            self._loop_ref.call_soon_threadsafe(slot.out_q.put_nowait, out)
        else:
            slot.out_q.put_nowait(out)

    # -- disaggregation: the decode side's pull -----------------------------
    async def _stream_pull(self, slot: _Slot, dp: Dict[str, Any]) -> None:
        """Decode-side streaming pull: inject the prefill's KV chunk by
        chunk, each chunk one scheduler op, so decode bursts of OTHER
        slots run in between; host memory is bounded by two chunks (the
        injecting one and one prefetch in flight).  Any failure falls
        back to local prefill: the slot's blocks are allocated and
        prefill_pos still points at the cached prefix."""
        src = None
        t0 = time.monotonic()
        rid = slot.request.request_id
        t_obs = obs.begin()
        tid_obs = (obs.trace_id_from_annotations(slot.request.annotations)
                   if t_obs else None)

        async def pull_chunk(b0: int, n: int):
            # a transiently failing chunk op (peer hiccup, injected
            # fault) is retried with jittered backoff before the whole
            # pull gives up and falls back to local prefill.  The chaos
            # seam sits INSIDE the retried call so `times=1` rules are
            # absorbed by a retry while unlimited rules exhaust it.
            async def once():
                await chaos.ahit("disagg.pull.chunk", key=f"{rid}:{b0}")
                return await src.chunk(b0, n)

            return await call_with_retry(
                once, PULL_POLICY,
                on_retry=lambda a, e: logger.warning(
                    "kv pull chunk [%d,%d) for %s failed (attempt %d): "
                    "%s", b0, b0 + n, rid, a, e))

        try:
            await slot.admitted.wait()
            if slot.finished or slot.cancel_requested:
                return
            src = await self.kv_pull_fn(dp)
            header = await call_with_retry(src.open, PULL_POLICY)
            layout = KvLayout.from_dict(header["layout"])
            layout.check_compatible(self.kv_wire_layout())
            prompt_len = slot.prompt_len
            if int(header["prompt_len"]) != prompt_len:
                raise ValueError(
                    f"prefill parked {header['prompt_len']} tokens but the "
                    f"decode request has {prompt_len}")
            bs = self.config.block_size
            n_blocks = (prompt_len + bs - 1) // bs
            if layout.num_blocks != n_blocks:
                raise ValueError(
                    f"prefill parked {layout.num_blocks} blocks; decode "
                    f"needs {n_blocks}")
            # skip blocks the local prefix cache materialized at
            # admission: pull only the missing tail
            start = slot.cached_tokens // bs
            per = layout.blocks_per_chunk(self.config.transfer_chunk_bytes)
            device_resident = getattr(src, "device_resident", False)
            if device_resident:
                # the chunk bound protects HOST memory, which device
                # chunks never touch: 8x chunks cut the round trips
                per *= 8
            spans = [(b0, min(per, n_blocks - b0))
                     for b0 in range(start, n_blocks, per)]
            pulled = 0
            # pipelined: chunk i+1 is in flight on the SOURCE while chunk
            # i injects here (receiver-paced, one outstanding prefetch)
            nxt = (asyncio.ensure_future(pull_chunk(*spans[0]))
                   if spans else None)
            try:
                for idx, (b0, n) in enumerate(spans):
                    if slot.finished or slot.cancel_requested:
                        return
                    arrs = await nxt
                    nxt = (asyncio.ensure_future(
                        pull_chunk(*spans[idx + 1]))
                        if idx + 1 < len(spans) else None)
                    await self._call_on_scheduler(
                        partial(self._inject_pulled_chunk, slot, b0, n,
                                arrs))
                    if not device_resident:
                        nbytes = sum(a.numel() * a.element_size()
                                     for a in arrs)
                        self.metrics["pull_host_chunk_bytes_max"] = max(
                            self.metrics.get("pull_host_chunk_bytes_max",
                                             0), nbytes)
                    pulled += n
            finally:
                if nxt is not None:
                    nxt.cancel()  # no-op if already done
                    try:
                        await nxt
                    except asyncio.CancelledError:
                        # suppress only the prefetch's OWN cancellation;
                        # re-raise when the pull task itself is being
                        # cancelled, so nothing below runs after a cancel
                        cur = asyncio.current_task()
                        if not nxt.cancelled() or (
                                cur is not None and cur.cancelling() > 0):
                            raise
                    except Exception:
                        pass
            self.metrics["pull_blocks"] = (
                self.metrics.get("pull_blocks", 0) + pulled)
            self.metrics["pull_seconds"] = (
                self.metrics.get("pull_seconds", 0.0)
                + (time.monotonic() - t0))
            await self._call_on_scheduler(
                partial(self._finish_pull, slot, dp.get("first_token")))
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.warning("KV pull failed for %s; local prefill fallback",
                           rid, exc_info=True)

            def fallback():
                slot.pulling = False  # the prefill path picks the slot up

            try:
                await self._call_on_scheduler(fallback)
            except Exception:
                pass
            self._wake.set()
        finally:
            obs.end("kv_pull", t_obs, request_id=rid, trace_id=tid_obs)
            if src is not None:
                try:
                    await src.close()
                except Exception:
                    pass

    def _inject_pulled_chunk(self, slot: _Slot, b0: int, n: int,
                             arrs) -> None:
        """Scheduler op: write one pulled chunk into the slot's blocks.
        `arrs` is (kb, vb), plus (ksb, vsb) for an int8 cache: CPU tensors
        (host-staged tier) or device tensors (broker tier).  The write
        goes on the stream after the bursts already dispatched; on a
        mesh every rank writes its slab (`_inject_kv`)."""
        if slot.finished or slot.cancel_requested:
            return  # blocks may already be freed; drop the chunk
        if len(arrs) != len(self.kv):
            raise ValueError(
                f"pulled chunk has {len(arrs)} payload arrays but the "
                f"cache expects {len(self.kv)} (kv dtype mismatch)")
        block_ids = self.allocator.seq_block_ids(
            self._seq_id(slot))[b0:b0 + n]
        if len(block_ids) != n:
            raise ValueError(f"slot lost blocks [{b0},{b0 + n}) mid-pull")
        self._inject_kv(block_ids, arrs)

    def _finish_pull(self, slot: _Slot, first: Optional[int]) -> None:
        """Scheduler op: every chunk landed — commit the blocks and emit
        the first token (recomputed when the transfer metadata lacks
        it)."""
        if slot.finished or slot.cancel_requested:
            return
        prompt_len = slot.prompt_len
        slot.ctx_len = prompt_len
        slot.prefill_pos = prompt_len
        slot.cached_tokens = prompt_len  # skipped compute entirely
        slot.pulling = False
        self._commit_full_blocks(slot)
        slot.first_token_t = time.monotonic()
        if slot.guide is not None:
            # constrained output served through disagg: the prefill
            # worker sampled its first token unconstrained (it parks
            # before any guided step), so pushing it would stream a stray
            # token ahead of the document.  Rewind to the last prompt
            # position instead and let _guided_step re-derive the first
            # token under the constraint, as the JAX engine does.
            self.metrics["cache_hit_tokens"] += prompt_len
            slot.ctx_len = prompt_len - 1
            slot.last_token = slot.seq.tokens[prompt_len - 1]
            return
        if first is None:
            first = self._recompute_first(slot)
        self.metrics["cache_hit_tokens"] += prompt_len
        self._push_token(slot, int(first))

    def _recompute_first(self, slot: _Slot) -> int:
        """The first token from the last prompt position, whose K/V the
        pull already wrote (the rewrite is value-identical): a one-row
        packed prefill on the smallest bucket's program (the padded B = 1
        program under capacity-dispatch MoE, as JAX's)."""
        if self.padded_prefill is not None:
            a = self._padded_arrays([slot], [1],
                                    self.config.prefill_buckets[0], 1,
                                    pos=[slot.prompt_len - 1])
            return int(Readback(self._dispatch_padded(a)).wait()[0])
        g = self.prefill_graphs
        T = g.buckets[0]
        a = g.host_descriptor(T)
        a["toks"][0] = slot.seq.tokens[slot.prompt_len - 1]
        a["positions"][0] = slot.prompt_len - 1
        a["valid"][0] = True
        a["tables"][0] = slot.block_table
        sp = slot.request.sampling
        a["seeds"][0] = slot.sampling_seed
        a["temps"][0] = sp.temperature
        a["top_ks"][0] = sp.top_k
        a["top_ps"][0] = sp.top_p
        if "lidx" in a:
            a["lidx"][0] = slot.lora_idx
        return int(Readback(self._dispatch_packed(a)).wait()[0])

    # -- KVBM: the cross-worker pull (kvbm/remote.py) ----------------------
    async def _remote_prefetch(self, request: PreprocessedRequest) -> None:
        """Pull this prompt's missing leading blocks from a peer's host
        tiers and stage them into the LOCAL G2, where admission's
        onboarding finds them.  Racy local-presence checks are safe: the
        worst case pulls a block that arrived locally meanwhile (the stage
        skips it)."""
        hashes = compute_block_hashes_for_request(
            request.token_ids, self.config.block_size,
            lora_name=request.lora_name, media_hashes=request.media_hashes)
        start = 0
        while start < len(hashes) and hashes[start] in self.kvbm:
            start += 1
        if start >= len(hashes):
            return
        blocks = await self.remote_kvbm_fetch(hashes[start:])
        if not blocks:
            return

        def stage() -> int:
            n = 0
            for h, *arrays in blocks:
                if h in self.kvbm:
                    continue
                if len(arrays) != len(self.kv):
                    # the peer runs the other cache dtype: its payload
                    # cannot go into this cache, and the leading-run
                    # contract makes the tail unusable too
                    break
                self._emit_tier_events(self.kvbm.offload(h, *arrays))
                n += 1
            return n

        staged = await self._call_on_scheduler(stage)
        if staged:
            self.metrics["remote_onboarded"] = (
                self.metrics.get("remote_onboarded", 0) + staged)
            logger.info("staged %d remote KV blocks for %s", staged,
                        request.request_id)

    def read_host_blocks(self, hashes: List[int]) -> asyncio.Future:
        """Serve a peer's pull: fetch each block from the local tiers
        (promoting it to G2: a peer pulling it marks the prefix hot) until
        the first miss.  Runs between scheduler steps."""

        def read():
            out = []
            for h in hashes:
                blk, events, _src = (self.kvbm.fetch(h)
                                     if self.kvbm is not None
                                     else (None, [], None))
                self._emit_tier_events(events)
                if blk is None:
                    break
                out.append((h, *blk))
            return out

        return self._call_on_scheduler(read)

    # -- KVBM: offload and onboard ----------------------------------------
    def _maybe_offload(self) -> None:
        """Copy the coldest evictable device blocks to the G2 host tier
        before eviction pressure destroys them: one batched gather per
        step, once free blocks fall below the watermark.  The blocks stay
        live in G1 (an offload is a copy, not a move).  On CUDA the gather
        queues behind the bursts in flight (stream order makes it read the
        blocks before any later write to them), the copies into pinned
        tensors run on a side stream after it, and the blocks commit at a
        later step, once their event has completed: the scheduler never
        waits for them."""
        if self.kvbm is None:
            return
        t0 = time.perf_counter()
        self._commit_offloads()
        if self.allocator.num_free < self._offload_watermark:
            cands = self.allocator.coldest_evictable(
                self.config.offload_batch,
                exclude=_OffloadExclude(self.kvbm, self._offload_pending),
                scan_limit=4 * self.config.offload_batch + 64)
            if cands:
                t_obs = obs.begin()
                done = None
                if self.mesh is not None:
                    # the ranks' slabs gathered into the logical blocks,
                    # read back now: the offload commits in this step
                    blocks = self._gather_host_blocks(
                        [bid for _, bid in cands])
                else:
                    blocks = blocks_to_host(self.kv,
                                            [bid for _, bid in cands],
                                            stream=self._offload_stream)
                if self._offload_stream is not None and self.mesh is None:
                    done = torch.cuda.Event()
                    done.record(self._offload_stream)
                self._offloading.append(
                    (done, [(h, blk) for (h, _), blk in zip(cands, blocks)]))
                self._offload_pending.update(h for h, _ in cands)
                # on the CPU the copies are done: commit now, as JAX does
                self._commit_offloads()
                obs.end("kvbm_offload", t_obs, track=self._obs_track,
                        blocks=len(cands))
        self.metrics["offload_s"] += time.perf_counter() - t0

    def _finish_offloads(self) -> None:
        """Wait for every offload copy in flight and commit it (the idle
        engine's loop: nothing else is queued on the stream)."""
        with self._step_lock:
            self._commit_offloads(wait=True)

    def _commit_offloads(self, wait: bool = False) -> None:
        """Commit to G2, in order, every offload whose copies have
        completed (stored(g2) events; G2's victims demote to G3 or spill
        to G4 here, on the scheduler thread, as in JAX).  Unless `wait`,
        an offload still in flight is left for a later step."""
        while self._offloading:
            done, blocks = self._offloading[0]
            if done is not None and not done.query():
                if not wait:
                    return
                t0 = time.perf_counter()
                t_d = obs.begin()
                done.synchronize()
                obs.end("device_wait", t_d, track=self._obs_track,
                        what="offload_copy")
                self.metrics["offload_wait_s"] += time.perf_counter() - t0
            self._offloading.popleft()
            for h, blk in blocks:
                self._offload_pending.discard(h)
                self.metrics["offloaded_bytes"] += sum(
                    t.numel() * t.element_size() for t in blk)
                self._emit_tier_events(self.kvbm.offload(h, *blk))

    def _try_onboard(self, slot: _Slot, hit: int, cap_blocks: int) -> int:
        """Extend a G1 prefix hit with blocks onboarded from G2/G3/G4:
        write their payloads into the freshly allocated blocks instead of
        recomputing prefill (the upload queues behind the bursts in flight
        and reads pinned memory, so the scheduler does not wait for it).
        Returns the number of blocks onboarded."""
        if self.kvbm is None:
            return 0
        hashes = slot.seq.block_hashes
        run = self.kvbm.match_run(hashes[hit:cap_blocks])
        if run == 0:
            return 0
        t_obs = obs.begin()
        block_ids = self.allocator.seq_block_ids(self._seq_id(slot))
        blocks, ids = [], []
        by_tier: Dict[str, int] = {}
        for i in range(hit, hit + run):
            blk, events, src = self.kvbm.fetch(hashes[i])
            self._emit_tier_events(events)
            if blk is None:  # dropped from the pool mid-walk
                break
            if len(blk) != len(self.kv):
                # a block staged from a peer running the OTHER cache dtype:
                # writing it without (or with stray) scales would be silent
                # corruption; treat it as a miss and recompute
                logger.warning(
                    "KVBM block %x has %d payload arrays but the cache "
                    "expects %d (kv dtype mismatch); recomputing",
                    hashes[i], len(blk), len(self.kv))
                break
            blocks.append(blk)
            ids.append(block_ids[i])
            by_tier[src] = by_tier.get(src, 0) + 1
            if self.kv_ledger is not None:
                self.kv_ledger.onboard(hashes[i], src,
                                       seq=self._seq_id(slot))
        if not ids:
            return 0
        if self.mesh is not None:
            # one logical payload, stacked on the block axis: every rank
            # writes its slab of it
            self._inject_kv(ids, [torch.stack([b[c] for b in blocks], dim=1)
                                  for c in range(len(self.kv))])
        else:
            blocks_from_host(self.kv, blocks, ids)
        for src, cnt in by_tier.items():
            key = f"kv_onboard_{src}"
            self.metrics[key] = self.metrics.get(key, 0) + cnt
        n = len(ids)
        obs.end("kvbm_onboard", t_obs, track=self._obs_track, blocks=n,
                tokens=n * self.config.block_size,
                **{f"from_{s}": c for s, c in by_tier.items()})
        return n

    def warmup_decode(self) -> None:
        """Build every program serving can reach, so no request pays for
        a kernel build, a cuBLAS warm-up or a graph capture: on CUDA both
        kernel sources first (one nvcc each, started together), then the
        packed-prefill program of every bucket, then every rung of the
        fusion ladder, greedy and sampled, dispatched full and as a
        continuation (engine/graphs.py captures each program at its first
        run), and under spec_decode every verify bucket's program and
        the draft model's propose bursts (k = 1..spec_k, B = 1), and both
        guided top-M programs.  Under capacity-dispatch MoE the padded
        prefill programs take the packed ones' place: every (rows,
        bucket) shape the scheduler can give runs once, eagerly
        (_padded_shapes).  Nothing real is computed (one prefill token
        a row, all-zero tables: every write lands in block 0), and the
        decode descriptor,
        the device chain and the continuation state are restored
        afterwards.  Runs on the caller's thread and holds the step lock
        throughout: the worker serves its generate endpoint (and arms the
        canary) before warm-up ends, and a step must not run between
        warm-up dispatches.  On a mesh every dispatch, and the descriptor's
        snapshot and restore, go through the step stream, so every rank
        builds the same programs (and, on NCCL, captures the same
        collectives) in the same order."""
        dev = self.device
        a = self.graphs.host_descriptor()
        a["ctx_lens"][:] = a["steps"][:] = 1
        with self._step_lock:
            if dev.type == "cuda":
                from ..ops import _build, cuda_packed_prefill, cuda_paged_attention

                _build.compile_sources([cuda_paged_attention.KERNEL,
                                        cuda_packed_prefill.KERNEL])
            if self.padded_prefill is not None:
                for rows, T in self._padded_shapes():
                    self._dispatch_padded(self._padded_warmup(rows, T))
            else:
                for T in self.prefill_graphs.buckets:
                    p = self.prefill_graphs.host_descriptor(T)
                    p["valid"][0] = True  # one token, in block 0
                    self._dispatch_packed(p)
            if self.verify_graphs is not None:
                for T in self.verify_graphs.buckets:
                    p = self.verify_graphs.host_descriptor(T)
                    p["valid"][0] = True  # one token, in block 0
                    self._dispatch_verify(p)
                # the draft's programs: the leader's device alone
                if hasattr(self.proposer, "warmup"):
                    self.proposer.warmup()
            g = self.guided_graphs.host_descriptor()
            g["ctx_lens"][:] = 1
            for m in self.guided_graphs.ms:
                self._dispatch_guided(g, m)[0].wait()
            self._publish("decode_snapshot")
            snap, last = self.graphs.snapshot(), self._last_desc
            for greedy in (True, False):
                a["temps"][:] = 0.0 if greedy else 0.7
                for k in self._fuse_ladder():
                    self._dispatch_decode(a, greedy, k).wait()
                    self._dispatch_decode_cont(k, k, greedy).wait()
            self._publish("decode_restore")
            self.graphs.restore(snap)
            self._last_desc = last
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- KV events ------------------------------------------------------------
    def _emit_events(self, res, tier: str = "g1") -> None:
        """Net one cache mutation's events (scheduler thread) and hand
        them to the sink on the loop thread: call_soon_threadsafe runs
        callbacks in FIFO order, so wire order equals mutation order.  G1
        evictions of offloaded blocks do not drop their G2/G3 copies: the
        consolidator nets per tier."""
        if not (res.stored or res.removed):
            return
        if tier != "g1" and self.kv_ledger is not None:
            # KVBM tier membership for the ledger's auditor, before the
            # netting (g1 transitions are recorded in the allocator)
            self.kv_ledger.tier_batch(res.stored, res.removed, tier)
        stored, removed, tier = self._consolidator.apply(
            list(res.stored), list(res.removed), tier)
        sink = self.kv_event_sink
        if sink is None or not (stored or removed):
            return
        if self._loop_ref is not None:
            self._loop_ref.call_soon_threadsafe(sink, stored, removed, tier)
        else:
            # before the engine started nothing is routing to it yet
            sink(stored, removed, tier)

    def _emit_tier_events(self, batches) -> None:
        """Emit [(stored, removed, tier), ...] batches from the KVBM
        manager (per tier; still netted through the consolidator)."""
        for stored, removed, tier in batches:
            self._emit_events(GrowResult(stored=stored, removed=removed),
                              tier=tier)

    # -- request entry ------------------------------------------------------
    async def generate(self, request: PreprocessedRequest,
                       token=None) -> AsyncIterator[LLMEngineOutput]:
        """Stream the request's tokens.  `token` is an optional
        cancellation token exposing `stopped_event` (asyncio.Event)."""
        self.start()
        if self.draining:
            # rejected before admission with the migratable marker: the
            # router may still dispatch here between the lease withdrawal
            # and its watch converging
            yield LLMEngineOutput(finish_reason="error", error=DRAIN_REJECT)
            return
        if self._task is not None and self._task.done():
            yield LLMEngineOutput(
                finish_reason="error",
                error="worker engine error: engine loop crashed")
            return
        unsupported = self._unsupported(request)
        if unsupported:
            yield LLMEngineOutput(finish_reason="error", error=unsupported)
            return
        if len(request.token_ids) >= self.config.max_context:
            yield LLMEngineOutput(
                finish_reason="error",
                error=f"prompt is {len(request.token_ids)} tokens; engine "
                      f"max_context is {self.config.max_context}")
            return
        self.metrics["requests"] += 1
        self.metrics["prompt_tokens"] += len(request.token_ids)
        dp = request.disaggregated_params
        want_pull = dp is not None and dp.get("engine") == "jax"
        if want_pull and self.kv_pull_fn is None:
            logger.warning("disaggregated_params but no kv_pull_fn; "
                           "falling back to local prefill")
            want_pull = False
        if self.kvbm is not None and self.remote_kvbm_fetch is not None:
            try:
                await self._remote_prefetch(request)
            except Exception:
                # a remote warm-up is an optimization; local prefill is the
                # always-correct fallback
                logger.warning("remote KVBM prefetch failed for %s",
                               request.request_id, exc_info=True)
        lora_idx = 0
        if request.lora_name:
            if self.lora_bank is None:
                # serving the base model labeled as the adapter would be
                # silently wrong output: fail loud, as the JAX engine does
                yield LLMEngineOutput(
                    finish_reason="error",
                    error=f"lora adapter {request.lora_name!r} requested "
                          "but this worker has LoRA disabled "
                          "(lora_max_adapters=0)")
                return
            try:
                lora_idx = await self._resolve_lora(request.lora_name)
            except Exception as e:
                yield LLMEngineOutput(
                    finish_reason="error",
                    error=f"lora adapter {request.lora_name!r}: {e}")
                return
        s = request.sampling
        seed = (s.seed if s.seed is not None
                # stable across processes (unlike hash(): PYTHONHASHSEED)
                else zlib.crc32(request.request_id.encode()) & 0x7FFFFFFF)
        slot = _Slot(
            index=-1, request=request,
            seq=TokenBlockSequence(request.token_ids, self.config.block_size,
                                   salt=request_salt(request.lora_name,
                                                     request.media_hashes)),
            out_q=asyncio.Queue(),
            block_table=np.zeros(self.config.max_blocks_per_seq, np.int32),
            sampling_seed=seed,
            epoch=next(self._epochs),
            lora_idx=lora_idx,
            enqueued_t=time.monotonic(),
            disagg_prefill=DISAGG_ANNOTATION in (request.annotations or []),
        )
        if s.guided_json is not None:
            from ..guided import JsonSchemaGuide

            slot.guide = JsonSchemaGuide(s.guided_json)
        pull_task = None
        if want_pull:
            slot.pulling = True
            slot.admitted = asyncio.Event()
        if self.kv_ledger is not None:
            # the ledger's tape entries for this sequence join the
            # request's distributed trace
            self.kv_ledger.bind_seq(
                request.request_id,
                obs.trace_id_from_annotations(request.annotations))
        with self._qlock:
            slot.queue_pos = len(self.waiting)
            self.waiting.append(slot)
        if lora_idx:
            # enqueued: the waiting/_slots scan now holds the reference
            self._lora_pins[lora_idx] -= 1
        self._wake.set()
        if want_pull:
            # streaming pull: chunk injects interleave with decode steps;
            # on any failure the slot falls back to local prefill
            pull_task = asyncio.create_task(self._stream_pull(slot, dp))
        try:
            while True:
                item = await next_or_cancel(
                    slot.out_q,
                    token.stopped_event if token is not None else None)
                if item is CANCELLED:
                    slot.cancel_requested = True
                    self._wake.set()
                    yield LLMEngineOutput(finish_reason="cancelled")
                    return
                yield item
                if item.finish_reason is not None:
                    return
        finally:
            if pull_task is not None and not pull_task.done():
                pull_task.cancel()
            if not slot.finished:
                # actual teardown happens on the scheduler thread
                slot.cancel_requested = True
                self._wake.set()

    async def _resolve_lora(self, name: str) -> int:
        """Map an adapter name to its bank slot, loading it from lora_dir
        on first use, as the JAX engine's `_resolve_lora`.  Eviction is
        LRU among adapters no active or waiting sequence references and
        no resolved-but-not-yet-enqueued request pins.  The registry
        changes and the bank write run as scheduler ops (between steps,
        under the step lock: a copy issued from another thread could
        land inside a graph capture or race a queued replay); the file
        read runs in an executor so streams never stall on it.  The
        write goes in place on the stream after the bursts already
        queued, into a slot no queued burst selects."""

        def lookup() -> Optional[int]:
            idx = self._lora_slots.get(name)
            if idx is not None:
                self._lora_lru.remove(name)
                self._lora_lru.append(name)
                self._lora_pins[idx] = self._lora_pins.get(idx, 0) + 1
            return idx

        idx = await self._call_on_scheduler(lookup)
        if idx is not None:
            return idx
        if self._lora_source is None:
            raise ValueError("unknown adapter (engine has no lora_dir)")
        loop = asyncio.get_running_loop()
        adapter = await loop.run_in_executor(
            None,
            lambda: self._lora_source.load(
                name, self.model_cfg.n_layers
            ).padded_to(self.config.lora_rank))

        def install() -> int:
            existing = self._lora_slots.get(name)
            if existing is not None:  # raced with another request
                self._lora_pins[existing] = \
                    self._lora_pins.get(existing, 0) + 1
                return existing
            in_use = {s.lora_idx for s in self._slots if s is not None}
            with self._qlock:
                in_use |= {s.lora_idx for s in self.waiting}
            in_use |= {i for i, c in self._lora_pins.items() if c > 0}
            free = (set(range(1, self.config.lora_max_adapters + 1))
                    - set(self._lora_slots.values()))
            if free:
                slot = min(free)
            else:
                victim = next(
                    (n for n in self._lora_lru
                     if self._lora_slots[n] not in in_use), None)
                if victim is None:
                    raise RuntimeError(
                        "all adapter slots are referenced by active "
                        "sequences; raise lora_max_adapters")
                slot = self._lora_slots.pop(victim)
                self._lora_lru.remove(victim)
            # a reused slot keeps nothing of its last adapter (on every
            # rank of a mesh: the write rides the step stream)
            self._write_lora(slot, adapter.tensors)
            self._lora_slots[name] = slot
            self._lora_lru.append(name)
            self._lora_pins[slot] = self._lora_pins.get(slot, 0) + 1
            logger.info("lora adapter %r loaded into slot %d (rank %d)",
                        name, slot, adapter.rank)
            return slot

        return await self._call_on_scheduler(install)

    @staticmethod
    def _unsupported(request: PreprocessedRequest) -> Optional[str]:
        """An error for request features the port does not serve yet
        (serving them without the feature would be silently wrong)."""
        if request.multimodal:
            return "multimodal inputs are not ported to dynamo_tpu_torch yet"
        return None

    # -- scheduler ------------------------------------------------------------
    async def _loop(self) -> None:
        try:
            while not self._closed:
                if self._sched_calls or self._expired_parks():
                    # scheduler ops (KV gathers, injects) run off the
                    # event loop; no step is in flight while we await
                    await asyncio.to_thread(self._between_steps)
                # a slot mid-pull has no step work of its own (its chunk
                # injects arrive as scheduler ops, which set _wake), except
                # a pending cancellation, which needs one step to reap it
                busy = (any(s is not None
                            and (not s.pulling or s.cancel_requested)
                            for s in self._slots)
                        or bool(self._inflight))
                if not busy and not self.waiting:
                    if self._offloading:
                        # idle: wait out the offload copies in flight (no
                        # burst is queued before them) and commit them, so
                        # their stored(g2) events do not wait for traffic
                        await asyncio.to_thread(self._finish_offloads)
                        continue
                    self._wake.clear()
                    if self._sched_calls:
                        continue
                    if self.kv_ledger is not None \
                            and self.kv_ledger.audit_due(5.0):
                        # the idle-tick reconciliation: an idle worker's
                        # books are swept too
                        await asyncio.to_thread(self._audit_ledger, "idle")
                    if self._parked:
                        # wake so the parked-KV TTL reaper runs even on an
                        # otherwise idle worker
                        try:
                            await asyncio.wait_for(self._wake.wait(), 5.0)
                        except asyncio.TimeoutError:
                            pass
                    else:
                        await self._wake.wait()
                    continue
                t0 = time.monotonic()
                await asyncio.to_thread(self._sched_step)
                self.metrics["step_time_s"] = time.monotonic() - t0
                self.metrics["steps"] += 1
                await asyncio.sleep(0)  # yield to the event loop
        except Exception:
            logger.exception("engine loop crashed")
            obs.flight_dump("engine_crash")
            self._fail_all_streams()
            raise

    def _sched_step(self) -> None:
        """One scheduler iteration, on the worker thread: admit, at most
        one packed prefill dispatch, then a decode step for every slot
        past prefill, so a long prompt never stalls active decodes for
        more than one chunk's compute."""
        with self._step_lock:
            if self._closed:
                return
            # chaos seam: crash ("fail") or wedge the scheduler on step
            # N — the loop's crash handler fails all streams with the
            # migratable worker-engine-error marker; a wedge is caught
            # by the canary (health_check.py)
            chaos.hit("engine.step", key=self.config.served_name)
            # timeline spans: one `step` over the iteration, `sched` over
            # the host-only scheduling work (`enqueue_ahead` when unread
            # bursts keep the device busy meanwhile: overlapped, not
            # overhead); the dispatch phases emit their own spans inside
            t_step = obs.begin()
            t = obs.begin()
            overlapped = self._overlap and bool(self._inflight)
            self._process_cancellations()
            self._maybe_offload()
            self._admit_waiting()
            obs.end("enqueue_ahead" if overlapped else "sched", t,
                    track=self._obs_track)
            # the previous step's deferred first tokens, before this
            # step's dispatches: the wait pays only for work the device
            # has had a step to finish
            self._flush_pending_first()
            self._prefill_step()
            self._guided_step()
            self._spec_step()
            if any(s is not None and not s.prefilling
                   and not s.awaiting_first for s in self._slots):
                self._decode_step()
            elif self._inflight:
                # no dispatchable decode work: flush the pipeline tail so
                # trailing tokens and finishes are delivered promptly
                self._drain_inflight()
            led = self.kv_ledger
            if led is not None and led.audit_due():
                # the finish cadence: a request freed its blocks since
                # the last sweep (host books only, no device sync)
                self._audit_ledger_locked("step")
            if t_step:  # attrs are only worth computing when tracing
                obs.end("step", t_step, track=self._obs_track,
                        active=sum(1 for s in self._slots
                                   if s is not None),
                        waiting=len(self.waiting))

    def _process_cancellations(self) -> None:
        with self._qlock:
            for slot in list(self.waiting):
                if slot.cancel_requested:
                    self.waiting.remove(slot)
                    slot.finished = True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.cancel_requested:
                slot.finished = True
                self._slots[i] = None
                self._emit_events(self.allocator.free(self._seq_id(slot)))
                # membership changed: de-fuse, so the freed lane returns
                # to useful work within a short burst
                self._decode_only_run = 0

    @staticmethod
    def _seq_id(slot: _Slot) -> str:
        return slot.request.request_id

    def _admit_waiting(self) -> None:
        """Move waiting requests into free slots (block allocation plus
        prefix-cache lookup; no model compute)."""
        c = self.config
        while True:
            with self._qlock:
                if not self.waiting:
                    return
                free_idx = next(
                    (i for i, s in enumerate(self._slots) if s is None), None)
                if free_idx is None:
                    return
                slot = self.waiting[0]
                prompt_len = len(slot.seq)
                # never reuse the whole prompt: the last token must be
                # computed to produce first-token logits
                cap_blocks = max(0, (prompt_len - 1) // c.block_size)
                res = self.allocator.allocate(
                    self._seq_id(slot), slot.seq.block_hashes[:cap_blocks],
                    slot.seq.num_blocks)
                if res is None:
                    return  # capacity: stay in queue (FIFO)
                self.waiting.pop(0)
            self._emit_events(res)
            slot.index = free_idx
            self._slots[free_idx] = slot
            slot.block_table[:len(res.block_ids)] = res.block_ids
            slot.committed_blocks = res.cached_blocks
            # extend the G1 hit with G2/G3/G4 onboarding (KV written back
            # into the cache instead of recomputed)
            onboarded = self._try_onboard(slot, res.cached_blocks,
                                          cap_blocks)
            for i in range(res.cached_blocks, res.cached_blocks + onboarded):
                self._emit_events(self.allocator.commit_block(
                    self._seq_id(slot), i, slot.seq.block_hashes[i]))
                slot.committed_blocks = i + 1
            cached = (res.cached_blocks + onboarded) * c.block_size
            slot.cached_tokens = cached
            self.metrics["cache_hit_tokens"] += cached
            if onboarded:
                self.metrics["onboarded_tokens"] = (
                    self.metrics.get("onboarded_tokens", 0)
                    + onboarded * c.block_size)
            slot.ctx_len = cached
            slot.prompt_len = prompt_len
            slot.prefill_pos = cached
            # disagg decode: wake the pull task now that blocks exist; the
            # slot idles (prefill and decode skip it) while chunk injects
            # stream in between steps
            if slot.pulling and slot.admitted is not None \
                    and self._loop_ref is not None:
                self._loop_ref.call_soon_threadsafe(slot.admitted.set)

    def _prefill_step(self) -> None:
        """One packed prefill dispatch for up to max_prefill_seqs
        prefilling slots (earliest-enqueued first), its token count capped
        by the chunk budget minus one token per decoding slot."""
        c = self.config
        pslots = sorted(
            (s for s in self._slots
             if s is not None and s.prefilling and not s.pulling),
            key=lambda s: s.enqueued_t,
        )[:c.max_prefill_seqs]
        if not pslots:
            return
        t_obs = obs.begin()
        rec = None
        try:
            rec = self._prefill_dispatch(pslots)
        finally:
            if t_obs:
                obs.end("prefill_dispatch", t_obs, track=self._obs_track,
                        rows=len(pslots),
                        **_span_fields(rec, _PREFILL_SPAN_FIELDS))

    def _prefill_dispatch(self, pslots: List[_Slot]) -> Optional[dict]:
        """_prefill_step's dispatch (split out so the span covers every
        exit); returns the dispatch's FPM record, None when nothing was
        planned."""
        c = self.config
        decoding = sum(1 for s in self._slots
                       if s is not None and not s.prefilling)
        budget = max(c.chunk_budget - decoding, c.prefill_buckets[0])
        # SLA-aware admission: while the frontends report the error
        # budget burning faster than slo_yield_burn and decodes are live,
        # prefill yields chunk budget to decode, scaled by threshold/burn
        # and floored at the smallest bucket (prefill always advances)
        if c.slo_yield_burn > 0 and decoding:
            burn = self._effective_slo_burn()
            if burn > c.slo_yield_burn:
                budget = max(int(budget * c.slo_yield_burn / burn),
                             c.prefill_buckets[0])
                self.metrics["slo_yield_steps"] = \
                    self.metrics.get("slo_yield_steps", 0) + 1
        # JAX's order: the ring (one prefilling slot, ring-eligible), then
        # packed, then padded
        if len(pslots) == 1 and self._ring_eligible(pslots[0]):
            self._prefill_ring_one(pslots[0])
            return None
        if not self._packed_prefill_ok:
            return self._prefill_padded(pslots, budget)
        plan = plan_packed_prefill(
            pslots, budget, block_size=c.block_size,
            max_blocks_per_seq=c.max_blocks_per_seq,
            min_bucket=c.prefill_buckets[0],
            with_lora=self.lora_bank is not None)
        if plan is None:
            return None
        # the bucket's program on the plan padded to max_prefill_seqs rows
        # (every row sampled: greedy rows take the argmax)
        tok = self._dispatch_packed(self.prefill_graphs.pad(plan.arrays))
        self.metrics["prefill_steps"] += 1
        # the first token is sampled (step 0 of the request's stream) only
        # for segments whose prompt completes in this chunk; intermediate
        # chunks discard theirs, and so do guided completions (the guided
        # step re-derives the first token under the constraint)
        completing = sum(1 for s, ch in zip(plan.slots, plan.chunks)
                         if s.prefill_pos + ch >= s.prompt_len)
        need = {i: s for i, (s, ch) in enumerate(zip(plan.slots,
                                                     plan.chunks))
                if s.prefill_pos + ch >= s.prompt_len
                and (s.guide is None or s.disagg_prefill)}
        rec = self._fpm_prefill(len(plan.slots), plan.tokens, plan.bucket,
                                completing,
                                self.prefill_graphs.costs[plan.bucket], True)
        firsts = None
        if need:
            firsts = self._prefill_samples(tok, need)
        for i, (slot, chunk) in enumerate(zip(plan.slots, plan.chunks)):
            if i in need:
                first = int(firsts[i]) if firsts is not None else None
            else:
                first = -1
            self._finish_prefill_chunk(slot, chunk, first)
        return rec

    def _ring_eligible(self, slot: _Slot) -> bool:
        """JAX's predicate: a cold (prefill_pos == 0), non-LoRA prompt
        longer than the largest bucket takes the one-shot ring program
        when the mesh has one; one predicate for the packed scheduler and
        the padded path, so they never route a slot differently."""
        return (self._ring_ok and slot.prefill_pos == 0
                and slot.prompt_len > self.config.prefill_buckets[-1]
                and slot.lora_idx == 0)

    def _prefill_ring_one(self, slot: _Slot) -> None:
        """The whole prompt through the ring program, JAX's
        `_prefill_ring_one`: padded to a pow2 multiple of sp x the
        smallest bucket (T_pad must divide over sp; pow2 rounding bounds
        the distinct lengths), published as JAX's prefill_ring step, its
        first token sampled on the leader.  No FPM record, as in JAX; the
        first call at a T_pad is the capture watch's "prefill_ring"
        record."""
        c = self.config
        T = slot.prompt_len
        g = c.sp * c.prefill_buckets[0]
        T_pad = _pow2(-(-T // g)) * g
        toks = np.zeros(T_pad, np.int32)
        toks[:T] = slot.seq.tokens[:T]
        s = slot.request.sampling
        tok = self._dispatch_ring({
            "toks": toks, "positions": np.arange(T_pad, dtype=np.int32),
            "block_table": slot.block_table.copy(),
            "true_len": np.int32(T), "seed": np.int32(slot.sampling_seed),
            "temp": np.float32(s.temperature), "top_k": np.int32(s.top_k),
            "top_p": np.float32(s.top_p)})
        self.metrics["ring_prefills"] = \
            self.metrics.get("ring_prefills", 0) + 1
        first = -1
        if slot.guide is None or slot.disagg_prefill:
            arr = self._prefill_samples(tok, {0: slot})
            first = int(arr[0]) if arr is not None else None
        self._finish_prefill_chunk(slot, T, first)

    def _dispatch_ring(self, a: Dict[str, np.ndarray]
                       ) -> Optional[torch.Tensor]:
        """The ring program on the descriptor `a` (JAX's prefill_ring
        keys), eager on every rank, published first: the family's
        prefill_ring over this rank's ring group, then the sampler on
        the leader's logits.  Returns the sampled token [1] on ring rank
        0, None elsewhere."""
        self._publish("prefill_ring", a)
        t0 = time.perf_counter()
        dev = self.device

        def t(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        T_pad = len(a["toks"])
        sent0 = self._ring.sent_bytes if self._ring is not None else 0
        if dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        logits, _ = self.family.prefill_ring(
            self.params, self.shard_cfg, self.kv, t(a["toks"]),
            t(a["positions"]), t(a["block_table"]), int(a["true_len"]),
            ring=self._ring)
        # the program's ms (the device's timeline between the events on
        # CUDA, the host's on the CPU) and the bytes this rank sent
        # around the ring
        if dev.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
        else:
            ms = (time.perf_counter() - t0) * 1e3
        self.ring_calls_ms.append(ms)
        self.metrics["ring_bytes"] = self.metrics.get("ring_bytes", 0) + (
            self._ring.sent_bytes - sent0 if self._ring is not None else 0)
        tok = None
        if logits is not None:
            tok = sample_tokens(
                logits[None], t(a["seed"]).reshape(1),
                torch.zeros(1, dtype=torch.int32, device=dev),
                t(a["temp"], torch.float32).reshape(1),
                t(a["top_k"]).reshape(1),
                t(a["top_p"], torch.float32).reshape(1))
        if T_pad not in self._ring_lengths:
            self._ring_lengths.add(T_pad)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.capture_watch.on_capture(
                "prefill_ring", T_pad, time.perf_counter() - t0,
                program_costs(self.model_cfg, "prefill_ring", T_pad,
                              sp=self.config.sp,
                              rank=self._ring.rank if self._ring else 0,
                              max_blocks=self.config.max_blocks_per_seq,
                              block_size=self.config.block_size,
                              int8=self.kv_dtype == "int8"))
        return tok

    def _bucket_for(self, n: int) -> int:
        """The smallest prefill bucket holding n tokens (the largest
        otherwise), as the JAX engine's."""
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        return self.config.prefill_buckets[-1]

    def _padded_shapes(self) -> List[Tuple[int, int]]:
        """Every (rows, bucket) the padded prefill can dispatch: B = 1 at
        each bucket up to the chunk budget's, and for n = 2 ..
        max_prefill_seqs co-scheduled slots (as many as the budget gives
        the smallest bucket each) pow2(n) rows at each bucket up to that
        of the n-way equal share."""
        c = self.config
        b0, top = c.prefill_buckets[0], c.prefill_buckets[-1]
        budget = max(c.chunk_budget, b0)
        shapes = {(1, T) for T in c.prefill_buckets
                  if T <= self._bucket_for(min(top, budget))}
        for n in range(2, min(c.max_prefill_seqs, budget // b0) + 1):
            cap = self._bucket_for(min(top, max(budget // n, b0)))
            shapes |= {(_pow2(n), T) for T in c.prefill_buckets if T <= cap}
        return sorted(shapes)

    def _padded_warmup(self, rows: int, T: int) -> Dict[str, np.ndarray]:
        """A padded dispatch's host arrays that compute nothing real: one
        token a row, all-zero tables (every write lands in block 0)."""
        c = self.config
        a = {"toks": np.zeros((rows, T), np.int32),
             "positions": np.tile(np.arange(T, dtype=np.int32), (rows, 1)),
             "tables": np.zeros((rows, c.max_blocks_per_seq), np.int32),
             "ctx_lens": np.zeros(rows, np.int32),
             "true_lens": np.ones(rows, np.int32),
             "seeds": np.zeros(rows, np.int32),
             "temps": np.zeros(rows, np.float32),
             "top_ks": np.zeros(rows, np.int32),
             "top_ps": np.ones(rows, np.float32)}
        if self.lora_bank is not None:
            a["lidx"] = np.zeros(rows, np.int32)
        return a

    def _padded_arrays(self, slots: List[_Slot], chunks: List[int],
                       bucket: int, rows: int,
                       pos: Optional[List[int]] = None
                       ) -> Dict[str, np.ndarray]:
        """The padded programs' host arrays for `slots`, each's chunk of
        `chunks` tokens from its position in `pos` (default its
        prefill_pos) padded to `bucket`, rows past the slots padding
        (true_len 0, all-zero tables): the JAX engine's
        `_prefill_dispatch` and `_prefill_one` arrays."""
        a = self._padded_warmup(rows, bucket)
        a["true_lens"][:] = 0
        for i, (slot, chunk) in enumerate(zip(slots, chunks)):
            p = slot.prefill_pos if pos is None else pos[i]
            a["toks"][i, :chunk] = slot.seq.tokens[p:p + chunk]
            a["positions"][i] = p + np.arange(bucket, dtype=np.int32)
            a["tables"][i] = slot.block_table
            a["ctx_lens"][i] = p
            a["true_lens"][i] = chunk
            sp = slot.request.sampling
            a["seeds"][i] = slot.sampling_seed
            a["temps"][i] = sp.temperature
            a["top_ks"][i] = sp.top_k
            a["top_ps"][i] = sp.top_p
            if "lidx" in a:
                a["lidx"][i] = slot.lora_idx
        return a

    def _prefill_padded(self, pslots: List[_Slot],
                        budget: int) -> Optional[dict]:
        """The JAX engine's padded prefill routing, for capacity-dispatch
        MoE (each sequence its own expert-capacity pool): one slot runs
        `prefill` on its chunk padded to its bucket; several share the
        budget equally, with no donation of leftovers (every row pads to
        the largest chunk's bucket, so a row past its share would
        multiply the batch's padded compute), fewer slots when the
        budget cannot give each the smallest bucket, and run
        `prefill_batched` on pow2(n) rows.  C depends on the padded
        length, so the padding is JAX's.  Returns the FPM record."""
        c = self.config
        n = max(1, min(len(pslots), budget // c.prefill_buckets[0]))
        pslots = pslots[:n]
        if n == 1 and self._ring_eligible(pslots[0]):
            # JAX's _prefill_one routes a ring-eligible slot to the ring
            self._prefill_ring_one(pslots[0])
            return None
        if n == 1:
            chunks = [min(c.prefill_buckets[-1], budget,
                          pslots[0].prompt_len - pslots[0].prefill_pos)]
            rows = 1
        else:
            share = max(budget // n, c.prefill_buckets[0])
            chunks = [min(c.prefill_buckets[-1], share,
                          s.prompt_len - s.prefill_pos) for s in pslots]
            rows = _pow2(n)
        bucket = self._bucket_for(max(chunks))
        tok = self._dispatch_padded(
            self._padded_arrays(pslots, chunks, bucket, rows))
        self.metrics["prefill_steps"] += 1
        need = {i: s for i, (s, ch) in enumerate(zip(pslots, chunks))
                if s.prefill_pos + ch >= s.prompt_len
                and (s.guide is None or s.disagg_prefill)}
        completing = sum(1 for s, ch in zip(pslots, chunks)
                         if s.prefill_pos + ch >= s.prompt_len)
        rec = self._fpm_prefill(n, int(sum(chunks)), bucket, completing,
                                self.padded_prefill.costs[(rows, bucket)],
                                False)
        firsts = self._prefill_samples(tok, need) if need else None
        for i, (slot, chunk) in enumerate(zip(pslots, chunks)):
            if i in need:
                first = int(firsts[i]) if firsts is not None else None
            else:
                first = -1
            self._finish_prefill_chunk(slot, chunk, first)
        return rec

    def _prefill_samples(self, tok: torch.Tensor,
                         need: Dict[int, _Slot]) -> Optional[np.ndarray]:
        """The completing slots' first tokens.  Lockstep: read back now.
        Overlap: start the copy to the host and defer the read one step
        (_flush_pending_first), so this step never blocks on its own
        dispatch; returns None then."""
        back = Readback(tok)
        if self._overlap:
            ents = []
            for row, slot in need.items():
                slot.awaiting_first = True
                ents.append((slot, (self._seq_id(slot), slot.epoch), row))
            self._pending_first.append({"tok": back, "entries": ents})
            return None
        t_obs = obs.begin()
        arr = back.wait()
        obs.end("device_wait", t_obs, track=self._obs_track,
                what="prefill_first_token")
        self._fpm_sync_t = time.monotonic()
        return arr

    def _flush_pending_first(self) -> None:
        """Overlap mode: read back the previous step's deferred first
        tokens and emit them.  Entries whose slot finished, was cancelled
        or was preempted since the dispatch are dropped (the (seq_id,
        epoch) check the in-flight bursts use)."""
        if not self._pending_first:
            return
        pending, self._pending_first = self._pending_first, []
        t_obs = obs.begin()
        arrs = [e["tok"].wait() for e in pending]
        obs.end("device_wait", t_obs, track=self._obs_track,
                what="deferred_first_token")
        self._fpm_sync_t = time.monotonic()
        for e, arr in zip(pending, arrs):
            for slot, ident, row in e["entries"]:
                slot.awaiting_first = False
                if slot.finished or slot.index < 0 \
                        or self._slots[slot.index] is not slot \
                        or (self._seq_id(slot), slot.epoch) != ident:
                    continue
                self._complete_prefill(slot, int(arr[row]))

    def _finish_prefill_chunk(self, slot: _Slot, chunk: int,
                              first: Optional[int]) -> None:
        """Advance a slot past a computed chunk.  `first` is the sampled
        first token when the prompt completes with it, -1 for a chunk
        that does not complete it (or a guided completion, which discards
        the sample), None for a completed prompt whose first token is
        still being read back (the next step's flush emits it)."""
        self.metrics["prefill_tokens"] += chunk
        slot.prefill_pos += chunk
        slot.prefill_chunks += 1
        slot.ctx_len = slot.prefill_pos
        # registration is deferred to materialization, so commit tracks
        # prefill progress chunk by chunk
        self._commit_full_blocks(slot)
        if slot.prefilling:
            return  # more chunks to go; decode runs in between
        if slot.guide is not None and not slot.disagg_prefill:
            # constrained output: the unconstrained sample is discarded
            # and the guided step re-derives the first token's logits by
            # re-running the last prompt position (its K/V rewrite is
            # value-identical)
            slot.first_token_t = time.monotonic()
            slot.ctx_len = slot.prompt_len - 1
            slot.last_token = slot.seq.tokens[slot.prompt_len - 1]
            return
        if first is None:
            return  # awaiting_first; the next step's flush completes it
        self._complete_prefill(slot, first)

    def _complete_prefill(self, slot: _Slot, first: int) -> None:
        """Prompt materialized and first token in hand: emit it, or park
        the KV for a disagg pull."""
        slot.first_token_t = time.monotonic()
        if slot.disagg_prefill:
            self._park_prefilled(slot, first)
            return
        self._push_token(slot, first)

    # -- speculative decoding (spec/) ----------------------------------------
    def _spec_step(self) -> None:
        """One speculation round, as the JAX engine's `_spec_step`:
        propose up to k draft tokens per eligible slot (n-gram prompt
        lookup or the draft model), score every speculating slot's row in
        ONE packed verify dispatch (the bucket's captured program,
        engine/graphs.py VerifyPrograms), read its candidate windows back,
        accept the longest distribution-preserving prefix on the host
        (sampler.spec_accept_tokens) and roll the rejected tail's block
        growth back through the allocator.

        Slots that speculate this step skip the decode burst (their
        emission is synchronous: the verify readback is the step); the
        rest decode as usual.  Mid-pull disagg slots, slots awaiting
        their first token, guided slots and LoRA slots never speculate,
        as in the JAX engine.  A slot whose
        acceptance EMA collapsed to k = 0 rides the pipelined decode path
        and re-probes with exponential backoff; a probe of a pipelined
        slot drains the pipeline first, so the proposer sees its true
        tail."""
        self._specced = frozenset()
        if self.proposer is None:
            return
        c = self.config
        cands = [s for s in self._slots
                 if s is not None and not s.prefilling and not s.pulling
                 and not s.awaiting_first and not s.finished
                 and s.guide is None and s.lora_idx == 0]
        if not cands:
            return
        rows = []
        budget = c.chunk_budget
        for s in cands:
            # an earlier candidate's probe drain can finish or preempt
            # later slots of this snapshot: re-check before the allocator
            if s.finished or self._slots[s.index] is not s:
                continue
            if s.spec_k_cur < 0:
                s.spec_k_cur = c.spec_k
                s.spec_backoff = min(self.SPEC_PROBE_MIN,
                                     c.spec_probe_interval)
                s.spec_accept_ema = 0.5
            if (s.spec_k_cur == 0 or s.inflight > 0) \
                    and s.generated < s.spec_probe_at:
                continue
            if budget <= 1:
                # a probe skipped here stays due next step; draining first
                # would flush the pipeline for a probe that never runs
                break
            if s.inflight > 0:
                self._drain_inflight()
                if s.finished or self._slots[s.index] is not s \
                        or s.inflight:
                    continue
            k = max(1, s.spec_k_cur)
            # verify touches positions [ctx, ctx+k]: cap by the table and
            # by the step's remaining token budget
            k = min(k, c.max_context - 1 - s.ctx_len, budget - 1)
            k = self._spec_grow(s, k) if k > 0 else 0
            if k <= 0:
                self._spec_feedback(s, 0, 0)
                continue
            drafts = list(self.proposer.propose(
                s.seq.tokens, k, ctx=s.ctx_len, draft_pos=s.draft_pos,
                block_table=s.block_table))[:k]
            if not drafts:
                # a miss for the EMA; plain decode takes the slot
                self._spec_feedback(s, 0, 0)
                self._spec_trim(s)
                continue
            budget -= len(drafts) + 1
            rows.append((s, drafts))
        if not rows:
            return
        from ..spec import plan_spec_verify

        plan = plan_spec_verify(rows, block_size=c.block_size,
                                max_blocks_per_seq=c.max_blocks_per_seq)
        g = self.verify_graphs
        T = len(plan.arrays["toks"])
        backs = [Readback(t) for t in self._dispatch_verify(plan.arrays)]
        t_obs = obs.begin()
        ids, vals, lse = (b.wait() for b in backs)
        obs.end("device_wait", t_obs, track=self._obs_track,
                what="spec_verify_fetch")
        self._fpm_sync_t = time.monotonic()
        t_obs = obs.begin()
        proposed_total = accepted_total = 0
        specced = set()
        for (s, drafts), off in zip(plan.rows, plan.offsets):
            n = len(drafts) + 1
            sm = s.request.sampling
            # host rng stream keyed (seed, position), as in the JAX engine
            rng = np.random.default_rng(
                (s.sampling_seed * 0x9E3779B1 + s.generated + 1)
                & 0xFFFFFFFF)
            accepted, emitted = spec_accept_tokens(
                ids[off:off + n], vals[off:off + n], lse[off:off + n],
                drafts, greedy=sm.temperature <= 0.0, top_k=sm.top_k,
                top_p=sm.top_p, rng=rng)
            proposed_total += len(drafts)
            accepted_total += accepted
            self._spec_feedback(s, accepted, len(drafts))
            specced.add(s.index)
            # the device chain no longer feeds this lane: its last_token is
            # a host-side spec emission, so the next burst must neither
            # chain it nor count as a continuation (_is_continuation)
            self._chain_owner[s.index] = None
            ctx0 = s.ctx_len
            for tok in emitted:
                s.ctx_len += 1
                self.metrics["decode_tokens"] += 1
                self._push_token(s, int(tok))
                if s.finished:
                    break
            # the draft cache matches the sequence through the accepted
            # prefix; after FULL acceptance the last draft's own KV was
            # never a decode input, so that position is prefilled again
            s.draft_pos = min(s.ctx_len, ctx0 + len(drafts))
            if not s.finished:
                self._spec_trim(s)
        obs.end("sample", t_obs, track=self._obs_track,
                what="spec_accept", lanes=len(plan.rows))
        self._specced = frozenset(specced)
        self.metrics["spec_steps"] = self.metrics.get("spec_steps", 0) + 1
        self.metrics["spec_proposed"] = \
            self.metrics.get("spec_proposed", 0) + proposed_total
        self.metrics["spec_accepted"] = \
            self.metrics.get("spec_accepted", 0) + accepted_total
        now = time.monotonic()
        gap = (now - self._fpm_last_spec_t
               if self._fpm_last_spec_t else 0.0)
        if gap > 1.0:
            gap = 0.0  # an idle stretch, not verify latency: unknown
        # one FPM record per verify dispatch: the acceptance input the SLA
        # planner's FpmObserver.spec_acceptance aggregates, and the verify
        # program's cost count for the roofline gauges
        cost = g.costs[T]
        self.fpm.append({
            "t": now, "kind": "spec_verify", "lanes": len(plan.rows),
            "proposed": proposed_total, "accepted": accepted_total,
            "tokens": plan.tokens, "gap_s": gap,
            "xla_flops": cost["flops"], "xla_bytes": cost["bytes"],
        })
        self._fpm_last_spec_t = now

    def _spec_grow(self, s: _Slot, k: int) -> int:
        """Grow s's block table to cover verify positions [ctx, ctx+k];
        under allocation pressure shrink k to what the table already
        covers (0 = no speculation this step)."""
        c = self.config
        bs = c.block_size
        nblocks = int(np.count_nonzero(s.block_table))
        while nblocks * bs <= s.ctx_len + k:
            if nblocks >= c.max_blocks_per_seq:
                break
            grow = self.allocator.append_block(self._seq_id(s))
            self._emit_events(grow)
            if grow.block_id is None:
                break
            s.block_table[nblocks] = grow.block_id
            nblocks += 1
        return min(k, nblocks * bs - 1 - s.ctx_len)

    def _spec_trim(self, s: _Slot) -> None:
        """Roll back speculative block growth: trailing blocks beyond the
        materialized context (the rejected drafts' KV slots) return to
        the allocator, so free-block accounting matches plain decode."""
        keep = max(-(-s.ctx_len // self.config.block_size), 1)
        self._emit_events(self.allocator.trim_blocks(self._seq_id(s), keep))
        s.block_table[keep:] = 0

    #: first re-probe distance (generated tokens); failed probes back off
    #: exponentially up to spec_probe_interval
    SPEC_PROBE_MIN = 8

    def _spec_feedback(self, s: _Slot, accepted: int,
                       proposed: int) -> None:
        """Fold one speculation outcome into the slot's adaptivity state:
        a proposer miss (proposed == 0) only pushes the probe clock with
        exponential backoff; a verified round updates the acceptance EMA,
        which runs the full spec_k when high, halves it when middling and
        collapses the slot to 0 (plain decode) below spec_accept_min."""
        c = self.config
        if proposed <= 0:
            s.spec_probe_at = s.generated + s.spec_backoff
            s.spec_backoff = min(s.spec_backoff * 2, c.spec_probe_interval)
            return
        rate = accepted / proposed
        s.spec_accept_ema = 0.7 * s.spec_accept_ema + 0.3 * rate
        if s.spec_accept_ema < c.spec_accept_min:
            s.spec_k_cur = 0
            s.spec_probe_at = s.generated + s.spec_backoff
            s.spec_backoff = min(s.spec_backoff * 2, c.spec_probe_interval)
        else:
            s.spec_backoff = min(self.SPEC_PROBE_MIN, c.spec_probe_interval)
            s.spec_k_cur = c.spec_k if s.spec_accept_ema >= 0.5 \
                else max(1, c.spec_k // 2)

    # -- guided decoding (guided/) -------------------------------------------
    def _guided_codec(self):
        """Token<->text codec for guided decoding: the worker installs the
        model's tokenizer; otherwise the byte mock the presets' model
        cards advertise."""
        if self.guided_codec is None:
            from ..frontend.tokenizer import MockTokenizer

            self.guided_codec = MockTokenizer(self.model_cfg.vocab_size)
        return self.guided_codec

    def _guided_step(self) -> None:
        """One constrained token for every guided slot, as the JAX
        engine's `_guided_step`.  Each slot steps alone through the
        top-M program (engine/graphs.py GuidedPrograms, its lane the only
        valid one), whose candidates are read back synchronously, after
        the decode bursts already queued on the stream.  They are tried
        in sampled order (argsort of the logits when greedy, else a Gumbel
        draw from the host rng keyed (seed + generated)) and the first
        whose decoded text keeps the output a valid JSON prefix wins; EOS
        is admissible only once the document is complete.  When no
        candidate of the window or of the widened retry fits, or the
        token budget runs out mid-document, the canonical completion
        closes the document, so the response is always schema-valid.
        Slots awaiting their first token are skipped: a guided disagg
        hop parks its prompt's KV at the next flush."""
        gslots = [s for s in self._slots
                  if s is not None and not s.prefilling
                  and not s.awaiting_first
                  and s.guide is not None and not s.finished]
        if not gslots:
            return
        c = self.config
        codec = self._guided_codec()
        g = self.guided_graphs
        t_obs = obs.begin()
        for slot in gslots:
            # a block for the next position (no burst speculation needed)
            nblocks = int(np.count_nonzero(slot.block_table))
            if slot.ctx_len >= nblocks * c.block_size:
                if nblocks >= c.max_blocks_per_seq:
                    self._guided_finish(slot, codec, forced=True)
                    continue
                grow = self.allocator.append_block(self._seq_id(slot))
                self._emit_events(grow)
                if grow.block_id is None:
                    self._preempt(slot)
                    continue
                slot.block_table[nblocks] = grow.block_id
            a = g.host_descriptor()
            i = slot.index
            a["tokens"][i] = slot.last_token
            a["positions"][i] = slot.ctx_len
            a["ctx_lens"][i] = slot.ctx_len
            a["tables"][i] = slot.block_table
            a["valid"][i] = True
            backs = self._dispatch_guided(a, self.GUIDED_TOPM)
            t_d = obs.begin()
            ids, vals = (b.wait() for b in backs)
            obs.end("device_wait", t_d, track=self._obs_track,
                    what="guided_topk_fetch")
            self._fpm_sync_t = time.monotonic()
            slot.ctx_len += 1  # this step's KV write is in the cache
            s = slot.request.sampling
            text = codec.decode(slot.guided_out)

            def choose(cand_ids, cand_logits):
                if s.temperature <= 0.0:
                    order = np.argsort(-cand_logits)
                else:
                    gum = np.random.default_rng(
                        (slot.sampling_seed + slot.generated)
                        & 0xFFFFFFFF).gumbel(size=cand_logits.shape)
                    order = np.argsort(-(cand_logits / s.temperature + gum))
                for j in order:
                    tok = int(cand_ids[j])
                    if tok in self.eos_ids:
                        if slot.guide.done(text):
                            return ("eos", tok)
                        continue
                    if slot.guide.ok(codec.decode(slot.guided_out + [tok])):
                        return ("tok", tok)
                return None

            chosen = choose(ids[i], vals[i])
            if chosen is None:
                # nothing in the top-M set extends the document: retry
                # once with the widened set before giving up (the step
                # re-runs the same position; the shared body rewrites
                # its K/V with the same values)
                self.metrics["guided_widened_retries"] = \
                    self.metrics.get("guided_widened_retries", 0) + 1
                backs = self._dispatch_guided(a, self.GUIDED_TOPM_WIDE)
                t_d = obs.begin()
                wids, wvals = (b.wait() for b in backs)
                obs.end("device_wait", t_d, track=self._obs_track,
                        what="guided_topk_fetch")
                chosen = choose(wids[i], wvals[i])
            if chosen is None:
                # even the widened set has no valid continuation: close
                # the document canonically (and say so in the response)
                self._guided_finish(slot, codec, forced=True)
                continue
            kind, tok = chosen
            if kind == "eos":
                self._guided_emit(slot, tok, "stop")
                continue
            slot.guided_out.append(tok)
            done = slot.guide.done(codec.decode(slot.guided_out))
            self._guided_emit(slot, tok, "stop" if done else None)
            if not slot.finished \
                    and slot.generated >= slot.request.stop.max_tokens:
                # budget exhausted mid-document: schema validity beats
                # the token budget, so the document is closed canonically
                # (a few tokens over) instead of truncated
                self._guided_finish(slot, codec, forced=True)
        obs.end("sample", t_obs, track=self._obs_track, what="guided",
                lanes=len(gslots))

    def _forensic(self, slot: _Slot) -> Dict[str, Any]:
        """Worker-side forensic facts for the stream's first-token and
        finish frames (the JAX frontend's RequestTracker reads them as
        the `worker_stamp` hop): the realized prefix-cache reuse, the
        waiting-queue position at enqueue, and step counts."""
        return {
            "cached_tokens": slot.cached_tokens,
            "queue_pos": slot.queue_pos,
            "prefill_chunks": slot.prefill_chunks,
            "generated": slot.generated,
        }

    def _stamp_metrics(self, slot: _Slot,
                       finish: Optional[str]) -> Optional[Dict[str, Any]]:
        """A token frame's metrics, as the JAX engine stamps them: the
        finish frame's usage, reuse and TTFT with the forensic stamp, the
        first token frame's stamp alone, none on the others."""
        if finish:
            return {"kv_usage": self.kv_usage(),
                    "cached_tokens": slot.cached_tokens,
                    "ttft_s": slot.first_token_t - slot.enqueued_t,
                    "forensic": self._forensic(slot)}
        if slot.generated == 1:
            return {"forensic": self._forensic(slot)}
        return None

    def _put(self, slot: _Slot, out: LLMEngineOutput) -> None:
        """Hand one chunk to the slot's stream (on the loop's thread)."""
        if self._loop_ref is not None:
            self._loop_ref.call_soon_threadsafe(slot.out_q.put_nowait, out)
        else:
            slot.out_q.put_nowait(out)

    def _release_finished(self, slot: _Slot) -> None:
        """A guided stream's end: the slot and its blocks go, as in the
        JAX engine's guided path."""
        slot.finished = True
        if slot.index >= 0:
            self._slots[slot.index] = None
            slot.index = -1
        self._emit_events(self.allocator.free(self._seq_id(slot)))

    def _guided_emit(self, slot: _Slot, tok: int,
                     finish: Optional[str]) -> None:
        """Stream one guided token with an explicit finish decision (the
        generic _finish_reason would truncate at max_tokens
        mid-document; the guided path closes the document instead)."""
        now = time.monotonic()
        if slot.last_push_t > 0.0:
            gap = now - slot.last_push_t
            self.itl_ema_s = gap if self.itl_ema_s == 0.0 \
                else 0.95 * self.itl_ema_s + 0.05 * gap
        slot.last_push_t = now
        slot.seq.append(tok)
        slot.last_token = tok
        slot.generated += 1
        self.metrics["decode_tokens"] += 1
        self._commit_full_blocks(slot)
        # the forensic stamp on the first and the finish frame, as the
        # JAX engine's guided path stamps them
        self._put(slot, LLMEngineOutput(
            token_ids=[tok], finish_reason=finish,
            metrics=({"forensic": self._forensic(slot)}
                     if finish is not None or slot.generated == 1
                     else None)))
        if finish is not None:
            self._release_finished(slot)

    def _guided_finish(self, slot: _Slot, codec,
                       forced: bool = False) -> None:
        """Emit the canonical completion that closes the document and
        finish the stream.  A non-empty completion means the engine, not
        the model, wrote the document's tail: the final chunk's metrics
        say how many tokens (`guided_forced_close_tokens`), and
        `guided_forced_closes` counts such finishes."""
        text = codec.decode(slot.guided_out)
        try:
            completion = slot.guide.complete(text)
        except ValueError:
            completion = ""
        toks = codec.encode(completion) if completion else []
        slot.guided_out.extend(toks)
        metrics = {"forensic": self._forensic(slot)}
        if toks or forced:
            self.metrics["guided_forced_closes"] = \
                self.metrics.get("guided_forced_closes", 0) + 1
            metrics["guided_forced_close_tokens"] = len(toks)
        self._put(slot, LLMEngineOutput(token_ids=list(toks),
                                        finish_reason="stop",
                                        metrics=metrics))
        self._release_finished(slot)

    # -- decode -------------------------------------------------------------
    def _fuse_ladder(self) -> List[int]:
        """The burst sizes adaptive fusion can dispatch, ascending: 1, then
        INTERLEAVE_BURST doubling up to decode_fused_steps.  One program
        per (greedy, rung) exists (engine/graphs.py), all built by
        warmup_decode: the ladder is the closed set serving can reach."""
        fused = self.config.decode_fused_steps
        ladder = [1]
        k = min(self.INTERLEAVE_BURST, fused)
        while k > ladder[-1]:
            ladder.append(k)
            k = min(k * 2, fused)
        return ladder

    def _fused_k(self) -> int:
        """This step's burst size (the adaptive fusion policy): pending
        admissions, prefill chunks or deferred first tokens de-fuse to the
        interleave burst and reset the ramp; a decode-only stretch ramps
        up the ladder one rung per step."""
        c = self.config
        if c.decode_fused_steps <= 1:
            return 1
        if (self.waiting
                or any(s is not None and (s.prefilling or s.awaiting_first)
                       for s in self._slots)):
            self._decode_only_run = 0
            return min(self.INTERLEAVE_BURST, c.decode_fused_steps)
        if not c.decode_fuse_adaptive:
            return c.decode_fused_steps
        k = min(self.INTERLEAVE_BURST << self._decode_only_run,
                c.decode_fused_steps)
        self._decode_only_run = min(self._decode_only_run + 1, 16)
        return k

    def _decodable(self) -> List[_Slot]:
        # slots that speculated this step already emitted synchronously
        # (_spec_step): dispatching them again would double-step; guided
        # slots step alone (_guided_step)
        return [s for s in self._slots
                if s is not None and not s.prefilling
                and not s.awaiting_first and s.guide is None
                and s.index not in self._specced]

    def _decode_step(self) -> None:
        """One decode burst for every slot past prefill.  At most depth-1
        bursts stay unread after it (the oldest are processed first);
        lockstep mode is depth 1 with a drain right after the dispatch."""
        c = self.config
        t_obs = obs.begin()
        depth = max(1, c.decode_pipeline_depth) if self._overlap else 1
        while len(self._inflight) >= depth:
            self._process_oldest_burst()
        k = self._fused_k()
        active = self._decodable()
        if not active:
            return
        # every active slot MUST have a block for its next device position
        # ctx_len + inflight (preempted if even that fails); blocks for the
        # rest of the burst are speculative: under pressure the burst
        # degrades to k = 1 instead of preempting
        for slot in active:
            # a drain below can finish later slots of this snapshot
            if slot.finished or self._slots[slot.index] is not slot:
                continue
            eff = slot.ctx_len + slot.inflight
            nblocks = int(np.count_nonzero(slot.block_table))
            if eff >= nblocks * c.block_size:
                if nblocks >= c.max_blocks_per_seq:
                    # the in-flight tokens reach the end of the table:
                    # drain so the length finish fires first
                    self._drain_inflight()
                    return
                grow = self.allocator.append_block(self._seq_id(slot))
                self._emit_events(grow)
                if grow.block_id is None:
                    # processing may finish the slot or free blocks
                    self._drain_inflight()
                    if slot.finished or self._slots[slot.index] is not slot:
                        continue
                    grow = self.allocator.append_block(self._seq_id(slot))
                    self._emit_events(grow)
                    if grow.block_id is None:
                        self._preempt(slot)
                        continue
                slot.block_table[nblocks] = grow.block_id
                nblocks += 1
            while k > 1 and eff + k - 1 >= nblocks * c.block_size:
                if nblocks >= c.max_blocks_per_seq:
                    k = 1  # positions past the table would clamp
                    break
                grow = self.allocator.append_block(self._seq_id(slot))
                self._emit_events(grow)
                if grow.block_id is None:
                    k = 1  # pressure: single step this time
                    break
                slot.block_table[nblocks] = grow.block_id
                nblocks += 1
        active = self._decodable()
        if not active:
            return
        # from here to the dispatch is host work building and enqueuing
        # the NEXT burst; with unread bursts in flight the device is still
        # executing, so it is the overlapped `enqueue_ahead` phase, nested
        # inside decode_dispatch
        t_ea = obs.begin() if (self._overlap and self._inflight) else 0.0
        # fresh arrays per full dispatch: _last_desc keeps the previous
        # ones as the continuation check's host mirror
        a = self.graphs.host_descriptor()
        for s in active:
            i, sp = s.index, s.request.sampling
            a["tokens"][i] = s.last_token
            # a lane whose previous burst is unread takes its input token
            # from the device chain; the host's last_token is stale
            a["use_chain"][i] = (
                self._chain_owner[i] == (self._seq_id(s), s.epoch)
                and s.inflight > 0)
            a["positions"][i] = a["ctx_lens"][i] = s.ctx_len + s.inflight
            a["tables"][i] = s.block_table
            a["seeds"][i] = s.sampling_seed
            a["steps"][i] = s.generated + s.inflight + 1
            a["temps"][i] = sp.temperature
            a["top_ks"][i] = sp.top_k
            a["top_ps"][i] = sp.top_p
            a["valid"][i] = True
            if "lidx" in a:
                a["lidx"][i] = s.lora_idx
        greedy = bool(np.all(a["temps"] <= 0.0))
        cont = self._is_continuation(a, active, k)
        if cont:
            # steady state: only the clock moved; advance the device
            # descriptor in the program and upload nothing
            prev = self._last_desc
            adv = prev["k"]
            back = self._dispatch_decode_cont(k, adv, greedy)
            for name in ("positions", "ctx_lens", "steps"):
                prev[name] = prev[name] + adv
            prev["k"] = k
            self.metrics["cont_bursts"] += 1
        else:
            back = self._dispatch_decode(a, greedy, k)
            self._last_desc = {n: v for n, v in a.items()
                               if n not in ("tokens", "use_chain")}
            self._last_desc["k"] = k
        obs.end("enqueue_ahead", t_ea, track=self._obs_track, k=k)
        self.metrics["decode_steps"] += k
        self.metrics["decode_bursts"] += 1
        rec = self._fpm_decode(k, self.graphs.costs[(greedy, k)])
        lanes = {}
        for s in active:
            s.inflight += k
            lanes[s.index] = (self._seq_id(s), s.epoch)
            self._chain_owner[s.index] = lanes[s.index]
        self._inflight.append({"burst": back, "k": k, "lanes": lanes})
        if t_obs:
            obs.end("decode_dispatch", t_obs, track=self._obs_track,
                    cont=cont, k=k, lanes=len(active),
                    **_span_fields(rec, _DECODE_SPAN_FIELDS))
        if not self._overlap:
            self._drain_inflight()  # lockstep: block and emit now

    def _is_continuation(self, a: Dict[str, np.ndarray], active,
                         k: int) -> bool:
        """True when this burst is the pure continuation of the last one:
        the same k, membership, tables, sampling and adapter slots, every
        lane's input token in the device chain, and positions and steps
        exactly one advance ahead, so the device descriptor can advance
        in place."""
        prev = self._last_desc
        if prev is None or k != prev["k"]:
            return False
        for s in active:
            if self._chain_owner[s.index] != (self._seq_id(s), s.epoch):
                return False
        m = a["valid"]
        adv = prev["k"]
        return (
            np.array_equal(a["valid"], prev["valid"])
            and np.array_equal(a["positions"][m], prev["positions"][m] + adv)
            and np.array_equal(a["ctx_lens"][m], prev["ctx_lens"][m] + adv)
            and np.array_equal(a["steps"][m], prev["steps"][m] + adv)
            and all(np.array_equal(a[n][m], prev[n][m])
                    for n in ("tables", "seeds", "temps", "top_ks",
                              "top_ps", "lidx") if n in a))

    def _process_oldest_burst(self) -> None:
        """Read back the oldest dispatched burst and apply it: stream its
        tokens, advance ctx, commit blocks, detect finishes.  Lanes whose
        slot finished, was preempted or cancelled since the dispatch are
        discarded (their writes went to blocks never committed past the
        finish, or to freed blocks that later dispatches overwrite in
        stream order)."""
        e = self._inflight.popleft()
        t_obs = obs.begin()
        arr = e["burst"].wait()  # [k, B]
        obs.end("device_wait", t_obs, track=self._obs_track, k=e["k"],
                what="burst_fetch")
        self._fpm_sync_t = time.monotonic()
        for i, ident in e["lanes"].items():
            s = self._slots[i]
            if s is None or (self._seq_id(s), s.epoch) != ident \
                    or s.finished:
                continue
            s.inflight -= e["k"]
            for j in range(e["k"]):
                s.ctx_len += 1
                self.metrics["decode_tokens"] += 1
                self._push_token(s, int(arr[j, i]))
                if s.finished:
                    break  # mid-burst finish: the overshoot is discarded

    def _drain_inflight(self) -> None:
        while self._inflight:
            self._process_oldest_burst()

    # -- forward-pass metrics ------------------------------------------------
    def _fpm_prefill(self, rows: int, tokens: int, bucket: int,
                     completing: int, cost: Dict[str, float],
                     packed: bool) -> dict:
        """One record per prefill dispatch (`packed`: the packed program,
        else a padded one), as the JAX engine's `_fpm_prefill`: gap_s is the dispatch-to-dispatch gap (0.0 after
        an idle second: unknown), queue_depth the prefilling and waiting
        requests minus those this dispatch completes, xla_flops/xla_bytes
        the bucket program's cost count (obs/costs.py; JAX's come from
        XLA's cost analysis of the compiled program), and est_mfu the
        hand-counted dense FLOPs over the gap against config.peak_tflops,
        when that is set and a blocking read of sampled tokens landed
        inside the gap; `mfu` is the cost count's FLOPs over the same gap
        (it includes attention, the real logit rows and the bucket's
        padding)."""
        now = time.monotonic()
        gap = (now - self._fpm_last_prefill_t
               if self._fpm_last_prefill_t else 0.0)
        if gap > 1.0:
            gap = 0.0
        depth = max(0, len(self.waiting) + sum(
            1 for s in self._slots if s is not None and s.prefilling)
            - completing)
        flops = tokens * self._flops_per_token
        synced = self._fpm_sync_t >= self._fpm_last_prefill_t
        rec = {
            "t": now, "kind": "prefill", "rows": rows, "tokens": tokens,
            "bucket": bucket, "packed": packed, "gap_s": gap,
            "flops": flops, "queue_depth": depth, "synced": synced,
            "xla_flops": cost["flops"], "xla_bytes": cost["bytes"],
        }
        if gap > 0.0 and self.config.peak_tflops > 0.0 and synced:
            peak = self.config.peak_tflops * 1e12
            rec["est_mfu"] = min(flops / gap / peak, 1.0)
            rec["mfu"] = min(cost["flops"] / gap / peak, 1.0)
        self.fpm.append(rec)
        self._fpm_last_prefill_t = now
        return rec

    def _fpm_decode(self, k: int, cost: Dict[str, float]) -> dict:
        """One record per decode burst, as the JAX engine's: its fused k,
        the slots past prefill, the dispatch-to-dispatch gap (with the
        pipeline saturated, the burst's wall time; 0.0 after an idle
        second: unknown) and the burst program's cost count as
        xla_flops/xla_bytes."""
        now = time.monotonic()
        gap = (now - self._fpm_last_decode_t
               if self._fpm_last_decode_t else 0.0)
        if gap > 1.0:
            gap = 0.0
        lanes = sum(1 for s in self._slots
                    if s is not None and not s.prefilling)
        rec = {"t": now, "kind": "decode", "k": k, "lanes": lanes,
               "gap_s": gap, "xla_flops": cost["flops"],
               "xla_bytes": cost["bytes"]}
        self.fpm.append(rec)
        self._fpm_last_decode_t = now
        return rec

    def _commit_full_blocks(self, slot: _Slot) -> None:
        """Register newly completed full blocks under their PLH, once every
        one of their tokens' K/V is in the cache (covered by ctx_len): the
        sampled token that completes a block has its K/V written on the
        NEXT decode step, so that block commits one step later."""
        materialized = slot.ctx_len // self.config.block_size
        limit = min(slot.seq.num_full_blocks, materialized)
        while slot.committed_blocks < limit:
            idx = slot.committed_blocks
            self._emit_events(self.allocator.commit_block(
                self._seq_id(slot), idx, slot.seq.block_hashes[idx]))
            slot.committed_blocks += 1

    def _push_token(self, slot: _Slot, tok: int) -> None:
        """Append a generated token, stream it, handle finish."""
        now = time.monotonic()
        if slot.last_push_t > 0.0:
            gap = now - slot.last_push_t
            self.itl_ema_s = gap if self.itl_ema_s == 0.0 \
                else 0.95 * self.itl_ema_s + 0.05 * gap
        slot.last_push_t = now
        slot.seq.append(tok)
        slot.last_token = tok
        slot.generated += 1
        self._commit_full_blocks(slot)
        finish = self._finish_reason(slot, tok)
        self._put(slot, LLMEngineOutput(
            token_ids=[tok], finish_reason=finish,
            metrics=self._stamp_metrics(slot, finish)))
        if finish is not None:
            slot.finished = True
            if slot.index >= 0:
                self._slots[slot.index] = None
            self._emit_events(self.allocator.free(self._seq_id(slot)))

    def _preempt(self, slot: _Slot) -> None:
        """KV out of blocks: drop the slot's blocks and re-enqueue it
        first, to be replayed from its full token sequence."""
        self.metrics["preemptions"] += 1
        self._slots[slot.index] = None
        self._emit_events(self.allocator.free(self._seq_id(slot)))
        slot.index = -1
        slot.ctx_len = 0
        slot.prefill_pos = 0
        slot.prompt_len = 0
        slot.committed_blocks = 0
        slot.block_table[:] = 0
        # its in-flight bursts are discarded when processed (lanes are
        # keyed by (seq_id, epoch))
        slot.epoch = next(self._epochs)
        slot.inflight = 0
        # the draft-model cache for the freed blocks is stale: the replay
        # re-prefills the draft from position 0 (spec/draft.py)
        slot.draft_pos = 0
        with self._qlock:
            self.waiting.insert(0, slot)

    def _finish_reason(self, slot: _Slot, tok: int) -> Optional[str]:
        st = slot.request.stop
        if not st.ignore_eos and tok in self.eos_ids:
            return "stop"
        if tok in (st.stop_token_ids or []):
            return "stop"
        if slot.generated >= st.max_tokens:
            return "length"
        if slot.ctx_len + 1 >= self.config.max_context:
            return "length"
        return None

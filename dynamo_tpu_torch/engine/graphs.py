"""The decode-burst and packed-prefill programs, captured once as CUDA
graphs and replayed.

The port's counterpart of the JAX engine's jitted decode programs
(`_decode_impl`, `_decode_multi_impl`, dynamo_tpu/engine/core.py) and of
its compile watch.  One program exists per (greedy, k): k fused decode
steps (models/llama.py decode_multi) at the fixed batch B = max_num_seqs
and full table width, argmax-only when `greedy`, else drawing with the
stateless sampler (engine/sampler.py sample_tokens).  With the fused
sampling epilogue (`epilogue=True`, EngineConfig.sampling_epilogue
"fused") every program ends each step at the final-norm hidden state
(models/llama.py decode_multi_hidden) and streams the projection through
ops/fused_sampling.py instead: a static property of all the programs,
as in the JAX engine, so the set of (greedy, k) programs is the same in
both modes.  Every program reads
the same static input buffers, the argument list of the JAX programs:
chain, use_chain, tokens, positions, tables, ctx_lens, seeds, steps,
temps, top_ks, top_ps, valid and the `advance` scalar.  They are views
of ONE int32 device descriptor (floats by their bits, flags as 0/1), so
a full dispatch uploads it with one copy from a pinned staging buffer.
A program adds `advance` to positions, ctx_lens and steps in place (the
continuation clock: a steady-state burst re-dispatches the previous
descriptor with advance = k and uploads nothing), takes each lane's
input token from the device chain where use_chain is set, writes its
[k, B] tokens to its own static output and their last row to the chain.

On CUDA the first run of a program is eager, which also sizes K1's
workspace and warms cuBLAS; it is then captured into a CUDA graph (one
memory pool shared by all programs; the KV cache and the parameters keep
their addresses, since every write is in place), and every later run
replays the graph.  Python's cyclic collector is off while a capture
runs: a collection there may destroy another, unreachable engine's
graphs, and destroying a graph invalidates the capture.  `warmup_decode` (engine/core.py) builds every rung
of the fusion ladder under the step lock, so serving captures nothing.
A capture that fails raises: there is no eager fallback on CUDA.
`counts[(greedy, k)]` is the number of times a program was built
(captured on CUDA; first run on the CPU): the analogue of
`compile_watch.counts`, and steady-state serving must not raise it.
With `capture=False` (and always on the CPU) the bodies run eagerly.

K1's wrappers count the launches they make.  A capture launches nothing,
so the counts it added are taken back and kept per program, and each
replay adds its program's count (k x layers) to the wrapper's.

PrefillPrograms, the counterpart of the JAX engine's one jitted packed
prefill per bucket (`_prefill_packed_impl`): one program per stream
length T of the planner's bucket ladder (engine/prefill.py; with the
default config the seven `prefill_buckets` 32 ... 2048).  Each runs
models/llama.py prefill_packed, which computes K3's tile plan on the
device, then sample_tokens (greedy rows take the argmax) into static
[rows] tokens and [rows, vocab] logits.  Rows are padded to
max_prefill_seqs and tables to max_blocks_per_seq: a padding row has
last_idx 0 and an all-zero table, and owns no token, so it reads and
writes only block 0 and K3 skips it.  So one program per bucket serves
every plan.  Its inputs are views of one int32 descriptor per bucket
(toks, positions, seg_ids, valid, then per row last_idx, seeds, temps,
top_ks, top_ps, then the tables), uploaded with one copy from a pinned
staging buffer.  The prefill programs keep their own graph pool: their
replays interleave with the decode programs' in any order.  K3's
launches move from the capture to each replay, as K1's do, and
`counts[T]` gates the builds as `counts[(greedy, k)]` does.

CatchupPrograms, the counterpart of the JAX draft proposer's jitted
catch-up prefill (`_prefill_impl`, spec/draft.py): one program per
prefill bucket, one segment each (its table the draft's row), writing
the draft model's cache only; its graph pool is its own.

VerifyPrograms, the counterpart of the JAX engine's jitted `spec_verify`
(`_spec_verify_impl`, speculative decoding): the same bucket machinery
(_BucketPrograms), one program per verify stream length T (the pow2
ladder from 8 to the stream a full round can give, engine/core.py), rows
padded to a fixed count and tables to max_blocks.  Each runs
models/llama.py spec_verify_packed (K3 attends, every packed position's
logits) and `spec_verify_window` into static ids [T, CAP], vals
[T, CAP] and lse [T], which the engine reads back for the host-side
acceptance test.  Its descriptor is toks, positions, seg_ids, valid and
temps_t of T words each, then the tables.  Its graph pool is its own.

LoRA (lora/bank.py): with an adapter bank the decode descriptor gains a
`lidx` lane (each lane's bank slot) after `valid`, the prefill stream a
`lidx` word per token, and both bodies read the bank's tensors in place
(its slots are written in place, so the captured addresses stay valid).
Without a bank the descriptors and the bodies are exactly the bank-less
ones.

GuidedPrograms, the counterpart of the JAX engine's guided top-M
programs (`_decode_topk_impl`): one decode step and the M largest
logits of every lane, for M = 32 and the widened 256, one graph each in
their own pool, both built by warm-up.

MoE (models/llama.py `_ffn`): every program above captures a MoE trunk
as it does a dense one, the descriptor's `valid` lanes or stream tokens
reaching the dispatch (padding claims no expert capacity).
PaddedPrefillPrograms, the counterparts of the JAX engine's jitted
`_prefill_impl` and `_prefill_batched_impl`, serve capacity-dispatch
MoE, whose sequences a packed stream would pool: one chunk padded to its
bucket, or pow2 rows padded to one bucket, run eagerly (capturing them
is left to do), one build record per (rows, T).

Every body calls the model family the engine bound (models/__init__.py
get_family; `self.family`).  The DeepSeek MLA family (models/
deepseek.py) has no packed prefill and no verify path, so an MLA engine
builds DecodePrograms, GuidedPrograms and PaddedPrefillPrograms only:
its decode bursts and top-M steps are captured as Llama's are (the
absorbed attention is plain torch, so a capture moves no kernel
launches), and its prefill takes the padded programs eagerly.

Every family records each build (`_Built`): `costs[key]` holds the
program's cost count (obs/costs.py, {"flops", "bytes"} at its captured
shapes), computed once at the build, and a `watch` the engine installs
(obs/compile_watch.py CaptureWatch) is told the family, the key, the
build's seconds (first run plus capture) and the costs.

Readback, the counterpart of `copy_to_host_async`: right after a run
its output is copied on the same stream into a pinned host buffer owned
by the returned `Readback`, and an event is recorded; `wait()` blocks on
that event only.  The next burst's replay may overwrite the static
output, but stream order puts it after the copy.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import get_family
from ..obs.costs import program_costs
from ..ops import fused_sampling
from .sampler import CAP, sample_tokens, top_window

# descriptor fields of B words each, in buffer order, then the tables
# (B x max_blocks words) and the advance word
FIELDS = ("tokens", "use_chain", "positions", "ctx_lens", "seeds", "steps",
          "temps", "top_ks", "top_ps", "valid")
_FLOAT_FIELDS = ("temps", "top_ps", "temps_t")
# pinned staging buffers for descriptor uploads, reused round-robin; each
# is rewritten only after the event of its last copy
_STAGING = 4


class Readback:
    """A device int32 array on its way to the host."""

    def __init__(self, src: torch.Tensor):
        if src.is_cuda:
            self._host = torch.empty(src.shape, dtype=src.dtype,
                                     pin_memory=True)
            self._host.copy_(src, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = src.clone(), None

    def wait(self) -> np.ndarray:
        """The host array, once its copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _lora_shape(bank: Optional[Dict[str, torch.Tensor]]) -> tuple:
    """(slots, rank) of a LoRA bank (lora/bank.py), (0, 0) without one."""
    if bank is None:
        return 0, 0
    a = bank["A_q"]  # [L, N, d_in, r]
    return int(a.shape[1]), int(a.shape[3])


class _Built:
    """A program family's build record: `counts[key]` (1 once built),
    `costs[key]` (the cost count, obs/costs.py) and the capture watch's
    event.  Subclasses give `COST_FAMILY` and the shape arguments of
    their count, and the family name the watch records."""

    COST_FAMILY = ""
    watch = None  # obs/compile_watch.py CaptureWatch, set by the engine

    def _cost_shape(self) -> dict:
        raise NotImplementedError

    def watch_family(self, key) -> str:
        raise NotImplementedError

    @staticmethod
    def watch_tokens(key) -> int:
        return int(key)

    def _built(self, key, seconds: float) -> None:
        self.counts[key] = 1
        self.costs[key] = program_costs(self.cfg, self.COST_FAMILY, key,
                                        **self._cost_shape())
        if self.watch is not None:
            self.watch.on_capture(self.watch_family(key),
                                  self.watch_tokens(key), seconds,
                                  self.costs[key])


def _cache_shape(kv: tuple) -> dict:
    """The cost count's cache arguments: block size and the int8 mode."""
    return {"block_size": int(kv[0].shape[3]),
            "int8": kv[0].dtype == torch.int8}


class _Desc:
    """Views of the descriptor buffer by field name."""

    def __init__(self, buf: torch.Tensor, B: int, max_blocks: int,
                 fields: tuple):
        for i, name in enumerate(fields):
            view = buf[i * B:(i + 1) * B]
            setattr(self, name, view.view(torch.float32)
                    if name in _FLOAT_FIELDS else view)
        off = len(fields) * B
        self.tables = buf[off:off + B * max_blocks].view(B, max_blocks)
        self.advance = buf[off + B * max_blocks:]


class _LaneDescriptor:
    """A lane-major int32 device descriptor (`fields` of B words each,
    then the tables, then the advance word) with its pinned staging
    buffers: what the decode and the guided programs read."""

    def _init_descriptor(self, B: int, max_blocks: int,
                         device: torch.device, fields: tuple) -> None:
        self.B, self.max_blocks, self.device = B, max_blocks, device
        self.fields = fields
        n = len(fields) * B + B * max_blocks + 1
        self.desc = torch.zeros(n, dtype=torch.int32, device=device)
        self.d = _Desc(self.desc, B, max_blocks, fields)
        pin = device.type == "cuda"
        self._staging = [torch.zeros(n, dtype=torch.int32, pin_memory=pin)
                         for _ in range(_STAGING)]
        self._staged = [None] * _STAGING
        self._next = 0

    # -- inputs ------------------------------------------------------------
    def host_descriptor(self) -> Dict[str, np.ndarray]:
        """Fresh host arrays of a descriptor with every lane padding (the
        JAX engine's padding values: top_p 1, everything else 0), for the
        caller to fill its live lanes into."""
        B = self.B
        a = {name: np.zeros(B, np.float32 if name in _FLOAT_FIELDS
                            else bool if name in ("use_chain", "valid")
                            else np.int32) for name in self.fields}
        if "top_ps" in a:
            a["top_ps"][:] = 1.0
        a["tables"] = np.zeros((B, self.max_blocks), np.int32)
        return a

    def upload(self, a: Dict[str, np.ndarray]) -> None:
        """A full descriptor from the host arrays `a` (the JAX engine's
        descriptor keys), advance 0: one copy from a pinned buffer."""
        i = self._next
        self._next = (i + 1) % _STAGING
        if self._staged[i] is not None:
            self._staged[i].synchronize()  # its last copy has run
        host = self._staging[i].numpy()
        B = self.B
        for j, name in enumerate(self.fields):
            col = np.asarray(a[name])
            host[j * B:(j + 1) * B] = (col.astype(np.float32).view(np.int32)
                                       if name in _FLOAT_FIELDS
                                       else col.astype(np.int32))
        off = len(self.fields) * B
        host[off:off + B * self.max_blocks] = np.asarray(
            a["tables"], np.int32).reshape(-1)
        host[-1] = 0
        self.desc.copy_(self._staging[i], non_blocking=True)
        if self.device.type == "cuda":
            self._staged[i] = torch.cuda.Event()
            self._staged[i].record()


class DecodePrograms(_LaneDescriptor, _Built):
    COST_FAMILY = "decode"
    # the JAX programs' names: decode (one step), decode_multi (bursts);
    # the draft proposer's instance records draft_propose
    FAMILY_ONE, FAMILY_MULTI = "decode", "decode_multi"

    def __init__(self, params, cfg, kv: tuple, B: int,
                 max_blocks: int, device: torch.device,
                 capture: bool = True, epilogue: bool = False,
                 lora_bank: Optional[Dict[str, torch.Tensor]] = None):
        self.params, self.cfg, self.kv = params, cfg, kv
        self.family = get_family(cfg)
        self.epilogue = epilogue
        # with a LoRA bank the descriptor gains the `lidx` lane (each
        # lane's bank slot) and the body reads the bank in place
        self.lora_bank = lora_bank
        self.capture = capture and device.type == "cuda"
        self._init_descriptor(
            B, max_blocks, device,
            FIELDS + ("lidx",) if lora_bank is not None else FIELDS)
        self.chain = torch.zeros(B, dtype=torch.int32, device=device)
        self.out: Dict[int, torch.Tensor] = {}
        self.counts: Dict[Tuple[bool, int], int] = {}
        self.costs: Dict[Tuple[bool, int], Dict[str, float]] = {}
        # seconds each capture took, and the bytes the graph pool reserved
        self.capture_s: Dict[Tuple[bool, int], float] = {}
        self.pool_bytes = 0
        self._graphs: Dict[Tuple[bool, int], torch.cuda.CUDAGraph] = {}
        self._graph_launches: Dict[Tuple[bool, int], list] = {}
        self._pool = None

    def _cost_shape(self) -> dict:
        return {"rows": self.B, "max_blocks": self.max_blocks,
                "lora": _lora_shape(self.lora_bank),
                "epilogue": self.epilogue, **_cache_shape(self.kv)}

    def watch_family(self, key) -> str:
        return self.FAMILY_ONE if key[1] == 1 else self.FAMILY_MULTI

    @staticmethod
    def watch_tokens(key) -> int:
        return int(key[1])

    def continuation(self, advance: int) -> None:
        """Re-dispatch the device descriptor: every lane chains and the
        program advances it by `advance`; nothing is uploaded."""
        self.d.use_chain.fill_(1)
        self.d.advance.fill_(advance)

    def snapshot(self) -> tuple:
        return self.desc.clone(), self.chain.clone()

    def restore(self, snap: tuple) -> None:
        self.desc.copy_(snap[0])
        self.chain.copy_(snap[1])

    # -- programs ----------------------------------------------------------
    def run_eager(self, greedy: bool, k: int) -> torch.Tensor:
        """The program body, run eagerly: returns its output [k, B]."""
        d = self.d
        for t in (d.positions, d.ctx_lens, d.steps):
            t.add_(d.advance)
        tokens = torch.where(d.use_chain != 0, self.chain, d.tokens)
        args = (self.params, self.cfg, self.kv, tokens, d.positions,
                d.tables, d.ctx_lens, k)
        lora = ({"lora_bank": self.lora_bank, "adapter_idx": d.lidx}
                if self.lora_bank is not None else {})
        if self.epilogue:
            uw = self.family.unembed_weight(self.params, self.cfg)
            if greedy:
                def fused(h, step):
                    return fused_sampling.fused_greedy_tokens(h, uw)
            else:
                def fused(h, step):
                    return fused_sampling.fused_sample_tokens(
                        h, uw, d.seeds, d.steps + step, d.temps, d.top_ks,
                        d.top_ps)
            burst, _ = self.family.decode_multi_hidden(
                *args, fused, valid=d.valid != 0, **lora)
        else:
            sample_fn: Optional[Callable] = None
            if not greedy:
                def sample_fn(logits, step):
                    return sample_tokens(logits, d.seeds, d.steps + step,
                                         d.temps, d.top_ks, d.top_ps)
            burst, _ = self.family.decode_multi(
                *args, sample_fn, valid=d.valid != 0, **lora)
        out = self.out.get(k)
        if out is None:
            out = self.out[k] = torch.zeros(k, self.B, dtype=torch.int32,
                                            device=self.device)
        out.copy_(burst)
        self.chain.copy_(burst[k - 1])
        return out

    def run(self, greedy: bool, k: int) -> Readback:
        """Dispatch program (greedy, k) on the current inputs and start
        its output's readback."""
        key = (greedy, k)
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            for fn, n in self._graph_launches[key]:
                fn.launches += n
            return Readback(self.out[k])
        t0 = time.perf_counter()
        out = self.run_eager(greedy, k)
        if key not in self.counts:
            if self.capture:
                self._capture(key)
            self._built(key, time.perf_counter() - t0)
        return Readback(out)

    def _capture(self, key: Tuple[bool, int]) -> None:
        from ..ops import cuda_paged_attention as k1

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        (self._graphs[key], self._graph_launches[key], self.capture_s[key],
         grown) = _capture(self.device, self._pool,
                           lambda: self.run_eager(*key),
                           (k1.paged_decode, k1.paged_decode_int8))
        self.pool_bytes += grown


def _capture(device: torch.device, pool, body: Callable[[], object],
             wrappers: tuple) -> tuple:
    """Capture `body` into a CUDA graph in `pool`.  Returns (the graph,
    [(wrapper, launches)] the body's kernel launches per replay, the
    seconds the capture took, the bytes the pool grew by).  A capture
    launches nothing, so the counts it added to `wrappers` are taken
    back."""
    before = [fn.launches for fn in wrappers]
    # what empty_cache cannot return afterwards is the pool's growth
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    # no cyclic collection inside a capture: it may destroy an unreachable
    # engine's CUDA graphs, and that invalidates the capture
    # (cudaErrorStreamCaptureInvalidated)
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        # thread_local: another engine of the process (a disagg pair on
        # one card) may launch work from its own scheduler thread meanwhile
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            body()
    finally:
        if gc_was_enabled:
            gc.enable()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    grown = torch.cuda.memory_reserved(device) - reserved
    launches = [(fn, fn.launches - b) for fn, b in zip(wrappers, before)]
    for fn, b in zip(wrappers, before):
        fn.launches = b  # the capture itself launched nothing
    return graph, launches, seconds, grown


# packed-prefill descriptor: fields of T words (the stream), then fields
# of `rows` words, then the tables (rows x max_blocks words)
PREFILL_STREAM = ("toks", "positions", "seg_ids", "valid")
PREFILL_ROWS = ("last_idx", "seeds", "temps", "top_ks", "top_ps")
# the verify descriptor: fields of T words, then the tables
VERIFY_STREAM = ("toks", "positions", "seg_ids", "valid", "temps_t")


class _BucketDesc:
    """Views of one bucket's descriptor buffer by field name."""

    def __init__(self, buf: torch.Tensor, T: int, rows: int,
                 max_blocks: int, stream: tuple, row_fields: tuple):
        off = 0
        for name, n in ([(f, T) for f in stream]
                        + [(f, rows) for f in row_fields]):
            view = buf[off:off + n]
            setattr(self, name, view.view(torch.float32)
                    if name in _FLOAT_FIELDS else view)
            off += n
        self.tables = buf[off:off + rows * max_blocks].view(rows, max_blocks)


class _BucketPrograms(_Built):
    """One program per stream length T of a packed planner's buckets,
    each reading views of its own int32 descriptor (STREAM fields of T
    words, ROWS fields of `rows` words, then the tables) and writing
    static outputs; captured at its first run on CUDA into the family's
    own graph pool, with K3's launches moved from the capture to each
    replay.  Subclasses give the fields, the outputs and the body."""

    KIND = ""
    STREAM: tuple = ()
    ROWS: tuple = ()

    def __init__(self, params, cfg, kv: tuple, rows: int,
                 max_blocks: int, buckets, device: torch.device,
                 capture: bool = True,
                 lora_bank: Optional[Dict[str, torch.Tensor]] = None):
        self.params, self.cfg, self.kv = params, cfg, kv
        self.family = get_family(cfg)
        self.rows, self.max_blocks, self.device = rows, max_blocks, device
        self.buckets = tuple(buckets)
        self.capture = capture and device.type == "cuda"
        # with a LoRA bank the stream gains `lidx` (each token's bank
        # slot) and the body reads the bank in place
        self.lora_bank = lora_bank
        self.stream = (self.STREAM + ("lidx",) if lora_bank is not None
                       else self.STREAM)
        self.desc: Dict[int, torch.Tensor] = {}
        self.d: Dict[int, _BucketDesc] = {}
        for T in self.buckets:
            self.desc[T] = torch.zeros(self._words(T), dtype=torch.int32,
                                       device=device)
            self.d[T] = _BucketDesc(self.desc[T], T, rows, max_blocks,
                                    self.stream, self.ROWS)
        self.counts: Dict[int, int] = {}
        self.costs: Dict[int, Dict[str, float]] = {}
        self.capture_s: Dict[int, float] = {}
        # the bytes the graph pool reserved, in all and by bucket
        self.pool_bytes = 0
        self.pool_grown: Dict[int, int] = {}
        self._graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self._graph_launches: Dict[int, list] = {}
        self._pool = None
        pin = device.type == "cuda"
        n = max(self._words(T) for T in self.buckets)
        self._staging = [torch.zeros(n, dtype=torch.int32, pin_memory=pin)
                         for _ in range(_STAGING)]
        self._staged = [None] * _STAGING
        self._next = 0
        self._init_outputs()

    def _cost_shape(self) -> dict:
        return {"rows": self.rows, "max_blocks": self.max_blocks,
                "lora": _lora_shape(self.lora_bank),
                **_cache_shape(self.kv)}

    def watch_family(self, key) -> str:
        return self.FAMILY

    def _words(self, T: int) -> int:
        return (len(self.stream) * T + len(self.ROWS) * self.rows
                + self.rows * self.max_blocks)

    # -- inputs ------------------------------------------------------------
    def host_descriptor(self, T: int) -> Dict[str, np.ndarray]:
        """Fresh host arrays of bucket T's descriptor with every token and
        row padding (top_p 1, everything else 0)."""
        rows = self.rows
        a = {name: np.zeros(T, bool if name == "valid" else np.float32
                            if name in _FLOAT_FIELDS else np.int32)
             for name in self.stream}
        a.update({name: np.zeros(rows, np.float32 if name in _FLOAT_FIELDS
                                  else np.int32) for name in self.ROWS})
        if "top_ps" in a:
            a["top_ps"][:] = 1.0
        a["tables"] = np.zeros((rows, self.max_blocks), np.int32)
        return a

    def pad(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A planner's arrays (S <= rows segment rows, tables up to
        max_blocks wide, stream length its bucket) padded to the bucket's
        descriptor."""
        T = len(arrays["toks"])
        a = self.host_descriptor(T)
        for name in self.stream:
            a[name][:] = arrays[name]
        tables = np.asarray(arrays["tables"])
        S = tables.shape[0]
        for name in self.ROWS:
            a[name][:S] = arrays[name]
        a["tables"][:S, :tables.shape[1]] = tables
        return a

    def upload(self, a: Dict[str, np.ndarray]) -> int:
        """Bucket T's descriptor from the host arrays `a` (T = the stream
        length): one copy from a pinned buffer.  Returns T."""
        T = len(a["toks"])
        if T not in self.desc:
            raise ValueError(f"no {self.KIND} program for a {T}-token "
                             f"stream; buckets {self.buckets}")
        i = self._next
        self._next = (i + 1) % _STAGING
        if self._staged[i] is not None:
            self._staged[i].synchronize()  # its last copy has run
        n = self._words(T)
        host = self._staging[i][:n].numpy()
        off = 0
        for name, width in ([(f, T) for f in self.stream]
                            + [(f, self.rows) for f in self.ROWS]):
            col = np.asarray(a[name])
            host[off:off + width] = (col.astype(np.float32).view(np.int32)
                                     if name in _FLOAT_FIELDS
                                     else col.astype(np.int32))
            off += width
        host[off:] = np.asarray(a["tables"], np.int32).reshape(-1)
        self.desc[T].copy_(self._staging[i][:n], non_blocking=True)
        if self.device.type == "cuda":
            self._staged[i] = torch.cuda.Event()
            self._staged[i].record()
        return T

    # -- programs ----------------------------------------------------------
    def _init_outputs(self) -> None:
        """Allocate every bucket's static outputs."""
        raise NotImplementedError

    def _outputs(self, T: int):
        raise NotImplementedError

    def run_eager(self, T: int):
        """The program body, run eagerly: returns its static outputs."""
        raise NotImplementedError

    def run(self, T: int):
        """Dispatch bucket T's program on its current descriptor; returns
        its static outputs (a later dispatch of the bucket overwrites
        them, in stream order)."""
        graph = self._graphs.get(T)
        if graph is not None:
            graph.replay()
            for fn, n in self._graph_launches[T]:
                fn.launches += n
            return self._outputs(T)
        t0 = time.perf_counter()
        out = self.run_eager(T)
        if T not in self.counts:
            if self.capture:
                self._capture(T)
            self._built(T, time.perf_counter() - t0)
        return out

    def _capture(self, T: int) -> None:
        from ..ops import cuda_packed_prefill as k3

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        (self._graphs[T], self._graph_launches[T], self.capture_s[T],
         grown) = _capture(self.device, self._pool,
                           lambda: self.run_eager(T),
                           (k3.packed_prefill, k3.packed_prefill_int8))
        self.pool_bytes += grown
        self.pool_grown[T] = grown


class PrefillPrograms(_BucketPrograms):
    """The packed-prefill program of each bucket: models/llama.py
    prefill_packed, then sample_tokens, into static [rows] tokens `tok[T]`
    and [rows, vocab] logits `logits[T]`."""

    KIND = "prefill"
    COST_FAMILY = "prefill"
    FAMILY = "prefill_packed"
    STREAM = PREFILL_STREAM
    ROWS = PREFILL_ROWS

    def _init_outputs(self) -> None:
        rows, dev = self.rows, self.device
        self.tok = {T: torch.zeros(rows, dtype=torch.int32, device=dev)
                    for T in self.buckets}
        self.logits = {T: torch.zeros(rows, self.cfg.vocab_size,
                                      dtype=torch.float32, device=dev)
                       for T in self.buckets}

    def _outputs(self, T: int) -> torch.Tensor:
        return self.tok[T]

    def run_eager(self, T: int) -> torch.Tensor:
        """The program body, run eagerly: returns its static tokens
        [rows] (its logits are in `logits[T]`)."""
        d = self.d[T]
        lora = ({"lora_bank": self.lora_bank, "adapter_idx": d.lidx}
                if self.lora_bank is not None else {})
        logits, _ = self.family.prefill_packed(
            self.params, self.cfg, self.kv, d.toks, d.positions, d.seg_ids,
            d.tables, d.last_idx, d.valid != 0, **lora)
        tok = sample_tokens(logits, d.seeds, torch.zeros_like(d.seeds),
                            d.temps, d.top_ks, d.top_ps)
        self.logits[T].copy_(logits)
        self.tok[T].copy_(tok)
        return self.tok[T]


class PaddedPrefillPrograms(_Built):
    """The padded prefill programs of capacity-dispatch MoE, the
    counterparts of the JAX engine's jitted `_prefill_impl` (one
    sequence's chunk padded to its bucket, models/llama.py `prefill`)
    and `_prefill_batched_impl` (Bp = pow2(n) rows of chunks padded to
    one bucket, `prefill_batched`), each followed by sample_tokens into
    [rows] tokens.  A packed stream would merge the sequences' expert
    capacity pools, so the engine routes these configs here, as JAX
    does.  They run eagerly (their lengths are read on the host); each
    (rows, T) shape records one build with its cost count, as a program
    family's first run does."""

    COST_FAMILY = "prefill_padded"

    def __init__(self, params, cfg, kv: tuple,
                 max_blocks: int, device: torch.device,
                 lora_bank: Optional[Dict[str, torch.Tensor]] = None):
        self.params, self.cfg, self.kv = params, cfg, kv
        self.family = get_family(cfg)
        self.max_blocks, self.device = max_blocks, device
        self.lora_bank = lora_bank
        self.counts: Dict[Tuple[int, int], int] = {}
        self.costs: Dict[Tuple[int, int], Dict[str, float]] = {}

    def _cost_shape(self) -> dict:
        # the row count is the key's
        return {"max_blocks": self.max_blocks,
                "lora": _lora_shape(self.lora_bank), **_cache_shape(self.kv)}

    def watch_family(self, key) -> str:
        return "prefill" if key[0] == 1 else "prefill_batched"

    @staticmethod
    def watch_tokens(key) -> int:
        return int(key[0] * key[1])

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device; on CUDA through pinned memory
        (the caching host allocator keeps it until the copy has run),
        so the dispatch never waits for the work queued before it."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def run(self, a: Dict[str, np.ndarray]) -> torch.Tensor:
        """One padded dispatch on the host arrays `a` (toks and positions
        [rows, T], tables [rows, max_blocks], and per row ctx_lens,
        true_lens, seeds, temps, top_ks, top_ps, with a LoRA bank lidx):
        rows 1 runs `prefill`, more `prefill_batched`.  Returns the
        sampled tokens [rows] (greedy rows take the argmax)."""
        rows, T = a["toks"].shape
        key = (rows, T)
        t0 = time.perf_counter()
        t = {k: self._upload(v) for k, v in a.items()
             if k not in ("ctx_lens", "true_lens")}
        if rows == 1:
            # the sequence's adapter slot on each of its tokens
            lora = ({"lora_bank": self.lora_bank,
                     "adapter_idx": t["lidx"].expand(T)}
                    if self.lora_bank is not None else {})
            logits, _ = self.family.prefill(
                self.params, self.cfg, self.kv, t["toks"][0],
                t["positions"][0], t["tables"][0], int(a["ctx_lens"][0]),
                int(a["true_lens"][0]), **lora)
            logits = logits[None]
        else:
            lora = ({"lora_bank": self.lora_bank, "adapter_idx": t["lidx"]}
                    if self.lora_bank is not None else {})
            logits, _ = self.family.prefill_batched(
                self.params, self.cfg, self.kv, t["toks"], t["positions"],
                t["tables"], a["ctx_lens"], a["true_lens"], **lora)
        tok = sample_tokens(logits, t["seeds"], torch.zeros_like(t["seeds"]),
                            t["temps"], t["top_ks"], t["top_ps"])
        if key not in self.counts:
            self._built(key, time.perf_counter() - t0)
        return tok


def spec_verify_window(logits: torch.Tensor, temps_t: torch.Tensor):
    """The JAX engine's `_spec_verify_impl` tail: per packed position the
    CAP largest temperature-scaled logits (ids [T, CAP] int32, values
    [T, CAP], ordered as `lax.top_k`: ties to the lower id) and the
    full-vocab logsumexp [T] of the scaled logits, the inputs of
    sampler.spec_accept_tokens."""
    scaled = logits / torch.clamp(temps_t, min=1e-6)[:, None]
    vals, ids = top_window(scaled)
    return ids.to(torch.int32), vals, torch.logsumexp(scaled, dim=-1)


class VerifyPrograms(_BucketPrograms):
    """The speculative verify program of each bucket: models/llama.py
    spec_verify_packed (K3 attends), then `spec_verify_window`, into
    static ids [T, CAP], vals [T, CAP] and lse [T]."""

    KIND = "verify"
    COST_FAMILY = "verify"
    FAMILY = "spec_verify"
    STREAM = VERIFY_STREAM

    def _init_outputs(self) -> None:
        dev = self.device
        self.out = {T: (torch.zeros(T, CAP, dtype=torch.int32, device=dev),
                        torch.zeros(T, CAP, dtype=torch.float32, device=dev),
                        torch.zeros(T, dtype=torch.float32, device=dev))
                    for T in self.buckets}

    def _outputs(self, T: int) -> tuple:
        return self.out[T]

    def run_eager(self, T: int) -> tuple:
        d = self.d[T]
        logits, _ = self.family.spec_verify_packed(
            self.params, self.cfg, self.kv, d.toks, d.positions, d.seg_ids,
            d.tables, d.valid != 0)
        for dst, src in zip(self.out[T], spec_verify_window(logits,
                                                            d.temps_t)):
            dst.copy_(src)
        return self.out[T]


# the draft catch-up descriptor: one segment's stream, then its table
CATCHUP_STREAM = ("toks", "positions", "seg_ids", "valid")


class CatchupPrograms(_BucketPrograms):
    """The draft model's catch-up prefill of each bucket, the counterpart
    of the JAX proposer's jitted `_prefill_impl` (dynamo_tpu/spec/
    draft.py): one segment (rows = 1) through models/llama.py
    prefill_packed_kv, so K3 attends to the draft's cached context from a
    descriptor that holds the chunk's positions and valid length on the
    device (no host read of a length, so the body is capturable).  It
    writes the draft's cache and has no output."""

    KIND = "catchup"
    COST_FAMILY = "catchup"
    FAMILY = "draft_prefill"
    STREAM = CATCHUP_STREAM

    def _init_outputs(self) -> None:
        pass

    def _outputs(self, T: int) -> None:
        return None

    def run_eager(self, T: int) -> None:
        d = self.d[T]
        self.family.prefill_packed_kv(self.params, self.cfg, self.kv,
                                      d.toks, d.positions, d.seg_ids,
                                      d.tables, d.valid != 0)


# the guided programs' descriptor: one decode step's lane fields
GUIDED_FIELDS = ("tokens", "positions", "ctx_lens", "valid")


class GuidedPrograms(_LaneDescriptor, _Built):
    """The guided-decoding candidate programs, the counterpart of the JAX
    engine's `_decode_topk_impl` (its `_topk_jit` and `_topk_wide_jit`):
    one decode step at B = max_num_seqs (models/llama.py decode; K1
    attends), then the M largest fp32 logits of every lane, ordered as
    `lax.top_k` (sampler.top_window: ties to the lower id), into static
    ids [B, M] int32 and vals [B, M] fp32.  One program per M in `ms`,
    all of one body that differs only in the window, so a widened retry
    rewrites the step's K/V with the same values.  The engine fills one
    valid lane a dispatch.  As in JAX, the step reads no LoRA bank.  On
    CUDA each program is captured at its first run (warmup_decode runs
    both) into its own graph pool, K1's launches moved to the replays;
    `counts[M]` gates the builds."""

    COST_FAMILY = "guided"

    def __init__(self, params, cfg, kv: tuple, B: int,
                 max_blocks: int, ms, device: torch.device,
                 capture: bool = True):
        self.params, self.cfg, self.kv = params, cfg, kv
        self.family = get_family(cfg)
        self.ms = tuple(ms)
        self.capture = capture and device.type == "cuda"
        self._init_descriptor(B, max_blocks, device, GUIDED_FIELDS)
        width = {m: min(m, cfg.vocab_size) for m in self.ms}
        self.ids = {m: torch.zeros(B, width[m], dtype=torch.int32,
                                   device=device) for m in self.ms}
        self.vals = {m: torch.zeros(B, width[m], dtype=torch.float32,
                                    device=device) for m in self.ms}
        self.counts: Dict[int, int] = {}
        self.costs: Dict[int, Dict[str, float]] = {}
        self.capture_s: Dict[int, float] = {}
        self.pool_bytes = 0
        self._graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self._graph_launches: Dict[int, list] = {}
        self._pool = None

    def _cost_shape(self) -> dict:
        return {"rows": self.B, "max_blocks": self.max_blocks,
                **_cache_shape(self.kv)}

    def watch_family(self, key) -> str:
        # the JAX engine's top-M programs: the window, then the widened
        return "decode_topk" if key == self.ms[0] else "decode_topk_wide"

    def run_eager(self, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The program body, run eagerly: returns its static (ids, vals)."""
        d = self.d
        logits, _ = self.family.decode(self.params, self.cfg, self.kv,
                                       d.tokens, d.positions, d.tables,
                                       d.ctx_lens, valid=d.valid != 0)
        vals, ids = top_window(logits.float(), m)
        self.ids[m].copy_(ids)
        self.vals[m].copy_(vals)
        return self.ids[m], self.vals[m]

    def run(self, m: int) -> Tuple[Readback, Readback]:
        """Dispatch program M on the current descriptor and start the
        readback of its (ids, vals)."""
        graph = self._graphs.get(m)
        if graph is not None:
            graph.replay()
            for fn, n in self._graph_launches[m]:
                fn.launches += n
            return Readback(self.ids[m]), Readback(self.vals[m])
        t0 = time.perf_counter()
        ids, vals = self.run_eager(m)
        if m not in self.counts:
            if self.capture:
                self._capture(m)
            self._built(m, time.perf_counter() - t0)
        return Readback(ids), Readback(vals)

    def _capture(self, m: int) -> None:
        from ..ops import cuda_paged_attention as k1

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        (self._graphs[m], self._graph_launches[m], self.capture_s[m],
         grown) = _capture(self.device, self._pool,
                           lambda: self.run_eager(m),
                           (k1.paged_decode, k1.paged_decode_int8))
        self.pool_bytes += grown

"""The mock engine: a vLLM-style continuous-batching scheduler, simulated,
a copy of dynamo_tpu/mocker/engine.py, with the same chaos seam
(`engine.step`, which crashes or wedges the scheduler on a rule).

No accelerator: token generation is deterministic pseudo-random, step
latency comes from a polynomial timing model, but the scheduling
behaviour is faithful: paged KV cache with prefix reuse, chunked
prefill, decode batching, capacity-based admission, preemption on OOM,
KV stored/removed events.  This is the test fixture the router,
frontend, global router and planner run against on the CPU, and it
needs no device: the same streams, KV events and FPM records as JAX's
mocker from the same arguments and seed.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import zlib
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional

from .. import chaos, obs
from ..protocols import (
    DRAIN_ABORT,
    DRAIN_REJECT,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..tokens import TokenBlockSequence, request_salt

logger = logging.getLogger(__name__)

# migratable markers (frontend/pipeline.py MIGRATABLE_MARKERS) carried by
# the simulated fault modes, so a mocker-injected death classifies exactly
# like a real one; the drain markers are shared with the JAX engine
# (protocols.DRAIN_REJECT / DRAIN_ABORT)
DEATH_ERROR = "connection lost (mocker: simulated worker death)"
FLAKY_ERROR = "connection lost (mocker: flaky stream drop)"


@dataclass
class MockEngineArgs:
    model_name: str = "mock-model"
    block_size: int = 64
    num_blocks: int = 4096
    max_num_seqs: int = 64
    max_batch_tokens: int = 8192  # chunked-prefill budget per step
    enable_prefix_caching: bool = True
    enable_chunked_prefill: bool = True
    vocab_size: int = 32000
    eos_token_id: int = 2
    # timing model (seconds): step = base + per_prefill_tok*p + per_decode_seq*d
    base_step_s: float = 0.002
    prefill_s_per_token: float = 0.00002
    decode_s_per_seq: float = 0.0002
    speedup_ratio: float = 1.0  # >1 runs faster than "real time"
    # overlapped scheduler sim (mirrors engine/config.py
    # overlap_scheduling): host scheduling hides behind the simulated
    # device step (the sleep shrinks by the host time spent since the
    # step began, and that work reports as `enqueue_ahead` instead of
    # `sched`), and decode-only stretches fuse adaptively up to
    # decode_fused_steps tokens per dispatch — one base_step_s per
    # BURST instead of per token, the same dispatch-amortization the
    # real engine's fused path buys.  De-fuses to the interleave burst
    # (min(4, decode_fused_steps) — the real _fused_k policy) the step
    # an arrival or prefill chunk appears.  Token streams are
    # byte-identical either way (position-addressed stream).
    overlap_scheduling: bool = True
    decode_fused_steps: int = 8
    # disagg role: "both" | "prefill" | "decode"
    role: str = "both"
    # emit exactly this text (as byte-token ids the frontend's mock
    # tokenizer decodes verbatim), then EOS — lets frontend tests drive
    # the output parsers (tool calls / reasoning) with structured text
    canned_text: str = ""
    # simulated data-parallel ranks: the worker runs dp_size independent
    # engines (disjoint KV caches) and exposes each as a routing target
    # (ref WorkerWithDpRank; per-rank publishers, vllm/main.py:379-425)
    dp_size: int = 1
    # simulated speculative decoding (mirrors engine/config.py spec_*):
    # {"k": int, "acceptance": float} — each decode step emits
    # 1 + (geometric draft-acceptance run, capped at k) tokens per
    # sequence and records spec_verify FPM entries, so planner/router
    # tests exercise the acceptance plumbing without a real model.
    # None disables.
    speculative: Optional[dict] = None
    # simulated KV quantization (mirrors engine/config.py
    # kv_cache_dtype): "int8" scales the simulated block pool to what
    # the same HBM budget holds at int8 bytes-per-block
    # (kv_cache_sim.kv_dtype_capacity_blocks, ~1.94x) and is advertised
    # in the MDC exactly like the JAX worker, so router/planner tier-1
    # tests cover the 2x-blocks regime without a device
    kv_cache_dtype: str = "bf16"
    # KV block-lifecycle ledger + auditor (obs/kv_ledger.py, mirrors
    # engine/config.py kv_ledger): None = follow DYN_KV_LEDGER
    # (always-on by default), True/False pins per engine — the
    # bench_serving --kv-ledger ab knob.  The mocker feeds the same
    # KvLedger (hash-keyed) so /debug/kv and the auditor are tier-1
    # testable CPU-only.
    kv_ledger: Optional[bool] = None
    # -- simulated KVBM tiers (fleet prefix cache) ------------------------
    # G2 host-LRU capacity in blocks (0 = no host tier): G1 evictions
    # demote here; G2 overflow spills into `object_store`
    host_blocks: int = 0
    # a SHARED kv_cache_sim.SimObjectStore standing in for the G4
    # shared-FS object store — pass ONE instance to every worker of a
    # simulated fleet so they see the same fleet prefix cache
    object_store: Optional[object] = None
    # onboard latency model: seconds charged per block served back into
    # G1 from each tier (added to the admitting step's simulated time,
    # and the source of the worker's advertised kv_tier_costs)
    g2_onboard_s_per_block: float = 0.0005
    g4_onboard_s_per_block: float = 0.002
    # KV-integrity parity (engine/config.py kv_io_deadline_s /
    # kv_breaker_*): simulated per-lookup G4 deadline charged when a
    # chaos "stall" fires, and the tier circuit breaker that prices a
    # failing G4 at recompute after `threshold` consecutive failures
    g4_deadline_s: float = 0.05
    kv_breaker_threshold: int = 3
    kv_breaker_cooldown_s: float = 5.0
    # -- simulated device-performance plane (obs satellites) --------------
    # the first dispatch of each program family emits a `compile` FPM
    # record of this duration — the exact record shape the JAX engine's
    # compile watchdog (obs/compile_watch.py) produces — so the
    # dynamo_engine_compile_seconds{family} histogram and the planner's
    # compile diag are tier-1 testable CPU-only.  First compiles are
    # marked serving=False (the warmup analogue); 0 disables.
    sim_compile_s: float = 0.002
    # additionally emit a MID-SERVING compile record every N scheduler
    # steps (serving=True) — drives the planner's recompile-storm diag
    # and the flight-recorder path in tests; 0 = off
    sim_recompile_every: int = 0
    # simulated accelerator peaks: when > 0, prefill/decode FPM records
    # carry xla_flops/xla_bytes (+ mfu) from the simulated cost model,
    # so the worker's roofline MFU/MBU gauges light up without a device
    peak_tflops: float = 0.0
    peak_hbm_gbps: float = 0.0
    # -- fault modes (chaos plane satellites) -----------------------------
    # die (error every stream with the migratable DEATH_ERROR marker,
    # reject everything after) once this many decode tokens have been
    # emitted engine-wide; 0 = off.  Simulates worker-kill-mid-decode
    # without a crash harness.
    fail_after_tokens: int = 0
    # stop stepping (alive-but-stuck: requests admit, streams go silent)
    # after this many scheduler steps; 0 = off.  The canary path and the
    # frontend's stream-idle rescue are what should save the requests.
    wedge_after: int = 0
    # per-decode-token probability of dropping that sequence's stream
    # with the migratable FLAKY_ERROR marker; 0.0 = off
    flaky: float = 0.0
    # seed for the fault-mode RNG (flaky draws) — reproducible chaos
    fault_seed: int = 0


@dataclass
class _Seq:
    request_id: str
    request: PreprocessedRequest
    blocks: TokenBlockSequence
    out_queue: asyncio.Queue
    num_prompt_tokens: int
    seed_val: int = 0  # position-addressed stream seed (see _next_token)
    prefill_pos: int = 0  # tokens prefetched so far (chunked prefill)
    generated: int = 0
    cached_blocks: int = 0
    # forensics parity with the JAX engine (engine/core.py _forensic):
    # queue position at enqueue + prefill chunk count, stamped back on
    # the first-token/finish frames so the whole plane — realized
    # overlap included, from the capacity sim's prefix matching — is
    # tier-1 testable CPU-only
    queue_pos: int = 0
    prefill_chunks: int = 0
    finished: bool = False
    disagg_prefill: bool = False   # prefill-only hop; return transfer params
    remote_prefilled: bool = False  # KV arrives via transfer; skip prefill
    rng: random.Random = field(default_factory=random.Random)
    guided_doc: Optional[str] = None  # lazily built canonical document


class MockEngine:
    """Continuous-batching scheduler over the simulated KV cache."""

    def __init__(self, args: MockEngineArgs,
                 kv_event_publisher=None):
        from .kv_cache_sim import KvCacheSim

        self.args = args
        from ..obs.kv_ledger import KvLedger, ledger_enabled

        self.kv_ledger = (KvLedger()
                          if ledger_enabled(args.kv_ledger) else None)
        # tier breaker (kvbm/breaker.py — the real manager's class, so
        # state names / thresholds can't drift between engines); only G4
        # is breakable in the sim (G2 is an in-process dict)
        if args.object_store is not None:
            from ..kvbm.breaker import TierBreaker

            self.kv_breaker = TierBreaker(
                ("g4",), threshold=args.kv_breaker_threshold,
                cooldown_s=args.kv_breaker_cooldown_s)
        else:
            self.kv_breaker = None
        # per-(tier, action) integrity failure counts — the mocker
        # analogue of TorchEngine.kv_integrity_counters()
        self.kv_integrity: Dict = {}
        self.cache = KvCacheSim(args.num_blocks, args.enable_prefix_caching,
                                kv_cache_dtype=args.kv_cache_dtype,
                                ledger=self.kv_ledger,
                                host_blocks=args.host_blocks,
                                object_store=args.object_store,
                                breaker=self.kv_breaker,
                                g4_deadline_s=args.g4_deadline_s,
                                on_corruption=self._note_kv_corruption)
        # onboard latency debt: seconds the NEXT step pays for blocks
        # admission served back into G1 from G2/G4 this step
        self._onboard_debt_s = 0.0
        self.publisher = kv_event_publisher
        self.waiting: List[_Seq] = []
        self.running: List[_Seq] = []
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        # graceful drain (worker.drain()): reject new work with the
        # migratable marker while in-flight requests finish or migrate
        self.draining = False
        # fail_after_tokens tripped: the simulated worker is dead
        self.dead = False
        # fault-mode RNG (flaky draws) — seeded, so chaos runs reproduce
        self._fault_rng = random.Random(args.fault_seed)
        # FPM-style counters
        self.metrics = {
            "steps": 0, "prefill_tokens": 0, "decode_tokens": 0,
            "preemptions": 0, "cache_hit_blocks": 0, "cache_lookup_blocks": 0,
            "requests": 0, "prompt_tokens": 0,
        }
        if args.speculative is not None:
            self.metrics["spec_proposed"] = 0
            self.metrics["spec_accepted"] = 0
        if args.host_blocks or args.object_store is not None:
            self.metrics["kv_onboard_g2"] = 0
            self.metrics["kv_onboard_g4"] = 0
        self.itl_ema_s = 0.0  # simulated inter-token latency (SLA planner)
        # forward-pass-metrics ring (the JAX engine's fpm analogue): the
        # worker drains it onto the event plane; with `speculative` set it
        # carries spec_verify acceptance records for FpmObserver
        from collections import deque

        self.fpm: deque = deque(maxlen=4096)
        # timeline tracing (obs/): the same span kinds the JAX engine
        # emits, from the simulated step loop — router/planner/chaos
        # tests exercise the whole timeline plane CPU-only.  One logical
        # track per engine (several mockers share one event loop).
        self._obs_track = f"sched:{id(self):x}"
        # simulated device-performance plane: which program families
        # have "compiled", and the per-phase dispatch-gap clocks for the
        # prefill/decode FPM records (the JAX engine's record shapes)
        self._compiled_families: set = set()
        self._fpm_last_prefill_t = 0.0
        self._fpm_last_decode_t = 0.0
        # overlapped-scheduler sim state: consecutive decode-only steps
        # (the adaptive-fusion ramp clock) and the previous decode
        # dispatch's (membership, k) — a matching pair is a continuation
        # burst (`cont` span attr, the real engine's zero-upload path)
        self._decode_run = 0
        self._last_decode_key = None

    # simulated cost model: nominal FLOPs / HBM bytes per token — the
    # values only need to be self-consistent (gauge math and record
    # plumbing are what tier-1 asserts, not a real chip's numbers)
    SIM_FLOPS_PER_TOKEN = 2e9
    SIM_BYTES_PER_TOKEN = 1e6

    def _sim_compile(self, family: str, tokens: int,
                     serving: bool = False) -> None:
        """Emit one compile FPM record (obs/compile_watch.py shape) the
        first time `family` dispatches — or an explicit mid-serving one
        (the recompile-storm sim)."""
        a = self.args
        if not a.sim_compile_s:
            return
        if family in self._compiled_families and not serving:
            return
        self._compiled_families.add(family)
        self.fpm.append({
            "t": time.monotonic(), "kind": "compile", "family": family,
            "seconds": a.sim_compile_s, "tokens": tokens,
            "serving": serving,
            "flops": tokens * self.SIM_FLOPS_PER_TOKEN,
            "bytes": tokens * self.SIM_BYTES_PER_TOKEN,
        })

    def _fpm_dispatch(self, kind: str, tokens: int, lanes: int,
                      queue_depth: int = 0, k: int = 1) -> None:
        """One prefill/decode FPM record per simulated dispatch — the
        same fields the JAX engine emits, so FpmWindow derivations,
        worker gauges, and planner diag run identically against the
        mocker."""
        now = time.monotonic()
        last = (self._fpm_last_prefill_t if kind == "prefill"
                else self._fpm_last_decode_t)
        gap = now - last if last else 0.0
        if gap > 1.0:
            gap = 0.0  # idle stretch, not dispatch latency
        flops = tokens * self.SIM_FLOPS_PER_TOKEN
        rec = {
            "t": now, "kind": kind, "gap_s": gap,
            "xla_flops": flops,
            "xla_bytes": tokens * self.SIM_BYTES_PER_TOKEN,
        }
        if kind == "prefill":
            rec.update(rows=lanes, tokens=tokens, bucket=tokens,
                       flops=flops, queue_depth=queue_depth, synced=True)
            if gap > 0.0 and self.args.peak_tflops > 0.0:
                rec["mfu"] = min(
                    flops / gap / (self.args.peak_tflops * 1e12), 1.0)
                rec["est_mfu"] = rec["mfu"]  # sim: one cost model
            self._fpm_last_prefill_t = now
        else:
            rec.update(k=k, lanes=lanes)
            self._fpm_last_decode_t = now
        self.fpm.append(rec)

    # -- public API -------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            self._task = None
        # terminate in-flight streams instead of leaving consumers hanging
        err = LLMEngineOutput(finish_reason="error")
        for seq in self.waiting + self.running:
            if not seq.finished:
                seq.finished = True
                seq.out_queue.put_nowait(err)
        self.waiting.clear()
        self.running.clear()

    @property
    def num_active_seqs(self) -> int:
        return len(self.running) + len(self.waiting)

    def kv_usage(self) -> float:
        return self.cache.used_blocks / max(1, self.cache.num_blocks)

    async def generate(
        self, request: PreprocessedRequest, token=None
    ) -> AsyncIterator[LLMEngineOutput]:
        """Enqueue a request and stream engine outputs (one token per item)."""
        self.start()
        if self.draining:
            # reject before admission: the router may still dispatch here
            # in the window between lease withdrawal and watch convergence
            yield LLMEngineOutput(finish_reason="error", error=DRAIN_REJECT)
            return
        if self.dead:
            yield LLMEngineOutput(finish_reason="error", error=DEATH_ERROR)
            return
        if self._task is not None and self._task.done():
            # scheduler loop died (chaos injection or a bug): fail fast
            # with the migratable marker instead of parking forever
            yield LLMEngineOutput(
                finish_reason="error",
                error="worker engine error: engine loop crashed")
            return
        self.metrics["requests"] += 1
        self.metrics["prompt_tokens"] += len(request.token_ids)
        # zlib.crc32, not hash(): the builtin is randomized per process
        # (PYTHONHASHSEED), and this seed must survive a cross-process
        # migration — worker B regenerating a seedless request's stream
        # has to agree with worker A about the suffix
        seed_val = (request.sampling.seed
                    if request.sampling.seed is not None
                    else zlib.crc32(request.request_id.encode())
                    & 0x7FFFFFFF)
        seq = _Seq(
            request_id=request.request_id,
            request=request,
            blocks=TokenBlockSequence(
                request.token_ids, self.args.block_size,
                salt=request_salt(request.lora_name,
                                  request.media_hashes),
            ),
            out_queue=asyncio.Queue(),
            num_prompt_tokens=len(request.token_ids),
            seed_val=seed_val,
            rng=random.Random(seed_val),
        )
        from ..protocols.llm import DISAGG_ANNOTATION

        seq.disagg_prefill = DISAGG_ANNOTATION in (request.annotations or [])
        dp = request.disaggregated_params
        seq.remote_prefilled = bool(dp) and dp.get("engine") == "mock"
        seq.queue_pos = len(self.waiting)
        self.waiting.append(seq)
        self._wake.set()
        from ..runtime.aio import CANCELLED, next_or_cancel

        try:
            while True:
                item = await next_or_cancel(
                    seq.out_queue,
                    token.stopped_event if token is not None else None,
                )
                if item is CANCELLED:
                    self._cancel_seq(seq)
                    yield LLMEngineOutput(finish_reason="cancelled")
                    return
                yield item
                if item.finish_reason is not None:
                    return
        finally:
            if not seq.finished:
                self._cancel_seq(seq)

    async def clear_kv_blocks(self) -> int:
        removed = self.cache.clear_cached()
        if self.publisher is not None and removed:
            await self.publisher.removed(removed)
        return len(removed)

    def _fail_all_streams(self, error: str) -> None:
        """Terminate every in-flight stream with a typed error."""
        err = LLMEngineOutput(finish_reason="error", error=error)
        stuck = self.waiting + self.running
        self.waiting = []
        self.running = []
        for seq in stuck:
            if not seq.finished:
                seq.finished = True
                res = self.cache.free(seq.request_id)
                self._publish(res)
                seq.out_queue.put_nowait(err)

    def drain_abort(self) -> None:
        """Graceful-drain deadline: error every in-flight stream with the
        migratable "worker draining" marker so the frontend replays each
        request on a surviving worker with no client-visible failure."""
        self.draining = True
        # flight recorder: same post-mortem tie-in as the JAX engine
        obs.flight_dump("drain_abort")
        self._fail_all_streams(DRAIN_ABORT)

    def _die(self) -> None:
        """fail_after_tokens tripped: simulate a worker death — every
        stream errors with the migratable connection-lost marker and the
        engine rejects everything from now on."""
        logger.warning("mock engine %s: simulated death after %d tokens",
                       self.args.model_name,
                       self.metrics["decode_tokens"])
        self.dead = True
        self._fail_all_streams(DEATH_ERROR)

    # -- internals --------------------------------------------------------
    def _cancel_seq(self, seq: _Seq) -> None:
        seq.finished = True
        if seq in self.waiting:
            self.waiting.remove(seq)
        if seq in self.running:
            self.running.remove(seq)
            res = self.cache.free(seq.request_id)
            self._publish(res)

    def _publish(self, res) -> None:
        if self.publisher is None or res is None:
            return
        # removed-before-stored within one mutation, serialized on the wire
        if res.stored or res.removed:
            self.publisher.enqueue_batch(stored=res.stored,
                                         removed=res.removed)
        # tier sim: demotion/onboard batches ride the same wire with
        # their tier tag (the engine's _emit_tier_events contract)
        for stored, removed, tier in getattr(res, "tier_events", ()):
            self.publisher.enqueue_batch(stored=stored, removed=removed,
                                         tier=tier)

    async def _loop(self) -> None:
        try:
            while not self._closed:
                if not self.running and not self.waiting:
                    if self.kv_ledger is not None \
                            and self.kv_ledger.audit_due(5.0):
                        # idle-tick reconciliation (the JAX engine's
                        # idle-branch cadence)
                        self.audit_kv(where="idle")
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                await self._step()
        except asyncio.CancelledError:
            pass
        except Exception:
            # mirror JaxEngine._loop: a crashed scheduler (chaos "fail"
            # injection or a bug) fails every stream with the migratable
            # worker-engine-error marker so the frontend replays them
            logger.exception("mock engine loop crashed")
            self._fail_all_streams(
                "worker engine error: engine loop failed or shut down")
            raise

    def _try_admit(self) -> None:
        while self.waiting and len(self.running) < self.args.max_num_seqs:
            seq = self.waiting[0]
            hashes = seq.blocks.block_hashes
            total = seq.blocks.num_blocks or 1
            self.metrics["cache_lookup_blocks"] += len(hashes)
            res = self.cache.allocate(seq.request_id, hashes, total)
            if res is None:
                break  # capacity; keep FIFO order
            self.metrics["cache_hit_blocks"] += res.cached_blocks
            seq.cached_blocks = res.cached_blocks
            if res.onboarded:
                per = {"g2": self.args.g2_onboard_s_per_block,
                       "g4": self.args.g4_onboard_s_per_block}
                for t, nblk in res.onboarded.items():
                    self.metrics[f"kv_onboard_{t}"] = \
                        self.metrics.get(f"kv_onboard_{t}", 0) + nblk
                    self._onboard_debt_s += nblk * per.get(t, 0.0)
            # prefix-cached tokens skip prefill compute
            seq.prefill_pos = min(
                res.cached_blocks * self.args.block_size, seq.num_prompt_tokens
            )
            if seq.remote_prefilled:
                # KV transferred from the prefill worker: no local compute
                seq.prefill_pos = seq.num_prompt_tokens
            self._publish(res)
            self.waiting.pop(0)
            self.running.append(seq)

    async def _step(self) -> None:
        if (self.args.wedge_after
                and self.metrics["steps"] >= self.args.wedge_after):
            # alive-but-stuck: the lease stays fresh, admitted streams go
            # silent — the canary (health_check.py) and the frontend's
            # stream-idle rescue are what must save the requests
            await asyncio.sleep(3600.0)
            return
        # chaos seam: crash ("fail") or wedge the scheduler on step N —
        # same seam name as TorchEngine._sched_step, so one chaos rule
        # drives either engine.  The key carries the worker id when one
        # is known so a rule can `match` a SINGLE worker of a fleet
        # (straggler injection: delay one worker's steps, leave its
        # siblings fast); substring matches on the model name keep
        # working.
        await chaos.ahit(
            "engine.step",
            key=(f"{self.args.model_name}:{self.publisher.worker_id}"
                 if self.publisher is not None else self.args.model_name))
        # timeline spans: same kinds (and zero-cost-off None check) as
        # JaxEngine._sched_step, so obs.report decomposes a mocker run
        # with the same phase taxonomy.  Overlap sim: mid decode-only
        # stretch the "device" (the previous burst's sleep) was still
        # running while this host work happens, so it reports as
        # enqueue_ahead — and the sleep below shrinks by the host time,
        # modeling host scheduling hidden behind device execution.
        host_t0 = time.monotonic()
        overlapped = self.args.overlap_scheduling and self._decode_run > 0
        t_step = obs.begin()
        t_obs = obs.begin()
        self._try_admit()
        obs.end("enqueue_ahead" if overlapped else "sched", t_obs,
                track=self._obs_track)
        if not self.running:
            await asyncio.sleep(0)  # let admissions catch up
            return

        budget = self.args.max_batch_tokens
        prefill_tokens = 0
        prefill_rows = 0
        decode_seqs: List[_Seq] = []

        t_obs = obs.begin()
        for seq in list(self.running):
            remaining_prefill = seq.num_prompt_tokens - seq.prefill_pos
            if remaining_prefill > 0:
                chunk = (
                    min(remaining_prefill, budget)
                    if self.args.enable_chunked_prefill
                    else remaining_prefill
                )
                if chunk <= 0:
                    continue
                seq.prefill_pos += chunk
                seq.prefill_chunks += 1
                prefill_tokens += chunk
                prefill_rows += 1
                budget -= chunk
            else:
                decode_seqs.append(seq)
        if prefill_tokens:
            obs.end("prefill_dispatch", t_obs, track=self._obs_track,
                    tokens=prefill_tokens)
            self._sim_compile("prefill", prefill_tokens)
            self._fpm_dispatch(
                "prefill", prefill_tokens, lanes=prefill_rows,
                queue_depth=len(self.waiting) + sum(
                    1 for s in self.running
                    if s.prefill_pos < s.num_prompt_tokens))

        # adaptive decode fusion (overlap sim, the real _fused_k policy):
        # pending arrivals / prefill chunks de-fuse to the interleave
        # burst within one step (the TTFT bound); a decode-only stretch
        # ramps interleave -> 2x -> ... -> decode_fused_steps
        k = 1
        if (self.args.overlap_scheduling and decode_seqs
                and self.args.decode_fused_steps > 1
                # disagg prefill hops emit transfer params once and
                # finish — fusing would hold that TTFT-critical emission
                # behind a k-long burst for nothing
                and not any(s.disagg_prefill for s in decode_seqs)):
            ib = min(4, self.args.decode_fused_steps)
            if prefill_tokens or self.waiting:
                self._decode_run = 0
                k = ib
            else:
                k = min(ib << min(self._decode_run, 10),
                        self.args.decode_fused_steps)
                self._decode_run += 1
        else:
            self._decode_run = 0

        # simulated step latency: one base dispatch cost per BURST (the
        # fused path's amortization), per-token costs unchanged
        # onboard debt: blocks served back into G1 from G2/G4 by this
        # step's admissions pay their tier's transfer latency here —
        # cheaper than the prefill recompute they displaced, which is
        # exactly the gap the cold-start bench measures
        onboard_s, self._onboard_debt_s = self._onboard_debt_s, 0.0
        # deadline-bounded G4 I/O: stalled lookups charged their
        # deadline by the capacity sim (no real sleep) pay it here as
        # simulated step time — the mocker analogue of the real
        # engine's bounded ObjectIO waits
        onboard_s += self.cache.io_penalty_s
        self.cache.io_penalty_s = 0.0
        step_s = (
            self.args.base_step_s
            + prefill_tokens * self.args.prefill_s_per_token
            + k * len(decode_seqs) * self.args.decode_s_per_seq
            + onboard_s
        ) / max(self.args.speedup_ratio, 1e-6)
        if self.args.overlap_scheduling:
            # host scheduling hides behind the device: the sleep only
            # covers what the host work since step start didn't already
            step_s_sleep = max(0.0, step_s - (time.monotonic() - host_t0))
        else:
            step_s_sleep = step_s
        # the sleep IS the simulated device step: device_wait by kind
        t_obs = obs.begin()
        await asyncio.sleep(step_s_sleep)
        obs.end("device_wait", t_obs, track=self._obs_track,
                what="sim_step")

        self.metrics["steps"] += 1
        self.metrics["prefill_tokens"] += prefill_tokens
        if decode_seqs:
            # each decoding seq saw k tokens this step: per-token ITL
            itl = step_s / k
            self.itl_ema_s = itl if self.itl_ema_s == 0.0 \
                else 0.9 * self.itl_ema_s + 0.1 * itl

        t_obs = obs.begin()
        for seq in decode_seqs:
            if seq.finished or seq not in self.running:
                # finished while this step slept: drain_abort()/_die()/
                # cancellation ran at the await point and already freed
                # the seq — touching its cache entry now would KeyError
                continue
            if seq.disagg_prefill:
                # prefill-only hop: emit first token + transfer metadata and
                # finish (mock transfer is instantaneous; no parking)
                tok = self._next_token(seq)
                seq.out_queue.put_nowait(LLMEngineOutput(
                    token_ids=[tok], finish_reason="stop",
                    kv_transfer_params={
                        "engine": "mock",
                        "first_token": tok,
                        "prompt_len": seq.num_prompt_tokens,
                    },
                    metrics={"forensic": self._forensic(seq)},
                ))
                seq.finished = True
                self.running.remove(seq)
                self._publish(self.cache.free(seq.request_id))
                continue
            # k fused decode rounds for this seq (adaptive fusion sim);
            # each round: 1 base token + a simulated speculative draft
            # acceptance run (Bernoulli chain truncated at the first
            # rejection — the same longest-accepted-prefix shape the
            # real verify step produces)
            for _round in range(k):
                if seq.finished or seq not in self.running:
                    break
                emit = 1
                spec = self.args.speculative
                if spec is not None:
                    sk = max(1, int(spec.get("k", 4)))
                    acc = float(spec.get("acceptance", 0.5))
                    a = 0
                    while a < sk and seq.rng.random() < acc:
                        a += 1
                    self.metrics["spec_proposed"] += sk
                    self.metrics["spec_accepted"] += a
                    self.fpm.append({
                        "t": time.monotonic(), "kind": "spec_verify",
                        "lanes": 1, "proposed": sk, "accepted": a,
                    })
                    emit = 1 + a
                for _ in range(emit):
                    if (self.args.fail_after_tokens
                            and self.metrics["decode_tokens"]
                            >= self.args.fail_after_tokens):
                        self._die()
                        return
                    if (self.args.flaky
                            and self._fault_rng.random() < self.args.flaky):
                        # drop just this sequence's stream mid-decode
                        # with a migratable marker; the engine itself
                        # stays healthy
                        seq.finished = True
                        self.running.remove(seq)
                        self._publish(self.cache.free(seq.request_id))
                        seq.out_queue.put_nowait(LLMEngineOutput(
                            finish_reason="error", error=FLAKY_ERROR))
                        break
                    tok = self._next_token(seq)
                    completed = seq.blocks.append(tok)
                    partial = seq.blocks.partial_len()
                    res = self.cache.grow(
                        seq.request_id, completed,
                        need_new_block=(partial == 1)
                    )
                    if res is None:
                        # OOM: preempt back to waiting, replay later
                        self.metrics["preemptions"] += 1
                        self.running.remove(seq)
                        free_res = self.cache.free(seq.request_id)
                        self._publish(free_res)
                        seq.prefill_pos = 0
                        self.waiting.insert(0, seq)
                        break
                    self._publish(res)
                    seq.generated += 1
                    self.metrics["decode_tokens"] += 1

                    finish = self._finish_reason(seq, tok)
                    # forensic stamp on first-token + finish frames —
                    # the JAX engine's exact contract
                    # (engine/core.py _push_token)
                    if finish:
                        step_metrics = {
                            "kv_usage": self.kv_usage(),
                            "active_seqs": len(self.running),
                            "forensic": self._forensic(seq),
                        }
                    elif seq.generated == 1:
                        step_metrics = {"forensic": self._forensic(seq)}
                    else:
                        step_metrics = None
                    out = LLMEngineOutput(
                        token_ids=[tok],
                        finish_reason=finish,
                        metrics=step_metrics,
                    )
                    seq.out_queue.put_nowait(out)
                    if finish is not None:
                        seq.finished = True
                        self.running.remove(seq)
                        res = self.cache.free(seq.request_id)
                        self._publish(res)
                        break
        if decode_seqs:
            # continuation-burst accounting (the real engine's `cont`
            # attr / _is_continuation): same lane membership, same k —
            # the dispatch the device-resident descriptor path uploads
            # nothing for.  A prefill chunk co-scheduled for a DIFFERENT
            # slot does not break a continuation (the decode descriptor
            # is unchanged), exactly like the real check.
            key = (frozenset(s.request_id for s in decode_seqs), k)
            cont = self._last_decode_key == key
            self._last_decode_key = key
            obs.end("decode_dispatch", t_obs, track=self._obs_track,
                    cont=cont, k=k, lanes=len(decode_seqs))
            self._sim_compile("decode", k * len(decode_seqs))
            self._fpm_dispatch("decode", k * len(decode_seqs),
                               lanes=len(decode_seqs), k=k)
        if (self.args.sim_recompile_every
                and self.metrics["steps"] % self.args.sim_recompile_every
                == 0):
            # simulated recompile storm: a mid-serving compile record
            # (serving=True — the planner's storm diag input)
            self._sim_compile("decode", len(decode_seqs) or 1,
                              serving=True)
        led = self.kv_ledger
        if led is not None and led.audit_due():
            # same finish/idle audit cadence as JaxEngine._sched_step
            self.audit_kv(where="step")
        obs.end("step", t_step, track=self._obs_track,
                active=len(self.running), waiting=len(self.waiting))

    def _note_kv_corruption(self, tier: str, h: int) -> None:
        """Attribute a quarantined block (TorchEngine._note_kv_corruption
        parity).  The capacity sim already recorded the ledger violation
        + quarantine op; this keeps the engine-level counter the worker
        exports as dynamo_kv_integrity_failures_total."""
        key = (tier, "quarantine")
        self.kv_integrity[key] = self.kv_integrity.get(key, 0) + 1

    def kv_integrity_counters(self) -> dict:
        """(tier, action) -> count, merging the sim's G4 I/O failures —
        the same row shape TorchEngine.kv_integrity_counters() returns."""
        out = dict(self.kv_integrity)
        for action, n in self.cache.io_failures.items():
            if n:
                out[("g4", action)] = out.get(("g4", action), 0) + n
        return out

    def tier_states(self) -> dict:
        """tier -> breaker state (TieredKvManager.tier_states parity)."""
        if self.kv_breaker is None:
            return {}
        return self.kv_breaker.states()

    def audit_kv(self, where: str = "on_demand") -> dict:
        """Reconcile the ledger's books against the capacity sim — the
        JAX engine's audit contract, loop-thread synchronous (the sim
        has no scheduler thread)."""
        led = self.kv_ledger
        if led is None:
            return {}
        live = [s.request_id for s in self.running] \
            + [s.request_id for s in self.waiting]
        return led.finish_audit(led.audit_sim(self.cache, live),
                                where=where)

    def _forensic(self, seq: _Seq) -> dict:
        """Worker-side forensic stamp (the JAX engine's _forensic
        contract): realized prefix reuse comes from the capacity sim's
        prefix matching, so predicted-vs-realized routing tests run
        CPU-only."""
        return {
            "cached_tokens": seq.cached_blocks * self.args.block_size,
            "queue_pos": seq.queue_pos,
            "prefill_chunks": seq.prefill_chunks,
            "generated": seq.generated,
        }

    def _next_token(self, seq: _Seq) -> int:
        canned = self.args.canned_text
        if seq.request.sampling.guided_json is not None:
            # simulated guided decoding: emit the schema's canonical
            # document (the real engine's constrained path is
            # engine/core.py _guided_step; the sim keeps frontend /
            # router tests GPU-free, like everything else here)
            if seq.guided_doc is None:
                from ..guided import JsonSchemaGuide

                seq.guided_doc = JsonSchemaGuide(
                    seq.request.sampling.guided_json).complete("")
            canned = seq.guided_doc
        if canned:
            data = canned.encode()
            if seq.generated < len(data):
                return 3 + data[seq.generated]  # MockTokenizer BYTE_BASE
            return self.args.eos_token_id
        # Position-addressed deterministic stream: the token at absolute
        # context position n is a pure function of (seed, n) — the mock
        # analogue of greedy decoding being a pure function of context.
        # This is what makes token-replay migration exact here: a
        # replayed request (prompt + already-emitted tokens) continues at
        # the same absolute position and regenerates the identical
        # suffix, so the chaos suite can assert token-identity between a
        # faulted run and the fault-free one.
        pos = seq.num_prompt_tokens + seq.generated
        r = random.Random((seq.seed_val << 20) ^ pos)
        if not seq.request.stop.ignore_eos and r.random() < 0.005:
            return self.args.eos_token_id
        return r.randrange(3, self.args.vocab_size)

    def _finish_reason(self, seq: _Seq, tok: int) -> Optional[str]:
        st = seq.request.stop
        if not st.ignore_eos and tok == self.args.eos_token_id:
            return "stop"
        if tok in (st.stop_token_ids or []):
            return "stop"
        if seq.generated >= st.max_tokens:
            return "length"
        total = seq.num_prompt_tokens + seq.generated
        # context window guard
        return None if total < 10**9 else "length"

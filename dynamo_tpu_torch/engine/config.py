"""Engine configuration.

The counterpart of dynamo_tpu/engine/config.py, keeping the JAX field
names and defaults of everything this slice of the port serves.  Fields
of JAX-engine features the port does not have yet are kept with their
JAX defaults so a shared launcher config reads the same, and setting one
to anything else raises: a silently ignored knob would let a deployment
believe it runs a feature it does not (ROADMAP.md lists what is left).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from ..disagg.transfer import DEFAULT_CHUNK_BYTES
from ..models import PRESETS, DeepseekConfig, LlamaConfig, get_family
from ..ops.packed_prefill import PACKED_IMPLS
from ..ops.paged_attention import DECODE_IMPLS

# the disaggregation roles (the JAX CLI's --role choices)
ROLES = ("both", "prefill", "decode")
# speculative decoding's proposers (the JAX CLI's --spec-decode choices)
SPEC_MODES = ("off", "ngram", "draft")

# field -> (default, the feature it belongs to)
_UNPORTED = {
    "dp": (1, "data parallelism"),
    "tp": (1, "tensor parallelism"),
    "sp": (1, "sequence-parallel ring prefill"),
}


@dataclass
class EngineConfig:
    model: str = "tiny"  # preset name (models.PRESETS, every family)
    # a local HF checkpoint directory (config.json + *.safetensors,
    # models/loader.py); overrides `model`, the engine loads its weights
    model_path: str = ""
    model_name: str = ""  # served model name; defaults to the model's
    model_config: Optional[Union[LlamaConfig, DeepseekConfig]] = None

    # paged KV cache (block 0 is the garbage block)
    block_size: int = 128         # tokens per block == PLH hashing block size
    num_blocks: int = 128         # physical blocks
    max_blocks_per_seq: int = 64  # max context = block_size * this
    enable_prefix_caching: bool = True
    # "bf16" (the model's dtype) | "int8" (quant/kv.py: int8 codes plus
    # fp32 scale planes, ~1.94x the blocks per byte at head_dim 128)
    kv_cache_dtype: str = "bf16"
    # > 0: size the block pool from this budget in GB (1e9 bytes) of
    # cache; the engine overwrites num_blocks with what it holds
    kv_hbm_gb: float = 0.0

    # batching
    max_num_seqs: int = 8
    # the smallest entry floors the per-step prefill budget and the packed
    # stream's padded length, as in the JAX engine
    prefill_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048)
    # decode burst: this many decode steps fused into ONE program
    # (models/llama.py decode_multi, captured as a CUDA graph by
    # engine/graphs.py) when no prefill/admission work is pending; 1
    # disables fusion
    decode_fused_steps: int = 8
    # decode output pipelining: up to depth-1 dispatched bursts stay
    # UNREAD while the next one runs, their sampled ids chained on the
    # device; emission and stop detection lag by up to
    # (depth-1) * decode_fused_steps tokens (the overshoot is discarded,
    # like a mid-burst finish).  Only effective with overlap_scheduling
    decode_pipeline_depth: int = 4
    # overlapped scheduler: decode bursts pipeline to
    # decode_pipeline_depth and a completing prefill's first-token
    # readback is deferred one step.  False = lockstep reference mode
    # (schedule, dispatch, block on the device, emit), greedy
    # byte-identical to the overlapped mode by construction
    overlap_scheduling: bool = True
    # adaptive decode fusion: in a decode-only stretch the burst size
    # ramps INTERLEAVE_BURST -> 2x -> ... -> decode_fused_steps (one
    # program per ladder rung, all built by warmup_decode) and de-fuses
    # to the interleave burst when an arrival, cancellation or pending
    # prefill chunk appears.  False = full decode_fused_steps whenever no
    # prefill/admission work is pending
    decode_fuse_adaptive: bool = True
    # SLA-aware admission: when the frontends' published error-budget
    # burn rate (the worst window, fed by the worker's slo_metrics
    # subscription into TorchEngine.set_slo_burn) exceeds this threshold
    # while decodes are active, the step's prefill chunk budget is scaled
    # by threshold/burn (floored at the smallest prefill bucket): prefill
    # yields to decode until ITL recovers.  0 disables.
    slo_yield_burn: float = 1.0
    # a burn signal older than this is ignored (a frontend gone or the
    # SLO plane off must not throttle prefill forever)
    slo_burn_stale_s: float = 10.0
    # per-step token budget: one packed prefill dispatch is capped to
    # max_batch_tokens minus one token per decoding slot
    max_batch_tokens: int = 2048
    # prefilling sequences packed into one dispatch
    max_prefill_seqs: int = 4
    # chunk budget for one packed prefill dispatch (0 = max_batch_tokens)
    prefill_chunk_tokens: int = 0
    # "off" | "fused": the decode programs end each step at the final-norm
    # hidden state and stream the projection in vocab tiles into the
    # sampler's statistics, so no [B, vocab] logits exist
    # (ops/fused_sampling.py); "off" materializes the logits
    sampling_epilogue: str = "off"
    # attention impl overrides ("" = keep the model config's): decode
    # "auto" | "torch" (ops/paged_attention.py), packed prefill "auto" |
    # "torch" (ops/packed_prefill.py)
    attn_impl: str = ""
    packed_attn_impl: str = ""

    # accelerator peak (dense bf16) TFLOP/s, for prefill-phase MFU in the
    # FPM records; 0 = unknown, MFU omitted
    peak_tflops: float = 0.0
    # accelerator peak HBM bandwidth in GB/s, for the /metrics roofline
    # MBU gauges (planner/metrics.py export_engine_gauges; H100 SXM HBM3:
    # 3350); 0 = unknown, MBU gauges omitted
    peak_hbm_gbps: float = 0.0
    # run TorchEngine.warmup_decode before the worker registers (the CLI
    # worker's default; off here so short-lived test engines skip it)
    warmup: bool = False

    # KVBM tiers (kvbm/): 0 disables the G2 host cache.  When enabled, the
    # scheduler offloads the coldest evictable device blocks to host
    # memory once free blocks fall below offload_watermark_blocks (one
    # batched device-to-host gather per step, pinned copies that the
    # scheduler never waits on), and onboards G2/G3/G4 prefix hits at
    # admission instead of recomputing prefill.
    host_cache_blocks: int = 0
    disk_cache_dir: Optional[str] = None   # G3; needs disk_cache_blocks > 0
    disk_cache_blocks: int = 0
    # G4 cluster-shared object store (kvbm/object_store.py): demotions
    # that would otherwise drop spill here; any worker onboards them
    object_store_dir: Optional[str] = None
    object_store_ttl_s: Optional[float] = None
    # cross-worker G2 pull (kvbm/remote.py): prefetch missing prefix
    # blocks from a peer's host tiers at admission time
    kvbm_remote: bool = True
    kvbm_remote_max_blocks: int = 64
    offload_watermark_blocks: int = 0      # 0 = num_blocks // 4
    offload_batch: int = 16                # max blocks gathered per step
    # KV integrity and degraded modes (kvbm/object_io.py,
    # kvbm/breaker.py): every G4 op of the serving path is awaited at
    # most kv_io_deadline_s on a dedicated I/O thread;
    # kv_breaker_threshold consecutive failures of a tier trip its
    # circuit breaker open until a half-open probe succeeds after
    # kv_breaker_cooldown_s
    kv_io_deadline_s: float = 0.25
    kv_breaker_threshold: int = 3
    kv_breaker_cooldown_s: float = 30.0

    # disaggregation role: "both" serves agg traffic; "prefill" workers run
    # prefill-only hops and park KV; "decode" workers pull and decode
    role: str = "both"
    # disagg KV transfer: bound on one wire frame's K+V payload bytes
    # (disagg/transfer.py chunk sizing)
    transfer_chunk_bytes: int = DEFAULT_CHUNK_BYTES

    # speculative decoding (spec/): "ngram" is the zero-weight
    # prompt-lookup proposer, "draft" a second model on the same device
    # (greedy k-step drafts through the decode programs at B = 1).  The
    # verify program scores every speculating sequence's drafts in ONE
    # packed dispatch (models/llama.py spec_verify_packed over K3, one
    # CUDA graph per stream bucket) and rejection sampling keeps the
    # decode sampler's distribution: greedy output is token-identical to
    # plain decode.  "off" disables.
    spec_decode: str = "off"
    # max draft tokens per round; the per-sequence draft length adapts
    # below it through an acceptance-rate EMA, down to 0 (plain pipelined
    # decode), with a probe every spec_probe_interval generated tokens
    spec_k: int = 4
    # n-gram proposer: suffix lengths tried, longest first
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # draft model, first match wins: explicit config object (tests) > HF
    # checkpoint dir > preset name.  Vocab must equal the target's.
    spec_draft_config: Optional[LlamaConfig] = None
    spec_draft_model_path: str = ""
    spec_draft_model: str = ""
    # acceptance EMA below this collapses the sequence to plain decode
    spec_accept_min: float = 0.15
    # max probe distance (generated tokens) for collapsed or missing
    # slots: failed probes back off exponentially from 8 up to this cap
    spec_probe_interval: int = 64

    # LoRA serving (lora/): 0 disables.  lora_max_adapters counts the
    # usable bank slots (slot 0 is the no-adapter slot); adapters load
    # from lora_dir (a PEFT directory tree) on their first request into
    # the stacked bank every captured decode and prefill program reads,
    # and the least recently used slot no sequence references is evicted
    # when the bank is full.  Ranks are zero-padded to lora_rank; larger
    # ranks are rejected.
    lora_max_adapters: int = 0
    lora_rank: int = 16
    lora_dir: Optional[str] = None

    # None = the model config's eos ids (the checkpoint's config.json with
    # model_path)
    eos_token_id: Optional[int] = None
    seed: int = 0

    # JAX-engine features not ported yet (see _UNPORTED)
    dp: int = 1
    tp: int = 1
    sp: int = 1

    def __post_init__(self):
        for name, (default, feature) in _UNPORTED.items():
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={value!r}: {feature} is not ported "
                    f"to dynamo_tpu_torch yet (default {default!r})")
        # imported here: ops/fused_sampling.py imports the engine package
        from ..ops.fused_sampling import EPILOGUE_MODES

        if self.sampling_epilogue not in EPILOGUE_MODES:
            raise ValueError(
                f"sampling_epilogue must be {' | '.join(EPILOGUE_MODES)}, "
                f"got {self.sampling_epilogue!r}")
        if self.role not in ROLES:
            raise ValueError(f"role must be {' | '.join(ROLES)}, got "
                             f"{self.role!r}")
        if self.spec_decode not in SPEC_MODES:
            raise ValueError(f"spec_decode must be "
                             f"{' | '.join(repr(m) for m in SPEC_MODES)}, "
                             f"got {self.spec_decode!r}")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bf16' | 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.attn_impl and self.attn_impl not in DECODE_IMPLS:
            raise ValueError(f"attn_impl must be one of "
                             f"{' | '.join(DECODE_IMPLS)}, got "
                             f"{self.attn_impl!r}")
        if self.packed_attn_impl and \
                self.packed_attn_impl not in PACKED_IMPLS:
            raise ValueError(f"packed_attn_impl must be one of "
                             f"{' | '.join(PACKED_IMPLS)}, got "
                             f"{self.packed_attn_impl!r}")

    def resolve_model(self) -> Union[LlamaConfig, DeepseekConfig]:
        """The model config (model_config, else the checkpoint's at
        model_path, else the preset) with the engine's attention-impl
        overrides, each applied only where the family has the knob, as
        the JAX engine does: an attn_impl outside the family's
        SUPPORTED_ATTN_IMPLS (MLA: the plain one alone) and a
        packed_attn_impl on a family with no packed prefill raise
        JAX's ValueErrors rather than be ignored."""
        if self.model_config is not None:
            cfg = self.model_config
        elif self.model_path:
            from .loader_cache import cached_hf_config

            cfg = cached_hf_config(self.model_path)
        elif self.model in PRESETS:
            cfg = PRESETS[self.model]
        else:
            raise ValueError(f"unknown model preset {self.model!r}; have "
                             f"{sorted(PRESETS)}")
        over = {}
        if self.attn_impl:
            supported = getattr(get_family(cfg), "SUPPORTED_ATTN_IMPLS",
                                DECODE_IMPLS)
            if self.attn_impl not in supported:
                raise ValueError(
                    f"attn_impl for model family {type(cfg).__name__} must "
                    f"be one of {' | '.join(supported)}, got "
                    f"{self.attn_impl!r}")
            over["attn_impl"] = self.attn_impl
        if self.packed_attn_impl:
            if "packed_attn_impl" not in {
                    f.name for f in dataclasses.fields(cfg)}:
                raise ValueError(
                    f"model family {type(cfg).__name__} has no "
                    f"packed_attn_impl knob (MLA has no packed prefill "
                    f"path)")
            over["packed_attn_impl"] = self.packed_attn_impl
        return dataclasses.replace(cfg, **over) if over else cfg

    @property
    def served_name(self) -> str:
        return self.model_name or self.resolve_model().name

    @property
    def max_context(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    @property
    def chunk_budget(self) -> int:
        """Effective per-step prefill token budget."""
        return self.prefill_chunk_tokens or self.max_batch_tokens

    def resolve_eos_ids(self) -> Tuple[int, ...]:
        if self.eos_token_id is not None:
            return (self.eos_token_id,)
        return self.resolve_model().eos_token_ids

"""Speculative decoding: proposers and packed verification.

The counterpart of dynamo_tpu/spec/.  A proposer drafts k continuation
tokens, the target scores all of them in one packed pass, and rejection
sampling accepts the longest prefix that preserves the target
distribution exactly (greedy: exact argmax-prefix match, so the served
stream is token-identical to plain decode).

  * ngram.py  - NgramProposer: zero-weight prompt lookup over the
    sequence's own history (a copy of the JAX module, numpy only).
  * draft.py  - DraftModelProposer: a second model with its own KV cache
    addressed by the target's block tables; greedy k-step drafts through
    the engine's decode programs at B = 1.
  * verify.py - the packing planner: speculating slots' rows
    [last_token, d1..dk] in ONE padding-free stream with segment ids,
    scored by the engine's verify programs (engine/graphs.py
    VerifyPrograms: models/llama.py spec_verify_packed over K3).

Rejection sampling lives in engine/sampler.py (spec_accept_tokens); the
engine (engine/core.py _spec_step) owns the adaptive draft length and the
KV rollback (block_allocator.trim_blocks).
"""

from .draft import DraftModelProposer
from .ngram import NgramProposer
from .verify import SpecPlan, plan_spec_verify


def make_proposer(config, device, params=None, capture: bool = True):
    """Build the proposer an EngineConfig asks for (engine/core.py).

    `config.spec_decode`: "ngram" (zero-weight prompt lookup) or "draft"
    (a second model on `device`, resolved from spec_draft_config >
    spec_draft_model_path > spec_draft_model preset, vocab-checked
    against the target).  `params`: the draft's weights (None: loaded or
    random, DraftModelProposer); `capture`: whether its propose programs
    are captured as CUDA graphs."""
    if config.spec_decode == "ngram":
        return NgramProposer(max_ngram=config.spec_ngram_max,
                             min_ngram=config.spec_ngram_min)
    if config.spec_decode == "draft":
        from ..models.llama import PRESETS

        if config.spec_draft_config is not None:
            draft_cfg = config.spec_draft_config
        elif config.spec_draft_model_path:
            from ..engine.loader_cache import cached_hf_config

            draft_cfg = cached_hf_config(config.spec_draft_model_path)
        elif config.spec_draft_model:
            if config.spec_draft_model not in PRESETS:
                raise ValueError(
                    f"unknown draft preset {config.spec_draft_model!r}; "
                    f"have {sorted(PRESETS)}")
            draft_cfg = PRESETS[config.spec_draft_model]
        else:
            raise ValueError(
                "spec_decode='draft' needs spec_draft_config, "
                "spec_draft_model_path, or spec_draft_model")
        target_cfg = config.resolve_model()
        if draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size}: draft tokens must be valid "
                "target tokens")
        return DraftModelProposer(
            draft_cfg, device,
            num_blocks=config.num_blocks, block_size=config.block_size,
            max_blocks_per_seq=config.max_blocks_per_seq,
            prefill_buckets=config.prefill_buckets,
            model_path=config.spec_draft_model_path,
            max_k=config.spec_k, seed=config.seed,
            # the draft cache follows the target's quantization policy
            kv_cache_dtype=config.kv_cache_dtype,
            params=params, capture=capture,
        )
    raise ValueError(
        f"spec_decode must be 'off' | 'ngram' | 'draft', "
        f"got {config.spec_decode!r}")


__all__ = [
    "DraftModelProposer",
    "NgramProposer",
    "SpecPlan",
    "make_proposer",
    "plan_spec_verify",
]

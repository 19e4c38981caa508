"""Memoized HF config resolution (EngineConfig.resolve_model is called on
every card build and scheduler decision; config.json is parsed once per
path).  The counterpart of dynamo_tpu/engine/loader_cache.py."""

from __future__ import annotations

from functools import lru_cache
from typing import Union

from ..models import DeepseekConfig, LlamaConfig


@lru_cache(maxsize=32)
def cached_hf_config(model_path: str) -> Union[LlamaConfig, DeepseekConfig]:
    from ..models.loader import load_hf_config

    return load_hf_config(model_path)

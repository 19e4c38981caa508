"""Model families of the port, one functional contract per family module
(the counterpart of dynamo_tpu/models/__init__.py):

    init_params(cfg, generator, device)   parameter tree
    prefill / prefill_batched             a chunked prompt over the paged cache
    decode / decode_multi                 batched token steps
    kv_cache_shapes(cfg, nb, bs)          the cache pair's shapes
    PRESETS                               name -> config

The engine binds a family once through get_family(cfg): Llama, Qwen and
Mixtral (llama.py, a GQA cache) and the DeepSeek MLA family
(deepseek.py, a latent cache) serve through the same plumbing; what a
family lacks (packed prefill, spec verify, an int8 cache, LoRA, the
hidden-state decode) the engine detects by the module's attributes."""

from . import deepseek, llama
from .deepseek import DeepseekConfig
from .llama import LlamaConfig, init_params

PRESETS = {**llama.PRESETS, **deepseek.PRESETS}


def get_family(cfg):
    """The model-family module of a config instance."""
    if isinstance(cfg, DeepseekConfig):
        return deepseek
    if isinstance(cfg, LlamaConfig):
        return llama
    raise TypeError(f"unknown model config type: {type(cfg).__name__}")


__all__ = ["DeepseekConfig", "LlamaConfig", "PRESETS", "get_family",
           "init_params"]

"""Model families of the port (dense Llama for now)."""

from .llama import PRESETS, LlamaConfig, init_params

__all__ = ["LlamaConfig", "PRESETS", "init_params"]

"""KV-cache quantization (engine config `kv_cache_dtype`).

quant/kv.py holds the symmetric int8 primitives and the bytes-per-block
capacity math; the writes and reads live beside the cache ops
(ops/paged_attention.py, ops/packed_prefill.py), and the model threads
the scale planes as members 3 and 4 of the KV cache tuple.
"""

from .kv import (
    INT8_MAX,
    blocks_for_hbm_budget,
    dequantize,
    is_quantized,
    kv_cache_bytes_per_block,
    quantize_tokens,
    unpack_kv,
)

__all__ = [
    "INT8_MAX",
    "blocks_for_hbm_budget",
    "dequantize",
    "is_quantized",
    "kv_cache_bytes_per_block",
    "quantize_tokens",
    "unpack_kv",
]

"""Symmetric int8 KV-cache quantization primitives.

The counterpart of dynamo_tpu/quant/kv.py, whose contract it keeps:

  * one fp32 scale per (layer, kv head, block, position), i.e. per
    written token per head, in planes [L, nkv, num_blocks, block_size]
    beside the cache (models/llama.py kv_cache_scale_shapes; the same
    layout in both packages, so the planes cross unchanged).  A scale per
    position keeps every write a pure scatter: a decode append never
    requantizes the rest of its block.
  * scale = absmax / 127 in fp32 and q = round(x / scale) clipped to
    +-127, so |dequantize(q, scale) - x| <= absmax / 254 elementwise.
    The division is a true division and torch.round rounds half to even
    like jnp.round, so codes and scales equal the JAX package's bit for
    bit on the same fp32 input.
  * a cache is a (k, v) tuple in full precision or (k, v, k_scale,
    v_scale) when int8.
  * at head_dim 128 a cached position costs (128 + 4) / 256 = 0.516 of
    its bf16 bytes: 1.94x the blocks in the same memory.

Dequantization happens at the attention read: the plain versions upcast
the gathered context (ops/paged_attention.py `_gather_ctx`), the CUDA
kernels fold the scales into their products (csrc/paged_decode.cu,
csrc/packed_prefill.cu).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

INT8_MAX = 127.0
# scales below this quantize to an all-zero row; dividing by the floor
# instead of the true (tiny) scale cannot overflow: |x| <= 127 * _EPS
_EPS = 1e-30


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization over the last axis:
    x [..., hd] -> (q int8 [..., hd], scale fp32 [...])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / INT8_MAX
    q = torch.round(xf / torch.clamp(scale, min=_EPS)[..., None])
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inverse of quantize_tokens: q [..., S, hd] * scale [..., S]."""
    out = q.float() * scale[..., None]
    return out if dtype is None else out.to(dtype)


def is_quantized(kv_cache) -> bool:
    return len(kv_cache) == 4


def unpack_kv(kv_cache):
    """(k, v, k_scale | None, v_scale | None) from either tuple arity."""
    if len(kv_cache) == 4:
        return tuple(kv_cache)
    k, v = kv_cache
    return k, v, None, None


# ---------------------------------------------------------------------------
# capacity math
# ---------------------------------------------------------------------------


def kv_cache_bytes_per_block(family, model_cfg, block_size: int,
                             kv_cache_dtype: str) -> int:
    """Device bytes ONE physical block costs across all layers (both cache
    members, each from its own shape: k and v, or MLA's latent and rope
    key of widths R and dr; for int8 both fp32 scale planes too), from
    the family's cache shapes."""
    k_shape, v_shape = family.kv_cache_shapes(model_cfg, 1, block_size)
    data_elems = math.prod(k_shape) + math.prod(v_shape)
    if kv_cache_dtype == "int8":
        ks_shape, vs_shape = family.kv_cache_scale_shapes(
            model_cfg, 1, block_size)
        return data_elems + 4 * (math.prod(ks_shape) + math.prod(vs_shape))
    itemsize = torch.empty(0, dtype=model_cfg.dtype).element_size()
    return data_elems * itemsize


def blocks_for_hbm_budget(family, model_cfg, block_size: int,
                          kv_cache_dtype: str, hbm_bytes: int) -> int:
    """Physical blocks a byte budget holds (floor 2: block 0 is the
    garbage block, so fewer than 2 cannot serve a single sequence)."""
    per = kv_cache_bytes_per_block(family, model_cfg, block_size,
                                   kv_cache_dtype)
    return max(2, int(hbm_bytes) // max(1, per))

"""Wrapper of kernel K1, the hand-written CUDA decode attention.

Kernel: csrc/paged_decode.cu (CUDA C++ for sm_90a, built by ops/_build.py
at first use).  It replaces the TPU kernel `paged_attention_decode_pallas`
(dynamo_tpu/ops/pallas_paged_attention.py) in its bf16 mode; the source
note says what bounds it on an H100 and how its design answers that.

For a CPU tensor `paged_decode` returns the plain version
(ops/paged_attention.py `paged_attention_decode_ref`).  For a CUDA tensor
it launches the kernel or raises: there is no fallback.  Each launch adds
one to `paged_decode.launches`, and nothing else does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import check_status, load_library
from .paged_attention import paged_attention_decode_ref

KERNEL = "paged_decode"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = (
    ("paged_decode_bf16",
     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
      ctypes.c_float, _P),
     ctypes.c_int),
    ("paged_decode_num_splits", (_I,), ctypes.c_int),
    ("paged_decode_error_string", (ctypes.c_int,), ctypes.c_char_p),
)
MAX_GROUP = 16
MAX_BLOCK_SIZE = 256


def _check(q, k_cache, v_cache, layer, block_tables, kv_lens) -> None:
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("kv_lens", kv_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (the kernel loads rows "
                         "as 16-byte vectors)")
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 \
            or v_cache.dtype != torch.bfloat16:
        raise TypeError("the CUDA decode kernel takes bf16 q and caches, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("block_tables and kv_lens must be int32")
    B, nh, hd = q.shape
    L, nkv, _, bs, chd = k_cache.shape
    if v_cache.shape != k_cache.shape or chd != hd:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    if nh % nkv or nh // nkv > MAX_GROUP:
        raise ValueError(f"{nh} heads over {nkv} kv heads: the group must "
                         f"divide and be <= {MAX_GROUP}")
    if bs % 32 or not 0 < bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {bs} must be a multiple of 32 in "
                         f"(0, {MAX_BLOCK_SIZE}]")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range [0, {L})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or kv_lens.shape != (B,):
        raise ValueError("block_tables must be [B, >=1] and kv_lens [B]")


def paged_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, layer: int,
                 block_tables: torch.Tensor,
                 kv_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention [B, nh, hd] over the paged cache
    [L, nkv, num_blocks, bs, hd]; the kernel computes
    paged_attention_decode_ref(..., round_scaled_q=True)."""
    if not q.is_cuda:
        return paged_attention_decode_ref(q, k_cache, v_cache, layer,
                                          block_tables, kv_lens)
    _check(q, k_cache, v_cache, layer, block_tables, kv_lens)
    lib = load_library(KERNEL, _SIGNATURES)
    B, nh, hd = q.shape
    _, nkv, num_blocks, bs, _ = k_cache.shape
    if B == 0:
        return torch.empty_like(q)
    mb = block_tables.shape[1]
    # split-KV partials (max, sum, unnormalized accumulator) per split
    splits = lib.paged_decode_num_splits(mb)
    part_ml = torch.empty(2, B, nh, splits, dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty(B, nh, splits, hd, dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.paged_decode_bf16(
        q.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(),
        block_tables.data_ptr(), kv_lens.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        B, nh, nkv, hd, num_blocks, bs, mb, 1.0 / math.sqrt(hd), stream)
    check_status(lib, "paged_decode_error_string", status, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0

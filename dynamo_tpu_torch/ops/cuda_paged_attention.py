"""Wrappers of kernel K1, the hand-written CUDA decode attention.

Kernel: csrc/paged_decode.cu (CUDA C++ for sm_90a, built by ops/_build.py
at first use).  It replaces the TPU kernel `paged_attention_decode_pallas`
(dynamo_tpu/ops/pallas_paged_attention.py) in its bf16 mode
(`paged_decode`) and its int8 mode (`paged_decode_int8`: int8 caches with
their fp32 scale planes, quant/kv.py).  K1 is bound by bytes; the source
note says how its design keeps them in flight: split-KV with the split
count sized to the grid (`decode_splits`, from B, nkv, the table width
and the SM count, never from kv_lens, so the call is capturable; the
kernel deals each row's 64-position units round-robin over its live
splits), a per-warp cp.async ring, and the splits' merge
fused into the same launch.  At the chip_smoke cases (llama-8b, H100
80GB HBM3 at 700 W) it takes 0.0161 ms at B = 8 against a 0.0082 ms
byte bound, 0.0100 ms at B = 4, 0.0076 ms at B = 1 (PERF.md).

One launch per call.  The split partials and the merge counters live in
one workspace per device (`_workspace`), grown when a shape needs more
and never freed while the process runs (a captured CUDA graph keeps its
pointers); the counters start at 0 and the kernel resets them.  So a
call allocates nothing but its output.  Calls on one device share the
workspace: make them from one stream, and make the first call of the
largest shape before capturing a CUDA graph (as a warm-up does), so the
workspace is not allocated inside the graph's memory pool.

For CPU tensors each wrapper returns the plain version
(ops/paged_attention.py `paged_attention_decode_ref`, with the scales for
int8).  For CUDA tensors it launches its kernel or raises: there is no
fallback, and no route from an int8 cache to the bf16 kernel.  Each
launch adds one to `paged_decode.launches` or `paged_decode_int8.launches`,
and nothing else does.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch

from ._build import check_status, load_library
from .paged_attention import paged_attention_decode_ref

KERNEL = "paged_decode"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = (
    ("paged_decode_bf16",
     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
      ctypes.c_float, _P),
     ctypes.c_int),
    ("paged_decode_int8",
     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
      _I, _I, ctypes.c_float, _P),
     ctypes.c_int),
    ("paged_decode_smem_bytes", (_I, _I), ctypes.c_int),
    ("paged_decode_error_string", (ctypes.c_int,), ctypes.c_char_p),
)
MAX_GROUP = 16
MAX_BLOCK_SIZE = 256
UNIT = 64           # context positions per unit of split work (kUnit)
CTAS_PER_SM = 2     # resident K1 CTAs per SM (shared memory): one wave
MAX_SPLITS = 16     # past it the merge costs more than the splits save


def decode_splits(B: int, nkv: int, max_blocks: int, block_size: int,
                  sm_count: int) -> int:
    """Splits per (sequence, kv head): one wave of CTAS_PER_SM CTAs per SM
    when every row fills its table, never more than a full table has
    units.  The kernel deals each row's own ceil(kv_len / UNIT) units
    round-robin over min(splits, its units) of them."""
    units = -(-max_blocks * block_size // UNIT)
    want = -(-CTAS_PER_SM * sm_count // max(1, B * nkv))
    return max(1, min(units, want, MAX_SPLITS))


_ws_lock = threading.Lock()
_ws: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_ws_retired: List[Tuple[torch.Tensor, torch.Tensor]] = []
_sms: Dict[torch.device, int] = {}


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _workspace(device: torch.device, n_floats: int,
               n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(floats, int32 counters) of at least these sizes on `device`; the
    counters are zero and the kernel leaves them so.  A grown workspace
    keeps the old one alive (a captured graph may still point at it)."""
    with _ws_lock:
        cur = _ws.get(device)
        if cur is None or cur[0].numel() < n_floats \
                or cur[1].numel() < n_counters:
            if cur is not None:
                _ws_retired.append(cur)
                n_floats = max(n_floats, cur[0].numel())
                n_counters = max(n_counters, cur[1].numel())
            cur = _ws[device] = (
                torch.empty(n_floats, dtype=torch.float32, device=device),
                torch.zeros(n_counters, dtype=torch.int32, device=device))
        return cur


def check_cache(q, k_cache, v_cache, k_scale, v_scale, layer: int,
                what: str) -> None:
    """The checks K1 and K3 share on q, the caches and, for the int8 mode
    (scales passed), the scale planes [L, nkv, num_blocks, bs] fp32."""
    dev = q.device
    quantized = k_scale is not None or v_scale is not None
    planes = (("k_scale", k_scale), ("v_scale", v_scale)) if quantized else ()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    *planes):
        if t is None:
            raise ValueError(f"the int8 {what} kernel needs {name}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cache = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_cache.dtype != cache \
            or v_cache.dtype != cache:
        raise TypeError(f"the CUDA {what} kernel's "
                        f"{'int8' if quantized else 'bf16'} mode takes bf16 "
                        f"q and {cache} caches, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} are not one "
                         "[L, nkv, nb, bs, hd] pair")
    if not 0 <= layer < k_cache.shape[0]:
        raise IndexError(f"layer {layer} out of range [0, "
                         f"{k_cache.shape[0]})")
    # rows load as 16-byte vectors: each layer's slab and scale rows too
    for name, t in (("q", q), ("k_cache", k_cache[layer]),
                    ("v_cache", v_cache[layer]),
                    *((n, t[layer]) for n, t in planes)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads rows as 16-byte vectors)")
    for name, t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != k_cache.shape[:4]:
            raise ValueError(f"{name} shape {tuple(t.shape)} is not the "
                             f"cache's [L, nkv, nb, bs] "
                             f"{tuple(k_cache.shape[:4])}")


def _check(q, k_cache, v_cache, layer, block_tables, kv_lens, k_scale=None,
           v_scale=None) -> None:
    check_cache(q, k_cache, v_cache, k_scale, v_scale, layer, "decode")
    for name, t in (("block_tables", block_tables), ("kv_lens", kv_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("block_tables and kv_lens must be int32")
    B, nh, hd = q.shape
    _, nkv, _, bs, chd = k_cache.shape
    if chd != hd:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    if nh % nkv or nh // nkv > MAX_GROUP:
        raise ValueError(f"{nh} heads over {nkv} kv heads: the group must "
                         f"divide and be <= {MAX_GROUP}")
    if bs % 32 or not 0 < bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {bs} must be a multiple of 32 in "
                         f"(0, {MAX_BLOCK_SIZE}]")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or kv_lens.shape != (B,):
        raise ValueError("block_tables must be [B, >=1] and kv_lens [B]")


def _launch(q, k_cache, v_cache, k_scale, v_scale, layer, block_tables,
            kv_lens, n_splits: Optional[int] = None) -> torch.Tensor:
    """One launch of the bf16 (no scales) or the int8 entry point;
    `n_splits` overrides the split plan (for measuring it)."""
    _check(q, k_cache, v_cache, layer, block_tables, kv_lens, k_scale,
           v_scale)
    lib = load_library(KERNEL, _SIGNATURES)
    B, nh, hd = q.shape
    _, nkv, num_blocks, bs, _ = k_cache.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    mb = block_tables.shape[1]
    if n_splits is None:
        n_splits = decode_splits(B, nkv, mb, bs, _sm_count(q.device))
    # each split's partial (max, sum) and accumulator per query row (the
    # accumulators 16-byte aligned)
    rows = B * nh * n_splits
    ml = -(-2 * rows // 4) * 4
    ws, counters = _workspace(q.device, ml + rows * hd, B * nkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (block_tables.data_ptr(), kv_lens.data_ptr(), ws.data_ptr(),
              ws.data_ptr() + 4 * ml, counters.data_ptr(), out.data_ptr(),
              B, nh, nkv, hd, num_blocks, bs, mb, n_splits,
              1.0 / math.sqrt(hd), stream)
    caches = (q.data_ptr(), k_cache[layer].data_ptr(),
              v_cache[layer].data_ptr())
    if k_scale is None:
        status = lib.paged_decode_bf16(*caches, *common)
    else:
        status = lib.paged_decode_int8(*caches, k_scale[layer].data_ptr(),
                                       v_scale[layer].data_ptr(), *common)
    check_status(lib, "paged_decode_error_string", status, "paged_decode")
    return out


def paged_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, layer: int,
                 block_tables: torch.Tensor,
                 kv_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention [B, nh, hd] over the bf16 paged cache
    [L, nkv, num_blocks, bs, hd]; the kernel computes
    paged_attention_decode_ref(..., round_scaled_q=True)."""
    if not q.is_cuda:
        return paged_attention_decode_ref(q, k_cache, v_cache, layer,
                                          block_tables, kv_lens)
    out = _launch(q, k_cache, v_cache, None, None, layer, block_tables,
                  kv_lens)
    paged_decode.launches += 1
    return out


def paged_decode_int8(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, layer: int,
                      block_tables: torch.Tensor,
                      kv_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention [B, nh, hd] over the int8 paged cache and its
    scale planes [L, nkv, num_blocks, bs]; the kernel computes
    paged_attention_decode_ref(..., round_scaled_q=True, k_scale=k_scale,
    v_scale=v_scale) up to the bf16 rounding of its P operand."""
    if not q.is_cuda:
        return paged_attention_decode_ref(q, k_cache, v_cache, layer,
                                          block_tables, kv_lens,
                                          k_scale=k_scale, v_scale=v_scale)
    if k_scale is None or v_scale is None:
        raise ValueError("paged_decode_int8 needs k_scale and v_scale")
    out = _launch(q, k_cache, v_cache, k_scale, v_scale, layer,
                  block_tables, kv_lens)
    paged_decode_int8.launches += 1
    return out


paged_decode.launches = 0
paged_decode_int8.launches = 0

"""Wrappers of kernel K3, the hand-written CUDA packed-prefill attention.

Kernel: csrc/packed_prefill.cu (CUDA C++ for sm_90a, built by
ops/_build.py at first use).  It replaces the TPU kernel
`packed_prefill_attention_pallas` (dynamo_tpu/ops/pallas_packed_prefill.py)
in its bf16 mode (`packed_prefill`) and its int8 mode
(`packed_prefill_int8`: int8 caches with their fp32 scale planes).  K3 is
bound by operations; the source note says how its design answers that:
wgmma on 64-row tiles (64 / group tokens x the group's heads), two
consumer warpgroups sharing one TMA-fed mbarrier ring of K/V stages, the
mask only on stages that cross a row's frontier, and in int8 mode three
converter warps that turn each stage's codes into bf16 once.  At the
chip_smoke case (llama-8b, a 2048-token stream, H100 80GB HBM3 at 700 W)
it takes 0.1099 ms (bf16) and 0.1482 ms (int8) against a 0.0275 ms
operation bound, with the plan computed beforehand (PERF.md).

`packed_prefill_plan` is the wrapper-side half of the tile-skip scheme: the
same per-(token tile, segment) chunk counts the TPU wrapper builds
(pallas_packed_prefill.py:244-254), with one cache block per chunk, at
the kernel's tile of `token_block(group)` tokens, plus the order in
which the grid walks the tiles (most work first).  The plan is the same
for every layer of a packed dispatch: models/llama.py computes it once
and hands it to each layer's call; a call without one computes it.

For CPU tensors each wrapper returns the plain version
(ops/packed_prefill.py `packed_prefill_attention_ref`, with the scales for
int8).  For CUDA tensors it launches its kernel or raises: there is no
fallback.  Each launch adds one to `packed_prefill.launches` or
`packed_prefill_int8.launches`, and nothing else does.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import check_status, load_library
from .cuda_paged_attention import check_cache
from .packed_prefill import packed_prefill_attention_ref

KERNEL = "packed_prefill"
TILE_ROWS = 64  # wgmma rows per consumer warpgroup (kRowsWG)
WARPGROUPS = 2  # consumer warpgroups per CTA (kWG)
MAX_GROUP = 8
MAX_BLOCK_SIZE = 128
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = (
    ("packed_prefill_bf16",
     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
      _I, ctypes.c_float, _P),
     ctypes.c_int),
    ("packed_prefill_int8",
     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
      _I, _I, _I, ctypes.c_float, _P),
     ctypes.c_int),
    ("packed_prefill_smem_bytes", (_I, _I), ctypes.c_int),
    ("packed_prefill_error_string", (ctypes.c_int,), ctypes.c_char_p),
)


def token_block(group: int) -> int:
    """Tokens per kernel tile: each consumer warpgroup takes
    TILE_ROWS // group tokens (all `group` heads of each)."""
    return WARPGROUPS * (TILE_ROWS // group)


class PackedPlan(NamedTuple):
    """The kernel's tile plan (`packed_prefill_plan`)."""
    seg_eff: torch.Tensor    # [n_tiles * token_block] int32, -1 = none
    positions: torch.Tensor  # [n_tiles * token_block] int32
    nchunks: torch.Tensor    # [n_tiles, S] int32
    order: torch.Tensor      # [n_tiles] int32, most chunks first
    token_block: int


def packed_prefill_plan(seg_ids: torch.Tensor, positions: torch.Tensor,
                        valid: torch.Tensor, block_tables: torch.Tensor,
                        n_heads: int, n_kv_heads: int,
                        block_size: int) -> PackedPlan:
    """K3's tile plan for a packed dispatch of these shapes, the same for
    all its layers, in torch ops on the stream's device (no host read, so
    a dispatch stays capturable).  Tiles are `token_block(group)` tokens.

    seg_eff [n_tiles * token_block]: each token's segment, -1 for invalid
    tokens and the tile padding, so no mask ever selects them and no
    chunk count grows on their behalf.  nchunks [n_tiles, S]: context
    blocks each (tile, segment) pair walks: the causal frontier of the
    tile's farthest token of that segment, 0 when the segment owns no
    token of the tile (the skip), capped at the table width.  order: the
    tiles by their total chunks, most first (stable), the order the grid
    runs them in."""
    n_segments, max_blocks = block_tables.shape
    tb = token_block(n_heads // n_kv_heads)
    T = seg_ids.shape[0]
    n_tiles = -(-T // tb)
    pad = n_tiles * tb - T
    seg = torch.where(valid, seg_ids.to(torch.int32),
                      torch.full_like(seg_ids, -1, dtype=torch.int32))
    pos = positions.to(torch.int32)
    if pad:
        seg = F.pad(seg, (0, pad), value=-1)
        pos = F.pad(pos, (0, pad))
    seg2 = seg.view(n_tiles, tb)
    pos2 = pos.view(n_tiles, tb)
    rows = torch.arange(n_segments, dtype=torch.int32, device=seg.device)
    owned = seg2[:, None, :] == rows[None, :, None]      # [n_tiles, S, TB]
    maxpos = torch.where(owned, pos2[:, None, :],
                         torch.full_like(pos2[:, None, :], -1)).amax(-1)
    nch = torch.where(maxpos >= 0, maxpos // block_size + 1,
                      torch.zeros_like(maxpos))
    nch = torch.clamp(nch, max=max_blocks).to(torch.int32).contiguous()
    order = torch.argsort(nch.sum(1), descending=True, stable=True)
    return PackedPlan(seg.contiguous(), pos.contiguous(), nch,
                      order.to(torch.int32), tb)


def _check(q, k_cache, v_cache, layer, block_tables, seg_ids, positions,
           valid, k_scale=None, v_scale=None) -> None:
    check_cache(q, k_cache, v_cache, k_scale, v_scale, layer,
                "packed-prefill")
    for name, t in (("block_tables", block_tables), ("seg_ids", seg_ids),
                    ("positions", positions), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not block_tables.is_contiguous():
        raise ValueError("block_tables must be contiguous")
    if block_tables.dtype != torch.int32:
        raise TypeError("block_tables must be int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    T, nh, hd = q.shape
    _, nkv, _, bs, chd = k_cache.shape
    if chd != hd:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    if nh % nkv or nh // nkv > MAX_GROUP:
        raise ValueError(f"{nh} heads over {nkv} kv heads: the group must "
                         f"divide and be <= {MAX_GROUP}")
    if bs % 64 or not 0 < bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {bs} must be a multiple of 64 in "
                         f"(0, {MAX_BLOCK_SIZE}]")
    if block_tables.dim() != 2 or block_tables.shape[1] < 1:
        raise ValueError("block_tables must be [S, >=1]")
    if seg_ids.shape != (T,) or positions.shape != (T,) \
            or valid.shape != (T,):
        raise ValueError("seg_ids, positions and valid must be [T]")


def _launch(q, k_cache, v_cache, k_scale, v_scale, layer, block_tables,
            seg_ids, positions, valid, plan: Optional[PackedPlan]
            ) -> torch.Tensor:
    """One launch of the bf16 (no scales) or the int8 entry point."""
    _check(q, k_cache, v_cache, layer, block_tables, seg_ids, positions,
           valid, k_scale, v_scale)
    lib = load_library(KERNEL, _SIGNATURES)
    T, nh, hd = q.shape
    _, nkv, num_blocks, bs, _ = k_cache.shape
    S, mb = block_tables.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    if plan is None:
        plan = packed_prefill_plan(seg_ids, positions, valid, block_tables,
                                   nh, nkv, bs)
    n_tiles = plan.nchunks.shape[0]
    if plan.token_block != token_block(nh // nkv) \
            or plan.nchunks.shape[1] != S \
            or plan.seg_eff.shape[0] != n_tiles * plan.token_block \
            or n_tiles * plan.token_block < T:
        raise ValueError("the tile plan does not fit this call's shapes")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (block_tables.data_ptr(), plan.seg_eff.data_ptr(),
              plan.positions.data_ptr(), plan.nchunks.data_ptr(),
              plan.order.data_ptr(), out.data_ptr(), T, nh, nkv, hd,
              num_blocks, bs, S, mb, n_tiles, 1.0 / math.sqrt(hd), stream)
    caches = (q.data_ptr(), k_cache[layer].data_ptr(),
              v_cache[layer].data_ptr())
    if k_scale is None:
        status = lib.packed_prefill_bf16(*caches, *common)
    else:
        status = lib.packed_prefill_int8(*caches, k_scale[layer].data_ptr(),
                                         v_scale[layer].data_ptr(), *common)
    check_status(lib, "packed_prefill_error_string", status,
                 "packed_prefill")
    return out


def packed_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, layer: int,
                   block_tables: torch.Tensor, seg_ids: torch.Tensor,
                   positions: torch.Tensor, valid: torch.Tensor,
                   plan: Optional[PackedPlan] = None) -> torch.Tensor:
    """Segment-causal attention [T, nh, hd] for a packed prefill stream
    over the bf16 cache; the kernel computes
    packed_prefill_attention_ref(..., round_scaled_q=True).  `plan`: the
    dispatch's `packed_prefill_plan`, computed here when absent."""
    if not q.is_cuda:
        return packed_prefill_attention_ref(q, k_cache, v_cache, layer,
                                            block_tables, seg_ids,
                                            positions, valid)
    out = _launch(q, k_cache, v_cache, None, None, layer, block_tables,
                  seg_ids, positions, valid, plan)
    packed_prefill.launches += 1
    return out


def packed_prefill_int8(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, layer: int,
                        block_tables: torch.Tensor, seg_ids: torch.Tensor,
                        positions: torch.Tensor, valid: torch.Tensor,
                        plan: Optional[PackedPlan] = None) -> torch.Tensor:
    """Segment-causal attention [T, nh, hd] over the int8 cache and its
    scale planes; the kernel computes packed_prefill_attention_ref(...,
    round_scaled_q=True, k_scale=k_scale, v_scale=v_scale) up to the bf16
    rounding of its P operand.  `plan` as in `packed_prefill`."""
    if not q.is_cuda:
        return packed_prefill_attention_ref(q, k_cache, v_cache, layer,
                                            block_tables, seg_ids,
                                            positions, valid,
                                            k_scale=k_scale, v_scale=v_scale)
    if k_scale is None or v_scale is None:
        raise ValueError("packed_prefill_int8 needs k_scale and v_scale")
    out = _launch(q, k_cache, v_cache, k_scale, v_scale, layer, block_tables,
                  seg_ids, positions, valid, plan)
    packed_prefill_int8.launches += 1
    return out


packed_prefill.launches = 0
packed_prefill_int8.launches = 0

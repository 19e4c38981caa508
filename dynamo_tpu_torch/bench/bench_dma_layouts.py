"""Paged-gather bandwidth microbench: how fast do paged KV blocks reach
on-chip memory, per cache layout?  The port's counterpart of
benchmarks/bench_dma_layouts.py (which stays the TPU's).

    python -m dynamo_tpu_torch.bench.bench_dma_layouts   # on a CUDA card

Kernels K4a and K4b (csrc/dma_layouts.cu, built by ops/_build.py) at the
source's shapes: llama-8b's 8 kv heads and head_dim 128, the engine's
block_size 128, a pool of 1024 blocks (a 256 MB bf16 slab), 512 blocks
gathered per pass from a seeded permutation in chunks of 8, 8 passes per
call, so 1.07 GB per gather call and 2.15 GB per sequential call:

  strided   K4a on the port's head-major cache layer [nkv, nb, bs, hd]:
            a block is 8 planes of 32 KB, each nb * 32 KB apart
  contig    K4a on a block-major slab [nb, nkv, bs, hd]: 256 KB
            contiguous per block
  seq       K4b: the whole block-major slab streamed in order (no table:
            the upper bound)

Prints GB/s and the share of the H100's 3.35 TB/s for each, with the
card's name and power limit.  Every byte of every listed block crosses
into shared memory; the outputs are checksums of what crossed (the TPU
kernels' outputs, in the port's [bs, hd] plane order), held here against
the plain versions below.

For CPU tensors the wrappers return the plain versions; for CUDA tensors
they launch their kernel or raise.  Each launch adds one to the
wrapper's `launches`, and nothing else does.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops._build import check_status, load_library

NKV, HD, BS = 8, 128, 128
NB = 1024       # pool blocks (256 MB slab at bf16)
NREAD = 512     # blocks gathered per pass
BPC = 8         # blocks per chunk
REPS = 8        # passes per call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

KERNEL = "dma_layouts"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = (
    ("dma_gather", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
     ctypes.c_int),
    ("dma_seq", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    ("dma_layouts_error_string", (ctypes.c_int,), ctypes.c_char_p),
)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gather_ref(cache: torch.Tensor, tables: torch.Tensor, strided: bool,
               reps: int = REPS, bpc: int = BPC) -> torch.Tensor:
    """K4a's function: `reps` x the sum, over the table's chunks of `bpc`
    blocks, of the chunk's first block's head-0 plane, rows 0-7.  cache:
    [nkv, nb, bs, hd] (strided) or [nb, nkv, bs, hd]; -> [8, hd] fp32."""
    first = tables.view(-1, bpc)[:, 0].long()
    planes = cache[0, first] if strided else cache[first, 0]
    return planes[:, :8].float().sum(0) * reps


def seq_ref(slab: torch.Tensor, reps: int = REPS,
            bpc: int = BPC) -> torch.Tensor:
    """K4b's function: `reps` x the sum, over the slab's chunks of `bpc`
    blocks, of the chunk's first block's head-0 plane; slab
    [nb, nkv, bs, hd] -> [bs, hd] fp32."""
    return slab[::bpc, 0].float().sum(0) * reps


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _grid(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.bfloat16 or t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 4-d bf16 tensor")
    if t.shape[2] * t.shape[3] * 2 > 32768 or t.shape[3] * 2 % 16:
        raise ValueError(f"{what}: a [bs, hd] plane must fit 32 KB in "
                         "16-byte rows")


def _gather(cache, tables, strided: bool, reps: int, bpc: int):
    if not cache.is_cuda:
        return gather_ref(cache, tables, strided, reps, bpc)
    _check(cache, "cache")
    if tables.dtype != torch.int32 or tables.device != cache.device \
            or tables.dim() != 1 or tables.numel() % bpc:
        raise ValueError("tables must be int32 [nread] on the cache's "
                         "device, nread a multiple of bpc")
    nkv, nb = (cache.shape[0], cache.shape[1]) if strided \
        else (cache.shape[1], cache.shape[0])
    bs, hd = cache.shape[2], cache.shape[3]
    lib = load_library(KERNEL, _SIGNATURES)
    grid = _grid(cache.device)
    out = torch.empty(8, hd, dtype=torch.float32, device=cache.device)
    part = torch.empty(grid, 8 * hd, dtype=torch.float32,
                       device=cache.device)
    status = lib.dma_gather(
        cache.data_ptr(), tables.data_ptr(), part.data_ptr(), out.data_ptr(),
        int(strided), nkv, nb, bs, hd, tables.numel(), bpc, reps, grid,
        torch.cuda.current_stream(cache.device).cuda_stream)
    check_status(lib, "dma_layouts_error_string", status, "dma_gather")
    return out


def gather_strided(cache: torch.Tensor, tables: torch.Tensor,
                   reps: int = REPS, bpc: int = BPC) -> torch.Tensor:
    """K4a on a head-major cache layer [nkv, nb, bs, hd]."""
    out = _gather(cache, tables, True, reps, bpc)
    if cache.is_cuda:
        gather_strided.launches += 1
    return out


def gather_contig(slab: torch.Tensor, tables: torch.Tensor,
                  reps: int = REPS, bpc: int = BPC) -> torch.Tensor:
    """K4a on a block-major slab [nb, nkv, bs, hd]."""
    out = _gather(slab, tables, False, reps, bpc)
    if slab.is_cuda:
        gather_contig.launches += 1
    return out


def seq(slab: torch.Tensor, reps: int = REPS, bpc: int = BPC) -> torch.Tensor:
    """K4b on a block-major slab [nb, nkv, bs, hd]."""
    if not slab.is_cuda:
        return seq_ref(slab, reps, bpc)
    _check(slab, "slab")
    nb, nkv, bs, hd = slab.shape
    lib = load_library(KERNEL, _SIGNATURES)
    grid = _grid(slab.device)
    out = torch.empty(bs, hd, dtype=torch.float32, device=slab.device)
    part = torch.empty(grid, bs * hd, dtype=torch.float32, device=slab.device)
    status = lib.dma_seq(
        slab.data_ptr(), part.data_ptr(), out.data_ptr(), nkv, nb, bs, hd,
        bpc, reps, grid, torch.cuda.current_stream(slab.device).cuda_stream)
    check_status(lib, "dma_layouts_error_string", status, "dma_seq")
    seq.launches += 1
    return out


gather_strided.launches = 0
gather_contig.launches = 0
seq.launches = 0


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------


def inputs(device: torch.device, seed: int = 0) -> dict:
    """Seeded inputs at the source's shapes: the head-major layer, the
    same blocks block-major, and the table (a permutation's first NREAD
    ids)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    layer = torch.randn(NKV, NB, BS, HD, generator=gen, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
    tables = torch.from_numpy(np.random.default_rng(seed).permutation(NB)[
        :NREAD].astype(np.int32)).to(device)
    return {"layer": layer, "slab": layer.transpose(0, 1).contiguous(),
            "tables": tables}


def nbytes(mode: str) -> int:
    """Bytes a call moves into on-chip memory: every listed block's
    planes in each of the REPS passes."""
    blocks = NB if mode == "seq" else NREAD
    return REPS * blocks * NKV * BS * HD * 2


def calls(x: dict) -> dict:
    """{mode: a thunk making one call of its kernel on `x`}."""
    return {"strided": lambda: gather_strided(x["layer"], x["tables"]),
            "contig": lambda: gather_contig(x["slab"], x["tables"]),
            "seq": lambda: seq(x["slab"])}


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call: CUDA events around `iters` calls
    (each moves a GB, so the host's launch cost is hidden)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(x: dict) -> dict:
    """{mode: {"ms", "gb_per_s", "share_of_peak", "bytes"}} on inputs
    `x`, each mode's kernel timed in turn."""
    res = {}
    for mode, fn in calls(x).items():
        ms = time_ms(fn)
        gbps = nbytes(mode) / (ms * 1e-3) / 1e9
        res[mode] = {"ms": ms, "gb_per_s": gbps,
                     "share_of_peak": gbps * 1e9 / HBM_BYTES_PER_S,
                     "bytes": nbytes(mode)}
    return res


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest relative L2 error over the output's rows."""
    den = ref.float().norm(dim=-1).clamp(min=1e-30)
    return ((out.float() - ref.float()).norm(dim=-1) / den).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_dma_layouts: torch.cuda is not available",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    x = inputs(dev)
    plain = {"strided": gather_ref(x["layer"], x["tables"], True),
             "contig": gather_ref(x["slab"], x["tables"], False),
             "seq": seq_ref(x["slab"])}
    for mode, fn in calls(x).items():
        err = row_rel_err(fn(), plain[mode])
        print(f"{mode}: max row relative error against the plain version "
              f"{err:.2e}")
        if not err <= 1e-5:
            print(f"{mode} disagrees with its plain version", file=sys.stderr)
            return 1
    print(f"card: {card}; {nbytes('contig') / 1e9:.2f} GB per gather call, "
          f"{nbytes('seq') / 1e9:.2f} GB per sequential call")
    for mode, r in measure(x).items():
        print(f"  {mode:8s} {r['gb_per_s']:7.1f} GB/s "
              f"({100 * r['share_of_peak']:.1f}% of 3.35 TB/s), "
              f"{r['ms']:.3f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())

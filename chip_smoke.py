#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, as below
    python3 chip_smoke.py --ab OTHER_DIR  # the kernels only, against
                                          # another checkout's
    python3 chip_smoke.py --worker-ab     # the engine directly against
                                          # the engine behind the worker
    python3 chip_smoke.py --decode-ab     # lockstep eager decode against
                                          # the default scheduler
    python3 chip_smoke.py --fused-ab      # the sampling epilogue off
                                          # against fused
    python3 chip_smoke.py --checkpoint    # the loaded-checkpoint phase
    python3 chip_smoke.py --prefill-ab    # eager packed prefill against
                                          # one CUDA graph per bucket
    python3 chip_smoke.py --disagg        # the disaggregated pair
    python3 chip_smoke.py --disagg-ipc    # the pair across two processes
    python3 chip_smoke.py --kvbm          # the KV block manager's tiers
    python3 chip_smoke.py --spec          # speculative decoding
    python3 chip_smoke.py --lora          # LoRA serving and guided decoding
    python3 chip_smoke.py --status        # the worker's status plane
    python3 chip_smoke.py --moe           # the MoE family (Mixtral)
    python3 chip_smoke.py --mla           # the DeepSeek MLA family

Builds the port's CUDA kernels from csrc/ (three nvcc processes started
together), holds each entry point (K1 and K3, each in its bf16 and its
int8 mode) against its plain PyTorch version at the llama-8b shapes the
main path gives it (K1 at B = 8, 4 and 1, K3 on a 2048-token and a
512-token packed stream and on the 32-token stream of a speculative
verify dispatch), runs the paged-gather bandwidth microbench
(dynamo_tpu_torch/bench/bench_dma_layouts.py: K4a strided and contig,
K4b) and holds its kernels against their plain versions, then serves
concurrent requests through `TorchEngine` with the llama-8b preset at
full width (random bf16 weights made on the card from a seed) and the
JAX engine's default scheduler (overlapped, decode bursts fused up to 8
steps and replayed from CUDA graphs that warm-up captures), first on a
bf16 KV cache and then, with the same weights, on an int8 KV cache sized
by a memory budget (`kv_cache_dtype="int8"`, `kv_hbm_gb`), and checks
the streams, that every decode program and every packed-prefill
bucket's program was captured once and never again while serving, that
a replayed burst equals the same burst run eagerly, and that a replayed
prefill bucket's first tokens and logits are bit-equal to its eager
body's (a full 2048-token bucket, and a 32-token one with padded rows).  After the bf16 engine run, the same requests go through a
`TorchEngineWorker` with the same config and weights, over the port's
runtime (mem discovery, in-process event plane, TCP request plane on
127.0.0.1), and the worker's contract is checked: streams, KV events,
load metrics, FPM records, the MDC, clear_kv_blocks, cancellation and
close, and its status plane (the system-status server on an ephemeral
port with an admin token, the roofline peaks of this card and the
timeline tracer on: /live and /health, system_addr in discovery,
/metrics' decode MBU and prefill MFU in (0, 1] with the decode MBU held
to the smoke's own roofline, one compile sample per captured program
and none while serving, a decode step's counted bytes against the
weights and a full table's KV, ordered kv_tier_costs, /debug/state's
token gate and JAX keys, /debug/profile naming K1 during a decode run,
the trace's span kinds, greedy streams equal with tracing off and on,
and /health 503 after the drain); then the decode A/B, the fused A/B and the prefill A/B (below)
run; after the int8 run, one request goes through a worker on the int8
cache (its launches and the dtype it reports), then the disagg phase
(below), then the pair across two processes (below), then the KVBM
phase (below), then the spec phase (below), then the LoRA and guided
phase (below).
Last, a HF-format Llama
checkpoint at
llama-8b width, depth cut to 4 layers (about 3.9 GB of bf16), is written
to a temporary directory with the standard library and served through
the port's own safetensors loader and weight cache (below).  Any failed
phase ends the script with a non-zero exit code.  It imports nothing of
JAX or of the JAX package.

Output: one line per phase; a `{"kernels": [...]}` JSON line with each
kernel's launches on the main path (`launches` in the engine run, or the
microbench's own run for K4, `worker_launches` in the worker run; a
replay of a captured program adds the K1/K3 launches its capture
recorded; `checkpoint_launches` in the loaded checkpoint's run;
`disagg_prefill_launches` and `disagg_decode_launches`, the disagg
pair's prefill and decode workers' in its main run;
`disagg_ipc_prefill_launches`, the prefill worker process's over the
four turns of the pair across two processes (its own counts, logged at
ready and at exit), and `disagg_ipc_decode_launches`, the decode
worker's in its first CUDA IPC turn; `kvbm_launches` in
the KVBM phase's first G2 run, bf16, or its int8 run; `spec_launches` in
the spec phase's first n-gram turn, bf16, or its int8 n-gram run;
`spec_draft_launches`, K3's in the draft's catch-up programs during the
draft == target turn;
`lora_launches` in the LoRA phase's mixed batch and `guided_launches` in
its guided run), error
against its plain version (`max_abs_err`, and
`max_rel_err`, the figure the tolerance holds), its device time (`ms`,
by CUDA-graph replay for K1/K3; K3's with its tile plan computed
beforehand, as the model does once per dispatch, `plan_ms` the plan
alone and `with_plan_ms` a call that computes its own; by CUDA events
around calls for K4), the plain version's time, the one-call PyTorch
yardstick's time (`library_ms`: scaled_dot_product_attention on the same
context gathered into a dense tensor beforehand, dequantized to bf16 for
the int8 modes; for K4 index_select of the table's blocks or a sum over
the slab, once; the port never calls them), the least time the card
could take (`bound_ms`) and, under `cases`, the time and bound of every
case; the card's name and power limit; and, last, `{"ok": true,
"device": {...}}`.

With --ab, each mode of both kernels of this checkout is timed against
the same mode of the checkout at OTHER_DIR (for instance the parent
commit unpacked into the git-ignored dynamo_tpu_torch/_build/), case by
case, in one process on one card, in turns (other, this, this, other),
both held to the plain version; K1 is also timed at other split counts.

With --worker-ab, the five requests on a bf16 cache are served in one
process directly by a `TorchEngine` and through a `TorchEngineWorker`
(own caches, the same weights) in turns (direct, worker, worker,
direct; three rounds), each turn's TTFT, tokens/s, decode-step medians
and prefill dispatches logged, and the port's codec is timed per frame.

The decode A/B (part of the whole check; alone with --decode-ab) serves
the five requests on a bf16 cache in one process by a lockstep engine
with single eager decode steps and by a default engine on graphs (same
weights, own caches), in turns (lockstep, default, default, lockstep;
two rounds): TTFT per request, decode tokens/s, the median dispatch gap
per burst and per token, the device's busy share of a profiled turn and
device operations per decode token.

The fused A/B (part of the whole check; alone with --fused-ab) serves
the five requests on a bf16 cache at llama-8b width and depth by two
default engines with the same weights: sampling_epilogue "off" and
"fused" (the final projection streamed in vocab tiles into the
sampler's statistics inside every captured program), in turns (off,
fused, fused, off; two rounds): each path's warm-up captures, a replayed
k = 8 burst against the eager one with its time and device operations
per decode token, per turn TTFT, decode tokens/s and the decode gap per
token, and the epilogue's bound.  Greedy streams must be equal, except
where they part at a near-tie: the off logits' top-2 gap at that token
(recomputed) within the largest tile-vs-full logit difference measured.

The prefill A/B (part of the whole check; alone with --prefill-ab)
serves the five requests on a bf16 cache by two default engines with
the same weights, packed prefill eager (TorchEngine(prefill_graphs=
False)) and on graphs, in turns (eager, graph, graph, eager; two
rounds): TTFT per request, the time from a warm run's start to its first
prefill record, the host time to dispatch one prefill, decode tokens/s,
and device operations per prefill token; streams must be equal.

The disagg phase (part of the whole check; alone with --disagg): a
prefill and a decode TorchEngineWorker (role "prefill" and "decode") in
one process at llama-8b width and depth, one set of weights, routed by
hand as the JAX frontend's PrefillOrchestrator routes; per tier (the
in-process broker, and host-staged frames over the request plane with
the broker lookup off) the five requests one at a time, whose streams
must equal an aggregated TorchEngine's (a parting only at a near-tie),
with no prefill on the decode worker, exactly the expected blocks
pulled, no parked KV left and one request's injected blocks bit-equal
to the sender's; then the five at once (TTFT through the pair against
the aggregated engine's), pull GB/s per tier, the host chunk bound, and
gather/inject GB/s against their byte bound; then one request through
an int8 pair against an aggregated int8 engine.

The pair across two processes (part of the whole check after the disagg
phase; alone with --disagg-ipc): a prefill worker process started with
`python -m dynamo_tpu_torch.engine --role prefill` (llama-8b at full
width and depth, random weights from seed 0, a bf16 cache of 512
blocks) and a decode TorchEngineWorker in this process, both opted in to
the device tier (DYN_KV_TRANSFER_SERVER=1), on file discovery under a
temporary directory with the in-process event plane.  The five requests
one at a time in turns (CUDA IPC, host-staged, host-staged, CUDA IPC;
the host-staged turns take the opt-in away from this process only):
every pull of an IPC turn moves device chunks only, streams equal the
aggregated engine's, landed blocks bit-equal across the turns over the
prompts' positions, no program built while serving, the prefill process
drops no staged chunk at its drain and exits 0 on SIGTERM; GB/s per tier
(from each pull's source to its last inject, and of pull time) beside
the broker's, a device chunk's RPC, event wait and copy, TTFT.

The KVBM phase (part of the whole check; alone with --kvbm): llama-8b
at full width and depth, a 64-block G1 with the offload watermark at the
pool, prompt A (1800 tokens, 14 full blocks) and five distinct
1800-token churn prompts that push A out of G1 (each engine its own
cache and temp directories): a reference without KVBM whose repeat of A
is a G1 prefix hit; G2 (pinned host memory) against the recompute
baseline in turns; G3 (a disk directory under $TMPDIR, its file system
printed); G4 (an object store directory); G2 on an int8 cache against
an int8 reference; and the cross-worker pull between two workers.  Each
onboarded repeat must onboard all 14 blocks from the named tier, prefill
at most 8 tokens, stream the reference repeat's tokens and hold prefix
blocks bit-equal to the reference's; no program is captured while
serving.  It prints the repeat's TTFT per tier against the recompute,
the churn's decode tokens/s with KVBM on and off, the scheduler's
seconds in offload passes, the gather's GB/s against its byte bound,
device-to-host GB/s against one contiguous pinned copy, the onboard's
upload + inject GB/s, G3 write and read GB/s, the pull's GB/s and the
pinned bytes of G2.

The spec phase (part of the whole check; alone with --spec): llama-8b at
full width and depth, random bf16 weights from seed 0, bf16 caches of 512
blocks; the five requests plus two repetition prompts (a 64-token random
pattern repeated 8 times, 64 greedy tokens).  A spec-off and an n-gram
engine (spec_k 4, both warmed up) serve them in turns (off, ngram, ngram,
off): streams must be equal except at a near-tie, the n-gram engine must
verify drafts, each verify bucket's program (8, 16, 32) must be captured
once by warm-up and never while serving, and a replayed verify bucket
must be bit-equal to its eager body; it prints TTFT, decode tokens/s,
proposed/accepted, each verify dispatch's device time (CUDA events) and
K3's launches per verify dispatch.  Then llama-8b as its own draft
(weights from the same seed, checked equal): streams equal spec-off
except at a near-tie, at least half the drafts accepted, nothing
captured while serving, every catch-up from the captured catch-up
program of its bucket; tokens/s and the catch-up's dispatches, host
time, device time (CUDA events) and K3 launches, and the one-token
catch-ups' device time against a speculation round.  Then one repetition request with
n-gram on an int8 cache against the int8 spec-off stream.

The LoRA and guided phase (part of the whole check; alone with --lora):
llama-8b at full width and depth, random bf16 weights from seed 0, bf16
caches of 512 blocks; three PEFT adapters (ranks 8, 16 and 8, all four
attention targets) written to $TMPDIR with the standard library.  A
bank-less engine and a LoRA engine (lora_max_adapters 4, lora_rank 16):
the five requests, all base, bit-equal on both; the mixed batch (base,
ad1, ad2, ad1) against the same prompts on the bank-less engine in
turns (off, lora, lora, off), each stream equal to the request served
alone (a parting only at a near-tie of its own logits) and each adapter
stream unlike the base one; no program captured while serving; a
replayed burst on slots 0/1/2/1 bit-equal to its eager body; each
adapter's first-token logits from the prefill program within 2e-2
(per-row relative L2) of a plain fp32 forward; device operations per
decode token with and without the bank, the operations a decode program
dispatches (the bank-less count equal to the default engine's) and the
delta's device time a step.  An engine
with lora_max_adapters 2 evicts the least recently used adapter for a
third, whose stream must equal the 4-slot engine's.  Guided decoding on
the bank-less engine: three guided requests (greedy, and two seeded
alike at T 0.7) beside two unguided ones, 64 tokens each; schema-valid
documents under the byte mock, equal seeded outputs, unguided streams
equal to their solo run, both top-M programs built by warm-up only, a
replayed M = 32 program bit-equal to its eager body; guided tokens/s, a
top-M program's device time, a guided step's host time, the guided
counters.

The checkpoint phase (alone with --checkpoint): the synthesized
checkpoint (two shards, config.json, tokenizer.json, a chat template)
is loaded by TorchEngine(EngineConfig(model_path=...)) on the card,
every parameter held bit for bit to the tensors written, the load timed
from disk (page cache dropped first) and from the weight cache in turns
with its GB/s, the five requests served (greedy streams equal to an
engine given the written tensors as params), and one request served
through a TorchEngineWorker whose MDC must carry the inline tokenizer
and the chat template.

The MLA phase (after the checkpoint phase in the whole check; alone
with --mla): deepseek-v2-lite at its published widths and full depth
(d 2048, 27 layers, 16 heads, kv_lora_rank 512, qk_nope 128, qk_rope
64, v_head 128, the first layer dense with ffn 10944, then 64 routed
experts of ffn 1408, top 6, plus 2 shared; vocab 102400), 15.7 B
random bf16 parameters made on the card from seed 0, a 512-block bf16
latent cache (31,104 bytes a token against llama-8b's 131,072), the
llama-8b runs' scheduler and the same five requests, dense dispatch.
The gates: every decode program and every padded (rows, bucket) shape
built once by warm-up and never while serving, no packed, verify or
catch-up program built, no GQA kernel launched; the greedy streams
equal to an engine running the same programs eagerly but at a logit
or router near-tie (`_near_tie`, the teacher-forced replay's two paths
the prompt in one chunk and in 512-token chunks); one layer's MLA
attention in bf16 within 2e-2 (per-row relative L2) of fp32, prefill
(non-absorbed, T = 2048 after 1024 cached tokens) and decode
(absorbed), with a planted foreign block above it; the absorbed decode
within 1e-4 of a materialised non-absorbed oracle in fp32; one request
through a TorchEngineWorker asked for int8 and the fused epilogue whose
MDC advertises bf16 and "off".  It prints TTFT and decode tokens/s, a
replayed k = 8 burst against its byte bound (obs/costs.py's MLA terms),
operations per decode token, a padded 1 x 2048 dispatch's device and
host time against its FLOP bound, the device split of both under
torch.profiler (MLA attention, the q/kv projections, expert GEMMs,
shared experts, router and glue, dense matmuls, other), the phase's
seconds and its max_memory_allocated; it frees its memory before the
MoE phase.

The MoE phase (last in the whole check; alone with --moe): mixtral-8x7b
at full width (d 4096, 32/8 heads, ffn 14336, 8 experts, top 2, vocab
32000) with its depth cut to MOE_LAYERS = 16 of 32 (the 32 layers hold
93.4 GB of bf16 weights, more than the card's 80 GB; 16 hold 46.97 GB),
random bf16 weights made on the card from seed 0, a bf16 cache of 512
blocks.  Dense dispatch on the default scheduler and graphs: the five
requests (every program captured once by warm-up and never while
serving, a replayed k = 8 burst and a replayed 2048 bucket equal to
their eager bodies, K1 and K3 launched), greedy streams equal to an
engine on the same weights with the plain attention versions except at
a near-tie; one MoE layer at T = 2048 in dense dispatch and in dropless
capacity dispatch (capacity factor E/k) within 2e-2 (per-row relative
L2) of an fp32 forward; capacity dispatch (the padded programs, eager,
no packed program built, K3 never launched) at E/k with greedy streams
equal to the dense engine's except at a near-tie, and at the default
1.25 with its tokens/s, TTFT and a padded dispatch's host and device
time; one request through a TorchEngineWorker (stream, MDC, launches).
It prints TTFT and decode tokens/s, a burst's replay against its byte
bound, operations per decode token, a 2048 bucket's device time against
its FLOP bound, the device time by family under torch.profiler (expert
GEMMs, the MoE dispatch/combine products, the router and its glue, K1,
K3, the dense matmuls, other) and the phase's seconds.

Bounds use the H100 SXM data sheet (3.35 TB/s HBM3, 989 TFLOP/s dense
bf16); a card run below its 700 W limit is slower, so its limit is
printed beside every number.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import os
import struct
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# fp32 outside the tensor cores (TF32 is off here): MLA's fp32 attention
FP32_FLOPS_PER_S = 67e12
# Tolerance of a kernel against its plain version, per output row (one
# token's one head, hd values): the relative L2 error ||out - ref|| /
# ||ref||.  The plain version runs with round_scaled_q=True, so it rounds
# q * 1/sqrt(hd) to bf16 as the kernels do; what remains is the kernel's
# bf16 rounding of the softmax weights before P.V, its summation order
# and both outputs' bf16 rounding (2^-9 relative each).  A row's output
# shrinks like 1/sqrt(context) with random inputs, so an absolute bound
# would be loose on long rows; a relative one is not.  REL_TOL lies
# between the largest error of the sound kernels and the smallest error
# of planted faults (a context block read from another sequence, one
# position past a row's end and, on an int8 cache, a block's scale rows
# read from another block), which every run measures again and requires
# to exceed it.  The int8 kernels compute their plain version up to the
# bf16 rounding of their P operand, P * v_scale, the same size of error.
REL_TOL = 1e-2
# whole-model agreement of the kernel path with the plain path: 32 bf16
# layers of random weights amplify per-layer rounding, so the bound is on
# direction (cosine) and on the argmax, unless the plain path's own top-2
# gap is smaller than the largest logit difference (a near-tie)
MIN_COSINE = 0.999


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest relative L2 error ||out - ref|| / ||ref|| over the rows of
    the last dimension whose reference is not all zero."""
    out, ref = out.float(), ref.float()
    den = ref.norm(dim=-1)
    live = den > 0
    return ((out - ref).norm(dim=-1)[live] / den[live]).max().item()


def hold_to_plain(name: str, out, ref, faults: dict) -> tuple:
    """(max_abs_err, max_rel_err) of a kernel's output against its plain
    version; exits unless the relative error is inside REL_TOL and every
    planted fault (name -> the plain version's output on faulty inputs)
    errs by more than REL_TOL, so the bound would catch it."""
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref)
    seen = {f: row_rel_err(o, ref) for f, o in faults.items()}
    log(f"{name}: max row relative error {rel:.3e} (limit {REL_TOL}), "
        f"max_abs_err {err:.3e}; planted faults' max row relative error: "
        + "; ".join(f"{f} {e:.3e}" for f, e in seen.items()))
    if min(seen.values()) <= REL_TOL:
        raise SystemExit(f"{name}: a planted fault passes the tolerance")
    if not rel <= REL_TOL:
        raise SystemExit(f"{name} disagrees with its plain version")
    return err, rel


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, by CUDA events around `iters` calls issued
    from the host (for the plain versions, which cannot be captured in a
    CUDA graph: the packed one synchronizes on torch.nonzero)."""
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


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call without host overhead: `calls` calls
    captured in one CUDA graph, CUDA events around `replays` replays.
    (A host loop of a kernel whose launch takes less device time than its
    Python wrapper takes on the host would measure the wrapper.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call with GQA heads (k/v keep
    their kv heads), as a thunk for the timers."""
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    """The three sources, one nvcc each, started together: K1's and K3's
    libraries hold their kernel's bf16 and int8 entry points, K4's its
    gather and sequential walks.  Logs each instantiation's registers and
    spills (ptxas) and, for K1/K3, the shared memory a CTA asks for."""
    import re

    from dynamo_tpu_torch.bench import bench_dma_layouts as k4
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
    from dynamo_tpu_torch.ops import cuda_paged_attention as k1

    t0 = time.perf_counter()
    logs = _build.compile_sources([k1.KERNEL, k3.KERNEL, k4.KERNEL])
    dt = time.perf_counter() - t0
    _build.load_library(k4.KERNEL, k4._SIGNATURES)
    fn = None
    for line in logs[k4.KERNEL].splitlines():
        m = re.search(r"Compiling entry function .*(walk|reduce)_kernel",
                      line)
        if m:
            fn = f"{k4.KERNEL} {m.group(1)}_kernel"
        elif fn and ("registers" in line or "spill" in line):
            log(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    for mod in (k1, k3):
        lib = _build.load_library(mod.KERNEL, mod._SIGNATURES)
        smem = getattr(lib, f"{mod.KERNEL}_smem_bytes")
        fn = None
        for line in logs[mod.KERNEL].splitlines():
            m = re.search(r"Compiling entry function .*ILi(\d+)ELb(\d)E", line)
            if m:
                hd, q8 = int(m.group(1)), int(m.group(2))
                fn = (f"{mod.KERNEL} hd={hd} {'int8' if q8 else 'bf16'} "
                      f"(smem {smem(hd, q8)} B a CTA)")
            elif fn and ("registers" in line or "spill" in line):
                log(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
            elif "Performance" in line or "warning" in line.lower():
                log(f"  ptxas {mod.KERNEL}: {line.strip()}")
    log(f"build: {k1.KERNEL}.cu, {k3.KERNEL}.cu and {k4.KERNEL}.cu for "
        f"sm_90a in {dt:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------


def _random_cache(gen, L, nkv, nb, bs, hd, device):
    k = torch.randn(L, nkv, nb, bs, hd, generator=gen, device=device)
    v = torch.randn(L, nkv, nb, bs, hd, generator=gen, device=device)
    # block 0 is the garbage block: junk that must never reach a result
    k[:, :, 0] *= 50.0
    v[:, :, 0] *= 50.0
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


# per-block magnitude spread of the int8 checks' K and V, as powers of 10:
# K by 0.7-1.4 and V by 0.32-3.2 (log-uniform).  Wider K spreads make a
# few positions take all of the softmax and wider V spreads let a small
# block drown in large ones; both would hide the read one position past
# a row's end (measured with the plain versions: V by 0.1-10 brought it
# down to 1.1e-2, at the tolerance)
INT8_SPREAD = (0.15, 0.5)


def _int8_cache(kc, vc, seed: int):
    """An int8 cache (k, v, k_scale, v_scale) quantized by the port's
    quantize_tokens from bf16 caches, each block's K/V first scaled by a
    factor drawn (numpy, from `seed`) within INT8_SPREAD, so that the
    magnitudes of blocks differ and a scale row read from another layer,
    head or block shows in the output."""
    from dynamo_tpu_torch.quant.kv import quantize_tokens

    rng = np.random.default_rng(seed)
    out = []
    for c, r in zip((kc, vc), INT8_SPREAD):
        spread = torch.from_numpy(10.0 ** rng.uniform(-r, r, c.shape[:3]))
        out.append(quantize_tokens(
            c.float() * spread.float().to(c.device)[..., None, None]))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _plant_junk(cache, tails) -> tuple:
    """A copy of an int8 cache with junk where nothing may be read: codes
    of 127 and scales of 1e30 in the garbage block, and codes of -127 and
    NaN scales at the unwritten positions `tails` ((block, first unused
    offset) pairs)."""
    k, v, ks, vs = (t.clone() for t in cache)
    for c in (k, v):
        c[:, :, 0] = 127
    for s in (ks, vs):
        s[:, :, 0] = 1e30
    for blk, off in tails:
        for c in (k, v):
            c[:, :, blk, off:] = -127
        for s in (ks, vs):
            s[:, :, blk, off:] = float("nan")
    return k, v, ks, vs


def _junk_check(name: str, kernel, cache, tails, out) -> None:
    """The kernel's output on `cache` with junk planted in the garbage
    block and the unwritten tails must equal `out` bit for bit."""
    again = kernel(*_plant_junk(cache, tails))
    torch.cuda.synchronize()
    same = torch.equal(again, out)
    log(f"{name}: junk (codes +-127, scales 1e30 and NaN) in the garbage "
        f"block and {len(tails)} unwritten tails, output bit-identical: "
        f"{same}")
    if not same:
        raise SystemExit(f"{name}: junk in unread positions reached the "
                         "output")


# K1's cases: (tag, kv_lens).  B = 8 is the case earlier versions were
# timed at; B = 4 decodes the engine's four prompts at its max_num_seqs;
# B = 1 is one long row, whose splits alone must fill the card
DECODE_CASES = (("B=8", [1, 127, 128, 129, 2048, 700, 1500, 2047]),
                ("B=4", [1800, 500, 100, 37]),
                ("B=1", [2047]))
# K3's cases: (tag, segment lengths, prefix offsets, stream order).  The
# long stream: row 1 is empty (an interleaved empty row); the stream
# starts with row 2, so the first active (tile, segment) pair is not
# (0, 0); row 2 starts at a prefix offset of 300 cached positions; 1800 +
# 100 + 110 + 37 = 2047 real tokens and one padded; no boundary is a
# multiple of the 32-token tile.  The short stream: four 128-token
# prompts, T = 512.  The verify stream (speculative decoding's verify
# program): four rows of 5 tokens (last token + 4 drafts) after contexts
# of 1800, 500, 100 and 37 cached positions, T = 32: one 32-token tile at
# group 4, every segment shorter than a warpgroup's token rows and all
# four sharing the tile.
VERIFY_CASE = "verify T=32"
PACKED_CASES = (("T=2048", [1800, 0, 100, 110, 37], [0, 0, 300, 0, 0],
                 [2, 0, 3, 4], 2048),
                ("T=512", [128, 128, 128, 128], [0, 0, 0, 0], [0, 1, 2, 3],
                 512),
                (VERIFY_CASE, [5, 5, 5, 5], [1800, 500, 100, 37],
                 [0, 1, 2, 3], 32))


def decode_case(cfg, device, kv_lens, int8: bool) -> dict:
    """K1's inputs for one case: random bf16 caches (or their int8
    quantization) with junk in the garbage block, each row's blocks a
    random disjoint set, padded table entries on block 0."""
    nh, nkv, hd, bs = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 128
    B, mb, L, layer = len(kv_lens), 2048 // bs, 2, 1
    need = [-(-n // bs) for n in kv_lens]
    nb = 1 + sum(need)
    rng = np.random.default_rng(1)
    perm = rng.permutation(nb - 1) + 1
    tables = np.zeros((B, mb), np.int32)  # padded entries -> block 0
    off = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[off:off + n]
        off += n
    gen = torch.Generator(device=device).manual_seed(1)
    kc, vc = _random_cache(gen, L, nkv, nb, bs, hd, device)
    q = torch.randn(B, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    return dict(q=q, cache=_int8_cache(kc, vc, seed=3) if int8 else (kc, vc),
                tables=tables, tables_t=torch.from_numpy(tables).to(device),
                lens_t=torch.tensor(kv_lens, dtype=torch.int32,
                                    device=device),
                kv_lens=kv_lens, layer=layer, bs=bs, mb=mb, int8=int8)


def decode_call(mod, c: dict, cache=None):
    """A thunk of one call of K1's wrapper in module `mod` (this
    checkout's ops.cuda_paged_attention, or another checkout's)."""
    cache = c["cache"] if cache is None else cache
    fn = mod.paged_decode_int8 if c["int8"] else mod.paged_decode
    return lambda: fn(c["q"], *cache, c["layer"], c["tables_t"],
                      c["lens_t"])


def decode_bound(cfg, c: dict):
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    total = sum(c["kv_lens"])
    # bytes per position per kv head: bf16 rows, or int8 rows + a scale
    pos_bytes = (hd + 4) if c["int8"] else 2 * hd
    nbytes = (2 * total * nkv * pos_bytes + 2 * c["q"].numel() * 2
              + c["tables"].nbytes + 4 * len(c["kv_lens"]))
    return bound(nbytes, 4 * nh * hd * total) + (nbytes,)


def check_decode_kernel(cfg, device, int8: bool = False) -> dict:
    """K1 in its bf16 mode, or (int8) in its int8 mode on the same
    shapes with the cache quantized by the port's quantizer, at every
    case of DECODE_CASES; the first case is the one that carries the
    plain and library times."""
    from dynamo_tpu_torch.ops import cuda_paged_attention as k1
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_attention_decode_ref,
    )

    name, tag = ("paged_decode_int8", "K1-int8") if int8 else \
        ("paged_decode", "K1")
    entry = {"name": name, "route": "cuda",
             "source": "dynamo_tpu_torch/csrc/paged_decode.cu",
             "replaces": "dynamo_tpu/ops/pallas_paged_attention.py:300",
             "cases": {}}
    for ci, (case, kv_lens) in enumerate(DECODE_CASES):
        c = decode_case(cfg, device, kv_lens, int8)
        q, cache, tables, layer = c["q"], c["cache"], c["tables"], c["layer"]
        bs, mb, B = c["bs"], c["mb"], len(kv_lens)

        def plain(tables_t=c["tables_t"], lens=c["lens_t"], cc=cache):
            scales = dict(k_scale=cc[2], v_scale=cc[3]) if int8 else {}
            return paged_attention_decode_ref(q, cc[0], cc[1], layer,
                                              tables_t, lens,
                                              round_scaled_q=True, **scales)

        out = decode_call(k1, c)()
        torch.cuda.synchronize()
        splits = k1.decode_splits(B, cfg.n_kv_heads, mb, bs,
                                  torch.cuda.get_device_properties(
                                      device).multi_processor_count)
        log(f"{tag} {name} vs plain, {case}: nh={cfg.n_heads} "
            f"nkv={cfg.n_kv_heads} hd={cfg.head_dim} bs={bs} "
            f"kv_lens={kv_lens}, {splits} splits a row")
        # planted faults: the longest row reads a block from another row
        # (B = 1: another of its own blocks); the longest row shorter than
        # the table sees one position more; int8: the longest row's block
        # reads the scale rows of another block
        r = int(np.argmax(kv_lens))
        col = -(-kv_lens[r] // bs) // 2
        other = (tables[(r + 1) % B, 0] if B > 1 else tables[r, col - 1])
        wrong = c["tables_t"].clone()
        wrong[r, col] = int(other)
        longer = c["lens_t"].clone()
        rl = max((i for i, n in enumerate(kv_lens) if n < mb * bs),
                 key=lambda i: kv_lens[i])
        longer[rl] += 1
        faults = {"foreign block": plain(tables_t=wrong),
                  "one position past kv_len": plain(lens=longer)}
        if int8:
            faults["scale row of another block"] = plain(cc=_swap_scale_rows(
                cache, layer, tables[r, col], other))
        err, rel = hold_to_plain(f"{tag} {case}", out, plain(), faults)
        if int8:
            tails = [(tables[b, (n - 1) // bs], (n - 1) % bs + 1)
                     for b, n in enumerate(kv_lens) if n % bs]
            _junk_check(f"{tag} {case}", lambda *cc: decode_call(k1, c, cc)(),
                        cache, tails, out)
        ms = graph_time_ms(decode_call(k1, c))
        bound_ms, bound_by, nbytes = decode_bound(cfg, c)
        entry["cases"][case] = {"ms": ms, "bound_ms": bound_ms,
                                "max_rel_err": rel, "splits": splits}
        log(f"{tag} {case} time: kernel {ms:.4f} ms (graph replay), bound "
            f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB)")
        if ci:
            continue
        plain_ms = time_ms(plain, iters=5)
        # yardstick: SDPA over each row's context gathered (int8: and
        # dequantized to bf16) densely beforehand, padded to the table
        # width (B x mb*bs positions) and masked
        nkv, hd, S = cfg.n_kv_heads, cfg.head_dim, mb * bs
        dense = [_dense(cc, s, layer, c["tables_t"].long())
                 .reshape(nkv, B, S, hd).transpose(0, 1).contiguous()
                 for cc, s in ((cache[0], cache[2] if int8 else None),
                               (cache[1], cache[3] if int8 else None))]
        mask = (torch.arange(S, device=device)[None, :]
                < c["lens_t"][:, None]).reshape(B, 1, 1, S)
        library_ms = graph_time_ms(sdpa(q.reshape(B, cfg.n_heads, 1, hd),
                                        *dense, mask))
        # what SDPA's padded bf16 input alone takes to read at the memory rate
        sdpa_bytes_ms = 2 * B * S * nkv * hd * 2 / HBM_BYTES_PER_S * 1e3
        log(f"{tag} {case} times: plain {plain_ms:.4f} ms (host loop), sdpa "
            f"{library_ms:.4f} ms (graph replay; it reads the padded {B}x{S} "
            f"positions{', dequantized to bf16 beforehand' if int8 else ''}, "
            f"{sdpa_bytes_ms:.4f} ms at the memory rate, against "
            f"{sum(kv_lens)} real ones{' in int8' if int8 else ''})")
        entry.update({"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms})
    entry["max_rel_err"] = max(v["max_rel_err"]
                               for v in entry["cases"].values())
    return entry


def _swap_scale_rows(cache, layer: int, blk: int, other: int) -> tuple:
    """A copy of an int8 cache whose block `blk` has block `other`'s scale
    rows in `layer` (the planted fault of a wrong scale index)."""
    k, v, ks, vs = cache
    ks, vs = ks.clone(), vs.clone()
    ks[layer, :, int(blk)] = ks[layer, :, int(other)]
    vs[layer, :, int(blk)] = vs[layer, :, int(other)]
    return k, v, ks, vs


def _dense(cache, scale, layer: int, *index) -> torch.Tensor:
    """cache[layer][:, *index] in bf16, dequantized when `scale` is given
    (the yardstick's input, made before it is timed)."""
    g = cache[layer][(slice(None), *index)]
    if scale is None:
        return g
    s = scale[layer][(slice(None), *index)]
    return (g.float() * s[..., None]).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# phase 4: K3 against its plain version
# ---------------------------------------------------------------------------


def packed_case(cfg, device, lens, ctx0, order, T, int8: bool) -> dict:
    """K3's inputs for one case: the packed stream of `lens` tokens per
    segment row (at prefix offsets `ctx0`, in stream `order`, padded to
    T), random caches (or their int8 quantization) with junk in the
    garbage block, each row's blocks a random disjoint set."""
    nh, nkv, hd, bs = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 128
    mb, L, layer = 2048 // bs, 2, 1
    S = len(lens)
    seg_ids = np.zeros(T, np.int32)
    positions = np.zeros(T, np.int32)
    valid = np.zeros(T, bool)
    off = 0
    for s in order:
        n = lens[s]
        seg_ids[off:off + n] = s
        positions[off:off + n] = ctx0[s] + np.arange(n)
        valid[off:off + n] = True
        off += n
    need = [-(-(c + n) // bs) if n else 0 for c, n in zip(ctx0, lens)]
    nb = 1 + sum(need)
    rng = np.random.default_rng(2)
    perm = rng.permutation(nb - 1) + 1
    tables = np.zeros((S, mb), np.int32)
    o = 0
    for s, n in enumerate(need):
        tables[s, :n] = perm[o:o + n]
        o += n
    gen = torch.Generator(device=device).manual_seed(2)
    kc, vc = _random_cache(gen, L, nkv, nb, bs, hd, device)
    q = torch.randn(T, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    return dict(q=q, cache=_int8_cache(kc, vc, seed=4) if int8 else (kc, vc),
                args=[torch.from_numpy(a).to(device)
                      for a in (tables, seg_ids, positions, valid)],
                tables=tables, seg_ids=seg_ids, positions=positions,
                valid=valid, lens=lens, ctx0=ctx0, layer=layer, bs=bs,
                int8=int8)


def packed_call(mod, c: dict, cache=None, plan=None):
    """A thunk of one call of K3's wrapper in module `mod` (this
    checkout's ops.cuda_packed_prefill, or another checkout's), with a
    precomputed tile plan when `plan` is given."""
    cache = c["cache"] if cache is None else cache
    fn = mod.packed_prefill_int8 if c["int8"] else mod.packed_prefill
    kw = {} if plan is None else {"plan": plan}
    return lambda: fn(c["q"], *cache, c["layer"], *c["args"], **kw)


def packed_plan_call(mod, cfg, c: dict):
    """A thunk computing K3's tile plan for case `c`, as
    models/llama.py does once per packed dispatch."""
    tables_t, seg_t, pos_t, val_t = c["args"]
    return lambda: mod.packed_prefill_plan(seg_t, pos_t, val_t, tables_t,
                                           cfg.n_heads, cfg.n_kv_heads,
                                           c["bs"])


def packed_bound(cfg, c: dict):
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    ctx = c["positions"][c["valid"]].astype(np.int64) + 1
    kv_pos = sum(a + n for a, n in zip(c["ctx0"], c["lens"]))
    pos_bytes = (hd + 4) if c["int8"] else 2 * hd
    T = c["q"].shape[0]
    nbytes = 2 * kv_pos * nkv * pos_bytes + 2 * c["q"].numel() * 2 \
        + c["tables"].nbytes + 9 * T
    return bound(nbytes, 4 * nh * hd * int(ctx.sum()))


def check_prefill_kernel(cfg, device, int8: bool = False) -> dict:
    """K3 in its bf16 mode, or (int8) in its int8 mode on the same
    streams with the cache quantized by the port's quantizer, at every
    case of PACKED_CASES; the first case carries the plain and library
    times, and the verify case has its own under `cases`.  `ms` is the kernel alone, with the tile plan computed
    beforehand as models/llama.py does once per dispatch; `plan_ms` is
    the plan alone and `with_plan_ms` a call that computes its own."""
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
    from dynamo_tpu_torch.ops.packed_prefill import (
        packed_prefill_attention_ref,
    )

    name, tag = ("packed_prefill_int8", "K3-int8") if int8 else \
        ("packed_prefill", "K3")
    entry = {"name": name, "route": "cuda",
             "source": "dynamo_tpu_torch/csrc/packed_prefill.cu",
             "replaces": "dynamo_tpu/ops/pallas_packed_prefill.py:195",
             "cases": {}}
    for ci, (case, lens, ctx0, order, T) in enumerate(PACKED_CASES):
        c = packed_case(cfg, device, lens, ctx0, order, T, int8)
        q, cache, args, layer = c["q"], c["cache"], c["args"], c["layer"]
        tables, bs, S = c["tables"], c["bs"], len(lens)

        def plain(tables_t=args[0], positions_t=args[2], cc=cache):
            scales = dict(k_scale=cc[2], v_scale=cc[3]) if int8 else {}
            return packed_prefill_attention_ref(q, cc[0], cc[1], layer,
                                                tables_t, args[1],
                                                positions_t, args[3],
                                                round_scaled_q=True,
                                                **scales)

        plan = packed_plan_call(k3, cfg, c)()
        out = packed_call(k3, c, plan=plan)()
        torch.cuda.synchronize()
        tail_zero = bool((out[~args[3]] == 0).all())
        log(f"{tag} {name} vs plain, {case}: rows={lens} prefix={ctx0} "
            f"stream order={order}, {plan.token_block}-token tiles, padded "
            f"tail exactly 0: {tail_zero}")
        if not tail_zero:
            raise SystemExit(f"{tag} {case}: the padded tail is not 0")
        # planted faults: the longest row reads one of its blocks from
        # the last row; its last token sees one position past its causal
        # frontier; int8: that block reads the last row's scale rows
        r = int(np.argmax(lens))
        col = (ctx0[r] + lens[r] - 1) // bs // 2
        wrong = args[0].clone()
        wrong[r, col] = args[0][S - 1, 0]
        further = args[2].clone()
        further[int(np.flatnonzero((c["seg_ids"] == r)
                                   & c["valid"])[-1])] += 1
        faults = {"foreign block": plain(tables_t=wrong),
                  "one position past the causal frontier":
                      plain(positions_t=further)}
        if int8:
            faults["scale row of another block"] = plain(cc=_swap_scale_rows(
                cache, layer, tables[r, col], tables[S - 1, 0]))
        err, rel = hold_to_plain(f"{tag} {case}", out, plain(), faults)
        if int8:
            ends = {s: a + n for s, (a, n) in enumerate(zip(ctx0, lens)) if n}
            tails = [(tables[s, (e - 1) // bs], (e - 1) % bs + 1)
                     for s, e in ends.items() if e % bs]
            _junk_check(f"{tag} {case}",
                        lambda *cc: packed_call(k3, c, cc, plan)(), cache,
                        tails, out)
        ms = graph_time_ms(packed_call(k3, c, plan=plan))
        plan_ms = graph_time_ms(packed_plan_call(k3, cfg, c))
        with_plan_ms = graph_time_ms(packed_call(k3, c))
        bound_ms, bound_by = packed_bound(cfg, c)
        entry["cases"][case] = {"ms": ms, "plan_ms": plan_ms,
                                "with_plan_ms": with_plan_ms,
                                "bound_ms": bound_ms, "max_rel_err": rel}
        log(f"{tag} {case} times: kernel {ms:.4f} ms (graph replay, tile "
            f"plan computed beforehand), plan {plan_ms:.4f} ms, kernel "
            f"with its own plan {with_plan_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        if ci and case != VERIFY_CASE:
            continue
        plain_ms = time_ms(plain, iters=3, warmup=1)
        # yardstick: one SDPA call over every row's context gathered
        # (int8: and dequantized to bf16) densely beforehand, with the
        # segment-causal mask
        cols = [(s, p) for s in range(S) for p in range(ctx0[s] + lens[s])]
        col_seg = torch.tensor([s for s, _ in cols], device=device)
        col_pos = torch.tensor([p for _, p in cols], device=device)
        col_blk = torch.from_numpy(tables).to(device)[col_seg,
                                                      col_pos // bs].long()
        kd, vd = (_dense(cc, s, layer, col_blk, col_pos % bs).unsqueeze(0)
                  .contiguous()
                  for cc, s in ((cache[0], cache[2] if int8 else None),
                                (cache[1], cache[3] if int8 else None)))
        seg_t, pos_t, val_t = args[1].long(), args[2].long(), args[3]
        mask = ((seg_t[:, None] == col_seg[None, :])
                & (col_pos[None, :] <= pos_t[:, None]) & val_t[:, None])
        mask[~val_t, 0] = True  # padded rows attend somewhere (output unused)
        library_ms = graph_time_ms(sdpa(q.transpose(0, 1).unsqueeze(0), kd,
                                        vd, mask))
        log(f"{tag} {case} times: plain {plain_ms:.4f} ms (host loop), sdpa "
            f"{library_ms:.4f} ms (graph replay"
            f"{', context dequantized to bf16 beforehand' if int8 else ''})")
        entry["cases"][case].update(plain_ms=plain_ms, library_ms=library_ms,
                                    bound_by=bound_by)
        if ci:
            continue
        entry.update({"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                      "plan_ms": plan_ms, "with_plan_ms": with_plan_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms})
    entry["max_rel_err"] = max(v["max_rel_err"]
                               for v in entry["cases"].values())
    return entry


# ---------------------------------------------------------------------------
# phase 4b: K4a/K4b, the paged-gather bandwidth microbench
# ---------------------------------------------------------------------------

# K4's outputs are fp32 sums of the same bf16 values in another order:
# the per-row relative L2 error against the plain version stays near
# fp32 rounding; a block read in place of another's moves it to O(1)
DMA_REL_TOL = 1e-5
K4_REPLACES = {"gather_strided": "benchmarks/bench_dma_layouts.py:103",
               "gather_contig": "benchmarks/bench_dma_layouts.py:103",
               "seq": "benchmarks/bench_dma_layouts.py:151"}


def check_dma_kernels(device) -> list:
    """K4a (strided, contig) and K4b at the microbench's shapes.  The
    main path is the microbench's own measurement (bench_dma_layouts
    measure): the counts are set to 0 just before it and read just
    after.  Then each mode is held against its plain version (per-row
    relative error <= DMA_REL_TOL) with a planted fault (a chunk-first
    table entry naming another block; K4b: the chunks' second blocks) that
    must read above it, and the plain version and one PyTorch call are
    timed (index_select of the table's blocks once, a sum over the slab
    once: neither is like-for-like, the first writes its copy and the
    second reduces every element, each in one pass where the kernel makes
    REPS)."""
    from dynamo_tpu_torch.bench import bench_dma_layouts as k4

    x = k4.inputs(device)
    wrappers = {"strided": k4.gather_strided, "contig": k4.gather_contig,
                "seq": k4.seq}
    for fn in wrappers.values():
        fn.launches = 0
    measured = k4.measure(x)
    launches = {m: fn.launches for m, fn in wrappers.items()}
    spare = next(b for b in range(k4.NB)
                 if b not in set(x["tables"].tolist()))
    bad = x["tables"].clone()
    bad[k4.BPC] = spare  # the second chunk's first block
    plain = {
        "strided": (lambda t=x["tables"]:
                    k4.gather_ref(x["layer"], t, True)),
        "contig": (lambda t=x["tables"]:
                   k4.gather_ref(x["slab"], t, False)),
        "seq": lambda s=x["slab"]: k4.seq_ref(s)}
    faults = {"strided": plain["strided"](bad),
              "contig": plain["contig"](bad),
              "seq": k4.seq_ref(x["slab"][1:])}
    library = {
        "strided": lambda: torch.index_select(x["layer"], 1,
                                              x["tables"].long()),
        "contig": lambda: torch.index_select(x["slab"], 0,
                                             x["tables"].long()),
        "seq": lambda: torch.sum(x["slab"], dim=(0, 1), dtype=torch.float32)}
    lib_bytes = {"strided": 2 * k4.nbytes("strided") // k4.REPS,
                 "contig": 2 * k4.nbytes("contig") // k4.REPS,
                 "seq": k4.nbytes("seq") // k4.REPS}
    entries = []
    for mode, fn in k4.calls(x).items():
        name = wrappers[mode].__name__
        out, ref = fn(), plain[mode]()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = row_rel_err(out, ref)
        det = torch.equal(out, fn())
        fault = row_rel_err(faults[mode], ref)
        r = measured[mode]
        plain_ms = time_ms(plain[mode], iters=5)
        library_ms = time_ms(library[mode], iters=5)
        bound_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"K4 {name}: max row relative error {rel:.3e} (limit "
            f"{DMA_REL_TOL}), max_abs_err {err:.3e}, bit-identical on a "
            f"second call: {det}; planted fault reads {fault:.3e}; "
            f"{r['gb_per_s']:.1f} GB/s = {100 * r['share_of_peak']:.1f}% of "
            f"3.35 TB/s ({r['bytes'] / 1e9:.2f} GB in {r['ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms); plain {plain_ms:.4f} ms; PyTorch "
            f"call {library_ms:.4f} ms for {lib_bytes[mode] / 1e9:.2f} GB "
            f"= {lib_bytes[mode] / library_ms / 1e6:.1f} GB/s; main-path "
            f"launches {launches[mode]}")
        if not fault > DMA_REL_TOL:
            raise SystemExit(f"K4 {name}: the planted fault passes")
        if not (rel <= DMA_REL_TOL and det):
            raise SystemExit(f"K4 {name} disagrees with its plain version")
        if not launches[mode]:
            raise SystemExit(f"K4 {name} was not launched by the microbench")
        entries.append({
            "name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/dma_layouts.cu",
            "replaces": K4_REPLACES[name], "launches": launches[mode],
            "max_abs_err": err, "max_rel_err": rel, "ms": r["ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "gb_per_s": r["gb_per_s"],
            "share_of_peak": r["share_of_peak"]})
    return entries


# ---------------------------------------------------------------------------
# phase 5: the engine at full width
# ---------------------------------------------------------------------------


def _requests(vocab: int):
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (1800, 500, 100, 37)]
    # shares its first 1024 tokens (8 blocks) with the first prompt
    prompts.append(prompts[0][:1024] + rng.integers(0, vocab, 200).tolist())
    reqs = []
    for i, p in enumerate(prompts):
        sampled = i == 2
        reqs.append(PreprocessedRequest(
            token_ids=p, request_id=f"smoke-{i}",
            sampling=(SamplingOptions(temperature=0.8, top_p=0.9, seed=1234)
                      if sampled else SamplingOptions(temperature=0.0)),
            stop=StopConditions(max_tokens=32, ignore_eos=True)))
    return reqs


async def _serve(engine, reqs):
    """Send every request at once; per request (tokens, finish reason,
    time to first token, time of the last token)."""
    t0 = time.perf_counter()

    async def one(req):
        toks, finish, first = [], None, None
        async for out in engine.generate(req):
            if out.token_ids and first is None:
                first = time.perf_counter() - t0
            toks.extend(out.token_ids)
            finish = out.finish_reason
        return toks, finish, first, time.perf_counter() - t0

    return await asyncio.gather(*(one(r) for r in reqs))


def _compare_logits(params, cfg, device, kv_dtype: str) -> int:
    """One 512-token prompt's last-token logits, and the next decode
    step's, through the kernel path and the plain path on the card, on a
    cache of `kv_dtype` ("bf16" | "int8").  Returns the device operations
    (kernels, copies) that the kernel path's decode step launched."""
    from dynamo_tpu_torch.models import llama

    plain_cfg = dataclasses.replace(cfg, attn_impl="torch",
                                    packed_attn_impl="torch")

    def new_cache():
        if kv_dtype == "bf16":
            return tuple(torch.zeros(s, dtype=cfg.dtype, device=device)
                         for s in llama.kv_cache_shapes(cfg, 8, 128))
        return tuple(torch.zeros(s, dtype=torch.int8, device=device)
                     for s in llama.kv_cache_shapes(cfg, 8, 128)) + tuple(
            torch.zeros(s, device=device)
            for s in llama.kv_cache_scale_shapes(cfg, 8, 128))

    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, 512)
                            .astype(np.int32)).to(device)
    pos = torch.arange(512, dtype=torch.int32, device=device)
    seg = torch.zeros(512, dtype=torch.int32, device=device)
    valid = torch.ones(512, dtype=torch.bool, device=device)
    tables = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32, device=device)
    last = torch.tensor([511], dtype=torch.int32, device=device)
    res = {}
    nxt = torch.tensor([7], dtype=torch.int32, device=device)
    at = torch.tensor([512], dtype=torch.int32, device=device)
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        kv = new_cache()
        pre, _ = llama.prefill_packed(params, c, kv, toks, pos, seg, tables,
                                      last, valid)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            dec, _ = llama.decode(params, c, kv, nxt, at, tables, at)
            torch.cuda.synchronize()
        if name == "kernel":
            ops = sum(1 for e in prof.events()
                      if str(e.device_type).endswith("CUDA"))
        res[name] = (pre[0].float(), dec[0].float())
    for i, what in enumerate(("prefill", "decode")):
        a, b = res["kernel"][i], res["plain"][i]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        diff = (a - b).abs().max().item()
        top2 = torch.topk(b, 2).values
        gap = (top2[0] - top2[1]).item()
        same = int(a.argmax()) == int(b.argmax())
        ok = cos >= MIN_COSINE and (same or gap <= diff)
        log(f"logits {what}, {kv_dtype} cache, kernel path vs plain path "
            f"(512-token prompt): cosine={cos:.6f} (>= {MIN_COSINE}) top1 "
            f"equal={same} "
            f"max_abs_diff={diff:.4f} plain top-2 gap={gap:.4f} "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(f"kernel path and plain path disagree ({what})")
    log(f"one decode step (one sequence, {kv_dtype} cache, kernel path): "
        f"{ops} device operations launched")
    return ops


# the int8 run's memory budget for its cache, in GB
INT8_KV_HBM_GB = 4.5


def _engine_config(kv_dtype: str):
    """The engine runs' config: llama-8b at full width, four slots, a
    2048-token prefill budget; 512 blocks of bf16 cache, or an int8 cache
    sized by INT8_KV_HBM_GB."""
    from dynamo_tpu_torch.engine import EngineConfig

    size = (dict(kv_cache_dtype="int8", kv_hbm_gb=INT8_KV_HBM_GB)
            if kv_dtype == "int8" else dict(num_blocks=512))
    return EngineConfig(model="llama-8b", block_size=128,
                        max_blocks_per_seq=16, max_num_seqs=4,
                        max_batch_tokens=2048, max_prefill_seqs=4, seed=0,
                        **size)


@contextlib.contextmanager
def gc_pauses(into: list):
    """Record the duration of every garbage-collector pass inside the
    block into `into` (seconds): the scheduler thread stops with the
    interpreter while one runs."""
    t0 = []

    def cb(phase, info):
        if phase == "start":
            t0.append(time.perf_counter())
        elif t0:
            into.append(time.perf_counter() - t0.pop())

    gc.callbacks.append(cb)
    try:
        yield into
    finally:
        gc.callbacks.remove(cb)


def _log_programs(engine, what: str) -> dict:
    """Log the engine's decode programs after warm-up: how many times
    each (greedy, k) was built, the seconds each capture took and the
    graph pool's bytes; exit unless every rung was built exactly once."""
    g = engine.graphs
    want = {(gr, k): 1 for gr in (True, False)
            for k in engine._fuse_ladder()}
    log(f"{what}: decode programs built {sorted(g.counts.items())}; "
        f"capture s " + ", ".join(f"{'greedy' if gr else 'sampled'} k={k} "
                                  f"{t:.2f}" for (gr, k), t in
                                  sorted(g.capture_s.items()))
        + f"; graph pool {g.pool_bytes / 2**20:.0f} MiB")
    if g.counts != want:
        raise SystemExit(f"{what}: warm-up built {g.counts}, expected every "
                         f"rung once: {want}")
    return dict(g.counts)


def _log_prefill_programs(engine, what: str) -> dict:
    """Log the engine's packed-prefill programs after warm-up (one per
    bucket of the planner's ladder: the seven prefill_buckets of the
    default config): builds, capture seconds, graph pool bytes; exit
    unless every bucket was built exactly once."""
    g = engine.prefill_graphs
    want = {T: 1 for T in engine.config.prefill_buckets}
    log(f"{what}: prefill programs built {sorted(g.counts.items())}; "
        f"capture s " + ", ".join(f"T={T} {t:.2f}" for T, t in
                                  sorted(g.capture_s.items()))
        + f"; prefill graph pool {g.pool_bytes / 2**20:.0f} MiB")
    if g.counts != want or g.buckets != tuple(want):
        raise SystemExit(f"{what}: warm-up built prefill programs "
                         f"{g.counts}, expected every bucket once: {want}")
    return dict(g.counts)


def check_engine(device, card: str, kv_dtype: str = "bf16", params=None):
    """Serve the five requests through TorchEngine at full width on a
    cache of `kv_dtype` with the JAX engine's default scheduler
    (overlapped, bursts fused up to 8, pipeline depth 4, adaptive), the
    decode bursts replayed from CUDA graphs captured by warmup_decode:
    the bf16 run makes random weights, the int8 run takes them as
    `params` and sizes its cache from INT8_KV_HBM_GB.  Exits unless every
    program was captured once by warm-up and never again while serving,
    and a replayed burst equals the same burst run eagerly
    (check_graph_burst).  Returns (the main path's launch counts by
    kernel name, the engine, device operations of one decode step, (the
    second (warm) run's results, its decode bursts' _step_medians))."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.quant.kv import blocks_for_hbm_budget

    int8 = kv_dtype == "int8"
    cfg = _engine_config(kv_dtype)
    if int8:
        mc8 = cfg.resolve_model()
        per = {d: blocks_for_hbm_budget(llama, mc8, 128, d,
                                        int(INT8_KV_HBM_GB * 1e9))
               for d in ("bf16", "int8")}
        log(f"kv_hbm_gb={INT8_KV_HBM_GB}: blocks_for_hbm_budget gives "
            f"{per['bf16']} bf16 blocks and {per['int8']} int8 blocks of "
            f"128 (ratio {per['int8'] / per['bf16']:.3f})")
    # (decode, prefill) wrappers of this cache dtype; the other pair's
    # counts must stay 0 (no route from one dtype to the other's kernel)
    used = _kernels_of(kv_dtype)
    unused = _kernels_of("bf16" if int8 else "int8")
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, params=params, device=device)
    torch.cuda.synchronize()
    mc = engine.model_cfg
    log(f"engine ({kv_dtype} KV cache): llama-8b d={mc.d_model} "
        f"layers={mc.n_layers} heads={mc.n_heads}/{mc.n_kv_heads} "
        f"vocab={mc.vocab_size}, "
        f"{'weights of the bf16 run' if int8 else 'random bf16 weights'} "
        f"in {time.perf_counter() - t0:.1f} s, {cfg.num_blocks} KV blocks "
        f"of {cfg.block_size}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    t0 = time.perf_counter()
    engine.warmup_decode()
    log(f"engine ({kv_dtype}) warm-up in {time.perf_counter() - t0:.1f} s")
    built = _log_programs(engine, f"engine ({kv_dtype})")
    pbuilt = _log_prefill_programs(engine, f"engine ({kv_dtype})")
    reqs = _requests(mc.vocab_size)
    gc.collect()  # not the earlier phases' garbage in this one's runs
    pauses: list = []

    async def run():
        try:
            # the main path's run: counts set to 0 just before, read just
            # after, before any other launch
            for fn in (*used, *unused):
                fn.launches = 0
            first = await _serve(engine, reqs)
            counts = {fn.__name__: fn.launches for fn in (*used, *unused)}
            stats = dict(engine.metrics)
            await engine.clear_kv_blocks()
            engine.fpm.clear()
            # bursts dispatched before the first run's last finish was
            # read back: the device runs them before the next prefill
            tail = len(engine._inflight)
            w0 = time.monotonic()
            with gc_pauses(pauses):
                second = await _serve(engine, reqs)
            steps = _step_medians(engine.fpm)
            dispatches = _prefill_dispatches(engine.fpm, w0)
            await engine.clear_kv_blocks()
            n0 = used[0].launches
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                await _serve(engine, reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return (first, counts, stats, (second, steps), (dispatches, tail),
                    (prof, wall, used[0].launches - n0))
        finally:
            await engine.close()

    first, launches, stats, direct, (dispatches, tail), (prof, wall,
                                                         counted) = \
        asyncio.run(run())
    second = direct[0]
    for i, (toks, finish, ttft, _) in enumerate(first):
        log(f"  request {i}: prompt {len(reqs[i].token_ids)} tokens, "
            f"{len(toks)} out, finish={finish}, ttft={ttft:.3f} s")
    bad = [i for i, r in enumerate(first) if r[1] != "length"
           or len(r[0]) != 32]
    if bad:
        raise SystemExit(f"requests {bad} did not finish with 32 tokens")
    if engine.graphs.counts != built \
            or engine.prefill_graphs.counts != pbuilt:
        raise SystemExit(f"serving captured programs again: "
                         f"{engine.graphs.counts} after warm-up {built}; "
                         f"prefill {engine.prefill_graphs.counts} after "
                         f"{pbuilt}")
    log(f"three serving runs captured nothing more: {engine.graphs.counts}, "
        f"prefill {engine.prefill_graphs.counts}")
    L = mc.n_layers
    need_dec = L * stats["decode_steps"]
    need_pre = L * stats["prefill_steps"]
    dec, pre = (fn.__name__ for fn in used)
    log(f"engine launches in the first run: {dec} {launches[dec]} (>= "
        f"{need_dec} = {L} layers x {stats['decode_steps']} fused decode "
        f"steps in {stats['decode_bursts']} bursts, "
        f"{stats['cont_bursts']} of them continuations; replays counted "
        f"from their captures), {pre} {launches[pre]} (>= {need_pre} = "
        f"{L} x {stats['prefill_steps']} prefill dispatches); the other "
        "mode's " + ", ".join(f"{fn.__name__} {launches[fn.__name__]}"
                              for fn in unused))
    if launches[dec] < need_dec or launches[pre] < need_pre \
            or not need_dec:
        raise SystemExit("the engine did not run through both kernels")
    if any(launches[fn.__name__] for fn in unused):
        raise SystemExit(f"the {kv_dtype} engine launched the other "
                         "mode's kernels")
    if stats["cache_hit_tokens"] < 1024:
        raise SystemExit(f"prefix hit not taken: {stats['cache_hit_tokens']}")
    log(f"prefix cache: {stats['cache_hit_tokens']} tokens reused "
        "(request 4 shares 1024 tokens with request 0)")
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    same = all(first[i][0] == second[i][0] for i in greedy)
    log(f"second run, same requests after clearing the prefix cache: greedy "
        f"streams {greedy} identical: {same}; sampled stream identical: "
        f"{first[2][0] == second[2][0]}")
    if not same or first[2][0] != second[2][0]:
        raise SystemExit("streams are not reproducible")
    for name, res in (("first (cold)", first), ("second (warm)", second)):
        n, secs = _decode_rate(res)
        log(f"serving, {kv_dtype} cache, {name} run ({card}): ttft s per "
            f"request {[round(r[2], 4) for r in res]}, decode {n} tokens in "
            f"{secs:.3f} s = {n / secs:.1f} tokens/s aggregate "
            f"(max_num_seqs={cfg.max_num_seqs}, overlapped, CUDA graphs)")
    log(f"decode burst ms, second (warm) run, median by lanes (FPM gap_s): "
        f"{_fmt_steps(direct[1])}; its prefill dispatches (ms after the "
        f"start, rows, tokens): {dispatches}; it started behind {tail} "
        f"bursts of the first run still in flight; {len(pauses)} GC "
        f"passes during it, {1e3 * sum(pauses):.1f} ms in all, the "
        f"longest {1e3 * max(pauses, default=0.0):.1f} ms")
    seen = _device_breakdown(prof, wall)
    k1_seen = sum(1 for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and "paged_decode" in e.name)
    log(f"profiled run: {dec} counted {counted} launches (replays counted "
        f"from their captures), the profiler saw {k1_seen} K1 kernels"
        + ("" if seen else " (no device time seen)"))
    check_graph_burst(engine, device, kv_dtype)
    check_prefill_replay(engine, device, kv_dtype)
    ops = _compare_logits(engine.params, mc, device, kv_dtype)
    return ({fn.__name__: launches[fn.__name__] for fn in used}, engine, ops,
            direct)


def _burst_inputs(engine, device, seed: int) -> tuple:
    """A k = 8 burst's descriptor at B = max_num_seqs, every lane live,
    over blocks of random K/V (int8: random codes and scales): lane
    contexts 1800, 500, 100 and 37 (the engine's prompts).  Returns (the
    descriptor's host arrays, the block ids the lanes use)."""
    c = engine.config
    bs, B, mb = c.block_size, c.max_num_seqs, c.max_blocks_per_seq
    lens = [1800, 500, 100, 37][:B]
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = np.zeros((B, mb), np.int32)
    nxt = 1
    for b, n in enumerate(lens):
        need = -(-(n + 8) // bs)
        tables[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    blocks = torch.arange(1, nxt, device=device)
    kv = engine.kv
    for t in kv[:2]:
        shape = (t.shape[0], t.shape[1], len(blocks), *t.shape[3:])
        if t.dtype == torch.int8:
            vals = torch.randint(-127, 128, shape, generator=gen,
                                 device=device, dtype=torch.int8)
        else:
            vals = torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32).to(t.dtype)
        t[:, :, blocks] = vals
    for t in kv[2:]:
        shape = (t.shape[0], t.shape[1], len(blocks), t.shape[3])
        t[:, :, blocks] = 0.02 * torch.rand(shape, generator=gen,
                                            device=device) + 0.005
    a = engine.graphs.host_descriptor()
    a["tokens"][:] = np.random.default_rng(seed).integers(
        0, engine.model_cfg.vocab_size, B)
    a["positions"][:] = a["ctx_lens"][:] = lens
    a["tables"][:] = tables
    a["steps"][:] = 1
    a["valid"][:] = True
    return a, blocks


def check_graph_burst(engine, device, kv_dtype: str) -> dict:
    """A replayed k = 8 greedy burst at B = max_num_seqs against the same
    burst run eagerly (the program's body) on the same inputs: the
    tokens must be equal and the K/V the two wrote within K1's per-row
    tolerance.  Also times the replay and the sampled program's replay on
    the same lanes (CUDA events) and counts the device
    operations of the eager body (the kernels the graph holds) per
    decode token.  Uses blocks of random K/V: run after serving."""
    g, k = engine.graphs, 8
    a, blocks = _burst_inputs(engine, device, seed=11)
    kv = engine.kv
    saved = [t[:, :, blocks].clone() for t in kv]
    snap = g.snapshot()

    def written():
        return [t[:, :, blocks].clone() for t in kv]

    def reset():
        for t, s in zip(kv, saved):
            t[:, :, blocks] = s
        g.restore(snap)
        g.upload(a)

    reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eager = g.run_eager(True, k).clone()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    _device_breakdown(prof, wall, f"eager k={k} greedy burst body "
                                  f"({kv_dtype})")
    kv_eager = written()
    reset()
    replay = torch.from_numpy(g.run(True, k).wait().copy())
    kv_replay = written()
    same = torch.equal(eager.cpu(), replay)
    errs = [row_rel_err(r.float(), e.float())
            for r, e in zip(kv_replay, kv_eager)]
    diff = max((r.float() - e.float()).abs().max().item()
               for r, e in zip(kv_replay, kv_eager))
    def replay_ms(greedy: bool) -> float:
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            g.continuation(0)
            g.run(greedy, k)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 5

    burst_ms = replay_ms(True)
    # the sampled program on the same lanes, every one sampled
    a["temps"][:], a["top_ps"][:] = 0.8, 0.9
    sampled_ms = replay_ms(False)
    tokens = k * engine.config.max_num_seqs
    log(f"graph burst ({kv_dtype}): replayed k={k} greedy burst at B="
        f"{engine.config.max_num_seqs} equals the eager burst: tokens "
        f"{same}, K/V max row relative error {max(errs):.3e} (limit "
        f"{REL_TOL}), max abs diff {diff:.3e}; replay {burst_ms:.3f} ms = "
        f"{burst_ms / k:.3f} ms a step (the sampled program {sampled_ms:.3f} "
        f"ms = {sampled_ms / k:.3f} ms a step); the burst's eager body "
        f"launched {ops} device operations = {ops / tokens:.1f} per decode "
        f"token")
    for t, s in zip(kv, saved):
        t[:, :, blocks] = s
    g.restore(snap)
    if not same:
        diverge = (eager.cpu() != replay).nonzero().tolist()
        raise SystemExit(f"replayed burst differs from the eager one at "
                         f"(step, lane) {diverge}")
    if not max(errs) <= REL_TOL:
        raise SystemExit("replayed burst wrote other K/V than the eager one")
    return {"burst_ms": burst_ms, "sampled_ms": sampled_ms,
            "ops_per_token": ops / tokens}


def _prefill_descriptor(engine, T: int, rows, seed: int) -> dict:
    """Bucket T's host descriptor for `rows`: (stream offset, tokens,
    first position, block ids) per segment row, random prompt tokens;
    the rows after them stay padding.  Row 1, where there is one, is
    sampled (seed 1234, T 0.8, top-p 0.9)."""
    g = engine.prefill_graphs
    a = g.host_descriptor(T)
    rng = np.random.default_rng(seed)
    for r, (off, n, start, blocks) in enumerate(rows):
        a["toks"][off:off + n] = rng.integers(
            0, engine.model_cfg.vocab_size, n)
        a["positions"][off:off + n] = start + np.arange(n)
        a["seg_ids"][off:off + n] = r
        a["valid"][off:off + n] = True
        a["tables"][r, :len(blocks)] = blocks
        a["last_idx"][r] = off + n - 1
    if len(rows) > 1:
        a["seeds"][1], a["temps"][1], a["top_ps"][1] = 1234, 0.8, 0.9
    return a


# (bucket, rows) of check_prefill_replay: a full 2048-token bucket of two
# prompts (1800 and 200 tokens, rows 2-3 padding), and a 32-token bucket
# of one 20-token chunk after a 300-token prefix (rows 1-3 padding)
PREFILL_REPLAY_CASES = (
    (2048, ((0, 1800, 0, tuple(range(1, 16))), (1800, 200, 0, (16, 17)))),
    (32, ((0, 20, 300, (20, 21, 22)),)),
)


def check_prefill_replay(engine, device, kv_dtype: str) -> dict:
    """Each PREFILL_REPLAY_CASES bucket's replayed program against its
    eager body on the same descriptor: the first tokens and the
    last-position logits must be bit-equal (the K/V both write are the
    same values).  Times the replay and the eager body (CUDA events,
    5 calls each) and the host time to dispatch each.  Uses blocks 1-22
    of the cache: run after serving."""
    g = engine.prefill_graphs
    out = {}
    for T, rows in PREFILL_REPLAY_CASES:
        a = _prefill_descriptor(engine, T, rows, seed=T)
        g.upload(a)
        eager = g.run_eager(T).clone()
        eager_logits = g.logits[T].clone()
        g.upload(a)
        replay = g.run(T).clone()
        torch.cuda.synchronize()
        same = (torch.equal(replay, eager)
                and torch.equal(g.logits[T], eager_logits))
        times = {}
        for path, fn in (("replay", lambda: g.run(T)),
                         ("eager", lambda: g.run_eager(T))):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(5):
                fn()
            host = (time.perf_counter() - t0) / 5
            end.record()
            end.synchronize()
            times[path] = (start.elapsed_time(end) / 5, host * 1e3)
        n = sum(r[1] for r in rows)
        log(f"prefill graph ({kv_dtype}), bucket T={T}, {len(rows)} of "
            f"{g.rows} rows live ({n} tokens): replayed first tokens "
            f"{replay[:len(rows)].tolist()} and logits bit-equal to the "
            f"eager body: {same}; replay {times['replay'][0]:.3f} ms on the "
            f"device, {times['replay'][1]:.3f} ms on the host to dispatch; "
            f"eager body {times['eager'][0]:.3f} ms on the device, "
            f"{times['eager'][1]:.3f} ms on the host")
        if not same:
            raise SystemExit(f"prefill graph T={T}: the replay differs from "
                             f"the eager body: {replay.tolist()} against "
                             f"{eager.tolist()}, logits max diff "
                             f"{(g.logits[T] - eager_logits).abs().max()}")
        out[T] = times
    return out


def _decode_rate(res) -> tuple:
    """(decode tokens after each request's first, seconds from the first
    first token to the last token) of a _serve-shaped result."""
    t_first = min(r[2] for r in res)
    return (sum(len(r[0]) - 1 for r in res),
            max(r[3] for r in res) - t_first)


def _step_medians(records) -> dict:
    """{lanes: (median ms, steps)} of the decode steps' dispatch-to-
    dispatch gaps in FPM records: the host-bound step time by batch size,
    where a prefill dispatch between two steps falls out of the median
    (the aggregate tokens/s does not separate them)."""
    by: dict = {}
    for r in records:
        if r["kind"] == "decode" and r["gap_s"] > 0:
            by.setdefault(r["lanes"], []).append(r["gap_s"] * 1e3)
    return {k: (float(np.median(v)), len(v)) for k, v in sorted(by.items())}


def _prefill_dispatches(records, w0: float) -> list:
    """[ms after `w0` (time.monotonic), rows, tokens] of each packed
    prefill dispatch in FPM `records` after w0."""
    return [[round((r["t"] - w0) * 1e3, 1), r["rows"], r["tokens"]]
            for r in records if r["kind"] == "prefill" and r["t"] >= w0]


def _fmt_steps(steps: dict) -> str:
    return ", ".join(f"{k} lanes {ms:.2f} ms ({n} steps)"
                     for k, (ms, n) in steps.items())


# ---------------------------------------------------------------------------
# phase 6: the worker at full width
# ---------------------------------------------------------------------------


@contextlib.asynccontextmanager
async def _serving_worker(device, cfg, params, status: bool = False,
                          warmup: bool = True):
    """A TorchEngineWorker (config `cfg` with `warmup`, a fresh cache of
    its kind, weights `params`) on a fresh runtime of the port: mem
    discovery, in-process event plane, the TCP request plane on
    127.0.0.1.  With `status` the runtime also serves the system-status
    server on an ephemeral port with the admin token STATUS_TOKEN, and
    the worker's config carries this card's peaks (PEAK_TFLOPS,
    PEAK_HBM_GBPS) for the roofline gauges.  Yields (runtime, worker,
    generate client, seen), `seen` collecting every message on the
    worker's kv_events, load_metrics and fpm subjects under "kv", "load"
    and "fpm".  On exit closes the worker and exits unless its MDC left
    discovery."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    extra = (dict(system_port=-1, admin_token=STATUS_TOKEN) if status
             else {})
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc",
        tcp_host="127.0.0.1", **extra), cluster_id=uuid.uuid4().hex).start()
    if status:
        cfg = dataclasses.replace(cfg, peak_tflops=PEAK_TFLOPS,
                                  peak_hbm_gbps=PEAK_HBM_GBPS)
    t0 = time.perf_counter()
    worker = await TorchEngineWorker(
        rt, dataclasses.replace(cfg, warmup=warmup), params=params,
        device=device).start()
    log(f"worker ({cfg.kv_cache_dtype} KV cache): started "
        f"{'with' if warmup else 'without'} warm-up in "
        f"{time.perf_counter() - t0:.1f} s, {worker.config.num_blocks} KV "
        f"blocks, instance {worker.served.instance_id} @ "
        f"{worker.served.instance.address}")
    seen = {"kv": [], "load": [], "fpm": []}
    stop = asyncio.Event()

    async def listen(subject, into):
        async for _, msg in rt.event_plane.subscribe(subject, cancel=stop):
            into.append(msg)

    listeners = [asyncio.create_task(listen(f"{k}.dynamo.backend", seen[v]))
                 for k, v in (("kv_events", "kv"), ("load_metrics", "load"),
                              ("fpm", "fpm"))]
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    key = worker.card.key(worker.served.instance_id)
    try:
        await client.wait_for_instances()
        yield rt, worker, client, seen
    finally:
        stop.set()
        for t in listeners:
            t.cancel()
        await asyncio.gather(*listeners, return_exceptions=True)
        await client.close()
        await worker.close()
        gone = not await rt.discovery.get_prefix(key)
        worker.engine.kv = worker.engine.graphs = None
        worker.engine.prefill_graphs = worker.engine.guided_graphs = None
        await rt.shutdown()
        log(f"worker close(): MDC gone from discovery: {gone}")
        if not gone:
            raise SystemExit("the MDC outlived close()")


async def _serve_worker(client, reqs):
    """_serve through the request plane: every request sent at once as
    PreprocessedRequest.to_dict() by `client`."""
    t0 = time.perf_counter()

    async def one(req):
        toks, finish, first = [], None, None
        async for out in client.generate(req.to_dict()):
            if out.get("token_ids") and first is None:
                first = time.perf_counter() - t0
            toks.extend(out.get("token_ids", []))
            finish = out.get("finish_reason")
        return toks, finish, first, time.perf_counter() - t0

    return await asyncio.gather(*(one(r) for r in reqs))


# ---------------------------------------------------------------------------
# the worker's status plane (rides the bf16 worker phase; --status alone)
# ---------------------------------------------------------------------------

# the gauges' peaks: this card's specification (H100 SXM dense bf16 tensor
# cores and HBM3), the rates the kernel bounds above divide by
PEAK_TFLOPS = BF16_FLOPS_PER_S / 1e12
PEAK_HBM_GBPS = HBM_BYTES_PER_S / 1e9
STATUS_TOKEN = "chip-smoke-admin"
# K1's kernel symbol, as the profiler names its device events
K1_SYMBOL = "paged_decode_kernel"
# the span kinds the worker phase exercises (no speculation, guided
# decoding or KVBM tiers there)
STATUS_SPANS = ("step", "sched", "enqueue_ahead", "prefill_dispatch",
                "decode_dispatch", "device_wait", "worker_request",
                "compile")
# the keys of the JAX worker's /debug/state source
# (dynamo_tpu/engine/worker.py debug_state)
DEBUG_STATE_KEYS = ("kind", "instance_id", "namespace", "component",
                    "model", "role", "draining", "active_seqs", "waiting",
                    "slots", "tokens_in_flight", "kv", "kv_usage",
                    "kv_cache_dtype", "itl_ema_s", "itl_p95_s", "compile",
                    "engine_metrics", "config")
# the decode MBU gauge (window sums of the bursts' counted bytes over
# their gaps) and the smoke's own roofline (the median burst's bytes over
# its gap) must agree within this factor: they read 0.573 and 0.495
# (1.157x) on an H100 80GB HBM3 at 700 W: the gauge weighs each burst by
# its gap, so the k = 8 bursts (the most bytes a second) count most, where
# the median counts every burst once
MBU_AGREE = 1.5


async def _http(addr: str, path: str, method: str = "GET",
                token: Optional[str] = None, timeout: float = 60.0) -> tuple:
    """(status, body bytes) of one HTTP/1.1 request to `addr` (host:port)
    over asyncio streams (the card's machine has no HTTP client
    library)."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    head = f"{method} {path} HTTP/1.1\r\nHost: {addr}\r\n"
    if token:
        head += f"X-Dyn-Admin-Token: {token}\r\n"
    writer.write((head + "Content-Length: 0\r\n\r\n").encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), timeout)
    writer.close()
    hdr, _, body = data.partition(b"\r\n\r\n")
    return int(hdr.split(b" ", 2)[1]), body


def _parse_metrics(text: str) -> list:
    """[(sample name, {label: value}, value)] of a Prometheus text
    exposition (the port's renderer: labels without embedded commas)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        lab = {}
        for part in labels.rstrip("}").split('",'):
            if "=" in part:
                k, v = part.split("=", 1)
                lab[k] = v.strip('"')
        out.append((name, lab, float(value)))
    return out


def _sample(samples, name: str, **labels) -> Optional[float]:
    for n, lab, v in samples:
        if n == name and all(lab.get(k) == x for k, x in labels.items()):
            return v
    return None


def _weight_read_bytes(params, lanes: int) -> int:
    """The bytes of weights one decode step reads: every parameter but the
    embedding table, of which it looks up `lanes` rows."""
    emb = params["embedding"]
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    return total - emb.numel() * emb.element_size() \
        + lanes * emb.shape[1] * emb.element_size()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


async def _status_probes(rt, worker, seen) -> dict:
    """The status checks before the main run: /live and /health answer
    200 on the warm worker, /debug/state answers 401 without the token,
    and the instance advertises system_addr in discovery."""
    addr = rt.system_address
    live, _ = await _http(addr, "/live")
    health, body = await _http(addr, "/health")
    denied, _ = await _http(addr, "/debug/state")
    snap = await rt.discovery.get_prefix("v1/instances/dynamo/backend/")
    advertised = sorted({v["metadata"].get("system_addr", "")
                         for v in snap.values()})
    log(f"status server at {addr}: /live {live}, /health {health} "
        f"({json.loads(body)['status']}), /debug/state without the token "
        f"{denied}; instances advertise system_addr {advertised}")
    # 401: a token is configured and none was given (403 is JAX's answer
    # when no token is configured at all)
    if (live, health, denied) != (200, 200, 401) or advertised != [addr]:
        raise SystemExit("the status server's probes or system_addr failed")
    return {"addr": addr}


async def _poll_live(addr: str, stop: asyncio.Event, into: list) -> None:
    """/live every 0.1 s until `stop`; each status into `into`."""
    while not stop.is_set():
        into.append((await _http(addr, "/live"))[0])
        try:
            await asyncio.wait_for(stop.wait(), 0.1)
        except asyncio.TimeoutError:
            pass


def _burst_roofline(recs) -> tuple:
    """(median per-burst bytes/s of the decode records with a plausible
    gap, bursts): the smoke's own decode roofline."""
    rates = [r["xla_bytes"] / r["gap_s"] for r in recs
             if r["kind"] == "decode" and 0.0 < r["gap_s"] < 1.0]
    return (float(np.median(rates)) if rates else 0.0), len(rates)


async def _status_gauges(rt, worker, seen, recs) -> dict:
    """/metrics after the main run: the roofline gauges in (0, 1], the
    decode MBU against the smoke's own roofline, one compile sample per
    captured program and none while serving, a 4-lane decode program's
    counted bytes between the weights it reads and those plus a full
    table's KV, and load_metrics' kv_tier_costs ordered."""
    eng = worker.engine
    await asyncio.sleep(1.1)  # two load-loop ticks past the run
    status, body = await _http(rt.system_address, "/metrics")
    samples = _parse_metrics(body.decode())
    mbu = _sample(samples, "dynamo_engine_mbu", phase="decode")
    mfu = _sample(samples, "dynamo_engine_mfu", phase="prefill")
    mfu_dec = _sample(samples, "dynamo_engine_mfu", phase="decode")
    mbu_pre = _sample(samples, "dynamo_engine_mbu", phase="prefill")
    own, bursts = _burst_roofline(recs)
    own_mbu = own / HBM_BYTES_PER_S
    compiles = {lab["family"]: v for n, lab, v in samples
                if n == "dynamo_engine_compile_seconds_count"}
    built = {}
    for progs in eng._program_families():
        for key in progs.counts:
            fam = progs.watch_family(key)
            built[fam] = built.get(fam, 0) + 1
    serving = sum(v for n, _, v in samples
                  if n == "dynamo_engine_serving_compiles_total")
    B, mb = eng.config.max_num_seqs, eng.config.max_blocks_per_seq
    per_step = eng.graphs.costs[(True, 1)]["bytes"]
    weights = _weight_read_bytes(eng.params, B)
    mc = eng.model_cfg
    table_kv = (2 * B * mc.n_kv_heads * mb * eng.config.block_size
                * mc.head_dim * 2 * mc.n_layers)
    costs = next((m["kv_tier_costs"] for m in reversed(seen["load"])
                  if "kv_tier_costs" in m), None)
    log(f"/metrics ({status}, {len(samples)} samples): decode MBU "
        f"{mbu} against the smoke's own roofline {own_mbu:.4f} (median of "
        f"{bursts} bursts' counted bytes over their gaps; ratio "
        f"{(mbu or 0) / own_mbu if own_mbu else float('nan'):.3f}), decode "
        f"MFU {mfu_dec}, prefill MFU {mfu}, prefill MBU {mbu_pre} (peaks "
        f"{PEAK_TFLOPS:.0f} TFLOP/s, {PEAK_HBM_GBPS:.0f} GB/s); compile "
        f"samples by family {compiles} against programs built {built}; "
        f"serving compiles {serving}; a {B}-lane decode step counts "
        f"{per_step / 1e9:.3f} GB against {weights / 1e9:.3f} GB of weights "
        f"read and a full table's KV of {table_kv / 1e9:.3f} GB; "
        f"kv_tier_costs {costs}")
    if status != 200 or mbu is None or mfu is None:
        raise SystemExit("/metrics lacks the roofline gauges")
    if not (0.0 < mbu <= 1.0 and 0.0 < mfu <= 1.0):
        raise SystemExit(f"roofline gauges out of (0, 1]: MBU {mbu}, "
                         f"MFU {mfu}")
    if not own_mbu or not 1 / MBU_AGREE <= mbu / own_mbu <= MBU_AGREE:
        raise SystemExit(f"decode MBU {mbu} disagrees with the smoke's "
                         f"roofline {own_mbu} beyond {MBU_AGREE}x")
    if compiles != built or serving:
        raise SystemExit("compile records do not match the captured "
                         "programs, or a capture landed while serving")
    # what lies above weights + table is the step's K/V writes and its
    # fp32 logits rows (~2.6 MB at llama-8b, 4 lanes)
    if not weights + table_kv <= per_step <= 1.01 * (weights + table_kv):
        raise SystemExit(f"a decode step counts {per_step} bytes, outside "
                         f"[{weights + table_kv}] + 1%")
    if not (costs and costs["g1"] == 0.0 < costs["g2"] < costs["g3"]
            < costs["g4"]):
        raise SystemExit(f"kv_tier_costs missing or unordered: {costs}")
    return {"mbu_decode": mbu, "own_mbu_decode": own_mbu,
            "mfu_prefill": mfu, "mfu_decode": mfu_dec,
            "mbu_prefill": mbu_pre, "compiles": compiles,
            "decode_step_gb": per_step / 1e9, "weights_gb": weights / 1e9,
            "table_kv_gb": table_kv / 1e9, "kv_tier_costs": costs}


async def _status_debug(rt, worker, client, reqs) -> dict:
    """/debug/state with the token (the JAX keys), then /debug/profile for
    0.5 s while four long greedy streams decode: status "ok", a Chrome
    trace naming K1's kernel among its device events, and a device-memory
    snapshot."""
    addr = rt.system_address
    st, body = await _http(addr, "/debug/state", token=STATUS_TOKEN)
    state = json.loads(body)
    src = state["sources"].get(f"worker:{worker.served.instance_id}", {})
    missing = sorted(set(DEBUG_STATE_KEYS) - set(src))
    log(f"/debug/state with the token: {st}, source keys missing against "
        f"the JAX worker's: {missing}; flight recorder "
        f"{len(state['flight']['spans'])} spans")
    if st != 200 or missing or not state["flight"]["enabled"]:
        raise SystemExit("/debug/state failed")
    long = [dataclasses.replace(r, request_id=f"profiled-{i}",
                                stop=dataclasses.replace(r.stop,
                                                         max_tokens=200))
            for i, r in enumerate(reqs[:4])]
    first = asyncio.Event()
    n_first = []

    async def one(req):
        async for out in client.generate(req.to_dict()):
            if out.get("token_ids") and req.request_id not in n_first:
                n_first.append(req.request_id)
                if len(n_first) == len(long):
                    first.set()

    runs = [asyncio.create_task(one(r)) for r in long]
    await asyncio.wait_for(first.wait(), 60.0)
    t0 = time.perf_counter()
    st, body = await _http(addr, "/debug/profile?duration_s=0.5", "POST",
                           token=STATUS_TOKEN)
    took = time.perf_counter() - t0
    await asyncio.gather(*runs)
    prof = json.loads(body)
    k1 = kernels = 0
    if prof.get("status") == "ok":
        with open(prof["trace_file"]) as f:
            trace = json.load(f)
        for e in trace.get("traceEvents", []):
            if e.get("cat") == "kernel":
                kernels += 1
                k1 += K1_SYMBOL in e.get("name", "")
    mem = prof.get("memory_profile")
    snap = json.load(open(mem)) if mem else {}
    log(f"/debug/profile?duration_s=0.5 during decode: {st}, status "
        f"{prof.get('status')}, backend {prof.get('backend')}, {took:.2f} s, "
        f"{kernels} kernel events of which {k1} name {K1_SYMBOL}; memory "
        f"snapshot {mem}: {snap.get('mem_get_info')}, allocated "
        f"{snap.get('memory_stats', {}).get('allocated_bytes.all.current')}"
        f"; error {prof.get('error') or prof.get('memory_profile_error')}")
    if st != 200 or prof.get("status") != "ok" or not k1 \
            or "mem_get_info" not in snap:
        raise SystemExit("/debug/profile did not capture K1 and a memory "
                         "snapshot")
    return {"profile_kernels": kernels, "profile_k1": k1}


async def _tracing_ab(engine, reqs) -> dict:
    """The same five requests through the worker's engine, all sent at
    once with the prefix cache cleared first, with tracing off, on, on
    and off: the greedy streams must be equal in every round; decode
    tokens/s is printed."""
    from dynamo_tpu_torch import obs

    tr = obs.tracer()
    rates, streams = {"off": [], "on": []}, []
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    for mode in ("off", "on", "on", "off"):
        if mode == "off":
            tr.uninstall()
        else:
            tr.install()
        await engine.clear_kv_blocks()
        res = await _serve(engine, [dataclasses.replace(
            r, request_id=f"{r.request_id}-{mode}-{len(streams)}")
            for r in reqs])
        n, secs = _decode_rate(res)
        rates[mode].append(n / secs)
        streams.append([res[i][0] for i in greedy])
    tr.install()
    same = all(s == streams[0] for s in streams)
    log(f"tracing A/B (off, on, on, off), decode tokens/s: off "
        f"{[round(x, 1) for x in rates['off']]}, on "
        f"{[round(x, 1) for x in rates['on']]}; greedy streams equal in "
        f"every round: {same}")
    if not same:
        raise SystemExit("greedy streams differ with tracing on")
    return {"tokens_per_s": rates}


def _within(rows, t0: float, t1: float, tid=None) -> dict:
    """{span kind: us} of the `rows` (Chrome trace "X" events) that lie
    inside [t0, t1] (on track `tid` if given), clipped to it."""
    by: dict = {}
    for e in rows:
        if tid is not None and e["tid"] != tid:
            continue
        lo, hi = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if hi > lo:
            by[e["name"]] = by.get(e["name"], 0.0) + hi - lo
    return by


async def _status_trace(out_path: str) -> dict:
    """The Chrome trace the tracer dumps: every span kind the worker phase
    exercised; the median 4-lane step split by phase (decode_dispatch's
    own time is what its nested device_wait and enqueue_ahead leave); and
    for each request, the wait from its arrival (`worker_request` start)
    to the first packed prefill dispatch after it, split by what the
    scheduler track did meanwhile."""
    from dynamo_tpu_torch import obs

    path = obs.tracer().dump(out_path)
    with open(path) as f:
        doc = json.load(f)
    rows = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    kinds = {e["name"] for e in rows}
    missing = sorted(set(STATUS_SPANS) - kinds)
    steps = [e for e in rows if e["name"] == "step"
             and e["args"].get("active") == 4]
    split = []
    for st in steps:
        by = _within(rows, st["ts"], st["ts"] + st["dur"], st["tid"])
        by["decode_dispatch"] = by.get("decode_dispatch", 0.0) \
            - by.get("device_wait", 0.0) - by.get("enqueue_ahead", 0.0)
        split.append((st["dur"], by))
    med = {}
    if split:
        med["step"] = float(np.median([d for d, _ in split])) / 1e3
        for k in ("sched", "enqueue_ahead", "prefill_dispatch",
                  "decode_dispatch", "device_wait"):
            med[k] = float(np.median([by.get(k, 0.0)
                                      for _, by in split])) / 1e3
    prefills = sorted(e["ts"] for e in rows
                      if e["name"] == "prefill_dispatch")
    sched_tid = steps[0]["tid"] if steps else None
    waits = []
    for r in rows:
        if r["name"] != "worker_request":
            continue
        nxt = next((t for t in prefills if t >= r["ts"]), None)
        if nxt is None:
            continue
        by = _within(rows, r["ts"], nxt, sched_tid)
        waits.append({"ms": round((nxt - r["ts"]) / 1e3, 2),
                      **{k: round(by.get(k, 0.0) / 1e3, 2)
                         for k in ("step", "prefill_dispatch",
                                   "decode_dispatch", "device_wait",
                                   "enqueue_ahead", "sched")}})
    log(f"trace {path}: {len(rows)} spans, kinds {sorted(kinds)}, missing "
        f"{missing}; the median of {len(split)} 4-lane steps, ms: "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f"; arrival to the next prefill dispatch, ms (and the scheduler "
        f"track's spans inside it): "
        f"{sorted(w['ms'] for w in waits)}, the longest "
        f"{max(waits, key=lambda w: w['ms']) if waits else None}")
    if missing:
        raise SystemExit(f"the trace lacks span kinds {missing}")
    return {"spans": len(rows), "step_ms": med, "arrival_waits": waits}


async def _status_drain(rt, worker, polled: list) -> dict:
    """The drain: /health answers 503 once it starts (the root token is
    killed with it, as the CLI does), /live stays 200 throughout."""
    addr = rt.system_address
    await worker.drain(1.0)
    rt.root_token.kill()
    health, body = await _http(addr, "/health")
    live, _ = await _http(addr, "/live")
    log(f"after the drain: /health {health} ({json.loads(body)['status']}),"
        f" /live {live}; /live polled {len(polled)} times during the run, "
        f"statuses {sorted(set(polled))}")
    if health != 503 or live != 200 or set(polled) != {200}:
        raise SystemExit("/health or /live wrong around the drain")
    return {"live_polls": len(polled)}


def _kernels_of(kv_dtype: str) -> tuple:
    """The (decode, prefill) wrappers that serve a cache of `kv_dtype`."""
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
    from dynamo_tpu_torch.ops import cuda_paged_attention as k1

    if kv_dtype == "int8":
        return k1.paged_decode_int8, k3.packed_prefill_int8
    return k1.paged_decode, k3.packed_prefill


def _check_worker_launches(counts: dict, steps: dict, L: int,
                           what: str = "worker") -> None:
    """Exit unless the (decode, prefill) launch `counts` of `what`'s run
    cover L layers x its decode steps and prefill dispatches in `steps`."""
    dec, pre = counts
    need_dec, need_pre = L * steps["decode_steps"], L * steps["prefill_steps"]
    log(f"{what} launches: {dec} {counts[dec]} (>= {need_dec} = {L} layers x "
        f"{steps['decode_steps']} decode steps), {pre} {counts[pre]} (>= "
        f"{need_pre} = {L} x {steps['prefill_steps']} prefill dispatches)")
    if counts[dec] < need_dec or counts[pre] < need_pre or not need_dec:
        raise SystemExit(f"the {what} did not run through both kernels")


def check_worker(device, card: str, cfg, params, direct) -> dict:
    """The five requests through a TorchEngineWorker (_serving_worker)
    with the engine run's config `cfg` and weights `params`, sent
    concurrently by a client of the same runtime.  `direct` is the
    engine run's (warm run's results, decode-step medians), for the log
    (None: not run): the worker starts warm too.  Exits unless every
    request finishes with 32 tokens, the kernels of this cache dtype were
    launched at least layers x steps times, the stored KV events carry
    every prompt's full-block hashes, the prefix hit reuses >= 1024
    tokens, load_metrics and FPM records arrive, the MDC is in discovery,
    clear_kv_blocks over the request plane clears blocks and removed
    events follow, a stream cancelled midway frees its slot, and close()
    removes the MDC.  The same worker also serves the status plane, with
    the tracer on, and its phase runs around the main run
    (_status_probes, _poll_live, _status_gauges, _status_debug,
    _tracing_ab, _status_trace, _status_drain); its own seconds are
    printed.  Returns the worker run's launch counts by kernel name."""
    import tempfile

    from dynamo_tpu_torch import obs
    from dynamo_tpu_torch.router.events import wire_to_hash
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

    kv_dtype = cfg.kv_cache_dtype
    used = _kernels_of(kv_dtype)
    reqs = _requests(cfg.resolve_model().vocab_size)
    bs = cfg.block_size
    trace_dir = tempfile.mkdtemp(prefix="chip-smoke-trace-")
    # the timeline spans from the worker's warm-up on
    obs.Tracer(out_path=os.path.join(trace_dir, "trace.json")).install()
    status_s = [0.0]

    async def run():
        async with _serving_worker(device, cfg, params, True) as (
                rt, worker, client, seen):
            eng, iid = worker.engine, worker.served.instance_id
            ep = rt.namespace("dynamo").component("backend")
            if not await rt.discovery.get_prefix(worker.card.key(iid)):
                raise SystemExit("the MDC is not in discovery")
            polled: list = []
            stop_poll = asyncio.Event()
            t_st = time.perf_counter()
            await _status_probes(rt, worker, seen)
            poller = asyncio.create_task(
                _poll_live(rt.system_address, stop_poll, polled))
            status_s[0] += time.perf_counter() - t_st
            m0 = dict(eng.metrics)
            # the main path's run: counts set to 0 just before, read just
            # after, before any other launch
            for fn in used:
                fn.launches = 0
            w0 = time.monotonic()
            res = await _serve_worker(client, reqs)
            w1 = time.monotonic()
            counts = {fn.__name__: fn.launches for fn in used}
            steps = {k: eng.metrics[k] - m0[k] for k in
                     ("decode_steps", "prefill_steps", "cache_hit_tokens")}
            # load metrics and FPM records (published every 0.5 s)
            for _ in range(100):
                if seen["load"] and seen["fpm"]:
                    break
                await asyncio.sleep(0.05)
            n_removed = len(seen["kv"])
            cleared = [x async for x in ep.endpoint("clear_kv_blocks")
                       .client().generate({})]
            for _ in range(100):
                if any(e["op"] == "removed" for e in seen["kv"][n_removed:]):
                    break
                await asyncio.sleep(0.02)
            removed_after = [e for e in seen["kv"][n_removed:]
                             if e["op"] == "removed"]
            # one stream abandoned after 4 tokens: the client kills it on
            # the server, and the engine frees its slot
            long = dataclasses.replace(reqs[3], request_id="smoke-cancel")
            long.stop = dataclasses.replace(long.stop, max_tokens=1000)
            got = 0
            stream = client.generate(long.to_dict())
            async for out in stream:
                got += len(out.get("token_ids", []))
                if got >= 4:
                    break
            await stream.aclose()
            for _ in range(200):
                if eng.num_active_seqs == 0:
                    break
                await asyncio.sleep(0.02)
            freed = eng.num_active_seqs == 0
            await asyncio.sleep(0.6)  # the main run's last FPM records
            recs = [r for m in seen["fpm"] for r in m["steps"]
                    if w0 <= r["t"] <= w1]
            t_st = time.perf_counter()
            stop_poll.set()
            await poller
            await _status_gauges(rt, worker, seen, recs)
            await _status_debug(rt, worker, client, reqs)
            await _tracing_ab(eng, reqs)
            await _status_trace(os.path.join(trace_dir, "trace.json"))
            await _status_drain(rt, worker, polled)
            status_s[0] += time.perf_counter() - t_st
            return (res, counts, steps, dict(seen), cleared, removed_after,
                    got, freed, (_step_medians(recs),
                                 _prefill_dispatches(recs, w0)))

    try:
        (res, counts, steps, seen, cleared, removed_after, got, freed,
         (step_ms, dispatches)) = asyncio.run(run())
    finally:
        if obs.tracer() is not None:
            obs.tracer().uninstall()
    log(f"status phase: {status_s[0]:.1f} s of its own (probes, gauges, "
        f"debug and profile routes, tracing A/B, trace, drain)")
    if direct is None:  # --status: no direct engine run to compare with
        direct = ([(r[0], r[1], float("nan"), r[3]) for r in res], {})
    direct, direct_step_ms = direct
    for i, (toks, finish, ttft, _) in enumerate(res):
        log(f"  worker request {i}: prompt {len(reqs[i].token_ids)} tokens, "
            f"{len(toks)} out, finish={finish}, ttft={ttft:.3f} s "
            f"(direct, warm {direct[i][2]:.3f} s)")
    bad = [i for i, r in enumerate(res) if r[1] != "length" or len(r[0]) != 32]
    if bad:
        raise SystemExit(f"worker requests {bad} did not finish with 32 tokens")
    _check_worker_launches(counts, steps, cfg.resolve_model().n_layers)
    stored = {wire_to_hash(h) for e in seen["kv"] if e["op"] == "stored"
              for h in e["block_hashes"]}
    for r in reqs:
        full = len(r.token_ids) // bs
        want = compute_block_hashes_for_request(r.token_ids, bs)[:full]
        if not stored.issuperset(want):
            raise SystemExit(f"{r.request_id}: stored KV events lack its "
                             "full-block hashes")
    log(f"worker KV events: {len(seen['kv'])} batches, {len(stored)} stored "
        f"hashes covering every prompt's full blocks; prefix reuse "
        f"{steps['cache_hit_tokens']} tokens")
    if steps["cache_hit_tokens"] < 1024:
        raise SystemExit("worker prefix hit not taken")
    load = seen["load"][-1] if seen["load"] else {}
    log(f"worker load_metrics: {len(seen['load'])} messages, last "
        f"worker_id={load.get('worker_id')} kv_usage={load.get('kv_usage')} "
        f"kv_cache_dtype={load.get('kv_cache_dtype')} itl_ema_s="
        f"{load.get('itl_ema_s')}; fpm: {len(seen['fpm'])} messages, "
        f"{sum(len(m['steps']) for m in seen['fpm'])} records")
    if not ({"worker_id", "kv_usage"} <= set(load)
            and load["kv_cache_dtype"] == kv_dtype and seen["fpm"]):
        raise SystemExit("load_metrics or fpm records missing")
    n_cleared = cleared[0]["cleared_blocks"] if cleared else 0
    log(f"worker clear_kv_blocks over the request plane: {n_cleared} blocks, "
        f"then {len(removed_after)} removed events; a stream abandoned after "
        f"{got} tokens freed its slot: {freed}")
    if n_cleared <= 0 or not removed_after or not freed:
        raise SystemExit("clear_kv_blocks or cancellation failed")
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    same = sum(res[i][0] == direct[i][0] for i in greedy)
    n, secs = _decode_rate(res)
    dn, dsecs = _decode_rate(direct)
    log(f"serving through the worker, {kv_dtype} cache ({card}): ttft s per "
        f"request {[round(r[2], 4) for r in res]}, decode {n} tokens in "
        f"{secs:.3f} s = {n / secs:.1f} tokens/s aggregate, against the "
        f"direct engine's warm run's {dn / dsecs:.1f} tokens/s (ttft "
        f"{[round(r[2], 4) for r in direct]}); greedy streams equal to the "
        f"direct run's: {same} of {len(greedy)} (not required: batching "
        f"differs, and so does bf16 rounding)")
    log(f"decode step ms through the worker, median by lanes (FPM gap_s): "
        f"{_fmt_steps(step_ms)}; direct warm run: "
        f"{_fmt_steps(direct_step_ms)}; the worker's prefill dispatches (ms "
        f"after the start, rows, tokens): {dispatches}")
    return counts


def check_worker_short(device, cfg, params) -> dict:
    """One request (the 500-token prompt) through a TorchEngineWorker with
    `cfg` (the int8 run's, or the MoE phase's) and weights `params`:
    exits unless it finishes with 32 tokens, the kernels of the cache's
    dtype were launched at least layers x steps times, load_metrics
    reports that dtype and the MDC in discovery names the served model
    with the cache's block size.  The rest of the worker's contract does
    not depend on the cache dtype or the model; check_worker holds it.
    Returns the launch counts by kernel name."""
    used = _kernels_of(cfg.kv_cache_dtype)
    req = _requests(cfg.resolve_model().vocab_size)[1]

    async def run():
        async with _serving_worker(device, cfg, params) as (
                rt, worker, client, seen):
            eng = worker.engine
            mdc = await rt.discovery.get_prefix(
                worker.card.key(worker.served.instance_id))
            m0 = dict(eng.metrics)
            for fn in used:
                fn.launches = 0
            res = await _serve_worker(client, [req])
            counts = {fn.__name__: fn.launches for fn in used}
            steps = {k: eng.metrics[k] - m0[k]
                     for k in ("decode_steps", "prefill_steps")}
            for _ in range(100):
                if seen["load"]:
                    break
                await asyncio.sleep(0.05)
            return (res[0], counts, steps, list(seen["load"]),
                    list(mdc.values()))

    (toks, finish, ttft, _), counts, steps, load, mdc = asyncio.run(run())
    kv = load[-1].get("kv_cache_dtype") if load else None
    card = mdc[0] if len(mdc) == 1 else {}
    log(f"  worker request 1 alone: {len(toks)} out, finish={finish}, "
        f"ttft={ttft:.3f} s; load_metrics kv_cache_dtype={kv}; MDC name "
        f"{card.get('name')!r}, block size "
        f"{card.get('kv_cache_block_size')}")
    if finish != "length" or len(toks) != 32:
        raise SystemExit("the worker's request did not finish with 32 tokens")
    if card.get("name") != cfg.served_name \
            or card.get("kv_cache_block_size") != cfg.block_size:
        raise SystemExit(f"the worker's MDC is not the model's: {card}")
    _check_worker_launches(counts, steps, cfg.resolve_model().n_layers)
    if kv != cfg.kv_cache_dtype:
        raise SystemExit(f"load_metrics kv_cache_dtype {kv!r}, expected "
                         f"{cfg.kv_cache_dtype!r}")
    return counts


# ---------------------------------------------------------------------------
# the decode A/B: lockstep eager decode against the default scheduler
# ---------------------------------------------------------------------------


def _body_ops(engine, k: int) -> int:
    """Device operations one decode program (greedy, k) launches: its body
    run eagerly, profiled, on an all-padding descriptor (writes land in
    block 0); a CUDA graph holds the same kernels.  The descriptor is
    restored afterwards."""
    g = engine.graphs
    snap = g.snapshot()
    a = g.host_descriptor()
    a["ctx_lens"][:] = a["steps"][:] = 1
    g.upload(a)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        g.run_eager(True, k)
        torch.cuda.synchronize()
    g.restore(snap)
    return sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))


def _dispatched_ops(engine, k: int) -> int:
    """Operations one decode program (greedy, k) dispatches, counted on
    the host: the aten ops its body calls, run eagerly on an all-padding
    descriptor (the profiler's host-side records, which drop nothing),
    plus K1's launches.  Unlike _body_ops's device-side count, which
    moves by a few events from run to run, two programs of one body
    count alike.  The descriptor and K1's count are restored."""
    k1 = _kernels_of(engine.kv_dtype)[0]
    g = engine.graphs
    snap = g.snapshot()
    a = g.host_descriptor()
    a["ctx_lens"][:] = a["steps"][:] = 1
    g.upload(a)
    torch.cuda.synchronize()
    n0 = k1.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        g.run_eager(True, k)
    torch.cuda.synchronize()
    launches, k1.launches = k1.launches - n0, n0
    g.restore(snap)
    return launches + sum(1 for e in prof.events()
                          if e.name.startswith("aten::"))


def _decode_ab_record(path: str, res, records) -> dict:
    """One turn of decode_ab: TTFT per request, aggregate decode tokens/s,
    and from the FPM decode records the median dispatch gap per burst and
    per token (gap / k), and the bursts' sizes."""
    n, secs = _decode_rate(res)
    dec = [r for r in records if r["kind"] == "decode" and r["gap_s"] > 0]
    ks: dict = {}
    for r in records:
        if r["kind"] == "decode":
            ks[r["k"]] = ks.get(r["k"], 0) + 1
    return {
        "path": path,
        "ttft_s": [round(r[2], 4) for r in res],
        "decode_tok_s": round(n / secs, 2),
        "gap_ms_per_burst": round(float(np.median(
            [r["gap_s"] * 1e3 for r in dec])), 3) if dec else None,
        "gap_ms_per_token": round(float(np.median(
            [r["gap_s"] * 1e3 / r["k"] for r in dec])), 3) if dec else None,
        "bursts_by_k": dict(sorted(ks.items())),
    }


def decode_ab(device, card: str, params, rounds: int = 2) -> dict:
    """The five requests at llama-8b width on a bf16 cache, served in one
    process by two engines with the same weights and their own caches:
    "lockstep", the lockstep scheduler with single eager decode steps
    (overlap_scheduling=False, decode_fused_steps=1, no CUDA graphs), and
    "default", the JAX engine's defaults on CUDA graphs; in turns
    (lockstep, default, default, lockstep) `rounds` times after a warm-up
    run of each, each turn from a cleared prefix cache after 1.1 s idle;
    then one profiled turn of each for the device's busy share, and each
    path's device operations per decode token (its decode program's
    body).  Returns the turns and each path's medians."""
    from dynamo_tpu_torch.engine import TorchEngine

    cfg = _engine_config("bf16")
    engines = {
        "lockstep": TorchEngine(dataclasses.replace(
            cfg, overlap_scheduling=False, decode_fused_steps=1),
            params=params, device=device, cuda_graphs=False),
        "default": TorchEngine(dataclasses.replace(cfg), params=params,
                               device=device)}
    reqs = _requests(cfg.resolve_model().vocab_size)
    for eng in engines.values():
        eng.warmup_decode()
    ks = {"lockstep": 1, "default": 8}
    ops = {p: _body_ops(e, ks[p]) for p, e in engines.items()}
    gc.collect()

    async def run():
        turns, prof = [], {}
        try:
            for eng in engines.values():  # warm-up
                await _serve(eng, reqs)
                await eng.clear_kv_blocks()
            await asyncio.sleep(1.1)
            for path in ["lockstep", "default", "default",
                         "lockstep"] * rounds:
                eng = engines[path]
                w0 = time.monotonic()
                res = await _serve(eng, reqs)
                w1 = time.monotonic()
                await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
                bad = [i for i, r in enumerate(res)
                       if r[1] != "length" or len(r[0]) != 32]
                if bad:
                    raise SystemExit(f"decode A/B {path}: requests {bad} "
                                     "did not finish with 32 tokens")
                turns.append(_decode_ab_record(
                    path, res, [r for r in eng.fpm if w0 <= r["t"] <= w1]))
                turns[-1]["streams"] = [r[0] for r in res]
                log(f"decode A/B turn {len(turns)}: "
                    f"{ {k: v for k, v in turns[-1].items() if k != 'streams'} }")
            for path, eng in engines.items():
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as p:
                    t0 = time.perf_counter()
                    res = await _serve(eng, reqs)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                await eng.clear_kv_blocks()
                log(f"decode A/B, {path}, profiled turn:")
                prof[path] = (_device_breakdown(p, wall),
                              sum(len(r[0]) for r in res))
        finally:
            for eng in engines.values():
                await eng.close()
        return turns, prof

    turns, prof = asyncio.run(run())
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    ref = turns[0]["streams"]
    if any(t["streams"][i] != ref[i] for t in turns for i in greedy):
        raise SystemExit("decode A/B: greedy streams differ between paths")
    summary = {}
    for path in ("lockstep", "default"):
        mine = [t for t in turns if t["path"] == path]
        med = {key: float(np.median([t[key] for t in mine]))
               for key in ("decode_tok_s", "gap_ms_per_burst",
                           "gap_ms_per_token")}
        med["ttft_s"] = [float(np.median([t["ttft_s"][i] for t in mine]))
                         for i in range(len(reqs))]
        seen, tokens = prof[path]
        med["busy_share"] = seen["busy_share"] if seen else None
        med["device_ops_per_token_served"] = (seen["device_ops"] / tokens
                                              if seen else None)
        med["device_ops_per_decode_token"] = \
            ops[path] / (ks[path] * cfg.max_num_seqs)
        summary[path] = med
        log(f"decode A/B, {path}, median of {len(mine)} turns ({card}): "
            f"{med}")
    log(f"decode A/B: default over lockstep decode tokens/s "
        f"{summary['default']['decode_tok_s'] / summary['lockstep']['decode_tok_s']:.2f}x; "
        f"greedy streams equal across every turn of both paths")
    for t in turns:
        del t["streams"]
    return {"turns": turns, "median": summary}


# ---------------------------------------------------------------------------
# the fused sampling epilogue against the materialized logits
# ---------------------------------------------------------------------------


def _tile_vs_full(params, cfg, h) -> float:
    """Largest |tile - full| over the logits of final-norm hidden states
    `h`: each column as the fused epilogue's tile product computes it
    (ops/fused_sampling.py's plan, DEFAULT_TILE columns) against the same
    column of the full [B, vocab] product the "off" path computes."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import fused_sampling as fs

    w = llama.unembed_weight(params, cfg)
    full = (h @ w).float()
    V = w.shape[1]
    tile, n_t = fs._tile_plan(V, fs.DEFAULT_TILE)
    diff = 0.0
    for i in range(n_t):
        lg, start = fs._tile_logits(h, w, i, tile, V)
        fresh = i * tile - start
        diff = max(diff, (lg[:, fresh:] - full[:, i * tile:start + tile])
                   .abs().max().item())
    return diff


def _sample_tile_diff(engine, device, steps: int = 8) -> float:
    """_tile_vs_full over `steps` eager decode steps at B = 4 live lanes
    (_burst_inputs' contexts over blocks of random K/V, argmax tokens
    fed back): the largest tile-vs-full logit difference seen.  Writes
    the engine's cache: run it when the engine has served."""
    from dynamo_tpu_torch.models import llama

    a, _ = _burst_inputs(engine, device, seed=13)
    dev = {n: torch.from_numpy(np.asarray(a[n])).to(device)
           for n in ("tokens", "positions", "tables", "ctx_lens")}
    tok, pos, ctx = dev["tokens"], dev["positions"], dev["ctx_lens"]
    params, cfg = engine.params, engine.model_cfg
    diff = 0.0
    for _ in range(steps):
        h, _ = llama.decode_hidden(params, cfg, engine.kv, tok, pos,
                                   dev["tables"], ctx)
        diff = max(diff, _tile_vs_full(params, cfg, h))
        tok = (h @ llama.unembed_weight(params, cfg)).float().argmax(-1) \
            .to(torch.int32)
        pos, ctx = pos + 1, ctx + 1
    return diff


def _replay_gap(params, cfg, device, prompt, stream, j: int,
                lora: Optional[tuple] = None) -> tuple:
    """The "off" path's logits for token j of `stream`, recomputed
    teacher-forced on a scratch cache: the prompt prefilled, then decode
    steps at B = 4 (lane 0 live, as served) fed stream[:j]; with `lora`
    (bank, slot) lane 0 and the prompt run on that adapter slot.  Returns
    (the gap between its top two logits, its top token, _tile_vs_full of
    that step's hidden state, its top logit)."""
    from dynamo_tpu_torch.models import llama

    bs = 128
    L = len(prompt)
    nb = -(-(L + j + 1) // bs)
    kv = tuple(torch.zeros(s, dtype=cfg.dtype, device=device)
               for s in llama.kv_cache_shapes(cfg, nb + 1, bs))
    T = -(-L // bs) * bs

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    if j < 1:
        raise SystemExit("fused A/B: streams part at the first token, which "
                         "prefill samples without the epilogue")
    table = list(range(1, nb + 1))
    bank, slot = lora if lora is not None else (None, 0)
    kw = (lambda idx: {"lora_bank": bank, "adapter_idx": i32(idx)}) \
        if bank is not None else (lambda idx: {})
    llama.prefill_packed(
        params, cfg, kv, i32(prompt + [0] * (T - L)),
        i32(list(range(L)) + [0] * (T - L)), i32([0] * T), i32([table]),
        i32([L - 1]), torch.arange(T, device=device) < L, **kw([slot] * T))
    tables = i32([table] + [[0] * nb] * 3)
    for s in range(j):
        at = [L + s, 0, 0, 0]
        h, _ = llama.decode_hidden(params, cfg, kv, i32([stream[s], 0, 0, 0]),
                                   i32(at), tables, i32(at),
                                   **kw([slot, 0, 0, 0]))
    full = (h @ llama.unembed_weight(params, cfg)).float()[0]
    top2 = torch.topk(full, 2)
    return ((top2.values[0] - top2.values[1]).item(),
            int(top2.indices[0]), _tile_vs_full(params, cfg, h),
            top2.values[0].item())


# the fused A/B's bound terms at llama-8b width, batch B = max_num_seqs
def _epilogue_bound(cfg, B: int) -> tuple:
    """(ms a decode step to read the [d, vocab] bf16 unembedding once at
    3.35 TB/s, bytes of the [B, vocab] fp32 logits' write and read that
    the epilogue saves)."""
    w_bytes = cfg.d_model * cfg.vocab_size * 2
    return w_bytes / HBM_BYTES_PER_S * 1e3, 2 * B * cfg.vocab_size * 4


def fused_ab(device, card: str, params, rounds: int = 2) -> dict:
    """The five requests at llama-8b width and depth (random bf16 weights
    `params`) on a bf16 cache, served in one process by two engines of
    the default scheduler with their own caches: "off" (logits
    materialized, the reference sampler) and "fused"
    (sampling_epilogue="fused": ops/fused_sampling.py inside every
    captured program), in turns (off, fused, fused, off) `rounds` times
    after a warm-up run of each.  Exits unless warm-up captured every
    (greedy, k) program of each once and serving none, a replayed k = 8
    burst equals the eager one on each, each path's greedy streams repeat
    across its turns, and fused greedy streams equal off ones up to a
    near-tie: where they part, the off logits' top-2 gap at that token
    (recomputed, _replay_gap) must be within the largest tile-vs-full
    logit difference measured.  Logs per turn TTFT, decode tokens/s and
    the FPM decode gap per token, and per path the k = 8 burst's replay
    time and device operations per decode token."""
    from dynamo_tpu_torch.engine import TorchEngine

    cfg = _engine_config("bf16")
    engines = {path: TorchEngine(dataclasses.replace(
        cfg, sampling_epilogue=path), params=params, device=device)
        for path in ("off", "fused")}
    mc = engines["off"].model_cfg
    built, burst = {}, {}
    for path, eng in engines.items():
        t0 = time.perf_counter()
        eng.warmup_decode()
        log(f"fused A/B, epilogue {path}: warm-up in "
            f"{time.perf_counter() - t0:.1f} s")
        built[path] = _log_programs(eng, f"fused A/B, epilogue {path}")
        burst[path] = check_graph_burst(eng, device,
                                        f"bf16, epilogue {path}")
    step_ms, saved = _epilogue_bound(mc, cfg.max_num_seqs)
    log(f"fused A/B: the epilogue's bound, the [{mc.d_model}, "
        f"{mc.vocab_size}] bf16 unembedding read once a step at 3.35 TB/s: "
        f"{step_ms:.4f} ms a step; the logits round trip it saves, "
        f"2 x {cfg.max_num_seqs} x {mc.vocab_size} x 4 bytes = {saved} "
        f"bytes = {saved / HBM_BYTES_PER_S * 1e3:.4f} ms a step; a replayed "
        f"k=8 burst {burst['fused']['burst_ms']:.3f} ms fused against "
        f"{burst['off']['burst_ms']:.3f} ms off (sampled "
        f"{burst['fused']['sampled_ms']:.3f} against "
        f"{burst['off']['sampled_ms']:.3f} ms), "
        f"{burst['fused']['ops_per_token']:.1f} against "
        f"{burst['off']['ops_per_token']:.1f} device operations per decode "
        f"token ({card})")
    reqs = _requests(mc.vocab_size)
    gc.collect()

    async def run():
        turns = []
        try:
            for eng in engines.values():  # warm-up
                await _serve(eng, reqs)
                await eng.clear_kv_blocks()
            await asyncio.sleep(1.1)
            for path in ["off", "fused", "fused", "off"] * rounds:
                eng = engines[path]
                w0 = time.monotonic()
                res = await _serve(eng, reqs)
                w1 = time.monotonic()
                await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
                bad = [i for i, r in enumerate(res)
                       if r[1] != "length" or len(r[0]) != 32]
                if bad:
                    raise SystemExit(f"fused A/B {path}: requests {bad} did "
                                     "not finish with 32 tokens")
                turns.append(_decode_ab_record(
                    path, res, [r for r in eng.fpm if w0 <= r["t"] <= w1]))
                turns[-1]["ops_per_decode_token"] = \
                    burst[path]["ops_per_token"]
                turns[-1]["streams"] = [r[0] for r in res]
                shown = {k: v for k, v in turns[-1].items()
                         if k != "streams"}
                log(f"fused A/B turn {len(turns)} ({card}): {shown}")
        finally:
            for eng in engines.values():
                await eng.close()
        return turns

    turns = asyncio.run(run())
    for path, eng in engines.items():
        if eng.graphs.counts != built[path]:
            raise SystemExit(f"fused A/B {path}: serving captured programs: "
                             f"{eng.graphs.counts} after warm-up "
                             f"{built[path]}")
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    first = {p: next(t["streams"] for t in turns if t["path"] == p)
             for p in engines}
    for t in turns:
        if any(t["streams"][i] != first[t["path"]][i] for i in greedy):
            raise SystemExit(f"fused A/B: {t['path']} greedy streams differ "
                             "between its turns")
    diff = _sample_tile_diff(engines["off"], device)
    log(f"fused A/B: largest tile-vs-full logit difference over 8 decode "
        f"steps of 4 live lanes: {diff:.6f}")
    parted = []
    for i in greedy:
        off, fused = first["off"][i], first["fused"][i]
        j = next((n for n, (a, b) in enumerate(zip(off, fused)) if a != b),
                 None)
        if j is None:
            continue
        gap, top, d, _ = _replay_gap(params, mc, device,
                                     list(reqs[i].token_ids), off, j)
        diff = max(diff, d)
        parted.append((i, j, gap))
        log(f"fused A/B: request {i}'s greedy streams part at token {j}: "
            f"off {off[j]}, fused {fused[j]}; the off logits' top-2 gap "
            f"there {gap:.6f} (recomputed top token {top}), tile-vs-full "
            f"difference of that step {d:.6f}")
    bad = [(i, j, gap) for i, j, gap in parted if gap > diff]
    log(f"fused A/B: greedy streams equal for "
        f"{len(greedy) - len(parted)} of {len(greedy)} requests; "
        f"{len(parted)} part at a near-tie within the largest tile-vs-full "
        f"difference {diff:.6f}: {parted}; the sampled request's stream "
        f"equal: {first['off'][2] == first['fused'][2]} (not required)")
    if bad:
        raise SystemExit(f"fused A/B: greedy streams part where the top-2 "
                         f"gap exceeds the tile-vs-full difference: {bad}")
    summary = {}
    for path in ("off", "fused"):
        mine = [t for t in turns if t["path"] == path]
        med = {key: float(np.median([t[key] for t in mine]))
               for key in ("decode_tok_s", "gap_ms_per_burst",
                           "gap_ms_per_token")}
        med["ttft_s"] = [float(np.median([t["ttft_s"][i] for t in mine]))
                         for i in range(len(reqs))]
        med["burst_ms"] = burst[path]["burst_ms"]
        med["sampled_burst_ms"] = burst[path]["sampled_ms"]
        med["ops_per_decode_token"] = burst[path]["ops_per_token"]
        summary[path] = med
        log(f"fused A/B, epilogue {path}, median of {len(mine)} turns "
            f"({card}): {med}")
    ratio = summary["fused"]["decode_tok_s"] / summary["off"]["decode_tok_s"]
    log(f"fused A/B: fused over off decode tokens/s {ratio:.3f}x, "
        f"decode gap per token {summary['fused']['gap_ms_per_token']:.3f} "
        f"against {summary['off']['gap_ms_per_token']:.3f} ms")
    for t in turns:
        del t["streams"]
    return {"turns": turns, "median": summary, "tile_vs_full": diff,
            "parted": parted}


# ---------------------------------------------------------------------------
# the prefill A/B: eager packed prefill against one CUDA graph per bucket
# ---------------------------------------------------------------------------


def _time_prefill_dispatches(engine, into: list) -> None:
    """Wrap the engine's prefill programs so each dispatch appends its
    host seconds (descriptor upload through the program's launch, eager
    or replayed) to `into`."""
    g = engine.prefill_graphs
    upload, run = g.upload, g.run
    t0 = []

    def timed_upload(a):
        t0.append(time.perf_counter())
        return upload(a)

    def timed_run(T):
        out = run(T)
        into.append(time.perf_counter() - t0.pop())
        return out

    g.upload, g.run = timed_upload, timed_run


def _prefill_ops_per_token(engine) -> float:
    """Device operations of the T = 2048 program's body (the first
    PREFILL_REPLAY_CASES descriptor, 2000 live tokens) per live token: a
    graph holds the same kernels."""
    g = engine.prefill_graphs
    T, rows = PREFILL_REPLAY_CASES[0]
    g.upload(_prefill_descriptor(engine, T, rows, seed=T))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        g.run_eager(T)
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    return ops / sum(r[1] for r in rows)


def prefill_ab(device, card: str, params, rounds: int = 2) -> dict:
    """The five requests at llama-8b width on a bf16 cache, served in one
    process by two default engines with the same weights and their own
    caches: "eager" (packed prefill dispatched layer by layer from the
    host, TorchEngine(prefill_graphs=False); decode on graphs) and
    "graph" (one captured program per bucket), in turns (eager, graph,
    graph, eager) `rounds` times after a warm-up run of each, each turn
    from a cleared prefix cache after 1.1 s idle.  Logs per turn TTFT per
    request, the time from the run's start to its first prefill record
    (FPM), the median host time to dispatch one prefill and decode
    tokens/s, and device operations per prefill token.  Exits unless
    the graph engine's warm-up built every bucket once and serving none,
    the eager engine captured nothing, and every stream is equal across
    turns and paths (the replays are bit-equal to the eager bodies)."""
    from dynamo_tpu_torch.engine import TorchEngine

    cfg = _engine_config("bf16")
    engines = {"eager": TorchEngine(dataclasses.replace(cfg), params=params,
                                    device=device, prefill_graphs=False),
               "graph": TorchEngine(dataclasses.replace(cfg), params=params,
                                    device=device)}
    for path, eng in engines.items():
        t0 = time.perf_counter()
        eng.warmup_decode()
        log(f"prefill A/B, {path}: warm-up in {time.perf_counter() - t0:.1f}"
            " s")
    built = _log_prefill_programs(engines["graph"], "prefill A/B, graph")
    if engines["eager"].prefill_graphs.capture_s:
        raise SystemExit("prefill A/B: the eager engine captured a program")
    ops = _prefill_ops_per_token(engines["graph"])
    host = {p: [] for p in engines}
    for path, eng in engines.items():
        _time_prefill_dispatches(eng, host[path])
    reqs = _requests(engines["graph"].model_cfg.vocab_size)
    gc.collect()

    async def run():
        turns = []
        try:
            for eng in engines.values():  # warm-up
                await _serve(eng, reqs)
                await eng.clear_kv_blocks()
            await asyncio.sleep(1.1)
            for path in ["eager", "graph", "graph", "eager"] * rounds:
                eng = engines[path]
                n0 = len(host[path])
                w0 = time.monotonic()
                res = await _serve(eng, reqs)
                w1 = time.monotonic()
                await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
                bad = [i for i, r in enumerate(res)
                       if r[1] != "length" or len(r[0]) != 32]
                if bad:
                    raise SystemExit(f"prefill A/B {path}: requests {bad} "
                                     "did not finish with 32 tokens")
                pre = [r["t"] for r in eng.fpm
                       if r["kind"] == "prefill" and w0 <= r["t"] <= w1]
                n, secs = _decode_rate(res)
                mine = host[path][n0:]
                turns.append({
                    "path": path,
                    "ttft_s": [round(r[2], 4) for r in res],
                    "first_prefill_ms": round((min(pre) - w0) * 1e3, 2),
                    "dispatch_host_ms": round(float(np.median(mine)) * 1e3,
                                              3),
                    "dispatches": len(mine),
                    "decode_tok_s": round(n / secs, 2),
                    "streams": [r[0] for r in res]})
                log(f"prefill A/B turn {len(turns)} ({card}): "
                    f"{ {k: v for k, v in turns[-1].items() if k != 'streams'} }")
        finally:
            for eng in engines.values():
                await eng.close()
        return turns

    turns = asyncio.run(run())
    if engines["graph"].prefill_graphs.counts != built:
        raise SystemExit(f"prefill A/B: serving built prefill programs: "
                         f"{engines['graph'].prefill_graphs.counts}")
    ref = turns[0]["streams"]
    if any(t["streams"] != ref for t in turns):
        raise SystemExit("prefill A/B: streams differ between turns or "
                         "paths")
    summary = {}
    for path in ("eager", "graph"):
        mine = [t for t in turns if t["path"] == path]
        med = {key: float(np.median([t[key] for t in mine]))
               for key in ("first_prefill_ms", "dispatch_host_ms",
                           "decode_tok_s")}
        med["ttft_s"] = [float(np.median([t["ttft_s"][i] for t in mine]))
                         for i in range(len(reqs))]
        med["device_ops_per_prefill_token"] = ops
        summary[path] = med
        log(f"prefill A/B, {path}, median of {len(mine)} turns ({card}): "
            f"{med}")
    log(f"prefill A/B: graph against eager, first prefill record "
        f"{summary['graph']['first_prefill_ms']:.2f} against "
        f"{summary['eager']['first_prefill_ms']:.2f} ms after a run's "
        f"start, host time a dispatch "
        f"{summary['graph']['dispatch_host_ms']:.3f} against "
        f"{summary['eager']['dispatch_host_ms']:.3f} ms; {ops:.3f} device "
        f"operations per prefill token; streams equal across every turn of "
        f"both paths")
    for t in turns:
        del t["streams"]
    return {"turns": turns, "median": summary}


# ---------------------------------------------------------------------------
# disaggregated prefill/decode: two workers on one card
# ---------------------------------------------------------------------------


def _expected_pulls(reqs, bs: int) -> list:
    """Blocks each request's pull moves when the five are served one at a
    time from cleared prefix caches: its prompt's blocks less the leading
    full blocks an earlier prompt committed on the decode side (admission
    never reuses the block of the last prompt token)."""
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

    seen, out = set(), []
    for r in reqs:
        hashes = compute_block_hashes_for_request(r.token_ids, bs)
        cap = (len(r.token_ids) - 1) // bs
        hit = 0
        while hit < cap and hashes[hit] in seen:
            hit += 1
        out.append(-(-len(r.token_ids) // bs) - hit)
        seen.update(hashes[:len(r.token_ids) // bs])
    return out


def _ulp_bf16(x: float) -> float:
    return float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(
        np.log2(abs(x))) if x else 0.0


async def _disagg_one(pclient, dclient, req, t0: float):
    """One request through the pair: the prompt with DISAGG_ANNOTATION to
    the prefill worker (one frame back: its first token and
    kv_transfer_params), then the request with those params to the decode
    worker.  Returns (tokens, finish, first token time, last token time,
    the prefill hop's time), times after t0."""
    from dynamo_tpu_torch.protocols import DISAGG_ANNOTATION

    hop = dataclasses.replace(req, annotations=[DISAGG_ANNOTATION])
    frames = [o async for o in pclient.generate(hop.to_dict())]
    t_hop = time.perf_counter() - t0
    if len(frames) != 1 or frames[0].get("finish_reason") != "stop" \
            or not frames[0].get("kv_transfer_params"):
        raise SystemExit(f"disagg: the prefill hop of {req.request_id} "
                         f"answered {frames}")
    dreq = dataclasses.replace(
        req, disaggregated_params=frames[0]["kv_transfer_params"])
    toks, finish, first = [], None, None
    async for out in dclient.generate(dreq.to_dict()):
        if out.get("token_ids") and first is None:
            first = time.perf_counter() - t0
        toks.extend(out.get("token_ids", []))
        finish = out.get("finish_reason")
    return toks, finish, first, time.perf_counter() - t0, t_hop


def _watch_blocks(pw, dw, rid: str, sent: dict, landed: dict) -> None:
    """Record request `rid`'s chunks as the prefill engine gathers them
    and its blocks as the decode engine injected them (gathered back),
    keyed by first block, for the bit-equality check."""
    from dynamo_tpu_torch.ops.kv_transfer import gather_universal

    extract, inject = (pw.engine.extract_parked_chunk,
                       dw.engine._inject_pulled_chunk)

    async def recorded_extract(request_id, start, count, **kw):
        arrs = await extract(request_id, start, count, **kw)
        if request_id == rid:
            sent[start] = [a.clone() for a in arrs]
        return arrs

    def recorded_inject(slot, b0, n, arrs):
        inject(slot, b0, n, arrs)
        if slot.request.request_id == rid:
            ids = dw.engine.allocator.seq_block_ids(rid)[b0:b0 + n]
            landed[b0] = gather_universal(dw.engine.kv, ids)

    pw.engine.extract_parked_chunk = recorded_extract
    dw.engine._inject_pulled_chunk = recorded_inject


def _pull_timer(engine):
    """Wrap a decode engine's pull source and chunk injects: per request
    [time its pull task reached the source (after admission), time its
    last chunk inject returned, blocks injected].  Returns (the records,
    a function that restores the engine's own)."""
    rec: dict = {}
    pull_fn, inject = engine.kv_pull_fn, engine._inject_pulled_chunk

    async def timed_pull_fn(dp):
        rec[dp["request_id"]] = [time.perf_counter(), None, 0]
        return await pull_fn(dp)

    def timed_inject(slot, b0, n, arrs):
        inject(slot, b0, n, arrs)
        r = rec.get(slot.request.request_id)
        if r is not None:
            r[1], r[2] = time.perf_counter(), r[2] + n

    def restore():
        engine.kv_pull_fn, engine._inject_pulled_chunk = pull_fn, inject

    engine.kv_pull_fn, engine._inject_pulled_chunk = timed_pull_fn, timed_inject
    return rec, restore


def _transfer_gb_s(rec: dict, block_bytes: int) -> tuple:
    """(GB/s, seconds) of the pulls in `rec` (_pull_timer) from their
    source to their last inject: the tier's own time, without the wait
    for admission behind the previous request's queued bursts."""
    secs = sum(r[1] - r[0] for r in rec.values() if r[1] is not None)
    moved = sum(r[2] for r in rec.values()) * block_bytes
    return (moved / secs / 1e9 if secs else 0.0), secs


def _same_blocks(sent: dict, landed: dict) -> bool:
    return bool(sent) and sorted(sent) == sorted(landed) and all(
        torch.equal(a.to(b.device).view(torch.uint8),
                    b.view(torch.uint8))
        for b0 in sent for a, b in zip(sent[b0], landed[b0]))


def _transfer_bandwidth(engine, n_blocks: int, card: str) -> dict:
    """gather_universal and inject_universal on `engine`'s cache, n_blocks
    blocks (a broker chunk), CUDA events around 5 calls each: ms, the
    byte bound (the payload read once and written once at 3.35 TB/s) and
    GB/s of the bytes moved."""
    from dynamo_tpu_torch.ops.kv_transfer import (
        gather_universal,
        inject_universal,
    )

    ids = torch.arange(1, 1 + n_blocks, device=engine.device)
    dst = torch.arange(1 + n_blocks, 1 + 2 * n_blocks, device=engine.device)
    arrs = gather_universal(engine.kv, ids)
    payload = sum(a.numel() * a.element_size() for a in arrs)
    out = {}
    for name, fn in (("gather_universal",
                      lambda: gather_universal(engine.kv, ids)),
                     ("inject_universal",
                      lambda: inject_universal(engine.kv, *arrs[:2], dst,
                                               *arrs[2:]))):
        ms = time_ms(fn, iters=5, warmup=2)
        moved = 2 * payload
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "bound_ms": bound_ms,
                     "gb_s": moved / ms / 1e6, "bytes": moved}
        log(f"disagg: {name} of {n_blocks} blocks ({payload / 2**20:.0f} "
            f"MiB payload, {moved / 2**20:.0f} MiB moved) {ms:.3f} ms = "
            f"{moved / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f}% of "
            f"the {bound_ms:.3f} ms byte bound at 3.35 TB/s ({card})")
    return out


@contextlib.contextmanager
def _broker_off(off: bool):
    """The host-staged tier forced: the in-process broker finds no
    engine (as tests/test_disagg.py's _forced_tier_roundtrip does)."""
    from dynamo_tpu_torch.disagg import broker

    orig = broker.lookup_engine
    if off:
        broker.lookup_engine = lambda _id: None
    try:
        yield
    finally:
        broker.lookup_engine = orig


@contextlib.asynccontextmanager
async def _disagg_pair(device, cfg, params, warmup: bool):
    """A prefill TorchEngineWorker (role "prefill", component "prefill")
    and a decode one (role "decode", component "backend") with config
    `cfg`, sharing the weight tensors `params`, on one runtime of the
    port (mem discovery, in-process event plane, TCP on 127.0.0.1).
    Yields (prefill worker, decode worker, prefill client, decode
    client); closes both and frees their caches on exit."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc",
        tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
    workers, clients = [], []
    try:
        for role, comp in (("prefill", "prefill"), ("decode", "backend")):
            t0 = time.perf_counter()
            w = await TorchEngineWorker(rt, dataclasses.replace(
                cfg, role=role, warmup=warmup), component=comp,
                params=params, device=device).start()
            workers.append(w)
            log(f"disagg ({cfg.kv_cache_dtype}): {role} worker started "
                f"{'with warm-up ' if warmup else ''}in "
                f"{time.perf_counter() - t0:.1f} s, "
                f"{w.config.num_blocks} KV blocks, MDC role "
                f"{w.card.runtime_config['role']}, "
                f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
            c = await rt.namespace("dynamo").component(comp).endpoint(
                "generate").client().start()
            clients.append(c)
            await c.wait_for_instances()
        yield (*workers, *clients)
    finally:
        for c in clients:
            await c.close()
        for w in workers:
            await w.close()
            w.engine.kv = w.engine.graphs = w.engine.prefill_graphs = None
            w.engine.guided_graphs = None
        await rt.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


def _aggregated_reference(device, cfg, params, reqs, warmup: bool) -> tuple:
    """The requests through an aggregated TorchEngine (`cfg`, weights
    `params`): one at a time (the reference streams), then, after a
    cleared prefix cache, all at once (the TTFT yardstick).  Frees its
    cache before returning."""
    from dynamo_tpu_torch.engine import TorchEngine

    eng = TorchEngine(dataclasses.replace(cfg), params=params, device=device)
    if warmup:
        eng.warmup_decode()

    async def run():
        try:
            one = [(await _serve(eng, [r]))[0] for r in reqs]
            await eng.clear_kv_blocks()
            await asyncio.sleep(1.1)
            return one, await _serve(eng, reqs)
        finally:
            await eng.close()

    one, conc = asyncio.run(run())
    eng.kv = eng.graphs = eng.prefill_graphs = eng.guided_graphs = None
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return one, conc


def _check_streams(what: str, got, ref, reqs, params, mc, device,
                   lora: Optional[tuple] = None) -> list:
    """Exit unless every stream of `got` equals `ref`'s, except a parting
    at a near-tie (the reference's top-2 logit gap at that token, through
    _replay_gap, within one bf16 ulp of its top logit); returns the
    partings.  With `lora` (bank, {adapter: slot}) each request's gap is
    its adapter's."""
    parted = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if g[0] == r[0]:
            continue
        j = next((n for n, (a, b) in enumerate(zip(g[0], r[0])) if a != b),
                 min(len(g[0]), len(r[0])))
        if j == 0:
            raise SystemExit(f"{what}: request {i}'s first token differs "
                             "from the aggregated engine's")
        slot = lora[1].get(reqs[i].lora_name, 0) if lora else 0
        gap, _, _, top = _replay_gap(
            params, mc, device, list(reqs[i].token_ids), r[0], j,
            (lora[0], slot) if lora else None)
        ulp = _ulp_bf16(top)
        parted.append((i, j, gap, ulp))
        log(f"{what}: request {i}'s stream parts from the aggregated one at "
            f"token {j}: top-2 gap {gap:.6f}, one bf16 ulp {ulp:.6f}")
        if gap > ulp:
            raise SystemExit(f"{what}: request {i} parts at token {j} where "
                             f"the top-2 gap {gap} exceeds a bf16 ulp")
    return parted


def check_disagg(device, card: str, params) -> dict:
    """Disaggregated serving at llama-8b width and depth on one card: a
    prefill and a decode TorchEngineWorker in one process (_disagg_pair,
    one set of weight tensors, two bf16 caches of 512 blocks, warm-up
    capturing every program), routed by hand as tests/test_disagg.py's
    _engine_disagg_roundtrip does (the frontend's PrefillOrchestrator is
    JAX code).  For each tier, the broker (device-resident chunks) and
    host-staged frames (broker lookup off), from cleared prefix caches:
    the five requests one at a time, whose streams must equal an
    aggregated TorchEngine's served one at a time with the same weights
    (a parting only at a near-tie), with the decode worker prefilling no
    token, pulling exactly each prompt's blocks less those its prefix
    cache holds, the prefill worker holding no parked entry after the
    pulls, and request 1's injected blocks bit-equal to the sender's
    gathered ones; then the five at once (TTFT through the pair against
    the aggregated engine's, concurrent).  The broker tier's one-at-a-time
    run is the main path: the launch counters are set to 0 just before
    it and read just after (K3 from the prefill worker's graph replays,
    K1 from the decode worker's).  Logs pull GB/s per tier, the host
    chunk bound, and gather/inject GB/s against their byte bound.  Then
    one request (request 1) through an int8 pair, both tiers, against an
    aggregated int8 engine.  Returns {"launches": {kernel: (prefill
    worker's, decode worker's)}, ...}."""
    cfg = _engine_config("bf16")
    mc = cfg.resolve_model()
    reqs = _requests(mc.vocab_size)
    bs = cfg.block_size
    t0 = time.perf_counter()
    ref_one, ref_conc = _aggregated_reference(device, cfg, params, reqs,
                                              warmup=True)
    log(f"disagg: aggregated reference (one at a time, then concurrent) in "
        f"{time.perf_counter() - t0:.1f} s; ttft s concurrent "
        f"{[round(r[2], 4) for r in ref_conc]}")
    want_pulls = _expected_pulls(reqs, bs)
    k1, k3 = _kernels_of("bf16")
    result = {"tiers": {}}

    async def run():
        async with _disagg_pair(device, cfg, params, warmup=True) as (
                pw, dw, pclient, dclient):
            pbuilt = _log_prefill_programs(pw.engine, "disagg prefill worker")
            dbuilt = _log_programs(dw.engine, "disagg decode worker")
            replays = []
            run_prefill = dw.engine.prefill_graphs.run

            def counted(T):
                replays.append(T)
                return run_prefill(T)

            dw.engine.prefill_graphs.run = counted
            layout = dw.engine.kv_wire_layout()
            for tier in ("broker", "host"):
                with _broker_off(tier == "host"):
                    for w in (pw, dw):
                        await w.engine.clear_kv_blocks()
                    await asyncio.sleep(1.1)
                    sent, landed = {}, {}
                    _watch_blocks(pw, dw, reqs[1].request_id, sent, landed)
                    timed, restore = _pull_timer(dw.engine)
                    m0 = dict(dw.engine.metrics)
                    p0 = dict(pw.engine.metrics)
                    if tier == "broker":
                        for fn in (k1, k3):
                            fn.launches = 0
                    one = []
                    for r in reqs:
                        t = time.perf_counter()
                        one.append(await _disagg_one(pclient, dclient, r, t))
                    if tier == "broker":
                        launches = {fn.__name__: fn.launches
                                    for fn in (k1, k3)}
                    dm = {k: dw.engine.metrics.get(k, 0) - m0.get(k, 0)
                          for k in ("prefill_tokens", "prefill_steps",
                                    "decode_steps", "pull_blocks",
                                    "pull_seconds")}
                    pm = {k: pw.engine.metrics[k] - p0[k]
                          for k in ("prefill_steps", "decode_steps",
                                    "prefill_tokens")}
                    for _ in range(100):
                        if not pw.engine._parked:
                            break
                        await asyncio.sleep(0.02)
                    parked = dict(pw.engine._parked)
                    restore()
                    del pw.engine.extract_parked_chunk
                    del dw.engine._inject_pulled_chunk
                    same = _same_blocks(sent, landed)
                    for w in (pw, dw):
                        await w.engine.clear_kv_blocks()
                    await asyncio.sleep(1.1)
                    conc = await asyncio.gather(*(
                        _disagg_one(pclient, dclient, r, time.perf_counter())
                        for r in reqs))
                entry = {"one": one, "conc": conc, "decode": dm,
                         "prefill": pm, "parked": parked, "timed": timed,
                         "blocks_equal": same,
                         "host_chunk_max": dw.engine.metrics.get(
                             "pull_host_chunk_bytes_max", 0),
                         "sent_chunks": len(sent)}
                if tier == "broker":
                    entry["launches"] = launches
                result["tiers"][tier] = entry
            for w, built, g in ((pw, pbuilt, pw.engine.prefill_graphs),
                                (dw, dbuilt, dw.engine.graphs)):
                if g.counts != built:
                    raise SystemExit(f"disagg: serving built programs: "
                                     f"{g.counts} after warm-up {built}")
            result["recomputes"] = len(replays)
            result["layout"] = layout
            # a broker chunk (8 frames' worth), within half the pool
            result["bandwidth"] = _transfer_bandwidth(
                dw.engine, min(8 * layout.blocks_per_chunk(
                    dw.engine.config.transfer_chunk_bytes),
                    (dw.engine.config.num_blocks - 1) // 2), card)

    asyncio.run(run())
    L = mc.n_layers
    block_bytes = result["layout"].block_bytes()
    chunk = result["layout"].blocks_per_chunk(cfg.transfer_chunk_bytes) \
        * block_bytes
    for tier, e in result["tiers"].items():
        one, dm, pm = e["one"], e["decode"], e["prefill"]
        bad = [i for i, r in enumerate(one)
               if r[1] != "length" or len(r[0]) != 32]
        if bad:
            raise SystemExit(f"disagg {tier}: requests {bad} did not finish "
                             "with 32 tokens")
        e["parted"] = _check_streams(f"disagg {tier}", one, ref_one, reqs,
                                     params, mc, device)
        gbs = (dm["pull_blocks"] * block_bytes / dm["pull_seconds"] / 1e9
               if dm["pull_seconds"] else 0.0)
        e["transfer_gb_s"], xfer_s = _transfer_gb_s(e["timed"], block_bytes)
        log(f"disagg {tier} tier, one at a time ({card}): from each pull's "
            f"source to its last inject {xfer_s:.3f} s = "
            f"{e['transfer_gb_s']:.2f} GB/s")
        log(f"disagg {tier} tier, one at a time ({card}): streams equal to "
            f"the aggregated engine's for {5 - len(e['parted'])} of 5; "
            f"decode worker prefill tokens {dm['prefill_tokens']}, prefill "
            f"dispatches {dm['prefill_steps']}, decode steps "
            f"{dm['decode_steps']}, pulled blocks {dm['pull_blocks']} "
            f"(expected {sum(want_pulls)} = {want_pulls}) in "
            f"{dm['pull_seconds']:.3f} s of pulls = {gbs:.2f} GB/s; prefill "
            f"worker prefill dispatches {pm['prefill_steps']}, decode steps "
            f"{pm['decode_steps']}; parked after the pulls "
            f"{sorted(e['parked'])}; request 1's {e['sent_chunks']} chunks "
            f"injected bit-equal to the sender's: {e['blocks_equal']}; "
            f"prefill hop s {[round(r[4], 4) for r in one]}")
        if dm["prefill_tokens"] or dm["prefill_steps"]:
            raise SystemExit(f"disagg {tier}: the decode worker prefilled "
                             "(a failed pull's local fallback?)")
        if dm["pull_blocks"] != sum(want_pulls):
            raise SystemExit(f"disagg {tier}: pulled {dm['pull_blocks']} "
                             f"blocks, expected {sum(want_pulls)}")
        if pm["decode_steps"] or e["parked"] or not e["blocks_equal"]:
            raise SystemExit(f"disagg {tier}: the prefill worker decoded, "
                             "kept parked KV or sent other blocks than "
                             "landed")
        conc = e["conc"]
        n, secs = _decode_rate(conc)
        rn, rsecs = _decode_rate(ref_conc)
        log(f"disagg {tier} tier, the five at once ({card}): ttft s through "
            f"the pair {[round(r[2], 4) for r in conc]} (prefill hop "
            f"{[round(r[4], 4) for r in conc]}) against the aggregated "
            f"engine's {[round(r[2], 4) for r in ref_conc]}; decode "
            f"{n / secs:.1f} tokens/s against {rn / rsecs:.1f}")
        e["pull_gb_s"] = gbs
    host_max = result["tiers"]["host"]["host_chunk_max"]
    log(f"disagg: pull_host_chunk_bytes_max {host_max} bytes against two "
        f"chunks {2 * chunk} bytes ({chunk // block_bytes} blocks of "
        f"{block_bytes} bytes a chunk under transfer_chunk_bytes "
        f"{cfg.transfer_chunk_bytes}); broker chunks of up to "
        f"{8 * chunk // block_bytes} blocks stay on the device")
    if not 0 < host_max <= 2 * chunk:
        raise SystemExit("disagg: host-staged chunks exceed two chunks")
    if result["tiers"]["broker"]["host_chunk_max"]:
        raise SystemExit("disagg: the broker tier staged chunks on the host")
    if result["recomputes"]:
        raise SystemExit("disagg: the decode worker recomputed a first token")
    launches = result["tiers"]["broker"]["launches"]
    steps = result["tiers"]["broker"]
    need_pre = L * steps["prefill"]["prefill_steps"]
    need_dec = L * steps["decode"]["decode_steps"]
    log(f"disagg launches, broker tier one at a time: {k3.__name__} "
        f"{launches[k3.__name__]} (>= {need_pre} = {L} layers x "
        f"{steps['prefill']['prefill_steps']} prefill replays on the prefill "
        f"worker), {k1.__name__} {launches[k1.__name__]} (>= {need_dec} = "
        f"{L} x {steps['decode']['decode_steps']} decode steps on the decode "
        f"worker)")
    if launches[k3.__name__] < need_pre or launches[k1.__name__] < need_dec \
            or not need_pre or not need_dec:
        raise SystemExit("disagg: the pair did not run through both kernels")
    out = {"launches": {k1.__name__: (0, launches[k1.__name__]),
                        k3.__name__: (launches[k3.__name__], 0)},
           "bandwidth": result["bandwidth"],
           "pull_gb_s": {t: e["pull_gb_s"]
                         for t, e in result["tiers"].items()},
           "transfer_gb_s": {t: e["transfer_gb_s"]
                             for t, e in result["tiers"].items()},
           # the aggregated engine's streams, one at a time: the
           # --disagg-ipc phase's reference too
           "ref_one": ref_one}
    out["launches"].update(check_disagg_int8(device, card, params))
    return out


def check_disagg_int8(device, card: str, params) -> dict:
    """Request 1 through an int8 prefill/decode pair (both caches int8,
    sized by INT8_KV_HBM_GB, no warm-up: the first run captures), once a
    tier, against an aggregated int8 engine: the scale planes ride along,
    so the stream must equal the aggregated one, with no prefill on the
    decode side.  Returns {kernel: (prefill worker's launches, decode
    worker's)} of the broker tier's run."""
    cfg = _engine_config("int8")
    mc = cfg.resolve_model()
    req = _requests(mc.vocab_size)[1]
    ref, _ = _aggregated_reference(device, cfg, params, [req], warmup=False)
    k1, k3 = _kernels_of("int8")
    got = {}

    async def run():
        async with _disagg_pair(device, cfg, params, warmup=False) as (
                pw, dw, pclient, dclient):
            for tier in ("broker", "host"):
                with _broker_off(tier == "host"):
                    m0 = dict(dw.engine.metrics)
                    for fn in (k1, k3):
                        fn.launches = 0
                    res = await _disagg_one(pclient, dclient, req,
                                            time.perf_counter())
                    got[tier] = (res, {fn.__name__: fn.launches
                                       for fn in (k1, k3)},
                                 dw.engine.metrics["prefill_tokens"]
                                 - m0["prefill_tokens"],
                                 dw.engine.metrics.get("pull_blocks", 0)
                                 - m0.get("pull_blocks", 0))
                    for w in (pw, dw):
                        await w.engine.clear_kv_blocks()

    asyncio.run(run())
    for tier, (res, launches, pre, pulled) in got.items():
        log(f"disagg int8 {tier} tier: request 1 {len(res[0])} out, "
            f"finish={res[1]}, equal to the aggregated int8 engine's: "
            f"{res[0] == ref[0][0]}; decode worker prefill tokens {pre}, "
            f"pulled {pulled} blocks; launches {launches}")
        if res[1] != "length" or len(res[0]) != 32 or pre or pulled != 4:
            raise SystemExit(f"disagg int8 {tier}: the request did not "
                             "finish by a pull")
        _check_streams(f"disagg int8 {tier}", [res], ref, [req], params, mc,
                       device)
    launches = got["broker"][1]
    if not (launches[k1.__name__] and launches[k3.__name__]):
        raise SystemExit("disagg int8: the pair did not run through both "
                         "int8 kernels")
    return {k1.__name__: (0, launches[k1.__name__]),
            k3.__name__: (launches[k3.__name__], 0)}


# ---------------------------------------------------------------------------
# disagg across processes: the device tier over CUDA IPC
# ---------------------------------------------------------------------------

IPC_OPT_IN = "DYN_KV_TRANSFER_SERVER"
# seconds the prefill worker process may take to build its weights, warm
# up and register, and to drain and exit on SIGTERM
IPC_READY_S = 400.0
IPC_EXIT_S = 120.0


def _start_prefill_process(cfg, disc: str, log_path: str):
    """`python -m dynamo_tpu_torch.engine --role prefill` at `cfg`'s model
    and cache, with the device tier opted in, file discovery under `disc`
    and the in-process event plane (the pair needs discovery and the
    request plane only).  Returns the process once it printed its ready
    line."""
    import select

    env = dict(os.environ, DYN_KV_TRANSFER_SERVER="1",
               DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=disc,
               DYN_EVENT_PLANE="inproc", DYN_LOG_JSON="0",
               DYN_LOG_LEVEL="INFO")
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.engine",
           "--role", "prefill", "--component", "prefill",
           "--model", cfg.model, "--block-size", str(cfg.block_size),
           "--num-blocks", str(cfg.num_blocks),
           "--max-blocks-per-seq", str(cfg.max_blocks_per_seq),
           "--max-num-seqs", str(cfg.max_num_seqs),
           "--kv-cache-dtype", cfg.kv_cache_dtype]
    with open(log_path, "w") as err:
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    deadline = time.monotonic() + IPC_READY_S
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("ready instance_id="):
                return proc
            if not line and proc.poll() is not None:
                break
    proc.kill()
    proc.wait()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    raise SystemExit(f"disagg ipc: the prefill worker process did not get "
                     f"ready (exit {proc.returncode}):\n{tail}")


def _stop_prefill_process(proc, log_path: str) -> tuple:
    """SIGTERM, wait; returns (exit code, its log's launch counts at ready
    and at exit, the staged chunk refs its drain dropped)."""
    import re
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=IPC_EXIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit("disagg ipc: the prefill worker process did not "
                         "exit on SIGTERM")
    with open(log_path) as f:
        text = f.read()
    counts = {w: json.loads(m) for w, m in re.findall(
        r"kernel launches at (ready|exit): (\{[^\n]*\})", text)}
    dropped = re.findall(r"drain: dropped (\d+) staged", text)
    if rc != 0 or set(counts) != {"ready", "exit"} or len(dropped) != 1:
        raise SystemExit(f"disagg ipc: the prefill worker process exited "
                         f"{rc}; log tail:\n{text[-3000:]}")
    return rc, counts, int(dropped[0])


def _same_prompt_rows(a, b, b0: int, prompt_len: int, bs: int) -> bool:
    """Two landed universal-layout chunk parts ([L, n, bs, ...] from block
    b0) bit-equal over the prompt's positions: a last block's tail past
    the prompt holds whatever the sender's block held before."""
    n = a.shape[1]
    keep = min(n * bs, prompt_len - b0 * bs)
    a = a.reshape(a.shape[0], n * bs, *a.shape[3:])[:, :keep]
    b = b.reshape(b.shape[0], n * bs, *b.shape[3:])[:, :keep]
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def check_disagg_ipc(device, card: str, params, ref_one=None,
                     broker_gb_s: Optional[float] = None) -> dict:
    """Disagg across two processes on one card, the device tier over CUDA
    IPC (disagg/device_transfer.py): a prefill worker process (the CLI,
    llama-8b at full width and depth, random weights from the engine's
    seed, which equal `params`; a bf16 cache of 512 blocks; opted in
    with DYN_KV_TRANSFER_SERVER=1) and a decode TorchEngineWorker in this
    process (the same config, `params`), both on file discovery under a
    temporary directory with the in-process event plane.  The five
    requests, one at a time from cleared prefix caches, in turns (IPC,
    host-staged, host-staged, IPC: the host-staged turns take the opt-in
    away from this process only, so the sender still advertises CUDA
    IPC and the receiver declines it).  Gates: every pull of an IPC turn
    moved device chunks only (no host chunk byte, no fallback) and every
    pull of a host turn host frames only; the decode worker prefilled
    nothing and pulled exactly the expected blocks; streams equal the
    aggregated engine's `ref_one` (a parting only at a near-tie); every
    landed block of every turn bit-equal to the first IPC turn's over the
    prompt's positions (the host frames carry the JAX crc32 of the
    sender's bytes, so the IPC bytes are the sender's); no program built while serving; the prefill
    process dropped no staged chunk at its drain (every pull's close
    released its buffer) and exited 0 on SIGTERM.  Reports GB/s per tier
    from each pull's source to its last inject (the tier's own time)
    beside the broker's (`broker_gb_s`, the same call's --disagg phase)
    and of the engine's pull time (which holds the wait for admission
    behind the previous request's queued bursts), the device chunks'
    time split into the chunk RPC, the event wait and the copy (device
    ms), and TTFT per request.  Returns
    {"launches": {kernel: (prefill process's, decode worker's)}, ...}:
    the prefill process's launches over the four turns (its logged counts
    at exit less those at ready), the decode worker's in the first IPC
    turn."""
    import shutil
    import tempfile
    import uuid

    from dynamo_tpu_torch.disagg import device_transfer
    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.ops.kv_transfer import gather_universal
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    t_phase = time.perf_counter()
    cfg = _engine_config("bf16")
    mc = cfg.resolve_model()
    reqs = _requests(mc.vocab_size)
    if ref_one is None:
        ref_one, _ = _aggregated_reference(device, cfg, params, reqs,
                                           warmup=True)
    want_pulls = _expected_pulls(reqs, cfg.block_size)
    k1, k3 = _kernels_of("bf16")
    tmp = tempfile.mkdtemp(prefix="dyn-disagg-ipc-")
    disc = os.path.join(tmp, "discovery")
    log_path = os.path.join(tmp, "prefill-worker.log")
    t0 = time.perf_counter()
    proc = _start_prefill_process(cfg, disc, log_path)
    log(f"disagg ipc: prefill worker process ready in "
        f"{time.perf_counter() - t0:.1f} s (pid {proc.pid})")
    saved = os.environ.get(IPC_OPT_IN)
    os.environ[IPC_OPT_IN] = "1"
    turns = ["ipc", "host", "host", "ipc"]
    result = {}

    async def run():
        rt = await DistributedRuntime(config=RuntimeConfig(
            discovery_backend="file", discovery_path=disc,
            event_plane="inproc", tcp_host="127.0.0.1"),
            cluster_id=uuid.uuid4().hex).start()
        dw, clients = None, []
        try:
            t0 = time.perf_counter()
            dw = await TorchEngineWorker(rt, dataclasses.replace(
                cfg, role="decode", warmup=True), component="backend",
                params=params, device=device).start()
            srv = device_transfer.get_transfer_server()
            log(f"disagg ipc: decode worker started with warm-up in "
                f"{time.perf_counter() - t0:.1f} s; CUDA IPC here: "
                f"{srv.capability if srv else None}")
            if srv is None:
                raise SystemExit("disagg ipc: CUDA IPC unavailable in the "
                                 "decode process (the probe failed)")
            for comp, ep in (("prefill", "generate"), ("backend", "generate"),
                             ("prefill", "clear_kv_blocks")):
                c = await rt.namespace("dynamo").component(comp).endpoint(
                    ep).client().start()
                await c.wait_for_instances()
                clients.append(c)
            pclient, dclient, pclear = clients
            built = _program_counts(dw.engine)
            inject = dw.engine._inject_pulled_chunk
            landed: dict = {}

            def recorded(slot, b0, n, arrs):
                # block by block: the tiers' chunks differ in width
                inject(slot, b0, n, arrs)
                rid = slot.request.request_id
                ids = dw.engine.allocator.seq_block_ids(rid)[b0:b0 + n]
                parts = gather_universal(dw.engine.kv, ids)
                for j in range(n):
                    landed[(rid, b0 + j)] = [p[:, j:j + 1] for p in parts]

            dw.engine._inject_pulled_chunk = recorded
            prompt_len = {r.request_id: len(r.token_ids) for r in reqs}
            first, out = None, []
            for i, tier in enumerate(turns):
                os.environ[IPC_OPT_IN] = "1" if tier == "ipc" else "0"
                await dw.engine.clear_kv_blocks()
                async for _ in pclear.generate({}):
                    pass
                await asyncio.sleep(1.1)
                landed.clear()
                if i == 0:
                    for fn in (k1, k3):
                        fn.launches = 0
                m0 = dict(dw.engine.metrics)
                timed, restore = _pull_timer(dw.engine)
                one, stats = [], []
                for r in reqs:
                    t = time.perf_counter()
                    one.append(await _disagg_one(pclient, dclient, r, t))
                    # the pull reached its source once the slot was admitted
                    stats.append(dict(dw.pull_stats.get(r.request_id, {}),
                                      pull_start_s=timed[r.request_id][0] - t))
                restore()
                if i == 0:
                    launches = {fn.__name__: fn.launches for fn in (k1, k3)}
                dm = {k: dw.engine.metrics.get(k, 0) - m0.get(k, 0)
                      for k in ("prefill_tokens", "prefill_steps",
                                "decode_steps", "pull_blocks",
                                "pull_seconds")}
                if first is None:
                    first = dict(landed)
                    differ = [] if first else ["none landed"]
                elif sorted(first) != sorted(landed):
                    differ = ["the landed blocks' keys"]
                else:
                    differ = [key for key in sorted(first) if not all(
                        _same_prompt_rows(a, b, key[1], prompt_len[key[0]],
                                          cfg.block_size)
                        for a, b in zip(first[key], landed[key]))]
                out.append({"tier": tier, "one": one, "stats": stats,
                            "decode": dm, "differ": differ, "timed": timed})
            del dw.engine._inject_pulled_chunk
            result["turns"] = out
            result["launches"] = launches
            result["built"] = (built, _program_counts(dw.engine))
            result["block_bytes"] = dw.engine.kv_wire_layout().block_bytes()
        finally:
            for c in clients:
                await c.close()
            if dw is not None:
                await dw.close()
                _free_engine(dw.engine)
            await rt.shutdown()

    try:
        asyncio.run(run())
    finally:
        if saved is None:
            os.environ.pop(IPC_OPT_IN, None)
        else:
            os.environ[IPC_OPT_IN] = saved
        rc, counts, dropped = _stop_prefill_process(proc, log_path)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    pre_launches = {k: counts["exit"][k] - counts["ready"][k]
                    for k in counts["exit"]}
    log(f"disagg ipc: the prefill worker process exited {rc} on SIGTERM; "
        f"its drain dropped {dropped} staged chunk refs; its launches over "
        f"the four turns {pre_launches}; the decode worker's in turn 1 "
        f"{result['launches']}")
    if dropped:
        raise SystemExit("disagg ipc: the sender's registry held staged "
                         "chunks after every pull closed")
    built, after = result["built"]
    if built != after:
        raise SystemExit(f"disagg ipc: serving built programs: {after} "
                         f"after warm-up {built}")
    block_bytes = result["block_bytes"]
    gb_s, xfer_gb_s = {}, {}
    for i, e in enumerate(result["turns"]):
        tier, one, dm, stats = e["tier"], e["one"], e["decode"], e["stats"]
        bad = [j for j, r in enumerate(one)
               if r[1] != "length" or len(r[0]) != 32]
        if bad:
            raise SystemExit(f"disagg ipc turn {i + 1}: requests {bad} did "
                             "not finish with 32 tokens")
        _check_streams(f"disagg ipc turn {i + 1} ({tier})", one, ref_one,
                       reqs, params, mc, device)
        if dm["prefill_tokens"] or dm["prefill_steps"] \
                or dm["pull_blocks"] != sum(want_pulls):
            raise SystemExit(f"disagg ipc turn {i + 1}: the decode worker "
                             f"prefilled or pulled {dm['pull_blocks']} "
                             f"blocks (expected {sum(want_pulls)})")
        dev = [s.get("device_chunks", 0) for s in stats]
        host = [s.get("host_bytes", 0) for s in stats]
        falls = sum(s.get("fallbacks", 0) for s in stats)
        if tier == "ipc" and (not all(dev) or any(host) or falls):
            raise SystemExit(f"disagg ipc turn {i + 1}: a pull left the "
                             f"device tier: device chunks {dev}, host bytes "
                             f"{host}, fallbacks {falls}")
        if tier == "host" and (any(dev) or not all(host)):
            raise SystemExit(f"disagg ipc turn {i + 1}: a host-staged pull "
                             f"moved device chunks {dev}")
        if e["differ"]:
            raise SystemExit(f"disagg ipc turn {i + 1}: landed blocks differ "
                             f"from the first IPC turn's: {e['differ']}")
        gbs = (dm["pull_blocks"] * block_bytes / dm["pull_seconds"] / 1e9
               if dm["pull_seconds"] else 0.0)
        xfer, xfer_s = _transfer_gb_s(e["timed"], block_bytes)
        gb_s.setdefault(tier, []).append(gbs)
        xfer_gb_s.setdefault(tier, []).append(xfer)
        n_dev = sum(dev)
        split = ""
        if n_dev:
            rpc = sum(s.get("rpc_s", 0.0) for s in stats) / n_dev * 1e3
            wait = sum(s.get("wait_ms", 0.0) for s in stats) / n_dev
            copy = sum(s.get("copy_ms", 0.0) for s in stats) / n_dev
            nbytes = sum(s.get("device_bytes", 0) for s in stats)
            copy_gb_s = nbytes / n_dev / copy / 1e6 if copy else 0.0
            split = (f"; {n_dev} device chunks ({nbytes / 2**20:.0f} MiB), "
                     f"a chunk's RPC {rpc:.2f} ms (host), event wait "
                     f"{wait:.3f} ms and copy {copy:.3f} ms (device) = "
                     f"{copy_gb_s:.1f} GB/s copied")
            e["split_ms"] = {"rpc": rpc, "wait": wait, "copy": copy}
        log(f"disagg ipc turn {i + 1} ({tier}, {card}): pulled "
            f"{dm['pull_blocks']} blocks in {dm['pull_seconds']:.3f} s of "
            f"pulls = {gbs:.2f} GB/s (from each pull's source to its last "
            f"inject {xfer_s:.3f} s = {xfer:.2f} GB/s){split}; host chunk "
            f"bytes {sum(host)}; "
            f"ttft s {[round(r[2], 4) for r in one]} (prefill hop "
            f"{[round(r[4], 4) for r in one]}, the pull's start "
            f"{[round(s['pull_start_s'], 4) for s in stats]}, its open RPC "
            f"{[round(s.get('open_s', 0.0), 4) for s in stats]}); blocks "
            f"bit-equal to turn 1's: {not e['differ']}")
    ratio = min(xfer_gb_s["ipc"]) / max(xfer_gb_s["host"])
    log(f"disagg ipc ({card}): GB/s from each pull's source to its last "
        f"inject, IPC {[round(g, 2) for g in xfer_gb_s['ipc']]}, host-staged "
        f"{[round(g, 2) for g in xfer_gb_s['host']]} (IPC at least "
        f"{ratio:.1f}x), broker (this call's --disagg phase) "
        f"{None if broker_gb_s is None else round(broker_gb_s, 2)}; of pull "
        f"time (the engine's, from the request's arrival, the wait for "
        f"admission included), IPC {[round(g, 2) for g in gb_s['ipc']]}, "
        f"host-staged {[round(g, 2) for g in gb_s['host']]}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    launches = result["launches"]
    if not (launches[k1.__name__] and pre_launches[k3.__name__]):
        raise SystemExit("disagg ipc: the pair did not run through both "
                         "kernels")
    return {"launches": {k1.__name__: (0, launches[k1.__name__]),
                         k3.__name__: (pre_launches[k3.__name__], 0)},
            "gb_s": gb_s, "transfer_gb_s": xfer_gb_s, "turns": [
                {k: e.get(k) for k in ("tier", "decode", "split_ms")}
                for e in result["turns"]]}


# ---------------------------------------------------------------------------
# KVBM: the multi-tier KV block manager (G2 pinned host memory, G3 disk,
# G4 shared object store, the cross-worker pull)
# ---------------------------------------------------------------------------

# prompt A: 1800 tokens, 14 full blocks of 128 (224 MiB of bf16 at
# llama-8b width); the churn: distinct 1800-token prompts served one at a
# time, enough that A keeps no block in a 64-block G1 (each request holds
# 15 blocks; the LRU evicts A's first)
KVBM_PROMPT = 1800
KVBM_CHURN = 5
KVBM_BLOCKS = 64
# G3's capacity: A and the churn offload 6 x 14 blocks, 8 of which G2
# keeps, so a disk of 64 would drop A's oldest blocks before the repeat
KVBM_DISK_BLOCKS = 96
# the G4 ops' deadline in this phase: a 16 MiB blob on a slow mount must
# not time out into a recompute the checks would call a failure
KVBM_IO_DEADLINE_S = 2.0


def _greedy(tokens, rid: str):
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    return PreprocessedRequest(
        token_ids=list(tokens), request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=32, ignore_eos=True))


def _kvbm_prompts(vocab: int) -> tuple:
    """(prompt A, the churn prompts, a short tick prompt), seed 11."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, vocab, KVBM_PROMPT).tolist()
    churn = [rng.integers(0, vocab, KVBM_PROMPT).tolist()
             for _ in range(KVBM_CHURN)]
    return a, churn, rng.integers(0, vocab, 37).tolist()


def _kvbm_config(kv_dtype: str, **kw):
    """The engine runs' config (_engine_config) with a 64-block G1 and the
    offload watermark at the pool, so every step offloads before it evicts
    (tests/test_kvbm.py:239); `kw` sets the tiers."""
    return dataclasses.replace(
        _engine_config("bf16"), kv_cache_dtype=kv_dtype,
        num_blocks=KVBM_BLOCKS, offload_watermark_blocks=KVBM_BLOCKS,
        kv_io_deadline_s=KVBM_IO_DEADLINE_S, **kw)


def _a_hashes(a, bs: int) -> list:
    from dynamo_tpu_torch.tokens import compute_block_hashes_for_request

    return compute_block_hashes_for_request(a, bs)[:(len(a) - 1) // bs]


async def _repeat(eng, req) -> tuple:
    """Serve `req` alone on the idle engine `eng`: (its _serve result,
    (metrics before, metrics after, where its TTFT went: each prefill
    dispatch's ms after the request's start, rows and tokens from the FPM
    records, and the garbage-collector passes inside it))."""
    await _idle(eng)
    m0 = dict(eng.metrics)
    pauses: list = []
    w0 = time.monotonic()
    with gc_pauses(pauses):
        res = (await _serve(eng, [req]))[0]
    trace = (f"prefill dispatches (ms after the start, rows, tokens) "
             f"{_prefill_dispatches(eng.fpm, w0)}, {len(pauses)} GC passes "
             f"{1e3 * sum(pauses):.1f} ms")
    return res, (m0, dict(eng.metrics), trace)


async def _idle(eng) -> None:
    """Wait until `eng` has nothing queued: no request, no burst in
    flight or being read back (the step lock free), no first token
    unread, no offload copy uncommitted, the device done.  A request sent
    right after another's stream ends would wait out that request's
    unread bursts first (overshoot the device still runs), which is not
    the TTFT of the tier it came back from."""
    while (eng.waiting or any(s is not None for s in eng._slots)
           or eng._inflight or eng._pending_first or eng._offloading
           or eng._step_lock.locked()):
        await asyncio.sleep(0.005)
    await asyncio.to_thread(torch.cuda.synchronize)


def _free_engine(eng) -> None:
    eng.kv = eng.graphs = eng.prefill_graphs = eng.guided_graphs = None
    eng.verify_graphs = eng.proposer = eng.padded_prefill = None
    gc.collect()
    torch.cuda.empty_cache()


def _prefix_blocks(eng, hashes) -> tuple:
    """The blocks G1 holds under `hashes`, gathered to the host."""
    from dynamo_tpu_torch.ops.kv_transfer import gather_universal

    ids = [eng.allocator._hash_to_block[h] for h in hashes]
    return tuple(t.cpu() for t in gather_universal(eng.kv, ids))


def _same_payload(x, y) -> bool:
    return len(x) == len(y) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        for a, b in zip(x, y))


def _kvbm_turn(device, card: str, cfg, params, prompts, what: str,
               count=()) -> dict:
    """One engine with `cfg` (warm-up capturing every program): prompt A,
    the churn one at a time, then A again once A keeps no block in G1.
    Launch counts of `count`'s wrappers are set to 0 just before A and
    read just after the repeat.  Frees the engine's cache."""
    from dynamo_tpu_torch.engine import TorchEngine

    a, churn, _ = prompts
    eng = TorchEngine(cfg, params=params, device=device)
    t0 = time.perf_counter()
    eng.warmup_decode()
    built = (_log_programs(eng, what), _log_prefill_programs(eng, what))
    log(f"{what}: warm-up in {time.perf_counter() - t0:.1f} s, "
        f"{cfg.num_blocks} blocks of {cfg.block_size}, host_cache_blocks "
        f"{cfg.host_cache_blocks}, disk {cfg.disk_cache_blocks}, object "
        f"store {bool(cfg.object_store_dir)}")
    hashes = _a_hashes(a, cfg.block_size)
    gc.collect()

    async def run():
        try:
            for fn in count:
                fn.launches = 0
            first = (await _serve(eng, [_greedy(a, "kvbm-a1")]))[0]
            t0 = time.perf_counter()
            churned = [(await _serve(eng, [_greedy(p, f"kvbm-c{i}")]))[0]
                       for i, p in enumerate(churn)]
            churn_s = time.perf_counter() - t0
            kept = eng.allocator.lookup(hashes)
            again, trace = await _repeat(eng, _greedy(a, "kvbm-a2"))
            launches = {fn.__name__: fn.launches for fn in count}
            return first, churned, churn_s, kept, again, trace, launches
        finally:
            await eng.close()

    first, churned, churn_s, kept, again, (m0, m1, trace), launches = \
        asyncio.run(run())
    if kept:
        raise SystemExit(f"{what}: A kept {kept} blocks in G1 after the "
                         "churn")
    if (eng.graphs.counts, eng.prefill_graphs.counts) != built:
        raise SystemExit(f"{what}: serving captured programs again: "
                         f"{eng.graphs.counts}, {eng.prefill_graphs.counts}")
    n_dec = sum(len(r[0]) - 1 for r in churned)
    dec_s = sum(r[3] - r[2] for r in churned)
    g2 = eng.kvbm.g2 if eng.kvbm is not None else None
    res = {
        "first": first, "again": again, "churn_s": churn_s,
        "decode_tok_s": n_dec / dec_s,
        "prefill": m1["prefill_tokens"] - m0["prefill_tokens"],
        "onboarded": {t: m1.get(f"kv_onboard_{t}", 0)
                      - m0.get(f"kv_onboard_{t}", 0)
                      for t in ("g2", "g3", "g4")},
        "launches": launches, "stats": dict(eng.kvbm.stats) if g2 else {},
        "offload_s": m1.get("offload_s", 0.0),
        "offload_wait_s": m1.get("offload_wait_s", 0.0),
        "offloaded_bytes": m1.get("offloaded_bytes", 0),
        "g2_bytes": g2.nbytes() if g2 else 0,
        "g2_pinned": sum(all(t.is_pinned() for t in b)
                         for b in g2._blocks.values()) if g2 else 0,
        "g2_blocks": len(g2) if g2 else 0,
        "blocks": _prefix_blocks(eng, hashes),
    }
    if eng.kvbm is not None and eng.kvbm.g3 is not None:
        res["g3_dir"] = eng.kvbm.g3.dir
    log(f"{what} ({card}): repeat ttft {again[2]:.4f} s (first "
        f"{first[2]:.4f} s; {trace}), repeat prefill tokens {res['prefill']}, "
        f"onboarded {res['onboarded']}; churn decode "
        f"{res['decode_tok_s']:.1f} tokens/s ({n_dec} tokens, "
        f"{KVBM_CHURN} requests in {churn_s:.2f} s); scheduler thread in "
        f"offload passes {res['offload_s']:.4f} s, waiting on copies "
        f"{res['offload_wait_s']:.4f} s (idle engine only); offloaded "
        f"{res['offloaded_bytes'] / 2**30:.3f} GiB; G2 {res['g2_blocks']} "
        f"blocks, {res['g2_bytes'] / 2**30:.3f} GiB, {res['g2_pinned']} "
        f"pinned; stats {res['stats']}; launches {launches}")
    _free_engine(eng)
    return res


def _kvbm_reference(device, card: str, kv_dtype: str, params,
                    prompts) -> dict:
    """KVBM off, 512 blocks: A, then A again (a G1 prefix hit of every
    full block); the repeat's tokens and its prefix blocks."""
    from dynamo_tpu_torch.engine import TorchEngine

    cfg = dataclasses.replace(_kvbm_config(kv_dtype), num_blocks=512)
    a = prompts[0]
    eng = TorchEngine(cfg, params=params, device=device)
    eng.warmup_decode()

    async def run():
        try:
            first = (await _serve(eng, [_greedy(a, "kvbm-ref1")]))[0]
            again, (m0, m1, trace) = await _repeat(eng,
                                                   _greedy(a, "kvbm-ref2"))
            return (first, again,
                    m1["prefill_tokens"] - m0["prefill_tokens"], trace)
        finally:
            await eng.close()

    first, again, prefilled, trace = asyncio.run(run())
    hashes = _a_hashes(a, cfg.block_size)
    ref = {"first": first, "again": again, "prefill": prefilled,
           "blocks": _prefix_blocks(eng, hashes)}
    log(f"kvbm reference ({kv_dtype}, KVBM off, 512 blocks, "
        f"{card}): repeat ttft {again[2]:.4f} s (G1 hit of "
        f"{len(hashes)} blocks, {prefilled} tokens prefilled; {trace}), "
        f"first ttft "
        f"{first[2]:.4f} s; repeat equal to the first stream: "
        f"{again[0] == first[0]}")
    _free_engine(eng)
    return ref


def _check_repeat(what: str, res: dict, ref: dict, tier: str,
                  n_blocks: int) -> None:
    """Exit unless the repeat onboarded all `n_blocks` of A, `tier`
    among them, computed at most 8 prefill tokens and streamed the
    reference repeat's tokens, with its prefix blocks bit-equal to the
    reference's."""
    got = res["onboarded"]
    ok = (sum(got.values()) == n_blocks and got[tier] > 0
          and res["prefill"] <= KVBM_PROMPT - n_blocks * 128
          and res["again"][0] == ref["again"][0]
          and res["again"][1] == "length"
          and _same_payload(res["blocks"], ref["blocks"]))
    log(f"{what}: onboarded {got} of {n_blocks} blocks, prefill tokens "
        f"{res['prefill']} (at most {KVBM_PROMPT - n_blocks * 128}), tokens "
        f"equal to the reference repeat's: {res['again'][0] == ref['again'][0]}"
        f", prefix blocks bit-equal: "
        f"{_same_payload(res['blocks'], ref['blocks'])}")
    if not ok:
        raise SystemExit(f"{what}: the repeat did not onboard A from {tier} "
                         "as the reference computed it")


def _kvbm_bandwidth(device, card: str, params, n: int) -> dict:
    """The offload's and the onboard's transfers on a bf16 cache of the
    KVBM config, n blocks, by CUDA events: the block-major gather against
    its byte bound (read and written once at 3.35 TB/s); the per-block
    device-to-host copies into pinned tensors against one contiguous
    pinned copy of the same bytes (the library yardstick), in turns; the
    upload and inject of blocks_from_host."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.ops.kv_transfer import blocks_from_host

    eng = TorchEngine(_kvbm_config("bf16"), params=params, device=device)
    kv = eng.kv
    idx = torch.arange(1, 1 + n, device=device)
    dst = list(range(1 + n, 1 + 2 * n))

    def gather():
        return [t.index_select(2, idx).permute(2, 0, 3, 1, 4).contiguous()
                for t in kv]

    major = gather()
    payload = sum(g.numel() * g.element_size() for g in major)
    pin = device.type == "cuda"
    hosts = [[torch.empty(g.shape[1:], dtype=g.dtype, pin_memory=pin)
              for g in major] for _ in range(n)]
    big = [torch.empty(g.shape, dtype=g.dtype, pin_memory=pin)
           for g in major]

    def per_block():
        for i in range(n):
            for h, g in zip(hosts[i], major):
                h.copy_(g[i], non_blocking=True)

    def one_copy():
        for b, g in zip(big, major):
            b.copy_(g, non_blocking=True)

    blocks = [tuple(h) for h in hosts]
    out = {"payload": payload, "gather_ms": time_ms(gather, 5, 2),
           "per_block_ms": [], "contiguous_ms": [],
           "onboard_ms": time_ms(lambda: blocks_from_host(kv, blocks, dst),
                                 3, 1)}
    for name in ("contiguous", "per_block", "per_block", "contiguous"):
        out[f"{name}_ms"].append(time_ms(
            one_copy if name == "contiguous" else per_block, 3, 1))
    moved = 2 * payload
    out["gather_bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
    gb = lambda nbytes, ms: nbytes / ms / 1e6  # noqa: E731
    log(f"kvbm transfers, {n} bf16 blocks ({payload / 2**20:.0f} MiB, "
        f"{card}): gather {out['gather_ms']:.3f} ms = "
        f"{gb(moved, out['gather_ms']):.1f} GB/s moved, "
        f"{100 * out['gather_bound_ms'] / out['gather_ms']:.1f}% of its "
        f"{out['gather_bound_ms']:.3f} ms byte bound; device-to-host "
        f"per-block pinned copies ms {[round(x, 3) for x in out['per_block_ms']]}"
        f" = {gb(payload, float(np.median(out['per_block_ms']))):.2f} GB/s "
        f"against one contiguous pinned copy ms "
        f"{[round(x, 3) for x in out['contiguous_ms']]} = "
        f"{gb(payload, float(np.median(out['contiguous_ms']))):.2f} GB/s; "
        f"onboard upload + inject {out['onboard_ms']:.3f} ms = "
        f"{gb(payload, out['onboard_ms']):.2f} GB/s")
    _free_engine(eng)
    return out


def _disk_bandwidth(card: str, blocks, directory: str) -> dict:
    """G3 write and read GB/s of `blocks` (per-block tensor tuples) in a
    fresh DiskBlockPool in `directory`: the puts (crc and npz included)
    timed on the host clock, then each file dropped from the page cache
    and every block read back and verified."""
    from dynamo_tpu_torch.kvbm.pools import DiskBlockPool

    pool = DiskBlockPool(directory, len(blocks))
    try:
        nbytes = sum(t.numel() * t.element_size() for b in blocks for t in b)
        t0 = time.perf_counter()
        for h, b in enumerate(blocks, 1):
            pool.put(h, *b)
        write_s = time.perf_counter() - t0
        for h in range(1, len(blocks) + 1):
            _evict(pool._path(h))
        t0 = time.perf_counter()
        back = [pool.get(h) for h in range(1, len(blocks) + 1)]
        read_s = time.perf_counter() - t0
        if not all(_same_payload(x, y) for x, y in zip(back, blocks)):
            raise SystemExit("kvbm: a G3 block read back other bytes")
    finally:
        pool.close()
    out = {"write_gb_s": nbytes / write_s / 1e9,
           "read_gb_s": nbytes / read_s / 1e9, "bytes": nbytes}
    log(f"kvbm G3 on {_fs_type(directory)} ({card}): {len(blocks)} "
        f"blocks, {nbytes / 2**20:.0f} MiB: write {write_s:.3f} s = "
        f"{out['write_gb_s']:.3f} GB/s, read (page cache dropped) "
        f"{read_s:.3f} s = {out['read_gb_s']:.3f} GB/s")
    return out


def _kvbm_remote(device, card: str, params, prompts, ref: dict) -> dict:
    """Two TorchEngineWorkers in one process sharing the weights (mem
    discovery, in-process event plane, TCP on 127.0.0.1), bf16, G2 on:
    W1 serves A and a tick (whose step offloads A's blocks); once W2's
    index sees W1's run, W2 serves A (routed by hand): it pulls A's
    blocks over kvbm_pull into its G2 and onboards them."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    a, _, tick = prompts
    cfg = _kvbm_config("bf16", host_cache_blocks=96, warmup=True)
    hashes = _a_hashes(a, cfg.block_size)

    async def run():
        rt = await DistributedRuntime(config=RuntimeConfig(
            discovery_backend="mem", event_plane="inproc",
            tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
        workers = []
        try:
            for _ in range(2):
                workers.append(await TorchEngineWorker(
                    rt, cfg, params=params, device=device).start())
            w1, w2 = workers
            built = [(w.engine.graphs.counts.copy(),
                      w.engine.prefill_graphs.counts.copy())
                     for w in workers]
            client = await rt.namespace("dynamo").component(
                "backend").endpoint("generate").client().start()
            await client.wait_for_instances()
            w1_id, w2_id = (w.served.instance_id for w in workers)

            async def serve(req, wid):
                t0 = time.perf_counter()
                toks, first = [], None
                async for out in client.generate(req.to_dict(),
                                                 instance_id=wid):
                    if out.get("token_ids") and first is None:
                        first = time.perf_counter() - t0
                    toks.extend(out.get("token_ids", []))
                return toks, first

            await serve(_greedy(a, "kvbm-r1"), w1_id)
            await serve(_greedy(tick, "kvbm-tick"), w1_id)
            t0 = time.monotonic()
            while w2._kvbm_index.best_run(hashes) != (w1_id, len(hashes)):
                if time.monotonic() - t0 > 30:
                    raise SystemExit("kvbm remote: W2's index never saw "
                                     "W1's G2 run of A")
                await asyncio.sleep(0.02)
            pulls = []
            fetch = w2.engine.remote_kvbm_fetch

            async def timed(hs):
                t = time.perf_counter()
                got = await fetch(hs)
                pulls.append((time.perf_counter() - t, got))
                return got

            w2.engine.remote_kvbm_fetch = timed
            await _idle(w2.engine)
            m0 = dict(w2.engine.metrics)
            toks, ttft = await serve(_greedy(a, "kvbm-r2"), w2_id)
            m1 = dict(w2.engine.metrics)
            blocks = _prefix_blocks(w2.engine, hashes)
            same_built = [(w.engine.graphs.counts,
                           w.engine.prefill_graphs.counts) for w in workers]
            await client.close()
            return toks, ttft, m0, m1, blocks, pulls, built == same_built
        finally:
            for w in workers:
                await w.close()
                _free_engine(w.engine)
            await rt.shutdown()

    toks, ttft, m0, m1, blocks, pulls, same_built = asyncio.run(run())
    pulled = sum(t.numel() * t.element_size()
                 for _, got in pulls for b in got for t in b[1:])
    pull_s = sum(s for s, _ in pulls)
    res = {"again": (toks, "length", ttft, 0.0), "blocks": blocks,
           "prefill": m1["prefill_tokens"] - m0["prefill_tokens"],
           "onboarded": {t: m1.get(f"kv_onboard_{t}", 0)
                         - m0.get(f"kv_onboard_{t}", 0)
                         for t in ("g2", "g3", "g4")},
           "remote_onboarded": m1.get("remote_onboarded", 0),
           "pull_gb_s": pulled / pull_s / 1e9 if pull_s else 0.0}
    log(f"kvbm remote ({card}): W2 pulled {res['remote_onboarded']} "
        f"blocks ({pulled / 2**20:.0f} MiB) in {pull_s:.3f} s = "
        f"{res['pull_gb_s']:.3f} GB/s over kvbm_pull; repeat ttft on W2 "
        f"{ttft:.4f} s (pull included); programs captured once on both "
        f"workers: {same_built}")
    if res["remote_onboarded"] != len(hashes) or not same_built:
        raise SystemExit("kvbm remote: W2 did not stage A's blocks from W1"
                         " or captured programs while serving")
    _check_repeat("kvbm remote", res, ref, "g2", len(hashes))
    return res


def check_kvbm(device, card: str, params) -> dict:
    """KVBM at llama-8b width and depth (weights `params`), a 64-block G1
    with the offload watermark at the pool.  Runs, each engine with its
    own cache and temp directories, freed before the next: (1) the
    reference, KVBM off, 512 blocks: A then A again (a G1 hit); (2) G2
    (96 blocks of pinned host memory, 1.5 GiB) and (3) the recompute
    baseline (KVBM off), in turns (2, 3, 3, 2): A, the churn one at a
    time, A again once A keeps no block in G1; (4) G3 (8 G2 blocks, 96 on
    disk); (5) G4 (8 G2 blocks, an object store directory); (6) G2 on an
    int8 cache against an int8 reference; (7) the cross-worker pull
    between two workers.  Every onboarded repeat must onboard all 14 of
    A's blocks from the named tier, prefill at most 8 tokens, stream the
    reference repeat's tokens and hold its prefix blocks bit-equal to the
    reference's; the recompute repeat prefills all 1800.  The first G2
    turn (bf16) and the int8 run are the KVBM main path: K1/K3's launch
    counts are set to 0 before and read after them."""
    import tempfile

    mc = _kvbm_config("bf16").resolve_model()
    prompts = _kvbm_prompts(mc.vocab_size)
    n_blocks = len(_a_hashes(prompts[0], 128))
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    k1, k3 = _kernels_of("bf16")
    k1i, k3i = _kernels_of("int8")
    ref = _kvbm_reference(device, card, "bf16", params, prompts)
    turns = {"g2": [], "off": []}
    for which in ("g2", "off", "off", "g2"):
        count = (k1, k3) if which == "g2" and not turns["g2"] else ()
        cfg = _kvbm_config("bf16", host_cache_blocks=96 if which == "g2"
                           else 0)
        res = _kvbm_turn(device, card, cfg, params, prompts,
                         f"kvbm {which} turn {len(turns[which]) + 1}",
                         count)
        turns[which].append(res)
        if which == "g2":
            _check_repeat(f"kvbm G2 turn {len(turns['g2'])}", res, ref,
                          "g2", n_blocks)
        elif res["prefill"] != KVBM_PROMPT or sum(res["onboarded"].values()):
            raise SystemExit("kvbm off: the repeat did not recompute A")
    launches = turns["g2"][0]["launches"]
    for fn in (k1, k3):
        if not launches[fn.__name__]:
            raise SystemExit(f"kvbm: {fn.__name__} did not launch")
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        g3 = _kvbm_turn(device, card, _kvbm_config(
            "bf16", host_cache_blocks=8, disk_cache_dir=os.path.join(d, "g3"),
            disk_cache_blocks=KVBM_DISK_BLOCKS), params, prompts, "kvbm G3")
        log(f"kvbm G3 directory on {_fs_type(d)}: demoted "
            f"{g3['stats'].get('demoted', 0)}, disk hits "
            f"{g3['stats'].get('disk_hits', 0)}")
        if not g3["stats"].get("demoted"):
            raise SystemExit("kvbm G3: nothing demoted to disk")
        _check_repeat("kvbm G3", g3, ref, "g3", n_blocks)
        disk = _disk_bandwidth(
            card, [tuple(t[:, i].contiguous() for t in ref["blocks"])
             for i in range(n_blocks)], os.path.join(d, "bw"))
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        g4 = _kvbm_turn(device, card, _kvbm_config(
            "bf16", host_cache_blocks=8, object_store_dir=d), params,
            prompts, "kvbm G4")
        log(f"kvbm G4 directory on {_fs_type(d)}: stats {g4['stats']}")
        _check_repeat("kvbm G4", g4, ref, "g4", n_blocks)
    ref8 = _kvbm_reference(device, card, "int8", params, prompts)
    int8 = _kvbm_turn(device, card, _kvbm_config("int8",
                                                 host_cache_blocks=96),
                      params, prompts, "kvbm G2 int8", (k1i, k3i))
    _check_repeat("kvbm G2 int8", int8, ref8, "g2", n_blocks)
    for fn in (k1i, k3i):
        if not int8["launches"][fn.__name__]:
            raise SystemExit(f"kvbm: {fn.__name__} did not launch")
    launches.update(int8["launches"])
    remote = _kvbm_remote(device, card, params, prompts, ref)
    bw = _kvbm_bandwidth(device, card, params, n_blocks)
    g2t = [r["again"][2] for r in turns["g2"]]
    offt = [r["again"][2] for r in turns["off"]]
    log(f"kvbm summary ({card}): A's repeat ttft s: G2 onboard {g2t} "
        f"against recompute {offt} (in turns), G3 {g3['again'][2]:.4f}, "
        f"G4 {g4['again'][2]:.4f}, int8 G2 {int8['again'][2]:.4f}, remote "
        f"{remote['again'][2]:.4f}; churn decode tokens/s KVBM on "
        f"{[round(r['decode_tok_s'], 1) for r in turns['g2']]} against off "
        f"{[round(r['decode_tok_s'], 1) for r in turns['off']]}; "
        f"scheduler seconds in offload passes "
        f"{[round(r['offload_s'], 4) for r in turns['g2']]}, waiting on "
        f"copies {[round(r['offload_wait_s'], 4) for r in turns['g2']]}; "
        f"G2 pinned bytes {turns['g2'][0]['g2_bytes']}")
    return {"launches": launches, "ttft": {"g2": g2t, "off": offt},
            "bandwidth": bw, "disk": disk,
            "pull_gb_s": remote["pull_gb_s"]}


# ---------------------------------------------------------------------------
# speculative decoding: n-gram and draft-model proposers, the packed verify
# program on K3 captured per bucket
# ---------------------------------------------------------------------------

# the repetition prompts: a random pattern of SPEC_PATTERN tokens repeated
# SPEC_REPEATS times (512 tokens), SPEC_NEW greedy tokens each
SPEC_PATTERN = 64
SPEC_REPEATS = 8
SPEC_NEW = 64


def _spec_requests(vocab: int):
    """The five requests plus two repetition prompts."""
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    reqs = _requests(vocab)
    rng = np.random.default_rng(9)
    for i in range(2):
        pattern = rng.integers(0, vocab, SPEC_PATTERN).tolist()
        reqs.append(PreprocessedRequest(
            token_ids=pattern * SPEC_REPEATS, request_id=f"smoke-rep-{i}",
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=SPEC_NEW, ignore_eos=True)))
    return reqs


def _check_greedy_streams(what: str, got, ref, reqs, params, mc, device):
    """_check_streams on the greedy requests: rejection sampling keeps a
    sampled request's distribution, not its spec-off draws."""
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    _check_streams(what, [got[i] for i in greedy], [ref[i] for i in greedy],
                   [reqs[i] for i in greedy], params, mc, device)


def _spec_config(kv_dtype: str, **kw):
    return dataclasses.replace(_engine_config(kv_dtype), **kw)


def _program_counts(eng) -> tuple:
    """Every program family's build counts (the draft's propose and
    catch-up programs where there is a draft)."""
    draft = getattr(eng.proposer, "programs", None)
    catchup = getattr(eng.proposer, "catchup", None)
    return (dict(eng.graphs.counts), dict(eng.prefill_graphs.counts),
            dict(eng.verify_graphs.counts) if eng.verify_graphs else None,
            dict(draft.counts) if draft is not None else None,
            dict(catchup.counts) if catchup is not None else None)


def _timed_verify(eng, into: list):
    """Wrap eng.verify_graphs.run so each dispatch records CUDA events
    around it on the stream: their interval is the dispatch's device time
    (the stream reaches the first event when the work queued before it is
    done)."""
    g = eng.verify_graphs
    run = g.run

    def timed(T):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(T)
        end.record()
        into.append((T, start, end))
        return out

    g.run = timed


def _spec_turn_record(path: str, res, eng, m0: dict) -> dict:
    n, secs = _decode_rate(res)
    m = {k: eng.metrics.get(k, 0) - m0.get(k, 0)
         for k in ("spec_steps", "spec_proposed", "spec_accepted",
                   "decode_tokens")}
    return {"path": path, "ttft_s": [round(r[2], 4) for r in res],
            "decode_tok_s": n / secs, **m,
            "acceptance": (m["spec_accepted"] / m["spec_proposed"]
                           if m["spec_proposed"] else None)}


def _check_verify_replay(eng, device) -> dict:
    """Bucket 32's replayed verify program against its eager body on the
    same descriptor (4 rows x 5 tokens at contexts 1800/500/100/37, blocks
    1-21 of the cache, row 1 sampled at T 0.7): ids, values and lse must be
    bit-equal.  Times 10 replays (CUDA events) and counts K3's launches
    per replay (the wrapper's count, which a replay raises by what its
    capture recorded).  Run after serving."""
    k3 = _kernels_of("bf16")[1]
    g = eng.verify_graphs
    a = g.host_descriptor(32)
    rng = np.random.default_rng(32)
    nxt, off = 1, 0
    for row, ctx in enumerate((1800, 500, 100, 37)):
        need = -(-(ctx + 5) // eng.config.block_size)
        a["tables"][row, :need] = np.arange(nxt, nxt + need)
        nxt += need
        a["toks"][off:off + 5] = rng.integers(0, eng.model_cfg.vocab_size, 5)
        a["positions"][off:off + 5] = ctx + np.arange(5)
        a["seg_ids"][off:off + 5] = row
        a["valid"][off:off + 5] = True
        a["temps_t"][off:off + 5] = 0.7 if row == 1 else 0.0
        off += 5
    g.upload(a)
    eager = [t.clone() for t in g.run_eager(32)]
    g.upload(a)
    replay = [t.clone() for t in g.run(32)]
    torch.cuda.synchronize()
    same = all(torch.equal(r, e) for r, e in zip(replay, eager))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n0 = k3.launches
    start.record()
    for _ in range(10):
        g.run(32)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 10
    per = (k3.launches - n0) / 10
    log(f"spec verify graph, bucket T=32 (4 rows x 5 tokens at contexts "
        f"1800/500/100/37): replayed ids, values and lse bit-equal to the "
        f"eager body: {same}; replay {ms:.3f} ms on the device; "
        f"{k3.__name__} launches per replay {per:g}")
    if not same:
        raise SystemExit("spec verify graph T=32: the replay differs from "
                         "the eager body")
    if per != eng.model_cfg.n_layers:
        raise SystemExit(f"spec verify graph T=32: {per:g} K3 launches a "
                         "dispatch, not one a layer")
    return {"replay_ms": ms, "k3_launches_per_dispatch": per}


def check_spec(device, card: str, params) -> dict:
    """Speculative decoding at llama-8b width and depth (random bf16
    weights `params`, a bf16 cache of 512 blocks), one process:

    * n-gram A/B: a spec-off and an n-gram engine (spec_k 4), both warmed
      up, serve the five requests and two repetition prompts in turns
      (off, ngram, ngram, off).  Gates: streams equal (a parting only at a
      near-tie), spec_steps > 0, each verify bucket's program captured once
      by warm-up and never while serving, a replayed verify bucket
      bit-equal to its eager body.  Reports TTFT, decode tokens/s,
      proposed/accepted, the median device time of a verify dispatch (CUDA
      events around each) and K3's launches per verify dispatch.
    * draft == target: the draft is llama-8b with the engine's seed, so
      its own weights equal the target's (checked); streams equal spec-off
      except at a near-tie, accepted >= proposed // 2, no capture while
      serving; tokens/s and the draft's eager catch-up prefills.
    * int8: one repetition request with n-gram on an int8 cache
      (INT8_KV_HBM_GB) against the int8 spec-off stream.

    Returns {"launches": {kernel: spec launches}, ...}."""
    from dynamo_tpu_torch.engine import TorchEngine

    t_phase = time.perf_counter()
    cfg = _spec_config("bf16")
    mc = cfg.resolve_model()
    reqs = _spec_requests(mc.vocab_size)
    k1, k3 = _kernels_of("bf16")
    off = TorchEngine(dataclasses.replace(cfg), params=params, device=device)
    ngram = TorchEngine(_spec_config("bf16", spec_decode="ngram", spec_k=4),
                        params=params, device=device)
    t0 = time.perf_counter()
    for eng in (off, ngram):
        eng.warmup_decode()
    vg = ngram.verify_graphs
    log(f"spec: engines off and ngram warmed up in "
        f"{time.perf_counter() - t0:.1f} s; verify programs built "
        f"{sorted(vg.counts.items())}, capture s "
        + ", ".join(f"T={T} {s:.2f}" for T, s in sorted(vg.capture_s.items()))
        + f", verify graph pool {vg.pool_bytes / 2**20:.0f} MiB")
    if vg.counts != {T: 1 for T in vg.buckets} or vg.buckets != (8, 16, 32):
        raise SystemExit(f"spec: warm-up built verify programs {vg.counts} "
                         f"for buckets {vg.buckets}, expected 8, 16, 32 once")
    built = _program_counts(ngram)
    gc.collect()
    verify_events: list = []

    async def ab():
        turns, streams, launches = [], {}, {}
        try:
            for i, path in enumerate(["off", "ngram", "ngram", "off"]):
                eng = off if path == "off" else ngram
                m0 = dict(eng.metrics)
                if i == 1:
                    for fn in (k1, k3):
                        fn.launches = 0
                    _timed_verify(ngram, verify_events)
                res = await _serve(eng, reqs)
                if i == 1:
                    launches.update({fn.__name__: fn.launches
                                     for fn in (k1, k3)})
                    del ngram.verify_graphs.run  # the class's again
                turns.append(_spec_turn_record(path, res, eng, m0))
                streams.setdefault(path, []).append(res)
                log(f"spec A/B turn {i + 1} ({card}): {turns[-1]}")
                await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
        finally:
            for eng in (off, ngram):
                await eng.close()
        return turns, streams, launches

    turns, streams, launches = asyncio.run(ab())
    for res in streams["off"] + streams["ngram"]:
        bad = [i for i, r in enumerate(res) if r[1] != "length"]
        if bad:
            raise SystemExit(f"spec: requests {bad} did not finish by length")
    ref = streams["off"][0]
    for what, got in (("spec off turn 4", streams["off"][1]),
                      ("spec ngram turn 2", streams["ngram"][0]),
                      ("spec ngram turn 3", streams["ngram"][1])):
        _check_greedy_streams(what, got, ref, reqs, params, mc, device)
    steps = sum(t["spec_steps"] for t in turns if t["path"] == "ngram")
    if not steps:
        raise SystemExit("spec: the n-gram engine never verified a draft")
    if _program_counts(ngram) != built:
        raise SystemExit(f"spec: serving built programs: "
                         f"{_program_counts(ngram)} after warm-up {built}")
    torch.cuda.synchronize()
    by_T: dict = {}
    for T, s, e in verify_events:
        by_T.setdefault(T, []).append(s.elapsed_time(e))
    verify_ms = {T: (float(np.median(v)), len(v)) for T, v in by_T.items()}
    log(f"spec: {steps} verify dispatches in the two ngram turns, none "
        f"captured a program; turn 2's verify dispatches by bucket: median "
        f"device ms and count {verify_ms}; spec launches (turn 2) "
        f"{launches}")
    if not (launches[k1.__name__] and launches[k3.__name__]):
        raise SystemExit("spec: the ngram turn did not launch K1 and K3")
    replay = _check_verify_replay(ngram, device)
    for eng in (off, ngram):
        _free_engine(eng)
    del off, ngram
    gc.collect()
    torch.cuda.empty_cache()
    log(f"spec n-gram A/B done at {time.perf_counter() - t_phase:.1f} s of "
        f"the phase")

    draft = check_spec_draft(device, card, params, reqs, ref)
    log(f"spec draft == target done at {time.perf_counter() - t_phase:.1f} "
        f"s of the phase")
    launches8 = check_spec_int8(device, card, params, reqs[-1])
    launches.update(launches8)
    log(f"spec phase done in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "turns": turns, "verify_ms": verify_ms,
            "replay": replay, "draft": draft}


def check_spec_draft(device, card: str, params, reqs, ref) -> dict:
    """Draft == target: llama-8b as its own draft, its weights made from
    the engine's seed by the proposer (a second 16 GB set, equal to
    `params`), its own 512-block cache; one warmed-up turn of `reqs`
    against the spec-off streams `ref`.  The draft's catch-up runs from
    one captured program per prefill bucket, each built by warm-up only
    (gated); each catch-up dispatch is timed by CUDA events around it
    (its device time) and its K3 launches counted (`catchup_launches`),
    beside the host time the proposer spends in catch-ups and the
    one-token catch-ups' share of a speculation round."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.models.llama import PRESETS

    cfg = _spec_config("bf16", spec_decode="draft", spec_k=4,
                       spec_draft_config=PRESETS["llama-8b"])
    mc = cfg.resolve_model()
    t0 = time.perf_counter()
    eng = TorchEngine(cfg, params=params, device=device)
    dp = eng.proposer.params
    same = all(torch.equal(dp[k], params[k]) for k in ("embedding",
                                                       "lm_head")) \
        and torch.equal(dp["layers"][-1]["w_down"],
                        params["layers"][-1]["w_down"])
    eng.warmup_decode()
    built = _program_counts(eng)
    cp = eng.proposer.catchup
    log(f"spec draft: engine with a llama-8b draft (its weights from seed "
        f"{cfg.seed}, equal to the target's: {same}) built and warmed up in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; draft "
        f"propose programs {sorted(built[3].items())}, catch-up programs "
        f"{sorted(built[4].items())} (capture s "
        + ", ".join(f"T={T} {x:.2f}" for T, x in sorted(cp.capture_s.items()))
        + f", pool {cp.pool_bytes / 2**20:.0f} MiB)")
    if not same:
        raise SystemExit("spec draft: the draft's weights differ from the "
                         "target's")
    if built[4] != {T: 1 for T in cp.buckets}:
        raise SystemExit(f"spec draft: warm-up built catch-up programs "
                         f"{built[4]} for buckets {cp.buckets}")
    k3 = _kernels_of("bf16")[1]
    timed: list = []
    cur = {"n": 0}
    propose, run_catchup = eng.proposer.propose, cp.run

    def counted_propose(tokens, k, *, ctx, draft_pos, block_table):
        cur["n"] = ctx - draft_pos
        return propose(tokens, k, ctx=ctx, draft_pos=draft_pos,
                       block_table=block_table)

    def timed_run(T):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        before = k3.launches
        ev[0].record()
        out = run_catchup(T)
        ev[1].record()
        timed.append((cur["n"], T, ev, k3.launches - before))
        return out

    eng.proposer.propose, cp.run = counted_propose, timed_run
    gc.collect()

    async def run():
        try:
            m0 = dict(eng.metrics)
            res = await _serve(eng, reqs)
            return res, _spec_turn_record("draft", res, eng, m0)
        finally:
            await eng.close()

    t_turn = time.perf_counter()
    res, rec = asyncio.run(run())
    t_turn = time.perf_counter() - t_turn
    del eng.proposer.propose, cp.run  # the classes' again
    torch.cuda.synchronize()
    catchup = dict(eng.proposer.metrics)
    dev_ms = [ev[0].elapsed_time(ev[1]) for _, _, ev, _ in timed]
    one_ms = [m for (n, _, _, _), m in zip(timed, dev_ms) if n == 1]
    rounds = rec["spec_steps"]
    round_ms = 1e3 * t_turn / rounds if rounds else 0.0
    catchup.update(
        catchup_device_s=sum(dev_ms) / 1e3,
        catchup_launches={k3.__name__: sum(x[3] for x in timed)},
        catchup_one_token=len(one_ms),
        catchup_one_token_ms=float(np.median(one_ms)) if one_ms else 0.0,
        round_ms=round_ms)
    log(f"spec draft turn ({card}): {rec}; the draft's catch-up on its "
        f"captured programs: {catchup['catchup_dispatches']} dispatches "
        f"(buckets {sorted(set(T for _, T, _, _ in timed))}), "
        f"{catchup['catchup_s']:.3f} s of host time, "
        f"{catchup['catchup_device_s']:.3f} s of device time, K3 launches "
        f"{catchup['catchup_launches']} (PR 9's eager catch-up: 6.81 s of "
        f"host time, 28.2 decode tokens/s); one-token catch-ups "
        f"{len(one_ms)}, median {catchup['catchup_one_token_ms']:.3f} ms of "
        f"device time against {round_ms:.2f} ms a speculation round "
        f"({rounds} rounds in {t_turn:.2f} s)")
    if any(r[1] != "length" for r in res):
        raise SystemExit("spec draft: a request did not finish by length")
    _check_greedy_streams("spec draft", res, ref, reqs, params, mc, device)
    if not rec["spec_proposed"] \
            or rec["spec_accepted"] < rec["spec_proposed"] // 2:
        raise SystemExit(f"spec draft: accepted {rec['spec_accepted']} of "
                         f"{rec['spec_proposed']} (need half)")
    if _program_counts(eng) != built:
        raise SystemExit(f"spec draft: serving built programs: "
                         f"{_program_counts(eng)} after warm-up {built}")
    if not catchup["catchup_dispatches"] \
            or len(timed) != catchup["catchup_dispatches"] \
            or not catchup["catchup_launches"][k3.__name__]:
        raise SystemExit("spec draft: the catch-up did not run through its "
                         "captured programs and K3")
    _free_engine(eng)
    del eng, dp
    gc.collect()
    torch.cuda.empty_cache()
    return {**rec, **catchup}


def check_spec_int8(device, card: str, params, req) -> dict:
    """One repetition request on int8 caches (INT8_KV_HBM_GB each): spec
    off, then n-gram (no warm-up: the first runs capture); the streams
    must be equal except at a near-tie.  Returns the int8 kernels'
    launches in the n-gram run."""
    from dynamo_tpu_torch.engine import TorchEngine

    k1, k3 = _kernels_of("int8")
    out = {}
    for path in ("off", "ngram"):
        kw = {"spec_decode": "ngram", "spec_k": 4} if path == "ngram" else {}
        eng = TorchEngine(_spec_config("int8", **kw), params=params,
                          device=device)

        async def run(eng=eng):
            try:
                for fn in (k1, k3):
                    fn.launches = 0
                return await _serve(eng, [req])
            finally:
                await eng.close()

        res = asyncio.run(run())
        launches = {fn.__name__: fn.launches for fn in (k1, k3)}
        out[path] = (res, dict(eng.metrics), launches)
        mc = eng.model_cfg
        _free_engine(eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    res, m, launches = out["ngram"]
    log(f"spec int8 ({card}): {req.request_id} {len(res[0][0])} out, "
        f"equal to the int8 spec-off stream: {res[0][0] == out['off'][0][0][0]}"
        f"; spec_steps {m.get('spec_steps', 0)} proposed "
        f"{m.get('spec_proposed', 0)} accepted {m.get('spec_accepted', 0)}; "
        f"launches {launches}")
    _check_streams("spec int8", res, out["off"][0], [req], params, mc, device)
    if not m.get("spec_steps") or not all(launches.values()):
        raise SystemExit("spec int8: no verify dispatch, or the int8 kernels "
                         "did not launch")
    return launches


# ---------------------------------------------------------------------------
# LoRA serving (a stacked adapter bank in the captured programs) and guided
# JSON decoding (the top-M programs over K1)
# ---------------------------------------------------------------------------

# the phase's adapters: (name, rank, file dtype, seed); alpha = 2 rank
LORA_ADAPTERS = (("ad1", 8, "BF16", 1), ("ad2", 16, "F32", 2),
                 ("ad3", 8, "BF16", 3))
LORA_RANK = 16
# the A and B factors' scale: the delta is of the order of the projection
# it is added to, so it changes the greedy streams
LORA_SCALE = 0.5
GUIDED_SCHEMA = {"type": "object", "properties": {
    "city": {"type": "string"}, "unit": {"enum": ["c", "f"]},
    "days": {"type": "integer"}}}
GUIDED_NEW = 64


def write_peft_adapter(root: str, name: str, cfg, rank: int, dtype: str,
                       seed: int) -> None:
    """A PEFT adapter of `cfg`'s width in root/name (adapter_config.json,
    adapter_model.safetensors with lora_A [r, d_in] and lora_B [d_out, r]
    for q/k/v/o of every layer), written with the standard library;
    random from `seed` (A ~ N(0, 1/d_in), B ~ N(0, 1/r), both times
    LORA_SCALE), in `dtype` ("BF16" | "F32"), lora_alpha = 2 rank."""
    gen = torch.Generator().manual_seed(seed)
    tdt = torch.bfloat16 if dtype == "BF16" else torch.float32
    dims = {"q": (cfg.d_model, cfg.q_dim), "k": (cfg.d_model, cfg.kv_dim),
            "v": (cfg.d_model, cfg.kv_dim), "o": (cfg.q_dim, cfg.d_model)}
    names, header, off = [], {}, 0
    for li in range(cfg.n_layers):
        for t, (d_in, d_out) in dims.items():
            p = f"base_model.model.model.layers.{li}.self_attn.{t}_proj"
            for ab, shape, fan in (("A", (rank, d_in), d_in),
                                   ("B", (d_out, rank), rank)):
                key = f"{p}.lora_{ab}.weight"
                n = shape[0] * shape[1] * tdt.itemsize
                header[key] = {"dtype": dtype, "shape": list(shape),
                               "data_offsets": [off, off + n]}
                names.append((key, shape, fan))
                off += n
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank,
                   "base_model_name_or_path": cfg.name,
                   "target_modules": ["q_proj", "k_proj", "v_proj",
                                      "o_proj"]}, f)
    hb = json.dumps(header).encode()
    hb += b" " * ((-(8 + len(hb))) % 8)
    with open(os.path.join(d, "adapter_model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for key, shape, fan in names:
            t = (torch.randn(shape, generator=gen) * (LORA_SCALE
                                                      / fan ** 0.5)).to(tdt)
            f.write((t.view(torch.int16) if tdt == torch.bfloat16
                     else t).numpy().tobytes())


def _lora_requests(vocab: int, loras) -> list:
    """The engine's first four prompts (1800, 500, 100, 37 tokens), 32
    greedy tokens each, on the adapters `loras` (None = base)."""
    reqs = _requests(vocab)[:4]
    return [dataclasses.replace(r, request_id=f"{r.request_id}-{lo}",
                                lora_name=lo,
                                sampling=dataclasses.replace(
                                    r.sampling, temperature=0.0))
            for r, lo in zip(reqs, loras)]


class _Fp32Layers:
    """The layers of a parameter tree, each upcast to fp32 on access (one
    layer at a time on the card)."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        for layer in self.layers:
            yield {k: ({kk: vv.float() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.float())
                   for k, v in layer.items()}


def _lora_delta_check(eng, device, src) -> dict:
    """For each adapter the engine holds: one 512-token prompt's
    first-token logits from the engine's prefill program (bucket 512, the
    prompt's tokens on the adapter's slot) against a plain fp32 forward
    (models/llama.py prefill with the weights upcast layer by layer, plain
    attention, x @ W + (x @ A) @ B on the adapter's fp32 tensors from the
    PEFT file): per-row relative L2, at most LORA_DELTA_TOL.  Slot 0 (the
    base model) is measured the same way as the yardstick, and each
    adapter's logits must move off the base ones by far more than the
    error.  Writes blocks 1-4 of the cache: run on an idle engine."""
    from dynamo_tpu_torch.lora.bank import empty_bank, write_adapter
    from dynamo_tpu_torch.models import llama

    mc, c = eng.model_cfg, eng.config
    T = 512
    toks = np.random.default_rng(17).integers(0, mc.vocab_size, T)
    g = eng.prefill_graphs
    cfg32 = dataclasses.replace(mc, dtype=torch.float32, attn_impl="torch",
                                packed_attn_impl="torch")
    p = eng.params
    ref_params = {"embedding": p["embedding"], "final_norm": p["final_norm"],
                  "lm_head": p["lm_head"].float(),
                  "layers": _Fp32Layers(p["layers"])}
    bank32 = empty_bank(mc.n_layers, c.lora_max_adapters + 1, c.lora_rank,
                        mc.d_model, mc.q_dim, mc.kv_dim, torch.float32,
                        device)
    for name, slot in eng._lora_slots.items():
        write_adapter(bank32, slot, src.load(name, mc.n_layers)
                      .padded_to(c.lora_rank).tensors)
    out, logits = {}, {}
    for name, slot in [("base", 0)] + sorted(eng._lora_slots.items()):
        a = g.host_descriptor(T)
        a["toks"][:] = toks
        a["positions"][:] = np.arange(T)
        a["valid"][:] = True
        a["lidx"][:] = slot
        a["last_idx"][0] = T - 1
        a["tables"][0, :4] = [1, 2, 3, 4]
        g.upload(a)
        g.run(T)
        got = g.logits[T][0].clone()
        kv32 = tuple(torch.zeros(s, dtype=torch.float32, device=device)
                     for s in llama.kv_cache_shapes(mc, 5, c.block_size))

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=device)

        ref, _ = llama.prefill(ref_params, cfg32, kv32, i32(toks),
                               i32(np.arange(T)), i32([1, 2, 3, 4]), 0, T,
                               lora_bank=bank32,
                               adapter_idx=torch.tensor(slot, device=device))
        del kv32
        err = row_rel_err(got[None], ref[None])
        logits[name] = got
        out[name] = {"slot": slot, "rel_l2": err}
    base = logits.pop("base")
    for name, got in logits.items():
        out[name]["moved_rel_l2"] = row_rel_err(got[None], base[None])
    log(f"lora: first-token logits of a 512-token prompt, the engine's "
        f"prefill program (bf16) against a plain fp32 forward with x@W + "
        f"(x@A)@B: per-row relative L2 {out} (limit {LORA_DELTA_TOL}; "
        f"moved_rel_l2 = the adapter's logits against the base ones)")
    for name, r in out.items():
        if not r["rel_l2"] <= LORA_DELTA_TOL:
            raise SystemExit(f"lora: adapter {name}'s logits are off the "
                             f"fp32 reference by {r['rel_l2']}")
        if name != "base" and not r["moved_rel_l2"] > 10 * r["rel_l2"]:
            raise SystemExit(f"lora: adapter {name} barely moves the logits "
                             f"({r['moved_rel_l2']})")
    return out


# the LoRA delta check's limit: per-row relative L2 of the engine's bf16
# logits against the fp32 forward
LORA_DELTA_TOL = 2e-2


def _check_lora_burst(eng, device) -> dict:
    """A replayed k = 8 greedy burst on lanes of slots 0, 1, 2, 1 against
    its eager body on the same inputs (_burst_inputs: random K/V): tokens
    bit-equal, K/V within K1's tolerance; the replay's device time."""
    g, k = eng.graphs, 8
    a, blocks = _burst_inputs(eng, device, seed=13)
    a["lidx"][:] = [0, 1, 2, 1]
    kv = eng.kv
    saved = [t[:, :, blocks].clone() for t in kv]
    snap = g.snapshot()

    def reset():
        for t, s in zip(kv, saved):
            t[:, :, blocks] = s
        g.restore(snap)
        g.upload(a)

    reset()
    eager = g.run_eager(True, k).clone()
    kv_eager = [t[:, :, blocks].clone() for t in kv]
    reset()
    replay = torch.from_numpy(g.run(True, k).wait().copy())
    same = torch.equal(eager.cpu(), replay)
    errs = [row_rel_err(t[:, :, blocks].float(), e.float())
            for t, e in zip(kv, kv_eager)]
    reset()
    ms = _replay_ms(g, k)
    for t, s in zip(kv, saved):
        t[:, :, blocks] = s
    g.restore(snap)
    log(f"lora: replayed k={k} greedy burst on slots [0, 1, 2, 1] equals "
        f"its eager body: tokens {same}, K/V max row relative error "
        f"{max(errs):.3e} (limit {REL_TOL}); replay {ms:.3f} ms")
    if not same or not max(errs) <= REL_TOL:
        raise SystemExit("lora: the replayed burst differs from its eager "
                         "body")
    return {"replay_ms": ms}


def _replay_ms(g, k: int, n: int = 5) -> float:
    """Device ms of one replay of the (greedy, k) program on the uploaded
    descriptor (CUDA events around n replays, the clock held still)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        g.continuation(0)
        g.run(True, k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _delta_step_ms(off, lora, device) -> dict:
    """The LoRA delta's device time a decode step: the same k = 8 burst
    (the engine's four contexts, random K/V) replayed by the bank-less
    engine and by the LoRA engine with every lane on an adapter, in turns
    (off, lora, lora, off); the difference of the medians over 8."""
    times = {"off": [], "lora": []}
    state = {}
    for name, eng in (("off", off), ("lora", lora)):
        a, blocks = _burst_inputs(eng, device, seed=19)
        if "lidx" in a:
            a["lidx"][:] = [1, 2, 1, 2]
        state[name] = (eng, a, blocks, [t[:, :, blocks].clone()
                                        for t in eng.kv],
                       eng.graphs.snapshot())
    for name in ("off", "lora", "lora", "off"):
        eng, a, _, _, _ = state[name]
        eng.graphs.upload(a)
        times[name].append(_replay_ms(eng.graphs, 8))
    for eng, a, blocks, saved, snap in state.values():
        for t, s in zip(eng.kv, saved):
            t[:, :, blocks] = s
        eng.graphs.restore(snap)
    med = {k: float(np.median(v)) for k, v in times.items()}
    out = {"burst_ms": times, "delta_ms_per_step": (med["lora"]
                                                    - med["off"]) / 8}
    log(f"lora: k=8 burst replay ms, bank-less / LoRA (every lane on an "
        f"adapter), in turns: {times}; the delta's device time a decode "
        f"step {out['delta_ms_per_step']:.3f} ms")
    return out


def _guided_requests(vocab: int) -> tuple:
    """(three guided requests: greedy, and two seeded at T 0.7 with the
    same seed; two unguided greedy ones), GUIDED_NEW tokens each, on the
    engine's 100- and 37-token prompts."""
    base = _requests(vocab)
    short = [base[2].token_ids, base[3].token_ids]
    guided = [dataclasses.replace(
        base[3], request_id=f"guided-{i}",
        sampling=dataclasses.replace(base[3].sampling, temperature=t,
                                     seed=s, top_p=1.0,
                                     guided_json=GUIDED_SCHEMA),
        stop=dataclasses.replace(base[3].stop, max_tokens=GUIDED_NEW,
                                 ignore_eos=False))
        for i, (t, s) in enumerate(((0.0, None), (0.7, 42), (0.7, 42)))]
    plain = [dataclasses.replace(
        base[2], request_id=f"plain-{i}", token_ids=p,
        sampling=dataclasses.replace(base[2].sampling, temperature=0.0,
                                     seed=None),
        stop=dataclasses.replace(base[2].stop, max_tokens=GUIDED_NEW))
        for i, p in enumerate(short)]
    return guided, plain


def _check_topm_replay(eng) -> dict:
    """The M = 32 guided program replayed against its eager body on one
    lane over blocks of the cache: ids and values bit-equal; each
    program's replay time and K1 launches a replay."""
    k1 = _kernels_of("bf16")[0]
    g = eng.guided_graphs
    a = g.host_descriptor()
    a["tokens"][1] = 7
    a["positions"][1] = a["ctx_lens"][1] = 500
    a["tables"][1, :4] = [1, 2, 3, 4]
    a["valid"][1] = True
    g.upload(a)
    eager = [t.clone() for t in g.run_eager(32)]
    g.upload(a)
    replay = [torch.from_numpy(b.wait().copy()) for b in g.run(32)]
    same = all(torch.equal(r, e.cpu()) for r, e in zip(replay, eager))
    ms = {}
    for m in g.ms:
        n0 = k1.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            g.run(m)
        end.record()
        end.synchronize()
        ms[m] = (start.elapsed_time(end) / 5, (k1.launches - n0) / 5)
    log(f"guided: replayed M=32 top-M program equals its eager body (ids "
        f"and values): {same}; replay ms and K1 launches a replay by M "
        f"{ms}")
    if not same:
        raise SystemExit("guided: the replayed M=32 program differs from "
                         "its eager body")
    return {"replay": {m: v[0] for m, v in ms.items()}}


def check_lora_guided(device, card: str, params,
                      ops_default: Optional[int] = None) -> dict:
    """LoRA serving and guided decoding at llama-8b width and depth
    (random bf16 weights `params`, bf16 caches of 512 blocks), one
    process.  Two PEFT adapters (rank 8 in bf16, rank 16 in fp32, all four
    attention targets, scaled to move the greedy streams) and a third for
    the eviction are written to $TMPDIR with the standard library.

    * A bank-less engine and a LoRA engine (lora_max_adapters 4,
      lora_rank 16), both warmed up.  The five requests, all base, on the
      LoRA engine stream bit-equal to the bank-less engine's.  Then the
      mixed batch (base, ad1, ad2, ad1 on the four prompts) against the
      same prompts without adapters on the bank-less engine, in turns
      (off, lora, lora, off): each LoRA stream equals the same request
      served alone on the LoRA engine (a parting only at a near-tie of
      its own logits) and each adapter stream differs from the base one;
      no program is captured while serving; a replayed burst on slots
      0/1/2/1 is bit-equal to its eager body; the delta's logits against
      an fp32 forward (_lora_delta_check).  Reports decode tokens/s,
      device operations per decode token with and without the bank
      (_body_ops), the operations a k = 8 program dispatches
      (_dispatched_ops: the bank-less engine's must equal `ops_default`,
      the default engine's in the same call), and the delta's device
      time a step.
    * Eviction: an engine with lora_max_adapters 2 serves ad1, ad2, then
      ad3, which takes the least recently used slot; ad3's stream equals
      the LoRA engine's (a near-tie aside).
    * Guided: on the bank-less engine, three guided requests (greedy, and
      two seeded at T 0.7 with one seed) beside two unguided ones, 64
      tokens each, after the two unguided alone.  Every guided output is
      a schema-valid document under the byte mock, the seeded two are
      equal, the unguided streams equal their solo run (a near-tie
      aside), both top-M programs were built by warm-up and never again,
      and a replayed M = 32 program is bit-equal to its eager body.
      Reports guided tokens/s, a guided step's device time (CUDA events
      around each top-M program) and host time, and the guided counters.

    Returns {"lora_launches": {kernel: n}, "guided_launches": {kernel:
    n}, ...}: K1/K3 launches in the mixed batch's first LoRA turn and in
    the guided run."""
    import tempfile

    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.guided import JsonSchemaGuide
    from dynamo_tpu_torch.lora import LocalLoraSource

    t_phase = time.perf_counter()
    k1, k3 = _kernels_of("bf16")
    base_cfg = _engine_config("bf16")
    mc = base_cfg.resolve_model()
    root = tempfile.mkdtemp(prefix="lora-")
    t0 = time.perf_counter()
    for name, rank, dtype, seed in LORA_ADAPTERS:
        write_peft_adapter(root, name, mc, rank, dtype, seed)
    log(f"lora: wrote {len(LORA_ADAPTERS)} PEFT adapters (ranks "
        f"{[a[1] for a in LORA_ADAPTERS]}) to {root} in "
        f"{time.perf_counter() - t0:.1f} s")
    lora_cfg = dataclasses.replace(base_cfg, lora_max_adapters=4,
                                   lora_rank=LORA_RANK, lora_dir=root)
    off = TorchEngine(dataclasses.replace(base_cfg), params=params,
                      device=device)
    lora = TorchEngine(lora_cfg, params=params, device=device)
    t0 = time.perf_counter()
    for eng in (off, lora):
        eng.warmup_decode()
    built = {}
    for name, eng in (("off", off), ("lora", lora)):
        built[name] = (_log_programs(eng, f"lora phase, {name}"),
                       _log_prefill_programs(eng, f"lora phase, {name}"),
                       dict(eng.guided_graphs.counts))
        if built[name][2] != {32: 1, 256: 1}:
            raise SystemExit(f"lora phase: warm-up built guided programs "
                             f"{built[name][2]}")
    log(f"lora: engines off and lora warmed up in "
        f"{time.perf_counter() - t0:.1f} s; guided capture s "
        f"{lora.guided_graphs.capture_s}, guided pool "
        f"{lora.guided_graphs.pool_bytes / 2**20:.0f} MiB; bank "
        f"{sum(t.numel() * t.element_size() for t in lora.lora_bank.values()) / 2**20:.0f} MiB")
    ops = {name: _body_ops(eng, 8) / (8 * eng.config.max_num_seqs)
           for name, eng in (("off", off), ("lora", lora))}
    dispatched = {name: _dispatched_ops(eng, 8)
                  for name, eng in (("off", off), ("lora", lora))}
    if ops_default is None:
        ops_default = dispatched["off"]
    log(f"lora: device operations per decode token (the profiler's device "
        f"count), bank-less {ops['off']:.1f}, with the bank "
        f"{ops['lora']:.1f}; operations a k=8 program dispatches (host "
        f"count), bank-less {dispatched['off']} (the default engine's in "
        f"this call {ops_default}), with the bank {dispatched['lora']}")
    if dispatched["off"] != ops_default:
        raise SystemExit("lora: the bank-less engine's decode programs "
                         "dispatch other operations than the default's")
    five = _requests(mc.vocab_size)
    mixed_loras = [None, "ad1", "ad2", "ad1"]
    mixed = _lora_requests(mc.vocab_size, mixed_loras)
    plain = _lora_requests(mc.vocab_size, [None] * 4)
    guided, unguided = _guided_requests(mc.vocab_size)
    g = off.guided_graphs
    events: list = []
    host_s: list = []
    run, step = g.run, off._guided_step

    def timed_run(m):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(m)
        end.record()
        events.append((m, start, end))
        return out

    def timed_step():
        n, t = len(events), time.perf_counter()
        step()
        if len(events) > n:  # a step that dispatched a top-M program
            host_s.append(time.perf_counter() - t)

    async def serve_guided(res):
        """Guided decoding on the bank-less engine: the unguided pair
        alone, then beside the three guided requests."""
        res["solo"] = await _serve(off, unguided)
        await off.clear_kv_blocks()
        m0 = dict(off.metrics)
        for fn in (k1, k3):
            fn.launches = 0
        g.run, off._guided_step = timed_run, timed_step
        t0 = time.perf_counter()
        res["both"] = await _serve(off, guided + unguided)
        res["guided_wall"] = time.perf_counter() - t0
        res["guided_launches"] = {fn.__name__: fn.launches
                                  for fn in (k1, k3)}
        del g.run, off._guided_step
        res["guided_metrics"] = {
            k: off.metrics.get(k, 0) - m0.get(k, 0)
            for k in ("guided_widened_retries", "guided_forced_closes",
                      "decode_tokens")}

    gc.collect()

    async def serve_lora():
        res = {"turns": []}
        try:
            res["five_off"] = await _serve(off, five)
            res["five_lora"] = await _serve(lora, five)
            for i, path in enumerate(("off", "lora", "lora", "off")):
                eng = off if path == "off" else lora
                if i == 1:
                    for fn in (k1, k3):
                        fn.launches = 0
                got = await _serve(eng, plain if path == "off" else mixed)
                if i == 0:
                    res["plain"] = got
                if i == 1:
                    res["launches"] = {fn.__name__: fn.launches
                                       for fn in (k1, k3)}
                    res["mixed"] = got
                n, secs = _decode_rate(got)
                res["turns"].append({"path": path, "decode_tok_s": n / secs,
                                     "ttft_s": [round(r[2], 4) for r in got]})
                log(f"lora turn {i + 1} ({card}): {res['turns'][-1]}")
                await eng.clear_kv_blocks()
            res["alone"] = [(await _serve(lora, [r]))[0] for r in mixed]
            await lora.clear_kv_blocks()
            res["ad3"] = (await _serve(lora, _lora_requests(
                mc.vocab_size, ["ad3"])))[0]
            await lora.clear_kv_blocks()
            await serve_guided(res)
        finally:
            await off.close()
            await lora.close()
        return res

    res = asyncio.run(serve_lora())
    if [r[0] for r in res["five_lora"]] != [r[0] for r in res["five_off"]]:
        raise SystemExit("lora: base requests on the LoRA engine differ "
                         "from the bank-less engine's streams")
    log("lora: the five base requests on the LoRA engine are bit-equal to "
        "the bank-less engine's streams")
    for got in [res["mixed"]] + [[r] for r in res["alone"]]:
        bad = [r for r in got if r[1] != "length" or len(r[0]) != 32]
        if bad:
            raise SystemExit("lora: a request did not finish with 32 tokens")
    parted = _check_streams("lora mixed batch vs alone", res["mixed"],
                            res["alone"], mixed, params, mc, device,
                            (lora.lora_bank, lora._lora_slots))
    # each adapter stream against the bank-less stream of its prompt
    for r, s, b in zip(mixed, res["mixed"], res["plain"]):
        if r.lora_name and s[0] == b[0]:
            raise SystemExit(f"lora: {r.request_id}'s stream equals the "
                             "base stream of its prompt")
    after = {name: ((dict(eng.graphs.counts),
                     dict(eng.prefill_graphs.counts),
                     dict(eng.guided_graphs.counts)))
             for name, eng in (("off", off), ("lora", lora))}
    if after != built:
        raise SystemExit(f"lora: serving built programs: {after} after "
                         f"warm-up {built}")
    log(f"lora: serving captured nothing more; mixed-batch launches "
        f"{res['launches']}; the mixed batch parts from the solo runs "
        f"{parted or 'nowhere'}")
    if not (res["launches"][k1.__name__] and res["launches"][k3.__name__]):
        raise SystemExit("lora: the mixed batch did not launch K1 and K3")
    burst = _check_lora_burst(lora, device)
    delta_ms = _delta_step_ms(off, lora, device)
    delta = _lora_delta_check(lora, device, LocalLoraSource(root))
    _free_engine(lora)
    del lora
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lora: mixed batch done at {time.perf_counter() - t_phase:.1f} s "
        f"of the phase")

    # eviction: two slots, ad1 and ad2 loaded, then ad3
    evict = TorchEngine(dataclasses.replace(lora_cfg, lora_max_adapters=2,
                                            num_blocks=64),
                        params=params, device=device)
    evict.warmup_decode()
    ebuilt = (dict(evict.graphs.counts), dict(evict.prefill_graphs.counts))

    async def serve_evict():
        out = []
        try:
            for name in ("ad1", "ad2", "ad3"):
                out.append((await _serve(evict, _lora_requests(
                    mc.vocab_size, [name])))[0])
                out.append(dict(evict._lora_slots))
        finally:
            await evict.close()
        return out

    ev = asyncio.run(serve_evict())
    slots = ev[5]
    log(f"lora eviction (lora_max_adapters 2): slots after ad1, ad2, ad3: "
        f"{ev[1]}, {ev[3]}, {slots}")
    if slots != {"ad2": 2, "ad3": 1}:
        raise SystemExit(f"lora eviction: ad3 did not take ad1's slot: "
                         f"{slots}")
    if (dict(evict.graphs.counts), dict(evict.prefill_graphs.counts)) \
            != ebuilt:
        raise SystemExit("lora eviction: serving built programs")
    eparted = _check_streams(
        "lora eviction ad3 vs the 4-slot engine", [ev[4]], [res["ad3"]],
        _lora_requests(mc.vocab_size, ["ad3"]), params, mc, device,
        (evict.lora_bank, evict._lora_slots))
    _free_engine(evict)
    del evict
    gc.collect()
    torch.cuda.empty_cache()

    # guided decoding on the bank-less engine (served in serve_lora)
    solo, both, wall = res["solo"], res["both"], res["guided_wall"]
    glaunches, gm = res["guided_launches"], res["guided_metrics"]
    codec = MockTokenizer(mc.vocab_size)
    texts = [codec.decode(r[0]) for r in both[:3]]
    for text in texts:
        if not JsonSchemaGuide(GUIDED_SCHEMA).done(text.strip()):
            raise SystemExit(f"guided: not a schema-valid document: {text!r}")
        json.loads(text)
    if both[1][0] != both[2][0]:
        raise SystemExit("guided: two runs with one seed differ")
    gparted = _check_streams("guided neighbours", both[3:], solo, unguided,
                             params, mc, device)
    if dict(g.counts) != {32: 1, 256: 1}:
        raise SystemExit(f"guided: serving built top-M programs: {g.counts}")
    torch.cuda.synchronize()
    dev = {}
    for m, s, e in events:
        dev.setdefault(m, []).append(s.elapsed_time(e))
    guided_tokens = sum(len(r[0]) for r in both[:3])
    span = max(r[3] for r in both[:3]) - min(r[2] for r in both[:3])
    report = {
        "outputs": texts, "guided_tokens": guided_tokens,
        "guided_tok_s": guided_tokens / span if span > 0 else None,
        "program_device_ms": {m: (float(np.median(v)), len(v))
                              for m, v in dev.items()},
        "step_host_ms": (float(np.median(host_s)) * 1e3 if host_s
                         else None, len(host_s)),
        **{k: v for k, v in gm.items() if k.startswith("guided")},
        "launches": glaunches, "wall_s": wall,
    }
    log(f"guided ({card}): {report}; the unguided neighbours part from "
        f"their solo run {gparted or 'nowhere'}")
    if not glaunches[k1.__name__] or not dev.get(32):
        raise SystemExit("guided: the guided run launched no top-M program")
    topm = _check_topm_replay(off)
    _free_engine(off)
    del off
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lora and guided phase done in {time.perf_counter() - t_phase:.1f} s")
    return {"lora_launches": res["launches"], "guided_launches": glaunches,
            "turns": res["turns"], "ops_per_token": ops,
            "dispatched_ops": dispatched, "burst": burst,
            "delta_step": delta_ms, "delta": delta, "guided": report,
            "topm": topm, "parted": parted + eparted + gparted}


# ---------------------------------------------------------------------------
# a loaded checkpoint: the port's own safetensors loader and weight cache
# ---------------------------------------------------------------------------

# depth of the synthesized checkpoint (llama-8b width): 4 of 32 layers,
# about 3.9 GB of bf16 on disk
CKPT_LAYERS = 4
CHAT_TEMPLATE = ("{% for m in messages %}<|{{ m.role }}|>{{ m.content }}"
                 "{% endfor %}<|assistant|>")


def _hf_tensors(cfg, n_layers: int) -> list:
    """(HF name, shape [out, in] as nn.Linear stores it, init scale or
    None for a norm) of a Llama checkpoint of `cfg`'s width, in the
    order the shards hold them."""
    d, q, kv, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.ffn_dim
    out = [("model.embed_tokens.weight", (cfg.vocab_size, d), 0.02)]
    for i in range(n_layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (d,), None),
                (p + "self_attn.q_proj.weight", (q, d), d ** -0.5),
                (p + "self_attn.k_proj.weight", (kv, d), d ** -0.5),
                (p + "self_attn.v_proj.weight", (kv, d), d ** -0.5),
                (p + "self_attn.o_proj.weight", (d, q), q ** -0.5),
                (p + "post_attention_layernorm.weight", (d,), None),
                (p + "mlp.gate_proj.weight", (f, d), d ** -0.5),
                (p + "mlp.up_proj.weight", (f, d), d ** -0.5),
                (p + "mlp.down_proj.weight", (d, f), f ** -0.5)]
    return out + [("model.norm.weight", (d,), None),
                  ("lm_head.weight", (cfg.vocab_size, d), d ** -0.5)]


def _evict(path: str) -> None:
    """Write the file back and drop it from the page cache, so the next
    read comes from the disk (a no-op on tmpfs, which has no disk)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def _fs_type(path: str) -> str:
    """The file system type /proc/mounts gives the longest mount point
    holding `path`."""
    best, kind = "", "unknown"
    real = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 2 and (real == parts[1] or real.startswith(
                    parts[1].rstrip("/") + "/")) and len(parts[1]) > len(best):
                best, kind = parts[1], parts[2]
    return kind


def write_checkpoint(path: str, cfg, n_layers: int, device,
                     seed: int = 0) -> dict:
    """A HF-format Llama checkpoint of `cfg`'s width and `n_layers`
    layers in `path`, written with the standard library alone: two
    safetensors shards (8-byte little-endian header length, the JSON
    header padded to 8 bytes, the raw bf16 bytes), their index,
    config.json (untied lm_head), a minimal tokenizer.json and a
    tokenizer_config.json with a chat template.  Weights are random from
    `seed`, made on the card (norms 1 + 0.1 N(0, 1)); returns them by HF
    name, on the card, for the bit-equality check."""
    gen = torch.Generator(device=device).manual_seed(seed)
    names = _hf_tensors(cfg, n_layers)
    half = 1 + 9 * (n_layers // 2)
    shards = [names[:half], names[half:]]
    ref, weight_map = {}, {}
    for s, part in enumerate(shards):
        fname = f"model-{s + 1:05d}-of-{len(shards):05d}.safetensors"
        header, off = {}, 0
        for name, shape, _ in part:
            n = int(np.prod(shape)) * 2
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + n]}
            off += n
            weight_map[name] = fname
        hb = json.dumps(header).encode()
        hb += b" " * ((-(8 + len(hb))) % 8)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(struct.pack("<Q", len(hb)))
            f.write(hb)
            for name, shape, scale in part:
                x = torch.randn(shape, generator=gen, device=device)
                t = (1 + 0.1 * x if scale is None else x * scale).to(
                    torch.bfloat16)
                ref[name] = t
                f.write(t.view(torch.int16).cpu().numpy().data)
    files = {
        "model.safetensors.index.json": {
            "metadata": {"total_size": sum(
                t.numel() * 2 for t in ref.values())},
            "weight_map": weight_map},
        "config.json": {
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "hidden_size": cfg.d_model, "intermediate_size": cfg.ffn_dim,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "num_hidden_layers": n_layers, "vocab_size": cfg.vocab_size,
            "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
            "max_position_embeddings": cfg.max_context,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16",
            "bos_token_id": 128000, "eos_token_id": [128001, 128009]},
        "tokenizer.json": {
            "version": "1.0", "added_tokens": [], "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "decoder": {"type": "ByteLevel"},
            "model": {"type": "BPE", "vocab": {"a": 0, "b": 1},
                      "merges": []}},
        "tokenizer_config.json": {"chat_template": CHAT_TEMPLATE},
    }
    for fname, body in files.items():
        with open(os.path.join(path, fname), "w") as f:
            json.dump(body, f)
    return ref


def _port_tree(ref: dict, n_layers: int) -> dict:
    """The port's parameter tree of the HF tensors `ref`, built here by
    hand (linear weights transposed to [in, out], norms fp32): the
    loader's expected output."""
    def norm(name):
        return {"norm": ref[name].float()}

    layers = []
    for i in range(n_layers):
        p = f"model.layers.{i}."
        layer = {"attn_norm": norm(p + "input_layernorm.weight"),
                 "mlp_norm": norm(p + "post_attention_layernorm.weight")}
        for key, hf in (("wq", "self_attn.q_proj"),
                        ("wk", "self_attn.k_proj"),
                        ("wv", "self_attn.v_proj"),
                        ("wo", "self_attn.o_proj"),
                        ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                        ("w_down", "mlp.down_proj")):
            layer[key] = ref[p + hf + ".weight"].T.contiguous()
        layers.append(layer)
    return {"embedding": ref["model.embed_tokens.weight"],
            "final_norm": norm("model.norm.weight"),
            "lm_head": ref["lm_head.weight"].T.contiguous(),
            "layers": layers}


def check_checkpoint(device, card: str) -> dict:
    """A synthesized HF Llama checkpoint at llama-8b width, depth cut to
    CKPT_LAYERS, served through the port's own loader: written to a
    temporary directory (its weight cache beside it, DYN_WEIGHT_CACHE_DIR),
    loaded by TorchEngine(EngineConfig(model_path=...)) on the card, every
    parameter held bit for bit to the tensors written, the load timed
    from disk (page cache dropped first) and from the weight cache in
    turns (disk, cache, cache, disk), the five requests served by that
    engine and by an engine given the written tensors as `params` (greedy
    streams equal), and one request through a TorchEngineWorker on the
    checkpoint whose MDC must carry the inline tokenizer and the chat
    template.  Returns the loaded engine's run's launch counts by kernel
    name."""
    import tempfile

    from dynamo_tpu_torch.models import weight_cache
    from dynamo_tpu_torch.models.llama import PRESETS

    used = _kernels_of("bf16")
    width = PRESETS["llama-8b"]
    with tempfile.TemporaryDirectory(prefix="ckpt-") as tmp:
        path = os.path.join(tmp, f"llama-8b-width-{CKPT_LAYERS}-layers")
        os.makedirs(path)
        cache_dir = os.path.join(tmp, "weight-cache")
        env = os.environ.get("DYN_WEIGHT_CACHE_DIR")
        os.environ["DYN_WEIGHT_CACHE_DIR"] = cache_dir
        try:
            t0 = time.perf_counter()
            ref = write_checkpoint(path, width, CKPT_LAYERS, device)
            files = sorted(os.listdir(path))
            for f in files:
                _evict(os.path.join(path, f))
            nbytes = sum(t.numel() * 2 for t in ref.values())
            log(f"checkpoint: llama-8b width (d {width.d_model}, heads "
                f"{width.n_heads}/{width.n_kv_heads}, hd {width.head_dim}, "
                f"ffn {width.ffn_dim}, vocab {width.vocab_size}, untied "
                f"lm_head), depth cut to {CKPT_LAYERS} of "
                f"{width.n_layers} layers: {len(ref)} bf16 tensors, "
                f"{nbytes / 1e9:.3f} GB in 2 shards, written and synced in "
                f"{time.perf_counter() - t0:.1f} s to {_fs_type(path)} "
                f"(the weight cache beside it); files {files}")
            results = _serve_checkpoint(device, card, path, ref, nbytes,
                                        cache_dir, used, width)
        finally:
            if env is None:
                os.environ.pop("DYN_WEIGHT_CACHE_DIR", None)
            else:
                os.environ["DYN_WEIGHT_CACHE_DIR"] = env
            weight_cache.clear_cache(cache_dir)
    return results


def _serve_checkpoint(device, card, path, ref, nbytes, cache_dir, used,
                      width):
    """check_checkpoint's engine, load, serving and worker checks on the
    checkpoint at `path` (written tensors `ref`, `nbytes` of them, the
    model config `width` at CKPT_LAYERS layers)."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.models import loader, weight_cache

    cfg = dataclasses.replace(_engine_config("bf16"), model_path=path)
    mc = cfg.resolve_model()
    if dataclasses.replace(mc, name=width.name) != dataclasses.replace(
            width, n_layers=CKPT_LAYERS, eos_token_ids=(128001, 128009)):
        raise SystemExit(f"checkpoint config read as {mc}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, device=device)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if weight_cache.read_cache(cache_dir, path, "cpu") is None:
        raise SystemExit("the engine's load wrote no weight cache entry")
    log(f"checkpoint: TorchEngine(EngineConfig(model_path=...)) loaded "
        f"it from disk onto {device} and wrote the weight cache in "
        f"{first:.2f} s")
    want = _port_tree(ref, CKPT_LAYERS)
    del ref
    got = dict(weight_cache._flatten_with_paths(engine.params))
    leaves = list(weight_cache._flatten_with_paths(want))
    bad = [name for name, t in leaves
           if name not in got or got[name].dtype != t.dtype
           or not got[name].is_contiguous() or not torch.equal(got[name], t)]
    if bad or len(got) != len(leaves):
        raise SystemExit(f"checkpoint: loaded parameters differ from the "
                         f"tensors written: {bad[:5]}")
    log(f"checkpoint: all {len(got)} parameters bit-equal to the tensors "
        "written (linear weights transposed, norms fp32)")
    loads = []
    for turn in ("disk", "cache", "cache", "disk"):
        torch.cuda.empty_cache()
        if turn == "disk":
            for f in os.listdir(path):
                _evict(os.path.join(path, f))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = (loader.load_params(path, mc, device=device, host_cache=False)
             if turn == "disk" else
             weight_cache.read_cache(cache_dir, path, device))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if p is None or not torch.equal(p["lm_head"],
                                        engine.params["lm_head"]):
            raise SystemExit(f"checkpoint: the {turn} load failed")
        del p
        loads.append({"from": turn, "s": round(secs, 4),
                      "GB_per_s": round(nbytes / 1e9 / secs, 3)})
        log(f"checkpoint load {len(loads)} ({card}): from {turn}, "
            f"{nbytes / 1e9:.3f} GB in {secs:.3f} s = "
            f"{nbytes / 1e9 / secs:.2f} GB/s")
    torch.cuda.empty_cache()
    reqs = _requests(mc.vocab_size)
    direct = TorchEngine(cfg, params=want, device=device)
    engine.warmup_decode()
    direct.warmup_decode()

    async def run():
        try:
            for fn in used:
                fn.launches = 0
            res = await _serve(engine, reqs)
            counts = {fn.__name__: fn.launches for fn in used}
            steps = {k: engine.metrics[k] for k in ("decode_steps",
                                                   "prefill_steps")}
            return res, counts, steps, await _serve(direct, reqs)
        finally:
            await engine.close()
            await direct.close()

    res, counts, steps, ref_res = asyncio.run(run())
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    bad = [i for i, r in enumerate(res) if r[1] != "length"
           or len(r[0]) != 32]
    if bad:
        raise SystemExit(f"checkpoint: requests {bad} did not finish")
    if any(res[i][0] != ref_res[i][0] for i in greedy):
        raise SystemExit("checkpoint: the loaded engine's greedy streams "
                         "differ from the engine given the tensors")
    n, secs = _decode_rate(res)
    log(f"checkpoint: the loaded engine served the five requests (ttft s "
        f"{[round(r[2], 4) for r in res]}, {n / secs:.1f} decode tokens/s, "
        f"{CKPT_LAYERS} layers, {card}); greedy streams {greedy} equal to "
        f"an engine given the written tensors as params; sampled stream "
        f"equal: {res[2][0] == ref_res[2][0]}")
    _check_worker_launches(counts, steps, CKPT_LAYERS,
                           "loaded checkpoint's engine")
    engine.kv = engine.graphs = direct.kv = direct.graphs = None
    engine.prefill_graphs = direct.prefill_graphs = None
    engine.guided_graphs = direct.guided_graphs = None
    del engine, direct, want
    torch.cuda.empty_cache()
    _checkpoint_worker(device, cfg, path, reqs[1])
    return {"launches": counts, "loads": loads, "first_load_s": first}


def _checkpoint_worker(device, cfg, path, req) -> None:
    """One request through a TorchEngineWorker serving the checkpoint
    (model_path; its weights from the weight cache): exits unless it
    finishes and the MDC in discovery carries tokenizer.json inline as
    the "hf" tokenizer with the first eos id, and the chat template."""
    async def run():
        async with _serving_worker(device, cfg, None) as (
                rt, worker, client, _):
            mdc = await rt.discovery.get_prefix(
                worker.card.key(worker.served.instance_id))
            res = await _serve_worker(client, [req])
            return list(mdc.values()), res[0]

    mdc, (toks, finish, ttft, _) = asyncio.run(run())
    with open(os.path.join(path, "tokenizer.json")) as f:
        tok_json = f.read()
    card = mdc[0] if len(mdc) == 1 else {}
    ok = (card.get("tokenizer") == {"type": "hf", "json": tok_json,
                                    "eos_id": 128001}
          and card.get("chat_template") == CHAT_TEMPLATE
          and card.get("name") == os.path.basename(path))
    log(f"checkpoint worker: one request, {len(toks)} out, finish={finish}, "
        f"ttft={ttft:.3f} s; MDC name {card.get('name')!r}, tokenizer "
        f"{(card.get('tokenizer') or {}).get('type')!r} inline "
        f"({len(tok_json)} bytes), chat template carried: "
        f"{card.get('chat_template') == CHAT_TEMPLATE}")
    if finish != "length" or len(toks) != 32 or not ok:
        raise SystemExit("checkpoint worker: request or MDC check failed")


# ---------------------------------------------------------------------------
# --worker-ab: does the request plane show in host-bound decode?
# ---------------------------------------------------------------------------


def codec_cost(packb, unpackb, reps: int = 20000) -> dict:
    """Microseconds per call of `packb` and `unpackb` (the port's codec, or
    any with msgpack's interface) on the request plane's frames: the data
    frame of one token (one per stream per decode step, packed by the
    server and unpacked by the client) and the request frame of the
    1800-token prompt (one per request)."""
    from dynamo_tpu_torch.protocols import LLMEngineOutput

    frames = {
        "token": {"t": "data", "id": "0123456789abcdef",
                  "data": LLMEngineOutput(token_ids=[91234]).to_dict()},
        "request": {"t": "req", "id": "0123456789abcdef",
                    "path": "dynamo/backend/generate", "iid": 2**62 + 1,
                    "payload": _requests(128256)[0].to_dict(), "ctx": {}},
    }
    out = {}
    for name, frame in frames.items():
        n = reps if name == "token" else max(reps // 200, 10)
        body = packb(frame)
        t0 = time.perf_counter()
        for _ in range(n):
            packb(frame)
        t1 = time.perf_counter()
        for _ in range(n):
            unpackb(body)
        t2 = time.perf_counter()
        out[name] = {"bytes": len(body), "pack_us": (t1 - t0) / n * 1e6,
                     "unpack_us": (t2 - t1) / n * 1e6}
    return out


def _ab_record(path: str, res, records, w0: float) -> dict:
    """One turn of worker_ab: TTFT per request, aggregate decode tokens/s,
    the median decode step by lanes and the prefill dispatches (ms after
    the turn's start, rows, tokens) of the FPM `records` in the turn."""
    n, secs = _decode_rate(res)
    return {
        "path": path,
        "ttft_s": [round(r[2], 4) for r in res],
        "decode_tok_s": round(n / secs, 2),
        "step_ms": {k: [round(ms, 2), c]
                    for k, (ms, c) in _step_medians(records).items()},
        "prefills": _prefill_dispatches(records, w0),
    }


def worker_ab(device, card: str, rounds: int = 3) -> dict:
    """The five requests at llama-8b width on a bf16 cache, served in one
    process directly by a TorchEngine and through a TorchEngineWorker
    (_serving_worker: its own cache, the same weights) in turns (direct,
    worker, worker, direct) `rounds` times, after one warm-up run of
    each; every turn starts from a cleared prefix cache after 1.1 s
    idle.  Returns the
    turns (_ab_record), each path's median over its turns, and the
    port's codec_cost on this host."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.runtime.codec import packb, unpackb

    cfg = _engine_config("bf16")
    reqs = _requests(cfg.resolve_model().vocab_size)

    async def run():
        engine = TorchEngine(cfg, device=device)
        turns = []
        try:
            async with _serving_worker(device, cfg, engine.params) as (
                    _, worker, client, seen):
                paths = {"direct": (engine, lambda: _serve(engine, reqs)),
                         "worker": (worker.engine,
                                    lambda: _serve_worker(client, reqs))}
                for eng, serve in paths.values():  # warm-up
                    await serve()
                    await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
                order = ["direct", "worker", "worker", "direct"] * rounds
                for path in order:
                    eng, serve = paths[path]
                    w0 = time.monotonic()
                    res = await serve()
                    w1 = time.monotonic()
                    await eng.clear_kv_blocks()
                    # idle past the FPM's 1 s gap limit, so that no step
                    # gap spans two turns; the worker's load loop
                    # publishes its records meanwhile
                    await asyncio.sleep(1.1)
                    recs = [r for r in engine.fpm if w0 <= r["t"] <= w1] \
                        if path == "direct" else \
                        [r for m in seen["fpm"] for r in m["steps"]
                         if w0 <= r["t"] <= w1]
                    bad = [i for i, r in enumerate(res)
                           if r[1] != "length" or len(r[0]) != 32]
                    if bad:
                        raise SystemExit(f"{path} requests {bad} did not "
                                         "finish with 32 tokens")
                    turns.append(_ab_record(path, res, recs, w0))
                    log(f"worker A/B turn {len(turns)}: {turns[-1]}")
        finally:
            await engine.close()
        return turns

    turns = asyncio.run(run())
    summary = {}
    for path in ("direct", "worker"):
        mine = [t for t in turns if t["path"] == path]
        med = {"decode_tok_s": float(np.median([t["decode_tok_s"]
                                                for t in mine]))}
        for lanes in ("1", "4"):
            vals = [t["step_ms"][int(lanes)][0] for t in mine
                    if int(lanes) in t["step_ms"]]
            med[f"step_ms_{lanes}_lanes"] = (float(np.median(vals))
                                            if vals else None)
        med["ttft_s"] = [float(np.median([t["ttft_s"][i] for t in mine]))
                         for i in range(len(reqs))]
        summary[path] = med
        log(f"worker A/B, {path}, median of {len(mine)} turns ({card}): "
            f"{med}")
    # the host drifts over a run, so each round (direct, worker, worker,
    # direct) is also compared within itself: the worker turns' mean
    # step over the direct turns' mean step
    ratios = {}
    for lanes in (1, 4):
        ratios[f"{lanes}_lanes"] = [
            round(float(np.mean([t["step_ms"][lanes][0] for t in rnd[1:3]])
                        / np.mean([t["step_ms"][lanes][0]
                                   for t in (rnd[0], rnd[3])])), 4)
            for rnd in (turns[i:i + 4] for i in range(0, len(turns), 4))]
    summary["worker_over_direct_by_round"] = ratios
    log(f"worker A/B, worker step over direct step within each round: "
        f"{ratios}")
    codec = codec_cost(packb, unpackb)
    tok = codec["token"]
    per_step = 4 * (tok["pack_us"] + tok["unpack_us"])
    step = summary["worker"]["step_ms_4_lanes"]
    log(f"the port's codec on this host: {codec}; at 4 lanes a decode step "
        f"packs and unpacks 4 token frames, {per_step:.1f} us"
        + (f" = {100 * per_step / (step * 1e3):.3f}% of the worker's "
           f"median step" if step else ""))
    return {"turns": turns, "median": summary, "codec_us": codec}


def _device_breakdown(prof, wall: float,
                      what: str = "profiled run") -> Optional[dict]:
    """Where a profiled run's device time goes: kernel time by family and
    the device's busy share of the run's wall time (one stream, so kernel
    times do not overlap; the profiler's own host overhead lengthens the
    wall, so the busy share is a lower bound).  Returns {"busy_share",
    "device_ops"}, or None when the profiler saw no kernels."""
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    if not kernels:
        log("device breakdown: not measured (the profiler saw no kernels)")
        return None
    fams = {"K1 paged_decode": ("paged_decode",),
            "K3 packed_prefill": ("packed_prefill",),
            "matmul": ("gemm", "cutlass", "xmma", "nvjet", "sm90"),
            "index/scatter": ("index", "scatter", "gather")}
    by = {k: 0.0 for k in (*fams, "other")}
    names = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        names[e.name] = names.get(e.name, 0.0) + us
        fam = next((f for f, keys in fams.items()
                    if any(k in e.name.lower() for k in keys)), "other")
        by[fam] += us
    busy = sum(by.values()) / 1e6
    log(f"device breakdown, {what}: wall {wall:.3f} s, kernels "
        f"{busy:.3f} s busy ({100 * busy / wall:.1f}%), "
        f"{len(kernels)} kernel launches; by family (ms): "
        + ", ".join(f"{k} {v / 1e3:.1f}" for k, v in by.items()))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    log("top kernels (ms): " + "; ".join(
        f"{n[:60]} {us / 1e3:.1f}" for n, us in top))
    return {"busy_share": busy / wall, "device_ops": len(kernels)}


# ---------------------------------------------------------------------------
# the MoE family at mixtral-8x7b width (--moe; last in the whole run)
# ---------------------------------------------------------------------------

# mixtral-8x7b's 32 layers hold 93.4 GB of bf16 weights, more than the
# card's 80 GB; 16 layers hold 46.97 GB with the embedding and lm_head
MOE_LAYERS = 16
# the one-layer check: its tokens, and the largest relative L2 error of
# a row against the fp32 forward (bf16 operands and products, fp32
# accumulation, as the adapters' check of the LoRA phase)
MOE_LAYER_T = 2048
MOE_LAYER_TOL = 2e-2
# the profiled device split: the families, in print order
MOE_FAMILIES = ("expert GEMMs", "MoE dispatch/combine", "MoE router+glue",
                "K1", "K3", "dense matmuls", "other")


def _moe_model(**kw):
    """mixtral-8x7b at full width, MOE_LAYERS deep."""
    from dynamo_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(PRESETS["mixtral-8x7b"], n_layers=MOE_LAYERS,
                               **kw)


def _moe_engine_config(mc, **kw):
    """The MoE and MLA runs' engine config: the llama-8b runs' scheduler
    (four slots, a 2048-token prefill budget, 16-wide tables) with model
    config `mc` and 512 blocks of bf16 cache."""
    from dynamo_tpu_torch.engine import EngineConfig

    return EngineConfig(model_config=mc, block_size=128,
                        max_blocks_per_seq=16, max_num_seqs=4,
                        max_batch_tokens=2048, max_prefill_seqs=4,
                        num_blocks=512, seed=0, **kw)


def _moe_serve(eng, reqs, used) -> tuple:
    """The requests through `eng` at once, launch counts set to 0 just
    before and read just after: (results, counts by kernel name, the
    engine's metrics).  Closes the engine."""
    async def run():
        try:
            for fn in used:
                fn.launches = 0
            res = await _serve(eng, reqs)
            counts = {fn.__name__: fn.launches for fn in used}
            return res, counts, dict(eng.metrics)
        finally:
            await eng.close()

    return asyncio.run(run())


def _profile_split(run, ranges: dict, classify, families: tuple,
                   what: str) -> Optional[dict]:
    """Device time by family (`families`, ms) of `run()` under
    torch.profiler, each kernel charged to the operator that launched
    it.  For the run every function `ranges` names ((module, attribute)
    -> label) runs inside a record_function range of that label, and
    `classify(op, chain)` names the family of a kernel launched by
    operator `op` under `chain` (the operator and its ancestry, ranges
    included, innermost first), or, with op None and chain [symbol], of
    a device kernel no operator launched (None: other).  Every kernel
    left uncharged is "other".  Logs `what` and returns the split, or
    None when the profiler saw no kernel."""
    orig = {key: getattr(*key) for key in ranges}

    def ranged(fn, label):
        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return wrapped

    for (mod, attr), label in ranges.items():
        setattr(mod, attr, ranged(orig[(mod, attr)], label))
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (mod, attr), fn in orig.items():
            setattr(mod, attr, fn)
    labels = set(ranges.values())
    by = dict.fromkeys(families, 0.0)
    device = 0.0
    for e in prof.events():
        # a range's own device-side annotation spans its kernels
        if str(e.device_type).endswith("CUDA") and e.name not in labels:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            device += ms
            fam = classify(None, [e.name])
            if fam is not None:
                by[fam] += ms
    for e in prof.events():
        if not getattr(e, "kernels", None):
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for kern in e.kernels:
            by[classify(e.name, chain)] += kern.duration / 1e3
    # the kernels no operator launched (beyond those named by symbol)
    by["other"] += max(device - sum(by.values()), 0.0)
    total = sum(by.values())
    if not device:
        log(f"{what}: not measured (the profiler saw no kernels)")
        return None
    log(f"{what}: wall {1e3 * wall:.1f} ms, kernels {total:.1f} ms; by "
        "family (ms, share): " + ", ".join(
            f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in by.items()))
    return by


def _moe_family(op, chain) -> Optional[str]:
    """_profile_split's classifier of the MoE model: under `_ffn`'s
    range a batched product is an expert GEMM, or a dispatch/combine
    product inside an einsum, and everything else there (the router's
    product, the sort, softmax, scatter, one-hot, cumsum) the router and
    its glue; outside it the dense products (attention projections, the
    lm_head) and other.  K1 and K3, launched through ctypes under no
    operator, count by their symbols."""
    if op is None:
        return ("K1" if "paged_decode" in chain[0]
                else "K3" if "packed_prefill" in chain[0] else None)
    if "moe_ffn" in chain:
        return ("MoE router+glue" if op != "aten::bmm"
                else "MoE dispatch/combine" if "aten::einsum" in chain
                else "expert GEMMs")
    if op in ("aten::mm", "aten::addmm", "aten::bmm"):
        return "dense matmuls"
    return "other"


def _moe_split(run, what: str) -> Optional[dict]:
    """Device time by family (MOE_FAMILIES, ms) of `run()`
    (_profile_split with `_ffn` in a range, `_moe_family`)."""
    from dynamo_tpu_torch.models import llama

    return _profile_split(run, {(llama, "_ffn"): "moe_ffn"}, _moe_family,
                          MOE_FAMILIES, f"MoE device split, {what}")


@contextlib.contextmanager
def _routes(record: Optional[list] = None, replay: Optional[list] = None):
    """Within the block every `_moe_router` call appends its expert ids
    [T, k] to `record`, or, with `replay` (a `record` of the same calls),
    selects the recorded experts instead of its own top k, weighted by
    the softmax of its own router logits at them."""
    from dynamo_tpu_torch.models import llama

    orig = llama._moe_router
    calls = iter(replay) if replay is not None else None

    def spy(layer, cfg, x):
        if calls is not None:
            ids = next(calls)
            router = x.float() @ layer["moe_gate"].float()
            return torch.softmax(torch.gather(router, 1, ids), dim=-1), ids
        w, e = orig(layer, cfg, x)
        if record is not None:
            record.append(e)
        return w, e

    llama._moe_router = spy
    try:
        yield
    finally:
        llama._moe_router = orig


def _moe_compare_logits(params, mc, device) -> dict:
    """K1 and K3 inside the MoE model against their plain versions, with
    the routing held fixed: a 512-token prompt's last-token logits
    (prefill_packed, K3) and the next decode step's (K1) through the
    kernel path, then through the plain path with the kernel path's
    expert choices replayed (_routes), so a router near-tie that rounding
    tips either way does not hide or fake a difference.  Exits unless
    each pair's cosine is at least MIN_COSINE and their top tokens agree
    or the plain top-2 gap is within the largest logit difference."""
    from dynamo_tpu_torch.models import llama

    plain = dataclasses.replace(mc, attn_impl="torch",
                                packed_attn_impl="torch")
    rng = np.random.default_rng(7)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    toks = i32(rng.integers(0, mc.vocab_size, 512).tolist())
    pos = torch.arange(512, dtype=torch.int32, device=device)
    seg = torch.zeros(512, dtype=torch.int32, device=device)
    valid = torch.ones(512, dtype=torch.bool, device=device)
    tables, last = i32([[1, 2, 3, 4, 5]]), i32([511])
    lane = torch.tensor([True], device=device)
    rec, out = [], {}
    for name, c in (("kernel", mc), ("plain", plain)):
        kv = tuple(torch.zeros(sh, dtype=mc.dtype, device=device)
                   for sh in llama.kv_cache_shapes(mc, 8, 128))
        with _routes(record=rec if name == "kernel" else None,
                     replay=rec if name == "plain" else None):
            pre, _ = llama.prefill_packed(params, c, kv, toks, pos, seg,
                                          tables, last, valid)
            dec, _ = llama.decode(params, c, kv, i32([7]), i32([512]),
                                  tables, i32([512]), valid=lane)
        out[name] = (pre[0].float(), dec[0].float())
    res = {}
    for i, what in enumerate(("prefill", "decode")):
        a, b = out["kernel"][i], out["plain"][i]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        diff = (a - b).abs().max().item()
        top2 = torch.topk(b, 2).values
        gap = (top2[0] - top2[1]).item()
        same = int(a.argmax()) == int(b.argmax())
        ok = cos >= MIN_COSINE and (same or gap <= diff)
        log(f"MoE logits {what}, kernel path vs plain path, routing held "
            f"(512-token prompt): cosine={cos:.6f} (>= {MIN_COSINE}) top1 "
            f"equal={same} max_abs_diff={diff:.4f} plain top-2 gap="
            f"{gap:.4f} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(f"MoE: kernel path and plain path disagree "
                             f"({what})")
        res[what] = {"cosine": cos, "max_abs_diff": diff}
    return res


def _moe_replay(params, cfg, device, prompt, stream, j: int,
                record: Optional[list] = None,
                replay: Optional[list] = None) -> torch.Tensor:
    """Token j's fp32 logits of `stream` through `cfg` on a scratch
    cache, teacher-forced as _replay_gap: the prompt prefilled packed,
    then decode steps at B = 4 (lane 0 live) fed stream[:j]; j = 0 is
    the prompt's last position.  `record`/`replay`: _routes's, over
    every router call of the replay."""
    from dynamo_tpu_torch.models import llama

    bs, L = 128, len(prompt)
    nb = -(-(L + j + 1) // bs)
    kv = tuple(torch.zeros(s, dtype=cfg.dtype, device=device)
               for s in llama.kv_cache_shapes(cfg, nb + 1, bs))
    T = -(-L // bs) * bs

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    table = list(range(1, nb + 1))
    tables = i32([table] + [[0] * nb] * 3)
    valid = torch.tensor([True, False, False, False], device=device)
    with _routes(record, replay):
        logits, _ = llama.prefill_packed(
            params, cfg, kv, i32(prompt + [0] * (T - L)),
            i32(list(range(L)) + [0] * (T - L)), i32([0] * T), i32([table]),
            i32([L - 1]), torch.arange(T, device=device) < L)
        logits = logits[0]
        for s in range(j):
            at = [L + s, 0, 0, 0]
            out, _ = llama.decode(params, cfg, kv, i32([stream[s], 0, 0, 0]),
                                  i32(at), tables, i32(at), valid=valid)
            logits = out[0]
    return logits.float()


def _route_flips(a: list, b: list, L: int, n_layers: int) -> int:
    """(token, layer) routings of the live rows (the L prompt tokens in
    the prefill's n_layers calls, then decode lane 0) that chose other
    experts in record `b` than in record `a`."""
    n = 0
    for c, (x, y) in enumerate(zip(a, b)):
        rows = L if c < n_layers else 1
        n += int((x[:rows].sort(dim=1).values
                  != y[:rows].sort(dim=1).values).any(dim=1).sum())
    return n


def _moe_streams(what: str, got, ref, reqs, params, cfg_got, cfg_ref,
                 device) -> list:
    """The partings of the greedy streams of `got` (served with cfg_got)
    from `ref`'s (cfg_ref), each logged with what _near_tie reads,
    teacher-forced at the parting token j (_moe_replay): the reference's
    top-2 logit gap and one bf16 ulp of its top logit; the (token,
    layer) routings of the context that the two paths chose otherwise;
    and, with every routing of the other path held to the reference's
    (_routes), its logits' cosine with the reference's, their largest
    difference and whether the top tokens agree."""
    parted = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if reqs[i].sampling.temperature > 0 or g[0] == r[0]:
            continue
        j = next((n for n, (a, b) in enumerate(zip(g[0], r[0])) if a != b),
                 min(len(g[0]), len(r[0])))
        prompt = list(reqs[i].token_ids)
        rec_ref, rec_got = [], []
        lr = _moe_replay(params, cfg_ref, device, prompt, r[0], j, rec_ref)
        _moe_replay(params, cfg_got, device, prompt, r[0], j, rec_got)
        lh = _moe_replay(params, cfg_got, device, prompt, r[0], j,
                         replay=rec_ref)
        top2 = torch.topk(lr, 2).values
        p = {"request": i, "token": j,
             "gap": (top2[0] - top2[1]).item(),
             "ulp": _ulp_bf16(top2[0].item()),
             "flips": _route_flips(rec_ref, rec_got, len(prompt),
                                   cfg_ref.n_layers),
             "held_cosine": torch.nn.functional.cosine_similarity(
                 lh, lr, dim=0).item(),
             "held_diff": (lh - lr).abs().max().item(),
             "held_same": int(lh.argmax()) == int(lr.argmax())}
        parted.append(p)
        log(f"{what}: request {i}'s greedy stream parts at token {j}: "
            f"reference top-2 gap {p['gap']:.6f}, one bf16 ulp "
            f"{p['ulp']:.6f}; {p['flips']} (token, layer) routings of its "
            f"context chose other experts on the two paths; with the "
            f"routing held to the reference's: cosine "
            f"{p['held_cosine']:.6f}, max difference {p['held_diff']:.6f}, "
            f"top tokens equal {p['held_same']}; near-tie: {_near_tie(p)}")
    return parted


def _near_tie(p: dict) -> bool:
    """Whether a _moe_streams parting is a near-tie: a logit near-tie,
    the reference's top-2 gap within one bf16 ulp of its top logit; or
    a router near-tie, where the two paths' rounding chose other experts
    for some token of the context (a discrete change that moves later
    logits by several ulps) and, with the routing held to the
    reference's, the other path agrees at the parting token (cosine at
    least MIN_COSINE, the same top token or a top-2 gap within their
    largest difference): the parting is the routing's, not the
    attention's or the dispatch's under test."""
    held = p["held_cosine"] >= MIN_COSINE and (p["held_same"]
                                               or p["gap"] <= p["held_diff"])
    return p["gap"] <= p["ulp"] or (p["flips"] > 0 and held)


def _moe_layer_check(params, mc, device) -> dict:
    """One MoE layer (layer 0's weights) on MOE_LAYER_T random bf16 rows,
    in dense dispatch and in capacity dispatch at capacity factor E/k
    (C = T: dropless), against an fp32 forward of the same layer: the
    same routing (`_moe_router`, fp32), then each expert's FFN in fp32
    on the rows routed to it, weighted and summed.  Exits unless every
    row's relative L2 error is within MOE_LAYER_TOL."""
    from dynamo_tpu_torch.models import llama

    layer = params["layers"][0]
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(MOE_LAYER_T, mc.d_model, generator=gen,
                    device=device).to(mc.dtype)
    top_w, top_e = llama._moe_router(layer, mc, x)
    xf = x.float()
    ref = torch.zeros(xf.shape, device=device)
    for e in range(mc.n_experts):
        rows, slot = (top_e == e).nonzero(as_tuple=True)
        h = torch.nn.functional.silu(xf[rows] @ layer["moe_w_gate"][e].float())
        h = h * (xf[rows] @ layer["moe_w_up"][e].float())
        ref.index_add_(0, rows, (h @ layer["moe_w_down"][e].float())
                       * top_w[rows, slot][:, None])
    out = {}
    for dispatch, cf in (("dense", mc.moe_capacity_factor),
                         ("capacity", mc.n_experts / mc.experts_per_token)):
        cfg = dataclasses.replace(mc, moe_dispatch=dispatch,
                                  moe_capacity_factor=cf)
        got = llama._ffn(layer, cfg, x)
        torch.cuda.synchronize()
        out[dispatch] = row_rel_err(got, ref)
        log(f"one MoE layer, T={MOE_LAYER_T}, {dispatch} dispatch (capacity "
            f"factor {cf}): max row relative L2 error against the fp32 "
            f"forward {out[dispatch]:.3e} (limit {MOE_LAYER_TOL})")
        if not out[dispatch] <= MOE_LAYER_TOL:
            raise SystemExit(f"the MoE layer ({dispatch} dispatch) disagrees "
                             "with its fp32 forward")
    return out


def _moe_padded_times(eng, device) -> dict:
    """Host and device ms (CUDA events; 3 calls each) of a padded
    prefill dispatch after serving: B = 1 on a full 2048 bucket and four
    rows of 512, random prompts over blocks 1-16 (a row's own)."""
    c, g = eng.config, eng.padded_prefill
    rng = np.random.default_rng(4)
    out = {}
    for rows, T in ((1, 2048), (4, 512)):
        a = eng._padded_warmup(rows, T)
        a["toks"][:] = rng.integers(0, eng.model_cfg.vocab_size, (rows, T))
        a["true_lens"][:] = T
        nb = T // c.block_size
        for r in range(rows):
            a["tables"][r, :nb] = 1 + r * nb + np.arange(nb)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(3):
            g.run(a)
        host = (time.perf_counter() - t0) / 3
        end.record()
        end.synchronize()
        out[(rows, T)] = (start.elapsed_time(end) / 3, 1e3 * host)
        log(f"capacity dispatch (factor {eng.model_cfg.moe_capacity_factor})"
            f", a padded prefill dispatch of {rows} x {T}: "
            f"{out[(rows, T)][0]:.3f} ms on the device, "
            f"{out[(rows, T)][1]:.3f} ms on the host to dispatch")
    return out


def _moe_capacity(device, card: str, params, reqs, used, mc) -> dict:
    """Capacity dispatch on the same weights: the five requests at
    capacity factor E/k (dropless; check_moe holds its greedy streams to
    the dense engine's) and at the default 1.25, timed.  Both engines
    warm up (decode programs captured, the padded shapes run eagerly),
    build no packed program, never launch K3 and build nothing while
    serving.  Returns {"dropless": the E/k run's results, "launches":
    the 1.25 run's counts, "padded_ms": its dispatch times}."""
    from dynamo_tpu_torch.engine import TorchEngine

    k1, k3 = used
    out = {}
    for cf in (mc.n_experts / mc.experts_per_token, mc.moe_capacity_factor):
        cmc = dataclasses.replace(mc, moe_dispatch="capacity",
                                  moe_capacity_factor=cf)
        eng = TorchEngine(_moe_engine_config(cmc), params=params,
                          device=device)
        t0 = time.perf_counter()
        eng.warmup_decode()
        built = _log_programs(eng, f"capacity engine (factor {cf})")
        padded = dict(eng.padded_prefill.counts)
        log(f"capacity engine (factor {cf}): warm-up in "
            f"{time.perf_counter() - t0:.1f} s, padded prefill shapes "
            f"{sorted(padded)}, packed programs {eng.prefill_graphs.counts}")
        if eng.prefill_graphs.counts or set(padded) != set(
                eng._padded_shapes()):
            raise SystemExit("capacity warm-up built a packed program or "
                             "missed a padded shape")
        res, counts, stats = _moe_serve(eng, reqs, used)
        _moe_check_served(f"capacity (factor {cf})", res, reqs, card,
                          eng.config)
        if eng.graphs.counts != built or eng.padded_prefill.counts != padded:
            raise SystemExit("the capacity engine built programs while "
                             "serving")
        need = mc.n_layers * stats["decode_steps"]
        log(f"capacity (factor {cf}) launches: {k1.__name__} "
            f"{counts[k1.__name__]} (>= {need}), {k3.__name__} "
            f"{counts[k3.__name__]} (0: no packed prefill); "
            f"{stats['prefill_steps']} padded prefill dispatches")
        if counts[k1.__name__] < need or counts[k3.__name__]:
            raise SystemExit("the capacity engine's launches are wrong")
        if cf == mc.n_experts / mc.experts_per_token:
            out["dropless"] = res
        else:
            out["padded_ms"] = _moe_padded_times(eng, device)
            out["launches"] = counts
            _moe_split(lambda: eng.padded_prefill.run(
                eng._padded_warmup(4, 512)), "a padded 4 x 512 dispatch "
                f"(capacity, factor {cf})")
        _free_engine(eng)
        del eng
    return out


def _moe_check_served(what: str, res, reqs, card: str, cfg) -> None:
    """Log TTFT and decode tokens/s of a _serve result; exit unless every
    request finished with 32 tokens."""
    n, secs = _decode_rate(res)
    log(f"serving mixtral-8x7b/{MOE_LAYERS} layers, {what} ({card}): ttft "
        f"s per request {[round(r[2], 4) for r in res]}, decode {n} "
        f"tokens in {secs:.3f} s = {n / secs:.1f} tokens/s aggregate "
        f"(max_num_seqs={cfg.max_num_seqs})")
    bad = [i for i, r in enumerate(res) if r[1] != "length"
           or len(r[0]) != 32]
    if bad:
        raise SystemExit(f"{what}: requests {bad} did not finish with 32 "
                         "tokens")


def check_moe(device, card: str) -> dict:
    """The MoE phase (module docstring).  Returns {"launches": the dense
    engine's main-path counts by kernel name, "seconds": ...}."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.obs.costs import program_costs, weight_bytes

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mc = _moe_model()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(mc, gen, device)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"MoE: mixtral-8x7b at full width (d={mc.d_model}, heads "
        f"{mc.n_heads}/{mc.n_kv_heads}, ffn {mc.ffn_dim}, {mc.n_experts} "
        f"experts, top {mc.experts_per_token}, vocab {mc.vocab_size}), "
        f"{mc.n_layers} of 32 layers: {nbytes / 1e9:.2f} GB of random bf16 "
        f"weights made on the card in {time.perf_counter() - t0:.1f} s")
    used = _kernels_of("bf16")
    reqs = _requests(mc.vocab_size)

    # dense dispatch, the default scheduler on graphs
    eng = TorchEngine(_moe_engine_config(mc), params=params, device=device)
    t0 = time.perf_counter()
    eng.warmup_decode()
    log(f"MoE dense engine: warm-up in {time.perf_counter() - t0:.1f} s; "
        f"prefill graph pool by bucket (MiB): "
        + ", ".join(f"T={T} {b / 2**20:.0f}" for T, b in
                    sorted(eng.prefill_graphs.pool_grown.items()))
        + f"; decode graph pool {eng.graphs.pool_bytes / 2**20:.0f} MiB")
    built = _log_programs(eng, "MoE dense engine")
    pbuilt = _log_prefill_programs(eng, "MoE dense engine")
    res, launches, stats = _moe_serve(eng, reqs, used)
    _moe_check_served("dense dispatch, graphs", res, reqs, card, eng.config)
    if eng.graphs.counts != built or eng.prefill_graphs.counts != pbuilt:
        raise SystemExit("the MoE engine captured programs while serving")
    L = mc.n_layers
    dec, pre = (fn.__name__ for fn in used)
    need_dec, need_pre = L * stats["decode_steps"], L * stats["prefill_steps"]
    log(f"MoE dense engine launches: {dec} {launches[dec]} (>= {need_dec} = "
        f"{L} layers x {stats['decode_steps']} decode steps), {pre} "
        f"{launches[pre]} (>= {need_pre} = {L} x {stats['prefill_steps']} "
        "prefill dispatches); nothing captured while serving")
    if launches[dec] < need_dec or launches[pre] < need_pre or not need_dec:
        raise SystemExit("the MoE engine did not run through both kernels")
    burst = check_graph_burst(eng, device, "mixtral bf16")
    step_bytes = weight_bytes(mc)
    counted = program_costs(mc, "decode", (True, 8), rows=4, max_blocks=16,
                            block_size=128)["bytes"]
    log(f"MoE k=8 burst replay {burst['burst_ms']:.3f} ms ({card}) against "
        f"its byte bound: {step_bytes / 1e9:.2f} GB of weights a step = "
        f"{8e3 * step_bytes / HBM_BYTES_PER_S:.1f} ms a burst at 3.35 TB/s "
        f"({burst['burst_ms'] * HBM_BYTES_PER_S / 8e3 / step_bytes:.2f}x); "
        f"with K1's full tables {counted / 1e9:.1f} GB = "
        f"{1e3 * counted / HBM_BYTES_PER_S:.1f} ms; "
        f"{burst['ops_per_token']:.1f} device operations per decode token "
        f"at {L} layers ({burst['ops_per_token'] / L:.1f} a layer; the dense "
        "llama-8b: 651-653 at 32 layers)")
    replay = check_prefill_replay(eng, device, "mixtral bf16")
    flops = program_costs(mc, "prefill", 2048, rows=4, max_blocks=16,
                          block_size=128)["flops"]
    ms = replay[2048]["replay"][0]
    log(f"MoE T=2048 bucket replay {ms:.3f} ms on the device ({card}) "
        f"against its FLOP bound: {flops / 1e12:.1f} TFLOP (dense dispatch,"
        f" {L} layers) = {1e3 * flops / BF16_FLOPS_PER_S:.1f} ms at 989 "
        f"TFLOP/s ({1e3 * flops / BF16_FLOPS_PER_S / ms:.2f} of it)")
    split = {"decode": _moe_split(lambda: eng.graphs.run_eager(True, 8),
                                  "eager k=8 decode burst body"),
             "prefill": _moe_split(lambda: eng.prefill_graphs.run_eager(2048),
                                   "eager T=2048 prefill bucket body")}
    _free_engine(eng)
    del eng

    layer = _moe_layer_check(params, mc, device)
    cap = _moe_capacity(device, card, params, reqs, used, mc)
    worker = check_worker_short(device, _moe_engine_config(mc), params)

    # the plain attention versions, eagerly, on the same weights
    pmc = dataclasses.replace(mc, attn_impl="torch", packed_attn_impl="torch")
    peng = TorchEngine(_moe_engine_config(pmc), params=params, device=device,
                       cuda_graphs=False)
    plain, plain_counts, _ = _moe_serve(peng, reqs, used)
    _free_engine(peng)
    del peng
    if any(plain_counts.values()):
        raise SystemExit(f"the plain engine launched kernels: {plain_counts}")
    held = _moe_compare_logits(params, mc, device)
    parted = {"plain": _moe_streams("MoE kernels against plain attention",
                                    res, plain, reqs, params, mc, pmc,
                                    device)}
    cmc = dataclasses.replace(mc, moe_dispatch="capacity",
                              moe_capacity_factor=mc.n_experts
                              / mc.experts_per_token)
    parted["capacity"] = _moe_streams(
        "MoE capacity dispatch (dropless) against dense", cap["dropless"],
        res, reqs, params, cmc, mc, device)
    bad = {k: [p for p in v if not _near_tie(p)] for k, v in parted.items()}
    if any(bad.values()):
        raise SystemExit(f"MoE streams part at neither a logit near-tie nor "
                         f"a router near-tie: {bad}")
    log("MoE: greedy streams of the kernel engine equal the plain-attention "
        "engine's (K1 and K3 held to their plain versions inside the "
        "model), and those of dropless capacity dispatch the dense "
        "engine's, but at near-ties")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"MoE phase: {secs:.1f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card})")
    return {"launches": launches, "worker_launches": worker,
            "capacity_launches": cap["launches"], "layer_err": layer,
            "burst": burst, "split": split, "parted": parted,
            "held": held,
            "seconds": secs}


# ---------------------------------------------------------------------------
# the DeepSeek MLA family at deepseek-v2-lite width and depth (--mla)
# ---------------------------------------------------------------------------

# one layer's MLA attention in bf16 against fp32: a T-token chunk after
# MLA_LAYER_CTX cached tokens, and a decode step over all of them; the
# per-row relative L2 limit is the MoE layer check's
MLA_LAYER_T = 2048
MLA_LAYER_CTX = 1024
MLA_LAYER_TOL = 2e-2
# the absorbed decode against a materialised non-absorbed oracle on the
# same fp32 cache (the identity MLA rests on; TF32 is off)
MLA_ABSORB_TOL = 1e-4
# the teacher-forced replays' second path: the prompt in chunks of this
# many tokens (the equal share a four-row prefill of 2048 gives a row)
MLA_CHUNK = 512
# the profiled device split: the families, in print order
MLA_FAMILIES = ("MLA attention", "q/kv projections", "expert GEMMs",
                "shared experts", "router+glue", "dense matmuls", "other")


def _mla_model():
    """deepseek-v2-lite at its published widths and full depth."""
    from dynamo_tpu_torch.models.deepseek import PRESETS

    return PRESETS["deepseek-v2-lite"]


@contextlib.contextmanager
def _ds_routes(record: Optional[list] = None, replay: Optional[list] = None):
    """_routes for the DeepSeek router: within the block every
    `_ds_router` call appends its expert ids [T, k] to `record`, or, with
    `replay` (the ids of the same calls, in order), selects those experts
    instead of its own choice, weighted by its own scores at them
    (renormalized and scaled as the router does)."""
    from dynamo_tpu_torch.models import deepseek

    orig = deepseek._ds_router
    calls = iter(replay) if replay is not None else None

    def spy(layer, cfg, x):
        if calls is not None:
            ids = next(calls)
            logits = x.float() @ layer["moe_gate"].float()
            scores = (torch.sigmoid(logits) if cfg.moe_scoring == "sigmoid"
                      else torch.softmax(logits, dim=-1))
            w = torch.gather(scores, 1, ids)
            if cfg.norm_topk_prob:
                w = w / (w.sum(-1, keepdim=True) + 1e-20)
            return w * cfg.routed_scaling_factor, ids
        w, e = orig(layer, cfg, x)
        if record is not None:
            record.append(e)
        return w, e

    deepseek._ds_router = spy
    try:
        yield
    finally:
        deepseek._ds_router = orig


def _mla_replay(params, cfg, device, prompt, stream, j: int,
                chunk: Optional[int] = None, record: Optional[list] = None,
                replay: Optional[list] = None) -> torch.Tensor:
    """Token j's fp32 logits of `stream` teacher-forced through the
    family's functions on a scratch cache: the prompt through the padded
    `prefill` in chunks of `chunk` tokens (None: one chunk), each padded
    to whole blocks, then decode steps at B = 4 (lane 0 live) fed
    stream[:j]; j = 0 is the prompt's last position.  `record`/`replay`:
    _ds_routes's, over every router call."""
    from dynamo_tpu_torch.models import deepseek

    bs, L = 128, len(prompt)
    nb = -(-(L + j + 1) // bs)
    kv = tuple(torch.zeros(s, dtype=cfg.dtype, device=device)
               for s in deepseek.kv_cache_shapes(cfg, nb + 1, bs))

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    table = list(range(1, nb + 1))
    tables = i32([table] + [[0] * nb] * 3)
    valid = torch.tensor([True, False, False, False], device=device)
    step = chunk or L
    with _ds_routes(record, replay):
        for c0 in range(0, L, step):
            n = min(step, L - c0)
            T = -(-n // bs) * bs
            logits, _ = deepseek.prefill(
                params, cfg, kv, i32(prompt[c0:c0 + n] + [0] * (T - n)),
                i32(list(range(c0, c0 + T))), i32(table), c0, n)
        for s in range(j):
            at = [L + s, 0, 0, 0]
            out, _ = deepseek.decode(params, cfg, kv,
                                     i32([stream[s], 0, 0, 0]), i32(at),
                                     tables, i32(at), valid=valid)
            logits = out[0]
    return logits.float()


def _chunked_routes(whole: list, L: int, n_moe: int, chunk: int,
                    bs: int = 128) -> list:
    """The router calls of a one-chunk replay (`whole`: n_moe prefill
    calls of [T, k], then the decode steps' calls) laid out as a replay
    in chunks of `chunk` tokens calls them: each chunk's n_moe calls
    hold its rows of the whole prompt's ids (padding rows: expert 0,
    which no valid row claims), then the same decode calls."""
    out = []
    for c0 in range(0, L, chunk):
        n = min(chunk, L - c0)
        T = -(-n // bs) * bs
        for m in range(n_moe):
            ids = whole[m][c0:c0 + n]
            pad = ids.new_zeros((T - n, ids.shape[1]))
            out.append(torch.cat([ids, pad]))
    return out + whole[n_moe:]


def _mla_route_flips(whole: list, chunked: list, L: int, n_moe: int,
                     chunk: int) -> int:
    """(token, layer) routings of the live rows (the L prompt tokens in
    each MoE layer, then decode lane 0) that the chunked replay chose
    otherwise than the one-chunk replay."""
    n_chunks = -(-L // chunk)
    n = 0
    for m in range(n_moe):
        a = whole[m][:L]
        b = torch.cat([chunked[c * n_moe + m][:min(chunk, L - c * chunk)]
                       for c in range(n_chunks)])
        n += int((a.sort(dim=1).values != b.sort(dim=1).values)
                 .any(dim=1).sum())
    for x, y in zip(whole[n_moe:], chunked[n_chunks * n_moe:]):
        n += int((x[:1].sort(dim=1).values != y[:1].sort(dim=1).values)
                 .any(dim=1).sum())
    return n


def _mla_streams(what: str, got, ref, reqs, params, cfg, device) -> list:
    """The partings of the greedy streams of `got` from `ref`'s, each
    logged with what _near_tie reads, teacher-forced at the parting
    token j (_mla_replay) through two numerically different paths, the
    prompt in one chunk (the reference) and in MLA_CHUNK-token chunks
    (as the engine's four-row prefill shares it): the reference's top-2
    gap and one bf16 ulp of its top logit; the (token, layer) routings
    the two paths chose otherwise; and, with the chunked path's routing
    held to the reference's (_ds_routes), its logits' cosine with the
    reference's, their largest difference and whether the top tokens
    agree."""
    n_moe = sum(cfg._moe_layer(li) for li in range(cfg.n_layers))
    parted = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if reqs[i].sampling.temperature > 0 or g[0] == r[0]:
            continue
        j = next((n for n, (a, b) in enumerate(zip(g[0], r[0])) if a != b),
                 min(len(g[0]), len(r[0])))
        prompt = list(reqs[i].token_ids)
        L = len(prompt)
        rec_ref, rec_got = [], []
        lr = _mla_replay(params, cfg, device, prompt, r[0], j,
                         record=rec_ref)
        _mla_replay(params, cfg, device, prompt, r[0], j, MLA_CHUNK,
                    record=rec_got)
        lh = _mla_replay(params, cfg, device, prompt, r[0], j, MLA_CHUNK,
                         replay=_chunked_routes(rec_ref, L, n_moe,
                                                MLA_CHUNK))
        top2 = torch.topk(lr, 2).values
        p = {"request": i, "token": j,
             "gap": (top2[0] - top2[1]).item(),
             "ulp": _ulp_bf16(top2[0].item()),
             "flips": _mla_route_flips(rec_ref, rec_got, L, n_moe,
                                       MLA_CHUNK),
             "held_cosine": torch.nn.functional.cosine_similarity(
                 lh, lr, dim=0).item(),
             "held_diff": (lh - lr).abs().max().item(),
             "held_same": int(lh.argmax()) == int(lr.argmax())}
        parted.append(p)
        log(f"{what}: request {i}'s greedy stream parts at token {j}: "
            f"reference top-2 gap {p['gap']:.6f}, one bf16 ulp "
            f"{p['ulp']:.6f}; {p['flips']} (token, layer) routings chose "
            f"other experts with the prompt in {MLA_CHUNK}-token chunks; "
            f"routing held: cosine {p['held_cosine']:.6f}, max difference "
            f"{p['held_diff']:.6f}, top tokens equal {p['held_same']}; "
            f"near-tie: {_near_tie(p)}")
    return parted


def _mla_family(op, chain) -> Optional[str]:
    """_profile_split's classifier of the MLA model: the attention (the
    latent gather, scores, softmax and the context's products;
    ops/mla_attention.py), the q/kv projections with the query's
    absorption (`_q_proj`, `_kv_latent`, `_absorb_q`), and DeepSeekMoE
    (`_ds_ffn`): there a batched product is an expert GEMM unless an
    einsum launched it, the shared experts' MLP is its own family, and
    the rest is the router and its glue.  Outside these the products
    (the output projection, the dense first layer's MLP, the lm_head)
    are dense matmuls and the rest other."""
    if op is None:
        return None
    if "mla_attn" in chain:
        return "MLA attention"
    if "mla_proj" in chain:
        return "q/kv projections"
    if "mla_ffn" in chain:
        return ("shared experts" if "mla_mlp" in chain
                else "expert GEMMs" if op == "aten::bmm"
                and "aten::einsum" not in chain else "router+glue")
    if op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"):
        return "dense matmuls"
    return "other"


def _mla_split(run, what: str, card: str) -> Optional[dict]:
    """Device time by family (MLA_FAMILIES, ms) of `run()`
    (_profile_split with the MLA model's functions in ranges,
    `_mla_family`)."""
    from dynamo_tpu_torch.models import deepseek

    ranges = {(deepseek, "mla_decode_attention"): "mla_attn",
              (deepseek, "mla_prefill_attention"): "mla_attn",
              (deepseek, "_q_proj"): "mla_proj",
              (deepseek, "_kv_latent"): "mla_proj",
              (deepseek, "_absorb_q"): "mla_proj",
              (deepseek, "_ds_ffn"): "mla_ffn",
              (deepseek, "_mlp"): "mla_mlp"}
    return _profile_split(run, ranges, _mla_family, MLA_FAMILIES,
                          f"MLA device split, {what} ({card})")


def _mla_layer_inputs(layer, cfg, device, dtype, faults: bool = False):
    """Layer 0's MLA inputs at `dtype` (bf16, or the fp32 reference from
    the same weights and hidden states upcast): MLA_LAYER_CTX cached
    tokens written into a fresh latent cache, then a MLA_LAYER_T-token
    chunk after them, and four decode rows at the whole context.
    Returns (prefill arguments, decode arguments, (the decode rows'
    q_nope, w_uk)); with `faults` the table's second block, a context
    block of every row, is a foreign block of other latents."""
    from dynamo_tpu_torch.models import deepseek
    from dynamo_tpu_torch.ops.paged_attention import write_prompt_kv

    bs, C, T = 128, MLA_LAYER_CTX, MLA_LAYER_T
    n = C + T
    nb = n // bs
    gen = torch.Generator(device=device).manual_seed(21)
    x = torch.randn(n + 4, cfg.d_model, generator=gen,
                    device=device).to(cfg.dtype).to(dtype)
    lay = {k: (v.to(dtype) if torch.is_tensor(v) else
               {kk: vv for kk, vv in v.items()})
           for k, v in layer.items() if k not in ("w_gate", "w_up",
                                                  "w_down")}
    c32 = dataclasses.replace(cfg, dtype=dtype)
    pos = torch.arange(n, device=device)
    h = deepseek.rms_norm(x[:n], lay["attn_norm"]["norm"], cfg.rms_eps)
    q_nope, q_rope = deepseek._q_proj(lay, c32, h, pos)
    c, kr = deepseek._kv_latent(lay, c32, h, pos)
    kv = tuple(torch.zeros(s, dtype=dtype, device=device)
               for s in deepseek.kv_cache_shapes(c32, nb + 2, bs))
    table = torch.arange(1, nb + 1, dtype=torch.int32, device=device)
    write_prompt_kv(*kv, 0, c[:n, None], kr[:n, None], table, 0, n)
    # a foreign block: other latents in the spare block nb + 1
    for t in kv:
        t[0, 0, nb + 1] = torch.randn(t.shape[3:], generator=gen,
                                      device=device).to(dtype)
    if faults:
        table = table.clone()
        table[1] = nb + 1
    pre = (q_nope[C:], q_rope[C:], c[C:], kr[C:], *kv, 0, table, C, T,
           lay["w_uk"], lay["w_uv"])
    # four decode rows at the whole context, their own new tokens
    hd = deepseek.rms_norm(x[n:], lay["attn_norm"]["norm"], cfg.rms_eps)
    dpos = torch.full((4, 1), n, device=device)
    qn, qr = deepseek._q_proj(lay, c32, hd[:, None], dpos)
    q_abs = deepseek._absorb_q(lay, qn[:, 0])
    lens = torch.full((4,), n, dtype=torch.int32, device=device)
    dec = (q_abs, qr[:, 0], *kv, 0, table[None].expand(4, -1), lens,
           lay["w_uv"], deepseek.score_scale(cfg.qk_head_dim))
    return pre, dec, (qn[:, 0], lay["w_uk"])


def _mla_layer_check(params, mc, device) -> dict:
    """Gate 3: one layer's MLA attention in bf16 (layer 0's weights, the
    projections and the cache in bf16) against the same computation from
    the same weights and hidden states in fp32: the non-absorbed prefill
    of a MLA_LAYER_T-token chunk after MLA_LAYER_CTX cached tokens and
    the absorbed decode of four rows over all of them.  Exits unless
    every output row's (one token's one head) relative L2 error is within
    MLA_LAYER_TOL, and unless a planted foreign block reads above it."""
    from dynamo_tpu_torch.ops.mla_attention import (
        mla_decode_attention,
        mla_prefill_attention,
    )

    layer = params["layers"][0]
    ref_pre, ref_dec, _ = _mla_layer_inputs(layer, mc, device, torch.float32)
    want = (mla_prefill_attention(*ref_pre), mla_decode_attention(*ref_dec))
    del ref_pre, ref_dec
    out = {}
    for faults in (False, True):
        pre, dec, _ = _mla_layer_inputs(layer, mc, device, mc.dtype, faults)
        got = (mla_prefill_attention(*pre), mla_decode_attention(*dec))
        torch.cuda.synchronize()
        for what, g, w in zip(("prefill", "decode"), got, want):
            out[(what, faults)] = row_rel_err(g, w)
        del pre, dec, got
    log(f"one MLA layer in bf16 against fp32 (prefill T={MLA_LAYER_T} "
        f"after {MLA_LAYER_CTX} cached tokens, non-absorbed; decode of 4 "
        f"rows over {MLA_LAYER_CTX + MLA_LAYER_T}, absorbed): max row "
        f"relative L2 error prefill {out[('prefill', False)]:.3e}, decode "
        f"{out[('decode', False)]:.3e} (limit {MLA_LAYER_TOL}); planted "
        f"foreign block: prefill {out[('prefill', True)]:.3e}, decode "
        f"{out[('decode', True)]:.3e} (must exceed it)")
    for what in ("prefill", "decode"):
        if not out[(what, False)] <= MLA_LAYER_TOL:
            raise SystemExit(f"MLA {what} attention in bf16 disagrees with "
                             "fp32")
        if not out[(what, True)] > MLA_LAYER_TOL:
            raise SystemExit(f"MLA {what}: the planted foreign block reads "
                             "within the limit")
    return {f"{w}{'_fault' if f else ''}": v for (w, f), v in out.items()}


def _mla_absorb_check(params, mc, device) -> float:
    """Gate 4: the absorbed decode (ops/mla_attention.py, the query
    absorbed through w_uk) against a materialised non-absorbed oracle on
    the same fp32 cache: per-head keys W_UK c_t concatenated with the
    shared rope key, values W_UV c_t, plain softmax attention.  Exits
    unless every row's relative L2 error is within MLA_ABSORB_TOL (the
    CPU twin: tests/test_torch_mla.py, as tests/test_mla.py:138)."""
    from dynamo_tpu_torch.ops.mla_attention import (
        _gather_latent,
        mla_decode_attention,
    )

    _, dec, (q_nope, w_uk) = _mla_layer_inputs(
        params["layers"][0], mc, device, torch.float32)
    q_abs, q_rope, c_cache, kr_cache, li, tables, lens, w_uv, scale = dec
    got = mla_decode_attention(*dec)
    c = _gather_latent(c_cache, li, tables)            # [B, S, R]
    kr = _gather_latent(kr_cache, li, tables)          # [B, S, dr]
    k_nope = torch.einsum("bsr,hrd->bhsd", c, w_uk)
    v = torch.einsum("bsr,hrd->bhsd", c, w_uv)
    s = (torch.einsum("bhd,bhsd->bhs", q_nope, k_nope)
         + torch.einsum("bhd,bsd->bhs", q_rope, kr)) * scale
    mask = torch.arange(c.shape[1], device=device)[None, None] \
        < lens[:, None, None]
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    oracle = torch.einsum("bhs,bhsd->bhd", p, v)
    torch.cuda.synchronize()
    err = row_rel_err(got, oracle)
    log(f"MLA absorbed decode against the materialised non-absorbed oracle "
        f"(fp32, 4 rows over {MLA_LAYER_CTX + MLA_LAYER_T} positions): max "
        f"row relative L2 error {err:.3e} (limit {MLA_ABSORB_TOL})")
    if not err <= MLA_ABSORB_TOL:
        raise SystemExit("the absorbed MLA decode disagrees with the "
                         "non-absorbed oracle")
    return err


def _mla_worker(device, cfg, params) -> dict:
    """Gate 5: one request (the 500-token prompt) through a
    TorchEngineWorker asked for an int8 cache and the fused epilogue:
    it must finish with 32 tokens, and the MDC in discovery must
    advertise what the engine runs, a bf16 cache and the epilogue off
    (JAX's fallbacks), with load_metrics reporting bf16 too.  The worker
    skips warm-up (the engine phase holds the program builds)."""
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8",
                              sampling_epilogue="fused")
    req = _requests(cfg.resolve_model().vocab_size)[1]

    async def run():
        async with _serving_worker(device, cfg, params, warmup=False) as (
                rt, worker, client, seen):
            mdc = await rt.discovery.get_prefix(
                worker.card.key(worker.served.instance_id))
            res = await _serve_worker(client, [req])
            for _ in range(100):
                if seen["load"]:
                    break
                await asyncio.sleep(0.05)
            return res[0], list(seen["load"]), list(mdc.values())

    (toks, finish, ttft, _), load, mdc = asyncio.run(run())
    rc = (mdc[0] if len(mdc) == 1 else {}).get("runtime_config", {})
    got = {"kv_cache_dtype": rc.get("kv_cache_dtype"),
           "sampling_epilogue": rc.get("sampling_epilogue"),
           "load_kv_cache_dtype": load[-1].get("kv_cache_dtype")
           if load else None}
    log(f"MLA worker (int8 and fused asked): request 1 {len(toks)} tokens, "
        f"finish={finish}, ttft={ttft:.3f} s; MDC {got}")
    if finish != "length" or len(toks) != 32:
        raise SystemExit("the MLA worker's request did not finish with 32 "
                         "tokens")
    if got != {"kv_cache_dtype": "bf16", "sampling_epilogue": "off",
               "load_kv_cache_dtype": "bf16"}:
        raise SystemExit(f"the MLA worker advertises settings it does not "
                         f"run: {got}")
    return {"ttft": ttft, **got}


def _mla_padded_ms(eng, device) -> tuple:
    """(device ms, host ms) of a padded 1 x 2048 prefill dispatch after
    serving (CUDA events; 3 calls): a random prompt over blocks 1-16."""
    c = eng.config
    a = eng._padded_warmup(1, 2048)
    a["toks"][:] = np.random.default_rng(4).integers(
        0, eng.model_cfg.vocab_size, (1, 2048))
    a["true_lens"][:] = 2048
    a["tables"][0, :2048 // c.block_size] = 1 + np.arange(
        2048 // c.block_size)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):
        eng.padded_prefill.run(a)
    host = (time.perf_counter() - t0) / 3
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 3, 1e3 * host, a


def check_mla(device, card: str) -> dict:
    """The MLA phase (module docstring).  Returns {"launches": K1/K3's
    counts in the graphed engine's run (0: MLA runs no kernel of the
    port), "seconds": ..., and the measured numbers}."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.models import deepseek, llama
    from dynamo_tpu_torch.obs.costs import (
        program_costs,
        program_terms,
        weight_bytes,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mc = _mla_model()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = deepseek.init_params(mc, gen, device)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    # bf16 cache bytes a token: both members' elements over the layers
    per_tok = {name: 2 * sum(int(np.prod(s)) for s in fam.kv_cache_shapes(
        cfg, 1, 1)) for name, fam, cfg in (
            ("deepseek-v2-lite", deepseek, mc),
            ("llama-8b", llama, llama.PRESETS["llama-8b"]))}
    log(f"MLA: deepseek-v2-lite at its published widths and full depth "
        f"(d={mc.d_model}, {mc.n_layers} layers, {mc.n_heads} heads, "
        f"kv_lora_rank {mc.kv_lora_rank}, qk_nope {mc.qk_nope_head_dim}, "
        f"qk_rope {mc.qk_rope_head_dim}, v_head {mc.v_head_dim}, first "
        f"{mc.first_k_dense} dense (ffn {mc.ffn_dim}), {mc.n_experts} routed "
        f"experts top {mc.experts_per_token} (ffn {mc.moe_ffn_dim}) plus "
        f"{mc.n_shared_experts} shared, vocab {mc.vocab_size}): "
        f"{sum(t.numel() for t in leaves) / 1e9:.2f} B parameters, "
        f"{nbytes / 1e9:.2f} GB of random bf16 weights made on the card in "
        f"{time.perf_counter() - t0:.1f} s; bf16 cache bytes a token "
        f"{per_tok['deepseek-v2-lite']} (llama-8b {per_tok['llama-8b']})")
    used = _kernels_of("bf16")
    reqs = _requests(mc.vocab_size)

    # the default scheduler with its decode bursts on graphs
    eng = TorchEngine(_moe_engine_config(mc), params=params, device=device)
    t0 = time.perf_counter()
    eng.warmup_decode()
    built = _log_programs(eng, "MLA engine")
    padded = dict(eng.padded_prefill.counts)
    guided = dict(eng.guided_graphs.counts)
    log(f"MLA engine: warm-up in {time.perf_counter() - t0:.1f} s; padded "
        f"prefill shapes {sorted(padded)}; packed programs "
        f"{eng.prefill_graphs}, verify programs {eng.verify_graphs}; "
        f"decode graph pool {eng.graphs.pool_bytes / 2**20:.0f} MiB")
    if eng.prefill_graphs is not None or eng.verify_graphs is not None \
            or set(padded) != set(eng._padded_shapes()) \
            or set(padded.values()) != {1}:
        raise SystemExit("MLA warm-up built a packed program or missed a "
                         "padded shape")
    res, launches, stats = _moe_serve(eng, reqs, used)
    _mla_check_served("graphs", res, card, eng.config)
    if eng.graphs.counts != built or eng.padded_prefill.counts != padded \
            or eng.guided_graphs.counts != guided:
        raise SystemExit("the MLA engine built programs while serving")
    log(f"MLA engine launches of the port's kernels: {launches} (MLA "
        f"attention is plain torch); {stats['decode_steps']} decode steps, "
        f"{stats['prefill_steps']} padded prefill dispatches; nothing built "
        "while serving")
    if any(launches.values()) or not stats["decode_steps"]:
        raise SystemExit("the MLA engine launched a GQA kernel or decoded "
                         "nothing")
    burst = check_graph_burst(eng, device, "deepseek-v2-lite bf16")
    step_bytes = weight_bytes(mc)
    counted = program_costs(mc, "decode", (True, 8), rows=4, max_blocks=16,
                            block_size=128)["bytes"]
    bound_ms = 1e3 * counted / HBM_BYTES_PER_S
    log(f"MLA k=8 burst replay {burst['burst_ms']:.3f} ms ({card}) against "
        f"its byte bound: {step_bytes / 1e9:.2f} GB of weights a step "
        f"(dense dispatch reads every expert) = "
        f"{8e3 * step_bytes / HBM_BYTES_PER_S:.2f} ms a burst at 3.35 TB/s; "
        f"with the full tables' latents {counted / 1e9:.2f} GB = "
        f"{bound_ms:.2f} ms ({burst['burst_ms'] / bound_ms:.2f}x); "
        f"{burst['ops_per_token']:.1f} device operations per decode token "
        f"({burst['ops_per_token'] / mc.n_layers:.1f} a layer)")
    dev_ms, host_ms, a = _mla_padded_ms(eng, device)
    terms = program_terms(mc, "prefill_padded", (1, 2048), max_blocks=16,
                          block_size=128)
    # the bf16 products at the tensor cores' peak, the fp32 attention at
    # the fp32 peak
    f_bound = 1e3 * (terms["matmul_flops"] / BF16_FLOPS_PER_S
                     + terms["attn_flops"] / FP32_FLOPS_PER_S)
    log(f"MLA padded 1 x 2048 prefill dispatch: {dev_ms:.3f} ms on the "
        f"device, {host_ms:.3f} ms on the host to dispatch ({card}); "
        f"counted {terms['matmul_flops'] / 1e12:.2f} TFLOP of bf16 products "
        f"(every expert on every token) at 989 TFLOP/s and "
        f"{terms['attn_flops'] / 1e12:.2f} TFLOP of fp32 attention at 67 "
        f"TFLOP/s = {f_bound:.2f} ms ({f_bound / dev_ms:.2f} of it)")
    split = {"decode": _mla_split(lambda: eng.graphs.run_eager(True, 8),
                                  "eager k=8 decode burst body", card),
             "prefill": _mla_split(lambda: eng.padded_prefill.run(a),
                                   "a padded 1 x 2048 prefill dispatch",
                                   card)}
    _free_engine(eng)
    del eng

    layer = _mla_layer_check(params, mc, device)
    absorb = _mla_absorb_check(params, mc, device)
    gc.collect()
    torch.cuda.empty_cache()

    # gate 2: the same engine with its programs run eagerly
    eeng = TorchEngine(_moe_engine_config(mc), params=params, device=device,
                       cuda_graphs=False)
    eager, _, _ = _moe_serve(eeng, reqs, used)
    _mla_check_served("eager", eager, card, eeng.config)
    _free_engine(eeng)
    del eeng
    parted = _mla_streams("MLA graphs against eager", res, eager, reqs,
                          params, mc, device)
    bad = [p for p in parted if not _near_tie(p)]
    if bad:
        raise SystemExit(f"MLA streams part at neither a logit near-tie nor "
                         f"a router near-tie: {bad}")
    log(f"MLA: greedy streams of the graphed engine equal the eager "
        f"engine's{' but at near-ties' if parted else ''}")
    worker = _mla_worker(device, _moe_engine_config(mc), params)
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"MLA phase: {secs:.1f} s, max_memory_allocated {peak:.1f} GiB "
        f"({card})")
    return {"launches": launches, "burst": burst, "bound_ms": bound_ms,
            "padded_ms": (dev_ms, host_ms), "flop_bound_ms": f_bound,
            "split": split, "layer_err": layer, "absorb_err": absorb,
            "parted": parted, "worker": worker,
            "tokens_s": _decode_rate(res), "ttft": [r[2] for r in res],
            "peak_gib": peak, "seconds": secs}


def _mla_check_served(what: str, res, card: str, cfg) -> None:
    """Log TTFT and decode tokens/s of a _serve result of the MLA engine;
    exit unless every request finished with 32 tokens."""
    n, secs = _decode_rate(res)
    log(f"serving deepseek-v2-lite, {what} ({card}): ttft s per request "
        f"{[round(r[2], 4) for r in res]}, decode {n} tokens in "
        f"{secs:.3f} s = {n / secs:.1f} tokens/s aggregate "
        f"(max_num_seqs={cfg.max_num_seqs})")
    bad = [i for i, r in enumerate(res) if r[1] != "length"
           or len(r[0]) != 32]
    if bad:
        raise SystemExit(f"MLA {what}: requests {bad} did not finish with 32 "
                         "tokens")


def load_checkout(path: str):
    """(_build, cuda_paged_attention, cuda_packed_prefill) of the port in
    another checkout at `path` (for instance the parent commit unpacked
    into a git-ignored directory), imported under another package name;
    its kernels build into that checkout's own _build/."""
    import importlib
    import importlib.util
    from pathlib import Path

    pkg = Path(path).resolve() / "dynamo_tpu_torch"
    name = "ab_dynamo_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in
                 ("_build", "cuda_paged_attention", "cuda_packed_prefill"))


def ab_compare(cfg, device, path: str) -> list:
    """Each mode of K1 and K3 of this checkout against the same mode of
    the checkout at `path`, at every case, on the same inputs and in one
    process: both outputs held to the plain version, and each timed by
    graph replay in turns (other, this, this, other).  K3's "this" is
    timed with its tile plan computed beforehand and with a plan of its
    own per call.  Also times this K1 at other split counts."""
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
    from dynamo_tpu_torch.ops import cuda_paged_attention as k1
    from dynamo_tpu_torch.ops.packed_prefill import (
        packed_prefill_attention_ref,
    )
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_attention_decode_ref,
    )

    _, o1, o3 = load_checkout(path)
    rows = []
    for int8 in (False, True):
        for case, kv_lens in DECODE_CASES:
            c = decode_case(cfg, device, kv_lens, int8)
            sc = dict(k_scale=c["cache"][2], v_scale=c["cache"][3]) \
                if int8 else {}
            ref = paged_attention_decode_ref(
                c["q"], *c["cache"][:2], c["layer"], c["tables_t"],
                c["lens_t"], round_scaled_q=True, **sc)
            old, new = decode_call(o1, c), decode_call(k1, c)
            errs = [row_rel_err(f(), ref) for f in (old, new)]
            t = [graph_time_ms(f) for f in (old, new, new, old)]
            sweep = {}
            if not int8:
                for n in (2, 4, 5, 8, 9, 16):
                    sweep[n] = graph_time_ms(lambda n=n: k1._launch(
                        c["q"], *c["cache"], None, None, c["layer"],
                        c["tables_t"], c["lens_t"], n_splits=n))
            rows.append({"kernel": "K1-int8" if int8 else "K1",
                         "case": case, "old_ms": (t[0] + t[3]) / 2,
                         "new_ms": (t[1] + t[2]) / 2, "turns": t,
                         "old_rel_err": errs[0], "new_rel_err": errs[1],
                         "bound_ms": decode_bound(cfg, c)[0],
                         "splits_sweep_ms": sweep})
            log(f"A/B {rows[-1]}")
        for case, lens, ctx0, order, T in PACKED_CASES:
            c = packed_case(cfg, device, lens, ctx0, order, T, int8)
            sc = dict(k_scale=c["cache"][2], v_scale=c["cache"][3]) \
                if int8 else {}
            ref = packed_prefill_attention_ref(
                c["q"], *c["cache"][:2], c["layer"], *c["args"],
                round_scaled_q=True, **sc)
            plan = packed_plan_call(k3, cfg, c)()
            old, new = packed_call(o3, c), packed_call(k3, c, plan=plan)
            errs = [row_rel_err(f(), ref) for f in (old, new)]
            t = [graph_time_ms(f) for f in (old, new, new, old)]
            rows.append({"kernel": "K3-int8" if int8 else "K3",
                         "case": case, "old_ms": (t[0] + t[3]) / 2,
                         "new_ms": (t[1] + t[2]) / 2, "turns": t,
                         "new_with_plan_ms": graph_time_ms(
                             packed_call(k3, c)),
                         "old_rel_err": errs[0], "new_rel_err": errs[1],
                         "bound_ms": packed_bound(cfg, c)[0]})
            log(f"A/B {rows[-1]}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; nothing to run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from dynamo_tpu_torch.models.llama import PRESETS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)
    cfg = PRESETS["llama-8b"]
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        # python3 chip_smoke.py --ab OTHER_CHECKOUT: the kernels only,
        # this checkout's against the other's
        other = load_checkout(sys.argv[2])[0]
        log(f"build of {sys.argv[2]}: "
            f"{sorted(other.compile_sources(['paged_decode', 'packed_prefill']))}")
        build_kernels()
        print(json.dumps({"ab": ab_compare(cfg, device, sys.argv[2])}),
              flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--decode-ab"]:
        # python3 chip_smoke.py --decode-ab: lockstep eager decode
        # against the default scheduler on graphs, in turns
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        print(json.dumps({"decode_ab": decode_ab(device, card, params)}),
              flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--fused-ab"]:
        # python3 chip_smoke.py --fused-ab: the sampling epilogue off
        # against fused, in turns
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        print(json.dumps({"fused_ab": fused_ab(device, card, params)}),
              flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] in (["--prefill-ab"], ["--disagg"], ["--disagg-ipc"]):
        # python3 chip_smoke.py --prefill-ab: eager packed prefill against
        # one graph per bucket, in turns; --disagg: the disagg phase;
        # --disagg-ipc: the pair across two processes
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        if sys.argv[1] == "--prefill-ab":
            out = {"prefill_ab": prefill_ab(device, card, params)}
        elif sys.argv[1] == "--disagg":
            out = {"disagg": check_disagg(device, card, params)}
            out["disagg"].pop("ref_one")
        else:
            out = {"disagg_ipc": check_disagg_ipc(device, card, params)}
        print(json.dumps(out, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--kvbm"]:
        # python3 chip_smoke.py --kvbm: the KVBM phase
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        print(json.dumps({"kvbm": check_kvbm(device, card, params)},
                         default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--spec"]:
        # python3 chip_smoke.py --spec: the speculative decoding phase
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        print(json.dumps({"spec": check_spec(device, card, params)},
                         default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--lora"]:
        # python3 chip_smoke.py --lora: the LoRA and guided phase
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        print(json.dumps({"lora": check_lora_guided(device, card, params)},
                         default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--checkpoint"]:
        # python3 chip_smoke.py --checkpoint: the loaded-checkpoint phase
        build_kernels()
        print(json.dumps({"checkpoint": check_checkpoint(device, card)}),
              flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--status"]:
        # python3 chip_smoke.py --status: the bf16 worker phase with its
        # status plane (no direct engine run before it)
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        t0 = time.perf_counter()
        launches = check_worker(device, card, _engine_config("bf16"),
                                params, None)
        print(json.dumps({"status": {
            "launches": launches,
            "seconds": round(time.perf_counter() - t0, 1)}}), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--moe"]:
        # python3 chip_smoke.py --moe: the MoE phase
        build_kernels()
        out = check_moe(device, card)
        print(json.dumps({"moe": {k: out[k] for k in (
            "launches", "worker_launches", "capacity_launches", "layer_err",
            "seconds")}}), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--mla"]:
        # python3 chip_smoke.py --mla: the MLA phase
        out = check_mla(device, card)
        print(json.dumps({"mla": {k: out[k] for k in (
            "launches", "layer_err", "absorb_err", "worker", "bound_ms",
            "flop_bound_ms", "peak_gib", "seconds")}}), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--worker-ab"]:
        # python3 chip_smoke.py --worker-ab: the engine directly against
        # the engine behind the worker, in turns
        print(json.dumps({"worker_ab": worker_ab(device, card)}), flush=True)
        print(card, flush=True)
        return 0
    build_kernels()
    kernels = [check_decode_kernel(cfg, device),
               check_prefill_kernel(cfg, device),
               check_decode_kernel(cfg, device, int8=True),
               check_prefill_kernel(cfg, device, int8=True)]
    dma = check_dma_kernels(device)
    torch.cuda.empty_cache()
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")
    launches, engine, ops_bf16, direct = check_engine(device, card)
    # the operations the default engine's k = 8 program dispatches, for
    # the LoRA phase's bank-less engine to match
    ops_default = _dispatched_ops(engine, 8)
    log(f"bf16 engine phase done at {time.perf_counter() - t_start:.1f} s")
    # the later runs reuse the weights; each cache is freed first
    params = engine.params
    engine.kv = engine.graphs = engine.prefill_graphs = None
    engine.guided_graphs = None
    torch.cuda.empty_cache()
    worker_launches = check_worker(device, card, engine.config, params,
                                   direct)
    log(f"bf16 worker phase done at {time.perf_counter() - t_start:.1f} s")
    del engine
    torch.cuda.empty_cache()
    # one round in the whole check (two with --decode-ab), so the
    # prefill A/B and disagg phases fit in the script's time budget
    decode_ab(device, card, params, rounds=1)
    torch.cuda.empty_cache()
    log(f"decode A/B phase done at {time.perf_counter() - t_start:.1f} s")
    fused_ab(device, card, params)
    torch.cuda.empty_cache()
    log(f"fused A/B phase done at {time.perf_counter() - t_start:.1f} s")
    prefill_ab(device, card, params)
    torch.cuda.empty_cache()
    log(f"prefill A/B phase done at {time.perf_counter() - t_start:.1f} s")
    launches8, engine8, ops_int8, _ = check_engine(device, card, "int8",
                                                   params)
    launches.update(launches8)
    log(f"int8 engine phase done at {time.perf_counter() - t_start:.1f} s")
    engine8.kv = engine8.graphs = engine8.prefill_graphs = None
    engine8.guided_graphs = None
    torch.cuda.empty_cache()
    worker_launches.update(check_worker_short(device, engine8.config, params))
    log(f"int8 worker phase done at {time.perf_counter() - t_start:.1f} s")
    log(f"device operations per decode step (one sequence): int8 cache "
        f"{ops_int8} against bf16 cache {ops_bf16} (the plain-torch "
        f"quantize-on-write adds {ops_int8 - ops_bf16})")
    del engine8
    torch.cuda.empty_cache()
    disagg = check_disagg(device, card, params)
    log(f"disagg phase done at {time.perf_counter() - t_start:.1f} s")
    ipc = check_disagg_ipc(device, card, params, disagg.pop("ref_one"),
                           disagg["transfer_gb_s"]["broker"])
    log(f"disagg ipc phase done at {time.perf_counter() - t_start:.1f} s")
    kvbm = check_kvbm(device, card, params)
    log(f"kvbm phase done at {time.perf_counter() - t_start:.1f} s")
    spec = check_spec(device, card, params)
    log(f"spec phase done at {time.perf_counter() - t_start:.1f} s")
    lora = check_lora_guided(device, card, params, ops_default)
    log(f"lora and guided phase done at {time.perf_counter() - t_start:.1f} "
        "s")
    del params
    torch.cuda.empty_cache()
    ckpt = check_checkpoint(device, card)
    log(f"checkpoint phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    mla = check_mla(device, card)
    log(f"mla phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    moe = check_moe(device, card)
    log(f"moe phase done at {time.perf_counter() - t_start:.1f} s")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["worker_launches"] = worker_launches[k["name"]]
        k["checkpoint_launches"] = ckpt["launches"].get(k["name"], 0)
        (k["disagg_prefill_launches"],
         k["disagg_decode_launches"]) = disagg["launches"][k["name"]]
        (k["disagg_ipc_prefill_launches"],
         k["disagg_ipc_decode_launches"]) = ipc["launches"].get(k["name"],
                                                                (0, 0))
        k["kvbm_launches"] = kvbm["launches"][k["name"]]
        k["spec_launches"] = spec["launches"][k["name"]]
        k["spec_draft_launches"] = spec["draft"]["catchup_launches"].get(
            k["name"], 0)
        k["lora_launches"] = lora["lora_launches"].get(k["name"], 0)
        k["guided_launches"] = lora["guided_launches"].get(k["name"], 0)
        k["moe_launches"] = moe["launches"].get(k["name"], 0)
        k["mla_launches"] = mla["launches"].get(k["name"], 0)
    for k in dma:  # the microbench is on no serving path
        k["disagg_prefill_launches"] = k["disagg_decode_launches"] = 0
        k["disagg_ipc_prefill_launches"] = k["disagg_ipc_decode_launches"] = 0
        k["kvbm_launches"] = k["spec_launches"] = k["spec_draft_launches"] = 0
        k["lora_launches"] = k["guided_launches"] = k["moe_launches"] = 0
        k["mla_launches"] = 0
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels + dma}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

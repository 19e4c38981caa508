#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, as below
    python3 chip_smoke.py --ab OTHER_DIR  # the kernels only, against
                                          # another checkout's
    python3 chip_smoke.py --worker-ab     # the engine directly against
                                          # the engine behind the worker
    python3 chip_smoke.py --frontend      # two full-depth workers behind
                                          # the port's frontend and KV
                                          # router
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
    python3 chip_smoke.py --discovery     # the int8 worker through etcd
                                          # and kubernetes discovery
    python3 chip_smoke.py --encoder       # the ViT encoder worker
    python3 chip_smoke.py --tp            # tensor parallelism, two ranks
                                          # on one card, full depth
    python3 chip_smoke.py --tp-families   # the MoE and MLA families on
                                          # two ranks on one card
    python3 chip_smoke.py --tp-disagg     # disaggregation and KVBM on
                                          # two ranks on one card
    python3 chip_smoke.py --tp-features   # speculation, LoRA, the fused
                                          # epilogue, guided and embed on
                                          # two ranks on one card
    python3 chip_smoke.py --sp            # sequence parallelism
    python3 chip_smoke.py --multihost     # a tp=2 mesh over a leader and
                                          # a follower launcher
    python3 chip_smoke.py --grouter       # an agg and a disagg pool on
                                          # the card behind the global
                                          # router, full depth
    python3 chip_smoke.py --loadgen       # loadgen's replay of 128 rows
                                          # through a full-depth worker
    python3 chip_smoke.py --chaos         # the chaos plane on two full-
                                          # depth workers behind the
                                          # frontend
    python3 chip_smoke.py --operator      # the graph operator and two
                                          # standalone router processes

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
bf16 KV cache and then, with the first layers of the same weights
(below), on an int8 KV cache sized by a memory budget
(`kv_cache_dtype="int8"`, `kv_hbm_gb`), and checks
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
and /health 503 after the drain), and, before that drain, the port's
OpenAI frontend and KV router on the same runtime (`_frontend_phase`:
/v1/models, the five prompts as text streamed through /v1/completions
against the same encodings over the request plane, a unary chat,
/v1/embeddings, a dropped stream, /metrics, the fifth request routed
with an 8-block overlap, K1/K3 launches counted around the HTTP
requests as `frontend_launches`; then /v1/messages unary and streamed
against /v1/chat/completions, count_tokens, a chained /v1/responses, a
multipart /v1/files upload run as a /v1/batches batch against the same
requests sent directly, /debug/requests, and, on a second frontend
with a session-affinity TTL, a session's three turns bound, reused and
released), KServe, the profiler's sweep and loadgen's replay of a
16-row synthesized trace through the worker and then through a port
MockerWorker on the same runtime (`_loadgen_phase`,
`loadgen_launches`); then the encoder phase (below), the
disagg phase (below, which ends with the pair as the disagg pool behind
the port's global router beside a mocker agg pool, `_grouter_short`,
`grouter_launches`), the pair across two processes (below) and the
spec phase (below).  These llama-8b phases run all 32 layers (the
pair's second process builds the preset, which has no depth flag; the
spec phase's n-gram turns must propose, which depends on the model's
streams).  The llama-8b phases after them serve the first
SERVE_LAYERS = 8 layers of the same weights, so that the whole check
stays well inside its time limit (each phase's flag alone runs all
32): the int8 engine run, with the bf16 cache's operations a decode
step counted again at that depth for its own; one request through a
worker on the int8 cache (its launches and the dtype it reports); the
same through a worker registered by etcd and by kubernetes discovery
against this script's standard-library fakes of an etcd gateway and
an API server (the discovery phase, below); the decode A/B, the fused
A/B and the prefill A/B (below); the KVBM phase (below); the LoRA and
guided phase (below).
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
`frontend_disagg_launches`, [prefill worker's, decode worker's] of
the same pair behind the port's frontend, always-disagg (run (a));
`lora_launches` in the LoRA phase's mixed batch and `guided_launches` in
its guided run; `etcd_launches` and `kube_launches` in the discovery
phase's requests; `embed_launches` and `encoder_launches`, counted
around the embed requests and the encoder phase, whose paths are plain
torch), error
against its plain version (`max_abs_err`, and
`max_rel_err`, the figure the tolerance holds), its device time (`ms`,
by CUDA-graph replay for K1/K3; K3's with its tile plan computed
beforehand, as the model does once per dispatch, `plan_ms` the plan
alone and `with_plan_ms` a call that computes its own; by CUDA events
around calls for K4), the plain version's time, the one-call PyTorch
yardstick's time (`library_ms`: scaled_dot_product_attention on the same
context gathered into a dense tensor beforehand, dequantized to bf16 for
the int8 modes; for K4 index_select of the table's blocks or a sum over
the slab, once a pass over the kernel's REPS passes; the port never
calls them), the least time the card
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

Every engine of the check serves with the KV ledger on (its default,
dynamo_tpu_torch/obs/kv_ledger.py).  The engine, decode A/B, disagg,
disagg IPC (its decode worker) and KVBM phases end each engine with an
on-demand audit that must reconcile clean with no violation counted by
any earlier sweep, and each KVBM turn holds the ledger's per-tier
onboard counts to the engine's and the KVBM manager's; the worker phase
checks the forensic stamp (`metrics["forensic"]`) on exactly each
stream's first-token and finish frames, and the status phase /debug/kv
(401 without the token; the schema, a clean fresh audit) and the
ledger's gauges on /metrics.

The decode A/B (part of the whole check with one round; alone with
--decode-ab) serves the five requests on a bf16 cache in one process by
a lockstep engine with single eager decode steps, a default engine on
graphs and the same with the KV ledger off (same weights, own caches),
in turns (lockstep, default, ledger_off, ledger_off, default, lockstep;
two rounds): TTFT per request, decode tokens/s, the median dispatch gap
per burst and per token, the median scheduler step's host wall time and
the ledger's sweeps, the device's busy share of a profiled turn and
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

The prefill A/B (part of the whole check with one round; alone with
--prefill-ab) serves the five requests on a bf16 cache by three default
engines with the same weights, packed prefill eager
(TorchEngine(prefill_graphs=False)), on graphs, and the padded programs
(prefill_packed=False), in turns (eager, graph, padded, padded, graph,
eager; two rounds): TTFT per request, the time from a warm run's start
to its first prefill record, the host time to dispatch one prefill,
decode tokens/s, and device operations per prefill token; the packed
paths' streams must be equal, the padded path's equal across its turns,
and each prompt's padded prompt-end logits within PADDED_LOGIT_TOL of
the packed ones; where the padded greedy streams first part from the
packed ones is logged with the packed top-2 gap there.

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
gather/inject GB/s against their byte bound; then the same pair behind
the port's frontend (kv router, DYN_INDEXER=auto: the native indexer
this script builds): the five prompts as text by hand, then through
HTTP always-disagg (streams equal, K3 launches equal the by-hand
pass's, no prefill on the decode worker) and conditionally (min isl
1024, ratio 0.7: request 1 remote, the rest local, request 5 on its
8-block overlap from the router's index; streams equal a by-hand run
in the same packed prefill dispatches, greedy ones the aggregated
engine's at a near-tie); then one request through an int8 pair
against an aggregated int8 engine.

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
with --mla): deepseek-v2-lite at its published widths (d 2048, 16
heads, kv_lora_rank 512, qk_nope 128, qk_rope 64, v_head 128, the first
layer dense with ffn 10944, then 64 routed experts of ffn 1408, top 6,
plus 2 shared; vocab 102400), at full depth (27 layers, 15.7 B random
bf16 parameters) with --mla and cut to MLA_LAYERS = 8 in the whole
check, weights made on the card from seed 0, a 512-block bf16
latent cache (31,104 bytes a token at 27 layers against llama-8b's
131,072 at 32), the llama-8b runs' scheduler and the same five
requests, dense dispatch.
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

The MoE phase (after the MLA phase in the whole check; alone with
--moe): mixtral-8x7b
at full width (d 4096, 32/8 heads, ffn 14336, 8 experts, top 2, vocab
32000) with its depth cut to MOE_LAYERS = 4 of 32 (the 32 layers hold
93.4 GB of bf16 weights, more than the card's 80 GB; 4 keep the whole
check inside its time limit),
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

The embed phase rides the bf16 worker phase, before its drain: the
worker's `embed` endpoint over the request plane at 37, 500 and 1800
tokens, each vector held to an fp32 computation of embed_text on the
card (cosine >= MIN_COSINE, a planted fault of one changed token below
it), ms a request against its bound and max_memory_allocated, and a
greedy stream with embeds sent while it decodes equal to one without.
The discovery phase (alone with --discovery) serves one int8 request
through a worker whose runtime registers by etcd, then by kubernetes,
against the fakes in this script: a second client sees the instance and
the MDC, the kernels are launched, the watcher sees the deletes after
revoke_lease; registration-to-visible and lease round-trip times are
logged.  The encoder phase (alone with --encoder) serves four .npy
images, twice, through the port's EncoderWorker with a ViT at CLIP
ViT-L/14-336 widths (bf16): 576 tokens an image, within ENCODER_TOL of
an fp32 tower, the repeat all cache hits, ms an image against the FLOP
bound (fp32 attention at 67 TFLOP/s); then two chats with a fifth
image through the port's frontend, in front of a one-layer LLM worker
of the encoder's model name: the EncoderHop encodes it (a tower call),
then finds it in the encoder's cache, and each request ends in the
worker's named refusal of the spliced embeddings (ROADMAP, Queue 3
item 9).  The script logs whether `grpc` and `google.protobuf` import
(the KServe service waits on it) and builds the router's native KV
indexer (host C++) after the kernels.

The tp phase (last in the whole check, llama-8b cut to TP_LAYERS = 4
layers; alone with --tp, all 32): two processes of an NCCL group on
cuda:0 report what NCCL says of two ranks on one device (it must
refuse), while a tp=1 engine (graphs, warmed up) and a tp=2 engine
(parallel/: rank 0 here, rank 1 a spawned process, both on cuda:0, so
the collectives go over gloo and the programs run eagerly) behind a
TorchEngineWorker serve the same random weights (seed 0): the
first-token logits of a 512-token prompt within TP_LOGIT_TOL of tp=1's
standard deviation, four concurrent greedy streams whose leading
tokens agree (a parting only where tp=1's top-2 gap is within the same
tolerance), then the decode tokens/s and TTFT of both in turns (tp1,
tp2, tp2, tp1; tp=2 through the worker's request plane, which keeps the
worker's health canary quiet) on the bf16 cache; then the same pair on
an int8 cache, its tp=1 engine eager (no timing).  K1 and K3 must be
launched on both ranks while serving, equally (rank 0's counted over
the worker's life less the tp=1 engine's runs, rank 1's reported by the
rank at close); after close no rank process is left and the card's
memory is back.  The kernel
checks also hold K1 (B = 8) and K3 (T = 2048), each mode, at a tp=2
rank's slab (nh 16 over nkv 4), the `tp2_slab` entry of each kernel;
`tp_launches` is [rank 0, rank 1] of the phase's serving.

The tp families phase (after the tp phase in the whole check, both
models at TP_LAYERS = 4; alone with --tp-families, mixtral-8x7b 4 of
32 layers and deepseek-v2-lite 8 of 27): the same tp=1 against tp=2
pair at full width for mixtral-8x7b in dense dispatch (K1 and K3 on
both ranks, equally: `tp_families_launches`) and, under the flag alone,
in capacity dispatch (K1 alone: the padded prefill programs), then
deepseek-v2-lite (plain torch MLA attention, no kernel), each with its
timing turns; a MoE
stream may also part at a router near-tie (a tp=2 replay in this
process, two ranks as threads, chose other experts for some token of
the context, and with tp=1's routing held it agrees).  The tp disagg
phase (then, llama-8b at TP_LAYERS; alone with --tp-disagg, all 32):
a tp=1 worker prefilling for a tp=2 worker over host-staged frames and
the reverse, and under the flag alone tp=1 -> tp=2 on the int8 cache,
the four requests one at a time against the tp=1 worker's own
aggregated streams (the same near-tie rule), the decode side
prefilling no token, pull GB/s and the prefill side's gather share
logged; then a tp=2 engine with a G2 tier offloads prompt A, and its
repeat after the churn onboards every full block of A from G2,
bit-equal on both ranks' kv heads to A's blocks gathered after a G1
hit, and streams the G1 hit's tokens.  `tp_disagg_rank1_launches` sums
rank 1's launches of those tp=2 sides.

The tp features phase (last, llama-8b at TP_LAYERS with one round of
turns; alone with --tp-features, all 32 layers and two): a tp=2 engine
with n-gram speculation, two synthesized rank-16 adapters
(lora_max_adapters 2) and the fused sampling epilogue, beside a tp=2
engine of the same config with the epilogue off, both two ranks on the
card over gloo, eager.  The fused engine's greedy streams equal the off
engine's prompt by prompt (a parting only at a near-tie of the off
engine's own logits), in turns with decode tokens/s, TTFT and the n-gram
acceptance; the adapters' streams differ from the base model's and a
mixed batch equals its requests served alone; a guided request's output
parses (the guided steps' host time); embed's latency, and its vector's
cosine to a tp=1 engine's >= MIN_COSINE.  Every verify dispatch launches
K3 once a layer on rank 0's slab, each engine's rank 1 launches K1 and
K3, and rank 0's launches equal the ranks 1's: `tp_features_launches`
is [rank 0, rank 1] of both engines.  The kernel checks also hold K3's
32-token verify stream at the slab (`tp2_slab["verify"]`).

The sp phase (last, llama-8b at TP_LAYERS; alone with --sp, all 32
layers, then a tp=2 x sp=2 engine of four ranks at TP_LAYERS): a tp=1
engine (graphs, warmed up) and an sp=2 engine (rank 1 spawned, both
ranks on the card over gloo, eager) on the same random weights, the
context raised to 8192 tokens; a 5000-token prompt (past the largest
prefill bucket, so it pads to T_pad 8192 and each rank holds 4096 query
rows) and a 300-token one, one at a time.  The long prompt takes the
ring prefill once and the short one stays packed (`ring_prefills`); the
ring's first-token logits are within TP_LOGIT_TOL std of tp=1's chunked
ones and the streams' leading tokens equal tp=1's (a parting only at a
near-tie); K1 and K3 launch on both ranks alike (`sp_launches`, [rank
0, rank 1]); the card's memory is back after close.  Logged: each
rank's ring program ms (CUDA events) against its bound (products at
989 TFLOP/s, the fp32 ring attention at 67 TFLOP/s), the bytes it sent
round the ring, its peak memory, and TTFT against tp=1's chunked TTFT.
Then the pipeline check: parallel/pipeline.py with two stages of
llama-8b's MLP as threads on the card, against their sequential
composition.

The multihost phase (last, llama-8b width at TP_LAYERS; alone with
--multihost, all 32 layers): a checkpoint written from a seed, served
by one tp=2 mesh over two launchers of `python -m
dynamo_tpu_torch.engine` (DYN_MH_RANK 1 started first, then 0,
DYN_MH_WORLD 2, JAX_COORDINATOR_ADDRESS on 127.0.0.1: two processes of
this machine standing in for two hosts, both ranks on the card over
gloo, eager).  Checked: the follower's `ready follower rank=1/2`, one
discoverable instance (the leader's), the four tp requests' streams
against a tp=1 engine on the same checkpoint (a parting only at a
near-tie), the leader's sharded load filling the weight cache and the
follower reading it, both launchers exiting 0 after the leader's
drain, and the follower's K1/K3 launches, read by the leader from the
mesh's store, non-zero and equal to its own log's and the leader's
(`multihost_launches`, [rank 0, rank 1]), every published step
replayed.

KServe, the profiler and the planner: before the bf16 worker phase's
frontend closes, the KServe gRPC service on its ModelManager
(`_kserve_phase`: the five prompts through ModelInfer and
ModelStreamInfer against /v1/completions' texts, `kserve_launches`);
then the profiler sweeps the same worker's engine (`_profiler_phase`:
ISL 128 and 1024 x concurrency 1 and 4, `profiler_launches`, the
profile's SLA inversion); and last the planner phase (`check_planner`,
the multihost phase's checkpoint, TP_LAYERS layers; alone with
--planner, all 32 with the profiler's CLI, SLA mode, the fleet scrape
and a Kubernetes scale): the planner spawns `python -m
dynamo_tpu_torch.engine --model-path` workers behind the port's
frontend, grows the fleet from 1 to 2 under a closed loop of requests
and drains it back while streams run, which must equal their
references (`planner_launches`, [first worker, second worker]).

The trace report, the operator, the standalone router and the chaos
plane: the bf16 worker phase reduces its tracer's dump and the main
run's window of it with `dynamo_tpu_torch.obs.report` (`_report_phase`:
the partition of the engine's wall time, whose named phases must
explain 95% of the main run's, and the roofline rows of its prefill and
decode dispatches at this card's peaks).  After the prefill A/B,
`check_fleet` (SERVE_LAYERS): the port's graph operator reconciles a
graph spec into Deployments on FakeKubeApi (create, a converged pass, a
planner scale write kept across an unrelated pass, a spec edit, a
removed component deleted); the rendered router Deployment's command
runs as a process on the discovery of two bf16 workers (file discovery,
zmq events) and must name an embedded KvRouter's pick for the five
prompts; behind the port's frontend, a truncated frame and an
engine-step crash mid-decode must migrate with the fault-free greedy
stream (a parting only at a near-tie), the crashed engine fail fast,
and the KV ledger's audit name each accounting fault the
`engine.kv_account` seam seeds (`chaos_launches`).  The disagg phase
fails its pair's KV pull once (the retry absorbs it) and then for good
(the decode worker prefills locally), both streams against the
aggregated engine's.  Alone: `--chaos` adds a failed dispatch, delayed
frames and a discovery outage; `--operator` a second router instance
(affinity: frees go to the instance that answered) and the operator's
`--once` CLI; `--decode-ab` times the seams with no plane against a
stub (`seam_ab`).

Bounds use the H100 SXM data sheet (3.35 TB/s HBM3, 989 TFLOP/s dense
bf16); a card run below its 700 W limit is slower, so its limit is
printed beside every number.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import gc
import json
import os
import struct
import subprocess
import sys
import threading
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
    gather and sequential walks; then the router's native KV indexer with
    the host C++ compiler.  Logs each instantiation's registers and
    spills (ptxas) and, for K1/K3, the shared memory a CTA asks for."""
    import re

    from dynamo_tpu_torch.bench import bench_dma_layouts as k4
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
    from dynamo_tpu_torch.ops import cuda_paged_attention as k1
    from dynamo_tpu_torch.router import native_indexer

    t0 = time.perf_counter()
    logs = _build.compile_sources([k1.KERNEL, k3.KERNEL, k4.KERNEL])
    dt = time.perf_counter() - t0
    # the router's native KV indexer (host C++), so DYN_INDEXER=auto
    # serves it in every frontend phase
    t1 = time.perf_counter()
    path = native_indexer.build()
    log(f"native KV indexer {path.name} built with "
        f"{native_indexer.compiler()} in {time.perf_counter() - t1:.1f} s")
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


def check_decode_kernel(cfg, device, int8: bool = False,
                        cases=DECODE_CASES) -> dict:
    """K1 in its bf16 mode, or (int8) in its int8 mode on the same
    shapes with the cache quantized by the port's quantizer, at every
    case of `cases` (DECODE_CASES); the first case is the one that
    carries the plain and library times."""
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
    for ci, (case, kv_lens) in enumerate(cases):
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


def check_prefill_kernel(cfg, device, int8: bool = False,
                         cases=PACKED_CASES) -> dict:
    """K3 in its bf16 mode, or (int8) in its int8 mode on the same
    streams with the cache quantized by the port's quantizer, at every
    case of `cases` (PACKED_CASES); the first case carries the plain and
    library times, and the verify case has its own under `cases`.  `ms` is the kernel alone, with the tile plan computed
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
    for ci, (case, lens, ctx0, order, T) in enumerate(cases):
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
    must read above it, and the plain version and the PyTorch calls are
    timed (index_select of the table's blocks, a sum over the slab, each
    once a pass over the kernel's REPS passes, so `library_ms` covers the
    kernel's reads; the gathers also write their copy, logged as their
    GB/s and `library_gb_per_s`)."""
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
    # one PyTorch call a pass, REPS passes, as the kernel makes
    library = {
        "strided": lambda: [torch.index_select(x["layer"], 1,
                                               x["tables"].long())
                            for _ in range(k4.REPS)],
        "contig": lambda: [torch.index_select(x["slab"], 0,
                                              x["tables"].long())
                           for _ in range(k4.REPS)],
        "seq": lambda: [torch.sum(x["slab"], dim=(0, 1),
                                  dtype=torch.float32)
                        for _ in range(k4.REPS)]}
    # the bytes the calls move: the gathers read the kernel's bytes and
    # write their copy, the sum reads them
    lib_bytes = {"strided": 2 * k4.nbytes("strided"),
                 "contig": 2 * k4.nbytes("contig"),
                 "seq": k4.nbytes("seq")}
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
            "library_gb_per_s": lib_bytes[mode] / library_ms / 1e6,
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


async def _audit_clean(engine, what: str) -> dict:
    """An on-demand audit of `engine`'s KV ledger (the /debug/kv cadence:
    between scheduler steps, under the step lock).  Exits unless the
    ledger is on, this sweep reconciles clean, and no earlier sweep (the
    finish and idle cadences) counted a violation.  Returns the audit's
    host ms (the wait for the step lock included) and the ledger's G1
    attribution."""
    led = engine.kv_ledger
    if led is None:
        raise SystemExit(f"{what}: the KV ledger is off")
    t0 = time.perf_counter()
    report = await engine.audit_kv()
    ms = (time.perf_counter() - t0) * 1e3
    totals = led.violations_by_kind()
    att = led.attribution()["g1"]
    counts = led.dump(tail=0)["counts"]
    log(f"{what}: KV ledger audit on demand "
        f"{'clean' if report.get('clean') else 'FAILED'} in {ms:.2f} ms, "
        f"{report.get('violation_count')} violation(s), totals {totals}; "
        f"G1 active {att['active']}, prefix-cached {att['prefix_cached']}, "
        f"pinned by transfer {att['pinned_by_transfer']}, tracked "
        f"{att['tracked']}; ops {counts}")
    if not report.get("clean") or totals:
        raise SystemExit(f"{what}: KV ledger violations "
                         f"{report.get('violations')}, totals {totals}")
    return {"ms": ms, "g1": att}


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
# llama-8b's depth in _engine_config: None is the preset's 32.  The whole
# check sets it to SERVE_LAYERS once the phases at full depth are done
# (module docstring), and those after them serve the first SERVE_LAYERS
# layers of the same weights
LLAMA_LAYERS: Optional[int] = None
SERVE_LAYERS = 8


def _engine_config(kv_dtype: str):
    """The engine runs' config: llama-8b at full width, LLAMA_LAYERS deep
    (None: all 32), four slots, a 2048-token prefill budget; 512 blocks
    of bf16 cache, or an int8 cache sized by INT8_KV_HBM_GB."""
    from dynamo_tpu_torch.engine import EngineConfig
    from dynamo_tpu_torch.models.llama import PRESETS

    size = (dict(kv_cache_dtype="int8", kv_hbm_gb=INT8_KV_HBM_GB)
            if kv_dtype == "int8" else dict(num_blocks=512))
    if LLAMA_LAYERS is not None:
        size["model_config"] = dataclasses.replace(PRESETS["llama-8b"],
                                                   n_layers=LLAMA_LAYERS)
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
            await _audit_clean(engine, f"engine ({kv_dtype})")
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
                          warmup: bool = True, runtime: Optional[dict] = None,
                          cluster_id: Optional[str] = None,
                          on_runtime=None, devices=None,
                          cuda_graphs: bool = True):
    """A TorchEngineWorker (config `cfg` with `warmup`, a fresh cache of
    its kind, weights `params`) on a fresh runtime of the port: mem
    discovery, in-process event plane, the TCP request plane on
    127.0.0.1.  With `status` the runtime also serves the system-status
    server on an ephemeral port with the admin token STATUS_TOKEN, and
    the worker's config carries this card's peaks (PEAK_TFLOPS,
    PEAK_HBM_GBPS) for the roofline gauges.  Yields (runtime, worker,
    generate client, seen), `seen` collecting every message on the
    worker's kv_events, load_metrics and fpm subjects under "kv", "load"
    and "fpm".  `runtime` overrides RuntimeConfig fields (another
    discovery backend), `cluster_id` names the runtime's cluster (a
    fresh one by default) and `on_runtime(rt)` runs before the worker
    starts.  `devices` and `cuda_graphs` go to the worker's engine (a
    mesh's devices; False on a gloo mesh).  On exit closes the worker
    and exits unless its MDC left discovery."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    extra = (dict(system_port=-1, admin_token=STATUS_TOKEN) if status
             else {})
    extra.setdefault("discovery_backend", "mem")
    extra.update(runtime or {})
    rt = await DistributedRuntime(config=RuntimeConfig(
        event_plane="inproc", tcp_host="127.0.0.1", **extra),
        cluster_id=cluster_id or uuid.uuid4().hex).start()
    if on_runtime is not None:
        on_runtime(rt)
    if status:
        cfg = dataclasses.replace(cfg, peak_tflops=PEAK_TFLOPS,
                                  peak_hbm_gbps=PEAK_HBM_GBPS)
    t0 = time.perf_counter()
    worker = await TorchEngineWorker(
        rt, dataclasses.replace(cfg, warmup=warmup), params=params,
        device=device, devices=devices, cuda_graphs=cuda_graphs).start()
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


async def _serve_worker(client, reqs, stamps: Optional[dict] = None):
    """_serve through the request plane: every request sent at once as
    PreprocessedRequest.to_dict() by `client`.  With `stamps` a dict,
    stamps[request id] collects (frame index, metrics["forensic"]) for
    every frame that carries the worker's forensic stamp, and
    stamps[(request id, "frames")] the stream's frame count."""
    t0 = time.perf_counter()

    async def one(req):
        toks, finish, first, i = [], None, None, 0
        async for out in client.generate(req.to_dict()):
            if out.get("token_ids") and first is None:
                first = time.perf_counter() - t0
            toks.extend(out.get("token_ids", []))
            finish = out.get("finish_reason")
            stamp = (out.get("metrics") or {}).get("forensic")
            if stamps is not None and stamp is not None:
                stamps.setdefault(req.request_id, []).append((i, stamp))
            i += 1
        if stamps is not None:
            stamps[(req.request_id, "frames")] = i
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


def _check_stamps(what: str, reqs, stamps: dict, hits: int) -> None:
    """The forensic stamp (the JAX engine's `_forensic`) on exactly each
    stream's first-token and finish frames: the first says 1 token
    generated, the finish the stream's 32, every one names a queue
    position among the requests sent and at least one prefill chunk,
    and the first stamps' realized prefix reuse sums to the engine's
    `cache_hit_tokens` (`hits`)."""
    bad, reused = [], 0
    for r in reqs:
        got = stamps.get(r.request_id, [])
        last = stamps.get((r.request_id, "frames"), 0) - 1
        ok = ([i for i, _ in got] == [0, last] and last > 0
              and got[0][1]["generated"] == 1
              and got[-1][1]["generated"] == r.stop.max_tokens
              and all(0 <= st["queue_pos"] < len(reqs)
                      and st["prefill_chunks"] >= 1 for _, st in got))
        if not ok:
            bad.append((r.request_id, got, last))
        elif got:
            reused += got[0][1]["cached_tokens"]
    log(f"{what}: forensic stamps on the first-token and finish frames of "
        f"{len(reqs) - len(bad)} of {len(reqs)} streams, e.g. "
        f"{stamps.get(reqs[-1].request_id)}; realized prefix reuse "
        f"{reused} tokens (engine {hits})")
    if bad or reused != hits:
        raise SystemExit(f"{what}: forensic stamps wrong or missing: {bad}")


async def _status_kv(rt, worker) -> dict:
    """/debug/kv without and with the token (401, then the worker's
    `kv:{instance_id}` source: schema dynamo.kv_ledger.v1, enabled, a
    fresh on-demand audit clean, no violation counted), and the ledger's
    gauges on /metrics (dynamo_kv_ledger_blocks per G1 state, no nonzero
    dynamo_kv_ledger_violations_total)."""
    addr = rt.system_address
    st_open, _ = await _http(addr, "/debug/kv")
    t0 = time.perf_counter()
    st, body = await _http(addr, "/debug/kv", token=STATUS_TOKEN)
    ms = (time.perf_counter() - t0) * 1e3
    src = json.loads(body)["sources"].get(
        f"kv:{worker.served.instance_id}", {}) if st == 200 else {}
    _, text = await _http(addr, "/metrics")
    samples = _parse_metrics(text.decode())
    blocks = {lab.get("state"): v for n, lab, v in samples
              if n == "dynamo_kv_ledger_blocks" and lab.get("tier") == "g1"}
    viol = [v for n, _, v in samples
            if n == "dynamo_kv_ledger_violations_total"]
    log(f"/debug/kv without the token {st_open}, with it {st} in "
        f"{ms:.1f} ms: schema {src.get('schema')}, enabled "
        f"{src.get('enabled')}, audit clean "
        f"{(src.get('audit') or {}).get('clean')}, violations_total "
        f"{src.get('violations_total')}, g1 {src.get('attribution', {}).get('g1')}"
        f"; /metrics dynamo_kv_ledger_blocks{{tier=g1}} {blocks}, "
        f"violation samples {viol}")
    if st_open != 401 or st != 200 \
            or src.get("schema") != "dynamo.kv_ledger.v1" \
            or src.get("enabled") is not True \
            or not (src.get("audit") or {}).get("clean") \
            or src.get("violations_total") or not blocks or any(viol):
        raise SystemExit("/debug/kv or the KV ledger gauges failed")
    return {"debug_kv_ms": ms, "g1": blocks}


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


async def _status_debug(rt, worker, client, reqs, seen) -> dict:
    """/debug/state with the token (the JAX keys), then /debug/profile for
    0.5 s while four long greedy streams decode: status "ok", a Chrome
    trace naming K1's kernel among its device events, and a device-memory
    snapshot.  Logs the longest decode dispatch-to-dispatch gap (FPM
    gap_s, from the worker's fpm messages in `seen`) inside the capture
    against the median outside it: the
    profiler's stop holds device.PROFILER_GRAPH_LOCK, so the scheduler's
    next replay waits for the stop and its event processing."""
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
    t0, m0 = time.perf_counter(), time.monotonic()
    st, body = await _http(addr, "/debug/profile?duration_s=0.5", "POST",
                           token=STATUS_TOKEN)
    took, m1 = time.perf_counter() - t0, time.monotonic()
    await asyncio.gather(*runs)
    await asyncio.sleep(0.6)  # the streams' last FPM records
    gaps = [(m0 <= r["t"] <= m1, r["gap_s"] * 1e3)
            for m in seen["fpm"] for r in m["steps"]
            if r["kind"] == "decode" and r["gap_s"] > 0
            and r["t"] >= m0 - 2.0]
    inside = max((g for i, g in gaps if i), default=None)
    outside = float(np.median([g for i, g in gaps if not i] or [0.0]))
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
        f"; error {prof.get('error') or prof.get('memory_profile_error')}"
        f"; longest decode dispatch gap inside the capture "
        f"{'(no burst)' if inside is None else f'{inside:.1f} ms'} (median "
        f"outside {outside:.2f} ms, {len(gaps)} bursts)")
    if st != 200 or prof.get("status") != "ok" or not k1 \
            or "mem_get_info" not in snap:
        raise SystemExit("/debug/profile did not capture K1 and a memory "
                         "snapshot")
    return {"profile_kernels": kernels, "profile_k1": k1,
            "profile_gap_ms": inside}


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
    return {"spans": len(rows), "step_ms": med, "arrival_waits": waits,
            "path": path}


# the report's bar (dynamo_tpu_torch/obs/report.py, as JAX's): the named
# phases of an engine track explain at least this share of its wall time
REPORT_NAMED_MIN = 0.95


def _report_phase(trace_path: str, run_doc: dict, card: str) -> dict:
    """The port's trace report (`dynamo_tpu_torch.obs.report`) on the bf16
    worker phase's recording, with this card's peaks: the whole dump
    the tracer wrote (warm-up, the main run, the status plane's turns,
    the tracing A/B's off turns as idle), and the main run's window of
    the same recording (`run_doc`: its spans, as Chrome trace JSON).
    Logs each partition (engine wall time by phase, innermost-span self
    time) and the main run's roofline rows (prefill and decode dispatch:
    FLOP/s and bytes/s from the port's cost count, MFU and MBU at
    PEAK_TFLOPS / PEAK_HBM_GBPS, the engine's own est_mfu) and the
    captured programs by family.  Exits unless the main run's named
    phases explain REPORT_NAMED_MIN of its engine wall time and both
    dispatch rows are there (a prefill row's rates count only the
    dispatches whose gap took a device sync, as the report's gate
    does)."""
    import tempfile

    from dynamo_tpu_torch.obs.report import report_paths

    t0 = time.perf_counter()
    fd, run_path = tempfile.mkstemp(prefix="chip-smoke-run-",
                                    suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(run_doc, f)
    try:
        whole = report_paths([trace_path], PEAK_TFLOPS, PEAK_HBM_GBPS)
        run = report_paths([run_path], PEAK_TFLOPS, PEAK_HBM_GBPS)
    finally:
        os.unlink(run_path)
    secs = time.perf_counter() - t0
    out = {"seconds": round(secs, 3)}
    for what, rep in (("whole trace", whole), ("main run", run)):
        gap = rep["gap"]
        fr = gap.get("wall_fractions", {})
        named = sum(v for k, v in fr.items() if k != "idle")
        out[what] = {"engine_wall_s": gap.get("engine_wall_s"),
                     "named": round(named, 4), "fractions": fr,
                     "spans": rep["spans"]}
        log(f"report ({what}, {rep['spans']} spans, {card}): engine wall "
            f"{gap.get('engine_wall_s')} s, named phases {named:.4f} of it "
            f"(bar {REPORT_NAMED_MIN}); partition {fr}; sched overhead "
            f"{gap.get('sched_overhead_frac')}, enqueue ahead "
            f"{gap.get('enqueue_ahead_frac')}, device wait "
            f"{gap.get('device_wait_frac')}, idle {gap.get('idle_frac')}")
    phases = run["roofline"]["phases"]
    for phase in ("prefill", "decode"):
        log(f"report roofline, main run, {phase} dispatches ({card}; peaks "
            f"{PEAK_TFLOPS:.0f} TFLOP/s bf16, {PEAK_HBM_GBPS:.0f} GB/s): "
            f"{phases.get(phase)}")
    compiles = whole["roofline"]["compiles"]
    log(f"report, captured programs by family (whole trace): "
        + "; ".join(f"{fam} x{c['count']} {c['seconds']:.3f} s, "
                    f"{c['serving']} while serving, intensity "
                    f"{c.get('intensity')}" for fam, c in compiles.items()))
    out["roofline"] = phases
    out["compile_families"] = len(compiles)
    log(f"report phase: {secs:.2f} s of host work")
    if out["main run"]["named"] < REPORT_NAMED_MIN:
        raise SystemExit(f"report: the main run's named phases explain "
                         f"{out['main run']['named']} of its engine wall "
                         f"time, under {REPORT_NAMED_MIN}")
    if any(not (phases.get(p) or {}).get("dispatches")
           for p in ("prefill", "decode")):
        raise SystemExit(f"report: the roofline lacks the prefill or the "
                         f"decode dispatches: {phases}")
    return out


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


def check_worker(device, card: str, cfg, params, direct) -> tuple:
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
    printed.  Before the drain, the same worker serves the embed phase
    (_embed_phase), then the port's frontend and KV router with its
    KServe service (_frontend_phase), then the profiler's sweep of the
    worker's engine (_profiler_phase).  Returns (the worker run's launch
    counts by kernel name, the embed phase's results, the frontend
    phase's, with the KServe run's under "kserve" and the profiler's
    under "profiler")."""
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
            stamps: dict = {}
            res = await _serve_worker(client, reqs, stamps)
            w1 = time.monotonic()
            counts = {fn.__name__: fn.launches for fn in used}
            # the main run's window of the recording, for the report
            tr = obs.tracer()
            run_doc = tr.chrome_trace(spans=[
                s for s in list(tr.spans) if w0 <= s[1] and s[2] <= w1])
            steps = {k: eng.metrics[k] - m0[k] for k in
                     ("decode_steps", "prefill_steps", "cache_hit_tokens")}
            _check_stamps("worker", reqs, stamps, steps["cache_hit_tokens"])
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
            await _status_kv(rt, worker)
            await _status_debug(rt, worker, client, reqs, seen)
            await _tracing_ab(eng, reqs)
            trace = await _status_trace(os.path.join(trace_dir,
                                                     "trace.json"))
            status_s[0] += time.perf_counter() - t_st
            report = _report_phase(trace["path"], run_doc, card)
            t_em = time.perf_counter()
            embed = await _embed_phase(rt, worker, reqs)
            embed["seconds"] = time.perf_counter() - t_em
            frontend = await _frontend_phase(rt, worker, params, used)
            frontend["profiler"] = await _profiler_phase(worker.engine,
                                                         used)
            frontend["loadgen"] = await _loadgen_phase(rt, worker, client,
                                                       used, LOADGEN_N)
            frontend["report"] = report
            t_st = time.perf_counter()
            await _status_drain(rt, worker, polled)
            status_s[0] += time.perf_counter() - t_st
            return (res, counts, steps, dict(seen), cleared, removed_after,
                    got, freed, (_step_medians(recs),
                                 _prefill_dispatches(recs, w0)), embed,
                    frontend)

    try:
        (res, counts, steps, seen, cleared, removed_after, got, freed,
         (step_ms, dispatches), embed, frontend) = asyncio.run(run())
    finally:
        if obs.tracer() is not None:
            obs.tracer().uninstall()
    log(f"status phase: {status_s[0]:.1f} s of its own (probes, gauges, "
        f"debug and profile routes, tracing A/B, trace, drain); embed "
        f"phase {embed['seconds']:.1f} s")
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
    return counts, embed, frontend


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


def _time_steps(engine, steps: list, audits: list) -> None:
    """Wrap the engine's scheduler step so each appends its wall seconds
    on the scheduler thread (host work and the device waits inside it)
    to `steps`, and its KV-ledger sweeps so each appends its seconds to
    `audits`."""
    step, sweep = engine._sched_step, engine._audit_ledger_locked

    def timed_step():
        t0 = time.perf_counter()
        step()
        steps.append(time.perf_counter() - t0)

    def timed_sweep(where="step"):
        t0 = time.perf_counter()
        out = sweep(where)
        audits.append(time.perf_counter() - t0)
        return out

    engine._sched_step, engine._audit_ledger_locked = timed_step, timed_sweep


def decode_ab(device, card: str, params, rounds: int = 2) -> dict:
    """The five requests at llama-8b width on a bf16 cache, served in one
    process by three engines with the same weights and their own caches:
    "lockstep", the lockstep scheduler with single eager decode steps
    (overlap_scheduling=False, decode_fused_steps=1, no CUDA graphs),
    "default", the JAX engine's defaults on CUDA graphs with the KV
    ledger on (its default), and "ledger_off", the same with
    kv_ledger=False; in turns (lockstep, default, ledger_off, ledger_off,
    default, lockstep) `rounds` times after a warm-up run of each, each
    turn from a cleared prefix cache after 1.1 s idle, logging each
    turn's median scheduler step (host wall ms on its thread) and its
    ledger sweeps; then one profiled turn of lockstep and default for
    the device's busy share, and each path's device operations per
    decode token (its decode program's body), and an on-demand audit of
    the default engine (clean).  Returns the turns, each path's medians
    and the operations the default engine's k = 8 program dispatches
    (_dispatched_ops)."""
    from dynamo_tpu_torch.engine import TorchEngine

    cfg = _engine_config("bf16")
    engines = {
        "lockstep": TorchEngine(dataclasses.replace(
            cfg, overlap_scheduling=False, decode_fused_steps=1),
            params=params, device=device, cuda_graphs=False),
        "default": TorchEngine(dataclasses.replace(cfg), params=params,
                               device=device),
        "ledger_off": TorchEngine(dataclasses.replace(cfg, kv_ledger=False),
                                  params=params, device=device)}
    if engines["default"].kv_ledger is None \
            or engines["ledger_off"].kv_ledger is not None:
        raise SystemExit("decode A/B: the KV ledger is not on by default "
                         "or not off when asked")
    reqs = _requests(cfg.resolve_model().vocab_size)
    for eng in engines.values():
        eng.warmup_decode()
    ks = {"lockstep": 1, "default": 8, "ledger_off": 8}
    ops = {p: _body_ops(engines[p], ks[p]) for p in ("lockstep", "default")}
    ops["ledger_off"] = ops["default"]  # the same programs: no host hook
    # what the LoRA phase's bank-less engine must dispatch at this depth
    dispatched = _dispatched_ops(engines["default"], 8)
    step_s = {p: [] for p in engines}
    audit_s = {p: [] for p in engines}
    for path, eng in engines.items():
        _time_steps(eng, step_s[path], audit_s[path])
    gc.collect()

    async def run():
        turns, prof = [], {}
        try:
            for eng in engines.values():  # warm-up
                await _serve(eng, reqs)
                await eng.clear_kv_blocks()
            await asyncio.sleep(1.1)
            for path in ["lockstep", "default", "ledger_off", "ledger_off",
                         "default", "lockstep"] * rounds:
                eng = engines[path]
                n0, a0 = len(step_s[path]), len(audit_s[path])
                w0 = time.monotonic()
                res = await _serve(eng, reqs)
                w1 = time.monotonic()
                mine, sweeps = step_s[path][n0:], audit_s[path][a0:]
                await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
                bad = [i for i, r in enumerate(res)
                       if r[1] != "length" or len(r[0]) != 32]
                if bad:
                    raise SystemExit(f"decode A/B {path}: requests {bad} "
                                     "did not finish with 32 tokens")
                turns.append(_decode_ab_record(
                    path, res, [r for r in eng.fpm if w0 <= r["t"] <= w1]))
                turns[-1].update(
                    step_host_ms=round(float(np.median(mine)) * 1e3, 3),
                    steps=len(mine), ledger_sweeps=len(sweeps),
                    ledger_sweep_ms=round(sum(sweeps) * 1e3, 3))
                turns[-1]["streams"] = [r[0] for r in res]
                log(f"decode A/B turn {len(turns)}: "
                    f"{ {k: v for k, v in turns[-1].items() if k != 'streams'} }")
            for path in ("lockstep", "default"):
                eng = engines[path]
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
            await _audit_clean(engines["default"], "decode A/B, default")
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
    for path in engines:
        mine = [t for t in turns if t["path"] == path]
        med = {key: float(np.median([t[key] for t in mine]))
               for key in ("decode_tok_s", "gap_ms_per_burst",
                           "gap_ms_per_token", "step_host_ms")}
        med["ttft_s"] = [float(np.median([t["ttft_s"][i] for t in mine]))
                         for i in range(len(reqs))]
        med["ledger_sweep_ms_per_turn"] = float(np.median(
            [t["ledger_sweep_ms"] for t in mine]))
        seen, tokens = prof.get(path, (None, 0))
        med["busy_share"] = seen["busy_share"] if seen else None
        med["device_ops_per_token_served"] = (seen["device_ops"] / tokens
                                              if seen else None)
        med["device_ops_per_decode_token"] = \
            ops[path] / (ks[path] * cfg.max_num_seqs)
        summary[path] = med
        log(f"decode A/B, {path}, median of {len(mine)} turns ({card}): "
            f"{med}")
    on, off = summary["default"], summary["ledger_off"]
    log(f"decode A/B: default over lockstep decode tokens/s "
        f"{on['decode_tok_s'] / summary['lockstep']['decode_tok_s']:.2f}x; "
        f"the KV ledger's cost ({card}): decode tokens/s with it "
        f"{on['decode_tok_s']:.2f} against {off['decode_tok_s']:.2f} "
        f"without ({on['decode_tok_s'] / off['decode_tok_s']:.4f}x), "
        f"median scheduler step {on['step_host_ms']:.3f} against "
        f"{off['step_host_ms']:.3f} ms host wall, its sweeps "
        f"{on['ledger_sweep_ms_per_turn']:.3f} ms a turn; greedy streams "
        f"equal across every turn of every path")
    for t in turns:
        del t["streams"]
    return {"turns": turns, "median": summary,
            "dispatched_ops_k8": dispatched}


def seam_ab(device, card: str, params, rounds: int = 3) -> dict:
    """What the chaos seams cost with no plane installed: the five
    requests through one default engine (bf16 cache, graphs captured by
    warm-up) in turns of "seam", the engine as it is (each scheduler
    step calls chaos.hit, whose body is one module-global None check;
    the allocator's seams are `chaos.active() is not None` checks), and
    "stub", the same engine with engine/core.py's and
    engine/block_allocator.py's `chaos` swapped for a stand-in whose
    `hit` and `active` return None at once (what the step loop cost
    before the seams, up to one call each); in turns (stub, seam, seam,
    stub) `rounds` times after a warm-up run, each turn from a cleared
    prefix cache after 1.1 s idle.  Logs each arm's decode tokens/s
    (median, min and max) and exits unless the greedy streams are equal
    in every turn."""
    import types

    from dynamo_tpu_torch import chaos
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.engine import block_allocator, core

    if chaos.active() is not None:
        raise SystemExit("seam A/B: a chaos plane is installed")
    stub = types.SimpleNamespace(hit=lambda *a, **k: None,
                                 active=lambda: None)
    cfg = _engine_config("bf16")
    eng = TorchEngine(dataclasses.replace(cfg), params=params, device=device)
    eng.warmup_decode()
    reqs = _requests(cfg.resolve_model().vocab_size)
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]

    async def run():
        rates, streams = {"stub": [], "seam": []}, []
        try:
            await _serve(eng, reqs)
            for arm in ["stub", "seam", "seam", "stub"] * rounds:
                mods = (core, block_allocator)
                for m in mods:
                    m.chaos = stub if arm == "stub" else chaos
                await eng.clear_kv_blocks()
                await asyncio.sleep(1.1)
                try:
                    res = await _serve(eng, [dataclasses.replace(
                        r, request_id=f"{r.request_id}-{arm}-{len(streams)}")
                        for r in reqs])
                finally:
                    for m in mods:
                        m.chaos = chaos
                n, secs = _decode_rate(res)
                rates[arm].append(n / secs)
                streams.append([res[i][0] for i in greedy])
        finally:
            await eng.close()
        return rates, streams

    rates, streams = asyncio.run(run())
    eng.kv = eng.graphs = eng.prefill_graphs = eng.guided_graphs = None
    gc.collect()
    torch.cuda.empty_cache()
    out = {arm: {"median": float(np.median(v)), "min": float(min(v)),
                 "max": float(max(v)), "turns": [round(x, 2) for x in v]}
           for arm, v in rates.items()}
    log(f"seam A/B ({card}), decode tokens/s with no chaos plane: "
        + "; ".join(f"{arm} median {o['median']:.2f} (min {o['min']:.2f}, "
                    f"max {o['max']:.2f}) over {len(o['turns'])} turns"
                    for arm, o in out.items())
        + f"; seam over stub {out['seam']['median'] / out['stub']['median']:.4f}x")
    if any(s != streams[0] for s in streams):
        raise SystemExit("seam A/B: greedy streams differ between turns")
    return out


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
    or replayed; for the padded programs, the uploads and the eager
    body's launches) to `into`."""
    if engine.padded_prefill is not None:
        padded = engine.padded_prefill.run

        def timed_padded(a):
            t0 = time.perf_counter()
            out = padded(a)
            into.append(time.perf_counter() - t0)
            return out

        engine.padded_prefill.run = timed_padded
        return
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


# the padded prefill's prompt-end logits against the packed one's, relative
# L2: two bf16 attention routes (plain padded against K3) read 0.0197-0.0205
# on an H100 for the five prompts, as K3 against the plain packed path does
# in the engine phase (cosine 0.99979, relative L2 0.020); 1.5x that
PADDED_LOGIT_TOL = 3e-2


def _padded_logits(params, mc, device, reqs) -> dict:
    """Each request's prompt-end logits through the packed program's
    model function (`prefill_packed`, K3) and the padded one's
    (`prefill`, one sequence padded to its bucket), each on a fresh
    cache: {request id: (relative L2 of padded against packed, the
    packed logits' top-2 gap, top tokens equal)}."""
    from dynamo_tpu_torch.models import llama

    out = {}
    bs, nb = 128, 16

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    for r in reqs:
        L = len(r.token_ids)
        T = next(b for b in (32, 64, 128, 256, 512, 1024, 2048) if b >= L)
        table = [1 + i for i in range(-(-L // bs))]
        table += [0] * (nb - len(table))
        toks = r.token_ids + [0] * (T - L)
        res = []
        for packed in (True, False):
            kv = tuple(torch.zeros(s_, dtype=mc.dtype, device=device)
                       for s_ in llama.kv_cache_shapes(mc, nb + 1, bs))
            if packed:
                lg, _ = llama.prefill_packed(
                    params, mc, kv, i32(toks), i32(list(range(L))
                                                   + [0] * (T - L)),
                    i32([0] * T), i32([table]), i32([L - 1]),
                    torch.arange(T, device=device) < L)
                res.append(lg[0].float())
            else:
                lg, _ = llama.prefill(params, mc, kv, i32(toks),
                                      i32(list(range(T))), i32(table), 0, L)
                res.append(lg.reshape(-1).float())
        a, b = res
        top2 = torch.topk(a, 2).values
        out[r.request_id] = (
            ((b - a).norm() / a.norm()).item(),
            (top2[0] - top2[1]).item(), int(a.argmax()) == int(b.argmax()))
    return out


def _first_parting(params, mc, device, reqs, packed, padded,
                   logits: dict) -> dict:
    """For each greedy request whose padded stream parts from the packed
    one: (the first token index where they differ, the packed path's
    top-2 logit gap there: the prompt-end logits' at index 0, else
    recomputed teacher-forced by _replay_gap)."""
    out = {}
    for i, r in enumerate(reqs):
        if r.sampling.temperature > 0 or packed[i] == padded[i]:
            continue
        j = next(k for k, (x, y) in enumerate(zip(packed[i], padded[i]))
                 if x != y)
        gap = (logits[r.request_id][1] if j == 0 else
               _replay_gap(params, mc, device, r.token_ids, packed[i], j)[0])
        out[r.request_id] = (j, gap)
    return out


def prefill_ab(device, card: str, params, rounds: int = 2) -> dict:
    """The five requests at llama-8b width on a bf16 cache, served in one
    process by three default engines with the same weights and their own
    caches: "eager" (packed prefill dispatched layer by layer from the
    host, TorchEngine(prefill_graphs=False); decode on graphs), "graph"
    (one captured program per bucket) and "padded" (prefill_packed=False:
    the padded programs, `prefill` for one prompt and `prefill_batched`
    for several, eager; decode on graphs), in turns (eager, graph,
    padded, padded, graph, eager) `rounds` times after a warm-up run of
    each, each turn from a cleared prefix cache after 1.1 s idle.  Logs
    per turn TTFT per request, the time from the run's start to its
    first prefill record (FPM), the median host time to dispatch one
    prefill and decode tokens/s, and device operations per prefill
    token.  Exits unless the graph engine's warm-up built every bucket
    once and serving none, the eager engine captured nothing, the padded
    engine's warm-up ran every padded shape and serving no other, every
    stream of the packed paths is equal across turns and paths (the
    replays are bit-equal to the eager bodies), the padded path's
    streams are equal across its turns, and each prompt's padded
    prompt-end logits are within PADDED_LOGIT_TOL of the packed ones;
    logs where the padded path's greedy streams first part from the
    packed ones, with the packed path's top-2 gap there."""
    from dynamo_tpu_torch.engine import TorchEngine

    cfg = _engine_config("bf16")
    engines = {"eager": TorchEngine(dataclasses.replace(cfg), params=params,
                                    device=device, prefill_graphs=False),
               "graph": TorchEngine(dataclasses.replace(cfg), params=params,
                                    device=device),
               "padded": TorchEngine(dataclasses.replace(
                   cfg, prefill_packed=False), params=params,
                   device=device)}
    if engines["padded"].padded_prefill is None:
        raise SystemExit("prefill A/B: prefill_packed=False kept the "
                         "packed programs")
    for path, eng in engines.items():
        t0 = time.perf_counter()
        eng.warmup_decode()
        log(f"prefill A/B, {path}: warm-up in {time.perf_counter() - t0:.1f}"
            " s")
    built = _log_prefill_programs(engines["graph"], "prefill A/B, graph")
    if engines["eager"].prefill_graphs.capture_s:
        raise SystemExit("prefill A/B: the eager engine captured a program")
    padded_built = dict(engines["padded"].padded_prefill.counts)
    log(f"prefill A/B, padded: warm-up ran {len(padded_built)} padded "
        f"shapes (rows, bucket) {sorted(padded_built)}")
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
            for path in ["eager", "graph", "padded", "padded", "graph",
                         "eager"] * rounds:
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
    if engines["padded"].padded_prefill.counts != padded_built:
        raise SystemExit(f"prefill A/B: serving ran new padded shapes: "
                         f"{engines['padded'].padded_prefill.counts}")
    ref = turns[0]["streams"]
    if any(t["streams"] != ref for t in turns if t["path"] != "padded"):
        raise SystemExit("prefill A/B: streams differ between turns or "
                         "packed paths")
    pads = [t["streams"] for t in turns if t["path"] == "padded"]
    if any(p != pads[0] for p in pads):
        raise SystemExit("prefill A/B: the padded path's streams differ "
                         "between its turns")
    mc = engines["graph"].model_cfg
    logits = _padded_logits(params, mc, device, reqs)
    parted = _first_parting(params, mc, device, reqs, ref, pads[0], logits)
    worst = max(v[0] for v in logits.values())
    log(f"prefill A/B, padded against packed prompt-end logits ({card}): "
        f"relative L2 by request {[round(v[0], 6) for v in logits.values()]}"
        f" (max {worst:.6f}, tolerance {PADDED_LOGIT_TOL}), packed top-2 "
        f"gaps {[round(v[1], 4) for v in logits.values()]}, top tokens "
        f"equal {[v[2] for v in logits.values()]}; greedy streams part "
        f"(request: first index, packed top-2 gap there) {parted or 'nowhere'}")
    if worst > PADDED_LOGIT_TOL:
        raise SystemExit("prefill A/B: the padded prefill's logits are off "
                         "the packed ones")
    summary = {}
    for path in engines:
        mine = [t for t in turns if t["path"] == path]
        med = {key: float(np.median([t[key] for t in mine]))
               for key in ("first_prefill_ms", "dispatch_host_ms",
                           "decode_tok_s")}
        med["ttft_s"] = [float(np.median([t["ttft_s"][i] for t in mine]))
                         for i in range(len(reqs))]
        # the packed bucket program's body (the padded path's not counted)
        med["device_ops_per_prefill_token"] = (ops if path != "padded"
                                               else None)
        summary[path] = med
        log(f"prefill A/B, {path}, median of {len(mine)} turns ({card}): "
            f"{med}")
    log(f"prefill A/B: padded against graph, first prefill record "
        f"{summary['padded']['first_prefill_ms']:.2f} against "
        f"{summary['graph']['first_prefill_ms']:.2f} ms, host time a "
        f"dispatch {summary['padded']['dispatch_host_ms']:.3f} against "
        f"{summary['graph']['dispatch_host_ms']:.3f} ms, ttft s "
        f"{summary['padded']['ttft_s']} against {summary['graph']['ttft_s']}")
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
    return {"turns": turns, "median": summary,
            "padded_logits": logits, "padded_parted": parted}


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


def _aggregated_reference(device, cfg, params, reqs, warmup: bool,
                          extra=()) -> tuple:
    """The requests through an aggregated TorchEngine (`cfg`, weights
    `params`): one at a time (the reference streams; the `extra` requests
    after them, their results appended), then, after a cleared prefix
    cache, `reqs` all at once (the TTFT yardstick).  Frees its cache
    before returning."""
    from dynamo_tpu_torch.engine import TorchEngine

    eng = TorchEngine(dataclasses.replace(cfg), params=params, device=device)
    if warmup:
        eng.warmup_decode()

    async def run():
        try:
            one = [(await _serve(eng, [r]))[0] for r in [*reqs, *extra]]
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
    _engine_disagg_roundtrip does, then behind the port's frontend
    (_disagg_frontend).  For each tier, the broker (device-resident chunks) and
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
    worker's, decode worker's)}, "frontend_launches": the same of the
    frontend's always-disagg run, ...}."""
    cfg = _engine_config("bf16")
    mc = cfg.resolve_model()
    reqs = _requests(mc.vocab_size)
    bs = cfg.block_size
    # the five prompts as text, as the frontend preprocesses them
    text_reqs = _text_requests(cfg)
    t0 = time.perf_counter()
    ref_one, ref_conc = _aggregated_reference(device, cfg, params, reqs,
                                              warmup=True, extra=text_reqs)
    ref_one, ref_text = ref_one[:len(reqs)], ref_one[len(reqs):]
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
            # first tokens the decode worker recomputed in the tiers' runs
            # (the frontend's conditional run prefills there on purpose)
            result["recomputes"] = len(replays)
            # the same pair behind the port's frontend (runs a and b)
            result["frontend"] = await _disagg_frontend(
                pw, dw, pclient, dclient, text_reqs, k1, k3)
            # the pair as the disagg pool behind the global router
            result["grouter"] = await _grouter_short(pw, dw, (k1, k3))
            # disagg.pull.chunk: a retried pull, then the local fallback
            result["pull_chaos"] = await _disagg_pull_chaos(
                pw, dw, pclient, dclient, reqs[1])
            for w, built, g in ((pw, pbuilt, pw.engine.prefill_graphs),
                                (dw, dbuilt, dw.engine.graphs)):
                if g.counts != built:
                    raise SystemExit(f"disagg: serving built programs: "
                                     f"{g.counts} after warm-up {built}")
            # every park released, every pulled slot finished: both
            # workers' books reconcile
            for w, role in ((pw, "prefill"), (dw, "decode")):
                await _audit_clean(w.engine, f"disagg {role} worker")
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
    pc = result["pull_chaos"]
    for what in ("retry", "fallback"):
        e = pc[what]
        if e["finish"] != "length" or len(e["tokens"]) != 32:
            raise SystemExit(f"disagg pull chaos ({what}): {e}")
        e["parted"] = _check_streams(f"disagg pull chaos ({what})",
                                     [(e["tokens"],)], [ref_one[1]],
                                     [reqs[1]], params, mc, device)
    log(f"disagg pull chaos ({card}): one failed chunk op absorbed by the "
        f"retry ({pc['retry']['fired']} injection, decode worker prefill "
        f"tokens {pc['retry']['prefill_tokens']}); a persistent failure "
        f"({pc['fallback']['fired']} injections) fell back to local "
        f"prefill ({pc['fallback']['prefill_tokens']} tokens); both "
        f"streams equal the aggregated engine's (partings "
        f"{pc['retry']['parted'] + pc['fallback']['parted']}); "
        f"{pc['seconds']:.2f} s")
    if pc["retry"]["fired"] != 1 or pc["retry"]["prefill_tokens"] \
            or pc["fallback"]["fired"] < 3 \
            or pc["fallback"]["prefill_tokens"] <= 0:
        raise SystemExit("disagg pull chaos: the retry prefilled, or the "
                         "persistent failure did not fall back to local "
                         "prefill")
    out["pull_chaos"] = {w: {k: pc[w][k] for k in ("fired",
                                                   "prefill_tokens")}
                         for w in ("retry", "fallback")}
    out["frontend_launches"] = _check_disagg_frontend(
        result["frontend"], text_reqs, ref_text, params, mc, device, card)
    out["grouter"] = result["grouter"]
    out["launches"].update(check_disagg_int8(device, card, params))
    return out


def _text_requests(cfg, name: str = "smoke") -> list:
    """The five frontend prompts (_frontend_texts) as the port's
    preprocessor makes them from _frontend_body's completions, with the
    card a worker of config `cfg` publishes (its mock tokenizer):
    request ids fd-0 .. fd-4."""
    from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.protocols import ModelDeploymentCard

    mc = cfg.resolve_model()
    pre = OpenAIPreprocessor(ModelDeploymentCard(
        name=name, tokenizer={"type": "mock", "vocab_size": mc.vocab_size},
        context_length=min(mc.max_context, cfg.max_context)))
    return [pre.preprocess_completion(_frontend_body(
        name, t, f"fd-{i}", sampled=(i == 2)))
        for i, t in enumerate(_frontend_texts())]


DISAGG_MIN_ISL = 1024
DISAGG_RATIO = 0.7


async def _disagg_frontend(pw, dw, pclient, dclient, text_reqs, k1,
                           k3) -> dict:
    """The disagg pair behind the port's frontend on its runtime (kv
    router), after a by-hand pass of the five text requests one at a time
    (_disagg_one) from cleared caches, K1/K3 counted around it.  Run (a),
    always-disagg: the five as streamed /v1/completions one at a time
    from cleared caches, counted the same way.  Run (b), conditional
    (DISAGG_MIN_ISL, DISAGG_RATIO, as `--disagg-min-isl 1024
    --disagg-ratio 0.7`): from cleared caches, request 1 alone until its
    pulled blocks are in the router's index, then the other four at once,
    each orchestrator decision recorded as (isl, overlap, remote).
    Returns the raw readings for _check_disagg_frontend."""
    from dynamo_tpu_torch.disagg.prefill_router import ConditionalDisaggConfig

    def metric_deltas(m0, p0):
        return ({k: dw.engine.metrics.get(k, 0) - m0.get(k, 0)
                 for k in ("prefill_tokens", "prefill_steps",
                           "decode_steps", "pull_blocks")},
                {k: pw.engine.metrics.get(k, 0) - p0.get(k, 0)
                 for k in ("prefill_tokens", "prefill_steps",
                           "decode_steps")})

    async def cleared(fe=None):
        for w in (pw, dw):
            await w.engine.clear_kv_blocks()
        if fe is not None:
            await fe.wait_blocks(dw.served.instance_id, 0,
                                 "a cleared decode worker")
        await asyncio.sleep(1.1)

    out = {"k1": k1.__name__, "k3": k3.__name__}
    await cleared()
    m0, p0 = dict(dw.engine.metrics), dict(pw.engine.metrics)
    for fn in (k1, k3):
        fn.launches = 0
    hand = []
    for r in text_reqs:
        hand.append(await _disagg_one(pclient, dclient, r,
                                      time.perf_counter()))
    out["hand_launches"] = {fn.__name__: fn.launches for fn in (k1, k3)}
    out["hand"], out["hand_steps"] = hand, metric_deltas(m0, p0)
    fe = await _Frontend.attach(pw.runtime, prefill=True,
                                disagg_config=ConditionalDisaggConfig(
                                    always_remote=True))
    spied: dict = {}
    _spy_streams(dw.engine, spied)
    orch = fe.pipeline.prefill
    decisions = {}
    decide = orch.should_disagg

    def recorded(req, overlap):
        d = decide(req, overlap)
        decisions[req.request_id] = (len(req.token_ids), overlap, d)
        return d

    orch.should_disagg = recorded
    bodies = {run: [_frontend_body(fe.model, t, f"f{run}-{i}",
                                   sampled=(i == 2))
                    for i, t in enumerate(_frontend_texts())]
              for run in ("a", "b")}
    try:
        # run (a): always remote, one at a time
        await cleared(fe)
        m0, p0 = dict(dw.engine.metrics), dict(pw.engine.metrics)
        for fn in (k1, k3):
            fn.launches = 0
        got_a = []
        for b in bodies["a"]:
            got_a.append(await fe.sse(b))
        out["a_launches"] = {fn.__name__: fn.launches for fn in (k1, k3)}
        out["a_steps"] = metric_deltas(m0, p0)
        out["a"] = got_a
        # run (b): conditional, request 1 alone first
        orch.config = ConditionalDisaggConfig(
            min_effective_isl=DISAGG_MIN_ISL,
            min_effective_ratio=DISAGG_RATIO)
        gate = len(text_reqs[0].token_ids) // dw.config.block_size
        dispatches: list = []
        dispatch = dw.engine._prefill_dispatch

        def recorded_dispatch(pslots):
            dispatches.append([(int(s.request.request_id.rsplit("-", 1)[1]),
                                s.prefill_pos) for s in pslots])
            return dispatch(pslots)

        dw.engine._prefill_dispatch = recorded_dispatch
        await cleared(fe)
        m0, p0 = dict(dw.engine.metrics), dict(pw.engine.metrics)
        got_b = [await fe.sse(bodies["b"][0])]
        await fe.wait_blocks(dw.served.instance_id, gate,
                             "request 1's pulled blocks")
        got_b += await asyncio.gather(*(fe.sse(b)
                                        for b in bodies["b"][1:]))
        out["b_steps"] = metric_deltas(m0, p0)
        out["b"] = got_b
        out["b_dispatches"] = [list(d) for d in dispatches]
        out["b_hand"], out["b_hand_dispatches"], out["b_hand_tries"] = \
            await _disagg_in_shape(pclient, dclient, fe, dw, text_reqs,
                                   gate, dispatches, cleared)
        out["decisions"] = decisions
        out["spied"] = spied
        out["pick_ms"] = [round(s * 1e3, 3) for s in fe.pick_s]
        out["indexer_impl"] = fe.router.overlap_stats()["indexer_impl"]
    finally:
        orch.should_disagg = decide
        dw.engine.__dict__.pop("generate", None)
        dw.engine.__dict__.pop("_prefill_dispatch", None)
        left = await fe.close()
    if left:
        raise SystemExit(f"disagg frontend: close() left tasks {left}")
    return out


DISAGG_SHAPE_TRIES = 3


async def _disagg_in_shape(pclient, dclient, fe, dw, text_reqs, gate: int,
                           dispatches: list, cleared) -> tuple:
    """Run (b)'s shape by hand over the request plane, the reference of its
    streams: from cleared caches, request 1 through the pair
    (_disagg_one), then, once its `gate` blocks are in the router's
    index, the other four to the decode worker alone (local prefill), in
    the groups run (b)'s packed prefill dispatches took them (recorded
    into `dispatches` as [(request index, prefill position)] a dispatch):
    each group sent once the dispatch before it has started.  Tried up
    to DISAGG_SHAPE_TRIES times, until the dispatches equal run (b)'s.
    Returns (the five token streams, the dispatches, tries)."""
    want = [list(d) for d in dispatches]
    groups, seen = [], set()
    for d in want:
        new = [i for i, _ in d if i not in seen]
        seen.update(new)
        groups.append(new)
    for attempt in range(1, DISAGG_SHAPE_TRIES + 1):
        await cleared(fe)
        dispatches.clear()
        tag = f"fh{attempt}"
        head = await _disagg_one(pclient, dclient, dataclasses.replace(
            text_reqs[0], request_id=f"{tag}-0"), time.perf_counter())
        await fe.wait_blocks(dw.served.instance_id, gate,
                             "request 1's pulled blocks (by hand)")
        tasks = {}
        for d, group in enumerate(groups):
            for i in group:
                tasks[i] = asyncio.create_task(_rp_stream(
                    dclient, dataclasses.replace(
                        text_reqs[i], request_id=f"{tag}-{i}")))
            end = time.monotonic() + FRONTEND_WAIT_S
            while len(dispatches) <= d and time.monotonic() < end:
                await asyncio.sleep(0.001)
        rest = {i: (await t)["ids"] for i, t in tasks.items()}
        got = [list(d) for d in dispatches]
        if got == want:
            break
        log(f"disagg frontend run (b) by hand, try {attempt}: prefill "
            f"dispatches {got} against run (b)'s {want}")
    ids = [head[0]] + [rest.get(i, []) for i in range(1, 5)]
    return ids, got, attempt


def _check_disagg_frontend(res: dict, text_reqs, ref_text, params, mc,
                           device, card: str) -> dict:
    """Exit unless run (a)'s streams equal the by-hand pass's and the
    aggregated engine's for the same requests (a greedy parting only at
    a near-tie), its K3 launches equal the by-hand pass's, the decode
    worker prefilled no token in either and the prefill worker decoded
    none; and unless run (b)'s decisions equal should_disagg's on the
    recorded (isl, overlap): request 1 remote, 2-4 local, 5 local on its
    8-block overlap, and its streams equal the by-hand run in its shape
    (_disagg_in_shape: the same packed prefill dispatches on the decode
    worker; a greedy parting only at a near-tie) and, greedy ones, the
    aggregated engine's one at a time (a parting only at a near-tie).
    Logs where the seeded sampled stream of each parts from the one at a
    time reference, TTFT through HTTP beside the by-hand pass's.  Returns
    {kernel: (prefill worker's launches, decode worker's)} of run (a)."""
    from dynamo_tpu_torch.disagg.prefill_router import (
        ConditionalDisaggConfig,
        PrefillOrchestrator,
    )

    hand = res["hand"]
    spied = res["spied"]
    greedy = [i for i in range(5) if i != 2]
    for run, got in (("a", res["a"]), ("b", res["b"])):
        ids = [spied.get(f"f{run}-{i}", []) for i in range(5)]
        if any(len(x) != 32 for x in ids) or any(
                (g["usage"] or {}).get("completion_tokens") != 32
                for g in got):
            raise SystemExit(f"disagg frontend run ({run}): streams of "
                             f"{[len(x) for x in ids]} tokens")
    a_ids = [spied[f"fa-{i}"] for i in range(5)]
    if a_ids[2] != ref_text[2][0] or a_ids[2] != hand[2][0]:
        raise SystemExit("disagg frontend run (a): the seeded sampled "
                         "stream differs from the aggregated engine's or "
                         "the by-hand pass's")
    res["a_parted"] = _check_streams(
        "disagg frontend run (a)", [(a_ids[i],) for i in greedy],
        [ref_text[i] for i in greedy], [text_reqs[i] for i in greedy],
        params, mc, device)
    hand_parted = _check_streams(
        "disagg frontend run (a) against the by-hand pass",
        [(a_ids[i],) for i in greedy], [hand[i] for i in greedy],
        [text_reqs[i] for i in greedy], params, mc, device)
    (dm, pm), (hdm, hpm) = res["a_steps"], res["hand_steps"]
    k1name, k3name = res["k1"], res["k3"]
    log(f"disagg frontend run (a), always-disagg ({card}): launches "
        f"{res['a_launches']} against the by-hand pass's "
        f"{res['hand_launches']}; decode worker steps {dm}, prefill worker "
        f"{pm} (by hand {hdm}, {hpm}); {len(hand_parted)} parting(s) from "
        f"the by-hand streams, {len(res['a_parted'])} from the aggregated "
        f"engine's; indexer {res['indexer_impl']}")
    if dm["prefill_tokens"] or dm["prefill_steps"] or hdm["prefill_tokens"]:
        raise SystemExit("disagg frontend run (a): the decode worker "
                         "prefilled")
    if pm["decode_steps"] or not pm["prefill_steps"]:
        raise SystemExit("disagg frontend run (a): the prefill worker "
                         "decoded, or prefilled nothing")
    if res["a_launches"][k3name] != res["hand_launches"][k3name] \
            or not res["a_launches"][k3name]:
        raise SystemExit(f"disagg frontend run (a): {k3name} launched "
                         f"{res['a_launches'][k3name]} times against the "
                         f"by-hand pass's {res['hand_launches'][k3name]}")
    if res["a_launches"][k1name] < mc.n_layers * dm["decode_steps"] \
            or not dm["decode_steps"]:
        raise SystemExit("disagg frontend run (a): the decode worker did "
                         "not run K1 on every decode step")
    ttft = [(round(g["ttft"], 4), round(h[2], 4), round(g["ttft"] - h[2], 4))
            for g, h in zip(res["a"], hand)]
    log(f"disagg frontend run (a) ({card}): TTFT s through HTTP / by hand "
        f"over the request plane / difference, per request: {ttft}; router "
        f"pick host ms {res['pick_ms']}")
    want = PrefillOrchestrator(None, ConditionalDisaggConfig(
        min_effective_isl=DISAGG_MIN_ISL, min_effective_ratio=DISAGG_RATIO))
    got = [res["decisions"].get(f"fb-{i}") for i in range(5)]
    expect = [want.should_disagg(text_reqs[i], g[1]) if g else None
              for i, g in enumerate(got)]
    shared = FRONTEND_SHARED
    log(f"disagg frontend run (b), conditional (min isl {DISAGG_MIN_ISL}, "
        f"ratio {DISAGG_RATIO}) ({card}): (isl, overlap from the router's "
        f"index, remote) per request {got}; should_disagg gives {expect}; "
        f"decode worker steps {res['b_steps'][0]}, prefill worker "
        f"{res['b_steps'][1]}")
    if None in got or [g[2] for g in got] != expect \
            or expect != [True, False, False, False, False] \
            or got[4][1] != shared:
        raise SystemExit("disagg frontend run (b): the decisions differ "
                         "from should_disagg's, or request 5 was not kept "
                         f"local on its {shared}-token overlap")
    # run (b)'s streams: against the by-hand run in its shape, and the
    # greedy ones against the aggregated engine one at a time
    b_ids, b_hand = [spied[f"fb-{i}"] for i in range(5)], res["b_hand"]
    log(f"disagg frontend run (b) ({card}): decode worker prefill "
        f"dispatches [(request, prefill position)] {res['b_dispatches']}; "
        f"by hand in its shape {res['b_hand_dispatches']} (try "
        f"{res['b_hand_tries']})")
    if res["b_hand_dispatches"] != res["b_dispatches"]:
        raise SystemExit("disagg frontend run (b): the by-hand run did not "
                         "take run (b)'s prefill dispatches")

    def parts_at(x, ref) -> Optional[int]:
        return None if x == ref else next(
            (n for n, (a, b) in enumerate(zip(x, ref)) if a != b),
            min(len(x), len(ref)))

    one = ref_text[2][0]
    log(f"disagg frontend run (b) ({card}): the seeded sampled stream parts "
        f"from the aggregated engine's one at a time at token "
        f"{parts_at(b_ids[2], one)} (None: equal); the by-hand run in its "
        f"shape at {parts_at(b_hand[2], one)}; run (b) from the by-hand "
        f"run at {parts_at(b_ids[2], b_hand[2])}")
    if b_ids[2] != b_hand[2]:
        raise SystemExit("disagg frontend run (b): the seeded sampled "
                         "stream differs from the by-hand run's in its "
                         "shape")
    res["b_parted_hand"] = _check_streams(
        "disagg frontend run (b) against the by-hand run in its shape",
        [(b_ids[i],) for i in greedy], [(b_hand[i],) for i in greedy],
        [text_reqs[i] for i in greedy], params, mc, device)
    res["b_parted"] = _check_streams(
        "disagg frontend run (b)", [(b_ids[i],) for i in greedy],
        [ref_text[i] for i in greedy], [text_reqs[i] for i in greedy],
        params, mc, device)
    return {k1name: (0, res["a_launches"][k1name]),
            k3name: (res["a_launches"][k3name], 0)}


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
            await _audit_clean(dw.engine, "disagg ipc decode worker")
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
            await _audit_clean(eng, what)
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
    # the ledger's per-tier onboard marks against the engine's onboard
    # counters and the KVBM manager's fetch hits
    led = eng.kv_ledger.onboard_counts()
    mine = {t: eng.metrics[f"kv_onboard_{t}"] for t in ("g2", "g3", "g4")
            if eng.metrics.get(f"kv_onboard_{t}")}
    hits = eng.kvbm.stats["onboarded"] if g2 is not None else 0
    log(f"{what}: KV ledger onboards by tier {led}, engine counters "
        f"{mine}, KVBM fetch hits {hits}")
    if led != mine or sum(led.values()) != hits:
        raise SystemExit(f"{what}: the ledger's onboard counts differ from "
                         "the KVBM stats")
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
            for i, w in enumerate(workers):
                await _audit_clean(w.engine, f"kvbm remote W{i + 1}")
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
# the MoE family at mixtral-8x7b width (--moe; before the tp phase)
# ---------------------------------------------------------------------------

# mixtral-8x7b's 32 layers hold 93.4 GB of bf16 weights, more than the
# card's 80 GB; 16 layers held 46.97 GB with the embedding and lm_head;
# 4 keep the whole check, with the tp phase after it, inside its 1200 s
MOE_LAYERS = 4
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

# deepseek-v2-lite's depth in the whole check (--mla: all 27)
MLA_LAYERS = 8
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


def check_mla(device, card: str, n_layers: Optional[int] = None) -> dict:
    """The MLA phase (module docstring), deepseek-v2-lite `n_layers` deep
    (None: all 27).  Returns {"launches": K1/K3's
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
    if n_layers is not None:
        mc = dataclasses.replace(mc, n_layers=n_layers)
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
    log(f"MLA: deepseek-v2-lite at its published widths, {mc.n_layers} of "
        f"27 layers (d={mc.d_model}, {mc.n_heads} heads, "
        f"kv_lora_rank {mc.kv_lora_rank}, qk_nope {mc.qk_nope_head_dim}, "
        f"qk_rope {mc.qk_rope_head_dim}, v_head {mc.v_head_dim}, first "
        f"{mc.first_k_dense} dense (ffn {mc.ffn_dim}), {mc.n_experts} routed "
        f"experts top {mc.experts_per_token} (ffn {mc.moe_ffn_dim}) plus "
        f"{mc.n_shared_experts} shared, vocab {mc.vocab_size}): "
        f"{sum(t.numel() for t in leaves) / 1e9:.2f} B parameters, "
        f"{nbytes / 1e9:.2f} GB of random bf16 weights made on the card in "
        f"{time.perf_counter() - t0:.1f} s; bf16 cache bytes a token "
        f"{per_tok['deepseek-v2-lite']} at {mc.n_layers} layers (llama-8b "
        f"{per_tok['llama-8b']} at 32)")
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


# ---------------------------------------------------------------------------
# discovery through etcd and the Kubernetes API (standard-library fakes)
# ---------------------------------------------------------------------------


class _FakeHttp:
    """An HTTP/1.1 server on asyncio streams for the discovery fakes (the
    card's machine has no aiohttp): one request per connection.
    `route(method, path, params, body, headers)` returns (status, JSON
    body), or an asyncio.Queue for a watch, whose items it writes as
    newline-terminated JSON in chunked transfer coding until the client
    goes, a None item arrives or the server closes."""

    def __init__(self):
        self._server = None
        self._watches: set = set()
        self.endpoint = ""

    async def start(self):
        self._server = await asyncio.start_server(self._handle, "127.0.0.1",
                                                  0)
        port = self._server.sockets[0].getsockname()[1]
        self.endpoint = f"http://127.0.0.1:{port}"
        return self

    async def close(self) -> None:
        for q in list(self._watches):
            q.put_nowait(None)
        self._server.close()
        await self._server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        from urllib.parse import parse_qsl

        try:
            head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
            lines = head.split("\r\n")
            method, target, _ = lines[0].split(" ", 2)
            headers = {}
            for line in lines[1:]:
                name, sep, value = line.partition(":")
                if sep:
                    headers[name.strip().lower()] = value.strip()
            n = int(headers.get("content-length", "0"))
            body = json.loads(await reader.readexactly(n)) if n else None
            path, _, query = target.partition("?")
            out = self.route(method, path, dict(parse_qsl(query)), body,
                             headers)
            if isinstance(out, asyncio.Queue):
                await self._stream(reader, writer, out)
                return
            status, obj = out
            data = json.dumps(obj).encode()
            writer.write(f"HTTP/1.1 {status} X\r\nContent-Type: "
                         f"application/json\r\nContent-Length: {len(data)}"
                         "\r\nConnection: close\r\n\r\n".encode() + data)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _stream(self, reader, writer, q: asyncio.Queue) -> None:
        self._watches.add(q)
        gone = asyncio.ensure_future(reader.read(1))  # the client's EOF
        try:
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                         b"\r\nTransfer-Encoding: chunked\r\n\r\n")
            while True:
                get = asyncio.ensure_future(q.get())
                await asyncio.wait({get, gone},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not get.done():
                    get.cancel()
                    return
                item = get.result()
                if item is None:
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
                data = json.dumps(item).encode() + b"\n"
                writer.write(b"%x\r\n%s\r\n" % (len(data), data))
                await writer.drain()
        finally:
            gone.cancel()
            self._watches.discard(q)
            self.unwatch(q)

    def route(self, method, path, params, body, headers):
        raise NotImplementedError

    def unwatch(self, q: asyncio.Queue) -> None:
        pass


class FakeEtcdGateway(_FakeHttp):
    """The etcd v3 JSON gateway's subset the discovery backend speaks
    (lease grant/keepalive/revoke with TTL expiry, kv put/range/
    deleterange, streaming watch from a start revision), with etcd's
    conventions: base64 keys and values, a revision counter, PUT events
    without a type, DELETE events for deletes and for the keys of an
    expired or revoked lease."""

    def __init__(self):
        super().__init__()
        self.kv: dict = {}       # key bytes -> (value bytes, lease id)
        self.leases: dict = {}   # lease id -> (ttl s, deadline)
        self.revision = 1
        # (revision, key, event): a watch from start_revision replays
        # what it missed, as etcd does
        self.history: list = []
        self._next_lease = 1000
        self._watchers: list = []  # (start, end, queue)
        self._expiry = None

    async def start(self):
        await super().start()
        self._expiry = asyncio.create_task(self._expiry_loop())
        return self

    async def close(self) -> None:
        self._expiry.cancel()
        await asyncio.gather(self._expiry, return_exceptions=True)
        await super().close()

    async def _expiry_loop(self) -> None:
        while True:
            await asyncio.sleep(0.1)
            now = time.monotonic()
            for lid, (_, deadline) in list(self.leases.items()):
                if now > deadline:
                    self._drop_lease(lid)

    @staticmethod
    def _b64(b: bytes) -> str:
        return base64.b64encode(b).decode()

    @staticmethod
    def _unb64(s: str) -> bytes:
        return base64.b64decode(s)

    def _notify(self, kind: str, key: bytes, value: bytes = b"") -> None:
        self.revision += 1
        ev = {"kv": {"key": self._b64(key),
                     "mod_revision": str(self.revision)}}
        if kind == "DELETE":
            ev["type"] = "DELETE"
        else:
            ev["kv"]["value"] = self._b64(value)
        self.history.append((self.revision, key, ev))
        for start, end, q in list(self._watchers):
            if start <= key < end:
                q.put_nowait({"result": {"events": [ev]}})

    def _drop_lease(self, lid: int) -> None:
        self.leases.pop(lid, None)
        for key, (_, owner) in list(self.kv.items()):
            if owner == lid:
                del self.kv[key]
                self._notify("DELETE", key)

    def _select(self, body: dict) -> list:
        key = self._unb64(body["key"])
        if body.get("range_end"):
            end = self._unb64(body["range_end"])
            return sorted(k for k in self.kv if key <= k < end)
        return [k for k in self.kv if k == key]

    def route(self, method, path, params, body, headers):
        body = body or {}
        if path == "/v3/lease/grant":
            ttl = float(body.get("TTL", 5))
            self._next_lease += 1
            self.leases[self._next_lease] = (ttl, time.monotonic() + ttl)
            return 200, {"ID": str(self._next_lease), "TTL": str(int(ttl))}
        if path == "/v3/lease/keepalive":
            lid = int(body.get("ID") or 0)
            if lid not in self.leases:
                return 200, {"result": {"ID": str(lid), "TTL": "0"}}
            ttl = self.leases[lid][0]
            self.leases[lid] = (ttl, time.monotonic() + ttl)
            return 200, {"result": {"ID": str(lid), "TTL": str(int(ttl))}}
        if path == "/v3/lease/revoke":
            self._drop_lease(int(body.get("ID") or 0))
            return 200, {}
        if path == "/v3/kv/put":
            key = self._unb64(body["key"])
            value = self._unb64(body.get("value", ""))
            lid = int(body["lease"]) if body.get("lease") else None
            if lid is not None and lid not in self.leases:
                return 400, {"error": "lease not found", "code": 5}
            self.kv[key] = (value, lid)
            self._notify("PUT", key, value)
            return 200, {"header": {"revision": str(self.revision)}}
        if path == "/v3/kv/range":
            keys = self._select(body)
            return 200, {"header": {"revision": str(self.revision)},
                         "kvs": [{"key": self._b64(k),
                                  "value": self._b64(self.kv[k][0])}
                                 for k in keys],
                         "count": str(len(keys))}
        if path == "/v3/kv/deleterange":
            keys = self._select(body)
            for k in keys:
                del self.kv[k]
                self._notify("DELETE", k)
            return 200, {"header": {"revision": str(self.revision)},
                         "deleted": str(len(keys))}
        if path == "/v3/watch":
            cr = body.get("create_request", {})
            start = self._unb64(cr["key"])
            end = (self._unb64(cr["range_end"]) if cr.get("range_end")
                   else start + b"\0")
            q: asyncio.Queue = asyncio.Queue()
            q.put_nowait({"result": {"created": True}})
            since = int(cr.get("start_revision") or 0)
            for rev, key, ev in self.history:
                if rev >= since and start <= key < end:
                    q.put_nowait({"result": {"events": [ev]}})
            self._watchers.append((start, end, q))
            return q
        return 404, {"error": f"no route {method} {path}"}

    def unwatch(self, q: asyncio.Queue) -> None:
        self._watchers = [w for w in self._watchers if w[2] is not q]


K8S_TOKEN = "chip-smoke-k8s-token"
K8S_NAMESPACE = "dynamo-smoke"


class FakeKubeApi(_FakeHttp):
    """The Kubernetes API server's Lease subset the discovery backend
    speaks (list with a label selector, watch, create with 409 on a
    duplicate, RFC 7386 merge patch, delete with 404), the
    deployments/{name}/scale subresource the planner's
    KubernetesConnector reads and merge-patches, and the graph
    operator's ConfigMap list and apps/v1 Deployment list, create (409 on
    a duplicate), get, merge patch and delete (404 on a missing one), in
    one namespace, behind a bearer token (401 without it).  The model is
    tests/fake_kube.py's FakeKubeApiServer; `calls` records the
    operator's requests as (method, path, query), and a scale write on a
    Deployment the operator created lands on its spec.replicas."""

    PREFIX = f"/apis/coordination.k8s.io/v1/namespaces/{K8S_NAMESPACE}/leases"

    def __init__(self, token: str = K8S_TOKEN):
        super().__init__()
        self.token = token
        self.leases: dict = {}  # name -> object
        # Deployments' scale subresource (the planner's
        # KubernetesConnector): name -> replicas, and each call's (method,
        # replicas patched)
        self.deployments: dict = {}
        self.scale_calls: list = []
        self.rv = 0
        # (resourceVersion, event): a watch from resourceVersion replays
        # what it missed, as the API server does
        self.history: list = []
        self._watchers: list = []
        # the graph operator's objects: name -> ConfigMap / Deployment
        self.configmaps: dict = {}
        self.apps: dict = {}
        self.calls: list = []

    def _bump(self) -> str:
        self.rv += 1
        return str(self.rv)

    def _notify(self, kind: str, obj: dict) -> None:
        ev = {"type": kind, "object": json.loads(json.dumps(obj))}
        self.history.append((self.rv, ev))
        for q in list(self._watchers):
            q.put_nowait(ev)

    @staticmethod
    def _merge(dst: dict, src: dict) -> None:
        for k, v in src.items():
            if v is None:
                dst.pop(k, None)
            elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                FakeKubeApi._merge(dst[k], v)
            else:
                dst[k] = json.loads(json.dumps(v))

    APPS = f"/apis/apps/v1/namespaces/{K8S_NAMESPACE}/deployments/"

    def _scale(self, method, name, body, headers):
        if name in self.apps:  # a Deployment the operator created
            spec = self.apps[name]["spec"]
            get = lambda: spec["replicas"]  # noqa: E731

            def put(n):
                spec["replicas"] = n
        elif name in self.deployments:
            get = lambda: self.deployments[name]  # noqa: E731

            def put(n):
                self.deployments[name] = n
        else:
            return 404, {"kind": "Status", "code": 404}
        if method == "PATCH":
            if headers.get("content-type") != "application/merge-patch+json":
                return 415, {"kind": "Status", "code": 415}
            put(int(body["spec"]["replicas"]))
            self.scale_calls.append(("PATCH", get()))
        elif method == "GET":
            self.scale_calls.append(("GET", None))
        else:
            return 405, {"kind": "Status", "code": 405}
        return 200, {"kind": "Scale", "metadata": {"name": name},
                     "spec": {"replicas": get()}}

    @staticmethod
    def _selected(obj: dict, sel: str) -> bool:
        """k=v and bare-key terms of a label selector, comma-joined."""
        labels = (obj.get("metadata") or {}).get("labels") or {}
        for term in filter(None, (t.strip() for t in sel.split(","))):
            k, eq, v = term.partition("=")
            if (labels.get(k) != v) if eq else (k not in labels):
                return False
        return True

    CONFIGMAPS = f"/api/v1/namespaces/{K8S_NAMESPACE}/configmaps"

    def _operator_route(self, method, path, params, body, headers):
        """The operator's ConfigMaps and Deployments."""
        self.calls.append((method, path, dict(params)))
        sel = params.get("labelSelector", "")
        if path == self.CONFIGMAPS and method == "GET":
            return 200, {"kind": "ConfigMapList", "items": [
                json.loads(json.dumps(o)) for o in self.configmaps.values()
                if self._selected(o, sel)]}
        name = path[len(self.APPS):].strip("/") if path.startswith(
            self.APPS) else ""
        if method == "GET" and not name:
            return 200, {"kind": "DeploymentList", "items": [
                json.loads(json.dumps(o)) for o in self.apps.values()
                if self._selected(o, sel)],
                "metadata": {"resourceVersion": str(self.rv)}}
        if method == "POST" and not name:
            name = body["metadata"]["name"]
            if name in self.apps:
                return 409, {"kind": "Status", "code": 409,
                             "reason": "AlreadyExists"}
            body["metadata"]["resourceVersion"] = self._bump()
            self.apps[name] = body
            return 201, body
        obj = self.apps.get(name)
        if obj is None:
            return 404, {"kind": "Status", "code": 404}
        if method == "GET":
            return 200, obj
        if method == "PATCH":
            if headers.get("content-type") != "application/merge-patch+json":
                return 415, {"kind": "Status", "code": 415}
            self._merge(obj, body)
            obj["metadata"]["resourceVersion"] = self._bump()
            return 200, obj
        if method == "DELETE":
            del self.apps[name]
            self._bump()
            return 200, {"kind": "Status", "status": "Success"}
        return 405, {"kind": "Status", "code": 405}

    def route(self, method, path, params, body, headers):
        if headers.get("authorization") != f"Bearer {self.token}":
            return 401, {"kind": "Status", "code": 401}
        if path.startswith(self.APPS) and path.endswith("/scale"):
            return self._scale(method, path[len(self.APPS):-len("/scale")],
                               body, headers)
        if path == self.CONFIGMAPS or path.startswith(self.APPS) \
                or path == self.APPS.rstrip("/"):
            return self._operator_route(method, path, params, body, headers)
        if not path.startswith(self.PREFIX):
            return 404, {"kind": "Status", "code": 404}
        name = path[len(self.PREFIX):].strip("/")
        if method == "GET" and not name:
            if params.get("watch") == "true":
                q: asyncio.Queue = asyncio.Queue()
                since = int(params.get("resourceVersion") or 0)
                for rv, ev in self.history:
                    if rv > since:
                        q.put_nowait(ev)
                self._watchers.append(q)
                return q
            k, _, v = params.get("labelSelector", "").partition("=")
            items = [json.loads(json.dumps(o)) for o in self.leases.values()
                     if not k or (o["metadata"].get("labels") or {}).get(k)
                     == v]
            return 200, {"kind": "LeaseList", "items": items,
                         "metadata": {"resourceVersion": str(self.rv)}}
        if method == "POST" and not name:
            name = body["metadata"]["name"]
            if name in self.leases:
                return 409, {"kind": "Status", "code": 409,
                             "reason": "AlreadyExists"}
            body["metadata"]["resourceVersion"] = self._bump()
            self.leases[name] = body
            self._notify("ADDED", body)
            return 201, body
        obj = self.leases.get(name)
        if obj is None:
            return 404, {"kind": "Status", "code": 404}
        if method == "PATCH":
            self._merge(obj, body)
            obj["metadata"]["resourceVersion"] = self._bump()
            self._notify("MODIFIED", obj)
            return 200, obj
        if method == "DELETE":
            del self.leases[name]
            self._bump()
            self._notify("DELETED", obj)
            return 200, {"kind": "Status", "status": "Success"}
        return 405, {"kind": "Status", "code": 405}

    def unwatch(self, q: asyncio.Queue) -> None:
        self._watchers = [w for w in self._watchers if w is not q]


DISCOVERY_BACKENDS = ("etcd", "kubernetes")
# lease round trips timed per backend
LEASE_RTTS = 20


@contextlib.contextmanager
def _environ(**kv):
    """os.environ with `kv` set, restored on exit."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _discovery_env(backend: str, fake) -> tuple:
    """(RuntimeConfig overrides, environment) of a runtime on `backend`
    served by `fake`, as a deployment configures one: the etcd endpoint,
    or the DYN_K8S_* variables make_discovery's KubeDiscovery reads."""
    if backend == "etcd":
        return {"discovery_backend": "etcd",
                "etcd_endpoint": fake.endpoint}, {}
    return ({"discovery_backend": "kubernetes"},
            {"DYN_K8S_API": fake.endpoint, "DYN_K8S_NAMESPACE": K8S_NAMESPACE,
             "DYN_K8S_TOKEN": K8S_TOKEN})


async def _lease_rtt_ms(disc, backend: str, key: str) -> float:
    """Median ms of LEASE_RTTS lease round trips: an etcd keepalive, or a
    Lease's renewTime merge patch."""
    times = []
    for _ in range(LEASE_RTTS):
        t0 = time.perf_counter()
        if backend == "etcd":
            await disc._call("/v3/lease/keepalive", {"ID": disc.lease_id})
        else:
            await disc._renew(key)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


async def _wait_for(pred, what: str, timeout: float = 30.0) -> None:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise SystemExit(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def check_discovery(device, cfg, params, backend: str) -> dict:
    """One request (the 500-token prompt) through a TorchEngineWorker with
    `cfg` (the int8 run's) and weights `params`, registered through
    `backend` ("etcd" or "kubernetes") against this script's fake of its
    server, configured as a deployment does (RuntimeConfig for etcd, the
    DYN_K8S_* environment for kubernetes), with the in-process event
    plane.  Exits unless a second discovery client built by
    make_discovery sees the worker's instance and MDC (put events of its
    watch, and its get_prefix), the request finishes with 32 tokens with
    the cache dtype's kernels launched at least layers x steps times, and
    the watcher sees the instance's and the MDC's deletes after the
    worker's revoke_lease.  Logs each key's registration-to-visible time
    (its put's start to the watcher's event), the revoke-to-visible
    time and the median lease round trip.  Returns the launch counts by
    kernel name and those times."""
    import uuid

    from dynamo_tpu_torch.runtime import make_discovery

    used = _kernels_of(cfg.kv_cache_dtype)
    req = _requests(cfg.resolve_model().vocab_size)[1]
    cid = uuid.uuid4().hex

    async def run():
        fake = await (FakeEtcdGateway() if backend == "etcd"
                      else FakeKubeApi()).start()
        overrides, env = _discovery_env(backend, fake)
        put_t, seen = {}, {}
        stop = asyncio.Event()

        def timed_puts(rt):
            inner = rt.discovery.put

            async def put(key, value, lease=True):
                put_t.setdefault(key, time.perf_counter())
                await inner(key, value, lease)

            rt.discovery.put = put

        try:
            with _environ(**env):
                probe = make_discovery(backend, cluster_id=cid,
                                       etcd_endpoint=fake.endpoint)

                async def watch():
                    async for ev in probe.watch("v1/", cancel=stop):
                        seen.setdefault((ev.type, ev.key),
                                        time.perf_counter())

                watcher = asyncio.create_task(watch())
                async with _serving_worker(
                        device, cfg, params, runtime=overrides,
                        cluster_id=cid, on_runtime=timed_puts) as (
                        rt, worker, client, _):
                    eng = worker.engine
                    inst = worker.served.instance.key()
                    mdc = worker.card.key(worker.served.instance_id)
                    await _wait_for(lambda: ("put", inst) in seen
                                    and ("put", mdc) in seen,
                                    f"{backend}: the watcher's puts")
                    got = await probe.get_prefix("v1/")
                    m0 = dict(eng.metrics)
                    for fn in used:
                        fn.launches = 0
                    res = await _serve_worker(client, [req])
                    counts = {fn.__name__: fn.launches for fn in used}
                    steps = {k: eng.metrics[k] - m0[k]
                             for k in ("decode_steps", "prefill_steps")}
                    rtt = await _lease_rtt_ms(rt.discovery, backend, inst)
                    t_rev = time.perf_counter()
                    await rt.discovery.revoke_lease()
                    await _wait_for(lambda: ("delete", inst) in seen
                                    and ("delete", mdc) in seen,
                                    f"{backend}: the watcher's deletes")
                stop.set()
                await watcher
                await probe.close()
        finally:
            stop.set()
            await fake.close()
        vis = [(seen[("put", k)] - put_t[k]) * 1e3 for k in (inst, mdc)]
        gone = max(seen[("delete", k)] for k in (inst, mdc)) - t_rev
        return (res[0], counts, steps, inst in got, got.get(mdc, {}), vis,
                gone * 1e3, rtt)

    ((toks, finish, ttft, _), counts, steps, inst_seen, card, vis, gone_ms,
     rtt) = asyncio.run(run())
    log(f"{backend} discovery worker ({cfg.kv_cache_dtype} cache): request "
        f"1 alone {len(toks)} out, finish={finish}, ttft={ttft:.3f} s; a "
        f"second client sees the instance: {inst_seen}, the MDC of "
        f"{card.get('name')!r}; registration to visible, ms: instance "
        f"{vis[0]:.2f}, MDC {vis[1]:.2f}; revoke_lease to both deletes "
        f"seen {gone_ms:.2f} ms; median lease round trip {rtt:.3f} ms over "
        f"{LEASE_RTTS}")
    if finish != "length" or len(toks) != 32:
        raise SystemExit(f"the {backend} worker's request did not finish "
                         "with 32 tokens")
    if not inst_seen or card.get("name") != cfg.served_name:
        raise SystemExit(f"the {backend} probe does not see the worker")
    _check_worker_launches(counts, steps, cfg.resolve_model().n_layers,
                           f"{backend} worker")
    return {"launches": counts, "visible_ms": vis, "revoke_ms": gone_ms,
            "lease_rtt_ms": rtt}


# ---------------------------------------------------------------------------
# the embed endpoint (rides the bf16 worker phase) and the encoder worker
# ---------------------------------------------------------------------------

# prompt lengths of the embed requests (buckets 64, 512 and 2048)
EMBED_LENGTHS = (37, 500, 1800)
# the planted fault (one token id changed) is gated on the shortest: a
# mean-pool over n positions moves by about 1/n when one changes
EMBED_FAULT_LEN = 37


def _tree_float(node):
    if isinstance(node, dict):
        return {k: _tree_float(v) for k, v in node.items()}
    return node.float()


class _Fp32Rows:
    """An embedding table whose looked-up rows come back fp32."""

    def __init__(self, table):
        self.table = table

    def __getitem__(self, idx):
        return self.table[idx].float()


class _Fp32Layers:
    """A layer list upcast to fp32 one layer at a time (a full fp32 copy
    of llama-8b is 32 GB)."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        for layer in self.layers:
            yield _tree_float(layer)


def _embed_fp32(params, mc, toks: list) -> torch.Tensor:
    """embed_text in fp32 on the weights' device: the bf16 weights upcast
    (exactly), fp32 activations."""
    from dynamo_tpu_torch.models import llama

    p32 = {"embedding": _Fp32Rows(params["embedding"]),
           "final_norm": params["final_norm"],
           "layers": _Fp32Layers(params["layers"])}
    t = torch.tensor(toks, dtype=torch.int32,
                     device=params["embedding"].device)
    return llama.embed_text(p32, dataclasses.replace(mc, dtype=torch.float32),
                            t, len(toks))


def _embed_bound_ms(mc, T: int) -> tuple:
    """(ms, what) the card needs at least for an embed call at bucket T:
    the larger of its bytes over 3.35 TB/s and its FLOPs (products over
    989 TFLOP/s bf16 plus the fp32 attention over 67 TFLOP/s)."""
    from dynamo_tpu_torch.obs.costs import embed_terms

    t = embed_terms(mc, T)
    flops_ms = (t["matmul_flops"] / BF16_FLOPS_PER_S
                + t["attn_flops"] / FP32_FLOPS_PER_S) * 1e3
    nbytes = sum(t[k] for k in ("weight_bytes", "kv_read_bytes",
                                "kv_write_bytes", "out_bytes"))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((flops_ms, "operations") if flops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


async def _embed_phase(rt, worker, reqs) -> dict:
    """The worker's `embed` endpoint over the request plane for
    EMBED_LENGTHS-token prompts (the smoke's prompts, cut), each twice:
    dim d_model, cosine with an fp32 computation of the same function on
    the card at least MIN_COSINE, the repeat equal, and a planted fault
    (the fp32 vector of the prompt with one token id changed) below the
    gate at EMBED_FAULT_LEN.  Then one greedy request alone, twice:
    without embeds, and with the embeds sent while it decodes; the
    streams must be equal (an embed runs between scheduler steps, on the
    engine's stream, so a burst's readback cannot be reordered).  K1/K3
    launches during the embeds are counted (plain torch: 0 expected).
    Logs ms per request (over the request plane, through engine.embed,
    and the forward alone by CUDA events) against the bound
    (_embed_bound_ms), and max_memory_allocated."""
    eng = worker.engine
    mc = eng.model_cfg
    comp = rt.namespace("dynamo").component("backend")
    client = await comp.endpoint("embed").client().start()
    gen = await comp.endpoint("generate").client().start()
    used = _kernels_of("bf16")
    prompts = {n: next(r for r in reqs if len(r.token_ids) >= n)
               .token_ids[:n] for n in EMBED_LENGTHS}
    rows = {}
    try:
        await client.wait_for_instances()

        async def embed(toks):
            t0 = time.perf_counter()
            frames = [f async for f in client.generate({"token_ids": toks})]
            return frames[0], (time.perf_counter() - t0) * 1e3

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in used:
            fn.launches = 0
        out = {}
        for n, toks in prompts.items():
            (f1, ms1), (f2, ms2) = await embed(toks), await embed(toks)
            out[n] = (f1, ms1, ms2, f2["embedding"] == f1["embedding"])
        launches = {fn.__name__: fn.launches for fn in used}
        peak = torch.cuda.max_memory_allocated()
        # where a request's time goes: the engine's embed() (the hop to
        # the scheduler thread and back, no request plane) and the forward
        # alone by CUDA events, both warm, the engine idle
        split = {}
        for n, toks in prompts.items():
            t0 = time.perf_counter()
            await eng.embed(toks)
            engine_ms = (time.perf_counter() - t0) * 1e3
            pad = torch.zeros(eng._bucket_for(n), dtype=torch.int32,
                              device=eng.device)
            pad[:n] = torch.tensor(toks, dtype=torch.int32)
            split[n] = (engine_ms, time_ms(
                lambda: eng.family.embed_text(eng.params, mc, pad, n),
                iters=3, warmup=1))
        for n, (f, ms1, ms2, same) in out.items():
            vec = torch.tensor(f["embedding"], device=eng.device)
            ref = await asyncio.to_thread(_embed_fp32, eng.params, mc,
                                          prompts[n])
            cos = float(torch.dot(vec, ref))
            fault = None
            if n == EMBED_FAULT_LEN:
                bad = list(prompts[n])
                bad[n // 2] = (bad[n // 2] + 1) % mc.vocab_size
                fault = float(torch.dot(vec, await asyncio.to_thread(
                    _embed_fp32, eng.params, mc, bad)))
            T = eng._bucket_for(n)
            bms, what = _embed_bound_ms(mc, T)
            engine_ms, device_ms = split[n]
            rows[n] = {"dim": f["dim"], "cosine": cos, "fault_cosine": fault,
                       "ms": [ms1, ms2], "engine_ms": engine_ms,
                       "device_ms": device_ms, "bucket": T, "bound_ms": bms,
                       "bound_by": what, "repeat_equal": same}
            log(f"embed {n} tokens (bucket {T}): dim {f['dim']}, cosine "
                f"with fp32 {cos:.6f} (gate {MIN_COSINE})"
                + (f", planted fault (one token id changed) {fault:.6f}"
                   if fault is not None else "")
                + f"; {ms1:.2f} / {ms2:.2f} ms a request over the request "
                f"plane (first, repeat), {engine_ms:.2f} ms through "
                f"engine.embed, {device_ms:.3f} ms the forward alone (CUDA "
                f"events), against its {bms:.3f} ms bound ({what}); repeat "
                f"equal: {same}")
        # an embed between decode bursts: one greedy request alone, then
        # again with the embeds sent while it decodes
        one = next(r for r in reqs if r.sampling.temperature <= 0)
        alone = (await _serve_worker(gen, [dataclasses.replace(
            one, request_id="smoke-embed-alone")]))[0][0]
        await eng.clear_kv_blocks()
        served, _ = await asyncio.gather(
            _serve_worker(gen, [dataclasses.replace(
                one, request_id="smoke-embed-busy")]),
            asyncio.gather(*(embed(t) for t in prompts.values())))
        interleaved = served[0][0] == alone
        log(f"embed phase: K1/K3 launches during the embeds {launches}; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB (the worker's "
            f"weights, KV cache and graph pools included); a greedy stream "
            f"with embeds sent while it decodes equals the one without: "
            f"{interleaved}")
    finally:
        await client.close()
        await gen.close()
    bad = [n for n, r in rows.items()
           if r["dim"] != mc.d_model or not r["cosine"] >= MIN_COSINE
           or not r["repeat_equal"]]
    if bad:
        raise SystemExit(f"embed requests {bad}: wrong dim, below cosine "
                         f"{MIN_COSINE} against fp32, or unrepeatable")
    if not rows[EMBED_FAULT_LEN]["fault_cosine"] < MIN_COSINE:
        raise SystemExit("embed: the planted fault passes the gate")
    if not interleaved:
        raise SystemExit("embed: a greedy stream changed with embeds "
                         "between its bursts")
    return {"rows": rows, "launches": launches, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# the port's OpenAI frontend and KV router (rides the bf16 worker phase;
# --frontend: two full-depth workers behind it)
# ---------------------------------------------------------------------------

# the five prompts as text: printable ASCII, one MockTokenizer token a
# character, at the engine phase's lengths; the fifth shares its first
# FRONTEND_SHARED characters (8 blocks of 128) with the first
FRONTEND_LENGTHS = (1800, 500, 100, 37)
FRONTEND_SHARED = 1024
FRONTEND_TAIL = 200
FRONTEND_WAIT_S = 60.0
EMBED_HTTP_COSINE = 0.9999


def _frontend_texts() -> list:
    rng = np.random.default_rng(6)

    def text(n: int) -> str:
        return "".join(chr(c) for c in rng.integers(32, 127, n))

    texts = [text(n) for n in FRONTEND_LENGTHS]
    texts.append(texts[0][:FRONTEND_SHARED] + text(FRONTEND_TAIL))
    return texts


def _frontend_body(model: str, text: str, rid: str,
                   sampled: bool = False) -> dict:
    """A streamed /v1/completions body: 32 tokens, ignore_eos, greedy or
    (`sampled`) seeded as the engine phase's third request, with the
    usage chunk, and the request id the router's decision is keyed by."""
    body = {"model": model, "prompt": text, "max_tokens": 32,
            "ignore_eos": True, "stream": True, "request_id": rid,
            "stream_options": {"include_usage": True}}
    body.update(dict(temperature=0.8, top_p=0.9, seed=1234) if sampled
                else dict(temperature=0.0))
    return body


# the code whose tasks the frontend's close() must leave none of: the
# frontend, the KV router and its replica sync, the HTTP server and client
FRONTEND_FILES = ("frontend" + os.sep, os.path.join("router", "kv_router.py"),
                  os.path.join("router", "replica_sync.py"),
                  os.path.join("runtime", "http_server.py"),
                  os.path.join("runtime", "http.py"))


class _Frontend:
    """The port's ModelWatcher (kv mode, make_kv_route_factory, and the
    watcher options `watch`: a disagg config, a session-affinity TTL) and
    HttpService on port 0, attached to a worker's runtime `rt`, with an
    HTTP client of the port (runtime/http.py) and the KV router's
    decisions by request id and pick host times recorded (`route` is the
    pipeline's route, `router` the KV router, the route itself or the one
    a SessionAffinityRouter wraps).  With `prefill` / `encoder` it waits
    for the prefill fleet's orchestrator / the encoder fleet's hop too.  While attached, a task factory
    notes every task created from FRONTEND_FILES' code (request plane
    connections excepted: the runtime pools them)."""

    @classmethod
    async def attach(cls, rt, n_instances: int = 1, prefill: bool = False,
                     encoder: bool = False, **watch) -> "_Frontend":
        from dynamo_tpu_torch.frontend.service import (
            HttpService,
            ModelManager,
            ModelWatcher,
        )
        from dynamo_tpu_torch.router.kv_router import make_kv_route_factory
        from dynamo_tpu_torch.runtime import RouterMode
        from dynamo_tpu_torch.runtime.http import HttpClient

        import traceback
        import weakref

        import dynamo_tpu_torch

        self = cls()
        pkg = os.path.dirname(os.path.abspath(dynamo_tpu_torch.__file__))
        roots = tuple(os.path.join(pkg, f) for f in FRONTEND_FILES)
        plane = os.path.join(pkg, "runtime", "request_plane.py")
        self.owned = weakref.WeakSet()
        loop = asyncio.get_running_loop()
        self.prev_factory = loop.get_task_factory()

        def factory(loop, coro, **kw):
            task = asyncio.Task(coro, loop=loop, **kw)
            code = getattr(coro, "cr_code", None)
            if (code is None or code.co_filename != plane) and any(
                    f.filename.startswith(roots)
                    for f in traceback.extract_stack(limit=40)):
                self.owned.add(task)
            return task

        loop.set_task_factory(factory)
        self.manager = ModelManager()
        self.watcher = await ModelWatcher(
            rt, self.manager, router_mode=RouterMode.KV,
            make_route=make_kv_route_factory(rt), **watch).start()
        self.service = await HttpService(rt, self.manager, host="127.0.0.1",
                                         port=0).start()
        self.http = HttpClient(f"http://127.0.0.1:{self.service.bound_port}")
        end = time.monotonic() + FRONTEND_WAIT_S
        def ready(p) -> bool:
            return len(p.client.instances) >= n_instances and (
                not prefill or (p.prefill is not None
                                and p.prefill.client.instance_ids)) and (
                not encoder or (p.encoder is not None
                                and p.encoder.client.instance_ids))

        while not (self.manager.models and ready(next(iter(
                self.manager.models.values())))):
            if time.monotonic() > end:
                raise SystemExit("frontend: the watcher never registered the "
                                 f"model with {n_instances} instance(s)")
            await asyncio.sleep(0.02)
        (self.model, self.pipeline), = self.manager.models.items()
        self.route = self.pipeline.migration.route
        self.router = getattr(self.route, "inner", None) or self.route
        self.decisions, self.pick_s = {}, []
        record, pick = self.router._record_decision, self.router.pick

        def recorded(request_id, *a, **kw):
            d = record(request_id, *a, **kw)
            self.decisions[request_id] = d
            return d

        async def timed_pick(*a, **kw):
            t = time.perf_counter()
            try:
                return await pick(*a, **kw)
            finally:
                self.pick_s.append(time.perf_counter() - t)

        self.router._record_decision = recorded
        self.router.pick = timed_pick
        log(f"frontend: model {self.model!r} behind the port's HttpService "
            f"on 127.0.0.1:{self.service.bound_port} (kv router, indexer "
            f"{self.router.overlap_stats()['indexer_impl']})")
        return self

    async def sse(self, body: dict, first: Optional[asyncio.Event] = None,
                  stop_after: Optional[int] = None) -> dict:
        return await _sse(self.http, body, first, stop_after)

    async def wait_blocks(self, iid: int, n: int, what: str) -> None:
        end = time.monotonic() + FRONTEND_WAIT_S
        while not (self.router.indexer.worker_block_count(iid) >= n if n
                   else self.router.indexer.worker_block_count(iid) == 0):
            if time.monotonic() > end:
                raise SystemExit(f"frontend: the router's index never held "
                                 f"{what}")
            await asyncio.sleep(0.01)

    async def close(self) -> list:
        """Close the service and the watcher; the frontend's tasks still
        pending after a grace of 2 s."""
        try:
            await self.http.close()
            await self.service.close()
            await self.watcher.close()
            end = time.monotonic() + 2.0
            while True:
                left = [t for t in self.owned if not t.done()]
                if not left or time.monotonic() > end:
                    return left
                await asyncio.sleep(0.02)
        finally:
            asyncio.get_running_loop().set_task_factory(self.prev_factory)


async def _sse(http, body: dict, first: Optional[asyncio.Event] = None,
               stop_after: Optional[int] = None) -> dict:
    """One streamed completion through the port's HTTP client `http`:
    its text, events, usage, and seconds from sending to the first event
    and to the last.  With `stop_after` the client drops the connection
    after that many events."""
    parts, ttft, last, usage, n = [], None, None, None, 0
    t0 = time.perf_counter()
    async with http.stream("POST", "/v1/completions", json=body,
                           read_timeout=FRONTEND_WAIT_S) as lines:
        async for line in lines:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            ev = json.loads(line[len(b"data: "):])
            if "error" in ev:
                raise SystemExit(f"frontend: {body['request_id']}: "
                                 f"{ev['error']}")
            usage = ev.get("usage") or usage
            for ch in ev["choices"]:
                now = time.perf_counter() - t0
                if ttft is None:
                    ttft = now
                    if first is not None:
                        first.set()
                last = now
                parts.append(ch["text"])
                n += 1
            if stop_after is not None and n >= stop_after:
                break
    return {"text": "".join(parts), "ttft": ttft, "last": last,
            "usage": usage, "events": n}


async def _rp_stream(client, req, first: Optional[asyncio.Event] = None,
                     instance_id: Optional[int] = None) -> dict:
    """One request over the request plane: its token ids and seconds from
    sending to the first token and to the last."""
    ids, ttft, last = [], None, None
    t0 = time.perf_counter()
    async for out in client.generate(req.to_dict(), instance_id=instance_id):
        if out.get("token_ids"):
            now = time.perf_counter() - t0
            if ttft is None:
                ttft = now
                if first is not None:
                    first.set()
            last = now
            ids.extend(out["token_ids"])
    return {"ids": ids, "ttft": ttft, "last": last}


async def _in_shape(run_one, gate) -> list:
    """The five requests, each run by `run_one(i, first_event)`: the first
    alone until its first token and `gate()` (its blocks in the router's
    index), then the other four at once."""
    first = asyncio.Event()
    head = asyncio.create_task(run_one(0, first))
    await asyncio.wait_for(first.wait(), FRONTEND_WAIT_S)
    await gate()
    rest = await asyncio.gather(*(run_one(i, None) for i in range(1, 5)))
    return [await head] + list(rest)


def _spy_streams(engine, into: dict) -> None:
    """Record every request's token ids, by request id, as `engine`
    emits them."""
    gen = engine.generate

    async def spied(request, *a, **kw):
        ids = into.setdefault(request.request_id, [])
        async for out in gen(request, *a, **kw):
            ids.extend(out.token_ids)
            yield out

    engine.generate = spied


def _render(tokenizer, ids) -> str:
    """The frontend's incremental rendering of a token stream."""
    return tokenizer.make_detokenizer().push(list(ids))


async def _sse_lines(fe, path: str, body: dict) -> list:
    """One streamed POST through the frontend: its SSE events as
    [(event name or None, data as JSON)]."""
    events, name = [], None
    async with fe.http.stream("POST", path, json=body,
                              read_timeout=FRONTEND_WAIT_S) as lines:
        async for line in lines:
            line = line.strip()
            if line.startswith(b"event: "):
                name = line[len(b"event: "):].decode()
            elif line.startswith(b"data: "):
                data = line[len(b"data: "):]
                events.append((name, data.decode() if data == b"[DONE]"
                               else json.loads(data)))
                name = None
    return events


async def _post_multipart(port: int, path: str, fields: list) -> tuple:
    """A multipart/form-data POST to 127.0.0.1:`port` (fields: (name,
    bytes, filename or None)), on a connection of its own: (status, the
    JSON body)."""
    boundary = b"smokeformboundary"
    body = b"".join(
        b"--" + boundary + b"\r\nContent-Disposition: form-data; name=\""
        + name.encode() + b"\""
        + (b"; filename=\"" + fn.encode() + b"\"" if fn else b"")
        + b"\r\n\r\n" + value + b"\r\n" for name, value, fn in fields)
    body += b"--" + boundary + b"--\r\n"
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"POST " + path.encode() + b" HTTP/1.1\r\nHost: x\r\n"
                     b"Connection: close\r\nContent-Type: multipart/"
                     b"form-data; boundary=" + boundary
                     + b"\r\nContent-Length: %d\r\n\r\n" % len(body)
                     + body)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), FRONTEND_WAIT_S)
    finally:
        writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), json.loads(data)


def _scrubbed(obj):
    """A response body with its ids and clocks taken out."""
    if isinstance(obj, dict):
        return {k: _scrubbed(v) for k, v in obj.items()
                if k not in ("id", "created", "created_at")}
    if isinstance(obj, list):
        return [_scrubbed(v) for v in obj]
    return obj


async def _extra_routes(fe, rt, pre, spied: dict, texts) -> dict:
    """The Anthropic, Responses, Files and Batches routes and
    /debug/requests through the phase's frontend: one unary and one
    streamed /v1/messages and a /v1/chat/completions of the same prompt
    (their token ids by request id from `spied`), count_tokens, a
    /v1/responses chained by previous_response_id, a multipart /v1/files
    upload of a two-line JSONL batch run through /v1/batches to
    `completed` beside the same two requests sent directly at once, and
    the frontend's forensics dump.  Returns the readings."""
    out = {}
    msg = {"model": fe.model, "max_tokens": 8, "temperature": 0.0,
           "ignore_eos": True,
           "messages": [{"role": "user", "content": texts[3]}]}

    def served_since(before) -> list:
        return [spied[k] for k in spied if k not in before]

    b = set(spied)
    out["chat"] = await fe.http.call("POST", "/v1/chat/completions", msg)
    out["chat_ids"] = served_since(b)
    b = set(spied)
    out["message"] = await fe.http.call("POST", "/v1/messages", msg)
    out["message_ids"] = served_since(b)
    b = set(spied)
    out["message_events"] = await _sse_lines(fe, "/v1/messages",
                                             dict(msg, stream=True))
    out["message_stream_ids"] = served_since(b)
    out["count_tokens"] = (await fe.http.call(
        "POST", "/v1/messages/count_tokens", msg))["input_tokens"]
    out["chat_tokens"] = len(pre.preprocess_chat(msg).token_ids)
    first = await fe.http.call("POST", "/v1/responses", {
        "model": fe.model, "input": texts[3], "max_output_tokens": 8,
        "temperature": 0.0})
    second = await fe.http.call("POST", "/v1/responses", {
        "model": fe.model, "input": "and then?", "max_output_tokens": 8,
        "temperature": 0.0, "previous_response_id": first["id"]})
    got = await fe.http.call("GET", f"/v1/responses/{second['id']}")
    out["responses"] = (first, second, got)
    lines = [{"custom_id": f"line-{i}", "method": "POST",
              "url": "/v1/chat/completions",
              "body": dict(msg, request_id=f"fe-batch-{i}", messages=[
                  {"role": "user", "content": t}])}
             for i, t in enumerate((texts[3], texts[2][:60]))]
    status, meta = await _post_multipart(
        fe.service.bound_port, "/v1/files",
        [("purpose", b"batch", None),
         ("file", ("\n".join(json.dumps(ln) for ln in lines)
                   + "\n").encode(), "smoke-batch.jsonl")])
    if status != 200:
        raise SystemExit(f"frontend: the multipart upload answered {status} "
                         f"{meta}")
    out["file"] = meta
    batch = await fe.http.call("POST", "/v1/batches", {
        "input_file_id": meta["id"], "endpoint": "/v1/chat/completions"})
    end = time.monotonic() + FRONTEND_WAIT_S
    while batch["status"] != "completed":
        if time.monotonic() > end:
            raise SystemExit(f"frontend: the batch stayed {batch['status']}")
        await asyncio.sleep(0.05)
        batch = await fe.http.call("GET", f"/v1/batches/{batch['id']}")
    out["batch"] = batch
    content = (await fe.http.request(
        "GET", f"/v1/files/{batch['output_file_id']}/content")).body
    out["batch_lines"] = {r["custom_id"]: r for r in
                          map(json.loads, content.decode().splitlines())}
    out["direct"] = await asyncio.gather(*(fe.http.call(
        "POST", "/v1/chat/completions",
        dict(ln["body"], request_id=f"fe-direct-{i}"))
        for i, ln in enumerate(lines)))
    out["batch_reqs"] = [pre.preprocess_chat(ln["body"]) for ln in lines]
    name = f"frontend:{fe.service._fleet_instance_id}"
    if rt.system_address:
        from dynamo_tpu_torch.runtime.http import HttpClient

        status_http = HttpClient(f"http://{rt.system_address}",
                                 token=rt.config.admin_token or "")
        try:
            dump = (await status_http.call(
                "GET", "/debug/requests"))["sources"][name]
        finally:
            await status_http.close()
        out["debug_requests"] = "http"
    else:
        dump = rt.forensics_sources[name]()
        out["debug_requests"] = "source"
    out["exemplars"] = {e["request_id"] for windows in dump["models"].values()
                        for w in windows for e in w["ttft"] + w["itl"]}
    out["dump_count"] = dump["exemplars"]
    return out


def _check_extra_routes(res: dict, spied: dict, params, mc, device) -> None:
    """Exit unless the extra routes' readings (_extra_routes) hold."""
    chat, msg = res["chat"], res["message"]
    text = msg["content"][0]["text"] if msg["content"] else None
    streamed = "".join(d["delta"].get("text", "") for n, d in
                       res["message_events"]
                       if n == "content_block_delta")
    names = [n for n, _ in res["message_events"]]
    if not (res["chat_ids"] and res["chat_ids"] == res["message_ids"]
            == res["message_stream_ids"]) or len(res["chat_ids"][0]) != 8:
        raise SystemExit("frontend: /v1/messages token ids differ from "
                         "/v1/chat/completions' for the same prompt")
    if text != chat["choices"][0]["message"]["content"] or streamed != text \
            or msg["stop_reason"] != "max_tokens" \
            or names[0] != "message_start" or names[-1] != "message_stop":
        raise SystemExit(f"frontend: /v1/messages answered {msg}, streamed "
                         f"{names}")
    if res["count_tokens"] != res["chat_tokens"]:
        raise SystemExit(f"frontend: count_tokens {res['count_tokens']} "
                         f"against {res['chat_tokens']}")
    first, second, got = res["responses"]
    if not (second["usage"]["input_tokens"] > first["usage"]["input_tokens"]
            and got == second and second["status"] == "completed"):
        raise SystemExit(f"frontend: /v1/responses chain {first} {second}")
    batch = res["batch"]
    if batch["request_counts"] != {"total": 2, "completed": 2, "failed": 0}:
        raise SystemExit(f"frontend: the batch ended {batch}")
    ids_b = [spied.get(f"fe-batch-{i}", []) for i in range(2)]
    ids_d = [spied.get(f"fe-direct-{i}", []) for i in range(2)]
    parted = _check_streams("frontend batch", [(x,) for x in ids_b],
                            [(x,) for x in ids_d], res["batch_reqs"], params,
                            mc, device)
    for i, direct in enumerate(res["direct"]):
        line = res["batch_lines"][f"line-{i}"]["response"]
        if line["status_code"] != 200 or (
                ids_b[i] == ids_d[i]
                and _scrubbed(line["body"]) != _scrubbed(direct)):
            raise SystemExit(f"frontend: batch line {i}'s body differs from "
                             f"the same request sent directly")
    res["batch_parted"] = parted
    if not res["exemplars"] & {f"fe-{i}" for i in range(5)}:
        raise SystemExit(f"frontend: /debug/requests holds none of the "
                         f"phase's requests: {sorted(res['exemplars'])}")


async def _affinity_short_form(fe, iid: int) -> dict:
    """Three chat turns of one session (x-dynamo-session-id) through a
    frontend with a session-affinity TTL: the first binds the session to
    the worker, the second reuses the binding, the third
    (x-dynamo-session-final) releases it."""
    coord = fe.route.coordinator
    sid = "smoke-session"
    body = {"model": fe.model, "max_tokens": 4, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "turn"}]}
    seen = []
    for turn in range(3):
        hdrs = {"x-dynamo-session-id": sid}
        if turn == 2:
            hdrs["x-dynamo-session-final"] = "1"
        await fe.http.call("POST", "/v1/chat/completions", body,
                           headers=hdrs)
        e = coord.entries.get(sid)
        seen.append(None if e is None else e.worker_id)
    if seen != [iid, iid, None]:
        raise SystemExit(f"frontend: session affinity bound {seen}, not "
                         f"[{iid}, {iid}, released]")
    return {"bound": seen}


async def _frontend_phase(rt, worker, params, used) -> dict:
    """The port's frontend and KV router (_Frontend) on the bf16 worker's
    runtime, after the worker phase's checks and before its drain.
    /v1/models lists the worker's card.  The five prompts (as text whose
    MockTokenizer encodings have the engine phase's lengths) run twice in
    one shape (_in_shape), each time on a cleared cache: over the request
    plane (the preprocessor's requests, the reference), then as streamed
    /v1/completions with K1/K3 launches counted around them.  Exits
    unless every stream's ids equal the reference's (a greedy one may
    part only at a near-tie, _check_streams), every HTTP text equals the
    frontend's rendering of the reference ids, usage counts 32 tokens,
    the fifth request was routed with an 8-block predicted overlap and
    realized 8, the launches cover layers x steps, a unary chat answers,
    the extra routes hold (_extra_routes, _check_extra_routes), a
    session binds, reuses and releases on a second frontend with a
    session-affinity TTL once the first is closed (_affinity_short_form),
    /v1/embeddings' vector has cosine >= EMBED_HTTP_COSINE with the
    request plane's `embed`, a stream the client drops frees its slot,
    /metrics carries the frontend's and the router's families, the KServe
    gRPC service on the same ModelManager holds (_kserve_phase), and
    close() leaves no task.  Logs each request's TTFT through HTTP
    beside the request plane's, the streamed decode tokens/s, the
    router's pick host time and the phase's seconds."""
    from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor

    t_phase = time.perf_counter()
    eng, iid = worker.engine, worker.served.instance_id
    mc = eng.model_cfg
    bs = worker.config.block_size
    pre = OpenAIPreprocessor(worker.card)
    tok = pre.tokenizer
    texts = _frontend_texts()
    comp = rt.namespace("dynamo").component("backend")
    gen = await comp.endpoint("generate").client().start()
    emb = await comp.endpoint("embed").client().start()
    fe = await _Frontend.attach(rt)
    spied: dict = {}
    _spy_streams(eng, spied)
    try:
        models = await fe.http.call("GET", "/v1/models")
        if [m["id"] for m in models["data"]] != [worker.card.name]:
            raise SystemExit(f"frontend: /v1/models lists {models}")
        bodies = [_frontend_body(fe.model, t, f"fe-{i}", sampled=(i == 2))
                  for i, t in enumerate(texts)]
        refs = [pre.preprocess_completion(dict(b, request_id=f"rp-{i}"))
                for i, b in enumerate(bodies)]
        if [len(r.token_ids) for r in refs] != [*FRONTEND_LENGTHS, 1224]:
            raise SystemExit("frontend: the texts do not encode to the "
                             "phase's lengths")

        async def index_gate():
            await fe.wait_blocks(iid, FRONTEND_LENGTHS[0] // bs,
                                 "the first prompt's blocks")

        await eng.clear_kv_blocks()
        ref = await _in_shape(
            lambda i, first: _rp_stream(gen, refs[i], first), index_gate)
        await eng.clear_kv_blocks()
        await fe.wait_blocks(iid, 0, "a cleared worker")
        m0 = dict(eng.metrics)
        for fn in used:
            fn.launches = 0
        got = await _in_shape(lambda i, first: fe.sse(bodies[i], first),
                              index_gate)
        counts = {fn.__name__: fn.launches for fn in used}
        steps = {k: eng.metrics[k] - m0[k] for k in
                 ("decode_steps", "prefill_steps", "cache_hit_tokens")}
        # one unary chat, one embedding, one dropped stream
        chat = await fe.http.call("POST", "/v1/chat/completions", {
            "model": fe.model, "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": texts[3]}]})
        vec = (await fe.http.call("POST", "/v1/embeddings", {
            "model": fe.model, "input": texts[3]}))["data"][0]["embedding"]
        rp_vec = [f async for f in emb.generate(
            {"token_ids": tok.encode(texts[3])})][0]["embedding"]
        a = torch.tensor(vec, dtype=torch.float64)
        b = torch.tensor(rp_vec, dtype=torch.float64)
        cos = float(a @ b / (a.norm() * b.norm()))
        drop = dict(bodies[3], request_id="fe-drop", max_tokens=1000)
        dropped = await fe.sse(drop, stop_after=4)
        end = time.monotonic() + 10.0
        while (eng.num_active_seqs or fe.service.inflight) \
                and time.monotonic() < end:
            await asyncio.sleep(0.02)
        freed = eng.num_active_seqs == 0 and fe.service.inflight == 0
        metrics = (await fe.http.request("GET", "/metrics")).body.decode()
        stats = fe.router.overlap_stats()
        pred_real = list(fe.router._pred_real)
        t_extra = time.perf_counter()
        extra = await _extra_routes(fe, rt, pre, spied, texts)
        extra["seconds"] = time.perf_counter() - t_extra
        kserve = await _kserve_phase(fe, rt, eng, iid, texts, refs, spied,
                                     used, params, mc)
    finally:
        eng.__dict__.pop("generate", None)
        left = await fe.close()
        await gen.close()
        await emb.close()
    # the session's short form on a second frontend with a TTL, so the
    # checks above run through the default deployment (no TTL)
    t_aff = time.perf_counter()
    aff = await _Frontend.attach(rt, session_affinity_ttl=30.0)
    try:
        extra["affinity"] = await _affinity_short_form(aff, iid)
    finally:
        left += await aff.close()
    extra["affinity_seconds"] = time.perf_counter() - t_aff
    secs = time.perf_counter() - t_phase
    base_secs = t_extra - t_phase
    # the streams against the reference
    for i, (g, r) in enumerate(zip(got, ref)):
        ids = spied.get(f"fe-{i}", [])
        if g["text"] != _render(tok, ids):
            raise SystemExit(f"frontend: request {i}'s HTTP text is not the "
                             "rendering of its own token ids")
        if (g["usage"] or {}).get("completion_tokens") != 32 \
                or len(r["ids"]) != 32:
            raise SystemExit(f"frontend: request {i}: usage {g['usage']}, "
                             f"{len(r['ids'])} reference tokens")
    greedy = [i for i in range(5) if i != 2]
    parted = _check_streams(
        "frontend", [(spied[f"fe-{i}"],) for i in greedy],
        [(ref[i]["ids"],) for i in greedy], [refs[i] for i in greedy],
        params, mc, eng.device)
    same_text = [got[i]["text"] == _render(tok, ref[i]["ids"])
                 for i in range(5)]
    if spied["fe-2"] != ref[2]["ids"]:
        raise SystemExit("frontend: the seeded sampled request's stream "
                         "differs from its request-plane reference")
    if not all(same_text[i] for i in range(5)
               if i not in {greedy[p[0]] for p in parted}):
        raise SystemExit(f"frontend: HTTP texts equal to the reference's "
                         f"rendering: {same_text}")
    fifth = fe.decisions.get("fe-4") or {}
    shared = FRONTEND_SHARED // bs
    log(f"frontend: the fifth request's decision {fifth}; predicted and "
        f"realized overlap blocks of every routed request {pred_real}")
    if fifth.get("predicted_overlap_blocks") != shared \
            or (shared, shared) not in pred_real:
        raise SystemExit(f"frontend: the fifth request was not routed with "
                         f"an overlap of {shared} blocks realized")
    _check_worker_launches(counts, steps, mc.n_layers, "frontend")
    if not (isinstance(chat["choices"][0]["message"]["content"], str)
            and chat["usage"]["completion_tokens"] == 8):
        raise SystemExit(f"frontend: unary chat answered {chat}")
    if len(vec) != mc.d_model or not cos >= EMBED_HTTP_COSINE:
        raise SystemExit(f"frontend: /v1/embeddings dim {len(vec)}, cosine "
                         f"{cos} with the request plane's embed")
    if dropped["events"] < 4 or not freed:
        raise SystemExit("frontend: a stream the client dropped did not "
                         "free its slot")
    names = ("dynamo_frontend_requests_total", "dynamo_frontend_itl_seconds",
             "dynamo_frontend_request_duration_seconds",
             "dynamo_router_overlap_blocks",
             "dynamo_router_overlap_realized_blocks")
    missing = [n for n in names if f"\n{n}" not in metrics]
    if missing:
        raise SystemExit(f"frontend: /metrics lacks {missing}")
    if left:
        raise SystemExit(f"frontend: close() left tasks {left}")
    _check_extra_routes(extra, spied, params, mc, eng.device)
    log(f"frontend extra routes: /v1/messages unary and streamed equal to "
        f"/v1/chat/completions ({extra['chat_ids'][0]}), count_tokens "
        f"{extra['count_tokens']}, /v1/responses chained (input tokens "
        f"{extra['responses'][0]['usage']['input_tokens']} then "
        f"{extra['responses'][1]['usage']['input_tokens']}), a multipart "
        f"upload of {extra['file']['bytes']} bytes run as a batch to "
        f"{extra['batch']['status']} {extra['batch']['request_counts']} "
        f"({len(extra['batch_parted'])} parting(s) from the direct "
        f"requests), /debug/requests ({extra['debug_requests']}) with "
        f"{extra['dump_count']} exemplars, the phase's among them; session "
        f"affinity bound, reused, released {extra['affinity']['bound']} "
        f"on a second frontend with a 30 s TTL; extra routes "
        f"{extra['seconds']:.1f} s, session {extra['affinity_seconds']:.1f} "
        f"s")
    # the four concurrent requests' decode tokens after their first
    n_dec = 31 * len(got[1:])
    rate = n_dec / (max(g["last"] for g in got[1:])
                    - min(g["ttft"] for g in got[1:]))
    ttft = [(round(g["ttft"], 4), round(r["ttft"], 4),
             round(g["ttft"] - r["ttft"], 4)) for g, r in zip(got, ref)]
    pick_ms = [round(s * 1e3, 3) for s in fe.pick_s]
    # the frontend's own host time a request: received to its dispatch
    # to the worker (preprocessing, routing), the SLO plane's histogram
    samples = _parse_metrics(metrics)
    n_q = sum(v for n, _, v in samples
              if n == "dynamo_frontend_queue_seconds_count")
    queue_ms = 1e3 * sum(v for n, _, v in samples
                         if n == "dynamo_frontend_queue_seconds_sum") / n_q
    log(f"frontend ({len(parted)} greedy parting(s) at a near-tie): TTFT s "
        f"through HTTP / through the request plane / difference, per "
        f"request: {ttft}; streamed decode {rate:.1f} tokens/s over the "
        f"four concurrent requests ({n_dec} decode tokens in all); router "
        f"pick host ms per decision {pick_ms}; received to dispatch "
        f"{queue_ms:.3f} ms a request on average over {n_q:.0f} "
        f"(dynamo_frontend_queue_seconds); /v1/embeddings cosine "
        f"{cos:.6f}; a dropped stream freed its slot; phase {secs:.1f} s, "
        f"{base_secs:.1f} s of it before the extra routes")
    log(f"frontend launches around the HTTP requests: {counts}; steps "
        f"{steps}; router stats {stats}")
    return {"launches": counts, "ttft": ttft, "decode_tokens_s": rate,
            "pick_ms": pick_ms, "queue_ms": queue_ms,
            "embed_cosine": cos, "parted": parted,
            "seconds": secs, "base_seconds": base_secs, "steps": steps,
            "extra_seconds": extra["seconds"],
            "affinity_seconds": extra["affinity_seconds"],
            "kserve": kserve}


def check_frontend(device, card: str, params) -> dict:
    """--frontend: two TorchEngineWorkers at llama-8b full depth sharing
    one copy of the weights `params`, each with its own 512-block bf16
    cache, on one runtime behind the port's frontend and KV router
    (_Frontend).  Each worker serves the first prompt, the fifth and a
    cold one (the fourth's text) alone over the request plane first, as
    the references; then both caches are cleared and the same go through
    HTTP: the first (placed by the tie-break), the fifth (exits unless it
    goes to the first's worker with an 8-block overlap against 0), and,
    while the fifth decodes, the cold one (exits unless it goes to the
    other worker, by load).  Exits unless every HTTP stream's ids equal
    its worker's reference (a greedy parting only at a near-tie) and its
    text their rendering, and K1 and K3 ran at least layers x steps
    times around the HTTP requests.  Then a second frontend, with a
    session-affinity TTL of 30 s, holds a session's turns on one worker
    while its KV router alone moves a cold request away
    (_affinity_pair)."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    cfg = dataclasses.replace(_engine_config("bf16"), warmup=True)
    used = _kernels_of("bf16")
    texts = _frontend_texts()

    async def run():
        rt = await DistributedRuntime(config=RuntimeConfig(
            discovery_backend="mem", event_plane="inproc",
            tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
        workers = []
        fe = None
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                workers.append(await TorchEngineWorker(
                    rt, cfg, params=params, device=device).start())
                log(f"frontend pair: worker {workers[-1].served.instance_id} "
                    f"started with warm-up in {time.perf_counter() - t0:.1f} "
                    f"s, {workers[-1].config.num_blocks} KV blocks")
            iids = [w.served.instance_id for w in workers]
            bs = cfg.block_size
            pre = OpenAIPreprocessor(workers[0].card)
            tok = pre.tokenizer
            gen = await rt.namespace("dynamo").component("backend").endpoint(
                "generate").client().start()
            fe = await _Frontend.attach(rt, n_instances=2)
            names = {0: "first", 4: "fifth", 3: "cold"}
            bodies = {i: _frontend_body(fe.model, texts[i], f"fe-{names[i]}")
                      for i in names}
            refs = {}
            for w in workers:
                await w.engine.clear_kv_blocks()
                for i in (0, 4, 3):
                    req = pre.preprocess_completion(dict(
                        bodies[i], request_id=f"rp-{w.served.instance_id}-{i}"))
                    refs[(w.served.instance_id, i)] = (await _rp_stream(
                        gen, req, instance_id=w.served.instance_id))["ids"]
            for w in workers:
                await w.engine.clear_kv_blocks()
                await fe.wait_blocks(w.served.instance_id, 0,
                                     "a cleared worker")
            spied: dict = {}
            for w in workers:
                _spy_streams(w.engine, spied)
            m0 = [dict(w.engine.metrics) for w in workers]
            for fn in used:
                fn.launches = 0
            got = {0: await fe.sse(bodies[0])}
            warm = fe.decisions["fe-first"]["target"]
            await fe.wait_blocks(warm, FRONTEND_LENGTHS[0] // bs,
                                 "the first prompt's blocks")
            first = asyncio.Event()
            fifth = asyncio.create_task(fe.sse(bodies[4], first))
            await asyncio.wait_for(first.wait(), FRONTEND_WAIT_S)
            got[3] = await fe.sse(bodies[3])
            got[4] = await fifth
            counts = {fn.__name__: fn.launches for fn in used}
            steps = {k: sum(w.engine.metrics[k] - m[k]
                            for w, m in zip(workers, m0))
                     for k in ("decode_steps", "prefill_steps")}
            decisions, pick_s = dict(fe.decisions), list(fe.pick_s)
            left, fe = await fe.close(), None
            if left:
                raise SystemExit(f"frontend: close() left tasks {left}")
            # the session on a second frontend, with a TTL
            fe = await _Frontend.attach(rt, n_instances=2,
                                        session_affinity_ttl=30.0)
            session = await _affinity_pair(fe, workers, texts)
            for w in workers:
                w.engine.__dict__.pop("generate", None)
            await gen.close()
            reqs = [pre.preprocess_completion(bodies[i]) for i in (0, 4, 3)]
            return (iids, warm, refs, got, spied, counts, steps, decisions,
                    pick_s, tok, reqs, workers[0].engine.model_cfg, session)
        finally:
            if fe is not None:
                left = await fe.close()
                if left:
                    raise SystemExit(f"frontend: close() left tasks {left}")
            for w in workers:
                await w.close()
                w.engine.kv = w.engine.graphs = None
                w.engine.prefill_graphs = w.engine.guided_graphs = None
            await rt.shutdown()

    t0 = time.perf_counter()
    (iids, warm, refs, got, spied, counts, steps, decisions, pick_s,
     tok, reqs, mc, session) = asyncio.run(run())
    secs = time.perf_counter() - t0
    other = next(i for i in iids if i != warm)
    d5, dc = decisions["fe-fifth"], decisions["fe-cold"]
    shared = FRONTEND_SHARED // cfg.block_size
    rejected = d5.get("best_rejected", {})
    log(f"frontend pair: the first request went to {warm} (tie-break); "
        f"the fifth's decision {d5}; the cold one's {dc}")
    if d5["target"] != warm or d5["predicted_overlap_blocks"] != shared \
            or rejected.get("overlap_blocks") != 0:
        raise SystemExit(f"frontend pair: the fifth request was not routed "
                         f"to the warm worker with {shared} blocks of "
                         f"overlap against 0")
    if dc["target"] != other:
        raise SystemExit("frontend pair: the cold request did not go by "
                         "load to the idle worker")
    served_by = {0: warm, 4: warm, 3: other}
    names = {0: "first", 4: "fifth", 3: "cold"}
    order = [0, 4, 3]
    parted = _check_streams(
        "frontend pair", [(spied[f"fe-{names[i]}"],) for i in order],
        [(refs[(served_by[i], i)],) for i in order], reqs, params, mc,
        device)
    for j, i in enumerate(order):
        if got[i]["text"] != _render(tok, spied[f"fe-{names[i]}"]):
            raise SystemExit(f"frontend pair: the {names[i]} request's text "
                             "is not the rendering of its token ids")
        if j not in {p[0] for p in parted} and got[i]["text"] != _render(
                tok, refs[(served_by[i], i)]):
            raise SystemExit(f"frontend pair: the {names[i]} request's text "
                             "differs from its worker's reference")
    _check_worker_launches(counts, steps, mc.n_layers, "frontend pair")
    ttft = {names[i]: round(got[i]["ttft"], 4) for i in order}
    log(f"frontend pair ({card}): TTFT s through HTTP {ttft}; router pick "
        f"host ms {[round(s * 1e3, 3) for s in pick_s]}; {len(parted)} "
        f"greedy parting(s) at a near-tie; phase {secs:.1f} s")
    return {"warm": warm, "fifth": d5, "cold": dc, "launches": counts,
            "steps": steps, "ttft": ttft, "parted": parted,
            "session": session, "seconds": round(secs, 1)}


AFFINITY_PHANTOMS = 4
AFFINITY_PHANTOM_BLOCKS = 400


async def _affinity_pair(fe, workers, texts) -> dict:
    """Session affinity over two workers (the frontend's TTL 30 s): turn
    1 of a session binds it where the KV router places it; then the
    bound worker carries AFFINITY_PHANTOMS phantom requests in the
    router's books, so the KV router alone sends a cold request (no
    session) to the other worker, while turns 2 and 3 (the last with
    x-dynamo-session-final) stay on the bound one; the final turn
    releases the binding.  Exits unless all of that holds."""
    served = {w.served.instance_id: [] for w in workers}
    for w in workers:
        gen = w.engine.generate

        async def recorded(request, *a, _gen=gen, _iid=w.served.instance_id,
                           **kw):
            served[_iid].append(request.request_id)
            async for out in _gen(request, *a, **kw):
                yield out

        w.engine.generate = recorded
    coord, sid = fe.route.coordinator, "pair-session"
    body = {"model": fe.model, "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True}

    async def turn(i: int, text: str, session: bool, final: bool = False):
        hdrs = {"x-dynamo-session-id": sid} if session else {}
        if final:
            hdrs["x-dynamo-session-final"] = "1"
        rid = f"fe-turn-{i}" if session else "fe-control"
        await fe.http.call("POST", "/v1/chat/completions", dict(
            body, request_id=rid,
            messages=[{"role": "user", "content": text}]), headers=hdrs)
        return rid

    await turn(1, texts[1][:300], True)
    bound = coord.entries[sid].worker_id
    for i in range(AFFINITY_PHANTOMS):
        fe.router.sequences.add_request(f"phantom-{i}", bound,
                                        AFFINITY_PHANTOM_BLOCKS, 0)
    try:
        await turn(2, texts[2], True)
        control = await turn(0, texts[1][300:], False)
        await turn(3, texts[3], True, final=True)
    finally:
        for i in range(AFFINITY_PHANTOMS):
            fe.router.sequences.free(f"phantom-{i}")
    where = {rid: iid for iid, rids in served.items() for rid in rids}
    turns = [where.get(f"fe-turn-{i}") for i in (1, 2, 3)]
    moved = fe.decisions.get(control, {}).get("target")
    log(f"frontend pair session affinity: turns on {turns} (bound to "
        f"{bound}); the KV router alone sent the control request to "
        f"{moved}; binding after the final turn "
        f"{coord.entries.get(sid)}")
    if turns != [bound] * 3 or where.get(control) == bound \
            or moved == bound or sid in coord.entries:
        raise SystemExit("frontend pair: the session's turns did not stay "
                         "on the bound worker, the control request was not "
                         "moved, or the final turn kept the binding")
    return {"bound": bound, "turns": turns, "control": moved}


# CLIP ViT-L/14-336, LLaVA-1.5's tower (openai/clip-vit-large-patch14-336:
# image 336, patch 14, width 1024, 24 layers, 16 heads), in the JAX
# package's VisionConfig fields (its MLP is 4 x d_model), projected to
# llama-8b's 4096
VIT_L = dict(image_size=336, patch_size=14, d_model=1024, n_layers=24,
             n_heads=16, out_dim=4096)
ENCODER_TOL = 2e-2
ENCODER_IMAGES = 4


def vit_flops(cfg, B: int = 1) -> tuple:
    """(bf16 product FLOPs, fp32 attention FLOPs) of the tower over B
    images."""
    n, d, L = cfg.n_patches, cfg.d_model, cfg.n_layers
    mm = (2 * n * cfg.patch_dim * d
          + L * (2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * 4 * d)
          + 2 * n * d * cfg.out_dim)
    return B * mm, B * L * 2 * 2 * n * n * d


def _frame_tensor(frame: dict) -> torch.Tensor:
    """An encode frame's embedding as a float32 CPU tensor (a bfloat16
    frame carries the 16-bit patterns)."""
    if frame["dtype"] == "bfloat16":
        t = torch.frombuffer(bytearray(frame["embedding"]),
                             dtype=torch.int16).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(frame["embedding"],
                                           dtype=frame["dtype"]).copy())
    return t.float().reshape(frame["shape"])


def check_encoder(device, card: str, cfg=None) -> dict:
    """The port's EncoderWorker with a VitEncoder at CLIP ViT-L/14-336
    widths (VIT_L, bf16, random weights from a seeded generator; `cfg`
    overrides the VisionConfig) on a fresh runtime (mem discovery,
    in-process event plane, TCP request plane): ENCODER_IMAGES .npy
    images (seeded, non-symmetric) through the request plane one request
    each, then the same again.  Exits unless every frame has n_patches
    (576) tokens of out_dim, each image is within ENCODER_TOL per-row
    relative L2 of an fp32 tower with the same weights (and a planted
    fault, the fp32 tower on the image with its height and width
    swapped, above it), and the repeat is all cache hits with no tower
    call; then _encoder_hop_http (two image chats through the port's
    frontend: a tower call, then a cache hit, n_patches placeholders
    spliced, each ending in the worker's named refusal).  Logs ms an image (through the request plane, and the tower
    alone by CUDA events) against the FLOP bound (products over 989
    TFLOP/s, the fp32 attention over 67), and the K1/K3 launches of the
    phase (plain torch: 0 expected)."""
    import io
    import uuid

    from dynamo_tpu_torch.multimodal import (
        EncoderWorker,
        VisionConfig,
        VitEncoder,
        media_hash,
    )
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    t_phase = time.perf_counter()
    cfg = cfg or VisionConfig(dtype=torch.bfloat16, **VIT_L)
    enc = VitEncoder(cfg, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(11)
    images = [rng.random((cfg.image_size, cfg.image_size, 3),
                         dtype=np.float32) for _ in range(ENCODER_IMAGES)]
    # one more goes through the frontend only (a tower call, then a cache
    # hit), at half the side: a chat body stays under the server's 1 MiB
    # (aiohttp's client_max_size), and the encoder resizes it
    hop_image = rng.random((cfg.image_size // 2, cfg.image_size // 2, 3),
                           dtype=np.float32)
    uris = []
    for img in [*images, hop_image]:
        buf = io.BytesIO()
        np.save(buf, img)
        uris.append("data:application/x-npy;base64,"
                    + base64.b64encode(buf.getvalue()).decode())
    uris, hop_uri = uris[:-1], uris[-1]
    hashes = [media_hash(u.partition(",")[2].encode()) for u in uris]
    calls = [0]
    inner = enc.encode

    def counted(px):
        calls[0] += 1
        return inner(px)

    enc.encode = counted
    used = _kernels_of("bf16") + _kernels_of("int8")

    async def run():
        rt = await DistributedRuntime(config=RuntimeConfig(
            discovery_backend="mem", event_plane="inproc",
            tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
        worker = await EncoderWorker(rt, "llava-smoke", encoder=enc).start()
        client = await rt.namespace("dynamo").component("encoder").endpoint(
            "encode").client().start()
        try:
            await client.wait_for_instances()
            passes = []
            for _ in range(2):
                c0 = calls[0]
                frames, ms = [], []
                for h, u in zip(hashes, uris):
                    t0 = time.perf_counter()
                    frames += [f async for f in client.generate(
                        {"request_id": h,
                         "items": [{"media_hash": h, "data_uri": u}]})]
                    ms.append((time.perf_counter() - t0) * 1e3)
                passes.append((frames, ms, calls[0] - c0))
            m0 = dict(worker.metrics)
            hop = await _encoder_hop_http(rt, device, hop_uri, calls)
            hop["cache_hits"] = worker.metrics["cache_hits"] \
                - m0["cache_hits"]
            return passes, m0, hop
        finally:
            await client.close()
            await worker.close()
            await rt.shutdown()

    for fn in used:
        fn.launches = 0
    passes, metrics, hop = asyncio.run(run())
    launches = {fn.__name__: fn.launches for fn in used}
    (first, ms1, tower1), (second, ms2, tower2) = passes
    enc32 = VitEncoder(dataclasses.replace(cfg, dtype=torch.float32),
                       device=device, generator=torch.Generator(
                           device=device).manual_seed(1))
    enc32.load_state_dict({k: v.float() for k, v in
                           enc.state_dict().items()})
    errs, faults = [], []
    frame_dtypes = {f["dtype"] for f in first + second}
    want_dtype = str(cfg.dtype).removeprefix("torch.")
    for f, img in zip(first, images):
        got = _frame_tensor(f)
        ref = enc32.encode(img[None])[0]
        bad = enc32.encode(
            np.ascontiguousarray(img.transpose(1, 0, 2))[None])[0]
        errs.append(row_rel_err(got, ref))
        faults.append(row_rel_err(bad, ref))
    del enc32
    px = torch.from_numpy(images[0][None]).to(device)
    with torch.no_grad():
        tower_ms = time_ms(lambda: enc(px), iters=5, warmup=2)
    mm, attn = vit_flops(cfg)
    bound_ms = (mm / BF16_FLOPS_PER_S + attn / FP32_FLOPS_PER_S) * 1e3
    shapes = {tuple(f["shape"]) for f in first + second}
    log(f"encoder phase ({card}): {cfg.n_layers} layers of width "
        f"{cfg.d_model} on {cfg.image_size}px images, {cfg.dtype}; frames "
        f"{len(first)} + {len(second)} of shape {sorted(shapes)}, dtype "
        f"{sorted(frame_dtypes)} ({len(first[0]['embedding'])} bytes); per-row "
        f"relative L2 against fp32 {[f'{e:.3e}' for e in errs]} (limit "
        f"{ENCODER_TOL}), planted fault (height and width swapped) "
        f"{[f'{e:.3e}' for e in faults]}; tower calls {tower1} then "
        f"{tower2}, cached {[f['cached'] for f in second]}, metrics "
        f"{metrics}; ms an image through the request plane, first pass "
        f"{[round(m, 2) for m in ms1]}, repeat {[round(m, 2) for m in ms2]};"
        f" the tower alone {tower_ms:.3f} ms an image against its "
        f"{bound_ms:.3f} ms FLOP bound ({mm / 1e12:.3f} TFLOP bf16 at 989, "
        f"{attn / 1e12:.3f} fp32 at 67); K1/K3 launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if shapes != {(cfg.n_patches, cfg.out_dim)} or len(second) != \
            ENCODER_IMAGES:
        raise SystemExit(f"encoder frames of shapes {shapes}")
    if frame_dtypes != {want_dtype}:
        raise SystemExit(f"encoder frames of dtypes {frame_dtypes}, not "
                         f"the tower's {want_dtype}")
    if max(errs) > ENCODER_TOL or min(faults) <= ENCODER_TOL:
        raise SystemExit("encoder: off fp32, or the planted fault passes")
    if tower2 or not all(f["cached"] for f in second) \
            or metrics["cache_hits"] != ENCODER_IMAGES:
        raise SystemExit("encoder: the repeat was not all cache hits")
    log(f"encoder hop through the port's frontend ({card}): two image chats "
        f"answered {hop['status']} ({hop['error']!r}); tower calls "
        f"{hop['tower_calls']}, encoder cache hits {hop['cache_hits']}; "
        f"placeholder tokens spliced {hop['spliced']}; hop ms "
        f"{[round(m, 2) for m in hop['hop_ms']]} against the request "
        f"plane's {round(ms1[0], 2)} (first pass) and {round(ms2[0], 2)} "
        f"(repeat)")
    if hop["status"] != [500, 500] or any(
            "multimodal inputs" not in e for e in hop["error"]) \
            or hop["tower_calls"] != [1, 0] or hop["cache_hits"] != 1 \
            or hop["spliced"] != [cfg.n_patches] * 2:
        raise SystemExit("encoder: the image chats through the frontend did "
                         "not reach the encoder, hit its cache, splice "
                         "n_patches placeholders and end in the worker's "
                         "named refusal")
    return {"err": max(errs), "fault": min(faults), "ms": ms1,
            "repeat_ms": ms2, "tower_ms": tower_ms, "bound_ms": bound_ms,
            "launches": launches, "hop_ms": hop["hop_ms"]}


# the LLM worker behind the encoder hop: a one-layer model of the llava
# name on the card (its engine refuses the spliced embeddings before any
# forward, ROADMAP Queue 3 item 9, so its size does not matter)
HOP_LLM = dict(name="llava-smoke-llm", vocab_size=4096, d_model=256,
               n_layers=1, n_heads=4, n_kv_heads=1, head_dim=64, ffn_dim=512)


async def _encoder_hop_http(rt, device, uri: str, calls: list) -> dict:
    """Two chats with the same image (`uri`) through the port's frontend
    on the encoder phase's runtime, in front of a HOP_LLM worker named as
    the encoder's model: the EncoderHop encodes (a tower call), then
    finds the image in the encoder's cache; each request ends in the
    worker's refusal.  Returns the statuses, errors, tower calls, the
    spliced placeholder counts and each hop's ms."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
    from dynamo_tpu_torch.models.llama import LlamaConfig

    llm = await TorchEngineWorker(rt, EngineConfig(
        model_config=LlamaConfig(dtype=torch.bfloat16, **HOP_LLM),
        model_name="llava-smoke", block_size=16, num_blocks=256,
        max_blocks_per_seq=128, max_num_seqs=2, warmup=False),
        device=device).start()
    fe = None
    out = {"status": [], "error": [], "tower_calls": [], "hop_ms": [],
           "spliced": []}
    try:
        fe = await _Frontend.attach(rt, encoder=True)
        hop = fe.pipeline.encoder
        inner = hop.encode_and_attach

        async def timed(req, token=None):
            t = time.perf_counter()
            try:
                got = await inner(req, token=token)
            finally:
                out["hop_ms"].append((time.perf_counter() - t) * 1e3)
            out["spliced"].append(len(got.token_ids) - len(req.token_ids))
            return got

        hop.encode_and_attach = timed
        body = {"model": fe.model, "max_tokens": 4, "messages": [
            {"role": "user", "content": [
                {"type": "text", "text": "what is in "},
                {"type": "image_url", "image_url": {"url": uri}}]}]}
        for _ in range(2):
            c0 = calls[0]
            r = await fe.http.request("POST", "/v1/chat/completions",
                                      json=body)
            out["status"].append(r.status)
            out["error"].append(r.json().get("error", {}).get("message", ""))
            out["tower_calls"].append(calls[0] - c0)
    finally:
        if fe is not None:
            left = await fe.close()
            if left:
                raise SystemExit(f"encoder hop: close() left tasks {left}")
        await llm.close()
        llm.engine.kv = None
    return out


# ---------------------------------------------------------------------------
# the tensor-parallel phase: two ranks on one card
# ---------------------------------------------------------------------------

# the whole check's depth of the tp phase's llama-8b (--tp runs all 32):
# at 8 layers the whole check took ~1140 s of its 1200 on an H100
TP_LAYERS = 4
# bf16 gate on the first-token logits of tp=2 against tp=1: the max
# absolute difference over the tp=1 logits' standard deviation.  Each
# rank rounds its row-parallel partial products (wo, w_down) to bf16
# before the sum, where tp=1 rounds the whole product once, on each of
# 2 x layers residual updates: on the CPU (bf16, d 1024, vocab 8192,
# random weights) the gap read 0.039 / 0.059 / 0.063 std at 2 / 8 / 16
# layers; a missing or doubled sum reads several std
TP_LOGIT_TOL = 0.2
TP_PROMPT = 512
TP_NEW = 16
# the ranks' join, collectives and the NCCL probe, seconds
TP_TIMEOUT_S = 300.0


def _nccl_probe_rank(rank: int, port: int) -> None:
    """One of two ranks of an NCCL group on cuda:0 (parallel/mesh.py's
    NCCL construction) and one all_reduce; what it raised, or its sum,
    goes to the store under probe/<rank>."""
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel import mesh

    store = dist.TCPStore(mesh.STORE_HOST, port, 3, False,
                          timeout=mesh._timeout(TP_TIMEOUT_S))
    try:
        torch.cuda.set_device(0)
        pg = mesh._nccl(store, "probe", rank, [0, 1], 60.0)
        x = torch.ones(1, device="cuda:0")
        pg.allreduce([x]).wait()
        torch.cuda.synchronize()
        msg = f"no error: the sum is {x.item()}"
    except Exception as e:  # the refusal is the point: report it
        msg = f"{type(e).__name__}: {e}"
    store.set(f"probe/{rank}", msg)
    os._exit(0)  # no NCCL teardown of a refused communicator


def _start_nccl_probe() -> tuple:
    """Spawn the probe's two ranks (they run while the phase builds its
    engines)."""
    import multiprocessing as mp

    import torch.distributed as dist

    from dynamo_tpu_torch.parallel import mesh

    store = dist.TCPStore(mesh.STORE_HOST, 0, 3, True,
                          timeout=mesh._timeout(TP_TIMEOUT_S),
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_nccl_probe_rank, args=(r, store.port),
                         name=f"nccl-probe{r}", daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    return store, procs


def _finish_nccl_probe(probe: tuple) -> dict:
    """The probe's messages (what NCCL said of two ranks on one device);
    each rank joined, or killed past the timeout."""
    store, procs = probe
    out = {}
    for r, p in enumerate(procs):
        p.join(TP_TIMEOUT_S)
        if p.is_alive():
            p.kill()
            p.join(10)
        key = f"probe/{r}"
        out[r] = (store.get(key).decode() if store.check([key])
                  else f"no message (exit code {p.exitcode})")
    refused = all(not m.startswith("no error") for m in out.values())
    for r, m in out.items():
        log(f"tp: NCCL with two ranks on cuda:0, rank {r}: {m[:600]}")
    if not refused:
        raise SystemExit("tp: NCCL accepted two ranks on one device; the "
                         "mesh's gloo choice for a shared device is wrong")
    return {"refused": refused, "messages": out}


def _tp_requests(vocab: int) -> list:
    """Four concurrent greedy requests: a TP_PROMPT-token prompt and
    three shorter ones, TP_NEW tokens each."""
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rng = np.random.default_rng(17)
    return [PreprocessedRequest(
        token_ids=rng.integers(0, vocab, n).tolist(), request_id=f"tp-{i}",
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=TP_NEW, ignore_eos=True))
        for i, n in enumerate((TP_PROMPT, 300, 100, 37))]


def _tp_one(req) -> tuple:
    """`req` cut to its first token, and the prefill bucket its prompt
    takes (whose program keeps the first-token logits)."""
    T = max(32, 1 << (len(req.token_ids) - 1).bit_length())
    one = dataclasses.replace(req, request_id=req.request_id + "-one",
                              stop=dataclasses.replace(req.stop,
                                                       max_tokens=1))
    return one, T


def _tp_margin(params, mc, device, tokens: list) -> tuple:
    """tp=1's logits after `tokens` (teacher-forced: one packed prefill
    of them on a scratch cache, or the family's padded `prefill` where
    the engine takes the padded programs: capacity MoE, MLA): (its top-2
    gap, its std)."""
    from dynamo_tpu_torch.models import get_family

    fam = get_family(mc)
    bs, n = 128, len(tokens)
    nb = -(-n // bs)
    T = max(32, 1 << (n - 1).bit_length())
    kv = tuple(torch.zeros(s, dtype=mc.dtype, device=device)
               for s in fam.kv_cache_shapes(mc, nb + 1, bs))

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    toks, pos = i32(tokens + [0] * (T - n)), i32(list(range(n))
                                                 + [0] * (T - n))
    if hasattr(fam, "prefill_packed") \
            and getattr(mc, "moe_dispatch", "dense") == "dense":
        logits, _ = fam.prefill_packed(
            params, mc, kv, toks, pos, i32([0] * T),
            i32([list(range(1, nb + 1))]), i32([n - 1]),
            torch.arange(T, device=device) < n)
    else:
        logits, _ = fam.prefill(params, mc, kv, toks, pos,
                                i32(list(range(1, nb + 1))), 0, n)
        logits = logits[None]
    top2 = torch.topk(logits[0], 2).values
    return (top2[0] - top2[1]).item(), logits[0].std().item()


def _tp_streams(what: str, got, ref, reqs, params, mc, device) -> list:
    """Leading tokens of each tp=2 stream equal to tp=1's; a parting is
    accepted only where tp=1's top-2 gap there is within TP_LOGIT_TOL of
    its logits' std (a near-tie at the tolerance the logits are held
    to), or, in a MoE model, at a router near-tie (_tp_router_tie: the
    two paths' rounding chose other experts for some token of the
    context and, with tp=2's routing held to tp=1's, tp=2 agrees at the
    parting token, as the MoE phase's _near_tie rules)."""
    lead = []
    for (g, _, _, _), (r, _, _, _), req in zip(got, ref, reqs):
        j = next((i for i, (a, b) in enumerate(zip(g, r)) if a != b),
                 min(len(g), len(r)))
        lead.append(j)
        if j < len(r):
            gap, std = _tp_margin(params, mc, device,
                                  req.token_ids + list(r[:j]))
            log(f"{what}: {req.request_id} parts at token {j} of {len(r)}, "
                f"tp=1 top-2 gap {gap:.4f} = {gap / std:.4f} std")
            if gap <= TP_LOGIT_TOL * std:
                continue
            if getattr(mc, "n_experts", 0) > 0:
                p = _tp_router_tie(params, mc, device, list(req.token_ids),
                                   list(r), j)
                held = p["held_cosine"] >= MIN_COSINE and (
                    p["held_same"] or p["gap"] <= p["held_diff"])
                log(f"{what}: {req.request_id} at token {j}: {p['flips']} "
                    f"(token, layer) routings of its context chose other "
                    f"experts at tp=2 than at tp=1; with tp=1's routing held "
                    f"at tp=2: cosine {p['held_cosine']:.6f}, max "
                    f"difference {p['held_diff']:.4f}, top tokens equal "
                    f"{p['held_same']}; router near-tie: "
                    f"{p['flips'] > 0 and held}")
                if p["flips"] > 0 and held:
                    continue
            raise SystemExit(f"{what}: {req.request_id} parts at token "
                             f"{j} where tp=1's top-2 gap is "
                             f"{gap / std:.4f} std (> {TP_LOGIT_TOL}) and "
                             "no router near-tie explains it")
    return lead


# the rank of a thread that runs one rank of an in-process tp=2 replay
_TP_RANK = threading.local()


@contextlib.contextmanager
def _rank_routes(fam, record: Optional[dict] = None,
                 replay: Optional[list] = None):
    """_routes (the Llama family's `_moe_router`) or _ds_routes
    (DeepSeek's `_ds_router`) for ranks run as threads: a call belongs to
    its thread's rank (`_TP_RANK.rank`, 0 on any other thread).  With
    `record` each call appends its expert ids [T, k] to record[rank];
    with `replay` (one rank's record) every rank selects the ids of its
    own call at the same index instead of its choice, weighted as the
    router weighs them."""
    from dynamo_tpu_torch.models import deepseek, llama

    mod, name = ((deepseek, "_ds_router") if fam is deepseek
                 else (llama, "_moe_router"))
    orig = getattr(mod, name)
    pos: dict = {}

    def weights(layer, cfg, x, ids):
        logits = x.float() @ layer["moe_gate"].float()
        if mod is llama:
            return torch.softmax(torch.gather(logits, 1, ids), dim=-1)
        scores = (torch.sigmoid(logits) if cfg.moe_scoring == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        w = torch.gather(scores, 1, ids)
        if cfg.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * cfg.routed_scaling_factor

    def spy(layer, cfg, x):
        rank = getattr(_TP_RANK, "rank", 0)
        if replay is not None:
            i = pos.get(rank, 0)
            pos[rank] = i + 1
            return weights(layer, cfg, x, replay[i]), replay[i]
        w, e = orig(layer, cfg, x)
        if record is not None:
            record.setdefault(rank, []).append(e)
        return w, e

    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _tp_replay(params, cfg, device, prompt, stream, j: int) -> torch.Tensor:
    """Token j's fp32 logits of `stream` teacher-forced through the
    family's padded `prefill` (one row, the engine's bucket) and decode
    steps at B = 4 (lane 0 live) fed stream[:j], on a scratch cache;
    `params` may be a rank's shard with its group (`cfg` its shard
    config)."""
    from dynamo_tpu_torch.models import get_family

    fam = get_family(cfg)
    bs, L = 128, len(prompt)
    nb = -(-(L + j + 1) // bs)
    T = max(32, 1 << (L - 1).bit_length())
    kv = tuple(torch.zeros(s, dtype=cfg.dtype, device=device)
               for s in fam.kv_cache_shapes(cfg, nb + 1, bs))

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    table = list(range(1, nb + 1))
    logits, _ = fam.prefill(params, cfg, kv, i32(prompt + [0] * (T - L)),
                            i32(list(range(L)) + [0] * (T - L)), i32(table),
                            0, L)
    tables = i32([table] + [[0] * nb] * 3)
    valid = torch.tensor([True, False, False, False], device=device)
    for s in range(j):
        at = [L + s, 0, 0, 0]
        out, _ = fam.decode(params, cfg, kv, i32([stream[s], 0, 0, 0]),
                            i32(at), tables, i32(at), valid=valid)
        logits = out[0]
    return logits.float()


def _tp2_in_process(shards, fn):
    """fn(params) on two threads, each a tp=2 rank (`_TP_RANK.rank`) with
    its shard and a gloo group over an in-process store; returns rank
    0's result."""
    import datetime
    import torch.distributed as dist

    from dynamo_tpu_torch.parallel.mesh import TensorGroup

    store = dist.HashStore()
    out, errs = [None, None], []

    def rank(r):
        try:
            _TP_RANK.rank = r
            pg = dist.ProcessGroupGloo(dist.PrefixStore("replay", store), r,
                                       2, datetime.timedelta(
                                           seconds=TP_TIMEOUT_S))
            out[r] = fn({**shards[r], "tp": TensorGroup("gloo", pg, r, 2)})
        except BaseException as e:  # re-raised on the caller's thread
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TP_TIMEOUT_S)
    if errs or any(t.is_alive() for t in threads):
        raise SystemExit(f"tp replay: a rank failed or hung: {errs}")
    return out[0]


def _tp_router_tie(params, mc, device, prompt, stream, j: int) -> dict:
    """What a router near-tie reads at token j of tp=1's `stream`: tp=1's
    top-2 gap there, the (token, layer) routings of the context that a
    tp=2 replay (two ranks as threads on `device`, the shards of tp=1's
    `params`) chose otherwise, and, with tp=2's routing held to tp=1's,
    its logits' cosine with tp=1's, their largest difference and
    whether the top tokens agree."""
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.parallel.mesh import shard_config, shard_params

    fam = get_family(mc)
    local = shard_config(mc, 2)
    shards = [shard_params(params, r, 2) for r in range(2)]
    ref, got = {}, {}

    def tp2(p):
        return _tp_replay(p, local, device, prompt, stream, j)

    with _rank_routes(fam, record=ref):
        lr = _tp_replay(params, mc, device, prompt, stream, j)
    with _rank_routes(fam, record=got):
        _tp2_in_process(shards, tp2)
    with _rank_routes(fam, replay=ref[0]):
        lh = _tp2_in_process(shards, tp2)
    del shards
    n_moe = sum(1 for layer in params["layers"] if "moe_gate" in layer)
    top2 = torch.topk(lr, 2).values
    return {"gap": (top2[0] - top2[1]).item(),
            "flips": _route_flips(ref[0], got[0], len(prompt), n_moe),
            "held_cosine": torch.nn.functional.cosine_similarity(
                lh, lr, dim=0).item(),
            "held_diff": (lh - lr).abs().max().item(),
            "held_same": int(lh.argmax()) == int(lr.argmax())}


def _tp_ranks_left() -> list:
    import multiprocessing as mp

    return [p.name for p in mp.active_children()
            if p.name.startswith("dynamo-rank")]


@contextlib.contextmanager
def _launches_into(into: dict):
    """Add the kernel launches this process makes inside the block to
    `into`."""
    from dynamo_tpu_torch.ops import launch_counts

    before = launch_counts()
    try:
        yield
    finally:
        for k, v in launch_counts().items():
            into[k] = into.get(k, 0) + v - before[k]


def _tp_serve(e1, tp1: dict, client):
    """The turn runners: tp=1 served by its engine directly (its launches
    counted into `tp1`), tp=2 through the worker's request plane."""

    async def serve_tp1(reqs):
        with _launches_into(tp1):
            return await _serve(e1, reqs)

    return {"tp1": serve_tp1,
            "tp2": lambda reqs: _serve_worker(client, reqs)}


def _first_logits(eng, T: int) -> torch.Tensor:
    """The first-token logits of the last prefill dispatch of `eng` (one
    row of bucket T): the packed program's, or the padded one's where
    the engine takes the padded programs."""
    if eng._packed_prefill_ok:
        return eng.prefill_graphs.logits[T][0].clone()
    return eng.padded_prefill.logits[0].clone()


def _tp_pair(device, card: str, mc, kv_dtype: str, timing: bool,
             what: Optional[str] = None,
             kernels: Optional[set] = None) -> dict:
    """A tp=1 engine and a tp=2 engine (two ranks on `device` over gloo,
    eager) behind a TorchEngineWorker, on the same random weights: the
    first-token logits, the four streams (tp=2 through the worker's
    request plane), and with `timing` decode tokens/s and TTFT in turns
    (tp1, tp2, tp2, tp1; the tp=1 engine then has its graphs, captured
    by warm-up; without `timing` it runs eagerly, the same bodies);
    after the worker's close its ranks' launches (rank 0's counted over
    the worker's life less the tp=1 engine's runs, rank 1's reported at
    stop, its whole life serving; the two must be equal, and every one
    of `kernels` launched, by default the cache's K1 and K3), no rank
    process left and the card's memory back.  `what` labels the log."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.ops import launch_counts

    base = _engine_config(kv_dtype)
    reqs = _tp_requests(mc.vocab_size)
    if kernels is None:
        kernels = {fn.__name__ for fn in _kernels_of(kv_dtype)}
    what = what or f"tp {kv_dtype}"

    async def run() -> dict:
        e1 = TorchEngine(dataclasses.replace(base, model_config=mc),
                         device=device, cuda_graphs=timing)
        if timing:
            e1.warmup_decode()
        gc.collect()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info(device)[0]
        out, tp1 = {}, {}
        one, T = _tp_one(reqs[0])
        t0 = time.perf_counter()
        life = launch_counts()
        async with _serving_worker(
                device, dataclasses.replace(base, model_config=mc, tp=2),
                None, warmup=False, devices=[device, device],
                cuda_graphs=False) as (rt, w, client, _):
            e2 = w.engine
            out.update(backend=e2.mesh.backend,
                       build_s=time.perf_counter() - t0,
                       num_blocks=e2.config.num_blocks,
                       mdc_tp_dp=(w.card.runtime_config["tp"],
                                  w.card.runtime_config["dp"]))
            log(f"{what}: tp=2 worker on {[str(device)] * 2}, "
                f"collectives over {e2.mesh.backend} (eager), up in "
                f"{out['build_s']:.1f} s; {e2.config.num_blocks} blocks, "
                f"a rank's kv heads {e2.kv[0].shape[1]} of "
                f"{getattr(mc, 'n_kv_heads', 1)}; MDC tp/dp "
                f"{out['mdc_tp_dp']}")
            if e2.mesh.backend != "gloo" or out["mdc_tp_dp"] != (2, 1):
                raise SystemExit(f"tp: backend {e2.mesh.backend}, MDC "
                                 f"tp/dp {out['mdc_tp_dp']}")
            serve = _tp_serve(e1, tp1, client)
            await serve["tp1"]([one])
            l1 = _first_logits(e1, T)
            await serve["tp2"]([one])
            l2 = _first_logits(e2, T)
            std = l1.float().std().item()
            diff = (l2.float() - l1.float()).abs().max().item()
            out["logit_diff_over_std"] = diff / std
            log(f"{what}: first-token logits of a {TP_PROMPT}-token "
                f"prompt, tp=2 against tp=1: max |diff| {diff:.4f}, std "
                f"{std:.4f}, {diff / std:.4f} std (tolerance "
                f"{TP_LOGIT_TOL}); argmax {int(l2.argmax())} / "
                f"{int(l1.argmax())}")
            if not diff / std <= TP_LOGIT_TOL:
                raise SystemExit(f"{what}: logits {diff / std:.4f} "
                                 f"std from tp=1's")
            ref = await serve["tp1"](reqs)
            got = await serve["tp2"](reqs)
            with _launches_into(tp1):  # the replays run tp=1's model
                out["leading"] = _tp_streams(what, got, ref,
                                             reqs, e1.params, mc, device)
            log(f"{what}: the four streams' leading tokens equal to "
                f"tp=1's, of {TP_NEW}: {out['leading']}")
            if timing:
                turns = {"tp1": [], "tp2": []}
                for name in ("tp1", "tp2", "tp2", "tp1"):
                    res = await serve[name](reqs)
                    n, secs = _decode_rate(res)
                    turns[name].append({
                        "decode_tok_s": n / secs,
                        "ttft_s": sorted(r[2] for r in res)})
                    log(f"{what} turn {name}: decode {n / secs:.2f} "
                        f"tokens/s, TTFT {min(r[2] for r in res):.3f}-"
                        f"{max(r[2] for r in res):.3f} s ({card})")
                out["turns"] = turns
        leader = {k: v - life[k] - tp1.get(k, 0)
                  for k, v in launch_counts().items()}
        out["launches"] = {"rank0": leader, **{
            f"rank{r}": c for r, c in e2.rank_launches.items()}}
        log(f"{what}: kernel launches while serving, by rank: "
            f"{out['launches']}")
        for rank, counts in out["launches"].items():
            if not all(counts.get(k, 0) > 0 for k in kernels):
                raise SystemExit(f"{what}: {rank} launched "
                                 f"{counts}, not every one of {kernels}")
        if out["launches"].get("rank1") != leader:
            raise SystemExit(f"{what}: the ranks launched "
                             f"different kernels {out['launches']}")
        del e2, w
        gc.collect()
        torch.cuda.empty_cache()
        left = _tp_ranks_left()
        free1 = torch.cuda.mem_get_info(device)[0]
        out["free_gib_before_after"] = (free0 / 2**30, free1 / 2**30)
        log(f"{what}: after close, rank processes left {left}; card "
            f"memory free {free0 / 2**30:.2f} GiB before the tp=2 worker, "
            f"{free1 / 2**30:.2f} GiB after")
        if left or free1 < free0 - 2**30:
            raise SystemExit(f"{what}: ranks {left} left or the "
                             "card's memory not back after close")
        await e1.close()
        _free_engine(e1)
        return out

    return asyncio.run(run())


def check_tp(device, card: str, n_layers: int) -> dict:
    """The tensor-parallel phase: NCCL's refusal of two ranks on one
    device, then a tp=1 and a tp=2 engine at llama-8b width and
    `n_layers` deep, random bf16 weights from seed 0, on a bf16 cache
    (with the timing turns) and on an int8 cache."""
    t0 = time.perf_counter()
    probe = _start_nccl_probe()
    from dynamo_tpu_torch.models.llama import PRESETS

    mc = dataclasses.replace(PRESETS["llama-8b"], n_layers=n_layers)
    out = {"layers": n_layers}
    try:
        out["bf16"] = _tp_pair(device, card, mc, "bf16", timing=True)
        out["int8"] = _tp_pair(device, card, mc, "int8", timing=False)
    finally:
        out["nccl"] = _finish_nccl_probe(probe)
    out["seconds"] = time.perf_counter() - t0
    log(f"tp phase ({n_layers} layers) done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the MoE and MLA families, disaggregation and KVBM on two ranks of one card
# ---------------------------------------------------------------------------

# --tp-families alone: mixtral-8x7b 4 of 32 layers (its experts are 8 x 3
# x 4096 x 14336 x 2 B = 2.8 GB a layer, 11.3 GB a side), deepseek-v2-lite
# 8 of 27 (~9 GB a side); the whole check runs both at TP_LAYERS
TP_MIXTRAL_LAYERS = 4
TP_DEEPSEEK_LAYERS = 8
# --tp-disagg's KVBM engine: prompt A of TP_KVBM_PROMPT tokens (7 full
# blocks), TP_KVBM_CHURN distinct prompts of its length served one at a
# time through a G1 of TP_KVBM_BLOCKS blocks (each request holds 8), so
# A keeps no block in G1 before its repeat; TP_KVBM_NEW tokens each
TP_KVBM_PROMPT = 1000
TP_KVBM_CHURN = 3
TP_KVBM_BLOCKS = 24
TP_KVBM_NEW = 4


def check_tp_families(device, card: str, mixtral_layers: int,
                      deepseek_layers: int, capacity: bool = True) -> dict:
    """The MoE and MLA families on a tp=2 mesh (two ranks on `device`
    over gloo, eager) against a tp=1 engine (graphs, warmed up) from the
    same seeded bf16 weights, through _tp_pair with its timing turns:
    mixtral-8x7b at full width in dense dispatch (both ranks must launch
    K1 and K3, and equally) and in capacity dispatch (the padded prefill
    programs: K1 alone), then deepseek-v2-lite at full width (MLA
    attention is plain torch: no kernel), each at its depth.  Each
    holds the first-token logits of a 512-token prompt within
    TP_LOGIT_TOL of tp=1's std and the four greedy streams' leading
    tokens (a parting only at a tp=1 near-tie or, MoE, a router
    near-tie).  The whole check runs it without the capacity pair
    (`capacity` False)."""
    from dynamo_tpu_torch.models.deepseek import PRESETS as DS
    from dynamo_tpu_torch.models.llama import PRESETS

    t0 = time.perf_counter()
    mix = dataclasses.replace(PRESETS["mixtral-8x7b"],
                              n_layers=mixtral_layers)
    k1 = {fn.__name__ for fn in _kernels_of("bf16")[:1]}
    out = {"mixtral_layers": mixtral_layers,
           "deepseek_layers": deepseek_layers}
    out["mixtral_dense"] = _tp_pair(device, card, mix, "bf16", timing=True,
                                    what="tp mixtral dense")
    gc.collect()
    if capacity:
        out["mixtral_capacity"] = _tp_pair(
            device, card, dataclasses.replace(mix, moe_dispatch="capacity"),
            "bf16", timing=True, what="tp mixtral capacity", kernels=k1)
        gc.collect()
    ds = dataclasses.replace(DS["deepseek-v2-lite"],
                             n_layers=deepseek_layers)
    out["deepseek"] = _tp_pair(device, card, ds, "bf16", timing=True,
                               what="tp deepseek-v2-lite", kernels=set())
    out["seconds"] = time.perf_counter() - t0
    log(f"tp families phase (mixtral {mixtral_layers} layers, deepseek "
        f"{deepseek_layers}) done in {out['seconds']:.1f} s ({card})")
    return out


def _tp_worker_kw(device, tp: int) -> dict:
    """A TorchEngineWorker's placement at tp: two ranks on `device` over
    gloo, eager and without warm-up (every warm-up dispatch would go
    through the step stream); tp=1 with its graphs, warmed up."""
    if tp == 1:
        return dict(device=device, warmup=True)
    return dict(device=device, devices=[device] * tp, cuda_graphs=False,
                warmup=False)


async def _tp_hop(what: str, card: str, prefill, decode, reqs, ref,
                  params, mc, device) -> dict:
    """The requests one at a time from the `prefill` worker (worker,
    client) to the `decode` one over host-staged frames (the broker off):
    the streams must equal the aggregated tp=1 `ref` (a parting only at
    a near-tie, _tp_streams on `params`, tp=1's weights), and the decode
    worker must prefill no token.  Logs pull GB/s (_pull_timer) and the
    prefill side's gather share of it (its extract_parked_chunk calls,
    a tp=2 side's slab gather over the ranks included)."""
    (pw, pclient), (dw, dclient) = prefill, decode
    gather_s = []
    extract = pw.engine.extract_parked_chunk

    async def timed_extract(request_id, start, count, **kw):
        t = time.perf_counter()
        arrs = await extract(request_id, start, count, **kw)
        gather_s.append(time.perf_counter() - t)
        return arrs

    pw.engine.extract_parked_chunk = timed_extract
    rec, restore = _pull_timer(dw.engine)
    pre0 = dw.engine.metrics["prefill_tokens"]
    blocks0 = dw.engine.metrics.get("pull_blocks", 0)
    try:
        with _broker_off(True):
            t0 = time.perf_counter()
            got = [await _disagg_one(pclient, dclient, r, t0) for r in reqs]
    finally:
        restore()
        pw.engine.extract_parked_chunk = extract
    block_bytes = dw.engine.kv_wire_layout(1).block_bytes()
    gb_s, secs = _transfer_gb_s(rec, block_bytes)
    pre = dw.engine.metrics["prefill_tokens"] - pre0
    blocks = dw.engine.metrics.get("pull_blocks", 0) - blocks0
    share = sum(gather_s) / secs if secs else 0.0
    log(f"{what}: {blocks} blocks pulled over host-staged frames at "
        f"{gb_s:.3f} GB/s ({secs:.3f} s), the prefill side's gathers "
        f"{sum(gather_s):.3f} s of it ({100 * share:.1f}%); decode worker "
        f"prefill tokens {pre} ({card})")
    if pre or blocks != sum(-(-len(r.token_ids) // 128) for r in reqs):
        raise SystemExit(f"{what}: the decode worker prefilled {pre} tokens "
                         f"and pulled {blocks} blocks")
    lead = _tp_streams(what, [g[:4] for g in got], ref, reqs, params, mc,
                       device)
    log(f"{what}: the streams' leading tokens equal to the aggregated tp=1 "
        f"engine's, of {TP_NEW}: {lead}")
    return {"leading": lead, "pull_gb_s": gb_s, "pull_s": secs,
            "gather_s": sum(gather_s), "gather_share": share,
            "blocks": blocks}


def _tp_hops(device, card: str, mc, kv_dtype: str, reqs,
             both: bool) -> dict:
    """A tp=1 worker (graphs, warmed up) and a tp=2 worker (two ranks on
    `device`) of cache `kv_dtype` on one runtime, random weights from seed
    0 on every rank: the requests one at a time through the tp=1 worker
    alone (the aggregated tp=1 reference), then, its prefix cache
    cleared, the tp=1 worker prefilling for the tp=2 one (_tp_hop) and,
    with `both`, the reverse.  The workers' role stays "both": each takes
    the prefill and the decode side in turn, the hand routing picks the
    side.  Returns each hop's numbers and the tp=2 side's rank 1
    launches."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    cfg = dataclasses.replace(_engine_config(kv_dtype), model_config=mc)

    async def run() -> dict:
        rt = await DistributedRuntime(config=RuntimeConfig(
            discovery_backend="mem", event_plane="inproc",
            tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
        sides, clients = {}, []
        out = {}
        try:
            for tp in (1, 2):
                t0 = time.perf_counter()
                kw = _tp_worker_kw(device, tp)
                comp = f"tp{tp}"
                w = await TorchEngineWorker(rt, dataclasses.replace(
                    cfg, tp=tp, warmup=kw.pop("warmup")), component=comp,
                    **kw).start()
                c = await rt.namespace("dynamo").component(comp).endpoint(
                    "generate").client().start()
                clients.append(c)
                await c.wait_for_instances()
                sides[tp] = (w, c)
                log(f"tp disagg {kv_dtype}: tp={tp} worker up in "
                    f"{time.perf_counter() - t0:.1f} s, "
                    f"{w.config.num_blocks} blocks, a rank's kv heads "
                    f"{w.engine.kv[0].shape[1]}")
            w1, c1 = sides[1]
            ref = [(await _serve_worker(c1, [r]))[0] for r in reqs]
            await w1.engine.clear_kv_blocks()
            params = w1.engine.params
            hops = [(1, 2), (2, 1)] if both else [(1, 2)]
            for p, d in hops:
                what = f"tp disagg {kv_dtype} tp{p}->tp{d}"
                out[f"{kv_dtype}_tp{p}_tp{d}"] = await _tp_hop(
                    what, card, sides[p], sides[d], reqs, ref, params, mc,
                    device)
                for w, _ in sides.values():
                    await w.engine.clear_kv_blocks()
        finally:
            for c in clients:
                await c.close()
            for w, _ in sides.values():
                await w.close()
            await rt.shutdown()
        out["rank1_launches"] = sides[2][0].engine.rank_launches.get(1, {})
        for w, _ in sides.values():
            _free_engine(w.engine)
        return out

    return asyncio.run(run())


async def _gather_blocks(eng, hashes) -> tuple:
    """The logical blocks `eng` holds in G1 under `hashes` (every rank's
    slab gathered, `_gather_kv`), on the host, as a scheduler op."""

    def gather():
        ids = [eng.allocator._hash_to_block[h] for h in hashes]
        return tuple(t.cpu() for t in eng._gather_kv(ids))

    return await eng._call_on_scheduler(gather)


def _tp_kvbm(device, card: str, mc) -> dict:
    """A tp=2 engine (two ranks on `device`, eager) with a G2 of 64 host
    blocks under a TP_KVBM_BLOCKS-block G1, the offload watermark at the
    pool: prompt A, A again at once (a G1 prefix hit plus its tail's
    prefill: the reference repeat), A's blocks gathered, the churn one at
    a time until A keeps no block in G1, then A again, which must onboard
    every full block of A from G2 (the ranks' slabs gathered on offload,
    the payload injected on every rank on onboard), hold them bit-equal
    to the gathered ones, prefill only the tail and stream the reference
    repeat's tokens (the same prefix bits, the same tail chunk).  Logs
    the repeat's TTFT against the cold one and the G1 hit's."""
    from dynamo_tpu_torch.engine import TorchEngine

    rng = np.random.default_rng(23)
    a = rng.integers(0, mc.vocab_size, TP_KVBM_PROMPT).tolist()
    churn = [rng.integers(0, mc.vocab_size, TP_KVBM_PROMPT).tolist()
             for _ in range(TP_KVBM_CHURN)]
    cfg = dataclasses.replace(
        _engine_config("bf16"), model_config=mc, tp=2,
        num_blocks=TP_KVBM_BLOCKS, offload_watermark_blocks=TP_KVBM_BLOCKS,
        host_cache_blocks=64)
    hashes = _a_hashes(a, cfg.block_size)

    def req(toks, rid):
        r = _greedy(toks, rid)
        return dataclasses.replace(r, stop=dataclasses.replace(
            r.stop, max_tokens=TP_KVBM_NEW))

    eng = TorchEngine(cfg, device=device, devices=[device, device],
                      cuda_graphs=False, mesh_timeout_s=TP_TIMEOUT_S)

    async def run():
        try:
            first = (await _serve(eng, [req(a, "tpkv-a1")]))[0]
            await _idle(eng)
            hit = (await _serve(eng, [req(a, "tpkv-a1-hit")]))[0]
            blocks = await _gather_blocks(eng, hashes)
            for i, p in enumerate(churn):
                await _serve(eng, [req(p, f"tpkv-c{i}")])
            kept = eng.allocator.lookup(hashes)
            await _idle(eng)
            m0 = dict(eng.metrics)
            again = (await _serve(eng, [req(a, "tpkv-a2")]))[0]
            m1 = dict(eng.metrics)
            back = await _gather_blocks(eng, hashes)
            return first, hit, again, kept, m0, m1, blocks, back
        finally:
            await eng.close()

    first, hit, again, kept, m0, m1, blocks, back = asyncio.run(run())
    onboarded = m1.get("kv_onboard_g2", 0) - m0.get("kv_onboard_g2", 0)
    prefilled = m1["prefill_tokens"] - m0["prefill_tokens"]
    half = blocks[0].shape[3] // 2
    same = [_same_payload(tuple(t[:, :, :, h] for t in blocks),
                          tuple(t[:, :, :, h] for t in back))
            for h in (slice(0, half), slice(half, None))]
    out = {"cold_ttft_s": first[2], "hit_ttft_s": hit[2],
           "repeat_ttft_s": again[2], "onboarded_blocks": onboarded,
           "repeat_prefill": prefilled, "kept_in_g1": kept,
           "offloaded_bytes": m1["offloaded_bytes"],
           "bit_equal_by_rank": same,
           "rank1_launches": eng.rank_launches.get(1, {})}
    log(f"tp kvbm: tp=2 engine, A ({len(a)} tokens, {len(hashes)} full "
        f"blocks) kept {kept} blocks in G1 before its repeat; the repeat "
        f"onboarded {onboarded} blocks from G2, bit-equal to the offloaded "
        f"ones on rank 0's / rank 1's kv heads: {same}, and prefilled "
        f"{prefilled} tokens; TTFT cold {first[2]:.3f} s, G1 hit "
        f"{hit[2]:.3f} s, G2 onboard {again[2]:.3f} s; "
        f"{m1['offloaded_bytes'] / 2**20:.0f} MiB offloaded ({card})")
    _free_engine(eng)
    if kept or onboarded != len(hashes) or not all(same) \
            or prefilled >= cfg.block_size or again[0] != hit[0]:
        raise SystemExit(f"tp kvbm: repeat {again[0]} against the G1 hit's "
                         f"{hit[0]}, {onboarded} of {len(hashes)} blocks "
                         f"onboarded, {kept} kept in G1, bit-equal {same}, "
                         f"{prefilled} tokens prefilled")
    return out


def check_tp_disagg(device, card: str, n_layers: int,
                    int8: bool = True) -> dict:
    """Disaggregation across tp at llama-8b width, `n_layers` deep (random
    bf16 weights from seed 0 on every side): on the bf16 cache a tp=1
    worker prefilling for a tp=2 worker and the reverse, and with `int8`
    tp=1 -> tp=2 on the int8 cache (_tp_hops), each against the tp=1
    worker's own aggregated streams; then a tp=2 engine's KVBM offload
    and onboard (_tp_kvbm).  The whole check runs it without the int8
    pair."""
    from dynamo_tpu_torch.models.llama import PRESETS

    t0 = time.perf_counter()
    mc = dataclasses.replace(PRESETS["llama-8b"], n_layers=n_layers)
    reqs = _tp_requests(mc.vocab_size)
    out = {"layers": n_layers}
    for kv_dtype in ("bf16", "int8") if int8 else ("bf16",):
        out[kv_dtype] = _tp_hops(device, card, mc, kv_dtype, reqs,
                                 both=kv_dtype == "bf16")
        gc.collect()
        torch.cuda.empty_cache()
    out["kvbm"] = _tp_kvbm(device, card, mc)
    left = _tp_ranks_left()
    if left:
        raise SystemExit(f"tp disagg: rank processes {left} left")
    out["seconds"] = time.perf_counter() - t0
    log(f"tp disagg phase ({n_layers} layers) done in {out['seconds']:.1f} "
        f"s ({card})")
    return out


# ---------------------------------------------------------------------------
# speculation, LoRA, the fused epilogue, guided decoding and embed on two
# ranks of one card
# ---------------------------------------------------------------------------

# greedy tokens a request of the tp features phase (the n-gram table
# probes a request at its first token, then 8 and 24 tokens on after a
# miss); the guided request's budget (the document is closed canonically
# when it runs out)
TPF_NEW = 24
TPF_GUIDED_NEW = 16
# the n-gram turn: two prompts that quote their own first token
# (_tpf_quoting), this many tokens each; a prompt grows by at most
# TPF_QUOTE_TRIES quotes
TPF_SPEC_NEW = 64
TPF_QUOTE_TRIES = 3
# the adapters: (name, rank, dtype, seed), rank 16 each
TPF_ADAPTERS = (("tpf-a", 16, "BF16", 11), ("tpf-b", 16, "F32", 12))
# embed calls timed after a first one, on a TPF_EMBED_TOKENS-token input
TPF_EMBED_CALLS = 3
TPF_EMBED_TOKENS = 100


def _tpf_requests(vocab: int, loras=(None,) * 4) -> list:
    """Four greedy requests, TPF_NEW tokens each: two repetition prompts
    (a 64-token pattern four times over) and two random ones (300 and
    37 tokens); request i on adapter loras[i] (None: the base model).
    The n-gram table proposes where a stream repeats itself, as these
    random-weight streams do now and then."""
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, vocab, 64).tolist() * 4 for _ in range(2)]
    prompts += [rng.integers(0, vocab, n).tolist() for n in (300, 37)]
    return [PreprocessedRequest(
        token_ids=p, request_id=f"tpf-{i}-{lo}", lora_name=lo,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=TPF_NEW, ignore_eos=True))
        for i, (p, lo) in enumerate(zip(prompts, loras))]


async def _tpf_quoting(eng, req) -> list:
    """A prompt on which the n-gram table proposes at its first probe:
    req's prompt P, then while the engine's first token for the prompt
    does not occur in it, that token and P again appended (the prompt
    still ends as P does, so where the next token leans on the last
    ones it stays the quoted one), at most TPF_QUOTE_TRIES times.  Each
    try is a one-token request."""
    toks = list(req.token_ids)
    for i in range(TPF_QUOTE_TRIES + 1):
        one = dataclasses.replace(
            req, token_ids=toks, request_id=f"{req.request_id}-quote{i}",
            stop=dataclasses.replace(req.stop, max_tokens=1))
        first = (await _serve(eng, [one]))[0][0][0]
        if first in toks or i == TPF_QUOTE_TRIES:
            return toks
        toks = toks + [first] + list(req.token_ids)


async def _tpf_gap(eng, req, stream, j: int) -> tuple:
    """The tp=2 engine's own logits for token j of `stream` (on req's
    adapter): the prompt and stream[:j] prefilled as one request through
    the engine (every rank), the first-token logits of its last prefill
    dispatch, gathered.  Returns (their top-2 gap, one bf16 ulp of the
    top logit)."""
    one = dataclasses.replace(
        req, token_ids=list(req.token_ids) + list(stream[:j]),
        request_id=f"{req.request_id}-gap{j}",
        stop=dataclasses.replace(req.stop, max_tokens=1))
    await _serve(eng, [one])
    T = next(r["bucket"] for r in reversed(eng.fpm)
             if r["kind"] == "prefill")
    top2 = torch.topk(eng.prefill_graphs.logits[T][0], 2).values
    return (top2[0] - top2[1]).item(), _ulp_bf16(top2[0].item())


async def _tpf_same(what: str, eng, got, ref, reqs) -> list:
    """Exit unless each stream of `got` equals `ref`'s, except a parting
    at a near-tie of the tp=2 engine's own logits there (_tpf_gap: the
    top-2 gap within one bf16 ulp of the top logit, the rule the
    single-device phases hold their streams to).  Returns the
    partings."""
    parted = []
    for g, r, req in zip(got, ref, reqs):
        if g[0] == r[0]:
            continue
        j = next((n for n, (a, b) in enumerate(zip(g[0], r[0])) if a != b),
                 min(len(g[0]), len(r[0])))
        if j == 0:
            raise SystemExit(f"{what}: {req.request_id}'s first token "
                             "differs")
        gap, ulp = await _tpf_gap(eng, req, r[0], j)
        parted.append((req.request_id, j, gap, ulp))
        log(f"{what}: {req.request_id} parts at token {j}: top-2 gap "
            f"{gap:.6f}, one bf16 ulp {ulp:.6f}")
        if gap > ulp:
            raise SystemExit(f"{what}: {req.request_id} parts at token {j} "
                             f"where the top-2 gap {gap} exceeds a bf16 ulp")
    return parted


def check_tp_features(device, card: str, n_layers: int,
                      rounds: int = 1) -> dict:
    """Speculative decoding (n-gram), LoRA (two synthesized rank-16
    adapters, lora_max_adapters 2), the fused sampling epilogue, guided
    decoding and embed on one tp=2 engine at llama-8b width and
    `n_layers` deep (random bf16 weights from seed 0, two ranks on
    `device` over gloo, eager), with a tp=2 engine of the same config
    but the epilogue off beside it.  Every program of either engine
    rides the step stream; the draft-free n-gram proposer, acceptance,
    the adapter registry and the guided choice are the leader's.

    * The epilogue: the four greedy requests (_tpf_requests) on the off
      and the fused engine in turns (off, fused, fused, off, `rounds`
      times; one round of off, fused with rounds = 0): the fused streams
      equal the off ones prompt by prompt (a parting only at a near-tie
      of the off engine's own logits, _tpf_same), and each path repeats
      its streams across its turns.  Decode tokens/s, TTFT and the
      n-gram acceptance of each turn; then the n-gram turn on the fused
      engine: the two repetition prompts made to quote their own first
      token (_tpf_quoting), TPF_SPEC_NEW tokens each.
    * LoRA on the fused engine: the requests on the base model and as a
      mixed batch (base, tpf-a, tpf-b, tpf-a) in turns (base, mixed,
      ...); each adapter stream differs from the base stream of its
      prompt, and the mixed batch's streams equal the same requests
      served apart: the base lane the base batch's, each adapter's
      request alone (a near-tie aside).
    * Guided: one greedy guided request (the LoRA phase's schema) on the
      fused engine: the output parses as a schema-valid document; the
      guided steps' host time (each _guided_step that dispatched).
    * Embed: TPF_EMBED_CALLS timed calls after a first one; the vector's
      cosine to a tp=1 engine's (the same weights) must be >= MIN_COSINE.
    * Every verify dispatch on rank 0 launches K3 once a layer at its
      verify stream on the rank's slab; each engine's rank 1 launches K1
      and K3, and rank 0's launches (both engines) equal the sum of the
      ranks 1's; after close no rank process is left.

    Returns the measurements and `launches` {"rank0": ..., "rank1": ...}
    (rank 1: both engines' followers)."""
    import tempfile

    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.guided import JsonSchemaGuide
    from dynamo_tpu_torch.models.llama import PRESETS
    from dynamo_tpu_torch.ops import launch_counts

    t_phase = time.perf_counter()
    mc = dataclasses.replace(PRESETS["llama-8b"], n_layers=n_layers)
    root = tempfile.mkdtemp(prefix="tp-lora-")
    for name, rank, dtype, seed in TPF_ADAPTERS:
        write_peft_adapter(root, name, mc, rank, dtype, seed)
    base = dataclasses.replace(
        _engine_config("bf16"), model_config=mc, tp=2, num_blocks=256,
        spec_decode="ngram", lora_max_adapters=2, lora_rank=16,
        lora_dir=root)
    wrappers = _kernels_of("bf16")
    kernels = {fn.__name__ for fn in wrappers}
    k3_name = wrappers[1].__name__ if wrappers else None
    names = [a[0] for a in TPF_ADAPTERS]
    plain = _tpf_requests(mc.vocab_size)
    mixed = _tpf_requests(mc.vocab_size, (None, names[0], names[1],
                                          names[0]))
    paths = (["off", "fused", "fused", "off"] * rounds if rounds
             else ["off", "fused"])

    async def run() -> dict:
        out = {"layers": n_layers}
        life = launch_counts()
        t0 = time.perf_counter()

        def build(path):
            return TorchEngine(
                dataclasses.replace(base, sampling_epilogue=path),
                device=device, devices=[device, device], cuda_graphs=False,
                mesh_timeout_s=TP_TIMEOUT_S)

        # both meshes at once: each waits ~12 s for its rank to spawn
        engines = dict(zip(("off", "fused"), await asyncio.gather(
            asyncio.to_thread(build, "off"),
            asyncio.to_thread(build, "fused"))))
        feat, off = engines["fused"], engines["off"]
        out["build_s"] = time.perf_counter() - t0
        log(f"tp features: two tp=2 engines (epilogue off and fused; "
            f"n-gram speculation, {len(names)} adapter slots of rank 16) "
            f"on {[str(device)] * 2} over {feat.mesh.backend}, up in "
            f"{out['build_s']:.1f} s; a rank's bank "
            f"{sum(t.numel() * t.element_size() for t in feat.lora_bank.values()) / 2**20:.0f} MiB")
        if not (feat.graphs.epilogue and feat.spec_enabled
                and feat.lora_bank is not None
                and feat.mesh.backend == "gloo"):
            raise SystemExit("tp features: the engine does not run every "
                             "feature on the mesh")
        verify = {"dispatches": 0}
        dispatch = feat._dispatch_verify

        def counted(a):
            verify["dispatches"] += 1
            with _launches_into(verify):
                return dispatch(a)

        feat._dispatch_verify = counted
        try:
            # the epilogue, in turns
            turns, streams = [], {"off": [], "fused": []}
            for path in paths:
                eng = engines[path]
                m0 = dict(eng.metrics)
                res = await _serve(eng, plain)
                await eng.clear_kv_blocks()
                bad = [r[1] for r in res if r[1] != "length"]
                if bad or any(len(r[0]) != TPF_NEW for r in res):
                    raise SystemExit(f"tp features {path}: finishes {bad}")
                n, secs = _decode_rate(res)
                prop = eng.metrics.get("spec_proposed", 0) - m0.get(
                    "spec_proposed", 0)
                acc = eng.metrics.get("spec_accepted", 0) - m0.get(
                    "spec_accepted", 0)
                turns.append({"path": path, "decode_tok_s": n / secs,
                              "ttft_s": sorted(r[2] for r in res),
                              "spec_proposed": prop, "spec_accepted": acc})
                streams[path].append(res)
                log(f"tp features turn {len(turns)} ({path}, {card}): "
                    f"decode {n / secs:.3f} tokens/s, TTFT "
                    f"{min(r[2] for r in res):.3f}-"
                    f"{max(r[2] for r in res):.3f} s, n-gram accepted "
                    f"{acc} of {prop}")
            for path, runs in streams.items():
                if any([r[0] for r in x] != [r[0] for r in runs[0]]
                       for x in runs):
                    raise SystemExit(f"tp features: the {path} streams "
                                     "differ between turns")
            out["turns"] = turns
            # the n-gram turn on the fused engine
            reps = [dataclasses.replace(
                r, request_id=r.request_id + "-spec",
                token_ids=await _tpf_quoting(feat, r),
                stop=dataclasses.replace(r.stop, max_tokens=TPF_SPEC_NEW))
                for r in plain[:2]]
            await feat.clear_kv_blocks()
            m0 = dict(feat.metrics)
            res = await _serve(feat, reps)
            await feat.clear_kv_blocks()
            n, secs = _decode_rate(res)
            spec = {k: feat.metrics.get(k, 0) - m0.get(k, 0)
                    for k in ("spec_steps", "spec_proposed",
                              "spec_accepted", "decode_tokens")}
            out["spec_turn"] = {"decode_tok_s": n / secs, **spec}
            log(f"tp features, n-gram turn ({card}): two prompts quoting "
                f"their first token ({[len(r.token_ids) for r in reps]} "
                f"tokens), {TPF_SPEC_NEW} tokens each: decode "
                f"{n / secs:.3f} tokens/s, {spec}")
            out["epilogue_parted"] = await _tpf_same(
                "tp features, fused against off", off, streams["fused"][0],
                streams["off"][0], plain)
            log(f"tp features: fused greedy streams equal to off for "
                f"{len(plain) - len(out['epilogue_parted'])} of "
                f"{len(plain)} prompts; partings "
                f"{out['epilogue_parted']}")
            # LoRA on the fused engine
            lturns, got = [], {}
            for which in (["base", "mixed"] * max(rounds, 1)):
                reqs = plain if which == "base" else mixed
                res = await _serve(feat, reqs)
                await feat.clear_kv_blocks()
                n, secs = _decode_rate(res)
                lturns.append({"batch": which, "decode_tok_s": n / secs})
                got.setdefault(which, res)
                log(f"tp features, lora turn {which} ({card}): decode "
                    f"{n / secs:.3f} tokens/s")
            out["lora_turns"] = lturns
            base_res, mixed_res = got["base"], got["mixed"]
            for i, req in enumerate(mixed):
                if req.lora_name and mixed_res[i][0] == base_res[i][0]:
                    raise SystemExit(f"tp features: {req.request_id}'s "
                                     "stream equals the base model's")
            # apart: the base lane in the base batch, each adapter alone
            apart = [base_res[0]] + [(await _serve(feat, [r]))[0]
                                     for r in mixed[1:3]]
            out["lora_parted"] = await _tpf_same(
                "tp features, mixed batch against apart", feat,
                mixed_res[:3], apart, mixed[:3])
            out["lora_slots"] = dict(feat._lora_slots)
            log(f"tp features: adapter slots {out['lora_slots']}; the "
                f"mixed batch equals the requests alone, partings "
                f"{out['lora_parted']}")
            # guided
            codec = MockTokenizer(mc.vocab_size)
            greq = dataclasses.replace(
                plain[3], request_id="tpf-guided",
                sampling=dataclasses.replace(plain[3].sampling,
                                             guided_json=GUIDED_SCHEMA),
                stop=dataclasses.replace(plain[3].stop,
                                         max_tokens=TPF_GUIDED_NEW,
                                         ignore_eos=False))
            host_s, step = [], feat._guided_step
            topm, dispatch_topm = [], feat._dispatch_guided

            def counted_topm(a, m):
                topm.append(m)
                return dispatch_topm(a, m)

            def timed_step():
                # the steps that dispatched a top-M program
                n, t = len(topm), time.perf_counter()
                step()
                if len(topm) > n:
                    host_s.append(time.perf_counter() - t)

            feat._guided_step = timed_step
            feat._dispatch_guided = counted_topm
            try:
                t1 = time.perf_counter()
                (gtoks, gfinish, _, _), = await _serve(feat, [greq])
                gwall = time.perf_counter() - t1
                # a scheduler op runs between steps: the step that ended
                # the stream has returned (and been timed)
                await feat._call_on_scheduler(lambda: None)
            finally:
                del feat._guided_step, feat._dispatch_guided
            text = codec.decode(gtoks)
            if gfinish != "stop" or not JsonSchemaGuide(
                    GUIDED_SCHEMA).done(text.strip()):
                raise SystemExit(f"tp features: guided output {text!r} "
                                 f"({gfinish}) is not a schema-valid "
                                 "document")
            json.loads(text)
            out["guided"] = {
                "text": text, "tokens": len(gtoks), "wall_s": gwall,
                "step_host_ms": float(np.median(host_s)) * 1e3,
                "steps": len(host_s), "top_m": topm,
                "forced_closes": feat.metrics.get("guided_forced_closes",
                                                  0)}
            log(f"tp features, guided ({card}): {out['guided']}")
            # embed
            etoks = plain[2].token_ids[:TPF_EMBED_TOKENS]
            vec = await feat.embed(etoks)
            ems = []
            for _ in range(TPF_EMBED_CALLS):
                t1 = time.perf_counter()
                again = await feat.embed(etoks)
                ems.append((time.perf_counter() - t1) * 1e3)
            if not np.array_equal(again, vec):
                raise SystemExit("tp features: two embed calls differ")
            out["embed_ms"] = float(np.median(ems))
            out["verify"] = dict(verify)
        finally:
            feat.__dict__.pop("_dispatch_verify", None)
            for eng in engines.values():
                await eng.close()
        leader = {k: v - life[k] for k, v in launch_counts().items()}
        follower = {k: sum(e.rank_launches.get(1, {}).get(k, 0)
                           for e in engines.values()) for k in leader}
        out["launches"] = {"rank0": leader, "rank1": follower}
        log(f"tp features: kernel launches by rank (both engines): "
            f"{out['launches']}; verify dispatches on rank 0 "
            f"{verify['dispatches']}, K3 launches in them "
            f"{verify.get(k3_name, 0)}")
        for name, eng in engines.items():
            r1 = eng.rank_launches.get(1, {})
            if not all(r1.get(k, 0) > 0 for k in kernels):
                raise SystemExit(f"tp features: the {name} engine's rank 1 "
                                 f"launched {r1}, not every one of "
                                 f"{kernels}")
        if leader != follower:
            raise SystemExit(f"tp features: the ranks launched different "
                             f"kernels {out['launches']}")
        if not verify["dispatches"] or k3_name is not None and verify.get(
                k3_name, 0) != n_layers * verify["dispatches"]:
            raise SystemExit(f"tp features: {verify['dispatches']} verify "
                             f"dispatches launched K3 "
                             f"{verify.get(k3_name, 0)} times")
        del feat, off, engines
        gc.collect()
        torch.cuda.empty_cache()
        left = _tp_ranks_left()
        if left:
            raise SystemExit(f"tp features: ranks {left} left after close")
        # the embedding's reference: a tp=1 engine on the same weights
        e1 = TorchEngine(dataclasses.replace(
            _engine_config("bf16"), model_config=mc, num_blocks=8),
            device=device)
        try:
            ref = await e1.embed(etoks)
        finally:
            await e1.close()
            _free_engine(e1)
        out["embed_cosine"] = float(np.dot(ref, vec) / (
            np.linalg.norm(ref) * np.linalg.norm(vec)))
        log(f"tp features, embed ({card}): {out['embed_ms']:.2f} ms a "
            f"{len(etoks)}-token call at tp=2 (median of "
            f"{TPF_EMBED_CALLS}); cosine to tp=1's "
            f"{out['embed_cosine']:.6f}")
        if not out["embed_cosine"] >= MIN_COSINE:
            raise SystemExit(f"tp features: embed cosine "
                             f"{out['embed_cosine']} < {MIN_COSINE}")
        return out

    out = asyncio.run(run())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"tp features phase ({n_layers} layers) done in "
        f"{out['seconds']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: the ring prefill on ranks of one card, and the
# pipeline primitive
# ---------------------------------------------------------------------------

# a prompt past the largest prefill bucket (2048): it pads to T_pad =
# 8192 (a pow2 multiple of sp x the smallest bucket), 4096 query rows a
# rank at sp = 2, and the short one stays on the packed path
SP_PROMPT = 5000
SP_SHORT = 300
SP_NEW = 16
# the sp engines' context (64 blocks of 128 tokens, 8192 positions) and
# pool (the long prompt's 40 blocks and the short one's, with room)
SP_BLOCKS_PER_SEQ = 64
SP_NUM_BLOCKS = 160
# the pipeline check: two stages of llama-8b's MLP, PP_MICRO
# microbatches of PP_TOKENS tokens
PP_MICRO = 4
PP_TOKENS = 256
PP_REL_TOL = 1e-3


def _sp_config(mc, **kw):
    """The sp phase's engine config: llama-8b's widths (`mc`), the
    default prefill buckets (largest 2048), four slots, the context
    raised to SP_BLOCKS_PER_SEQ blocks of 128, a bf16 cache of
    SP_NUM_BLOCKS blocks."""
    from dynamo_tpu_torch.engine import EngineConfig

    return EngineConfig(model_config=mc, block_size=128,
                        max_blocks_per_seq=SP_BLOCKS_PER_SEQ,
                        num_blocks=SP_NUM_BLOCKS, max_num_seqs=4,
                        max_batch_tokens=2048, max_prefill_seqs=4, seed=0,
                        **kw)


def _sp_requests(vocab: int) -> list:
    """The long greedy request and the short one, SP_NEW tokens each."""
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rng = np.random.default_rng(23)
    return [PreprocessedRequest(
        token_ids=rng.integers(0, vocab, n).tolist(), request_id=f"sp-{i}",
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=SP_NEW, ignore_eos=True))
        for i, n in enumerate((SP_PROMPT, SP_SHORT))]


def _ring_t_pad(cfg) -> int:
    """The engine's T_pad of the long prompt (engine/core.py
    _prefill_ring_one)."""
    g = cfg.sp * cfg.prefill_buckets[0]
    n = -(-SP_PROMPT // g)
    return (1 << (n - 1).bit_length()) * g


def _ring_bound(mc, T_pad: int, sp: int, rank: int) -> dict:
    """Ring rank `rank`'s least time for its ring prefill program
    (obs/costs.py ring_terms; `mc` the rank's shard config under tp):
    the larger of its bytes over HBM and its
    operations, the products over 989 TFLOP/s bf16 plus the fp32 ring
    attention over 67 TFLOP/s."""
    from dynamo_tpu_torch.obs.costs import ring_terms

    t = ring_terms(mc, T_pad, sp, rank, False)
    ops = (t["matmul_flops"] / BF16_FLOPS_PER_S
           + t["attn_flops"] / FP32_FLOPS_PER_S) * 1e3
    nbytes = (t["weight_bytes"] + t["kv_write_bytes"] + t["out_bytes"]) \
        / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "attn_share": t["attn_flops"] / FP32_FLOPS_PER_S * 1e3
            / max(ops, nbytes)}


async def _serve_one_by_one(eng, reqs) -> list:
    """Each request alone, in order (a ring prefill needs its prompt to
    be the only one prefilling)."""
    out = []
    for r in reqs:
        out += await _serve(eng, [r])
    return out


@contextlib.contextmanager
def _ring_logits(into: list):
    """Collect the logits the ring prefill returns in this process (ring
    rank 0's) into `into`."""
    from dynamo_tpu_torch.models import llama

    orig = llama.prefill_ring

    def spy(*a, **kw):
        logits, kv = orig(*a, **kw)
        if logits is not None:
            into.append(logits.float().clone())
        return logits, kv

    llama.prefill_ring = spy
    try:
        yield
    finally:
        llama.prefill_ring = orig


def _sp_mesh(device, card: str, mc, mesh: dict, ref: list,
             ref_logits: torch.Tensor, kernels: set,
             what: str, profile: bool = False) -> dict:
    """An engine on the mesh `mesh` (every rank on `device`, gloo, eager)
    serving the long and the short request one at a time, held to the
    tp=1 engine's streams `ref` and first-token logits `ref_logits`:
    ring_prefills 1 after the long prompt and after the short one; the
    ring's logits within TP_LOGIT_TOL std of tp=1's chunked ones; the
    streams' leading tokens equal (a parting only at a tp=1 near-tie);
    every rank launching each of `kernels`, all ranks alike; the card's
    memory back and no rank left after close; the long prompt served
    again cold (the prefix cache cleared) streams the same, through a
    second, warm ring call.  Logs each rank's ring program ms (CUDA
    events; first and warm) against its bound, the bytes it sent round
    the ring, its peak memory, and TTFT; with `profile`, rank 0's kernels
    in a third, warm ring call split by family (_profile_split)."""
    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.ops import launch_counts
    from dynamo_tpu_torch.parallel.mesh import shard_config

    reqs = _sp_requests(mc.vocab_size)
    world = mesh.get("tp", 1) * mesh["sp"]

    async def run() -> dict:
        out = {}
        gc.collect()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info(device)[0]
        torch.cuda.reset_peak_memory_stats(device)
        life, extra, logits = launch_counts(), {}, []
        t0 = time.perf_counter()
        eng = TorchEngine(_sp_config(mc, **mesh), devices=[device] * world,
                          cuda_graphs=False, mesh_timeout_s=TP_TIMEOUT_S)
        try:
            out["build_s"] = time.perf_counter() - t0
            log(f"{what}: {world} ranks on {[str(device)] * world}, ring "
                f"over {eng.mesh.ring.backend}, tensor groups over "
                f"{eng.mesh.backend if eng.mesh.tensor else 'none'} "
                f"(eager), up in {out['build_s']:.1f} s; "
                f"{eng.config.num_blocks} blocks, context "
                f"{eng.config.max_context}")
            with _ring_logits(logits):
                got = [(await _serve(eng, [reqs[0]]))[0]]
            out["ring_after_long"] = eng.metrics.get("ring_prefills", 0)
            got += await _serve(eng, [reqs[1]])
            out["ring_after_short"] = eng.metrics.get("ring_prefills", 0)
            log(f"{what}: ring_prefills {out['ring_after_long']} after the "
                f"{SP_PROMPT}-token prompt, {out['ring_after_short']} after "
                f"the {SP_SHORT}-token one")
            if (out["ring_after_long"], out["ring_after_short"]) != (1, 1) \
                    or len(logits) != 1:
                raise SystemExit(f"{what}: the long prompt did not take "
                                 "the ring prefill once, or the short one "
                                 "took it")
            std = ref_logits.std().item()
            diff = (logits[0] - ref_logits).abs().max().item()
            out["logit_diff_over_std"] = diff / std
            log(f"{what}: first-token logits of the {SP_PROMPT}-token "
                f"prompt, ring against tp=1's chunked prefill: max |diff| "
                f"{diff:.4f}, std {std:.4f}, {diff / std:.4f} std "
                f"(tolerance {TP_LOGIT_TOL}); argmax "
                f"{int(logits[0].argmax())} / {int(ref_logits.argmax())}")
            if not diff / std <= TP_LOGIT_TOL:
                raise SystemExit(f"{what}: logits {diff / std:.4f} std "
                                 "from tp=1's")
            with _launches_into(extra):  # replays on rank 0's weights
                out["leading"] = _tp_streams(what, got, ref, reqs,
                                             eng.params, mc, device)
            log(f"{what}: the streams' leading tokens equal to tp=1's, "
                f"of {SP_NEW}: {out['leading']}")
            out["ttft_s"] = got[0][2]
            # the long prompt again, cold (the prefix cache cleared): the
            # ring program warm, the same stream
            await eng.clear_kv_blocks()
            again = (await _serve(eng, [reqs[0]]))[0]
            if eng.metrics.get("ring_prefills", 0) != 2 \
                    or again[0] != got[0][0]:
                raise SystemExit(f"{what}: the repeated long prompt took "
                                 "no ring or streamed otherwise")
            out["warm_ttft_s"] = again[2]
            if profile:
                # once more, warm, under torch.profiler on this thread (the
                # engine idle, its step lock held)
                a = _ring_descriptor(eng, reqs[0])
                with eng._step_lock:
                    out["split"] = _profile_split(
                        lambda: eng._dispatch_ring(a), _ring_ranges(),
                        _ring_family, RING_FAMILIES,
                        f"{what}: rank 0's kernels in a warm ring prefill, "
                        f"under the profiler ({card})")
            out["peak_gib"] = {"rank0": torch.cuda.max_memory_allocated(
                device) / 2**30}
        finally:
            await eng.close()
        # each rank's ring calls: the first, the warm one (and the
        # profiled one)
        calls = {"rank0": list(eng.ring_calls_ms), **{
            f"rank{r}": m.get("ring_calls_ms", [])
            for r, m in eng.rank_metrics.items()}}
        out["ring_calls_ms"] = calls
        out["ring_ms"] = {k: v[0] for k, v in calls.items()}
        out["warm_ring_ms"] = {k: v[1] for k, v in calls.items()}
        out["ring_bytes"] = {"rank0": eng.metrics["ring_bytes"]
                             // len(calls["rank0"])}
        for r, m in eng.rank_metrics.items():
            out["ring_bytes"][f"rank{r}"] = \
                m.get("ring_bytes", 0) // len(calls[f"rank{r}"])
            out["peak_gib"][f"rank{r}"] = \
                m.get("max_memory_allocated", 0) / 2**30
        leader = {k: v - life[k] - extra.get(k, 0)
                  for k, v in launch_counts().items()}
        out["launches"] = {"rank0": leader, **{
            f"rank{r}": c for r, c in eng.rank_launches.items()}}
        log(f"{what}: kernel launches while serving, by rank: "
            f"{out['launches']}")
        for rank, counts in out["launches"].items():
            if not all(counts.get(k, 0) > 0 for k in kernels):
                raise SystemExit(f"{what}: {rank} launched {counts}, not "
                                 f"every one of {kernels}")
            if counts != leader:
                raise SystemExit(f"{what}: the ranks launched different "
                                 f"kernels {out['launches']}")
        T_pad = _ring_t_pad(eng.config)
        sp = mesh["sp"]
        local = shard_config(mc, mesh.get("tp", 1))
        for name, ms in out["ring_ms"].items():
            r = int(name[4:])
            b = _ring_bound(local, T_pad, sp, r % sp)
            out.setdefault("bound", {})[name] = b
            warm = out["warm_ring_ms"][name]
            log(f"{what}: {name} (ring rank {r % sp}) ring prefill of "
                f"T_pad {T_pad} ({T_pad // sp} rows) on the device's "
                f"timeline: first {ms:.1f} ms, warm {warm:.1f} ms; bound "
                f"{b['bound_ms']:.2f} ms ({b['bound_by']}; its fp32 ring "
                f"attention {b['attn_share']:.0%} of it) = "
                f"{b['bound_ms'] / warm:.1%} of the warm call; sent "
                f"{out['ring_bytes'][name] / 1e6:.1f} MB round the ring a "
                f"call; peak {out['peak_gib'][name]:.2f} GiB ({card})")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        left = _tp_ranks_left()
        # an exited rank's CUDA context may take a moment to be freed
        free1, t_free = torch.cuda.mem_get_info(device)[0], time.monotonic()
        while free1 < free0 - 2**30 and time.monotonic() - t_free < 20:
            time.sleep(0.5)
            free1 = torch.cuda.mem_get_info(device)[0]
        out["free_gib_before_after"] = (free0 / 2**30, free1 / 2**30)
        log(f"{what}: after close, rank processes left {left}; card memory "
            f"free {free0 / 2**30:.2f} GiB before the engine, "
            f"{free1 / 2**30:.2f} GiB after "
            f"{time.monotonic() - t_free:.1f} s")
        if left or free1 < free0 - 2**30:
            raise SystemExit(f"{what}: ranks {left} left or the card's "
                             "memory not back after close")
        return out

    return asyncio.run(run())


RING_FAMILIES = ("ring attention", "products", "other")


def _ring_ranges() -> dict:
    """_profile_split's ranges: ring_attention (models/llama.py imports
    it at each call, so the module attribute is what it finds)."""
    from dynamo_tpu_torch.ops import ring_attention as ring_mod

    return {(ring_mod, "ring_attention"): "ring_attention"}


def _ring_family(op, chain) -> Optional[str]:
    """_profile_split's classifier of a ring prefill: every kernel under
    ring_attention's range (its fp32 products, the online softmax's
    elementwise passes, the shards' copies to and from the host), the
    products outside it (projections, MLP, lm_head), and the rest
    (norms, rope, the cache writes, the embedding, the sampler)."""
    if op is None:
        return None
    if "ring_attention" in chain:
        return "ring attention"
    if op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"):
        return "products"
    return "other"


def _ring_descriptor(eng, req) -> dict:
    """`req`'s prompt (the long one) as the engine's prefill_ring step, on a
    table of zeros: every K/V write lands in the garbage block 0."""
    c = eng.config
    T_pad = _ring_t_pad(c)
    toks = np.zeros(T_pad, np.int32)
    toks[:len(req.token_ids)] = req.token_ids
    return {"toks": toks, "positions": np.arange(T_pad, dtype=np.int32),
            "block_table": np.zeros(c.max_blocks_per_seq, np.int32),
            "true_len": np.int32(len(req.token_ids)),
            "seed": np.int32(0), "temp": np.float32(0.0),
            "top_k": np.int32(0), "top_p": np.float32(1.0)}


# ring attention alone at the sp phase's shapes: llama-8b's heads, a
# T_pad of RING_T over two ranks, causal; timed RING_ITERS times after a
# warm call
RING_T = 8192
RING_ITERS = 3


def check_ring_attention(device, card: str) -> dict:
    """ops/ring_attention.py alone on the card: two ranks as threads of
    this process over a gloo ring (their kernels share the card's one
    stream, so the pair's wall is both ranks' work), bf16 q/k/v of
    llama-8b's heads (32 over 8, hd 128) at T = RING_T, causal.  Holds the
    ring's output to the plain version (`attention_reference`, fp32
    scores over the whole square) and to SDPA within REL_TOL per row,
    and logs the pair's ms (host clock, synchronized) against the bound
    of both ranks' fp32 attention (ring rank 0 one shard, rank 1 two) at
    67 TFLOP/s, beside the plain version's and one SDPA call's ms."""
    import datetime

    import torch.distributed as dist

    from dynamo_tpu_torch.models.llama import PRESETS
    from dynamo_tpu_torch.ops.ring_attention import (
        attention_reference,
        ring_attention,
    )
    from dynamo_tpu_torch.parallel.mesh import RingGroup

    cfg = PRESETS["llama-8b"]
    sp, T = 2, RING_T
    tq = T // sp
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v = (torch.randn(1, T, h, cfg.head_dim, generator=gen,
                           device=device).to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    store = dist.HashStore()
    groups = [None] * sp

    def pair(out=None):
        errs = []

        def rank(r):
            try:
                torch.cuda.set_device(device)
                if groups[r] is None:
                    groups[r] = RingGroup("gloo", dist.ProcessGroupGloo(
                        dist.PrefixStore("ring", store), r, sp,
                        datetime.timedelta(seconds=TP_TIMEOUT_S)), r, sp)
                o = ring_attention(q[:, r * tq:(r + 1) * tq],
                                   k[:, r * tq:(r + 1) * tq],
                                   v[:, r * tq:(r + 1) * tq], groups[r])
                torch.cuda.synchronize(device)
                if out is not None:
                    out[r] = o
            except BaseException as e:  # re-raised below
                errs.append(e)

        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(sp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TP_TIMEOUT_S)
        if errs or any(t.is_alive() for t in threads):
            raise SystemExit(f"ring attention: a rank failed or hung: "
                             f"{errs}")

    outs = [None] * sp
    pair(outs)  # warm, and the output checked
    walls = []
    for _ in range(RING_ITERS):
        t0 = time.perf_counter()
        pair()
        walls.append((time.perf_counter() - t0) * 1e3)
    got = torch.cat(outs, dim=1)
    kh, vh = (x.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
              .transpose(1, 2) for x in (k, v))

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kh, vh, is_causal=True).transpose(1, 2)

    def plain():
        return attention_reference(q, k, v)

    lib_out, ref = lib(), plain()
    err = (got.float() - ref.float()).abs().max().item()
    rel, rel_lib = row_rel_err(got, ref), row_rel_err(got, lib_out)
    del ref, lib_out
    lib_ms = time_ms(lib, iters=10, warmup=2)
    plain_ms = time_ms(plain, iters=2, warmup=1)
    torch.cuda.empty_cache()
    chunk = 2 * 2 * tq * tq * cfg.n_heads * cfg.head_dim
    flops = (1 + 2) * chunk  # ring rank 0 one shard, rank 1 two
    bound_ms = flops / FP32_FLOPS_PER_S * 1e3
    ms = float(np.median(walls))
    out = {"T": T, "sp": sp, "ms": ms, "walls_ms": walls,
           "bound_ms": bound_ms, "bound_by": "operations",
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "max_abs_err": err, "rel_err": rel, "rel_err_sdpa": rel_lib}
    log(f"ring attention alone (llama-8b heads 32 over 8, hd 128, T {T} "
        f"over {sp} ranks as threads, causal, bf16 in, fp32 scores): "
        f"median {ms:.2f} ms of {RING_ITERS} (host clock, both ranks), "
        f"bound {bound_ms:.2f} ms ({flops / 1e12:.3f} TFLOP fp32 at 67 "
        f"TFLOP/s) = {bound_ms / ms:.1%}; plain version {plain_ms:.2f} "
        f"ms, SDPA {lib_ms:.3f} ms; against the plain version max |diff| "
        f"{err:.3g}, per-row relative L2 {rel:.3g}, against SDPA {rel_lib:.3g}"
        f" (tolerance {REL_TOL}) ({card})")
    if not (rel <= REL_TOL and rel_lib <= REL_TOL):
        raise SystemExit("ring attention disagrees with its plain version "
                         "or SDPA")
    return out


def _sp_reference(device, card: str, mc, timing: bool) -> tuple:
    """The tp=1 engine (graphs, warmed up, with `timing`; else eager) on
    the same random weights: the two requests one at a time, chunked, and
    the long prompt's first-token logits (its last chunk's packed
    program).  Returns (results, logits, TTFT of the long prompt)."""
    from dynamo_tpu_torch.engine import TorchEngine

    reqs = _sp_requests(mc.vocab_size)

    async def run():
        e1 = TorchEngine(_sp_config(mc), device=device, cuda_graphs=timing)
        try:
            if timing:
                e1.warmup_decode()
            res = [(await _serve(e1, [reqs[0]]))[0]]
            last = [r for r in e1.fpm if r.get("bucket")][-1]["bucket"]
            logits = _first_logits(e1, last).float()
            res += await _serve(e1, [reqs[1]])
            log(f"sp reference: tp=1 {'graphs' if timing else 'eager'}, "
                f"the {SP_PROMPT}-token prompt chunked (last chunk's bucket "
                f"{last}), TTFT {res[0][2]:.3f} s ({card})")
        finally:
            await e1.close()
            _free_engine(e1)
        return res, logits

    return asyncio.run(run())


def _pp_stage(params, state, x, active):
    """One stage of the pipeline check: llama-8b's SwiGLU MLP as a
    residual block; its state counts the tokens it took."""
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return x + h @ params["w_down"], {
        "count": state["count"] + (x.shape[0] if active else 0)}


def check_pipeline(device, card: str) -> dict:
    """parallel/pipeline.py pipeline_apply with two stages as threads on
    `device` (a gloo ring of two, host-staged hops), at llama-8b's MLP
    widths in bf16 with random weights, against the sequential
    composition of the same stages: the outputs within PP_REL_TOL
    relative L2 per row, every stage's count PP_MICRO x PP_TOKENS.  Logs
    both times (CUDA events around each; one card does both stages, so
    the schedule buys no overlap here)."""
    import datetime

    import torch.distributed as dist

    from dynamo_tpu_torch.models.llama import PRESETS
    from dynamo_tpu_torch.parallel.mesh import RingGroup
    from dynamo_tpu_torch.parallel.pipeline import pipeline_apply

    cfg = PRESETS["llama-8b"]
    d, f, S = cfg.d_model, cfg.ffn_dim, 2
    gen = torch.Generator(device=device).manual_seed(7)

    def w(*shape, fan):
        return (torch.randn(shape, generator=gen, device=device)
                / fan ** 0.5).to(torch.bfloat16)

    params = {"w_gate": w(S, d, f, fan=d), "w_up": w(S, d, f, fan=d),
              "w_down": w(S, f, d, fan=f)}
    xs = torch.randn(PP_MICRO, PP_TOKENS, d, generator=gen,
                     device=device).to(torch.bfloat16)
    state = {"count": torch.zeros(S, dtype=torch.int64, device=device)}

    def sequential():
        ys = []
        for m in range(PP_MICRO):
            x = xs[m]
            for s in range(S):
                x, _ = _pp_stage({k: v[s] for k, v in params.items()},
                                 {"count": state["count"][s]}, x, True)
            ys.append(x)
        return torch.stack(ys)

    store = dist.HashStore()
    res, errs = [None] * S, []

    def stage(r):
        try:
            torch.cuda.set_device(device)
            pg = dist.ProcessGroupGloo(
                dist.PrefixStore("pp", store), r, S,
                datetime.timedelta(seconds=TP_TIMEOUT_S))
            res[r] = pipeline_apply(_pp_stage, params, state, xs,
                                    RingGroup("gloo", pg, r, S))
            torch.cuda.synchronize(device)
        except BaseException as e:  # re-raised below
            errs.append(e)

    ref = sequential()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=stage, args=(r,)) for r in range(S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TP_TIMEOUT_S)
    pp_ms = (time.perf_counter() - t0) * 1e3
    if errs or any(t.is_alive() for t in threads):
        raise SystemExit(f"pipeline: a stage failed or hung: {errs}")
    seq_ms = time_ms(sequential, iters=3, warmup=1)
    out = {"micro": PP_MICRO, "tokens": PP_TOKENS, "stages": S}
    rel = max(row_rel_err(ys, ref) for ys, _ in res)
    out["max_abs_err"] = max((ys.float() - ref.float()).abs().max().item()
                             for ys, _ in res)
    out["rel_err"] = rel
    counts = [int(st["count"][0]) for _, st in res]
    out.update(counts=counts, pipeline_ms=pp_ms, sequential_ms=seq_ms)
    log(f"pipeline: {S} stages of llama-8b's MLP (d {d}, ffn {f}, bf16) "
        f"as threads on {device}, {PP_MICRO} microbatches of {PP_TOKENS} "
        f"tokens: outputs against the sequential composition max |diff| "
        f"{out['max_abs_err']:.3g}, per-row relative L2 {rel:.3g} "
        f"(tolerance {PP_REL_TOL}); stage counts {counts}; pipelined "
        f"{pp_ms:.1f} ms (host clock, thread start to join, gloo hops "
        f"through the host) against sequential {seq_ms:.2f} ms ({card})")
    if not rel <= PP_REL_TOL or counts != [PP_MICRO * PP_TOKENS] * S:
        raise SystemExit(f"pipeline: outputs {rel} from the sequential "
                         f"composition or counts {counts}")
    return out


def check_sp(device, card: str, n_layers: int, tp_sp: bool = False) -> dict:
    """The sequence-parallel phase: a tp=1 engine (graphs, warmed up) and
    an sp=2 engine (rank 0 here, rank 1 spawned, both on `device` over
    gloo, eager) at llama-8b width and `n_layers` deep, random bf16
    weights from seed 0, the context raised to 8192 tokens; with `tp_sp`
    also a tp=2 x sp=2 engine (four ranks) at TP_LAYERS against an eager
    tp=1 one; ring attention alone; then the pipeline check."""
    from dynamo_tpu_torch.models.llama import PRESETS

    t0 = time.perf_counter()
    kernels = {fn.__name__ for fn in _kernels_of("bf16")}
    mc = dataclasses.replace(PRESETS["llama-8b"], n_layers=n_layers)
    out = {"layers": n_layers}
    ref, logits = _sp_reference(device, card, mc, timing=True)
    out["sp2"] = _sp_mesh(device, card, mc, {"sp": 2}, ref, logits,
                          kernels, "sp2", profile=True)
    out["sp2"]["tp1_ttft_s"] = ref[0][2]
    log(f"sp2: TTFT of the {SP_PROMPT}-token prompt {out['sp2']['ttft_s']:.3f}"
        f" s through the ring against {ref[0][2]:.3f} s chunked at tp=1 "
        f"({card})")
    del logits
    if tp_sp:
        mc4 = dataclasses.replace(mc, n_layers=TP_LAYERS)
        ref4, logits4 = _sp_reference(device, card, mc4, timing=False)
        out["tp2_sp2"] = _sp_mesh(device, card, mc4, {"tp": 2, "sp": 2},
                                  ref4, logits4, kernels, "tp2 x sp2")
        del logits4
    gc.collect()
    torch.cuda.empty_cache()
    out["ring_attention"] = check_ring_attention(device, card)
    out["pipeline"] = check_pipeline(device, card)
    out["seconds"] = time.perf_counter() - t0
    log(f"sp phase ({n_layers} layers) done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# multihost: a leader and a follower launcher of one tp=2 mesh
# ---------------------------------------------------------------------------

# seconds a launcher may take to load its weights and join, and to exit
# after the leader's drain
MH_READY_S = 600.0
MH_EXIT_S = 180.0
MH_BLOCKS = 64


def _mh_args(path: str, device) -> list:
    """The launchers' CLI arguments (both launchers take the same): the
    checkpoint at `path`, tp=2, eager (the ranks share a card: gloo), no
    warm-up (the leader's first requests build what they run)."""
    args = ["--model-path", path, "--tp", "2", "--no-cuda-graphs",
            "--no-warmup", "--block-size", "128",
            "--num-blocks", str(MH_BLOCKS), "--max-blocks-per-seq", "8",
            "--max-num-seqs", "4"]
    return args + (["--device", "cpu"] if device.type == "cpu" else [])


def _start_launcher(rank: int, args: list, env: dict, log_path: str):
    """`python -m dynamo_tpu_torch.engine` as launcher `rank` of 2, its
    log in `log_path`."""
    env = dict(env, DYN_MH_RANK=str(rank), DYN_MH_WORLD="2")
    with open(log_path, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.engine", *args],
            env=env, stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))


def _ready_line(proc, log_path: str, what: str, deadline: float) -> str:
    """The launcher's ready line; SystemExit with its log's tail when it
    exits or prints none before `deadline`."""
    import select

    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("ready "):
                return line.strip()
            if not line and proc.poll() is not None:
                break
    proc.kill()
    proc.wait()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    raise SystemExit(f"multihost: the {what} printed no ready line (exit "
                     f"{proc.returncode}):\n{tail}")


def _launcher_log(path: str) -> dict:
    """What a launcher's log says: its own launch counts at exit, and the
    leader's steps published and the ranks' reports."""
    import re

    with open(path) as f:
        text = f.read()
    out = {"text": text}
    for key, pat in (("launches", r"kernel launches at exit: (\{[^\n]*\})"),
                     ("rank_launches", r"rank launches at exit: (\{[^\n]*\})"),
                     ("rank_steps", r"rank steps replayed at exit: "
                                    r"(\{[^\n]*\})")):
        m = re.findall(pat, text)
        out[key] = json.loads(m[-1]) if m else None
    m = re.findall(r"steps published: (\d+)", text)
    out["published"] = int(m[-1]) if m else None
    m = re.findall(r"rank (\d+) replayed (\d+) steps", text)
    out["replayed"] = {int(r): int(n) for r, n in m}
    out["cache_written"] = "weight cache written" in text
    out["cache_read"] = "weights restored from host cache" in text
    m = re.findall(r"loaded \S+ from disk to \S+: \d+ tensors, ([\d.]+) GB "
                   r"in ([\d.]+) s", text)
    out["disk_load"] = [(float(a), float(b)) for a, b in m]
    m = re.findall(r"weights restored from host cache for \S+ to \S+: \d+ "
                   r"tensors, ([\d.]+) GB in ([\d.]+) s", text)
    out["cache_load"] = [(float(a), float(b)) for a, b in m]
    return out


async def _mh_serve(disc: str, reqs) -> tuple:
    """Through the launchers' file discovery: the instances a client
    finds (and the instance files), and the streams of `reqs` sent at
    once to the one instance."""
    import uuid

    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=disc,
        event_plane="inproc", tcp_host="127.0.0.1"),
        cluster_id=uuid.uuid4().hex).start()
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    try:
        ids = [i.instance_id for i in await client.wait_for_instances(60.0)]
        files = sorted({f[:-5] for _, _, fs in os.walk(
            os.path.join(disc, "v1", "instances")) for f in fs
            if f.endswith(".json")})
        got = await _serve_worker(client, reqs)
    finally:
        await client.close()
        await rt.shutdown()
    return ids, files, got


def check_multihost(device, card: str, n_layers: int,
                    ckpt: Optional[str] = None) -> dict:
    """The multihost phase: a llama-8b-width checkpoint of `n_layers`
    layers (random bf16 weights from seed 0) served by one tp=2 mesh
    spread over two launchers of `python -m dynamo_tpu_torch.engine`, two
    processes of this machine standing in for two hosts (DYN_MH_RANK 0 /
    1, DYN_MH_WORLD 2, JAX_COORDINATOR_ADDRESS on 127.0.0.1, the follower
    started first), ranks on the one card over gloo.  Checks: the
    follower's ready line; exactly one instance in discovery, the
    leader's; the four tp requests' greedy streams against a tp=1 engine
    on the same checkpoint (a parting only at a near-tie, _tp_streams);
    the leader's sharded load filled the weight cache and the follower
    read it; after the leader's drain both launchers exit 0, and the
    follower's K1/K3 launches, as the leader read them from the mesh's
    store, are non-zero and equal to the follower's own count and to the
    leader's (the same programs), with every published step replayed.
    `ckpt`: a checkpoint of `n_layers` layers written by the caller
    (write_checkpoint, seed 0), served in place of one written here."""
    import signal
    import socket
    import tempfile

    from dynamo_tpu_torch.engine import TorchEngine
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config
    from dynamo_tpu_torch.models.llama import PRESETS

    t0 = time.perf_counter()
    width = PRESETS["llama-8b"]
    kernels = [fn.__name__ for fn in _kernels_of("bf16")]
    out = {"layers": n_layers}
    with tempfile.TemporaryDirectory(prefix="multihost-") as tmp:
        path = ckpt or os.path.join(tmp, f"llama-8b-width-{n_layers}-layers")
        if ckpt is None:
            os.makedirs(path)
            write_checkpoint(path, width, n_layers, device)
        out["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
            if f.endswith(".safetensors")) / 1e9
        torch.cuda.empty_cache()
        log(f"multihost: checkpoint of {n_layers} layers at llama-8b width, "
            f"{out['checkpoint_gb']:.3f} GB, "
            + (f"written in {time.perf_counter() - t0:.1f} s" if ckpt is None
               else "the caller's"))
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        disc = os.path.join(tmp, "cluster")
        cache_dir = os.path.join(tmp, "weight-cache")
        env = dict(os.environ, DYN_DISCOVERY_BACKEND="file",
                   DYN_DISCOVERY_PATH=disc, DYN_EVENT_PLANE="inproc",
                   DYN_LOG_JSON="0", DYN_LOG_LEVEL="INFO",
                   DYN_WEIGHT_CACHE_DIR=cache_dir,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   DYN_MH_BARRIER_TIMEOUT_S=str(MH_READY_S))
        args = _mh_args(path, device)
        logs = {r: os.path.join(tmp, f"launcher{r}.log") for r in (0, 1)}
        procs = {}
        try:
            t1 = time.perf_counter()
            procs[1] = _start_launcher(1, args, env, logs[1])
            procs[0] = _start_launcher(0, args, env, logs[0])
            deadline = time.monotonic() + MH_READY_S
            fline = _ready_line(procs[1], logs[1], "follower", deadline)
            lline = _ready_line(procs[0], logs[0], "leader", deadline)
            out["ready_s"] = time.perf_counter() - t1
            log(f"multihost: {fline!r} and {lline!r} in "
                f"{out['ready_s']:.1f} s")
            if fline != "ready follower rank=1/2" \
                    or not lline.startswith("ready instance_id="):
                raise SystemExit(f"multihost: ready lines {fline!r}, "
                                 f"{lline!r}")
            lid = int(lline.split("=", 1)[1])
            reqs = _tp_requests(width.vocab_size)
            t1 = time.perf_counter()
            ids, files, got = asyncio.run(_mh_serve(disc, reqs))
            out["serve_s"] = time.perf_counter() - t1
            out["instances"] = ids
            log(f"multihost: discovery lists instances {ids} (instance "
                f"files {files}); the four requests through the leader in "
                f"{out['serve_s']:.1f} s ({card})")
            if ids != [lid] or files != [str(lid)]:
                raise SystemExit(f"multihost: discovery lists {ids} / "
                                 f"{files}, not the leader's {lid} alone")
            # the tp=1 reference on the same checkpoint (its load reads the
            # weight cache the leader filled)
            cfg1 = engine_config(build_args().parse_args(
                [a for a in args if a not in ("--tp", "2",
                                              "--no-cuda-graphs")]))

            async def reference():
                e1 = TorchEngine(cfg1, device=device, cuda_graphs=False)
                try:
                    res = await _serve(e1, reqs)
                    lead = _tp_streams("multihost", got, res, reqs,
                                       e1.params, e1.model_cfg, device)
                finally:
                    await e1.close()
                    _free_engine(e1)
                return lead

            prior = os.environ.get("DYN_WEIGHT_CACHE_DIR")
            os.environ["DYN_WEIGHT_CACHE_DIR"] = cache_dir
            try:
                out["leading"] = asyncio.run(reference())
            finally:
                if prior is None:
                    os.environ.pop("DYN_WEIGHT_CACHE_DIR")
                else:
                    os.environ["DYN_WEIGHT_CACHE_DIR"] = prior
            log(f"multihost: the four streams' leading tokens equal to "
                f"tp=1's, of {TP_NEW}: {out['leading']}")
            procs[0].send_signal(signal.SIGTERM)
            rcs = {}
            for r in (0, 1):
                try:
                    rcs[r] = procs[r].wait(timeout=MH_EXIT_S)
                except subprocess.TimeoutExpired:
                    raise SystemExit(f"multihost: launcher {r} did not exit "
                                     f"{MH_EXIT_S:.0f} s after the leader's "
                                     "drain") from None
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                p.stdout.close()
        lead_log, fol_log = _launcher_log(logs[0]), _launcher_log(logs[1])
    out["exit_codes"] = rcs
    mine = fol_log["launches"] or {}
    stored = (lead_log["rank_launches"] or {}).get("1", {})
    leader = lead_log["launches"] or {}
    out["launches"] = {"rank0": leader, "rank1": stored,
                       "rank1_own_log": mine}
    out["steps"] = {"published": lead_log["published"],
                    "replayed": (lead_log["rank_steps"] or {}).get("1"),
                    "replayed_own_log": fol_log["replayed"].get(1)}
    out["weight_cache"] = {
        "leader_wrote": lead_log["cache_written"],
        "follower_read": fol_log["cache_read"],
        "leader_disk_load_gb_s": lead_log["disk_load"],
        "follower_cache_load_gb_s": fol_log["cache_load"]}
    out["seconds"] = time.perf_counter() - t0
    log(f"multihost: exit codes {rcs}; launches by rank (rank 1 as the "
        f"leader read it from the store): {out['launches']}; steps "
        f"{out['steps']}; weight cache {out['weight_cache']}")
    if rcs != {0: 0, 1: 0}:
        raise SystemExit(f"multihost: exit codes {rcs}; follower log tail:"
                         f"\n{fol_log['text'][-3000:]}")
    if not all(stored.get(k, 0) > 0 for k in kernels) \
            or stored != mine or stored != leader:
        raise SystemExit(f"multihost: the follower's launches {stored} "
                         f"(its own log {mine}, the leader's {leader}); "
                         f"every one of {kernels} must be non-zero and the "
                         "three equal")
    st = out["steps"]
    if not (st["published"] and st["replayed"] == st["replayed_own_log"]
            == st["published"] - 1):
        raise SystemExit(f"multihost: steps {st}: the follower must replay "
                         "every step the leader published before its stop")
    if not (out["weight_cache"]["leader_wrote"]
            and out["weight_cache"]["follower_read"]):
        raise SystemExit(f"multihost: weight cache {out['weight_cache']}: "
                         "the leader's sharded load must fill it and the "
                         "follower's read it")
    log(f"multihost phase ({n_layers} layers) done in {out['seconds']:.1f} s")
    return out


# -- KServe, the profiler and the planner ------------------------------------

# the profiler's sweep of the bf16 worker's engine in the whole run
PROFILE_ISLS = (128, 1024)
PROFILE_CONCS = (1, 4)
PROFILE_OSL = 16
# the SLA inversion asked of the profile: targets at this multiple of
# the profile's own concurrency-1 ITL and TTFT, for this fleet load
PROFILE_TARGET_X = 2.0
PROFILE_ACTIVE = 8
PROFILE_RPS = 10.0


def _grpc_call(ch, name: str, resp_cls, stream: bool = False):
    from dynamo_tpu_torch.frontend.kserve import SERVICE

    make = ch.stream_stream if stream else ch.unary_unary
    return make(f"/{SERVICE}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)


def _infer_request(pb, model: str, text: str, rid: str, max_tokens: int):
    """A KServe text request with the HTTP greedy body's settings: its
    max_tokens, ignore_eos, temperature 0 (KServe's default)."""
    req = pb.ModelInferRequest(model_name=model, id=rid)
    t = req.inputs.add()
    t.name, t.datatype = "text_input", "BYTES"
    t.shape.append(1)
    t.contents.bytes_contents.append(text.encode())
    req.parameters["max_tokens"].int64_param = max_tokens
    req.parameters["ignore_eos"].bool_param = True
    return req


async def _first_token(spied: dict, rid: str, first) -> None:
    """Set `first` once the engine has emitted `rid`'s first token (the
    shape's gate for a unary RPC, whose answer comes whole)."""
    end = time.monotonic() + FRONTEND_WAIT_S
    while not spied.get(rid):
        if time.monotonic() > end:
            raise SystemExit(f"kserve: {rid} emitted no token within "
                             f"{FRONTEND_WAIT_S:.0f} s")
        await asyncio.sleep(0.005)
    first.set()


async def _kserve_phase(fe, rt, eng, iid: int, texts, refs, spied: dict,
                        used, params, mc) -> dict:
    """The KServe v2 gRPC service (frontend/kserve.py) on the frontend's
    ModelManager, with its HTTP service's resolver, as the CLI wires it.
    Liveness, readiness and metadata answer; an unknown model gets
    NOT_FOUND.  Then the five prompts, greedy with the settings KServe
    carries (32 tokens, ignore_eos, temperature 0), three times in the
    frontend phase's shape (_in_shape) on a cleared cache: streamed
    /v1/completions (the reference), ModelInfer and ModelStreamInfer,
    with K1/K3 launches counted around the two gRPC runs
    (`kserve_launches`).  Exits unless each gRPC text is the rendering of
    its own token ids and equals the HTTP text of the same prompt (a
    greedy stream may part only at a near-tie, _check_streams), exactly
    the stream's last response is final with finish reason "length", and
    both kernels launched at least layers x steps times.  Logs the gRPC
    first-response time beside the HTTP TTFT of the same request."""
    import grpc
    import grpc.aio

    from dynamo_tpu_torch.frontend import kserve_pb2 as pb
    from dynamo_tpu_torch.frontend.kserve import PLATFORM, KserveGrpcService

    t_phase = time.perf_counter()
    bs = eng.config.block_size
    tok = fe.pipeline.preprocessor.tokenizer
    svc = await KserveGrpcService(rt, fe.manager, host="127.0.0.1", port=0,
                                  resolver=fe.service._resolve_pipeline
                                  ).start()
    ch = grpc.aio.insecure_channel(f"127.0.0.1:{svc.bound_port}")

    async def gate():
        await fe.wait_blocks(iid, FRONTEND_LENGTHS[0] // bs,
                             "the first prompt's blocks")

    async def cleared():
        await eng.clear_kv_blocks()
        await fe.wait_blocks(iid, 0, "a cleared worker")

    async def unary(i, first):
        rid = f"ksu-{i}"
        waiter = (asyncio.create_task(_first_token(spied, rid, first))
                  if first is not None else None)
        t0 = time.perf_counter()
        resp = await _grpc_call(ch, "ModelInfer", pb.ModelInferResponse)(
            _infer_request(pb, fe.model, texts[i], rid, 32))
        if waiter is not None:
            await waiter
        return {"text": resp.outputs[0].contents.bytes_contents[0].decode(),
                "finish": resp.parameters["finish_reason"].string_param,
                "seconds": time.perf_counter() - t0}

    async def streamed(i, first):
        rid = f"kss-{i}"
        call = _grpc_call(ch, "ModelStreamInfer",
                          pb.ModelStreamInferResponse, stream=True)()
        t0 = time.perf_counter()
        await call.write(_infer_request(pb, fe.model, texts[i], rid, 32))
        await call.done_writing()
        parts, finals, ttft = [], [], None
        async for r in call:
            if r.error_message:
                raise SystemExit(f"kserve: {rid}: {r.error_message}")
            ir = r.infer_response
            if ttft is None:
                ttft = time.perf_counter() - t0
                if first is not None:
                    first.set()
            parts.append(ir.outputs[0].contents.bytes_contents[0].decode())
            finals.append(
                (ir.parameters["triton_final_response"].bool_param,
                 ir.parameters["finish_reason"].string_param))
        return {"text": "".join(parts), "finals": finals, "ttft": ttft}

    try:
        live = await _grpc_call(ch, "ServerLive", pb.ServerLiveResponse)(
            pb.ServerLiveRequest())
        ready = await _grpc_call(ch, "ServerReady", pb.ServerReadyResponse)(
            pb.ServerReadyRequest())
        mready = await _grpc_call(ch, "ModelReady", pb.ModelReadyResponse)(
            pb.ModelReadyRequest(name=fe.model))
        meta = await _grpc_call(ch, "ModelMetadata",
                                pb.ModelMetadataResponse)(
            pb.ModelMetadataRequest(name=fe.model))
        try:
            await _grpc_call(ch, "ModelInfer", pb.ModelInferResponse)(
                _infer_request(pb, "no-such-model", "x", "ks-nf", 4))
            missing = "OK"
        except grpc.aio.AioRpcError as e:
            missing = e.code().name
        if not (live.live and ready.ready and mready.ready
                and meta.platform == PLATFORM
                and [(t.name, t.datatype) for t in meta.inputs]
                == [("text_input", "BYTES")]
                and [(t.name, t.datatype) for t in meta.outputs]
                == [("text_output", "BYTES")] and missing == "NOT_FOUND"):
            raise SystemExit(f"kserve: live {live.live}, ready {ready.ready}"
                             f", model ready {mready.ready}, metadata "
                             f"{meta}, an unknown model {missing}")
        bodies = [_frontend_body(fe.model, t, f"ksh-{i}")
                  for i, t in enumerate(texts)]
        await cleared()
        http = await _in_shape(lambda i, first: fe.sse(bodies[i], first),
                               gate)
        m0 = dict(eng.metrics)
        for fn in used:
            fn.launches = 0
        await cleared()
        got_u = await _in_shape(unary, gate)
        await cleared()
        got_s = await _in_shape(streamed, gate)
        counts = {fn.__name__: fn.launches for fn in used}
        steps = {k: eng.metrics[k] - m0[k] for k in
                 ("decode_steps", "prefill_steps")}
    finally:
        await ch.close()
        await svc.close()
    for i in range(5):
        u, s = got_u[i], got_s[i]
        if u["text"] != _render(tok, spied[f"ksu-{i}"]) \
                or s["text"] != _render(tok, spied[f"kss-{i}"]):
            raise SystemExit(f"kserve: request {i}'s text is not the "
                             "rendering of its own token ids")
        if u["finish"] != "length" or s["finals"][-1] != (True, "length") \
                or any(f for f, _ in s["finals"][:-1]) \
                or len(spied[f"ksu-{i}"]) != 32:
            raise SystemExit(f"kserve: request {i}: unary finish "
                             f"{u['finish']}, stream finals {s['finals']}")
    parted = _check_streams(
        "kserve", [(spied[f"ksu-{i}"],) for i in range(5)]
        + [(spied[f"kss-{i}"],) for i in range(5)],
        [(spied[f"ksh-{i}"],) for i in range(5)] * 2, list(refs) * 2,
        params, mc, eng.device)
    off = {p[0] % 5 for p in parted}
    same = [got_u[i]["text"] == http[i]["text"] == got_s[i]["text"]
            for i in range(5)]
    if not all(same[i] for i in range(5) if i not in off):
        raise SystemExit(f"kserve: ModelInfer, ModelStreamInfer and "
                         f"/v1/completions texts equal per request: {same}")
    _check_worker_launches(counts, steps, mc.n_layers, "kserve")
    ttft = [(round(http[i]["ttft"], 4), round(got_s[i]["ttft"], 4),
             round(got_u[i]["seconds"], 4)) for i in range(5)]
    secs = time.perf_counter() - t_phase
    log(f"kserve ({len(parted)} greedy parting(s) at a near-tie): per "
        f"request, HTTP TTFT s / ModelStreamInfer first response s / "
        f"ModelInfer whole answer s: {ttft}; stream responses "
        f"{[len(s['finals']) for s in got_s]}; metadata platform "
        f"{meta.platform!r}; an unknown model {missing}; kserve_launches "
        f"{counts} over steps {steps}; phase {secs:.1f} s")
    return {"launches": counts, "ttft": ttft, "parted": parted,
            "steps": steps, "seconds": secs}


class _Recorded:
    """An engine wrapper for the profiler's sweep: every request's id,
    prompt length, max_tokens and the tokens it got."""

    def __init__(self, engine):
        self.engine = engine
        self.kv_dtype = engine.kv_dtype
        self.seen = []

    async def generate(self, req):
        rec = [req.request_id, len(req.token_ids), req.stop.max_tokens, 0]
        self.seen.append(rec)
        async for out in self.engine.generate(req):
            rec[3] += len(out.token_ids)
            yield out


async def _profiler_phase(eng, used) -> dict:
    """The profiler (profiler/profile.py profile_engine) sweeping the
    worker's engine: ISL PROFILE_ISLS x concurrency PROFILE_CONCS, OSL
    PROFILE_OSL, one round, its warm-up point first, with K1/K3 launches
    counted around the sweep (`profiler_launches`).  Gates on structure,
    not speed: every request gets its max_tokens, both kernels launch,
    the profile is tagged bf16 with the grid asked for, its JSON
    round-trips through a file byte for byte, and the PerfModel built
    from it answers the SLA inversion (targets PROFILE_TARGET_X times its
    own concurrency-1 ITL and TTFT) with a finite replica count for
    PROFILE_ACTIVE active sequences and PROFILE_RPS requests/s.  Logs
    every grid point."""
    import math
    import tempfile

    from dynamo_tpu_torch.planner import PerfModel
    from dynamo_tpu_torch.profiler import PerfProfile, profile_engine

    t0 = time.perf_counter()
    rec = _Recorded(eng)
    for fn in used:
        fn.launches = 0
    prof = await profile_engine(rec, model_name="llama-8b",
                                isls=PROFILE_ISLS, osl=PROFILE_OSL,
                                concurrencies=PROFILE_CONCS, rounds=1)
    counts = {fn.__name__: fn.launches for fn in used}
    sweep_s = time.perf_counter() - t0
    short = [r for r in rec.seen if r[3] != r[2]]
    want = 1 + len(PROFILE_ISLS) * sum(PROFILE_CONCS)
    with tempfile.TemporaryDirectory(prefix="profile-") as tmp:
        path = os.path.join(tmp, "profile.json")
        prof.save(path)
        with open(path, "rb") as f:
            written = f.read()
        PerfProfile.load(path).save(path)
        with open(path, "rb") as f:
            again = f.read()
    pm = PerfModel(PerfProfile.from_json(written.decode()))
    c1 = {p.isl: p for p in prof.points if p.concurrency == 1}
    itl_t = PROFILE_TARGET_X * c1[PROFILE_ISLS[0]].itl_mean_s
    ttft_t = PROFILE_TARGET_X * c1[PROFILE_ISLS[-1]].ttft_p95_s
    cap = pm.max_active_for_itl(itl_t, PROFILE_ISLS[0])
    rps = pm.max_rps_for_ttft(PROFILE_ISLS[-1], ttft_t)
    n_itl = math.ceil(PROFILE_ACTIVE / cap)
    n_ttft = math.ceil(PROFILE_RPS / rps)
    for p in prof.points:
        log(f"profiler: isl {p.isl} c {p.concurrency}: TTFT p50/p95 "
            f"{p.ttft_p50_s * 1e3:.1f}/{p.ttft_p95_s * 1e3:.1f} ms, ITL "
            f"mean/p95 {p.itl_mean_s * 1e3:.2f}/{p.itl_p95_s * 1e3:.2f} ms, "
            f"{p.req_per_s:.2f} req/s, {p.output_tok_per_s:.1f} tokens/s")
    log(f"profiler: {len(rec.seen)} requests in {sweep_s:.1f} s, "
        f"profiler_launches {counts}; SLA inversion: ITL target "
        f"{itl_t * 1e3:.2f} ms -> {cap:.2f} active a replica -> {n_itl} "
        f"replicas for {PROFILE_ACTIVE}; TTFT target {ttft_t * 1e3:.1f} ms "
        f"at ISL {PROFILE_ISLS[-1]} -> {rps:.2f} req/s a replica -> "
        f"{n_ttft} replicas for {PROFILE_RPS} req/s")
    if short or len(rec.seen) != want:
        raise SystemExit(f"profiler: {len(rec.seen)} requests (want {want});"
                         f" short of their max_tokens: {short}")
    if not all(n > 0 for n in counts.values()):
        raise SystemExit(f"profiler: launches {counts}: the sweep did not "
                         "run through both kernels")
    if written != again or prof.meta.get("kv_cache_dtype") != "bf16" \
            or [(p.isl, p.concurrency) for p in prof.points] != [
                (i, c) for i in PROFILE_ISLS for c in PROFILE_CONCS]:
        raise SystemExit(f"profiler: the profile's JSON did not round-trip "
                         f"or its grid/tag is off: {prof.meta}")
    if not (0 < cap < math.inf and 0 < rps < math.inf
            and 0 < n_itl < 10**6 and 0 < n_ttft < 10**6):
        raise SystemExit(f"profiler: the SLA inversion answered capacity "
                         f"{cap}, rate {rps}")
    return {"launches": counts, "points": [p.to_dict() for p in prof.points],
            "replicas": (n_itl, n_ttft), "seconds": sweep_s}


# the planner phase: the multihost phase's llama-8b-width checkpoint of
# TP_LAYERS layers in the whole run (its own of 32 under --planner),
# workers of 64 blocks of 128 tokens
PLANNER_BLOCKS = 64
PLANNER_CLIENTS = 4        # the closed loop's concurrent requests
PLANNER_PROMPT = 200
PLANNER_NEW = 32
PLANNER_TAIL_NEW = 256     # the streams in flight at the scale-down
PLANNER_DRAIN_S = 0.1      # the workers' --drain-deadline-s
PLANNER_READY_S = 300.0
PLANNER_EXIT_S = 120.0
PLANNER_TOKEN = "chip-smoke-admin"
PLANNER_PROFILE_S = 900.0


def _planner_args(path: str, device) -> list:
    """The spawned workers' CLI arguments: the checkpoint, a 64-block
    bf16 cache, no warm-up (each program is captured at its first use),
    a PLANNER_DRAIN_S drain grace."""
    args = ["--model-path", path, "--block-size", "128",
            "--num-blocks", str(PLANNER_BLOCKS), "--max-blocks-per-seq", "16",
            "--max-num-seqs", "4", "--no-warmup",
            "--drain-deadline-s", str(PLANNER_DRAIN_S)]
    return args + (["--device", "cpu"] if device.type == "cpu" else [])


def _byte_tokenizer_json() -> dict:
    """A byte-level BPE tokenizer.json with no merges, each of the 256
    bytes one token (its id the byte's value), that `tokenizers` loads:
    write_checkpoint's minimal one is for the loader, not the frontend."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("\xa1"), ord("\xac") + 1),
          *range(ord("\xae"), ord("\xff") + 1)]
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    level = {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [], "normalizer": None, "pre_tokenizer": level,
            "post_processor": None, "decoder": dict(level,
                                                   add_prefix_space=True),
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": {chr(c): b for b, c in zip(bs, cs)},
                      "merges": []}}


def _planner_request(rid: str, gen, vocab: int, n_new: int):
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    ids = torch.randint(3, vocab, (PLANNER_PROMPT,), generator=gen)
    return PreprocessedRequest(
        token_ids=ids.tolist(), request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=n_new, ignore_eos=True))


async def _pipeline_stream(pipeline, req, into: list) -> list:
    """`req` through the frontend's pipeline (its KV router, migration by
    token replay), each token appended to `into` as it arrives."""
    async for out in pipeline.migration.generate(req):
        if out.finish_reason == "error":
            raise SystemExit(f"planner: {req.request_id}: {out.error}")
        into.extend(out.token_ids)
    return into


class _Proposals:
    """A connector that reports the live fleet's size and records what
    it is asked to scale to, applying nothing (the SLA planner's dry
    run beside the load planner that owns the fleet)."""

    def __init__(self, fleet_conn):
        self.fleet_conn = fleet_conn
        self.asked: list = []

    async def current_replicas(self) -> int:
        return await self.fleet_conn.current_replicas()

    async def scale(self, replicas: int) -> int:
        self.asked.append(replicas)
        return replicas

    drain = scale


async def _await_until(pred, what: str, timeout: float) -> None:
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise SystemExit(f"planner: {what} never came within "
                             f"{timeout:.0f} s")
        await asyncio.sleep(0.02)


async def _kube_scale() -> dict:
    """The planner's KubernetesConnector against FakeKubeApi's
    deployments/{name}/scale route: read, scale up, drain down."""
    from dynamo_tpu_torch.planner.connectors import KubernetesConnector

    fake = await FakeKubeApi().start()
    fake.deployments["worker"] = 1
    conn = KubernetesConnector("worker", namespace=K8S_NAMESPACE,
                               api_url=fake.endpoint, token=K8S_TOKEN)
    try:
        seen = [await conn.current_replicas(), await conn.scale(2),
                await conn.current_replicas(), await conn.drain(1)]
    finally:
        await conn.close()
        await fake.close()
    if seen != [1, 2, 2, 1] or fake.scale_calls != [
            ("GET", None), ("PATCH", 2), ("GET", None), ("PATCH", 1)]:
        raise SystemExit(f"planner: KubernetesConnector read/scaled "
                         f"{seen}, the API server saw {fake.scale_calls}")
    return {"replicas": seen, "calls": fake.scale_calls}


class _BasePlus:
    """The planner's fleet: a first replica that runs in this process
    (the base, its weights the near-tie replays' too) and the replicas a
    SubprocessConnector spawns past it.  The planner sees one fleet: a
    scale to n keeps the base and asks the subprocess connector for
    n - 1; its drain-gated scale-down is the subprocess connector's
    (SIGTERM: the worker's own drain)."""

    def __init__(self, sub):
        self.sub = sub
        self.governor = sub.governor

    @property
    def drain_escalations(self) -> int:
        return self.sub.drain_escalations

    async def current_replicas(self) -> int:
        return 1 + await self.sub.current_replicas()

    async def scale(self, replicas: int) -> int:
        return 1 + await self.sub.scale(max(replicas - 1, 0))

    async def drain(self, replicas: int) -> int:
        return 1 + await self.sub.drain(max(replicas - 1, 0))

    async def close(self) -> None:
        await self.sub.close()


def write_planner_checkpoint(path: str, n_layers: int, device) -> None:
    """write_checkpoint's llama-8b-width checkpoint of `n_layers` layers
    (seed 0) in `path`, with a byte-level tokenizer.json the frontend
    can build."""
    from dynamo_tpu_torch.models.llama import PRESETS

    os.makedirs(path)
    write_checkpoint(path, PRESETS["llama-8b"], n_layers, device)
    torch.cuda.empty_cache()
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(_byte_tokenizer_json(), f)


def check_planner(device, card: str, n_layers: int, full: bool = False,
                  ckpt: Optional[str] = None) -> dict:
    """The planner phase: a llama-8b-width checkpoint of `n_layers` layers
    (write_planner_checkpoint; `ckpt`: one the caller wrote) behind
    the port's frontend in kv mode (_Frontend) over file discovery and
    the zmq event plane.  The fleet's first replica is a TorchEngineWorker
    of this process on the checkpoint (the engine CLI's config); the
    planner's SubprocessConnector spawns `python -m
    dynamo_tpu_torch.engine --model-path` past it (_BasePlus).  Manual
    ticks of the load-mode planner (min 1, max 2, two active sequences a
    replica): a closed loop of PLANNER_CLIENTS requests through the
    frontend's pipeline must grow the fleet from 1 to 2, and the spawned
    worker must register and take requests (a routed decision naming
    it).  Then the load ends: both workers' caches are cleared, two long
    streams are sent (the router balances them over the two workers)
    and, once the spawned worker's has emitted tokens and the load
    samples show only the tails, a tick must drain it (SIGTERM: the
    worker withdraws, waits PLANNER_DRAIN_S, ends the rest with the
    migratable marker) back to 1, and it exits 0.  Every tail equals
    its reference, served one at a time before the scale-up; a stream
    that migrated by token replay after j tokens equals it up to j, and
    past j a fresh request of its prompt and those j tokens served
    alone (each a parting only at a near-tie).  Both workers launch K1
    and K3 (`planner_launches`: the base's counters, the spawned
    worker's log at exit).  With `full` (--planner alone): the
    profiler's CLI first sweeps JAX's default grid on the same
    checkpoint, an SLA-mode planner fed by that profile and a fleet
    observer (`--fleet-scrape`: the workers' status servers) ticks
    beside the load planner, which carries the fleet summary in its
    diag, and a KubernetesConnector scales a Deployment on FakeKubeApi.
    Logs the time to scale up, from spawn to registration and to the
    first routed request, and the drain."""
    import re
    import tempfile

    from dynamo_tpu_torch.models.llama import PRESETS

    t0 = time.perf_counter()
    kernels = [fn.__name__ for fn in _kernels_of("bf16")]
    out = {"layers": n_layers}
    gen = torch.Generator().manual_seed(24)
    refs = [_planner_request(f"tail-{i}", gen, PRESETS["llama-8b"].vocab_size,
                             PLANNER_TAIL_NEW) for i in range(2)]
    with tempfile.TemporaryDirectory(prefix="planner-") as tmp:
        path = ckpt or os.path.join(tmp, f"llama-8b-width-{n_layers}-layers")
        if ckpt is None:
            write_planner_checkpoint(path, n_layers, device)
        out["checkpoint_s"] = time.perf_counter() - t0
        disc = os.path.join(tmp, "cluster")
        env = dict(DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=disc,
                   DYN_EVENT_PLANE="zmq", DYN_LOG_JSON="0",
                   DYN_LOG_LEVEL="INFO", DYN_SYSTEM_PORT="-1",
                   DYN_ADMIN_TOKEN=PLANNER_TOKEN,
                   DYN_WEIGHT_CACHE_DIR=os.path.join(tmp, "weight-cache"))
        profile = None
        if full:
            profile = os.path.join(tmp, "profile.json")
            t1 = time.perf_counter()
            with _environ(**env):
                prof = subprocess.run(
                    [sys.executable, "-m", "dynamo_tpu_torch.profiler",
                     "--engine", "torch", "--model-path", path, "--out",
                     profile] + (["--device", "cpu"] if device.type == "cpu"
                                 else []),
                    capture_output=True, text=True,
                    timeout=PLANNER_PROFILE_S,
                    cwd=os.path.dirname(os.path.abspath(__file__)))
            out["profile_cli_s"] = time.perf_counter() - t1
            if prof.returncode != 0:
                raise SystemExit(f"planner: the profiler CLI exited "
                                 f"{prof.returncode}:\n{prof.stderr[-3000:]}")
            log(f"planner: the profiler CLI on the {n_layers}-layer "
                f"checkpoint, JAX's default grid, in "
                f"{out['profile_cli_s']:.1f} s ({card}):\n"
                + prof.stdout.strip())
            from dynamo_tpu_torch.profiler import PerfProfile

            pts = PerfProfile.load(profile).points
            if len(pts) != 15 or not all(
                    p.ttft_p95_s > 0 and p.itl_mean_s > 0 for p in pts):
                raise SystemExit(f"planner: the profiler CLI's profile has "
                                 f"{len(pts)} points, some without "
                                 "latencies (failed requests)")
        with _environ(**env):
            res = asyncio.run(_planner_cycle(
                device, disc, path, refs, profile, tmp, full))
        logs = res.pop("logs")
        out.update(res)
        with open(logs[res["victim_pid"]]) as f:
            text = f.read()
        m = re.findall(r"kernel launches at exit: (\{[^\n]*\})", text)
        if not m:
            raise SystemExit(f"planner: the spawned worker logged no "
                             f"launches at exit:\n{text[-3000:]}")
        out["launches"] = [res["base_launches"], json.loads(m[-1])]
    out["seconds"] = time.perf_counter() - t0
    log(f"planner ({n_layers} layers, {card}): checkpoint "
        f"{out['checkpoint_s']:.1f} s; the base worker ready in "
        f"{out['base_ready_s']:.1f} s; scale-up {out['scale_up_s']:.2f} s "
        f"after the load began (decision {out['up_decision']}); spawn to "
        f"registered {out['spawn_to_registered_s']:.2f} s, to its first "
        f"routed request {out['spawn_to_routed_s']:.2f} s; drain "
        f"{out['drain_s']:.2f} s (victim exit {out['victim_exit']}; "
        f"migrated after {out['migrated']} tokens by tail); "
        f"{len(out['parted'])} parting(s) at a near-tie; planner_launches "
        f"{out['launches']}; phase {out['seconds']:.1f} s")
    if out["victim_exit"] != 0:
        raise SystemExit(f"planner: the drained worker exited "
                         f"{out['victim_exit']}")
    if not all(w.get(k, 0) > 0 for w in out["launches"] for k in kernels):
        raise SystemExit(f"planner: launches {out['launches']}: both "
                         f"workers must launch each of {kernels}")
    return out


async def _planner_cycle(device, disc: str, path: str, refs, profile,
                         tmp: str, full: bool) -> dict:
    """check_planner's fleet, from the base worker's start to the close."""
    import math
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config
    from dynamo_tpu_torch.obs.fleet import FleetObserver
    from dynamo_tpu_torch.planner import (
        PerfModel,
        Planner,
        PlannerConfig,
        SubprocessConnector,
    )
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    res = {}
    used = _kernels_of("bf16")
    args = _planner_args(path, device)
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=disc, event_plane="zmq",
        tcp_host="127.0.0.1", system_port=-1, admin_token=PLANNER_TOKEN),
        cluster_id=uuid.uuid4().hex).start()
    sub = SubprocessConnector("dynamo_tpu_torch.engine", args,
                              term_grace_s=PLANNER_EXIT_S, log_dir=tmp)
    conn = _BasePlus(sub)
    fleet = (await FleetObserver(runtime=rt, interval_s=0.5,
                                 token=PLANNER_TOKEN).start()
             if full else None)
    planner = Planner(rt, "dynamo", "backend", conn, fleet=fleet,
                      config=PlannerConfig(
                          min_replicas=1, max_replicas=2, cooldown_s=0.0,
                          target_active_per_replica=2.0,
                          down_stable_ticks=1, predictor="constant",
                          quarantine=False))
    base = fe = sla = None
    prefix = "v1/instances/dynamo/backend/generate"
    try:
        for fn in used:
            fn.launches = 0
        t_base = time.perf_counter()
        base = await TorchEngineWorker(
            rt, engine_config(build_args().parse_args(args)),
            device=device).start()
        first_iid = base.served.instance_id
        res["base_ready_s"] = time.perf_counter() - t_base
        fe = await _Frontend.attach(rt)
        pipeline = fe.pipeline
        routed: list = []
        split: dict = {}
        tails: list = []
        record = fe.router._record_decision

        def note(request_id, *a, **kw):
            d = record(request_id, *a, **kw)
            routed.append((request_id, d["target"], time.perf_counter()))
            if request_id.startswith("tail-") and tails:
                i = int(request_id.split("-")[1])
                if i < len(tails) and tails[i]:
                    # a re-route mid-stream: the migration's replay point
                    split.setdefault(i, len(tails[i]))
            return d

        fe.router._record_decision = note
        # the tails' references, one at a time on the base worker
        tail_refs = [await _pipeline_stream(pipeline, r, []) for r in refs]

        async def instances() -> list:
            return sorted(v["instance_id"] for v in
                          (await rt.discovery.get_prefix(prefix)).values())

        await planner.observer.start()
        if full:
            pm = PerfModel.load(profile)
            c1 = {p.isl: p for p in pm.profile.points if p.concurrency == 1}
            sla = Planner(rt, "dynamo", "backend", _Proposals(conn),
                          fleet=fleet, perf_model=pm, config=PlannerConfig(
                              mode="sla", max_replicas=8, cooldown_s=0.0,
                              predictor="constant", quarantine=False,
                              itl_target_s=2 * c1[min(c1)].itl_mean_s,
                              ttft_target_s=2 * c1[max(c1)].ttft_p95_s))
            await sla.observer.start()
            await sla.fpm.start()
        # the closed loop, until the planner grows the fleet
        grown = asyncio.Event()
        gen = torch.Generator().manual_seed(25)
        vocab = base.engine.model_cfg.vocab_size
        served: list = []

        async def client(c: int) -> None:
            j = 0
            while not grown.is_set():
                req = _planner_request(f"load-{c}-{j}", gen, vocab,
                                       PLANNER_NEW)
                toks = await _pipeline_stream(pipeline, req, [])
                served.append((req.request_id, len(toks)))
                j += 1

        t_load = time.perf_counter()
        load = [asyncio.create_task(client(c))
                for c in range(PLANNER_CLIENTS)]
        end = time.monotonic() + PLANNER_READY_S
        while True:
            applied = await planner.tick()
            if applied == 2:
                break
            if time.monotonic() > end:
                raise SystemExit(f"planner: no scale-up within "
                                 f"{PLANNER_READY_S:.0f} s: "
                                 f"{planner.last_diag}")
            await asyncio.sleep(0.2)
        t_up = time.perf_counter()
        res["scale_up_s"] = t_up - t_load
        res["up_decision"] = {k: v for k, v in planner.decisions[-1].items()
                              if k in ("observed_active", "predicted",
                                       "current", "proposed", "applied")}
        victim = sub.procs[-1]
        end = time.monotonic() + PLANNER_READY_S
        while len(await instances()) < 2:
            if victim.returncode is not None or time.monotonic() > end:
                raise SystemExit(f"planner: the spawned worker never "
                                 f"registered (exit {victim.returncode})")
            await asyncio.sleep(0.05)
        res["spawn_to_registered_s"] = time.perf_counter() - t_up
        (new_iid,) = [i for i in await instances() if i != first_iid]
        await _await_until(
            lambda: any(t == new_iid and rid in dict(served)
                        for rid, t, _ in routed),
            "a request routed to the spawned worker and served",
            PLANNER_READY_S)
        res["spawn_to_routed_s"] = next(
            t for _, iid, t in routed if iid == new_iid) - t_up
        log(f"planner: the base worker ready in {res['base_ready_s']:.1f} "
            f"s; scaled up {res['scale_up_s']:.2f} s after the load began; "
            f"the spawned worker registered "
            f"{res['spawn_to_registered_s']:.1f} s after its spawn, first "
            f"routed {res['spawn_to_routed_s']:.1f} s after it")
        if full:
            await _await_until(lambda: sla.observer.aggregate().workers == 2
                               and sla.observer.aggregate().req_per_s > 0,
                               "both workers' load and a request rate in "
                               "the SLA planner", 60.0)
            await _await_until(lambda: fleet.summary() is not None
                               and fleet.summary()["live"] == 2,
                               "both workers live in the fleet scrape", 60.0)
            await sla.tick()
            res["sla"] = {"proposed": sla.connector.asked or None,
                          "diag": {k: sla.last_diag.get(k) for k in (
                              "itl_capacity", "ttft_rps_capacity", "n_itl",
                              "n_ttft", "pred_req_rate", "mean_isl",
                              "itl_correction", "fleet_imbalance",
                              "fleet_kv_headroom")}}
            log(f"planner: the SLA planner on the profile: {res['sla']}")
            n = res["sla"]["diag"]
            if n["n_itl"] is None or not (
                    math.isfinite(n["itl_capacity"] or math.nan)
                    and n["pred_req_rate"] > 0
                    and 0 <= n["n_itl"] < 10**6 and 0 < n["n_ttft"] < 10**6
                    and n["fleet_imbalance"] is not None):
                raise SystemExit(f"planner: SLA proposal {res['sla']}")
            # the load planner's own tick under the same load: the fleet
            # summary in its diag, and no action (two workers carry it)
            await planner.tick()
            fs = {k: planner.last_diag.get(k) for k in (
                "fleet_imbalance", "fleet_straggler", "fleet_kv_headroom")}
            res["fleet_diag"] = fs
            log(f"planner: the load planner's fleet diag {fs}; fleet "
                f"summary {fleet.summary()}")
            if fs["fleet_imbalance"] is None or len(planner.decisions) != 1:
                raise SystemExit(f"planner: fleet diag {fs}, decisions "
                                 f"{list(planner.decisions)}")
        grown.set()
        await asyncio.gather(*load)
        if full:
            res["kube"] = await _kube_scale()
            log(f"planner: KubernetesConnector on FakeKubeApi {res['kube']}")
        # the load ends: both workers' caches cleared (so no prefix pulls
        # a tail to one worker), then two long streams, the second sent
        # once the first is routed (the router balances them)
        clear = await rt.namespace("dynamo").component("backend").endpoint(
            "clear_kv_blocks").client().start()
        try:
            for iid in (first_iid, new_iid):
                [x async for x in clear.generate({}, instance_id=iid)]
        finally:
            await clear.close()
        for iid in (first_iid, new_iid):
            await fe.wait_blocks(iid, 0, "a cleared worker")
        mark = len(routed)
        tasks = []
        for i in range(2):
            tails.append([])
            tasks.append(asyncio.create_task(
                _pipeline_stream(pipeline, refs[i], tails[i])))
            await _await_until(
                lambda: any(rid == refs[i].request_id
                            for rid, _, _ in routed[mark:]),
                f"tail {i}'s routing", 60.0)
        on_victim = [i for i in range(2) if (refs[i].request_id, new_iid)
                     in {(rid, t) for rid, t, _ in routed[mark:]}]
        if on_victim:
            await _await_until(lambda: len(tails[on_victim[0]]) >= 8,
                               "eight tokens of the spawned worker's stream",
                               60.0)
        # the observer's latest samples must be the tails' (the closed
        # loop's last ones read two active a worker)
        await _await_until(
            lambda: planner.observer.aggregate().active_seqs <= len(tails),
            "load samples with only the tails active", 30.0)
        t_down = time.perf_counter()
        applied = await planner.tick()
        res["drain_s"] = time.perf_counter() - t_down
        if applied != 1:
            raise SystemExit(f"planner: the scale-down tick applied "
                             f"{applied}: {planner.last_diag}")
        res["victim_exit"] = victim.returncode
        res["victim_pid"] = victim.pid
        await asyncio.gather(*tasks)
        res["decisions"] = [d["applied"] for d in planner.decisions]
        if res["decisions"] != [2, 1]:
            raise SystemExit(f"planner: decisions {res['decisions']}")
        # each tail against its references: a migrated one's continuation
        # against its prompt and replayed tokens served fresh, alone
        res["migrated"] = {i: split.get(i) for i in on_victim}
        got, want, reqs = [], [], []
        for i in range(2):
            j = split.get(i, len(tails[i]))
            got.append((tails[i][:j],))
            want.append((tail_refs[i][:j],))
            reqs.append(refs[i])
            if j < len(tails[i]):
                await base.engine.clear_kv_blocks()
                cont = dataclasses.replace(
                    refs[i], request_id=f"cont-{i}",
                    token_ids=list(refs[i].token_ids) + tails[i][:j],
                    stop=dataclasses.replace(
                        refs[i].stop, max_tokens=len(tails[i]) - j))
                got.append((tails[i][j:],))
                want.append((await _pipeline_stream(pipeline, cont, []),))
                reqs.append(cont)
        res["parted"] = _check_streams("planner", got, want, reqs,
                                       base.engine.params,
                                       base.engine.model_cfg, device)
        res["base_launches"] = {fn.__name__: fn.launches for fn in used}
    finally:
        await planner.close()
        if sla is not None:
            await sla.close()
        if fe is not None:
            await fe.close()
        await conn.close()
        if base is not None:
            await base.close()
        if fleet is not None:
            await fleet.close()
        await rt.shutdown()
    res["logs"] = dict(sub.logs)
    return res

# ---------------------------------------------------------------------------
# the global router and loadgen (with the mocker beside them)
# ---------------------------------------------------------------------------

# the global router estimates ~4 characters a token (a real tokenizer's
# rate) while the mock tokenizer counts one a character, so a threshold
# of N prompt tokens is N // 4 to the router: the whole run's short form
# routes at the pair frontend's own DISAGG_MIN_ISL (1024 tokens: the
# 1800- and 1224-character prompts go disagg, the 500-, 100- and
# 37-character ones agg), --grouter at the CLI's --disagg-min-isl 2048
# (prompts of 2100 and 4000 characters go disagg)
GROUTER_SHORT_MIN_ISL = DISAGG_MIN_ISL // 4
GROUTER_FULL_MIN_ISL = 2048 // 4
GROUTER_LONG_CHARS = (2100, 4000)
GROUTER_SHORT_CHARS = (500, 100, 37)
GROUTER_BLOCKS_PER_SEQ = 32  # --grouter's engines: 4096 tokens of context
GROUTER_AGG_NS, GROUTER_DISAGG_NS = "agg", "dynamo"
GROUTER_ADDED_ROUNDS = 8
LOADGEN_N, LOADGEN_FULL_N = 16, 128
LOADGEN_SEED = 25
LOADGEN_SLO_TTFT_S, LOADGEN_SLO_ITL_S = 2.0, 0.025


class _PoolFrontend:
    """A pool's frontend: the port's ModelWatcher (kv mode) over the
    pool's namespace alone, with `disagg_config` for a disagg pool, and
    an HttpService on port 0 that advertises itself in discovery (a
    frontend instance is what makes a namespace a pool to the global
    router), with an HTTP client of the port."""

    @classmethod
    async def start(cls, rt, ns: str, model: str,
                    disagg_config=None) -> "_PoolFrontend":
        from dynamo_tpu_torch.frontend.service import (
            HttpService,
            ModelManager,
            ModelWatcher,
        )
        from dynamo_tpu_torch.router.kv_router import make_kv_route_factory
        from dynamo_tpu_torch.runtime import RouterMode
        from dynamo_tpu_torch.runtime.http import HttpClient

        self = cls()
        self.ns = ns
        self.manager = ModelManager()
        self.watcher = await ModelWatcher(
            rt, self.manager, router_mode=RouterMode.KV,
            make_route=make_kv_route_factory(rt), namespaces={ns},
            disagg_config=disagg_config).start()
        self.service = await HttpService(rt, self.manager, host="127.0.0.1",
                                         port=0, advertise=True).start()
        self.http = HttpClient(f"http://127.0.0.1:{self.service.bound_port}")
        end = time.monotonic() + FRONTEND_WAIT_S
        while not (self.manager.get(model) is not None
                   and self.manager.get(model).client.instances
                   and (disagg_config is None
                        or (self.manager.get(model).prefill is not None
                            and self.manager.get(
                                model).prefill.client.instance_ids))):
            if time.monotonic() > end:
                raise SystemExit(f"grouter: pool {ns}'s frontend never "
                                 f"registered {model}")
            await asyncio.sleep(0.02)
        route = self.manager.get(model).migration.route
        self.router = getattr(route, "inner", None) or route
        return self

    async def queue_ms(self) -> float:
        """The frontend's received-to-dispatch mean (ms) so far, from its
        dynamo_frontend_queue_seconds histogram."""
        samples = _parse_metrics(
            (await self.http.request("GET", "/metrics")).body.decode())
        n = sum(v for name, _, v in samples
                if name == "dynamo_frontend_queue_seconds_count")
        tot = sum(v for name, _, v in samples
                  if name == "dynamo_frontend_queue_seconds_sum")
        return 1e3 * tot / n if n else float("nan")

    async def close(self) -> None:
        await self.http.close()
        await self.service.close()
        await self.watcher.close()


def _grouter_texts(full: bool) -> list:
    """The global router's prompts: the frontend phase's five in the whole
    run's short form, two long and three short ones with --grouter."""
    if not full:
        return _frontend_texts()
    rng = np.random.default_rng(7)
    lengths = (GROUTER_LONG_CHARS[0], GROUTER_SHORT_CHARS[0],
               GROUTER_LONG_CHARS[1], *GROUTER_SHORT_CHARS[1:])
    return ["".join(chr(c) for c in rng.integers(32, 127, n))
            for n in lengths]


async def _grouter_phase(cluster: str, pools: dict, model: str, texts: list,
                         used, config_kw: dict) -> dict:
    """The port's global router (global_router/service.py) over two pools
    of one discovery cluster: `pools` maps "agg" and "disagg" to {"rt":
    the pool's runtime (its namespace is the pool's), "engines": the
    TorchEngines to clear between requests ([] for a mocker pool),
    "decode": the decode worker's instance id in a disagg pool}.  Each
    pool gets its own advertised frontend (_PoolFrontend; the disagg one
    with the conditional-disagg thresholds DISAGG_MIN_ISL / DISAGG_RATIO).
    Each prompt, one at a time as a greedy streamed completion of 32
    tokens: from cleared caches through the global router (the main
    path: the K1/K3 counts set to 0 just before, read just after, by the
    pool it went to), then from cleared caches the same body sent to
    that pool's frontend directly.  Exits unless every request went to
    the pool its (estimated ISL, ratio) asks for (GlobalRouterConfig
    `config_kw`), every text through the router equals the direct one,
    the route counts on the router's /metrics agree, and a card pool
    launched both kernels.  Then GROUTER_ADDED_ROUNDS turns of the
    shortest prompt to the agg pool through the router and directly.
    Returns the launches by pool, the route counts,
    route_latency_quantiles, the router's added time a request (TTFT
    through it less TTFT direct, ms; each request's and the turns'
    median) beside each frontend's received-to-dispatch, and the phase's
    seconds."""
    from dynamo_tpu_torch.disagg.prefill_router import ConditionalDisaggConfig
    from dynamo_tpu_torch.global_router import (
        GlobalRouterConfig,
        GlobalRouterService,
    )
    from dynamo_tpu_torch.global_router.policy import estimate_isl
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from dynamo_tpu_torch.runtime.http import HttpClient

    t_phase = time.perf_counter()
    config = GlobalRouterConfig(**config_kw)
    fes = {}
    for kind, pool in pools.items():
        fes[kind] = await _PoolFrontend.start(
            pool["rt"], pool["rt"].config.namespace, model,
            ConditionalDisaggConfig(min_effective_isl=DISAGG_MIN_ISL,
                                    min_effective_ratio=DISAGG_RATIO)
            if kind == "disagg" else None)
    grt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc", tcp_host="127.0.0.1",
        namespace="global"), cluster_id=cluster).start()
    grouter = await GlobalRouterService(
        grt, host="127.0.0.1", port=0, config=config,
        staleness_scrape_s=0.5).start()
    http = HttpClient(f"http://127.0.0.1:{grouter.port}")

    async def cleared(kind: str) -> None:
        pool = pools[kind]
        if not pool["engines"]:
            return
        for eng in pool["engines"]:
            await eng.clear_kv_blocks()
        iid = pool["decode"]
        end = time.monotonic() + FRONTEND_WAIT_S
        while fes[kind].router.indexer.worker_block_count(iid):
            if time.monotonic() > end:
                raise SystemExit(f"grouter: pool {kind}'s index never "
                                 "emptied")
            await asyncio.sleep(0.01)
        await asyncio.sleep(1.1)

    launches = {kind: {fn.__name__: 0 for fn in used} for kind in pools}
    runs = []
    try:
        end = time.monotonic() + FRONTEND_WAIT_S
        while not (len(grouter.directory.pools_for_model(model)) == 2
                   and any(p.is_disagg for p in
                           grouter.directory.pools_for_model(model))):
            if time.monotonic() > end:
                raise SystemExit("grouter: the pools never came up")
            await asyncio.sleep(0.02)
        for i, text in enumerate(texts):
            body = dict(_frontend_body(model, text, f"gr-{i}"),
                        seed=100 + i)
            isl = estimate_isl(body)
            kind = ("disagg" if isl >= config.disagg_min_isl
                    and isl / (isl + 32) >= config.disagg_ratio else "agg")
            await cleared(kind)
            for fn in used:
                fn.launches = 0
            via = await _sse(http, body)
            for fn in used:
                launches[kind][fn.__name__] += fn.launches
            await cleared(kind)
            direct = await _sse(fes[kind].http, body)
            runs.append({"kind": kind, "chars": len(text), "isl": isl,
                         "equal": via["text"] == direct["text"]
                         and via["usage"] == direct["usage"],
                         "added_ms": 1e3 * (via["ttft"] - direct["ttft"])})
        # the route counts of the requests above
        metrics = (await http.request("GET", "/metrics")).body.decode()
        # the router's added time: the shortest prompt to the agg pool
        # through the router and directly, in turns (ABBA), warm caches
        short = min(texts, key=len)
        added = []
        for j in range(GROUTER_ADDED_ROUNDS):
            ttft = {}
            for way in (("via", "direct") if j % 2 == 0
                        else ("direct", "via")):
                body = dict(_frontend_body(model, short, f"gr-add-{j}-{way}"),
                            seed=7)
                ttft[way] = (await _sse(http if way == "via"
                                        else fes["agg"].http, body))["ttft"]
            added.append(1e3 * (ttft["via"] - ttft["direct"]))
        await asyncio.sleep(0.6)  # one staleness scrape of each pool
        state = grouter.debug_state()
        queue_ms = {kind: await fe.queue_ms() for kind, fe in fes.items()}
    finally:
        await http.close()
        await grouter.close()
        await grt.shutdown()
        for fe in fes.values():
            await fe.close()
    samples = _parse_metrics(metrics)
    routed = {f"{lab['pool']}/{lab['reason']}": v for name, lab, v in samples
              if name == "dynamo_grouter_routed_total"}
    want = {}
    for r in runs:
        ns = pools[r["kind"]]["rt"].config.namespace
        key = f"{ns}/{r['kind']}"
        want[key] = want.get(key, 0) + 1
    out = {"launches": launches, "routed": routed,
           "route_latency": state["route_latency"],
           "added_ms": [round(r["added_ms"], 3) for r in runs],
           "added_ms_median": float(np.median(added)),
           "queue_ms": queue_ms, "staleness": state["staleness"],
           "runs": [(r["kind"], r["chars"], r["isl"]) for r in runs],
           "seconds": time.perf_counter() - t_phase}
    log(f"grouter: requests (pool, characters, estimated ISL) {out['runs']}; "
        f"route counts on /metrics {routed}; route latency (received to "
        f"forward started) {out['route_latency']}; added time a request "
        f"(TTFT through the router less TTFT direct) ms {out['added_ms']}, "
        f"median of {GROUTER_ADDED_ROUNDS} warm turns of the shortest prompt "
        f"to the agg pool {out['added_ms_median']:.3f} ms; "
        f"the pool frontends' own received-to-dispatch ms {queue_ms}; "
        f"staleness scrape {out['staleness']}; texts equal to the direct "
        f"hits {[r['equal'] for r in runs]}; phase {out['seconds']:.1f} s")
    log(f"grouter_launches by pool: {launches}")
    if routed != {k: float(v) for k, v in want.items()}:
        raise SystemExit(f"grouter: routed {routed}, expected {want}")
    if len({r["kind"] for r in runs}) != 2:
        raise SystemExit("grouter: the prompts did not cover both classes")
    if not all(r["equal"] for r in runs):
        raise SystemExit("grouter: a stream through the router differs from "
                         "the direct hit")
    for kind, pool in pools.items():
        if pool["engines"] and not all(launches[kind].values()):
            raise SystemExit(f"grouter: pool {kind} did not run through both "
                             "kernels")
    return out


async def _grouter_short(pw, dw, used) -> dict:
    """The whole run's short form: the disagg pair (check_disagg's, on its
    runtime, namespace GROUTER_DISAGG_NS) as the disagg pool and a port
    MockerWorker serving the same model name in namespace GROUTER_AGG_NS
    of the same cluster as the agg pool (no card worker can share the
    phase), at GROUTER_SHORT_MIN_ISL."""
    from dynamo_tpu_torch.mocker import MockEngineArgs, MockerWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    rt = pw.runtime
    mrt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc", tcp_host="127.0.0.1",
        namespace=GROUTER_AGG_NS), cluster_id=rt.cluster_id).start()
    mock = await MockerWorker(mrt, MockEngineArgs(
        model_name=dw.card.name, block_size=dw.config.block_size),
        namespace=GROUTER_AGG_NS, component="backend").start()
    try:
        return await _grouter_phase(
            rt.cluster_id,
            {"agg": {"rt": mrt, "engines": []},
             "disagg": {"rt": rt, "engines": [pw.engine, dw.engine],
                        "decode": dw.served.instance_id}},
            dw.card.name, _grouter_texts(False), used,
            dict(disagg_min_isl=GROUTER_SHORT_MIN_ISL, disagg_ratio=0.7))
    finally:
        await mock.close()
        await mrt.shutdown()


def check_grouter(device, card: str, params) -> dict:
    """--grouter: both pools on the card at llama-8b full depth, one copy
    of the weight tensors `params` shared by three TorchEngineWorkers
    (warm, bf16 caches of 512 blocks, GROUTER_BLOCKS_PER_SEQ blocks of
    context): an agg pool of one worker (namespace GROUTER_AGG_NS) and a
    disagg pool of a prefill and a decode worker (GROUTER_DISAGG_NS), in
    one discovery cluster, behind the port's global router at the CLI's
    thresholds (--disagg-min-isl 2048 tokens, GROUTER_FULL_MIN_ISL to the
    router's estimate; --disagg-ratio 0.7), prompts from
    _grouter_texts(True) (_grouter_phase)."""
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    cfg = dataclasses.replace(_engine_config("bf16"), warmup=True,
                              max_blocks_per_seq=GROUTER_BLOCKS_PER_SEQ)
    cluster = uuid.uuid4().hex
    used = _kernels_of("bf16")

    async def run():
        rts, workers = [], []
        try:
            for ns in (GROUTER_AGG_NS, GROUTER_DISAGG_NS):
                rts.append(await DistributedRuntime(config=RuntimeConfig(
                    discovery_backend="mem", event_plane="inproc",
                    tcp_host="127.0.0.1", namespace=ns),
                    cluster_id=cluster).start())
            for rt, role, comp in ((rts[0], "both", "backend"),
                                   (rts[1], "prefill", "prefill"),
                                   (rts[1], "decode", "backend")):
                t0 = time.perf_counter()
                workers.append(await TorchEngineWorker(
                    rt, dataclasses.replace(cfg, role=role),
                    namespace=rt.config.namespace, component=comp,
                    params=params, device=device).start())
                log(f"grouter: {rt.config.namespace} {role} worker started "
                    f"in {time.perf_counter() - t0:.1f} s, "
                    f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB "
                    f"allocated")
            agg, pw, dw = workers
            return await _grouter_phase(
                cluster,
                {"agg": {"rt": rts[0], "engines": [agg.engine],
                         "decode": agg.served.instance_id},
                 "disagg": {"rt": rts[1], "engines": [pw.engine, dw.engine],
                            "decode": dw.served.instance_id}},
                dw.card.name, _grouter_texts(True), used,
                dict(disagg_min_isl=GROUTER_FULL_MIN_ISL, disagg_ratio=0.7))
        finally:
            for w in workers:
                await w.close()
                w.engine.kv = w.engine.graphs = w.engine.prefill_graphs = None
                w.engine.guided_graphs = None
            for rt in rts:
                await rt.shutdown()

    out = asyncio.run(run())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"grouter ({card}): {cfg.resolve_model().n_layers} layers, phase "
        f"{out['seconds']:.1f} s")
    return out


async def _loadgen_phase(rt, worker, client, used, n: int) -> dict:
    """Loadgen's replay (loadgen/replay.py) of a synthesized trace
    (`synthesize`: n requests, input 512, output 32, 2 prefix groups of
    4 blocks, 8 requests/s, seed LOADGEN_SEED) through `client` over the
    request plane to the bf16 worker, from a cleared cache, the K1/K3
    counts set to 0 just before and read just after; then the same rows
    against a port MockerWorker on the same runtime (component
    "mocker").  Exits unless every row of both completed with no error
    and nothing dropped, and the worker's launches cover layers x its
    decode steps and prefill dispatches.  Returns the launches, both
    summaries (TTFT/ITL p50/p90/p99, output tokens/s, goodput at
    LOADGEN_SLO_TTFT_S / LOADGEN_SLO_ITL_S) and the seconds."""
    from dynamo_tpu_torch.loadgen import replay, synthesize
    from dynamo_tpu_torch.mocker import MockEngineArgs, MockerWorker

    t0 = time.perf_counter()
    eng = worker.engine
    bs, vocab = worker.config.block_size, eng.model_cfg.vocab_size
    rows = synthesize(n, rate_rps=8.0, input_len=512, output_len=32,
                      block_size=bs, prefix_groups=2, prefix_blocks=4,
                      seed=LOADGEN_SEED)
    slo = dict(slo_ttft_s=LOADGEN_SLO_TTFT_S, slo_itl_s=LOADGEN_SLO_ITL_S)
    await eng.clear_kv_blocks()
    m0 = dict(eng.metrics)
    for fn in used:
        fn.launches = 0
    report = await replay(client.generate, rows, block_size=bs,
                          vocab_size=vocab, max_concurrency=n)
    counts = {fn.__name__: fn.launches for fn in used}
    steps = {k: eng.metrics[k] - m0[k] for k in
             ("decode_steps", "prefill_steps", "cache_hit_tokens")}
    summary = report.summary(**slo)
    mock = await MockerWorker(rt, MockEngineArgs(
        model_name="loadgen-mock", block_size=bs, vocab_size=vocab),
        component="mocker").start()
    mclient = await rt.namespace("dynamo").component("mocker").endpoint(
        "generate").client().start()
    try:
        await mclient.wait_for_instances()
        msummary = (await replay(mclient.generate, rows, block_size=bs,
                                 vocab_size=vocab,
                                 max_concurrency=n)).summary(**slo)
    finally:
        await mclient.close()
        await mock.close()
    out = {"launches": counts, "steps": steps, "summary": summary,
           "mocker": msummary, "seconds": time.perf_counter() - t0}
    log(f"loadgen: {n} rows replayed through the worker: {summary}")
    log(f"loadgen: the same rows against the port's MockerWorker: "
        f"{msummary}")
    log(f"loadgen_launches: {counts}; steps {steps}; phase "
        f"{out['seconds']:.1f} s")
    for what, s in (("worker", summary), ("mocker", msummary)):
        if (s["requests"], s["completed"], s["errors"], s["dropped"]) \
                != (n, n, 0, 0):
            raise SystemExit(f"loadgen: the {what}'s replay {s}")
    _check_worker_launches(counts, steps, eng.model_cfg.n_layers, "loadgen")
    return out


def check_loadgen(device, card: str, params, n: int) -> dict:
    """--loadgen: _loadgen_phase's replay of `n` rows through a warm bf16
    TorchEngineWorker (_serving_worker) at llama-8b full depth."""
    async def run():
        async with _serving_worker(device, _engine_config("bf16"),
                                   params) as (rt, worker, client, _):
            return await _loadgen_phase(rt, worker, client,
                                        _kernels_of("bf16"), n)

    out = asyncio.run(run())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"loadgen ({card}): {n} rows in {out['seconds']:.1f} s")
    return out


def tp_slab_kernels(cfg, device) -> list:
    """K1 (B = 8) and K3 (T = 2048, and the 32-token verify stream of a
    speculative round), each mode, at a tp=2 rank's slab of cfg (its
    heads and kv heads halved), held to the plain versions with the
    planted faults and timed, as at the whole model's shapes."""
    from dynamo_tpu_torch.parallel.mesh import shard_config

    slab = shard_config(cfg, 2)
    log(f"tp=2 slab shapes: nh {slab.n_heads}, nkv {slab.n_kv_heads}, "
        f"group {slab.n_heads // slab.n_kv_heads}")
    packed = (PACKED_CASES[0], PACKED_CASES[-1])
    return [check_decode_kernel(slab, device, cases=DECODE_CASES[:1]),
            check_prefill_kernel(slab, device, cases=packed),
            check_decode_kernel(slab, device, int8=True,
                                cases=DECODE_CASES[:1]),
            check_prefill_kernel(slab, device, int8=True, cases=packed)]


def _slab_entry(e: dict) -> dict:
    """A slab check's entry: its first case's numbers, and K3's verify
    stream's under "verify"."""
    out = {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "max_abs_err", "max_rel_err")}
    if VERIFY_CASE in e.get("cases", {}):
        out["verify"] = e["cases"][VERIFY_CASE]
    return out


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



# ---------------------------------------------------------------------------
# the graph operator, the standalone router and the chaos plane, on a
# fleet of two workers (check_fleet; --operator, --chaos)
# ---------------------------------------------------------------------------

FLEET_WAIT_S = 60.0
ROUTER_READY_S = 180.0
OPERATOR_IMAGE = "reg/dynamo-tpu-torch:smoke"
OPERATOR_GRAPH = "smoke"
# the greedy 500-token prompt of _requests: the chaos phase's stream
CHAOS_PROMPT = 1
# the faulted stream's engine.step crash: the third step of the worker
# serving it (a prefill, a decode burst, then the crash mid-decode)
CHAOS_STEP_AFTER = 2


def _graph_spec(model: str, bs: int, image: str = OPERATOR_IMAGE) -> dict:
    """A graph spec for the port's operator: the fleet's frontend, two
    GPU workers, the standalone KV router over them and a planner."""
    return {"name": OPERATOR_GRAPH, "image": image,
            "model": {"name": model, "path": "/models/llama-8b"},
            "components": {
                "frontend": {"kind": "frontend", "replicas": 1,
                             "port": 8000},
                "worker": {"kind": "worker", "replicas": 2, "gpu": 1},
                "router": {"kind": "router", "replicas": 1, "args": [
                    "--block-size", str(bs), "--router-component",
                    "kv-router"]},
                "planner": {"kind": "planner", "replicas": 1, "args": [
                    "--worker-module", "dynamo_tpu_torch.engine"]}}}


def _set_graph(fake, spec: dict) -> None:
    from dynamo_tpu_torch.operator.spec import GRAPH_LABEL

    fake.configmaps[spec["name"]] = {
        "metadata": {"name": spec["name"], "labels": {GRAPH_LABEL: "1"}},
        "data": {"spec": json.dumps(spec)}}


def _container(fake, name: str) -> dict:
    return fake.apps[name]["spec"]["template"]["spec"]["containers"][0]


async def _operator_phase(fake, model: str, bs: int, full: bool) -> dict:
    """The port's GraphOperator against FakeKubeApi: a graph spec
    (_graph_spec) reconciled into four Deployments; a pass with nothing
    to do; a planner scale write on the workers' Deployment through the
    port's KubernetesConnector, kept across a reconcile that only edits
    the frontend's args; a spec edit (the image, the workers' replicas)
    converged, the spec's replica count overriding the planner's; the
    planner removed from the spec and its Deployment deleted.  With
    `full`, `python -m dynamo_tpu_torch.operator --once` reconciles a
    second graph as a process of its own.  Exits unless each step holds;
    returns the calls by method and the router Deployment's container."""
    from dynamo_tpu_torch.operator import GraphOperator
    from dynamo_tpu_torch.planner.connectors import KubernetesConnector

    name = lambda c: f"{OPERATOR_GRAPH}-{c}"  # noqa: E731
    spec = _graph_spec(model, bs)
    op = GraphOperator(api_url=fake.endpoint, namespace=K8S_NAMESPACE,
                       token=K8S_TOKEN)
    conn = KubernetesConnector(name("worker"), namespace=K8S_NAMESPACE,
                               api_url=fake.endpoint, token=K8S_TOKEN)
    t0 = time.perf_counter()
    try:
        _set_graph(fake, spec)
        await op.reconcile_once()
        created = sorted(fake.apps)
        worker = _container(fake, name("worker"))
        if created != sorted(name(c) for c in spec["components"]) \
                or op.stats["created"] != 4 \
                or worker["resources"]["limits"] != {"nvidia.com/gpu": "1"} \
                or worker["command"][:3] != ["python", "-m",
                                             "dynamo_tpu_torch.engine"]:
            raise SystemExit(f"operator: the first pass created {created} "
                             f"({op.stats}), worker container {worker}")
        await op.reconcile_once()
        if op.stats["patched"]:
            raise SystemExit("operator: a converged pass patched")
        # the planner's scale write, then a reconcile unrelated to it
        if await conn.scale(5) != 5:
            raise SystemExit("operator: the connector's scale write failed")
        spec["components"]["frontend"]["args"] = ["--router-mode", "kv"]
        _set_graph(fake, spec)
        await op.reconcile_once()
        kept = fake.apps[name("worker")]["spec"]["replicas"]
        fe_cmd = _container(fake, name("frontend"))["command"]
        if kept != 5 or fe_cmd[-2:] != ["--router-mode", "kv"]:
            raise SystemExit(f"operator: the unrelated pass left the "
                             f"workers at {kept} replicas (the planner "
                             f"wrote 5) or the frontend at {fe_cmd}")
        # a spec edit: the image rolls everything, its replicas win
        spec["image"] = OPERATOR_IMAGE + "-v2"
        spec["components"]["worker"]["replicas"] = 3
        _set_graph(fake, spec)
        await op.reconcile_once()
        images = {n: _container(fake, n)["image"] for n in fake.apps}
        replicas = fake.apps[name("worker")]["spec"]["replicas"]
        if replicas != 3 or set(images.values()) != {spec["image"]}:
            raise SystemExit(f"operator: the spec edit converged to "
                             f"{replicas} worker replicas, images {images}")
        del spec["components"]["planner"]
        _set_graph(fake, spec)
        await op.reconcile_once()
        if name("planner") in fake.apps or op.stats["deleted"] != 1:
            raise SystemExit(f"operator: the removed planner's Deployment "
                             f"is still there ({op.stats})")
        if op.stats["errors"]:
            raise SystemExit(f"operator: reconcile errors {op.stats}")
    finally:
        await op.close()
        await conn.close()
    methods = {}
    for m, _, _ in fake.calls:
        methods[m] = methods.get(m, 0) + 1
    out = {"stats": dict(op.stats), "calls": methods,
           "router": _container(fake, name("router")),
           "seconds": round(time.perf_counter() - t0, 3)}
    log(f"operator: {len(fake.calls)} API calls {methods}, stats "
        f"{op.stats}; the planner's scale write (5) kept across the "
        f"unrelated pass, the spec's 3 replicas won, the planner deleted; "
        f"the router Deployment runs {out['router']['command']} "
        f"({out['seconds']:.2f} s)")
    if full:
        other = dict(_graph_spec(model, bs), name="smoke-cli")
        _set_graph(fake, other)
        env = dict(os.environ, DYN_K8S_TOKEN=K8S_TOKEN)
        t1 = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.operator", "--once",
            "--api-url", fake.endpoint, "--namespace", K8S_NAMESPACE,
            env=env, stdout=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.PIPE)
        _, err = await asyncio.wait_for(proc.communicate(), FLEET_WAIT_S)
        made = sorted(n for n in fake.apps if n.startswith("smoke-cli-"))
        log(f"operator CLI --once: exit {proc.returncode}, created {made} "
            f"in {time.perf_counter() - t1:.1f} s")
        if proc.returncode != 0 or len(made) != 4:
            raise SystemExit(f"operator CLI: exit {proc.returncode}, "
                             f"created {made}: {err.decode()[-2000:]}")
        out["cli"] = made
    return out


async def _start_rendered_router(container: dict, disco_dir: str,
                                 log_path: str, component: str = ""):
    """The router Deployment's rendered command as a process of its own:
    `python` is this interpreter, the container's environment is kept,
    and discovery points at the fleet's (file discovery under
    `disco_dir`, the zmq event plane) where a cluster's pod would find
    the Kubernetes API.  `component` renames the router's component (a
    second instance).  Returns the process (its stdout the ready line's
    pipe, its stderr `log_path`)."""
    cmd = [sys.executable, *container["command"][1:]]
    if component:
        i = cmd.index("--router-component")
        cmd[i + 1] = component
    env = dict(os.environ)
    env.update({e["name"]: e["value"] for e in container["env"]})
    env.update(DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=disco_dir,
               DYN_EVENT_PLANE="zmq")
    with open(log_path, "ab") as errf:
        return await asyncio.create_subprocess_exec(
            *cmd, env=env, stdout=asyncio.subprocess.PIPE, stderr=errf)


async def _router_ready(proc, log_path: str) -> int:
    try:
        line = await asyncio.wait_for(proc.stdout.readline(),
                                      ROUTER_READY_S)
    except asyncio.TimeoutError:
        line = b""
    if not line.startswith(b"ready instance_id="):
        proc.kill()
        await proc.wait()
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise SystemExit(f"standalone router: no ready line within "
                         f"{ROUTER_READY_S:.0f} s: {tail}")
    return int(line.split(b"=", 1)[1])


async def _stop_process(proc) -> int:
    if proc.returncode is None:
        proc.terminate()
        try:
            await asyncio.wait_for(proc.wait(), 30)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
    return proc.returncode


async def _router_phase(rt, client, workers, reqs, bs: int, comps: list,
                        router_ids: list) -> dict:
    """The standalone router (component comps[0], from the operator's
    rendered command) against a KvRouter embedded in this process over
    the same workers: worker 0 and worker 1 hold the first and second
    prompts' blocks (served there directly), and for each of the five
    prompts the standalone's find_best_worker must name the embedded
    router's pick (any of its tied best picks where its costs tie), with
    the same request and overlap blocks; mark_prefill_completed and free
    answer ok.  With a second instance (comps[1]), the affinity check of
    tests/test_torch_router_main.py: a request held at the first
    instance steers its probes, a free sent to the second leaves it
    held, a free sent to the first releases it."""
    from dynamo_tpu_torch.router.kv_router import KvRouter

    t0 = time.perf_counter()
    iids = [w.served.instance_id for w in workers]
    for i, w in ((0, 0), (1, 1)):
        async for _ in client.generate(dataclasses.replace(
                reqs[i], request_id=f"warm-{i}").to_dict(),
                instance_id=iids[w]):
            pass
    full = [len(r.token_ids) // bs for r in reqs]
    emb = await KvRouter(rt, "dynamo", "backend", client, block_size=bs,
                         replica_sync=False).start()
    eps = {}
    try:
        end = time.monotonic() + FLEET_WAIT_S
        while not (emb.indexer.worker_block_count(iids[0]) >= full[0]
                   and emb.indexer.worker_block_count(iids[1]) >= full[1]):
            if time.monotonic() > end:
                raise SystemExit("router phase: the embedded router never "
                                 "saw the warm blocks")
            await asyncio.sleep(0.02)
        for comp in comps:
            ns = rt.namespace("dynamo").component(comp)
            eps[comp] = {ep: await ns.endpoint(ep).client().start()
                         for ep in ("find_best_worker",
                                    "mark_prefill_completed", "free")}
            await eps[comp]["find_best_worker"].wait_for_instances(
                timeout=FLEET_WAIT_S)

        async def one(c, ep, payload):
            out = [x async for x in c[ep].generate(payload)]
            if len(out) != 1:
                raise SystemExit(f"standalone router {ep}: {out}")
            return out[0]

        async def pick(c, req):
            return await one(c, "find_best_worker", req.to_dict())

        r1 = eps[comps[0]]
        # the standalone has seen the warm-ups once it names them
        end = time.monotonic() + FLEET_WAIT_S
        while True:
            probe = dataclasses.replace(reqs[0], request_id="probe")
            ans = await pick(r1, probe)
            await one(r1, "free", {"request_id": "probe"})
            if ans.get("overlap_blocks") == full[0]:
                break
            if time.monotonic() > end:
                raise SystemExit(f"standalone router: never saw the warm "
                                 f"blocks ({ans})")
            await asyncio.sleep(0.1)
        rows = []
        for r in reqs:
            want = await emb.pick(r)
            dec = emb.pop_decision(r.request_id) or {}
            emb.complete(r.request_id)
            scores = dec.get("scores", {})
            best = min(scores.values()) if scores else None
            tied = sorted(int(t) for t, s in scores.items() if s == best)
            got = await pick(r1, r)
            ok = await one(r1, "mark_prefill_completed",
                           {"request_id": r.request_id})
            freed = await one(r1, "free", {"request_id": r.request_id})
            rows.append({"request": r.request_id, "embedded": want,
                         "tied": tied, "standalone": got.get("instance_id"),
                         "request_blocks": (got.get("request_blocks"),
                                            dec.get("request_blocks")),
                         "overlap_blocks": (
                             got.get("overlap_blocks"),
                             dec.get("predicted_overlap_blocks"))})
            if got.get("router_instance_id") != router_ids[0] \
                    or ok != {"ok": True} or freed != {"ok": True}:
                raise SystemExit(f"standalone router: {got}, {ok}, {freed}")
            same = (got.get("instance_id") == want if len(tied) <= 1
                    else got.get("instance_id") in tied)
            if not same or rows[-1]["request_blocks"][0] \
                    != rows[-1]["request_blocks"][1] or (
                    got.get("instance_id") == want
                    and rows[-1]["overlap_blocks"][0]
                    != rows[-1]["overlap_blocks"][1]):
                raise SystemExit(f"standalone router: {r.request_id}'s "
                                 f"answer differs from the embedded "
                                 f"router's: {rows[-1]}")
        log(f"standalone router against the embedded KvRouter: "
            + "; ".join(f"{x['request']} -> {x['standalone']} (embedded "
                        f"{x['embedded']}, tied {x['tied']}), blocks "
                        f"{x['request_blocks'][0]}, overlap "
                        f"{x['overlap_blocks'][0]}" for x in rows))
        out = {"rows": rows}
        if len(comps) > 1:
            out["affinity"] = await _router_affinity(eps, comps, reqs, pick,
                                                     one)
        out["seconds"] = round(time.perf_counter() - t0, 3)
        return out
    finally:
        for c in eps.values():
            for cl in c.values():
                await cl.close()
        await emb.close()


async def _router_affinity(eps, comps, reqs, pick, one) -> dict:
    """tests/test_torch_router_main.py's affinity check on the card's
    fleet: r1 holds a 3-block and a 2-block request on different
    workers; a 1-block probe's pick says whether the first is held."""
    r1, r2 = eps[comps[0]], eps[comps[1]]
    base = reqs[3]

    def req(rid, n):
        # never served, so no worker holds its blocks: cold picks
        toks = (list(base.token_ids) * 20)[:n]
        return dataclasses.replace(base, request_id=rid, token_ids=toks,
                                   stop=dataclasses.replace(base.stop,
                                                            max_tokens=4))

    async def free(c, rid):
        return await one(c, "free", {"request_id": rid})

    hold1 = await pick(r1, req("hold-1", 330))
    w_h = hold1["instance_id"]
    probe1 = await pick(r1, req("probe-1", 100))
    await free(r1, "probe-1")
    hold2 = await pick(r1, req("hold-2", 200))
    wrong = await free(r2, "hold-1")
    probe2 = await pick(r1, req("probe-2", 100))
    await free(r1, "probe-2")
    right = await free(r1, "hold-1")
    probe3 = await pick(r1, req("probe-3", 100))
    await free(r1, "probe-3")
    await free(r1, "hold-2")
    out = {"steered": probe1["instance_id"] != w_h,
           "split": hold2["instance_id"] != w_h, "wrong": wrong,
           "still_held": probe2["instance_id"] != w_h, "right": right,
           "released": probe3["instance_id"] == w_h}
    log(f"standalone router affinity: {out}")
    if out != {"steered": True, "split": True, "wrong": {"ok": True},
               "still_held": True, "right": {"ok": True}, "released": True}:
        raise SystemExit(f"standalone router: affinity broken: {out}")
    return out


async def _through(mig, req, rid: str, workers) -> list:
    """`req` as `rid` through the frontend's migration operator from
    cleared prefix caches (a stream that hits a cached prefix may part
    from a cold one at a near-tie): the token ids its client receives."""
    for w in workers:
        if w.engine._task is None or not w.engine._task.done():
            await w.engine.clear_kv_blocks()
    ids = []
    async for out in mig.generate(dataclasses.replace(req, request_id=rid)):
        ids.extend(out.token_ids)
    return ids


async def _chaos_phase(fe, workers, reqs, full: bool) -> dict:
    """The chaos plane on the fleet behind the frontend's migration
    operator, every stream from cleared prefix caches: the fault-free
    greedy stream of CHAOS_PROMPT, then (b) one
    `request_plane.frame` truncate (the stream cut after its third
    frame, as a worker dying mid-stream looks), (with `full`: one
    `request_plane.dispatch` failure, two delayed frames, a window of
    `discovery.op` failures), then (a) `engine.step` fail after
    CHAOS_STEP_AFTER steps on the worker that took the request, which
    kills its engine loop mid-decode; each faulted stream is migrated by
    token replay and returned for the comparison with the fault-free one.
    The crashed engine must fail a new request fast with a migratable
    error.  Then (c) on the survivor's engine, the four `engine.kv_account`
    classes each seeded by one request and named by the ledger's
    on-demand audit, in an order where no fault feeds the next: a
    refcount drift and a leak keep their blocks off the free list, an
    orphan puts a block the ledger still owns back on it, and a double
    free breaks the free list for whatever follows."""
    from dynamo_tpu_torch import chaos
    from dynamo_tpu_torch.frontend.pipeline import is_migratable

    mig = fe.pipeline.migration
    req = reqs[CHAOS_PROMPT]
    t0 = time.perf_counter()
    streams = {"base": await _through(mig, req, "chaos-base", workers)}
    rules = [("truncate", ("request_plane.frame", "truncate"),
              dict(after=3, times=1, match="generate"))]
    if full:
        rules += [("dispatch", ("request_plane.dispatch", "fail"),
                   dict(times=1, error="connection lost (chaos: "
                        "dispatch)")),
                  ("delay", ("request_plane.frame", "delay"),
                   dict(delay_s=0.05, after=2, times=2,
                        match="generate")),
                  ("discovery", ("discovery.op", "fail"),
                   dict(error="injected discovery outage"))]
    rules.append(("crash", ("engine.step", "fail"),
                  dict(after=CHAOS_STEP_AFTER, times=1,
                       error="worker engine error: chaos crash on step N")))
    fired = {}
    for i, (what, (seam, action), kw) in enumerate(rules):
        plane = chaos.ChaosPlane(seed=i).rule(seam, action, **kw)
        with plane:
            streams[what] = await _through(mig, req, f"chaos-{what}",
                                           workers)
        fired[what] = plane.fired()
        # the discovery window fails the watches' polls, as many as land
        # in it: the request path itself never touches discovery
        want = {"delay": 2, "discovery": fired[what]}.get(what, 1)
        if fired[what] != want:
            raise SystemExit(f"chaos {what}: {fired[what]} injections, "
                             f"expected {want}")
    dead = [w for w in workers
            if w.engine._task is not None and w.engine._task.done()]
    live = [w for w in workers if w not in dead]
    if len(dead) != 1:
        raise SystemExit(f"chaos crash: {len(dead)} engines died")
    outs = [o async for o in dead[0].engine.generate(
        dataclasses.replace(req, request_id="post-crash"))]
    if outs[0].finish_reason != "error" \
            or not is_migratable(RuntimeError(outs[0].error)):
        raise SystemExit(f"chaos crash: the dead engine answered {outs}")
    # (c): each accounting fault class named by the audit
    eng = live[0].engine
    named = {}
    for i, kind in enumerate(("refcount_drift", "leak", "orphan",
                              "double_free")):
        plane = chaos.ChaosPlane(seed=i).rule(
            "engine.kv_account", "drop", match=f"{kind}:", times=1)
        with plane:
            await _serve(eng, [dataclasses.replace(
                reqs[3], request_id=f"kv-{kind}",
                stop=dataclasses.replace(reqs[3].stop, max_tokens=8))])
            end = time.monotonic() + FLEET_WAIT_S
            while eng.num_active_seqs:  # freed a step after its frame
                if time.monotonic() > end:
                    raise SystemExit(f"chaos kv_account: kv-{kind} never "
                                     "freed")
                await asyncio.sleep(0.01)
        report = await eng.audit_kv()
        kinds = sorted({v["kind"] for v in report.get("violations", ())})
        named[kind] = {"fired": plane.fired(), "audit": kinds}
        if plane.fired() != 1 or kind.replace("_", "-") not in kinds:
            raise SystemExit(f"chaos kv_account {kind}: fired "
                             f"{plane.fired()}, the audit named {kinds}")
    log(f"chaos kv_account on the survivor's engine: {named}")
    return {"streams": streams, "fired": fired, "kv_account": named,
            "crashed": dead[0].served.instance_id,
            "seconds": round(time.perf_counter() - t0, 3)}


def check_fleet(device, card: str, params, chaos_form: Optional[str],
                operator_form: Optional[str]) -> dict:
    """Two bf16 TorchEngineWorkers (LLAMA_LAYERS deep, sharing the weight
    tensors `params`, warm-up on) on one runtime over file discovery and
    the zmq event plane, behind the port's frontend in kv mode
    (_Frontend).  `operator_form` ("short", "full" or None): the port's
    graph operator against FakeKubeApi (_operator_phase, before the
    workers start), the router Deployment's rendered command launched as
    a process on the fleet's discovery (two instances with "full") and
    held to an embedded KvRouter (_router_phase).  `chaos_form`
    ("short", "full" or None): _chaos_phase, whose migrated streams must
    equal the fault-free one (a parting only at a near-tie), with the
    launches of K1/K3 counted around its streams (the phase's main path).
    Returns the phases' results and the launches."""
    import shutil
    import tempfile
    import uuid

    from dynamo_tpu_torch.engine import TorchEngineWorker
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    cfg = dataclasses.replace(_engine_config("bf16"), warmup=True)
    mc = cfg.resolve_model()
    bs = cfg.block_size
    reqs = _requests(mc.vocab_size)
    used = _kernels_of("bf16")
    root = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    disco = os.path.join(root, "discovery")
    router_log = os.path.join(root, "router.log")
    result: dict = {}

    async def run():
        fake, fe, client, rt = None, None, None, None
        workers, procs = [], []
        try:
            if operator_form:
                fake = await FakeKubeApi().start()
                result["operator"] = await _operator_phase(
                    fake, "llama-8b", bs, operator_form == "full")
                # the routers start while the workers warm up
                comps = ["kv-router"] + (["kv-router-2"]
                                         if operator_form == "full" else [])
                for comp in comps:
                    procs.append(await _start_rendered_router(
                        result["operator"]["router"], disco, router_log,
                        comp))
            rt = await DistributedRuntime(config=RuntimeConfig(
                discovery_backend="file", discovery_path=disco,
                event_plane="zmq", tcp_host="127.0.0.1"),
                cluster_id=uuid.uuid4().hex).start()
            for _ in range(2):
                t0 = time.perf_counter()
                workers.append(await TorchEngineWorker(
                    rt, cfg, params=params, device=device).start())
                log(f"fleet: worker {workers[-1].served.instance_id} "
                    f"started with warm-up in {time.perf_counter() - t0:.1f} "
                    f"s, {workers[-1].config.num_blocks} KV blocks")
            client = await rt.namespace("dynamo").component(
                "backend").endpoint("generate").client().start()
            await client.wait_for_instances()
            if operator_form:
                ids = [await _router_ready(p, router_log) for p in procs]
                log(f"fleet: {len(procs)} standalone router process(es) "
                    f"ready, instances {ids}")
                result["router"] = await _router_phase(
                    rt, client, workers, reqs, bs, comps, ids)
            if chaos_form:
                fe = await _Frontend.attach(rt, n_instances=2)
                for fn in used:
                    fn.launches = 0
                m0 = [dict(w.engine.metrics) for w in workers]
                result["chaos"] = await _chaos_phase(
                    fe, workers, reqs, chaos_form == "full")
                result["launches"] = {fn.__name__: fn.launches
                                      for fn in used}
                result["steps"] = {k: sum(w.engine.metrics[k] - m[k]
                                          for w, m in zip(workers, m0))
                                   for k in ("decode_steps",
                                             "prefill_steps")}
        finally:
            for p in procs:
                code = await _stop_process(p)
                log(f"fleet: standalone router exited {code}")
            if fe is not None:
                left = await fe.close()
                if left:
                    raise SystemExit(f"fleet: the frontend left tasks "
                                     f"{left}")
            if client is not None:
                await client.close()
            for w in workers:
                await w.close()
                w.engine.kv = w.engine.graphs = None
                w.engine.prefill_graphs = w.engine.guided_graphs = None
            if rt is not None:
                await rt.shutdown()
            if fake is not None:
                await fake.close()

    t0 = time.perf_counter()
    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    if chaos_form:
        ch = result["chaos"]
        base = ch["streams"]["base"]
        names = [k for k in ch["streams"] if k != "base"]
        if len(base) != 32:
            raise SystemExit(f"chaos: the fault-free stream has "
                             f"{len(base)} tokens")
        parted = _check_streams(
            "chaos", [(ch["streams"][k],) for k in names],
            [(base,)] * len(names), [reqs[CHAOS_PROMPT]] * len(names),
            params, mc, device)
        _check_worker_launches(result["launches"], result["steps"],
                               mc.n_layers, "chaos fleet")
        log(f"chaos ({card}): the migrated streams of {names} equal the "
            f"fault-free one for {len(names) - len(parted)} of "
            f"{len(names)} ({len(parted)} parting(s) at a near-tie); "
            f"injections {ch['fired']}; the crash killed worker "
            f"{ch['crashed']}'s engine; phase {ch['seconds']:.1f} s")
        result["parted"] = parted
        del ch["streams"]
    result["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"fleet phase (operator {operator_form}, chaos {chaos_form}): "
        f"{result['seconds']:.1f} s")
    return result


async def _disagg_pull_chaos(pw, dw, pclient, dclient, req) -> dict:
    """`disagg.pull.chunk` on the disagg pair: a pull failing once is
    absorbed by the pull's retry (the decode worker prefills nothing), a
    pull that keeps failing falls back to local prefill.  Returns each
    run's tokens, injections and decode-side prefill tokens."""
    from dynamo_tpu_torch import chaos

    out = {}
    t0 = time.perf_counter()
    for i, (what, kw) in enumerate((("retry", dict(times=1)),
                                    ("fallback", {}))):
        for w in (pw, dw):
            await w.engine.clear_kv_blocks()
        m0 = dict(dw.engine.metrics)
        plane = chaos.ChaosPlane(seed=17 + i).rule(
            "disagg.pull.chunk", "fail",
            error="injected pull chunk failure", **kw)
        with plane:
            r = await _disagg_one(pclient, dclient, dataclasses.replace(
                req, request_id=f"{req.request_id}-pull-{what}"),
                time.perf_counter())
        out[what] = {"tokens": r[0], "finish": r[1],
                     "fired": plane.fired(),
                     "prefill_tokens": dw.engine.metrics["prefill_tokens"]
                     - m0["prefill_tokens"]}
    out["seconds"] = round(time.perf_counter() - t0, 3)
    return out


def main() -> int:
    global LLAMA_LAYERS
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; nothing to run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # the port's frontend renders chat templates with jinja2, a declared
    # dependency of torch's wheel: a card machine without it fails here
    import jinja2

    log(f"jinja2 {jinja2.__version__} (the frontend's chat templates)")
    # the KServe gRPC service (frontend/kserve.py) needs the first two;
    # the planner phase's workers publish over zmq, and its frontend
    # builds their checkpoint's tokenizer with `tokenizers`
    for name in ("grpc", "google.protobuf", "zmq", "tokenizers"):
        try:
            mod = __import__(name, fromlist=["__version__"])
            log(f"{name} imports: version "
                f"{getattr(mod, '__version__', 'unknown')}")
        except ImportError as e:
            log(f"{name} does not import: {e}")
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
        out = {"decode_ab": decode_ab(device, card, params)}
        # what the chaos seams cost with no plane installed
        out["seam_ab"] = seam_ab(device, card, params)
        print(json.dumps(out), flush=True)
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
        launches, embed, frontend = check_worker(
            device, card, _engine_config("bf16"), params, None)
        print(json.dumps({"status": {
            "launches": launches, "embed": embed, "frontend": frontend,
            "seconds": round(time.perf_counter() - t0, 1)}}), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--discovery"]:
        # python3 chip_smoke.py --discovery: the int8 worker through etcd
        # and kubernetes discovery
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        t0 = time.perf_counter()
        out = {b: check_discovery(device, _engine_config("int8"), params, b)
               for b in DISCOVERY_BACKENDS}
        print(json.dumps({"discovery": out, "seconds": round(
            time.perf_counter() - t0, 1)}), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--encoder"]:
        # python3 chip_smoke.py --encoder: the encoder worker phase
        print(json.dumps({"encoder": check_encoder(device, card)}),
              flush=True)
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
    if sys.argv[1:] == ["--tp"]:
        # python3 chip_smoke.py --tp: the tensor-parallel phase at full
        # depth, and K1/K3 at a tp=2 rank's slab
        build_kernels()
        slab = tp_slab_kernels(cfg, device)
        out = check_tp(device, card, cfg.n_layers)
        print(json.dumps({"tp": out, "slab": [
            {"name": e["name"], **_slab_entry(e)} for e in slab]},
            default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--tp-families"]:
        # python3 chip_smoke.py --tp-families: the MoE and MLA families
        # on two ranks of one card
        build_kernels()
        out = check_tp_families(device, card, TP_MIXTRAL_LAYERS,
                                TP_DEEPSEEK_LAYERS)
        print(json.dumps({"tp_families": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--tp-disagg"]:
        # python3 chip_smoke.py --tp-disagg: disaggregation and KVBM on
        # two ranks of one card, llama-8b at full depth
        build_kernels()
        out = check_tp_disagg(device, card, cfg.n_layers)
        print(json.dumps({"tp_disagg": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--tp-features"]:
        # python3 chip_smoke.py --tp-features: speculation, LoRA, the
        # fused epilogue, guided decoding and embed on two ranks of one
        # card, llama-8b at full depth, and K1/K3 at a rank's slab
        build_kernels()
        slab = tp_slab_kernels(cfg, device)
        out = check_tp_features(device, card, cfg.n_layers, rounds=2)
        print(json.dumps({"tp_features": out, "slab": [
            {"name": e["name"], **_slab_entry(e)} for e in slab]},
            default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--sp"]:
        # python3 chip_smoke.py --sp: the ring prefill on two ranks of one
        # card at full depth, a tp=2 x sp=2 engine at TP_LAYERS, and the
        # pipeline check
        build_kernels()
        out = check_sp(device, card, cfg.n_layers, tp_sp=True)
        print(json.dumps({"sp": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--multihost"]:
        # python3 chip_smoke.py --multihost: a tp=2 mesh over a leader
        # and a follower launcher (two processes), llama-8b at full depth
        build_kernels()
        out = check_multihost(device, card, cfg.n_layers)
        print(json.dumps({"multihost": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--frontend"]:
        # python3 chip_smoke.py --frontend: two full-depth workers sharing
        # one copy of the weights behind the port's frontend and KV router
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        print(json.dumps({"frontend": check_frontend(device, card, params)},
                         default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--planner"]:
        # python3 chip_smoke.py --planner: the planner phase at full
        # depth, with the profiler's CLI, SLA mode, the fleet scrape and
        # the Kubernetes connector
        build_kernels()
        out = check_planner(device, card, cfg.n_layers, full=True)
        print(json.dumps({"planner": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] in (["--grouter"], ["--loadgen"]):
        # python3 chip_smoke.py --grouter: an agg and a disagg pool on the
        # card at full depth behind the global router; --loadgen: the
        # loadgen replay of LOADGEN_FULL_N rows at full depth
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        if sys.argv[1] == "--grouter":
            out = {"grouter": check_grouter(device, card, params)}
        else:
            out = {"loadgen": check_loadgen(device, card, params,
                                            LOADGEN_FULL_N)}
        print(json.dumps(out, default=str), flush=True)
        print(card, flush=True)
        return 0
    if sys.argv[1:] in (["--chaos"], ["--operator"]):
        # python3 chip_smoke.py --chaos: the chaos phase's full form on
        # two full-depth workers behind the frontend; --operator: the
        # graph operator and two standalone router instances over them
        build_kernels()
        from dynamo_tpu_torch.models import llama

        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, device)
        chaos_full = sys.argv[1] == "--chaos"
        out = check_fleet(device, card, params,
                          "full" if chaos_full else None,
                          None if chaos_full else "full")
        print(json.dumps({sys.argv[1][2:]: out}, default=str), flush=True)
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
    for k, e in zip(kernels, tp_slab_kernels(cfg, device)):
        k["tp2_slab"] = _slab_entry(e)
    dma = check_dma_kernels(device)
    torch.cuda.empty_cache()
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")
    launches, engine, _, direct = check_engine(device, card)
    log(f"bf16 engine phase done at {time.perf_counter() - t_start:.1f} s")
    # the later runs reuse the weights; each cache is freed first
    params = engine.params
    engine.kv = engine.graphs = engine.prefill_graphs = None
    engine.guided_graphs = None
    torch.cuda.empty_cache()
    worker_launches, embed, frontend = check_worker(
        device, card, engine.config, params, direct)
    log(f"bf16 worker phase done at {time.perf_counter() - t_start:.1f} s")
    del engine
    torch.cuda.empty_cache()
    encoder = check_encoder(device, card)
    log(f"encoder phase done at {time.perf_counter() - t_start:.1f} s")
    # the pair's second process builds the preset's full depth
    disagg = check_disagg(device, card, params)
    log(f"disagg phase done at {time.perf_counter() - t_start:.1f} s")
    ipc = check_disagg_ipc(device, card, params, disagg.pop("ref_one"),
                           disagg["transfer_gb_s"]["broker"])
    log(f"disagg ipc phase done at {time.perf_counter() - t_start:.1f} s")
    # its n-gram turns must propose, which depends on the model's streams
    spec = check_spec(device, card, params)
    log(f"spec phase done at {time.perf_counter() - t_start:.1f} s")
    # from here on the first SERVE_LAYERS layers of the same weights
    LLAMA_LAYERS = SERVE_LAYERS
    params = {**params, "layers": params["layers"][:SERVE_LAYERS]}
    gc.collect()
    torch.cuda.empty_cache()
    launches8, engine8, ops_int8, _ = check_engine(device, card, "int8",
                                                   params)
    launches.update(launches8)
    log(f"int8 engine phase ({SERVE_LAYERS} layers) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    engine8.kv = engine8.graphs = engine8.prefill_graphs = None
    engine8.guided_graphs = None
    torch.cuda.empty_cache()
    # the bf16 cache's count at this depth, for the int8 one's
    ops_bf16 = _compare_logits(params, engine8.model_cfg, device, "bf16")
    log(f"device operations per decode step (one sequence, "
        f"{SERVE_LAYERS} layers): int8 cache {ops_int8} against bf16 cache "
        f"{ops_bf16} (the plain-torch quantize-on-write adds "
        f"{ops_int8 - ops_bf16})")
    worker_launches.update(check_worker_short(device, engine8.config, params))
    log(f"int8 worker phase done at {time.perf_counter() - t_start:.1f} s")
    disc = {b: check_discovery(device, engine8.config, params, b)
            for b in DISCOVERY_BACKENDS}
    log(f"etcd and kubernetes discovery phase done at "
        f"{time.perf_counter() - t_start:.1f} s")
    del engine8
    torch.cuda.empty_cache()
    # one round in the whole check (two with --decode-ab), so the
    # later phases fit in the script's time budget
    ops_default = decode_ab(device, card, params,
                            rounds=1)["dispatched_ops_k8"]
    torch.cuda.empty_cache()
    log(f"decode A/B phase ({SERVE_LAYERS} layers) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    # one round in the whole check (two with --fused-ab)
    fused_ab(device, card, params, rounds=1)
    torch.cuda.empty_cache()
    log(f"fused A/B phase done at {time.perf_counter() - t_start:.1f} s")
    # one round in the whole check (two with --prefill-ab): the padded
    # engine's turns take the second round's place
    prefill_ab(device, card, params, rounds=1)
    torch.cuda.empty_cache()
    log(f"prefill A/B phase done at {time.perf_counter() - t_start:.1f} s")
    # the graph operator, the standalone router and the chaos plane on
    # two workers behind the frontend, short forms
    fleet = check_fleet(device, card, params, "short", "short")
    log(f"fleet phase (operator, router, chaos) done at "
        f"{time.perf_counter() - t_start:.1f} s")
    kvbm = check_kvbm(device, card, params)
    log(f"kvbm phase done at {time.perf_counter() - t_start:.1f} s")
    lora = check_lora_guided(device, card, params, ops_default)
    log(f"lora and guided phase done at {time.perf_counter() - t_start:.1f} "
        "s")
    # the checkpoint phase's config takes its depth from the checkpoint
    LLAMA_LAYERS = None
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = check_checkpoint(device, card)
    log(f"checkpoint phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    mla = check_mla(device, card, MLA_LAYERS)
    log(f"mla phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    moe = check_moe(device, card)
    log(f"moe phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    tp = check_tp(device, card, TP_LAYERS)
    log(f"tp phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    tpf = check_tp_families(device, card, TP_LAYERS, TP_LAYERS,
                            capacity=False)
    log(f"tp families phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    tpd = check_tp_disagg(device, card, TP_LAYERS, int8=False)
    log(f"tp disagg phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    tpx = check_tp_features(device, card, TP_LAYERS, rounds=0)
    log(f"tp features phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    spx = check_sp(device, card, TP_LAYERS)
    log(f"sp phase done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # the multihost and planner phases serve one checkpoint
    import shutil
    import tempfile

    shared = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        path = os.path.join(shared, f"llama-8b-width-{TP_LAYERS}-layers")
        t0 = time.perf_counter()
        write_planner_checkpoint(path, TP_LAYERS, device)
        log(f"checkpoint of {TP_LAYERS} layers at llama-8b width for the "
            f"multihost and planner phases written in "
            f"{time.perf_counter() - t0:.1f} s")
        mhx = check_multihost(device, card, TP_LAYERS, ckpt=path)
        log(f"multihost phase done at {time.perf_counter() - t_start:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        plx = check_planner(device, card, TP_LAYERS, ckpt=path)
        log(f"planner phase done at {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(shared, ignore_errors=True)
    # rank 1's launches on the tp=2 side of every disagg hop and of the
    # KVBM engine
    tpd_rank1 = {}
    for part in tpd.values():
        if isinstance(part, dict):
            for name, n in part.get("rank1_launches", {}).items():
                tpd_rank1[name] = tpd_rank1.get(name, 0) + n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["worker_launches"] = worker_launches[k["name"]]
        k["checkpoint_launches"] = ckpt["launches"].get(k["name"], 0)
        (k["disagg_prefill_launches"],
         k["disagg_decode_launches"]) = disagg["launches"][k["name"]]
        # the same pair behind the port's frontend, always-disagg:
        # [prefill worker's, decode worker's]
        k["frontend_disagg_launches"] = list(
            disagg["frontend_launches"].get(k["name"], (0, 0)))
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
        k["etcd_launches"] = disc["etcd"]["launches"].get(k["name"], 0)
        k["kube_launches"] = disc["kubernetes"]["launches"].get(k["name"], 0)
        k["embed_launches"] = embed["launches"].get(k["name"], 0)
        k["frontend_launches"] = frontend["launches"].get(k["name"], 0)
        k["encoder_launches"] = encoder["launches"].get(k["name"], 0)
        # rank 0 / rank 1 of the tp=2 engine of the cache it serves
        mode = tp["int8" if k["name"].endswith("_int8") else "bf16"]
        k["tp_launches"] = [mode["launches"][r].get(k["name"], 0)
                            for r in ("rank0", "rank1")]
        # mixtral dense dispatch at tp=2, rank 0 / rank 1
        k["tp_families_launches"] = [
            tpf["mixtral_dense"]["launches"][r].get(k["name"], 0)
            for r in ("rank0", "rank1")]
        k["tp_disagg_rank1_launches"] = tpd_rank1.get(k["name"], 0)
        # speculation, LoRA, fused, guided and embed at tp=2, rank 0 /
        # rank 1 (both engines of the phase)
        k["tp_features_launches"] = [
            tpx["launches"][r].get(k["name"], 0) for r in ("rank0", "rank1")]
        # rank 0 / rank 1 of the sp=2 engine (bf16 cache)
        k["sp_launches"] = [spx["sp2"]["launches"][r].get(k["name"], 0)
                            for r in ("rank0", "rank1")]
        # the leader launcher's rank 0 / the follower launcher's rank 1
        k["multihost_launches"] = [
            mhx["launches"][r].get(k["name"], 0) for r in ("rank0", "rank1")]
        # the gRPC requests of the frontend phase, the profiler's sweep of
        # the bf16 worker's engine, and the planner's two workers
        k["kserve_launches"] = frontend["kserve"]["launches"].get(
            k["name"], 0)
        k["profiler_launches"] = frontend["profiler"]["launches"].get(
            k["name"], 0)
        k["planner_launches"] = [w.get(k["name"], 0)
                                 for w in plx["launches"]]
        # the global router's short form: [agg pool (a mocker), disagg
        # pool (the pair)]; the loadgen replay through the bf16 worker
        k["grouter_launches"] = [
            disagg["grouter"]["launches"][p].get(k["name"], 0)
            for p in ("agg", "disagg")]
        k["loadgen_launches"] = frontend["loadgen"]["launches"].get(
            k["name"], 0)
        # the chaos phase's streams over the two-worker fleet
        k["chaos_launches"] = fleet["launches"].get(k["name"], 0)
    for k in dma:  # the microbench is on no serving path
        k["disagg_prefill_launches"] = k["disagg_decode_launches"] = 0
        k["frontend_disagg_launches"] = [0, 0]
        k["disagg_ipc_prefill_launches"] = k["disagg_ipc_decode_launches"] = 0
        k["kvbm_launches"] = k["spec_launches"] = k["spec_draft_launches"] = 0
        k["lora_launches"] = k["guided_launches"] = k["moe_launches"] = 0
        k["mla_launches"] = k["etcd_launches"] = k["kube_launches"] = 0
        k["embed_launches"] = k["encoder_launches"] = 0
        k["frontend_launches"] = 0
        k["tp_launches"] = k["tp_families_launches"] = [0, 0]
        k["tp_features_launches"] = k["sp_launches"] = [0, 0]
        k["multihost_launches"] = [0, 0]
        k["tp_disagg_rank1_launches"] = 0
        k["kserve_launches"] = k["profiler_launches"] = 0
        k["planner_launches"] = k["grouter_launches"] = [0, 0]
        k["loadgen_launches"] = k["chaos_launches"] = 0
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

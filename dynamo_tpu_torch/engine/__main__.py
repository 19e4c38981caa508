"""`python -m dynamo_tpu_torch.engine` — run a torch engine worker.

The counterpart of `python -m dynamo_tpu.engine`, with the flags of the
features the port serves (flags of features not ported yet are not
offered) and `--device`, CUDA by default: without CUDA the worker exits
non-zero unless `--device cpu` asks for the plain attention versions on
the CPU.  The runtime is configured from the `DYN_*` environment
(runtime/config.py), e.g. DYN_DISCOVERY_BACKEND=file and
DYN_DISCOVERY_PATH=<dir> to sit behind `python -m dynamo_tpu.frontend`
on one host; DYN_SYSTEM_PORT (negative: an ephemeral port) serves
/health, /live, /metrics and, with DYN_ADMIN_TOKEN, the /debug routes
(runtime/system_status.py), and DYN_TRACE=1 with DYN_TRACE_OUT=<file>
records the timeline spans and dumps them as a Chrome trace at exit
(obs/).  Prints `ready instance_id=<id>` once registered; SIGTERM
drains, deregisters and exits.  The kernels' launch counts (each CUDA
wrapper's `launches`) are logged once ready and again at exit, so a
driver of the process can tell what serving launched.

`--tp N --dp M` serve one mesh of N * M ranks (parallel/): this process
is rank 0 and spawns the others, one per device, the first N * M
visible CUDA devices (or all on the CPU with `--device cpu`); with
fewer devices the worker exits non-zero with JAX's make_mesh error.
`--no-cuda-graphs` runs the programs eagerly on CUDA, as a mesh whose
ranks share a card (gloo) needs.

Multihost (parallel/multihost.py): with DYN_MH_WORLD = H > 1 this
process is launcher DYN_MH_RANK of H, one per host, every launcher with
the same flags and JAX_COORDINATOR_ADDRESS=host:port (the leader's
store).  It owns N * M / H ranks (a mesh H does not divide exits 2) on
its first N * M / H devices.  Launcher 0 is the leader: it serves, once
every launcher's ranks have joined within DYN_MH_BARRIER_TIMEOUT_S (else
it exits non-zero naming the ranks that never came), and prints `ready
instance_id=<id>`.  Any other launcher joins it (waiting for its store
as long), prints `ready follower rank=h/H`, replays the leader's steps
and exits 0 when the leader's drain stops them, its spawned ranks with
it; a replay that fails exits 1.  At exit the leader logs the steps it
published and each other rank's launch counts and steps replayed, as
the ranks reported them into the mesh's store.  With DYN_MH_WORLD unset or 1 the CLI
is the single launcher it always was.
"""

import argparse
import asyncio
import json
import logging
import os
import sys

from .. import obs
from ..device import resolve_device
from ..ops import launch_counts
from ..ops.fused_sampling import EPILOGUE_MODES
from ..ops.packed_prefill import PACKED_IMPLS
from ..ops.paged_attention import DECODE_IMPLS
from ..parallel.mesh import MeshConfig, default_devices, mesh_devices
from ..parallel.multihost import MultihostContext, initialize
from ..runtime import DistributedRuntime
from ..runtime.aio import install_drain_handler
from ..runtime.logging import setup_logging
from .config import ROLES, SPEC_MODES, EngineConfig
from .worker import TorchEngineWorker

logger = logging.getLogger("dynamo_tpu_torch.engine")


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.engine")
    p.add_argument("--model", default="tiny",
                   help="model preset name, any family (Llama, Mixtral, "
                        "DeepSeek MLA: tiny-mla, deepseek-v2-lite, ...)")
    p.add_argument("--model-path", default="",
                   help="local HF checkpoint dir (overrides --model): the "
                        "Llama lineage, Mixtral, DeepSeek V2/V3")
    p.add_argument("--model-name", default="", help="served model name")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--num-blocks", type=int, default=128)
    p.add_argument("--max-blocks-per-seq", type=int, default=64)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--no-prefix-caching", action="store_true")
    p.add_argument("--kv-cache-dtype", default="bf16",
                   choices=["bf16", "int8"],
                   help="KV storage dtype (quant/kv.py): int8 stores codes "
                        "plus fp32 scales, ~1.94x the blocks per byte at "
                        "head_dim 128; the DeepSeek MLA family has no int8 "
                        "cache and falls back to bf16 with a warning")
    p.add_argument("--kv-hbm-gb", type=float, default=0.0,
                   help="KV memory budget in GB: derive --num-blocks from "
                        "bytes per block at the KV dtype (0 = use "
                        "--num-blocks as given)")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="packed-prefill token budget per scheduler step; "
                        "0 = max_batch_tokens")
    p.add_argument("--no-packed-prefill", action="store_true",
                   help="disable packed chunked prefill (use the padded "
                        "per-row programs)")
    p.add_argument("--attn-impl", default="", choices=["", *DECODE_IMPLS],
                   help="decode attention: auto = kernel K1 on CUDA "
                        "tensors, torch = the plain version; default keeps "
                        "the preset's")
    p.add_argument("--packed-attn-impl", default="",
                   choices=["", *PACKED_IMPLS],
                   help="packed-prefill attention: auto = kernel K3 on "
                        "CUDA tensors, torch = the plain version")
    p.add_argument("--sampling-epilogue", default="off",
                   choices=list(EPILOGUE_MODES),
                   help="fused = stream the decode step's final projection "
                        "in vocab tiles into the sampler's statistics (no "
                        "[B, vocab] logits); off = materialize the logits "
                        "and sample them (the DeepSeek MLA family falls "
                        "back to off)")
    p.add_argument("--peak-tflops", type=float,
                   default=float(os.environ.get("DYN_PEAK_TFLOPS", "0")),
                   help="dense-bf16 peak, for prefill MFU in the FPM "
                        "records (H100 SXM: 989); 0 = unknown")
    p.add_argument("--peak-hbm-gbps", type=float,
                   default=float(os.environ.get("DYN_PEAK_HBM_GBPS", "0")),
                   help="peak HBM bandwidth GB/s, for the /metrics "
                        "roofline MBU gauges (H100 SXM: 3350); 0 = unknown")
    p.add_argument("--no-overlap-scheduling", action="store_true",
                   help="lockstep scheduler: dispatch, block on the "
                        "device, emit (the byte-identical reference for "
                        "the overlapped default)")
    p.add_argument("--no-adaptive-fusion", action="store_true",
                   help="fixed decode bursts: decode_fused_steps whenever "
                        "no prefill/admission work is pending, instead of "
                        "ramping the fusion ladder")
    p.add_argument("--slo-yield-burn", type=float, default=1.0,
                   help="SLA-aware admission: prefill chunks yield "
                        "budget to decode while the frontend-published "
                        "SLO burn rate exceeds this (0 disables)")
    p.add_argument("--host-cache-blocks", type=int, default=0,
                   help="G2 host-memory KV cache capacity (blocks); 0 off")
    p.add_argument("--offload-watermark-blocks", type=int, default=0,
                   help="offload coldest device blocks to G2 once free "
                        "blocks fall below this (0 = num_blocks/4); raise "
                        "toward num_blocks so allocation bursts can't "
                        "evict a block before the offload pass copies it")
    p.add_argument("--disk-cache-dir", default="",
                   help="G3 disk KV cache directory")
    p.add_argument("--disk-cache-blocks", type=int, default=0)
    p.add_argument("--object-store-dir",
                   default=os.environ.get("DYN_KVBM_OBJECT_DIR", ""),
                   help="G4 cluster-shared object store (shared FS path; "
                        "defaults to $DYN_KVBM_OBJECT_DIR)")
    p.add_argument("--kv-io-deadline-s", type=float, default=0.25,
                   help="per-op deadline for shared-FS (G4) KV I/O on the "
                        "dedicated I/O thread; a wedged mount is a bounded "
                        "timeout off the scheduler path")
    p.add_argument("--kv-breaker-threshold", type=int, default=3,
                   help="consecutive tier failures that trip the tier's "
                        "circuit breaker open (tier skipped until a "
                        "half-open probe succeeds)")
    p.add_argument("--kv-breaker-cooldown-s", type=float, default=30.0,
                   help="seconds an open tier breaker waits before "
                        "admitting one half-open probe op")
    p.add_argument("--no-kvbm-remote", action="store_true",
                   help="disable cross-worker G2 pull")
    p.add_argument("--role", default="both", choices=list(ROLES),
                   help="disaggregation role: prefill workers park each "
                        "prompt's KV for a decode worker's pull; decode "
                        "workers pull it instead of prefilling")
    p.add_argument("--reasoning-parser", default="",
                   help="advertise a reasoning parser (e.g. deepseek_r1) "
                        "so frontends split <think> spans")
    p.add_argument("--spec-decode", default="off", choices=list(SPEC_MODES),
                   help="speculative decoding proposer (spec/): ngram = "
                        "zero-weight prompt lookup; draft = a second "
                        "model on the same device")
    p.add_argument("--spec-k", type=int, default=4,
                   help="max draft tokens per speculation round "
                        "(per-sequence acceptance EMA adapts below this)")
    p.add_argument("--spec-draft-model", default="",
                   help="draft model preset for --spec-decode draft")
    p.add_argument("--spec-draft-model-path", default="",
                   help="draft HF checkpoint dir (overrides the preset)")
    p.add_argument("--lora-dir", default=os.environ.get("DYN_LORA_PATH", ""),
                   help="PEFT adapter tree (lora/source.py); empty = off")
    p.add_argument("--lora-max-adapters", type=int, default=4)
    p.add_argument("--lora-rank", type=int, default=16)
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the kernel build and decode warm-up at "
                        "startup")
    p.add_argument("--drain-deadline-s", type=float, default=5.0,
                   help="SIGTERM grace: in-flight requests get this long "
                        "to finish before the rest error with the "
                        "migratable 'worker draining' marker")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits non-zero without CUDA), "
                        "cuda:N, or cpu (the plain attention versions)")
    p.add_argument("--no-cuda-graphs", action="store_true",
                   help="run the decode and prefill programs eagerly on "
                        "CUDA (a mesh whose ranks share a card talks "
                        "through gloo, which a graph cannot capture)")
    return p


def engine_config(args: argparse.Namespace) -> EngineConfig:
    return EngineConfig(
        model=args.model,
        model_path=args.model_path,
        model_name=args.model_name,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        max_blocks_per_seq=args.max_blocks_per_seq,
        max_num_seqs=args.max_num_seqs,
        tp=args.tp,
        dp=args.dp,
        enable_prefix_caching=not args.no_prefix_caching,
        kv_cache_dtype=args.kv_cache_dtype,
        kv_hbm_gb=args.kv_hbm_gb,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefill_packed=not args.no_packed_prefill,
        attn_impl=args.attn_impl,
        packed_attn_impl=args.packed_attn_impl,
        sampling_epilogue=args.sampling_epilogue,
        peak_tflops=args.peak_tflops,
        peak_hbm_gbps=args.peak_hbm_gbps,
        overlap_scheduling=not args.no_overlap_scheduling,
        decode_fuse_adaptive=not args.no_adaptive_fusion,
        slo_yield_burn=args.slo_yield_burn,
        warmup=not args.no_warmup,
        role=args.role,
        reasoning_parser=args.reasoning_parser,
        host_cache_blocks=args.host_cache_blocks,
        offload_watermark_blocks=args.offload_watermark_blocks,
        disk_cache_dir=args.disk_cache_dir or None,
        disk_cache_blocks=args.disk_cache_blocks,
        object_store_dir=args.object_store_dir or None,
        kv_io_deadline_s=args.kv_io_deadline_s,
        kv_breaker_threshold=args.kv_breaker_threshold,
        kv_breaker_cooldown_s=args.kv_breaker_cooldown_s,
        kvbm_remote=not args.no_kvbm_remote,
        spec_decode=args.spec_decode,
        spec_k=args.spec_k,
        spec_draft_model=args.spec_draft_model,
        spec_draft_model_path=args.spec_draft_model_path,
        # the bank exists only with an adapter directory, as in JAX
        lora_dir=args.lora_dir or None,
        lora_max_adapters=(args.lora_max_adapters if args.lora_dir else 0),
        lora_rank=args.lora_rank,
    )


async def main() -> int:
    setup_logging()
    # timeline tracing (obs/): DYN_TRACE=1 installs the process tracer;
    # DYN_TRACE_OUT gets a Chrome trace dump at exit
    obs.install_from_env()
    args = build_args().parse_args()
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dynamo_tpu_torch.engine: {e}", file=sys.stderr)
        return 2
    config = engine_config(args)
    mcfg = MeshConfig(dp=config.dp, tp=config.tp, sp=config.sp)
    try:
        mh = MultihostContext.detect()
        if mh.world > 1:
            mh = initialize()  # the coordinator: JAX_COORDINATOR_ADDRESS
        mesh_devices(mcfg, default_devices(mcfg, device), mh.world)
    except ValueError as e:
        print(f"dynamo_tpu_torch.engine: {e}", file=sys.stderr)
        return 2
    rt = await DistributedRuntime.detached().start()
    worker = await TorchEngineWorker(
        rt, config, namespace=args.namespace, component=args.component,
        migration_limit=args.migration_limit, device=device,
        cuda_graphs=not args.no_cuda_graphs, mh=mh,
    ).start()

    async def drain_worker() -> None:
        # graceful SIGTERM: withdraw the lease, finish or abort in-flight
        # requests, then exit, even if a drain step fails
        try:
            await worker.drain(args.drain_deadline_s)
        finally:
            rt.root_token.kill()

    install_drain_handler(drain_worker)
    logger.info("kernel launches at ready: %s", json.dumps(launch_counts()))
    if worker.served is not None:
        print(f"ready instance_id={worker.served.instance_id}", flush=True)
    else:  # a follower launcher: no routing identity, replay only
        print(f"ready follower rank={mh.rank}/{mh.world}", flush=True)
    rc = 0
    try:
        if worker.replay_done is None:
            await rt.root_token.wait_killed()
        else:
            # the leader's stop ends the replay; SIGTERM kills the token
            killed = asyncio.ensure_future(rt.root_token.wait_killed())
            await asyncio.wait({killed, worker.replay_done},
                               return_when=asyncio.FIRST_COMPLETED)
            killed.cancel()
            await asyncio.gather(killed, return_exceptions=True)
            if worker.replay_done.done() \
                    and worker.replay_done.exception() is not None:
                rc = 1
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    await worker.close()
    await rt.shutdown()
    logger.info("kernel launches at exit: %s", json.dumps(launch_counts()))
    eng = worker.engine
    if worker.served is not None and eng is not None and eng.rank_launches:
        # what the other ranks reported into the mesh's store at stop
        logger.info("steps published: %d", eng.steps_published)
        logger.info("rank launches at exit: %s", json.dumps(
            {str(r): c for r, c in eng.rank_launches.items()}))
        logger.info("rank steps replayed at exit: %s", json.dumps(
            {str(r): m.get("steps_replayed")
             for r, m in eng.rank_metrics.items()}))
    if worker.replay_alive:
        # a follower stopped before the leader's stop: its replay thread
        # waits in gloo's receive, which neither an abort nor the
        # interpreter's exit can end
        logging.shutdown()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    return rc


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))

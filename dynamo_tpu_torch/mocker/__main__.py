"""`python -m dynamo_tpu_torch.mocker`: run one or more mocker workers on
the port's runtime, with `python -m dynamo_tpu.mocker`'s flags.  The
device-free backend the frontend, router, global router, planner and
loadgen are tested against; prints `ready workers=[...]` and drains on
SIGTERM.
"""

import argparse
import asyncio
import logging
import os

from .. import obs
from ..runtime import DistributedRuntime
from ..runtime.logging import setup_logging
from .engine import MockEngineArgs
from .worker import MockerWorker


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.mocker")
    p.add_argument("--model-name", default="mock-model")
    # DYN_NAMESPACE is the pool-membership contract (deploy/README.md
    # "Pools"): a worker manifest labeled for a pool must land in it
    # without also repeating the label as a flag
    p.add_argument("--namespace",
                   default=os.environ.get("DYN_NAMESPACE", "dynamo"))
    p.add_argument("--component", default="mocker")
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-blocks", type=int, default=4096)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-batch-tokens", type=int, default=8192)
    p.add_argument("--speedup-ratio", type=float, default=1.0)
    p.add_argument("--no-prefix-caching", action="store_true")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--migration-limit", type=int, default=0)
    p.add_argument("--role", default="both", choices=["both", "prefill", "decode"])
    p.add_argument("--spec-k", type=int, default=0,
                   help="simulated speculative decoding: draft tokens "
                        "per step (0 = off)")
    p.add_argument("--spec-acceptance", type=float, default=0.5,
                   help="simulated per-draft acceptance probability")
    p.add_argument("--kv-cache-dtype", default="bf16",
                   choices=["bf16", "int8"],
                   help="simulated KV storage dtype: int8 scales the "
                        "block pool to what the same HBM budget holds "
                        "at int8 bytes-per-block (~1.94x blocks) and is "
                        "advertised in the MDC like a torch worker")
    # simulated device-performance plane (obs/): compile records +
    # roofline fields under the exact names the JAX worker exports
    p.add_argument("--peak-tflops", type=float, default=0.0,
                   help="simulated accelerator peak TFLOP/s: prefill "
                        "FPM records carry mfu and the roofline MFU "
                        "gauges light up (0 = off)")
    p.add_argument("--peak-hbm-gbps", type=float, default=0.0,
                   help="simulated peak HBM GB/s for the roofline MBU "
                        "gauges (0 = off)")
    p.add_argument("--sim-compile-s", type=float, default=0.002,
                   help="simulated per-family compile duration emitted "
                        "as compile FPM records (0 = off)")
    p.add_argument("--sim-recompile-every", type=int, default=0,
                   help="emit a mid-serving compile record every N "
                        "steps — drives the planner's recompile-storm "
                        "diag (0 = off)")
    # fault modes: worker death, a wedged scheduler and dropped streams
    # without a crash harness
    p.add_argument("--fail-after-tokens", type=int, default=0,
                   help="simulate worker death after N decode tokens: "
                        "every stream errors with the migratable "
                        "connection-lost marker (0 = off)")
    p.add_argument("--wedge-after", type=int, default=0,
                   help="stop stepping after N scheduler steps "
                        "(alive-but-stuck; the canary withdraws the "
                        "lease, the frontend's idle bound rescues "
                        "in-flight streams; 0 = off)")
    p.add_argument("--flaky", type=float, default=0.0,
                   help="per-decode-token probability of dropping that "
                        "stream with a migratable error (0.0 = off)")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the fault-mode RNG (reproducible "
                        "--flaky runs)")
    p.add_argument("--drain-deadline-s", type=float, default=5.0,
                   help="SIGTERM grace: in-flight requests get this long "
                        "to finish before the rest error with the "
                        "migratable 'worker draining' marker and "
                        "replay elsewhere")
    p.add_argument("--no-overlap-scheduling", action="store_true",
                   help="lockstep scheduler sim (one token per seq per "
                        "step, host time serial with the simulated "
                        "device) instead of the overlapped default")
    p.add_argument("--decode-fused-steps", type=int, default=8,
                   help="adaptive-fusion ceiling for the overlap sim: "
                        "decode-only stretches fuse up to this many "
                        "tokens per dispatch (1 disables fusion)")
    return p


async def main() -> None:
    setup_logging()
    # timeline tracing (obs/): DYN_TRACE=1 installs the process
    # tracer; DYN_TRACE_OUT gets a Chrome trace dump at exit
    obs.install_from_env()
    args = build_args().parse_args()
    engine_args = MockEngineArgs(
        model_name=args.model_name,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        max_num_seqs=args.max_num_seqs,
        max_batch_tokens=args.max_batch_tokens,
        speedup_ratio=args.speedup_ratio,
        enable_prefix_caching=not args.no_prefix_caching,
        role=args.role,
        speculative=({"k": args.spec_k, "acceptance": args.spec_acceptance}
                     if args.spec_k > 0 else None),
        kv_cache_dtype=args.kv_cache_dtype,
        peak_tflops=args.peak_tflops,
        peak_hbm_gbps=args.peak_hbm_gbps,
        sim_compile_s=args.sim_compile_s,
        sim_recompile_every=args.sim_recompile_every,
        fail_after_tokens=args.fail_after_tokens,
        wedge_after=args.wedge_after,
        flaky=args.flaky,
        fault_seed=args.fault_seed,
        overlap_scheduling=not args.no_overlap_scheduling,
        decode_fused_steps=args.decode_fused_steps,
    )
    rt = await DistributedRuntime.detached().start()
    workers = []
    for _ in range(args.num_workers):
        w = MockerWorker(rt, engine_args, namespace=args.namespace,
                         component=args.component,
                         migration_limit=args.migration_limit)
        workers.append(await w.start())

    async def drain_all() -> None:
        # graceful SIGTERM: drain every worker (in-flight requests finish
        # or migrate with zero client-visible errors), then exit — even
        # if a drain step fails, the process must still come down.
        # return_exceptions: one worker's failed drain (flaky discovery)
        # must not cut short the others' grace period mid-drain
        try:
            results = await asyncio.gather(
                *(w.drain(args.drain_deadline_s) for w in workers),
                return_exceptions=True)
            for w, r in zip(workers, results):
                if isinstance(r, BaseException):
                    logging.getLogger(__name__).error(
                        "drain of worker %s failed",
                        w.served.instance_id, exc_info=r)
        finally:
            rt.root_token.kill()

    from ..runtime.aio import install_drain_handler

    install_drain_handler(drain_all)
    print(f"ready workers={[w.served.instance_id for w in workers]}", flush=True)
    try:
        await rt.root_token.wait_killed()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    for w in workers:
        await w.close()
    await rt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())

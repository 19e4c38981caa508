"""`python -m dynamo_tpu_torch.frontend` — the OpenAI HTTP server,
preprocessor and router in one process, with no device.

A copy of dynamo_tpu/frontend/__main__.py: it takes every flag of the
JAX frontend's CLI.  Conditional disaggregation (`--disagg-min-isl`,
`--disagg-ratio`, `--always-disagg`), sticky sessions
(`--session-affinity-ttl`) and pool scoping (`--pool-scoped`) configure
the ModelWatcher as JAX's CLI does; `--grpc-port N` (non-zero) also
serves the KServe v2 gRPC protocol on port N (frontend/kserve.py, which
alone imports grpc).  Once serving it prints `ready port=<bound port>`;
SIGTERM or SIGINT closes the services, the watcher and the runtime, and
the process exits 0.
"""

import argparse
import asyncio
import os
import signal
import sys

from .. import obs
from ..runtime import DistributedRuntime, RouterMode
from ..runtime.logging import setup_logging
from .service import HttpService, ModelManager, ModelWatcher


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--router-mode", default="round_robin",
        choices=["random", "round_robin", "least_loaded", "p2c", "kv"],
    )
    p.add_argument("--busy-threshold", type=int, default=None)
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    # conditional disagg thresholds (ref: conditional_disagg.rs:11-18)
    p.add_argument("--disagg-min-isl", type=int, default=2048)
    p.add_argument("--disagg-ratio", type=float, default=0.7)
    p.add_argument("--always-disagg", action="store_true")
    p.add_argument("--grpc-port", type=int, default=0,
                   help="serve the KServe v2 gRPC inference protocol on "
                        "this port (0 = disabled)")
    p.add_argument(
        "--session-affinity-ttl", type=float,
        default=float(os.environ.get("DYN_SESSION_AFFINITY_TTL", 0)) or None,
        help="seconds an idle agent session stays pinned to its worker "
             "(0/unset disables sticky sessions)")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="TTFT target in ms: a request is 'good' only if "
                        "its first token beat this (goodput/burn-rate "
                        "gauges light up when set)")
    p.add_argument("--slo-itl-ms", type=float, default=None,
                   help="per-request mean inter-token-latency target in "
                        "ms for the goodput check")
    p.add_argument("--slo-objective", type=float, default=0.99,
                   help="SLO objective (good-request fraction) the "
                        "burn-rate error budget derives from")
    p.add_argument("--pool-scoped", action="store_true",
                   help="serve only models in this process's namespace "
                        "(DYN_NAMESPACE) — the pool-frontend contract")
    p.add_argument("--advertise", action="store_true",
                   help="register this frontend in discovery even "
                        "without a system-status port, so the global "
                        "router can route to it")
    return p


def unported(args) -> list:
    """The flags given whose features the port has not yet: none, every
    flag of the JAX frontend's CLI is served."""
    return []


async def main(args) -> None:
    setup_logging()
    # timeline tracing (obs/): DYN_TRACE=1 installs the process
    # tracer; DYN_TRACE_OUT gets a Chrome trace dump at exit
    obs.install_from_env()
    rt = await DistributedRuntime.detached().start()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, rt.root_token.kill)
    manager = ModelManager()

    make_route = None
    mode = RouterMode(args.router_mode)
    if mode == RouterMode.KV:
        from ..router.kv_router import make_kv_route_factory

        make_route = make_kv_route_factory(
            rt,
            overlap_score_weight=args.kv_overlap_score_weight,
            temperature=args.router_temperature,
        )
    from ..disagg.prefill_router import ConditionalDisaggConfig

    disagg_config = ConditionalDisaggConfig(
        min_effective_isl=args.disagg_min_isl,
        min_effective_ratio=args.disagg_ratio,
        always_remote=args.always_disagg,
    )
    # "0 disables": normalize sub-second/zero TTLs to off here, where the
    # error is visible, instead of raising per-MDC inside the watcher loop
    affinity_ttl = args.session_affinity_ttl
    if affinity_ttl is not None and affinity_ttl < 1.0:
        affinity_ttl = None
    watcher = await ModelWatcher(
        rt, manager, router_mode=mode, make_route=make_route,
        disagg_config=disagg_config,
        session_affinity_ttl=affinity_ttl,
        namespaces={rt.config.namespace} if args.pool_scoped else None,
    ).start()
    from ..obs.slo import SloConfig

    service = await HttpService(
        rt, manager, host=args.host, port=args.port,
        busy_threshold=args.busy_threshold,
        slo=SloConfig(ttft_ms=args.slo_ttft_ms, itl_ms=args.slo_itl_ms,
                      objective=args.slo_objective),
        advertise=True if args.advertise else None,
    ).start()
    grpc_service = None
    if args.grpc_port:
        from .kserve import KserveGrpcService

        grpc_service = await KserveGrpcService(
            rt, manager, host=args.host, port=args.grpc_port,
            resolver=service._resolve_pipeline).start()
    print(f"ready port={service.bound_port}", flush=True)
    try:
        await rt.root_token.wait_killed()
    except asyncio.CancelledError:
        pass
    if grpc_service is not None:
        await grpc_service.close()
    await service.close()
    await watcher.close()
    await rt.shutdown()


def run(argv=None) -> int:
    """Parse `argv` and serve until a signal (0)."""
    asyncio.run(main(build_args().parse_args(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(run())

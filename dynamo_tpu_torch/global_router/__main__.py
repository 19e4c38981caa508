"""`python -m dynamo_tpu_torch.global_router`: the pool-level request
plane on the port's runtime, with `python -m dynamo_tpu.global_router`'s
flags; prints `ready port=N` and exits 0 on SIGTERM.

Runs the global router as its own process: discovers pool namespaces
from the shared discovery plane, classifies requests on (ISL, predicted
TTFT) with the conditional-disagg thresholds, and proxies to the chosen
pool's frontend tier.  Deploy one (or a few, behind any TCP LB — the
process is stateless apart from latency EWMAs) per fleet.
"""

import argparse
import asyncio
import signal

from .. import obs
from ..runtime import DistributedRuntime
from ..runtime.logging import setup_logging
from .policy import GlobalRouterConfig
from .service import GlobalRouterService


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.global_router")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    # same conditional-disagg thresholds the frontends use
    # (conditional_disagg.rs:11-18), applied one level up: which CLASS
    # of pool a request wants
    p.add_argument("--disagg-min-isl", type=int, default=2048)
    p.add_argument("--disagg-ratio", type=float, default=0.7)
    p.add_argument("--load-penalty-ms", type=float, default=10.0,
                   help="predicted-TTFT penalty per in-flight request "
                        "per frontend (the ITL-headroom proxy)")
    p.add_argument("--staleness-scrape-s", type=float, default=2.0,
                   help="interval of the frontend /metrics scrape that "
                        "feeds dynamo_grouter_staleness_spread")
    return p


async def main() -> None:
    setup_logging()
    obs.install_from_env()
    args = build_args().parse_args()
    rt = await DistributedRuntime.detached().start()
    config = GlobalRouterConfig(
        disagg_min_isl=args.disagg_min_isl,
        disagg_ratio=args.disagg_ratio,
        load_penalty_s=args.load_penalty_ms / 1000.0,
    )
    service = await GlobalRouterService(
        rt, host=args.host, port=args.port, config=config,
        staleness_scrape_s=args.staleness_scrape_s).start()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, rt.root_token.kill)
    print(f"ready port={service.port}", flush=True)
    try:
        await rt.root_token.wait_killed()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    await service.close()
    await rt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())

"""`python -m dynamo_tpu_torch.planner` — autoscale a worker fleet on
this host.

The JAX planner CLI's flags: it observes the fleet's load metrics and
scales `python -m <worker-module>` subprocesses between --min-replicas
and --max-replicas (or a Kubernetes Deployment with `--connector
kubernetes`); `--mode sla` plans against a profile that `python -m
dynamo_tpu_torch.profiler` took, and `--fleet-scrape` feeds the fleet
observer (obs/fleet.py) into every tick and the straggler quarantine.
Prints `planner running` once the first replicas are spawned; SIGTERM
or SIGINT stops the planner, drains the replicas and exits 0.

Example (the port's worker on the CPU):
    python -m dynamo_tpu_torch.planner --worker-module dynamo_tpu_torch.engine \
        --worker-arg=--device=cpu --worker-arg=--model=tiny
"""

import argparse
import asyncio
import logging
import signal

from ..runtime import DistributedRuntime
from ..runtime.logging import setup_logging
from .connectors import SubprocessConnector
from .planner import Planner, PlannerConfig

logger = logging.getLogger(__name__)


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.planner")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--connector", default="subprocess",
                   choices=["subprocess", "kubernetes"],
                   help="EXECUTE target: subprocess fleet on this host, "
                        "or a K8s Deployment's scale subresource")
    p.add_argument("--worker-module",
                   help="module spawned per replica (subprocess connector;"
                        " e.g. dynamo_tpu_torch.engine)")
    p.add_argument("--worker-arg", action="append", default=[],
                   help="argument passed to each worker (repeatable)")
    p.add_argument("--k8s-deployment",
                   help="Deployment name to scale (kubernetes connector); "
                        "API/namespace/token from DYN_K8S_* or in-cluster")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--target-active-per-replica", type=float, default=4.0)
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--cooldown", type=float, default=5.0)
    p.add_argument("--predictor", default="ema",
                   choices=["constant", "ema", "linear"])
    # SLA mode: plan under latency targets against a profiled perf model
    # (produce one with `python -m dynamo_tpu_torch.profiler`)
    p.add_argument("--mode", default="load", choices=["load", "sla"])
    p.add_argument("--ttft-target-ms", type=float, default=None)
    p.add_argument("--itl-target-ms", type=float, default=None)
    p.add_argument("--perf-model", default=None,
                   help="perf profile JSON (required for --mode sla)")
    # burn-rate actuation (obs/slo.py burn_by_phase via the frontends'
    # slo_metrics stream): fast burn forces scale-up ahead of the
    # predictor; --phase scopes which breach reason actuates this
    # planner instance (disagg P/D-ratio control: one planner per pool)
    p.add_argument("--burn-up-threshold", type=float, default=2.0,
                   help="SLO burn rate that forces +1 replica ahead of "
                        "the load predictor (0 disables)")
    p.add_argument("--phase", default="", choices=["", "prefill", "decode"],
                   help="disagg pool this planner scales: TTFT burn "
                        "actuates prefill, ITL burn decode, '' any")
    # drain-gated scale-down + straggler quarantine
    p.add_argument("--no-drain-scale-down", action="store_true",
                   help="hard-stop victims instead of drain-gating "
                        "scale-down")
    p.add_argument("--no-quarantine", action="store_true",
                   help="disable the straggler-quarantine actuation")
    p.add_argument("--quarantine-hold-s", type=float, default=30.0,
                   help="readmission delay for a quarantined straggler "
                        "(doubles per flap)")
    p.add_argument("--term-grace-s", type=float, default=15.0,
                   help="subprocess scale-down: seconds between SIGTERM "
                        "(triggers the worker's drain) and SIGKILL — "
                        "size to the workers' --drain-deadline-s plus "
                        "margin")
    # fleet introspection (obs/fleet.py): merged /metrics + /debug/state
    # scrapes folded into every tick's diag and exported as
    # dynamo_fleet_* gauges on this process's /metrics
    p.add_argument("--fleet-scrape", action="store_true",
                   help="run a FleetObserver: scrape every discovered "
                        "instance's debug surface (DYN_ADMIN_TOKEN), "
                        "feed fleet_imbalance/straggler/kv_headroom "
                        "into planner diag, export dynamo_fleet_* "
                        "gauges")
    p.add_argument("--fleet-interval", type=float, default=5.0,
                   help="seconds between fleet scrapes")
    return p


async def main() -> None:
    setup_logging()
    args = build_args().parse_args()
    rt = await DistributedRuntime.detached().start()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, rt.root_token.kill)
    if args.connector == "kubernetes":
        from .connectors import KubernetesConnector

        if not args.k8s_deployment:
            raise SystemExit("--connector kubernetes needs "
                             "--k8s-deployment")
        connector = KubernetesConnector(args.k8s_deployment)
    else:
        if not args.worker_module:
            raise SystemExit("--connector subprocess needs "
                             "--worker-module")
        connector = SubprocessConnector(args.worker_module, args.worker_arg,
                                        term_grace_s=args.term_grace_s)
    fleet = None
    if args.fleet_scrape:
        from ..obs.fleet import FleetObserver

        fleet = await FleetObserver(
            runtime=rt, namespace=args.namespace,
            interval_s=args.fleet_interval).start()
    planner = Planner(
        rt, args.namespace, args.component, connector,
        fleet=fleet,
        config=PlannerConfig(
            interval_s=args.interval,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            target_active_per_replica=args.target_active_per_replica,
            cooldown_s=args.cooldown,
            predictor=args.predictor,
            mode=args.mode,
            ttft_target_s=(args.ttft_target_ms / 1e3
                           if args.ttft_target_ms else None),
            itl_target_s=(args.itl_target_ms / 1e3
                          if args.itl_target_ms else None),
            perf_model_path=args.perf_model,
            burn_up_threshold=args.burn_up_threshold,
            phase=args.phase,
            drain_on_scale_down=not args.no_drain_scale_down,
            quarantine=not args.no_quarantine,
            quarantine_hold_s=args.quarantine_hold_s,
        ),
    )
    await connector.scale(args.min_replicas)
    await planner.start()
    print("planner running", flush=True)
    try:
        await rt.root_token.wait_killed()
    except asyncio.CancelledError:
        pass
    await planner.close()
    if fleet is not None:
        await fleet.close()
    await connector.close()
    await rt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())

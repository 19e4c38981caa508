"""`python -m dynamo_tpu_torch.router` — standalone KV-aware router service.

A copy of `python -m dynamo_tpu.router` on the port's runtime, KvRouter
and KvRouterConfig, with its flags, endpoints and answers: frontends
that do not embed a KvRouter query this component for placement
decisions instead.

Endpoints (component defaults to "router"):
    find_best_worker     PreprocessedRequest dict ->
                         {instance_id, router_instance_id, request_blocks,
                          overlap_blocks}
                         or, when the router selects no worker:
                         {error: "no_workers_available", router_instance_id}
    mark_prefill_completed  {request_id} -> {ok}
    free                 {request_id} -> {ok}

Multiple standalone routers converge through replica sync
(router/replica_sync.py) like embedded ones.  AFFINITY: callers must send
mark_prefill_completed/free for a request to the SAME router instance that
answered its find_best_worker (use the returned router_instance_id) — the
request's local slot entry lives only there; peers track it under a
router-qualified key.
"""

import argparse
import asyncio
import logging

from ..protocols import PreprocessedRequest
from ..runtime import DistributedRuntime
from ..runtime.discovery import new_instance_id
from ..runtime.logging import setup_logging
from .kv_router import KvRouter
from .selector import KvRouterConfig

logger = logging.getLogger(__name__)


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.router")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend",
                   help="worker component to route over")
    p.add_argument("--router-component", default="router",
                   help="component name this service registers as")
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    return p


async def main() -> None:
    setup_logging()
    args = build_args().parse_args()
    rt = await DistributedRuntime.detached().start()
    client = await (rt.namespace(args.namespace).component(args.component)
                    .endpoint("generate").client()).start()
    router = await KvRouter(
        rt, args.namespace, args.component, client,
        block_size=args.block_size,
        config=KvRouterConfig(
            overlap_score_weight=args.kv_overlap_score_weight,
            temperature=args.router_temperature,
        ),
    ).start()

    async def find_best_worker(payload, ctx):
        request = PreprocessedRequest.from_dict(payload)
        worker = await router.pick(request)
        if worker is None:
            # distinguishable from a placement: the selector had no
            # candidate
            yield {"error": "no_workers_available",
                   "router_instance_id": instance_id}
            return
        yield {
            "instance_id": worker,
            "router_instance_id": instance_id,
            "request_blocks": (len(request.token_ids) + args.block_size - 1)
            // args.block_size,
            "overlap_blocks": router.sequences.overlap_of(
                request.request_id),
        }

    async def mark_prefill_completed(payload, ctx):
        router.mark_prefill_completed(payload["request_id"])
        yield {"ok": True}

    async def free(payload, ctx):
        router.complete(payload["request_id"])
        yield {"ok": True}

    comp = rt.namespace(args.namespace).component(args.router_component)
    instance_id = new_instance_id()
    served = [
        await comp.endpoint("find_best_worker").serve_endpoint(
            find_best_worker, instance_id=instance_id),
        await comp.endpoint("mark_prefill_completed").serve_endpoint(
            mark_prefill_completed, instance_id=instance_id),
        await comp.endpoint("free").serve_endpoint(
            free, instance_id=instance_id),
    ]
    print(f"ready instance_id={instance_id}", flush=True)
    try:
        await rt.root_token.wait_killed()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    for s in served:
        await s.shutdown()
    await router.close()
    await client.close()
    await rt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())

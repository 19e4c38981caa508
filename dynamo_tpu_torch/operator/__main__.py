"""`python -m dynamo_tpu_torch.operator` — run the graph reconcile loop.

A copy of `python -m dynamo_tpu.operator` with its flags: a single
asyncio process.  Credentials resolve exactly like every other component
(in-cluster service account, or DYN_K8S_* for dev).
"""

import argparse
import asyncio
import logging

from .reconciler import GraphOperator


def main() -> None:
    ap = argparse.ArgumentParser(description="dynamo_tpu_torch graph operator")
    ap.add_argument("--api-url", default="", help="K8s API (default: "
                    "in-cluster / DYN_K8S_API)")
    ap.add_argument("--namespace", default="")
    ap.add_argument("--interval", type=float, default=10.0,
                    help="reconcile resync period, seconds")
    ap.add_argument("--once", action="store_true",
                    help="single reconcile pass (CI / dry-run)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)

    async def run():
        op = GraphOperator(api_url=args.api_url, namespace=args.namespace,
                           interval_s=args.interval)
        try:
            if args.once:
                await op.reconcile_once()
            else:
                await op.run()
        finally:
            await op.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()

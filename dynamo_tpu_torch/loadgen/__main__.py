"""`python -m dynamo_tpu_torch.loadgen`: replay a trace against a live
cluster over the port's runtime, with `python -m dynamo_tpu.loadgen`'s
flags.

Drives worker `generate` endpoints over the request plane with
PreprocessedRequest payloads (exact ISL/OSL control, like the reference's
token-level router benchmarks) and prints the TTFT/ITL/goodput report as
one JSON object.

    # synthetic load against the default backend component
    python -m dynamo_tpu_torch.loadgen --synthesize 200 --rate 8 \
        --input-len 512 --output-len 64 --slo-ttft 2.0 --slo-itl 0.025

    # a recorded mooncake-style JSONL trace, 4x faster than recorded
    python -m dynamo_tpu_torch.loadgen --trace trace.jsonl --speedup 4
"""

from __future__ import annotations

import argparse
import asyncio
import json

from ..runtime import DistributedRuntime, RouterMode
from .replay import replay
from .trace import load_trace, save_trace, synthesize


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.loadgen")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--trace", default="", help="mooncake-style JSONL trace")
    p.add_argument("--synthesize", type=int, default=0,
                   help="generate N synthetic requests instead of --trace")
    p.add_argument("--save-trace", default="",
                   help="write the synthesized trace to this path")
    p.add_argument("--rate", type=float, default=4.0, help="arrivals/s")
    p.add_argument("--input-len", type=int, default=256)
    p.add_argument("--output-len", type=int, default=32)
    p.add_argument("--prefix-groups", type=int, default=0)
    p.add_argument("--prefix-blocks", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16,
                   help="token block size for hash_ids expansion (must "
                        "match the serving engine's)")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--speedup", type=float, default=1.0)
    p.add_argument("--max-concurrency", type=int, default=256)
    p.add_argument("--slo-ttft", type=float, default=None)
    p.add_argument("--slo-itl", type=float, default=None)
    p.add_argument("--router-mode", default="round_robin",
                   choices=[m.value for m in RouterMode])
    return p


async def main() -> None:
    args = build_args().parse_args()
    if args.synthesize:
        rows = synthesize(
            args.synthesize, rate_rps=args.rate, input_len=args.input_len,
            output_len=args.output_len, block_size=args.block_size,
            prefix_groups=args.prefix_groups,
            prefix_blocks=args.prefix_blocks,
        )
        if args.save_trace:
            save_trace(args.save_trace, rows)
    elif args.trace:
        rows = load_trace(args.trace)
    else:
        raise SystemExit("need --trace or --synthesize N")

    rt = await DistributedRuntime.detached().start()
    client = await (
        rt.namespace(args.namespace).component(args.component)
        .endpoint("generate")
        .client(router_mode=RouterMode(args.router_mode))
    ).start()
    await client.wait_for_instances()

    report = await replay(
        client.generate, rows, block_size=args.block_size,
        vocab_size=args.vocab_size, speedup=args.speedup,
        max_concurrency=args.max_concurrency,
    )
    print(json.dumps(report.summary(slo_ttft_s=args.slo_ttft,
                                    slo_itl_s=args.slo_itl)))
    await client.close()
    await rt.shutdown()


if __name__ == "__main__":
    asyncio.run(main())

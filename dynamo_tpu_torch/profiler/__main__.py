"""`python -m dynamo_tpu_torch.profiler` — self-benchmark the port's
engine and write the perf-profile JSON the SLA planner plans against.

The JAX profiler CLI's flags.  `--engine torch` (the default) sweeps a
TorchEngine built from the engine flags, warmed up first (every program
serving reaches is built before the sweep), on `--device` (CUDA unless
`--device cpu` asks for the plain attention versions); `--engine mock`
sweeps the simulator (mocker/, host only, real-time steps), as JAX's
`--engine mock` does.

    python -m dynamo_tpu_torch.profiler --model-path DIR \\
        --out profile.json --isls 128,512 --concurrencies 1,2,4,8
    python -m dynamo_tpu_torch.profiler --device cpu --model tiny
    python -m dynamo_tpu_torch.profiler --engine mock --isls 128,512
"""

import argparse
import asyncio
import sys

from ..runtime.logging import setup_logging


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.profiler")
    p.add_argument("--engine", default="torch", choices=["torch", "mock"])
    p.add_argument("--out", default="profile.json")
    p.add_argument("--isls", default="128,512,2048",
                   help="comma-separated prompt lengths")
    p.add_argument("--concurrencies", default="1,2,4,8,16")
    p.add_argument("--osl", type=int, default=32)
    p.add_argument("--rounds", type=int, default=2)
    # engine shape (the engine CLI's flags)
    p.add_argument("--model", default="tiny")
    p.add_argument("--model-path", default="")
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--max-blocks-per-seq", type=int, default=64)
    p.add_argument("--max-num-seqs", type=int, default=16)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits non-zero without CUDA), "
                        "cuda:N, or cpu (the plain attention versions)")
    return p


def _torch_engine(args, device):
    """The TorchEngine the engine flags describe, on `device`."""
    from ..engine.config import EngineConfig
    from ..engine.core import TorchEngine

    config = EngineConfig(
        model=args.model, model_path=args.model_path,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_blocks_per_seq=args.max_blocks_per_seq,
        max_num_seqs=args.max_num_seqs, tp=args.tp,
    )
    return TorchEngine(config, device=device)


async def main(args) -> int:
    from . import profile_engine

    isls = [int(x) for x in args.isls.split(",") if x]
    concs = [int(x) for x in args.concurrencies.split(",") if x]
    if args.engine == "mock":
        from ..mocker import MockEngine, MockEngineArgs

        engine = MockEngine(MockEngineArgs(speedup_ratio=1.0))
        name = "mock"
    else:
        from ..device import resolve_device

        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"dynamo_tpu_torch.profiler: {e}", file=sys.stderr)
            return 2
        engine = _torch_engine(args, device)
        name = args.model_path or args.model
    try:
        if args.engine == "torch":
            await asyncio.to_thread(engine.warmup_decode)
        prof = await profile_engine(
            engine, model_name=name, isls=isls, osl=args.osl,
            concurrencies=concs, rounds=args.rounds,
        )
    finally:
        await engine.close()
    prof.save(args.out)
    print(f"wrote {len(prof.points)} grid points to {args.out}", flush=True)
    for pt in prof.points:
        print(f"  isl={pt.isl:5d} c={pt.concurrency:3d} "
              f"ttft_p95={pt.ttft_p95_s * 1e3:8.1f}ms "
              f"itl_p95={pt.itl_p95_s * 1e3:7.2f}ms "
              f"rps={pt.req_per_s:7.2f}", flush=True)
    return 0


def run(argv=None) -> int:
    setup_logging()
    return asyncio.run(main(build_args().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(run())

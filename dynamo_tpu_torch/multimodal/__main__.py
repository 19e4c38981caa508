"""`python -m dynamo_tpu_torch.multimodal` — run an encoder worker.

The counterpart of `python -m dynamo_tpu.multimodal`, with its flags and
defaults and `--device`, CUDA by default (without CUDA it exits
non-zero unless `--device cpu` asks for the CPU).  The encode fleet of
encoder/decoder disaggregation; pair it with an LLM fleet serving the
same --model-name behind the JAX frontend:

    python -m dynamo_tpu_torch.multimodal --model-name llava-x --encoder vit
    python -m dynamo_tpu_torch.engine --model-name llava-x
    python -m dynamo_tpu.frontend

The runtime is configured from the `DYN_*` environment (runtime/config.py).
Prints `ready instance_id=<id>` once registered; SIGTERM deregisters
and exits.
"""

import argparse
import asyncio
import sys

from ..device import resolve_device
from ..runtime import DistributedRuntime
from ..runtime.aio import install_drain_handler
from ..runtime.logging import setup_logging
from .encoder import MockVisionEncoder, VisionConfig, VitEncoder
from .worker import EncoderWorker


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dynamo_tpu_torch.multimodal")
    p.add_argument("--model-name", required=True,
                   help="LLM model this encoder fleet serves")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="encoder")
    p.add_argument("--encoder", default="mock", choices=["mock", "vit"])
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--vision-dim", type=int, default=128)
    p.add_argument("--vision-layers", type=int, default=2)
    p.add_argument("--out-dim", type=int, default=512,
                   help="LLM embedding width")
    p.add_argument("--cache-capacity", type=int, default=32)
    p.add_argument("--image-token-id", type=int, default=0,
                   help="placeholder token the frontend splices per "
                        "embedding position")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits non-zero without CUDA), "
                        "cuda:N, or cpu")
    return p


async def main() -> int:
    setup_logging()
    args = build_args().parse_args()
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dynamo_tpu_torch.multimodal: {e}", file=sys.stderr)
        return 2
    if args.encoder == "vit":
        encoder = VitEncoder(VisionConfig(
            image_size=args.image_size, patch_size=args.patch_size,
            d_model=args.vision_dim, n_layers=args.vision_layers,
            out_dim=args.out_dim,
        ), device=device)
    else:
        encoder = MockVisionEncoder(out_dim=args.out_dim)
    rt = await DistributedRuntime.detached().start()
    worker = await EncoderWorker(
        rt, args.model_name, encoder=encoder,
        namespace=args.namespace, component=args.component,
        cache_capacity=args.cache_capacity,
        image_token_id=args.image_token_id,
    ).start()

    async def stop() -> None:
        rt.root_token.kill()

    install_drain_handler(stop)
    print(f"ready instance_id={worker.served.instance_id}", flush=True)
    try:
        await rt.root_token.wait_killed()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    await worker.close()
    await rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))

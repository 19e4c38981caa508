"""Device ops of the port: paged KV writes, decode and packed-prefill
attention (plain PyTorch versions plus their CUDA kernels' wrappers)."""

"""The port's benchmarks: `python -m dynamo_tpu_torch.bench.<name>` on a
CUDA card."""

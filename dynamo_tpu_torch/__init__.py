"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu's engine and
its worker (`python -m dynamo_tpu_torch.engine`, on the port's own copy
of the distributed runtime in runtime/).

A second package beside the JAX one (`dynamo_tpu/`, the reference it is
held against), for one NVIDIA H100.  It imports `torch`, never `jax`, and
nothing of `dynamo_tpu`: the jax-free modules it needs are copied, with
the JAX package's module names so each counterpart is easy to find.

Entry points default to `device="cuda"` and raise when CUDA is absent;
the CPU runs only when the caller asks for it (device.py).  Attention
runs through hand-written CUDA kernels (csrc/, built at first use by
ops/_build.py) on CUDA tensors and through their plain PyTorch versions
on CPU tensors.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

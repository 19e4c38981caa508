"""Device ops of the port: paged KV writes, decode and packed-prefill
attention (plain PyTorch versions plus their CUDA kernels' wrappers)."""


def launch_counts() -> dict:
    """Each kernel wrapper's launches in this process (K1 and K3, both
    modes), by the wrapper's name."""
    from . import cuda_packed_prefill as k3
    from . import cuda_paged_attention as k1

    return {fn.__name__: fn.launches
            for fn in (k1.paged_decode, k1.paged_decode_int8,
                       k3.packed_prefill, k3.packed_prefill_int8)}

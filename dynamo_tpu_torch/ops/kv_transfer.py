"""KV blocks out of and into the paged cache, in the universal layout.

The counterparts of the JAX engine's `_gather_impl` and `_inject_impl`
(dynamo_tpu/engine/core.py), which XLA runs there (no Pallas kernel).
Payloads cross between engines in the universal transfer layout
[L, nb, bs, nkv, hd], whatever either side's cache layout: the port's
cache is [L, nkv, NB, bs, hd] (ops/paged_attention.py), the JAX
package's [L, nkv, NB, hd, bs], so the permutes differ and the payload
does not.  An int8 cache's fp32 scale planes [L, nkv, NB, bs] move
verbatim as [L, nb, bs, nkv].

Both are plain torch index ops on the cache's device: `index_select`
for the gather, and an in-place `index_copy_` for the inject, so the
cache keeps its address and the captured CUDA graphs (engine/graphs.py)
stay valid.  `ids` are the cache's block ids, in payload order, with no
padding (eager torch has no shape buckets to fill).

On a tensor-parallel rank (parallel/mesh.py) the cache holds the rank's
kv heads only, so `gather_universal` returns the rank's slab of the
payload (the leader gathers the slabs into the logical blocks over the
tensor group, parallel/mesh.py gather_slabs), and `inject_universal`
takes a logical payload and writes the rank's kv heads of it (`heads`).
MLA's latent cache is whole on every rank: its gather is the leader's
copy and its inject writes the whole payload (`heads=None`).

KVBM moves single blocks between the cache and host memory
(`blocks_to_host` / `blocks_from_host`), each block its own tensor tuple
in the universal per-block layout [L, bs, nkv, hd] (scales [L, bs, nkv]):
the gather is block-major, so each block's device-to-host copy is one
contiguous copy into its own pinned tensor, and the upload copies each
block's pinned tensor straight into a device staging buffer.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..parallel.mesh import payload_slab

Ids = Union[torch.Tensor, Sequence[int]]


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`; a host tensor goes up from pinned memory (a
    pageable upload synchronizes the stream first, so the host would wait
    out every burst in flight; the caching host allocator keeps the
    pinned block until the copy has run)."""
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _ids(ids: Ids, device: torch.device) -> torch.Tensor:
    if not isinstance(ids, torch.Tensor):
        ids = torch.tensor(list(ids), dtype=torch.long)
    return _to(ids.to(torch.long), device)


def gather_universal(kv: Tuple[torch.Tensor, ...],
                     ids: Ids) -> Tuple[torch.Tensor, ...]:
    """Blocks `ids` of the cache `kv` ((k, v) or (k, v, k_scale,
    v_scale)) as contiguous universal-layout tensors: (kb, vb)
    [L, nb, bs, nkv, hd], plus (ksb, vsb) [L, nb, bs, nkv] for an int8
    cache; nkv the kv heads the cache holds (a tensor-parallel rank's
    slab)."""
    idx = _ids(ids, kv[0].device)
    out = [t.index_select(2, idx).permute(0, 2, 3, 1, 4).contiguous()
           for t in kv[:2]]
    out += [t.index_select(2, idx).permute(0, 2, 3, 1).contiguous()
            for t in kv[2:]]
    return tuple(out)


def inject_universal(kv: Tuple[torch.Tensor, ...], kb: torch.Tensor,
                     vb: torch.Tensor, ids: Ids,
                     ksb: torch.Tensor = None,
                     vsb: torch.Tensor = None,
                     heads: Optional[slice] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Write universal-layout blocks into blocks `ids` of the cache `kv`,
    in place, and return it.  The payload is moved to the cache's device
    (through pinned memory from the host) and cast to its dtype; an int8
    cache needs the scale planes ksb/vsb.  `heads`: the payload's kv
    heads this cache holds (a tensor-parallel rank's slab of a logical
    payload); None writes every head."""
    if (len(kv) == 4) != (ksb is not None and vsb is not None):
        raise ValueError(
            f"a cache of {len(kv)} arrays needs "
            f"{'the' if len(kv) == 4 else 'no'} scale planes")
    dev = kv[0].device
    idx = _ids(ids, dev)
    kb, vb, *scales = payload_slab(
        (kb, vb) + ((ksb, vsb) if ksb is not None else ()), heads)
    ksb, vsb = scales if scales else (None, None)
    for t, b in zip(kv, (kb, vb)):
        t.index_copy_(2, idx, _to(b, dev).to(t.dtype).permute(0, 3, 1, 2, 4))
    for t, b in zip(kv[2:], (ksb, vsb)):
        t.index_copy_(2, idx, _to(b, dev).to(t.dtype).permute(0, 3, 1, 2))
    return kv


def blocks_to_host(kv: Tuple[torch.Tensor, ...], ids: Ids,
                   stream=None) -> List[Tuple[torch.Tensor, ...]]:
    """Blocks `ids` of the cache `kv` as one host tensor tuple each: (k, v)
    [L, bs, nkv, hd], plus (k_scale, v_scale) [L, bs, nkv] for an int8
    cache.  The gather runs on the current stream, after the work queued
    there (so it reads the blocks before any later write to them).  From a
    CUDA cache the copies go into pinned tensors and are asynchronous, on
    `stream` when given (a side stream: the copies overlap the next
    kernels instead of delaying them): record an event on that stream
    after this call and read no byte before it has completed."""
    idx = _ids(ids, kv[0].device)
    # block-major [nb, L, bs, nkv(, hd)]: one contiguous slab per block
    major = [t.index_select(2, idx).permute(2, 0, 3, 1, 4).contiguous()
             for t in kv[:2]]
    major += [t.index_select(2, idx).permute(2, 0, 3, 1).contiguous()
              for t in kv[2:]]
    ctx = contextlib.nullcontext()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(kv[0].device))
        for g in major:  # not reused before the side stream's copies ran
            g.record_stream(stream)
        ctx = torch.cuda.stream(stream)
    out = []
    with ctx:
        for i in range(len(idx)):
            blk = []
            for g in major:
                # a tensor of its own per block: a view into the batch
                # would keep the whole batch alive as long as any one
                # block lives
                host = torch.empty(g.shape[1:], dtype=g.dtype,
                                   pin_memory=g.is_cuda)
                blk.append(host.copy_(g[i], non_blocking=True))
            out.append(tuple(blk))
    return out


def blocks_from_host(kv: Tuple[torch.Tensor, ...],
                     blocks: Sequence[Tuple[torch.Tensor, ...]],
                     ids: Ids) -> Tuple[torch.Tensor, ...]:
    """Write host blocks (blocks_to_host's layout) into blocks `ids` of
    the cache `kv`, in place: each block's tensors are uploaded into a
    device staging buffer (a block not in pinned memory is pinned first:
    a pageable upload would wait out the stream), then one
    inject_universal."""
    dev = kv[0].device
    staged = []
    for c in range(len(kv)):
        first = blocks[0][c]
        st = torch.empty((len(blocks), *first.shape), dtype=first.dtype,
                         device=dev)
        for i, blk in enumerate(blocks):
            src = blk[c]
            if dev.type == "cuda" and not src.is_pinned():
                src = src.pin_memory()
            st[i].copy_(src, non_blocking=True)
        staged.append(st.transpose(0, 1))  # universal [L, nb, ...]
    return inject_universal(kv, staged[0], staged[1], ids, *staged[2:])

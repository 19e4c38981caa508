"""Ring attention: sequence-parallel exact attention for long context.

The counterpart of dynamo_tpu/ops/ring_attention.py, per rank.  There the
sequence axis is sharded over the mesh's "sp" axis and one shard_map
program rotates the K/V shards around the ring with `lax.ppermute`; here
each rank is a process (parallel/mesh.py) that holds one query shard and
one K/V shard, and its ring group (`RingGroup`) passes the K/V shard to
the next rank and takes the previous rank's, sp - 1 times.  So, as
there:

  * memory per rank is O(T / sp): the score block of a step is the
    rank's queries against one K/V shard, never the whole square, and
    its query rows are tiled so that one block stays under
    SCORE_BLOCK_BYTES;
  * the result is EXACT attention: the flash-style online-softmax
    update of JAX's `_online_update`, line for line, fp32 accumulators,
    the finite -1e30 mask value, causal masking by global positions and
    `l == 0 -> 1` for a row with no unmasked key, the output in q's
    dtype;
  * GQA is native: K/V shards carry only the kv heads, and the scores
    run in the grouped layout [T, G = kv heads, R = q heads per group].

The shards are taken in JAX's order: the resident shard first, then,
after i hops, the shard that started at ring position (me - i) mod sp.
Each hop is posted before the rank attends to the shard it holds, so
the transfer overlaps that step's products.  A shard whose every key
lies after every query of the rank (causal, src > me) is skipped: JAX
attends to it and its masked update leaves o, m and l bit-for-bit as
they were (p = 0, alpha = 1), so the result is the same.  It still
travels, since the ranks after it need it, and `on_shard` sees every
shard: the caller writes the whole prompt's K/V into its own cache from
the shards as they arrive, with no collective of its own
(models/llama.py prefill_ring).

Under tensor parallelism the heads are the rank's own (JAX's
`head_axis="tp"`): a rank's ring is the sp ranks of its tensor
coordinate, and nothing crosses the tensor group.

The JAX module has no Pallas kernel (it is jnp under shard_map), and
this one is plain torch, as ROADMAP.md's rule for device paths without
one has it.  `attention_reference` is JAX's single-device oracle, the
plain version the tests and the chip check hold the ring against.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

_NEG_INF = -1e30  # finite -inf stand-in: keeps exp/max NaN-free
# bytes of one fp32 score block [B, rows, Hq, Tk] that ring_attention's
# query tile stays under
SCORE_BLOCK_BYTES = 1 << 29


def _online_update(o, m, l, s, v):
    """One flash-attention accumulator update, grouped GQA layout (JAX's
    `_online_update` with a leading batch axis).

    o [B, T, G, R, D] f32, m/l [B, T, G, R] f32, s [B, T, G, R, Tk] f32
    scores (already masked), v [B, Tk, G, D]: G = kv heads, R = q heads
    per group."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with no unmasked key yet: keep the exponent base at 0 to avoid
    # exp(large); their p and alpha both come out 0/1 harmlessly
    base = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - base[..., None])                  # [B, T, G, R, Tk]
    p = torch.where(s <= _NEG_INF / 2, 0.0, p)
    alpha = torch.exp(torch.where(m <= _NEG_INF / 2, 0.0, m) - base)
    alpha = torch.where(m <= _NEG_INF / 2,
                        torch.where(m_new <= _NEG_INF / 2, 1.0, 0.0), alpha)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("btgrs,bsgd->btgrd", p, v.float())
    o_new = o * alpha[..., None] + pv
    return o_new, m_new, l_new


def _q_block(B: int, hq: int, tk: int) -> int:
    """Query rows a score block of SCORE_BLOCK_BYTES holds (at least 1)."""
    return max(1, SCORE_BLOCK_BYTES // (4 * B * hq * tk))


def ring_attention(
    q: torch.Tensor,             # [B, Tq, Hq, D] this rank's query shard
    k: torch.Tensor,             # [B, Tk, Hkv, D] this rank's K/V shard
    v: torch.Tensor,
    ring=None,                   # parallel/mesh.py RingGroup; None: sp = 1
    causal: bool = True,
    sm_scale: Optional[float] = None,
    on_shard: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                None]] = None,
) -> torch.Tensor:
    """Exact attention of this rank's queries over every rank's keys,
    with the sequence sharded over the ring: rank s holds global
    positions [s * Tq, (s + 1) * Tq) of q and [s * Tk, (s + 1) * Tk) of
    k and v (JAX's `ring_attention` shard for shard; Tq == Tk there).
    Every rank of the ring calls this with its shards.

    `on_shard(src, k, v)` sees each K/V shard, the rank's own first,
    with the ring position it started at.  The query rows are taken in
    tiles of SCORE_BLOCK_BYTES of fp32 scores; the arithmetic of a row
    does not depend on the tiling.  Returns this rank's [B, Tq, Hq, D]
    in q's dtype."""
    sp = 1 if ring is None else ring.size
    me = 0 if ring is None else ring.rank
    B, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    r = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    q_block = _q_block(B, hq, tk)
    dev = q.device
    qg = q.reshape(B, tq, hkv, r, d).float()
    q_pos = me * tq + torch.arange(tq, device=dev)  # global query positions
    o = torch.zeros((B, tq, hkv, r, d), dtype=torch.float32, device=dev)
    m = torch.full((B, tq, hkv, r), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, tq, hkv, r), dtype=torch.float32, device=dev)

    def attend(kr, vr, src):
        k_pos = src * tk + torch.arange(tk, device=dev)
        kf = kr.float()
        for r0 in range(0, tq, q_block):
            r1 = min(tq, r0 + q_block)
            s = torch.einsum("btgrd,bsgd->btgrs", qg[:, r0:r1],
                             kf) * sm_scale
            if causal:
                mask = q_pos[r0:r1, None] >= k_pos[None, :]   # [rows, Tk]
                s = torch.where(mask[None, :, None, None, :], s, _NEG_INF)
            o[:, r0:r1], m[:, r0:r1], l[:, r0:r1] = _online_update(
                o[:, r0:r1], m[:, r0:r1], l[:, r0:r1], s, vr)

    src, kr, vr = me, k, v
    for i in range(sp):
        # post the next hop first: it runs while this shard is attended
        pending = (ring.exchange(torch.stack([kr, vr]))
                   if i < sp - 1 else None)
        if on_shard is not None:
            on_shard(src, kr, vr)
        # a shard wholly in every query's future is an exact no-op of the
        # masked update (see the module docstring)
        if not (causal and src * tk > me * tq + tq - 1):
            attend(kr, vr, src)
        if pending is not None:
            kv = pending()
            kr, vr = kv[0], kv[1]
            src = (me - i - 1) % sp
    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows -> 0 output
    return (o / l[..., None]).reshape(B, tq, hq, d).to(q.dtype)


def attention_reference(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-device exact attention, JAX's oracle for the ring (and the
    ring's plain version): q [B, T, Hq, D], k/v [B, T, Hkv, D], the same
    semantics computed globally."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    s = torch.einsum(
        "btgrd,bsgd->btgrs",
        q.reshape(b, t, hkv, hq // hkv, d).float(), k.float()) * sm_scale
    if causal:
        pos = torch.arange(t, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = torch.where(mask[None, :, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("btgrs,bsgd->btgrd", p, v.float())
    return o.reshape(b, t, hq, d).to(q.dtype)

"""Fused sampling epilogue: final projection -> token ids without a
[B, vocab] logits tensor.

The counterpart of dynamo_tpu/ops/fused_sampling.py.  Every decode step
ends with the [B, d] x [d, vocab] final projection; the reference path
(models/llama.py `_logits`, engine/sampler.py) writes the [B, vocab] fp32
logits and reads them back for an argmax or a top-CAP window.  Here the
projection runs in vocab TILES of DEFAULT_TILE columns (`_tile_plan`: the
last tile's start is clamped to vocab - tile, and its columns that
overlap the previous tile are masked to -inf, as JAX's dynamic_slice
plan does), and each tile is reduced at once into what sampling needs:

  * the maximum of the RAW logits and its first column (the sampler's
    greedy and temperature <= 0 contract: `argmax`, first maximum wins);
  * the top-CAP window of the TEMPERATURE-SCALED logits, ordered as
    `lax.top_k` orders the full vector (descending, equal values by
    ascending id: engine/sampler.py order_keys);
  * the logsumexp of the scaled logits, the normalizer top-p is measured
    against.

JAX threads these as carries through a fori_loop: a running argmax with
a strict `>`, a running window merged "running candidates first", an
online logsumexp.  The port keeps one row per tile of each statistic
(a [tiles, B] maximum and sum, a [tiles, B, CAP] window) and combines
them once after the last tile: the first tile holding the largest
maximum (argmax over tiles, which is the strict `>` of the running
form), the top-CAP of the tiles' windows under the same total order,
and the max-rescaled sum of the tiles' sums.  The results are the
running form's, the window bit for bit; the combine costs a handful of
device operations where the running merge costs a handful per tile.

`fused_sample_tokens` then replays engine/sampler.py's draw on the
window: the same fold_in(PRNGKey(seed), step) key, top-k clamp, nucleus
mask with the first candidate kept, and Gumbel-max categorical.  So
greedy tokens equal the reference path's wherever a tile's product
rounds as the same columns of the full product do (on the CPU, and on
the card up to cuBLAS choosing another algorithm for the tile's shape),
and sampled tokens equal them up to the logsumexp's summation order.

The JAX package writes this in XLA, not Pallas: it is not a TPU kernel.
The port writes it in plain torch (per-tile `torch.matmul` plus
reductions), inside the decode programs that engine/graphs.py captures
as CUDA graphs; it gets a hand-written kernel only on evidence from the
card (ROADMAP.md, "other device paths").
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engine.sampler import CAP, draw, mask_window, order_keys

#: vocab columns per streamed tile (the JAX package's value)
DEFAULT_TILE = 2048

#: EngineConfig.sampling_epilogue vocabulary
EPILOGUE_MODES = ("off", "fused")


def _tile_plan(V: int, tile: int):
    """Clamped tile width and count.  The last tile's start is clamped
    to V - tile, so its leading columns overlap the previous tile;
    `_tile_logits` masks them."""
    tile = max(1, min(tile, V))
    return tile, -(-V // tile)


def _tile_logits(h: torch.Tensor, w: torch.Tensor, i: int, tile: int,
                 V: int):
    """One streamed tile: (fp32 logits [B, tile] with the clamped last
    tile's overlap columns at -inf, the tile's first column)."""
    start = min(i * tile, V - tile)
    lg = (h @ w[:, start:start + tile]).float()
    if start < i * tile:
        lg[:, :i * tile - start] = float("-inf")
    return lg, start


def _stream(h: torch.Tensor, w: torch.Tensor, tile: int,
            denom: Optional[torch.Tensor]):
    """One pass over the projection's tiles.  Returns (raw-logit maximum
    [B], its first column [B] int64) and, when `denom` [B] (the clamped
    temperatures) is given, (window values [B, CAP], window ids [B, CAP]
    int64, logsumexp [B]) of the scaled logits; else None."""
    B, V = h.shape[0], w.shape[1]
    tile, n_t = _tile_plan(V, tile if denom is None else max(tile, CAP))
    dev = h.device
    tv = torch.empty(n_t, B, dtype=torch.float32, device=dev)
    ta = torch.empty(n_t, B, dtype=torch.int64, device=dev)
    if denom is not None:
        tm = torch.empty(n_t, B, dtype=torch.float32, device=dev)
        ts = torch.empty(n_t, B, dtype=torch.float32, device=dev)
        wv = torch.empty(n_t, B, CAP, dtype=torch.float32, device=dev)
        wi = torch.empty(n_t, B, CAP, dtype=torch.int64, device=dev)
        local = torch.arange(tile, device=dev)
    for i in range(n_t):
        lg, start = _tile_logits(h, w, i, tile, V)
        torch.max(lg, dim=-1, out=(tv[i], ta[i]))
        if denom is None:
            continue
        sc = lg / denom[:, None]
        torch.amax(sc, dim=-1, out=tm[i])
        torch.sum(torch.exp(sc - tm[i][:, None]), dim=-1, out=ts[i])
        _, pos = torch.topk(order_keys(sc, local), CAP, dim=-1)
        torch.gather(sc, -1, pos, out=wv[i])
        torch.add(pos, start, out=wi[i])
    # the first tile holding the largest maximum: a later tile's equal
    # maximum never replaces it (the running form's strict `>`)
    j = torch.argmax(tv, dim=0)
    bv = tv.gather(0, j[None])[0]
    bi = ta.gather(0, j[None])[0] + torch.clamp(j * tile, max=V - tile)
    if denom is None:
        return (bv, bi), None
    cand_v = wv.transpose(0, 1).reshape(B, n_t * CAP)
    cand_i = wi.transpose(0, 1).reshape(B, n_t * CAP)
    _, pos = torch.topk(order_keys(cand_v, cand_i), CAP, dim=-1)
    m = tm.amax(dim=0)
    lse = m + torch.log(torch.sum(ts * torch.exp(tm - m[None]), dim=0))
    return (bv, bi), (cand_v.gather(-1, pos), cand_i.gather(-1, pos), lse)


def fused_greedy_tokens(h: torch.Tensor,  # [B, d] final-norm hidden
                        w: torch.Tensor,  # [d, vocab] unembedding matrix
                        *, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Streaming argmax of the final projection: the token ids [B] int32
    of sampler.greedy_tokens(_logits(...)), ties to the lowest id."""
    (_, bi), _ = _stream(h, w, tile, None)
    return bi.to(torch.int32)


def fused_sample_stats(h: torch.Tensor, w: torch.Tensor,
                       temperature: torch.Tensor, *,
                       tile: int = DEFAULT_TILE):
    """The statistics one streamed pass gathers, the JAX epilogue's final
    carries: (raw-logit maximum [B], its first column [B], window values
    [B, CAP], window ids [B, CAP], logsumexp [B] of the scaled logits).
    Requires vocab >= CAP, as lax.top_k does of the reference."""
    (bv, bi), (rv, ri, lse) = _stream(
        h, w, tile, torch.clamp(temperature, min=1e-6))
    return bv, bi, rv, ri, lse


def fused_sample_tokens(
    h: torch.Tensor,            # [B, d] final-norm hidden
    w: torch.Tensor,            # [d, vocab] unembedding matrix
    seeds: torch.Tensor,        # [B] int32 per-request seed
    steps: torch.Tensor,        # [B] int32 decode step counter (rng stream)
    temperature: torch.Tensor,  # [B] fp32; <= 0 means greedy
    top_k: torch.Tensor,        # [B] int; 0 disables
    top_p: torch.Tensor,        # [B] fp32; >= 1 disables
    *, tile: int = DEFAULT_TILE,
) -> torch.Tensor:
    """Streaming sample_tokens: one pass gathers (argmax, top-CAP window,
    logsumexp), then the sampler's masked-window draw runs on the window.
    Token ids [B] int32."""
    _, bi, rv, ri, lse = fused_sample_stats(h, w, temperature, tile=tile)
    sampled = draw(ri, mask_window(rv, lse, top_k, top_p), seeds, steps)
    return torch.where(temperature <= 0.0, bi.to(torch.int32), sampled)

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

Tensor parallelism (parallel/mesh.py): the unembedding splits over the
vocabulary (`lm_head` on dim 1, a tied embedding on dim 0), so a rank's
`w` is its slice [d, V/tp] of consecutive columns.  Given its tensor
group (`group`, models/llama.py `params["tp"]`) each rank streams its
slice alone, tiles planned over V/tp, and one gather of the ranks'
statistics (TensorGroup.gather_stats: [B, 2] when greedy, else
[B, 2 CAP + 3], never the [B, V/tp] logits) combines them
(`_combine_ranks`) into the single-device contract:

  * the maximum: the first rank holding the largest, so the first
    maximum by GLOBAL vocab index wins (each rank's own first maximum is
    its lowest column, and the ranks hold ascending column ranges);
  * the window: the top-CAP of the ranks' windows, their ids made
    global, under the same total order (value, then ascending id), so
    candidates of an earlier rank come first among equals, as an
    earlier tile's do;
  * the logsumexp: m + log sum_r exp(lse_r - m) over the ranks'.

Every rank then samples the same token (every statistic crossed the
group), so the ranks' device chains stay alike.  Greedy tokens are the
off path's argmax over the gathered logits wherever the slices' tiles
round as its columns do; sampled tokens draw from the same window with
a logsumexp that differs in its summation order only.

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


def _combine_ranks(group, V: int, best, window):
    """The tensor group's statistics from each rank's `_stream` over its
    vocab slice of V columns (rank r holds [r V, (r + 1) V)): one
    gather, then the single-device contract (module docstring).  Column
    ids (below 2^24) cross as exact fp32.  Returns `_stream`'s tuple
    with global ids."""
    bv, bi = best
    off = group.rank * V
    cols = [bv[:, None], (bi + off).float()[:, None]]
    if window is not None:
        rv, ri, lse = window
        cols += [lse[:, None], rv, (ri + off).float()]
    stats = group.gather_stats(torch.cat(cols, dim=1))  # [tp, B, n]
    # the first rank holding the largest maximum: torch.argmax returns
    # the first of equal maxima, and rank order is column order
    j = torch.argmax(stats[:, :, 0], dim=0)[None]
    best = (stats[:, :, 0].gather(0, j)[0],
            stats[:, :, 1].gather(0, j)[0].long())
    if window is None:
        return best, None
    B = bv.shape[0]
    cand_v = stats[:, :, 3:3 + CAP].transpose(0, 1).reshape(B, -1)
    cand_i = stats[:, :, 3 + CAP:].transpose(0, 1).reshape(B, -1).long()
    _, pos = torch.topk(order_keys(cand_v, cand_i), CAP, dim=-1)
    lses = stats[:, :, 2]
    m = lses.amax(dim=0)
    lse = m + torch.log(torch.sum(torch.exp(lses - m[None]), dim=0))
    return best, (cand_v.gather(-1, pos), cand_i.gather(-1, pos), lse)


def _stats(h: torch.Tensor, w: torch.Tensor, tile: int,
           denom: Optional[torch.Tensor], group):
    """`_stream` over w, combined over the tensor group when there is
    one (w then the rank's vocab slice)."""
    best, window = _stream(h, w, tile, denom)
    if group is None:
        return best, window
    return _combine_ranks(group, w.shape[1], best, window)


def fused_greedy_tokens(h: torch.Tensor,  # [B, d] final-norm hidden
                        w: torch.Tensor,  # [d, vocab] unembedding matrix
                        *, tile: int = DEFAULT_TILE,
                        group=None) -> torch.Tensor:
    """Streaming argmax of the final projection: the token ids [B] int32
    of sampler.greedy_tokens(_logits(...)), ties to the lowest id.  With
    a tensor group, w is the rank's vocab slice."""
    (_, bi), _ = _stats(h, w, tile, None, group)
    return bi.to(torch.int32)


def fused_sample_stats(h: torch.Tensor, w: torch.Tensor,
                       temperature: torch.Tensor, *,
                       tile: int = DEFAULT_TILE, group=None):
    """The statistics one streamed pass gathers, the JAX epilogue's final
    carries: (raw-logit maximum [B], its first column [B], window values
    [B, CAP], window ids [B, CAP], logsumexp [B] of the scaled logits).
    Requires vocab >= CAP, as lax.top_k does of the reference (with a
    tensor group, each rank's slice; the ids are global)."""
    (bv, bi), (rv, ri, lse) = _stats(
        h, w, tile, torch.clamp(temperature, min=1e-6), group)
    return bv, bi, rv, ri, lse


def fused_sample_tokens(
    h: torch.Tensor,            # [B, d] final-norm hidden
    w: torch.Tensor,            # [d, vocab] unembedding matrix
    seeds: torch.Tensor,        # [B] int32 per-request seed
    steps: torch.Tensor,        # [B] int32 decode step counter (rng stream)
    temperature: torch.Tensor,  # [B] fp32; <= 0 means greedy
    top_k: torch.Tensor,        # [B] int; 0 disables
    top_p: torch.Tensor,        # [B] fp32; >= 1 disables
    *, tile: int = DEFAULT_TILE, group=None,
) -> torch.Tensor:
    """Streaming sample_tokens: one pass gathers (argmax, top-CAP window,
    logsumexp), then the sampler's masked-window draw runs on the window.
    Token ids [B] int32.  With a tensor group, w is the rank's vocab
    slice and every rank draws the same tokens."""
    _, bi, rv, ri, lse = fused_sample_stats(h, w, temperature, tile=tile,
                                            group=group)
    sampled = draw(ri, mask_window(rv, lse, top_k, top_p), seeds, steps)
    return torch.where(temperature <= 0.0, bi.to(torch.int32), sampled)

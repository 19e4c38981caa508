"""The port's fused sampling epilogue against dynamo_tpu.ops.fused_sampling.

Given the same final-norm hidden state, unembedding matrix, seeds, steps,
temperatures, top-k and top-p, the port's `fused_greedy_tokens` and
`fused_sample_tokens` return the JAX package's tokens, and the port's
streamed statistics equal the full-vocab quantities JAX's epilogue
reproduces: the first maximum of the raw logits, the `lax.top_k` window
of the scaled logits (values and ids exactly) and their logsumexp (within
1e-5 relative: the two sum in other orders).  The cases cover vocab
sizes that are not a multiple of the tile (the clamped last tile, one
with fewer fresh columns than CAP), a tile wider than the vocab,
llama-3's 128256 columns at the default tile, and integer-valued inputs
whose products are exact in fp32, so ties are exact and everywhere:
across tile edges, at the CAP edge and at the maximum.  The port's fused
tokens also equal its own reference sampler's on the full logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import fused_sampling as jf
from dynamo_tpu_torch.engine import sampler
from dynamo_tpu_torch.ops import fused_sampling as tf

# (vocab, d, tile, integer-valued inputs)
CASES = {
    "even-tiles": (1024, 32, 256, False),
    "ragged": (1000, 32, 300, False),
    "ragged-ties": (1000, 16, 300, True),
    "last-tile-under-cap": (1090, 16, 128, True),
    "tile-over-vocab": (200, 16, 2048, True),
    "llama3-vocab": (128256, 8, tf.DEFAULT_TILE, True),
}
B = 6
SAMPLING = dict(temps=np.float32([0.0, 0.7, 1.0, 1.3, 0.5, 0.9]),
                top_ks=np.int32([0, 0, 5, 40, 0, 64]),
                top_ps=np.float32([1.0, 0.9, 1.0, 0.95, 0.5, 0.8]))


def test_constants_equal_jax():
    assert tf.CAP == jf.CAP == sampler.CAP
    assert tf.DEFAULT_TILE == jf.DEFAULT_TILE
    assert tf.EPILOGUE_MODES == jf.EPILOGUE_MODES
    for V, tile in ((128256, 2048), (1000, 300), (200, 2048), (64, 64),
                    (1, 7)):
        assert tf._tile_plan(V, tile) == jf._tile_plan(V, tile)


def _inputs(name):
    V, D, tile, ints = CASES[name]
    rng = np.random.default_rng(V + D)
    if ints:
        # small integers: every product and sum is exact in fp32, so the
        # logits are integers and tie exactly, in any summation order
        h = rng.integers(-2, 3, (B, D)).astype(np.float32)
        w = rng.integers(-2, 3, (D, V)).astype(np.float32)
    else:
        h = rng.standard_normal((B, D)).astype(np.float32)
        w = rng.standard_normal((D, V)).astype(np.float32)
    # a tie for the maximum straddling the first tile edge: the lower id
    # must win, in both streams
    t = min(tile, V)
    if t < V:
        w[:, t - 1] = w[:, t] = 4.0 * np.sign(h[0]) + (h[0] == 0)
    return V, tile, h, w


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_tokens_and_statistics_equal_jax(name):
    V, tile, h, w = _inputs(name)
    seeds = np.arange(B, dtype=np.int32) * 7 + 1
    steps = np.arange(B, dtype=np.int32) + 3
    s = SAMPLING
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    jh, jw = jnp.asarray(h), jnp.asarray(w)
    targs = [torch.from_numpy(a) for a in (seeds, steps, s["temps"],
                                           s["top_ks"], s["top_ps"])]
    jargs = [jnp.asarray(a) for a in (seeds, steps, s["temps"], s["top_ks"],
                                      s["top_ps"])]

    greedy = tf.fused_greedy_tokens(th, tw, tile=tile)
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jf.fused_greedy_tokens(jh, jw, tile=tile)))
    drawn = tf.fused_sample_tokens(th, tw, *targs, tile=tile)
    np.testing.assert_array_equal(
        drawn.numpy(),
        np.asarray(jf.fused_sample_tokens(jh, jw, *jargs, tile=tile)))

    # the streamed statistics: what JAX's carries reproduce over the
    # full vector (its logits, its argmax, its lax.top_k, its logsumexp)
    logits = jh @ jw
    scaled = logits / jnp.maximum(jnp.asarray(s["temps"]), 1e-6)[:, None]
    bv, bi, rv, ri, lse = tf.fused_sample_stats(th, tw, targs[2], tile=tile)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(logits.max(-1)))
    np.testing.assert_array_equal(bi.numpy(),
                                  np.asarray(jnp.argmax(logits, -1)))
    jv, ji = jax.lax.top_k(scaled, jf.CAP)
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.scipy.special.logsumexp(scaled, -1)),
        rtol=1e-5, atol=0)

    # and the port's reference path on the materialized logits
    full = torch.from_numpy(np.array(logits))
    np.testing.assert_array_equal(greedy.numpy(),
                                  sampler.greedy_tokens(full).numpy())
    np.testing.assert_array_equal(
        drawn.numpy(), sampler.sample_tokens(full, *targs).numpy())


def test_ties_resolve_to_the_lowest_id():
    """Integer inputs with a planted tie at the maximum across the first
    tile edge: the first (lowest) id wins the greedy stream, and the
    window holds equal values in ascending id order."""
    V, tile, h, w = _inputs("ragged-ties")
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    lg = h @ w
    assert lg[0, tile - 1] == lg[0, tile] == lg[0].max()
    assert int(tf.fused_greedy_tokens(th, tw, tile=tile)[0]) == tile - 1
    _, _, rv, ri, _ = tf.fused_sample_stats(th, tw, torch.ones(B),
                                            tile=tile)
    rv, ri = rv.numpy(), ri.numpy()
    assert (np.diff(rv, axis=-1) <= 0).all()
    same = rv[:, 1:] == rv[:, :-1]
    assert same.sum() > B  # ties inside the window ...
    assert (ri[:, 1:][same] > ri[:, :-1][same]).all()  # ... by ascending id
    # and the CAP edge cuts through a tie: the window keeps the lowest
    # ids of the value at its edge
    for b in range(B):
        edge = rv[b, -1]
        tied = np.flatnonzero(lg[b] == edge)
        kept = ri[b][rv[b] == edge]
        assert len(tied) > len(kept)
        np.testing.assert_array_equal(kept, tied[:len(kept)])

"""Token sampling: greedy / temperature / top-k / top-p.

The counterpart of dynamo_tpu/engine/sampler.py, with the same semantics:
sampling is restricted to the CAP (64) highest logits per row, the
requested top_k is clamped to CAP, and the top-p nucleus mass is measured
against the TRUE full-vocab softmax (logsumexp), with the first candidate
always kept.  temperature <= 0 is greedy over the full vocabulary.  The
window is ordered as `lax.top_k` orders it, equal values by ascending id
(order_keys), since the draw below indexes its noise by window position.

The draw is stateless, as in the JAX package: row b draws from the key
`fold_in(PRNGKey(seeds[b]), steps[b])` by the Gumbel-max trick
(`jax.random.categorical`).  The threefry2x32 hash, the key derivation,
the random bits and the uniform-to-Gumbel transform are written out here
in plain torch integer and float ops, with the constants and rotations of
`jax._src.prng` (threefry2x32, threefry_fold_in,
threefry_random_bits with jax_threefry_partitionable=True) and
`jax._src.random` (_uniform, _gumbel in its default "low" mode,
categorical).  So the bits equal JAX's bit for bit, and a seeded sampled
stream equals the JAX engine's token for token (up to an ulp of
-log(-log(u)) in the rare case that it decides an argmax).  Nothing reads
the host, so a sampled decode burst can be captured in a CUDA graph.
uint32 arithmetic is carried in int64 tensors masked to 32 bits (torch
has no full uint32 op set).

`spec_window_weights` and `spec_accept_tokens`, speculative decoding's
host-side rejection sampling, are numpy and copied verbatim: on the same
verify outputs and the same host RNG they accept and emit the same tokens.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

NEG_INF = -1e30

#: sampling candidate window (max effective top-k)
CAP = 64

_MASK = 0xFFFFFFFF
# threefry2x32: the rotations of even and odd rounds and the key-schedule
# parity constant (jax._src.prng._threefry2x32_lowering)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32 uniform in [tiny, 1) from 32 random bits (jax._src.random
# _uniform): 23 mantissa bits under the exponent of 1.0
_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000
_SPAN = float(np.float32(1.0) - np.float32(_TINY))  # maxval - minval in fp32


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary: [B, vocab] -> [B] int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash of counts (x1, x2) under key (k1, k2): int64
    tensors holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seeds: torch.Tensor):
    """`jax.random.PRNGKey` of int32 seeds [B]: the key words (0, seed as
    uint32), each [B] int64."""
    s = seeds.to(torch.int64) & _MASK
    return torch.zeros_like(s), s


def fold_in(key, data: torch.Tensor):
    """`jax.random.fold_in(key, data)` per row: data [B] int, taken as
    uint32, is hashed as the count pair (0, data)."""
    d = data.to(torch.int64) & _MASK
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` per row, the partitionable
    path: the counts are the uint64 iota split into (hi, lo) words and the
    two output words are xor-ed.  [B, n] int64."""
    k1, k2 = key[0][:, None], key[1][:, None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(key, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), float32)` per row ("low" mode):
    -log(-log(u)), u uniform in [tiny, 1).  [B, n] float32."""
    bits = (random_bits(key, n) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(floats * _SPAN + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def order_keys(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys that order the fp32 values `x` [..., n] descending and
    equal values by ascending column id `cols` (broadcast against x, ids
    below 2^31): the order of `lax.top_k`, which keeps the lower index
    first on a tie.  `torch.topk` promises no order among equal values,
    and bf16 logits tie often.  The float's bits are mapped to an integer
    of the same order (negative floats' magnitude bits flipped); NaN is
    not ordered."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return b * (1 << 32) - cols


def top_window(scaled: torch.Tensor, m: int = CAP):
    """(values, ids) [B, m] of the m (default CAP) largest of `scaled`
    [B, n], sorted descending with ties to the lower id, as `lax.top_k`."""
    n = scaled.shape[-1]
    _, ids = torch.topk(order_keys(scaled, torch.arange(
        n, device=scaled.device)), min(m, n), dim=-1)
    return torch.gather(scaled, -1, ids), ids


def mask_window(vals: torch.Tensor, lse: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """The window `vals` [B, n] (scaled logits, descending) with NEG_INF
    on every candidate that top-k or top-p removes: top_k clamped to CAP,
    the nucleus mass measured against `lse` [B], the logsumexp of the
    full-vocab scaled logits, and the first candidate always kept."""
    k_eff = torch.clamp(torch.where(top_k > 0, top_k,
                                    torch.full_like(top_k, CAP)), 1, CAP)
    keep_k = torch.arange(vals.shape[-1], device=vals.device)[None, :] \
        < k_eff[:, None]
    cum = torch.cumsum(torch.exp(vals - lse[:, None]), dim=-1)
    first = torch.ones_like(cum[:, :1], dtype=torch.bool)
    keep_p = torch.cat([first, cum[:, :-1] < top_p[:, None]], dim=-1)
    return torch.where(keep_k & keep_p, vals, torch.full_like(vals, NEG_INF))


def draw(ids: torch.Tensor, masked: torch.Tensor, seeds: torch.Tensor,
         steps: torch.Tensor) -> torch.Tensor:
    """One candidate of each row's masked window, `jax.random.categorical`
    with the key fold_in(PRNGKey(seed), step) (Gumbel-max): [B] int32."""
    key = fold_in(prng_key(seeds), steps)
    pick = torch.argmax(gumbel(key, masked.shape[-1]) + masked, dim=-1)
    return torch.gather(ids, 1, pick[:, None])[:, 0].to(torch.int32)


def candidate_window(logits: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor):
    """(ids [B, CAP], masked scaled logits [B, CAP]): the candidates a
    sampled row draws from, with NEG_INF on every candidate that top-k or
    top-p removes."""
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    vals, ids = top_window(scaled)
    lse = torch.logsumexp(scaled, dim=-1)
    return ids, mask_window(vals, lse, top_k, top_p)


def sample_tokens(
    logits: torch.Tensor,        # [B, vocab] fp32
    seeds: torch.Tensor,         # [B] int32 per-request seed
    steps: torch.Tensor,         # [B] int32 decode step counter (rng stream)
    temperature: torch.Tensor,   # [B] fp32; <= 0 means greedy
    top_k: torch.Tensor,         # [B] int; 0 disables
    top_p: torch.Tensor,         # [B] fp32; >= 1 disables
) -> torch.Tensor:
    """Sampled token ids [B] int32: each sampled row draws one candidate
    of its masked window with the key fold_in(PRNGKey(seed), step); greedy
    rows take the full-vocab argmax.  Every row is computed on the device
    and no value is read back."""
    greedy = greedy_tokens(logits)
    ids, masked = candidate_window(logits, temperature, top_k, top_p)
    sampled = draw(ids, masked, seeds, steps)
    return torch.where(temperature <= 0.0, greedy, sampled)


# ---------------------------------------------------------------------------
# speculative decoding: host-side rejection sampling (spec/)
#
# The verify program (engine/graphs.py VerifyPrograms, the JAX engine's
# _spec_verify_impl) returns, per packed position, the top-CAP candidate
# ids + temperature-scaled logits and the full-vocab logsumexp of the scaled logits.  From those three arrays the
# host reconstructs EXACTLY the masked-window categorical `sample_tokens`
# draws from (same CAP window, same top-k clamp, same true-softmax top-p
# nucleus), so acceptance decisions are made against the real target
# distribution, not an approximation of it.
#
# Proposals are point masses (greedy n-gram / greedy draft model), so the
# Leviathan rejection rule specializes to: accept draft d with probability
# p(d); on rejection, sample from p with d's mass removed, renormalized.
# The emitted marginal is p(d)*1[x=d] + (1-p(d)) * p(x)*1[x!=d]/(1-p(d))
# = p(x) — the target distribution exactly, per position.  Greedy
# (temperature <= 0) degenerates to exact argmax-prefix matching, so the
# speculative stream is token-identical to plain greedy decode.
# ---------------------------------------------------------------------------


def spec_window_weights(vals: np.ndarray, lse: float, top_k: int,
                        top_p: float) -> np.ndarray:
    """Normalized target weights over the CAP candidate window — the same
    masking sample_tokens applies on device.  vals: [CAP] scaled logits
    sorted descending; lse: logsumexp of the full scaled logits."""
    probs = np.exp(vals.astype(np.float64) - float(lse))
    k_eff = int(np.clip(top_k if top_k > 0 else CAP, 1, CAP))
    keep = np.arange(CAP) < k_eff
    cum = np.cumsum(probs)
    keep &= np.concatenate(([True], cum[:-1] < top_p))
    w = np.where(keep, probs, 0.0)
    s = w.sum()
    if s <= 0.0:  # fp underflow corner: the argmax candidate stands alone
        w = np.zeros(CAP)
        w[0] = 1.0
        return w
    return w / s


def spec_accept_tokens(
    ids: np.ndarray,      # [n, CAP] candidate ids per position, sorted
    vals: np.ndarray,     # [n, CAP] scaled logits per position
    lse: np.ndarray,      # [n] full-vocab logsumexp of scaled logits
    drafts: List[int],    # k point-mass proposals (n == k + 1)
    *,
    greedy: bool,
    top_k: int,
    top_p: float,
    rng: np.random.Generator,
) -> Tuple[int, List[int]]:
    """Verify k drafted tokens against the target's per-position window
    distributions.  Returns (accepted_count, emitted_tokens): the
    accepted draft prefix plus exactly ONE more token — the corrected
    sample at the first rejection, or the bonus token from the position
    after the last draft when everything was accepted."""
    emitted: List[int] = []
    for i, d in enumerate(drafts):
        if greedy:
            t = int(ids[i, 0])
            if t == d:
                emitted.append(d)
                continue
            emitted.append(t)
            return i, emitted
        w = spec_window_weights(vals[i], lse[i], top_k, top_p)
        j = np.nonzero(ids[i] == d)[0]
        p_d = float(w[j[0]]) if len(j) else 0.0
        if rng.random() < p_d:
            emitted.append(d)
            continue
        if len(j):
            w[j[0]] = 0.0
        s = w.sum()
        if s <= 0.0:
            # the target was itself a point mass at d and the float
            # comparison still rejected: d IS the sample
            emitted.append(d)
            continue
        emitted.append(int(ids[i, rng.choice(CAP, p=w / s)]))
        return i, emitted
    # every draft accepted: bonus token from the last scored position
    i = len(drafts)
    if greedy:
        emitted.append(int(ids[i, 0]))
    else:
        w = spec_window_weights(vals[i], lse[i], top_k, top_p)
        emitted.append(int(ids[i, rng.choice(CAP, p=w)]))
    return len(drafts), emitted


def apply_penalties(
    logits: torch.Tensor,             # [B, vocab]
    token_counts: torch.Tensor,       # [B, vocab] int: counts in the output
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,   # [B]
) -> torch.Tensor:
    """OpenAI frequency and presence penalties, as the JAX sampler's
    `apply_penalties`.  Like the JAX engine, the engine does not call it:
    both accept the request fields and ignore them."""
    counts = token_counts.to(torch.float32)
    lf = logits - frequency_penalty[:, None] * counts
    return lf - presence_penalty[:, None] * (counts > 0).to(torch.float32)

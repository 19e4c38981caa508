"""Token sampling: greedy / temperature / top-k / top-p.

The counterpart of dynamo_tpu/engine/sampler.py, with the same semantics:
sampling is restricted to the CAP (64) highest logits per row, the
requested top_k is clamped to CAP, and the top-p nucleus mass is measured
against the TRUE full-vocab softmax (logsumexp), with the first candidate
always kept.  temperature <= 0 is greedy over the full vocabulary.

The draws differ: JAX folds the step into a threefry key, while the port
draws from a per-request `torch.Generator` seeded from the request's seed
(engine/core.py), so seeded sampled streams match the JAX engine in
distribution only; greedy streams match token for token.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e30

#: sampling candidate window (max effective top-k)
CAP = 64


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary: [B, vocab] -> [B] int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def candidate_window(logits: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor):
    """(ids [B, CAP], masked scaled logits [B, CAP]): the candidates a
    sampled row draws from, with NEG_INF on every candidate that top-k or
    top-p removes."""
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    cap = min(CAP, logits.shape[-1])
    vals, ids = torch.topk(scaled, cap, dim=-1)  # sorted descending
    k_eff = torch.clamp(torch.where(top_k > 0, top_k,
                                    torch.full_like(top_k, CAP)), 1, CAP)
    keep_k = torch.arange(cap, device=logits.device)[None, :] \
        < k_eff[:, None]
    probs = torch.exp(vals - torch.logsumexp(scaled, dim=-1, keepdim=True))
    cum = torch.cumsum(probs, dim=-1)
    first = torch.ones_like(cum[:, :1], dtype=torch.bool)
    keep_p = torch.cat([first, cum[:, :-1] < top_p[:, None]], dim=-1)
    masked = torch.where(keep_k & keep_p, vals,
                         torch.full_like(vals, NEG_INF))
    return ids, masked


def sample_tokens(
    logits: torch.Tensor,        # [B, vocab] fp32
    temperature: torch.Tensor,   # [B] fp32; <= 0 means greedy
    top_k: torch.Tensor,         # [B] int; 0 disables
    top_p: torch.Tensor,         # [B] fp32; >= 1 disables
    generators: Sequence[Optional[torch.Generator]],  # per row
) -> torch.Tensor:
    """Sampled token ids [B] int32.  Each sampled row draws one candidate
    from its masked window with its own generator (on logits' device);
    greedy rows need none and draw nothing."""
    out = greedy_tokens(logits)
    temps = temperature.tolist()
    rows = [b for b, t in enumerate(temps) if t > 0.0]
    if not rows:
        return out
    ids, masked = candidate_window(logits, temperature, top_k, top_p)
    probs = torch.softmax(masked, dim=-1)
    for b in rows:
        j = torch.multinomial(probs[b], 1, generator=generators[b])
        out[b] = ids[b, j[0]].to(torch.int32)
    return out

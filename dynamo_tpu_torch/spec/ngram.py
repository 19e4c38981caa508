"""Zero-weight n-gram (prompt-lookup) proposer.

A copy of dynamo_tpu/spec/ngram.py (numpy only).

Drafts come from the sequence's OWN history: the longest n-gram suffix of
(prompt + generated output) is matched against every earlier position,
and the tokens that followed the most recent previous occurrence become
the proposal.  No weights, no device programs, no extra HBM — the
proposer runs on the scheduler thread in microseconds, which is why it
is the tier-1 test proposer and the default production choice for
repetitive workloads (extraction, code completion, templated JSON, and
any greedy stream that has entered a cycle).

The acceptance dynamics are self-regulating at the engine level: when
history matches predict the target model well the engine's per-sequence
acceptance EMA keeps the draft length up; on non-repetitive text matches
either don't exist (propose() returns [] and the step costs nothing) or
get rejected, and the EMA collapses the sequence back to plain decode.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class NgramProposer:
    """Prompt-lookup proposer (vLLM's ngram speculator, Saxena 2023).

    max_ngram/min_ngram bound the suffix lengths tried, longest first —
    a longer match is a stronger signal, so it wins over a more recent
    shorter one."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: Sequence[int], k: int, *, ctx: int = 0,
                draft_pos: int = 0, block_table=None) -> List[int]:
        """Up to k draft tokens continuing `tokens`, or [] when no
        suffix n-gram recurs in the history.  ctx/draft_pos/block_table
        are the draft-model proposer's bookkeeping; ignored here."""
        a = np.asarray(tokens, dtype=np.int64)
        L = len(a)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            # candidate starts i in [0, L-n-1]: every window a[i:i+n]
            # starts before the suffix's own start (the self-match at
            # i = L-n is out of range by construction, so overlapping
            # recurrences right up against the suffix — the onset of
            # token-level repetition — are legitimate candidates) and
            # leaves >= 1 token after it
            if L < n + 2:
                continue
            suffix = a[-n:]
            ok = np.ones(L - n, dtype=bool)
            for j in range(n):
                ok &= a[j:j + L - n] == suffix[j]
            hits = np.nonzero(ok)[0]
            if len(hits) == 0:
                continue
            # most recent occurrence still followed by k tokens; when
            # every recurrence sits closer to the end than that, fall
            # back to the earliest one (longest available continuation)
            full = hits[hits + n + k <= L]
            i = int(full[-1]) if len(full) else int(hits[0])
            drafts = a[i + n:i + n + k]
            if len(drafts):
                return [int(t) for t in drafts]
        return []

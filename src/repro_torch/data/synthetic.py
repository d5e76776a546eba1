"""Synthetic token streams, copied from ``repro/data/synthetic.py``.

Only ``zipf_text`` is here: the language-modelling stand-in that the
training slice reads.  It is a pure function of (seed, length), numpy
only, so the port and the reference draw the same tokens.
"""
from __future__ import annotations

import numpy as np


def zipf_text(seed: int, n_tokens: int, vocab: int, *, alpha: float = 1.2,
              copy_prob: float = 0.12, copy_span: int = 32) -> np.ndarray:
    """Zipfian unigram stream with stochastic span copying (induction heads)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    # paste copies of earlier spans to create learnable long-range structure
    n_copies = int(n_tokens * copy_prob / copy_span)
    for _ in range(n_copies):
        if n_tokens < 4 * copy_span:
            break
        src = rng.integers(0, n_tokens - 2 * copy_span)
        dst = rng.integers(src + copy_span, n_tokens - copy_span)
        toks[dst : dst + copy_span] = toks[src : src + copy_span]
    return toks

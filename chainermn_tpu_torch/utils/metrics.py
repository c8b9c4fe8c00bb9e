"""Evaluation metrics — a copy of ``chainermn_tpu/utils/metrics.py`` (the
port keeps its own, importing nothing of the JAX package).

The reference's seq2seq example reported BLEU on WMT validation data
(REF:examples/seq2seq/seq2seq.py); this module provides an in-repo corpus
BLEU (Papineni et al., 2002) so the framework stays self-contained — no
NLTK dependency.  Host-side Python: metrics run on decoded token lists,
not on the device.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, Sequence


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    references: Iterable[Sequence],
    hypotheses: Iterable[Sequence],
    max_n: int = 4,
    smooth: bool = True,
) -> float:
    """Corpus-level BLEU-``max_n`` with brevity penalty.

    ``references``/``hypotheses``: parallel iterables of token sequences
    (ints or strings — anything hashable).  One reference per hypothesis
    (the common NMT-validation setup).  ``smooth`` adds +1 smoothing to
    higher-order precisions (Lin & Och 2004), keeping short-corpus scores
    finite; exact corpus BLEU with ``smooth=False``.
    """
    refs = [list(r) for r in references]
    hyps = [list(h) for h in hypotheses]
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references vs {len(hyps)} hypotheses")
    if not refs:
        return 0.0

    match = [0] * max_n
    total = [0] * max_n
    ref_len = hyp_len = 0
    for ref, hyp in zip(refs, hyps):
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_n + 1):
            h = _ngrams(hyp, n)
            r = _ngrams(ref, n)
            match[n - 1] += sum((h & r).values())
            total[n - 1] += max(len(hyp) - n + 1, 0)

    log_prec = 0.0
    for n in range(max_n):
        m, t = match[n], total[n]
        if smooth and n > 0:
            m, t = m + 1, t + 1
        if m == 0 or t == 0:
            return 0.0
        log_prec += math.log(m / t)
    log_prec /= max_n

    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_prec)


def strip_special(tokens: Sequence[int], eos: int = 2, pad: int = 0):
    """Cut a decoded sequence at EOS and drop padding — the usual
    post-processing before BLEU."""
    out = []
    for t in tokens:
        if t == eos:
            break
        if t != pad:
            out.append(int(t))
    return out

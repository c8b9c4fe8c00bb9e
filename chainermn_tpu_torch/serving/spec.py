"""Draft proposal sources for speculative decoding — port of
``chainermn_tpu/serving/spec.py``.

Two drafters share one contract — a draft is a **pure deterministic
function of the request's own context**, so the proposal never depends
on batch composition, scheduling order, or preemption history, and the
accepted stream can't either:

* :func:`propose_draft` — n-gram prompt lookup (arXiv:2304.04487 /
  vLLM's ngram speculator): the most recent earlier occurrence of the
  context's trailing n-gram predicts the next few tokens;
* :class:`DraftModel` — a layer-truncated self-draft: a plain
  :class:`~chainermn_tpu_torch.models.transformer.TransformerLM` whose
  parameters are a strict subset of the target's (the embedding, the
  first ``k`` layers, the final norm, and the tied head), run greedily.

Acceptance is exact-match: the scheduler samples token ``i`` from the
verify logits exactly as sequential decode would have, accepts while the
draft agrees, and always emits the first disagreeing *sampled* token —
so a bad draft costs wasted chunk compute, never correctness.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def propose_draft(context: Sequence[int], n_draft: int, *,
                  max_ngram: int = 3, min_ngram: int = 1) -> List[int]:
    """Up to ``n_draft`` draft tokens continuing ``context``.

    Tries the trailing n-gram from ``max_ngram`` down to ``min_ngram``;
    the first n for which the n-gram recurs earlier in the context wins,
    and the tokens following its MOST RECENT earlier occurrence are the
    draft (clipped at the context end, so the draft may be shorter than
    ``n_draft``).  Returns ``[]`` when nothing recurs — the scheduler
    falls back to a plain decode step for that request.
    """
    if n_draft <= 0:
        return []
    ctx = [int(t) for t in context]
    L = len(ctx)
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        if n <= 0:
            break
        tail = ctx[L - n:]
        for s in range(L - n - 1, -1, -1):
            if ctx[s:s + n] == tail:
                follow = ctx[s + n:s + n + n_draft]
                if follow:
                    return follow
                break  # the match sits flush at the end; shorter n won't
    return []


def longest_accepted(drafts: Sequence[int],
                     sampled: Sequence[int]) -> int:
    """How many leading draft tokens the (sequentially exact) sampled
    tokens confirm: acceptance stops at the first mismatch."""
    n = 0
    for d, s in zip(drafts, sampled):
        if int(d) != int(s):
            break
        n += 1
    return n


def draft_param_names(n_layers: int) -> List[str]:
    """The reference's top-level parameter keys a ``k``-layer truncated
    draft shares with its target: the embedding (also the tied head), the
    first ``k`` layers and the final norm.  In the port's ``state_dict``
    these are the ``embed.``, ``layers.{i}.`` and ``final_norm.`` keys."""
    return (["embed"]
            + [f"layer_{i}" for i in range(int(n_layers))]
            + ["final_norm"])


class DraftModel:
    """Layer-truncated self-draft: the target model's first ``n_layers``
    layers as a standalone plain ``TransformerLM``, proposing greedy
    continuations of a request's context.

    The draft holds the target's own modules (its parameters ARE the
    target's tensors, not copies; the draft is built on the meta device
    and then given them).  The rollout is ``n_draft`` sequential
    full-context dense forwards, each padded up the engine's prefill bucket
    ladder; a draft forward touches no paged cache, so it can never perturb
    verify state.  Each token is a host ``np.argmax`` (first max on ties)
    of the fp32 logits row — a fixed function of ``context``."""

    def __init__(self, lm, n_layers: int, buckets):
        from ..models.transformer import TransformerLM

        if not 1 <= int(n_layers) <= int(lm.n_layers):
            raise ValueError(
                f"draft_layers ({n_layers}) must be in [1, {lm.n_layers}]")
        self.n_layers = int(n_layers)
        self.max_len = int(lm.max_len)
        self.buckets = sorted(int(b) for b in buckets)
        with torch.device("meta"):
            model = TransformerLM(
                vocab=lm.vocab, d_model=lm.d_model, n_heads=lm.n_heads,
                d_ff=lm.d_ff, n_layers=self.n_layers, max_len=lm.max_len,
                dtype=lm.dtype, n_kv_heads=lm.n_kv_heads, device="meta",
            )
        self.model = model
        self.rebind(lm)
        self._shapes = set()

    def rebind(self, lm) -> None:
        """Take ``lm``'s embedding, first ``n_layers`` layers and final norm
        again (after the caller re-placed its parameters, e.g. under a
        sharding plan), so the draft runs on the placed parameters and not
        on stale ones."""
        model = self.model
        model.embed = lm.embed
        model.layers = torch.nn.ModuleList(list(lm.layers)[:self.n_layers])
        model.final_norm = lm.final_norm
        model.pe = lm.pe
        self.mesh = getattr(lm.embed.weight, "device_mesh", None)

    def _forward(self, tokens):
        if self.mesh is None:
            return self.model(tokens)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return self.model(tokens).to_local()

    def _bucket(self, length: int) -> int:
        for b in self.buckets:
            if b >= length:
                return b
        return length

    @property
    def compiles(self) -> int:
        """Distinct (bucketed) shapes the draft step has run (the
        reference's compile count)."""
        return len(self._shapes)

    def propose(self, context: Sequence[int], n_draft: int) -> List[int]:
        """Up to ``n_draft`` greedy draft tokens continuing ``context``
        (clipped so the rollout never runs past ``max_len``)."""
        if n_draft <= 0:
            return []
        ctx = [int(t) for t in context]
        out: List[int] = []
        dev = self.model.device
        for _ in range(int(n_draft)):
            L = len(ctx)
            if L >= self.max_len:
                break
            S = self._bucket(L)
            self._shapes.add(S)
            padded = np.zeros((1, S), np.int64)
            padded[0, :L] = ctx
            with torch.no_grad():
                logits = self._forward(torch.from_numpy(padded).to(dev))
            row = logits[0, max(L - 1, 0)].float().cpu().numpy()
            tok = int(np.argmax(row))
            out.append(tok)
            ctx.append(tok)
        return out

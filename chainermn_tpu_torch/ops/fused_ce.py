"""Chunked softmax cross-entropy against a tied embedding — the LM loss head.

Port of ``chainermn_tpu/ops/fused_ce.py``.  The ``(N, V)`` logit matrix
never exists: rows are processed in chunks, each chunk's logits (bf16
operands, fp32 accumulation) are reduced at once to the loss and one fp32
log-sum-exp per token, and the backward recomputes each chunk's logits
from that saved LSE and accumulates the embedding gradient chunk by
chunk.  Peak extra memory is ``chunk x V`` fp32.

Both operands of every chunk product are cast to bf16, as the reference
does, whatever the model's dtype.  The products are plain matrix products
(``torch.mm``): the reference leaves them to XLA too.  On a CUDA tensor
the product runs in cuBLAS with a float32 output; on a CPU tensor the
bf16-rounded operands are multiplied in float32, which is the same fp32
accumulation of exact bf16 products.
"""

from __future__ import annotations

import torch

#: Rows per chunk when the caller gives none.
DEFAULT_CHUNK = 512


def _pick_chunk(n: int, chunk: int) -> int:
    """Largest divisor of ``n`` that is <= chunk."""
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    return chunk


def _mm_f32(a, b):
    """``a @ b`` of two bf16 matrices with fp32 accumulation and output."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(h_c, emb16):
    """(C, D) x (V, D) bf16 -> (C, V) fp32 logits."""
    return _mm_f32(h_c.to(torch.bfloat16), emb16.t())


class LocalVocabStrategy:
    """How the chunked scan merges its row statistics over the vocabulary:
    for a FULL vocabulary on one device every merge is the identity and
    every valid label is owned here.  The vocab-parallel cross-entropy
    (``parallel.sharding.vocab_parallel_cross_entropy``) swaps in a
    strategy whose merges are collectives over the shards and whose
    labels are resolved by ownership: one scan for both."""

    def merge_max(self, m):
        return m

    def merge_sum(self, s):
        return s

    def merge_pick(self, p):
        return p

    def reduce_dh(self, dh):
        return dh

    def label_local(self, labels):
        """(local row index, ownership mask): every valid label is owned
        here, an invalid (< 0) label nowhere."""
        return labels.clamp_min(0), labels >= 0


def ce_scan_fwd(hidden, embedding, labels, chunk, strat):
    """Chunked CE forward over (N, D) ``hidden`` and this device's (V, D)
    ``embedding`` rows: the sum over valid tokens of ``lse - picked``, the
    valid count and the per-token lse (fp32), never holding more than one
    ``(chunk, V)`` logit tile.  ``strat`` merges the row statistics across
    vocabulary shards (:class:`LocalVocabStrategy`: no shards)."""
    N = hidden.shape[0]
    C = _pick_chunk(N, chunk)
    emb16 = embedding.to(torch.bfloat16)
    dev = hidden.device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_valid = torch.zeros((), dtype=torch.float32, device=dev)
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    for i in range(0, N, C):
        logits = _chunk_logits(hidden[i:i + C], emb16)
        l_c = labels[i:i + C]
        m = strat.merge_max(logits.amax(dim=-1))
        se = strat.merge_sum(torch.exp(logits - m[:, None]).sum(dim=-1))
        lse_c = m + torch.log(se)
        valid = l_c >= 0
        idx, owner = strat.label_local(l_c)
        picked = logits.gather(1, idx[:, None].long())[:, 0]
        picked = strat.merge_pick(
            torch.where(owner, picked, torch.zeros_like(picked)))
        tok = torch.where(valid, lse_c - picked, torch.zeros_like(lse_c))
        loss_sum = loss_sum + tok.sum()
        n_valid = n_valid + valid.sum().float()
        lse[i:i + C] = lse_c
    return loss_sum, n_valid, lse


def ce_scan_bwd(hidden, embedding, labels, lse, g_loss, g_lse, chunk,
                strat):
    """Chunked CE backward: each chunk's logits recomputed from the saved
    lse, ``dlogits = g_loss (p - onehot) + g_lse p`` on valid rows (the
    one-hot only where this device owns the label), ``dh`` reduced over
    the shards by ``strat`` and ``d embedding`` accumulated in fp32.
    Returns ``(dh, d_emb)`` in the inputs' dtypes."""
    C = _pick_chunk(hidden.shape[0], chunk)
    N = hidden.shape[0]
    emb16 = embedding.to(torch.bfloat16)
    dh = torch.empty_like(hidden)
    d_emb = torch.zeros(embedding.shape, dtype=torch.float32,
                        device=embedding.device)
    rows = torch.arange(C, device=hidden.device)
    for i in range(0, N, C):
        h16 = hidden[i:i + C].to(torch.bfloat16)
        logits = _mm_f32(h16, emb16.t())                 # recompute
        p = torch.exp(logits - lse[i:i + C, None])
        l_c = labels[i:i + C]
        valid = (l_c >= 0)[:, None]
        idx, owner = strat.label_local(l_c)
        # d loss_sum / d logits = p - onehot on valid rows;
        # d lse / d logits = p.
        dlogits = g_loss * p
        dlogits[rows, idx.long()] -= g_loss * owner.to(p.dtype)
        dlogits = torch.where(valid, dlogits, torch.zeros_like(dlogits))
        dlogits = dlogits + g_lse[i:i + C, None] * p
        d16 = dlogits.to(torch.bfloat16)
        dh[i:i + C] = strat.reduce_dh(_mm_f32(d16, emb16)).to(hidden.dtype)
        d_emb += _mm_f32(d16.t(), h16)
    return dh, d_emb.to(embedding.dtype)


class _FusedCESum(torch.autograd.Function):
    """Sum over valid tokens of ``lse_i - logits_i[label_i]``, the valid
    count, and the per-token lse; labels < 0 are ignored (0 loss, 0 grad).
    hidden (N, D), embedding (V, D), labels (N,) int."""

    @staticmethod
    def forward(ctx, hidden, embedding, labels, chunk):
        loss_sum, n_valid, lse = ce_scan_fwd(hidden, embedding, labels,
                                             chunk, LocalVocabStrategy())
        ctx.save_for_backward(hidden, embedding, labels, lse)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(n_valid)
        return loss_sum, n_valid, lse

    @staticmethod
    def backward(ctx, g_loss, _g_nvalid, g_lse):
        hidden, embedding, labels, lse = ctx.saved_tensors
        dh, d_emb = ce_scan_bwd(hidden, embedding, labels, lse, g_loss,
                                g_lse, ctx.chunk, LocalVocabStrategy())
        return dh, d_emb, None, None


def _validate_and_flatten(hidden, embedding, labels, chunk):
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    D = hidden.shape[-1]
    h2 = hidden.reshape(-1, D)
    l2 = labels.reshape(-1)
    if h2.shape[0] != l2.shape[0]:
        raise ValueError(
            f"hidden rows {h2.shape[0]} != labels {l2.shape[0]}"
        )
    if embedding.shape[-1] != D:
        raise ValueError(
            f"embedding dim {embedding.shape[-1]} != hidden dim {D}"
        )
    return h2, l2, DEFAULT_CHUNK if chunk is None else int(chunk)


def fused_cross_entropy(hidden, embedding, labels, *, chunk=None):
    """Mean softmax cross-entropy of ``hidden @ embedding.T`` against
    ``labels`` without materializing the ``(N, V)`` logits.

    ``hidden`` (..., D), ``embedding`` (V, D) (the tied ``embed`` weight),
    ``labels`` (...) int; negative labels are ignored.  Returns the scalar
    mean over valid tokens (0.0 when none is valid).  ``chunk``: rows per
    chunk (default :data:`DEFAULT_CHUNK`; the largest divisor of N not
    above it is used)."""
    h2, l2, chunk = _validate_and_flatten(hidden, embedding, labels, chunk)
    loss_sum, n_valid, _ = _FusedCESum.apply(h2, embedding, l2, chunk)
    return loss_sum / n_valid.clamp_min(1.0)


def fused_cross_entropy_with_lse(hidden, embedding, labels, *, chunk=None):
    """:func:`fused_cross_entropy` also returning the per-token
    log-sum-exp ``(N,)`` (differentiable: the z-loss pattern)."""
    h2, l2, chunk = _validate_and_flatten(hidden, embedding, labels, chunk)
    loss_sum, n_valid, lse = _FusedCESum.apply(h2, embedding, l2, chunk)
    return loss_sum / n_valid.clamp_min(1.0), lse


def naive_cross_entropy(hidden, embedding, labels):
    """Materialized-logits oracle (tests only): the same math over full
    ``(N, V)`` fp32 logits."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    logits = _chunk_logits(h2, embedding.to(torch.bfloat16))
    l2 = labels.reshape(-1)
    valid = l2 >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, l2.clamp_min(0)[:, None].long())[:, 0]
    tok = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return tok.sum() / valid.sum().float().clamp_min(1.0)

"""Vocab-parallel (Megatron-style) embedding and cross-entropy — the
vocab-parallel half of ``chainermn_tpu/parallel/sharding.py``.

Each rank of a communicator (the reference's ``axis_name``) holds a
contiguous slice of the vocabulary: rank ``i`` owns ids ``[i V/n,
(i+1) V/n)`` of the embedding table, which is also the tied LM head.
Each function is a ``torch.autograd.Function`` with its collectives
written out in both directions, as the reference's ``custom_vjp``s are:

* :func:`vocab_parallel_embed`: each rank looks up the ids it owns
  (zeros elsewhere) and one sum-allreduce assembles the activations.
  Backward: the ownership-masked scatter of the cotangent into the local
  rows; with ``grad_reduce=True`` (the sequence-parallel contract, where
  each rank consumes a different slice of the output) the cotangent is
  summed over the ranks first.
* :func:`gather_seq_for_replicated_head`: all-gather of a sequence shard
  whose backward SLICES the (replicated) cotangent instead of summing it.
* :func:`vocab_parallel_cross_entropy`: the chunked scan of
  :mod:`chainermn_tpu_torch.ops.fused_ce` with a strategy that merges the
  row max (max-allreduce), sum-exp and picked logit (two sum-allreduces)
  per chunk, and sums ``dh`` over the ranks in the backward.

Every rank of the communicator calls each function, and each takes the
result into its backward.  The reference's ``transformer_param_spec``
and ``make_gspmd_train_step`` (XLA's sharding annotations) are not
here.
"""

from __future__ import annotations

import torch

from ..ops.fused_ce import _validate_and_flatten, ce_scan_bwd, ce_scan_fwd


class _VocabParallelEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, embedding_shard, comm, grad_reduce):
        v_loc = embedding_shard.shape[0]
        local = tokens.long() - comm.rank * v_loc
        in_range = (local >= 0) & (local < v_loc)
        idx = local.clamp(0, v_loc - 1)
        emb = embedding_shard[idx]
        emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
        ctx.save_for_backward(idx, in_range)
        ctx.comm, ctx.grad_reduce = comm, grad_reduce
        ctx.shape = embedding_shard.shape
        return comm.allreduce(emb, "sum")

    @staticmethod
    def backward(ctx, g):
        idx, in_range = ctx.saved_tensors
        if ctx.grad_reduce:
            # Each rank's cotangent covers its own slice of the output:
            # reassemble the full cotangent BEFORE the ownership mask.
            g = ctx.comm.allreduce(g, "sum")
        g = torch.where(in_range[..., None], g, torch.zeros_like(g))
        d_emb = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        d_emb.index_add_(0, idx.reshape(-1), g.reshape(-1, ctx.shape[-1]))
        return None, d_emb, None, None


def vocab_parallel_embed(tokens, embedding_shard, comm, grad_reduce=False):
    """Look ``tokens`` up in a VOCAB-SHARDED table: ``embedding_shard``
    (V/n, D) is this rank's contiguous rows.  Returns the replicated
    (..., D) embeddings.

    ``grad_reduce``: False is the pure tensor-parallel contract (the
    cotangent of the output is the same on every rank, so the local
    scatter is the complete gradient of this shard); True is the
    sequence-parallel one (each rank consumes its own slice of the
    output, so the cotangents are summed over the ranks before the
    scatter)."""
    return _VocabParallelEmbed.apply(tokens, embedding_shard, comm,
                                     bool(grad_reduce))


class _GatherForHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis, ctx.s_local = comm, axis, x.shape[axis]
        return comm.allgather(x, axis=axis, tiled=True)

    @staticmethod
    def backward(ctx, g):
        s, r = ctx.s_local, ctx.comm.rank
        return g.narrow(ctx.axis, r * s, s).contiguous(), None, None


def gather_seq_for_replicated_head(x, comm, axis: int = 1):
    """All-gather a sequence-sharded activation for a head whose gradient
    is REPLICATED over the ranks (the vocab-parallel cross-entropy):
    every rank seeds the same cotangent on the gathered tensor, so the
    backward slices it back to this rank's shard (a plain all-gather's
    reduce-scatter would count it ``n`` times)."""
    return _GatherForHead.apply(x, comm, axis)


class _VocabShardStrategy:
    """:class:`~chainermn_tpu_torch.ops.fused_ce.LocalVocabStrategy`'s
    cross-shard sibling: the row max, sum-exp and picked logit merged over
    the ranks, labels resolved by contiguous-shard ownership, and ``dh``
    summed over the ranks."""

    def __init__(self, comm, v_loc: int):
        self.comm, self.v_loc = comm, v_loc
        self.offset = comm.rank * v_loc

    def merge_max(self, m):
        return self.comm.allreduce(m, "max")

    def merge_sum(self, s):
        return self.comm.allreduce(s, "sum")

    def merge_pick(self, p):
        return self.comm.allreduce(p, "sum")

    def reduce_dh(self, dh):
        return self.comm.allreduce(dh, "sum")

    def label_local(self, labels):
        local = labels - self.offset
        owner = (local >= 0) & (local < self.v_loc)
        return local.clamp(0, self.v_loc - 1), owner


class _VocabParallelCESum(torch.autograd.Function):
    """Replicated (loss_sum, n_valid) over vocab-sharded logits."""

    @staticmethod
    def forward(ctx, hidden, embedding_shard, labels, comm, chunk):
        strat = _VocabShardStrategy(comm, embedding_shard.shape[0])
        loss_sum, n_valid, lse = ce_scan_fwd(hidden, embedding_shard, labels,
                                             chunk, strat)
        ctx.save_for_backward(hidden, embedding_shard, labels, lse)
        ctx.comm, ctx.chunk = comm, chunk
        ctx.mark_non_differentiable(n_valid)
        return loss_sum, n_valid

    @staticmethod
    def backward(ctx, g_loss, _g_nvalid):
        hidden, embedding_shard, labels, lse = ctx.saved_tensors
        strat = _VocabShardStrategy(ctx.comm, embedding_shard.shape[0])
        dh, d_emb = ce_scan_bwd(hidden, embedding_shard, labels, lse, g_loss,
                                torch.zeros_like(lse), ctx.chunk, strat)
        return dh, d_emb, None, None, None


def vocab_parallel_cross_entropy(hidden, embedding_shard, labels, comm, *,
                                 chunk: int = 512):
    """Mean softmax cross-entropy of ``hidden`` against a VOCAB-SHARDED
    tied embedding (this rank's (V/n, D) rows) — the tensor-parallel LM
    head.  The semantics of
    :func:`~chainermn_tpu_torch.ops.fused_ce.fused_cross_entropy`
    (negative labels ignored; bf16 products, fp32 reductions; never more
    than one (chunk, V/n) logit tile), with the softmax statistics merged
    across the ranks: one max-allreduce and two sum-allreduces a chunk,
    one sum-allreduce of ``dh`` a chunk in the backward.  ``hidden`` and
    ``labels`` are the same on every rank; returns the replicated mean,
    and gradients ``d hidden`` replicated and ``d embedding_shard``
    local."""
    h2, l2, chunk = _validate_and_flatten(hidden, embedding_shard, labels,
                                          chunk)
    loss_sum, n_valid = _VocabParallelCESum.apply(h2, embedding_shard, l2,
                                                  comm, int(chunk))
    return loss_sum / n_valid.clamp_min(1.0)

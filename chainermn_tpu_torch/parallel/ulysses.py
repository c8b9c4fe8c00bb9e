"""Ulysses-style sequence parallelism — all-to-all head <-> sequence
reshard.  Port of ``chainermn_tpu/parallel/ulysses.py``.

Attention is parallel over heads but all-to-all over the sequence, so
when activations arrive sequence-sharded over the ranks of a
communicator (the reference's ``axis_name``), two all-to-alls reshard
them to head-sharded (the full sequence on each rank, ``H / n`` heads),
the port's :func:`~chainermn_tpu_torch.ops.flash_attention.flash_attention`
runs locally (the hand-written kernels on a CUDA tensor), and a third
all-to-all reshards back.  The all-to-alls are
:func:`chainermn_tpu_torch.functions.alltoall`, differentiable, whose
chunk order is ``lax.all_to_all(..., tiled=True)``'s: chunk ``j`` along
the split axis goes to rank ``j``, and the received chunks are
concatenated along the concat axis in source-rank order.

Compared with ring attention: one all-to-all each way instead of ``n``
rotations, but it needs ``H % n == 0`` and holds the full sequence on
each rank during attention.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..functions import alltoall
from ..ops.flash_attention import flash_attention


def ulysses_attention(q, k, v, comm, causal: bool = True,
                      scale: Optional[float] = None,
                      q_segment_ids=None, kv_segment_ids=None,
                      window: Optional[int] = None):
    """Sequence-parallel attention through the head <-> sequence
    all-to-all.

    q: (B, S_local, H, D), k/v: (B, S_local, Hk, D) sequence shards;
    returns (B, S_local, H, D).  ``H`` must divide by the rank count, and
    under GQA ``Hk`` must divide ``H`` and divide by the rank count too.
    ``q_segment_ids``/``kv_segment_ids``: (B, S_local) LOCAL shards of
    packed-sequence ids, all-gathered beside the reshard, or full
    (B, S_local * n) ids, used as they are.  ``window``: a sliding window
    over the full sequence, exact, since each rank holds all of it."""
    n = comm.size
    B, S_loc, H, D = q.shape
    Hk = k.shape[2]
    if H % n:
        raise ValueError(f"head count {H} not divisible by axis size {n}")
    if Hk != H and (H % Hk or Hk % n):
        raise ValueError(
            f"kv head count {Hk} must divide query heads {H} and be "
            f"divisible by axis size {n}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if kv_segment_ids is not None and q_segment_ids is None:
        raise ValueError(
            "kv_segment_ids without q_segment_ids would be silently "
            "ignored; pass q_segment_ids (optionally alone — kv defaults "
            "to it)")
    if kv_segment_ids is None:
        kv_segment_ids = q_segment_ids

    # (B, S_loc, H, D) -> (B, S_full, H/n, D): split heads, concat sequence.
    def to_heads(x):
        return alltoall(comm, x, split_axis=2, concat_axis=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    qs = ks = None
    if q_segment_ids is not None:
        def full_ids(ids):
            ids = torch.as_tensor(ids, device=q.device).to(torch.int32)
            if ids.shape[1] == S_loc * n:
                return ids
            if ids.shape[1] != S_loc:
                raise ValueError(
                    f"segment ids sequence length {ids.shape[1]} is "
                    f"neither local ({S_loc}) nor full ({S_loc * n})")
            return comm.allgather(ids, axis=1, tiled=True)

        qs, ks = full_ids(q_segment_ids), full_ids(kv_segment_ids)
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale,
                          q_segment_ids=qs, kv_segment_ids=ks, window=window)
    return alltoall(comm, out.to(q.dtype), split_axis=1, concat_axis=2)


def make_ulysses_attention_fn(comm, causal: bool = True, segment_ids=None,
                              window=None):
    """Adapter for the transformer layers' ``attention_fn`` slot.
    ``segment_ids``: optional row-uniform GLOBAL (S,) ids, broadcast to
    the batch at call time (attention runs over the full sequence here,
    so no slice and gather is needed)."""

    def fn(q, k, v, mask=None):
        del mask
        qs = None
        if segment_ids is not None:
            ids = torch.as_tensor(segment_ids)
            if ids.dim() != 1:
                raise ValueError(
                    "adapter segment_ids must be row-uniform GLOBAL (S,)")
            qs = ids.to(device=q.device, dtype=torch.int32)[None].expand(
                q.shape[0], ids.shape[0])
        return ulysses_attention(q, k, v, comm, causal=causal,
                                 q_segment_ids=qs, window=window)

    return fn

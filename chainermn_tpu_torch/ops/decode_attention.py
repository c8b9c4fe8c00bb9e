"""Paged single-query decode attention — the serving data plane.

Port of ``chainermn_tpu/ops/decode_attention.py``.  K/V live in fixed-size
*pages* ``(N, page_size, Hkv, D)`` indexed by a per-sequence block table
(vLLM's PagedAttention, arXiv:2309.06180), so sequences of different
lengths share one physical cache and grow in ``page_size`` quanta:

* :func:`paged_attention_decode` — one query per sequence over its pages;
* :func:`paged_attention_chunk` — T consecutive queries per sequence, each
  with its own causal bound (speculative verify, prefix-cache suffix
  prefill); the decode step is its T = 1 case;
* :func:`write_prompt_pages`, :func:`write_chunk_pages`,
  :func:`write_token_pages` — the scatter writes of prefill, chunk and
  decode K/V into the pages.

These are plain torch ops, as the reference's are jnp; no hand kernel.

Invalid-slot convention: a block-table entry that names no page holds
``n_pages`` (:func:`invalid_block`), one past the last page.  JAX drops an
out-of-range scatter and zero-fills an out-of-range gather; torch raises
on both, so here the semantics are explicit:

* a write whose page is ``n_pages``, or whose position is negative or
  beyond the table's reach, writes nothing: only the valid (page, slot)
  pairs reach ``index_put_``;
* a gather of page ``n_pages`` yields zeros, payload and scale both.

Pages update **in place** (the counterpart of the reference engine's
donated cache buffers); every write function also returns its pages.

``block_tables`` and the length vectors may live on the host while the
pages live on the GPU: the routing of a write is computed where the
tables are and only the selected indices cross to the pages' device, so
a write never waits on the device.

All reductions are per sequence: nothing crosses the batch dimension,
which keeps a sequence's result independent of which other sequences
share its step (up to the GEMM library's choice of kernel per shape).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..communicators.quant import dequantize_kv


def _scale(d_head: int) -> float:
    """``1/sqrt(D)`` as the fp32 value the reference multiplies by: its
    numpy float64 scale promotes the logits to fp32 before the product."""
    return float(np.float32(1.0 / np.sqrt(d_head)))


def invalid_block(n_pages: int) -> int:
    """The sentinel block id of an unallocated table slot: one past the
    last page (never -1, which would name the last real page)."""
    return int(n_pages)


def _positions_to_pages(block_tables, positions, page_size: int,
                        n_pages: int):
    """Map token positions to ``(page_id, slot)`` through the block table.

    ``block_tables``: (B, W) int, invalid entries ``n_pages``;
    ``positions``: (B, P) int token positions; a position that is negative
    or beyond the table's reach resolves to the invalid page.  Returns
    ``(page_id, slot)``, both (B, P) int32, on the tables' device."""
    W = block_tables.shape[1]
    positions = positions.to(block_tables.device)
    valid = (positions >= 0) & (positions < W * page_size)
    safe = positions.clamp(0, W * page_size - 1).long()
    page = torch.gather(block_tables.long(), 1, safe // page_size)
    page = torch.where(valid, page, torch.full_like(page,
                                                    invalid_block(n_pages)))
    return page.int(), (safe % page_size).int()


def _to(t, device):
    """A host index tensor to ``device`` without a stream synchronise (a
    blocking copy from pageable memory waits for the device to drain)."""
    return t.to(device, non_blocking=True)


def _scatter(pages, new, page, slot):
    """``pages[page, slot] = new`` for the valid pairs only (in place)."""
    keep = (page >= 0) & (page < pages.shape[0])
    b, t = keep.nonzero(as_tuple=True)
    dev = pages.device
    pages.index_put_(
        (_to(page[b, t].long(), dev), _to(slot[b, t].long(), dev)),
        new[_to(b, new.device), _to(t, new.device)].to(pages.dtype),
    )
    return pages


def write_prompt_pages(k_pages, new_k, block_tables, seq_lens):
    """Scatter a whole prompt's K (or V) into the pages.

    ``k_pages``: (N, page_size, Hkv, D) (or (N, page_size, Hkv) scales);
    ``new_k``: (B, S, Hkv, D); ``seq_lens``: (B,) valid prompt lengths —
    positions ``t >= seq_lens[b]`` (padding up to the bucket) write
    nothing."""
    N, page_size = k_pages.shape[0], k_pages.shape[1]
    B, S = new_k.shape[0], new_k.shape[1]
    dev = block_tables.device
    lens = torch.as_tensor(seq_lens).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    pos = torch.where(pos < lens[:, None], pos, torch.full_like(pos, -1))
    page, slot = _positions_to_pages(block_tables, pos, page_size, N)
    return _scatter(k_pages, new_k, page, slot)


def write_chunk_pages(k_pages, new_k, block_tables, start_lens):
    """Scatter a T-token chunk's K (or V) per sequence into the pages.

    ``new_k``: (B, T, Hkv, D) — token ``t`` of row ``b`` lands at position
    ``start_lens[b] + t``.  Rows with ``start_lens[b] < 0`` (padding rows
    of a bucket) write nothing; positions beyond the table's reach write
    nothing, so a chunk may over-run a row's real suffix (drafts, bucket
    padding): such slots lie beyond the row's masked context and a later
    step rewrites them before any mask exposes them."""
    N, page_size = k_pages.shape[0], k_pages.shape[1]
    T = new_k.shape[1]
    dev = block_tables.device
    start = torch.as_tensor(start_lens).to(dev).int()
    pos = start[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None]
    pos = torch.where(start[:, None] >= 0, pos, torch.full_like(pos, -1))
    page, slot = _positions_to_pages(block_tables, pos, page_size, N)
    return _scatter(k_pages, new_k, page, slot)


def write_token_pages(k_pages, new_k, block_tables, seq_lens):
    """Scatter one decode token's K (or V) per sequence into the pages:
    ``new_k`` (B, 1, Hkv, D) lands at position ``seq_lens[b]`` (the
    context length before this token); rows with ``seq_lens[b] < 0`` write
    nothing.  A T = 1 chunk write, so it delegates."""
    return write_chunk_pages(k_pages, new_k, block_tables, seq_lens)


def paged_attention_decode(q, k_pages, v_pages, block_tables, seq_lens, *,
                           block_ctx: Optional[int] = None, k_scales=None,
                           v_scales=None):
    """Single-query attention over paged K/V.

    ``q``: (B, 1, H, D); ``k_pages``/``v_pages``: (N, page_size, Hkv, D)
    with Hkv dividing H; ``block_tables``: (B, W) int (invalid == N);
    ``seq_lens``: (B,) valid cache positions INCLUDING the just-written
    current token.  Returns (B, 1, H, D) in ``q.dtype``; see
    :func:`paged_attention_chunk` for the numerics, ``block_ctx`` and the
    int8 scales."""
    if q.shape[1] != 1:
        raise ValueError(
            f"paged_attention_decode consumes one query per sequence, got "
            f"a length-{q.shape[1]} chunk"
        )
    return paged_attention_chunk(
        q, k_pages, v_pages, block_tables, torch.as_tensor(seq_lens) - 1,
        block_ctx=block_ctx, k_scales=k_scales, v_scales=v_scales,
    )


def paged_attention_chunk(q, k_pages, v_pages, block_tables, start_lens, *,
                          block_ctx: Optional[int] = None, k_scales=None,
                          v_scales=None):
    """Multi-query causal attention over paged K/V (verify, suffix prefill).

    ``q``: (B, T, H, D) — T queries per sequence at positions
    ``start_lens[b] + t``; query ``t`` attends to cache positions
    ``< start_lens[b] + t + 1`` (its own freshly written slot included),
    the bound T sequential decode steps would each see.  Rows with
    ``start_lens[b] < 0`` are padding: all masked, output never read.

    Numerics as the reference's: the logits are an einsum in ``q.dtype``,
    promoted to fp32 and times ``1/sqrt(D)`` (the reference's numpy scalar
    promotes them); masked keys get ``finfo(float32).min`` (so an
    all-padding row stays finite); softmax in fp32, the weights cast back
    to ``q.dtype`` before the second einsum.

    ``block_ctx``: gather the context in chunks of this many pages to bound
    the transient (B, ctx, Hkv, D) buffer (``None``: one gather); the
    concatenated context is the same tensor, so the result is bitwise the
    one-shot result.

    ``k_scales``/``v_scales``: (N, page_size, Hkv) fp32 scales of int8
    pages, gathered through the same table (zeros for page N) and
    multiplied back in, in ``q.dtype``, before any einsum.

    Returns (B, T, H, D) in ``q.dtype``."""
    B, T, H, D = q.shape
    N, page_size, Hkv, _ = k_pages.shape
    if H % Hkv:
        raise ValueError(f"n_kv_heads ({Hkv}) must divide n_heads ({H})")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    dev = k_pages.device
    tables = _to(torch.as_tensor(block_tables).long(), dev)
    W = tables.shape[1]

    def gather(pages, t):
        valid = t < N
        g = pages[t.clamp(max=N - 1)]                  # (B, w, P, ...)
        g = torch.where(valid.view(*valid.shape, *([1] * (g.dim() - 2))),
                        g, 0)
        return g.reshape(B, t.shape[1] * page_size, *pages.shape[2:])

    def gather_deq(pages, scales, t):
        g = gather(pages, t)
        if scales is None:
            return g
        return dequantize_kv(g, gather(scales, t), q.dtype)

    if block_ctx is None or block_ctx >= W:
        k = gather_deq(k_pages, k_scales, tables)
        v = gather_deq(v_pages, v_scales, tables)
    else:
        ks, vs = [], []
        for s in range(0, W, block_ctx):
            t = tables[:, s:s + block_ctx]
            ks.append(gather_deq(k_pages, k_scales, t))
            vs.append(gather_deq(v_pages, v_scales, t))
        k = torch.cat(ks, dim=1)
        v = torch.cat(vs, dim=1)

    if Hkv != H:
        k = torch.repeat_interleave(k, H // Hkv, dim=2)
        v = torch.repeat_interleave(v, H // Hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(D)
    ctx = k.shape[1]
    start = _to(torch.as_tensor(start_lens).int(), dev)
    bounds = start[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=dev)[None] + 1
    mask = (torch.arange(ctx, device=dev)[None, None]
            < bounds[:, :, None])[:, None]
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)

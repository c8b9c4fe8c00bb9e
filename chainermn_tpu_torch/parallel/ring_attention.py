"""Ring attention — blockwise sequence-parallel attention, one process a
sequence shard.  Port of ``chainermn_tpu/parallel/ring_attention.py``.

The sequence dimension is sharded over the ranks of a communicator (the
reference's ``axis_name``; in a data x sequence layout,
``comm.split(("intra",))``).  Queries stay put; K/V blocks (only the
``Hk`` heads of GQA) rotate around the ring, one
``dist.batch_isend_irecv`` a step from rank ``r`` to ``r + 1``, while an
online softmax merges each block's partial result in fp32.  A one-rank
ring rotates nothing.

* :func:`ring_attention` computes each block with dense fp32 products,
  as the reference does, and masks it by GLOBAL positions (causal,
  sliding window) and by packed-sequence segment ids that rotate with
  their K/V.  A block that no query of this shard may attend is skipped:
  merging it would change nothing.
* :func:`zigzag_ring_attention` takes zigzag-sharded sequences (shard
  ``r`` holds chunks ``r`` and ``2n-1-r``) and computes per ring step
  only the two half-blocks that are causally live.  The reference
  selects the second one by data (``early_live = my >= j``); here the
  rank knows ``j`` and its own index, so it is a host branch and only
  the live half-block runs.  On a CUDA tensor each half-block runs the
  hand-written flash kernels through ``flash_attention_with_lse[_seg]``
  and merges through ``(lse, 1, o)``; on a CPU tensor it is the dense
  block by default and the kernels' plain twins with ``use_flash=True``.

Backward: each ring is one ``torch.autograd.Function``.  Its forward
keeps q, k, v, the fp32 output and the merged row log-sum-exp ``L``; its
backward rotates K/V around the ring again, recomputes each live block's
probabilities ``exp(s - L)`` against ``delta = rowsum(dO * O)``, and
carries each block's dK/dV accumulator (fp32) with it, one more hop
bringing it home.  Memory stays at one block, as the reference's
checkpointed scan keeps it.  The zigzag ring's backward feeds ``L`` and
``delta`` straight to ``flash_dq``/``flash_dkv`` (their plain twins on
the CPU) for every half-block.

Every rank of the communicator calls each function with the same shapes,
and every rank takes the result into its backward, since the backward
rotates too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..functions import allgather as _allgather
from ..ops import _kernels
from ..ops.flash_attention import (flash_attention_with_lse,
                                   flash_attention_with_lse_seg,
                                   flash_block_plan, from_bh, seg_to_bh,
                                   to_bh)
from .pipeline import _exchange, _ready

_INF = float("inf")
# Tags of the rotations (gloo matches on them; NCCL in posting order).
_TAG = (1 << 25) + 16


# ---------------------------------------------------------------------------
# Dense blocks in the kernel layout: q (BH, Sq, D), k/v (BHk, Sk, D); the
# batch-major head flattening puts q row i's kv row at i // G.  A mask is
# None or bool (R, Sq, Sk) with R = 1 or BHk (see _kv_rows).
# ---------------------------------------------------------------------------


def _kv_rows(mask_b, Hk: int):
    """A (B, Sq, Sk) mask -> one row per kv head row (B * Hk, Sq, Sk)."""
    return torch.repeat_interleave(mask_b, Hk, dim=0)


def _grouped(x, BHk: int):
    return x.reshape(BHk, x.shape[0] // BHk, *x.shape[1:])


def _dense_stats(q, k, v, mask, scale):
    """One q-block x kv-block attention with unnormalized accumulators in
    fp32: ``(m, l, pv)``, ``m``/``l`` (BH, Sq), ``pv`` (BH, Sq, D); a fully
    masked row has ``m = -inf``, ``l = 0``, ``pv = 0``."""
    BH, Sq, D = q.shape
    BHk = k.shape[0]
    s = torch.einsum("xgqd,xkd->xgqk", _grouped(q.float(), BHk),
                     k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None], -_INF)
    m = s.amax(-1)
    # exp(-inf - 0) = 0 keeps fully masked rows at zero.
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe[..., None])
    pv = torch.einsum("xgqk,xkd->xgqd", p, v.float())
    return m.reshape(BH, Sq), p.sum(-1).reshape(BH, Sq), pv.reshape(BH, Sq, D)


def _dense_grads(q, k, v, do, L, delta, mask, scale):
    """One block's share of the attention gradients from the merged row
    log-sum-exp ``L`` and ``delta = rowsum(dO * O)`` (both (BH, Sq) fp32):
    ``(dq, dk, dv)`` in fp32."""
    BH, Sq, D = q.shape
    BHk = k.shape[0]
    qg, dog = _grouped(q.float(), BHk), _grouped(do.float(), BHk)
    kf, vf = k.float(), v.float()
    s = torch.einsum("xgqd,xkd->xgqk", qg, kf) * scale
    p = torch.exp(s - _grouped(L, BHk)[..., None])
    if mask is not None:
        p = p.masked_fill(~mask[:, None], 0.0)
    dv = torch.einsum("xgqk,xgqd->xkd", p, dog)
    ds = p * (torch.einsum("xgqd,xkd->xgqk", dog, vf)
              - _grouped(delta, BHk)[..., None])
    dq = torch.einsum("xgqk,xkd->xgqd", ds, kf) * scale
    dk = torch.einsum("xgqk,xgqd->xkd", ds, qg) * scale
    return dq.reshape(BH, Sq, D), dk, dv


def _online_merge(stats, blk, gate=None):
    """Merge one block's ``(m, l, pv)`` into running online-softmax stats.

    NaN-safe at the -inf edges (fully masked rows, untouched
    accumulators).  ``gate`` (bool) drops the block when False.  Takes the
    reference's layout (``m``/``l`` (B, H, S), ``acc`` (B, S, H, D)) or
    the kernel layout (``m``/``l`` (BH, S), ``acc`` (BH, S, D))."""
    m_run, l_run, acc = stats
    m_blk, l_blk, pv_blk = blk
    if gate is not None and not gate:
        return stats
    m_new = torch.maximum(m_run, m_blk)
    zero = torch.zeros_like(m_new)
    m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
    alpha = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_safe), zero)
    beta = torch.where(torch.isfinite(m_blk), torch.exp(m_blk - m_safe), zero)
    l_new = l_run * alpha + l_blk * beta
    if acc.dim() == 4:
        alpha, beta = alpha.transpose(1, 2), beta.transpose(1, 2)
    return (m_new, l_new, acc * alpha[..., None] + pv_blk * beta[..., None])


def _finish(stats):
    """(fp32 output, merged row log-sum-exp ``L`` with 0 where a row
    attended nothing)."""
    m, l, acc = stats
    L = m + torch.log(l)
    return (acc / l.clamp_min(1e-30)[..., None],
            torch.where(torch.isfinite(L), L, torch.zeros_like(L)))


def _block_attn(q, k, v, mask, scale):
    """The reference's block attention in its layout: q (B, Sq, H, D),
    k/v (B, Sk, Hk, D), ``mask`` broadcastable to (B, 1, Sq, Sk) (a
    size-1 head axis).  Returns ``(m, l, pv)``: (B, H, Sq) twice and
    (B, Sq, H, D), fp32."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    if H % Hk:
        raise ValueError(f"kv heads ({Hk}) must divide query heads ({H})")
    bmask = None
    if mask is not None:
        bmask = torch.as_tensor(mask).expand(-1, 1, Sq, k.shape[1])[:, 0]
        bmask = bmask if bmask.shape[0] == 1 else _kv_rows(bmask, Hk)
    m, l, pv = _dense_stats(to_bh(q), to_bh(k), to_bh(v), bmask, scale)
    return m.reshape(B, H, Sq), l.reshape(B, H, Sq), from_bh(pv, B, H)


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------


def _rotate(comm, tensors):
    """Send each tensor to rank ``r + 1`` and receive its counterpart from
    ``r - 1``, all in one batched exchange; returns the received tensors.
    A one-rank ring returns them as they are."""
    n = comm.size
    if n == 1:
        return list(tensors)
    _ready(comm)
    me = comm.rank
    outs = [torch.empty_like(t) for t in tensors]
    _exchange(comm,
              [(t, (me + 1) % n, _TAG + i) for i, t in enumerate(tensors)],
              [(o, (me - 1) % n, _TAG + i) for i, o in enumerate(outs)])
    return outs


# ---------------------------------------------------------------------------
# Ring attention (dense blocks)
# ---------------------------------------------------------------------------


def _ring_mask(my, src, S, causal, window, q_seg, kv_seg, Hk, device):
    """The mask of shard ``my``'s queries against shard ``src``'s keys:
    None when every pair is live, False when none is, else bool (1 or
    B * Hk, S, S)."""
    mask = None
    if causal:
        off = (my - src) * S           # q_pos - k_pos = off + i - j
        lo, hi = off - (S - 1), off + (S - 1)
        if hi < 0 or (window is not None and lo >= window):
            return False
        if lo < 0 or (window is not None and hi >= window):
            d = (torch.arange(S, device=device)[:, None] + off
                 - torch.arange(S, device=device)[None, :])
            mask = d >= 0
            if window is not None:
                mask &= d < window
            mask = mask[None]
    if q_seg is not None:
        seg = q_seg[:, :, None] == kv_seg[:, None, :]
        mask = _kv_rows(seg if mask is None else (mask & seg), Hk)
    return mask


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, comm, Hk, causal, scale,
                window):
        n, my = comm.size, comm.rank
        S = q.shape[1]
        BH, D = q.shape[0], q.shape[2]
        dev = q.device
        stats = (torch.full((BH, S), -_INF, device=dev),
                 torch.zeros(BH, S, device=dev),
                 torch.zeros(BH, S, D, device=dev))
        kb, vb, sb = k, v, kv_seg
        for j in range(n):
            src = (my - j) % n
            mask = _ring_mask(my, src, S, causal, window, q_seg, sb, Hk, dev)
            if mask is not False:
                stats = _online_merge(
                    stats, _dense_stats(q, kb, vb, mask, scale))
            if j < n - 1:
                rot = _rotate(comm, [kb, vb] + ([sb] if sb is not None
                                               else []))
                kb, vb = rot[0], rot[1]
                sb = rot[2] if sb is not None else None
        # The backward's delta = rowsum(dO * O) takes the fp32 output.
        out, L = _finish(stats)
        ctx.save_for_backward(q, k, v, out, L, q_seg, kv_seg)
        ctx.args = (comm, Hk, causal, scale, window)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, L, q_seg, kv_seg = ctx.saved_tensors
        comm, Hk, causal, scale, window = ctx.args
        n, my = comm.size, comm.rank
        S = q.shape[1]
        delta = (do.float() * out).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        kb, vb, sb = k, v, kv_seg
        for j in range(n):
            src = (my - j) % n
            mask = _ring_mask(my, src, S, causal, window, q_seg, sb, Hk,
                              q.device)
            if mask is not False:
                g = _dense_grads(q, kb, vb, do, L, delta, mask, scale)
                dq += g[0]
                dk += g[1]
                dv += g[2]
            # The accumulators travel with their block and one more hop
            # after the last step brings each one home.
            last = j == n - 1
            rot = _rotate(comm, ([] if last else [kb, vb]) + [dk, dv] + (
                [sb] if sb is not None and not last else []))
            if not last:
                kb, vb, dk, dv = rot[:4]
                sb = rot[4] if sb is not None else None
            else:
                dk, dv = rot
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def _check_segments(q_segment_ids, kv_segment_ids):
    if kv_segment_ids is not None and q_segment_ids is None:
        raise ValueError(
            "kv_segment_ids without q_segment_ids would be silently "
            "ignored; pass q_segment_ids (optionally alone — kv defaults "
            "to it)"
        )
    return q_segment_ids if kv_segment_ids is None else kv_segment_ids


def ring_attention(q, k, v, comm, causal: bool = True,
                   scale: Optional[float] = None,
                   q_segment_ids=None, kv_segment_ids=None,
                   window: Optional[int] = None):
    """Sequence-parallel attention; every rank of ``comm`` holds one
    contiguous shard of the sequence, rank ``r`` positions ``[r S, (r+1)
    S)``.

    q: (B, S_local, H, D); k/v: (B, S_local, Hk, D) with ``Hk`` dividing
    ``H`` (GQA: only the reduced K/V rotate).  ``q_segment_ids`` /
    ``kv_segment_ids``: optional (B, S_local) LOCAL shards of packed
    segment ids (kv defaults to q's); the kv ids rotate with their K/V.
    ``window`` (causal only): query ``i`` attends keys ``(i - window,
    i]`` by global position, across shard boundaries.  Returns (B,
    S_local, H, D), equal up to fp32 accumulation order to full attention
    over the gathered sequence."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if H % Hk or v.shape[2] != Hk:
        raise ValueError(f"kv heads ({Hk}) must divide query heads ({H})")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    kv_segment_ids = _check_segments(q_segment_ids, kv_segment_ids)
    qs = ks = None
    if q_segment_ids is not None:
        qs = torch.as_tensor(q_segment_ids, device=q.device).to(torch.int32)
        ks = torch.as_tensor(kv_segment_ids, device=q.device).to(torch.int32)
    out = _Ring.apply(to_bh(q), to_bh(k), to_bh(v), qs, ks, comm, Hk,
                      bool(causal), float(scale), window)
    return from_bh(out, B, H)


# ---------------------------------------------------------------------------
# Zigzag layout
# ---------------------------------------------------------------------------


def zigzag_indices(seq_len: int, n_shards: int):
    """Permutation putting a global sequence into zigzag layout: the
    sequence cut into ``2n`` chunks, shard ``r`` holding chunks ``(r,
    2n-1-r)`` — one early, one late, so that causal work balances.  Apply
    to the sequence axis before sharding (``x[:, zigzag_indices(S, n)]``)
    and :func:`inverse_zigzag_indices` to outputs."""
    if seq_len % (2 * n_shards):
        raise ValueError(f"seq_len {seq_len} must divide by 2*{n_shards}")
    c = seq_len // (2 * n_shards)
    idx = []
    for r in range(n_shards):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * n_shards - 1 - r) * c, (2 * n_shards - r) * c))
    return np.asarray(idx)


def inverse_zigzag_indices(seq_len: int, n_shards: int):
    idx = zigzag_indices(seq_len, n_shards)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(seq_len)
    return inv


def _flash_block_stats(q, k, v, causal, scale, block, qseg=None, kseg=None):
    """Block stats from the flash kernels in :func:`_online_merge`'s
    ``(m, l, pv)`` convention: any ``(m', l', pv')`` with the same
    normalized output and the same ``m + log l`` is equivalent, so the
    kernel's ``(o, lse)`` maps to ``(lse, 1, o)``.  Differentiable (the
    LSE cotangent folds into the kernels' backward).  q (B, S, H, D),
    k/v (B, S, Hk, D); ``qseg``/``kseg``: optional (B, S) segment ids."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if qseg is None:
        o, lse = flash_attention_with_lse(to_bh(q), to_bh(k), to_bh(v),
                                          scale, causal, block, block)
    else:
        o, lse = flash_attention_with_lse_seg(
            to_bh(q), to_bh(k), to_bh(v), seg_to_bh(qseg, H),
            seg_to_bh(kseg, Hk), scale, causal, block, block)
    lse3 = lse[..., 0].reshape(B, H, S)
    return lse3, torch.ones_like(lse3), from_bh(o, B, H).float()


class _Zigzag(torch.autograd.Function):
    """The zigzag ring over the kernel layout.  ``q`` is (2, BH, C, D)
    (the early and the late chunk), ``kv`` (4, BHk, C, D) (k early, k
    late, v early, v late), ``seg`` (B, 2C) int32 or None."""

    @staticmethod
    def forward(ctx, q, kv, seg, comm, H, Hk, scale, flash, block):
        n, my = comm.size, comm.rank
        C, dev = q.shape[2], q.device

        stats = [(torch.full(q.shape[1:3], -_INF, device=dev),
                  torch.zeros(q.shape[1:3], device=dev),
                  torch.zeros(q.shape[1:], device=dev)) for _ in range(2)]
        kvb, segb = kv, seg
        for j in range(n):
            if j:
                rot = _rotate(comm, [kvb] + ([segb] if seg is not None
                                             else []))
                kvb = rot[0]
                segb = rot[1] if seg is not None else None
            for qi, ki, causal in _zigzag_blocks(j, my):
                qsg, ksg = _half_segs(seg, segb, qi, ki, C, H, Hk)
                if flash:
                    if qsg is None:
                        o, lse = flash_attention_with_lse(
                            q[qi], kvb[ki], kvb[2 + ki], scale, causal,
                            block, block)
                    else:
                        o, lse = flash_attention_with_lse_seg(
                            q[qi], kvb[ki], kvb[2 + ki], qsg, ksg, scale,
                            causal, block, block)
                    lse = lse[..., 0]
                    blk = (lse, torch.ones_like(lse), o.float())
                else:
                    blk = _dense_stats(q[qi], kvb[ki], kvb[2 + ki],
                                       _half_mask(causal, qsg, ksg, C, dev),
                                       scale)
                stats[qi] = _online_merge(stats[qi], blk)
        outs, Ls = zip(*(_finish(s) for s in stats))
        out, L = torch.stack(outs), torch.stack(Ls)
        ctx.save_for_backward(q, kv, seg, out, L)
        ctx.args = (comm, H, Hk, scale, flash)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, kv, seg, out, L = ctx.saved_tensors
        comm, H, Hk, scale, flash = ctx.args
        n, C, dev = comm.size, q.shape[2], q.device
        do = do.contiguous()
        delta = (do.float() * out).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        if flash:
            L3 = [L[i][..., None].contiguous() for i in range(2)]
            d3 = [delta[i][..., None].contiguous() for i in range(2)]
        kvb, segb = kv, seg
        for j in range(n):
            if j:
                rot = _rotate(comm, [kvb, dkv] + ([segb] if seg is not None
                                                  else []))
                kvb, dkv = rot[0], rot[1]
                segb = rot[2] if seg is not None else None
            for qi, ki, causal in _zigzag_blocks(j, comm.rank):
                qsg, ksg = _half_segs(seg, segb, qi, ki, C, H, Hk)
                args = (q[qi], kvb[ki], kvb[2 + ki], do[qi])
                if flash:
                    args += (L3[qi], d3[qi], scale, causal, None, qsg, ksg)
                    g_q = _kernels.flash_dq(*args)
                    g_k, g_v = _kernels.flash_dkv(*args)
                else:
                    g_q, g_k, g_v = _dense_grads(
                        *args, L[qi], delta[qi],
                        _half_mask(causal, qsg, ksg, C, dev), scale)
                dq[qi] += g_q
                dkv[ki] += g_k
                dkv[2 + ki] += g_v
        # Each accumulator holds the block of rank r + 1 (r + 1 - (n - 1)):
        # one more hop takes it home.
        if n > 1:
            (dkv,) = _rotate(comm, [dkv])
        return (dq.to(q.dtype), dkv.to(kv.dtype), None, None, None, None,
                None, None, None)


def _half_segs(seg, segb, qi, ki, C, H, Hk):
    """The (q, kv) segment ids of half-block (qi, ki): (B, C) ids for the
    dense path are turned into masks by :func:`_half_mask`; here both
    are returned in the kernels' (BH, C, 1) layout when segmented."""
    if seg is None:
        return None, None
    qs = seg[:, qi * C:(qi + 1) * C]
    ks = segb[:, ki * C:(ki + 1) * C]
    return seg_to_bh(qs, H), seg_to_bh(ks, Hk)


def _half_mask(causal, qsg, ksg, C, device):
    """Dense mask of a half-block from the kernel-layout segment ids: None,
    (1, C, C) or one row per kv head row (BHk, C, C)."""
    mask = None
    if causal:
        mask = torch.ones(C, C, dtype=torch.bool, device=device).tril()[None]
    if qsg is not None:
        G = qsg.shape[0] // ksg.shape[0]
        qrow = qsg[::G, :, 0]                  # one q row per kv row
        seg = qrow[:, :, None] == ksg[:, None, :, 0]
        mask = seg if mask is None else (mask & seg)
    return mask


def _zigzag_blocks(j: int, my: int):
    """The live half-blocks of rank ``my`` at ring step ``j``, as (query
    half, kv half, causal), 0 = early and 1 = late.  At ``j > 0`` the kv
    block comes from rank ``my - j``: its early chunk is live for this
    rank's early chunk when that rank is behind (``my >= j``), else its
    late chunk for this rank's late chunk; the late chunk always sees the
    received early chunk."""
    if j == 0:
        return [(0, 0, True), (1, 0, False), (1, 1, True)]
    return [(0, 0, False) if my >= j else (1, 1, False), (1, 0, False)]


def zigzag_ring_attention(q, k, v, comm, scale: Optional[float] = None,
                          use_flash: Optional[bool] = None,
                          segment_ids=None):
    """Causal ring attention over zigzag-sharded sequences: half the work
    of :func:`ring_attention` at perfect load balance.

    Inputs are this rank's zigzag shard (see :func:`zigzag_indices`):
    (B, S_local, H, D) q and (B, S_local, Hk, D) k/v, the first half chunk
    ``r`` (early), the second chunk ``2n-1-r`` (late).  Per ring step each
    rank computes two half-blocks: its late chunk against the received
    early chunk, and its early chunk against the received early chunk when
    the source is behind it, else its late chunk against the received late
    chunk.

    ``use_flash``: None takes the flash kernels on a CUDA tensor when the
    block plan allows the chunk shape, and the dense blocks on a CPU
    tensor; True takes the kernels (their plain twins on the CPU) and
    raises when the plan refuses; False takes the dense blocks.
    ``segment_ids``: optional (B, S_local) packed-sequence ids IN ZIGZAG
    LAYOUT; they rotate with the K/V blocks."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if H % Hk or v.shape[2] != Hk:
        raise ValueError(f"kv heads ({Hk}) must divide query heads ({H})")
    if S % 2:
        raise ValueError("zigzag shard length must be even (two chunks)")
    C = S // 2
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    flash_ok, block = flash_block_plan(C, D)
    if use_flash is None:
        use_flash = flash_ok and q.is_cuda
    elif use_flash and not flash_ok:
        raise ValueError(
            f"use_flash=True but the kernel block plan refused the chunk "
            f"shape (C={C}, D={D}): D > 256, or C has no block dividing it; "
            f"pass use_flash=False (or None) to use the dense blocks")
    qz = torch.stack([to_bh(q[:, :C]), to_bh(q[:, C:])])
    kvz = torch.stack([to_bh(k[:, :C]), to_bh(k[:, C:]),
                       to_bh(v[:, :C]), to_bh(v[:, C:])])
    seg = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device).to(
            torch.int32).contiguous()
    out = _Zigzag.apply(qz, kvz, seg, comm, H, Hk, float(scale),
                        bool(use_flash), block)
    return torch.cat([from_bh(out[0], B, H), from_bh(out[1], B, H)], dim=1)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


def _local_seg_slice(segment_ids, comm, s_local: int, batch: int, device):
    """This rank's (batch, s_local) slice of row-uniform GLOBAL (S,) ids."""
    ids = torch.as_tensor(segment_ids)
    if ids.dim() != 1:
        raise ValueError(
            f"adapter segment_ids must be row-uniform GLOBAL (S,), got "
            f"shape {tuple(ids.shape)} — per-row (B, S) ids go to "
            "ring_attention/ulysses_attention directly (as LOCAL shards)")
    n = comm.size
    if ids.shape[0] != s_local * n:
        raise ValueError(
            f"adapter segment_ids length {ids.shape[0]} != global sequence "
            f"{s_local} * {n} shards = {s_local * n}")
    r = comm.rank
    row = ids[r * s_local:(r + 1) * s_local].to(device=device,
                                                 dtype=torch.int32)
    return row[None].expand(batch, s_local)


def make_ring_attention_fn(comm, causal: bool = True, segment_ids=None,
                           window=None):
    """Adapter with the ``attention_fn(q, k, v, mask)`` signature of the
    transformer layers (the mask is ignored: causality is positional).
    ``segment_ids``: optional row-uniform GLOBAL (S,) ids, sliced to this
    rank's shard at call time."""

    def fn(q, k, v, mask=None):
        del mask
        qs = None
        if segment_ids is not None:
            qs = _local_seg_slice(segment_ids, comm, q.shape[1], q.shape[0],
                                  q.device)
        return ring_attention(q, k, v, comm, causal=causal,
                              q_segment_ids=qs, window=window)

    return fn


def make_zigzag_ring_attention_fn(comm, segment_ids=None):
    """Adapter for :func:`zigzag_ring_attention` (always causal; inputs in
    zigzag layout).  ``segment_ids``: optional row-uniform GLOBAL (S,) ids
    ALREADY in zigzag layout."""

    def fn(q, k, v, mask=None):
        del mask
        seg = None
        if segment_ids is not None:
            seg = _local_seg_slice(segment_ids, comm, q.shape[1], q.shape[0],
                                   q.device)
        return zigzag_ring_attention(q, k, v, comm, segment_ids=seg)

    return fn


def gather_sequence_kv(k, v, comm):
    """All-gather sequence-sharded K/V: (B, S_local, Hk, D) on each rank
    -> (B, S_local * n, Hk, D) in ring order, the plain concatenation an
    unsharded chunk would hold (the building block of a sequence-parallel
    prefill).  Differentiable (its backward reduce-scatters)."""
    return (_allgather(comm, k, axis=1, tiled=True),
            _allgather(comm, v, axis=1, tiled=True))

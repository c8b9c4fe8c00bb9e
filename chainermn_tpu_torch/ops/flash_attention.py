"""Flash attention on hand-written Hopper kernels.

Port of ``chainermn_tpu/ops/flash_attention.py``.  Blockwise attention
with an online softmax: O(S) memory, fp32 accumulation, and a
FlashAttention-2 backward that recomputes probabilities from one saved
fp32 log-sum-exp per row, so neither pass materializes the S x S matrix.
The three Pallas kernels of the reference become the CUDA kernels of
:mod:`chainermn_tpu_torch.ops._kernels` (``flash_fwd``, ``flash_dq``,
``flash_dkv``), each registered as a custom op
(``torch.ops.chainermn_torch.*``) that the autograd function below calls,
so a dispatch mode sees their real inputs and outputs; on CPU tensors
each op runs its plain PyTorch twin, which is what the CPU tests run.

Public layouts are the reference's: ``(B, S, H, D)`` at
:func:`flash_attention`, ``(B*H, S, D)`` at the kernel boundary (the
``_with_lse`` functions), with the batch-major head flattening that makes
query row ``b``'s kv row ``b // G`` under GQA/MQA.

Masks: causal, a sliding window (``q - k < window``, causal only) and
packed-sequence segment ids; a query row whose segment matches no key
(padding) gives zero output and zero gradients.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _kernels

_NEG_INF = _kernels._NEG_INF


# ---------------------------------------------------------------------------
# Autograd over the three kernels
# ---------------------------------------------------------------------------


def _flash_bh_bwd(q, k, v, o, lse, do, dlse, scale, causal, window, q_seg,
                  kv_seg):
    """(BH, S, D) backward: (dq, dk, dv).

    ``delta = rowsum(dO * O) - dlse`` is a plain torch op outside the
    kernels (the reference computes it in XLA outside Pallas): since
    d lse_i / d s_ij = p_ij, the LSE cotangent folds into the per-row
    residual of ``dS = P * (dP - delta)``."""
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float().reshape(delta.shape)
    delta = delta.contiguous()
    dq = _kernels.flash_dq(q, k, v, do, lse, delta, scale, causal, window,
                           q_seg, kv_seg)
    dk, dv = _kernels.flash_dkv(q, k, v, do, lse, delta, scale, causal,
                                window, q_seg, kv_seg)
    return dq, dk, dv


class _FlashBH(torch.autograd.Function):
    """(BH, S, D) flash attention returning ``(o, lse)``, both
    differentiable.  One Function serves the reference's four
    ``custom_vjp``s (plain, segmented, with-LSE, with-LSE segmented): an
    unused ``lse`` output simply gets no cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, scale, causal, window):
        o, lse = _kernels.flash_fwd(q, k, v, scale, causal, window, q_seg,
                                    kv_seg)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.args = (scale, causal, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        scale, causal, window = ctx.args
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _flash_bh_bwd(q, k, v, o, lse, do, dlse, scale, causal,
                                   window, q_seg, kv_seg)
        return dq, dk, dv, None, None, None, None, None


def _check_blocks(Sq, Sk, block_q, block_k):
    for name, S, b in (("block_q", Sq, block_q), ("block_k", Sk, block_k)):
        if b is not None and (b < 1 or S % b):
            raise ValueError(f"{name}={b} must divide the sequence length {S}")


def flash_attention_with_lse(q, k, v, scale, causal, block_q=None,
                             block_k=None):
    """(BH, S, D) flash attention returning ``(o, lse)`` with ``lse`` of
    shape ``(BH, S, 1)`` fp32 — both differentiable; the LSE cotangent
    folds into the backward kernels' residual.  The composition form for
    layers that merge blocks through the row log-sum-exp.

    ``block_q``/``block_k`` are validated (they must divide the sequence
    lengths, as the reference's grid requires) but do not choose the CUDA
    tile."""
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return _FlashBH.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          None, None, float(scale), bool(causal), None)


def flash_attention_with_lse_seg(q, k, v, q_seg, kv_seg, scale, causal,
                                 block_q=None, block_k=None):
    """Segment-masked :func:`flash_attention_with_lse`; ``q_seg``/``kv_seg``
    are ``(BH, S, 1)`` int32 (see :func:`seg_to_bh`)."""
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return _FlashBH.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_seg.to(torch.int32).contiguous(), kv_seg.to(torch.int32).contiguous(),
        float(scale), bool(causal), None,
    )


# ---------------------------------------------------------------------------
# Dense counterpart (shapes outside the kernel gate)
# ---------------------------------------------------------------------------


def segment_mask(q_segment_ids, kv_segment_ids):
    """(B, Sq) x (B, Sk) int ids -> (B, Sq, Sk) boolean equality mask."""
    return q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]


def dense_attention(q, k, v, scale, causal, q_segment_ids=None,
                    kv_segment_ids=None, window=None):
    """Materialized-logits attention over (B, S, H, D): the counterpart of
    the reference's ``_xla_attention``, taken for shapes outside the
    kernel gate.  fp32 logits and softmax; fully masked rows give zero."""
    if k.shape[2] != q.shape[2]:
        G = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    Sq, Sk = q.shape[1], k.shape[1]
    dev = q.device
    mask = None
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev).tril()[None]
    if window is not None:
        band = (torch.arange(Sq, device=dev)[:, None]
                - torch.arange(Sk, device=dev)[None, :] < window)[None]
        mask = band if mask is None else (mask & band)
    if q_segment_ids is not None:
        seg = segment_mask(q_segment_ids, kv_segment_ids)
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask[:, None], logits,
                             torch.full_like(logits, _NEG_INF))
    w = torch.softmax(logits, dim=-1)
    if q_segment_ids is not None:
        any_valid = mask.any(dim=-1)                       # (B, Sq)
        w = torch.where(any_valid[:, None, :, None], w, torch.zeros_like(w))
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Block policy and layouts
# ---------------------------------------------------------------------------


def auto_block_size(S: int) -> int:
    """The reference's static default block edge: the divisor of ``S``
    among 128/256/512 nearest ``S/16`` (clamped to [128, 512]), else
    ``min(128, S)``.  It decides only the shape gate here."""
    target = int(np.clip(S // 16, 128, 512))
    cands = [b for b in (128, 256, 512) if S % b == 0]
    if not cands:
        return min(128, S)
    return min(cands, key=lambda b: abs(b - target))


def flash_block_plan(S: int, D: int):
    """(usable, block_size) for running the kernels over length-``S``
    chunks — the reference's compiled-path policy without the TPU sublane
    rule (the CUDA kernels mask their own ragged edge): D <= 256 and a
    block that divides ``S``."""
    if D > 256:
        return False, 0
    if any(S % b == 0 for b in (128, 256, 512)):
        return True, auto_block_size(S)
    if S <= 512:
        return True, S
    return False, 0


def to_bh(x):
    """(B, S, H, D) -> (B*H, S, D), the kernel layout (contiguous)."""
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()


def from_bh(x, B: int, H: int):
    """(B*H, S, D) -> (B, S, H, D)."""
    _, S, D = x.shape
    return x.reshape(B, H, S, D).permute(0, 2, 1, 3)


def seg_to_bh(ids, H: int):
    """(B, S) segment ids -> the kernel's (B*H, S, 1) int32 layout."""
    return torch.repeat_interleave(ids.to(torch.int32), H, dim=0)[..., None] \
        .contiguous()


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
):
    """Flash attention over (B, S, H, D) tensors.

    ``k``/``v`` may carry ``H_kv`` heads dividing ``H`` (GQA; 1 is MQA):
    the kernels read the shared kv row by index arithmetic and reduce the
    group's dk/dv inside the dK/dV kernel.  ``window`` (causal only): query
    ``i`` attends keys ``[i - window + 1, i]``.  ``q_segment_ids`` /
    ``kv_segment_ids``: (B, S) int ids of packed sequences.

    The shape gate is the reference's: D <= 256 and blocks dividing the
    sequence lengths run the kernels (on a CUDA tensor, the hand-written
    kernel; on a CPU tensor, its plain twin); other shapes take
    :func:`dense_attention`.  ``block_q``/``block_k`` are validated as
    in the reference but do not choose the CUDA tile, which each kernel
    compiles in; with no block to choose, the wrapper consults no tune
    cache (``tuning.search_space.flash_search_space`` lists the one tile
    of each route).  The reference's backward block pair has nothing to
    choose here and is not taken.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Hk = k.shape[2]
    if H % Hk or v.shape[2] != Hk:
        raise ValueError(
            f"kv heads ({Hk}, v {v.shape[2]}) must be equal and divide "
            f"the query head count ({H})"
        )
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if window is not None:
        if not causal:
            raise ValueError(
                "window (sliding-window attention) requires causal=True"
            )
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be passed together"
        )

    block_q = min(block_q or auto_block_size(Sq), Sq)
    block_k = min(block_k or auto_block_size(Sk), Sk)
    usable = D <= 256 and Sq % block_q == 0 and Sk % block_k == 0
    if not usable:
        return dense_attention(
            q, k, v, scale, causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, window=window,
        )

    qs = ks = None
    if q_segment_ids is not None:
        qs = seg_to_bh(q_segment_ids, H)
        ks = seg_to_bh(kv_segment_ids, Hk)
    out, _ = _FlashBH.apply(to_bh(q), to_bh(k), to_bh(v), qs, ks,
                            float(scale), bool(causal), window)
    return from_bh(out, B, H)


def make_flash_attention_fn(causal: bool = True, q_segment_ids=None,
                            kv_segment_ids=None, window=None,
                            block_q=None, block_k=None):
    """Adapter for the transformer layers' ``attention_fn(q, k, v, mask)``
    slot (the mask argument is ignored; causality is the kernel's).

    Segment ids bind at construction: ``(S,)`` ids broadcast to every
    batch row (the data-parallel-safe form), ``(B, S)`` ids must match the
    batch the adapter sees."""

    def _match(ids, batch, device):
        ids = torch.as_tensor(ids, device=device)
        if ids.dim() == 1:
            return ids[None].expand(batch, ids.shape[0])
        if ids.shape[0] != batch:
            raise ValueError(
                f"segment_ids batch {ids.shape[0]} != attention batch "
                f"{batch}: pass row-uniform (S,) ids under data "
                "parallelism, or call flash_attention directly"
            )
        return ids

    def fn(q, k, v, mask=None):
        del mask
        qs = ks = None
        if q_segment_ids is not None:
            qs = _match(q_segment_ids, q.shape[0], q.device)
            ks = _match(
                kv_segment_ids if kv_segment_ids is not None
                else q_segment_ids,
                k.shape[0], k.device,
            )
        return flash_attention(
            q, k, v, causal=causal, q_segment_ids=qs, kv_segment_ids=ks,
            window=window, block_q=block_q, block_k=block_k,
        )

    return fn

"""One-pass RMSNorm, optionally followed by RoPE, forward and backward: the
normalisations of :class:`~chainermn_tpu_torch.models.afmoe.AFMoELM`.

``y = rope(x * rsqrt(mean(x^2) + eps) * w)`` over the last dimension, the
statistic and every product in fp32 whatever the input's dtype, ``y``
rounded once to the output dtype; the row's ``rstd`` is kept for the
backward, which recomputes ``xhat = x * rstd``.  ``rope`` is the identity
or, given the (S, d) cos and sin tables of
:func:`~chainermn_tpu_torch.models.afmoe.rope_tables`, the rotation of each
(B, S, H, d) head row by its position's row::

    y = n * cos + rotate_half(n) * sin,   rotate_half([a, b]) = [-b, a]

Folding the rotation into the norm moves where ``q`` and ``k`` round to
bf16, not what they compute: the norm's fp32 result is rotated before its
one rounding, where the two-step form rounded the normalised head to bf16
and rounded again after rotating it.  The result is closer to the fp32
mathematics, never further.

Three hand-written Triton kernels behind two ``torch.library`` custom ops
(``chainermn_torch::rms_fwd`` and ``::rms_bwd``, each taking the tables or
``None``) whose bodies run plain PyTorch twins on CPU tensors; each launch
on a card adds one to :data:`LAUNCHES`, under ``rms_rope_fwd`` /
``rms_rope_bwd`` when the tables were given:

=================  ======================================================
``rms_fwd``        ``(y, rstd)`` of rows of any width (``rms_rope_fwd``:
                   the same kernel with the tables)
``rms_bwd``        ``dx`` and per-program fp32 partials of ``dw``: the
                   tables first rotate ``dy`` back (``rms_rope_bwd``)
``rms_dw``         ``dw``: the partials summed in a fixed order (no
                   atomics, so two runs give the same bits)
=================  ======================================================

They replace no TPU kernel (the reference's norms are jnp) and were added
because the fp32 elementwise chain they replace (a dozen whole-tensor
passes a norm, each through device memory) dominated the Trinity step.
Every one is bound by bytes, at well under one operation a byte: the
design reads each input once and writes each output once, holds the row
statistic and both RoPE halves in registers (the tables are 2 MB and stay
in L2), and sizes a block of rows from the row width, a shape the caller
cannot choose wrong: rows of 2048 go one to a forward program, the rows
of a 128-wide head 16 (:data:`PROGRAM_BYTES`).  The backward walks blocks
of about :data:`BWD_BLOCK_BYTES` in one program per SM, so that its
``dw`` partials stay near 1 MB.  Each kernel compiles at its first launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {"rms_fwd": 0, "rms_rope_fwd": 0, "rms_bwd": 0,
            "rms_rope_bwd": 0, "rms_dw": 0}

#: Bytes a forward program moves: rows of 2048 go one to a program, the
#: rows of a 128-wide head 16 to a program (measured on an H100: larger
#: blocks of head rows are slower with RoPE, 0.136 ms a q call at 32 KB
#: against 0.110 at 8 KB).
PROGRAM_BYTES = 8 * 1024

#: Bytes a backward program moves each turn of its loop over row blocks.
BWD_BLOCK_BYTES = 128 * 1024

#: Columns of ``dw`` a program of its second pass sums.
DW_COLUMNS = 16

#: Widest row a program holds in registers.
MAX_WIDTH = 16384

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TRITON: dict = {}
_SMS: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain twins (the CPU path)
# ---------------------------------------------------------------------------


def rope_plain(y: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """``y * cos + rotate_half(y) * sin`` over (B, S, H, d) by the (S, d)
    tables, in ``y``'s dtype."""
    a, b = y.chunk(2, dim=-1)
    return y * cos[:, None] + torch.cat([-b, a], dim=-1) * sin[:, None]


def rope_back_plain(dy: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """The rotation's backward: ``dy`` rotated back by the same tables."""
    a, b = (dy * sin[:, None]).chunk(2, dim=-1)
    return dy * cos[:, None] + torch.cat([b, -a], dim=-1)


def _wide(t: Tensor) -> torch.dtype:
    """fp32, or ``t``'s dtype where it is wider (fp64 for gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _up(t: Tensor) -> Tensor:
    return t.to(_wide(t))


def rms_fwd_plain(x: Tensor, w: Tensor, eps: float, out_dtype: torch.dtype,
                  cos: Optional[Tensor] = None,
                  sin: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """``(y, rstd)``: ``y`` in ``out_dtype``, ``rstd`` (..., 1) fp32."""
    xf = _up(x)
    rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    y = xf * rstd * _up(w)
    if cos is not None:
        y = rope_plain(y, cos, sin)
    return y.to(out_dtype), rstd


def rms_bwd_plain(dy: Tensor, x: Tensor, w: Tensor, rstd: Tensor,
                  cos: Optional[Tensor] = None,
                  sin: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """``(dx, dw)``: ``dx`` in ``x``'s dtype, ``dw`` fp32."""
    dyf = _up(dy)
    if cos is not None:
        dyf = rope_back_plain(dyf, cos, sin)
    xhat = _up(x) * rstd
    dyw = dyf * _up(w)
    dx = rstd * (dyw - xhat * (dyw * xhat).mean(-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw


# ---------------------------------------------------------------------------
# The Triton kernels (built at first launch)
# ---------------------------------------------------------------------------


def _triton():
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl

    @triton.jit
    def rms_fwd_kernel(x_ptr, w_ptr, cos_ptr, sin_ptr, y_ptr, rstd_ptr,
                       n_rows, D, heads, seq, eps, ROWS: tl.constexpr,
                       BLOCK: tl.constexpr, ROPE: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        live = rows < n_rows
        cols = tl.arange(0, BLOCK)
        at = rows.to(tl.int64)[:, None] * D + cols[None, :]
        out_ty = y_ptr.dtype.element_ty
        if ROPE:
            # The two halves of each head row apart, so that the rotation
            # pairs them in registers.
            half = D // 2
            cm = cols < half
            m = live[:, None] & cm[None, :]
            x1 = tl.load(x_ptr + at, mask=m, other=0.0).to(tl.float32)
            x2 = tl.load(x_ptr + at + half, mask=m, other=0.0).to(tl.float32)
            ms = (tl.sum(x1 * x1, axis=1) + tl.sum(x2 * x2, axis=1)) / D
            rstd = 1.0 / tl.sqrt(ms + eps)
            w1 = tl.load(w_ptr + cols, mask=cm, other=0.0).to(tl.float32)
            w2 = tl.load(w_ptr + half + cols, mask=cm,
                         other=0.0).to(tl.float32)
            n1 = x1 * rstd[:, None] * w1[None, :]
            n2 = x2 * rstd[:, None] * w2[None, :]
            tab = (((rows // heads) % seq).to(tl.int64)[:, None] * D
                   + cols[None, :])
            c1 = tl.load(cos_ptr + tab, mask=m, other=0.0)
            c2 = tl.load(cos_ptr + tab + half, mask=m, other=0.0)
            s1 = tl.load(sin_ptr + tab, mask=m, other=0.0)
            s2 = tl.load(sin_ptr + tab + half, mask=m, other=0.0)
            tl.store(y_ptr + at, (n1 * c1 - n2 * s1).to(out_ty), mask=m)
            tl.store(y_ptr + at + half, (n2 * c2 + n1 * s2).to(out_ty),
                     mask=m)
        else:
            cm = cols < D
            m = live[:, None] & cm[None, :]
            x = tl.load(x_ptr + at, mask=m, other=0.0).to(tl.float32)
            rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / D + eps)
            w = tl.load(w_ptr + cols, mask=cm, other=0.0).to(tl.float32)
            tl.store(y_ptr + at, (x * rstd[:, None] * w[None, :]).to(out_ty),
                     mask=m)
        tl.store(rstd_ptr + rows, rstd, mask=live)

    @triton.jit
    def rms_bwd_kernel(dy_ptr, x_ptr, w_ptr, rstd_ptr, cos_ptr, sin_ptr,
                       dx_ptr, part_ptr, n_rows, D, heads, seq,
                       ROWS: tl.constexpr, BLOCK: tl.constexpr,
                       ROPE: tl.constexpr):
        pid = tl.program_id(0)
        n_blocks = tl.cdiv(n_rows, ROWS)
        cols = tl.arange(0, BLOCK)
        dx_ty = dx_ptr.dtype.element_ty
        if ROPE:
            half = D // 2
            cm = cols < half
            w1 = tl.load(w_ptr + cols, mask=cm, other=0.0).to(tl.float32)
            w2 = tl.load(w_ptr + half + cols, mask=cm,
                         other=0.0).to(tl.float32)
            acc1 = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
            acc2 = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
            for blk in range(pid, n_blocks, tl.num_programs(0)):
                rows = blk * ROWS + tl.arange(0, ROWS)
                live = rows < n_rows
                m = live[:, None] & cm[None, :]
                at = rows.to(tl.int64)[:, None] * D + cols[None, :]
                tab = (((rows // heads) % seq).to(tl.int64)[:, None] * D
                       + cols[None, :])
                g1 = tl.load(dy_ptr + at, mask=m, other=0.0).to(tl.float32)
                g2 = tl.load(dy_ptr + at + half, mask=m,
                             other=0.0).to(tl.float32)
                c1 = tl.load(cos_ptr + tab, mask=m, other=0.0)
                c2 = tl.load(cos_ptr + tab + half, mask=m, other=0.0)
                s1 = tl.load(sin_ptr + tab, mask=m, other=0.0)
                s2 = tl.load(sin_ptr + tab + half, mask=m, other=0.0)
                d1 = g1 * c1 + g2 * s2        # dy rotated back
                d2 = g2 * c2 - g1 * s1
                r = tl.load(rstd_ptr + rows, mask=live, other=0.0)[:, None]
                h1 = tl.load(x_ptr + at, mask=m,
                             other=0.0).to(tl.float32) * r
                h2 = tl.load(x_ptr + at + half, mask=m,
                             other=0.0).to(tl.float32) * r
                e1 = d1 * w1[None, :]
                e2 = d2 * w2[None, :]
                c = (tl.sum(e1 * h1, axis=1) + tl.sum(e2 * h2, axis=1)) / D
                tl.store(dx_ptr + at, (r * (e1 - h1 * c[:, None])).to(dx_ty),
                         mask=m)
                tl.store(dx_ptr + at + half,
                         (r * (e2 - h2 * c[:, None])).to(dx_ty), mask=m)
                acc1 += d1 * h1
                acc2 += d2 * h2
            tl.store(part_ptr + pid * D + cols, tl.sum(acc1, axis=0),
                     mask=cm)
            tl.store(part_ptr + pid * D + half + cols, tl.sum(acc2, axis=0),
                     mask=cm)
        else:
            cm = cols < D
            w = tl.load(w_ptr + cols, mask=cm, other=0.0).to(tl.float32)
            acc = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
            for blk in range(pid, n_blocks, tl.num_programs(0)):
                rows = blk * ROWS + tl.arange(0, ROWS)
                live = rows < n_rows
                m = live[:, None] & cm[None, :]
                at = rows.to(tl.int64)[:, None] * D + cols[None, :]
                g = tl.load(dy_ptr + at, mask=m, other=0.0).to(tl.float32)
                r = tl.load(rstd_ptr + rows, mask=live, other=0.0)[:, None]
                h = tl.load(x_ptr + at, mask=m, other=0.0).to(tl.float32) * r
                e = g * w[None, :]
                c = tl.sum(e * h, axis=1) / D
                tl.store(dx_ptr + at, (r * (e - h * c[:, None])).to(dx_ty),
                         mask=m)
                acc += g * h
            tl.store(part_ptr + pid * D + cols, tl.sum(acc, axis=0), mask=cm)

    @triton.jit
    def rms_dw_kernel(part_ptr, dw_ptr, n_parts, D, BLOCK_P: tl.constexpr,
                      BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cm = cols < D
        acc = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            ps = p0 + tl.arange(0, BLOCK_P)
            m = (ps < n_parts)[:, None] & cm[None, :]
            acc += tl.load(part_ptr + ps[:, None] * D + cols[None, :],
                           mask=m, other=0.0)
        tl.store(dw_ptr + cols, tl.sum(acc, axis=0), mask=cm)

    _TRITON.update(triton=triton, fwd=rms_fwd_kernel, bwd=rms_bwd_kernel,
                   dw=rms_dw_kernel)
    return _TRITON


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def tile(D: int, row_bytes: int, rope: bool,
         program_bytes: int) -> Tuple[int, int, int]:
    """``(ROWS, BLOCK, num_warps)`` of a block of rows ``D`` wide that move
    ``row_bytes`` each: the rows that make up ``program_bytes`` (a power of
    two, at least one) and the block of columns (half the row under RoPE,
    whose halves are held apart)."""
    block = _pow2(D // 2 if rope else D)
    rows = max(1, program_bytes // row_bytes)
    rows = 1 << (rows.bit_length() - 1)
    elems = rows * block * (2 if rope else 1)
    return rows, block, 8 if elems >= 2048 else 4


def _sms(device) -> int:
    i = device.index
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _check(name, x, w, rope, *more):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: runs on the CPU (its twin) or on a CUDA "
                         f"card, not on {x.device.type}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: takes {_DTYPES}, got {x.dtype}")
    if tuple(w.shape) != (D,):
        raise ValueError(f"{name}: weight of shape {tuple(w.shape)} for "
                         f"rows {D} wide")
    if not 0 < D <= MAX_WIDTH:
        raise ValueError(f"{name}: rows of 1 to {MAX_WIDTH}, got {D}")
    for t in (x, w, *rope, *more):
        if t.device != x.device:
            raise ValueError(f"{name}: all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if rope:
        cos, sin = rope
        if x.dim() != 4 or D % 2:
            raise ValueError(f"{name}: RoPE takes (B, S, H, d) rows of even "
                             f"width, got {tuple(x.shape)}")
        want = (x.shape[1], D)
        for t in rope:
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(f"{name}: tables of shape {want} in fp32, "
                                 f"got {tuple(t.shape)} {t.dtype}")


def _rope_dims(x: Tensor, rope) -> Tuple[int, int]:
    """``(heads, seq)``: a row's position is ``(row // heads) % seq``."""
    return (x.shape[2], x.shape[1]) if rope else (1, 1)


def _tables(cos, sin) -> tuple:
    """``(cos, sin)``, or ``()`` for a norm without RoPE."""
    if (cos is None) != (sin is None):
        raise ValueError("rms_norm: RoPE takes both cos and sin")
    return () if cos is None else (cos, sin)


def _fwd(x, w, eps, out_dtype, rope):
    name = "rms_rope_fwd" if rope else "rms_fwd"
    _check(name, x, w, rope)
    D = x.shape[-1]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                       device=x.device)
    n = x.numel() // D
    if n:
        rows, block, warps = tile(D, D * (x.element_size() + y.element_size()),
                                  bool(rope), PROGRAM_BYTES)
        heads, seq = _rope_dims(x, rope)
        cos, sin = rope or (x, x)
        k = _triton()
        with torch.cuda.device(x.device):
            k["fwd"][(-(-n // rows),)](
                x, w, cos, sin, y, rstd, n, D, heads, seq, eps, ROWS=rows,
                BLOCK=block, ROPE=bool(rope), num_warps=warps)
        LAUNCHES[name] += 1
    return y, rstd


def _bwd(dy, x, w, rstd, rope):
    name = "rms_rope_bwd" if rope else "rms_bwd"
    _check(name, x, w, rope, dy, rstd)
    D = x.shape[-1]
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    n = x.numel() // D
    if not n:
        return dx, dw.zero_()
    rows, block, warps = tile(
        D, D * (dy.element_size() + 2 * x.element_size()), bool(rope),
        BWD_BLOCK_BYTES)
    # One program an SM keeps the ``dw`` partials (programs x width x 4
    # bytes) near 1 MB for rows of 2048, and was the fastest measured.
    programs = min(-(-n // rows), _sms(x.device))
    parts = torch.empty(programs, D, dtype=torch.float32, device=x.device)
    heads, seq = _rope_dims(x, rope)
    cos, sin = rope or (x, x)
    k = _triton()
    block_c = min(DW_COLUMNS, _pow2(D))
    with torch.cuda.device(x.device):
        k["bwd"][(programs,)](
            dy, x, w, rstd, cos, sin, dx, parts, n, D, heads, seq, ROWS=rows,
            BLOCK=block, ROPE=bool(rope), num_warps=warps)
        k["dw"][(-(-D // block_c),)](parts, dw, programs, D, BLOCK_P=32,
                                     BLOCK_C=block_c, num_warps=4)
    LAUNCHES[name] += 1
    LAUNCHES["rms_dw"] += 1
    return dx, dw


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------


@torch.library.custom_op("chainermn_torch::rms_fwd", mutates_args=())
def _rms_fwd_op(x: Tensor, w: Tensor, eps: float, out_dtype: torch.dtype,
                cos: Optional[Tensor] = None,
                sin: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    if x.device.type == "cpu":
        return rms_fwd_plain(x, w, eps, out_dtype, cos, sin)
    return _fwd(x, w, eps, out_dtype, _tables(cos, sin))


@_rms_fwd_op.register_fake
def _(x, w, eps, out_dtype, cos=None, sin=None):
    return (x.new_empty(x.shape, dtype=out_dtype),
            x.new_empty(x.shape[:-1] + (1,), dtype=_wide(x)))


@torch.library.custom_op("chainermn_torch::rms_bwd", mutates_args=())
def _rms_bwd_op(dy: Tensor, x: Tensor, w: Tensor, rstd: Tensor,
                cos: Optional[Tensor] = None,
                sin: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    if x.device.type == "cpu":
        return rms_bwd_plain(dy, x, w, rstd, cos, sin)
    return _bwd(dy, x, w, rstd, _tables(cos, sin))


@_rms_bwd_op.register_fake
def _(dy, x, w, rstd, cos=None, sin=None):
    return torch.empty_like(x), x.new_empty((x.shape[-1],), dtype=_wide(w))


# ---------------------------------------------------------------------------
# Autograd over the kernels
# ---------------------------------------------------------------------------


class _RMSNorm(torch.autograd.Function):
    """Keeps ``x``, ``w`` and the row statistic (and the tables) for the
    backward."""

    @staticmethod
    def forward(ctx, x, w, eps, out_dtype, cos, sin):
        x = x.contiguous()
        y, rstd = torch.ops.chainermn_torch.rms_fwd(x, w, eps, out_dtype,
                                                    cos, sin)
        ctx.save_for_backward(x, w, rstd, cos, sin)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd, cos, sin = ctx.saved_tensors
        dx, dw = torch.ops.chainermn_torch.rms_bwd(dy.contiguous(), x, w,
                                                   rstd, cos, sin)
        return dx, dw.to(w.dtype), None, None, None, None


def rms_norm(x: Tensor, w: Tensor, eps: float,
             out_dtype: torch.dtype = torch.float32,
             rope: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dimension in fp32,
    then RoPE by ``rope`` = (cos, sin), each (S, d) fp32, over ``x`` of
    (B, S, H, d); the result in ``out_dtype``.  Differentiable in ``x``
    and ``w``."""
    cos, sin = rope if rope is not None else (None, None)
    return _RMSNorm.apply(x, w, eps, out_dtype, cos, sin)

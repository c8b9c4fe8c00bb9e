"""Dropless expert dispatch: the permute, the grouped products and the
weighted combine of :class:`~chainermn_tpu_torch.parallel.moe.DroplessMoE`.

A token's ``k`` routing choices are its *assignments*; those that fall on
the experts this rank holds are laid out in an expert-sorted buffer of
``M = T k + count (ALIGN - 1)`` rows (every assignment could be held; each
expert's group starts on a multiple of :data:`ALIGN`), computed on the device
by one stable sort (:func:`dispatch_plan`), so no group size ever reaches
the host.  Rows that belong to no assignment are zeros on the way in and
are never read on the way out.

Three hand-written Triton kernels move rows between the token order and
that buffer; each is a ``torch.library`` custom op
(``chainermn_torch::moe_permute``, ``::moe_combine``,
``::moe_combine_bwd``) whose body runs a plain PyTorch twin on CPU
tensors, as the flash ops do, and adds one to :data:`LAUNCHES` per launch
on a card:

===================  ====================================================
``moe_permute``      ``xs[r] = x[src[r]]``, zeros where ``src[r] < 0``
``moe_combine``      ``out[t] = sum_j g[t, j] ys[pos[t, j]]`` over the held
                     ``pos >= 0`` (``g`` = 1 when absent: the permute's
                     backward)
``moe_combine_bwd``  ``dys[r] = w[r] dout[src[r]]`` and
                     ``dw[r] = <dout[src[r]], ys[r]>``: the combine's
                     backward, zeros where ``src[r] < 0``
===================  ====================================================

The expert products are one grouped GEMM each (:func:`grouped_mm`):
``torch._grouped_mm`` over the groups' cumulative ends on a card (bf16
only), its plain twin on the CPU; neither loops over experts in Python.  Rows past
the last group are left undefined by the card's product and are read by
nothing.  Each Triton kernel compiles at its first launch.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {"moe_permute": 0, "moe_combine": 0, "moe_combine_bwd": 0}

#: Group starts are aligned to this many rows: the card's grouped product
#: reads every group through 16-byte-aligned tiles.
ALIGN = 16

_TRITON: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The plan: where each held assignment lives in the expert-sorted buffer
# ---------------------------------------------------------------------------

Plan = collections.namedtuple("Plan", "src pos assign offs sizes rows")
Plan.__doc__ = """Where each held assignment lives in the sorted buffer.

``src`` (M,) int32: the token of each buffer row, -1 for a row that holds
no assignment; ``assign`` (M,) int64: the flat assignment index
``t * k + j`` of each row, -1 likewise; ``pos`` (T, k) int32: the row of
each assignment, -1 where its expert is not held; ``offs`` (count,) int32:
the groups' cumulative ends (padded to :data:`ALIGN`); ``sizes`` (count,)
int64: each held expert's assignments; ``rows``: M."""


def buffer_rows(tokens: int, k: int, count: int) -> int:
    """Rows of the sorted buffer: every assignment held, every group padded."""
    return tokens * k + count * (ALIGN - 1)


def dispatch_plan(idx: Tensor, first: int, count: int) -> Plan:
    """The :class:`Plan` of top-k choices ``idx`` (T, k) over the global
    experts, for the held experts ``[first, first + count)``: a stable sort
    of the assignments by held expert (the others last), each group's rows
    in assignment order.  Device ops only, no host synchronisation."""
    T, k = idx.shape
    dev = idx.device
    n = T * k
    M = buffer_rows(T, k, count)
    local = idx.reshape(-1).long() - first
    held = (local >= 0) & (local < count)
    key = torch.where(held, local, torch.full_like(local, count))
    order = torch.argsort(key, stable=True)
    sizes = torch.zeros(count + 1, dtype=torch.long, device=dev).scatter_add_(
        0, key, torch.ones_like(key))[:count]
    padded = (sizes + (ALIGN - 1)) // ALIGN * ALIGN
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    first_sorted = torch.cumsum(sizes, 0) - sizes
    skey = key[order]
    valid = skey < count
    e = skey.clamp(max=count - 1)
    r = torch.arange(n, device=dev)
    row = torch.where(valid, starts[e] + r - first_sorted[e],
                      torch.full_like(r, M))
    assign = torch.full((M + 1,), -1, dtype=torch.long, device=dev).scatter_(
        0, row, torch.where(valid, order, torch.full_like(order, -1)))[:M]
    pos = torch.empty(n, dtype=torch.long, device=dev).scatter_(
        0, order, torch.where(valid, row, torch.full_like(row, -1)))
    src = torch.where(assign >= 0, assign // k, torch.full_like(assign, -1))
    return Plan(src.to(torch.int32), pos.view(T, k).to(torch.int32), assign,
                ends.to(torch.int32), sizes, M)


# ---------------------------------------------------------------------------
# Plain twins (the CPU path)
# ---------------------------------------------------------------------------


def permute_plain(x: Tensor, src: Tensor) -> Tensor:
    s = src.long()
    out = x[s.clamp(min=0)]
    return torch.where((s >= 0)[:, None], out, torch.zeros_like(out))


def combine_plain(ys: Tensor, pos: Tensor, g: Optional[Tensor]) -> Tensor:
    p = pos.long()
    rows = ys[p.clamp(min=0)].float()                       # (T, k, D)
    w = (p >= 0).float() if g is None else torch.where(
        p >= 0, g.float(), torch.zeros_like(g, dtype=torch.float32))
    return (rows * w[..., None]).sum(1).to(ys.dtype)


def combine_bwd_plain(dout: Tensor, ys: Tensor, src: Tensor,
                      w: Tensor) -> Tuple[Tensor, Tensor]:
    s = src.long()
    ok = (s >= 0)[:, None]
    dy = torch.where(ok, dout[s.clamp(min=0)].float(),
                     torch.zeros((), device=dout.device))
    y = torch.where(ok, ys.float(), torch.zeros((), device=ys.device))
    return (dy * w.float()[:, None]).to(ys.dtype), (dy * y).sum(-1)


# ---------------------------------------------------------------------------
# The Triton kernels (built at first launch)
# ---------------------------------------------------------------------------


def _triton():
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl

    @triton.jit
    def moe_permute_kernel(x_ptr, src_ptr, out_ptr, D,
                           BLOCK_D: tl.constexpr):
        r = tl.program_id(0).to(tl.int64)
        s = tl.load(src_ptr + r).to(tl.int64)
        ok = s >= 0
        base = tl.where(ok, s, 0) * D
        for d0 in range(0, D, BLOCK_D):
            cols = d0 + tl.arange(0, BLOCK_D)
            m = cols < D
            v = tl.load(x_ptr + base + cols, mask=m & ok, other=0.0)
            tl.store(out_ptr + r * D + cols, v, mask=m)

    @triton.jit
    def moe_combine_kernel(ys_ptr, pos_ptr, g_ptr, out_ptr, D,
                           K: tl.constexpr, HAS_G: tl.constexpr,
                           BLOCK_D: tl.constexpr):
        t = tl.program_id(0).to(tl.int64)
        for d0 in range(0, D, BLOCK_D):
            cols = d0 + tl.arange(0, BLOCK_D)
            m = cols < D
            acc = tl.zeros([BLOCK_D], dtype=tl.float32)
            for j in tl.static_range(K):
                p = tl.load(pos_ptr + t * K + j).to(tl.int64)
                ok = p >= 0
                v = tl.load(ys_ptr + tl.where(ok, p, 0) * D + cols,
                            mask=m & ok, other=0.0).to(tl.float32)
                if HAS_G:
                    v = v * tl.load(g_ptr + t * K + j)
                acc += v
            tl.store(out_ptr + t * D + cols,
                     acc.to(out_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def moe_combine_bwd_kernel(dout_ptr, ys_ptr, src_ptr, w_ptr, dys_ptr,
                               dw_ptr, D, BLOCK_D: tl.constexpr):
        r = tl.program_id(0).to(tl.int64)
        s = tl.load(src_ptr + r).to(tl.int64)
        ok = s >= 0
        w = tl.load(w_ptr + r)
        base = tl.where(ok, s, 0) * D
        dot = tl.zeros([BLOCK_D], dtype=tl.float32)
        for d0 in range(0, D, BLOCK_D):
            cols = d0 + tl.arange(0, BLOCK_D)
            m = cols < D
            dy = tl.load(dout_ptr + base + cols, mask=m & ok,
                         other=0.0).to(tl.float32)
            y = tl.load(ys_ptr + r * D + cols, mask=m & ok,
                        other=0.0).to(tl.float32)
            tl.store(dys_ptr + r * D + cols,
                     (dy * w).to(dys_ptr.dtype.element_ty), mask=m)
            dot += dy * y
        tl.store(dw_ptr + r, tl.sum(dot, axis=0))

    _TRITON.update(triton=triton, permute=moe_permute_kernel,
                   combine=moe_combine_kernel,
                   combine_bwd=moe_combine_bwd_kernel)
    return _TRITON


def _block(D: int) -> int:
    return min(4096, 1 << max(0, (D - 1).bit_length()))


def _check_rows(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


@torch.library.custom_op("chainermn_torch::moe_permute", mutates_args=())
def _permute_op(x: Tensor, src: Tensor) -> Tensor:
    if x.device.type == "cpu":
        return permute_plain(x, src)
    _check_rows("moe_permute", x, src)
    M, D = src.shape[0], x.shape[1]
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M:
        k = _triton()
        with torch.cuda.device(x.device):
            k["permute"][(M,)](x, src, out, D, BLOCK_D=_block(D),
                               num_warps=4)
        LAUNCHES["moe_permute"] += 1
    return out


@_permute_op.register_fake
def _(x, src):
    return x.new_empty((src.shape[0], x.shape[1]))


@torch.library.custom_op("chainermn_torch::moe_combine", mutates_args=())
def _combine_op(ys: Tensor, pos: Tensor, g: Optional[Tensor]) -> Tensor:
    if ys.device.type == "cpu":
        return combine_plain(ys, pos, g)
    _check_rows("moe_combine", ys, pos, *([g] if g is not None else []))
    (T, K), D = pos.shape, ys.shape[1]
    out = torch.empty((T, D), dtype=ys.dtype, device=ys.device)
    if T:
        k = _triton()
        with torch.cuda.device(ys.device):
            k["combine"][(T,)](ys, pos, g if g is not None else pos, out, D,
                               K=K, HAS_G=g is not None, BLOCK_D=_block(D),
                               num_warps=4)
        LAUNCHES["moe_combine"] += 1
    return out


@_combine_op.register_fake
def _(ys, pos, g):
    return ys.new_empty((pos.shape[0], ys.shape[1]))


@torch.library.custom_op("chainermn_torch::moe_combine_bwd", mutates_args=())
def _combine_bwd_op(dout: Tensor, ys: Tensor, src: Tensor,
                    w: Tensor) -> Tuple[Tensor, Tensor]:
    if ys.device.type == "cpu":
        return combine_bwd_plain(dout, ys, src, w)
    _check_rows("moe_combine_bwd", dout, ys, src, w)
    M, D = ys.shape
    dys = torch.empty_like(ys)
    dw = torch.empty(M, dtype=torch.float32, device=ys.device)
    if M:
        k = _triton()
        with torch.cuda.device(ys.device):
            k["combine_bwd"][(M,)](dout, ys, src, w, dys, dw, D,
                                   BLOCK_D=_block(D), num_warps=4)
        LAUNCHES["moe_combine_bwd"] += 1
    return dys, dw


@_combine_bwd_op.register_fake
def _(dout, ys, src, w):
    return torch.empty_like(ys), ys.new_empty((ys.shape[0],),
                                              dtype=torch.float32)


# ---------------------------------------------------------------------------
# Autograd over the kernels
# ---------------------------------------------------------------------------


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, pos):
        ctx.save_for_backward(pos)
        return torch.ops.chainermn_torch.moe_permute(x.contiguous(), src)

    @staticmethod
    def backward(ctx, dxs):
        (pos,) = ctx.saved_tensors
        dx = torch.ops.chainermn_torch.moe_combine(dxs.contiguous(), pos,
                                                   None)
        return dx, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ys, g, pos, src, assign):
        ys = ys.contiguous()
        g = g.float().contiguous()
        ctx.save_for_backward(ys, g, pos, src, assign)
        return torch.ops.chainermn_torch.moe_combine(ys, pos, g)

    @staticmethod
    def backward(ctx, dout):
        ys, g, pos, src, assign = ctx.saved_tensors
        w = torch.where(assign >= 0, g.reshape(-1)[assign.clamp(min=0)],
                        torch.zeros((), device=g.device))
        dys, dw = torch.ops.chainermn_torch.moe_combine_bwd(
            dout.contiguous(), ys, src, w.contiguous())
        p = pos.long()
        dg = torch.where(p >= 0, dw[p.clamp(min=0)],
                         torch.zeros((), device=dw.device))
        return dys, dg, None, None, None


def permute(x: Tensor, plan: Plan) -> Tensor:
    """(T, D) token rows -> the (M, D) expert-sorted buffer of ``plan``;
    differentiable in ``x``."""
    return _Permute.apply(x, plan.src, plan.pos)


def combine(ys: Tensor, g: Tensor, plan: Plan) -> Tensor:
    """The (M, D) expert outputs -> (T, D): each token's held outputs
    weighted by its gates ``g`` (T, k) and summed; differentiable in ``ys``
    and ``g``."""
    return _Combine.apply(ys, g, plan.pos, plan.src, plan.assign)


# ---------------------------------------------------------------------------
# Grouped products and the gated unit between them
# ---------------------------------------------------------------------------


def grouped_mm_plain(x: Tensor, w: Tensor, offs: Tensor) -> Tensor:
    """``x`` (M, K) rows times their group's ``w`` (G, K, N): group ``g``
    holds rows ``[offs[g-1], offs[g])``; rows past ``offs[-1]`` give 0."""
    M, G = x.shape[0], w.shape[0]
    gid = torch.searchsorted(offs.long(),
                             torch.arange(M, device=x.device), right=True)
    every = torch.einsum("mk,gkn->mgn", x, w)
    idx = gid.clamp(max=G - 1)[:, None, None].expand(M, 1, w.shape[2])
    out = every.gather(1, idx)[:, 0]
    return torch.where((gid < G)[:, None], out, torch.zeros((), dtype=out.dtype))


def grouped_mm(x: Tensor, w: Tensor, offs: Tensor) -> Tensor:
    """One grouped product ``x_g @ w[g]`` for every group of rows (see
    :func:`grouped_mm_plain`); differentiable in both.  On the CPU the
    plain twin; on a card ``torch._grouped_mm`` (its rows past
    ``offs[-1]`` undefined), which takes bf16 operands only: any other
    dtype there is refused, since the twin would compute every expert for
    every row."""
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, offs)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(
            f"grouped_mm on {x.device.type} takes bf16 operands "
            f"(torch._grouped_mm), got {x.dtype} and {w.dtype}: build the "
            "expert layer with dtype=torch.bfloat16")
    return torch._grouped_mm(x, w, offs=offs)


class _SwiGLU(torch.autograd.Function):
    """``silu(a) * b`` keeping only ``a`` and ``b`` for the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return F.silu(a) * b

    @staticmethod
    def backward(ctx, dh):
        a, b = ctx.saved_tensors
        af, dhf = a.float(), dh.float()
        sig = torch.sigmoid(af)
        da = dhf * b.float() * sig * (1.0 + af * (1.0 - sig))
        db = dhf * af * sig
        return da.to(a.dtype), db.to(b.dtype)


def swiglu(a: Tensor, b: Tensor) -> Tensor:
    return _SwiGLU.apply(a, b)


def warm_up(device, d_model: int, k: int, dtype=torch.bfloat16) -> None:
    """Run each kernel once, forward and backward, on a few rows of width
    ``d_model`` with ``k`` choices a token: on a card this compiles the
    Triton kernels before a timed or traced step needs them."""
    dev = torch.device(device)
    T, count = 4, 2
    idx = torch.arange(T * k, device=dev).remainder(count + 1).view(T, k)
    plan = dispatch_plan(idx, 0, count)
    x = torch.randn(T, d_model, device=dev, dtype=dtype, requires_grad=True)
    g = torch.rand(T, k, device=dev, requires_grad=True)
    combine(permute(x, plan), g, plan).float().sum().backward()

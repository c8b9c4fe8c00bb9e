"""Operand rounding of the plain references.

``fp32`` leaves an operand as it is.  ``fp8`` (the control) computes
where the program computes in bf16 in fp8 instead: each operand of a
product, and each activation a layer hands on, is rounded to float8 e4m3
with one scale a tensor (amax / 448), and the gradient that flows back
into an activation is rounded to float8 e5m2 (amax / 57344); parameters
keep fp32 gradients, and every sum and product accumulates in fp32.
"""

from __future__ import annotations

import torch

#: Per precision: (forward dtype and its largest value, the activation
#: gradient's dtype and its largest value); a largest value of None means
#: no scale (bf16 has fp32's range).
_FORMATS = {
    "fp8": ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)),
    "bf16": ((torch.bfloat16, None), (torch.bfloat16, None)),
}
PRECISIONS = ("fp32",) + tuple(_FORMATS)


def _round(x, fmt):
    dtype, top = fmt
    if top is None:
        return x.to(dtype).to(x.dtype)
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision, round_grad):
        ctx.fmt = _FORMATS[precision][1] if round_grad else None
        return _round(x, _FORMATS[precision][0])

    @staticmethod
    def backward(ctx, g):
        if ctx.fmt is not None:
            g = _round(g, ctx.fmt)
        return g, None, None


def operand(x: torch.Tensor, precision: str, weight: bool = False):
    """``x`` as a product's operand, or an activation handed on, at
    ``precision``; ``weight`` keeps its gradient in fp32.  ``bf16``
    mirrors the program's own precision (a witness, not a control)."""
    if precision == "fp32":
        return x
    if precision in _FORMATS:
        return _Round.apply(x, precision, not weight)
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


def no_tf32(torch_mod=torch) -> None:
    """fp32 products in fp32: TF32 off in cuBLAS and cuDNN."""
    torch_mod.backends.cuda.matmul.allow_tf32 = False
    torch_mod.backends.cudnn.allow_tf32 = False

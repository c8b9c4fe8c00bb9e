"""The ``flax.linen`` building blocks of the reference's convnets, with
flax's semantics, for NCHW tensors (the port keeps them in
``channels_last`` memory, cuDNN's fast layout on Hopper).

* :class:`Conv`: ``padding="SAME"`` splits the total padding as XLA does,
  low = total // 2 and high = total - low (a 7x7 stride-2 conv on 224 px
  pads (2, 3), a 3x3 stride-2 conv on an even size (0, 1)); torch's
  symmetric padding gives the same shapes on a shifted grid.  Input,
  kernel and bias are cast to ``dtype`` for the product.
* :func:`max_pool`: ``"SAME"`` pads with -inf on the same split, the
  default ``"VALID"`` does not pad.
* :class:`BatchNorm`: flax 0.12's ``BatchNorm`` over the channel axis.  In
  train mode it normalises with the batch's biased variance (the
  statistics reduced in fp32 by ATen's batch norm, cuDNN's or the CPU's)
  and updates ``running = m * running + (1 - m) * batch`` with that
  biased variance, recovered from the kernel's saved inverse standard
  deviation; ``torch.nn.BatchNorm2d`` would store the unbiased variance
  with the complementary momentum.  In eval mode it uses the running
  statistics.  The output is cast to ``dtype``.
* :class:`Dense`: ``nn.Dense``, input and parameters cast to ``dtype``.
* :func:`dropout`: ``nn.Dropout`` with the mask drawn from an explicit
  ``torch.Generator`` (JAX's masks cannot be reproduced; parity is held
  in eval mode).

Initialisers follow flax's defaults from an explicit ``torch.Generator``:
``lecun_normal`` (a standard normal truncated to [-2, 2], times
sqrt(1 / fan_in) / 0.8796...) for conv and dense kernels, zero biases,
BatchNorm scale 1 (or 0 with ``zero_scale``) and bias 0.  Parameters are
fp32.  :mod:`chainermn_tpu_torch.convert` maps flax's variables onto the
``weight``/``bias``/``running_mean``/``running_var`` names used here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# Standard deviation of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        return weight.mul_(fan_in ** -0.5 / _TRUNC_STD)


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(shape, window, strides, padding):
    """``(symmetric, asymmetric)`` padding of a window op on NCHW
    ``shape``: a symmetric ``SAME`` padding goes to the op itself, any
    other is ``F.pad``'s ``(w_lo, w_hi, h_lo, h_hi)`` (else ``None``)."""
    if padding == "VALID":
        return (0, 0), None
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    (hl, hh), (wl, wh) = (same_pads(shape[2], window[0], strides[0]),
                          same_pads(shape[3], window[1], strides[1]))
    if hl == hh and wl == wh:
        return (hl, wl), None
    return (0, 0), (wl, wh, hl, hh)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """``nn.Conv`` on NCHW: kernel ``(out, in, kh, kw)``."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1, padding: str = "SAME", use_bias: bool = True,
                 dtype=torch.bfloat16, generator: torch.Generator = None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.dtype = dtype
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        lecun_normal_(self.weight, in_features * kh * kw, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        sym, asym = _pads(x.shape, self.kernel_size, self.strides,
                          self.padding)
        if asym is not None:
            x = F.pad(x, asym)
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        # The kernel's cast is its one copy a step, made in the input's
        # layout: a ZeRO-3 parameter is a permuted view of its flat HWIO
        # slice, which the cast also lays out as cuDNN takes it.
        fmt = (torch.channels_last
               if x.is_contiguous(memory_format=torch.channels_last)
               else torch.preserve_format)
        return F.conv2d(x.to(dt), self.weight.to(dt, memory_format=fmt),
                        bias, self.strides, sym)


def max_pool(x, window=3, strides=2, padding: str = "VALID"):
    """``nn.max_pool`` on NCHW (flax's default padding is ``"VALID"``)."""
    window, strides = _pair(window), _pair(strides)
    sym, asym = _pads(x.shape, window, strides, padding)
    if asym is not None:
        x = F.pad(x, asym, value=float("-inf"))
    return F.max_pool2d(x, window, strides, sym)


class Dense(nn.Module):
    """``nn.Dense``: weight ``(out, in)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, generator: torch.Generator = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """``nn.BatchNorm`` over axis 1 with ``momentum`` and ``epsilon`` as
    flax names them; ``forward(x, train)``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = True):
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.epsilon)
            return y.to(self.dtype)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            m = self.momentum
            var = invstd.pow(-2).sub_(self.epsilon).clamp_(min=0.0)
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y.to(self.dtype)


def dropout(x, rate: float, train: bool, generator: torch.Generator = None):
    """``nn.Dropout(rate, deterministic=not train)``: keeps an element with
    probability 1 - rate and scales it by 1 / (1 - rate); the mask comes
    from ``generator`` (on ``x``'s device), which train mode requires."""
    if not train:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator "
                         "(pass rng=...), as flax needs a 'dropout' rng")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))

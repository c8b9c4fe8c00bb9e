"""Plain ResNet in fp32: the reference of the ``convnet_train`` cells.

ResNet v1 with bottleneck blocks (He et al. 2015, Table 1), as the
ImageNet examples of Flax and ChainerMN build it: the stride of a
downsampling block on its 3x3 convolution, a 1x1 projection shortcut
where the shape changes, XLA's ``SAME`` padding (low = total // 2), a
3x3 stride-2 max pool padded with -inf, BatchNorm over (N, H, W) with the
biased batch variance, the global mean, a dense head.  Images come in as
NHWC uint8 and are decoded as x / 127.5 - 1.

BatchNorm in train mode normalises with the batch statistics and keeps
them in ``last_stats`` instead of updating its running buffers: the
caller averages them over the ranks and updates the buffers, as a
data-parallel step with averaged state does.  Module names equal the
port's state-dict keys.  Imports neither JAX nor the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .precision import operand


def same_pads(size: int, window: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class RefConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.stride = stride
        self.precision = "fp32"

    def forward(self, x):
        k = self.weight.shape[-1]
        hl, hh = same_pads(x.shape[2], k, self.stride)
        wl, wh = same_pads(x.shape[3], k, self.stride)
        x = F.pad(x, (wl, wh, hl, hh))
        return operand(F.conv2d(
            operand(x, self.precision),
            operand(self.weight, self.precision, weight=True),
            stride=self.stride), self.precision)


class RefBN(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.last_stats = None
        self.precision = "fp32"

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        self.last_stats = (mean.detach(), var.detach())
        y = (x - mean[None, :, None, None]) * torch.rsqrt(
            var[None, :, None, None] + self.eps)
        return operand(y * self.weight[None, :, None, None]
                       + self.bias[None, :, None, None], self.precision)


class RefDense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.precision = "fp32"

    def forward(self, x):
        return (operand(x, self.precision)
                @ operand(self.weight, self.precision, weight=True).t()
                + self.bias)


class RefBottleneck(nn.Module):
    def __init__(self, c_in: int, filters: int, stride: int, eps: float):
        super().__init__()
        out = filters * 4
        self.Conv_0 = RefConv(c_in, filters, 1)
        self.BatchNorm_0 = RefBN(filters, eps)
        self.Conv_1 = RefConv(filters, filters, 3, stride)
        self.BatchNorm_1 = RefBN(filters, eps)
        self.Conv_2 = RefConv(filters, out, 1)
        self.BatchNorm_2 = RefBN(out, eps)
        self.precision = "fp32"
        self.has_proj = c_in != out or stride != 1
        if self.has_proj:
            self.conv_proj = RefConv(c_in, out, 1, stride)
            self.norm_proj = RefBN(out, eps)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x))
        return operand(F.relu(x + y), self.precision)


class RefResNet(nn.Module):
    def __init__(self, stage_sizes, num_filters: int = 64,
                 classes: int = 1000, bn_eps: float = 1e-5):
        super().__init__()
        self.conv_init = RefConv(3, num_filters, 7, 2)
        self.bn_init = RefBN(num_filters, bn_eps)
        self.block_names = []
        width = num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                name = f"BottleneckBlock_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                setattr(self, name, RefBottleneck(
                    width, filters, 2 if i > 0 and j == 0 else 1, bn_eps))
                self.block_names.append(name)
                width = filters * 4
        self.Dense_0 = RefDense(width, classes)

    def set_precision(self, precision: str) -> None:
        for m in self.modules():
            if hasattr(m, "precision"):
                m.precision = precision

    def forward(self, images):
        """Logits of NHWC images (uint8, decoded here, or already real)."""
        x = images.float()
        if images.dtype == torch.uint8:
            x = x / 127.5 - 1.0
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        hl, hh = same_pads(x.shape[2], 3, 2)
        wl, wh = same_pads(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")),
                         3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))

    def batch_norms(self):
        return {n: m for n, m in self.named_modules() if isinstance(m, RefBN)}

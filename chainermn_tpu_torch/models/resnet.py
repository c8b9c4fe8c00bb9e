"""ResNet family — port of ``chainermn_tpu/models/resnet.py``, the
ImageNet workhorse (ChainerMN's ResNet-50 benchmark model).

The reference takes NHWC images and computes in NHWC; the port takes the
same NHWC images and computes in NCHW tensors held in ``channels_last``
memory (the permute of an NHWC tensor is such a tensor, no copy), with
bf16 convolutions over fp32 parameters, BatchNorm with flax's semantics
(:mod:`.layers`), the global mean over H and W in the compute dtype
(accumulated in fp32, rounded once) and an fp32 ``Dense`` head.  Module
names equal flax's (``conv_init``, ``bn_init``, ``BottleneckBlock_i``
with ``Conv_j``/``BatchNorm_j``/``conv_proj``/``norm_proj``,
``Dense_0``), so :mod:`chainermn_tpu_torch.convert` maps the reference's
variables by name.

``forward(x, train=True)``: in train mode BatchNorm normalises with the
batch statistics and updates its running buffers in place (the flax
``mutable=["batch_stats"]`` update); ``MultiNodeOptimizer
.make_train_step_with_state`` then averages the buffers over the ranks.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .layers import BatchNorm, Conv, Dense, max_pool


class _Block(nn.Module):
    """The residual tail shared by both blocks: the ``conv_proj``/
    ``norm_proj`` shortcut where the shape changes, then ReLU of the sum."""

    def _shortcut(self, in_features, out_features, strides, dtype, gen):
        self.has_proj = in_features != out_features or strides != 1
        if self.has_proj:
            self.conv_proj = Conv(in_features, out_features, 1, strides,
                                  use_bias=False, dtype=dtype, generator=gen)
            self.norm_proj = BatchNorm(out_features, dtype=dtype)

    def _residual(self, x, y, train):
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x), train)
        return F.relu(x + y)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, generator: torch.Generator = None):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, 1, use_bias=False,
                           dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, strides, use_bias=False,
                           dtype=dtype, generator=generator)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, out, 1, use_bias=False, dtype=dtype,
                           generator=generator)
        self.BatchNorm_2 = BatchNorm(out, dtype=dtype, zero_scale=True)
        self._shortcut(in_features, out, strides, dtype, generator)

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        return self._residual(x, y, train)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, generator: torch.Generator = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, strides, use_bias=False,
                           dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, use_bias=False, dtype=dtype,
                           generator=generator)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        self._shortcut(in_features, filters, strides, dtype, generator)

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        return self._residual(x, y, train)


class ResNet(nn.Module):
    """NHWC in, fp32 logits out.  ``dtype=torch.bfloat16`` keeps the
    convolutions' inputs bf16 while parameters and statistics stay fp32.
    Weights come from a ``torch.Generator`` seeded by ``seed``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, use_bias=False,
                              dtype=dtype, generator=gen)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        width = num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                setattr(self, name, block_cls(
                    width, filters, 2 if i > 0 and j == 0 else 1, dtype, gen))
                self.block_names.append(name)
                width = filters * block_cls.expansion
        self.Dense_0 = Dense(width, num_classes, dtype=torch.float32,
                             generator=gen)
        self.to(resolve_device(device), memory_format=torch.channels_last)

    def forward(self, x, train: bool = True):
        x = x.permute(0, 3, 1, 2).to(self.dtype)     # NHWC -> channels_last
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = max_pool(x, 3, 2, "SAME")
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)

"""Classic ImageNet convnets — port of ``chainermn_tpu/models/convnets.py``
(ChainerMN's example zoo: AlexNet, NiN, GoogLeNet).

As in :mod:`.resnet`: NHWC images in, NCHW ``channels_last`` compute, bf16
convolutions over fp32 parameters, fp32 logits out, and module names equal
to flax's so :mod:`chainermn_tpu_torch.convert` maps the reference's
parameters by name.  Convolutions use flax's default ``"SAME"`` padding
(AlexNet's 11x11 stride-4 stem included), pools flax's default
``"VALID"`` unless the reference asks for ``"SAME"``.

AlexNet flattens in the reference's NHWC order: the activations are
permuted to NHWC before the flatten (a view of a ``channels_last``
tensor), so ``Dense_0``'s input rows keep flax's (h, w, c) order and the
conversion is a plain transpose.

``forward(x, train=True, rng=None)``: in train mode dropout draws its
masks from ``rng``, a ``torch.Generator`` on the input's device, which the
caller seeds per rank and per step; flax's masks cannot be reproduced, so
parity with the reference is held in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .layers import Conv, Dense, dropout, max_pool


def _place(module: nn.Module, device) -> None:
    module.to(resolve_device(device), memory_format=torch.channels_last)


def _input(x, dtype):
    return x.permute(0, 3, 1, 2).to(dtype)          # NHWC -> channels_last


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 image_size: int = 224, device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        conv = dict(dtype=dtype, generator=gen)
        self.Conv_0 = Conv(3, 96, 11, 4, **conv)
        self.Conv_1 = Conv(96, 256, 5, **conv)
        self.Conv_2 = Conv(256, 384, 3, **conv)
        self.Conv_3 = Conv(384, 384, 3, **conv)
        self.Conv_4 = Conv(384, 256, 3, **conv)
        # Spatial size after the stem (SAME, /4) and three VALID 3x3/2 pools.
        s = -(-image_size // 4)
        for _ in range(3):
            s = (s - 3) // 2 + 1
        self.Dense_0 = Dense(s * s * 256, 4096, **conv)
        self.Dense_1 = Dense(4096, 4096, **conv)
        self.Dense_2 = Dense(4096, num_classes, dtype=torch.float32,
                             generator=gen)
        _place(self, device)

    def forward(self, x, train: bool = True, rng=None):
        x = _input(x, self.dtype)
        x = max_pool(F.relu(self.Conv_0(x)))
        x = max_pool(F.relu(self.Conv_1(x)))
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = max_pool(F.relu(self.Conv_4(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # (h, w, c)
        x = dropout(F.relu(self.Dense_0(x)), 0.5, train, rng)
        x = dropout(F.relu(self.Dense_1(x)), 0.5, train, rng)
        return self.Dense_2(x)


class NiN(nn.Module):
    """Network-in-Network: mlpconv stacks (conv + two 1x1 convs) and
    global average pooling."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        width = 3
        for name, features, kernel, strides in (
                ("mlp1", 96, 11, 4), ("mlp2", 256, 5, 1), ("mlp3", 384, 3, 1),
                ("mlp4", num_classes, 3, 1)):
            setattr(self, f"{name}_0", Conv(width, features, kernel, strides,
                                            dtype=dtype, generator=gen))
            for i in (1, 2):
                setattr(self, f"{name}_{i}", Conv(features, features, 1,
                                                  dtype=dtype, generator=gen))
            width = features
        _place(self, device)

    def _mlpconv(self, x, name):
        for i in range(3):
            x = F.relu(getattr(self, f"{name}_{i}")(x))
        return x

    def forward(self, x, train: bool = True, rng=None):
        x = _input(x, self.dtype)
        x = max_pool(self._mlpconv(x, "mlp1"))
        x = max_pool(self._mlpconv(x, "mlp2"))
        x = max_pool(self._mlpconv(x, "mlp3"))
        x = dropout(x, 0.5, train, rng)
        x = self._mlpconv(x, "mlp4")
        return x.mean(dim=(2, 3)).float()


class _Inception(nn.Module):
    def __init__(self, in_features, n1, n3r, n3, n5r, n5, pool_proj, dtype,
                 generator):
        super().__init__()
        conv = dict(dtype=dtype, generator=generator)
        self.b1 = Conv(in_features, n1, 1, **conv)
        self.b3r = Conv(in_features, n3r, 1, **conv)
        self.b3 = Conv(n3r, n3, 3, **conv)
        self.b5r = Conv(in_features, n5r, 1, **conv)
        self.b5 = Conv(n5r, n5, 5, **conv)
        self.bp = Conv(in_features, pool_proj, 1, **conv)
        self.out_features = n1 + n3 + n5 + pool_proj

    def forward(self, x):
        b1 = F.relu(self.b1(x))
        b3 = F.relu(self.b3(F.relu(self.b3r(x))))
        b5 = F.relu(self.b5(F.relu(self.b5r(x))))
        bp = F.relu(self.bp(max_pool(x, 3, 1, "SAME")))
        return torch.cat([b1, b3, b5, bp], dim=1)


# GoogLeNet's inception modules: (name, n1, n3r, n3, n5r, n5, pool_proj),
# with a 3x3/2 SAME pool after i3b and i4e.
_INCEPTIONS = (
    ("i3a", 64, 96, 128, 16, 32, 32), ("i3b", 128, 128, 192, 32, 96, 64),
    ("i4a", 192, 96, 208, 16, 48, 64), ("i4b", 160, 112, 224, 24, 64, 64),
    ("i4c", 128, 128, 256, 24, 64, 64), ("i4d", 112, 144, 288, 32, 64, 64),
    ("i4e", 256, 160, 320, 32, 128, 128), ("i5a", 256, 160, 320, 32, 128, 128),
    ("i5b", 384, 192, 384, 48, 128, 128),
)
_POOL_AFTER = ("i3b", "i4e")


class GoogLeNet(nn.Module):
    """GoogLeNet/Inception-v1 without the auxiliary classifiers."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        conv = dict(dtype=dtype, generator=gen)
        self.Conv_0 = Conv(3, 64, 7, 2, **conv)
        self.Conv_1 = Conv(64, 64, 1, **conv)
        self.Conv_2 = Conv(64, 192, 3, **conv)
        width = 192
        for name, *sizes in _INCEPTIONS:
            block = _Inception(width, *sizes, dtype, gen)
            setattr(self, name, block)
            width = block.out_features
        self.Dense_0 = Dense(width, num_classes, dtype=torch.float32,
                             generator=gen)
        _place(self, device)

    def forward(self, x, train: bool = True, rng=None):
        x = _input(x, self.dtype)
        x = max_pool(F.relu(self.Conv_0(x)), 3, 2, "SAME")
        x = F.relu(self.Conv_1(x))
        x = max_pool(F.relu(self.Conv_2(x)), 3, 2, "SAME")
        for name, *_ in _INCEPTIONS:
            x = getattr(self, name)(x)
            if name in _POOL_AFTER:
                x = max_pool(x, 3, 2, "SAME")
        x = dropout(x.mean(dim=(2, 3)), 0.4, train, rng)
        return self.Dense_0(x)

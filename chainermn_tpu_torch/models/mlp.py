"""MLP — the model of the MNIST example, port of
``chainermn_tpu/models/mlp.py``: 784 → ``n_units`` → ``n_units`` →
``n_out`` with ReLU (ChainerMN's example MLP, layers ``l1``..``l3``).

Weights come from a ``torch.Generator`` seeded by ``seed``: each kernel
~ N(0, 1/fan_in), biases zero.  ``convert.mlp_flax_to_state_dict`` loads
the reference's flax parameters instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device


class MLP(nn.Module):
    def __init__(self, n_units: int = 1000, n_out: int = 10, n_in: int = 784,
                 device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.l1 = nn.Linear(n_in, n_units)
        self.l2 = nn.Linear(n_units, n_units)
        self.l3 = nn.Linear(n_units, n_out)
        with torch.no_grad():
            for layer in (self.l1, self.l2, self.l3):
                layer.weight.normal_(0.0, layer.in_features ** -0.5,
                                     generator=gen)
                layer.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.l1(x))
        x = F.relu(self.l2(x))
        return self.l3(x)

"""Vision Transformer — port of ``chainermn_tpu/models/vit.py`` (BASELINE
config #5, ViT-B/16).

Flax's computation, module for module: the image (NHWC, as the reference
takes it) is cast to the compute dtype and patchified by one strided
:class:`~.layers.Conv` (flax's ``SAME`` padding, which is none when the
patch divides the image); the patch grid is read row-major over (H, W),
as ``reshape(B, -1, d)`` reads flax's NHWC output, so the NCHW result is
moved to channels-last first; a zero-initialised fp32 ``cls`` token and
an fp32 ``pos_embed`` (normal, std 0.02) are cast to the compute dtype;
then ``n_layers`` :class:`~.transformer.EncoderLayer` blocks (dense
attention, as the reference's ``EncoderLayer`` without an
``attention_fn``), ``final_norm``, and an fp32 ``head`` on the ``cls``
token.  Parameters are fp32; :mod:`chainermn_tpu_torch.convert` maps
flax's tree onto them (``block_i`` onto ``blocks.i``).

``image_size`` (an int or ``(H, W)``) fixes the ``pos_embed`` length,
which flax takes from the first input.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from .layers import Conv, Dense
from .transformer import EncoderLayer, LayerNorm


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
                 n_layers: int = 12, dtype=torch.bfloat16, image_size=224,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.patch, self.d_model, self.dtype = patch, d_model, dtype
        n_tokens = -(-h // patch) * -(-w // patch) + 1
        self.patchify = Conv(3, d_model, patch, strides=patch, dtype=dtype,
                             generator=gen)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, d_model))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        self.blocks = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dtype, generator=gen)
            for _ in range(n_layers))
        self.final_norm = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, num_classes, dtype=torch.float32,
                          generator=gen)
        self.to(dev)

    def forward(self, x, train: bool = True):
        """``x`` (B, H, W, 3) -> (B, num_classes) fp32 logits.  ``train``
        is accepted for the reference's signature (no dropout)."""
        B = x.shape[0]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.patchify(x.contiguous(memory_format=torch.channels_last))
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.d_model)
        cls = self.cls.to(self.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.final_norm(x)
        return self.head(x[:, 0])


ViT_B16 = ViT  # the defaults are the B/16 configuration

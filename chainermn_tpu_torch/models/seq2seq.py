"""Seq2seq encoder/decoder — port of ``chainermn_tpu/models/seq2seq.py``,
the model-parallel acceptance model (BASELINE config #3): the encoder's
final GRU states are what crosses ranks.

The reference runs flax's ``GRUCell`` under ``nn.RNN``:

    r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h,

where ``ir``, ``iz``, ``in`` and ``hn`` have a bias and ``hr``, ``hz``
do not.  ``torch.nn.GRU`` computes the same recurrence but adds trainable
``b_hr`` and ``b_hz``, which an optimizer would move away from zero.  So
:class:`GRU` keeps flax's parameter set (``weight_ih`` stacks ``ir``,
``iz``, ``in``; ``weight_hh`` stacks ``hr``, ``hz``, ``hn``; ``bias_hn``)
and runs ``nn.GRU``'s kernel (cuDNN on the card, ATen on the CPU) through
``torch.func.functional_call`` with the hidden-side bias built each call
as ``cat(0, 0, bias_hn)``.  Everything is fp32, as the reference's
defaults.  Initialisers follow flax's from a seeded generator: the input
kernels ``lecun_normal``, the recurrent ones orthogonal, biases zero, the
embeddings N(0, 1/D) (parity tests load converted weights instead).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .layers import Dense, lecun_normal_

PAD, BOS, EOS = 0, 1, 2


class GRU(nn.Module):
    """One GRU layer over (B, T, in) with flax ``GRUCell``'s parameters;
    ``forward(x, h0=None)`` returns the (B, T, H) outputs (the last one
    is the final state)."""

    def __init__(self, in_features: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_features))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))
        for w in self.weight_ih.data.chunk(3):
            lecun_normal_(w, in_features, generator)
        with torch.no_grad():
            for w in self.weight_hh.data.chunk(3):
                w.copy_(nn.init.orthogonal_(torch.empty(hidden, hidden),
                                            generator=generator))
        # The kernel's module, outside the parameters: functional_call
        # hands it this layer's tensors each call.
        object.__setattr__(self, "_rnn", nn.GRU(
            in_features, hidden, batch_first=True, device="meta"))

    def forward(self, x, h0=None):
        b = self.bias_hn
        weights = {"weight_ih_l0": self.weight_ih,
                   "weight_hh_l0": self.weight_hh,
                   "bias_ih_l0": self.bias_ih,
                   "bias_hh_l0": torch.cat([b.new_zeros(2 * self.hidden), b])}
        if h0 is None:
            h0 = x.new_zeros(x.shape[0], self.hidden)
        out, _ = torch.func.functional_call(self._rnn, weights,
                                            (x, h0[None].contiguous()))
        return out


class Encoder(nn.Module):
    """(B, S) int tokens -> (n_layers, B, H): each layer's final state."""

    def __init__(self, vocab: int, d_model: int = 256, n_layers: int = 2,
                 device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.embed = _embedding(vocab, d_model, gen)
        self.grus = nn.ModuleList(GRU(d_model, d_model, gen)
                                  for _ in range(n_layers))
        self.to(resolve_device(device))

    def forward(self, src):
        x = F.embedding(src, self.embed.weight)
        finals = []
        for gru in self.grus:
            x = gru(x)
            finals.append(x[:, -1])
        return torch.stack(finals)


class Decoder(nn.Module):
    """Teacher-forced decode: ``hidden`` (n_layers, B, H) from the encoder
    and ``tgt_in`` (B, T) shifted-right targets -> (B, T, vocab) fp32
    logits."""

    def __init__(self, vocab: int, d_model: int = 256, n_layers: int = 2,
                 device="cuda", seed: int = 1):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.embed = _embedding(vocab, d_model, gen)
        self.grus = nn.ModuleList(GRU(d_model, d_model, gen)
                                  for _ in range(n_layers))
        self.proj = Dense(d_model, vocab, dtype=torch.float32, generator=gen)
        self.to(resolve_device(device))

    def forward(self, hidden, tgt_in):
        x = F.embedding(tgt_in, self.embed.weight)
        for i, gru in enumerate(self.grus):
            x = gru(x, hidden[i])
        return self.proj(x)


class Seq2seq(nn.Module):
    """The single-process composition, the oracle the split model must
    match."""

    def __init__(self, vocab: int, d_model: int = 256, n_layers: int = 2,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.encoder = Encoder(vocab, d_model, n_layers, device, seed)
        self.decoder = Decoder(vocab, d_model, n_layers, device, seed + 1)

    def forward(self, src, tgt_in):
        return self.decoder(self.encoder(src), tgt_in)


def _embedding(vocab, d_model, gen):
    emb = nn.Embedding(vocab, d_model)
    with torch.no_grad():
        emb.weight.normal_(0.0, d_model ** -0.5, generator=gen)
    return emb


def shift_right(tgt):
    """Prepend BOS, drop the last token: the teacher-forcing input."""
    return torch.cat([torch.full_like(tgt[:, :1], BOS), tgt[:, :-1]], dim=1)

"""Plain decoder-only LM in fp32: the reference of the ``lm_train`` cells.

A GPT-style pre-norm stack as the configuration states it (GPT-3,
Brown et al. 2020, with the departures its file lists): a tied (V, D)
embedding plus sinusoidal positions; per layer x + attn(LN(x)) and
x + FF(LN(x)) with bias-free projections, causal softmax attention of
scale d_head^-1/2 and a tanh-approximated GELU; a final LayerNorm; the
mean cross-entropy of h E^T against the labels.

Attention is computed in blocks of query rows against the causal prefix
of keys, the loss in blocks of rows, and every layer is recomputed in the
backward (``torch.utils.checkpoint``), so the full model trains in fp32
on one card.  Parameter names equal the port's state-dict keys, so one
set of weights loads into both.  Imports neither JAX nor the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .precision import operand


class _Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))


class _Norm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class _Attention(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.query = _Linear(d_model, d_model)
        self.key = _Linear(d_model, d_model)
        self.value = _Linear(d_model, d_model)
        self.out = _Linear(d_model, d_model)


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi = _Linear(d_model, d_ff)
        self.wo = _Linear(d_ff, d_model)


class _Layer(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.norm_0 = _Norm(d_model)
        self.attention = _Attention(d_model)
        self.norm_1 = _Norm(d_model)
        self.feed_forward = _FeedForward(d_model, d_ff)


def _mm(x, w, precision):
    """x W^T with both operands, and the result, at ``precision``."""
    return operand(operand(x, precision)
                   @ operand(w, precision, weight=True).t(), precision)


def sinusoidal(S: int, d: int, device) -> torch.Tensor:
    """Sinusoidal positions (Vaswani et al. 2017): sin on even features,
    cos on odd ones, wavelengths 2 pi 10000^(2i/d)."""
    pos = torch.arange(S, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(S, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def causal_attention(q, k, v, scale, block, precision):
    """softmax(q k^T scale, causal) v over (B, H, S, d) fp32, ``block``
    query rows at a time against their causal prefix of keys."""
    S = q.shape[2]
    outs = []
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        s = (operand(q[:, :, i0:i1], precision)
             @ operand(k[:, :, :i1], precision).transpose(-1, -2)) * scale
        later = (torch.arange(i1, device=q.device)[None, :]
                 > torch.arange(i0, i1, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
        outs.append(operand(p, precision) @ operand(v[:, :, :i1], precision))
    return operand(torch.cat(outs, dim=2), precision)


class RefLM(nn.Module):
    def __init__(self, vocab: int, d_model: int, n_heads: int, d_ff: int,
                 n_layers: int, ln_eps: float, attn_block: int = 1024,
                 loss_block: int = 4096):
        super().__init__()
        self.embed = nn.Module()
        self.embed.weight = nn.Parameter(torch.empty(vocab, d_model))
        self.layers = nn.ModuleList(_Layer(d_model, d_ff)
                                    for _ in range(n_layers))
        self.final_norm = _Norm(d_model)
        self.n_heads, self.ln_eps = n_heads, ln_eps
        self.attn_block, self.loss_block = attn_block, loss_block
        self.precision = "fp32"

    def set_precision(self, precision: str) -> None:
        self.precision = precision

    def _layer(self, layer, x):
        B, S, D = x.shape
        H, p = self.n_heads, self.precision
        dh = D // H
        h = operand(F.layer_norm(x, (D,), layer.norm_0.weight,
                                 layer.norm_0.bias, self.ln_eps), p)
        a = layer.attention

        def heads(w):
            return _mm(h, w.weight, p).view(B, S, H, dh).transpose(1, 2)

        o = causal_attention(heads(a.query), heads(a.key), heads(a.value),
                             dh ** -0.5, self.attn_block, p)
        x = operand(x + _mm(o.transpose(1, 2).reshape(B, S, D),
                            a.out.weight, p), p)
        h = operand(F.layer_norm(x, (D,), layer.norm_1.weight,
                                 layer.norm_1.bias, self.ln_eps), p)
        f = layer.feed_forward
        g = operand(F.gelu(_mm(h, f.wi.weight, p), approximate="tanh"), p)
        return operand(x + _mm(g, f.wo.weight, p), p)

    def _loss_sum(self, h, labels):
        logits = _mm(h, self.embed.weight, self.precision)
        return F.cross_entropy(logits, labels, reduction="sum")

    def forward(self, tokens, labels):
        """Mean cross-entropy over every token of ``tokens`` (B, S)."""
        B, S = tokens.shape
        D = self.embed.weight.shape[1]
        x = operand(self.embed.weight[tokens]
                    + sinusoidal(S, D, tokens.device), self.precision)
        for layer in self.layers:
            x = checkpoint(self._layer, layer, x, use_reentrant=False)
        x = operand(F.layer_norm(x, (D,), self.final_norm.weight,
                                 self.final_norm.bias, self.ln_eps),
                    self.precision)
        h, lab = x.reshape(B * S, D), labels.reshape(B * S)
        total = 0.0
        for i in range(0, B * S, self.loss_block):
            j = i + self.loss_block
            total = total + checkpoint(self._loss_sum, h[i:j], lab[i:j],
                                       use_reentrant=False)
        return total / (B * S)

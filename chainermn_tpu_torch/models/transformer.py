"""Transformer encoder-decoder and decoder-only LM — the dense training
paths.

Port of ``chainermn_tpu/models/transformer.py`` (``MultiHeadAttention``,
``FeedForward``, ``EncoderLayer``, ``DecoderLayer``, ``Transformer``,
``TransformerLM``).  The numerics copy flax's:

* ``LayerNorm`` epsilon is 1e-6, statistics in fp32, output in the
  compute dtype;
* ``gelu`` is the tanh approximation;
* a layer with ``dtype=torch.bfloat16`` keeps fp32 parameters and casts
  both its input and its parameters to bf16 for the product;
* positions are added in the compute dtype;
* the dense (no ``attention_fn``) mask fills with ``finfo(float32).min``;
* the tied heads (``embed.attend``) run in the compute dtype: flax's
  ``promote_dtype`` casts the fp32 query to the embedding's dtype, so with
  the default bf16 ``Transformer`` returns bf16 logits, as the reference
  computes them (its docstring says fp32).

Parameter layout: every projection is an ``nn.Linear`` (weight
``(out, in)``); :mod:`chainermn_tpu_torch.convert` maps flax's
``DenseGeneral``/``Dense`` kernels onto it.  Initialisation draws from a
``torch.Generator`` seeded by ``seed``: embedding ~ N(0, 1/D), each
projection ~ N(0, 1/fan_in) (flax draws the projections from a truncated
normal; parity tests load converted weights instead).

The decode (KV cache), paged and sequence-parallel modes of the reference
are later slices (ROADMAP A.6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device

_LATER = "is a later slice of the port (ROADMAP A.6)"


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, L, L) lower-triangular boolean mask."""
    return torch.ones(length, length, dtype=torch.bool,
                      device=device).tril()[None, None]


def _dense(x, weight, dtype):
    """Flax ``Dense`` semantics: input and parameter cast to ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype))


def _init_linear(layer: nn.Linear, gen: torch.Generator):
    with torch.no_grad():
        fan_in = layer.weight.shape[1]
        layer.weight.normal_(0.0, fan_in ** -0.5, generator=gen)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: epsilon 1e-6 (torch's default is 1e-5), fp32
    statistics, the result in ``dtype``."""

    EPS = 1e-6

    def __init__(self, d_model: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d_model))
        self.bias = nn.Parameter(torch.zeros(d_model))
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.EPS)
        return y.to(self.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 decode: bool = False, n_kv_heads: Optional[int] = None,
                 paged: Optional[str] = None, sp_axis: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if decode:
            raise NotImplementedError(f"decode (KV cache) {_LATER}")
        if paged is not None:
            raise NotImplementedError(f"paged KV cache {_LATER}")
        if sp_axis is not None:
            raise NotImplementedError(f"sp_axis {_LATER}")
        n_kv = n_kv_heads or n_heads
        if n_heads % n_kv:
            raise ValueError(
                f"n_kv_heads ({n_kv}) must divide n_heads ({n_heads})"
            )
        self.n_heads, self.n_kv = n_heads, n_kv
        self.d_head = d_model // n_heads
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.query = nn.Linear(d_model, n_heads * self.d_head, bias=False)
        self.key = nn.Linear(d_model, n_kv * self.d_head, bias=False)
        self.value = nn.Linear(d_model, n_kv * self.d_head, bias=False)
        self.out = nn.Linear(n_heads * self.d_head, d_model, bias=False)
        if generator is not None:
            for layer in (self.query, self.key, self.value, self.out):
                _init_linear(layer, generator)

    def forward(self, q_in, kv_in, mask=None):
        B, Sq, _ = q_in.shape
        Sk = kv_in.shape[1]
        dt, H, Hk, dh = self.dtype, self.n_heads, self.n_kv, self.d_head
        q = _dense(q_in, self.query.weight, dt).view(B, Sq, H, dh)
        k = _dense(kv_in, self.key.weight, dt).view(B, Sk, Hk, dh)
        v = _dense(kv_in, self.value.weight, dt).view(B, Sk, Hk, dh)
        if self.attention_fn is not None:
            out = self.attention_fn(q, k, v, mask)
        else:
            if Hk != H:
                k = torch.repeat_interleave(k, H // Hk, dim=2)
                v = torch.repeat_interleave(v, H // Hk, dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(dh))
            logits = logits.float()
            if mask is not None:
                logits = torch.where(
                    mask, logits,
                    torch.full_like(logits, torch.finfo(torch.float32).min),
                )
            weights = torch.softmax(logits, dim=-1).to(dt)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return _dense(out.reshape(B, Sq, H * dh), self.out.weight, dt)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)
        if generator is not None:
            _init_linear(self.wi, generator)
            _init_linear(self.wo, generator)

    def forward(self, x):
        h = F.gelu(_dense(x, self.wi.weight, self.dtype), approximate="tanh")
        return _dense(h, self.wo.weight, self.dtype)


class EncoderLayer(nn.Module):
    """Pre-norm block: x + MHA(LN(x)), then x + FF(LN(x))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype=torch.bfloat16, attention_fn=None,
                 n_kv_heads: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_0 = LayerNorm(d_model, dtype)
        self.attention = MultiHeadAttention(
            d_model, n_heads, dtype, attention_fn, n_kv_heads=n_kv_heads,
            generator=generator,
        )
        self.norm_1 = LayerNorm(d_model, dtype)
        self.feed_forward = FeedForward(d_model, d_ff, dtype, generator)

    def forward(self, x, mask=None):
        h = self.norm_0(x)
        x = x + self.attention(h, h, mask)
        return x + self.feed_forward(self.norm_1(x))


class DecoderLayer(nn.Module):
    """Pre-norm block: y + self-MHA(LN(y)), y + cross-MHA(LN(y), enc), then
    y + FF(LN(y)).  Flax names its parts ``LayerNorm_{0,1,2}``,
    ``self_attn``, ``cross_attn`` and ``FeedForward_0``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_0 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype,
                                            generator=generator)
        self.norm_1 = LayerNorm(d_model, dtype)
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dtype,
                                             generator=generator)
        self.norm_2 = LayerNorm(d_model, dtype)
        self.feed_forward = FeedForward(d_model, d_ff, dtype, generator)

    def forward(self, y, enc, self_mask=None, cross_mask=None):
        h = self.norm_0(y)
        y = y + self.self_attn(h, h, self_mask)
        y = y + self.cross_attn(self.norm_1(y), enc, cross_mask)
        return y + self.feed_forward(self.norm_2(y))


class Transformer(nn.Module):
    """Encoder-decoder (WMT shape, BASELINE config #4) with one shared
    ``embed``: it embeds both token streams and is the tied output head.

    ``forward(src, tgt)`` takes (B, S) source and (B, T) target tokens (the
    target shifted right by the caller), with 0 as padding: the encoder
    attends where ``src != 0``, the decoder causally where ``tgt != 0``,
    and the cross-attention where ``src != 0``.  Returns (B, T, vocab)
    logits in the compute dtype (see the module docstring).  ``device``
    defaults to ``"cuda"`` as :class:`TransformerLM`'s does."""

    def __init__(self, vocab: int, d_model: int = 512, n_heads: int = 8,
                 d_ff: int = 2048, n_enc_layers: int = 6,
                 n_dec_layers: int = 6, max_len: int = 512,
                 dtype=torch.bfloat16, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab, self.d_model, self.dtype = vocab, d_model, dtype
        self.embed = nn.Embedding(vocab, d_model)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, d_model ** -0.5, generator=gen)
        self.enc = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dtype, generator=gen)
            for _ in range(n_enc_layers))
        self.enc_norm = LayerNorm(d_model, dtype)
        self.dec = nn.ModuleList(
            DecoderLayer(d_model, n_heads, d_ff, dtype, generator=gen)
            for _ in range(n_dec_layers))
        self.dec_norm = LayerNorm(d_model, dtype)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False,
        )
        self.to(dev)

    def _embed(self, tokens):
        x = F.embedding(tokens, self.embed.weight).to(self.dtype)
        return x + self.pe[:tokens.shape[1]].to(self.dtype)

    def forward(self, src, tgt):
        src_mask = (src != 0)[:, None, None, :]
        x = self._embed(src)
        for layer in self.enc:
            x = layer(x, src_mask)
        x = self.enc_norm(x)
        self_mask = (causal_mask(tgt.shape[1], tgt.device)
                     & (tgt != 0)[:, None, None, :])
        y = self._embed(tgt)
        for layer in self.dec:
            y = layer(y, x, self_mask, src_mask)
        y = self.dec_norm(y)
        return _dense(y.float(), self.embed.weight, self.dtype)


class TransformerLM(nn.Module):
    """Decoder-only LM with a tied embedding head.

    ``device`` defaults to ``"cuda"`` and raises when no CUDA device is
    present; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, vocab: int, d_model: int = 512, n_heads: int = 8,
                 d_ff: int = 2048, n_layers: int = 6, max_len: int = 2048,
                 dtype=torch.bfloat16, attention_fn: Optional[Callable] = None,
                 decode: bool = False, remat: bool = False,
                 n_kv_heads: Optional[int] = None,
                 paged: Optional[str] = None, sp_axis: Optional[str] = None,
                 device="cuda", seed: int = 0):
        super().__init__()
        if decode:
            raise NotImplementedError(f"decode (KV cache) {_LATER}")
        if paged is not None:
            raise NotImplementedError(f"paged KV cache {_LATER}")
        if sp_axis is not None:
            raise NotImplementedError(f"sp_axis {_LATER}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.max_len, self.dtype = max_len, dtype
        self.attention_fn, self.remat = attention_fn, remat
        self.embed = nn.Embedding(vocab, d_model)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, d_model ** -0.5, generator=gen)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dtype, attention_fn,
                         n_kv_heads=n_kv_heads, generator=gen)
            for _ in range(n_layers)
        )
        self.final_norm = LayerNorm(d_model, dtype)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False,
        )
        self.to(dev)

    def _positions(self, position_offset, S: int):
        """The sinusoidal rows added to the embeddings: ``(S, D)`` or, for
        per-sequence positions, ``(B, S, D)``."""
        if position_offset is None:
            return self.pe[:S]
        off = torch.as_tensor(position_offset, device=self.pe.device)
        if off.dim() == 0:
            # The reference's dynamic slice: the start clamps into range.
            start = min(max(int(off), 0), self.pe.shape[0] - S)
            return self.pe[start:start + S]
        return self.pe[off.long()]

    def forward(self, tokens, position_offset=None, return_hidden=False,
                inputs_embeds=None):
        """``tokens`` (B, S) int.

        ``position_offset``: the global position of this shard's first
        token (an int or 0-d tensor) when the sequence is sharded; an
        ``(S,)`` tensor of explicit global positions (the zigzag layout);
        or a ``(B, S)`` tensor of per-sequence positions.  The dense path's
        causal mask is local, so a sharded sequence needs a
        sequence-parallel ``attention_fn`` (ring, Ulysses).

        ``inputs_embeds``: ``(B, S, d_model)`` embeddings replacing the
        table lookup (positions are still added here): the entry point of
        a vocab-sharded embedding, whose table lives outside this module.
        It requires ``return_hidden=True``, since the tied head then has
        no table either.

        ``return_hidden=True`` returns the final-norm hidden states
        (B, S, d_model) — the input of
        :func:`~chainermn_tpu_torch.ops.fused_ce.fused_cross_entropy` —
        instead of the logits ``embed.attend`` gives.  ``remat`` recomputes
        each layer in the backward (``torch.utils.checkpoint``)."""
        S = tokens.shape[1]
        pos = self._positions(position_offset, S)
        if inputs_embeds is None:
            x = F.embedding(tokens, self.embed.weight).to(self.dtype)
        else:
            if not return_hidden:
                raise ValueError(
                    "inputs_embeds requires return_hidden=True: the tied "
                    "embed.attend head has no table when the lookup is "
                    "external (vocab-sharded) — compute the head with "
                    "the same external table"
                )
            x = inputs_embeds.to(self.dtype)
        x = x + (pos if pos.dim() == 3 else pos[None]).to(self.dtype)
        mask = (None if self.attention_fn is not None
                else causal_mask(S, tokens.device))
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, mask, use_reentrant=False)
            else:
                x = layer(x, mask)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return _dense(x, self.embed.weight, self.dtype)

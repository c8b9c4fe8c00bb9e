"""AFMoE: the decoder of Arcee's Trinity models (``model_type`` ``afmoe``).

Per block, with RMSNorms computed in fp32 and a residual stream in fp32::

    h   = x + N_post_attn(Attn(N_in(x)))
    out = h + N_post_mlp(F(N_pre_mlp(h)))

``Attn`` is grouped-query attention with a sigmoid gate on its output:
``q = RMS_head(W_q u)``, ``k = RMS_head(W_k u)``, ``v = W_v u`` (each kv
head shared by ``n_heads / n_kv_heads`` query heads); on a sliding layer
RoPE on q and k and a causal window, on a full layer no positions and a
causal mask; ``Attn(u) = W_o (softmax(q k^T / sqrt(d_head)) v * sigmoid(W_g
u))``, through the hand-written flash kernels
(:func:`~chainermn_tpu_torch.ops.flash_attention`).  ``F`` is a SwiGLU
``W_2 (silu(W_1 u) * W_3 u)`` on the leading ``n_dense_layers`` and a
:class:`~chainermn_tpu_torch.parallel.moe.DroplessMoE` (sigmoid top-k
routing with a selection bias, a shared expert) on the others.  The
embedding is scaled by ``sqrt(d_model)`` (``mup_enabled``); a final
RMSNorm feeds the untied head.  Products run in ``dtype`` over fp32
parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel import moe as _moe
from ..parallel.moe import DroplessMoE, SwiGLUFeedForward

SLIDING, FULL = "sliding_attention", "full_attention"


class _RMSNormFn(torch.autograd.Function):
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, keeping ``x`` and the
    row statistic for the backward."""

    @staticmethod
    def forward(ctx, x, w, eps, out_dtype):
        xf = x.float()
        rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, rstd)
        return (xf * rstd * w.float()).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        xhat = x.float() * rstd
        dyf = dy.float()
        dyw = dyf * w.float()
        dx = rstd * (dyw - xhat * (dyw * xhat).mean(-1, keepdim=True))
        dw = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x, out_dtype=torch.float32):
        return _RMSNormFn.apply(x, self.weight, self.eps, out_dtype)


def rope_tables(S: int, d: int, theta: float, device):
    """(cos, sin), each (S, d) fp32: the angle ``p theta^(-2i/d)`` of
    position ``p`` and frequency ``i``, repeated over both halves."""
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=device) / d)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


class _RopeFn(torch.autograd.Function):
    """RoPE on (B, S, H, d) in fp32, the result in the input's dtype; the
    backward rotates back by the same tables."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        dyf = dy.float()
        a, b = (dyf * sin).chunk(2, dim=-1)
        return (dyf * cos + torch.cat([b, -a], dim=-1)).to(dy.dtype), \
            None, None


class GatedAttention(nn.Module):
    """Gated grouped-query attention of one AFMoE block (see the module
    docstring); ``window`` None is a full layer, else a sliding one."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 d_head: int, window: Optional[int], eps: float,
                 dtype=torch.bfloat16):
        super().__init__()
        if n_heads % n_kv_heads:
            raise ValueError(f"n_kv_heads ({n_kv_heads}) must divide "
                             f"n_heads ({n_heads})")
        self.n_heads, self.n_kv, self.d_head = n_heads, n_kv_heads, d_head
        self.window, self.dtype = window, dtype
        self.query = nn.Linear(d_model, n_heads * d_head, bias=False)
        self.key = nn.Linear(d_model, n_kv_heads * d_head, bias=False)
        self.value = nn.Linear(d_model, n_kv_heads * d_head, bias=False)
        self.gate = nn.Linear(d_model, n_heads * d_head, bias=False)
        self.out = nn.Linear(n_heads * d_head, d_model, bias=False)
        self.q_norm = RMSNorm(d_head, eps)
        self.k_norm = RMSNorm(d_head, eps)

    def forward(self, u, rope=None):
        B, S, _ = u.shape
        dt, H, Hk, dh = self.dtype, self.n_heads, self.n_kv, self.d_head

        def proj(lin):
            return F.linear(u, lin.weight.to(dt))

        q = self.q_norm(proj(self.query).view(B, S, H, dh), dt)
        k = self.k_norm(proj(self.key).view(B, S, Hk, dh), dt)
        v = proj(self.value).view(B, S, Hk, dh)
        if self.window is not None:
            cos, sin = (t[:, None] for t in rope)
            q, k = _RopeFn.apply(q, cos, sin), _RopeFn.apply(k, cos, sin)
        a = flash_attention(q, k, v, causal=True, window=self.window)
        o = a.reshape(B, S, H * dh) * torch.sigmoid(proj(self.gate))
        return F.linear(o, self.out.weight.to(dt))


class AFMoEBlock(nn.Module):
    def __init__(self, attention: GatedAttention, mlp: nn.Module, d: int,
                 eps: float):
        super().__init__()
        self.input_norm = RMSNorm(d, eps)
        self.attention = attention
        self.post_attention_norm = RMSNorm(d, eps)
        self.pre_mlp_norm = RMSNorm(d, eps)
        self.mlp = mlp
        self.post_mlp_norm = RMSNorm(d, eps)

    def forward(self, x, rope):
        dt = self.attention.dtype
        h = x + self.post_attention_norm(
            self.attention(self.input_norm(x, dt), rope))
        return h + self.post_mlp_norm(self.mlp(self.pre_mlp_norm(h, dt)))


class AFMoELM(nn.Module):
    """The AFMoE decoder LM holding experts ``[first_expert, first_expert +
    held_experts)`` of each expert layer (all of them by default).

    ``layer_types``: one of ``"sliding_attention"`` / ``"full_attention"``
    a layer (the published list's first ``n_layers``).  The expert layers
    update their selection bias once per optimizer step after
    :meth:`register_bias_update`.  ``comm`` of more than one rank is
    refused by the expert layers (no exchange between ranks).
    ``device`` defaults to ``"cuda"``; the weights are drawn there from
    ``seed``: every matrix N(0, 1/fan_in), norm scales 1, biases 0."""

    def __init__(self, vocab: int, d_model: int, n_layers: int,
                 n_heads: int, n_kv_heads: int, d_head: int, d_ff: int,
                 d_expert: int, n_experts: int, top_k: int,
                 n_dense_layers: int, layer_types: Sequence[str],
                 window: int, rope_theta: float = 10000.0,
                 norm_eps: float = 1e-5, route_scale: float = 1.0,
                 n_shared: int = 1, bias_rate: float = 1e-3,
                 first_expert: int = 0, held_experts: Optional[int] = None,
                 dtype=torch.bfloat16, comm=None, device="cuda",
                 seed: int = 0):
        super().__init__()
        types = list(layer_types)[:n_layers]
        if len(types) != n_layers or set(types) - {SLIDING, FULL}:
            raise ValueError(f"layer_types must give {n_layers} of "
                             f"{SLIDING!r} / {FULL!r}")
        dev = resolve_device(device)
        self.vocab, self.d_model, self.d_head = vocab, d_model, d_head
        self.layer_types, self.rope_theta = types, rope_theta
        self.dtype = dtype
        self.embed_scale = math.sqrt(d_model)
        with torch.device(dev):
            self.embed = nn.Embedding(vocab, d_model)
            self.layers = nn.ModuleList()
            for i, kind in enumerate(types):
                attn = GatedAttention(d_model, n_heads, n_kv_heads, d_head,
                                      window if kind == SLIDING else None,
                                      norm_eps, dtype)
                mlp = (SwiGLUFeedForward(d_model, d_ff, dtype)
                       if i < n_dense_layers else
                       DroplessMoE(d_model, d_expert, n_experts, top_k,
                                   first=first_expert, count=held_experts,
                                   route_scale=route_scale,
                                   n_shared=n_shared, bias_rate=bias_rate,
                                   dtype=dtype, comm=comm))
                self.layers.append(AFMoEBlock(attn, mlp, d_model, norm_eps))
            self.final_norm = RMSNorm(d_model, norm_eps)
            self.head = nn.Linear(d_model, vocab, bias=False)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        if self.device.type == "meta":
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
            else:
                p.fill_(1.0)
        for name, b in self.named_buffers():
            b.zero_()

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def moe_layers(self):
        return _moe.moe_layers(self)

    def register_bias_update(self, optimizer):
        """Move the expert layers' selection biases before each
        ``optimizer.step()``; returns the hook's handle."""
        return _moe.register_bias_update(self, optimizer)

    def forward(self, tokens, return_hidden: bool = False):
        """``tokens`` (B, S) int -> logits (B, S, vocab) in ``dtype``, or
        with ``return_hidden`` the final-norm hidden states (B, S,
        d_model), the input of ``fused_cross_entropy`` with
        ``head.weight``."""
        S = tokens.shape[1]
        x = F.embedding(tokens, self.embed.weight) * self.embed_scale
        rope = None
        if SLIDING in self.layer_types:
            rope = rope_tables(S, self.d_head, self.rope_theta, tokens.device)
        for layer in self.layers:
            x = layer(x, rope)
        h = self.final_norm(x, self.dtype)
        if return_hidden:
            return h
        return F.linear(h, self.head.weight.to(self.dtype))

"""Plain AFMoE decoder in fp32 (Arcee's Trinity): the reference of the
``afmoe_train`` cells and of the port's CPU tests.

Per block, with every RMSNorm ``x rsqrt(mean(x^2) + eps) w``::

    h   = x + N_post_attn(Attn(N_in(x)))
    out = h + N_post_mlp(F(N_pre_mlp(h)))

``Attn(u) = W_o (softmax(q k^T / sqrt(d_head), mask) v * sigmoid(W_g u))``
with ``q = RMS_head(W_q u)``, ``k = RMS_head(W_k u)``, ``v = W_v u``, kv
head ``h // G`` serving query head ``h``; a sliding layer rotates q and k
(RoPE, angle ``p theta^(-2i/d)`` over both halves) and masks keys more
than ``window - 1`` before the query; a full layer is causal, without
positions.  ``F`` is ``W_2 (silu(W_1 u) * W_3 u)`` on the leading dense
layers; on an expert layer ``s = sigmoid(W_r u)`` over every expert, each
token's ``top_k`` by ``s + expert_bias``, gates ``route_scale s_i / sum
s_I``, and ``F(u) = sum_{i in I, held} g_i SwiGLU_i(u) + SwiGLU_shared(u)``,
each held expert looping over its tokens.  The embedding is scaled by
``embed_scale``; a final RMSNorm feeds the untied head.

Attention is computed in blocks of query rows against their live keys,
the loss in blocks of rows, and every layer is recomputed in the backward
(``torch.utils.checkpoint``).  Each forward counts every expert's
assignments (not the recomputations); :meth:`RefTrinity.update_bias`
then moves the selection bias by ``bias_rate sign(mean - count)``.
Parameter names equal the port's state-dict keys.  Imports neither JAX
nor the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .precision import operand

SLIDING = "sliding_attention"


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


class _Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = _param(d_out, d_in)


class _Norm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class _Attention(nn.Module):
    def __init__(self, d, H, Hk, dh):
        super().__init__()
        self.query = _Linear(d, H * dh)
        self.key = _Linear(d, Hk * dh)
        self.value = _Linear(d, Hk * dh)
        self.gate = _Linear(d, H * dh)
        self.out = _Linear(H * dh, d)
        self.q_norm = _Norm(dh)
        self.k_norm = _Norm(dh)


class _SwiGLU(nn.Module):
    def __init__(self, d, f):
        super().__init__()
        self.gate = _Linear(d, f)
        self.up = _Linear(d, f)
        self.down = _Linear(f, d)


class _Experts(nn.Module):
    def __init__(self, d, f, n_experts, count, n_shared):
        super().__init__()
        self.router = _Linear(d, n_experts)
        self.register_buffer("expert_bias", torch.zeros(n_experts))
        self.experts_gate = _param(count * f, d)
        self.experts_up = _param(count * f, d)
        self.experts_down = _param(count * d, f)
        self.shared = _SwiGLU(d, n_shared * f)
        self.counts = torch.zeros(n_experts, dtype=torch.float64)


class _Block(nn.Module):
    def __init__(self, d, H, Hk, dh, mlp):
        super().__init__()
        self.input_norm = _Norm(d)
        self.attention = _Attention(d, H, Hk, dh)
        self.post_attention_norm = _Norm(d)
        self.pre_mlp_norm = _Norm(d)
        self.mlp = mlp
        self.post_mlp_norm = _Norm(d)


def _mm(x, w, precision):
    """x W^T with both operands, and the result, at ``precision``."""
    return operand(operand(x, precision)
                   @ operand(w, precision, weight=True).t(), precision)


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """RoPE over (B, H, S, d)."""
    S, d = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    a, b = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-b, a], dim=-1) * sin


def masked_attention(q, k, v, scale, window, block, precision):
    """softmax(q k^T scale, causal and the window) v over (B, H, S, d),
    ``block`` query rows at a time against their live keys."""
    S = q.shape[2]
    outs = []
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        j0 = 0 if window is None else max(0, i0 - window + 1)
        s = (operand(q[:, :, i0:i1], precision)
             @ operand(k[:, :, j0:i1], precision).transpose(-1, -2)) * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(j0, i1, device=q.device)[None, :]
        dead = kj > qi
        if window is not None:
            dead = dead | (qi - kj >= window)
        p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
        outs.append(operand(p, precision)
                    @ operand(v[:, :, j0:i1], precision))
    return operand(torch.cat(outs, dim=2), precision)


class RefTrinity(nn.Module):
    def __init__(self, vocab: int, d_model: int, n_layers: int, n_heads: int,
                 n_kv_heads: int, d_head: int, d_ff: int, d_expert: int,
                 n_experts: int, held: int, first: int, top_k: int,
                 n_dense_layers: int, layer_types, window: int,
                 rope_theta: float, eps: float, route_scale: float,
                 bias_rate: float, n_shared: int, embed_scale: float,
                 attn_block: int = 512, loss_block: int = 4096):
        super().__init__()
        self.embed = nn.Module()
        self.embed.weight = _param(vocab, d_model)
        blocks = []
        for i in range(n_layers):
            mlp = (_SwiGLU(d_model, d_ff) if i < n_dense_layers else
                   _Experts(d_model, d_expert, n_experts, held, n_shared))
            blocks.append(_Block(d_model, n_heads, n_kv_heads, d_head, mlp))
        self.layers = nn.ModuleList(blocks)
        self.final_norm = _Norm(d_model)
        self.head = _Linear(d_model, vocab)
        self.types = list(layer_types)[:n_layers]
        self.H, self.Hk, self.dh = n_heads, n_kv_heads, d_head
        self.d_expert, self.first, self.held = d_expert, first, held
        self.top_k, self.window, self.theta = top_k, window, rope_theta
        self.eps, self.route_scale = eps, route_scale
        self.bias_rate, self.embed_scale = bias_rate, embed_scale
        self.attn_block, self.loss_block = attn_block, loss_block
        self.precision = "fp32"
        self.counting = False

    def set_precision(self, precision: str) -> None:
        self.precision = precision

    # -- the blocks ----------------------------------------------------------

    def _attention(self, a, u, sliding):
        B, S, _ = u.shape
        H, Hk, dh, p = self.H, self.Hk, self.dh, self.precision

        def heads(w, n):
            return _mm(u, w.weight, p).view(B, S, n, dh).transpose(1, 2)

        q = operand(rms(heads(a.query, H), a.q_norm.weight, self.eps), p)
        k = operand(rms(heads(a.key, Hk), a.k_norm.weight, self.eps), p)
        v = heads(a.value, Hk)
        if sliding:
            q, k = operand(rope(q, self.theta), p), operand(rope(k, self.theta),
                                                           p)
        g = H // Hk
        o = masked_attention(q, k.repeat_interleave(g, dim=1),
                             v.repeat_interleave(g, dim=1), dh ** -0.5,
                             self.window if sliding else None,
                             self.attn_block, p)
        o = o.transpose(1, 2).reshape(B, S, H * dh)
        o = operand(o * torch.sigmoid(_mm(u, a.gate.weight, p)), p)
        return _mm(o, a.out.weight, p)

    def _swiglu(self, f, u):
        p = self.precision
        h = operand(F.silu(_mm(u, f.gate.weight, p)) * _mm(u, f.up.weight, p),
                    p)
        return _mm(h, f.down.weight, p)

    def route(self, m, x):
        """Each token's ``top_k`` experts (T, k) and gates (T, k)."""
        s = torch.sigmoid(operand(x, self.precision) @ m.router.weight.t())
        idx = torch.topk(s.detach() + m.expert_bias, self.top_k,
                         dim=-1).indices
        chosen = s.gather(1, idx)
        return idx, self.route_scale * chosen / chosen.sum(-1, keepdim=True)

    def _experts(self, m, u):
        B, S, D = u.shape
        x = u.reshape(B * S, D)
        idx, g = self.route(m, x)
        if self.counting:
            m.counts = m.counts.to(idx.device) + torch.bincount(
                idx.reshape(-1), minlength=m.counts.numel()).double()
        p, f = self.precision, self.d_expert
        out = torch.zeros_like(x)
        for e in range(self.held):
            tok, slot = (idx == self.first + e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            h = operand(F.silu(_mm(xe, m.experts_gate[e * f:(e + 1) * f], p))
                        * _mm(xe, m.experts_up[e * f:(e + 1) * f], p), p)
            ye = _mm(h, m.experts_down[e * D:(e + 1) * D], p)
            out = out.index_add(0, tok, ye * g[tok, slot][:, None])
        out = operand(out, p) + self._swiglu(m.shared, x)
        return out.view(B, S, D)

    def _layer(self, i, x):
        blk, p = self.layers[i], self.precision
        u = operand(rms(x, blk.input_norm.weight, self.eps), p)
        a = self._attention(blk.attention, u, self.types[i] == SLIDING)
        h = x + rms(a, blk.post_attention_norm.weight, self.eps)
        u = operand(rms(h, blk.pre_mlp_norm.weight, self.eps), p)
        f = (self._experts(blk.mlp, u) if isinstance(blk.mlp, _Experts)
             else self._swiglu(blk.mlp, u))
        return h + rms(f, blk.post_mlp_norm.weight, self.eps)

    def _loss_sum(self, h, labels):
        logits = _mm(h, self.head.weight, self.precision)
        return F.cross_entropy(logits, labels, reduction="sum")

    def forward(self, tokens, labels):
        """Mean cross-entropy over every token of ``tokens`` (B, S)."""
        B, S = tokens.shape
        D = self.embed.weight.shape[1]
        x = self.embed.weight[tokens] * self.embed_scale
        self.counting = torch.is_grad_enabled()
        try:
            for i in range(len(self.layers)):
                x = checkpoint(self._layer, i, x, use_reentrant=False)
        finally:
            self.counting = False
        x = operand(rms(x, self.final_norm.weight, self.eps), self.precision)
        h, lab = x.reshape(B * S, D), labels.reshape(B * S)
        total = 0.0
        for i in range(0, B * S, self.loss_block):
            j = i + self.loss_block
            total = total + checkpoint(self._loss_sum, h[i:j], lab[i:j],
                                       use_reentrant=False)
        return total / (B * S)

    @torch.no_grad()
    def update_bias(self):
        """``expert_bias += bias_rate sign(mean(counts) - counts)`` in every
        expert layer; the counts start again from zero."""
        for blk in self.layers:
            m = blk.mlp
            if isinstance(m, _Experts):
                c = m.counts
                m.expert_bias += self.bias_rate * torch.sign(
                    c.mean() - c).to(m.expert_bias)
                m.counts = torch.zeros_like(c)

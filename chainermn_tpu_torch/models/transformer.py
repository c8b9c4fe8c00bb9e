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

The cache modes (the reference's flax ``cache`` collection):

* ``decode=True`` — the dense KV cache of :func:`generate`: one token a
  call, written at the running index of a :class:`DenseLayerCache`;
* ``paged="prefill" | "decode" | "chunk"`` — the serving engine's paged KV
  cache, one :class:`PagedLayerCache` of pages a layer, routed through
  ``block_tables``/``seq_lens`` (:mod:`~chainermn_tpu_torch.ops.decode_attention`);
  ``kv_dtype="int8"`` pages carry fp32 scales and each write records its
  round-trip error (the reference's sown ``kv_quant_err``).

Flax keeps the cache in a mutable collection of the module; here the
caller owns the caches (:meth:`TransformerLM.init_paged_cache`,
:meth:`TransformerLM.init_decode_cache`) and passes them to ``forward``,
which updates them in place.  The reference builds a prefill, a decode and
a chunk twin over one parameter tree; here ``forward(..., paged=mode)``
picks the mode per call over the module's own parameters.

Sequence-parallel chunk prefill (``sp_axis``, ``paged="chunk"`` only):
each rank holds C consecutive tokens of one slice; K and V are gathered
to the whole slice (:func:`~chainermn_tpu_torch.parallel.ring_attention.gather_sequence_kv`,
a pure concatenation, so every rank writes the pages the unsharded chunk
writes) and the local queries attend at their global causal bounds.
``sp_axis`` is a communicator (anything with ``rank`` and ``allgather``)
or the name of a dimension of the ``DeviceMesh`` passed as ``mesh=``,
where the reference names a ``shard_map`` axis.

Tensor parallelism: with DTensor parameters (a serving engine under a
sharding plan) the attention core — the page writes, the paged or dense
attention — runs on each rank's local heads through ``local_map``
(:func:`~chainermn_tpu_torch.parallel.sharding.on_local_heads`), over
pages whose KV-head axis is sharded the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import check_model_device, resolve_device
from ..communicators.quant import dequantize_kv, quantize_kv
from ..parallel.ring_attention import gather_sequence_kv
from ..ops.decode_attention import (
    _scale,
    paged_attention_chunk,
    paged_attention_decode,
    write_chunk_pages,
    write_prompt_pages,
    write_token_pages,
)

PAGED_MODES = ("prefill", "decode", "chunk")


@dataclasses.dataclass
class PagedLayerCache:
    """One layer's KV pages: ``k_pages``/``v_pages`` (N, page_size, Hkv,
    D) in the compute dtype, or int8 with ``k_scales``/``v_scales`` (N,
    page_size, Hkv) fp32.  A quantised write sets ``kv_quant_err`` (a 0-d
    fp32 tensor, the max round-trip error of that write)."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    kv_quant_err: Optional[torch.Tensor] = None

    LEAVES = ("k_pages", "v_pages", "k_scales", "v_scales")

    @classmethod
    def zeros(cls, page_count: int, page_size: int, n_kv: int, d_head: int,
              dtype, kv_dtype: Optional[str] = None, device=None):
        if page_count <= 0 or page_size <= 0:
            raise ValueError("paged modes require page_count > 0 and "
                             "page_size > 0")
        _check_kv_dtype(kv_dtype)
        shape = (page_count, page_size, n_kv, d_head)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        if not kv_dtype:
            return cls(zeros(shape, dtype), zeros(shape, dtype))
        return cls(zeros(shape, torch.int8), zeros(shape, torch.int8),
                   zeros(shape[:3], torch.float32),
                   zeros(shape[:3], torch.float32))

    def leaves(self) -> dict:
        """The page tensors by the reference's leaf names (every one is
        indexed by page along dim 0)."""
        return {n: getattr(self, n) for n in self.LEAVES
                if getattr(self, n) is not None}


@dataclasses.dataclass
class DenseLayerCache:
    """One layer's dense KV cache (``decode=True``): (B, cache_len, Hkv,
    D) keys and values and the running write index."""

    cached_key: torch.Tensor
    cached_value: torch.Tensor
    cache_index: int = 0


def _check_kv_dtype(kv_dtype):
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")


def _check_modes(decode, paged, attention_fn, sp_axis):
    """The reference's refusals of the cache modes (construction and
    per-call overrides alike)."""
    if sp_axis is not None and paged != "chunk":
        raise ValueError(
            "sp_axis shards the multi-token chunk step only; decode is "
            "per-token (nothing to shard) and whole-prompt prefill should "
            "use the chunk path when sequence-sharded")
    if paged is None:
        if decode and attention_fn is not None:
            raise ValueError(
                "decode=True is incompatible with attention_fn: the "
                "pluggable adapters impose their own causality and ignore "
                "the cache mask; build the model without attention_fn "
                "for generate()"
            )
        return
    if decode:
        raise ValueError(
            "paged and decode are mutually exclusive KV cache modes: the "
            "dense cache keeps one index for the whole batch, pages keep "
            "per-sequence lengths"
        )
    if attention_fn is not None:
        raise ValueError(
            "paged modes are incompatible with attention_fn: the pluggable "
            "adapters ignore the cache mask and would attend to the wrong "
            "page slots"
        )
    if paged not in PAGED_MODES:
        raise ValueError(
            f"paged must be 'prefill', 'decode' or 'chunk', got {paged!r}")


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
    #: The weights whose dimension packs whole heads of ``d_head`` rows, and
    #: that dimension: what ``sharding.validate`` holds a head-sharding
    #: plan to (query and kv head counts both divisible by the axis).
    HEAD_DIMS = {"query.weight": 0, "key.weight": 0, "value.weight": 0,
                 "out.weight": 1}

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 decode: bool = False, n_kv_heads: Optional[int] = None,
                 paged: Optional[str] = None, sp_axis: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_modes(decode, paged, attention_fn, sp_axis)
        self.decode, self.paged, self.sp_axis = decode, paged, sp_axis
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

    def forward(self, q_in, kv_in, mask=None, *, cache=None,
                block_tables=None, seq_lens=None, paged=None, decode=None,
                sp_axis=None, mesh=None):
        """``cache``: this layer's :class:`PagedLayerCache` (paged modes) or
        :class:`DenseLayerCache` (``decode``), updated in place.
        ``paged``/``decode`` override the constructor's mode for this call
        (a cache mode attends densely, ignoring ``attention_fn``);
        ``block_tables``/``seq_lens`` route the paged modes (see
        :mod:`~chainermn_tpu_torch.ops.decode_attention`): ``seq_lens`` is
        the valid prompt length for ``prefill``, the context length before
        the token for ``decode``, and each row's start position for
        ``chunk``.  ``sp_axis`` (a communicator, or a dimension of
        ``mesh``) shards a chunk's tokens over ranks (overriding the
        constructor's)."""
        paged = self.paged if paged is None else paged
        decode = self.decode if decode is None else decode
        sp_axis = self.sp_axis if sp_axis is None else sp_axis
        cached = paged is not None or decode
        if cached:
            # A cache mode runs the dense path, as the reference's twins
            # (built without attention_fn) do.
            _check_modes(decode, paged, None,
                         sp_axis if paged == "chunk" else None)
        attention_fn = None if cached else self.attention_fn
        B, Sq, _ = q_in.shape
        Sk = kv_in.shape[1]
        dt, H, Hk, dh = self.dtype, self.n_heads, self.n_kv, self.d_head
        q = _dense(q_in, self.query.weight, dt).view(B, Sq, H, dh)
        k = _dense(kv_in, self.key.weight, dt).view(B, Sk, Hk, dh)
        v = _dense(kv_in, self.value.weight, dt).view(B, Sk, Hk, dh)
        if paged is not None:
            if cache is None or block_tables is None or seq_lens is None:
                raise ValueError("paged modes require a cache, block_tables "
                                 "and seq_lens")
            sp = (_sp_comm(sp_axis, mesh)
                  if paged == "chunk" and sp_axis is not None else None)
            leaves = cache.leaves()
            names = [n for n in leaves if n.endswith("_pages")]
            scales = [n for n in leaves if n.endswith("_scales")]
            heads = _head_comm(q)

            def core(q, k, v, *tensors):
                c = dataclasses.replace(cache, **dict(zip(names + scales,
                                                          tensors)))
                out = self._paged(paged, q, k, v, mask, c, block_tables,
                                  seq_lens, sp, heads)
                cache.kv_quant_err = c.kv_quant_err
                return out

            out = self._local(core, q, k, v, [leaves[n] for n in names],
                              [leaves[n] for n in scales])
        else:
            if decode:
                k, v, mask = self._dense_cache(q, k, v, cache)
            if attention_fn is not None:
                out = attention_fn(q, k, v, mask)
            else:
                out = self._local(lambda q, k, v: _attend(q, k, v, mask),
                                  q, k, v)
        return _dense(out.reshape(B, Sq, H * dh), self.out.weight, dt)

    @staticmethod
    def _local(fn, q, k, v, tensors=(), whole=()):
        """``fn(q, k, v, *tensors, *whole)``, on each rank's local heads
        when ``q`` is a DTensor (``tensors`` shard their heads on dim 2
        as ``q`` does; ``whole`` are replicated)."""
        if type(q) is torch.Tensor:
            return fn(q, k, v, *tensors, *whole)
        from ..parallel.sharding import on_local_heads

        return on_local_heads(fn, q, k, v, *tensors, whole=whole)

    def _paged(self, mode, q, k, v, mask, cache, block_tables, seq_lens,
               sp=None, heads=None):
        """Write this call's K/V into the pages and attend: ``prefill``
        over the local K/V with the dense causal mask (the prompt is the
        whole context, still in full precision), ``decode`` and ``chunk``
        over the pages.  ``sp`` shards a chunk's tokens (see the module
        docstring).  ``heads`` (tensor parallelism): the group over which
        this rank's KV heads are one slice of every head; int8 scales are
        kept whole and equal on every rank (the reference's replicated
        ``k_scales``/``v_scales``), so each write gathers every rank's
        scales and the attention reads this rank's slice of them."""
        quant = cache.k_scales is not None

        def write_kv(writer, lens):
            if not quant:
                writer(cache.k_pages, k, block_tables, lens)
                writer(cache.v_pages, v, block_tables, lens)
                return
            qk, k_sc = quantize_kv(k)
            qv, v_sc = quantize_kv(v)
            err = torch.maximum(
                (dequantize_kv(qk, k_sc, torch.float32) - k.float())
                .abs().amax(),
                (dequantize_kv(qv, v_sc, torch.float32) - v.float())
                .abs().amax(),
            )
            if heads is not None:
                k_sc = heads.allgather(k_sc, axis=-1, tiled=True)
                v_sc = heads.allgather(v_sc, axis=-1, tiled=True)
                err = heads.allreduce(err, "max")
            writer(cache.k_pages, qk, block_tables, lens)
            writer(cache.v_pages, qv, block_tables, lens)
            writer(cache.k_scales, k_sc, block_tables, lens)
            writer(cache.v_scales, v_sc, block_tables, lens)
            cache.kv_quant_err = err

        scales = dict(k_scales=cache.k_scales, v_scales=cache.v_scales)
        if quant and heads is not None:
            h0 = heads.rank * k.shape[2]
            scales = {n: t[:, :, h0:h0 + k.shape[2]]
                      for n, t in scales.items()}
        if mode == "prefill":
            write_kv(write_prompt_pages, seq_lens)
            return _attend(q, k, v, mask)
        if mode == "chunk":
            attn_start = seq_lens
            if sp is not None:
                C = q.shape[1]
                k, v = gather_sequence_kv(k, v, sp)
                # Padding rows (seq_lens < 0) stay masked on every rank.
                lens = torch.as_tensor(seq_lens)
                attn_start = torch.where(lens >= 0, lens + sp.rank * C, lens)
            write_kv(write_chunk_pages, seq_lens)
            return paged_attention_chunk(q, cache.k_pages, cache.v_pages,
                                         block_tables, attn_start, **scales)
        if q.shape[1] != 1:
            raise ValueError(
                f"paged decode consumes exactly one token per call, got a "
                f"length-{q.shape[1]} chunk"
            )
        write_kv(write_token_pages, seq_lens)
        return paged_attention_decode(q, cache.k_pages, cache.v_pages,
                                      block_tables,
                                      torch.as_tensor(seq_lens) + 1,
                                      **scales)

    def _dense_cache(self, q, k, v, cache):
        """``decode=True``: write the token at the running index and return
        the whole cache with the positions past it masked."""
        if cache is None:
            raise ValueError("decode=True requires a DenseLayerCache")
        if q.shape[1] != 1:
            raise ValueError(
                f"decode mode consumes exactly one token per call, got a "
                f"length-{q.shape[1]} chunk; feed tokens one at a time, as "
                f"generate() does"
            )
        ck, cv = cache.cached_key, cache.cached_value
        L = ck.shape[1]
        i = cache.cache_index
        at = min(max(i, 0), L - 1)      # the reference's dynamic_update_slice
        ck[:, at:at + 1] = k.to(ck.dtype)
        cv[:, at:at + 1] = v.to(cv.dtype)
        cache.cache_index = i + 1
        mask = (torch.arange(L, device=ck.device) <= i)[None, None, None, :]
        return ck, cv, mask


def _attend(q, k, v, mask):
    """Dense attention over ``(B, S, H, D)`` heads (grouped K/V repeated),
    softmax in fp32 (the reference's numpy scale promotes the logits)."""
    H, dt = q.shape[2], q.dtype
    if k.shape[2] != H:
        k = torch.repeat_interleave(k, H // k.shape[2], dim=2)
        v = torch.repeat_interleave(v, H // v.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(
        q.shape[-1])
    if mask is not None:
        logits = torch.where(
            mask, logits,
            torch.full_like(logits, torch.finfo(torch.float32).min))
    weights = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _head_comm(q):
    """For a DTensor ``q`` whose heads (dim 2) shard over one mesh
    dimension, that dimension's group; else ``None``."""
    if type(q) is torch.Tensor:
        return None
    from torch.distributed.tensor import Shard

    from ..parallel.sharding import axis_comm

    mesh = q.device_mesh
    dims = [i for i, p in enumerate(q.placements)
            if isinstance(p, Shard) and p.dim % q.ndim == 2]
    if not dims:
        return None
    return axis_comm(mesh, mesh.mesh_dim_names[dims[0]])


def _sp_comm(sp_axis, mesh):
    """The communicator of a sequence-parallel chunk: ``sp_axis`` itself,
    or the ``mesh`` dimension it names."""
    if not isinstance(sp_axis, str):
        return sp_axis
    if mesh is None:
        raise ValueError(f"sp_axis {sp_axis!r} names a mesh dimension: "
                         "pass the DeviceMesh as mesh=")
    from ..parallel.sharding import axis_comm

    return axis_comm(mesh, sp_axis)


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
                 generator: Optional[torch.Generator] = None,
                 decode: bool = False, paged: Optional[str] = None,
                 sp_axis=None):
        super().__init__()
        self.norm_0 = LayerNorm(d_model, dtype)
        self.attention = MultiHeadAttention(
            d_model, n_heads, dtype, attention_fn, decode=decode,
            n_kv_heads=n_kv_heads, paged=paged, sp_axis=sp_axis,
            generator=generator,
        )
        self.norm_1 = LayerNorm(d_model, dtype)
        self.feed_forward = FeedForward(d_model, d_ff, dtype, generator)

    def forward(self, x, mask=None, **cache_args):
        """``cache_args``: ``cache``, ``block_tables``, ``seq_lens``,
        ``paged``, ``decode``, ``sp_axis``, ``mesh`` for the attention's
        cache modes."""
        h = self.norm_0(x)
        x = x + self.attention(h, h, mask, **cache_args)
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
    present; pass ``device="cpu"`` to run on the CPU.

    ``decode``/``paged`` set the default cache mode of ``forward`` (see the
    module docstring); ``page_count``, ``page_size`` and ``kv_dtype`` are
    the default page geometry of :meth:`init_paged_cache`."""

    def __init__(self, vocab: int, d_model: int = 512, n_heads: int = 8,
                 d_ff: int = 2048, n_layers: int = 6, max_len: int = 2048,
                 dtype=torch.bfloat16, attention_fn: Optional[Callable] = None,
                 decode: bool = False, remat: bool = False,
                 n_kv_heads: Optional[int] = None,
                 paged: Optional[str] = None, page_count: int = 0,
                 page_size: int = 0, kv_dtype: Optional[str] = None,
                 sp_axis=None, device="cuda", seed: int = 0):
        super().__init__()
        _check_modes(decode, paged, attention_fn, sp_axis)
        _check_kv_dtype(kv_dtype)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads, self.d_ff, self.n_kv_heads = n_heads, d_ff, n_kv_heads
        self.max_len, self.dtype = max_len, dtype
        self.attention_fn, self.remat = attention_fn, remat
        self.decode, self.paged = decode, paged
        self.page_count, self.page_size = page_count, page_size
        self.kv_dtype, self.sp_axis = kv_dtype, sp_axis
        self.embed = nn.Embedding(vocab, d_model)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, d_model ** -0.5, generator=gen)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, dtype, attention_fn,
                         n_kv_heads=n_kv_heads, generator=gen,
                         decode=decode, paged=paged, sp_axis=sp_axis)
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

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def init_paged_cache(self, page_count: Optional[int] = None,
                         page_size: Optional[int] = None,
                         kv_dtype: Optional[str] = "model"
                         ) -> List[PagedLayerCache]:
        """Zero pages for every layer (zeros are the empty cache: every
        table slot starts invalid).  Defaults to the model's geometry;
        ``kv_dtype`` defaults to the model's own, and ``None`` asks for
        full-precision pages whatever the model's field says."""
        n_kv = self.n_kv_heads or self.n_heads
        return [PagedLayerCache.zeros(
            page_count or self.page_count, page_size or self.page_size,
            n_kv, self.d_model // self.n_heads, self.dtype,
            self.kv_dtype if kv_dtype == "model" else kv_dtype,
            device=self.device) for _ in range(self.n_layers)]

    def init_decode_cache(self, batch: int) -> List[DenseLayerCache]:
        """An empty dense KV cache of ``max_len`` positions a layer."""
        n_kv = self.n_kv_heads or self.n_heads
        shape = (batch, self.max_len, n_kv, self.d_model // self.n_heads)
        return [DenseLayerCache(
            torch.zeros(shape, dtype=self.dtype, device=self.device),
            torch.zeros(shape, dtype=self.dtype, device=self.device))
            for _ in range(self.n_layers)]

    def forward(self, tokens, position_offset=None, return_hidden=False,
                inputs_embeds=None, block_tables=None, seq_lens=None,
                cache=None, paged=None, decode=None, sp_axis=None,
                mesh=None):
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
        each layer in the backward (``torch.utils.checkpoint``).

        ``cache``: a list of per-layer caches (:meth:`init_paged_cache`,
        :meth:`init_decode_cache`) that the call updates in place;
        ``paged``/``decode`` override the constructor's mode for this call
        (one set of parameters serves every mode; a cache mode attends
        densely, as the reference's twins built without ``attention_fn``
        do); ``block_tables``/``seq_lens`` route the paged modes;
        ``sp_axis``/``mesh`` shard a chunk's tokens (``position_offset``
        then holds this rank's global positions)."""
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
        paged = self.paged if paged is None else paged
        decode = self.decode if decode is None else decode
        dense = self.attention_fn is None or paged is not None or decode
        mask = causal_mask(S, tokens.device) if dense else None
        if cache is None and dense and (paged is not None or decode):
            cache = [None] * len(self.layers)     # the layers refuse it
        if cache is None:
            per_layer = [{}] * len(self.layers)
        else:
            if len(cache) != len(self.layers):
                raise ValueError(f"{len(cache)} layer caches for "
                                 f"{len(self.layers)} layers")
            per_layer = [dict(cache=c, block_tables=block_tables,
                              seq_lens=seq_lens, paged=paged, decode=decode,
                              sp_axis=sp_axis, mesh=mesh)
                         for c in cache]
        for layer, args in zip(self.layers, per_layer):
            if self.remat and torch.is_grad_enabled() and not args:
                x = checkpoint(layer, x, mask, use_reentrant=False)
            else:
                x = layer(x, mask, **args)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return _dense(x, self.embed.weight, self.dtype)


def generate(lm: TransformerLM, prompt, max_new_tokens: int,
             rng: Optional[torch.Generator] = None,
             temperature: float = 0.0, device="cuda"):
    """Autoregressive generation with a dense KV cache — O(T·max_len)
    attention instead of re-running the prefix for every token.

    ``lm``: any :class:`TransformerLM` (the cache path attends densely,
    whatever its ``attention_fn``) on ``device`` (default ``"cuda"``; raises with no CUDA device unless
    ``device="cpu"``).  ``prompt``: (B, T) int.  Greedy at
    ``temperature=0`` (argmax, first max on ties), else softmax sampling
    from ``rng`` (a ``torch.Generator`` on ``device``; the draws are
    torch's, not the reference's ``jax.random``).  Returns (B, T +
    max_new_tokens): the prompt with its continuation."""
    dev = check_model_device(lm.device, device)
    prompt = torch.as_tensor(prompt, device=dev)
    B, T = prompt.shape
    total = T + max_new_tokens
    if total > lm.max_len:
        raise ValueError(
            f"prompt + new tokens ({total}) exceed max_len {lm.max_len}")
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 requires rng")
    cache = lm.init_decode_cache(B)
    prev = torch.zeros(B, dtype=prompt.dtype, device=dev)
    ys = []
    with torch.no_grad():
        for t in range(total - 1):
            tok = prompt[:, t] if t < T else prev
            logits = lm(tok[:, None], position_offset=t, cache=cache,
                        paged=None, decode=True)[:, 0]
            if temperature > 0.0:
                p = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(p, 1, generator=rng)[:, 0]
            else:
                nxt = logits.argmax(-1)
            prev = nxt.to(prompt.dtype)
            ys.append(prev)
    # ys[t] is the prediction after consuming token t.
    gen = torch.stack(ys[T - 1:], dim=1)
    return torch.cat([prompt, gen], dim=1)

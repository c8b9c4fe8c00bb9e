"""Parameters between the reference's flax tree and the port's ``state_dict``.

The flax tree of ``chainermn_tpu.models.transformer.TransformerLM`` (as
numpy arrays, with or without the outer ``"params"`` key) maps onto
:class:`chainermn_tpu_torch.models.transformer.TransformerLM` as

=====================================================  ==========================================
flax path (shape)                                      port key (shape)
=====================================================  ==========================================
``embed/embedding`` (V, D)                             ``embed.weight`` (V, D)
``layer_i/MultiHeadAttention_0/{query,key,value}``     ``layers.i.attention.{query,key,value}``
``/kernel`` (D, h, dh)                                 ``.weight`` (h*dh, D): reshape, transpose
``layer_i/MultiHeadAttention_0/out/kernel``            ``layers.i.attention.out.weight``
(h, dh, D)                                             (D, h*dh): reshape, transpose
``layer_i/FeedForward_0/{wi,wo}/kernel`` (in, out)     ``layers.i.feed_forward.{wi,wo}.weight``
                                                       (out, in): transpose
``layer_i/LayerNorm_{0,1}/{scale,bias}``               ``layers.i.norm_{0,1}.{weight,bias}``
``final_norm/{scale,bias}``                            ``final_norm.{weight,bias}``
=====================================================  ==========================================

The reference's encoder-decoder ``Transformer`` maps onto the port's by
:func:`encdec_flax_to_state_dict`: ``enc_i`` as the encoder layers above
onto ``enc.i``, ``dec_i/{self_attn,cross_attn}`` onto
``dec.i.{self_attn,cross_attn}`` with the same reshapes,
``dec_i/LayerNorm_{0,1,2}`` onto ``dec.i.norm_{0,1,2}``, and
``enc_norm``/``dec_norm`` by name.  The seq2seq models map by
:func:`seq2seq_flax_to_state_dict`: each flax ``GRUCell_i`` onto
``grus.i``, its ``ir/iz/in`` kernels ``(in, H)`` transposed and stacked
into ``weight_ih`` ``(3H, in)``, their biases into ``bias_ih``, the
bias-free ``hr/hz`` and ``hn`` kernels into ``weight_hh`` and ``hn``'s
bias into ``bias_hn``.

The reference's MNIST ``MLP`` maps onto :class:`models.mlp.MLP` by
:func:`mlp_flax_to_state_dict` (``Dense_i/kernel`` transposed into
``l{i+1}.weight``).

The convnets (``ResNet*``, ``AlexNet``, ``NiN``, ``GoogLeNet``) name their
modules as flax does, so :func:`convnet_flax_to_state_dict` maps flax's
``{"params", "batch_stats"}`` by path, ``a/b/leaf`` onto ``a.b.<name>``:

=====================================  ===================================
flax leaf (shape)                      port name (shape)
=====================================  ===================================
``Conv``  ``kernel`` (kh, kw, in, out)  ``weight`` (out, in, kh, kw)
``Dense`` ``kernel`` (in, out)          ``weight`` (out, in)
``bias``                               ``bias``
``BatchNorm`` ``scale``                 ``weight``
``batch_stats`` ``mean`` / ``var``      ``running_mean`` / ``running_var``
=====================================  ===================================

The reference's ``ViT`` maps onto :class:`models.vit.ViT` by
:func:`vit_flax_to_state_dict`: ``patchify`` as a conv, ``cls`` and
``pos_embed`` as they are, ``block_i`` as an encoder layer onto
``blocks.i``, ``final_norm`` and the dense ``head``.  The ViT example's
three trees (``Patchify``: ``proj`` and ``pos``; ``Blocks``: ``block_i``;
the head) map by :func:`vit_example_flax_to_state_dict`, which takes
pipeline rank ``d``'s slice ``[d]`` of the stacked stage parameters —
``(pp, ...)``, or ``(pp, v, ...)`` with interleaved chunks, whose ``v``
state dicts it stacks back on a leading chunk axis.  The
parallel-convolution net's per-device channel shards map by
:func:`parallel_conv_flax_to_state_dict` (rank ``d`` takes ``[d]``).

The long-context example's parameters are the ``TransformerLM``'s; under
``--vocab-tp`` each rank holds rows ``[r V/n, (r+1) V/n)`` of the table,
which :func:`vocab_shard` takes from the full ``embed/embedding`` (or
``embed.weight``).

Every move is a reshape or a transpose, so each round trip is bit-exact.

The same moves carry sharding specs: :func:`flax_spec_to_torch` maps the
reference's ``PartitionSpec`` on a flax leaf onto the spec of the port
parameter it becomes (a merged ``(h, dh)`` pair takes whichever entry
shards).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_NORMS = (("LayerNorm_0", "norm_0"), ("LayerNorm_1", "norm_1"))
_QKV = ("query", "key", "value")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t)


def _n_layers(keys, stack: str) -> int:
    return len({k.split(".")[1] for k in keys if k.startswith(stack + ".")})


def _mha_to_sd(sd, pre, mha):
    for name in _QKV:
        kern = np.asarray(mha[name]["kernel"])
        sd[f"{pre}.{name}.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
    out = np.asarray(mha["out"]["kernel"])
    sd[f"{pre}.out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)


def _mha_to_flax(sd, pre, n_heads):
    out_w = sd[f"{pre}.out.weight"]                    # (D, h*dh)
    D = out_w.shape[0]
    d_head = out_w.shape[1] // n_heads
    mha = {}
    for name in _QKV:
        w = sd[f"{pre}.{name}.weight"]                 # (h*dh, D)
        mha[name] = {"kernel": np.ascontiguousarray(
            w.T.reshape(D, w.shape[0] // d_head, d_head))}
    mha["out"] = {"kernel": np.ascontiguousarray(
        out_w.T.reshape(n_heads, d_head, D))}
    return mha


def _ff_to_sd(sd, pre, ff):
    for name in ("wi", "wo"):
        sd[f"{pre}.{name}.weight"] = _t(np.asarray(ff[name]["kernel"]).T)


def _ff_to_flax(sd, pre):
    return {name: {"kernel": np.ascontiguousarray(
        sd[f"{pre}.{name}.weight"].T)} for name in ("wi", "wo")}


def _ln_to_sd(sd, pre, ln):
    sd[f"{pre}.weight"] = _t(ln["scale"])
    sd[f"{pre}.bias"] = _t(ln["bias"])


def _ln_to_flax(sd, pre):
    return {"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]}


def _encoder_layer_to_sd(sd, pre, layer):
    _mha_to_sd(sd, f"{pre}.attention", layer["MultiHeadAttention_0"])
    _ff_to_sd(sd, f"{pre}.feed_forward", layer["FeedForward_0"])
    for flax_name, ours in _NORMS:
        _ln_to_sd(sd, f"{pre}.{ours}", layer[flax_name])


def _encoder_layer_to_flax(sd, pre, n_heads):
    layer = {"MultiHeadAttention_0": _mha_to_flax(sd, f"{pre}.attention",
                                                  n_heads),
             "FeedForward_0": _ff_to_flax(sd, f"{pre}.feed_forward")}
    for flax_name, ours in _NORMS:
        layer[flax_name] = _ln_to_flax(sd, f"{pre}.{ours}")
    return layer


def flax_to_state_dict(params) -> dict:
    """Flax param tree (numpy leaves) -> the port's ``state_dict``."""
    p = params.get("params", params)
    sd = {"embed.weight": _t(p["embed"]["embedding"])}
    i = 0
    while f"layer_{i}" in p:
        _encoder_layer_to_sd(sd, f"layers.{i}", p[f"layer_{i}"])
        i += 1
    _ln_to_sd(sd, "final_norm", p["final_norm"])
    return sd


def state_dict_to_flax(state_dict, n_heads: int) -> dict:
    """The port's ``state_dict`` -> flax param tree (numpy leaves, no
    outer ``"params"`` key).  ``n_heads`` is the query head count; the kv
    head count follows from the key projection's width."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    tree = {"embed": {"embedding": sd["embed.weight"]}}
    for i in range(_n_layers(sd, "layers")):
        tree[f"layer_{i}"] = _encoder_layer_to_flax(sd, f"layers.{i}",
                                                    n_heads)
    tree["final_norm"] = _ln_to_flax(sd, "final_norm")
    return tree


_DEC_NORMS = (("LayerNorm_0", "norm_0"), ("LayerNorm_1", "norm_1"),
              ("LayerNorm_2", "norm_2"))


def encdec_flax_to_state_dict(params) -> dict:
    """The reference's ``Transformer`` (encoder-decoder) tree -> the
    port's ``Transformer`` ``state_dict``: ``enc_i`` onto ``enc.i`` as an
    encoder layer, ``dec_i/{self_attn,cross_attn,FeedForward_0,
    LayerNorm_{0,1,2}}`` onto ``dec.i.{self_attn,cross_attn,feed_forward,
    norm_{0,1,2}}``, ``enc_norm``/``dec_norm`` by name."""
    p = params.get("params", params)
    sd = {"embed.weight": _t(p["embed"]["embedding"])}
    i = 0
    while f"enc_{i}" in p:
        _encoder_layer_to_sd(sd, f"enc.{i}", p[f"enc_{i}"])
        i += 1
    i = 0
    while f"dec_{i}" in p:
        layer, pre = p[f"dec_{i}"], f"dec.{i}"
        for name in ("self_attn", "cross_attn"):
            _mha_to_sd(sd, f"{pre}.{name}", layer[name])
        _ff_to_sd(sd, f"{pre}.feed_forward", layer["FeedForward_0"])
        for flax_name, ours in _DEC_NORMS:
            _ln_to_sd(sd, f"{pre}.{ours}", layer[flax_name])
        i += 1
    _ln_to_sd(sd, "enc_norm", p["enc_norm"])
    _ln_to_sd(sd, "dec_norm", p["dec_norm"])
    return sd


def encdec_state_dict_to_flax(state_dict, n_heads: int) -> dict:
    """The inverse of :func:`encdec_flax_to_state_dict` (no ``"params"``
    key)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    tree = {"embed": {"embedding": sd["embed.weight"]}}
    for i in range(_n_layers(sd, "enc")):
        tree[f"enc_{i}"] = _encoder_layer_to_flax(sd, f"enc.{i}", n_heads)
    for i in range(_n_layers(sd, "dec")):
        pre = f"dec.{i}"
        layer = {name: _mha_to_flax(sd, f"{pre}.{name}", n_heads)
                 for name in ("self_attn", "cross_attn")}
        layer["FeedForward_0"] = _ff_to_flax(sd, f"{pre}.feed_forward")
        for flax_name, ours in _DEC_NORMS:
            layer[flax_name] = _ln_to_flax(sd, f"{pre}.{ours}")
        tree[f"dec_{i}"] = layer
    tree["enc_norm"] = _ln_to_flax(sd, "enc_norm")
    tree["dec_norm"] = _ln_to_flax(sd, "dec_norm")
    return tree


_GATES = ("r", "z", "n")


def _gru_to_sd(sd, pre, cell):
    sd[f"{pre}.weight_ih"] = _t(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES]))
    sd[f"{pre}.bias_ih"] = _t(np.concatenate(
        [np.asarray(cell[f"i{g}"]["bias"]) for g in _GATES]))
    sd[f"{pre}.weight_hh"] = _t(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]))
    sd[f"{pre}.bias_hn"] = _t(cell["hn"]["bias"])


def _gru_to_flax(sd, pre):
    w_ih = np.split(sd[f"{pre}.weight_ih"], 3)
    b_ih = np.split(sd[f"{pre}.bias_ih"], 3)
    w_hh = np.split(sd[f"{pre}.weight_hh"], 3)
    cell = {}
    for g, w, b, h in zip(_GATES, w_ih, b_ih, w_hh):
        cell[f"i{g}"] = {"kernel": np.ascontiguousarray(w.T),
                         "bias": np.ascontiguousarray(b)}
        cell[f"h{g}"] = {"kernel": np.ascontiguousarray(h.T)}
    cell["hn"]["bias"] = sd[f"{pre}.bias_hn"]
    return cell


def seq2seq_flax_to_state_dict(params, prefix: str = "") -> dict:
    """A reference ``Encoder``, ``Decoder`` or ``Seq2seq`` tree -> the
    port module's ``state_dict``: ``embed/embedding`` onto
    ``embed.weight``; each ``GRUCell_i`` onto ``grus.i``, its ``ir``,
    ``iz``, ``in`` kernels (in, H) transposed and stacked into
    ``weight_ih`` (3H, in) with their biases into ``bias_ih``, ``hr``,
    ``hz``, ``hn`` into ``weight_hh`` and ``hn``'s bias into
    ``bias_hn``; ``proj`` as a dense layer.  A ``Seq2seq`` tree's
    ``encoder``/``decoder`` subtrees map under those prefixes."""
    p = params.get("params", params)
    sd = {}
    if "encoder" in p:
        for part in ("encoder", "decoder"):
            sd.update(seq2seq_flax_to_state_dict(p[part], f"{prefix}{part}."))
        return sd
    sd[f"{prefix}embed.weight"] = _t(p["embed"]["embedding"])
    i = 0
    while f"GRUCell_{i}" in p:
        _gru_to_sd(sd, f"{prefix}grus.{i}", p[f"GRUCell_{i}"])
        i += 1
    if "proj" in p:
        sd[f"{prefix}proj.weight"] = _t(np.asarray(p["proj"]["kernel"]).T)
        sd[f"{prefix}proj.bias"] = _t(p["proj"]["bias"])
    return sd


def seq2seq_state_dict_to_flax(state_dict) -> dict:
    """The inverse of :func:`seq2seq_flax_to_state_dict` (no ``"params"``
    key)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    parts = {k.split(".")[0] for k in sd}
    if parts == {"encoder", "decoder"}:
        return {part: seq2seq_state_dict_to_flax(
            {k[len(part) + 1:]: v for k, v in sd.items()
             if k.startswith(part + ".")}) for part in ("encoder", "decoder")}
    tree = {"embed": {"embedding": sd["embed.weight"]}}
    for i in range(_n_layers(sd, "grus")):
        tree[f"GRUCell_{i}"] = _gru_to_flax(sd, f"grus.{i}")
    if "proj.weight" in sd:
        tree["proj"] = {"kernel": np.ascontiguousarray(sd["proj.weight"].T),
                        "bias": sd["proj.bias"]}
    return tree


def mlp_flax_to_state_dict(params) -> dict:
    """The reference's flax ``MLP`` tree -> :class:`models.mlp.MLP`'s
    ``state_dict``: ``Dense_i/kernel`` (in, out) transposed into
    ``l{i+1}.weight`` (out, in), ``Dense_i/bias`` into ``l{i+1}.bias``."""
    p = params.get("params", params)
    sd = {}
    for i in range(3):
        dense = p[f"Dense_{i}"]
        sd[f"l{i + 1}.weight"] = _t(np.asarray(dense["kernel"]).T)
        sd[f"l{i + 1}.bias"] = _t(dense["bias"])
    return sd


def mlp_state_dict_to_flax(state_dict) -> dict:
    """The inverse of :func:`mlp_flax_to_state_dict` (no ``"params"``
    key)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    return {f"Dense_{i}": {
        "kernel": np.ascontiguousarray(sd[f"l{i + 1}.weight"].T),
        "bias": sd[f"l{i + 1}.bias"]} for i in range(3)}


# Conv kernels HWIO <-> OIHW; dense kernels (in, out) <-> (out, in).
_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}
_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}
_STATS = {"mean": "running_mean", "var": "running_var"}


def convnet_flax_to_state_dict(variables) -> dict:
    """A convnet's flax ``{"params", "batch_stats"}`` (numpy leaves;
    ``batch_stats`` absent for the models without BatchNorm) -> the port
    model's ``state_dict``."""
    sd = {}

    def walk(tree, prefix, stats):
        for name, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{name}.", stats)
            elif stats:
                sd[prefix + _STATS[name]] = _t(v)
            elif name == "kernel":
                a = np.asarray(v)
                sd[prefix + "weight"] = _t(a.transpose(_TO_TORCH[a.ndim]))
            else:
                sd[prefix + {"scale": "weight", "bias": "bias"}[name]] = _t(v)

    walk(variables["params"], "", False)
    walk(variables.get("batch_stats", {}), "", True)
    return sd


def convnet_state_dict_to_flax(state_dict) -> dict:
    """The inverse of :func:`convnet_flax_to_state_dict`:
    ``{"params": ..., "batch_stats": ...}`` with numpy leaves
    (``batch_stats`` empty for the models without BatchNorm)."""
    out = {"params": {}, "batch_stats": {}}
    inverse = {v: k for k, v in _STATS.items()}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = _np(t)
        if leaf in inverse:
            tree, leaf = out["batch_stats"], inverse[leaf]
        else:
            tree = out["params"]
            if leaf == "weight" and a.ndim > 1:
                leaf, a = "kernel", np.ascontiguousarray(
                    a.transpose(_TO_FLAX[a.ndim]))
            elif leaf == "weight":
                leaf = "scale"
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = a
    return out


def flax_flat_layout(model):
    """A convnet's parameters in the order of the reference's flat ZeRO
    buffer (jax's sorted tree leaves, under flax's leaf names) and, for
    each, the permutation that takes it into flax's layout (conv kernels
    OIHW -> HWIO, dense kernels ``(out, in)`` -> ``(in, out)``, ``None``
    for the rest): the ``params`` to build the wrapped optimizer over and
    the multi-node optimizer's ``flat_layout``, so that each ZeRO shard
    holds the reference shard's elements in its order."""
    def key(item):
        name, p = item
        *path, leaf = name.split(".")
        if leaf == "weight":
            leaf = "kernel" if p.dim() > 1 else "scale"
        return (*path, leaf)

    named = sorted(model.named_parameters(), key=key)
    return ([p for _, p in named],
            [_TO_FLAX.get(p.dim()) if name.endswith("weight") else None
             for name, p in named])


def stage_slice(tree, index):
    """``tree`` (nested mappings of arrays) with every leaf indexed by
    ``index`` along its leading axis: one rank's slice ``[d]`` of the
    reference's stacked per-device parameters."""
    if isinstance(tree, Mapping):
        return {k: stage_slice(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]


def _conv_to_sd(sd, pre, conv):
    sd[f"{pre}.weight"] = _t(np.asarray(conv["kernel"]).transpose(
        _TO_TORCH[4]))
    sd[f"{pre}.bias"] = _t(conv["bias"])


def _dense_to_sd(sd, pre, dense):
    sd[f"{pre}.weight"] = _t(np.asarray(dense["kernel"]).T)
    sd[f"{pre}.bias"] = _t(dense["bias"])


def _blocks_to_sd(sd, pre, tree):
    i = 0
    while f"block_{i}" in tree:
        _encoder_layer_to_sd(sd, f"{pre}.{i}", tree[f"block_{i}"])
        i += 1


def vit_flax_to_state_dict(params) -> dict:
    """The reference's ``ViT`` tree -> :class:`models.vit.ViT`'s
    ``state_dict``."""
    p = params.get("params", params)
    sd = {}
    _conv_to_sd(sd, "patchify", p["patchify"])
    sd["cls"] = _t(p["cls"])
    sd["pos_embed"] = _t(p["pos_embed"])
    _blocks_to_sd(sd, "blocks", p)
    _ln_to_sd(sd, "final_norm", p["final_norm"])
    _dense_to_sd(sd, "head", p["head"])
    return sd


def vit_state_dict_to_flax(state_dict, n_heads: int) -> dict:
    """The inverse of :func:`vit_flax_to_state_dict` (no ``"params"``
    key)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    tree = {"patchify": {
        "kernel": np.ascontiguousarray(
            sd["patchify.weight"].transpose(_TO_FLAX[4])),
        "bias": sd["patchify.bias"]},
        "cls": sd["cls"], "pos_embed": sd["pos_embed"]}
    for i in range(_n_layers(sd, "blocks")):
        tree[f"block_{i}"] = _encoder_layer_to_flax(sd, f"blocks.{i}",
                                                    n_heads)
    tree["final_norm"] = _ln_to_flax(sd, "final_norm")
    tree["head"] = {"kernel": np.ascontiguousarray(sd["head.weight"].T),
                    "bias": sd["head.bias"]}
    return tree


def vit_example_flax_to_state_dict(params, rank: int,
                                   virtual_stages: int = 1) -> dict:
    """The reference ViT example's ``{"embed", "stages", "head"}`` tree ->
    the port example's ``{"embed", "stages", "head"}`` state dicts on
    pipeline rank ``rank``: ``Patchify`` (``proj.{weight,bias}``,
    ``pos``), that rank's ``Blocks`` (``blocks.i.*``; with
    ``virtual_stages`` > 1 each entry stacks the rank's chunks on a
    leading axis) and the head (``weight``, ``bias``)."""
    def unwrap(t):
        return t.get("params", t)

    embed, head = unwrap(params["embed"]), unwrap(params["head"])
    esd = {"pos": _t(embed["pos"])}
    _conv_to_sd(esd, "proj", embed["proj"])
    hsd = {"weight": _t(np.asarray(head["kernel"]).T),
           "bias": _t(head["bias"])}
    mine = unwrap(stage_slice(unwrap(params["stages"]), rank))
    chunks = []
    for l in range(virtual_stages):
        tree = mine if virtual_stages == 1 else stage_slice(mine, l)
        csd = {}
        _blocks_to_sd(csd, "blocks", tree)
        chunks.append(csd)
    ssd = chunks[0] if virtual_stages == 1 else {
        k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
    return {"embed": esd, "stages": ssd, "head": hsd}


def parallel_conv_flax_to_state_dict(stacked_params, rank: int) -> dict:
    """The reference parallel-convolution example's stacked per-device
    parameters (leading device axis) -> rank ``rank``'s channel-shard
    ``state_dict`` of the port's ``ShardedConvNet`` (``conv_i`` and
    ``head`` by name, as :func:`convnet_flax_to_state_dict` maps them)."""
    p = stacked_params.get("params", stacked_params)
    return convnet_flax_to_state_dict({"params": stage_slice(p, rank)})


def vocab_shard(table, rank: int, n: int):
    """Rank ``rank``'s contiguous rows of a (V, D) embedding table split
    over ``n`` vocab shards (the ownership of
    ``parallel.sharding.vocab_parallel_embed``)."""
    V = table.shape[0]
    if V % n:
        raise ValueError(f"vocab {V} does not split into {n} shards")
    v = V // n
    return table[rank * v:(rank + 1) * v]


def _leaf_kind(path: str, ndim: int) -> str:
    """The layout move of flax leaf ``path`` (``/``-joined) of rank
    ``ndim``: ``out`` ((h, dh, D) -> (D, h dh)), ``qkv`` ((D, h, dh) ->
    (h dh, D)), ``conv`` (HWIO -> OIHW), ``dense`` ((in, out) -> (out,
    in); a GRU gate's block of ``weight_ih``/``weight_hh``) or ``same``."""
    parts = path.split("/")
    if parts[-1] != "kernel":
        return "same"
    if ndim == 3:
        return "out" if len(parts) > 1 and parts[-2] == "out" else "qkv"
    return {4: "conv", 2: "dense"}.get(ndim, "same")


def _merge(a, b):
    entries = [x for e in (a, b) if e is not None
               for x in (e if isinstance(e, tuple) else (e,))]
    return None if not entries else entries[0] if len(entries) == 1 \
        else tuple(entries)


def flax_spec_to_torch(path: str, spec, ndim: int) -> tuple:
    """The spec, one entry per dimension, of the port parameter that the
    reference's flax leaf ``path`` (rank ``ndim``) maps onto, given the
    reference's ``spec`` on that leaf (a ``PartitionSpec`` or any
    sequence of entries; missing trailing entries replicate).

    Transposes and permutations carry their entries along; the merged
    ``(h, dh)`` dimension of an attention projection takes the entry of
    whichever of the two shards (both: their tuple, ``h`` major).  Where
    the sharded one is ``h``, the port's block split of ``h dh`` gives
    each rank the reference's heads; where it is ``dh`` (the ``fsdp``
    plan's ``kernel_3d``), only each rank's share agrees.  A GRU gate's
    kernel maps onto the spec of the stacked ``weight_ih``/``weight_hh``
    it is a block of."""
    e = list(spec) + [None] * (ndim - len(tuple(spec)))
    kind = _leaf_kind(path, ndim)
    if kind == "out":
        return (e[2], _merge(e[0], e[1]))
    if kind == "qkv":
        return (_merge(e[1], e[2]), e[0])
    if kind == "conv":
        return tuple(e[i] for i in _TO_TORCH[4])
    if kind == "dense":
        return (e[1], e[0])
    return tuple(e)


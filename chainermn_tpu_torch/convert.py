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

Every move is a reshape or a transpose, so each round trip is bit-exact.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_NORMS = (("LayerNorm_0", "norm_0"), ("LayerNorm_1", "norm_1"))
_QKV = ("query", "key", "value")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _n_layers(keys) -> int:
    return len({k.split(".")[1] for k in keys if k.startswith("layers.")})


def flax_to_state_dict(params) -> dict:
    """Flax param tree (numpy leaves) -> the port's ``state_dict``."""
    p = params.get("params", params)
    sd = {"embed.weight": _t(p["embed"]["embedding"])}
    i = 0
    while f"layer_{i}" in p:
        layer = p[f"layer_{i}"]
        pre = f"layers.{i}"
        mha = layer["MultiHeadAttention_0"]
        for name in _QKV:
            kern = np.asarray(mha[name]["kernel"])
            sd[f"{pre}.attention.{name}.weight"] = _t(
                kern.reshape(kern.shape[0], -1).T
            )
        out = np.asarray(mha["out"]["kernel"])
        sd[f"{pre}.attention.out.weight"] = _t(
            out.reshape(-1, out.shape[-1]).T
        )
        for name in ("wi", "wo"):
            sd[f"{pre}.feed_forward.{name}.weight"] = _t(
                np.asarray(layer["FeedForward_0"][name]["kernel"]).T
            )
        for flax_name, ours in _NORMS:
            sd[f"{pre}.{ours}.weight"] = _t(layer[flax_name]["scale"])
            sd[f"{pre}.{ours}.bias"] = _t(layer[flax_name]["bias"])
        i += 1
    sd["final_norm.weight"] = _t(p["final_norm"]["scale"])
    sd["final_norm.bias"] = _t(p["final_norm"]["bias"])
    return sd


def state_dict_to_flax(state_dict, n_heads: int) -> dict:
    """The port's ``state_dict`` -> flax param tree (numpy leaves, no
    outer ``"params"`` key).  ``n_heads`` is the query head count; the kv
    head count follows from the key projection's width."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    D = sd["embed.weight"].shape[1]
    tree = {"embed": {"embedding": sd["embed.weight"]}}
    for i in range(_n_layers(sd)):
        pre = f"layers.{i}"
        out_w = sd[f"{pre}.attention.out.weight"]         # (D, h*dh)
        d_head = out_w.shape[1] // n_heads
        mha = {}
        for name in _QKV:
            w = sd[f"{pre}.attention.{name}.weight"]       # (h*dh, D)
            mha[name] = {"kernel": np.ascontiguousarray(
                w.T.reshape(D, w.shape[0] // d_head, d_head))}
        mha["out"] = {"kernel": np.ascontiguousarray(
            out_w.T.reshape(n_heads, d_head, D))}
        layer = {
            "MultiHeadAttention_0": mha,
            "FeedForward_0": {
                name: {"kernel": np.ascontiguousarray(
                    sd[f"{pre}.feed_forward.{name}.weight"].T)}
                for name in ("wi", "wo")
            },
        }
        for flax_name, ours in _NORMS:
            layer[flax_name] = {"scale": sd[f"{pre}.{ours}.weight"],
                                "bias": sd[f"{pre}.{ours}.bias"]}
        tree[f"layer_{i}"] = layer
    tree["final_norm"] = {"scale": sd["final_norm.weight"],
                          "bias": sd["final_norm.bias"]}
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

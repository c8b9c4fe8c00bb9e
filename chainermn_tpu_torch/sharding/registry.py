"""Built-in sharding plans — the port of
``chainermn_tpu/sharding/registry.py``.

The six plans keep the reference's names, axes, descriptions and rule
names, so :meth:`~.plan.ShardingPlan.explain` rows line up between the
packages.  The rule patterns and specs are rewritten for the port's
parameter names and layouts: every projection is an ``nn.Linear`` whose
weight is ``(out, in)`` (flax's kernel is ``(in, out)``), and the
attention projections are 2-D with whole heads contiguous along
``heads·d_head`` (flax's are 3-D ``(d_model, heads, d_head)`` and
``(heads, d_head, d_model)``):

==================  ==========================================  ===================
rule                port name (layout)                          spec
==================  ==========================================  ===================
``attention_qkv``   ``.{query,key,value}.weight`` (h·dh, D)     ``P("model", None)``
``attention_out``   ``.out.weight`` (D, h·dh)                   ``P(None, "model")``
``ffn_in``          ``.wi.weight`` (d_ff, D)                    ``P("model", None)``
``ffn_out``         ``.wo.weight`` (D, d_ff)                    ``P(None, "model")``
``kv_pages``        ``{k,v}_pages`` (pages, page, n_kv, dh)     ``P(None, None, "model", None)``
``embedding``       ``embed.weight`` (V, D)                     ``P("data", None)``
``kernel_{2,3,4}d`` every ``weight``/``weight_ih``/``weight_hh``  dim 0 over ``"data"``
                    of rank 2, 3, 4 (``Linear`` (out, in), conv
                    (O, I, kh, kw), the GRU's stacked gates)
==================  ==========================================  ===================

``Shard(0)`` of a ``(h·dh, D)`` weight over ``model`` gives rank ``r``
heads ``[r h/n, (r+1) h/n)``, the reference's shard.  The FSDP rules
shard the output features as the reference's do; where flax splits a
query kernel's ``d_head`` (``kernel_3d``) the port splits ``h·dh`` in
blocks — both are gathered before use, so only each rank's share agrees.
Every plan ends in a catch-all, so every model of
:mod:`chainermn_tpu_torch.models` resolves with no unmatched leaf.
"""

from __future__ import annotations

from typing import Dict, List

from .plan import P, PlanRule, ShardingPlan, mesh_axis_sizes, validate

_REGISTRY: Dict[str, ShardingPlan] = {}


def register_plan(plan: ShardingPlan, *, overwrite: bool = False
                  ) -> ShardingPlan:
    """Add ``plan`` to the registry (the built-ins below, and user code
    defining project-local layouts)."""
    if plan.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"sharding plan {plan.name!r} is already registered "
            "(pass overwrite=True to replace it)"
        )
    _REGISTRY[plan.name] = plan
    return plan


def get_plan(name: str) -> ShardingPlan:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown sharding plan {name!r}; registered plans: "
            f"{sorted(_REGISTRY)}"
        ) from None


def list_plans() -> List[ShardingPlan]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def plans_for_mesh(mesh, params=None) -> List[ShardingPlan]:
    """Registry plans whose every axis is a dimension of ``mesh`` (a
    ``DeviceMesh``'s ``mesh_dim_names``, or ``{axis: size}``) and, when
    ``params`` is given, that :func:`validate` clean against it at the
    mesh's sizes."""
    names = set(mesh_axis_sizes(mesh))
    out = []
    for plan in list_plans():
        if not set(plan.axes) <= names:
            continue
        if params is not None and not validate(plan, params, mesh).ok:
            continue
        out.append(plan)
    return out


# ---------------------------------------------------------------------
# Rule blocks (shared between plans)
# ---------------------------------------------------------------------

_REPLICATE = PlanRule("replicate", r".*", P())

# Megatron tensor parallelism: column-parallel q/k/v and wi (output rows
# over "model"), row-parallel out and wo (input columns over "model").
_TP_RULES = (
    PlanRule("attention_qkv", r"(^|\.)(query|key|value)\.weight$",
             P("model", None), ndim=2),
    PlanRule("attention_out", r"(^|\.)out\.weight$", P(None, "model"),
             ndim=2),
    PlanRule("ffn_in", r"(^|\.)wi\.weight$", P("model", None)),
    PlanRule("ffn_out", r"(^|\.)wo\.weight$", P(None, "model")),
    # paged KV cache: (page_count, page_size, n_kv, d_head) — the KV-head
    # axis over "model" so TP decode keeps heads local (serving only)
    PlanRule("kv_pages", r"(k|v)_pages$",
             P(None, None, "model", None), ndim=4),
    _REPLICATE,
)

# FSDP: the output features (dim 0 in torch's layouts) of every weight of
# rank >= 2 and the vocab rows of the embedding over "data"; biases, norm
# scales, class tokens and position tables replicate.
_WEIGHT = r"(^|\.)weight(_ih|_hh)?$"
_FSDP_RULES = (
    PlanRule("embedding", r"(^|\.)embed\.weight$", P("data", None), ndim=2),
    PlanRule("kernel_2d", _WEIGHT, P("data", None), ndim=2),
    PlanRule("kernel_3d", _WEIGHT, P("data", None, None), ndim=3),
    PlanRule("kernel_4d", _WEIGHT, P("data", None, None, None), ndim=4),
    _REPLICATE,
)


# ---------------------------------------------------------------------
# Built-in plans
# ---------------------------------------------------------------------

register_plan(ShardingPlan(
    name="dp",
    rules=(_REPLICATE,),
    axes=("data",),
    description="Pure data parallelism: params, moments, and cache "
                "replicated; only the batch shards.",
))

register_plan(ShardingPlan(
    name="tp",
    rules=_TP_RULES,
    axes=("model",),
    description="Megatron tensor parallelism for attention/FFN "
                "families (transformer, ViT): heads and FFN hidden "
                "shard over 'model'; KV pages shard for TP decode.",
))

register_plan(ShardingPlan(
    name="dp_tp",
    rules=_TP_RULES,
    axes=("data", "model"),
    description="Composed DP×TP on a 2-D ('data', 'model') mesh: the "
                "tp rule table for params/moments, batch over 'data'.",
))

register_plan(ShardingPlan(
    name="sp",
    rules=(_REPLICATE,),
    axes=("sp",),
    description="Sequence-parallel prefill (serving engine): params and "
                "KV pages replicated over 'sp'; only the chunk "
                "program's token axis shards (shard_map inside the "
                "engine's sp prefill step), so one slice's activations "
                "split across devices while decode stays single-chip.",
))

register_plan(ShardingPlan(
    name="fsdp",
    rules=_FSDP_RULES,
    axes=("data",),
    description="Fully-sharded data parallelism: every kernel and "
                "embedding shards one dim over 'data'; GSPMD "
                "gathers/scatters around use.",
))

register_plan(ShardingPlan(
    name="zero",
    rules=(_REPLICATE,),
    moment_rules=_FSDP_RULES,
    axes=("data",),
    description="ZeRO-1 in GSPMD form: params replicated, optimizer "
                "moments sharded over 'data' via the FSDP rule block.",
))

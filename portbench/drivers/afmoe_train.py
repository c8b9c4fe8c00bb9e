"""Driver ``afmoe_train``: the AFMoE decoder (Arcee's Trinity) holding a
slice of its experts, trained through the port's data-parallel entry
point.

The program: ``create_communicator`` (the configuration's communicator),
``models.afmoe.AFMoELM`` built on the card in bf16 over fp32 parameters
(windowed gated GQA on the hand-written flash kernels, the dropless
expert layer of ``parallel.moe``), the fused cross-entropy against the
untied head, ``torch.optim.AdamW`` wrapped by
``create_multi_node_optimizer`` with the expert layers' bias update as
its step pre-hook, stepped by ``make_train_step(n_accum=...)``.  The
reference: :class:`..reference.trinity.RefTrinity`, which runs a step's
sequences in chunks and moves its biases once a step.
"""

from __future__ import annotations

import itertools
import math

from .. import harness, sparse_yardstick
from ..reference.trinity import RefTrinity
from .lm_train import OPTIMIZER, first_grad_norms  # noqa: F401
#: Sequences the reference takes through one forward and backward.
REF_CHUNK = 2
#: Steps a run takes from a fresh optimizer before its window opens: the
#: first steps the reference follows and the steps that size the window.
SETUP_STEPS = harness.FIRST_STEPS + harness.TIMING_STEPS
#: The expert layer's device spans that ``moe_ms`` reads.
MOE_SPANS = ("moe", "moe/backward")


def _embed_scale(cfg):
    """The embedding's scale, ``sqrt(hidden_size)`` under ``mup_enabled``:
    the one setting the program builds, so any other is refused."""
    if not cfg["mup_enabled"]:
        raise ValueError("afmoe_train builds AFMoELM, which scales the "
                         "embedding by sqrt(hidden_size) (mup_enabled); "
                         "the configuration turns it off")
    return math.sqrt(cfg["hidden_size"])


def reference(cfg: dict, traffic: dict):
    """The plain reference, on the current default device."""
    return RefTrinity(
        cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["head_dim"], cfg["intermediate_size"],
        cfg["moe_intermediate_size"], cfg["num_experts_published"],
        cfg["num_experts"], cfg["first_expert"], cfg["num_experts_per_tok"],
        cfg["num_dense_layers"], cfg["layer_types"], cfg["sliding_window"],
        cfg["rope_theta"], cfg["rms_norm_eps"], cfg["route_scale"],
        cfg["load_balance_coeff"], cfg["num_shared_experts"],
        _embed_scale(cfg))


def ref_step(torch, ref, batches):
    """One reference step over every rank's batch, ``REF_CHUNK`` sequences
    at a time: the mean loss over every token, the parameters' gradients
    of it, and the selection biases moved once."""
    rows = sum(len(t) for t, _ in batches)
    total = 0.0
    for toks, labs in batches:
        for i in range(0, len(toks), REF_CHUNK):
            t, y = toks[i:i + REF_CHUNK], labs[i:i + REF_CHUNK]
            loss = ref(t, y) * (len(t) / rows)
            loss.backward()
            total += loss.item()
    ref.update_bias()
    return total


def work(cfg: dict, traffic: dict, world: int) -> dict:
    """Work of one global step: tokens, model FLOPs, the flash launches'
    shapes and live pairs, the expert layer's calls."""
    b, s = traffic["batch"], traffic["seq"]
    n_accum = traffic.get("n_accum", 1)
    micro = b // n_accum
    H, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    L = cfg["num_hidden_layers"]
    launches = {}
    for pairs in sparse_yardstick.afmoe_pairs(cfg, s):
        launches[pairs] = launches.get(pairs, 0) + n_accum
    return {"unit": "tokens", "per_step": b * s * world,
            "flops_per_step": sparse_yardstick.afmoe_train_flops(
                cfg, b * world, s),
            "flash_masked": [[micro * H, micro * Hk, s, cfg["head_dim"],
                              pairs * micro * H, n]
                             for pairs, n in launches.items()],
            "moe": {"calls_per_step": (L - cfg["num_dense_layers"])
                    * n_accum,
                    "tokens_per_call": micro * s,
                    "d_model": cfg["hidden_size"],
                    "d_expert": cfg["moe_intermediate_size"]}}


def build(torch, cfg: dict, traffic: dict, ctx):
    """The program's model and communicator, and ``new_step()``: a fresh
    AdamW under the wrapper, the bias update hooked to it, the expert
    counts cleared, and its train step, ``(inner, wrapper, step)``, which
    calls :func:`mark_window` before its ``SETUP_STEPS + 1``-th step;
    ``ctx.fault`` ``half_batch`` plants that fault."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models.afmoe import AFMoELM
    from chainermn_tpu_torch.ops import moe_dispatch
    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

    _embed_scale(cfg)
    comm = create_communicator(cfg["communicator"], device=ctx.device)
    model = AFMoELM(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_head=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], d_expert=cfg["moe_intermediate_size"],
        n_experts=cfg["num_experts_published"],
        top_k=cfg["num_experts_per_tok"],
        n_dense_layers=cfg["num_dense_layers"],
        layer_types=cfg["layer_types"], window=cfg["sliding_window"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        route_scale=cfg["route_scale"], n_shared=cfg["num_shared_experts"],
        bias_rate=cfg["load_balance_coeff"],
        first_expert=cfg["first_expert"], held_experts=cfg["num_experts"],
        dtype=torch.bfloat16, comm=comm,
        device=ctx.device, seed=ctx.seed % 2**63)
    moe_dispatch.warm_up(ctx.device, cfg["hidden_size"],
                         cfg["num_experts_per_tok"])
    n_accum = traffic.get("n_accum", 1)

    def new_step():
        inner = torch.optim.AdamW(model.parameters(), lr=cfg["lr"],
                                  betas=tuple(cfg["adam_betas"]),
                                  eps=cfg["adam_eps"],
                                  weight_decay=cfg["weight_decay"])
        model.register_bias_update(inner)
        for m in model.moe_layers():
            m.reset_counts()
        opt = create_multi_node_optimizer(inner, comm)
        half = ctx.fault == "half_batch"

        def loss_fn(batch):
            toks, labs = batch
            if half:       # half the rows, or of one row's tokens
                cut = ((slice(len(toks) // 2),) if len(toks) > 1 else
                       (slice(None), slice(toks.shape[1] // 2)))
                toks, labs = toks[cut], labs[cut]
            h = model(toks, return_hidden=True)
            return fused_cross_entropy(h, model.head.weight, labs)

        step = opt.make_train_step(loss_fn, n_accum=n_accum,
                                   local_batch=True)
        calls = itertools.count()

        def windowed_step(batch):
            if next(calls) == SETUP_STEPS:
                mark_window()
            return step(batch)

        return inner, opt, windowed_step

    return model, comm, new_step


def mark_window() -> None:
    """At the first step of the window, with a Reporter installed: resolve
    the set-up steps' device spans and count what the expert layer's span
    counters hold then under ``setup/<counter>``, which ``moe_ms``
    subtracts, so that it reads the window's steps alone."""
    from chainermn_tpu_torch.observability import reporter, spans

    rep = reporter.get_reporter()
    if rep is None:
        return
    spans.flush_device_spans()
    c = rep.summary()["counters"]
    for span in MOE_SPANS:
        for name in (f"device_ms/{span}", f"device_spans/{span}"):
            rep.count(f"setup/{name}", c.get(name, 0))

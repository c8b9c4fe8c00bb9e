"""Driver ``lm_train``: a decoder-only LM trained through the port's
data-parallel entry point.

The program: ``create_communicator`` (the configuration's communicator),
``models.transformer.TransformerLM`` in bf16 over fp32 parameters with the
hand-written causal flash attention (``ops.make_flash_attention_fn``),
the fused cross-entropy against the tied embedding at its default chunk,
``torch.optim.AdamW`` wrapped by ``create_multi_node_optimizer`` and
stepped by ``make_train_step``.  Each rank trains on its own batch
(``local_batch``).  The reference: :class:`..reference.lm.RefLM`.
"""

from __future__ import annotations

from .. import yardstick
from ..reference.lm import RefLM

OPTIMIZER = "adamw"


def reference(cfg: dict, traffic: dict):
    """The plain reference, on the current default device."""
    return RefLM(cfg["vocab"], cfg["d_model"], cfg["n_heads"], cfg["d_ff"],
                 cfg["n_layers"], cfg["layer_norm_eps"])


def ref_step(torch, ref, batches):
    """One reference forward and backward over every rank's batch: the
    mean loss over the ranks, and the parameters' gradients of it."""
    total = 0.0
    for toks, labs in batches:
        loss = ref(toks, labs) / len(batches)
        loss.backward()
        total += loss.item()
    return total


def work(cfg: dict, traffic: dict, world: int) -> dict:
    """Work of one global step: tokens, model FLOPs, the flash shape."""
    n_params = yardstick.lm_params(cfg["vocab"], cfg["d_model"], cfg["d_ff"],
                                   cfg["n_layers"])
    b, s = traffic["batch"], traffic["seq"]
    dh = cfg["d_model"] // cfg["n_heads"]
    return {"unit": "tokens", "per_step": b * s * world,
            "flops_per_step": yardstick.lm_train_flops(
                n_params, b * s * world, b * world, s, cfg["n_heads"], dh,
                cfg["n_layers"]),
            "flash_shape": [b * cfg["n_heads"], s, dh]}


def build(torch, cfg: dict, traffic: dict, ctx):
    """The program's model and communicator, and ``new_step()``: a fresh
    AdamW under the wrapper and its train step, ``(inner, wrapper,
    step)``; ``ctx.fault`` ``half_batch`` plants that fault."""
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.ops import make_flash_attention_fn
    from chainermn_tpu_torch.ops.fused_ce import fused_cross_entropy

    comm = create_communicator(cfg["communicator"], device=ctx.device)
    model = TransformerLM(
        vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        d_ff=cfg["d_ff"], n_layers=cfg["n_layers"],
        max_len=max(cfg["n_ctx"], traffic["seq"]), dtype=torch.bfloat16,
        attention_fn=make_flash_attention_fn(causal=True),
        device=ctx.device, seed=ctx.seed % 2**63)

    def new_step():
        inner = torch.optim.AdamW(model.parameters(), lr=cfg["lr"],
                                  betas=tuple(cfg["adam_betas"]),
                                  eps=cfg["adam_eps"],
                                  weight_decay=cfg["weight_decay"])
        opt = create_multi_node_optimizer(inner, comm)
        half = ctx.fault == "half_batch"

        def loss_fn(batch):
            toks, labs = batch
            if half:       # half the rows, or of one row's tokens
                cut = ((slice(len(toks) // 2),) if len(toks) > 1 else
                       (slice(None), slice(toks.shape[1] // 2)))
                toks, labs = toks[cut], labs[cut]
            h = model(toks, return_hidden=True)
            return fused_cross_entropy(h, model.embed.weight, labs)

        return inner, opt, opt.make_train_step(loss_fn, local_batch=True)

    return model, comm, new_step


def first_grad_norms(torch, model, inner, cfg) -> dict:
    """The norm of each parameter's first-step gradient from AdamW's state
    after one step: exp_avg = (1 - beta1) g."""
    b1 = cfg["adam_betas"][0]
    return {n: _state_norm(torch, inner, p, "exp_avg") / (1 - b1)
            for n, p in model.named_parameters()}


def _state_norm(torch, inner, p, key):
    """The norm of ``p``'s optimizer state ``key``; NaN where the
    optimizer holds none (it never stepped)."""
    t = inner.state.get(p, {}).get(key)
    return t.norm() if t is not None else torch.tensor(float("nan"))

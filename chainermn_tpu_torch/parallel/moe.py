"""Expert parallelism — mixture-of-experts with all-to-all token routing.
Port of ``chainermn_tpu/parallel/moe.py``.

Experts are sharded over the ranks of a communicator (the reference's
``axis_name``), ``experts_per_device`` a rank, device-major: rank ``d``
owns global experts ``d * epd .. (d+1) * epd - 1``.  Tokens are routed
to their experts' ranks with one all-to-all, the local experts run, and a
second all-to-all routes the results back
(:func:`chainermn_tpu_torch.functions.alltoall`, differentiable).
Capacity-based dispatch keeps shapes fixed: each rank sends exactly
``capacity`` token slots to every expert (zeros, weighted 0, where
unused), whatever the routing.  The dispatch and combine products are
plain einsums, as the reference leaves them to XLA; the reference's
``vmap`` over local experts is a loop here.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
import torch.nn.functional as F

from ..functions import alltoall


def topk_route(gate_logits, n_experts: int, capacity: int, k: int = 1):
    """Top-k routing with per-(rank, expert) capacity (GShard-style).

    ``gate_logits``: (T, E).  Returns ``(dispatch, combine)``, both
    (E, C, T) fp32: ``dispatch`` the one-hot slot of each granted
    (token, choice), ``combine`` the same times the gate weight.  With
    ``k > 1`` each token goes to its k most probable experts, the gates
    renormalized over the chosen set, and first choices claim capacity
    slots before second choices (choice-major priority)."""
    T, E = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    onehots, gates = [], []
    remaining = probs
    for _ in range(k):
        idx = remaining.argmax(-1)
        oh = F.one_hot(idx, E).float()                       # (T, E)
        gate = (remaining * oh).sum(-1)                      # raw prob
        # A choice from zero remaining mass is argmax's spurious index 0:
        # drop it instead of burning a capacity slot.
        oh = oh * (gate > 0).float()[:, None]
        gates.append(gate)
        onehots.append(oh)
        remaining = remaining * (1.0 - oh)
    if k > 1:
        # GShard renormalizes over the chosen set; top-1 keeps the router
        # probability (Switch), so the router still gets a gradient.
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    dev = gate_logits.device
    dispatch = torch.zeros(E, capacity, T, device=dev)
    combine = torch.zeros(E, capacity, T, device=dev)
    claimed = torch.zeros(E, device=dev)     # slots used by earlier choices
    for oh, gate in zip(onehots, gates):
        # Position in the expert's queue: arrival order within the
        # choice, after the slots earlier choices claimed.
        pos = (torch.cumsum(oh, 0) - 1.0 + claimed[None, :]) * oh
        pos = pos - (1.0 - oh)                               # -1 off-expert
        kept = (pos >= 0) & (pos < capacity)
        slot = torch.where(kept, pos, torch.zeros_like(pos)).long()
        slot_onehot = F.one_hot(slot, capacity).float() * kept[..., None]
        d = torch.einsum("te,tec->ect", oh, slot_onehot)
        dispatch = dispatch + d
        combine = combine + d * gate[None, None, :]
        claimed = claimed + oh.sum(0)
    return dispatch, combine


def top1_route(gate_logits, n_experts: int, capacity: int):
    """Top-1 routing (Switch-style) — see :func:`topk_route`."""
    return topk_route(gate_logits, n_experts, capacity, k=1)


def load_balancing_loss(gate_logits, n_experts: int):
    """Switch-Transformer auxiliary loss ``E * sum_e f_e P_e`` (``f_e`` the
    share of tokens whose top-1 expert is ``e``, ``P_e`` the mean router
    probability of ``e``): 1.0 under uniform routing, larger as routing
    collapses."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    top1 = F.one_hot(probs.argmax(-1), n_experts).float()
    return n_experts * (top1.mean(0) * probs.mean(0)).sum()


def _expert(tree, e: int):
    """Expert ``e`` of a tree whose every leaf leads with the expert axis."""
    if isinstance(tree, torch.Tensor):
        return tree[e]
    if isinstance(tree, dict):
        return {key: _expert(val, e) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_expert(val, e) for val in tree)
    raise TypeError(f"expert parameters must be tensors or dicts, lists and "
                    f"tuples of them, got {type(tree).__name__}")


def moe_layer(x, gate_w, expert_fn: Callable, expert_params, comm,
              capacity_factor: float = 2.0, k: int = 1,
              return_aux: bool | str = False,
              experts_per_device: int = 1):
    """Expert-parallel MoE FFN on this rank's tokens ``x`` (T_local, D).

    ``gate_w``: (D, E) router weights, the same on every rank, with ``E =
    comm.size * experts_per_device``.  ``expert_params``: THIS rank's
    experts — the bare parameters for one expert a rank, else a tree whose
    every leaf leads with an ``experts_per_device`` axis.
    ``expert_fn(params, tokens) -> tokens`` is one expert.  ``k``: experts
    per token (1 = Switch, 2 = GShard).  ``return_aux=True`` also returns
    ``{"load_balance_loss", "dropped_fraction"}`` for this rank's tokens
    (the fraction of the k T routings granted no slot);
    ``return_aux="scalar"`` is the deprecated ``(y, load_balance_loss)``
    form and warns.  Returns (T_local, D): each token replaced by its
    experts' outputs weighted by the gates (dropped tokens give zeros)."""
    n = comm.size
    epd = experts_per_device
    if epd < 1:
        raise ValueError(f"experts_per_device must be >= 1, got {epd}")
    E = n * epd
    T, D = x.shape
    if gate_w.shape[1] != E:
        raise ValueError(
            f"gate_w routes to {gate_w.shape[1]} experts but the layout "
            f"is {n} devices x {epd} experts/device = {E}")
    capacity = max(1, int(capacity_factor * k * T / E))

    gate_logits = x @ gate_w                                # (T, E)
    dispatch, combine = topk_route(gate_logits, E, capacity, k=k)
    expert_in = torch.einsum("ect,td->ecd", dispatch, x.float())
    # The device-major expert axis splits into n chunks of epd: rank d
    # receives ITS experts' slots from every source, (source, expert).
    expert_in = alltoall(comm, expert_in, split_axis=0, concat_axis=0)
    if epd == 1:
        flat = expert_in.reshape(n * capacity, D).to(x.dtype)
        out = expert_fn(expert_params, flat).float().reshape(n, capacity, D)
    else:
        grp = (expert_in.reshape(n, epd, capacity, D).transpose(0, 1)
               .reshape(epd, n * capacity, D).to(x.dtype))
        out = torch.stack([expert_fn(_expert(expert_params, e), grp[e])
                           for e in range(epd)]).float()
        out = (out.reshape(epd, n, capacity, D).transpose(0, 1)
               .reshape(E, capacity, D))
    out = alltoall(comm, out.reshape(E, capacity, D), split_axis=0,
                   concat_axis=0)
    y = torch.einsum("ect,ecd->td", combine, out).to(x.dtype)
    if not return_aux:
        return y
    aux = {"load_balance_loss": load_balancing_loss(gate_logits, E),
           # One 1 in dispatch per GRANTED (token, choice) of the k T asked.
           "dropped_fraction": 1.0 - dispatch.sum() / (k * T)}
    if return_aux == "scalar":
        warnings.warn(
            "moe_layer(return_aux='scalar') is deprecated: return_aux=True "
            "now returns (y, aux_dict); read aux['load_balance_loss'] "
            "instead.  The 'scalar' shim will be removed next release.",
            DeprecationWarning, stacklevel=2)
        return y, aux["load_balance_loss"]
    return y, aux


def dense_moe_oracle(x, gate_w, expert_fn: Callable, all_expert_params,
                     capacity_factor: float = 2.0, k: int = 1):
    """One-device oracle: the same routing with every expert local;
    ``all_expert_params`` leads with the global expert axis."""
    E = gate_w.shape[1]
    T, D = x.shape
    capacity = max(1, int(capacity_factor * k * T / E))
    dispatch, combine = topk_route(x @ gate_w, E, capacity, k=k)
    expert_in = torch.einsum("ect,td->ecd", dispatch, x.float())
    out = torch.stack([
        expert_fn(_expert(all_expert_params, e),
                  expert_in[e].to(x.dtype)).float() for e in range(E)])
    return torch.einsum("ect,ecd->td", combine, out).to(x.dtype)

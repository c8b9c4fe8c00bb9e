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

:class:`DroplessMoE` has no reference counterpart: a token-choice layer
that holds a slice of the experts, routes over all of them and computes
every held assignment (no capacity, nothing dropped) through the sorted
dispatch of :mod:`~chainermn_tpu_torch.ops.moe_dispatch`, with a shared
expert and an auxiliary-loss-free balancing bias.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..functions import alltoall
from ..observability import reporter as _reporter
from ..observability import spans as _spans
from ..ops import moe_dispatch as _md


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


class SwiGLUFeedForward(nn.Module):
    """``down(silu(gate x) * up x)``, bias-free, products in ``dtype``."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.gate = nn.Linear(d_model, d_ff, bias=False)
        self.up = nn.Linear(d_model, d_ff, bias=False)
        self.down = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        h = _md.swiglu(F.linear(x, self.gate.weight.to(dt)),
                       F.linear(x, self.up.weight.to(dt)))
        return F.linear(h, self.down.weight.to(dt))


#: Device spans of :class:`DroplessMoE` whose time the Reporter's counters
#: also carry (``device_ms/<name>``): the forward and the backward.
for _name in ("moe", "moe/backward"):
    _spans.count_device_time(_name)


class DroplessMoE(nn.Module):
    """Token-choice mixture of experts that drops nothing, holding experts
    ``[first, first + count)`` of ``n_experts``.

    Routing (over all ``n_experts``, in fp32): ``s = sigmoid(router x)``;
    each token's ``top_k`` experts by ``s + expert_bias`` (the bias
    selects, it never weighs); gates ``route_scale * s_i / sum s_I`` over
    the whole chosen set.  The output is the held experts' SwiGLU outputs
    weighted by their gates, plus the shared expert (width ``n_shared *
    d_expert``) on every token.  Expert matrices are stored 2-D with their
    input width last: ``experts_gate``, ``experts_up`` ``(count *
    d_expert, d_model)``, ``experts_down`` ``(count * d_model,
    d_expert)``.

    ``counts`` (a buffer outside the state dict) adds up each of the
    ``n_experts``' assignments over the training forwards since the last
    :meth:`update_bias`, which moves ``expert_bias`` by ``bias_rate *
    sign(mean - count)`` (auxiliary-loss-free balancing) and clears them;
    :meth:`register_bias_update` runs it before every step of an
    optimizer.  No host synchronisation; no Python loop over experts.

    The exchange of tokens between ranks that hold different experts is
    not here: a ``comm`` of more than one rank is refused.

    Inside a traced train step the forward runs under the device spans
    ``moe``, ``moe/route`` and ``moe/experts``, the backward under
    ``moe/backward``; with a Reporter installed each call counts
    ``moe/calls``, ``moe/assignments_total``, ``moe/assignments_held`` and
    ``moe/max_expert_load`` (the largest held expert's assignments),
    resolved without a synchronisation."""

    def __init__(self, d_model: int, d_expert: int, n_experts: int,
                 top_k: int, first: int = 0, count: int | None = None,
                 route_scale: float = 1.0, n_shared: int = 1,
                 bias_rate: float = 1e-3, dtype=torch.bfloat16, comm=None):
        super().__init__()
        count = n_experts - first if count is None else count
        if comm is not None and comm.size > 1:
            raise NotImplementedError(
                f"DroplessMoE on {comm.size} ranks needs the exchange of "
                "tokens between the ranks' experts (a variable-size "
                "all-to-all), which it does not have: run it on one rank")
        if not (0 <= first and 1 <= count and first + count <= n_experts):
            raise ValueError(f"held experts [{first}, {first + count}) must "
                             f"lie in [0, {n_experts})")
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k must lie in [1, {n_experts}]")
        self.d_model, self.d_expert = d_model, d_expert
        self.n_experts, self.top_k = n_experts, top_k
        self.first, self.count = first, count
        self.route_scale, self.bias_rate = route_scale, bias_rate
        self.dtype = dtype
        self.router = nn.Linear(d_model, n_experts, bias=False)
        self.register_buffer("expert_bias", torch.zeros(n_experts))
        self.register_buffer("counts", torch.zeros(n_experts),
                             persistent=False)
        self.experts_gate = nn.Parameter(torch.empty(count * d_expert,
                                                     d_model))
        self.experts_up = nn.Parameter(torch.empty(count * d_expert, d_model))
        self.experts_down = nn.Parameter(torch.empty(count * d_model,
                                                     d_expert))
        self.shared = SwiGLUFeedForward(d_model, n_shared * d_expert, dtype)

    def route(self, x):
        """``(idx, g)``: each token's ``top_k`` global experts (T, k) and
        their gates (T, k) fp32, differentiable in ``x`` and the router."""
        s = torch.sigmoid(F.linear(x.float(), self.router.weight.float()))
        idx = torch.topk(s.detach() + self.expert_bias, self.top_k,
                         dim=-1).indices
        chosen = s.gather(1, idx)
        return idx, self.route_scale * chosen / chosen.sum(-1, keepdim=True)

    def _experts(self, x, g, plan):
        dt, F_, D, c = self.dtype, self.d_expert, self.d_model, self.count
        xs = _md.permute(x, plan)
        wg = self.experts_gate.to(dt).view(c, F_, D).transpose(1, 2)
        wu = self.experts_up.to(dt).view(c, F_, D).transpose(1, 2)
        wd = self.experts_down.to(dt).view(c, D, F_).transpose(1, 2)
        h = _md.swiglu(_md.grouped_mm(xs, wg, plan.offs),
                       _md.grouped_mm(xs, wu, plan.offs))
        return _md.combine(_md.grouped_mm(h, wd, plan.offs), g, plan)

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, self.d_model).to(self.dtype)
        with _spans.step_span("moe"):
            with _spans.step_span("moe/route"):
                idx, g = self.route(x)
                plan = _md.dispatch_plan(idx, self.first, self.count)
            if self.training and torch.is_grad_enabled():
                with torch.no_grad():
                    self.counts.scatter_add_(
                        0, idx.reshape(-1),
                        torch.ones(idx.numel(), device=idx.device,
                                   dtype=self.counts.dtype))
            self._count(idx, plan)
            with _spans.step_span("moe/experts"):
                y = self._experts(x, g, plan)
            y = y + self.shared(x)
        if torch.is_grad_enabled() and y.requires_grad:
            self._time_backward(x, y)
        return y.view(shape)

    @staticmethod
    def _count(idx, plan):
        if _reporter.get_reporter() is not None:
            _spans.count_on_device({
                "moe/calls": torch.ones((), device=idx.device),
                "moe/assignments_total": torch.full((), idx.numel(),
                                                    device=idx.device),
                "moe/assignments_held": plan.sizes.sum(),
                "moe/max_expert_load": plan.sizes.max()})

    @staticmethod
    def _time_backward(x, y):
        """Open ``moe/backward`` when the output's gradient arrives and
        close it when the input's is complete (inside a traced step)."""
        if _spans.traced_device() is None:
            return
        open_ = []

        def start(grad):
            cm = _spans.step_span("moe/backward")
            cm.__enter__()
            open_.append(cm)

        def end(grad):
            while open_:
                open_.pop().__exit__(None, None, None)

        y.register_hook(start)
        if x.requires_grad:
            x.register_hook(end)
        else:
            y.register_hook(end)

    @torch.no_grad()
    def update_bias(self):
        """``expert_bias += bias_rate * sign(mean(counts) - counts)``; the
        counts start again from zero."""
        c = self.counts
        self.expert_bias.add_(torch.sign(c.mean() - c), alpha=self.bias_rate)
        c.zero_()

    def reset_counts(self):
        self.counts.zero_()


def moe_layers(module: nn.Module):
    """The :class:`DroplessMoE` layers of ``module``."""
    return [m for m in module.modules() if isinstance(m, DroplessMoE)]


def register_bias_update(module: nn.Module, optimizer):
    """Move every :class:`DroplessMoE` bias of ``module`` once before each
    ``optimizer.step()`` (a step pre-hook); returns the hook's handle."""
    layers = moe_layers(module)

    def hook(opt, args, kwargs):
        for m in layers:
            m.update_bias()

    return optimizer.register_step_pre_hook(hook)

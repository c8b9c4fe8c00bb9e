"""The optax pieces of the examples, as ``torch.optim`` code.

* :func:`linear_schedule` is ``optax.linear_schedule``: a function of the
  update count, which starts at 0, so the first update takes
  ``init_value`` (0 in the example's warm-up).  The multi-node optimizer
  takes it as ``lr_schedule`` and counts updates: under double buffering
  the reduce-only first step is not one.
* :func:`warmup_cosine_decay_schedule` is optax's: the same count, so the
  WMT example's first AdamW update runs at learning rate 0, which still
  moves Adam's moments (and its bias-correction count), under optax and
  under ``torch.optim.AdamW`` alike.
* ``optax.sgd(lr, momentum=m)`` is ``torch.optim.SGD(params, lr,
  momentum=m)`` (``dampening=0``, no Nesterov, no weight decay): both add
  the gradient to the decayed trace first and scale the trace by the
  learning rate after.
* :class:`LARS` is ``optax.lars(lr, weight_decay=wd, momentum=m)``, whose
  order differs from torch SGD's: add ``wd * p``, scale by the trust
  ratio ``trust_coefficient * ||p|| / ||u||`` (1 where either norm is 0),
  scale by the learning rate, and only then the momentum trace.  The
  ratio is per parameter tensor; under ZeRO the multi-node optimizer
  rebuilds it over one flat shard, so the ratio is per shard there, as in
  the reference, which hands optax the flat shard.
* :class:`OptaxAdamW` is ``optax.adamw`` in optax's order of operations
  (the ViT and long-context examples).
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: ``init_value`` at count 0, linear to
    ``end_value`` at ``transition_steps``, held there after; a constant
    ``init_value`` when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init_value`` times
    ``(1 - alpha) * (0.5 * (1 + cos(pi * t / T))) ** exponent + alpha``
    with ``t = min(count, T)``."""
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps`` updates, then a cosine decay
    to ``end_value`` at ``decay_steps`` (which counts the warm-up)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)

    def schedule(count: int) -> float:
        return (warmup(count) if count < warmup_steps
                else decay(count - warmup_steps))

    return schedule


class LARS(torch.optim.Optimizer):
    """``optax.lars`` with ``eps=0``, no masks and no Nesterov."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9,
                 weight_decay: float = 0.0, trust_coefficient: float = 0.001):
        if lr < 0.0 or weight_decay < 0.0 or not 0.0 <= momentum < 1.0:
            raise ValueError(f"invalid LARS hyperparameters: lr={lr}, "
                             f"momentum={momentum}, "
                             f"weight_decay={weight_decay}")
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      trust_coefficient=trust_coefficient))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if group["weight_decay"]:
                    u = u.add(p, alpha=group["weight_decay"])
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                    group["trust_coefficient"] * pn / un)
                u = u * ratio * group["lr"]
                state = self.state[p]
                buf = state.get("momentum_buffer")
                if buf is None:
                    buf = state["momentum_buffer"] = u.clone()
                else:
                    buf.mul_(group["momentum"]).add_(u)
                p.sub_(buf)
        return loss


class OptaxAdamW(torch.optim.Optimizer):
    """``optax.adamw(lr, b1, b2, eps, weight_decay)`` in optax's order of
    operations: the moments, the bias corrections ``1 - b ** count`` in
    fp32, ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * p``,
    times ``-lr``, added to the parameters.  :meth:`update` takes the
    gradients as a list (and scales the update by ``scale``: the ViT
    example's double-buffered step 0 runs it with 0); :meth:`step` takes
    them from ``.grad`` (zeros where there is none), so the multi-node
    optimizer can wrap it.  One parameter group; ``count`` is optax's
    update count, kept in the group so that checkpoints carry it."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, count=0))
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdamW takes one parameter group")

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def update(self, grads, scale: float = 1.0):
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["b1"], group["b2"]
        for p in params:
            if p not in self.state or not self.state[p]:
                self.state[p] = {"mu": torch.zeros_like(p),
                                 "nu": torch.zeros_like(p)}
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        group["count"] += 1
        c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) **
                        group["count"]) for b in (b1, b2))
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params,
                                                    group["weight_decay"]))
        torch._foreach_mul_(upd, -group["lr"])
        if scale != 1.0:
            torch._foreach_mul_(upd, scale)
        torch._foreach_add_(params, upd)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.update([torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.param_groups[0]["params"]])
        return loss

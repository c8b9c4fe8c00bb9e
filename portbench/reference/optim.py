"""Plain optimizer updates over lists of fp32 tensors, written out from
their papers: AdamW (Loshchilov & Hutter 2019; decoupled decay applied to
the parameter before the Adam step, bias-corrected moments) and SGD with
heavy-ball momentum (the first step's buffer is the gradient)."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params, lr, betas, eps, weight_decay):
        self.params = list(params)
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


class SGD:
    def __init__(self, params, lr, momentum):
        self.params = list(params)
        self.lr, self.mu = lr, momentum
        self.buf = None

    @torch.no_grad()
    def step(self, grads):
        if self.buf is None:
            self.buf = [g.clone() for g in grads]
        else:
            for b, g in zip(self.buf, grads):
                b.mul_(self.mu).add_(g)
        for p, b in zip(self.params, self.buf):
            p.sub_(self.lr * b)


def make(kind: str, params, cfg: dict):
    """The optimizer a configuration names (``adamw`` or ``sgd``)."""
    if kind == "adamw":
        return AdamW(params, cfg["lr"], tuple(cfg["adam_betas"]),
                     cfg["adam_eps"], cfg["weight_decay"])
    if kind == "sgd":
        return SGD(params, cfg["lr"], cfg["momentum"])
    raise ValueError(f"unknown optimizer {kind!r}")

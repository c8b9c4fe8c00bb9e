"""Pseudo-connect — port of ``chainermn_tpu/functions/pseudo_connect.py``
(ChainerMN's ``PseudoConnect``).

:func:`pseudo_connect` returns its actual tensors unchanged (views of
them) through one autograd node that also takes the delegate's token as
an input, so that backward from those tensors reaches the delegate's
``Send`` even when the sent value has no local consumer.  Given another
delegate as the "actual", it merges the two into one delegate whose
backward reaches both sends.
"""

from __future__ import annotations

import torch

from .point_to_point import DelegateVariable, _flatten, _unflatten


class _Graft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, *xs):
        ctx.token = (token.shape, token.dtype, token.device)
        outs = tuple(x.view_as(x) for x in xs)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, device = ctx.token
        token_grad = (torch.zeros(shape, dtype=dtype, device=device)
                      if ctx.needs_input_grad[0] else None)
        return (token_grad, *grads)


def _token(delegate) -> torch.Tensor:
    return (delegate.token if isinstance(delegate, DelegateVariable)
            else delegate)


def _graft(token, leaves):
    if not (torch.is_grad_enabled() and token.requires_grad):
        return list(leaves)
    return list(_Graft.apply(token, *leaves))


def pseudo_connect(delegate_variable, *actual_variables):
    """``actual_variables`` unchanged, with ``delegate_variable`` (a
    :class:`DelegateVariable` or its token) grafted into their graph; a
    :class:`DelegateVariable` among them is merged with it.  With no
    actuals the delegate is returned as it is."""
    if not actual_variables:
        return delegate_variable
    token = _token(delegate_variable)
    out = []
    for v in actual_variables:
        if isinstance(v, DelegateVariable):
            merged = _graft(token, [v.token])[0]
            out.append(DelegateVariable(merged, v.payload, v.dst))
        else:
            leaves, spec = _flatten(v)
            out.append(_unflatten(_graft(token, leaves), spec))
    return out[0] if len(out) == 1 else tuple(out)

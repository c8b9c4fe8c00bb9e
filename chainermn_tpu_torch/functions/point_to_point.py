"""Differentiable point-to-point communication — port of
``chainermn_tpu/functions/point_to_point.py``.

The reference describes every rank in one traced SPMD program, so a
transfer there is one ``lax.ppermute`` that JAX differentiates.  A
process a rank brings back ChainerMN's own design (SURVEY §3.3):

* :func:`send` sends ``x`` to a peer and returns a
  :class:`DelegateVariable`, whose ``token`` is a zero-size tensor made by
  the autograd function ``_Send``: its backward *receives* the gradient
  of ``x`` from the peer;
* :func:`recv` receives from a peer through ``_Recv``, whose backward
  *sends* the gradient back; a delegate passed to it becomes an input of
  that node, so that this rank's backward runs the receive's send before
  the earlier send's receive, the reverse of the forward order, as the
  peer's does;
* :func:`~chainermn_tpu_torch.functions.pseudo_connect` grafts a delegate
  into tensors that reach the loss, so that backward reaches a send whose
  value has no local consumer.

The payload is a tensor or a (nested) tuple or list of tensors.  Before
it, the sender sends a header on the same process group: its length,
then the structure and each leaf's dtype, shape and whether it carries
a gradient.  Both travel on the communicator's device group (NCCL on the
card, gloo on the CPU), as tensors on its device; nothing is pickled.
Sends and receives are blocking, so both sides must issue them in the
same order, in forward and in backward.

Two deliberate divergences from the reference's signatures, which name
both ends because one program holds both: ``src`` is accepted and must
equal ``comm.rank``; and :func:`recv` takes no delegate on a receiving
process (its normal form), where the reference raises.  A transfer from
a rank to itself is a local pass-through that keeps the gradient path:
the delegate carries the payload, and :func:`recv` from this rank itself
takes that delegate.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

# Model-plane transfers use their own tag, clear of the object plane's
# (on a gloo-only job both planes share one group).
_TAG_P2P = 1 << 25

_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)


class DelegateVariable(NamedTuple):
    """The reference's zero-size delegate variable.  ``token`` carries the
    send's place in this rank's graph; ``payload`` is the value itself
    only for a send to this rank itself (``None`` otherwise)."""

    token: torch.Tensor
    payload: Any = None
    dst: int = -1

    def __add__(self, other):
        from .pseudo_connect import pseudo_connect

        return pseudo_connect(self, other)


def _flatten(tree):
    """Leaves and structure of a tensor or a nested tuple/list of them;
    the structure is ``None`` for a tensor, else a tuple of children's."""
    if isinstance(tree, torch.Tensor):
        return [tree], None
    if isinstance(tree, (tuple, list)):
        leaves, spec = [], []
        for child in tree:
            sub, s = _flatten(child)
            leaves += sub
            spec.append(s)
        return leaves, tuple(spec)
    raise TypeError(f"payload must be a tensor or a tuple/list of them, "
                    f"got {type(tree).__name__}")


def _unflatten(leaves, spec):
    it = iter(leaves)

    def build(s):
        return next(it) if s is None else tuple(build(c) for c in s)

    return build(spec)


def _spec_ints(spec, out):
    if spec is None:
        out.append(-1)
    else:
        out.append(len(spec))
        for s in spec:
            _spec_ints(s, out)
    return out


def _spec_of(ints, pos=0):
    n = ints[pos]
    if n < 0:
        return None, pos + 1
    pos += 1
    children = []
    for _ in range(n):
        child, pos = _spec_of(ints, pos)
        children.append(child)
    return tuple(children), pos


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _check_peer(comm, rank, what):
    if not 0 <= rank < comm.size:
        raise ValueError(f"{what} rank {rank} outside the communicator's "
                         f"{comm.size} ranks")


def _send_tensor(comm, t, peer):
    dist.send(t.contiguous(), comm._global(peer), group=comm.group,
              tag=_TAG_P2P)


def _recv_tensor(comm, shape, dtype, peer):
    t = torch.empty(shape, dtype=dtype, device=comm.device)
    dist.recv(t, comm._global(peer), group=comm.group, tag=_TAG_P2P)
    return t


def encode_header(spec, leaves, grads) -> list:
    """The payload's header as ints: its structure, then each leaf's
    dtype, whether it carries a gradient, rank and shape."""
    ints = _spec_ints(spec, [])
    for t, g in zip(leaves, grads):
        ints += [_DTYPES.index(t.dtype), int(g), t.dim(), *t.shape]
    return ints


def decode_header(ints):
    """``(spec, [(shape, dtype, carries_grad)])`` from
    :func:`encode_header`'s ints."""
    spec, pos = _spec_of(ints)
    metas = []
    while pos < len(ints):
        dtype, grad, ndim = ints[pos:pos + 3]
        shape = tuple(ints[pos + 3:pos + 3 + ndim])
        metas.append((shape, _DTYPES[dtype], bool(grad)))
        pos += 3 + ndim
    return spec, metas


def _send_header(comm, peer, spec, leaves, grads):
    body = torch.tensor(encode_header(spec, leaves, grads),
                        dtype=torch.int64, device=comm.device)
    _send_tensor(comm, torch.tensor([body.numel()], dtype=torch.int64,
                                    device=comm.device), peer)
    _send_tensor(comm, body, peer)


def _recv_header(comm, peer):
    """``(spec, [(shape, dtype, carries_grad)])`` of the next payload."""
    n = int(_recv_tensor(comm, (1,), torch.int64, peer)[0])
    return decode_header(_recv_tensor(comm, (n,), torch.int64, peer).tolist())


class _Send(torch.autograd.Function):
    """Forward sends the leaves and returns the zero-size token; backward
    receives the gradient of every leaf that carries one."""

    @staticmethod
    def forward(ctx, comm, peer, *leaves):
        for t in leaves:
            _send_tensor(comm, t, peer)
        ctx.comm, ctx.peer = comm, peer
        ctx.metas = [(t.shape, t.dtype) for t in leaves]
        return torch.empty(0, device=comm.device)

    @staticmethod
    def backward(ctx, _token_grad):
        grads = [_recv_tensor(ctx.comm, shape, dtype, ctx.peer) if need
                 else None
                 for need, (shape, dtype) in zip(ctx.needs_input_grad[2:],
                                                 ctx.metas)]
        return (None, None, *grads)


class _Recv(torch.autograd.Function):
    """Forward receives the leaves; backward sends back the gradient of
    every leaf that carries one (zeros where none arrived) and gives the
    token a zero-size gradient, so that the delegate's send runs its
    backward after this."""

    @staticmethod
    def forward(ctx, comm, peer, metas, token):
        outs = [_recv_tensor(comm, shape, dtype, peer)
                for shape, dtype, _ in metas]
        ctx.comm, ctx.peer, ctx.metas = comm, peer, metas
        ctx.mark_non_differentiable(
            *[o for o, (_, _, g) in zip(outs, metas) if not g])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        for g, (shape, dtype, carries) in zip(grads, ctx.metas):
            if carries:
                if g is None:
                    g = torch.zeros(shape, dtype=dtype, device=ctx.comm.device)
                _send_tensor(ctx.comm, g.to(dtype), ctx.peer)
        token_grad = (torch.zeros(0, device=ctx.comm.device)
                      if ctx.needs_input_grad[3] else None)
        return None, None, None, token_grad


def _local_token(leaves) -> torch.Tensor:
    """A zero-size tensor on the graph of ``leaves`` (a send to self)."""
    parts = [t.reshape(-1)[:0].float() for t in leaves
             if t.is_floating_point()]
    return torch.cat(parts) if parts else torch.empty(0)


def send(x, communicator, rank: int, src: int | None = None
         ) -> DelegateVariable:
    """Send ``x`` (a tensor or a tuple of them) to ``rank`` and return the
    delegate: its ``token`` requires grad when ``x`` does, and backward
    through it receives the gradient of ``x`` from ``rank``.  ``src`` (the
    reference's explicit sender) must be this rank when given."""
    comm = communicator
    if src is not None and src != comm.rank:
        raise ValueError(f"send(src={src}) on rank {comm.rank}: a process "
                         "sends only its own values")
    _check_peer(comm, rank, "send to")
    leaves, spec = _flatten(x)
    if rank == comm.rank:
        return DelegateVariable(_local_token(leaves), x, rank)
    grads = [_needs_grad(t) and t.is_floating_point() for t in leaves]
    _send_header(comm, rank, spec, leaves, grads)
    if any(grads):
        token = _Send.apply(comm, rank, *leaves)
    else:
        with torch.no_grad():
            token = _Send.apply(comm, rank, *leaves)
    return DelegateVariable(token, None, rank)


def recv(communicator, rank: int, delegate_variable=None):
    """Receive the payload the matching :func:`send` on ``rank`` sent (the
    same structure of tensors, on the communicator's device).  Backward
    through it sends the gradient back to ``rank``.  ``delegate_variable``
    (a delegate of an earlier send on this rank) orders this receive's
    backward before that send's.  From this rank itself it returns the
    payload of ``delegate_variable``, which must be the matching send's."""
    comm = communicator
    _check_peer(comm, rank, "recv from")
    if rank == comm.rank:
        if delegate_variable is None or delegate_variable.payload is None:
            raise ValueError(
                "recv from this rank itself needs the delegate_variable "
                "returned by the matching send(x, comm, rank)")
        return delegate_variable.payload
    spec, metas = _recv_header(comm, rank)
    token = None
    if delegate_variable is not None:
        token = (delegate_variable.token
                 if isinstance(delegate_variable, DelegateVariable)
                 else delegate_variable)
    if any(g for _, _, g in metas) and torch.is_grad_enabled():
        if token is None or not token.requires_grad:
            token = torch.empty(0, device=comm.device, requires_grad=True)
        outs = _Recv.apply(comm, rank, metas, token)
    else:
        outs = [_recv_tensor(comm, shape, dtype, rank)
                for shape, dtype, _ in metas]
    return _unflatten(outs, spec)


class _SendRecv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, src, dst, x):
        me = comm.rank
        ctx.comm, ctx.src, ctx.dst = comm, src, dst
        if me == dst:
            if src == dst:
                return x.clone()
            out = torch.empty_like(x)
            dist.recv(out, comm._global(src), group=comm.group, tag=_TAG_P2P)
            return out
        if me == src:
            _send_tensor(comm, x, dst)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        comm, src, dst, me = ctx.comm, ctx.src, ctx.dst, ctx.comm.rank
        if src == dst:
            return None, None, None, g if me == src else torch.zeros_like(g)
        if me == dst:
            _send_tensor(comm, g, src)
        if me == src:
            gx = torch.empty_like(g)
            dist.recv(gx, comm._global(dst), group=comm.group, tag=_TAG_P2P)
            return None, None, None, gx
        return None, None, None, torch.zeros_like(g)


def send_recv(x, communicator, src: int, dst: int):
    """Collective point-to-point: every rank calls it with an ``x`` of the
    same shape; ``dst`` gets ``src``'s value, every other rank zeros
    (the reference's SPMD form).  Backward sends the gradient at ``dst``
    back to ``src``; every rank must take the result into its backward."""
    _check_peer(communicator, src, "send_recv from")
    _check_peer(communicator, dst, "send_recv to")
    leaves, spec = _flatten(x)
    return _unflatten([_SendRecv.apply(communicator, src, dst, t)
                       for t in leaves], spec)


def _ring(comm, x, shift):
    n = comm.size
    if shift % n == 0:
        return x.clone()
    me = comm.rank
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      comm._global((me + shift) % n), comm.group,
                      _TAG_P2P),
           dist.P2POp(dist.irecv, out, comm._global((me - shift) % n),
                      comm.group, _TAG_P2P)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, shift, x):
        ctx.comm, ctx.shift = comm, shift
        return _ring(comm, x, shift)

    @staticmethod
    def backward(ctx, g):
        return None, None, _ring(ctx.comm, g, -ctx.shift)


def ring_exchange(x, communicator, shift: int = 1):
    """Rotate values around the ring: rank ``r`` gets rank
    ``(r - shift) % n``'s ``x`` (a tensor or a tuple of them); backward
    rotates the gradients the other way.  Collective."""
    leaves, spec = _flatten(x)
    return _unflatten([_RingExchange.apply(communicator, shift, t)
                       for t in leaves], spec)

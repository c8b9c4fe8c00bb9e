"""Microbatched pipeline parallelism, one process a stage — port of
``chainermn_tpu/parallel/pipeline.py``.

The reference stacks the stages along a mesh axis and runs each schedule
as one ``lax.scan`` over ticks with a ``ppermute`` shift per tick.  Here
each stage is its own process and the reference's ``axis_name`` is a
communicator (a sub-communicator from ``comm.split(("intra",))`` in a
data x pipeline layout): rank ``d`` of it holds stage ``d``.  Each
schedule keeps the reference's tick algebra — which unit (microbatch,
chunk) a rank runs at which tick — and at the end of a tick every rank
trades its activations and cotangents with its ring neighbours in one
``dist.batch_isend_irecv``, so that no order of blocking sends can hang
NCCL.  A rank computes only its active units: the fill and drain ticks
that the reference runs on zeros and masks are skipped, and every
microbatch meets the same arithmetic as in the reference.

* :func:`spmd_pipeline` (GPipe) and :func:`spmd_pipeline_circular` are
  autograd functions: the forward keeps each unit's stage input, and the
  backward runs the mirrored schedule, recomputing each stage from its
  saved input (the reference's ``jax.checkpoint`` per tick, what
  ``torch.utils.checkpoint`` does for one call), so memory holds O(M)
  stage inputs.
* :func:`pipeline_1f1b_loss_and_grads` and
  :func:`pipeline_interleaved_1f1b_loss_and_grads` return explicit
  gradients, as the reference does: at each tick a rank runs one forward
  and one backward unit, and keeps the graph of each forward until its
  backward (at most ``2nv - 1`` live graphs) instead of recomputing it.
* :func:`pipeline_circular_1f1b_loss_and_grads` differentiates the
  circular forward; :func:`pipeline_forward_and_loss` gives the GPipe
  loss on every rank.

``stage_fn(stage_params, x) -> y`` must be pure in ``stage_params`` (a
tensor, or nested dicts, lists and tuples of tensors; e.g.
``torch.func.functional_call`` of a module), and ``y`` has ``x``'s
microbatch shape and dtype.  For the chunked schedules every leaf of
``stage_params`` leads with the chunk axis ``v``.  ``x`` (and ``target``)
have the same shape on every rank; only stage 0 reads ``x``.  Every rank
of the communicator calls each function with the same ``n_microbatches``,
and every rank must take an autograd function's result into its backward,
since the backward exchanges cotangents too.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

# Tags of the schedules' transfers (gloo matches on them; NCCL matches
# sends and receives between a pair in the order they are issued, which
# is the forward stream's before the backward's on both sides).
_TAG_FWD = (1 << 25) + 1
_TAG_BWD = (1 << 25) + 2


# -- trees of tensors ---------------------------------------------------------

def _flatten(tree):
    """Leaves of a tensor or of nested dicts, lists and tuples of them, and
    a function that rebuilds the tree from new leaves."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"stage parameters must be tensors or dicts, lists "
                        f"and tuples of them, got {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, pos = [], 0
        for (_, build), size in zip(parts, sizes):
            out.append(build(new[pos:pos + size]))
            pos += size
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def _split(x, M: int):
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_microbatches {M}")
    return list(x.reshape(M, B // M, *x.shape[1:]).unbind(0))


def _check_rounds(M: int, n: int, v: int, what: str):
    if M % n:
        raise ValueError(
            f"{what} schedule needs n_microbatches ({M}) divisible by the "
            f"pipeline size ({n}) — admissions happen in rounds")
    if v < 1:
        raise ValueError(f"n_chunks must be >= 1, got {v}")


# -- the tick algebra (the reference's, unit for unit) ------------------------

def circular_unit(t: int, d: int, n: int, M: int, v: int):
    """Circular schedule: the ``(microbatch, chunk)`` rank ``d`` runs at
    tick ``t``, or ``None``.  Local time ``u = t - d``; round ``r = u //
    (n v)``, chunk ``l = (u % (n v)) // n``, microbatch ``r n + u % n``.
    With one chunk it is GPipe's: microbatch ``t - d``."""
    u = t - d
    if not 0 <= u < M * v:
        return None
    r, q = divmod(u, n * v)
    return r * n + q % n, q // n


def coupled_forward_unit(t: int, d: int, n: int, M: int, v: int):
    """1F1B and interleaved 1F1B: the forward ``(microbatch, chunk)`` of
    rank ``d`` at tick ``t``, or ``None`` — ``(m, s = l n + d)`` at tick
    ``r v n + s + j`` for ``m = r n + j``."""
    w = t - d
    if w < 0:
        return None
    r, u = divmod(w, n * v)
    m = r * n + u % n
    return (m, u // n) if m < M else None


def coupled_backward_unit(t: int, d: int, n: int, M: int, v: int):
    """The backward ``(microbatch, chunk)`` of rank ``d`` at tick ``t``, or
    ``None`` — ``(m, s)`` at tick ``r v n + j + 2(L - 1) - s``, ``L = n v``."""
    w = t - 2 * (n * v - 1) + d
    j = w % n
    z = (w - j) // n                # = r v - l
    r = (z + v - 1) // v            # ceil(z / v): the unique (r, l)
    m = r * n + j
    return (m, r * v - z) if 0 <= m < M else None


def coupled_schedule_ticks(n: int, n_microbatches: int, n_chunks: int) -> int:
    """Ticks of the coupled 1F1B schedule: ``M v + n v + n - 2``
    (``M + 2(n - 1)`` with one chunk)."""
    return n_microbatches * n_chunks + n * n_chunks + n - 2


def circular_schedule_ticks(n: int, n_microbatches: int, n_chunks: int) -> int:
    """Total forward ticks of the circular (buffered-admission) schedule:
    ``M*v + n - 1`` — each device is gapless for its ``M*v`` chunk units,
    offset by its ring position.  The backward (AD mirror) adds the same,
    so the whole step's bubble is ``2(n-1)`` chunk-times against an ideal
    ``2Mv`` — the Megatron-LM interleaved bound ``(n-1)/(v*M)``."""
    return n_microbatches * n_chunks + n - 1


# -- transfers ----------------------------------------------------------------

def _ready(comm):
    """Before a pipeline's first batched transfer on ``comm``'s group: one
    collective over the whole group (NCCL creates the group's communicator
    on the first call that coalesces point-to-point operations, and every
    rank must take part in it)."""
    if comm.size > 1 and not getattr(comm, "_p2p_ready", False):
        dist.all_reduce(torch.zeros(1, device=comm.device), group=comm.group)
        comm._p2p_ready = True


def _exchange(comm, sends, recvs):
    """One tick's transfers: ``sends`` and ``recvs`` are ``(tensor, peer,
    tag)`` lists, the forward stream's first.  A transfer from this rank to
    itself (the ring wrap of a one-rank pipeline) is a copy."""
    me = comm.rank
    local = {tag: t for t, p, tag in sends if p == me}
    for b, p, tag in recvs:
        if p == me:
            b.copy_(local[tag])
    ops = [dist.P2POp(dist.isend, t.contiguous(), comm._global(p), comm.group,
                      tag) for t, p, tag in sends if p != me]
    ops += [dist.P2POp(dist.irecv, b, comm._global(p), comm.group, tag)
            for b, p, tag in recvs if p != me]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _check_out(y, x, d):
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(
            f"stage {d} maps {tuple(x.shape)} {x.dtype} to {tuple(y.shape)} "
            f"{y.dtype}; pipeline stages keep the activation's shape and "
            "dtype")


def _chunk(leaves, l, chunked: bool):
    return [p[l] for p in leaves] if chunked else list(leaves)


def _vjp(stage_fn, rebuild, leaves, x, g, need_x: bool):
    """Recompute one stage from its saved input and return the gradients
    of its parameters and of its input for the output cotangent ``g``."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in leaves]
        xg = x.detach().requires_grad_(need_x)
        y = stage_fn(rebuild(ps), xg)
        ins = ps + ([xg] if need_x else [])
        gs = torch.autograd.grad(y, ins, g, allow_unused=True)
    gs = [torch.zeros_like(i) if gg is None else gg for gg, i in zip(gs, ins)]
    return gs[:len(ps)], (gs[-1] if need_x else None)


# -- the autograd schedules (GPipe and circular) ------------------------------

class _Schedule(torch.autograd.Function):
    """Forward: each rank runs its units of ``plan`` in tick order, feeding
    stage 0's first chunk from the microbatches and every other unit from
    the previous rank; the last global stage's outputs are the result
    (zeros on every other rank).  Backward: the same units in reverse tick
    order, each stage recomputed from its saved input."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        comm, stage_fn, rebuild, M, v, chunked = plan
        n, d = comm.size, comm.rank
        micro = _split(x.detach(), M)
        T = circular_schedule_ticks(n, M, v)
        saved, outs = {}, [None] * M
        state = None
        _ready(comm)
        with torch.no_grad():
            for t in range(T):
                sends, recvs = [], []
                unit = circular_unit(t, d, n, M, v)
                if unit is not None:
                    m, l = unit
                    xin = micro[m] if d == 0 and l == 0 else state
                    saved[unit] = xin
                    y = stage_fn(rebuild(_chunk(leaves, l, chunked)), xin)
                    _check_out(y, xin, d)
                    if d == n - 1 and l == v - 1:
                        outs[m] = y
                    else:
                        sends.append((y, (d + 1) % n, _TAG_FWD))
                nxt = circular_unit(t + 1, d, n, M, v)
                if nxt is not None and not (d == 0 and nxt[1] == 0):
                    state = torch.empty_like(micro[0])
                    recvs.append((state, (d - 1) % n, _TAG_FWD))
                _exchange(comm, sends, recvs)
        ctx.plan, ctx.saved = plan, saved
        ctx.leaves = [p.detach() for p in leaves]
        ctx.micro_shape = micro[0].shape
        if d == n - 1:
            return torch.cat(outs)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, gout):
        comm, stage_fn, rebuild, M, v, chunked = ctx.plan
        n, d = comm.size, comm.rank
        saved, ctx.saved = ctx.saved, None
        leaves = ctx.leaves
        gmicro = _split(gout, M) if d == n - 1 else None
        need_x = ctx.needs_input_grad[1]
        gacc = [torch.zeros_like(p) for p in leaves]
        gin = [None] * M
        state = None
        T = circular_schedule_ticks(n, M, v)
        for t in reversed(range(T)):
            sends, recvs = [], []
            unit = circular_unit(t, d, n, M, v)
            if unit is not None:
                m, l = unit
                g = gmicro[m] if d == n - 1 and l == v - 1 else state
                first = d == 0 and l == 0
                gp, gx = _vjp(stage_fn, rebuild, _chunk(leaves, l, chunked),
                              saved.pop(unit), g, need_x or not first)
                for acc, gg in zip(gacc, gp):
                    (acc[l] if chunked else acc).add_(gg)
                if first:
                    gin[m] = gx
                else:
                    sends.append((gx, (d - 1) % n, _TAG_BWD))
            prv = circular_unit(t - 1, d, n, M, v)
            if prv is not None and not (d == n - 1 and prv[1] == v - 1):
                state = gout.new_empty(ctx.micro_shape)
                recvs.append((state, (d + 1) % n, _TAG_BWD))
            _exchange(comm, sends, recvs)
        gx = None
        if need_x:
            gx = torch.cat(gin) if d == 0 else torch.zeros(
                (M * ctx.micro_shape[0], *ctx.micro_shape[1:]),
                dtype=gout.dtype, device=gout.device)
        return (None, gx, *[g if need else None for g, need in
                            zip(gacc, ctx.needs_input_grad[2:])])


def _run_schedule(stage_fn, stage_params, x, comm, M, v, chunked):
    leaves, rebuild = _flatten(stage_params)
    return _Schedule.apply((comm, stage_fn, rebuild, M, v, chunked), x,
                           *leaves)


def spmd_pipeline(
    stage_fn: Callable,
    stage_params,
    x,
    comm,
    n_microbatches: int,
):
    """GPipe over the ranks of ``comm``, differentiable through autograd.

    ``stage_fn(stage_params, activation) -> activation`` — one stage's
    compute; same activation shape in and out.  ``stage_params`` — THIS
    rank's stage parameters.  ``x`` — (B, ...) the full local batch, read
    on stage 0.  Returns (B, ...) final-stage outputs, valid on the LAST
    rank (zeros elsewhere).  Microbatch ``m`` runs on rank ``d`` at tick
    ``m + d``; the backward mirrors the schedule and recomputes each stage
    from its saved input."""
    M = n_microbatches
    _split(x, M)
    return _run_schedule(stage_fn, stage_params, x, comm, M, 1, False)


def spmd_pipeline_circular(
    stage_fn: Callable,
    stage_params,
    x,
    comm,
    n_microbatches: int,
    n_chunks: int,
):
    """Circular (virtual-stage) pipeline FORWARD with round-buffered
    admissions — the Megatron-tight interleaved schedule, differentiable
    through autograd.

    Rank ``d`` holds ``v = n_chunks`` model chunks (global stage ``s = l n
    + d``; every leaf of ``stage_params`` leads with the ``(v, ...)`` chunk
    axis).  Microbatches are admitted in rounds of ``n`` and each round is
    pushed through all ``v`` laps before the next; rank ``d`` at tick
    ``t`` runs the unit of :func:`circular_unit`, gapless over ``[d, d +
    M v)``, and every handoff (the ring wrap ``n - 1 -> 0`` between laps
    included) lands one tick before its use.  Ticks:
    :func:`circular_schedule_ticks`, each way.

    Returns ``(B, ...)`` final-stage outputs in microbatch order, valid on
    the LAST rank (zeros elsewhere)."""
    M, v = n_microbatches, n_chunks
    _split(x, M)
    _check_rounds(M, comm.size, v, "circular")
    return _run_schedule(stage_fn, stage_params, x, comm, M, v, True)


class _FromLast(torch.autograd.Function):
    """The last rank's scalar on every rank (a sum over the ranks of a
    value that is zero elsewhere); each rank's cotangent goes back to its
    own input, so a loss on every rank counts once."""

    @staticmethod
    def forward(ctx, comm, local):
        out = local.detach().clone()
        if comm.size > 1:
            dist.all_reduce(out, group=comm.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


def _connected_zero(out):
    """A zero scalar on ``out``'s graph: a rank whose value does not count
    still runs the schedule's (collective) backward."""
    return (out.sum() * 0.0).float()


def pipeline_forward_and_loss(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    target,
    comm,
    n_microbatches: int,
):
    """Pipeline forward + last-stage loss, the same value on every rank.

    ``loss_fn(final_activation, target) -> scalar`` runs on the last
    rank's outputs; the result is that loss on every rank, and backward
    from it on every rank trains every stage once (each rank gets the
    gradients of ITS stage parameters)."""
    out = spmd_pipeline(stage_fn, stage_params, x, comm, n_microbatches)
    if comm.rank == comm.size - 1:
        local = loss_fn(out, target)
    else:
        local = _connected_zero(out)
    return _FromLast.apply(comm, local)


# -- the explicit-gradient schedules ------------------------------------------

def _loss_and_cotangents(loss_fn, loss_params, y, tgt):
    """``(loss, d loss / d y, d loss / d loss_params leaves)``."""
    hleaves, hbuild = _flatten(loss_params)
    with torch.enable_grad():
        yd = y.detach().requires_grad_()
        hs = [h.detach().requires_grad_() for h in hleaves]
        if loss_params is None:
            mloss = loss_fn(yd, tgt)
        else:
            mloss = loss_fn(hbuild(hs), yd, tgt)
        gs = torch.autograd.grad(mloss, hs + [yd], allow_unused=True)
    gs = [torch.zeros_like(i) if g is None else g
          for g, i in zip(gs, hs + [yd])]
    return mloss.detach(), gs[-1], gs[:-1]


def _coupled(stage_fn, loss_fn, stage_params, x, target, comm, M, v,
             chunked, loss_params, with_input_grads):
    n, d = comm.size, comm.rank
    micro = _split(x.detach(), M)
    tmicro = _split(target, M)
    leaves, rebuild = _flatten(stage_params)
    leaves = [p.detach() for p in leaves]
    hleaves, hbuild = _flatten(loss_params)
    gacc = [torch.zeros_like(p) for p in leaves]
    hacc = [torch.zeros_like(h) for h in hleaves]
    lacc = torch.zeros((), dtype=torch.float32, device=x.device)
    gx_out = [None] * M
    live = {}
    fstate = bstate = None
    _ready(comm)
    for t in range(coupled_schedule_ticks(n, M, v)):
        sends, recvs = [], []
        unit = coupled_forward_unit(t, d, n, M, v)
        if unit is not None:
            m, l = unit
            first = d == 0 and l == 0
            xin = micro[m] if first else fstate
            with torch.enable_grad():
                ps = [p.detach().requires_grad_()
                      for p in _chunk(leaves, l, chunked)]
                xg = xin.detach().requires_grad_(
                    with_input_grads or not first)
                y = stage_fn(rebuild(ps), xg)
            _check_out(y, xin, d)
            fresh = None
            if d == n - 1 and l == v - 1:
                mloss, gy, gh = _loss_and_cotangents(loss_fn, loss_params,
                                                     y, tmicro[m])
                lacc = lacc + mloss.float()
                for acc, g in zip(hacc, gh):
                    acc.add_(g / M)
                fresh = gy / M
            else:
                sends.append((y.detach(), (d + 1) % n, _TAG_FWD))
            live[unit] = (y, ps, xg, fresh)
        unit = coupled_backward_unit(t, d, n, M, v)
        if unit is not None:
            m, l = unit
            y, ps, xg, fresh = live.pop(unit)
            g = fresh if fresh is not None else bstate
            ins = ps + ([xg] if xg.requires_grad else [])
            gs = torch.autograd.grad(y, ins, g, allow_unused=True)
            gs = [torch.zeros_like(i) if gg is None else gg
                  for gg, i in zip(gs, ins)]
            for acc, gg in zip(gacc, gs[:len(ps)]):
                (acc[l] if chunked else acc).add_(gg)
            if d == 0 and l == 0:
                if with_input_grads:
                    gx_out[m] = gs[-1]
            else:
                sends.append((gs[-1], (d - 1) % n, _TAG_BWD))
            del y, ps, xg, gs
        nxt = coupled_forward_unit(t + 1, d, n, M, v)
        if nxt is not None and not (d == 0 and nxt[1] == 0):
            fstate = torch.empty_like(micro[0])
            recvs.append((fstate, (d - 1) % n, _TAG_FWD))
        nxt = coupled_backward_unit(t + 1, d, n, M, v)
        if nxt is not None and not (d == n - 1 and nxt[1] == v - 1):
            bstate = torch.empty_like(micro[0])
            recvs.append((bstate, (d + 1) % n, _TAG_BWD))
        _exchange(comm, sends, recvs)
    loss = lacc / M
    if n > 1:
        dist.all_reduce(loss, group=comm.group)
    out = (loss, rebuild(gacc))
    if loss_params is not None:
        out = out + (hbuild(hacc),)
    if with_input_grads:
        out = out + (torch.cat(gx_out) if d == 0 else torch.zeros_like(x),)
    return out


def pipeline_1f1b_loss_and_grads(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    target,
    comm,
    n_microbatches: int,
    loss_params=None,
    with_input_grads: bool = False,
):
    """1F1B: pipelined forward AND backward with explicit gradients — no
    autograd over the schedule.

    At tick ``t`` stage ``s`` runs the forward of microbatch ``t - s`` and
    the backward of microbatch ``t - 2(n-1) + s``; a microbatch's backward
    trails its forward on the same stage by ``2(n-1-s)`` ticks, so at most
    ``2n - 1`` forward graphs are live on a rank, whatever the microbatch
    count.  ``M + 2(n-1)`` ticks.

    ``loss_fn(final_activation, target_microbatch) -> scalar`` (mean over
    the microbatch).  Returns ``(mean_loss, stage_grads)``: the loss on
    every rank, and each rank's gradients of ITS ``stage_params``.

    ``loss_params``: when given, ``loss_fn(loss_params, y, target)`` — the
    head runs inside the schedule and its gradients are appended:
    ``(loss, stage_grads, loss_param_grads)``, nonzero on the last stage
    (sum them over the ranks before use).  ``with_input_grads=True``
    appends ``input_grads`` of ``x``'s shape, the cotangent of the
    pipeline input, nonzero on stage 0 (sum before use)."""
    M = n_microbatches
    _split(x, M)
    return _coupled(stage_fn, loss_fn, stage_params, x, target, comm, M, 1,
                    False, loss_params, with_input_grads)


def pipeline_interleaved_1f1b_loss_and_grads(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    target,
    comm,
    n_microbatches: int,
    n_chunks: int,
    loss_params=None,
    with_input_grads: bool = False,
):
    """Interleaved (virtual-stage) 1F1B: ``v = n_chunks`` model chunks a
    rank, explicit gradients — the Megatron-LM interleaved schedule.

    Rank ``d`` owns global stages ``d, d+n, ..., d+(v-1)n``; every leaf
    of ``stage_params`` leads with the ``(v, ...)`` chunk axis.
    Microbatches circulate the ring ``v`` laps, admitted in rounds of
    ``n`` (``n_microbatches`` must divide by ``n``).  With ``L = n v``,
    ``m = r n + j`` and ``s = l n + d``:

        forward  of (m, s) on rank d at tick  t = r v n + s + j
        backward of (m, s) on rank d at tick  t = r v n + j + 2(L-1) - s

    ``M v + n v + n - 2`` ticks; a ring wrap (rank ``n-1 -> 0`` forward,
    ``0 -> n-1`` backward) is a chunk transition.  At most ``2L - 1``
    forward graphs are live on a rank.  Same return contract as
    :func:`pipeline_1f1b_loss_and_grads`; ``stage_grads`` carries the
    ``(v, ...)`` chunk axis."""
    M, v = n_microbatches, n_chunks
    _split(x, M)
    _check_rounds(M, comm.size, v, "interleaved")
    return _coupled(stage_fn, loss_fn, stage_params, x, target, comm, M, v,
                    True, loss_params, with_input_grads)


def pipeline_circular_1f1b_loss_and_grads(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x,
    target,
    comm,
    n_microbatches: int,
    n_chunks: int,
    loss_params=None,
    with_input_grads: bool = False,
):
    """Loss + grads over :func:`spmd_pipeline_circular`, with the return
    contract of :func:`pipeline_interleaved_1f1b_loss_and_grads`
    (``stage_grads`` with the ``(v, ...)`` chunk axis; head gradients on
    the last stage, input cotangents on stage 0 — sum both before use).

    The backward is autograd through the circular schedule (mirrored, each
    chunk recomputed from its saved input), not an explicit wavefront:
    bubble ``(n-1)/(v M)`` at ``O(M v)`` saved chunk inputs.  Each rank
    differentiates its own local loss (the mean over the microbatches on
    the last rank, nothing elsewhere), so every gradient is that of the
    loss once, as the reference's unreduced ``local_loss`` gives."""
    n, d = comm.size, comm.rank
    M = n_microbatches
    _split(x, M)
    _check_rounds(M, n, n_chunks, "circular")
    leaves, rebuild = _flatten(stage_params)
    hleaves, hbuild = _flatten(loss_params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in leaves]
        hs = [h.detach().requires_grad_() for h in hleaves]
        xg = x.detach().requires_grad_(with_input_grads)
        outs = spmd_pipeline_circular(stage_fn, rebuild(ps), xg, comm, M,
                                      n_chunks)
        if d == n - 1:
            tm = _split(target, M)
            om = _split(outs, M)
            per = [loss_fn(om[m], tm[m]) if loss_params is None else
                   loss_fn(hbuild(hs), om[m], tm[m]) for m in range(M)]
            local = torch.stack(per).mean()
        else:
            local = _connected_zero(outs)
        ins = ps + hs + ([xg] if with_input_grads else [])
        gs = torch.autograd.grad(local, ins, allow_unused=True)
    gs = [torch.zeros_like(i) if g is None else g for g, i in zip(gs, ins)]
    loss = local.detach().float().clone()
    if n > 1:
        dist.all_reduce(loss, group=comm.group)
    out = (loss, rebuild(gs[:len(ps)]))
    if loss_params is not None:
        out = out + (hbuild(gs[len(ps):len(ps) + len(hs)]),)
    if with_input_grads:
        out = out + (gs[-1],)
    return out


# ---------------------------------------------------------------------
# serving-side composition: decode microbatching for tp×pp shard groups
# ---------------------------------------------------------------------

def decode_microbatches(n_rows: int, n_stages: int):
    """Contiguous split of a decode batch's row range ``[0, n_rows)``
    into at most ``n_stages`` microbatches — the serving analogue of
    this module's microbatch axis.  Returns ``[(start, stop), ...]`` in
    dispatch order (GPipe fill order: stage 0's rows first), sized as
    evenly as possible with the remainder on the leading stages, so the
    split is a pure function of ``(n_rows, n_stages)`` and two shard
    groups given the same batch dispatch identical steps.

    Splitting is bit-exact for the serving stack by construction:
    paged attention is per-sequence and sampling counter-based, so a
    row's logits (and its sampled token) never depend on which other
    rows share its step.
    """
    n_rows = int(n_rows)
    n_stages = max(1, int(n_stages))
    if n_rows <= 0:
        return []
    k = min(n_rows, n_stages)
    base, rem = divmod(n_rows, k)
    spans = []
    start = 0
    for s in range(k):
        stop = start + base + (1 if s < rem else 0)
        spans.append((start, stop))
        start = stop
    return spans


def serve_pipeline_order(n_micro: int, n_stages: int):
    """Dispatch order of ``(stage, microbatch)`` ticks for a serving
    decode iteration pipelined over ``n_stages`` stage subgroups — the
    same fill-drain wavefront :func:`spmd_pipeline` executes, viewed
    from the host dispatcher: microbatch ``m`` enters stage ``s`` at
    tick ``m + s``, so total latency is ``n_micro + n_stages - 1``
    stage-times against ``n_micro * n_stages`` sequential (the GPipe
    bubble).  Used by the bench's tp×pp model and pinned by unit test;
    the leader's own dispatch loop only needs the microbatch order
    (:func:`decode_microbatches`) because follower stages replay
    asynchronously."""
    n_micro = max(0, int(n_micro))
    n_stages = max(1, int(n_stages))
    order = []
    for tick in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = tick - s
            if 0 <= m < n_micro:
                order.append((tick, s, m))
    return order

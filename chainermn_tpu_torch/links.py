"""MultiNodeChainList — a model spanning ranks; port of
``chainermn_tpu/links.py`` (ChainerMN's ``MultiNodeChainList``).

Components are registered with ``add_link(fn, rank, rank_in, rank_out)``:
``fn(params, x) -> y`` runs on its owner ``rank``, takes its input from
the sends of ``rank_in`` (the chain's input when ``None``) and sends its
output to ``rank_out`` (the chain's output when ``None``).  Every process
runs the same walk over the components, in the order they were added,
but computes only the ones it owns: for each it receives from
``rank_in`` (:func:`functions.recv`), calls ``fn``, and sends to
``rank_out`` (:func:`functions.send`).  That order is the same on every
rank, so each receive's matching send comes earlier in it and the
forward cannot deadlock; backward runs the transfers in the reverse
order because each rank threads its transfers through one another's
delegates.  A transfer between two components of the same rank is a
local pass-through.

The reference is one SPMD program: ``lax.cond`` on the rank skips the
components a device does not own, a mis-wired chain fails at trace time,
and the chain's output is broadcast with a masked ``psum``.  Here the
wiring is checked before any transfer (a receive with no earlier send,
a send that is never received, no output: ``ValueError`` naming the
edge), and the output is broadcast from its owner so that every rank
returns it, as in the reference.  A loss computed from it on every rank
counts once, as the reference's replicated output does: the owner's
backward runs from its own copy, every other rank's backward reaches
only its own transfers (the copy it received carries no gradient).

Parameter tiers:

* replicated (:meth:`apply`): every rank holds every component's
  parameters and uses only its own; a data-parallel train step sums the
  gradients over the ranks so that every rank applies the same update,
  as the reference's seq2seq example does;
* sharded (:meth:`shard_params`, :meth:`apply_sharded`,
  :meth:`make_sharded_train_step`): each process keeps one flat fp32 row
  of its own components' parameters only, which a process a rank gives
  natively (the reference pads every device's row to the largest);
  :meth:`materialize_params` broadcasts every component from its owner
  to every rank.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from collections.abc import Mapping
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from .functions import point_to_point as p2p
from .functions.pseudo_connect import pseudo_connect


class _Component(NamedTuple):
    fn: Callable
    rank: int
    rank_in: Optional[tuple]
    rank_out: Optional[tuple]
    needs_input: bool


def _as_ranks(r):
    if r is None:
        return None
    return (r,) if isinstance(r, int) else tuple(r)


def _tree_flatten(tree):
    """Leaves (tensors) and structure of a nest of mappings, tuples and
    lists of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], None
    if isinstance(tree, Mapping):
        leaves, spec = [], []
        for k, v in tree.items():
            sub, s = _tree_flatten(v)
            leaves += sub
            spec.append((k, s))
        return leaves, ("map", tuple(spec))
    if isinstance(tree, (tuple, list)):
        leaves, spec = [], []
        for v in tree:
            sub, s = _tree_flatten(v)
            leaves += sub
            spec.append(s)
        return leaves, (type(tree).__name__, tuple(spec))
    raise TypeError(f"parameters must nest tensors in mappings, tuples and "
                    f"lists, got {type(tree).__name__}")


def _tree_unflatten(leaves, spec):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, children = s
        if kind == "map":
            return {k: build(c) for k, c in children}
        built = [build(c) for c in children]
        return built if kind == "list" else tuple(built)

    return build(spec)


def _requires_grad(tree) -> bool:
    return any(t.requires_grad for t in p2p._flatten(tree)[0])


class MultiNodeChainList:
    """A chain of components on the ranks of ``comm`` (reference-parity
    API, the owner rank named explicitly as the reference does)."""

    def __init__(self, comm):
        self.comm = comm
        self._components: list[_Component] = []
        self._shard_meta = None

    def add_link(self, fn: Callable, rank: int, rank_in=None, rank_out=None,
                 needs_input: bool = False):
        """Register ``fn(params, x) -> y`` owned by ``rank``.  ``rank_in``:
        the rank(s) whose sends feed it, in order (``None``: the chain's
        input); ``rank_out``: the rank(s) its output goes to (``None``:
        it is the chain's output).  ``needs_input`` also passes the
        chain's input after the received payload(s) (a decoder that needs
        the encoder's state and the target tokens)."""
        self._components.append(_Component(
            fn, rank, _as_ranks(rank_in), _as_ranks(rank_out), needs_input))
        return self

    # ------------------------------------------------------------------
    def _check(self, n_params=None):
        """Raise ``ValueError`` for a chain that could not run: wrong
        parameter count, an owner outside the world, a receive with no
        earlier send, no output, a send never received."""
        comps, n = self._components, self.comm.size
        if n_params is not None and n_params != len(comps):
            raise ValueError(f"params_list has {n_params} entries for "
                             f"{len(comps)} components")
        inflight = Counter()
        has_output = False
        for i, c in enumerate(comps):
            for r in (c.rank, *(c.rank_in or ()), *(c.rank_out or ())):
                if not 0 <= r < n:
                    raise ValueError(f"component {i} names rank {r} outside "
                                     f"the {n}-rank world")
            for src in c.rank_in or ():
                if not inflight[(src, c.rank)]:
                    raise ValueError(
                        f"component {i} owned by rank {c.rank} expects a send "
                        f"from rank {src}, but no send from {src} to "
                        f"{c.rank} was issued earlier in the chain; check "
                        "rank_in/rank_out (nothing was sent)")
                inflight[(src, c.rank)] -= 1
            if c.rank_out is None:
                has_output = True
            else:
                for dst in c.rank_out:
                    inflight[(c.rank, dst)] += 1
        if not has_output:
            raise ValueError("no component has rank_out=None; the chain "
                             "never produces an output")
        for (src, dst), k in inflight.items():
            if k:
                raise ValueError(f"{k} send(s) from rank {src} to rank {dst} "
                                 "are never received; check rank_in/rank_out "
                                 "(nothing was sent)")

    def _walk(self, get_params: Callable, x):
        comm = self.comm
        me = comm.rank
        local = defaultdict(list)   # sends from this rank to itself
        last = None                 # this rank's newest unthreaded transfer
        out = owner = None
        for i, c in enumerate(self._components):
            if c.rank_out is None:
                owner = c.rank
            if c.rank != me:
                continue
            if c.rank_in is None:
                inp = x
            else:
                got = []
                for src in c.rank_in:
                    if src == me:
                        got.append(p2p.recv(comm, me, local[me].pop(0)))
                        continue
                    payload = p2p.recv(comm, src, delegate_variable=last)
                    if _requires_grad(payload):
                        last = p2p._local_token(p2p._flatten(payload)[0])
                    got.append(payload)
                if c.needs_input:
                    got.append(x)
                inp = got[0] if len(got) == 1 else tuple(got)
            y = c.fn(get_params(i, c), inp)
            if c.rank_out is None:
                out = y
                continue
            for dst in c.rank_out:
                if dst == me:
                    local[me].append(p2p.send(y, comm, me))
                    continue
                if last is not None:
                    y = pseudo_connect(last, y)
                last = p2p.send(y, comm, dst)
        y = self._replicate(out, owner)
        if torch.is_grad_enabled() and me != owner and last is None:
            # A rank with no transfer of its own: a gradient-carrying
            # leaf, so that its backward runs (and does nothing).
            last = torch.empty(0, device=comm.device, requires_grad=True)
        return y if last is None else pseudo_connect(last, y)

    def _replicate(self, y, owner):
        """The owner's ``y`` on every rank: the owner returns ``y`` itself,
        the others a received copy."""
        comm = self.comm
        if comm.size == 1:
            return y
        dev = comm.device
        if comm.rank == owner:
            leaves, spec = p2p._flatten(y)
            body = torch.tensor(
                p2p.encode_header(spec, leaves, [False] * len(leaves)),
                dtype=torch.int64, device=dev)
            comm.bcast(torch.tensor([body.numel()], device=dev), owner)
            comm.bcast(body, owner)
            for t in leaves:
                comm.bcast(t.detach().contiguous(), owner)
            return y
        n = comm.bcast(torch.zeros(1, dtype=torch.int64, device=dev), owner)
        spec, metas = p2p.decode_header(comm.bcast(
            torch.zeros(int(n[0]), dtype=torch.int64, device=dev),
            owner).tolist())
        return p2p._unflatten([comm.bcast(torch.empty(
            shape, dtype=dtype, device=dev), owner)
            for shape, dtype, _ in metas], spec)

    def apply(self, params_list: Sequence[Any], x):
        """Forward (replicated tier): ``params_list[i]`` are component
        ``i``'s parameters; only this rank's components are used.  Returns
        the chain's output on every rank.  Collective."""
        self._check(len(params_list))
        return self._walk(lambda i, c: params_list[i], x)

    def make_forward(self):
        """``fwd(params_list, x)``, the reference's "just call the model"
        surface (there it wraps ``shard_map`` and ``jit``)."""
        return self.apply

    # ------------------------------------------------------------------
    # Sharded tier: each process keeps only its own components
    # ------------------------------------------------------------------
    def shard_params(self, params_list: Sequence[Any]) -> torch.nn.Parameter:
        """This rank's components' parameters packed into one flat fp32
        row (a ``Parameter`` on the communicator's device, empty on a rank
        that owns none); every rank keeps the other components' shapes
        only.  The row is what :meth:`apply_sharded` and
        :meth:`make_sharded_train_step` trade in."""
        self._check(len(params_list))
        me = self.comm.rank
        metas, offsets, parts = [], [], []
        cursor = Counter()
        for c, params in zip(self._components, params_list):
            leaves, spec = _tree_flatten(params)
            leaf_meta = tuple((tuple(t.shape), t.dtype, t.numel())
                              for t in leaves)
            metas.append((spec, leaf_meta))
            offsets.append(cursor[c.rank])
            cursor[c.rank] += sum(m[2] for m in leaf_meta)
            if c.rank == me:
                parts += [t.detach().reshape(-1).float() for t in leaves]
        self._shard_meta = (tuple(metas), tuple(offsets), dict(cursor))
        dev = self.comm.device
        row = (torch.cat([t.to(dev) for t in parts]) if parts
               else torch.zeros(0, device=dev))
        return torch.nn.Parameter(row)

    def _require_shard_meta(self):
        if self._shard_meta is None:
            raise RuntimeError("call shard_params(params_list) first")

    def _unpack(self, flat, i, base=0):
        """Component ``i``'s parameter tree as views of ``flat`` (cast to
        each leaf's dtype), starting at ``base``."""
        spec, leaf_meta = self._shard_meta[0][i]
        off, leaves = base, []
        for shape, dtype, size in leaf_meta:
            leaves.append(flat[off:off + size].view(shape).to(dtype))
            off += size
        return _tree_unflatten(leaves, spec)

    def apply_sharded(self, row, x):
        """Forward over this rank's row (:meth:`shard_params`): the same
        walk as :meth:`apply`, with each owned component's parameters as
        views of the row.  Collective."""
        self._require_shard_meta()
        self._check()
        offsets = self._shard_meta[1]
        return self._walk(lambda i, c: self._unpack(row, i, offsets[i]), x)

    def materialize_params(self, row):
        """Every component's parameters on every rank (for evaluation,
        export, or the replicated tier): each owner broadcasts its
        components' slices of its row.  Collective."""
        self._require_shard_meta()
        comm = self.comm
        metas, offsets, _ = self._shard_meta
        out = []
        for i, c in enumerate(self._components):
            size = sum(m[2] for m in metas[i][1])
            buf = (row.detach()[offsets[i]:offsets[i] + size].clone()
                   if c.rank == comm.rank else
                   torch.empty(size, device=comm.device))
            if comm.size > 1:
                comm.bcast(buf, c.rank)
            out.append(self._unpack(buf, i))
        return out

    def init_sharded_opt_state(self, optimizer: Callable, row):
        """The optimizer over this rank's row: ``optimizer`` builds a
        ``torch.optim.Optimizer`` from a parameter list (a class with its
        hyperparameters bound, the counterpart of an optax
        transformation); its state lives beside the row, so each rank
        holds state for its own components only."""
        self._require_shard_meta()
        return optimizer([row])

    def make_sharded_train_step(self, optimizer: Callable,
                                loss_fn: Callable):
        """``step(row, opt_state, batch) -> (row, opt_state, loss)``:
        the forward over the rows with ``batch`` as the chain's input,
        ``loss_fn(chain_output, batch)`` on every rank, backward, and the
        update of this rank's row by ``opt_state`` (from
        :meth:`init_sharded_opt_state` with the same ``optimizer``).
        Every rank takes the same batch (pure model parallelism): each
        row's gradient concerns only its own components, so no gradient
        is reduced over the ranks."""
        del optimizer       # opt_state carries it (reference signature)

        def step(row, opt_state, batch):
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(self.apply_sharded(row, batch), batch)
            loss.backward()
            if row.grad is None:
                row.grad = torch.zeros_like(row)
            opt_state.step()
            return row, opt_state, loss.detach()

        return step

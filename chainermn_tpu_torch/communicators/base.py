"""Communicator base class — port of ``chainermn_tpu/communicators/base.py``.

ChainerMN's model, restored: one process per rank, each holding its own
copy of the model, with an eager communicator whose methods *are* the
network operations (``torch.distributed`` collectives; NCCL on the GPU,
gloo on the CPU).  Three planes:

* the model plane: ``allreduce``, ``bcast``, ``allgather``, ``gather``,
  ``scatter``, ``alltoall``, ``reduce_scatter`` on tensors, and
  ``broadcast_data``/``allreduce_grad`` on parameters and gradients
  (bucketed, optionally on a scaled int8/fp8 wire, see :mod:`.quant`, and
  launched from gradient hooks during backward, see :mod:`.overlap`);
* the object plane: pickled objects over a gloo group (``send_obj``,
  ``recv_obj``, ``bcast_obj``, ``gather_obj``, ``allgather_obj``,
  ``allreduce_obj``, ``scatter_obj``, ``barrier``), so pickles never go
  through device tensors on an NCCL job;
* ``split(color, key)``: ``MPI_Comm_split``, a communicator over a subset
  of the ranks with its own process groups.

Ranks and roots are always this communicator's ranks; they are mapped to
global ranks for ``torch.distributed``, and results that come back in a
process group's order (sorted global ranks) are put back into this
communicator's rank order.
"""

from __future__ import annotations

import datetime
import os
import pickle
import threading
import time
from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from . import overlap as overlap_mod
from . import packing, quant
from .mesh_utils import Topology

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# Object-plane messages of the collectives built on point-to-point sends
# use tags from here up, clear of the tags users give ``send_obj``.
_TAG_GATHER = 1 << 24


def _leaves(tree):
    """Tensors of a tensor, a sequence of tensors or a mapping of them, in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return list(tree.values())
    return list(tree)


class _Pending:
    """``fn()`` running on a daemon thread, waited on with an optional
    deadline (``time.monotonic``).  A wait that times out raises
    ``TimeoutError`` and leaves ``fn`` running, so a later wait resumes it.
    (Gloo's send and receive handles report completion only from their own
    ``wait()``, and a gloo wait that times out aborts the whole group, so
    a bounded wait blocks a thread instead.)"""

    def __init__(self, fn):
        self._done = threading.Event()
        self._out = self._err = None

        def run():
            try:
                self._out = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in result
                self._err = e
            finally:
                self._done.set()

        threading.Thread(target=run, daemon=True).start()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, deadline=None):
        left = None if deadline is None else max(0.0,
                                                 deadline - time.monotonic())
        if not self._done.wait(left):
            raise TimeoutError("object-plane operation timed out")
        if self._err is not None:
            raise self._err
        return self._out


def _wait(work, deadline):
    """Wait on ``work``; with a ``deadline`` raise ``TimeoutError`` when it
    passes, leaving ``work`` pending."""
    if deadline is None:
        work.wait()
    else:
        _Pending(work.wait).result(deadline)


class CommunicatorBase:
    """Abstract communicator; subclasses specialise :meth:`_allreduce_impl`
    (the mean) and, for multi-leg patterns, :meth:`_allreduce_sum_impl`.

    ``allreduce_grad_dtype`` casts gradients before the collective and
    back after (the reference's ``pure_nccl`` fp16 option);
    ``bucket_bytes`` caps the fused gradient buckets (``None`` =
    :meth:`resolve_bucket_bytes`, ``0`` = one collective per tensor
    through the subclass's own path);
    ``overlap`` pins the backward-overlapped bucket launch (``None`` =
    ``CHAINERMN_TPU_OVERLAP``, default ON); ``overlap_granularity`` sets
    buckets per launch stage; ``comm_dtype`` (``"int8"``/``"fp8"``/
    ``"none"``; ``None`` = ``CHAINERMN_TPU_COMM_DTYPE``, default off) puts
    the buckets on a scaled narrow wire."""

    name = "base"

    def __init__(self, topology: Topology, allreduce_grad_dtype=None,
                 bucket_bytes: int | None = None,
                 overlap: bool | None = None,
                 overlap_granularity: int | None = None,
                 comm_dtype=None):
        self.topology = topology
        self.allreduce_grad_dtype = allreduce_grad_dtype
        if bucket_bytes is not None:
            bucket_bytes = int(bucket_bytes)
            if bucket_bytes < 0:
                raise ValueError(
                    f"bucket_bytes must be >= 0, got {bucket_bytes}")
        self.bucket_bytes = bucket_bytes
        self.overlap = None if overlap is None else bool(overlap)
        if overlap_granularity is not None:
            overlap_granularity = int(overlap_granularity)
            if overlap_granularity < 1:
                raise ValueError("overlap_granularity must be >= 1, got "
                                 f"{overlap_granularity}")
        self.overlap_granularity = overlap_granularity
        self.comm_dtype = quant.canonical_comm_dtype(comm_dtype)
        self._fp8_sums = None         # does the backend sum fp8? (probed)
        self._packers: dict = {}      # bucket plan per (shapes, dtypes)
        self._recv_state: dict = {}   # partial receives, kept for retries
        members = topology.members
        # Group position -> communicator rank (groups order ranks by their
        # global rank; a split orders its ranks by key).
        self._group_order = (
            None if members is None else
            sorted(range(len(members)), key=lambda r: members[r]))
        if self._group_order == list(range(self.size)):
            self._group_order = None

    def _ctor_kwargs(self) -> dict:
        return dict(allreduce_grad_dtype=self.allreduce_grad_dtype,
                    bucket_bytes=self.bucket_bytes, overlap=self.overlap,
                    overlap_granularity=self.overlap_granularity,
                    comm_dtype=self.comm_dtype)

    # -- topology (reference ``rank``/``size``/``intra_*``/``inter_*``) --
    @property
    def device(self) -> torch.device:
        return self.topology.device

    @property
    def rank(self) -> int:
        return self.topology.rank

    @property
    def size(self) -> int:
        return self.topology.size

    @property
    def intra_rank(self) -> int:
        return self.topology.intra_rank

    @property
    def intra_size(self) -> int:
        return self.topology.intra_size

    @property
    def inter_rank(self) -> int:
        return self.topology.inter_rank

    @property
    def inter_size(self) -> int:
        return self.topology.inter_size

    @property
    def group(self):
        """This communicator's process group (``None`` = the world)."""
        return self.topology.group

    def _global(self, r: int) -> int:
        members = self.topology.members
        return r if members is None else members[r]

    def _to_group_order(self, items):
        if self._group_order is None:
            return list(items)
        return [items[r] for r in self._group_order]

    def _to_comm_order(self, items):
        if self._group_order is None:
            return list(items)
        out = [None] * len(items)
        for g, r in enumerate(self._group_order):
            out[r] = items[g]
        return out

    # -- model plane: tensor collectives ---------------------------------
    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over the ranks (``sum``/``mean``/``max``/``min``);
        returns a new tensor."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown op {op!r}")
        out = x.clone()
        if self.size > 1:
            dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.group)
        return out / self.size if op == "mean" else out

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Broadcast ``x`` from rank ``root``, in place; returns ``x``."""
        if self.size > 1:
            dist.broadcast(x, src=self._global(root), group=self.group)
        return x

    def allgather(self, x: torch.Tensor, axis: int = 0,
                  tiled: bool = False) -> torch.Tensor:
        """Every rank's ``x``: stacked on a new ``axis`` of size ``size``,
        or concatenated along ``axis`` with ``tiled``."""
        if self.size == 1:
            parts = [x]
        else:
            flat = x.contiguous().reshape(-1)
            buf = flat.new_empty(self.size * flat.numel())
            dist.all_gather_into_tensor(buf, flat, group=self.group)
            parts = self._to_comm_order(list(buf.view(self.size, *x.shape)))
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    def gather(self, x: torch.Tensor, root: int = 0,
               axis: int = 0) -> torch.Tensor:
        """``root`` receives every rank's ``x`` stacked on ``axis``; the
        other ranks get zeros of that shape (the reference's traced
        ``gather``)."""
        if self.size == 1:
            return x.unsqueeze(axis)
        x = x.contiguous()
        parts = ([torch.empty_like(x) for _ in range(self.size)]
                 if self.rank == root else None)
        dist.gather(x, parts, dst=self._global(root), group=self.group)
        if self.rank != root:
            return x.new_zeros(x.shape[:axis] + (self.size,) + x.shape[axis:])
        return torch.stack(self._to_comm_order(parts), axis)

    def scatter(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Rank ``d`` receives chunk ``d`` of ``root``'s ``x`` along axis 0
        (every rank passes an ``x`` of the same shape)."""
        if x.shape[0] % self.size:
            raise ValueError(
                f"scatter axis 0 ({x.shape[0]}) must be divisible by the "
                f"rank count ({self.size}); pad the input first")
        if self.size == 1:
            return x.clone()
        chunks = [c.contiguous() for c in x.chunk(self.size)]
        out = torch.empty_like(chunks[0])
        dist.scatter(out, self._to_group_order(chunks)
                     if self.rank == root else None,
                     src=self._global(root), group=self.group)
        return out

    def alltoall(self, x: torch.Tensor, split_axis: int = 0,
                 concat_axis: int = 0) -> torch.Tensor:
        """Chunk ``j`` of ``x`` along ``split_axis`` goes to rank ``j``;
        the received chunks are concatenated along ``concat_axis`` in
        source-rank order (``lax.all_to_all`` with ``tiled=True``)."""
        if x.shape[split_axis] % self.size:
            raise ValueError(
                f"alltoall split axis ({x.shape[split_axis]}) must be "
                f"divisible by the rank count ({self.size})")
        chunks = list(x.chunk(self.size, split_axis))
        if self.size > 1:
            shape = chunks[0].shape
            send = torch.cat([c.contiguous().reshape(-1)
                              for c in self._to_group_order(chunks)])
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=self.group)
            chunks = self._to_comm_order(
                [c.view(shape) for c in recv.chunk(self.size)])
        return torch.cat(chunks, concat_axis)

    def reduce_scatter(self, x: torch.Tensor,
                       scatter_dimension: int = 0) -> torch.Tensor:
        """Sum over the ranks; rank ``r`` keeps chunk ``r`` along
        ``scatter_dimension`` (``psum_scatter`` with ``tiled=True``)."""
        n = self.size
        if x.shape[scatter_dimension] % n:
            raise ValueError(
                f"reduce_scatter dimension ({x.shape[scatter_dimension]}) "
                f"must be divisible by the rank count ({n})")
        if n == 1:
            return x.clone()
        xt = x.movedim(scatter_dimension, 0)
        chunks = self._to_group_order(list(xt.chunk(n)))
        send = torch.cat(chunks)        # (n * k, ...): the group's order
        out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
        dist.reduce_scatter_tensor(out, send, group=self.group)
        return out.movedim(0, scatter_dimension)

    # -- model plane: parameters and gradients ---------------------------
    def broadcast_data(self, tensors, root: int = 0):
        """Replicate parameters from ``root`` to every rank, in place
        (reference ``broadcast_data(model)``, the multi-node optimizer's
        first-update broadcast).  Takes a module, a sequence or a mapping
        of tensors."""
        if isinstance(tensors, torch.nn.Module):
            tensors = list(tensors.parameters())
        with torch.no_grad():
            for t in _leaves(tensors):
                self.bcast(t, root)
        return tensors

    def resolve_comm_dtype(self) -> str | None:
        """The gradient wire for this call: the constructor's
        ``comm_dtype`` (``"none"`` pins it off), else
        ``CHAINERMN_TPU_COMM_DTYPE``, else off.  A name from
        :data:`quant.COMM_DTYPE_CHOICES`, or ``None``."""
        cd = self.comm_dtype
        if cd is None:
            env = os.environ.get(quant.ENV_COMM_DTYPE, "").strip()
            if env:
                try:
                    cd = quant.canonical_comm_dtype(env)
                except ValueError:
                    cd = None
        return None if cd in (None, "none") else cd

    def wire_dtype(self):
        """The dtype the quantized buckets travel in, or ``None`` when the
        wire is full precision.  ``fp8`` is ``torch.float8_e4m3fn`` where
        this communicator's backend sums it (probed once with one small
        all-reduce; gloo never does) and int8 elsewhere."""
        cd = self.resolve_comm_dtype()
        if cd is None:
            return None
        if cd == "int8":
            return torch.int8
        if self._fp8_sums is None:
            self._fp8_sums = self._probe_fp8_sum()
        return torch.float8_e4m3fn if self._fp8_sums else torch.int8

    def _probe_fp8_sum(self) -> bool:
        if dist.get_backend(self.group) == "gloo":
            return False
        x = torch.ones(2, dtype=torch.float8_e4m3fn, device=self.device)
        try:
            dist.all_reduce(x, group=self.group)
        except (RuntimeError, TypeError, ValueError):
            return False
        return bool((x.float() == self.size).all())

    def resolve_bucket_bytes(self) -> int:
        """Effective bucket cap for one ``allreduce_grad`` call: the
        constructor's ``bucket_bytes`` if set, else the
        ``CHAINERMN_TPU_BUCKET_BYTES`` override (``0`` = unbucketed; a
        value that is not an integer is ignored, a negative one gives 0),
        else 4 MiB.  The reference looks up a tuned value between the
        override and the default (ROADMAP A.7); the port has no tune
        cache yet."""
        bb = self.bucket_bytes
        if bb is None:
            env = os.environ.get(packing.ENV_BUCKET_BYTES, "").strip()
            if env:
                try:
                    bb = int(env)
                except ValueError:
                    bb = None
        if bb is None:
            bb = packing.DEFAULT_BUCKET_BYTES
        return max(int(bb), 0)

    def resolve_overlap(self, overlap: bool | None = None) -> bool:
        """The call's pin, else the constructor's ``overlap``, else the
        ``CHAINERMN_TPU_OVERLAP`` gate (default ON)."""
        if overlap is not None:
            return bool(overlap)
        if self.overlap is not None:
            return self.overlap
        return overlap_mod.overlap_enabled()

    def resolve_overlap_granularity(self) -> int:
        """Constructor, else ``CHAINERMN_TPU_OVERLAP_GRANULARITY``, else 1."""
        if self.overlap_granularity is not None:
            return self.overlap_granularity
        return overlap_mod.resolve_granularity()

    def allreduce_grad(self, grads):
        """Average gradients across the ranks, in place.

        ``grads`` is a sequence or mapping of tensors (the port updates
        them in place rather than returning a new tree, which saves a
        full gradient copy); it is also returned.  Reference contract
        (``base.py:548-592``): the optional ``allreduce_grad_dtype`` cast
        and cast back, and for more than one tensor the bucketed packing
        — one collective per per-dtype bucket instead of one per tensor,
        each float bucket on the scaled narrow wire when a ``comm_dtype``
        resolves.  ``bucket_bytes=0`` gives each subclass's unbucketed
        path, at full precision.  On one rank with a full-precision wire
        the mean is the input: only the dtype round trip is applied, with
        no packing and no collective; the quantized wire runs at every
        world size, as in the reference."""
        leaves = _leaves(grads)
        if not leaves:
            return grads
        bb = self.resolve_bucket_bytes() if len(leaves) > 1 else 0
        bucketed = bb > 0
        wire = self.wire_dtype() if bucketed else None
        if self.size == 1 and wire is None:
            if self.allreduce_grad_dtype is not None:
                with torch.no_grad():
                    for g in leaves:
                        g.copy_(g.to(self.allreduce_grad_dtype))
            return grads
        work = leaves
        if self.allreduce_grad_dtype is not None:
            work = [g.to(self.allreduce_grad_dtype) for g in leaves]
        if bucketed:
            key = (bb,) + tuple((tuple(g.shape), g.dtype) for g in work)
            packer = self._packers.get(key)
            if packer is None:
                packer = packing.GradPacker.for_tensors(work, bb)
                self._packers[key] = packer
            bufs = packer.pack(work)
            out = packer.unpack([self._launch_bucket(b, wire)()
                                 for b in bufs])
        else:
            out = self._allreduce_impl(work)
        with torch.no_grad():
            for g, r in zip(leaves, out):
                g.copy_(r)
        return grads

    def _launch_bucket(self, buf, wire):
        """Start one bucket's mean; returns a callable that waits for it
        and gives the result (the unit of work of both the eager and the
        overlapped path, so the two run the same operations)."""
        if wire is not None and quant.quantizable(buf.dtype):
            out = self._allreduce_quantized(buf, wire)
            return lambda: out
        return self._allreduce_async(buf)

    def _allreduce_async(self, buf):
        """Subclasses whose mean is one collective launch it with
        ``async_op=True``; multi-leg patterns run here, synchronously."""
        out = self._allreduce_impl([buf])[0]
        return lambda: out

    def _allreduce_impl(self, tensors: Sequence[torch.Tensor]):
        """Mean of each tensor over the ranks; returns the results (which
        may be the inputs, reduced in place)."""
        raise NotImplementedError

    def _allreduce_sum_impl(self, buf: torch.Tensor) -> torch.Tensor:
        """Pure sum of one bucket over the ranks, the quantized wire's
        collective: every mean divides inline, and integer division on
        an int8 buffer would truncate, so the quantized path applies the
        mean in fp32 at dequant time instead.  Multi-leg patterns
        override it with their sum chain."""
        dist.all_reduce(buf, group=self.group)
        return buf

    def _allreduce_quantized(self, buf, wire_dt):
        """One bucket through scale -> cast -> sum -> cast -> unscale (see
        :mod:`.quant`): the global amax by a max all-reduce, the
        world-headroom scale, the narrow sum by
        :meth:`_allreduce_sum_impl`, the fp32 dequant carrying the mean."""
        world = self.size
        amax = quant.local_amax(buf)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=self.group)
        scale = quant.scale_for(amax, wire_dt, world)
        qsum = self._allreduce_sum_impl(quant.quantize(buf, scale, wire_dt))
        return quant.dequantize_mean(qsum, scale, world, buf.dtype)

    def multi_node_mean(self, grads):
        """Alias of :meth:`allreduce_grad` (later reference spelling)."""
        return self.allreduce_grad(grads)

    # -- object plane ----------------------------------------------------
    @property
    def _obj_group(self):
        obj = self.topology.obj_group
        return self.group if obj is None else obj

    def _isend_obj(self, obj, dest: int, tag: int):
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
        n = torch.tensor([data.numel()], dtype=torch.int64)
        g = self._global(dest)
        works = [dist.isend(n, g, group=self._obj_group, tag=tag),
                 dist.isend(data, g, group=self._obj_group, tag=tag)]
        return works, (n, data)

    def _recv_now(self, source: int, tag: int):
        g = self._global(source)
        n = torch.zeros(1, dtype=torch.int64)
        dist.recv(n, g, group=self._obj_group, tag=tag)
        data = torch.empty(int(n[0]), dtype=torch.uint8)
        dist.recv(data, g, group=self._obj_group, tag=tag)
        return pickle.loads(data.numpy().tobytes())

    def _recv_obj(self, source: int, tag: int, deadline):
        # A bounded receive runs on a thread; one that timed out stays
        # here, so the next call on the same (source, tag) resumes it and
        # the stream stays intact.
        key = (source, tag)
        pending = self._recv_state.get(key)
        if pending is None:
            if deadline is None:
                return self._recv_now(source, tag)
            pending = self._recv_state[key] = _Pending(
                lambda: self._recv_now(source, tag))
        try:
            return pending.result(deadline)
        finally:
            if pending.done:
                del self._recv_state[key]

    @staticmethod
    def _deadline(timeout_ms):
        return None if timeout_ms is None else \
            time.monotonic() + timeout_ms / 1000.0

    def send_obj(self, obj, dest: int, tag: int = 0) -> None:
        """Point-to-point send of a picklable object to rank ``dest`` (the
        reference's ``send``).  Matched ``send_obj``/``recv_obj`` pairs on
        one (edge, tag) complete in order, MPI's matching rule."""
        if not (0 <= dest < self.size) or dest == self.rank:
            raise ValueError(
                f"send_obj dest must be another rank in [0, {self.size}), "
                f"got {dest} (self.rank={self.rank})")
        works, _keep = self._isend_obj(obj, dest, tag)
        for w in works:
            w.wait()

    def recv_obj(self, source: int, tag: int = 0,
                 timeout_ms: int | None = None):
        """Blocking receive from rank ``source``; waits indefinitely by
        default, and a finite ``timeout_ms`` raises ``TimeoutError``
        instead, leaving the stream intact so the receive may be
        retried."""
        if not (0 <= source < self.size) or source == self.rank:
            raise ValueError(
                f"recv_obj source must be another rank in [0, {self.size}), "
                f"got {source} (self.rank={self.rank})")
        return self._recv_obj(source, tag, self._deadline(timeout_ms))

    def bcast_obj(self, obj, root: int = 0):
        """Broadcast a picklable object from ``root``."""
        if self.size <= 1:
            return obj
        box = [obj if self.rank == root else None]
        dist.broadcast_object_list(box, src=self._global(root),
                                   group=self._obj_group)
        return box[0]

    def gather_obj(self, obj, root: int | None = None,
                   timeout_ms: int | None = None):
        """Every rank's object.  ``root=None``: the list on every rank
        (allgather); ``root=r``: the list at ``r`` and ``None`` elsewhere,
        every other rank sending only to ``r``.  ``timeout_ms`` bounds the
        wait on each member's payload (``TimeoutError``)."""
        if root is not None and not (0 <= root < self.size):
            raise ValueError(f"gather_obj root {root} out of range")
        if self.size == 1:
            return [obj]
        if root is None and timeout_ms is None:
            out = [None] * self.size
            dist.all_gather_object(out, obj, group=self._obj_group)
            return self._to_comm_order(out)
        deadline = self._deadline(timeout_ms)
        others = [r for r in range(self.size) if r != self.rank]
        targets = others if root is None else (
            [root] if self.rank != root else [])
        sends = [self._isend_obj(obj, r, _TAG_GATHER) for r in targets]
        out = None
        if root is None or self.rank == root:
            out = [None] * self.size
            out[self.rank] = obj
            for r in others:
                out[r] = self._recv_obj(r, _TAG_GATHER, deadline)
        for works, _keep in sends:
            for w in works:
                _wait(w, deadline)
        return out

    def allgather_obj(self, obj):
        return self.gather_obj(obj)

    def allreduce_obj(self, obj, op=None):
        """Sum (or ``op``-reduce, in rank order) objects across the ranks —
        the reference's ``allreduce_obj`` that the evaluator uses."""
        objs = self.gather_obj(obj)
        red = objs[0]
        for o in objs[1:]:
            red = op(red, o) if op is not None else red + o
        return red

    def scatter_obj(self, objs, root: int = 0):
        """Rank ``r`` receives ``objs[r]`` of ``root``'s list."""
        if self.size == 1:
            return objs[0]
        out = [None]
        dist.scatter_object_list(
            out, self._to_group_order(objs) if self.rank == root else None,
            src=self._global(root), group=self._obj_group)
        return out[0]

    def barrier(self, timeout_s: float | None = None):
        """Wait for every rank.  ``timeout_s`` (or
        ``CHAINERMN_TPU_BARRIER_TIMEOUT_S``, set identically on every rank)
        bounds the wait with gloo's ``monitored_barrier``: a rank that died
        raises ``TimeoutError`` here instead of stalling the others."""
        if self.size <= 1:
            return
        if timeout_s is None:
            t = os.environ.get("CHAINERMN_TPU_BARRIER_TIMEOUT_S")
            timeout_s = float(t) if t else None
        if timeout_s is None:
            dist.barrier(group=self._obj_group)
            return
        try:
            dist.monitored_barrier(
                group=self._obj_group,
                timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError as e:
            raise TimeoutError(f"barrier: {e}") from e

    # -- split -----------------------------------------------------------
    @property
    def device_size(self) -> int:
        """Devices of this communicator: one a process here, so its
        ``size`` (the reference's SPMD communicator counts devices)."""
        return self.size

    def split(self, color_or_axes, key: int = 0):
        """``MPI_Comm_split`` in the reference's two shapes.

        ``split(color, key=0)``: collective over this communicator.  Ranks
        with the same ``color`` form a communicator of the same class,
        ranked by ``(key, old rank)``; ``color=None`` (``MPI_UNDEFINED``)
        takes part and gets ``None``.  The new communicator has its own
        process group (and a gloo group for its object plane on NCCL);
        its topology is one rank per node (``inter_size`` = its size), and
        a class whose constraints that shape breaks falls back to
        ``xla_ici``, as in the reference.

        ``split(("inter",))`` or ``split(("intra",))``: the communicator
        over one axis of this one's ``(inter, intra)`` grid — the ranks
        that share this rank's coordinate on the other axis, ranked by
        their coordinate on the kept one (``("inter",)`` joins the ranks
        of one ``intra_rank`` across the nodes, the data-parallel group of
        a data x pipeline layout).  Both axes give this communicator's
        ranks again.  ``hierarchical`` and ``two_dimensional`` split by
        axis give ``xla_ici``, as in the reference.

        Splitting the world creates every color's groups on every rank in
        the same order (``new_group`` is collective over the world).
        Splitting a split communicator creates each group among its
        members only (``use_local_synchronization``), on NCCL as on gloo."""
        axes = None
        if not isinstance(color_or_axes, (str, tuple, list)):
            color = color_or_axes
        else:
            axes = ((color_or_axes,) if isinstance(color_or_axes, str)
                    else tuple(color_or_axes))
            unknown = set(axes) - {"inter", "intra"}
            if not axes or unknown:
                raise ValueError(f"split axes must be drawn from ('inter', "
                                 f"'intra'), got {color_or_axes!r}")
            if set(axes) == {"inter", "intra"}:
                color, key = 0, self.rank
            elif axes[0] == "inter":
                color, key = self.intra_rank, self.inter_rank
            else:
                color, key = self.inter_rank, self.intra_rank
        trips = self.allgather_obj(
            (None if color is None else int(color), int(key), self.rank))
        # The two-leg patterns need both axes: split to one, they degrade
        # to the flat collective, as the reference's do.
        flat = axes is not None and self.name in ("hierarchical",
                                                   "two_dimensional")
        subs = self._split_groups(trips, always_xla_ici=flat)
        return None if color is None else subs[int(color)]

    def split_devices(self, colors, keys=None) -> dict:
        """The reference's device-plane split: ``colors[r]`` (and
        ``keys[r]``, default 0) for every rank ``r`` of this communicator,
        the same lists on every rank.  Returns ``{color: communicator}``
        over every color in order of its lowest member: an ``xla_ici``
        communicator for each color that holds this rank, ``None`` for
        the others (``MPI_COMM_NULL``); a ``None`` color places its rank
        in no group.  Each group's ranks are ordered by ``(key, old
        rank)``.  Collective: every rank calls it, with the same lists."""
        n = self.size
        colors = list(colors)
        if len(colors) != n:
            raise ValueError(
                f"colors must have length device_size={n}, got {len(colors)}")
        keys = [0] * n if keys is None else list(keys)
        if len(keys) != n:
            raise ValueError(
                f"keys must have length device_size={n}, got {len(keys)}")
        trips = [(c, int(k), r) for r, (c, k) in enumerate(zip(colors, keys))]
        return self._split_groups(trips, always_xla_ici=True)

    def _split_groups(self, trips, always_xla_ici: bool = False) -> dict:
        """``{color: communicator or None}`` for the ``(color, key, rank)``
        triples of every rank (``None`` colors in no group), creating each
        color's process groups in order of its lowest member."""
        from .xla_ici import XlaIciCommunicator

        colors = sorted({c for c, _, _ in trips if c is not None},
                        key=lambda c: min(r for cc, _, r in trips if cc == c))
        me = self._global(self.rank)
        backend = dist.get_backend(self.group)
        out = {}
        for c in colors:
            members = tuple(self._global(r) for _, r in
                            sorted((k, r) for cc, k, r in trips if cc == c))
            ranks = sorted(members)
            if self.topology.members is None:
                grp = dist.new_group(ranks)
                obj = (None if backend == "gloo" else
                       dist.new_group(ranks, backend="gloo"))
            elif me in members:
                grp = _local_group(ranks)
                obj = (None if backend == "gloo" else
                       _local_group(ranks, backend="gloo"))
            if me not in members:
                out[c] = None
                continue
            rank = members.index(me)
            topo = Topology(
                device=self.device, rank=rank, size=len(members),
                intra_rank=0, intra_size=1, inter_rank=rank,
                inter_size=len(members), intra_group=None, inter_group=grp,
                group=grp, members=members, obj_group=obj)
            cls = XlaIciCommunicator if always_xla_ici else type(self)
            try:
                out[c] = cls(topo, **self._ctor_kwargs())
            except ValueError:
                out[c] = XlaIciCommunicator(topo, **self._ctor_kwargs())
        return out

    def __repr__(self):
        return (
            f"{type(self).__name__}(rank={self.rank}, size={self.size}, "
            f"inter={self.inter_size}, intra={self.intra_size}, "
            f"device={self.device})"
        )


_LOCAL_GROUPS: dict = {}
_GROUP_COMMS: dict = {}


def group_communicator(group) -> CommunicatorBase:
    """The ``xla_ici`` communicator over an existing process group (a
    ``DeviceMesh`` dimension's, or one the caller made), built once per
    group and world: its ranks are the group's, in the group's order, and
    on NCCL its object plane gets a gloo group of the same members.
    Called by a member of ``group``."""
    from .xla_ici import XlaIciCommunicator

    world = dist.group.WORLD
    hit = _GROUP_COMMS.get(group.group_name)
    if hit is not None and hit[0] is world:
        return hit[1]
    members = tuple(dist.get_process_group_ranks(group))
    rank = members.index(dist.get_rank())
    nccl = dist.get_backend(group) == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if nccl
              else torch.device("cpu"))
    obj = _local_group(sorted(members), backend="gloo") if nccl else None
    topo = Topology(
        device=device, rank=rank, size=len(members), intra_rank=0,
        intra_size=1, inter_rank=rank, inter_size=len(members),
        intra_group=None, inter_group=group, group=group, members=members,
        obj_group=obj)
    comm = XlaIciCommunicator(topo)
    _GROUP_COMMS[group.group_name] = (world, comm)
    return comm


def _local_group(ranks, backend=None):
    """A group created by its members alone (``use_local_synchronization``),
    one per member set and backend (``None`` = the world's): torch names
    such a group from its ranks and the count of groups this process has
    made, which only the members agree on, so a second split over the same
    ranks in the same world must reuse the first one's group."""
    key, world = (tuple(ranks), backend), dist.group.WORLD
    hit = _LOCAL_GROUPS.get(key)
    if hit is None or hit[0] is not world:
        hit = _LOCAL_GROUPS[key] = (world, dist.new_group(
            list(ranks), backend=backend, use_local_synchronization=True))
    return hit[1]

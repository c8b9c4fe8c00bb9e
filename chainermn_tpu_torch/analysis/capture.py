"""Capture one call of a step: its op stream, its collectives, a census.

The port's counterpart of two pieces of the reference's
``observability/hlo_audit.py``: ``trace_step`` (trace a step into a jaxpr
without running it) and the part of ``CollectiveAudit`` that the lint
rules read (the collective events, bytes per axis,
``reduction_collectives()``).  Eager PyTorch has no program to trace, so
:func:`capture_step` runs the step ONCE under a
``torch.utils._python_dispatch.TorchDispatchMode`` that sees every ATen
op of the forward, the backward and the optimizer update, the flash
kernels' custom ops (``chainermn_torch::flash_*``), and every
``torch.distributed`` collective with its dtype, shape and group.

Two rules bind a capture:

* **No collective leaves the process.**  The mode records each
  ``c10d.*`` op (``torch.distributed``'s explicit collectives, with
  ``async_op=True`` too: the overlap hooks of
  :mod:`..communicators.overlap`) and each ``_c10d_functional.*`` op
  (DTensor's, ``torch.distributed._functional_collectives``') and does
  not run it on the caller's group.  It fills the outputs as a one-rank
  world would (a sum is the local value, a gather repeats it, a
  reduce-scatter keeps this rank's chunk) and returns a completed
  ``Work``, so a step whose ranks diverge is linted, not hung.  The
  capture notes the op index at which each such ``Work`` is first
  waited on, so an ``async_op=True`` collective is read as a pair of
  issue and wait (:mod:`..observability.collective_audit` reads the
  compute between them).  A
  ``c10d``/``_c10d_functional`` op this module does not know raises
  :class:`CaptureError`; it is never run.  The values a capture computes
  are therefore not the step's; only its structure is read.

  Two paths reach a process group without this thread's dispatcher: the
  object plane's bounded waits (``recv_obj``/``gather_obj`` with
  ``timeout_ms`` run the receive on a daemon thread, which a thread-local
  dispatch mode does not see) and ``monitored_barrier``.  The capture
  therefore records the object plane at the communicator instead: every
  ``CommunicatorBase`` object-plane method (``send_obj``, ``recv_obj``,
  ``bcast_obj``, ``gather_obj``, ``allgather_obj``, ``allreduce_obj``,
  ``scatter_obj``, ``barrier``) called on the capturing thread becomes an
  ``obj.<method>`` event and is answered locally; ``recv_obj`` raises
  :class:`CaptureError` (no peer can answer it).

* **The capture leaves no trace.**  Before the call it snapshots the
  state it is given (``state=``): every parameter and its ``.grad``,
  every buffer, the optimizer state and hyperparameters, a
  :class:`~..optimizers.MultiNodeOptimizer`'s step and update counts,
  stale gradients and ZeRO shard, and the communicator's per-step caches
  (the published plans, the fp8 probe); plus the torch CPU and CUDA RNG
  states.  After the call it restores them IN PLACE: a tensor the step
  rebound is bound back to its original storage and its values copied
  back, so storages and ``data_ptr``s stay.  Telemetry (the Reporter and
  step-log stacks) is muted during the call.  The snapshot holds one
  copy of that state on its device: for the full-width LM step (469.8M
  fp32 parameters under AdamW) 1.88 GB of parameters at the first call,
  when the moments do not exist yet, and 5.64 GB (parameters plus both
  moments) at a later one, with as much again for gradients that exist
  before the call.

Storages, not tensors, carry identity: views share their base's storage.
Each storage gets a serial id at first sight; an op output that shares no
storage with the op's inputs is fresh and gets a new id even where the
allocator reused an address, and an address whose seen tensors have all
died maps to a new id when it comes back (a tensor made outside the
dispatcher, as ``torch.tensor`` makes optimizer step counts).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import threading
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode


class CaptureError(RuntimeError):
    """A capture met something it cannot record without running it on the
    caller's group (an unknown collective op, a peer receive)."""


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


class TensorRef(NamedTuple):
    """One tensor as an op saw it: its storage's serial id, shape, dtype,
    and whether it covers its whole storage."""

    storage: int
    shape: Tuple[int, ...]
    dtype: str
    whole: bool


@dataclasses.dataclass
class OpRecord:
    """One dispatched op.  ``args`` holds, per tensor-bearing argument in
    schema order, the tuple of its tensors (one for a ``Tensor``, n for a
    ``Tensor[]``); ``written`` the positions in ``args`` the op writes in
    place; ``overwrite`` whether those writes replace the storage's content
    (``copy_``, ``zero_``, ``fill_``, an ``out=``); ``outputs`` the tensors
    it returned; ``fresh`` which of them got a new storage."""

    index: int
    name: str
    args: Tuple[Tuple[TensorRef, ...], ...]
    written: Tuple[int, ...]
    overwrite: bool
    outputs: Tuple[TensorRef, ...]
    fresh: Tuple[bool, ...]
    event: Optional[int] = None


class CollectiveEvent(NamedTuple):
    """One collective, canonicalized: the reference's fields with the
    group's global ranks in place of mesh axes.  ``kind`` is the
    collective's family (``all_reduce``, ``reduce_scatter``, ``reduce``,
    ``all_gather``, ``broadcast``, ``all_to_all``, ``gather``,
    ``scatter``, ``send``, ``recv``, ``barrier``, ``object``); ``reduce_op``
    its reduction (``SUM``, ``AVG``, ``MAX``, ... or ``""``); ``explicit``
    whether it is a ``c10d``/object-plane call (``False`` for a functional
    collective, as DTensor issues); ``root`` a rooted collective's root as
    a global rank (``-1`` otherwise)."""

    path: str
    name: str
    group: Tuple[int, ...]
    dtype: str
    shape: Tuple[int, ...]
    bytes: int
    kind: str = ""
    reduce_op: str = ""
    explicit: bool = True
    root: int = -1


#: reductions that sum or average (the reference's psum/psum_scatter).
SUM_OPS = ("SUM", "AVG", "PREMUL_SUM")
#: reductions whose result is identical on every rank of the group
#: (taint-clearing, as the reference's pmax/pmin).
INVARIANT_OPS = ("SUM", "AVG", "PREMUL_SUM", "MAX", "MIN")
_REDUCTION_KINDS = ("all_reduce", "reduce_scatter", "reduce")


class CollectiveCensus:
    """The part of the reference's ``CollectiveAudit`` the rules read:
    counts per collective, operand bytes per group and per collective,
    and :meth:`reduction_collectives`.  Built from a captured program's
    events, or from bare events (``analyze_program`` then skips the rules
    that need the op stream)."""

    def __init__(self, events: Sequence[CollectiveEvent]):
        self.events = list(events)

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.name] = out.get(e.name, 0) + 1
        return out

    @property
    def bytes_per_group(self) -> Dict[Tuple[int, ...], int]:
        out: Dict[Tuple[int, ...], int] = {}
        for e in self.events:
            out[e.group] = out.get(e.group, 0) + e.bytes
        return out

    def census(self) -> Dict[str, int]:
        return dict(sorted(self.counts.items()))

    def reductions(self) -> List[CollectiveEvent]:
        """The explicit summing reductions (all-reduce, reduce-scatter,
        reduce of SUM/AVG: ``torch.distributed`` calls).  DTensor's
        functional collectives under a sharding plan are the counterpart
        of what GSPMD inserts after tracing, which the reference's census
        of a jaxpr never sees: they are events, not reductions here."""
        return [e for e in self.events
                if e.explicit and e.kind in _REDUCTION_KINDS
                and e.reduce_op in SUM_OPS]

    def reduction_collectives(self) -> int:
        """One per logical reduction: an ``async_op=True`` collective and
        its later ``wait()`` are one event (a ``Work.wait`` is not a
        dispatched op), as the reference folds start/done pairs."""
        return len(self.reductions())


@dataclasses.dataclass
class StateTensor:
    """A parameter or optimizer-state tensor (``kind`` ``param``/``opt``)
    as it was before and after the call: storage addresses, bytes, and the
    serial id of the storage after the call (``None`` when no op saw it)."""

    kind: str
    name: str
    before_ptr: Optional[int]
    before_bytes: int
    after_ptr: Optional[int]
    after_storage: Optional[int]


@dataclasses.dataclass
class CapturedProgram:
    """What :func:`capture_step` returns: the op stream, the collective
    events, the batch's storage ids (the taint sources), the state
    tensors, the number of parameter leaves, the snapshot's size and the
    flash kernels' launches during the call."""

    ops: List[OpRecord]
    events: List[CollectiveEvent]
    batch_storages: Tuple[int, ...] = ()
    state: List[StateTensor] = dataclasses.field(default_factory=list)
    n_leaves: Optional[int] = None
    snapshot_bytes: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: event index -> op index of the issue, for each ``c10d`` collective
    #: issued with ``async_op=True``.
    async_issues: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: event index -> the number of ops recorded when its ``Work`` was
    #: first waited on (ops ``issue + 1 .. wait - 1`` ran in between).
    waits: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def census(self) -> CollectiveCensus:
        return CollectiveCensus(self.events)

    def op_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.name] = out.get(op.name, 0) + 1
        return out


# ---------------------------------------------------------------------------
# Storage identity
# ---------------------------------------------------------------------------


def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def storage_ptr(t) -> Optional[int]:
    """The address of ``t``'s StorageImpl (shared by every view), or
    ``None`` for a tensor without one."""
    try:
        return _local(t).untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return None


def _tensor_bytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Collective emulation
# ---------------------------------------------------------------------------


_RED_NAMES: Dict[int, str] = {}


def _reduce_op_name(obj) -> str:
    if not _RED_NAMES:
        for name, val in dist.ReduceOp.RedOpType.__members__.items():
            _RED_NAMES[int(val)] = name
    if isinstance(obj, str):
        return obj.upper()
    if isinstance(obj, torch.ScriptObject):
        return _RED_NAMES.get(int(obj.op()), "?")
    try:
        return _RED_NAMES.get(int(obj), str(obj))
    except (TypeError, ValueError):
        return str(obj).rsplit(".", 1)[-1].upper()


def _unbox_group(obj):
    if isinstance(obj, torch.ScriptObject):
        return dist.ProcessGroup.unbox(obj)
    if isinstance(obj, dist.ProcessGroup):
        return obj
    if isinstance(obj, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(obj)
    raise CaptureError(f"cannot read a process group from {type(obj)}")


def _group_ranks(pg) -> Tuple[int, ...]:
    return tuple(dist.get_process_group_ranks(pg))


def _group_index(pg) -> int:
    return dist.get_group_rank(pg, dist.get_rank())


def _done_work(result):
    fut = torch.futures.Future()
    fut.set_result(result)
    return torch._C._distributed_c10d._create_work_from_future(fut)


def _flat(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


#: c10d op -> (kind, argument read, argument written).
_C10D = {
    "allreduce_": ("all_reduce", "tensors", "tensors"),
    "allreduce_coalesced_": ("all_reduce", "tensors", "tensors"),
    "allgather_": ("all_gather", "input_tensors", "output_tensors"),
    "_allgather_base_": ("all_gather", "input_tensor", "output_tensor"),
    "allgather_coalesced_": ("all_gather", "input_list", "output_lists"),
    "allgather_into_tensor_coalesced_": ("all_gather", "inputs", "outputs"),
    "reduce_scatter_": ("reduce_scatter", "input_tensors", "output_tensors"),
    "_reduce_scatter_base_": ("reduce_scatter", "input_tensor",
                              "output_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", "inputs",
                                         "outputs"),
    "broadcast_": ("broadcast", "tensors", "tensors"),
    "reduce_": ("reduce", "tensors", "tensors"),
    "gather_": ("gather", "input_tensors", "output_tensors"),
    "scatter_": ("scatter", "input_tensors", "output_tensors"),
    "alltoall_": ("all_to_all", "input_tensors", "output_tensors"),
    "alltoall_base_": ("all_to_all", "input", "output"),
    "barrier": ("barrier", None, None),
    "monitored_barrier_": ("barrier", None, None),
    "send": ("send", "tensors", None),
    "recv_": ("recv", None, "tensors"),
    "recv_any_source_": ("recv", None, "tensors"),
}

_FUNCTIONAL = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "all_reduce_coalesced_": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_out": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
#: functional ops that pass their input through (no communication).
_FUNCTIONAL_PASS = ("wait_tensor", "_wrap_tensor_autograd")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd", "c10d_functional")


def _bind(func, args, kwargs) -> Dict[str, Any]:
    out = {}
    for i, a in enumerate(func._schema.arguments):
        if i < len(args):
            out[a.name] = args[i]
        elif a.name in kwargs:
            out[a.name] = kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


def _emulate_c10d(base: str, b: Dict[str, Any], pg):
    """Fill a c10d op's outputs as a one-rank world would, in place."""
    n = dist.get_world_size(pg)
    gi = _group_index(pg)
    with torch.no_grad():
        if base == "allgather_":
            for outs, x in zip(b["output_tensors"], b["input_tensors"]):
                for o in outs:
                    o.copy_(x)
        elif base == "_allgather_base_":
            b["output_tensor"].view(n, -1).copy_(
                b["input_tensor"].reshape(1, -1).expand(n, -1))
        elif base in ("allgather_coalesced_",
                      "allgather_into_tensor_coalesced_"):
            ins = b.get("input_list", b.get("inputs"))
            outs = b.get("output_lists", b.get("outputs"))
            for o, x in zip(outs, ins):
                if isinstance(o, (list, tuple)):
                    for oo in o:
                        oo.copy_(x)
                else:
                    o.view(n, -1).copy_(x.reshape(1, -1).expand(n, -1))
        elif base == "reduce_scatter_":
            for o, xs in zip(b["output_tensors"], b["input_tensors"]):
                o.copy_(xs[gi])
        elif base == "_reduce_scatter_base_":
            o = b["output_tensor"]
            o.copy_(b["input_tensor"].reshape(n, -1)[gi].view_as(o))
        elif base == "reduce_scatter_tensor_coalesced_":
            for o, x in zip(b["outputs"], b["inputs"]):
                o.copy_(x.reshape(n, -1)[gi].view_as(o))
        elif base == "gather_":
            if b["output_tensors"] and b["output_tensors"][0]:
                x = b["input_tensors"][0]
                for o in b["output_tensors"][0]:
                    o.copy_(x)
        elif base == "scatter_":
            if b["input_tensors"] and b["input_tensors"][0]:
                b["output_tensors"][0].copy_(b["input_tensors"][0][gi])
        elif base == "alltoall_":
            for o, x in zip(b["output_tensors"], b["input_tensors"]):
                if o.shape == x.shape:
                    o.copy_(x)
        elif base == "alltoall_base_":
            o, x = b["output"], b["input"]
            if o.shape == x.shape:
                o.copy_(x)
            else:
                o.zero_()


def _c10d_returns(func, b: Dict[str, Any], work):
    """The op's declared returns: a Work, or the first argument of the
    same type (the schemas return their output argument and a Work)."""
    outs = []
    for r in func._schema.returns:
        ty = str(r.type)
        if "Work" in ty:
            outs.append(work.boxed())
            continue
        for a in func._schema.arguments:
            if str(a.type) == ty:
                outs.append(b[a.name])
                break
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else tuple(outs)


def _emulate_functional(base: str, b: Dict[str, Any], pg):
    n = dist.get_world_size(pg)
    gi = _group_index(pg)
    with torch.no_grad():
        if base in ("all_reduce", "broadcast"):
            return b["input"].clone()
        if base in ("all_reduce_", "broadcast_"):
            return b["input"]
        if base == "all_reduce_coalesced":
            return [x.clone() for x in b["inputs"]]
        if base == "all_reduce_coalesced_":
            return b["inputs"]
        if base == "all_gather_into_tensor":
            return torch.cat([b["input"]] * n)
        if base == "all_gather_into_tensor_out":
            out = b["out"]
            out.copy_(torch.cat([b["input"]] * n))
            return out
        if base == "all_gather_into_tensor_coalesced":
            return [torch.cat([x] * n) for x in b["inputs"]]
        if base == "reduce_scatter_tensor":
            return b["input"].chunk(n)[gi].clone()
        if base == "reduce_scatter_tensor_coalesced":
            return [x.chunk(n)[gi].clone() for x in b["inputs"]]
        if base == "all_to_all_single":
            x = b["input"]
            rows = sum(b["output_split_sizes"]) if b.get(
                "output_split_sizes") else x.shape[0]
            if rows == x.shape[0]:
                return x.clone()
            return x.new_zeros((rows,) + tuple(x.shape[1:]))
    raise CaptureError(f"no emulation for _c10d_functional.{base}")


# ---------------------------------------------------------------------------
# The dispatch mode
# ---------------------------------------------------------------------------


_OVERWRITE_OPS = frozenset({
    "copy_", "zero_", "fill_", "normal_", "uniform_", "bernoulli_",
    "random_", "exponential_", "geometric_", "cauchy_", "log_normal_",
})


class _SchemaInfo:
    """Per-op facts read once from the schema."""

    def __init__(self, func):
        sch = func._schema
        self.written = []
        self.has_out = False
        for i, a in enumerate(sch.arguments):
            ai = a.alias_info
            if ai is not None and ai.is_write:
                self.written.append(i)
                if a.name == "out" or a.kwarg_only:
                    self.has_out = True
        base = func._opname if hasattr(func, "_opname") else \
            sch.name.split("::")[-1]
        self.overwrite = base in _OVERWRITE_OPS or self.has_out
        self.names = [a.name for a in sch.arguments]


class _CaptureMode(TorchDispatchMode):

    def __init__(self, thread_id):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.events: List[CollectiveEvent] = []
        self._ids: Dict[int, int] = {}
        self._refs: Dict[int, List[Any]] = {}
        self._next = 0
        self._schemas: Dict[Any, _SchemaInfo] = {}
        self._lock = threading.Lock()
        self.thread_id = thread_id
        self.async_issues: Dict[int, int] = {}
        self.waits: Dict[int, int] = {}
        self._works: Dict[int, Tuple[Any, int]] = {}   # id -> (Work, event)

    # -- storage ids ---------------------------------------------------
    def _new_id(self, ptr, t) -> int:
        sid = self._next
        self._next += 1
        self._ids[ptr] = sid
        self._refs[ptr] = [weakref.ref(t)]
        return sid

    def storage_id(self, t) -> Optional[int]:
        """The serial id of ``t``'s storage: the one its address maps to
        while a tensor seen on that storage is alive, else a new one (the
        allocator reused the address of a dead storage)."""
        lt = _local(t)
        ptr = storage_ptr(lt)
        if ptr is None:
            return None
        sid = self._ids.get(ptr)
        if sid is not None:
            alive = [r for r in self._refs[ptr] if r() is not None]
            if alive:
                if len(alive) < 8 and not any(r() is lt for r in alive):
                    alive.append(weakref.ref(lt))
                self._refs[ptr] = alive
                return sid
        return self._new_id(ptr, lt)

    def _ref(self, t, sid) -> TensorRef:
        lt = _local(t)
        nb = _tensor_bytes(lt)
        try:
            whole = (lt.storage_offset() == 0 and lt.is_contiguous()
                     and nb == lt.untyped_storage().nbytes())
        except (RuntimeError, NotImplementedError):
            whole = False
        return TensorRef(sid, tuple(lt.shape), str(lt.dtype).replace(
            "torch.", ""), whole)

    def _arg_refs(self, func, args, kwargs):
        info = self._schemas.get(func)
        if info is None:
            info = self._schemas[func] = _SchemaInfo(func)
        vals = list(args) + [kwargs.get(n) for n in info.names[len(args):]]
        refs, positions, written = [], [], []
        for i, v in enumerate(vals):
            ts = _flat(v)
            if not ts:
                continue
            if i in info.written:
                written.append(len(refs))
            refs.append(tuple(self._ref(t, self.storage_id(t)) for t in ts))
            positions.append(i)
        return info, refs, written

    def _out_refs(self, outs, in_ptrs):
        """An op's returned tensors, and which of them are fresh: one that
        shares no storage with the op's inputs gets a new id."""
        refs, fresh = [], []
        for t in outs:
            ptr = storage_ptr(t)
            if ptr is None:
                continue
            is_fresh = ptr not in in_ptrs
            sid = (self._new_id(ptr, _local(t)) if is_fresh
                   else self.storage_id(t))
            refs.append(self._ref(t, sid))
            fresh.append(is_fresh)
        return tuple(refs), tuple(fresh)

    def record(self, name, func, args, kwargs, out):
        info, refs, written = self._arg_refs(func, args, kwargs)
        in_ptrs = {storage_ptr(t) for v in list(args) + list(kwargs.values())
                   for t in _flat(v)}
        outs, fresh = self._out_refs(_flat(out), in_ptrs)
        with self._lock:
            self.ops.append(OpRecord(
                index=len(self.ops), name=name, args=tuple(refs),
                written=tuple(written), overwrite=info.overwrite,
                outputs=outs, fresh=fresh))

    def add_event(self, **kw) -> int:
        with self._lock:
            idx = len(self.events)
            self.events.append(CollectiveEvent(
                path=f"op[{len(self.ops)}] {kw['name']}", **kw))
            return idx

    def record_collective(self, name, ins, written, fresh_outs, ev):
        """A collective's record: ``args`` is (what it reads, what it
        writes in place); ``outputs`` the fresh tensors it returned."""
        in_refs = tuple(self._ref(t, self.storage_id(t)) for t in ins)
        w_refs = tuple(self._ref(t, self.storage_id(t)) for t in written)
        outs, fresh = self._out_refs(fresh_outs,
                                     {storage_ptr(t) for t in ins})
        with self._lock:
            self.ops.append(OpRecord(
                index=len(self.ops), name=name, args=(in_refs, w_refs),
                written=(1,) if w_refs else (), overwrite=True,
                outputs=outs, fresh=fresh, event=ev))

    # -- dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # A tensor subclass (DTensor) desugars into plain ops and
        # functional collectives first; the mode sees those.
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        ns = func.namespace
        name = f"{ns}.{func._schema.name.split('::')[-1]}"
        if ns in _COLLECTIVE_NAMESPACES:
            return self._collective(func, ns, args, kwargs)
        out = func(*args, **kwargs)
        self.record(name, func, args, kwargs, out)
        return out

    def _event(self, name, pg, ins, kind, red, explicit, root):
        return self.add_event(
            name=name, group=_group_ranks(pg),
            dtype=str(ins[0].dtype).replace("torch.", "") if ins else "",
            shape=tuple(ins[0].shape) if ins else (),
            bytes=sum(_tensor_bytes(t) for t in ins), kind=kind,
            reduce_op=red, explicit=explicit, root=root)

    def _collective(self, func, ns, args, kwargs):
        base = func._schema.name.split("::")[-1]
        b = _bind(func, args, kwargs)
        name = f"{ns}.{base}"
        red = _reduce_op_name(b["reduce_op"]) if "reduce_op" in b else ""
        if ns == "c10d":
            if base not in _C10D:
                raise CaptureError(
                    f"capture does not know the collective {name}; it was "
                    "not run")
            kind, in_arg, out_arg = _C10D[base]
            pg = _unbox_group(b["process_group"])
            ins = _flat(b.get(in_arg)) if in_arg else []
            written = _flat(b.get(out_arg)) if out_arg else []
            root = -1
            if "root_rank" in b:
                root = _group_ranks(pg)[int(b["root_rank"])]
            ev = self._event(name, pg, ins or written, kind, red, True, root)
            _emulate_c10d(base, b, pg)
            if b.get("async_op"):
                self.async_issues[ev] = len(self.ops)
            self.record_collective(name, ins, written, (), ev)
            work = _done_work(written)
            self._works[id(work)] = (work, ev)
            return _c10d_returns(func, b, work)
        if base in _FUNCTIONAL_PASS:
            out = func(*args, **kwargs)
            self.record(name, func, args, kwargs, out)
            return out
        if base not in _FUNCTIONAL:
            raise CaptureError(
                f"capture does not know the collective {name}; it was not "
                "run")
        pg = _unbox_group(b["group_name"])
        ins = _flat(b.get("input", b.get("inputs")))
        root = _group_ranks(pg)[int(b["src"])] if "src" in b else -1
        ev = self._event(name, pg, ins, _FUNCTIONAL[base], red, False, root)
        out = _emulate_functional(base, b, pg)
        self.record_collective(name, ins, (), _flat(out), ev)
        return out


@contextlib.contextmanager
def _waits_recorded(mode: _CaptureMode):
    """Note where each ``Work`` the mode handed out is first waited on
    (``Work.wait`` is not a dispatched op)."""
    work_cls = torch._C._distributed_c10d.Work
    orig = work_cls.wait

    def wait(self, *args, **kwargs):
        hit = mode._works.get(id(self))
        if hit is not None and hit[0] is self:
            with mode._lock:
                mode.waits.setdefault(hit[1], len(mode.ops))
        return orig(self, *args, **kwargs)

    work_cls.wait = wait
    try:
        yield
    finally:
        work_cls.wait = orig


# ---------------------------------------------------------------------------
# The object plane, recorded at the communicator
# ---------------------------------------------------------------------------


_OBJ_METHODS = ("send_obj", "recv_obj", "bcast_obj", "gather_obj",
                "allgather_obj", "allreduce_obj", "scatter_obj", "barrier")


def _obj_bytes(obj) -> int:
    try:
        return len(pickle.dumps(obj))
    except Exception:  # noqa: BLE001 — an unpicklable object is 0 bytes here
        return 0


def _comm_ranks(comm) -> Tuple[int, ...]:
    return tuple(comm._global(r) for r in range(comm.size))


@contextlib.contextmanager
def _object_plane(mode: _CaptureMode):
    """Answer ``CommunicatorBase``'s object plane locally on the capturing
    thread, recording one ``obj.<method>`` event a call; other threads go
    through untouched."""
    from ..communicators.base import CommunicatorBase

    originals = {m: CommunicatorBase.__dict__[m] for m in _OBJ_METHODS}

    def make(method):
        orig = originals[method]

        def patched(self, *args, **kwargs):
            if threading.get_ident() != mode.thread_id:
                return orig(self, *args, **kwargs)
            obj = args[0] if args else kwargs.get("obj", kwargs.get("objs"))
            root = -1
            if method in ("bcast_obj", "scatter_obj"):
                r = args[1] if len(args) > 1 else kwargs.get("root", 0)
                root = self._global(r)
            elif method == "gather_obj":
                r = args[1] if len(args) > 1 else kwargs.get("root")
                root = -1 if r is None else self._global(r)
            elif method in ("send_obj", "recv_obj"):
                r = args[1] if method == "send_obj" else args[0]
                root = self._global(r)
            mode.add_event(
                name=f"obj.{method}", group=_comm_ranks(self),
                dtype="object", shape=(), bytes=_obj_bytes(obj),
                kind="object", reduce_op="", explicit=True, root=root)
            n = self.size
            if method in ("send_obj", "barrier"):
                return None
            if method == "recv_obj":
                raise CaptureError(
                    "recv_obj inside a captured step: no peer answers a "
                    "receive during a capture")
            if method == "bcast_obj":
                return obj
            if method in ("gather_obj", "allgather_obj"):
                r = args[1] if len(args) > 1 else kwargs.get("root")
                if method == "gather_obj" and r is not None \
                        and r != self.rank:
                    return None
                return [obj] * n
            if method == "allreduce_obj":
                op = args[1] if len(args) > 1 else kwargs.get("op")
                red = obj
                for _ in range(n - 1):
                    red = op(red, obj) if op is not None else red + obj
                return red
            if method == "scatter_obj":
                return obj[self.rank] if obj is not None else None
            return orig(self, *args, **kwargs)

        return patched

    for m in _OBJ_METHODS:
        setattr(CommunicatorBase, m, make(m))
    try:
        yield
    finally:
        for m, f in originals.items():
            setattr(CommunicatorBase, m, f)


# ---------------------------------------------------------------------------
# Snapshot and restore
# ---------------------------------------------------------------------------


def _is_multi_node_optimizer(obj) -> bool:
    return hasattr(obj, "actual_optimizer") and hasattr(obj, "communicator")


@dataclasses.dataclass
class _Slot:
    """A tensor to restore: ``rebind(orig)`` puts ``orig`` back where the
    step may have rebound it, then its values are copied back."""

    orig: Any
    copy: Any
    rebind: Any = None


class _Snapshot:
    """Everything :func:`capture_step` restores, gathered from ``state``."""

    def __init__(self, state, comm):
        self.slots: List[_Slot] = []
        self.restorers: List[Any] = []
        self.params: List[Tuple[str, Any]] = []      # (name, tensor)
        self.opt_state: List[Tuple[str, Any]] = []   # (name, tensor)
        self.nbytes = 0
        self._seen_params = set()
        self._seen_opts = set()
        self.n_leaves = 0
        for item in _as_list(state):
            self._take(item)
        if comm is not None:
            self._take_comm(comm)

    # -- gather --------------------------------------------------------
    def _tensor(self, t, rebind=None):
        with torch.no_grad():
            c = t.detach().clone()
        self.nbytes += _tensor_bytes(c)
        self.slots.append(_Slot(t, c, rebind))

    def _param(self, name, p):
        if id(p) in self._seen_params:
            return
        self._seen_params.add(id(p))
        self.n_leaves += 1
        data = p.data
        self.params.append((name, p))

        def rebind(orig, p=p):
            if storage_ptr(p) != storage_ptr(orig) or p.shape != orig.shape:
                p.data = orig
        self._tensor(data, rebind)
        g = p.grad
        if g is None:
            self.restorers.append(lambda p=p: setattr(p, "grad", None))
        else:
            gd = g

            def rebind_grad(orig, p=p):
                if p.grad is not orig:
                    p.grad = orig
            self._tensor(gd, rebind_grad)

    def _module(self, m, prefix=""):
        for name, p in m.named_parameters(prefix=prefix, remove_duplicate=True):
            self._param(name, p)
        for mod_name, mod in m.named_modules(prefix=prefix):
            for bname, buf in list(mod._buffers.items()):
                if buf is None:
                    continue

                def rebind(orig, mod=mod, bname=bname):
                    if mod._buffers.get(bname) is not orig:
                        mod._buffers[bname] = orig
                self._tensor(buf, rebind)

    def _optimizer(self, opt, prefix="opt", params=True):
        if id(opt) in self._seen_opts:
            return
        self._seen_opts.add(id(opt))
        groups = [{k: v for k, v in g.items() if k != "params"}
                  for g in opt.param_groups]
        for g in opt.param_groups:
            for p in g["params"]:
                if p.requires_grad and params:
                    self._param(f"{prefix}.param{len(self.params)}", p)
        before = {}
        for p, st in opt.state.items():
            entry = {}
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    with torch.no_grad():
                        c = v.detach().clone()
                    self.nbytes += _tensor_bytes(c)
                    entry[k] = (v, c)
                    self.opt_state.append((f"{prefix}.state.{k}", v))
                else:
                    entry[k] = (v, None)
            before[p] = entry

        def restore(opt=opt, groups=groups, before=before):
            for g, saved in zip(opt.param_groups, groups):
                for k, v in saved.items():
                    g[k] = v
            opt.state.clear()
            with torch.no_grad():
                for p, entry in before.items():
                    st = {}
                    for k, (v, c) in entry.items():
                        if c is not None:
                            v.copy_(c)
                        st[k] = v
                    opt.state[p] = st
        self.restorers.append(restore)

    def _multi_node(self, mno):
        counts = (mno.step_count, mno.update_count)
        stale = mno._stale
        for p in mno._params:
            self._param(f"param{len(self.params)}", p)
        self._optimizer(mno.actual_optimizer)
        if mno._inner is not None:
            # The rebuilt optimizer's one parameter is the ZeRO shard.
            self._optimizer(mno._inner, "inner", params=False)
        if mno._shard is not None:
            self.params.append(("shard", mno._shard))
            self._tensor(mno._shard)
        if isinstance(stale, torch.Tensor):
            self._tensor(stale)
        elif stale is not None:
            for t in stale:
                self._tensor(t)

        def restore(mno=mno, counts=counts, stale=stale):
            mno.step_count, mno.update_count = counts
            mno._stale = stale
        self.restorers.append(restore)
        if mno._target is not None:
            self._module(mno._target)

    def _take_comm(self, comm):
        saved = {k: getattr(comm, k) for k in ("_fp8_sums",)
                 if hasattr(comm, k)}
        plans = set(getattr(comm, "_reported_plans", ()))

        def restore(comm=comm, saved=saved, plans=plans):
            for k, v in saved.items():
                setattr(comm, k, v)
            if hasattr(comm, "_reported_plans"):
                comm._reported_plans.clear()
                comm._reported_plans.update(plans)
        self.restorers.append(restore)

    def _take(self, item):
        if isinstance(item, torch.nn.Module):
            self._module(item)
        elif isinstance(item, torch.optim.Optimizer):
            self._optimizer(item)
        elif _is_multi_node_optimizer(item):
            self._multi_node(item)
            self._take_comm(item.communicator)
        elif isinstance(item, torch.Tensor):
            self._tensor(item)
        elif isinstance(item, (list, tuple)):
            for x in item:
                self._take(x)
        elif isinstance(item, dict):
            for x in item.values():
                self._take(x)
        else:
            raise TypeError(
                f"capture state: expected modules, optimizers, a "
                f"MultiNodeOptimizer or tensors, got {type(item)}")

    # -- state tensors for the rules -------------------------------------
    def state_refs(self):
        """``[(kind, name, tensor)]`` of the parameters and optimizer state
        as they stand now."""
        out = [("param", n, p) for n, p in self.params]
        out += [("opt", n, t) for n, t in self.opt_state]
        return out

    def restore(self):
        with torch.no_grad():
            for s in self.slots:
                if s.rebind is not None:
                    s.rebind(s.orig)
                s.orig.copy_(s.copy)
        for r in self.restorers:
            r()


def _as_list(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return list(state)
    return [state]


def _rng_state():
    cpu = torch.get_rng_state()
    cuda = (torch.cuda.get_rng_state_all()
            if torch.cuda.is_available() and torch.cuda.is_initialized()
            else None)
    return cpu, cuda


def _set_rng_state(saved):
    cpu, cuda = saved
    torch.set_rng_state(cpu)
    if cuda is not None:
        torch.cuda.set_rng_state_all(cuda)


@contextlib.contextmanager
def _telemetry_muted():
    from ..observability import reporter as _rep
    from ..observability import step_log as _sl

    with _rep._stack_lock:
        reps = list(_rep._stack)
        _rep._stack.clear()
    with _sl._stack_lock:
        recs = list(_sl._stack)
        _sl._stack.clear()
    try:
        yield
    finally:
        with _rep._stack_lock:
            _rep._stack[:0] = reps
        with _sl._stack_lock:
            _sl._stack[:0] = recs


def _batch_leaves(batch) -> List[torch.Tensor]:
    """The tensors of a batch: a tensor, or nested lists, tuples and
    mappings of them."""
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        return [t for v in batch.values() for t in _batch_leaves(v)]
    if isinstance(batch, (list, tuple)):
        return [t for v in batch for t in _batch_leaves(v)]
    return []


def _launches():
    from ..ops import _kernels
    return dict(_kernels.LAUNCHES)


def capture_step(fn, *args, comm=None, state=(), batch_argnum: int = -1,
                 n_leaves: Optional[int] = None, **kwargs) -> CapturedProgram:
    """Run ``fn(*args, **kwargs)`` once under the capture mode and return
    the :class:`CapturedProgram`.

    ``state``: what the step mutates and the capture must restore — a
    module, a ``torch.optim`` optimizer, a
    :class:`~..optimizers.MultiNodeOptimizer` (its parameters, its
    optimizer's state, its counts, its communicator's caches), tensors, or
    a list of them.  The parameters and optimizer state among them are
    what R002 and R005 read.  ``comm``: the communicator whose per-step
    caches are restored too.  ``batch_argnum``: the positional argument
    whose tensors are the taint sources (default the last, the
    ``make_train_step`` convention).  ``n_leaves`` overrides the
    parameter count R004 compares against."""
    snap = _Snapshot(state, comm)
    rng = _rng_state()
    before = [(kind, name, storage_ptr(t), _tensor_bytes(t))
              for kind, name, t in _dedupe_names(snap.state_refs())]
    mode = _CaptureMode(threading.get_ident())
    launches0 = _launches()
    try:
        with _telemetry_muted(), _object_plane(mode), \
                _waits_recorded(mode), mode:
            batch_ids = []
            if args:
                for t in _batch_leaves(args[batch_argnum]):
                    sid = mode.storage_id(t)
                    if sid is not None:
                        batch_ids.append(sid)
            fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        launches1 = _launches()
        # Parameters and optimizer state after the call (a lazily created
        # optimizer state appears here), before anything is restored.
        after = [(kind, name, storage_ptr(t), mode.storage_id(t))
                 for kind, name, t in _after_refs(snap, state)]
    finally:
        snap.restore()
        _set_rng_state(rng)
    by_name = {(k, n): (p, b) for k, n, p, b in before}
    tensors = []
    for kind, name, ptr, sid in after:
        bptr, bbytes = by_name.get((kind, name), (None, 0))
        tensors.append(StateTensor(kind, name, bptr, bbytes, ptr, sid))
    return CapturedProgram(
        ops=mode.ops, events=mode.events,
        batch_storages=tuple(batch_ids), state=tensors,
        n_leaves=n_leaves if n_leaves is not None else (
            snap.n_leaves or None),
        snapshot_bytes=snap.nbytes,
        launches={k: launches1[k] - launches0[k] for k in launches1},
        async_issues=dict(mode.async_issues), waits=dict(mode.waits))


def _after_refs(snap: _Snapshot, state):
    """The parameters (as the snapshot listed them) and every optimizer
    state tensor that exists after the call.  (A plain loop: a recursive
    closure would hold these tensors in a reference cycle until the
    garbage collector ran.)"""
    out = [("param", n, p) for n, p in snap.params]
    seen, todo = set(), _as_list(state)
    while todo:
        item = todo.pop(0)
        if isinstance(item, (list, tuple)):
            todo[:0] = list(item)
            continue
        if isinstance(item, dict):
            todo[:0] = list(item.values())
            continue
        opts = []
        if isinstance(item, torch.optim.Optimizer):
            opts = [(item, "opt")]
        elif _is_multi_node_optimizer(item):
            opts = [(item.actual_optimizer, "opt"), (item._inner, "inner")]
        for opt, prefix in opts:
            if opt is None or id(opt) in seen:
                continue
            seen.add(id(opt))
            for st in opt.state.values():
                for k, v in st.items():
                    if isinstance(v, torch.Tensor):
                        out.append(("opt", f"{prefix}.state.{k}", v))
    return _dedupe_names(out)


def _dedupe_names(refs):
    """Make ``(kind, name)`` unique in order (several moments share a
    state key name across parameters)."""
    counts: Dict[Tuple[str, str], int] = {}
    out = []
    for kind, name, t in refs:
        k = (kind, name)
        i = counts.get(k, 0)
        counts[k] = i + 1
        out.append((kind, name if i == 0 else f"{name}#{i}", t))
    return out

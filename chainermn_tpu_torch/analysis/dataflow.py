"""Taint dataflow over a captured op stream: which storages still carry
*un-reduced* per-rank content.

The port's counterpart of the reference's ``analysis/dataflow.py``, which
walks a jaxpr.  The R002 question is the same — does a gradient computed
from this rank's batch slice reach the optimizer update without a
reduction over the data-parallel group? — and so is the lattice: a taint
is the set of data-parallel *labels* a value still owes a reduction over.

Labels name groups of ranks in a rank-independent way, as the reference's
mesh axis names do: with a communicator they are its axes, ``intra`` (this
rank's node) and ``inter`` (its peers of the same intra rank), each
standing for this rank's group on that axis; without one, each group a
collective runs over is a label of its own.  A collective over a group
``G`` *covers* every label whose ranks lie inside ``G`` (a world
all-reduce covers both axes).

Taints belong to storages, because views share them:

* the batch's storages start with every label;
* an op writes the union of its inputs' taints to its fresh outputs (a
  view shares its base's storage and changes nothing);
* an in-place op that overwrites a whole storage (``copy_``, ``zero_``,
  ``fill_``, an ``out=``) replaces that storage's taint with its other
  inputs'; any other write unions into it; ``_foreach_*`` ops (the
  optimizers') are ordinary in-place ops, element by element;
* the flash kernels' custom ops flow taint like any other op;
* an all-reduce or reduce-scatter of SUM/AVG clears the labels its group
  covers, and so does a MAX/MIN all-reduce (its result is identical on
  every rank, as the reference's ``pmax``/``pmin``); a ``reduce`` clears
  them on its root; a ``broadcast`` gives every rank its root's value, so
  its output takes the root's taint less the covered labels (the root's
  taint, when another rank is the root, is what that rank's own capture
  recorded at the broadcast, exchanged by R002; without the exchange the
  local input stands in);
* gathers and all-to-alls carry their inputs' taint (the gathered values
  still differ by rank), a ``recv`` the taint of what this rank has sent
  (the SPMD reading of a point-to-point exchange).

Each op is visited once, in order: the stream has no loops to iterate
(an eager step unrolls them), so no fixpoint is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple

from .capture import INVARIANT_OPS, CapturedProgram, OpRecord

EMPTY: FrozenSet[str] = frozenset()


def _union(ts) -> FrozenSet[str]:
    out = EMPTY
    for t in ts:
        out = out | t
    return out


@dataclasses.dataclass
class TaintResult:
    """Per-storage taint after the step; per op, the taint of its
    outputs (the union over them, written or fresh); per broadcast, in
    order, its root (a global rank) and this rank's input taint."""

    storage: Dict[int, FrozenSet[str]]
    op_out: List[FrozenSet[str]]
    broadcasts: List[Tuple[int, FrozenSet[str]]]


def covered(labels: Mapping[str, FrozenSet[int]], group) -> FrozenSet[str]:
    g = set(group)
    return frozenset(name for name, ranks in labels.items() if ranks <= g)


def propagate(program: CapturedProgram,
              labels: Mapping[str, FrozenSet[int]],
              rank: int = 0,
              root_taints: Optional[Dict[int, FrozenSet[str]]] = None
              ) -> TaintResult:
    """Run the taint over ``program``'s op stream.  ``labels`` maps each
    label to its ranks (this rank's view); ``rank`` is this process's
    global rank; ``root_taints`` maps a broadcast's position (in order) to
    its root's input taint, where known."""
    taint: Dict[int, FrozenSet[str]] = {}
    seed = frozenset(labels)
    for sid in program.batch_storages:
        taint[sid] = seed
    op_out: List[FrozenSet[str]] = []
    broadcasts: List[Tuple[int, FrozenSet[str]]] = []
    sent = EMPTY

    def read(ref) -> FrozenSet[str]:
        return taint.get(ref.storage, EMPTY)

    def write(ref, t, replace):
        if replace and ref.whole:
            taint[ref.storage] = t
        else:
            taint[ref.storage] = taint.get(ref.storage, EMPTY) | t

    for op in program.ops:
        if op.event is not None:
            ev = program.events[op.event]
            ins = op.args[0] if op.args else ()
            targets = list(op.args[1]) if len(op.args) > 1 else []
            targets += list(op.outputs)
            src = _union(read(r) for r in ins)
            cov = covered(labels, ev.group)
            kind = ev.kind
            new = src
            if kind in ("all_reduce", "reduce_scatter"):
                if ev.reduce_op in INVARIANT_OPS:
                    new = src - cov
            elif kind == "reduce":
                if ev.root != rank:
                    op_out.append(_union(read(r) for r in targets))
                    continue
                if ev.reduce_op in INVARIANT_OPS:
                    new = src - cov
            elif kind == "broadcast":
                i = len(broadcasts)
                broadcasts.append((ev.root, src))
                if ev.root != rank and root_taints is not None \
                        and i in root_taints:
                    new = root_taints[i] - cov
                else:
                    new = src - cov
            elif kind == "send":
                sent = sent | src
                op_out.append(EMPTY)
                continue
            elif kind == "recv":
                new = sent
            elif kind in ("barrier", "object"):
                op_out.append(EMPTY)
                continue
            for r in targets:
                write(r, new, True)
            op_out.append(_union(read(r) for r in targets))
            continue
        _ordinary(op, read, write)
        op_out.append(_union(read(r) for r in op.outputs)
                      | _union(read(r) for w in op.written
                               for r in op.args[w]))
    return TaintResult(taint, op_out, broadcasts)


def _ordinary(op: OpRecord, read, write) -> None:
    lists = [a for a in op.args if len(a) > 1]
    n = len(lists[0]) if lists else 0
    if "_foreach_" in op.name and n and all(len(a) == n for a in lists):
        def elem(a, i):
            return read(a[i]) if len(a) == n else _union(read(r) for r in a)
        for i in range(n):
            t_all = _union(elem(a, i) for a in op.args)
            if op.overwrite:
                t_src = _union(elem(a, i) for j, a in enumerate(op.args)
                               if j not in op.written)
            else:
                t_src = t_all
            for w in op.written:
                a = op.args[w]
                if len(a) == n:
                    write(a[i], t_src, op.overwrite)
            if len(op.outputs) == n and op.fresh[i]:
                write(op.outputs[i], t_all, True)
        if len(op.outputs) != n:
            joint = _union(read(r) for a in op.args for r in a)
            for r, f in zip(op.outputs, op.fresh):
                if f:
                    write(r, joint, True)
        return
    joint = _union(read(r) for a in op.args for r in a)
    if op.written:
        src = (_union(read(r) for j, a in enumerate(op.args)
                      if j not in op.written for r in a)
               if op.overwrite else joint)
        for w in op.written:
            for r in op.args[w]:
                write(r, src, op.overwrite)
    for r, f in zip(op.outputs, op.fresh):
        if f:
            write(r, joint, True)

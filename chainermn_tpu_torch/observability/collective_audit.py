"""Collective audit — the census of a step's wire cost, read off a capture.

Port of the device-independent half of
``chainermn_tpu/observability/hlo_audit.py``: for any call (a built train
step, a communicator's ``allreduce_grad``) count the collectives it issues
and charge each one's per-rank operand bytes to the communicator's axes.
That is the evidence of an algorithm's wire structure on any number of
ranks, and what the two-level communicators' claim is checked against
(:func:`assert_two_dimensional_inter_savings`: two_dimensional's
inter-node bytes are flat's divided by ``intra_size``).

Eager PyTorch has no program to trace.  The audit runs the call once
under :func:`~..analysis.capture.capture_step` (no collective leaves the
process, the state it is given is restored) and reads the capture's
:class:`~..analysis.capture.CollectiveEvent` records, as the linter does:
one record of the step serves both.  The reference's HLO-text half
(``fold_async_counts``, ``audit_jaxpr``, ``audit_hlo_text``,
``audit_compiled``, ``trace_step``) reads XLA's programs and has no
counterpart.

Reading the port's collectives in the reference's terms:

* ``counts`` keeps the port's kinds (``all_reduce``, ``reduce``,
  ``broadcast``, ``reduce_scatter``, ``all_gather``, ``send``, ``recv``,
  ...); a reduction that does not sum carries its op (``all_reduce:MAX``).
  :meth:`CollectiveAudit.census` maps them onto the reference's
  primitives by :data:`CENSUS_PRIMITIVE`.
* A group equal to the communicator's intra group is charged to
  ``"intra"``, its inter group to ``"inter"``, a group of all its ranks
  to both (an op over both axes charges both); any other group under its
  global ranks, ``str(tuple)``.  Without a communicator every group is
  charged under its ranks.
* Operand bytes are the input's bytes per rank, as the reference's
  ``_operand_bytes``: the whole buffer of a reduce-scatter, the shard of
  an all-gather.
* An ``async_op=True`` collective and the first ``wait()`` on its
  ``Work`` are the reference's start/done pair; ``overlap_fraction`` is
  the share of pairs with a compute op dispatched between the two (the
  overlap hooks of :mod:`..communicators.overlap` launch such pairs from
  the backward).  DTensor's functional collectives are issued
  asynchronously by design and are not counted as pairs.

The object plane (pickles over the communicator's gloo group) is not on
the gradient wire and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..analysis.capture import SUM_OPS, CapturedProgram, capture_step

COLLECTIVE_PRIMITIVES = (
    "psum", "reduce_scatter", "all_gather", "ppermute", "all_to_all",
)

#: The primitives that reduce (bucketing makes their count O(n_buckets)).
REDUCTION_PRIMITIVES = ("psum", "reduce_scatter")

#: The four the gradient-allreduce census reports.
ALLREDUCE_CENSUS_KEYS = ("psum", "reduce_scatter", "all_gather", "ppermute")

#: Count key -> the reference's primitive.  Keys without an entry have no
#: one-to-one image and stay out of :meth:`CollectiveAudit.census`:
#: ``broadcast`` (the second half of hierarchical's reduce-then-broadcast,
#: whose reduce carries the reference's one psum over the intra axis),
#: ``recv`` (a ring step's send carries its ppermute), ``gather``,
#: ``scatter``, ``barrier``, and a reduction that does not sum, such as the
#: int8/fp8 wire's ``all_reduce:MAX`` of each bucket's amax (the
#: reference's ``pmax``, which its census does not count either).
CENSUS_PRIMITIVE = {
    "all_reduce": "psum",
    "reduce": "psum",
    "reduce_scatter": "reduce_scatter",
    "all_gather": "all_gather",
    "send": "ppermute",
    "all_to_all": "all_to_all",
}

_REDUCTION_KINDS = ("all_reduce", "reduce", "reduce_scatter")

#: Ops that launch no device work: views, allocations, detaching.  Any
#: other op dispatched between an issue and its wait is compute.
_PLUMBING = frozenset(f"aten.{n}" for n in (
    "view", "_unsafe_view", "reshape", "alias", "detach", "as_strided",
    "slice", "select", "t", "transpose", "permute", "expand", "squeeze",
    "unsqueeze", "split", "split_with_sizes", "chunk", "unbind", "narrow",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_reshape_alias",
))


def _count_key(event) -> str:
    """The ``counts`` key of one captured collective: its kind, with the
    reduce op appended where a reduction does not sum."""
    if event.kind in _REDUCTION_KINDS and event.reduce_op \
            and event.reduce_op not in SUM_OPS:
        return f"{event.kind}:{event.reduce_op}"
    return event.kind


def _axis_names(comm) -> Dict[Tuple[int, ...], Tuple[str, ...]]:
    """Sorted global ranks of a group -> the axes it is charged to."""
    import torch.distributed as dist

    topo = getattr(comm, "topology", None)
    if topo is None:
        return {}
    out = {}
    for name, group in (("inter", topo.inter_group),
                        ("intra", topo.intra_group)):
        if group is not None:
            out[tuple(sorted(dist.get_process_group_ranks(group)))] = (name,)
    world = tuple(sorted(comm._global(r) for r in range(comm.size)))
    out[world] = ("inter", "intra")
    return out


@dataclasses.dataclass
class CollectiveAudit:
    """Census of one captured call's collectives (the reference's fields).

    ``counts`` — occurrences per count key: the collective's kind, with
    the reduce op appended where a reduction does not sum.
    ``bytes_per_axis`` — per-rank operand bytes charged to each axis a
    collective runs over (an op over both axes charges both).
    ``bytes_per_primitive`` — per-rank operand bytes per count key.
    ``op_bytes`` — per-rank operand bytes of each occurrence, in issue
    order per count key: with bucketing, the per-bucket byte profile.
    ``async_pairs`` — ``async_op=True`` collectives whose ``Work`` was
    waited on in the call.
    ``overlap_fraction`` — the share of those pairs with at least one
    compute op dispatched between the issue and the wait (0.0 without
    pairs).
    ``program`` — the capture the audit was read from."""

    counts: Dict[str, int]
    bytes_per_axis: Dict[str, int]
    bytes_per_primitive: Dict[str, int]
    op_bytes: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    async_pairs: int = 0
    overlap_fraction: float = 0.0
    program: Optional[CapturedProgram] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def from_program(cls, program: CapturedProgram,
                     comm=None) -> "CollectiveAudit":
        axes = _axis_names(comm) if comm is not None else {}
        counts: Dict[str, int] = {}
        per_axis: Dict[str, int] = {}
        per_prim: Dict[str, int] = {}
        op_bytes: Dict[str, List[int]] = {}
        for e in program.events:
            if e.kind == "object":
                continue
            key = _count_key(e)
            counts[key] = counts.get(key, 0) + 1
            per_prim[key] = per_prim.get(key, 0) + e.bytes
            op_bytes.setdefault(key, []).append(e.bytes)
            group = tuple(sorted(e.group))
            for ax in axes.get(group, (str(group),)):
                per_axis[ax] = per_axis.get(ax, 0) + e.bytes
        pairs = overlapped = 0
        for ev, issue in program.async_issues.items():
            wait = program.waits.get(ev)
            if wait is None:
                continue
            pairs += 1
            if any(op.event is None and op.name not in _PLUMBING
                   for op in program.ops[issue + 1:wait]):
                overlapped += 1
        return cls(counts, per_axis, per_prim, op_bytes, pairs,
                   overlapped / pairs if pairs else 0.0, program)

    def census(self, keys=ALLREDUCE_CENSUS_KEYS) -> Dict[str, int]:
        """Fixed-key count view in the reference's primitives (zeros
        included): the allreduce bench's ``hlo_collectives`` record."""
        folded: Dict[str, int] = {}
        for k, n in self.counts.items():
            prim = CENSUS_PRIMITIVE.get(k)
            if prim is not None:
                folded[prim] = folded.get(prim, 0) + n
        return {k: folded.get(k, 0) for k in keys}

    def reduction_collectives(self) -> int:
        """Reduction occurrences (psum + reduce_scatter of the census)."""
        c = self.census(COLLECTIVE_PRIMITIVES)
        return sum(c[k] for k in REDUCTION_PRIMITIVES)

    def summary(self) -> dict:
        return {
            "counts": dict(self.counts),
            "bytes_per_axis": dict(self.bytes_per_axis),
            "bytes_per_primitive": dict(self.bytes_per_primitive),
            "op_bytes": {k: list(v) for k, v in self.op_bytes.items()},
            "reduction_collectives": self.reduction_collectives(),
            "async_pairs": self.async_pairs,
            "overlap_fraction": self.overlap_fraction,
        }


def audit_fn(fn, *args, comm=None, state=(), **kwargs) -> CollectiveAudit:
    """Run ``fn(*args, **kwargs)`` once under the capture and audit it.

    ``comm`` names the axes (and its per-step caches are restored);
    ``state`` is what the call mutates — modules, optimizers, a
    ``MultiNodeOptimizer``, tensors — restored in place afterwards with
    the RNG states, as :func:`~..analysis.capture.capture_step` does."""
    program = capture_step(fn, *args, comm=comm, state=state, **kwargs)
    return CollectiveAudit.from_program(program, comm)


def audit_allreduce(comm, nbytes: int,
                    dtype=torch.float32) -> CollectiveAudit:
    """``comm.allreduce_grad`` over one buffer of ``nbytes`` per rank on
    the communicator's device (the single-tensor path: no buckets)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    buf = torch.ones(max(1, nbytes // itemsize), dtype=dtype,
                     device=comm.device)
    return audit_fn(lambda b: comm.allreduce_grad([b]), buf, comm=comm,
                    state=[buf])


def _leaves(tensors) -> List[torch.Tensor]:
    if isinstance(tensors, dict):
        return list(tensors.values())
    return list(tensors)


def audit_allreduce_tree(comm, tensors,
                         overlap: bool = False) -> CollectiveAudit:
    """``comm.allreduce_grad`` over this rank's tensors (a mapping or a
    sequence; values restored afterwards).

    With bucketing (the communicator's ``bucket_bytes``) the reductions
    are O(n_buckets) and ``op_bytes`` holds each bucket's wire size; with
    ``bucket_bytes=0`` the per-tensor path shows.  ``overlap=True``
    audits the backward-overlapped launch instead: each floating tensor
    becomes the gradient of a parameter in a backward pass under
    :class:`~..communicators.overlap.BackwardOverlap`, whose hooks launch
    each bucket as soon as it is complete."""
    leaves = _leaves(tensors)
    if not overlap:
        return audit_fn(lambda ts: comm.allreduce_grad(ts), leaves,
                        comm=comm, state=leaves)
    from ..communicators.overlap import BackwardOverlap

    params = [torch.nn.Parameter(t.detach().clone()) for t in leaves]
    ov = BackwardOverlap(comm, params,
                         comm.resolve_overlap_granularity(params),
                         wire=comm.wire_dtype(params))

    def backward(ts):
        ov.arm()
        # d(sum(p * t))/dp = t: each parameter's gradient is its tensor.
        loss = sum((p * t).sum().float() for p, t in zip(params, ts))
        loss.backward()
        ov.finish()

    try:
        return audit_fn(backward, leaves, comm=comm, state=params)
    finally:
        ov.remove()


def assert_two_dimensional_inter_savings(profiles: dict,
                                         intra_size: int) -> None:
    """``profiles``: {communicator_name: bytes_per_axis dict}.  Asserts
    the 2D claim when both sides are present: two_dimensional's
    inter-axis operand bytes == flat's / intra_size (the reference's
    rationale for the 2D algorithm on slow inter-node links)."""
    flat = next(
        (profiles[k] for k in ("flat", "xla_ici", "pure_nccl")
         if k in profiles), None,
    )
    td = profiles.get("two_dimensional")
    if flat is None or td is None:
        return
    flat_inter = flat.get("inter", 0)
    td_inter = td.get("inter", 0)
    assert flat_inter > 0 and td_inter > 0, (profiles,)
    assert td_inter * intra_size == flat_inter, (
        f"two_dimensional inter-axis bytes {td_inter} x intra "
        f"{intra_size} != flat's {flat_inter} — the 2D bandwidth claim "
        "does not hold in the captured call"
    )


__all__ = [
    "ALLREDUCE_CENSUS_KEYS", "CENSUS_PRIMITIVE", "COLLECTIVE_PRIMITIVES",
    "REDUCTION_PRIMITIVES", "CollectiveAudit",
    "assert_two_dimensional_inter_savings", "audit_allreduce",
    "audit_allreduce_tree", "audit_fn",
]

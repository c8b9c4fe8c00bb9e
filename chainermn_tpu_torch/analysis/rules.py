"""The lint ruleset, R001–R006 — port of ``chainermn_tpu/analysis/rules.py``.

Each rule keeps the reference's id, name and severity and reads the
captured program of :mod:`.capture` where the reference reads a jaxpr.
Where the meaning had to change, the rule's docstring says how.
"""

from __future__ import annotations

from typing import List

from . import dataflow
from .core import (Finding, LintContext, SEVERITY_ERROR,
                   group_fingerprints, register_rule)

#: dtypes whose reduction accumulates in reduced precision on the wire.
NARROW_DTYPES = ("bfloat16", "float16")

#: quantized wire dtypes produced by ``comm_dtype=`` — legitimate ONLY
#: inside the blessed scale→cast→reduce→cast→unscale pattern, whose tell
#: is the amax MAX all-reduce over the same group.
QUANT_WIRE_DTYPES = ("int8", "float8_e4m3fn", "float8_e4m3")

#: below this leaf count the per-leaf and bucketed launches coincide, so
#: R004 cannot (and need not) distinguish them.
_R004_MIN_LEAVES = 4


def _axes(ctx: LintContext, group) -> tuple:
    """The data-parallel labels a group covers, else its ranks."""
    cov = dataflow.covered(ctx.labels(), group)
    return tuple(sorted(cov)) if cov else tuple(str(r) for r in group)


@register_rule(
    "R001", "collective-order-divergence",
    "collective sequence differs across cond branches or across ranks — "
    "deadlock risk at dispatch",
)
def check_collective_divergence(ctx: LintContext) -> List[Finding]:
    """The cross-rank half: every rank captures its step, then the ranks
    compare their collective sequences over the communicator's object
    plane, outside the capture.  The comparison is group by group
    (:func:`~.core.group_fingerprints`): every member of a group must
    issue the same collectives on it in the same order — the deadlock
    criterion, which two-level patterns meet although their ranks' whole
    sequences differ (only ``hierarchical``'s node leaders join the
    inter-node all-reduce).  The reference's other half — a ``cond`` whose
    branches trace different collective sequences — has no counterpart:
    eager execution takes one branch, so the branches cannot be compared;
    the comparison across ranks catches the divergence that branch causes
    on the ranks that took the other one."""
    comm = ctx.comm
    if comm is None or getattr(comm, "size", 1) <= 1:
        return []
    mine = group_fingerprints(ctx.program)
    gathered = dict(comm.allgather_obj((ctx.rank(), mine)))
    empty = group_fingerprints(None).get((), "")
    bad = []
    for group in sorted({g for m in gathered.values() for g in m}):
        fps = {gathered[r].get(group, empty) for r in group
               if r in gathered}
        if len(fps) > 1:
            bad.append((group, len(fps)))
    if not bad:
        return []
    group, n = bad[0]
    return [Finding(
        rule="R001", severity=SEVERITY_ERROR,
        message=(
            "collective fingerprint differs across ranks "
            f"({n} distinct sequences on group {list(group)}; "
            f"{len(bad)} group(s) disagree): the step programs are not "
            "SPMD and will deadlock at the first mismatched collective"
        ),
        axes=tuple(str(r) for r in group),
        fix_hint=(
            "remove rank-dependent branching from the step (model config, "
            "loss selection, communicator choice and every collective "
            "must match on every process)"
        ),
    )]


@register_rule(
    "R002", "unreduced-gradient",
    "a gradient computed under the data-parallel axis reaches the "
    "optimizer update with no psum/allreduce on that axis",
    requires=("jaxpr", "args"),
)
def check_unreduced_gradient(ctx: LintContext) -> List[Finding]:
    """A parameter or optimizer-state tensor still carries a data-parallel
    taint after the step (see :mod:`.dataflow`).  Runs only when a
    data-parallel group has more than one rank: at world 1 there is
    nothing to diverge from (and the port's ``allreduce_grad`` issues no
    collective there).  With a communicator of more than one rank the
    ranks exchange each broadcast's input taint over its object plane (a
    broadcast's output is its root's value), so every rank must lint."""
    labels = ctx.labels()
    live = frozenset(n for n, ranks in labels.items() if len(ranks) > 1)
    if not live:
        return []
    prog = ctx.program
    rank = ctx.rank()
    res = dataflow.propagate(prog, labels, rank)
    comm = ctx.comm
    if comm is not None and comm.size > 1:
        mine = [(root, sorted(t)) for root, t in res.broadcasts]
        gathered = dict(comm.allgather_obj((rank, mine)))
        roots = {}
        for i, (root, _) in enumerate(res.broadcasts):
            theirs = gathered.get(root)
            if theirs is not None and i < len(theirs) \
                    and theirs[i][0] == root:
                roots[i] = frozenset(theirs[i][1])
        if roots:
            res = dataflow.propagate(prog, labels, rank, roots)
    hits, axes = [], set()
    for st in prog.state:
        if st.after_storage is None:
            continue
        t = res.storage.get(st.after_storage, dataflow.EMPTY) & live
        if t:
            hits.append(st.name)
            axes |= t
    if not hits:
        return []
    axes = tuple(sorted(axes))
    return [Finding(
        rule="R002", severity=SEVERITY_ERROR,
        message=(
            f"{len(hits)} parameter/optimizer-state tensor(s) still carry "
            f"un-reduced per-rank gradient content on data-parallel axes "
            f"{axes} after the step (first: {hits[0]}): replicas will "
            "silently diverge"
        ),
        axes=axes,
        fix_hint=(
            "average gradients before the optimizer update — "
            "communicator.allreduce_grad(grads), or torch.distributed."
            "all_reduce over the data-parallel group and divide"
        ),
    )]


@register_rule(
    "R003", "narrow-dtype-reduction",
    "psum/psum_scatter accumulates a bf16/fp16 or bare int8/fp8 payload "
    "without an explicit opt-in or the scaled-quantization pattern",
)
def check_narrow_dtype_reduction(ctx: LintContext) -> List[Finding]:
    """A narrow (bf16/fp16) or bare quantized (int8/fp8) explicit
    reduction.  Blessed by the communicator's ``allreduce_grad_dtype``
    (intent), by a resolved ``comm_dtype`` (the communicator emits the
    scaled wire itself), or structurally by a MAX all-reduce over a group
    covering the same ranks (the amax agreement of the scaled wire)."""
    comm = ctx.comm
    if comm is not None and \
            getattr(comm, "allreduce_grad_dtype", None) is not None:
        return []
    comm_quant = None
    if comm is not None:
        resolve = getattr(comm, "resolve_comm_dtype", None)
        comm_quant = resolve() if callable(resolve) else None
    max_groups = [set(e.group) for e in ctx.events()
                  if e.explicit and e.kind == "all_reduce"
                  and e.reduce_op == "MAX"]
    findings = []
    for e in ctx.get_audit().reductions():
        if e.dtype in QUANT_WIRE_DTYPES:
            if comm_quant is not None:
                continue
            if any(set(e.group) <= g for g in max_groups):
                continue
            findings.append(Finding(
                rule="R003", severity=SEVERITY_ERROR,
                message=(
                    f"{e.name} reduces a bare {e.dtype} payload of shape "
                    f"{list(e.shape)} with no amax scale exchange: an "
                    "unscaled narrow sum wraps or saturates as the world "
                    "grows"
                ),
                eqn_path=e.path, axes=_axes(ctx, e.group), bytes=e.bytes,
                fix_hint=(
                    "use comm_dtype= on the communicator (or "
                    "CHAINERMN_TPU_COMM_DTYPE) so the reduction is wrapped "
                    "in the scaled pattern: MAX-reduce the bucket amax, "
                    "divide by the per-rank budget, reduce, rescale"
                ),
            ))
            continue
        if e.dtype not in NARROW_DTYPES:
            continue
        findings.append(Finding(
            rule="R003", severity=SEVERITY_ERROR,
            message=(
                f"{e.name} reduces a {e.dtype} payload of shape "
                f"{list(e.shape)}: the accumulation itself runs in "
                f"{e.dtype}, silently losing gradient precision as the "
                "world grows"
            ),
            eqn_path=e.path, axes=_axes(ctx, e.group), bytes=e.bytes,
            fix_hint=(
                "keep gradients float32 through the collective, or opt in "
                "explicitly with allreduce_grad_dtype= on the communicator "
                "(which also suppresses this rule)"
            ),
        ))
    return findings


@register_rule(
    "R004", "bucketing-regression",
    "reduction-collective count scales with parameter leaf count "
    "instead of bucket count",
    requires=("audit",),
)
def check_bucketing_regression(ctx: LintContext) -> List[Finding]:
    """Explicit reductions >= the parameter leaf count, from 4 leaves up:
    the unbucketed per-leaf launch leaking back in.  An ``async_op=True``
    collective and its later wait are one event (the overlapped
    schedule), so overlap is never misread as a regression; DTensor's
    functional collectives are not counted
    (:meth:`~.capture.CollectiveCensus.reductions`)."""
    n_leaves = ctx.n_leaves
    if not n_leaves or n_leaves < _R004_MIN_LEAVES:
        return []
    red = ctx.get_audit().reductions()
    if len(red) < n_leaves:
        return []
    return [Finding(
        rule="R004", severity=SEVERITY_ERROR,
        message=(
            f"{len(red)} reduction collectives for a {n_leaves}-leaf "
            "parameter tree: the gradient allreduce is scaling with "
            "leaf count, not bucket count"
        ),
        bytes=sum(e.bytes for e in red),
        fix_hint=(
            "re-enable gradient bucketing: bucket_bytes>0 on the "
            "communicator (and check CHAINERMN_TPU_BUCKET_BYTES is not "
            "set to 0)"
        ),
    )]


@register_rule(
    "R005", "donation-audit",
    "train step rebinds parameters or optimizer state to new storage "
    "instead of updating them in place",
)
def check_donation(ctx: LintContext) -> List[Finding]:
    """The reference flags a step compiled without donating its buffers:
    XLA must then keep the old and the new parameters alive at once.  The
    eager counterpart of that doubled memory is a step that rebinds a
    parameter or optimizer-state tensor to a new storage
    (``p.data = p.data - lr * g``) instead of updating it in place: the
    old and the new tensors were both alive.  Fires for every such tensor
    that held bytes before the step (a ZeRO-3 parameter released between
    steps holds none)."""
    hits, nbytes = [], 0
    for st in ctx.program.state:
        if st.before_ptr is None or st.before_bytes == 0:
            continue
        if st.after_ptr != st.before_ptr:
            hits.append(st.name)
            nbytes += st.before_bytes
    if not hits:
        return []
    return [Finding(
        rule="R005", severity=SEVERITY_ERROR,
        message=(
            f"step rebinds {len(hits)} parameter/optimizer-state "
            f"tensor(s) (~{nbytes} bytes; first: {hits[0]}) to new "
            "storage instead of updating in place: the old and the new "
            "tensors are both alive, doubling their memory"
        ),
        bytes=nbytes,
        fix_hint=(
            "update in place — torch.optim's step, p.add_(...), or "
            "p.copy_(new) under torch.no_grad() — instead of assigning "
            "p.data or a new tensor"
        ),
    )]


@register_rule(
    "R006", "sharding-plan-coverage",
    "a sharding plan leaves parameter leaves unmatched or resolves a "
    "leaf to a spec that cannot apply",
    requires=("plan",),
)
def check_plan_coverage(ctx: LintContext) -> List[Finding]:
    """The port's :func:`~..sharding.validate`'s two error classes as
    findings (shadowed rules stay advisory, in ``validate``'s summary)."""
    from ..sharding import validate

    v = validate(ctx.plan, ctx.plan_params)
    findings: List[Finding] = []
    for path in v.unmatched:
        findings.append(Finding(
            rule="R006", severity=SEVERITY_ERROR,
            message=(
                f"plan {ctx.plan.name!r} has no rule matching parameter "
                f"leaf '{path}': resolution raises and the layout is "
                "undefined for this model"
            ),
            eqn_path=path,
            fix_hint=(
                "add a rule whose regex matches this path, or end the "
                "plan with a terminal catch-all "
                "PlanRule('replicate', r'.*', P())"
            ),
        ))
    for c in v.conflicts:
        findings.append(Finding(
            rule="R006", severity=SEVERITY_ERROR,
            message=(
                f"plan {ctx.plan.name!r} rule {c['rule']!r} resolves "
                f"leaf '{c['path']}' to a conflicting spec: {c['reason']}"
            ),
            eqn_path=c["path"],
            fix_hint=(
                "fix the rule's PartitionSpec (one mesh axis per entry, "
                "no more entries than the leaf has dims, axes that "
                "exist on the target mesh)"
            ),
        ))
    return findings


"""Collective-correctness linter — core engine.

Port of ``chainermn_tpu/analysis/core.py``.  The reference traces a step
into a jaxpr and evaluates a registry of rules over it before the step
ever runs.  An eager step has no jaxpr: here the step runs once under
:func:`~.capture.capture_step` — a dispatch mode that records every op
and collective, runs no collective on the caller's group, and restores
every tensor and RNG state it touched — and the same registry of rules
reads the captured program.  The costliest distributed failures are
silently wrong or hung programs — ranks issuing divergent collective
sequences (deadlock at the first mismatch), gradients applied without an
allreduce over the data-parallel group (silent replica divergence),
reductions accumulating in bf16 — and all of them show in that program.

Entry points:

* :func:`analyze_fn` — capture ``fn(*args, **kwargs)`` and run the rules;
  ``state=`` names what the step mutates (modules, optimizers, a
  ``MultiNodeOptimizer``), which the capture restores and R002/R005 read.
* :func:`analyze_program` — the counterpart of ``analyze_jaxpr``: run the
  rules over a captured program, or a bare
  :class:`~.capture.CollectiveCensus` (rules that need the op stream are
  reported in ``rules_skipped``).
* :func:`analyze_plan` — lint a sharding plan against parameters (R006).
* :func:`assert_lint_clean` — raise :class:`LintError` on any
  error-severity finding.

``requires`` keeps the reference's tokens: ``"jaxpr"`` means a captured
program, ``"audit"`` a census, ``"args"`` the step's arguments (the batch,
R002's taint sources), ``"plan"`` and ``"host"`` as in the reference.

Suppression: ``# lint: disable=R002`` comments in the step function's
source, the ``disable=``/``rules=`` allowlists, or the
``CHAINERMN_TPU_LINT_DISABLE`` environment variable (comma-separated
rule ids).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import re
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, \
    Tuple

from .capture import (CapturedProgram, CollectiveCensus, CollectiveEvent,
                      capture_step)

#: comma-separated rule ids disabled process-wide (e.g. "R003,R005").
ENV_DISABLE = "CHAINERMN_TPU_LINT_DISABLE"

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

_DISABLE_COMMENT_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_, \t]+)")


@dataclasses.dataclass
class Finding:
    """One structured lint finding.

    ``eqn_path`` locates the offending op in the captured stream
    (``"op[123] c10d.allreduce_"``, stable across runs of the same
    program) or the source/plan path; ``axes`` the data-parallel labels
    (or group ranks) it concerns; ``bytes`` the operand payload (0 when
    not applicable)."""

    rule: str
    severity: str
    message: str
    eqn_path: str = ""
    axes: Tuple[str, ...] = ()
    bytes: int = 0
    fix_hint: str = ""

    def summary(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "eqn_path": self.eqn_path,
            "axes": list(self.axes),
            "bytes": self.bytes,
            "fix_hint": self.fix_hint,
        }

    def render(self) -> str:
        loc = f" at {self.eqn_path}" if self.eqn_path else ""
        ax = f" axes={','.join(self.axes)}" if self.axes else ""
        hint = f"\n    fix: {self.fix_hint}" if self.fix_hint else ""
        return (
            f"{self.rule} [{self.severity}]{loc}{ax}: {self.message}{hint}"
        )


@dataclasses.dataclass
class Rule:
    """A registered lint rule.  ``check(ctx)`` returns findings;
    ``requires`` names the context pieces it needs; the engine skips the
    rule, rather than erroring, when the input form cannot satisfy them."""

    id: str
    name: str
    summary: str
    check: Callable[["LintContext"], List[Finding]]
    requires: Tuple[str, ...] = ("jaxpr",)


#: rule id -> Rule.  Populated by ``register_rule`` when
#: ``chainermn_tpu_torch.analysis.rules`` imports.
RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, name: str, summary: str,
                  requires: Tuple[str, ...] = ("jaxpr",)):
    def deco(check):
        RULES[rule_id] = Rule(rule_id, name, summary, check, requires)
        return check

    return deco


def _registry() -> Dict[str, Rule]:
    if not RULES:
        from . import rules as _rules  # noqa: F401
    return RULES


def list_rules() -> List[Tuple[str, str, str]]:
    """``[(id, name, one-line summary)]`` for every registered rule."""
    reg = _registry()
    return [(r.id, r.name, r.summary) for _, r in sorted(reg.items())]


# ----------------------------------------------------------------------
# Collective sequences
# ----------------------------------------------------------------------
def collective_events(program) -> List[CollectiveEvent]:
    """Every collective of a captured program (or census) in issue order —
    the sequence whose cross-rank agreement R001 checks."""
    if program is None:
        return []
    return list(program.events)


def group_key(group) -> List[int]:
    """A group as every member describes it alike: the offsets of its
    global ranks from its lowest one (an intra group ``(2, 3)`` and
    ``(0, 1)`` both read ``[0, 1]``)."""
    g = sorted(group)
    return [r - g[0] for r in g] if g else []


def collective_fingerprint(program) -> str:
    """sha256 over ``[name, group, dtype, shape]`` of every collective in
    issue order, the group in its rank-independent form
    (:func:`group_key`).  Two ranks whose steps hash differently WILL
    deadlock or corrupt at the first mismatched collective; comparing this
    string over the communicator's object plane is the pre-launch check."""
    sig = [
        [e.name, group_key(e.group), e.dtype, list(e.shape)]
        for e in collective_events(program)
    ]
    return hashlib.sha256(
        json.dumps(sig, separators=(",", ":")).encode()
    ).hexdigest()


def group_fingerprints(program) -> Dict[Tuple[int, ...], str]:
    """Per group (its global ranks), sha256 over ``[name, dtype, shape]``
    of the collectives this rank issued on it, in order; ``{(): ...}``
    holds the digest of an empty sequence.  R001 holds every member of a
    group to the same digest."""
    seqs: Dict[Tuple[int, ...], list] = {(): []}
    for e in collective_events(program):
        seqs.setdefault(tuple(e.group), []).append(
            [e.name, e.dtype, list(e.shape)])
    return {g: hashlib.sha256(json.dumps(
        sig, separators=(",", ":")).encode()).hexdigest()
        for g, sig in seqs.items()}


# ----------------------------------------------------------------------
# Context and report
# ----------------------------------------------------------------------
def _group_ranks(group) -> FrozenSet[int]:
    import torch.distributed as dist

    if group is None:
        return frozenset({dist.get_rank()})
    return frozenset(dist.get_process_group_ranks(group))


@dataclasses.dataclass
class LintContext:
    """Everything a rule may look at.  Any piece may be ``None``/empty
    depending on the entry point; a rule's ``requires`` declares what it
    cannot do without."""

    program: Optional[CapturedProgram] = None
    census: Optional[CollectiveCensus] = None
    comm: Any = None
    n_leaves: Optional[int] = None
    fn: Any = None
    #: label -> global ranks of this rank's group (see dataflow); resolved
    #: from the communicator or the collectives when not given.
    dp_labels: Optional[Dict[str, FrozenSet[int]]] = None
    #: sharding plan + parameters for coverage rules (R006).
    plan: Any = None
    plan_params: Any = None
    #: host-plane source corpus (H001–H005).
    host: Any = None

    def events(self) -> List[CollectiveEvent]:
        if self.program is not None:
            return list(self.program.events)
        if self.census is not None:
            return list(self.census.events)
        return []

    def get_audit(self) -> Optional[CollectiveCensus]:
        if self.census is None and self.program is not None:
            self.census = self.program.census
        return self.census

    def rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0

    def labels(self) -> Dict[str, FrozenSet[int]]:
        if self.dp_labels is None:
            self.dp_labels = _resolve_labels(self)
        return self.dp_labels

    def has(self, req: str) -> bool:
        if req == "jaxpr":
            return self.program is not None
        if req == "audit":
            return self.get_audit() is not None
        if req == "args":
            return self.program is not None
        if req == "plan":
            return self.plan is not None and self.plan_params is not None
        if req == "host":
            return self.host is not None
        return False


def _resolve_labels(ctx: LintContext) -> Dict[str, FrozenSet[int]]:
    """The data-parallel labels: the communicator's axes (this rank's
    ``intra`` and ``inter`` groups) when one is in hand, else one label
    per group any collective runs over, else none (nothing to reduce)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return {}
    comm = ctx.comm
    if comm is not None and getattr(comm, "topology", None) is not None:
        topo = comm.topology
        return {"inter": _group_ranks(topo.inter_group),
                "intra": _group_ranks(topo.intra_group)}
    groups = sorted({e.group for e in ctx.events()})
    return {"g:" + ",".join(str(r) for r in g): frozenset(g)
            for g in groups}


class LintError(AssertionError):
    """Raised by :func:`assert_lint_clean`; carries the full report."""

    def __init__(self, report: "LintReport"):
        self.report = report
        super().__init__(report.render())


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]
    rules_run: Tuple[str, ...] = ()
    rules_skipped: Tuple[str, ...] = ()
    suppressed: int = 0
    #: the captured program the rules read (``None`` off the fn/program
    #: entry points); not part of :meth:`summary`.
    program: Optional[CapturedProgram] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.summary() for f in self.findings],
            "rules_run": list(self.rules_run),
            "rules_skipped": list(self.rules_skipped),
            "suppressed": self.suppressed,
        }

    def render(self) -> str:
        if not self.findings:
            return (
                f"lint clean ({len(self.rules_run)} rules: "
                f"{', '.join(self.rules_run)})"
            )
        lines = [f.render() for f in self.findings]
        lines.append(
            f"{len(self.findings)} finding(s), {len(self.errors)} error(s)"
        )
        return "\n".join(lines)


# ----------------------------------------------------------------------
# Suppression
# ----------------------------------------------------------------------
def _source_disables(fn) -> frozenset:
    """Rule ids named in ``# lint: disable=R00x`` comments in ``fn``'s
    source (the per-step allowlist)."""
    if fn is None:
        return frozenset()
    try:
        src = inspect.getsource(inspect.unwrap(fn))
    except (TypeError, OSError):
        return frozenset()
    ids = set()
    for m in _DISABLE_COMMENT_RE.finditer(src):
        ids.update(t.strip() for t in m.group(1).split(",") if t.strip())
    return frozenset(ids)


def _env_disables() -> frozenset:
    raw = os.environ.get(ENV_DISABLE, "")
    return frozenset(t.strip() for t in raw.split(",") if t.strip())


# ----------------------------------------------------------------------
# Engine
# ----------------------------------------------------------------------
def _run_rules(ctx: LintContext, rules: Optional[Sequence[str]],
               disable: Sequence[str]) -> LintReport:
    reg = _registry()
    selected = list(rules) if rules else sorted(reg)
    unknown = [r for r in selected if r not in reg]
    if unknown:
        raise ValueError(
            f"unknown lint rule(s) {unknown}; known: {sorted(reg)}"
        )
    disabled = set(disable) | _env_disables() | _source_disables(ctx.fn)

    run, skipped, findings, suppressed = [], [], [], 0
    for rid in selected:
        if rid in disabled:
            suppressed += 1
            continue
        rule = reg[rid]
        if not all(ctx.has(req) for req in rule.requires):
            skipped.append(rid)
            continue
        findings.extend(rule.check(ctx))
        run.append(rid)
    findings.sort(key=lambda f: (f.rule, f.eqn_path))
    return LintReport(
        findings=findings,
        rules_run=tuple(run),
        rules_skipped=tuple(skipped),
        suppressed=suppressed,
        program=ctx.program,
    )


def _pin_labels(ctx: LintContext, dp_axes) -> None:
    if dp_axes:
        keep = set(dp_axes)
        ctx.dp_labels = {k: v for k, v in ctx.labels().items() if k in keep}


def analyze_fn(fn, *args, comm=None, rules: Optional[Sequence[str]] = None,
               disable: Sequence[str] = (), batch_argnum: int = -1,
               dp_axes: Optional[Sequence[str]] = None, state=(),
               n_leaves: Optional[int] = None, **kwargs) -> LintReport:
    """Capture ``fn(*args, **kwargs)`` once and lint the program.

    ``comm`` enables the cross-rank checks (R001's fingerprint, R002's
    broadcast exchange; both collective over its object plane: every rank
    must lint) and the communicator-aware intent checks (R003's
    ``allreduce_grad_dtype``).  ``state`` is what the step mutates — a
    module, optimizer, ``MultiNodeOptimizer`` or a list of them; the
    capture restores it and R002/R005 read its parameters and optimizer
    state.  ``batch_argnum`` names the positional argument carrying the
    data-parallel batch (default the last, the ``make_train_step``
    convention); ``dp_axes`` keeps only those data-parallel labels
    (``"intra"``/``"inter"`` with a communicator)."""
    program = capture_step(fn, *args, comm=comm, state=state,
                           batch_argnum=batch_argnum, n_leaves=n_leaves,
                           **kwargs)
    ctx = LintContext(program=program, comm=comm, fn=fn,
                      n_leaves=program.n_leaves)
    _pin_labels(ctx, dp_axes)
    return _run_rules(ctx, rules, disable)


def analyze_program(program, comm=None,
                    rules: Optional[Sequence[str]] = None,
                    disable: Sequence[str] = (),
                    dp_axes: Optional[Sequence[str]] = None,
                    n_leaves: Optional[int] = None) -> LintReport:
    """Lint an already-captured program, or a bare
    :class:`~.capture.CollectiveCensus` (census-only rules such as R004
    then run; the rules that need the op stream are reported in
    ``rules_skipped``).  ``n_leaves`` feeds R004's leaf-count comparison
    when the program carries none."""
    if isinstance(program, CollectiveCensus):
        ctx = LintContext(census=program, comm=comm, n_leaves=n_leaves)
    else:
        ctx = LintContext(program=program, comm=comm,
                          n_leaves=n_leaves if n_leaves is not None
                          else program.n_leaves)
        _pin_labels(ctx, dp_axes)
    return _run_rules(ctx, rules, disable)


def analyze_plan(plan, params, rules: Optional[Sequence[str]] = None,
                 disable: Sequence[str] = ()) -> LintReport:
    """Lint a sharding plan against a module or a ``{path: shape}``
    mapping (rule R006: unmatched leaves, spec conflicts); nothing runs.
    The program rules are reported in ``rules_skipped``."""
    ctx = LintContext(plan=plan, plan_params=params)
    return _run_rules(ctx, rules, disable)


def assert_lint_clean(fn, *args, comm=None,
                      rules: Optional[Sequence[str]] = None,
                      disable: Sequence[str] = (), **kwargs) -> LintReport:
    """Lint and raise :class:`LintError` on any error-severity finding.
    Returns the (clean) report otherwise."""
    report = analyze_fn(
        fn, *args, comm=comm, rules=rules, disable=disable, **kwargs
    )
    if not report.ok:
        raise LintError(report)
    return report

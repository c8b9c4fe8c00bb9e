"""Collective-correctness linter for captured step programs — port of
``chainermn_tpu/analysis``.

A step runs once under :func:`capture_step` (a dispatch mode that records
every op and collective, runs no collective on the caller's group, and
restores what the step mutated) and a registry of rules reads the
captured program — collective-order divergence across ranks (R001),
unreduced gradients (R002), narrow-dtype reductions (R003), bucketing
regressions (R004), updates that rebind instead of updating in place
(R005), sharding-plan coverage (R006).  The host plane gets the same
treatment in :mod:`.hostlint` (H001–H005: lock discipline,
blocking-under-lock, mirror-before-execute, wire-schema lock, determinism
taint) via :func:`analyze_host` / ``tools.lint --host``.

Surfaces:

* library — :func:`analyze_fn` / :func:`analyze_program` /
  :func:`analyze_plan` / :func:`assert_lint_clean`;
* CLI — ``python -m chainermn_tpu_torch.tools.lint`` (``--rules``,
  ``--format json``, nonzero exit on error findings);
* runtime hook — ``CHAINERMN_TPU_LINT=1`` lints a built train step at
  its first call and reports through the Reporter/step log
  (``CHAINERMN_TPU_LINT=strict`` raises instead).

Suppression: ``# lint: disable=R00x`` in the step's source,
``disable=``/``rules=``, ``CHAINERMN_TPU_LINT_DISABLE``.
"""

from .capture import (  # noqa: F401
    CaptureError,
    CapturedProgram,
    CollectiveCensus,
    CollectiveEvent,
    capture_step,
)
from .core import (  # noqa: F401
    ENV_DISABLE,
    Finding,
    LintContext,
    LintError,
    LintReport,
    Rule,
    analyze_fn,
    analyze_plan,
    analyze_program,
    assert_lint_clean,
    collective_events,
    collective_fingerprint,
    list_rules,
    register_rule,
)
from .hostlint import analyze_host  # noqa: F401
from . import rules  # noqa: F401  (registers R001–R006)
from . import hostlint  # noqa: F401  (registers H001–H005)

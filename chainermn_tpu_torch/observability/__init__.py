"""Host-side telemetry — port of ``chainermn_tpu/observability`` (the
parts the serving path calls on every step):

* :class:`Reporter` — scalars, counters, histograms and gauges per
  process, merged across ranks through the communicator's object plane;
* :class:`StepRecorder` — the JSONL step-event log (atomic append,
  rotation, a truncated last line skipped on read) with CUDA allocator
  memory stats;
* :func:`span` — named host regions on the profiler timeline and in the
  active sinks, with ``device=`` also their time on the device
  (``device/<name>``, resolved lazily; :func:`flush_device_spans`);
* :mod:`tracing` — request span trees, the flight recorder, SLO
  burn-rate gauges and the postmortem exports;
* :class:`MetricsExporter` — a live Prometheus ``/metrics`` endpoint over
  a Reporter or a fleet view;
* :class:`AnomalyDetector` — latency-regression and goodput-drop alarms
  over the fleet view (an autoscaler input);
* :mod:`collective_audit` — the device-independent half of the
  reference's ``hlo_audit.py``: :class:`CollectiveAudit` (counts, bytes
  per axis and per collective, async pairs and their overlap) read off
  one capture of a call, :func:`audit_fn`, :func:`audit_allreduce`,
  :func:`audit_allreduce_tree` and
  :func:`assert_two_dimensional_inter_savings`.

The HLO-text half of ``hlo_audit.py`` (async start/done folding, jaxpr
walks, compiled-HLO parsing) and ``spans.named_scope`` read XLA's
programs and scopes; they have no counterpart.
"""

from .anomaly import AnomalyDetector  # noqa: F401
from .collective_audit import (  # noqa: F401
    CollectiveAudit,
    assert_two_dimensional_inter_savings,
    audit_allreduce,
    audit_allreduce_tree,
    audit_fn,
)
from .exporter import MetricsExporter  # noqa: F401
from .reporter import (  # noqa: F401
    Reporter,
    get_reporter,
    merge_summaries,
    report,
    scope,
)
from .spans import (  # noqa: F401
    flush_device_spans,
    span,
    step_span,
    telemetry_active,
    traced_step,
)
from .step_log import (  # noqa: F401
    StepRecorder,
    current_recorder,
    device_memory_stats,
    read_records,
    recording,
    recover,
)
from .tracing import (  # noqa: F401
    FlightRecorder,
    SLOConfig,
    SpanCtx,
    Tracer,
    get_tracer,
    read_flight,
    read_flight_dir,
    stage_percentiles,
    stitch,
    to_chrome_trace,
    trace_scope,
    tracing_active,
    validate_trace,
)

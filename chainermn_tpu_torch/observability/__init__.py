"""Host-side telemetry — port of ``chainermn_tpu/observability`` (the
parts the serving path calls on every step):

* :class:`Reporter` — scalars, counters, histograms and gauges per
  process, merged across ranks through the communicator's object plane;
* :class:`StepRecorder` — the JSONL step-event log (atomic append,
  rotation, a truncated last line skipped on read) with CUDA allocator
  memory stats;
* :func:`span` — named host regions on the profiler timeline and in the
  active sinks;
* :mod:`tracing` — request span trees, the flight recorder and SLO
  burn-rate gauges.

``hlo_audit.py`` (XLA's HLO), ``exporter.py`` and ``anomaly.py`` are later
slices (ROADMAP A.7); ``spans.named_scope`` is XLA's and has no
counterpart.
"""

from .reporter import (  # noqa: F401
    Reporter,
    get_reporter,
    merge_summaries,
    report,
    scope,
)
from .spans import span, telemetry_active  # noqa: F401
from .step_log import (  # noqa: F401
    StepRecorder,
    current_recorder,
    device_memory_stats,
    read_records,
)
from .tracing import (  # noqa: F401
    FlightRecorder,
    SLOConfig,
    SpanCtx,
    Tracer,
    get_tracer,
    read_flight,
    stitch,
    trace_scope,
    tracing_active,
    validate_trace,
)

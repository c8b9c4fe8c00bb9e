"""Trace spans — port of ``chainermn_tpu/observability/spans.py``: named
regions visible in three sinks at once.

``with span("fwd"):`` stamps the region onto the profiler timeline
(``utils/profiling.annotate``: ``torch.profiler.record_function``),
measures the host-side duration, and publishes it to whichever telemetry
sinks are active: the current
:class:`~chainermn_tpu_torch.observability.reporter.Reporter` (as a
``span/<name>`` scalar + histogram) and the current
:class:`~chainermn_tpu_torch.observability.step_log.StepRecorder` (buffered
into the next step row's ``spans`` field).  With neither active the
cost is two ``perf_counter`` calls — cheap enough to leave in library
hot paths permanently, the design stance nvprof-era tooling never
allowed the reference.

Host-side durations measure *dispatch + any blocking* — under CUDA's
asynchronous launches a span around device work is NOT device time (the
profiler trace is); they are still the right signal for host-bound
stalls (input pipeline, blocking readbacks).  The reference's
``named_scope`` tags XLA's compiled ops and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import time

from . import reporter as _reporter
from . import step_log as _step_log


def telemetry_active() -> bool:
    """True when a Reporter or StepRecorder is installed — the gate
    library call sites use to keep the zero-telemetry hot path free of
    even span bookkeeping."""
    return (
        _reporter.get_reporter() is not None
        or _step_log.current_recorder() is not None
    )


@contextlib.contextmanager
def span(name: str):
    """Named host-side region: profiler annotation + duration fan-out.

    Exception-safe: the duration is recorded (and the span marked as an
    error) even when the body raises, so a failed request can't leave a
    half-open span behind for the next request on the thread.  The
    exception propagates unchanged.
    """
    from ..utils.profiling import annotate

    t0 = time.perf_counter()
    err = False
    try:
        with annotate(name):
            yield
    except BaseException:
        err = True
        raise
    finally:
        dt = time.perf_counter() - t0
        rep = _reporter.get_reporter()
        if rep is not None:
            rep.observe(f"span/{name}", dt)
            rep.histogram_observe(f"span/{name}", dt)
            if err:
                rep.count(f"span/{name}/errors", 1)
        rec = _step_log.current_recorder()
        if rec is not None:
            rec.add_span(name, dt)
            if err:
                rec.add_span(f"{name}/error", dt)


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
asynchronous launches a span around device work is NOT device time.
``span(name, device=dev)`` also measures the device: on a CUDA ``dev``
it records a pair of timing events on the current stream and publishes
their distance as ``device/<name>`` (Reporter scalar + histogram; the
StepRecorder's ``device_spans`` field).  No synchronisation is added:
the pair resolves later, when a later device span finds it complete
(``query``), or when a reader that has synchronised calls
:func:`flush_device_spans`.  On a CPU ``dev`` the device duration is the
host duration.  The reference's ``named_scope`` tags XLA's compiled ops
and has no counterpart here.

A train step that telemetry traces runs under :func:`traced_step`, and
its phases and the kernels it calls open :func:`step_span`: a device
span inside such a step, a shared null context anywhere else.

Readers that see only a Reporter's counters get two more forms:
:func:`count_device_time` names device spans whose seconds also go to
the counters ``device_ms/<name>`` (milliseconds) and
``device_spans/<name>`` (spans resolved); :func:`count_on_device` adds
0-d device tensors to counters without synchronising (a non-blocking
copy that resolves as the device spans do).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

from . import reporter as _reporter
from . import step_log as _step_log

#: Device spans waiting to resolve; past this the oldest is dropped and
#: counted as ``device_span/dropped``.
PENDING_LIMIT = 1024

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_pending: collections.deque = collections.deque()
_free: dict = {}            # device index -> timing events to reuse
# The device of the train step being traced, or None.  A module global
# and not a thread-local: autograd runs a CUDA backward on its own thread.
_step_device = None

_Pair = collections.namedtuple(
    "_Pair", "name index start end reporter recorder step")
# Device spans whose time also goes to the Reporter's counters.
_counted: set = set()
# Counter values on their way from the device: (event, host copy, names,
# reporter), oldest first.
_deferred: collections.deque = collections.deque()


def telemetry_active() -> bool:
    """True when a Reporter or StepRecorder is installed — the gate
    library call sites use to keep the zero-telemetry hot path free of
    even span bookkeeping."""
    return (
        _reporter.get_reporter() is not None
        or _step_log.current_recorder() is not None
    )


@contextlib.contextmanager
def span(name: str, device=None):
    """Named host-side region: profiler annotation + duration fan-out.

    ``device`` (a ``torch.device`` or its name) also publishes
    ``device/<name>`` in seconds: on CUDA, the time on the current stream
    between two events recorded at entry and exit.  That includes any
    wait on the stream (for another stream's event, or for the host to
    launch more work); it is not the kernels' busy time.

    Exception-safe: the duration is recorded (and the span marked as an
    error) even when the body raises, so a failed request can't leave a
    half-open span behind for the next request on the thread.  The
    exception propagates unchanged.
    """
    from ..utils.profiling import annotate

    pair = _open_device(device) if device is not None else None
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
        if rep is None and rec is None:
            if pair is not None:
                _recycle(pair[0], *pair[2:])
        elif device is not None:
            step = rec.steps if rec is not None else None
            if pair is None:
                _publish(name, dt, rep, rec, step)
            else:
                _close_device(pair, name, rep, rec, step)


@contextlib.contextmanager
def traced_step(device):
    """Run the body as a traced train step on ``device``: under
    ``span("train_step", device=device)``, with :func:`step_span` open
    for its duration (in every thread)."""
    global _step_device
    prev, _step_device = _step_device, device
    try:
        with span("train_step", device=device):
            yield
    finally:
        _step_device = prev


def traced_device():
    """The device of the train step being traced, or None outside one."""
    return _step_device


def step_span(name: str):
    """``span(name, device=...)`` on the step's device inside
    :func:`traced_step`; a shared null context anywhere else, so that
    untraced steps and evaluation pay one global read."""
    dev = _step_device
    return _NULL if dev is None else span(name, device=dev)


def _open_device(device):
    """``(index, stream, start, end)``: two timing events for ``device``
    (reused when the pool has them), the start recorded on its current
    stream; ``None`` on the CPU, whose host clock is the device's."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    _poll()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    with _lock:
        free = _free.setdefault(index, [])
        events = [free.pop() if free else None for _ in range(2)]
    start, end = (torch.cuda.Event(enable_timing=True) if e is None else e
                  for e in events)
    stream = torch.cuda.current_stream(index)
    start.record(stream)
    return index, stream, start, end


def _close_device(opened, name, rep, rec, step):
    index, stream, start, end = opened
    end.record(stream)
    dropped = None
    with _lock:
        if len(_pending) >= PENDING_LIMIT:
            dropped = _pending.popleft()
        _pending.append(_Pair(name, index, start, end, rep, rec, step))
    if dropped is not None:
        sink = dropped.reporter or _reporter.get_reporter()
        if sink is not None:
            sink.count("device_span/dropped", 1)


def count_device_time(name: str) -> None:
    """Also count the device span ``name`` into the Reporter's counters:
    ``device_ms/<name>`` its milliseconds, ``device_spans/<name>`` one a
    resolved span."""
    _counted.add(name)


def count_on_device(values) -> None:
    """Add ``{counter: 0-d tensor}`` to the current Reporter's counters.
    CUDA values travel by one non-blocking copy to pinned memory and are
    counted when a later device span, or :func:`flush_device_spans`, finds
    the copy complete; nothing synchronises.  No Reporter: nothing."""
    import torch

    rep = _reporter.get_reporter()
    if rep is None or not values:
        return
    names = list(values)
    vec = torch.stack([values[n].detach().reshape(()).double()
                       for n in names])
    if vec.device.type != "cuda":
        for n, v in zip(names, vec.tolist()):
            rep.count(n, v)
        return
    host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    with _lock:
        _deferred.append((event, host, names, rep))
    _poll()


def _resolve_counts(item):
    _, host, names, rep = item
    for n, v in zip(names, host.tolist()):
        rep.count(n, v)


def _publish(name, seconds, rep, rec, step):
    if rep is not None:
        rep.observe(f"device/{name}", seconds)
        rep.histogram_observe(f"device/{name}", seconds)
        if name in _counted:
            rep.count(f"device_ms/{name}", seconds * 1e3)
            rep.count(f"device_spans/{name}", 1)
    if rec is not None:
        rec.add_device_span(step, name, seconds)


def _recycle(index, *events):
    with _lock:
        _free.setdefault(index, []).extend(events)


def _resolve(pair):
    seconds = pair.start.elapsed_time(pair.end) / 1e3
    _recycle(pair.index, pair.start, pair.end)
    _publish(pair.name, seconds, pair.reporter, pair.recorder, pair.step)


def _poll():
    """Resolve the pending pairs that have completed, oldest first,
    stopping at the first still running; never waits."""
    done, counts = [], []
    with _lock:
        while _pending and _pending[0].end.query():
            done.append(_pending.popleft())
        while _deferred and _deferred[0][0].query():
            counts.append(_deferred.popleft())
    for pair in done:
        _resolve(pair)
    for item in counts:
        _resolve_counts(item)


def flush_device_spans() -> int:
    """Resolve every pending device span into the sinks it was opened
    under, waiting for each; returns how many.  For a reader that has
    synchronised the device (then nothing waits); the step never calls
    it."""
    with _lock:
        todo = list(_pending)
        _pending.clear()
        counts = list(_deferred)
        _deferred.clear()
    for pair in todo:
        pair.end.synchronize()
        _resolve(pair)
    for item in counts:
        item[0].synchronize()
        _resolve_counts(item)
    return len(todo)

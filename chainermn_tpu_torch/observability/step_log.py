"""Structured step-event log — port of
``chainermn_tpu/observability/step_log.py``: one JSONL row per event.

The reference's ``LogReport`` serialized its observation dict to
``log`` (JSON) once per report interval; this version logs at
*step* granularity with crash-honest file semantics, because the
north-star scaling work needs per-step evidence (step time, throughput,
loss, grad norm, recompiles, device memory) rather than per-interval
averages.

File contract:

* **Atomic append** — each row is one ``os.write`` of a complete
  ``...\\n`` line on an ``O_APPEND`` descriptor, so concurrent writers
  (the train loop, the prefetch thread, a monitoring listener) never
  interleave bytes within a line.
* **Rotation** — when a write would push the file past ``rotate_bytes``
  the file rotates through ``path.1 … path.<max_files>`` (highest =
  oldest), bounding disk for soak runs.
* **Crash-safe reading** — a SIGKILL mid-write leaves at most one
  truncated final line; :func:`read_records` skips it.

The reference also turns ``jax.monitoring`` compile events into rows;
eager PyTorch compiles nothing, so that bridge has no counterpart.  Device
memory comes from the CUDA caching allocator.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, List, Optional


def _jsonable(v):
    """Coerce numpy/torch scalars (and 0-d arrays) to plain Python; leave
    everything json.dumps already handles untouched."""
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)  # np.float32, 0-d tensors, np.int64, ...
    except Exception:
        return str(v)


def device_memory_stats() -> Optional[dict]:
    """Best-effort ``{bytes_in_use, peak_bytes_in_use, ...}`` of the
    current CUDA device; ``None`` without one — callers omit the field
    rather than fake it."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        st = torch.cuda.memory_stats()
        return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
                "num_allocs": int(st.get("allocation.all.allocated", 0))}
    except Exception:
        return None


class StepRecorder:
    """Append-only JSONL event recorder for one process.

    ``record(event, **fields)`` writes an arbitrary event row;
    :meth:`step` is the train-loop entry point — it stamps wall time,
    computes the host-side step duration since the previous ``step``
    call, derives throughput from ``items``, attaches any span
    durations buffered by :func:`chainermn_tpu_torch.observability.span`,
    and samples device memory every ``mem_every`` steps.

    Use as a context manager (``with StepRecorder(path) as rec:``) to
    also install it as the *current* recorder that spans and the
    instrumented optimizer publish into.
    """

    def __init__(
        self,
        path: str,
        rotate_bytes: Optional[int] = None,
        max_files: int = 3,
        rank: int = 0,
        mem_every: int = 1,
        clock=time.perf_counter,
    ):
        self.path = str(path)
        self.rotate_bytes = rotate_bytes
        self.max_files = max(1, int(max_files))
        self.rank = int(rank)
        self.mem_every = max(0, int(mem_every))
        self._clock = clock
        self._lock = threading.Lock()
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._fd = os.open(
            self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644
        )
        self._prev_t: Optional[float] = None
        self._step_count = 0
        self._pending_spans: dict = {}

    # -- write side ----------------------------------------------------
    def record(self, event: str, **fields) -> None:
        """Append one ``{"event": event, "rank": r, "t": wall, ...}``
        row atomically (with rotation)."""
        row = {"event": event, "rank": self.rank, "t": time.time()}
        row.update({k: _jsonable(v) for k, v in fields.items()})
        line = (json.dumps(row) + "\n").encode("utf-8")
        with self._lock:
            self._maybe_rotate(len(line))
            os.write(self._fd, line)

    def _maybe_rotate(self, incoming: int) -> None:
        if not self.rotate_bytes:
            return
        try:
            size = os.fstat(self._fd).st_size
        except OSError:
            return
        if size == 0 or size + incoming <= self.rotate_bytes:
            return
        os.close(self._fd)
        for i in range(self.max_files - 1, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")
        self._fd = os.open(
            self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644
        )

    def add_span(self, name: str, seconds: float) -> None:
        """Buffer a span duration for the next :meth:`step` row (called
        by :func:`chainermn_tpu_torch.observability.span`)."""
        with self._lock:
            self._pending_spans[name] = (
                self._pending_spans.get(name, 0.0) + seconds
            )

    def step(self, step: Optional[int] = None, items: Optional[int] = None,
             **fields) -> dict:
        """Record one training step.  Returns the written row (handy for
        tests and rank-0 printing).

        ``dt`` is the host wall time since the previous ``step`` call
        (absent on the first); ``items`` (tokens or images in the step)
        derives ``per_sec``.  Extra ``fields`` (loss, grad_norm, lr, …)
        pass through; torch/numpy scalars are read back to floats HERE —
        callers that care about async dispatch should pass host values.
        """
        now = self._clock()
        with self._lock:
            dt = None if self._prev_t is None else now - self._prev_t
            self._prev_t = now
            self._step_count += 1
            n = self._step_count
            spans, self._pending_spans = self._pending_spans, {}
        row: dict = {"step": n - 1 if step is None else int(step)}
        if dt is not None:
            row["dt"] = dt
            if items is not None:
                row["per_sec"] = items / dt if dt > 0 else 0.0
        if items is not None:
            row["items"] = int(items)
        if spans:
            row["spans"] = spans
        if self.mem_every and n % self.mem_every == 0:
            mem = device_memory_stats()
            if mem is not None:
                row["mem"] = mem
        row.update(fields)
        self.record("step", **row)
        row["event"] = "step"
        return row

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    # -- current-recorder stack ---------------------------------------
    def __enter__(self):
        install(self)
        return self

    def __exit__(self, *exc):
        uninstall(self)
        self.close()
        return False


_stack: list = []
_stack_lock = threading.Lock()


def current_recorder() -> Optional[StepRecorder]:
    with _stack_lock:
        return _stack[-1] if _stack else None


def install(recorder: StepRecorder) -> None:
    with _stack_lock:
        _stack.append(recorder)


def uninstall(recorder: StepRecorder) -> None:
    with _stack_lock:
        if recorder in _stack:
            _stack.remove(recorder)


# ---------------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------------
def _iter_one(path: str, strict: bool) -> Iterator[dict]:
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    # A crash mid-write leaves the LAST line unterminated; any other
    # undecodable line is real corruption.
    complete, tail = lines[:-1], lines[-1]
    for line in complete:
        if not line.strip():
            continue
        try:
            yield json.loads(line)
        except ValueError:
            if strict:
                raise
            continue
    if tail.strip():
        try:
            yield json.loads(tail)
        except ValueError:
            if strict:
                raise
            # partial final line: the crash-recovery case — skipped.


def read_records(path: str, include_rotated: bool = True,
                 strict: bool = False) -> List[dict]:
    """Parsed rows, oldest first, skipping a truncated final line.

    ``include_rotated``: read ``path.N … path.1`` (oldest → newest)
    before ``path`` so summaries cover the whole retained window."""
    paths = []
    if include_rotated:
        n = 1
        while os.path.exists(f"{path}.{n}"):
            n += 1
        paths.extend(f"{path}.{i}" for i in range(n - 1, 0, -1))
    if os.path.exists(path):
        paths.append(path)
    if not paths:
        raise FileNotFoundError(path)
    rows: List[dict] = []
    for p in paths:
        rows.extend(_iter_one(p, strict))
    return rows

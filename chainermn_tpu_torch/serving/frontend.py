"""Queue frontend: submission, backpressure, deadlines, streaming.

Port of ``chainermn_tpu/serving/frontend.py`` (host code, copied as it
is).

The frontend is the boundary between callers and the scheduler loop:

* :meth:`ServeFrontend.submit` turns (prompt, options) into a
  :class:`RequestHandle` or raises :class:`QueueFull` — bounded-queue
  backpressure, so a bursty producer finds out *at submission time*
  rather than growing an unbounded backlog;
* priority-aware shedding: every request carries a priority class
  (0 = most important).  At capacity, an arriving request sheds the
  *lowest*-class waiting request iff that victim's class is strictly
  lower than its own — overload degrades the cheap traffic first,
  never inverts priorities, and both sides are counted per class
  (``serve/admit/<class>``, ``serve/shed/<class>``,
  ``serve/rejected/<class>``) for the load-shedding curves;
* retry hints are *jittered*: every :class:`QueueFull` scales its
  ``retry_after_s`` by a deterministic per-frontend random factor in
  [0.75, 1.25), so a thousand clients rejected in the same burst do
  not come back in the same burst (the classic synchronized retry
  storm);
* per-request deadlines: a request that exceeds its ``timeout_s``
  (measured from submission, via an injectable clock so tests don't
  sleep) is cancelled wherever it is — dropped from the queue, or
  evicted mid-decode — and its handle reports ``timeout``;
* streaming: ``on_token`` callbacks fire per sampled token from inside
  the scheduler step, before the request completes.

The frontend never spawns threads — :meth:`step` advances everything by
one scheduler iteration and the caller owns the loop (`run_until_idle`
for batch jobs, an external event loop for a real server).  That keeps
the whole serving stack deterministic and testable in-process.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional

from ..observability import tracing as _tracing
from .engine import SamplingParams
from .scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)


class QueueFull(RuntimeError):
    """Backpressure: the admission queue is at capacity.  Callers
    should retry after draining some completions (or shed load).

    ``retry_after_s`` — when the frontend has observed enough decode
    throughput to estimate one — is the predicted seconds until the
    nearest-to-done running request retires and frees a batch slot.
    ``None`` means "no estimate" (cold frontend), not "retry now"."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class RequestHandle:
    """Caller-side view of a submitted request."""

    request_id: int
    submitted_at: float
    timeout_s: Optional[float]
    _request: Request
    finished_at: Optional[float] = None
    timed_out: bool = False
    #: trace id when tracing is active (None otherwise).
    trace_id: Optional[str] = None
    #: root span context when THIS frontend minted the root (a handle
    #: for a request whose root lives in the router carries None here).
    _trace_root: Optional[_tracing.SpanCtx] = None

    @property
    def done(self) -> bool:
        return self.timed_out or self._request.done

    @property
    def tokens(self) -> List[int]:
        return list(self._request.generated)

    @property
    def status(self) -> str:
        if self.timed_out:
            return "timeout"
        return self._request.state.value

    @property
    def error(self) -> Optional[str]:
        return "deadline exceeded" if self.timed_out else \
            self._request.error

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


class ServeFrontend:
    """Bounded-queue frontend over a :class:`ContinuousBatchingScheduler`.

    ``max_queue`` bounds waiting requests ACROSS frontend + scheduler
    (running ones don't count — they hold pages, not queue slots).
    ``clock`` defaults to ``time.monotonic``; tests inject a fake.
    """

    #: steps remembered by the decode-throughput estimator.
    THROUGHPUT_WINDOW = 64

    def __init__(self, scheduler: ContinuousBatchingScheduler,
                 max_queue: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 replica=None,
                 reporter=None):
        self.scheduler = scheduler
        self.max_queue = int(max_queue)
        self.clock = clock
        # Replica id stamped on trace records minted here (the in-
        # process cluster shares one tracer across replicas, so the
        # tracer's own default can't attribute them).
        self.replica = replica if replica is not None else scheduler.replica
        self.reporter = reporter if reporter is not None \
            else scheduler.reporter
        self._handles: Dict[int, RequestHandle] = {}
        self._next_id = 0
        # (timestamp, tokens emitted) per recent step — the decode
        # throughput window retry-after hints are derived from.
        self._step_times: List[tuple] = []
        # Deterministic jitter stream for retry-after hints: seeded per
        # frontend so replicas desynchronize each other's rejected
        # clients, reproducible run-to-run (no wall-clock entropy).
        self._jitter = random.Random(f"retry-jitter:{self.replica!r}")

    # -- submission ----------------------------------------------------
    def queue_depth(self) -> int:
        return len(self.scheduler.waiting)

    def reserve_id(self) -> int:
        """Claim the next request id without enqueueing anything —
        migration restores KV pages under the id BEFORE the request
        object exists (see :meth:`adopt`)."""
        rid = self._next_id
        self._next_id += 1
        return rid

    def decode_tokens_per_sec(self) -> Optional[float]:
        """Observed decode throughput over the recent step window, or
        None before two timestamped steps exist."""
        w = self._step_times
        if len(w) < 2:
            return None
        elapsed = w[-1][0] - w[0][0]
        tokens = sum(t for _, t in w[1:])
        if elapsed <= 0 or tokens <= 0:
            return None
        return tokens / elapsed

    def _retry_after_hint(self) -> Optional[float]:
        """Seconds until a queue slot plausibly frees: the remaining
        tokens of the nearest-to-done live request, at the observed
        per-request step rate (aggregate throughput / live requests),
        jittered by a deterministic factor in [0.75, 1.25) so rejected
        clients spread their retries instead of re-spiking together."""
        tput = self.decode_tokens_per_sec()
        if tput is None:
            return None
        live = self.scheduler.running or list(self.scheduler.waiting)
        if not live:
            return None
        nearest = min(
            max(1, r.max_new_tokens - len(r.generated)) for r in live
        )
        base = nearest * len(live) / tput
        return base * (0.75 + 0.5 * self._jitter.random())

    # -- priority shedding ---------------------------------------------
    def sheddable_class(self, priority: int) -> Optional[int]:
        """The class a shed would evict for an arrival of ``priority``:
        the numerically largest waiting class STRICTLY below it, or
        None when shedding can't help (everything waiting is at least
        as important).  The router consults this to route an important
        arrival at a full fleet toward the cheapest victim."""
        worst = max(
            (r.priority for r in self.scheduler.waiting), default=None
        )
        if worst is None or worst <= priority:
            return None
        return worst

    def _shed_one(self, priority: int, now: float) -> bool:
        """Evict the single worst waiting request (largest class, most
        recently queued within it) iff strictly lower-class than
        ``priority``.  The victim fails with a ``shed: ...`` error —
        distinguishable from deadline/engine failures — and is counted
        under ``serve/shed/<class>``."""
        if self.sheddable_class(priority) is None:
            return False
        sched = self.scheduler
        victim = max(
            enumerate(sched.waiting), key=lambda iv: (iv[1].priority, iv[0])
        )[1]
        sched.waiting.remove(victim)
        victim.state = RequestState.FAILED
        victim.error = f"shed: overload (class {victim.priority})"
        sched._finished[victim.request_id] = victim
        h = self._handles.get(victim.request_id)
        if h is not None and h.finished_at is None:
            h.finished_at = now
            self._close_trace(h)
        if self.reporter is not None:
            self.reporter.count(f"serve/shed/{victim.priority}", 1)
            if victim.tenant is not None:
                self.reporter.count(f"tenant/{victim.tenant}/shed", 1)
        return True

    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               stop_token: Optional[int] = None,
               timeout_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               committed: Optional[List[int]] = None,
               trace=None,
               speculative: bool = True,
               priority: int = 0,
               tenant: Optional[str] = None,
               shared_prefix: bool = False,
               ) -> RequestHandle:
        """Enqueue one request; raises :class:`QueueFull` (with a
        ``retry_after_s`` hint once throughput is known) when the
        waiting queue is at ``max_queue``.  ``on_token(request_id,
        token)`` streams tokens as they are sampled.

        ``committed`` — tokens this request already generated on a
        previous replica (failover replay): they are preloaded into the
        request so admission re-prefills prompt+committed and sampling
        resumes at the next position, bit-identical to an uninterrupted
        run (counter-based RNG).  ``on_token`` does NOT re-fire for
        them — the caller already streamed them.

        ``trace`` — parent trace context (a ``SpanCtx`` or its wire
        dict) when the request's ROOT span is owned elsewhere (the
        cluster router); with a tracer installed and no parent given,
        this frontend mints the root here.

        ``priority`` — the request's shed class (0 = most important).
        At capacity the arrival first tries to shed one strictly
        lower-class waiting request; only when no such victim exists
        does it see :class:`QueueFull` itself.

        ``tenant`` — accounting identity: admits/sheds/rejects and
        token flow are additionally counted under ``tenant/<id>/*``
        (None = untenanted, no extra series).

        ``shared_prefix`` — opt a tenanted request into the SHARED
        prefix-cache namespace (for common system prompts); by default
        tenanted requests match and register prefixes only within
        their tenant's salted namespace."""
        priority = int(priority)
        if self.queue_depth() >= self.max_queue and not self._shed_one(
            priority, self.clock()
        ):
            hint = self._retry_after_hint()
            msg = f"waiting queue at capacity ({self.max_queue})"
            if hint is not None:
                msg += f"; retry after ~{hint:.3f}s"
            if self.reporter is not None:
                self.reporter.count(f"serve/rejected/{priority}", 1)
                if tenant is not None:
                    self.reporter.count(f"tenant/{tenant}/rejected", 1)
            raise QueueFull(msg, retry_after_s=hint)
        rid = self.reserve_id()
        req = Request(
            request_id=rid,
            prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            sampling=sampling or SamplingParams(),
            stop_token=stop_token,
            on_token=on_token,
            speculative=speculative,
            priority=priority,
            tenant=tenant,
            shared_prefix=bool(shared_prefix),
        )
        if self.reporter is not None:
            self.reporter.count(f"serve/admit/{priority}", 1)
            if tenant is not None:
                self.reporter.count(f"tenant/{tenant}/admit", 1)
                self.reporter.count(f"tenant/{tenant}/tokens_in",
                                    len(req.prompt))
        if committed:
            req.generated = list(map(int, committed))
        handle = RequestHandle(
            request_id=rid,
            submitted_at=self.clock(),
            timeout_s=timeout_s,
            _request=req,
        )
        tr = _tracing.get_tracer()
        if tr is not None:
            parent = _tracing.SpanCtx.from_wire(trace)
            if parent is None:
                # This frontend is the entry point: mint the root.
                root_attrs = dict(
                    rid=rid, prompt_len=len(req.prompt),
                    max_new_tokens=req.max_new_tokens,
                )
                if tenant is not None:
                    root_attrs["tenant"] = tenant
                handle._trace_root = tr.begin(
                    "request", replica=self.replica, **root_attrs
                )
                parent = handle._trace_root
            handle.trace_id = parent.trace_id
            req.trace = parent
            req.trace_enq = tr.clock()
        self._handles[rid] = handle
        self.scheduler.add_request(req)
        if req.done:  # rejected at intake (oversized / empty prompt)
            handle.finished_at = handle.submitted_at
            self._close_trace(handle)
        return handle

    def adopt(self, req: Request,
              timeout_s: Optional[float] = None) -> RequestHandle:
        """Register a request whose KV pages are already live in this
        engine (restored under ``req.request_id``, reserved via
        :meth:`reserve_id`) and admit it straight into the decode batch
        — the receiving end of a cross-replica handoff."""
        self.scheduler.adopt_request(req)
        handle = RequestHandle(
            request_id=req.request_id,
            submitted_at=self.clock(),
            timeout_s=timeout_s,
            _request=req,
        )
        if req.trace is not None:
            handle.trace_id = req.trace.trace_id
        self._handles[req.request_id] = handle
        return handle

    def _close_trace(self, h: RequestHandle) -> None:
        """End the root span for a handle whose root was minted HERE
        (no-op for router-owned roots).  Idempotent."""
        root = h._trace_root
        if root is None:
            return
        h._trace_root = None
        tr = _tracing.get_tracer()
        if tr is not None:
            err = h.error
            tr.end(root, error=err, status=h.status,
                   tokens=len(h._request.generated))

    # -- deadlines -----------------------------------------------------
    def _expire(self, now: float) -> int:
        """Cancel every live request past its deadline.  Waiting ones
        are dropped from the queue; running ones are evicted (pages
        freed).  Returns how many were cancelled."""
        expired = [
            h for h in self._handles.values()
            if not h.done and h.timeout_s is not None
            and now - h.submitted_at > h.timeout_s
        ]
        for h in expired:
            req = h._request
            sched = self.scheduler
            if req in sched.waiting:
                sched.waiting.remove(req)
            if req in sched.running:
                sched.running.remove(req)
            if req.request_id in sched.engine.kv:
                sched.engine.kv.free(req.request_id)
            req.state = RequestState.FAILED
            req.error = "deadline exceeded"
            sched._finished[req.request_id] = req
            h.timed_out = True
            h.finished_at = now
            self._close_trace(h)
        return len(expired)

    # -- driving -------------------------------------------------------
    def step(self) -> int:
        """Expire deadlines, then one scheduler iteration.  Returns
        tokens emitted."""
        self._expire(self.clock())
        emitted = self.scheduler.step()
        now = self.clock()
        self._step_times.append((now, emitted))
        if len(self._step_times) > self.THROUGHPUT_WINDOW:
            del self._step_times[: -self.THROUGHPUT_WINDOW]
        for h in self._handles.values():
            if h._request.done and h.finished_at is None:
                h.finished_at = now
                self._close_trace(h)
        self._expire(now)
        return emitted

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        steps = 0
        while self.scheduler.has_work:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"frontend did not drain within {max_steps} steps"
                )
            self.step()

    # -- results -------------------------------------------------------
    def result(self, handle: RequestHandle,
               max_steps: int = 100_000) -> List[int]:
        """Drive the loop until ``handle`` completes; returns its
        tokens.  Raises on failure/timeout."""
        steps = 0
        while not handle.done:
            steps += 1
            if steps > max_steps:
                raise RuntimeError("request did not complete")
            self.step()
        if handle.status == "timeout":
            raise TimeoutError(
                f"request {handle.request_id} exceeded its deadline"
            )
        if handle.status == "failed":
            raise RuntimeError(
                f"request {handle.request_id} failed: {handle.error}"
            )
        return handle.tokens

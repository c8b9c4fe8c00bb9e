"""Continuous-batching scheduler: iteration-level admission + preemption.

Port of ``chainermn_tpu/serving/scheduler.py`` (host policy, copied as
it is over the port's engine).

Orca-style scheduling: the unit of work is one *decode iteration*, not
one request.  Every :meth:`ContinuousBatchingScheduler.step` the
scheduler (1) admits waiting requests whose prompts fit the cache (FCFS,
with a free-page watermark so admission doesn't immediately force
eviction), (2) prefills the newly admitted prompts one at a time, and
(3) runs ONE batched decode iteration over every running sequence —
requests join and leave the in-flight batch at iteration granularity, so
a short request never waits behind a long one's tail.

Preemption is *eviction with recompute*: when the pool can't cover the
next iteration's page growth, the most-recently-admitted running
sequence is evicted — its pages freed, its prompt+generated tokens
pushed back to the FRONT of the waiting queue — and re-prefilled on
re-admission.  Latest-first victim selection keeps the oldest requests
making progress (no livelock: the head of the queue is never the
victim while anything younger runs).  Because sampling is per-request
counter-based and the paged attention per-sequence, an evicted request
resumes bit-identically — the parity tests pin exactly that.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from enum import Enum
from typing import Callable, Deque, Dict, List, Optional

from ..observability import tracing as _tracing
from .engine import InferenceEngine, SamplingParams
from .kv_cache import OutOfBlocks


class RequestState(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"


@dataclasses.dataclass
class Request:
    """One generation request as the scheduler tracks it.

    ``generated`` accumulates sampled tokens; ``state`` moves
    WAITING → RUNNING (→ WAITING again on preemption) → FINISHED, or
    FAILED when the request can never be satisfied (prompt alone
    exceeds the pool).  ``on_token`` fires per sampled token; the
    frontend plugs streaming callbacks in here.
    """

    request_id: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams
    )
    stop_token: Optional[int] = None
    on_token: Optional[Callable[[int, int], None]] = None
    state: RequestState = RequestState.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    error: Optional[str] = None
    #: prompt tokens served from shared prefix pages at the most recent
    #: admission (observability; bit-exactness is unconditional).
    prefix_hit_tokens: int = 0
    #: per-request opt-out for speculative decoding.
    speculative: bool = True
    #: priority class: 0 is most important; larger = more sheddable.
    #: The frontend's overload policy sheds the numerically largest
    #: class first — scheduling order itself stays FCFS (Orca-style).
    priority: int = 0
    #: accounting identity: token counters and KV page-seconds are
    #: attributed under ``tenant/<id>/*`` (None = untenanted).
    tenant: Optional[str] = None
    #: prefix-cache sharing opt-in: a tenanted request normally matches
    #: and registers prefixes only within its tenant's salted namespace
    #: (isolation closes the cross-tenant timing side-channel); setting
    #: this TRUE places the request in the shared (None) namespace —
    #: for common system prompts every tenant is meant to share.
    shared_prefix: bool = False
    #: host step index at which the first token appeared (TTFT proxy).
    first_token_step: Optional[int] = None
    #: trace context stage spans parent to (the request's ROOT — see
    #: the crash-robust parenting rule in observability/tracing.py).
    trace: Optional[_tracing.SpanCtx] = None
    #: tracer-clock enqueue time — the pending queue-wait span's start.
    trace_enq: Optional[float] = None
    #: chunked prefill cursor: context position the next prefill slice
    #: starts at, or None when the request is not mid-prefill.  While
    #: set, the request holds its pages but is excluded from decode
    #: batches; preemption resets it to None (full recompute).
    prefill_pos: Optional[int] = None

    @property
    def context(self) -> List[int]:
        """Prompt + generated so far — what a re-prefill replays."""
        return list(self.prompt) + list(self.generated)

    @property
    def prefix_namespace(self) -> Optional[str]:
        """The prefix-index namespace this request matches/registers
        in: its tenant id, unless it opted into the shared one."""
        return None if self.shared_prefix else self.tenant

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.FAILED)

    def _finish_if_complete(self) -> bool:
        if len(self.generated) >= self.max_new_tokens or (
            self.stop_token is not None
            and self.generated
            and self.generated[-1] == self.stop_token
        ):
            self.state = RequestState.FINISHED
            return True
        return False


class ContinuousBatchingScheduler:
    """Drives an :class:`InferenceEngine` at iteration granularity.

    ``watermark_blocks`` free pages are kept in reserve at admission
    time (default: enough for one decode-iteration of page growth at
    full batch), trading a little admission latency against preemption
    churn.  ``reporter`` (optional, an observability ``Reporter``)
    receives occupancy/queue gauges and token counters each step.
    """

    def __init__(self, engine: InferenceEngine,
                 watermark_blocks: Optional[int] = None,
                 reporter=None, replica=None,
                 spec_tokens: int = 0,
                 stream_prefix: bool = True):
        self.engine = engine
        self.watermark = (
            engine.max_batch if watermark_blocks is None
            else int(watermark_blocks)
        )
        self.reporter = reporter
        #: streaming prefix registration: during chunked prefill each
        #: completed slice's full pages are published to the prefix
        #: index immediately (partial-prefix keys are valid — digests
        #: are cumulative-run keyed), and a mid-prefill request whose
        #: prompt is meanwhile registered DEEPER by another sequence
        #: adopts those pages and moves its cursor past them instead of
        #: recomputing.  Off registers a prompt only when it completes.
        self.stream_prefix = bool(stream_prefix)
        #: draft length for speculative decoding (0 = plain one-token
        #: decode).  Drafts come from n-gram prompt lookup on each
        #: request's OWN context (serving/spec.py), so the emitted
        #: stream stays independent of batch composition — speculation
        #: changes how many engine steps a stream takes, never its
        #: tokens.
        self.spec_tokens = int(spec_tokens)
        # Prefix-cache / speculation accounting (Reporter gauge sources).
        self._prefix_lookup_tokens = 0
        self._prefix_hit_tokens = 0
        #: prompt tokens skipped mid-prefill by adopting pages another
        #: sequence streamed into the index (serve/prefill_stream_hits).
        self._stream_hit_tokens = 0
        #: prefill slices computed over a range the index already held
        #: (serve/dup_prefill_slices) — the duplicate work streaming
        #: registration exists to eliminate.
        self._dup_prefill_slices = 0
        self._spec_rows = 0
        self._spec_emitted = 0
        # Per-draft-source acceptance accounting: the aggregate
        # serve/spec_accept_len gauge keeps its historical name; the
        # labelled serve/spec_accept_len/<source> twins let tools.obs
        # compare ngram vs model acceptance side by side.
        self._spec_rows_by: Dict[str, int] = {}
        self._spec_emitted_by: Dict[str, int] = {}
        # In a multi-replica tier every scheduler publishes the same
        # gauge names; a replica id suffixes them ("serving/running/
        # replica/<id>") so tools.obs can split the fleet into
        # per-replica Prometheus labels.  Default: bare names, exactly
        # as the single-replica stack always published them.
        self.replica = replica
        self._gauge_suffix = "" if replica is None else f"/replica/{replica}"
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self._finished: Dict[int, Request] = {}
        self._step = 0
        # Deficit round-robin admission across tenants (off by default:
        # empty weights keep the historical strict-FCFS order exactly).
        # See set_tenant_weights.
        self._tenant_weights: Dict[str, float] = {}
        self._tenant_deficit: Dict[str, float] = {}
        self._drr_ring: List[str] = []
        self._drr_next = 0
        self._pending_charge = None
        #: the request a capacity-blocked admission stopped at (the
        #: "head" under DRR order); run_to_completion's stuck-queue
        #: diagnosis fails THIS request, not blindly waiting[0].
        self._blocked_head: Optional[Request] = None

    # -- intake --------------------------------------------------------
    def add_request(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if not req.prompt:
            req.state = RequestState.FAILED
            req.error = "empty prompt"
            self._finished[req.request_id] = req
            return
        if total > self.engine.config.max_len:
            req.state = RequestState.FAILED
            req.error = (
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len "
                f"{self.engine.config.max_len}"
            )
            self._finished[req.request_id] = req
            return
        self.waiting.append(req)

    def adopt_request(self, req: Request) -> None:
        """Admit a request whose KV pages are ALREADY allocated and
        written under ``req.request_id`` — the cross-replica handoff
        seam (migration / disaggregated prefill).  The pages must cover
        exactly ``len(req.context) - 1`` positions: the same state a
        locally-running request is in between iterations (its last
        sampled token is written by the NEXT decode step), so the decode
        loop continues it with no special casing.  Bypasses the queue
        and the admission watermark: an adopted sequence already paid
        its prefill elsewhere, and if pages run short later it preempts
        like anyone else (eviction replays its full context here)."""
        if req.request_id not in self.engine.kv:
            raise ValueError(
                f"adopt_request({req.request_id}): no KV allocation — "
                "restore the migrated pages first"
            )
        covered = self.engine.kv.seq_len(req.request_id)
        want = len(req.context) - 1
        if covered != want:
            raise ValueError(
                f"adopt_request({req.request_id}): pages cover {covered} "
                f"positions, context of {want + 1} tokens needs {want} "
                "(last token is written by the next decode step)"
            )
        if len(self.running) >= self.engine.max_batch:
            raise OutOfBlocks(
                f"adopt_request({req.request_id}): decode batch already "
                f"at max_batch {self.engine.max_batch}"
            )
        req.state = RequestState.RUNNING
        self.running.append(req)

    # -- policy helpers ------------------------------------------------
    def set_tenant_weights(self, weights: Optional[Dict[str, float]]
                           ) -> None:
        """Turn on deficit-round-robin admission across tenants.

        ``weights`` maps tenant id → share (e.g. from
        ``TrafficSpec.tenant_weights()``); a tenant absent from the map
        (including untenanted requests, keyed ``""``) gets weight 1.0.
        With DRR on, one tenant's burst can no longer starve another:
        each admission grants every backlogged tenant deficit credit in
        proportion to its weight and serves the tenant whose head
        affords its cost (prompt + max_new_tokens) first — admission
        stays FCFS *within* a tenant, and capacity blocking stays
        strict (a pick that doesn't fit stops admission; nobody skips
        ahead of it).  Passing None/empty reverts to global FCFS."""
        self._tenant_weights = dict(weights or {})
        self._tenant_deficit = {}
        self._drr_ring = []
        self._drr_next = 0
        self._pending_charge = None

    def _tenant_of(self, req: Request) -> str:
        return "" if req.tenant is None else str(req.tenant)

    @staticmethod
    def _admission_cost(req: Request) -> int:
        return len(req.context) + req.max_new_tokens

    def _next_admission(self) -> Request:
        """The request DRR admits next (``waiting[0]`` when DRR is
        off or only one tenant is backlogged).  Pure pick: the deficit
        charge is staged in ``_pending_charge`` and applied by
        :meth:`_charge_admission` only once the pick actually admits —
        a capacity-blocked pick must not accumulate debt."""
        self._pending_charge = None
        if not self._tenant_weights:
            return self.waiting[0]
        heads: Dict[str, Request] = {}
        for req in self.waiting:
            t = self._tenant_of(req)
            if t not in heads:
                heads[t] = req
        if len(heads) == 1:
            return self.waiting[0]
        # Deficits persist only while a tenant stays backlogged
        # (standard DRR: going idle forfeits credit).
        self._tenant_deficit = {
            t: d for t, d in self._tenant_deficit.items() if t in heads
        }
        for t in sorted(heads):
            if t not in self._drr_ring:
                self._drr_ring.append(t)
        self._drr_ring = [t for t in self._drr_ring if t in heads]
        ring = self._drr_ring
        quantum = max(
            self._admission_cost(heads[t]) for t in heads
        )
        # How many credit rounds until each tenant's head is
        # affordable; serve the soonest, ring order breaking ties.
        best = None
        for pos in range(len(ring)):
            t = ring[(self._drr_next + pos) % len(ring)]
            w = max(float(self._tenant_weights.get(t, 1.0)), 1e-9)
            need = (self._admission_cost(heads[t])
                    - self._tenant_deficit.get(t, 0.0))
            rounds = max(0, math.ceil(need / (quantum * w)))
            if best is None or rounds < best[0]:
                best = (rounds, pos, t)
        rounds, pos, pick = best
        self._pending_charge = (pick, rounds, quantum,
                                self._admission_cost(heads[pick]),
                                sorted(heads))
        return heads[pick]

    def _charge_admission(self) -> None:
        if self._pending_charge is None:
            return
        pick, rounds, quantum, cost, tenants = self._pending_charge
        self._pending_charge = None
        if rounds:
            for t in tenants:
                w = float(self._tenant_weights.get(t, 1.0))
                self._tenant_deficit[t] = (
                    self._tenant_deficit.get(t, 0.0)
                    + rounds * quantum * w
                )
        self._tenant_deficit[pick] = (
            self._tenant_deficit.get(pick, 0.0) - cost
        )
        if pick in self._drr_ring:
            self._drr_next = (
                (self._drr_ring.index(pick) + 1) % len(self._drr_ring)
            )

    def _admit(self) -> List[Request]:
        """Admission until the batch or the cache (minus watermark) is
        full.  Default order is strict FCFS — stop at the first request
        that doesn't fit; skipping ahead would starve large prompts.
        With tenant weights set (:meth:`set_tenant_weights`) the *next*
        request is chosen by deficit round-robin across backlogged
        tenants instead, FCFS within each tenant; blocking stays
        strict."""
        admitted = []
        self._blocked_head = None
        while self.waiting and len(self.running) < self.engine.max_batch:
            req = self._next_admission()
            ctx = len(req.context)
            # Shared full pages covering the prompt's head are claimed
            # instead of allocated: a cache-hot prompt only pays for its
            # un-shared suffix (capacity-wise AND prefill-wise).
            prefix = self.engine.kv.match_prefix(
                req.prompt, namespace=req.prefix_namespace
            )
            # When nothing is running the watermark is waived — a lone
            # request that fits the bare pool must make progress.
            reserve = self.watermark if self.running else 0
            if not self.engine.kv.can_allocate(ctx + 1, reserve=reserve,
                                               prefix_pages=prefix):
                self._blocked_head = req
                break
            if self.waiting[0] is req:
                self.waiting.popleft()
            else:
                self.waiting.remove(req)
            self._charge_admission()
            self.engine.kv.allocate(req.request_id, ctx,
                                    prefix_pages=prefix,
                                    tenant=req.tenant)
            req.prefix_hit_tokens = (
                len(prefix) * self.engine.kv.block_size
            )
            self._prefix_lookup_tokens += len(req.prompt)
            self._prefix_hit_tokens += req.prefix_hit_tokens
            req.state = RequestState.RUNNING
            self.running.append(req)
            admitted.append(req)
        return admitted

    def _preempt_one(self) -> bool:
        """Evict the most-recently-admitted running sequence back to the
        head of the waiting queue.  Returns False when nothing is left
        to evict."""
        if not self.running:
            return False
        victim = self.running.pop()
        self.engine.kv.free(victim.request_id)
        victim.state = RequestState.WAITING
        victim.preemptions += 1
        # A mid-prefill victim recomputes from scratch on re-admission
        # (its partially-written pages were just freed).
        victim.prefill_pos = None
        self.waiting.appendleft(victim)
        if victim.trace is not None:
            tr = _tracing.get_tracer()
            if tr is not None:
                tr.event("preempted", victim.trace, replica=self.replica,
                         generated=len(victim.generated))
                victim.trace_enq = tr.clock()
        if self.reporter is not None:
            self.reporter.count("serving/preemptions", 1)
        return True

    def _fail(self, req: Request, msg: str) -> None:
        if req.request_id in self.engine.kv:
            self.engine.kv.free(req.request_id)
        if req in self.running:
            self.running.remove(req)
        req.state = RequestState.FAILED
        req.error = msg
        self._finished[req.request_id] = req

    def _retire(self, req: Request) -> None:
        self.engine.kv.free(req.request_id)
        self.running.remove(req)
        self._finished[req.request_id] = req

    def _emit(self, req: Request, token: int, tr=None) -> None:
        req.generated.append(token)
        if req.first_token_step is None:
            req.first_token_step = self._step
        if req.tenant is not None and self.reporter is not None:
            self.reporter.count(f"tenant/{req.tenant}/tokens_out", 1)
        if tr is not None and req.trace is not None:
            tr.token(req.trace)
        if req.on_token is not None:
            req.on_token(req.request_id, token)

    # -- the iteration -------------------------------------------------
    def step(self) -> int:
        """One scheduler iteration: admit → prefill admitted → one
        batched decode over all running sequences.  Returns the number
        of tokens emitted this step (0 = idle)."""
        self._step += 1
        emitted = 0
        # Zero-overhead gate: with no tracer installed (and no request
        # carrying a context) every tracing branch below is dead.
        tr = _tracing.get_tracer()

        for req in self._admit():
            traced = tr is not None and req.trace is not None
            if traced and req.trace_enq is not None:
                now = tr.clock()
                tr.record_span(
                    "queue", req.trace, req.trace_enq,
                    now - req.trace_enq, replica=self.replica,
                    depth=len(self.waiting),
                    preemptions=req.preemptions,
                )
                req.trace_enq = None
            t0 = tr.clock() if traced else 0.0
            hit = min(req.prefix_hit_tokens, len(req.context))
            try:
                if hit and hit == len(req.context):
                    # Every page of the context is shared: no prefill at
                    # all.  Recover the last token's logits with a
                    # one-token decode re-writing position ctx-1 — that
                    # position lives in a shared page, so the CoW split
                    # (private replica of the page) makes the write
                    # legal; the rewritten K/V is bit-identical because
                    # the attended prefix is.
                    self.engine.make_writable(req.request_id, hit - 1)
                    logits = self.engine.decode(
                        [req.context[-1]], [req.request_id], [hit - 1]
                    )[0]
                elif (self.engine.prefill_chunk
                      and len(req.context) - hit
                      > self.engine.prefill_chunk):
                    # Long un-cached suffix: prefill it in slices
                    # interleaved with the decode iterations below
                    # instead of stalling this whole step on one prompt.
                    # Pages are already allocated (admission covers the
                    # full context), so slices can't hit OutOfBlocks;
                    # prefix registration and the first sampled token
                    # wait for the final slice.  A prefix hit composes:
                    # slices cover only the un-shared suffix.
                    req.prefill_pos = hit
                    continue
                else:
                    logits = self.engine.prefill_cached(
                        req.context, req.request_id, hit
                    )
                self.engine.kv.register_prefix(
                    req.request_id, req.prompt,
                    namespace=req.prefix_namespace,
                )
            except OutOfBlocks:
                # The CoW split found no free page: un-admit; the next
                # step retries (possibly after preemption frees pages).
                self.engine.kv.free(req.request_id)
                self.running.remove(req)
                req.state = RequestState.WAITING
                self.waiting.appendleft(req)
                continue
            except ValueError as e:  # oversized prompt and similar
                if traced:
                    tr.record_span(
                        "prefill", req.trace, t0, tr.clock() - t0,
                        replica=self.replica, error=True,
                        tokens=len(req.context),
                    )
                self._fail(req, str(e))
                continue
            tok = self.engine.sample(
                logits, req.sampling, len(req.context)
            )
            if traced:
                tr.record_span(
                    "prefill", req.trace, t0, tr.clock() - t0,
                    replica=self.replica, tokens=len(req.context),
                    cached=hit,
                )
            self._emit(req, tok, tr)
            emitted += 1
            if req._finish_if_complete():
                self._retire(req)

        # Chunked prefill: one slice per mid-prefill request per
        # iteration, so a long prompt's prefill co-schedules with the
        # decode batch below instead of monopolising whole steps.
        for req in [r for r in self.running if r.prefill_pos is not None]:
            L = len(req.context)
            pos = req.prefill_pos
            bs = self.engine.kv.block_size
            hit_tokens = 0
            if self.engine.kv.prefix_cache:
                # Re-probe the index before every slice: another
                # sequence streaming the same document may have
                # registered pages past this cursor since the last one.
                hit = self.engine.kv.match_prefix(
                    req.prompt, namespace=req.prefix_namespace
                )
                hit_tokens = len(hit) * bs
                # Adopt only whole pages strictly below the final
                # sampled position: the cursor stays page-aligned and
                # the next slice writes only private pages, so adoption
                # is a pure reference swap (never allocates, never CoWs
                # on the hot path).
                adopt_n = min(len(hit), (L - 1) // bs)
                if self.stream_prefix and adopt_n * bs > pos:
                    self.engine.kv.adopt_prefix(
                        req.request_id, hit[:adopt_n]
                    )
                    skipped = adopt_n * bs - pos
                    self._stream_hit_tokens += skipped
                    if self.reporter is not None:
                        self.reporter.count(
                            "serve/prefill_stream_hits", skipped
                        )
                    pos = adopt_n * bs
                    req.prefill_pos = pos
            end = min(pos + self.engine.prefill_chunk, L)
            if min(end, hit_tokens) > pos:
                # Part of this slice recomputes K/V the index already
                # holds — duplicate prefill work (streaming OFF, or the
                # sub-page tail adoption cannot cover).
                self._dup_prefill_slices += 1
                if self.reporter is not None:
                    self.reporter.count("serve/dup_prefill_slices", 1)
            rtraced = tr is not None and req.trace is not None
            t0 = tr.clock() if rtraced else 0.0
            logits = self.engine.chunk(
                [req.context[pos:end]], [req.request_id], [pos]
            )
            if rtraced:
                tr.record_span(
                    "prefill_chunk", req.trace, t0, tr.clock() - t0,
                    replica=self.replica, tokens=end - pos, pos=end,
                    total=L,
                )
            if end < L:
                req.prefill_pos = end
                if self.stream_prefix:
                    # Publish the completed slice's full pages NOW so a
                    # concurrent request over the same document (local,
                    # or remote via the next gossip beat) shares them
                    # instead of re-prefilling.
                    self.engine.kv.register_prefix(
                        req.request_id, req.prompt[:end],
                        namespace=req.prefix_namespace,
                    )
                continue
            # Final slice: the prompt is fully written — register the
            # prefix and sample the first token at the same position a
            # one-shot prefill would have (bit-exact by the chunk
            # contract: logits[0, t] predicts position pos + t + 1).
            req.prefill_pos = None
            self.engine.kv.register_prefix(
                req.request_id, req.prompt,
                namespace=req.prefix_namespace,
            )
            tok = self.engine.sample(
                logits[0, end - pos - 1], req.sampling, L
            )
            self._emit(req, tok, tr)
            emitted += 1
            if req._finish_if_complete():
                self._retire(req)

        # One decode iteration over the whole running set.  Page growth
        # (extend) happens first so an OutOfBlocks preempts BEFORE any
        # cache write — the evicted sequence replays cleanly.  Mid-
        # prefill sequences are inert here: their allocation already
        # covers the full context, so extend is a no-op, and they are
        # excluded from the decode batch until their final slice lands.
        while self.running:
            try:
                for req in self.running:
                    self.engine.kv.extend(
                        req.request_id, len(req.context)
                    )
                break
            except OutOfBlocks:
                if not self._preempt_one():
                    break
                if not self.running:
                    # the pool can't hold even one sequence's growth
                    lone = self.waiting.popleft()
                    self._fail(
                        lone,
                        "sequence cannot grow within the cache even "
                        "when running alone",
                    )
        batch = [r for r in self.running if r.prefill_pos is None]
        if batch:
            traced_reqs = [] if tr is None else [
                r for r in batch if r.trace is not None
            ]
            # -- speculate: drafts from each request's own context, via
            # the engine's resolved source (n-gram lookup or the
            # truncated draft model — either is a pure function of the
            # context, so acceptance stays bit-exact).  Best-effort page
            # growth for the draft writes; a row whose draft can't get
            # pages (or proposes nothing) simply decodes plainly within
            # the same batched step.
            drafts: Dict[int, List[int]] = {}
            draft_source = getattr(self.engine, "draft_source", "ngram")
            if self.spec_tokens > 0:
                ts0 = tr.clock() if traced_reqs else 0.0
                for r in batch:
                    if not r.speculative:
                        continue
                    room = min(
                        r.max_new_tokens - len(r.generated) - 1,
                        self.engine.config.max_len - len(r.context) - 1,
                    )
                    rtraced = tr is not None and r.trace is not None
                    td0 = tr.clock() if rtraced else 0.0
                    d = self.engine.propose_draft(
                        r.context, min(self.spec_tokens, room)
                    )
                    if rtraced:
                        tr.record_span(
                            "draft", r.trace, td0, tr.clock() - td0,
                            replica=self.replica, source=draft_source,
                            draft=len(d),
                        )
                    if not d:
                        continue
                    try:
                        self.engine.kv.extend(
                            r.request_id, len(r.context) + len(d)
                        )
                    except OutOfBlocks:
                        continue
                    drafts[r.request_id] = d
                if traced_reqs:
                    dur = tr.clock() - ts0
                    for r in traced_reqs:
                        tr.record_span(
                            "speculate", r.trace, ts0, dur,
                            replica=self.replica,
                            draft=len(drafts.get(r.request_id, ())),
                        )
            t0 = tr.clock() if traced_reqs else 0.0
            # context[-1] is the token sampled last step but not yet
            # written to the pages — write it at position len-1, then
            # the returned logits predict position len.  With drafts the
            # verify chunk row is [pending, d1..dk]: logits[j] predicts
            # position len-1+j+1, bit-exact to j+1 sequential decodes as
            # long as d1..dj matched the sampled stream.
            lens = [len(r.context) - 1 for r in batch]
            if drafts:
                logits_rows = self.engine.chunk(
                    [[r.context[-1]] + drafts.get(r.request_id, [])
                     for r in batch],
                    [r.request_id for r in batch],
                    lens,
                )
            else:
                logits = self.engine.decode(
                    [r.context[-1] for r in batch],
                    [r.request_id for r in batch],
                    lens,
                )
            accepted_by_id: Dict[int, int] = {}
            for i, req in enumerate(batch):
                d = drafts.get(req.request_id, [])
                base = len(req.context)
                accept: List[int] = []
                for j in range(len(d) + 1):
                    row = logits_rows[i, j] if drafts else logits[i]
                    tok = self.engine.sample(row, req.sampling, base + j)
                    accept.append(tok)
                    if j < len(d) and tok != d[j]:
                        break  # first true token the draft missed
                    if req.stop_token is not None and tok == req.stop_token:
                        break
                    if (len(req.generated) + len(accept)
                            >= req.max_new_tokens):
                        break
                if drafts:
                    self._spec_rows += 1
                    self._spec_emitted += len(accept)
                    self._spec_rows_by[draft_source] = (
                        self._spec_rows_by.get(draft_source, 0) + 1
                    )
                    self._spec_emitted_by[draft_source] = (
                        self._spec_emitted_by.get(draft_source, 0)
                        + len(accept)
                    )
                    accepted_by_id[req.request_id] = len(accept)
                for tok in accept:
                    self._emit(req, tok, tr)
                    emitted += 1
                # Give back pages the accepted run didn't need, restoring
                # the between-iteration invariant (coverage == context-1,
                # the state adopt_request and migration expect).
                self.engine.kv.truncate(
                    req.request_id, len(req.context) - 1
                )
                if req._finish_if_complete():
                    self._retire(req)
            if traced_reqs:
                # One batched iteration serves every traced request in
                # it; they share the measured duration (sampling +
                # streaming included).
                dur = tr.clock() - t0
                stage = "verify" if drafts else "decode"
                for r in traced_reqs:
                    attrs = dict(replica=self.replica, batch=len(batch))
                    if drafts:
                        attrs["accepted"] = accepted_by_id.get(
                            r.request_id, 0
                        )
                    tr.record_span(stage, r.trace, t0, dur, **attrs)

        if self.reporter is not None:
            st = self.engine.kv.stats()
            sfx = self._gauge_suffix
            self.reporter.gauge(f"serving/cache_utilization{sfx}",
                                st.utilization)
            self.reporter.gauge(f"serving/used_blocks{sfx}",
                                st.used_blocks)
            self.reporter.gauge(f"serving/free_blocks{sfx}",
                                st.free_blocks)
            self.reporter.gauge(f"serving/running{sfx}",
                                len(self.running))
            self.reporter.gauge(f"serving/waiting{sfx}",
                                len(self.waiting))
            if self._tenant_weights:
                # Deficit credit per backlogged tenant: positive means
                # the tenant is owed service, negative that its last
                # admission ran ahead of its share.
                for ten in sorted(self._tenant_deficit):
                    self.reporter.gauge(
                        f"serve/tenant_deficit/{ten or 'default'}{sfx}",
                        self._tenant_deficit[ten],
                    )
            self.reporter.gauge(f"serving/cached_blocks{sfx}",
                                st.cached_blocks)
            if self._prefix_lookup_tokens:
                self.reporter.gauge(
                    f"serve/prefix_hit_rate{sfx}",
                    self._prefix_hit_tokens / self._prefix_lookup_tokens,
                )
            if self._spec_rows:
                self.reporter.gauge(
                    f"serve/spec_accept_len{sfx}",
                    self._spec_emitted / self._spec_rows,
                )
                # Labelled per-draft-source twins (satellite of the
                # aggregate gauge above, which keeps its name).
                for src, rows in self._spec_rows_by.items():
                    if rows:
                        self.reporter.gauge(
                            f"serve/spec_accept_len/{src}{sfx}",
                            self._spec_emitted_by[src] / rows,
                        )
            if emitted:
                self.reporter.count("serving/tokens", emitted)
            # Per-tenant KV residency: page-seconds integrated by the
            # cache itself (sum over tenants == the pool's used-page
            # integral, exactly — conservation is by construction).
            tenant_ps = self.engine.kv.page_seconds()
            if tenant_ps:
                for ten, ps in tenant_ps.items():
                    self.reporter.gauge(
                        f"tenant/{ten}/kv_page_seconds", ps
                    )
                self.reporter.gauge(
                    f"serving/kv_page_seconds{sfx}",
                    self.engine.kv.pool_page_seconds(),
                )
        return emitted

    # -- driving -------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def run_to_completion(self, max_steps: int = 100_000
                          ) -> Dict[int, Request]:
        """Step until idle; returns {request_id: Request} for every
        retired request.  ``max_steps`` is a runaway guard, not a
        policy knob."""
        steps = 0
        while self.has_work:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"scheduler did not drain within {max_steps} steps"
                )
            made = self.step()
            if made == 0 and not self.running and self.waiting:
                # waiting but nothing admittable and nothing running:
                # the (DRR-ordered) head request can never fit.
                victim = self._blocked_head
                if victim is None or victim not in self.waiting:
                    victim = self.waiting[0]
                self.waiting.remove(victim)
                self._fail(
                    victim,
                    "prompt cannot be admitted: exceeds cache capacity",
                )
        return dict(self._finished)

    def results(self) -> Dict[int, Request]:
        return dict(self._finished)

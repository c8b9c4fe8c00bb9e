"""Prefill/decode disaggregation: long prompts off the decode path.

A long prompt's prefill is a single giant jit step; run on the replica
that is also decoding, it stalls every in-flight stream for its whole
duration (the DistServe/Splitwise observation).  Disaggregation routes
prompts at/above the router's ``prefill_threshold`` to a PREFILL-role
replica, which:

1. allocates a scratch sequence, prefills the prompt, and samples the
   first generated token (committed immediately — time-to-first-token
   is the prefill replica's product);
2. snapshots the written pages (:func:`migration.extract_sequence`) and
   frees the scratch sequence — the prefill pool only ever holds
   prompts in flight;
3. hands the snapshot to the router, which places it on a DECODE-role
   replica with batch+page headroom: pages restored under a freshly
   reserved request id, then the request is ADOPTED straight into the
   decode batch (:meth:`ServeFrontend.adopt`) carrying the first token
   as already-generated context.

The adopted request is bit-exactly the request that would have existed
had the decode replica prefilled locally — same pages, same context,
same counter-based sampling positions — so the disaggregated stream
equals the single-engine oracle's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...observability import tracing as _tracing
from .migration import (
    KVSnapshot,
    extract_sequence,
)
from ..kv_cache import OutOfBlocks


@dataclasses.dataclass
class PrefillJob:
    """One disaggregated prompt queued on a prefill-role replica.
    ``handle`` is the router's ClusterHandle (opaque here — disagg only
    threads it through so the router can correlate results)."""

    handle: object
    prompt: list
    sampling: object
    attempts: int = 0
    #: root trace context the prefill span parents to (None untraced).
    trace: Optional[_tracing.SpanCtx] = None


@dataclasses.dataclass
class PrefillResult:
    """A finished prefill awaiting decode placement: the snapshot plus
    the first sampled token.  ``error`` set means the job failed
    terminally (oversized prompt, ...) and carries no snapshot."""

    job: PrefillJob
    snapshot: Optional[KVSnapshot] = None
    first_token: Optional[int] = None
    error: Optional[str] = None


# Scratch-sequence ids on the prefill pool: request ids live in the
# decode replica's namespace, so scratch ids use a private nonce.
_scratch_counter = 0


def run_prefill_job(engine, job: PrefillJob,
                    replica=None) -> Optional[PrefillResult]:
    """Execute one prefill job on ``engine`` (a prefill-role replica's).
    Returns the result, or None when the pool momentarily can't hold the
    prompt (caller requeues; ``attempts`` counts the retries).
    ``replica`` stamps the prefill span when tracing is active."""
    global _scratch_counter
    L = len(job.prompt)
    need = engine.kv.blocks_for(L)
    if need > engine.kv.n_blocks:
        return PrefillResult(
            job=job,
            error=(
                f"prompt of {L} tokens needs {need} pages; the prefill "
                f"pool holds {engine.kv.n_blocks}"
            ),
        )
    if not engine.kv.can_allocate(L):
        job.attempts += 1
        return None  # transient: other prefills hold the pool
    tr = _tracing.get_tracer()
    traced = tr is not None and job.trace is not None
    t0 = tr.clock() if traced else 0.0
    _scratch_counter += 1
    sid = ("prefill_scratch", _scratch_counter)
    engine.kv.allocate(sid, L)
    try:
        logits = engine.prefill(job.prompt, sid)
        first = engine.sample(logits, job.sampling, L)
        snap = extract_sequence(engine, sid, context=list(job.prompt),
                                prompt_len=L)
    except ValueError as e:
        if traced:
            tr.record_span("prefill", job.trace, t0, tr.clock() - t0,
                           replica=replica, error=True, tokens=L,
                           disagg=True)
        return PrefillResult(job=job, error=str(e))
    finally:
        engine.kv.free(sid)
    if traced:
        tr.record_span("prefill", job.trace, t0, tr.clock() - t0,
                       replica=replica, tokens=L, disagg=True,
                       attempts=job.attempts)
    return PrefillResult(job=job, snapshot=snap, first_token=first)


def place_handoff(replica, result: PrefillResult, req,
                  timeout_s: Optional[float] = None):
    """Restore ``result``'s pages on ``replica`` and adopt ``req`` into
    its decode batch.  Returns the replica-local RequestHandle, or None
    when the replica momentarily lacks pages/batch room (the router
    keeps the handoff pending and retries).  ``req.request_id`` must be
    unset (None): the id is reserved here, on the adopting frontend."""
    from .migration import restore_sequence

    eng = replica.scheduler.engine
    if len(replica.scheduler.running) >= eng.max_batch:
        return None
    tr = _tracing.get_tracer()
    traced = tr is not None and req.trace is not None
    t0 = tr.clock() if traced else 0.0
    rid = replica.frontend.reserve_id()
    try:
        restore_sequence(eng, result.snapshot, rid)
    except OutOfBlocks:
        return None
    req.request_id = rid
    try:
        handle = replica.frontend.adopt(req, timeout_s=timeout_s)
    except OutOfBlocks:
        eng.kv.free(rid)
        return None
    if traced:
        tr.record_span("handoff", req.trace, t0, tr.clock() - t0,
                       replica=replica.replica_id,
                       tokens=len(req.context))
    return handle

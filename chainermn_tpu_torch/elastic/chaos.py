"""Deterministic fault injection — the chaos harness; port of
``chainermn_tpu/elastic/chaos.py`` (host code, copied as it is).

A :class:`ChaosSchedule` is a declarative list of faults, written as a
single string so it travels through env vars and CLI flags unchanged::

    kill:rank=1:step=5;term:rank=0:step=8;hb_stall:rank=1:step=3:secs=30
    ckpt_corrupt:rank=0:gen=4;ckpt_torn:rank=1:gen=6;ckpt_slow:secs=0.05

Faults fire *inside the targeted rank* at that rank's own step counter
— not from the supervisor's clock — so a schedule is exactly
reproducible: ``kill:rank=1:step=5`` dies at the same optimizer state
every run.  Each fault carries the incarnation it belongs to
(default 0, the first launch), so a kill does not re-fire after the
supervisor respawns the world.

Kinds:

* ``kill`` — ``SIGKILL`` self at ``step`` (a hard crash: no cleanup,
  peers stall until the supervisor's heartbeat deadline).
* ``term`` — ``SIGTERM`` self at ``step`` (preemption: the elastic
  runtime's handler turns it into a coordinated grace-window
  checkpoint and a distinct exit code).
* ``hb_stall`` — suppress heartbeats for ``secs`` starting at ``step``
  (alive-but-silent: only the deadline can catch it).
* ``ckpt_corrupt`` — after generation ``gen`` commits, flip a payload
  byte in this rank's snapshot (the payload crc32 must catch it on load).
* ``ckpt_torn`` — truncate the tail of generation ``gen``'s snapshot
  (a torn write: the header parses, the payload doesn't).
* ``ckpt_slow`` — sleep ``secs`` inside every checkpoint save (slow
  snapshot I/O widening the crash window).

The schedule drives the test suite and ``tools.serve --chaos``; an
elastic supervisor passes it to ranks via ``CHAINERMN_TPU_CHAOS``.

Serving-tier coordinates: the same grammar also addresses *serving
replicas* on a *wall-clock* axis — ``kill:replica=1:at=0.25`` kills
replica 1 a quarter second into a traffic run.  ``replica=`` targets a
replica id instead of a training rank, and ``at=`` (seconds since the
harness armed) replaces ``step=`` where there is no shared step counter
— a cluster of free-running replica threads has no step, only time.
``kill``/``term`` accept either coordinate; :class:`TimedChaos` is the
serving-side executor that fires ``at=`` faults exactly once as their
deadline passes (the *caller* maps the fault onto an action —
``router.fail_replica`` for an in-process harness, a real ``SIGKILL``
for a multi-process one — so the grammar stays policy-free).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import List, Optional, Tuple

ENV_SCHEDULE = "CHAINERMN_TPU_CHAOS"

_KINDS = ("kill", "term", "hb_stall", "ckpt_corrupt", "ckpt_torn",
          "ckpt_slow")
# kill/term fire at a training step OR a wall-clock offset (one of the
# tuple suffices); every other kind keeps its fixed requirement.
_REQUIRED = {
    "kill": (("step", "at"),),
    "term": (("step", "at"),),
    "hb_stall": ("step", "secs"),
    "ckpt_corrupt": ("gen",),
    "ckpt_torn": ("gen",),
    "ckpt_slow": ("secs",),
}


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    rank: Optional[int] = None  # None targets every rank
    step: Optional[int] = None
    gen: Optional[int] = None
    secs: float = 0.0
    inc: int = 0  # incarnation the fault belongs to (-1: every one)
    replica: Optional[int] = None  # serving-replica target (vs. rank)
    at: Optional[float] = None  # seconds since harness start (vs. step)

    def targets(self, rank: int, incarnation: int) -> bool:
        if self.rank is not None and self.rank != rank:
            return False
        return self.inc == -1 or self.inc == incarnation

    def format(self) -> str:
        parts = [self.kind]
        if self.rank is not None:
            parts.append(f"rank={self.rank}")
        if self.replica is not None:
            parts.append(f"replica={self.replica}")
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.at is not None:
            parts.append(f"at={self.at:g}")
        if self.gen is not None:
            parts.append(f"gen={self.gen}")
        if self.secs:
            parts.append(f"secs={self.secs:g}")
        if self.inc != 0:
            parts.append(f"inc={self.inc}")
        return ":".join(parts)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    faults: Tuple[Fault, ...] = ()

    @classmethod
    def parse(cls, text: str) -> "ChaosSchedule":
        faults = []
        for item in (text or "").split(";"):
            item = item.strip()
            if not item:
                continue
            fields = item.split(":")
            kind = fields[0].strip()
            if kind not in _KINDS:
                raise ValueError(
                    f"chaos: unknown fault kind {kind!r} in {item!r} "
                    f"(known: {', '.join(_KINDS)})"
                )
            kw: dict = {}
            for kv in fields[1:]:
                if "=" not in kv:
                    raise ValueError(
                        f"chaos: expected key=value, got {kv!r} in {item!r}"
                    )
                k, v = kv.split("=", 1)
                k = k.strip()
                if k in ("rank", "step", "gen", "inc", "replica"):
                    kw[k] = int(v)
                elif k in ("secs", "at"):
                    kw[k] = float(v)
                else:
                    raise ValueError(
                        f"chaos: unknown key {k!r} in {item!r}"
                    )
            missing = [
                req for req in _REQUIRED[kind]
                if not any(
                    k in kw
                    for k in (req if isinstance(req, tuple) else (req,))
                )
            ]
            if missing:
                names = [
                    "|".join(m) if isinstance(m, tuple) else m
                    for m in missing
                ]
                raise ValueError(
                    f"chaos: fault {kind!r} requires "
                    f"{'/'.join(names)} in {item!r}"
                )
            faults.append(Fault(kind=kind, **kw))
        return cls(tuple(faults))

    def format(self) -> str:
        return ";".join(f.format() for f in self.faults)

    def for_rank(self, rank: int, incarnation: int) -> Tuple[Fault, ...]:
        return tuple(
            f for f in self.faults if f.targets(rank, incarnation)
        )

    def timed(self) -> Tuple[Fault, ...]:
        """Faults on the wall-clock axis (``at=``), in firing order —
        the subset a :class:`TimedChaos` executor arms."""
        return tuple(
            sorted(
                (f for f in self.faults if f.at is not None),
                key=lambda f: f.at,
            )
        )


class ChaosEngine:
    """Worker-side fault executor: armed with the faults that target
    this (rank, incarnation), it fires step faults from
    :meth:`on_step` and checkpoint faults from a wrapped
    ``MultiNodeCheckpointer.save``."""

    def __init__(self, schedule: ChaosSchedule, rank: int,
                 incarnation: int, heartbeat=None):
        self.rank = int(rank)
        self.incarnation = int(incarnation)
        self.heartbeat = heartbeat
        self._armed = list(schedule.for_rank(rank, incarnation))
        self._fired: set = set()

    def _due(self, kinds, step=None, gen=None):
        for f in self._armed:
            if f.kind not in kinds or id(f) in self._fired:
                continue
            if step is not None and (f.step is None or step < f.step):
                continue
            if gen is not None and (f.gen is None or gen < f.gen):
                continue
            self._fired.add(id(f))
            yield f

    # -- step faults ---------------------------------------------------
    def on_step(self, step: int) -> None:
        """Call once per training step, BEFORE the step executes: a
        ``step=s`` fault fires with exactly ``s`` steps completed."""
        for f in self._due(("hb_stall",), step=step):
            if self.heartbeat is not None:
                self.heartbeat.suppress(f.secs)
        for f in self._due(("term",), step=step):
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGTERM)
        for f in self._due(("kill",), step=step):
            sys.stdout.write(
                f"chaos: SIGKILL rank {self.rank} at step {step}\n"
            )
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    # -- checkpoint faults ---------------------------------------------
    def wrap_checkpointer(self, ckpt) -> None:
        """Wrap ``ckpt.save`` so ckpt_* faults fire at the declared
        generation.  Corruption happens AFTER the save commits (the
        two-phase rename completed, the marker is up): precisely the
        torn-payload-with-valid-marker state maybe_load's crc vote must
        catch."""
        if not any(f.kind.startswith("ckpt_") for f in self._armed):
            return
        orig = ckpt.save

        def save(state, iteration, block=True):
            for f in self._due(("ckpt_slow",), gen=None):
                self._fired.discard(id(f))  # every save, not once
                time.sleep(f.secs)
            hit = list(self._due(("ckpt_corrupt", "ckpt_torn"),
                                 gen=iteration))
            if hit:
                orig(state, iteration, block=True)
                ckpt.wait()
                snap = ckpt._snap(iteration, ckpt.comm.rank)
                for f in hit:
                    _damage(snap, torn=(f.kind == "ckpt_torn"))
                    sys.stdout.write(
                        f"chaos: {f.kind} rank {self.rank} "
                        f"gen {iteration}\n"
                    )
                    sys.stdout.flush()
                return
            return orig(state, iteration, block=block)

        ckpt.save = save


def _damage(path: str, torn: bool) -> None:
    size = os.path.getsize(path)
    if torn:
        with open(path, "r+b") as f:
            f.truncate(max(0, size - 7))
        return
    # Flip one payload byte (the last byte before the trailing u32
    # crc32) so the payload checksum mismatches.
    off = max(0, size - 5)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


def engine_from_env(rank: int, incarnation: int,
                    heartbeat=None) -> Optional[ChaosEngine]:
    text = os.environ.get(ENV_SCHEDULE)
    if not text:
        return None
    return ChaosEngine(
        ChaosSchedule.parse(text), rank, incarnation, heartbeat=heartbeat
    )


class TimedChaos:
    """Serving-side executor for ``at=`` faults.

    Training chaos fires inside the victim at its own step counter;
    serving replicas free-run with no shared step, so the only
    reproducible coordinate is elapsed time since the harness armed.
    :meth:`due` returns each fault exactly once when its deadline
    passes — the caller maps it onto an action (``fail_replica`` for
    thread replicas, ``os.kill`` for process ones), keeping the grammar
    itself free of any cluster policy."""

    def __init__(self, schedule: ChaosSchedule,
                 clock=time.monotonic):
        self.clock = clock
        self._armed = list(schedule.timed())
        self._t0: Optional[float] = None

    def start(self, now: Optional[float] = None) -> None:
        self._t0 = self.clock() if now is None else now

    @property
    def pending(self) -> int:
        return len(self._armed)

    def due(self, now: Optional[float] = None) -> Tuple[Fault, ...]:
        """Newly-due faults (armed, deadline passed), oldest first.
        Arms the clock lazily on first call so bare ``due()`` polling
        works without an explicit :meth:`start`."""
        now = self.clock() if now is None else now
        if self._t0 is None:
            self._t0 = now
        elapsed = now - self._t0
        fired = tuple(f for f in self._armed if f.at <= elapsed)
        if fired:
            self._armed = [f for f in self._armed if f.at > elapsed]
        return fired


# Canonical corpus for grammar smoke checks (``tools.lint --self``):
# every accepted form round-trips parse→format→parse unchanged, and
# each rejected form must raise — so a grammar regression is caught by
# the same lint gate that guards source hygiene.
GRAMMAR_CORPUS_OK = (
    "kill:rank=1:step=5",
    "term:rank=0:step=8;hb_stall:rank=1:step=3:secs=30",
    "ckpt_corrupt:rank=0:gen=4;ckpt_torn:rank=1:gen=6;ckpt_slow:secs=0.05",
    "kill:replica=1:at=0.25",
    "kill:replica=2:at=1.5;term:replica=0:at=3",
    "kill:rank=1:step=5:inc=-1",
)
GRAMMAR_CORPUS_BAD = (
    "explode:rank=1:step=5",        # unknown kind
    "kill:rank=1",                  # kill needs step or at
    "kill:replica=1",               # ... regardless of target axis
    "hb_stall:rank=1:step=3",       # hb_stall needs secs
    "kill:rank=1:step",             # not key=value
    "kill:rank=1:when=5",           # unknown key
)


def validate_grammar() -> List[str]:
    """Self-check the schedule grammar against the canonical corpus.
    Returns a list of problems (empty when healthy)."""
    problems: List[str] = []
    for text in GRAMMAR_CORPUS_OK:
        try:
            sched = ChaosSchedule.parse(text)
            rt = ChaosSchedule.parse(sched.format())
            if rt != sched:
                problems.append(
                    f"chaos grammar: {text!r} does not round-trip "
                    f"(format() -> {sched.format()!r})"
                )
        except ValueError as e:
            problems.append(f"chaos grammar: {text!r} rejected: {e}")
    for text in GRAMMAR_CORPUS_BAD:
        try:
            ChaosSchedule.parse(text)
        except ValueError:
            continue
        problems.append(
            f"chaos grammar: invalid schedule {text!r} was accepted"
        )
    return problems

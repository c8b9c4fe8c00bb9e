"""Elastic training supervisor — the port of
``chainermn_tpu/elastic/supervisor.py``; it owns the trainer processes end
to end.

The supervisor spawns the N-rank ``torch.distributed`` world (each rank
learns its identity from ``CHAINERMN_TPU_ELASTIC_*`` and forms the group
at the coordinator address given there), monitors liveness (process exit
codes AND heartbeat-file deadlines through the shared
:class:`~chainermn_tpu_torch.elastic.heartbeat.HeartbeatMonitor` — a rank
that is alive but wedged looks the same as a dead one), and when a rank
dies it tears the survivors down with *bounded* waits (SIGTERM, backoff
polls, SIGKILL; nothing here blocks without a deadline), then rebuilds the
world and lets training resume from the newest consistent checkpoint
generation:

* **respawn in place** (default): the same world size on a fresh
  coordinator port;
* **rescale** (``rescale_on_failure``): shrink to the surviving rank
  count — the relaunched ranks re-place parameters and moments through
  the ``ShardingPlan`` registry (``ElasticContext.reshard``), so an N→M
  restart needs no conversion step.  A rank that left through the crash
  hook (exit 13) survives: over ``torch.distributed`` a peer's death
  fails the others' next collective at once, where the reference's peers
  block until teardown.

SIGTERM as preemption is first-class: ranks that exit with
``EXIT_PREEMPTED`` (the worker's grace-window checkpoint path) are
counted apart from crashes and always respawned — the spot-capacity case,
where preemption is routine and crash budgets are for bugs.

Everything the supervisor observes — spawns, deaths (with the crash
postmortem row the dying rank appended), teardowns, restarts,
preemptions, resume generations — goes to a step-event log
(``--step-log``) as ``elastic`` event rows plus ``counter`` rows that
``tools.obs summarize``/``prom`` show as ``elastic/restarts``,
``elastic/preemptions`` and ``elastic/resume_generation``.

This module imports neither torch nor the communicator stack: it is
process supervision alone, cheap enough to test with stdlib dummy
workers, and the same command line drives either package's ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from .heartbeat import HeartbeatMonitor, read_beat

#: Exit code the elastic runtime uses for a clean preemption exit
#: (EX_TEMPFAIL-adjacent: "try again", distinct from the crash
#: barrier's 13 and from signal deaths' negative codes).
EXIT_PREEMPTED = 75

#: The crash hook's exit code (``global_except_hook``): the rank's process
#: raised and left, but its host and card did not go away.
EXIT_CRASH_HOOK = 13

_RESUME_RE = re.compile(r"resumed from iteration (\d+)")


@dataclasses.dataclass
class SupervisorConfig:
    """One elastic job.  ``argv`` is the rank command line, launched
    identically for every rank — rank identity travels via env
    (``CHAINERMN_TPU_ELASTIC_*``), never argv, so respawn and rescale
    need no argv surgery."""

    argv: List[str]
    nproc: int
    max_restarts: int = 2          # crash-restart budget (preemptions excluded)
    max_preemptions: int = 16      # backstop so a term-looping job terminates
    rescale_on_failure: bool = False
    min_nproc: int = 1
    heartbeat_timeout_s: float = 60.0
    start_grace_s: float = 120.0   # deadline for the FIRST beat (start-up)
    poll_s: float = 0.1
    grace_s: float = 10.0          # teardown: SIGTERM → this long → SIGKILL
    backoff_s: float = 0.5         # respawn backoff base (doubles, capped 8s)
    chaos: Optional[str] = None
    workdir: Optional[str] = None  # heartbeat/postmortem files live here
    step_log: Optional[str] = None
    env: Optional[Dict[str, str]] = None
    echo: bool = True              # prefix-echo rank output to our stdout
    coordinator_host: str = "127.0.0.1"
    barrier_timeout_s: Optional[float] = 120.0  # exported to ranks
    init_timeout_s: float = 120.0
    #: serve a live Prometheus /metrics scrape endpoint on this port
    #: while the job runs (0 = ephemeral; None = off): the elastic/*
    #: counters plus per-event-kind counts, scrapeable mid-chaos.
    metrics_port: Optional[int] = None


class _Rank:
    """One spawned rank: the process, its heartbeat file, and a reader
    thread draining stdout (scanning for resume/digest markers while
    preventing pipe-full deadlock)."""

    def __init__(self, rank: int, proc: subprocess.Popen, hb_path: str,
                 echo: bool):
        self.rank = rank
        self.proc = proc
        self.hb_path = hb_path
        self.lines: List[str] = []
        self._echo = echo
        self.reader = threading.Thread(target=self._drain, daemon=True)
        self.reader.start()

    def _drain(self):
        try:
            for line in self.proc.stdout:
                self.lines.append(line)
                if self._echo:
                    sys.stdout.write(f"[r{self.rank}] {line}")
                    sys.stdout.flush()
        except Exception:
            pass

    def output(self) -> str:
        return "".join(self.lines)


class ElasticSupervisor:
    def __init__(self, config: SupervisorConfig):
        if config.nproc < 1:
            raise ValueError("nproc must be >= 1")
        self.config = config
        self.restarts = 0
        self.preemptions = 0
        self.incarnation = 0
        #: fabric control surface: a chip arbiter asks the job to
        #: change size via :meth:`yield_ranks`/:meth:`grant_ranks`.
        #: The resize rides the normal preemption path (SIGTERM →
        #: grace-window checkpoint → exit 75 → respawn), so resumes
        #: stay bit-exact; lease-driven rescales are counted separately
        #: and never burn the ``max_preemptions`` budget.
        self.world = config.nproc
        self.running = False
        self.lease_rescales = 0
        self.lease_tag = ""
        self._ctl_lock = threading.Lock()
        self._target_world: Optional[int] = None
        self._fabric_preempt = False
        self._live_ranks: List[_Rank] = []
        self.resume_generation: Optional[int] = None
        self.params_digest: Optional[str] = None
        self.events: List[dict] = []
        self._recorder = None
        self._reporter = None
        self._exporter = None
        #: scrape URL once the exporter is up (config.metrics_port).
        self.metrics_url: Optional[str] = None
        self._workdir = config.workdir or os.path.join(
            os.getcwd(), "elastic-supervisor"
        )
        os.makedirs(self._workdir, exist_ok=True)

    # -- observability -------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        row = {"kind": kind, "incarnation": self.incarnation, **fields}
        self.events.append(row)
        if self._recorder is not None:
            self._recorder.record("elastic", **row)
            for name, value in (
                ("elastic/restarts", self.restarts),
                ("elastic/preemptions", self.preemptions),
                ("elastic/resume_generation",
                 self.resume_generation or 0),
            ):
                self._recorder.record("counter", name=name, value=value)
        if self._reporter is not None:
            self._reporter.count(f"elastic/events/{kind}", 1)
            self._reporter.gauge("elastic/restarts", self.restarts)
            self._reporter.gauge("elastic/preemptions", self.preemptions)
            self._reporter.gauge("elastic/incarnation", self.incarnation)
            self._reporter.gauge("elastic/resume_generation",
                                 self.resume_generation or 0)

    # -- fabric control surface ----------------------------------------
    def set_lease_tag(self, tag: str) -> None:
        """Stamp subsequent incarnations with the fabric lease id (the
        ranks echo it into their heartbeat files)."""
        self.lease_tag = tag

    def request_world(self, new_world: int) -> bool:
        """Ask the running job to resize to ``new_world`` ranks.

        Returns immediately (False when the job is not running or the
        size is a no-op); the resize completes asynchronously: live
        ranks get SIGTERM, take the grace-window checkpoint, exit 75,
        and the run loop respawns at the new size, where ``maybe_load``
        re-shards through the ShardingPlan registry and resumes
        bit-exactly.  Watch :attr:`world` to observe completion.
        """
        new_world = max(int(new_world), self.config.min_nproc)
        with self._ctl_lock:
            if not self.running:
                return False
            if new_world == (self._target_world
                             if self._target_world is not None
                             else self.world):
                return False
            self._target_world = new_world
            self._fabric_preempt = True
            live = list(self._live_ranks)
        for rk in live:
            if rk.proc.poll() is None:
                try:
                    rk.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        return True

    def yield_ranks(self, k: int) -> bool:
        """Shrink the job by ``k`` ranks (fabric preempts chips for
        serving)."""
        return self.request_world(self.world - int(k))

    def grant_ranks(self, k: int) -> bool:
        """Grow the job by ``k`` ranks (fabric returns chips)."""
        return self.request_world(self.world + int(k))

    # -- process plumbing ----------------------------------------------
    def _free_port(self) -> int:
        with socket.socket() as s:
            s.bind((self.config.coordinator_host, 0))
            return s.getsockname()[1]

    def _spawn_world(self, world: int) -> List[_Rank]:
        cfg = self.config
        port = self._free_port()
        coord = f"{cfg.coordinator_host}:{port}"
        inc_dir = os.path.join(self._workdir, f"inc{self.incarnation}")
        os.makedirs(inc_dir, exist_ok=True)
        ranks = []
        for r in range(world):
            hb = os.path.join(inc_dir, f"hb.rank{r}")
            env = dict(os.environ)
            env.update(cfg.env or {})
            env.update({
                "CHAINERMN_TPU_ELASTIC": "1",
                "CHAINERMN_TPU_ELASTIC_RANK": str(r),
                "CHAINERMN_TPU_ELASTIC_NPROC": str(world),
                "CHAINERMN_TPU_ELASTIC_COORD": coord,
                "CHAINERMN_TPU_ELASTIC_HB_FILE": hb,
                "CHAINERMN_TPU_ELASTIC_INCARNATION":
                    str(self.incarnation),
                "CHAINERMN_TPU_ELASTIC_INIT_TIMEOUT_S":
                    str(cfg.init_timeout_s),
                "CHAINERMN_TPU_POSTMORTEM_FILE":
                    os.path.join(self._workdir, "postmortem.jsonl"),
                "CHAINERMN_TPU_ELASTIC_PLANE": "train",
                "CHAINERMN_TPU_ELASTIC_LEASE": self.lease_tag,
            })
            if cfg.chaos:
                env["CHAINERMN_TPU_CHAOS"] = cfg.chaos
            if cfg.barrier_timeout_s is not None:
                env["CHAINERMN_TPU_BARRIER_TIMEOUT_S"] = \
                    str(cfg.barrier_timeout_s)
            proc = subprocess.Popen(
                cfg.argv, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env,
            )
            ranks.append(_Rank(r, proc, hb, cfg.echo))
        with self._ctl_lock:
            self._live_ranks = ranks
            self.world = world
        self._event("spawn", world=world, coordinator=coord,
                    pids=[rk.proc.pid for rk in ranks])
        return ranks

    def _teardown(self, ranks: List[_Rank]) -> None:
        """Bounded: SIGTERM everyone alive, poll with backoff up to
        ``grace_s``, SIGKILL stragglers, then reap (a SIGKILLed process
        cannot refuse the reap, so the final joins are brief)."""
        cfg = self.config
        alive = [rk for rk in ranks if rk.proc.poll() is None]
        for rk in alive:
            try:
                rk.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + cfg.grace_s
        pause = cfg.poll_s
        while alive and time.monotonic() < deadline:
            alive = [rk for rk in alive if rk.proc.poll() is None]
            if alive:
                time.sleep(pause)
                pause = min(pause * 2, 1.0)
        killed = []
        for rk in alive:
            try:
                rk.proc.kill()
                killed.append(rk.rank)
            except OSError:
                pass
        for rk in ranks:
            try:
                rk.proc.wait(timeout=cfg.grace_s)
            except subprocess.TimeoutExpired:
                pass
            if rk.proc.stdout is not None:
                rk.reader.join(timeout=2.0)
                try:
                    rk.proc.stdout.close()
                except OSError:
                    pass
        self._event("teardown", sigkilled=killed)

    # -- postmortem ----------------------------------------------------
    def _postmortem_rows(self) -> List[dict]:
        path = os.path.join(self._workdir, "postmortem.jsonl")
        try:
            from ..observability.step_log import read_records

            return [r for r in read_records(path)
                    if r.get("event") == "crash"]
        except Exception:
            return []

    # -- one incarnation -----------------------------------------------
    def _monitor(self, ranks: List[_Rank]) -> dict:
        """Run one incarnation to an outcome:
        ``{"outcome": "ok"|"preempted"|"crash", ...}``.  Every exit
        path through here is deadline-bounded."""
        cfg = self.config
        monitor = HeartbeatMonitor(
            [rk.rank for rk in ranks],
            miss_after_s=cfg.heartbeat_timeout_s, clock=time.time,
        )
        first_beat: Dict[int, bool] = {rk.rank: False for rk in ranks}
        start = time.time()
        while True:
            exited_bad = []
            running = []
            for rk in ranks:
                code = rk.proc.poll()
                if code is None:
                    running.append(rk)
                    mtime = read_beat(rk.hb_path)
                    if mtime is not None:
                        first_beat[rk.rank] = True
                        monitor.beat(rk.rank, now=mtime)
                    elif time.time() - start < cfg.start_grace_s:
                        # Pre-first-beat grace: process start-up and
                        # the group's formation can dwarf the
                        # steady-state deadline.
                        monitor.beat(rk.rank)
                elif code == 0:
                    # Done: its beats stop on purpose, so its silence
                    # must not read as a death while a peer still runs.
                    monitor.forget(rk.rank)
                elif code != EXIT_PREEMPTED:
                    exited_bad.append((rk.rank, code))
                    monitor.mark_dead(rk.rank)
            hb_dead = monitor.check()
            if exited_bad or hb_dead:
                # A rank that already left with EXIT_PREEMPTED makes this
                # a preemption, not a crash: the coordinated grace-window
                # checkpoint barrier completed on EVERY rank before any
                # rank exits, so peers killed by the coordinator's
                # departure (rank 0 holds the group's store) are
                # collateral, and resume is safe.
                preempted = any(
                    rk.proc.poll() == EXIT_PREEMPTED for rk in ranks
                )
                if not preempted:
                    # A fabric resize SIGTERMs every rank; one that dies
                    # to the signal before its grace handler is up exits
                    # -SIGTERM.  When a resize is pending and every exit
                    # is explained by it (clean, checkpointed, or killed
                    # by our own signal), the wave is the resize — it
                    # must ride the lease budget, not the crash budget.
                    with self._ctl_lock:
                        fabric_pending = self._fabric_preempt
                    preempted = fabric_pending and not hb_dead and all(
                        rk.proc.poll()
                        in (None, 0, EXIT_PREEMPTED, -signal.SIGTERM)
                        for rk in ranks
                    )
                self._event(
                    "failure", exited=exited_bad, heartbeat_dead=hb_dead,
                    preempted=preempted,
                    postmortem=self._postmortem_rows()[-3:],
                )
                self._teardown(ranks)
                self._scan_output(ranks)
                codes = {rk.rank: rk.proc.poll() for rk in ranks}
                if preempted:
                    return {"outcome": "preempted", "codes": codes,
                            "dead": set()}
                # A peer's death fails the survivors' next collective at
                # once over torch.distributed, and they leave through the
                # crash hook: those ranks' hosts are alive, so a rescale
                # shrinks only by ranks that died otherwise (a signal,
                # another exit code) or fell silent.
                dead = {r for r, code in exited_bad
                        if code != EXIT_CRASH_HOOK} | set(hb_dead)
                return {"outcome": "crash", "codes": codes, "dead": dead}
            if not running:
                codes = {rk.rank: rk.proc.poll() for rk in ranks}
                self._scan_output(ranks)
                if any(c == EXIT_PREEMPTED for c in codes.values()):
                    return {"outcome": "preempted", "codes": codes,
                            "dead": set()}
                return {"outcome": "ok", "codes": codes, "dead": set()}
            time.sleep(cfg.poll_s)

    def _scan_output(self, ranks: List[_Rank]) -> None:
        for rk in ranks:
            rk.reader.join(timeout=2.0)
            out = rk.output()
            for m in _RESUME_RE.finditer(out):
                self.resume_generation = int(m.group(1))
            m = re.search(r"params_digest ([0-9a-f]{8})", out)
            if m:
                self.params_digest = m.group(1)

    # -- the job -------------------------------------------------------
    def run(self) -> dict:
        cfg = self.config
        world = cfg.nproc
        status = "failed"
        last_codes: dict = {}
        recorder_cm = None
        if cfg.step_log:
            from ..observability.step_log import StepRecorder

            # No device-memory sampling: the supervisor must not drag
            # torch into its own process.
            recorder_cm = StepRecorder(cfg.step_log, mem_every=0)
            self._recorder = recorder_cm
        if cfg.metrics_port is not None:
            from ..observability import MetricsExporter, Reporter

            self._reporter = Reporter()
            self._exporter = MetricsExporter(
                self._reporter, port=cfg.metrics_port
            )
            self._exporter.start()
            self.metrics_url = self._exporter.url
        self.running = True
        try:
            while True:
                # Consume a pending fabric resize before (re)spawning:
                # request_world may have landed during the previous
                # incarnation's teardown or the backoff window.
                with self._ctl_lock:
                    target = self._target_world
                    self._target_world = None
                if target is not None and target != world:
                    self._event("lease_rescale", from_world=world,
                                to_world=target)
                    world = target
                ranks = self._spawn_world(world)
                result = self._monitor(ranks)
                last_codes = {
                    str(k): v for k, v in result["codes"].items()
                }
                if result["outcome"] == "ok":
                    status = "ok"
                    self._event("success", world=world, codes=last_codes)
                    break
                if result["outcome"] == "preempted":
                    with self._ctl_lock:
                        fabric = self._fabric_preempt
                        self._fabric_preempt = False
                    if fabric:
                        # Arbiter-initiated resize: same checkpoint
                        # exit, but routine by design — it must never
                        # exhaust the preemption budget.
                        self.lease_rescales += 1
                        self._event("lease_preempt", codes=last_codes)
                    else:
                        self.preemptions += 1
                        self._event("preempted", codes=last_codes)
                        if self.preemptions > cfg.max_preemptions:
                            self._event("give_up",
                                        reason="max_preemptions")
                            break
                else:
                    self.restarts += 1
                    if self.restarts > cfg.max_restarts:
                        self._event("give_up", reason="max_restarts",
                                    codes=last_codes)
                        break
                    if cfg.rescale_on_failure:
                        survivors = world - len(result["dead"])
                        new_world = max(cfg.min_nproc, survivors)
                        if new_world != world:
                            self._event("rescale", from_world=world,
                                        to_world=new_world)
                            world = new_world
                self.incarnation += 1
                # Respawn backoff: exponential in the restart count so a
                # crash-looping job cannot spin the host.
                time.sleep(min(
                    cfg.backoff_s * (2 ** max(0, self.restarts - 1)), 8.0
                ))
        finally:
            self.running = False
            report = {
                "status": status,
                "nproc": cfg.nproc,
                "world": world,
                "incarnations": self.incarnation + 1,
                "restarts": self.restarts,
                "preemptions": self.preemptions,
                "lease_rescales": self.lease_rescales,
                "resume_generation": self.resume_generation,
                "params_digest": self.params_digest,
                "exit_codes": last_codes,
            }
            self._event("report", **report)
            if recorder_cm is not None:
                recorder_cm.close()
                self._recorder = None
            if self._exporter is not None:
                self._exporter.stop()
                self._exporter = None
        return report


def run_supervised(config: SupervisorConfig) -> dict:
    """One-call form: build, run, return the report dict."""
    return ElasticSupervisor(config).run()


def main_report_line(report: dict) -> str:
    """The stable one-line JSON the CLI prints and tests parse."""
    return "ELASTIC_REPORT " + json.dumps(report, sort_keys=True)

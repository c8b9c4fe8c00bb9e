"""Threaded cluster driving: one stepping thread per replica.

The router's single-threaded :meth:`ReplicaRouter.step` serializes every
replica's work onto one thread — correct, deterministic, and the right
default for tests — but it cannot OVERLAP a prefill-role replica's long
prompt with a decode-role replica's iterations, which is the entire
point of disaggregation.  :class:`ThreadedClusterDriver` gives each
replica its own thread (stepping under ``replica.lock``) while the
caller pumps the router's policy work (health, handoff placement,
status sync) with ``router.step(drive_replicas=False)``.

Token streams stay bit-exact under any interleaving: placement decisions
move between replicas, but each replica's scheduler is sequential under
its lock, and sampling is counter-based per request — threading changes
*when* tokens appear, never *which* tokens.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional


class ThreadedClusterDriver:
    """Steps every replica of ``router`` on its own daemon thread.

    Use as a context manager::

        with ThreadedClusterDriver(router):
            handles = [router.submit(...) for ...]
            while any(not h.done for h in handles):
                router.step(drive_replicas=False)
                time.sleep(0.001)
    """

    def __init__(self, router, idle_sleep_s: float = 0.001,
                 heartbeat: bool = True):
        self.router = router
        self.idle_sleep_s = idle_sleep_s
        self.heartbeat = heartbeat
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        #: replica ids ever given a thread — ensure_threads() is
        #: idempotent across autoscaler spawns (a retired id is NOT
        #: reused; its thread exited on the alive flip).
        self._known: set = set()
        self._started = False

    def _worker(self, replica) -> None:
        while not self._stop.is_set():
            if not replica.alive:
                return
            with replica.lock:
                # Re-check under the lock: fail_replica marks death
                # while holding it, and a step after that mark would
                # commit tokens the router has already replayed.
                if not replica.alive:
                    return
                busy = replica.has_work
                if busy:
                    replica.step()
            if self.heartbeat and self.router.health is not None:
                self.router.health.beat(replica.replica_id)
            # A busy worker re-takes its lock at once, and a lock is not
            # fair: yield first, so the policy pump (handoffs, failover,
            # migration) gets the lock between two steps.
            time.sleep(0 if busy else self.idle_sleep_s)

    def _spawn_thread(self, rep) -> None:
        t = threading.Thread(
            target=self._worker, args=(rep,), daemon=True,
            name=f"replica-{rep.replica_id}",
        )
        t.start()
        self._threads.append(t)
        self._known.add(rep.replica_id)

    def start(self) -> "ThreadedClusterDriver":
        if self._started:
            raise RuntimeError("driver already started")
        self._started = True
        for rep in list(self.router.replicas.values()):
            self._spawn_thread(rep)
        return self

    def ensure_threads(self) -> int:
        """Give any replica that joined the fleet since the last call
        (autoscaler scale-up) its stepping thread.  Returns how many
        were started.  Called from the policy pump — the autoscaler
        spawns, the pump wires."""
        if not self._started:
            return 0
        started = 0
        for rep in list(self.router.replicas.values()):
            if rep.replica_id not in self._known:
                self._spawn_thread(rep)
                started += 1
        return started

    def stop(self, timeout_s: Optional[float] = 10.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads = []
        self._known = set()
        self._started = False
        self._stop = threading.Event()

    def __enter__(self) -> "ThreadedClusterDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def run_until_idle(self, timeout_s: float = 300.0,
                       poll_s: float = 0.002) -> None:
        """Pump router policy work until every handle completes (or
        ``timeout_s`` elapses — RuntimeError, streams intact)."""
        deadline = time.monotonic() + timeout_s
        while self.router.has_work:
            self.ensure_threads()
            self.router.step(drive_replicas=False)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"cluster did not drain within {timeout_s}s"
                )
            time.sleep(poll_s)

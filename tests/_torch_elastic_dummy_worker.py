"""Stdlib-only dummy rank for the port's supervisor tests
(``tests/test_torch_elastic.py``), the counterpart of
``_elastic_dummy_worker.py``.

It imports nothing of either package: the supervisor is process plumbing
alone, and these modes exercise exactly its observable contract — exit
codes, heartbeat-file mtimes, SIGTERM behaviour::

    python _torch_elastic_dummy_worker.py <mode>

Modes (rank/incarnation read from CHAINERMN_TPU_ELASTIC_* env):

* ``ok``            — beat a few steps, exit 0.
* ``crash_once``    — exit 3 in incarnation 0, behave like ``ok`` after.
* ``crash_always``  — exit 3 every incarnation (restart-budget tests).
* ``crash_rank1_once`` — rank 1 exits 3 in incarnation 0; everyone
  else loops ``ok``-style (rescale tests).
* ``teardown``      — incarnation 0: rank 1 exits 3 as soon as rank 0
  has beaten, while rank 0 IGNORES SIGTERM and beats forever (the
  supervisor must escalate to SIGKILL within its grace window); later
  incarnations ``ok``.
* ``stall``         — incarnation 0: rank 1 stops beating after 2
  beats but stays alive (only the heartbeat deadline can catch it);
  later incarnations ``ok``.
* ``preempt_once``  — incarnation 0: exit 75 (EXIT_PREEMPTED) after 2
  beats; later incarnations ``ok``.
* ``kill_rank1_peers_follow`` — incarnation 0: rank 1 SIGKILLs itself
  and every other rank leaves through the crash hook's exit 13 right
  after, as torch.distributed peers whose collective lost a rank do;
  later incarnations ``ok``.
* ``rank0_finishes_first`` — every incarnation: rank 0 beats once and
  exits 0 at once, rank 1 beats for 2 s and exits 0 (a finished rank's
  silence is no death).
"""

import os
import signal
import sys
import time

EXIT_PREEMPTED = 75


def beat(path, step):
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, path)


def main():
    mode = sys.argv[1]
    rank = int(os.environ.get("CHAINERMN_TPU_ELASTIC_RANK", "0"))
    inc = int(os.environ.get("CHAINERMN_TPU_ELASTIC_INCARNATION", "0"))
    hb = os.environ.get("CHAINERMN_TPU_ELASTIC_HB_FILE")

    first = inc == 0
    if mode == "crash_once" and first:
        print(f"dummy rank {rank}: crashing (inc {inc})", flush=True)
        sys.exit(3)
    if mode == "crash_always":
        sys.exit(3)
    if mode == "teardown" and first and rank == 1 and hb:
        # Crash only once rank 0 has beaten, that is, after it ignores
        # SIGTERM: on a loaded host rank 0 could otherwise still be
        # starting when the supervisor's SIGTERM arrives, and exit on it.
        peer = os.path.join(os.path.dirname(hb), "hb.rank0")
        deadline = time.monotonic() + 20.0
        while not os.path.exists(peer) and time.monotonic() < deadline:
            time.sleep(0.01)
    if mode in ("crash_rank1_once", "teardown") and first and rank == 1:
        sys.exit(3)
    if mode == "kill_rank1_peers_follow" and first:
        # Rank 1 marks its death first and its peers follow the mark, so
        # on a loaded host no peer leaves before rank 1 has started.
        mark = os.path.join(os.path.dirname(hb or "."), "killed.rank1")
        if rank == 1:
            open(mark, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        deadline = time.monotonic() + 20.0
        while not os.path.exists(mark) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.01)
        sys.exit(13)
    if mode == "rank0_finishes_first":
        for step in range(1 if rank == 0 else 40):
            if hb:
                beat(hb, step)
            time.sleep(0.05)
        sys.exit(0)
    if mode == "teardown" and first and rank == 0:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        step = 0
        while True:  # only SIGKILL ends this
            if hb:
                beat(hb, step)
            step += 1
            time.sleep(0.02)

    steps = 4
    for step in range(steps):
        if hb and not (mode == "stall" and first and rank == 1
                       and step >= 2):
            beat(hb, step)
        if mode == "preempt_once" and first and step == 2:
            print(f"dummy rank {rank}: preempted (inc {inc})", flush=True)
            sys.exit(EXIT_PREEMPTED)
        if mode == "stall" and first and rank == 1 and step >= 2:
            time.sleep(60)  # alive but silent; teardown reaps us
        time.sleep(0.05)
    print(f"resumed from iteration {inc * 10}", flush=True)
    print(f"final gstep 4 params_digest {0xabad1dea + rank:08x}",
          flush=True)
    print(f"DUMMY_OK rank={rank} inc={inc}", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()

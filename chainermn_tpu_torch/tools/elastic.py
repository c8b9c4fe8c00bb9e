"""Elastic training launcher CLI — the port of
``chainermn_tpu/tools/elastic.py``.

Runs a training command under the
:class:`~chainermn_tpu_torch.elastic.supervisor.ElasticSupervisor`:
spawns the N-rank ``torch.distributed`` world, restarts (or rescales) it
on rank death, and injects deterministic faults from a chaos schedule.

Usage::

    # 2-rank world, restart up to 3 times on crashes:
    python -m chainermn_tpu_torch.tools.elastic --nproc 2 --max-restarts 3 -- \\
        python -m chainermn_tpu_torch.examples.train_mnist \\
        --communicator pure_nccl --elastic --checkpoint-dir /tmp/ck \\
        --checkpoint-every 1

    # chaos: SIGKILL rank 1 at its step 5, then rescale to the surviving
    # rank count instead of respawning in place:
    python -m chainermn_tpu_torch.tools.elastic --nproc 2 \\
        --chaos 'kill:rank=1:step=5' --rescale-on-failure -- ...

The final line on stdout is ``ELASTIC_REPORT {...}`` — one JSON object
with status, restarts, preemptions, resume generation, and the final
``params_digest`` scraped from rank output.  Exit code 0 only when the
job finished cleanly.

Supervisor events and ``elastic/*`` counters go to ``--step-log``;
summarize with ``python -m chainermn_tpu_torch.tools.obs summarize PATH``.
"""

from __future__ import annotations

import argparse
import sys

from ..elastic.supervisor import (
    ElasticSupervisor,
    SupervisorConfig,
    main_report_line,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.tools.elastic",
        description="Run a training command under the elastic "
                    "supervisor.",
    )
    ap.add_argument("--nproc", type=int, required=True,
                    help="world size to launch")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="crash-restart budget (preemptions don't count)")
    ap.add_argument("--rescale-on-failure", action="store_true",
                    help="shrink to the surviving rank count instead of "
                         "respawning in place")
    ap.add_argument("--min-nproc", type=int, default=1,
                    help="rescale floor")
    ap.add_argument("--chaos", default=None, metavar="SCHEDULE",
                    help="deterministic fault schedule, e.g. "
                         "'kill:rank=1:step=5;term:rank=0:step=8'")
    ap.add_argument("--hb-timeout", type=float, default=60.0,
                    help="seconds without a heartbeat before a rank "
                         "counts as dead")
    ap.add_argument("--start-grace", type=float, default=120.0,
                    help="deadline for a rank's FIRST beat (start-up)")
    ap.add_argument("--grace", type=float, default=10.0,
                    help="teardown SIGTERM→SIGKILL grace window")
    ap.add_argument("--workdir", default=None,
                    help="heartbeat/postmortem scratch dir")
    ap.add_argument("--step-log", default=None, metavar="PATH",
                    help="write supervisor events + elastic/* counters "
                         "as a JSONL step-event log")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a live Prometheus /metrics endpoint of "
                         "the supervisor's elastic/* counters on this "
                         "port while the job runs (0 = ephemeral)")
    ap.add_argument("--no-echo", action="store_true",
                    help="don't mirror rank output to stdout")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="training command (prefix with --)")
    args = ap.parse_args(argv)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no training command given (append: -- python ...)")

    if args.chaos:
        # Parse early: a typo'd schedule should fail the launch, not
        # silently no-op inside every rank.
        from ..elastic.chaos import ChaosSchedule

        ChaosSchedule.parse(args.chaos)

    config = SupervisorConfig(
        argv=cmd,
        nproc=args.nproc,
        max_restarts=args.max_restarts,
        rescale_on_failure=args.rescale_on_failure,
        min_nproc=args.min_nproc,
        heartbeat_timeout_s=args.hb_timeout,
        start_grace_s=args.start_grace,
        grace_s=args.grace,
        chaos=args.chaos,
        workdir=args.workdir,
        step_log=args.step_log,
        echo=not args.no_echo,
        metrics_port=args.metrics_port,
    )
    report = ElasticSupervisor(config).run()
    print(main_report_line(report))
    return 0 if report["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())

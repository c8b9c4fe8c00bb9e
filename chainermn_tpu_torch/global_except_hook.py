"""Global exception hook — failure containment.

Port of ``chainermn_tpu/global_except_hook.py`` (reference: ChainerMN's
``global_except_hook``, which calls ``MPI_Abort`` from ``sys.excepthook``).
There is no ``MPI_Abort`` over ``torch.distributed``: the hook makes the
failing rank print a postmortem (its rank in the banner, the traceback)
and leave at once with ``os._exit``, so no atexit handler or process-group
teardown can hang it; its peers' next collective then fails on the closed
connection (or a barrier's timeout) instead of waiting forever.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

_EXIT_CODE = 13  # distinct from the interpreter's 1: "left by the hook"
_hook_installed = False
_current_step = None


def set_current_step(step) -> None:
    """Best-effort step bookmark for the crash postmortem row (the
    elastic runtime calls this from ``ElasticContext.beat``)."""
    global _current_step
    _current_step = int(step)


def _safe_rank():
    """(rank, world size) without touching a backend: -1, -1 when no
    process group is up."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001 — the hook must not raise
        pass
    return -1, -1


def _write_postmortem(rank, size, exc_type, exc_value, exc_traceback):
    """Append one crash row (who, which step, what traceback) before the
    process vanishes, so a supervisor's postmortem can name the culprit.
    Two sinks, each best effort and each an O_APPEND JSONL row, so
    concurrent ranks do not tear each other's lines:

    * the installed :class:`~.observability.step_log.StepRecorder`, when
      one is live;
    * the file ``CHAINERMN_TPU_POSTMORTEM_FILE`` names (the elastic
      supervisor sets it for every rank it spawns).

    Never raises: a failing postmortem must not mask the exit."""
    if rank < 0:
        # No process group: the elastic environment still names us.
        try:
            rank = int(os.environ.get("CHAINERMN_TPU_ELASTIC_RANK", -1))
        except ValueError:
            pass
    tb = "".join(
        traceback.format_exception(exc_type, exc_value, exc_traceback)
    )[-8000:]
    row = {"event": "crash", "rank": rank, "size": size,
           "step": _current_step, "t": time.time(),
           "exc": f"{exc_type.__name__}: {exc_value}", "traceback": tb}
    try:
        from .observability.step_log import current_recorder

        rec = current_recorder()
        if rec is not None:
            rec.record("crash", rank=rank, size=size, step=_current_step,
                       exc=row["exc"], traceback=tb)
    except Exception:  # noqa: BLE001 — the hook must not raise
        pass
    try:
        path = os.environ.get("CHAINERMN_TPU_POSTMORTEM_FILE")
        if path:
            fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
            try:
                os.write(fd, (json.dumps(row) + "\n").encode("utf-8"))
            finally:
                os.close(fd)
    except Exception:  # noqa: BLE001
        pass


def _handle_uncaught(exc_type, exc_value, exc_traceback):
    rank, size = _safe_rank()
    sys.stderr.write(
        "\n*****************************************************\n"
        f"chainermn_tpu_torch: uncaught exception on rank {rank}/{size};\n"
        "leaving this process so its peers fail fast instead of hanging\n"
        "in a collective.\n"
        "*****************************************************\n"
    )
    traceback.print_exception(exc_type, exc_value, exc_traceback)
    try:
        _write_postmortem(rank, size, exc_type, exc_value, exc_traceback)
    except Exception:  # noqa: BLE001
        pass
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(_EXIT_CODE)


def add_hook():
    """Install the hook (idempotent)."""
    global _hook_installed
    if not _hook_installed:
        sys.excepthook = _handle_uncaught
        _hook_installed = True


def remove_hook():
    global _hook_installed
    sys.excepthook = sys.__excepthook__
    _hook_installed = False
